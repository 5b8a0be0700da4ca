"""What each design lever of the bf16 flash kernel is worth, on the card,
and how the kernel compares with other versions of its source.

    python -m algonauts2025_tpu_torch.scripts.flash_levers [--out DIR]
        [--baseline NAME=PATH ...] [--rounds N]

Builds ``csrc/flash_attention.cu`` as it is and, beside it, copies with
one lever of ``flash_tc_kernel`` switched off (``LEVERS``: patched lines,
written under ``_build/flash_levers/``; the checkout's source stays as it
is; a lever whose lines the source does not hold once each is reported
and left out) and each ``--baseline`` source file (for example the parent
commit's ``flash_attention.cu``, unpacked with ``git archive``), one nvcc
process each, all started together.  For every build it prints ptxas's
spills and registers for the six bf16 instantiations and any remark that
it serialised the wgmma; a lever build whose registers at launch are not
those its setmaxnreg split assumes (``tc_launch_regs`` of its block) is
not launched (its consumers would wait for ever).  The others run at the
main paths' shapes: rows 4, 3 (fp32 and bf16 scores) and 5 at (4, 22,
8192, 64) bf16 strided, row 2 at (8, 24, 1024, 128) bf16 causal with 8 kv
heads.  Each output is held against the plain version (relative L2), and
the builds are timed in ``--rounds`` turns, forwards and backwards in
alternation, beside ``scaled_dot_product_attention`` (row 2 over 50
calls, the others over 20, as ``chip_smoke.py`` times them); each time
printed is the median of the rounds.  Row 2's heads also run not causal
at T = 1024 and causal at T = 8192 (one sequence), which split its time
into a cost a key tile and a cost an item.  The SASS of the source as
built is counted by instruction class for each bf16 instantiation
(``cuobjdump -sass``).  The program is ``kernel_tools.lever_study``'s.
The last line is the JSON of the readings; ``--out`` also writes it to
``DIR/flash_levers.json``.
"""

from __future__ import annotations

import sys

import torch

from ..ops import flash_attention as fa
from . import kernel_tools as kt

__all__ = ["LEVERS", "FAMILY", "main"]

FILE = "flash_attention.cu"
# the consumer warpgroups' turns: the first hand-off, and the wait and the
# hand-off round the products in each of the loop's two bodies (told apart
# by their indent)
_TURNS = [(FILE, "bar_arrive(kTurn, 256);", "{}")] + [
    (FILE, f"{call}\n{pad}{after}", f"{{}}\n{pad}{after}")
    for call, pad, after in (("bar_sync(kTurn + wg, 256);", 8 * " ", "wgmma_fence();"),
                             ("bar_sync(kTurn + wg, 256);", 10 * " ", "wgmma_fence();"),
                             ("bar_arrive(next_turn, 256);", 8 * " ", "release();"),
                             ("bar_arrive(next_turn, 256);", 10 * " ", "wgmma_wait();"))]
TWO_WARPGROUPS = "two consumer warpgroups at d = 64"
#: lever -> the (file, old, new) patches that switch it off
LEVERS = {
    "as built": [],
    "no turns (the warpgroups issue their products freely)": _TURNS,
    "no ones panel (row sums on the CUDA cores)": [
        (FILE, "using BlockOf = Block<kD, !kMasked && kD == 64>;", "using BlockOf = Block<kD, false>;")],
    TWO_WARPGROUPS: [(FILE, "kWarpgroups = kD == 64 ? 3 : 2;", "kWarpgroups = 2;"),
                     (FILE, "kConsumerRegs = kD == 64 ? 160 : 240;", "kConsumerRegs = 240;"),
                     (FILE, "kProducerRegs = kD == 64 ? 32 : 24;", "kProducerRegs = 24;")],
    "items in plain rounds (block i takes items i, i + gridDim.x, ...)": [
        (FILE, "(t & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x)", "blockIdx.x")],
    "o stored by the threads (no TMA store)": [
        (FILE, "t.o_tma = o_tma && make_map(&t.o_map, p.o, p.so, p.D, p.T, p.H, B, 64) == 0;", "t.o_tma = 0;")],
    "causal items head by head (the blocks at work share K and V)": [
        (FILE, "const int bh = causal ? k % p.BH : k / n_q;", "const int bh = k / n_q;"),
        (FILE, "const int qt = causal ? n_q - 1 - k / p.BH : k % n_q;",
         "const int qt = causal ? n_q - 1 - k % n_q : k % n_q;")],
}
VIT, LLAMA, LLAMA_KV = (4, 22, 8192, 64), (8, 24, 1024, 128), 8


def launch_regs(lever: str, key: tuple) -> int:
    """The registers at launch that a lever's setmaxnreg split assumes for
    the instantiation ``key`` (head dim, masked, bf16 scores): those of its
    block, two consumer warpgroups' at d = 64 under ``TWO_WARPGROUPS``."""
    if lever == TWO_WARPGROUPS and key[0] == 64:
        return fa.tc_launch_regs(128 * (2 + 1))
    return fa.tc_block(key[0])["launch_regs"]


def _setup():
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, t, h, d = VIT[0], VIT[2], VIT[1], VIT[3]
    fused = torch.randn((b, t, 3, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    vit = fused.permute(2, 0, 3, 1, 4).unbind(0)  # head-split views, as the backbone hands them over
    llama = [torch.randn((LLAMA[0], LLAMA[2], n, LLAMA[3]), generator=gen, device="cuda").to(torch.bfloat16)
             .transpose(1, 2) for n in (LLAMA[1], LLAMA_KV, LLAMA_KV)]
    lens = torch.full((LLAMA[0],), LLAMA[2], dtype=torch.int32, device="cuda")
    long = [torch.randn((1, 8192, n, LLAMA[3]), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
            for n in (LLAMA[1], LLAMA_KV, LLAMA_KV)]
    calls = {
        "row 4": (lambda: fa.flash_attention(*vit), lambda: fa.bounded_attention_plain(*vit)),
        "row 3": (lambda: fa.fast_flash_attention(*vit), lambda: fa.fast_attention_plain(*vit)),
        "row 3, bf16 scores": (lambda: fa.fast_flash_attention(*vit, torch.bfloat16),
                               lambda: fa.fast_attention_plain(*vit, torch.bfloat16)),
        "row 5": (lambda: fa.flash_attention_packed(*vit), lambda: fa.packed_attention_plain(*vit)),
        "row 2": (lambda: fa.flash_attention(*llama, causal=True, lengths=lens),
                  lambda: fa.flash_attention_plain(*llama, True, lens)),
        "row 2 heads, T = 1024, not causal": (lambda: fa.flash_attention(*llama),
                                              lambda: fa.flash_attention_plain(*llama, False, None)),
        "row 2 heads, T = 8192, causal": (lambda: fa.flash_attention(*long, causal=True),
                                          lambda: fa.flash_attention_plain(*long, True, None)),
    }
    rows = {}
    for row, (kernel, plain) in calls.items():
        rows[row] = kt.Row(kernel, 50 if row == "row 2" else 20, lambda out, ref=plain(): kt.rel_l2(out, ref))
        torch.cuda.empty_cache()
    sdpa_ms = {"row 4": kt.time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*vit)),
               "row 2": kt.time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                   *llama, is_causal=True, enable_gqa=True), iters=50)}
    return rows, {"sdpa_ms": sdpa_ms}, None


FAMILY = kt.LeverFamily(
    script="flash_levers", files=(FILE,), libraries=("flash_attention",), levers=LEVERS, kernel="flash_tc_kernel",
    decode=fa.tc_instantiation, label=str, launch_regs=launch_regs, instantiations=len(fa.TC_INSTANTIATIONS),
    sass_ops=("HGMMA", "MUFU.EX2", "FFMA", "FMUL", "FADD", "FMNMX", "F2FP", "SHFL", "BAR", "SYNCS", "STG", "LDG",
              "STL", "LDL", "USETMAXREG"),
    setup=_setup, builds_key="levers", errors_key="rel_l2",
    ptxas_record=lambda ptxas: {"spill_bytes": sum(v.get("spills", 0) for v in ptxas["flash_attention"].values())})


def main(argv: list[str] | None = None) -> dict:
    return kt.lever_study(FAMILY, __doc__, argv)


if __name__ == "__main__":
    main(sys.argv[1:])
