"""What each design lever of the int8 GEMM core is worth, on the card, and
how the core compares with other versions of its sources.

    python -m algonauts2025_tpu_torch.scripts.int8_levers [--out DIR]
        [--baseline NAME=DIR ...] [--rounds N]

Builds ``csrc/w8a8.cu`` (kernel row 6) and ``csrc/int8_mlp.cu`` (row 7) as
they are and, beside them, copies with one lever of the core switched
(``LEVERS``: patched lines of ``int8_wgmma.cuh``, ``w8a8.cu`` or
``int8_mlp.cu``, written under ``_build/int8_levers/``; the checkout's
sources stay as they are; a lever whose lines the sources do not hold once
each is reported and left out) and the three files of each ``--baseline``
directory (for example the parent commit's ``csrc``, unpacked with ``git
archive``), one nvcc process a library, all started together.  For every
build it prints ptxas's registers and spills for each GEMM instantiation
and any remark that it serialised the wgmma or ignored setmaxnreg; a
lever build whose instantiations do not hold the registers at launch
that their setmaxnreg split assumes (``quant.schedule_block``) is not
launched (its consumers would wait for ever).  The others run row 6 at
(32768, 1408) x (1408, 1408) and row 7 at (32768, 1408) -> 6144 -> 1408,
bf16 in and out (the ViT-G window batch of 4), held against the plain
versions (row 6 bit for bit, row 7 by relative L2), and are timed in
``--rounds`` turns, forwards and backwards in alternation: each call with
CUDA events over 20 (row 6) or 10 (row 7) calls, and five calls of each
under ``torch.profiler``, which gives the quantize pass, row 6's GEMM and
row 7's fc1 and fc2 apart.  Each time printed is the median of the
rounds.  The SASS of the sources as built is counted by instruction class
for each GEMM instantiation (``cuobjdump -sass``).  The program is
``kernel_tools.lever_study``'s.  The last line is the JSON of the
readings; ``--out`` also writes it to ``DIR/int8_levers.json``.
"""

from __future__ import annotations

import sys

import torch

from ..ops import quant
from . import kernel_tools as kt

__all__ = ["LEVERS", "FAMILY", "main"]

#: the sources of the two int8 kernels
FILES = ("int8_wgmma.cuh", "w8a8.cu", "int8_mlp.cu")
#: lever -> the (file, old line, new line) patches that switch it
LEVERS = {
    "as built": [],
    "fc1 Cooperative (128 x 256 tiles, its epilogue after its products)": [
        ("int8_mlp.cu", "gemm<StoreGeluQuant, i8wg::PingPongPairs>", "gemm<StoreGeluQuant, i8wg::Cooperative>")],
    "fc1 PingPong (one warpgroup a 128 x 128 tile)": [
        ("int8_mlp.cu", "gemm<StoreGeluQuant, i8wg::PingPongPairs>", "gemm<StoreGeluQuant, i8wg::PingPong>")],
    "fc2 PingPong (128 x 128 tiles)": [
        ("int8_mlp.cu", "StoreDequant<float, 1>, i8wg::Cooperative>", "StoreDequant<float, 1>, i8wg::PingPong>"),
        ("int8_mlp.cu", "StoreDequant<__nv_bfloat16, 1>, i8wg::Cooperative>",
         "StoreDequant<__nv_bfloat16, 1>, i8wg::PingPong>")],
    "row 6 PingPongPairs (two warpgroups a 128 x 128 tile)": [
        ("w8a8.cu", "StoreDequant<float, 0>, i8wg::PingPong>", "StoreDequant<float, 0>, i8wg::PingPongPairs>"),
        ("w8a8.cu", "StoreDequant<__nv_bfloat16, 0>, i8wg::PingPong>",
         "StoreDequant<__nv_bfloat16, 0>, i8wg::PingPongPairs>")],
    "row 6 Cooperative (128 x 256 tiles)": [
        ("w8a8.cu", "StoreDequant<float, 0>, i8wg::PingPong>", "StoreDequant<float, 0>, i8wg::Cooperative>"),
        ("w8a8.cu", "StoreDequant<__nv_bfloat16, 0>, i8wg::PingPong>",
         "StoreDequant<__nv_bfloat16, 0>, i8wg::Cooperative>")],
    "fc1 epilogue 2 column pairs a group": [
        ("int8_wgmma.cuh", "constexpr int kGroupPairs = 4;", "constexpr int kGroupPairs = 2;")],
}
#: the kernels of each library, by a piece of their names: the parts timed
PARTS = {"w8a8": {"row 6 quantize": "quantize_kernel", "row 6 GEMM": "gemm_kernel"},
         "int8_mlp": {"row 7 quantize": "quantize_kernel", "fc1": "StoreGeluQuant", "fc2": "StoreDequant"}}


def _parts_ms(row6, row7, calls: int = 5) -> dict[str, float]:
    """ms a call of each part of ``PARTS``, from ``torch.profiler`` over
    ``calls`` calls of each row."""
    out = {}
    for name, run in (("w8a8", row6), ("int8_mlp", row7)):
        out.update(kt.parts_ms(kt.device_kernels(lambda: [run() for _ in range(calls)]), calls, PARTS[name]))
    return out


def _setup():
    """Row 6's and row 7's ViT-G arguments (row 7 over row 6's x), their
    plain outputs and their parts."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, w_q, w_s, sx, bias, w_t = kt.w8a8_case(kt.VITG_M, kt.VITG_D, kt.VITG_D, torch.bfloat16, gen)
    args, sx7, sh = kt.mlp_case(kt.VITG_M, kt.VITG_D, kt.VITG_F, gen, x=x)
    weights = kt.kmajor(args)
    ref6 = quant.int8_matmul_fused_plain(x, w_q, w_s, sx, bias=bias)
    ref7 = quant.int8_mlp_fused_plain(*args, sx7, sh)

    def row6():
        return quant.int8_matmul_fused(x, w_q, w_s, sx, bias=bias, w_kmajor=w_t)

    def row7():
        return quant.int8_mlp_fused(*args, sx7, sh, **weights)

    rows = {"row 6": kt.Row(row6, 20, lambda out: bool(torch.equal(out, ref6)), "row 6 bit-equal"),
            "row 7": kt.Row(row7, 10, lambda out: kt.rel_l2(out, ref7), "row 7 rel L2")}
    return rows, {}, lambda: _parts_ms(row6, row7)


FAMILY = kt.LeverFamily(
    script="int8_levers", files=FILES, libraries=tuple(PARTS), levers=LEVERS, kernel="gemm_kernel",
    decode=quant.gemm_instantiation, label=lambda key: f"{key[0]}, {key[1] or '-'}",
    launch_regs=lambda lever, key: quant.schedule_block(key[1])["launch_regs"], instantiations=None,
    sass_ops=("IGMMA", "MUFU.RCP", "MUFU.EX2", "I2F", "F2I", "FRND", "FFMA", "FMUL", "FADD", "FSETP", "BRA", "CALL",
              "BAR", "SYNCS", "STS", "UTMASTG", "UTMALDG", "LDG", "STG", "STL", "LDL", "USETMAXREG"),
    setup=_setup, builds_key="builds", errors_key="errors", ptxas_record=lambda ptxas: {"ptxas": ptxas})


def main(argv: list[str] | None = None) -> dict:
    return kt.lever_study(FAMILY, __doc__, argv)


if __name__ == "__main__":
    main(sys.argv[1:])
