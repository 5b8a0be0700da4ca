"""What each design lever of the bf16 flash kernel is worth, on the card,
and how the kernel compares with other versions of its source.

    python -m algonauts2025_tpu_torch.scripts.flash_levers [--out DIR]
        [--baseline NAME=PATH ...]

Builds ``csrc/flash_attention.cu`` as it is and, beside it, copies with
one lever of ``flash_tc_kernel`` switched off (``LEVERS``: patched lines,
written under ``_build/levers/``; the checkout's source stays as it is; a
lever whose lines the source no longer holds is reported and left out)
and each ``--baseline`` source file (for example the parent commit's
``flash_attention.cu``, unpacked with ``git archive``), one nvcc process
each, all started together.  For every build it prints ptxas's spills
and registers for the six bf16 instantiations and any remark that it
serialised the wgmma; a lever build whose registers at launch are not
those its setmaxnreg split assumes (``tc_launch_regs`` of its block) is
not launched (its consumers would wait for ever).  The others run at the
main paths' shapes: rows 4,
3 (fp32 and bf16 scores) and 5 at (4, 22, 8192, 64) bf16 strided, row 2 at
(8, 24, 1024, 128) bf16 causal with 8 kv heads.  Each output is held
against the plain version (relative L2), and the builds are timed in
``--rounds`` turns, forwards and backwards in alternation, beside
``scaled_dot_product_attention`` (row 2 over 50 calls, the others over 20,
as ``chip_smoke.py`` times them); each time printed is the median of the
rounds.  Row 2's heads also run not causal at T = 1024 and causal at T =
8192 (one sequence), which split its time into a cost a key tile and a
cost an item.  The SASS of the source as built is counted by instruction
class for each bf16 instantiation (``cuobjdump -sass``).
The last line is the JSON of the readings; ``--out`` also writes it to
``DIR/flash_levers.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

from ..ops import _cuda
from ..ops import flash_attention as fa

__all__ = ["LEVERS", "main"]

_TURNS = [("bar_sync(kTurn + wg, 256);", "{}"), ("bar_arrive(next_turn, 256);", "{}"),
          ("bar_arrive(kTurn, 256);", "{}")]
#: lever -> (the source lines it patches, consumer warpgroups at d = 64 if
#: it changes them)
LEVERS = {
    "as built": ([], None),
    "no turns (the warpgroups issue their products freely)": (_TURNS, None),
    "no ones panel (row sums on the CUDA cores)": (
        [("using BlockOf = Block<kD, !kMasked && kD == 64>;", "using BlockOf = Block<kD, false>;")], None),
    "two consumer warpgroups at d = 64": (
        [("kWarpgroups = kD == 64 ? 3 : 2;", "kWarpgroups = 2;"),
         ("kConsumerRegs = kD == 64 ? 160 : 240;", "kConsumerRegs = 240;"),
         ("kProducerRegs = kD == 64 ? 32 : 24;", "kProducerRegs = 24;")], 2),
    "items in plain rounds (block i takes items i, i + gridDim.x, ...)": (
        [("(t & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x)", "blockIdx.x")], None),
    "o stored by the threads (no TMA store)": (
        [("t.o_tma = o_tma && make_map(&t.o_map, p.o, p.so, p.D, p.T, p.H, B, 64) == 0;", "t.o_tma = 0;")], None),
    "causal items head by head (the blocks at work share K and V)": (
        [("const int bh = causal ? k % p.BH : k / n_q;", "const int bh = k / n_q;"),
         ("const int qt = causal ? n_q - 1 - k / p.BH : k % n_q;", "const int qt = causal ? n_q - 1 - k % n_q : k % n_q;")],
        None),
}
VIT, LLAMA, LLAMA_KV = (4, 22, 8192, 64), (8, 24, 1024, 128), 8
#: the instruction classes counted in the SASS
SASS_OPS = ("HGMMA", "MUFU.EX2", "FFMA", "FMUL", "FADD", "FMNMX", "F2FP", "SHFL", "BAR", "SYNCS", "STG", "LDG",
            "STL", "LDL", "USETMAXREG")


def _launch_regs(lever: str) -> dict[int, int]:
    """The registers at launch, by head dim, that a lever's setmaxnreg split
    assumes."""
    warpgroups = LEVERS[lever][1]
    regs = {d: fa.tc_block(d)["launch_regs"] for d in (64, 128)}
    if warpgroups is not None:
        regs[64] = fa.tc_launch_regs(128 * (warpgroups + 1))
    return regs


def _sources(baselines: dict[str, Path]) -> dict[str, str]:
    """build name -> source text: each lever that applies to the source, and
    each baseline."""
    source = (_cuda.CSRC / "flash_attention.cu").read_text()
    texts = {}
    for lever, (patches, _) in LEVERS.items():
        missing = [old for old, _ in patches if old not in source]
        if missing:
            print(f"{lever}: left out, the source no longer holds {missing}", flush=True)
            continue
        text = source
        for old, new in patches:
            text = text.replace(old, new)
        texts[lever] = text
    for name, path in baselines.items():
        texts[name] = path.read_text()
    return texts


def _build_all(texts: dict[str, str]) -> dict[str, tuple[Path, str, int]]:
    """build name -> (library, nvcc's report, exit code)."""
    procs = {}
    for i, (lever, text) in enumerate(texts.items()):
        folder = _cuda.BUILD_DIR / "levers" / str(i)
        folder.mkdir(parents=True, exist_ok=True)
        (folder / "flash_attention.cu").write_text(text)
        library = folder / "libflash_attention.so"
        procs[lever] = (library, subprocess.Popen(_cuda.nvcc_command(folder / "flash_attention.cu", library),
                                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    builds = {}
    for lever, (library, proc) in procs.items():
        report = proc.communicate()[0]
        builds[lever] = (library, report, proc.returncode)
    return builds


def _ptxas(report: str) -> dict[tuple[int, ...], dict[str, int]]:
    """(head dim, masked, bf16 scores) -> registers and spill bytes of each
    ``flash_tc_kernel`` instantiation in a ``-Xptxas -v`` report."""
    out, key = {}, None
    for line in report.splitlines():
        if found := re.search(r"Compiling entry function '(\w*flash_tc_kernel\w*)'", line):
            args = found.group(1).split("flash_tc_kernel")[1]
            key = tuple(int(x) for x in re.findall(r"L[ib](\d+)E", args)[:3])
            out[key] = {}
        elif "Compiling entry function" in line:
            key = None
        elif key and (found := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[key]["spills"] = int(found.group(1)) + int(found.group(2))
        elif key and (found := re.search(r"Used (\d+) registers", line)):
            out[key]["registers"] = int(found.group(1))
    return out


def _sass_ops(library: Path) -> dict[str, dict[str, int]]:
    """Per bf16 ``flash_tc_kernel`` instantiation ("(head dim, masked, bf16
    scores)"), how many instructions of each ``SASS_OPS`` class its SASS
    holds."""
    cuobjdump = Path(_cuda._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)], check=True, capture_output=True,
                          text=True).stdout
    out = {}
    for function in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = function.split(None, 1)
        if "flash_tc_kernel" in name:
            key = tuple(int(x) for x in re.findall(r"L[ib](\d+)E", name.split("flash_tc_kernel", 1)[1])[:3])
            out[str(key)] = {op: len(re.findall(rf"\b{re.escape(op)}\b", body)) for op in SASS_OPS}
    return out


def _median(values: list[float]) -> float:
    ordered = sorted(values)
    mid = len(ordered) // 2
    return ordered[mid] if len(ordered) % 2 else (ordered[mid - 1] + ordered[mid]) / 2


def _time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _rel(out: torch.Tensor, ref: torch.Tensor) -> float:
    return (torch.linalg.vector_norm(out.float() - ref.float()) / torch.linalg.vector_norm(ref.float())).item()


def _library_functions(library: Path):
    """A stand-in for ``_cuda.function`` over the symbols of ``library``."""
    lib = ctypes.CDLL(str(library))

    def function(name, symbol, argtypes, restype=ctypes.c_int):
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = list(argtypes), restype
        return fn
    return function


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, help="directory for flash_levers.json")
    parser.add_argument("--baseline", action="append", default=[], metavar="NAME=PATH",
                        help="another flash_attention.cu to build and time beside this one")
    parser.add_argument("--rounds", type=int, default=4, help="times each build is timed, in turns")
    args = parser.parse_args(argv)
    if args.rounds < 1:
        raise SystemExit("flash_levers: --rounds must be at least 1")
    baselines = {}
    for spec in args.baseline:
        name, sep, path = spec.partition("=")
        if not (sep and name and Path(path).is_file()) or name in LEVERS:
            raise SystemExit(f"flash_levers: --baseline takes NAME=PATH of a source file, got {spec!r}")
        baselines[name] = Path(path)
    if not torch.cuda.is_available():
        raise SystemExit("flash_levers: CUDA is not available; this script needs a CUDA card")
    builds = _build_all(_sources(baselines))
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, t, h, d = VIT[0], VIT[2], VIT[1], VIT[3]
    fused = torch.randn((b, t, 3, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    vit = fused.permute(2, 0, 3, 1, 4).unbind(0)  # head-split views, as the backbone hands them over
    llama = [torch.randn((LLAMA[0], LLAMA[2], n, LLAMA[3]), generator=gen, device="cuda").to(torch.bfloat16)
             .transpose(1, 2) for n in (LLAMA[1], LLAMA_KV, LLAMA_KV)]
    lens = torch.full((LLAMA[0],), LLAMA[2], dtype=torch.int32, device="cuda")
    long = [torch.randn((1, 8192, n, LLAMA[3]), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
            for n in (LLAMA[1], LLAMA_KV, LLAMA_KV)]
    rows = {
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
    refs = {}
    for row, (_, plain) in rows.items():
        refs[row] = plain()
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    result = {"card": card, "rounds": args.rounds, "levers": {}, "sdpa_ms": {
        "row 4": _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*vit)),
        "row 2": _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            *llama, is_causal=True, enable_gqa=True), iters=50)}}
    runnable = []
    for lever, (library, report, code) in builds.items():
        ptxas = _ptxas(report)
        remarks = sorted({m for m in re.findall(r"\((C75\d\d)\)", report)})
        ok = code == 0 and len(ptxas) == 6
        if lever in LEVERS:
            want = _launch_regs(lever)
            ok = ok and all(v.get("registers") == want[k[0]] for k, v in ptxas.items())
        result["levers"][lever] = {"spill_bytes": sum(v.get("spills", 0) for v in ptxas.values()),
                                   "ptxas_remarks": remarks, "launched": ok, "ms": {}, "rel_l2": {}}
        print(f"{lever}: nvcc exit {code}, ptxas {ptxas}, remarks {remarks or 'none'}", flush=True)
        if ok:
            runnable.append(lever)
    if "as built" in runnable:
        result["sass_ops"] = _sass_ops(builds["as built"][0])
        for key, ops in result["sass_ops"].items():
            print(f"as built SASS {key}: {ops}", flush=True)
    for rounds in range(args.rounds):
        for lever in runnable if rounds % 2 == 0 else runnable[::-1]:
            entry = result["levers"][lever]
            with mock.patch.object(fa._cuda, "function", _library_functions(builds[lever][0])):
                for row, (kernel, _) in rows.items():
                    if rounds == 0:
                        entry["rel_l2"][row] = _rel(kernel(), refs[row])
                    entry["ms"].setdefault(row, []).append(_time_ms(kernel, iters=50 if row == "row 2" else 20))
    for lever in runnable:
        entry = result["levers"][lever]
        entry["median_ms"] = {row: _median(ms) for row, ms in entry["ms"].items()}
        print(f"{lever}: " + ", ".join(f"{row} {entry['median_ms'][row]:.4f} ms ({min(ms):.4f}-{max(ms):.4f}; "
                                       f"rel L2 {entry['rel_l2'][row]:.2e})" for row, ms in entry["ms"].items()),
              flush=True)
    print(f"sdpa: row 4 {result['sdpa_ms']['row 4']:.4f} ms, row 2 {result['sdpa_ms']['row 2']:.4f} ms "
          f"on {result['card']}", flush=True)
    line = json.dumps(result)
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "flash_levers.json").write_text(line + "\n")
    print(line, flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
