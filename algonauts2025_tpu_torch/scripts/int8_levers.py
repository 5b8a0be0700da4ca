"""What each design lever of the int8 GEMM core is worth, on the card, and
how the core compares with other versions of its sources.

    python -m algonauts2025_tpu_torch.scripts.int8_levers [--out DIR]
        [--baseline NAME=DIR ...] [--rounds N]

Builds ``csrc/w8a8.cu`` (kernel row 6) and ``csrc/int8_mlp.cu`` (row 7) as
they are and, beside them, copies with one lever of the core switched
(``LEVERS``: patched lines of ``int8_wgmma.cuh``, ``w8a8.cu`` or
``int8_mlp.cu``, written under ``_build/int8_levers/``; the checkout's
sources stay as they are; a lever whose lines the sources no longer hold
is reported and left out) and the three files of each ``--baseline``
directory (for example the parent commit's ``csrc``, unpacked with ``git
archive``), one nvcc process a library, all started together.  For every
build it prints ptxas's registers and spills for each GEMM instantiation
and any remark that it serialised the wgmma or ignored setmaxnreg; a
lever build whose instantiations do not hold the registers at launch
that their setmaxnreg split assumes (``quant.gemm_block``) is not
launched (its consumers would wait for ever).  The others run row 6 at
(32768, 1408) x (1408, 1408) and row 7 at (32768, 1408) -> 6144 -> 1408,
bf16 in and out (the ViT-G window batch of 4), held against the plain
versions (row 6 bit for bit, row 7 by relative L2), and are timed in
``--rounds`` turns, forwards and backwards in alternation: each call with
CUDA events over 20 (row 6) or 10 (row 7) calls, and five calls of each
under ``torch.profiler``, which gives the quantize pass, row 6's GEMM and
row 7's fc1 and fc2 apart.  Each time printed is the median of the
rounds.  The SASS of the sources as built is counted by instruction class
for each GEMM instantiation (``cuobjdump -sass``).  The last line is the
JSON of the readings; ``--out`` also writes it to ``DIR/int8_levers.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

from ..ops import _cuda
from ..ops import quant
from ..ops.flash_attention import tc_launch_regs

__all__ = ["LEVERS", "main"]

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
#: the instruction classes counted in the SASS
SASS_OPS = ("IGMMA", "MUFU.RCP", "MUFU.EX2", "I2F", "F2I", "FRND", "FFMA", "FMUL", "FADD", "FSETP", "BRA", "CALL",
            "BAR", "SYNCS", "STS", "UTMASTG", "UTMALDG", "LDG", "STG", "STL", "LDL", "USETMAXREG")
M, D, F = 32768, 1408, 6144


def _sources(baselines: dict[str, Path]) -> dict[str, dict[str, str]]:
    """build name -> file -> text: each lever that applies to the sources,
    and each baseline."""
    texts = {name: (_cuda.CSRC / name).read_text() for name in FILES}
    out = {}
    for lever, patches in LEVERS.items():
        missing = [old for file, old, _ in patches if old not in texts[file]]
        if missing:
            print(f"{lever}: left out, the sources no longer hold {missing}", flush=True)
            continue
        build = dict(texts)
        for file, old, new in patches:
            build[file] = build[file].replace(old, new)
        out[lever] = build
    for name, folder in baselines.items():
        out[name] = {file: (folder / file).read_text() for file in FILES}
    return out


def _build_all(texts: dict[str, dict[str, str]]) -> dict[str, dict[str, tuple[Path, str, int]]]:
    """build name -> library ("w8a8", "int8_mlp") -> (path, nvcc's report,
    exit code)."""
    procs = {}
    for i, (build, files) in enumerate(texts.items()):
        folder = _cuda.BUILD_DIR / "int8_levers" / str(i)
        folder.mkdir(parents=True, exist_ok=True)
        for file, text in files.items():
            (folder / file).write_text(text)
        for name in PARTS:
            library = folder / f"lib{name}.so"
            procs[build, name] = (library, subprocess.Popen(
                _cuda.nvcc_command(folder / f"{name}.cu", library), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    builds: dict[str, dict[str, tuple[Path, str, int]]] = {}
    for (build, name), (library, proc) in procs.items():
        builds.setdefault(build, {})[name] = (library, proc.communicate()[0], proc.returncode)
    return builds


def _instantiation(name: str) -> str:
    """"epilogue, schedule" of a mangled ``gemm_kernel`` name (the schedule is
    absent in a core without schedules)."""
    epilogue = re.search(r"(StoreGeluQuant|StoreDequantRope|StoreDequantI\w+?Li\dEE)", name).group(1)
    schedule = re.search(r"(Cooperative|PingPongPairs|PingPong)", name)
    return f"{epilogue}, {schedule.group(1) if schedule else '-'}"


def _launch_regs(instantiation: str) -> int:
    """The registers at launch that an instantiation's setmaxnreg split
    assumes: those of its schedule's block."""
    warpgroups = quant._SCHEDULES[instantiation.split(", ")[1]][0]
    return tc_launch_regs(128 * (warpgroups + 1))


def _ptxas(report: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes of each GEMM instantiation in a ``-Xptxas
    -v`` report."""
    out, key = {}, None
    for line in report.splitlines():
        if found := re.search(r"Compiling entry function '(\w*gemm_kernel\w*)'", line):
            key = _instantiation(found.group(1))
            out[key] = {}
        elif "Compiling entry function" in line:
            key = None
        elif key and (found := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[key]["spills"] = int(found.group(1)) + int(found.group(2))
        elif key and (found := re.search(r"Used (\d+) registers", line)):
            out[key]["registers"] = int(found.group(1))
    return out


def _sass_ops(library: Path) -> dict[str, dict[str, int]]:
    """Per GEMM instantiation, how many instructions of each ``SASS_OPS``
    class its SASS holds."""
    cuobjdump = Path(_cuda._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)], check=True, capture_output=True,
                          text=True).stdout
    out = {}
    for function in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = function.split(None, 1)
        if "gemm_kernel" in name:
            out[_instantiation(name)] = {op: len(re.findall(rf"\b{re.escape(op)}\b", body)) for op in SASS_OPS}
    return out


def _time_ms(fn, iters: int) -> float:
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


def _parts_ms(row6, row7, calls: int = 5) -> dict[str, float]:
    """ms a call of each part of ``PARTS``, from ``torch.profiler`` over
    ``calls`` calls of each row."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    out = {}
    for name, run in (("w8a8", row6), ("int8_mlp", row7)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        for part, piece in PARTS[name].items():
            out[part] = sum(e.self_device_time_total for e in kernels if piece in e.key) / 1e3 / calls
    return out


def _library_functions(libraries: dict[str, Path]):
    """A stand-in for ``_cuda.function`` over the symbols of these libraries."""
    libs = {name: ctypes.CDLL(str(path)) for name, path in libraries.items()}

    def function(name, symbol, argtypes, restype=ctypes.c_int):
        fn = getattr(libs[name], symbol)
        fn.argtypes, fn.restype = list(argtypes), restype
        return fn
    return function


def _inputs(gen: torch.Generator):
    """Row 6's and row 7's ViT-G arguments, seeded as ``chip_smoke.py``'s."""

    def dense(k, n):
        return quant.quantize_weight(torch.randn((k, n), generator=gen, device="cuda") / k**0.5)

    def scale(x):
        return (x.float().abs().amax() / 127.0).reshape(())

    x = torch.randn((M, D), generator=gen, device="cuda").to(torch.bfloat16)
    w_q, w_s = dense(D, D)
    bias = 0.1 * torch.randn(D, generator=gen, device="cuda")
    row6 = (x, w_q, w_s, scale(x)), {"bias": bias, "w_kmajor": w_q.t().contiguous()}
    w1_q, w1_s = dense(D, F)
    w2_q, w2_s = dense(F, D)
    b1 = 0.1 * torch.randn(F, generator=gen, device="cuda")
    b2 = 0.1 * torch.randn(D, generator=gen, device="cuda")
    sx = scale(x)
    sxs = quant._static_scale(sx)
    h = quant.gelu_erf_approx(quant._dequant(quant._int_matmul(quant._quantize(x.float(), sxs), w1_q),
                                             sxs, w1_s, b1))
    row7 = ((x, w1_q, w1_s, b1, w2_q, w2_s, b2, sx, scale(h)),
            {"w1_kmajor": w1_q.t().contiguous(), "w2_kmajor": w2_q.t().contiguous()})
    return row6, row7


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, help="directory for int8_levers.json")
    parser.add_argument("--baseline", action="append", default=[], metavar="NAME=DIR",
                        help=f"a directory holding another {', '.join(FILES)} to build and time beside these")
    parser.add_argument("--rounds", type=int, default=4, help="times each build is timed, in turns")
    args = parser.parse_args(argv)
    if args.rounds < 1:
        raise SystemExit("int8_levers: --rounds must be at least 1")
    baselines = {}
    for spec in args.baseline:
        name, sep, path = spec.partition("=")
        if not (sep and name and all((Path(path) / f).is_file() for f in FILES)) or name in LEVERS:
            raise SystemExit(f"int8_levers: --baseline takes NAME=DIR of a directory holding {FILES}, got {spec!r}")
        baselines[name] = Path(path)
    if not torch.cuda.is_available():
        raise SystemExit("int8_levers: CUDA is not available; this script needs a CUDA card")
    builds = _build_all(_sources(baselines))
    gen = torch.Generator(device="cuda").manual_seed(0)
    (a6, k6), (a7, k7) = _inputs(gen)
    ref6 = quant.int8_matmul_fused_plain(*a6, bias=k6["bias"])
    ref7 = quant.int8_mlp_fused_plain(*a7).float()
    row6 = lambda: quant.int8_matmul_fused(*a6, **k6)  # noqa: E731
    row7 = lambda: quant.int8_mlp_fused(*a7, **k7)  # noqa: E731
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    result = {"card": card, "rounds": args.rounds, "builds": {}}
    runnable = []
    for build, libraries in builds.items():
        ptxas = {name: _ptxas(report) for name, (_, report, _) in libraries.items()}
        reports = "".join(report for _, report, _ in libraries.values())
        remarks = [line.strip() for line in reports.splitlines()
                   if "setmaxnreg" in line.lower() or "serializ" in line.lower()]
        ok = all(code == 0 for _, _, code in libraries.values()) and all(ptxas.values())
        if build in LEVERS:
            ok = ok and all(v.get("registers") == _launch_regs(key) for p in ptxas.values() for key, v in p.items())
        result["builds"][build] = {"ptxas": ptxas, "ptxas_remarks": remarks, "launched": ok, "ms": {},
                                   "parts_ms": {}, "errors": {}}
        print(f"{build}: nvcc exits {[code for _, _, code in libraries.values()]}, ptxas {ptxas}, "
              f"remarks {remarks or 'none'}", flush=True)
        if ok:
            runnable.append(build)
    if "as built" in runnable:
        result["sass_ops"] = {name: _sass_ops(builds["as built"][name][0]) for name in PARTS}
        for name, ops in result["sass_ops"].items():
            for key, counts in ops.items():
                print(f"as built SASS {name} ({key}): {counts}", flush=True)
    for rounds in range(args.rounds):
        for build in runnable if rounds % 2 == 0 else runnable[::-1]:
            entry = result["builds"][build]
            libraries = {name: path for name, (path, _, _) in builds[build].items()}
            with mock.patch.object(quant._cuda, "function", _library_functions(libraries)):
                if rounds == 0:
                    out6, out7 = row6(), row7().float()
                    entry["errors"] = {
                        "row 6 bit-equal": bool(torch.equal(out6, ref6)),
                        "row 7 rel L2": (torch.linalg.vector_norm(out7 - ref7)
                                         / torch.linalg.vector_norm(ref7)).item()}
                entry["ms"].setdefault("row 6", []).append(_time_ms(row6, 20))
                entry["ms"].setdefault("row 7", []).append(_time_ms(row7, 10))
                for part, ms in _parts_ms(row6, row7).items():
                    entry["parts_ms"].setdefault(part, []).append(ms)
    for build in runnable:
        entry = result["builds"][build]
        entry["median_ms"] = {key: statistics.median(ms) for key, ms in {**entry["ms"], **entry["parts_ms"]}.items()}
        print(f"{build}: " + ", ".join(f"{key} {ms:.4f} ms" for key, ms in entry["median_ms"].items())
              + f"; {entry['errors']}", flush=True)
    print(f"on {card}", flush=True)
    line = json.dumps(result)
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "int8_levers.json").write_text(line + "\n")
    print(line, flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
