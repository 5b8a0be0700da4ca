"""Build, inspect and time the port's CUDA kernels beside the package's own
build: what ``chip_smoke.py`` and the lever scripts (``flash_levers.py``,
``int8_levers.py``) share.

- ``write_patched``, ``start_builds``, ``finish_builds``: copies of ``csrc``
  sources with some lines replaced, written under ``_build/<dir>`` and
  built with one nvcc each, all started together;
- ``stand_in``: ``_cuda.function`` over such builds' libraries;
- ``ptxas_kernels``, ``ptxas_remarks``, ``sass_functions``, ``sass_ops``,
  ``sass_digest``: what nvcc's ``-Xptxas -v`` report and ``cuobjdump
  -sass`` say of each kernel;
- ``time_ms``, ``device_kernels``, ``parts_ms``: a call's device time from
  CUDA events, and its kernels' from ``torch.profiler``;
- ``w8a8_case``, ``mlp_case``: seeded arguments of kernel rows 6 and 7;
- ``LeverFamily`` and ``lever_study``: the program of the lever scripts.

Nothing here runs at import; every function that needs the card or the
CUDA toolkit asks for it when called.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import re
import statistics
import subprocess
import typing as tp
from pathlib import Path
from unittest import mock

import torch

from ..ops import _cuda, quant

__all__ = ["Patch", "Build", "write_patched", "start_builds", "finish_builds", "stand_in", "ptxas_kernels",
           "ptxas_remarks", "sass_functions", "sass_ops", "sass_digest", "time_ms", "device_kernels", "parts_ms",
           "rel_l2", "card_line", "VITG_M", "VITG_D", "VITG_F", "w8a8_case", "mlp_case", "kmajor", "Row", "LeverFamily",
           "write_builds", "gate", "lever_study"]

#: (file, the text it replaces, which must be in the file exactly once, the
#: replacement)
Patch = tuple[str, str, str]


class Build(tp.NamedTuple):
    library: Path
    report: str  # nvcc's output, ptxas's ``-v`` report among it
    code: int  # nvcc's exit code


def write_patched(sources: dict[str, Path], patches: list[Patch], folder: Path) -> list[Patch]:
    """Write each source (file name -> path) into ``folder`` with ``patches``
    applied.  Returns the patches whose text is not exactly once in its
    file, and writes nothing then: the caller decides what that means."""
    texts = {file: path.read_text() for file, path in sources.items()}
    bad = [patch for patch in patches if texts[patch[0]].count(patch[1]) != 1]
    if not bad:
        for file, old, new in patches:
            texts[file] = texts[file].replace(old, new)
        folder.mkdir(parents=True, exist_ok=True)
        for file, text in texts.items():
            (folder / file).write_text(text)
    return bad


def start_builds(jobs: dict[tp.Hashable, tuple[Path, Path]]) -> dict[tp.Hashable, tuple[Path, subprocess.Popen]]:
    """Start one nvcc a job (key -> (source, library)), all at once."""
    return {key: (library, subprocess.Popen(_cuda.nvcc_command(source, library), stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
            for key, (source, library) in jobs.items()}


def finish_builds(started: dict[tp.Hashable, tuple[Path, subprocess.Popen]]) -> dict[tp.Hashable, Build]:
    """Wait for each of ``start_builds``' processes."""
    return {key: Build(library, proc.communicate()[0], proc.returncode) for key, (library, proc) in started.items()}


def stand_in(libraries: dict[str, Path]):
    """A stand-in for ``_cuda.function`` over these libraries (csrc name ->
    library), for ``mock.patch.object(_cuda, "function", ...)``."""
    libs = {name: ctypes.CDLL(str(path)) for name, path in libraries.items()}

    def function(name, symbol, argtypes, restype=ctypes.c_int):
        fn = getattr(libs[name], symbol)
        fn.argtypes, fn.restype = list(argtypes), restype
        return fn
    return function


def ptxas_kernels(report: str) -> dict[str, dict[str, int]]:
    """Per kernel (mangled name) of a ``-Xptxas -v`` report: the registers it
    holds at launch and the bytes of its spill stores and loads."""
    kernels, name = {}, None
    for line in report.splitlines():
        if found := re.search(r"Compiling entry function '(\w+)'", line):
            name = found.group(1)
            kernels[name] = {}
        elif name and (found := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            kernels[name]["spills"] = int(found.group(1)) + int(found.group(2))
        elif name and (found := re.search(r"Used (\d+) registers", line)):
            kernels[name]["registers"] = int(found.group(1))
    return kernels


def ptxas_remarks(report: str) -> list[str]:
    """The lines of a report in which ptxas ignored setmaxnreg or serialised
    the wgmma."""
    return [line.strip() for line in report.splitlines()
            if "setmaxnreg" in line.lower() or "serializ" in line.lower()]


def sass_functions(library: Path) -> dict[str, str]:
    """Mangled name -> SASS of every kernel in ``library`` (``cuobjdump
    -sass``)."""
    sass = subprocess.run([_cuda.cuda_tool("cuobjdump"), "-sass", str(library)], check=True, capture_output=True,
                          text=True).stdout
    return dict(function.split(None, 1) for function in re.split(r"\n\s*Function : ", sass)[1:])


def sass_ops(body: str, ops: tp.Iterable[str]) -> dict[str, int]:
    """How many instructions of each class of ``ops`` a SASS body holds."""
    return {op: len(re.findall(rf"\b{re.escape(op)}\b", body)) for op in ops}


def sass_digest(body: str) -> str:
    """sha256 of a SASS body's instruction lines (each address, instruction
    and encoding word, its runs of blanks made one space): two bodies share
    it exactly when they hold the same instructions in the same order."""
    lines = [" ".join(line.split()) for line in body.splitlines() if line.strip().startswith("/*")]
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(run) -> list[tuple[str, float, int]]:
    """(name, device ms in all, launches) of every kernel that ``run()``
    launches, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def parts_ms(kernels: list[tuple[str, float, int]], calls: int, names: dict[str, str]) -> dict[str, float]:
    """ms a call of each part of a kernel, from ``device_kernels`` over
    ``calls`` calls: ``names`` maps a part to a piece of its kernels' names
    (an int8 kernel's quantize pass, a GEMM by its epilogue)."""
    return {part: sum(ms for key, ms, _ in kernels if piece in key) / calls for part, piece in names.items()}


def rel_l2(out: torch.Tensor, ref: torch.Tensor) -> float:
    out, ref = out.float(), ref.float()
    return (torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref)).item()


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


# ViT-G at a window batch of 4: (B*N, D) activations, D, MLP width
VITG_M, VITG_D, VITG_F = 4 * 8192, 1408, 6144


def _int8_dense(k, n, gen):
    """Seeded float weights at a dense layer's init scale, quantized per column."""
    return quant.quantize_weight(torch.randn((k, n), generator=gen, device=gen.device) / k**0.5)


def _absmax_scale(x: torch.Tensor) -> torch.Tensor:
    return (x.float().abs().amax() / 127.0).reshape(())


def w8a8_case(m, k, n, x_dtype, gen):
    """Row 6's arguments for one dense, on ``gen``'s device: x, the weight
    with its scale, x's absmax scale, the bias and the K-major weight."""
    x = torch.randn((m, k), generator=gen, device=gen.device).to(x_dtype)
    w_q, w_s = _int8_dense(k, n, gen)
    bias = 0.1 * torch.randn(n, generator=gen, device=gen.device)
    return x, w_q, w_s, _absmax_scale(x), bias, w_q.t().contiguous()


def mlp_case(m, k, f, gen, x: torch.Tensor | None = None):
    """Row 7's arguments, on ``gen``'s device: (x, w1, its scale, b1, w2, its
    scale, b2), x's absmax scale and that of the post-gelu hidden state;
    bf16 x is drawn unless given."""
    if x is None:
        x = torch.randn((m, k), generator=gen, device=gen.device).to(torch.bfloat16)
    w1_q, w1_s = _int8_dense(k, f, gen)
    w2_q, w2_s = _int8_dense(f, k, gen)
    b1 = 0.1 * torch.randn(f, generator=gen, device=gen.device)
    b2 = 0.1 * torch.randn(k, generator=gen, device=gen.device)
    sx = _absmax_scale(x)
    sxs = quant._static_scale(sx)
    h = quant.gelu_erf_approx(quant._dequant(quant._int_matmul(quant._quantize(x.float(), sxs), w1_q),
                                             sxs, w1_s, b1))
    return (x, w1_q, w1_s, b1, w2_q, w2_s, b2), sx, _absmax_scale(h)


def kmajor(args) -> dict[str, torch.Tensor]:
    """The K-major weights that int8_mlp_fused's kernel reads, from
    ``mlp_case``'s arguments."""
    return {"w1_kmajor": args[1].t().contiguous(), "w2_kmajor": args[4].t().contiguous()}


@dataclasses.dataclass(frozen=True)
class Row:
    """A call the lever study times in each build (over ``iters`` calls), and
    its output's error against the plain version, recorded under
    ``error_name`` (the row's name when empty)."""

    run: tp.Callable[[], torch.Tensor]
    iters: int
    error: tp.Callable[[torch.Tensor], float | bool]
    error_name: str = ""


@dataclasses.dataclass(frozen=True)
class LeverFamily:
    """What the lever study knows of one family of kernels."""

    script: str  # the command's name: its messages, its JSON file
    files: tuple[str, ...]  # the csrc files a build copies (a --baseline gives them all)
    libraries: tuple[str, ...]  # the sources a build compiles, one library each
    levers: dict[str, list[Patch]]  # lever -> its patches ("as built": none)
    kernel: str  # the family's kernel, as its mangled names hold it
    decode: tp.Callable[[str], tuple]  # a mangled name -> its instantiation
    label: tp.Callable[[tuple], str]  # an instantiation -> its key in the JSON
    launch_regs: tp.Callable[[str, tuple], int]  # (lever, instantiation) -> the registers its split assumes
    instantiations: int | None  # how many a build holds in all (None: one a library or more)
    sass_ops: tuple[str, ...]  # the instruction classes counted in the SASS as built
    # on the card: the rows, readings taken once for the JSON's top level,
    # and the ms of each part of a build (once a round; None: no parts)
    setup: tp.Callable[[], tuple[dict[str, Row], dict, tp.Callable[[], dict[str, float]] | None]]
    builds_key: str  # the JSON's key of the builds
    errors_key: str  # a build's key of its rows' errors
    ptxas_record: tp.Callable[[dict], dict]  # ptxas by library and label -> a build's keys for it


def write_builds(family: LeverFamily, baselines: dict[str, dict[str, Path]], root: Path) -> dict[str, Path]:
    """Write each lever whose patches apply to the sources (the others are
    reported and left out) and each baseline (name -> file -> path) into
    its folder under ``root``: build name -> folder."""
    csrc = {file: _cuda.CSRC / file for file in family.files}
    builds = [(lever, patches, csrc) for lever, patches in family.levers.items()]
    builds += [(name, [], sources) for name, sources in baselines.items()]
    folders = {}
    for i, (name, patches, sources) in enumerate(builds):
        if bad := write_patched(sources, patches, root / str(i)):
            print(f"{name}: left out, the sources do not hold each of {[old for _, old, _ in bad]} once", flush=True)
        else:
            folders[name] = root / str(i)
    return folders


def gate(family: LeverFamily, name: str, libraries: dict[str, Build]) -> tuple[dict, list[str], bool]:
    """A build's ptxas readings (library -> label -> registers and spills),
    ptxas's remarks, and whether the build may be launched: every nvcc
    exited 0, the build holds the family's instantiations, and a lever
    build holds at launch the registers its setmaxnreg split assumes (fewer
    would leave its consumers waiting for ever)."""
    ptxas = {lib: {family.decode(kernel): info for kernel, info in ptxas_kernels(build.report).items()
                   if family.kernel in kernel} for lib, build in libraries.items()}
    held = (sum(map(len, ptxas.values())) == family.instantiations if family.instantiations
            else all(ptxas.values()))
    ok = all(build.code == 0 for build in libraries.values()) and held
    if name in family.levers:
        ok = ok and all(info.get("registers") == family.launch_regs(name, key)
                        for by_key in ptxas.values() for key, info in by_key.items())
    labelled = {lib: {family.label(key): info for key, info in by_key.items()} for lib, by_key in ptxas.items()}
    return labelled, ptxas_remarks("".join(build.report for build in libraries.values())), ok


def _baselines(family: LeverFamily, specs: list[str]) -> dict[str, dict[str, Path]]:
    """--baseline NAME=PATH: a source file for a family of one file, a
    directory holding every file otherwise."""
    one = len(family.files) == 1
    baselines = {}
    for spec in specs:
        name, sep, path = spec.partition("=")
        sources = {family.files[0]: Path(path)} if one else {file: Path(path) / file for file in family.files}
        if not (sep and name and path and all(p.is_file() for p in sources.values())) or name in family.levers:
            what = "PATH of a source file" if one else f"DIR of a directory holding {family.files}"
            raise SystemExit(f"{family.script}: --baseline takes NAME={what}, got {spec!r}")
        baselines[name] = sources
    return baselines


def lever_study(family: LeverFamily, doc: str, argv: list[str] | None = None) -> dict:
    """The lever scripts' program: build every lever and baseline of
    ``family`` at once, gate each build on ptxas's report (a lever build
    whose registers at launch are not those its setmaxnreg split assumes is
    not launched: its consumers would wait for ever), count the SASS as
    built, hold each launched build's rows against their plain versions and
    time them in ``--rounds`` turns, forwards and backwards in alternation,
    and print the medians; the last line is the JSON of the readings."""
    one = len(family.files) == 1
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("--out", type=Path, help=f"directory for {family.script}.json")
    parser.add_argument("--baseline", action="append", default=[], metavar="NAME=PATH" if one else "NAME=DIR",
                        help=f"another {family.files[0]} to build and time beside this one" if one else
                        f"a directory holding another {', '.join(family.files)} to build and time beside these")
    parser.add_argument("--rounds", type=int, default=4, help="times each build is timed, in turns")
    args = parser.parse_args(argv)
    if args.rounds < 1:
        raise SystemExit(f"{family.script}: --rounds must be at least 1")
    baselines = _baselines(family, args.baseline)
    if not torch.cuda.is_available():
        raise SystemExit(f"{family.script}: CUDA is not available; this script needs a CUDA card")
    folders = write_builds(family, baselines, _cuda.BUILD_DIR / family.script)
    builds: dict[str, dict[str, Build]] = {}
    for (name, lib), build in finish_builds(start_builds({
            (name, lib): (folder / f"{lib}.cu", folder / f"lib{lib}.so")
            for name, folder in folders.items() for lib in family.libraries})).items():
        builds.setdefault(name, {})[lib] = build
    rows, top, parts = family.setup()
    card = card_line()
    result = {"card": card, "rounds": args.rounds, family.builds_key: {}, **top}
    runnable = []
    for name, libraries in builds.items():
        labelled, remarks, ok = gate(family, name, libraries)
        result[family.builds_key][name] = {**family.ptxas_record(labelled), "ptxas_remarks": remarks, "launched": ok,
                                           "ms": {}, family.errors_key: {}, **({"parts_ms": {}} if parts else {})}
        print(f"{name}: nvcc exits {[build.code for build in libraries.values()]}, ptxas {labelled}, "
              f"remarks {remarks or 'none'}", flush=True)
        if ok:
            runnable.append(name)
    if "as built" in runnable:
        sass = {lib: {family.label(family.decode(kernel)): sass_ops(body, family.sass_ops)
                      for kernel, body in sass_functions(builds["as built"][lib].library).items()
                      if family.kernel in kernel} for lib in family.libraries}
        for lib, by_label in sass.items():
            for label, counts in by_label.items():
                print(f"as built SASS {lib} ({label}): {counts}", flush=True)
        result["sass_ops"] = sass[family.libraries[0]] if one else sass
    for turn in range(args.rounds):
        for name in runnable if turn % 2 == 0 else runnable[::-1]:
            entry = result[family.builds_key][name]
            libraries = {lib: build.library for lib, build in builds[name].items()}
            with mock.patch.object(_cuda, "function", stand_in(libraries)):
                for row, spec in rows.items():
                    if turn == 0:
                        entry[family.errors_key][spec.error_name or row] = spec.error(spec.run())
                    entry["ms"].setdefault(row, []).append(time_ms(spec.run, spec.iters))
                for part, ms in (parts() if parts else {}).items():
                    entry["parts_ms"].setdefault(part, []).append(ms)
    for name in runnable:
        entry = result[family.builds_key][name]
        entry["median_ms"] = {key: statistics.median(ms)
                              for key, ms in {**entry["ms"], **entry.get("parts_ms", {})}.items()}
        print(f"{name}: " + ", ".join(f"{key} {ms:.4f} ms" for key, ms in entry["median_ms"].items())
              + f"; {entry[family.errors_key]}", flush=True)
    print(f"on {card}: {top}", flush=True)
    line = json.dumps(result)
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / f"{family.script}.json").write_text(line + "\n")
    print(line, flush=True)
    return result
