"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and becomes
``_build/lib<name>-<hash>.so`` the first time it is needed; the hash of the
source and of the shared ``csrc/*.cuh`` headers is in the file name, so an
edited source or header is rebuilt and a stale library is never loaded.
There is no fallback: a failed build raises.  The kernel wrappers share the
rest of their host glue from here: the dtype codes of the C interfaces,
the typed entry points and the device check.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "DTYPE_CODES", "build", "build_all", "nvcc_command", "load",
           "function", "check_cuda", "build_logs"]

#: the dtype argument of every kernel's C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: nvcc's output (register and shared-memory use from ``-Xptxas -v``) per
#: source built by this process.
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(str(Path(CUDA_HOME) / "bin" / "nvcc"))
    for path in candidates:
        if path and Path(path).exists():
            return path
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest = digest.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def nvcc_command(source: Path, library: Path, nvcc: str | None = None) -> list[str]:
    """The nvcc command that builds ``source`` into the shared ``library``
    for sm_90a, with ptxas's register and shared-memory report."""
    return [
        nvcc or _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", str(library), str(source),
    ]


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile the named sources (default: every ``csrc/*.cu``), one nvcc
    process per source, all started together.  Returns name -> library."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    out = {name: _library_path(name) for name in names}
    todo = {name: lib for name, lib in out.items() if not lib.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            nvcc_command(CSRC / f"{name}.cu", tmp, nvcc),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, todo[name])  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def build(name: str) -> Path:
    return build_all([name])[name]


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built on first use)."""
    return ctypes.CDLL(str(build(name)))


@functools.cache
def function(name: str, symbol: str, argtypes: tuple, restype=ctypes.c_int):
    """``symbol`` of ``csrc/<name>.cu``'s library, typed with ``argtypes``
    and ``restype`` (built on first use)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def check_cuda(kernel: str, contiguous: bool = False, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on a CUDA device (and, with
    ``contiguous``, is contiguous): the kernel wrappers' first check."""
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{kernel} kernel: {arg} is on {t.device}, not a CUDA device")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{kernel} kernel: {arg} must be contiguous")
