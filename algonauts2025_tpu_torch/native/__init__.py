"""Native data-plane library: build (g++) + ctypes bindings.

Builds dataplane.cpp into a shared object on first use (cached in the
package's git-ignored ``_build/`` directory, built to a per-pid temp and
atomically renamed) and exposes typed wrappers.  Every entry
point has a NumPy fallback so the framework runs without a toolchain.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
import typing as tp
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_HERE = Path(__file__).parent
_SRC = _HERE / "dataplane.cpp"
_BUILD = _HERE.parent / "_build"
_SO = _BUILD / "dataplane.so"
_HOST_FILE = _BUILD / "dataplane.so.host"
_LOCK = threading.Lock()
_LIB: tp.Any = None
_TRIED = False


def _host_tag() -> str:
    u = os.uname()
    return f"{u.nodename}:{u.machine}"


def _build() -> bool:
    # per-pid output + atomic rename: concurrent processes (job arrays)
    # may build simultaneously; none must ever CDLL a half-written .so
    tmp = _SO.with_suffix(f".so.{os.getpid()}")
    _BUILD.mkdir(parents=True, exist_ok=True)
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-shared",
        "-fPIC",
        "-o",
        str(tmp),
        str(_SRC),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
        # record which host built it: -march=native binaries must never be
        # CDLL'd on a different machine (shared/NFS checkouts) — dlopen
        # can't detect the ISA mismatch and the first call would SIGILL
        host_tmp = _HOST_FILE.with_suffix(f".host.{os.getpid()}")
        host_tmp.write_text(_host_tag())
        os.replace(host_tmp, _HOST_FILE)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError) as e:
        logger.warning("native build failed (%s); using NumPy fallbacks", e)
        tmp.unlink(missing_ok=True)
        return False


def get_lib() -> tp.Any:
    """The loaded library, or None when unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("ALGONAUTS_TPU_NO_NATIVE"):
            return None
        stale = (
            not _SO.exists()
            or _SO.stat().st_mtime < _SRC.stat().st_mtime
            # built by a different machine (shared checkout): rebuild —
            # the 96-line TU compiles in ~1 s, SIGILL debugging doesn't
            or not _HOST_FILE.exists()
            or _HOST_FILE.read_text().strip() != _host_tag()
        )
        if stale and not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError as e:
            logger.warning("native load failed (%s)", e)
            return None
        c_i64 = ctypes.c_int64
        c_int = ctypes.c_int
        f32_p = ctypes.POINTER(ctypes.c_float)
        f64_p = ctypes.POINTER(ctypes.c_double)
        lib.pcm16_to_mono_f32.argtypes = [
            ctypes.POINTER(ctypes.c_int16), c_i64, c_int, f32_p, f64_p, f64_p,
        ]
        lib.pcm24_to_mono_f32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), c_i64, c_int, f32_p, f64_p, f64_p,
        ]
        lib.zscore_inplace.argtypes = [f32_p, c_i64, ctypes.c_double, ctypes.c_double]
        lib.overlap_add_f32.argtypes = [
            f32_p, c_i64, f32_p, c_i64, c_i64, c_i64, c_i64, c_i64,
        ]
        _LIB = lib
        logger.info("native dataplane loaded from %s", _SO)
        return _LIB


def decode_pcm16_mono_zscore(raw: np.ndarray, channels: int) -> np.ndarray | None:
    """int16 interleaved PCM -> z-scored mono float32 in one native pass."""
    lib = get_lib()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw.view(np.int16))
    frames = raw.size // channels
    out = np.empty(frames, dtype=np.float32)
    s = ctypes.c_double()
    s2 = ctypes.c_double()
    lib.pcm16_to_mono_f32(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        frames,
        channels,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(s),
        ctypes.byref(s2),
    )
    lib.zscore_inplace(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), frames, s, s2
    )
    return out


def overlap_add(out: np.ndarray, src: np.ndarray, dst_off: int, src_off: int, n: int) -> bool:
    """out[..., dst_off:dst_off+n] += src[..., src_off:src_off+n] (2D f32).

    Returns False (caller falls back to NumPy) for any dtype/layout mismatch
    or when the requested slices would read/write out of bounds — the C++
    kernel takes raw offsets and must never see an invalid window.
    """
    lib = get_lib()
    if (
        lib is None
        or out.dtype != np.float32
        or src.dtype != np.float32
        or out.ndim != 2
        or src.ndim != 2
        or not out.flags.c_contiguous
        or not src.flags.c_contiguous
        or out.shape[0] != src.shape[0]
        or n < 0
        or dst_off < 0
        or src_off < 0
        or dst_off + n > out.shape[1]
        or src_off + n > src.shape[1]
    ):
        return False
    lib.overlap_add_f32(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.shape[1],
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        src.shape[1],
        out.shape[0],
        dst_off,
        src_off,
        n,
    )
    return True
