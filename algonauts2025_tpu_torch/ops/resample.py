"""Polyphase windowed-sinc resampling (julius replacement).

The port of algonauts2025_tpu/ops/resample.py: the kernel bank is built
once on the host (NumPy, the same bank) and the filtering runs as one
strided ``conv1d`` on the tensor's device, with the phase bank as the
output channels.  Filter design: gcd-reduced rates p (new) / q (old),
windowed sinc with ``zeros`` crossings and a raised-cosine window, rolloff
0.945.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resample_poly", "resample_kernel"]


@functools.lru_cache(maxsize=16)
def resample_kernel(
    old_sr: int, new_sr: int, zeros: int = 24, rolloff: float = 0.945
) -> tuple[np.ndarray, int, int, int]:
    """Build the polyphase kernel bank.

    Returns (kernels (p, 1, width), p, q, pad) where output phase i is the
    convolution of the input (stride q) with kernels[i]."""
    g = math.gcd(int(old_sr), int(new_sr))
    q = int(old_sr) // g  # decimation
    p = int(new_sr) // g  # interpolation (number of phases)
    sr = min(p, q) * rolloff
    width = int(math.ceil(zeros * q / sr))
    idx = np.arange(-width, width + q, dtype=np.float64)
    kernels = []
    for i in range(p):
        t = (-i / p + idx / q) * sr
        t = np.clip(t, -zeros, zeros) * math.pi
        window = np.cos(t / zeros / 2) ** 2
        kernels.append(np.sinc(t / math.pi) * window)
    scale = sr / q
    bank = (np.stack(kernels) * scale).astype(np.float32)[:, None, :]
    return bank, p, q, width


def resample_poly(x: torch.Tensor, old_sr: int, new_sr: int) -> torch.Tensor:
    """Resample the last axis of float32 ``x`` (..., T) from old_sr to
    new_sr; the output has ``int(T * new_sr / old_sr)`` samples."""
    if old_sr == new_sr:
        return x
    bank, p, q, width = resample_kernel(int(old_sr), int(new_sr))
    length = x.shape[-1]
    out_len = int(length * new_sr / old_sr)
    xf = F.pad(x.reshape(-1, 1, length), (width, width + q))
    # (N, 1, T) * (p, 1, K) -> (N, p, frames), stride q
    out = F.conv1d(xf, torch.from_numpy(bank).to(device=x.device, dtype=x.dtype), stride=q)
    # interleave phases: frame f phase i -> output index f*p + i
    out = out.transpose(1, 2).reshape(xf.shape[0], -1)[:, :out_len]
    return out.reshape(*x.shape[:-1], out_len)
