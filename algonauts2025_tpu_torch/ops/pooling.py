"""Temporal pooling as a precomputed (T, T') matrix.

Reproduces PyTorch AdaptiveAvgPool1d's uneven binning — bin i averages
input[floor(i*T/O) : ceil((i+1)*T/O)] — as one matmul.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["adaptive_avg_pool_matrix", "adaptive_avg_pool1d"]


@functools.lru_cache(maxsize=64)
def adaptive_avg_pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 matrix M with x @ M == AdaptiveAvgPool1d(n_out)(x)."""
    mat = np.zeros((n_in, n_out), dtype=np.float32)
    for i in range(n_out):
        lo = (i * n_in) // n_out
        hi = -(-((i + 1) * n_in) // n_out)  # ceil
        mat[lo:hi, i] = 1.0 / (hi - lo)
    return mat


def adaptive_avg_pool1d(x, n_out: int):
    """Pool the last axis of x to n_out bins (PyTorch semantics) as one
    matmul; a NumPy array or a tensor (the matrix on its device, in its
    dtype)."""
    mat = adaptive_avg_pool_matrix(x.shape[-1], n_out)
    if isinstance(x, torch.Tensor):
        return x @ torch.from_numpy(mat).to(device=x.device, dtype=x.dtype)
    return x @ mat
