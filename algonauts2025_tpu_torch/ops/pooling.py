"""Temporal pooling as a precomputed (T, T') matrix.

Reproduces PyTorch AdaptiveAvgPool1d's uneven binning — bin i averages
input[floor(i*T/O) : ceil((i+1)*T/O)] — as one matmul.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["adaptive_avg_pool_matrix"]


@functools.lru_cache(maxsize=64)
def adaptive_avg_pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 matrix M with x @ M == AdaptiveAvgPool1d(n_out)(x)."""
    mat = np.zeros((n_in, n_out), dtype=np.float32)
    for i in range(n_out):
        lo = (i * n_in) // n_out
        hi = -(-((i + 1) * n_in) // n_out)  # ceil
        mat[lo:hi, i] = 1.0 / (hi - lo)
    return mat
