"""Branch-free rational erf-gelu, the same function as the JAX package's.

erf(z) ~= z * P5(z^2) / Q4(z^2) for |z| <= 3.5, clamped outside: 7.2e-7
absolute on erf, 1.3e-6 on gelu for |x| < 5.  Plain tensor ops; the trunk's
FF uses it so that the port computes the function the JAX trunk trains.
"""

from __future__ import annotations

import torch

__all__ = ["erf_rational", "gelu_fast"]

_P = (
    1.12837844e00,
    3.23145577e-01,
    6.63509064e-02,
    8.59716620e-03,
    2.27834428e-04,
    -1.41600601e-06,
)
_Q = (
    1.0,
    6.19700850e-01,
    1.65423640e-01,
    2.45017900e-02,
    2.04720000e-03,
)
_CLAMP = 3.5


def erf_rational(z: torch.Tensor) -> torch.Tensor:
    """erf(z) to 7.2e-7 absolute, branch-free (computed in the input dtype)."""
    zc = torch.clamp(z, -_CLAMP, _CLAMP)
    u = zc * zc
    p = u * _P[-1] + _P[-2]
    for c in _P[-3::-1]:
        p = p * u + c
    q = u * _Q[-1] + _Q[-2]
    for c in _Q[-3::-1]:
        q = q * u + c
    return zc * (p / q)


def gelu_fast(x: torch.Tensor) -> torch.Tensor:
    """Exact-form (erf) gelu to 1.3e-6 absolute."""
    z = x * 0.7071067811865476
    return 0.5 * x * (1.0 + erf_rational(z))
