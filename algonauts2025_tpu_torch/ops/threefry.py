"""JAX's default random normals in NumPy: threefry2x32 and its uniform -> normal map.

The video feature calibrates its static int8 scales on
``jax.random.normal(jax.random.PRNGKey(7), shape)`` (float32); the port
cannot call JAX, so it rebuilds those numbers here.  The bits are exact:
the partitionable threefry2x32 scheme (JAX's default), a uint64 iota
counter split into two uint32 words, the two output words xor-ed.  The
uniform in [nextafter(-1, 0), 1) is exact too.  The inverse error
function is XLA's float32 one (Giles' polynomials over a Cephes log1p
whose large branch calls XLA's CPU float32 log, the Cephes ``logf``
polynomial, with the fused multiply-adds XLA's CPU backend emits), so the
normals are bit-equal to JAX's (tests/test_torch_video.py checks them and
the log against ``jnp.log``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["threefry2x32", "normal", "log"]

_F32 = np.float32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's ErfInv32 (Giles): coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# XLA's Log1p for |x| < sqrt(2) - 1 (Cephes rational), highest power first
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# XLA's CPU float32 log (Cephes logf): polynomial in x = m - 1, m in [sqrt(1/2), sqrt(2))
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375  # log(2) = Q2 + Q1, Q2 exact in 9 bits


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1: int, k2: int, x1: np.ndarray, x2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the uint32 counter pairs (x1, x2)."""
    ks = [np.uint32(k1), np.uint32(k2), np.uint32(k1) ^ np.uint32(k2) ^ np.uint32(0x1BD11BDA)]
    with np.errstate(over="ignore"):
        x = [x1 + ks[0], x2 + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _fma(a: np.ndarray, b: np.ndarray, c) -> np.ndarray:
    """float32 a * b + c with (almost always) one rounding: the product is
    exact in float64."""
    return (a.astype(np.float64) * b.astype(np.float64) + np.asarray(c, np.float64)).astype(_F32)


def _polynomial(x: np.ndarray, coeffs) -> np.ndarray:
    p = np.zeros_like(x)
    for c in coeffs:  # float32 coefficients, as XLA's constants are
        p = _fma(p, x, _F32(c))
    return p


def log(x: np.ndarray) -> np.ndarray:
    """float32 natural log of positive ``x`` as XLA's CPU backend
    computes it: the mantissa m in [0.5, 1) and exponent e of x, shifted to
    x = 2m - 1, e - 1 when m < sqrt(1/2), else x = m - 1; the degree-8
    polynomial in three interleaved fma chains; then
    fma(y, x^3, e Q1) - x^2/2 + x + e Q2.  Bit-equal to ``jnp.log`` on the
    CPU (the fused ``y x^3 + e Q1`` is what a correctly rounded log misses)."""
    # XLA clamps to the smallest normal first; zero, inf and negative
    # inputs, which the normals never reach, are not handled here
    m, e = np.frexp(np.maximum(np.asarray(x, _F32), np.finfo(_F32).tiny))
    m, e = m.astype(_F32), e.astype(_F32)
    low = m < _F32(0.707106781186547524)
    z = np.where(low, (m - _F32(1)) + m, m - _F32(1)).astype(_F32)
    e = np.where(low, e - _F32(1), e).astype(_F32)
    z2 = (z * z).astype(_F32)
    z3 = (z2 * z).astype(_F32)
    p = [_F32(c) for c in _LOG_P]
    y = _fma(_fma(z, p[0], p[1]), z, p[2])
    y1 = _fma(_fma(z, p[3], p[4]), z, p[5])
    y2 = _fma(_fma(z, p[6], p[7]), z, p[8])
    y = _fma(_fma(y, z3, y1), z3, y2)
    y = _fma(y, z3, (_F32(_LOG_Q1) * e).astype(_F32))
    out = (z - (_F32(0.5) * z2).astype(_F32)).astype(_F32)
    return ((out + y).astype(_F32) + (_F32(_LOG_Q2) * e).astype(_F32)).astype(_F32)


def _log1p(x: np.ndarray) -> np.ndarray:
    x2 = x * x
    small = (_polynomial(x, _LOG1P_NUM) / _polynomial(x, _LOG1P_DEN)).astype(_F32)
    small = ((x * x2) * small).astype(_F32)
    small = x + _fma(np.full_like(x, -0.5), x2, small)
    large = log(x + _F32(1))
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small, large).astype(_F32)


def _erf_inv(x: np.ndarray) -> np.ndarray:
    w = -_log1p(x * -x)
    lt = w < _F32(5)
    w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3)).astype(_F32)
    p = np.where(lt, _F32(_ERFINV_LT5[0]), _F32(_ERFINV_GE5[0])).astype(_F32)
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, _F32(lo), _F32(hi)))
    return np.where(np.abs(x) == 1, x * _F32(np.inf), p * x).astype(_F32)


def normal(seed: int, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape)`` in float32."""
    n = int(np.prod(shape))
    counts = np.arange(n, dtype=np.uint64)
    b1, b2 = threefry2x32(seed >> 32 & 0xFFFFFFFF, seed & 0xFFFFFFFF,
                          (counts >> np.uint64(32)).astype(np.uint32), counts.astype(np.uint32))
    bits = b1 ^ b2
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(_F32) - _F32(1)
    lo = np.nextafter(_F32(-1), _F32(0))
    u = np.maximum(lo, floats * (_F32(1) - lo) + lo).astype(_F32)
    return (_F32(np.sqrt(2)) * _erf_inv(u)).reshape(shape)
