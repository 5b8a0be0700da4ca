"""w8a8 int8 dense path of the frozen video backbone: plain ops + two kernels.

The port of algonauts2025_tpu/ops/quant.py.  Weights are int8 per output
column, activations int8 per row (dynamic) or by one calibrated static
scale.  ``int8_matmul_fused`` (``csrc/w8a8.cu``) and ``int8_mlp_fused``
(``csrc/int8_mlp.cu``), both over the int8 tensor-core GEMM of
``csrc/int8_wgmma.cuh``, are the hand-written CUDA counterparts of the two
Pallas kernels; each has its plain PyTorch version beside it
(``*_plain``, same arguments), which the wrapper runs for CPU tensors
only.  On a CUDA tensor the wrapper launches the kernel or raises.

Integer sums in the plain versions are exact: the int8 values are carried
as float64, whose 53-bit mantissa holds every partial sum here (at most
K * 127^2 < 2^27), and converted to float32 once, as the int32 -> float32
conversion of the kernels does.
"""

from __future__ import annotations

import ctypes
import re
import typing as tp

import numpy as np
import torch
from torch import nn

from . import _cuda

__all__ = [
    "quantize_weight",
    "int8_matmul",
    "int8_matmul_fused",
    "int8_matmul_fused_plain",
    "int8_mlp_fused",
    "int8_mlp_fused_plain",
    "gelu_erf_approx",
    "QuantDense",
    "quantize_tree",
    "quantize_dense_params",
    "calibrate_quant_scales",
    "gemm_block",
    "schedule_block",
    "gemm_instantiation",
    "gemm_l2_read_bytes",
    "INT8_GEMMS",
    "INT8_EPILOGUES",
    "launch_counts",
]

#: kernel launches since the last reset, counted where each kernel launches
#: (``w8a8_rope``: the w8a8 kernel with the rotary in its epilogue)
launch_counts: dict[str, int] = {"w8a8": 0, "w8a8_rope": 0, "int8_mlp": 0}

#: (library, entry point, argument types) of the kernels' C interfaces
_W8A8_ARGS = (ctypes.c_void_p, ctypes.c_int) + (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 4
_W8A8 = ("w8a8", "w8a8_forward", _W8A8_ARGS + (ctypes.c_void_p,))
_W8A8_ROPE = ("w8a8", "w8a8_rope_forward", _W8A8_ARGS + (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 2
              + (ctypes.c_void_p,))
_INT8_MLP = ("int8_mlp", "int8_mlp_forward", (
    (ctypes.c_void_p, ctypes.c_int) + (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 4
    + (ctypes.c_void_p,)
))
#: the fused kernels' K and N (F) must be multiples of this (the JAX
#: wrappers' rule, and the int8 core's 128-deep stages and 128-wide tiles)
_ALIGN = 128

#: the int8 core's schedules (csrc/int8_wgmma.cuh ``Schedule``): consumer
#: warpgroups, warpgroups a team (a team takes a tile; two teams take turns),
#: tile columns, ring stages, and the registers setmaxnreg gives a consumer
#: thread
_SCHEDULES = {"Cooperative": (2, 2, 256, 4, 240), "PingPong": (2, 1, 128, 6, 240),
              "PingPongPairs": (4, 2, 128, 5, 112)}
#: the schedule of each GEMM of the two int8 kernels, as w8a8.cu and
#: int8_mlp.cu instantiate them: row 6's GEMM, and fc1 and fc2 of row 7
INT8_GEMMS = {"w8a8": "PingPong", "fc1": "PingPongPairs", "fc2": "Cooperative"}
#: the GEMM instantiations of the int8 core in each int8 kernel's library,
#: one an epilogue, by their epilogue as ``gemm_instantiation`` reads it
#: (w8a8: dequant by sx to fp32 and bf16, and the bf16 one rotated; the MLP:
#: fc1's gelu/requant, fc2's dequant by sh to fp32 and bf16), and the GEMM
#: of ``INT8_GEMMS`` each serves, which gives its schedule
INT8_EPILOGUES = {
    "w8a8": {"StoreDequantIfLi0EE": "w8a8", "StoreDequantI13__nv_bfloat16Li0EE": "w8a8",
             "StoreDequantRope": "w8a8"},
    "int8_mlp": {"StoreGeluQuant": "fc1", "StoreDequantIfLi1EE": "fc2", "StoreDequantI13__nv_bfloat16Li1EE": "fc2"},
}
#: the core's tile rows, stage depth, the registers setmaxnreg leaves a
#: producer thread, and the bytes of one staged piece of the output (64 rows
#: x 128 bytes)
_BM, _BK, _PRODUCER_REGS, _PIECE_BYTES = 128, 128, 24, 64 * 128


def gemm_block(gemm: str) -> dict[str, tp.Any]:
    """The block the int8 core launches for ``gemm`` ("w8a8", "fc1" or
    "fc2"): ``schedule_block`` of its schedule."""
    return schedule_block(INT8_GEMMS[gemm])


def schedule_block(schedule: str) -> dict[str, tp.Any]:
    """The block the int8 core launches on ``schedule`` ("Cooperative",
    "PingPong" or "PingPongPairs"): a pure function mirroring
    ``i8wg::Schedule`` and ``i8wg::Layout``.

    ``smem_bytes`` counts the A and Bt rings, two staged output pieces a
    consumer warpgroup, the full and empty mbarrier of each stage and the
    slack that aligns the base to 1024 bytes; ``acc_regs`` are a consumer
    thread's int32 accumulators; ``launch_regs`` is what
    ``__launch_bounds__(threads, 1)`` gives a thread, which the setmaxnreg
    split must not exceed."""
    from .flash_attention import tc_launch_regs

    warpgroups, team, bn, stages, consumer_regs = _SCHEDULES[schedule]
    threads = 128 * (warpgroups + 1)
    rows = _BM // team
    return {
        "schedule": schedule, "tile_m": _BM, "tile_n": bn, "stage_k": _BK, "stages": stages,
        "warpgroups": warpgroups, "team": team, "rows": rows, "acc_regs": rows // 64 * bn // 2,
        "threads": threads, "staging_bytes": warpgroups * 2 * _PIECE_BYTES,
        "smem_bytes": stages * (_BM + bn) * _BK + warpgroups * 2 * _PIECE_BYTES + 16 * stages + 1024,
        "consumer_regs": consumer_regs, "producer_regs": _PRODUCER_REGS,
        "launch_regs": tc_launch_regs(threads),
    }


def gemm_instantiation(name: str) -> tuple[str, str | None]:
    """(epilogue, schedule) of a mangled ``gemm_kernel`` name of the int8
    core, the epilogue as ``INT8_EPILOGUES`` names it; the schedule is None
    in a core without schedules."""
    epilogue = re.search(r"(StoreGeluQuant|StoreDequantRope|StoreDequantI\w+?Li\dEE)", name).group(1)
    schedule = re.search(r"(Cooperative|PingPongPairs|PingPong)", name)
    return epilogue, schedule and schedule.group(1)


def gemm_l2_read_bytes(m: int, n: int, k: int, tile_m: int, tile_n: int) -> int:
    """The bytes an int8 (m, k) x (k, n) GEMM in tile_m x tile_n tiles reads
    from L2: every tile reads its A row panel and its B column panel once
    (a tile past n reads no B beyond it), so A's bytes n / tile_n times and
    B's m / tile_m times, rounded up."""
    return m * k * -(-n // tile_n) + n * k * -(-m // tile_m)


def _static_scale(s, poison_if: torch.Tensor | None = None) -> torch.Tensor:
    """Validate a calibrated static activation scale.

    a_scale == 0 is the "uncalibrated" sentinel; running the static path
    with it would saturate every activation to +/-127 and give plausible
    finite garbage.  The scale becomes NaN instead, so the output is NaN.
    ``poison_if`` lets coupled scales (the fused MLP's x/h pair) poison
    together."""
    s = torch.as_tensor(s, dtype=torch.float32)
    bad = s <= 0 if poison_if is None else poison_if
    return torch.where(bad, torch.full_like(s, float("nan")), s.clamp_min(1e-12))


def quantize_weight(w: np.ndarray | torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., K, N) float weights -> (int8 (..., K, N), float32 scale (..., N)).

    Per output column; leading axes (a stacked (L, K, N)) get their own
    scales.  Rounds half to even, bit for bit as the JAX package's host
    quantization."""
    w32 = torch.as_tensor(np.asarray(w, np.float32)) if isinstance(w, np.ndarray) else w.float()
    scale = (w32.abs().amax(dim=-2) / 127.0).clamp_min(1e-12)
    w_q = torch.clamp(torch.round(w32 / scale[..., None, :]), -127, 127).to(torch.int8)
    return w_q, scale


def _quantize(xf: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """round(x / sx) clipped to +-127, kept as float (a NaN stays NaN)."""
    return torch.clamp(torch.round(xf / sx), -127.0, 127.0)


def _int_matmul(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8-valued xq (M, K) and w_q (K, N), as the
    float32 rounding of the int32 sums."""
    return torch.matmul(xq.double(), w_q.double()).float()


def int8_matmul(
    x: torch.Tensor,
    w_q: torch.Tensor,
    w_scale: torch.Tensor,
    x_scale: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """x (..., K) float @ int8 (K, N) -> float32 (..., N).

    ``x_scale=None``: dynamic per-row activation scales; a scalar: the
    static calibrated scale (NaN-poisoned when it is 0)."""
    lead = x.shape[:-1]
    xf = x.float().reshape(-1, x.shape[-1])
    if x_scale is None:
        sx = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    else:
        sx = _static_scale(x_scale).to(xf.device)
    acc = _int_matmul(_quantize(xf, sx), w_q)
    out = acc * sx * w_scale[None]
    return out.reshape(*lead, w_q.shape[-1])


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add.

    The product is exact in float64; the float64 sum is rounded to odd
    (TwoSum gives its exact error), which makes the final rounding to
    float32 exact as well."""
    a, b, c = torch.broadcast_tensors(a.double(), b.double(), c.double())
    p = a * b
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=s.device)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even, torch.nextafter(s, torch.where(err > 0, inf, -inf)), s)
    return s.float()


def _dequant(acc, scale, w_scale, bias):
    """The kernels' epilogue: fma(acc, scale * w_scale[n], bias[n]) in float32
    (as XLA fuses the JAX kernels' ``acc * scale + bias``)."""
    return _fma(acc, (scale * w_scale.float())[None], bias.float()[None])


def _bias(bias: torch.Tensor | None, n: int, device) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.float32, device=device) if bias is None else bias.float()


def _rotate(y: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The V-JEPA rotary of every head of y (M, N): row m is token m % T of
    the (T, hd) fp32 tables, and each head's interleaved lane pairs rotate
    in fp32, by separate multiplies and an add, as ``_apply_rope`` of
    models/backbones/vjepa2.py does."""
    t, hd = cos.shape
    y32 = y.float().reshape(-1, t, y.shape[-1] // hd, hd)
    pair = y32.reshape(*y32.shape[:-1], hd // 2, 2)
    rot = torch.stack([-pair[..., 1], pair[..., 0]], dim=-1).reshape(y32.shape)
    return (y32 * cos[:, None] + rot * sin[:, None]).to(y.dtype).reshape(y.shape)


def _check_rope(rope, x: torch.Tensor, m: int, out_dtype: torch.dtype) -> None:
    """Raise unless ``rope`` is the (cos, sin) pair that the rotating
    epilogue takes for an (m, N) output: fp32, contiguous, on x's device,
    both (T, hd) with T dividing m and hd even and dividing 128 (so that no
    pair or head straddles a 128-wide tile), and a bf16 output."""
    cos, sin = rope
    if out_dtype != torch.bfloat16:
        raise TypeError(f"int8_matmul_fused: the rotary's output is bfloat16, got {out_dtype}")
    for name, table in (("cos", cos), ("sin", sin)):
        if table.dtype != torch.float32:
            raise TypeError(f"int8_matmul_fused: rope {name} must be float32, got {table.dtype}")
        if not table.is_contiguous() or table.device != x.device:
            raise ValueError(f"int8_matmul_fused: rope {name} must be contiguous on {x.device}")
    if cos.dim() != 2 or sin.shape != cos.shape:
        raise ValueError(f"int8_matmul_fused: rope tables must be two (T, hd), got {tuple(cos.shape)}, "
                         f"{tuple(sin.shape)}")
    t, hd = cos.shape
    if t < 1 or m % t or hd % 2 or _ALIGN % hd:
        raise ValueError(f"int8_matmul_fused: rope tables ({t}, {hd}) need T dividing M={m} and an even "
                         f"hd dividing {_ALIGN}")


def int8_matmul_fused_plain(
    x: torch.Tensor,
    w_q: torch.Tensor,
    w_scale: torch.Tensor,
    x_scale: torch.Tensor | float,
    bias: torch.Tensor | None = None,
    out_dtype: torch.dtype = torch.bfloat16,
    *,
    w_kmajor: torch.Tensor | None = None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """The plain version of ``int8_matmul_fused`` on any device, equal to
    the kernel bit for bit; it reads the (K, N) weight and takes the
    K-major copy only to share the kernel's arguments."""
    k, n = w_q.shape
    sx = _static_scale(x_scale).to(x.device)
    acc = _int_matmul(_quantize(x.float().reshape(-1, k), sx), w_q)
    out = _dequant(acc, sx, w_scale, _bias(bias, n, x.device)).to(out_dtype)
    if rope is not None:
        out = _rotate(out, *rope)
    return out.reshape(*x.shape[:-1], n)


def _check_float(name: str, x: torch.Tensor, out_dtype: torch.dtype) -> None:
    if x.dtype not in _cuda.DTYPE_CODES or out_dtype not in _cuda.DTYPE_CODES:
        raise TypeError(
            f"{name} kernel takes float32 or bfloat16 in and out, got {x.dtype} -> {out_dtype}"
        )
    if x.numel() == 0:
        raise ValueError(f"{name} kernel: empty input {tuple(x.shape)}")


def int8_matmul_fused(
    x: torch.Tensor,
    w_q: torch.Tensor,
    w_scale: torch.Tensor,
    x_scale: torch.Tensor | float,
    bias: torch.Tensor | None = None,
    out_dtype: torch.dtype = torch.bfloat16,
    *,
    w_kmajor: torch.Tensor | None = None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Static-scale w8a8 dense: float x (..., K) @ int8 (K, N) + bias -> out_dtype.

    The kernel (CUDA tensors) or its plain version (CPU tensors); the two
    agree bit for bit.  ``x_scale`` is the calibrated static scale; 0
    poisons the output with NaN.  K and N must be multiples of 128, as the
    JAX wrapper requires.  The kernel reads its weight K-major:
    ``w_kmajor`` is ``w_q.T`` (N, K), contiguous, required on a CUDA card
    and ignored on the CPU.  ``rope`` (cos, sin), two (T, hd) fp32 tables,
    rotates the bf16 output's heads in the epilogue: the output's rows are
    (..., T) tokens, its columns heads of hd interleaved lane pairs
    (``_check_rope``); bit for bit the bf16 dense followed by the V-JEPA
    rotary (``_apply_rope`` of models/backbones/vjepa2.py)."""
    lead = x.shape[:-1]
    k, n = w_q.shape
    if x.shape[-1] != k:
        raise ValueError(f"int8_matmul_fused: x has K={x.shape[-1]}, w_q is {tuple(w_q.shape)}")
    if k % _ALIGN or n % _ALIGN:
        raise ValueError(f"int8_matmul_fused needs 128-aligned dims, got K={k}, N={n}")
    if w_kmajor is not None and tuple(w_kmajor.shape) != (n, k):
        raise ValueError(
            f"int8_matmul_fused: w_kmajor must be {(n, k)} (K-major), got {tuple(w_kmajor.shape)}"
        )
    m = x.numel() // k
    if rope is not None:
        _check_rope(rope, x, m, out_dtype)
    if x.device.type == "cpu":
        return int8_matmul_fused_plain(x, w_q, w_scale, x_scale, bias, out_dtype, rope=rope)
    if w_kmajor is None:
        raise ValueError("w8a8 kernel: w_kmajor (the K-major weight) is required")
    x2 = x.reshape(-1, k)
    sx = _static_scale(x_scale).to(x.device).reshape(1)
    bias, w_scale = _bias(bias, n, x.device), w_scale.float()
    _check_float("w8a8", x2, out_dtype)
    _cuda.check_cuda("w8a8", contiguous=True, x=x2, w_kmajor=w_kmajor, w_scale=w_scale, bias=bias,
                     x_scale=sx)
    if w_kmajor.dtype != torch.int8:
        raise TypeError(f"w8a8 kernel: w_kmajor must be int8, got {w_kmajor.dtype}")
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    codes = _cuda.DTYPE_CODES
    args = (x2.data_ptr(), codes[x2.dtype], w_kmajor.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
            sx.data_ptr(), xq.data_ptr(), out.data_ptr(), codes[out_dtype], m, n, k)
    name = "w8a8" if rope is None else "w8a8_rope"
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if rope is None:
            err = _cuda.function(*_W8A8)(*args, stream)
        else:
            cos, sin = rope
            err = _cuda.function(*_W8A8_ROPE)(*args, cos.data_ptr(), sin.data_ptr(), *cos.shape, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} (M={m}, K={k}, N={n})")
    launch_counts[name] += 1
    return out.reshape(*lead, n)


def gelu_erf_approx(x: torch.Tensor) -> torch.Tensor:
    """Exact-form gelu with Abramowitz-Stegun 7.1.26 for erf (max |err|
    1.5e-7), operation by operation as the JAX package's _gelu_erf_approx
    and the fused MLP kernel compute it."""
    z = x * 0.7071067811865476
    a = torch.abs(z)
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (
        0.254829592
        + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429)))
    )
    erf_abs = 1.0 - poly * torch.exp(-a * a)
    erf = torch.sign(z) * erf_abs
    return 0.5 * x * (1.0 + erf)


def _coupled_scales(x_scale, h_scale, device) -> torch.Tensor:
    """(sx, sh), both NaN when either is uncalibrated: the int8 cast between
    the two GEMMs would otherwise launder a NaN hidden state."""
    sx = torch.as_tensor(x_scale, dtype=torch.float32).to(device)
    sh = torch.as_tensor(h_scale, dtype=torch.float32).to(device)
    bad = (sx <= 0) | (sh <= 0)
    return torch.stack([_static_scale(sx, poison_if=bad), _static_scale(sh, poison_if=bad)])


def int8_mlp_fused_plain(
    x: torch.Tensor,
    w1_q: torch.Tensor,
    w1_scale: torch.Tensor,
    b1: torch.Tensor,
    w2_q: torch.Tensor,
    w2_scale: torch.Tensor,
    b2: torch.Tensor,
    x_scale: torch.Tensor | float,
    h_scale: torch.Tensor | float,
    out_dtype: torch.dtype = torch.bfloat16,
    *,
    w1_kmajor: torch.Tensor | None = None,
    w2_kmajor: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain version of ``int8_mlp_fused`` on any device; it reads the
    (K, N) weights and takes the K-major copies only to share the kernel's
    arguments."""
    k = w1_q.shape[0]
    sx, sh = _coupled_scales(x_scale, h_scale, x.device)
    xf = x.float().reshape(-1, k)
    h = gelu_erf_approx(_dequant(_int_matmul(_quantize(xf, sx), w1_q), sx, w1_scale, b1))
    acc = _int_matmul(_quantize(h, sh), w2_q)
    return _dequant(acc, sh, w2_scale, b2).to(out_dtype).reshape(*x.shape[:-1], k)


def int8_mlp_fused(
    x: torch.Tensor,
    w1_q: torch.Tensor,
    w1_scale: torch.Tensor,
    b1: torch.Tensor,
    w2_q: torch.Tensor,
    w2_scale: torch.Tensor,
    b2: torch.Tensor,
    x_scale: torch.Tensor | float,
    h_scale: torch.Tensor | float,
    out_dtype: torch.dtype = torch.bfloat16,
    *,
    w1_kmajor: torch.Tensor | None = None,
    w2_kmajor: torch.Tensor | None = None,
) -> torch.Tensor:
    """Static-scale w8a8 MLP: gelu(x @ w1 + b1) @ w2 + b2, quantization inside.

    ``x_scale`` / ``h_scale`` are the calibrated scales of the input and of
    the post-gelu hidden state.  K and F must be multiples of 128, as the
    JAX wrapper requires.  The kernel (CUDA tensors) or its plain version
    (CPU tensors).  The kernel reads its weights K-major: ``w1_kmajor`` is
    ``w1_q.T`` (F, K) and ``w2_kmajor`` is ``w2_q.T`` (K, F), contiguous;
    both are required on a CUDA card and ignored on the CPU."""
    lead = x.shape[:-1]
    k, f = w1_q.shape
    if x.shape[-1] != k or w2_q.shape != (f, k):
        raise ValueError(
            f"int8_mlp_fused: x (..., {x.shape[-1]}), w1 {tuple(w1_q.shape)}, w2 {tuple(w2_q.shape)}"
        )
    if k % _ALIGN or f % _ALIGN:
        raise ValueError(f"int8_mlp_fused needs 128-aligned dims, got K={k}, F={f}")
    for name, w, want in (("w1_kmajor", w1_kmajor, (f, k)), ("w2_kmajor", w2_kmajor, (k, f))):
        if w is not None and tuple(w.shape) != want:
            raise ValueError(f"int8_mlp_fused: {name} must be {want} (K-major), got {tuple(w.shape)}")
    if x.device.type == "cpu":
        return int8_mlp_fused_plain(x, w1_q, w1_scale, b1, w2_q, w2_scale, b2, x_scale, h_scale,
                                    out_dtype)
    if w1_kmajor is None or w2_kmajor is None:
        raise ValueError("int8_mlp kernel: w1_kmajor and w2_kmajor (the K-major weights) are required")
    sc = _coupled_scales(x_scale, h_scale, x.device)
    x2 = x.reshape(-1, k)
    w1_scale, b1, w2_scale, b2 = (t.float() for t in (w1_scale, b1, w2_scale, b2))
    _check_float("int8_mlp", x2, out_dtype)
    _cuda.check_cuda("int8_mlp", contiguous=True, x=x2, w1_kmajor=w1_kmajor, w1_scale=w1_scale, b1=b1,
                     w2_kmajor=w2_kmajor, w2_scale=w2_scale, b2=b2, scales=sc)
    if w1_kmajor.dtype != torch.int8 or w2_kmajor.dtype != torch.int8:
        raise TypeError("int8_mlp kernel: w1_kmajor and w2_kmajor must be int8")
    m = x2.shape[0]
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    hidden = torch.empty((m, f), dtype=torch.int8, device=x.device)
    out = torch.empty((m, k), dtype=out_dtype, device=x.device)
    codes = _cuda.DTYPE_CODES
    with torch.cuda.device(x.device):
        err = _cuda.function(*_INT8_MLP)(
            x2.data_ptr(), codes[x2.dtype], w1_kmajor.data_ptr(), w1_scale.data_ptr(),
            b1.data_ptr(), w2_kmajor.data_ptr(), w2_scale.data_ptr(), b2.data_ptr(),
            sc.data_ptr(), xq.data_ptr(), hidden.data_ptr(), out.data_ptr(), codes[out_dtype],
            m, k, f, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"int8_mlp kernel launch failed: CUDA error {err} (M={m}, K={k}, F={f})")
    launch_counts["int8_mlp"] += 1
    return out.reshape(*lead, k)


class QuantDense:
    """Functional int8 dense over a params dict {kernel_q, scale, a_scale?, bias?}."""

    @staticmethod
    def apply(params: dict, x: torch.Tensor, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        # a calibrated static scale is honoured when the dict carries one
        y = int8_matmul(x, params["kernel_q"], params["scale"], x_scale=params.get("a_scale"))
        if "bias" in params:
            y = y + params["bias"].float()
        return y.to(out_dtype)


_DENSE_NAMES = ("query", "key", "value", "proj", "fc1", "fc2")


def quantize_tree(params: dict, names: tuple[str, ...] = _DENSE_NAMES) -> dict:
    """Quantize every named dense sub-dict {kernel, bias?} of a float params tree."""

    def walk(node):
        out = {}
        for key, value in node.items():
            if isinstance(value, dict) and key in names and "kernel" in value:
                out[key] = quantize_dense_params(value)
            elif isinstance(value, dict):
                out[key] = walk(value)
            else:
                out[key] = value
        return out

    return walk(params)


def quantize_dense_params(dense_params: dict) -> dict:
    """{'kernel', 'bias'?} -> {'kernel_q', 'scale', 'a_scale', 'bias'?}.

    A stacked (L, K, N) kernel gets per-layer scales; ``a_scale`` starts at
    0, the uncalibrated sentinel."""
    kernel = dense_params["kernel"]
    w_q, scale = quantize_weight(kernel)
    out = {"kernel_q": w_q, "scale": scale,
           "a_scale": torch.zeros(tuple(kernel.shape[:-2]), device=w_q.device)}
    if "bias" in dense_params:
        out["bias"] = torch.as_tensor(dense_params["bias"]).float()
    return out


def calibrate_quant_scales(model: nn.Module, *inputs: tp.Any, margin: float = 1.0) -> nn.Module:
    """Set static activation scales from one observed forward pass.

    Every quantized dense of ``model`` (a module with an ``observing`` flag,
    ``absmax`` and an ``a_scale`` buffer) records its input absmax during
    one forward of ``inputs``; each ``a_scale`` then becomes
    ``max(absmax * margin / 127, 1e-12)``.  Observing modules quantize
    dynamically, so a_scale == 0 does not corrupt deeper statistics.
    Updates ``model`` in place and returns it."""
    denses = [m for m in model.modules() if hasattr(m, "observing")]
    for m in denses:
        m.observing, m.absmax = True, None
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        for m in denses:
            m.observing = False
    for m in denses:
        if m.absmax is not None:
            m.a_scale.copy_((m.absmax * margin / 127.0).clamp_min(1e-12))
    return model
