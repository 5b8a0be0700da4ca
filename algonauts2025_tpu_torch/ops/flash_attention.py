"""Long-sequence attention of the video backbone: a CUDA kernel + its plain version.

The port of the dispatch of algonauts2025_tpu/ops/flash_attention.py for
the case the video backbone takes: non-causal, no key lengths, a head dim
that is not a multiple of 128 (ViT-G: 8192 tokens, 22 heads of 64).  The
JAX package runs it as ``_bounded_kernel``; here ``csrc/flash_attention.cu``
computes the same function: the softmax scale folded into q and rounded to
q's dtype, p rounded to v's dtype before the P.V product, the row sum over
that rounded p.  It shifts the scores by their running maximum, so unlike
the TPU kernel's a-priori shift it cannot overflow when the scores of a
row spread widely.

The causal / key-length case (``_flash_kernel``, the text slice) and the
off-dispatch ``_fast_flash`` and ``flash_attention_packed`` are not
ported yet (ROADMAP queue 2).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

__all__ = ["flash_attention", "bounded_attention_plain", "launch_counts"]

#: kernel launches since the last reset, counted where the kernel launches
launch_counts: dict[str, int] = {"flash_attention": 0}

_FORWARD = ("flash_attention", "flash_forward", (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_longlong),
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_void_p,
))
_MAX_HEAD_DIM = ("flash_attention", "flash_max_head_dim", ())
#: query rows per chunk of the plain version: its fp32 scores are then
#: (B, H, 1024, T), 0.74 GB for 22 heads of 8192 tokens, not 5.9 GB
_PLAIN_ROWS = 1024


def bounded_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, T, d) exact softmax attention with the kernel's roundings.

    Computed in chunks of query rows (rows are independent, so chunking
    changes no value) so that the scores of 8192 tokens fit in memory."""
    scale = q.shape[-1] ** -0.5
    kf, vf = k.float(), v.float()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for r0 in range(0, q.shape[-2], _PLAIN_ROWS):
        qs = (q[..., r0 : r0 + _PLAIN_ROWS, :].float() * scale).to(q.dtype).float()
        s = torch.matmul(qs, kf.transpose(-1, -2))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(v.dtype).float()
        o = torch.matmul(p, vf) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        out[..., r0 : r0 + _PLAIN_ROWS, :] = o.to(q.dtype)
    return out


def _flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch ``flash_forward`` of csrc/flash_attention.cu on the current stream.

    q, k and v may be strided views as long as the head dim is contiguous;
    the output is allocated in (B, T, H, d) order and returned as a
    (B, H, T, d) view, so the caller's merge of the heads is free."""
    _cuda.check_cuda("flash attention", q=q, k=k, v=v)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in _cuda.DTYPE_CODES:
            raise TypeError(f"flash attention kernel takes float32 or bfloat16, {name} is {x.dtype}")
        if x.dim() != 4 or x.shape != q.shape:
            raise ValueError(
                f"flash attention kernel wants q, k, v of one (B, H, T, d) shape, got "
                f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
            )
        if x.stride(-1) != 1:
            raise ValueError(f"flash attention kernel needs a unit stride on the head dim of {name}")
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError("flash attention kernel: q, k, v differ in dtype or device")
    b, h, t, d = q.shape
    max_d = _cuda.function(*_MAX_HEAD_DIM)()
    if t < 1 or b * h < 1 or not 1 <= d <= max_d:
        raise ValueError(
            f"flash attention kernel: shape {tuple(q.shape)}; it takes head dims "
            f"1..{max_d} and a non-empty T"
        )
    if b * h > 65535:
        raise ValueError(f"flash attention kernel: B*H={b * h} exceeds the grid's 65535")
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, out) for s in x.stride()[:3]))
    with torch.cuda.device(q.device):
        err = _cuda.function(*_FORWARD)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            b, h, t, d, _cuda.DTYPE_CODES[q.dtype], d**-0.5, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err} (shape {tuple(q.shape)})")
    launch_counts["flash_attention"] += 1
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, H, T, d) attention without materialized scores.

    The non-causal, unmasked case with ``d % 128 != 0`` (the JAX package's
    ``_bounded_kernel`` dispatch): the kernel for CUDA tensors, its plain
    version for CPU tensors.  The kernel tiles T itself, so the JAX
    package's q/kv block sizes have no counterpart here."""
    if causal or lengths is not None or q.shape[-1] % 128 == 0:
        raise NotImplementedError(
            "flash_attention with causal=True, key lengths or a head dim that is a multiple "
            "of 128 runs _flash_kernel, which the text slice ports (ROADMAP queue 2)"
        )
    if q.device.type == "cpu":
        return bounded_attention_plain(q, k, v)
    return _flash_cuda(q, k, v)
