"""Fused attention for the trunk: a hand-written CUDA kernel + its plain version.

Trunk sequences are short (~298 steps of pooled 2 Hz features), and the
kernel (``csrc/attention.cu``) fuses q k^T -> softmax -> P v per
(batch, head) without writing the scores to device memory.  The gradient
is analytic: the backward recomputes the probabilities with plain tensor
ops, as the JAX package's ``_pallas_attention_bwd`` does.

Rotary embedding uses the interleaved (GPT-J) pairing of the JAX package.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda

__all__ = [
    "apply_rotary",
    "rotary_angles",
    "dot_product_attention",
    "fused_attention",
    "attention_forward",
    "vector_layout",
    "launch_counts",
]

#: kernel launches since the last reset, counted where the kernel launches
launch_counts: dict[str, int] = {"attention": 0}


def rotary_angles(seq_len: int, rot_dim: int, base: float = 10000.0) -> np.ndarray:
    """(seq_len, rot_dim/2) rotation angles (host-side constant)."""
    inv_freq = 1.0 / (base ** (np.arange(0, rot_dim, 2) / rot_dim))
    t = np.arange(seq_len)
    return np.einsum("t,f->tf", t, inv_freq).astype(np.float32)


def apply_rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the leading ``2*angles.shape[-1]`` dims of the head axis.

    x: (..., T, Dh); pairs are (x[2i], x[2i+1]) on the first rot_dim dims,
    the remainder passes through.  The output keeps the input dtype."""
    rot_dim = 2 * angles.shape[-1]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1 = x_rot[..., 0::2]
    x2 = x_rot[..., 1::2]
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """(B, H, T, Dh) attention, fp32 softmax accumulation.

    A fully-masked row returns zeros, not the uniform mean of V."""
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v)
    if mask is not None:
        any_valid = mask.any(dim=-1, keepdim=True)
        out = torch.where(any_valid, out, torch.zeros((), dtype=out.dtype, device=out.device))
    return out


_FORWARD = ("attention", "attn_forward", (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_longlong),
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_void_p,
))
_SMEM_BYTES = ("attention", "attn_smem_bytes", (ctypes.c_int,), ctypes.c_longlong)
#: elements the kernel moves at a time on its vector route
_VECTOR = 4


def vector_layout(head_dim: int, strides, data_ptrs, element_size: int) -> bool:
    """Whether the kernel may read q, k, v and write o four elements at a
    time: the head dim and every (b, h, t) stride in ``strides`` (one
    sequence a tensor) are multiples of 4 elements and every base in
    ``data_ptrs`` is aligned to 4 elements.  Otherwise the same kernel
    moves one element at a time.  A pure function of the layout, decided
    before the launch: it never copies and never retries."""
    return (head_dim % _VECTOR == 0
            and all(s % _VECTOR == 0 for st in strides for s in st[:3])
            and all(ptr % (_VECTOR * element_size) == 0 for ptr in data_ptrs))


def _output_like(q: torch.Tensor) -> torch.Tensor:
    """The kernel's output for q: allocated in (B, T, H, Dh) order and
    returned as a (B, H, T, Dh) view."""
    b, h, t, dh = q.shape
    return torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)


def _attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch ``attn_forward`` of csrc/attention.cu on the current stream.

    q, k and v may be strided views (the trunk's head split of its fused
    qkv projection) as long as the head dim is contiguous; the output is
    allocated in (B, T, H, Dh) order and returned as a (B, H, T, Dh) view,
    so the caller's merge of the heads is free.  ``vector_layout`` picks the
    kernel's load width from the four layouts."""
    _cuda.check_cuda("attention", q=q, k=k, v=v)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in _cuda.DTYPE_CODES:
            raise TypeError(f"attention kernel takes float32 or bfloat16, {name} is {x.dtype}")
        if x.dim() != 4 or x.shape != q.shape:
            raise ValueError(
                f"attention kernel wants q, k, v of one (B, H, T, Dh) shape, got "
                f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
            )
        if x.stride(-1) != 1:
            raise ValueError(f"attention kernel needs a unit stride on the head dim of {name}")
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError("attention kernel: q, k, v differ in dtype or device")
    b, h, t, dh = q.shape
    if t < 1 or dh < 1 or b * h < 1:
        raise ValueError(f"attention kernel: empty shape {tuple(q.shape)}")
    if b * h > 65535:
        raise ValueError(f"attention kernel: B*H={b * h} exceeds the grid's 65535")
    out = _output_like(q)
    tensors = (q, k, v, out)
    vec = vector_layout(dh, [x.stride() for x in tensors], [x.data_ptr() for x in tensors],
                        q.element_size())
    strides = (ctypes.c_longlong * 12)(*(s for x in tensors for s in x.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _cuda.function(*_FORWARD)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            b, h, t, dh, _cuda.DTYPE_CODES[q.dtype], int(vec), dh**-0.5, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"attention kernel launch failed: CUDA error {err} (shape {tuple(q.shape)}, "
            f"{_cuda.function(*_SMEM_BYTES)(dh)} B of shared memory per block)"
        )
    launch_counts["attention"] += 1
    return out


def attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unmasked attention: the CUDA kernel, or its plain version for CPU tensors."""
    if q.device.type == "cpu":
        return dot_product_attention(q, k, v)
    return _attention_cuda(q, k, v)


class _FusedAttention(torch.autograd.Function):
    """Kernel forward with the analytic backward of ``_pallas_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return attention_forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        scale = q.shape[-1] ** -0.5
        q32, k32, v32 = q.float(), k.float(), v.float()
        scores = torch.matmul(q32, k32.transpose(-1, -2))
        probs = torch.softmax(scores * scale, dim=-1)
        g32 = g.float()
        dv = torch.matmul(probs.transpose(-1, -2), g32)
        dprobs = torch.matmul(g32, v32.transpose(-1, -2))
        dscores = probs * (dprobs - torch.sum(dprobs * probs, dim=-1, keepdim=True))
        dq = scale * torch.matmul(dscores, k32)
        dk = scale * torch.matmul(dscores.transpose(-1, -2), q32)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Attention over (B, H, T, Dh).

    Unmasked calls go through the kernel (its plain version on the CPU);
    a masked call takes the masked plain version, as the JAX package routes
    masked calls to XLA."""
    if mask is not None:
        return dot_product_attention(q, k, v, mask)
    return _FusedAttention.apply(q, k, v)
