"""Trainable transformer trunk with rotary + ScaleNorm (torch.nn).

The port of algonauts2025_tpu/models/transformer.py: pre-norm blocks with
per-dim residual scales, rotary q/k (interleaved pairing), no-bias
attention projections, an erf-gelu FF and a final norm.  Attention runs
through ops.attention.fused_attention, the hand-written CUDA kernel on the
card.  Depth is an ``nn.ModuleList``; the JAX package's scanned
``(depth, ...)`` params are unstacked by ``models.convert``.
"""

from __future__ import annotations

import math
import typing as tp

import pydantic
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import apply_rotary, fused_attention, rotary_angles
from ..ops.fast_gelu import gelu_fast

__all__ = [
    "ScaleNorm",
    "SelfAttention",
    "FeedForward",
    "EncoderBlock",
    "TransformerEncoder",
    "TransformerEncoderConfig",
    "lecun_normal_",
]


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """flax's Dense kernel init (truncated normal, variance 1/fan_in) on a
    torch (out, in) weight."""
    std = math.sqrt(1.0 / weight.shape[-1]) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def _init_linear(layer: nn.Linear, generator: torch.Generator | None) -> None:
    lecun_normal_(layer.weight, generator)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


def _norm(dim: int, use_scalenorm: bool, device) -> nn.Module:
    """ScaleNorm, else x_transformers' LayerNorm: learned gain, no bias, eps 1e-5."""
    if use_scalenorm:
        return ScaleNorm(device=device)
    return nn.LayerNorm(dim, eps=1e-5, bias=False, device=device)


class ScaleNorm(nn.Module):
    """y = g * x / (||x|| / sqrt(d)) — a single learned scalar gain."""

    def __init__(self, eps: float = 1e-5, device=None) -> None:
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones((), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = x.shape[-1] ** -0.5
        # eps inside the sqrt keeps the gradient finite at zero rows
        norm = torch.sqrt(torch.sum(x**2, dim=-1, keepdim=True) + self.eps**2) * scale
        return x / torch.clamp(norm, min=self.eps) * self.g


class SelfAttention(nn.Module):
    def __init__(
        self, dim: int, heads: int, dim_head: int, rotary_dim: int,
        dropout: float = 0.0, device=None,
    ) -> None:
        super().__init__()
        self.heads, self.dim_head, self.rotary_dim = heads, dim_head, rotary_dim
        self.qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False, device=device)
        self.out = nn.Linear(heads * dim_head, dim, bias=False, device=device)
        self.dropout = nn.Dropout(dropout) if dropout > 0 else nn.Identity()
        self._angles: dict[tuple[int, torch.device], torch.Tensor] = {}

    def _rotary(self, t: int, device: torch.device) -> torch.Tensor:
        key = (t, device)
        if key not in self._angles:
            self._angles[key] = torch.from_numpy(rotary_angles(t, self.rotary_dim)).to(device)
        return self._angles[key]

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        b, t, _ = x.shape
        h, dh = self.heads, self.dim_head
        # (B, T, 3, H, Dh) -> three (B, H, T, Dh) strided views, no copies
        q, k, v = self.qkv(x).view(b, t, 3, h, dh).permute(2, 0, 3, 1, 4).unbind(0)
        if self.rotary_dim:
            ang = self._rotary(t, x.device)
            q = apply_rotary(q, ang)
            k = apply_rotary(k, ang)
        out = fused_attention(q, k, v, mask=mask)
        out = out.transpose(1, 2).reshape(b, t, h * dh)
        return self.dropout(self.out(out))


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0, device=None) -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim, dim * mult, device=device)
        self.fc2 = nn.Linear(dim * mult, dim, device=device)
        self.dropout = nn.Dropout(dropout) if dropout > 0 else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # erf-form gelu through the rational of ops.fast_gelu (1.3e-6 absolute)
        return self.fc2(self.dropout(gelu_fast(self.fc1(x))))


class EncoderBlock(nn.Module):
    """Pre-norm block: x = x*res_scale + branch(norm(x)), attn then FF."""

    def __init__(
        self, dim: int, heads: int, dim_head: int, rotary_dim: int, ff_mult: int,
        attn_dropout: float, ff_dropout: float, use_scalenorm: bool,
        scale_residual: bool, device=None,
    ) -> None:
        super().__init__()
        # per-dim residual gains (x_transformers Residual.residual_scale)
        if scale_residual:
            self.res_scale_attn = nn.Parameter(torch.ones(dim, device=device))
            self.res_scale_ff = nn.Parameter(torch.ones(dim, device=device))
        else:
            self.res_scale_attn = self.res_scale_ff = None
        self.attn_norm = _norm(dim, use_scalenorm, device)
        self.attn = SelfAttention(dim, heads, dim_head, rotary_dim, attn_dropout, device=device)
        self.ff_norm = _norm(dim, use_scalenorm, device)
        self.ff = FeedForward(dim, ff_mult, ff_dropout, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        branch = self.attn(self.attn_norm(x), mask)
        x = (x if self.res_scale_attn is None else x * self.res_scale_attn) + branch
        branch = self.ff(self.ff_norm(x))
        return (x if self.res_scale_ff is None else x * self.res_scale_ff) + branch


class TransformerEncoder(nn.Module):
    """Pre-norm encoder of ``depth`` blocks with a final norm."""

    def __init__(
        self,
        dim: int,
        depth: int = 8,
        heads: int = 8,
        dim_head: int | None = None,
        ff_mult: int = 4,
        attn_dropout: float = 0.0,
        ff_dropout: float = 0.0,
        use_scalenorm: bool = True,
        rotary_pos_emb: bool = True,
        scale_residual: bool = True,
        causal: bool = False,
        remat: bool = False,
        remat_policy: str | None = None,
        device=None,
    ) -> None:
        super().__init__()
        if remat_policy is not None:
            if remat_policy == "save_attn_out":
                raise NotImplementedError(
                    "remat_policy='save_attn_out' is not ported yet (ROADMAP, queue 1)"
                )
            raise ValueError(f"unknown remat_policy {remat_policy!r} (known: 'save_attn_out')")
        dh = dim_head or dim // heads
        rotary_dim = max(dh // 2, 32) if rotary_pos_emb else 0
        rotary_dim = min(rotary_dim, dh)
        self.causal, self.remat = causal, remat
        self.blocks = nn.ModuleList(
            EncoderBlock(
                dim, heads, dh, rotary_dim, ff_mult, attn_dropout, ff_dropout,
                use_scalenorm, scale_residual, device=device,
            )
            for _ in range(depth)
        )
        self.final_norm = _norm(dim, use_scalenorm, device)

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """flax's initialisers: lecun-normal kernels, zero biases, unit gains."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                _init_linear(module, generator)
            elif isinstance(module, (ScaleNorm, nn.LayerNorm)):
                nn.init.ones_(module.g if isinstance(module, ScaleNorm) else module.weight)
            elif isinstance(module, EncoderBlock) and module.res_scale_attn is not None:
                nn.init.ones_(module.res_scale_attn)
                nn.init.ones_(module.res_scale_ff)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mask = None
        if self.causal:
            t = x.shape[1]
            mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()[None, None]
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                # full remat: keep only the block input, recompute the rest
                x = checkpoint(block, x, mask, use_reentrant=False)
            else:
                x = block(x, mask)
        return self.final_norm(x)


class TransformerEncoderConfig(pydantic.BaseModel):
    """Config surface mirroring the reference TransformerEncoderConfig."""

    model_config = pydantic.ConfigDict(extra="forbid")
    name: tp.Literal["TransformerEncoder"] = "TransformerEncoder"
    heads: int = 8
    depth: int = 12
    cross_attend: bool = False
    causal: bool = False
    attn_flash: bool = False  # parity field; the kernel is always fused
    attn_dropout: float = 0.1
    ff_mult: int = 4
    ff_dropout: float = 0.0
    use_scalenorm: bool = True
    use_rmsnorm: bool = False
    rel_pos_bias: bool = False
    alibi_pos_bias: bool = False
    rotary_pos_emb: bool = True
    rotary_xpos: bool = False
    residual_attn: bool = False
    scale_residual: bool = True
    layer_dropout: float = 0.0

    #: accepted-for-parity fields whose non-default values would build a
    #: different architecture in the reference; fail loudly instead.
    _UNSUPPORTED_DEFAULTS: tp.ClassVar[dict[str, tp.Any]] = {
        "cross_attend": False,
        "use_rmsnorm": False,
        "rel_pos_bias": False,
        "alibi_pos_bias": False,
        "rotary_xpos": False,
        "residual_attn": False,
        "layer_dropout": 0.0,
    }

    def build(self, dim: int, device=None) -> TransformerEncoder:
        if dim % self.heads != 0:
            raise ValueError(f"dim ({dim}) must be divisible by heads ({self.heads})")
        engaged = {
            k for k, v in self._UNSUPPORTED_DEFAULTS.items() if getattr(self, k) != v
        }
        if engaged:
            raise NotImplementedError(
                f"TransformerEncoderConfig fields {sorted(engaged)} change the "
                "architecture in the reference (x_transformers) but are not "
                "implemented by this trunk; refusing to build a different model"
            )
        return TransformerEncoder(
            dim=dim,
            depth=self.depth,
            heads=self.heads,
            dim_head=dim // self.heads,
            ff_mult=self.ff_mult,
            attn_dropout=self.attn_dropout,
            ff_dropout=self.ff_dropout,
            use_scalenorm=self.use_scalenorm,
            rotary_pos_emb=self.rotary_pos_emb,
            scale_residual=self.scale_residual,
            causal=self.causal,
            device=device,
        )
