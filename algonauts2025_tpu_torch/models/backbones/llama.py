"""Llama-3.x decoder backbone (torch.nn) for frozen text features.

The port of algonauts2025_tpu/models/backbones/llama.py: GQA attention with
llama3-scaled RoPE (half-split pairing, unlike the trunk's interleaved
rotary), RMSNorm, a SwiGLU MLP of bias-free denses, returning the full
(L+1, B, T, D) fp32 hidden-state stack: the embedding, layers 1..L-1 and
the final norm of layer L (HF parity).

The dtype casts are the JAX package's: ``cfg.dtype`` (bf16) activations
and weights, RMSNorm statistics and gain in fp32 with the output cast
back, RoPE in fp32 then cast.  On a CUDA card the attention of a
right-padded batch with T >= 256 and T % 128 == 0 runs the masked flash
kernel of ops/flash_attention.py, where the JAX package runs its Pallas
``_flash_kernel`` on a TPU; elsewhere (and on the CPU) the masked plain
attention runs, as the JAX package's XLA path does.  The scanned ``(L,
...)`` params of the JAX package are one module per layer here
(``models.convert.llama_params_to_torch`` unstacks them).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import dot_product_attention
from ...ops.flash_attention import flash_attention

__all__ = ["LlamaConfig", "LlamaBackbone", "params_from_hf", "attention_inputs", "LLAMA_3P2_3B"]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 3072
    intermediate_size: int = 8192
    num_layers: int = 28
    num_heads: int = 24
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    # llama3 rope scaling (3.2 family)
    rope_scaling_factor: float = 32.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    dtype: torch.dtype = torch.bfloat16


#: the published meta-llama/Llama-3.2-3B shapes
LLAMA_3P2_3B = LlamaConfig()
#: the std of HF LlamaConfig's ``initializer_range``
INITIALIZER_RANGE = 0.02


def _llama3_rope_freqs(cfg: LlamaConfig) -> np.ndarray:
    """Inverse frequencies with the llama3 long-context rescaling (float64,
    then float32)."""
    inv_freq = 1.0 / (
        cfg.rope_theta ** (np.arange(0, cfg.head_dim, 2, dtype=np.float64) / cfg.head_dim)
    )
    if cfg.rope_scaling_factor and cfg.rope_scaling_factor != 1.0:
        low_wavelen = cfg.rope_original_max_position / cfg.rope_low_freq_factor
        high_wavelen = cfg.rope_original_max_position / cfg.rope_high_freq_factor
        wavelen = 2 * np.pi / inv_freq
        scaled = inv_freq / cfg.rope_scaling_factor
        smooth = (cfg.rope_original_max_position / wavelen - cfg.rope_low_freq_factor) / (
            cfg.rope_high_freq_factor - cfg.rope_low_freq_factor
        )
        smoothed = (1 - smooth) * scaled + smooth * inv_freq
        inv_freq = np.where(
            wavelen > low_wavelen,
            scaled,
            np.where(wavelen < high_wavelen, inv_freq, smoothed),
        )
    return inv_freq.astype(np.float32)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    """The half-split rotation pairing (x[i], x[i + d/2])."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


class RMSNorm(nn.Module):
    """fp32 statistics and an fp32 gain; the output in the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.pow(2).mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.weight).to(x.dtype)


def _dense(cfg: LlamaConfig, in_features: int, features: int, device) -> nn.Linear:
    return nn.Linear(in_features, features, bias=False, dtype=cfg.dtype, device=device)


class LlamaMlp(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        self.gate_proj = _dense(cfg, cfg.hidden_size, cfg.intermediate_size, device)
        self.up_proj = _dense(cfg, cfg.hidden_size, cfg.intermediate_size, device)
        self.down_proj = _dense(cfg, cfg.intermediate_size, cfg.hidden_size, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


def _decoder_attention(q, k, v, mask, lengths):
    """Causal decoder attention: the masked flash kernel on the card (right-
    padded lengths masked in the kernel, k and v at their kv heads), the
    masked plain attention over repeated k and v elsewhere."""
    t = q.shape[-2]
    if q.is_cuda and lengths is not None and t >= 256 and t % 128 == 0:
        return flash_attention(q, k, v, causal=True, lengths=lengths)
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    # fully-masked rows zero-fill, matching the flash kernel
    return dot_product_attention(q, k, v, mask=mask)


class LlamaAttention(nn.Module):
    """GQA attention with per-batch llama3 RoPE tables (padding tolerant)."""

    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.q_proj = _dense(cfg, cfg.hidden_size, cfg.num_heads * hd, device)
        self.k_proj = _dense(cfg, cfg.hidden_size, cfg.num_kv_heads * hd, device)
        self.v_proj = _dense(cfg, cfg.hidden_size, cfg.num_kv_heads * hd, device)
        self.o_proj = _dense(cfg, cfg.num_heads * hd, cfg.hidden_size, device)

    def forward(self, x, cos, sin, mask, lengths=None):
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.head_dim
        # head-split views (B, heads, T, hd) of the (B, T, heads*hd) projections
        q = self.q_proj(x).reshape(b, t, cfg.num_heads, hd).transpose(1, 2)
        k = self.k_proj(x).reshape(b, t, cfg.num_kv_heads, hd).transpose(1, 2)
        v = self.v_proj(x).reshape(b, t, cfg.num_kv_heads, hd).transpose(1, 2)

        def rope(z):
            z32 = z.float()
            return (z32 * cos[:, None] + _rotate_half(z32) * sin[:, None]).to(cfg.dtype)

        out = _decoder_attention(rope(q), rope(k), v, mask, lengths)
        return self.o_proj(out.transpose(1, 2).reshape(b, t, cfg.num_heads * hd))


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, device=device)
        self.attn = LlamaAttention(cfg, device=device)
        self.post_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, device=device)
        self.mlp = LlamaMlp(cfg, device=device)

    def forward(self, x, cos, sin, mask, lengths):
        x = x + self.attn(self.input_norm(x), cos, sin, mask, lengths)
        return x + self.mlp(self.post_norm(x))


def attention_inputs(cfg: LlamaConfig, attention_mask: torch.Tensor):
    """Layer-invariant attention inputs from a (B, T) padding mask.

    Returns ``(cos, sin, mask, lengths, right_padded)``: the per-batch
    llama3 RoPE tables (B, T, hd) for cumsum-derived positions, the
    causal+pad (B, 1, T, T) mask, per-row token counts (int32), and the
    right-pad-contract validity flag per row."""
    t = attention_mask.shape[-1]
    device = attention_mask.device
    positions = torch.clamp(torch.cumsum(attention_mask, dim=-1) - 1, min=0)
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=device))[None, None]
    mask = causal & attention_mask[:, None, None, :].bool()
    inv = torch.from_numpy(_llama3_rope_freqs(cfg)).to(device)
    ang = positions[..., None].float() * inv  # (B, T, hd/2)
    emb = torch.cat([ang, ang], dim=-1)
    lengths = attention_mask.sum(dim=-1).to(torch.int32)
    right_padded = (
        attention_mask.bool() == (torch.arange(t, device=device)[None] < lengths[:, None])
    ).all(dim=-1)
    return torch.cos(emb), torch.sin(emb), mask, lengths, right_padded


class LlamaBackbone(nn.Module):
    """Frozen decoder; returns all hidden states (L+1, B, T, D) in fp32.

    ``attention_mask`` must be RIGHT-padded (1s then 0s); rows violating
    the contract return NaN states from entry 1 on, on every device (the
    flash kernel could not honor them, and a silent card/CPU divergence is
    worse).  Entry 0, the embedding, is not poisoned, as in the JAX
    package."""

    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype, device=device)
        self.layers = nn.ModuleList(LlamaLayer(cfg, device=device) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, device=device)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator | None = None) -> "LlamaBackbone":
        """Random weights as HF initializes a Llama: normal(0,
        INITIALIZER_RANGE) for the embedding and every dense, unit RMSNorm
        gains."""
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * INITIALIZER_RANGE)
        return self

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg
        b, t = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, t), dtype=torch.int32, device=input_ids.device)
        x = self.embed_tokens(input_ids)
        cos, sin, mask, lengths, right_padded = attention_inputs(cfg, attention_mask)
        out = torch.empty((cfg.num_layers + 1, b, t, cfg.hidden_size), device=x.device)
        out[0] = x
        # CONTRACT: masks are right-padded; the flash kernel masks columns
        # >= lengths, which only right padding makes correct, so violating
        # rows are poisoned on every device
        x = torch.where(right_padded[:, None, None], x, torch.nan)
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, mask, lengths)
            if i + 1 < cfg.num_layers:
                out[i + 1] = x
        out[-1] = self.final_norm(x)
        return out


def params_from_hf(state_dict: tp.Mapping[str, tp.Any], cfg: LlamaConfig) -> dict[str, torch.Tensor]:
    """An HF LlamaModel state dict -> this backbone's state dict.

    Takes any mapping of arrays or tensors (no ``transformers``).  Every
    tensor passes through float32 before its target dtype (``cfg.dtype`` for
    the embedding and denses, float32 for the RMSNorm gains), as the JAX
    package's ``params_from_hf`` converts."""

    def arr(name: str, dtype: torch.dtype | None = None) -> torch.Tensor:
        w = state_dict[name]
        w = w.detach().float().cpu() if isinstance(w, torch.Tensor) else torch.from_numpy(np.asarray(w, np.float32))
        return w.to(dtype or cfg.dtype)

    out = {"embed_tokens.weight": arr("embed_tokens.weight"),
           "final_norm.weight": arr("norm.weight", torch.float32)}
    for i in range(cfg.num_layers):
        src, dst = f"layers.{i}.", f"layers.{i}."
        out[dst + "input_norm.weight"] = arr(src + "input_layernorm.weight", torch.float32)
        out[dst + "post_norm.weight"] = arr(src + "post_attention_layernorm.weight", torch.float32)
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out[f"{dst}attn.{n}.weight"] = arr(f"{src}self_attn.{n}.weight")  # (out, in) on both sides
        for n in ("gate_proj", "up_proj", "down_proj"):
            out[f"{dst}mlp.{n}.weight"] = arr(f"{src}mlp.{n}.weight")
    return out
