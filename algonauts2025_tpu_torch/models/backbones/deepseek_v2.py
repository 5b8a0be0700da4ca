"""DeepSeek-V2 decoder backbone (torch.nn) for frozen text features.

The layer equations of the ``deepseek_v2`` checkpoints' own
``modeling_deepseek.py`` (DeepSeek-V2, arXiv:2405.04434), at the sizes of
``DeepSeek-V2-Lite`` by default, with the Llama backbone's contract:
right-padded (B, T) ids and mask in, the (L+1, B, T, D) fp32 hidden-state
stack out (the embedding, layers 1..L-1 and the final norm of layer L).

- Multi-head latent attention without a q LoRA: ``q = W_q h`` gives each
  head a 128-wide "nope" part and a 64-wide rotary part; ``W_kva h`` gives
  the 512-wide latent ``c_kv`` and one 64-wide rotary key shared by every
  head; ``c_kv`` passes an RMSNorm and ``W_kvb`` into each head's 128-wide
  key and value.  RoPE pairs interleaved dims (x[2i], x[2i+1]), with the
  yarn tables (``yarn_inv_freq``), and is written out de-interleaved as the
  published code writes it (a permutation that q and k share, so the
  scores are those of the interleaved form).  The softmax scale is
  (nope + rope)^-0.5 x yarn_mscale(factor, mscale_all_dim)^2, as
  ``modeling_deepseek.py`` sets it; transformers' native
  ``DeepseekV2Attention`` leaves the mscale^2 (1.5896 for the Lite) out.
- The first ``first_k_dense_replace`` layers have a dense SwiGLU MLP; the
  rest a mixture of experts (``ops/moe.py``): an fp32 router over
  ``n_routed_experts``, greedy top-k, the routed SwiGLUs' outputs weighted
  and summed in fp32 and cast, plus the shared experts (one SwiGLU of
  ``n_shared_experts`` x ``moe_intermediate_size``) that every token takes.

The dtype casts: ``cfg.dtype`` (bf16) weights and activations, RMSNorm
statistics and gain in fp32 with the output cast back, RoPE in fp32 then
cast, the router in fp32 from the upcast hidden state, the routed combine
in fp32.  The attention (``CausalAttention``) takes float32 scores of the
bf16 q and k, a float32 softmax, and rounds the normalised probabilities
to bf16 before their product with v, as the published eager attention
rounds them (its scores are bf16; the configuration states float32).  A fused kernel
that rounds exp(s - m) under a running max, as cuDNN's and flash
attention's do, departs from that by about the gap a bf16 rounding of the
scores makes, so it is not used.  The causal mask is exact for right-padded
rows (a valid query sees no padded key); a row whose mask is not
right-padded gives NaN states from entry 1 on.

Under a profiler each forward's stages are spans (``utils.profiling.span``):
``dsv2.embed``, then per layer ``mla.attention`` and ``dense.mlp`` or
``moe.route``, ``moe.experts`` and ``moe.shared``, and ``dsv2.final``.
``expert_tokens`` counts, on the device and without a host read, the valid
tokens routed to each expert of each MoE layer (``reset_expert_tokens``).
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import moe
from ...utils.profiling import span
from .llama import RMSNorm

__all__ = ["DeepseekV2Config", "DeepseekV2Backbone", "DEEPSEEK_V2_LITE", "config_from_hf", "params_from_hf",
           "from_hf", "yarn_inv_freq", "yarn_mscale", "softmax_scale", "CausalAttention"]


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_layers: int = 27
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    #: yarn rope scaling; a ``rope_factor`` of 1 turns it off
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    dtype: torch.dtype = torch.bfloat16

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace and layer % self.moe_layer_freq == 0

    @property
    def moe_layers(self) -> list[int]:
        return [i for i in range(self.num_layers) if self.is_moe(i)]


#: the published deepseek-ai/DeepSeek-V2-Lite shapes
DEEPSEEK_V2_LITE = DeepseekV2Config()
#: the std of the config's ``initializer_range``
INITIALIZER_RANGE = 0.02


def config_from_hf(c: tp.Mapping[str, tp.Any], dtype: torch.dtype = torch.bfloat16) -> DeepseekV2Config:
    """The config of a ``deepseek_v2`` ``config.json`` dict.  Raises on what
    this backbone does not compute: a q LoRA, another router."""
    if c.get("q_lora_rank") is not None:
        raise ValueError(f"q_lora_rank {c['q_lora_rank']}: this backbone computes the Lite's MLA without a q LoRA")
    if c.get("topk_method", "greedy") != "greedy" or c.get("scoring_func", "softmax") != "softmax":
        raise ValueError(f"router {c.get('topk_method')}/{c.get('scoring_func')}: only greedy top-k over a softmax")
    if c["num_key_value_heads"] != c["num_attention_heads"]:
        raise ValueError("MLA gives every head its own key and value")
    rope = c.get("rope_scaling") or {}
    kind = rope.get("rope_type", rope.get("type"))
    if rope and kind != "yarn":
        raise ValueError(f"rope_scaling {kind!r}: only yarn")
    return DeepseekV2Config(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"], intermediate_size=c["intermediate_size"],
        moe_intermediate_size=c["moe_intermediate_size"], num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"], kv_lora_rank=c["kv_lora_rank"], qk_nope_head_dim=c["qk_nope_head_dim"],
        qk_rope_head_dim=c["qk_rope_head_dim"], v_head_dim=c["v_head_dim"], n_routed_experts=c["n_routed_experts"],
        n_shared_experts=c["n_shared_experts"], num_experts_per_tok=c["num_experts_per_tok"],
        first_k_dense_replace=c["first_k_dense_replace"], moe_layer_freq=c.get("moe_layer_freq", 1),
        norm_topk_prob=c["norm_topk_prob"], routed_scaling_factor=c["routed_scaling_factor"],
        rope_theta=c["rope_theta"], rms_eps=c["rms_norm_eps"],
        rope_factor=rope.get("factor", 1.0),
        rope_original_max_position=rope.get("original_max_position_embeddings", 4096),
        rope_beta_fast=rope.get("beta_fast", 32), rope_beta_slow=rope.get("beta_slow", 1),
        rope_mscale=rope.get("mscale", 1.0), rope_mscale_all_dim=rope.get("mscale_all_dim", 0.0),
        dtype=dtype)


# -- yarn -----------------------------------------------------------------------

def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """0.1 x mscale x ln(factor) + 1 (1 without scaling)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def softmax_scale(cfg: DeepseekV2Config) -> float:
    """(nope + rope)^-0.5, times yarn_mscale(factor, mscale_all_dim)^2 under yarn."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if cfg.rope_factor > 1 and cfg.rope_mscale_all_dim:
        scale *= yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim) ** 2
    return scale


def yarn_inv_freq(cfg: DeepseekV2Config) -> np.ndarray:
    """The (rope / 2,) inverse frequencies: theta^(-2i/d) blended into
    theta^(-2i/d) / factor by a linear ramp over the dims whose wavelengths
    lie between ``beta_fast`` and ``beta_slow`` turns of the original
    context (float64, then float32)."""
    d, base = cfg.qk_rope_head_dim, cfg.rope_theta
    extra = 1.0 / base ** (np.arange(0, d, 2, dtype=np.float64) / d)
    if cfg.rope_factor <= 1:
        return extra.astype(np.float32)

    def dim_of(turns: float) -> float:
        return d * math.log(cfg.rope_original_max_position / (turns * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(dim_of(cfg.rope_beta_fast)), 0)
    high = min(math.ceil(dim_of(cfg.rope_beta_slow)), d - 1)
    ramp = np.clip((np.arange(d // 2, dtype=np.float64) - low) / max(high - low, 1e-3), 0, 1)
    keep = 1.0 - ramp  # 1: extrapolate (high frequencies), 0: interpolate
    return (extra / cfg.rope_factor * (1 - keep) + extra * keep).astype(np.float32)


def _cos_gain(cfg: DeepseekV2Config) -> float:
    """The cos and sin tables' gain: yarn_mscale(factor, mscale) /
    yarn_mscale(factor, mscale_all_dim)."""
    if cfg.rope_factor <= 1:
        return 1.0
    return yarn_mscale(cfg.rope_factor, cfg.rope_mscale) / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved pairs (x[2i], x[2i+1]) of ``x`` (..., T, d) by
    the (B, 1, T, d / 2) tables in fp32, written de-interleaved (the evens'
    results, then the odds'), in x's dtype."""
    x32 = x.float()
    even, odd = x32[..., 0::2], x32[..., 1::2]
    return torch.cat([even * cos - odd * sin, odd * cos + even * sin], dim=-1).to(x.dtype)


# -- the layers ---------------------------------------------------------------------

class CausalAttention(nn.Module):
    """Causal softmax attention at a fixed scale, a module so that hooks see
    its q, k and v: ``forward(q, k, v)`` on (B, H, T, dk) q, k and (B, H, T,
    dv) v takes float32 scores ``scale`` q.k, a float32 softmax, rounds the
    normalised probabilities to v's dtype, then P.v in v's dtype."""

    def __init__(self, scale: float) -> None:
        super().__init__()
        self.scale = scale

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        t = q.shape[-2]
        scores = torch.matmul(q.float() * self.scale, k.float().transpose(-1, -2))
        scores.masked_fill_(torch.ones(t, t, dtype=torch.bool, device=q.device).triu_(1), float("-inf"))
        return torch.matmul(torch.softmax(scores, dim=-1).to(v.dtype), v)


def _dense(cfg: DeepseekV2Config, in_features: int, features: int, device) -> nn.Linear:
    return nn.Linear(in_features, features, bias=False, dtype=cfg.dtype, device=device)


class SwiGLU(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, width: int, device=None) -> None:
        super().__init__()
        self.gate_proj = _dense(cfg, cfg.hidden_size, width, device)
        self.up_proj = _dense(cfg, cfg.hidden_size, width, device)
        self.down_proj = _dense(cfg, width, cfg.hidden_size, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LatentAttention(nn.Module):
    """MLA without a q LoRA; ``forward(x, cos, sin)`` on the layer's normed
    input gives the output after ``o_proj``."""

    def __init__(self, cfg: DeepseekV2Config, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        h, d = cfg.num_heads, cfg.hidden_size
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        self.q_proj = _dense(cfg, d, h * qk, device)
        self.kv_a_proj_with_mqa = _dense(cfg, d, cfg.kv_lora_rank + cfg.qk_rope_head_dim, device)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_eps, device=device)
        self.kv_b_proj = _dense(cfg, cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim), device)
        self.o_proj = _dense(cfg, h * cfg.v_head_dim, d, device)
        self.core = CausalAttention(softmax_scale(cfg))

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        h, nope, pe = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        q = self.q_proj(x).view(b, t, h, nope + pe).transpose(1, 2)
        q_nope, q_pe = q.split([nope, pe], dim=-1)
        c_kv, k_pe = self.kv_a_proj_with_mqa(x).split([cfg.kv_lora_rank, pe], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c_kv)).view(b, t, h, nope + cfg.v_head_dim).transpose(1, 2)
        k_nope, v = kv.split([nope, cfg.v_head_dim], dim=-1)
        k_pe = rope(k_pe[:, None], cos, sin).expand(b, h, t, pe)
        q = torch.cat([q_nope, rope(q_pe, cos, sin)], dim=-1)
        k = torch.cat([k_nope, k_pe], dim=-1)
        out = self.core(q, k, v)
        return self.o_proj(out.transpose(1, 2).reshape(b, t, h * cfg.v_head_dim))


class MoEGate(nn.Module):
    """The router: ``forward(x)`` on (N, D) gives the fp32 (N, k) weights
    and the (N, k) expert ids."""

    def __init__(self, cfg: DeepseekV2Config, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts, cfg.hidden_size, dtype=cfg.dtype,
                                               device=device))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        return moe.route(x, self.weight, cfg.num_experts_per_tok, cfg.norm_topk_prob, cfg.routed_scaling_factor)


class MoE(nn.Module):
    """Routed experts, stacked for grouped GEMMs (``w13``: (E, 2F, D), the
    gate projections above the up projections; ``w2``: (E, D, F)), and the
    shared experts.  ``forward(x, valid, counts)`` on the (B, T, D) normed
    input adds each valid token's k experts into ``counts`` (E,)."""

    def __init__(self, cfg: DeepseekV2Config, device=None) -> None:
        super().__init__()
        e, d, f = cfg.n_routed_experts, cfg.hidden_size, cfg.moe_intermediate_size
        self.gate = MoEGate(cfg, device=device)
        self.w13 = nn.Parameter(torch.empty(e, 2 * f, d, dtype=cfg.dtype, device=device))
        self.w2 = nn.Parameter(torch.empty(e, d, f, dtype=cfg.dtype, device=device))
        self.shared = SwiGLU(cfg, cfg.n_shared_experts * f, device=device)

    def forward(self, x: torch.Tensor, valid: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        flat = x.reshape(b * t, d)
        with span("moe.route"):
            weights, ids = self.gate(flat)
            counts.scatter_add_(0, ids.reshape(-1), valid[:, None].expand_as(ids).reshape(-1))
        with span("moe.experts"):
            routed = moe.routed_experts(flat, weights, ids, self.w13, self.w2)
        with span("moe.shared"):
            shared = self.shared(x)
        return routed.view(b, t, d) + shared


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, layer: int, device=None) -> None:
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, device=device)
        self.attn = LatentAttention(cfg, device=device)
        self.post_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, device=device)
        self.mlp = MoE(cfg, device=device) if cfg.is_moe(layer) else SwiGLU(cfg, cfg.intermediate_size, device)

    def forward(self, x, cos, sin, valid, counts):
        with span("mla.attention"):
            x = x + self.attn(self.input_norm(x), cos, sin)
        if isinstance(self.mlp, MoE):
            return x + self.mlp(self.post_norm(x), valid, counts)
        with span("dense.mlp"):
            return x + self.mlp(self.post_norm(x))


class DeepseekV2Backbone(nn.Module):
    """Frozen decoder; returns all hidden states (L+1, B, T, D) in fp32.

    ``attention_mask`` must be RIGHT-padded (1s then 0s); rows violating the
    contract return NaN states from entry 1 on (the causal attention could
    not honour them).  Entry 0, the embedding, is not poisoned."""

    def __init__(self, cfg: DeepseekV2Config, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype, device=device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i, device=device) for i in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, device=device)
        self.register_buffer("expert_tokens", torch.zeros(len(cfg.moe_layers), cfg.n_routed_experts,
                                                          dtype=torch.int64, device=device), persistent=False)
        #: the inverse frequencies by device: uploaded once, not every forward
        self._inv_freq: dict[torch.device, torch.Tensor] = {}

    def reset_expert_tokens(self) -> None:
        """Zero ``expert_tokens`` (MoE layers x experts) on the embedding's device."""
        self.expert_tokens = torch.zeros_like(self.expert_tokens, device=self.embed_tokens.weight.device)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator | None = None) -> "DeepseekV2Backbone":
        """Random weights as HF initializes the model: normal(0,
        INITIALIZER_RANGE) for the embedding, every dense, the router and the
        experts, unit RMSNorm gains."""
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * INITIALIZER_RANGE)
        return self

    def rope_tables(self, attention_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The (B, 1, T, rope / 2) cos and sin of the cumsum-derived positions."""
        device = attention_mask.device
        inv = self._inv_freq.get(device)
        if inv is None:
            inv = self._inv_freq[device] = torch.from_numpy(yarn_inv_freq(self.cfg)).to(device)
        positions = torch.clamp(torch.cumsum(attention_mask, dim=-1) - 1, min=0)
        ang = positions[:, None, :, None].float() * inv
        gain = _cos_gain(self.cfg)
        return torch.cos(ang) * gain, torch.sin(ang) * gain

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg
        b, t = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, t), dtype=torch.int32, device=input_ids.device)
        with span("dsv2.embed"):
            x = self.embed_tokens(input_ids)
            cos, sin = self.rope_tables(attention_mask)
            lengths = attention_mask.sum(dim=-1)
            right_padded = (attention_mask.bool() == (torch.arange(t, device=x.device)[None] < lengths[:, None])
                            ).all(dim=-1)
            valid = attention_mask.reshape(-1).to(torch.int64)
            out = torch.empty((cfg.num_layers + 1, b, t, cfg.hidden_size), device=x.device)
            out[0] = x
            x = torch.where(right_padded[:, None, None], x, torch.nan)
        moe_index = {layer: j for j, layer in enumerate(cfg.moe_layers)}
        for i, layer in enumerate(self.layers):
            counts = self.expert_tokens[moe_index[i]] if i in moe_index else None
            x = layer(x, cos, sin, valid, counts)
            if i + 1 < cfg.num_layers:
                out[i + 1] = x
        with span("dsv2.final"):
            out[-1] = self.final_norm(x)
        return out


def params_from_hf(state_dict: tp.Mapping[str, tp.Any], cfg: DeepseekV2Config) -> dict[str, torch.Tensor]:
    """An HF ``deepseek_v2`` model's state dict (the base model's names) ->
    this backbone's state dict, each routed expert's gate, up and down
    projections stacked for the grouped GEMMs.

    Takes any mapping of arrays or tensors (no ``transformers``), read one
    name at a time; a tensor stays on its device and goes to ``cfg.dtype``
    (the RMSNorm gains to float32), so that a mapping that makes each tensor
    when it is read never holds two copies of the model."""

    def arr(name: str, dtype: torch.dtype | None = None) -> torch.Tensor:
        w = state_dict[name]
        w = w.detach() if isinstance(w, torch.Tensor) else torch.from_numpy(np.asarray(w, np.float32))
        return w.to(dtype or cfg.dtype)

    out = {"embed_tokens.weight": arr("embed_tokens.weight"),
           "final_norm.weight": arr("norm.weight", torch.float32)}
    for i in range(cfg.num_layers):
        src, dst = f"layers.{i}.", f"layers.{i}."
        out[dst + "input_norm.weight"] = arr(src + "input_layernorm.weight", torch.float32)
        out[dst + "post_norm.weight"] = arr(src + "post_attention_layernorm.weight", torch.float32)
        for n in ("q_proj", "kv_a_proj_with_mqa", "kv_b_proj", "o_proj"):
            out[f"{dst}attn.{n}.weight"] = arr(f"{src}self_attn.{n}.weight")
        out[dst + "attn.kv_a_layernorm.weight"] = arr(src + "self_attn.kv_a_layernorm.weight", torch.float32)
        if not cfg.is_moe(i):
            for n in ("gate_proj", "up_proj", "down_proj"):
                out[f"{dst}mlp.{n}.weight"] = arr(f"{src}mlp.{n}.weight")
            continue
        out[dst + "mlp.gate.weight"] = arr(src + "mlp.gate.weight")
        experts = [f"{src}mlp.experts.{e}." for e in range(cfg.n_routed_experts)]
        out[dst + "mlp.w13"] = torch.stack([torch.cat([arr(p + "gate_proj.weight"), arr(p + "up_proj.weight")])
                                            for p in experts])
        out[dst + "mlp.w2"] = torch.stack([arr(p + "down_proj.weight") for p in experts])
        for n in ("gate_proj", "up_proj", "down_proj"):
            out[f"{dst}mlp.shared.{n}.weight"] = arr(f"{src}mlp.shared_experts.{n}.weight")
    return out


def from_hf(state_dict: tp.Mapping[str, tp.Any], hf_config: tp.Mapping[str, tp.Any],
            dtype: torch.dtype = torch.bfloat16) -> DeepseekV2Backbone:
    """A backbone holding the converted tensors themselves (built on the
    meta device, then assigned): its parameters lie where the state dict's
    tensors lie."""
    cfg = config_from_hf(hf_config, dtype)
    model = DeepseekV2Backbone(cfg, device="meta")
    model.load_state_dict(params_from_hf(state_dict, cfg), assign=True)
    model.reset_expert_tokens()
    return model
