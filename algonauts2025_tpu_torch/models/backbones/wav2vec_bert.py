"""Wav2Vec2-BERT conformer backbone (torch.nn) for frozen audio features.

The port of algonauts2025_tpu/models/backbones/wav2vec_bert.py, the
inference path of HF ``facebook/w2v-bert-2.0`` with
``position_embeddings_type="relative_key"``: feature projection (LayerNorm
+ Linear over 160-dim stacked log-mel frames), then conformer blocks
(half-step FFNs, self-attention with a clamped relative-distance key bias,
a causal depthwise-conv module).  Returns the (L+1, B, T, D) fp32
hidden-state stack.

The dtype casts are the JAX package's: ``cfg.dtype`` (bf16) weights and
activations, LayerNorm statistics and affine in fp32 with the output cast
back, attention scores and the relative bias in fp32, the softmax cast to
``cfg.dtype`` before P.V.  The JAX package places the relative bias with
a banded one-hot matmul (``_rel_onehot``, a TPU layout workaround that
pins a (T, 73, T) tensor); here it is a gather of the same values.  The
scanned ``(L, ...)`` params of the JAX package are one module per layer
(``models.convert.wav2vec_bert_params_to_torch`` unstacks them).  The
audio path has no Pallas kernel, so nothing here launches one of the
port's kernels.  Under a profiler a forward's stages are spans
(``utils.profiling.span``): ``conformer.embed``, then per layer
``conformer.ffn1``, ``conformer.attention``, ``conformer.conv`` and
``conformer.ffn2`` (the last with the final LayerNorm).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.profiling import span

__all__ = ["Wav2VecBertConfig", "Wav2VecBertBackbone", "params_from_hf", "W2V_BERT_2_0"]


@dataclasses.dataclass(frozen=True)
class Wav2VecBertConfig:
    input_dim: int = 160
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    conv_kernel_size: int = 31
    left_max_pos: int = 64
    right_max_pos: int = 8
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16


#: the published facebook/w2v-bert-2.0 shapes
W2V_BERT_2_0 = Wav2VecBertConfig()
#: the std of HF Wav2Vec2BertConfig's ``initializer_range``
INITIALIZER_RANGE = 0.02


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """flax LayerNorm: statistics and affine in fp32, the output in ``dtype``."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps).to(dtype)


def _norm(cfg: Wav2VecBertConfig, dim: int, device) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=cfg.layer_norm_eps, device=device)


class FeedForward(nn.Module):
    def __init__(self, cfg: Wav2VecBertConfig, device=None) -> None:
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size, dtype=cfg.dtype,
                                            device=device)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size, dtype=cfg.dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.silu(self.intermediate_dense(x)))


class ConvModule(nn.Module):
    """LayerNorm, pad mask, pointwise conv to 2H + GLU, causal depthwise
    conv, LayerNorm, swish, pointwise conv (the pointwise convs as Linear)."""

    def __init__(self, cfg: Wav2VecBertConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.layer_norm = _norm(cfg, h, device)
        self.pointwise_conv1 = nn.Linear(h, 2 * h, bias=False, dtype=cfg.dtype, device=device)
        self.depthwise_conv = nn.Conv1d(h, h, cfg.conv_kernel_size, groups=h, bias=False, dtype=cfg.dtype,
                                        device=device)
        self.depthwise_layer_norm = _norm(cfg, h, device)
        self.pointwise_conv2 = nn.Linear(h, h, bias=False, dtype=cfg.dtype, device=device)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor | None = None) -> torch.Tensor:
        dtype = self.cfg.dtype
        h = _layer_norm(x, self.layer_norm, dtype)
        if pad_mask is not None:
            h = torch.where(pad_mask[..., None], h, 0.0)
        a, b = self.pointwise_conv1(h).chunk(2, dim=-1)
        h = a * torch.sigmoid(b)
        # causal depthwise conv over time: pad (k-1) on the left
        h = F.pad(h.transpose(1, 2), (self.cfg.conv_kernel_size - 1, 0))
        h = self.depthwise_conv(h).transpose(1, 2)
        h = F.silu(_layer_norm(h, self.depthwise_layer_norm, dtype))
        return self.pointwise_conv2(h)


def relative_positions(t: int, left: int, right: int, device=None) -> torch.Tensor:
    """(T, T) int64 index of the distance table: clamp(r - l, -left, right) + left."""
    pos = torch.arange(t, device=device)
    return torch.clamp(pos[None, :] - pos[:, None], -left, right) + left


class RelKeyAttention(nn.Module):
    """Self-attention with a clamped relative-distance key bias
    (HF modeling_wav2vec2_bert.py:308-320)."""

    def __init__(self, cfg: Wav2VecBertConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            setattr(self, name, nn.Linear(h, h, dtype=cfg.dtype, device=device))
        n_pos = cfg.left_max_pos + cfg.right_max_pos + 1
        self.distance_embedding = nn.Parameter(torch.zeros((n_pos, h // cfg.num_heads), device=device))

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor | None, rel_index: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        h, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads

        def heads(linear):
            return linear(x).reshape(b, t, h, hd).transpose(1, 2)

        q, k, v = heads(self.linear_q), heads(self.linear_k), heads(self.linear_v)
        qf = q.float()
        scores = torch.matmul(qf, k.float().transpose(-1, -2)) / hd**0.5
        # project q onto the small distance table, then place the clamped
        # diagonals: rel[b, h, l, r] = qd[b, h, l, rel_index[l, r]]
        qd = torch.matmul(qf, self.distance_embedding.float().T)  # (B, H, T, n_pos)
        rel = torch.take_along_dim(qd, rel_index[None, None], dim=-1)
        scores = scores + rel / hd**0.5
        if attn_bias is not None:
            scores = scores + attn_bias
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, cfg.hidden_size)
        return self.linear_out(out)


class ConformerLayer(nn.Module):
    def __init__(self, cfg: Wav2VecBertConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.ffn1_layer_norm = _norm(cfg, h, device)
        self.ffn1 = FeedForward(cfg, device=device)
        self.self_attn_layer_norm = _norm(cfg, h, device)
        self.self_attn = RelKeyAttention(cfg, device=device)
        self.conv_module = ConvModule(cfg, device=device)
        self.ffn2_layer_norm = _norm(cfg, h, device)
        self.ffn2 = FeedForward(cfg, device=device)
        self.final_layer_norm = _norm(cfg, h, device)

    def forward(self, x, attn_bias, pad_mask, rel_index):
        dtype = self.cfg.dtype
        with span("conformer.ffn1"):
            x = x + 0.5 * self.ffn1(_layer_norm(x, self.ffn1_layer_norm, dtype))
        with span("conformer.attention"):
            x = x + self.self_attn(_layer_norm(x, self.self_attn_layer_norm, dtype), attn_bias, rel_index)
        with span("conformer.conv"):
            x = x + self.conv_module(x, pad_mask)
        with span("conformer.ffn2"):
            x = x + 0.5 * self.ffn2(_layer_norm(x, self.ffn2_layer_norm, dtype))
            return _layer_norm(x, self.final_layer_norm, dtype)


class Wav2VecBertBackbone(nn.Module):
    """Frozen conformer; returns all hidden states (L+1, B, T, D) in fp32:
    the projected input, then every layer's output."""

    def __init__(self, cfg: Wav2VecBertConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.fp_layer_norm = _norm(cfg, cfg.input_dim, device)
        self.fp_projection = nn.Linear(cfg.input_dim, cfg.hidden_size, dtype=cfg.dtype, device=device)
        self.layers = nn.ModuleList(ConformerLayer(cfg, device=device) for _ in range(cfg.num_layers))

    @torch.no_grad()
    def init_random(self, generator: torch.Generator | None = None) -> "Wav2VecBertBackbone":
        """Random weights: normal(0, INITIALIZER_RANGE) for every dense and
        conv weight and the distance tables, zero biases, unit LayerNorm
        gains."""
        for module in self.modules():
            if isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, (nn.Linear, nn.Conv1d)):
                module.weight.copy_(torch.randn(module.weight.shape, generator=generator,
                                                device=module.weight.device) * INITIALIZER_RANGE)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, RelKeyAttention):
                table = module.distance_embedding
                table.copy_(torch.randn(table.shape, generator=generator, device=table.device) * INITIALIZER_RANGE)
        return self

    def forward(self, input_features: torch.Tensor, attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        """``input_features`` (B, T, input_dim); ``attention_mask`` (B, T),
        nonzero on valid frames: padded frames are zeroed after the
        projection and in the conv module, and padded keys get a -1e30
        bias (padded query rows are computed, not zeroed)."""
        cfg = self.cfg
        with span("conformer.embed"):
            x = self.fp_projection(_layer_norm(input_features, self.fp_layer_norm, cfg.dtype))
            b, t, _ = x.shape
            pad_mask = attn_bias = None
            if attention_mask is not None:
                pad_mask = attention_mask.bool()
                x = torch.where(pad_mask[..., None], x, 0.0)
                attn_bias = torch.where(pad_mask[:, None, None, :], 0.0, -1e30)
            rel_index = relative_positions(t, cfg.left_max_pos, cfg.right_max_pos, device=x.device)
        out = torch.empty((cfg.num_layers + 1, b, t, cfg.hidden_size), device=x.device)
        out[0] = x
        for i, layer in enumerate(self.layers):
            x = layer(x, attn_bias, pad_mask, rel_index)
            out[i + 1] = x
        return out


def params_from_hf(state_dict: tp.Mapping[str, tp.Any], cfg: Wav2VecBertConfig) -> dict[str, torch.Tensor]:
    """An HF Wav2Vec2BertModel state dict -> this backbone's state dict.

    Takes any mapping of arrays or tensors (no ``transformers``).  Every
    tensor passes through float32 before its target dtype: ``cfg.dtype``
    for the dense and conv weights and biases, float32 for the LayerNorms
    and the distance tables, as the JAX package's ``params_from_hf``
    converts.  The pointwise convs' (out, in, 1) kernels become Linear
    weights."""

    def arr(name: str, dtype: torch.dtype | None = None) -> torch.Tensor:
        w = state_dict[name]
        w = w.detach().float().cpu() if isinstance(w, torch.Tensor) else torch.from_numpy(np.asarray(w, np.float32))
        return w.to(dtype or cfg.dtype)

    out: dict[str, torch.Tensor] = {}

    def linear(dst: str, src: str, bias: bool = True) -> None:
        out[dst + ".weight"] = arr(src + ".weight")
        if bias:
            out[dst + ".bias"] = arr(src + ".bias")

    def layernorm(dst: str, src: str) -> None:
        out[dst + ".weight"] = arr(src + ".weight", torch.float32)
        out[dst + ".bias"] = arr(src + ".bias", torch.float32)

    layernorm("fp_layer_norm", "feature_projection.layer_norm")
    linear("fp_projection", "feature_projection.projection")
    for i in range(cfg.num_layers):
        src, dst = f"encoder.layers.{i}.", f"layers.{i}."
        for name in ("ffn1_layer_norm", "self_attn_layer_norm", "ffn2_layer_norm", "final_layer_norm",
                     "conv_module.layer_norm", "conv_module.depthwise_layer_norm"):
            layernorm(dst + name, src + name)
        for ff in ("ffn1", "ffn2"):
            linear(f"{dst}{ff}.intermediate_dense", f"{src}{ff}.intermediate_dense")
            linear(f"{dst}{ff}.output_dense", f"{src}{ff}.output_dense")
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            linear(f"{dst}self_attn.{name}", f"{src}self_attn.{name}")
        out[dst + "self_attn.distance_embedding"] = arr(src + "self_attn.distance_embedding.weight", torch.float32)
        for name in ("pointwise_conv1", "pointwise_conv2"):
            out[f"{dst}conv_module.{name}.weight"] = arr(f"{src}conv_module.{name}.weight")[:, :, 0]
        out[dst + "conv_module.depthwise_conv.weight"] = arr(src + "conv_module.depthwise_conv.weight")
    return out
