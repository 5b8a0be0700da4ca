"""Residual-MLP fMRI decoder (the alternate model family).

The port of algonauts2025_tpu/models/fmri_mlp.py: subject layers, optional
TR embeddings, a per-TR input layer (a (T, C, H) einsum, the reference's
grouped conv), residual hidden blocks and in/out time aggregation.  Only
``norm_type="ln"`` builds (flax's LayerNorm: eps 1e-6); the gelu is the
erf form through ``ops.fast_gelu``, as in the JAX package.

flax infers input widths at init; the port takes them at build.  With
``time_agg="in_linear"`` the input's time axis must be
``n_repetition_times`` long (the width of that Dense).
``models.convert.fmri_mlp_params_to_torch`` moves the JAX module's params.
"""

from __future__ import annotations

import typing as tp

import pydantic
import torch
from torch import nn

from ..ops.fast_gelu import gelu_fast
from .common import MlpConfig, SubjectLayers, flax_init_
from .transformer import lecun_normal_

__all__ = ["FmriMlp", "FmriMlpConfig"]

_TimeAgg = tp.Literal["in_mean", "in_linear", "out_mean", "out_linear"]


class FmriMlpConfig(pydantic.BaseModel):
    model_config = pydantic.ConfigDict(extra="forbid")
    name: tp.Literal["FmriMlp"] = "FmriMlp"

    # trunk
    hidden: int = 4096
    n_blocks: int = 4
    act_first: bool = False
    norm_type: str = "ln"

    # temporal handling
    time_agg: _TimeAgg = "out_linear"
    n_repetition_times: int = 1
    use_tr_layer: bool = False
    use_tr_embeds: bool = False
    tr_embed_dim: int = 16

    # subject conditioning
    subject_layers: bool = False
    subject_layers_dim: tp.Literal["input", "hidden"] = "hidden"
    subject_layers_id: bool = False
    n_subjects: int = 20

    # outputs
    out_dim: int | None = None
    output_head_config: tp.Union[MlpConfig, dict[str, MlpConfig], None] = None

    def build(self, n_in_channels: int, n_outputs: int | None, device=None) -> "FmriMlp":
        width = n_outputs if n_outputs is not None else self.out_dim
        if width is None:
            raise ValueError("set either n_outputs or config.out_dim")
        return FmriMlp(in_dim=n_in_channels, out_dim=width, config=self, device=device)


class _ActNorm(nn.Module):
    """LayerNorm then the erf gelu (the reverse with ``act_first``)."""

    def __init__(self, dim: int, norm_type: str, act_first: bool, device=None) -> None:
        super().__init__()
        # BatchNorm's running statistics are not replicated: the reference's
        # "bn" would train a different model here, so it raises
        if norm_type != "ln":
            raise NotImplementedError(
                f"norm_type={norm_type!r}: only 'ln' is supported (the "
                "reference's 'bn' variant is deliberately not replicated)"
            )
        self.act_first = act_first
        self.norm = nn.LayerNorm(dim, eps=1e-6, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act_first:
            return self.norm(gelu_fast(x))
        return gelu_fast(self.norm(x))


class _Block(nn.Module):
    def __init__(self, hidden: int, cfg: FmriMlpConfig, device=None) -> None:
        super().__init__()
        self.dense = nn.Linear(hidden, hidden, device=device)
        self.act_norm = _ActNorm(hidden, cfg.norm_type, cfg.act_first, device=device)


class FmriMlp(nn.Module):
    """x (B, ..., T) -> (B, out_dim), or a dict of heads' outputs."""

    def __init__(self, in_dim: int, out_dim: int, config: FmriMlpConfig, device=None) -> None:
        super().__init__()
        cfg = self.config = config
        self.in_dim, self.out_dim = in_dim, out_dim
        n_rep = cfg.n_repetition_times
        self.time_in = (nn.Linear(n_rep, 1, device=device)
                        if cfg.time_agg == "in_linear" else None)
        if cfg.time_agg in ("in_mean", "in_linear"):
            n_rep = 1
        self.n_rep = n_rep
        width = in_dim
        self.subject_layers = None
        if cfg.subject_layers:
            width = {"hidden": cfg.hidden, "input": in_dim}[cfg.subject_layers_dim]
            self.subject_layers = SubjectLayers(
                in_dim, width, cfg.n_subjects, use_bias=False,
                init_id=cfg.subject_layers_id, device=device,
            )
        self.tr_embed = None
        if cfg.use_tr_embeds:
            self.tr_embed = nn.Embedding(n_rep, cfg.tr_embed_dim, device=device)
            width += cfg.tr_embed_dim
        self.tr_weights = self.tr_bias = self.input = None
        if cfg.use_tr_layer:
            # per-TR weights: one (C, H) matmul per TR
            self.tr_weights = nn.Parameter(torch.empty(n_rep, width, cfg.hidden, device=device))
            self.tr_bias = nn.Parameter(torch.empty(n_rep, cfg.hidden, device=device))
        else:
            self.input = nn.Linear(width, cfg.hidden, device=device)
        self.norm_in = _ActNorm(cfg.hidden, cfg.norm_type, cfg.act_first, device=device)
        self.blocks = nn.ModuleList(_Block(cfg.hidden, cfg, device) for _ in range(cfg.n_blocks))
        self.time_out = (nn.Linear(n_rep, 1, device=device)
                         if cfg.time_agg == "out_linear" else None)
        self.output = nn.Linear(cfg.hidden, out_dim, device=device)
        head = cfg.output_head_config
        self.head = head.build(out_dim, device=device) if isinstance(head, MlpConfig) else None
        self.heads = nn.ModuleDict(
            {name: h.build(out_dim, device=device) for name, h in head.items()}
        ) if isinstance(head, dict) else None

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """flax's initialisers: lecun-normal kernels (the per-TR weights over
        a fan-in of T x C), zero biases, unit LayerNorm gains; the TR
        embedding N(0, 1 / tr_embed_dim)."""
        flax_init_(self, generator)
        with torch.no_grad():
            if self.subject_layers is not None:
                self.subject_layers.init_weights(generator)
            if self.tr_embed is not None:
                self.tr_embed.weight.normal_(generator=generator).mul_(
                    self.config.tr_embed_dim**-0.5)
            if self.tr_weights is not None:
                t, c, _ = self.tr_weights.shape
                lecun_normal_(self.tr_weights, generator, fan_in=t * c)
                self.tr_bias.zero_()

    def forward(self, x: torch.Tensor, subject_ids: torch.Tensor | None = None,
                training: bool = False) -> torch.Tensor | dict[str, torch.Tensor]:
        cfg = self.config
        x = x.reshape(x.shape[0], -1, x.shape[-1])  # (B, C, T)
        if cfg.time_agg == "in_mean":
            x = x.mean(dim=2, keepdim=True)
        elif cfg.time_agg == "in_linear":
            x = self.time_in(x)  # over the trailing time axis -> (B, C, 1)
        b, _, t = x.shape
        if t != self.n_rep:
            raise ValueError(f"TR mismatch: {t} != {self.n_rep}")
        if self.subject_layers is not None:
            x = self.subject_layers(x, subject_ids)
        x = x.transpose(1, 2)  # (B, T, C)
        if self.tr_embed is not None:
            embeds = self.tr_embed(torch.arange(t, device=x.device))
            x = torch.cat([x, embeds[None].expand(b, t, -1)], dim=2)
        if self.tr_weights is not None:
            x = torch.einsum("btc,tch->bth", x, self.tr_weights) + self.tr_bias[None]
        else:
            x = self.input(x)
        x = nn.functional.dropout(self.norm_in(x), 0.5, training=training)
        residual = x
        for block in self.blocks:
            h = block.act_norm(block.dense(x))
            x = nn.functional.dropout(h, 0.15, training=training) + residual
            residual = x
        x = x.transpose(1, 2)  # (B, H, T)
        if cfg.time_agg == "out_mean":
            x = x.mean(dim=2)
        elif cfg.time_agg == "out_linear":
            x = self.time_out(x)[..., 0]
        x = self.output(x.reshape(b, -1))
        # the heads run without dropout, as the JAX module calls them
        if self.head is not None:
            return self.head(x)
        if self.heads is not None:
            return {name: head(x) for name, head in self.heads.items()}
        return x
