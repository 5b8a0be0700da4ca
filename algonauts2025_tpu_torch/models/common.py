"""Shared model building blocks (torch.nn).

The port of algonauts2025_tpu/models/common.py: the per-subject readout
(SubjectLayers), the MLP factory config, LayerScale and Mean.
"""

from __future__ import annotations

import typing as tp

import pydantic
import torch
from torch import nn

from .transformer import lecun_normal_

__all__ = ["LayerScale", "Mean", "Mlp", "MlpConfig", "SubjectLayers", "flax_init_"]


class SubjectLayers(nn.Module):
    """Per-subject linear map: x (B, C, T), subjects (B,) -> (B, D, T).

    Weight (S, C, D) and bias (S, D) init ~ N(0, 1/C); with no subjects
    (or ``average_subjects``) every element uses the mean weight."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        n_subjects: int,
        use_bias: bool = True,
        init_id: bool = False,
        average_subjects: bool = False,
        device=None,
    ) -> None:
        super().__init__()
        if init_id and in_channels != out_channels:
            raise ValueError("init_id requires in_channels == out_channels")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.init_id, self.average_subjects = init_id, average_subjects
        self.weights = nn.Parameter(
            torch.empty(n_subjects, in_channels, out_channels, device=device)
        )
        self.bias = (
            nn.Parameter(torch.empty(n_subjects, out_channels, device=device))
            if use_bias
            else None
        )
        #: tensor parallelism (parallel.sharding): this rank's parcels of
        #: ``weights`` and ``bias``; the output is gathered over the ranks
        self.tp = None

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        scale = 1.0 / self.in_channels**0.5
        with torch.no_grad():
            if self.init_id:
                eye = torch.eye(self.in_channels, device=self.weights.device)
                self.weights.copy_(eye.expand_as(self.weights) * scale)
                if self.bias is not None:
                    self.bias.zero_()
                return
            self.weights.normal_(generator=generator).mul_(scale)
            if self.bias is not None:
                self.bias.normal_(generator=generator).mul_(scale)

    def forward(self, x: torch.Tensor, subjects: torch.Tensor | None) -> torch.Tensor:
        if self.tp is not None:
            x = self.tp.enter(x)
        x32 = x.float()
        if self.average_subjects or subjects is None:
            out = torch.einsum("bct,cd->bdt", x32, self.weights.mean(dim=0))
            b = None if self.bias is None else self.bias.mean(dim=0)[None, :, None]
        else:
            subjects = subjects.reshape(-1)
            w = self.weights[subjects]  # (B, C, D)
            out = torch.einsum("bct,bcd->bdt", x32, w)
            b = None if self.bias is None else self.bias[subjects][:, :, None]
        if b is not None:
            out = out + b
        if self.tp is not None:
            out = self.tp.gather(out, 1)
        return out.to(x.dtype)


class Mean(nn.Module):
    """Axis-mean as a module (the time aggregation of sequential stacks)."""

    def __init__(self, axis: int, keepdims: bool = False) -> None:
        super().__init__()
        self.axis, self.keepdims = axis, keepdims

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=self.axis, keepdim=self.keepdims)


class LayerScale(nn.Module):
    """Learned per-channel residual scale with boosted init: y = boost *
    scale[:, None] * x, scale starting at init / boost."""

    def __init__(self, channels: int, init: float = 0.1, boost: float = 5.0,
                 device=None) -> None:
        super().__init__()
        self.init, self.boost = init, boost
        self.scale = nn.Parameter(torch.empty(channels, device=device))
        self.init_weights()

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.scale.fill_(self.init / self.boost)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (self.boost * self.scale)[:, None] * x


class PReLU(nn.Module):
    """flax's PReLU: one learned slope (init 0.01) for the negative side."""

    def __init__(self, device=None) -> None:
        super().__init__()
        self.negative_slope = nn.Parameter(torch.full((), 0.01, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.negative_slope * x)


def flax_init_(module: nn.Module, generator: torch.Generator | None = None) -> None:
    """flax's initialisers over every submodule: lecun-normal Linear
    kernels, zero biases, unit LayerNorm gains, PReLU slopes at 0.01."""
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, nn.Linear):
                lecun_normal_(sub.weight, generator)
                if sub.bias is not None:
                    sub.bias.zero_()
            elif isinstance(sub, nn.LayerNorm):
                sub.reset_parameters()
            elif isinstance(sub, PReLU):
                sub.negative_slope.fill_(0.01)


_ACTIVATIONS: dict[str | None, tp.Callable[[torch.Tensor], torch.Tensor] | None] = {
    # flax's gelu is the tanh approximation
    "gelu": lambda v: nn.functional.gelu(v, approximate="tanh"),
    "relu": nn.functional.relu,
    "elu": nn.functional.elu,
    "prelu": None,  # a module with a learned slope, built per layer
    None: lambda v: v,
}


class Mlp(nn.Module):
    """Linear stack with optional norm/activation/dropout per layer.

    No hidden sizes: a bare Linear (no dropout).  Otherwise torchvision's
    MLP layout: norm -> activation -> dropout after each hidden layer, and
    a trailing dropout after the final linear.  ``norm_layer`` is "layer"
    (flax's LayerNorm: eps 1e-6, with bias) or None; batch / instance /
    unit norms need running statistics and raise."""

    def __init__(
        self,
        input_size: int,
        hidden_sizes: tp.Sequence[int],
        output_size: int | None = None,
        norm_layer: str | None = None,
        activation_layer: str | None = "relu",
        use_bias: bool = True,
        dropout: float = 0.0,
        device=None,
    ) -> None:
        super().__init__()
        if activation_layer not in _ACTIVATIONS:
            raise ValueError(f"unknown activation_layer {activation_layer!r}")
        if norm_layer not in ("layer", None):
            raise NotImplementedError(
                f"norm_layer={norm_layer!r} is not supported (use 'layer' or None)"
            )
        sizes = list(hidden_sizes) + ([output_size] if output_size is not None else [])
        if not sizes:
            raise ValueError("Mlp needs hidden_sizes and/or output_size")
        self.activation_layer, self.dropout = activation_layer, dropout
        self.trailing_dropout = bool(hidden_sizes) and dropout > 0
        self.layers = nn.ModuleList(
            nn.Linear(n_in, n_out, bias=use_bias, device=device)
            for n_in, n_out in zip([input_size] + sizes[:-1], sizes)
        )
        hidden = sizes[:-1]
        self.norms = nn.ModuleList(
            nn.LayerNorm(n, eps=1e-6, device=device) for n in hidden
        ) if norm_layer == "layer" else None
        self.prelus = nn.ModuleList(
            PReLU(device=device) for _ in hidden
        ) if activation_layer == "prelu" else None

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        flax_init_(self, generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < last:
                if self.norms is not None:
                    x = self.norms[i](x)
                if self.prelus is not None:
                    x = self.prelus[i](x)
                else:
                    x = _ACTIVATIONS[self.activation_layer](x)
            if (i < last or self.trailing_dropout) and self.dropout > 0:
                x = nn.functional.dropout(x, self.dropout, training=not deterministic)
        return x


class MlpConfig(pydantic.BaseModel):
    """Config surface mirroring the reference MlpConfig."""

    model_config = pydantic.ConfigDict(extra="forbid")
    name: tp.Literal["Mlp"] = "Mlp"
    input_size: int | None = None
    hidden_sizes: list[int] | None = None
    norm_layer: tp.Literal["layer", "batch", "instance", "unit", None] = None
    activation_layer: tp.Literal["relu", "gelu", "elu", "prelu", None] = "relu"
    bias: bool = True
    dropout: float = 0.0

    def build(self, input_size: int | None = None, output_size: int | None = None,
              device=None) -> Mlp:
        """flax infers the input width at init; torch needs it here (the
        argument, else the config's ``input_size``)."""
        size = input_size if input_size is not None else self.input_size
        if size is None:
            raise ValueError("MlpConfig.build needs input_size (argument or config)")
        return Mlp(
            input_size=size,
            hidden_sizes=self.hidden_sizes or [],
            output_size=output_size,
            norm_layer=self.norm_layer,
            activation_layer=self.activation_layer,
            use_bias=self.bias,
            dropout=self.dropout,
            device=device,
        )
