"""Loss functions + config registry (the slice's subset).

Losses are plain functions over (N, D) tensors; the config surface keeps
the reference's names so grid configs port unchanged.  Only MSELoss and
PearsonLoss are ported; the other names raise (ROADMAP, queue 1).
"""

from __future__ import annotations

import typing as tp

import pydantic
import torch

__all__ = ["LossConfig", "mse_loss", "pearson_loss", "build_loss"]

LossFn = tp.Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def pearson_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    dim: int = 1,
    eps: float = 1e-8,
    reduction: str = "mean",
) -> torch.Tensor:
    """1 - r per column of (N, D), reduced like torch losses."""
    x = torch.movedim(pred, dim, 0)
    y = torch.movedim(target, dim, 0)
    x = x.reshape(x.shape[0], -1)
    y = y.reshape(y.shape[0], -1)
    x = x - x.mean(dim=1, keepdim=True)
    y = y - y.mean(dim=1, keepdim=True)
    cov = torch.sum(x * y, dim=1)
    # eps inside the sqrt: finite gradient for constant (zero-variance) rows
    xs = torch.sqrt(torch.sum(x**2, dim=1) + eps)
    ys = torch.sqrt(torch.sum(y**2, dim=1) + eps)
    per_column = 1 - cov / (xs * ys + eps)
    if reduction == "sum":
        return torch.sum(per_column)
    if reduction == "none":
        return per_column
    return torch.mean(per_column)


#: the JAX package's torch-style loss names (its config surface); only
#: MSELoss builds here
_TORCH_STYLE_NAMES = (
    "MSELoss", "L1Loss", "HuberLoss", "SmoothL1Loss", "BCELoss", "BCEWithLogitsLoss",
    "KLDivLoss", "PoissonNLLLoss", "CrossEntropyLoss", "SoftMarginLoss", "NLLLoss",
    "MarginRankingLoss", "HingeEmbeddingLoss", "MultiLabelSoftMarginLoss", "GaussianNLLLoss",
    "CosineEmbeddingLoss", "TripletMarginLoss", "MultiMarginLoss", "MultiLabelMarginLoss",
    "CTCLoss",
)


class PearsonLossConfig(pydantic.BaseModel):
    model_config = pydantic.ConfigDict(extra="forbid")
    name: tp.Literal["PearsonLoss"] = "PearsonLoss"
    reduction: str = "mean"
    dim: int = 1


class TorchLossConfig(pydantic.BaseModel):
    """Reference-style name + kwargs for standard regression losses."""

    model_config = pydantic.ConfigDict(extra="forbid")
    name: tp.Literal[_TORCH_STYLE_NAMES]  # type: ignore[valid-type]
    kwargs: dict[str, tp.Any] = {}


#: the ``Experiment.loss`` field: the JAX package's discriminated union
LossConfig = tp.Annotated[
    tp.Union[PearsonLossConfig, TorchLossConfig], pydantic.Field(discriminator="name")
]


def build_loss(config: tp.Any) -> LossFn:
    """``{"name": "MSELoss"}`` or ``{"name": "PearsonLoss", "dim": ..., "reduction": ...}``,
    as a dict or a ``LossConfig``."""
    if isinstance(config, pydantic.BaseModel):
        config = config.model_dump()
    cfg = dict(config)
    name = cfg.pop("name", None)
    if name == "MSELoss":
        kwargs = dict(cfg.pop("kwargs", {}))
        # torch's default reduction is the only one this loss implements
        if kwargs.pop("reduction", "mean") != "mean" or kwargs or cfg:
            raise ValueError(f"MSELoss: unsupported settings {kwargs or cfg}")
        return mse_loss
    if name == "PearsonLoss":
        dim = cfg.pop("dim", 1)
        reduction = cfg.pop("reduction", "mean")
        if cfg:
            raise ValueError(f"PearsonLoss: unsupported settings {sorted(cfg)}")
        if reduction not in ("mean", "sum", "none"):
            raise ValueError(f"unknown reduction {reduction!r}")
        return lambda pred, target: pearson_loss(pred, target, dim=dim, reduction=reduction)
    raise NotImplementedError(
        f"loss {name!r} is not ported yet (ROADMAP, queue 1: other losses); "
        "ported: MSELoss, PearsonLoss"
    )
