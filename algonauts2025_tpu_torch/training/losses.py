"""Loss functions + config registry (the slice's subset).

Losses are plain functions over (N, D) tensors; the config surface keeps
the reference's names so grid configs port unchanged.  Only MSELoss and
PearsonLoss are ported; the other names raise (ROADMAP, queue 1).
"""

from __future__ import annotations

import typing as tp

import torch

__all__ = ["mse_loss", "pearson_loss", "build_loss"]

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


def build_loss(config: tp.Mapping[str, tp.Any]) -> LossFn:
    """``{"name": "MSELoss"}`` or ``{"name": "PearsonLoss", "dim": ..., "reduction": ...}``."""
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
