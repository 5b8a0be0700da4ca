"""Pearson correlation: batched, and as a streaming state of sums.

The selection metric of the pipeline is the mean per-voxel Pearson r.
All state fields are sums, so merging batches is addition.
"""

from __future__ import annotations

import typing as tp

import torch

__all__ = [
    "pearson_corr",
    "PearsonState",
    "init_pearson_state",
    "update_pearson_state",
    "compute_pearson",
]


def pearson_corr(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-column Pearson r of two (N, D) tensors -> (D,).

    eps sits inside the sqrt so the gradient stays finite at constant columns."""
    xm = x - x.mean(dim=0, keepdim=True)
    ym = y - y.mean(dim=0, keepdim=True)
    cov = (xm * ym).sum(dim=0)
    xs = torch.sqrt((xm**2).sum(dim=0) + eps)
    ys = torch.sqrt((ym**2).sum(dim=0) + eps)
    return cov / (xs * ys + eps)


class PearsonState(tp.NamedTuple):
    """Sufficient statistics for streaming per-column Pearson r."""

    n: torch.Tensor  # scalar (or (G,) for grouped states)
    sx: torch.Tensor  # (D,) sum x
    sy: torch.Tensor  # (D,) sum y
    sxx: torch.Tensor  # (D,) sum x^2
    syy: torch.Tensor  # (D,) sum y^2
    sxy: torch.Tensor  # (D,) sum x*y


def init_pearson_state(
    dim: int, device: str | torch.device, dtype: torch.dtype = torch.float32
) -> PearsonState:
    z = torch.zeros((dim,), dtype=dtype, device=device)
    return PearsonState(torch.zeros((), dtype=dtype, device=device), z, z, z, z, z)


def update_pearson_state(
    state: PearsonState, preds: torch.Tensor, target: torch.Tensor
) -> PearsonState:
    """Accumulate a (N, D) batch of predictions/targets."""
    preds = preds.to(state.sx.dtype)
    target = target.to(state.sx.dtype)
    return PearsonState(
        n=state.n + preds.shape[0],
        sx=state.sx + preds.sum(0),
        sy=state.sy + target.sum(0),
        sxx=state.sxx + (preds**2).sum(0),
        syy=state.syy + (target**2).sum(0),
        sxy=state.sxy + (preds * target).sum(0),
    )


def compute_pearson(state: PearsonState, eps: float = 1e-8) -> torch.Tensor:
    """Per-column r from accumulated state -> (D,)."""
    n = state.n
    cov = state.sxy - state.sx * state.sy / n
    # fp32 cancellation can leave tiny-negative variances for near-constant
    # columns; clamp before the sqrt or the metric turns NaN
    vx = torch.clamp(state.sxx - state.sx**2 / n, min=0.0)
    vy = torch.clamp(state.syy - state.sy**2 / n, min=0.0)
    return cov / (torch.sqrt(vx * vy) + eps)
