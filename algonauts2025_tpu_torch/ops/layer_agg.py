"""Fractional-depth layer selection and group-mean aggregation.

The port's copy of algonauts2025_tpu/ops/layer_agg.py (host NumPy).
Backbones emit a (layers, D, T) stack; configs select fractional depths
(e.g. [0.5, 0.75, 1.0]) and either keep them or mean consecutive groups.
"""

from __future__ import annotations

import typing as tp

import numpy as np

__all__ = ["layer_indices", "aggregate_layers"]


def layer_indices(n_layers: int, layers: tp.Sequence[float]) -> list[int]:
    return np.unique([int(i * (n_layers - 1)) for i in layers]).tolist()


def aggregate_layers(
    latents: np.ndarray,
    layers: tp.Sequence[float],
    layer_aggregation: tp.Optional[str] = "group_mean",
) -> np.ndarray:
    """Select/aggregate the leading (layers) axis of a latent stack.

    - single selected index: squeeze (or keep 1-sized axis when
      aggregation is None)
    - group_mean: mean each [l_k, l_{k+1}) slab (last index inclusive)
    - None: plain index selection
    """
    inds = layer_indices(latents.shape[0], layers)
    if len(inds) == 1:
        if layer_aggregation is None:
            return latents[inds[0]][None, :]
        return latents[inds[0]]
    if layer_aggregation == "group_mean":
        inds[-1] += 1
        return np.stack([latents[a:b].mean(0) for a, b in zip(inds[:-1], inds[1:])])
    if layer_aggregation is None:
        return latents[inds]
    raise ValueError(f"Unknown layer aggregation: {layer_aggregation}")
