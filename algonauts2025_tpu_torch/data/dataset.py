"""Batches and their host-to-device copy.

``SegmentData`` is the batch type the trainer consumes: feature name ->
(B, ...) array, plus the source segments.  ``to_device`` replaces the JAX
package's ``prefetch_to_device``: pinned host memory and ``non_blocking``
copies, so the copy overlaps the work already queued on the card.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

__all__ = ["SegmentData", "to_device"]


@dataclasses.dataclass
class SegmentData:
    """A batch: feature name -> (B, ...) array + the source segments."""

    data: tp.Dict[str, np.ndarray]
    segments: tp.List[tp.Any]

    def __post_init__(self) -> None:
        if not isinstance(self.data, dict):
            raise TypeError(f"'data' needs to be a dict, got: {self.data}")
        if not self.data:
            raise ValueError(f"No data in {self}")
        if not isinstance(self.segments, list):
            raise TypeError(f"'segments' needs to be a list, got {self.segments}")
        batch_size = next(iter(self.data.values())).shape[0]
        if len(self.segments) != batch_size:
            raise RuntimeError(
                f"Incoherent batch size {batch_size} for "
                f"{len(self.segments)} segments"
            )

    @property
    def batch_size(self) -> int:
        return next(iter(self.data.values())).shape[0]


def to_device(
    data: tp.Mapping[str, np.ndarray | torch.Tensor], device: str | torch.device
) -> dict[str, torch.Tensor]:
    """Copy a batch dict onto ``device`` (pinned, non-blocking for CUDA)."""
    device = torch.device(device)
    out = {}
    for key, value in data.items():
        tensor = torch.as_tensor(value)
        if device.type == "cuda" and tensor.device.type == "cpu":
            tensor = tensor.pin_memory()
        out[key] = tensor.to(device, non_blocking=True)
    return out
