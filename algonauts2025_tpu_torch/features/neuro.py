"""Fmri target feature: z-scored BOLD on the TR grid with hemodynamic lag.

Rebuild of reference data_utils/data_utils/features/neuro.py:25-153: reads
the Fmri event payload ((parcels, time) float32), z-scores each parcel over
time (nilearn "zscore_sample" parity: ddof=1), caches, and exposes it as a
TimedArray at 1/TR Hz whose start is shifted by -4.47 s so that windows cut
with the same lag line up (neuro.py:143-153).
"""

from __future__ import annotations

import typing as tp

import numpy as np

from ..core.events import Event, Fmri as FmriEvent
from ..core.segments import HEMODYNAMIC_LAG
from ..core.timed import TimedArray
from .base import FeatureBase

__all__ = ["Fmri"]

TR_FREQUENCY = 1 / 1.49


def zscore_sample(data: np.ndarray, axis: int = -1, eps: float = 1e-8) -> np.ndarray:
    """Per-row sample z-score (ddof=1), nilearn standardize='zscore_sample'."""
    mean = data.mean(axis=axis, keepdims=True)
    std = data.std(axis=axis, keepdims=True, ddof=1)
    return (data - mean) / np.maximum(std, eps)


class Fmri(FeatureBase):
    name: tp.Literal["Fmri"] = "Fmri"

    event_type: tp.ClassVar[str] = "Fmri"
    frequency: tp.ClassVar[float] = TR_FREQUENCY

    def _exclude_from_cache_uid(self) -> list[str]:
        return ["device", "offset"]

    @staticmethod
    def item_uid(event: Event) -> str:
        return str(event.filepath)  # type: ignore[attr-defined]

    def _compute(self, events: tp.Sequence[FmriEvent]) -> tp.Iterator[np.ndarray]:
        for event in events:
            data = np.asarray(event.read(), dtype=np.float32)  # (parcels, time)
            yield zscore_sample(data).astype(np.float32)

    def __call__(self, events, start, duration, trigger=None):
        from ..data import helpers

        events = helpers.extract_events(events, types=self._event_types_helper)
        # a window only ever intersects one recording (reference neuro.py:87)
        return super().__call__(events[:1], start=start, duration=duration, trigger=trigger)

    def _get_timed_arrays(
        self, events: list[FmriEvent], start: float, duration: float
    ) -> tp.Iterable[TimedArray]:
        for event, data in zip(events, self._get_data(events)):
            yield TimedArray(
                data=np.asarray(data),
                frequency=event.frequency,
                start=event.start - HEMODYNAMIC_LAG,
                duration=event.duration,
            )
