"""SubjectEncoder: subject label -> integer index per segment.

Rebuild of reference data_utils/data_utils/features/subject.py:23-149.
``prepare`` builds the label table from all events; ``__call__`` returns a
(1,) int32 array for the segment's subject — the index the per-subject
readout and grouped metrics key on.
"""

from __future__ import annotations

import logging
import typing as tp

import numpy as np
import pydantic

from ..core.events import Event
from ..core.timed import TimedArray
from .base import FeatureBase

logger = logging.getLogger(__name__)

__all__ = ["SubjectEncoder"]


class SubjectEncoder(FeatureBase):
    name: tp.Literal["SubjectEncoder"] = "SubjectEncoder"

    event_type: tp.ClassVar[str] = "Event"
    frequency: tp.ClassVar[float] = 0.0

    _label_to_ind: dict[str, int] = pydantic.PrivateAttr(default={})

    @staticmethod
    def item_uid(event: Event) -> str:
        raise NotImplementedError  # no bulk cache for this feature

    @staticmethod
    def _extract_subject(event: Event) -> str:
        if hasattr(event, "subject"):
            return getattr(event, "subject")
        return event.extra["subject"]

    @property
    def n_subjects(self) -> int:
        return len(self._label_to_ind)

    def prepare(self, obj: tp.Any) -> None:
        from ..data import helpers

        events = helpers.extract_events(obj, types=self._event_types_helper)
        field = "subject"
        if not all(hasattr(e, field) or field in e.extra for e in events):
            raise TypeError(f"Field {field} not found in events for SubjectEncoder")
        labels = set(self._extract_subject(e) for e in events)
        if len(labels) < 2:
            logger.warning(
                "SubjectEncoder found a single label: %s (probably unintended)", labels
            )
        self._label_to_ind = {label: i for i, label in enumerate(sorted(labels))}
        if events:
            self(events[0], events[0].start, duration=0.001)

    def get_static(self, event: Event) -> np.ndarray:
        if not self._label_to_ind:
            raise ValueError("Call subject_encoder.prepare(events) before use.")
        return np.asarray(
            [self._label_to_ind[self._extract_subject(event)]], dtype=np.int64
        )

    def _get_timed_arrays(
        self, events: list[Event], start: float, duration: float
    ) -> tp.Iterable[TimedArray]:
        for event in events[:1]:
            yield TimedArray(
                frequency=0,
                duration=event.duration,
                start=event.start,
                data=self.get_static(event),
            )

    def __call__(self, events, start, duration, trigger=None):
        from ..data import helpers

        events = helpers.extract_events(events, types=self._event_types_helper)
        out = super().__call__(events[:1], start=start, duration=duration, trigger=trigger)
        return out.astype(np.int64)
