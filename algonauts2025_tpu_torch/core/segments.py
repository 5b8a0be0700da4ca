"""Segmentation: fixed training windows over event timelines.

Behavioral spec from reference data_utils/data_utils/segments.py, re-derived.
Windows are ``WINDOW_SECONDS`` long with the same stride, shifted by
``-HEMODYNAMIC_LAG`` seconds for the BOLD response delay (149 s windows,
4.47 s = 3 TR lag; reference segments.py:168-179).

All host-side NumPy: window selection is ragged/dynamic and must stay out of
jit; the device sees only the fixed-shape tensors produced by features
pooled over these windows.

Implementation notes (this rebuild): event normalization works on column
records with a single stable sort keyed on timeline appearance order;
window/event intersection is a vectorized interval test over
struct-of-arrays (starts/stops) per timeline.
"""

from __future__ import annotations


import logging
import warnings
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np
import pandas as pd

from .events import Event, warn_once

logger = logging.getLogger(__name__)

#: Hemodynamic lag in seconds (3 TRs at TR=1.49 s).
HEMODYNAMIC_LAG = 4.47
#: Training window length and stride, in seconds.
WINDOW_SECONDS = 149.0


class Segment:
    """A [start, start+duration) window plus the events overlapping it."""

    def __init__(
        self,
        start: float,
        duration: float,
        _index: np.ndarray,
        ns_events: Optional[List[Event]] = None,
        _trigger: Union[float, Dict[str, Any], None] = None,
    ) -> None:
        self.start = start
        self.duration = duration
        self._index = _index
        self.ns_events = [] if ns_events is None else ns_events
        self._trigger = _trigger

    def __repr__(self) -> str:
        return (
            f"Segment(start={self.start}, duration={self.duration}, "
            f"n_events={len(self.ns_events)}, trigger={self._trigger})"
        )

    @property
    def stop(self) -> float:
        return self.duration + self.start

    @property
    def events(self) -> pd.DataFrame:
        rows = [e.to_dict() for e in self.ns_events]
        if not rows or len(rows) != len(self._index):
            raise RuntimeError(
                f"segment has no usable ns_events/index pair: {self}"
            )
        return pd.DataFrame(data=rows, index=self._index)

    def subsegment(self, start: float, duration: float) -> "Segment":
        """A shorter window at ``start`` seconds *into* this segment."""
        if start < 0:
            raise AssertionError("subsegment start is relative and must be >= 0")
        lo = self.start + start
        hi = lo + duration
        starts = np.fromiter((e.start for e in self.ns_events), dtype=float)
        stops = starts + np.fromiter(
            (e.duration for e in self.ns_events), dtype=float
        )
        hit = np.flatnonzero((starts <= hi) & (stops >= lo))
        return Segment(
            start=lo,
            duration=duration,
            _index=np.asarray(self._index)[hit],
            ns_events=[self.ns_events[i] for i in hit],
            _trigger=self._trigger,
        )


def _normalize_record(record: Dict[str, Any]) -> Dict[str, Any]:
    """Round-trip one event row through its Event class so defaults are
    filled and values coerced; unknown types pass through with a warning."""
    kind = record["type"]
    klass = Event._CLASSES.get(kind)
    if klass is not None:
        return {**record, **klass.from_dict(record).to_dict()}
    if kind in {name.lower() for name in Event._CLASSES}:
        raise ValueError(f"Legacy uncapitalized event {record}")
    warn_once(
        f'Unexpected type "{kind}". Add a new Event subclass in '
        "algonauts2025_tpu_torch.core.events to support it."
    )
    return dict(record)


def validate_events(events: pd.DataFrame) -> pd.DataFrame:
    """Normalize, type-check and sort an events DataFrame.

    Ensures a "type" column of strings, round-trips every row through its
    Event class, sorts by (timeline appearance order, start asc, duration
    desc) and appends a "stop" column.
    """
    if events.empty:
        return events.copy()
    kinds = events.get("type")
    if kinds is None or not all(isinstance(k, str) for k in kinds.unique()):
        raise ValueError('events DataFrame must have a "type" column with strings')

    normalized = pd.DataFrame(
        [_normalize_record(rec) for rec in events.to_dict(orient="records")],
        index=events.index,
    )
    degenerate = normalized.loc[normalized.duration <= 0]
    if len(degenerate):
        warnings.warn(
            f"Found {len(degenerate)} event(s) with null duration "
            f"(types: {degenerate['type'].unique()})"
        )

    appearance = {tl: k for k, tl in enumerate(normalized.timeline.unique())}
    normalized = normalized.assign(_tl_rank=normalized.timeline.map(appearance))
    normalized = normalized.sort_values(
        by=["_tl_rank", "start", "duration"],
        ascending=[True, True, False],
        kind="stable",
        ignore_index=True,
    ).drop(columns="_tl_rank")

    front = ["type", "start", "duration", "timeline"]
    rest = [c for c in normalized.columns if c not in front]
    normalized = normalized.loc[:, front + rest]
    normalized["stop"] = normalized.start + normalized.duration
    return normalized


class SegmentCreator:
    """Struct-of-arrays event index for one timeline; cuts windows fast."""

    def __init__(self, events: List[Event]) -> None:
        distinct = set(map(lambda e: e.timeline, events))
        if len(distinct) > 1:
            raise ValueError(
                f"{type(self).__name__} needs a single timeline, got {distinct}"
            )
        self.events = np.array(events, dtype=object)
        self.starts = np.fromiter((e.start for e in events), dtype=float)
        self.stops = self.starts + np.fromiter(
            (e.duration for e in events), dtype=float
        )
        self.indices = np.array([event._index for event in events])

    @classmethod
    def from_obj(cls, obj: Any) -> Dict[str, "SegmentCreator"]:
        """One creator per timeline, keyed in timeline appearance order."""
        from ..data import helpers

        per_timeline: Dict[str, List[Event]] = {}
        for event in helpers.extract_events(obj):
            per_timeline.setdefault(event.timeline, []).append(event)
        keys: List[str] = list(per_timeline)
        if isinstance(obj, pd.DataFrame):
            keys = list(obj.timeline.unique())
        # a timeline may carry only unregistered event types (which
        # validate_events tolerates with a warning and extract_events
        # drops): give it an empty creator like the reference's
        # defaultdict(list) instead of a KeyError
        return {key: cls(per_timeline.get(key, [])) for key in keys}

    def select(self, start: float, duration: float) -> Segment:
        """All events intersecting [start, start+duration)."""
        hit = np.flatnonzero((self.starts < start + duration) & (self.stops > start))
        return Segment(
            start=start,
            duration=duration,
            _index=self.indices[hit],
            ns_events=list(self.events[hit]),
        )


def _window_starts(lo: float, hi: float, stride: float) -> np.ndarray:
    """Window start grid covering [lo, hi] inclusive-ish (1e-8 slack)."""
    return np.arange(lo, hi + 1e-8, stride)


def iter_segments(
    events: pd.DataFrame,
    *,
    start_jitter: float = 0.0,
) -> Iterator[Segment]:
    """Cut each timeline into lag-shifted fixed windows.

    ``start_jitter`` shifts every window start (used by the JitterWindows
    training callback; reference callbacks.py:25-44).
    """
    for creator in SegmentCreator.from_obj(events).values():
        shift = start_jitter - HEMODYNAMIC_LAG
        for lo in _window_starts(
            creator.starts.min() + shift, creator.stops.max() + shift, WINDOW_SECONDS
        ):
            seg = creator.select(start=lo, duration=WINDOW_SECONDS)
            seg._trigger = lo
            yield seg


def list_segments(events: pd.DataFrame) -> List[Segment]:
    return list(iter_segments(events))


def find_enclosed(df: pd.DataFrame, start: float, duration: float) -> pd.Series:
    """Indices of events fully inside [start, start+duration]."""
    lo = df.start.to_numpy()
    hi = lo + df.duration.to_numpy()
    inside = (lo >= start) & (hi <= start + duration)
    return pd.Series(df.index[inside])


def find_overlap(
    events: pd.DataFrame, *, start: float = 0.0, duration: Optional[float] = None
) -> pd.Series:
    """Indices of events overlapping [start, start+duration] (single
    timeline only): starting inside, ending inside, or covering it."""
    if duration is None:
        raise AssertionError("duration is required")
    if events.timeline.nunique() != 1:
        raise AssertionError("find_overlap expects a single timeline")
    lo = events.start
    hi = events.start + events.duration
    end = start + duration
    starts_inside = (lo >= start) & (lo < end)
    ends_inside = (hi > start) & (hi <= end)
    covers = (lo <= start) & (hi >= end)
    return pd.Series(events.index[starts_inside | ends_inside | covers])
