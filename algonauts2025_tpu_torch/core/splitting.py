"""Deterministic split assignment and event chunking.

Behavioral spec from reference data_utils/data_utils/splitting.py.  The
splitter must stay bit-identical across processes and hosts (it defines the
train/val partition and therefore cache identity), so the scoring recipe —
sha256(uid) as an integer, seeded ``random.Random``, one uniform draw — is
preserved exactly; everything around it is re-derived.
"""

from __future__ import annotations

import bisect
import hashlib
import itertools
import math
import random
from typing import Any, Dict, List, Literal, Mapping, Optional

import numpy as np
import pandas as pd

from .events import BaseSplittableEvent, Event


class DeterministicSplitter:
    """Hash a uid into a split name with fixed ratios.

    The uid -> score map is pure and stable: two hosts (or two runs years
    apart) assign the same uid to the same split.
    """

    def __init__(self, ratios: Mapping[str, float], seed: float = 0.0) -> None:
        if min(ratios.values()) <= 0:
            raise AssertionError("all split ratios must be > 0")
        if not math.isclose(sum(ratios.values()), 1.0, rel_tol=1e-5, abs_tol=1e-8):
            raise AssertionError(f"split ratios must sum to 1, got {ratios}")
        self.ratios = dict(ratios)
        self.seed = seed
        self._names = list(ratios)
        self._edges = list(itertools.accumulate(ratios.values()))

    def __repr__(self) -> str:
        return f"{type(self).__name__}(ratios={self.ratios}, seed={self.seed})"

    def _score(self, uid: str) -> float:
        digest = int(hashlib.sha256(uid.encode()).hexdigest(), 16)
        return random.Random(digest + self.seed).random()

    def __call__(self, uid: str) -> str:
        score = self._score(uid)
        slot = bisect.bisect_right(self._edges, score)
        if slot >= len(self._names):
            # fp rounding can leave the last edge fractionally below 1.0
            raise ValueError(f"score {score} beyond cdf {self._edges}")
        return self._names[slot]


def _grid_cuts(
    lo: float, hi: float, step: float, min_tail: Optional[float]
) -> List[float]:
    """Regular cut grid over [lo, hi); drops the last cut when the tail it
    would create is shorter than ``min_tail``."""
    cuts: List[float] = np.arange(lo, hi, step).tolist()
    if min_tail is not None and cuts and hi - cuts[-1] < min_tail:
        cuts.pop()
    return cuts


def _section_cuts(df: pd.DataFrame, use_type: str, step: float) -> List[float]:
    """Cut grids restarted at every split-label change of ``use_type``
    events (so chunks never straddle a train/val boundary)."""
    marks = df.loc[df.type == use_type, ["start", "duration", "split"]]
    labels = marks.split.astype(str).to_numpy()
    fresh = np.ones(len(marks), dtype=bool)
    fresh[1:] = labels[1:] != labels[:-1]
    section_of = np.cumsum(fresh)
    cuts: List[float] = []
    starts = marks.start.to_numpy()
    stops = starts + marks.duration.to_numpy()
    for sec in np.unique(section_of):
        inside = section_of == sec
        cuts.extend(np.arange(starts[inside][0], stops[inside][-1], step))
    return cuts


def chunk_events(
    events: pd.DataFrame,
    event_type_to_chunk: Literal["Sound", "Video"],
    event_type_to_use: Optional[str] = None,
    min_duration: Optional[float] = None,
    max_duration: float = np.inf,
) -> pd.DataFrame:
    """Split long media events into <= max_duration pieces.

    Per timeline, cut points are either a regular ``max_duration`` grid or
    restart at split-section boundaries of ``event_type_to_use`` events
    (reference splitting.py:43-106 semantics).  Extra columns of the
    original rows (split/movie/chunk/...) are carried onto the pieces.

    Documented divergence: the reference copies ``row._asdict()`` wholesale
    (splitting.py:96-99), which leaks the itertuples ``Index`` (the chunked
    row's ORIGINAL positional index) as an inert junk column on chunked
    rows; this rebuild does not reproduce it (nothing downstream reads it —
    it would only round-trip into Event.extra as noise).
    """
    target_cls = Event._CLASSES[event_type_to_chunk]
    if not issubclass(target_cls, BaseSplittableEvent):
        raise AssertionError(f"cannot chunk non-splittable type {event_type_to_chunk}")
    if event_type_to_use is not None and "split" not in events.columns:
        raise AssertionError("a split column is required when event_type_to_use is set")

    pieces: List[Dict[str, Any]] = []
    replaced: List[Any] = []
    for _, group in events.groupby("timeline"):
        group = group.sort_values("start")
        if event_type_to_use is None:
            lo = float(np.nanmin(group.start.to_numpy()))
            hi = float(np.nanmax(group.stop.to_numpy()))
            cuts = _grid_cuts(lo, hi, max_duration, min_duration)
        else:
            cuts = _section_cuts(group, event_type_to_use, max_duration)

        targets = group.loc[group.type == event_type_to_chunk]
        replaced.extend(targets.index)
        for record in targets.to_dict(orient="records"):
            original = target_cls.from_dict(record)
            rel_cuts = [t - original.start for t in cuts]
            for part in original._split(rel_cuts, min_duration):
                row = dict(record)
                row.update(part.to_dict())
                pieces.append(row)

    keep = events.drop(index=replaced)
    return pd.concat([keep, pd.DataFrame(pieces)]).reset_index(drop=True)
