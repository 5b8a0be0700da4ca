"""Time/frequency core: sample-rate conversion and time-windowed arrays.

Host-side pure-NumPy by design: ragged time alignment happens *before*
tensors enter the XLA world, so the device only ever sees fixed-shape
(B, L, D, T) blocks.

Behavioral contract (matches the reference time core,
data_utils/data_utils/base.py:40-211, re-derived from its semantics):

- ``Frequency.to_ind`` rounds (not floors) seconds -> sample index.
- ``TimedArray`` wraps an array whose *last* axis is time at ``frequency``
  Hz starting at ``start`` seconds.  ``frequency == 0`` marks a static
  (non-sampled) payload covering ``[start, start + duration)``.
- ``a += b`` accumulates ``b``'s overlap onto ``a``'s grid; with
  ``aggregation="average"`` a per-timepoint streaming mean is kept.
- Window extraction clamps to at least one timepoint when windows touch,
  and a zero-width contact between two extended windows is no overlap.

Implementation notes (this rebuild): all window math is centralised in
``_clip_window`` which works in integer sample space; the sum-aggregation
hot path (2D float32, the dataloader case) goes through the native C++
``overlap_add`` kernel with explicit bounds validation.
"""

from __future__ import annotations

import typing as tp

import numpy as np

__all__ = ["Frequency", "TimedArray"]


class Frequency(float):
    """A sampling rate in Hz with second <-> sample-index conversions."""

    def to_ind(self, seconds: tp.Any) -> tp.Any:
        """Nearest sample index for a time offset (vectorized over arrays)."""
        nearest = np.round(np.multiply(seconds, float(self)))
        if isinstance(seconds, np.ndarray):
            return nearest.astype(int)
        return int(nearest)

    def to_sec(self, index: tp.Any) -> tp.Any:
        """Time offset of a sample index at this rate."""
        return index / self


class _Span(tp.NamedTuple):
    """An aligned sub-window of a TimedArray."""

    lo: float  # aligned window start (absolute seconds)
    width: float  # aligned window length (seconds)
    index: slice | None  # payload sample slice; None for static payloads
    # (None is the REFERENCE CONTRACT, base.py:181: data[..., None] appends
    # a broadcast axis so a static payload spreads over the target window
    # during overlap-add accumulation — do not "fix" it to slice(None))


def _clip_window(array: "TimedArray", start: float, duration: float) -> _Span | None:
    """Intersect [start, start+duration) with ``array``'s own window.

    Returns the grid-aligned span, or None when the windows are disjoint.
    A zero-width contact counts only if one of the two windows is itself
    zero-length (so point-like events still land on the grid).
    """
    if duration < 0:
        raise ValueError(f"negative window duration: {duration}")
    lo = start if start > array.start else array.start
    hi = min(start + duration, array.stop)
    if hi < lo:
        return None
    if hi == lo and duration != 0 and array.duration != 0:
        return None
    rate = array.frequency
    if not rate:
        return _Span(lo, hi - lo, None)
    first = rate.to_ind(lo - array.start)
    count = max(1, rate.to_ind(hi - lo))
    total = array.data.shape[-1]
    if first > total - count:
        first = total - count
    if first < 0:
        raise RuntimeError(
            f"window [{start}, {start + duration}) cannot be aligned on {array}"
        )
    return _Span(
        rate.to_sec(first) + array.start,
        float(rate.to_sec(count)),
        slice(first, first + count),
    )


class TimedArray:
    """An nd-array whose last axis is a time grid, with overlap-add.

    Parameters
    ----------
    frequency: sampling rate of the last axis (Hz); 0 means static data
        spanning the whole window.
    start: window start in seconds.
    data: payload; when None, an empty accumulator sized from ``duration``
        is created (its feature shape is adopted from the first ``+=``).
    duration: window length in seconds (required when data is None or
        frequency == 0).
    aggregation: "sum" accumulates overlaps; "average" maintains a running
        mean via per-timepoint visit counts.
    """

    def __init__(
        self,
        *,
        frequency: float,
        start: float,
        data: np.ndarray | None = None,
        duration: float | None = None,
        aggregation: str = "sum",
    ) -> None:
        if aggregation not in ("sum", "average"):
            raise ValueError(f"Unknown {aggregation=}")
        if duration is not None and duration < 0:
            raise ValueError(f"duration should be None or >=0, got {duration}")
        self.frequency = Frequency(frequency)
        self.start = start
        self.aggregation = aggregation
        self.data = self._coerce_payload(data, duration)
        if self.frequency:
            self.duration = float(self.frequency.to_sec(self.data.shape[-1]))
        elif duration is None:
            raise ValueError(f"duration must be provided if {frequency=}")
        else:
            self.duration = duration
        self._seen: np.ndarray | None = None
        if aggregation == "average":
            width = self.data.shape[-1] if self.frequency else 1
            self._seen = np.zeros(width, dtype=int)

    def _coerce_payload(
        self, data: np.ndarray | None, duration: float | None
    ) -> np.ndarray:
        """Validate a payload against (frequency, duration), or build an
        empty accumulator when no payload is given."""
        if data is None:
            if duration is None:
                raise ValueError("Missing data or duration")
            if not self.frequency:
                return np.zeros((0,))
            return np.zeros((0, max(1, self.frequency.to_ind(duration))))
        if self.frequency and duration is not None:
            if not data.shape[-1]:
                raise ValueError(
                    f"Last dimension is empty but frequency is not null "
                    f"(shape={data.shape})"
                )
            want = max(1, self.frequency.to_ind(duration))
            if abs(data.shape[-1] - want) > 2:
                raise ValueError(
                    f"Data has incorrect (last) dimension {data.shape} for "
                    f"duration {duration} and frequency {self.frequency} "
                    f"(expected {want})"
                )
        return data

    @property
    def stop(self) -> float:
        return self.start + self.duration

    def __repr__(self) -> str:
        head = (
            f"frequency={self.frequency},start={self.start},"
            f"duration={self.duration},aggregation={self.aggregation}"
        )
        return f"{type(self).__name__}({head},data={self.data})"

    def overlap(self, start: float, duration: float) -> tp.Optional["TimedArray"]:
        """Extract the sub-window overlapping [start, start+duration)."""
        span = _clip_window(self, start, duration)
        if span is None:
            return None
        return TimedArray(
            frequency=self.frequency,
            start=span.lo,
            duration=span.width,
            data=self.data[..., span.index],
        )

    # -- accumulation -----------------------------------------------------

    def _check_addable(self, other: "TimedArray") -> None:
        if not other.frequency or self.frequency == other.frequency:
            return
        drift = abs(self.frequency - other.frequency)
        if drift * max(self.duration, other.duration) >= 0.5:
            raise ValueError(
                "Cannot add with different (non-0) frequencies "
                f"({other.frequency} and {self.frequency})"
            )

    def _adopt_shape(self, other: "TimedArray") -> np.ndarray:
        """Feature shape comes from the first contribution; the time width
        stays ours."""
        head = other.data.shape[:-1] if other.frequency else other.data.shape
        tail = (self.data.shape[-1],) if self.frequency else ()
        return np.zeros(head + tail, dtype=other.data.dtype)

    def _sum_into(self, src: np.ndarray, dst_sl: tp.Any, src_sl: tp.Any) -> None:
        if (
            isinstance(dst_sl, slice)
            and isinstance(src_sl, slice)
            and self.data.ndim == 2
            and src.ndim == 2
            and self.data.dtype == np.float32
            and src.dtype == np.float32
            and dst_sl.stop - dst_sl.start == src_sl.stop - src_sl.start
        ):
            from ..native import overlap_add

            if overlap_add(
                self.data, src, dst_sl.start, src_sl.start, dst_sl.stop - dst_sl.start
            ):
                return
        self.data[..., dst_sl] += src[..., src_sl]

    def _mean_into(self, src: np.ndarray, dst_sl: tp.Any, src_sl: tp.Any) -> None:
        assert self._seen is not None
        seen = self._seen[..., dst_sl]
        step = 1.0 / (1.0 + seen)
        self.data[..., dst_sl] += (src[..., src_sl] - self.data[..., dst_sl]) * step
        seen += 1

    def __iadd__(self, other: "TimedArray") -> "TimedArray":
        self._check_addable(other)
        if not self.data.size:
            self.data = self._adopt_shape(other)
        dst_sl: tp.Any = None
        src_sl: tp.Any = None
        if self.frequency:
            mine = _clip_window(self, other.start, other.duration)
            theirs = _clip_window(other, self.start, self.duration)
            if mine is None or theirs is None:
                return self  # disjoint: nothing to accumulate
            dst_sl, src_sl = mine.index, theirs.index
        if self._seen is None:
            self._sum_into(other.data, dst_sl, src_sl)
        else:
            self._mean_into(other.data, dst_sl, src_sl)
        return self
