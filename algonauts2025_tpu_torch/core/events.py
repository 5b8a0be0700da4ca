"""Typed event taxonomy over stimulus timelines.

Behavioral spec from the reference event model
(data_utils/data_utils/events.py:25-354), re-derived: a pydantic ``Event``
hierarchy with a subclass registry, DataFrame <-> object round-trip,
splittable media events, and ``method:`` URIs that route payload reads back
to the owning timeline object.

Host-side only.  Readers return NumPy arrays (never framework tensors); the
device boundary is crossed later by the feature extractors.

Implementation notes (this rebuild): row parsing partitions columns with a
single pass over a normalized mapping; media splitting is vectorized over a
cut-edge array; the ``method:`` URI dispatch is a standalone resolver.
"""

from __future__ import annotations

import functools
import inspect
import logging
import urllib.parse
from pathlib import Path
from typing import Any, Callable, ClassVar, Dict, List, Optional, Sequence, Tuple, Type, TypeVar, Union

import numpy as np
import pandas as pd
import pydantic
from typing_extensions import Annotated

from .timed import Frequency

logger = logging.getLogger(__name__)

E = TypeVar("E", bound="Event")

_ISSUED_WARNINGS: set[str] = set()


def warn_once(message: str) -> None:
    if message not in _ISSUED_WARNINGS:
        import warnings

        warnings.warn(message)
        _ISSUED_WARNINGS.add(message)


StrCast = Annotated[
    str, pydantic.BeforeValidator(lambda v: str(v) if isinstance(v, int) else v)
]


def _is_missing(value: Any) -> bool:
    """True for scalar NaN/None cells; array-valued cells always count as
    present (pd.isna would return an elementwise mask for those)."""
    flag = pd.isna(value)
    return bool(flag) if np.ndim(flag) == 0 else False


def _row_to_mapping(row: Any) -> Tuple[Dict[str, Any], Optional[int]]:
    """Normalize a dict / itertuples row / Series into (mapping, df_index)."""
    if hasattr(row, "_asdict"):  # namedtuple from DataFrame.itertuples
        return row._asdict(), getattr(row, "Index", None)
    if isinstance(row, pd.Series):
        return row.to_dict(), None
    return dict(row), None


def _register_event_class(cls: Type["Event"]) -> None:
    """Every Event subclass is addressable by its class name (the "type"
    column of event DataFrames)."""
    cls.type = cls.__name__
    Event._CLASSES[cls.type] = cls


class Event(pydantic.BaseModel):
    """A typed span [start, start+duration) on a named timeline."""

    timeline: str
    start: float
    duration: pydantic.NonNegativeFloat = 0.0
    extra: Dict[str, Any] = {}

    type: ClassVar[str] = "Event"
    _CLASSES: ClassVar[Dict[str, Type["Event"]]] = {}
    _index: Optional[int] = None

    def __init_subclass__(cls) -> None:
        super().__init_subclass__()
        _register_event_class(cls)

    def __str__(self) -> str:
        return ", ".join(f"{k}={v}" for k, v in self if k != "extra")

    @property
    def stop(self) -> float:
        return self.duration + self.start

    def model_post_init(self, context: object) -> None:
        super().model_post_init(context)
        if _is_missing(self.start):
            raise ValueError(f"no start time on {self!r}")

    def to_dict(self) -> Dict[str, Any]:
        """Flatten to a DataFrame-ready dict: extras, then type, then the
        declared fields (fields win on collision; Paths become str)."""
        declared = {
            name: str(value) if isinstance(value, Path) else value
            for name, value in self
            if name != "extra"
        }
        return {**self.extra, "type": self.type, **declared}

    @classmethod
    def from_dict(cls, row: Any) -> "Event":
        """Build the registered Event subclass named by ``row["type"]``.

        Unknown keys land in ``extra`` (an ``extra__`` prefix is stripped);
        missing/NaN cells are dropped so pydantic defaults apply.
        """
        mapping, df_index = _row_to_mapping(row)
        target = cls._CLASSES[mapping["type"]]
        if not issubclass(target, cls):
            raise TypeError(f"{target} is not a subclass of {cls}")
        declared = target.model_fields.keys()
        present = {k: v for k, v in mapping.items() if not _is_missing(v)}
        kwargs = {k: v for k, v in present.items() if k in declared}
        spill = {
            (k[len("extra__") :] if k.startswith("extra__") else k): v
            for k, v in present.items()
            if k not in declared and k != "type"
        }
        kwargs["extra"] = {**kwargs.get("extra", {}), **spill}
        try:
            event = target(**kwargs)
        except Exception:
            logger.warning(
                "Event.from_dict failed for row %s (kwargs %s)", mapping, kwargs
            )
            raise
        event._index = df_index
        return event


Event._CLASSES["Event"] = Event


class EventTypesHelper:
    """Resolve a type spec (name(s) or an Event class) to the set of
    concrete registered subclass names it covers."""

    classes: Tuple[Type[Event], ...]

    def __init__(self, event_types: Union[str, Type[Event], Sequence[str]]) -> None:
        self.specified = event_types
        if inspect.isclass(event_types):
            self.classes = (event_types,)
        else:
            names = [event_types] if isinstance(event_types, str) else event_types
            unknown = [n for n in names if n not in Event._CLASSES]
            if unknown:
                raise ValueError(
                    f"{list(names)} is an invalid event name, "
                    f"use one of {list(Event._CLASSES)}"
                )
            self.classes = tuple(Event._CLASSES[n] for n in names)
        self.names = [
            name
            for name, klass in Event._CLASSES.items()
            if issubclass(klass, self.classes)
        ]


def _resolve_method_uri(uri: str, timeline: str) -> Callable[[], Any]:
    """Turn ``method:<name>?k=v`` into a bound call on the timeline object
    registered under ``timeline`` (see data.study.TIMELINES)."""
    from ..data.study import TIMELINES

    parts = urllib.parse.urlparse(uri)
    for field in ("netloc", "params", "fragment"):
        if getattr(parts, field):
            raise AssertionError(f"unsupported {field} in method URI {uri!r}")
    owner = TIMELINES[timeline]
    query = dict(urllib.parse.parse_qsl(parts.query, strict_parsing=True))
    return functools.partial(getattr(owner, parts.path), **query)


class BaseDataEvent(Event):
    """An event whose payload lives in a file (or behind a method: URI)."""

    filepath: Union[Path, str] = ""
    frequency: float = 0
    _read_method: Any = None

    def model_post_init(self, context: object) -> None:
        super().model_post_init(context)
        if not self.filepath:
            raise ValueError("filepath is required")
        self._bind_reader()
        self.filepath = str(self.filepath)
        if ":" not in self.filepath and not Path(self.filepath).exists():
            warn_once(f"file missing: {self.filepath}")

    def _bind_reader(self) -> None:
        try:
            already = getattr(self, "_read_method", None) is not None
        except TypeError:
            already = False
        if already:
            return
        uri = str(self.filepath)
        if uri.startswith("method:"):
            self._read_method = _resolve_method_uri(uri, self.timeline)
        else:
            self._read_method = self._read

    def read(self) -> Any:
        self._bind_reader()
        return self._read_method()

    def _read(self) -> Any:
        raise NotImplementedError

    def _missing_duration_or_frequency(self) -> bool:
        return any(_is_missing(v) or not v for v in (self.duration, self.frequency))

    def __hash__(self) -> int:
        payload = sorted((k, str(v)) for k, v in self.to_dict().items())
        return hash(str(payload))

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, self.__class__) and hash(self) == hash(other)


class BaseSplittableEvent(BaseDataEvent):
    """A data event that can be cut at timepoints (chunking support)."""

    offset: pydantic.NonNegativeFloat = 0.0

    def _split(
        self, timepoints: List[float], min_duration: Optional[float] = None
    ) -> Sequence["BaseSplittableEvent"]:
        """Cut this event at the given (relative) timepoints.

        Cuts outside (0, duration) are ignored; with ``min_duration``, cuts
        whose gap to either neighbor edge falls short are dropped.
        """
        span = self.duration
        cuts = np.unique([t for t in timepoints if 0 < t < span])
        if min_duration and cuts.size:
            gap_lo = np.diff(cuts, prepend=0.0)
            gap_hi = np.diff(cuts, append=span)
            cuts = cuts[(gap_lo >= min_duration) & (gap_hi >= min_duration)]
        edges = np.concatenate([[0.0], cuts, [span]])
        if np.any(np.diff(edges) <= 0):
            raise ValueError(f"cut edges must be strictly increasing: {edges}")
        base = dict(self)
        pieces = []
        for lo, hi in zip(edges[:-1], edges[1:]):
            base.update(
                start=self.start + lo, duration=hi - lo, offset=self.offset + lo
            )
            pieces.append(type(self)(**base))
        return pieces


class Image(BaseDataEvent):
    caption: str = ""

    def model_post_init(self, context: object) -> None:
        super().model_post_init(context)
        if self.duration <= 0:
            logger.info("ignoring zero-duration Image event")

    def _read(self) -> Any:
        from PIL import Image as PILImage

        with PILImage.open(self.filepath) as img:
            return img.convert("RGB")


class Sound(BaseSplittableEvent):
    """A span of an audio file.  ``read()`` -> float32 (samples, channels)."""

    def model_post_init(self, context: object) -> None:
        if not Path(str(self.filepath)).exists():
            raise ValueError(f"no such audio file: {self.filepath}")
        if self._missing_duration_or_frequency():
            from ..io import wav as wavio

            header = wavio.info(str(self.filepath))
            self.frequency = float(header.samplerate)
            self.duration = header.duration
        super().model_post_init(context)

    def _read(self) -> np.ndarray:
        from ..io import wav as wavio

        rate = Frequency(self.frequency)
        samples = wavio.read(
            str(self.filepath),
            start=rate.to_ind(self.offset),
            frames=rate.to_ind(self.duration),
        )
        return samples[:, None] if samples.ndim == 1 else samples


class Video(BaseSplittableEvent):
    """A span of a video file.  ``read()`` -> io.video.VideoClip."""

    def model_post_init(self, context: object) -> None:
        if not Path(str(self.filepath)).exists():
            raise ValueError(f"no such video file: {self.filepath}")
        if self._missing_duration_or_frequency():
            from ..io import video as videoio

            header = videoio.info(str(self.filepath))
            self.frequency = float(header.fps)
            self.duration = header.duration
        super().model_post_init(context)

    def _read(self) -> Any:
        from ..io import video as videoio

        return videoio.VideoClip(
            str(self.filepath), offset=self.offset, duration=self.duration
        )


class BaseText(Event):
    text: str = pydantic.Field("", min_length=1)
    context: str = ""
    language: str = ""


class Word(BaseText):
    sentence: str = ""
    sentence_char: Optional[int] = None


class Text(BaseText):
    pass


class Phoneme(BaseText):
    pass


class Sentence(BaseText):
    pass


class Fmri(BaseDataEvent):
    """BOLD recording: (parcels, time) at ``frequency`` Hz (TR = 1/freq)."""

    subject: StrCast = ""

    def model_post_init(self, context: object) -> None:
        self.subject = str(self.subject)
        for missing, what in (
            (self._missing_duration_or_frequency(), "duration and frequency"),
            (not self.subject, "a subject"),
        ):
            if missing:
                raise ValueError(f"Fmri event needs {what}; got: {self}")
        super().model_post_init(context)

    def _read(self) -> np.ndarray:
        from ..io import fmri as fmriio

        data = fmriio.load(str(self.filepath))
        # io.fmri.load returns the array AS STORED; this event declares
        # frequency/duration, so orientation is validated here instead of
        # guessed there (the Algonauts release stores time-major files)
        n_expected = int(round(float(self.duration) * float(self.frequency)))
        err_time_last = abs(data.shape[-1] - n_expected)
        err_time_first = abs(data.shape[0] - n_expected)
        if min(err_time_last, err_time_first) > 1:
            raise ValueError(
                f"Fmri file {self.filepath} has shape {data.shape}; neither "
                f"axis matches the declared {n_expected} timesteps "
                f"(duration {self.duration} s at {self.frequency} Hz)"
            )
        if err_time_last <= 1 and err_time_first <= 1:
            # BOTH axes within the +/-1 tolerance (e.g. 1000 parcels and
            # ~1000 TRs, or a time axis off by one TR while the parcel
            # count equals the declared timesteps): orientation is
            # undecidable from shape, and a wrong guess silently swaps
            # axes — fail loudly instead (r4: previously only the exact
            # tie raised; the smaller-error axis won otherwise)
            raise ValueError(
                f"Fmri file {self.filepath} has shape {data.shape}: BOTH axes "
                f"are within 1 of the declared {n_expected} timesteps, so the "
                "orientation is ambiguous.  Store the file (parcels, time) or "
                "use a parcel count that differs from the timestep count"
            )
        if err_time_last < err_time_first:
            return data  # (parcels, time) — the framework contract
        return np.ascontiguousarray(data.T)
