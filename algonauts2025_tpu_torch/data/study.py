"""Study loading: timeline discovery -> event DataFrames -> enhancer chain.

Behavioral spec from reference data_utils/data_utils/data.py, re-derived.
A study is a set of (subject, timeline) recordings; each timeline loads its
raw events, the StudyLoader concatenates them, runs the enhancer pipeline
and caches both per-timeline and final frames (parquet) keyed by config
hash.

The ``TIMELINES`` registry lets ``method:`` URIs inside events dispatch
reads back to their owning timeline object.
"""

from __future__ import annotations

import hashlib
import logging
import re
from pathlib import Path
from typing import Any, ClassVar, Dict, Iterator, List, Optional, Type, Union, final

import pandas as pd
import pydantic

from ..cache.frame_store import FrameStore
from ..config.uid import config_uid
from ..core.events import StrCast
from ..core.segments import validate_events
from .enhancers import Enhancer

logger = logging.getLogger(__name__)

PathLike = Union[str, Path]

#: timeline name -> owning BaseData (method: URI dispatch table)
TIMELINES: Dict[str, "BaseData"] = {}

_STUDIES: Dict[str, Type["BaseData"]] = {}


def _compress_string(raw: str) -> str:
    """Filesystem-safe short name; output is identical to the reference's
    scheme (timeline names are cache keys and must stay stable)."""
    raw = str(raw)

    def _h10(s: str) -> str:
        return hashlib.sha256(s.encode()).hexdigest()[:10]

    name = Path(raw).name
    safe = re.sub(r"[^a-zA-Z0-9.\-_]", "", name)
    if len(name) > 70:
        safe = "_".join([safe[:20], _h10(name), safe[-20:]])
    if str(Path(raw).parent) != "." or safe != name:
        safe = f"{_h10(raw)}_{safe}"
    return safe


class BaseData(pydantic.BaseModel):
    """One (subject, timeline) recording of a study."""

    subject: StrCast
    path: PathLike
    timeline: str = ""

    version: ClassVar[str] = "v1"
    study: ClassVar[str] = ""

    def __init_subclass__(cls) -> None:
        super().__init_subclass__()
        _STUDIES[cls.__name__] = cls

    def _auto_timeline_name(self) -> str:
        """<ClassName>_<field>-<value>_... over all fields except path."""
        skip = {"path", "timeline"}
        parts = [type(self).__name__] + [
            f"{name}-{getattr(self, name)}"
            for name in type(self).model_fields
            if name not in skip
        ]
        return _compress_string("_".join(parts))

    def model_post_init(self, context: object) -> None:
        super().model_post_init(context)
        if not self.timeline:
            self.timeline = self._auto_timeline_name()
        TIMELINES[self.timeline] = self

    @classmethod
    def _iter_timelines(cls, path: Path) -> Iterator["BaseData"]:
        raise NotImplementedError

    @final
    @classmethod
    def resolve_root(cls, path: PathLike) -> Path:
        """Dataset root for this study: ``path`` itself, or a nested
        ``path/<StudyName>`` directory when the study lives one level down.
        Shared by timeline discovery and anything else that reads files
        relative to the dataset (e.g. submission sample counts) so they
        cannot disagree about where the data is."""
        root = Path(path)
        study = cls.__name__
        if root.name.lower() != study.lower():
            nested = [root / study, root / study.lower()]
            root = next((p for p in nested if p.exists()), root)
        return root

    @final
    @classmethod
    def iter_timelines(cls, path: PathLike) -> Iterator["BaseData"]:
        Path(path).mkdir(parents=True, exist_ok=True)
        root = cls.resolve_root(path)
        empty = True
        for timeline in cls._iter_timelines(root):
            empty = False
            yield timeline
        if empty:
            raise RuntimeError(f"No timeline found for {cls.__name__} in {root}")

    def _load_events(self) -> pd.DataFrame:
        raise NotImplementedError

    @final
    def load(self) -> pd.DataFrame:
        events = self._load_events()
        for column in ("subject", "timeline"):
            if column in events:
                raise ValueError(f"Column {column} already exists in events dataframe")
            events[column] = getattr(self, column)
        events["study"] = type(self).__name__
        return validate_events(events)


class StudyInfra(pydantic.BaseModel):
    """Caching config for the study build (parquet event cache)."""

    model_config = pydantic.ConfigDict(extra="forbid")
    folder: Union[str, Path, None] = None
    mode: str = "cached"
    version: str = "1"
    cluster: Optional[str] = None

    @pydantic.field_validator("mode")
    @classmethod
    def _known_mode(cls, v: str) -> str:
        if v not in ("cached", "force"):
            raise ValueError(f"unknown study cache mode {v!r}")
        return v


class StudyLoader(pydantic.BaseModel):
    """Builds the full (enhanced) events DataFrame for a study."""

    model_config = pydantic.ConfigDict(extra="forbid")

    path: PathLike
    study: str = "Algonauts2025"
    query: Optional[str] = None
    # SerializeAsAny: the wrap-validator dispatches into subclasses, so
    # serialization must follow the runtime class too — a plain Enhancer
    # annotation dumps only base fields, silently dropping every enhancer
    # kwarg on round trips (job-array task files, cache uids)
    enhancers: Union[
        List[pydantic.SerializeAsAny[Enhancer]],
        Dict[str, pydantic.SerializeAsAny[Enhancer]],
    ] = []
    infra: StudyInfra = StudyInfra()
    cache_all_timelines: bool = True

    _timelines: Optional[List[BaseData]] = None

    def _exclude_from_cache_uid(self) -> List[str]:
        return ["path", "query", "cache_all_timelines"]

    def study_cls(self) -> Type[BaseData]:
        from . import algonauts  # noqa: F401  (registers the study)

        return _STUDIES[self.study]

    def iter_timelines(self) -> Iterator[BaseData]:
        if self._timelines is None:
            self._timelines = list(self.study_cls().iter_timelines(self.path))
        else:
            # refresh the registry: a fresh process (or cleared registry)
            # must still resolve method: URIs
            TIMELINES.update({tl.timeline: tl for tl in self._timelines})
        return iter(self._timelines)

    def study_summary(self, apply_query: bool = True) -> pd.DataFrame:
        """One row per timeline with subject/timeline indices, optionally
        narrowed by the configured pandas query."""
        summary = pd.DataFrame([dict(tl) for tl in self.iter_timelines()])
        summary["subject"] = self.study + "/" + summary.subject.astype(str)
        clashes = {"subject_index", "timeline_index"} & set(summary.columns)
        if clashes:
            raise RuntimeError(f"Study dataframes may not contain {clashes}")
        by_subject = summary.groupby("subject")
        summary = summary.assign(
            subject_index=by_subject.ngroup(),
            subject_timeline_index=by_subject.cumcount(),
            timeline_index=summary.index,
        )
        if apply_query and self.query is not None:
            summary = summary.query(self.query)
        return summary

    def _store(self) -> Optional[FrameStore]:
        if self.infra.folder is None:
            return None
        uid = config_uid(self, version=self.infra.version)
        store = FrameStore(Path(self.infra.folder) / uid / "events")
        if self.infra.mode == "force":
            store.clear()
        return store

    def _selected_timelines(self) -> List[BaseData]:
        timelines = list(self.iter_timelines())
        if self.query is None:
            return timelines
        # study_summary applies the configured query; the surviving rows'
        # (preserved) positional index selects the timelines
        return [timelines[i] for i in self.study_summary().index]

    def _load_one(self, tl: BaseData, store: Optional[FrameStore]) -> pd.DataFrame:
        TIMELINES[tl.timeline] = tl
        if store is not None and tl.timeline in store:
            return store[tl.timeline]
        frame = tl.load()
        frame.subject = f"{self.study}/{tl.subject}"
        # cache_all_timelines=False keeps only the final enhanced frame on
        # disk (saves space when raw per-timeline loads are cheap)
        if store is not None and self.cache_all_timelines:
            store[tl.timeline] = frame
        return frame

    def _enhancer_chain(self) -> List[Enhancer]:
        if isinstance(self.enhancers, dict):
            return list(self.enhancers.values())
        return list(self.enhancers)

    def build(self) -> pd.DataFrame:
        """Discover timelines, load+cache raw events, run enhancers."""
        selected = self._selected_timelines()
        if not selected:
            raise RuntimeError(f"No timeline found for {self.study} ({self.query=})")
        store = self._store()

        # the enhanced result is cached keyed by the query (enhancer config
        # is already part of the store uid)
        final_key = f"built-{self.query}"
        if store is not None and final_key in store:
            return validate_events(store[final_key])

        events = pd.concat(
            [self._load_one(tl, store) for tl in selected]
        ).reset_index(drop=True)
        for enhancer in self._enhancer_chain():
            events = enhancer(events)
        events = validate_events(events)
        if store is not None:
            store[final_key] = events
        return events
