"""Config-driven event-DataFrame transforms (enhancer pipeline).

Behavioral spec from reference data_utils/data_utils/enhancers.py,
re-derived: a discriminated union of pydantic transforms applied in
sequence by the StudyLoader.  All host-side preprocessing; results are
cached upstream by the study cache.

Implementation notes (this rebuild): sentence grouping is a vectorized
boundary scan over word columns (the reference walks rows one by one);
the registry builds its discriminated-union adapter lazily; audio is
demuxed with the ffmpeg binary instead of moviepy.
"""

from __future__ import annotations

import contextlib
import logging
import os
from pathlib import Path
from typing import (
    Any,
    ClassVar,
    Dict,
    List,
    Literal,
    Optional,
    Sequence,
    Set,
    Tuple,
    Union,
)

import numpy as np
import pandas as pd
import pydantic
from typing_extensions import Annotated

from ..core import events as ev
from ..core.segments import find_enclosed
from ..core.splitting import DeterministicSplitter, chunk_events
from . import text_match

logger = logging.getLogger(__name__)

MISSING_SENTENCE = "# MISSING SENTENCE #"

_WORD_TYPES = "Word"


class BaseEnhancer(pydantic.BaseModel):
    """Registry base: subclasses declare ``name: Literal['X'] = 'X'`` and
    become addressable through ``BaseEnhancer.model_validate({"name": "X"})``."""

    model_config = pydantic.ConfigDict(extra="forbid")
    name: str

    _REGISTRY: ClassVar[Dict[str, type]] = {}
    _ADAPTER: ClassVar[Optional[pydantic.TypeAdapter]] = None

    @classmethod
    def __pydantic_init_subclass__(cls, **kwargs: Any) -> None:
        super().__pydantic_init_subclass__(**kwargs)
        label = cls.__name__
        if "Base" in label or label.startswith("_"):
            return
        spec = cls.model_fields.get("name")
        if spec is None or spec.default != label:
            raise NotImplementedError(
                f"Enhancer {label} needs: name: Literal[{label!r}] = {label!r}"
            )
        BaseEnhancer._REGISTRY[label] = cls
        BaseEnhancer._ADAPTER = None  # rebuilt on next dispatch

    @classmethod
    def _dispatch_adapter(cls) -> pydantic.TypeAdapter:
        if BaseEnhancer._ADAPTER is None:
            union = Union[tuple(BaseEnhancer._REGISTRY.values())]  # type: ignore[valid-type]
            BaseEnhancer._ADAPTER = pydantic.TypeAdapter(
                Annotated[union, pydantic.Field(discriminator="name")]
            )
        return BaseEnhancer._ADAPTER

    @pydantic.model_validator(mode="wrap")
    @classmethod
    def _parse_into_subclass(
        cls, value: Any, handler: pydantic.ValidatorFunctionWrapHandler
    ) -> "BaseEnhancer":
        if cls is not BaseEnhancer:
            return handler(value)
        return cls._dispatch_adapter().validate_python(value)

    def __call__(self, events: pd.DataFrame) -> pd.DataFrame:
        raise NotImplementedError


Enhancer = BaseEnhancer
EnhancerConfig = BaseEnhancer


def _word_mask(events: pd.DataFrame) -> pd.Series:
    return events.type.isin(ev.EventTypesHelper(_WORD_TYPES).names)


def _invalid_sentence(values: Sequence[Any]) -> List[bool]:
    return [not (isinstance(s, str) and s) for s in values]


class AddText(BaseEnhancer):
    """Concatenate Word events into one re-punctuated Text per timeline."""

    name: Literal["AddText"] = "AddText"

    @staticmethod
    def _punctuate(raw: str) -> str:
        parts = text_match.split_sentences(raw)
        return ". ".join(p.text.strip().capitalize().rstrip(".") for p in parts)

    def __call__(self, events: pd.DataFrame) -> pd.DataFrame:
        if "Text" in events.type.unique():
            logger.info("Text already present in events dataframe, skipping")
            return events
        fresh = []
        for _, group in events.groupby("timeline"):
            words = group.loc[group.type == "Word"]
            if not len(words):
                continue
            first = words.start.min()
            last = (words.start + words.duration).max()
            row = words.iloc[0].to_dict()
            row.update(
                type="Text",
                start=first,
                duration=last - first,
                timeline=group.timeline.iloc[0],
                text=self._punctuate(" ".join(words.text.to_list())),
            )
            fresh.append(row)
        return pd.concat([events, pd.DataFrame(fresh)], ignore_index=True)


class AddTextToWords(AddText):
    """Alias of AddText kept for config compatibility (reference
    enhancers.py:115-116)."""

    name: Literal["AddTextToWords"] = "AddTextToWords"  # type: ignore[assignment]


def _sentence_groups(words: pd.DataFrame) -> np.ndarray:
    """Group id per word row: a new group starts at a timeline change, a
    sentence-text change, or a non-increasing sentence_char.  The final row
    never opens a group of its own (reference loop quirk: the last word is
    appended to ``words`` before the boundary checks, so it compares with
    itself and is absorbed into the previous sentence — EVEN ACROSS A
    TIMELINE BOUNDARY, where the resulting cross-timeline Sentence can have
    a negative duration and raise ValidationError; verified byte-identical
    to the reference on both the corrupt-sentence and raising variants,
    tests/test_reference_oracle.py)."""
    n = len(words)
    timelines = words.timeline.to_numpy()
    starts = words.start.to_numpy()
    sentences = words.sentence.to_numpy(dtype=object)
    chars = pd.to_numeric(words.sentence_char, errors="coerce").to_numpy(dtype=float)

    same_timeline = timelines[1:] == timelines[:-1]
    if np.any(same_timeline & (starts[1:] < starts[:-1])):
        raise ValueError("Words are not sorted within a timeline")

    opens = np.zeros(n, dtype=bool)
    opens[0] = True
    if n > 1:
        changed = ~same_timeline
        changed |= np.array(
            [sentences[i] != sentences[i - 1] for i in range(1, n)]
        )
        both_known = ~np.isnan(chars[1:]) & ~np.isnan(chars[:-1])
        changed |= both_known & (chars[1:] <= chars[:-1])
        opens[1:] = changed
        opens[-1] = False
    return np.cumsum(opens)


def _extract_sentences(events: pd.DataFrame) -> List[ev.Sentence]:
    """Group annotated words into Sentence events (vectorized equivalent of
    reference enhancers.py:205-245)."""
    words = events.loc[_word_mask(events), :]
    if not len(words):
        return []
    eps = 1e-6
    groups = _sentence_groups(words)
    out: List[ev.Sentence] = []
    starts = words.start.to_numpy()
    stops = starts + words.duration.to_numpy()
    sentences = words.sentence.to_numpy(dtype=object)
    timelines = words.timeline.to_numpy()
    for gid in np.unique(groups):
        member = np.flatnonzero(groups == gid)
        a, b = member[0], member[-1]
        label = sentences[a]
        if not (isinstance(label, str) and label):
            label = MISSING_SENTENCE
        out.append(
            ev.Sentence(
                start=starts[a] - eps,
                duration=stops[b] - starts[a] + 2 * eps,
                timeline=timelines[a],
                text=label,
            )
        )
    return out


class AddSentenceToWords(BaseEnhancer):
    """Fuzzy-align Words to the Text transcript; annotate sentence spans."""

    name: Literal["AddSentenceToWords"] = "AddSentenceToWords"
    max_unmatched_ratio: float = 0.0
    override_sentences: bool = False

    def model_post_init(self, context: object) -> None:
        super().model_post_init(context)
        if not 0 <= self.max_unmatched_ratio < 1:
            raise ValueError("max_unmatched_ratio must be >=0 and <1")

    def _check_unmatched(self, events: pd.DataFrame) -> None:
        words = events.loc[_word_mask(events), :]
        if not len(words):
            return
        bad = sum(_invalid_sentence(words.sentence))
        ratio = bad / len(words)
        if ratio > self.max_unmatched_ratio:
            raise RuntimeError(
                f"Ratio of unmatched words is {ratio:.4f} on {len(words)} words "
                f"while max_unmatched_ratio={self.max_unmatched_ratio}"
            )

    def _annotate_one_timeline(self, events: pd.DataFrame) -> pd.DataFrame:
        contexts = events.loc[events.type == "Text"]
        events = events.copy(deep=True)
        word_rows = _word_mask(events)
        events.loc[:, "sentence_char"] = np.nan
        events["sentence"] = pd.Series("", index=events.index, dtype=object)

        harvested: List[Dict[str, Any]] = []
        seen_spans: Set[tuple] = set()
        for context in contexts.itertuples():
            enclosed = find_enclosed(
                events, start=context.start, duration=context.duration
            )
            inside = events.loc[enclosed]
            sel = inside.index[inside.type.isin(ev.EventTypesHelper(_WORD_TYPES).names)]
            if not len(sel):
                raise ValueError("No word overlapping with context")
            language = getattr(context, "language", None)
            if not isinstance(language, str):
                raise ValueError(f"Need language for Text field {context}")
            matched = pd.DataFrame(
                text_match.match_text_words(
                    context.text, events.loc[sel].text.tolist(), language=language
                ),
                index=sel,
            )
            events.loc[sel, matched.columns] = matched
            subject = getattr(context, "subject", None)
            # _extract_sentences re-reads ALL annotated words, so with
            # several Text contexts per timeline earlier contexts' sentences
            # reappear; keep each span once (the reference duplicates them
            # quadratically — deliberate divergence)
            for sentence in _extract_sentences(events):
                span = (sentence.timeline, sentence.start, sentence.text)
                if span in seen_spans:
                    continue
                seen_spans.add(span)
                record = sentence.to_dict()
                if subject is not None:
                    record["subject"] = subject
                harvested.append(record)
        keep = [r for r in harvested if r["text"] != MISSING_SENTENCE]
        return pd.concat([events, pd.DataFrame(keep)], ignore_index=True)

    def __call__(self, events: pd.DataFrame) -> pd.DataFrame:
        if "Sentence" in events.type.unique():
            if not self.override_sentences:
                logger.warning("Sentence already present in events dataframe")
                return events
            events = events[events.type != "Sentence"]
        if "timeline" in events.columns and events.timeline.nunique() > 1:
            parts = [
                self(group) for _, group in events.groupby("timeline", sort=False)
            ]
            return pd.concat(parts, ignore_index=True)
        annotated = self._annotate_one_timeline(events).reset_index(drop=True)
        self._check_unmatched(annotated)
        return annotated


def _merge_sentences(
    sentences: List[ev.Sentence],
    min_duration: Optional[float] = None,
    min_words: Optional[int] = None,
) -> List[List[ev.Sentence]]:
    """Greedily coalesce consecutive sentences until each bucket reaches the
    duration/word-count floor; a timeline change always opens a bucket."""
    buckets: List[List[ev.Sentence]] = []
    for sentence in sentences:
        if not buckets:
            buckets.append([sentence])
            continue
        head, tail = buckets[-1][0], buckets[-1][-1]
        ripe = True
        if min_duration is not None:
            ripe &= sentence.start - head.start >= min_duration
        if min_words is not None:
            ripe &= sum(len(s.text.split()) for s in buckets[-1]) >= min_words
        if ripe or tail.timeline != sentence.timeline:
            buckets.append([sentence])
        else:
            buckets[-1].append(sentence)
    return buckets


class AssignSentenceSplit(BaseEnhancer):
    """Deterministically split sentence groups into train/val/test."""

    name: Literal["AssignSentenceSplit"] = "AssignSentenceSplit"
    min_duration: Optional[float] = None
    min_words: Optional[int] = None
    ratios: Tuple[float, float, float] = (0.8, 0.1, 0.1)
    seed: int = 0
    max_unmatched_ratio: float = 0.0

    def model_post_init(self, context: object) -> None:
        super().model_post_init(context)
        if sum(self.ratios) != 1:
            raise ValueError("Split ratios must sum to 1")

    def _assignments(self, merged: List[List[ev.Sentence]]) -> Dict[Any, Any]:
        """Map each sentence text to a split; sentences whose merged groups
        disagree become "undefined" (they leak across splits otherwise)."""
        live = {k: v for k, v in zip(("train", "val", "test"), self.ratios) if v > 0}
        splitter = DeterministicSplitter(live, seed=self.seed)
        verdicts: Dict[Any, Any] = {MISSING_SENTENCE: "undefined"}
        seen_groups: Dict[str, Set[str]] = {}
        for bucket in merged:
            key = "".join(s.text for s in bucket)
            if key not in verdicts:
                verdicts[key] = splitter(key)
            for sentence in bucket:
                seen_groups.setdefault(sentence.text, set()).add(key)
                if verdicts.setdefault(sentence.text, verdicts[key]) != verdicts[key]:
                    verdicts[sentence.text] = "undefined"
                    logger.warning(
                        "Sequence split %r set to undefined (conflicting groups: %s)",
                        sentence.text,
                        seen_groups[sentence.text],
                    )
        return verdicts

    def __call__(self, events: pd.DataFrame) -> pd.DataFrame:
        synthetic_timeline = "timeline" not in events.columns
        if synthetic_timeline:
            events["timeline"] = "#foo#"
        word_rows = _word_mask(events)
        words = events.loc[word_rows, :]
        if not len(words):
            # nothing to split (audio/video-only study) — remove the
            # synthetic timeline column injected above IN PLACE, or the
            # caller's frame permanently grows a bogus '#foo#' column
            # (the injection above mutated it in place too; r4 review)
            if synthetic_timeline:
                events.drop(columns=["timeline"], inplace=True)
            return events
        bad_ratio = sum(_invalid_sentence(words.sentence)) / len(words)
        if bad_ratio > self.max_unmatched_ratio:
            raise RuntimeError(
                f"Ratio of words with no sentence match is {bad_ratio:.2f} "
                f"while max_unmatched_ratio={self.max_unmatched_ratio}"
            )
        live = [r for r in self.ratios if r > 0]
        if len(live) == 1:
            only = ("train", "val", "test")[list(self.ratios).index(live[0])]
            events.loc[word_rows, "split"] = only
        else:
            merged = _merge_sentences(
                _extract_sentences(events),
                min_duration=self.min_duration,
                min_words=self.min_words,
            )
            verdicts = self._assignments(merged)
            has_sentence = ~(events.sentence.isnull() | (events.sentence == ""))
            # a sentence text can miss a verdict: the final word of a
            # timeline never opens a group (extraction quirk), so a
            # trailing one-word sentence has no Sentence event.  Assign
            # "undefined" instead of crashing (the reference KeyErrors here)
            events.loc[has_sentence, "split"] = [
                verdicts.get(str(s), "undefined")
                for s in events.loc[has_sentence].sentence
            ]
            events.loc[~has_sentence & word_rows, "split"] = "undefined"
        if synthetic_timeline and tuple(events.timeline.unique()) == ("#foo#",):
            # in place, matching the in-place injection above: the
            # CALLER's frame must not keep the synthetic column either
            events.drop(columns=["timeline"], inplace=True)
        return events


class _ContextState:
    """Rolling left-context accumulator shared across words of a timeline."""

    def __init__(self, keep_full_history: bool) -> None:
        self.keep_full_history = keep_full_history
        self.history: List[str] = []
        self.last: Any = None

    def flush(self) -> None:
        self.history = []

    def advance(self, word: Any, split_field: str) -> None:
        """Update history given the transition last -> word."""
        prev = self.last
        if prev is None:
            return
        if word.sentence != prev.sentence:
            wc, lc = word.sentence_char, prev.sentence_char
            if not (pd.isna(wc) or pd.isna(lc)) and wc <= lc:
                if self.keep_full_history:
                    self.history.append(prev.sentence)
                if split_field and getattr(prev, split_field, "") != getattr(
                    word, split_field, ""
                ):
                    self.flush()
        if prev.timeline != word.timeline:
            self.flush()
        elif word.start < prev.start:
            raise ValueError(
                f"Words are not in increasing order ({word} after {prev})"
            )


class AddContextToWords(BaseEnhancer):
    """Rolling left context for each word (caps at max_context_len words)."""

    name: Literal["AddContextToWords"] = "AddContextToWords"
    sentence_only: bool = True
    max_context_len: Optional[int] = None
    split_field: str = "split"

    def __call__(self, events: pd.DataFrame) -> pd.DataFrame:
        if hasattr(events, "context"):
            events.context = events.context.fillna("").astype(str)
        word_rows = _word_mask(events)
        words = events.loc[word_rows, :]
        sfield = self.split_field
        if sfield and sfield not in words.columns:
            raise ValueError(f"split_field {sfield!r} is not part of dataframe columns")

        state = _ContextState(keep_full_history=not self.sentence_only)
        contexts: List[str] = []
        for word in words.itertuples(index=False):
            sent = word.sentence
            if not (isinstance(sent, str) and sent):
                if sfield and state.last is not None:
                    if getattr(state.last, sfield, "") != getattr(word, sfield, ""):
                        state.flush()
                contexts.append("")
                state.last = None
                continue
            state.advance(word, sfield)
            if word.sentence_char is None or np.isnan(word.sentence_char):
                contexts.append("")
                continue
            state.last = word
            upto = int(float(word.sentence_char) + len(word.text))
            rolling = "".join(state.history) + word.sentence[:upto]
            if self.max_context_len is not None:
                rolling = " ".join(rolling.split(" ")[-self.max_context_len - 1 :])
            contexts.append(rolling)
        events.loc[word_rows, "context"] = contexts
        return events


class RemoveMissing(BaseEnhancer):
    """Drop events whose ``field`` is null/empty."""

    name: Literal["RemoveMissing"] = "RemoveMissing"
    event_types: Union[str, Sequence[str]] = "Word"
    field: str = "context"

    def __call__(self, events: pd.DataFrame) -> pd.DataFrame:
        if self.field not in events.columns:
            logger.warning("Field %s not in events dataframe, skipping", self.field)
            return events
        affected = events.type.isin(ev.EventTypesHelper(self.event_types).names)
        column = events.loc[:, self.field]
        empty = column.isnull() | (column == "")
        return events.loc[~(affected & empty)]


class ChunkEvents(BaseEnhancer):
    name: Literal["ChunkEvents"] = "ChunkEvents"
    event_type_to_chunk: Literal["Sound", "Video"]
    event_type_to_use: Optional[str] = None
    min_duration: Optional[float] = None
    max_duration: float = np.inf

    def __call__(self, events: pd.DataFrame) -> pd.DataFrame:
        return chunk_events(
            events,
            self.event_type_to_chunk,
            self.event_type_to_use,
            self.min_duration,
            self.max_duration,
        )


def _demux_audio(video_path: Path, wav_path: Path) -> bool:
    """Demux a video's audio track to WAV via the ffmpeg binary."""
    import shutil
    import subprocess

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        return False
    # demux to a temp sibling, then atomically rename: an interrupted
    # ffmpeg must never leave a partial wav at the final path, where every
    # later run would trust it and cache garbage audio features under the
    # normal uid (r4 review)
    tmp_path = wav_path.with_suffix(f".tmp{os.getpid()}.wav")
    argv = [ffmpeg, "-y", "-i", str(video_path), "-vn", "-acodec", "pcm_s16le",
            str(tmp_path)]
    try:
        subprocess.run(argv, check=True, capture_output=True)
    except subprocess.CalledProcessError:
        with contextlib.suppress(FileNotFoundError):
            tmp_path.unlink()
        return False
    if not tmp_path.exists():
        return False
    os.replace(tmp_path, wav_path)
    return True


class ExtractAudioFromVideo(BaseEnhancer):
    """Create Sound events for each Video's audio track.

    A ``.wav`` sibling of the video is used directly when present;
    otherwise the audio is demuxed via the ffmpeg binary when available.
    (The reference used moviepy for the same job, enhancers.py:430-459.)
    """

    name: Literal["ExtractAudioFromVideo"] = "ExtractAudioFromVideo"

    def __call__(self, events: pd.DataFrame) -> pd.DataFrame:
        videos = events.loc[events.type == "Video"]
        if not len(videos):
            return events
        soundtracks = []
        for record in videos.to_dict(orient="records"):
            wav_path = Path(record["filepath"]).with_suffix(".wav")
            if not wav_path.exists() and not _demux_audio(
                Path(record["filepath"]), wav_path
            ):
                logger.warning(
                    "No audio available for %s (no .wav sibling, no ffmpeg)",
                    record["filepath"],
                )
                continue
            track = dict(record)
            track.update(type="Sound", filepath=str(wav_path), frequency=pd.NA)
            soundtracks.append(track)
        out = pd.concat([events, pd.DataFrame(soundtracks)], ignore_index=True)
        return out.reset_index(drop=True)
