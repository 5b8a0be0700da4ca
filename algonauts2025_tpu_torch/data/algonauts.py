"""Algonauts 2025 dataset adapter.

Behavioral spec from reference data_utils/data_utils/studies/
algonauts2025.py, re-derived: enumerates Friends s1-s7 (a-d chunks) +
movie10 timelines for sub-01/02/03/05, turns TSV transcripts into Word
events, the .mkv movie into a Video event and the per-subject HDF5 BOLD
into an Fmri event (TR 1.49 s, Schaefer-1000).  Friends season 7 is the
held-out test split.

Differences from the reference (deliberate):
- fMRI payloads are plain (parcels, time) float32 arrays (no nibabel).
- The Video event is only added when the movie file exists, so text/audio
  pipelines run on partial mirrors of the dataset.

Implementation notes (this rebuild): timeline enumeration is a declarative
candidate table filtered by on-disk presence; transcripts are parsed
vectorized (literal_eval + explode) instead of row-by-row loops.
"""

from __future__ import annotations

import ast
from itertools import product
from pathlib import Path
from typing import ClassVar, Iterator, List, Literal, Optional, Tuple

import numpy as np
import pandas as pd

from .study import BaseData

TR_SECONDS = 1.49

_SUBJECTS = ("sub-01", "sub-02", "sub-03", "sub-05")
_MOVIE10_FILMS = ("bourne", "wolf", "life", "figures")
#: films recorded twice (run-1/run-2) in movie10
_TWO_RUN_FILMS = ("life", "figures")

#: timelines excluded upstream (missing/corrupt in the release)
_EXCLUDED_FRIENDS = {
    (5, 20, "a"),
    (4, 1, "a"),
    (6, 3, "a"),
    (4, 13, "b"),
    (4, 1, "b"),
}


def _friends_candidates() -> Iterator[Tuple[str, str, int]]:
    """(movie=season, chunk=eNNx, run) candidates for the friends task."""
    for season, episode, part in product(range(1, 8), range(1, 26), "abcd"):
        if (season, episode, part) not in _EXCLUDED_FRIENDS:
            yield str(season), f"e{episode:02d}{part}", 0


def _movie10_candidates() -> Iterator[Tuple[str, str, int]]:
    """(movie, chunk, run) candidates for the movie10 task."""
    for film, part, rep in product(_MOVIE10_FILMS, range(1, 18), (1, 2)):
        if rep == 1 or film in _TWO_RUN_FILMS:
            yield film, str(part), rep


class Algonauts2025(BaseData):
    task: Literal["friends", "movie10"]
    movie: str
    chunk: str
    run: int = 0

    version: ClassVar[str] = "v1"

    @classmethod
    def _iter_timelines(cls, path: str | Path) -> Iterator["Algonauts2025"]:
        candidates = {"friends": _friends_candidates, "movie10": _movie10_candidates}
        for subject in _SUBJECTS:
            for task, generate in candidates.items():
                for movie, chunk, run in generate():
                    timeline = cls(
                        path=str(path),
                        subject=subject,
                        task=task,
                        movie=movie,
                        chunk=chunk,
                        run=run,
                    )
                    if timeline._is_available():
                        yield timeline

    def _is_available(self) -> bool:
        """A timeline counts when its transcript exists and (for recorded
        splits) the BOLD file does too; the friends-s7 test split ships
        without fMRI."""
        if not self._get_transcript_filepath().exists():
            return False
        if self.task == "friends" and self._get_split() == "test":
            return True
        return self._get_fmri_filepath().exists()

    # -- on-disk layout ---------------------------------------------------
    def _root(self) -> Path:
        return Path(self.path) / "download" / "algonauts_2025.competitors"

    def _stimulus_stem(self) -> str:
        """File stem shared by transcript and movie files."""
        if self.task == "friends":
            return f"s{int(self.movie):02d}{self.chunk}"
        return f"{self.movie}{int(self.chunk):02d}"

    def _stimulus_folder(self, kind: str) -> Path:
        sub = f"s{self.movie}" if self.task == "friends" else self.movie
        return self._root() / "stimuli" / kind / self.task / sub

    def _get_transcript_filepath(self) -> Path:
        prefix = "friends_" if self.task == "friends" else "movie10_"
        return self._stimulus_folder("transcripts") / (
            prefix + self._stimulus_stem() + ".tsv"
        )

    def _get_movie_filepath(self) -> Path:
        prefix = "friends_" if self.task == "friends" else ""
        return self._stimulus_folder("movies") / (
            prefix + self._stimulus_stem() + ".mkv"
        )

    def _get_fmri_filepath(self) -> Path:
        tail = "_desc-s123456_bold.h5" if self.task == "friends" else "_bold.h5"
        name = (
            f"{self.subject}_task-{self.task}_space-MNI152NLin2009cAsym_"
            f"atlas-Schaefer18_parcel-1000Par7Net{tail}"
        )
        return self._root() / "fmri" / self.subject / "func" / name

    # -- payload loading --------------------------------------------------
    def _fmri_key(self) -> str:
        """HDF5 dataset key of this timeline's BOLD chunk."""
        if self.task == "friends":
            return f"{int(self.movie):02d}{self.chunk}"
        key = self._stimulus_stem()
        if self.movie in _TWO_RUN_FILMS:
            key = f"{key}_run-{self.run}"
        return key

    def _load_fmri(self, timeline: str = "") -> np.ndarray:
        """(parcels, time) float32 BOLD for this timeline's chunk."""
        from ..io.fmri import load_h5_key

        bold = load_h5_key(str(self._get_fmri_filepath()), self._fmri_key())
        # release stores (time, parcels); keep time last
        return np.ascontiguousarray(bold.T)

    def _get_split(self) -> str:
        is_test = self.task == "friends" and int(self.movie) == 7
        return "test" if is_test else "train"

    def _word_frame(self) -> pd.DataFrame:
        """Transcript TSV -> one row per word (vectorized parse)."""
        per_tr = pd.read_csv(self._get_transcript_filepath(), sep="\t")
        fields = {
            "words_per_tr": "text",
            "onsets_per_tr": "start",
            "durations_per_tr": "duration",
        }
        lists = per_tr[list(fields)].rename(columns=fields)
        for column in lists.columns:
            lists[column] = lists[column].apply(ast.literal_eval)
        words = lists.explode(list(fields.values()), ignore_index=True).dropna()
        if not len(words):
            return pd.DataFrame()
        words["start"] = words.start.astype(float)
        words["duration"] = words.duration.astype(float)
        words["stop"] = words.start + words.duration
        words["type"] = "Word"
        words["language"] = "english"
        return words

    def _load_events(self) -> pd.DataFrame:
        frames: List[pd.DataFrame] = []
        if self._get_split() != "test":
            bold = self._load_fmri()
            frames.append(
                pd.DataFrame(
                    [
                        dict(
                            type="Fmri",
                            filepath=f"method:_load_fmri?timeline={self.timeline}",
                            start=0,
                            frequency=1 / TR_SECONDS,
                            duration=bold.shape[-1] * TR_SECONDS,
                        )
                    ]
                )
            )
        movie_path = self._get_movie_filepath()
        if movie_path.exists():
            frames.append(
                pd.DataFrame([dict(type="Video", filepath=movie_path, start=0)])
            )
        words = self._word_frame()
        if len(words):
            frames.append(
                pd.DataFrame(
                    [
                        dict(
                            type="Text",
                            text=" ".join(words.text.to_list()),
                            start=words.start.min(),
                            duration=words.stop.max() - words.start.min(),
                            stop=words.stop.max(),
                            language="english",
                        )
                    ]
                )
            )
            frames.append(words)
        events = pd.concat(frames, ignore_index=True)
        events["split"] = self._get_split()
        events["movie"] = "movie:" + str(self.movie)
        events["chunk"] = "chunk:" + str(self.chunk)
        return events
