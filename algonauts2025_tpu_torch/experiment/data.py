"""Data assembly: study + features -> per-split datasets.

Rebuild of reference algonauts2025/main.py:63-203 (class Data): builds the
event table, assigns the 90/10 chunk-level train/val split with the
deterministic hash splitter, prepares features (bulk backbone inference
into caches) and cuts per-split SegmentDatasets with static pad_duration.
"""

from __future__ import annotations

import logging
import typing as tp

import pandas as pd
import pydantic

from ..core.events import EventTypesHelper
from ..core.segments import WINDOW_SECONDS, iter_segments
from ..core.splitting import DeterministicSplitter
from ..data.dataset import SegmentDataset
from ..data.helpers import prepare_features
from ..data.study import StudyLoader
from ..features.audio import Wav2VecBert
from ..features.neuro import Fmri
from ..features.subject import SubjectEncoder
from ..features.text import LLAMA3p2
from ..features.video import VJEPA2

logger = logging.getLogger(__name__)

__all__ = ["Data"]

FEATURE_EVENT_TYPES = {
    "text": "Word",
    "audio": "Sound",
    "video": "Video",
    "fmri": "Fmri",
    "subject_id": "Event",
}


class Data(pydantic.BaseModel):
    """Configuration and creation of per-split datasets."""

    model_config = pydantic.ConfigDict(extra="forbid")

    study: StudyLoader
    neuro: Fmri
    text_feature: tp.Optional[LLAMA3p2] = None
    audio_feature: tp.Optional[Wav2VecBert] = None
    video_feature: tp.Optional[VJEPA2] = None
    layers: list[float] | None = None
    layer_aggregation: tp.Literal["group_mean"] | None = None
    num_workers: int = 0
    batch_size: int = 16
    #: drop the final partial TRAIN batch each epoch.  Default False =
    #: reference parity (torch DataLoader drop_last=False trains the tail
    #: batch at a smaller B).  Val/test always keep every sample
    #: (evaluation must be exact).
    drop_last: bool = False
    pad_duration: float | None = WINDOW_SECONDS

    _subject_encoder: SubjectEncoder = pydantic.PrivateAttr(default=None)

    def model_post_init(self, _ctx: tp.Any) -> None:
        super().model_post_init(_ctx)
        for modality in ["text", "audio", "video"]:
            feature = getattr(self, f"{modality}_feature")
            if feature is None:
                continue
            if self.layers is not None:
                feature.layers = self.layers
            if self.layer_aggregation is not None:
                feature.layer_aggregation = self.layer_aggregation

    def get_events(self) -> pd.DataFrame:
        events = self.study.build()
        if "split" not in events.columns:
            events["split"] = "train"
        train_sel = events.split == "train"
        splitter = DeterministicSplitter(ratios={"train": 1 - 0.1, "val": 0.1})
        values = events.loc[train_sel]["chunk"].unique()
        splits = [splitter(value) for value in values]
        if splits and "val" not in splits:
            splits[-1] = "val"  # guarantee a val split
        events.loc[train_sel, "split"] = events.loc[train_sel]["chunk"].map(
            dict(zip(values, splits))
        )
        unassigned = events[events.split.isna()]
        if len(unassigned) > 0:
            critical = {"Fmri", "Text", "Sound", "Video", "Word"}
            if critical & set(unassigned.type.unique()):
                raise ValueError(
                    f"Events without split: {unassigned.type.unique()}"
                )
            logger.warning(
                "Events without split (ignored): %s", unassigned.type.unique()
            )
        return events

    def build_features(self, events: pd.DataFrame) -> dict[str, tp.Any]:
        features: dict[str, tp.Any] = {}
        for modality in ["text", "audio", "video"]:
            feature = getattr(self, f"{modality}_feature")
            if feature is not None:
                features[modality] = feature
        if "Fmri" in events.type.unique():
            features["fmri"] = self.neuro
        self._subject_encoder = SubjectEncoder()
        features["subject_id"] = self._subject_encoder

        to_remove = set()
        for name, feature in features.items():
            event_types = EventTypesHelper(FEATURE_EVENT_TYPES[name]).names
            if not any(t in events.type.unique() for t in event_types):
                to_remove.add(name)
        for name in to_remove:
            del features[name]
            logger.warning("Removing feature %s (no corresponding events)", name)
        return features

    @property
    def n_subjects(self) -> int:
        summary = self.study.study_summary()
        return summary.subject.nunique()

    def get_datasets(
        self,
        events: pd.DataFrame | None = None,
        splits: tp.Sequence[str] | None = None,
    ) -> dict[str, SegmentDataset]:
        if events is None:
            events = self.get_events()
        features = self.build_features(events)
        prepare_features(features, events)

        out: dict[str, SegmentDataset] = {}
        for split in splits or ["train", "val", "test"]:
            if split == "all":
                sel = pd.Series([True] * len(events), index=events.index)
            else:
                sel = events.split == split
            if not sel.any():
                logger.warning("No events found for split %s", split)
                continue
            segments = list(iter_segments(events[sel]))
            out[split] = SegmentDataset(
                features=features,
                segments=segments,
                pad_duration=self.pad_duration,
            )
        return out

    def get_loaders(
        self,
        events: pd.DataFrame | None = None,
        split_to_build: tp.Union[str, tp.Sequence[str], None] = None,
    ) -> dict[str, tp.Any]:
        """Reference-API convenience (main.py:124-203): per-split re-iterable
        batch sources instead of torch DataLoaders."""
        if isinstance(split_to_build, str):
            splits: tp.Sequence[str] | None = [split_to_build]
        else:
            splits = split_to_build
        datasets = self.get_datasets(events, splits=splits)
        return {
            split: ds.build_dataloader(
                batch_size=self.batch_size,
                shuffle=split == "train",
                num_workers=self.num_workers,
            )
            for split, ds in datasets.items()
        }

    def recut_segments(
        self, dataset: SegmentDataset, events: pd.DataFrame, jitter: float
    ) -> None:
        """Re-cut a dataset's windows with a start jitter (JitterWindows
        semantics, reference callbacks.py:16-44)."""
        dataset.segments = list(iter_segments(events, start_jitter=jitter))

