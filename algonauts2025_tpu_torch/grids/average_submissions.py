"""Ensemble submission averaging (the port's copy of the JAX package's).

Behavioral spec from reference grids/average_submissions.py, re-derived:
load every per-run submission zip under a grid folder, optionally keep the
k most diverse predictors (greedy on the prediction correlation matrix),
and write a weighted-average submission.  Pure NumPy host-side
post-processing.

Deliberate divergence from the reference: with ``per_voxel_weights`` the
per-voxel pearson softmax is taken over *runs* (axis 0), so the weights of
the contributing runs sum to 1 at every voxel.  The reference softmaxes
over voxels (dim=1), which does not produce convex per-voxel combinations
— the weighted sum there is scaled by an arbitrary per-run constant.  We
keep the sensible normalization and note the difference here.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import typing as tp
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pandas as pd

logger = logging.getLogger(__name__)

__all__ = ["average_submissions", "select_diverse_subset", "get_k_most_diverse_indices"]

#: submission payload: subject -> chunk -> (time, voxels) predictions
Predictions = tp.Dict[str, tp.Dict[str, np.ndarray]]


@dataclasses.dataclass
class RunArtifacts:
    """Everything one grid run contributes to the ensemble."""

    predictions: Predictions
    metrics: pd.DataFrame
    pearson: tp.Optional[np.ndarray]  # per-voxel validation r

    @property
    def has_score(self) -> bool:
        return "val/pearson" in self.metrics.columns and len(self.metrics) > 0

    @property
    def score(self) -> float:
        return float(self.metrics["val/pearson"].item())


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    shifted = np.exp(x - x.max(axis=axis, keepdims=True))
    return shifted / shifted.sum(axis=axis, keepdims=True)


def select_diverse_subset(corr: np.ndarray, k: int) -> list[int]:
    """Greedy min-total-|corr| selection of k indices."""
    if k > corr.shape[0]:
        raise ValueError(f"cannot pick {k} diverse runs out of {corr.shape[0]}")
    chosen = [int(np.argmin(np.abs(corr).sum(axis=0)))]
    while len(chosen) < k:
        cost = np.abs(corr[:, chosen]).sum(axis=1)
        cost[chosen] = np.inf
        chosen.append(int(np.argmin(cost)))
    return chosen


def _stack_runs(predictions: tp.List[Predictions]) -> np.ndarray:
    """(n_runs, flat) matrix over the first subject's chunks."""
    first_subject = next(iter(predictions[0]))
    blocks = [
        np.array([run[first_subject][chunk] for run in predictions])
        for chunk in predictions[0][first_subject]
    ]
    return np.concatenate(blocks, axis=1).reshape(len(predictions), -1)


def get_k_most_diverse_indices(predictions: tp.List[Predictions], k: int) -> np.ndarray:
    corr = np.corrcoef(_stack_runs(predictions))
    return np.array(select_diverse_subset(corr, k))


def _read_run(submission_zip: str) -> tp.Optional[RunArtifacts]:
    folder = Path(submission_zip).parent
    try:
        with zipfile.ZipFile(submission_zip) as zf:
            member = zf.namelist()[0]
            with zf.open(member) as fh:
                predictions = np.load(fh, allow_pickle=True).item()
    except Exception:
        logger.warning("Error loading submission from %s", submission_zip)
        return None
    # sidecar artifacts are best-effort: a partially-written run folder
    # (corrupt metrics.csv, missing pearson.npy) must degrade to a skipped
    # or unweighted run, never abort the whole ensemble
    try:
        metrics = pd.read_csv(folder / "metrics.csv")
    except Exception:
        logger.warning("Error loading metrics.csv from %s", folder)
        metrics = pd.DataFrame()
    pearson_file = folder / "pearson.npy"
    pearson = None
    if pearson_file.exists():
        try:
            pearson = np.load(pearson_file)
        except Exception:
            logger.warning("Error loading pearson.npy from %s", folder)
    return RunArtifacts(
        predictions=predictions,
        metrics=metrics,
        pearson=pearson,
    )


def _discover(grid_path: Path, max_runs: tp.Optional[int]) -> tp.List[str]:
    found: tp.List[str] = []
    for child in sorted(os.listdir(grid_path)):
        candidate = grid_path / child / "submission.zip"
        if candidate.exists():
            found.append(str(candidate))
        if max_runs is not None and len(found) >= max_runs:
            break
    return found


def _ensemble_weights(
    runs: tp.List[RunArtifacts], per_voxel: bool, temperature: float
) -> np.ndarray:
    """(n_runs, 1, 1) scalar or (n_runs, 1, n_voxels) per-voxel weights,
    broadcastable against stacked (n_runs, time, voxels) predictions."""
    if per_voxel:
        missing = [i for i, r in enumerate(runs) if r.pearson is None]
        if missing:
            raise ValueError(
                f"per_voxel_weights needs pearson.npy for every run; runs "
                f"{missing} have none (test_only runs skip the val pass "
                "that writes it) — drop them or use score weighting"
            )
        stacked = np.stack([r.pearson for r in runs]) / temperature
        return _softmax(stacked, axis=0)[:, None, :]
    scores = np.array([r.score for r in runs])
    return _softmax(scores / temperature)[:, None, None]


def average_submissions(
    grid_path: Path,
    weigh_by_score: bool = False,
    per_voxel_weights: bool = False,
    temperature: float = 1.0,
    max_runs: int | None = None,
    k_most_diverse: int | None = None,
) -> Path:
    """Combine all run submissions under ``grid_path`` into one zip."""
    grid_path = Path(grid_path)
    if per_voxel_weights and not weigh_by_score:
        # reference parity: weights are only applied under weigh_by_score
        # (reference average_submissions.py:121-125 computes but ignores
        # them otherwise) — keep the behavior, but say so out loud
        logger.warning(
            "per_voxel_weights=True has no effect without "
            "weigh_by_score=True: predictions are plain-averaged"
        )
    paths = _discover(grid_path, max_runs)
    logger.info("Found %d submissions", len(paths))
    if not paths:
        raise RuntimeError(f"No submissions under {grid_path}")

    with ThreadPoolExecutor(max_workers=10) as pool:
        loaded = list(zip(paths, pool.map(_read_run, paths)))
    loaded = [(p, r) for p, r in loaded if r is not None]
    if not loaded:
        raise RuntimeError(
            f"All {len(paths)} submission zips under {grid_path} failed to "
            "load (see warnings above)"
        )
    if weigh_by_score and not per_voxel_weights:
        # the degrade-never-abort contract (_read_run): a run whose
        # metrics.csv was corrupt has no score — SKIP it loudly rather than
        # crash the whole ensemble on one partially-written folder
        scoreless = [p for p, r in loaded if not r.has_score]
        if scoreless:
            logger.warning(
                "Dropping %d run(s) with unreadable/missing val/pearson "
                "from the score-weighted ensemble: %s",
                len(scoreless), scoreless,
            )
            loaded = [(p, r) for p, r in loaded if r.has_score]
        if not loaded:
            raise RuntimeError(
                "weigh_by_score=True but no run has a readable val/pearson"
            )
    runs = [r for _p, r in loaded]

    if k_most_diverse is not None:
        picked = get_k_most_diverse_indices([r.predictions for r in runs],
                                            k_most_diverse)
        runs = [runs[i] for i in picked]

    weights = None
    if weigh_by_score:
        weights = _ensemble_weights(runs, per_voxel_weights, temperature)

    combined: tp.Dict[str, tp.Dict[str, np.ndarray]] = {}
    reference_run = runs[0].predictions
    for subject, chunks in reference_run.items():
        combined[subject] = {}
        for chunk in chunks:
            stacked = np.array([r.predictions[subject][chunk] for r in runs])
            if weights is None:
                combined[subject][chunk] = stacked.mean(axis=0)
            else:
                combined[subject][chunk] = (stacked * weights).sum(axis=0)

    out_path = grid_path / "submission.npy"
    np.save(out_path, combined)  # type: ignore[arg-type]
    with zipfile.ZipFile(out_path.with_suffix(".zip"), "w") as zipf:
        zipf.write(out_path, arcname=out_path.name)
    logger.info("Saved average submission to %s", out_path.with_suffix(".zip"))
    return out_path.with_suffix(".zip")


if __name__ == "__main__":
    from .defaults import SAVEDIR

    average_submissions(
        grid_path=Path(SAVEDIR) / "model_soup",
        weigh_by_score=True,
        per_voxel_weights=True,
        temperature=0.3,
    )
