"""Synthetic Algonauts-layout study generator.

Writes a tiny dataset with the exact on-disk layout the Algonauts2025
adapter expects (transcripts TSV, per-subject HDF5 BOLD, movie + wav
stimuli), so the full pipeline — study discovery, enhancers, features,
training, submission writing — can run end-to-end without the real data.
Used by tests, ``grids.test_run`` fallback and ``bench.py``.
"""

from __future__ import annotations

import typing as tp
import zlib
from pathlib import Path

import numpy as np

from ..data.algonauts import TR_SECONDS
from ..io import hdf5

_WORDS = (
    "the quick brown fox jumps over a lazy dog while rain falls on green "
    "hills and children laugh near the old stone bridge by the river"
).split()


def _write_transcript(path: Path, duration: float, rng: np.random.Generator) -> None:
    import pandas as pd

    n_tr = int(duration / TR_SECONDS)
    rows = []
    wi = int(rng.integers(0, len(_WORDS)))
    for k in range(n_tr):
        t0 = k * TR_SECONDS
        n_words = int(rng.integers(1, 4))
        words, onsets, durs = [], [], []
        for j in range(n_words):
            words.append(_WORDS[(wi + j) % len(_WORDS)])
            onsets.append(round(t0 + j * 0.4, 3))
            durs.append(0.3)
        wi += n_words
        rows.append(
            {
                "words_per_tr": repr(words),
                "onsets_per_tr": repr(onsets),
                "durations_per_tr": repr(durs),
            }
        )
    path.parent.mkdir(parents=True, exist_ok=True)
    pd.DataFrame(rows).to_csv(path, sep="\t", index=False)


def _write_wav(path: Path, duration: float, rng: np.random.Generator, sr: int = 16000) -> None:
    from ..io import wav as wavio

    t = np.arange(int(duration * sr)) / sr
    freq = float(rng.uniform(200, 600))
    sig = 0.25 * np.sin(2 * np.pi * freq * t) + 0.05 * rng.standard_normal(len(t))
    path.parent.mkdir(parents=True, exist_ok=True)
    wavio.write(path, sig.astype(np.float32), sr)


def _write_video(path: Path, duration: float, rng: np.random.Generator, fps: int = 4) -> bool:
    import cv2

    path.parent.mkdir(parents=True, exist_ok=True)
    n = int(duration * fps)
    h = w = 64
    for fourcc_name in ("mp4v", "XVID", "MJPG"):
        fourcc = cv2.VideoWriter_fourcc(*fourcc_name)
        writer = cv2.VideoWriter(str(path), fourcc, fps, (w, h))
        if writer.isOpened():
            break
        writer.release()
    else:
        return False
    for k in range(n):
        frame = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
        # moving gradient so frames are distinguishable
        frame[:, :, 0] = (np.arange(w)[None, :] * 4 + k * 8) % 256
        writer.write(frame)
    writer.release()
    return path.exists() and path.stat().st_size > 0


def make_synthetic_study(
    root: str | Path,
    *,
    subjects: tp.Sequence[str] = ("sub-01", "sub-02"),
    train_episodes: tp.Sequence[str] = ("e01a", "e01b"),
    test_episodes: tp.Sequence[str] = ("e01a",),
    duration: float = 45.0,
    n_parcels: int = 64,
    with_video: bool = True,
    seed: int = 0,
) -> Path:
    """Create a synthetic dataset under ``root``; returns the study path.

    BOLD is generated as a noisy linear readout of a word-rate signal so a
    working model can achieve nontrivial Pearson r on it.
    """
    rng = np.random.default_rng(seed)
    study_path = Path(root) / "algonauts2025"
    comp = study_path / "download" / "algonauts_2025.competitors"

    episodes = [("1", ch, "train") for ch in train_episodes]
    episodes += [("7", ch, "test") for ch in test_episodes]

    # shared stimuli
    for season, chunk, _split in episodes:
        tpath = (
            comp / "stimuli" / "transcripts" / "friends" / f"s{season}"
            / f"friends_s{int(season):02d}{chunk}.tsv"
        )
        if not tpath.exists():
            # stable per-chunk seed (builtin hash() is salted per process)
            chunk_seed = seed + zlib.crc32(chunk.encode()) % 1000
            _write_transcript(tpath, duration, np.random.default_rng(chunk_seed))
        mpath = (
            comp / "stimuli" / "movies" / "friends" / f"s{season}"
            / f"friends_s{int(season):02d}{chunk}.mkv"
        )
        if with_video and not mpath.exists():
            ok = _write_video(mpath, duration, rng)
            if ok:
                _write_wav(mpath.with_suffix(".wav"), duration, rng)

    n_tr = int(duration / TR_SECONDS)
    for subject in subjects:
        func = comp / "fmri" / subject / "func"
        func.mkdir(parents=True, exist_ok=True)
        stem = (
            f"{subject}_task-friends_space-MNI152NLin2009cAsym_"
            "atlas-Schaefer18_parcel-1000Par7Net"
        )
        h5path = func / f"{stem}_desc-s123456_bold.h5"
        present = set(hdf5.keys(h5path)) if h5path.exists() else set()
        new: dict[str, np.ndarray] = {}
        for season, chunk, split in episodes:
            if split == "test":
                continue
            key = f"ses-001_task-{int(season):02d}{chunk}"
            if key in present or key in new:
                continue
            # (time, parcels): noisy projection of a smooth latent
            latent = rng.standard_normal((n_tr, 8)).cumsum(axis=0)
            latent -= latent.mean(0)
            proj = rng.standard_normal((8, n_parcels))
            bold = latent @ proj + 0.5 * rng.standard_normal((n_tr, n_parcels))
            new[key] = bold.astype(np.float32)
        if new or not h5path.exists():
            hdf5.write(h5path, new, mode="a")
    # test target sample numbers for the submission writer; season-7 test
    # timelines exist for every release subject (they need no BOLD)
    for subject in ["sub-01", "sub-02", "sub-03", "sub-05"]:
        tsn_dir = comp / "fmri" / subject / "target_sample_number"
        tsn_dir.mkdir(parents=True, exist_ok=True)
        tsn = {f"s07{chunk}": n_tr for season, chunk, split in episodes if split == "test"}
        np.save(tsn_dir / f"{subject}_friends-s7_fmri_samples.npy", tsn, allow_pickle=True)

    return study_path
