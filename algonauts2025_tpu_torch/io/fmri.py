"""fMRI payload loading (HDF5 / NumPy), replacing nibabel/h5py plumbing
(reference data_utils/data_utils/studies/algonauts2025.py:137-153); HDF5
through io/hdf5.py, which needs no h5py.

Arrays are returned float32 AS STORED — orientation is the caller's
responsibility: data/algonauts.py transposes the release's time-major
datasets, and core/events.Fmri._read validates orientation against the
event's declared duration/frequency (transposing when the file is
time-major).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import hdf5


def load(path: str) -> np.ndarray:
    """Load a 2D array from .h5/.hdf5/.npy, orientation as stored."""
    p = Path(path)
    if p.suffix in (".h5", ".hdf5"):
        keys = hdf5.keys(p)
        if len(keys) != 1:
            raise ValueError(f"Expected a single dataset in {path}, got {keys}")
        data = hdf5.read(p, keys[0])
    elif p.suffix == ".npy":
        data = np.load(p)
    else:
        raise ValueError(f"Unsupported fmri file type: {path}")
    data = np.asarray(data, dtype=np.float32)
    if data.ndim != 2:
        raise ValueError(f"{path} should be 2D (time x parcels or parcels x time)")
    return data


def load_h5_key(path: str, key_substr: str) -> np.ndarray:
    """Load the unique dataset whose name contains ``key_substr``.

    The Algonauts release stores one dataset per (movie, chunk[, run]) in a
    per-subject h5 file keyed like "..._task-s01e02a_...".
    """
    keys = hdf5.keys(path)
    selected = [k for k in keys if key_substr in k]
    if len(selected) != 1:
        raise ValueError(f"Multiple or no keys found for {key_substr!r} in {path}: {keys}")
    return np.asarray(hdf5.read(path, selected[0]), dtype=np.float32)
