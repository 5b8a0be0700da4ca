"""Parquet-backed DataFrame cache (exca ParquetPandasDataFrame equivalent).

Used by the study loader to cache per-timeline event DataFrames and the
fully-enhanced events table (reference data_utils/data_utils/data.py:122,207).
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import pandas as pd

__all__ = ["FrameStore"]


def _safe_name(key: str) -> str:
    h = hashlib.sha256(key.encode()).hexdigest()[:12]
    stem = "".join(c for c in key if c.isalnum() or c in "-_.")[:60]
    return f"{stem}-{h}.parquet"


class FrameStore:
    """Dict-like {str key -> pd.DataFrame} stored as parquet files."""

    def __init__(self, folder: str | Path) -> None:
        self.folder = Path(folder)
        self.folder.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        return self.folder / _safe_name(key)

    def __contains__(self, key: str) -> bool:
        return self._path(key).exists()

    def __getitem__(self, key: str) -> pd.DataFrame:
        path = self._path(key)
        if not path.exists():
            raise KeyError(key)
        return pd.read_parquet(path)

    def __setitem__(self, key: str, df: pd.DataFrame) -> None:
        # per-process temp name: concurrent writers of the same key (job
        # arrays building the same study) must not interleave into one
        # .tmp file; the atomic replace makes last-writer-wins safe
        tmp = self._path(key).with_suffix(f".tmp{os.getpid()}")
        # parquet requires homogeneous column types; object columns holding
        # mixed values are stringified (the event round-trip restores types)
        df = df.copy()
        for col in df.columns:
            if df[col].dtype == object:
                mask = df[col].notna()
                if not all(isinstance(v, str) for v in df.loc[mask, col]):
                    df[col] = df[col].astype(str).where(mask, None)
        df.to_parquet(tmp)
        tmp.replace(self._path(key))

    def clear(self) -> None:
        for p in self.folder.glob("*.parquet"):
            p.unlink()
        for p in self.folder.glob("*.tmp*"):  # orphans from killed writers
            p.unlink()
