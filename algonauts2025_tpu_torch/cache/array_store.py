"""Append-only memmap array store with a JSONL index.

TPU-native replacement for exca's MemmapArrayFile/NumpyMemmapArray caches
(reference features cache activations per item uid, e.g. text.py:204-208,
audio.py:140-144).  One store = one flat binary file plus a JSONL index of
(key, offset, shape, dtype).  Reads are zero-copy memmap views, so the
feature __call__ hot path (DataLoader equivalent) never deserializes.

Writes are guarded by an exclusive lock file so concurrent prepare() calls
from several processes don't interleave (the reference relied on exca's
file locks for the same purpose).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import typing as tp
from pathlib import Path

import numpy as np

__all__ = ["ArrayStore"]


@contextlib.contextmanager
def _file_lock(path: Path, timeout: float = 600.0) -> tp.Iterator[None]:
    """Exclusive advisory lock on ``<path>.lock`` via fcntl.flock.

    flock is released by the KERNEL when the holder dies (any signal,
    incl. SIGKILL), so a killed writer can never deadlock kill+resume —
    no stale-lock detection or pid-based stealing needed (an earlier
    O_EXCL+steal design had an unclosable TOCTOU between liveness check
    and steal; flock has neither problem).  The lock file persists after
    release — unlinking it would race a third process onto a fresh inode
    while a second still holds the old one (two "exclusive" holders).
    The holder's host:pid is written into the file purely for the
    timeout diagnostic.
    """
    import fcntl

    lock = Path(str(path) + ".lock")
    start = time.time()
    fd = os.open(lock, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError:
                if time.time() - start > timeout:
                    held_by = "?"
                    with contextlib.suppress(OSError):
                        held_by = lock.read_text().strip() or "?"
                    raise TimeoutError(
                        f"Could not acquire lock {lock} "
                        f"(held by live process {held_by})"
                    )
                time.sleep(0.05)
        # diagnostics only — correctness lives in the flock
        with contextlib.suppress(OSError):
            os.ftruncate(fd, 0)
            os.write(fd, f"{os.uname().nodename}:{os.getpid()}".encode())
        try:
            yield
        finally:
            with contextlib.suppress(OSError):
                os.ftruncate(fd, 0)
            fcntl.flock(fd, fcntl.LOCK_UN)
    finally:
        os.close(fd)


class ArrayStore:
    """Dict-like {str key -> np.ndarray} backed by a single memmap file."""

    def __init__(self, folder: str | Path, keep_in_ram: bool = False) -> None:
        self.folder = Path(folder)
        self.folder.mkdir(parents=True, exist_ok=True)
        self._bin = self.folder / "data.bin"
        self._index_path = self.folder / "index.jsonl"
        self._index: dict[str, tuple[int, tuple[int, ...], str]] = {}
        self._index_mtime: tuple[int, int] | float = -1.0
        self._ram: dict[str, np.ndarray] | None = {} if keep_in_ram else None
        self._mmap: np.memmap | None = None
        self._load_index()

    def _load_index(self) -> None:
        if not self._index_path.exists():
            return
        st = self._index_path.stat()
        # (mtime_ns, size): size grows on every append, so two writes in
        # one coarse-granularity mtime tick (NFS) can't serve a stale index
        mtime = (st.st_mtime_ns, st.st_size)
        if mtime == self._index_mtime and self._index:
            return
        index: dict[str, tuple[int, tuple[int, ...], str]] = {}
        with open(self._index_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn write from a crashed producer
                index[rec["k"]] = (rec["o"], tuple(rec["s"]), rec["d"])
        self._index = index
        self._index_mtime = mtime
        self._mmap = None  # file may have grown

    def refresh(self) -> None:
        self._load_index()

    def __len__(self) -> int:
        return len(self._index)

    def keys(self) -> tp.KeysView[str]:
        return self._index.keys()

    def __contains__(self, key: str) -> bool:
        if key in self._index:
            return True
        self._load_index()
        return key in self._index

    def __getitem__(self, key: str) -> np.ndarray:
        if self._ram is not None and key in self._ram:
            return self._ram[key]
        if key not in self._index:
            self._load_index()
        offset, shape, dtype = self._index[key]
        if self._mmap is None:
            self._mmap = np.memmap(self._bin, dtype=np.uint8, mode="r")
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        arr = self._mmap[offset : offset + nbytes].view(dtype).reshape(shape)
        if self._ram is not None:
            arr = np.array(arr)  # own the data in RAM
            self._ram[key] = arr
        return arr

    def missing(self, keys: tp.Iterable[str]) -> list[str]:
        self._load_index()
        return [k for k in keys if k not in self._index]

    def append_many(self, items: tp.Iterable[tuple[str, np.ndarray]]) -> None:
        """Append arrays; flushes index entry after each payload write."""
        with _file_lock(self._bin):
            self._load_index()
            with open(self._bin, "ab") as bf, open(self._index_path, "a") as xf:
                for key, arr in items:
                    if key in self._index:
                        continue
                    arr = np.ascontiguousarray(arr)
                    offset = bf.tell()
                    bf.write(arr.tobytes())
                    bf.flush()
                    rec = {
                        "k": key,
                        "o": offset,
                        "s": list(arr.shape),
                        "d": arr.dtype.str,
                    }
                    xf.write(json.dumps(rec) + "\n")
                    xf.flush()
                    self._index[key] = (offset, arr.shape, arr.dtype.str)
                    if self._ram is not None:
                        self._ram[key] = np.array(arr)
        self._mmap = None

    def clear(self) -> None:
        with _file_lock(self._bin):
            for p in (self._bin, self._index_path):
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(p)
            self._index = {}
            self._index_mtime = -1.0
            self._mmap = None
            if self._ram is not None:
                self._ram = {}
