"""Per-item cached map execution (exca MapInfra equivalent).

A feature's bulk compute (``_get_data``) maps events -> arrays.  Results
are cached per item uid in an ArrayStore keyed by the owning config's hash
(minus its cache-uid exclusions), replicating the reference's contract that
``device``/``layers`` etc. never invalidate caches (reference
text.py:153-158) while any semantic config change does.
"""

from __future__ import annotations

import logging
import typing as tp
from pathlib import Path

import numpy as np
import pydantic

from ..config.uid import config_uid
from .array_store import ArrayStore

logger = logging.getLogger(__name__)

__all__ = ["MapInfra", "CachedMap"]


class MapInfra(pydantic.BaseModel):
    """Placement/caching config for per-item map computations.

    ``cluster`` values: None (in-process), "threadpool"/"processpool"
    (host-side parallel map over items).  The reference's "slurm" fanout
    maps to external multi-host launches; within one program host threads
    feed the single device stream.
    """

    model_config = pydantic.ConfigDict(extra="forbid")

    folder: str | Path | None = None
    mode: tp.Literal["cached", "force", "readonly"] = "cached"
    version: str = "0"
    keep_in_ram: bool = True
    cluster: tp.Optional[str] = None
    max_jobs: int | None = None

    def _exclude_from_cache_uid(self) -> list[str]:
        return list(type(self).model_fields)


class CachedMap:
    """Wraps a bulk generator fn with an item-level array cache."""

    def __init__(
        self,
        *,
        infra: MapInfra,
        owner: pydantic.BaseModel,
        method_name: str,
        fn: tp.Callable[[list], tp.Iterable[np.ndarray]],
        item_uid: tp.Callable[[tp.Any], str],
    ) -> None:
        self.infra = infra
        self.owner = owner
        self.method_name = method_name
        self.fn = fn
        self.item_uid = item_uid
        self._store: ArrayStore | None = None
        self._cleared = False
        self._ram_only: dict[str, np.ndarray] = {}
        self._warned_processpool = False

    @property
    def store(self) -> ArrayStore | None:
        if self.infra.folder is None:
            return None
        if self._store is None:
            # the owner can declare an implementation version (class var
            # `_cache_impl_version`) that busts caches when the COMPUTE
            # semantics change without any config field changing — e.g.
            # the r3 video decode/resize parity fixes changed cached
            # feature values under identical configs.  "0" (the default)
            # keeps historical uids stable.
            impl = str(getattr(self.owner, "_cache_impl_version", "0"))
            version = (
                self.infra.version
                if impl == "0"
                else f"{self.infra.version}+impl{impl}"
            )
            uid = config_uid(self.owner, version=version)
            folder = Path(self.infra.folder) / uid / self.method_name
            self._store = ArrayStore(folder, keep_in_ram=self.infra.keep_in_ram)
            if self.infra.mode == "force" and not self._cleared:
                self._store.clear()
                self._cleared = True
        return self._store

    def __call__(self, items: tp.Sequence[tp.Any]) -> list[np.ndarray]:
        store = self.store
        uids = [self.item_uid(it) for it in items]
        if store is None:
            # no folder: RAM-only cache for the lifetime of this object.
            # Dedupe within the call too (first appearance wins, like the
            # store path): duplicate uids — e.g. every unmatched word with
            # an empty context — must not pay a backbone forward each
            missing: dict[str, tp.Any] = {}
            for u, it in zip(uids, items):
                if u not in self._ram_only and u not in missing:
                    missing[u] = it
            if missing:
                results = self.fn(list(missing.values()))
                for u, arr in zip(missing, results):
                    self._ram_only[u] = np.asarray(arr)
            return [self._ram_only[u] for u in uids]

        # keep one compute per distinct uid, in first-appearance order
        seen: dict[str, tp.Any] = {}
        for u, it in zip(uids, items):
            if u not in seen:
                seen[u] = it
        missing_uids = store.missing(list(seen))
        if missing_uids:
            if self.infra.mode == "readonly":
                raise KeyError(
                    f"{len(missing_uids)} items missing from readonly cache "
                    f"{store.folder}"
                )
            to_compute = [seen[u] for u in missing_uids]
            logger.info(
                "%s.%s: computing %d/%d items (cache %s)",
                type(self.owner).__name__,
                self.method_name,
                len(to_compute),
                len(seen),
                store.folder,
            )
            # consume the compute generator OUTSIDE the store lock: the
            # bulk fn can run for minutes/hours (backbone inference), and
            # append_many holds an exclusive file lock while iterating —
            # holding it across compute would time out every concurrent
            # shard of a job array.  Small batches keep memory bounded
            # while the per-record index flush preserves crash safety.
            batch: list[tuple[str, np.ndarray]] = []
            for item in self._compute(missing_uids, to_compute):
                batch.append(item)
                if len(batch) >= 8:
                    store.append_many(batch)
                    batch = []
            if batch:
                store.append_many(batch)
        return [store[u] for u in uids]

    def _compute(
        self, missing_uids: list[str], to_compute: list
    ) -> tp.Iterator[tuple[str, np.ndarray]]:
        """Run the bulk fn over missing items; with cluster="threadpool"/
        "processpool" the items are chunked over host threads (IO-bound
        readers — device-bound fns serialize on the stream anyway)."""
        workers = self.infra.max_jobs or 4
        if self.infra.cluster in ("threadpool", "processpool") and len(to_compute) > 1:
            if self.infra.cluster == "processpool" and not self._warned_processpool:
                # fns here close over unpicklable device state (jit'd
                # backbones), so real ProcessPoolExecutor isolation is
                # impossible in-process; true process isolation is
                # cluster="external" (job arrays).  Run as threads, but say
                # so ONCE — a silent substitution would let a GIL-bound fn
                # "parallelize" into nothing with no signal.
                self._warned_processpool = True
                logger.warning(
                    "cluster='processpool' runs as a THREAD pool in-process "
                    "(device-backed fns are unpicklable); use "
                    "cluster='external' for real process isolation"
                )
            import concurrent.futures

            n = min(workers, len(to_compute))
            chunks = [
                (missing_uids[k::n], to_compute[k::n]) for k in range(n)
            ]
            with concurrent.futures.ThreadPoolExecutor(n) as pool:
                futures = [
                    pool.submit(lambda c=c: list(zip(c[0], map(np.asarray, self.fn(c[1])))))
                    for c in chunks
                ]
                for fut in futures:
                    yield from fut.result()
            return
        for u, arr in zip(missing_uids, self.fn(to_compute)):
            yield u, np.asarray(arr)
