"""Segment dataset, host-side batching and the host-to-device copy.

The port of algonauts2025_tpu/data/dataset.py:

- Batches are dicts of fixed-shape NumPy arrays (``pad_duration`` makes
  every feature a static (L, D, T) block), assembled on host threads from
  the memmap feature caches and TimedArray pooling.
- ``prefetch_to_device`` keeps the JAX package's bounded queue and producer
  thread; the thread copies each batch into pinned memory and queues a
  ``non_blocking`` copy onto an explicit ``torch.device``, so batch k+1
  crosses while the card works on batch k.
- ``to_device`` is the trainer's copy: a tensor already on the device is
  left as it is, so the two compose.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import logging
import queue
import threading
import typing as tp

import numpy as np
import torch

from ..core.segments import Segment
from ..core.timed import Frequency

logger = logging.getLogger(__name__)

__all__ = ["SegmentData", "SegmentDataset", "get_pad_lengths", "prefetch_to_device", "to_device"]


@dataclasses.dataclass
class SegmentData:
    """A batch: feature name -> (B, ...) array + the source segments."""

    data: tp.Dict[str, np.ndarray]
    segments: tp.List[Segment]

    def __post_init__(self) -> None:
        if not isinstance(self.data, dict):
            raise TypeError(f"'data' needs to be a dict, got: {self.data}")
        if not self.data:
            raise ValueError(f"No data in {self}")
        if not isinstance(self.segments, list):
            raise TypeError(f"'segments' needs to be a list, got {self.segments}")
        batch_size = next(iter(self.data.values())).shape[0]
        if len(self.segments) != batch_size:
            raise RuntimeError(
                f"Incoherent batch size {batch_size} for "
                f"{len(self.segments)} segments"
            )

    @property
    def batch_size(self) -> int:
        return next(iter(self.data.values())).shape[0]


def _pad_to(arr: np.ndarray, pad_len: int | None) -> np.ndarray:
    if pad_len is None:
        return arr
    t = arr.shape[-1]
    if pad_len < t:
        logger.warning("Pad duration shorter than segment duration, cropping.")
        return arr[..., :pad_len]
    if pad_len == t:
        return arr
    widths = [(0, 0)] * (arr.ndim - 1) + [(0, pad_len - t)]
    return np.pad(arr, widths)


def get_pad_lengths(
    features: tp.Mapping[str, tp.Any], pad_duration: float | None
) -> tp.Dict[str, int]:
    pad_lengths: tp.Dict[str, int] = {}
    if pad_duration is None:
        return pad_lengths
    for name, f in features.items():
        freq = getattr(f, "frequency", None)
        if freq:
            pad_lengths[name] = Frequency(freq).to_ind(pad_duration)
    return pad_lengths


class SegmentDataset:
    """Map-style dataset: segment -> per-feature pooled arrays."""

    def __init__(
        self,
        features: tp.Mapping[str, tp.Any],
        segments: tp.Sequence[Segment],
        pad_duration: float | None = None,
    ) -> None:
        if not isinstance(features, collections.abc.Mapping):
            raise ValueError(f"Only dict of features supported, got {type(features)}")
        self.features = features
        self.segments = list(segments)
        self.pad_duration = pad_duration
        self._pad_lengths = get_pad_lengths(features, pad_duration)

    def __len__(self) -> int:
        return len(self.segments)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        seg = self.segments[idx]
        out: dict[str, np.ndarray] = {}
        for name, feature in self.features.items():
            data = feature(
                seg.ns_events,
                start=seg.start,
                duration=seg.duration,
                trigger=seg._trigger,
            )
            data = np.asarray(data)
            out[name] = _pad_to(data, self._pad_lengths.get(name))
        return out

    def collate(
        self, items: tp.Sequence[dict[str, np.ndarray]], segments: tp.List[Segment]
    ) -> SegmentData:
        data = {}
        for name in items[0]:
            try:
                data[name] = np.stack([it[name] for it in items], axis=0)
            except ValueError:
                shapes = [it[name].shape for it in items]
                raise ValueError(
                    f"Failed to collate feature {name!r} with shapes {shapes}. "
                    "Specify pad_duration in SegmentDataset for static shapes."
                )
        return SegmentData(data=data, segments=segments)

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        seed: int | None = None,
        num_workers: int = 0,
        drop_remainder: bool = False,
    ) -> tp.Iterator[SegmentData]:
        """Yield collated batches; item assembly optionally on host threads."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        if drop_remainder:
            order = order[: (len(order) // batch_size) * batch_size]

        chunks = [
            order[i : i + batch_size] for i in range(0, len(order), batch_size)
        ]
        if num_workers > 0:
            with concurrent.futures.ThreadPoolExecutor(num_workers) as ex:
                # pipeline: submit the next chunk's items while yielding
                pending = collections.deque()
                for chunk in chunks:
                    pending.append(
                        (chunk, [ex.submit(self.__getitem__, int(i)) for i in chunk])
                    )
                    while len(pending) > 2:
                        yield self._finish(*pending.popleft())
                while pending:
                    yield self._finish(*pending.popleft())
        else:
            for chunk in chunks:
                items = [self[int(i)] for i in chunk]
                yield self.collate(items, [self.segments[int(i)] for i in chunk])

    def _finish(self, chunk: np.ndarray, futures: list) -> SegmentData:
        items = [f.result() for f in futures]
        return self.collate(items, [self.segments[int(i)] for i in chunk])

    def build_dataloader(
        self,
        batch_size: int = 16,
        shuffle: bool = False,
        num_workers: int = 0,
        seed: int | None = None,
    ) -> tp.Iterable[SegmentData]:
        """Reference-API convenience: a re-iterable batch source."""
        dataset = self

        class _Loader:
            def __iter__(self):
                return dataset.batches(
                    batch_size=batch_size,
                    shuffle=shuffle,
                    seed=seed,
                    num_workers=num_workers,
                )

            def __len__(self):
                return -(-len(dataset) // batch_size)

        return _Loader()

    def as_one_batch(self, num_workers: int = 0) -> SegmentData:
        batches = list(
            self.batches(batch_size=max(1, len(self)), num_workers=num_workers)
        )
        if not batches:
            raise ValueError(
                "as_one_batch on an EMPTY dataset (zero segments) — check "
                "the split/query that produced it"
            )
        if len(batches) == 1:
            return batches[0]
        data = {
            name: np.concatenate([b.data[name] for b in batches], axis=0)
            for name in batches[0].data
        }
        segments = [s for b in batches for s in b.segments]
        return SegmentData(data=data, segments=segments)


def prefetch_to_device(
    iterator: tp.Iterable[SegmentData],
    device: str | torch.device,
    size: int = 2,
) -> tp.Iterator[SegmentData]:
    """Double-buffer host batches onto ``device``.

    A producer thread copies each batch's arrays into pinned memory and
    queues ``non_blocking`` copies onto the device (``to_device``), at most
    ``size`` batches ahead of the consumer, so assembling and pinning batch
    k+1 overlaps the card's work on batch k.  The copies go on the device's
    current stream, behind the work already queued there.  An early stop of
    the consumer (``limit_train_batches``, ``fast_dev_run``) stops the
    thread and drops the staged batches."""
    device = torch.device(device)

    def _put(batch: SegmentData) -> SegmentData:
        return SegmentData(data=to_device(batch.data, device), segments=batch.segments)

    q: "queue.Queue" = queue.Queue(maxsize=size)
    _END = object()
    err: list[BaseException] = []
    stop = threading.Event()

    def _producer() -> None:
        try:
            for batch in iterator:
                staged = _put(batch)
                while not stop.is_set():
                    try:
                        q.put(staged, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # propagate to consumer
            err.append(e)
        finally:
            # the END sentinel must never be dropped: with a full queue a
            # put_nowait would lose it and the consumer's final q.get()
            # would block forever at epoch end
            while not stop.is_set():
                try:
                    q.put(_END, timeout=0.1)
                    break
                except queue.Full:
                    continue

    thread = threading.Thread(target=_producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        # consumer abandoned mid-epoch: unblock the producer and drop staged
        # device batches so they free
        stop.set()
        while not q.empty():
            with contextlib.suppress(queue.Empty):
                q.get_nowait()
        thread.join(timeout=10.0)


def to_device(
    data: tp.Mapping[str, np.ndarray | torch.Tensor], device: str | torch.device
) -> dict[str, torch.Tensor]:
    """Copy a batch dict onto ``device`` (pinned, non-blocking for CUDA)."""
    device = torch.device(device)
    out = {}
    for key, value in data.items():
        tensor = torch.as_tensor(value)
        if device.type == "cuda" and tensor.device.type == "cpu":
            tensor = tensor.pin_memory()
        out[key] = tensor.to(device, non_blocking=True)
    return out
