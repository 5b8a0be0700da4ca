"""Tracing and per-stage timing.

The port of algonauts2025_tpu/utils/profiling.py:

- ``trace(logdir)``: a ``torch.profiler`` trace (host activity, and the
  card's kernels and copies when there is a card) around a region, written
  as a Chrome trace ``trace.json`` under ``logdir``.  Unlike the JAX
  package's ``trace``, which carries on without a trace when the profiler
  fails to start, this one raises: a run asked to profile never ends
  "successfully" with no trace.
- ``step_range(i)``: a ``record_function`` range named ``train_step#<i>``
  (and an NVTX range on the card) around one train step.
- ``step_summary(path)``: from a written trace, each step's host wall
  time, the card's busy time for the work launched inside the step and
  the number of kernels launched.
- ``StageTimer``: wall-clock accounting for host pipeline stages.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
import typing as tp
from collections import defaultdict
from pathlib import Path

import torch

logger = logging.getLogger(__name__)

__all__ = ["trace", "step_range", "step_summary", "StageTimer", "STEP_PREFIX"]

#: name prefix of the per-step ranges
STEP_PREFIX = "train_step#"
#: trace categories of work on the card
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(logdir: str | Path) -> tp.Iterator[torch.profiler.profile]:
    """Profile the region; write ``<logdir>/trace.json``.  Raises when the
    profiler cannot start or the trace is not written."""
    path = Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the region's last kernels end inside the trace
    out = path / "trace.json"
    prof.export_chrome_trace(str(out))
    if not out.is_file() or out.stat().st_size == 0:
        raise RuntimeError(f"torch.profiler wrote no trace to {out}")
    logger.info("Wrote profiler trace to %s", out)


@contextlib.contextmanager
def step_range(step: int) -> tp.Iterator[None]:
    """A profiler range (and an NVTX range on the card) around step ``step``."""
    name = f"{STEP_PREFIX}{step}"
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _busy_ms(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals in microseconds, as ms."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def step_summary(trace_path: str | Path) -> list[dict[str, tp.Any]]:
    """Per ``step_range``: ``host_ms`` (the range's wall time), ``wait_ms``
    (the host time since the previous step's range ended: the data feed),
    ``device_ms`` (the card busy with the kernels and copies launched inside
    the range, overlaps counted once, wherever on the timeline they ran),
    ``launches`` (kernels launched inside the range) and ``runtime_ms``
    (the host's ms in each CUDA runtime call inside the range, by name:
    where it waited on the card or the allocator)."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    steps = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), int(e["name"][len(STEP_PREFIX):]))
        for e in complete
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith(STEP_PREFIX)
    )
    # a launch belongs to the step whose host range holds the launch call
    # (the backward's launches come from autograd's thread, inside the range)
    step_of: dict[int, int] = {}
    runtime: dict[int, dict[str, float]] = defaultdict(lambda: defaultdict(float))
    for e in complete:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        ts = float(e["ts"])
        for start, end, step in steps:
            if start <= ts <= end:
                runtime[step][e.get("name", "?")] += float(e["dur"]) / 1e3
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    step_of[corr] = step
                break
    work: dict[int, list[tuple[float, float]]] = defaultdict(list)
    launches: dict[int, int] = defaultdict(int)
    for e in complete:
        if e.get("cat") not in _DEVICE_CATEGORIES:
            continue
        step = step_of.get(e.get("args", {}).get("correlation"))
        if step is None:
            continue
        work[step].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        launches[step] += e["cat"] == "kernel"
    out, previous_end = [], None
    for start, end, step in steps:
        out.append({
            "step": step,
            "host_ms": (end - start) / 1e3,
            "wait_ms": (start - previous_end) / 1e3 if previous_end is not None else 0.0,
            "device_ms": _busy_ms(work[step]),
            "launches": launches[step],
            "runtime_ms": dict(runtime[step]),
        })
        previous_end = end
    return out


class StageTimer:
    """Accumulates wall-clock per named stage; dumps a JSON summary."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> tp.Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def wrap(self, name: str, iterable: tp.Iterable) -> tp.Iterator:
        """Attribute the time spent *producing* each item to ``name``."""
        it = iter(iterable)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
            yield item

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_s": round(self.totals[name] / max(1, self.counts[name]), 6),
            }
            for name in sorted(self.totals)
        }

    def dump(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.summary(), indent=2))

    def log(self) -> None:
        for name, stats in self.summary().items():
            logger.info(
                "stage %-24s total=%.3fs n=%d mean=%.2fms",
                name, stats["total_s"], stats["count"], stats["mean_s"] * 1e3,
            )
