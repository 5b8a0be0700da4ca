"""The traced window: a ``torch.profiler`` trace read back into intervals.

``Tracer`` opens the profiler around the measured window (with ``--trace 1``)
and reads its Chrome trace back: the device's work (kernels, copies,
memsets) as (name, start, end) intervals clipped to the window, and the
benchmark's own host spans (``span(name)``: ``record_function`` ranges named
``bench.<name>``).  Times are seconds from the window's start.  The trace
is written under ``TMPDIR`` and deleted once read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import typing as tp
from collections import defaultdict

import torch

#: trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."


@contextlib.contextmanager
def span(name: str) -> tp.Iterator[None]:
    """A host span of the benchmark's own, seen in the trace."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


@dataclasses.dataclass
class Trace:
    window_s: float
    #: (name, category, start_s, end_s) of each device operation in the window
    device: list[tuple[str, str, float, float]]
    #: (name, start_s, end_s) of each benchmark span (prefix stripped)
    spans: list[tuple[str, float, float]]

    def kernels(self, *needles: str) -> list[tuple[str, float, float]]:
        """The kernels whose name holds any of ``needles``."""
        return [(n, s, e) for n, c, s, e in self.device
                if c == "kernel" and any(needle in n for needle in needles)]

    def busy_s(self) -> float:
        """The union of the device intervals: seconds the device worked."""
        total, reach = 0.0, float("-inf")
        for _, _, start, end in sorted(self.device, key=lambda d: d[2]):
            if end > reach:
                total += end - max(start, reach)
                reach = end
        return total

    def idle_gaps(self) -> list[tuple[float, float]]:
        """The (start, end) stretches of the window with nothing on the device."""
        gaps, reach = [], 0.0
        for _, _, start, end in sorted(self.device, key=lambda d: d[2]):
            if start > reach:
                gaps.append((reach, start))
            reach = max(reach, end)
        if reach < self.window_s:
            gaps.append((reach, self.window_s))
        return gaps

    def open_span(self, t: float) -> str:
        """The innermost benchmark span open at ``t`` ("none" outside all)."""
        best = None
        for name, start, end in self.spans:
            if start <= t <= end and (best is None or start >= best[1]):
                best = (name, start)
        return best[0] if best else "none"

    def breakdown(self, top: int = 10) -> dict[str, list[list]]:
        """The device operations that took most time, summed by name, and
        the longest idle gaps, each named by the span that was open on the
        host at its middle."""
        by_name: dict[str, float] = defaultdict(float)
        for name, _, start, end in self.device:
            by_name[name] += end - start
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[name[:200], s] for name, s in ops],
                "idle_gaps": [[self.open_span((a + b) / 2), b - a] for a, b in gaps]}


class Tracer:
    """``with tracer.window():`` profiles the measured window; ``trace`` then
    holds it.  ``enabled=False`` measures without the profiler."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self.trace: Trace | None = None

    @contextlib.contextmanager
    def window(self) -> tp.Iterator[None]:
        if not self.enabled:
            yield
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(SPAN_PREFIX + "window"):
                yield
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.trace = read_events(events)


def read_events(events: list[dict]) -> Trace:
    """A ``Trace`` from Chrome trace events: the window is the
    ``bench.window`` span."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in complete if e.get("name") == SPAN_PREFIX + "window"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans, not one")
    t0 = float(windows[0]["ts"])
    t1 = t0 + float(windows[0]["dur"])
    device, spans = [], []
    for e in complete:
        start = float(e["ts"])
        end = start + float(e["dur"])
        if e.get("cat") in DEVICE_CATEGORIES:
            start, end = max(start, t0), min(end, t1)
            if end > start:
                device.append((e.get("name", "?"), e["cat"], (start - t0) / 1e6, (end - t0) / 1e6))
        elif e.get("cat") == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIX):
            name = e["name"][len(SPAN_PREFIX):]
            if name != "window":
                spans.append((name, (start - t0) / 1e6, (end - t0) / 1e6))
    return Trace(window_s=(t1 - t0) / 1e6, device=device, spans=spans)
