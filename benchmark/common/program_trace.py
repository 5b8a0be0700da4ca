"""The program's own spans in a traced window, beside the device's work.

``trace.read_events`` keeps the device's work and the benchmark's
``bench.*`` spans.  ``read`` takes the same Chrome trace events for what
the program records itself: its ``record_function`` ranges (the port's
``utils.profiling.span``: ``video.*`` and ``vit.*``, the spans of one
window batch ending in ``#<k>``), the CUDA runtime and driver calls with
their correlation ids, and each device operation with the id of the call
that launched it.  An operation is put down to the innermost program range
whose host interval holds its launch call, as the port's
``utils.profiling.step_summary`` does for steps.  Times are seconds from
the window's start.

The four quantities a window batch (``per_batch``), each ``None`` where
the trace holds none of the spans it reads:

- ``stream.exposed_ms.video``: device-idle time whose innermost open host
  span is a program span other than ``video.fetch``: the card starved by
  the program's own host work;
- ``stream.stage_ms.video``: host time in ``video.stack`` and
  ``video.upload``;
- ``stream.waits.video``: blocking host waits on the card
  (``BLOCKING_CALLS``) made inside program spans;
- ``vit.glue_ms.video``: device time of the kernels launched inside
  ``video.backbone``, less the hand-written ones (``HAND_WRITTEN``).

``EventTracer`` is ``trace.Tracer`` with the window's events kept for
``read``.  A ``benchmark`` change that lets ``trace.read_events`` keep the
program's ranges and the runtime calls takes ``read`` in there and retires
``EventTracer`` and ``benchmark/spans.py``.
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

from .. import harness
from . import trace
from .trace import SPAN_PREFIX, Trace, read_events

#: name prefixes of the program's ranges
PROGRAM_PREFIXES = ("video.", "vit.")
#: runtime calls in which the host waits for the card
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
#: row 6's w8a8 GEMM (its quantize pass is row 7's ``QUANTIZE``)
ROW6_GEMM = "StoreDequant<__nv_bfloat16, 0>"


def _hand_written() -> tuple[str, ...]:
    """The names of the hand-written kernels of rows 4, 6 and 7, as the
    roofline metrics that time them hold them."""
    flash = harness.load_module(harness.ROOT / "metrics" / "flash_roofline.video.py")
    mlp = harness.load_module(harness.ROOT / "metrics" / "int8_mlp_roofline.video.py")
    return (*flash.KERNELS, mlp.FC1, mlp.FC2, mlp.QUANTIZE, ROW6_GEMM)


HAND_WRITTEN = _hand_written()
STAGES = ("video.stack", "video.upload")
FETCH = "video.fetch"
BACKBONE = "video.backbone"


class _Range(tp.NamedTuple):
    name: str
    start: float
    end: float


@dataclasses.dataclass
class ProgramTrace:
    base: Trace
    #: each program range, its ``#<k>`` split off
    spans: list[_Range]
    #: (name, start_s, correlation) of each CUDA runtime or driver call
    calls: list[tuple[str, float, int | None]]
    #: (name, seconds in the window, correlation) of each kernel
    kernels: list[tuple[str, float, int | None]]

    def _host_ranges(self) -> list[_Range]:
        """The program's ranges and the benchmark's (the window left out)."""
        return self.spans + [_Range(*s) for s in self.base.spans]

    def open_at(self, times: list[float], ranges: list[_Range] | None = None) -> list[list[str]]:
        """For each of ``times``, the names of the ranges open at it,
        outermost first (ranges nest: one host thread records them)."""
        ranges = sorted(self.spans if ranges is None else ranges, key=lambda r: (r.start, -r.end))
        out: list[list[str]] = [[] for _ in times]
        active: list[_Range] = []
        i = 0
        for j in sorted(range(len(times)), key=times.__getitem__):
            t = times[j]
            while i < len(ranges) and ranges[i].start <= t:
                active.append(ranges[i])
                i += 1
            active = [r for r in active if r.end >= t]
            out[j] = [r.name for r in active]
        return out

    def innermost_pieces(self) -> list[tuple[float, float, str]]:
        """The window cut at every host range's start and end: (start, end,
        innermost open range) of each piece, in order ("none" outside all)."""
        ranges = self._host_ranges()
        points = sorted({0.0, self.base.window_s} | {p for r in ranges for p in (r.start, r.end)
                                                      if 0.0 < p < self.base.window_s})
        mids = [(a + b) / 2 for a, b in zip(points, points[1:])]
        names = [opened[-1] if opened else "none" for opened in self.open_at(mids, ranges)]
        return [(a, b, name) for (a, b), name in zip(zip(points, points[1:]), names)]

    def idle_by_span(self) -> dict[str, float]:
        """Seconds of device idle time by the innermost host range open."""
        out: dict[str, float] = defaultdict(float)
        pieces = self.innermost_pieces()
        i = 0
        for a, b in self.base.idle_gaps():
            while i < len(pieces) and pieces[i][1] <= a:
                i += 1
            j = i
            while j < len(pieces) and pieces[j][0] < b:
                start, end, name = pieces[j]
                out[name] += min(b, end) - max(a, start)
                j += 1
        return dict(out)

    def host_by_span(self) -> dict[str, float]:
        """Seconds of host time in each program range, by name."""
        out: dict[str, float] = defaultdict(float)
        for r in self.spans:
            out[r.name] += max(0.0, min(r.end, self.base.window_s) - max(r.start, 0.0))
        return dict(out)

    def waits_by_span(self) -> dict[str, int]:
        """Blocking calls made inside program ranges, by the innermost one."""
        calls = [(name, t) for name, t, _ in self.calls if name in BLOCKING_CALLS]
        out: dict[str, int] = defaultdict(int)
        for opened in self.open_at([t for _, t in calls]):
            if opened:
                out[opened[-1]] += 1
        return dict(out)

    def device_by_span(self) -> dict[str, dict[str, float]]:
        """Device seconds of each kernel, by the innermost program range
        that held its launch call ("none": launched outside them or by a
        call the trace lacks), in ``"all"``; those launched inside
        ``video.backbone`` and not hand-written in ``"glue"``."""
        launch = {corr: t for _, t, corr in self.calls if corr is not None}
        kernels = [(name, seconds, launch.get(corr)) for name, seconds, corr in self.kernels]
        timed = [k for k in kernels if k[2] is not None]
        out: dict[str, dict[str, float]] = {"all": defaultdict(float), "glue": defaultdict(float)}
        for (name, seconds, _), opened in zip(timed, self.open_at([k[2] for k in timed])):
            inner = opened[-1] if opened else "none"
            out["all"][inner] += seconds
            if BACKBONE in opened and not any(h in name for h in HAND_WRITTEN):
                out["glue"][inner] += seconds
        out["all"]["none"] += sum(seconds for _, seconds, t in kernels if t is None)
        return {key: dict(value) for key, value in out.items()}

    def named_gaps(self, top: int = 10) -> list[list]:
        """``Trace.breakdown``'s longest idle gaps, each named by the
        innermost host range open at its middle, the program's included."""
        gaps = sorted(self.base.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        names = self.open_at([(a + b) / 2 for a, b in gaps], self._host_ranges())
        return [[opened[-1] if opened else "none", b - a] for (a, b), opened in zip(gaps, names)]

    def per_batch(self, batches: int) -> dict[str, float | None]:
        """The four quantities a window batch (the module's docstring)."""
        names = {r.name for r in self.spans}
        out: dict[str, float | None] = dict.fromkeys(
            ("stream.exposed_ms.video", "stream.stage_ms.video", "stream.waits.video", "vit.glue_ms.video"))
        if not batches or not names:
            return out
        out["stream.waits.video"] = sum(self.waits_by_span().values()) / batches
        if names - {FETCH}:
            idle = self.idle_by_span()
            exposed = sum(s for n, s in idle.items() if n in names and n != FETCH)
            out["stream.exposed_ms.video"] = 1e3 * exposed / batches
        if names & set(STAGES):
            host = self.host_by_span()
            out["stream.stage_ms.video"] = 1e3 * sum(host.get(n, 0.0) for n in STAGES) / batches
        if BACKBONE in names:
            out["vit.glue_ms.video"] = 1e3 * sum(self.device_by_span()["glue"].values()) / batches
        return out


def read(events: list[dict]) -> ProgramTrace:
    """A ``ProgramTrace`` from Chrome trace events: the window is the
    ``bench.window`` span, as for ``trace.read_events``."""
    base = read_events(events)
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    t0 = next(float(e["ts"]) for e in complete if e.get("name") == SPAN_PREFIX + "window")
    t1 = t0 + base.window_s * 1e6
    spans, calls, kernels = [], [], []
    for e in complete:
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        corr = e.get("args", {}).get("correlation")
        cat = e.get("cat")
        if cat == "user_annotation" and e.get("name", "").startswith(PROGRAM_PREFIXES):
            # the batch index is for the eye; the quantities sum over batches
            spans.append(_Range(e["name"].split("#")[0], (start - t0) / 1e6, (end - t0) / 1e6))
        elif cat in ("cuda_runtime", "cuda_driver"):
            calls.append((e.get("name", "?"), (start - t0) / 1e6, corr))
        elif cat == "kernel" and min(end, t1) > max(start, t0):
            kernels.append((e.get("name", "?"), (min(end, t1) - max(start, t0)) / 1e6, corr))
    return ProgramTrace(base=base, spans=spans, calls=calls, kernels=kernels)


class EventTracer(trace.Tracer):
    """``trace.Tracer``'s profiled window, with the trace's events kept in
    ``events`` beside ``trace``."""

    def __init__(self) -> None:
        super().__init__(True)
        self.events: list[dict] = []

    @contextlib.contextmanager
    def window(self) -> tp.Iterator[None]:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            with trace.span("window"):
                yield
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.trace = read_events(self.events)
