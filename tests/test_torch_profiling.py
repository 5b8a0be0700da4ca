"""The port's tracing, on the CPU.

``trace`` writes a Chrome trace with one range per ``step_range``;
``step_summary`` reads each step back (on the CPU no kernel is launched:
device time and launches are 0); ``Experiment(profile=True)`` traces the
first train epoch, one range per train step; a trace that cannot be written
raises instead of passing silently (the JAX package's ``trace`` carries on
without one).  ``span`` opens a range only while a profiler records; the
video stream's and the ViT's spans appear nested, in the order the code
runs them.
"""

import json
import time

import numpy as np
import pytest
import torch
from test_torch_experiment import _config

from algonauts2025_tpu.data.synthetic import make_synthetic_study
from algonauts2025_tpu_torch.experiment import Experiment
from algonauts2025_tpu_torch.features.video import TinyVideoBackbone, encode_window_stream
from algonauts2025_tpu_torch.utils import profiling


def _ranges(path) -> list[tuple[str, float, float]]:
    """The (name, start, end) of each profiler range in a written trace, by start."""
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"),
                  key=lambda r: (r[1], -r[2]))


def test_trace_writes_one_range_per_step(tmp_path):
    with profiling.trace(tmp_path / "profile"):
        for i in range(3):
            with profiling.step_range(i):
                x = torch.randn(32, 32, requires_grad=True)
                (x @ x).sum().backward()
            time.sleep(0.01)  # the host's wait before the next step
    path = tmp_path / "profile" / "trace.json"
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"train_step#0", "train_step#1", "train_step#2"} <= names
    steps = profiling.step_summary(path)
    assert [s["step"] for s in steps] == [0, 1, 2]
    assert all(s["host_ms"] > 0 and s["device_ms"] == 0 and s["launches"] == 0
               and s["runtime_ms"] == {} for s in steps)
    assert steps[0]["wait_ms"] == 0 and all(s["wait_ms"] >= 9 for s in steps[1:])


def test_busy_time_counts_overlaps_once():
    assert profiling._busy_ms([(0, 1000), (500, 1500), (3000, 3500)]) == pytest.approx(2.0)
    assert profiling._busy_ms([]) == 0.0


def test_step_summary_attributes_device_work_by_launch(tmp_path):
    """A kernel belongs to the step whose range holds its launch call, even
    when it runs after the range ended; copies count as busy time but not
    as launches."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "train_step#0", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "train_step#1", "ts": 150, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 5,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 20, "dur": 5,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 160, "dur": 5,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 90, "dur": 80, "args": {"correlation": 1}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 170, "dur": 10,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 200, "dur": 40,
         "args": {"correlation": 3}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = profiling.step_summary(path)
    assert got == [
        {"step": 0, "host_ms": 0.1, "wait_ms": 0.0, "device_ms": 0.09, "launches": 1,
         "runtime_ms": {"cudaLaunchKernel": 0.005, "cudaMemcpyAsync": 0.005}},
        {"step": 1, "host_ms": 0.1, "wait_ms": 0.05, "device_ms": 0.04, "launches": 1,
         "runtime_ms": {"cudaLaunchKernel": 0.005}},
    ]


def test_trace_raises_when_nothing_is_written(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace", lambda self, path: None)
    with pytest.raises(RuntimeError, match="wrote no trace"):
        with profiling.trace(tmp_path / "profile"):
            torch.ones(2).sum()


def test_experiment_profile_traces_the_first_epoch(tmp_path):
    study = make_synthetic_study(tmp_path / "data", with_video=False, n_parcels=16,
                                 duration=40.0)
    cfg = _config(tmp_path, study, "profiled")
    cfg.update(profile=True, n_epochs=2, save_checkpoints=False)
    exp = Experiment(**cfg)
    out = exp.run()
    path = tmp_path / "run_profiled" / "profile" / "trace.json"
    steps = profiling.step_summary(path)
    n_batches = len(exp._trainer.history) and exp._trainer.step // 2
    assert len(steps) == n_batches > 0  # the first epoch's steps, not the second's
    assert [s["step"] for s in steps] == list(range(n_batches))
    assert "val/pearson" in out


def test_span_opens_no_range_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    for manager in (profiling.span("video.stack#0"), profiling.step_range(0)):
        with manager:
            torch.ones(2).sum()
    assert opened == []


def test_spans_nest_in_the_trace_with_their_index(tmp_path):
    with profiling.trace(tmp_path):
        with profiling.span("outer#3"):
            with profiling.span("inner#3"):
                torch.ones(4).sum()
            with profiling.step_range(7):
                pass
    ranges = {name: (start, end) for name, start, end in _ranges(tmp_path / "trace.json")}
    assert {"outer#3", "inner#3", "train_step#7"} <= set(ranges)
    (o0, o1), (i0, i1), (s0, s1) = ranges["outer#3"], ranges["inner#3"], ranges["train_step#7"]
    assert o0 <= i0 <= i1 <= s0 <= s1 <= o1


def test_window_stream_spans_in_the_order_the_code_runs_them(tmp_path):
    """Three batches of two windows: each batch's stack and encode (the
    backbone's upload, preprocess and backbone inside it), and the fetch of
    the batch two back (the rest after the last batch); the ViT's spans
    inside each ``video.backbone``."""
    backbone = TinyVideoBackbone(device="cpu")
    windows = [np.full((8, 36, 64, 3), i, np.uint8) for i in range(6)]
    with profiling.trace(tmp_path):
        encode_window_stream(backbone, windows, window_batch=2)
    ranges = _ranges(tmp_path / "trace.json")
    video = [name for name, _, _ in ranges if name.startswith("video.")]
    want = []
    for k in (0, 1, 2):
        want += [f"video.stack#{k}", f"video.encode#{k}", "video.upload", "video.preprocess", "video.backbone"]
        want += ["video.fetch#0"] if k == 2 else []
    assert video == want + ["video.fetch#1", "video.fetch#2"]
    for k in (0, 1, 2):
        encode = [(s, e) for n, s, e in ranges if n == f"video.encode#{k}"][0]
        inner = [n for n, s, e in ranges if n.startswith("video.") and encode[0] <= s and e <= encode[1]]
        assert inner == [f"video.encode#{k}", "video.upload", "video.preprocess", "video.backbone"]
    n_layers = len(backbone.model.layers)
    for name, start, end in ranges:
        if name == "video.backbone":
            inside = [n for n, s, e in ranges if n.startswith("vit.") and start <= s and e <= end]
            assert inside == ["vit.embed", "vit.rope"] + ["vit.attention", "vit.mlp"] * n_layers + ["vit.final"]
