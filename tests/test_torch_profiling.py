"""The port's tracing and stage timing, on the CPU.

``trace`` writes a Chrome trace with one range per ``step_range``;
``step_summary`` reads each step back (on the CPU no kernel is launched:
device time and launches are 0); ``Experiment(profile=True)`` traces the
first train epoch, one range per train step; a trace that cannot be written
raises instead of passing silently (the JAX package's ``trace`` carries on
without one).  ``StageTimer`` is the twin of tests/test_infra_units.py's.
"""

import json
import time

import pytest
import torch
from test_torch_experiment import _config

from algonauts2025_tpu.data.synthetic import make_synthetic_study
from algonauts2025_tpu_torch.experiment import Experiment
from algonauts2025_tpu_torch.utils import profiling


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


def test_stage_timer():
    timer = profiling.StageTimer()
    with timer.stage("decode"):
        time.sleep(0.01)
    with timer.stage("decode"):
        time.sleep(0.01)
    with timer.stage("encode"):
        time.sleep(0.005)
    for _ in timer.wrap("iter", range(3)):
        pass
    report = timer.summary()
    assert report["decode"]["total_s"] >= 0.02 and report["decode"]["count"] == 2
    assert report["encode"]["total_s"] >= 0.005
    assert report["iter"]["count"] == 3
    assert set(report) == {"decode", "encode", "iter"}
