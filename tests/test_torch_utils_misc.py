"""The port's twin of the prefetch and tracking cases of
tests/test_utils_misc.py, over algonauts2025_tpu_torch's copies; plus the
port's own prefetch contract (explicit device, composes with ``to_device``)."""

import json
import sys

import numpy as np
import pytest
import torch

from algonauts2025_tpu_torch.data.dataset import SegmentData, prefetch_to_device, to_device
from algonauts2025_tpu_torch.experiment.tracking import WandbLoggerConfig


def _batches(n=3, b=2):
    for i in range(n):
        yield SegmentData(
            data={"x": np.full((b, 4), float(i), np.float32)},
            segments=[None] * b,
        )


def test_prefetch_to_device_order_and_content():
    out = list(prefetch_to_device(_batches(), "cpu", size=2))
    assert len(out) == 3
    for i, batch in enumerate(out):
        np.testing.assert_allclose(np.asarray(batch.data["x"]), float(i))


def test_prefetch_propagates_errors():
    def bad():
        yield from _batches(1)
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(prefetch_to_device(bad(), "cpu"))


def test_local_run_logger(tmp_path):
    logger = WandbLoggerConfig(offline=True, project="p").build(
        save_dir=tmp_path, xp_config={"a": 1}, id="run1"
    )
    logger.log({"loss": 1.0, "pearson": 0.5}, step=3)
    logger.finish()
    lines = [json.loads(l) for l in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert lines[0]["loss"] == 1.0 and lines[0]["_step"] == 3
    assert json.loads((tmp_path / "run_config.json").read_text()) == {"a": 1}


class _FakeWandbRun:
    def __init__(self, kwargs):
        self.init_kwargs = kwargs
        self.logged: list = []
        self.finished = False

    def log(self, metrics, step=None):
        self.logged.append((dict(metrics), step))

    def finish(self):
        self.finished = True


class _FakeWandb:
    """Stand-in for the wandb package (absent in this image): records the
    init/log/finish surface the mirror path drives (reference
    modeling_utils/utils.py:163-210 runs the real one via Lightning)."""

    def __init__(self, fail_init=False):
        self.fail_init = fail_init
        self.runs: list = []

    def init(self, **kwargs):
        if self.fail_init:
            raise RuntimeError("api key missing")
        run = _FakeWandbRun(kwargs)
        self.runs.append(run)
        return run


def test_wandb_mirror_executes(tmp_path, monkeypatch):
    fake = _FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    logger = WandbLoggerConfig(project="p", group="g", name="n").build(
        save_dir=tmp_path, xp_config={"a": 1}, id="run1"
    )
    logger.log({"loss": 2.0}, step=7)
    logger.finish()
    (run,) = fake.runs
    assert run.init_kwargs["project"] == "p"
    assert run.init_kwargs["group"] == "g"
    assert run.init_kwargs["id"] == "run1"
    assert run.init_kwargs["config"] == {"a": 1}
    assert run.logged == [({"loss": 2.0}, 7)]
    assert run.finished
    # the JSONL stream is written regardless of the mirror
    lines = [json.loads(l) for l in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert lines[0]["loss"] == 2.0 and lines[0]["_step"] == 7


def test_wandb_offline_skips_init(tmp_path, monkeypatch):
    fake = _FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    logger = WandbLoggerConfig(offline=True, project="p").build(save_dir=tmp_path)
    logger.log({"loss": 1.0}, step=0)
    logger.finish()
    assert fake.runs == []


def test_wandb_init_failure_warns_and_falls_back(tmp_path, monkeypatch, caplog):
    fake = _FakeWandb(fail_init=True)
    monkeypatch.setitem(sys.modules, "wandb", fake)
    with caplog.at_level("WARNING", logger="algonauts2025_tpu_torch.experiment.tracking"):
        logger = WandbLoggerConfig(project="p").build(save_dir=tmp_path)
    assert any("wandb.init failed" in r.message for r in caplog.records)
    logger.log({"loss": 3.0}, step=1)  # JSONL path still works
    lines = [json.loads(l) for l in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert lines[0]["loss"] == 3.0


def test_wandb_broken_import_warns_and_falls_back(tmp_path, monkeypatch, caplog):
    """An importable-but-broken wandb (the classic protobuf-mismatch
    TypeError at import time) must degrade to JSONL-only with a warning,
    not take the run down (r4 review: the guard only caught ImportError)."""
    import importlib.abc
    import importlib.machinery

    monkeypatch.delitem(sys.modules, "wandb", raising=False)

    class _BoomLoader(importlib.abc.Loader):
        def create_module(self, spec):
            return None

        def exec_module(self, module):
            raise TypeError("descriptors cannot be created directly")

    class _Finder(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name == "wandb":
                return importlib.machinery.ModuleSpec("wandb", _BoomLoader())
            return None

    finder = _Finder()
    sys.meta_path.insert(0, finder)
    try:
        with caplog.at_level("WARNING", logger="algonauts2025_tpu_torch.experiment.tracking"):
            logger = WandbLoggerConfig(project="p").build(save_dir=tmp_path)
    finally:
        sys.meta_path.remove(finder)
        sys.modules.pop("wandb", None)
    assert any("wandb import failed" in r.message for r in caplog.records)
    logger.log({"loss": 4.0}, step=2)  # JSONL path still works
    lines = [json.loads(l) for l in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert lines[0]["loss"] == 4.0


def test_prefetch_yields_tensors_that_to_device_keeps():
    """The trainer's ``to_device`` leaves a prefetched batch where it is:
    the same tensor objects come back, so nothing is copied twice."""
    (batch,) = list(prefetch_to_device(_batches(1), torch.device("cpu")))
    x = batch.data["x"]
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    assert to_device(batch.data, "cpu")["x"] is x
    assert batch.segments == [None, None]
