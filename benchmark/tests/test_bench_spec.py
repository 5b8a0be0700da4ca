"""BENCHMARK.json and the files it names: present, well formed, found by name."""

from __future__ import annotations

import json
import re
import shutil
import time

import pytest
import torch

from conftest import BENCH, ROOT, spec, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert s["command"] == ["python3", "benchmark/run.py"] and s["paths"] == ["benchmark"]
    assert 1 <= s["run_seconds"] <= 51 and isinstance(s["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    s = spec()
    names = [x["name"] for part in ("configs", "workloads", "end_to_end", "per_layer") for x in s[part]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(x["name"] for x in s["end_to_end"] + s["per_layer"])) == len(s["end_to_end"] + s["per_layer"])
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in s["workloads"]:
        assert NAME.match(c["config"]) and NAME.match(c["traffic"]) and c["chips"] in (1, 4)
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    for m in s["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and m["source"] in ("device_trace", "program_span", "program_counter",
                                                                 "host_clock")
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", [c["name"] for c in spec()["workloads"]])
def test_cell_files_exist(cell):
    s = spec()
    c = next(x for x in s["workloads"] if x["name"] == cell)
    config = next(x for x in s["configs"] if x["name"] == c["config"])
    assert (ROOT / config["file"]).is_file() and config["file"].startswith("benchmark/configs/")
    traffic = json.loads((BENCH / "traffic" / f"{c['traffic']}.json").read_text())
    assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    assert limits and all(v > 0 for v in limits.values())
    from benchmark.harness import cell_metrics

    e2e = {m["name"] for m in cell_metrics(s, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = cell_metrics(s, cell, True)
    assert per_layer and all(m["moves"] in e2e for m in per_layer)
    for m in cell_metrics(s, cell, False) + per_layer:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_every_config_is_used_and_layers_are_named_alike():
    s = spec()
    assert {c["name"] for c in s["configs"]} == {w["config"] for w in s["workloads"]}
    from benchmark.harness import load_module

    for m in s["per_layer"]:
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py")
        assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"]


def test_a_cell_added_as_files_alone_runs(tmp_path):
    """A new cell, configuration, traffic kind and metric, added as new files
    and new entries only, is found and run by the harness unchanged."""
    from benchmark import harness

    root = tiny_root(tmp_path)
    (root / "configs" / "dummy.json").write_text(json.dumps({"size": 64}))
    (root / "traffic" / "dummy_loop.json").write_text(json.dumps({"driver": "dummy_loop", "steps": 3}))
    (root / "limits" / "dummy_loop.tiny.json").write_text(json.dumps({"sum_gap": 1e-6}))
    (root / "drivers" / "dummy_loop.py").write_text('''
import time, torch

class Driver:
    def __init__(self, run):
        self.run = run
        self.x = torch.ones(run.config["size"])
    def prepare(self):
        pass
    def window(self, seconds, tracer):
        t0 = time.perf_counter()
        with tracer.window():
            for _ in range(self.run.traffic["steps"]):
                self.x = self.x * 1.0
        return {"window_s": time.perf_counter() - t0, "steps": 3, "attempted": 3, "failed": 0}
    def release(self):
        pass
    def numbers(self):
        return {"sum_gap": abs(float(self.x.sum()) - self.run.config["size"])}
''')
    (root / "metrics" / "dummy_rate.py").write_text(
        "def read(run):\n    return run.work['steps'] / run.window_s\n")
    s = spec()
    s["configs"].append({"name": "dummy", "source": "https://example.org", "file": "benchmark/configs/dummy.json",
                         "reduced": [], "why": "a test"})
    s["workloads"].append({"name": "dummy_loop.tiny", "config": "dummy", "traffic": "dummy_loop", "chips": 1,
                           "why": "a test"})
    s["end_to_end"].append({"name": "dummy_rate", "unit": "steps/s", "better": "higher", "bound": 0.05,
                            "source": "host_clock", "workloads": ["dummy_loop.tiny"]})
    result, checks = harness.execute(s, "dummy_loop.tiny", 7, 0.1, False, torch.device("cpu"),
                                     time.perf_counter(), root=root)
    assert result["correct"] and set(result["metrics"]) == {"dummy_rate", "setup_s"}
    assert checks == [("sum_gap", 0.0, 1e-6)]


def test_a_forbidden_module_loaded_after_the_window_refuses_the_result(tmp_path, monkeypatch):
    """A module of JAX loaded by the check or a metric's reader, after the
    window, stops the run before it has a result."""
    import sys
    import types

    from benchmark import harness

    root = tiny_root(tmp_path)
    (root / "metrics" / "feature_stim_s_per_s.py").write_text(
        "import sys, types\n"
        "def read(run):\n"
        "    sys.modules['jax'] = types.ModuleType('jax')\n"
        "    return 1.0\n")
    # recorded, then taken out: the test's end leaves ``jax`` as it found it
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.delitem(sys.modules, "jax")
    with pytest.raises(SystemExit, match="jax"):
        harness.execute(spec(), "video_windows.vitg", 7, 0.1, False, torch.device("cpu"), time.perf_counter(),
                        root=root)


def test_run_refuses_without_a_card_and_prints_nothing(tmp_path):
    """``run.py`` exits non-zero and prints no result without CUDA, and in a
    directory that holds only BENCHMARK.json and the benchmark's files."""
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "video_windows.vitg", "--seed",
                           "4000000000", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    alone = tmp_path / "alone"
    shutil.copytree(BENCH, alone / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", alone)
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "video_windows.vitg", "--seed",
                           "1", "--seconds", "1", "--trace", "0"], cwd=alone, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
