"""One run of one cell: set-up, the measured window, the check, the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``
names its configuration (``benchmark/configs/<config>.json``) and its traffic
(``benchmark/traffic/<traffic>.json``); the traffic file names the driver
that runs it (``benchmark/drivers/<driver>.py``); each metric the cell
reports is read by ``benchmark/metrics/<metric>.py``; the limits of its
check are ``benchmark/limits/<cell>.json``.  A later cell, configuration,
traffic mix or metric is a new file and a new entry, never an edit here.

A driver module has ``Driver(run)``, which builds the system under test,
and its methods ``prepare()`` (the first, checked steps and the warm-up; the
rest of set-up), ``window(seconds, tracer)`` (runs the
measured window and returns the work done in it), ``release()`` (frees the
program's state) and ``numbers()`` (the numbers compared against the plain
reference, by name; each is held to its limit).  The module may also have
``control(run)`` (the same numbers with each control in the program's
place, by the control's name)
and ``FAULTS`` (name -> a patch that breaks the timed path), which
``readings.py`` and the tests use.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
import typing as tp
from pathlib import Path

import torch

from .common.trace import Trace, Tracer

ROOT = Path(__file__).resolve().parent
#: modules that may not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "algonauts2025_tpu")


def load_module(path: Path):
    """The Python file ``path`` as a module (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.parent.name}_{path.stem}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Run:
    """What one run knows: the cell and its files, and what it measured."""

    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: torch.device
    #: ``torch.cuda.get_device_name()`` ("cpu" off the card): the peak table's key
    device_name: str = "cpu"
    setup_s: float = math.nan
    window_s: float = math.nan
    #: what the window completed, in the cell driver's units ("steps", "windows", ...)
    work: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    trace: Trace | None = None


def cell_metrics(spec: dict, name: str, trace: bool) -> list[dict]:
    """The metrics cell ``name`` reports: its end-to-end metrics, or with
    ``trace`` its per-layer metrics."""
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in reported else [])]


def forbidden_modules() -> list[str]:
    return sorted({key.split(".")[0] for key in sys.modules} & set(FORBIDDEN))


def execute(spec: dict, name: str, seed: int, seconds: float, trace: bool,
            device: torch.device, started: float, root: Path = ROOT,
            patch: tp.Callable[[tp.Any], None] | None = None) -> tuple[dict, list[tuple[str, float, float]]]:
    """Run cell ``name`` once; returns the result line (without the checks)
    and the checks.  ``patch(driver)``, for tests, changes the built driver
    before its window."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    traffic = read_json(root / "traffic" / f"{cell['traffic']}.json")
    config = read_json(root / "configs" / f"{cell['config']}.json")
    limits = read_json(root / "limits" / f"{name}.json")
    driver_module = load_module(root / "drivers" / f"{traffic['driver']}.py")
    metrics = cell_metrics(spec, name, trace)
    readers = {m["name"]: load_module(root / "metrics" / f"{m['name']}.py") for m in metrics}

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    run = Run(name=name, cell=cell, config=config, traffic=traffic, seed=seed,
              seconds=seconds, device=device, device_name=kind)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    driver = driver_module.Driver(run)
    if patch is not None:
        patch(driver)
    driver.prepare()
    tracer = Tracer(trace)
    run.setup_s = time.perf_counter() - started
    run.work = driver.window(seconds, tracer)
    run.window_s = run.work.pop("window_s")
    run.trace = tracer.trace
    if device.type == "cuda":
        torch.cuda.synchronize()
        run.peak_bytes = torch.cuda.max_memory_allocated()
    driver.release()
    checks = [(key, value, limits[key]) for key, value in driver.numbers().items()]

    values = {}
    for m in metrics:
        value = readers[m["name"]].read(run)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    # last, once the reference and every reader have run: what the port or
    # a library loaded at any time after the window counts too
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the process holds {found} after the window; the benchmark runs without JAX")
    result = {
        "correct": all(math.isfinite(v) and v <= lim for _, v, lim in checks),
        "attempted": run.work.get("attempted", 0),
        "failed": run.work.get("failed", 0),
        "metrics": values,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
                   "count": cell["chips"], "memory_peak_bytes": run.peak_bytes},
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    return result, checks


def emit(result: dict, checks: list[tuple[str, float, float]]) -> None:
    """The checks as the last lines of stderr, and the result as the last
    line of stdout with the checks under its last key."""
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    # a number that is not finite has failed; JSON has no spelling for it
    line = {**result, "checks": {name: {"value": v if math.isfinite(v) else repr(v), "limit": lim}
                                 for name, v, lim in checks}}
    print(json.dumps(line), flush=True)
