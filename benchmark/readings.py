"""The readings a cell's limits are set from, many seeds in one process.

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault half_batch --fault-seeds 7,8,9] \
        [--seconds 2] [--set key=value ...] [--out file.jsonl]

For each seed of ``--seeds``: the cell's system is built, prepared and run
for a short window at the cell's own load, then its compared numbers are
read against the reference (the lower readings).  For each of
``--control-seeds``: each of the cell driver's controls (the reference in a
lower precision in the program's place: the upper readings), a line each.
For each of ``--fault-seeds``: the program with ``--fault`` planted before
its first step (a training cell's fault readings).  ``--set`` changes a key of the
configuration (dotted), to show a fault of the program.  One JSON line a
reading, on stdout and in ``--out``.  Needs the CUDA card, as ``run.py``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=seeds, default=[])
    parser.add_argument("--control-seeds", type=seeds, default=[])
    parser.add_argument("--fault")
    parser.add_argument("--fault-seeds", type=seeds, default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--set", action="append", default=[])
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("readings need the CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(c for c in spec["workloads"] if c["name"] == args.workload)
    config = harness.read_json(harness.ROOT / "configs" / f"{cell['config']}.json")
    traffic = harness.read_json(harness.ROOT / "traffic" / f"{cell['traffic']}.json")
    for item in args.set:
        key, value = item.split("=", 1)
        *path, last = key.split(".")
        node = config
        for part in path:
            node = node[part]
        node[last] = json.loads(value)
    module = harness.load_module(harness.ROOT / "drivers" / f"{traffic['driver']}.py")
    out = open(args.out, "a") if args.out else None

    def emit(kind: str, seed: int, numbers: dict, started: float) -> None:
        line = json.dumps({"workload": args.workload, "kind": kind, "seed": seed, "set": args.set,
                           "numbers": numbers, "seconds": time.perf_counter() - started,
                           "card": torch.cuda.get_device_name()})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def new_run(seed: int) -> harness.Run:
        return harness.Run(name=args.workload, cell=cell, config=config, traffic=traffic, seed=seed,
                           seconds=args.seconds, device=device, device_name=torch.cuda.get_device_name())

    def program(seed: int, fault: str | None) -> dict:
        driver = module.Driver(new_run(seed))
        if fault:
            module.FAULTS[fault](driver)
        driver.prepare()
        if not fault:
            driver.window(args.seconds, harness.Tracer(False))
        driver.release()
        return driver.numbers()

    try:
        for kind, run_seeds in (("program", args.seeds), ("control", args.control_seeds),
                                (f"fault:{args.fault}", args.fault_seeds)):
            for seed in run_seeds:
                started = time.perf_counter()
                if kind == "control":
                    for name, numbers in module.control(new_run(seed)).items():
                        emit(f"control:{name}", seed, numbers, started)
                else:
                    emit(kind, seed, program(seed, args.fault if kind != "program" else None), started)
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
