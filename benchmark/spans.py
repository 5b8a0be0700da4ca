"""The program's spans in traced runs of a cell: where the card's idle time,
the host's waits on the card and the glue kernels' device time go.

    python3 benchmark/spans.py --workload video_windows.vitg --seeds 1,2 \
        [--seconds 40] [--out file.jsonl]

Each seed is one run as ``run.py --trace 1`` makes it (set-up, the traced
window, the check), one after the other in this process, with the
profiler's events kept for ``common/program_trace.py``.  One JSON line a
run, on stdout and in ``--out``: the run's result line under ``result``,
and under ``program`` the four quantities a window batch
(``ProgramTrace.per_batch``) and, a batch and by the innermost program
span, the device's idle ms, the host's ms, the kernels' device ms, the
glue kernels' device ms and the blocking waits, with the longest idle
gaps named by the innermost span open.  Needs the CUDA card, as
``run.py``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def traced_run(spec: dict, workload: str, seed: int, seconds: float, device, root: Path | None = None) -> dict:
    """One traced run of ``workload``: its line (the module's docstring)."""
    from benchmark import harness
    from benchmark.common import program_trace

    started = time.perf_counter()
    kept, work = program_trace.EventTracer(), {}

    def patch(driver) -> None:
        window = driver.window

        def traced(seconds: float, tracer) -> dict:
            work.update(window(seconds, kept))
            tracer.trace = kept.trace
            return dict(work)

        driver.window = traced

    result, checks = harness.execute(spec, workload, seed, seconds, True, device, started,
                                     root=root or harness.ROOT, patch=patch)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    program = program_trace.read(kept.events)
    batches = work.get("batches", 0)

    def per_batch(by_span: dict, scale: float = 1e3) -> dict[str, float]:
        return {name: scale * v / batches for name, v in sorted(by_span.items(), key=lambda kv: -kv[1])}

    kernels = program.device_by_span()
    return {
        "workload": workload, "seed": seed, "batches": batches, "window_s": work.get("window_s"),
        "stim_s_per_s": work["stim_s"] / work["window_s"] if work.get("stim_s") else None,
        "result": result,
        "program": {
            "per_batch": program.per_batch(batches),
            "idle_ms": per_batch(program.idle_by_span()),
            "host_ms": per_batch(program.host_by_span()),
            "kernel_ms": per_batch(kernels["all"]),
            "glue_ms": per_batch(kernels["glue"]),
            "waits": per_batch(program.waits_by_span(), 1.0),
            "idle_gaps": program.named_gaps(),
        } if batches else None,
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=seeds, required=True)
    parser.add_argument("--seconds", type=float, default=40.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("spans need the CUDA card", file=sys.stderr)
        return 3
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            line = traced_run(spec, args.workload, seed, args.seconds, torch.device("cuda"))
            text = json.dumps({**line, "card": torch.cuda.get_device_name()})
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
