"""Run one cell of the benchmark once, on the CUDA card of this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: reads ``BENCHMARK.json`` there, builds the
cell's system from the seed, warms it up, measures ``--seconds`` seconds,
checks what the window produced against the plain reference, and prints
the result as one JSON line, last on stdout (``harness.emit``).  With
``--trace 1`` the window runs under ``torch.profiler`` and the line carries
the per-layer metrics instead of the end-to-end ones.  Without a CUDA card
(or with fewer cards than the cell asks for) it exits non-zero and prints
no result.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # the kernels' build directory is the port's own, inside the checkout
    # (``algonauts2025_tpu_torch/_build``); transformers must not load JAX
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((c for c in spec["workloads"] if c["name"] == args.workload), None)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
        return 3
    result, checks = harness.execute(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                                     torch.device("cuda"), STARTED)
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
