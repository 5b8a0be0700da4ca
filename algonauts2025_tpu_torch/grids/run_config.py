"""Run a single Experiment from a JSON config file.

    python -m algonauts2025_tpu_torch.grids.run_config /path/to/task_00000.json

The entry point the external launcher (ALGONAUTS_TPU_LAUNCHER, for
``infra.cluster="external"``) invokes for each element of a job array.
The port runs one process on one device: a multi-process launch
(``WORLD_SIZE`` above 1, or a coordinator address) raises until the
parallel strategies are ported (ROADMAP queue 1 item 6).
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

from ..experiment import Experiment


def _check_single_process() -> None:
    world = int(os.environ.get("WORLD_SIZE", "1") or "1")
    coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get("MASTER_ADDR")
    if world > 1 or coordinator:
        raise NotImplementedError(
            f"WORLD_SIZE={world}, coordinator={coordinator!r}: multi-process runs are not "
            "ported yet (ROADMAP queue 1 item 6, parallel strategies)"
        )


def main(path: str) -> None:
    _check_single_process()
    config = json.loads(Path(path).read_text())
    out = Experiment(**config).run()
    print(json.dumps(out, default=str))


def cli(argv: list[str] | None = None) -> None:
    """Console-script entry (``algonauts-tpu-torch-run-config <config.json>``)."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit("usage: algonauts-tpu-torch-run-config <config.json>")
    main(argv[0])


if __name__ == "__main__":
    cli()
