"""Run a single Experiment from a JSON config file.

    python -m algonauts2025_tpu_torch.grids.run_config /path/to/task_00000.json

The entry point the external launcher (ALGONAUTS_TPU_LAUNCHER, for
``infra.cluster="external"``) invokes for each element of a job array.
Under ``torchrun --nproc-per-node N`` each of the N processes runs it: it
joins the launch's process group first (``parallel.init_distributed``:
NCCL on the card, gloo for ``accelerator="cpu"``), and the Experiment's
``n_devices`` must then be N.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from ..experiment import Experiment
from ..parallel.mesh import init_distributed


def main(path: str) -> None:
    config = json.loads(Path(path).read_text())
    init_distributed(device="cpu" if config.get("accelerator") == "cpu" else None)
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
