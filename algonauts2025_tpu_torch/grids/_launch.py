"""The shared command line of the grid entry points (run_grid / run_ensemble).

The port of algonauts2025_tpu/grids/_launch.py: each sweep is a small
argparse CLI over the default config, fanned out through
``experiment.grid.run_grid`` (in-process, a thread pool, or one job per
config through the external launcher).
"""

from __future__ import annotations

import argparse
import typing as tp

from ..config import ConfDict
from .defaults import PROJECT_NAME, SAVEDIR, default_config


def sweep_parser(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--dry-run", action="store_true",
                        help="enumerate configs without launching")
    parser.add_argument("--overwrite", action="store_true", help="clear existing run folders")
    parser.add_argument("--non-interactive", action="store_true",
                        help="never prompt before overwriting")
    parser.add_argument("--infra-mode", default="force", choices=("cached", "force", "retry"),
                        help="task-cache mode for each run")
    parser.add_argument("--savedir", default=SAVEDIR, help="grid output root")
    return parser


def launch_sweep(
    sweep_name: str,
    grid: tp.Dict[str, list],
    *,
    base_update: tp.Optional[dict] = None,
    sample: tp.Optional[int] = None,
    seed: tp.Optional[int] = None,
    args: tp.Optional[argparse.Namespace] = None,
) -> list:
    """Expand ``grid`` over the default config (updated with
    ``base_update``) and launch one run each; no checkpoints are written."""
    from ..experiment import Experiment
    from ..experiment.grid import run_grid

    if args is None:
        args = sweep_parser(sweep_name).parse_args([])
    config = ConfDict(default_config)
    config.update(
        {
            "infra": {"cluster": None, "folder": args.savedir, "job_name": PROJECT_NAME},
            "wandb_config.group": sweep_name,
            "save_checkpoints": False,
        }
    )
    if base_update:
        config.update(base_update)
    return run_grid(
        Experiment,
        sweep_name,
        config.to_dict(),
        grid,
        job_name_keys=["wandb_config.name", "infra.job_name"],
        combinatorial=True,
        n_randomly_sampled=sample,
        seed=seed,
        overwrite=args.overwrite,
        dry_run=args.dry_run,
        infra_mode=args.infra_mode,
        interactive=not args.non_interactive,
    )
