"""Grid fan-out: config product -> uid folders -> task array.

The port of algonauts2025_tpu/experiment/grid.py (the reference's
modeling_utils run_grid, whose Slurm job array becomes a TaskInfra job
array: in-process, a thread pool, or one job per config through the
external launcher, ``cache.task_cache.TaskInfra._launch_external``).
"""

from __future__ import annotations

import logging
import random
import shutil
import typing as tp
from itertools import product
from pathlib import Path

from ..config.confdict import ConfDict

logger = logging.getLogger(__name__)

__all__ = ["run_grid"]


def run_grid(
    exp_cls: type,
    exp_name: str,
    base_config: dict[str, tp.Any],
    grid: dict[str, list],
    n_randomly_sampled: int | None = None,
    job_name_keys: list[str] | None = None,
    combinatorial: bool = False,
    overwrite: bool = False,
    dry_run: bool = False,
    infra_mode: str = "retry",
    seed: int | None = None,
    interactive: bool = True,
) -> list[ConfDict]:
    """Launch one experiment per grid point; returns the configs.

    ``combinatorial``: the product of every axis, else one axis varied at a
    time; ``n_randomly_sampled``: that many points drawn without
    replacement with ``random.Random(seed)``.  Each point runs in
    ``<infra.folder>/<exp_name>/<uid of its params>``; ``dry_run`` only
    enumerates the configs (no experiment is built, no data read)."""
    base = ConfDict(base_config)
    base["infra.job_name"] = exp_name
    base_config = base.to_dict()  # per-task configs inherit the job name
    base_folder = Path(base["infra"]["folder"])
    if not all(isinstance(v, list) for v in grid.values()):
        raise ValueError("Grid values must be lists.")

    if combinatorial:
        grid_product = [dict(zip(grid.keys(), v)) for v in product(*grid.values())]
    else:
        grid_product = [{param: value} for param, values in grid.items() for value in values]
    if n_randomly_sampled is not None:
        if n_randomly_sampled > len(grid_product):
            raise ValueError(
                f"n_randomly_sampled={n_randomly_sampled} exceeds the "
                f"{len(grid_product)} grid points"
            )
        grid_product = random.Random(seed).sample(grid_product, n_randomly_sampled)

    logger.info("Launching %d tasks", len(grid_product))

    def _expand(params: dict) -> ConfDict | None:
        job_name = ConfDict(params).to_uid()
        config = ConfDict(base_config)
        config.update(params)
        folder = base_folder / exp_name / job_name
        if folder.exists():
            logger.info("%s already exists.", folder)
            if overwrite and not dry_run:
                if interactive:
                    print(f"Folder {folder} exists. Overwrite? (y/n)")
                    if input().lower() != "y":
                        return None
                shutil.rmtree(folder)
                folder.mkdir()
        config["infra.folder"] = str(folder)
        config["infra.mode"] = infra_mode
        for key in job_name_keys or []:
            config.update({key: str(job_name)})
        return config

    if dry_run:
        out_configs = [c for c in map(_expand, grid_product) if c is not None]
        logger.info("Dry run: %d configs.", len(out_configs))
        return out_configs

    template = exp_cls(**ConfDict(base_config).to_dict())
    template.infra.mode = infra_mode
    out_configs = []
    with template.infra.job_array() as tasks:
        for params in grid_product:
            config = _expand(params)
            if config is None:
                continue
            tasks.append(exp_cls(**config.to_dict()))
            out_configs.append(config)
    logger.info("Done.")
    return out_configs
