"""Layer x seed hyperparameter sweep (the reference grids/run_grid.py values).

    python -m algonauts2025_tpu_torch.grids.run_grid [--dry-run] [--seeds 5]

The port of algonauts2025_tpu/grids/run_grid.py.  Set
``infra.cluster="external"`` and ALGONAUTS_TPU_LAUNCHER in the base config
for one job per run (each running ``grids.run_config``).
"""

from __future__ import annotations

from ._launch import launch_sweep, sweep_parser

SWEEP = "grid"

#: fractional-depth layer selections swept against seeds
LAYER_CHOICES = [
    [0.0, 0.5, 1.0],
    [0.5, 0.75, 1.0],
    [0.5, 1.0],
    [0.0, 0.2, 0.4, 0.6, 0.8, 1.0],
]


def main(argv: list[str] | None = None, base_update: dict | None = None) -> list:
    """``base_update``: dotted-key overrides of the default config (the
    study, caches and devices of an in-process caller)."""
    parser = sweep_parser("layers x seed sweep")
    parser.add_argument("--seeds", type=int, default=5, help="number of seeds")
    args = parser.parse_args(argv)
    grid = {"data.layers": LAYER_CHOICES, "seed": list(range(args.seeds))}
    return launch_sweep(SWEEP, grid, base_update=base_update, args=args)


if __name__ == "__main__":
    main()
