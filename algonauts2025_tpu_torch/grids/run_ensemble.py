"""Model-soup ensemble fan-out (the reference grids/run_ensemble.py values).

    python -m algonauts2025_tpu_torch.grids.run_ensemble [--n-models 1000] [--sample-seed S]

The port of algonauts2025_tpu/grids/run_ensemble.py: samples configs from
the soup grid (layers, loss, aggregations, dropout, subject embedding) and
launches one run per sample; combine them afterwards with
``grids.average_submissions``.  The soup has 768 points: a larger
``--n-models`` (the default 1000 included) samples all of them, with a
warning (the JAX package's run_grid refuses it).
"""

from __future__ import annotations

import logging
import math

from ._launch import launch_sweep, sweep_parser
from .run_grid import LAYER_CHOICES

logger = logging.getLogger(__name__)

SWEEP = "model_soup"

#: the soup's sampling space (reference run_ensemble.py values)
SOUP_GRID = {
    "data.layers": LAYER_CHOICES,
    "loss.name": ["MSELoss", "PearsonLoss", "SmoothL1Loss", "HuberLoss"],
    "data.layer_aggregation": [None, "group_mean"],
    "brain_model_config.subject_embedding": [True, False],
    "brain_model_config.layer_aggregation": ["cat", "mean"],
    "brain_model_config.feature_aggregation": ["cat", "sum"],
    "brain_model_config.modality_dropout": [0.0, 0.2, 0.4],
}


def main(argv: list[str] | None = None, base_update: dict | None = None) -> list:
    """``base_update``: dotted-key overrides of the default config, applied
    after the soup's own (seed and patience off)."""
    parser = sweep_parser("model-soup ensemble sweep")
    parser.add_argument("--n-models", type=int, default=1000, help="number of sampled configs")
    parser.add_argument("--sample-seed", type=int, default=None)
    args = parser.parse_args(argv)
    n_points = math.prod(len(v) for v in SOUP_GRID.values())
    if args.n_models > n_points:
        logger.warning("--n-models %d exceeds the soup's %d configs: sampling all of them",
                       args.n_models, n_points)
    return launch_sweep(
        SWEEP,
        dict(SOUP_GRID),
        base_update={"seed": None, "patience": None, **(base_update or {})},
        sample=min(args.n_models, n_points),
        seed=args.sample_seed,
        args=args,
    )


if __name__ == "__main__":
    main()
