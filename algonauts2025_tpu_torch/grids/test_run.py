"""Smoke run: the full trimodal pipeline on a small slice.

    python -m algonauts2025_tpu_torch.grids.test_run [--device cpu]

The port's copy of the JAX package's ``grids/test_run.py``.  With real
Algonauts data present (ALGONAUTS_TPU_DATA), the reference smoke recipe
runs (10 timelines, 6 epochs, no checkpoints).  Without it, a synthetic
study (data/synthetic.py) plus the tiny random backbones exercise the
complete path (study build, enhancers, the text, audio and video feature
caches, training, metrics, submission) in minutes.  The trainer and the
backbones run on the CUDA card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import argparse
import copy
import os
import shutil
from pathlib import Path

from ..config import ConfDict
from .defaults import default_config

FEATURES = ("text_feature", "audio_feature", "video_feature")

_SMOKE_OVERRIDES = {
    "save_checkpoints": False,
    "n_epochs": 6,
    "infra.cluster": None,
    "infra.mode": "force",
    "data.num_workers": 0,
    "data.study.query": "subject_timeline_index<10",
    "wandb_config": None,
}

_TINY_BACKBONES = {
    "data.text_feature.model_name": "tiny-random",
    "data.audio_feature.model_name": "tiny-random",
    "data.video_feature.model_name": "tiny-random",
    "brain_model_config.hidden": 96,
    "brain_model_config.depth": 2,
    "brain_model_config.heads": 4,
    "n_epochs": 4,
}


def _synthesize_if_needed(cfg: ConfDict, tmp_root: str | None) -> None:
    """Point the config at a generated study when no real dataset exists."""
    if (Path(cfg["data.study.path"]) / "download").exists():
        return
    from ..data.synthetic import make_synthetic_study

    root = Path(tmp_root or os.path.join(cfg["infra.folder"], "synthetic_data"))
    cfg.update(dict(_TINY_BACKBONES))
    cfg["data.study.path"] = str(make_synthetic_study(root, with_video=True))
    # the defaults declare num_outputs=1000 (the real dataset's parcel
    # count, validated at update time); the synthetic study has fewer
    # parcels, so the metrics infer the voxel dim.  Copy before popping:
    # ConfDict holds the metrics list (and its dicts) by reference to
    # defaults.default_config, which must stay as it is
    metrics = copy.deepcopy(cfg.get("metrics", []))
    for metric in metrics:
        if isinstance(metric, dict):
            metric.get("kwargs", {}).pop("num_outputs", None)
    cfg["metrics"] = metrics


def build_test_config(tmp_root: str | None = None, device: str = "cuda") -> dict:
    """The smoke config; ``device`` ("cuda" or "cpu") places the trainer and
    the three backbones."""
    cfg = ConfDict(default_config)
    cfg.update(dict(_SMOKE_OVERRIDES))
    _synthesize_if_needed(cfg, tmp_root)
    run_folder = os.path.join(cfg["infra"]["folder"], "test")
    cfg["infra.folder"] = run_folder
    cfg["data.study.infra.folder"] = os.path.join(run_folder, "study_cache")
    for feature in (*FEATURES, "neuro"):
        cfg[f"data.{feature}.infra.folder"] = os.path.join(run_folder, "feature_cache")
    cfg["accelerator"] = device
    for feature in FEATURES:
        cfg[f"data.{feature}.device"] = device
    return cfg.to_dict()


def test_run(config: dict) -> dict:
    from ..experiment import Experiment

    experiment = Experiment(**config)
    experiment.infra.clear_job()
    return experiment.run()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    smoke_config = build_test_config(device=parser.parse_args().device)
    stale = smoke_config["infra"]["folder"]
    if os.path.exists(stale):
        shutil.rmtree(stale)
    print(test_run(smoke_config))
