"""Default experiment configuration (the port's copy of the JAX package's).

The dotted-key surface (section names, field names, default values) is the
JAX package's and the reference recipe's (grids/defaults.py there): grids
sweep over these exact keys and cached artifacts hash them, so the two
packages share caches.  The assembly below is organized by section; only
the composed ``default_config`` matters.  The trainer and the three frozen
backbones run on the CUDA card (``accelerator`` and each feature's
``device`` keep their defaults).

Paths come from environment variables, the JAX package's names:
- ALGONAUTS_TPU_DATA: dataset root (contains algonauts2025/download/...)
- ALGONAUTS_TPU_SAVE: results root
- ALGONAUTS_TPU_CACHE: feature/study cache root
"""

from __future__ import annotations

import os
from pathlib import Path

PROJECT_NAME = "algonauts-2025"

DATADIR = os.environ.get("ALGONAUTS_TPU_DATA", os.path.expanduser("~/algonauts_data"))
BASEDIR = os.environ.get("ALGONAUTS_TPU_SAVE", os.path.expanduser("~/algonauts_runs"))
CACHEDIR = os.environ.get(
    "ALGONAUTS_TPU_CACHE", os.path.join(BASEDIR, "cache", PROJECT_NAME)
)
SAVEDIR = os.path.join(BASEDIR, "results", PROJECT_NAME)


def _feature(name: str) -> dict:
    """A frozen-backbone feature entry with the shared cache infra."""
    return {
        "name": name,
        "infra": {
            "folder": CACHEDIR,
            "keep_in_ram": True,
            "mode": "cached",
            "version": "final",
        },
    }


text_feature = _feature("LLAMA3p2")
video_feature = _feature("VJEPA2")
audio_feature = _feature("Wav2VecBert")
neuro_feature = _feature("Fmri")

#: host-side event pipeline: transcripts -> sentences -> rolling context,
#: audio demux, 30-60 s stimulus chunking
_ENHANCER_CHAIN = {
    "addtext": {"name": "AddText"},
    "addsentence": {
        "name": "AddSentenceToWords",
        "max_unmatched_ratio": 0.05,
    },
    "addcontext": {
        "name": "AddContextToWords",
        "sentence_only": False,
        "max_context_len": 1024,
    },
    "removemissing": {"name": "RemoveMissing"},
    "extractaudio": {"name": "ExtractAudioFromVideo"},
    "chunkevents": {
        "name": "ChunkEvents",
        "event_type_to_chunk": "Sound",
        "max_duration": 60,
        "min_duration": 30,
    },
}

_DATA = {
    "num_workers": 8,
    "batch_size": 16,
    "study": {
        "path": str(Path(DATADIR) / "algonauts2025"),
        "query": None,
        "infra": {"folder": CACHEDIR},
        "enhancers": _ENHANCER_CHAIN,
    },
    "neuro": neuro_feature,
    "text_feature": text_feature,
    "video_feature": video_feature,
    "audio_feature": audio_feature,
    "layers": [0.5, 0.75, 1.0],
    "layer_aggregation": "group_mean",
}

_MODEL = {
    "name": "FmriEncoder",
    "modality_dropout": 0.3,
    "feature_aggregation": "cat",
    "layer_aggregation": "cat",
    "subject_embedding": False,
    # activation recompute for the 0.9B trunk + Adam
    "remat": True,
    "contrastive_enabled": True,
    "contrastive_modalities": ["video"],
    "contrastive_weight": 0.1,
    "contrastive_temperature": 0.07,
}

_METRICS = [
    {
        "log_name": "pearson",
        "name": "MultidimPearsonCorrCoef",
        "kwargs": {"num_outputs": 1000},
    },
    {
        "log_name": "subj_pearson",
        "name": "GroupedMetric",
        "metric_name": "MultidimPearsonCorrCoef",
        "kwargs": {"num_outputs": 1000},
    },
    {
        "log_name": "retrieval_top1",
        "name": "TopkAcc",
        "topk": 1,
    },
]

_OPTIM = {
    "optimizer": {
        "name": "Adam",
        "lr": 1e-4,
        # bf16 first moment: one param copy less
        "kwargs": {"weight_decay": 0.0, "mu_dtype": "bfloat16"},
    },
    "scheduler": {
        "name": "OneCycleLR",
        "kwargs": {"max_lr": 1e-4, "pct_start": 0.1},
    },
}

default_config = {
    "infra": {
        "cluster": None,  # None = run in-process; "external" = pod fanout
        "folder": SAVEDIR,
    },
    "data": _DATA,
    "wandb_config": {
        "log_model": False,
        "project": "algonauts-2025",
        "group": "default",
        "host": None,
    },
    "brain_model_config": _MODEL,
    "metrics": _METRICS,
    "loss": {"name": "MSELoss"},
    "optim": _OPTIM,
    "n_epochs": 15,
    # device topology (reference reaches DDP via infra.gpus_per_node): total
    # devices and tensor-parallel width; one device until the parallel
    # strategies are ported
    "n_devices": None,
    "model_parallel": 1,
    "limit_train_batches": None,
    "patience": None,
    "enable_progress_bar": True,
    "log_every_n_steps": 5,
    "fast_dev_run": False,
    "seed": 33,
}


if __name__ == "__main__":
    import sys

    from ..config import ConfDict
    from ..experiment import Experiment

    # dotted-key overrides from argv, reference run.sh style:
    #   python -m algonauts2025_tpu_torch.grids.defaults n_epochs=1 data.batch_size=8
    cfg = ConfDict(default_config)
    for arg in sys.argv[1:]:
        if "=" not in arg:
            raise SystemExit(f"expected key=value overrides, got {arg!r}")
        key, value = arg.split("=", 1)
        try:
            import json

            value = json.loads(value)  # numbers/bools/null/lists
        except ValueError:
            pass  # keep as string
        cfg[key] = value
    exp = Experiment(**cfg.to_dict())
    exp.infra.clear_job()
    print(exp.run())
