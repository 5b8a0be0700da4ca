"""Experiment tracking: local JSONL logger with a wandb-compatible config.

The reference logs to Weights & Biases via Lightning (reference
modeling_utils/utils.py:163-210).  This build always writes a local JSONL
metrics stream (works offline) and mirrors to wandb when the
package is importable and not in offline mode.
"""

from __future__ import annotations

import json
import logging
import time
import typing as tp
from pathlib import Path

import pydantic

__all__ = ["WandbLoggerConfig", "RunLogger"]


class RunLogger:
    def __init__(self, save_dir: str | Path, run_id: str | None = None, wandb_run: tp.Any = None):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.save_dir / "metrics.jsonl"
        self.run_id = run_id
        self._wandb = wandb_run

    def log(self, metrics: tp.Mapping[str, tp.Any], step: int | None = None) -> None:
        record = {"_time": time.time(), "_step": step}
        record.update(
            {k: v for k, v in metrics.items() if isinstance(v, (int, float, str))}
        )
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log(dict(metrics), step=step)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


class WandbLoggerConfig(pydantic.BaseModel):
    """Config surface mirroring the reference WandbLoggerConfig."""

    model_config = pydantic.ConfigDict(extra="forbid")

    offline: bool = False
    host: str | None = None
    name: str | None = None
    group: str | None = None
    entity: str | None = None
    version: str | None = None
    dir: Path | None = None
    id: str | None = None
    anonymous: bool | None = None
    project: str | None = None
    log_model: str | bool = False
    experiment: tp.Any | None = None
    prefix: str = ""

    def build(
        self,
        save_dir: str | Path,
        xp_config: dict | pydantic.BaseModel | None = None,
        id: str | None = None,
    ) -> RunLogger:
        if isinstance(xp_config, pydantic.BaseModel):
            xp_config = xp_config.model_dump()
        run_id = id or self.id
        wandb_run = None
        if not self.offline:
            try:
                import wandb
            except ImportError:
                wandb = None  # offline image: local JSONL only
            except Exception as exc:
                # importable-but-broken install (protobuf mismatch, partial
                # package): degrade to JSONL like the offline case, loudly —
                # the mirror must never take the training run down with it
                logging.getLogger(__name__).warning(
                    "wandb import failed (%s: %s); falling back to local "
                    "JSONL logging only",
                    type(exc).__name__,
                    exc,
                )
                wandb = None
            if wandb is not None:
                try:
                    wandb_run = wandb.init(
                        project=self.project,
                        group=self.group,
                        name=self.name,
                        entity=self.entity,
                        id=run_id,
                        dir=str(save_dir),
                        config=xp_config,
                        reinit=True,
                    )
                except Exception as exc:
                    # wandb importable but init failed (auth, network, bad
                    # settings): fall back to the JSONL stream, but say so —
                    # a silently-absent mirror looks identical to offline
                    logging.getLogger(__name__).warning(
                        "wandb.init failed (%s); metrics go to the local "
                        "JSONL stream only",
                        exc,
                    )
                    wandb_run = None
        logger = RunLogger(save_dir, run_id=run_id, wandb_run=wandb_run)
        if xp_config is not None:
            (Path(save_dir) / "run_config.json").write_text(
                json.dumps(xp_config, default=str, indent=2)
            )
        return logger
