"""Closed-loop train steps of the trunk on a pool of device-resident batches.

Set-up builds one ``BrainTrainer`` from the configuration, loads the seeded
weights (``reference.make_weights``: the same the reference starts from),
makes a pool of seeded batches on the device and runs the first
``checked_steps`` steps through ``train_step`` on pool batches 0, 1, 2:
their losses, the first gradient's norm by leaf (read back from Adam's
second moment after one step: nu = (1 - b2) g^2) and each leaf's change
after them are what the check compares.  The window then calls
``train_step`` back to back on the next batches of the pool, cycled, on the
same trainer.  The host data path is bypassed.
"""

from __future__ import annotations

import math
import time

import torch

from algonauts2025_tpu_torch.models import FmriEncoderConfig
from algonauts2025_tpu_torch.ops import _cuda
from algonauts2025_tpu_torch.training import BrainTrainer, OptimConfig, TrainerConfig, build_loss
from benchmark.common.trace import span
from benchmark.reference import tribe_trunk as reference

MODEL_KEYS = ("n_subjects", "feature_aggregation", "layer_aggregation", "subject_embedding",
              "modality_dropout", "contrastive_enabled", "contrastive_modalities", "contrastive_weight",
              "contrastive_temperature", "hidden", "depth", "heads", "remat")


def build_trainer(cfg: dict, seed: int, device: torch.device) -> BrainTrainer:
    """The trainer the configuration describes, through the port's API."""
    model_cfg = FmriEncoderConfig(**{k: cfg["brain_model_config"][k] for k in MODEL_KEYS})
    if cfg["brain_model_config"]["ff_mult"] != 4 or cfg["max_positions"] != 1024:
        raise ValueError("the port's trunk has ff_mult 4 and 1024 positions")
    model = model_cfg.build({m: tuple(d) for m, d in cfg["feature_dims"].items()},
                            n_outputs=cfg["n_outputs"], n_output_timesteps=cfg["n_output_timesteps"])
    return BrainTrainer(
        model=model,
        loss_fn=build_loss(cfg["loss"]),
        optim_config=OptimConfig(**cfg["optim"]),
        metrics={},
        config=TrainerConfig(n_epochs=cfg["n_epochs"], folder=None, save_checkpoints=False, seed=seed,
                             swa_start=cfg["swa_start"], contrastive_weight=cfg["brain_model_config"]["contrastive_weight"]),
        device=device,
    )


class Driver:
    def __init__(self, run) -> None:
        self.run = run
        cfg, traffic = run.config, run.traffic
        if run.device.type == "cuda":
            _cuda.build_all(["attention"])
        self.trainer = build_trainer(cfg, run.seed, run.device)
        self.trainer.init_state(None, total_steps=traffic["total_steps"])
        self.trainer.model.load_state_dict(reference.make_weights(cfg, run.seed, run.device))
        self.batches = reference.make_batches(cfg, run.seed, traffic["pool_batches"], run.device)
        self.record: dict | None = None
        self.next = 0

    def _step(self) -> torch.Tensor:
        loss, _ = self.trainer.train_step(self.batches[self.next % len(self.batches)])
        self.next += 1
        return loss

    def prepare(self) -> None:
        """The checked first steps (which also warm every shape up)."""
        n = self.run.traffic["checked_steps"]
        b2 = self.run.config["optim"]["optimizer"]["kwargs"].get("betas", (0.9, 0.999))[1]
        params = dict(self.trainer.model.named_parameters())
        losses, grads = [], {}
        for step in range(n):
            losses.append(self._step().item())
            if step == 0:
                state = self.trainer.optimizer.state
                grads = {k: math.sqrt(float(state[p]["nu"].double().sum()) / (1 - b2)) if p in state else 0.0
                         for k, p in params.items()}
        with torch.no_grad():
            w0 = reference.make_weights(self.run.config, self.run.seed, self.run.device)
            change = {k: float((p - w0[k]).double().norm()) for k, p in params.items()}
            del w0
        self.record = {"losses": losses, "grad_norms": [grads], "change": change}
        self.checked = self.batches[:n]

    def window(self, seconds: float, tracer) -> dict:
        sync = torch.cuda.synchronize if self.run.device.type == "cuda" else (lambda: None)
        sync()
        steps = 0
        with tracer.window():
            t0 = time.perf_counter()
            while True:
                with span("train_step"):
                    self._step()
                steps += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            sync()
            elapsed = time.perf_counter() - t0
        return {"window_s": elapsed, "steps": steps, "attempted": steps, "failed": 0}

    def release(self) -> None:
        self.trainer.release()
        del self.trainer
        self.batches = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def numbers(self) -> dict[str, float]:
        ref = reference.train(self.run.config, self.run.seed, self.checked, self.run.traffic["total_steps"],
                              self.run.device)
        return reference.gaps(self.record, ref)


def control(run) -> dict[str, dict[str, float]]:
    """The reference's steps on TF32 in the program's place (the one control:
    the configuration states float32 with TF32 off)."""
    cfg, traffic = run.config, run.traffic
    batches = reference.make_batches(cfg, run.seed, traffic["checked_steps"], run.device)
    steps = [reference.train(cfg, run.seed, batches, traffic["total_steps"], run.device, tf32=tf32)
             for tf32 in (True, False)]
    return {"tf32": reference.gaps(*steps)}


def _half_batch(driver: Driver) -> None:
    """Each step sees the first half of its rows (the mean over those)."""
    step = driver.trainer.train_step
    driver.trainer.train_step = lambda data: step({k: v[: len(v) // 2] for k, v in data.items()})


def _frozen(driver: Driver) -> None:
    """Each step returns the state unchanged: the optimizer does nothing."""
    driver.trainer.optimizer.step = lambda: None


#: faults of the timed path that the check must catch
FAULTS = {"half_batch": _half_batch, "frozen_state": _frozen}
