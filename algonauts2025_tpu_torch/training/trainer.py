"""The training engine: steps, SWA, early stopping, checkpoints.

The port of algonauts2025_tpu/training/trainer.py:

- a train step (forward with the shared-trunk InfoNCE head, loss,
  backward, hand-written Adam step) with the modality-dropout draws taken
  from a ``torch.Generator`` seeded from ``seed`` and the step;
- SWA as a running mean of the params kept on the host, merged at epoch
  boundaries from ``swa_start`` of training, with the LR annealed to
  ``swa_lr`` inside the schedule;
- streaming metrics updated on the device per eval batch;
- best (on the monitor) and last checkpoints written with ``torch.save``,
  with optimizer and SWA state for an exact resume;
- with ``profile_dir``, a ``torch.profiler`` trace of the first train epoch
  (one range per step, ``utils.profiling``);
- ``release()`` hands the card's memory back after a run;
- with ``mesh`` (``parallel.get_mesh``, one process a device), data and
  tensor parallelism: each data rank runs its rows of the global batch
  and the predictions and InfoNCE latents are gathered before the loss
  (the losses and the metrics couple the rows), the gradients are
  averaged over "data", and the weights that ``parallel.sharding`` names
  split over "model" with the Megatron collectives (Adafactor and LAMB sum
  a split weight's statistics over "model": ``optim.Shard``).  A step, a
  loss and a metric equal those of one device.  Checkpoints and the SWA mean hold
  the full tensors, and rank 0 writes the files, so a checkpoint loads on
  any mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
import typing as tp
from pathlib import Path

import numpy as np
import torch

from ..data.dataset import SegmentData, to_device
from ..parallel.collectives import Parallel
from ..parallel.mesh import shard_batch
from ..parallel.sharding import apply_tensor_parallel, shard_tensor, state_shardings, unshard_tensor
from ..runtime import default_device
from ..utils.profiling import step_range, trace
from .metrics import Metric, MetricNeverUpdated
from .optim import OptimConfig, Shard

logger = logging.getLogger(__name__)

__all__ = ["BrainTrainer", "TrainerConfig"]

Params = dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainerConfig:
    n_epochs: int = 10
    monitor: str = "val/pearson"
    monitor_mode: str = "max"
    patience: int | None = None
    swa_start: float = 0.6  # fraction of epochs before SWA begins
    swa_lr: float = 1e-5
    swa_enabled: bool = True
    contrastive_weight: float = 0.0
    limit_train_batches: int | None = None
    log_every_n_steps: int | None = None
    save_checkpoints: bool = True
    folder: str | Path | None = None
    seed: int = 33
    fast_dev_run: bool = False
    #: a torch.profiler trace of the first train epoch goes here (trace.json)
    profile_dir: str | Path | None = None


def _to_host(tree: tp.Any) -> tp.Any:
    """A CPU copy of nested dicts/lists of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class BrainTrainer:
    """Trainer for FmriEncoder-style models.

    ``model(batch, training=...)`` returns (B, O, T') predictions;
    ``model.forward_with_contrastive`` also returns a dict of InfoNCE losses.
    ``device=None`` means the CUDA card (see ``runtime.default_device``):
    this process's device.  ``mesh`` is a ``("data", "model")`` DeviceMesh
    over the launch's processes (``parallel.get_mesh``); every process
    calls every method with the same global batches.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        loss_fn: tp.Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        optim_config: OptimConfig,
        metrics: tp.Mapping[str, Metric],
        config: TrainerConfig,
        device: str | torch.device | None = None,
        mesh: tp.Any | None = None,
    ) -> None:
        self.model = model
        self.loss_fn = loss_fn
        self.optim_config = optim_config
        self.metrics = dict(metrics)
        self.config = config
        self.device = default_device(device)
        self.mesh = mesh
        self._parallel: Parallel | None = None
        #: parameter name -> the dim split over "model" (None: replicated)
        self._specs: dict[str, int | None] = {}
        self.optimizer = None
        self.schedule: tp.Callable[[int], float] | None = None
        self.step = 0
        self.history: list[dict[str, float]] = []
        self.callback_metrics: dict[str, float] = {}
        self._has_contrastive = hasattr(model, "forward_with_contrastive")
        self._swa_params: Params | None = None
        self._swa_count = 0
        self._best: float | None = None  # monitor state, persisted in ckpts
        self._bad_epochs = 0
        #: per-epoch record sink (``experiment.tracking.RunLogger``), if set
        self._logger: tp.Any = None

    # -- initialization ---------------------------------------------------
    def init_state(self, example_batch: SegmentData, total_steps: int) -> None:
        """Materialise and initialise the model from ``seed`` on the device,
        and build the optimizer and schedule.  ``example_batch`` keeps the
        JAX trainer's signature: the port's shapes are fixed at build."""
        del example_batch
        cfg = self.config
        generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.model.to_empty(device=self.device)
        self.model.init_weights(generator)  # the full weights, on every rank
        if self.mesh is not None:
            self._parallel = Parallel(self.mesh)
            tp_group = self._parallel.tp
            if tp_group is not None:
                self._specs = state_shardings(self.model, tp_group.size)
                apply_tensor_parallel(self.model, self._specs, tp_group)
        swa_start_step = int(total_steps * cfg.swa_start) if cfg.swa_enabled else None
        self.optimizer, self.schedule = self.optim_config.build(
            self.model.parameters(),
            total_steps,
            swa_start_step=swa_start_step,
            swa_lr=cfg.swa_lr,
            steps_per_epoch=max(1, total_steps // max(1, cfg.n_epochs)),
        )
        if self._specs:
            # Adafactor and LAMB reduce over whole parameters: they sum a
            # split parameter's statistics over the model group
            self.optimizer.set_shards(
                {p: Shard(self._specs[name], self._full_shape(name, p))
                 for name, p in self.model.named_parameters() if self._specs.get(name) is not None},
                self._parallel.sum_over_model,
            )
        self.step = 0
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info("Total parameters: %d (this rank's)", n_params)

    def _local(self, data: tp.Mapping[str, tp.Any]) -> tuple[dict[str, torch.Tensor], tp.Callable | None]:
        """This rank's rows of a global batch on the device, and the row
        gather that restores the global batch (None where the batch is not
        split: one device, or rows that do not divide the data axis)."""
        if self._parallel is None:
            return to_device(data, self.device), None
        local, split = shard_batch(data, self.mesh, self.device)
        return local, (self._parallel.gather_rows if split else None)

    def _step_generator(self) -> torch.Generator:
        """Host generator of this step's modality-dropout draws."""
        seed = np.random.SeedSequence([self.config.seed + 1, self.step]).generate_state(1)[0]
        return torch.Generator().manual_seed(int(seed))

    # -- steps --------------------------------------------------------------
    def _flat(self, y: torch.Tensor) -> torch.Tensor:
        """(b, d, t) -> ((b t), d), the reference step's flattening."""
        return y.transpose(1, 2).reshape(-1, y.shape[1])

    def train_step(
        self, data: tp.Mapping[str, torch.Tensor]
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """One optimizer step on a global batch (on the host or the device);
        returns (loss, InfoNCE losses)."""
        assert self.optimizer is not None, "call init_state first"
        self.model.train()
        # the same draws on every rank: the modality-dropout mask is one per
        # modality for the whole global batch
        generator = self._step_generator()
        local, gather = self._local(data)
        if self._has_contrastive:
            y_pred, closses = self.model.forward_with_contrastive(
                local, training=True, generator=generator, gather_rows=gather
            )
        else:
            y_pred, closses = self.model(local, training=True, generator=generator), {}
        y_true = local["fmri"]
        if gather is not None:
            y_pred, y_true = gather(y_pred), gather(y_true)
        loss = self.loss_fn(self._flat(y_pred), self._flat(y_true))
        if closses:
            loss = loss + self.config.contrastive_weight * (
                sum(closses.values()) / max(1, len(closses))
            )
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self._parallel is not None:
            self._parallel.reduce_grads(self.model.parameters())
        self.optimizer.step()
        self.step += 1
        return loss.detach(), {k: v.detach() for k, v in closses.items()}

    @torch.no_grad()
    def eval_step(self, data: tp.Mapping[str, tp.Any]) -> torch.Tensor:
        """The (B, O, T') predictions of a global batch, on every rank."""
        self.model.eval()
        local, gather = self._local(data)
        y_pred = self.model(local, training=False)
        return y_pred if gather is None else gather(y_pred)

    def _swa_merge(self, host_params: Params | None = None) -> None:
        """Host-side running mean of params (exact fp32, no device memory)."""
        params = host_params if host_params is not None else self._full_state_dict()
        if self._swa_params is None:
            self._swa_params = params
            self._swa_count = 1
            return
        n = float(self._swa_count)
        self._swa_params = {
            k: (avg * n + params[k]) / (n + 1.0) for k, avg in self._swa_params.items()
        }
        self._swa_count += 1

    # -- training loop ----------------------------------------------------
    def fit(
        self,
        train_loader_fn: tp.Callable[[int], tp.Iterable[SegmentData]],
        val_loader_fn: tp.Callable[[], tp.Iterable[SegmentData]],
        start_epoch: int = 0,
    ) -> None:
        cfg = self.config
        assert self.optimizer is not None, "call init_state first"
        swa_start_epoch = int(cfg.n_epochs * cfg.swa_start)
        # a resumed run continues the monitor/patience state of its checkpoint
        best = self._best
        if best is None:
            best = -np.inf if cfg.monitor_mode == "max" else np.inf
        bad_epochs = self._bad_epochs
        n_epochs = 1 if cfg.fast_dev_run else cfg.n_epochs
        last_host_state = None

        for epoch in range(start_epoch, n_epochs):
            t0 = time.time()
            traced = cfg.profile_dir is not None and epoch == start_epoch
            with trace(cfg.profile_dir) if traced else contextlib.nullcontext():
                losses = self._train_epoch(train_loader_fn(epoch), epoch)
            train_loss = float(torch.stack(losses).mean()) if losses else float("nan")

            val_metrics = self.evaluate(val_loader_fn(), split="val")
            lr = self._current_lr()
            record = {
                "epoch": epoch,
                "train/loss": train_loss,
                "lr": lr,
                "epoch_seconds": time.time() - t0,
                **val_metrics,
            }
            self.history.append(record)
            self.callback_metrics.update(
                {k: v for k, v in record.items() if isinstance(v, (int, float))}
            )
            if self._logger is not None:
                self._logger.log(record, step=self.step)
            logger.info(
                "epoch %d: loss=%.5f %s lr=%.2e (%.1fs)", epoch, train_loss,
                " ".join(f"{k}={v:.4f}" for k, v in val_metrics.items() if isinstance(v, float)),
                lr, record["epoch_seconds"],
            )
            if not val_metrics:
                raise RuntimeError(
                    "validation produced no batches/metrics — an empty val "
                    "split would disable best-checkpointing and let patience "
                    "stop training"
                )
            monitored = val_metrics.get(cfg.monitor)
            if monitored is None:
                raise KeyError(
                    f"monitor {cfg.monitor!r} not in validation metrics "
                    f"{sorted(val_metrics)}; set TrainerConfig.monitor to one of these"
                )
            improved = monitored > best if cfg.monitor_mode == "max" else monitored < best
            # one host copy serves "best", "last" and the SWA merge
            host_state = None
            if self._ckpt_path("last") is not None:
                host_state = self._host_state()
            last_host_state = host_state
            if cfg.swa_enabled and epoch >= swa_start_epoch:
                self._swa_merge(None if host_state is None else host_state["params"])
            if improved:
                best = monitored
                bad_epochs = 0
                self._best, self._bad_epochs = best, bad_epochs
                self.save_checkpoint("best", host_state=host_state)
            else:
                bad_epochs += 1
            self._best, self._bad_epochs = best, bad_epochs
            self.save_checkpoint("last", epoch=epoch, host_state=host_state)
            # stop after `patience` consecutive non-improving validations
            if cfg.patience is not None and bad_epochs >= cfg.patience:
                logger.info("Early stopping at epoch %d", epoch)
                break

        # adopt the SWA weights at the end of training
        if cfg.swa_enabled and self._swa_count > 0:
            self._load_full_params(self._swa_params)
            if last_host_state is not None:
                last_host_state = {**last_host_state, "params": self._swa_params}
            self.save_checkpoint("last", epoch=n_epochs - 1, host_state=last_host_state)

    def _train_epoch(self, loader: tp.Iterable[SegmentData], epoch: int) -> list[torch.Tensor]:
        cfg = self.config
        losses = []
        for i, batch in enumerate(loader):
            if cfg.limit_train_batches is not None and i >= cfg.limit_train_batches:
                break
            if cfg.fast_dev_run and i >= 1:
                break
            with step_range(i):
                loss, _aux = self.train_step(batch.data)
            losses.append(loss)
            if cfg.log_every_n_steps and (i + 1) % cfg.log_every_n_steps == 0:
                logger.info("epoch %d step %d: train/loss=%.5f", epoch, i, float(loss))
        return losses

    def release(self) -> None:
        """Give the device memory of a finished run back: the weights go to
        the meta device, and the optimizer (which holds the parameters it
        was built over) and the metric states are dropped.  ``history`` and
        ``callback_metrics`` stay; the trainer cannot step, evaluate or
        save after this."""
        self.optimizer = None
        self.model.to("meta")
        self._swa_params = None
        for metric in self.metrics.values():
            metric.reset()

    def _current_lr(self) -> float:
        return 0.0 if self.schedule is None else float(self.schedule(self.step))

    # -- evaluation -------------------------------------------------------
    def evaluate(self, loader: tp.Iterable[SegmentData], split: str = "val") -> dict[str, float]:
        assert self.optimizer is not None, "call init_state first"
        metrics = {name: m for name, m in self.metrics.items() if name.startswith(split)}
        for metric in metrics.values():
            metric.reset()
        needs_groups = any(m.needs_groups or m.is_retrieval for m in metrics.values())
        losses = []
        for batch in loader:
            data = to_device(batch.data, self.device)
            y_pred = self.eval_step(data)  # the global batch's, on every rank
            y_true = data["fmri"]
            yp, yt = self._flat(y_pred), self._flat(y_true)
            losses.append(self.loss_fn(yp, yt))
            subject_ids = data.get("subject_id")
            voxel_groups = segment_groups = None
            if subject_ids is not None and needs_groups:
                segment_groups = subject_ids.reshape(-1)
                voxel_groups = torch.repeat_interleave(segment_groups, y_pred.shape[2])
            retrieval_args = None  # time-means computed once per batch
            for metric in metrics.values():
                if metric.is_retrieval:
                    if retrieval_args is None:
                        retrieval_args = (y_pred.mean(dim=-1), y_true.float().mean(dim=-1))
                    args, groups = retrieval_args, segment_groups
                else:
                    args, groups = (yp, yt), voxel_groups
                if metric.needs_groups:
                    metric.update(*args, groups=groups)
                else:
                    metric.update(*args)
        out: dict[str, float] = {}
        if losses:
            out[f"{split}/loss"] = float(torch.stack(losses).mean())
        for name, metric in metrics.items():
            try:
                value = metric.compute()
            except MetricNeverUpdated:
                continue  # empty split; any other failure must be loud
            if isinstance(value, dict):
                for k, v in value.items():
                    out[f"{name}/{k}"] = v
                if value and name not in out:
                    # the group mean under the base name, so a grouped metric
                    # can be monitored; nanmean skips single-row groups
                    out[name] = float(np.nanmean(list(value.values())))
            else:
                out[name] = value
        return out

    def predict(
        self, loader: tp.Iterable[SegmentData]
    ) -> tp.Iterator[tuple[np.ndarray, SegmentData]]:
        assert self.optimizer is not None, "call init_state first"
        for batch in loader:
            y_pred = self.eval_step(batch.data)
            yield y_pred.cpu().numpy(), batch

    # -- checkpointing ----------------------------------------------------
    def _ckpt_path(self, name: str) -> Path | None:
        if self.config.folder is None or not self.config.save_checkpoints:
            return None
        return Path(self.config.folder) / f"{name}.ckpt"

    def _full(self, name: str, local: torch.Tensor, dim: int | None) -> torch.Tensor:
        """The full tensor of parameter ``name`` (or of a state of it) split
        on ``dim`` from every model rank's part; a collective under tensor
        parallelism."""
        if dim is None:
            return local
        group = self._parallel.model_group
        parts = [torch.empty_like(local) for _ in range(self._parallel.n_model)]
        torch.distributed.all_gather(parts, local.contiguous(), group=group)
        return unshard_tensor(name, parts, dim)

    def _own(self, name: str, full: torch.Tensor, dim: int | None) -> torch.Tensor:
        """This rank's part of the full parameter ``name`` (or of a state of
        it) split on ``dim``."""
        if dim is None:
            return full
        tp_group = self._parallel.tp
        return shard_tensor(name, full, dim, tp_group.rank, tp_group.size)

    def _full_state_dict(self) -> Params:
        """A host copy of the model's full state dict (every rank gets it)."""
        return _to_host({k: self._full(k, v, self._specs.get(k))
                         for k, v in self.model.state_dict().items()})

    def _load_full_params(self, full: tp.Mapping[str, torch.Tensor], strict: bool = True) -> None:
        """Load a full state dict (a checkpoint's, the SWA mean) into this
        rank's parts."""
        self.model.load_state_dict({k: self._own(k, v, self._specs.get(k)) for k, v in full.items()},
                                   strict=strict)

    def _full_shape(self, name: str, local: torch.Tensor) -> tuple[int, ...]:
        shape = list(local.shape)
        dim = self._specs.get(name)
        if dim is not None:
            shape[dim] *= self._parallel.n_model
        return tuple(shape)

    def _optimizer_states(self, opt_state: dict[str, tp.Any], to_full: bool) -> dict[str, tp.Any]:
        """An optimizer state dict whose per-parameter tensors of the split
        parameters are made full (``to_full``) or cut to this rank's part
        (each on the dim the optimizer names: Adafactor's factored moments
        lack one dim of the parameter, or are whole)."""
        if not self._specs:
            return opt_state
        params = dict(self.model.named_parameters())
        names = {id(p): n for n, p in params.items()}
        order = [names[id(p)] for group in self.optimizer.param_groups for p in group["params"]]
        states = {}
        for index, state in opt_state["state"].items():
            name = order[int(index)]
            param = params[name]

            def convert(key, v):
                if not isinstance(v, torch.Tensor):
                    return v
                dim = self.optimizer.state_split_dim(param, key)
                return self._full(name, v, dim) if to_full else self._own(name, v, dim)

            states[index] = {k: convert(k, v) for k, v in state.items()}
        return {**opt_state, "state": states}

    def _host_state(self) -> dict[str, tp.Any]:
        """Step, full params and full optimizer state on the host; a
        collective under tensor parallelism (every rank calls it)."""
        return {
            "step": self.step,
            "params": self._full_state_dict(),
            "opt_state": _to_host(self._optimizer_states(self.optimizer.state_dict(), True)),
        }

    def save_checkpoint(
        self, name: str, epoch: int | None = None, host_state: dict | None = None
    ) -> None:
        """``host_state``: an already-fetched host copy of the state, so an
        improving epoch pays one device-to-host copy for "best" and "last".
        Under a mesh every rank gathers the state and rank 0 writes it."""
        path = self._ckpt_path(name)
        if path is None or self.optimizer is None:
            return
        state = host_state if host_state is not None else self._host_state()
        if self._parallel is not None and not self._parallel.writer:
            return
        payload = {
            "state": state,
            "meta": {
                "epoch": epoch if epoch is not None else -1,
                "swa_count": self._swa_count,
                "best": float(self._best) if self._best is not None else float("nan"),
                "bad_epochs": self._bad_epochs,
            },
        }
        if self._swa_params is not None:
            payload["swa_params"] = self._swa_params
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)  # a reader never sees a half-written file

    def load_checkpoint(
        self, path: str | Path, strict: bool = True, params_only: bool = False
    ) -> int:
        """Restore state; returns the next epoch to run.

        ``params_only`` adopts only the model weights (warm start): the
        fresh optimizer state, schedule position and SWA slots are kept."""
        assert self.optimizer is not None, "init_state before load_checkpoint"
        try:
            raw = torch.load(Path(path), map_location="cpu", weights_only=True)
        except Exception:
            if strict:
                raise
            logger.warning("Non-strict checkpoint load failed for %s", path)
            return 0
        new_params = raw["state"]["params"]
        if params_only:
            current = {k: self._full_shape(k, v) for k, v in self.model.state_dict().items()}
            missing = set(current) - set(new_params)
            mismatched = {
                k for k in set(current) & set(new_params)
                if tuple(new_params[k].shape) != current[k]
            }
            if (missing or mismatched) and strict:
                raise ValueError(
                    f"Checkpoint {path}: {len(missing)} model parameters "
                    f"missing, {len(mismatched)} shape-mismatched "
                    f"(e.g. {sorted(missing | mismatched)[:3]}); "
                    "pass strict=False to adopt the intersection"
                )
            adopt = {
                k: v for k, v in new_params.items()
                if k in current and k not in mismatched
            }
            self._load_full_params(adopt, strict=False)
            return 0
        self._load_full_params(new_params)
        self.optimizer.load_state_dict(self._optimizer_states(raw["state"]["opt_state"], False))
        self.step = int(raw["state"]["step"])
        self._swa_params = raw.get("swa_params")
        meta = raw["meta"]
        self._swa_count = int(meta.get("swa_count", 0))
        restored_best = float(meta.get("best", float("nan")))
        self._best = None if np.isnan(restored_best) else restored_best
        self._bad_epochs = int(meta.get("bad_epochs", 0))
        return int(meta["epoch"]) + 1
