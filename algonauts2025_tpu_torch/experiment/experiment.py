"""Experiment: the full train/eval/submit lifecycle (single entry point).

Rebuild of reference algonauts2025/main.py:206-511.  ``Experiment(**cfg)
.run()`` is cached by config hash (TaskInfra), builds the data pipeline,
infers feature dims from a probe batch, trains the FmriEncoder with the
BrainTrainer (SWA, early stopping, checkpoints), then writes metrics.csv,
per-voxel pearson.npy and the challenge submission zip.

The port of algonauts2025_tpu/experiment/experiment.py: the same fields,
cache uid, lifecycle and artifacts (config.yaml, metrics.csv, pearson.npy,
last.ckpt, submission.npy / .zip).  ``accelerator`` picks the trainer's
device: "cuda" is the card (``runtime.default_device``, which raises where
there is none), "cpu" runs on the host.  ``n_devices`` and
``model_parallel`` shape the ``("data", "model")`` mesh of the trainer
(``parallel.get_mesh``).  A torch process drives one device, so a run
over N devices is N processes (``torchrun --nproc-per-node N -m
algonauts2025_tpu_torch.grids.run_config task.json``); ``n_devices`` that
differs from the launch's world size raises and names that command.  Rank
0 writes the run's files.  ``profile=True`` writes a ``torch.profiler``
trace of the first train epoch to ``<folder>/profile/trace.json``.  After
a run the trainer's device memory is released (``BrainTrainer.release``),
so that a grid's members can run one after another in one process.

Differences by design (as in the JAX package):
- no Lightning: the trainer is ``training.trainer.BrainTrainer``;
- JitterWindows is a loader factory (train windows re-cut every epoch with
  +-10 s start jitter, reference callbacks.py:16-44), not a callback
  mutating a DataLoader;
- per-voxel pearson comes from the streaming metric state instead of a
  1000-iteration scipy loop (reference main.py:459-477).
"""

from __future__ import annotations

import logging
import typing as tp
import zipfile
from pathlib import Path

import numpy as np
import pandas as pd
import pydantic
import torch
import torch.distributed as dist
import yaml

from ..cache.task_cache import TaskInfra
from ..data.dataset import SegmentDataset, prefetch_to_device
from ..models.fmri_encoder import FmriEncoderConfig
from ..parallel.mesh import get_mesh
from ..runtime import default_device
from ..training.losses import LossConfig, build_loss
from ..training.metrics import MetricConfig, MultidimPearsonCorrCoef, build_metric
from ..training.optim import OptimConfig
from ..training.trainer import BrainTrainer, TrainerConfig
from .data import Data
from .tracking import RunLogger, WandbLoggerConfig

logger = logging.getLogger(__name__)


def _monitor_mode(monitor: str, metrics: tp.Mapping[str, tp.Any]) -> str:
    """Checkpoint/early-stop direction from the monitored metric's own
    higher_is_better flag (grouped metrics monitor "<name>/<group>")."""
    for key in (monitor, monitor.rsplit("/", 1)[0]):
        metric = metrics.get(key)
        if metric is not None:
            return "max" if metric.higher_is_better else "min"
    return "min" if "loss" in monitor else "max"

__all__ = ["Experiment"]

N_OUTPUT_TIMESTEPS = 100
START_JITTER_SECONDS = 10.0


def _writer() -> bool:
    """Whether this process writes the run's files: rank 0 of a launch."""
    return not dist.is_initialized() or dist.get_rank() == 0


class Experiment(pydantic.BaseModel):
    model_config = pydantic.ConfigDict(extra="forbid")

    data: Data
    seed: int | None = 33
    brain_model_config: FmriEncoderConfig
    loss: LossConfig
    optim: OptimConfig
    metrics: list[MetricConfig] = []
    monitor: str = "val/pearson"
    wandb_config: WandbLoggerConfig | None = None
    #: the trainer's device: "cuda" (the card) or "cpu"
    accelerator: tp.Literal["cuda", "cpu"] = "cuda"
    n_epochs: int = 10
    patience: int | None = None
    limit_train_batches: int | None = None
    enable_progress_bar: bool = True
    log_every_n_steps: int | None = None
    fast_dev_run: bool = False
    save_checkpoints: bool = True
    checkpoint_path: str | None = None
    test_only: bool = False
    # device topology (the mesh): n_devices = the launch's processes, one
    # device each (None = the world size), model_parallel = the
    # tensor-parallel width; the mesh is (n_devices // model_parallel,
    # model_parallel)
    n_devices: int | None = None
    model_parallel: int = pydantic.Field(default=1, ge=1)
    profile: bool = False  # torch.profiler trace of the first train epoch

    infra: TaskInfra = TaskInfra(version="1")

    _trainer: tp.Any = pydantic.PrivateAttr(default=None)

    def model_post_init(self, _ctx: tp.Any) -> None:
        super().model_post_init(_ctx)
        if self.infra.folder is None:
            raise ValueError("infra.folder needs to be specified to save results.")
        self.infra.bind(self)
        if self.brain_model_config.n_subjects is None:
            self.brain_model_config.n_subjects = self.data.n_subjects

    def _exclude_from_cache_uid(self) -> list[str]:
        """Device topology is placement, not task identity: the reference
        reaches DDP via infra.gpus_per_node and exca excludes infra from
        task uids, so re-running a cached experiment on a different
        device count reuses the result (mode='force' recomputes).  Same
        contract as the feature-level pipeline_stages/sequence_parallel
        exclusions.  profile only adds a trace artifact; accelerator is
        placement too."""
        return ["n_devices", "model_parallel", "profile", "accelerator"]

    # -- lifecycle --------------------------------------------------------
    def run(self) -> dict[str, float]:
        return self.infra.run_cached(self._run)

    def setup_run(self) -> None:
        folder = Path(self.infra.folder)
        folder.mkdir(parents=True, exist_ok=True)
        if not _writer():
            return
        with open(folder / "config.yaml", "w") as f:
            yaml.safe_dump(
                self.model_dump(mode="json"),
                f,
                indent=4,
                default_flow_style=False,
                sort_keys=False,
            )

    def _device(self) -> torch.device:
        """This process's device: the card of its rank, or the CPU."""
        return default_device(None if self.accelerator == "cuda" else self.accelerator)

    def _mesh(self):
        """The trainer's ("data", "model") mesh, None on one device.
        ``n_devices`` other than the launch's world size, and a
        ``model_parallel`` that does not divide it, raise in ``get_mesh``:
        a run never trains on fewer devices than it asked for."""
        n = self.n_devices
        if n is None:
            n = dist.get_world_size() if dist.is_initialized() else 1
        if n <= 1 and self.model_parallel <= 1:
            return None
        return get_mesh(n_devices=n, model_parallel=self.model_parallel)

    def _feature_dims(self, batch) -> tuple[dict, int]:
        feature_dims: dict[str, tuple[int, int] | None] = {}
        for modality in ["text", "audio", "video"]:
            if modality in batch.data:
                arr = batch.data[modality]
                if arr.ndim == 4:
                    feature_dims[modality] = (arr.shape[1], arr.shape[2])
                elif arr.ndim == 3:
                    feature_dims[modality] = (1, arr.shape[1])
                else:
                    raise ValueError(
                        f"Unexpected ndim for modality {modality}: {arr.ndim}"
                    )
            else:
                feature_dims[modality] = None
        n_outputs = batch.data["fmri"].shape[1] if "fmri" in batch.data else 1000
        return feature_dims, n_outputs

    def _run(self) -> dict[str, float]:
        self.setup_run()
        if self.wandb_config is not None:
            run_logger = self.wandb_config.build(
                save_dir=self.infra.folder,
                xp_config=self.model_dump(mode="json"),
                id=f"{self.wandb_config.group}-{self.infra.uid().split('-')[-1]}",
            )
        else:
            # the JSONL metrics stream is always on; wandb only mirrors it
            run_logger = RunLogger(save_dir=self.infra.folder)
        try:
            return self._run_with_logger(run_logger)
        finally:
            # a failed fit/eval/submission must still finalize the logger
            # (flush trailing metrics, mark the wandb run finished)
            run_logger.finish()
            if self._trainer is not None:
                self._trainer.release()

    def _run_with_logger(self, run_logger) -> dict[str, float]:
        device = self._device()
        mesh = self._mesh()
        writer = _writer()
        if self.seed is not None:
            np.random.seed(self.seed)

        splits = ["test"] if self.test_only else ["train", "val", "test"]
        events = self.data.get_events()
        datasets = self.data.get_datasets(events, splits=splits)
        probe_ds = next(iter(datasets.values()))
        probe_batch = next(probe_ds.batches(batch_size=min(2, len(probe_ds))))
        feature_dims, n_outputs = self._feature_dims(probe_batch)
        logger.info("Feature dims: %s; n_outputs: %s", feature_dims, n_outputs)

        model = self.brain_model_config.build(
            feature_dims=feature_dims,
            n_outputs=n_outputs,
            n_output_timesteps=N_OUTPUT_TIMESTEPS,
        )

        n_subjects = self.brain_model_config.n_subjects or 8
        metrics = {}
        for split in ["val", "test"]:
            for mc in self.metrics:
                # (metrics infer the voxel dim from their first update; a
                # config-declared num_outputs is validated there instead)
                metrics[f"{split}/{mc.log_name}"] = build_metric(mc, n_groups=n_subjects)

        trainer = BrainTrainer(
            model=model,
            loss_fn=build_loss(self.loss),
            optim_config=self.optim,
            metrics=metrics,
            config=TrainerConfig(
                n_epochs=self.n_epochs,
                monitor=self.monitor,
                monitor_mode=_monitor_mode(self.monitor, metrics),
                patience=self.patience,
                contrastive_weight=self.brain_model_config.contrastive_weight,
                limit_train_batches=self.limit_train_batches,
                log_every_n_steps=self.log_every_n_steps,
                save_checkpoints=self.save_checkpoints,
                folder=self.infra.folder,
                seed=self.seed if self.seed is not None else 0,
                fast_dev_run=self.fast_dev_run,
                profile_dir=Path(self.infra.folder) / "profile" if self.profile else None,
            ),
            device=device,
            mesh=mesh,
        )
        trainer._logger = run_logger if writer else None
        self._trainer = trainer

        batch_size = self.data.batch_size
        num_workers = self.data.num_workers

        train_ds = datasets.get("train")
        val_ds = datasets.get("val")
        test_ds = datasets.get("test")
        # ceil with the tail batch, floor when drop_last discards it — the
        # LR schedule / SWA start must count the steps that actually run
        if train_ds is None:
            steps_per_epoch = 1
        elif self.data.drop_last:
            steps_per_epoch = max(1, len(train_ds) // batch_size)
        else:
            steps_per_epoch = max(1, -(-len(train_ds) // batch_size))
        if self.limit_train_batches is not None:
            # the LR schedule and step-based SWA annealing must count the
            # steps that actually run (reference: Lightning's
            # estimated_stepping_batches honors limit_train_batches)
            steps_per_epoch = min(steps_per_epoch, self.limit_train_batches)
        total_steps = self.n_epochs * steps_per_epoch
        trainer.init_state(probe_batch, total_steps=total_steps)

        # resume: explicit checkpoint or last.ckpt in the run folder.  An
        # explicit checkpoint_path is a WARM START (weights only, fresh
        # optimizer/schedule/SWA — reference load_from_checkpoint
        # strict=False semantics); last.ckpt is a full resume.
        start_epoch = 0
        ckpt, is_warm_start = self._get_checkpoint_path()
        if self.test_only and ckpt is None:
            raise RuntimeError(
                "test_only=True but no checkpoint exists (checkpoint_path "
                "unset and no last.ckpt in the run folder) — refusing to "
                "write a submission from randomly initialized weights"
            )
        if ckpt is not None:
            # explicit warm starts fail LOUDLY on an unloadable checkpoint
            # (silently training from random init would masquerade as a
            # warm-started run); only the automatic last.ckpt resume is
            # tolerant of e.g. a checkpoint torn by a crash
            start_epoch = trainer.load_checkpoint(
                ckpt,
                strict=is_warm_start,
                params_only=is_warm_start,
            )
            logger.info("Loaded checkpoint %s (next epoch %d)", ckpt, start_epoch)

        train_events = events[events.split == "train"] if train_ds is not None else None
        rng = np.random.default_rng(self.seed or 0)

        def train_loader(epoch: int):
            assert train_ds is not None
            # every epoch gets fresh jittered windows, epoch 0 included
            # (reference JitterWindows.on_train_epoch_start, callbacks.py:25)
            jitter = float(rng.uniform(-1, 1) * START_JITTER_SECONDS)
            self.data.recut_segments(train_ds, train_events, jitter)
            return prefetch_to_device(
                train_ds.batches(
                    batch_size=batch_size,
                    shuffle=True,
                    seed=(self.seed or 0) + epoch,
                    num_workers=num_workers,
                    drop_remainder=self.data.drop_last,
                ),
                device=trainer.device,
            )

        def val_loader():
            assert val_ds is not None
            return val_ds.batches(batch_size=batch_size, num_workers=num_workers)

        if not self.test_only and train_ds is not None and val_ds is not None:
            trainer.fit(train_loader, val_loader, start_epoch=start_epoch)

        results: dict[str, float] = {}
        if val_ds is not None:
            results.update(trainer.evaluate(val_loader(), split="val"))
            # per-voxel pearson for ensemble weighting (reference
            # pearson.npy): reuse the streaming metric state accumulated by
            # evaluate() — a second predict pass over val doubles inference
            pv = trainer.metrics.get("val/pearson")
            if not isinstance(pv, MultidimPearsonCorrCoef):
                pv = MultidimPearsonCorrCoef(num_outputs=n_outputs)
                for preds, batch in trainer.predict(val_loader()):
                    y_true = batch.data["fmri"]
                    yp = np.swapaxes(preds, 1, 2).reshape(-1, preds.shape[1])
                    yt = np.swapaxes(np.asarray(y_true), 1, 2).reshape(
                        -1, y_true.shape[1]
                    )
                    pv.update(torch.from_numpy(yp), torch.from_numpy(yt))
            if writer:
                np.save(Path(self.infra.folder) / "pearson.npy", pv.per_voxel())

        # test/* metrics: only computable when the test split carries REAL
        # fmri targets (held-out-with-targets studies).  The Algonauts
        # challenge test split is submission-only — the adapter never
        # emits test Fmri events (data/algonauts.py:177) — so it skips
        # with a log line.  The check is on EVENTS, not on the probe
        # batch: a prepared Fmri feature fills windows with its zeros
        # missing-default, so "fmri" appears in every test batch and a
        # batch-level check would score predictions against zeros and log
        # meaningless exact-0.0 metrics rows (r5 review; supersedes the
        # r4 probe-batch guard).
        if (
            test_ds is not None
            and len(test_ds)
            and any(k.startswith("test/") for k in trainer.metrics)
        ):
            has_targets = not events[
                (events.split == "test") & (events.type == "Fmri")
            ].empty
            if has_targets:
                results.update(
                    trainer.evaluate(
                        test_ds.batches(batch_size=batch_size, num_workers=num_workers),
                        split="test",
                    )
                )
            else:
                logger.info(
                    "test split has no Fmri target events (submission-only): "
                    "test/* metrics skipped"
                )

        # metrics.csv (reference main.py:504-506)
        all_metrics = {**trainer.callback_metrics, **results}
        if writer:
            pd.DataFrame([all_metrics]).to_csv(
                Path(self.infra.folder) / "metrics.csv", index=False
            )

        if test_ds is not None and len(test_ds):
            self.write_submission(trainer, test_ds, batch_size, writer=writer)
        return {k: float(v) for k, v in all_metrics.items() if isinstance(v, (int, float))}

    def _get_checkpoint_path(self) -> tuple[Path | None, bool]:
        """(path, is_warm_start).  The run's OWN last.ckpt always wins: a
        preempted warm-started run must resume its progress, not re-warm-
        start from the pretrained checkpoint and retrain from epoch 0 on
        every restart."""
        last = Path(self.infra.folder) / "last.ckpt"
        if last.exists():
            if self.checkpoint_path:
                # say so out loud: re-running a folder with a NEW warm-start
                # checkpoint silently resumes the stale run otherwise
                # (ADVICE r3 #3)
                logger.warning(
                    "Resuming from the run's own %s; the configured "
                    "checkpoint_path=%s is IGNORED (delete last.ckpt or use "
                    "a fresh folder to warm-start from it)",
                    last,
                    self.checkpoint_path,
                )
            return last, False
        if self.checkpoint_path:
            path = Path(self.checkpoint_path)
            assert path.exists(), f"Checkpoint path {path} does not exist."
            return path, True
        return None, False

    # -- submission (reference callbacks.py:47-103) -----------------------
    @staticmethod
    def _season_prefix(movie_label: str) -> str:
        """Challenge chunk prefix from an events movie label ("movie:7" ->
        "s07"; non-numeric labels pass through, e.g. movie10 films)."""
        movie = str(movie_label).split(":")[-1]
        return f"s{int(movie):02d}" if movie.isdigit() else movie

    @staticmethod
    def _samples_tag(season: str) -> str:
        """Stem of the target_sample_number file for a season prefix
        ("s07" -> "friends-s7")."""
        if season[:1] == "s" and season[1:].isdigit():
            return f"friends-s{int(season[1:])}"
        return season

    def write_submission(
        self, trainer: BrainTrainer, test_ds: SegmentDataset, batch_size: int,
        writer: bool = True,
    ) -> None:
        """The challenge submission from the test split's predictions (every
        rank predicts; only ``writer`` writes)."""
        submission: dict[str, dict[str, list[np.ndarray]]] = {}
        seasons: dict[str, set[str]] = {}
        loader = test_ds.batches(batch_size=batch_size)
        for preds, batch in trainer.predict(loader):
            for i, segment in enumerate(batch.segments):
                ev = segment.events
                subject = ev.subject.unique()[0].split("/")[-1]
                # chunk name follows the data (reference callbacks.py:66-68
                # hardcodes "s07"; a non-s7 test split would mislabel there)
                season = self._season_prefix(ev.movie.unique()[0])
                seasons.setdefault(subject, set()).add(season)
                chunk = season + ev.chunk.unique()[0].split(":")[1]
                pred = preds[i].T  # (T, n_outputs)
                submission.setdefault(subject, {}).setdefault(chunk, []).append(pred)

        # same nested-directory resolution as timeline discovery — a parent
        # study path must not train fine and then crash at submission time
        study_root = self.data.study.study_cls().resolve_root(self.data.study.path)
        root = study_root / "download" / "algonauts_2025.competitors"
        out: dict[str, dict[str, np.ndarray]] = {}
        for subject, chunks in submission.items():
            # merge the target sample counts of every season this subject's
            # test chunks came from
            target: dict[str, int] = {}
            for season in sorted(seasons[subject]):
                samples_file = (
                    root
                    / "fmri"
                    / subject
                    / "target_sample_number"
                    / f"{subject}_{self._samples_tag(season)}_fmri_samples.npy"
                )
                target.update(np.load(samples_file, allow_pickle=True).item())
            out[subject] = {}
            for chunk, n_samples in target.items():
                if chunk not in chunks:
                    raise ValueError(f"No predictions for {subject}/{chunk}")
                result = np.concatenate(chunks[chunk], axis=0)
                if len(result) < n_samples:
                    raise ValueError(
                        f"{len(result)} predictions for {chunk}, expected >= {n_samples}"
                    )
                out[subject][chunk] = result[:n_samples]

        if not writer:
            return
        path = Path(self.infra.folder) / "submission.npy"
        np.save(path, out)  # type: ignore[arg-type]
        with zipfile.ZipFile(path.with_suffix(".zip"), "w") as zipf:
            zipf.write(path, arcname=path.name)
        logger.info("Saved submission to %s", path.with_suffix(".zip"))
