"""Multi-process helpers of the port's parallel tests (not a test module).

``spawn`` runs ``fn(rank, world, *args)`` in ``world`` fresh processes
(the ``spawn`` start method) joined by a gloo process group on a free
localhost port, and returns each rank's result.  Every wait has a
deadline: a hung rank fails the test instead of eating the suite's time
limit, and every process is killed in a ``finally``.  The workers below
import only torch and the port (no JAX), so a rank starts in seconds.
"""

from __future__ import annotations

import multiprocessing
import queue
import socket
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

#: each multi-process test's deadline, seconds
TIMEOUT = 120
REPO = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(fn, rank: int, world: int, port: int, results, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        results.put((rank, True, fn(rank, world, *args)))
    except Exception:  # reported to the parent, which fails the test
        results.put((rank, False, traceback.format_exc()))
        raise
    dist.barrier()  # neither rank tears down while the other still talks
    dist.destroy_process_group()


def spawn(fn, world: int, *args, timeout: float = TIMEOUT) -> list:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each run
    in its own process of a gloo world; raises if a rank fails or the
    deadline passes."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_run, args=(fn, rank, world, port, results, args))
             for rank in range(world)]
    deadline = time.monotonic() + timeout
    out: dict[int, object] = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                waiting = sorted(set(range(world)) - set(out))
                dead = [r for r in waiting if procs[r].exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks {dead} died with no result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {waiting} gave no result within {timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]


# -- workers -----------------------------------------------------------------


def _trainer(cfg: dict, mesh, folder=None):
    from algonauts2025_tpu_torch.models import FmriEncoderConfig
    from algonauts2025_tpu_torch.training import (
        BrainTrainer, OptimConfig, TrainerConfig, build_loss, build_metric,
    )

    model = FmriEncoderConfig(**cfg["model"]).build(cfg["dims"], n_outputs=cfg["n_out"],
                                                    n_output_timesteps=cfg["n_tr"])
    metrics = {"val/pearson": build_metric({"log_name": "pearson",
                                            "name": "MultidimPearsonCorrCoef"})}
    return BrainTrainer(
        model=model,
        loss_fn=build_loss({"name": cfg.get("loss", "MSELoss")}),
        optim_config=OptimConfig(optimizer={"name": cfg.get("optimizer", "Adam"),
                                            "lr": cfg.get("lr", 1e-3)}),
        metrics=metrics,
        config=TrainerConfig(n_epochs=cfg.get("n_epochs", 2), folder=folder,
                             save_checkpoints=folder is not None, seed=0,
                             contrastive_weight=cfg.get("contrastive_weight", 0.0)),
        device="cpu",
        mesh=mesh,
    )


def _load_full(trainer, full: dict, model_parallel: int, mesh) -> None:
    """This rank's part of a full (converted) state dict into the model."""
    from algonauts2025_tpu_torch.parallel.sharding import shard_state_dict, state_shardings

    specs = state_shardings(full, model_parallel)
    rank = mesh.get_local_rank("model") if mesh is not None else 0
    trainer.model.load_state_dict(shard_state_dict(full, specs, rank, model_parallel))


def fit_on_mesh(rank: int, world: int, model_parallel: int, cfg: dict, full: dict,
                batch: dict, folder: str | None) -> dict:
    """Two epochs of ``fit`` on a (world // mp, mp) mesh from the full
    initial weights ``full``; returns the history and the split shapes."""
    from algonauts2025_tpu_torch.data import SegmentData
    from algonauts2025_tpu_torch.parallel import get_mesh

    mesh = get_mesh(world, model_parallel)
    trainer = _trainer(cfg, mesh, folder)
    data = SegmentData(data=batch, segments=[None] * len(batch["fmri"]))
    trainer.init_state(data, total_steps=4)
    _load_full(trainer, full, model_parallel, mesh)
    shapes = {k: tuple(v.shape) for k, v in trainer.model.state_dict().items()}
    trainer.fit(lambda epoch: iter([data]), lambda: iter([data]))
    preds = next(trainer.predict([data]))[0]
    params = {k: v.numpy() for k, v in trainer._full_state_dict().items()}
    # the full checkpoint loads back into this rank's parts, optimizer too
    opt_state = trainer.optimizer.state_dict()
    assert trainer.load_checkpoint(f"{folder}/last.ckpt") == 2
    for name, value in trainer._full_state_dict().items():
        np.testing.assert_array_equal(value.numpy(), params[name], err_msg=name)
    for index, state in trainer.optimizer.state_dict()["state"].items():
        for key, value in state.items():
            torch.testing.assert_close(value, opt_state["state"][index][key], rtol=0, atol=0)
    return {"history": trainer.history, "shapes": shapes, "preds": preds, "params": params}


def one_step(rank: int, world: int, model_parallel: int, cfg: dict, full: dict,
             batch: dict, contiguous_qkv: bool = False) -> dict:
    """One train step on the mesh from ``full``; returns the loss, the
    InfoNCE losses and the full updated params (gathered)."""
    from algonauts2025_tpu_torch.parallel import get_mesh, sharding

    if contiguous_qkv:
        # the split that T2 rules out: two contiguous halves of the rows
        def contiguous(name, full_t, dim, r, n):
            if dim is None or n == 1:
                return full_t
            return full_t.chunk(n, dim=dim)[r].contiguous()

        sharding.shard_tensor = contiguous
        import algonauts2025_tpu_torch.training.trainer as trainer_module

        trainer_module.shard_tensor = contiguous
    mesh = get_mesh(world, model_parallel)
    trainer = _trainer(cfg, mesh)
    from algonauts2025_tpu_torch.data import SegmentData

    trainer.init_state(SegmentData(data=batch, segments=[None] * len(batch["fmri"])),
                       total_steps=2)
    _load_full(trainer, full, model_parallel, mesh)
    loss, aux = trainer.train_step({k: torch.from_numpy(v) for k, v in batch.items()})
    params = {k: v.numpy() for k, v in trainer._full_state_dict().items()}
    return {"loss": loss.item(), "aux": {k: v.item() for k, v in aux.items()}, "params": params}


def train_steps(rank: int, world: int, model_parallel: int, runs: list) -> list[dict]:
    """For each ``(cfg, full, batches)`` of ``runs``: one train step a batch
    on a fresh mesh from ``full``; returns the losses, the full params and
    the full optimizer state (as a checkpoint holds it), after checking
    that the full state cuts back to this rank's."""
    from algonauts2025_tpu_torch.parallel import get_mesh

    out = []
    for cfg, full, batches in runs:
        mesh = get_mesh(world, model_parallel)
        trainer = _trainer(cfg, mesh)
        trainer.init_state(None, total_steps=len(batches))
        _load_full(trainer, full, model_parallel, mesh)
        losses = [trainer.train_step({k: torch.from_numpy(v) for k, v in b.items()})[0].item()
                  for b in batches]
        state = trainer._host_state()
        local = trainer.optimizer.state_dict()["state"]
        for index, values in trainer._optimizer_states(state["opt_state"], False)["state"].items():
            for key, value in values.items():
                torch.testing.assert_close(value, local[index][key], rtol=0, atol=0)
        out.append({
            "losses": losses,
            "params": {k: v.numpy() for k, v in state["params"].items()},
            "opt_state": {i: {k: v.numpy() for k, v in values.items()}
                          for i, values in state["opt_state"]["state"].items()},
        })
    return out


def make_batch(cfg: dict, b: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    data = {m: rng.standard_normal((b, n_layers, d, 20)).astype(np.float32)
            for m, (n_layers, d) in cfg["dims"].items()}
    data["subject_id"] = rng.integers(0, 4, size=(b, 1))
    data["fmri"] = rng.standard_normal((b, cfg["n_out"], cfg["n_tr"])).astype(np.float32)
    return data
