"""Process groups, device meshes and batch placement.

The port of algonauts2025_tpu/parallel/mesh.py.  The JAX package runs one
program per host over all of its devices, and XLA inserts the collectives.
A torch process drives one device, so a mesh of N devices is N processes
(``torchrun --nproc-per-node N``) joined by ``torch.distributed``:

- ``init_distributed`` joins the launcher's process group (NCCL for the
  card, gloo for the CPU); without a launcher it does nothing;
- ``get_mesh`` is a ``DeviceMesh`` with dims ``("data", "model")``: the
  batch splits over "data", the large weights over "model"
  (``parallel.sharding``);
- ``shard_batch`` gives each data rank its rows of a global batch, or the
  whole batch where its rows do not divide the data axis (eval tails).

Sequence and pipeline parallelism run in one process over an ordered list
of local devices (``LocalMesh``), as the JAX features run them over the
first N local devices.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import typing as tp

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..data.dataset import to_device
from ..runtime import default_device

logger = logging.getLogger(__name__)

__all__ = [
    "init_distributed",
    "get_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "LocalMesh",
    "local_mesh",
]

#: how a run over N devices is launched: one process a device
LAUNCH = "torchrun --nproc-per-node {n} -m algonauts2025_tpu_torch.grids.run_config task.json"


def init_distributed(device: str | torch.device | None = None) -> None:
    """Join the process group of a ``torchrun``-style launch.

    Reads ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
    ``LOCAL_RANK``.  Without ``MASTER_ADDR`` (no launcher) it does nothing.
    The backend is NCCL for the card (``device=None``, as everywhere in the
    port), each process on the card of its ``LOCAL_RANK``, and gloo for
    ``device="cpu"``."""
    if not os.environ.get("MASTER_ADDR"):
        return  # single-process run
    if "WORLD_SIZE" in os.environ and "RANK" not in os.environ:
        # defaulting to 0 would give every worker the same rank and hang
        # the rendezvous with an opaque timeout
        raise RuntimeError("WORLD_SIZE is set but RANK is not; export a distinct RANK per process")
    if dist.is_initialized():
        logger.info("torch.distributed already initialized")
        return
    backend = "nccl" if default_device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        backend,
        init_method="env://",
        rank=int(os.environ.get("RANK", "0")),
        world_size=int(os.environ.get("WORLD_SIZE", "1")),
    )
    logger.info("torch.distributed initialized (%s): rank %d/%d", backend,
                dist.get_rank(), dist.get_world_size())


def get_mesh(n_devices: int | None = None, model_parallel: int = 1) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the launch's processes, shaped
    ``(n // model_parallel, model_parallel)``.

    ``n_devices`` must be the launch's world size (None takes it): a torch
    process drives one device, so more devices need more processes, and a
    run never trains on fewer devices than it asked for.  A mesh needs the
    launch's process group (``init_distributed``)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(
            f"n_devices={n} but this launch has {world} process(es); a torch process "
            f"drives one device, so launch one process a device: {LAUNCH.format(n=n)}"
        )
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: launch with torchrun (or set "
                           "MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK) and call "
                           "init_distributed()")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def batch_sharding(mesh: DeviceMesh) -> tuple[int, int]:
    """(this process's data rank, the data axis size): axis 0 of a batch
    splits into that many row blocks and this process takes its own."""
    return mesh.get_local_rank("data"), mesh.size(0)


def replicated(mesh: DeviceMesh) -> tuple[int, int]:
    """The placement of a batch that every process holds whole."""
    del mesh
    return 0, 1


def shard_batch(
    batch_data: tp.Mapping[str, tp.Any],
    mesh: DeviceMesh | None,
    device: str | torch.device | None = None,
) -> tuple[dict[str, torch.Tensor], bool]:
    """This process's part of a global batch, on ``device``.

    Returns ``(data, split)``: with ``split`` every array holds this data
    rank's contiguous block of rows; without it (no mesh, or rows that do
    not divide the data axis, as eval tails) every process holds the whole
    batch, as the JAX ``shard_batch`` replicates such batches."""
    device = default_device(device)
    rank, n_data = (0, 1) if mesh is None else batch_sharding(mesh)
    rows = {len(v) for v in batch_data.values()}
    split = n_data > 1 and len(rows) == 1 and rows.pop() % n_data == 0
    if split:
        batch_data = {k: torch.as_tensor(v).chunk(n_data)[rank] for k, v in batch_data.items()}
    return to_device(batch_data, device), split


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """An ordered list of local devices with one axis name: the mesh of
    the one-process sequence and pipeline parallelism.  A device may occur
    more than once (the shards then share it, as the CPU's do in the
    tests)."""

    devices: tuple[torch.device, ...]
    axis_name: str

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_name: self.size}

    @property
    def axis_names(self) -> tuple[str]:
        return (self.axis_name,)


def local_mesh(n: int, axis_name: str, device: str | torch.device | None = None) -> LocalMesh:
    """A ``LocalMesh`` of ``n`` shards: the first ``n`` cards (``device=None``,
    raising when fewer are visible), or ``n`` shards of one named device
    (``"cpu"``, or ``"cuda:0"`` for virtual shards on one card)."""
    if device is not None:
        return LocalMesh(tuple([torch.device(device)] * n), axis_name)
    default_device(None)  # raises without a card
    count = torch.cuda.device_count()
    if count < n:
        raise ValueError(f"{axis_name} over {n} devices but only {count} devices are visible")
    return LocalMesh(tuple(torch.device("cuda", i) for i in range(n)), axis_name)
