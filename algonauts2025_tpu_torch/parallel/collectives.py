"""The collectives of data and tensor parallelism, with their gradients.

Under XLA SPMD a loss over a sharded batch is global by construction; a
torch process sees only its own rows and weights.  These autograd
functions make the values global where the math needs them:

- ``gather_rows``: all-gather along axis 0 over the data group; its
  backward all-reduces the gradient and keeps this rank's rows, so after
  the mean of the gradients over the data group (``Parallel.reduce_grads``)
  each parameter holds the gradient of the one-device step;
- the Megatron pair over the model group: ``copy_to`` (identity forward,
  all-reduce backward) in front of a column-parallel layer and
  ``reduce_from`` (all-reduce forward, identity backward) behind a
  row-parallel one;
- ``gather_from``: all-gather along a dim over the model group, whose
  backward keeps this rank's slice (every rank of the group computes the
  same loss from the gathered tensor).

``torch.distributed.nn.functional.all_gather`` does what ``gather_rows``
does but warns that it is deprecated; these run on gloo and NCCL alike.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["gather_rows", "copy_to", "reduce_from", "gather_from", "TensorParallel", "Parallel"]

#: the gradient mean's bucket: 64 M fp32 elements (256 MB), so that the
#: flat copy stays a fraction of the 0.94 B flagship's gradients
BUCKET_ELEMENTS = 1 << 26


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _own(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x.chunk(dist.get_world_size(group), dim=dim)[dist.get_rank(group)].contiguous()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, 0, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return _own(grad, 0, ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()  # a fresh tensor: the all-reduce writes in place
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _own(grad, ctx.dim, ctx.group), None, None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherRows.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherFrom.apply(x, dim, group)


class TensorParallel:
    """The model group as the split modules see it (``module.tp``): the
    transformer's attention and FF and the subject readout call these
    around their local matmuls."""

    def __init__(self, group) -> None:
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return gather_from(x, dim, self.group)


class Parallel:
    """What a trainer needs of a ``("data", "model")`` mesh: the groups,
    this process's ranks, the row gather of a split batch, the mean of the
    gradients over the data group, the optimizer's sums over the model
    group and whether this process writes files."""

    def __init__(self, mesh: DeviceMesh) -> None:
        self.mesh = mesh
        self.data_group = mesh.get_group("data")
        self.model_group = mesh.get_group("model")
        self.n_data = mesh.size(0)
        self.n_model = mesh.size(1)
        self.tp = TensorParallel(self.model_group) if self.n_model > 1 else None
        self.writer = dist.get_rank() == 0

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        return gather_rows(x, self.data_group)

    @torch.no_grad()
    def reduce_grads(self, params: tp.Iterable[torch.Tensor]) -> None:
        """Mean of each gradient over the data group, one flat all-reduce
        a bucket of ~BUCKET_ELEMENTS (every rank holds gradients for the
        same parameters: the modality-dropout draws are the same on every
        rank)."""
        if self.n_data == 1:
            return
        bucket: list[torch.Tensor] = []
        for grad in (p.grad for p in params if p.grad is not None):
            bucket.append(grad)
            if sum(g.numel() for g in bucket) >= BUCKET_ELEMENTS:
                self._mean(bucket)
                bucket = []
        if bucket:
            self._mean(bucket)

    @torch.no_grad()
    def sum_over_model(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each tensor summed over the model group, in one flat all-reduce:
        the partial sums of a whole-parameter optimizer stage (Adafactor's
        statistics, LAMB's norms) for every split parameter at once."""
        return _sum_flat(parts, self.model_group)

    def _mean(self, grads: list[torch.Tensor]) -> None:
        for g, total in zip(grads, _sum_flat(grads, self.data_group)):
            g.copy_(total).div_(self.n_data)


def _sum_flat(parts: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Each tensor summed over ``group`` through one all-reduce of their
    concatenation; views of it, shaped as ``parts``."""
    flat = torch.cat([x.reshape(-1) for x in parts])
    dist.all_reduce(flat, group=group)
    return [piece.view_as(x) for piece, x in zip(flat.split([x.numel() for x in parts]), parts)]
