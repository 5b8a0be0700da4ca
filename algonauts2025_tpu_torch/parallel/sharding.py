"""Which parameters split over the mesh's "model" axis, and how.

The port of algonauts2025_tpu/parallel/sharding.py.  Pure data parallelism
replicates the parameters; with ``model`` > 1 the large weights split
(tensor parallelism), after the JAX rules:

- the SubjectLayers readout: the parcel axis of ``predictor.weights``
  (S, C, O) and ``predictor.bias`` (S, O);
- the trunk FF: ``fc1`` column-parallel (the rows of its (4D, D) torch
  weight, and its bias with them), ``fc2`` row-parallel (the columns of
  its (D, 4D) weight);
- the attention: ``qkv`` column-parallel by whole heads, ``out``
  row-parallel.

Everything else is replicated.  The JAX package only annotates and XLA
inserts the collectives; here ``param_spec`` names the dim to split,
``shard_tensor`` cuts a rank's part, and the split modules run the
Megatron collectives of ``parallel.collectives`` (``module.tp``).

Two things differ from a contiguous split of the JAX kernels, because a
torch rank must compute its part alone: the fused qkv weight holds its
rows in (3, heads, head dim) order, so a rank takes h/tp whole heads of
each of q, k and v; and fc1's bias goes with fc1's rows.  A split that
does not divide replicates its module's parameters, with the JAX
package's warning.
"""

from __future__ import annotations

import logging
import typing as tp

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

logger = logging.getLogger(__name__)

__all__ = ["param_spec", "state_shardings", "sharding_report", "shard_tensor",
           "shard_state_dict", "unshard_tensor", "apply_tensor_parallel"]

#: the fused qkv weight: its rows are (3, heads, head dim)
QKV = ".attn.qkv.weight"


def param_spec(name: str, shape: tuple[int, ...], model_axes: int) -> int | None:
    """The dim of the port parameter ``name`` that splits over "model"
    (None: replicated)."""
    if model_axes <= 1 or not shape:
        return None
    if name.startswith("predictor.") and name.endswith(("weights", "bias")):
        return len(shape) - 1  # parcels
    if "blocks." in name:
        if name.endswith((".ff.fc1.weight", ".ff.fc1.bias", QKV)):
            return 0  # column-parallel: output features
        if name.endswith((".ff.fc2.weight", ".attn.out.weight")):
            return 1  # row-parallel: input features
    return None


def _unit(name: str) -> str:
    """The module whose split parameters must split together."""
    for cut in (".attn.", ".ff."):
        if cut in name:
            return name[: name.index(cut) + len(cut)]
    return name.rsplit(".", 1)[0]


def _model_axes(mesh: DeviceMesh | int) -> int:
    return mesh if isinstance(mesh, int) else mesh["model"].size()


def state_shardings(
    params: nn.Module | tp.Mapping[str, tp.Any], mesh: DeviceMesh | int
) -> dict[str, int | None]:
    """Parameter name -> split dim over the "model" axis of ``mesh`` (or
    over that many ranks).

    ``params`` is a model or a mapping of names to tensors (shapes are
    read).  A split that does not divide falls back to replication for
    every parameter of its module, loudly: a silently replicated readout
    on a tp > 1 mesh trains slower with no other signal.  The qkv weight
    divides when its head count does (read from a model's attention
    modules; from a mapping, its rows must divide 3 x model_axes)."""
    model_axes = _model_axes(mesh)
    heads: dict[str, int] = {}
    if isinstance(params, nn.Module):
        for mod_name, module in params.named_modules():
            if hasattr(module, "qkv") and hasattr(module, "heads"):
                heads[f"{mod_name}.qkv.weight"] = module.heads
        params = dict(params.named_parameters())
    specs = {name: param_spec(name, tuple(p.shape), model_axes) for name, p in params.items()}
    bad_units = set()
    for name, dim in specs.items():
        if dim is None:
            continue
        size = params[name].shape[dim]
        if name.endswith(QKV):
            ok = (heads[name] % model_axes == 0) if name in heads else size % (3 * model_axes) == 0
        else:
            ok = size % model_axes == 0
        if not ok:
            logger.warning(
                "param %s shape %s does not divide model=%d on dim %d; replicating "
                "(tensor parallelism disabled for it)",
                name, tuple(params[name].shape), model_axes, dim,
            )
            bad_units.add(_unit(name))
    return {name: None if _unit(name) in bad_units else dim for name, dim in specs.items()}


def sharding_report(
    params: nn.Module | tp.Mapping[str, tp.Any], mesh: DeviceMesh | int
) -> dict[str, int]:
    """How many parameter elements split over "model" and how many are
    replicated: the observability hook for "is tp actually engaged?"."""
    named = dict(params.named_parameters()) if isinstance(params, nn.Module) else params
    specs = state_shardings(params, mesh)
    counts = {"sharded": 0, "replicated": 0}
    for name, p in named.items():
        counts["sharded" if specs[name] is not None else "replicated"] += p.numel()
    return counts


def shard_tensor(name: str, full: torch.Tensor, dim: int | None, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s part of the full parameter ``name`` split ``n`` ways
    on ``dim``: a contiguous block, except qkv, whose rows are taken as
    h/n whole heads of each of q, k and v."""
    if dim is None or n == 1:
        return full
    if name.endswith(QKV):
        return torch.cat([part.chunk(n, dim=0)[rank] for part in full.chunk(3, dim=0)])
    return full.chunk(n, dim=dim)[rank].contiguous()


def unshard_tensor(name: str, parts: tp.Sequence[torch.Tensor], dim: int | None) -> torch.Tensor:
    """The full parameter from every rank's part (``shard_tensor``'s inverse)."""
    if dim is None or len(parts) == 1:
        return parts[0]
    if name.endswith(QKV):
        thirds = [p.chunk(3, dim=0) for p in parts]
        return torch.cat([torch.cat([t[i] for t in thirds]) for i in range(3)])
    return torch.cat(list(parts), dim=dim)


def shard_state_dict(
    full: tp.Mapping[str, torch.Tensor], specs: tp.Mapping[str, int | None], rank: int, n: int
) -> dict[str, torch.Tensor]:
    """One rank's state dict from a full one (e.g. ``models.convert``'s)."""
    return {k: shard_tensor(k, v, specs.get(k), rank, n) for k, v in full.items()}


def apply_tensor_parallel(model: nn.Module, specs: tp.Mapping[str, int | None], tp_group) -> None:
    """Cut ``model``'s parameters to this rank's parts (in place) and give
    each module with a split parameter the group it computes over
    (``module.tp``: the attention, the FF and the subject readout)."""
    with torch.no_grad():
        for name, param in model.named_parameters():
            dim = specs.get(name)
            if dim is not None:
                param.data = shard_tensor(name, param.data, dim, tp_group.rank, tp_group.size)
    for mod_name, module in model.named_modules():
        if not hasattr(module, "tp"):
            continue
        prefix = f"{mod_name}." if mod_name else ""
        split = [specs.get(prefix + p) is not None for p, _ in module.named_parameters()]
        if any(split):
            module.tp = tp_group
