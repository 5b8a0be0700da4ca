"""Pipeline parallelism for layer stacks (GPipe over a ``LocalMesh``).

The port of algonauts2025_tpu/parallel/pipeline.py.  A stack of L layers
splits into S stages of L/S contiguous layers, one stage a device of the
mesh, and the batch into M microbatches.  :func:`pipeline_scan` runs the
GPipe schedule: M + S - 1 steps, at each step every stage applies its
layers to the microbatch it holds and hands the result to the next stage
(a device-to-device copy, the JAX package's ``ppermute``).  The JAX
package runs the stages in one program over the first N local devices;
the port runs them in one process, stage by stage within a step.

Layer-invariant inputs (RoPE tables, masks) ride as ``consts``: they are
looked up per microbatch and moved once to each stage's device, so only
the evolving activation travels between stages.  The schedule changes
which device computes a layer, never the math applied to one microbatch,
so the result is bitwise that of a sequential run over the same
microbatch shapes, and autograd follows the copies (no custom backward).
"""

from __future__ import annotations

import typing as tp

import torch
from torch.utils import _pytree as pytree

from .mesh import LocalMesh

__all__ = ["pipeline_scan", "pipelined_llama_states", "stage_layers"]


def _layers(stacked_params: tp.Any) -> list[tp.Any]:
    """Per-layer params: a sequence (e.g. an ``nn.ModuleList``) as is, or a
    pytree of (L, ...) tensors sliced along its leading axis."""
    if isinstance(stacked_params, (list, tuple, torch.nn.ModuleList)):
        return list(stacked_params)
    n = pytree.tree_leaves(stacked_params)[0].shape[0]
    return [pytree.tree_map(lambda x, i=i: x[i], stacked_params) for i in range(n)]


def _to(tree: tp.Any, device: torch.device) -> tp.Any:
    return pytree.tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, tree)


def stage_layers(n_layers: int, n_stages: int) -> list[range]:
    """The layer indices of each stage: contiguous blocks of L/S."""
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages")
    per = n_layers // n_stages
    return [range(s * per, (s + 1) * per) for s in range(n_stages)]


def pipeline_scan(
    layer_fn: tp.Callable[..., tp.Any],
    stacked_params: tp.Any,
    activations: tp.Any,
    mesh: LocalMesh,
    axis_name: str = "stage",
    n_microbatches: int = 2,
    collect: tp.Callable[[tp.Any], torch.Tensor] | None = None,
    consts: tp.Any = None,
):
    """Apply an L-layer stack, its stages spread over ``mesh[axis_name]``.

    ``layer_fn(params_one_layer, act) -> act`` is the single-layer body
    (``layer_fn(params, act, const)`` when ``consts`` is given);
    ``activations`` is a pytree whose leaves all have the leading batch
    axis B, which ``n_microbatches`` must divide.  ``consts`` carries
    layer-invariant per-row inputs (same leading axis B) that never travel
    between stages.  ``collect(act)`` extracts a per-layer state;
    collected states return as (L, B, ...).  A layer's params are used
    where they are (place them on their stage's device first, as
    ``TorchTextBackbone(pipeline_mesh=)`` does); tensors of a pytree
    stack are moved to the stage's device per use.

    Returns ``(final_activations, states_or_None)`` with the batch axis
    restored, on the mesh's first device."""
    n_stage = mesh.shape[axis_name]
    layers = _layers(stacked_params)
    stages = stage_layers(len(layers), n_stage)
    b = pytree.tree_leaves(activations)[0].shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by {n_microbatches} microbatches")
    m = n_microbatches
    devices = mesh.devices
    home = devices[0]

    def split(tree):
        return [pytree.tree_map(lambda x, i=i: x.chunk(m)[i], tree) for i in range(m)]

    micro = split(activations)
    consts_m = split(consts) if consts is not None else [None] * m
    # consts move once to each stage's device (per microbatch)
    stage_consts = [[_to(c, dev) for c in consts_m] for dev in devices]
    outputs: list[tp.Any] = [None] * m
    states: list[list[torch.Tensor | None]] = [[None] * m for _ in layers]
    buf: list[tp.Any] = [None] * n_stage  # the activation each stage holds
    for t in range(m + n_stage - 1):
        # later stages first: each consumes what the stage before it
        # produced in the previous step
        for s in reversed(range(n_stage)):
            mb = t - s
            if not 0 <= mb < m:
                continue
            act = _to(micro[mb] if s == 0 else buf[s - 1], devices[s])
            const = stage_consts[s][mb]
            for i in stages[s]:
                params = layers[i]
                if not isinstance(params, torch.nn.Module):
                    params = _to(params, devices[s])
                act = layer_fn(params, act) if consts is None else layer_fn(params, act, const)
                if collect is not None:
                    states[i][mb] = collect(act)
            if s == n_stage - 1:
                outputs[mb] = _to(act, home)
            else:
                buf[s] = act
    out = pytree.tree_map(lambda *xs: torch.cat(xs), *outputs)
    if collect is None:
        return out, None
    return out, torch.stack([torch.cat([st.to(home) for st in layer]) for layer in states])


def pipelined_llama_states(
    cfg,
    model,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor | None,
    mesh: LocalMesh,
    axis_name: str = "stage",
    n_microbatches: int = 2,
) -> torch.Tensor:
    """``LlamaBackbone.forward`` with its layer stack pipelined over ``mesh``.

    The same preamble as the backbone (``attention_inputs``: RoPE tables,
    masks, the right-pad contract, NaN-poisoned left-padded rows) and the
    same (L+1, B, T, D) fp32 state stack (the embedding first, the final
    norm in the last slot); only the layer loop is distributed.  ``model``
    is the ``LlamaBackbone`` whose layers sit on their stages' devices
    (``TorchTextBackbone(pipeline_mesh=)``); its embedding and final norm
    on the mesh's first device."""
    from ..models.backbones.llama import attention_inputs

    b, t = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, t), dtype=torch.int32, device=input_ids.device)
    x = model.embed_tokens(input_ids)
    head = x.float()
    cos, sin, mask, lengths, right_padded = attention_inputs(cfg, attention_mask)
    x = torch.where(right_padded[:, None, None], x, torch.nan)

    def layer_fn(layer, x_, const):
        return layer(x_, *const)

    x, states = pipeline_scan(
        layer_fn, model.layers, x, mesh, axis_name=axis_name, n_microbatches=n_microbatches,
        collect=lambda x_: x_.float(), consts=(cos, sin, mask, lengths),
    )
    states[-1] = model.final_norm(x.to(head.device)).float()
    return torch.cat([head[None], states.to(head.device)])
