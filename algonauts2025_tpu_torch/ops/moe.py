"""Routed experts of a mixture-of-experts layer (DeepSeek's fine-grained MoE).

The parts of ``DeepseekV2MoE`` (the checkpoint's ``modeling_deepseek.py``)
between the router and the shared experts:

- ``route``: the router in float32 (the bf16 hidden state upcast, an fp32
  gate, softmax over every expert, greedy top-k; the top-k weights left as
  they are unless the configuration renormalises them), as
  ``DeepseekV2MoEGate`` computes it;
- ``sort_by_expert``: the (token, slot) pairs in expert order and each
  expert's end offset, all device tensors (``scatter_add_``: no
  ``bincount``, no host read);
- ``routed_experts``: each expert's SwiGLU on its rows, then the weighted
  sum over a token's k slots in float32, cast back to the rows' dtype.

The experts run as two grouped GEMMs over the sorted rows
(``torch._grouped_mm``, the gate and up projections in one) on every
device: bf16 on the card (sm_90), float32 or bf16 on the CPU; whatever the
grouped call refuses raises, and nothing falls back.
``expert_rows_plain``, a loop over the experts that gives the same (N, k,
D) rows in (token, slot) order, is the tests' oracle.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["route", "sort_by_expert", "swiglu", "expert_rows_grouped", "expert_rows_plain", "combine",
           "routed_experts"]


def route(x: torch.Tensor, gate_weight: torch.Tensor, top_k: int, norm_topk_prob: bool = False,
          scaling: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, D) hidden states -> the float32 (N, k) weights and the (N, k)
    expert ids of the greedy top-k of the softmax over the experts."""
    logits = F.linear(x.float(), gate_weight.float())
    scores = logits.softmax(dim=-1, dtype=torch.float32)
    weights, ids = torch.topk(scores, top_k, dim=-1, sorted=False)
    if norm_topk_prob:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    return weights * scaling, ids


def sort_by_expert(ids: torch.Tensor, n_experts: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (N x k,) slots of ``ids`` in expert order (stable: a token's rows
    keep their order within an expert) and the int32 end offset of each
    expert's rows, on the device of ``ids``."""
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.int32, device=ids.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return order, torch.cumsum(counts, dim=0, dtype=torch.int32)


def swiglu(h: torch.Tensor) -> torch.Tensor:
    """silu(gate) x up of the (rows, 2F) output of the fused gate and up
    projections, in its dtype."""
    gate, up = h.chunk(2, dim=-1)
    return F.silu(gate) * up


def expert_rows_grouped(x: torch.Tensor, ids: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """(N, D) rows, (N, k) expert ids, the stacked (E, 2F, D) gate-and-up and
    (E, D, F) down weights -> the (N, k, D) expert outputs: the rows sorted
    by expert, two grouped GEMMs, the outputs put back in (token, slot)
    order."""
    n, k = ids.shape
    order, offsets = sort_by_expert(ids, w13.shape[0])
    rows = x[order // k]
    h = swiglu(torch._grouped_mm(rows, w13.transpose(1, 2), offs=offsets))
    out = torch._grouped_mm(h, w2.transpose(1, 2), offs=offsets)
    return torch.empty_like(out).index_copy_(0, order, out).view(n, k, -1)


def expert_rows_plain(x: torch.Tensor, ids: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """``expert_rows_grouped`` as a loop over the experts, each over the
    rows routed to it in ascending (token, slot) order: the tests' oracle."""
    n, k = ids.shape
    flat = ids.reshape(-1)
    out = x.new_empty(n * k, w2.shape[1])
    for e in range(w13.shape[0]):
        slots = (flat == e).nonzero().squeeze(1)
        if slots.numel():
            out[slots] = swiglu(x[slots // k] @ w13[e].T) @ w2[e].T
    return out.view(n, k, -1)


def combine(rows: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(N, k, D) expert outputs and float32 (N, k) weights -> (N, D): the
    weighted sum in float32, cast to the outputs' dtype."""
    return (rows.float() * weights[..., None]).sum(dim=1).to(rows.dtype)


def routed_experts(x: torch.Tensor, weights: torch.Tensor, ids: torch.Tensor, w13: torch.Tensor,
                   w2: torch.Tensor) -> torch.Tensor:
    """The routed experts' (N, D) output: the grouped GEMMs (raising where
    they cannot run) and the float32 combine."""
    return combine(expert_rows_grouped(x, ids, w13, w2), weights)
