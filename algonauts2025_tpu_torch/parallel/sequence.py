"""Sequence parallelism: exact ring attention over the shards of a sequence.

The port of algonauts2025_tpu/parallel/sequence.py.  The long-sequence
path of the framework is V-JEPA2 feature extraction, 8192-token full
attention a window.  With the sequence split into n shards, each shard's
queries see the global key/value sequence as the KV shards travel around
a ring: at each of n steps a shard folds the (Tq x Tkv) score block of
the KV shard it holds into running flash statistics (o, m, l), then hands
that KV shard to the next shard.

The JAX package runs this inside ``shard_map`` over a mesh axis of one
program.  The port runs it in one process over the shards of a
``LocalMesh`` (an ordered list of local devices, which may repeat one
device): the neighbour exchange (``lax.ppermute``) is a device-to-device
copy of the KV shard, and autograd follows the copies, so the ring's
gradient needs no custom backward.

The local block is a plain fp32 product, as in the JAX package (no TPU
kernel computes it), with TF32 off by the port's fp32 contract
(``runtime``).  ``causal=True`` adds the decoder mask: each step knows the
shard its KV came from, hence its global key offset.  Masked scores take
-1e30 and the running max starts at -inf, so a fully masked step is wiped
out by the zero correction of the first step that sees a real score.
"""

from __future__ import annotations

import torch

from .mesh import LocalMesh

__all__ = ["ring_attention_local", "sequence_parallel_attention"]


def ring_attention_local(
    q: list[torch.Tensor], k: list[torch.Tensor], v: list[torch.Tensor], causal: bool = False
) -> list[torch.Tensor]:
    """Exact attention of every query shard over the global key/value sequence.

    ``q[r]``: (B, H, Tq_local, D), shard r's queries on its device;
    ``k[r]``/``v[r]``: (B, H, Tkv_local, D), shard r's keys and values.
    Returns shard r's (B, H, Tq_local, D) output on its device, in q's
    dtype (the math runs in fp32)."""
    n = len(q)
    tq, tkv, d = q[0].shape[2], k[0].shape[2], q[0].shape[-1]
    scale = d**-0.5
    qf = [x.float() * scale for x in q]
    b, h = q[0].shape[:2]
    o = [torch.zeros((b, h, tq, d), dtype=torch.float32, device=x.device) for x in q]
    m = [torch.full((b, h, tq), -torch.inf, dtype=torch.float32, device=x.device) for x in q]
    l = [torch.zeros((b, h, tq), dtype=torch.float32, device=x.device) for x in q]
    k_c, v_c = list(k), list(v)
    for step in range(n):
        for r in range(n):
            s = torch.einsum("bhqd,bhkd->bhqk", qf[r], k_c[r].float())
            if causal:
                src = (r - step) % n  # the shard this KV came from
                q_pos = r * tq + torch.arange(tq, device=s.device)[:, None]
                k_pos = src * tkv + torch.arange(tkv, device=s.device)[None]
                s = torch.where(q_pos >= k_pos, s, -1e30)
            m_new = torch.maximum(m[r], s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m[r] - m_new)
            l[r] = l[r] * corr + p.sum(dim=-1)
            o[r] = o[r] * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_c[r].float())
            m[r] = m_new
        if step + 1 < n:
            # the ring: every shard hands its KV shard to the next
            k_c = [k_c[(r - 1) % n].to(q[r].device) for r in range(n)]
            v_c = [v_c[(r - 1) % n].to(q[r].device) for r in range(n)]
    return [(o[r] / l[r][..., None]).to(q[r].dtype) for r in range(n)]


def sequence_parallel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: LocalMesh,
    axis_name: str = "data",
    causal: bool = False,
) -> torch.Tensor:
    """(B, H, T, D) attention with T split over ``mesh[axis_name]``.

    Each shard's rows go to its device, the shards run
    :func:`ring_attention_local`, and the output is assembled on q's
    device.  The shard count must divide T."""
    n = mesh.shape[axis_name]
    t = q.shape[2]
    if t % n:
        raise ValueError(
            f"sequence length {t} not divisible by mesh axis {axis_name!r} of size {n}"
        )

    def split(x: torch.Tensor) -> list[torch.Tensor]:
        return [part.to(dev) for part, dev in zip(x.chunk(n, dim=2), mesh.devices)]

    out = ring_attention_local(split(q), split(k), split(v), causal=causal)
    return torch.cat([part.to(q.device) for part in out], dim=2)
