"""Seeds and seeded tensors: every input and weight of a run comes from ``--seed``.

``derive(seed, tag)`` gives each consumer (weights, batches, windows) its
own stream.  ``seeded_tensors`` makes a set of named tensors from one
``torch.Generator`` in one normal draw, on the device, so that both the
program and the reference get the same values without either handing them
to the other.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: (name, shape, init): init is ("normal", std), ("zeros",) or ("ones",)
Spec = list[tuple[str, tuple[int, ...], tuple]]


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for ``tag`` under the run's ``seed``."""
    words = [int(b) for b in tag.encode()]
    state = np.random.SeedSequence([seed & 0xFFFFFFFFFFFFFFFF, *words]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def seeded_tensors(spec: Spec, seed: int, device: torch.device | str,
                   dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """The tensors of ``spec`` in ``dtype`` on ``device``: the normal
    entries are views of one standard-normal draw (scaled by their std), in
    the order of ``spec``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {name: math.prod(shape) for name, shape, _ in spec}
    n_normal = sum(sizes[name] for name, _, init in spec if init[0] == "normal")
    normal = torch.randn(n_normal, generator=gen, device=device, dtype=dtype) if n_normal else None
    out: dict[str, torch.Tensor] = {}
    offset = 0
    for name, shape, init in spec:
        kind = init[0]
        if kind == "normal":
            out[name] = normal[offset:offset + sizes[name]].view(shape).mul_(init[1])
            offset += sizes[name]
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
    return out
