"""Microbench of the attention kernel variants on the card.

The port of scripts/bench_attn.py, at the video path's shapes: window
batch 4 x 22 heads x 8192 tokens x head dim 64, bf16.

    python -m algonauts2025_tpu_torch.scripts.bench_attn [variant ...]

Variants (default: fast bounded):

- ``default``: ``flash_attention``'s dispatch, ``flash_forward`` at d = 64;
- ``fast`` / ``fastb16``: ``fast_flash_attention`` with fp32 / bf16 scores;
- ``bounded``: ``flash_attention`` (the bounded kernel's function, which
  the dispatch picks at d = 64; the JAX version's block sizes have no
  counterpart);
- ``packed``: ``flash_attention_packed``;
- ``all``: every variant above.

Each timing runs R serialized calls (each call's output is the next q) and
takes the best of 3 from CUDA events.  Every requested variant other than
``fast`` is then held against ``fast`` on the (1, 2)-head slice.  Names the
port has no counterpart for (``boundb16``, the ``bounded:qb:kvb`` block
sweep) print "not available".  A failing variant raises.
"""

from __future__ import annotations

import sys
import time
import typing as tp

import torch

from ..ops import flash_attention as fa
from ..runtime import default_device

__all__ = ["VARIANTS", "run", "main"]

B, H, T, D = 4, 22, 8192, 64
R = 8  # serialized kernel calls per timing
REPS = 3
#: name -> (function of q, k, v; the launch counter of its kernel)
VARIANTS: dict[str, tuple[tp.Callable, str]] = {
    "default": (fa.flash_attention, "flash_attention"),
    "fast": (fa.fast_flash_attention, "flash_fast"),
    "fastb16": (lambda q, k, v: fa.fast_flash_attention(q, k, v, torch.bfloat16), "flash_fast"),
    "bounded": (fa.flash_attention, "flash_attention"),
    "packed": (fa.flash_attention_packed, "flash_packed"),
}


def timeit(name: str, fn: tp.Callable, q, k, v) -> float:
    """Best of REPS timings of R serialized calls, in ms a call: CUDA
    events on the card, the host clock on the CPU."""

    def loop():
        x = q
        for _ in range(R):
            x = fn(x, k, v).to(q.dtype)  # the output is the next q
        return x

    loop()  # warm up
    best = float("inf")
    for _ in range(REPS):
        if q.is_cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loop()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / R
        else:
            t0 = time.perf_counter()
            loop()
            ms = (time.perf_counter() - t0) * 1e3 / R
        best = min(best, ms)
    per_win_40 = best * 40 / q.shape[0] / 1e3
    print(f"{name:18s} {best:8.2f} ms/call   ({per_win_40:.3f} s/window over 40 layers)", flush=True)
    return best


def rel_err(name: str, fn: tp.Callable, ref: torch.Tensor, q, k, v) -> tuple[float, float]:
    """Max-abs and mean relative error of ``fn`` against ``ref``."""
    err = (fn(q, k, v).float() - ref.float()).abs()
    mx, rel = err.max().item(), (err.mean() / ref.float().abs().mean()).item()
    print(f"{name:18s} max_abs={mx:.2e} mean_rel={rel:.2e}", flush=True)
    return mx, rel


def run(
    variants: tp.Sequence[str],
    device: str | torch.device | None = None,
    shape: tuple[int, int, int, int] = (B, H, T, D),
) -> dict:
    """Time and check ``variants`` on seeded bf16 (B, H, T, D) inputs
    (``device`` and ``shape`` let the CPU test run it small).

    Returns ``{"ms": {name: ms}, "err": {name: (max_abs, mean_rel)},
    "launches": {counter: n}}``, the last being the kernel launches the run
    makes on a CUDA card: (1 + REPS) * R per timed variant, one per checked
    variant and one for the reference."""
    device = default_device(device)
    names = [name for v in variants for name in (VARIANTS if v == "all" else [v])]
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16) for _ in range(3))
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    print(f"bench_attn {tuple(shape)} bfloat16 on {device} ({clock}), R={R}, best of {REPS}", flush=True)
    result: dict = {"ms": {}, "err": {}, "launches": {}}
    launches = result["launches"]
    found = [name for name in names if name in VARIANTS]
    for name in names:
        if name not in VARIANTS:
            print(f"{name}: not available, skipped", flush=True)
            continue
        fn, counter = VARIANTS[name]
        result["ms"][name] = timeit(name, fn, q, k, v)
        launches[counter] = launches.get(counter, 0) + (1 + REPS) * R

    # error against the online-max fp32 kernel on a small slice, only for
    # the variants requested
    checked = [name for name in found if name != "fast"]
    if checked:
        qs, ks, vs = q[:1, :2], k[:1, :2], v[:1, :2]
        ref = fa.fast_flash_attention(qs, ks, vs)
        launches["flash_fast"] = launches.get("flash_fast", 0) + 1
        for name in checked:
            fn, counter = VARIANTS[name]
            result["err"][name] = rel_err(name, fn, ref, qs, ks, vs)
            launches[counter] = launches.get(counter, 0) + 1
    return result


def main(argv: tp.Sequence[str] | None = None) -> dict:
    return run(list(argv if argv is not None else sys.argv[1:]) or ["fast", "bounded"])


if __name__ == "__main__":
    main()
