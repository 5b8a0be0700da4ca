#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Print the card's name and power limit; build every kernel of
   ``algonauts2025_tpu_torch/csrc`` with nvcc for sm_90a.
2. Hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at edge shapes, and the kernel's autograd
   gradients against autograd of the plain version; time the kernel, the
   plain version and the library call (``scaled_dot_product_attention``,
   a yardstick the port never calls).
3. A small FmriEncoder trained on the card and on the CPU from the same
   weights must agree step by step.
4. The main path at full width: ``BrainTrainer`` on the flagship
   FmriEncoder configured as ``bench.py``'s ``bench_train`` (0.94 B
   params, batch 16 x 298 steps, remat, InfoNCE, bf16-mu Adam, OneCycle),
   with random weights from a seed: ``init_state``, train steps,
   ``evaluate`` with the default grid's three metrics, ``predict``.  The
   kernels' launch counters are zeroed just before and read just after.

The line before the last is the JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from algonauts2025_tpu_torch.data import SegmentData
from algonauts2025_tpu_torch.models import FmriEncoderConfig
from algonauts2025_tpu_torch.ops import _cuda
from algonauts2025_tpu_torch.ops import attention as attn
from algonauts2025_tpu_torch.training import (
    BrainTrainer, OptimConfig, TrainerConfig, build_loss, build_metric,
)

SEED = 0
# (B, H, T, Dh) of the trunk's attention at the flagship: hidden 3072, 8 heads
FLAGSHIP = (16, 8, 298, 384)
TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}

# published dense peaks (NVIDIA data sheets): fp32 without tensor cores,
# bf16 tensor cores, memory bytes/s
PEAKS = {
    "PCIe": {"float32": 51e12, "bfloat16": 756e12, "bytes": 2.0e12},
    "NVL": {"float32": 60e12, "bfloat16": 835e12, "bytes": 3.9e12},
    "SXM": {"float32": 67e12, "bfloat16": 989e12, "bytes": 3.35e12},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks_for(name: str) -> dict[str, float]:
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    if "H100" not in name:
        log(f"note: no peak table for {name!r}; bounds use the H100 SXM data sheet")
    return PEAKS["SXM"]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def card() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script needs a CUDA card")
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {line}")
    return line


def build_kernels() -> None:
    t0 = time.time()
    libs = _cuda.build_all()
    log(f"built {sorted(libs)} in {time.time() - t0:.1f} s")
    for name, text in _cuda.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  nvcc {name}: {line.strip()}")


def qkv(shape, dtype, strided: bool, gen: torch.Generator):
    """q, k, v on the card; ``strided`` takes them as the trunk does, as
    head-split views of one fused (B, T, 3, H, Dh) projection."""
    b, h, t, dh = shape
    if strided:
        fused = torch.randn((b, t, 3, h, dh), generator=gen, device="cuda").to(dtype)
        return fused.permute(2, 0, 3, 1, 4).unbind(0)
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3)]


def check_attention(peaks: dict[str, float]) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [
        (FLAGSHIP, torch.float32, True),
        (FLAGSHIP, torch.bfloat16, False),
        ((2, 4, 37, 24), torch.float32, False),
        ((1, 1, 1, 8), torch.float32, False),
        ((2, 3, 513, 64), torch.float32, False),
        ((2, 3, 513, 64), torch.bfloat16, True),
    ]
    flagship_err = None
    for shape, dtype, strided in cases:
        q, k, v = qkv(shape, dtype, strided, gen)
        out = attn._attention_cuda(q, k, v)
        torch.cuda.synchronize()
        ref = attn.dot_product_attention(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        ok = out.dtype == dtype and out.shape == q.shape and err <= TOL[dtype]
        log(f"attention {shape} {str(dtype)[6:]}{' strided' if strided else ''}: "
            f"max_abs_err {err:.3e} (tol {TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("attention kernel disagrees with its plain version")
        if shape == FLAGSHIP and dtype == torch.float32:
            flagship_err = err

    # the autograd.Function's analytic backward against autograd of the plain version
    q, k, v = qkv((2, 3, 37, 24), torch.float32, False, gen)
    g = torch.randn(q.shape, generator=gen, device="cuda")
    a = [x.clone().requires_grad_(True) for x in (q, k, v)]
    b = [x.clone().requires_grad_(True) for x in (q, k, v)]
    attn.fused_attention(*a).backward(g)
    attn.dot_product_attention(*b).backward(g)
    grad_err = max((x.grad - y.grad).abs().max().item() for x, y in zip(a, b))
    log(f"attention grads (2, 3, 37, 24): max_abs_err {grad_err:.3e} (tol 1e-5)")
    if grad_err > 1e-5:
        raise SystemExit("attention backward disagrees with autograd of the plain version")

    # times at the main path's shape and layout
    q, k, v = qkv(FLAGSHIP, torch.float32, True, gen)
    b_, h_, t_, dh_ = FLAGSHIP
    kernel_ms = time_ms(lambda: attn._attention_cuda(q, k, v))
    plain_ms = time_ms(lambda: attn.dot_product_attention(q, k, v))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
    flops = 4 * b_ * h_ * t_ * t_ * dh_
    nbytes = 4 * b_ * h_ * t_ * dh_ * q.element_size()
    by_ops, by_bytes = flops / peaks["float32"], nbytes / peaks["bytes"]
    bound_ms = 1e3 * max(by_ops, by_bytes)
    qb, kb, vb = qkv(FLAGSHIP, torch.bfloat16, True, gen)
    bf16_ms = time_ms(lambda: attn._attention_cuda(qb, kb, vb))
    bf16_bound = 1e3 * max(flops / peaks["bfloat16"], nbytes / 2 / peaks["bytes"])
    log(f"attention {FLAGSHIP} fp32: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    log(f"attention {FLAGSHIP} bf16: kernel {bf16_ms:.4f} ms, bound {bf16_bound:.4f} ms")
    return {
        "name": "attention",
        "route": "cuda",
        "source": "algonauts2025_tpu_torch/csrc/attention.cu",
        "replaces": "algonauts2025_tpu/ops/attention.py:80 (_attn_kernel)",
        "launches": None,  # filled from the main path's run
        "max_abs_err": flagship_err,
        "tol": TOL[torch.float32],
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
    }


FLAGSHIP_DIMS = {"text": (2, 3072), "audio": (2, 1024), "video": (2, 1408)}
METRICS = [
    {"log_name": "pearson", "name": "MultidimPearsonCorrCoef", "kwargs": {"num_outputs": 1000}},
    {"log_name": "subj_pearson", "name": "GroupedMetric",
     "metric_name": "MultidimPearsonCorrCoef", "kwargs": {"num_outputs": 1000}},
    {"log_name": "retrieval_top1", "name": "TopkAcc", "topk": 1},
]
OPTIM = {
    "optimizer": {"name": "Adam", "lr": 1e-4,
                  "kwargs": {"weight_decay": 0.0, "mu_dtype": "bfloat16"}},
    "scheduler": {"name": "OneCycleLR", "kwargs": {"max_lr": 1e-4, "pct_start": 0.1}},
}


def make_trainer(feature_dims, n_outputs, device=None, metrics=(), **model_kw):
    cfg = FmriEncoderConfig(
        n_subjects=4, modality_dropout=0.3, remat=True, contrastive_enabled=True,
        contrastive_modalities=["video"], **model_kw,
    )
    model = cfg.build(feature_dims, n_outputs=n_outputs, n_output_timesteps=100)
    return BrainTrainer(
        model=model,
        loss_fn=build_loss({"name": "MSELoss"}),
        optim_config=OptimConfig(**OPTIM),
        metrics={f"val/{m['log_name']}": build_metric(m, n_groups=4) for m in metrics},
        config=TrainerConfig(n_epochs=1, folder=None, save_checkpoints=False, seed=SEED,
                             contrastive_weight=0.1),
        device=device,
    )


def make_batch(feature_dims, n_outputs, b, t, gen, device="cuda"):
    data = {
        m: torch.randn((b, n_layers, d, t), generator=gen, device=device)
        for m, (n_layers, d) in feature_dims.items()
    }
    data["subject_id"] = torch.randint(0, 4, (b, 1), generator=gen, device=device)
    data["fmri"] = torch.randn((b, n_outputs, 100), generator=gen, device=device)
    return SegmentData(data=data, segments=[None] * b)


def check_small_against_cpu() -> None:
    """A small trunk trained 3 steps on the card (through the kernel) and on
    the CPU (plain version) from the same weights: losses agree to 1e-4."""
    dims = {"text": (2, 40), "audio": (2, 16), "video": (2, 24)}
    small = dict(hidden=96, depth=2, heads=2)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    batches = [make_batch(dims, 20, 4, 200, gen) for _ in range(3)]
    gpu = make_trainer(dims, 20, **small)
    cpu = make_trainer(dims, 20, device="cpu", **small)
    gpu.init_state(batches[0], total_steps=3)
    cpu.init_state(batches[0], total_steps=3)
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    worst = 0.0
    for batch in batches:
        lg = gpu.train_step(batch.data)[0].item()
        lc = cpu.train_step({k: v.cpu() for k, v in batch.data.items()})[0].item()
        worst = max(worst, abs(lg - lc) / abs(lc))
    log(f"small trunk, 3 steps, card vs CPU: max rel loss diff {worst:.3e} (tol 1e-4)")
    if not worst <= 1e-4:
        raise SystemExit("the small trunk on the card disagrees with the CPU")


def main_path(n_steps: int = 5, n_eval: int = 2, n_predict: int = 1) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, t = 16, 298
    trainer = make_trainer(FLAGSHIP_DIMS, 1000, metrics=METRICS)
    train = [make_batch(FLAGSHIP_DIMS, 1000, b, t, gen) for _ in range(n_steps)]
    evals = [make_batch(FLAGSHIP_DIMS, 1000, b, t, gen) for _ in range(n_eval + n_predict)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for key in attn.launch_counts:
        attn.launch_counts[key] = 0
    trainer.init_state(train[0], total_steps=100)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    step_s, losses = [], []
    for batch in train:
        t0 = time.perf_counter()
        loss, aux = trainer.train_step(batch.data)
        losses.append(loss.item())  # synchronises
        step_s.append(time.perf_counter() - t0)
        if not all(np.isfinite([losses[-1], *(v.item() for v in aux.values())])):
            raise SystemExit(f"non-finite train loss {losses[-1]} / {aux}")
    t0 = time.perf_counter()
    val = trainer.evaluate(evals[:n_eval], split="val")
    eval_s = time.perf_counter() - t0
    preds = [p for p, _ in trainer.predict(evals[n_eval:])]
    torch.cuda.synchronize()
    launches = dict(attn.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    log(f"params {n_params}, train losses {losses}")
    log(f"step seconds {step_s}; median {statistics.median(step_s[1:]):.4f} s (first excluded)")
    log(f"evaluate on {n_eval} batches: {eval_s:.3f} s; metrics {json.dumps(val)}")
    log(f"peak device memory {peak_gb:.2f} GB")
    keys = ["val/loss", "val/pearson", "val/subj_pearson", "val/retrieval_top1"]
    if any(k not in val or not np.isfinite(val[k]) for k in keys):
        raise SystemExit(f"missing or non-finite metrics: {val}")
    if [p.shape for p in preds] != [(b, 1000, 100)] * n_predict or not all(
        np.isfinite(p).all() for p in preds
    ):
        raise SystemExit("predict gave the wrong shape or non-finite values")
    depth = trainer.model.config.depth
    expected = 2 * depth * n_steps + depth * (n_eval + n_predict)  # remat recomputes
    log(f"attention launches {launches['attention']} (expected {expected})")
    if launches["attention"] != expected:
        raise SystemExit("the main path did not launch the attention kernel as expected")
    return {"attention": launches["attention"], "step_s": statistics.median(step_s[1:]),
            "peak_gb": peak_gb, "n_params": n_params}


def main() -> None:
    name_and_limit = card()
    kind = torch.cuda.get_device_name(0)
    peaks = peaks_for(kind)
    torch.manual_seed(SEED)
    build_kernels()
    attention = check_attention(peaks)
    check_small_against_cpu()
    run = main_path()
    attention["launches"] = run["attention"]
    log(f"main path: median step {run['step_s']:.4f} s, peak {run['peak_gb']:.2f} GB, "
        f"{run['n_params']} params on {name_and_limit}")
    print(json.dumps({"kernels": [attention]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
