"""Plain PyTorch reference of the TRIBE FmriEncoder trunk's train step.

TRIBE (arXiv:2507.22229), as its default grid configures it: per-modality
linear projectors of the layer-concatenated features, concatenated to the
trunk width; a learned time position embedding; a pre-norm transformer of
ScaleNorm blocks with per-channel residual gains, rotary q/k (interleaved
pairs over the first max(d_head / 2, 32) dims of each head), softmax
attention without biases and an erf-gelu feed-forward; a final ScaleNorm;
a per-subject linear readout over parcels, average-pooled onto the TRs;
the MSE against the fMRI plus a weighted symmetric InfoNCE between the
trunk's latents and a linear head of the video features.  Modality
dropout zeroes a projected modality (one draw a modality a step, one
survivor forced).  The optimizer is optax's Adam with a bfloat16 first
moment under a one-cycle cosine schedule.

Everything is float32 with TF32 off (``tf32=True`` is the control: the same
steps on the tensor cores' TF32), unfused, without recompute and without
any kernel of the program; it imports nothing of it.  The weights come from
the seed (``make_weights``), as the benchmark hands them to the program.
"""

from __future__ import annotations

import contextlib
import math
import statistics
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ..common.seeds import Spec, derive, seeded_tensors

Batch = dict[str, torch.Tensor]


def model_dims(cfg: dict) -> dict[str, int]:
    model = cfg["brain_model_config"]
    n_mod = len(cfg["feature_dims"])
    width = model["hidden"] // n_mod * n_mod if model["feature_aggregation"] == "cat" else model["hidden"]
    d_head = width // model["heads"]
    return {"width": width, "proj": width // n_mod, "d_head": d_head,
            "rot": min(max(d_head // 2, 32), d_head), "ff": width * model["ff_mult"]}


def weight_spec(cfg: dict) -> Spec:
    """Every trunk weight: its name (the program's parameter name), shape
    and init (flax's: variance 1/fan_in kernels, zero biases, unit gains,
    N(0, 1) positions, N(0, 1/width) readout)."""
    model = cfg["brain_model_config"]
    dims = model_dims(cfg)
    w, ff = dims["width"], dims["ff"]
    spec: Spec = []

    def linear(name: str, n_in: int, n_out: int, bias: bool = True) -> None:
        spec.append((f"{name}.weight", (n_out, n_in), ("normal", n_in ** -0.5)))
        if bias:
            spec.append((f"{name}.bias", (n_out,), ("zeros",)))

    for modality, (n_layers, dim) in cfg["feature_dims"].items():
        linear(f"projectors.{modality}", n_layers * dim, dims["proj"])
    for modality in model["contrastive_modalities"]:
        n_layers, dim = cfg["feature_dims"][modality]
        linear(f"contrastive_heads.{modality}", n_layers * dim, model["hidden"])
    spec.append(("time_pos_embed", (1, cfg["max_positions"], w), ("normal", 1.0)))
    for i in range(model["depth"]):
        block = f"encoder.blocks.{i}"
        spec += [(f"{block}.res_scale_attn", (w,), ("ones",)), (f"{block}.res_scale_ff", (w,), ("ones",)),
                 (f"{block}.attn_norm.g", (), ("ones",)), (f"{block}.ff_norm.g", (), ("ones",))]
        linear(f"{block}.attn.qkv", w, 3 * w, bias=False)
        linear(f"{block}.attn.out", w, w, bias=False)
        linear(f"{block}.ff.fc1", w, ff)
        linear(f"{block}.ff.fc2", ff, w)
    spec.append(("encoder.final_norm.g", (), ("ones",)))
    s = model["n_subjects"]
    spec.append(("predictor.weights", (s, w, cfg["n_outputs"]), ("normal", w ** -0.5)))
    spec.append(("predictor.bias", (s, cfg["n_outputs"]), ("normal", w ** -0.5)))
    return spec


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    return seeded_tensors(weight_spec(cfg), derive(seed, "weights"), device)


def make_batches(cfg: dict, seed: int, n: int, device) -> list[Batch]:
    """``n`` batches of seeded features (B, layers, dim, T), subject ids
    and fMRI targets (B, parcels, TRs), on the device; every row differs."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "batches"))
    b, t = cfg["batch_size"], cfg["n_timesteps"]
    out = []
    for _ in range(n):
        batch = {m: torch.randn((b, n_layers, dim, t), generator=gen, device=device)
                 for m, (n_layers, dim) in cfg["feature_dims"].items()}
        batch["subject_id"] = torch.randint(0, cfg["brain_model_config"]["n_subjects"], (b, 1),
                                            generator=gen, device=device)
        batch["fmri"] = torch.randn((b, cfg["n_outputs"], cfg["n_output_timesteps"]), generator=gen,
                                    device=device)
        out.append(batch)
    return out


def dropout_draws(cfg: dict, seed: int, step: int) -> list[bool]:
    """Which modalities step ``step`` drops: a host generator seeded from
    (seed + 1, step), a uniform a modality below the dropout rate, and one
    uniformly drawn survivor when all would drop."""
    rate = cfg["brain_model_config"]["modality_dropout"]
    n_mod = len(cfg["feature_dims"])
    if rate <= 0:
        return [False] * n_mod
    state = np.random.SeedSequence([seed + 1, step]).generate_state(1)[0]
    gen = torch.Generator().manual_seed(int(state))
    draws = torch.rand(n_mod, generator=gen) < rate
    keep = int(torch.randint(0, n_mod, (), generator=gen))
    if bool(draws.all()):
        draws[keep] = False
    return draws.tolist()


def one_cycle(cfg: dict, total_steps: int, step: int) -> float:
    """The one-cycle cosine schedule (torch's OneCycleLR shape, optax's
    fp32 arithmetic) with the SWA anneal starting at ``swa_start``."""
    kw = cfg["optim"]["scheduler"]["kwargs"]
    max_lr = kw.get("max_lr", cfg["optim"]["optimizer"]["lr"])
    total = max(2, total_steps)
    warmup = min(max(1, round(total * kw.get("pct_start", 0.3))), total - 1)
    init = max_lr / kw.get("div_factor", 25.0)
    final = init / kw.get("final_div_factor", 1e4)
    if int(total_steps * cfg["swa_start"]) <= step:
        raise ValueError("the reference covers the steps before the SWA anneal")
    f32 = np.float32
    step = min(step, total)
    if step < warmup:
        up = min(max(f32(step) / f32(warmup), f32(0)), f32(1))
        return float(f32(init) + f32(max_lr - init) * (f32(0.5) * (f32(1) - np.cos(f32(math.pi) * up, dtype=f32))))
    down = min(max(f32(step - warmup) / f32(total - warmup), f32(0)), f32(1))
    return float(f32(final) + f32(max_lr - final) * (f32(0.5) * (f32(1) + np.cos(f32(math.pi) * down, dtype=f32))))


def _scale_norm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    norm = torch.sqrt((x * x).sum(-1, keepdim=True) + eps * eps) * x.shape[-1] ** -0.5
    return x / norm.clamp_min(eps) * g


def _rotary(x: torch.Tensor, rot: int) -> torch.Tensor:
    """Rotate interleaved pairs of the first ``rot`` dims of (B, H, T, dh)."""
    t = x.shape[-2]
    inv = 1.0 / 10000.0 ** (np.arange(0, rot, 2) / rot)
    angles = torch.from_numpy((np.arange(t)[:, None] * inv[None]).astype(np.float32)).to(x.device)
    cos, sin = angles.cos(), angles.sin()
    x1, x2 = x[..., :rot:2], x[..., 1:rot:2]
    rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).flatten(-2)
    return torch.cat([rotated, x[..., rot:]], dim=-1)


def _info_nce(q: torch.Tensor, k: torch.Tensor, tau: float) -> torch.Tensor:
    q = q.reshape(-1, q.shape[-1])
    k = k.reshape(-1, k.shape[-1])
    q = q / torch.sqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    k = k / torch.sqrt((k * k).sum(-1, keepdim=True) + 1e-12)
    logits = q @ k.T / tau
    diag = (q * k).sum(-1) / tau
    return 0.5 * ((torch.logsumexp(logits, 1) - diag).mean() + (torch.logsumexp(logits, 0) - diag).mean())


def loss_of(w: dict[str, torch.Tensor], batch: Batch, cfg: dict, drops: list[bool]) -> torch.Tensor:
    """The train loss of one batch: MSE of the pooled predictions plus the
    weighted InfoNCE."""
    model = cfg["brain_model_config"]
    dims = model_dims(cfg)
    b, t = batch["fmri"].shape[0], next(iter(batch.values())).shape[-1]

    def features(modality: str) -> torch.Tensor:  # (B, L, D, T) -> (B, T, L*D)
        x = batch[modality].float()
        return x.reshape(b, -1, t).transpose(1, 2)

    parts = []
    for modality, dropped in zip(cfg["feature_dims"], drops):
        y = F.linear(features(modality), w[f"projectors.{modality}.weight"], w[f"projectors.{modality}.bias"])
        parts.append(torch.zeros_like(y) if dropped else y)
    x = torch.cat(parts, dim=-1) + w["time_pos_embed"][:, :t]
    h, dh = model["heads"], dims["d_head"]
    for i in range(model["depth"]):
        p = f"encoder.blocks.{i}."
        qkv = F.linear(_scale_norm(x, w[p + "attn_norm.g"]), w[p + "attn.qkv.weight"])
        q, k, v = qkv.view(b, t, 3, h, dh).permute(2, 0, 3, 1, 4)
        q, k = _rotary(q, dims["rot"]), _rotary(k, dims["rot"])
        probs = torch.softmax(q @ k.transpose(-1, -2) * dh ** -0.5, dim=-1)
        attn = (probs @ v).transpose(1, 2).reshape(b, t, h * dh)
        x = x * w[p + "res_scale_attn"] + F.linear(attn, w[p + "attn.out.weight"])
        hidden = F.gelu(F.linear(_scale_norm(x, w[p + "ff_norm.g"]), w[p + "ff.fc1.weight"], w[p + "ff.fc1.bias"]))
        x = x * w[p + "res_scale_ff"] + F.linear(hidden, w[p + "ff.fc2.weight"], w[p + "ff.fc2.bias"])
    latents = _scale_norm(x, w["encoder.final_norm.g"])
    sid = batch["subject_id"].reshape(-1)
    pred = torch.einsum("btc,bcd->bdt", latents, w["predictor.weights"][sid]) + w["predictor.bias"][sid][:, :, None]
    pred = F.adaptive_avg_pool1d(pred, cfg["n_output_timesteps"])
    loss = ((pred - batch["fmri"].float()) ** 2).mean()
    if model["contrastive_enabled"]:
        nce = []
        for modality in model["contrastive_modalities"]:
            head = f"contrastive_heads.{modality}"
            mod = F.linear(features(modality), w[head + ".weight"], w[head + ".bias"])
            nce.append(_info_nce(latents, mod, model["contrastive_temperature"]))
        loss = loss + model["contrastive_weight"] * sum(nce) / len(nce)
    return loss


@contextlib.contextmanager
def matmul_precision(tf32: bool) -> tp.Iterator[None]:
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def train(cfg: dict, seed: int, batches: list[Batch], total_steps: int, device,
          tf32: bool = False) -> dict[str, tp.Any]:
    """``len(batches)`` reference steps from the seeded weights: each
    step's loss, each leaf's gradient norm at every step, and each leaf's
    change after the last step."""
    opt = cfg["optim"]["optimizer"]
    b1, b2 = opt["kwargs"].get("betas", (0.9, 0.999))
    eps = opt["kwargs"].get("eps", 1e-8)
    if opt["name"] != "Adam" or opt["kwargs"].get("weight_decay", 0.0):
        raise ValueError("the reference has Adam without weight decay")
    mu_dtype = getattr(torch, opt["kwargs"].get("mu_dtype", "float32"))
    b1_mu = float(torch.tensor(b1, dtype=mu_dtype))  # optax casts b1 to mu's dtype
    w0 = make_weights(cfg, seed, device)
    w = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    mu = {k: torch.zeros_like(v, dtype=mu_dtype) for k, v in w.items()}
    nu = {k: torch.zeros_like(v) for k, v in w.items()}
    losses, grad_norms = [], []
    f32 = np.float32
    with matmul_precision(tf32):
        for step, batch in enumerate(batches):
            loss = loss_of(w, batch, cfg, dropout_draws(cfg, seed, step))
            grads = torch.autograd.grad(loss, list(w.values()), allow_unused=True)
            losses.append(loss.item())
            lr = one_cycle(cfg, total_steps, step)
            count = step + 1
            bc1 = float(f32(1) - f32(b1) ** f32(count))
            bc2 = float(f32(1) - f32(b2) ** f32(count))
            norms = {}
            with torch.no_grad():
                for (name, p), g in zip(w.items(), grads):
                    g = torch.zeros_like(p) if g is None else g
                    norms[name] = float(g.double().norm())
                    m = (1 - b1) * g + b1_mu * mu[name]
                    nu[name].mul_(b2).add_((1 - b2) * (g * g))
                    p.add_((m / bc1) / (torch.sqrt(nu[name] / bc2) + eps) * -lr)
                    mu[name] = m.to(mu_dtype)
            grad_norms.append(norms)
    with torch.no_grad():
        change = {k: float((w[k] - w0[k]).double().norm()) for k in w}
    return {"losses": losses, "grad_norms": grad_norms, "change": change}


def gaps(got: dict[str, tp.Any], ref: dict[str, tp.Any], floor: float = 1e-3) -> dict[str, float]:
    """The compared numbers of ``got`` (the program's steps, or the
    control's) against the reference's:

    - ``loss_gap``: the largest relative gap of a step's loss;
    - ``grad_gap``: the largest gap between a leaf's first-gradient norm
      and the reference's, over the larger of that leaf's and the median
      leaf's reference norm;
    - ``change_gap``: the same of the leaves' change after the steps, over
      the leaves whose reference gradient reaches ``floor`` times the
      median leaf's at some step (the others move by round-off alone)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"], strict=True))
    g_ref, g_got = ref["grad_norms"][0], got["grad_norms"][0]
    med = statistics.median(g_ref.values())
    grad_gap = max(abs(g_got[k] - g_ref[k]) / max(g_ref[k], med) for k in g_ref)
    peak = {k: max(norms[k] for norms in ref["grad_norms"]) for k in g_ref}
    med_peak = statistics.median(peak.values())
    moved = [k for k in g_ref if peak[k] >= floor * med_peak]
    med_change = statistics.median(ref["change"][k] for k in moved)
    change_gap = max(abs(got["change"][k] - ref["change"][k]) / max(ref["change"][k], med_change)
                     for k in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
