"""Optimizers and LR schedules with the reference config surface.

The port of algonauts2025_tpu/training/optim.py, whose optimizers are optax
chains.  Each one here is that chain's update rule written over tensors,
not a ``torch.optim`` class: the two families differ in defaults and update
order (optax's Adagrad accumulator starts at 0.1, its RMSprop puts eps
inside the square root, its Adafactor factors second moments, clips and
scales by the parameter RMS, its LAMB takes the trust ratio after the
weight decay).  The optax scalars (bias corrections, decay rates, the
schedules) are computed in fp32 as optax computes them.

Adam and AdamW keep ``mu_dtype``: the first moment is stored in that
dtype (bf16 at the flagship: one fewer fp32 copy of 0.9 B params), updated
from the stored value and bias-corrected in fp32 before the cast.  The
schedule is a plain ``step -> lr`` function; from the SWA start step the
LR cosine-anneals to ``swa_lr`` and stays there.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import pydantic
import torch

__all__ = ["Adam", "OptaxRule", "OptimizerConfig", "SchedulerConfig", "OptimConfig"]

Schedule = tp.Callable[[int], float]

_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

F32 = np.float32


def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay**count`` in fp32."""
    return float(F32(1) - F32(decay) ** F32(count))


class _CountedOptimizer(torch.optim.Optimizer):
    """A ``torch.optim.Optimizer`` with optax's step count (kept in its
    state dict).  The learning rate of a step is ``param_groups[0]["lr"]``."""

    def __init__(self, params, defaults: dict) -> None:
        super().__init__(params, defaults)
        self.count = 0

    def state_dict(self):
        out = super().state_dict()
        out["count"] = self.count
        return out

    def load_state_dict(self, state_dict) -> None:
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count", 0))
        super().load_state_dict(state_dict)


class Adam(_CountedOptimizer):
    """optax's Adam/AdamW update with a ``mu_dtype`` first moment.

    Per step t (1-based), in fp32 unless noted:
    mu = (1-b1) g + b1 mu_stored (b1 and the product b1*mu in mu_dtype, as
    optax promotes them); nu = (1-b2) g^2 + b2 nu; u = mu/(1-b1^t) / (sqrt(nu/(1-b2^t)) + eps);
    AdamW adds wd*p to u; p += (-lr) u; mu is stored as mu_dtype.
    Adam's weight decay is torch's L2 term, added to the gradient first.
    """

    def __init__(
        self,
        params,
        lr: float = 1e-3,
        betas: tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        decoupled: bool = False,
        mu_dtype: torch.dtype | None = None,
    ) -> None:
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                        decoupled=decoupled)
        super().__init__(params, defaults)
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        self.count += 1
        for group in self.param_groups:
            b1, b2 = group["betas"]
            bc1 = _bias_correction(b1, self.count)
            bc2 = _bias_correction(b2, self.count)
            neg_lr = -float(group["lr"])
            wd, eps = group["weight_decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                    state["nu"] = torch.zeros_like(p)
                if wd and not group["decoupled"]:
                    g = g + wd * p
                # optax casts the weakly typed b1 to mu's dtype (0.9 -> 0.8984375
                # in bf16) before the product with the stored moment
                b1_mu = float(torch.tensor(b1, dtype=state["mu"].dtype))
                mu = (1 - b1) * g + b1_mu * state["mu"]
                nu = state["nu"]
                nu.mul_(b2).add_((1 - b2) * (g * g))  # == (1-b2) g^2 + b2 nu
                update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                if wd and group["decoupled"]:
                    update = update + wd * p
                p.add_(update * neg_lr)
                state["mu"] = mu.to(state["mu"].dtype)

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        # torch casts loaded state to the param dtype; mu lives in mu_dtype
        for state in self.state.values():
            if "mu" in state and self.mu_dtype is not None:
                state["mu"] = state["mu"].to(self.mu_dtype)


# -- the other optax chains, one update rule each ----------------------------
#
# Each rule maps (grad after the L2 term, param, state, lr, count) to the
# delta that optax's chain adds to the param; ``count`` is the step's
# 1-based count (optax's incremented counter), ``state`` the param's dict.


def _zeros(state: dict, p: torch.Tensor, *names: str, fill: float = 0.0) -> None:
    for name in names:
        if name not in state:
            state[name] = torch.full_like(p, fill)


def _sgd(g, p, state, lr, count, hp):
    """optax.sgd: a trace (t = g + m t) when momentum is set, then -lr."""
    if hp["momentum"] is not None:
        _zeros(state, p, "trace")
        state["trace"] = g + hp["momentum"] * state["trace"]
        g = state["trace"]
    return g * -lr


def _adagrad(g, p, state, lr, count, hp):
    """optax.adagrad: the squared sums start at 0.1; u = g rsqrt(s + 1e-7)."""
    _zeros(state, p, "sum_of_squares", fill=0.1)
    s = g * g + state["sum_of_squares"]
    state["sum_of_squares"] = s
    inv = torch.where(s > 0, torch.rsqrt(s + 1e-7), 0.0)
    return (inv * g) * -lr


def _rmsprop(g, p, state, lr, count, hp):
    """optax.rmsprop: nu = 0.1 g^2 + 0.9 nu; u = g rsqrt(nu + 1e-8) (eps
    inside the root); -lr; then a trace of the scaled updates."""
    _zeros(state, p, "nu", "trace")
    nu = 0.1 * (g * g) + 0.9 * state["nu"]
    state["nu"] = nu
    u = (torch.rsqrt(nu + 1e-8) * g) * -lr
    state["trace"] = u + hp["momentum"] * state["trace"]
    return state["trace"]


def _lion(g, p, state, lr, count, hp):
    """optax.lion (b1 0.9, b2 0.99): u = sign(0.1 g + 0.9 mu), mu = 0.01 g +
    0.99 mu, then the decoupled decay, then -lr."""
    _zeros(state, p, "mu")
    mu = state["mu"]
    u = torch.sign((1.0 - 0.9) * g + 0.9 * mu)
    state["mu"] = (1 - 0.99) * g + 0.99 * mu
    return (u + hp["weight_decay"] * p) * -lr


def _adam_moments(g, state, p, b1, b2):
    _zeros(state, p, "mu", "nu")
    state["mu"] = (1 - b1) * g + b1 * state["mu"]
    state["nu"] = (1 - b2) * (g * g) + b2 * state["nu"]
    return state["mu"], state["nu"]


def _adamax(g, p, state, lr, count, hp):
    """optax.adamax: nu = max(|g| + eps, b2 nu); u = mu_hat / nu."""
    b1, b2 = hp["betas"]
    _zeros(state, p, "mu", "nu")
    state["mu"] = (1 - b1) * g + b1 * state["mu"]
    state["nu"] = torch.maximum(torch.abs(g) + hp["eps"], b2 * state["nu"])
    mu_hat = state["mu"] / _bias_correction(b1, count)
    return (mu_hat / state["nu"]) * -lr


def _nadam(g, p, state, lr, count, hp):
    """optax.nadam (adam with nesterov): mu_hat = b1 mu/(1-b1^(t+1)) +
    (1-b1) g/(1-b1^t)."""
    b1, b2 = hp["betas"]
    mu, nu = _adam_moments(g, state, p, b1, b2)
    mu_hat = (b1 * (mu / _bias_correction(b1, count + 1))
              + (1 - b1) * (g / _bias_correction(b1, count)))
    nu_hat = nu / _bias_correction(b2, count)
    return (mu_hat / (torch.sqrt(nu_hat + 0.0) + hp["eps"])) * -lr


def _radam(g, p, state, lr, count, hp):
    """optax.radam: the rectified Adam step once the SMA length rho >= 5,
    the bias-corrected momentum before."""
    b1, b2 = hp["betas"]
    mu, nu = _adam_moments(g, state, p, b1, b2)
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    b2t = F32(b2) ** F32(count)
    ro = F32(ro_inf) - F32(2 * count) * b2t / (F32(1) - b2t)
    mu_hat = mu / _bias_correction(b1, count)
    if ro < F32(5.0):
        return mu_hat * -lr
    r = np.sqrt((ro - F32(4.0)) * (ro - F32(2.0)) * F32(ro_inf)
                / (F32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
    nu_hat = nu / _bias_correction(b2, count)
    return (float(r) * mu_hat / (torch.sqrt(nu_hat + 0.0) + hp["eps"])) * -lr


def _adadelta(g, p, state, lr, count, hp):
    """optax.adadelta (rho 0.9, eps 1e-6): u = sqrt(e_x + eps)/sqrt(e_g + eps) g."""
    _zeros(state, p, "e_g", "e_x")
    g = g + 0.0 * p  # optax.adadelta's own add_decayed_weights(0.0)
    state["e_g"] = 0.1 * (g * g) + 0.9 * state["e_g"]
    u = (torch.sqrt(state["e_x"] + 1e-6) / torch.sqrt(state["e_g"] + 1e-6)) * g
    state["e_x"] = 0.1 * (u * u) + 0.9 * state["e_x"]
    return u * -lr


def _factored_dims(shape: tuple[int, ...]) -> tuple[int, int] | None:
    """optax's choice of the two dims to factor (the largest two, from 128)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


def _adafactor(g, p, state, lr, count, hp):
    """optax.adafactor's defaults: factored second moments (decay
    1 - t^-0.8, eps 1e-30), updates clipped to block RMS 1, times lr, times
    the param's RMS (at least 1e-3), negated."""
    decay = F32(1.0) - F32(count) ** F32(-0.8)
    keep, new = float(decay), float(F32(1.0) - decay)
    grad_sqr = g * g + 1e-30
    dims = _factored_dims(tuple(p.shape))
    if dims is not None:
        d1, d0 = dims
        if "v_row" not in state:
            state["v_row"] = torch.zeros_like(grad_sqr.mean(dim=d0))
            state["v_col"] = torch.zeros_like(grad_sqr.mean(dim=d1))
        v_row = keep * state["v_row"] + new * grad_sqr.mean(dim=d0)
        v_col = keep * state["v_col"] + new * grad_sqr.mean(dim=d1)
        state["v_row"], state["v_col"] = v_row, v_col
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
        u = g * row_factor.unsqueeze(d0) * (v_col**-0.5).unsqueeze(d1)
    else:
        _zeros(state, p, "v")
        state["v"] = keep * state["v"] + new * grad_sqr
        u = g * state["v"] ** -0.5
    u = u / torch.clamp(torch.sqrt(torch.mean(u * u)) / 1.0, min=1.0)
    u = u * lr
    rms = torch.sqrt(torch.mean(p * p))
    u = u * torch.where(rms <= 1e-3, 1e-3, rms)
    return -u


def _lamb(g, p, state, lr, count, hp):
    """optax.lamb: the Adam direction (no L2 term), plus wd p, times the
    trust ratio ||p|| / ||u|| (1 where either is 0), then -lr."""
    b1, b2 = hp["betas"]
    mu, nu = _adam_moments(g, state, p, b1, b2)
    u = (mu / _bias_correction(b1, count)) / (
        torch.sqrt(nu / _bias_correction(b2, count) + 0.0) + hp["eps"])
    u = u + hp["weight_decay"] * p
    p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
    ratio = torch.where((p_norm == 0.0) | (u_norm == 0.0), 1.0, p_norm / (u_norm + 0.0))
    return (u * ratio) * -lr


#: name -> (rule, whether the weight decay is torch's L2 term on the gradient;
#: Lion and LAMB apply theirs inside the chain instead)
_RULES: dict[str, tuple[tp.Callable, bool]] = {
    "SGD": (_sgd, True),
    "Adagrad": (_adagrad, True),
    "RMSprop": (_rmsprop, True),
    "Lion": (_lion, False),
    "Adamax": (_adamax, True),
    "NAdam": (_nadam, True),
    "RAdam": (_radam, True),
    "Adadelta": (_adadelta, True),
    "Adafactor": (_adafactor, True),
    "LAMB": (_lamb, False),
}


class OptaxRule(_CountedOptimizer):
    """One of the optax chains of the JAX package's ``OptimizerConfig``,
    written over tensors (see the rules above); fp32 parameters."""

    def __init__(self, params, name: str, lr: float = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, momentum: float | None = None) -> None:
        if name not in _RULES:
            raise ValueError(f"Unknown optimizer: {name}")
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                        momentum=momentum)
        super().__init__(params, defaults)
        self.name = name

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{self.name}.step takes no closure")
        self.count += 1
        rule, l2 = _RULES[self.name]
        for group in self.param_groups:
            lr, wd = float(group["lr"]), group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad + wd * p if (l2 and wd) else p.grad
                p.add_(rule(g, p, self.state[p], lr, self.count, group))


class OptimizerConfig(pydantic.BaseModel):
    model_config = pydantic.ConfigDict(extra="forbid")
    name: str = "Adam"
    lr: float
    kwargs: dict[str, tp.Any] = {}

    def build(self, params) -> _CountedOptimizer:
        kw = dict(self.kwargs)
        weight_decay = kw.pop("weight_decay", 0.0)
        betas = tuple(kw.pop("betas", (0.9, 0.999)))
        eps = kw.pop("eps", 1e-8)
        momentum = kw.pop("momentum", 0.0)
        # read by Adam/AdamW only, as in the JAX package
        mu_dtype = kw.pop("mu_dtype", None)
        if kw:
            raise ValueError(f"Unsupported optimizer kwargs: {list(kw)}")
        if mu_dtype not in _DTYPES:
            raise ValueError(f"unsupported mu_dtype {mu_dtype!r}")
        if self.name in ("Adam", "AdamW"):
            return Adam(
                params, lr=self.lr, betas=betas, eps=eps, weight_decay=weight_decay,
                decoupled=self.name == "AdamW", mu_dtype=_DTYPES[mu_dtype],
            )
        if self.name not in _RULES:
            raise ValueError(f"Unknown optimizer: {self.name} (use one of "
                             f"Adam/AdamW/{'/'.join(_RULES)})")
        # optax.sgd(momentum=None) has no trace; RMSprop's trace is always
        # there (decay 0 when unset), as the JAX package builds them
        if self.name == "SGD":
            momentum = momentum or None
        return OptaxRule(params, self.name, lr=self.lr, betas=betas, eps=eps,
                         weight_decay=weight_decay, momentum=momentum)


# -- schedules: optax's fp32 arithmetic -------------------------------------


def _cos(x: np.float32) -> np.float32:
    return np.cos(F32(math.pi) * x, dtype=F32)


def _clip01(x: np.float32) -> np.float32:
    return min(max(x, F32(0.0)), F32(1.0))


class SchedulerConfig(pydantic.BaseModel):
    model_config = pydantic.ConfigDict(extra="forbid")
    name: str = "OneCycleLR"
    kwargs: dict[str, tp.Any] = {}

    def build(self, base_lr: float, total_steps: int) -> Schedule:
        kw = dict(self.kwargs)

        def reject_leftovers() -> None:
            # torch honours scheduler kwargs: dropping one would train a
            # different LR trajectory
            if kw:
                raise ValueError(f"Unsupported {self.name} scheduler kwargs: {sorted(kw)}")

        if self.name == "OneCycleLR":
            max_lr = kw.pop("max_lr", base_lr)
            pct_start = kw.pop("pct_start", 0.3)
            div_factor = kw.pop("div_factor", 25.0)
            final_div_factor = kw.pop("final_div_factor", 1e4)
            reject_leftovers()
            total = max(2, total_steps)
            warmup = min(max(1, round(total * pct_start)), total - 1)
            init = max_lr / div_factor
            final = init / final_div_factor

            def one_cycle(step: int) -> float:
                step = min(step, total)
                if step < warmup:
                    up = _clip01(F32(step) / F32(warmup))
                    return float(F32(init) + F32(max_lr - init)
                                 * (F32(0.5) * (F32(1) - _cos(up))))
                down = _clip01(F32(step - warmup) / F32(total - warmup))
                return float(F32(final) + F32(max_lr - final) * (F32(0.5) * (F32(1) + _cos(down))))

            return one_cycle
        if self.name == "CosineAnnealingLR":
            t_max = float(max(1, kw.pop("T_max", total_steps)))
            eta_min = kw.pop("eta_min", 0.0)
            reject_leftovers()
            alpha = eta_min / base_lr if base_lr else 0.0

            def cosine(step: int) -> float:
                angle = F32(math.pi) * F32(min(float(step), t_max)) / F32(t_max)
                decay = F32(0.5) * (F32(1) + np.cos(angle, dtype=F32))
                return float(F32(base_lr) * (F32(1 - alpha) * decay + F32(alpha)))

            return cosine
        if self.name == "StepLR":
            step_size = kw.pop("step_size")
            gamma = kw.pop("gamma", 0.1)
            reject_leftovers()
            return lambda step: float(F32(base_lr) * F32(gamma) ** F32(step // step_size))
        if self.name == "LinearLR":
            start = base_lr * kw.pop("start_factor", 1 / 3)
            end = base_lr * kw.pop("end_factor", 1.0)
            total = kw.pop("total_iters", 5)
            reject_leftovers()
            if total <= 0:
                return lambda step: start

            def linear(step: int) -> float:
                frac = F32(1) - F32(min(max(step, 0), total)) / F32(total)
                return float(F32(start - end) * frac + F32(end))

            return linear
        raise ValueError(f"Unknown scheduler: {self.name}")


def _with_swa_annealing(
    schedule: Schedule, swa_start_step: int, swa_lr: float, annealing_steps: int
) -> Schedule:
    """After swa_start_step, cosine-anneal from the pre-SWA LR to swa_lr."""

    def fn(step: int) -> float:
        if step < swa_start_step:
            return schedule(step)
        base = F32(schedule(swa_start_step))
        frac = _clip01(F32(step - swa_start_step) / F32(max(1, annealing_steps)))
        return float(F32(swa_lr) + (base - F32(swa_lr)) * F32(0.5) * (F32(1) + _cos(frac)))

    return fn


class OptimConfig(pydantic.BaseModel):
    """The reference's LightningOptimizerConfig surface."""

    model_config = pydantic.ConfigDict(extra="forbid")
    name: tp.Literal["LightningOptimizer"] = "LightningOptimizer"
    optimizer: OptimizerConfig
    scheduler: SchedulerConfig | None = None
    interval: tp.Literal["step", "epoch"] = "step"

    def build(
        self,
        params,
        total_steps: int,
        swa_start_step: int | None = None,
        swa_lr: float = 1e-5,
        steps_per_epoch: int | None = None,
    ) -> tuple[_CountedOptimizer, Schedule]:
        """(optimizer over ``params``, ``schedule(step) -> lr``)."""
        base_lr = self.optimizer.lr
        if self.scheduler is None:
            schedule: Schedule = lambda step: base_lr  # noqa: E731
        elif self.interval == "epoch":
            # torch semantics: scheduler.step() once per epoch
            if steps_per_epoch is None:
                raise ValueError("interval='epoch' requires steps_per_epoch")
            spe = max(1, steps_per_epoch)
            inner = self.scheduler.build(base_lr, max(1, total_steps // spe))
            schedule = lambda step: inner(step // spe)  # noqa: E731
        else:
            schedule = self.scheduler.build(base_lr, total_steps)
        if swa_start_step is not None and swa_start_step < total_steps:
            schedule = _with_swa_annealing(
                schedule, swa_start_step, swa_lr, total_steps - swa_start_step
            )
        return self.optimizer.build(params), schedule
