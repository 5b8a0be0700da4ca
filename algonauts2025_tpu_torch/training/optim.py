"""Optimizers and LR schedules with the reference config surface.

The port of algonauts2025_tpu/training/optim.py.  Adam and AdamW are a
hand-written step that matches ``optax.scale_by_adam(mu_dtype=...)``: the
first moment is stored in ``mu_dtype`` (bf16 at the flagship: one fewer
fp32 copy of 0.9 B params), updated from the stored value, bias-corrected
in fp32 before the cast.  ``torch.optim.Adam`` has no such knob.  The
schedule is a plain ``step -> lr`` function; from the SWA start step the
LR cosine-anneals to ``swa_lr`` and stays there.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import pydantic
import torch

__all__ = ["Adam", "OptimizerConfig", "SchedulerConfig", "OptimConfig"]

Schedule = tp.Callable[[int], float]

_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class Adam(torch.optim.Optimizer):
    """optax's Adam/AdamW update with a ``mu_dtype`` first moment.

    Per step t (1-based), in fp32 unless noted:
    mu = (1-b1) g + b1 mu_stored (b1 and the product b1*mu in mu_dtype, as
    optax promotes them); nu = (1-b2) g^2 + b2 nu; u = mu/(1-b1^t) / (sqrt(nu/(1-b2^t)) + eps);
    AdamW adds wd*p to u; p += (-lr) u; mu is stored as mu_dtype.
    Adam's weight decay is torch's L2 term, added to the gradient first.
    The learning rate of step t is ``param_groups[0]["lr"]``.
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
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        self.count += 1
        for group in self.param_groups:
            b1, b2 = group["betas"]
            # optax: 1 - decay**count in fp32
            bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
            bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
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

    def state_dict(self):
        out = super().state_dict()
        out["count"] = self.count
        return out

    def load_state_dict(self, state_dict) -> None:
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count", 0))
        super().load_state_dict(state_dict)
        # torch casts loaded state to the param dtype; mu lives in mu_dtype
        for state in self.state.values():
            if "mu" in state and self.mu_dtype is not None:
                state["mu"] = state["mu"].to(self.mu_dtype)


class OptimizerConfig(pydantic.BaseModel):
    model_config = pydantic.ConfigDict(extra="forbid")
    name: str = "Adam"
    lr: float
    kwargs: dict[str, tp.Any] = {}

    def build(self, params) -> Adam:
        kw = dict(self.kwargs)
        weight_decay = kw.pop("weight_decay", 0.0)
        betas = kw.pop("betas", (0.9, 0.999))
        eps = kw.pop("eps", 1e-8)
        kw.pop("momentum", None)  # read by SGD/RMSprop only, as in the JAX package
        mu_dtype = kw.pop("mu_dtype", None)
        if kw:
            raise ValueError(f"Unsupported optimizer kwargs: {list(kw)}")
        if mu_dtype not in _DTYPES:
            raise ValueError(f"unsupported mu_dtype {mu_dtype!r}")
        if self.name not in ("Adam", "AdamW"):
            raise NotImplementedError(
                f"optimizer {self.name!r} is not ported yet (ROADMAP, queue 1: "
                "other optimizers); ported: Adam, AdamW"
            )
        return Adam(
            params, lr=self.lr, betas=betas, eps=eps, weight_decay=weight_decay,
            decoupled=self.name == "AdamW", mu_dtype=_DTYPES[mu_dtype],
        )


class SchedulerConfig(pydantic.BaseModel):
    model_config = pydantic.ConfigDict(extra="forbid")
    name: str = "OneCycleLR"
    kwargs: dict[str, tp.Any] = {}

    def build(self, base_lr: float, total_steps: int) -> Schedule:
        if self.name != "OneCycleLR":
            raise NotImplementedError(
                f"scheduler {self.name!r} is not ported yet (ROADMAP, queue 1: "
                "other schedulers); ported: OneCycleLR"
            )
        kw = dict(self.kwargs)
        max_lr = kw.pop("max_lr", base_lr)
        pct_start = kw.pop("pct_start", 0.3)
        div_factor = kw.pop("div_factor", 25.0)
        final_div_factor = kw.pop("final_div_factor", 1e4)
        if kw:
            raise ValueError(f"Unsupported OneCycleLR scheduler kwargs: {sorted(kw)}")
        total = max(2, total_steps)
        warmup = min(max(1, round(total * pct_start)), total - 1)
        init = max_lr / div_factor
        final = init / final_div_factor

        def schedule(step: int) -> float:
            step = min(step, total)
            if step < warmup:
                up = min(max(step / warmup, 0.0), 1.0)
                return init + (max_lr - init) * 0.5 * (1 - math.cos(math.pi * up))
            down = min(max((step - warmup) / (total - warmup), 0.0), 1.0)
            return final + (max_lr - final) * 0.5 * (1 + math.cos(math.pi * down))

        return schedule


def _with_swa_annealing(
    schedule: Schedule, swa_start_step: int, swa_lr: float, annealing_steps: int
) -> Schedule:
    """After swa_start_step, cosine-anneal from the pre-SWA LR to swa_lr."""

    def fn(step: int) -> float:
        if step < swa_start_step:
            return schedule(step)
        base = schedule(swa_start_step)
        frac = min(max((step - swa_start_step) / max(1, annealing_steps), 0.0), 1.0)
        return swa_lr + (base - swa_lr) * 0.5 * (1 + math.cos(math.pi * frac))

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
    ) -> tuple[Adam, Schedule]:
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
