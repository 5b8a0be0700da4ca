"""Loss functions + config registry.

The port of algonauts2025_tpu/training/losses.py: losses are plain
functions over (N, D) tensors, and the config surface keeps the
reference's names ("MSELoss", "SmoothL1Loss", ...) so grid configs port
unchanged.  Each function is the JAX package's formula over torch ops
(CTCLoss is optax's forward recursion, not ``F.ctc_loss``), so both
packages compute the same number in the same order.
"""

from __future__ import annotations

import inspect
import typing as tp

import pydantic
import torch

__all__ = ["LossConfig", "PearsonLossConfig", "TorchLossConfig", "build_loss",
           "mse_loss", "pearson_loss"]

LossFn = tp.Callable[..., torch.Tensor]


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    abs_err = torch.abs(pred - target)
    quad = torch.clamp(abs_err, max=delta)
    return torch.mean(0.5 * quad**2 + delta * (abs_err - quad))


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    err = torch.abs(pred - target)
    return torch.mean(torch.where(err < beta, 0.5 * err**2 / beta, err - 0.5 * beta))


def pearson_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    dim: int = 1,
    eps: float = 1e-8,
    reduction: str = "mean",
) -> torch.Tensor:
    """1 - r per column of (N, D), reduced like torch losses."""
    x = torch.movedim(pred, dim, 0)
    y = torch.movedim(target, dim, 0)
    x = x.reshape(x.shape[0], -1)
    y = y.reshape(y.shape[0], -1)
    x = x - x.mean(dim=1, keepdim=True)
    y = y - y.mean(dim=1, keepdim=True)
    cov = torch.sum(x * y, dim=1)
    # eps inside the sqrt: finite gradient for constant (zero-variance) rows
    xs = torch.sqrt(torch.sum(x**2, dim=1) + eps)
    ys = torch.sqrt(torch.sum(y**2, dim=1) + eps)
    per_column = 1 - cov / (xs * ys + eps)
    if reduction == "sum":
        return torch.sum(per_column)
    if reduction == "none":
        return per_column
    return torch.mean(per_column)


def bce_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    p = torch.clamp(pred, eps, 1 - eps)
    return -torch.mean(target * torch.log(p) + (1 - target) * torch.log1p(-p))


def bce_with_logits_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    # log-sum-exp form, numerically stable for large |pred|
    return torch.mean(
        torch.clamp(pred, min=0) - pred * target + torch.log1p(torch.exp(-torch.abs(pred)))
    )


def kl_div_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch.nn.KLDivLoss semantics: pred is log-probabilities, target is
    probabilities; the "mean" reduction averages over all elements."""
    log_t = torch.log(torch.clamp(target, min=1e-38))
    return torch.mean(torch.where(target > 0, target * (log_t - pred), 0.0))


def poisson_nll_loss(pred: torch.Tensor, target: torch.Tensor, log_input: bool = True,
                     eps: float = 1e-8) -> torch.Tensor:
    if log_input:
        return torch.mean(torch.exp(pred) - target * pred)
    return torch.mean(pred - target * torch.log(pred + eps))


def cross_entropy_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch CrossEntropyLoss with probability targets over the last axis."""
    return torch.mean(-torch.sum(target * torch.log_softmax(pred, dim=-1), dim=-1))


def soft_margin_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.log1p(torch.exp(-target * pred)))


def nll_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch.nn.NLLLoss over (N, C) log-probabilities.  Integer targets pick
    a class per row; float targets of pred's shape are soft class weights
    (the JAX package's documented extension)."""
    if not torch.is_floating_point(target):
        return -torch.mean(torch.gather(pred, -1, target.long()[:, None])[:, 0])
    return -torch.mean(torch.sum(target * pred, dim=-1))


def margin_ranking_loss(x1: torch.Tensor, x2: torch.Tensor, target: torch.Tensor,
                        margin: float = 0.0) -> torch.Tensor:
    """torch.nn.MarginRankingLoss, with torch's three arguments: it
    validates in a config but the two-argument trainer step cannot drive it."""
    return torch.mean(torch.clamp(-target * (x1 - x2) + margin, min=0.0))


def hinge_embedding_loss(pred: torch.Tensor, target: torch.Tensor,
                         margin: float = 1.0) -> torch.Tensor:
    """x where y==1, max(0, margin-x) where y==-1."""
    return torch.mean(torch.where(target > 0, pred, torch.clamp(margin - pred, min=0.0)))


def multilabel_soft_margin_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-class sigmoid BCE on logits, mean over classes then over rows."""
    softplus = torch.nn.functional.softplus
    per_class = target * softplus(-pred) + (1 - target) * softplus(pred)
    return torch.mean(torch.mean(per_class, dim=-1))


def gaussian_nll_loss(pred: torch.Tensor, target: torch.Tensor, var: torch.Tensor,
                      full: bool = False, eps: float = 1e-6) -> torch.Tensor:
    """torch.nn.GaussianNLLLoss (input, target, var)."""
    v = torch.clamp(var, min=eps)
    out = 0.5 * (torch.log(v) + (pred - target) ** 2 / v)
    if full:
        out = out + 0.5 * torch.log(torch.tensor(2 * torch.pi, dtype=out.dtype))
    return torch.mean(out)


def cosine_embedding_loss(x1: torch.Tensor, x2: torch.Tensor, target: torch.Tensor,
                          margin: float = 0.0, eps: float = 1e-8) -> torch.Tensor:
    """torch.nn.CosineEmbeddingLoss (x1, x2, target)."""
    norms = torch.linalg.norm(x1, dim=-1) * torch.linalg.norm(x2, dim=-1)
    cos = torch.sum(x1 * x2, dim=-1) / torch.clamp(norms, min=eps)
    per_row = torch.where(target > 0, 1.0 - cos, torch.clamp(cos - margin, min=0.0))
    return torch.mean(per_row)


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor,
                        margin: float = 1.0, p: float = 2.0, eps: float = 1e-6) -> torch.Tensor:
    """torch.nn.TripletMarginLoss, with F.pairwise_distance's elementwise +eps."""
    def dist(a, b):
        return torch.sum(torch.abs(a - b + eps) ** p, dim=-1) ** (1.0 / p)

    return torch.mean(torch.clamp(dist(anchor, positive) - dist(anchor, negative) + margin,
                                  min=0.0))


def multi_margin_loss(pred: torch.Tensor, target: torch.Tensor, p: float = 1.0,
                      margin: float = 1.0) -> torch.Tensor:
    """torch.nn.MultiMarginLoss: class-index targets over (N, C) scores."""
    c = pred.shape[1]
    true_score = torch.gather(pred, -1, target.long()[:, None])
    viol = torch.clamp(margin - true_score + pred, min=0.0) ** p
    onehot = torch.nn.functional.one_hot(target.long(), c).bool()
    return torch.mean(torch.sum(torch.where(onehot, 0.0, viol), dim=-1) / c)


def multilabel_margin_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch.nn.MultiLabelMarginLoss: int targets, -1-terminated per row."""
    n, c = pred.shape
    tgt = target.long()
    # valid targets: everything before the first -1 in each row
    is_tgt_slot = ~(torch.cumsum((tgt < 0).long(), dim=-1) > 0)
    safe = torch.where(is_tgt_slot, torch.clamp(tgt, min=0), 0)
    tgt_mask = torch.zeros((n, c), dtype=torch.bool, device=pred.device)
    tgt_mask.scatter_reduce_(1, safe, is_tgt_slot, reduce="amax")
    # sum over (target j, non-target k) of max(0, 1 - (x[j] - x[k])) / C
    xj = torch.gather(pred, -1, safe)  # (N, S) target scores
    hinge = torch.clamp(1.0 - (xj[:, :, None] - pred[:, None, :]), min=0.0)  # (N, S, C)
    valid = is_tgt_slot[:, :, None] & ~tgt_mask[:, None, :]
    return torch.mean(torch.sum(torch.where(valid, hinge, 0.0), dim=(1, 2)) / c)


def _ctc_per_sequence(logits: torch.Tensor, logit_pad: torch.Tensor, labels: torch.Tensor,
                      label_pad: torch.Tensor, blank: int = 0,
                      log_epsilon: float = -1e5) -> torch.Tensor:
    """optax.ctc_loss: the per-sequence negative log-likelihood of (B, T, K)
    logits (log-softmaxed here) by the same blank/emit forward recursion."""
    b, _, k = logits.shape
    n = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = n - torch.sum(label_pad, dim=1).long()
    repeat = (labels[:, :-1] == labels[:, 1:]).float()
    repeat = torch.nn.functional.pad(repeat, (0, 1))
    logprobs_phi = logprobs[:, :, blank:blank + 1].transpose(0, 1)  # (T, B, 1)
    one_hot = torch.nn.functional.one_hot(labels.long(), k).to(logprobs.dtype)  # (B, N, K)
    logprobs_emit = torch.einsum("btk,bnk->btn", logprobs, one_hot).transpose(0, 1)  # (T, B, N)
    phi = torch.full((b, n + 1), log_epsilon, dtype=logprobs.dtype, device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), log_epsilon, dtype=logprobs.dtype, device=logits.device)

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=-1)

    for log_emit, log_phi, pad in zip(logprobs_emit, logprobs_phi, logit_pad.transpose(0, 1)):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + log_epsilon * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + log_emit, emit + log_emit)
        next_phi = prev_phi + log_phi
        next_phi = update_phi(next_phi, emit + log_phi + log_epsilon * (1.0 - repeat))
        pad = pad.reshape(b, 1)
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = update_phi(phi, emit)
    return -torch.gather(last, 1, labellens[:, None])[:, 0]


def ctc_loss(log_probs: torch.Tensor, targets: torch.Tensor, input_lengths: torch.Tensor,
             target_lengths: torch.Tensor, blank: int = 0,
             reduction: str = "mean") -> torch.Tensor:
    """torch.nn.CTCLoss semantics on (T, N, C) log-probs; "mean" divides each
    sequence loss by its target length before averaging."""
    t = log_probs.shape[0]
    logits = log_probs.transpose(0, 1)  # (N, T, C)
    steps = torch.arange(t, device=logits.device)[None, :]
    logit_pad = (steps >= input_lengths[:, None]).float()
    s = targets.shape[1]
    label_pad = (torch.arange(s, device=logits.device)[None, :]
                 >= target_lengths[:, None]).float()
    per_seq = _ctc_per_sequence(logits, logit_pad, targets, label_pad, blank=blank)
    if reduction == "sum":
        return torch.sum(per_seq)
    if reduction == "none":
        return per_seq
    return torch.mean(per_seq / torch.clamp(target_lengths, min=1))


_TORCH_STYLE_LOSSES: dict[str, tp.Callable[..., LossFn]] = {
    "MSELoss": lambda: mse_loss,
    "L1Loss": lambda: l1_loss,
    "HuberLoss": lambda delta=1.0: (lambda p, t: huber_loss(p, t, delta=delta)),
    "SmoothL1Loss": lambda beta=1.0: (lambda p, t: smooth_l1_loss(p, t, beta=beta)),
    "BCELoss": lambda: bce_loss,
    "BCEWithLogitsLoss": lambda: bce_with_logits_loss,
    "KLDivLoss": lambda: kl_div_loss,
    "PoissonNLLLoss": lambda log_input=True: (
        lambda p, t: poisson_nll_loss(p, t, log_input=log_input)
    ),
    "CrossEntropyLoss": lambda: cross_entropy_loss,
    "SoftMarginLoss": lambda: soft_margin_loss,
    "NLLLoss": lambda: nll_loss,
    "MarginRankingLoss": lambda margin=0.0: (
        lambda x1, x2, t: margin_ranking_loss(x1, x2, t, margin=margin)
    ),
    "HingeEmbeddingLoss": lambda margin=1.0: (
        lambda p, t: hinge_embedding_loss(p, t, margin=margin)
    ),
    "MultiLabelSoftMarginLoss": lambda: multilabel_soft_margin_loss,
    "GaussianNLLLoss": lambda full=False, eps=1e-6: (
        lambda p, t, v: gaussian_nll_loss(p, t, v, full=full, eps=eps)
    ),
    "CosineEmbeddingLoss": lambda margin=0.0: (
        lambda a, b, t: cosine_embedding_loss(a, b, t, margin=margin)
    ),
    "TripletMarginLoss": lambda margin=1.0, p=2.0: (
        lambda a, pos, neg: triplet_margin_loss(a, pos, neg, margin=margin, p=p)
    ),
    "MultiMarginLoss": lambda p=1.0, margin=1.0: (
        lambda x, t: multi_margin_loss(x, t, p=p, margin=margin)
    ),
    "MultiLabelMarginLoss": lambda: multilabel_margin_loss,
    "CTCLoss": lambda blank=0, reduction="mean": (
        lambda lp, t, il, tl: ctc_loss(lp, t, il, tl, blank=blank, reduction=reduction)
    ),
}


def _torch_default_kwargs(name: str, kwargs: dict[str, tp.Any],
                          candidates: tp.Iterable[str]) -> list[str]:
    """Of ``candidates``, the kwargs that exist on the torch.nn loss of the
    same name with a value equal to the torch default (behavioral no-ops)."""
    cls = getattr(torch.nn, name, None)
    if cls is None:
        return []
    params = inspect.signature(cls.__init__).parameters
    return [
        key for key in candidates
        if key in params
        and params[key].default is not inspect.Parameter.empty
        and kwargs[key] == params[key].default
    ]


class BaseLossConfig(pydantic.BaseModel):
    model_config = pydantic.ConfigDict(extra="forbid")
    name: str

    def build(self) -> LossFn:
        raise NotImplementedError


class PearsonLossConfig(BaseLossConfig):
    name: tp.Literal["PearsonLoss"] = "PearsonLoss"
    reduction: str = "mean"
    dim: int = 1

    def build(self) -> LossFn:
        if self.reduction not in ("mean", "sum", "none"):
            raise ValueError(f"unknown reduction {self.reduction!r}")
        dim, reduction = self.dim, self.reduction
        return lambda pred, target: pearson_loss(pred, target, dim=dim, reduction=reduction)


class TorchLossConfig(BaseLossConfig):
    """Reference-style name + kwargs for standard regression losses."""

    name: tp.Literal[tuple(_TORCH_STYLE_LOSSES)]  # type: ignore[valid-type]
    kwargs: dict[str, tp.Any] = {}

    def build(self) -> LossFn:
        factory = _TORCH_STYLE_LOSSES[self.name]
        supported = set(inspect.signature(factory).parameters)
        kwargs = dict(self.kwargs)
        unknown = set(kwargs) - supported
        # a config ported from the reference may spell out torch defaults
        # this build does not parameterize (MSELoss reduction='mean'): those
        # are no-ops; a kwarg that would change the objective stays loud
        for key in _torch_default_kwargs(self.name, kwargs, unknown):
            kwargs.pop(key)
            unknown.discard(key)
        if unknown:
            raise ValueError(
                f"{self.name}: unsupported kwargs {sorted(unknown)}; this "
                f"build supports {sorted(supported) or 'no kwargs'} (plus "
                "torch-default values of the torch constructor's kwargs)"
            )
        return factory(**kwargs)


#: the ``Experiment.loss`` field: the JAX package's discriminated union
LossConfig = tp.Annotated[
    tp.Union[PearsonLossConfig, TorchLossConfig], pydantic.Field(discriminator="name")
]


def build_loss(config: tp.Any) -> LossFn:
    """A loss from a ``LossConfig`` or its dict (``{"name": ..., ...}``)."""
    if isinstance(config, BaseLossConfig):
        return config.build()
    if isinstance(config, dict) and "name" in config:
        known = sorted(_TORCH_STYLE_LOSSES) + ["PearsonLoss"]
        if config["name"] not in known:
            raise ValueError(
                f"unknown loss {config['name']!r}; supported losses: " + ", ".join(known)
            )
    return pydantic.TypeAdapter(LossConfig).validate_python(config).build()
