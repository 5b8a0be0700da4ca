"""Evaluation metrics: streaming Pearson, grouped per-subject, retrieval.

The port of algonauts2025_tpu/training/metrics.py: accumulators of sums on
the device, updated per eval batch and read once at ``compute``.  Grouped
accumulation is an ``index_add_`` over subject ids, with one sentinel slot
that catches ids outside [0, n_groups).
"""

from __future__ import annotations

import typing as tp
import warnings

import numpy as np
import pydantic
import torch

from ..ops.pearson import (
    PearsonState,
    compute_pearson,
    init_pearson_state,
    update_pearson_state,
)

__all__ = [
    "Metric",
    "MetricNeverUpdated",
    "MultidimPearsonCorrCoef",
    "GroupedPearson",
    "GroupedMetric",
    "TopkAcc",
    "Rank",
    "OnlinePearsonCorr",
    "MetricConfig",
    "build_metric",
]


class MetricNeverUpdated(RuntimeError):
    """compute() was called on a metric that received no update() calls."""


class Metric:
    """Streaming metric protocol: reset / update / compute.

    - ``is_retrieval``: wants segment-level (N, D) embeddings (time-pooled
      predictions/targets) instead of flattened voxel rows.
    - ``needs_groups``: wants the per-row group ids (subject indices).
    """

    higher_is_better: bool = True
    is_retrieval: bool = False
    needs_groups: bool = False

    def reset(self) -> None:
        raise NotImplementedError

    def update(
        self, preds: torch.Tensor, target: torch.Tensor, groups: torch.Tensor | None = None
    ) -> None:
        raise NotImplementedError

    def compute(self) -> tp.Any:
        raise NotImplementedError


class MultidimPearsonCorrCoef(Metric):
    """Mean of per-voxel Pearson r over flattened (N, D) predictions."""

    def __init__(self, num_outputs: int | None = None):
        self.num_outputs = num_outputs
        self.reset()

    def reset(self) -> None:
        self._state: PearsonState | None = None

    def update(self, preds, target, groups=None) -> None:
        preds = preds.reshape(-1, preds.shape[-1])
        target = target.reshape(-1, target.shape[-1])
        if self.num_outputs is not None and preds.shape[-1] != self.num_outputs:
            raise ValueError(
                f"MultidimPearsonCorrCoef(num_outputs={self.num_outputs}) "
                f"got predictions with {preds.shape[-1]} outputs"
            )
        if self._state is None:
            self._state = init_pearson_state(preds.shape[-1], preds.device)
        self._state = update_pearson_state(self._state, preds, target)

    def compute(self) -> float:
        if self._state is None:
            raise MetricNeverUpdated("update() must run before compute()")
        return float(torch.nanmean(compute_pearson(self._state)))

    def per_voxel(self) -> np.ndarray:
        assert self._state is not None
        return compute_pearson(self._state).cpu().numpy()


class GroupedPearson(Metric):
    """Per-group (subject) mean voxel Pearson via one grouped sum state."""

    needs_groups = True

    def __init__(self, n_groups: int, num_outputs: int | None = None):
        self.n_groups = n_groups
        self.num_outputs = num_outputs
        self.reset()

    def reset(self) -> None:
        self._state: PearsonState | None = None

    def update(self, preds, target, groups=None) -> None:
        preds = preds.reshape(-1, preds.shape[-1]).float()
        target = target.reshape(-1, target.shape[-1]).float()
        if self.num_outputs is not None and preds.shape[-1] != self.num_outputs:
            raise ValueError(
                f"GroupedPearson(num_outputs={self.num_outputs}) got "
                f"predictions with {preds.shape[-1]} outputs"
            )
        if groups is None:
            groups = torch.zeros((preds.shape[0],), dtype=torch.long, device=preds.device)
        groups = groups.reshape(-1).long()
        # ids outside [0, n_groups) land in the sentinel slot n_groups and
        # raise at compute(); no per-batch device sync is paid
        groups = torch.where(
            (groups < 0) | (groups >= self.n_groups), self.n_groups, groups
        )
        if self._state is None:
            z = torch.zeros((self.n_groups + 1, preds.shape[-1]), device=preds.device)
            self._state = PearsonState(
                torch.zeros((self.n_groups + 1,), device=preds.device), z, z, z, z, z
            )

        def seg(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
            return acc.index_add(0, groups, x)

        s = self._state
        self._state = PearsonState(
            n=seg(s.n, torch.ones((preds.shape[0],), device=preds.device)),
            sx=seg(s.sx, preds),
            sy=seg(s.sy, target),
            sxx=seg(s.sxx, preds**2),
            syy=seg(s.syy, target**2),
            sxy=seg(s.sxy, preds * target),
        )

    def compute(self) -> dict[str, float]:
        if self._state is None:
            raise MetricNeverUpdated("update() must run before compute()")
        overflow = float(self._state.n[self.n_groups])
        if overflow:
            raise ValueError(
                f"GroupedPearson(n_groups={self.n_groups}) saw {int(overflow)} "
                "rows with group id outside [0, n_groups); raise n_groups to "
                "cover every group id"
            )
        s = self._state
        r = compute_pearson(PearsonState(s.n[:, None], s.sx, s.sy, s.sxx, s.syy, s.sxy))
        counts = s.n.cpu().numpy()
        r = r.cpu().numpy()
        out: dict[str, float] = {}
        for g in range(self.n_groups):
            if counts[g] == 0:
                continue  # group id never present in this split
            if counts[g] <= 1:
                # Pearson is undefined on one row: NaN keeps the group visible
                warnings.warn(
                    f"GroupedPearson: group {g} has only {int(counts[g])} "
                    "row(s); Pearson undefined, emitting NaN",
                    RuntimeWarning,
                    stacklevel=2,
                )
                out[str(g)] = float("nan")
            else:
                out[str(g)] = float(np.nanmean(r[g]))
        return out


class GroupedMetric(Metric):
    """Any metric, one independent instance per group id, created lazily."""

    needs_groups = True

    def __init__(self, factory: tp.Callable[[], Metric]):
        self.factory = factory
        probe = factory()
        self.is_retrieval = probe.is_retrieval
        self.higher_is_better = probe.higher_is_better
        self.reset()

    def reset(self) -> None:
        self._members: dict[int, Metric] = {}

    def update(self, preds, target, groups=None) -> None:
        rows = (
            torch.zeros((preds.shape[0],), dtype=torch.long)
            if groups is None
            else groups.reshape(-1).cpu()
        )
        preds = preds.reshape(-1, preds.shape[-1])
        target = target.reshape(-1, target.shape[-1])
        if rows.shape[0] != preds.shape[0]:
            raise ValueError(f"groups ({rows.shape[0]}) must match rows ({preds.shape[0]})")
        for g in torch.unique(rows).tolist():
            member = self._members.setdefault(int(g), self.factory())
            keep = torch.nonzero(rows == g).reshape(-1).to(preds.device)
            member.update(preds[keep], target[keep])

    def compute(self) -> dict[str, tp.Any]:
        if not self._members:
            raise MetricNeverUpdated("update() must run before compute()")
        return {str(g): m.compute() for g, m in sorted(self._members.items())}


def _retrieval_ranks(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-15) -> torch.Tensor:
    """Rank of the true row of y for each row of x under cosine-vs-y
    scoring (norm on y only, midrank ties)."""
    inv_norms = 1.0 / (eps + torch.linalg.norm(y, dim=1))
    scores = torch.einsum("bc,oc,o->bo", x, y, inv_norms)
    true_scores = torch.diagonal(scores)[:, None]
    nan = torch.isnan(scores)
    ranks_gt = torch.sum((scores > true_scores) & ~nan, dim=1)
    ranks_ge = torch.sum((scores >= true_scores) & ~nan, dim=1) - 1
    ranks = (ranks_gt + ranks_ge) / 2
    return torch.where(ranks < 0, float(len(scores) // 2), ranks)


class Rank(Metric):
    higher_is_better = False
    is_retrieval = True

    def __init__(self, reduction: str = "median", relative: bool = False):
        self.reduction = reduction
        self.relative = relative
        self.reset()

    def reset(self) -> None:
        self._ranks: list[torch.Tensor] = []

    def update(self, preds, target, groups=None) -> None:
        ranks = _retrieval_ranks(preds, target)
        if self.relative:
            ranks = ranks / target.shape[0]
        self._ranks.append(ranks)

    def _all_ranks(self) -> np.ndarray:
        if not self._ranks:
            raise MetricNeverUpdated("update() must run before compute()")
        return torch.cat(self._ranks).cpu().numpy()

    def compute(self) -> float:
        agg = {"mean": np.mean, "median": np.median, "std": np.std}[self.reduction]
        return float(agg(self._all_ranks()))


class TopkAcc(Rank):
    higher_is_better = True

    def __init__(self, topk: int = 5):
        super().__init__(relative=False)
        self.topk = topk

    def compute(self) -> float:
        return float((self._all_ranks() < self.topk).mean())


# -- config surface -------------------------------------------------------


class BaseMetricConfig(pydantic.BaseModel):
    model_config = pydantic.ConfigDict(extra="forbid")
    log_name: str
    name: str

    def build(self, n_groups: int | None = None) -> Metric:
        raise NotImplementedError

    @property
    def is_grouped(self) -> bool:
        return self.name == "GroupedMetric"

    @property
    def is_retrieval(self) -> bool:
        return self.name in ("TopkAcc", "Rank")


class PearsonMetricConfig(BaseMetricConfig):
    name: tp.Literal["MultidimPearsonCorrCoef"] = "MultidimPearsonCorrCoef"
    kwargs: dict[str, tp.Any] = {}

    def build(self, n_groups: int | None = None) -> Metric:
        return MultidimPearsonCorrCoef(**self.kwargs)


class GroupedMetricConfig(BaseMetricConfig):
    name: tp.Literal["GroupedMetric"] = "GroupedMetric"
    metric_name: str = "MultidimPearsonCorrCoef"
    kwargs: dict[str, tp.Any] = {}

    def build(self, n_groups: int | None = None) -> Metric:
        if self.metric_name == "MultidimPearsonCorrCoef":
            return GroupedPearson(n_groups=n_groups or 8, **self.kwargs)
        classes = _groupable_metric_classes()
        if self.metric_name not in classes:
            raise ValueError(
                f"GroupedMetric over {self.metric_name!r}: unknown metric, "
                f"use one of {sorted(classes)}"
            )
        return GroupedMetric(lambda: classes[self.metric_name](**self.kwargs))


def _groupable_metric_classes() -> dict[str, type]:
    return {
        "MultidimPearsonCorrCoef": MultidimPearsonCorrCoef,
        "OnlinePearsonCorr": OnlinePearsonCorr,
        "Rank": Rank,
        "TopkAcc": TopkAcc,
    }


class TopkAccConfig(BaseMetricConfig):
    name: tp.Literal["TopkAcc"] = "TopkAcc"
    topk: int = 5

    def build(self, n_groups: int | None = None) -> Metric:
        return TopkAcc(topk=self.topk)


class RankConfig(BaseMetricConfig):
    name: tp.Literal["Rank"] = "Rank"
    reduction: str = "median"
    relative: bool = False

    def build(self, n_groups: int | None = None) -> Metric:
        return Rank(reduction=self.reduction, relative=self.relative)


class OnlinePearsonCorr(MultidimPearsonCorrCoef):
    """Streaming Pearson with the reference's dim / reduction surface
    (the sufficient-statistics accumulator already is online)."""

    def __init__(self, dim: int = 0, reduction: str | None = "mean"):
        self.dim = dim
        self.reduction = reduction
        super().__init__()

    def update(self, preds, target, groups=None) -> None:
        if self.dim == 1:
            preds, target = preds.T, target.T
        super().update(preds, target)

    def compute(self):
        if self._state is None:
            raise MetricNeverUpdated("update() must run before compute()")
        corr = compute_pearson(self._state)
        if self.reduction == "mean":
            return float(torch.nanmean(corr))
        if self.reduction == "sum":
            return float(torch.nansum(corr))
        return corr.cpu().numpy()


class OnlinePearsonCorrConfig(BaseMetricConfig):
    name: tp.Literal["OnlinePearsonCorr"] = "OnlinePearsonCorr"
    dim: int = 0
    reduction: str | None = "mean"

    def build(self, n_groups: int | None = None) -> Metric:
        return OnlinePearsonCorr(dim=self.dim, reduction=self.reduction)


MetricConfig = tp.Annotated[
    tp.Union[PearsonMetricConfig, GroupedMetricConfig, TopkAccConfig, RankConfig,
             OnlinePearsonCorrConfig],
    pydantic.Field(discriminator="name"),
]


def build_metric(config: tp.Any, n_groups: int | None = None) -> Metric:
    if isinstance(config, BaseMetricConfig):
        return config.build(n_groups)
    return pydantic.TypeAdapter(MetricConfig).validate_python(config).build(n_groups)
