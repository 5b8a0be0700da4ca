"""The port's losses, optimizers, schedulers and metrics against the JAX package's.

Every loss name of the JAX table (and PearsonLoss) goes through both
``build_loss`` on the same numpy-seeded inputs: fp32, rtol 1e-6 / atol
1e-6.  Every optimizer x scheduler trains the same parameters on the same
gradients through the port's rule and the JAX package's optax chain:
parameters after 5 steps at rtol 1e-5, and after 8 with set kwargs (RAdam
with b2 = 0.99 enters its rectified branch at step 6; with the default
b2 = 0.999 that branch's rho = 1999 - 1993 cancels in fp32, so the last
ulp of b2**t, where numpy's pow and XLA's differ, moves the step by 0.6 %); every schedule's learning rates at rtol 5e-7 (both compute in
fp32; numpy's cos and XLA's differ by up to 3 ulp), which on these rates
of 1e-4 to 2e-2 is tighter than 1e-7 absolute.  The metrics are
the twins of ``tests/test_models_training.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from algonauts2025_tpu.training import metrics as jax_metrics
from algonauts2025_tpu.training import optim as jax_optim
from algonauts2025_tpu.training.losses import build_loss as jax_build_loss
from algonauts2025_tpu_torch.training import metrics, optim
from algonauts2025_tpu_torch.training.losses import build_loss

LOSS_TOL = dict(rtol=1e-6, atol=1e-6)


def _loss_inputs():
    """name -> (kwargs, numpy args) for every loss of the JAX table."""
    rng = np.random.default_rng(0)
    n, c = 24, 7
    raw = rng.standard_normal((n, c)).astype(np.float32)
    tgt = rng.standard_normal((n, c)).astype(np.float32)
    x2 = rng.standard_normal((n, c)).astype(np.float32)
    probs = (1 / (1 + np.exp(-raw))).astype(np.float32)
    tprob = (1 / (1 + np.exp(-tgt))).astype(np.float32)
    logp = np.log(probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    psum = (tprob / tprob.sum(-1, keepdims=True)).astype(np.float32)
    psum[0, 0] = 0.0  # a zero target probability takes KLDivLoss's where
    signs = (np.sign(tgt) + (tgt == 0)).astype(np.float32)
    counts = (np.abs(tgt) * 3).astype(np.float32)
    classes = rng.integers(0, c, size=(n,))
    binlab = (tgt > 0).astype(np.float32)
    var = (np.abs(x2) + 0.1).astype(np.float32)
    ml_tgt = np.full((n, c), -1, np.int64)
    for i in range(n):
        k = int(rng.integers(1, 4))
        ml_tgt[i, :k] = rng.choice(c, size=k, replace=False)
    t, nb, nc, s = 12, 4, 6, 5
    lp = rng.standard_normal((t, nb, nc)).astype(np.float32)
    lp = (lp - np.log(np.exp(lp).sum(-1, keepdims=True))).astype(np.float32)
    ctc_tgt = rng.integers(1, nc, size=(nb, s))
    ctc_tgt[0, 1] = ctc_tgt[0, 0]  # a repeated label takes the blank-between path
    il = np.array([t, t, t - 3, t - 1])
    tl = rng.integers(2, s + 1, size=(nb,))
    return {
        "MSELoss": ({}, (raw, tgt)),
        "L1Loss": ({}, (raw, tgt)),
        "HuberLoss": ({"delta": 0.7}, (raw, tgt)),
        "SmoothL1Loss": ({"beta": 0.8}, (raw, tgt)),
        "BCELoss": ({}, (probs, tprob)),
        "BCEWithLogitsLoss": ({}, (raw * 5, tprob)),
        "KLDivLoss": ({}, (logp, psum)),
        "PoissonNLLLoss": ({}, (raw, counts)),
        "CrossEntropyLoss": ({}, (raw, psum)),
        "SoftMarginLoss": ({}, (raw, signs)),
        "NLLLoss": ({}, (logp, classes)),
        "MarginRankingLoss": ({"margin": 0.2}, (raw, x2, signs)),
        "HingeEmbeddingLoss": ({}, (raw, signs)),
        "MultiLabelSoftMarginLoss": ({}, (raw, binlab)),
        "GaussianNLLLoss": ({"full": True}, (raw, x2, var)),
        "CosineEmbeddingLoss": ({"margin": 0.1}, (raw, x2, signs[:, 0])),
        "TripletMarginLoss": ({}, (raw, x2, tgt)),
        "MultiMarginLoss": ({}, (raw, classes)),
        "MultiLabelMarginLoss": ({}, (raw, ml_tgt)),
        "CTCLoss": ({}, (lp, ctc_tgt, il, tl)),
    }


LOSS_CASES = _loss_inputs()


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_matches_jax(name):
    kwargs, args = LOSS_CASES[name]
    config = {"name": name, "kwargs": kwargs}
    want = np.asarray(jax_build_loss(config)(*(jnp.asarray(a) for a in args)))
    got = build_loss(config)(*(torch.from_numpy(np.asarray(a)) for a in args))
    np.testing.assert_allclose(got.numpy(), want, **LOSS_TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("dim", [0, 1])
def test_pearson_loss_config_matches_jax(rng, reduction, dim):
    p = rng.standard_normal((12, 5)).astype(np.float32)
    t = rng.standard_normal((12, 5)).astype(np.float32)
    config = {"name": "PearsonLoss", "dim": dim, "reduction": reduction}
    want = np.asarray(jax_build_loss(config)(jnp.asarray(p), jnp.asarray(t)))
    got = build_loss(config)(torch.from_numpy(p), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), want, **LOSS_TOL)


@pytest.mark.parametrize("reduction", ["sum", "none"])
def test_ctc_reductions_match_jax(reduction):
    _, args = LOSS_CASES["CTCLoss"]
    config = {"name": "CTCLoss", "kwargs": {"reduction": reduction}}
    want = np.asarray(jax_build_loss(config)(*(jnp.asarray(a) for a in args)))
    got = build_loss(config)(*(torch.from_numpy(np.asarray(a)) for a in args))
    np.testing.assert_allclose(got.numpy(), want, **LOSS_TOL)


def test_loss_gradients_match_jax(rng):
    """The soup's losses train: their gradients agree too (fp32, 1e-6)."""
    p = rng.standard_normal((16, 6)).astype(np.float32) * 2
    t = rng.standard_normal((16, 6)).astype(np.float32)
    for name in ("SmoothL1Loss", "HuberLoss", "MSELoss", "PearsonLoss"):
        fn = jax_build_loss({"name": name})
        want = np.asarray(jax.grad(lambda a: fn(a, jnp.asarray(t)))(jnp.asarray(p)))
        x = torch.from_numpy(p.copy()).requires_grad_()
        build_loss({"name": name})(x, torch.from_numpy(t)).backward()
        np.testing.assert_allclose(x.grad.numpy(), want, err_msg=name, **LOSS_TOL)


def test_loss_kwargs_accept_torch_defaults_reject_changes():
    """A ported config may spell out torch defaults; behaviour-changing or
    unknown kwargs stay loud, and unknown names list the supported ones."""
    a, b = torch.randn(4, 5), torch.randn(4, 5)
    same = build_loss({"name": "MSELoss", "kwargs": {"reduction": "mean"}})(a, b)
    assert float(same) == pytest.approx(float(build_loss({"name": "MSELoss"})(a, b)))
    huber = build_loss({"name": "HuberLoss", "kwargs": {"reduction": "mean", "delta": 1.0}})
    assert np.isfinite(float(huber(a, b)))
    for kwargs in ({"reduction": "sum"}, {"not_a_kwarg": 1}):
        with pytest.raises(ValueError, match="unsupported kwargs"):
            build_loss({"name": "MSELoss", "kwargs": kwargs})
    with pytest.raises(ValueError, match="PearsonLoss"):
        build_loss({"name": "NoSuchLoss"})


# -- optimizers x schedulers -------------------------------------------------

OPTIMIZERS = ["Adam", "AdamW", "SGD", "Adagrad", "RMSprop", "Lion", "Adamax", "NAdam",
              "RAdam", "Adadelta", "Adafactor", "LAMB"]
SCHEDULERS = {
    None: None,
    "OneCycleLR": {"max_lr": 2e-2, "pct_start": 0.3},
    "CosineAnnealingLR": {"eta_min": 1e-4},
    "StepLR": {"step_size": 3, "gamma": 0.5},
    "LinearLR": {"start_factor": 0.25, "total_iters": 6},
}
#: the (in, out) kernel is factored by Adafactor (both dims >= 128)
SHAPES = {"kernel": (130, 128), "bias": (6,), "scalar": ()}


def _optim_config(name, scheduler, kwargs):
    cfg = {"optimizer": {"name": name, "lr": 1e-2, "kwargs": kwargs}}
    if scheduler is not None:
        cfg["scheduler"] = {"name": scheduler, "kwargs": SCHEDULERS[scheduler]}
    return cfg


def _train_both(name, scheduler, kwargs, n_steps, swa=None):
    rng = np.random.default_rng(3)
    p0 = {k: np.asarray(rng.standard_normal(s), np.float32) for k, s in SHAPES.items()}
    grads = [{k: np.asarray(rng.standard_normal(s) * 0.1, np.float32) for k, s in SHAPES.items()}
             for _ in range(n_steps)]
    grads[2]["bias"][:] = 0.0  # a zero gradient: Adagrad's where, LAMB's trust ratio
    cfg = _optim_config(name, scheduler, kwargs)
    tx, _ = jax_optim.OptimConfig(**cfg).build(n_steps + 2, swa_start_step=swa)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt, schedule = optim.OptimConfig(**cfg).build(list(tensors.values()), n_steps + 2,
                                                   swa_start_step=swa)
    for step, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in tensors.items():
            p.grad = torch.from_numpy(g[k])
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
    return params, tensors


@pytest.mark.parametrize("scheduler", list(SCHEDULERS))
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_optax(name, scheduler):
    want, got = _train_both(name, scheduler, {}, n_steps=5)
    for k in SHAPES:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name,kwargs", [
    ("SGD", {"momentum": 0.9, "weight_decay": 0.01}),
    ("RMSprop", {"momentum": 0.5, "weight_decay": 0.01}),
    ("Adagrad", {"weight_decay": 0.01}),
    ("Lion", {"weight_decay": 0.1, "betas": (0.8, 0.9)}),
    ("NAdam", {"weight_decay": 0.01, "betas": (0.8, 0.95), "eps": 1e-6}),
    ("RAdam", {"betas": (0.9, 0.99)}),
    ("Adamax", {"weight_decay": 0.01, "eps": 1e-6}),
    ("Adadelta", {"weight_decay": 0.01}),
    ("Adafactor", {"weight_decay": 0.01}),
    ("LAMB", {"weight_decay": 0.01, "eps": 1e-6}),
])
def test_optimizer_kwargs_match_optax(name, kwargs):
    """Momentum, weight decay (torch's L2 term, or Lion's and LAMB's own)
    and betas/eps reach the rule as they reach the optax chain; Lion's
    betas are the chain's own, as in the JAX package."""
    want, got = _train_both(name, "CosineAnnealingLR", kwargs, n_steps=8)
    for k in SHAPES:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("swa", [None, 5])
@pytest.mark.parametrize("interval", ["step", "epoch"])
@pytest.mark.parametrize("scheduler", [s for s in SCHEDULERS if s])
def test_schedule_learning_rates_match_jax(scheduler, interval, swa):
    total = 20
    cfg = dict(_optim_config("Adam", scheduler, {}), interval=interval)
    _, ref = jax_optim.OptimConfig(**cfg).build(total, swa_start_step=swa, swa_lr=2e-4,
                                                steps_per_epoch=3)
    _, sched = optim.OptimConfig(**cfg).build([torch.zeros(1, requires_grad=True)], total,
                                              swa_start_step=swa, swa_lr=2e-4,
                                              steps_per_epoch=3)
    want = np.array([float(ref(jnp.int32(s))) for s in range(total + 3)])
    got = np.array([sched(s) for s in range(total + 3)])
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)


def test_optimizer_state_round_trips(rng):
    """The step count and per-param state survive state_dict / load."""
    w = torch.nn.Parameter(torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)))
    opt = optim.OptimizerConfig(name="RAdam", lr=0.1).build([w])
    for _ in range(3):
        w.grad = torch.ones_like(w)
        opt.step()
    fresh = optim.OptimizerConfig(name="RAdam", lr=0.1).build([w])
    fresh.load_state_dict(opt.state_dict())
    assert fresh.count == 3
    torch.testing.assert_close(fresh.state[w]["mu"], opt.state[w]["mu"])


def test_unknown_optimizer_and_scheduler_raise():
    with pytest.raises(ValueError, match="Unknown optimizer"):
        optim.OptimizerConfig(name="Nope", lr=1e-3).build([torch.nn.Parameter(torch.ones(1))])
    with pytest.raises(ValueError, match="Unknown scheduler"):
        optim.SchedulerConfig(name="Nope").build(1e-3, 10)
    with pytest.raises(ValueError, match="Unsupported StepLR"):
        optim.SchedulerConfig(name="StepLR", kwargs={"step_size": 2, "last_epoch": 3}).build(
            1e-3, 10)


# -- metrics (test_models_training.py:365-509) -------------------------------


def test_metrics_surface_matches_jax(rng):
    p = rng.standard_normal((30, 5)).astype(np.float32)
    t = (p + 0.5 * rng.standard_normal((30, 5))).astype(np.float32)
    groups = np.array([0] * 15 + [1] * 15)
    for config, kw in [
        ({"log_name": "pearson", "name": "MultidimPearsonCorrCoef",
          "kwargs": {"num_outputs": 5}}, {}),
        ({"log_name": "subj", "name": "GroupedMetric", "metric_name": "MultidimPearsonCorrCoef",
          "kwargs": {"num_outputs": 5}}, {"groups": groups}),
        ({"log_name": "ret", "name": "TopkAcc", "topk": 2}, {}),
        ({"log_name": "rank", "name": "Rank", "relative": True}, {}),
    ]:
        ref = jax_metrics.build_metric(config, n_groups=2)
        got = metrics.build_metric(config, n_groups=2)
        ref.update(jnp.asarray(p), jnp.asarray(t),
                   **{k: jnp.asarray(v) for k, v in kw.items()})
        got.update(torch.from_numpy(p), torch.from_numpy(t),
                   **{k: torch.from_numpy(v) for k, v in kw.items()})
        want, have = ref.compute(), got.compute()
        if isinstance(want, dict):
            assert set(have) == set(want)
            np.testing.assert_allclose([have[k] for k in want], list(want.values()), rtol=1e-5)
        else:
            assert have == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("metric_name,kwargs", [
    ("TopkAcc", {"topk": 1}),
    ("Rank", {"reduction": "mean"}),
    ("OnlinePearsonCorr", {"reduction": "mean"}),
    ("OnlinePearsonCorr", {"reduction": "sum", "dim": 1}),
    ("MultidimPearsonCorrCoef", {}),
])
def test_grouped_metric_wraps_any_metric(rng, metric_name, kwargs):
    """GroupedMetric over each groupable metric gives the JAX package's
    per-group values and capability flags."""
    p = rng.standard_normal((30, 5)).astype(np.float32)
    t = (p + rng.standard_normal((30, 5))).astype(np.float32)
    groups = np.array([0] * 12 + [1] * 18)
    config = {"log_name": "g", "name": "GroupedMetric", "metric_name": metric_name,
              "kwargs": kwargs}
    ref = jax_metrics.GroupedMetric(
        lambda: jax_metrics._groupable_metric_classes()[metric_name](**kwargs))
    got = metrics.build_metric(config, n_groups=2)
    if metric_name != "MultidimPearsonCorrCoef":
        assert isinstance(got, metrics.GroupedMetric)
        assert (got.is_retrieval, got.needs_groups) == (ref.is_retrieval, True)
    ref.update(jnp.asarray(p), jnp.asarray(t), groups=jnp.asarray(groups))
    got.update(torch.from_numpy(p), torch.from_numpy(t), groups=torch.from_numpy(groups))
    want, have = ref.compute(), got.compute()
    assert set(have) == set(want)
    np.testing.assert_allclose([have[k] for k in want], [want[k] for k in want], rtol=1e-5)
    with pytest.raises(ValueError, match="unknown metric"):
        metrics.build_metric({"log_name": "bad", "name": "GroupedMetric", "metric_name": "Nope"})


@pytest.mark.parametrize("dim,reduction", [(0, "mean"), (0, "sum"), (1, "mean"), (0, None)])
def test_online_pearson_matches_jax(rng, dim, reduction):
    config = {"log_name": "o", "name": "OnlinePearsonCorr", "dim": dim, "reduction": reduction}
    ref, got = jax_metrics.build_metric(config), metrics.build_metric(config)
    for _ in range(2):  # streamed over two updates
        p = rng.standard_normal((9, 9)).astype(np.float32)
        t = (p + rng.standard_normal((9, 9))).astype(np.float32)
        ref.update(jnp.asarray(p), jnp.asarray(t))
        got.update(torch.from_numpy(p), torch.from_numpy(t))
    np.testing.assert_allclose(np.asarray(got.compute()), np.asarray(ref.compute()), rtol=1e-5)


def test_metric_never_updated_raises():
    for m in [metrics.MultidimPearsonCorrCoef(), metrics.GroupedPearson(n_groups=2),
              metrics.Rank(), metrics.TopkAcc(), metrics.OnlinePearsonCorr(),
              metrics.GroupedMetric(metrics.OnlinePearsonCorr)]:
        with pytest.raises(metrics.MetricNeverUpdated):
            m.compute()
