"""The port's training slice against the JAX package's, on the CPU.

Schedules, the Adam step with a bf16 first moment, the metrics, and the
slice as a whole: the JAX BrainTrainer and the port's, from the same
converted initial params, take the same 3 batches and must agree on every
step's loss and on the params after the last step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from algonauts2025_tpu.data.dataset import SegmentData as JaxSegmentData
from algonauts2025_tpu.models import FmriEncoderConfig as JaxFmriEncoderConfig
from algonauts2025_tpu.training import metrics as jax_metrics
from algonauts2025_tpu.training import optim as jax_optim
from algonauts2025_tpu.training import trainer as jax_trainer
from algonauts2025_tpu.training.losses import build_loss as jax_build_loss
from algonauts2025_tpu_torch.data import SegmentData
from algonauts2025_tpu_torch.models import FmriEncoderConfig, flax_params_to_torch
from algonauts2025_tpu_torch.training import metrics, optim, trainer
from algonauts2025_tpu_torch.training.losses import build_loss, pearson_loss

OPTIM = {
    "optimizer": {"name": "Adam", "lr": 1e-4,
                  "kwargs": {"weight_decay": 0.0, "mu_dtype": "bfloat16"}},
    "scheduler": {"name": "OneCycleLR", "kwargs": {"max_lr": 1e-4, "pct_start": 0.1}},
}


@pytest.mark.parametrize("total,swa_start", [(40, None), (40, 24), (4, 2), (3, None)])
def test_schedules_match_jax(total, swa_start):
    cfg = {**OPTIM, "scheduler": {"name": "OneCycleLR",
                                  "kwargs": {"max_lr": 1e-3, "pct_start": 0.3}}}
    _, ref = jax_optim.OptimConfig(**cfg).build(total, swa_start_step=swa_start, swa_lr=2e-5)
    _, sched = optim.OptimConfig(**cfg).build(
        [torch.zeros(1, requires_grad=True)], total, swa_start_step=swa_start, swa_lr=2e-5
    )
    want = np.array([float(ref(jnp.int32(s))) for s in range(total + 3)])
    got = np.array([sched(s) for s in range(total + 3)])
    # the JAX schedule runs in fp32 (1 - cos near 0 keeps few digits), the
    # port's in Python floats
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_epoch_interval_schedule_matches_jax():
    cfg = {**OPTIM, "interval": "epoch"}
    _, ref = jax_optim.OptimConfig(**cfg).build(30, steps_per_epoch=6)
    _, sched = optim.OptimConfig(**cfg).build(
        [torch.zeros(1, requires_grad=True)], 30, steps_per_epoch=6
    )
    want = [float(ref(jnp.int32(s))) for s in range(32)]
    np.testing.assert_allclose([sched(s) for s in range(32)], want, rtol=1e-5)


@pytest.mark.parametrize("name,wd", [("Adam", 0.0), ("Adam", 0.01), ("AdamW", 0.01)])
def test_adam_bf16_mu_matches_optax(rng, name, wd):
    cfg = {"name": name, "lr": 1e-2, "kwargs": {"weight_decay": wd, "mu_dtype": "bfloat16"}}
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) for _ in range(4)]
    tx = jax_optim.OptimizerConfig(**cfg).build(1e-2)
    params = {"w": jnp.asarray(p0)}
    state = tx.init(params)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = optim.OptimizerConfig(**cfg).build([w])
    for g in grads:
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
        w.grad = torch.from_numpy(g)
        opt.step()
    assert opt.state[w]["mu"].dtype == torch.bfloat16
    # the same fp32 operations in the same order: last-ulp differences only
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]), atol=1e-7, rtol=1e-6)
    adam_state = next(
        s for s in jax.tree.leaves(state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)
    )
    mu_ref = np.asarray(adam_state.mu["w"].astype(jnp.float32))
    np.testing.assert_array_equal(opt.state[w]["mu"].float().numpy(), mu_ref)


def test_optimizer_round_trips_mu_dtype():
    w = torch.nn.Parameter(torch.ones(3))
    opt = optim.OptimizerConfig(name="Adam", lr=0.1, kwargs={"mu_dtype": "bfloat16"}).build([w])
    w.grad = torch.full((3,), 0.5)
    opt.step()
    fresh = optim.OptimizerConfig(name="Adam", lr=0.1, kwargs={"mu_dtype": "bfloat16"}).build([w])
    fresh.load_state_dict(opt.state_dict())
    assert fresh.state[w]["mu"].dtype == torch.bfloat16 and fresh.count == 1


def test_unported_optimizer_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optim.OptimizerConfig(name="SGD", lr=0.1).build([torch.nn.Parameter(torch.ones(1))])


def _preds(rng, n=40, d=6):
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def test_pearson_corr_matches_jax(rng):
    from algonauts2025_tpu.ops.pearson import pearson_corr as jax_pearson_corr
    from algonauts2025_tpu_torch.ops.pearson import pearson_corr

    p, t = _preds(rng)
    t[:, 0] = 1.0  # a constant column goes through eps
    np.testing.assert_allclose(pearson_corr(torch.from_numpy(p), torch.from_numpy(t)).numpy(),
                               np.asarray(jax_pearson_corr(jnp.asarray(p), jnp.asarray(t))),
                               atol=1e-6)


def test_pearson_metric_matches_jax(rng):
    ref, port = jax_metrics.MultidimPearsonCorrCoef(), metrics.MultidimPearsonCorrCoef()
    for _ in range(3):
        p, t = _preds(rng)
        ref.update(jnp.asarray(p), jnp.asarray(t))
        port.update(torch.from_numpy(p), torch.from_numpy(t))
    np.testing.assert_allclose(port.compute(), ref.compute(), atol=1e-6)
    np.testing.assert_allclose(port.per_voxel(), ref.per_voxel(), atol=1e-6)


def test_grouped_pearson_matches_jax(rng):
    ref, port = jax_metrics.GroupedPearson(n_groups=4), metrics.GroupedPearson(n_groups=4)
    for i in range(2):
        p, t = _preds(rng)
        groups = rng.integers(0, 3, size=40)
        if i == 0:
            groups[-1] = 3  # group 3 gets a single row: NaN by design
        ref.update(jnp.asarray(p), jnp.asarray(t), groups=jnp.asarray(groups))
        port.update(torch.from_numpy(p), torch.from_numpy(t), groups=torch.from_numpy(groups))
    with pytest.warns(RuntimeWarning):
        want = ref.compute()
    with pytest.warns(RuntimeWarning, match="group 3"):
        got = port.compute()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6)
    port.update(*(torch.from_numpy(x) for x in _preds(rng, n=2)), groups=torch.tensor([0, 9]))
    with pytest.raises(ValueError, match="outside"):
        port.compute()


def test_topk_and_rank_match_jax(rng):
    x = rng.standard_normal((12, 8)).astype(np.float32)
    y = x + 0.8 * rng.standard_normal((12, 8)).astype(np.float32)
    y[3] = y[5]  # a tie
    for ref, port in [(jax_metrics.TopkAcc(topk=2), metrics.TopkAcc(topk=2)),
                      (jax_metrics.Rank(relative=True), metrics.Rank(relative=True))]:
        ref.update(jnp.asarray(x), jnp.asarray(y))
        port.update(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(port.compute(), ref.compute(), atol=1e-6)


def test_grouped_topk_matches_jax(rng):
    cfg = {"log_name": "g", "name": "GroupedMetric", "metric_name": "TopkAcc",
           "kwargs": {"topk": 2}}
    ref = jax_metrics.build_metric(cfg, n_groups=3)
    port = metrics.build_metric(cfg, n_groups=3)
    x = rng.standard_normal((12, 8)).astype(np.float32)
    y = x + rng.standard_normal((12, 8)).astype(np.float32)
    groups = rng.integers(0, 3, size=12)
    ref.update(jnp.asarray(x), jnp.asarray(y), groups=jnp.asarray(groups))
    port.update(torch.from_numpy(x), torch.from_numpy(y), groups=torch.from_numpy(groups))
    assert port.compute() == pytest.approx(ref.compute())


def test_build_metric_defaults():
    """The three metrics of the default grid config."""
    cfgs = [
        {"log_name": "pearson", "name": "MultidimPearsonCorrCoef", "kwargs": {"num_outputs": 6}},
        {"log_name": "subj_pearson", "name": "GroupedMetric",
         "metric_name": "MultidimPearsonCorrCoef", "kwargs": {"num_outputs": 6}},
        {"log_name": "retrieval_top1", "name": "TopkAcc", "topk": 1},
    ]
    built = [metrics.build_metric(c, n_groups=4) for c in cfgs]
    assert isinstance(built[0], metrics.MultidimPearsonCorrCoef)
    assert isinstance(built[1], metrics.GroupedPearson) and built[1].n_groups == 4
    assert isinstance(built[2], metrics.TopkAcc) and built[2].topk == 1


def test_pearson_loss_matches_jax(rng):
    from algonauts2025_tpu.training.losses import pearson_loss as jax_pearson_loss

    p, t = _preds(rng)
    np.testing.assert_allclose(
        pearson_loss(torch.from_numpy(p), torch.from_numpy(t)).item(),
        float(jax_pearson_loss(jnp.asarray(p), jnp.asarray(t))), atol=1e-6,
    )
    assert build_loss({"name": "PearsonLoss"})(torch.from_numpy(p), torch.from_numpy(t)).ndim == 0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_loss({"name": "HuberLoss"})


# -- the slice as a whole ----------------------------------------------------

FEATURE_DIMS = {"text": (2, 12), "audio": (2, 4), "video": (2, 10)}
MODEL = dict(n_subjects=3, hidden=48, depth=2, heads=4, modality_dropout=0.0, remat=True,
             contrastive_enabled=True, contrastive_modalities=["video"])


def _batches(rng, n, b=4, t=13, n_out=9, n_tr=5):
    out = []
    for _ in range(n):
        data = {m: rng.standard_normal((b, n_layers, d, t)).astype(np.float32)
                for m, (n_layers, d) in FEATURE_DIMS.items()}
        data["subject_id"] = rng.integers(0, 3, size=(b, 1))
        data["fmri"] = rng.standard_normal((b, n_out, n_tr)).astype(np.float32)
        out.append(data)
    return out


def test_three_steps_match_jax_trainer(rng):
    batches = _batches(rng, 3)
    tcfg = dict(n_epochs=1, folder=None, save_checkpoints=False, seed=0, contrastive_weight=0.1)

    jax_model = JaxFmriEncoderConfig(**MODEL).build(FEATURE_DIMS, n_outputs=9, n_output_timesteps=5)
    ref = jax_trainer.BrainTrainer(
        jax_model, jax_build_loss({"name": "MSELoss"}), jax_optim.OptimConfig(**OPTIM), {},
        jax_trainer.TrainerConfig(**tcfg),
    )
    ref.init_state(JaxSegmentData(data=batches[0], segments=[None] * 4), total_steps=3)
    init_params = jax.tree.map(np.asarray, ref.state.params)
    ref._build_steps()
    key = jax.random.PRNGKey(1)
    ref_losses = []
    state = ref.state
    for data in batches:
        state, loss, _ = ref._train_step(state, {k: jnp.asarray(v) for k, v in data.items()}, key)
        ref_losses.append(float(loss))

    port = trainer.BrainTrainer(
        FmriEncoderConfig(**MODEL).build(FEATURE_DIMS, n_outputs=9, n_output_timesteps=5),
        build_loss({"name": "MSELoss"}), optim.OptimConfig(**OPTIM), {},
        trainer.TrainerConfig(**tcfg), device="cpu",
    )
    port.init_state(SegmentData(data=batches[0], segments=[None] * 4), total_steps=3)
    port.model.load_state_dict(flax_params_to_torch(init_params), strict=True)
    losses = [port.train_step({k: torch.from_numpy(v) for k, v in d.items()})[0].item()
              for d in batches]

    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    want = flax_params_to_torch(jax.tree.map(np.asarray, state.params))
    for name, p in port.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5, err_msg=name)


def test_fit_writes_checkpoints_and_resumes(rng, tmp_path):
    batches = [SegmentData(data=d, segments=[None] * 4) for d in _batches(rng, 2)]
    val = [SegmentData(data=d, segments=[None] * 4) for d in _batches(rng, 1)]
    metric_cfg = {"log_name": "pearson", "name": "MultidimPearsonCorrCoef"}

    def make(n_epochs):
        return trainer.BrainTrainer(
            FmriEncoderConfig(**MODEL).build(FEATURE_DIMS, n_outputs=9, n_output_timesteps=5),
            build_loss({"name": "MSELoss"}), optim.OptimConfig(**OPTIM),
            {"val/pearson": metrics.build_metric(metric_cfg)},
            trainer.TrainerConfig(n_epochs=n_epochs, folder=tmp_path, seed=0, swa_start=0.5,
                                  contrastive_weight=0.1),
            device="cpu",
        )

    first = make(2)
    first.init_state(batches[0], total_steps=4)
    first.fit(lambda epoch: batches, lambda: val)
    assert (tmp_path / "best.ckpt").is_file() and (tmp_path / "last.ckpt").is_file()
    assert len(first.history) == 2 and first.step == 4
    assert np.isfinite(first.history[-1]["val/pearson"])

    resumed = make(3)
    resumed.init_state(batches[0], total_steps=6)
    start = resumed.load_checkpoint(tmp_path / "last.ckpt")
    assert start == 2 and resumed.step == 4 and resumed._swa_count == first._swa_count
    for name, p in resumed.model.state_dict().items():
        torch.testing.assert_close(p, first.model.state_dict()[name])
    assert resumed.optimizer.state_dict()["count"] == 4
    resumed.fit(lambda epoch: batches, lambda: val, start_epoch=start)
    assert resumed.step == 6 and len(resumed.history) == 1

    warm = make(1)
    warm.init_state(batches[0], total_steps=2)
    assert warm.load_checkpoint(tmp_path / "best.ckpt", params_only=True) == 0
    assert warm.step == 0 and warm.optimizer.count == 0
    preds = list(warm.predict(val))
    assert preds[0][0].shape == (4, 9, 5) and np.isfinite(preds[0][0]).all()
