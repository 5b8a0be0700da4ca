"""The port's data and tensor parallelism against the JAX package's, on the
CPU: the twins of tests/test_parallel.py.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port's mesh is a world of gloo processes (``torch_mp.spawn``: the spawn
start method, a free port, a 120 s deadline).  Every layout starts from
the JAX trainer's initial weights (``models.convert`` for the full state
dict, ``parallel.sharding.shard_state_dict`` for a rank's part).
Tolerances: a mesh step against the one-device port step at rel 1e-5 on
the loss and atol 1e-5 on the params (fp32 reassociation of the gathers
and the gradient mean); the port against the JAX trainer at the trunk's
rtol 1e-4 / atol 1e-5 (tests/test_torch_training.py); the tiny video
backbone split over "data" against one device at atol 1e-5 and against
JAX at the backbone's atol 3e-4, rtol 1e-3 (tests/test_torch_video.py).
Adafactor and LAMB under tensor parallelism: three mesh steps against the
one-device port as above, and against the JAX trainer on
``get_mesh(8, model_parallel=2)`` at atol 1e-5; their rules over the
slices of a model group of threads against the whole parameter at atol
1e-6.
"""

import functools
import logging
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mp
from algonauts2025_tpu.data.dataset import SegmentData as JaxSegmentData
from algonauts2025_tpu.models import FmriEncoderConfig as JaxFmriEncoderConfig
from algonauts2025_tpu.parallel import get_mesh as jax_get_mesh
from algonauts2025_tpu.parallel import shard_batch as jax_shard_batch
from algonauts2025_tpu.parallel.sharding import param_spec as jax_param_spec
from algonauts2025_tpu.parallel.sharding import sharding_report as jax_sharding_report
from algonauts2025_tpu.parallel.sharding import state_shardings as jax_state_shardings
from algonauts2025_tpu.training import BrainTrainer as JaxBrainTrainer
from algonauts2025_tpu.training import OptimConfig as JaxOptimConfig
from algonauts2025_tpu.training import TrainerConfig as JaxTrainerConfig
from algonauts2025_tpu.training import build_loss as jax_build_loss
from algonauts2025_tpu.training import build_metric as jax_build_metric
from algonauts2025_tpu_torch.models import flax_params_to_torch
from algonauts2025_tpu_torch.models import convert
from algonauts2025_tpu_torch.parallel import local_mesh
from algonauts2025_tpu_torch.parallel.sharding import (
    param_spec, sharding_report, shard_tensor, state_shardings, unshard_tensor,
)
from algonauts2025_tpu_torch.training import optim

#: the JAX test's trunk (tests/test_parallel.py::_setup)
CFG = {
    "model": dict(n_subjects=4, hidden=96, depth=1, heads=4),
    "dims": {"text": (2, 16), "audio": (2, 12)},
    "n_out": 32,
    "n_tr": 10,
}


def _jax_trainer(cfg, b, n_epochs=2, loss="MSELoss", mesh=None):
    model = JaxFmriEncoderConfig(**cfg["model"]).build(cfg["dims"], n_outputs=cfg["n_out"],
                                                       n_output_timesteps=cfg["n_tr"])
    return JaxBrainTrainer(
        model=model,
        loss_fn=jax_build_loss({"name": loss}),
        optim_config=JaxOptimConfig(optimizer={"name": cfg.get("optimizer", "Adam"),
                                               "lr": cfg.get("lr", 1e-3)}),
        metrics={"val/pearson": jax_build_metric({"log_name": "pearson",
                                                  "name": "MultidimPearsonCorrCoef"})},
        config=JaxTrainerConfig(n_epochs=n_epochs, folder=None, save_checkpoints=False, seed=0),
        mesh=mesh,
    )


def _jax_init(cfg, batch, total_steps, n_epochs=2, mesh=None):
    """A JAX trainer initialised on ``batch``, and its weights as the port's
    full state dict."""
    ref = _jax_trainer(cfg, len(batch["fmri"]), n_epochs, mesh=mesh)
    data = JaxSegmentData(data=batch, segments=[None] * len(batch["fmri"]))
    ref.init_state(data, total_steps=total_steps)
    full = flax_params_to_torch(jax.tree.map(np.asarray, ref.state.params))
    return ref, data, full


@pytest.mark.parametrize("world,model_parallel", [(4, 1), (4, 2)])
def test_mesh_training(world, model_parallel, tmp_path):
    """dp4 and dp2 x tp2 meshes of gloo processes train two epochs from
    the JAX weights: the readout (and FF and qkv) split over "model", the
    history equals the JAX one-device fit's, and the checkpoint rank 0
    writes holds the full tensors, which load into a one-device trainer
    as the mesh's final (SWA) weights."""
    batch = torch_mp.make_batch(CFG, b=2 * (world // model_parallel))
    ref, jdata, full = _jax_init(CFG, batch, total_steps=4)
    ref.fit(lambda e: iter([jdata]), lambda: iter([jdata]))

    out = torch_mp.spawn(torch_mp.fit_on_mesh, world, model_parallel, CFG, full, batch,
                         str(tmp_path))
    for rank_out in out:
        shapes = rank_out["shapes"]
        assert shapes["predictor.weights"] == (4, 96, 32 // model_parallel)
        assert shapes["encoder.blocks.0.attn.qkv.weight"] == (3 * 96 // model_parallel, 96)
        for got, want in zip(rank_out["history"], ref.history):
            assert got["train/loss"] == pytest.approx(want["train/loss"], rel=1e-4)
            assert got["val/pearson"] == pytest.approx(want["val/pearson"], abs=1e-5)
        np.testing.assert_array_equal(rank_out["preds"], out[0]["preds"])

    single = torch_mp._trainer(CFG, None)
    single.init_state(None, total_steps=4)
    assert single.load_checkpoint(tmp_path / "last.ckpt") == 2
    for name, p in single.model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), out[0]["params"][name], err_msg=name)


def _flagship_params():
    """Port-named parameters at the flagship shapes (3072-d trunk, 8 layers,
    1000-parcel readouts), on the meta device, and the JAX test's tree."""
    jax_tree = {
        "predictor": {"weights": jnp.zeros((4, 3072, 1000)), "bias": jnp.zeros((4, 1000))},
        "blocks": {
            "ff": {"in": {"kernel": jnp.zeros((8, 3072, 12288))},
                   "out": {"kernel": jnp.zeros((8, 12288, 3072))}},
            "qkv": {"kernel": jnp.zeros((8, 3072, 9216))},
        },
        "time_pos_embed": jnp.zeros((1, 1024, 3072)),
    }
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    port = {"predictor.weights": meta(4, 3072, 1000), "predictor.bias": meta(4, 1000),
            "time_pos_embed": meta(1, 1024, 3072)}
    for i in range(8):
        port[f"encoder.blocks.{i}.ff.fc1.weight"] = meta(12288, 3072)
        port[f"encoder.blocks.{i}.ff.fc2.weight"] = meta(3072, 12288)
        port[f"encoder.blocks.{i}.attn.qkv.weight"] = meta(9216, 3072)
    return jax_tree, port


def test_tp_engages_on_flagship_shapes(caplog):
    """At the flagship shapes tp=2 splits the majority of the elements, as
    many as the JAX rules split; a readout that does not divide the model
    axis replicates LOUDLY."""
    jax_tree, port = _flagship_params()
    report = sharding_report(port, 2)
    total = report["sharded"] + report["replicated"]
    assert report["sharded"] / total > 0.9, report
    assert report == jax_sharding_report(jax_tree, jax_get_mesh(n_devices=8, model_parallel=2))

    bad = {"predictor.weights": torch.empty((4, 3072, 999), device="meta")}
    with caplog.at_level(logging.WARNING, logger="algonauts2025_tpu_torch.parallel.sharding"):
        report = sharding_report(bad, 2)
    assert report["sharded"] == 0
    assert any("does not divide model" in r.message for r in caplog.records)


def test_param_spec_splits_what_jax_splits():
    """On a JAX trunk's own param tree, mapped to the port's names by
    models.convert: the port splits the same parameters on the same axes
    (a flax (in, out) kernel's axis is the other one of the torch weight),
    plus fc1's bias, which a rank's fc1 rows need."""
    batch = torch_mp.make_batch(CFG, b=2)
    ref, _, _ = _jax_init(CFG, batch, total_steps=2)
    n_split = 0
    for path, value in convert._flatten(jax.tree.map(np.asarray, ref.state.params)):
        spec = list(jax_param_spec("/".join(path), value.shape, 2))
        for sub, one in convert._unstack(path, value):
            name, weight = convert._convert_leaf(sub, one)
            axes = spec[value.ndim - one.ndim:]  # the axes left after unstacking
            dim = next((a for a, axis in enumerate(axes) if axis is not None), None)
            if dim is not None and path[-1] == "kernel":
                dim = one.ndim - 1 - dim  # a flax (in, out) kernel is a torch (out, in) weight
            want = 0 if name.endswith("ff.fc1.bias") else dim
            assert param_spec(name, weight.shape, 2) == want, name
            n_split += want is not None
    assert n_split == 7  # qkv, out, fc1's weight and bias, fc2, the readout's weights and bias


def test_qkv_splits_by_whole_heads():
    """T2: a rank's qkv rows are h/tp whole heads of each of q, k and v (the
    rows are (3, heads, head dim)); a contiguous split would hand rank 0
    all of q and half of k."""
    h, dh, d = 4, 3, 5
    full = torch.arange(3 * h * dh * d, dtype=torch.float32).reshape(3 * h * dh, d)
    heads = full.view(3, h, dh, d)
    name = "encoder.blocks.0.attn.qkv.weight"
    parts = [shard_tensor(name, full, 0, r, 2) for r in range(2)]
    for r, part in enumerate(parts):
        torch.testing.assert_close(part.view(3, h // 2, dh, d), heads[:, r * 2 : (r + 1) * 2])
    torch.testing.assert_close(unshard_tensor(name, parts, 0), full)
    assert not torch.equal(parts[0], full.chunk(2)[0])


STEP_CASES = {
    # the JAX test's step: MSE
    "mse": dict(CFG),
    # T1 and T3: InfoNCE over the global rows, PearsonLoss over the global
    # (b t) rows, modality dropout drawn alike on every rank
    "infonce_pearson_dropout": dict(
        CFG, loss="PearsonLoss", contrastive_weight=0.1,
        model=dict(CFG["model"], modality_dropout=0.5, contrastive_enabled=True,
                   contrastive_modalities=["text", "audio"]),
    ),
}


def _one_device_step(cfg, full, batch):
    single = torch_mp._trainer(cfg, None)
    single.init_state(None, total_steps=2)
    single.model.load_state_dict(full)
    loss, aux = single.train_step({k: torch.from_numpy(v) for k, v in batch.items()})
    return loss.item(), {k: v.item() for k, v in aux.items()}, single.model.state_dict()


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_dp_matches_single_device(case):
    """One step over a dp4 mesh == the same step on one device (loss, the
    InfoNCE losses and every updated param); the MSE step also equals the
    JAX one-device step from the same weights."""
    cfg = STEP_CASES[case]
    batch = torch_mp.make_batch(cfg, b=8, seed=1)
    ref, jdata, full = _jax_init(cfg, batch, total_steps=2)
    loss, aux, params = _one_device_step(cfg, full, batch)
    out = torch_mp.spawn(torch_mp.one_step, 4, 1, cfg, full, batch)
    for rank_out in out:
        assert rank_out["loss"] == pytest.approx(loss, rel=1e-5)
        assert rank_out["aux"].keys() == aux.keys()
        for key, value in aux.items():
            assert rank_out["aux"][key] == pytest.approx(value, rel=1e-5)
        for name, p in params.items():
            np.testing.assert_allclose(rank_out["params"][name], p.numpy(), atol=1e-5,
                                       err_msg=name)
    if case == "mse":
        ref._build_steps()
        state, jloss, _ = ref._train_step(ref.state, {k: jnp.asarray(v) for k, v in batch.items()},
                                          jax.random.PRNGKey(1))
        assert out[0]["loss"] == pytest.approx(float(jloss), rel=1e-4)
        np.testing.assert_allclose(out[0]["params"]["time_pos_embed"],
                                   np.asarray(state.params["time_pos_embed"]), atol=1e-5)


@pytest.mark.parametrize("contiguous", [False, True])
def test_tp_step_matches_single_device(contiguous):
    """dp1 x tp2 (and dp2 x tp2): one step equals the one-device step with
    q, k and v split by whole heads; the contiguous split of T2 does not."""
    cfg = STEP_CASES["infonce_pearson_dropout"]
    batch = torch_mp.make_batch(cfg, b=4, seed=2)
    _, _, full = _jax_init(cfg, batch, total_steps=2)
    loss, aux, params = _one_device_step(cfg, full, batch)
    world = 2 if contiguous else 4
    out = torch_mp.spawn(torch_mp.one_step, world, 2, cfg, full, batch, contiguous)
    if contiguous:  # the same check fails
        for rank_out in out:
            assert rank_out["loss"] != pytest.approx(loss, rel=1e-5)
            assert rank_out["aux"]["text"] != pytest.approx(aux["text"], rel=1e-5)
        return
    for rank_out in out:
        assert rank_out["loss"] == pytest.approx(loss, rel=1e-5)
        for name, p in params.items():
            np.testing.assert_allclose(rank_out["params"][name], p.numpy(), atol=1e-5,
                                       err_msg=name)


#: a trunk whose split weights Adafactor factors (both dims >= 128 of the
#: whole weight): qkv (576, 192) and fc2 split on their larger dim; the
#: square attn.out on the dim a tie puts first, so its (192, 96) slice
#: would factor the other way; the readout (4, 192, 128) on its smaller
#: factored dim, so its 64-wide slice would not factor at all
TP_CFG = dict(CFG, model=dict(CFG["model"], hidden=192), n_out=128)
TP_LAYOUTS = {"dp1xtp2": 2, "dp2xtp2": 4}


@functools.lru_cache(maxsize=None)
def _tp_case(optimizer):
    """The JAX trainer on ``get_mesh(8, model_parallel=2)`` with
    ``optimizer``, its initial weights as the port's full state dict, three
    batches, and the JAX mesh's and the one-device port's three steps."""
    cfg = dict(TP_CFG, optimizer=optimizer)
    batches = [torch_mp.make_batch(cfg, b=4, seed=seed) for seed in (3, 4, 5)]
    mesh = jax_get_mesh(n_devices=8, model_parallel=2)
    ref = _jax_trainer(cfg, 4, mesh=mesh)
    data = JaxSegmentData(data=batches[0], segments=[None] * 4)
    if optimizer == "Adafactor":
        # the JAX package's init lays each parameter's PartitionSpec onto
        # optax's factored moments too, by path, and fails on their ranks
        # (ROADMAP §3); here the params take their shardings and XLA lays
        # out the optimizer state from them
        with pytest.raises(ValueError, match="incompatible with its sharding"):
            ref.init_state(data, total_steps=3)
        ref.mesh = None
        ref.init_state(data, total_steps=3)
        params = jax.device_put(ref.state.params, jax_state_shardings(ref.state.params, mesh))
        ref.state = ref.state.replace(params=params, opt_state=jax.jit(ref.tx.init)(params))
    else:
        ref.init_state(data, total_steps=3)
    assert "model" in str(ref.state.params["predictor"]["weights"].sharding.spec)
    full = flax_params_to_torch(jax.tree.map(np.asarray, ref.state.params))
    ref._build_steps()
    state = ref.state
    for batch in batches:
        state, _, _ = ref._train_step(state, jax_shard_batch(batch, mesh), jax.random.PRNGKey(1))
    jax_params = flax_params_to_torch(jax.tree.map(np.asarray, state.params))

    single = torch_mp._trainer(cfg, None)
    single.init_state(None, total_steps=3)
    single.model.load_state_dict(full)
    losses = [single.train_step({k: torch.from_numpy(v) for k, v in b.items()})[0].item()
              for b in batches]
    opt_state = {i: {k: v.numpy() for k, v in st.items()}
                 for i, st in single.optimizer.state_dict()["state"].items()}
    params = {k: v.numpy() for k, v in single.model.state_dict().items()}
    return cfg, full, batches, jax_params, (losses, params, opt_state)


TP_OPTIMIZERS = ["Adafactor", "LAMB"]


@functools.lru_cache(maxsize=None)
def _tp_run(layout):
    """Both optimizers' three steps on the ``layout`` mesh, in one world of
    gloo processes: {optimizer: every rank's result}."""
    runs = [_tp_case(name)[:3] for name in TP_OPTIMIZERS]
    out = torch_mp.spawn(torch_mp.train_steps, TP_LAYOUTS[layout], 2, runs)
    return {name: [rank_out[i] for rank_out in out] for i, name in enumerate(TP_OPTIMIZERS)}


@pytest.mark.parametrize("layout", list(TP_LAYOUTS))
@pytest.mark.parametrize("optimizer", TP_OPTIMIZERS)
def test_tp_whole_param_optimizers_match_single_device(optimizer, layout):
    """Adafactor and LAMB reduce over whole parameters; under dp1 x tp2 and
    dp2 x tp2 a rank sums its slice's statistics over the model group, so
    three steps equal the one-device port's (losses at rel 1e-5, params at
    atol 1e-5) and the checkpoint's full optimizer state (the factored
    moments too) equals the one-device state (rtol 1e-4, atol 1e-5 of the
    state's largest magnitude: gradient moments summed in another order)."""
    _, _, _, _, (losses, params, opt_state) = _tp_case(optimizer)
    for rank_out in _tp_run(layout)[optimizer]:
        assert rank_out["losses"] == pytest.approx(losses, rel=1e-5)
        for name, p in params.items():
            np.testing.assert_allclose(rank_out["params"][name], p, atol=1e-5, err_msg=name)
        assert rank_out["opt_state"].keys() == opt_state.keys()
        for index, state in opt_state.items():
            assert rank_out["opt_state"][index].keys() == state.keys()
            for key, value in state.items():
                np.testing.assert_allclose(rank_out["opt_state"][index][key], value, rtol=1e-4,
                                           atol=1e-5 * np.abs(value).max(),
                                           err_msg=f"{index}.{key}")
    if optimizer == "Adafactor":  # the factored moments of the split weights are there
        assert any("v_row" in state for state in opt_state.values())


@pytest.mark.parametrize("optimizer", TP_OPTIMIZERS)
def test_jax_mesh_whole_param_optimizers_match_port_tp(optimizer):
    """The reference does what the port now does: the JAX trainer on
    ``get_mesh(8, model_parallel=2)`` (dp4 x tp2, optax over global arrays
    under NamedSharding) trains three steps from the same weights to the
    port's dp2 x tp2 params (atol 1e-5)."""
    _, _, _, jax_params, _ = _tp_case(optimizer)
    got = _tp_run("dp2xtp2")[optimizer][0]["params"]
    assert got.keys() == jax_params.keys()
    for name, p in jax_params.items():
        np.testing.assert_allclose(got[name], p.numpy(), atol=1e-5, err_msg=name)


class _ThreadGroup:
    """A model group of ``n`` threads in one process: a rank's
    ``sum_over_group`` adds every rank's list, and each call is counted."""

    def __init__(self, n):
        self.barrier = threading.Barrier(n)
        self.lists = [None] * n
        self.calls = 0

    def sum_over_group(self, rank):
        def add(parts):
            self.lists[rank] = parts
            self.barrier.wait()
            out = [sum(lst[i] for lst in self.lists).clone() for i in range(len(parts))]
            if rank == 0:
                self.calls += 1
            self.barrier.wait()
            return out

        return add


def _optimizer_steps(name, params, grads, shards=None, sum_over_group=None):
    """``optim.OptaxRule`` ``name`` over ``params``, one step a list of
    gradients (the parameters' slices and their ``Shard`` under tensor
    parallelism)."""
    params = [torch.nn.Parameter(p.clone()) for p in params]
    opt = optim.OptaxRule(params, name, lr=1e-2, weight_decay=0.01)
    if shards is not None:
        opt.set_shards({p: shards for p in params}, sum_over_group)
    for step_grads in grads:
        for p, g in zip(params, step_grads):
            p.grad = g
        opt.step()
    return [p.detach() for p in params]


@pytest.mark.parametrize("name", ["Adafactor", "LAMB"])
@pytest.mark.parametrize("shape,dim,adafactor_calls", [
    ((256, 128), 0, 2),  # the (128, 128) slice factors its dims the other way round
    ((4, 192, 128), 2, 2),  # the 64-wide slice is under 128: it would not factor
    ((300, 200), 1, 2),  # the split dim is the smaller factored one
    ((576, 192), 0, 2),  # the split dim is the larger factored one
    ((8, 256, 128), 0, 1),  # split along a dim that is not factored
    ((64,), 0, 1),  # not factored at all
])
def test_split_rule_reads_the_whole_parameter(name, shape, dim, adafactor_calls):
    """Two parameters, each split over a model group of two threads, three
    steps: the slices' updates, their partial sums added across the group,
    are the whole parameters' (atol 1e-6); each slice on its own is not.
    A step makes one collective a stage for both parameters (Adafactor: the
    statistics, where a factored dim is split, then the squared sums; LAMB:
    the squared sums).  ``_factored_dims`` reads the whole shape."""
    gen = torch.Generator().manual_seed(0)
    whole = [torch.randn(shape, generator=gen) for _ in range(2)]
    grads = [[0.1 * torch.randn(shape, generator=gen) for _ in range(2)] for _ in range(3)]
    want = _optimizer_steps(name, whole, grads)

    group, got = _ThreadGroup(2), [None, None]

    def rank(r):
        got[r] = _optimizer_steps(name, [p.chunk(2, dim)[r] for p in whole],
                                  [[g.chunk(2, dim)[r] for g in gs] for gs in grads],
                                  optim.Shard(dim, shape), group.sum_over_group(r))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert got[0] is not None and got[1] is not None
    alone = [_optimizer_steps(name, [p.chunk(2, dim)[r] for p in whole],
                              [[g.chunk(2, dim)[r] for g in gs] for gs in grads])
             for r in range(2)]
    for i, p in enumerate(want):
        torch.testing.assert_close(torch.cat([got[0][i], got[1][i]], dim), p, rtol=0, atol=1e-6)
        assert (torch.cat([alone[0][i], alone[1][i]], dim) - p).abs().max() > 1e-5
    assert group.calls == 3 * (adafactor_calls if name == "Adafactor" else 1)


@pytest.mark.parametrize("name", ["Adafactor", "LAMB"])
def test_replicated_params_take_the_unsplit_rule(name):
    """Beside split parameters, a replicated one steps bit for bit as with
    no shards at all (the unsplit rule, no collective)."""
    gen = torch.Generator().manual_seed(1)
    replicated = torch.randn(192, 160, generator=gen)
    split = torch.randn(128, 160, generator=gen)
    grads = [[0.1 * torch.randn(192, 160, generator=gen), 0.1 * torch.randn(128, 160, generator=gen)]
             for _ in range(3)]
    alone = _optimizer_steps(name, [replicated], [[g[0]] for g in grads])[0]
    params = [torch.nn.Parameter(replicated.clone()), torch.nn.Parameter(split.clone())]
    opt = optim.OptaxRule(params, name, lr=1e-2, weight_decay=0.01)
    opt.set_shards({params[1]: optim.Shard(0, (256, 160))}, lambda parts: parts)
    for step_grads in grads:
        for p, g in zip(params, step_grads):
            p.grad = g
        opt.step()
    assert torch.equal(params[0].detach(), alone)


def test_factored_dims_read_the_whole_shape():
    """A rank's Adafactor factors its slice by the whole parameter's dims:
    the (4, 192, 64) slice of a (4, 192, 128) readout split on its last dim
    keeps factored moments (v_row without d0 = 1, v_col without d1 = 2),
    where the slice's own shape (64 < 128) factors nothing; the (128, 128)
    slice of a (256, 128) weight split on dim 0 averages v_row over dim 0,
    where its own shape's tie would put d0 on dim 1."""
    assert optim._factored_dims((4, 192, 128)) == (2, 1)
    assert optim._factored_dims((4, 192, 64)) is None
    assert optim._factored_dims((256, 128)) == (1, 0)
    assert optim._factored_dims((128, 128)) == (0, 1)
    for shape, dim, v_row, v_col in [((4, 192, 128), 2, (4, 64), (4, 192)),
                                     ((256, 128), 0, (128,), (128,))]:
        part = torch.nn.Parameter(torch.ones(shape).chunk(2, dim)[0].clone())
        opt = optim.OptaxRule([part], "Adafactor", lr=1e-2)
        opt.set_shards({part: optim.Shard(dim, shape)}, lambda parts: parts)
        part.grad = torch.arange(part.numel(), dtype=torch.float32).view_as(part)
        opt.step()
        state = opt.state[part]
        assert "v" not in state
        assert tuple(state["v_row"].shape) == v_row and tuple(state["v_col"].shape) == v_col
        # v_row is the whole parameter's mean over d0: on dim 0 of the
        # (256, 128) weight a sum over the group (here the slice's) / 256
        if shape == (256, 128):
            torch.testing.assert_close(state["v_row"], (part.grad**2 + 1e-30).sum(0) / 256)
        assert opt.state_split_dim(part, "v_row") == (1 if dim == 2 else None)
        assert opt.state_split_dim(part, "v_col") == (None if dim == 2 else 0)


def test_video_feature_extraction_shards_over_mesh():
    """Window batches split over the "data" devices: the outputs equal the
    one-device path's and the JAX sharded backbone's."""
    from algonauts2025_tpu.features.video import JaxVideoBackbone
    from algonauts2025_tpu.features.video import TinyVideoBackbone as JTiny
    from algonauts2025_tpu_torch.features.video import TinyVideoBackbone, TorchVideoBackbone
    from algonauts2025_tpu_torch.models import vjepa2_params_to_torch

    jsingle = JTiny(hidden_size=32, num_layers=2, n_frames=4, crop_size=32)
    jsharded = JaxVideoBackbone(jsingle.model, jsingle.params, n_frames=4, crop_size=32,
                                mesh=jax_get_mesh(n_devices=8, model_parallel=1))
    single = TinyVideoBackbone(hidden_size=32, num_layers=2, n_frames=4, crop_size=32,
                               state_dict=vjepa2_params_to_torch(jsingle.params), device="cpu")
    sharded = TorchVideoBackbone(single.model, n_frames=4, crop_size=32, device="cpu",
                                 mesh=local_mesh(8, "data", "cpu"))
    windows = np.random.default_rng(0).integers(0, 255, (8, 4, 32, 32, 3), dtype=np.uint8)
    got = sharded.encode_windows(windows)
    np.testing.assert_allclose(got, single.encode_windows(windows), atol=1e-5)
    np.testing.assert_allclose(got, jsharded.encode_windows(windows), atol=3e-4, rtol=1e-3)
    assert "data" in str(jsharded.encode_windows_async(windows).sharding.spec)


def test_experiment_over_two_processes(tmp_path):
    """``run_config`` under torchrun's environment in two processes
    (``n_devices=2``, gloo on the CPU): the Experiment trains over a dp2
    mesh (the eval tail batches, whose rows do not divide, replicated) and
    rank 0 alone writes the run's files, which equal those of the
    one-process run of the same config (the per-epoch losses and metrics at
    rel 1e-5, the artifacts at tests/test_torch_experiment.py's 1e-4)."""
    import json
    import os
    import subprocess
    import sys

    import pandas as pd

    from algonauts2025_tpu_torch.data.synthetic import make_synthetic_study
    from algonauts2025_tpu_torch.experiment import Experiment
    from test_torch_experiment import ARTIFACT_ATOL, _config

    study = make_synthetic_study(tmp_path / "data", with_video=False, n_parcels=16, duration=40.0)
    one = _config(tmp_path, study, "shared")  # also fills the feature caches
    Experiment(**one).run()
    two = dict(one, n_devices=2, infra={"folder": str(tmp_path / "run_two"), "mode": "force"})
    (tmp_path / "two.json").write_text(json.dumps(two, default=str))
    port = torch_mp.free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                   RANK=str(rank), LOCAL_RANK=str(rank),
                   PYTHONPATH=str(torch_mp.REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "algonauts2025_tpu_torch.grids.run_config",
             str(tmp_path / "two.json")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            out, err = p.communicate(timeout=torch_mp.TIMEOUT)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    run_one, run_two = tmp_path / "run_shared", tmp_path / "run_two"
    got, want = pd.read_csv(run_two / "metrics.csv"), pd.read_csv(run_one / "metrics.csv")
    assert list(got.columns) == list(want.columns)
    for column in want.columns:
        if column != "epoch_seconds":
            np.testing.assert_allclose(got[column], want[column], rtol=1e-5, err_msg=column)
    assert len((run_two / "metrics.jsonl").read_text().splitlines()) == 2  # one writer
    np.testing.assert_allclose(np.load(run_two / "pearson.npy"), np.load(run_one / "pearson.npy"),
                               atol=ARTIFACT_ATOL)
    sub = np.load(run_two / "submission.npy", allow_pickle=True).item()
    ref = np.load(run_one / "submission.npy", allow_pickle=True).item()
    assert sub.keys() == ref.keys()
    for subject, chunks in ref.items():
        for chunk, arr in chunks.items():
            np.testing.assert_allclose(sub[subject][chunk], arr, atol=ARTIFACT_ATOL)
