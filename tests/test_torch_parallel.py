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
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mp
from algonauts2025_tpu.data.dataset import SegmentData as JaxSegmentData
from algonauts2025_tpu.models import FmriEncoderConfig as JaxFmriEncoderConfig
from algonauts2025_tpu.parallel import get_mesh as jax_get_mesh
from algonauts2025_tpu.parallel.sharding import param_spec as jax_param_spec
from algonauts2025_tpu.parallel.sharding import sharding_report as jax_sharding_report
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

#: the JAX test's trunk (tests/test_parallel.py::_setup)
CFG = {
    "model": dict(n_subjects=4, hidden=96, depth=1, heads=4),
    "dims": {"text": (2, 16), "audio": (2, 12)},
    "n_out": 32,
    "n_tr": 10,
}


def _jax_trainer(cfg, b, n_epochs=2, loss="MSELoss"):
    model = JaxFmriEncoderConfig(**cfg["model"]).build(cfg["dims"], n_outputs=cfg["n_out"],
                                                       n_output_timesteps=cfg["n_tr"])
    return JaxBrainTrainer(
        model=model,
        loss_fn=jax_build_loss({"name": loss}),
        optim_config=JaxOptimConfig(optimizer={"name": "Adam", "lr": 1e-3}),
        metrics={"val/pearson": jax_build_metric({"log_name": "pearson",
                                                  "name": "MultidimPearsonCorrCoef"})},
        config=JaxTrainerConfig(n_epochs=n_epochs, folder=None, save_checkpoints=False, seed=0),
    )


def _jax_init(cfg, batch, total_steps, n_epochs=2):
    """A JAX trainer initialised on ``batch``, and its weights as the port's
    full state dict."""
    ref = _jax_trainer(cfg, len(batch["fmri"]), n_epochs)
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


def test_whole_param_optimizers_refuse_tensor_parallelism():
    """Adafactor and LAMB reduce over whole parameters; a tp rank holds a
    slice, so the trainer refuses them with model_parallel > 1."""
    out = torch_mp.spawn(torch_mp.refused_optimizer, 2, CFG, "LAMB")
    assert all("LAMB reduces over whole parameters" in msg for msg in out)


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
