"""The plain references against the port at a tiny size on the CPU."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark.harness import Run, Tracer, load_module
from benchmark.reference import tribe_trunk, vjepa2_vitg_int8


def build(root, config: str, traffic: str, seed: int, **changes):
    cfg = json.loads((root / "configs" / f"{config}.json").read_text())
    for key, value in changes.items():
        cfg["brain_model_config"][key] = value
    tr = json.loads((root / "traffic" / f"{traffic}.json").read_text())
    run = Run(name="t", cell={}, config=cfg, traffic=tr, seed=seed, seconds=0.2, device=torch.device("cpu"))
    return load_module(root / "drivers" / f"{tr['driver']}.py").Driver(run)


@pytest.mark.parametrize("seed", [3, 2**31 + 17, 2**40 + 1])
def test_trunk_reference_follows_the_port(tiny, seed):
    driver = build(tiny, "tribe_trunk", "trunk_step", seed)
    driver.prepare()
    driver.window(0.2, Tracer(False))
    driver.release()
    gaps = driver.numbers()
    assert gaps["loss_gap"] < 2e-6 and gaps["grad_gap"] < 2e-6 and gaps["change_gap"] < 2e-5, gaps


def test_trunk_weights_are_the_ports_parameters(tiny):
    driver = build(tiny, "tribe_trunk", "trunk_step", 1)
    names = {name for name, _, _ in tribe_trunk.weight_spec(driver.run.config)}
    assert names == set(driver.trainer.model.state_dict())


@pytest.mark.parametrize("seed", [5, 11])
def test_dropout_draws_are_the_ports(tiny, seed):
    """With dropout on, the reference's draws give the port's losses."""
    driver = build(tiny, "tribe_trunk", "trunk_step", seed, modality_dropout=0.5)
    driver.prepare()
    assert any(any(tribe_trunk.dropout_draws(driver.run.config, seed, s)) for s in range(3))
    driver.release()
    assert driver.numbers()["loss_gap"] < 2e-6


def test_dropped_after_use_is_the_ports_fault(tiny):
    """The port's Adam skips a leaf without a gradient (a projector whose
    modality a step drops after an earlier step used it): the reference,
    as optax, moves it by its momentum.  The port's own Adam given zero
    gradients there (another path of the program) sides with the reference."""
    seed = 7  # drops text at steps 0 and 2
    assert [d[0] for d in (tribe_trunk.dropout_draws({"brain_model_config": {"modality_dropout": 0.3},
                                                       "feature_dims": {"a": 0, "b": 0, "c": 0}}, seed, s)
                           for s in range(3))] == [True, False, True]
    driver = build(tiny, "tribe_trunk", "trunk_step", seed, modality_dropout=0.3)
    driver.prepare()
    driver.release()
    assert driver.numbers()["change_gap"] > 0.1
    driver = build(tiny, "tribe_trunk", "trunk_step", seed, modality_dropout=0.3)
    opt = driver.trainer.optimizer
    step = opt.step

    def zero_filled():
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        step()

    opt.step = zero_filled
    driver.prepare()
    driver.release()
    assert driver.numbers()["change_gap"] < 2e-5


@pytest.mark.parametrize("seed", [5, 2**33 + 9])
def test_vitg_reference_follows_the_port(tiny, card_semantics, seed):
    """Every answer of a window against the reference: within the tiny
    model's quantisation noise (16 tokens a window pool little of it; a
    static scale may differ by a bf16 step of its absmax)."""
    driver = build(tiny, "vjepa2_vitg_int8", "video_windows", seed)
    driver.prepare()
    driver.window(0.2, Tracer(False))
    driver.release()
    assert driver.numbers()["state_gap"] < 2e-2


@pytest.mark.parametrize("seed", [5, 2**33 + 9])
def test_vitg_reference_is_the_ports_function(tiny, card_semantics, seed, monkeypatch):
    """Given the port's static scales, the reference computes the port's
    states to float rounding."""
    driver = build(tiny, "vjepa2_vitg_int8", "video_windows", seed)
    scales = {}
    names = {"attn.query": "attention.query", "attn.key": "attention.key", "attn.value": "attention.value",
             "attn.proj": "attention.proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for name, module in driver.backbone.model.named_modules():
        if hasattr(module, "a_scale"):
            _, i, rest = name.split(".", 2)
            scales[f"encoder.layer.{i}.{names[rest]}"] = float(module.a_scale)
    driver.prepare()
    assert driver.first_attention is None  # the warm-up batches are not taken
    driver.window(0.2, Tracer(False))
    driver.release()
    # the window's first batch, at the sampled tokens of each window
    assert driver.first_attention.shape == (driver.batch, len(driver.tokens), 128)
    calibrate = vjepa2_vitg_int8.Encoder.calibrate

    def port_scales(self, margin):
        calibrate(self, margin)
        self.a_scale = scales

    monkeypatch.setattr(vjepa2_vitg_int8.Encoder, "calibrate", port_scales)
    numbers = driver.numbers()
    assert numbers["state_gap"] < 1e-6 and numbers["first_attention_gap"] < 1e-6, numbers


def test_vitg_reference_calibrates_as_the_port(tiny):
    from algonauts2025_tpu_torch.features.video import load_video_backbone
    from algonauts2025_tpu_torch.models.backbones.vjepa2 import _QDense
    from benchmark.drivers import video_windows  # noqa: F401  (the HF keys)

    cfg = json.loads((tiny / "configs" / "vjepa2_vitg_int8.json").read_text())
    keys = load_module(tiny / "drivers" / "video_windows.py").HF_KEYS
    backbone = load_video_backbone(vjepa2_vitg_int8.make_weights(cfg, 3, "cpu"), {k: cfg[k] for k in keys},
                                   quantize=True, quant_static=True, device="cpu")
    encoder = vjepa2_vitg_int8.Encoder(cfg, vjepa2_vitg_int8.make_weights(cfg, 3, "cpu"))
    encoder.calibrate(cfg["calibration_margin"])
    names = {"attn.query": "attention.query", "attn.key": "attention.key", "attn.value": "attention.value",
             "attn.proj": "attention.proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for name, module in backbone.model.named_modules():
        if isinstance(module, _QDense):
            _, i, rest = name.split(".", 2)
            ref = f"encoder.layer.{i}.{names[rest]}"
            assert torch.equal(module.kernel_q.T, encoder.w[ref + ".q"])
            assert torch.allclose(module.scale, encoder.w[ref + ".scale"], rtol=0, atol=0)
            assert float(module.a_scale) == pytest.approx(encoder.a_scale[ref], rel=1e-2)


def test_calibration_input_is_jaxs(tiny):
    """The reference's threefry normals on torch equal the port's NumPy ones
    (bit-exact JAX normals) within float32 rounding of erfinv."""
    from algonauts2025_tpu_torch.ops.threefry import normal

    got = vjepa2_vitg_int8.jax_normal(7, (4, 8, 8, 3), "cpu").numpy()
    want = normal(7, (4, 8, 8, 3))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
