"""scripts/quant_parity.py's pipeline against the JAX package's on the CPU.

The JAX package measured its static-int8 ViT-G against exact bf16 with
root ``scripts/quant_parity.py`` (ACCURACY.md): ``quantize_tree``,
``calibrate_quant_scales(margin=1.5)`` and the static apply.  Here a tiny
config (2 layers, 64 wide, 4 frames of 32 x 32) runs that pipeline in the
JAX package and the port's (``quantized_state``, ``static_int8_backbone``)
on the same flax-initialised weights, converted by
``vjepa2_params_to_torch``, and the same seeded window; the port's three
numbers must agree with the JAX pipeline's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algonauts2025_tpu.models.backbones import vjepa2 as jv
from algonauts2025_tpu.ops.quant import calibrate_quant_scales, quantize_tree
from algonauts2025_tpu_torch.models import vjepa2_params_to_torch
from algonauts2025_tpu_torch.models.backbones import vjepa2 as tv
from algonauts2025_tpu_torch.ops import quant as tq
from algonauts2025_tpu_torch.scripts import quant_parity

TINY = dict(crop_size=32, patch_size=16, tubelet_size=2, frames_per_clip=4, hidden_size=64, num_layers=2,
            num_heads=4, mlp_ratio=2.0)
#: how far 1 - r of each number may lie from the JAX pipeline's: in bf16 the
#: two frameworks round at other places (tests/test_torch_vjepa2.py), which
#: read 1.2e-4 against 9.8e-5 here; in fp32 they agree to summation order
#: (4.5e-10 here)
TOL = {"bfloat16": 1e-4, "float32": 1e-7}


def _window(seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (1, 4, 32, 32, 3)).astype(np.float32)


def _jax_numbers(dtype, px):
    cfg = jv.VJEPA2Config(dtype=dtype, **TINY)
    model = jv.VJEPA2Backbone(cfg, token_pool=True)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(px))["params"]
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(px)))
    qmodel = jv.VJEPA2Backbone(dataclasses.replace(cfg, quantize=True, quant_static=False), token_pool=True)
    qparams = calibrate_quant_scales(qmodel.apply, quantize_tree(jax.device_get(params)), jnp.asarray(px),
                                     margin=1.5)
    smodel = jv.VJEPA2Backbone(dataclasses.replace(cfg, quantize=True, quant_static=True), token_pool=True)
    out = np.asarray(smodel.apply({"params": qparams}, jnp.asarray(px)))
    return params, qparams, quant_parity.agreement(ref, out)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_pipeline_numbers_match_jax(dtype):
    px = _window()
    params, qparams, want = _jax_numbers(getattr(jnp, dtype), px)
    cfg = tv.VJEPA2Config(dtype=getattr(torch, dtype), **TINY)
    got = quant_parity.compare(cfg, vjepa2_params_to_torch(params), px, "cpu")
    assert set(got) == set(want) == {"global_r", "min_layer_r", "min_token_cosine"}
    for key in want:
        assert 0.99 < got[key] <= 1 and abs((1 - got[key]) - (1 - want[key])) <= TOL[dtype], (key, got, want)


def test_quantized_state_is_quantize_tree():
    """The port's int8 weights and scales are the JAX package's
    ``quantize_tree`` of the same float weights, bit for bit; its
    calibrated scales are the JAX pipeline's up to summation order."""
    px = _window()
    params, qparams, _ = _jax_numbers(jnp.float32, px)
    cfg = tv.VJEPA2Config(dtype=torch.float32, **TINY)
    qmodel = quant_parity.static_int8_backbone(cfg, vjepa2_params_to_torch(params), torch.from_numpy(px), "cpu")
    assert qmodel.cfg.quant_static
    want = vjepa2_params_to_torch(qparams)
    got = qmodel.state_dict()
    for key in want:
        if key.endswith(("kernel_q", ".scale")):
            np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
        elif key.endswith("a_scale"):
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-5, err_msg=key)
    assert sum(key.endswith("kernel_q") for key in want) == 12


def test_agreement_of_identical_and_scaled_features():
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((3, 2, 16)).astype(np.float32)
    assert quant_parity.agreement(ref, ref) == pytest.approx(
        {"global_r": 1.0, "min_layer_r": 1.0, "min_token_cosine": 1.0})
    noisy = ref + 0.01 * rng.standard_normal(ref.shape).astype(np.float32)
    numbers = quant_parity.agreement(ref, noisy)
    assert 0.999 < numbers["min_token_cosine"] < 1 and numbers["global_r"] >= numbers["min_layer_r"]


def test_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: main runs the full ViT-G there")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        quant_parity.main([])
