"""The port's V-JEPA2 backbone against the JAX package's, on the CPU.

Weights are made once on the JAX side (flax init, or an HF-named state
dict built here) and carried to the port by models.convert /
params_from_hf, so both sides hold the same numbers.  On the CPU both run
their plain paths: unfused int8 matmuls, exact gelu, plain attention.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algonauts2025_tpu.models.backbones import vjepa2 as jv
from algonauts2025_tpu.ops.quant import calibrate_quant_scales
from algonauts2025_tpu_torch.models import vjepa2_params_to_torch
from algonauts2025_tpu_torch.models.backbones import vjepa2 as tv
from algonauts2025_tpu_torch.ops import flash_attention as tflash
from algonauts2025_tpu_torch.ops import quant as tq

SMALL = dict(crop_size=32, patch_size=16, tubelet_size=2, frames_per_clip=4, hidden_size=64,
             num_layers=2, num_heads=4, mlp_ratio=2.0)


def _pixels(seed=1, shape=(2, 4, 32, 32, 3)):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _pair(token_pool, quantize=False, **over):
    kw = {**SMALL, **over}
    jmodel = jv.VJEPA2Backbone(jv.VJEPA2Config(dtype=jnp.float32, quantize=quantize, **kw),
                               token_pool=token_pool)
    tmodel = tv.VJEPA2Backbone(tv.VJEPA2Config(dtype=torch.float32, quantize=quantize, **kw),
                               token_pool=token_pool)
    return jmodel, tmodel


@pytest.mark.parametrize("n,hd", [(32, 16), (8192, 64), (50, 22)])
def test_rope_tables_equal_jax(n, hd):
    cos, sin = tv._rope_tables(n, hd, 256, 16)
    jcos, jsin = jv._rope_tables(n, hd, 256, 16)
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)


def test_apply_rope_matches_jax(rng):
    x = rng.standard_normal((2, 3, 32, 16)).astype(np.float32)
    cos, sin = tv._rope_tables(32, 16, 32, 16)
    ref = jv._apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    got = tv._apply_rope(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("token_pool", [False, True])
def test_float_backbone_matches_jax(token_pool):
    jmodel, tmodel = _pair(token_pool)
    pixels = _pixels()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(pixels))["params"]
    tmodel.load_state_dict(vjepa2_params_to_torch(params))
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(pixels)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(pixels)).numpy()
    assert got.shape == ref.shape == ((3, 2, 64) if token_pool else (3, 2, 8, 64))
    np.testing.assert_allclose(got, ref, atol=3e-4, rtol=1e-3)


@pytest.mark.parametrize("token_pool", [False, True])
def test_quantized_static_backbone_matches_jax(token_pool):
    """Calibrated in JAX, the scales carried over with the int8 weights."""
    jdyn, tmodel = _pair(token_pool, quantize=True)
    pixels = _pixels()
    params = jdyn.init(jax.random.PRNGKey(0), jnp.asarray(pixels))["params"]
    params = calibrate_quant_scales(jdyn.apply, params, jnp.asarray(pixels), margin=1.5)
    jstatic = jv.VJEPA2Backbone(dataclasses.replace(jdyn.cfg, quant_static=True),
                                token_pool=token_pool)
    ref = np.asarray(jstatic.apply({"params": params}, jnp.asarray(pixels)))
    tmodel.load_state_dict(vjepa2_params_to_torch(params))
    tmodel.set_quant_static()
    assert all(m.static_scale for m in tmodel.modules() if isinstance(m, tv._QDense))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(pixels)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=3e-4, rtol=1e-3)


def test_quantized_dynamic_backbone_matches_jax():
    jmodel, tmodel = _pair(True, quantize=True)
    pixels = _pixels()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(pixels))["params"]
    tmodel.load_state_dict(vjepa2_params_to_torch(params))
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(pixels)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(pixels)).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-4, rtol=1e-3)


def test_bf16_backbone_close_to_jax():
    """The production dtype: bf16 activations, fp32 rotary and norms; the
    two frameworks round bf16 at other places, hence the looser bound."""
    kw = {**SMALL}
    jmodel = jv.VJEPA2Backbone(jv.VJEPA2Config(**kw), token_pool=True)
    tmodel = tv.VJEPA2Backbone(tv.VJEPA2Config(**kw), token_pool=True)
    pixels = _pixels()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(pixels))["params"]
    tmodel.load_state_dict(vjepa2_params_to_torch(params))
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(pixels)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(pixels)).numpy()
    assert got.dtype == np.float32
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 2e-2, rel


def _hf_state_dict(rng, d=48, layers=2, mlp=96, c=3, ts=2, ps=16):
    sd = {"encoder.embeddings.patch_embeddings.proj.weight": rng.standard_normal((d, c, ts, ps, ps)),
          "encoder.embeddings.patch_embeddings.proj.bias": rng.standard_normal(d),
          "encoder.layernorm.weight": 1 + 0.1 * rng.standard_normal(d),
          "encoder.layernorm.bias": 0.1 * rng.standard_normal(d)}
    for i in range(layers):
        p = f"encoder.layer.{i}."
        for n in ("norm1", "norm2"):
            sd[p + n + ".weight"] = 1 + 0.1 * rng.standard_normal(d)
            sd[p + n + ".bias"] = 0.1 * rng.standard_normal(d)
        for n, (o, i_) in {"attention.query": (d, d), "attention.key": (d, d),
                           "attention.value": (d, d), "attention.proj": (d, d),
                           "mlp.fc1": (mlp, d), "mlp.fc2": (d, mlp)}.items():
            sd[p + n + ".weight"] = rng.standard_normal((o, i_)) / np.sqrt(i_)
            sd[p + n + ".bias"] = 0.1 * rng.standard_normal(o)
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}


@pytest.mark.parametrize("quantize", [False, True])
def test_params_from_hf_matches_jax_converter(rng, quantize):
    """HF key names -> the port's state dict equals the JAX params_from_hf
    tree carried over by the converter (int8 weights and scales exactly)."""
    kw = {**SMALL, "hidden_size": 48}
    sd = _hf_state_dict(rng)
    got = tv.params_from_hf(sd, tv.VJEPA2Config(quantize=quantize, **kw))
    ref = vjepa2_params_to_torch(jv.params_from_hf(sd, jv.VJEPA2Config(quantize=quantize, **kw)))
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key].to(ref[key].dtype).numpy(), ref[key].numpy(),
                                      err_msg=key)
    model = tv.VJEPA2Backbone(tv.VJEPA2Config(quantize=quantize, **kw))
    model.load_state_dict(got)  # strict: every buffer and parameter is covered
    # the JAX backbone itself is held against an HF VJEPA2Model with these
    # key names by tests/test_backbones.py::test_vjepa2_parity


def test_converter_rejects_unknown_leaves():
    with pytest.raises(KeyError, match="no torch counterpart"):
        vjepa2_params_to_torch({"layers": {"attn": {"query": {"mystery": np.zeros((2, 3))}}}})


def test_sequence_parallel_is_not_ported():
    """A backbone built with ``sequence_parallel_axis`` runs only over a
    LocalMesh of that axis name; over one it gives the one-device states."""
    from algonauts2025_tpu_torch.parallel import local_mesh

    model = tv.VJEPA2Backbone(tv.VJEPA2Config(**SMALL, dtype=torch.float32,
                                              sequence_parallel_axis="seq"))
    model.init_random(torch.Generator().manual_seed(0))
    plain = tv.VJEPA2Backbone(tv.VJEPA2Config(**SMALL, dtype=torch.float32))
    plain.load_state_dict(model.state_dict())
    pixels = torch.randn((2, 4, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="needs a LocalMesh"):
        model(pixels)
    with pytest.raises(ValueError, match="needs a LocalMesh"):
        model(pixels, mesh=local_mesh(2, "data", "cpu"))
    with torch.no_grad():
        got = model(pixels, mesh=local_mesh(2, "seq", "cpu"))
        want = plain(pixels)
    # the ring against the plain attention at fp32 roundoff (the JAX SP tests')
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


def test_cpu_forward_launches_no_kernel():
    """An aligned, calibrated static model with 1024 tokens takes the kernel
    route only on the card: on the CPU every call runs the plain path."""
    kw = dict(crop_size=128, patch_size=16, tubelet_size=2, frames_per_clip=32,
              hidden_size=128, num_layers=1, num_heads=2, mlp_ratio=2.0, quantize=True)
    model = tv.VJEPA2Backbone(tv.VJEPA2Config(**kw), token_pool=True).init_random(
        torch.Generator().manual_seed(0))
    pixels = torch.from_numpy(_pixels(2, (1, 32, 128, 128, 3)))
    tq.calibrate_quant_scales(model, pixels, margin=1.5)
    model.set_quant_static()
    before = {**tq.launch_counts, **tflash.launch_counts}
    with torch.no_grad():
        out = model(pixels)
    assert out.shape == (2, 1, 128) and torch.isfinite(out).all()
    assert {**tq.launch_counts, **tflash.launch_counts} == before
