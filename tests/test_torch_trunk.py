"""The port's trunk modules against the JAX package's, with the same weights.

Weights are initialised by flax, moved with ``flax_params_to_torch`` and
loaded strictly; inputs come from numpy.  CPU, fp32, small widths.  The
tolerance is 1e-5 absolute: the same fp32 function in two libraries'
summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algonauts2025_tpu.models import common as jax_common
from algonauts2025_tpu.models import fmri_encoder as jax_fe
from algonauts2025_tpu.models import transformer as jax_tr
from algonauts2025_tpu_torch.models import common, convert, fmri_encoder, transformer

ATOL = 1e-5


def _load(module: torch.nn.Module, params) -> torch.nn.Module:
    module.load_state_dict(convert.flax_params_to_torch(params), strict=True)
    return module


def test_scalenorm_matches_jax(rng):
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    x[0, 0] = 0.0  # a zero row goes through eps
    jm = jax_tr.ScaleNorm()
    params = {"g": np.float32(1.7)}
    ref = jm.apply({"params": params}, jnp.asarray(x))
    port = _load(transformer.ScaleNorm(), params)
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), np.asarray(ref), atol=ATOL)


# (dim, heads): rotary_dim = min(max(dh//2, 32), dh) takes every branch:
# dh=12 -> 12 (whole head), dh=48 -> 32 (the floor), dh=128 -> 64 (dh//2)
@pytest.mark.parametrize("dim,heads", [(48, 4), (48, 1), (128, 1)])
@pytest.mark.parametrize("remat", [False, True])
def test_transformer_encoder_matches_jax(rng, dim, heads, remat):
    x = rng.standard_normal((2, 11, dim)).astype(np.float32)
    jm = jax_tr.TransformerEncoder(dim=dim, depth=2, heads=heads, remat=remat)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    # residual gains away from 1 so the per-dim scales are exercised
    blocks = params["blocks"]["block"]
    blocks["res_scale_attn"] = jnp.asarray(1 + 0.1 * rng.standard_normal((2, dim)), jnp.float32)
    blocks["res_scale_ff"] = jnp.asarray(1 + 0.1 * rng.standard_normal((2, dim)), jnp.float32)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))

    port = _load(transformer.TransformerEncoder(dim=dim, depth=2, heads=heads, remat=remat), params)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)

    # gradients through the (rematerialised) blocks and the attention backward
    g = rng.standard_normal(ref.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p, v: jm.apply({"params": p}, v), params, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=ATOL)
    want = convert.flax_params_to_torch(jax.tree.map(np.asarray, gp))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("variant", [{"use_scalenorm": False}, {"causal": True}])
def test_transformer_encoder_variants_match_jax(rng, variant):
    """The LayerNorm trunk (flax ``scale`` -> torch ``weight``) and the causal
    trunk (masked plain attention)."""
    x = rng.standard_normal((2, 9, 48)).astype(np.float32)
    jm = jax_tr.TransformerEncoder(dim=48, depth=2, heads=4, **variant)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    port = _load(transformer.TransformerEncoder(dim=48, depth=2, heads=4, **variant), params)
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), ref, atol=ATOL)


def test_gelu_fast_matches_jax():
    from algonauts2025_tpu.ops.fast_gelu import gelu_fast as jax_gelu
    from algonauts2025_tpu_torch.ops.fast_gelu import gelu_fast

    x = np.linspace(-8, 8, 20001, dtype=np.float32)
    # the same rational in the same fp32 order: a few ulp at most
    np.testing.assert_allclose(gelu_fast(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_gelu(jnp.asarray(x))), atol=1e-6, rtol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x).double()).numpy()
    assert np.abs(gelu_fast(torch.from_numpy(x)).numpy() - exact).max() < 1.3e-6 * 4


@pytest.mark.parametrize("n_in,n_out", [(298, 100), (13, 5), (7, 7)])
def test_pool_matrix_matches_jax_and_torch(n_in, n_out):
    from algonauts2025_tpu.ops.pooling import adaptive_avg_pool_matrix as jax_pool
    from algonauts2025_tpu_torch.ops.pooling import adaptive_avg_pool_matrix

    mat = adaptive_avg_pool_matrix(n_in, n_out)
    np.testing.assert_array_equal(mat, jax_pool(n_in, n_out))
    x = torch.randn(2, 3, n_in, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(x @ torch.from_numpy(mat),
                               torch.nn.functional.adaptive_avg_pool1d(x, n_out))


def test_init_matches_flax_statistics():
    """init_weights draws flax's initialisers: each parameter's mean and
    spread match the flax init of the same model (constants exactly)."""
    dims = {"text": (2, 64), "audio": (1, 32), "video": (2, 48)}
    kw = dict(n_subjects=4, hidden=192, depth=2, heads=4, contrastive_enabled=True,
              subject_embedding=True)
    batch = {m: jnp.zeros((1, n_layers, d, 3)) for m, (n_layers, d) in dims.items()}
    batch["subject_id"] = jnp.zeros((1, 1), jnp.int32)
    jm = jax_fe.FmriEncoderConfig(**kw).build(dims, n_outputs=100, n_output_timesteps=2)
    want = convert.flax_params_to_torch(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), batch, method="forward_with_contrastive")["params"]))
    port = fmri_encoder.FmriEncoderConfig(**kw).build(dims, n_outputs=100, n_output_timesteps=2)
    port.to_empty(device="cpu")
    port.init_weights(torch.Generator().manual_seed(0))
    got = port.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if w.numel() < 100 or float(w.std()) == 0.0:
            torch.testing.assert_close(g, w, msg=name)  # ones / zeros
            continue
        # sampling error of a std over >= 100 draws stays well inside 25 %
        assert abs(float(g.std()) / float(w.std()) - 1) < 0.25, name
        assert abs(float(g.mean()) - float(w.mean())) < 0.25 * float(w.std()), name
        if w.numel() >= 2000:
            # flax's truncated normal stops at 2/0.88 std; 2000 untruncated
            # draws all inside 2.3 std happen with probability ~1e-19
            truncated = float(w.abs().max()) <= 2.3 * float(w.std())
            assert (float(g.abs().max()) <= 2.3 * float(g.std())) == truncated, name


def test_transformer_config_guard():
    with pytest.raises(NotImplementedError, match="rel_pos_bias"):
        transformer.TransformerEncoderConfig(rel_pos_bias=True).build(48)
    transformer.TransformerEncoder(dim=48, depth=1, heads=4, remat=True,
                                   remat_policy="save_attn_out", device="meta")
    with pytest.raises(ValueError, match="unknown remat_policy 'bogus'"):
        transformer.TransformerEncoder(dim=48, depth=1, heads=4, remat=True,
                                       remat_policy="bogus")
    enc = transformer.TransformerEncoderConfig(depth=1, heads=4).build(48, device="meta")
    assert len(enc.blocks) == 1


@pytest.mark.parametrize("with_subjects", [True, False])
def test_subject_layers_matches_jax(rng, with_subjects):
    x = rng.standard_normal((3, 16, 7)).astype(np.float32)
    subjects = np.array([[2], [0], [2]])
    jm = jax_common.SubjectLayers(in_channels=16, out_channels=5, n_subjects=3)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(subjects))["params"]
    s = subjects if with_subjects else None
    ref = jm.apply({"params": params}, jnp.asarray(x), None if s is None else jnp.asarray(s))
    port = _load(common.SubjectLayers(16, 5, 3), params)
    out = port(torch.from_numpy(x), None if s is None else torch.from_numpy(s))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL)


FEATURE_DIMS = {"text": (2, 12), "audio": (1, 6), "video": (2, 10)}


def _encoder_pair(rng, aggregation="cat", **overrides):
    cfg_kw = dict(
        n_subjects=3, hidden=48, depth=2, heads=4, contrastive_enabled=True,
        feature_aggregation=aggregation, remat=True, **overrides,
    )
    batch = {
        m: rng.standard_normal((2, n_layers, d, 13)).astype(np.float32)
        for m, (n_layers, d) in FEATURE_DIMS.items()
    }
    batch["subject_id"] = np.array([[1], [2]])
    jm = jax_fe.FmriEncoderConfig(**cfg_kw).build(FEATURE_DIMS, n_outputs=9, n_output_timesteps=5)
    params = jm.init(
        jax.random.PRNGKey(3), {k: jnp.asarray(v) for k, v in batch.items()},
        method="forward_with_contrastive",
    )["params"]
    port = fmri_encoder.FmriEncoderConfig(**cfg_kw).build(
        FEATURE_DIMS, n_outputs=9, n_output_timesteps=5, device="cpu"
    )
    _load(port, params)
    return jm, params, port, batch


@pytest.mark.parametrize("aggregation", ["cat", "sum"])
def test_fmri_encoder_matches_jax(rng, aggregation):
    jm, params, port, batch = _encoder_pair(rng, aggregation)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ref = np.asarray(jm.apply({"params": params}, jb))
    with torch.no_grad():
        out = port(tb).numpy()
        pred, losses = port.forward_with_contrastive(tb)
    assert out.shape == (2, 9, 5)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    ref_pred, ref_losses = jm.apply({"params": params}, jb, method="forward_with_contrastive")
    np.testing.assert_allclose(pred.numpy(), np.asarray(ref_pred), atol=ATOL)
    assert set(losses) == set(ref_losses) == {"video"}
    np.testing.assert_allclose(losses["video"].item(), float(ref_losses["video"]), atol=ATOL)


def test_fmri_encoder_subject_embedding_matches_jax(rng):
    jm, params, port, batch = _encoder_pair(rng, subject_embedding=True)
    ref = np.asarray(jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        out = port({k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_info_nce_matches_jax(rng):
    q = rng.standard_normal((3, 7, 16)).astype(np.float32)
    k = rng.standard_normal((3, 7, 16)).astype(np.float32)
    k[0, 0] = 0.0  # a zero row goes through _safe_normalize's eps
    ref = float(jax_fe._info_nce(jnp.asarray(q), jnp.asarray(k), 0.07))
    out = fmri_encoder._info_nce(torch.from_numpy(q), torch.from_numpy(k), 0.07).item()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_modality_dropout_keeps_a_survivor():
    """With dropout 1.0 every modality is drawn as dropped; exactly one
    survivor (from the step's generator) remains."""
    cfg = fmri_encoder.FmriEncoderConfig(n_subjects=1, hidden=48, depth=1, heads=4,
                                         modality_dropout=1.0)
    model = cfg.build(FEATURE_DIMS, n_outputs=4, n_output_timesteps=2)
    model.to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    batch = {m: torch.ones((1, n_layers, d, 3)) for m, (n_layers, d) in FEATURE_DIMS.items()}
    for seed in range(6):
        x = model.aggregate_features(batch, training=True,
                                     generator=torch.Generator().manual_seed(seed))
        live = [bool(chunk.abs().sum() > 0) for chunk in x.split(16, dim=-1)]
        assert sum(live) == 1


def test_convert_rejects_unknown_leaves():
    with pytest.raises(KeyError, match="mystery"):
        convert.flax_params_to_torch({"proj_text": {"kernel": np.zeros((2, 3))},
                                      "mystery": {"w": np.zeros(2)}})
