"""The port's FmriMlp, Mlp / Mean / LayerScale and the save_attn_out remat
policy against the JAX package's, with the same weights.

Flax initialises the weights; ``fmri_mlp_params_to_torch`` /
``flax_params_to_torch`` move them and the port's module loads them
strictly.  Inputs come from numpy.  CPU, fp32, small widths: forwards at
atol 1e-5 (the trunk tests' tolerance: one fp32 function in two libraries'
summation orders).  The remat policy changes what is saved, never what is
computed: against the port's full remat the loss and every gradient are
bit-equal; against the JAX policy (another library's fp32 sums) the loss
at rtol 1e-5 and the gradients at rtol 1e-5 / atol 1e-5 (measured: the
loss 1.1e-6 relative, gradient elements of order 1-10 up to 3.6e-6 apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algonauts2025_tpu.models import common as jax_common
from algonauts2025_tpu.models import fmri_mlp as jax_fmri_mlp
from algonauts2025_tpu.models import transformer as jax_tr
from algonauts2025_tpu_torch.models import common, convert, fmri_mlp, transformer

ATOL = 1e-5

FMRI_MLP_CASES = {
    "default": dict(hidden=32, n_blocks=2),
    "subjects_tr_layer_embeds": dict(hidden=32, n_blocks=2, subject_layers=True, n_subjects=3,
                                     use_tr_layer=True, use_tr_embeds=True, tr_embed_dim=4,
                                     n_repetition_times=3),
    "subjects_input_dim_act_first": dict(hidden=24, n_blocks=1, subject_layers=True,
                                         subject_layers_dim="input", subject_layers_id=True,
                                         n_subjects=3, act_first=True, time_agg="out_mean",
                                         n_repetition_times=3),
    "in_linear": dict(hidden=16, n_blocks=3, time_agg="in_linear", n_repetition_times=4),
    "in_mean_head": dict(hidden=16, n_blocks=1, time_agg="in_mean", n_repetition_times=4,
                         output_head_config={"name": "Mlp", "hidden_sizes": [12, 6],
                                             "norm_layer": "layer",
                                             "activation_layer": "prelu"}),
    "heads": dict(hidden=16, n_blocks=1, n_repetition_times=2,
                  output_head_config={"a": {"hidden_sizes": [5]},
                                      "b": {"hidden_sizes": [7, 3], "activation_layer": "gelu"}}),
}


@pytest.mark.parametrize("case", sorted(FMRI_MLP_CASES))
def test_fmri_mlp_matches_jax(rng, case):
    kw = FMRI_MLP_CASES[case]
    t = kw.get("n_repetition_times", 1)
    x = rng.standard_normal((3, 2, 8, t)).astype(np.float32)  # (B, layers, dim, T)
    subjects = np.array([2, 0, 1])
    jm = jax_fmri_mlp.FmriMlpConfig(**kw).build(n_in_channels=16, n_outputs=8)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(subjects))["params"]
    params = jax.tree.map(  # non-zero biases and gains, so their mapping shows
        lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(1), a.shape), params)
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(subjects))
    cfg = fmri_mlp.FmriMlpConfig(**kw)
    port = cfg.build(n_in_channels=16, n_outputs=8)
    port.load_state_dict(convert.fmri_mlp_params_to_torch(params, cfg), strict=True)
    got = port(torch.from_numpy(x), torch.from_numpy(subjects))
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(ref[k]), atol=ATOL)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=ATOL)


def test_fmri_mlp_trains_with_dropout(rng):
    """Training mode draws the trunk's dropouts; eval mode is deterministic;
    init_weights gives finite outputs of the configured width."""
    cfg = fmri_mlp.FmriMlpConfig(hidden=32, n_blocks=2, subject_layers=True, n_subjects=3)
    model = cfg.build(n_in_channels=16, n_outputs=8)
    model.init_weights(torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.standard_normal((2, 16, 1)).astype(np.float32))
    subj = torch.tensor([0, 1])
    out = model(x, subj)
    assert out.shape == (2, 8) and torch.isfinite(out).all()
    assert torch.equal(out, model(x, subj))
    assert not torch.equal(model(x, subj, training=True), out)
    with pytest.raises(ValueError, match="TR mismatch"):
        model(torch.zeros(2, 16, 3), subj)


def test_fmri_mlp_rejects_unsupported_norm():
    cfg = fmri_mlp.FmriMlpConfig(hidden=16, n_blocks=1, norm_type="bn")
    with pytest.raises(NotImplementedError, match="norm_type"):
        cfg.build(n_in_channels=8, n_outputs=4)


def test_convert_fmri_mlp_rejects_unknown_leaves():
    cfg = fmri_mlp.FmriMlpConfig(hidden=8, n_blocks=1)
    with pytest.raises(KeyError, match="Dense_9"):
        convert.fmri_mlp_params_to_torch({"Dense_9": {"kernel": np.zeros((2, 2))}}, cfg)


@pytest.mark.parametrize("norm,act,hidden", [
    (None, "relu", [16]), ("layer", "gelu", [16, 12]), (None, "elu", [5]),
    ("layer", "prelu", [9]), (None, None, [4]), (None, "relu", []),
])
def test_mlp_matches_jax(rng, norm, act, hidden):
    x = rng.standard_normal((4, 8)).astype(np.float32)
    config = dict(hidden_sizes=hidden, norm_layer=norm, activation_layer=act)
    jm = jax_common.MlpConfig(**config).build(output_size=6)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(
        lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(2), a.shape), params)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    port = common.MlpConfig(**config).build(input_size=8, output_size=6)
    head = {"Mlp_0": params}
    state = convert.fmri_mlp_params_to_torch(
        head, fmri_mlp.FmriMlpConfig(output_head_config=common.MlpConfig(**config)))
    port.load_state_dict({k.removeprefix("head."): v for k, v in state.items()}, strict=True)
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), np.asarray(ref),
                               atol=ATOL)


def test_mlp_trailing_dropout_parity():
    """torchvision's MLP ends with a dropout after the final Linear; the
    bare Linear (no hidden sizes) has none."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32))
    torch.manual_seed(1)
    m = common.Mlp(8, hidden_sizes=[16], output_size=64, dropout=0.5)
    m.init_weights(torch.Generator().manual_seed(0))
    zero_frac = float((m(x, deterministic=False) == 0.0).float().mean())
    assert 0.2 < zero_frac < 0.8
    bare = common.Mlp(8, hidden_sizes=[], output_size=64, dropout=0.5)
    assert float((bare(x, deterministic=False) == 0.0).float().mean()) == 0.0
    assert torch.equal(m(x), m(x))  # deterministic by default
    with pytest.raises(NotImplementedError, match="norm_layer"):
        common.Mlp(8, hidden_sizes=[4], norm_layer="batch")
    with pytest.raises(ValueError, match="input_size"):
        common.MlpConfig(hidden_sizes=[4]).build()


@pytest.mark.parametrize("axis,keepdims", [(2, False), (1, True), (-1, False)])
def test_mean_module_matches_jax(rng, axis, keepdims):
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    ref = jax_common.Mean(axis=axis, keepdims=keepdims).apply({}, jnp.asarray(x))
    got = common.Mean(axis=axis, keepdims=keepdims)(torch.from_numpy(x))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-7)


def test_layer_scale_matches_jax(rng):
    """The boosted init (init / boost, times boost in the forward) and a
    learned scale give the JAX module's output."""
    x = rng.standard_normal((4, 5)).astype(np.float32)
    port = common.LayerScale(channels=4, init=0.2, boost=3.0)
    torch.testing.assert_close(port.scale.detach(), torch.full((4,), 0.2 / 3.0))
    scale = rng.standard_normal(4).astype(np.float32)
    ref = jax_common.LayerScale(channels=4, init=0.2, boost=3.0).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))
    with torch.no_grad():
        port.scale.copy_(torch.from_numpy(scale))
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), np.asarray(ref),
                               atol=1e-6)


# -- remat_policy="save_attn_out" (test_models_training.py:586-633) ---------


def _loss_and_grads(enc, x, r):
    # a fixed random projection: sum(out**2) is constant under the final ScaleNorm
    loss = (enc(x) * r).sum()
    grads = torch.autograd.grad(loss, list(enc.parameters()))
    return loss.detach(), dict(zip([n for n, _ in enc.named_parameters()], grads))


@pytest.mark.parametrize("causal", [False, True])
def test_remat_save_attn_out_equals_full_remat_and_jax(rng, causal):
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    r = rng.standard_normal((2, 12, 32)).astype(np.float32)
    jenc = jax_tr.TransformerEncoder(dim=32, depth=2, heads=4, causal=causal, remat=True,
                                     remat_policy="save_attn_out")
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    jloss, jgrads = jax.value_and_grad(
        lambda p: (jenc.apply({"params": p}, jnp.asarray(x)) * jnp.asarray(r)).sum())(params)
    jgrads = convert.flax_params_to_torch(jgrads)
    results = {}
    for policy in (None, "save_attn_out"):
        enc = transformer.TransformerEncoder(dim=32, depth=2, heads=4, causal=causal,
                                             remat=True, remat_policy=policy)
        enc.load_state_dict(convert.flax_params_to_torch(params), strict=True)
        results[policy] = _loss_and_grads(enc, torch.from_numpy(x), torch.from_numpy(r))
    (full_loss, full_grads), (loss, grads) = results[None], results["save_attn_out"]
    assert torch.equal(loss, full_loss)
    assert all(torch.equal(grads[k], full_grads[k]) for k in full_grads)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)
    assert set(grads) == set(jgrads)
    for k in grads:
        np.testing.assert_allclose(grads[k].numpy(), jgrads[k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)

