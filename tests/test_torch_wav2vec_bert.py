"""The port's w2v-BERT conformer (models/backbones/wav2vec_bert.py) against
the JAX package's, on the CPU, with HF's Wav2Vec2BertModel as a second
oracle.  Weights come from the JAX init (converted by
models.convert.wav2vec_bert_params_to_torch) or from one HF-named state
dict fed to both converters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algonauts2025_tpu.models.backbones import wav2vec_bert as jw
from algonauts2025_tpu_torch.models import wav2vec_bert_params_to_torch
from algonauts2025_tpu_torch.models.backbones import wav2vec_bert as tw

TINY = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128, conv_kernel_size=7)


@pytest.fixture(scope="module")
def pair():
    """The JAX tiny conformer's params and the port's module with the same weights."""
    model = jw.Wav2VecBertBackbone(jw.Wav2VecBertConfig(**TINY, dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 160)))["params"]
    port = tw.Wav2VecBertBackbone(tw.Wav2VecBertConfig(**TINY, dtype=torch.float32))
    port.load_state_dict(wav2vec_bert_params_to_torch(params))
    return model, params, port


# fp32 on both sides: the order of the sums only (states of magnitude ~4)
@pytest.mark.parametrize("padded", [False, True])
def test_conformer_matches_jax(pair, rng, padded):
    """Every row is compared, padded query rows too (computed, not zeroed)."""
    model, params, port = pair
    x = rng.standard_normal((2, 90, 160)).astype(np.float32)
    mask = None
    if padded:
        mask = np.ones((2, 90), bool)
        mask[1, 57:] = False
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(x), None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ref.shape == (3, 2, 90, 64)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-5)


def test_pad_mask_hides_the_padding(pair, rng):
    """Valid rows of a padded batch equal the unpadded call's."""
    port = pair[2]
    x = torch.from_numpy(rng.standard_normal((1, 70, 160)).astype(np.float32))
    padded = torch.cat([x, torch.from_numpy(rng.standard_normal((1, 30, 160)).astype(np.float32))], dim=1)
    mask = torch.arange(100)[None] < 70
    with torch.no_grad():
        torch.testing.assert_close(port(padded, mask)[:, :, :70], port(x), atol=2e-5, rtol=1e-5)


def test_relative_bias_gather_is_the_onehot_placement(rng):
    """The gather places the same values as the JAX one-hot matmul."""
    t, left, right = 40, 8, 2
    qd = rng.standard_normal((2, 3, t, left + right + 1)).astype(np.float32)
    onehot = np.asarray(jw._rel_onehot(t, left, right), np.float32)
    ref = np.einsum("bhlp,lpr->bhlr", qd, onehot)
    idx = tw.relative_positions(t, left, right)
    got = torch.take_along_dim(torch.from_numpy(qd), idx[None, None], dim=-1).numpy()
    np.testing.assert_array_equal(got, ref)


def _hf_state_dict(rng, d=32, layers=2, f=64, k=7, inp=20, n_pos=11, hd=8):
    shapes = {"feature_projection.layer_norm.weight": (inp,), "feature_projection.layer_norm.bias": (inp,),
              "feature_projection.projection.weight": (d, inp), "feature_projection.projection.bias": (d,)}
    for i in range(layers):
        p = f"encoder.layers.{i}."
        for ln in ("ffn1_layer_norm", "self_attn_layer_norm", "ffn2_layer_norm", "final_layer_norm",
                   "conv_module.layer_norm", "conv_module.depthwise_layer_norm"):
            shapes.update({p + ln + ".weight": (d,), p + ln + ".bias": (d,)})
        for ff in ("ffn1", "ffn2"):
            shapes.update({f"{p}{ff}.intermediate_dense.weight": (f, d), f"{p}{ff}.intermediate_dense.bias": (f,),
                           f"{p}{ff}.output_dense.weight": (d, f), f"{p}{ff}.output_dense.bias": (d,)})
        for n in ("linear_q", "linear_k", "linear_v", "linear_out"):
            shapes.update({f"{p}self_attn.{n}.weight": (d, d), f"{p}self_attn.{n}.bias": (d,)})
        shapes.update({p + "self_attn.distance_embedding.weight": (n_pos, hd),
                       p + "conv_module.pointwise_conv1.weight": (2 * d, d, 1),
                       p + "conv_module.pointwise_conv2.weight": (d, d, 1),
                       p + "conv_module.depthwise_conv.weight": (d, 1, k)})
    return {name: (0.2 * rng.standard_normal(s)).astype(np.float32) for name, s in shapes.items()}


HF_SMALL = dict(input_dim=20, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                conv_kernel_size=7, left_max_pos=8, right_max_pos=2)


def test_params_from_hf_matches_jax_converter(rng):
    """One HF-named state dict through both converters (fp32), then both
    models on the same features."""
    sd = _hf_state_dict(rng)
    jcfg = jw.Wav2VecBertConfig(**HF_SMALL, dtype=jnp.float32)
    tcfg = tw.Wav2VecBertConfig(**HF_SMALL, dtype=torch.float32)
    port = tw.Wav2VecBertBackbone(tcfg)
    port.load_state_dict(tw.params_from_hf(sd, tcfg))
    # the converted JAX params back through the flax converter give the same state dict
    converted = wav2vec_bert_params_to_torch(jw.params_from_hf(sd, jcfg))
    assert converted.keys() == port.state_dict().keys()
    for name, value in port.state_dict().items():
        torch.testing.assert_close(value, converted[name], rtol=0, atol=0)
    feats = rng.standard_normal((2, 12, 20)).astype(np.float32)
    ref = np.asarray(jw.Wav2VecBertBackbone(jcfg).apply({"params": jw.params_from_hf(sd, jcfg)}, jnp.asarray(feats)))
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(feats)).numpy(), ref, atol=2e-5, rtol=1e-5)


def test_params_from_hf_dtypes(rng):
    """bf16 dense and conv weights, fp32 LayerNorms and distance tables."""
    cfg = tw.Wav2VecBertConfig(**HF_SMALL)
    sd = tw.params_from_hf(_hf_state_dict(rng), cfg)
    assert sd["layers.1.conv_module.pointwise_conv1.weight"].shape == (64, 32)
    assert sd["layers.0.self_attn.linear_q.weight"].dtype == torch.bfloat16
    assert sd["layers.0.conv_module.depthwise_conv.weight"].dtype == torch.bfloat16
    assert sd["layers.0.self_attn.distance_embedding"].dtype == torch.float32
    assert sd["fp_layer_norm.weight"].dtype == torch.float32
    model = tw.Wav2VecBertBackbone(cfg)
    model.load_state_dict(sd)  # strict: every parameter named


def test_matches_hf_wav2vec2_bert():
    """HF's model at tests/test_backbones.py's config and tolerance."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.Wav2Vec2BertConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        feature_projection_input_dim=20, conv_depthwise_kernel_size=7, left_max_position_embeddings=8,
        right_max_position_embeddings=2, position_embeddings_type="relative_key", hidden_dropout=0.0,
        attention_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0, conformer_conv_dropout=0.0,
        layerdrop=0.0, mask_time_prob=0.0, mask_feature_prob=0.0,
    )
    torch.manual_seed(0)
    hf_model = transformers.Wav2Vec2BertModel(hf_cfg).eval()
    cfg = tw.Wav2VecBertConfig(**HF_SMALL, dtype=torch.float32)
    port = tw.Wav2VecBertBackbone(cfg)
    port.load_state_dict(tw.params_from_hf(hf_model.state_dict(), cfg))
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 12, 20)).astype(np.float32))
    with torch.no_grad():
        ref = torch.stack(hf_model(input_features=feats, output_hidden_states=True).hidden_states)
        got = port(feats)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=3e-4, rtol=1e-3)


def test_init_random_is_seeded():
    cfg = tw.Wav2VecBertConfig(**TINY, dtype=torch.float32)
    a = tw.Wav2VecBertBackbone(cfg).init_random(torch.Generator().manual_seed(3))
    b = tw.Wav2VecBertBackbone(cfg).init_random(torch.Generator().manual_seed(3))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    w = a.layers[0].ffn1.intermediate_dense.weight
    assert abs(w.std().item() - tw.INITIALIZER_RANGE) < 2e-3
    assert torch.equal(a.layers[0].final_layer_norm.weight, torch.ones(64))
