"""bf16 agreement of the port's backbones with the JAX package's at full
depth, on the CPU.

Each backbone runs at a small width and its production depth: Llama-3.2-3B's
28 layers (head dim 128), ViT-G's 40 blocks (head dim 64) and w2v-BERT 2.0's
24 conformer layers.  One set of weights serves three models: the JAX bf16
init (bf16 denses, fp32 norms), the same numbers in fp32 for the JAX fp32
model, and ``models.convert``'s copy for the port's bf16 model.  The bound,
on every layer's states: the port's bf16 drifts from the JAX bf16 by at most
twice what the JAX bf16 drifts from the JAX fp32 (relative L2).  Two
independent bf16 roundings of the same sums differ by about sqrt(2) of one;
a cast placed elsewhere (a norm or rotary in bf16, a residual added in
another dtype) grows with depth far past 2.  The JAX backbones are scanned,
so their depth costs no compile time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from algonauts2025_tpu.models.backbones import llama as jl
from algonauts2025_tpu.models.backbones import vjepa2 as jv
from algonauts2025_tpu.models.backbones import wav2vec_bert as jw
from algonauts2025_tpu_torch.models import (
    llama_params_to_torch, vjepa2_params_to_torch, wav2vec_bert_params_to_torch,
)
from algonauts2025_tpu_torch.models.backbones import llama as tl
from algonauts2025_tpu_torch.models.backbones import vjepa2 as tv
from algonauts2025_tpu_torch.models.backbones import wav2vec_bert as tw


def _fp32(params):
    return jax.tree.map(lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x, params)


def _rel(a, b, valid=None):
    """Relative L2 of a against b, one number a layer (states (L+1, ...))."""
    out = []
    for x, y in zip(a.astype(np.float64), b.astype(np.float64)):
        if valid is not None:
            x, y = x[valid], y[valid]
        out.append(np.linalg.norm(x - y) / np.linalg.norm(y))
    return np.array(out)


def _check(name, port16, jax16, jax32, valid=None):
    """Every layer: rel(port16, jax16) <= 2 x rel(jax16, jax32)."""
    assert port16.shape == jax16.shape == jax32.shape
    assert np.isfinite(port16 if valid is None else port16[:, valid]).all()
    ours, theirs = _rel(port16, jax16, valid), _rel(jax16, jax32, valid)
    worst = int(np.argmax(ours - 2 * theirs))
    assert (ours <= 2 * theirs).all(), (
        f"{name}: layer {worst} of {len(ours) - 1}: rel(port bf16, JAX bf16) {ours[worst]:.4e} > "
        f"2 x rel(JAX bf16, JAX fp32) = 2 x {theirs[worst]:.4e}; last layer {ours[-1]:.4e} "
        f"against {theirs[-1]:.4e}")


def test_llama_28_layers():
    """Llama at 28 layers, hidden 256, 2 query heads of 128 over one kv
    head, the RMSNorm gains moved off 1; tokens (2, 64), the second row
    right-padded to 41 (its valid positions compared)."""
    kw = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=28,
              num_heads=2, num_kv_heads=1, head_dim=128)
    j16 = jl.LlamaBackbone(jl.LlamaConfig(dtype=jnp.bfloat16, **kw))
    j32 = jl.LlamaBackbone(jl.LlamaConfig(dtype=jnp.float32, **kw))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (2, 64)).astype(np.int32)
    mask = np.ones((2, 64), np.int32)
    mask[1, 41:] = 0
    params = jax.jit(j16.init)(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.2 * rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "weight" else x, params)
    out16 = np.asarray(j16.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)), np.float32)
    out32 = np.asarray(j32.apply({"params": _fp32(params)}, jnp.asarray(ids), jnp.asarray(mask)))
    port = tl.LlamaBackbone(tl.LlamaConfig(dtype=torch.bfloat16, **kw))
    port.load_state_dict(llama_params_to_torch(params))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), torch.from_numpy(mask)).float().numpy()
    assert got.shape == (29, 2, 64, 256)
    _check("Llama", got, out16, out32, valid=mask.astype(bool))


def test_vjepa2_40_blocks():
    """V-JEPA2 at 40 blocks, width 128, 2 heads of 64; one clip of 32
    frames of 64 x 64, 256 tokens, every token's state."""
    kw = dict(crop_size=64, patch_size=16, tubelet_size=2, frames_per_clip=32, hidden_size=128,
              num_layers=40, num_heads=2)
    j16 = jv.VJEPA2Backbone(jv.VJEPA2Config(dtype=jnp.bfloat16, **kw), token_pool=False)
    j32 = jv.VJEPA2Backbone(jv.VJEPA2Config(dtype=jnp.float32, **kw), token_pool=False)
    pixels = np.random.default_rng(1).uniform(size=(1, 32, 64, 64, 3)).astype(np.float32)
    params = jax.jit(j16.init)(jax.random.PRNGKey(0), jnp.asarray(pixels))["params"]
    out16 = np.asarray(j16.apply({"params": params}, jnp.asarray(pixels)), np.float32)
    out32 = np.asarray(j32.apply({"params": _fp32(params)}, jnp.asarray(pixels)))
    port = tv.VJEPA2Backbone(tv.VJEPA2Config(dtype=torch.bfloat16, **kw), token_pool=False)
    port.load_state_dict(vjepa2_params_to_torch(params))
    with torch.no_grad():
        got = port(torch.from_numpy(pixels)).float().numpy()
    assert got.shape == (41, 1, 256, 128)
    _check("V-JEPA2", got, out16, out32)


def test_wav2vec_bert_24_layers():
    """The w2v-BERT conformer at 24 layers, width 128, 2 heads of 64; one
    full row of 150 feature frames and one padded to 97 (its valid frames
    compared)."""
    kw = dict(hidden_size=128, num_layers=24, num_heads=2, intermediate_size=512)
    j16 = jw.Wav2VecBertBackbone(jw.Wav2VecBertConfig(dtype=jnp.bfloat16, **kw))
    j32 = jw.Wav2VecBertBackbone(jw.Wav2VecBertConfig(dtype=jnp.float32, **kw))
    features = np.random.default_rng(2).standard_normal((2, 150, 160)).astype(np.float32)
    mask = np.ones((2, 150), bool)
    mask[1, 97:] = False
    params = jax.jit(j16.init)(jax.random.PRNGKey(0), jnp.asarray(features))["params"]
    args = (jnp.asarray(features), jnp.asarray(mask))
    out16 = np.asarray(j16.apply({"params": params}, *args), np.float32)
    out32 = np.asarray(j32.apply({"params": _fp32(params)}, *args))
    port = tw.Wav2VecBertBackbone(tw.Wav2VecBertConfig(dtype=torch.bfloat16, **kw))
    port.load_state_dict(wav2vec_bert_params_to_torch(params))
    with torch.no_grad():
        got = port(torch.from_numpy(features), torch.from_numpy(mask)).float().numpy()
    assert got.shape == (25, 2, 150, 128)
    _check("w2v-BERT", got, out16, out32, valid=mask)


def test_bf16_drift_at_flagship_head_dims(rng):
    """The twin of tests/test_accuracy_gate.py::test_bf16_drift_at_flagship_head_dims
    on the port's Llama: the same shapes and weights (the JAX fp32 init),
    the port's bf16 stack against its fp32 stack, per layer cosine > 0.999
    and relative L2 < 0.02 (measured ceilings, ACCURACY.md)."""
    kw = dict(vocab_size=512, hidden_size=512, intermediate_size=1024, num_layers=2, num_heads=4,
              num_kv_heads=2)
    tokens = rng.integers(0, 512, size=(2, 64)).astype(np.int32)
    params = jl.LlamaBackbone(jl.LlamaConfig(dtype=jnp.float32, **kw)).init(
        jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    outs = []
    for dtype in (torch.float32, torch.bfloat16):
        port = tl.LlamaBackbone(tl.LlamaConfig(dtype=dtype, **kw))
        port.load_state_dict(llama_params_to_torch(params))
        with torch.no_grad():
            outs.append(port(torch.from_numpy(tokens).long()).numpy())
    a = outs[0].astype(np.float64).reshape(outs[0].shape[0], -1)
    b = outs[1].astype(np.float64).reshape(outs[1].shape[0], -1)
    cos = np.sum(a * b, axis=-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    rel = np.linalg.norm(a - b) / np.linalg.norm(a)
    assert cos.min() > 0.999, cos
    assert rel < 0.02, rel
