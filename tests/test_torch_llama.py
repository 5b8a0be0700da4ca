"""The port's Llama backbone against the JAX package's, on the CPU.

Weights are made once on the JAX side (flax init with the RMSNorm gains
perturbed, or an HF-named state dict built here) and carried to the port by
models.convert / params_from_hf, so both sides hold the same numbers.  On
the CPU both run the masked plain attention; the kernel route of
``_decoder_attention`` runs only on a card (chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algonauts2025_tpu.models.backbones import llama as jl
from algonauts2025_tpu_torch.models import llama_params_to_torch
from algonauts2025_tpu_torch.models.backbones import llama as tl
from algonauts2025_tpu_torch.ops import flash_attention as tflash

#: small, with GQA (4 query heads over 2 kv heads) and the llama3 rope
#: scaling of the 3.2 family (its wavelengths straddle both cut-offs at d=16)
SMALL = dict(vocab_size=97, hidden_size=64, intermediate_size=96, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=16)


def _pair(dtype="float32", **over):
    kw = {**SMALL, **over}
    jmodel = jl.LlamaBackbone(jl.LlamaConfig(dtype=getattr(jnp, dtype), **kw))
    tmodel = tl.LlamaBackbone(tl.LlamaConfig(dtype=getattr(torch, dtype), **kw))
    return jmodel, tmodel


def _params(jmodel, seed=0):
    """Flax init, with every RMSNorm gain moved off 1 so that a gain applied
    in the wrong place shows."""
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        if path[-1].key == "weight":
            return x + jnp.asarray(0.2 * rng.standard_normal(x.shape), x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(perturb, params)


def _inputs(b=2, t=40, lengths=None, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, SMALL["vocab_size"], (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    for i, n in enumerate(lengths or []):
        mask[i, n:] = 0
    return ids, mask


def _run(jmodel, tmodel, params, ids, mask):
    tmodel.load_state_dict(llama_params_to_torch(params))
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    return got, ref


def test_rope_freqs_bit_equal():
    for over in ({}, {"head_dim": 16}, {"rope_scaling_factor": 1.0}):
        jc = dataclasses.replace(jl.LLAMA_3P2_3B, **over)
        tc = dataclasses.replace(tl.LLAMA_3P2_3B, **over)
        np.testing.assert_array_equal(tl._llama3_rope_freqs(tc), jl._llama3_rope_freqs(jc))


def test_published_shapes():
    model = tl.LlamaBackbone(tl.LLAMA_3P2_3B, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 3_212_749_824
    assert dataclasses.asdict(tl.LLAMA_3P2_3B) == {
        **dataclasses.asdict(jl.LLAMA_3P2_3B), "dtype": torch.bfloat16}


def test_fp32_backbone_matches_jax():
    jmodel, tmodel = _pair()
    params = _params(jmodel)
    got, ref = _run(jmodel, tmodel, params, *_inputs())
    assert got.shape == (SMALL["num_layers"] + 1, 2, 40, SMALL["hidden_size"])
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


def test_right_padded_rows_match_jax_on_valid_positions():
    jmodel, tmodel = _pair()
    params = _params(jmodel, seed=2)
    lengths = [40, 23]
    got, ref = _run(jmodel, tmodel, params, *_inputs(lengths=lengths))
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[:, b, :n], ref[:, b, :n], atol=2e-5, rtol=0)
    assert np.isfinite(got).all()


def test_bf16_backbone_close_to_jax():
    """bf16 weights and activations: the two frameworks round at other
    places (XLA's bf16 dots and silu against PyTorch's), so the bound is
    relative L2 over the whole stack."""
    jmodel, tmodel = _pair("bfloat16")
    params = _params(jmodel, seed=3)
    got, ref = _run(jmodel, tmodel, params, *_inputs(lengths=[40, 31]))
    valid = np.ones(got.shape[:3], bool)
    valid[:, 1, 31:] = False
    rel = np.linalg.norm(got[valid] - ref[valid]) / np.linalg.norm(ref[valid])
    assert rel <= 1e-2, rel


def test_left_padded_row_is_poisoned_from_entry_one():
    """The right-pad contract: a left-padded row is NaN in every layer's
    state, but entry 0 (the embedding) is not poisoned, as in JAX."""
    jmodel, tmodel = _pair()
    params = _params(jmodel, seed=4)
    ids, mask = _inputs()
    mask[1, :5] = 0
    got, ref = _run(jmodel, tmodel, params, ids, mask)
    assert np.isnan(got[1:, 1]).all() and np.isnan(ref[1:, 1]).all()
    assert np.isfinite(got[0, 1]).all()
    np.testing.assert_allclose(got[0], ref[0], atol=0)
    np.testing.assert_allclose(got[:, 0], ref[:, 0], atol=2e-5, rtol=0)


def test_attention_inputs_match_jax():
    cfg_j, cfg_t = jl.LlamaConfig(**SMALL), tl.LlamaConfig(**SMALL)
    _, mask = _inputs(b=3, t=12, lengths=[12, 5, 0])
    mask[2, 3:6] = 1  # a row that breaks the right-pad contract
    ref = jl.attention_inputs(cfg_j, jnp.asarray(mask))
    got = tl.attention_inputs(cfg_t, torch.from_numpy(mask))
    for name, g, r in zip(("cos", "sin", "mask", "lengths", "right_padded"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6, err_msg=name)
    assert got[3].dtype == torch.int32 and got[4].tolist() == [True, True, False]


def test_kernel_route_matches_plain_route_on_valid_rows():
    """What the card computes (the masked flash attention over the kv
    heads, causal with key lengths) equals the CPU route (the masked plain
    attention over repeated kv heads) on every valid query row."""
    rng = np.random.default_rng(5)
    b, h, kvh, t, d = 2, 4, 2, 256, 16
    q = torch.from_numpy(rng.standard_normal((b, h, t, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, kvh, t, d)).astype(np.float32)) for _ in range(2))
    _, mask = _inputs(b, t, lengths=[256, 100])
    _, _, m, lengths, _ = tl.attention_inputs(tl.LlamaConfig(**SMALL), torch.from_numpy(mask))
    plain = tl._decoder_attention(q, k, v, m, lengths)
    kernel = tflash.flash_attention(q, k, v, causal=True, lengths=lengths)
    torch.testing.assert_close(kernel[0], plain[0], atol=2e-6, rtol=1e-5)
    torch.testing.assert_close(kernel[1, :, :100], plain[1, :, :100], atol=2e-6, rtol=1e-5)


def _hf_state_dict(rng, cfg):
    """An HF LlamaModel state dict (names and (out, in) Linear layout)."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    shapes = {"embed_tokens.weight": (cfg["vocab_size"], d), "norm.weight": (d,)}
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (d,),
            p + "post_attention_layernorm.weight": (d,),
            p + "self_attn.q_proj.weight": (cfg["num_heads"] * hd, d),
            p + "self_attn.k_proj.weight": (cfg["num_kv_heads"] * hd, d),
            p + "self_attn.v_proj.weight": (cfg["num_kv_heads"] * hd, d),
            p + "self_attn.o_proj.weight": (d, cfg["num_heads"] * hd),
            p + "mlp.gate_proj.weight": (cfg["intermediate_size"], d),
            p + "mlp.up_proj.weight": (cfg["intermediate_size"], d),
            p + "mlp.down_proj.weight": (d, cfg["intermediate_size"]),
        })
    return {name: rng.standard_normal(shape).astype(np.float32) for name, shape in shapes.items()}


@pytest.mark.parametrize("dtype,as_tensors", [("float32", False), ("bfloat16", True)])
def test_params_from_hf_matches_jax_converter(rng, dtype, as_tensors):
    sd = _hf_state_dict(rng, SMALL)
    jcfg = jl.LlamaConfig(dtype=getattr(jnp, dtype), **SMALL)
    tcfg = tl.LlamaConfig(dtype=getattr(torch, dtype), **SMALL)
    want = llama_params_to_torch(jl.params_from_hf(sd, jcfg))
    src = {k: torch.from_numpy(v) for k, v in sd.items()} if as_tensors else sd
    got = tl.params_from_hf(src, tcfg)
    assert got.keys() == want.keys()
    for name, value in got.items():
        assert value.dtype == (torch.float32 if name.endswith("norm.weight") else tcfg.dtype), name
        assert torch.equal(value.float(), want[name]), name
    tl.LlamaBackbone(tcfg).load_state_dict(got)  # strict: every parameter named


def test_converter_rejects_unknown_leaves():
    with pytest.raises(KeyError, match="no torch counterpart"):
        llama_params_to_torch({"layers": {"attn": {"q_proj": {"bias": np.zeros((2, 3))}}}})


def test_cpu_forward_launches_no_kernel():
    """T = 256 with key lengths takes the kernel route only on a card."""
    _, tmodel = _pair()
    tmodel.init_random(torch.Generator().manual_seed(0))
    ids, mask = _inputs(t=256, lengths=[256, 99])
    before = dict(tflash.launch_counts)
    with torch.no_grad():
        out = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert tflash.launch_counts == before
    assert out.shape == (3, 2, 256, 64) and torch.isfinite(out).all()
