"""The port's bench-only attention entry points and its attention bench,
against the JAX package's, on the CPU.

On CPU tensors ``fast_flash_attention`` and ``flash_attention_packed`` run
their kernels' plain versions; the JAX ``_fast_kernel`` and
``_flash_kernel_packed`` run in interpret mode, as tests/test_ops.py runs
them.  The CUDA kernels are held against the plain versions on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algonauts2025_tpu.ops import flash_attention as jfa
from algonauts2025_tpu_torch.ops import flash_attention as tf
from algonauts2025_tpu_torch.scripts import bench_attn


def _qkv(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


# fp32 inputs differ only in the order of the sums; bf16 outputs by about
# one bf16 rounding of values of magnitude ~1
@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_fast_plain_matches_fast_pallas(rng, dtype, atol, score_dtype):
    q, k, v = _qkv(rng, (1, 2, 512, 64))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jfa._fast_flash(*(jnp.asarray(x).astype(jd) for x in (q, k, v)), 128, 256, True,
                          getattr(jnp, score_dtype))
    got = tf.fast_flash_attention(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                                  score_dtype=getattr(torch, score_dtype))
    assert got.dtype == td and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=atol)


def test_fast_fp32_scores_are_the_bounded_function(rng):
    """With fp32 scores the fast kernel computes flash_forward's function,
    bit for bit; bf16 scores change it."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, (2, 3, 300, 32)))
    fast = tf.fast_flash_attention(q, k, v)
    assert torch.equal(fast, tf.bounded_attention_plain(q, k, v))
    b16 = tf.fast_flash_attention(q, k, v, score_dtype=torch.bfloat16)
    assert 1e-4 < (b16 - fast).abs().max() < 2e-2


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_packed_plain_matches_packed_pallas(rng, dtype, atol):
    """tests/test_ops.py's packed shape and blocks."""
    q, k, v = _qkv(rng, (1, 4, 512, 64))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jfa.flash_attention_packed(*(jnp.asarray(x).astype(jd) for x in (q, k, v)),
                                     q_block=128, kv_block=256, interpret=True)
    got = tf.flash_attention_packed(*(torch.from_numpy(x).to(td) for x in (q, k, v)))
    assert got.dtype == td and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=atol)


def test_packed_takes_any_length(rng):
    """The JAX version's T % block rule has no counterpart: T = 37 against
    the unmasked flash_attention_plain."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, (2, 2, 37, 64)))
    assert torch.equal(tf.flash_attention_packed(q, k, v), tf.flash_attention_plain(q, k, v))


@pytest.mark.parametrize("shape", [(1, 4, 64, 32), (1, 3, 64, 64)])
@pytest.mark.parametrize("fn", [tf.flash_attention_packed, tf.packed_attention_plain])
def test_packed_contract_raises(shape, fn):
    q = torch.zeros(shape)
    with pytest.raises(ValueError, match="H even"):
        fn(q, q, q)


def test_fast_rejects_other_score_dtypes():
    q = torch.zeros((1, 1, 8, 64))
    with pytest.raises(ValueError, match="score_dtype"):
        tf.fast_flash_attention(q, q, q, score_dtype=torch.float16)


@pytest.mark.parametrize("entry,counter,args", [
    (tf._FAST, "flash_fast", (1, 2, 8, 64, 0, 0, 0.125)),
    (tf._PACKED, "flash_packed", (1, 2, 8, 64, 0, 0.125)),
])
def test_cuda_launch_refuses_cpu_tensors(entry, counter, args):
    q = torch.zeros((1, 2, 8, 64))
    before = dict(tf.launch_counts)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tf._launch(entry, counter, q, q, q, False, *args)
    assert tf.launch_counts == before


def test_bench_runs_end_to_end_on_cpu(capsys):
    before = dict(tf.launch_counts)
    out = bench_attn.run(["all", "boundb16", "bounded:512:2048"], device="cpu", shape=(1, 2, 64, 64))
    printed = capsys.readouterr().out
    assert "boundb16: not available" in printed and "bounded:512:2048: not available" in printed
    assert list(out["ms"]) == ["default", "fast", "fastb16", "bounded", "packed"]
    assert all(ms > 0 for ms in out["ms"].values())
    assert list(out["err"]) == ["default", "fastb16", "bounded", "packed"]
    # default and bounded are the fast function with fp32 scores
    assert out["err"]["default"] == out["err"]["bounded"] == (0.0, 0.0)
    assert 0 < out["err"]["fastb16"][0] < 3e-2 and 0 < out["err"]["packed"][0] < 3e-2
    # what the run would launch on a card: 4 timings of R calls per variant
    # (warm-up + 3 reps), one call per checked variant, one for the reference
    n = (1 + bench_attn.REPS) * bench_attn.R
    assert out["launches"] == {"flash_attention": 2 * n + 2, "flash_fast": 2 * n + 2,
                               "flash_packed": n + 1}
    assert tf.launch_counts == before  # the CPU ran the plain versions


def test_bench_default_variants_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_attn.main([])
