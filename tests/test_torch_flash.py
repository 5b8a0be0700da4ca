"""The port's flash attention (ops/flash_attention.py) against the JAX
package's, on the CPU.

On CPU tensors ``flash_attention`` runs the kernels' plain versions; the
JAX ``_bounded_kernel`` and ``_flash_kernel`` run in interpret mode, as
tests/test_ops.py runs them.  The CUDA kernels are held against the plain
versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algonauts2025_tpu.ops.attention import dot_product_attention as jax_dpa
from algonauts2025_tpu.ops.flash_attention import flash_attention as jax_flash
from algonauts2025_tpu_torch.ops import flash_attention as tf
from algonauts2025_tpu_torch.ops.attention import dot_product_attention


def _qkv(rng, shape, scale=1.0):
    return [(rng.standard_normal(shape) * scale).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_plain_matches_bounded_pallas(rng, dtype, atol):
    q, k, v = _qkv(rng, (1, 2, 1024, 64))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_flash(*(jnp.asarray(x).astype(jd) for x in (q, k, v)), interpret=True)
    got = tf.flash_attention(*(torch.from_numpy(x).to(td) for x in (q, k, v)))
    assert got.dtype == td and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=atol)


def test_wide_score_spread_stays_finite(rng):
    """q and k scaled x30 spread the scores of a row over hundreds of nats.
    The JAX kernel's a-priori shift overflows exp there and returns NaN
    everywhere (a fault of the JAX package, ROADMAP section 3); the port's
    running-max softmax stays finite and equals plain attention."""
    q, k, v = _qkv(rng, (1, 2, 1024, 64))
    q, k = q * 30, k * 30
    jax_out = np.asarray(jax_flash(*(jnp.asarray(x) for x in (q, k, v)), interpret=True))
    assert np.isnan(jax_out).all()
    got = tf.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert torch.isfinite(got).all()
    ref = np.asarray(jax_dpa(*(jnp.asarray(x) for x in (q, k, v))))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("t", [1, 37, 1000, 1100])
def test_plain_matches_dot_product_attention_at_any_length(rng, t):
    """Ragged lengths, and T above the plain version's query chunk."""
    q, k, v = map(torch.from_numpy, _qkv(rng, (2, 3, t, 24)))
    got = tf.bounded_attention_plain(q, k, v)
    torch.testing.assert_close(got, dot_product_attention(q, k, v), atol=2e-5, rtol=1e-5)


def test_plain_takes_strided_views(rng):
    """The backbone hands over head-split views of (B, T, H*d) projections."""
    fused = torch.from_numpy(rng.standard_normal((2, 40, 3, 4, 16)).astype(np.float32))
    q, k, v = fused.permute(2, 0, 3, 1, 4).unbind(0)
    got = tf.flash_attention(q, k, v)
    torch.testing.assert_close(got, tf.flash_attention(*(x.contiguous() for x in (q, k, v))))


def _jax_masked_reference(q, k, v, causal, lengths):
    """JAX's masked dot_product_attention under the causal and key-length mask."""
    t = q.shape[-2]
    mask = np.ones((q.shape[0], 1, t, t), bool)
    if causal:
        mask &= np.tril(np.ones((t, t), bool))
    if lengths is not None:
        mask &= np.arange(t)[None, None, None] < np.asarray(lengths)[:, None, None, None]
    return np.asarray(jax_dpa(*(jnp.asarray(x) for x in (q, k, v)), mask=jnp.asarray(mask)))


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_causal_lengths_match_flash_pallas_on_all_rows(rng, dtype, atol):
    """``_flash_kernel`` (interpret mode) defines the padded query rows too,
    so every row is compared, not only the valid ones."""
    q, k, v = _qkv(rng, (2, 2, 256, 16))
    lengths = np.array([200, 256], np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_flash(*(jnp.asarray(x).astype(jd) for x in (q, k, v)), q_block=64, kv_block=128,
                    causal=True, lengths=jnp.asarray(lengths), interpret=True)
    got = tf.flash_attention(*(torch.from_numpy(x).to(td) for x in (q, k, v)), causal=True,
                             lengths=torch.from_numpy(lengths))
    assert got.dtype == td and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=atol)


@pytest.mark.parametrize("lengths", [None, (0, 256)])
def test_full_head_dim_matches_flash_pallas(rng, lengths):
    """d = 128, non-causal: ``_flash_kernel``'s dispatch, with and without
    key lengths (a length-0 row among them)."""
    q, k, v = _qkv(rng, (2, 2, 256, 128))
    lens = None if lengths is None else np.array(lengths, np.int32)
    ref = jax_flash(*(jnp.asarray(x) for x in (q, k, v)), q_block=128, kv_block=128,
                    lengths=None if lens is None else jnp.asarray(lens), interpret=True)
    got = tf.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             lengths=None if lens is None else torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_zero_length_row_is_exactly_zero(rng, causal):
    q, k, v = map(torch.from_numpy, _qkv(rng, (3, 2, 40, 16)))
    got = tf.flash_attention(q, k, v, causal=causal, lengths=torch.tensor([5, 0, 40]))
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    assert got[0].abs().min() > 0 and got[2].abs().min() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gqa_equals_repeated_kv(rng, dtype):
    """Query head h reads kv head h // rep, the order jnp.repeat gives."""
    q = torch.from_numpy(_qkv(rng, (2, 6, 50, 32))[0]).to(dtype)
    k, v = (torch.from_numpy(x).to(dtype) for x in _qkv(rng, (2, 2, 50, 32))[:2])
    lengths = torch.tensor([50, 17])
    got = tf.flash_attention(q, k, v, causal=True, lengths=lengths)
    rep = [torch.from_numpy(np.repeat(x.float().numpy(), 3, axis=1)).to(dtype) for x in (k, v)]
    assert torch.equal(got, tf.flash_attention(q, *rep, causal=True, lengths=lengths))


@pytest.mark.parametrize("t", [1, 37, 300])
@pytest.mark.parametrize("causal,lengths", [(True, None), (True, "ragged"), (False, "ragged")])
def test_masked_plain_matches_dot_product_attention_at_any_length(rng, t, causal, lengths):
    """Ragged T, which JAX's block sizes do not take, against JAX's masked
    dot_product_attention."""
    q, k, v = _qkv(rng, (2, 3, t, 24))
    lens = None if lengths is None else np.array([t, max(1, t // 3)], np.int32)
    got = tf.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                             lengths=None if lens is None else torch.from_numpy(lens))
    ref = _jax_masked_reference(q, k, v, causal, lens)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_masked_plain_takes_strided_views(rng):
    """The Llama backbone hands over head-split views of its projections."""
    fused = torch.from_numpy(rng.standard_normal((2, 300, 3, 4, 16)).astype(np.float32))
    q, k, v = fused.permute(2, 0, 3, 1, 4).unbind(0)
    lengths = torch.tensor([300, 123])
    got = tf.flash_attention(q, k, v, causal=True, lengths=lengths)
    torch.testing.assert_close(
        got, tf.flash_attention(*(x.contiguous() for x in (q, k, v)), causal=True, lengths=lengths))


def test_masked_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 2, 8, 128))
    before = dict(tf.launch_counts)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tf._flash_masked_cuda(q, q[:, :1], q[:, :1], True, torch.tensor([8]))
    assert tf.launch_counts == before


def test_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 1, 8, 64))
    before = dict(tf.launch_counts)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tf._flash_cuda(q, q, q)
    assert tf.launch_counts == before
