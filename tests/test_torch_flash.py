"""The port's long-sequence attention (ops/flash_attention.py) against the
JAX package's, on the CPU.

On CPU tensors ``flash_attention`` runs the kernel's plain version; the
JAX ``_bounded_kernel`` runs in interpret mode, as tests/test_ops.py runs
it.  The CUDA kernel is held against the plain version on the card by
chip_smoke.py.
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


@pytest.mark.parametrize("kwargs,d", [({"causal": True}, 64), ({"lengths": torch.ones(1)}, 64), ({}, 128)])
def test_unported_dispatch_cases_raise(rng, kwargs, d):
    q = torch.zeros((1, 1, 8, d))
    with pytest.raises(NotImplementedError, match="text slice"):
        tf.flash_attention(q, q, q, **kwargs)


def test_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 1, 8, 64))
    before = dict(tf.launch_counts)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tf._flash_cuda(q, q, q)
    assert tf.launch_counts == before
