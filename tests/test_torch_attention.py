"""The port's attention ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both sides.  On CPU
tensors the port's wrapper runs the kernel's plain version, so these
tests hold the plain version (and the autograd.Function's analytic
backward) against the JAX functions; the CUDA kernel itself is held
against the plain version on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algonauts2025_tpu.ops import attention as jax_attn
from algonauts2025_tpu_torch.ops import attention as port_attn


def _qkv(rng, shape, dtype=np.float32):
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("t,dh,rot", [(9, 16, 8), (37, 24, 24), (5, 64, 32)])
def test_rotary_matches_jax(rng, t, dh, rot):
    x = rng.standard_normal((2, 3, t, dh)).astype(np.float32)
    ang = port_attn.rotary_angles(t, rot)
    np.testing.assert_array_equal(ang, jax_attn.rotary_angles(t, rot))
    ref = jax_attn.apply_rotary(jnp.asarray(x), jnp.asarray(ang))
    out = port_attn.apply_rotary(torch.from_numpy(x), torch.from_numpy(ang))
    assert out.dtype == torch.float32
    # elementwise sin/cos products: a few ulp between the two libms
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_rotary_keeps_bf16(rng):
    x = torch.from_numpy(rng.standard_normal((1, 2, 7, 16)).astype(np.float32)).bfloat16()
    ang = torch.from_numpy(port_attn.rotary_angles(7, 8))
    assert port_attn.apply_rotary(x, ang).dtype == torch.bfloat16


@pytest.mark.parametrize("masked", [False, True])
def test_dot_product_attention_matches_jax(rng, masked):
    q, k, v = _qkv(rng, (2, 3, 11, 16))
    mask = None
    if masked:
        mask = rng.random((2, 1, 11, 11)) > 0.4
        mask[0, 0, 3, :] = False  # one fully masked row
    ref = np.asarray(jax_attn.dot_product_attention(
        *map(jnp.asarray, (q, k, v)), None if mask is None else jnp.asarray(mask)
    ))
    out = port_attn.dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), None if mask is None else torch.from_numpy(mask)
    ).numpy()
    # fp32 softmax and matmuls in two libraries' summation orders
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    if masked:
        np.testing.assert_array_equal(out[0, :, 3], 0.0)


def test_fused_attention_masked_takes_plain_path(rng):
    q, k, v = map(torch.from_numpy, _qkv(rng, (1, 2, 6, 8)))
    mask = torch.ones((6, 6), dtype=torch.bool).tril()[None, None]
    out = port_attn.fused_attention(q, k, v, mask=mask)
    torch.testing.assert_close(out, port_attn.dot_product_attention(q, k, v, mask))


def test_plain_path_matches_pallas_interpret(rng):
    """The port's CPU path against the Pallas kernel in interpret mode, at
    the shape tests/test_ops.py runs it."""
    q, k, v = _qkv(rng, (2, 4, 37, 24))
    ref = np.asarray(jax_attn._fused_attention_tpu(*map(jnp.asarray, (q, k, v)), interpret=True))
    out = port_attn.fused_attention(*map(torch.from_numpy, (q, k, v))).detach().numpy()
    # the interpret-mode kernel pads T and Dh to 128: same function, other sum order
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_fused_attention_grads_match_jax(rng):
    """The autograd.Function's backward against _pallas_attention_bwd and
    against jax.vjp of the plain dot_product_attention."""
    q, k, v = _qkv(rng, (2, 3, 13, 16))
    g = rng.standard_normal((2, 3, 13, 16)).astype(np.float32)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    ref_bwd = jax_attn._pallas_attention_bwd((jq, jk, jv), jg)
    _, vjp = jax.vjp(jax_attn.dot_product_attention, jq, jk, jv)
    ref_vjp = vjp(jg)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = port_attn.fused_attention(tq, tk, tv)
    out.backward(torch.from_numpy(g))
    for got, want_bwd, want_vjp in zip((tq.grad, tk.grad, tv.grad), ref_bwd, ref_vjp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want_bwd), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_vjp), atol=1e-5, rtol=1e-5)


def test_fused_attention_grads_match_torch_autograd(rng):
    """The analytic backward against autograd through the plain version."""
    q, k, v = _qkv(rng, (1, 2, 9, 8))
    g = torch.from_numpy(rng.standard_normal((1, 2, 9, 8)).astype(np.float32))
    a = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    b = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    port_attn.fused_attention(*a).backward(g)
    port_attn.dot_product_attention(*b).backward(g)
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, atol=1e-6, rtol=1e-5)


def test_cpu_path_launches_no_kernel(rng):
    before = port_attn.launch_counts["attention"]
    q, k, v = map(torch.from_numpy, _qkv(rng, (1, 1, 4, 8)))
    port_attn.fused_attention(q, k, v)
    assert port_attn.launch_counts["attention"] == before


@pytest.mark.parametrize("x,m", [(1, 128), (128, 128), (298, 128), (384, 64), (0, 8)])
def test_round_up_matches_jax(x, m):
    from algonauts2025_tpu.ops._util import round_up as jax_round_up
    from algonauts2025_tpu_torch.ops._util import round_up

    assert round_up(x, m) == jax_round_up(x, m)


def test_kernel_wrapper_rejects_cpu_tensors(rng):
    """The CUDA wrapper raises on what the kernel does not take, before
    building or launching anything."""
    q, k, v = map(torch.from_numpy, _qkv(rng, (1, 1, 4, 8)))
    with pytest.raises(ValueError, match="not a CUDA device"):
        port_attn._attention_cuda(q, k, v)


def _trunk_qkv(dim: int, heads: int, b: int, t: int):
    """(q, k, v) as the trunk's SelfAttention hands them to fused_attention,
    on the meta device (layouts only), with the trunk's rotary width."""
    from unittest import mock

    from algonauts2025_tpu_torch.models import transformer

    dh = dim // heads
    attn = transformer.SelfAttention(dim, heads, dh, min(max(dh // 2, 32), dh), device="meta")
    seen = []

    def capture(q, k, v, mask=None):
        seen.append((q, k, v))
        return q

    with torch.no_grad(), mock.patch.object(transformer, "fused_attention", capture):
        attn(torch.empty((b, t, dim), device="meta"))
    return seen[0]


#: every trunk configuration in the repo as (dim, heads, batch, T): the
#: flagship (bench.py's bench_train: (16, 8, 298, 384) fused-qkv views),
#: chip_smoke.py's small trunk and the CPU tests' encoders
TRUNKS = {
    "flagship": (3072, 8, 16, 298),
    "chip_smoke_small": (96, 2, 4, 200),
    "test_48x4": (48, 4, 2, 11),
    "test_48x1": (48, 1, 2, 11),
    "test_128x1": (128, 1, 2, 11),
    "test_192x4": (192, 4, 2, 11),
}


def _route(q, k, v):
    out = port_attn._output_like(q)
    tensors = (q, k, v, out)
    return port_attn.vector_layout(q.shape[-1], [x.stride() for x in tensors],
                                   [x.data_ptr() for x in tensors], q.element_size())


@pytest.mark.parametrize("trunk", sorted(TRUNKS))
def test_every_trunk_takes_the_vector_route(trunk):
    """The kernel's layout routing is a pure function of the layouts, and
    every trunk the repo configures gets four-element loads."""
    q, k, v = _trunk_qkv(*TRUNKS[trunk])
    dim, heads, b, t = TRUNKS[trunk]
    assert q.shape == (b, heads, t, dim // heads) and v.stride(-1) == 1
    assert _route(q, k, v) is True and _route(q, k, v) is True


@pytest.mark.parametrize("shape,strided,vector", [
    ((16, 8, 298, 384), True, True),
    ((2, 4, 37, 24), False, True),
    ((1, 1, 1, 8), False, True),
    ((2, 3, 513, 64), True, True),
    ((1, 3, 45, 30), True, False),   # rows of 30 values: one element at a time
    ((2, 3, 9, 30), False, False),
])
def test_route_of_chip_smoke_cases(shape, strided, vector):
    """chip_smoke.py's check_attention cases, built as it builds them."""
    import chip_smoke

    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = chip_smoke.qkv(shape, dtype, strided, torch.Generator().manual_seed(0), device="cpu")
        assert _route(q, k, v) is vector


def test_route_refuses_vector_loads_off_alignment():
    base = torch.zeros(4 * 3 * 16 * 64 + 1)
    x = base[1:].view(4, 3, 16, 64)  # starts one float past a 16-byte boundary
    y = torch.zeros(4, 3, 16, 64)
    assert _route(y, y, y) is True
    assert _route(x, y, y) is False
    odd = torch.zeros(8192).as_strided((2, 3, 16, 64), (3 * 16 * 66, 16 * 66, 66, 1))
    assert _route(y, odd, y) is False
