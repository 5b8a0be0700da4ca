"""The port's int8 path (ops/quant.py) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both sides.  On CPU
tensors the port's fused wrappers run their kernels' plain versions; the
JAX Pallas kernels run in interpret mode, as tests/test_quant.py runs
them.  The CUDA kernels are held against the plain versions on the card
by chip_smoke.py.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algonauts2025_tpu.ops import quant as jq
from algonauts2025_tpu_torch.ops import _cuda
from algonauts2025_tpu_torch.ops import quant as tq


def _bf16(rng, shape):
    """bf16 values as (jax array, torch tensor) holding the same numbers."""
    x = rng.standard_normal(shape).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return jnp.asarray(x).astype(jnp.bfloat16), torch.tensor(x).bfloat16()


@pytest.mark.parametrize("shape", [(128, 96), (3, 16, 8), (1408, 640)])
def test_quantize_weight_bit_exact(rng, shape):
    w = rng.standard_normal(shape).astype(np.float32)
    ref_q, ref_s = jq.quantize_weight(w)
    for got_q, got_s in (tq.quantize_weight(w), tq.quantize_weight(torch.from_numpy(w))):
        assert got_q.dtype == torch.int8 and got_q.shape == shape
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


def test_quantize_dense_params_and_tree_match_jax(rng):
    stacked = {"kernel": rng.standard_normal((3, 16, 8)).astype(np.float32),
               "bias": rng.standard_normal((3, 8)).astype(np.float32)}
    ref = jq.quantize_dense_params(stacked)
    got = tq.quantize_dense_params(stacked)
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))
    assert got["scale"].shape == (3, 8) and got["a_scale"].shape == (3,)
    tree = {"attn": {"query": {"kernel": stacked["kernel"][0]}}, "norm": {"scale": np.ones(8)}}
    qtree = tq.quantize_tree(tree)
    assert set(qtree["attn"]["query"]) == {"kernel_q", "scale", "a_scale"}
    assert qtree["norm"] is not tree["norm"] and np.all(qtree["norm"]["scale"] == 1)


@pytest.mark.parametrize("static", [False, True])
def test_int8_matmul_matches_jax(rng, static):
    x = rng.standard_normal((64, 128)).astype(np.float32)
    w_q, w_s = jq.quantize_weight(rng.standard_normal((128, 96)).astype(np.float32))
    sx = np.float32(np.abs(x).max() / 127.0) if static else None
    ref = np.asarray(jq.int8_matmul(jnp.asarray(x), w_q, w_s, x_scale=sx))
    got = tq.int8_matmul(torch.from_numpy(x), torch.tensor(np.asarray(w_q)),
                         torch.tensor(np.asarray(w_s)),
                         x_scale=None if sx is None else torch.tensor(sx))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("m,k,n", [(64, 256, 128), (130, 384, 640)])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_matmul_fused_plain_equals_pallas(rng, m, k, n, out_dtype):
    """The plain version equals the Pallas kernel (interpret mode) exactly:
    same quantization, exact integer sums, the same fp32 epilogue."""
    xj, xt = _bf16(rng, (m, k))
    w_q, w_s = jq.quantize_weight(rng.standard_normal((k, n)).astype(np.float32) * 0.05)
    bias = rng.standard_normal((n,)).astype(np.float32)
    sx = np.float32(np.abs(np.asarray(xj, np.float32)).max() / 127.0)
    ref = jq.int8_matmul_fused(xj, w_q, w_s, jnp.float32(sx), bias=jnp.asarray(bias),
                               out_dtype=getattr(jnp, out_dtype), interpret=True)
    got = tq.int8_matmul_fused(xt, torch.tensor(np.asarray(w_q)),
                               torch.tensor(np.asarray(w_s)), torch.tensor(sx),
                               bias=torch.from_numpy(bias), out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def _w8a8_inputs(rng, m, k, n):
    """bf16 x, int8 weight, scales and bias of one dense as (jax args,
    torch args), and the static scale sx."""
    xj, xt = _bf16(rng, (m, k))
    w_q, w_s = jq.quantize_weight(rng.standard_normal((k, n)).astype(np.float32) * 0.05)
    bias = rng.standard_normal((n,)).astype(np.float32)
    sx = np.float32(np.abs(np.asarray(xj, np.float32)).max() / 127.0)
    jax_args = (xj, w_q, w_s, jnp.float32(sx))
    torch_args = (xt, torch.tensor(np.asarray(w_q)), torch.tensor(np.asarray(w_s)), torch.tensor(sx))
    return jax_args, torch_args, bias


@pytest.mark.parametrize("k,n", [(192, 128), (128, 192), (128, 100)])
def test_int8_matmul_fused_refuses_unaligned_dims_as_jax(rng, k, n):
    """Both wrappers refuse a K or N that is not a multiple of 128."""
    jax_args, torch_args, bias = _w8a8_inputs(rng, 8, k, n)
    with pytest.raises(ValueError, match="128-aligned dims"):
        jq.int8_matmul_fused(*jax_args, bias=jnp.asarray(bias), interpret=True)
    with pytest.raises(ValueError, match="128-aligned dims"):
        tq.int8_matmul_fused(*torch_args, bias=torch.from_numpy(bias))


def test_int8_matmul_fused_refuses_kmajor_of_wrong_shape(rng):
    _, torch_args, bias = _w8a8_inputs(rng, 8, 128, 256)
    w_q, bias = torch_args[1], torch.from_numpy(bias)
    with pytest.raises(ValueError, match="w_kmajor must be"):
        tq.int8_matmul_fused(*torch_args, bias=bias, w_kmajor=w_q)  # the (K, N) layout
    out = tq.int8_matmul_fused(*torch_args, bias=bias, w_kmajor=w_q.T.contiguous())
    assert torch.equal(out, tq.int8_matmul_fused_plain(*torch_args, bias=bias))


def test_int8_matmul_fused_plain_with_kmajor_equals_pallas(rng):
    """The plain version, called as the backbone calls the kernel (with the
    K-major copy), equals the Pallas kernel in interpret mode exactly at a
    ragged M and an N of three 128-wide tiles."""
    jax_args, torch_args, bias = _w8a8_inputs(rng, 45, 128, 384)
    ref = jq.int8_matmul_fused(*jax_args, bias=jnp.asarray(bias), out_dtype=jnp.float32, interpret=True)
    got = tq.int8_matmul_fused_plain(*torch_args, bias=torch.from_numpy(bias), out_dtype=torch.float32,
                                     w_kmajor=torch_args[1].T.contiguous())
    assert got.shape == (45, 384)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _rope_dense(rng, windows, tokens, hd, start, total):
    """bf16 x (windows, tokens, 256), a 256-wide dense's torch args and
    bias, and the V-JEPA rotary tables of tokens [start, start + tokens) of
    ``total`` (a sequence-parallel shard's slice when start > 0)."""
    from algonauts2025_tpu_torch.models.backbones import vjepa2 as tv

    _, (x, w_q, w_s, sx), bias = _w8a8_inputs(rng, windows * tokens, 256, 256)
    cos, sin = (torch.from_numpy(t[start:start + tokens]) for t in tv._rope_tables(total, hd, 64, 16))
    return (x.reshape(windows, tokens, 256), w_q, w_s, sx), torch.from_numpy(bias), (cos, sin)


@pytest.mark.parametrize("hd,start,total", [(64, 0, 48), (64, 48, 96), (32, 0, 48), (128, 16, 64)])
def test_int8_matmul_fused_rope_equals_dense_then_apply_rope(rng, hd, start, total):
    """The rotating dense (its plain version, and the wrapper on CPU
    tensors) equals the bf16 dense followed by the backbone's ``_apply_rope``
    bit for bit: two windows over tables of their tokens, full or sliced at
    a shard's token offset."""
    from algonauts2025_tpu_torch.models.backbones import vjepa2 as tv

    tokens = 48 if start != 16 else 32
    args, bias, (cos, sin) = _rope_dense(rng, 2, tokens, hd, start, total)
    dense = tq.int8_matmul_fused_plain(*args, bias=bias)
    heads = dense.reshape(2, tokens, 256 // hd, hd).transpose(1, 2)
    want = tv._apply_rope(heads, cos, sin).transpose(1, 2).reshape(dense.shape)
    plain = tq.int8_matmul_fused_plain(*args, bias=bias, rope=(cos, sin))
    wrapped = tq.int8_matmul_fused(*args, bias=bias, rope=(cos, sin), w_kmajor=args[1].T.contiguous())
    assert plain.dtype == wrapped.dtype == torch.bfloat16 and plain.shape == (2, tokens, 256)
    assert torch.equal(plain, want) and torch.equal(wrapped, want)
    assert not torch.equal(plain, dense)  # the tables rotate these tokens


@pytest.mark.parametrize("bad,error,match", [
    ("float64", TypeError, "must be float32"),
    ("strided", ValueError, "must be contiguous"),
    ("3-d", ValueError, "two \\(T, hd\\)"),
    ("sin shape", ValueError, "two \\(T, hd\\)"),
    ("T", ValueError, "T dividing M"),
    ("odd hd", ValueError, "even hd"),
    ("hd 96", ValueError, "dividing 128"),
    ("float32 out", TypeError, "output is bfloat16"),
])
def test_int8_matmul_fused_refuses_bad_rope_tables(rng, bad, error, match):
    """The wrapper checks the tables before it runs anything: fp32,
    contiguous, both (T, hd) with T dividing M and an even hd dividing 128,
    and a bf16 output."""
    args, bias, (cos, sin) = _rope_dense(rng, 2, 48, 64, 0, 48)
    out_dtype = torch.bfloat16
    if bad == "float64":
        cos = cos.double()
    elif bad == "strided":
        cos = torch.cat([cos, cos], dim=1)[:, ::2]
    elif bad == "3-d":
        cos, sin = cos[None], sin[None]
    elif bad == "sin shape":
        sin = sin[:, :32].contiguous()
    elif bad == "T":
        cos, sin = cos[:36].contiguous(), sin[:36].contiguous()
    elif bad == "odd hd":
        cos, sin = cos[:, :63].contiguous(), sin[:, :63].contiguous()
    elif bad == "hd 96":
        cos, sin = torch.ones(48, 96), torch.zeros(48, 96)
    else:
        out_dtype = torch.float32
    before = dict(tq.launch_counts)
    with pytest.raises(error, match=match):
        tq.int8_matmul_fused(*args, bias=bias, out_dtype=out_dtype, rope=(cos, sin))
    assert tq.launch_counts == before


def test_rope_gemm_is_row_6s_gemm_on_its_schedule():
    """w8a8.cu's rotating entry runs the dequantizing epilogue of row 6
    (StoreDequant by sx, bf16) inside StoreDequantRope, on the schedule
    ``INT8_GEMMS`` names for row 6, and refuses what its wrapper refuses."""
    text = (_cuda.CSRC / "w8a8.cu").read_text()
    epi = re.search(r"using Epi = (i8wg::StoreDequantRope<i8wg::StoreDequant<__nv_bfloat16, 0>>);", text)
    sched = re.findall(r"gemm<Epi, i8wg::(\w+)>", text)
    assert epi and sched == [tq.INT8_GEMMS["w8a8"]]
    assert "int w8a8_rope_forward(" in text and tq._W8A8_ROPE[:2] == ("w8a8", "w8a8_rope_forward")
    assert len(tq._W8A8_ROPE[2]) == len(tq._W8A8[2]) + 4  # the tables, T and hd
    assert "out_dtype != 1 || tokens < 1 || M % tokens || head_dim < 2 || head_dim > 128 || 128 % head_dim" in text


@pytest.mark.parametrize("mangled,want,gemm", [
    ("_ZN4i8wg11gemm_kernelINS_12StoreDequantI13__nv_bfloat16Li0EEENS_8PingPongEEEvNS_6ParamsEPKf",
     ("StoreDequantI13__nv_bfloat16Li0EE", "PingPong"), "w8a8"),
    ("_ZN4i8wg11gemm_kernelINS_16StoreDequantRopeINS_12StoreDequantI13__nv_bfloat16Li0EEEEENS_8PingPongEEEvNS_6Params"
     "ENT_4ArgsE", ("StoreDequantRope", "PingPong"), "w8a8"),
    ("_ZN4i8wg11gemm_kernelIN12_GLOBAL__N_114StoreGeluQuantENS_11CooperativeEEEvNS_6ParamsEPKf",
     ("StoreGeluQuant", "Cooperative"), "fc1"),
    ("_ZN4i8wg11gemm_kernelINS_12StoreDequantIfLi1EEEEEvNS_6ParamsEPKf", ("StoreDequantIfLi1EE", None), "fc2"),
    ("_ZN4i8wg11gemm_kernelINS_12StoreDequantIfLi0EEENS_8PingPongEEEvNS_6ParamsENT_4ArgsE",
     ("StoreDequantIfLi0EE", "PingPong"), "w8a8"),
    ("_ZN4i8wg11gemm_kernelINS_12StoreDequantI13__nv_bfloat16Li1EEENS_11CooperativeEEEvNS_6ParamsENT_4ArgsE",
     ("StoreDequantI13__nv_bfloat16Li1EE", "Cooperative"), "fc2"),
])
def test_gemm_instantiation_names(mangled, want, gemm):
    """``gemm_instantiation`` reads (epilogue, schedule) from a mangled
    ``gemm_kernel`` name, None for a core without schedules, and tells the
    rotating GEMM from the plain bf16 one it wraps; ``INT8_EPILOGUES`` names
    the GEMM of each epilogue, which gives the schedule chip_smoke.py's SASS
    and ptxas checks hold it to."""
    assert tq.gemm_instantiation(mangled) == want
    library = "w8a8" if gemm == "w8a8" else "int8_mlp"
    assert tq.INT8_EPILOGUES[library][want[0]] == gemm


def test_csrc_includes_resolve_and_the_dp4a_core_is_gone():
    """Every quoted #include of csrc/ names a file there, and no source
    names the deleted __dp4a core."""
    sources = sorted(_cuda.CSRC.glob("*.cu")) + sorted(_cuda.CSRC.glob("*.cuh"))
    assert {p.name for p in sources} >= {"w8a8.cu", "int8_mlp.cu", "int8_wgmma.cuh"}
    includes = {}
    for path in sources:
        text = path.read_text()
        assert "int8_gemm.cuh" not in text, path.name
        includes[path.name] = re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, flags=re.M)
        for name in includes[path.name]:
            assert (_cuda.CSRC / name).is_file(), (path.name, name)
    assert not (_cuda.CSRC / "int8_gemm.cuh").exists()
    assert includes["w8a8.cu"] == includes["int8_mlp.cu"] == ["int8_wgmma.cuh"]


def test_int8_matmul_fused_poisons_uncalibrated_scale(rng):
    _, xt = _bf16(rng, (32, 256))
    w_q, w_s = tq.quantize_weight(rng.standard_normal((256, 128)).astype(np.float32))
    out = tq.int8_matmul_fused(xt, w_q, w_s, torch.tensor(0.0), out_dtype=torch.float32)
    assert torch.isnan(out).all()
    out = tq.int8_matmul(xt, w_q, w_s, x_scale=torch.tensor(0.0))
    assert torch.isnan(out).all()


def _mlp_inputs(rng, m, k, f):
    xj, xt = _bf16(rng, (m, k))
    w1 = rng.standard_normal((k, f)).astype(np.float32) * 0.05
    w2 = rng.standard_normal((f, k)).astype(np.float32) * 0.05
    b1 = rng.standard_normal((f,)).astype(np.float32) * 0.1
    b2 = rng.standard_normal((k,)).astype(np.float32) * 0.1
    (w1q, s1), (w2q, s2) = jq.quantize_weight(w1), jq.quantize_weight(w2)
    sx = np.float32(np.abs(np.asarray(xj, np.float32)).max() / 127.0)
    jax_args = (xj, w1q, s1, jnp.asarray(b1), w2q, s2, jnp.asarray(b2))
    torch_args = (xt, *(torch.tensor(np.asarray(a)) for a in (w1q, s1, b1, w2q, s2, b2)))
    return jax_args, torch_args, sx


def test_int8_mlp_fused_plain_matches_pallas(rng):
    """Within the fused-MLP kernel's tolerance: relative L2 <= 1e-3 and
    max-abs <= 1e-2 max|ref|.  The gelu's exp differs between libraries
    in the last bit, which can flip rare int8 roundings of the hidden state."""
    jax_args, torch_args, sx = _mlp_inputs(rng, 96, 256, 512)
    sh = np.float32(0.02)
    ref = np.asarray(jq.int8_mlp_fused(*jax_args, jnp.float32(sx), jnp.float32(sh), bm=128,
                                       fchunk=256, out_dtype=jnp.float32, interpret=True))
    got = tq.int8_mlp_fused(*torch_args, torch.tensor(sx), torch.tensor(sh),
                            out_dtype=torch.float32).numpy()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= 1e-3, rel
    assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("bad", ["x", "h"])
def test_int8_mlp_fused_couples_poisoning(rng, bad):
    _, torch_args, sx = _mlp_inputs(rng, 32, 256, 128)
    scales = {"x": torch.tensor(sx), "h": torch.tensor(0.02)}
    scales[bad] = torch.tensor(0.0)
    out = tq.int8_mlp_fused(*torch_args, scales["x"], scales["h"], out_dtype=torch.float32)
    assert torch.isnan(out).all()


def test_gelu_erf_approx_matches_jax():
    x = np.linspace(-8, 8, 4097, dtype=np.float32)
    ref = np.asarray(jq._gelu_erf_approx(jnp.asarray(x)))
    got = tq.gelu_erf_approx(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - exact).max() < 2e-6


def test_quant_dense_apply_matches_jax(rng):
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    jp, tp_ = jq.quantize_dense_params({"kernel": w, "bias": b}), tq.quantize_dense_params(
        {"kernel": w, "bias": b})
    a_scale = np.float32(np.abs(x).max() / 127.0)
    ref = jq.QuantDense.apply({**jp, "a_scale": jnp.float32(a_scale)}, jnp.asarray(x),
                              out_dtype=jnp.float32)
    got = tq.QuantDense.apply({**tp_, "a_scale": torch.tensor(a_scale)}, torch.from_numpy(x),
                              out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # the uncalibrated sentinel poisons; a dict without a_scale quantizes dynamically
    assert torch.isnan(tq.QuantDense.apply(tp_, torch.from_numpy(x))).all()
    dyn = {k: v for k, v in tp_.items() if k != "a_scale"}
    assert torch.isfinite(tq.QuantDense.apply(dyn, torch.from_numpy(x))).all()


def test_calibrate_quant_scales_matches_jax():
    """One observed forward gives the same a_scale per dense and layer."""
    from algonauts2025_tpu.models.backbones.vjepa2 import VJEPA2Backbone, VJEPA2Config
    from algonauts2025_tpu_torch.models import vjepa2_params_to_torch
    from algonauts2025_tpu_torch.models.backbones import vjepa2 as tv

    kw = dict(crop_size=32, patch_size=16, tubelet_size=2, frames_per_clip=4, hidden_size=64,
              num_layers=2, num_heads=4, mlp_ratio=2.0, quantize=True)
    model = VJEPA2Backbone(VJEPA2Config(dtype=jnp.float32, **kw), token_pool=True)
    pixels = np.random.default_rng(1).uniform(size=(2, 4, 32, 32, 3)).astype(np.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(pixels))["params"]
    ref = jq.calibrate_quant_scales(model.apply, params, jnp.asarray(pixels), margin=1.5)

    port = tv.VJEPA2Backbone(tv.VJEPA2Config(dtype=torch.float32, **kw), token_pool=True)
    port.load_state_dict(vjepa2_params_to_torch(params))
    tq.calibrate_quant_scales(port, torch.from_numpy(pixels), margin=1.5)
    want = {k: v for k, v in vjepa2_params_to_torch(ref).items() if k.endswith("a_scale")}
    got = {k: v for k, v in port.state_dict().items() if k.endswith("a_scale")}
    assert set(got) == set(want) and len(got) == 12
    for key in want:
        assert float(got[key]) > 0
        # the same activations up to fp32 summation order
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-5, err_msg=key)


def test_kernel_wrappers_refuse_cpu_tensors_for_the_kernel(rng):
    """The CUDA path of each wrapper checks its inputs before any launch: a
    CPU tensor never reaches the kernel (it runs the plain version instead)."""
    x = torch.zeros((4, 128))
    w_q, w_s = tq.quantize_weight(rng.standard_normal((128, 128)).astype(np.float32))
    with pytest.raises(ValueError, match="not a CUDA device"):
        _cuda.check_cuda("w8a8", contiguous=True, x=x)
    before = dict(tq.launch_counts)
    tq.int8_matmul_fused(x, w_q, w_s, 1.0)
    assert tq.launch_counts == before


def _kmajor_backbones():
    """A small quantized JAX V-JEPA2 with two parameter draws, and the
    port's backbone of the same configuration."""
    from algonauts2025_tpu.models.backbones.vjepa2 import VJEPA2Backbone, VJEPA2Config
    from algonauts2025_tpu_torch.models.backbones import vjepa2 as tv

    kw = dict(crop_size=32, patch_size=16, tubelet_size=2, frames_per_clip=4, hidden_size=128,
              num_layers=2, num_heads=4, mlp_ratio=2.0, quantize=True)
    model = VJEPA2Backbone(VJEPA2Config(dtype=jnp.float32, **kw), token_pool=True)
    pixels = jnp.zeros((1, 4, 32, 32, 3), jnp.float32)
    params = [model.init(jax.random.PRNGKey(seed), pixels)["params"] for seed in (0, 1)]
    port = tv.VJEPA2Backbone(tv.VJEPA2Config(dtype=torch.float32, **kw), token_pool=True)
    return params, port, tv._QDense


def test_kernel_q_kmajor_follows_every_weight_load():
    """The K-major copy the fused MLP kernel reads equals kernel_q.T after
    init_random, after load_state_dict of the JAX params, after a second
    load and after an in-place write, and is kept while nothing changes."""
    from algonauts2025_tpu_torch.models import vjepa2_params_to_torch

    params, port, qdense = _kmajor_backbones()
    denses = [m for m in port.modules() if isinstance(m, qdense)]
    assert len(denses) == 12

    def held() -> list[torch.Tensor]:
        copies = []
        for m in denses:
            km = m.kernel_q_kmajor()
            assert km.dtype == torch.int8 and km.is_contiguous()
            assert km.shape == (m.features, m.in_features) and torch.equal(km, m.kernel_q.T)
            assert m.kernel_q_kmajor() is km
            copies.append(km.clone())
        return copies

    port.init_random(torch.Generator().manual_seed(0))
    seen = [held()]
    for p in params:
        port.load_state_dict(vjepa2_params_to_torch(p))
        seen.append(held())
    with torch.no_grad():
        denses[0].kernel_q.neg_()
    seen.append(held())
    # each load really changed the weights, so a stale copy would have failed
    for before, after in zip(seen, seen[1:]):
        assert any(not torch.equal(a, b) for a, b in zip(before, after))


@pytest.mark.parametrize("k,f", [(192, 256), (256, 192), (128, 100)])
def test_int8_mlp_fused_refuses_unaligned_dims(rng, k, f):
    _, torch_args, sx = _mlp_inputs(rng, 8, k, f)
    with pytest.raises(ValueError, match="128-aligned dims"):
        tq.int8_mlp_fused(*torch_args, torch.tensor(sx), torch.tensor(0.02))


@pytest.mark.parametrize("which", ["w1_kmajor", "w2_kmajor"])
def test_int8_mlp_fused_refuses_kmajor_of_wrong_shape(rng, which):
    _, torch_args, sx = _mlp_inputs(rng, 8, 128, 256)
    w1_q, w2_q = torch_args[1], torch_args[4]
    good = {"w1_kmajor": w1_q.T.contiguous(), "w2_kmajor": w2_q.T.contiguous()}
    bad = {**good, which: {"w1_kmajor": w1_q, "w2_kmajor": w2_q}[which]}  # the (K, N) layout
    with pytest.raises(ValueError, match=f"{which} must be"):
        tq.int8_mlp_fused(*torch_args, torch.tensor(sx), torch.tensor(0.02), **bad)
    out = tq.int8_mlp_fused(*torch_args, torch.tensor(sx), torch.tensor(0.02), **good)
    assert torch.equal(out, tq.int8_mlp_fused_plain(*torch_args, torch.tensor(sx), torch.tensor(0.02)))


def test_int8_mlp_fused_plain_with_kmajor_matches_pallas(rng):
    """The plain version, called as the backbone calls the kernel (with the
    K-major copies), against the Pallas kernel in interpret mode at a
    ragged M and an F of three 128-wide tiles; limits as above."""
    jax_args, torch_args, sx = _mlp_inputs(rng, 45, 128, 384)
    sh = np.float32(0.02)
    ref = np.asarray(jq.int8_mlp_fused(*jax_args, jnp.float32(sx), jnp.float32(sh), bm=128,
                                       fchunk=128, out_dtype=jnp.float32, interpret=True))
    got = tq.int8_mlp_fused_plain(*torch_args, torch.tensor(sx), torch.tensor(sh), torch.float32,
                                  w1_kmajor=torch_args[1].T.contiguous(),
                                  w2_kmajor=torch_args[4].T.contiguous()).numpy()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= 1e-3, rel
    assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()


# ---- the int8 GEMM core's block (csrc/int8_wgmma.cuh) and its fast epilogue ----

_CORE = (_cuda.CSRC / "int8_wgmma.cuh").read_text()


@pytest.mark.parametrize("gemm", sorted(tq.INT8_GEMMS))
def test_gemm_block_fits_shared_memory(gemm):
    """The A and Bt rings, the two staged output pieces of each consumer
    warpgroup, the mbarriers and the alignment slack fit the 227 KB a block
    may use; every ring slot and output piece starts on a 1024-byte boundary
    of the 128-byte swizzle, and TMA's boxes are at most 256 rows."""
    from algonauts2025_tpu_torch.ops.flash_attention import SM90_MAX_SMEM

    block = tq.gemm_block(gemm)
    assert block["smem_bytes"] <= SM90_MAX_SMEM
    assert block["tile_m"] * block["stage_k"] % 1024 == 0 and block["tile_n"] * block["stage_k"] % 1024 == 0
    assert block["staging_bytes"] % 1024 == 0 and max(block["tile_m"], block["tile_n"]) <= 256
    assert block["stage_k"] == 128 and block["tile_n"] % 128 == 0


@pytest.mark.parametrize("gemm", sorted(tq.INT8_GEMMS))
def test_gemm_block_register_budget(gemm):
    """The setmaxnreg split (consumer warpgroups x 128 x their registers +
    128 x the producer's) fits the 65,536 registers of an SM and the
    registers the block holds at launch; a consumer thread holds the int32
    accumulators of its rows of a tile with 48 registers or more to spare for
    the epilogue; each count is one setmaxnreg takes."""
    from algonauts2025_tpu_torch.ops.flash_attention import SM90_REGISTERS

    block = tq.gemm_block(gemm)
    split = 128 * block["warpgroups"] * block["consumer_regs"] + 128 * block["producer_regs"]
    assert split <= SM90_REGISTERS and split <= block["threads"] * block["launch_regs"]
    assert block["threads"] == 128 * (block["warpgroups"] + 1)
    for regs in (block["consumer_regs"], block["producer_regs"]):
        assert 24 <= regs <= 256 and regs % 8 == 0
    assert block["producer_regs"] <= block["launch_regs"] <= block["consumer_regs"]
    assert block["rows"] * block["tile_n"] // 128 == block["acc_regs"] <= block["consumer_regs"] - 48
    assert block["warpgroups"] // block["team"] in (1, 2) and block["rows"] in (64, 128)


def test_gemm_block_mirrors_the_kernel_source():
    """``gemm_block`` is the Python mirror of ``i8wg``'s constants and
    schedules, and ``INT8_GEMMS`` names the schedule each GEMM of w8a8.cu
    and int8_mlp.cu is instantiated with."""
    consts = dict(re.findall(r"^constexpr int (k\w+) = ([^;]+);", _CORE, re.M))
    block = tq.gemm_block("fc1")
    assert int(consts["kBM"]) == block["tile_m"] and int(consts["kBK"]) == block["stage_k"]
    assert int(consts["kProducerRegs"]) == block["producer_regs"]
    assert consts["kChunkBytes"] == "64 * 128"
    found = {name: tuple(int(x) for x in args.split(","))
             for name, args in re.findall(r"^struct (\w+) : Schedule<([\d, ]+)> \{\};", _CORE, re.M)}
    assert found == tq._SCHEDULES
    kernels = {"w8a8": (_cuda.CSRC / "w8a8.cu").read_text(), "int8_mlp": (_cuda.CSRC / "int8_mlp.cu").read_text()}
    calls = [(lib, epi, sched) for lib, text in kernels.items()
             for epi, sched in re.findall(r"gemm<(StoreGeluQuant|i8wg::StoreDequant<[^>]+>), i8wg::(\w+)>", text)]
    gemm_of = {("w8a8", "0"): "w8a8", ("int8_mlp", "1"): "fc2"}
    got = {}
    for lib, epi, sched in calls:
        gemm = "fc1" if epi == "StoreGeluQuant" else gemm_of[lib, epi[-2]]
        got.setdefault(gemm, set()).add(sched)
    assert got == {gemm: {sched} for gemm, sched in tq.INT8_GEMMS.items()}
    assert len(calls) == 5  # one per epilogue: w8a8 fp32 / bf16, fc1, fc2 fp32 / bf16


def test_gemm_l2_read_bytes():
    """A tile reads its A row panel and its B column panel once: at ViT-G
    the 128 x 128 tiles of the parent design read 1.015 GB (row 6) and
    4.429 GB (fc1, fc2) from L2; a 256-wide tile past N reads no B beyond N."""
    m, d, f = 32768, 1408, 6144
    assert tq.gemm_l2_read_bytes(m, d, d, 128, 128) == m * d * 11 + d * d * 256 == 1_015_021_568
    assert tq.gemm_l2_read_bytes(m, f, d, 128, 128) == tq.gemm_l2_read_bytes(m, d, f, 128, 128) == 4_429_185_024
    assert tq.gemm_l2_read_bytes(m, d, f, 128, 256) == m * f * 6 + d * f * 256
    assert tq.gemm_l2_read_bytes(1, 128, 128, 128, 256) == 128 + 128 * 128


# a numpy float32 mirror of the rounding of int8_wgmma.cuh's quantize

_MAGIC = np.float32(12582912.0)  # 1.5 * 2^23


def _quantize_rint_magic(c):
    """``i8wg::quantize``'s rounding of a clamped value: one float addition of
    1.5 * 2^23, then the low bits of the sum."""
    t = (np.asarray(c, np.float32) + _MAGIC).astype(np.float32)
    return t.view(np.int32) - 0x4B400000, t


def test_quantize_rounding_by_one_addition_is_rint():
    """clamp then one addition of 1.5 * 2^23 is rint then clamp, bit for bit,
    over every float32 in [-128, 128] near the half-integers and a dense
    sweep between them; NaN goes to -127 both ways."""
    halves = np.arange(-128, 128, dtype=np.float32) + np.float32(0.5)
    near = [np.nextafter(halves, np.float32(np.inf * d)) for d in (1, -1)]
    c = np.concatenate([halves, *near, np.linspace(-200, 200, 2_000_001, dtype=np.float32),
                        np.float32([0.0, -0.0, np.nan, np.inf, -np.inf])])
    ref = np.fmin(np.fmax(np.rint(c), np.float32(-127)), np.float32(127))
    got, _ = _quantize_rint_magic(np.fmin(np.fmax(c, np.float32(-127)), np.float32(127)))
    ref = np.where(np.isnan(ref), np.float32(-127), ref)
    np.testing.assert_array_equal(got, ref.astype(np.int32))
