"""The port's flash attention (ops/flash_attention.py) against the JAX
package's, on the CPU.

On CPU tensors ``flash_attention`` runs the kernels' plain versions; the
JAX ``_bounded_kernel`` and ``_flash_kernel`` run in interpret mode, as
tests/test_ops.py runs them.  The CUDA kernels are held against the plain
versions on the card by chip_smoke.py; what of them the CPU can check is
here too: the TMA layout contract of the bf16 kernel against the layouts
of its callers, and the source lines chip_smoke.py's mutants patch.
"""

import re
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from algonauts2025_tpu.ops.attention import dot_product_attention as jax_dpa
from algonauts2025_tpu.ops.flash_attention import flash_attention as jax_flash
from algonauts2025_tpu_torch.models.backbones import llama, vjepa2
from algonauts2025_tpu_torch.ops import _cuda
from algonauts2025_tpu_torch.ops import flash_attention as tf
from algonauts2025_tpu_torch.scripts import flash_levers
from algonauts2025_tpu_torch.scripts import kernel_tools as kt
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


def _captured(module, target: str, run) -> tuple:
    """The (q, k, v) that ``run()`` hands to ``module.target``."""
    seen = []

    def capture(q, k, v, *rest):
        seen.append((q, k, v))
        return q

    with torch.no_grad(), mock.patch.object(module, target, capture):
        run()
    return seen[0]


def _vitg_qkv():
    """One ViT-G attention at its full width (22 heads of 64) over 16 tokens."""
    attn = vjepa2.VJEPA2Attention(vjepa2.VJEPA2_VITG, device="cpu")
    x = torch.randn((2, 16, 1408)).to(vjepa2.VJEPA2_VITG.dtype)
    rope = (torch.ones((16, 64)), torch.zeros((16, 64)))
    return _captured(vjepa2, "_attention", lambda: attn(x, rope))


def _llama_qkv():
    """One Llama-3.2-3B attention at its full width (24 query heads over 8
    kv heads of 128) over 16 tokens."""
    cfg = llama.LLAMA_3P2_3B
    attn = llama.LlamaAttention(cfg, device="cpu")
    x = torch.randn((2, 16, cfg.hidden_size)).to(cfg.dtype)
    cos, sin = torch.ones((2, 16, cfg.head_dim)), torch.zeros((2, 16, cfg.head_dim))
    return _captured(llama, "_decoder_attention", lambda: attn(x, cos, sin, None, torch.tensor([16, 9])))


def _chip_smoke_qkv(shape, strided, scale=1.0):
    """chip_smoke.qkv as check_flash / check_fast / check_packed use it."""
    q, k, v = chip_smoke.qkv(shape, torch.float32, strided, torch.Generator().manual_seed(0), device="cpu")
    return (q * scale).to(torch.bfloat16), (k * scale).to(torch.bfloat16), v.to(torch.bfloat16)


#: the bf16 callers of the flash kernels, each giving (q, k, v) as it hands
#: them over, at full width where the caller is a model
CALLERS = {
    "vitg": _vitg_qkv,
    "llama": _llama_qkv,
    "bench": lambda: [x[:1, :2] for x in (torch.randn((4, 22, 64, 64)).to(torch.bfloat16) for _ in range(3))],
    "chip_smoke_qkv_strided": lambda: _chip_smoke_qkv((4, 22, 40, 64), True),
    "chip_smoke_qkv_strided_d96": lambda: _chip_smoke_qkv((2, 3, 40, 96), True),
    "chip_smoke_qkv_x30": lambda: _chip_smoke_qkv((1, 2, 40, 64), False, 30.0),
    "chip_smoke_qkv_d32": lambda: chip_smoke.qkv((2, 3, 40, 32), torch.bfloat16, False,
                                                 torch.Generator().manual_seed(0), device="cpu"),
    "chip_smoke_masked_qkv": lambda: chip_smoke.masked_qkv((8, 24, 40, 128), 8, torch.bfloat16,
                                                           torch.Generator().manual_seed(0), device="cpu"),
    "chip_smoke_masked_qkv_d96": lambda: chip_smoke.masked_qkv((2, 6, 40, 96), 2, torch.bfloat16,
                                                               torch.Generator().manual_seed(0), device="cpu"),
}


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_tma_layout_takes_every_caller(caller):
    """Every bf16 caller's q, k and v meet the layout that TMA reads."""
    for name, x in zip("qkv", CALLERS[caller]()):
        assert x.dtype == torch.bfloat16 and x.dim() == 4 and x.stride(-1) == 1
        tf.check_tma_layout(name, x.shape, x.stride(), x.data_ptr(), x.element_size())


@pytest.mark.parametrize("strides,offset,match", [
    ((3 * 16 * 68, 16 * 68, 68, 1), 0, "k's t stride 68 is not a multiple of 8 elements"),
    ((4096, 1028, 64, 1), 0, "k's h stride 1028"),
    ((3076, 1024, 64, 1), 0, "k's b stride 3076"),
    ((3 * 1024, 1024, 64, 1), 4, "k starts at .* not on a 16-byte boundary"),
])
def test_tma_layout_refuses_unaligned_views(strides, offset, match):
    x = torch.zeros(8192, dtype=torch.bfloat16).as_strided((2, 3, 16, 64), strides, offset)
    with pytest.raises(ValueError, match=match):
        tf.check_tma_layout("k", x.shape, x.stride(), x.data_ptr(), x.element_size())


def test_tma_layout_ignores_strides_of_size_one_dims():
    x = torch.zeros(8192, dtype=torch.bfloat16).as_strided((1, 1, 16, 64), (5, 3, 64, 1))
    tf.check_tma_layout("q", x.shape, x.stride(), x.data_ptr(), x.element_size())


@pytest.mark.parametrize("mutant", sorted(chip_smoke.MUTANTS))
def test_mutant_line_occurs_once_in_the_source(mutant, tmp_path):
    """chip_smoke.py builds each mutant by replacing one line of the flash
    source (``kernel_tools.write_patched``); the line must be there exactly
    once, or the build fails."""
    line, patched = chip_smoke.MUTANTS[mutant]
    source = _cuda.CSRC / "flash_attention.cu"
    assert kt.write_patched({source.name: source}, [(source.name, line, patched)], tmp_path) == []
    assert (tmp_path / source.name).read_text() == source.read_text().replace(line, patched)


TC_INSTANTIATIONS = tf.TC_INSTANTIATIONS


@pytest.mark.parametrize("head_dim,masked,bf16_scores", TC_INSTANTIATIONS)
def test_tc_block_fits_shared_memory(head_dim, masked, bf16_scores):
    """The q tile, the K/V ring, the mbarriers and the alignment slack fit
    the 227 KB a block may use; the tiles start on the 1024-byte boundaries
    of the 128-byte swizzle, and TMA's q box (one row per query) is at most
    256 rows."""
    block = tf.tc_block(head_dim, bool(masked))
    assert block["smem_bytes"] <= tf.SM90_MAX_SMEM
    assert block["rows"] == 64 * block["warpgroups"] <= 256
    assert block["rows"] * 128 % 1024 == 0 and 128 * head_dim * 2 % 1024 == 0


@pytest.mark.parametrize("head_dim,masked,bf16_scores", TC_INSTANTIATIONS)
def test_tc_block_register_budget(head_dim, masked, bf16_scores):
    """The setmaxnreg split (consumers x 128 x their registers + 128 x the
    producer's) fits the 65,536 registers of an SM and the registers the
    block holds at launch; each count is one setmaxnreg takes."""
    block = tf.tc_block(head_dim, bool(masked))
    split = 128 * block["warpgroups"] * block["consumer_regs"] + 128 * block["producer_regs"]
    assert split <= tf.SM90_REGISTERS
    assert split <= block["threads"] * block["launch_regs"]
    assert block["threads"] == 128 * (block["warpgroups"] + 1)
    for regs in (block["consumer_regs"], block["producer_regs"]):
        assert 24 <= regs <= 256 and regs % 8 == 0
    assert block["producer_regs"] <= block["launch_regs"] <= block["consumer_regs"]


def test_tc_block_mirrors_the_kernel_source():
    """``tc_block`` is the Python mirror of ``tc::Block`` in the source: the
    per-head-dim constants and the q slots agree."""
    source = (_cuda.CSRC / "flash_attention.cu").read_text()
    found = {name: (int(a), int(b)) for name, a, b in
             re.findall(r"static constexpr int (k\w+) = kD == 64 \? (\d+) : (\d+);", source)}
    keys = {"kWarpgroups": "warpgroups", "kStages": "stages", "kConsumerRegs": "consumer_regs",
            "kProducerRegs": "producer_regs"}
    assert set(found) == set(keys)
    for name, key in keys.items():
        assert (tf.tc_block(64)[key], tf.tc_block(128)[key]) == found[name]
    slots = re.findall(r"static constexpr int kQSlots = (\d+);", source)
    assert [int(n) for n in slots] == [tf.tc_block(64)["q_slots"]] == [tf.tc_block(128)["q_slots"]]


@pytest.mark.parametrize("head_dim", [1, 32, 64, 65, 96, 128])
def test_tc_block_runs_head_dims_at_64_or_128(head_dim):
    assert tf.tc_block(head_dim)["head_dim"] == (64 if head_dim <= 64 else 128)


@pytest.mark.parametrize("head_dim", [0, 129])
def test_tc_block_refuses_head_dims_the_kernel_does_not_take(head_dim):
    with pytest.raises(ValueError, match="head dims 1..128"):
        tf.tc_block(head_dim)


@pytest.mark.parametrize("lever", sorted(flash_levers.LEVERS))
def test_lever_registers_follow_its_block(lever):
    """scripts/flash_levers.py launches a lever's build only if ptxas gave
    it the registers its setmaxnreg split assumes: tc_block's, or, for the
    lever with two consumer warpgroups at d = 64, those of that block."""
    regs = {d: flash_levers.launch_regs(lever, (d, 0, 0)) for d in (64, 128)}
    assert regs[128] == tf.tc_block(128)["launch_regs"] == 168
    assert regs[64] == (tf.tc_launch_regs(128 * 3) if lever == flash_levers.TWO_WARPGROUPS else
                        tf.tc_block(64)["launch_regs"])


def test_levers_leave_out_what_the_source_lacks(tmp_path):
    """A lever whose lines the source no longer holds is left out rather
    than failing the run; a baseline source is built as it is."""
    source = (_cuda.CSRC / "flash_attention.cu").read_text()
    lever = "items in plain rounds (block i takes items i, i + gridDim.x, ...)"
    (_, old, new), = flash_levers.LEVERS[lever]
    (tmp_path / "flash_attention.cu").write_text(source.replace(old, new))
    baseline = tmp_path / "parent.cu"
    baseline.write_text("// another version\n")
    with mock.patch.object(kt._cuda, "CSRC", tmp_path):
        folders = kt.write_builds(flash_levers.FAMILY, kt._baselines(flash_levers.FAMILY, [f"parent={baseline}"]),
                                  tmp_path / "builds")
    assert set(folders) == set(flash_levers.LEVERS) - {lever} | {"parent"}
    assert (folders["parent"] / "flash_attention.cu").read_text() == "// another version\n"
    assert (folders["as built"] / "flash_attention.cu").read_text() == (tmp_path / "flash_attention.cu").read_text()


@pytest.mark.parametrize("spec", ["parent", "={source}", "parent={missing}", "as built={source}"])
def test_levers_refuse_a_bad_baseline(spec, tmp_path):
    """--baseline takes NAME=PATH of an existing file, under a name that is
    not a lever's; the check comes before any build."""
    (tmp_path / "a.cu").write_text("// another version\n")
    spec = spec.format(source=tmp_path / "a.cu", missing=tmp_path / "missing.cu")
    with pytest.raises(SystemExit, match="--baseline takes NAME=PATH"):
        flash_levers.main(["--baseline", spec])
