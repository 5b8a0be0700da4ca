"""The relative-key attention of w2v-BERT (``ops.flash_attention.relkey_attention``)
on the CPU: its plain version against the arithmetic the backbone ran
before the kernel, the backbone's CPU forward, the Python mirrors of the
kernel's block and band tiles, the decoder of its name, the wrapper's
refusals, the mutants of ``chip_smoke.py`` and the benchmark's reader of
its roofline.  The kernel itself runs on the card
(``test_torch_relkey_card.py``, ``chip_smoke.py``)."""

import re
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from algonauts2025_tpu_torch.models.backbones import wav2vec_bert as tw
from algonauts2025_tpu_torch.ops import _cuda
from algonauts2025_tpu_torch.ops import flash_attention as tf
from algonauts2025_tpu_torch.scripts import kernel_tools as kt
from benchmark.harness import load_module

ROOT = Path(__file__).resolve().parent.parent
RECORDED = Path(__file__).parent / "fixtures" / "kernels"


def _parent_attention(qf, k, v, table, attn_bias, rel_index, dtype):
    """The score pipeline of ``RelKeyAttention.forward`` before the kernel,
    line for line, over (B, H, T, hd) heads."""
    hd = qf.shape[-1]
    scores = torch.matmul(qf, k.float().transpose(-1, -2)) / hd**0.5
    qd = torch.matmul(qf, table.float().T)
    rel = torch.take_along_dim(qd, rel_index[None, None], dim=-1)
    scores = scores + rel / hd**0.5
    if attn_bias is not None:
        scores = scores + attn_bias
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.matmul(probs, v)


def _pad_mask(lengths, t):
    return torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]


@pytest.mark.parametrize("lengths", [None, (90, 57)])
@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64), (torch.float32, 32)])
def test_plain_is_the_parents_arithmetic(lengths, dtype, hd):
    """``relkey_attention_plain`` gives, bit for bit, what the backbone
    computed before: the bias from the (T, T) index and the (B, 1, 1, T)
    -1e30 key bias of a right-padded mask, at T = 90 (not a multiple of 64)."""
    gen = torch.Generator().manual_seed(3)
    b, h, t = 2, 3, 90
    q, k, v = (torch.randn((b, t, h, hd), generator=gen).to(dtype).transpose(1, 2) for _ in range(3))
    table = 0.3 * torch.randn((73, hd), generator=gen)
    attn_bias = None
    if lengths is not None:
        attn_bias = torch.where(_pad_mask(lengths, t)[:, None, None, :], 0.0, -1e30)
    want = _parent_attention(q.float(), k, v, table, attn_bias, tw.relative_positions(t, 64, 8), dtype)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    got = tf.relkey_attention_plain(q, k, v, table, lens, 64, 8)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(tf.relkey_attention(q, k, v, table, lens, 64, 8), want)  # CPU tensors take the plain version


def _parent_forward(model: tw.Wav2VecBertBackbone, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``Wav2VecBertBackbone.forward`` before the kernel: the (B, 1, 1, T)
    key bias and the (T, T) index built once, the parent's attention."""
    cfg = model.cfg
    x = model.fp_projection(tw._layer_norm(feats, model.fp_layer_norm, cfg.dtype))
    b, t, _ = x.shape
    pad_mask = mask.bool()
    x = torch.where(pad_mask[..., None], x, 0.0)
    attn_bias = torch.where(pad_mask[:, None, None, :], 0.0, -1e30)
    rel_index = tw.relative_positions(t, cfg.left_max_pos, cfg.right_max_pos)
    states = [x]
    for layer in model.layers:
        x = x + 0.5 * layer.ffn1(tw._layer_norm(x, layer.ffn1_layer_norm, cfg.dtype))
        a = tw._layer_norm(x, layer.self_attn_layer_norm, cfg.dtype)
        attn = layer.self_attn
        h, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        q, k, v = (m(a).reshape(b, t, h, hd).transpose(1, 2) for m in (attn.linear_q, attn.linear_k, attn.linear_v))
        out = _parent_attention(q.float(), k, v, attn.distance_embedding, attn_bias, rel_index, cfg.dtype)
        x = x + attn.linear_out(out.transpose(1, 2).reshape(b, t, cfg.hidden_size))
        x = x + layer.conv_module(x, pad_mask)
        x = x + 0.5 * layer.ffn2(tw._layer_norm(x, layer.ffn2_layer_norm, cfg.dtype))
        x = tw._layer_norm(x, layer.final_layer_norm, cfg.dtype)
        states.append(x)
    return torch.stack(states).float()


@pytest.mark.parametrize("dtype,heads", [(torch.bfloat16, 2), (torch.float32, 4)])
def test_cpu_forward_is_the_parents_and_launches_nothing(dtype, heads):
    """The backbone's CPU forward (right-padded mask; head dim 64 in bf16,
    the kernel's configuration, and 32 in fp32) equals the forward before
    the kernel bit for bit, and launches no kernel."""
    cfg = tw.Wav2VecBertConfig(hidden_size=128, num_layers=2, num_heads=heads, intermediate_size=256,
                               conv_kernel_size=7, dtype=dtype)
    model = tw.Wav2VecBertBackbone(cfg, device="cpu").init_random(torch.Generator().manual_seed(5))
    feats = torch.randn((2, 90, cfg.input_dim), generator=torch.Generator().manual_seed(6))
    mask = _pad_mask((90, 57), 90)
    before = dict(tf.launch_counts)
    with torch.no_grad():
        got = model(feats, attention_mask=mask)
        want = _parent_forward(model, feats, mask)
    assert torch.equal(got, want)
    assert tf.launch_counts == before


@pytest.mark.parametrize("left,right", [(64, 8), (5, 3), (0, 3), (70, 9)])
def test_band_tiles_match_the_distances_of_every_tile(left, right):
    """``relkey_tile_kind`` (``rk::tile_kind``) against a brute-force clamp
    of r - l over every (64-row, 128-key) tile of T up to 1,100: "left" and
    "right" exactly where every score of the tile takes the first or the
    last q.E value, "band" elsewhere."""
    for q0 in range(0, 1100, 64):
        rows = np.arange(q0, q0 + 64)[:, None]
        for k0 in range(0, 1100, 128):
            dist = np.clip(np.arange(k0, k0 + 128)[None, :] - rows, -left, right)
            want = "left" if (dist == -left).all() else "right" if (dist == right).all() else "band"
            assert tf.relkey_tile_kind(q0, k0, left, right) == want, (q0, k0)


def test_relkey_block_fits_shared_memory_and_the_register_file():
    """The block's q slots, K/V ring, table, q.E rows, mbarriers and slack
    fit the 227 KB a block may use; its tiles start on 1024-byte bounds; the
    setmaxnreg split fits the registers the block holds at launch."""
    block = tf.relkey_block()
    assert block["smem_bytes"] <= tf.SM90_MAX_SMEM
    assert block["rows"] == 64 * block["warpgroups"] <= 256 and block["rows"] * 128 % 1024 == 0
    assert block["threads"] == 128 * (block["warpgroups"] + 1)
    split = 128 * block["warpgroups"] * block["consumer_regs"] + 128 * block["producer_regs"]
    assert split <= tf.SM90_REGISTERS and split <= block["threads"] * block["launch_regs"]
    for regs in (block["consumer_regs"], block["producer_regs"]):
        assert 24 <= regs <= 256 and regs % 8 == 0
    assert block["max_pos"] >= 73  # w2v-BERT 2.0's table: 64 + 8 + 1 distances


def test_relkey_block_mirrors_the_kernel_source():
    """``relkey_block`` is the Python mirror of ``namespace rk``'s constants."""
    source = (_cuda.CSRC / "flash_attention.cu").read_text()
    rk = source[source.index("namespace rk {"):source.index("}  // namespace rk")]
    found = dict((name, int(n)) for name, n in re.findall(r"^constexpr int (k\w+) = (\d+);$", rk, re.M))
    block = tf.relkey_block()
    assert found == {"kGroups": block["warpgroups"], "kConsumerRegs": block["consumer_regs"],
                     "kProducerRegs": block["producer_regs"], "kSlots": block["q_slots"],
                     "kRing": block["stages"], "kMaxPos": block["max_pos"]}


def test_sass_digest_reads_instructions_only():
    """``kernel_tools.sass_digest``: the same instructions under other
    headers and blanks share a digest; one changed instruction does not."""
    body = ("_Z3foov\n.headerflags @\"EF_CUDA_SM90\"\n"
            "        /*0000*/    LDC R1, c[0x0][0x28] ;    /* 0x00000a00ff017b82 */\n"
            "                                              /* 0x000fe20000000800 */\n"
            "        /*0010*/    EXIT ;                    /* 0x000000000000794d */\n")
    other_headers = body.replace(".headerflags @\"EF_CUDA_SM90\"", "\t.section .text").replace("    ", "\t")
    assert kt.sass_digest(other_headers) == kt.sass_digest(body)
    assert kt.sass_digest(body.replace("c[0x0][0x28]", "c[0x0][0x30]")) != kt.sass_digest(body)


def test_the_recorded_tc_sass_digests_cover_the_six_instantiations():
    """``chip_smoke.TC_SASS_DIGESTS`` holds one sha256 for each of the six
    ``TC_INSTANTIATIONS``, under the names of the recorded build."""
    text = chip_smoke.TC_SASS_DIGESTS.read_text()
    digests = chip_smoke.tc_sass_digests(text)
    assert sorted(digests) == sorted(tf.TC_INSTANTIATIONS)
    assert all(re.fullmatch(r"[0-9a-f]{64}", d) for d in digests.values())
    report = (RECORDED / "flash_attention.ptxas.txt").read_text()
    names = set(re.findall(r"Compiling entry function '(\w*flash_tc_kernel\w*)'", report))
    assert {line.split()[1] for line in text.splitlines() if line and not line.startswith("#")} == names


def test_relkey_instantiation_decodes_the_recorded_names():
    """The recorded build holds one ``flash_relkey_kernel``, decoded to
    ``RELKEY_INSTANTIATIONS``; its name holds no ``flash_tc_kernel``, so that
    the video cell's ``flash_roofline.video`` and the six
    ``TC_INSTANTIATIONS`` do not take it in."""
    report = (RECORDED / "flash_attention.ptxas.txt").read_text()
    names = re.findall(r"Compiling entry function '(\w*flash_relkey_kernel\w*)'", report)
    assert [tf.relkey_instantiation(n) for n in names] == tf.RELKEY_INSTANTIATIONS
    assert not any("flash_tc_kernel" in n for n in names)
    kernels = kt.ptxas_kernels(report)
    assert {tf.relkey_instantiation(k): v for k, v in kernels.items() if "flash_relkey_kernel" in k} == {
        key: {"spills": 0, "registers": tf.relkey_block()["launch_regs"]} for key in tf.RELKEY_INSTANTIATIONS}
    tc = sorted(tf.tc_instantiation(k) for k in kernels if "flash_tc_kernel" in k)
    assert tc == sorted(tf.TC_INSTANTIATIONS)


def _heads(b, h, t, d, gen):
    """bf16 (B, H, T, d) head views of (B, T, H, d) projections, as the backbone hands them over."""
    return [torch.randn((b, t, h, d), generator=gen).to(torch.bfloat16).transpose(1, 2) for _ in range(3)]


def _misaligned(b, h, t, d, gen):
    """Head views whose h stride (68 elements) TMA cannot read."""
    return [torch.randn((b, t, h, 68), generator=gen).to(torch.bfloat16)[..., :d].transpose(1, 2) for _ in range(3)]


@pytest.mark.parametrize("case,match", [
    ("table", "table of shape"),
    ("head_dim", "head dim 64"),
    ("tma", "h stride 68"),
    ("lengths", "lengths of shape"),
    ("dtype", "wants bf16"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take_without_a_launch(case, match):
    gen = torch.Generator().manual_seed(7)
    q, k, v = (_misaligned if case == "tma" else _heads)(1, 2, 40, 32 if case == "head_dim" else 64, gen)
    if case == "dtype":
        q = q.float()
    table = torch.zeros((72 if case == "table" else 73, q.shape[-1]))
    lengths = torch.tensor([40, 40] if case == "lengths" else [40], dtype=torch.int32)
    before = dict(tf.launch_counts)

    def launch(*args, **kwargs):
        raise AssertionError("the kernel was looked up for a launch")

    with mock.patch.object(_cuda, "check_cuda"), mock.patch.object(_cuda, "function", launch):
        with pytest.raises(ValueError, match=match):
            tf._relkey_cuda(q, k, v, table, lengths, 64, 8)
    assert tf.launch_counts == before


def test_wrapper_refuses_cpu_tensors_on_the_kernel_route():
    q, k, v = _heads(1, 2, 40, 64, torch.Generator().manual_seed(8))
    with pytest.raises(ValueError, match="not a CUDA device"):
        tf._relkey_cuda(q, k, v, torch.zeros((73, 64)), None, 64, 8)


@pytest.mark.parametrize("dtype,heads", [(torch.bfloat16, 2), (torch.float32, 4)])
def test_the_backbone_calls_the_wrapper_in_every_layer(dtype, heads, monkeypatch):
    """Every configuration's attention goes through ``relkey_attention``,
    which picks the plain version for CPU tensors and the kernel (or a
    refusal) for CUDA tensors: the backbone holds no route of its own."""
    calls = []

    def wrapper(q, *args):
        calls.append((q.dtype, q.shape[-1]))
        return tf.relkey_attention(q, *args)

    monkeypatch.setattr(tw, "relkey_attention", wrapper)
    cfg = tw.Wav2VecBertConfig(hidden_size=128, num_layers=2, num_heads=heads, intermediate_size=256,
                               conv_kernel_size=7, dtype=dtype)
    model = tw.Wav2VecBertBackbone(cfg, device="cpu").init_random(torch.Generator().manual_seed(5))
    with torch.no_grad():
        model(torch.randn((1, 20, cfg.input_dim)), attention_mask=_pad_mask((17,), 20))
    assert calls == [(dtype, 128 // heads)] * cfg.num_layers


@pytest.mark.parametrize("mask", ["left_padded", "with_a_hole"])
def test_a_mask_that_is_not_right_padded_gives_nan_rows(mask):
    """The key counts mask only right padding, so a row whose mask is not
    right-padded gives NaN states from entry 1 on (its entry 0, the
    projected input, stays); the other rows are what they are alone."""
    cfg = tw.Wav2VecBertConfig(hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                               conv_kernel_size=7, dtype=torch.bfloat16)
    model = tw.Wav2VecBertBackbone(cfg, device="cpu").init_random(torch.Generator().manual_seed(5))
    feats = torch.randn((2, 40, cfg.input_dim), generator=torch.Generator().manual_seed(6))
    bad = torch.arange(40) >= 9 if mask == "left_padded" else (torch.arange(40) < 30) & (torch.arange(40) != 12)
    good = torch.arange(40) < 31
    with torch.no_grad():
        out = model(feats, attention_mask=torch.stack([good, bad]))
        alone = model(feats[:1], attention_mask=good[None])
    assert torch.isfinite(out[0, 1]).all() and torch.isnan(out[1:, 1]).all()
    assert torch.equal(out[:, :1], alone)


@pytest.mark.parametrize("mutant", sorted(chip_smoke.RELKEY_MUTANTS))
def test_relkey_mutant_lines_occur_once_in_the_source(mutant, tmp_path):
    """chip_smoke.py builds each relative-key mutant by replacing lines of
    the flash source; each must be there exactly once."""
    source = _cuda.CSRC / "flash_attention.cu"
    patches = chip_smoke.RELKEY_MUTANTS[mutant]
    assert kt.write_patched({source.name: source}, patches, tmp_path) == []
    want = source.read_text()
    for _, old, new in patches:
        want = want.replace(old, new)
    assert (tmp_path / source.name).read_text() == want


class _Trace:
    def __init__(self, kernels):
        self._kernels = kernels

    def kernels(self, *needles):
        return [k for k in self._kernels if any(n in k[0] for n in needles)]


class _Run:
    device_name = "NVIDIA H100 80GB HBM3"
    config = {"num_attention_heads": 16, "hidden_size": 1024, "num_hidden_layers": 24}

    def __init__(self, trace, work):
        self.trace, self.work = trace, work


def test_relkey_roofline_reads_the_kernel_and_nothing_without_it():
    """``relkey_roofline.audio``: the bound of each chunk's 24 calls at its
    valid frames over the kernels' device time; empty without a trace, a
    chunk, or the kernel (a program that lacks it)."""
    reader = load_module(ROOT / "benchmark" / "metrics" / "relkey_roofline.audio.py")
    assert (reader.LAYER, reader.MOVES) == ("kernels", "feature_stim_s_per_s")
    name = "void (anonymous namespace)::rk::flash_relkey_kernel<64>((anonymous namespace)::rk::RelKeyParams)"
    calls = [(name, 0.001 * i, 0.001 * i + 0.0002) for i in range(48)]
    work = {"chunk_frames": [3000, 2000]}
    assert reader.read(_Run(None, work)) is None
    assert reader.read(_Run(_Trace([("flash_tc_kernel", 0.0, 1.0)]), work)) is None
    assert reader.read(_Run(_Trace(calls), {"chunk_frames": []})) is None
    peaks = chip_smoke.peaks_for(_Run.device_name)
    bound = 24 * sum(reader.call_bound_s(_Run.config, t, peaks)[0] for t in (3000, 2000))
    assert reader.read(_Run(_Trace(calls), work)) == pytest.approx(100 * bound / (48 * 0.0002))
    # at T = 3000 the operations bind: 4 H T^2 d at the bf16 peak
    assert reader.call_bound_s(_Run.config, 3000, peaks) == (4 * 16 * 3000**2 * 64 / peaks["bfloat16"], "operations")
