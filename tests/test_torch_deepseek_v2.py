"""The port's DeepSeek-V2 text backbone on the CPU.

``models/backbones/deepseek_v2.py`` and ``ops/moe.py`` against two
independent oracles at a small size: transformers' ``DeepseekV2Model``
(without rope scaling, where its native attention and the published code
agree) and the benchmark's plain reference
(``benchmark/reference/deepseek_v2_lite.py``, which imports nothing of the
port) with the published yarn scaling.  Also: the yarn tables and the
softmax scale worked out by hand, the grouped expert path against the
per-expert loop, mutants the reference must catch, the chain and padded
dispatches of ``encode_word_stream``, the spans and counters, and the
work that ``text.mfu`` and ``moe_roofline.text`` count.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from algonauts2025_tpu_torch.features import text as tt
from algonauts2025_tpu_torch.models.backbones import deepseek_v2 as dv
from algonauts2025_tpu_torch.models.backbones.llama import LlamaBackbone
from algonauts2025_tpu_torch.ops import moe
from benchmark.common.peaks import peaks_for
from benchmark.harness import load_module
from benchmark.reference import deepseek_v2_lite as ref

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
FULL = json.loads((BENCH / "configs" / "deepseek_v2_lite.json").read_text())
#: 3 layers (one dense, two MoE), 64 wide, 8 experts top-2, 1 shared, the published yarn
TINY = {**FULL, "hidden_size": 64, "intermediate_size": 96, "moe_intermediate_size": 32, "num_hidden_layers": 3,
        "num_attention_heads": 4, "num_key_value_heads": 4, "n_routed_experts": 8, "n_shared_experts": 1,
        "num_experts_per_tok": 2, "kv_lora_rank": 16, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
        "v_head_dim": 16, "vocab_size": 512, "bos_token_id": 510, "eos_token_id": 511}


def _rel(got, want) -> np.ndarray:
    """Relative L2 of each leading entry over the rest."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (np.linalg.norm((got - want).reshape(len(want), -1), axis=1)
            / np.linalg.norm(want.reshape(len(want), -1), axis=1))


def _port(cfg: dict, seed: int, dtype: torch.dtype) -> dv.DeepseekV2Backbone:
    return dv.from_hf(ref.SeededWeights(cfg, seed, "cpu"), cfg, dtype=dtype)


def _reference(cfg: dict, seed: int, ids: torch.Tensor, dtype: torch.dtype) -> np.ndarray:
    """The reference's (L+1, T, D) states of one sequence."""
    return ref.Model(cfg, seed, "cpu", dtype=dtype).run([ids], [torch.eye(len(ids))])[0].numpy()


# -- transformers' DeepseekV2Model --------------------------------------------------

def _hf_model(seed: int):
    from transformers import DeepseekV2Config, DeepseekV2Model

    hc = DeepseekV2Config(
        vocab_size=97, hidden_size=64, intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=4, n_routed_experts=8, n_shared_experts=1,
        num_experts_per_tok=2, first_k_dense_replace=1, kv_lora_rank=16, q_lora_rank=None, qk_rope_head_dim=8,
        qk_nope_head_dim=16, v_head_dim=16, rope_scaling=None, norm_topk_prob=False, topk_method="greedy",
        n_group=1, topk_group=1, routed_scaling_factor=1.0, rms_norm_eps=1e-6, attn_implementation="eager")
    model = DeepseekV2Model(hc).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            base = 1.0 if "norm" in name else 0.0
            p.copy_(base + 0.2 * torch.randn(p.shape, generator=gen))
    return model, hc.to_dict()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("padded", [False, True])
def test_port_matches_hf_deepseek_v2(seed, padded):
    """Every hidden state of the fp32 port against transformers' eager
    ``DeepseekV2Model`` on the same weights (one dense and two MoE layers),
    the valid positions of right-padded rows included."""
    hf, hf_config = _hf_model(seed)
    port = dv.from_hf(hf.state_dict(), hf_config, dtype=torch.float32)
    ids = torch.randint(0, 97, (2, 13), generator=torch.Generator().manual_seed(seed))
    mask = torch.ones(2, 13, dtype=torch.int64)
    if padded:
        mask[1, 9:] = 0
    with torch.no_grad():
        want = torch.stack(hf(input_ids=ids, attention_mask=mask, output_hidden_states=True).hidden_states)
        got = port(ids, mask)
    assert got.shape == want.shape == (4, 2, 13, 64)
    valid = mask.bool()[None, :, :, None].expand_as(want)
    np.testing.assert_allclose(got[valid].numpy(), want[valid].numpy(), rtol=1e-5, atol=2e-5)


# -- yarn ---------------------------------------------------------------------------

def test_published_config_is_the_lite():
    assert dv.config_from_hf(FULL) == dv.DEEPSEEK_V2_LITE
    n = sum(math.prod(shape) for _, shape, _ in ref.weight_spec(FULL))
    layer = 13_762_560 + 2 * 2048 + 512  # MLA and the norms
    moe_layer = 64 * 3 * 2048 * 1408 + 3 * 2048 * 2816 + 64 * 2048
    assert n == 102400 * 2048 + 2048 + 27 * layer + 3 * 2048 * 10944 + 26 * moe_layer == 15_496_769_024
    # 15.50 B without the LM head: 31.0 GB in bf16


def test_yarn_inv_freq_by_hand():
    """theta^(-2i/64) for i <= 10 (the 32-turn correction dim:
    floor(64 ln(4096 / 64 pi) / 2 ln 1e4) = 10), theta^(-2i/64) / 40 from
    i = 23 on (ceil(64 ln(4096 / 2 pi) / 2 ln 1e4) = 23), a linear blend
    between."""
    inv = dv.yarn_inv_freq(dv.DEEPSEEK_V2_LITE).astype(np.float64)
    extra = 10000.0 ** (-np.arange(0, 64, 2) / 64)
    assert math.floor(64 * math.log(4096 / (32 * 2 * math.pi)) / (2 * math.log(10000))) == 10
    assert math.ceil(64 * math.log(4096 / (2 * math.pi)) / (2 * math.log(10000))) == 23
    np.testing.assert_allclose(inv[:11], extra[:11], rtol=1e-7)
    np.testing.assert_allclose(inv[23:], extra[23:] / 40, rtol=1e-7)
    ramp = (16 - 10) / 13
    assert inv[16] == pytest.approx(extra[16] / 40 * ramp + extra[16] * (1 - ramp), rel=1e-7)
    np.testing.assert_allclose(ref.yarn_inv_freq(FULL).numpy(), inv, rtol=1e-7)


def test_yarn_inv_freq_matches_transformers():
    from transformers import DeepseekV2Config
    from transformers.modeling_rope_utils import ROPE_INIT_FUNCTIONS

    hc = DeepseekV2Config(**{k: v for k, v in FULL.items() if k in ("hidden_size", "num_attention_heads",
                                                                       "qk_rope_head_dim", "rope_theta",
                                                                       "max_position_embeddings")},
                          rope_scaling=FULL["rope_scaling"])
    inv, gain = ROPE_INIT_FUNCTIONS["yarn"](hc, "cpu")
    np.testing.assert_allclose(dv.yarn_inv_freq(dv.DEEPSEEK_V2_LITE), inv.numpy(), rtol=2e-7)
    assert gain == pytest.approx(dv._cos_gain(dv.DEEPSEEK_V2_LITE)) == pytest.approx(1.0)


def test_softmax_scale_by_hand():
    """192^-0.5 x (0.1 x 0.707 x ln 40 + 1)^2 = 0.0721688 x 1.589627."""
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert mscale ** 2 == pytest.approx(1.589627, abs=1e-6)
    assert dv.softmax_scale(dv.DEEPSEEK_V2_LITE) == pytest.approx(0.114722, abs=1e-6)
    assert ref.softmax_scale(FULL) == dv.softmax_scale(dv.DEEPSEEK_V2_LITE)
    assert dv.softmax_scale(dataclasses.replace(dv.DEEPSEEK_V2_LITE, rope_factor=1.0)) == 192 ** -0.5


# -- the reference ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 2**40 + 7])
@pytest.mark.parametrize("dtype, limit", [(torch.float32, 2e-6), (torch.bfloat16, 2e-2)])
def test_port_matches_reference(seed, dtype, limit):
    """The port's states against the plain reference's on the same seeded
    weights, every layer: float32 within float32 rounding; bf16 within the
    rounding flips of its bf16 activations."""
    ids = torch.randint(0, 500, (37,), generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        got = _port(TINY, seed, dtype)(ids[None])[:, 0].float().numpy()
    gaps = _rel(got, _reference(TINY, seed, ids, dtype))
    assert gaps[0] == 0 and gaps.max() <= limit, gaps


@pytest.mark.parametrize("mutant", ["renormalised_topk", "no_shared_experts", "half_split_rope", "no_mscale2"])
def test_reference_catches_a_mutant(mutant, monkeypatch):
    """Each departure from the published layer makes the float32 port read
    far above the sound port's gap to the reference (~1e-7)."""
    cfg = TINY
    if mutant == "renormalised_topk":
        cfg = {**TINY, "norm_topk_prob": True}
    elif mutant == "half_split_rope":
        def half_split(x, cos, sin):
            x32 = x.float()
            a, b = x32.chunk(2, dim=-1)
            return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1).to(x.dtype)

        monkeypatch.setattr(dv, "rope", half_split)
    elif mutant == "no_mscale2":
        monkeypatch.setattr(dv, "softmax_scale", lambda c: (c.qk_nope_head_dim + c.qk_rope_head_dim) ** -0.5)
    port = _port(cfg, 5, torch.float32)
    if mutant == "no_shared_experts":
        for layer in port.layers[1:]:
            layer.mlp.shared.down_proj.weight.data.zero_()
    ids = torch.randint(0, 500, (41,), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = port(ids[None])[:, 0].numpy()
    assert _rel(got, _reference(TINY, 5, ids, torch.float32)).max() > 1e-3


def _normalised_p_attention(q, k, v, scale, bf16_scores=False):
    """Causal attention in float64 with the normalised p rounded to bf16 (and,
    for the control, the scores too), the output rounded to bf16."""
    t = q.shape[-2]
    s = (q.double() @ k.double().transpose(-1, -2)) * scale
    if bf16_scores:
        s = s.bfloat16().double()
    s.masked_fill_(torch.ones(t, t, dtype=torch.bool).triu_(1), float("-inf"))
    return (torch.softmax(s, -1).bfloat16().double() @ v.double()).bfloat16().double()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attention_rounds_the_normalised_probabilities(seed):
    """``CausalAttention`` against the configuration's numerics in float64
    (the bf16 output of a few rounding flips apart); a fused attention that
    rounds exp(s - m) under a running max (SDPA) and bf16 scores read
    farther by 50x or more."""
    gen = torch.Generator().manual_seed(seed)
    q, k = (torch.randn(2, 4, 300, 24, generator=gen).bfloat16() for _ in range(2))
    v = torch.randn(2, 4, 300, 16, generator=gen).bfloat16()
    want = _normalised_p_attention(q, k, v, 0.3)

    def gap(got):
        return float((got.double() - want).norm() / want.norm())

    assert gap(dv.CausalAttention(0.3)(q, k, v)) < 1e-4
    assert gap(torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True, scale=0.3)) > 2e-3
    assert gap(_normalised_p_attention(q, k, v, 0.3, bf16_scores=True)) > 4e-3


def test_reference_control_reads_lower_precision():
    """The reference's own controls differ from it: bf16 scores move the
    attention's output, the bf16 router moves some tokens' experts, fp8
    experts move the MoE's output."""
    model = ref.Model(TINY, 2, "cpu")
    w0 = model.weights(0)
    a = ref.bf(torch.randn(200, 64, generator=torch.Generator().manual_seed(3)))
    assert ref.rel_gap(ref.Model(TINY, 2, "cpu", scores="bf16").attention(w0, a), model.attention(w0, a)) > 1e-4
    w = model.weights(1)
    x = ref.bf(torch.randn(256, 64, generator=torch.Generator().manual_seed(2)))
    out, ids = model.moe(w, x)
    low, low_ids = ref.Model(TINY, 2, "cpu", router="bf16").moe(w, x)
    assert ref.route_mismatch(low_ids, ids) > 0
    fp8, fp8_ids = ref.Model(TINY, 2, "cpu", experts="fp8").moe(w, x)
    assert ref.route_mismatch(fp8_ids, ids) == 0 and ref.rel_gap(fp8, out) > 5e-3


# -- the routed experts ---------------------------------------------------------------

def _routing(n, e, k, d, f, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=gen).to(dtype)
    w13 = (0.1 * torch.randn(e, 2 * f, d, generator=gen)).to(dtype)
    w2 = (0.1 * torch.randn(e, d, f, generator=gen)).to(dtype)
    logits = torch.randn(n, e, generator=gen)
    logits[:, e // 2] = -1e9  # one expert without a row
    weights, ids = torch.topk(logits.softmax(-1), k, dim=-1, sorted=False)
    return x, weights, ids, w13, w2


@pytest.mark.parametrize("n, e, k", [(1, 4, 2), (37, 8, 2), (200, 16, 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_path_matches_the_per_expert_loop(n, e, k, dtype):
    """The sort, the offsets and the combine: the grouped path
    (``torch._grouped_mm`` on CPU tensors) gives the per-expert loop's rows
    bit for bit."""
    x, weights, ids, w13, w2 = _routing(n, e, k, 16, 8, dtype, n)
    order, offsets = moe.sort_by_expert(ids, e)
    flat = ids.reshape(-1)
    assert torch.equal(flat[order], flat.sort(stable=True).values)
    assert offsets.dtype == torch.int32 and offsets.tolist() == np.cumsum(np.bincount(flat, minlength=e)).tolist()
    got = moe.expert_rows_grouped(x, ids, w13, w2)
    want = moe.expert_rows_plain(x, ids, w13, w2)
    assert got.shape == (n, k, 16) and torch.equal(got, want)
    assert torch.equal(moe.combine(got, weights), moe.routed_experts(x, weights, ids, w13, w2))


def test_torch_grouped_mm_matches_the_per_expert_loop():
    """``torch._grouped_mm`` itself over the sorted rows of CPU tensors, in
    bf16 (the card's bf16 kernel is held to the same loop in
    ``test_torch_deepseek_v2_card.py``)."""
    x, weights, ids, w13, w2 = _routing(64, 8, 2, 16, 8, torch.bfloat16, 1)
    got = moe.expert_rows_grouped(x, ids, w13, w2)
    want = moe.expert_rows_plain(x, ids, w13, w2).float()
    assert float((got.float() - want).norm() / want.norm()) < 1e-2


def test_route_is_fp32_greedy_topk():
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(50, 16, generator=gen).bfloat16()
    gate = (0.3 * torch.randn(8, 16, generator=gen)).bfloat16()
    weights, ids = moe.route(x, gate, 3)
    scores = (x.float() @ gate.float().T).softmax(-1)
    top = scores.topk(3, dim=-1)
    assert weights.dtype == torch.float32
    assert torch.equal(ids.sort(-1).values, top.indices.sort(-1).values)
    assert torch.allclose(weights.sort(-1).values, top.values.sort(-1).values)
    renormed, _ = moe.route(x, gate, 3, norm_topk_prob=True)
    assert torch.allclose(renormed.sum(-1), torch.ones(50))


# -- the backbone's contract ------------------------------------------------------------

def test_left_padded_row_is_poisoned_from_entry_one():
    port = _port(TINY, 1, torch.float32)
    ids = torch.randint(0, 500, (2, 9), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 9, dtype=torch.int32)
    mask[1, :2] = 0
    with torch.no_grad():
        out = port(ids, mask)
    assert torch.isfinite(out[:, 0]).all() and torch.isfinite(out[0, 1]).all()
    assert torch.isnan(out[1:, 1]).all()


def test_config_from_hf_refuses_what_it_does_not_compute():
    with pytest.raises(ValueError, match="q LoRA"):
        dv.config_from_hf({**FULL, "q_lora_rank": 1536})
    with pytest.raises(ValueError, match="greedy"):
        dv.config_from_hf({**FULL, "topk_method": "group_limited_greedy"})


def test_pipeline_stages_split_llama_only():
    from algonauts2025_tpu_torch.parallel import LocalMesh

    with pytest.raises(ValueError, match="Llama backbones only"):
        tt.load_text_backbone(ref.SeededWeights(TINY, 1, "cpu"), TINY, tt.HashTokenizer(500), 511, device="cpu",
                              pipeline_stages=2)
    with pytest.raises(ValueError, match="Llama backbones only"):
        tt.TorchTextBackbone(_port(TINY, 1, torch.float32), tt.HashTokenizer(500), 511, device="cpu",
                             pipeline_mesh=LocalMesh((torch.device("cpu"),) * 2, "stage"))


def test_load_text_backbone_dispatches_on_model_type():
    backbone = tt.load_text_backbone(ref.SeededWeights(TINY, 1, "cpu"), TINY, tt.HashTokenizer(500), 511,
                                     device="cpu")
    assert isinstance(backbone.model, dv.DeepseekV2Backbone)
    assert backbone.model.cfg == dv.config_from_hf(TINY) and backbone.model.cfg.dtype == torch.bfloat16
    assert backbone.model.layers[1].mlp.w13.shape == (8, 64, 64)
    with pytest.raises(ValueError, match="no text backbone"):
        tt.load_text_backbone({}, {"model_type": "qwen2"}, tt.HashTokenizer(500), 0, device="cpu")
    assert not isinstance(backbone.model, LlamaBackbone)


# -- the word stream ------------------------------------------------------------------------

VOCAB = "the quick brown fox jumps over a lazy dog near misty hills".split()


def _words(n: int) -> list[tuple[str, str]]:
    words = [VOCAB[(3 * i) % len(VOCAB)] for i in range(n)]
    return [(w, " ".join(words[: i + 1])) for i, w in enumerate(words)]


def _backbone(seed: int = 2) -> tt.TorchTextBackbone:
    return tt.TorchTextBackbone(_port(TINY, seed, torch.float32), tt.HashTokenizer(500), pad_id=511, device="cpu")


def test_chain_matches_padded_dispatch():
    """One chain forward a chunk of nested contexts against every context in
    padded batches: the same states (causal attention, shared positions)."""
    bb = _backbone()
    words = _words(30)
    chain = np.stack(list(tt.encode_word_stream(bb, words, batch_size=8, chain_chunk=16)))
    assert bb.counts["chain_forwards"] == 2 and bb.counts["batched_forwards"] == 0
    padded = np.stack(list(tt.encode_word_stream(bb, words, batch_size=8, min_chain=10**9)))
    assert bb.counts["batched_forwards"] == 4
    assert chain.shape == padded.shape == (30, 4, 64)
    np.testing.assert_allclose(chain, padded, rtol=2e-5, atol=2e-6)


def test_spans_and_counters():
    """The stream's ``text.*#<k>`` spans and the model's spans under a
    profiler; the counters of the forwards and tokens; ``expert_tokens``
    counts k experts for every valid token of every MoE layer."""
    bb = _backbone()
    bb.model.reset_expert_tokens()
    words = _words(20)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = list(tt.encode_word_stream(bb, words[:12], batch_size=8))
        out += list(tt.encode_word_stream(bb, words[12:], batch_size=8, min_chain=10**9))
    names = {e.name for e in prof.events()}
    assert len(out) == 20
    for k in range(bb.counts["forwards"]):
        assert {f"text.{s}#{k}" for s in ("pad", "upload", "backbone", "pool", "fetch")} <= names, k
    assert {"dsv2.embed", "mla.attention", "dense.mlp", "moe.route", "moe.experts", "moe.shared",
            "dsv2.final"} <= names
    c = bb.counts
    assert c["forwards"] == c["chain_forwards"] + c["batched_forwards"] == 2
    valid = len(words[11][1].split()) + sum(len(c[1].split()) for c in words[12:])
    assert c["tokens"] == valid and c["padded_tokens"] == 32 + 8 * 32 - valid
    assert bb.model.expert_tokens.shape == (2, 8)
    assert bb.model.expert_tokens.sum(dim=1).tolist() == [2 * valid] * 2


def test_counters_reset():
    bb = _backbone()
    list(tt.encode_word_stream(bb, _words(9), batch_size=8))
    assert bb.counts["forwards"] == 1
    bb.reset_counts()
    assert set(bb.counts.values()) == {0}


# -- the per-layer metrics' work ----------------------------------------------------------

def test_text_mfu_counts_by_hand():
    """2 x 2241.6 M active parameters a token (MLA 13.76 M x 27, the dense
    MLP 67.2 M, each MoE layer 6 x 8.65 M routed + 17.3 M shared + 0.13 M
    router), and 10,240 x (p + 1) a layer for q.k and P.v."""
    mfu = load_module(BENCH / "metrics" / "text.mfu.py")
    mla = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    moe_layer = 6 * 3 * 2048 * 1408 + 3 * 2048 * 2816 + 64 * 2048
    assert mla == 13_762_560 and moe_layer == 69_337_088
    assert mfu.active_params(FULL) == 27 * mla + 3 * 2048 * 10944 + 26 * moe_layer == 2_241_593_344
    assert mfu.token_flops(FULL) == pytest.approx(4.483e9, rel=1e-4)
    assert mfu.row_flops(FULL, 3) == 3 * mfu.token_flops(FULL) + 27 * 10240 * (1 + 2 + 3)
    # a padded 8 x 1024 batch: 37.9 TFLOP, 38.3 ms at the bf16 peak
    assert 8 * mfu.row_flops(FULL, 1024) / 989e12 == pytest.approx(0.0383, abs=1e-4)


def test_moe_roofline_bound_by_hand():
    """A MoE layer of 8192 valid tokens: 2 x 3 x 2048 x 1408 x 6 x 8192 FLOP
    (0.86 ms at 989 TFLOP/s) against 1.107 GB of expert weights and 0.40 GB
    of routed rows (0.45 ms at 3.35 TB/s): compute-bound; at 64 tokens the
    weights bind."""
    roof = load_module(BENCH / "metrics" / "moe_roofline.text.py")
    peaks = peaks_for("NVIDIA H100 80GB HBM3")
    assert roof.moe_layers(FULL) == 26
    s, by = roof.call_bound_s(FULL, 8192, peaks)
    assert by == "operations" and s == pytest.approx(2 * 3 * 2048 * 1408 * 6 * 8192 / 989e12)
    s, by = roof.call_bound_s(FULL, 64, peaks)
    weights = 2 * 3 * 2048 * 1408 * 64
    assert weights == 1_107_296_256
    assert by == "bytes" and s == pytest.approx((weights + 4 * 6 * 64 * 2048) / 3.35e12)
