"""The port's text feature path (features/text.py) against the JAX package's.

The JAX ``LLAMA3p2._compute`` on its tiny fp32 backbone is the reference;
the port's ``encode_word_stream`` runs ``TinyTextBackbone`` built from the
same weights (models.convert.llama_params_to_torch) on the CPU, through the
same chain / batched routing, and must give the same per-word features at
the bound tests/test_text_chain.py holds the JAX chain path to.
"""

import numpy as np
import pytest
import torch

from algonauts2025_tpu.core.events import Word
from algonauts2025_tpu.features import text as jt
from algonauts2025_tpu.models.backbones import llama as jl
from algonauts2025_tpu_torch.features import text as tt
from algonauts2025_tpu_torch.models import llama_params_to_torch
from algonauts2025_tpu_torch.models.backbones import llama as tl

VOCAB = "the quick brown fox jumps over a lazy dog near misty hills".split()


def _words(n: int, context_cap: int | None = None, offset: int = 0) -> list[tuple[str, str]]:
    words = [VOCAB[(i + offset) % len(VOCAB)] for i in range(n)]
    out = []
    for i, w in enumerate(words):
        lo = 0 if context_cap is None else max(0, i + 1 - context_cap)
        out.append((w, " ".join(words[lo : i + 1])))
    return out


@pytest.fixture(scope="module")
def pair():
    """The JAX tiny backbone and the port's with the same weights."""
    jax_backbone = jt.TinyTextBackbone()
    port = tt.TinyTextBackbone(state_dict=llama_params_to_torch(jax_backbone.params), device="cpu")
    return jax_backbone, port


def _compare(pair, words, **feature_kw):
    jax_backbone, port = pair
    feat = jt.LLAMA3p2(model_name="tiny-random", **feature_kw)
    feat.set_backbone(jax_backbone)
    events = [Word(start=0.5 * i, duration=0.4, text=w, context=c, timeline="t")
              for i, (w, c) in enumerate(words)]
    ref = [np.asarray(x) for x in feat._compute(events)]
    got = list(tt.encode_word_stream(port, words, **feature_kw))
    assert len(got) == len(ref) == len(words)
    for g, r in zip(got, ref):
        assert g.dtype == np.float32 and g.shape == r.shape == (5, 64)
        np.testing.assert_allclose(g, r, rtol=2e-5, atol=2e-6)
    return got


def test_chain_run_matches_jax(pair):
    words = _words(24)
    runs = tt._chain_runs(pair[1], words, 1024)
    assert [(is_chain, len(ws)) for is_chain, ws, _ in runs] == [(True, 24)]
    _compare(pair, words)


def test_capped_context_demotes_to_batched_path(pair):
    """Word-capped rolling contexts stop being prefixes of each other: the
    first 20 words chain, the sliding tail runs in padded batches."""
    words = _words(40, context_cap=20)
    runs = tt._chain_runs(pair[1], words, 1024)
    assert [(is_chain, len(ws)) for is_chain, ws, _ in runs] == [(True, 20), (False, 20)]
    _compare(pair, words, batch_size=8)


def test_context_beyond_bucket_table(pair):
    """1100 tokens: past the 1024 bucket, widened to 512-steps (1536), and
    a second context left-truncated to max_context_tokens."""
    long_ctx = " ".join(VOCAB[i % len(VOCAB)] for i in range(1100))
    words = [("fox", long_ctx), ("dog", long_ctx + " dog"), ("hills", "near misty hills")]
    ids, mask = pair[1].encode_pretokenized(pair[1].chain_tokenize([c for _, c in words]), 1100)
    assert ids.shape == (3, 1536) and mask.sum(axis=-1).tolist() == [1100, 1100, 3]
    _compare(pair, words, max_context_tokens=1100)


def test_empty_context_stands_for_the_word(pair):
    words = _words(10)
    words[3] = ("misty", "")
    got = _compare(pair, words)
    alone = list(tt.encode_word_stream(pair[1], [("misty", "misty")]))
    np.testing.assert_allclose(got[3], alone[0], rtol=2e-5, atol=2e-6)


def test_hidden_and_pooled_states_match_jax(pair):
    jax_backbone, port = pair
    ids, mask = port.encode(["the quick brown fox", "a lazy dog", "hills"], 1024)
    assert ids.shape == (3, 32)
    # these rows pool fewer positions than a word stream's (one, for
    # "hills"), so single elements near zero keep more of the fp32 noise
    np.testing.assert_allclose(port.hidden_states(ids, mask), jax_backbone.hidden_states(ids, mask),
                               rtol=2e-5, atol=1e-5)
    spans = np.array([3, 1, 5], np.int32)
    np.testing.assert_allclose(port.pooled_states(ids, mask, spans),
                               jax_backbone.pooled_states(ids, mask, spans), rtol=2e-5, atol=1e-5)


class _CountingTokenizer:
    """Hash ids per whitespace word; ``merge`` fuses "a b" into one id, the
    kind of cross-word merge that breaks per-word concatenation."""

    def __init__(self, merge: bool = False):
        self.merge = merge
        self.calls: list[str] = []

    def __call__(self, text: str) -> list[int]:
        self.calls.append(text)
        if self.merge:
            text = text.replace("a b", "a_b")
        return [sum(map(ord, w)) for w in text.split()]


def _backbone(tokenizer):
    model = tl.LlamaBackbone(tl.LlamaConfig(vocab_size=16, hidden_size=16, intermediate_size=16,
                                            num_layers=1, num_heads=2, num_kv_heads=1, head_dim=8,
                                            dtype=torch.float32))
    return tt.TorchTextBackbone(model, tokenizer, pad_id=0, device="cpu")


@pytest.mark.parametrize("text", ["two  spaces", "tab\there", "new\nline", "nbsp here", "single"])
def test_incremental_tokenizer_whitespace_guard(text):
    """Whitespace runs, tabs, newlines and unicode spaces (and one-word
    texts) bypass the per-word cache: one full tokenization, nothing cached."""
    tok = _CountingTokenizer()
    bb = _backbone(tok)
    assert bb._tokenize(text) == tok(text)
    assert tok.calls == [text, text] and not bb._word_ids and bb._inc_checked == 0


def test_incremental_tokenizer_checks_a_sample():
    """The first 32 fast-path contexts and every 64th after are checked
    against full tokenization; words are tokenized once each."""
    tok = _CountingTokenizer()
    bb = _backbone(tok)
    texts = [f"w{i % 5} w{i % 3} end" for i in range(200)]
    assert bb.chain_tokenize(texts) == [tok(t) for t in texts]
    full = [c for c in tok.calls[: -len(texts)] if c.count(" ") == 2]
    assert len(full) == 32 + len([i for i in range(33, 201) if i % 64 == 0])
    assert bb._inc_enabled and bb._inc_checked == 200
    assert len(bb._word_ids) == 5 + 3 + 1


def test_incremental_tokenizer_disables_on_mismatch():
    tok = _CountingTokenizer(merge=True)
    bb = _backbone(tok)
    assert bb._tokenize("x y") == tok("x y") and bb._inc_enabled
    assert bb._tokenize("a b c") == tok("a b c")  # the checked context returns the full ids
    assert not bb._inc_enabled
    before = len(tok.calls)
    assert bb._tokenize("a b") == tok("a b")
    assert tok.calls[before] == "a b"  # full tokenization from here on


def test_load_text_backbone_matches_jax_converter(rng):
    """An HF-named state dict and config.json keys, bf16, against the JAX
    package's params_from_hf on the same dict."""
    cfg = dict(vocab_size=50, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, rope_theta=500000.0)
    jcfg = jl.LlamaConfig(vocab_size=50, hidden_size=32, intermediate_size=48, num_layers=2,
                          num_heads=4, num_kv_heads=2, head_dim=8)
    d, hd, f = 32, 8, 48
    shapes = {"embed_tokens.weight": (50, d), "norm.weight": (d,)}
    for i in range(2):
        p = f"layers.{i}."
        shapes.update({p + "input_layernorm.weight": (d,), p + "post_attention_layernorm.weight": (d,),
                       p + "self_attn.q_proj.weight": (4 * hd, d), p + "self_attn.k_proj.weight": (2 * hd, d),
                       p + "self_attn.v_proj.weight": (2 * hd, d), p + "self_attn.o_proj.weight": (d, 4 * hd),
                       p + "mlp.gate_proj.weight": (f, d), p + "mlp.up_proj.weight": (f, d),
                       p + "mlp.down_proj.weight": (d, f)})
    sd = {k: (0.2 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    port = tt.load_text_backbone(sd, cfg, tt.HashTokenizer(50), pad_id=0, device="cpu")
    ref = jt.JaxTextBackbone(jl.LlamaBackbone(jcfg), jl.params_from_hf(sd, jcfg),
                             jt.HashTokenizer(50), pad_id=0)
    assert port.model.cfg == tl.LlamaConfig(**{**jcfg.__dict__, "dtype": torch.bfloat16})
    ids, mask = port.encode(["the quick brown fox jumps", "a lazy dog"], 1024)
    got, want = port.hidden_states(ids, mask), np.asarray(ref.hidden_states(ids, mask), np.float32)
    valid = np.broadcast_to(mask.astype(bool)[None, :, :, None], got.shape)
    assert np.linalg.norm(got[valid] - want[valid]) / np.linalg.norm(want[valid]) <= 1e-2


def test_hash_tokenizer_matches_jax():
    text = "The quick BROWN fox, jumps"
    assert tt.HashTokenizer(128256)(text) == jt.HashTokenizer(128256)(text)


def test_pipeline_mesh_is_not_ported():
    """A pipeline mesh whose stage count does not divide the layers is
    refused when the backbone is built (as the JAX JaxTextBackbone refuses
    it); one that divides them places each stage's layers on its device."""
    from algonauts2025_tpu_torch.parallel import LocalMesh

    with pytest.raises(ValueError, match="1 layers not divisible by 2 stages"):
        tt.TorchTextBackbone(tl.LlamaBackbone(tl.LlamaConfig(num_layers=1), device="meta"),
                             tt.HashTokenizer(8), 0, device="cpu",
                             pipeline_mesh=LocalMesh((torch.device("cpu"),) * 2, "stage"))
    with pytest.raises(ValueError, match="not divisible"):
        jt.TinyTextBackbone(num_layers=3, pipeline_mesh=_jax_stages(2))
    backbone = tt.TinyTextBackbone(num_layers=4, device="cpu",
                                   pipeline_mesh=LocalMesh((torch.device("cpu"),) * 2, "stage"))
    assert backbone.pipeline_mesh.shape == {"stage": 2}


def _jax_stages(n):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), ("stage",))
