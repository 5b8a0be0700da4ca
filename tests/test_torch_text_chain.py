"""The port's twin of tests/test_text_chain.py: the same LLAMA3p2 cases
over algonauts2025_tpu_torch's feature, on the CPU.

Chain fast path for the text feature (r3).

Rolling word contexts are nested prefixes, so ONE causal forward over the
longest context reproduces every per-context forward's hidden states at
that prefix's tail positions (shared absolute positions + causal
attention).  These tests pin the fast path's exactness against the
batched reference path and its fallback behavior when chains break.
"""

import numpy as np
import pytest

from algonauts2025_tpu_torch.core.events import Word
from algonauts2025_tpu_torch.features.text import LLAMA3p2, TinyTextBackbone


VOCAB = "the quick brown fox jumps over a lazy dog near misty hills".split()


def _word_events(n: int, context_cap: int | None = None) -> list[Word]:
    words = [VOCAB[i % len(VOCAB)] for i in range(n)]
    events = []
    for i, w in enumerate(words):
        lo = 0 if context_cap is None else max(0, i + 1 - context_cap)
        ctx = " ".join(words[lo : i + 1])
        events.append(
            Word(start=0.5 * i, duration=0.4, text=w, context=ctx, timeline="t")
        )
    return events


@pytest.fixture(scope="module")
def feat():
    f = LLAMA3p2(model_name="tiny-random", device="cpu")
    f.set_backbone(TinyTextBackbone(device="cpu"))  # fp32 params -> tight comparisons
    return f


def test_chain_matches_batched_exactly(feat):
    events = _word_events(24)
    chain = [np.asarray(x) for x in feat._compute(events)]
    batched = [np.asarray(x) for x in feat._compute_batched(feat.backbone, events)]
    assert len(chain) == len(batched) == 24
    for c, b in zip(chain, batched):
        np.testing.assert_allclose(c, b, rtol=2e-5, atol=2e-6)


def test_chain_run_splitting_on_token_limit(feat):
    """Contexts that exceed max_context_tokens break the chain and route
    through the (left-truncating) batched path — outputs must still match
    the batched path end to end."""
    events = _word_events(30)
    short = feat.model_copy(update={"max_context_tokens": 12})
    short.set_backbone(feat.backbone)
    runs = short._chain_runs(short.backbone, events)
    assert any(not r[0] for r in runs)  # something fell off the chain
    chain = [np.asarray(x) for x in short._compute(events)]
    batched = [
        np.asarray(x) for x in short._compute_batched(short.backbone, events)
    ]
    for c, b in zip(chain, batched):
        np.testing.assert_allclose(c, b, rtol=2e-5, atol=2e-6)


def test_chain_breaks_on_non_prefix_contexts(feat):
    """Sliding-window contexts (left-truncated at the WORD level) are not
    prefixes of each other: the splitter must demote them to the batched
    path rather than pooling wrong positions."""
    events = _word_events(20, context_cap=4)
    runs = feat._chain_runs(feat.backbone, events)
    # the first 4 words chain (still true prefixes); the sliding tail must
    # not be treated as one chain
    tail = [r for r in runs if len(r[1]) > 4 and r[0]]
    assert not tail
    # and EVERY run marked as a chain must satisfy the prefix invariant
    # directly (a wrongly-chained short run would otherwise only surface
    # through the numeric comparison below)
    for is_chain, _es, toks in runs:
        if is_chain:
            for prev, cur in zip(toks, toks[1:]):
                assert cur[: len(prev)] == prev
    chain = [np.asarray(x) for x in feat._compute(events)]
    batched = [np.asarray(x) for x in feat._compute_batched(feat.backbone, events)]
    for c, b in zip(chain, batched):
        np.testing.assert_allclose(c, b, rtol=2e-5, atol=2e-6)


def test_chain_kernel_past_word_bucket_table(feat):
    """pooled_states_chain_async must extend the word-count axis past
    WBUCKETS[-1] (256-step rounding) instead of crashing — it is public
    API even though production chunks dispatches to CHAIN_CHUNK words."""
    bb = feat.backbone
    toks: list[list[int]] = []
    cur: list[int] = []
    n = bb.WBUCKETS[-1] + 3
    for i in range(n):
        cur = cur + [1 + (i % 100)]
        toks.append(list(cur))
    spans = [1] * n
    out = np.asarray(bb.pooled_states_chain_async(toks, spans))
    assert out.shape[1] >= n
    # word i pools exactly its last token's states: check one past the table
    ids, mask = bb.encode_pretokenized([toks[-1]], max_len=4096)
    states = bb.hidden_states(ids, mask)  # (L+1, 1, T, D)
    np.testing.assert_allclose(
        out[:, n - 1], states[:, 0, n - 1], rtol=2e-5, atol=2e-6
    )


def test_encode_pretokenized_matches_encode(feat):
    bb = feat.backbone
    texts = ["the quick brown fox", "over a lazy dog near misty hills", "hi"]
    ids_a, mask_a = bb.encode(texts, 6)  # forces left-truncation too
    ids_b, mask_b = bb.encode_pretokenized(
        [bb._tokenize(t) for t in texts], 6
    )
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(mask_a, mask_b)


def test_demoted_runs_reuse_chain_tokens(feat, monkeypatch):
    """Runs demoted to the batched path must NOT re-tokenize: the chain
    scanner already computed every event's token ids."""
    events = _word_events(20, context_cap=4)  # sliding windows -> demotion
    bb = feat.backbone
    ref = [np.asarray(x) for x in feat._compute_batched(bb, events)]
    calls = {"n": 0}
    orig = type(bb)._tokenize

    def counting(self, t):
        calls["n"] += 1
        return orig(self, t)

    monkeypatch.setattr(type(bb), "_tokenize", counting)
    out = [np.asarray(x) for x in feat._compute(events)]
    assert calls["n"] == len(events)  # once per event, in the scanner only
    for c, b in zip(out, ref):
        np.testing.assert_allclose(c, b, rtol=2e-5, atol=2e-6)


def test_single_word_and_empty_context(feat):
    events = [
        Word(start=0.0, duration=0.4, text="hi", context="hi", timeline="t"),
        Word(start=0.5, duration=0.4, text="there", context="hi there", timeline="t"),
    ]
    out = [np.asarray(x) for x in feat._compute(events)]
    ref = [np.asarray(x) for x in feat._compute_batched(feat.backbone, events)]
    for c, b in zip(out, ref):
        np.testing.assert_allclose(c, b, rtol=2e-5, atol=2e-6)
