"""The port's twin of tests/test_segmenter_divergence.py: the same cases over
the copies in algonauts2025_tpu_torch.

Sentence-segmenter divergence measurement (r3 verdict missing #3).

The reference segments transcripts with spacy statistical models
(reference utils.py:157-188) feeding AddText/AddSentenceToWords and hence
every text-feature context.  spacy cannot be installed here (zero
egress), so the rule-based segmenter is measured against HAND-LABELED
Friends-style dialogue corpora instead:

- ``dialogue_corpus.json`` — the development set the r4 rules were tuned
  on (interruption dashes, dotted acronyms, a.m./p.m. sentence ends,
  staccato fragments); pinned at exact agreement as a regression fixture.
- ``dialogue_corpus_heldout.json`` — written AFTER the r4 rules were
  frozen and measured as-is (no tuning loop).  Measured at P=0.949
  R=1.000 F1=0.974 at the r4 freeze (2 false splits: the title
  abbreviations "Gov."/"Fr.").  The r5 rule set added the title and
  month abbreviation classes, which closed both; the corpus now reads
  P=R=F1=1.0 and is gated as a regression fixture alongside the dev set.
- ``dialogue_corpus_heldout2.json`` — written AFTER the r5 rule freeze
  (titles + months) and measured as-is.  P=0.974 R=1.000 F1=0.987 on
  74 gold sentences.  The single false split is the deliberately-planted
  day-abbreviation probe ("moved to Sat. at noon"): "sat"/"sun"/"may"
  are ordinary English words whose suppression would merge real
  boundaries, so the class is left open by design (recall > precision
  for context building — a missed boundary corrupts every following
  word's context, a false split only shortens one).  The residual bound:
  one FP per capitalized day-abbreviation + lowercase-follower, a
  pattern essentially absent from spoken-dialogue transcripts.

Divergence is also propagated through the production enhancer chain
(AddSentenceToWords -> AddContextToWords) to measure CONTEXT drift: the
fraction of words whose running context changes when segmentation
boundaries come from the gold labels instead of the rules.  ACCURACY.md
records the measured numbers.
"""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from algonauts2025_tpu_torch.data import text_match

FIXTURES = Path(__file__).parent / "fixtures"


def _load(name):
    return json.loads((FIXTURES / name).read_text())


def _gold_boundaries(item) -> set[int]:
    out, pos = set(), 0
    for s in item["sentences"][:-1]:
        pos += len(s)
        out.add(pos)
    return out


def _agreement(items) -> tuple[float, float, float, list]:
    tp = fp = fn = 0
    diffs = []
    for it in items:
        gold = _gold_boundaries(it)
        got = {s.end for s in text_match.split_sentences(it["text"])}
        got -= {len(it["text"])}
        tp += len(gold & got)
        fp += len(got - gold)
        fn += len(gold - got)
        if gold != got:
            diffs.append((it["text"], sorted(gold), sorted(got)))
    prec = tp / (tp + fp) if tp + fp else 1.0
    rec = tp / (tp + fn) if tp + fn else 1.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return prec, rec, f1, diffs


def test_dev_corpus_exact_agreement():
    """The tuned rules reproduce every hand-labeled boundary on the
    development corpus — a regression pin for the r4 rule set."""
    prec, rec, f1, diffs = _agreement(_load("dialogue_corpus.json"))
    assert f1 == 1.0, diffs


def test_heldout_corpus_agreement_bound():
    """r4 held-out corpus (measured 0.974 at the r4 freeze): the r5 title
    abbreviation rules closed both known false splits, so it is now a
    full-agreement regression fixture like the dev corpus."""
    prec, rec, f1, diffs = _agreement(_load("dialogue_corpus_heldout.json"))
    assert f1 == 1.0, (prec, rec, f1, diffs)


def test_heldout2_corpus_agreement_bound():
    """r5 held-out corpus (written after the r5 rule freeze, measured
    as-is: P=0.974 R=1.000 F1=0.987).  The one FP is the documented
    day-abbreviation probe ("Sat. at noon") — left open by design, see
    module docstring.  Gates: F1 >= 0.98, and recall stays perfect
    (a missed boundary merges contexts — strictly worse than a split)."""
    prec, rec, f1, diffs = _agreement(_load("dialogue_corpus_heldout2.json"))
    assert f1 >= 0.98, (prec, rec, f1, diffs)
    assert rec == 1.0, (prec, rec, f1, diffs)


def _contexts_for(text: str, seg_fn, sentence_only: bool = False) -> list[str]:
    """Run the PRODUCTION enhancer chain over one transcript snippet with
    ``seg_fn`` as the segmenter; return each word's running context."""
    from algonauts2025_tpu_torch.core import validate_events
    from algonauts2025_tpu_torch.data.enhancers import (
        AddContextToWords,
        AddSentenceToWords,
    )

    rows = []
    t = 0.0
    words = text.split()
    for w in words:
        rows.append(
            dict(type="Word", text=w, start=round(t, 2), duration=0.3,
                 timeline="tl", language="english", split="train")
        )
        t += 0.5
    rows.append(
        dict(type="Text", text=text, start=0.0, duration=t + 1.0,
             timeline="tl", language="english", split="train")
    )
    events = validate_events(pd.DataFrame(rows))

    orig = text_match.split_sentences
    text_match.split_sentences = seg_fn
    try:
        events = AddSentenceToWords(max_unmatched_ratio=0.5)(events)
        events = AddContextToWords(sentence_only=sentence_only)(events)
    finally:
        text_match.split_sentences = orig
    out = events[events.type == "Word"].sort_values("start")
    return out.context.tolist()


def test_context_drift_from_segmentation():
    """Propagate rule-vs-gold segmentation through the production
    AddSentenceToWords -> AddContextToWords chain and measure how many
    word contexts actually change.  Gates the end-to-end impact of the
    segmenter approximation on the text features (r3 verdict #6)."""
    items = (
        _load("dialogue_corpus.json")
        + _load("dialogue_corpus_heldout.json")
        + _load("dialogue_corpus_heldout2.json")
    )

    def gold_fn_for(item):
        spans = []
        pos = 0
        for s in item["sentences"]:
            spans.append(text_match.Sentence(start=pos, end=pos + len(s), text=s))
            pos += len(s)

        def seg(text, _spans=spans, _item=item):
            assert text == _item["text"]
            return _spans

        return seg

    total = drifted = 0
    drift_snippets = 0
    for it in items:
        got = _contexts_for(it["text"], text_match.split_sentences)
        want = _contexts_for(it["text"], gold_fn_for(it))
        assert len(got) == len(want)
        n_diff = sum(a != b for a, b in zip(got, want))
        total += len(got)
        drifted += n_diff
        drift_snippets += bool(n_diff)
    rate = drifted / total
    # Measured at rule freeze: ZERO.  Structural, not lucky: with the
    # production config (sentence_only=False, reference defaults.py), the
    # context is past_sentences + current-sentence prefix — i.e. the
    # cumulative transcript prefix up to the word — which is INVARIANT to
    # where the sentence boundaries fall.  Segmentation divergence can
    # only reach text features through sentence_only=True (not in any
    # deployed config) or unmatched-word fallbacks.  ACCURACY.md records
    # this finding; the assert keeps the invariance from silently
    # breaking if the context construction changes.
    assert rate == 0.0, (rate, drifted, total, drift_snippets)


def test_context_drift_harness_detects_divergence():
    """Sanity check on the zero above: with sentence_only=True the same
    harness MUST show drift on a snippet whose rule segmentation differs
    from gold — proving the measurement can detect divergence at all."""
    items = [
        it
        for it in _load("dialogue_corpus_heldout.json")
        + _load("dialogue_corpus_heldout2.json")
        if _gold_boundaries(it)
        != {s.end for s in text_match.split_sentences(it["text"])}
        - {len(it["text"])}
        and len(it["sentences"]) > 1
    ]
    if not items:
        # the rules fully agree with every corpus: synthesize divergence
        # by mis-labeling a multi-sentence snippet as one gold sentence —
        # the harness must still see the disagreement
        src = next(
            it
            for it in _load("dialogue_corpus_heldout.json")
            if len(it["sentences"]) > 1
        )
        items = [{"text": src["text"], "sentences": [src["text"]]}]
    it = items[0]

    spans, pos = [], 0
    for s in it["sentences"]:
        spans.append(text_match.Sentence(start=pos, end=pos + len(s), text=s))
        pos += len(s)

    got = _contexts_for(it["text"], text_match.split_sentences, sentence_only=True)
    want = _contexts_for(it["text"], lambda _t: spans, sentence_only=True)
    assert got != want  # the harness sees the boundary disagreement
