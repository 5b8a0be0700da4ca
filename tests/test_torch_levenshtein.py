"""The port's ``opcodes`` (data/levenshtein.py) against ``Levenshtein.opcodes``.

The C++ behind the Levenshtein package picks one of many optimal edit
scripts; the port must pick the same one: on short inputs (one matrix and
its backtrace), on long ones (the Hirschberg split, from ~2,048 symbols of
matrix on), on tie-heavy small alphabets and on near-identical
transcript-like word sequences.  ``match_list`` must then give the JAX
package's index pairs.  The Levenshtein package is the oracle here only;
the port never imports it.
"""

import random
import time

import Levenshtein
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from algonauts2025_tpu.data import text_match as jax_text_match
from algonauts2025_tpu_torch.data import text_match
from algonauts2025_tpu_torch.data.levenshtein import editops, opcodes


def _random(n, k, rng):
    return "".join(chr(97 + rng.randrange(k)) for _ in range(n))


def _assert_same(a, b):
    assert opcodes(a, b) == Levenshtein.opcodes(a, b)


def _assert_same_match(a, b):
    for on_replace in ("delete", "keep"):
        got = text_match.match_list(a, b, on_replace=on_replace)
        want = jax_text_match.match_list(a, b, on_replace=on_replace)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@st.composite
def _pairs(draw):
    alphabet = "abcde"[: draw(st.integers(2, 5))]
    a = draw(st.text(alphabet=alphabet, max_size=1500))
    b = draw(st.one_of(st.text(alphabet=alphabet, max_size=1500),
                       st.builds(lambda i, j, s: a[:i] + s + a[j:], st.integers(0, len(a)),
                                 st.integers(0, len(a)), st.text(alphabet=alphabet, max_size=40))))
    return a, b


@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(_pairs())
def test_opcodes_equal_on_small_alphabets(pair):
    _assert_same(*pair)
    _assert_same_match(*pair)


@pytest.mark.parametrize("a,b", [
    ("", ""), ("", "abc"), ("abc", ""), ("a", "a"), ("ab", "ba"), ("spam", "park"),
    ("qabxcd", "abycdf"), ("a" * 100, "b" * 3), ("ab" * 50, "ba" * 50),
])
def test_opcodes_equal_on_edge_cases(a, b):
    _assert_same(a, b)


def _transcripts(n_words, seed, rate):
    """A transcript of ``n_words`` words and a near-identical one (words
    dropped, swapped and inserted at ``rate``), as ``match_list`` encodes
    word sequences: one symbol a distinct word."""
    rng = random.Random(seed)
    vocab = ["".join(chr(97 + rng.randrange(26)) for _ in range(rng.randrange(1, 9)))
             for _ in range(3000)]
    a = [vocab[min(int(rng.paretovariate(1.2)), 2999)] for _ in range(n_words)]
    b = []
    for word in a:
        x = rng.random()
        if x < rate / 3:
            continue
        if x < 2 * rate / 3:
            b.append(vocab[rng.randrange(3000)])
            continue
        b.append(word)
        if x < rate:
            b.append(vocab[rng.randrange(3000)])
    return a, b


@pytest.mark.parametrize("n_words,rate", [(3000, 0.02), (3000, 0.2), (8000, 0.05), (20000, 0.03)])
def test_opcodes_equal_on_near_identical_transcripts(n_words, rate):
    a, b = _transcripts(n_words, seed=n_words, rate=rate)
    _assert_same(*text_match._encode_as_text(a, b))
    _assert_same_match(a, b)


@pytest.mark.parametrize("n", [2048, 2100, 3000, 5000])
@pytest.mark.parametrize("k", [2, 4, 5])
def test_opcodes_equal_on_long_tie_heavy_pairs(n, k):
    """Long random pairs over 2-5 symbols: many optimal scripts, and the
    split of long inputs decides which one comes out."""
    rng = random.Random(n * 10 + k)
    a, b = _random(n, k, rng), _random(int(n * rng.uniform(0.8, 1.2)), k, rng)
    _assert_same(a, b)
    _assert_same_match(a, b)


def test_editops_apply():
    """The edit operations turn one string into the other."""
    rng = random.Random(1)
    a, b = _random(2500, 3, rng), _random(2300, 3, rng)
    out, src = [], 0
    for tag, i, j in editops(a, b):
        out.append(a[src:i])
        src = i
        if tag == "insert":
            out.append(b[j])
        elif tag == "replace":
            out.append(b[j])
            src += 1
        else:
            src += 1
    out.append(a[src:])
    assert "".join(out) == b
    assert len(editops(a, b)) == Levenshtein.distance(a, b)


def test_opcodes_time_at_3000_symbols():
    rng = random.Random(0)
    a, b = _random(3000, 4, rng), _random(3000, 4, rng)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        opcodes(a, b)
        best = min(best, time.perf_counter() - t0)
    assert best < 0.5, best
