"""Transcript-to-text alignment: sentence segmentation + fuzzy matching.

Replaces the reference's spacy + Levenshtein pipeline (reference
data_utils/data_utils/utils.py:25-59 match_list, enhancers.py:499-594
_match_text_words) with a self-contained rule-based sentence segmenter and
the same editops-based alignment (data/levenshtein.py gives the
Levenshtein package's opcodes without it).  All host-side, offline preprocessing.
"""

from __future__ import annotations

import dataclasses
import re
import typing as tp

import numpy as np

from .levenshtein import opcodes

__all__ = ["match_list", "split_sentences", "tokenize", "match_text_words", "Token"]

_ABBREV = {
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc", "e.g", "i.e",
    "a.m", "p.m", "u.s", "inc", "ltd", "co", "gen", "col", "capt", "sgt",
    "ave", "blvd", "rd", "mt", "ft", "dept", "approx",
    # titles that precede proper names (r4 held-out corpus found "Gov."
    # and "Fr." causing false splits — ACCURACY.md r4; closed in r5).
    # Tokens that are ALSO ordinary dialogue words live in the
    # capitalized-only set below instead.
    "fr", "lt", "maj", "cmdr", "det", "supt", "adm", "cpl", "pvt",
    "msgr", "atty",
    # month abbreviations ("Jan. 12"); terminal-capable, see below.  Day
    # abbreviations are deliberately NOT listed: "sat"/"sun"/"may" are
    # ordinary words whose suppression would merge real boundaries
    # (recall matters more than precision for context building).
    "jan", "feb", "apr", "jun", "jul", "aug", "sep", "sept",
    "oct", "nov", "dec",
}

#: abbreviations that collide with ordinary lowercase words ("thanks,
#: sis." is NOT Sister; "his rep. Nobody trusts him", "give it a rev.",
#: "all right, gov.", "don't mar. the finish"): suppression applies only
#: when the RAW token is capitalized — the title/month register ("Gov.
#: Whitmore", "Rep. Alvarez", "Mar. 12") — so the lowercase word usage
#: keeps its sentence boundary (r5 meta-review: the unconditional list
#: merged vocative-final sentences, the worst failure class).
_CAPITALIZED_ONLY_ABBREV = {"gov", "rev", "rep", "pres", "sen", "hon", "mar"}


def _encode_as_text(A: tp.Sequence, B: tp.Sequence) -> tuple[str, str]:
    """Map two symbol sequences onto one shared character alphabet so the
    string edit-distance machinery can align them.  Any bijection works
    (the aligner only tests equality)."""
    alphabet: dict = {}
    for symbol in list(A) + list(B):
        alphabet.setdefault(symbol, len(alphabet))
    return (
        "".join(chr(alphabet[s]) for s in A),
        "".join(chr(alphabet[s]) for s in B),
    )


def match_list(A, B, on_replace: str = "delete"):
    """Align two sequences; returns matched index pairs (A_sel, B_sel).

    Pairs come from the equal blocks of an optimal edit script (plus the
    replace blocks when ``on_replace == "keep"``).  Same contract as the
    reference's match_list (data_utils utils.py:25-59), implemented over
    merged opcode blocks instead of per-position editops.
    """
    if on_replace not in ("delete", "keep"):
        raise NotImplementedError(f"unknown on_replace={on_replace!r}")
    if not isinstance(A, str):
        A, B = _encode_as_text(A, B)
    keep = {"equal"} | ({"replace"} if on_replace == "keep" else set())
    a_idx: list[int] = []
    b_idx: list[int] = []
    for tag, a0, a1, b0, b1 in opcodes(A, B):
        if tag in keep:
            a_idx.extend(range(a0, a1))
            b_idx.extend(range(b0, b1))
    out_a = np.asarray(a_idx, dtype=int)
    out_b = np.asarray(b_idx, dtype=int)
    assert out_a.size == out_b.size
    return out_a, out_b


@dataclasses.dataclass
class Sentence:
    start: int  # char offset in full text
    end: int  # char offset (exclusive, including trailing whitespace)
    text: str  # text with trailing whitespace


@dataclasses.dataclass
class Token:
    text: str
    idx: int  # char offset in full text
    sent: Sentence


_SENT_END = re.compile(r"(?:([.!?]+)([\"')\]]*)|([—–]|--))(\s+|$)")

#: abbreviations that CAN legitimately end a sentence ("lands at 2 a.m.
#: Naturally, ..."): an uppercase follower overrides the suppression
_TERMINAL_OK_ABBREV = {"a.m", "p.m", "etc", "u.s", "inc", "ltd", "co",
                       # months: digits follow mid-sentence ("Jan. 12"
                       # suppresses via the non-upper follower); a capital
                       # follower means a new sentence ("back in Oct.
                       # Bring snacks.") — unlike titles, months never
                       # precede proper names
                       "jan", "feb", "mar", "apr", "jun", "jul", "aug",
                       "sep", "sept", "oct", "nov", "dec"}


def split_sentences(text: str) -> list[Sentence]:
    """Rule-based sentence segmentation over raw text.

    Splits after .!? (plus closing quotes/brackets) followed by whitespace,
    and after transcript-style interruption dashes handing over to a
    capital ("I just— You know what?").  Suppression rules, pinned by
    tests/test_sentence_segmentation.py and measured against the
    hand-labeled dialogue corpus (tests/test_segmenter_divergence.py):
    - a dotted acronym ("Ph.D.", "D.M.V.") splits only before an
      uppercase follower (its '.' is part of the token, not terminal —
      but lowercased ASR-style streams must still split after ordinary
      words, so the rule keys on the token, not the follower alone);
    - known abbreviations and single initials ("Mr.", "J."); the
      sentence-final-capable ones ("a.m.", "etc.") DO split before an
      uppercase follower;
    - "No." only when followed by a digit ("No. 5");
    - an ellipsis followed by a non-capital continues the sentence;
    - terminal punctuation inside quotes followed by a lowercase word is
      dialogue attribution ('"Run!" he shouted.') and continues.
    Trailing whitespace belongs to the sentence (spacy text_with_ws parity).
    """
    if not text:
        return []
    boundaries = [0]
    for m in _SENT_END.finditer(text):
        end = m.end()
        marks, trail, dash = m.group(1), m.group(2), m.group(3)
        following = text[end : end + 1]  # first char after the whitespace
        if dash is not None:
            # interruption dash: a boundary only when the dash is attached
            # to the truncated word AND the next utterance starts with a
            # capital ("fin— No, YOU listen").  A free-standing dash
            # ("the — Joey, stop it — museum") is a parenthetical aside,
            # not an interruption, whatever the case of what follows.
            attached = m.start() > 0 and not text[m.start() - 1].isspace()
            if attached and following.isupper() and end < len(text):
                boundaries.append(end)
            continue
        # ellipsis that does not hand over to a capital keeps flowing
        if set(marks) == {"."} and len(marks) > 1 and not following.isupper():
            continue
        # quoted terminal + lowercase word = dialogue attribution
        if any(c in "\"'" for c in trail) and following.islower():
            continue
        if "!" not in marks and "?" not in marks:
            # word immediately before the punctuation
            before = text[: m.start()].rstrip()
            raw_word = (
                before.split()[-1].strip("\"'()[]") if before.split() else ""
            ).rstrip(".")
            last_word = raw_word.lower()
            # ambiguous tokens ("Rep."/"rep", "Gov."/"gov", "Mar."/"mar")
            # count as abbreviations only in their capitalized
            # title/month register; lowercase is the ordinary word
            is_abbrev = last_word in _ABBREV or (
                last_word in _CAPITALIZED_ONLY_ABBREV and raw_word[:1].isupper()
            )
            # dotted acronym ("ph.d", "d.m.v"): the '.' belongs to the
            # token; split only when handing over to a capital.  Keyed on
            # an ALPHABETIC dot-stripped core so prices/percent decimals
            # ("$4.50", "20.5%") stay ordinary sentence-final words
            if "." in last_word and last_word.replace(".", "").isalpha():
                if not following.isupper():
                    continue
                if is_abbrev and last_word not in _TERMINAL_OK_ABBREV:
                    continue  # "e.g. Friday" still flows
            elif is_abbrev and not (
                last_word in _TERMINAL_OK_ABBREV and following.isupper()
            ):
                continue
            if len(last_word) == 1 and last_word.isalpha():
                continue
            if last_word == "no" and following.isdigit():
                continue
        if end < len(text):
            boundaries.append(end)
    boundaries.append(len(text))
    sents = []
    for a, b in zip(boundaries[:-1], boundaries[1:]):
        if text[a:b].strip():
            sents.append(Sentence(start=a, end=b, text=text[a:b]))
    if not sents:
        sents = [Sentence(start=0, end=len(text), text=text)]
    return sents


_TOKEN = re.compile(r"\S+")


def tokenize(text: str) -> list[Token]:
    """Whitespace tokens with char offsets, each linked to its sentence."""
    sents = split_sentences(text)
    tokens: list[Token] = []
    si = 0
    for m in _TOKEN.finditer(text):
        while si < len(sents) - 1 and m.start() >= sents[si].end:
            si += 1
        tokens.append(Token(text=m.group(), idx=m.start(), sent=sents[si]))
    return tokens


def word_preproc(word: str) -> str:
    return word.lower().strip('",. ()?!\n\t')


def match_text_words(
    text: str, words: tp.Sequence[str], language: str = ""
) -> tp.List[tp.Dict[str, tp.Any]]:
    """For each transcript word, find its sentence and char offset in text.

    Returns one dict per word with keys "sentence" (sentence text with
    trailing whitespace) and "sentence_char" (char offset of the word
    within its sentence); unmatched words inherit the enclosing sentence
    when their neighbors agree (reference enhancers.py:582-594).
    """
    tokens = tokenize(text)
    token_strs = [word_preproc(t.text) for t in tokens]
    word_strs = [word_preproc(w) for w in words]
    text_match, words_match = match_list(token_strs, word_strs)

    info: tp.List[tp.Dict[str, tp.Any]] = [{} for _ in words]
    for tm, wm in zip(text_match, words_match):
        tok = tokens[tm]
        info[wm]["sentence"] = tok.sent.text
        info[wm]["sentence_char"] = tok.idx - tok.sent.start

    # fill unmatched words whose neighbors share a sentence
    prev_sent: str | None = None
    missing: list[dict] = []
    for i in info:
        sent = i.get("sentence")
        if sent is None:
            missing.append(i)
            continue
        if prev_sent == sent:
            for m in missing:
                m["sentence"] = sent
        missing = []
        prev_sent = sent
    return info
