"""The DeepSeek-V2-Lite word stream, as the ``LLAMA3p2`` feature runs it.

Set-up makes the model's weights from the seed on the device in the HF
checkpoint's layout, one tensor at a time (``reference.SeededWeights``), and
loads them through the port's ``load_text_backbone``, as a checkpoint is
loaded; makes a pool of seeded transcripts (``make_pool``: words drawn from
a Zipf vocabulary, grouped into sentences, timed at a dialogue's rate) and
gives every word its rolling left context with the port's own
``AddContextToWords``, as ``grids/defaults.py`` sets it up; and warms up one
chain forward at each token bucket and one padded batch.  The tokenizer is
seeded too (``SeededTokenizer``).

The window is ``encode_word_stream`` over the pool's transcripts in order,
cycled, one call a transcript: the first ~790 words of a transcript
(contexts of up to 1024 tokens, nested prefixes) go through chain forwards
of one context for 64 words each, the rest through padded batches of 8 x
1024 tokens; one dispatch in flight, each word's (L+1, D) states back on
the host.  The window is cut at a word boundary once ``--seconds`` have
passed and the first padded batch, which the check reads, has been
dispatched (a few seconds in at full size).

The check: the window's first chain dispatch whole and 24 further answers
drawn from the seed across both paths, each against the reference's states
of the same token ids (``state_gap``); layer 0's MLA output and the first
MoE layer's output of the window's first padded batch, on the program's own
input (taken by hooks), against the reference's of that input
(``first_attention_gap``, ``first_moe_gap``); the attention's own part of
layer 0's MLA, its output on the program's own rotated q, k and v, against
the reference's attention of them (``first_attention_core_gap``: the MLA
output also carries the projections' rounding flips, which the averaging
over up to 1024 keys makes large beside its small output); and the share
of that batch's tokens whose top-6 experts differ from the reference's on
the same input (``route_mismatch_share``).
"""

from __future__ import annotations

import gc
import hashlib
import math
import re
import time

import numpy as np
import pandas as pd
import torch

from algonauts2025_tpu_torch.data.enhancers import AddContextToWords
from algonauts2025_tpu_torch.features.text import TorchTextBackbone, encode_word_stream, load_text_backbone
from benchmark.common.seeds import derive
from benchmark.common.trace import span
from benchmark.reference import deepseek_v2_lite as reference

#: answers drawn from each path besides the first chain dispatch
SAMPLED_PER_PATH = 12
#: the largest model this driver builds off the card (the full one needs the card)
MAX_CPU_PARAMS = 2e9
_PIECE = re.compile(r"[a-z]+|[^\sa-z]")


class SeededTokenizer:
    """Text -> ids: lowercase letter runs and single other characters, each
    a piece; a run of up to 6 letters gives 1 id, 7-10 letters 2, 11-12
    letters 3 and each further 4 letters one more, a punctuation mark 1
    (about 1.3 ids a word of the traffic, a BPE tokenizer's rate on
    English); the ids are drawn from a hash of the piece under the seed,
    below ``n_ids``.  Single spaces never merge pieces, so the port's
    per-word tokenization cache is exact for it."""

    def __init__(self, seed: int, n_ids: int) -> None:
        self.key = derive(seed, "tokenizer").to_bytes(8, "little")
        self.n_ids = n_ids
        self._cache: dict[str, tuple[int, ...]] = {}

    @staticmethod
    def count(piece: str) -> int:
        n = len(piece)
        if not piece.isalpha() or n <= 6:
            return 1
        return 2 if n <= 10 else 3 + (n - 11) // 4

    def _ids(self, piece: str) -> tuple[int, ...]:
        ids = self._cache.get(piece)
        if ids is None:
            digest = hashlib.blake2b(piece.encode(), key=self.key, digest_size=32).digest()
            ids = tuple(int.from_bytes(digest[4 * i:4 * i + 4], "little") % self.n_ids
                        for i in range(self.count(piece)))
            self._cache[piece] = ids
        return ids

    def __call__(self, text: str) -> list[int]:
        return [i for piece in _PIECE.findall(text.lower()) for i in self._ids(piece)]


def vocabulary(traffic: dict, seed: int) -> list[str]:
    """``vocabulary`` words of 1-12 letters by Zipf rank: the mean length
    grows with the log of the rank (short words are the frequent ones)."""
    rng = np.random.default_rng(derive(seed, "vocabulary"))
    n = traffic["vocabulary"]
    ranks = np.arange(n)
    lengths = np.clip(np.rint(2.0 + 0.62 * np.log1p(ranks) + rng.normal(0, 1.5, n)),
                      traffic["min_letters"], traffic["max_letters"]).astype(int)
    letters = rng.integers(0, 26, (n, traffic["max_letters"]))
    return ["".join(chr(97 + c) for c in row[:k]) for row, k in zip(letters, lengths)]


class Transcript:
    """One transcript: its words' ``(text, context)`` pairs, their start
    times in seconds, and its duration."""

    def __init__(self, words: list[tuple[str, str]], starts: np.ndarray, duration: float) -> None:
        self.words, self.starts, self.duration = words, starts, duration

    def cover(self) -> np.ndarray:
        """The seconds each word answers for: to the next word's start, the
        last word to the transcript's end."""
        return np.diff(self.starts, append=self.duration)


def make_pool(traffic: dict, seed: int) -> list[Transcript]:
    """The pool's transcripts in order: a duration each, filled by sentences
    of ``sentence_words`` words ending in a mark, each sentence spoken at a
    rate of its own between ``min_words_per_s`` and ``max_words_per_s`` (its
    words' starts uniform over its span; the first word at 0, the last
    sentence cut at the end), each word drawn from the vocabulary by Zipf
    rank, and every word's rolling context from ``AddContextToWords``.  The
    rate is drawn a sentence, not a transcript: a window covers one to two
    transcripts, and one rate a transcript made the seconds a word answers
    for, and so ``stim_s``, differ by up to 25 % from seed to seed."""
    rng = np.random.default_rng(derive(seed, "transcripts"))
    vocab = vocabulary(traffic, seed)
    weights = 1.0 / np.arange(1, len(vocab) + 1) ** traffic["zipf_exponent"]
    weights /= weights.sum()
    enhancer = AddContextToWords(sentence_only=False, max_context_len=traffic["max_context_len"])
    lo, hi = traffic["sentence_words"]
    pool = []
    for k in range(traffic["transcripts"]):
        duration = float(rng.uniform(traffic["min_transcript_s"], traffic["max_transcript_s"]))
        sentences, t = [], 0.0
        while t < duration:
            m = int(rng.integers(lo, hi + 1))
            span = m / rng.uniform(traffic["min_words_per_s"], traffic["max_words_per_s"])
            times = np.sort(rng.uniform(t, t + span, m))
            sentences.append(times[times < duration])
            t += span
        starts = np.concatenate(sentences)
        starts[0] = 0.0
        n = len(starts)
        texts = [vocab[i] for i in rng.choice(len(vocab), n, p=weights)]
        rows, i = [], 0
        for times in sentences:
            m = len(times)
            if not m:
                continue
            words = texts[i:i + m]
            sentence = " ".join(words) + str(rng.choice([".", ".", ".", "?", "!"]))
            char = 0
            for j, w in enumerate(words):
                rows.append({"type": "Word", "text": w, "start": starts[i + j], "duration": 0.3,
                             "timeline": f"transcript{k}", "split": "train", "sentence": sentence,
                             "sentence_char": float(char)})
                char += len(w) + 1
            i += m
        events = enhancer(pd.DataFrame(rows))
        pool.append(Transcript(list(zip(events.text, events.context)), starts, duration))
    return pool


def cpu_params(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape, _ in reference.weight_spec(cfg))


def first_moe_layer(cfg: dict) -> int:
    return next(i for i in range(cfg["num_hidden_layers"]) if reference.is_moe(cfg, i))


class Sample:
    """The answers the check covers: the window's first chain dispatch (the
    pool's first words, up to ``chain_chunk`` of them, whose contexts nest
    within the chain's token limit) and answers drawn from the seed
    among ``answered`` stream positions, half from contexts within the
    chain's token limit, half beyond it."""

    def __init__(self, pool: list[Transcript], tokenizer, traffic: dict, seed: int, answered: int) -> None:
        words = [w for t in pool for w in t.words]
        limit = traffic["max_context_tokens"]
        ids = []
        for text, context in words[:min(traffic["chain_chunk"], answered)]:
            x = tokenizer(context or text)
            if len(x) > limit:
                break
            ids.append(x)
        first = words[:len(ids)]
        self.first = torch.tensor(ids[-1], dtype=torch.long)
        self.first_pool = reference.pool_matrix(len(ids[-1]), [(len(x), max(1, min(len(t), len(x))))
                                                               for x, (t, _) in zip(ids, first)])
        gen = np.random.default_rng(derive(seed, "answers"))
        short, long_ = [], []
        for i in gen.permutation(np.arange(len(first), answered)):
            text, context = words[i % len(words)]
            (short if len(tokenizer(context or text)) <= limit else long_).append(int(i))
            if min(len(short), len(long_)) >= 2 * SAMPLED_PER_PATH:
                break
        n_long = min(len(long_), max(SAMPLED_PER_PATH, 2 * SAMPLED_PER_PATH - len(short)))
        self.positions = sorted(short[:2 * SAMPLED_PER_PATH - n_long] + long_[:n_long])
        self.sequences, self.pools = [], []
        for i in self.positions:
            text, context = words[i % len(words)]
            x = tokenizer(context or text)[-limit:]
            self.sequences.append(torch.tensor(x, dtype=torch.long))
            self.pools.append(reference.pool_matrix(len(x), [(len(x), max(1, min(len(text), len(x))))]))


def first_batch(pool: list[Transcript], tokenizer, traffic: dict) -> list[torch.Tensor]:
    """The token ids of the first padded batch of the pool's first
    transcript: its first ``batch_size`` words beyond the chain's limit."""
    limit = traffic["max_context_tokens"]
    out = []
    for text, context in pool[0].words:
        x = tokenizer(context or text)
        if len(x) > limit:
            out.append(torch.tensor(x[-limit:], dtype=torch.long))
            if len(out) == traffic["batch_size"]:
                break
    return out


class Driver:
    def __init__(self, run) -> None:
        self.run = run
        cfg, traffic = run.config, run.traffic
        if run.device.type != "cuda" and cpu_params(cfg) > MAX_CPU_PARAMS:
            raise SystemExit(f"{cpu_params(cfg)} parameters: this configuration runs on the card; on the CPU "
                             "give it a small one (benchmark/tests/test_bench_text.py)")
        self.tokenizer = SeededTokenizer(run.seed, cfg["bos_token_id"])
        self.pool = make_pool(traffic, run.seed)
        self.words = [w for t in self.pool for w in t.words]
        self.cover = np.concatenate([t.cover() for t in self.pool])
        self.backbone: TorchTextBackbone = load_text_backbone(
            reference.SeededWeights(cfg, run.seed, run.device), cfg, self.tokenizer, cfg["eos_token_id"],
            device=run.device)
        self.encode = encode_word_stream
        self.stream_args = {k: traffic[k] for k in ("batch_size", "max_context_tokens", "min_chain", "chain_chunk")}
        self.forward_lengths: list[list[int]] = []
        self.captured: dict[str, torch.Tensor] = {}
        self._armed = self._capture = False
        forward = self.backbone._forward

        def recorded_forward(ids, mask):
            """Each forward's valid tokens by row, and the window's first
            padded batch's inputs and outputs (by the hooks)."""
            lengths = np.asarray(mask).sum(axis=-1)
            self.forward_lengths.append([int(n) for n in lengths])
            self._capture = self._armed and len(lengths) > 1
            if self._capture:
                self._armed = False
                self.captured["lengths"] = torch.from_numpy(lengths.astype(np.int64))
            out = forward(ids, mask)
            self._capture = False
            return out

        self.backbone._forward = recorded_forward
        model = self.backbone.model
        attention, moe = model.layers[0].attn, model.layers[first_moe_layer(cfg)].mlp
        attention.register_forward_pre_hook(self._take("attention_input"))
        attention.register_forward_hook(self._take("attention_output", output=True))
        core = getattr(attention, "core", None)  # the attention's q, k, v and output, where the port has it
        if core is not None:
            for item, key in enumerate(("core_q", "core_k", "core_v")):
                core.register_forward_pre_hook(self._take(key, item=item))
            core.register_forward_hook(self._take("core_output", output=True))
        moe.register_forward_pre_hook(self._take("moe_input"))
        moe.register_forward_hook(self._take("moe_output", output=True))
        moe.gate.register_forward_hook(self._take("moe_ids", output=True, item=1))

    def _take(self, key: str, output: bool = False, item: int = 0):
        """A hook that keeps, while a capture is on, the module's first
        argument (or its output, or item ``item`` of it), on the device."""
        def hook(module, args, *out):
            if self._capture:
                value = out[0] if output else args
                self.captured[key] = value[item] if isinstance(value, tuple) else value
        return hook

    def prepare(self) -> None:
        """One chain forward at each token bucket up to the chain's limit
        (the up to ``chain_chunk`` words of the first transcript whose
        contexts end at the bucket's last fill) and one padded batch (the
        first transcript's first ``batch_size`` words beyond the limit):
        every shape of the window, the largest among them."""
        traffic = self.run.traffic
        words = self.pool[0].words
        lengths = [len(self.tokenizer(c or t)) for t, c in words]
        limit = traffic["max_context_tokens"]
        for bucket in TorchTextBackbone.BUCKETS:
            end = max((i + 1 for i, n in enumerate(lengths) if n <= min(bucket, limit)), default=0)
            if end:
                for _ in self.encode(self.backbone, words[max(0, end - traffic["chain_chunk"]):end],
                                     **self.stream_args):
                    pass
        beyond = [w for w, n in zip(words, lengths) if n > limit][:traffic["batch_size"]]
        for _ in self.encode(self.backbone, beyond, **self.stream_args):
            pass

    def _stream(self):
        """The pool's transcripts in order, cycled, one ``encode_word_stream``
        call each: a call tokenizes its words before its first dispatch, so
        a transcript a call pays that up front as a study's ``_compute``
        does, in proportion to the words it answers."""
        while True:
            for transcript in self.pool:
                yield from self.encode(self.backbone, transcript.words, **self.stream_args)

    def _checked(self) -> bool:
        """Whether the window holds what the check reads: the first padded
        batch (a few seconds into a full-size window), or a whole pass of
        the pool."""
        return "moe_ids" in self.captured or len(self.answers) >= len(self.words)

    def window(self, seconds: float, tracer) -> dict:
        sync = torch.cuda.synchronize if self.run.device.type == "cuda" else (lambda: None)
        counts = getattr(self.backbone, "counts", None)  # the port's counters, where it has them
        if counts is not None:
            self.backbone.reset_counts()
        model = self.backbone.model
        if hasattr(model, "reset_expert_tokens"):
            model.reset_expert_tokens()
        self.forward_lengths = []
        self.answers: list[np.ndarray] = []
        self.captured = {}
        self._armed = True
        sync()
        with tracer.window():
            t0 = time.perf_counter()
            with span("stream"):
                stream = self._stream()
                for latents in stream:
                    self.answers.append(latents)
                    if time.perf_counter() - t0 >= seconds and self._checked():
                        break
                stream.close()
            elapsed = time.perf_counter() - t0
        n = len(self.answers)
        work = {"window_s": elapsed, "words": n,
                "stim_s": float(sum(self.cover[i % len(self.words)] for i in range(n))),
                "attempted": n, "failed": sum(not np.isfinite(a).all() for a in self.answers),
                "forward_lengths": self.forward_lengths}
        if counts is not None:
            work.update(counts)
        if hasattr(model, "expert_tokens"):
            work["expert_tokens"] = model.expert_tokens.tolist()  # read once, after the window
        return work

    def release(self) -> None:
        """Free the model: the wrapped ``_forward`` holds the backbone in a
        reference cycle, so collect it before the cache is emptied."""
        del self.backbone
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def numbers(self) -> dict[str, float]:
        """The sample's answers against the reference's states of the same
        token ids (the worst answer's ``state_gap``); the first padded
        batch's layer-0 MLA and first MoE layer on the program's own input
        against the reference's of that input."""
        run, cfg = self.run, self.run.config
        sample = Sample(self.pool, self.tokenizer, run.traffic, run.seed, len(self.answers))
        nan = float("nan")
        out = {"state_gap": nan, "first_attention_gap": nan, "first_attention_core_gap": nan, "first_moe_gap": nan,
               "route_mismatch_share": nan}
        with reference.no_tf32():
            model = reference.Model(cfg, run.seed, run.device)
            states = model.run([sample.first, *sample.sequences], [sample.first_pool, *sample.pools])
            first = states[0]
            gaps = [reference.state_gap(torch.from_numpy(self.answers[i]), first[:, i])
                    for i in range(first.shape[1])]
            gaps += [reference.state_gap(torch.from_numpy(self.answers[i]), s[:, 0])
                     for i, s in zip(sample.positions, states[1:])]
            out["state_gap"] = max(gaps)
            if "moe_ids" not in self.captured:
                return out
            c = self.captured
            lengths = c["lengths"].tolist()
            w0 = model.weights(0)
            got = torch.cat([c["attention_output"][b, :n] for b, n in enumerate(lengths)])
            ref = torch.cat([model.attention(w0, c["attention_input"][b, :n].float()) for b, n in enumerate(lengths)])
            out["first_attention_gap"] = reference.rel_gap(got, ref)
            got = torch.cat([c["core_output"][b, :, :n] for b, n in enumerate(lengths)], dim=1)
            ref = torch.cat([model.attend(*(c[key][b, :, :n].float() for key in ("core_q", "core_k", "core_v")))
                             for b, n in enumerate(lengths)], dim=1)
            out["first_attention_core_gap"] = reference.rel_gap(got, ref)
            del w0
            w1 = model.weights(first_moe_layer(cfg))
            rows = torch.cat([c["moe_input"][b, :n] for b, n in enumerate(lengths)]).float()
            ref, ref_ids = model.moe(w1, rows)
            got = torch.cat([c["moe_output"][b, :n] for b, n in enumerate(lengths)])
            t = c["moe_input"].shape[1]
            got_ids = torch.cat([c["moe_ids"][b * t:b * t + n] for b, n in enumerate(lengths)])
            out["first_moe_gap"] = reference.rel_gap(got, ref)
            out["route_mismatch_share"] = reference.route_mismatch(got_ids, ref_ids)
        return out


#: the controls: each precision the configuration states, one step lower on
#: its own (the fp32 scores in bf16, the fp32 router in bf16, the routed
#: experts' bf16 in fp8 e4m3)
CONTROLS = {"bf16_scores": {"scores": "bf16"}, "bf16_router": {"router": "bf16"}, "fp8_experts": {"experts": "fp8"}}


def control(run) -> dict[str, dict[str, float]]:
    """Each control's reference in the program's place, on the sample the
    window would check (answers drawn over one pass of the pool) and on the
    pool's first padded batch: the numbers by the control's name."""
    cfg, traffic = run.config, run.traffic
    tokenizer = SeededTokenizer(run.seed, cfg["bos_token_id"])
    pool = make_pool(traffic, run.seed)
    sample = Sample(pool, tokenizer, traffic, run.seed, sum(len(t.words) for t in pool))
    batch = first_batch(pool, tokenizer, traffic)
    sequences, pools = [sample.first, *sample.sequences], [sample.first_pool, *sample.pools]
    captured = range(len(sequences), len(sequences) + len(batch))
    out = {}
    with reference.no_tf32():
        base = reference.Model(cfg, run.seed, run.device)
        states = base.run(sequences + batch, pools + [torch.zeros(0, len(x)) for x in batch], capture=captured)
        w0, w1 = base.weights(0), base.weights(first_moe_layer(cfg))
        inputs = [base.attention_inputs[j] for j in captured]
        attention = torch.cat([base.attention(w0, a) for a in inputs])
        qkv = [base.qkv(w0, a) for a in inputs]
        core = torch.cat([base.attend(*x) for x in qkv], dim=1)
        rows = torch.cat([base.moe_inputs[j] for j in captured])
        moe, ids = base.moe(w1, rows)
        for name, lower in CONTROLS.items():
            low = reference.Model(cfg, run.seed, run.device, **lower)
            low_states = low.run(sequences, pools)
            low_moe, low_ids = low.moe(w1, rows)
            gaps = [reference.state_gap(a, b) for s, r in zip(low_states, states)
                    for a, b in zip(s.transpose(0, 1), r.transpose(0, 1))]
            out[name] = {"state_gap": max(gaps),
                         "first_attention_gap": reference.rel_gap(torch.cat([low.attention(w0, a) for a in inputs]),
                                                                  attention),
                         "first_attention_core_gap": reference.rel_gap(torch.cat([low.attend(*x) for x in qkv], dim=1),
                                                                       core),
                         "first_moe_gap": reference.rel_gap(low_moe, moe),
                         "route_mismatch_share": reference.route_mismatch(low_ids, ids)}
    return out


def _altered_answer(driver: Driver) -> None:
    """Every answer comes back one layer off (an off-by-one of the index
    into the hidden-state stack)."""
    encode = driver.encode

    def altered(*args, **kwargs):
        for latents in encode(*args, **kwargs):
            yield np.roll(latents, 1, axis=0)

    driver.encode = altered


FAULTS = {"altered_answer": _altered_answer}
