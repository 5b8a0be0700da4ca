"""Llama text features: frozen hidden states pooled per word.

The device side of algonauts2025_tpu/features/text.py.  Each word carries
its running left context; contexts are tokenized on the host (an
incremental per-word cache, checked against full tokenization), bucketed
by length to a few static widths and encoded in batches of the full (L+1)
hidden stack; a word's embedding is the mean of the hidden states over the
last ``len(word)`` token positions (the reference's quirk: the character
length of the word caps the token span), pooled on the device.  Rolling
contexts that are nested prefixes of each other run as one forward over
the longest prefix (a chain); the rest run as padded batches.

``encode_word_stream`` is the device side and takes ``(text, context)``
pairs; the pydantic ``LLAMA3p2`` feature runs it over ``Word`` events and
caches each word's (L+1, D) stack under its ``"{text}_{context}"`` uid.
"""

from __future__ import annotations

import hashlib
import logging
import re
import typing as tp

import numpy as np
import torch

from ..core.events import Event, Word
from ..core.timed import TimedArray
from ..models.backbones.llama import LlamaBackbone, LlamaConfig, params_from_hf
from ..parallel.mesh import LocalMesh, local_mesh
from ..parallel.pipeline import pipelined_llama_states, stage_layers
from ..runtime import default_device
from .base import LayeredFeatureBase

logger = logging.getLogger(__name__)

__all__ = [
    "LLAMA3p2",
    "TorchTextBackbone",
    "TinyTextBackbone",
    "HashTokenizer",
    "load_text_backbone",
    "load_hf_text_backbone",
    "encode_word_stream",
]

# any whitespace run, or whitespace that is not a plain single space:
# contexts containing these bypass the incremental tokenizer entirely
_NON_SIMPLE_WS = re.compile(r"\s\s|[^\S ]")

#: minimum run length for the single-forward chain path; shorter runs batch
#: better through the padded path
MIN_CHAIN = 8
#: words per chain dispatch (sub-chains of a prefix chain are prefix chains,
#: so splitting is exact); 64 fills the 64 word bucket exactly
CHAIN_CHUNK = 64


class HashTokenizer:
    """Deterministic hash tokenizer (whitespace words -> ids).

    Stand-in when the real tokenizer assets are unavailable; keeps the full
    pipeline runnable offline (synthetic studies, smoke tests)."""

    def __init__(self, vocab_size: int, pad_id: int = 0):
        self.vocab_size = vocab_size
        self.pad_id = pad_id

    def __call__(self, text: str) -> list[int]:
        out = []
        for w in text.split():
            h = int(hashlib.sha256(w.lower().encode()).hexdigest()[:8], 16)
            out.append(1 + h % (self.vocab_size - 1))
        return out


def _bucket(n: int, buckets: tp.Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _bucket_width(n: int, buckets: tp.Sequence[int], step: int = 512) -> int:
    """Static device width for ``n`` elements: bucket table first, then
    ``step``-multiples beyond the table (never silently truncate)."""
    width = _bucket(max(1, n), buckets)
    if n > width:
        width = -(-n // step) * step
    return width


def _pad_ids(
    seqs: tp.Sequence[tp.Sequence[int]], width: int, pad_id: int
) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad token sequences to ``(len(seqs), width)`` ids + mask.

    Keeps the END of over-long sequences (running contexts are
    left-truncated by contract); empty sequences become a single pad
    token so every row has >= 1 valid position."""
    ids = np.full((len(seqs), width), pad_id, dtype=np.int32)
    mask = np.zeros((len(seqs), width), dtype=np.int32)
    for i, s in enumerate(seqs):
        s = list(s[-width:]) if s else [pad_id]
        ids[i, : len(s)] = s
        mask[i, : len(s)] = 1
    return ids, mask


def _pipelined_columns(
    dispatches: tp.Iterable[tuple[tp.Any, int]],
) -> tp.Iterator[np.ndarray]:
    """One-deep dispatch pipeline over ``(pending_array, count)`` pairs.

    Yields fp32 ``array[:, j]`` columns for each pair, fetching batch i
    only after batch i+1 was dispatched: the host waits for batch i's
    copy while batch i+1 is queued on the device."""
    pending: tuple[tp.Any, int] | None = None
    for out, count in dispatches:
        if pending is not None:
            pooled = np.asarray(pending[0])  # (L+1, B, D)
            for j in range(pending[1]):
                yield pooled[:, j].astype(np.float32)
        pending = (out, count)
    if pending is not None:
        pooled = np.asarray(pending[0])
        for j in range(pending[1]):
            yield pooled[:, j].astype(np.float32)


class _HostCopy:
    """A device result on its way to the host: on a CUDA card the copy into
    pinned memory is queued (``non_blocking``) right behind the forward and
    an event marks its end; ``np.asarray`` waits for that event only."""

    def __init__(self, out: torch.Tensor):
        if out.is_cuda:
            self._host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self._host.copy_(out, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = out, None

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        out = self._host.numpy()
        return out if dtype is None else out.astype(dtype)


class TorchTextBackbone:
    """A LlamaBackbone + tokenizer on ``device`` (the CUDA card unless it
    says otherwise).

    With ``pipeline_mesh`` (a ``LocalMesh`` with axis "stage") the layer
    stack splits into contiguous stages, each stage's layers placed once on
    its device, and every forward runs the GPipe schedule of
    ``parallel.pipelined_llama_states``: the per-device weight memory is
    L/S of the stack.  The embedding and final norm stay on ``device``."""

    BUCKETS = (32, 64, 128, 256, 512, 1024)
    #: word-count buckets for the chain pooling matrix
    WBUCKETS = (16, 64, 256, 1024)

    def __init__(self, model: LlamaBackbone, tokenizer, pad_id: int,
                 device: str | torch.device | None = None, pipeline_mesh: LocalMesh | None = None):
        self.device = default_device(device)
        self.pipeline_mesh = pipeline_mesh
        if pipeline_mesh is None:
            self.model = model.to(self.device).eval()
        else:
            stages = stage_layers(model.cfg.num_layers, pipeline_mesh.shape["stage"])
            model.embed_tokens.to(self.device)
            model.final_norm.to(self.device)
            for stage, dev in zip(stages, pipeline_mesh.devices):
                for i in stage:
                    model.layers[i].to(dev)
            self.model = model.eval()
        self.tokenizer = tokenizer
        self.pad_id = pad_id
        # incremental tokenization state (see _tokenize): per-word id cache
        self._word_ids: dict[tuple[bool, str], tuple[int, ...]] = {}
        self._inc_checked = 0
        self._inc_enabled = True

    def _tokenize_full(self, t: str) -> list[int]:
        if hasattr(self.tokenizer, "encode"):  # HF tokenizer
            return list(self.tokenizer.encode(t, add_special_tokens=False))
        return list(self.tokenizer(t))

    def _tokenize(self, t: str) -> list[int]:
        """Incremental context tokenization: encode each word once, keyed by
        (is_first, word), and concatenate.  Exact for BPE tokenizers whose
        pre-tokenizer never merges across a single-space boundary (Llama-3's
        GPT-style regex; the leading space rides with the following word).

        Two safety layers: (1) STRUCTURAL: only contexts that are
        single-space-joined non-space words take the fast path; any
        whitespace run, tab, newline or unicode space falls through to full
        tokenization; (2) SAMPLED: the first 32 fast-path contexts are
        checked against full tokenization, then every 64th, for as long as
        the backbone lives, and the fast path switches off on any mismatch."""
        if not self._inc_enabled or " " not in t or _NON_SIMPLE_WS.search(t) is not None:
            return self._tokenize_full(t)
        ids: list[int] = []
        for i, w in enumerate(t.split(" ")):
            key = (i == 0, w)
            got = self._word_ids.get(key)
            if got is None:
                got = tuple(self._tokenize_full(w if i == 0 else " " + w))
                self._word_ids[key] = got
            ids.extend(got)
        self._inc_checked += 1
        if self._inc_checked <= 32 or self._inc_checked % 64 == 0:
            ref = self._tokenize_full(t)
            if ids != ref:
                logger.warning(
                    "incremental tokenization mismatch on %r; disabling the fast path for this backbone",
                    t[:80],
                )
                self._inc_enabled = False
                return ref
        return ids

    def encode(self, texts: list[str], max_len: int = 1024) -> tuple[np.ndarray, np.ndarray]:
        return self.encode_pretokenized([self._tokenize(t) for t in texts], max_len)

    def encode_pretokenized(
        self, seqs: tp.Sequence[tp.Sequence[int]], max_len: int = 1024
    ) -> tuple[np.ndarray, np.ndarray]:
        """``encode`` for already-tokenized sequences (the chain scanner
        tokenizes every word up front; demoted runs reuse those ids)."""
        seqs = [s[-max_len:] if len(s) > max_len else s for s in seqs]  # left-truncate
        longest = max((len(s) for s in seqs), default=1)
        return _pad_ids(seqs, _bucket_width(longest, self.BUCKETS), self.pad_id)

    def _forward(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        ids_t = torch.from_numpy(np.asarray(ids)).to(self.device, torch.long)
        mask_t = torch.from_numpy(np.asarray(mask)).to(self.device, torch.int32)
        if self.pipeline_mesh is None:
            return self.model(ids_t, mask_t)
        # the largest power-of-2 divisor of B up to 4: a smaller GPipe
        # bubble without splitting below one row
        b = ids_t.shape[0]
        m = 4 if b % 4 == 0 else (2 if b % 2 == 0 else 1)
        return pipelined_llama_states(self.model.cfg, self.model, ids_t, mask_t,
                                      self.pipeline_mesh, n_microbatches=m)

    @torch.no_grad()
    def hidden_states(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        return self._forward(ids, mask).cpu().numpy()

    @torch.no_grad()
    def _pooled(self, ids: np.ndarray, mask: np.ndarray, spans: np.ndarray) -> torch.Tensor:
        # word embedding = mean of the last `span` valid positions, pooled
        # ON DEVICE so only (L+1, B, D) crosses to the host
        states = self._forward(ids, mask)
        n_valid = torch.from_numpy(np.asarray(mask).sum(axis=-1)).to(self.device)
        spans_t = torch.from_numpy(np.asarray(spans)).to(self.device)
        pos = torch.arange(ids.shape[-1], device=self.device)[None]
        sel = (pos >= (n_valid - spans_t)[:, None]) & (pos < n_valid[:, None])
        w = sel / sel.sum(dim=-1, keepdim=True).clamp_min(1)
        return torch.einsum("lbtd,bt->lbd", states, w.float())

    def pooled_states(self, ids: np.ndarray, mask: np.ndarray, spans: np.ndarray) -> np.ndarray:
        """(L+1, B, D) word embeddings, pooled on device."""
        return self._pooled(ids, mask, spans).cpu().numpy()

    def pooled_states_async(self, ids: np.ndarray, mask: np.ndarray, spans: np.ndarray) -> _HostCopy:
        """Dispatch the pooled forward and its copy to the host without
        waiting for either; ``np.asarray`` of the result waits."""
        return _HostCopy(self._pooled(ids, mask, spans))

    def chain_tokenize(self, texts: list[str]) -> list[list[int]]:
        """Token ids per text via the incremental per-word cache."""
        return [self._tokenize(t) for t in texts]

    @torch.no_grad()
    def pooled_states_chain_async(self, tokens: list[list[int]], spans: tp.Sequence[int]) -> _HostCopy:
        """Per-word pooled states for a nested-prefix context chain in ONE
        forward over the final (longest) token sequence.

        ``tokens`` must be a prefix chain (tokens[i] extends tokens[i-1]);
        word i pools the mean of the last ``spans[i]`` positions of its own
        prefix: the same numbers as ``pooled_states`` on each context
        separately (causal attention + shared absolute positions).  Returns
        (L+1, Wbucket, D) on its way to the host; the caller takes the first
        len(tokens) rows."""
        width = _bucket_width(len(tokens[-1]), self.BUCKETS)
        ids, mask = _pad_ids([tokens[-1]], width, self.pad_id)
        # word-count axis: bucket table, then 256-steps beyond it
        wb = _bucket_width(len(tokens), self.WBUCKETS, step=256)
        pool = np.zeros((wb, width), dtype=np.float32)
        for i, (tk, span) in enumerate(zip(tokens, spans)):
            length = max(1, len(tk))
            s = max(1, min(int(span), length))
            pool[i, length - s : length] = 1.0 / s
        states = self._forward(ids, mask)  # (L+1, 1, T, D)
        pool_t = torch.from_numpy(pool).to(self.device)
        return _HostCopy(torch.einsum("ltd,wt->lwd", states[:, 0], pool_t))


class TinyTextBackbone(TorchTextBackbone):
    """Small Llama for offline/synthetic runs (the JAX package's tiny
    config, fp32): random weights from ``seed``, or the weights of
    ``state_dict`` (e.g. a JAX tiny backbone's, converted by
    ``models.convert.llama_params_to_torch``)."""

    def __init__(
        self,
        hidden_size: int = 64,
        num_layers: int = 4,
        vocab: int = 512,
        seed: int = 0,
        state_dict: tp.Mapping[str, torch.Tensor] | None = None,
        device: str | torch.device | None = None,
        pipeline_mesh: LocalMesh | None = None,
    ):
        device = default_device(device)
        cfg = LlamaConfig(
            vocab_size=vocab,
            hidden_size=hidden_size,
            intermediate_size=hidden_size * 2,
            num_layers=num_layers,
            num_heads=4,
            num_kv_heads=2,
            head_dim=hidden_size // 4,
            rope_scaling_factor=1.0,
            dtype=torch.float32,
        )
        model = LlamaBackbone(cfg, device=device)
        if state_dict is None:
            model.init_random(torch.Generator(device=device).manual_seed(seed))
        else:
            model.load_state_dict(state_dict)
        super().__init__(model, HashTokenizer(vocab), pad_id=0, device=device,
                         pipeline_mesh=pipeline_mesh)


def load_text_backbone(
    state_dict: tp.Mapping[str, tp.Any],
    hf_config: tp.Mapping[str, tp.Any],
    tokenizer,
    pad_id: int,
    device: str | torch.device | None = None,
    pipeline_stages: int = 0,
) -> TorchTextBackbone:
    """A bf16 Llama from an HF LlamaModel's state dict and config dict
    (``config.json`` keys: vocab_size, hidden_size, intermediate_size,
    num_hidden_layers, num_attention_heads, num_key_value_heads,
    rope_theta), the llama3 rope scaling and RMSNorm eps of the 3.2 family,
    and a tokenizer (an HF tokenizer's ``encode``, or any callable text ->
    ids)."""
    device = default_device(device)
    c = hf_config
    cfg = LlamaConfig(
        vocab_size=c["vocab_size"],
        hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"],
        head_dim=c["hidden_size"] // c["num_attention_heads"],
        rope_theta=c["rope_theta"],
        dtype=torch.bfloat16,
    )
    mesh = _pp_mesh(pipeline_stages, device)
    # pipelined: the converted weights stay on the host until each layer
    # goes to its stage's device
    model = LlamaBackbone(cfg, device=device if mesh is None else "cpu")
    model.load_state_dict(params_from_hf(state_dict, cfg))
    return TorchTextBackbone(model, tokenizer, pad_id, device=device, pipeline_mesh=mesh)


def _pp_mesh(pipeline_stages: int, device: torch.device) -> LocalMesh | None:
    """A ("stage",) mesh of ``pipeline_stages`` stages (None when off): the
    first N cards, raising when fewer are visible, or N stages on the CPU."""
    if pipeline_stages <= 1:
        return None
    return local_mesh(pipeline_stages, "stage", "cpu" if device.type == "cpu" else None)


def load_hf_text_backbone(
    model_name: str, device: str | torch.device | None = None, pipeline_stages: int = 0
) -> TorchTextBackbone:
    """The bf16 backbone of a named HF checkpoint (``AutoModel`` and its
    tokenizer), read from the local HF cache only: nothing is downloaded.
    ``pipeline_stages`` > 1 splits the layer stack over that many devices
    (``_pp_mesh``)."""
    from transformers import AutoModel, AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(
        model_name, truncation_side="left", local_files_only=True
    )
    hf_model = AutoModel.from_pretrained(model_name, local_files_only=True)
    pad_id = tokenizer.pad_token_id
    if pad_id is None:  # `or` would discard a legitimate pad id of 0
        pad_id = tokenizer.eos_token_id
    return load_text_backbone(
        hf_model.state_dict(), hf_model.config.to_dict(), tokenizer, pad_id, device=device,
        pipeline_stages=pipeline_stages,
    )


def _chain_runs(
    backbone: TorchTextBackbone,
    words: tp.Sequence[tuple[str, str]],
    max_context_tokens: int,
    min_chain: int = MIN_CHAIN,
) -> list[list]:
    """Split ``words`` into maximal nested-prefix token-chain runs.

    Returns [is_chain, words, tokens] groups in order.  A run chains while
    each context's token ids extend the previous word's ids (true for
    rolling contexts until the left-truncation kicks in) and stays within
    max_context_tokens.  Chain runs shorter than ``min_chain`` are demoted and
    merged into the neighboring batched runs."""
    raw: list[list] = []
    cur_w: list = []
    cur_t: list = []
    limit = min(max_context_tokens, 4096)  # bound device width
    max_words = backbone.WBUCKETS[-1]
    for word in words:
        ids = backbone.chain_tokenize([word[1] or word[0]])[0]
        chainable = 0 < len(ids) <= limit
        extends = (
            bool(cur_w) and chainable and len(cur_w) < max_words
            and ids[: len(cur_t[-1])] == cur_t[-1]
        )
        if extends:
            cur_w.append(word)
            cur_t.append(ids)
            continue
        if cur_w:
            raw.append([True, cur_w, cur_t])
        if chainable:
            cur_w, cur_t = [word], [ids]
        else:
            raw.append([False, [word], [ids]])
            cur_w, cur_t = [], []
    if cur_w:
        raw.append([True, cur_w, cur_t])
    merged: list[list] = []
    for is_chain, ws, ts in raw:
        is_chain = is_chain and len(ws) >= min_chain
        if merged and not merged[-1][0] and not is_chain:
            merged[-1][1].extend(ws)
            merged[-1][2].extend(ts)
        else:
            merged.append([is_chain, ws, ts])
    return merged


def _batched(
    backbone: TorchTextBackbone,
    words: tp.Sequence[tuple[str, str]],
    toks: tp.Sequence[tp.Sequence[int]],
    batch_size: int,
    max_context_tokens: int,
) -> tp.Iterator[np.ndarray]:
    """Padded-batch path over already-tokenized contexts, one-deep pipelined."""

    def dispatches():
        for lo in range(0, len(words), batch_size):
            chunk = words[lo : lo + batch_size]
            ids, mask = backbone.encode_pretokenized(toks[lo : lo + batch_size], max_context_tokens)
            # last len(word) valid positions, mean-pooled (reference parity)
            n_valid = mask.sum(axis=-1)
            spans = np.array([max(1, min(len(w[0]), int(n_valid[j]))) for j, w in enumerate(chunk)],
                             dtype=np.int32)
            yield backbone.pooled_states_async(ids, mask, spans), len(chunk)

    yield from _pipelined_columns(dispatches())


def encode_word_stream(
    backbone: TorchTextBackbone,
    words: tp.Sequence[tuple[str, str]],
    batch_size: int = 8,
    max_context_tokens: int = 1024,
    min_chain: int = MIN_CHAIN,
    chain_chunk: int = CHAIN_CHUNK,
) -> tp.Iterator[np.ndarray]:
    """Per-word (L+1, D) float32 features of ``(text, context)`` pairs, in order.

    The device side of the JAX package's ``LLAMA3p2._compute``: nested-
    prefix chain runs of at least ``min_chain`` words go through one
    forward per ``chain_chunk`` words over the chunk's longest context; the rest in
    padded batches of ``batch_size`` (contexts left-truncated to
    ``max_context_tokens``).  An empty context stands for the word itself."""
    for is_chain, run, toks in _chain_runs(backbone, words, max_context_tokens, min_chain):
        if not is_chain:
            yield from _batched(backbone, run, toks, batch_size, max_context_tokens)
            continue
        spans = [len(w[0]) for w in run]

        def chain_dispatches(toks=toks, spans=spans):
            for k in range(0, len(toks), chain_chunk):
                sub_t = toks[k : k + chain_chunk]
                yield backbone.pooled_states_chain_async(sub_t, spans[k : k + chain_chunk]), len(sub_t)

        yield from _pipelined_columns(chain_dispatches())


class LLAMA3p2(LayeredFeatureBase):
    """Word-level Llama feature on the 2 Hz grid (the JAX package's config
    surface and cache uids)."""

    name: tp.Literal["LLAMA3p2"] = "LLAMA3p2"
    model_name: str = "meta-llama/Llama-3.2-3B"
    batch_size: int = 8
    max_context_tokens: int = 1024
    #: >1 stage-shards the backbone's layer stack over that many devices
    #: (pipeline parallelism; see ``TorchTextBackbone``); device topology,
    #: not semantics: excluded from the cache uid like ``device``
    pipeline_stages: int = 0

    event_type: tp.ClassVar[str] = "Word"
    frequency: tp.ClassVar[float] = 2.0
    modality: tp.ClassVar[str] = "text"
    MIN_CHAIN: tp.ClassVar[int] = MIN_CHAIN
    CHAIN_CHUNK: tp.ClassVar[int] = CHAIN_CHUNK

    def _exclude_from_cache_uid(self) -> list[str]:
        return [
            "device", "layers", "layer_aggregation", "batch_size",
            "pipeline_stages",
        ]

    @staticmethod
    def item_uid(event: Event) -> str:
        # the reference's cache key, kept verbatim for cache parity; it is
        # ambiguous when a word itself contains "_" (transcripts hold none)
        return f"{event.text}_{event.context}"  # type: ignore[attr-defined]

    def _tiny_backbone(self, device: torch.device) -> TorchTextBackbone:
        return TinyTextBackbone(device=device,
                                pipeline_mesh=_pp_mesh(self.pipeline_stages, device))

    def _named_backbone(self, device: torch.device) -> TorchTextBackbone:
        return load_hf_text_backbone(self.model_name, device=device,
                                     pipeline_stages=self.pipeline_stages)

    def _chain_runs(self, backbone: TorchTextBackbone, events: tp.Sequence[Word]) -> list[list]:
        """[is_chain, (text, context) pairs, token ids] runs of ``events``."""
        return _chain_runs(backbone, _pairs(events), self.max_context_tokens, self.MIN_CHAIN)

    def _compute(self, events: tp.Sequence[Word]) -> tp.Iterator[np.ndarray]:
        yield from encode_word_stream(
            self.backbone, _pairs(events), batch_size=self.batch_size,
            max_context_tokens=self.max_context_tokens, min_chain=self.MIN_CHAIN,
            chain_chunk=self.CHAIN_CHUNK,
        )

    def _compute_batched(
        self, backbone: TorchTextBackbone, events: tp.Sequence[Word]
    ) -> tp.Iterator[np.ndarray]:
        """Every event through the padded-batch path (the chain path's
        reference)."""
        words = _pairs(events)
        toks = backbone.chain_tokenize([c or t for t, c in words])
        yield from _batched(backbone, words, toks, self.batch_size, self.max_context_tokens)

    def _get_timed_arrays(
        self, events: list[Word], start: float, duration: float
    ) -> tp.Iterable[TimedArray]:
        for event, latent in zip(events, self._get_data(events)):
            latent = self._aggregate_layers(np.asarray(latent))
            yield TimedArray(
                frequency=0,
                duration=event.duration,
                start=event.start,
                data=latent,
            )


def _pairs(events: tp.Sequence[Word]) -> list[tuple[str, str]]:
    return [(e.text, e.context) for e in events]
