"""w2v-BERT audio features: frozen conformer states on the 2 Hz grid.

The device side of algonauts2025_tpu/features/audio.py.  Per chunk: a mono
z-scored waveform (``mono_zscore``), polyphase resampling to 16 kHz
(ops/resample.py), the kaldi log-mel frontend (ops/mel.py), the frozen
conformer's hidden states, and nearest-neighbour resampling of the (L+1,
D, T50) stack onto the 2 Hz grid, on the device.  Each waveform is
zero-padded to a multiple of ``bucket_seconds``, with the padding masked
out of the mel statistics and the attention, as the JAX package does to
bound its compiled shapes.

Under a profiler chunk k's stages are spans (``utils.profiling.span``):
``audio.upload#<k>``, ``audio.resample#<k>``, ``audio.mel#<k>``,
``audio.backbone#<k>`` (the conformer's ``conformer.*`` inside),
``audio.frames#<k>`` and ``audio.fetch#<k>``.  ``TorchAudioBackbone.counts``
counts the chunks, their valid 50 Hz frames and the padded frames the
buckets add, and the CUDA graphs of the conformer.

On the card a bucketed chunk's conformer is replayed from CUDA graphs
(``StageGraphs``), one set a bucket shape, captured after the bucket's
first chunk: every hook-free run of the forward's stages is one graph,
and a stage with a Python hook runs eagerly, so its hooks fire on every
chunk.  The exact-length call and the CPU run every stage eagerly.

``encode_sound_stream`` takes ``(waveform, rate, duration)`` chunks; the
pydantic ``Wav2VecBert`` feature feeds it from ``Sound`` events (or the wav
demuxed beside a ``Video``) and caches per (filepath, offset, duration).
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.modules import module as nn_module

from ..core.events import Event, Sound, Video
from ..core.timed import Frequency
from ..io import wav as wavio
from ..models.backbones.wav2vec_bert import Wav2VecBertBackbone, Wav2VecBertConfig, params_from_hf
from ..ops import flash_attention as flash_ops
from ..ops.mel import log_mel_features, log_mel_features_masked
from ..ops.resample import resample_poly
from ..runtime import default_device
from ..utils.profiling import span
from .base import LayeredFeatureBase

__all__ = [
    "Wav2VecBert",
    "TARGET_SR",
    "OUTPUT_HZ",
    "nearest_resample",
    "mono_zscore",
    "TorchAudioBackbone",
    "TinyAudioBackbone",
    "load_audio_backbone",
    "load_hf_audio_backbone",
    "encode_sound_stream",
    "stage_runs",
    "StageGraphs",
]

TARGET_SR = 16000
OUTPUT_HZ = 2.0


def nearest_resample(x: np.ndarray, n_out: int) -> np.ndarray:
    """torch F.interpolate(mode='nearest') over the last axis."""
    n_in = x.shape[-1]
    idx = np.floor(np.arange(n_out) * (n_in / n_out)).astype(int)
    idx = np.clip(idx, 0, n_in - 1)
    return x[..., idx]


def mono_zscore(wav: np.ndarray) -> np.ndarray:
    """(frames, channels) -> the channel mean, z-scored: (x - mean) / (1e-8 + std)."""
    wav = wav.mean(axis=1)
    return (wav - wav.mean()) / (1e-8 + wav.std())


def _frame_index(n_out: int, ratio: np.float32, n_in: int) -> np.ndarray:
    """floor(arange(n_out) * ratio) in float32, as the JAX package computes
    it on the device (float64 picks other frames at some boundaries),
    clipped to [0, n_in - 1]."""
    idx = np.floor(np.arange(n_out, dtype=np.float32) * np.float32(ratio)).astype(np.int64)
    return np.clip(idx, 0, max(n_in - 1, 0))


def _has_hooks(*roots: torch.nn.Module) -> bool:
    """Whether a forward or forward-pre hook sits on ``roots`` or a module
    under them (a walk of ``_modules``: ``modules()`` costs ~5x as much,
    and this runs every chunk)."""
    stack = list(roots)
    while stack:
        module = stack.pop()
        if module is not None:
            if module._forward_hooks or module._forward_pre_hooks:
                return True
            stack.extend(module._modules.values())
    return False


def stage_runs(model: Wav2VecBertBackbone) -> list[tuple[int, int, bool]]:
    """The forward's stages (``Wav2VecBertBackbone.stage_modules``: 0 the
    embed, k the layer k - 1) as maximal runs ``(start, stop, hook_free)``
    of consecutive stages that all lack, or all have, a forward or
    forward-pre hook on one of their modules or submodules.  A hook on the
    backbone itself or a global module hook marks every stage.  A pure
    function of the hooks registered."""
    everywhere = (bool(model._forward_hooks or model._forward_pre_hooks)
                  or bool(nn_module._global_forward_hooks or nn_module._global_forward_pre_hooks))
    runs: list[tuple[int, int, bool]] = []
    for k, roots in enumerate(model.stage_modules()):
        free = not everywhere and not _has_hooks(*roots)
        if runs and runs[-1][2] == free:
            runs[-1] = (runs[-1][0], k + 1, free)
        else:
            runs.append((k, k + 1, free))
    return runs


class StageGraphs:
    """CUDA graphs of a backbone's bucketed forwards on the card: for each
    (bucket frames, ``stage_runs``) key, one graph a hook-free run, captured
    on a side stream right after the key's first chunk, which runs every
    stage eagerly (its hook-free runs on that side stream, as their warm-up)
    and returns its own states.  Later chunks of the key replay the graphs
    and run the hooked stages eagerly between them.

    The static buffers (the mel features, the mask, the carry between runs
    and the flat fp32 (L+1) x T x D stack) are sized for the largest bucket
    seen; each bucket uses views of their first elements, and every graph
    of every bucket draws its intermediates from one shared memory pool.
    Graphs bake in addresses, so a larger bucket reallocates the buffers,
    drops every graph and lets each key capture again.  Invariant: nothing
    that lives across replays is allocated inside a capture (every input,
    output and carry is a static buffer, allocated outside), so the graphs
    may replay in any order although they share a pool.

    A capture runs in the calling thread's own mode (``thread_local``): the
    other threads of the process (the other features of ``prepare_features``)
    may allocate device and page-locked memory, copy to and from the host,
    and record, query and wait on events and streams meanwhile.  A
    device-wide ``torch.cuda.synchronize()`` in another thread still
    invalidates the capture (in every mode), and a draw from the card's
    default generator there raises (the capture holds that generator);
    the port's features make neither call.
    Each graph keeps the kernel launches its capture recorded
    (``ops.flash_attention.recorded_counts``) and adds them to
    ``launch_counts`` at each replay, so the counts are launches run."""

    def __init__(self, model: Wav2VecBertBackbone, device: torch.device):
        self.model = model
        self.device = device
        #: the side stream of every warm-up and capture (none on the CPU,
        #: where only the static buffers and the runs work)
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        #: per key, each hook-free run's graph and the launches it records
        self.graphs: dict[tuple, dict[int, tuple[torch.cuda.CUDAGraph, dict[str, int]]]] = {}
        self.frames = 0
        self.pool = None

    def _views(self, t: int) -> dict[str, torch.Tensor]:
        """The static buffers' views for ``t`` frames, reallocated (every
        graph dropped first) when ``t`` passes their size."""
        cfg = self.model.cfg
        if t > self.frames:
            self.graphs.clear()
            self.pool = None
            self.buffers = {
                "feats": torch.empty(t * cfg.input_dim, device=self.device),
                "mask": torch.empty(t, dtype=torch.bool, device=self.device),
                "x": torch.zeros(t * cfg.hidden_size, dtype=cfg.dtype, device=self.device),
                "lengths": torch.zeros(1, dtype=torch.int32, device=self.device),
                "out": torch.empty(self.model.num_stages * t * cfg.hidden_size, device=self.device),
            }
            self.frames = t
        b = self.buffers
        return {"feats": b["feats"][:t * cfg.input_dim].view(1, t, cfg.input_dim),
                "mask": b["mask"][:t].view(1, t),
                "x": b["x"][:t * cfg.hidden_size].view(1, t, cfg.hidden_size),
                "lengths": b["lengths"],
                "out": b["out"][:self.model.num_stages * t * cfg.hidden_size].view(-1, 1, t, cfg.hidden_size)}

    def _run(self, start: int, stop: int, v: dict[str, torch.Tensor], own: bool = False) -> None:
        """Stages ``start`` to ``stop - 1`` from the static carry into the
        static stack, leaving the next stage's carry in the static buffers;
        with ``own`` on copies of the carry, so that hooks see tensors of
        their own chunk."""
        carry = (v["feats"], v["mask"]) if start == 0 else (v["x"], v["lengths"], v["mask"])
        if own:
            carry = tuple(c.clone() for c in carry)
        x, lengths, _ = self.model.run_stages(start, stop, carry, v["out"])
        if stop < self.model.num_stages:
            v["x"].copy_(x)
            if start == 0:
                v["lengths"].copy_(lengths)

    def __call__(self, feats: torch.Tensor, mask: torch.Tensor, runs: list[tuple[int, int, bool]],
                 counts: dict[str, int]) -> torch.Tensor:
        """The (L+1, 1, T, D) stack of ``feats`` (1, T, input_dim) under
        ``mask`` (1, T): a view of the static stack, valid until the next
        call."""
        v = self._views(feats.shape[1])
        v["feats"].copy_(feats)
        v["mask"].copy_(mask)
        key = (feats.shape[1], tuple(runs))
        graphs = self.graphs.get(key)
        main = torch.cuda.current_stream(self.device)
        for start, stop, free in runs:
            if free and graphs is not None:
                graph, recorded = graphs[start]
                graph.replay()
                for name, n in recorded.items():
                    flash_ops.launch_counts[name] += n
                counts["graph_replays"] += 1
                continue
            counts["eager_stages"] += stop - start
            if not free:
                self._run(start, stop, v, own=True)
                continue
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                self._run(start, stop, v)
            main.wait_stream(self.stream)
        if graphs is None:
            self.graphs[key] = self._capture(runs, v)
            counts["graph_captures"] += len(self.graphs[key])
        return v["out"]

    def _capture(self, runs: list[tuple[int, int, bool]],
                 v: dict[str, torch.Tensor]) -> dict[int, tuple[torch.cuda.CUDAGraph, dict[str, int]]]:
        """One graph a hook-free run, on the side stream its warm-up ran on,
        with the launches it recorded.  A capture records and runs nothing:
        the stack keeps the states the eager call left there.
        ``capture_begin`` / ``capture_end`` directly: ``torch.cuda.graph``
        would also synchronise, collect garbage and empty the allocator's
        cache at every capture."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graphs = {}
        with torch.cuda.stream(self.stream):
            for start, stop, free in runs:
                if free:
                    graph, before = torch.cuda.CUDAGraph(), dict(flash_ops.recorded_counts)
                    graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                    try:
                        self._run(start, stop, v)
                    finally:
                        graph.capture_end()
                    recorded = {name: n - before[name] for name, n in flash_ops.recorded_counts.items()}
                    graphs[start] = graph, {name: n for name, n in recorded.items() if n}
        return graphs


class TorchAudioBackbone:
    """A Wav2VecBertBackbone on one device (the CUDA card unless ``device``
    says otherwise); waveforms are 16 kHz mono float32 arrays or tensors."""

    def __init__(self, model: Wav2VecBertBackbone, device: str | torch.device | None = None):
        self.device = default_device(device)
        self.model = model.to(self.device).eval()
        #: distinct (bucket samples, n_out_max) shapes run so far
        self.bucket_shapes: set[tuple[int, int]] = set()
        #: chunks encoded on the 2 Hz grid, their valid 50 Hz frames and the
        #: frames their buckets' padding added; the CUDA graphs captured and
        #: replayed, and the stages run eagerly, in the bucketed path on the
        #: card (``reset_counts`` zeroes them)
        self.counts: dict[str, int] = {}
        self.reset_counts()
        self.graphs = StageGraphs(self.model, self.device) if self.device.type == "cuda" else None

    def reset_counts(self) -> None:
        self.counts.update(chunks=0, frames=0, padded_frames=0, graph_captures=0, graph_replays=0,
                           eager_stages=0)

    def _wav(self, wav_16k) -> torch.Tensor:
        return torch.as_tensor(wav_16k, dtype=torch.float32).to(self.device)

    def _count(self, t_valid: int, t_run: int) -> None:
        self.counts["chunks"] += 1
        self.counts["frames"] += t_valid
        self.counts["padded_frames"] += t_run - t_valid

    @torch.no_grad()
    def hidden_states(self, wav_16k) -> np.ndarray:
        """(T,) 16 kHz waveform -> (L+1, T50, D) hidden stack."""
        return self.model(log_mel_features(self._wav(wav_16k))[None])[:, 0].cpu().numpy()

    @torch.no_grad()
    def states_2hz(self, wav: torch.Tensor, n_out: int, bucket_samples: int | None = None,
                   tag: str = "") -> torch.Tensor:
        """(L+1, D, n_out) hidden stack of a 16 kHz waveform on the device,
        resampled to the output grid there: at the exact length, or with
        ``bucket_samples`` zero-padded to it, the mel normalization and the
        conformer's attention masking out the padding (so the values match
        the exact-length call within float tolerance).  Its stages are the
        spans ``audio.mel<tag>``, ``audio.backbone<tag>`` and
        ``audio.frames<tag>``.  A bucketed call on the card replays the
        bucket's CUDA graphs (``StageGraphs``) where the backbone's hooks
        leave a stage free of them."""
        n = wav.shape[-1]
        mask = None
        with span(f"audio.mel{tag}"):
            if bucket_samples is None:
                feats = log_mel_features(wav)
                t_valid = feats.shape[0]
            else:
                if bucket_samples < n:
                    raise ValueError(f"bucket {bucket_samples} smaller than wav {n}")
                n_out_max = max(n_out, int(bucket_samples / TARGET_SR * OUTPUT_HZ))
                self.bucket_shapes.add((bucket_samples, n_out_max))
                feats, t_valid = log_mel_features_masked(F.pad(wav, (0, bucket_samples - n)), n)
                mask = (torch.arange(feats.shape[0], device=self.device) < t_valid)[None]
        with span(f"audio.backbone{tag}"):
            runs = None if mask is None or self.graphs is None else stage_runs(self.model)
            if runs is not None and any(free for *_, free in runs):
                states = self.graphs(feats[None], mask, runs, self.counts)[:, 0]
            else:
                states = self.model(feats[None], attention_mask=mask)[:, 0]  # (L+1, T50 or T50pad, D)
                if runs is not None:
                    self.counts["eager_stages"] += self.model.num_stages
        with span(f"audio.frames{tag}"):
            if bucket_samples is None:
                idx = _frame_index(n_out, np.float32(t_valid / n_out), t_valid)
            else:
                idx = _frame_index(n_out_max, np.float32(t_valid) / np.float32(max(n_out, 1)), t_valid)[:n_out]
            out = states[:, torch.from_numpy(idx).to(self.device)].transpose(1, 2)
        self._count(t_valid, states.shape[1])
        return out

    def hidden_states_2hz(self, wav_16k, n_out: int) -> np.ndarray:
        """(L+1, D, n_out) hidden stack resampled to the output grid on the device."""
        return self.states_2hz(self._wav(wav_16k), n_out).cpu().numpy()

    def hidden_states_2hz_bucketed(self, wav_16k, n_out: int, bucket_samples: int) -> np.ndarray:
        """Bucketed variant: the wav is zero-padded to ``bucket_samples``; the
        mel normalization and the conformer's attention mask out the
        padding, so the values match the exact-length call within float
        tolerance."""
        return self.states_2hz(self._wav(wav_16k), n_out, bucket_samples).cpu().numpy()


class TinyAudioBackbone(TorchAudioBackbone):
    """Small random-weight conformer for offline/synthetic runs (the JAX
    package's tiny config, fp32): random weights from ``seed``, or the
    weights of ``state_dict`` (e.g. a JAX tiny backbone's, converted by
    ``models.convert.wav2vec_bert_params_to_torch``).  It runs on the CPU:
    on the card its attention (fp32, head dim 16) raises, since the
    relative-key kernel takes bf16 at head dim 64."""

    def __init__(
        self,
        hidden_size: int = 64,
        num_layers: int = 2,
        seed: int = 0,
        state_dict: tp.Mapping[str, torch.Tensor] | None = None,
        device: str | torch.device | None = None,
    ):
        device = default_device(device)
        cfg = Wav2VecBertConfig(
            hidden_size=hidden_size,
            num_layers=num_layers,
            num_heads=4,
            intermediate_size=hidden_size * 2,
            conv_kernel_size=7,
            dtype=torch.float32,
        )
        model = Wav2VecBertBackbone(cfg, device=device)
        if state_dict is None:
            model.init_random(torch.Generator(device=device).manual_seed(seed))
        else:
            model.load_state_dict(state_dict)
        super().__init__(model, device=device)


def load_audio_backbone(
    state_dict: tp.Mapping[str, tp.Any],
    hf_config: tp.Mapping[str, tp.Any],
    device: str | torch.device | None = None,
) -> TorchAudioBackbone:
    """A bf16 w2v-BERT from an HF Wav2Vec2BertModel's state dict and config
    dict (``config.json`` keys: feature_projection_input_dim, hidden_size,
    num_hidden_layers, num_attention_heads, intermediate_size,
    conv_depthwise_kernel_size, left_max_position_embeddings,
    right_max_position_embeddings)."""
    device = default_device(device)
    c = hf_config
    cfg = Wav2VecBertConfig(
        input_dim=c["feature_projection_input_dim"],
        hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        intermediate_size=c["intermediate_size"],
        conv_kernel_size=c["conv_depthwise_kernel_size"],
        left_max_pos=c["left_max_position_embeddings"],
        right_max_pos=c["right_max_position_embeddings"],
        dtype=torch.bfloat16,
    )
    model = Wav2VecBertBackbone(cfg, device=device)
    model.load_state_dict(params_from_hf(state_dict, cfg))
    return TorchAudioBackbone(model, device=device)


def encode_sound_stream(
    backbone: TorchAudioBackbone,
    chunks: tp.Iterable[tuple[tp.Any, float, float]],
    bucket_seconds: float = 5.0,
) -> tp.Iterator[np.ndarray]:
    """Per-chunk (L+1, D, n_out) float32 features of ``(wav, rate, duration)``
    chunks, in order: the device loop of the JAX ``Wav2VecBert._compute``.

    ``wav`` is a mono z-scored waveform (``mono_zscore``) at ``rate`` Hz,
    resampled to 16 kHz on the device unless it is there already; ``n_out =
    max(1, round(duration * 2))`` steps of the 2 Hz grid.  With
    ``bucket_seconds`` the waveform is padded up to a multiple of it (at
    least one); 0 runs the exact length.  Chunk k's stages are the spans
    ``audio.upload#<k>``, ``audio.resample#<k>``, those of
    ``TorchAudioBackbone.states_2hz`` and ``audio.fetch#<k>``."""
    for k, (wav, sfreq, duration) in enumerate(chunks):
        with span(f"audio.upload#{k}"):
            wav = torch.as_tensor(np.asarray(wav, dtype=np.float32)).to(backbone.device)
        if int(sfreq) != TARGET_SR:
            with span(f"audio.resample#{k}"):
                wav = resample_poly(wav, int(sfreq), TARGET_SR)
        timepoints = max(1, int(np.round(np.multiply(duration, OUTPUT_HZ))))
        bucket = None
        if bucket_seconds:
            step = int(bucket_seconds * TARGET_SR)
            bucket = max(step, -(-wav.shape[-1] // step) * step)
        latents = backbone.states_2hz(wav, timepoints, bucket, tag=f"#{k}")
        with span(f"audio.fetch#{k}"):
            latents = latents.cpu().numpy()
        yield latents.astype(np.float32)


def load_hf_audio_backbone(
    model_name: str, device: str | torch.device | None = None
) -> TorchAudioBackbone:
    """The bf16 backbone of a named HF ``Wav2Vec2BertModel`` checkpoint, read
    from the local HF cache only: nothing is downloaded."""
    from transformers import Wav2Vec2BertModel

    hf_model = Wav2Vec2BertModel.from_pretrained(model_name, local_files_only=True)
    return load_audio_backbone(hf_model.state_dict(), hf_model.config.to_dict(), device=device)


class Wav2VecBert(LayeredFeatureBase):
    """Frozen w2v-BERT states of each ``Sound`` event on the 2 Hz grid (the
    JAX package's config surface and cache uids)."""

    name: tp.Literal["Wav2VecBert"] = "Wav2VecBert"
    model_name: str = "facebook/w2v-bert-2.0"
    #: wav lengths are padded up to multiples of this (seconds) so arbitrary
    #: ChunkEvents durations run a bounded set of shapes; 0 disables
    bucket_seconds: float = 5.0

    event_type: tp.ClassVar[str] = "Sound"
    frequency: tp.ClassVar[float] = OUTPUT_HZ
    modality: tp.ClassVar[str] = "audio"

    def _exclude_from_cache_uid(self) -> list[str]:
        # bucket padding is masked out of the numerics (values match the
        # exact-length call within float tolerance), so it never busts caches
        return ["device", "layers", "layer_aggregation", "bucket_seconds"]

    @staticmethod
    def item_uid(event: Event) -> str:
        return f"{event.filepath}_{event.offset:.2f}_{event.duration:.2f}"  # type: ignore[attr-defined]

    def _tiny_backbone(self, device: torch.device) -> TorchAudioBackbone:
        return TinyAudioBackbone(device=device)

    def _named_backbone(self, device: torch.device) -> TorchAudioBackbone:
        return load_hf_audio_backbone(self.model_name, device=device)

    def _read_mono_zscore(self, event: Event) -> tuple[np.ndarray, float]:
        """The event's mono z-scored waveform and its rate; a ``Sound``'s wav
        through the fused native PCM16 decode."""
        if isinstance(event, Sound):
            sr = Frequency(event.frequency)
            wav = wavio.read_mono_zscore(
                str(event.filepath),
                start=sr.to_ind(event.offset),
                frames=sr.to_ind(event.duration),
            )
            return wav, float(event.frequency)
        wav, sfreq = self._read_wav(event)
        return mono_zscore(wav), sfreq

    def _read_wav(self, event: Event) -> tuple[np.ndarray, float]:
        if isinstance(event, Sound):
            return np.asarray(event.read(), dtype=np.float32), float(event.frequency)
        if isinstance(event, Video):
            # audio demuxed next to the video by ExtractAudioFromVideo
            wav_path = Path(str(event.filepath)).with_suffix(".wav")
            sr = wavio.info(str(wav_path)).samplerate
            data = wavio.read(
                str(wav_path),
                start=int(event.offset * sr),
                frames=int(event.duration * sr),
            )
            return data, float(sr)
        raise TypeError(f"Unsupported event for audio feature: {type(event)}")

    def _compute(self, events: tp.Sequence[Event]) -> tp.Iterator[np.ndarray]:
        chunks = ((*self._read_mono_zscore(e), e.duration) for e in events)
        yield from encode_sound_stream(self.backbone, chunks, bucket_seconds=self.bucket_seconds)
