"""The w2v-BERT 2.0 chunk stream, as the ``Wav2VecBert`` feature runs it.

Set-up makes the model's float weights from the seed on the device (in the
HF checkpoint's layout) and loads them through the port's
``load_audio_backbone``, as a checkpoint is loaded; makes a pool of seeded
48 kHz stereo soundtracks on the device, cuts each as ``ChunkEvents`` cuts
a ``Sound`` event (``core.splitting``'s grid and the event's own rule: 60 s
pieces, a 30-90 s tail) and holds each chunk on the host as
``Wav2VecBert._read_mono_zscore`` gives it (mono, z-scored, float32);
and warms up the longest piece ``ChunkEvents`` can cut and one chunk of
every other 5 s bucket in the pool.  The window is one
``encode_sound_stream`` call over an endless stream of pool chunks in
order, cycled, cut at a chunk boundary once ``--seconds`` have passed:
resampling and the fbank on the card, one chunk in flight, each chunk's
(L+1, D, n_out) states back on the host.  Every answer is then checked
against the reference's states for its pool chunk, computed at the
chunk's exact length; and the first layer's attention output (the input
of its ``linear_out``, taken by a hook) of the window's first chunk at
frames drawn from the seed, against the reference's attention of the same
attention input (taken by a hook too): the score pipeline on its own,
where a lower precision of the scores shows before the bf16 rounding of
the layers around it hides it.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from algonauts2025_tpu_torch.core import splitting
from algonauts2025_tpu_torch.features.audio import encode_sound_stream, load_audio_backbone
from benchmark.common.seeds import derive
from benchmark.common.trace import span
from benchmark.reference import w2v_bert2 as reference

#: frames of the first chunk's first-layer attention output that are compared
SAMPLED_FRAMES = 512
HF_KEYS = ("feature_projection_input_dim", "hidden_size", "num_hidden_layers", "num_attention_heads",
           "intermediate_size", "conv_depthwise_kernel_size", "left_max_position_embeddings",
           "right_max_position_embeddings")
#: the slow envelope of the seeded signal: one random gain every this many seconds
ENVELOPE_S = 0.1


def chunk_edges(duration: float, max_duration: float, min_duration: float) -> list[float]:
    """The edges, in seconds, of ``ChunkEvents``' pieces of one sound of
    ``duration`` starting at 0: the grid of ``max_duration`` steps less a
    last cut that would leave a tail under ``min_duration``
    (``splitting._grid_cuts``), then the event's own rule that drops a cut
    nearer than ``min_duration`` to either neighbour edge."""
    cuts = np.asarray(splitting._grid_cuts(0.0, duration, max_duration, min_duration))
    cuts = np.unique(cuts[(cuts > 0) & (cuts < duration)])
    if cuts.size:
        keep = (np.diff(cuts, prepend=0.0) >= min_duration) & (np.diff(cuts, append=duration) >= min_duration)
        cuts = cuts[keep]
    return [0.0, *cuts.tolist(), duration]


def make_pool(traffic: dict, seed: int, device) -> list[tuple[torch.Tensor, int, float]]:
    """The pool's ``(wav, rate, duration)`` chunks in order, soundtrack by
    soundtrack: each soundtrack ``channels`` x its samples of white noise
    under a slow random envelope a channel, made on the device; each chunk
    the channel mean of its samples, z-scored on its own (``mono_zscore``)."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "soundtracks"))
    rate, channels = traffic["sample_rate"], traffic["channels"]
    lo, hi = traffic["min_soundtrack_s"], traffic["max_soundtrack_s"]
    lengths = torch.randint(int(lo * rate), int(hi * rate) + 1, (traffic["soundtracks"],), generator=gen,
                            device=device).tolist()
    pool = []
    for n in lengths:
        steps = math.ceil(n / (ENVELOPE_S * rate)) + 1
        envelope = torch.exp(0.5 * torch.randn(1, channels, steps, generator=gen, device=device))
        envelope = F.interpolate(envelope, size=n, mode="linear", align_corners=True)[0]
        sound = (torch.randn(channels, n, generator=gen, device=device) * envelope).mean(dim=0)
        edges = chunk_edges(n / rate, traffic["max_duration"], traffic["min_duration"])
        for start, stop in zip(edges[:-1], edges[1:]):
            wav = sound[round(start * rate):round(stop * rate)]
            wav = (wav - wav.mean()) / (1e-8 + wav.std(correction=0))
            pool.append((wav, rate, wav.shape[0] / rate))
    return pool


def valid_frames(samples: int, rate: int) -> int:
    """The 50 Hz frames of a chunk of ``samples`` at ``rate``: 400 / 160
    fbank frames of its 16 kHz samples, stacked in pairs."""
    n16 = int(samples * reference.TARGET_SR / rate)
    return (1 + (n16 - 400) // 160) // 2


def bucket_of(samples: int, rate: int, bucket_seconds: float) -> int:
    """The 16 kHz bucket ``encode_sound_stream`` pads the chunk to."""
    step = int(bucket_seconds * reference.TARGET_SR)
    n16 = int(samples * reference.TARGET_SR / rate)
    return max(step, -(-n16 // step) * step)


class Driver:
    def __init__(self, run) -> None:
        self.run = run
        cfg = run.config
        self.backbone = load_audio_backbone(reference.make_weights(cfg, run.seed, run.device),
                                            {k: cfg[k] for k in HF_KEYS}, device=run.device)
        self.pool = [(wav.cpu().numpy(), rate, duration)
                     for wav, rate, duration in make_pool(run.traffic, run.seed, run.device)]
        self.bucket_seconds = cfg["bucket_seconds"]
        self.encode = encode_sound_stream
        self.first_valid = valid_frames(len(self.pool[0][0]), self.pool[0][1])
        self.frames = reference.sample_frames(self.first_valid, run.seed, SAMPLED_FRAMES)
        self.first_input = self.first_attention = None
        self._capture = False
        attention = self.backbone.model.layers[0].self_attn
        attention.register_forward_pre_hook(self._take_first_input)
        attention.linear_out.register_forward_pre_hook(self._take_first_attention)

    def _take_first_input(self, module, args) -> None:
        """The first layer's attention input at the valid frames, once after
        ``_capture`` is set: (frames, D), left on the device."""
        if self._capture:
            self.first_input = args[0][0, :self.first_valid]

    def _take_first_attention(self, module, args) -> None:
        """The first layer's attention output at the sampled frames, once
        after ``_capture`` is set: (frames, D), left on the device."""
        if self._capture:
            self._capture = False
            self.first_attention = args[0][0, self.frames.to(args[0].device)]

    def prepare(self) -> None:
        """The longest piece ``ChunkEvents`` can cut (a sample short of
        ``max_duration + min_duration``, the largest bucket: so that the
        peak memory is the traffic's, whatever tails the seed drew), then
        one chunk of every bucket in the pool, through the stream: every
        shape of the window."""
        traffic = self.run.traffic
        rate = traffic["sample_rate"]
        longest = round((traffic["max_duration"] + traffic["min_duration"]) * rate) - 1
        pieces, total = [], 0
        for wav, _, _ in self.pool:
            pieces.append(wav)
            total += len(wav)
            if total >= longest:
                break
        wav = np.concatenate(pieces)[:longest]
        warm = [(wav, rate, len(wav) / rate)]
        buckets = {bucket_of(len(wav), rate, self.bucket_seconds)}
        for chunk in self.pool:
            bucket = bucket_of(len(chunk[0]), chunk[1], self.bucket_seconds)
            if bucket not in buckets:
                buckets.add(bucket)
                warm.append(chunk)
        for _ in self.encode(self.backbone, warm, self.bucket_seconds):
            pass

    def _stream(self, seconds: float, order: list[int]):
        t0 = time.perf_counter()
        i = 0
        while not order or time.perf_counter() - t0 < seconds:
            with span("next_chunk"):
                index = i % len(self.pool)
                order.append(index)
                i += 1
            yield self.pool[index]

    def window(self, seconds: float, tracer) -> dict:
        sync = torch.cuda.synchronize if self.run.device.type == "cuda" else (lambda: None)
        counts = getattr(self.backbone, "counts", None)  # the port's counters, where it has them
        if counts is not None:
            self.backbone.reset_counts()
        sync()
        self.order: list[int] = []
        self.answers: list[np.ndarray] = []
        chunk_frames: list[int] = []
        counted = 0
        self._capture = True
        with tracer.window():
            t0 = time.perf_counter()
            with span("stream"):
                for latents in self.encode(self.backbone, self._stream(seconds, self.order), self.bucket_seconds):
                    self.answers.append(latents)
                    if counts is not None:
                        chunk_frames.append(counts["frames"] - counted)
                        counted = counts["frames"]
            elapsed = time.perf_counter() - t0
        n = len(self.answers)
        work = {"window_s": elapsed, "chunks": n, "stim_s": sum(self.pool[i][2] for i in self.order[:n]),
                "attempted": len(self.order), "failed": len(self.order) - n}
        if counts is not None:
            work.update(frames=counts["frames"], padded_frames=counts["padded_frames"], chunk_frames=chunk_frames)
        return work

    def release(self) -> None:
        del self.backbone
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def numbers(self) -> dict[str, float]:
        """Every answer of the window against the reference's states of its
        pool chunk (``reference.gaps``), the worst answer's; and the first
        chunk's first-layer attention output at the sampled frames against
        the reference's of the same attention input
        (``reference.attention_gap``)."""
        answered = self.order[:len(self.answers)]
        distinct = sorted(set(answered))  # the window's first chunk is the pool's first
        chunks = [(torch.from_numpy(self.pool[i][0]).to(self.run.device), *self.pool[i][1:]) for i in distinct]
        states, attention = reference.chunk_states(self.run.config, self.run.seed, chunks, frames=self.frames,
                                                   attention_input=self.first_input)
        ref = dict(zip(distinct, states))
        per_answer = [reference.gaps(torch.from_numpy(got), ref[i]) for got, i in zip(self.answers, answered)]
        out = {key: max(g[key] for g in per_answer) for key in per_answer[0]}
        out["first_attention_gap"] = reference.attention_gap(self.first_attention, attention)
        return out


#: the controls: each precision the configuration states, one step lower on
#: its own (the float32 score pipeline in bf16, the bf16 denses in fp8 e4m3)
CONTROLS = {"bf16_scores": {"scores": "bf16"}, "fp8_denses": {"denses": "fp8"}}


def control(run) -> dict[str, dict[str, float]]:
    """Each control's reference in the program's place, over the pool: the
    worst chunk's numbers, by the control's name (the attention of each
    one's own first attention input, which the score control leaves as the
    reference has it)."""
    pool = make_pool(run.traffic, run.seed, run.device)
    first = pool[0]
    frames = reference.sample_frames(valid_frames(len(first[0]), first[1]), run.seed, SAMPLED_FRAMES)
    ref, ref_attention = reference.chunk_states(run.config, run.seed, pool, frames=frames)
    out = {}
    for name, lower in CONTROLS.items():
        low, low_attention = reference.chunk_states(run.config, run.seed, pool, frames=frames, **lower)
        per_chunk = [reference.gaps(s, r) for s, r in zip(low, ref)]
        out[name] = {key: max(g[key] for g in per_chunk) for key in per_chunk[0]}
        out[name]["first_attention_gap"] = reference.attention_gap(low_attention, ref_attention)
    return out


def _altered_answer(driver: Driver) -> None:
    """Every chunk comes back one step late on the 2 Hz grid (an
    off-by-one of the frame index)."""
    encode = driver.encode

    def altered(*args, **kwargs):
        for latents in encode(*args, **kwargs):
            yield np.roll(latents, 1, axis=-1)

    driver.encode = altered


FAULTS = {"altered_answer": _altered_answer}
