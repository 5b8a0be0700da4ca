"""The port's w2v-BERT 2.0 audio path against the benchmark's plain reference.

``benchmark/reference/w2v_bert2.py`` (plain PyTorch, no import of the port)
is the reference; the port's ``encode_sound_stream`` runs the model built
from the same seeded weights in the HF layout (``params_from_hf``) on the
CPU, at a tiny size: 2 layers, 64 wide, 4 heads, conv 7, the published
distance clamp (64 left, 8 right).  Also here: the spans and counters of the
stream, and the work that ``audio.mfu`` counts.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from algonauts2025_tpu_torch.features import audio as ta
from algonauts2025_tpu_torch.models.backbones.wav2vec_bert import (Wav2VecBertBackbone, Wav2VecBertConfig,
                                                                   params_from_hf, relative_positions)
from algonauts2025_tpu_torch.ops.mel import log_mel_features, log_mel_features_masked
from algonauts2025_tpu_torch.ops.resample import resample_poly
from algonauts2025_tpu_torch.utils import profiling
from benchmark.harness import load_module
from benchmark.reference import w2v_bert2 as ref

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
FULL = json.loads((BENCH / "configs" / "w2v_bert2.json").read_text())
TINY = {**FULL, "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 128,
        "conv_depthwise_kernel_size": 7}
#: 48 kHz chunks: padded into a 5 s bucket, exactly one bucket, padded into 10 s
SECONDS = (3.2, 5.0, 7.3)


def _backbone(seed: int, dtype: torch.dtype) -> ta.TorchAudioBackbone:
    cfg = Wav2VecBertConfig(input_dim=160, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                            conv_kernel_size=7, dtype=dtype)
    model = Wav2VecBertBackbone(cfg, device="cpu")
    model.load_state_dict(params_from_hf(ref.make_weights(TINY, seed, "cpu"), cfg))
    return ta.TorchAudioBackbone(model, device="cpu")


def _chunks(seed: int, rate: int = 48000) -> list[tuple[np.ndarray, int, float]]:
    rng = np.random.default_rng(seed)
    out = []
    for seconds in SECONDS:
        n = int(seconds * rate)
        stereo = rng.standard_normal((n, 2)).astype(np.float32) * np.linspace(0.2, 1.5, n, dtype=np.float32)[:, None]
        out.append((ta.mono_zscore(stereo).astype(np.float32), rate, n / rate))
    return out


def _rel(got, want) -> np.ndarray:
    """Relative L2 of each layer over (D, n_out)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm((got - want).reshape(len(want), -1), axis=1) / np.linalg.norm(want.reshape(len(want), -1),
                                                                                        axis=1)


# float32: the float32 model on both sides, the gap the resampler's and the
# FFT's float32 rounding (~1e-7 of the waveform, ~4e-6 of the fbank) leave
# after 2 layers (read 1e-6 to 2e-6).  bf16: that rounding flips a bf16
# value now and then, and a flip moves its layer by up to a bf16 step
# (2^-8): read 1e-3 to 3e-3 after 2 layers; fp8 denses read 3.9e-2 and more.
TOLERANCE = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("bucket_seconds", [5.0, 0.0], ids=["bucketed", "exact"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_stream_matches_reference(dtype, bucket_seconds):
    seed = 2**31 + 11
    chunks = _chunks(seed)
    got = list(ta.encode_sound_stream(_backbone(seed, dtype), chunks, bucket_seconds=bucket_seconds))
    want, _ = ref.chunk_states(TINY, seed, [(torch.from_numpy(w), r, d) for w, r, d in chunks], dtype=dtype)
    assert [g.shape for g in got] == [tuple(w.shape) for w in want] == [(3, 64, 6), (3, 64, 10), (3, 64, 15)]
    for g, w in zip(got, want):
        assert _rel(g, w.numpy()).max() < TOLERANCE[dtype]


def test_bf16_tolerance_catches_fp8_denses():
    """The bf16 tolerance above lies below what the fp8-dense control reads."""
    seed = 5
    chunks = [(torch.from_numpy(w), r, d) for w, r, d in _chunks(seed)]
    sound, _ = ref.chunk_states(TINY, seed, chunks)
    low, _ = ref.chunk_states(TINY, seed, chunks, denses="fp8")
    assert min(_rel(lo.numpy(), s.numpy())[1:].max() for lo, s in zip(low, sound)) > 2 * TOLERANCE[torch.bfloat16]


@pytest.mark.parametrize("rate", [48000, 44100])
def test_resampler_matches_reference(rate):
    """The polyphase conv against the reference's tap-by-tap sum: float32
    sums in another order (read 8e-8)."""
    wav = torch.from_numpy(_chunks(1, rate)[0][0])
    got, want = resample_poly(wav, rate, 16000), ref.resample(wav, rate, 16000)
    assert got.shape == want.shape == (int(len(wav) * 16000 / rate),)
    assert float((got - want).norm() / want.norm()) < 1e-6


def test_fbank_matches_reference():
    """The kaldi fbank of one 16 kHz waveform: the same float32 operations
    (read equal); the bucketed fbank's valid frames, statistics over them
    alone (read 4e-8)."""
    wav = resample_poly(torch.from_numpy(_chunks(2)[2][0]), 48000, 16000)
    want = ref.fbank(wav)
    got = log_mel_features(wav)
    assert got.shape == want.shape == (364, 160)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
    padded, t_valid = log_mel_features_masked(torch.nn.functional.pad(wav, (0, 160000 - len(wav))), len(wav))
    assert t_valid == 364 and padded.shape == (499, 160)
    torch.testing.assert_close(padded[:t_valid], want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("t", [80, 150])
def test_relative_bias_einsum_matches_gather(t):
    """HF's einsum over the gathered table against the port's projection
    onto the table and gather (``RelKeyAttention``), at T > 73 so that the
    clamp engages at both ends."""
    gen = torch.Generator().manual_seed(t)
    q, table = torch.randn(4, t, 16, generator=gen), torch.randn(73, 16, generator=gen)
    rows = torch.arange(t)
    want = ref.relative_bias(q, table, rows, t, 64, 8)
    got = torch.take_along_dim(q @ table.T, relative_positions(t, 64, 8)[None], dim=-1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # clamped: every key more than 8 ahead or 64 behind reads the edge row
    torch.testing.assert_close(want[:, 0, 9:], (q[:, 0] @ table[-1])[:, None].expand(-1, t - 9))
    torch.testing.assert_close(want[:, t - 1, :t - 65], (q[:, t - 1] @ table[0])[:, None].expand(-1, t - 65))
    # and the distances just inside the edges read rows of their own
    assert not torch.allclose(want[:, 0, 7], want[:, 0, 8])
    assert not torch.allclose(want[:, t - 1, t - 64], want[:, t - 1, t - 65])


def _ranges(path: Path) -> list[tuple[str, float, float]]:
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


def test_stream_spans_a_chunk(tmp_path):
    """Under a profiler each chunk's stages are six ``audio.*#k`` spans, in
    the order the code runs them, and the backbone's holds 1 + 4 L
    ``conformer.*`` spans."""
    backbone = _backbone(3, torch.float32)
    with profiling.trace(tmp_path):
        list(ta.encode_sound_stream(backbone, _chunks(3), bucket_seconds=5.0))
    ranges = _ranges(tmp_path / "trace.json")
    audio = [name for name, _, _ in ranges if name.startswith("audio.")]
    stages = ("upload", "resample", "mel", "backbone", "frames", "fetch")
    assert audio == [f"audio.{stage}#{k}" for k in range(3) for stage in stages]
    conformer = ["conformer.embed"] + ["conformer.ffn1", "conformer.attention", "conformer.conv", "conformer.ffn2"] * 2
    for k in range(3):
        start, end = next((s, e) for n, s, e in ranges if n == f"audio.backbone#{k}")
        assert [n for n, s, e in ranges if n.startswith("conformer.") and start <= s and e <= end] == conformer
    assert sum(n.startswith("conformer.") for n, _, _ in ranges) == 3 * (1 + 4 * 2)


@pytest.mark.parametrize("bucket_seconds", [5.0, 0.0], ids=["bucketed", "exact"])
def test_counters_by_hand(bucket_seconds):
    """16 kHz samples n: (1 + (n - 400) // 160) // 2 valid 50 Hz frames; a
    bucket of b samples runs (1 + (b - 400) // 160) // 2.  3.2 s: 51200 ->
    159 of a 5 s bucket's 249; 5.0 s: 80000 -> 249 of 249; 7.3 s: 116800 ->
    364 of a 10 s bucket's 499."""
    backbone = _backbone(4, torch.float32)
    backbone.counts["chunks"] = 7
    backbone.reset_counts()
    list(ta.encode_sound_stream(backbone, _chunks(4), bucket_seconds=bucket_seconds))
    padded = 90 + 0 + 135 if bucket_seconds else 0
    assert backbone.counts == {"chunks": 3, "frames": 159 + 249 + 364, "padded_frames": padded}


def test_audio_mfu_work_of_a_60s_chunk_by_hand():
    """A 60 s chunk is 2999 valid frames: 4.372 TFLOP at the published widths."""
    t, h, f, layers = 2999, 1024, 4096, 24
    per_layer = 2 * (2 * 2 * t * h * f) + 4 * 2 * t * h * h + 2 * 2 * t * t * h + 2 * t * 73 * h
    per_layer += 2 * t * h * 2 * h + 2 * t * h * h + 2 * t * h * 31
    hand = 2 * t * 160 * h + layers * per_layer
    got = load_module(BENCH / "metrics" / "audio.mfu.py").chunk_flops(FULL, t)
    assert got == hand
    assert got == pytest.approx(4.372e12, rel=1e-3)
