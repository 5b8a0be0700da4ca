"""The port's audio feature path (features/audio.py) against the JAX package's.

The JAX ``Wav2VecBert._compute`` on its tiny fp32 backbone over ``Sound``
events in wav files is the reference; the port's ``encode_sound_stream``
runs ``TinyAudioBackbone`` built from the same weights
(models.convert.wav2vec_bert_params_to_torch) on the CPU over the same
files, read and z-scored by ``mono_zscore``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algonauts2025_tpu.core.events import Sound
from algonauts2025_tpu.features import audio as ja
from algonauts2025_tpu.io import wav as wavio
from algonauts2025_tpu_torch.features import audio as ta
from algonauts2025_tpu_torch.models import wav2vec_bert_params_to_torch


@pytest.fixture(scope="module")
def pair():
    """The JAX tiny backbone and the port's with the same weights."""
    jax_backbone = ja.TinyAudioBackbone(hidden_size=32, num_layers=2)
    port = ta.TinyAudioBackbone(hidden_size=32, num_layers=2,
                                state_dict=wav2vec_bert_params_to_torch(jax_backbone.params), device="cpu")
    return jax_backbone, port


def _wav(seconds: float, sr: int = ta.TARGET_SR, channels: int = 1, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((int(seconds * sr), channels))).astype(np.float32)


# the fp32 conformer on both sides (states of magnitude ~4); the rest is
# the mel frontend's FFT difference (tests/test_audio_bucketing.py)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bucket_seconds", [5.0, 0.0])
def test_encode_sound_stream_matches_jax_compute(pair, tmp_path, bucket_seconds):
    """Sound events in wav files at 16, 44.1 and 48 kHz, mono and stereo."""
    jax_backbone, port = pair
    feat = ja.Wav2VecBert(model_name="tiny-random", bucket_seconds=bucket_seconds)
    feat.set_backbone(jax_backbone)
    events, chunks = [], []
    for i, (seconds, sr, channels) in enumerate(((2.2, 16000, 1), (3.9, 44100, 2), (5.3, 48000, 2))):
        path = tmp_path / f"w{i}.wav"
        wavio.write(path, _wav(seconds, sr, channels, seed=i), sr)
        event = Sound(start=0.0, timeline=f"t{i}", filepath=str(path))
        events.append(event)
        chunks.append((ta.mono_zscore(wavio.read(str(path))), event.frequency, event.duration))
    ref = [np.asarray(x) for x in feat._compute(events)]
    got = list(ta.encode_sound_stream(port, chunks, bucket_seconds=bucket_seconds))
    assert [g.shape for g in got] == [r.shape for r in ref] == [(3, 32, 4), (3, 32, 8), (3, 32, 11)]
    for g, r in zip(got, ref):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, r, **TOL)
    if bucket_seconds:
        assert port.bucket_shapes == {(80000, 10), (160000, 20)}


def test_hidden_states_match_jax(pair):
    jax_backbone, port = pair
    wav = _wav(1.7)[:, 0]
    ref = jax_backbone.hidden_states(wav)
    got = port.hidden_states(wav)
    assert got.shape == ref.shape == (3, 84, 32)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("seconds,n_out,bucket", [(3.7, 7, 5), (4.9, 10, 5), (2.9, 3, 10), (0.3, 1, 5)])
def test_2hz_frame_indices_equal_jax(seconds, n_out, bucket):
    """The 2 Hz frames picked on the device, float32 arithmetic as in JAX:
    the exact-length and the bucketed index, element for element."""
    t50 = int(seconds * 50) - 1
    jax_exact = np.clip(np.asarray(jnp.floor(jnp.arange(n_out) * (t50 / n_out)).astype(jnp.int32)), 0, t50 - 1)
    np.testing.assert_array_equal(ta._frame_index(n_out, np.float32(t50 / n_out), t50), jax_exact)
    n_max = max(n_out, int(bucket * ta.OUTPUT_HZ))
    t_f, n_f = jnp.float32(t50), jnp.maximum(jnp.float32(n_out), 1.0)
    jax_bucketed = np.clip(np.asarray(jnp.floor(jnp.arange(n_max) * (t_f / n_f)).astype(jnp.int32)), 0, t50 - 1)
    ratio = np.float32(t50) / np.float32(n_out)
    np.testing.assert_array_equal(ta._frame_index(n_max, ratio, t50), jax_bucketed)


def test_2hz_frame_indices_float32_not_float64():
    """A boundary where float64 picks the next frame: the port keeps JAX's."""
    hits = [(t, n) for t in range(50, 400) for n in range(2, 40)
            if not np.array_equal(ta._frame_index(n, np.float32(t / n), t),
                                  np.clip(np.floor(np.arange(n) * (t / n)).astype(int), 0, t - 1))]
    assert hits  # float64 would differ here; the equality test above pins float32


def test_bucketed_states_match_exact(pair):
    """tests/test_audio_bucketing.py's invariant and tolerance, on the port."""
    port = pair[1]
    wav = _wav(3.7, seed=1)[:, 0]
    exact = port.hidden_states_2hz(wav, 7)
    bucketed = port.hidden_states_2hz_bucketed(wav, 7, 5 * ta.TARGET_SR)
    assert bucketed.shape == exact.shape == (3, 32, 7)
    np.testing.assert_allclose(bucketed, exact, atol=2e-3, rtol=1e-3)


def test_bucket_smaller_than_wav_raises(pair):
    with pytest.raises(ValueError, match="bucket"):
        pair[1].hidden_states_2hz_bucketed(_wav(1.2)[:, 0], 2, ta.TARGET_SR)


def test_mono_zscore_matches_jax(tmp_path):
    path = tmp_path / "s.wav"
    wavio.write(path, _wav(0.8, channels=2, seed=3), ta.TARGET_SR)
    got = ta.mono_zscore(wavio.read(str(path)))
    data = wavio.read(str(path)).mean(axis=1)  # the JAX package's NumPy path
    np.testing.assert_array_equal(got, (data - data.mean()) / (1e-8 + data.std()))
    np.testing.assert_allclose(got, wavio.read_mono_zscore(str(path)), atol=1e-5)


def test_nearest_resample_matches_jax(rng):
    x = rng.standard_normal((3, 4, 37)).astype(np.float32)
    for n_out in (1, 10, 37, 80):
        np.testing.assert_array_equal(ta.nearest_resample(x, n_out), ja.nearest_resample(x, n_out))


def test_load_audio_backbone_matches_jax_converter(rng):
    """An HF-named state dict and config.json keys, bf16, against the JAX
    package's params_from_hf on the same dict."""
    from algonauts2025_tpu.models.backbones import wav2vec_bert as jw

    from test_torch_wav2vec_bert import HF_SMALL, _hf_state_dict

    cfg = dict(feature_projection_input_dim=20, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64, conv_depthwise_kernel_size=7, left_max_position_embeddings=8,
               right_max_position_embeddings=2)
    sd = _hf_state_dict(rng)
    port = ta.load_audio_backbone(sd, cfg, device="cpu")
    assert port.model.cfg.dtype == torch.bfloat16 and port.model.cfg.input_dim == 20
    jcfg = jw.Wav2VecBertConfig(**HF_SMALL)
    feats = rng.standard_normal((1, 30, 20)).astype(np.float32)
    want = np.asarray(jw.Wav2VecBertBackbone(jcfg).apply({"params": jw.params_from_hf(sd, jcfg)},
                                                         jnp.asarray(feats)), np.float32)
    with torch.no_grad():
        got = port.model(torch.from_numpy(feats)).numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 2e-2


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ta.TinyAudioBackbone()
    assert ta.TinyAudioBackbone(device="cpu").device == torch.device("cpu")
