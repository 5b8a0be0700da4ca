"""The port's audio frontend (ops/resample.py, ops/mel.py) against the JAX
package's, on the CPU, with HF's SeamlessM4TFeatureExtractor as a second
oracle for the mel features."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from algonauts2025_tpu.ops import mel as jmel
from algonauts2025_tpu.ops import resample as jres
from algonauts2025_tpu_torch.ops import mel as tmel
from algonauts2025_tpu_torch.ops import resample as tres

SR = 16000


def _speech_like(n: int, sr: int, rng) -> np.ndarray:
    """tests/test_ops.py's voiced-speech stand-in."""
    t = np.arange(n) / sr
    f0 = 120 * (1 + 0.1 * np.sin(2 * np.pi * 2.5 * t))
    x = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 9))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
    return (x + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("old_sr", [44100, 48000, 22050])
def test_resample_kernel_bank_is_the_jax_bank(old_sr):
    ours, theirs = tres.resample_kernel(old_sr, SR), jres.resample_kernel(old_sr, SR)
    assert ours[1:] == theirs[1:]
    np.testing.assert_array_equal(ours[0], theirs[0])


# fp32 convolutions that differ only in the order of their sums
@pytest.mark.parametrize("old_sr", [44100, 48000, 22050])
def test_resample_matches_jax(rng, old_sr):
    x = _speech_like(int(1.3 * old_sr), old_sr, rng)
    ref = np.asarray(jres.resample_poly(jnp.asarray(x), old_sr, SR))
    got = tres.resample_poly(torch.from_numpy(x), old_sr, SR)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6, rtol=1e-5)


def test_resample_batched_leading_axes(rng):
    x = rng.standard_normal((2, 3, 4410)).astype(np.float32)
    got = tres.resample_poly(torch.from_numpy(x), 44100, SR)
    assert got.shape == (2, 3, 1600)
    np.testing.assert_allclose(got[1, 2].numpy(), tres.resample_poly(torch.from_numpy(x[1, 2]), 44100, SR).numpy(),
                               atol=1e-6)


def test_resample_identity(rng):
    x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    assert tres.resample_poly(x, SR, SR) is x


def test_mel_tables_are_the_jax_tables():
    np.testing.assert_array_equal(tmel.mel_filter_bank_kaldi(257), jmel.mel_filter_bank_kaldi(257))
    np.testing.assert_array_equal(tmel.povey_window(400), jmel.povey_window(400))


# tests/test_audio_bucketing.py's tolerance: torch's and XLA's FFTs differ
# in the last bits, which the log of small mel energies amplifies
MEL_TOL = dict(atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("seconds", [0.05, 1.0, 2.3])
def test_mel_matches_jax(rng, seconds):
    wav = _speech_like(int(seconds * SR), SR, rng)
    ref = np.asarray(jmel.log_mel_features(jnp.asarray(wav)))
    got = tmel.log_mel_features(torch.from_numpy(wav))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **MEL_TOL)


@pytest.mark.parametrize("n_valid", [1200, 36800, 64000])
def test_masked_mel_matches_jax(rng, n_valid):
    """A few valid frames, most of the bucket, and the whole bucket."""
    padded = np.zeros(4 * SR, np.float32)
    padded[:n_valid] = rng.standard_normal(n_valid).astype(np.float32)
    ref, ref_t = jmel.log_mel_features_masked(jnp.asarray(padded), np.int32(n_valid))
    got, got_t = tmel.log_mel_features_masked(torch.from_numpy(padded), n_valid)
    assert got_t == int(ref_t) and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **MEL_TOL)


def test_masked_mel_matches_exact_length(rng):
    """tests/test_audio_bucketing.py's invariant, on the port."""
    wav = rng.standard_normal(int(2.3 * SR)).astype(np.float32)
    exact = tmel.log_mel_features(torch.from_numpy(wav))
    padded = np.zeros(4 * SR, np.float32)
    padded[: len(wav)] = wav
    feats, t = tmel.log_mel_features_masked(torch.from_numpy(padded), len(wav))
    assert t == exact.shape[0]
    np.testing.assert_allclose(feats[:t].numpy(), exact.numpy(), **MEL_TOL)


def test_mel_matches_hf_feature_extractor():
    """A second oracle, at tests/test_backbones.py's tolerance."""
    transformers = pytest.importorskip("transformers")
    fe = transformers.SeamlessM4TFeatureExtractor()
    rng = np.random.default_rng(0)
    wav = (0.3 * np.sin(np.linspace(0, 700, SR)) + 0.05 * rng.standard_normal(SR)).astype(np.float32)
    ref = fe(wav, sampling_rate=SR, return_tensors="np", padding=False)["input_features"][0]
    got = tmel.log_mel_features(torch.from_numpy(wav)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=1e-3)
