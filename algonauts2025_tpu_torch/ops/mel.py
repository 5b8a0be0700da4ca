"""Kaldi-style log-mel filterbank frontend (SeamlessM4T parity).

The port of algonauts2025_tpu/ops/mel.py, run on the waveform's device:
framing, DC removal, pre-emphasis, povey window, rFFT, kaldi mel
projection, log, per-bin normalization, 2-frame stacking.  Constants
match HF feature_extraction_seamless_m4t.py: 400/160 frames, 512-point
FFT, 80 kaldi mel bins in [20, 8000] Hz, mel floor 2^-23, the waveform
scaled to the 16-bit range.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["log_mel_features", "log_mel_features_masked", "mel_filter_bank_kaldi", "povey_window"]


def _hz_to_mel_kaldi(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


@functools.lru_cache(maxsize=4)
def mel_filter_bank_kaldi(
    num_frequency_bins: int = 257,
    num_mel_filters: int = 80,
    min_frequency: float = 20.0,
    max_frequency: float = 8000.0,
    sampling_rate: int = 16000,
) -> np.ndarray:
    """(num_frequency_bins, num_mel_filters) triangular filters built in mel
    space (triangularize_in_mel_space=True, norm=None)."""
    mel_min = _hz_to_mel_kaldi(min_frequency)
    mel_max = _hz_to_mel_kaldi(max_frequency)
    mel_freqs = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    # fft bin frequencies mapped into mel space
    fft_bin_width = sampling_rate / ((num_frequency_bins - 1) * 2)
    fft_freqs = _hz_to_mel_kaldi(fft_bin_width * np.arange(num_frequency_bins))
    filter_diff = np.diff(mel_freqs)
    slopes = np.expand_dims(mel_freqs, 0) - np.expand_dims(fft_freqs, 1)
    down_slopes = -slopes[:, :-2] / filter_diff[:-1]
    up_slopes = slopes[:, 2:] / filter_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=4)
def povey_window(length: int = 400) -> np.ndarray:
    """Kaldi povey window: hann(periodic=False)^0.85."""
    n = np.arange(length, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * math.pi * n / (length - 1))
    return (hann**0.85).astype(np.float32)


def _log_mel(
    waveform: torch.Tensor,
    frame_length: int,
    hop_length: int,
    fft_length: int,
    stride: int,
    n_valid: int | None,
) -> tuple[torch.Tensor, int]:
    device = waveform.device
    waveform = waveform.float() * 32768.0
    num_frames = 1 + (waveform.shape[-1] - frame_length) // hop_length
    frames = waveform.unfold(0, frame_length, hop_length)  # (F, frame_length), a view
    # remove DC offset per frame
    frames = frames - frames.mean(dim=-1, keepdim=True)
    # pre-emphasis 0.97 (first sample scaled, HF audio_utils parity)
    pre = torch.cat([frames[:, :1] * (1 - 0.97), frames[:, 1:] - 0.97 * frames[:, :-1]], dim=-1)
    windowed = pre * torch.from_numpy(povey_window(frame_length)).to(device)
    spec = torch.fft.rfft(windowed, n=fft_length, dim=-1)
    power = spec.abs() ** 2  # (F, fft/2+1)
    mel = power @ torch.from_numpy(mel_filter_bank_kaldi(fft_length // 2 + 1)).to(device)
    mel = torch.log(torch.clamp_min(mel, 1.192092955078125e-07))
    # per-mel-bin normalization over time (ddof=1); with ``n_valid`` the
    # statistics come from the valid (un-padded) frames only, so a
    # zero-padded bucket normalizes exactly like the exact-length call
    if n_valid is None:
        n_frames_valid = num_frames
        mean = mel.mean(dim=0, keepdim=True)
        var = mel.var(dim=0, correction=1, keepdim=True)
    else:
        n_frames_valid = min(max(1 + (int(n_valid) - frame_length) // hop_length, 1), num_frames)
        valid = mel[:n_frames_valid]
        mean = valid.sum(dim=0, keepdim=True) / n_frames_valid
        var = ((valid - mean) ** 2).sum(dim=0, keepdim=True) / max(n_frames_valid - 1, 1)
    mel = (mel - mean) / torch.sqrt(var + 1e-7)
    # stack `stride` frames
    t = (mel.shape[0] // stride) * stride
    return mel[:t].reshape(t // stride, mel.shape[1] * stride), n_frames_valid // stride


def log_mel_features(
    waveform: torch.Tensor,
    frame_length: int = 400,
    hop_length: int = 160,
    fft_length: int = 512,
    stride: int = 2,
) -> torch.Tensor:
    """(T,) float32 mono 16 kHz waveform -> (T', 80*stride) features.

    Matches SeamlessM4TFeatureExtractor with do_normalize_per_mel_bins=True
    and pad_to_multiple_of handled by the stride trim."""
    return _log_mel(waveform, frame_length, hop_length, fft_length, stride, None)[0]


def log_mel_features_masked(
    waveform: torch.Tensor,
    n_valid: int,
    frame_length: int = 400,
    hop_length: int = 160,
    fft_length: int = 512,
    stride: int = 2,
) -> tuple[torch.Tensor, int]:
    """Length-bucketed variant: ``waveform`` is zero-padded to a bucket
    width, ``n_valid`` is the true sample count.  Returns (features,
    valid_feature_frames); normalization statistics use valid frames only."""
    return _log_mel(waveform, frame_length, hop_length, fft_length, stride, n_valid)
