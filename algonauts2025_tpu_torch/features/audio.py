"""w2v-BERT audio features: frozen conformer states on the 2 Hz grid.

The device side of algonauts2025_tpu/features/audio.py.  Per chunk: a mono
z-scored waveform (``mono_zscore``), polyphase resampling to 16 kHz
(ops/resample.py), the kaldi log-mel frontend (ops/mel.py), the frozen
conformer's hidden states, and nearest-neighbour resampling of the (L+1,
D, T50) stack onto the 2 Hz grid, on the device.  Each waveform is
zero-padded to a multiple of ``bucket_seconds``, with the padding masked
out of the mel statistics and the attention, as the JAX package does to
bound its compiled shapes.

The pydantic ``Wav2VecBert`` feature, ``Sound`` events, the cache uid and
wav I/O are host layers that are not ported yet (ROADMAP queue 1 item 11):
``encode_sound_stream`` takes ``(waveform, rate, duration)`` chunks.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ..models.backbones.wav2vec_bert import Wav2VecBertBackbone, Wav2VecBertConfig, params_from_hf
from ..ops.mel import log_mel_features, log_mel_features_masked
from ..ops.resample import resample_poly
from ..runtime import default_device

__all__ = [
    "TARGET_SR",
    "OUTPUT_HZ",
    "nearest_resample",
    "mono_zscore",
    "TorchAudioBackbone",
    "TinyAudioBackbone",
    "load_audio_backbone",
    "encode_sound_stream",
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


class TorchAudioBackbone:
    """A Wav2VecBertBackbone on one device (the CUDA card unless ``device``
    says otherwise); waveforms are 16 kHz mono float32 arrays or tensors."""

    def __init__(self, model: Wav2VecBertBackbone, device: str | torch.device | None = None):
        self.device = default_device(device)
        self.model = model.to(self.device).eval()
        #: distinct (bucket samples, n_out_max) shapes run so far
        self.bucket_shapes: set[tuple[int, int]] = set()

    def _wav(self, wav_16k) -> torch.Tensor:
        return torch.as_tensor(wav_16k, dtype=torch.float32).to(self.device)

    @torch.no_grad()
    def hidden_states(self, wav_16k) -> np.ndarray:
        """(T,) 16 kHz waveform -> (L+1, T50, D) hidden stack."""
        return self.model(log_mel_features(self._wav(wav_16k))[None])[:, 0].cpu().numpy()

    @torch.no_grad()
    def hidden_states_2hz(self, wav_16k, n_out: int) -> np.ndarray:
        """(L+1, D, n_out) hidden stack resampled to the output grid on the device."""
        states = self.model(log_mel_features(self._wav(wav_16k))[None])[:, 0]  # (L+1, T50, D)
        t50 = states.shape[1]
        idx = _frame_index(n_out, np.float32(t50 / n_out), t50)
        return states[:, torch.from_numpy(idx).to(self.device)].transpose(1, 2).cpu().numpy()

    @torch.no_grad()
    def hidden_states_2hz_bucketed(self, wav_16k, n_out: int, bucket_samples: int) -> np.ndarray:
        """Bucketed variant: the wav is zero-padded to ``bucket_samples``; the
        mel normalization and the conformer's attention mask out the
        padding, so the values match the exact-length call within float
        tolerance."""
        wav = self._wav(wav_16k)
        n = wav.shape[-1]
        if bucket_samples < n:
            raise ValueError(f"bucket {bucket_samples} smaller than wav {n}")
        n_out_max = max(n_out, int(bucket_samples / TARGET_SR * OUTPUT_HZ))
        self.bucket_shapes.add((bucket_samples, n_out_max))
        feats, t_valid = log_mel_features_masked(F.pad(wav, (0, bucket_samples - n)), n)
        mask = (torch.arange(feats.shape[0], device=self.device) < t_valid)[None]
        states = self.model(feats[None], attention_mask=mask)[:, 0]  # (L+1, T50pad, D)
        ratio = np.float32(t_valid) / np.float32(max(n_out, 1))
        idx = _frame_index(n_out_max, ratio, t_valid)[:n_out]
        return states[:, torch.from_numpy(idx).to(self.device)].transpose(1, 2).cpu().numpy()


class TinyAudioBackbone(TorchAudioBackbone):
    """Small random-weight conformer for offline/synthetic runs (the JAX
    package's tiny config, fp32): random weights from ``seed``, or the
    weights of ``state_dict`` (e.g. a JAX tiny backbone's, converted by
    ``models.convert.wav2vec_bert_params_to_torch``)."""

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
    least one); 0 runs the exact length."""
    for wav, sfreq, duration in chunks:
        wav = torch.as_tensor(np.asarray(wav, dtype=np.float32)).to(backbone.device)
        if int(sfreq) != TARGET_SR:
            wav = resample_poly(wav, int(sfreq), TARGET_SR)
        timepoints = max(1, int(np.round(np.multiply(duration, OUTPUT_HZ))))
        if bucket_seconds:
            step = int(bucket_seconds * TARGET_SR)
            bucket = max(step, -(-wav.shape[-1] // step) * step)
            latents = backbone.hidden_states_2hz_bucketed(wav, timepoints, bucket)
        else:
            latents = backbone.hidden_states_2hz(wav, timepoints)
        yield latents.astype(np.float32)
