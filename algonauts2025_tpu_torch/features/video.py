"""V-JEPA2 video features: frame windows -> token-pooled backbone states.

The device side of algonauts2025_tpu/features/video.py: each 2 Hz step
sees the previous 4 s as ``n_frames`` frames; windows are preprocessed and
encoded in batches of ``window_batch`` and the hidden states are
mean-pooled over tokens, giving an (L+1, D, T) stack per video.  The
pydantic ``VJEPA2`` feature, its cache identity, events and video decoding
are host layers that are not ported yet (ROADMAP queue 1 item 11):
``encode_window_stream`` takes the decoded windows directly.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from ..models.backbones.vjepa2 import VJEPA2Backbone, VJEPA2Config, params_from_hf
from ..ops.quant import calibrate_quant_scales
from ..ops.threefry import normal as jax_normal
from ..ops.video_prep import preprocess_frames
from ..runtime import default_device

__all__ = [
    "VideoBackbone",
    "TorchVideoBackbone",
    "TinyVideoBackbone",
    "load_video_backbone",
    "encode_window_stream",
]

_NOT_PORTED_SP = (
    "sequence parallelism (ring attention over torch.distributed) is not ported yet "
    "(ROADMAP queue 1 item 10)"
)


class VideoBackbone:
    n_frames: int = 64

    def encode_windows(self, windows: np.ndarray) -> np.ndarray:
        """(B, n_frames, H, W, 3) uint8 -> (B, L+1, D) token-pooled states."""
        raise NotImplementedError


class TorchVideoBackbone(VideoBackbone):
    """Window encoder on one device (the CUDA card unless ``device`` says otherwise)."""

    def __init__(
        self,
        model: VJEPA2Backbone,
        n_frames: int = 64,
        crop_size: int = 256,
        device: str | torch.device | None = None,
        mesh=None,
        sequence_parallel: bool = False,
    ):
        if mesh is not None or sequence_parallel:
            raise NotImplementedError(_NOT_PORTED_SP)
        self.device = default_device(device)
        self.model = model.to(self.device).eval()
        self.n_frames = n_frames
        self.crop_size = crop_size
        if model.cfg.quant_static:
            # a_scale == 0 is the "uncalibrated" sentinel: the static path
            # would saturate every activation and give finite garbage
            scales = [b for name, b in model.named_buffers() if name.endswith("a_scale")]
            if scales and any(bool((s <= 0).any()) for s in scales):
                raise ValueError(
                    "quant_static model has uncalibrated activation scales (a_scale == 0); "
                    "run ops.quant.calibrate_quant_scales on the dynamic-scale model first"
                )

    @torch.no_grad()
    def encode_windows(self, windows: np.ndarray | torch.Tensor) -> np.ndarray:
        pixels = preprocess_frames(torch.as_tensor(windows).to(self.device), self.crop_size)
        states = self.model(pixels)
        if states.dim() == 4:  # (L+1, B, N, D) -> token mean
            states = states.mean(dim=2)
        return states.transpose(0, 1).cpu().numpy()  # (B, L+1, D)


def _calibrated_static_model(model: VJEPA2Backbone, n_frames: int, crop_size: int) -> VJEPA2Backbone:
    """Calibrate the activation scales of a dynamic-scale quantized model on
    a fixed seeded input, then switch it to its static scales (in place).

    The input is the JAX package's: ``jax.random.normal(PRNGKey(7), ...)``
    as "normalized pixels", rebuilt in NumPy (ops/threefry.py); margin 1.5
    leaves clip headroom for real frames."""
    device = next(model.parameters()).device
    sample = torch.from_numpy(jax_normal(7, (1, n_frames, crop_size, crop_size, 3))).to(device)
    calibrate_quant_scales(model, sample, margin=1.5)
    return model.set_quant_static()


class TinyVideoBackbone(TorchVideoBackbone):
    """Small video ViT for offline/synthetic runs: random weights from
    ``seed``, or the weights of ``state_dict`` (e.g. a JAX tiny backbone's,
    converted by ``models.convert.vjepa2_params_to_torch``)."""

    def __init__(
        self,
        hidden_size: int = 64,
        num_layers: int = 2,
        n_frames: int = 8,
        crop_size: int = 32,
        seed: int = 0,
        quantize: bool = False,
        quant_static: bool = False,
        state_dict: tp.Mapping[str, torch.Tensor] | None = None,
        device: str | torch.device | None = None,
    ):
        device = default_device(device)
        cfg = VJEPA2Config(
            crop_size=crop_size, patch_size=16, tubelet_size=2, frames_per_clip=n_frames,
            hidden_size=hidden_size, num_layers=num_layers, num_heads=4, mlp_ratio=2.0,
            dtype=torch.float32, quantize=quantize,
        )
        model = VJEPA2Backbone(cfg, device=device)
        if state_dict is None:
            model.init_random(torch.Generator(device=device).manual_seed(seed))
        else:
            model.load_state_dict(state_dict)
        if quantize and quant_static:
            model = _calibrated_static_model(model, n_frames, crop_size)
        super().__init__(model, n_frames=n_frames, crop_size=crop_size, device=device)


def load_video_backbone(
    state_dict: tp.Mapping[str, tp.Any],
    hf_config: tp.Mapping[str, tp.Any],
    quantize: bool = False,
    quant_static: bool = False,
    sequence_parallel: int = 0,
    device: str | torch.device | None = None,
) -> TorchVideoBackbone:
    """A V-JEPA2 encoder from an HF checkpoint's state dict and config dict
    (``config.json`` keys: crop_size, patch_size, tubelet_size,
    frames_per_clip, hidden_size, num_hidden_layers, num_attention_heads,
    mlp_ratio), token-pooled, bf16."""
    if sequence_parallel > 1:
        raise NotImplementedError(_NOT_PORTED_SP)
    device = default_device(device)
    c = hf_config
    cfg = VJEPA2Config(
        crop_size=c["crop_size"], patch_size=c["patch_size"], tubelet_size=c["tubelet_size"],
        frames_per_clip=c["frames_per_clip"], hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
        mlp_ratio=c["mlp_ratio"], dtype=torch.bfloat16, quantize=quantize,
    )
    model = VJEPA2Backbone(cfg, token_pool=True, device=device)
    model.load_state_dict(params_from_hf(state_dict, cfg))
    if quantize and quant_static:
        model = _calibrated_static_model(model, cfg.frames_per_clip, cfg.crop_size)
    return TorchVideoBackbone(model, n_frames=cfg.frames_per_clip, crop_size=cfg.crop_size,
                              device=device)


def encode_window_stream(
    backbone: VideoBackbone, windows: tp.Iterable[np.ndarray], window_batch: int
) -> np.ndarray:
    """Encode a stream of (n_frames, H, W, 3) windows in order -> (L+1, D, T) float32.

    Windows go to the backbone ``window_batch`` at a time; the last batch
    is padded to full width by repeating its last window, and the extra
    outputs are dropped (one compiled batch shape in the JAX package)."""
    outputs, batch = [], []
    for window in windows:
        batch.append(window)
        if len(batch) == window_batch:
            outputs.append(backbone.encode_windows(np.stack(batch)))
            batch = []
    if batch:
        n = len(batch)
        batch += [batch[-1]] * (window_batch - n)
        outputs.append(backbone.encode_windows(np.stack(batch))[:n])
    stacked = np.concatenate(outputs, axis=0)  # (T, L+1, D)
    return np.transpose(stacked, (1, 2, 0)).astype(np.float32)
