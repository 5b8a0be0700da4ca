"""Video preprocessing: resize, centre crop, normalize (plain torch ops).

The port of algonauts2025_tpu/ops/video_prep.py, which replicates the HF
VJEPA2VideoProcessor (torchvision v2 resize): shortest edge to
``int(crop * 256 / 224)``, long edge TRUNCATED (``int(resize * long /
short)``), antialiased bilinear, centre crop with Python's banker's
rounding of the offset, 1/255 rescale, ImageNet mean/std.  The JAX
package resizes with ``jax.image.resize(..., antialias=True)``; here
``F.interpolate(mode="bilinear", antialias=True)`` does, which agrees with
it to about 5e-3 on the 0-255 scale (1e-4 after normalization).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "preprocess_frames", "resized_size"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resized_size(h: int, w: int, crop_size: int) -> tuple[int, int]:
    """torchvision's shortest-edge size: short -> resize exactly, long truncated."""
    resize = int(crop_size * 256 / 224)
    if h <= w:
        return resize, int(resize * w / h)
    return int(resize * h / w), resize


def preprocess_frames(
    frames: torch.Tensor | np.ndarray, crop_size: int = 256
) -> torch.Tensor:
    """(..., T, H, W, 3) uint8 -> (..., T, crop, crop, 3) float32 normalized.

    Leading axes (a batch of windows) are flattened into one resize call,
    as the JAX package's ``jax.vmap`` over windows."""
    frames = torch.as_tensor(frames)
    *lead, h, w, c = frames.shape
    new_h, new_w = resized_size(h, w, crop_size)
    x = frames.reshape(-1, h, w, c).permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(new_h, new_w), mode="bilinear", antialias=True,
                      align_corners=False)
    # torchvision center_crop: int(round(diff / 2.0)), banker's rounding
    top = int(round((new_h - crop_size) / 2.0))
    left = int(round((new_w - crop_size) / 2.0))
    x = x[:, :, top : top + crop_size, left : left + crop_size]
    x = x.permute(0, 2, 3, 1) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).reshape(*lead, crop_size, crop_size, c)
