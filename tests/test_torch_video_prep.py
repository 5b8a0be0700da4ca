"""The port's video preprocessing (ops/video_prep.py) against the JAX package's.

The JAX package resizes with jax.image.resize(antialias=True), the port
with F.interpolate(antialias=True); the two differ by < 5e-3 on the 0-255
scale, about 1e-4 after /255/std.
"""

import numpy as np
import pytest
import torch

from algonauts2025_tpu.ops.video_prep import IMAGENET_MEAN, IMAGENET_STD
from algonauts2025_tpu.ops.video_prep import preprocess_frames as jax_prep
from algonauts2025_tpu_torch.ops import video_prep as tp_


@pytest.mark.parametrize("h,w,crop", [
    (288, 512, 256),  # landscape, the Algonauts movies' aspect
    (512, 288, 256),  # portrait
    (240, 427, 256),  # odd resize difference: banker's-rounded crop offset
    (40, 70, 32),     # the tiny backbone's crop
])
def test_preprocess_matches_jax(rng, h, w, crop):
    frames = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    ref = np.asarray(jax_prep(frames, crop))
    got = tp_.preprocess_frames(torch.from_numpy(frames), crop)
    assert got.dtype == torch.float32 and got.shape == (2, crop, crop, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_preprocess_batches_windows(rng):
    """A (B, T, H, W, 3) batch of windows is B independent windows."""
    frames = rng.integers(0, 256, (3, 2, 40, 70, 3), dtype=np.uint8)
    got = tp_.preprocess_frames(frames, 32)
    assert got.shape == (3, 2, 32, 32, 3)
    for i in range(3):
        torch.testing.assert_close(got[i], tp_.preprocess_frames(frames[i], 32))


def test_constants_and_sizes_match_jax():
    assert tp_.IMAGENET_MEAN == IMAGENET_MEAN and tp_.IMAGENET_STD == IMAGENET_STD
    assert tp_.resized_size(288, 512, 256) == (292, 519)
    assert tp_.resized_size(512, 288, 256) == (519, 292)
