"""The port's video feature path (features/video.py, ops/threefry.py,
ops/layer_agg.py) against the JAX package's, on the CPU."""

import jax
import numpy as np
import pytest
import torch

from algonauts2025_tpu.features import video as jvideo
from algonauts2025_tpu.ops import layer_agg as jagg
from algonauts2025_tpu_torch.features import video as tvideo
from algonauts2025_tpu_torch.models import vjepa2_params_to_torch
from algonauts2025_tpu_torch.ops import layer_agg as tagg
from algonauts2025_tpu_torch.ops import threefry


@pytest.mark.parametrize("shape", [(1,), (3, 7), (1, 8, 32, 32, 3)])
def test_threefry_normal_matches_jax(shape):
    """The calibration input: bits, uniforms and normals all bit-equal."""
    got = threefry.normal(7, shape)
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(7), shape))
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("lo,hi", [(1e-6, 0.6), (1e-30, 1e30)])
def test_log_matches_jax_bit_for_bit(lo, hi):
    """XLA's CPU float32 log on 1M seeded arguments: the range the erf_inv's
    log1p feeds it, and thirty decades either side of 1."""
    rng = np.random.default_rng(11)
    x = np.exp(rng.uniform(np.log(lo), np.log(hi), 1_000_000)).astype(np.float32)
    ref = np.asarray(jax.numpy.log(x))
    np.testing.assert_array_equal(threefry.log(x).view(np.int32), ref.view(np.int32))


def test_threefry_bits_match_jax():
    counts = np.arange(1000, dtype=np.uint32)
    b1, b2 = threefry.threefry2x32(0, 7, np.zeros_like(counts), counts)
    ref = jax.random.bits(jax.random.PRNGKey(7), (1000,), np.uint32)
    np.testing.assert_array_equal(b1 ^ b2, np.asarray(ref))


def _jax_compute_loop(backbone, windows, window_batch):
    """The batching loop of the JAX VJEPA2._compute (features/video.py)."""
    outputs, batch = [], []
    for window in windows:
        batch.append(window)
        if len(batch) == window_batch:
            outputs.append(backbone.encode_windows(np.stack(batch))[: len(batch)])
            batch = []
    if batch:
        n = len(batch)
        while len(batch) < window_batch:
            batch.append(batch[-1])
        outputs.append(backbone.encode_windows(np.stack(batch))[:n])
    return np.transpose(np.concatenate(outputs, axis=0), (1, 2, 0)).astype(np.float32)


@pytest.mark.parametrize("quantize,quant_static", [(False, False), (True, True)])
def test_window_stream_matches_jax(quantize, quant_static):
    """5 windows in batches of 2 (the last one padded) through the tiny
    backbone: the port's encode_window_stream against the JAX
    TinyVideoBackbone and the _compute loop, from the same weights.  The
    static-scale pair calibrates itself on each side (the port on its
    NumPy rebuild of the JAX normals)."""
    windows = list(np.random.default_rng(3).integers(0, 256, (5, 8, 40, 60, 3), dtype=np.uint8))
    uncalibrated = jvideo.TinyVideoBackbone(quantize=quantize)
    ref_bb = jvideo.TinyVideoBackbone(quantize=quantize, quant_static=quant_static)
    ref = _jax_compute_loop(ref_bb, windows, 2)
    port_bb = tvideo.TinyVideoBackbone(
        quantize=quantize, quant_static=quant_static,
        state_dict=vjepa2_params_to_torch(uncalibrated.params), device="cpu",
    )
    got = tvideo.encode_window_stream(port_bb, windows, window_batch=2)
    assert got.shape == ref.shape == (3, 64, 5) and got.dtype == np.float32
    if quant_static:
        want = {k: v for k, v in vjepa2_params_to_torch(ref_bb.params).items() if k.endswith("a_scale")}
        for key, value in port_bb.model.state_dict().items():
            if key.endswith("a_scale"):
                np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=1e-5, err_msg=key)
    # the backbone's tolerance (tests/test_backbones.py); the two resizes
    # differ by ~1e-4 in normalized units, well inside it
    np.testing.assert_allclose(got, ref, atol=3e-4, rtol=1e-3)


def test_window_stream_order_and_padding():
    """Batches of window_batch, the last padded and cut back, order kept."""

    class Recorder(tvideo.VideoBackbone):
        def __init__(self):
            self.batches = []

        def encode_windows(self, windows):
            self.batches.append(len(windows))
            return windows[:, :1, :2, 0, 0].astype(np.float32)  # (B, 1, 2)

    windows = [np.full((1, 2, 1, 3), i, np.uint8) for i in range(5)]
    rec = Recorder()
    out = tvideo.encode_window_stream(rec, windows, window_batch=2)
    assert rec.batches == [2, 2, 2] and out.shape == (1, 2, 5)
    np.testing.assert_array_equal(out[0, 0], np.arange(5))


@pytest.mark.parametrize("layers,agg", [
    ([0.5, 0.75, 1.0], "group_mean"), ([0.5, 0.75, 1.0], None), ([1.0], "group_mean"),
    ([1.0], None), ([0.0, 0.3, 0.6, 1.0], "group_mean"),
])
def test_aggregate_layers_matches_jax(rng, layers, agg):
    latents = rng.standard_normal((41, 8, 5)).astype(np.float32)
    assert tagg.layer_indices(41, layers) == jagg.layer_indices(41, layers)
    got = tagg.aggregate_layers(latents, layers, agg)
    np.testing.assert_array_equal(got, jagg.aggregate_layers(latents, layers, agg))
    with pytest.raises(ValueError, match="Unknown"):
        tagg.aggregate_layers(latents, [0.5, 1.0], "max")


def test_uncalibrated_static_backbone_is_refused():
    bb = tvideo.TinyVideoBackbone(quantize=True, device="cpu")
    bb.model.set_quant_static()  # a_scale still 0
    with pytest.raises(ValueError, match="uncalibrated"):
        tvideo.TorchVideoBackbone(bb.model, n_frames=8, crop_size=32, device="cpu")


def test_sequence_parallel_is_not_ported():
    bb = tvideo.TinyVideoBackbone(device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        tvideo.TorchVideoBackbone(bb.model, sequence_parallel=True, device="cpu")


def test_load_video_backbone_from_hf_state_dict(rng):
    """An HF-named state dict + config.json dict -> a token-pooled bf16
    static-int8 backbone, calibrated, on the CPU."""
    from test_torch_vjepa2 import _hf_state_dict

    cfg = dict(crop_size=32, patch_size=16, tubelet_size=2, frames_per_clip=4, hidden_size=48,
               num_hidden_layers=2, num_attention_heads=4, mlp_ratio=2.0)
    bb = tvideo.load_video_backbone(_hf_state_dict(rng), cfg, quantize=True, quant_static=True,
                                    device="cpu")
    assert bb.model.token_pool and bb.model.cfg.quant_static and bb.n_frames == 4
    out = bb.encode_windows(rng.integers(0, 256, (2, 4, 40, 60, 3), dtype=np.uint8))
    assert out.shape == (2, 3, 48) and np.isfinite(out).all()


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card the video entry points raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvideo.TinyVideoBackbone()
