"""V-JEPA2 video features: frame windows -> token-pooled backbone states.

The device side of algonauts2025_tpu/features/video.py: each 2 Hz step
sees the previous 4 s as ``n_frames`` frames; windows are preprocessed and
encoded in batches of ``window_batch`` and the hidden states are
mean-pooled over tokens, giving an (L+1, D, T) stack per video, with two
batches in flight on the device.  ``encode_window_stream`` takes decoded
windows; the pydantic ``VJEPA2`` feature feeds it from ``Video`` events
(io/video.py) and caches per (filepath, offset, duration).

A ``LocalMesh`` (parallel/mesh.py) spreads a backbone over local devices,
as the JAX package spreads it over a mesh: over "data" the window batch
splits over the devices; with ``sequence_parallel`` each window's frames
(hence its tokens) split over the shards and attention runs as one exact
ring over them (parallel/sequence.py).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

from ..core.events import Event, Video
from ..core.timed import Frequency
from ..models.backbones.vjepa2 import VJEPA2Backbone, VJEPA2Config, params_from_hf
from ..ops.quant import calibrate_quant_scales
from ..ops.threefry import normal as jax_normal
from ..ops.video_prep import preprocess_frames
from ..parallel.mesh import LocalMesh, local_mesh
from ..runtime import default_device
from .base import LayeredFeatureBase

__all__ = [
    "VJEPA2",
    "VideoBackbone",
    "TorchVideoBackbone",
    "TinyVideoBackbone",
    "load_video_backbone",
    "load_hf_video_backbone",
    "encode_window_stream",
]

OUTPUT_HZ = 2.0
#: each 2 Hz step sees the previous 4 s of video
WINDOW_SECONDS_BACK = 4.0


class VideoBackbone:
    n_frames: int = 64

    def encode_windows(self, windows: np.ndarray) -> np.ndarray:
        """(B, n_frames, H, W, 3) uint8 -> (B, L+1, D) token-pooled states."""
        raise NotImplementedError

    def encode_windows_async(self, windows: np.ndarray) -> torch.Tensor:
        """``encode_windows`` as a tensor; a device backbone returns before
        its batch is done."""
        return torch.as_tensor(self.encode_windows(windows))


class TorchVideoBackbone(VideoBackbone):
    """Window encoder on ``device`` (the CUDA card unless it says otherwise).

    With ``mesh`` (a ``LocalMesh``) the window batch splits over the mesh's
    devices, each with a copy of the weights; with ``sequence_parallel``
    the frames of every window split over its shards instead (the model is
    rebuilt with ``sequence_parallel_axis`` over the same weights).  The
    values are the one-device path's up to the order of fp sums."""

    def __init__(
        self,
        model: VJEPA2Backbone,
        n_frames: int = 64,
        crop_size: int = 256,
        device: str | torch.device | None = None,
        mesh: LocalMesh | None = None,
        sequence_parallel: bool = False,
    ):
        self.device = default_device(device)
        if sequence_parallel:
            if mesh is None:
                raise ValueError("sequence_parallel=True requires a mesh")
            tubelet = model.cfg.tubelet_size
            if n_frames % (mesh.size * tubelet):
                raise ValueError(
                    f"n_frames={n_frames} must split into {mesh.size} shards "
                    f"of whole tubelets (size {tubelet})"
                )
            sp = VJEPA2Backbone(dataclasses.replace(model.cfg, sequence_parallel_axis=mesh.axis_name),
                                token_pool=model.token_pool, device="meta")
            sp.load_state_dict(model.state_dict(), assign=True)  # the same tensors
            model = sp
        self.model = model.to(self.device).eval()
        self.mesh = mesh
        self.sequence_parallel = sequence_parallel
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
    def encode_windows_async(self, windows: np.ndarray | torch.Tensor) -> torch.Tensor:
        """Enqueue one batch: (B, L+1, D) states left on the device, not
        waited for (the host copy of a numpy batch is pinned, so its upload
        overlaps the batch before it)."""
        frames = torch.as_tensor(windows)
        if self.mesh is not None and not self.sequence_parallel:
            # the window batch over the mesh's devices, each with its copy
            parts = [part for part in frames.tensor_split(self.mesh.size) if len(part)]
            return torch.cat([self._encode(self.model._replica(dev), part, dev).to(self.device)
                              for part, dev in zip(parts, self.mesh.devices)])
        return self._encode(self.model, frames, self.device)

    def _encode(self, model: VJEPA2Backbone, frames: torch.Tensor, device: torch.device) -> torch.Tensor:
        if device.type == "cuda" and frames.device.type == "cpu":
            frames = frames.pin_memory()
        pixels = preprocess_frames(frames.to(device, non_blocking=True), self.crop_size)
        states = model(pixels, mesh=self.mesh) if self.sequence_parallel else model(pixels)
        if states.dim() == 4:  # (L+1, B, N, D) -> token mean
            states = states.mean(dim=2)
        return states.transpose(0, 1)  # (B, L+1, D)

    def encode_windows(self, windows: np.ndarray | torch.Tensor) -> np.ndarray:
        return self.encode_windows_async(windows).cpu().numpy()


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
        mesh: LocalMesh | None = None,
        sequence_parallel: bool = False,
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
        super().__init__(model, n_frames=n_frames, crop_size=crop_size, device=device,
                         mesh=mesh, sequence_parallel=sequence_parallel)


def _sp_mesh(sequence_parallel: int, device: torch.device) -> LocalMesh | None:
    """A ("seq",) mesh of ``sequence_parallel`` shards (None when off): the
    first N cards, raising when fewer are visible, or N shards of the CPU
    (the stand-in for the JAX tests' virtual host devices)."""
    if sequence_parallel <= 1:
        return None
    return local_mesh(sequence_parallel, "seq", "cpu" if device.type == "cpu" else None)


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
    mlp_ratio), token-pooled, bf16.  ``sequence_parallel`` > 1 splits each
    window's tokens over that many devices (``_sp_mesh``)."""
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
    mesh = _sp_mesh(sequence_parallel, device)
    return TorchVideoBackbone(model, n_frames=cfg.frames_per_clip, crop_size=cfg.crop_size,
                              device=device, mesh=mesh, sequence_parallel=mesh is not None)


def load_hf_video_backbone(
    model_name: str,
    quantize: bool = False,
    quant_static: bool = False,
    sequence_parallel: int = 0,
    device: str | torch.device | None = None,
) -> TorchVideoBackbone:
    """The backbone of a named HF V-JEPA2 checkpoint, read from the local HF
    cache only: nothing is downloaded."""
    from transformers import AutoModel

    hf_model = AutoModel.from_pretrained(model_name, local_files_only=True)
    return load_video_backbone(hf_model.state_dict(), hf_model.config.to_dict(),
                               quantize=quantize, quant_static=quant_static,
                               sequence_parallel=sequence_parallel, device=device)


def encode_window_stream(
    backbone: VideoBackbone, windows: tp.Iterable[np.ndarray], window_batch: int
) -> np.ndarray:
    """Encode a stream of (n_frames, H, W, 3) windows in order -> (L+1, D, T) float32.

    Windows go to the backbone ``window_batch`` at a time; the last batch
    is padded to full width by repeating its last window, and the extra
    outputs are dropped (one compiled batch shape in the JAX package).  Two
    batches stay in flight: batch k computes while k+1 uploads and k-1
    comes back."""
    outputs: list[np.ndarray] = []
    pending: list[tuple[torch.Tensor, int]] = []

    def flush(keep: int = 0) -> None:
        while len(pending) > keep:
            states, n = pending.pop(0)
            outputs.append(states[:n].cpu().numpy())

    def submit(batch: list[np.ndarray], n: int) -> None:
        pending.append((backbone.encode_windows_async(np.stack(batch)), n))
        flush(keep=2)

    batch: list[np.ndarray] = []
    for window in windows:
        batch.append(window)
        if len(batch) == window_batch:
            submit(batch, window_batch)
            batch = []
    if batch:
        n = len(batch)
        submit(batch + [batch[-1]] * (window_batch - n), n)
    flush()
    stacked = np.concatenate(outputs, axis=0)  # (T, L+1, D)
    return np.transpose(stacked, (1, 2, 0)).astype(np.float32)


class VJEPA2(LayeredFeatureBase):
    """Token-pooled V-JEPA2 states of each ``Video`` event on the 2 Hz grid
    (the JAX package's config surface and cache uids)."""

    name: tp.Literal["VJEPA2"] = "VJEPA2"
    model_name: str = "facebook/vjepa2-vitg-fpc64-256"
    window_batch: int = 4
    #: w8a8 int8 backbone matmuls; changes feature values, so it is part of
    #: the cache identity (quantized features are their own universe)
    quantize: bool = True
    #: with quantize: activation scales calibrated once on a fixed seeded
    #: input, routed through the fused int8 kernels (kernel rows 6 and 7)
    quant_static: bool = True
    #: >1 splits the 8192-token window sequence over that many devices
    #: (exact ring attention, parallel/sequence.py); device topology, not
    #: semantics: excluded from the cache uid like ``device`` and
    #: ``window_batch``
    sequence_parallel: int = 0

    event_type: tp.ClassVar[str] = "Video"
    frequency: tp.ClassVar[float] = OUTPUT_HZ
    modality: tp.ClassVar[str] = "video"
    latents_span_event: tp.ClassVar[bool] = True
    #: the JAX package's cache-semantics version ("3": quantize and
    #: quant_static default to True), kept so the caches are shared
    _cache_impl_version: tp.ClassVar[str] = "3"

    def _exclude_from_cache_uid(self) -> list[str]:
        return [
            "device", "layers", "layer_aggregation", "window_batch",
            "sequence_parallel",
        ]

    @staticmethod
    def item_uid(event: Event) -> str:
        return f"{event.filepath}_{event.offset:.2f}_{event.duration:.2f}"  # type: ignore[attr-defined]

    def _tiny_backbone(self, device: torch.device) -> VideoBackbone:
        mesh = _sp_mesh(self.sequence_parallel, device)
        return TinyVideoBackbone(quantize=self.quantize, quant_static=self.quant_static,
                                 device=device, mesh=mesh, sequence_parallel=mesh is not None)

    def _named_backbone(self, device: torch.device) -> VideoBackbone:
        return load_hf_video_backbone(self.model_name, quantize=self.quantize,
                                      quant_static=self.quant_static,
                                      sequence_parallel=self.sequence_parallel, device=device)

    def _compute(self, events: tp.Sequence[Video]) -> tp.Iterator[np.ndarray]:
        backbone = self.backbone
        for event in events:
            clip = event.read()
            try:
                expect_frames = max(1, Frequency(OUTPUT_HZ).to_ind(event.duration))
                times = np.linspace(0, clip.duration, expect_frames + 1)[1:]
                windows = clip.sliding_windows(times, backbone.n_frames, WINDOW_SECONDS_BACK)
                latents = encode_window_stream(backbone, windows, self.window_batch)
            finally:
                # a failure mid-event must not leak the decoder
                clip.close()
            yield latents
