"""Frozen-feature extraction of the port (device side)."""

from .video import (
    TinyVideoBackbone,
    TorchVideoBackbone,
    VideoBackbone,
    encode_window_stream,
    load_video_backbone,
)

__all__ = [
    "TinyVideoBackbone",
    "TorchVideoBackbone",
    "VideoBackbone",
    "encode_window_stream",
    "load_video_backbone",
]
