"""Frozen-feature extraction of the port (device side)."""

from .text import (
    HashTokenizer,
    TinyTextBackbone,
    TorchTextBackbone,
    encode_word_stream,
    load_text_backbone,
)
from .video import (
    TinyVideoBackbone,
    TorchVideoBackbone,
    VideoBackbone,
    encode_window_stream,
    load_video_backbone,
)

__all__ = [
    "HashTokenizer",
    "TinyTextBackbone",
    "TorchTextBackbone",
    "encode_word_stream",
    "load_text_backbone",
    "TinyVideoBackbone",
    "TorchVideoBackbone",
    "VideoBackbone",
    "encode_window_stream",
    "load_video_backbone",
]
