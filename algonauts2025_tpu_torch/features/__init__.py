"""Frozen-feature extraction of the port (device side)."""

from .audio import (
    TinyAudioBackbone,
    TorchAudioBackbone,
    encode_sound_stream,
    load_audio_backbone,
    mono_zscore,
)
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
    "TinyAudioBackbone",
    "TorchAudioBackbone",
    "encode_sound_stream",
    "load_audio_backbone",
    "mono_zscore",
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
