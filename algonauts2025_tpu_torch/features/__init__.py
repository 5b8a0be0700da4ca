"""Features of the port: the pydantic features (host side, cached per item)
and the frozen backbones' device sides."""

from .audio import (
    TinyAudioBackbone,
    TorchAudioBackbone,
    Wav2VecBert,
    encode_sound_stream,
    load_audio_backbone,
    mono_zscore,
)
from .base import FeatureBase, LayeredFeatureBase
from .neuro import Fmri
from .subject import SubjectEncoder
from .text import (
    LLAMA3p2,
    HashTokenizer,
    TinyTextBackbone,
    TorchTextBackbone,
    encode_word_stream,
    load_text_backbone,
)
from .video import (
    VJEPA2,
    TinyVideoBackbone,
    TorchVideoBackbone,
    VideoBackbone,
    encode_window_stream,
    load_video_backbone,
)

__all__ = [
    "FeatureBase",
    "LayeredFeatureBase",
    "Fmri",
    "SubjectEncoder",
    "LLAMA3p2",
    "Wav2VecBert",
    "VJEPA2",
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
