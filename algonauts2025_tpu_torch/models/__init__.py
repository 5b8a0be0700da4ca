"""Models of the port: the FmriEncoder trunk, its pieces and the frozen backbones."""

from .common import SubjectLayers
from .convert import (
    flax_params_to_torch,
    llama_params_to_torch,
    vjepa2_params_to_torch,
    wav2vec_bert_params_to_torch,
)
from .fmri_encoder import FmriEncoder, FmriEncoderConfig
from .transformer import ScaleNorm, TransformerEncoder, TransformerEncoderConfig

__all__ = [
    "FmriEncoder",
    "FmriEncoderConfig",
    "ScaleNorm",
    "SubjectLayers",
    "TransformerEncoder",
    "TransformerEncoderConfig",
    "flax_params_to_torch",
    "llama_params_to_torch",
    "vjepa2_params_to_torch",
    "wav2vec_bert_params_to_torch",
]
