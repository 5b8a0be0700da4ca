"""Models of the port: the FmriEncoder trunk, its pieces and the frozen backbones."""

from .common import LayerScale, Mean, Mlp, MlpConfig, SubjectLayers
from .convert import (
    flax_params_to_torch,
    fmri_mlp_params_to_torch,
    llama_params_to_torch,
    vjepa2_params_to_torch,
    wav2vec_bert_params_to_torch,
)
from .fmri_encoder import FmriEncoder, FmriEncoderConfig
from .fmri_mlp import FmriMlp, FmriMlpConfig
from .transformer import ScaleNorm, TransformerEncoder, TransformerEncoderConfig

__all__ = [
    "FmriEncoder",
    "FmriEncoderConfig",
    "FmriMlp",
    "FmriMlpConfig",
    "LayerScale",
    "Mean",
    "Mlp",
    "MlpConfig",
    "ScaleNorm",
    "SubjectLayers",
    "TransformerEncoder",
    "TransformerEncoderConfig",
    "flax_params_to_torch",
    "fmri_mlp_params_to_torch",
    "llama_params_to_torch",
    "vjepa2_params_to_torch",
    "wav2vec_bert_params_to_torch",
]
