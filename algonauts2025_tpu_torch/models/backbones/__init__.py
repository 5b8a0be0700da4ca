"""Frozen feature backbones of the port."""

from .llama import LLAMA_3P2_3B, LlamaBackbone, LlamaConfig
from .vjepa2 import VJEPA2_VITG, VJEPA2Backbone, VJEPA2Config, params_from_hf
from .wav2vec_bert import W2V_BERT_2_0, Wav2VecBertBackbone, Wav2VecBertConfig

__all__ = ["LLAMA_3P2_3B", "LlamaBackbone", "LlamaConfig",
           "VJEPA2_VITG", "VJEPA2Backbone", "VJEPA2Config", "params_from_hf",
           "W2V_BERT_2_0", "Wav2VecBertBackbone", "Wav2VecBertConfig"]
