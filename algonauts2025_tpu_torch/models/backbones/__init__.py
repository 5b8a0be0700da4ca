"""Frozen feature backbones of the port."""

from .llama import LLAMA_3P2_3B, LlamaBackbone, LlamaConfig
from .vjepa2 import VJEPA2_VITG, VJEPA2Backbone, VJEPA2Config, params_from_hf

__all__ = ["LLAMA_3P2_3B", "LlamaBackbone", "LlamaConfig",
           "VJEPA2_VITG", "VJEPA2Backbone", "VJEPA2Config", "params_from_hf"]
