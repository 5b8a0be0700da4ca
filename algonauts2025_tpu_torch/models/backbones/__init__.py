"""Frozen feature backbones of the port."""

from .vjepa2 import VJEPA2_VITG, VJEPA2Backbone, VJEPA2Config, params_from_hf

__all__ = ["VJEPA2_VITG", "VJEPA2Backbone", "VJEPA2Config", "params_from_hf"]
