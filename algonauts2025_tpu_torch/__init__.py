"""PyTorch/CUDA port of algonauts2025_tpu (the trunk training and video feature slices).

Mirrors the JAX package's layout (ops/, models/, features/, training/) and imports
nothing of it.  See README.md, section "PyTorch/CUDA port".
"""

from . import runtime
from .runtime import default_device

__all__ = ["default_device", "runtime"]
