"""PyTorch/CUDA port of algonauts2025_tpu: trunk training and the video, text and audio feature paths.

Mirrors the JAX package's layout (ops/, models/, features/, training/) and imports
nothing of it.  See README.md, section "PyTorch/CUDA port".
"""

from . import runtime
from .runtime import default_device

__all__ = ["default_device", "runtime"]
