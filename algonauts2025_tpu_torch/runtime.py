"""Device choice for the port's entry points, and the fp32 contract.

Entry points run on the CUDA card unless the caller names another device;
nothing quietly falls back to the CPU.  TF32 is off for matmuls and cuDNN
because fp32 is the numerical contract the port is held to.
"""

from __future__ import annotations

import torch

__all__ = ["default_device"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card, and raises
    when there is none (pass ``device="cpu"`` to run on the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
