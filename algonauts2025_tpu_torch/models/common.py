"""Shared model building blocks (torch.nn): the per-subject readout."""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["SubjectLayers"]


class SubjectLayers(nn.Module):
    """Per-subject linear map: x (B, C, T), subjects (B,) -> (B, D, T).

    Weight (S, C, D) and bias (S, D) init ~ N(0, 1/C); with no subjects
    (or ``average_subjects``) every element uses the mean weight."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        n_subjects: int,
        use_bias: bool = True,
        init_id: bool = False,
        average_subjects: bool = False,
        device=None,
    ) -> None:
        super().__init__()
        if init_id and in_channels != out_channels:
            raise ValueError("init_id requires in_channels == out_channels")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.init_id, self.average_subjects = init_id, average_subjects
        self.weights = nn.Parameter(
            torch.empty(n_subjects, in_channels, out_channels, device=device)
        )
        self.bias = (
            nn.Parameter(torch.empty(n_subjects, out_channels, device=device))
            if use_bias
            else None
        )

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        scale = 1.0 / self.in_channels**0.5
        with torch.no_grad():
            if self.init_id:
                eye = torch.eye(self.in_channels, device=self.weights.device)
                self.weights.copy_(eye.expand_as(self.weights) * scale)
                if self.bias is not None:
                    self.bias.zero_()
                return
            self.weights.normal_(generator=generator).mul_(scale)
            if self.bias is not None:
                self.bias.normal_(generator=generator).mul_(scale)

    def forward(self, x: torch.Tensor, subjects: torch.Tensor | None) -> torch.Tensor:
        x32 = x.float()
        if self.average_subjects or subjects is None:
            out = torch.einsum("bct,cd->bdt", x32, self.weights.mean(dim=0))
            b = None if self.bias is None else self.bias.mean(dim=0)[None, :, None]
        else:
            subjects = subjects.reshape(-1)
            w = self.weights[subjects]  # (B, C, D)
            out = torch.einsum("bct,bcd->bdt", x32, w)
            b = None if self.bias is None else self.bias[subjects][:, :, None]
        if b is not None:
            out = out + b
        return out.to(x.dtype)
