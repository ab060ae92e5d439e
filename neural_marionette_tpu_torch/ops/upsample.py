"""2x trilinear upsampling, half-pixel (align_corners=False), edges clamped.

Counterpart of ``neural_marionette_tpu/ops/upsample.py``, whose per-axis
interpolation matrices (out[2i] = 0.25 in[i-1] + 0.75 in[i],
out[2i+1] = 0.75 in[i] + 0.25 in[i+1]) are exactly this interpolation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample2_trilinear_first(x: torch.Tensor) -> torch.Tensor:
    """(B, C, X, Y, Z) -> (B, C, 2X, 2Y, 2Z)."""
    return F.interpolate(x, scale_factor=2, mode="trilinear",
                         align_corners=False)


def upsample2_trilinear(x: torch.Tensor) -> torch.Tensor:
    """(B, X, Y, Z, C) -> (B, 2X, 2Y, 2Z, C), channels-last."""
    y = upsample2_trilinear_first(torch.movedim(x, -1, 1))
    return torch.movedim(y, 1, -1)
