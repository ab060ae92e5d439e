"""6D -> 3x3 rotation (Gram-Schmidt).

Counterpart of ``neural_marionette_tpu/ops/rotations.py``.
"""
from __future__ import annotations

import torch


def rotation_6d_to_matrix(param: torch.Tensor) -> torch.Tensor:
    """``(..., 6)`` -> ``(..., 3, 3)``.

    x = normalize(a); z = normalize(x × b); y = z × x; R = [x | y | z]
    (columns), with the reference's 1e-10 norm guard."""
    a = param[..., 0:3]
    b = param[..., 3:6]

    def _normalize(v):
        mag = torch.sqrt((v * v).sum(dim=-1, keepdim=True) + 1e-20) + 1e-10
        return v / mag

    x = _normalize(a)
    z = _normalize(torch.linalg.cross(x, b, dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)  # columns
