"""Coordinate grids (CoordConv channels, voxel-centre coordinates).

Counterpart of ``neural_marionette_tpu/ops/coords.py``. The maps are built
from the same float32 ``np.linspace`` as the JAX package, so coordinates
agree to the bit. Public functions keep the channels-last layout;
:func:`add_coord_channels_first` serves the models' NCDHW convolutions.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def coord_maps_np(spatial: tuple[int, ...]) -> np.ndarray:
    """(*spatial, D) float32 meshgrid of per-axis linspace(-1, 1)."""
    grids = [np.linspace(-1.0, 1.0, n, dtype=np.float32) for n in spatial]
    mesh = np.meshgrid(*grids, indexing="ij")
    out = np.stack(mesh, axis=-1)
    out.flags.writeable = False  # cached and shared by every caller
    return out


@functools.lru_cache(maxsize=32)
def _coord_maps(spatial: tuple[int, ...], dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    # made once per device: a copy from host memory on every call would
    # make the host wait for all the work queued on the card before it
    with torch.inference_mode(False):
        return torch.tensor(coord_maps_np(spatial), dtype=dtype,
                            device=device)


def coord_maps(spatial, dtype=torch.float32, device=None) -> torch.Tensor:
    """(*spatial, D) meshgrid of per-axis linspace(-1, 1) coordinates.
    Cached and shared by every caller: read it, never write it."""
    return _coord_maps(tuple(int(s) for s in spatial), dtype,
                       torch.device(device or "cpu"))


def add_coord_channels(x: torch.Tensor) -> torch.Tensor:
    """``(B, X1..XD, C)`` -> ``(B, X1..XD, C + D)``, channels-last."""
    maps = coord_maps(x.shape[1:-1], x.dtype, x.device)
    maps = maps.expand((x.shape[0],) + maps.shape)
    return torch.cat([x, maps], dim=-1)


def add_coord_channels_first(x: torch.Tensor) -> torch.Tensor:
    """``(B, C, X1..XD)`` -> ``(B, C + D, X1..XD)``, channels-first."""
    maps = coord_maps(x.shape[2:], x.dtype, x.device)
    maps = torch.movedim(maps, -1, 0)
    maps = maps.expand((x.shape[0],) + maps.shape)
    return torch.cat([x, maps], dim=1)
