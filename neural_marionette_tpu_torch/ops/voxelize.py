"""Point cloud -> binary occupancy grid; carries kernel K1.

Counterpart of ``neural_marionette_tpu/ops/voxelize.py`` and of the Pallas
voxelizer ``ops/pallas/voxelize_kernel.py``.

* :func:`voxelize_np` — host path (NumPy), the JAX package's semantics:
  truncating int cast and an index clip.
* :func:`voxelize` — device path with the semantics of ``voxelize_jnp`` /
  ``voxelize_pallas``: true division by ``2/G + 1e-5``, floor, and a point
  is dropped when ANY axis is out of range; duplicates give 1. A CUDA
  tensor goes to the kernel ``csrc/voxelize.cu`` (one launch that writes
  every element of a ``torch.empty`` output), a CPU tensor to
  :func:`voxelize_plain`.

Output is channels-last: ``(..., G, G, G, 1)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import kernels

launches = 0  # kernel launches of :func:`voxelize`
_fn = None  # the kernel's C entry point, loaded on first use
_steps: dict = {}  # G -> the float32 step, as the C float it is passed as


def _grid_params(grid_size: int):
    bmin = -1.0
    step = 2.0 / grid_size + 1e-5  # reference: (bbox_len / shape) + 1e-5
    return bmin, step


def voxelize_np(points: np.ndarray, grid_size: int) -> np.ndarray:
    """``(N, 3)`` float points in [-1, 1] -> ``(G, G, G, 1)`` float32 grid."""
    bmin, step = _grid_params(grid_size)
    idx = ((points[..., :3] - bmin) / step).astype(np.int32)
    idx = np.clip(idx, 0, grid_size - 1)
    grid = np.zeros((grid_size,) * 3 + (1,), dtype=np.float32)
    grid[idx[:, 0], idx[:, 1], idx[:, 2], 0] = 1.0
    return grid


def _check_points(points: torch.Tensor):
    if points.dtype != torch.float32:
        raise TypeError(f"voxelize: points must be float32, got {points.dtype}")
    if points.ndim < 2 or points.shape[-1] != 3:
        raise ValueError(f"voxelize: points must be (..., N, 3), got "
                         f"{tuple(points.shape)}")


def voxelize_plain(points: torch.Tensor, grid_size: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``(..., N, 3)`` float32 ->
    ``(..., G, G, G, 1)`` in ``dtype``."""
    _check_points(points)
    G = grid_size
    batch_shape = points.shape[:-2]
    F, N = math.prod(batch_shape), points.shape[-2]
    flat = points.reshape(F, N, 3)
    _, step = _grid_params(G)
    # a device tensor, not a Python scalar: CUDA divides by a host scalar
    # through its reciprocal, which rounds cell-boundary points differently
    step_t = torch.tensor([step], dtype=torch.float32, device=points.device)
    idx = torch.floor((flat + 1.0) / step_t)
    ok = ((idx >= 0) & (idx < G)).all(dim=-1)
    idx = idx.long()
    lin = (torch.arange(F, device=points.device)[:, None] * G ** 3
           + (idx[..., 0] * G + idx[..., 1]) * G + idx[..., 2])
    out = torch.zeros(F * G ** 3, dtype=dtype, device=points.device)
    out[lin[ok]] = 1
    return out.reshape(batch_shape + (G, G, G, 1))


def voxelize(points: torch.Tensor, grid_size: int,
             dtype=torch.float32) -> torch.Tensor:
    """``(..., N, 3)`` float32 points -> ``(..., G, G, G, 1)`` occupancy in
    ``dtype`` (float32 or bfloat16; the compute dtype directly saves a
    cast pass). CUDA tensors run kernel K1, CPU tensors the plain version."""
    if points.device.type == "cpu":
        return voxelize_plain(points, grid_size, dtype)
    _check_dtype(dtype)
    G = grid_size
    out = torch.empty(points.shape[:-2] + (G, G, G, 1), dtype=dtype,
                      device=points.device)
    return _launch(points, G, out)


def _voxelize_into(points: torch.Tensor, grid_size: int,
                   out: torch.Tensor) -> torch.Tensor:
    """Kernel K1 into ``out`` (``(..., G, G, G, 1)``, float32 or bfloat16,
    contiguous, on the points' card): the kernel writes every element, so
    ``out`` may hold anything before the call."""
    G = grid_size
    _check_dtype(out.dtype)
    want = points.shape[:-2] + (G, G, G, 1)
    if out.shape != want or not out.is_contiguous() \
            or out.device != points.device:
        raise ValueError(f"voxelize: out must be a contiguous "
                         f"{tuple(want)} tensor on {points.device}, got "
                         f"{tuple(out.shape)} on {out.device}")
    return _launch(points, G, out)


def _check_dtype(dtype):
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"voxelize: output dtype must be float32 or "
                        f"bfloat16, got {dtype}")


def _launch(points: torch.Tensor, G: int, out: torch.Tensor) -> torch.Tensor:
    """One launch of K1 from ``points`` into ``out`` (checked by the
    caller); the library, its entry point and the step per G are cached."""
    global launches, _fn
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"voxelize: unsupported device {dev}")
    _check_points(points)
    if not points.is_contiguous():
        raise ValueError("voxelize: points must be contiguous")
    step = _steps.get(G)
    if step is None:
        step = _steps[G] = float(np.float32(_grid_params(G)[1]))
    if _fn is None:
        _fn = kernels.library("voxelize").nm_voxelize
    code = _fn(points.data_ptr(), out.data_ptr(),
               out.dtype == torch.bfloat16, out.numel() // G ** 3,
               points.shape[-2], G, step, dev.index,
               torch._C._cuda_getCurrentRawStream(dev.index))
    if code:
        kernels.check(kernels.library("voxelize"), code, "voxelize kernel")
    launches += 1
    return out
