"""Keypoint ops: spatial soft-argmax and separable Gaussian rendering.

Counterpart of ``neural_marionette_tpu/ops/keypoints.py``. Public functions
keep the channels-last heatmap layout ``(B, G1..GD, K)``; the ``_first``
variants take and give ``(B, K, G1..GD)`` for the NCDHW models.
"""
from __future__ import annotations

import torch


def extract_keypoints_from_heatmap_first(heatmap: torch.Tensor) -> torch.Tensor:
    """Spatial soft-argmax. ``(B, K, G1..GD)`` -> ``(B, K, D+1)``.

    Intensity is the spatial mean normalised by the per-batch max over K
    (+1e-6); per-axis weights are sums of ``heatmap + 1e-6`` over the other
    axes, normalised, then expectation weights over ``linspace(-1, 1)``."""
    spatial = heatmap.shape[2:]
    D = len(spatial)
    spatial_axes = tuple(range(2, 2 + D))

    intensity = heatmap.mean(dim=spatial_axes)  # (B, K)
    intensity = intensity / (intensity.amax(dim=-1, keepdim=True) + 1e-6)

    coords = []
    for d, Gd in enumerate(spatial):
        other = tuple(a for a in spatial_axes if a != d + 2)
        n_other = 1
        for a in other:
            n_other *= heatmap.shape[a]
        weights = heatmap.sum(dim=other) + 1e-6 * n_other  # (B, K, Gd)
        weights = weights / weights.sum(dim=-1, keepdim=True)
        grid = torch.linspace(-1.0, 1.0, Gd, dtype=heatmap.dtype,
                              device=heatmap.device)
        coords.append(torch.einsum("bkg,g->bk", weights, grid))
    coords = torch.stack(coords, dim=-1)  # (B, K, D)
    return torch.cat([coords, intensity[..., None]], dim=-1)


def extract_keypoints_from_heatmap(heatmap: torch.Tensor) -> torch.Tensor:
    """``(B, G1..GD, K)`` -> ``(B, K, D+1)``."""
    return extract_keypoints_from_heatmap_first(torch.movedim(heatmap, -1, 1))


def render_gaussian_maps_first(keypoints: torch.Tensor, sigma,
                               G: int) -> torch.Tensor:
    """``(..., K, D+1)`` -> ``(..., K, G1..GD)``: axis-aligned Gaussian blobs
    ``exp(-(x-c)^2 / (2 (sigma/G)^2))``, separable, scaled by intensity.
    ``sigma``: scalar or ``(K,)`` per-keypoint widths."""
    coords = keypoints[..., :-1]          # (..., K, D)
    intensities = keypoints[..., -1]      # (..., K)
    D = coords.shape[-1]
    sigma = torch.as_tensor(sigma, dtype=keypoints.dtype,
                            device=keypoints.device)
    width = 2.0 * (sigma / G) ** 2.0
    if width.ndim == 0:
        width = width.expand(coords.shape[-2])  # (K,)

    grid = torch.linspace(-1.0, 1.0, G, dtype=keypoints.dtype,
                          device=keypoints.device)
    axis_maps = torch.exp(
        -((grid - coords[..., None]) ** 2) / width[:, None, None])

    out = axis_maps[..., 0, :]
    for d in range(1, D):
        out = out[..., None] * axis_maps[..., d, :].reshape(
            axis_maps.shape[:-2] + (1,) * d + (G,))
    return out * intensities.reshape(intensities.shape + (1,) * D)


def render_gaussian_maps(keypoints: torch.Tensor, sigma, G: int) -> torch.Tensor:
    """``(..., K, D+1)`` -> ``(..., G1..GD, K)``, channels-last."""
    out = render_gaussian_maps_first(keypoints, sigma, G)
    D = keypoints.shape[-1] - 1
    return torch.movedim(out, out.ndim - 1 - D, -1)
