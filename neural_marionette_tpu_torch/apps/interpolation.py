"""Motion interpolation demo (reference vis_interpolation.py).

Counterpart of ``neural_marionette_tpu/apps/interpolation.py``: detect
keypoints over a clip, keep every ``anchor_rate``-th frame (and the last)
as an anchor, and fill the in-between frames with the prior rollout,
among ``sample_num``, selected to land near the next anchor. The renders
come with the port's ``viz``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..api import Marionette
from ..models import SkeletonArrays
from .common import detect_and_extract_skeleton


def run_interpolation(m: Marionette, vox_clip: np.ndarray,
                      anchor_rate: int = 10, sample_num: int = 10000,
                      seed: int = 2, threshold: float = 0.5,
                      eps=None) -> dict:
    """``vox_clip`` (T, G, G, G, 1). ``sample_num`` defaults to the
    reference's 10000 prior trajectories (vis_interpolation.py:54). The
    noise is drawn from ``seed`` on the marionette's device, or given as
    ``eps`` (``HSVRNNBVH.interpolate``).

    Returns the interpolated voxels (T, G, G, G, 1) thresholded to {0, 1},
    the selected keypoints (T, K, 4), the detected ones and the
    skeleton."""
    model = m.model
    det, skeleton = detect_and_extract_skeleton(m, vox_clip)
    sk = SkeletonArrays.from_skeleton(skeleton, m.device)
    gen = torch.Generator(m.device).manual_seed(seed)
    with torch.inference_mode():
        selected = model.dyna_module.interpolate(
            det["keypoints"], sk, anchor_rate=anchor_rate,
            sample_num=sample_num, eps=eps, generator=gen)
        dec = model.kypt_detector.decode_from_dyna(
            selected, det["first_feature"], m.clip_tensor(vox_clip[:1])[:, 0])
        vox = dec["gen"][0].float().cpu().numpy()
    return dict(interp_voxels=(vox >= threshold).astype(np.float32),
                keypoints=selected[0].cpu().numpy(),
                detected_keypoints=det["keypoints"][0].cpu().numpy(),
                skeleton=skeleton)


def save_outputs(result: dict, out_dir: str) -> None:
    """The ``.npy`` exports: interpolated voxels and keypoints."""
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "interp_voxels.npy"),
            result["interp_voxels"])
    np.save(os.path.join(out_dir, "keypoints.npy"), result["keypoints"])
