"""Motion interpolation demo (reference vis_interpolation.py).

Counterpart of ``neural_marionette_tpu/apps/interpolation.py``: detect
keypoints over a clip, keep every ``anchor_rate``-th frame (and the last)
as an anchor, and fill the in-between frames with the prior rollout,
among ``sample_num``, selected to land near the next anchor; the renders
are the port's ``viz``, on the card.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..api import Marionette
from ..models import SkeletonArrays
from ..viz.visualize import vis_keypoints, vis_recon
from .common import detect_and_extract_skeleton
from .generation import render_generation


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


def save_outputs(result: dict, out_dir: str, vox_clip=None,
                 device=None) -> dict:
    """The interpolation output inventory of the JAX ``save_outputs``: the
    ``.npy`` exports, the surfel renders under the ``interp_result``
    prefix (``generation.render_generation``, no conditioning frames), the
    keypoint video with the skeleton's adjacency
    (``gifs/0/interpolation_keypoints_0.gif``) and, given the clip
    ``vox_clip`` (T, G, G, G, 1), the recon video against it. The renders
    run on ``device`` (``cuda`` unless the caller asks for the CPU).
    Returns the host ms of each part."""
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "interp_voxels.npy"),
            result["interp_voxels"])
    np.save(os.path.join(out_dir, "keypoints.npy"), result["keypoints"])
    iv = result["interp_voxels"][None]
    stats = {"render_generation": render_generation(
        iv, out_dir, Tcond=0, prefix="interp_result", device=device)}
    t0 = time.perf_counter()
    vis_keypoints(iv, result["keypoints"][None], logger_path=out_dir,
                  nepoch=0, affinity=result["skeleton"].A, log_num=1,
                  group="interpolation", mode="A", device=device)
    stats["vis_keypoints_ms"] = (time.perf_counter() - t0) * 1e3
    if vox_clip is not None:
        t0 = time.perf_counter()
        vis_recon(vox_clip[None], iv, logger_path=out_dir, nepoch=0,
                  log_num=1, group="interpolation", device=device)
        stats["vis_recon_ms"] = (time.perf_counter() - t0) * 1e3
    return stats
