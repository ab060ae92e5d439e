"""Motion generation demo (reference vis_generation.py).

Counterpart of ``neural_marionette_tpu/apps/generation.py``: condition on
the first ``Tcond`` frames of a clip, collapse to the best posterior latent
per step, then roll ``sample_num`` independent prior trajectories forward
and decode each back to voxels. The renders come with the port's ``viz``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..api import Marionette
from ..models import SkeletonArrays
from .common import detect_and_extract_skeleton


def run_generation(m: Marionette, vox_clip: np.ndarray, Tcond: int = 5,
                   Tgen: int = 25, sample_num: int = 3, seed: int = 2,
                   threshold: float = 0.5, eps=None) -> dict:
    """``vox_clip`` (>= Tcond, G, G, G, 1), of which the first ``Tcond``
    frames condition. The rollout's noise is drawn from ``seed`` on the
    marionette's device, or given as ``eps`` (``HSVRNNBVH.generate_many``).

    Returns generated voxels (sample_num, Tcond+Tgen, G, G, G, 1)
    thresholded to {0, 1}, their keypoints (sample_num, Tcond+Tgen, K, 4),
    the conditioning keypoints (Tcond, K, 4) and the skeleton."""
    model = m.model
    det, skeleton = detect_and_extract_skeleton(m, vox_clip[:Tcond])
    sk = SkeletonArrays.from_skeleton(skeleton, m.device)
    gen = torch.Generator(m.device).manual_seed(seed)
    first_frame = m.clip_tensor(vox_clip[:1])[:, 0]
    vox_out, kp_out = [], []
    with torch.inference_mode():
        cond_kp, gen_kp = model.dyna_module.generate_many(
            det["keypoints"], sk, Ttot=Tcond + Tgen, Tcond=Tcond,
            sample_num=sample_num, eps=eps, generator=gen)
        for s in range(sample_num):
            full_kp = torch.cat([cond_kp, gen_kp[s:s + 1]], dim=1)
            dec = model.kypt_detector.decode_from_dyna(
                full_kp, det["first_feature"], first_frame)
            vox = dec["gen"][0].float().cpu().numpy()
            vox_out.append((vox >= threshold).astype(np.float32))
            kp_out.append(full_kp[0].cpu().numpy())
    return dict(gen_voxels=np.stack(vox_out), keypoints=np.stack(kp_out),
                skeleton=skeleton, cond_keypoints=cond_kp[0].cpu().numpy())


def save_outputs(result: dict, out_dir: str) -> None:
    """The ``.npy`` exports: generated voxels, keypoints, parents."""
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "gen_voxels.npy"), result["gen_voxels"])
    np.save(os.path.join(out_dir, "keypoints.npy"), result["keypoints"])
    np.save(os.path.join(out_dir, "parents.npy"),
            result["skeleton"].parents)
