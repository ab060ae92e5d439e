"""Motion generation demo (reference vis_generation.py).

Counterpart of ``neural_marionette_tpu/apps/generation.py``: condition on
the first ``Tcond`` frames of a clip, collapse to the best posterior latent
per step, then roll ``sample_num`` independent prior trajectories forward
and decode each back to voxels; the renders are the port's ``viz``, on the
card.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..api import Marionette, resolve_device
from ..models import SkeletonArrays
from ..viz import raster as R
from ..viz.image_files import to_uint8, write_gif, write_png
from ..viz.visualize import vis_keypoints, vis_recon
from .common import detect_and_extract_skeleton

RENDER_DELAY_S = 0.1   # the JAX save_gif's duration=0.1


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


def save_outputs(result: dict, out_dir: str, vox_cond=None, Tcond: int = 5,
                 device=None) -> dict:
    """The generation output inventory of the JAX ``save_outputs``: the
    ``.npy`` exports (generated voxels, keypoints, parents), the surfel
    renders (:func:`render_generation`), the keypoint videos with the
    skeleton's adjacency (``gifs/0/generation_keypoints_<s>.gif``) and,
    given the conditioning frames ``vox_cond`` (Tcond, G, G, G, 1), the
    recon videos against them (``generation_recon_<s>.gif``). The renders
    run on ``device`` (``cuda`` unless the caller asks for the CPU).
    Returns the host ms of each part."""
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "gen_voxels.npy"), result["gen_voxels"])
    np.save(os.path.join(out_dir, "keypoints.npy"), result["keypoints"])
    np.save(os.path.join(out_dir, "parents.npy"),
            result["skeleton"].parents)
    stats = {"render_generation": render_generation(
        result["gen_voxels"], out_dir, Tcond=Tcond, device=device)}
    gv = result["gen_voxels"]
    t0 = time.perf_counter()
    vis_keypoints(gv, result["keypoints"], logger_path=out_dir, nepoch=0,
                  affinity=result["skeleton"].A, log_num=gv.shape[0],
                  group="generation", mode="A", device=device)
    stats["vis_keypoints_ms"] = (time.perf_counter() - t0) * 1e3
    if vox_cond is not None:
        t0 = time.perf_counter()
        ref = np.broadcast_to(
            np.concatenate([vox_cond,
                            np.zeros_like(gv[0][vox_cond.shape[0]:])])[None],
            gv.shape)
        vis_recon(ref, gv, logger_path=out_dir, nepoch=0,
                  log_num=gv.shape[0], group="generation",
                  Tcond=vox_cond.shape[0], device=device)
        stats["vis_recon_ms"] = (time.perf_counter() - t0) * 1e3
    return stats


def render_generation(gen_voxels: np.ndarray, out_dir: str, Tcond: int = 5,
                      prefix: str = "gen_result", device=None) -> dict:
    """Surfel-"plate" renders with estimated normals, the reference's
    generation output inventory (vis_generation.py:155-192), at the
    reference camera (``raster.default_camera()``):
    ``<prefix>_imgs_<s>/%02d.png`` per non-empty frame and
    ``<prefix>_<s>.gif`` per sample (100 ms a frame, an empty frame
    white); conditioning frames blue, generated frames green, shaded by a
    clip-wide height ramp. A sample with no voxel gets its (empty) image
    directory and no GIF, as in the JAX function.

    The normals are estimated on the host (``raster.estimate_normals``);
    each sample's frames are shaded and splatted in one pass on
    ``device``. Returns the host ms of the parts: ``normals_ms`` (host),
    ``render_ms`` (the device pass and the copy of the frames back),
    ``encode_ms`` (PNG and GIF files), and the ``frames`` rendered."""
    dev = resolve_device(device)
    G = gen_voxels.shape[2]
    cam = R.default_camera()
    stats = {"normals_ms": 0.0, "render_ms": 0.0, "encode_ms": 0.0,
             "frames": 0}
    for s in range(gen_voxels.shape[0]):
        img_dir = os.path.join(out_dir, f"{prefix}_imgs_{s}")
        os.makedirs(img_dir, exist_ok=True)
        # clip-wide z ramp (the reference derives it from the clip)
        occ_all = np.stack(np.nonzero(gen_voxels[s, :, ..., 0]), axis=-1)
        if len(occ_all) == 0:
            continue
        t0 = time.perf_counter()
        zs = occ_all[:, 3] / ((G - 1) / 2) - 1
        min_z, z_len = float(zs.min()), float(max(zs.max() - zs.min(),
                                                  1e-6))
        pts, nrm, cols, frame, drawn = [], [], [], [], []
        for t in range(gen_voxels.shape[1]):
            coords = np.stack(np.nonzero(gen_voxels[s, t, ..., 0]),
                              axis=-1) / ((G - 1) / 2) - 1
            if len(coords) == 0:
                continue
            base = np.array([0.6, 0.6, 1.0]) if t < Tcond \
                else np.array([0.6, 1.0, 0.6])
            ramp = (coords[:, -1] - min_z) / z_len * 0.8 + 0.2
            pts.append(coords)
            nrm.append(R.estimate_normals(coords))
            cols.append(base[None] * ramp[:, None])
            frame.append(np.full(len(coords), t))
            drawn.append(t)
        t1 = time.perf_counter()
        imgs = R.render_surfels_frames(
            cam, torch.as_tensor(np.concatenate(pts), device=dev),
            torch.as_tensor(np.concatenate(nrm), device=dev),
            torch.as_tensor(np.concatenate(cols), device=dev),
            torch.as_tensor(np.concatenate(frame), device=dev),
            R.blank(cam, gen_voxels.shape[1], device=dev), radius=0.03)
        frames = to_uint8(imgs)
        t2 = time.perf_counter()
        for t in drawn:
            write_png(frames[t], os.path.join(img_dir, f"{t:02d}.png"))
        write_gif(frames, os.path.join(out_dir, f"{prefix}_{s}.gif"),
                  RENDER_DELAY_S)
        t3 = time.perf_counter()
        stats["normals_ms"] += (t1 - t0) * 1e3
        stats["render_ms"] += (t2 - t1) * 1e3
        stats["encode_ms"] += (t3 - t2) * 1e3
        stats["frames"] += len(frames)
    return stats
