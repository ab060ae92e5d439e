"""Skeleton-driven motion retargeting: skinning weights + LBS.

Counterpart of ``neural_marionette_tpu/retarget.py``, copied: reference
`vis_retarget.py:21-62` (nearest-bone skin weights
with exponential parent/child blending) and `:264-322` (bind-pose local
coordinates, FK with target bone offsets + source rotations, linear blend
skinning).  The reference's per-point Python loop (N iterations,
vis_retarget.py:54-60) and per-frame LBS loop are vectorised NumPy here —
this is host-side one-shot geometry, not a training hot path.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .skeleton import Skeleton


def extract_skin_weights(skeleton: Skeleton, points: np.ndarray,
                         keypoints: np.ndarray, hardness: float = 8.0,
                         threshold: float = 0.2) -> np.ndarray:
    """(N, 3) points + (K, 4) keypoints -> (N, K) skin weights.

    Bone proxy for joint k = midpoint of (k, nearest valid ancestor); root
    and low-intensity joints are never the nearest bone; weights blend the
    nearest joint and its (original) parent with exp(hardness * distance)
    ratios (reference vis_retarget.py:21-62).
    """
    parents = skeleton.parents
    K = keypoints.shape[0]
    N = points.shape[0]
    root = int(skeleton.priority_indices[0])

    invalid = keypoints[:, -1] < threshold
    bones = np.zeros((K, 3), dtype=np.float64)
    for k in range(K):
        parent = int(parents[k])
        if parent == k:
            bones[k] = keypoints[k, :3]
        else:
            while invalid[parent]:
                parent = int(parents[parent])
            bones[k] = (keypoints[k, :3] + keypoints[parent, :3]) / 2.0

    dist = np.sqrt(((points[:, None] - bones[None]) ** 2).sum(-1))  # (N, K)
    dist[:, invalid] = 1e4
    dist[:, root] = 1e4  # never choose the root

    child = dist.argmin(axis=-1)  # (N,)
    parent = parents[child].astype(np.int64)  # original parents (upstream)
    d_child = np.exp(np.sqrt(
        ((points - keypoints[child, :3]) ** 2).sum(-1)) * hardness)
    d_parent = np.exp(np.sqrt(
        ((points - keypoints[parent, :3]) ** 2).sum(-1)) * hardness)
    denom = d_child + d_parent

    w = np.zeros((N, K), dtype=np.float64)
    rows = np.arange(N)
    # parent gets the child-distance share and vice versa (closer joint
    # dominates); parent first so child wins when parent == child
    w[rows, parent] = d_child / denom
    w[rows, child] = d_parent / denom
    return w


class RetargetResult(NamedTuple):
    new_points: np.ndarray     # (T, N, 3) deformed target points
    new_keypoints: np.ndarray  # (T, K, 4) retargeted joint positions
    skin_weights: np.ndarray   # (N, K)


def retarget_motion(skeleton: Skeleton,
                    source_keypoints: np.ndarray,   # (T, K, 4)
                    source_R: np.ndarray,           # (T, K, 3, 3) global
                    target_keypoints: np.ndarray,   # (K, 4) bind pose
                    target_R: np.ndarray,           # (K, 3, 3) bind pose
                    target_points: np.ndarray,      # (N, 3)
                    target_offset: np.ndarray,      # (K, 3) bone offsets
                    hardness: float = 8.0,
                    mode: str = "ours") -> RetargetResult:
    """Transfer source motion onto the target shape.

    ``ours``: target points go to per-joint local frames via the inverse
    bind rotations, then each frame rebuilds joint positions by FK with
    TARGET bone offsets and SOURCE rotations (vis_retarget.py:267-287,
    303-322).  ``baseline``: no rotations; source offsets rescaled by the
    target/source bone-length ratio (vis_retarget.py:288-298).
    """
    T, K = source_keypoints.shape[:2]
    parents = skeleton.parents
    priority = skeleton.priority_indices
    root = int(priority[0])

    skin = extract_skin_weights(skeleton, target_points, target_keypoints,
                                hardness)
    R_inv = np.swapaxes(target_R, -1, -2)  # (K, 3, 3)

    pos0 = target_keypoints[:, :3]
    offsets_from_joint = target_points[:, None] - pos0[None]  # (N, K, 3)
    if mode == "ours":
        points_local = np.einsum("kij,nkj->nki", R_inv, offsets_from_joint)
    else:
        points_local = offsets_from_joint

    # per-frame joint positions: FK with target offsets + source rotations
    new_keypoints = np.zeros((T, K, 3))
    for t in range(T):
        pos = np.zeros((K, 3))
        pos[root] = source_keypoints[t, root, :3]
        for idx in priority[1:]:
            idx = int(idx)
            p = int(parents[idx])
            if mode == "ours":
                pos[idx] = source_R[t, idx] @ target_offset[idx] + pos[p]
            else:
                src_off = (source_keypoints[t, idx, :3]
                           - source_keypoints[t, p, :3])
                src_len = np.sqrt((src_off ** 2).sum())
                tgt_len = np.sqrt(((target_keypoints[idx, :3]
                                    - target_keypoints[p, :3]) ** 2).sum())
                pos[idx] = pos[p] + src_off * (tgt_len / max(src_len, 1e-9))
        new_keypoints[t] = pos
    new_keypoints = np.clip(new_keypoints, -1, 1)

    # LBS: x_t[n] = sum_k w[n,k] (R_t[k] @ local[n,k] + pos_t[k])
    if mode == "ours":
        R_use = source_R  # (T, K, 3, 3)
    else:
        R_use = np.broadcast_to(np.eye(3), (T, K, 3, 3))
    rotated = np.einsum("tkij,nkj->tnki", R_use, points_local)
    translated = rotated + new_keypoints[:, None]  # (T, N, K, 3)
    new_points = np.einsum("nk,tnki->tni", skin, translated)

    kp4 = np.concatenate(
        [new_keypoints,
         np.broadcast_to(source_keypoints[:, :, 3:], (T, K, 1))], axis=-1)
    return RetargetResult(new_points=new_points, new_keypoints=kp4,
                          skin_weights=skin)
