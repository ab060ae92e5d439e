"""Quantitative evaluation metrics.

Counterpart of ``neural_marionette_tpu/eval.py`` (reference
``utils/eval_utils.py``):

* :func:`semantic_scores` — match each GT joint to the nearest predicted
  keypoint (low-intensity keypoints invalidated), accumulate a K'xK
  assignment histogram; score = mean over GT joints of the max assignment
  fraction (eval_utils.py:59-89, finalised :12-20). Host NumPy, a copy.
* :func:`voxel_chamfer` — binarize recon at 0.5 and compute the symmetric
  chamfer distance between occupied-voxel coordinate sets, reported x1e4
  (eval_utils.py:29-55, :21-26). The JAX function builds a dense
  ``(n_gt, n_rc, 3)`` float64 array per frame, gigabytes once the recon
  covers much of the grid; this one computes the same value in bounded
  memory, with plain torch ops on the tensors' device (see there).
* :func:`affinity_recovery` and :func:`evaluate`, copies.
"""
from __future__ import annotations

import numpy as np
import torch


def semantic_scores(scores: np.ndarray | None, keypoints: np.ndarray,
                    gt_keypoints: np.ndarray,
                    intensity_threshold: float = 0.2):
    """Accumulate the assignment histogram for one batch.

    keypoints: (B, T, K, 4) predicted (xyz + intensity).
    gt_keypoints: (B, T, K', 3).
    Returns (scores (K', K), batch_score float)."""
    kypt = np.array(keypoints, copy=True)
    B, T, K, _ = kypt.shape
    invalid = kypt[..., -1] < intensity_threshold
    kypt[invalid] = np.array([1e4, 1e4, 1e4, 1.0])
    pred = kypt[..., :-1][:, :, None]          # (B, T, 1, K, 3)
    gt = np.asarray(gt_keypoints)[:, :, :, None]  # (B, T, K', 1, 3)
    K_gt = gt.shape[2]

    if scores is None:
        scores = np.zeros((K_gt, K))

    dist = ((gt - pred) ** 2).sum(-1)              # (B, T, K', K)
    closest = dist.argmin(axis=-1).reshape(-1, K_gt)  # (B*T, K')
    batch_fracs = []
    for k_gt in range(K_gt):
        hist = np.bincount(closest[:, k_gt], minlength=K).astype(np.float64)
        scores[k_gt] += hist
        batch_fracs.append(hist.max() / hist.sum())
    return scores, float(np.mean(batch_fracs))


def semantic_final(scores: np.ndarray) -> float:
    """Final score from the accumulated histogram (eval_utils.py:12-20)."""
    total = scores[0].sum()
    norm = scores / total
    return float(norm.max(axis=-1).mean())


def squared_distance_transform(occ: torch.Tensor) -> torch.Tensor:
    """(F, G, G, G) bool -> int32, per voxel the squared distance in voxel
    units to the nearest occupied voxel of its frame, exact (at least
    ``3 G^2`` in a frame with none). Separable: one min-plus pass per axis,
    ``f'[x] = min_x' f[x'] + (x - x')^2``, ``G^4`` sums a frame."""
    G = occ.shape[-1]
    ar = torch.arange(G, device=occ.device, dtype=torch.int32)
    sq = (ar[:, None] - ar[None, :]) ** 2          # [x, x']
    f = torch.where(occ, 0, 3 * G * G).to(torch.int32)
    for axis in (1, 2, 3):
        f = f.movedim(axis, -1)
        f = (f[..., None, :] + sq).amin(-1)
        f = f.movedim(-1, axis)
    return f


#: frames whose distance transforms :func:`voxel_chamfer` holds at once
FRAMES_PER_CHUNK = 4


def voxel_chamfer(gt_voxel, recon, threshold: float = 0.5) -> float:
    """Mean symmetric chamfer (x1e4) between occupied-voxel coordinates,
    over the frames where both sets are non-empty.

    gt_voxel / recon: (B, T, G, G, G, 1) channels-last, recon in [0, 1];
    numpy arrays or tensors (the work runs on recon's device). Each
    voxel's distance to the other set is read from the other set's exact
    squared distance transform (:func:`squared_distance_transform`), in
    integer voxel units, then scaled by the JAX function's coordinate step
    2 / (G - 1): the value is the JAX function's (to float64 rounding), in
    memory of :data:`FRAMES_PER_CHUNK` grids of ``G^4`` int32, whatever the
    occupancy."""
    rc_t = torch.as_tensor(recon)
    gt_t = torch.as_tensor(gt_voxel, device=rc_t.device)
    gt = (gt_t[..., 0] != 0).flatten(0, 1)
    rc = (rc_t[..., 0] >= threshold).flatten(0, 1)
    G = gt.shape[-1]
    sums = []
    step = FRAMES_PER_CHUNK
    for i in range(0, gt.shape[0], step):
        g, r = gt[i:i + step], rc[i:i + step]
        # each GT voxel to the nearest recon voxel, and back
        to_rc = (squared_distance_transform(r).long() * g).sum((1, 2, 3))
        to_gt = (squared_distance_transform(g).long() * r).sum((1, 2, 3))
        sums.append(torch.stack([to_rc, to_gt, g.sum((1, 2, 3)),
                                 r.sum((1, 2, 3))], dim=1))
    rows = torch.cat(sums).cpu().numpy()
    step2 = ((G - 1) / 2) ** 2
    total, count = 0.0, 0
    for to_rc, to_gt, n_gt, n_rc in rows:
        if n_gt == 0 or n_rc == 0:
            continue
        total += to_rc / n_gt / step2 + to_gt / n_rc / step2
        count += 1
    return float(total / max(count, 1)) * 1e4


def affinity_recovery(gt_affinity: np.ndarray, parents: np.ndarray,
                      semantic_hist: np.ndarray) -> dict:
    """Fraction of GT skeleton edges recovered by the extracted skeleton.

    GT joints are mapped to predicted keypoints via the semantic
    assignment histogram (argmax per GT joint — the same mapping
    semantic_final scores), and a GT edge (i, j) counts as recovered when
    the extracted skeleton (parent edges) connects the two mapped
    keypoints (the reference writes ``gt_affinity.npy`` in
    prepare_aistpp.py:66-73 but never reads it).

    gt_affinity: (K', K') symmetric 0/1.  parents: (K,) extracted-skeleton
    parent indices.  semantic_hist: (K', K) accumulated assignment counts."""
    gt = np.asarray(gt_affinity)
    parents = np.asarray(parents)
    assign = np.asarray(semantic_hist).argmax(-1)          # (K',)
    pred_edges = {(int(min(k, p)), int(max(k, p)))
                  for k, p in enumerate(parents) if p >= 0 and p != k}
    gt_i, gt_j = np.nonzero(np.triu(gt, 1))
    recovered = 0
    collapsed = 0
    for i, j in zip(gt_i, gt_j):
        a, b = int(assign[i]), int(assign[j])
        if a == b:
            collapsed += 1  # both GT endpoints map to one keypoint
            continue
        if (min(a, b), max(a, b)) in pred_edges:
            recovered += 1
    n_gt = len(gt_i)
    return {"recovered": recovered, "collapsed": collapsed,
            "gt_edges": n_gt,
            "recovery": recovered / max(n_gt, 1)}


def evaluate(name: str, scores, params: dict):
    """Dispatch matching the reference surface (eval_utils.py:4-10)."""
    if name == "semantic":
        new_scores, log = semantic_scores(scores, params["keypoints"],
                                          params["gt_keypoints"])
        return {"scores": new_scores, "scores_log": log}
    if name == "voxel_chamfer":
        log = voxel_chamfer(params["voxel"], params["recon"])
        scores = (scores or []) + [log]
        return {"scores": scores, "scores_log": log}
    raise ValueError(f"invalid evaluation metric {name!r}")
