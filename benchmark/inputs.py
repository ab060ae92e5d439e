"""The benchmark's inputs, made from the seed: the AIST++-layout tree the
training cells load, the point windows the serving cell streams, and the
plain re-derivation of the batches the training loader makes of the tree.

The tree follows the prepared AIST++ layout
(``aist_plusplus_smpl_joints/{surface,joints}/train/<seq>.npy``): float32
clips of a body-sized blob of points drifting and swaying over the clip,
24 joints among the points. The windows are blobs of points drifting
across a clip, with a few stray points outside [-1, 1] that the
voxelizer drops.
"""
from __future__ import annotations

import os
import random
from pathlib import Path

import numpy as np


def seed_of(*parts: int) -> int:
    """A 32-bit seed mixed from whole numbers of any size."""
    return int(np.random.SeedSequence([int(p) for p in parts])
               .generate_state(1)[0])


# ---------------------------------------------------------------- the tree
def write_aist_tree(root: Path, seed: int, sequences: int, frames: int,
                    points: int) -> int:
    """The training split of an AIST++-layout tree under ``root``; returns
    the bytes written."""
    g = np.random.default_rng(seed_of(seed, 1))
    base = Path(root) / "aist_plusplus_smpl_joints"
    for sub in ("surface", "joints"):
        (base / sub / "train").mkdir(parents=True, exist_ok=True)
    total = 0
    t = np.arange(frames, dtype=np.float32)[:, None, None]
    for i in range(sequences):
        body = (g.normal(0.0, 0.25, (points, 3))
                * np.array([0.3, 0.9, 0.2])).astype(np.float32)
        drift = t * g.uniform(-0.01, 0.01, 3).astype(np.float32)
        pts = body[None] + drift
        pts[..., 0:1] += 0.05 * np.sin(0.3 * t + body[None, :, 1:2] * 4)
        joints = np.ascontiguousarray(pts[:, :24])
        name = f"gBR_sBM_cAll_d{i:03d}_mBR0_ch01.npy"
        np.save(base / "surface" / "train" / name, pts)
        np.save(base / "joints" / "train" / name, joints)
        total += pts.nbytes + joints.nbytes
    return total


def _window(x: np.ndarray, start: int, T: int, sr: int) -> np.ndarray:
    """The strided window from ``start``, normalized into [-1, 1]^3 by its
    bounding box, as the reference's ``episodic_normalization``."""
    seq = np.array(x[start:start + T * sr:sr])
    bmax = np.amax(seq, axis=(0, 1))
    bmin = np.amin(seq, axis=(0, 1))
    blen = (bmax - bmin).max()
    return ((seq - bmin[None, None]) * 1.0 / (blen + 1e-5)) * 2 - 1 \
        + np.array([0.0, 0.0, 0.0])


def loader_batches(root: Path, cfg: dict, n_batches: int) -> list:
    """The first ``n_batches`` point batches (B, T, N, 3) float32 that the
    training loader makes of the tree, worked out again: the sequences in
    the dataset's shuffled order, each loader pass's shuffled order, and
    per item the random window start, then the random point subset, drawn
    from generators seeded as the loader's are."""
    surf = Path(root) / "aist_plusplus_smpl_joints" / "surface" / "train"
    names = sorted(os.listdir(surf))
    random.Random(cfg["seed"]).shuffle(names)
    starts = random.Random(cfg["seed"])
    subsets = np.random.default_rng(cfg["seed"])
    order_rng = random.Random(cfg["seed"])
    B, T, sr, n = cfg["nbatch"], cfg["Ttot"], cfg["sample_rate"], \
        cfg["n_points"]
    out = []
    while len(out) < n_batches:
        order = list(range(len(names)))
        order_rng.shuffle(order)
        for i in range(0, len(order) - B + 1, B):
            rows = []
            for j in order[i:i + B]:
                x = np.load(surf / names[j], mmap_mode="r")[..., :3]
                L, N = x.shape[:2]
                if L < T * sr:
                    raise ValueError("sequence shorter than a window")
                span = sr * (T - 1)
                start = starts.randint(0, L - 1 - span) if L - 1 - span >= 0 \
                    else 0
                idx = None if N == n else subsets.choice(N, n, replace=N < n)
                w = _window(x, start, T, sr).astype(np.float32)
                rows.append(w if idx is None else w[:, idx])
            out.append(np.stack(rows))
            if len(out) == n_batches:
                break
    return out


# ---------------------------------------------------------- serving windows
def serve_window(seed: int, index: int, B: int, T: int, N: int
                 ) -> np.ndarray:
    """Window ``index`` of a stream, (B, T, N, 3) float32."""
    g = np.random.default_rng(seed_of(seed, 2, index))
    base = g.normal(0.0, 0.25, (B, 1, N, 3)) * np.array([0.6, 1.0, 0.5])
    drift = np.linspace(-0.2, 0.2, T)[None, :, None, None] * \
        g.uniform(-1, 1, (B, 1, 1, 3))
    pts = np.clip(base + drift, -0.7, 0.7)
    stray = g.random((B, T, N)) < 0.002
    k = int(stray.sum())
    pts[stray] = g.uniform(1.01, 1.2, (k, 3)) * g.choice([-1.0, 1.0], (k, 3))
    return pts.astype(np.float32)
