"""Host-side sequence pipeline: window cropping, episodic normalization,
window-start selection and the fixed point count.

Counterpart of ``neural_marionette_tpu/data/pipeline.py`` (reference
``utils/dataset_utils.py:6-19`` and the window-start logic the reference
repeats in each dataset class, ``dataset/dataset.py:51-73``), with the same
arithmetic, so a window equals the JAX package's to the bit.

Each random choice of a window is split from the work on its data:
:func:`window_start` and :func:`point_indices` make the draws from the
sequence's length and point count alone, :func:`crop_window` and
:func:`select_points` apply them. The loader draws on its calling thread in
index order and transforms in its threads, so its batches do not depend
on thread timing (``data/loader.py``). :func:`window_from_sequence` and
:func:`fix_point_count` are the two halves put together, as the JAX
package has them.
"""
from __future__ import annotations

import random
from typing import Optional

import numpy as np


def crop_sequence(seq: np.ndarray, start: int, T: int,
                  sample_rate: int = 1) -> np.ndarray:
    """Strided temporal window (reference utils/dataset_utils.py:6-7)."""
    return seq[start:start + T * sample_rate:sample_rate]


def episodic_normalization(seq: np.ndarray, scale: float = 1.0,
                           x_trans: float = 0.0, z_trans: float = 0.0,
                           joints: Optional[np.ndarray] = None):
    """Normalize a whole clip into [-1, 1]^3 by the clip-wide bbox
    (per-episode, not per-frame), optionally co-normalizing joints
    (reference utils/dataset_utils.py:9-19)."""
    bmax = np.amax(seq, axis=(0, 1))
    bmin = np.amin(seq, axis=(0, 1))
    blen = (bmax - bmin).max()
    out = ((seq - bmin[None, None]) * scale / (blen + 1e-5)) * 2 - 1 \
        + np.array([x_trans, 0.0, z_trans])
    if joints is not None:
        joints = ((joints - bmin[None, None]) * scale / (blen + 1e-5)) * 2 - 1
        return out, joints
    return out


def select_window_start(seq_len: int, T: int, sample_rate: int,
                        random_crop: bool, epoch_id: int,
                        rng: random.Random) -> int:
    """Window-start policy shared by every dataset.

    random_crop: uniform start such that the strided window fits
    (reference dataset.py:51-56); otherwise an epoch-deterministic sweep
    with offset wraparound (reference dataset.py:57-63)."""
    span = sample_rate * (T - 1)
    if random_crop:
        if seq_len - 1 - span < 0:
            return 0
        return rng.randint(0, seq_len - 1 - span)
    offset = (epoch_id % T) * sample_rate
    n_windows = max(seq_len // (T * sample_rate), 1)
    start = (epoch_id % n_windows) * (T * sample_rate) + offset
    if start + span >= seq_len:
        start = max(start - 2 * offset, 0)
    return start


def pad_short_sequence(x: np.ndarray, T: int, sample_rate: int) -> np.ndarray:
    """Repeat the last frame so a strided window fits
    (reference dataset.py:65-68)."""
    if x.shape[0] < T * sample_rate:
        copy_num = T - x.shape[0]
        if copy_num > 0:
            x = np.concatenate([x] + [x[-1:]] * copy_num, axis=0)
    return x


def point_indices(N: int, n_points: int,
                  rng: np.random.Generator) -> Optional[np.ndarray]:
    """The point subset :func:`fix_point_count` draws for a cloud of ``N``
    points: None when ``N == n_points`` (nothing drawn), else ``n_points``
    indices, without replacement when there are more points than wanted."""
    if N == n_points:
        return None
    return rng.choice(N, n_points, replace=N < n_points)


def select_points(points: np.ndarray,
                  idx: Optional[np.ndarray]) -> np.ndarray:
    """``points[:, idx]`` (the points as they are when ``idx`` is None)."""
    return points if idx is None else points[:, idx]


def fix_point_count(points: np.ndarray, n_points: int,
                    rng: np.random.Generator) -> np.ndarray:
    """Subsample or repeat points to a fixed N per frame (the steps take
    static shapes; the reference's .npy files are fixed-N already)."""
    return select_points(points, point_indices(points.shape[1], n_points,
                                               rng))


def window_start(seq_len: int, T: int, sample_rate: int, random_crop: bool,
                 epoch_id: int, rng: random.Random) -> int:
    """The start :func:`window_from_sequence` takes for a sequence of
    ``seq_len`` frames: 0 (no draw) when it is shorter than the strided
    window and is padded, else :func:`select_window_start`."""
    if seq_len < T * sample_rate:
        return 0
    return select_window_start(seq_len, T, sample_rate, random_crop,
                               epoch_id, rng)


def crop_window(x: np.ndarray, start: int, T: int, sample_rate: int,
                joints: Optional[np.ndarray] = None, scale: float = 1.0,
                align_rots: Optional[np.ndarray] = None):
    """The window of ``x`` that starts at ``start``: padding of a short
    sequence, the strided crop, normalization and the root alignment of
    :func:`window_from_sequence`. Only the window's frames are read, so
    ``x`` may be a memory map of the whole sequence."""
    if x.shape[0] < T * sample_rate:
        x = pad_short_sequence(x, T, sample_rate)
        if joints is not None:
            joints = pad_short_sequence(joints, T, sample_rate)
    x = np.array(crop_sequence(x, start, T, sample_rate))
    if joints is not None:
        joints = crop_sequence(joints, start, T, sample_rate)
        x, joints = episodic_normalization(x, scale=scale, joints=joints)
    else:
        x = episodic_normalization(x, scale=scale)
    if align_rots is not None:
        r = align_rots[min(start, len(align_rots) - 1)]  # (3, 3)
        x = np.einsum("ij,tnj->tni", r, x)
        # renormalize so the rotated window stays inside [-1,1]^3
        if joints is not None:
            x, joints = episodic_normalization(x, scale=scale, joints=joints)
        else:
            x = episodic_normalization(x, scale=scale)
    if joints is not None:
        return x, joints
    return x


def window_from_sequence(x: np.ndarray, T: int, sample_rate: int,
                         random_crop: bool, epoch_id: int,
                         rng: random.Random,
                         joints: Optional[np.ndarray] = None,
                         scale: float = 1.0,
                         align_rots: Optional[np.ndarray] = None):
    """Full window extraction: start selection, padding, crop, normalize.

    The reference's dataset classes order the two steps differently:
    DFAUST/AIST choose the start before padding short sequences
    (dataset.py:51-68), animals/humanoids/panda pad first (dataset.py:
    221-238). A padded sequence starts at 0 with no draw either way
    (:func:`window_start`), so one path gives both orders' window.

    ``align_rots``: per-source-frame (T_seq, 3, 3) root-alignment rotation
    matrices (AIST ``align_root``). The window-start frame's matrix is
    applied to every frame of the normalized window (the reference's
    intent at dataset.py:161-164; its numpy code there crashes as written),
    then the window is normalized again (joints co-normalized by the same
    bbox transform, not rotated), so no point leaves [-1, 1]^3."""
    start = window_start(x.shape[0], T, sample_rate, random_crop, epoch_id,
                         rng)
    return crop_window(x, start, T, sample_rate, joints=joints, scale=scale,
                       align_rots=align_rots)
