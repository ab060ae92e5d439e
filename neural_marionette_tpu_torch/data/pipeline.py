"""Host-side sequence pipeline: window cropping and episodic normalization.

Counterpart of ``neural_marionette_tpu/data/pipeline.py`` (reference
``utils/dataset_utils.py:6-19``), the two functions the demo apps need; the
window-start selection and the loader come with the data layer.
"""
from __future__ import annotations

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
