"""Shared demo plumbing: pretrained loading, clip loading, detection and
the skeleton.

Counterpart of ``neural_marionette_tpu/apps/common.py`` (reference demo
preamble, vis_generation.py:44-90). The port's :class:`api.Marionette`
plays the role of the JAX package's ``DemoContext``: the configuration,
the model with its weights on one device, and the skeleton.
``synthetic_clip`` comes with the data layer.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..api import Marionette, resolve_device
from ..config import MarionetteConfig, load_reference_pickle
from ..data.pipeline import crop_sequence, episodic_normalization
from ..models import NeuralMarionette
from ..ops.voxelize import voxelize_np
from ..skeleton import Skeleton
from ..train.checkpoint import load_params_only
from ..weights import init_weights, load_reference_checkpoint


def load_pretrained(exp_dir: str, device=None, **overrides) -> Marionette:
    """A float32 :class:`Marionette` from an experiment directory.

    Layouts understood:
      * the port's: ``<exp_dir>/opt.json`` + ``<exp_dir>/epochs/<n>/``
        (``train.CheckpointManager``; the latest epoch, with its skeleton);
      * the reference's: ``<exp_dir>/opt.pickle`` + ``<exp_dir>/<name>.pth``
        (``weights.load_reference_checkpoint``, the first ``.pth`` by
        name).
    With neither checkpoint it warns and keeps random weights (seed 0)."""
    opt_json = os.path.join(exp_dir, "opt.json")
    opt_pickle = os.path.join(exp_dir, "opt.pickle")
    if os.path.exists(opt_json):
        cfg = MarionetteConfig.from_json(opt_json)
    elif os.path.exists(opt_pickle):
        cfg = load_reference_pickle(opt_pickle)
    else:
        raise FileNotFoundError(f"no opt.json/opt.pickle under {exp_dir}")
    if overrides:
        cfg = cfg.replace(**overrides)

    dev = resolve_device(device)
    model = NeuralMarionette(cfg, device=dev)
    init_weights(model, torch.Generator().manual_seed(0))
    skeleton = None
    pth_files = sorted(f for f in os.listdir(exp_dir) if f.endswith(".pth"))
    if os.path.isdir(os.path.join(exp_dir, "epochs")):
        state, skeleton, _ = load_params_only(exp_dir)
        model.load_state_dict(state, strict=True)
    elif pth_files:
        load_reference_checkpoint(os.path.join(exp_dir, pth_files[0]),
                                  model)
    else:
        print(f"WARNING: no checkpoint found under {exp_dir}; "
              "running with random weights")
    return Marionette(cfg, model, dev, skeleton=skeleton)


def load_clip(file: str, cfg: MarionetteConfig, start: int = 0,
              scale: float = 1.0, x_trans: float = 0.0,
              z_trans: float = 0.0):
    """``.npy`` point sequence -> (voxels (T, G, G, G, 1), points (T, N, 3)),
    voxelized on the host (reference demo load_voxel,
    vis_generation.py:14-25)."""
    x = np.load(file)[..., :3]
    x = crop_sequence(x, start=start, T=cfg.Ttot,
                      sample_rate=cfg.sample_rate)
    x = episodic_normalization(x, scale, x_trans, z_trans)
    vox = np.stack([voxelize_np(x[t], cfg.grid_size)
                    for t in range(x.shape[0])])
    return vox.astype(np.float32), x.astype(np.float32)


def detect_and_extract_skeleton(m: Marionette, vox_clip: np.ndarray
                                ) -> tuple[dict, Skeleton]:
    """Detector forward on a clip ``(T, G, G, G, 1)``, affinity on, under
    ``torch.inference_mode()``: the detector's outputs as tensors on the
    device (batch of one), and the skeleton (the marionette's, else
    extracted on the host from the learned affinity and cached)."""
    with torch.inference_mode():
        det = m.model.kypt_detector(m.clip_tensor(vox_clip), affinity_active=True)
    return det, m.extract_skeleton()
