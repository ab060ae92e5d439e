"""NeuralMarionette: detector + dynamics composition.

Counterpart of ``neural_marionette_tpu/models/marionette.py``: the phase
flags are call arguments, and the boundary between detector and dynamics
detaches the keypoints.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch
import torch.nn as nn

from ..config import MarionetteConfig
from .detector import KyptDetector
from .dynamics import HSVRNNBVH, SkeletonArrays


class NeuralMarionette(nn.Module):
    """``conv_kernel=True`` routes the detector's eligible convs through
    kernel K3 (``models/blocks.routes_to_kernel``): the counterpart of the
    JAX package's ``NM_PALLAS_CONV=1``. It adds no parameter."""

    def __init__(self, cfg: MarionetteConfig, dtype=torch.float32,
                 device=None, conv_kernel: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.conv_kernel = conv_kernel
        self.kypt_detector = KyptDetector(cfg, dtype, device, conv_kernel)
        self.dyna_module = HSVRNNBVH(cfg, device)

    def forward(self, vox_seq, detector_active: bool = True,
                learner_active: bool = False, affinity_active: bool = True,
                skeleton: Optional[SkeletonArrays] = None,
                sample_num: int = 10, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> dict[str, Any]:
        """vox_seq: (B, T, G, G, G, 1). A frozen detector (learner only)
        runs under ``torch.no_grad()``: the JAX package's ``stop_gradient``
        on its outputs, without a detector-sized autograd graph."""
        log: dict[str, Any] = {}
        if detector_active or learner_active:
            frozen = (contextlib.nullcontext() if detector_active
                      else torch.no_grad())
            with frozen:
                log.update(self.kypt_detector(
                    vox_seq, affinity_active=affinity_active))
        if learner_active:
            if skeleton is None:
                raise ValueError("the learner path needs a SkeletonArrays")
            log.update(self.dyna_module.encode(
                log["keypoints"].detach(), skeleton, sample_num=sample_num,
                eps=eps, generator=generator))
        return log

    def encode_only(self, vox_seq, skeleton: SkeletonArrays,
                    affinity_active: bool = True, sample_num: int = 10,
                    eps: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> dict[str, Any]:
        """Detector + dynamics encode for inference: keypoints, per-frame
        global rotations R, affinity, recon and the loss scalars."""
        det = self.kypt_detector(vox_seq, affinity_active=affinity_active)
        det.update(self.dyna_module.encode(
            det["keypoints"].detach(), skeleton, sample_num=sample_num,
            eps=eps, generator=generator))
        return det
