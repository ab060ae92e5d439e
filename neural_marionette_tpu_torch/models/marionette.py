"""NeuralMarionette: detector + dynamics composition.

Counterpart of ``neural_marionette_tpu/models/marionette.py``: the phase
flags are call arguments, and the boundary between detector and dynamics
detaches the keypoints.
"""
from __future__ import annotations

import contextlib
from typing import Any, Collection, Optional

import torch
import torch.nn as nn

from ..config import MarionetteConfig
from ..parallel.mesh import Mesh
from .detector import DETECTOR_OUTPUTS, GumbelSource, KyptDetector
from .dynamics import HSVRNNBVH, SkeletonArrays

#: the keys of ``HSVRNNBVH.encode``
ENCODE_OUTPUTS = frozenset((
    "kypt_recon", "R", "z_kypts", "h_kypts", "kl_kypt", "kypt_recon_loss",
    "gae_recon_loss", "topo_recon_loss", "best_index"))


def check_outputs(outputs: Collection[str]) -> frozenset:
    """The names of ``outputs`` as a set; raises ``KeyError`` on a name that
    :meth:`NeuralMarionette.encode_only` does not return, as the JAX
    stream's ``out[k]`` does."""
    want = frozenset(outputs)
    unknown = want - DETECTOR_OUTPUTS - ENCODE_OUTPUTS
    if unknown:
        raise KeyError(f"unknown outputs {sorted(unknown)}; encode_only "
                       f"returns {sorted(DETECTOR_OUTPUTS | ENCODE_OUTPUTS)}")
    return want


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
                generator: Optional[torch.Generator] = None,
                gumbel: GumbelSource = None,
                mesh: Optional[Mesh] = None) -> dict[str, Any]:
        """vox_seq: (B, T, G, G, G, 1). A frozen detector (learner only)
        runs under ``torch.no_grad()``: the JAX package's ``stop_gradient``
        on its outputs, without a detector-sized autograd graph.
        ``generator`` draws the VRNN's sample noise (or ``eps`` is it);
        ``gumbel`` is ``affinity_ver`` 4's uniform draw or the generator to
        draw it from (the JAX package's ``"gumbel"`` rng). ``mesh``: the
        detector's frame axis (``parallel.mesh``)."""
        log: dict[str, Any] = {}
        if detector_active or learner_active:
            frozen = (contextlib.nullcontext() if detector_active
                      else torch.no_grad())
            with frozen:
                log.update(self.kypt_detector(
                    vox_seq, affinity_active=affinity_active, gumbel=gumbel,
                    mesh=mesh))
        if learner_active:
            if skeleton is None:
                raise ValueError("the learner path needs a SkeletonArrays")
            log.update(self.dyna_module.encode(
                log["keypoints"].detach(), skeleton, sample_num=sample_num,
                eps=eps, generator=generator))
        return log

    def generate(self, vox_seq, skeleton: SkeletonArrays,
                 affinity_active: bool = True, sample_num: int = 10,
                 eps=None, generator: Optional[torch.Generator] = None,
                 gumbel: GumbelSource = None) -> dict[str, Any]:
        """Conditioned generation (reference neural_marionette.py:58-103):
        detect on the first ``cfg.Tcond`` frames, roll the VRNN out to the
        clip's T, decode the generated keypoints back to voxels. Returns
        ``gen`` = recon[:, :Tcond] || decoded (B, T, G, G, G, 1),
        ``keypoints`` = detected || generated (B, T, K, 4) and ``affinity``.
        ``eps``: as ``HSVRNNBVH.generate`` takes it; ``gumbel`` as
        :meth:`forward` takes it."""
        T = vox_seq.shape[1]
        Tcond = self.cfg.Tcond
        if not Tcond < T:
            raise ValueError(f"generate needs more than Tcond={Tcond} "
                             f"frames, got {T}")
        det = self.kypt_detector(vox_seq[:, :Tcond],
                                 affinity_active=affinity_active,
                                 gumbel=gumbel)
        keypoints = det["keypoints"]
        dyn = self.dyna_module.generate(keypoints.detach(), skeleton, Ttot=T,
                                        Tcond=Tcond, sample_num=sample_num,
                                        eps=eps, generator=generator)
        gen = self.kypt_detector.decode_from_dyna(
            dyn["keypoints_gen"], det["first_feature"], vox_seq[:, 0])["gen"]
        return dict(
            gen=torch.cat([det["recon"][:, :Tcond], gen], dim=1),
            keypoints=torch.cat([keypoints[:, :Tcond], dyn["keypoints_gen"]],
                                dim=1),
            affinity=det["affinity"])

    def encode_only(self, vox_seq, skeleton: SkeletonArrays,
                    affinity_active: bool = True, sample_num: int = 10,
                    eps: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    gumbel: GumbelSource = None,
                    outputs: Optional[Collection[str]] = None
                    ) -> dict[str, Any]:
        """Detector + dynamics encode for inference: keypoints, per-frame
        global rotations R, affinity, recon and the loss scalars.
        ``outputs``: the keys to compute and return (None: all of them);
        the detector runs only their work (``KyptDetector.forward``) and
        the VRNN encode only for its keys, each output equal to the bit to
        the full path's. An unknown name raises ``KeyError``."""
        want = check_outputs(DETECTOR_OUTPUTS | ENCODE_OUTPUTS
                             if outputs is None else outputs)
        det = self.kypt_detector(vox_seq, affinity_active=affinity_active,
                                 gumbel=gumbel,
                                 outputs=want & DETECTOR_OUTPUTS)
        if want & ENCODE_OUTPUTS:
            det.update(self.dyna_module.encode(
                det["keypoints"].detach(), skeleton, sample_num=sample_num,
                eps=eps, generator=generator))
        return {k: det[k] for k in want}
