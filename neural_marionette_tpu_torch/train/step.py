"""Train and eval steps.

Counterpart of ``neural_marionette_tpu/train/step.py``. One step per
scheduler phase, as there: the (detector, learner, affinity) flags and the
loss weights are fixed when the step is made. PyTorch runs eagerly, so
there is nothing to compile; the step updates the :class:`TrainState` in
place and returns its metrics as 0-dim tensors on the device, so a caller
that does not read them never waits for the card.

A step takes a batch of points ``(B, T, N, 3)`` (voxelized on the device,
kernel K1 on a card) or of voxels ``(B, T, G, G, G, 1)``. With
``cfg.grad_accum`` > 1 the batch is split into that many microbatches, run
in order; their gradients sum in ``.grad`` and are scaled, with the
metrics, by 1/accum. Each microbatch draws its own sample noise from the
state's generator, unless the caller hands it in (``eps``, one tensor per
microbatch, as ``HSVRNNBVH.encode`` takes it), as the tests do to replay the
JAX step's noise.

``make_generate_step`` comes with the generation slice.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from ..config import MarionetteConfig
from ..models.dynamics import SkeletonArrays
from ..ops.voxelize import voxelize
from .losses import LOSS_LIST
from .state import TrainState, make_update_mask


def _as_voxels(batch: torch.Tensor, cfg: MarionetteConfig,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Points ``(B, T, N, 3)`` -> occupancy ``(B, T, G, G, G, 1)``, on the
    batch's device (kernel K1 for a CUDA tensor), directly in ``dtype``
    (occupancy is binary, so exact in bfloat16); voxels are cast."""
    if batch.ndim == 4 and batch.shape[-1] == 3:
        return voxelize(batch, cfg.grid_size,
                        dtype=dtype or torch.float32)
    if dtype is not None and batch.dtype != dtype:
        batch = batch.to(dtype)
    return batch


def total_loss(out: dict[str, Any], weights: dict[str, float],
               dtype: torch.dtype, device: torch.device):
    """Weighted sum over the loss registry in ``dtype``, promoting as the
    terms do (as the JAX package sums it); absent losses contribute 0
    (reference train.py:389-398)."""
    zero = torch.zeros((), dtype=dtype, device=device)
    total = zero
    metrics = {}
    for name in LOSS_LIST:
        val = out.get(name)
        if val is None:
            val = zero
        total = total + weights.get(name, 0.0) * val
        metrics[name] = val
    metrics["total_loss"] = total
    return total, metrics


def make_train_step(model: torch.nn.Module, cfg: MarionetteConfig,
                    weights: dict[str, float], detector_active: bool,
                    learner_active: bool, affinity_active: bool):
    """The train step of one scheduler phase:
    ``step(state, batch, skeleton=None, eps=None) -> metrics``.

    Metrics: every loss of the registry, ``total_loss`` and ``grad_norm``
    (the global norm of the masked gradients before clipping)."""
    w = dict(weights)
    accum = max(int(cfg.grad_accum), 1)
    names = [n for n, _ in model.named_parameters()]
    mask = make_update_mask(names, detector_active, learner_active,
                            affinity_active)
    trainable = [mask[n] == 1.0 for n in names]
    params = [p for _, p in model.named_parameters()]

    def loss_fn(micro, skeleton, eps, generator):
        vox = _as_voxels(micro, cfg, model.dtype)
        out = model(vox, detector_active=detector_active,
                    learner_active=learner_active,
                    affinity_active=affinity_active, skeleton=skeleton,
                    eps=eps, generator=generator)
        return total_loss(out, w, vox.dtype, vox.device)

    def step(state: TrainState, batch: torch.Tensor,
             skeleton: Optional[SkeletonArrays] = None,
             eps: Optional[Sequence[torch.Tensor]] = None
             ) -> dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the step was made for another model than the "
                             "state's")
        B = batch.shape[0]
        if B % accum:
            raise ValueError(f"batch {B} is not a multiple of grad_accum "
                             f"{accum}")
        if eps is not None and len(eps) != accum:
            raise ValueError(f"eps: one tensor per microbatch ({accum}), "
                             f"got {len(eps)}")
        for p in params:
            p.grad = None
        micros = batch.reshape((accum, B // accum) + batch.shape[1:])
        metrics = None
        for i in range(accum):
            loss, m = loss_fn(micros[i], skeleton,
                              None if eps is None else eps[i],
                              state.generator)
            if loss.requires_grad:
                loss.backward()
            m = {k: v.detach() for k, v in m.items()}
            metrics = m if metrics is None else {
                k: metrics[k] + m[k] for k in metrics}
        grads = [p.grad for p in params]
        if accum > 1:
            inv = 1.0 / accum
            present = [g for g in grads if g is not None]
            if present:
                torch._foreach_mul_(present, inv)
            metrics = {k: v * inv for k, v in metrics.items()}
        metrics["grad_norm"] = state.optimizer.update(grads, trainable)
        for p in params:
            p.grad = None
        state.step += 1
        return metrics

    return step


def make_eval_step(model: torch.nn.Module, cfg: MarionetteConfig,
                   weights: dict[str, float], detector_active: bool,
                   learner_active: bool, affinity_active: bool):
    """Forward only, the detector always on (as the JAX eval step):
    ``eval_step(batch, skeleton=None, generator=None, eps=None) ->
    (metrics, tensors)`` with the tensors needed for logging."""
    w = dict(weights)

    @torch.no_grad()
    def eval_fn(batch, skeleton=None, generator=None, eps=None):
        vox = _as_voxels(batch, cfg, model.dtype)
        out = model(vox, detector_active=True,
                    learner_active=learner_active,
                    affinity_active=affinity_active, skeleton=skeleton,
                    eps=eps, generator=generator)
        _, metrics = total_loss(out, w, vox.dtype, vox.device)
        tensors = {k: out[k] for k in
                   ("recon", "keypoints", "affinity", "kypt_recon")
                   if out.get(k) is not None}
        return metrics, tensors

    return eval_fn
