"""Train state and the masked Adam.

Counterpart of ``neural_marionette_tpu/train/state.py``. The JAX package
trains with ``optax.inject_hyperparams(chain(clip_by_global_norm(
max_grad_norm), adam(lr)))`` and masks the gradients before the update and
the updates after it (``train/step.py:134-144``). So a frozen parameter
keeps its value while its Adam moments still decay on zero gradients, under
one count shared by every parameter. ``torch.optim.Adam`` differs (it skips
a parameter without a gradient and counts steps per parameter, moves a
parameter through its momentum on a zero gradient, and ``clip_grad_norm_``
adds 1e-6 to the norm), so :class:`Adam` below is written out to mirror
optax:

* clip: ``g * max_norm / |g|`` (as ``(g / |g|) * max_norm``) when
  ``|g| >= max_norm``, over the global norm of the masked gradients;
* Adam: b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias-corrected moments;
* the learning rate a float32 value that :func:`set_learning_rate` sets,
  as ``inject_hyperparams`` holds it.

The update runs with ``torch._foreach_*`` ops over the parameter lists and
writes the parameters in place. The clip's choice stays on the device: the
step reads nothing back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..config import MarionetteConfig


def _f32(x: float) -> float:
    """``x`` rounded to float32 (exactly representable from then on)."""
    return float(np.float32(x))


class Adam:
    """``chain(clip_by_global_norm(max_norm), adam(lr))`` over named
    parameters, with an update mask applied to the gradients and to the
    updates. State: ``count`` (shared), ``mu`` and ``nu`` per parameter,
    ``lr``."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: Mapping[str, torch.nn.Parameter],
                 max_grad_norm: float, lr: float):
        self.names = list(params)
        self.params = [params[n] for n in self.names]
        self.max_grad_norm = float(max_grad_norm)
        self.lr = _f32(lr)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """``sqrt(sum_i |g_i|^2)`` as a 0-dim float32 tensor on the device."""
        if not grads:
            return torch.zeros((), dtype=torch.float32,
                               device=self.params[0].device)
        return torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(list(grads))))

    @torch.no_grad()
    def update(self, grads: Sequence[Optional[torch.Tensor]],
               trainable: Sequence[bool]) -> torch.Tensor:
        """One step. ``grads[i]`` is parameter i's gradient (None for 0);
        ``trainable[i]`` is its mask (1 or 0). A masked parameter keeps its
        value, and its moments decay as on a zero gradient. Returns the
        global norm of the masked gradients before clipping."""
        idx = [i for i, on in enumerate(trainable) if on]
        g = [grads[i] if grads[i] is not None
             else torch.zeros_like(self.params[i]) for i in idx]
        g_norm = self.global_norm(g)
        if g:
            # optax: select(|g| < max_norm, g, (g / |g|) * max_norm), kept on
            # the device; dividing and multiplying by 1 is exact
            clip = ~(g_norm < self.max_grad_norm)
            one = torch.ones_like(g_norm)
            g = torch._foreach_div(g, torch.where(clip, g_norm, one))
            torch._foreach_mul_(g, torch.where(
                clip, torch.full_like(g_norm, self.max_grad_norm), one))
        self.count += 1
        b1, b2 = self.b1, self.b2
        frozen = [i for i, on in enumerate(trainable) if not on]
        # a zero gradient adds exactly 0 to b * moment
        if frozen:
            torch._foreach_mul_([self.mu[i] for i in frozen], b1)
            torch._foreach_mul_([self.nu[i] for i in frozen], b2)
        if not idx:
            return g_norm
        mu = [self.mu[i] for i in idx]
        nu = [self.nu[i] for i in idx]
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1.0 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        # bias corrections in float32, as optax computes them
        n = np.float32(self.count)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** n)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** n)
        u = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(u, den)
        torch._foreach_mul_(u, -self.lr)
        torch._foreach_add_([self.params[i] for i in idx], u)
        return g_norm

    def reset(self) -> None:
        """Fresh moments and count; the learning rate stays."""
        self.count = 0
        for t in self.mu + self.nu:
            t.zero_()

    def state_dict(self) -> dict:
        return {"count": self.count, "lr": self.lr,
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, sd: Mapping) -> None:
        if set(sd["mu"]) != set(self.names) or set(sd["nu"]) != set(
                self.names):
            raise KeyError("optimizer state does not match the parameters")
        self.count = int(sd["count"])
        self.lr = _f32(sd["lr"])
        for i, n in enumerate(self.names):
            self.mu[i].copy_(sd["mu"][n])
            self.nu[i].copy_(sd["nu"][n])


@dataclass
class TrainState:
    """The model (its parameters), the optimizer state, the generator the
    steps draw their sample noise from, and the number of steps taken."""
    model: torch.nn.Module
    optimizer: Adam
    generator: torch.Generator
    step: int = 0


def make_optimizer(cfg: MarionetteConfig, model: torch.nn.Module) -> Adam:
    return Adam(dict(model.named_parameters()), cfg.max_grad_norm, cfg.lrate)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the learning rate (float32), once per epoch."""
    state.optimizer.lr = _f32(lr)
    return state


def make_update_mask(names, detector_active: bool, learner_active: bool,
                     affinity_active: bool) -> dict[str, float]:
    """0/1 per parameter name of the port's ``state_dict``: which
    parameters receive updates this phase."""
    def mask(name: str) -> float:
        parts = name.split(".")
        if "offset_param" in parts:
            return 0.0  # never trained (hsvrnn_bvh.py:64-65)
        if "affinity_params" in parts and not affinity_active:
            return 0.0  # affinity anneal gate (kypt_detector.py:71-78)
        if parts[0] == "kypt_detector":
            return 1.0 if detector_active else 0.0
        if parts[0] == "dyna_module":
            return 1.0 if learner_active else 0.0
        return 1.0

    return {n: mask(n) for n in names}


def create_train_state(cfg: MarionetteConfig, model: torch.nn.Module,
                       generator: torch.Generator) -> TrainState:
    return TrainState(model=model, optimizer=make_optimizer(cfg, model),
                      generator=generator, step=0)


def reset_optimizer(cfg: MarionetteConfig, state: TrainState) -> TrainState:
    """Fresh Adam moments, keeping the parameters, generator, step and the
    current learning rate: the reference's recreate-the-optimizer-every-
    epoch semantics (train.py:366-374), for ``cfg.opt_reset_per_epoch``."""
    state.optimizer.reset()
    return state
