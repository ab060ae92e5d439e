"""Fused decoder stage: conv3d + GroupNorm + LeakyReLU; carries kernel K4.

Counterpart of ``neural_marionette_tpu/ops/pallas/fusedstage_kernel.py``:
``leaky_relu_0.01(GN_{ngroups, eps}(conv3d(x, w) + b) * scale + bias)``,
forward only, x ``(F, D, H, W, Cin)``, w ``(k, k, k, Cin, Cout)``, b /
scale / bias ``(Cout,)`` -> ``(F, D, H, W, Cout)`` in x's dtype, ngroups
``Cout // 16`` by default.

Its order of rounding, as there:

* pass 1 — K3's convolution (bf16 operands, float32 sums, bias in float32)
  storing y in x's dtype, and the moments of the float32 y BEFORE that
  rounding. On a card this is kernel ``csrc/conv3d.cu`` with its stats
  epilogue (per frame, voxel tile and channel); on the CPU the same sums in
  plain PyTorch;
* a small reduce to per-(frame, group) ``mean`` and ``var = E[y^2] -
  mean^2`` in float32 (unclamped);
* pass 2 — ``((y - mean) * rsqrt(var + eps)) * scale + bias`` in float32
  on the stored y, LeakyReLU, one rounding to x's dtype. Plain PyTorch
  elementwise ops on both devices, as the JAX package leaves pass 2 to XLA.

Like the JAX package, the models do not route through it: its entry is
:func:`fused_stage` itself. :func:`reference_stage` is the JAX package's
oracle (the library's conv, then GroupNorm in two passes).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import conv3d as K3

LEAKY_SLOPE = 0.01

launches = 0  # kernel launches of :func:`fused_stage`


def _groups(Cout: int, ngroups: Optional[int]) -> int:
    ngroups = max(Cout // 16, 1) if ngroups is None else ngroups
    if Cout % ngroups:
        raise ValueError(f"fused_stage: {Cout} channels do not split into "
                         f"{ngroups} groups")
    return ngroups


def _normalize(y: torch.Tensor, s: torch.Tensor, q: torch.Tensor,
               scale: torch.Tensor, bias: torch.Tensor, ngroups: int,
               eps: float) -> torch.Tensor:
    """Reduce and pass 2: y ``(F, D, H, W, C)`` as stored, s / q ``(F, C)``
    per-channel float32 sums of the unrounded y and of its squares."""
    Fr, D, H, W, C = y.shape
    Cg = C // ngroups
    n = float(D * H * W * Cg)
    mean = s.reshape(Fr, ngroups, Cg).sum(-1) / n
    var = q.reshape(Fr, ngroups, Cg).sum(-1) / n - mean * mean
    inv = torch.rsqrt(var + eps)
    mu_c = mean.repeat_interleave(Cg, dim=1)[:, None, None, None, :]
    inv_c = inv.repeat_interleave(Cg, dim=1)[:, None, None, None, :]
    z = y.to(torch.float32, copy=True)   # in place below: one float32 temp
    z.sub_(mu_c).mul_(inv_c).mul_(scale.float()).add_(bias.float())
    return F.leaky_relu_(z, LEAKY_SLOPE).to(y.dtype)


def fused_stage_plain(x, w, b, scale, bias, ngroups: Optional[int] = None,
                      eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_stage` (any device), in its
    order of rounding."""
    K3._check(x, w, b, "fused_stage_plain")
    ngroups = _groups(w.shape[4], ngroups)
    yf = K3._conv_f32(x, w, b)
    s = yf.sum(dim=(1, 2, 3))
    q = (yf * yf).sum(dim=(1, 2, 3))
    return _normalize(yf.to(x.dtype), s, q, scale, bias, ngroups, eps)


def fused_stage(x, w, b, scale, bias, ngroups: Optional[int] = None,
                eps: float = 1e-5) -> torch.Tensor:
    """leaky_relu(group_norm(conv3d(x, w) + b)), forward only. CUDA tensors
    run kernel K4's pass 1 (``csrc/conv3d.cu`` with its stats epilogue),
    CPU tensors :func:`fused_stage_plain`."""
    global launches
    if x.device.type == "cpu":
        return fused_stage_plain(x, w, b, scale, bias, ngroups, eps)
    ngroups = _groups(w.shape[4], ngroups)
    y, part = K3._launch(x, w, b, stats=True)
    launches += 1
    tot = part.sum(dim=1)                      # (F, 2, Cout), in tile order
    return _normalize(y, tot[:, 0], tot[:, 1], scale, bias, ngroups, eps)


def reference_stage(x, w, b, scale, bias, ngroups: Optional[int] = None,
                    eps: float = 1e-5) -> torch.Tensor:
    """The JAX package's ``reference_stage``: the library conv in x's dtype,
    plus b in x's dtype, GroupNorm in float32 in two passes, LeakyReLU."""
    K3._check(x, w, b, "reference_stage")
    Fr, D, H, W, _ = x.shape
    k, Cout = w.shape[0], w.shape[4]
    ngroups = _groups(Cout, ngroups)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3),
                 w.to(x.dtype).permute(4, 3, 0, 1, 2), padding=k // 2)
    y = y.permute(0, 2, 3, 4, 1) + b.to(x.dtype)
    yf = y.float().reshape(Fr, D, H, W, ngroups, Cout // ngroups)
    mean = yf.mean(dim=(1, 2, 3, 5), keepdim=True)
    var = ((yf - mean) ** 2).mean(dim=(1, 2, 3, 5), keepdim=True)
    z = (yf - mean) * torch.rsqrt(var + eps)
    z = z.reshape(Fr, D, H, W, Cout) * scale.float() + bias.float()
    return torch.where(z >= 0, z, z * LEAKY_SLOPE).to(x.dtype)
