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
  epilogue (per frame, brick and channel); on the CPU the same sums in
  plain PyTorch;
* a small reduce to per-(frame, group) ``mean`` and ``var = E[y^2] -
  mean^2`` in float32 (unclamped), PyTorch on both devices;
* pass 2 — ``((y - mean) * rsqrt(var + eps)) * scale + bias`` in float32
  on the stored y, LeakyReLU, one rounding to x's dtype: one read and one
  write of y. On a card kernel ``csrc/groupnorm.cu`` (the one fused pass
  that XLA makes of it in the JAX package), on the CPU
  :func:`normalize_plain`, PyTorch's elementwise ops in the same order.

Like the JAX package, the models do not route through it: its entry is
:func:`fused_stage` itself. :func:`reference_stage` is the JAX package's
oracle (the library's conv, then GroupNorm in two passes).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels
from . import conv3d as K3

LEAKY_SLOPE = 0.01

launches = 0        # calls of :func:`fused_stage` that launched its kernels
pass2_launches = 0  # launches of the pass-2 kernel (:func:`normalize`)


def _groups(Cout: int, ngroups: Optional[int]) -> int:
    ngroups = max(Cout // 16, 1) if ngroups is None else ngroups
    if Cout % ngroups:
        raise ValueError(f"fused_stage: {Cout} channels do not split into "
                         f"{ngroups} groups")
    return ngroups


def group_stats(s: torch.Tensor, q: torch.Tensor, ngroups: int, n: float,
                eps: float):
    """The reduce: s / q ``(F, C)`` per-channel float32 sums of the
    unrounded y and of its squares over ``n / (C / ngroups)`` voxels ->
    (mean, rsqrt(var + eps)), each ``(F, C)`` float32, the group's value
    repeated over its channels."""
    Fr, C = s.shape
    Cg = C // ngroups
    mean = s.reshape(Fr, ngroups, Cg).sum(-1) / n
    var = q.reshape(Fr, ngroups, Cg).sum(-1) / n - mean * mean
    inv = torch.rsqrt(var + eps)
    return (mean.repeat_interleave(Cg, dim=1).contiguous(),
            inv.repeat_interleave(Cg, dim=1).contiguous())


def normalize_plain(y: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of pass 2 (any device): y ``(F, D, H, W, C)``
    as stored, mean / inv ``(F, C)`` from :func:`group_stats`."""
    z = y.to(torch.float32, copy=True)   # in place below: one float32 temp
    z.sub_(mean[:, None, None, None, :]).mul_(inv[:, None, None, None, :])
    z.mul_(scale.float()).add_(bias.float())
    return F.leaky_relu_(z, LEAKY_SLOPE).to(y.dtype)


def normalize(y: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
              scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Pass 2: kernel ``csrc/groupnorm.cu`` for a CUDA y (float32 or
    bfloat16), :func:`normalize_plain` for a CPU y. The output has y's
    dtype and memory layout."""
    global pass2_launches
    if y.device.type == "cpu":
        return normalize_plain(y, mean, inv, scale, bias)
    if y.device.type != "cuda":
        raise ValueError(f"normalize kernel: unsupported device {y.device}")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"normalize kernel: y must be float32 or bfloat16, "
                        f"got {y.dtype}")
    Fr, D, H, W, C = y.shape
    mean, inv, scale, bias = (t.to(device=y.device, dtype=torch.float32)
                              .contiguous()
                              for t in (mean, inv, scale, bias))
    if mean.shape != (Fr, C) or inv.shape != (Fr, C) or \
            scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"normalize kernel: mean {tuple(mean.shape)}, inv "
                         f"{tuple(inv.shape)}, scale {tuple(scale.shape)}, "
                         f"bias {tuple(bias.shape)} for y {tuple(y.shape)}")
    out = torch.empty_like(y)   # y's memory layout
    lib = kernels.library("groupnorm")
    code = lib.nm_groupnorm_act(
        kernels.ptr(y), int(y.dtype == torch.bfloat16), kernels.ptr(out),
        kernels.ptr(mean), kernels.ptr(inv), kernels.ptr(scale),
        kernels.ptr(bias), Fr, D, H, W, C, *y.stride(), *out.stride(),
        y.device.index, kernels.stream_handle(y.device))
    kernels.check(lib, code, "normalize kernel")
    pass2_launches += 1
    return out


def _normalize(y: torch.Tensor, s: torch.Tensor, q: torch.Tensor,
               scale: torch.Tensor, bias: torch.Tensor, ngroups: int,
               eps: float) -> torch.Tensor:
    """Reduce and pass 2 in plain PyTorch: y ``(F, D, H, W, C)`` as stored,
    s / q ``(F, C)`` per-channel float32 sums of the unrounded y and of its
    squares."""
    Fr, D, H, W, C = y.shape
    mean, inv = group_stats(s, q, ngroups, float(D * H * W * (C // ngroups)),
                            eps)
    return normalize_plain(y, mean, inv, scale, bias)


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
    run kernel K4: pass 1 (``csrc/conv3d.cu`` with its stats epilogue), the
    reduce, pass 2 (``csrc/groupnorm.cu``); CPU tensors
    :func:`fused_stage_plain`."""
    global launches
    if x.device.type == "cpu":
        return fused_stage_plain(x, w, b, scale, bias, ngroups, eps)
    ngroups = _groups(w.shape[4], ngroups)
    y, part = K3._launch(x, w, b, stats=True,
                         packed=K3.packed_operands(w, b))
    launches += 1
    Fr, D, H, W, C = y.shape
    tot = part.sum(dim=1)                      # (F, 2, Cout), in brick order
    mean, inv = group_stats(tot[:, 0], tot[:, 1], ngroups,
                            float(D * H * W * (C // ngroups)), eps)
    return normalize(y, mean, inv, scale, bias)


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
