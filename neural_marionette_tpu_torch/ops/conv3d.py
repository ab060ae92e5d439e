"""SAME-padded odd cubic 3D convolution plus bias; carries kernel K3.

Counterpart of ``neural_marionette_tpu/ops/pallas/conv3d_kernel.py``
(``conv3d_pallas``), in its layout: x ``(F, D, H, W, Cin)``, w ``(k, k, k,
Cin, Cout)``, b ``(Cout,)`` -> ``(F, D, H, W, Cout)`` in x's dtype. The
operands are rounded to bfloat16, the products summed in float32, b rounded
to bfloat16 and added in float32, and the sum rounded once to x's dtype.

* :func:`conv3d` — an autograd function. Forward: kernel ``csrc/conv3d.cu``
  for a CUDA tensor, :func:`conv3d_plain` for a CPU tensor. Backward: the
  JAX package's ``_bwd`` with PyTorch's convolution gradients in place of
  XLA's convs (dx in x's dtype, dw cast to w's dtype, db the sum of g cast
  to w's dtype).
* :func:`conv3d_plain` — the kernel's arithmetic in plain PyTorch.

The tensors are addressed through their strides: a logical NDHWC view of
the port's NCDHW activations (``x.permute(0, 2, 3, 4, 1)``) goes to the
kernel without a copy, and the output comes back in the same memory
layout as x.

The models route a conv here with ``conv_kernel=True``
(``models/blocks.conv``), the counterpart of the JAX package's
``NM_PALLAS_CONV=1``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels

launches = 0  # kernel launches of :func:`conv3d`


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           name: str = "conv3d") -> int:
    """Validate shapes and devices; returns the kernel size."""
    if x.ndim != 5 or w.ndim != 5 or b.ndim != 1:
        raise ValueError(f"{name}: x (F, D, H, W, Cin), w (k, k, k, Cin, "
                         f"Cout), b (Cout,); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    k = w.shape[0]
    if w.shape[:3] != (k, k, k) or k % 2 == 0:
        raise ValueError(f"{name}: the kernel must be cubic and odd, got "
                         f"{tuple(w.shape[:3])}")
    if w.shape[3] != x.shape[4] or b.shape[0] != w.shape[4]:
        raise ValueError(f"{name}: channels of x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} and b {tuple(b.shape)} disagree")
    if not (x.is_floating_point() and w.is_floating_point()
            and b.is_floating_point()):
        raise TypeError(f"{name}: x, w and b must be floating point")
    if not (x.device == w.device == b.device):
        raise ValueError(f"{name}: x, w and b on different devices")
    return k


def _conv_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    """The convolution of the bf16-rounded operands plus the bf16-rounded
    bias, in float32, before the final rounding: ``(F, D, H, W, Cout)``.
    bf16 values are exact in float32 (and in TF32), so only the order of the
    float32 sums differs from the kernel's."""
    k = w.shape[0]
    bf = torch.bfloat16
    xf = x.to(bf).float().permute(0, 4, 1, 2, 3)
    wf = w.to(bf).float().permute(4, 3, 0, 1, 2)
    y = F.conv3d(xf, wf, padding=k // 2)
    y = y + b.to(bf).float()[:, None, None, None]
    return y.permute(0, 2, 3, 4, 1)


def conv3d_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device): one rounding of
    :func:`_conv_f32` to x's dtype."""
    _check(x, w, b, "conv3d_plain")
    return _conv_f32(x, w, b).to(x.dtype)


def _channels_first(x: torch.Tensor) -> bool:
    """Is the logical (F, D, H, W, C) tensor x an NCDHW-dense one?"""
    return x.permute(0, 4, 1, 2, 3).is_contiguous()


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            stats: bool = False):
    """Run the kernel on CUDA tensors: ``y`` (and, with ``stats``, the
    per-(frame, voxel tile, channel) sums and sums of squares of the float32
    outputs, ``(F, tiles, 2, Cout)``, else None). y has x's memory layout
    (NCDHW-dense or NDHWC-dense)."""
    k = _check(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d kernel: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3d kernel: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    Fr, D, H, W, Cin = x.shape
    Cout = w.shape[4]
    if Fr > 65535:
        raise ValueError(f"conv3d kernel: at most 65535 frames, got {Fr}")
    lib = kernels.library("conv3d")
    tile_m, tile_k = lib.nm_conv3d_tile_m(), lib.nm_conv3d_tile_k()
    bn = 64 if Cout % 64 == 0 else 32
    cin_pad = -(-Cin // tile_k) * tile_k
    cout_pad = -(-Cout // bn) * bn
    wp = w.to(torch.bfloat16).reshape(k ** 3, Cin, Cout)
    if (cin_pad, cout_pad) != (Cin, Cout):
        wp = F.pad(wp, (0, cout_pad - Cout, 0, cin_pad - Cin))
    wp = wp.contiguous()
    bias = b.to(torch.bfloat16).contiguous()
    if _channels_first(x):
        y = torch.empty((Fr, Cout, D, H, W), dtype=x.dtype,
                        device=x.device).permute(0, 2, 3, 4, 1)
    else:
        y = torch.empty((Fr, D, H, W, Cout), dtype=x.dtype, device=x.device)
    part = None
    if stats:
        tiles = -(-(D * H * W) // tile_m)
        part = torch.empty((Fr, tiles, 2, Cout), dtype=torch.float32,
                           device=x.device)
    code = lib.nm_conv3d(
        kernels.ptr(x), int(x.dtype == torch.bfloat16), kernels.ptr(wp),
        kernels.ptr(bias), kernels.ptr(y),
        None if part is None else kernels.ptr(part),
        Fr, D, H, W, Cin, Cout, k, *x.stride(), *y.stride(), cin_pad,
        cout_pad, bn, x.device.index, kernels.stream_handle(x.device))
    kernels.check(lib, code, "conv3d kernel")
    return y, part


def _forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    global launches
    if x.device.type == "cpu":
        return conv3d_plain(x, w, b)
    y, _ = _launch(x, w, b)
    launches += 1
    return y


class _Conv3d(torch.autograd.Function):
    """``conv3d_pallas``'s custom VJP (``conv3d_kernel.py:157-185``)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return _forward(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        pad = w.shape[0] // 2
        xc = x.permute(0, 4, 1, 2, 3)                  # NCDHW views
        gc = g.to(x.dtype).permute(0, 4, 1, 2, 3)
        w_oi = w.permute(4, 3, 0, 1, 2)                # (Cout, Cin, k, k, k)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            # the conv of g with the flipped, io-swapped kernel, in x's dtype
            dx = torch.nn.grad.conv3d_input(
                xc.shape, w_oi.to(x.dtype), gc,
                padding=pad).permute(0, 2, 3, 4, 1)
        if ctx.needs_input_grad[1]:
            # the correlation of x with g in x's dtype: for bf16 x the
            # products are exact in float32 and the library sums in
            # float32, so this is JAX's float32 correlation up to the order
            # of its sums, rounded once to w's dtype
            dw = torch.nn.grad.conv3d_weight(
                xc, w_oi.shape, gc, padding=pad).permute(2, 3, 4, 1, 0)
            dw = dw.to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 1, 2, 3), dtype=torch.float32).to(w.dtype)
        return dx, dw, db


def conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """``(F, D, H, W, Cin)`` x, ``(k, k, k, Cin, Cout)`` w (k odd),
    ``(Cout,)`` b -> ``(F, D, H, W, Cout)`` in x's dtype (float32 or
    bfloat16 on a card). CUDA tensors run kernel K3, CPU tensors the plain
    version; both are differentiable."""
    return _Conv3d.apply(x, w, b)
