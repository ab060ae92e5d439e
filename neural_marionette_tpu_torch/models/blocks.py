"""3D conv building blocks, NCDHW, plain path.

Counterpart of ``neural_marionette_tpu/models/blocks.py`` (the reference's
``modules/vox_modules.py``). Module attribute names follow the reference's
``state_dict`` keys, so reference and JAX weights map onto them
(``weights.py``). Semantics carried over:

* convolutions compute in ``dtype`` (weights and input cast to it);
  GroupNorm(C // 16 groups, eps 1e-5) computes in and returns float32, as
  flax promotes against its float32 scale;
* LeakyReLU slope 0.01;
* the output of :class:`Res3DBlock` is the identity of ``res + skip``
  (upstream ``F.leaky_relu(x, True)`` sets slope 1.0);
* :class:`Upsample3DBlock` pads with ``output_padding`` before its
  block-level bias, which is added in float32.

With ``conv_kernel=True`` (the counterpart of the JAX package's
``NM_PALLAS_CONV=1``) every conv that :func:`routes_to_kernel` accepts goes
through kernel K3 (``ops/conv3d``) instead of ``F.conv3d``.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import conv3d as K3

LEAKY_SLOPE = 0.01


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


def num_groups(C: int) -> int:
    return max(C // 16, 1)


def group_norm(C: int, device=None) -> nn.GroupNorm:
    return nn.GroupNorm(num_groups(C), C, eps=1e-5, device=device)


def routes_to_kernel(m: nn.Conv3d, dtype: torch.dtype) -> bool:
    """The conv route's predicate: the JAX package's
    ``_pallas_conv_applicable`` (``models/blocks.py`` there) without its
    backend test. A cubic odd kernel of 3 or more, stride 1, SAME padding,
    a bias, bfloat16 compute and at least 32 input channels."""
    k = m.kernel_size
    return (dtype == torch.bfloat16 and m.in_channels >= 32
            and len(set(k)) == 1 and k[0] % 2 == 1 and k[0] >= 3
            and m.stride == (1, 1, 1) and m.padding == (k[0] // 2,) * 3
            and m.dilation == (1, 1, 1) and m.groups == 1
            and m.padding_mode == "zeros" and m.bias is not None)


def conv(m: nn.Conv3d, x: torch.Tensor, dtype: torch.dtype,
         kernel: bool = False) -> torch.Tensor:
    """``m``'s convolution with input, weight and bias in ``dtype``; with
    ``kernel``, through kernel K3 where :func:`routes_to_kernel` allows. The
    kernel takes the NCDHW activation as a logical NDHWC view and returns
    NCDHW memory, so the route adds no layout copy. On a card it reads the
    weight packed once per parameter version (``K3.packed_operands``); where
    no gradient is wanted the casts of w and b are skipped too, since the
    kernel and the plain version round them to bfloat16 themselves."""
    if kernel and routes_to_kernel(m, dtype):
        w, b = m.weight, m.bias
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                        or b.requires_grad):
            w, b = w.to(dtype), b.to(dtype)
        packed = K3.packed_operands(m.weight, m.bias, channels_first=True) \
            if x.is_cuda else None
        y = K3.conv3d(x.to(dtype).permute(0, 2, 3, 4, 1),
                      w.permute(2, 3, 4, 1, 0), b, packed=packed)
        return y.permute(0, 4, 1, 2, 3)
    b = None if m.bias is None else m.bias.to(dtype)
    return F.conv3d(x.to(dtype), m.weight.to(dtype), b, m.stride, m.padding)


def norm(m: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm in float32 (flax promotes against its float32 scale; a
    float64 module, as the float64 reference runs build, stays float64)."""
    return F.group_norm(x.to(torch.promote_types(x.dtype, m.weight.dtype)),
                        m.num_groups, m.weight, m.bias, m.eps)


class Basic3DBlock(nn.Module):
    """Conv3d(k, same) -> GroupNorm -> LeakyReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 dtype=torch.float32, device=None, conv_kernel: bool = False):
        super().__init__()
        self.dtype = dtype
        self.conv_kernel = conv_kernel
        self.block = nn.Sequential(
            nn.Conv3d(in_ch, out_ch, kernel_size, padding=kernel_size // 2,
                      device=device),
            group_norm(out_ch, device),
            nn.LeakyReLU(LEAKY_SLOPE))

    def forward(self, x):
        return leaky_relu(norm(self.block[1], conv(self.block[0], x,
                                                   self.dtype,
                                                   self.conv_kernel)))


class Res3DBlock(nn.Module):
    """2x(Conv3 + GN) residual, 1x1 (+GN) skip projection when the width
    changes; identity output activation."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32,
                 device=None, conv_kernel: bool = False):
        super().__init__()
        self.dtype = dtype
        self.conv_kernel = conv_kernel
        self.res_branch = nn.Sequential(
            nn.Conv3d(in_ch, out_ch, 3, padding=1, device=device),
            group_norm(out_ch, device),
            nn.LeakyReLU(LEAKY_SLOPE),
            nn.Conv3d(out_ch, out_ch, 3, padding=1, device=device),
            group_norm(out_ch, device))
        if in_ch == out_ch:
            self.skip_con = nn.Sequential()
        else:
            self.skip_con = nn.Sequential(
                nn.Conv3d(in_ch, out_ch, 1, device=device),
                group_norm(out_ch, device))

    def forward(self, x):
        r, ck = self.res_branch, self.conv_kernel
        res = leaky_relu(norm(r[1], conv(r[0], x, self.dtype, ck)))
        res = norm(r[4], conv(r[3], res, self.dtype, ck))
        if len(self.skip_con) == 0:
            skip = x
        else:
            skip = norm(self.skip_con[1], conv(self.skip_con[0], x,
                                               self.dtype))
        return res + skip


class Pool3DBlock(nn.Module):
    """Strided-conv downsample (kernel = stride = pool) + GN + LeakyReLU."""

    def __init__(self, channels: int, pool_size: int = 2,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.stride_conv = nn.Sequential(
            nn.Conv3d(channels, channels, pool_size, stride=pool_size,
                      device=device),
            group_norm(channels, device),
            nn.LeakyReLU(LEAKY_SLOPE))

    def forward(self, x):
        s = self.stride_conv
        return leaky_relu(norm(s[1], conv(s[0], x, self.dtype)))


class Upsample3DBlock(nn.Module):
    """ConvTranspose3d(k=2, s=2) + GN + LeakyReLU, with torch-style
    ``output_padding``; the extra plane gets the bias only."""

    def __init__(self, in_ch: int, out_ch: int, output_padding: int = 0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.output_padding = output_padding
        self.block = nn.Sequential(
            nn.ConvTranspose3d(in_ch, out_ch, 2, stride=2,
                               output_padding=output_padding, device=device),
            group_norm(out_ch, device),
            nn.LeakyReLU(LEAKY_SLOPE))

    def forward(self, x):
        ct = self.block[0]
        y = F.conv_transpose3d(x.to(self.dtype), ct.weight.to(self.dtype),
                               None, stride=2,
                               output_padding=self.output_padding)
        y = y + ct.bias.view(1, -1, 1, 1, 1)  # float32 bias promotes
        return leaky_relu(norm(self.block[1], y))


class Hourglass(nn.Module):
    """3-level 3D hourglass with residual skip paths (reference ``HG``).
    ``N`` is the input spatial size, used only for the decoder's
    ``output_padding`` on grids that are not powers of two."""

    def __init__(self, in_ch: int, out_ch: int, N: int, dtype=torch.float32,
                 device=None, conv_kernel: bool = False):
        super().__init__()
        pad = [(N // 4) % 2, (N // 2) % 2, N % 2]
        kw = dict(dtype=dtype, device=device)
        rk = dict(kw, conv_kernel=conv_kernel)
        self.skip_res1 = Res3DBlock(in_ch, out_ch, **rk)
        self.encoder_pool1 = Pool3DBlock(in_ch, 2, **kw)
        self.encoder_res1 = Res3DBlock(in_ch, 32, **rk)
        self.skip_res2 = Res3DBlock(32, 32, **rk)
        self.encoder_pool2 = Pool3DBlock(32, 2, **kw)
        self.encoder_res2 = Res3DBlock(32, 48, **rk)
        self.skip_res3 = Res3DBlock(48, 48, **rk)
        self.encoder_pool3 = Pool3DBlock(48, 2, **kw)
        self.encoder_res3 = Res3DBlock(48, 72, **rk)
        self.decoder_res3 = Res3DBlock(72, 72, **rk)
        self.decoder_upsample3 = Upsample3DBlock(72, 48, pad[0], **kw)
        self.decoder_res2 = Res3DBlock(48, 48, **rk)
        self.decoder_upsample2 = Upsample3DBlock(48, 32, pad[1], **kw)
        self.decoder_res1 = Res3DBlock(32, 32, **rk)
        self.decoder_upsample1 = Upsample3DBlock(32, out_ch, pad[2], **kw)

    def forward(self, x):
        skip1 = self.skip_res1(x)
        x = self.encoder_pool1(x)
        x = self.encoder_res1(x)
        skip2 = self.skip_res2(x)
        x = self.encoder_pool2(x)
        x = self.encoder_res2(x)
        skip3 = self.skip_res3(x)
        x = self.encoder_pool3(x)
        x = self.encoder_res3(x)

        x = self.decoder_res3(x)
        x = self.decoder_upsample3(x) + skip3
        x = self.decoder_res2(x)
        x = self.decoder_upsample2(x) + skip2
        x = self.decoder_res1(x)
        return self.decoder_upsample1(x) + skip1
