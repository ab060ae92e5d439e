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
* :func:`pack_weight` / :func:`packed_operands` — the weight in the
  kernel's layout, and a cache of it per parameter version, so that a
  serving window packs nothing and a training step packs each weight once.

The tensors are addressed through their strides: a logical NDHWC view of
the port's NCDHW activations (``x.permute(0, 2, 3, 4, 1)``) goes to the
kernel without a copy, and the output comes back in the same memory
layout as x.

The kernel's tiling, mirrored here so that the CPU tests reach it: K
chunks of ``CHUNK`` input channels; an N tile of :func:`tile_n` output
channels; bricks of :func:`brick` = (z, 8, x) output voxels, one block each
(the stats partials of K4's pass 1 come per brick, :func:`stats_tiles`).

The models route a conv here with ``conv_kernel=True``
(``models/blocks.conv``), the counterpart of the JAX package's
``NM_PALLAS_CONV=1``.
"""
from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F

from .. import kernels

launches = 0  # kernel launches of :func:`conv3d`

CHUNK = 32        # input channels per K chunk (csrc/conv3d.cu CK)
BRICK_Y = 8       # brick rows; a 64-row wgmma tile is 8 rows x 8 columns
# brick (planes, columns) per N tile width (csrc/conv3d.cu Tile<NT>)
_BRICK = {32: (4, 16), 64: (4, 8), 128: (2, 8)}


def tile_n(cout: int) -> int:
    """Output channels per N tile: the narrowest of 32, 64 and 128 that
    holds ``cout`` (a Cout of 256 takes two tiles of 128)."""
    return 32 if cout <= 32 else 64 if cout <= 64 else 128


def brick(cout: int) -> tuple[int, int, int]:
    """(z, y, x) output voxels of a brick for ``cout`` output channels."""
    zt, bx = _BRICK[tile_n(cout)]
    return zt, BRICK_Y, bx


def stats_tiles(D: int, H: int, W: int, cout: int) -> int:
    """Bricks of one frame: the second axis of the stats partials."""
    zt, by, bx = brick(cout)
    return -(-D // zt) * -(-H // by) * -(-W // bx)


def brick_partials_plain(yf: torch.Tensor) -> torch.Tensor:
    """Plain version of the stats epilogue's layout: ``yf`` (F, D, H, W, C)
    float32 -> (F, bricks, 2, C), per brick (in the kernel's order: x
    fastest, then y, then z) the sum and sum of squares of its voxels in
    the grid."""
    Fr, D, H, W, C = yf.shape
    zt, by, bx = brick(C)
    nz, ny, nx = -(-D // zt), -(-H // by), -(-W // bx)
    v = F.pad(yf, (0, 0, 0, nx * bx - W, 0, ny * by - H, 0, nz * zt - D))
    v = v.reshape(Fr, nz, zt, ny, by, nx, bx, C).permute(0, 1, 3, 5, 7, 2, 4,
                                                          6)
    v = v.reshape(Fr, nz * ny * nx, C, -1)
    return torch.stack((v.sum(-1), (v * v).sum(-1)), dim=2)


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """w ``(k, k, k, Cin, Cout)`` -> the kernel's B operand, bfloat16
    ``(ceil(Cout / nt), k^3, cin_pad / 8, nt, 8)``, contiguous, zero beyond
    (Cin, Cout): per (N tile, tap, 8 input channels) the nt output channels'
    8 weights, 16 bytes each, as the tensor cores read them."""
    k, cin, cout = w.shape[0], w.shape[3], w.shape[4]
    nt = tile_n(cout)
    cin_pad = -(-cin // CHUNK) * CHUNK
    ntiles = -(-cout // nt)
    wb = w.detach().to(torch.bfloat16).reshape(k ** 3, cin, cout)
    wb = F.pad(wb, (0, ntiles * nt - cout, 0, cin_pad - cin))
    wb = wb.reshape(k ** 3, cin_pad // 8, 8, ntiles, nt)
    return wb.permute(3, 0, 1, 4, 2).contiguous()


_PACKED: dict[int, tuple] = {}   # id(weight) -> (refs, key, packed)


def _version_key(t: torch.Tensor):
    return (t._version, t.data_ptr(), t.device)


def packed_operands(weight: torch.Tensor, bias: torch.Tensor,
                    channels_first: bool = False):
    """(packed weight, bias in bfloat16) of a conv for the kernel, cached
    per version of the two parameters: a repeat call with parameters that
    have not changed returns the same tensors; an in-place update (an
    optimizer step, ``copy_``, ``load_state_dict``) bumps the version and
    repacks. ``weight`` is ``(k, k, k, Cin, Cout)``, or with
    ``channels_first`` an ``nn.Conv3d``'s ``(Cout, Cin, k, k, k)``. The key
    is the parameter itself, never a cast of it (under
    ``torch.inference_mode`` a cast has no version counter); an inference
    tensor is packed anew on every call."""
    def pack():
        w = weight.permute(2, 3, 4, 1, 0) if channels_first else weight
        return pack_weight(w), bias.detach().to(torch.bfloat16).contiguous()

    if weight.is_inference() or bias.is_inference():
        return pack()
    wid = id(weight)
    key = (_version_key(weight), _version_key(bias), channels_first)
    hit = _PACKED.get(wid)
    if hit is not None and hit[0][0]() is weight and hit[0][1]() is bias \
            and hit[1] == key:
        return hit[2]
    packed = pack()
    refs = (weakref.ref(weight, lambda _, i=wid: _PACKED.pop(i, None)),
            weakref.ref(bias))
    _PACKED[wid] = (refs, key, packed)
    return packed


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


_checked = []   # the library whose tiling matched this module's


def _library():
    """The kernel's library, its tiling checked against this module's once
    per load."""
    lib = kernels.library("conv3d")
    if lib not in _checked:
        tiling = (lib.nm_conv3d_chunk(),
                  {nt: (lib.nm_conv3d_brick_z(nt), lib.nm_conv3d_brick_x(nt))
                   for nt in _BRICK})
        if tiling != (CHUNK, _BRICK):
            raise RuntimeError(f"conv3d kernel: the library's tiling "
                               f"{tiling} differs from ops/conv3d.py's")
        _checked.append(lib)
    return lib


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            stats: bool = False, packed=None):
    """Run the kernel on CUDA tensors: ``y`` (and, with ``stats``, the
    per-(frame, brick, channel) sums and sums of squares of the float32
    outputs, ``(F, stats_tiles(D, H, W, Cout), 2, Cout)``, else None). y has
    x's dtype and memory layout (NCDHW-dense or NDHWC-dense). ``packed`` is
    :func:`packed_operands`' pair for (w, b), or None to pack here."""
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
    nt = tile_n(Cout)
    cin_pad = -(-Cin // CHUNK) * CHUNK
    wp, bias = (pack_weight(w), b.to(torch.bfloat16).contiguous()) \
        if packed is None else packed
    want = (-(-Cout // nt), k ** 3, cin_pad // 8, nt, 8)
    if tuple(wp.shape) != want or wp.dtype != torch.bfloat16 or \
            not wp.is_contiguous() or wp.device != x.device or \
            tuple(bias.shape) != (Cout,) or bias.dtype != torch.bfloat16 or \
            not bias.is_contiguous() or bias.device != x.device:
        raise ValueError(f"conv3d kernel: packed operands {tuple(wp.shape)} "
                         f"{wp.dtype}, {tuple(bias.shape)} {bias.dtype} do "
                         f"not fit x {tuple(x.shape)} and w {tuple(w.shape)}")
    lib = _library()
    # the kernel takes bf16 x (a float32 x is rounded to nearest, as the
    # kernel would); .to keeps the memory layout
    xb = x.to(torch.bfloat16)
    if _channels_first(x):
        y = torch.empty((Fr, Cout, D, H, W), dtype=x.dtype,
                        device=x.device).permute(0, 2, 3, 4, 1)
    else:
        y = torch.empty((Fr, D, H, W, Cout), dtype=x.dtype, device=x.device)
    part = None
    if stats:
        part = torch.empty((Fr, stats_tiles(D, H, W, Cout), 2, Cout),
                           dtype=torch.float32, device=x.device)
    code = lib.nm_conv3d(
        kernels.ptr(xb), kernels.ptr(wp), kernels.ptr(bias), kernels.ptr(y),
        int(y.dtype == torch.float32),
        None if part is None else kernels.ptr(part),
        Fr, D, H, W, Cin, Cout, k, *xb.stride(), *y.stride(), cin_pad, nt,
        x.device.index, kernels.stream_handle(x.device))
    kernels.check(lib, code, "conv3d kernel")
    return y, part


def _forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, packed=None
             ) -> torch.Tensor:
    global launches
    if x.device.type == "cpu":
        return conv3d_plain(x, w, b)
    y, _ = _launch(x, w, b, packed=packed)
    launches += 1
    return y


class _Conv3d(torch.autograd.Function):
    """``conv3d_pallas``'s custom VJP (``conv3d_kernel.py:157-185``)."""

    @staticmethod
    def forward(ctx, x, w, b, packed):
        ctx.save_for_backward(x, w)
        return _forward(x, w, b, packed)

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
        return dx, dw, db, None


def conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, packed=None
           ) -> torch.Tensor:
    """``(F, D, H, W, Cin)`` x, ``(k, k, k, Cin, Cout)`` w (k odd),
    ``(Cout,)`` b -> ``(F, D, H, W, Cout)`` in x's dtype (float32 or
    bfloat16 on a card). CUDA tensors run kernel K3, CPU tensors the plain
    version; both are differentiable. ``packed``, optional, is
    :func:`packed_operands`' pair for the bf16 rounding of (w, b), used by
    the kernel in place of packing w and b on every call; it takes no
    gradient."""
    return _Conv3d.apply(x, w, b, packed)
