"""Detector / graph loss functions; carries kernel K2.

Counterpart of ``neural_marionette_tpu/ops/losses.py``. Layouts are the JAX
package's, channels-last:

* ``seq``:        (B, T, G, G, G, 1)
* ``heatmaps``:   (B, T, g, g, g, K)
* ``keypoints``:  (B, T, K, D+1)
* ``affinity``:   (nneighbor, K, K, 1)

The chamfer numerator of :func:`volume_fitting_loss` goes through
:func:`chamfer_num`, an autograd function: kernel ``csrc/chamfer.cu``
forward and backward for a CUDA tensor, :func:`chamfer_num_plain` and
:func:`chamfer_num_bwd_plain` for a CPU tensor. The denominator stays
outside.
"""
from __future__ import annotations

import functools

import torch

from .. import kernels
from .coords import coord_maps
from .keypoints import render_gaussian_maps_first

_LOG_CLAMP = -100.0  # torch.nn.BCELoss clamps log() at -100

launches = 0      # forward kernel launches of :func:`chamfer_num`
bwd_launches = 0  # backward kernel launches of :func:`chamfer_num`


class _BCE(torch.autograd.Function):
    """``nn.BCELoss`` per element, the reference's loss: the forward with
    its logs clamped at -100, as the JAX package writes it; the backward
    ``g (x - y) / max(x (1 - x), 1e-12)`` in float32, as ``nn.BCELoss``
    differentiates it. Autograd through the clamped logs would give
    ``0 * inf`` = NaN wherever the sharpened sigmoid rounds to exactly 1.0
    (or 0.0), which bfloat16 does (the JAX package's gradient has that NaN;
    ``ROADMAP.md`` Queue 3)."""

    @staticmethod
    def forward(ctx, recon, target):
        ctx.save_for_backward(recon, target)
        log_p = torch.clamp(torch.log(recon), min=_LOG_CLAMP)
        log_1p = torch.clamp(torch.log1p(-recon), min=_LOG_CLAMP)
        return -(target * log_p + (1.0 - target) * log_1p)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        x32 = x.float()
        d = (x32 - y.float()) / torch.clamp(x32 * (1.0 - x32), min=1e-12)
        return (g.float() * d).to(x.dtype), None


def bce_recon_loss(recon: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-(B, T) mean binary cross entropy over channel+spatial dims."""
    nll = _BCE.apply(recon, target)
    return nll.mean(dim=tuple(range(2, nll.ndim)))


def keypoint_sparsity_loss(heatmaps: torch.Tensor) -> torch.Tensor:
    """L1 of spatial-mean heatmap activations, mean over K -> (B, T)."""
    spatial_axes = tuple(range(2, heatmaps.ndim - 1))
    heatmap_mean = heatmaps.mean(dim=spatial_axes)  # (B, T, K)
    return heatmap_mean.abs().mean(dim=2)


def temporal_separation_loss(keypoints: torch.Tensor,
                             sep_sigma: float) -> torch.Tensor:
    """Gaussian penalty on similar displacement trajectories -> (B,)."""
    coords = keypoints[..., :-1]  # (B, T, K, D)
    K = coords.shape[2]
    displacement = coords - coords.mean(dim=1, keepdim=True)
    diff = ((displacement[:, :, :, None] - displacement[:, :, None]) ** 2
            ).sum(dim=-1)  # (B, T, K, K)
    diff = diff.mean(dim=1)
    loss = torch.exp(-diff / (2.0 * sep_sigma ** 2.0))
    loss = loss.sum(dim=(1, 2)) - K
    return loss / (K * (K - 1))


# ------------------------------------------------------------ kernel K2
@functools.lru_cache(maxsize=32)
def _linspace(G: int, device: torch.device) -> torch.Tensor:
    """Per-axis voxel-centre coordinates, exactly ``ops/coords``' grid.
    Cached per grid and device: the kernels' wrappers read it every call."""
    return coord_maps((G,), device=device)[:, 0]


def _check_chamfer(kp: torch.Tensor, occ_flat: torch.Tensor, grid_size: int):
    if kp.dtype != torch.float32:
        raise TypeError(f"chamfer_num: kp must be float32, got {kp.dtype}")
    if occ_flat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"chamfer_num: occupancy must be float32 or "
                        f"bfloat16, got {occ_flat.dtype}")
    if kp.ndim != 3 or kp.shape[-1] != 3:
        raise ValueError(f"chamfer_num: kp must be (M, K, 3), got "
                         f"{tuple(kp.shape)}")
    if occ_flat.shape != (kp.shape[0], grid_size ** 3):
        raise ValueError(f"chamfer_num: occupancy must be (M, G^3) = "
                         f"{(kp.shape[0], grid_size ** 3)}, got "
                         f"{tuple(occ_flat.shape)}")
    if kp.device != occ_flat.device:
        raise ValueError("chamfer_num: kp and occupancy on different devices")


def _frame_vals(V: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``val[v, k] = |c_k|^2 - 2 v.c_k`` of one frame: (G^3, K)."""
    return (c * c).sum(dim=-1)[None] - 2.0 * (V @ c.T)


def chamfer_num_plain(kp: torch.Tensor, occ_flat: torch.Tensor,
                      grid_size: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: kp (M, K, 3) float32, occ_flat
    (M, G^3) float32 or bfloat16 -> num (M,) float32 with
    ``num[m] = sum_v occ[m, v] * relu(|v|^2 + min_k(|c_k|^2 - 2 v.c_k))``.
    One frame at a time, so the (G^3, K) dot tensor stays small."""
    _check_chamfer(kp, occ_flat, grid_size)
    V = coord_maps((grid_size,) * 3, device=kp.device).reshape(-1, 3)
    v2 = (V * V).sum(dim=-1)
    out = []
    for m in range(kp.shape[0]):
        dmin = v2 + _frame_vals(V, kp[m]).amin(dim=-1)
        out.append((torch.clamp(dmin, min=0.0)
                    * occ_flat[m].float()).sum())
    if not out:
        return torch.zeros(0, dtype=torch.float32, device=kp.device)
    return torch.stack(out)


def _frame_bwd_weights(V: torch.Tensor, v2: torch.Tensor, c: torch.Tensor,
                       occ: torch.Tensor, g: torch.Tensor):
    """One frame's backward weights with JAX's VJP conventions (see
    :func:`chamfer_num_bwd_plain`): voxel centres ``V`` (G^3, 3) and their
    ``v2 = |v|^2``, keypoints ``c`` (K, 3), occupancy ``occ`` (G^3,) and the
    frame's output gradient ``g`` -> ``(W (G^3, K), dmin (G^3,))`` with
    ``W_k(v) = g occ(v) relu'(dmin(v)) [val_k(v) = min] / ties(v)``."""
    vals = _frame_vals(V, c)                            # (G^3, K)
    minval = vals.amin(dim=-1, keepdim=True)
    tied = (vals == minval).float()
    dmin = v2 + minval[:, 0]
    relu_w = torch.where(dmin > 0, 1.0, torch.where(dmin == 0, 0.5, 0.0))
    w = (g * occ.float() * relu_w) / tied.sum(dim=-1)   # (G^3,)
    return tied * w[:, None], dmin


def chamfer_num_bwd_plain(g: torch.Tensor, kp: torch.Tensor,
                          occ_flat: torch.Tensor, grid_size: int):
    """Plain PyTorch version of the backward kernel: the gradients of
    ``sum_m g[m] * num[m]`` -> (dkp (M, K, 3) float32, docc (M, G^3) in the
    occupancy's dtype), with JAX's VJP conventions written out:

    * relu' is 1 above 0, 1/2 at exactly 0 and 0 below (``jnp.maximum``);
    * the min over k gives each of the tied minima ``1 / ties`` of the
      gradient (``jnp.min``);

    so ``W_k(v) = g occ(v) relu'(dmin(v)) [val_k(v) = min] / ties(v)``,
    ``dkp_k = 2 c_k sum_v W_k(v) - 2 sum_v W_k(v) v`` and
    ``docc(v) = g relu(dmin(v))``. One frame at a time."""
    _check_chamfer(kp, occ_flat, grid_size)
    g = g.reshape(-1).float()
    V = coord_maps((grid_size,) * 3, device=kp.device).reshape(-1, 3)
    v2 = (V * V).sum(dim=-1)
    dkp, docc = [], []
    for m in range(kp.shape[0]):
        c = kp[m]                                       # (K, 3)
        W, dmin = _frame_bwd_weights(V, v2, c, occ_flat[m], g[m])
        S = W.sum(dim=0)                                # (K,)
        P = W.T @ V                                     # (K, 3)
        dkp.append(2.0 * c * S[:, None] - 2.0 * P)
        docc.append((g[m] * torch.clamp(dmin, min=0.0)).to(occ_flat.dtype))
    if not dkp:
        return torch.zeros_like(kp), torch.zeros_like(occ_flat)
    return torch.stack(dkp), torch.stack(docc)


class _ChamferNum(torch.autograd.Function):
    """K2 with its backward: the kernels for CUDA tensors, the plain
    versions for CPU tensors."""

    @staticmethod
    def forward(ctx, kp, occ_flat, grid_size):
        ctx.save_for_backward(kp, occ_flat)
        ctx.grid_size = grid_size
        if kp.device.type == "cpu":
            return chamfer_num_plain(kp, occ_flat, grid_size)
        return _chamfer_num_cuda(kp, occ_flat, grid_size)

    @staticmethod
    def backward(ctx, grad):
        kp, occ_flat = ctx.saved_tensors
        want_docc = ctx.needs_input_grad[1]
        grad = grad.float().contiguous()
        if kp.device.type == "cpu":
            dkp, docc = chamfer_num_bwd_plain(grad, kp, occ_flat,
                                              ctx.grid_size)
        else:
            dkp, docc = _chamfer_bwd_cuda(grad, kp, occ_flat, ctx.grid_size,
                                          want_docc)
        return dkp, (docc if want_docc else None), None


_lib = None   # (the kernel's library, voxels per tile, largest K)
# (device index, stream) -> (int32 tickets, one per frame, float32 scratch
# for the tile partials). The tickets are zero between launches (a frame's
# last block sets its ticket back to 0) and a stream's launches run in
# order, so they share one workspace.
_workspace: dict = {}


def _chamfer_setup(kp, occ_flat, grid_size, floats_per_tile):
    """(the loaded library, tiles per frame, the frames' tickets, a scratch
    of ``floats_per_tile`` floats per tile or more, the per-axis
    coordinates, the current stream) after the kernel's checks."""
    global _lib
    for name, t in (("kp", kp), ("occupancy", occ_flat)):
        if not t.is_contiguous():
            raise ValueError(f"chamfer_num: {name} must be contiguous")
    if _lib is None:
        lib = kernels.library("chamfer")
        _lib = (lib, lib.nm_chamfer_tile_voxels(), lib.nm_chamfer_max_k())
    lib, tile, max_k = _lib
    M, K = kp.shape[:2]
    if not 1 <= K <= max_k:
        raise ValueError(f"chamfer_num: K={K} outside [1, {max_k}]")
    if M > 65535:
        raise ValueError(f"chamfer_num: at most 65535 frames, got {M}")
    dev = kp.device
    n_tiles = -(-grid_size ** 3 // tile)
    stream = kernels.stream_handle(dev)
    key = (dev.index, stream.value)
    tickets, scratch = _workspace.get(key, (None, None))
    need = n_tiles * floats_per_tile
    if tickets is None or tickets.numel() < M or scratch.numel() < need:
        tickets = torch.zeros(max(M, 64), dtype=torch.int32, device=dev)
        scratch = torch.empty(need, dtype=torch.float32, device=dev)
        _workspace[key] = (tickets, scratch)
    return lib, n_tiles, tickets, scratch, _linspace(grid_size, dev), stream


def _chamfer_num_cuda(kp, occ_flat, grid_size):
    global launches
    M, K = kp.shape[:2]
    lib, n_tiles, tickets, partial, lin, stream = _chamfer_setup(
        kp, occ_flat, grid_size, M)
    dev = kp.device
    num = torch.empty((M,), dtype=torch.float32, device=dev)
    code = lib.nm_chamfer_fwd(
        kp.data_ptr(), occ_flat.data_ptr(),
        int(occ_flat.dtype == torch.bfloat16), lin.data_ptr(),
        partial.data_ptr(), tickets.data_ptr(), num.data_ptr(), M, K,
        grid_size, n_tiles, dev.index, stream)
    kernels.check(lib, code, "chamfer kernel")
    launches += 1
    return num


def _chamfer_bwd_cuda(g, kp, occ_flat, grid_size, want_docc):
    """The backward kernel: (dkp, docc or None)."""
    global bwd_launches
    M, K = kp.shape[:2]
    lib, n_tiles, tickets, partial, lin, stream = _chamfer_setup(
        kp, occ_flat, grid_size, M * K * 4)
    dev = kp.device
    if g.shape != (M,) or g.device != dev:
        raise ValueError(f"chamfer_num backward: gradient must be ({M},) on "
                         f"{dev}, got {tuple(g.shape)} on {g.device}")
    dkp = torch.empty((M, K, 3), dtype=torch.float32, device=dev)
    docc = torch.empty_like(occ_flat) if want_docc else None
    code = lib.nm_chamfer_bwd(
        g.data_ptr(), kp.data_ptr(), occ_flat.data_ptr(),
        int(occ_flat.dtype == torch.bfloat16), lin.data_ptr(),
        partial.data_ptr(), tickets.data_ptr(), dkp.data_ptr(),
        docc.data_ptr() if want_docc else None, M, K, grid_size, n_tiles,
        dev.index, stream)
    kernels.check(lib, code, "chamfer backward kernel")
    bwd_launches += 1
    return dkp, docc


def chamfer_num(kp: torch.Tensor, occ_flat: torch.Tensor,
                grid_size: int) -> torch.Tensor:
    """kp (M, K, 3) float32, occ_flat (M, G^3) float32/bfloat16 -> (M,)
    float32, differentiable in both. CUDA tensors run kernel K2 forward and
    backward, CPU tensors their plain versions."""
    if kp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"chamfer_num: unsupported device {kp.device}")
    _check_chamfer(kp, occ_flat, grid_size)
    return _ChamferNum.apply(kp, occ_flat, grid_size)


def volume_fitting_loss(seq: torch.Tensor, keypoints: torch.Tensor,
                        sigmas, vol_fit_type: str) -> torch.Tensor:
    """Occupancy-weighted fit of keypoints to the voxel volume -> (B, T).

    ``chamfer`` (the shipped default): per-voxel min squared distance to the
    nearest keypoint, averaged over occupied voxels (kernel K2 on a card).
    ``gaussian``: the share of occupied voxels that the keypoints' Gaussian
    blobs (``sigmas`` x 4, scaled by intensity, rendered on the full grid)
    leave uncovered, ``sum((1 - max_k blob_k) occ) / sum(occ)``; the JAX
    package's intended semantics of the reference's broken branch, plain
    PyTorch as there. ``none``: zeros."""
    B, T = seq.shape[:2]
    spatial = seq.shape[2:-1]
    if vol_fit_type == "none":
        return torch.zeros((B, T), dtype=seq.dtype, device=seq.device)
    if vol_fit_type not in ("chamfer", "gaussian"):
        raise ValueError(f"unknown vol_fit_type {vol_fit_type!r}")
    if len(set(spatial)) != 1:
        raise ValueError(f"volume_fitting_loss: grid must be cubic, got "
                         f"{tuple(spatial)}")
    G = spatial[0]
    if vol_fit_type == "gaussian":
        occ = seq[..., 0]                                   # (B, T, G, G, G)
        sig = torch.as_tensor(sigmas, device=seq.device).to(seq.dtype) * 4.0
        mask = render_gaussian_maps_first(keypoints, sig, G).amax(dim=2)
        num = ((1.0 - mask) * occ).sum(dim=(2, 3, 4))
        return num / occ.sum(dim=(2, 3, 4))
    M = B * T
    occ = seq[..., 0].reshape(M, G ** 3)
    kp = keypoints[..., :3].float().reshape(M, -1, 3).contiguous()
    num = chamfer_num(kp, occ, G).reshape(B, T).to(seq.dtype)
    den = occ.reshape(B, T, -1).sum(dim=-1)
    return num / torch.clamp(den, min=1.0)


def graph_consistency_losses(keypoints: torch.Tensor, affinity: torch.Tensor,
                             local_const: bool = True, time_const: bool = True,
                             sparsity_const: bool = True, ver: int = 0):
    """(local, time, sparsity, intensity) graph losses; ``intensity`` is
    hard-zero upstream and kept so here."""
    dtype, dev = keypoints.dtype, keypoints.device
    zero = torch.zeros((1, 1), dtype=dtype, device=dev)

    influence = affinity.amax(dim=0)  # (K, K, 1)
    if ver == 2:
        influence = influence + influence.transpose(0, 1)
    positions = keypoints[..., :3]
    infl = influence[None, None]  # (1, 1, K, K, 1)
    intensities = keypoints[..., -1][..., None, None]  # (B, T, K, 1, 1)
    dist = ((positions[:, :, :, None] - positions[:, :, None]) ** 2).sum(
        dim=-1, keepdim=True)  # (B, T, K, K, 1)

    if local_const:
        lc = dist * infl * intensities if ver in (0, 2) else dist * infl
        local_loss = lc.mean(dim=(2, 3, 4))
    else:
        local_loss = zero

    if time_const:
        dev_ = (dist - dist.mean(dim=1, keepdim=True)).abs()
        tc = dev_ * infl * intensities if ver in (0, 2) else dev_ * infl
        time_loss = tc.mean(dim=(2, 3, 4))
    else:
        time_loss = zero

    if sparsity_const:
        aff = affinity[..., 0]  # (n, K, K)
        a_self = aff[:, None]
        a_other = aff[None]
        sp = ((a_self * a_other) ** 2).sum(dim=1, keepdim=True)
        sp = sp - a_self ** 4
        sp = sp.sum(dim=(0, 1))  # (K, K)
        sparsity_loss = sp.mean()[None, None]
    else:
        sparsity_loss = zero

    return local_loss, time_loss, sparsity_loss, zero


def _cosine_similarity(x, y, eps=1e-6):
    """torch CosineSimilarity semantics: each norm clamped at eps."""
    w12 = (x * y).sum(dim=-1)
    nx = torch.sqrt(torch.clamp((x * x).sum(dim=-1), min=eps * eps))
    ny = torch.sqrt(torch.clamp((y * y).sum(dim=-1), min=eps * eps))
    return w12 / (nx * ny)


def graph_trajectory_loss(keypoints: torch.Tensor, affinity: torch.Tensor,
                          ver: int = 0) -> torch.Tensor:
    """Velocity/acceleration cosine-dissimilarity weighted by influence
    -> (1, 1)."""
    influence = affinity[..., 0].amax(dim=0)  # (K, K)
    if ver == 2:
        influence = influence + influence.T
    infl = influence[None, None]

    vel = keypoints[:, 1:, :, :3] - keypoints[:, :-1, :, :3]
    acc = vel[:, 1:] - vel[:, :-1]
    vel_cos = (1.0 - _cosine_similarity(vel[:, :, :, None],
                                        vel[:, :, None])) / 2.0
    acc_cos = (1.0 - _cosine_similarity(acc[:, :, :, None],
                                        acc[:, :, None])) / 2.0

    if ver in (0, 2):
        inten = keypoints[..., -1][..., None]
        inten_v = (inten[:, 1:] + inten[:, :-1]) / 2.0
        inten_a = (inten_v[:, 1:] + inten_v[:, :-1]) / 2.0
        vel_term = (vel_cos * infl * inten_v).mean(dim=(0, 1))
        acc_term = (acc_cos * infl * inten_a).mean(dim=(0, 1))
    else:
        vel_term = (vel_cos * infl).mean(dim=(0, 1))
        acc_term = (acc_cos * infl).mean(dim=(0, 1))
    return (vel_term + acc_term).mean()[None, None]


def gaussian_kl(mean_q, std_q, mean_p, std_p):
    """KL(N(mean_q, std_q) || N(mean_p, std_p)), element-wise diagonal."""
    var_ratio = (std_q / std_p) ** 2
    t1 = ((mean_q - mean_p) / std_p) ** 2
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))
