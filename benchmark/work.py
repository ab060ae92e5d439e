"""The yardstick's arithmetic: the card's peaks, the model's useful FLOPs on
each cell's path, and the bytes and operations each hand-written kernel
needs per call.

The FLOP counter is a copy of the port's analytic counter
(``utils/flops.py``): conv and matmul multiply-adds of the model as built,
2 FLOPs each; GroupNorm, activations, the Gaussian maps, the trilinear
taps and forward kinematics' 3 x 3 products are left out (under 1 % of
the convs at the AIST widths). It counts per cell what the cell's path
computes: the decoder only where its output is used.

A kernel's bound counts each input byte read once and each output byte
written once, and the operations the data needs (K2: only the occupied
voxels).
"""
from __future__ import annotations

# NVIDIA H100 SXM, published dense peaks (NVIDIA's data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12


# ------------------------------------------------------------ model FLOPs
def _conv(vox: int, k: int, cin: int, cout: int) -> float:
    return 2.0 * vox * (k ** 3) * cin * cout


def _res3d(g: int, cin: int, cout: int) -> float:
    v = g ** 3
    f = _conv(v, 3, cin, cout) + _conv(v, 3, cout, cout)
    if cin != cout:
        f += _conv(v, 1, cin, cout)
    return f


def _pool2(g_out: int, c: int) -> float:
    return _conv(g_out ** 3, 2, c, c)


def _upsample_block(g_out: int, cin: int, cout: int) -> float:
    return 2.0 * (g_out ** 3) * cin * cout


def _hourglass(n: int, c: int) -> float:
    f = _res3d(n, c, c)
    f += _pool2(n // 2, c)
    f += _res3d(n // 2, c, 32)
    f += _res3d(n // 2, 32, 32)
    f += _pool2(n // 4, 32)
    f += _res3d(n // 4, 32, 48)
    f += _res3d(n // 4, 48, 48)
    f += _pool2(n // 8, 48)
    f += _res3d(n // 8, 48, 72)
    f += _res3d(n // 8, 72, 72)
    f += _upsample_block(n // 4, 72, 48)
    f += _res3d(n // 4, 48, 48)
    f += _upsample_block(n // 2, 48, 32)
    f += _res3d(n // 2, 32, 32)
    f += _upsample_block(n, 32, c)
    return f


def _feature_net(g: int, c: int) -> float:
    f = _conv(g ** 3, 5, 4, c // 4)
    f += _pool2(g // 2, c // 4)
    f += _res3d(g // 2, c // 4, c // 2)
    f += _pool2(g // 4, c // 2)
    f += _hourglass(g // 4, c // 2)
    f += _res3d(g // 4, c // 2, c)
    return f


def _decoder(g: int, c: int, k: int, d: int = 3) -> float:
    gq = g // 4
    f = _conv(gq ** 3, 1, 2 * k + c + d, c)
    f += _conv((g // 2) ** 3, 3, c, c // 2)
    f += _conv((g // 2) ** 3, 3, c // 2, c // 2)
    f += _conv(g ** 3, 3, c // 2, c // 4)
    f += _conv(g ** 3, 3, c // 4, c // 4)
    f += _conv(g ** 3, 1, c // 4, 1)
    return f


def keypoint_flops(cfg: dict) -> float:
    """One clip's keypoint path: the per-frame feature net and heatmap head
    over T frames, the spatio-temporal prior's feature net and head once."""
    g, c, k, T = cfg["grid_size"], cfg["feat_dim"], cfg["nkeypoints"], \
        cfg["Ttot"]
    f = T * (_feature_net(g, c) + _conv((g // 4) ** 3, 1, c, k))
    f += _feature_net(g, 2 * c) + _conv((g // 4) ** 3, 1, 2 * c, k)
    f += T * _conv((g // 4) ** 3, 1, 2, 1)               # the fusion
    return f


def decoder_flops(cfg: dict) -> float:
    """One clip's voxel decoder over T frames."""
    return cfg["Ttot"] * _decoder(cfg["grid_size"], cfg["feat_dim"],
                                  cfg["nkeypoints"])


def vrnn_encode_flops(cfg: dict, samples: int = 10) -> float:
    """One clip's VRNN encode over T steps: the posterior and prior MLPs and
    the GRU once a step, both decoder heads on every sample."""
    K, H, Z = cfg["nkeypoints"], cfg["nhidden_kypt"], cfg["nlatent_kypt"]
    S = K * 4
    macs = ((H + S) * 128 + 128 * 2 * Z + H * 128 + 128 * 2 * Z
            + 3 * H * (S + Z) + 3 * H * H
            + samples * ((H + Z) * 128 + 128 * (3 + K)
                         + (H + Z) * 128 + 128 * 6 * K))
    return 2.0 * macs * cfg["Ttot"]


def useful_flops_per_clip(cfg: dict, path: str) -> float:
    """``detector_train``: forward and backward of the whole detector (3 x
    the forward; remat's recompute not counted). ``dynamics_train``: the
    frozen detector's keypoint path once, 3 x the VRNN encode.
    ``serve``: the keypoint path and the VRNN encode once."""
    if path == "detector_train":
        return 3.0 * (keypoint_flops(cfg) + decoder_flops(cfg))
    if path == "dynamics_train":
        return keypoint_flops(cfg) + 3.0 * vrnn_encode_flops(cfg)
    if path == "serve":
        return keypoint_flops(cfg) + vrnn_encode_flops(cfg)
    raise ValueError(f"unknown path {path!r}")


# ---------------------------------------------------------- kernel bounds
def bound_s(n_bytes: float, ops: float, peak_ops: float) -> float:
    """The least time of a call: the larger of its bytes over the memory
    rate and its operations over the peak of their type."""
    return max(n_bytes / PEAK_BYTES_PER_S, ops / peak_ops)


def k1_bound_s(frames: int, n_points: int, grid: int, out_bytes: int
               ) -> float:
    """K1 (voxelize): float32 points in, the occupancy grid out."""
    return bound_s(frames * n_points * 3 * 4 + frames * grid ** 3 * out_bytes,
                   0.0, PEAK_FP32_OPS_PER_S)


def k2_bound_s(frames: int, K: int, grid: int, occ_bytes: int,
               occupied: int, backward: bool) -> float:
    """K2 (chamfer numerator): the keypoints and the grid read, one float a
    frame written (forward) or the keypoints' gradient written (backward);
    per occupied voxel the min over the keypoints (9 K) and 8 (forward) or
    16 (backward) more."""
    grid_bytes = frames * grid ** 3 * occ_bytes
    kp_bytes = frames * K * 3 * 4
    if backward:
        return bound_s(frames * 4 + 2 * kp_bytes + grid_bytes,
                       occupied * (K * 9 + 16), PEAK_FP32_OPS_PER_S)
    return bound_s(kp_bytes + grid_bytes + frames * 4,
                   occupied * (K * 9 + 8), PEAK_FP32_OPS_PER_S)


def k3_bound_s(x_shape, w_shape) -> float:
    """K3 (bf16 conv): x, w and b read once, y written once, 2 FLOPs a
    multiply-add. ``x_shape`` (F, D, H, W, Cin), ``w_shape`` (k, k, k, Cin,
    Cout)."""
    Fr, D, H, W, Cin = x_shape
    k, Cout = w_shape[0], w_shape[-1]
    vox = Fr * D * H * W
    n_bytes = 2 * (vox * Cin + k ** 3 * Cin * Cout + Cout + vox * Cout)
    return bound_s(n_bytes, 2.0 * vox * k ** 3 * Cin * Cout,
                   PEAK_BF16_OPS_PER_S)
