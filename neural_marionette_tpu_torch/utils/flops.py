"""Analytic model-FLOPs counter for MFU accounting.

A copy of the JAX package's ``utils/flops.py`` (the port imports nothing of
that package), with the H100's peak as the default of :func:`mfu`.

MFU is computed from the MODEL's useful FLOPs, not from a profiler's count
of what ran: a layout rewrite or padding would inflate it on exactly the
configurations it helps.

The counter walks the same architecture the modules build
(``models/blocks.py``, ``models/detector.py``; reference
modules/vox_modules.py, model/kypt_detector.py) and sums conv/matmul MACs.
Elementwise work (GroupNorm, activations, gaussian rendering, trilinear
upsample taps) and the VRNN's per-keypoint MLPs are excluded: together they
are <1% of the conv FLOPs at the flagship scale.

Validation: ``tests/test_torch_utils.py`` holds :func:`forward_flops`
within 10 % of ``torch.utils.flop_counter.FlopCounterMode``'s count of the
port's own detector forward at a small width, and equal to the JAX
package's counter over the AIST preset and the option sets.
"""
from __future__ import annotations


def _conv(vox: int, k: int, cin: int, cout: int) -> float:
    """FLOPs of one 3D conv: 2 * output_voxels * k^3 * Cin * Cout."""
    return 2.0 * vox * (k ** 3) * cin * cout


def _res3d(g: int, cin: int, cout: int) -> float:
    """Res3DBlock (blocks.py): two k3 convs + 1x1 skip proj if cin!=cout."""
    v = g ** 3
    f = _conv(v, 3, cin, cout) + _conv(v, 3, cout, cout)
    if cin != cout:
        f += _conv(v, 1, cin, cout)
    return f


def _pool2(g_out: int, c: int) -> float:
    """Pool3DBlock: k2 s2 conv, C -> C."""
    return _conv(g_out ** 3, 2, c, c)


def _upsample_block(g_out: int, cin: int, cout: int) -> float:
    """Upsample3DBlock: ConvTranspose k2 s2 — one tap per output voxel."""
    return 2.0 * (g_out ** 3) * cin * cout


def _hourglass(n: int, c: int) -> float:
    """3-level HG (blocks.py Hourglass; reference vox_modules.py:78-120)
    at input size ``n`` with ``output_channels=c``."""
    f = _res3d(n, c, c)                       # skip1
    f += _pool2(n // 2, c)
    f += _res3d(n // 2, c, 32)
    f += _res3d(n // 2, 32, 32)               # skip2
    f += _pool2(n // 4, 32)
    f += _res3d(n // 4, 32, 48)
    f += _res3d(n // 4, 48, 48)               # skip3
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
    """FeatureNet (detector.py): stem k5 (Cin = 1 vox + 3 coords) ->
    pool -> Res(C/2) -> pool -> HG(C/2) -> Res(C)."""
    f = _conv(g ** 3, 5, 4, c // 4)
    f += _pool2(g // 2, c // 4)
    f += _res3d(g // 2, c // 4, c // 2)
    f += _pool2(g // 4, c // 2)
    f += _hourglass(g // 4, c // 2)
    f += _res3d(g // 4, c // 2, c)
    return f


def _decoder(g: int, c: int, k: int, d: int = 3) -> float:
    """adjust 1x1 + VoxelDecoder (detector.py): counted in the PLAIN
    two-op form (upsample taps excluded, convs at their true shapes) —
    the strip/upconv paths compute the same math."""
    gq = g // 4
    f = _conv(gq ** 3, 1, 2 * k + c + d, c)              # adjust
    f += _conv((g // 2) ** 3, 3, c, c // 2)              # stage 0
    f += _conv((g // 2) ** 3, 3, c // 2, c // 2)         # stage 1
    f += _conv(g ** 3, 3, c // 2, c // 4)                # stage 2 (upconv)
    f += _conv(g ** 3, 3, c // 4, c // 4)                # stage 3
    f += _conv(g ** 3, 1, c // 4, 1)                     # head
    return f


def forward_flops(cfg, B: int) -> float:
    """Model FLOPs of one full forward (encode + decode + ST prior) at
    batch ``B`` — conv/matmul terms only, see module docstring."""
    g, c, k = cfg.grid_size, cfg.feat_dim, cfg.nkeypoints
    frames = B * cfg.Ttot
    f = frames * (_feature_net(g, c) + _decoder(g, c, k))
    f += frames * _conv((g // 4) ** 3, 1, c, k)          # heatmap head
    if cfg.const_intensity in (2, 3, 4):
        # spatio-temporal prior branch: FeatureNet(2C) + head on B frames
        f += B * (_feature_net(g, 2 * c)
                  + _conv((g // 4) ** 3, 1, 2 * c, k))
    return f


def train_step_flops(cfg, B: int) -> float:
    """fwd + bwd ~= 3x forward (the standard matmul convention: one
    activation-grad and one weight-grad matmul per forward matmul).
    Rematerialization recompute is deliberately NOT counted — MFU
    measures useful work (PaLM-style accounting)."""
    return 3.0 * forward_flops(cfg, B)


# NVIDIA H100 SXM, dense bfloat16 on the tensor cores (NVIDIA's data sheet)
H100_SXM_BF16_DENSE_TFLOPS = 989.0


def mfu(flops_per_step: float, step_seconds: float,
        peak_tflops: float = H100_SXM_BF16_DENSE_TFLOPS) -> float:
    """Fraction of the card's bf16 peak (default: the H100 SXM's dense
    bf16, 989 TFLOP/s)."""
    return flops_per_step / step_seconds / (peak_tflops * 1e12)
