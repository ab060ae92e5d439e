"""K2's sparse kernel order (``csrc/chamfer.cu``) emulated in numpy, against
the JAX package on the CPU.

The kernel runs only on the card. What it computes in which order is
emulated here in float32, step by step as the source does it:

* per tile of ``TILE_VOXELS`` voxels of a frame, the nonzero voxels
  compacted in voxel order (their in-frame index and value);
* forward: thread j sums the compacted voxels j, j + THREADS, ...; a tree
  of shuffles per warp, the warps in order; the frame's tile partials
  summed the same way by its last block;
* backward, in rounds of ``CHUNK`` compacted voxels: per voxel the min over
  k, the mask of the tied keypoints, ties, relu' and the weight
  ``w = g occ relu' / ties`` with its products w v; thread (k, segment)
  sums w and w v over its segment's voxels whose mask has bit k; the
  segments in order; the
  tiles in the last block's order (thread group q takes tiles q, q + Q, ...,
  then the groups in order); ``dkp = 2 c S - 2 P``.

A fused multiply-add is emulated in float64 and rounded once to float32 (a
product of two float32 values is exact in float64). The geometry
(``THREADS``, ``TILE_VOXELS``, ``CHUNK``, ``MAX_K``) is read from the source.

The JAX side runs ``chamfer_num_pallas`` in interpret mode, as
tests/test_pallas.py does, and the jnp path of tests/test_torch_ops.py.
Tracing the Pallas kernel costs seconds per keypoint count (20 s for the
backward at K = 64), so the frames of one call carry several keypoint
counts, each padded to the call's K with the Pallas kernel's own sentinel
keypoints (``_SENTINEL`` = 1e9: |c|^2 ~ 3e18 never wins the min, so the
sums are those of a call with the frame's own K). The backward's
comparison with the Pallas kernel covers K up to 24; K = 64 is held
against the jnp path.
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_marionette_tpu import ops as J
from neural_marionette_tpu.ops.pallas.chamfer_kernel import (
    _SENTINEL, chamfer_num_pallas)

from neural_marionette_tpu_torch.ops import coords as Pc
from neural_marionette_tpu_torch.ops import losses as Pl

SRC = Path(Pl.__file__).resolve().parents[1] / "csrc" / "chamfer.cu"


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", SRC.read_text())[1])


THREADS, TILE, CHUNK, MAX_K = (_define(n) for n in (
    "THREADS", "TILE_VOXELS", "CHUNK", "MAX_K"))
f32 = np.float32


# ------------------------------------------------------------ emulation
def _fma(a, b, c):
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(f32)


def _sq3(a, b, c):
    return _fma(c, c, _fma(b, b, a * a))


def _keypoints(c):
    """(K, 4): the keypoints and |c|^2, as load_keypoints stores them."""
    return np.concatenate([c, _sq3(c[:, 0], c[:, 1], c[:, 2])[:, None]], 1)


def _vals(kp4, x, y, z):
    """(n, K) val_k(v) = |c_k|^2 - 2 v.c_k with chamfer_val's roundings."""
    d = _fma(kp4[:, 2], z[:, None],
             _fma(kp4[:, 1], y[:, None], kp4[:, 0] * x[:, None]))
    return _fma(f32(-2.0), d, kp4[:, 3])


def _tiles(row, G):
    """Per tile: (coordinates x, y, z, values) of its nonzero voxels in
    voxel order, from the per-axis linspace table."""
    lin = np.linspace(-1.0, 1.0, G, dtype=f32)
    for t0 in range(0, G ** 3, TILE):
        idx = t0 + np.flatnonzero(row[t0:t0 + TILE] != 0)
        yield (lin[idx // (G * G)], lin[idx // G % G], lin[idx % G],
               row[idx])


def _block_sum(v):
    """block_sum: per warp the lane-0 result of the shuffle-down tree, then
    the warps in order."""
    total = f32(0.0)
    for w in range(0, THREADS, 32):
        lanes = v[w:w + 32].copy()
        for off in (16, 8, 4, 2, 1):
            lanes[:off] = lanes[:off] + lanes[off:2 * off]
        total = f32(total + lanes[0])
    return total


def _strided(values, acc, add):
    """Thread j folds values j, j + THREADS, ... into acc[j] with add."""
    for s in range(0, len(values), THREADS):
        n = min(THREADS, len(values) - s)
        acc[:n] = add(values[s:s + n], acc[:n])
    return acc


def emulate_fwd(kp, occ, G):
    """num (M,) in the forward kernel's order; occ holds the occupancy's
    values as float32."""
    num = np.zeros(kp.shape[0], f32)
    for m in range(kp.shape[0]):
        kp4 = _keypoints(kp[m])
        partials = []
        for x, y, z, o in _tiles(occ[m], G):
            best = _vals(kp4, x, y, z).min(axis=1)
            dmin = np.maximum(_sq3(x, y, z) + best, f32(0.0))
            acc = _strided(np.stack([o, dmin], 1), np.zeros(THREADS, f32),
                           lambda od, a: _fma(od[:, 0], od[:, 1], a))
            partials.append(_block_sum(acc))
        sums = _strided(np.array(partials, f32), np.zeros(THREADS, f32),
                        lambda p, a: a + p)
        num[m] = _block_sum(sums)
    return num


def _tile_sums(x, y, z, o, gm, kp4):
    """One tile's (K, 4) partial (S_k, P_k) in the backward's order."""
    K = kp4.shape[0]
    nseg = THREADS // K
    acc = np.zeros((4, nseg, K), f32)       # S, Px, Py, Pz per (seg, k)
    for c0 in range(0, len(o), CHUNK):
        v = [a[c0:c0 + CHUNK] for a in (x, y, z)]
        vals = _vals(kp4, *v)
        best = vals.min(axis=1)
        mask = vals == best[:, None]
        dmin = _sq3(*v) + best
        relu_w = np.where(dmin > 0, f32(1.0),
                          np.where(dmin == 0, f32(0.5), f32(0.0)))
        w = (f32(gm) * o[c0:c0 + CHUNK] * relu_w
             / mask.sum(axis=1).astype(f32)).astype(f32)
        mask &= (w != 0)[:, None]
        cn = len(w)
        lo = np.arange(nseg) * cn // nseg
        hi = (np.arange(nseg) + 1) * cn // nseg
        for r in range(int((hi - lo).max())):
            j = np.minimum(lo + r, cn - 1)
            hit = mask[j] & (lo + r < hi)[:, None]          # (nseg, K)
            wj = w[j][:, None]
            acc[0] = np.where(hit, acc[0] + wj, acc[0])
            for a in range(3):
                acc[1 + a] = np.where(hit, acc[1 + a] + wj * v[a][j][:, None],
                                      acc[1 + a])
    part = np.zeros((K, 4), f32)
    for s in range(nseg):
        part = part + acc[:, s].T
    return part


def emulate_bwd(g, kp, occ, G):
    """dkp (M, K, 3) in the backward kernel's order."""
    M, K = kp.shape[:2]
    nout = 4 * K
    Q = THREADS // nout
    dkp = np.zeros((M, K, 3), f32)
    for m in range(M):
        kp4 = _keypoints(kp[m])
        parts = np.stack([_tile_sums(*t, g[m], kp4)
                          for t in _tiles(occ[m], G)]).reshape(-1, nout)
        tot = np.zeros(nout, f32)
        for q in range(Q):
            a = np.zeros(nout, f32)
            for t in range(q, len(parts), Q):
                a = a + parts[t]
            tot = tot + a
        tot = tot.reshape(K, 4)
        dkp[m] = (f32(2.0) * kp[m]) * tot[:, :1] - f32(2.0) * tot[:, 1:]
    return dkp


# ------------------------------------------------------------ the JAX side
@functools.lru_cache(maxsize=None)
def _centres(G):
    with jax.ensure_compile_time_eval():   # also when first asked in a trace
        return np.asarray(J.coord_maps((G,) * 3)).reshape(-1, 3)


def _jnp_chamfer_num(kp, occ_flat, G):
    """The JAX package's jnp volume-fitting numerator (as in
    tests/test_torch_ops.py), whose VJP is jax.grad's own."""
    V = jnp.asarray(_centres(G))
    v2 = jnp.sum(V * V, axis=-1)
    dots = jnp.einsum("vc,mkc->mvk", V, kp,
                      precision=jax.lax.Precision.HIGHEST)
    c2 = jnp.sum(kp * kp, axis=-1)
    dmin = v2[None] + jnp.min(c2[:, None, :] - 2.0 * dots, axis=-1)
    return jnp.sum(jnp.maximum(dmin, 0.0) * occ_flat, axis=-1)


KS = (1, 9, 24, 64)
DTYPES = ("float32", "bfloat16")


def _frame(K, dtype):
    """The index of the (K, dtype) frame in _case."""
    return 2 * KS.index(K) + DTYPES.index(dtype)


@functools.lru_cache(maxsize=None)
def _case(G):
    """One frame per (K, dtype) of KS x DTYPES: keypoints, weighted
    occupancy (about 5 % occupied, values in [0.5, 1.5] rounded to the
    dtype, as float32), upstream gradients, and the keypoints padded to
    MAX_K with sentinels."""
    g = np.random.default_rng(G)
    M = 2 * len(KS)
    kp = [g.uniform(-0.9, 0.9, (K, 3)).astype(f32) for K in KS for _ in DTYPES]
    occ = ((g.random((M, G ** 3)) < 0.05)
           * g.uniform(0.5, 1.5, (M, G ** 3))).astype(f32)
    occ[1::2] = torch.from_numpy(occ[1::2]).bfloat16().float().numpy()
    w = g.uniform(-2.0, 2.0, M).astype(f32)
    pad = np.full((M, MAX_K, 3), _SENTINEL, f32)
    for m, c in enumerate(kp):
        pad[m, :len(c)] = c
    return kp, occ, w, pad


# traced once per shape: the interpret-mode kernel takes seconds to trace
_pallas_fwd = jax.jit(chamfer_num_pallas, static_argnums=2)


@functools.lru_cache(maxsize=None)
def _pallas_num(G):
    """chamfer_num_pallas on every frame of _case(G) at K = MAX_K. The
    kernel casts the occupancy to float32 first, so bfloat16 values go in
    as float32."""
    _, occ, _, pad = _case(G)
    return np.asarray(_pallas_fwd(jnp.asarray(pad), jnp.asarray(occ), G))


def _weighted_grad(fn, kp, occ, w, G):
    """jax.grad over kp of sum_m w[m] fn(kp, occ)[m]."""
    return np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(
        fn(a, jnp.asarray(occ), G) * w)))(jnp.asarray(kp)))


@functools.lru_cache(maxsize=None)
def _jax_dkp(G=32, Kp=24):
    """(jax.grad of the jnp path on every frame of _case(G) at K = MAX_K,
    jax.grad of chamfer_num_pallas on the frames with K <= Kp at K = Kp)."""
    _, occ, w, pad = _case(G)
    n = 2 * sum(K <= Kp for K in KS)
    return (_weighted_grad(_jnp_chamfer_num, pad, occ, w, G),
            _weighted_grad(chamfer_num_pallas, pad[:n, :Kp], occ[:n], w[:n],
                           G))


# ------------------------------------------------------------------ tests
def test_geometry_of_the_source():
    """The emulated geometry is the kernel's: whole rounds of 16-byte loads
    per tile, at most four (their counts share a 64-bit scan word), a
    tie mask of MAX_K bits, and the backward's final sum fits a block."""
    assert TILE % (THREADS * 8) == 0 and TILE // (THREADS * 4) <= 4
    assert MAX_K == 64 and 4 * MAX_K <= THREADS <= CHUNK
    src = SRC.read_text()
    assert "unsigned long long mask_a" in src and "__popcll(mask)" in src


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("G", [16, 32])
def test_sparse_forward_equals_pallas(G, K, dtype):
    """The forward's order against chamfer_num_pallas (interpret mode):
    rtol 1e-5 (float32 sums of about 200 (G=16) or 1600 (G=32) terms in
    other orders); and against the plain version."""
    m = _frame(K, dtype)
    kp, occ, _, _ = _case(G)
    got = emulate_fwd(kp[m][None], occ[m:m + 1], G)
    np.testing.assert_allclose(got, _pallas_num(G)[m:m + 1], rtol=1e-5)
    occ_t = torch.from_numpy(occ[m:m + 1]).to(getattr(torch, dtype))
    plain = Pl.chamfer_num_plain(torch.from_numpy(kp[m][None]), occ_t, G)
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", KS)
def test_sparse_backward_equals_jax(K, dtype):
    """The backward's order (G=32) against jax.grad of chamfer_num_pallas
    (interpret mode, K <= 24) and of the jnp path, weighted by g, at the
    tolerances of test_chamfer_backward_plain_equals_jax: dkp rtol 1e-5 /
    atol 1e-4 (sums of about 1600 terms in other orders)."""
    G, m = 32, _frame(K, dtype)
    kp, occ, w, _ = _case(G)
    got = emulate_bwd(w[m:m + 1], kp[m][None], occ[m:m + 1], G)
    jnp_dkp, pallas_dkp = _jax_dkp()
    want = [jnp_dkp[m:m + 1, :K]]
    if K <= 24:
        want.append(pallas_dkp[m:m + 1, :K])
    for ref in want:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_sparse_exact_conventions():
    """The G=5 inputs of test_chamfer_backward_exact_conventions (voxel
    centres and their products exact in float32; exact ties over k, relu at
    exactly 0): the emulated kernel equals jax.grad of the jnp path and the
    plain version to the bit, num too. G^3 = 125 is one ragged tile."""
    G = 5
    kp = np.array([[[0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [-1.0, 0.0, 0.5],
                    [0.25, -0.5, 0.0], [0.75, -0.5, 0.0]],
                   [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 0.0, 0.0],
                    [-0.25, 0.5, -1.0], [-0.75, 0.5, -1.0]]], f32)
    occ = (np.random.default_rng(9).random((2, G ** 3)) < 0.6).astype(f32)
    occ[:, [31, 62, 93, 112]] = 1.0
    w = np.array([1.5, -0.75], f32)
    dkp = emulate_bwd(w, kp, occ, G)
    np.testing.assert_array_equal(
        dkp, _weighted_grad(_jnp_chamfer_num, kp, occ, w, G))
    pk, _ = Pl.chamfer_num_bwd_plain(torch.from_numpy(w),
                                     torch.from_numpy(kp),
                                     torch.from_numpy(occ), G)
    np.testing.assert_array_equal(dkp, pk.numpy())
    np.testing.assert_array_equal(
        emulate_fwd(kp, occ, G),
        np.asarray(_jnp_chamfer_num(jnp.asarray(kp), jnp.asarray(occ), G)))


def _edge_frames(case):
    """(G, occupancy (2, G^3)): an all-empty frame beside a random one; two
    frames whose occupied voxels all sit in one tile (the last, and the
    third); two fully occupied frames (G=16: one tile of eight backward
    rounds)."""
    g = np.random.default_rng(17)
    if case == "full":
        return 16, np.ones((2, 16 ** 3), f32)
    G = 32
    occ = (g.random((2, G ** 3)) < 0.3).astype(f32)
    if case == "empty":
        occ[0] = 0.0
    else:
        keep = np.zeros(G ** 3, bool)
        keep[G ** 3 - TILE:] = True
        occ[0] *= keep
        occ[1] *= np.roll(keep, 3 * TILE)
    return G, occ


@pytest.mark.parametrize("case", ["empty", "one_tile", "full"])
def test_sparse_edge_frames(case):
    """Forward and backward in the kernels' order on edge frames (K=24)
    against the jnp path and the plain versions: num rtol 1e-5; dkp rtol
    1e-5 / atol 1e-4 plus 2e-5 of the magnitude of its summed terms, the
    bound of chip_smoke.py's card check (``_dkp_scale``: 2 |c_k| sum |W_k|
    + 2 sum |W_k| |v|; a 30 % G=32 frame sums about 400 terms per keypoint,
    a full G=16 frame about 170, and dkp = 2 c S - 2 P cancels two such
    sums); an empty frame gives exactly 0."""
    G, occ = _edge_frames(case)
    g = np.random.default_rng(18)
    kp = g.uniform(-0.9, 0.9, (2, 24, 3)).astype(f32)
    w = np.array([1.25, -0.5], f32)
    num = emulate_fwd(kp, occ, G)
    dkp = emulate_bwd(w, kp, occ, G)
    want_num = np.asarray(_jnp_chamfer_num(jnp.asarray(kp), jnp.asarray(occ),
                                           G))
    want_dkp = _weighted_grad(_jnp_chamfer_num, kp, occ, w, G)
    kp_t, occ_t, w_t = map(torch.from_numpy, (kp, occ, w))
    plain_num = Pl.chamfer_num_plain(kp_t, occ_t, G).numpy()
    plain_dkp = Pl.chamfer_num_bwd_plain(w_t, kp_t, occ_t, G)[0].numpy()
    V = Pc.coord_maps((G,) * 3).reshape(-1, 3)
    v2 = (V * V).sum(-1)
    scale = np.stack([
        (2.0 * c.abs() * W.sum(0)[:, None] + 2.0 * (W.T @ V.abs())).numpy()
        for c, W in ((kp_t[m], Pl._frame_bwd_weights(
            V, v2, kp_t[m], occ_t[m], w_t[m])[0].abs()) for m in range(2))])
    for ref_num, ref_dkp in ((want_num, want_dkp), (plain_num, plain_dkp)):
        np.testing.assert_allclose(num, ref_num, rtol=1e-5)
        assert (np.abs(dkp - ref_dkp)
                <= 1e-4 + 1e-5 * np.abs(ref_dkp) + 2e-5 * scale).all()
    if case == "empty":
        assert num[0] == 0.0 and not dkp[0].any()
