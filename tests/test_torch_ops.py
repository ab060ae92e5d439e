"""The port's ops against the JAX package's, on the CPU.

Kernels K1 (voxelizer) and K2 (chamfer numerator) are checked through
their plain versions, which is what a CPU tensor runs; the JAX side runs
the Pallas kernels in interpret mode, as tests/test_pallas.py does.
Tolerances: exact for coordinates and occupancy; ~1e-6 for ops; losses
2e-6 relative unless stated.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_marionette_tpu import ops as J
from neural_marionette_tpu.ops.pallas import voxelize_pallas
from neural_marionette_tpu.ops.pallas.chamfer_kernel import chamfer_num_pallas
from neural_marionette_tpu.ops.upsample import upsample2_trilinear

from neural_marionette_tpu_torch.ops import coords as Pc
from neural_marionette_tpu_torch.ops import fk as Pfk
from neural_marionette_tpu_torch.ops import keypoints as Pk
from neural_marionette_tpu_torch.ops import losses as Pl
from neural_marionette_tpu_torch.ops import rotations as Pr
from neural_marionette_tpu_torch.ops import upsample as Pu
from neural_marionette_tpu_torch.ops import voxelize as Pv


def t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ coords
@pytest.mark.parametrize("spatial", [(8, 8, 8), (5, 7, 3), (32, 32, 32)])
def test_coord_maps_bitwise(spatial):
    np.testing.assert_array_equal(Pc.coord_maps(spatial).numpy(),
                                  np.asarray(J.coord_maps(spatial)))


def test_add_coord_channels_both_layouts():
    x = np.random.default_rng(0).normal(size=(2, 6, 5, 4, 3)).astype(
        np.float32)
    want = np.asarray(J.add_coord_channels(jnp.asarray(x)))
    np.testing.assert_array_equal(Pc.add_coord_channels(t(x)).numpy(), want)
    first = Pc.add_coord_channels_first(t(np.moveaxis(x, -1, 1)))
    np.testing.assert_array_equal(np.moveaxis(first.numpy(), 1, -1), want)


# ------------------------------------------------------------- voxelize K1
def _voxel_cases():
    g = np.random.default_rng(3)
    G = 32
    step = np.float32(2.0 / G + 1e-5)
    edges = np.arange(0, G + 2, dtype=np.float32) * step - 1.0
    boundary = np.stack(np.meshgrid(edges, edges[::3], edges[::5],
                                    indexing="ij"), -1).reshape(1, -1, 3)

    def oob(values):
        out = []
        for axis in range(3):
            for bad in values:
                p = g.uniform(-0.9, 0.9, (1, 40, 3)).astype(np.float32)
                p[0, ::2, axis] = bad
                out.append(p)
        return np.concatenate(out, axis=0)

    return {
        "random_batch": g.uniform(-1, 1, (2, 3, 500, 3)),
        "ragged_n": g.uniform(-1, 1, (1, 777, 3)),
        "duplicates": np.zeros((2, 300, 3)) + np.array([0.1, -0.2, 0.3]),
        "cell_boundaries": boundary,
        "oob_high_and_far": oob((1.0 + step * G, 1.3, 1e9, -1e9)),
        "oob_just_below": oob((-1.0 - step / 2, -1.2)),
    }


def _voxelize_true_division(pts, G):
    """float32 numpy oracle: floor((p + 1) / step), dropped if any axis is
    out of range."""
    step = np.float32(2.0 / G + 1e-5)
    idx = np.floor((pts + np.float32(1.0)) / step)
    ok = ((idx >= 0) & (idx < G)).all(-1)
    out = np.zeros(pts.shape[:-2] + (G, G, G, 1), np.float32)
    for f in np.ndindex(pts.shape[:-2]):
        i = idx[f][ok[f]].astype(np.int64)
        out[f][i[:, 0], i[:, 1], i[:, 2], 0] = 1.0
    return out


@pytest.mark.parametrize("case", sorted(_voxel_cases()))
def test_voxelize_plain_equals_pallas_and_jnp(case):
    """Occupancy exactly equal to the float32 true-division oracle, and to
    both JAX voxelizers except where they disagree with that semantics:

    * points exactly on a cell boundary: inside jit, XLA turns the division
      by the constant step into a multiply by its reciprocal, so the
      interpreted Pallas kernel rounds some of them one cell down;
    * points just below -1: ``voxelize_jnp``'s ``.at[]`` normalises the
      negative index -1 to G-1 before ``mode="drop"``, so it wraps them to
      the far side instead of dropping them.
    """
    pts = _voxel_cases()[case].astype(np.float32)
    G = 32
    got = Pv.voxelize(t(pts), G).numpy()
    np.testing.assert_array_equal(got, _voxelize_true_division(pts, G))
    if case != "oob_just_below":
        np.testing.assert_array_equal(got, np.asarray(J.voxelize_jnp(
            jnp.asarray(pts), G)))
    if case != "cell_boundaries":
        np.testing.assert_array_equal(got, np.asarray(voxelize_pallas(
            jnp.asarray(pts), G)))
    if case == "duplicates":
        assert got.sum() == 2.0
    bf16 = Pv.voxelize(t(pts), G, dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16.float().numpy(), got)


def test_voxelize_cpu_tensor_runs_plain_version_only():
    before = Pv.launches
    Pv.voxelize(torch.zeros(1, 4, 3), 16)
    assert Pv.launches == before
    with pytest.raises(TypeError):
        Pv.voxelize(torch.zeros(1, 4, 3, dtype=torch.float64), 16)


def test_voxelize_np_copy_matches():
    pts = np.random.default_rng(1).uniform(-1.1, 1.1, (400, 3)).astype(
        np.float32)
    for G in (16, 64):
        np.testing.assert_array_equal(Pv.voxelize_np(pts, G),
                                      J.voxelize_np(pts, G))


# ---------------------------------------------------------------- upsample
def test_upsample2_trilinear():
    x = np.random.default_rng(0).normal(size=(2, 5, 4, 6, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        Pu.upsample2_trilinear(t(x)).numpy(),
        np.asarray(upsample2_trilinear(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- keypoints
def test_extract_keypoints_from_heatmap():
    h = np.random.default_rng(0).uniform(0, 2, (3, 8, 6, 7, 5)).astype(
        np.float32)
    np.testing.assert_allclose(
        Pk.extract_keypoints_from_heatmap(t(h)).numpy(),
        np.asarray(J.extract_keypoints_from_heatmap(jnp.asarray(h))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sigma", [1.5, "per_k"])
def test_render_gaussian_maps(sigma):
    g = np.random.default_rng(1)
    kp = np.concatenate([g.uniform(-1, 1, (2, 3, 5, 3)),
                         g.uniform(0, 1, (2, 3, 5, 1))], -1).astype(np.float32)
    sig = g.uniform(1, 2, 5).astype(np.float32) if sigma == "per_k" else 1.5
    np.testing.assert_allclose(
        Pk.render_gaussian_maps(t(kp), sig if np.isscalar(sig) else t(sig),
                                8).numpy(),
        np.asarray(J.render_gaussian_maps(jnp.asarray(kp), sig, 8)),
        rtol=1e-6, atol=1e-6)


# --------------------------------------------------------- rotations and fk
def test_rotation_6d_to_matrix():
    p = np.random.default_rng(0).normal(size=(4, 7, 6)).astype(np.float32)
    np.testing.assert_allclose(
        Pr.rotation_6d_to_matrix(t(p)).numpy(),
        np.asarray(J.rotation_6d_to_matrix(jnp.asarray(p))),
        rtol=1e-6, atol=1e-6)


def _tree(K, seed):
    g = np.random.default_rng(seed)
    order = g.permutation(K).astype(np.int32)
    parents = np.zeros(K, np.int32)
    parents[order[0]] = order[0]
    for i in range(1, K):
        parents[order[i]] = order[g.integers(0, i)]
    return order, parents


@pytest.mark.parametrize("inverse", [False, True])
def test_fk_sequential_and_parallel(inverse):
    K, B = 11, 3
    order, parents = _tree(K, 5)
    g = np.random.default_rng(6)
    R = np.asarray(J.rotation_6d_to_matrix(jnp.asarray(
        g.normal(size=(B, K, 6)).astype(np.float32))))
    off = g.normal(size=(B, K, 3)).astype(np.float32)
    root = g.normal(size=(B, 3)).astype(np.float32)
    po, pp = t(order.astype(np.int64)), t(parents.astype(np.int64))
    jo, jp = jnp.asarray(order), jnp.asarray(parents)
    want_R = np.asarray(J.fk_global_rotations(jnp.asarray(R), jo, jp,
                                              inverse=inverse))
    for fn in (Pfk.fk_global_rotations, Pfk.fk_global_rotations_parallel):
        np.testing.assert_allclose(fn(t(R), po, pp, inverse=inverse).numpy(),
                                   want_R, rtol=1e-5, atol=1e-5)
    want_p = np.asarray(J.fk_positions(jnp.asarray(want_R), jnp.asarray(off),
                                       jnp.asarray(root), jo, jp))
    for fn in (Pfk.fk_positions, Pfk.fk_positions_parallel):
        np.testing.assert_allclose(
            fn(t(want_R), t(off), t(root), po, pp).numpy(), want_p,
            rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ losses
def _kp(B, T, K, seed):
    g = np.random.default_rng(seed)
    return np.concatenate([g.uniform(-0.9, 0.9, (B, T, K, 3)),
                           g.uniform(0.1, 1, (B, T, K, 1))],
                          -1).astype(np.float32)


def test_detector_losses():
    g = np.random.default_rng(0)
    B, T, K, G = 2, 5, 6, 8
    recon = g.uniform(0.01, 0.99, (B, T, G, G, G, 1)).astype(np.float32)
    target = (g.random((B, T, G, G, G, 1)) < 0.3).astype(np.float32)
    heat = g.normal(size=(B, T, 4, 4, 4, K)).astype(np.float32)
    kp = _kp(B, T, K, 1)
    pairs = [
        (Pl.bce_recon_loss(t(recon), t(target)),
         J.bce_recon_loss(recon, target)),
        (Pl.keypoint_sparsity_loss(t(heat)), J.keypoint_sparsity_loss(heat)),
        (Pl.temporal_separation_loss(t(kp), 0.3),
         J.temporal_separation_loss(kp, 0.3)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("ver", [0, 1, 2])
def test_graph_losses(ver):
    g = np.random.default_rng(ver)
    B, T, K = 2, 5, 6
    kp = _kp(B, T, K, 2)
    aff = g.uniform(0, 1, (2, K, K, 1)).astype(np.float32)
    got = Pl.graph_consistency_losses(t(kp), t(aff), ver=ver)
    want = J.graph_consistency_losses(kp, aff, ver=ver)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(
        Pl.graph_trajectory_loss(t(kp), t(aff), ver=ver).numpy(),
        np.asarray(J.graph_trajectory_loss(kp, aff, ver=ver)), rtol=2e-6)


def test_gaussian_kl():
    g = np.random.default_rng(0)
    a = [g.uniform(0.1, 2, (3, 7)).astype(np.float32) for _ in range(4)]
    np.testing.assert_allclose(Pl.gaussian_kl(*map(t, a)).numpy(),
                               np.asarray(J.gaussian_kl(*a)), rtol=2e-6)


# --------------------------------------------------------------- chamfer K2
@pytest.mark.parametrize("K,occ_dtype", [(24, "float32"), (9, "float32"),
                                         (24, "bfloat16"), (9, "bfloat16")])
def test_chamfer_plain_equals_pallas(K, occ_dtype):
    """Plain K2 against chamfer_num_pallas (interpret mode). rtol 1e-5:
    both sum about 1600 relu(dmin) terms in float32 in different orders."""
    G, M = 32, 2
    g = np.random.default_rng(K)
    kp = g.uniform(-0.9, 0.9, (M, K, 3)).astype(np.float32)
    occ = (g.random((M, G ** 3)) < 0.05).astype(np.float32)
    want = np.asarray(chamfer_num_pallas(
        jnp.asarray(kp), jnp.asarray(occ, dtype=getattr(jnp, occ_dtype)), G))
    got = Pl.chamfer_num(t(kp), t(occ).to(getattr(torch, occ_dtype)), G)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("K", [24, 9])
def test_volume_fitting_loss_equals_jnp_chamfer(K):
    """Port's volume_fitting_loss (plain K2 numerator) against the JAX
    package's jnp chamfer branch: rtol 1e-5."""
    G, B, T = 16, 2, 3
    g = np.random.default_rng(K + 1)
    seq = (g.random((B, T, G, G, G, 1)) < 0.1).astype(np.float32)
    kp = _kp(B, T, K, K)
    want = np.asarray(J.volume_fitting_loss(jnp.asarray(seq), jnp.asarray(kp),
                                            [1.5] * K, "chamfer"))
    got = Pl.volume_fitting_loss(t(seq), t(kp), None, "chamfer")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def _jnp_chamfer_num(kp, occ_flat, G):
    """The JAX package's jnp volume-fitting numerator (ops/losses.py), whose
    VJP is jax.grad's own: equal split over tied minima, 1/2 at relu 0."""
    V = jnp.asarray(np.asarray(J.coord_maps((G,) * 3)).reshape(-1, 3))
    v2 = jnp.sum(V * V, axis=-1)
    dots = jnp.einsum("vc,mkc->mvk", V, kp,
                      precision=jax.lax.Precision.HIGHEST)
    c2 = jnp.sum(kp * kp, axis=-1)
    dmin = v2[None] + jnp.min(c2[:, None, :] - 2.0 * dots, axis=-1)
    return jnp.sum(jnp.maximum(dmin, 0.0) * occ_flat, axis=-1)


@pytest.mark.parametrize("K,occ_dtype", [(24, "float32"), (9, "float32"),
                                         (24, "bfloat16"), (9, "bfloat16")])
def test_chamfer_backward_plain_equals_jax(K, occ_dtype):
    """``chamfer_num_bwd_plain`` against ``jax.grad`` of chamfer_num_pallas
    (interpret mode) and of the jnp path, weighted by g, for kp and the
    occupancy; and the autograd route of :func:`chamfer_num` on the CPU.
    Tolerances of tests/test_pallas.py:167-173: dkp rtol 1e-5 / atol 1e-4
    (sums of ~1600 terms in other orders), docc atol 4e-6 * max|g| (one ulp
    of dmin near the relu and min boundaries); a bfloat16 docc rounds
    g * relu(dmin) to 8 bits, so there rtol 8e-3."""
    G, M = 32, 3
    g = np.random.default_rng(K)
    kp = g.uniform(-0.9, 0.9, (M, K, 3)).astype(np.float32)
    occ = (g.random((M, G ** 3)) < 0.05).astype(np.float32)
    w = g.uniform(0.5, 2.0, M).astype(np.float32)
    jdt = getattr(jnp, occ_dtype)
    occ_j = jnp.asarray(occ, dtype=jdt)

    def grads(fn):
        return jax.grad(lambda a, b: jnp.sum(fn(a, b, G) * w),
                        argnums=(0, 1))(jnp.asarray(kp), occ_j)

    occ_t = t(occ).to(getattr(torch, occ_dtype))
    dkp, docc = Pl.chamfer_num_bwd_plain(t(w), t(kp), occ_t, G)
    assert dkp.dtype == torch.float32 and docc.dtype == occ_t.dtype
    docc_tol = dict(rtol=8e-3 if occ_dtype == "bfloat16" else 1e-5,
                    atol=4e-6 * float(w.max()))
    for fn in (chamfer_num_pallas, _jnp_chamfer_num):
        gk, go = grads(fn)
        np.testing.assert_allclose(dkp.numpy(), np.asarray(gk), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(docc.float().numpy(),
                                   np.asarray(go, np.float32), **docc_tol)
    # the same gradients through autograd (the CPU route of the loss)
    kp_t = t(kp).requires_grad_(True)
    occ_g = occ_t.clone().requires_grad_(True)
    (Pl.chamfer_num(kp_t, occ_g, G) * t(w)).sum().backward()
    np.testing.assert_array_equal(kp_t.grad.numpy(), dkp.numpy())
    np.testing.assert_array_equal(occ_g.grad.float().numpy(),
                                  docc.float().numpy())


def test_chamfer_backward_exact_conventions():
    """On a G=5 grid, whose voxel centres (-1, -0.5, 0, 0.5, 1) and their
    products are exact in float32: duplicate keypoints (an exact tie over
    k), keypoints on voxel centres (dmin == 0, relu' = 1/2) and tied
    nearest keypoints across a voxel. The plain backward equals jax.grad
    of the jnp path exactly (chamfer_num_pallas needs G^3 in (8, 128)
    tiles, which no grid with exact centres of this size has)."""
    G = 5
    kp = np.array([[[0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [-1.0, 0.0, 0.5],
                    [0.25, -0.5, 0.0], [0.75, -0.5, 0.0]],
                   [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 0.0, 0.0],
                    [-0.25, 0.5, -1.0], [-0.75, 0.5, -1.0]]], np.float32)
    g = np.random.default_rng(9)
    occ = (g.random((2, G ** 3)) < 0.6).astype(np.float32)
    occ[:, [31, 62, 93, 112]] = 1.0   # on the keypoints and between pairs
    w = np.array([1.5, -0.75], np.float32)
    dkp, docc = Pl.chamfer_num_bwd_plain(t(w), t(kp), t(occ), G)
    gk, go = jax.grad(lambda a, b: jnp.sum(_jnp_chamfer_num(a, b, G) * w),
                      argnums=(0, 1))(jnp.asarray(kp), jnp.asarray(occ))
    np.testing.assert_array_equal(dkp.numpy(), np.asarray(gk))
    np.testing.assert_array_equal(docc.numpy(), np.asarray(go))
    # the convention cases are present: exact ties and relu at exactly 0
    V = Pc.coord_maps((G,) * 3).reshape(-1, 3)
    for m in range(2):
        c = t(kp[m])
        vals = (c * c).sum(-1)[None] - 2.0 * (V @ c.T)
        ties = (vals == vals.amin(-1, keepdim=True)).sum(-1)
        dmin = (V * V).sum(-1) + vals.amin(-1)
        assert int((ties > 1).sum()) > 0 and int((dmin == 0).sum()) > 0


def test_chamfer_checks_and_backward_not_ported():
    """The argument checks, and the backward that replaced the
    not-yet-ported error: the autograd function's backward runs the plain
    version on CPU tensors and returns no occupancy gradient unless asked
    (the backward kernel's launch counter does not move on the CPU)."""
    kp = torch.zeros(2, 24, 3)
    with pytest.raises(ValueError):
        Pl.chamfer_num(kp, torch.zeros(2, 100), 8)
    with pytest.raises(TypeError):
        Pl.chamfer_num(kp.double(), torch.zeros(2, 512), 8)
    with pytest.raises(NotImplementedError):
        Pl.volume_fitting_loss(torch.zeros(1, 1, 4, 4, 4, 1),
                               torch.zeros(1, 1, 3, 4), None, "gaussian")
    before = (Pl.launches, Pl.bwd_launches)
    kp = torch.rand(2, 24, 3, generator=torch.Generator().manual_seed(0))
    kp.requires_grad_(True)
    occ = (torch.rand(2, 512, generator=torch.Generator().manual_seed(1))
           < 0.3).float()
    Pl.chamfer_num(kp, occ, 8).sum().backward()
    assert occ.grad is None and kp.grad.shape == kp.shape
    want, _ = Pl.chamfer_num_bwd_plain(torch.ones(2), kp.detach(), occ, 8)
    assert torch.equal(kp.grad, want)
    assert (Pl.launches, Pl.bwd_launches) == before
