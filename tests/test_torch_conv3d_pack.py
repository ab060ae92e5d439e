"""The host side of kernels K3 and K4, on the CPU: the packed weight that
the conv kernel reads, the cache that packs it once per parameter version,
the brick geometry of K4's moment partials, and K4's pass 2 split into the
reduce and the elementwise pass. The kernels themselves run only on a card
(``chip_smoke.py`` holds them against these plain versions there).

Tolerances: the packing and its cache move bf16 values without arithmetic,
so they are compared exactly; sums over bricks are float32 sums of the same
values in another order, within 1e-5 of the total's magnitude.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_marionette_tpu.ops.pallas import fusedstage_kernel as jax_k4

from neural_marionette_tpu_torch.models import NeuralMarionette, blocks
from neural_marionette_tpu_torch.ops import conv3d as K3
from neural_marionette_tpu_torch.ops import fusedstage as K4
from neural_marionette_tpu_torch.train import create_train_state

from _torch_port import configs

BF16 = torch.bfloat16
CSRC = Path(K3.__file__).resolve().parents[1] / "csrc" / "conv3d.cu"


def _weight(k, cin, cout, seed=0):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.normal(size=(k, k, k, cin, cout)).astype(
        np.float32))


# ------------------------------------------------------------ the packing
def unpack_weight(wp, k, cin, cout):
    """Inverse of ``pack_weight``: ``(k, k, k, cin, cout)`` bfloat16."""
    ntiles, taps, cg, nt, _ = wp.shape
    w = wp.permute(1, 2, 4, 0, 3).reshape(taps, cg * 8, ntiles * nt)
    return w[:, :cin, :cout].reshape(k, k, k, cin, cout)


@pytest.mark.parametrize("k,cin,cout", [(3, 32, 32), (3, 48, 72),
                                        (3, 72, 48), (3, 128, 128),
                                        (3, 32, 256), (5, 40, 20)])
def test_pack_weight_round_trips(k, cin, cout):
    """The packed layout (N tiles, k^3, cin_pad / 8, nt, 8) holds w[tap,
    8 cg + j, nt tile + n] at [tile, tap, cg, n, j], zeros beyond (Cin,
    Cout), and unpacks to the bf16 weight."""
    w = _weight(k, cin, cout)
    wp = K3.pack_weight(w)
    nt = K3.tile_n(cout)
    cin_pad = -(-cin // K3.CHUNK) * K3.CHUNK
    assert wp.dtype == BF16 and wp.is_contiguous()
    assert wp.shape == (-(-cout // nt), k ** 3, cin_pad // 8, nt, 8)
    wb = w.to(BF16).reshape(k ** 3, cin, cout)
    g = np.random.default_rng(1)
    for _ in range(50):
        tile, tap = g.integers(wp.shape[0]), g.integers(k ** 3)
        cg, n, j = g.integers(cin_pad // 8), g.integers(nt), g.integers(8)
        ci, co = 8 * cg + j, tile * nt + n
        want = wb[tap, ci, co] if ci < cin and co < cout else 0.0
        assert float(wp[tile, tap, cg, n, j]) == float(want)
    assert torch.equal(unpack_weight(wp, k, cin, cout), w.to(BF16))
    full = unpack_weight(wp, k, cin_pad, wp.shape[0] * nt)
    assert not full[..., cin:, :].any() and not full[..., cout:].any()


def test_tiling_mirrors_the_kernel_source():
    """``ops/conv3d.py``'s tiling constants are those of csrc/conv3d.cu
    (the library checks the same at its first launch on a card)."""
    src = CSRC.read_text()
    assert int(re.search(r"constexpr int CK = (\d+);", src)[1]) == K3.CHUNK
    assert int(re.search(r"constexpr int BY = (\d+);", src)[1]) == K3.BRICK_Y
    tiles = {int(n): (int(z), 8 * int(x)) for n, z, x in re.findall(
        r"struct Tile<(\d+)> \{ static constexpr int ZT = (\d+), XT = "
        r"(\d+); \};", src)}
    assert tiles == K3._BRICK
    for cout, nt in ((8, 32), (32, 32), (48, 64), (64, 64), (72, 128),
                     (128, 128), (256, 128)):
        assert K3.tile_n(cout) == nt
        zt, bx = tiles[nt]
        assert K3.brick(cout) == (zt, 8, bx)
        assert zt * bx // 8 * nt // 2 == 128   # accumulators a thread


# -------------------------------------------------------------- the cache
def _conv_params(cin=32, cout=48):
    m = torch.nn.Conv3d(cin, cout, 3, padding=1)
    return m.weight, m.bias


def test_packed_cache_hits_for_an_unchanged_parameter():
    w, b = _conv_params()
    first = K3.packed_operands(w, b, channels_first=True)
    again = K3.packed_operands(w, b, channels_first=True)
    assert again[0] is first[0] and again[1] is first[1]
    assert torch.equal(first[0], K3.pack_weight(w.permute(2, 3, 4, 1, 0)))
    assert torch.equal(first[1], b.to(BF16))
    with torch.inference_mode():   # the key is the parameter, not a cast
        assert K3.packed_operands(w, b, channels_first=True)[0] is first[0]
        cast = w.to(BF16)          # an inference tensor: packed anew
        wp = K3.packed_operands(cast, b.to(BF16), channels_first=True)[0]
    assert torch.equal(wp, first[0]) and wp is not first[0]


def test_packed_cache_repacks_after_an_in_place_update():
    w, b = _conv_params()
    first = K3.packed_operands(w, b, channels_first=True)
    with torch.no_grad():
        w.mul_(2.0)
    second = K3.packed_operands(w, b, channels_first=True)
    assert second[0] is not first[0]
    assert torch.equal(second[0], K3.pack_weight(w.permute(2, 3, 4, 1, 0)))
    assert torch.equal(second[1], first[1])
    with torch.no_grad():
        b.copy_(torch.ones_like(b))
    third = K3.packed_operands(w, b, channels_first=True)
    assert third[1] is not second[1] and torch.equal(third[1],
                                                     torch.ones(48, dtype=BF16))


def test_packed_cache_repacks_after_an_adam_step():
    """One step of ``train/state.Adam`` (in-place ``_foreach`` updates) on a
    tiny routed model: every routed conv's cached pack is replaced by the
    pack of its updated weight."""
    _, cfg = configs()
    net = NeuralMarionette(cfg, dtype=BF16, conv_kernel=True)
    routed = [m for m in net.modules() if isinstance(m, torch.nn.Conv3d)
              and blocks.routes_to_kernel(m, BF16)]
    assert routed
    before = [K3.packed_operands(m.weight, m.bias, channels_first=True)
              for m in routed]
    state = create_train_state(cfg, net, torch.Generator().manual_seed(0))
    opt = state.optimizer
    g = torch.Generator().manual_seed(1)
    opt.update([torch.randn(p.shape, generator=g) for p in opt.params],
               [True] * len(opt.params))
    for m, old in zip(routed, before):
        new = K3.packed_operands(m.weight, m.bias, channels_first=True)
        assert new[0] is not old[0] and not torch.equal(new[0], old[0])
        assert torch.equal(new[0], K3.pack_weight(
            m.weight.permute(2, 3, 4, 1, 0)))


def test_routed_conv_without_gradient_equals_with():
    """``blocks.conv`` skips the casts of w and b where no gradient is
    wanted: the plain version rounds them to bf16 itself, so the outputs
    are equal to the bit."""
    m = torch.nn.Conv3d(32, 40, 3, padding=1)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 32, 5, 6, 7)).astype(np.float32)).to(BF16)
    with torch.no_grad():
        quiet = blocks.conv(m, x, BF16, True)
    loud = blocks.conv(m, x, BF16, True)
    assert loud.requires_grad and not quiet.requires_grad
    assert torch.equal(quiet, loud.detach())


# ------------------------------------------------ the stats partials' geometry
@pytest.mark.parametrize("shape", [(2, 5, 9, 11, 40), (3, 2, 2, 2, 72),
                                   (1, 64, 3, 17, 256), (1, 7, 8, 8, 32),
                                   (2, 4, 12, 4, 48)])
def test_brick_partials_match_the_kernel_tiling(shape):
    """For ragged D, H, W: (F, stats_tiles, 2, C), bricks of brick(C)
    voxels clipped to the grid, x fastest, then y, then z; their sums add
    up to the frame's."""
    Fr, D, H, W, C = shape
    zt, by, bx = K3.brick(C)
    tiles = K3.stats_tiles(D, H, W, C)
    assert tiles == -(-D // zt) * -(-H // by) * -(-W // bx)
    ones = K3.brick_partials_plain(torch.ones(shape))
    assert ones.shape == (Fr, tiles, 2, C)
    nx, ny = -(-W // bx), -(-H // by)
    for t in range(tiles):
        bz, r = divmod(t, nx * ny)
        iy, ix = divmod(r, nx)
        count = (min(zt, D - bz * zt) * min(by, H - iy * by)
                 * min(bx, W - ix * bx))
        assert bool((ones[:, t] == count).all()), t
    y = torch.from_numpy(np.random.default_rng(3).normal(size=shape).astype(
        np.float32))
    part = K3.brick_partials_plain(y)
    for i, want in enumerate((y.sum(dim=(1, 2, 3)), (y * y).sum(
            dim=(1, 2, 3)))):
        got = part[:, :, i].sum(dim=1)
        assert float((got - want).abs().max()) <= 1e-5 * float(
            (y.abs() if i == 0 else y * y).sum())


# ------------------------------------------------------------ K4's pass 2
def test_normalize_split_is_the_old_pass_2():
    """``_normalize`` (the plain reduce and pass 2) is ``group_stats`` then
    ``normalize_plain``; ``normalize`` takes the plain version for a CPU y,
    launches nothing, and keeps y's dtype and memory layout."""
    g = np.random.default_rng(4)
    Fr, D, H, W, C, ng = 2, 3, 4, 5, 48, 3
    y = torch.from_numpy(g.normal(size=(Fr, C, D, H, W)).astype(
        np.float32)).to(BF16).permute(0, 2, 3, 4, 1)
    yf = y.float()
    s, q = yf.sum(dim=(1, 2, 3)), (yf * yf).sum(dim=(1, 2, 3))
    sc, bi = (torch.from_numpy(g.normal(m, 0.1, C).astype(np.float32))
              for m in (1.0, 0.0))
    mean, inv = K4.group_stats(s, q, ng, float(D * H * W * C // ng), 1e-5)
    assert mean.shape == inv.shape == (Fr, C)
    Cg = C // ng
    want_mean = s.reshape(Fr, ng, Cg).sum(-1) / (D * H * W * Cg)
    assert torch.equal(mean[:, ::Cg], want_mean)
    launches = K4.pass2_launches
    got = K4.normalize(y, mean, inv, sc, bi)
    assert K4.pass2_launches == launches
    assert got.dtype == BF16 and got.stride() == y.stride()
    assert torch.equal(got, K4._normalize(y, s, q, sc, bi, ng, 1e-5))
    z = ((yf - mean[:, None, None, None]) * inv[:, None, None, None]) * sc \
        + bi
    assert torch.equal(got, torch.where(z > 0, z, z * 0.01).to(BF16))
    with pytest.raises(ValueError, match="unsupported device"):
        K4.normalize(y.to("meta"), mean, inv, sc, bi)


def test_fused_stage_plain_matches_jax_fused_stage_f32():
    """K4's plain path in float32 against the JAX kernel in interpret mode
    (the bf16 case is ``test_torch_conv3d.test_fused_stage_matches_pallas``):
    the conv's float32 sums in other orders, carried by the GroupNorm's
    gain of about 1, 1e-4 of the largest |ref|."""
    g = np.random.default_rng(5)
    x = g.normal(0, 1, (2, 6, 6, 6, 32)).astype(np.float32)
    w = g.normal(0, 0.05, (3, 3, 3, 32, 32)).astype(np.float32)
    b, sc, bi = (g.normal(m, 0.1, (32,)).astype(np.float32)
                 for m in (0, 1, 0))
    want = np.asarray(jax_k4.fused_stage(
        *(jnp.asarray(a) for a in (x, w, b, sc, bi))), np.float32)
    got = K4.fused_stage(*(torch.from_numpy(a) for a in (x, w, b, sc, bi)))
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err
