"""K1's partition of work (``csrc/voxelize.cu``) emulated in numpy, against
the JAX package's voxelizers and the port's plain version on the CPU.

The kernel runs only on the card. What it does, in the order it does it,
is emulated here:

* ``SLABS`` blocks per frame; block s owns the voxels
  ``[s * chunk, min((s + 1) * chunk, G^3))``, ``chunk`` = G^3 / SLABS
  rounded up to whole 32-bit words, as a bitmask (plus one zero pad word);
* every block reads all of its frame's points, computes each point's cell
  in float32 with a true division, and sets the bits of its own range;
* each block expands its mask with ``STORE_BYTES`` stores (a 64-bit window
  of the mask, shifted to the store's first voxel), and writes the
  elements before the first aligned address and after the last whole store
  one by one; the output may start at any element offset.

The emulation counts the writes of every element: each is written exactly
once, and the vector stores are aligned. The geometry (``SLABS``,
``THREADS``, ``STORE_BYTES``) is read from the source.

The JAX side runs ``voxelize_pallas`` in interpret mode, as
tests/test_pallas.py does; its known deviation is excluded as in
tests/test_torch_ops.py: points exactly on a cell boundary (XLA multiplies
by the reciprocal of the step). ``voxelize_pallas`` takes no empty cloud
and casts NaN to an index, so N = 0 and NaN are held against the plain
version and the oracle only.
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_marionette_tpu.ops.pallas import voxelize_pallas

from neural_marionette_tpu_torch.ops import voxelize as Pv

SRC = Path(Pv.__file__).resolve().parents[1] / "csrc" / "voxelize.cu"


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", SRC.read_text())[1])


SLABS, THREADS, STORE_BYTES = (_define(n) for n in (
    "SLABS", "THREADS", "STORE_BYTES"))
f32 = np.float32
GRIDS = (5, 16, 32, 64)
ONE = {2: 0x3F80, 4: 0x3F800000}   # bfloat16 and float32 1.0, as bits


# ------------------------------------------------------------ emulation
def _block_voxels(G3):
    per = -(-G3 // SLABS)
    return -(-per // 32) * 32


def _masks(pts, G):
    """(F, SLABS, words) uint32: each block's mask after the scatter."""
    F = pts.shape[0]
    G3 = G ** 3
    chunk = _block_voxels(G3)
    masks = np.zeros((F, SLABS, chunk // 32 + 1), np.uint32)
    step = f32(2.0 / G + 1e-5)
    with np.errstate(invalid="ignore"):
        cell = np.floor((pts + f32(1.0)) / step)
    ok = ((cell >= 0) & (cell < G)).all(-1)
    i = np.where(ok[..., None], cell, 0).astype(np.int64)
    lin = (i[..., 0] * G + i[..., 1]) * G + i[..., 2]
    for s in range(SLABS):
        v0 = min(s * chunk, G3)
        n = min(v0 + chunk, G3) - v0
        for f in range(F):
            local = lin[f, ok[f]] - v0
            local = local[(local >= 0) & (local < n)]
            np.bitwise_or.at(masks[f, s], local >> 5, np.uint32(1) <<
                             (local & 31).astype(np.uint32))
    return masks


def emulate(masks, G, esize, offset=0):
    """The kernel's output from the blocks' ``masks`` as integer bits, (F,
    G^3) int64, for an output that starts ``offset`` bytes past a 16-byte
    boundary; asserts that every element is written exactly once and every
    vector store is aligned."""
    F = masks.shape[0]
    G3 = G ** 3
    chunk = _block_voxels(G3)
    out = np.zeros(F * G3, np.int64)
    writes = np.zeros(F * G3, np.int64)
    per_store = STORE_BYTES // esize
    lanes = np.arange(per_store)
    for f in range(F):
        for r in range(SLABS):
            m = masks[f, r].astype(np.uint64)
            v0 = min(r * chunk, G3)
            n = min(v0 + chunk, G3) - v0
            first = f * G3 + v0          # element index of the range
            mis = (offset + first * esize) % STORE_BYTES
            head = min(n, (STORE_BYTES - mis) % STORE_BYTES // esize)
            n_vec = (n - head) // per_store
            tail0 = head + n_vec * per_store
            # vector stores: a 64-bit window of the mask at each store
            o = head + np.arange(n_vec) * per_store
            assert ((offset + (first + o) * esize) % STORE_BYTES == 0).all()
            window = (m[(o >> 5) + 1] << np.uint64(32)) | m[o >> 5]
            bits = (window >> (o & 31).astype(np.uint64)).astype(np.int64)
            on = (bits[:, None] >> lanes) & 1
            e = (first + o[:, None] + lanes).ravel()
            out[e] = on.ravel() * ONE[esize]
            writes[e] += 1
            # scalar head and tail
            for s in list(range(head)) + list(range(tail0, n)):
                bit = (int(m[s >> 5]) >> (s & 31)) & 1
                out[first + s] = bit * ONE[esize]
                writes[first + s] += 1
    assert (writes == 1).all(), "an element written other than once"
    return out.reshape(F, G3)


def _bits(t):
    """A float32 or bfloat16 tensor's elements as integer bits."""
    view = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
    bits = t.contiguous().view(view).numpy().astype(np.int64)
    return bits & (0xFFFF if t.dtype == torch.bfloat16 else 0xFFFFFFFF)


def _oracle(pts, G):
    step = np.float32(2.0 / G + 1e-5)
    idx = np.floor((pts + np.float32(1.0)) / step)
    ok = ((idx >= 0) & (idx < G)).all(-1)
    out = np.zeros((pts.shape[0], G ** 3), np.float32)
    for f in range(pts.shape[0]):
        i = idx[f][ok[f]].astype(np.int64)
        out[f, (i[:, 0] * G + i[:, 1]) * G + i[:, 2]] = 1.0
    return out


def _check_against_plain(pts, G):
    """The emulated kernel, in both output types and at two output offsets,
    equals the plain version's bits and the oracle; returns the occupancy."""
    want = _oracle(pts, G)
    masks = _masks(pts, G)
    for dtype, esize, offsets in ((torch.float32, 4, (0, 4)),
                                  (torch.bfloat16, 2, (0, 6))):
        plain = Pv.voxelize_plain(torch.from_numpy(pts), G, dtype=dtype)
        plain_bits = _bits(plain).reshape(pts.shape[0], G ** 3)
        for offset in offsets:
            np.testing.assert_array_equal(emulate(masks, G, esize, offset),
                                          plain_bits)
        np.testing.assert_array_equal(plain.float().numpy().reshape(
            want.shape), want)
    return want


# ------------------------------------------------------------ cases
def _cases(G):
    """name -> (F, N, 3) float32 points at grid G."""
    g = np.random.default_rng(G)
    step = np.float32(2.0 / G + 1e-5)

    def oob(values, n=40):
        out = []
        for axis in range(3):
            for bad in values:
                p = g.uniform(-0.9, 0.9, (1, n, 3))
                p[0, ::2, axis] = bad
                out.append(p)
        return np.concatenate(out, axis=0)

    edges = np.arange(0, G + 2, dtype=np.float32) * step - np.float32(1.0)
    boundary = np.stack(np.meshgrid(edges, edges[::3], edges[::5],
                                    indexing="ij"), -1).reshape(1, -1, 3)
    mixed = g.uniform(-1.05, 1.05, (3, 301, 3))
    mixed[:, 150:] = mixed[:, :151]          # every point twice
    cases = {
        "mixed_ragged": mixed,
        "duplicates": np.zeros((2, 300, 3)) + np.array([0.1, -0.2, 0.3]),
        # around one cell's centre: every point in one voxel, one mask word
        "one_voxel": (g.integers(0, G, 3) + 0.5) * float(step) - 1.0
        + g.uniform(-0.2, 0.2, (1, 777, 3)) * float(step),
        "single_point": g.uniform(-0.9, 0.9, (1, 1, 3)),
        "oob_one_axis": oob((1.0 + float(step) * G, 1.3, 1e9, -1e9, np.inf,
                             -np.inf)),
        "oob_just_below": oob((-1.0 - float(step) / 2, -1.2)),
        "cell_boundaries": boundary,
    }
    return {k: np.ascontiguousarray(v, dtype=np.float32)
            for k, v in cases.items()}


CASES = sorted(_cases(5))


@functools.lru_cache(maxsize=None)
def _pallas(G):
    """voxelize_pallas of every case but cell_boundaries at grid G, in one
    interpreted call: the cases padded to one N with 1e9 (dropped)."""
    cases = {k: v for k, v in _cases(G).items() if k != "cell_boundaries"}
    n = max(v.shape[1] for v in cases.values())
    frames, where = [], {}
    for name, v in cases.items():
        pad = np.full((v.shape[0], n - v.shape[1], 3), 1e9, np.float32)
        where[name] = slice(len(frames), len(frames) + v.shape[0])
        frames.extend(np.concatenate([v, pad], axis=1))
    got = np.asarray(voxelize_pallas(jnp.asarray(np.stack(frames)), G))
    return {k: got[s].reshape(s.stop - s.start, G ** 3)
            for k, s in where.items()}


# ------------------------------------------------------------ tests
@pytest.mark.parametrize("G", [1, 2, 5, 16, 31, 32, 64, 100, 128])
def test_partition_covers_the_grid(G):
    """The blocks' ranges tile [0, G^3) in whole 32-bit words (the last
    ones possibly empty), and the mask fits the card's shared memory."""
    G3 = G ** 3
    chunk = _block_voxels(G3)
    assert chunk % 32 == 0 and chunk * SLABS >= G3
    assert chunk * (SLABS - 1) < G3 + 32 * SLABS
    covered = np.zeros(G3, np.int64)
    for r in range(SLABS):
        v0 = min(r * chunk, G3)
        covered[v0:min(v0 + chunk, G3)] += 1
    assert (covered == 1).all()
    assert (chunk // 32 + 1) * 4 <= 227 * 1024
    assert THREADS % 32 == 0 and STORE_BYTES == 16


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("G", GRIDS)
def test_kernel_order_equals_pallas_and_plain(G, case):
    pts = _cases(G)[case]
    want = _check_against_plain(pts, G)
    if case != "cell_boundaries":
        np.testing.assert_array_equal(_pallas(G)[case], want)
    if case in ("duplicates", "one_voxel"):
        assert want.sum() == pts.shape[0]


@pytest.mark.parametrize("G", GRIDS)
def test_kernel_order_on_empty_and_nan(G):
    """N = 0 writes a grid of zeros; NaN on any axis drops the point."""
    empty = np.zeros((3, 0, 3), np.float32)
    assert _check_against_plain(empty, G).sum() == 0
    g = np.random.default_rng(G + 1)
    pts = g.uniform(-0.9, 0.9, (3, 50, 3)).astype(np.float32)
    for axis in range(3):
        pts[axis, ::3, axis] = np.nan
    want = _check_against_plain(pts, G)
    ok = ~np.isnan(pts).any(-1)
    assert want.sum() <= ok.sum()
    np.testing.assert_array_equal(want, _oracle(
        np.where(ok[..., None], pts, np.float32(1e9)), G))
