"""The port's data layer against the JAX package's, on the CPU: every
dataset family on fixture trees in the reference's layouts, the loader,
the prefetcher, the native host library, and the trainer's input.

Items and batches must equal the JAX package's to the bit (same values,
same dtype); the loader's batches must be the same at every
``num_workers``. The native voxelizer must equal the JAX package's to the
bit, normalization within 2e-6 (the host library computes in float32, the
plain version in float64), the crop exactly. About 25 s on one core.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

from neural_marionette_tpu.data import DataLoader as JaxDataLoader
from neural_marionette_tpu.data import load_dataset as jax_load_dataset
from neural_marionette_tpu.data import native as jax_native
from neural_marionette_tpu.data.pipeline import \
    window_from_sequence as jax_window

from neural_marionette_tpu_torch import kernels
from neural_marionette_tpu_torch.data import (DATASETS, DataLoader,
                                              load_dataset,
                                              prefetch_to_device)
from neural_marionette_tpu_torch.data import native
from neural_marionette_tpu_torch.data.pipeline import (crop_sequence,
                                                       episodic_normalization,
                                                       window_from_sequence)
from neural_marionette_tpu_torch.ops.voxelize import voxelize_np
from neural_marionette_tpu_torch.train import Trainer

from _torch_port import configs
from test_real_layout import _write_aist_tree

T, RATE, N_POINTS = 4, 2, 256
# frames of the stored sequences: long, between T and T*RATE (no padding,
# a short crop), below T (padded); points above, below and at N_POINTS
SEQS = [(12, 300), (6, 200), (3, 256), (15, 256)]
K_GT = 5


def _save(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, arr)


def _clip(g, frames, n):
    pts = g.uniform(-0.5, 0.5, size=(frames, n, 3)).astype(np.float32)
    return pts + np.linspace(0, 0.3, frames, dtype=np.float32)[:, None,
                                                               None]


def _joints(g, frames):
    return g.uniform(-0.5, 0.5, size=(frames, K_GT, 3)).astype(np.float32)


def _write_family(root, name, g):
    """A fixture tree of dataset family ``name`` with the SEQS sequences
    per split, in the reference's on-disk layout."""
    for split in ("train", "test"):
        for i, (frames, n) in enumerate(SEQS):
            pts = _clip(g, frames, n)
            if name == "dfaust":
                _save(f"{root}/D-FAUST/surface/{split}/s{i % 2}/seq{i}.npy",
                      pts)
            elif name in ("animals", "humanoids"):
                _save(f"{root}/DeformingThings4D/{name}/{split}/a{i % 2}/"
                      f"m{i}.npy", pts)
            elif name == "panda":
                base = f"{root}/panda_gripper/{split}"
                _save(f"{base}/vertices/p{i}_run_vertices.npy", pts)
                _save(f"{base}/centroids/p{i}_run_centroids.npy",
                      _joints(g, frames))
            elif name == "hands":
                _save(f"{root}/InterHand2.6Mnpy/{split}/ep{i % 2}/"
                      f"{'left' if i % 3 else 'right'}/f{i}.npy", pts)
            elif name == "hanco":
                base = f"{root}/HanCo/{split}"
                _save(f"{base}/vertices/h{i}_vertices.npy", pts)
                _save(f"{base}/joints/h{i}_joints.npy", _joints(g, frames))
            elif name == "aist":
                base = f"{root}/aist_plusplus_smpl_joints"
                _save(f"{base}/surface/{split}/g{i}.npy", pts)
                _save(f"{base}/joints/{split}/g{i}.npy", _joints(g, frames))
                c, s = np.cos(0.3 * np.arange(frames)), np.sin(
                    0.3 * np.arange(frames))
                rots = np.zeros((frames, 3, 3), np.float32)
                rots[:, 0, 0] = rots[:, 2, 2] = c
                rots[:, 0, 2], rots[:, 2, 0], rots[:, 1, 1] = s, -s, 1
                _save(f"{base}/root_aligns/{split}/g{i}.npy", rots)
    if name == "aist":
        _save(f"{root}/aist_plusplus_smpl_joints/gt_affinity.npy",
              np.eye(K_GT, k=1, dtype=np.float32)
              + np.eye(K_GT, k=-1, dtype=np.float32))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("families"))
    g = np.random.default_rng(0)
    for name in DATASETS:
        if name != "synthetic":
            _write_family(root, name, g)
    return root


def _cfgs(root, **kw):
    base = dict(data_root=root, Ttot=T, sample_rate=RATE, n_points=N_POINTS,
                nbatch=2, seed=3)
    base.update(kw)
    return configs(**base)


def _assert_same(a, b):
    if isinstance(b, tuple):
        assert isinstance(a, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("random_crop,is_eval", [(0, 0), (1, 0), (0, 1),
                                                 (1, 1)])
@pytest.mark.parametrize("family", sorted(DATASETS))
def test_items_equal_jax_to_the_bit(trees, family, random_crop, is_eval):
    """``load_dataset(...)[i]`` for every item, both splits, epochs 0-2, in
    one order on both sides (the generators advance item by item)."""
    jcfg, cfg = _cfgs(trees, dataset=family, random_crop=random_crop,
                      is_eval=is_eval)
    kw = dict(n_sequences=4, seq_len=9) if family == "synthetic" else {}
    for train in (True, False):
        jds, ds = jax_load_dataset(train, jcfg, **kw), load_dataset(
            train, cfg, **kw)
        assert ds.seq_path == jds.seq_path and len(ds) == len(jds) > 0
        for epoch in range(3):
            jds.log_epoch(epoch)
            ds.log_epoch(epoch)
            for i in range(len(ds)):
                _assert_same(ds[i], jds[i])
        if is_eval and family in ("aist", "panda", "hanco", "synthetic"):
            assert isinstance(ds[0], tuple)
        jaff, aff = jds.gt_affinity(), ds.gt_affinity()
        assert (aff is None) == (jaff is None)
        if aff is not None:
            _assert_same(aff, jaff)


@pytest.mark.parametrize("is_eval", [0, 1])
def test_aist_align_root_and_voxels_equal_jax(trees, is_eval):
    """``align_root`` (the window-start frame's rotation, renormalized) and
    ``output="voxels"`` (the port's native library against the JAX one)."""
    jcfg, cfg = _cfgs(trees, dataset="aist", random_crop=1, is_eval=is_eval,
                      grid_size=16)
    for kw in (dict(align_root=True), dict(output="voxels"),
               dict(align_root=True, output="voxels")):
        jds, ds = jax_load_dataset(True, jcfg, **kw), load_dataset(
            True, cfg, **kw)
        for epoch in range(2):
            jds.log_epoch(epoch)
            ds.log_epoch(epoch)
            for i in range(len(ds)):
                _assert_same(ds[i], jds[i])


def test_short_sequences_both_padding_orders():
    """A short clip (below T, and between T and T*RATE) windows as the JAX
    function does under either padding order, through the port's one path."""
    import random
    g = np.random.default_rng(5)
    for frames in (2, 3, 5, 7):
        x = g.uniform(-1, 1, size=(frames, 16, 3)).astype(np.float32)
        j = g.uniform(-1, 1, size=(frames, 3, 3)).astype(np.float32)
        for pad_first in (False, True):
            want = jax_window(x, T, RATE, True, 1, random.Random(0), joints=j,
                              short_pad_first=pad_first)
            got = window_from_sequence(x, T, RATE, True, 1, random.Random(0),
                                       joints=j)
            _assert_same(got, want)


def test_synthetic_memo_and_gt_affinity():
    jcfg, cfg = _cfgs("", dataset="synthetic", is_eval=1, nkeypoints=6)
    jds = jax_load_dataset(True, jcfg, n_sequences=3, seq_len=9)
    ds = load_dataset(True, cfg, n_sequences=3, seq_len=9)
    _assert_same(ds.gt_affinity(), jds.gt_affinity())
    first = ds[1]
    assert set(ds._memo) == {int(ds.seq_path[1].split("_")[1])}
    _assert_same(ds._load_points(ds.seq_path[1]), jds._load_points(
        jds.seq_path[1]))
    assert first[0].shape == (T, N_POINTS, 3)


def test_unknown_dataset_raises_like_jax():
    jcfg, cfg = _cfgs("", dataset="nope")
    with pytest.raises(ValueError) as want:
        jax_load_dataset(True, jcfg)
    with pytest.raises(ValueError) as got:
        load_dataset(True, cfg)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------ loader
def _batches(loader, epochs, ds):
    out = []
    for epoch in range(epochs):
        ds.log_epoch(epoch)
        out += list(loader)
    return out


def _long_aist(tmp_path, n=7):
    """An AIST tree whose sequences all fit a window (stackable items)."""
    root = str(tmp_path)
    _write_aist_tree(root, n_train=n, n_test=2)
    return root


@pytest.mark.parametrize("random_crop", [0, 1])
def test_loader_equals_jax_at_zero_workers_and_any_count(tmp_path,
                                                          random_crop):
    """Batches of ``(points, joints)`` over two epochs, shuffled: the JAX
    loader's at num_workers=0, the same at 0, 2 and 4 workers (the JAX
    loader's depend on thread timing there)."""
    root = _long_aist(tmp_path)
    jcfg, cfg = _cfgs(root, dataset="aist", random_crop=random_crop,
                      is_eval=1)
    jds = jax_load_dataset(True, jcfg)
    want = _batches(JaxDataLoader(jds, 2, seed=4, num_workers=0), 2, jds)
    assert len(want) == 6
    for workers in (0, 2, 4):
        ds = load_dataset(True, cfg)
        with DataLoader(ds, 2, seed=4, num_workers=workers) as loader:
            got = _batches(loader, 2, ds)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)


def test_loader_drop_last_and_process_slices(tmp_path):
    root = _long_aist(tmp_path)
    jcfg, cfg = _cfgs(root, dataset="aist", random_crop=1, is_eval=0)
    jds, ds = jax_load_dataset(True, jcfg), load_dataset(True, cfg)
    want = list(JaxDataLoader(jds, 3, seed=1, num_workers=0,
                              drop_last=False))
    loader = DataLoader(ds, 3, seed=1, num_workers=2, drop_last=False)
    got = list(loader)
    assert len(loader) == 3 and [b.shape[0] for b in got] == [3, 3, 1]
    for a, b in zip(got, want):
        _assert_same(a, b)
    assert len(DataLoader(ds, 3, num_workers=0)) == 2
    assert len(list(DataLoader(ds, 3, num_workers=0))) == 2
    # two processes: each materializes its half of every global batch,
    # drawing the same order as one process does
    whole = list(DataLoader(load_dataset(True, cfg), 4, seed=2,
                            num_workers=0))
    halves = [list(DataLoader(load_dataset(True, cfg), 4, seed=2,
                              num_workers=2, process_index=p,
                              process_count=2)) for p in (0, 1)]
    jhalves = [list(JaxDataLoader(jax_load_dataset(True, jcfg), 4, seed=2,
                                  num_workers=0, process_index=p,
                                  process_count=2)) for p in (0, 1)]
    assert len(whole) == 1 and [len(h) for h in halves] == [1, 1]
    for p in (0, 1):
        _assert_same(halves[p][0], jhalves[p][0])
        assert halves[p][0].shape[0] == 2
    with pytest.raises(ValueError):
        DataLoader(ds, 3, process_count=2)
    with pytest.raises(ValueError):
        DataLoader(ds, 4, process_count=2, drop_last=False)


def test_prefetch_passes_tensors_through_on_the_cpu(tmp_path):
    root = _long_aist(tmp_path, n=4)
    _, cfg = _cfgs(root, dataset="aist", random_crop=1, is_eval=1)
    host = list(DataLoader(load_dataset(True, cfg), 2, num_workers=0))
    got = list(prefetch_to_device(iter(host), buffer_size=2, device="cpu"))
    assert len(got) == len(host) == 2
    for (p, j), (hp, hj) in zip(got, host):
        assert isinstance(p, torch.Tensor) and p.device.type == "cpu"
        assert np.array_equal(p.numpy(), hp) and np.array_equal(j.numpy(), hj)
    t = torch.zeros(2, 3)
    assert next(prefetch_to_device(iter([t]), device="cpu")) is t
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(prefetch_to_device(iter(host)))


# ---------------------------------------------------------- native library
def _points_with_out_of_range(seed):
    g = np.random.default_rng(seed)
    pts = g.uniform(-1, 1, size=(6, 700, 3)).astype(np.float32)
    pts[0, :50] = g.uniform(-3, 3, size=(50, 3))        # off the grid
    pts[1, :3] = [[-1, -1, -1], [1, 1, 1], [1.5, -1.5, 0]]
    pts[2, :] = 1.0 - 1e-7
    return pts


@pytest.mark.parametrize("G", [5, 16, 32])
def test_native_voxelizer_equals_jax_native(G):
    assert jax_native.available()
    pts = _points_with_out_of_range(G)
    got = native.voxelize_batch(pts, G)
    want = jax_native.voxelize_batch(pts, G)
    _assert_same(got, want)
    plain = np.stack([voxelize_np(f, G) for f in pts])
    _assert_same(got, plain)


def test_native_normalize_and_crop():
    g = np.random.default_rng(1)
    seq = g.uniform(-5, 9, size=(7, 300, 3)).astype(np.float32)
    joints = g.uniform(-5, 9, size=(7, 6, 3)).astype(np.float32)
    got, gj = native.normalize_episodic(seq, 0.9, 0.1, -0.2, joints=joints)
    want, wj = jax_native.normalize_episodic(seq, 0.9, 0.1, -0.2,
                                             joints=joints)
    plain, pj = episodic_normalization(seq.astype(np.float64), 0.9, 0.1,
                                       -0.2, joints=joints)
    for a, b in ((got, want), (gj, wj), (got, plain), (gj, pj)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)
    np.testing.assert_allclose(native.normalize_episodic(seq),
                               episodic_normalization(seq), rtol=0,
                               atol=2e-6)
    for start, n, rate in ((0, 3, 2), (2, 5, 1), (6, 1, 3), (0, 0, 1)):
        _assert_same(native.crop_strided(seq, start, n, rate),
                     crop_sequence(seq, start, n, rate))
    with pytest.raises(ValueError):
        native.crop_strided(seq, 4, 3, 2)
    with pytest.raises(ValueError):
        native.voxelize_batch(seq[0], 8)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No fallback: a library that does not compile raises."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "nm_host.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(kernels, "CSRC", src)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(kernels, "_LIBS", {})
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="build failed"):
        native.voxelize_batch(np.zeros((1, 4, 3), np.float32), 8)
    assert not list((tmp_path / "_build").glob("*.so"))


# ------------------------------------------------------ the trainer's input
@pytest.fixture(scope="module")
def tiny_trainer():
    _, cfg = configs(detector_start=0, learner_start=int(1e9),
                     affinity_anneal=0, save_every=100)
    return Trainer(cfg, device="cpu", dtype="float32")


@contextlib.contextmanager
def _recording_step(trainer):
    """The batches the phase's train step is given, while in the block."""
    key = trainer.sched.phase_key()
    step = trainer.phase_step()
    seen = []

    def recording(state, batch, sk):
        seen.append(batch)
        return step(state, batch, sk)

    trainer._steps[key] = recording
    try:
        yield seen
    finally:
        trainer._steps[key] = step


def test_trainer_takes_loader_tuples(tiny_trainer, tmp_path):
    """A ``(points, joints)`` batch (what every is_eval dataset yields)
    trains on its points."""
    root = _long_aist(tmp_path, n=4)
    _, cfg = _cfgs(root, dataset="aist", random_crop=1, is_eval=1,
                   grid_size=32)
    batches = list(DataLoader(load_dataset(True, cfg), 2, num_workers=0))
    assert isinstance(batches[0], tuple)
    with _recording_step(tiny_trainer) as seen:
        record = tiny_trainer.train_epoch(0, batches)
    assert len(seen) == 2
    for got, (pts, _) in zip(seen, batches):
        assert np.array_equal(got.numpy(), pts)
    assert np.isfinite(record["train"]["total_loss"])


def test_trainer_takes_device_tensors_without_a_copy(tiny_trainer):
    """A tensor on the step's device reaches the step as it is, alone or
    in a tuple; numpy input is still converted to float32."""
    g = np.random.default_rng(2)
    t = torch.from_numpy(g.uniform(-0.5, 0.5, size=(2, T, 64, 3)).astype(
        np.float32))
    with _recording_step(tiny_trainer) as seen:
        tiny_trainer.train_epoch(0, [t, (t, torch.zeros(2, T, 5, 3))])
    assert [s.data_ptr() for s in seen] == [t.data_ptr()] * 2
    with _recording_step(tiny_trainer) as seen:
        tiny_trainer.train_epoch(0, [t.numpy().astype(np.float64)])
    assert seen[0].dtype == torch.float32 and torch.equal(seen[0], t)
