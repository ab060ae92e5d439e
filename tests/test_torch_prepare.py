"""The port's offline preparers against the JAX package's, on the
fabricated raw inputs of tests/test_prepare_scripts.py (a cube mesh, a
tiny SMPL-layout model, a 2-frame registrations hdf5, AIST++ motion
pickles): surface samples, the SMPL forward and both ``main()``s, every
written array equal to the bit; the written trees read by the port's
``AIST`` and ``DFAUST`` datasets as the JAX datasets read them; and
``prepare_dfaust.main`` raising without ``h5py``. About 10 s.
"""
import builtins
import os
import pickle

import numpy as np
import pytest

from neural_marionette_tpu.config import MarionetteConfig as JaxConfig
from neural_marionette_tpu.data import datasets as jax_datasets
from neural_marionette_tpu.data import meshsample as jax_meshsample
from neural_marionette_tpu.data import prepare_aistpp as jax_aistpp
from neural_marionette_tpu.data import prepare_dfaust as jax_dfaust
from neural_marionette_tpu.data import smpl_np as jax_smpl

from neural_marionette_tpu_torch.config import MarionetteConfig
from neural_marionette_tpu_torch.data import datasets, meshsample, smpl_np
from neural_marionette_tpu_torch.data import prepare_aistpp, prepare_dfaust

from test_prepare_scripts import _cube_mesh, _write_tiny_smpl


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _assert_same_tree(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for rel in ta:
        if rel.endswith(".npy"):
            x, y = np.load(os.path.join(a, rel)), np.load(os.path.join(b, rel))
            assert x.dtype == y.dtype and x.shape == y.shape, rel
            np.testing.assert_array_equal(x, y, err_msg=rel)
        assert ta[rel] == tb[rel], rel


def test_surface_samples_equal_to_the_bit():
    verts, faces = _cube_mesh(scale=1.7)
    for fn in ("face_normals", "face_areas"):
        np.testing.assert_array_equal(getattr(meshsample, fn)(verts, faces),
                                      getattr(jax_meshsample, fn)(verts,
                                                                  faces))
    for seed in (0, 1):
        a = meshsample.sample_surface(verts, faces, 500,
                                      np.random.default_rng(seed))
        b = jax_meshsample.sample_surface(verts, faces, 500,
                                          np.random.default_rng(seed))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        pn = meshsample.sample_surface_with_normals(
            verts, faces, 64, np.random.default_rng(seed))
        assert pn.dtype == np.float32 and pn.shape == (64, 6)
        np.testing.assert_array_equal(
            pn, jax_meshsample.sample_surface_with_normals(
                verts, faces, 64, np.random.default_rng(seed)))
    with pytest.raises(ValueError):
        meshsample.sample_surface(np.zeros((3, 3)), np.array([[0, 1, 2]]), 4)


def test_smpl_forward_equal_to_the_bit(tmp_path):
    model = str(tmp_path / "smpl.pkl")
    _write_tiny_smpl(model)
    # an .npz model with pose blendshapes and explicit parents
    with open(model, "rb") as f:
        data = pickle.load(f)
    g = np.random.default_rng(5)
    npz = str(tmp_path / "smpl.npz")
    np.savez(npz, v_template=data["v_template"],
             J_regressor=data["J_regressor"], weights=data["weights"],
             parents=np.concatenate([[-1], np.arange(23)]), faces=data["f"],
             posedirs=g.normal(0, 0.01, (8, 3, 207)))
    T = 4
    go, bp = g.normal(0, 0.4, (T, 1, 3)), g.normal(0, 0.3, (T, 23, 3))
    trans = g.normal(0, 1, (T, 3))
    for path in (model, npz):
        port, ref = smpl_np.SMPLNumpy(path), jax_smpl.SMPLNumpy(path)
        np.testing.assert_array_equal(port.parents, ref.parents)
        np.testing.assert_array_equal(port.faces, ref.faces)
        v = port.forward(go, bp, trans, scaling=1.3)
        np.testing.assert_array_equal(v, ref.forward(go, bp, trans, 1.3))
        np.testing.assert_array_equal(port.joints_from_vertices(v),
                                      ref.joints_from_vertices(v))
    np.testing.assert_array_equal(smpl_np.rodrigues(bp),
                                  jax_smpl.rodrigues(bp))


def _write_dfaust_raw(root):
    """A 2-frame registrations hdf5 and its subjects file (the fixture of
    tests/test_prepare_scripts.py); returns the main() flags."""
    import h5py
    verts, faces = _cube_mesh()
    droot = root / "D-FAUST"
    droot.mkdir(parents=True)
    with h5py.File(droot / "registrations_m.hdf5", "w") as f:
        f["50002_chicken_wings"] = np.stack(
            [verts, verts + [0.1, 0.0, 0.0]]).transpose(1, 2, 0)
        f["faces"] = faces
    subjects = root / "subjects_and_sequences.txt"
    subjects.write_text("50002 (male)\n  chicken_wings\n  missing_seq\n")
    return ["--path", str(droot), "--subjects_file", str(subjects),
            "--n_points", "64"]


def test_prepare_dfaust_main_equal_to_the_bit(tmp_path):
    pytest.importorskip("h5py")
    trees = []
    for side, main in (("port", prepare_dfaust.main),
                       ("jax", jax_dfaust.main)):
        root = tmp_path / side
        main(_write_dfaust_raw(root))
        surface = root / "D-FAUST" / "surface"
        trees.append(surface)
        # the manual split placement (as upstream), for the datasets
        split = surface / "train" / "50002"
        split.mkdir(parents=True)
        os.rename(surface / "50002" / "chicken_wings.npy",
                  split / "chicken_wings.npy")
    _assert_same_tree(*trees)
    kw = dict(grid_size=32, Ttot=2, sample_rate=1, n_points=32,
              dataset="dfaust")
    port = datasets.DFAUST(train=True, options=MarionetteConfig(
        data_root=str(tmp_path / "port"), **kw))
    ref = jax_datasets.DFAUST(train=True, options=JaxConfig(
        data_root=str(tmp_path / "jax"), **kw))
    assert len(port) == len(ref) == 1
    np.testing.assert_array_equal(port[0], ref[0])


def test_prepare_dfaust_raises_without_h5py(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_h5py(name, *a, **kw):
        if name == "h5py" or name.startswith("h5py."):
            raise ImportError("No module named 'h5py'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="prepare_dfaust needs h5py"):
        prepare_dfaust.main(["--path", str(tmp_path)])


def _write_aistpp_raw(root, model):
    """AIST++ motion pickles and an ignore list (the fixture of
    tests/test_prepare_scripts.py); returns the main() flags."""
    anno = root / "aist_plusplus_final"
    motions = anno / "motions"
    motions.mkdir(parents=True)
    rng = np.random.default_rng(3)
    names = [f"gBR_sBM_cAll_d{i:02d}_mBR0_ch{i:02d}" for i in range(12)]
    for name in names:
        with open(motions / (name + ".pkl"), "wb") as f:
            pickle.dump({"smpl_poses": rng.normal(0, 0.1, (3, 72)),
                         "smpl_scaling": np.array([1.5]),
                         "smpl_trans": rng.normal(0, 0.5, (3, 3))}, f)
    (anno / "ignore_list.txt").write_text(names[0] + "\n")
    return ["--anno_dir", str(anno), "--smpl_model", model,
            "--save_dir", str(root / "aist_plusplus_smpl_joints"),
            "--n_points", "64"]


def test_prepare_aistpp_main_equal_to_the_bit(tmp_path):
    model = str(tmp_path / "smpl.pkl")
    _write_tiny_smpl(model)
    trees = []
    for side, main in (("port", prepare_aistpp.main),
                       ("jax", jax_aistpp.main)):
        root = tmp_path / side
        main(_write_aistpp_raw(root, model))
        trees.append(root / "aist_plusplus_smpl_joints")
    _assert_same_tree(*trees)
    aff = np.load(trees[0] / "gt_affinity.npy")
    assert aff.shape == (24, 24) and aff.sum() == 2 * 23
    kw = dict(grid_size=32, Ttot=2, sample_rate=1, n_points=32,
              dataset="aist", is_eval=1)
    for train in (True, False):
        port = datasets.AIST(train=train, options=MarionetteConfig(
            data_root=str(tmp_path / "port"), **kw), align_root=True)
        ref = jax_datasets.AIST(train=train, options=JaxConfig(
            data_root=str(tmp_path / "jax"), **kw), align_root=True)
        assert len(port) == len(ref) >= 1
        for i in range(len(port)):
            for a, b in zip(port[i], ref[i]):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(port.gt_affinity(), ref.gt_affinity())
        np.testing.assert_array_equal(port.gt_affinity(), aff)
