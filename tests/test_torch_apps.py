"""The demo apps of the port against the JAX package, on the CPU:
``retarget.extract_skin_weights`` and ``retarget_motion`` (equal to the
bit), ``apps.run_generation``, ``run_interpolation`` and ``run_retarget``
through the port's ``Marionette`` against JAX ``DemoContext`` runs on the
same weights and noise, ``load_pretrained`` / ``Marionette.load`` from the
port's checkpoint tree and from a reference ``opt.pickle`` + ``.pth`` (equal
to the bit to the JAX package's ``load_reference_checkpoint``), the tree
with no checkpoint, the clip and OBJ readers, and the entry points' JAX
defaults.

Tolerances: keypoints atol 1e-4 (as test_torch_models.py); thresholded
voxels equal on all but 1e-4 of the grid (a voxel within the decoders'
1e-4 agreement of the 0.5 threshold may flip); retargeted points, keypoints
and skin weights atol 1e-3 (the target keypoints agree to 1e-4 and the
skin weights scale their distances by exp(hardness * d), hardness 8).
About 60 s on one CPU core.
"""
import argparse
import dataclasses
import inspect
import os
import pickle

import numpy as np
import pytest
import torch

import jax

from neural_marionette_tpu import api as japi
from neural_marionette_tpu import config as JC
from neural_marionette_tpu import retarget as JR
from neural_marionette_tpu.apps import common as jcommon
from neural_marionette_tpu.apps import generation as jgen
from neural_marionette_tpu.apps import interpolation as jinterp
from neural_marionette_tpu.apps import retarget as jret
from neural_marionette_tpu.utils.torch_convert import \
    load_reference_checkpoint as jax_load_reference_checkpoint

from neural_marionette_tpu_torch import api as papi
from neural_marionette_tpu_torch import config as PC
from neural_marionette_tpu_torch import retarget as PR
from neural_marionette_tpu_torch.api import Marionette
from neural_marionette_tpu_torch.apps import common as pcommon
from neural_marionette_tpu_torch.apps import generation as pgen
from neural_marionette_tpu_torch.apps import interpolation as pinterp
from neural_marionette_tpu_torch.apps import retarget as pret
from neural_marionette_tpu_torch.models import NeuralMarionette
from neural_marionette_tpu_torch.skeleton import Skeleton, extract_skeleton
from neural_marionette_tpu_torch.train import (CheckpointManager,
                                               create_train_state)
from neural_marionette_tpu_torch.weights import (init_weights,
                                                 load_reference_checkpoint,
                                                 state_dict_from_jax)

from _torch_port import (configs, jax_generate_eps, jax_interpolate_eps,
                         jax_params, jax_sample_eps, moving_vox)

ATOL = 1e-4


def t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ retarget math
def _rig(K, seed):
    """A skeleton extracted from a random affinity and keypoints, some of
    them below the 0.2 intensity threshold but not the root (with the root
    below it, both packages' walk up to a valid ancestor never ends)."""
    g = np.random.default_rng(seed)
    aff = g.uniform(0, 1, (2, K, K, 1)).astype(np.float32)
    sk = extract_skeleton(aff)
    kp = np.concatenate([g.uniform(-0.6, 0.6, (K, 3)),
                         g.uniform(0.0, 1.0, (K, 1))], -1)
    kp[sk.priority_indices[0], 3] = 0.9
    assert (kp[:, 3] < 0.2).any()
    return g, sk, kp


def _rotations(g, shape):
    q, r = np.linalg.qr(g.normal(size=shape + (3, 3)))
    return q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., None, :]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_skin_weights_equal_jax_to_the_bit(seed):
    _, sk, kp = _rig(8, seed)
    pts = np.random.default_rng(seed + 10).uniform(-0.8, 0.8, (300, 3))
    for hardness in (8.0, 2.5):
        np.testing.assert_array_equal(
            PR.extract_skin_weights(sk, pts, kp, hardness),
            JR.extract_skin_weights(sk, pts, kp, hardness))


@pytest.mark.parametrize("mode", ["ours", "baseline"])
def test_retarget_motion_equals_jax_to_the_bit(mode):
    g, sk, kp = _rig(8, 3)
    T, N = 5, 200
    src = np.concatenate([kp[None, :, :3] + g.normal(0, 0.05, (T, 8, 3)),
                          np.broadcast_to(kp[None, :, 3:], (T, 8, 1))], -1)
    args = (sk, src, _rotations(g, (T, 8)), kp, _rotations(g, (8,)),
            g.uniform(-0.8, 0.8, (N, 3)), g.normal(0, 0.2, (8, 3)))
    got = PR.retarget_motion(*args, hardness=8.0, mode=mode)
    want = JR.retarget_motion(*args, hardness=8.0, mode=mode)
    assert isinstance(got, PR.RetargetResult)
    for a, b, name in zip(got, want, got._fields):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_skin_weights_properties():
    """The JAX package's property case (tests/test_demos.py), on the port."""
    g = np.random.default_rng(0)
    K = 5
    sk = Skeleton(A=np.zeros((K, K), np.float32),
                  priority_values=np.zeros(K, np.float32),
                  priority_indices=np.array([0, 1, 4, 2, 3], np.int32),
                  parents=np.array([0, 0, 1, 2, 0], dtype=np.int32))
    kp = np.concatenate([g.uniform(-0.5, 0.5, size=(K, 3)),
                         np.ones((K, 1))], axis=-1)
    pts = g.uniform(-0.5, 0.5, size=(50, 3))
    w = PR.extract_skin_weights(sk, pts, kp)
    assert w.shape == (50, K)
    np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-9)
    assert (w >= 0).all()
    assert (np.count_nonzero(w, axis=1) <= 2).all()


def test_retarget_identity():
    """The JAX package's identity case: a shape retargeted onto itself with
    identity rotations and its own offsets is reproduced."""
    g = np.random.default_rng(1)
    K = 4
    parents = np.array([0, 0, 1, 2], dtype=np.int32)
    sk = Skeleton(A=np.zeros((K, K), np.float32),
                  priority_values=np.arange(K, dtype=np.float32),
                  priority_indices=np.arange(K, dtype=np.int32),
                  parents=parents)
    kp = np.concatenate([g.uniform(-0.5, 0.5, size=(K, 3)),
                         np.ones((K, 1))], axis=-1)
    pts = g.uniform(-0.5, 0.5, size=(30, 3))
    T = 3
    src_kp = np.broadcast_to(kp, (T, K, 4)).copy()
    eye = np.broadcast_to(np.eye(3), (T, K, 3, 3)).copy()
    offset = kp[:, :3] - kp[parents, :3]
    res = PR.retarget_motion(sk, src_kp, eye, kp, np.broadcast_to(
        np.eye(3), (K, 3, 3)).copy(), pts, offset, mode="ours")
    np.testing.assert_allclose(res.new_points[0], pts, atol=1e-6)


# ------------------------------------------------------------ the apps
@pytest.fixture(scope="module")
def demo():
    """A JAX ``DemoContext`` and the port's ``Marionette`` on the same
    parameters, and a moving clip of 8 frames."""
    jcfg, cfg = configs(Ttot=8, Tcond=2)
    model, params = jax_params(jcfg, seed=7)
    ctx = jcommon.DemoContext(cfg=jcfg, model=model, params=params,
                              skeleton=None)
    m = Marionette.from_jax_params(cfg, params, device="cpu")
    vox, pts = moving_vox(B=1, T=8, G=jcfg.grid_size, seed=8)
    return ctx, m, vox[0], pts[0]


def _voxels_agree(got, want):
    assert got.shape == want.shape
    assert set(np.unique(got)) <= {0.0, 1.0}
    assert np.mean(got != want) <= 1e-4, np.mean(got != want)


def test_run_generation_matches_jax(demo, tmp_path):
    ctx, m, vox, _ = demo
    Tcond, Tgen, S, seed = 2, 3, 2, 4
    want = jgen.run_generation(ctx, vox, Tcond=Tcond, Tgen=Tgen,
                               sample_num=S, seed=seed)
    eps = jax_generate_eps(ctx.model, ctx.params, jax.random.PRNGKey(seed),
                           Tcond + Tgen, Tcond, S)
    got = pgen.run_generation(m, vox, Tcond=Tcond, Tgen=Tgen, sample_num=S,
                              seed=seed, eps=tuple(map(t, eps)))
    for a, b in zip(got["skeleton"], want["skeleton"]):
        np.testing.assert_array_equal(a, b)
    _voxels_agree(got["gen_voxels"], want["gen_voxels"])
    for k in ("keypoints", "cond_keypoints"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    pgen.save_outputs(got, str(tmp_path))
    for f in ("gen_voxels.npy", "keypoints.npy", "parents.npy"):
        assert os.path.exists(tmp_path / f), f


def test_run_interpolation_matches_jax(demo, tmp_path):
    ctx, m, vox, _ = demo
    rate, S, seed = 3, 16, 5
    want = jinterp.run_interpolation(ctx, vox, anchor_rate=rate,
                                     sample_num=S, seed=seed)
    eps = jax_interpolate_eps(ctx.model, ctx.params,
                              jax.random.PRNGKey(seed), vox.shape[0], rate, S)
    got = pinterp.run_interpolation(m, vox, anchor_rate=rate, sample_num=S,
                                    seed=seed, eps=tuple(map(t, eps)))
    _voxels_agree(got["interp_voxels"], want["interp_voxels"])
    for k in ("keypoints", "detected_keypoints"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    pinterp.save_outputs(got, str(tmp_path))
    for f in ("interp_voxels.npy", "keypoints.npy"):
        assert os.path.exists(tmp_path / f), f


@pytest.mark.parametrize("mode", ["ours", "baseline"])
def test_run_retarget_matches_jax(demo, mode, tmp_path):
    ctx, m, vox, pts = demo
    seed = 6
    target = pts[0][::2]                                   # (N, 3)
    want = jret.run_retarget(ctx, vox, target, mode=mode, seed=seed)
    Z, T = ctx.cfg.nlatent_kypt, vox.shape[0]
    eps = (jax_sample_eps(ctx.model, ctx.params, jax.random.PRNGKey(seed),
                          T, 10, 1, Z),
           jax_sample_eps(ctx.model, ctx.params,
                          jax.random.PRNGKey(seed + 1), 1, 10, 1, Z))
    got = pret.run_retarget(m, vox, target, mode=mode, seed=seed,
                            eps=tuple(map(t, eps)))
    for k in ("source_keypoints", "target_keypoints"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_array_equal(got["source_keypoints"][1:, :, -1],
                                  np.broadcast_to(
                                      got["source_keypoints"][0, :, -1],
                                      (T - 1, ctx.cfg.nkeypoints)))
    np.testing.assert_array_equal(got["target_keypoints"][0, 0, :, 3],
                                  got["source_keypoints"][0, :, 3])
    for a, b, name in zip(got["result"], want["result"],
                          got["result"]._fields):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3, err_msg=name)
    pret.save_outputs(got, str(tmp_path))
    for f in ("retargeted_points.npy", "retargeted_keypoints.npy",
              "skin_weights.npy", "parents.npy"):
        assert os.path.exists(tmp_path / f), f


def test_entry_points_keep_the_jax_defaults_and_seeds(demo):
    """``Marionette.generate``, ``interpolate`` and ``retarget`` take the
    JAX package's defaults; a seed gives the same result twice."""
    for name in ("generate", "interpolate", "retarget"):
        want = inspect.signature(getattr(japi.Marionette, name)).parameters
        got = inspect.signature(getattr(papi.Marionette, name)).parameters
        assert list(got) == list(want), name
        for k in want:
            assert got[k].default == want[k].default, (name, k)
    _, m, vox, pts = demo
    a, b = (m.generate(vox, Tcond=2, Tgen=2, sample_num=2) for _ in range(2))
    assert a["gen_voxels"].shape == (2, 4) + vox.shape[1:]
    np.testing.assert_array_equal(a["keypoints"], b["keypoints"])
    c = m.interpolate(vox[:5], anchor_rate=2, sample_num=8, seed=3)
    assert c["keypoints"].shape == (5, m.cfg.nkeypoints, 4)
    r = m.retarget(vox[:3], pts[0][::4], mode="baseline")
    assert r["result"].new_points.shape == (3, len(pts[0][::4]), 3)
    assert np.isfinite(r["result"].new_points).all()


# ------------------------------------------------------------ loading
def test_load_from_a_port_checkpoint_tree(tmp_path):
    """``opt.json`` + ``epochs/<n>`` of the port's ``CheckpointManager``:
    the latest epoch's weights to the bit, and its skeleton."""
    jcfg, cfg = configs()
    _, params = jax_params(jcfg, seed=9)
    net = NeuralMarionette(cfg)
    net.load_state_dict(state_dict_from_jax(params))
    aff = net.kypt_detector.get_affinity().detach().numpy()
    skeleton = extract_skeleton(aff)
    cfg.save_json(str(tmp_path / "opt.json"))
    mgr = CheckpointManager(str(tmp_path))
    state = create_train_state(cfg, net, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(0.5)
    mgr.save(1, state, skeleton)
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(2.0)
    mgr.save(2, state, skeleton)
    m = Marionette.load(str(tmp_path), device="cpu")
    assert dataclasses.asdict(m.cfg) == dataclasses.asdict(cfg)
    for k, v in m.model.state_dict().items():
        assert torch.equal(v, net.state_dict()[k]), k
    for a, b in zip(m.skeleton, skeleton):
        np.testing.assert_array_equal(a, b)


def _reference_tree(path, cfg, seed, drop=None, extra=None):
    """A reference experiment directory: ``opt.pickle`` (an
    ``argparse.Namespace`` with one unknown and one None attribute) and a
    ``network.pth`` of seeded random tensors of every key of the model."""
    os.makedirs(path, exist_ok=True)
    ns = argparse.Namespace(**{**dataclasses.asdict(cfg),
                               "exp_name": None, "unknown_flag": 3})
    with open(os.path.join(path, "opt.pickle"), "wb") as f:
        pickle.dump(ns, f)
    g = np.random.default_rng(seed)
    state = {k: torch.from_numpy(g.normal(0, 0.1, v.shape).astype(np.float32))
             for k, v in NeuralMarionette(cfg).state_dict().items()}
    if drop is not None:
        del state[drop]
    state.update(extra or {})
    torch.save(state, os.path.join(path, "network.pth"))
    return state


def test_load_from_a_reference_tree_equals_jax(tmp_path):
    """``opt.pickle`` + ``network.pth``: the configuration as the JAX
    package's ``load_reference_pickle`` reads it, and every tensor, detector
    and dynamics, equal to the bit to JAX ``load_reference_checkpoint`` ->
    ``state_dict_from_jax`` and to the file."""
    jcfg, cfg = configs()
    written = _reference_tree(str(tmp_path), cfg, seed=10)
    m = Marionette.load(str(tmp_path), device="cpu")
    want_cfg = JC.load_reference_pickle(str(tmp_path / "opt.pickle"))
    assert dataclasses.asdict(want_cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(m.cfg) == dataclasses.asdict(want_cfg)
    assert dataclasses.asdict(PC.load_reference_pickle(
        str(tmp_path / "opt.pickle"))) == dataclasses.asdict(want_cfg)
    want = state_dict_from_jax(jax_load_reference_checkpoint(
        str(tmp_path / "network.pth")))
    got = m.model.state_dict()
    assert set(got) == set(want) == set(written)
    for k, v in got.items():
        assert torch.equal(v, want[k]) and torch.equal(v, written[k]), k
    assert m.skeleton is None


def test_reference_checkpoint_missing_or_unmapped_key_raises(tmp_path):
    """Strict on every key: a missing dynamics key raises, and so does a key
    outside the model (the JAX converter refuses it too)."""
    jcfg, cfg = configs()
    missing = tmp_path / "missing"
    _reference_tree(str(missing), cfg, seed=11,
                    drop="dyna_module.kypt_rnn_cell.bias_hh")
    with pytest.raises(KeyError, match="missing"):
        load_reference_checkpoint(str(missing / "network.pth"),
                                  NeuralMarionette(cfg))
    unmapped = tmp_path / "unmapped"
    _reference_tree(str(unmapped), cfg, seed=12,
                    extra={"agent.policy.weight": torch.zeros(2)})
    with pytest.raises(KeyError, match="agent.policy"):
        Marionette.load(str(unmapped), device="cpu")
    with pytest.raises(KeyError):
        jax_load_reference_checkpoint(str(unmapped / "network.pth"))
    shape = tmp_path / "shape"
    _reference_tree(str(shape), cfg, seed=13, extra={
        "dyna_module.offset_param": torch.zeros(cfg.nkeypoints + 1, 3)})
    with pytest.raises(ValueError, match="offset_param"):
        Marionette.load(str(shape), device="cpu")


def test_load_with_no_checkpoint_warns_and_keeps_random_weights(tmp_path,
                                                                capsys):
    _, cfg = configs()
    cfg.save_json(str(tmp_path / "opt.json"))
    m = Marionette.load(str(tmp_path), device="cpu", Tcond=1)
    assert "WARNING: no checkpoint found" in capsys.readouterr().out
    assert m.cfg.Tcond == 1 and m.skeleton is None
    ref = NeuralMarionette(cfg)
    init_weights(ref, torch.Generator().manual_seed(0))
    for k, v in m.model.state_dict().items():
        assert torch.equal(v, ref.state_dict()[k]), k
    with pytest.raises(FileNotFoundError):
        Marionette.load(str(tmp_path / "absent"), device="cpu")


# ------------------------------------------------------------ readers
_OBJ = """# a quad and a triangle; the quad has UVs, the triangle none
mtllib mesh.mtl
v 0.0 0.0 0.0
v 1.0 0.0 0.0
v 1.0 2.0 0.0
v 0.0 2.0 0.5
v 0.5 0.5 3.0
vt 0.0 0.0
vt 1.0 0.0
vt 1.0 1.0
vt 0.0 1.0
f 1/1 2/2 3/3 4/4
f 2 3 5
"""


def test_obj_mesh_and_target_points_equal_jax(tmp_path):
    """``load_obj_mesh`` on a small OBJ (an n-gon fan-triangulated, per-
    vertex UVs, a material whose image is absent, so no image reader is
    imported) and ``load_target_points`` from it and from a ``.npy`` clip,
    equal to the JAX package's."""
    obj = tmp_path / "mesh.obj"
    obj.write_text(_OBJ)
    (tmp_path / "mesh.mtl").write_text("newmtl m\nmap_Kd absent.png\n")
    got, want = pret.load_obj_mesh(str(obj)), jret.load_obj_mesh(str(obj))
    assert got["texture"] is None and want["texture"] is None
    assert got["faces"].tolist() == [[0, 1, 2], [0, 2, 3], [1, 2, 4]]
    for k in ("verts", "faces", "uv"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(pret.load_obj_vertices(str(obj)),
                                  want["verts"])
    for kw in (dict(is_bind=True), dict(scale=0.6, x_trans=0.1)):
        np.testing.assert_array_equal(
            pret.load_target_points(str(obj), **kw),
            jret.load_target_points(str(obj), **kw))
    clip = np.random.default_rng(0).normal(size=(3, 40, 3))
    np.save(tmp_path / "clip.npy", clip)
    np.testing.assert_array_equal(
        pret.load_target_points(str(tmp_path / "clip.npy")),
        jret.load_target_points(str(tmp_path / "clip.npy")))


def test_load_clip_equals_jax(tmp_path):
    jcfg, cfg = configs(Ttot=3, sample_rate=2)
    seq = np.random.default_rng(1).normal(size=(9, 300, 4))
    np.save(tmp_path / "seq.npy", seq)
    got = pcommon.load_clip(str(tmp_path / "seq.npy"), cfg, start=1,
                            scale=0.9, x_trans=0.05)
    want = jcommon.load_clip(str(tmp_path / "seq.npy"), jcfg, start=1,
                             scale=0.9, x_trans=0.05)
    assert got[0].shape == (3,) + (jcfg.grid_size,) * 3 + (1,)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
