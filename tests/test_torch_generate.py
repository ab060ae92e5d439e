"""Generation and interpolation of the port against the JAX package, on the
CPU: ``HSVRNNBVH.generate_many``, ``generate`` and ``interpolate`` (the
latter against both JAX ``interpolate`` and its oracle
``_interpolate_eager``), ``KyptDetector.decode_from_dyna``,
``NeuralMarionette.generate`` and ``train.make_generate_step``, on the same
parameters (``state_dict_from_jax``) and the same noise (the JAX draws
rebuilt from their keys by ``_torch_port``).

Tolerances: keypoints and voxels atol 1e-4, as the encode test
(test_torch_models.py); the selections (every best-of-N and every
``choose`` argmin) equal, recorded from ``torch.argmin`` on the port and
from ``jnp.argmin`` on the JAX side (through ``jax.debug.callback``).
About 30 s on one CPU core.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_marionette_tpu.models import NeuralMarionette as JaxMarionette
from neural_marionette_tpu.models import SkeletonArrays as JaxSkeletonArrays
from neural_marionette_tpu.skeleton import extract_skeleton as jax_skeleton
from neural_marionette_tpu.train.step import \
    make_generate_step as jax_generate_step

from neural_marionette_tpu_torch.models import NeuralMarionette, \
    SkeletonArrays
from neural_marionette_tpu_torch.models.blocks import routes_to_kernel
from neural_marionette_tpu_torch.ops import conv3d as K3
from neural_marionette_tpu_torch.train import make_generate_step
from neural_marionette_tpu_torch.weights import state_dict_from_jax

from _torch_port import (configs, jax_generate_eps, jax_interpolate_eps,
                         jax_params, moving_vox)

ATOL = 1e-4


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def pair():
    """The JAX model and parameters, the port's model on them, a skeleton
    from their affinity, and detected keypoints of a moving clip."""
    jcfg, cfg = configs(Ttot=8, Tcond=3)
    model, params = jax_params(jcfg, seed=3)
    net = NeuralMarionette(cfg)
    net.load_state_dict(state_dict_from_jax(params), strict=True)
    net.eval()
    aff = model.apply(params, method=lambda m: m.kypt_detector.get_affinity())
    skeleton = jax_skeleton(np.asarray(aff))
    vox, pts = moving_vox(B=2, T=8, G=jcfg.grid_size, seed=4)
    det = jax.jit(lambda pr, v: model.apply(
        pr, v, method=lambda m, x: m.kypt_detector(x)))(
        params, jnp.asarray(vox))
    kp = np.asarray(det["keypoints"])                  # (2, 8, K, 4)
    return dict(jcfg=jcfg, cfg=cfg, model=model, params=params, net=net,
                skeleton=skeleton, jsk=JaxSkeletonArrays.from_skeleton(
                    skeleton),
                sk=SkeletonArrays.from_skeleton(skeleton), vox=vox, pts=pts,
                kp=kp)


@contextlib.contextmanager
def recorded_argmins(monkeypatch):
    """Record every ``torch.argmin`` and ``jnp.argmin`` result, in order;
    the JAX ones through an ordered ``jax.debug.callback``, so they are
    recorded inside ``jit`` and ``lax.scan`` too."""
    got = {"torch": [], "jax": []}
    t_argmin, j_argmin = torch.argmin, jnp.argmin

    def t_rec(*a, **k):
        out = t_argmin(*a, **k)
        got["torch"].append(out.numpy().copy())
        return out

    def j_rec(*a, **k):
        out = j_argmin(*a, **k)
        jax.debug.callback(
            lambda v: got["jax"].append(np.asarray(v).copy()), out,
            ordered=True)
        return out

    with monkeypatch.context() as mp:
        mp.setattr(torch, "argmin", t_rec)
        mp.setattr(jnp, "argmin", j_rec)
        yield got
        jax.effects_barrier()


def _dyna(m, name):
    return lambda mod, *a, **k: getattr(mod.dyna_module, name)(*a, **k)


# ---------------------------------------------------------------- rollouts
def test_generate_many_matches_jax(pair, monkeypatch):
    """One clip of Tcond=3 detected frames, 5 generated, 4 samples: the
    conditioning keypoints are the detected ones (not the best samples),
    the generated ones atol 1e-4, the conditioning selections equal."""
    p = pair
    Tcond, Ttot, S = 3, 8, 4
    kp = p["kp"][:1, :Tcond]
    key = jax.random.PRNGKey(21)
    eps = jax_generate_eps(p["model"], p["params"], key, Ttot, Tcond, S)
    with recorded_argmins(monkeypatch) as rec, torch.no_grad():
        want_c, want_g = jax.jit(lambda pr, k: p["model"].apply(
            pr, k, p["jsk"], Ttot=Ttot, Tcond=Tcond, sample_num=S,
            method=_dyna(p["model"], "generate_many"),
            rngs={"sample": key}))(p["params"], jnp.asarray(kp))
        got_c, got_g = p["net"].dyna_module.generate_many(
            t(kp), p["sk"], Ttot, Tcond, sample_num=S,
            eps=tuple(map(t, eps)))
    assert got_c.shape == (1, Tcond, kp.shape[2], 4)
    assert got_g.shape == (S, Ttot - Tcond, kp.shape[2], 4)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_c.numpy(), kp)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=0,
                               atol=ATOL)
    assert len(rec["torch"]) == Tcond
    np.testing.assert_array_equal(np.stack(rec["torch"]),
                                  np.stack(rec["jax"]))


def test_generate_matches_jax(pair, monkeypatch):
    """Two clips (B=2), Tcond=3, 4 generated, 5 samples: the best
    conditioning samples and the rollout atol 1e-4, selections equal."""
    p = pair
    Tcond, Ttot, S, B = 3, 7, 5, 2
    kp = p["kp"][:, :Tcond]
    key = jax.random.PRNGKey(22)
    eps = jax_generate_eps(p["model"], p["params"], key, Ttot, Tcond, S,
                           B=B, many=False)
    with recorded_argmins(monkeypatch) as rec, torch.no_grad():
        want = jax.jit(lambda pr, k: p["model"].apply(
            pr, k, p["jsk"], Ttot=Ttot, Tcond=Tcond, sample_num=S,
            method=_dyna(p["model"], "generate"), rngs={"sample": key}))(
            p["params"], jnp.asarray(kp))
        got = p["net"].dyna_module.generate(t(kp), p["sk"], Ttot=Ttot,
                                            Tcond=Tcond, sample_num=S,
                                            eps=tuple(map(t, eps)))
    for k in ("keypoints_cond", "keypoints_gen"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
    assert len(rec["torch"]) == Tcond
    np.testing.assert_array_equal(np.stack(rec["torch"]),
                                  np.stack(rec["jax"]))


@pytest.mark.parametrize("T", [8, 7])
def test_interpolate_matches_jax_scanned_and_eager(pair, monkeypatch, T):
    """anchor_rate 3, S 16 (as tests/test_models.py), T 8 (anchors 0, 3,
    6, 7) and 7 (anchors 0, 3, 6): the port's one implementation against
    JAX ``interpolate`` and ``_interpolate_eager``, atol 1e-4; every best
    and choose argmin equal to each one's; intensities frozen to frame
    0."""
    p = pair
    S, rate = 16, 3
    kp = p["kp"][:1, :T]
    key = jax.random.PRNGKey(23)
    eps = jax_interpolate_eps(p["model"], p["params"], key, T, rate, S)
    run, choices = {}, {}
    with torch.no_grad():
        got = p["net"].dyna_module.interpolate(
            t(kp), p["sk"], anchor_rate=rate, sample_num=S,
            eps=tuple(map(t, eps)))
    for name in ("interpolate", "_interpolate_eager"):
        with recorded_argmins(monkeypatch) as rec:
            run[name] = jax.jit(lambda pr, k: p["model"].apply(
                pr, k, p["jsk"], anchor_rate=rate, sample_num=S,
                method=_dyna(p["model"], name), rngs={"sample": key}))(
                p["params"], jnp.asarray(kp))
            with torch.no_grad():
                p["net"].dyna_module.interpolate(
                    t(kp), p["sk"], anchor_rate=rate, sample_num=S,
                    eps=tuple(map(t, eps)))
        choices[name] = rec
    K = kp.shape[2]
    assert got.shape == (1, T, K, 4)
    n_anchors = len([s for s in range(T) if s % rate == 0 or s == T - 1])
    for name, want in run.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL, err_msg=name)
        rec = choices[name]
        assert len(rec["torch"]) == len(rec["jax"]) == 2 * n_anchors, name
        np.testing.assert_array_equal(np.stack(rec["torch"]),
                                      np.stack(rec["jax"]), err_msg=name)
    np.testing.assert_array_equal(got[0, :, :, -1].numpy(),
                                  np.broadcast_to(kp[0, 0, :, -1], (T, K)))
    anchors = [s for s in range(T) if s % rate == 0]
    np.testing.assert_array_equal(got[0, anchors, :, :3].numpy(),
                                  kp[0, anchors, :, :3])


def test_rollouts_draw_from_generator(pair):
    """Without ``eps`` the rollouts draw from the generator: the same seed
    gives the same result, another seed another; wrong eps shapes raise."""
    p = pair
    dyn = p["net"].dyna_module
    kp = t(p["kp"][:1])
    runs = []
    with torch.no_grad():
        for seed in (1, 1, 2):
            g = torch.Generator().manual_seed(seed)
            runs.append((dyn.generate_many(kp[:, :3], p["sk"], 6, 3, 3,
                                           generator=g)[1],
                         dyn.interpolate(kp, p["sk"], 3, 8, generator=g)))
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    for a, c in zip(runs[0], runs[2]):
        assert not torch.equal(a, c)
    with pytest.raises(ValueError, match="eps"):
        dyn.interpolate(kp, p["sk"], 3, 8, eps=(torch.zeros(8, 8, 2),) * 2)
    with pytest.raises(ValueError, match="Tcond"):
        dyn.generate_many(kp, p["sk"], 10, 3, 3)


# ------------------------------------------------------- decode / generate
def test_decode_from_dyna_matches_jax(pair):
    """Rollout keypoints, a channels-last first-frame feature and a first
    frame through both decoders: atol 1e-4; the fixed sigma list, so the
    result is the detector's own render-and-decode of the same keypoints."""
    p = pair
    jcfg = p["jcfg"]
    g = np.random.default_rng(5)
    B, T, K, G = 2, 5, jcfg.nkeypoints, jcfg.grid_size
    kp = np.concatenate([g.uniform(-0.7, 0.7, (B, T, K, 3)),
                         g.uniform(0.2, 1.0, (B, T, K, 1))], -1).astype(
        np.float32)
    ff = g.normal(0, 1, (B,) + (G // 4,) * 3 + (jcfg.feat_dim,)).astype(
        np.float32)
    first = p["vox"][:, 0]
    want = jax.jit(lambda pr, *a: p["model"].apply(
        pr, *a, method=lambda m, *b: m.kypt_detector.decode_from_dyna(*b)))(
        p["params"], jnp.asarray(kp), jnp.asarray(ff), jnp.asarray(first))
    with torch.no_grad():
        got = p["net"].kypt_detector.decode_from_dyna(t(kp), t(ff), t(first))
    assert got["gen"].shape == (B, T, G, G, G, 1)
    np.testing.assert_allclose(got["gen"].numpy(), np.asarray(want["gen"]),
                               rtol=0, atol=ATOL)


def _check_generate(got, want, B, T, jcfg):
    G, K = jcfg.grid_size, jcfg.nkeypoints
    assert got["gen"].shape == (B, T, G, G, G, 1)
    assert got["keypoints"].shape == (B, T, K, 4)
    for k in ("gen", "keypoints", "affinity"):
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k]), rtol=0, atol=ATOL,
                                   err_msg=k)


def test_marionette_generate_matches_jax(pair):
    """``NeuralMarionette.generate`` on two clips of 8 frames (Tcond 3):
    recon || decoded voxels, detected || generated keypoints, affinity."""
    p = pair
    S = 3
    key = jax.random.PRNGKey(24)
    eps = jax_generate_eps(p["model"], p["params"], key, 8, 3, S, B=2,
                           many=False)
    want = jax.jit(lambda pr, v: p["model"].apply(
        pr, v, p["jsk"], sample_num=S, method=JaxMarionette.generate,
        rngs={"sample": key}))(p["params"], jnp.asarray(p["vox"]))
    with torch.no_grad():
        got = p["net"].generate(t(p["vox"]), p["sk"], sample_num=S,
                                eps=tuple(map(t, eps)))
    _check_generate(got, want, 2, 8, p["jcfg"])


def test_generate_step_matches_jax(pair):
    """``make_generate_step`` on a point batch (voxelized on each side) in
    float32, against the JAX package's jitted generate step."""
    p = pair
    S = 3
    key = jax.random.PRNGKey(25)
    eps = jax_generate_eps(p["model"], p["params"], key, 8, 3, S, B=2,
                           many=False)
    want = jax_generate_step(p["model"], p["jcfg"], sample_num=S)(
        p["params"], jnp.asarray(p["pts"]), p["jsk"], key)
    got = make_generate_step(p["net"], p["cfg"], sample_num=S)(
        t(p["pts"]), p["sk"], eps=tuple(map(t, eps)))
    assert not got["gen"].requires_grad
    _check_generate(got, want, 2, 8, p["jcfg"])


def test_generate_step_conv_route_bf16(pair, monkeypatch):
    """A bfloat16 model with ``conv_kernel=True``: the step runs the conv
    route (on the CPU, K3's plain version) once per routed conv of one
    detector forward plus once per routed conv of the decoder
    (``decode_from_dyna``), and agrees with the route off within
    bfloat16 rounding (keypoints atol 2e-2, voxels differ in at most 1 %
    of the grid)."""
    p = pair
    runs, calls = {}, []
    plain = K3.conv3d_plain

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(K3, "conv3d_plain", counted)
    eps = tuple(map(t, jax_generate_eps(p["model"], p["params"],
                                        jax.random.PRNGKey(26), 8, 3, 3,
                                        B=2, many=False)))
    for route in (False, True):
        net = NeuralMarionette(p["cfg"], dtype=torch.bfloat16,
                               conv_kernel=route).eval()
        net.load_state_dict(p["net"].state_dict())
        calls.clear()
        runs[route] = make_generate_step(net, p["cfg"], sample_num=3)(
            t(p["pts"]), p["sk"], eps=eps)
        n_calls = len(calls)
    det = net.kypt_detector
    routed = [m for m in det.modules() if isinstance(m, torch.nn.Conv3d)
              and routes_to_kernel(m, torch.bfloat16)]
    dec = [m for m in det.kypt_to_vox.modules()
           if isinstance(m, torch.nn.Conv3d)
           and routes_to_kernel(m, torch.bfloat16)]
    assert len(dec) > 0 and n_calls == len(routed) + len(dec)
    on, off = runs[True], runs[False]
    assert on["gen"].dtype == torch.bfloat16
    np.testing.assert_allclose(on["keypoints"].numpy(),
                               off["keypoints"].numpy(), rtol=0, atol=2e-2)
    flips = ((on["gen"].float() >= 0.5) != (off["gen"].float() >= 0.5))
    assert flips.float().mean() <= 0.01


def test_trainer_makes_the_generate_step_with_the_learner(pair):
    """``Trainer.phase_generate_step``: None while the learner is off, as
    the JAX training loop makes it only for a learner phase; once the
    learner is on, one step per phase on the trainer's model, equal to a
    step made by hand on the same noise."""
    import dataclasses
    from neural_marionette_tpu_torch.train import Trainer
    p = pair
    cfg = dataclasses.replace(p["cfg"], detector_start=0, detector_end=1,
                              learner_start=1, affinity_anneal=0)
    trainer = Trainer(cfg, device="cpu", dtype="float32", model=p["net"])
    trainer.sched.anneal(0)
    assert trainer.phase_generate_step() is None
    trainer.sched.anneal(1)
    step = trainer.phase_generate_step()
    assert step is not None and trainer.phase_generate_step() is step
    eps = tuple(map(t, jax_generate_eps(p["model"], p["params"],
                                        jax.random.PRNGKey(27), 8, 3, 10,
                                        B=2, many=False)))
    got = step(t(p["vox"]), p["sk"], eps=eps)
    want = make_generate_step(p["net"], cfg)(t(p["vox"]), p["sk"], eps=eps)
    for k in ("gen", "keypoints"):
        assert torch.equal(got[k], want[k]), k
