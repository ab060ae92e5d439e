"""The port's evaluation against the JAX package's, on the CPU: the eval
functions of ``eval.py`` on the same inputs, and ``Trainer.validate``
against the JAX ``make_eval_step`` plus ``evaluate`` on the same weights
and batches.

Tolerances: the semantic histograms, ``semantic_final`` and
``affinity_recovery`` equal; ``voxel_chamfer`` within 1e-9 relative (the
port reads each distance from an exact integer distance transform, the
JAX function computes it in float64 coordinates). In ``validate`` the
step's metrics within the train-step tests' 2e-3 relative
(``tests/test_torch_train_step.py``) and the voxel_chamfer scores within
1e-9 relative once the recon binarizes the same on both sides (checked).
About 40 s on one core.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_marionette_tpu import eval as jeval
from neural_marionette_tpu.models import SkeletonArrays as JaxSkeletonArrays
from neural_marionette_tpu.ops import voxelize_jnp
from neural_marionette_tpu.skeleton import extract_skeleton as jax_skeleton
from neural_marionette_tpu.train import LossScheduler as JaxScheduler
from neural_marionette_tpu.train import make_eval_step as jax_eval_step

from neural_marionette_tpu_torch import eval as peval
from neural_marionette_tpu_torch.models import NeuralMarionette
from neural_marionette_tpu_torch.train import Trainer
from neural_marionette_tpu_torch.weights import state_dict_from_jax

from _torch_port import configs, jax_params, jax_sample_eps, moving_vox


def _keypoints(g, B=2, T=3, K=6, K_gt=4):
    kp = g.uniform(-1, 1, size=(B, T, K, 4)).astype(np.float32)
    kp[..., 3] = g.uniform(0, 1, size=(B, T, K))   # some below 0.2
    gt = g.uniform(-1, 1, size=(B, T, K_gt, 3)).astype(np.float32)
    return kp, gt


def test_semantic_scores_and_final_equal_jax():
    g = np.random.default_rng(0)
    want = got = None
    for _ in range(3):
        kp, gt = _keypoints(g)
        want, wlog = jeval.semantic_scores(want, kp, gt)
        got, glog = peval.semantic_scores(got, kp, gt)
        assert np.array_equal(got, want) and glog == wlog
    assert peval.semantic_final(got) == jeval.semantic_final(want)
    out = peval.evaluate("semantic", None, dict(keypoints=kp,
                                                gt_keypoints=gt))
    assert np.array_equal(out["scores"], jeval.evaluate(
        "semantic", None, dict(keypoints=kp, gt_keypoints=gt))["scores"])


@pytest.mark.parametrize("occupancy", [0.0, 0.02, 0.5, 0.97])
@pytest.mark.parametrize("G", [8, 16])
def test_voxel_chamfer_equals_jax(G, occupancy, monkeypatch):
    """Sparse to nearly full recons, the half-occupied one included; an
    empty GT frame and an empty recon frame are skipped on both sides."""
    g = np.random.default_rng(G)
    gt = (g.uniform(size=(2, 3, G, G, G, 1)) < 0.08).astype(np.float32)
    recon = g.uniform(size=(2, 3, G, G, G, 1)).astype(np.float32)
    recon = np.where(recon < occupancy, 0.5 + recon / 2, recon / 2)
    gt[0, 0] = 0
    recon[1, 2] = 0.1
    want = jeval.voxel_chamfer(gt, recon)
    for frames in (1, 4):
        monkeypatch.setattr(peval, "FRAMES_PER_CHUNK", frames)
        got = peval.voxel_chamfer(torch.from_numpy(gt),
                                  torch.from_numpy(recon))
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    scores = peval.evaluate("voxel_chamfer", [1.0],
                            dict(voxel=gt, recon=recon))["scores"]
    assert scores[0] == 1.0 and len(scores) == 2


def test_squared_distance_transform_is_exact():
    g = np.random.default_rng(1)
    occ = g.uniform(size=(3, 7, 7, 7)) < 0.05
    occ[2] = False
    occ[2, 6, 0, 3] = True
    got = peval.squared_distance_transform(torch.from_numpy(occ)).numpy()
    grid = np.stack(np.meshgrid(*[np.arange(7)] * 3, indexing="ij"), -1)
    for f in range(3):
        pts = np.argwhere(occ[f])
        d = ((grid[..., None, :] - pts) ** 2).sum(-1).min(-1)
        assert np.array_equal(got[f], d)


def test_affinity_recovery_and_dispatch_equal_jax():
    g = np.random.default_rng(2)
    K_gt, K = 5, 6
    gt_aff = np.zeros((K_gt, K_gt), np.float32)
    for i in range(K_gt - 1):
        gt_aff[i, i + 1] = gt_aff[i + 1, i] = 1
    for _ in range(4):
        hist = g.integers(0, 9, size=(K_gt, K)).astype(np.float64)
        parents = np.array([-1] + list(g.integers(0, K, size=K - 1)))
        assert peval.affinity_recovery(gt_aff, parents, hist) == \
            jeval.affinity_recovery(gt_aff, parents, hist)
    with pytest.raises(ValueError):
        peval.evaluate("nope", None, {})


# ------------------------------------------------------------- validation
PHASES = {
    "detector": (dict(detector_start=0, learner_start=int(1e9),
                      affinity_anneal=0), (True, False, True)),
    "learner": (dict(detector_end=0, learner_start=0, affinity_anneal=0),
                (False, True, True)),
}
B, N_BATCHES, SEED = 2, 2, 7


def _batches(T, G):
    """Two validation batches of (points, GT joints)."""
    out = []
    for i in range(N_BATCHES):
        _, pts = moving_vox(B=B, T=T, G=G, seed=10 + i)
        gt = np.random.default_rng(20 + i).uniform(
            -0.5, 0.5, size=(B, T, 4, 3)).astype(np.float32)
        out.append((pts, gt))
    return out


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_validate_matches_jax_eval_step_and_evaluate(phase):
    fields, flags = PHASES[phase]
    jcfg, cfg = configs(seed=SEED, is_eval=1, eval_voxel_chamfer=1,
                        **fields)
    model, params = jax_params(jcfg, seed=0)
    batches = _batches(jcfg.Ttot, jcfg.grid_size)
    names = ["semantic", "voxel_chamfer"]

    # the JAX package's validation loop (train.py:271-306)
    jsched = JaxScheduler(jcfg)
    jsched.anneal(0)
    jsk = None
    if flags[1]:
        aff = model.apply(params,
                          method=lambda m: m.kypt_detector.get_affinity())
        jsk = JaxSkeletonArrays.from_skeleton(jax_skeleton(np.asarray(aff)))
    step = jax_eval_step(model, jcfg, jsched.active_weights(), *flags)
    want_metrics, want_scores, recons, eps = [], {}, [], []
    for i, (pts, gt) in enumerate(batches):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), i)
        m, t = jax.tree.map(np.asarray, step(params, jnp.asarray(pts), jsk,
                                             key))
        want_metrics.append(m)
        recons.append(t["recon"])
        eps.append(torch.from_numpy(jax_sample_eps(
            model, params, key, jcfg.Ttot, 10, B, jcfg.nlatent_kypt))
            if flags[1] else None)
        for name, p in (("semantic", dict(keypoints=t["keypoints"],
                                          gt_keypoints=gt)),
                        ("voxel_chamfer", dict(
                            voxel=np.asarray(voxelize_jnp(
                                jnp.asarray(pts), jcfg.grid_size)),
                            recon=t["recon"]))):
            want_scores[name] = jeval.evaluate(name, want_scores.get(name),
                                               p)["scores"]

    net = NeuralMarionette(cfg)
    net.load_state_dict(state_dict_from_jax(params), strict=True)
    trainer = Trainer(cfg, device="cpu", dtype="float32", model=net)
    tuples = [(torch.from_numpy(p), torch.from_numpy(g)) for p, g in batches]
    valid, scores = trainer.validate(0, tuples, names, eps=eps)
    assert (trainer.skeleton is not None) == flags[1]

    for k in want_metrics[0]:
        mean = np.mean([float(m[k]) for m in want_metrics])
        np.testing.assert_allclose(valid[k], mean, rtol=2e-3, atol=1e-7,
                                   err_msg=k)
    assert np.array_equal(scores["semantic"], want_scores["semantic"])
    # not the degenerate histogram of all keypoints below the intensity
    # threshold (every GT joint then maps to keypoint 0)
    assert np.count_nonzero(scores["semantic"].sum(0)) > 1
    # the recon binarizes the same on both sides, so the chamfer agrees
    for (pts, _), e, jrecon in zip(batches, eps, recons):
        _, t = trainer.phase_eval_step()(
            torch.from_numpy(pts), trainer.phase_skeleton(), eps=e)
        assert np.array_equal(t["recon"].numpy() >= 0.5, jrecon >= 0.5)
    np.testing.assert_allclose(scores["voxel_chamfer"],
                               want_scores["voxel_chamfer"], rtol=1e-9)
    for name in names:
        assert np.isfinite(valid[name])
    stats = trainer.validation_stats
    assert stats["batches"] == N_BATCHES and 0 < stats["recon_occupancy"] < 1
    # a second validation accumulates the running scores
    trainer.validate(0, tuples[:1], names, eps=eps[:1])
    assert len(scores["voxel_chamfer"]) == N_BATCHES + 1
    assert scores["semantic"].sum() > want_scores["semantic"].sum()
