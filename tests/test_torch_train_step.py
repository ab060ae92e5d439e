"""The port's train step against the JAX package's ``make_train_step``, on
the CPU, on the same parameters (carried by ``state_dict_from_jax``), the
same point batch and, in the learner phase, the same sample noise.

Gradients are compared as Adam's first moment after step 1, which is
``(1 - b1)`` times the masked, clipped gradient on both sides. Tolerances
(float32 on both sides):

* loss scalars 2e-3 relative (as the serving slice's), ``grad_norm`` 1e-3;
* gradients, per tensor, max abs error 2e-2 of the tensor's largest entry,
  and over all tensors a relative L2 error of 1e-3. The float32 gradients
  of these deep conv stacks are ill-conditioned: on the detector-phase
  batch the JAX package's own float32 gradient lies up to 4.8e-3 (per
  tensor) and 3.8e-4 (L2) from its float64 gradient, the port's 9.4e-3
  and 2.4e-4;
* parameters after one Adam step: each moves by lr * g / (|g| + eps), about
  lr * sign(g), so an element whose gradient is near eps or near a sign
  change differs by up to 2 lr. Every element within 2 lr, and all but
  1/1000 of them within 5e-5 + 1e-2 |p| (the criterion of
  ``tests/test_train_step.py::test_grad_accum_matches_full_batch``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_marionette_tpu.models import SkeletonArrays as JaxSkeletonArrays
from neural_marionette_tpu.ops import voxelize_jnp
from neural_marionette_tpu.skeleton import extract_skeleton as jax_skeleton
from neural_marionette_tpu.train import LossScheduler as JaxScheduler
from neural_marionette_tpu.train import create_train_state as jax_state
from neural_marionette_tpu.train import make_eval_step as jax_eval_step
from neural_marionette_tpu.train import make_train_step as jax_train_step

from neural_marionette_tpu_torch.models import NeuralMarionette
from neural_marionette_tpu_torch.models import SkeletonArrays
from neural_marionette_tpu_torch.train import (LOSS_LIST, LossScheduler,
                                               create_train_state,
                                               make_eval_step,
                                               make_train_step)
from neural_marionette_tpu_torch.train.step import _as_voxels
from neural_marionette_tpu_torch.weights import state_dict_from_jax

from _torch_port import configs, jax_params, jax_sample_eps, moving_vox

B = 2
PHASES = {
    # name: (config fields, (detector, learner, affinity))
    "detector": (dict(detector_start=0, learner_start=int(1e9),
                      affinity_anneal=0), (True, False, True)),
    # pretrained_mode=1: the detector frozen, the VRNN trains
    "learner": (dict(detector_end=0, learner_start=0, affinity_anneal=0),
                (False, True, True)),
}


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_mu(opt_state):
    """Adam's first moment from the JAX optimizer state (inject_hyperparams
    -> chain(clip, adam) -> scale_by_adam)."""
    return state_dict_from_jax(_numpy_tree(opt_state.inner_state[1][0].mu))


def _run(phase, accum=1, jax_steps=1):
    """One phase's step on both sides from the same parameters: the JAX
    state and metrics after ``jax_steps`` steps, the port's after as many,
    the port's Adam moments, and the noise both drew."""
    fields, flags = PHASES[phase]
    jcfg, cfg = configs(grad_accum=accum, **fields)
    model, params = jax_params(jcfg, seed=0)
    _, pts = moving_vox(B=B, T=jcfg.Ttot, G=jcfg.grid_size, seed=0)
    jsched = JaxScheduler(jcfg)
    jsched.anneal(0)
    weights = jsched.active_weights()
    jsk = sk = None
    if flags[1]:
        aff = model.apply(params,
                          method=lambda m: m.kypt_detector.get_affinity())
        skel = jax_skeleton(np.asarray(aff))
        jsk = JaxSkeletonArrays.from_skeleton(skel)
        sk = SkeletonArrays.from_skeleton(skel)
    state = jax_state(jcfg, params, jax.random.PRNGKey(3))
    step = jax_train_step(model, jcfg, weights, *flags, mesh=None,
                          donate=False)
    jmetrics, eps = [], []
    for _ in range(jax_steps):
        sample_rng = jax.random.split(state.rng, 3)[1]
        keys = (jax.random.split(sample_rng, accum) if accum > 1
                else [sample_rng])
        eps.append([
            torch.from_numpy(jax_sample_eps(
                model, params,
                jax.random.split(k)[0] if accum > 1 else k,
                jcfg.Ttot, 10, B // accum, jcfg.nlatent_kypt))
            for k in keys] if flags[1] else None)
        state, m = step(state, jnp.asarray(pts), jsk)
        jmetrics.append(_numpy_tree(m))

    net = NeuralMarionette(cfg)
    net.load_state_dict(state_dict_from_jax(params), strict=True)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    sched = LossScheduler(cfg)
    sched.anneal(0)
    assert sched.phase_key() == jsched.phase_key()
    pstate = create_train_state(cfg, net, torch.Generator().manual_seed(0))
    pstep = make_train_step(net, cfg, sched.active_weights(), *flags)
    pmetrics = [pstep(pstate, torch.from_numpy(pts), sk, eps=eps[i])
                for i in range(jax_steps)]
    return dict(jcfg=jcfg, cfg=cfg, pts=pts, model=model, params=params,
                weights=weights, jstate=state,
                jmetrics=jmetrics, pstate=pstate, pmetrics=pmetrics,
                before=before, flags=flags)


@pytest.fixture(scope="module")
def detector_run():
    return _run("detector")


@pytest.fixture(scope="module")
def learner_run():
    return _run("learner")


@pytest.fixture(scope="module")
def accum_run():
    return _run("detector", accum=2)


def _check_metrics(run, i=0):
    got, want = run["pmetrics"][i], run["jmetrics"][i]
    assert set(got) == set(want) == set(LOSS_LIST) | {"total_loss",
                                                       "grad_norm"}
    for k in LOSS_LIST + ["total_loss"]:
        assert got[k].shape == ()
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=2e-3,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(got["grad_norm"].numpy(), want["grad_norm"],
                               rtol=1e-3)


def _check_gradients(run, prefix=None):
    """Adam's first moment (1 - b1) * clip(mask * g) on both sides."""
    want = _jax_mu(run["jstate"].opt_state)
    opt = run["pstate"].optimizer
    err2 = ref2 = 0.0
    for name, mu in zip(opt.names, opt.mu):
        if prefix is not None and not name.startswith(prefix):
            continue
        a, b = mu.numpy(), want[name].numpy()
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-2 * scale + 1e-12,
                                   err_msg=name)
        err2 += float(((a - b).astype(np.float64) ** 2).sum())
        ref2 += float((b.astype(np.float64) ** 2).sum())
    assert ref2 > 0
    assert np.sqrt(err2 / ref2) < 1e-3, np.sqrt(err2 / ref2)


def _check_params(run):
    lr = run["jcfg"].lrate
    want = state_dict_from_jax(_numpy_tree(run["jstate"].params))
    total = loose = 0
    for name, p in run["pstate"].model.named_parameters():
        a, b = p.detach().numpy(), want[name].numpy()
        d = np.abs(a - b)
        assert d.max() <= 2 * lr + 1e-6, (name, d.max())
        loose += int((d > 5e-5 + 1e-2 * np.abs(b)).sum())
        total += a.size
    assert loose <= total // 1000, (loose, total)


def test_as_voxels_matches_jax(detector_run):
    """The step's points -> voxels on the CPU (K1's plain version) equals
    the JAX step's ``voxelize_jnp`` on this batch; bfloat16 is exact."""
    run = detector_run
    G = run["cfg"].grid_size
    pts = torch.from_numpy(run["pts"])
    want = np.asarray(voxelize_jnp(jnp.asarray(run["pts"]), G))
    got = _as_voxels(pts, run["cfg"])
    np.testing.assert_array_equal(got.numpy(), want)
    bf16 = _as_voxels(pts, run["cfg"], torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16.float().numpy(), want)
    assert _as_voxels(got, run["cfg"], torch.bfloat16).dtype == \
        torch.bfloat16


def test_detector_step_metrics_match_jax(detector_run):
    _check_metrics(detector_run)
    assert float(detector_run["pmetrics"][0]["kypt_recon_loss"]) == 0.0


def test_detector_step_gradients_match_jax(detector_run):
    _check_gradients(detector_run)


def test_detector_step_params_match_jax(detector_run):
    """Updated parameters; ``offset_param`` and the (inactive) dynamics
    unchanged to the bit."""
    _check_params(detector_run)
    model, before = detector_run["pstate"].model, detector_run["before"]
    for name, p in model.named_parameters():
        if name.startswith("dyna_module."):
            assert torch.equal(p.detach(), before[name]), name
    assert detector_run["pstate"].step == 1
    assert detector_run["pstate"].optimizer.count == 1


def test_learner_step_matches_jax(learner_run):
    """Learner phase with the JAX step's noise: every metric (kl_kypt and
    kypt_recon_loss among them), the VRNN's gradients and parameters; the
    frozen detector and ``offset_param`` unchanged to the bit on both
    sides."""
    run = learner_run
    _check_metrics(run)
    for k in ("kl_kypt", "kypt_recon_loss"):
        assert float(run["pmetrics"][0][k]) > 0, k
    _check_gradients(run, prefix="dyna_module.")
    _check_params(run)
    want = state_dict_from_jax(_numpy_tree(run["jstate"].params))
    for name, p in run["pstate"].model.named_parameters():
        if name.startswith("kypt_detector.") or name.endswith("offset_param"):
            assert torch.equal(p.detach(), run["before"][name]), name
            np.testing.assert_array_equal(want[name].numpy(),
                                          run["before"][name].numpy())


def test_grad_accum_matches_jax_and_full_batch(accum_run, detector_run):
    """grad_accum=2 against the JAX step with grad_accum=2 (metrics,
    gradients, parameters), and against the port's own full-batch step:
    the losses are batch means, so total_loss agrees to 1e-5 relative and
    the parameters by the criterion above."""
    _check_metrics(accum_run)
    _check_gradients(accum_run)
    _check_params(accum_run)
    np.testing.assert_allclose(
        accum_run["pmetrics"][0]["total_loss"].numpy(),
        detector_run["pmetrics"][0]["total_loss"].numpy(), rtol=1e-5)
    full = dict(detector_run["pstate"].model.named_parameters())
    total = loose = 0
    for name, p in accum_run["pstate"].model.named_parameters():
        a, b = p.detach().numpy(), full[name].detach().numpy()
        loose += int((np.abs(a - b) > 5e-5 + 1e-2 * np.abs(b)).sum())
        total += a.size
    assert loose <= total // 1000, (loose, total)


def test_eval_step_matches_jax(detector_run):
    """``make_eval_step`` (detector on, learner off) against the JAX
    package's on the step's starting parameters and batch: every metric at
    the step's tolerance, the logged tensors at the serving slice's
    (``tests/test_torch_models.py``: 1e-4 absolute, the affinity 1e-6), and
    no gradient kept."""
    run = detector_run
    flags = (True, False, True)
    jeval = jax_eval_step(run["model"], run["jcfg"], run["weights"], *flags)
    want_m, want_t = _numpy_tree(jeval(run["params"], jnp.asarray(run["pts"]),
                                       None, jax.random.PRNGKey(0)))
    net = NeuralMarionette(run["cfg"])
    net.load_state_dict(state_dict_from_jax(run["params"]), strict=True)
    peval = make_eval_step(net, run["cfg"], run["weights"], *flags)
    got_m, got_t = peval(torch.from_numpy(run["pts"]))
    assert set(got_m) == set(want_m) and set(got_t) == set(want_t)
    for k, v in got_m.items():
        np.testing.assert_allclose(v.numpy(), want_m[k], rtol=2e-3, atol=1e-7,
                                   err_msg=k)
    for k, v in got_t.items():
        assert not v.requires_grad, k
        np.testing.assert_allclose(v.numpy(), want_t[k], rtol=0,
                                   atol=1e-6 if k == "affinity" else 1e-4,
                                   err_msg=k)


def test_step_checks_its_arguments(detector_run):
    run = detector_run
    cfg = dataclasses.replace(run["cfg"], grad_accum=2)
    net = run["pstate"].model
    step = make_train_step(net, cfg, {}, *run["flags"])
    with pytest.raises(ValueError, match="multiple"):
        step(run["pstate"], torch.zeros(3, 4, 8, 3))
    with pytest.raises(ValueError, match="microbatch"):
        step(run["pstate"], torch.zeros(2, 4, 8, 3), eps=[None])
    other = create_train_state(cfg, NeuralMarionette(cfg),
                               torch.Generator())
    with pytest.raises(ValueError, match="model"):
        step(other, torch.zeros(2, 4, 8, 3))
