"""The port's training layer against the JAX package's, on the CPU: the loss
registry, ``LossScheduler`` and ``MetricLogger``, the update mask, the
masked Adam against optax, ``total_loss``, and the trainer loop (learning
rate stages, the skeleton at learner start, checkpoints resumed to the
bit). The step itself against ``make_train_step`` is in
``tests/test_torch_train_step.py``.
"""
import dataclasses
import itertools
import math
import shutil

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_marionette_tpu.config import adjust_config as jax_adjust
from neural_marionette_tpu.config import derive_training_id
from neural_marionette_tpu.skeleton import extract_skeleton as jax_skeleton
from neural_marionette_tpu.train import losses as JL
from neural_marionette_tpu.train import LossScheduler as JaxScheduler
from neural_marionette_tpu.train import MetricLogger as JaxLogger
from neural_marionette_tpu.train import make_optimizer as jax_optimizer
from neural_marionette_tpu.train import make_update_mask as jax_mask
from neural_marionette_tpu.train import total_loss as jax_total_loss

from neural_marionette_tpu_torch.config import MarionetteConfig
from neural_marionette_tpu_torch.models import NeuralMarionette
from neural_marionette_tpu_torch.train import (Adam, CheckpointManager,
                                               LossScheduler, MetricLogger,
                                               Trainer, create_train_state,
                                               make_train_step,
                                               make_update_mask,
                                               reset_optimizer,
                                               set_learning_rate, total_loss)
from neural_marionette_tpu_torch.train import losses as PL
from neural_marionette_tpu_torch.weights import state_dict_from_jax

from _torch_port import configs, jax_params, moving_vox


def _schedule_configs():
    """name -> JAX config: the AIST preset, its pretrained_mode=1 (the
    dynamics run: detector frozen from epoch 0), and a run whose learner
    starts at epoch 2 with the affinity gated until epoch 1."""
    from neural_marionette_tpu.config import MarionetteConfig as JaxConfig
    aist = jax_adjust(JaxConfig(dataset="aist"))
    dyna = derive_training_id(jax_adjust(JaxConfig(dataset="aist",
                                                   pretrained_mode=1)))
    staged = JaxConfig(detector_start=0, detector_end=3, learner_start=2,
                       affinity_anneal=1, firstdecay=2, seconddecay=4,
                       nepoch=6)
    return {"aist": aist, "aist_pretrained_mode_1": dyna,
            "learner_start_2": staged}


def _port_config(jcfg):
    return MarionetteConfig(**dataclasses.asdict(jcfg))


def test_loss_tables_match_jax():
    jcfg = _schedule_configs()["aist"]
    cfg = _port_config(jcfg)
    assert PL.LOSS_LIST == JL.LOSS_LIST
    assert PL.DETECTOR_LOSSES == JL.DETECTOR_LOSSES
    assert PL.LEARNER_LOSSES == JL.LEARNER_LOSSES
    assert PL.loss_weights(cfg) == JL.loss_weights(jcfg)
    assert PL.anneal_epochs(cfg) == JL.anneal_epochs(jcfg)
    assert PL.module_active_epochs(cfg) == JL.module_active_epochs(jcfg)


@pytest.mark.parametrize("name", sorted(_schedule_configs()))
def test_scheduler_matches_jax(name):
    """Every epoch of the run: module activity, the affinity gate, the
    active losses and weights, the staged learning rate and the phase
    key, equal."""
    jcfg = _schedule_configs()[name]
    js, ps = JaxScheduler(jcfg), LossScheduler(_port_config(jcfg))
    assert ps.milestones == js.milestones
    assert ps.loss_names_anneal == js.loss_names_anneal
    keys = set()
    for epoch in range(jcfg.nepoch):
        js.anneal(epoch)
        ps.anneal(epoch)
        assert ps.module_actives == js.module_actives, epoch
        assert ps.affinity_active == js.affinity_active, epoch
        assert ps.current_loss_names == js.current_loss_names, epoch
        assert ps.active_weights() == js.active_weights(), epoch
        assert ps.learning_rate(epoch) == js.learning_rate(epoch), epoch
        assert ps.phase_key() == js.phase_key(), epoch
        keys.add(ps.phase_key())
    if name == "learner_start_2":
        assert len(keys) == 4  # detector, +affinity, +learner, learner only


def test_metric_logger_matches_jax():
    g = np.random.default_rng(0)
    jl, pl = JaxLogger(), MetricLogger()
    for epoch in range(3):
        for _ in range(4):
            m = {"a": g.normal(), "b": np.float32(g.normal())}
            if epoch != 1:
                m["c"] = g.normal()
            jl.add_dict(m)
            pl.add_dict(m)
        assert pl.mean("a") == jl.mean("a")
        assert pl.reset() == jl.reset()
    assert pl.history == jl.history
    assert math.isnan(pl.mean("missing"))


@pytest.fixture(scope="module")
def small():
    """The small configuration on both sides, the JAX parameters and the
    port's parameter names (made once: the JAX shapes take a trace)."""
    jcfg, cfg = configs()
    _, params = jax_params(jcfg)
    names = [n for n, _ in NeuralMarionette(cfg).named_parameters()]
    return jcfg, cfg, params, names


@pytest.mark.parametrize("flags", list(itertools.product([False, True],
                                                        repeat=3)))
def test_update_mask_matches_jax(flags, small):
    """The 0/1 mask of every parameter, for all eight phase combinations,
    carried through the weight bridge."""
    _, _, params, names = small
    want = state_dict_from_jax(jax.tree.map(
        lambda m, p: np.full(p.shape, m, np.float32),
        jax_mask(params, *flags), params))
    got = make_update_mask(names, *flags)
    assert set(got) == set(want)
    for name, value in got.items():
        assert np.all(want[name].numpy() == value), name
    assert got["dyna_module.offset_param"] == 0.0


def _optax(cfg, params, grads_per_step, mask):
    tx = jax_optimizer(cfg)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p)
    norms = []
    for grads in grads_per_step:
        g = {k: jnp.asarray(v) * mask[k] for k, v in grads.items()}
        norms.append(float(optax.global_norm(g)))
        u, state = tx.update(g, state, p)
        p = optax.apply_updates(p, {k: u[k] * mask[k] for k in u})
    return p, state, norms


def test_adam_matches_optax():
    """Three steps of the port's Adam with the clip triggered and a masked
    parameter, against the JAX package's optax chain: parameters, moments
    and pre-clip norms. The same float32 operations in the same order, but
    XLA may divide by the norm through its reciprocal and round float32
    ** n otherwise, so each may differ by an ulp, which the moment sums'
    cancellation can lift: rtol 1e-6 plus 1e-6 of the largest entry. The
    masked parameter is unchanged to the bit."""
    jcfg, cfg = configs(max_grad_norm=1.0, lrate=3e-3)
    g = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 2)}
    mask = {"a": 1.0, "b": 0.0, "c": 1.0}
    params = {k: g.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    steps = [{k: (g.normal(size=s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    want, jstate, jnorms = _optax(jcfg, params, steps, mask)

    torch_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                    for k, v in params.items()}
    opt = Adam(torch_params, cfg.max_grad_norm, cfg.lrate)
    for i, grads in enumerate(steps):
        norm = opt.update([torch.from_numpy(grads[k]) for k in opt.names],
                          [mask[k] == 1.0 for k in opt.names])
        assert norm.item() > cfg.max_grad_norm  # the clip fires
        np.testing.assert_allclose(norm.item(), jnorms[i], rtol=1e-6)
    adam = jstate.inner_state[1][0]
    assert opt.count == int(adam.count) == 3
    def close(a, b):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(b).max()))

    for i, k in enumerate(opt.names):
        close(torch_params[k].detach().numpy(), want[k])
        close(opt.mu[i].numpy(), adam.mu[k])
        close(opt.nu[i].numpy(), adam.nu[k])
    np.testing.assert_array_equal(torch_params["b"].detach().numpy(),
                                  params["b"])


def test_learning_rate_and_reset_optimizer(small):
    """``set_learning_rate`` holds the rate in float32 as optax's
    inject_hyperparams does; ``reset_optimizer`` zeroes the moments and the
    count and keeps the rate, the parameters and the generator."""
    from neural_marionette_tpu.train import create_train_state as jax_create
    from neural_marionette_tpu.train import reset_optimizer as jax_reset
    from neural_marionette_tpu.train import set_learning_rate as jax_set_lr
    jcfg, cfg, params, _ = small
    jstate = jax_reset(jcfg, jax_set_lr(jax_create(
        jcfg, params, jax.random.PRNGKey(0)), 3e-4))
    net = NeuralMarionette(cfg)
    gen = torch.Generator().manual_seed(5)
    state = set_learning_rate(create_train_state(cfg, net, gen), 3e-4)
    assert state.optimizer.lr == float(
        jstate.opt_state.hyperparams["learning_rate"])
    state.optimizer.count = 7
    for t in state.optimizer.mu + state.optimizer.nu:
        t.fill_(1.0)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    out = reset_optimizer(cfg, state)
    assert out.optimizer.count == 0 and out.optimizer.lr == state.optimizer.lr
    assert all(float(t.abs().max()) == 0.0
               for t in out.optimizer.mu + out.optimizer.nu)
    assert out.generator is gen
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_total_loss_dtype_matches_jax():
    """The weighted sum promotes as JAX does: bfloat16 terms sum in
    bfloat16, a float32 term lifts the total to float32; absent losses are
    0."""
    g = np.random.default_rng(1)
    weights = {n: float(g.uniform(0.1, 2)) for n in PL.LOSS_LIST}
    for f32_keys in ((), ("kl_kypt", "kypt_recon_loss")):
        vals = {n: np.float32(g.uniform(0, 1))
                for n in PL.LOSS_LIST[:8] + ["kl_kypt", "kypt_recon_loss"]}
        jout = {n: jnp.asarray(v, jnp.float32 if n in f32_keys
                               else jnp.bfloat16) for n, v in vals.items()}
        pout = {n: torch.tensor(v, dtype=torch.float32 if n in f32_keys
                                else torch.bfloat16) for n, v in vals.items()}
        jt, jm = jax_total_loss(jout, weights, jnp.bfloat16)
        pt, pm = total_loss(pout, weights, torch.bfloat16,
                            torch.device("cpu"))
        assert str(pt.dtype).split(".")[-1] == str(jt.dtype)
        np.testing.assert_allclose(pt.float().numpy(),
                                   np.asarray(jt, np.float32), rtol=1e-2)
        assert set(pm) == set(jm)
        assert float(pm["graph_vol_loss"]) == 0.0


def test_loss_decreases_over_six_steps(small):
    """Detector phase, six steps on one batch, as
    ``tests/test_train_step.py::test_detector_phase_loss_decreases``."""
    cfg = dataclasses.replace(small[1], lrate=1e-3)
    params = small[2]
    net = NeuralMarionette(cfg)
    net.load_state_dict(state_dict_from_jax(params))
    sched = LossScheduler(cfg)
    sched.anneal(0)
    state = create_train_state(cfg, net, torch.Generator().manual_seed(0))
    step = make_train_step(net, cfg, sched.active_weights(), True, False,
                           sched.affinity_active)
    _, pts = moving_vox(B=2, T=cfg.Ttot, G=cfg.grid_size, seed=3)
    batch = torch.from_numpy(pts)
    losses = [float(step(state, batch)["total_loss"]) for _ in range(6)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


# ----------------------------------------------------------------- trainer
def _trainer_cfg():
    """Detector from epoch 0, learner from epoch 2 (detector off from 3),
    learning rate stages at epochs 1 and 2."""
    return configs(detector_start=0, detector_end=3, learner_start=2,
                   affinity_anneal=0, firstdecay=1, seconddecay=2,
                   lrate=1e-3, nepoch=4, save_every=1, save_que_len=3)


def _trainer(cfg, params, path=None):
    net = NeuralMarionette(cfg)
    net.load_state_dict(state_dict_from_jax(params))
    return Trainer(cfg, device="cpu", dtype="float32", model=net,
                   logger_path=path)


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """One run of 4 epochs checkpointed every epoch, and a second trainer
    resumed from a copy of its epoch-1 checkpoint."""
    jcfg, cfg = _trainer_cfg()
    model, params = jax_params(jcfg, seed=1)
    _, pts = moving_vox(B=2, T=cfg.Ttot, G=cfg.grid_size, seed=4)
    batches = [pts[:, :, :200], pts[:, :, 200:]]
    root = tmp_path_factory.mktemp("trainer")
    a = _trainer(cfg, params, str(root / "a"))
    records, affinity_at = [], {}
    for epoch in range(cfg.nepoch):
        if epoch == 2:
            # the affinity the skeleton is extracted from, as the epoch starts
            affinity_at[2] = a.model.kypt_detector.affinity_params.detach(
                ).numpy().copy()
        records.extend(a.fit(batches, nepoch=epoch + 1))
        if epoch == 1:
            shutil.copytree(root / "a", root / "b")
    b = _trainer(cfg, params, str(root / "b"))
    resumed_from = b.start_epoch
    resumed = list(b.fit(batches))
    return dict(jcfg=jcfg, cfg=cfg, model=model, params=params, a=a, b=b,
                records=records, resumed=resumed, resumed_from=resumed_from,
                affinity_at=affinity_at, root=root)


def test_trainer_learning_rate_stages_and_phases(trainer_runs):
    run = trainer_runs
    lr = run["cfg"].lrate
    assert [r["epoch"] for r in run["records"]] == [0, 1, 2, 3]
    assert [r["lr"] for r in run["records"]] == [lr, lr / 4, lr / 10,
                                                lr / 10]
    assert run["a"].state.optimizer.lr == float(np.float32(lr / 10))
    phases = [(r["phase"]["detector"], r["phase"]["learner"])
              for r in run["records"]]
    assert phases == [(True, False), (True, False), (True, True),
                      (False, True)]
    assert run["a"].state.step == 8
    for r in run["records"]:
        assert np.isfinite(r["train"]["total_loss"])
        assert np.isfinite(r["train"]["grad_norm"])
    assert run["records"][0]["train"]["kl_kypt"] == 0.0
    assert run["records"][3]["train"]["kl_kypt"] > 0.0


def test_trainer_skeleton_at_learner_start_matches_jax(trainer_runs):
    """The skeleton extracted when the learner turns on (epoch 2) equals
    the JAX package's host extraction from the JAX model's affinity on the
    same, trained, affinity parameters."""
    run = trainer_runs
    params = jax.tree.map(np.asarray, run["params"])
    params["params"]["kypt_detector"]["affinity_params"] = \
        run["affinity_at"][2]
    aff = run["model"].apply(
        params, method=lambda m: m.kypt_detector.get_affinity())
    want = jax_skeleton(np.asarray(aff))
    for a, b in zip(run["a"].skeleton, want):
        np.testing.assert_array_equal(a, b)


def test_trainer_checkpoint_resumes_to_the_bit(trainer_runs):
    """A trainer resumed from the epoch-1 checkpoint reaches, after epochs
    2 and 3, the very parameters, moments, count, generator state, step
    and skeleton of the run that went on; the ring buffer keeps the
    newest ``save_que_len`` epochs."""
    run = trainer_runs
    a, b = run["a"], run["b"]
    assert run["resumed_from"] == 2
    assert [r["epoch"] for r in run["resumed"]] == [2, 3]
    for (n, p), (_, q) in zip(a.model.state_dict().items(),
                              b.model.state_dict().items()):
        assert torch.equal(p, q), n
    for x, y in zip(a.state.optimizer.mu + a.state.optimizer.nu,
                    b.state.optimizer.mu + b.state.optimizer.nu):
        assert torch.equal(x, y)
    assert a.state.optimizer.count == b.state.optimizer.count == 8
    assert torch.equal(a.state.generator.get_state(),
                       b.state.generator.get_state())
    assert a.state.step == b.state.step
    for x, y in zip(a.skeleton, b.skeleton):
        np.testing.assert_array_equal(x, y)
    for ra, rb in zip(run["records"][2:], run["resumed"]):
        assert ra["train"] == rb["train"]
    mgr = CheckpointManager(str(run["root"] / "a"), run["cfg"].save_que_len)
    assert mgr.latest_epoch() == 3
    assert sorted(int(p.name) for p in (run["root"] / "a" / "epochs")
                  .iterdir()) == [1, 2, 3]
    _, skeleton, meta = mgr.restore(
        create_train_state(run["cfg"], NeuralMarionette(run["cfg"]),
                           torch.Generator()), epoch=2)
    assert meta == {"epoch": 2}
    for x, y in zip(skeleton, a.skeleton):
        np.testing.assert_array_equal(x, y)
