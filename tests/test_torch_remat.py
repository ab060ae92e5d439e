"""Rematerialisation of the detector's conv stacks (``cfg.remat``) in the
port, on the CPU at the tests' small width (grid 32, feat_dim 32, K 6,
T 4, B 2).

* The parameters and their ``state_dict`` keys do not depend on ``remat``,
  and ``weights.state_dict_from_jax`` carries a JAX tree made at
  ``remat=2`` into a port model at ``remat=2``.
* A detector-phase step with ``grad_accum`` 2 at ``remat`` 1 and 2 equals
  the ``remat=0`` step to the bit (every gradient as the optimizer gets
  it, every metric, every parameter after Adam, the generator's state),
  for ``const_intensity`` 2, where the per-frame and the spatio-temporal
  feature nets are both regions: in float32 on the plain route, and in
  bfloat16 on the conv route (``conv_kernel=True``; the route takes only
  bfloat16 convs), where ``_Conv3d`` runs its plain version under the
  checkpoint. Recomputation is real: the conv route's calls of K3's plain
  version follow ``chip_smoke.routed_remat_launches``, the formula the
  card's launch counters are held to, and the activations autograd keeps
  outside the regions shrink.
* The JAX package's train step at ``remat`` 1 and 2 against the port's at
  the same value, at the tolerances of ``tests/test_torch_train_step.py``.
* Without a gradient nothing changes: the eval step and a stream window at
  ``remat=2`` equal ``remat=0``'s to the bit.
* ``cli.train --remat 2`` records the value in ``opt.json``, and a
  checkpoint saved at ``remat=0`` resumes at ``remat=2`` into the same
  epoch to the bit; over four gloo processes (data 2 x model 2) a
  ``remat=2`` step equals the ``remat=0`` step to the bit on every rank.

About 2.5 minutes alone on one core, half of it the two JAX step
compiles.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_marionette_tpu.train import LossScheduler as JaxScheduler
from neural_marionette_tpu.train import create_train_state as jax_state
from neural_marionette_tpu.train import make_train_step as jax_train_step

from neural_marionette_tpu_torch.api import Marionette
from neural_marionette_tpu_torch.cli import train as cli_train
from neural_marionette_tpu_torch.models import NeuralMarionette
from neural_marionette_tpu_torch.models.detector import remat_level
from neural_marionette_tpu_torch.ops import conv3d as K3
from neural_marionette_tpu_torch.train import (LossScheduler,
                                               create_train_state,
                                               make_eval_step,
                                               make_train_step)
from neural_marionette_tpu_torch.weights import (init_weights,
                                                 state_dict_from_jax)

from _torch_port import configs, jax_params, moving_vox
from test_real_layout import _write_aist_tree
from test_torch_train_step import (PHASES, _check_gradients, _check_metrics,
                                   _check_params, _numpy_tree)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the card's launch formula)

B, ACCUM = 2, 2
DETECTOR = PHASES["detector"]
ROUTES = {"plain": (torch.float32, False), "conv_kernel": (torch.bfloat16,
                                                           True)}


def _cfg(remat, **kw):
    return dataclasses.replace(configs(**DETECTOR[0])[1], remat=remat, **kw)


def _net(cfg, dtype=torch.float32, conv_kernel=False, seed=0):
    net = NeuralMarionette(cfg, dtype=dtype, conv_kernel=conv_kernel)
    init_weights(net, torch.Generator().manual_seed(seed))
    return net


class _CountedPlainConv:
    """Counts the calls of K3's plain version, the kernel's counterpart on
    the CPU (one per routed conv launched, recomputations included)."""

    def __enter__(self):
        self.n, self._plain = 0, K3.conv3d_plain

        def counted(*a, **k):
            self.n += 1
            return self._plain(*a, **k)

        K3.conv3d_plain = counted
        return self

    def __exit__(self, *exc):
        K3.conv3d_plain = self._plain


def _port_step(remat, route="plain", ci=2, accum=ACCUM, pts=None):
    """One detector-phase step of the port from seeded weights: (metrics,
    the gradients the optimizer got, the parameters after it, the
    generator's state, K3's plain calls, the model)."""
    dtype, ck = ROUTES[route]
    cfg = _cfg(remat, const_intensity=ci, grad_accum=accum)
    net = _net(cfg, dtype, ck)
    sched = LossScheduler(cfg)
    sched.anneal(0)
    state = create_train_state(cfg, net, torch.Generator().manual_seed(5))
    grads = []
    update = state.optimizer.update

    def capture(gs, trainable):
        grads.extend(None if g is None else g.clone() for g in gs)
        return update(gs, trainable)

    state.optimizer.update = capture
    step = make_train_step(net, cfg, sched.active_weights(), *DETECTOR[1])
    if pts is None:
        pts = moving_vox(B=B, T=cfg.Ttot, G=cfg.grid_size, seed=1)[1]
    with _CountedPlainConv() as calls:
        metrics = step(state, torch.from_numpy(pts))
    params = {k: v.detach().clone() for k, v in net.named_parameters()}
    return dict(metrics=metrics, grads=grads, params=params,
                generator=state.generator.get_state(), calls=calls.n,
                net=net)


# ---------------------------------------------------------------- weights
@pytest.mark.parametrize("ci", (0, 2))
def test_state_dict_keys_do_not_depend_on_remat(ci):
    nets = {r: NeuralMarionette(_cfg(r, const_intensity=ci))
            for r in (0, 1, 2)}
    shapes = {r: {k: tuple(v.shape) for k, v in n.state_dict().items()}
              for r, n in nets.items()}
    assert list(shapes[0]) == list(shapes[1]) == list(shapes[2])
    assert shapes[0] == shapes[1] == shapes[2]
    init_weights(nets[0], torch.Generator().manual_seed(ci))
    nets[2].load_state_dict(nets[0].state_dict(), strict=True)
    for k, v in nets[0].state_dict().items():
        assert torch.equal(nets[2].state_dict()[k], v), k


def test_jax_tree_at_remat_2_loads_into_the_port_at_remat_2():
    """The JAX package's tree at ``remat=2`` is its tree at 0 but for the
    decoder's name, ``CheckpointVoxelDecoder_0`` under ``nn.remat`` (its
    children's names are pinned); the bridge maps both names alike."""
    jcfg, cfg = configs(const_intensity=2, remat=2)
    _, params = jax_params(jcfg, seed=2)
    _, params0 = jax_params(configs(const_intensity=2)[0], seed=2)
    renamed = jax.tree.map(lambda x: x, params0)
    k2v = renamed["params"]["kypt_detector"]["kypt_to_vox"]
    k2v["CheckpointVoxelDecoder_0"] = k2v.pop("VoxelDecoder_0")
    shapes = [jax.tree.map(np.shape, t) for t in (params, renamed)]
    assert shapes[0] == shapes[1]
    want = state_dict_from_jax(params0)
    got = state_dict_from_jax(renamed)
    assert list(got) == list(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    net = NeuralMarionette(cfg)
    net.load_state_dict(state_dict_from_jax(params), strict=True)


# ------------------------------------------------- remat 1, 2 == remat 0
@pytest.fixture(scope="module")
def steps():
    """The port's steps at remat 0, 1 and 2 on both routes."""
    return {(route, r): _port_step(r, route) for route in ROUTES
            for r in (0, 1, 2)}


@pytest.mark.parametrize("remat", (1, 2))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_step_equals_the_remat_0_step_to_the_bit(steps, route, remat):
    got, want = steps[route, remat], steps[route, 0]
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        assert torch.equal(got["metrics"][k], v), k
    assert len(got["grads"]) == len(want["grads"])
    assert sum(g is not None for g in want["grads"]) > 0
    for a, b in zip(got["grads"], want["grads"]):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
    assert torch.equal(got["generator"], want["generator"])


@pytest.mark.parametrize("remat", (0, 1, 2))
@pytest.mark.parametrize("ci", (0, 2))
def test_routed_conv_launches_follow_the_formula(steps, ci, remat):
    """K3's plain calls in a routed bf16 step (``grad_accum`` 2) are the
    formula's per microbatch, which the card's counters are held to: the
    forward, plus one recompute in each region that reaches the conv. The
    plain route calls none."""
    run = steps["conv_kernel", remat] if ci == 2 else \
        _port_step(remat, "conv_kernel", ci=0)
    det = run["net"].kypt_detector
    assert run["calls"] == ACCUM * chip_smoke.routed_remat_launches(det,
                                                                    remat)
    if remat == 0:
        assert run["calls"] == ACCUM * chip_smoke._routed_per_forward(det)
    assert steps["plain", remat]["calls"] == 0


def _saved_bytes(net, vox, remat):
    """Bytes of the tensors autograd keeps between the forward and the
    backward outside any region (a region keeps only its inputs)."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    net.train()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        net.kypt_detector(vox)
    return total[0]


def test_regions_keep_fewer_activations():
    vox = torch.from_numpy(moving_vox(B=B, T=4, G=32, seed=1)[0])
    saved = {}
    for r in (0, 1, 2):
        saved[r] = _saved_bytes(_net(_cfg(r, const_intensity=2)), vox, r)
    assert saved[1] < saved[0] / 4, saved
    assert saved[2] <= saved[1], saved


# -------------------------------------------------------------- against JAX
@pytest.mark.parametrize("remat", (1, 2))
def test_step_matches_jax_at_the_same_remat(remat):
    jcfg, cfg = configs(remat=remat, **DETECTOR[0])
    model, params = jax_params(jcfg, seed=0)
    pts = moving_vox(B=B, T=jcfg.Ttot, G=jcfg.grid_size, seed=0)[1]
    jsched = JaxScheduler(jcfg)
    jsched.anneal(0)
    step = jax_train_step(model, jcfg, jsched.active_weights(),
                          *DETECTOR[1], mesh=None, donate=False)
    jstate, jm = step(jax_state(jcfg, params, jax.random.PRNGKey(3)),
                      jnp.asarray(pts), None)
    net = NeuralMarionette(cfg)
    net.load_state_dict(state_dict_from_jax(params), strict=True)
    sched = LossScheduler(cfg)
    sched.anneal(0)
    pstate = create_train_state(cfg, net, torch.Generator().manual_seed(0))
    pm = make_train_step(net, cfg, sched.active_weights(), *DETECTOR[1])(
        pstate, torch.from_numpy(pts))
    run = dict(jcfg=jcfg, jstate=jstate, jmetrics=[_numpy_tree(jm)],
               pstate=pstate, pmetrics=[pm])
    _check_metrics(run)
    _check_gradients(run)
    _check_params(run)


# ------------------------------------------------ no gradient, no effect
def test_eval_step_and_stream_window_are_unchanged():
    vox, pts = moving_vox(B=B, T=4, G=32, seed=3)
    res = {}
    for r in (0, 2):
        cfg = _cfg(r)
        net = _net(cfg)
        sched = LossScheduler(cfg)
        sched.anneal(0)
        metrics, tensors = make_eval_step(net, cfg, sched.active_weights(),
                                          *DETECTOR[1])(
            torch.from_numpy(vox), generator=torch.Generator().manual_seed(1))
        net.eval()
        assert remat_level(net.kypt_detector.vox_to_kypt) == 0
        m = Marionette.from_config(cfg, seed=4, device="cpu")
        with m.stream(dtype="float32", sample_num=3,
                      outputs=("keypoints", "kypt_recon", "R",
                               "recon")) as s:
            window = list(s.run([pts]))
        res[r] = (metrics, tensors, window)
    (m0, t0, w0), (m2, t2, w2) = res[0], res[2]
    for k in m0:
        assert torch.equal(m0[k], m2[k]), k
    for k in t0:
        assert torch.equal(t0[k], t2[k]), k
    assert len(w0) == len(w2) == 1
    for k in w0[0]:
        np.testing.assert_array_equal(w0[0][k], w2[0][k], err_msg=k)


def test_remat_level_needs_training_mode_and_grad():
    net = _net(_cfg(2))
    det = net.kypt_detector.vox_to_kypt
    assert remat_level(det) == 2
    with torch.no_grad():
        assert remat_level(det) == 0
    net.eval()
    assert remat_level(det) == 0
    net.train()
    assert remat_level(net.kypt_detector.kypt_to_vox) == 2


# ------------------------------------------------------ CLI and processes
CLI_FLAGS = ["--platform", "cpu", "--dataset", "aist",
             "--apply_adjust_config", "0", "--grid_size", "32",
             "--feat_dim", "32", "--nkeypoints", "6", "--Ttot", "4",
             "--Tcond", "2", "--sample_rate", "2", "--nbatch", "2",
             "--n_points", "256", "--num_workers", "0",
             "--nlatent_kypt", "16", "--nhidden_kypt", "32",
             "--is_eval", "0", "--save_every", "1", "--detector_start", "0",
             "--detector_end", "10", "--learner_start", "10",
             "--affinity_anneal", "0", "--exp_name", "v"]
EXP = "rl_setup/disc_training/aist/affinity_params/6kypt/v"


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Epoch 0 at remat 0 with its checkpoint; then epoch 1 resumed from it
    at remat 0 and, in a copy of the tree, at remat 2 (two steps each)."""
    tmp = tmp_path_factory.mktemp("remat_cli")
    data = tmp / "data"
    _write_aist_tree(str(data), n_train=4, n_test=2)

    def train(out, nepoch, remat):
        cli_train.main(CLI_FLAGS + ["--data_root", str(data),
                                    "--output_root", str(out),
                                    "--nepoch", str(nepoch),
                                    "--remat", str(remat)])
        return out / EXP

    first = train(tmp / "a", 1, 0)
    shutil.copytree(tmp / "a", tmp / "b")
    return dict(remat0=train(tmp / "a", 2, 0), remat2=train(tmp / "b", 2, 2),
                first=first)


def test_cli_records_remat_in_opt_json(cli_runs):
    for name, want in (("remat0", 0), ("remat2", 2)):
        opt = json.loads((cli_runs[name] / "opt.json").read_text())
        assert opt["remat"] == want, name


def test_remat_0_checkpoint_resumes_at_remat_2_to_the_bit(cli_runs):
    a, b = cli_runs["remat0"], cli_runs["remat2"]
    recs = [[json.loads(ln) for ln in (d / "metrics.jsonl").read_text()
             .splitlines()] for d in (a, b)]
    assert [r["epoch"] for r in recs[0]] == [r["epoch"] for r in recs[1]] \
        == [0, 1]
    assert recs[0][1]["train"] == recs[1][1]["train"]
    assert all(np.isfinite(v) for v in recs[1][1]["train"].values())
    files = sorted(p.relative_to(a / "epochs/1")
                   for p in (a / "epochs/1").rglob("*") if p.is_file())
    assert files
    for rel in files:
        if rel.suffix == ".json":
            continue
        assert (a / "epochs/1" / rel).read_bytes() == \
            (b / "epochs/1" / rel).read_bytes(), rel


WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
from neural_marionette_tpu_torch.config import MarionetteConfig
from neural_marionette_tpu_torch.models import NeuralMarionette
from neural_marionette_tpu_torch.parallel import make_mesh, shard_batch
from neural_marionette_tpu_torch.parallel.distributed import (
    initialize, shutdown, warmup_collectives)
from neural_marionette_tpu_torch.train import (create_train_state,
                                               make_train_step)

port, rank, world, job_path = sys.argv[1:5]
rank, world = int(rank), int(world)
initialize(f"localhost:{port}", world, rank, device="cpu")
mesh = make_mesh(2, 2)
warmup_collectives(mesh)
job = torch.load(job_path, weights_only=False)
res = {}
for remat in (0, 2):
    cfg = MarionetteConfig(**{**job["cfg"], "remat": remat})
    net = NeuralMarionette(cfg)
    net.load_state_dict(job["state_dict"])
    state = create_train_state(cfg, net, torch.Generator().manual_seed(7))
    step = make_train_step(net, cfg, job["weights"], True, False, True,
                           mesh=mesh)
    metrics = step(state, shard_batch(mesh, job["points"],
                                      microbatches=cfg.grad_accum))
    res[remat] = {"metrics": {k: v.clone() for k, v in metrics.items()},
                  "params": {k: v.detach().clone()
                             for k, v in net.named_parameters()},
                  "generator": state.generator.get_state()}
torch.save(res, f"{job_path}.{rank}")
shutdown()
"""


def test_distributed_remat_2_step_equals_remat_0_on_every_rank(tmp_path):
    """data 2 x model 2 (the detector's frames split over the model row,
    gathered outside the regions), ``grad_accum`` 2, global batch 4."""
    from test_torch_parallel import _free_port
    cfg = _cfg(0, grad_accum=ACCUM)
    sched = LossScheduler(cfg)
    sched.anneal(0)
    job = {"cfg": dataclasses.asdict(cfg),
           "state_dict": _net(cfg, seed=6).state_dict(),
           "weights": sched.active_weights(),
           "points": torch.from_numpy(moving_vox(B=4, T=4, G=32,
                                                 seed=4)[1])}
    path = tmp_path / "job.pt"
    torch.save(job, path)
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(port),
                               str(r), "4", str(path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    for r in range(4):
        res = torch.load(f"{path}.{r}", weights_only=False)
        for part in ("metrics", "params"):
            for k, v in res[0][part].items():
                assert torch.equal(res[2][part][k], v), (r, part, k)
        assert torch.equal(res[2]["generator"], res[0]["generator"])
