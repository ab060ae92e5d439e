"""The port's distributed layer (``parallel/``) on the CPU: gloo over
``localhost``, one thread a process.

* The mesh layouts and the guards (the counterparts of
  ``tests/test_parallel.py::test_mesh_shapes`` and
  ``::test_shard_batch_guards_awkward_shapes``), the rows of each data rank
  (``local_rows``) and the loader's process slices by microbatch.
* One detector-phase and one learner-phase train step (``grad_accum`` 2,
  global batch B 4) in 2 processes (``data 2``), 2 processes (``model 2``:
  the detector's frames split) and 4 processes (``data 2 x model 2``),
  each against the one-process port step on the same global batch and
  against the JAX ``make_train_step`` on one device (one microbatch of
  B 4: the losses are batch means, and ``tests/test_torch_train_step.py``
  holds the port's microbatches against the JAX step's and against its
  own full batch). The learner phase replays the JAX step's noise, cut
  into the two microbatches; a third step (``affinity_ver`` 4, learner
  phase) draws its Gumbel and VRNN noise from the state's generator, so
  the ranks draw the global microbatch's noise and keep their rows.
* The frame-axis detector forward against the JAX ``KyptDetector`` (the
  check of ``tests/_mh_model_axis_worker.py``: keypoints within 1e-4), for
  ``const_intensity`` 3 and 2 (the recurrence).

Tolerances. Against the one-process port step the world differs only in
the order of its float32 arithmetic (each rank's convolutions on fewer
rows or frames, its sums, then the ``all_reduce``), so: metrics 1e-5
relative; Adam's first moment (the clipped gradient
times 0.1) per tensor within 1e-3 of the tensor's largest entry and 1e-4
relative L2 over all, a tenth of the distance of the port's own float32
gradient from float64 (``tests/test_torch_train_step.py``; measured here:
4.8e-5 and 1.3e-5 in the detector phase); parameters within 2 lr
everywhere (Adam's first step moves each element by about lr * sign(g),
so an element whose gradient sits at a sign change may flip) and all but
1/1000 of them within 5e-5 + 1e-2 |p|, the criterion of
``tests/test_torch_train_step.py``; the generators equal to the bit, and
every rank's parameters equal to the bit to rank 0's. Against JAX, the tolerances of
``tests/test_torch_train_step.py``. About 90 s on one core, most of it
the two JAX step compiles, during which the three process groups run.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_marionette_tpu.models import KyptDetector as JaxDetector
from neural_marionette_tpu.models import SkeletonArrays as JaxSkeletonArrays
from neural_marionette_tpu.skeleton import extract_skeleton as jax_skeleton
from neural_marionette_tpu.train import LossScheduler as JaxScheduler
from neural_marionette_tpu.train import create_train_state as jax_state
from neural_marionette_tpu.train import make_train_step as jax_train_step

from neural_marionette_tpu_torch.data import DataLoader
from neural_marionette_tpu_torch.models import NeuralMarionette
from neural_marionette_tpu_torch.models import SkeletonArrays
from neural_marionette_tpu_torch.parallel import (DATA_AXIS, MODEL_AXIS,
                                                  Mesh, check_batch_shape,
                                                  shard_batch)
from neural_marionette_tpu_torch.parallel.mesh import local_rows, mesh_layout
from neural_marionette_tpu_torch.skeleton import extract_skeleton
from neural_marionette_tpu_torch.train import (LossScheduler,
                                               create_train_state,
                                               make_train_step)
from neural_marionette_tpu_torch.weights import state_dict_from_jax

from _torch_port import configs, jax_params, jax_sample_eps, moving_vox
from test_torch_train_step import (PHASES, _check_gradients, _check_metrics,
                                   _check_params, _numpy_tree)

REPO = Path(__file__).resolve().parents[1]
B, ACCUM = 4, 2
TOPOLOGIES = {"data2": (2, 1), "model2": (1, 2), "data2_model2": (2, 2)}
STEPS = ("detector", "learner", "learner_aff4")
FORWARDS = (3, 2)   # const_intensity of the frame-axis forwards


# ------------------------------------------------------------------ layout
def test_mesh_shapes():
    ranks = mesh_layout(8, data=4, model=2)
    assert ranks.shape == (4, 2)
    np.testing.assert_array_equal(ranks, np.arange(8).reshape(4, 2))
    assert mesh_layout(8, model=2).shape == (4, 2)     # data=-1
    with pytest.raises(ValueError, match="3x2 != 8"):
        mesh_layout(8, data=3, model=2)
    with pytest.raises(ValueError, match="not divisible by model=3"):
        mesh_layout(8, model=3)
    m = Mesh(data=4, model=2, rank=5)
    assert m.shape == {DATA_AXIS: 4, MODEL_AXIS: 2} and m.world == 8
    assert (m.data_rank, m.model_rank) == (2, 1)
    assert ranks[m.data_rank, m.model_rank] == m.rank


def test_shard_batch_guards_awkward_shapes():
    """T not divisible by the model (frame) axis, or B by the data axis,
    fails loudly with JAX's messages; an awkward T works on a data-only
    mesh, and a rank gets its rows."""
    mesh = Mesh(data=4, model=2, rank=0)
    with pytest.raises(ValueError, match="T=21 not divisible"):
        shard_batch(mesh, torch.zeros((4, 21, 8, 8, 8, 1)))
    with pytest.raises(ValueError, match="B=3 not divisible"):
        shard_batch(mesh, torch.zeros((3, 4, 8, 8, 8, 1)))
    with pytest.raises(ValueError, match="B=3 not divisible"):
        check_batch_shape(mesh, (3, 4))
    batch = torch.arange(8.0)[:, None, None].expand(8, 21, 4).contiguous()
    out = shard_batch(Mesh(data=8, model=1, rank=5), batch)
    assert out.shape == (1, 21, 4) and float(out[0, 0, 0]) == 5.0


def test_local_rows_are_the_one_process_microbatches():
    """Data rank d holds its share of each contiguous microbatch, so the
    world's microbatch i is the one-process step's; with one microbatch,
    the JAX loader's contiguous slice. The loader's process slices follow
    it."""
    np.testing.assert_array_equal(local_rows(8, 2, 1), [4, 5, 6, 7])
    np.testing.assert_array_equal(local_rows(8, 2, 1, microbatches=2),
                                  [2, 3, 6, 7])
    for data, micro in ((2, 2), (4, 2), (2, 3)):
        bs = 12 if micro == 3 else 8
        rows = [local_rows(bs, data, d, micro).reshape(micro, -1)
                for d in range(data)]
        for i in range(micro):
            got = np.concatenate([r[i] for r in rows])
            np.testing.assert_array_equal(
                got, np.arange(i * bs // micro, (i + 1) * bs // micro))
    with pytest.raises(ValueError, match="multiple"):
        local_rows(6, 2, 0, microbatches=2)

    class Items:
        def __len__(self):
            return 16

        def draw(self, j):
            return None

        def load(self, j, plan):
            return np.array([j])

    def epoch(**kw):
        return [b[:, 0].tolist() for b in DataLoader(
            Items(), 8, seed=3, num_workers=0, **kw)]

    whole = epoch()
    parts = [epoch(process_index=d, process_count=2, microbatches=2)
             for d in range(2)]
    for w, p0, p1 in zip(whole, *parts):
        assert p0 == [w[0], w[1], w[4], w[5]] and p1 == [w[2], w[3], w[6],
                                                         w[7]]
    with pytest.raises(ValueError, match="microbatches"):
        DataLoader(Items(), 6, process_index=0, process_count=2,
                   microbatches=2)


# ------------------------------------------------------------ process groups
WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
from neural_marionette_tpu_torch.config import MarionetteConfig
from neural_marionette_tpu_torch.models import NeuralMarionette, SkeletonArrays
from neural_marionette_tpu_torch.parallel import make_mesh, shard_batch
from neural_marionette_tpu_torch.parallel.distributed import (
    initialize, shutdown, warmup_collectives)
from neural_marionette_tpu_torch.parallel.mesh import all_gather
from neural_marionette_tpu_torch.train import (create_train_state,
                                               make_train_step)

port, rank, world, data, model, job_path = sys.argv[1:7]
rank, world = int(rank), int(world)
initialize(f"localhost:{port}", world, rank, device="cpu")
mesh = make_mesh(int(data), int(model))
warmup_collectives(mesh)
job = torch.load(job_path, weights_only=False)
me = torch.tensor([float(rank)])
res = {"data_group": all_gather(me, mesh.data_group).tolist(),
       "model_group": all_gather(me, mesh.model_group).tolist()}
for name, case in job["steps"].items():
    cfg = MarionetteConfig(**case["cfg"])
    net = NeuralMarionette(cfg)
    net.load_state_dict(job["state_dict"])
    state = create_train_state(cfg, net, torch.Generator().manual_seed(7))
    step = make_train_step(net, cfg, case["weights"], *case["flags"],
                           mesh=mesh)
    sk = (None if case["skeleton"] is None
          else SkeletonArrays.from_skeleton(case["skeleton"]))
    local = shard_batch(mesh, job["points"], microbatches=cfg.grad_accum)
    metrics = step(state, local, sk, eps=case["eps"])
    res[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                 "params": {k: v.detach().clone()
                            for k, v in net.named_parameters()},
                 "mu": dict(zip(state.optimizer.names, state.optimizer.mu)),
                 "generator": state.generator.get_state()}
for ci, case in job["forwards"].items():
    net = NeuralMarionette(MarionetteConfig(**case["cfg"]))
    net.load_state_dict(case["state_dict"])
    with torch.no_grad():
        out = net.kypt_detector(shard_batch(mesh, job["voxels"]), mesh=mesh)
    res[f"forward{ci}"] = out["keypoints"]
torch.save(res, f"{job_path}.{rank}")
shutdown()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(job_path, data, model):
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    port, world = _free_port(), data * model
    return [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(port), str(r), str(world),
         str(data), str(model), str(job_path)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _jax_eps(model, params, jcfg):
    """The noise of the JAX step (one microbatch) from ``params`` (its
    state's key, as ``make_train_step`` splits it), cut into the port's
    ``ACCUM`` microbatches, each (T, 10, B/2, Z)."""
    rng = jax_state(jcfg, params, jax.random.PRNGKey(3)).rng
    full = torch.from_numpy(jax_sample_eps(
        model, params, jax.random.split(rng, 3)[1], jcfg.Ttot, 10, B,
        jcfg.nlatent_kypt))
    return list(full.chunk(ACCUM, dim=2))


def _port_step(cfg, state_dict, weights, flags, pts, skeleton, eps):
    net = NeuralMarionette(cfg)
    net.load_state_dict(state_dict)
    state = create_train_state(cfg, net, torch.Generator().manual_seed(7))
    metrics = make_train_step(net, cfg, weights, *flags)(
        state, torch.from_numpy(pts),
        None if skeleton is None else SkeletonArrays.from_skeleton(skeleton),
        eps=eps)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: v.detach().clone()
                       for k, v in net.named_parameters()},
            "mu": dict(zip(state.optimizer.names, state.optimizer.mu)),
            "generator": state.generator.get_state()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX steps, the one-process port steps and the three process
    groups' results (every rank's), on the same parameters and batch. The
    process groups run while this process compiles the JAX steps."""
    tmp = tmp_path_factory.mktemp("parallel")
    jcfg, cfg = configs(**PHASES["detector"][0])
    model, params = jax_params(jcfg, seed=0)
    state_dict = state_dict_from_jax(params)
    vox, pts = moving_vox(B=B, T=jcfg.Ttot, G=jcfg.grid_size, seed=4)
    aff = np.asarray(model.apply(
        params, method=lambda m: m.kypt_detector.get_affinity()))
    job = {"state_dict": state_dict, "points": torch.from_numpy(pts),
           "voxels": torch.from_numpy(vox), "steps": {}, "forwards": {}}
    cases = {}
    for name in STEPS:
        phase = "detector" if name == "detector" else "learner"
        fields, flags = PHASES[phase]
        extra = {"affinity_ver": 4} if name == "learner_aff4" else {}
        jc, c = configs(**fields, **extra)
        c = dataclasses.replace(c, grad_accum=ACCUM)
        sched = LossScheduler(c)
        sched.anneal(0)
        eps = _jax_eps(model, params, jc) if name == "learner" else None
        job["steps"][name] = dict(
            cfg=dataclasses.asdict(c), weights=sched.active_weights(),
            flags=flags, skeleton=extract_skeleton(aff) if flags[1] else None,
            eps=eps)
        cases[name] = (jc, c)
    forward_params = {}
    for ci in FORWARDS:
        jc, c = configs(const_intensity=ci)
        _, forward_params[ci] = jax_params(jc, seed=ci)
        job["forwards"][ci] = dict(
            cfg=dataclasses.asdict(c),
            state_dict=state_dict_from_jax(forward_params[ci]))
    procs = {}
    for topo, (data, mdl) in TOPOLOGIES.items():
        path = tmp / f"{topo}.pt"
        torch.save(job, path)
        procs[topo] = _launch(path, data, mdl)

    jax_runs, one, jax_keypoints = {}, {}, {}
    for name, (jc, c) in cases.items():
        case = job["steps"][name]
        one[name] = _port_step(c, state_dict, case["weights"], case["flags"],
                               pts, case["skeleton"], case["eps"])
        if name == "learner_aff4":
            continue
        jsched = JaxScheduler(jc)
        jsched.anneal(0)
        assert jsched.active_weights() == case["weights"]
        jsk = (JaxSkeletonArrays.from_skeleton(jax_skeleton(aff))
               if case["flags"][1] else None)
        step = jax_train_step(model, jc, case["weights"], *case["flags"],
                              mesh=None, donate=False)
        jstate, jm = step(jax_state(jc, params, jax.random.PRNGKey(3)),
                          jnp.asarray(pts), jsk)
        jax_runs[name] = dict(jcfg=jc, jstate=jstate,
                              jmetrics=[_numpy_tree(jm)])
    for ci in FORWARDS:
        det = JaxDetector(configs(const_intensity=ci)[0])
        jax_keypoints[ci] = np.asarray(jax.jit(
            lambda p, v: det.apply(p, v)["keypoints"])(
            {"params": forward_params[ci]["params"]["kypt_detector"]},
            jnp.asarray(vox)))

    results = {}
    for topo, group in procs.items():
        outs = [p.communicate(timeout=600)[0] for p in group]
        for r, (p, out) in enumerate(zip(group, outs)):
            assert p.returncode == 0, f"{topo} rank {r}:\n{out[-3000:]}"
        results[topo] = [torch.load(f"{tmp / topo}.pt.{r}",
                                    weights_only=False)
                         for r in range(len(group))]
    return dict(one=one, jax=jax_runs, results=results, job=job,
                jax_keypoints=jax_keypoints)


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_process_groups_are_the_mesh_columns_and_rows(runs, topo):
    data, model = TOPOLOGIES[topo]
    ranks = np.arange(data * model).reshape(data, model)
    for r, res in enumerate(runs["results"][topo]):
        assert res["data_group"] == ranks[:, r % model].tolist()
        assert res["model_group"] == ranks[r // model].tolist()


def _close_to_one_process(got, want, lr):
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    err2 = ref2 = 0.0
    for k, b in want["mu"].items():
        a = got["mu"][k]
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-3 * scale + 1e-12, k
        err2 += float(((a - b).double() ** 2).sum())
        ref2 += float((b.double() ** 2).sum())
    assert ref2 > 0 and np.sqrt(err2 / ref2) < 1e-4, np.sqrt(err2 / ref2)
    total = loose = 0
    for k, b in want["params"].items():
        d = (got["params"][k] - b).abs()
        assert float(d.max()) <= 2 * lr + 1e-6, (k, float(d.max()))
        loose += int((d > 5e-5 + 1e-2 * b.abs()).sum())
        total += d.numel()
    assert loose <= total // 1000, (loose, total)
    assert torch.equal(got["generator"], want["generator"])


@pytest.mark.parametrize("name", STEPS)
@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_step_equals_the_one_process_step(runs, topo, name):
    """Every rank: metrics, gradients (Adam's first moment), parameters and
    generator state against the one-process port step on the global batch;
    every rank's parameters equal to the bit to rank 0's."""
    ranks = runs["results"][topo]
    lr = runs["job"]["steps"][name]["cfg"]["lrate"]
    for res in ranks:
        _close_to_one_process(res[name], runs["one"][name], lr)
        for k, v in res[name]["params"].items():
            assert torch.equal(v, ranks[0][name]["params"][k]), k
    if name != "detector":
        assert ranks[0][name]["metrics"]["kypt_recon_loss"] > 0


@pytest.mark.parametrize("name", ("detector", "learner"))
@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_step_matches_jax(runs, topo, name):
    """Rank 0's step against the JAX ``make_train_step`` (one device, the
    global batch as one microbatch), with the tolerances of
    ``tests/test_torch_train_step.py``."""
    res = runs["results"][topo][0][name]
    jrun = runs["jax"][name]
    opt = types.SimpleNamespace(names=list(res["mu"]),
                                mu=list(res["mu"].values()))
    params = res["params"]
    run = dict(jrun, pmetrics=[{k: torch.tensor(v, dtype=torch.float32)
                                for k, v in res["metrics"].items()}],
               pstate=types.SimpleNamespace(
                   optimizer=opt,
                   model=types.SimpleNamespace(
                       named_parameters=lambda: params.items())))
    _check_metrics(run)
    _check_gradients(run, prefix="dyna_module." if name == "learner"
                     else None)
    _check_params(run)


@pytest.mark.parametrize("ci", FORWARDS)
@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_frame_axis_forward_matches_jax(runs, topo, ci):
    """Each rank's keypoints (its rows, every frame) against the JAX
    detector's on the global batch: 1e-4, as the JAX package's own
    model-axis check."""
    data, model = TOPOLOGIES[topo]
    want = runs["jax_keypoints"][ci]
    for r, res in enumerate(runs["results"][topo]):
        rows = local_rows(B, data, r // model)
        np.testing.assert_allclose(res[f"forward{ci}"].numpy(), want[rows],
                                   rtol=1e-4, atol=1e-4)
