"""The port's training CLI over two processes on the CPU (gloo over
``localhost``, one thread a process), on a miniature AIST++ tree
(``tests/test_real_layout._write_aist_tree``), the counterpart of
``tests/test_multihost.py::test_train_cli_two_processes_then_topology_change_resume``:

* ``cli.train`` with ``--num_processes 2 --mesh_data 2`` and
  ``--grad_accum 2`` for one epoch (the detector phase, with validation):
  one ``metrics.jsonl`` record, written by rank 0 alone, rank 0's
  ``opt.json`` and GIFs, an epoch-0 checkpoint, and both ranks to the end;
* its epoch 0 against a one-process run of the same command with
  ``--grad_accum 4`` (the loader's ``global_draws``: the same batches;
  every forward on one row, as each rank's microbatches): the two differ
  only in the order of their float32 sums (each rank's rows, then the
  ``all_reduce``), so every training loss agrees within 1e-4 relative
  plus 1e-6 absolute (the graph losses' near-zero terms are rounding
  noise of order-1 terms), ``grad_norm`` within 1e-3 (the bound of
  ``tests/test_torch_train_step.py``), and the epoch-0 checkpoint's
  parameters within 2 lr, all but 1/1000 within 5e-5 + 1e-2 |p| (that
  file's criterion). Validation runs four rows a forward in one process
  and two in each of two, and the detector's float32 outputs are
  ill-conditioned enough (its saturated recon, the trajectory loss's
  velocity cosines) that other batch sizes give other losses, so they
  are checked finite only;
* a resume of that checkpoint on one process for epoch 1 (the learner
  phase): ``resumed from epoch 0``, a second record, an epoch-1
  checkpoint.

About 50 s on one core (three training processes at once, then one).
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_marionette_tpu_torch.parallel.distributed import initialize

from test_real_layout import _write_aist_tree

REPO = Path(__file__).resolve().parents[1]
TRAIN = [sys.executable, "-m", "neural_marionette_tpu_torch.cli.train"]
FLAGS = ["--dataset", "aist", "--apply_adjust_config", "0",
         "--platform", "cpu", "--grid_size", "32", "--feat_dim", "32",
         "--nkeypoints", "6", "--Ttot", "4", "--Tcond", "2",
         "--sample_rate", "2", "--nbatch", "4", "--n_points", "256",
         "--num_workers", "2", "--nlatent_kypt", "16", "--nhidden_kypt",
         "32", "--is_eval", "1", "--eval_voxel_chamfer", "1",
         "--save_every", "1", "--detector_start", "0",
         "--detector_end", "1", "--learner_start", "1",
         "--affinity_anneal", "0", "--exp_name", "mp"]
EXP = "rl_setup/disc_training/aist/affinity_params/6kypt/mp"


def _popen(args):
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.Popen(TRAIN + args, cwd=REPO, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(proc, what):
    out = proc.communicate(timeout=600)[0]
    assert proc.returncode == 0, f"{what}:\n{out[-3000:]}"
    return out


def _records(exp):
    return [json.loads(ln) for ln in
            (exp / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp_cli")
    _write_aist_tree(str(tmp / "data"), n_train=4, n_test=4)
    common = FLAGS + ["--data_root", str(tmp / "data"), "--nepoch", "1"]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    two = common + ["--grad_accum", "2", "--output_root", str(tmp / "two"),
                    "--coordinator_address", f"localhost:{port}",
                    "--num_processes", "2", "--mesh_data", "2",
                    "--mesh_model", "1"]
    ranks = [_popen(two + ["--process_id", str(i)]) for i in range(2)]
    single = _popen(common + ["--grad_accum", "4",
                              "--output_root", str(tmp / "one")])
    outs = [_finish(p, f"rank {i}") for i, p in enumerate(ranks)]
    _finish(single, "one process")
    exp = tmp / "two" / EXP
    after_two = _records(exp)
    resume = _popen(FLAGS + ["--data_root", str(tmp / "data"),
                             "--grad_accum", "2",
                             "--output_root", str(tmp / "two"),
                             "--nepoch", "2"])
    resumed = _finish(resume, "resume")
    return dict(exp=exp, outs=outs, after_two=after_two, resumed=resumed,
                one=_records(tmp / "one" / EXP), one_exp=tmp / "one" / EXP)


def test_two_processes_log_and_checkpoint_on_rank_0(run):
    exp, outs = run["exp"], run["outs"]
    assert len(run["after_two"]) == 1 and run["after_two"][0]["epoch"] == 0
    for part in ("train", "valid"):
        assert all(np.isfinite(v) for v in run["after_two"][0][part].values())
    assert {"semantic", "voxel_chamfer"} <= set(run["after_two"][0]["valid"])
    assert (exp / "opt.json").is_file()
    assert (exp / "epochs" / "0" / "meta.json").is_file()
    assert sorted(os.listdir(exp / "gifs" / "0")) == sorted(
        f"track_{what}_{i}.gif" for what in ("keypoints", "recon")
        for i in range(4))
    for out in outs:
        assert "training complete" in out
    assert "epoch 0 stats" in outs[0] and "epoch 0 stats" not in outs[1]
    assert "GIF logging" not in outs[1]


def _epoch0_params(exp):
    return torch.load(exp / "epochs" / "0" / "state.pt", map_location="cpu",
                      weights_only=True)["model"]


def test_two_processes_equal_one_process(run):
    """The epoch-0 training losses and checkpoint of the two-process run
    against the one-process run's (module docstring)."""
    (two,), (one,) = run["after_two"], run["one"]
    assert set(two["valid"]) == set(one["valid"])
    assert set(two["train"]) == set(one["train"])
    for k, v in one["train"].items():
        tol = dict(rtol=1e-3) if k == "grad_norm" else dict(rtol=1e-4,
                                                            atol=1e-6)
        np.testing.assert_allclose(two["train"][k], v, err_msg=k, **tol)
    want = _epoch0_params(run["one_exp"])
    got = _epoch0_params(run["exp"])
    lr = one["lr"]
    total = loose = 0
    for k, b in want.items():
        d = (got[k] - b).abs()
        assert float(d.max()) <= 2 * lr + 1e-6, k
        loose += int((d > 5e-5 + 1e-2 * b.abs()).sum())
        total += d.numel()
    assert loose <= total // 1000, (loose, total)


def test_checkpoint_of_two_processes_resumes_on_one(run):
    assert "resumed from epoch 0" in run["resumed"]
    records = _records(run["exp"])
    assert [r["epoch"] for r in records] == [0, 1]
    assert records[1]["train"]["kypt_recon_loss"] > 0      # the learner
    assert all(np.isfinite(v) for v in records[1]["train"].values())
    assert sorted(os.listdir(run["exp"] / "epochs")) == ["0", "1"]


def test_several_processes_need_an_address():
    with pytest.raises(ValueError, match="coordinator_address"):
        initialize(None, 2, 0, device="cpu")
    with pytest.raises(ValueError, match="process_id 2 of 2"):
        initialize("localhost:1", 2, 2, device="cpu")
    assert initialize(None, 1, 0, device="cpu") is None
