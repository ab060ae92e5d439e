"""The port's training CLI and demo CLIs on the CPU (``--platform cpu``),
on a miniature AIST++ tree (``tests/test_real_layout._write_aist_tree``
plus a ``gt_affinity.npy``): two epochs across the detector -> learner
switch, the files the JAX ``train.py`` writes with its record keys and the
GIFs of every epoch (``gifs/<epoch>/``: the tracked keypoints and recon,
and the generated ones in the learner epochs, decoded by Pillow with their
frame count, size and 150 ms delay), a resume that starts at the next
epoch, the three ``cli/vis_*`` writing their ``.npy`` outputs and renders
from the training run's directory, and, without a card and without
``--platform cpu``, a nonzero exit. About 70 s on one core (three
training processes).
"""
import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from neural_marionette_tpu_torch.cli import (vis_generation,
                                             vis_interpolation, vis_retarget)

from test_real_layout import K_GT, _write_aist_tree

REPO = Path(__file__).resolve().parents[1]
TRAIN = [sys.executable, "-m", "neural_marionette_tpu_torch.cli.train"]
FLAGS = ["--dataset", "aist", "--apply_adjust_config", "0",
         "--grid_size", "32", "--feat_dim", "32", "--nkeypoints", "6",
         "--Ttot", "4", "--Tcond", "2", "--sample_rate", "2", "--nbatch", "2",
         "--n_points", "256", "--num_workers", "2", "--nlatent_kypt", "16",
         "--nhidden_kypt", "32", "--is_eval", "1",
         "--eval_voxel_chamfer", "1", "--save_every", "1",
         "--detector_start", "0", "--detector_end", "1",
         "--learner_start", "1", "--affinity_anneal", "0"]
JAX_RECORD_KEYS = {"epoch", "lr", "time", "train", "valid"}


def _run(args, timeout=600, **env):
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1", **env)
    return subprocess.run(TRAIN + args, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two epochs, then a resume to a third; returns the experiment
    directory and the two processes' results."""
    tmp = tmp_path_factory.mktemp("cli")
    data, out = tmp / "data", tmp / "out"
    base = _write_aist_tree(str(data), n_train=4, n_test=2)
    aff = np.eye(K_GT, k=1, dtype=np.float32)
    np.save(os.path.join(base, "gt_affinity.npy"), aff + aff.T)
    common = FLAGS + ["--platform", "cpu", "--data_root", str(data),
                      "--output_root", str(out), "--exp_name", "v"]
    first = _run(common + ["--nepoch", "2", "--profile_dir",
                           str(tmp / "prof")])
    assert first.returncode == 0, first.stderr[-3000:]
    second = _run(common + ["--nepoch", "3"])
    assert second.returncode == 0, second.stderr[-3000:]
    exp = out / "rl_setup/disc_training/aist/affinity_params/6kypt/v"
    return dict(exp=exp, first=first, second=second, prof=tmp / "prof")


def test_two_epochs_across_the_phase_switch_write_train_py_files(run):
    exp = run["exp"]
    for name in ("opt.json", "metrics.jsonl", "semantic_result.csv",
                 "chamfer_result.csv", "affinity_result.json"):
        assert (exp / name).is_file(), name
    assert sorted(os.listdir(exp / "epochs")) == ["0", "1", "2"]
    opt = json.loads((exp / "opt.json").read_text())
    assert opt["training_id"] == "rl_setup/disc_training/aist/" \
        "affinity_params/6kypt" and opt["nepoch"] == 3
    records = [json.loads(ln) for ln in
               (exp / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1, 2]
    for r in records:
        assert set(r) == JAX_RECORD_KEYS
        assert {"semantic", "voxel_chamfer", "total_loss"} <= set(r["valid"])
        for part in ("train", "valid"):
            assert all(np.isfinite(v) for v in r[part].values()), r
    # epoch 0 trains the detector, epochs 1-2 the learner
    for r, learner in zip(records, (False, True, True)):
        assert (r["train"]["kypt_recon_loss"] > 0) == learner
        assert (r["train"]["kl_kypt"] > 0) == learner
    meta = json.loads((exp / "epochs/1/meta.json").read_text())
    assert meta["epoch"] == 1 and "skeleton" in meta
    with open(exp / "semantic_result.csv") as f:
        hist = np.array([[float(v) for v in row] for row in csv.reader(f)])
    assert hist.shape == (K_GT, 6) and np.allclose(hist.sum(1), 1.0)
    chamfer = np.loadtxt(exp / "chamfer_result.csv", delimiter=",")
    assert chamfer.shape == () and np.isfinite(chamfer)   # the resumed run's
    rec = json.loads((exp / "affinity_result.json").read_text())
    assert set(rec) == {"recovered", "collapsed", "gt_edges", "recovery"}
    assert rec["gt_edges"] == K_GT - 1
    assert list(run["prof"].glob("trace_epoch1.json"))
    # the GIFs of every epoch (log_gif_every 1), two videos each (nbatch 2)
    T = 4
    for epoch, learner in ((0, False), (1, True), (2, True)):
        names = {f"{grp}_{what}_{i}.gif" for grp in
                 (("track", "gen") if learner else ("track",))
                 for what in ("keypoints", "recon") for i in range(2)}
        gif_dir = exp / "gifs" / str(epoch)
        assert set(os.listdir(gif_dir)) == names, epoch
        for name in names:
            im = Image.open(gif_dir / name)
            assert im.n_frames == T and im.info["duration"] == 150
            assert im.size == ((384 if "recon" in name else 192), 192)
    for proc, epochs in ((run["first"], (0, 1)), (run["second"], (2,))):
        for epoch in epochs:
            assert f"epoch {epoch}: GIF logging" in proc.stdout


def test_resume_starts_at_the_next_epoch(run):
    assert "resumed from epoch 1" in run["second"].stdout
    assert "resumed" not in run["first"].stdout
    assert run["second"].stdout.count("total loss") == 1


@pytest.mark.parametrize("cli,outputs,renders,args", [
    (vis_generation, ["gen_voxels.npy", "keypoints.npy", "parents.npy"],
     ["gen_result_0.gif", "gen_result_1.gif", "gen_result_imgs_0/05.png",
      "gifs/0/generation_keypoints_1.gif", "gifs/0/generation_recon_1.gif"],
     ["--Tcond", "3", "--Tgen", "3", "--sample_num", "2"]),
    (vis_interpolation, ["interp_voxels.npy", "keypoints.npy"],
     ["interp_result_0.gif", "interp_result_imgs_0/06.png",
      "gifs/0/interpolation_keypoints_0.gif",
      "gifs/0/interpolation_recon_0.gif"],
     ["--Ttot", "7", "--anchor_rate", "3", "--sample_num", "16"]),
    (vis_retarget, ["retargeted_points.npy", "retargeted_keypoints.npy",
                    "skin_weights.npy", "parents.npy"],
     ["source.gif", "source_imgs/03.png", "target.png", "target_skin.png",
      "smooth.gif", "skeleton.gif", "overlay_imgs/03.png"],
     ["--Ttot", "4"]),
])
def test_demo_clis_write_their_outputs(run, tmp_path, cli, outputs, renders,
                                       args):
    """From the training run's directory (its latest checkpoint and
    skeleton), with the synthetic fallbacks for the absent demo files: the
    ``.npy`` outputs and the renders (PNG sets at the reference camera,
    1025 x 958, and GIFs)."""
    out = tmp_path / "demo"
    assert cli.main(["--platform", "cpu", "--exp_dir", str(run["exp"]),
                     "--out_dir", str(out),
                     "--source_file", str(tmp_path / "absent.npy"),
                     *args]) == 0
    for name in outputs:
        arr = np.load(out / name)
        assert np.isfinite(arr).all(), name
    for name in renders:
        im = Image.open(out / name)
        if name.endswith(".png") and not name.startswith("gifs"):
            assert im.size == (1025, 958), name
    parents = json.loads((run["exp"] / "epochs/2/meta.json").read_text())[
        "skeleton"]["parents"]
    if "parents.npy" in outputs:
        assert np.load(out / "parents.npy").tolist() == parents


def test_without_a_card_it_exits_nonzero(tmp_path):
    res = _run(FLAGS + ["--data_root", str(tmp_path), "--output_root",
                        str(tmp_path), "--nepoch", "1"], timeout=300)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not (tmp_path / "rl_setup").exists()
