"""The port's flagship orchestrator (``cli.flagship``) on the CPU.

Against the JAX package's ``scripts/run_flagship.py``, loaded with
``importlib`` from its path and run with its training and demo processes
replaced by recorders (as the port's are here): ``COMMON``, the training
IDs, each phase's flags and the demos' flags equal, with and without
``--smoke``; both demo clips equal to the bit; the summary's keys. Then
``cli.flagship --smoke --root <tmp>`` end to end in a subprocess: both
phases' files, the export, the dynamics phase loading it and keeping it
frozen, the three demos' outputs and the summary; and a second invocation
with ``--skip_phase1`` (the dynamics phase resumes at its end, the demos
recorded, as the first run ran them).

The JAX ``--smoke`` is not run: it spends minutes in XLA compiles. The
steps it would drive are held against JAX by tests/test_torch_train_step.py
and tests/test_torch_pretrained.py. About 3.6 min on the CPU, of which
the end-to-end run takes ~190 s on one thread: two training processes
and three demo processes, whose renders at 1025 x 958 take half of it.
"""
import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_marionette_tpu_torch.cli import flagship
from neural_marionette_tpu_torch.train.checkpoint import load_params_only

REPO = Path(__file__).resolve().parents[1]
JAX_SCRIPT = REPO / "scripts" / "run_flagship.py"
JAX_SUMMARY_KEYS = {
    "nepoch", "sequences", "phase1_sec", "detector_epoch", "phase2_sec",
    "demo_generation", "demo_interpolation", "demo_retarget",
    "phase1_final", "phase1_semantic_csv", "phase2_final",
    "phase2_semantic_csv", "skeleton_parents"}


def _load_jax_script():
    spec = importlib.util.spec_from_file_location("jax_run_flagship",
                                                  JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fake_phase_outputs(out, training_id, argv):
    """What a training run leaves for the orchestrator: the last epoch's
    checkpoint directory with its meta, a metrics line and the semantic
    CSV."""
    exp = argv[argv.index("--exp_name") + 1]
    last = int(argv[argv.index("--nepoch") + 1]) - 1
    logger = Path(out) / training_id / exp
    (logger / "epochs" / str(last)).mkdir(parents=True)
    (logger / "epochs" / str(last) / "meta.json").write_text(json.dumps(
        {"epoch": last, "skeleton": {"parents": [-1, 0]}}))
    (logger / "metrics.jsonl").write_text(json.dumps({"epoch": last}) + "\n")
    (logger / "semantic_result.csv").write_text("1\n")


def _run_jax(tmp, args, monkeypatch):
    """The JAX script's main() under ``tmp`` with its processes recorded:
    ([(name, COMMON, extra)], {demo: argv after the script}, summary)."""
    mod = _load_jax_script()
    mod.REPO = str(tmp)
    phases, demos = [], {}

    def run_phase(name, extra, log_path):
        phases.append((name, list(mod.COMMON), list(extra)))
        _fake_phase_outputs(os.path.join(mod.REPO, "output"),
                            mod.PHASE1_ID if "1" in name else mod.PHASE2_ID,
                            extra)
        return 1.0

    def call(cmd, **kw):
        demos[cmd[1].split("_")[1][:-3]] = cmd[2:]
        return 0

    mod.run_phase = run_phase
    mod.subprocess = types.SimpleNamespace(call=call,
                                           STDOUT=subprocess.STDOUT)
    monkeypatch.setattr(sys, "argv", ["run_flagship.py"] + args)
    mod.main()
    summary = json.loads((tmp / "output" / "flagship_summary.json")
                         .read_text())
    return phases, demos, summary


def _run_port(tmp, args, monkeypatch):
    """The port's main() under ``tmp`` with its processes recorded."""
    phases, demos = [], {}

    def run_phase(name, argv, log_path):
        phases.append((name, list(argv)))
        Path(log_path).write_text("")
        out = argv[argv.index("--output_root") + 1]
        _fake_phase_outputs(out, flagship.PHASE1_ID if "1" in name
                            else flagship.PHASE2_ID, argv)
        return 1.0

    def run_demo(name, argv, log_path):
        demos[name] = list(argv)
        return 1.0

    monkeypatch.setattr(flagship, "run_phase", run_phase)
    monkeypatch.setattr(flagship, "run_demo", run_demo)
    monkeypatch.setattr(flagship, "platform_device", lambda p: None)
    monkeypatch.setattr(flagship, "card_line", lambda p: "a card, 700 W")
    assert flagship.main(args + ["--root", str(tmp)]) == 0
    return phases, demos, json.loads((tmp / "flagship_summary.json")
                                     .read_text())


def _flag_values(argv, paths=("--exp_dir", "--source_file", "--target_file",
                              "--out_dir")):
    """The flags of a demo's argv, path values reduced to their last
    parts."""
    out = []
    for flag, value in zip(argv[::2], argv[1::2]):
        if flag in paths:
            value = os.path.basename(value)
        out.append((flag, value))
    return out


@pytest.mark.parametrize("args", [[], ["--smoke"],
                                  ["--nepoch", "7", "--sequences", "33"]])
def test_flags_ids_clips_and_summary_equal_the_jax_script(tmp_path, args,
                                                          monkeypatch):
    jax_mod = _load_jax_script()
    assert flagship.COMMON == jax_mod.COMMON
    assert (flagship.PHASE1_ID, flagship.PHASE2_ID) == \
        (jax_mod.PHASE1_ID, jax_mod.PHASE2_ID)
    args = args + ["--exp_name", "x"]
    jphases, jdemos, jsum = _run_jax(tmp_path / "jax", args, monkeypatch)
    pphases, pdemos, psum = _run_port(tmp_path / "port", args, monkeypatch)
    root = tmp_path / "port"
    where = ["--output_root", str(root / "output"),
             "--pretrained_dir", str(root / "pretrained")]
    assert [n for n, *_ in jphases] == [n for n, _ in pphases] == \
        ["phase1-detector", "phase2-dynamics"]
    for (_, common, extra), (_, argv) in zip(jphases, pphases):
        assert argv == common + extra + where
    if "--smoke" in args:
        assert "--platform" in jphases[0][1]
    # the export, where Trainer.load_pretrained_detector reads it
    ep = psum["detector_epoch"]
    assert ep == jsum["detector_epoch"]
    assert (root / "pretrained" / "detector" / "synthetic_detector" /
            "epochs" / str(ep) / "meta.json").is_file()
    assert list(jdemos) == list(pdemos) == ["generation", "interpolation",
                                            "retarget"]
    for name in jdemos:
        assert _flag_values(jdemos[name]) == _flag_values(pdemos[name])
        assert pdemos[name][pdemos[name].index("--out_dir") + 1] == \
            str(root / "demo" / name)
    for clip in ("flagship_demo.npy", "flagship_target.npy"):
        a = np.load(root / "demo" / "source" / clip)
        b = np.load(tmp_path / "jax" / "data" / "demo" / "source" / clip)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert set(jsum) == JAX_SUMMARY_KEYS
    assert JAX_SUMMARY_KEYS <= set(psum) and psum["card"] == "a card, 700 W"
    for k in ("nepoch", "sequences", "detector_epoch", "skeleton_parents",
              "phase1_final", "phase2_final"):
        assert psum[k] == jsum[k], k


# one thread per process, as the suite's other workers run
# (tests/_torch_port.py), so that the processes of the --smoke run do not
# take the CPU from them
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    root = tmp_path_factory.mktemp("flagship")
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="",
               **ONE_THREAD)
    res = subprocess.run([sys.executable, "-m",
                          "neural_marionette_tpu_torch.cli.flagship",
                          "--smoke", "--root", str(root)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=900)
    return root, res


def test_smoke_end_to_end(smoke):
    root, res = smoke
    assert res.returncode == 0, res.stderr[-3000:] + res.stdout[-3000:]
    summary = json.loads((root / "flagship_summary.json").read_text())
    assert JAX_SUMMARY_KEYS <= set(summary) and summary["card"] == "cpu"
    assert summary["nepoch"] == 2 and summary["sequences"] == 8
    exp = "flagship_torch_smoke"
    p1 = root / "output" / flagship.PHASE1_ID / exp
    p2 = root / "output" / flagship.PHASE2_ID / exp
    for logger, learner in ((p1, False), (p2, True)):
        for name in ("opt.json", "metrics.jsonl", "semantic_result.csv"):
            assert (logger / name).is_file(), (logger, name)
        assert sorted(os.listdir(logger / "epochs")) == ["0", "1"]
        records = [json.loads(ln) for ln in
                   (logger / "metrics.jsonl").read_text().splitlines()]
        assert [r["epoch"] for r in records] == [0, 1]
        for r in records:
            assert all(np.isfinite(v) for p in ("train", "valid")
                       for v in r[p].values()), r
            assert (r["train"]["kypt_recon_loss"] > 0) == learner
        opt = json.loads((logger / "opt.json").read_text())
        assert opt["pretrained_mode"] == int(learner)
        assert opt["grid_size"] == 32 and opt["feat_dim"] == 32
        assert opt["grad_accum"] == (4 if learner else 2)
    assert summary["phase1_final"]["epoch"] == 1
    assert summary["phase2_final"]["epoch"] == 1
    assert summary["detector_epoch"] == 1
    # the export, loaded by the dynamics phase and kept frozen there
    exported, _, _ = load_params_only(
        str(root / "pretrained" / "detector" / "synthetic_detector"))
    last1, _, _ = load_params_only(str(p1))
    log2 = (root / "flagship_phase2.log").read_text()
    assert "loaded the pretrained detector of " + str(root / "pretrained") \
        in log2
    for epoch in (0, 1):
        state2, skeleton, _ = load_params_only(str(p2), epoch)
        assert skeleton is not None
        for k, v in exported.items():
            if k.startswith("kypt_detector."):
                assert torch.equal(v, last1[k]) and torch.equal(v, state2[k])
    assert summary["skeleton_parents"] == skeleton.parents.tolist()
    # what cli.train printed: two epochs a phase, no kernel on the CPU
    for phase in ("phase1", "phase2"):
        stats = summary[f"{phase}_stats"]
        assert sorted(stats["epochs"]) == ["0", "1"]
        assert all(e["steps"] == 2 and e["step_ms_p50"] > 0
                   and e["peak_gib"] is None
                   for e in stats["epochs"].values())
        assert set(stats["launches"].values()) == {0}
        assert stats["flops_per_step"] > 0 and stats["mfu"] > 0
    demos = {"generation": {"gen_voxels.npy": (3, 30, 32, 32, 32, 1),
                            "keypoints.npy": (3, 30, 24, 4)},
             "interpolation": {"interp_voxels.npy": (21, 32, 32, 32, 1),
                               "keypoints.npy": (21, 24, 4)},
             "retarget": {"retargeted_points.npy": (40, 2064, 3),
                          "retargeted_keypoints.npy": (40, 24, 4)}}
    for name, want in demos.items():
        assert summary[f"demo_{name}"] == "ok"
        for fname, shape in want.items():
            arr = np.load(root / "demo" / name / fname)
            assert arr.shape == shape and np.isfinite(arr).all()
        assert list((root / "demo" / name).rglob("*.png"))
        assert list((root / "demo" / name).rglob("*.gif"))


def test_second_invocation_skips_phase1(smoke, monkeypatch):
    root, res = smoke
    assert res.returncode == 0
    demos = []
    monkeypatch.setattr(flagship, "run_demo",
                        lambda name, argv, log: demos.append(name) or 1.0)
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    for k, v in ONE_THREAD.items():
        monkeypatch.setenv(k, v)
    before = (root / "flagship_phase1.log").stat().st_mtime_ns
    assert flagship.main(["--smoke", "--skip_phase1", "--root",
                          str(root)]) == 0
    assert (root / "flagship_phase1.log").stat().st_mtime_ns == before
    assert "resumed from epoch 1" in \
        (root / "flagship_phase2.log").read_text()
    summary = json.loads((root / "flagship_summary.json").read_text())
    assert "phase1_sec" not in summary and summary["phase2_sec"] > 0
    assert summary["detector_epoch"] == 1
    assert summary["phase2_stats"]["epochs"] == {}
    assert demos == ["generation", "interpolation", "retarget"]


def test_without_a_card_it_exits_nonzero(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m",
                          "neural_marionette_tpu_torch.cli.flagship",
                          "--root", str(tmp_path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert not (tmp_path / "flagship_summary.json").exists()
