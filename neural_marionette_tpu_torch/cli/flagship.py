"""Flagship two-phase training schedule of the port, end to end.

    python -m neural_marionette_tpu_torch.cli.flagship [--nepoch 160] \\
        [--sequences 256] [--root output/flagship_torch] [--smoke]

The counterpart of the JAX package's ``scripts/run_flagship.py``, with its
phases, flags, training IDs and summary, over the port's ``cli.train`` and
``cli.vis_*``: a detector phase (``--pretrained_mode 0``, T 10, Tcond 3,
``grad_accum`` 2, lr 4e-4 staged at epochs 60 and 140) to a trained
affinity; its last epoch exported to
``<root>/pretrained/detector/synthetic_detector``, where
``Trainer.load_pretrained_detector`` reads it (``--pretrained_dir``); a
dynamics phase (``--pretrained_mode 1``, T 20, Tcond 5, ``grad_accum`` 4,
constant lr) from that detector; then the three demo CLIs from the dynamics
phase's last checkpoint, on a synthetic source clip and a static target.
Both phases run the synthetic articulated-chain dataset at the flagship
AIST++ shapes (K 24, grid 64, B 24, bfloat16).

Each phase and demo is a subprocess (``python -m
neural_marionette_tpu_torch.cli.<name>``) with its log under ``<root>``;
one that fails prints its log's tail and ends the run with a nonzero exit.
A re-run resumes each phase from its last saved epoch (``--save_every
1``, ``cli.train``'s resume). Everything lands under ``--root``:
``output/<training id>/<exp_name>/`` per phase, ``pretrained/``,
``demo/`` and ``flagship_summary.json`` (the JAX summary's keys, the
card's name and power limit, and per phase the epochs' step p50, peak
memory and kernel launches that ``cli.train`` prints, with the model-FLOPs
utilisation of ``utils.flops``).

It runs on the card and exits nonzero without one, unless ``--smoke``:
the JAX script's CPU rehearsal (grid 32, feat 32, B 4, 2 epochs, 8
sequences, ``--platform cpu``, ``--num_workers 0``, ``--sample_num 64``
for the interpolation).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

from . import platform_device

# the directory that holds the package: the subprocesses' cwd and path
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PHASE1_ID = "rl_setup/disc_training/synthetic/affinity_params/24kypt"
PHASE2_ID = ("rl_setup/dyna_training/synthetic/dl/HSVRNNBVH/24kypt/"
             "128zkypt_512hkypt")

COMMON = [
    "--dataset", "synthetic", "--apply_adjust_config", "0",
    "--nkeypoints", "24", "--grid_size", "64",
    "--sample_rate", "2", "--random_crop", "1", "--is_eval", "1",
    "--lrate", "4e-4", "--nbatch", "24", "--compute_dtype", "bfloat16",
    "--log_gif_num", "4", "--save_every", "1", "--seed", "0",
]


def common_flags(smoke: bool) -> list[str]:
    """:data:`COMMON`, or with ``smoke`` the JAX script's CPU rehearsal
    sizes (grid 32, B 4, feat 32, the CPU, no loader threads)."""
    flags = list(COMMON)
    if smoke:
        flags[flags.index("--grid_size") + 1] = "32"
        flags[flags.index("--nbatch") + 1] = "4"
        flags += ["--feat_dim", "32", "--platform", "cpu",
                  "--num_workers", "0"]
    return flags


def phase1_flags(nepoch: int) -> list[str]:
    """The detector phase (reference disc_training)."""
    return ["--pretrained_mode", "0",
            "--Ttot", "10", "--Tcond", "3",
            "--nepoch", str(nepoch),
            "--firstdecay", "60", "--seconddecay", "140",
            "--grad_accum", "2", "--remat", "0",
            "--log_gif_every", "25"]


def phase2_flags(nepoch: int) -> list[str]:
    """The dynamics phase from the exported detector. The reference pins the
    lr in dynamics training (dataset/config.py: firstdecay = seconddecay =
    1e10); a microbatch is 6 sequences x 20 frames = 120 folded frames."""
    return ["--pretrained_mode", "1",
            "--Ttot", "20", "--Tcond", "5",
            "--nepoch", str(nepoch),
            "--firstdecay", str(10**9),
            "--seconddecay", str(10**9),
            "--grad_accum", "4", "--remat", "0",
            "--log_gif_every", "25"]


def _run(cmd: list[str], log_path: str) -> tuple[int, float]:
    """``cmd`` from :data:`REPO` with the package on its path, its output
    to ``log_path``; (exit code, seconds). The caching allocator grows
    expandable segments unless the caller set ``PYTORCH_CUDA_ALLOC_CONF``:
    the dynamics phase's frozen detector forward peaks at 71 GiB allocated
    on an 80 GB card, and with fixed segments a 15 GiB GroupNorm buffer
    found no free block although 3.7 GiB lay reserved and unused."""
    env = dict(os.environ)
    env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    t0 = time.time()
    with open(log_path, "w") as log:
        rc = subprocess.call(cmd, cwd=REPO, env=env, stdout=log,
                             stderr=subprocess.STDOUT)
    return rc, time.time() - t0


def _fail(name: str, rc: int, dt: float, log_path: str):
    with open(log_path) as f:
        tail = f.readlines()[-40:]
    sys.stderr.write("".join(tail))
    raise SystemExit(f"{name} failed rc={rc} after {dt:.0f}s "
                     f"(log: {log_path})")


def run_phase(name: str, argv: list[str], log_path: str) -> float:
    """One ``cli.train`` run; its seconds. Exits on failure."""
    cmd = [sys.executable, "-m", "neural_marionette_tpu_torch.cli.train"] \
        + argv
    print(f"[flagship] {name}: {' '.join(cmd)}", flush=True)
    rc, dt = _run(cmd, log_path)
    if rc != 0:
        _fail(name, rc, dt, log_path)
    print(f"[flagship] {name} done in {dt / 60:.1f} min", flush=True)
    return dt


def run_demo(name: str, argv: list[str], log_path: str) -> float:
    """One ``cli.vis_<name>`` run; its seconds. Exits on failure."""
    cmd = [sys.executable, "-m",
           f"neural_marionette_tpu_torch.cli.vis_{name}"] + argv
    print(f"[flagship] demo {name}: {' '.join(cmd)}", flush=True)
    rc, dt = _run(cmd, log_path)
    if rc != 0:
        _fail(f"demo {name}", rc, dt, log_path)
    return dt


def latest_epoch_dir(logger_path: str) -> tuple[str, int]:
    root = os.path.join(logger_path, "epochs")
    epochs = sorted(int(d) for d in os.listdir(root) if d.isdigit())
    return os.path.join(root, str(epochs[-1])), epochs[-1]


def demo_clips(out_dir: str) -> tuple[str, str]:
    """The demos' inputs, written as the JAX script writes them: the source
    is the raw (unnormalised) points of the synthetic clip of seed 10000,
    long enough for the retarget demo's 40-frame window at sample_rate 2;
    the retarget target is a static shape (N, 3), the first frame of the
    clip of seed 10001 (reference vis_retarget semantics: a rest-pose
    mesh or scan). Returns (source path, target path)."""
    from ..config import MarionetteConfig
    from ..data.datasets import Synthetic
    os.makedirs(out_dir, exist_ok=True)
    cfg = MarionetteConfig(dataset="synthetic", nkeypoints=24)
    ds = Synthetic(train=False, options=cfg, n_sequences=2, seq_len=120)
    src = os.path.join(out_dir, "flagship_demo.npy")
    tgt = os.path.join(out_dir, "flagship_target.npy")
    pts, _ = ds._generate(10_000)
    np.save(src, pts.astype("float32"))
    target, _ = ds._generate(10_001)
    np.save(tgt, target[0].astype("float32"))
    return src, tgt


def card_line(platform: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``"cpu"``."""
    if platform == "cpu":
        return "cpu"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0].strip()


_STATS = re.compile(r"^epoch (\d+) stats (\{.*\})$")
_LAUNCHES = re.compile(r"^kernel launches (\{.*\})$")


def phase_stats(log_path: str) -> dict:
    """The per-epoch ``stats`` lines and the ``kernel launches`` line that
    ``cli.train`` printed into a phase's log."""
    epochs, launches = {}, None
    with open(log_path) as f:
        for line in f:
            m = _STATS.match(line.strip())
            if m:
                epochs[int(m.group(1))] = json.loads(m.group(2))
            m = _LAUNCHES.match(line.strip())
            if m:
                launches = json.loads(m.group(1))
    return {"epochs": epochs, "launches": launches}


def model_flops_utilisation(argv: list[str], stats: dict,
                            train: bool) -> dict:
    """The model FLOPs of a step of the phase's configuration
    (``utils.flops``: fwd + bwd in the detector phase, the forward alone in
    the dynamics phase, whose detector is frozen) and the share of the
    H100's dense bfloat16 peak at the last epoch's step p50."""
    from ..utils.flops import forward_flops, mfu, train_step_flops
    from .train import parse_args
    cfg, _ = parse_args(argv)
    flops = (train_step_flops if train else forward_flops)(cfg, cfg.nbatch)
    out = {"flops_per_step": flops, "counted": "fwd+bwd" if train
           else "forward (frozen detector)"}
    if stats["epochs"]:
        p50 = stats["epochs"][max(stats["epochs"])]["step_ms_p50"]
        if p50:
            out["mfu"] = mfu(flops, p50 / 1e3)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--nepoch", type=int, default=160)
    ap.add_argument("--sequences", type=int, default=256)
    ap.add_argument("--exp_name", type=str, default="flagship_torch")
    ap.add_argument("--root", type=str, default="output/flagship_torch",
                    help="directory of every output of the run")
    ap.add_argument("--skip_phase1", action="store_true")
    ap.add_argument("--skip_phase2", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CPU end-to-end rehearsal of the exact "
                         "orchestration path (grid 32, 2 epochs)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.smoke:
        args.nepoch, args.sequences = 2, 8
        args.exp_name += "_smoke"
    platform = "cpu" if args.smoke else ""
    platform_device(platform)     # raises without a card
    root = os.path.abspath(args.root)
    out = os.path.join(root, "output")
    os.makedirs(out, exist_ok=True)
    common = common_flags(args.smoke)
    where = ["--output_root", out,
             "--pretrained_dir", os.path.join(root, "pretrained")]
    summary = {"nepoch": args.nepoch, "sequences": args.sequences,
               "card": card_line(platform)}
    scale = ["--synthetic_sequences", str(args.sequences),
             "--synthetic_seq_len", "60",
             "--exp_name", args.exp_name]
    p1_logger = os.path.join(out, PHASE1_ID, args.exp_name)
    p2_logger = os.path.join(out, PHASE2_ID, args.exp_name)
    phases = {"phase1": common + scale + phase1_flags(args.nepoch) + where,
              "phase2": common + scale + phase2_flags(args.nepoch) + where}

    # ---- phase 1: detector training (reference disc_training)
    if not args.skip_phase1:
        summary["phase1_sec"] = run_phase(
            "phase1-detector", phases["phase1"],
            os.path.join(root, "flagship_phase1.log"))

    # ---- export the detector for pretrained_mode=1: the directory of the
    # port's checkpoints that Trainer.load_pretrained_detector reads
    src, ep = latest_epoch_dir(p1_logger)
    pre = os.path.join(root, "pretrained", "detector", "synthetic_detector",
                       "epochs", str(ep))
    if os.path.isdir(os.path.dirname(pre)):
        shutil.rmtree(os.path.dirname(pre))
    os.makedirs(os.path.dirname(pre), exist_ok=True)
    shutil.copytree(src, pre)
    summary["detector_epoch"] = ep
    print(f"[flagship] exported detector epoch {ep} -> {pre}", flush=True)

    # ---- phase 2: dynamics training from the pretrained detector
    if not args.skip_phase2:
        summary["phase2_sec"] = run_phase(
            "phase2-dynamics", phases["phase2"],
            os.path.join(root, "flagship_phase2.log"))

    src_clip, tgt_clip = demo_clips(os.path.join(root, "demo", "source"))

    # ---- the three demo CLIs from the final checkpoint
    plat = ["--platform", "cpu"] if args.smoke else []
    demo_out = os.path.join(root, "demo")
    demos = {
        "generation": ["--exp_dir", p2_logger, "--source_file", src_clip,
                       "--out_dir", os.path.join(demo_out, "generation")]
        + plat,
        "interpolation": ["--exp_dir", p2_logger, "--source_file", src_clip,
                          "--out_dir", os.path.join(demo_out,
                                                    "interpolation")]
        + plat + (["--sample_num", "64"] if args.smoke else []),
        "retarget": ["--exp_dir", p2_logger, "--source_file", src_clip,
                     "--target_file", tgt_clip,
                     "--out_dir", os.path.join(demo_out, "retarget")] + plat,
    }
    for name, demo_argv in demos.items():
        summary[f"demo_{name}_sec"] = run_demo(
            name, demo_argv, os.path.join(root, f"flagship_demo_{name}.log"))
        summary[f"demo_{name}"] = "ok"

    # ---- summary: final losses, semantic score, skeleton, and per phase
    # what cli.train printed (step p50, peak memory, kernel launches)
    for phase, logger in (("phase1", p1_logger), ("phase2", p2_logger)):
        mfile = os.path.join(logger, "metrics.jsonl")
        if os.path.exists(mfile):
            with open(mfile) as f:
                lines = [json.loads(ln) for ln in f if ln.strip()]
            if lines:
                summary[f"{phase}_final"] = lines[-1]
        sem = os.path.join(logger, "semantic_result.csv")
        if os.path.exists(sem):
            summary[f"{phase}_semantic_csv"] = sem
        log_path = os.path.join(root, f"flagship_{phase}.log")
        if f"{phase}_sec" in summary:
            stats = phase_stats(log_path)
            stats.update(model_flops_utilisation(
                phases[phase], stats, train=phase == "phase1"))
            summary[f"{phase}_stats"] = stats
    _, ep2 = latest_epoch_dir(p2_logger)
    meta = os.path.join(p2_logger, "epochs", str(ep2), "meta.json")
    with open(meta) as f:
        summary["skeleton_parents"] = json.load(f).get(
            "skeleton", {}).get("parents")

    with open(os.path.join(root, "flagship_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
