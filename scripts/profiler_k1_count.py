#!/usr/bin/env python3
"""How many of kernel K1's launches ``torch.profiler`` records, on one
NVIDIA GPU, in the ways ``chip_smoke.py`` profiles kernel calls, training
steps and serving windows, with and without an idle gap at the edges of
the recorded round (``chip_smoke.profiler_gap``).

    python3 scripts/profiler_k1_count.py [--repeats N]

K1 (``csrc/voxelize.cu``) runs once per call, step and window, so the
profiler should record exactly as many K1 operations as it records calls,
steps or windows. Each case runs ``--repeats`` times (default 5; the
kernel-call cases four times as often) at the AIST preset, bf16, B 4,
T 10, N 4096, once as ``<case>`` and once as ``<case>_gap``:

* ``k1_cold`` — ten K1 calls at the serving shape, the profiler started
  with them;
* ``k1_warm`` — ten calls in the profiler's warm-up round, then the ten
  it records (``chip_smoke.device_events``);
* ``learner_back_to_back`` — a learner-phase ``Trainer`` step in the
  profiler's warm-up round, then two steps recorded back to back (one
  synchronisation after both);
* ``learner_synchronised`` — the same, synchronised after each recorded
  step (``chip_smoke.phase_train``);
* ``stream_cold`` — four windows of a stream, the profiler started with
  them;
* ``stream_warm`` — one window of another stream in the warm-up round,
  then the four (``chip_smoke.phase_profile``).

Each repeat gives (K1 operations, all device operations, host
``cudaLaunchKernel`` records): where the profiler keeps a launch and drops
its kernel, the third outnumbers the kernels of a ``k1_*`` case. Prints the card's name and power limit, a
line per case, and last one JSON object ``{"profiler_k1_count": {...}}``.
Exits nonzero without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402


def _counts(prof):
    from torch.autograd import DeviceType
    ev = prof.events()
    dev = [e for e in ev if e.device_type == DeviceType.CUDA
           and not e.name.startswith("ProfilerStep")]
    launches = sum(e.device_type == DeviceType.CPU
                   and e.name.startswith("cudaLaunchKernel") for e in ev)
    return sum("voxelize_kernel" in e.name for e in dev), len(dev), launches


def _recorded(warm, record, gap):
    """Profile ``record()``: with ``warm``, after ``warm()`` in the
    profiler's warm-up round; with ``gap``, the recorded round opens and
    closes with ``chip_smoke.profiler_gap``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    kw = {} if warm is None else dict(
        schedule=schedule(wait=0, warmup=1, active=1))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **kw) as prof:
        if warm is not None:
            warm()
            torch.cuda.synchronize()
            prof.step()
        if gap:
            c.profiler_gap()
        record()
        torch.cuda.synchronize()
        if gap:
            c.profiler_gap()
    return _counts(prof)


def _cases(name, warm, record, repeats):
    return {f"{name}{tag}": [_recorded(warm, record, gap)
                             for _ in range(repeats)]
            for tag, gap in (("", False), ("_gap", True))}


def _k1(device, repeats):
    import torch
    from neural_marionette_tpu_torch.ops import voxelize as V
    pts = torch.from_numpy(c.serving_points(c.SERVE_B, c.SERVE_T, c.SERVE_N,
                                            seed=31)).to(device)

    def calls():
        for _ in range(10):
            V.voxelize(pts, 64, dtype=torch.bfloat16)

    return {**_cases("k1_cold", None, calls, repeats),
            **_cases("k1_warm", calls, calls, repeats)}


def _learner(cfg, device, repeats):
    import torch
    from neural_marionette_tpu_torch.train import Trainer
    trainer = Trainer(dataclasses.replace(
        cfg, detector_start=0, detector_end=0, learner_start=0,
        affinity_anneal=0), device=device, dtype="bfloat16")
    c._train_epoch(trainer, 0, 2, 100, {})   # extracts the skeleton
    step, sk = trainer.phase_step(), trainer.phase_skeleton()
    pts = [torch.from_numpy(c.serving_points(c.SERVE_B, c.SERVE_T,
                                             c.SERVE_N, seed=5000 + i))
           for i in range(3)]

    def warm():
        step(trainer.state, pts[0].to(device), sk)

    def steps(synchronised):
        def run():
            for p in pts[1:]:
                step(trainer.state, p.to(device), sk)
                if synchronised:
                    torch.cuda.synchronize()
        return run

    return {**_cases("learner_back_to_back", warm, steps(False), repeats),
            **_cases("learner_synchronised", warm, steps(True), repeats)}


def _stream(marionette, repeats):
    ws = [c.serving_points(c.SERVE_B, c.SERVE_T, c.SERVE_N, seed=200 + i)
          for i in range(4)]

    def windows(n):
        def run():
            stream = marionette.stream(dtype="bfloat16",
                                       sample_num=c.SAMPLE_NUM)
            for _ in stream.run(ws[:n]):
                pass
        return run

    return {**_cases("stream_cold", None, windows(4), repeats),
            **_cases("stream_warm", windows(1), windows(4), repeats)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profiler_k1_count: no CUDA device", file=sys.stderr)
        return 2
    from neural_marionette_tpu_torch import MarionetteConfig, adjust_config
    from neural_marionette_tpu_torch.api import Marionette
    card = c.phase_card()
    c.phase_build()
    device = torch.device("cuda")
    cfg = adjust_config(MarionetteConfig(dataset="aist"))
    res = {"card": card, "repeats": args.repeats,
           **_k1(device, 4 * args.repeats),
           **_learner(cfg, device, args.repeats)}
    torch.cuda.empty_cache()
    m = Marionette.from_config(cfg, seed=0, device=device)
    res.update(_stream(m, args.repeats))
    for k, v in res.items():
        if k not in ("card", "repeats"):
            c.log(f"[profiler_k1_count] {k}: (K1, device operations, "
                  f"launches) per repeat {v}")
    print(card)
    print(json.dumps({"profiler_k1_count": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
