"""The readings that the correctness limits are set from, for one cell on
the card: the program's on many seeds (the lower reading), and on a few
seeds the control and the faults, each put in the program's place (the
upper reading): the reference in the precision below the configuration's
(``low``); in training, the reference whose loss and gradient take the
mean over half of each batch while every row runs forward (``half``); in
the dynamics phase and in serving, the reference whose frozen keypoints
are moved by one voxel where they are made (``shift``); in serving, the
reference that keeps the VRNN's second-nearest sample (``pick``).

    python3 -m benchmark.calibrate --workload <name> --seeds <n> \\
        [--controls <n>] [--faults <label> ...] [--seconds <s>] \\
        [--seed-list <n> ...] [--out <file.jsonl>]

One JSON line per seed; the benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from .registry import Registry
from .run import execute


def faults(label: str, fields: dict) -> dict:
    """The keywords of the control or fault ``label`` for the driver."""
    return {"low": {"prec": "low"}, "half": {"keep_rows": 0.5},
            "shift": {"shift": 2.0 / fields["grid_size"]},
            "pick": {"rank": 1}}[label]


DEFAULT_FAULTS = {"train_loop": ["low", "half"],
                  "stream_closed": ["low", "pick", "shift"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", nargs="*", default=None,
                    help="labels read on the --controls seeds (default: "
                    "low half in training, low pick shift in serving)")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seed-list", type=int, nargs="*", default=[],
                    help="seeds read before the generated ones")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    reg = Registry()
    cell = reg.cell(args.workload)
    driver = reg.traffic(cell["traffic"])["driver"]
    fields = reg.config(cell["config"])["model"]
    labels = DEFAULT_FAULTS[driver] if args.faults is None else args.faults
    out = open(args.out, "a") if args.out else sys.stdout
    seeds = args.seed_list + [args.first_seed + 7919 * i
                              for i in range(args.seeds)]
    for i, seed in enumerate(seeds):
        controls = {}
        if i >= len(args.seed_list) and \
                i - len(args.seed_list) < args.controls:
            controls = {label: faults(label, fields) for label in labels}
        res = execute(reg, args.workload, seed, args.seconds, False,
                      torch.device("cuda", 0), os.environ.get("TMPDIR"),
                      controls=controls)
        line = {"seed": seed, "correct": res["correct"],
                "program": res["_readings"],
                "controls": res["_controls"],
                "metrics": {k: v["value"] for k, v in
                            res["metrics"].items()},
                "detail": res["_detail"]}
        print(json.dumps(line), file=out, flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
