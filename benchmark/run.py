"""Run one cell of the benchmark once and print its result.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; the mix names its driver (``drivers/<driver>.py``), which
sets the port up from the seed, runs the measured window (``--trace 0``:
the end-to-end metrics) or a traced window (``--trace 1``: the per-layer
metrics, each read by ``metrics/<metric>.py``), and then has what the
timed path produced judged against the plain reference (``check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``busy_s`` and
``window_s`` when traced), ``breakdown`` when traced, and last
``compared``: every number the check compared beside its limit, which the
last lines of standard error repeat. Without a CUDA card, or with a JAX
module loaded when the window has closed, the run prints no result and
exits with 2.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _seconds_since_start() -> float:
    """Seconds since this process started (``/proc``), or 0 where that
    cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_T_IMPORT = time.perf_counter()
_BEFORE_IMPORT = _seconds_since_start()

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
# the kernel caches of anything built in the run stay in the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

import torch  # noqa: E402

from . import check, trace  # noqa: E402
from .registry import Registry  # noqa: E402


class Context:
    """What a driver gets: the cell, its configuration's fields, its mix,
    the device, the seed, the window's length, whether it is traced, a
    directory for its data, the controls and faults to read beside the
    program (label -> the keywords of the driver's reference), and the
    set-up clock."""

    def __init__(self, cell, fields, mix, device, seed, seconds, traced,
                 tmp, controls=None):
        self.cell, self.fields, self.mix = cell, fields, mix
        self.device, self.seed, self.seconds = device, int(seed), seconds
        self.trace, self.tmp = traced, tmp
        self.controls = controls or {}
        self.setup_s = None

    def mark_setup_end(self):
        self.setup_s = _BEFORE_IMPORT + time.perf_counter() - _T_IMPORT


def _e2e(registry, cell, out, setup_s) -> dict:
    """The cell's end-to-end metrics: ``setup_s`` from the harness's clock,
    each other one read by ``metrics/<metric>.py`` from what the driver
    measured over the window."""
    metrics = {}
    for m in registry.end_to_end(cell):
        value = setup_s if m["name"] == "setup_s" else \
            registry.reader(m["name"])(out["e2e"])
        if value is None:
            raise KeyError(f"{m['name']}: not among what the driver "
                           f"measured, {sorted(out['e2e'])}")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def _per_layer(registry, cell, record) -> dict:
    metrics = {}
    for m in registry.per_layer(cell):
        value = registry.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def execute(registry, cell_name, seed, seconds, traced, device, tmp,
            controls=None, fields=None, mix=None) -> dict:
    """One run of a cell on ``device``; returns the result object (and, as
    ``controls``, the control readings asked for). ``fields`` and ``mix``
    replace the configuration's and the mix's (the tests' small sizes)."""
    cell = registry.cell(cell_name)
    fields = fields or registry.config(cell["config"])["model"]
    mix = mix or registry.traffic(cell["traffic"])
    ctx = Context(cell_name, fields, mix, device, seed, seconds, traced, tmp,
                  controls)
    out = registry.driver(mix["driver"]).run(ctx)
    ok, compared = check.verdict(out["readings"],
                                 registry.limits(cell_name))
    ok = ok and out["failed"] == 0
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(out["device_peak"])}
    result = {"correct": bool(ok), "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    if traced:
        rec = out["record"]
        result["metrics"] = _per_layer(registry, cell_name, rec)
        dev.update(busy_s=trace.busy_ns(rec) / 1e9,
                   window_s=rec["window_ns"] / 1e9)
        result["device"] = dev
        result["breakdown"] = trace.breakdown(rec)
    else:
        result["metrics"] = _e2e(registry, cell_name, out, ctx.setup_s)
        result["device"] = dev
    result["compared"] = compared
    # every reading, compared or not, and the controls' (for calibrate)
    result["_readings"] = out["readings"]
    result["_controls"] = out.get("controls", {})
    result["_detail"] = out.get("detail", {})
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    registry = Registry()
    cell = registry.cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"benchmark: {cell['chips']} CUDA card(s) needed, {found} "
              "found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    tmp = os.environ.get("TMPDIR") or None
    result = execute(registry, args.workload, args.seed, args.seconds,
                     bool(args.trace), device, tmp)
    for k in ("_readings", "_controls", "_detail"):
        result.pop(k)
    loaded = check.forbidden_modules()
    if loaded:
        print(f"benchmark: JAX modules loaded: {loaded}", file=sys.stderr)
        return 2
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
