#!/usr/bin/env python3
"""Kernel K1 (``neural_marionette_tpu_torch/csrc/voxelize.cu``, the
voxelizer) timed at the AIST serving shape on one NVIDIA GPU, beside the
yardstick and a plain fill of the same grid.

    python3 scripts/voxelize_ablation.py [--root DIR] [--ablation]

Shape: the points of ``chip_smoke.serving_points`` (4, 10, 4096, 3)
float32 -> a (4, 10, 64, 64, 64, 1) bfloat16 grid, through the package's
own entry point (``ops.voxelize.voxelize``). Per variant: CUDA-event ms per
call (``chip_smoke.cuda_ms``), device ms and device operations per call
from the profiler (``chip_smoke.device_events``), and the bound. Beside it, in the same process:
``torch.zeros`` of the grid alone (one fill, what the grid's write costs
on its own) and ``chip_smoke``'s two-call yardstick (``torch.zeros`` +
``index_put_`` of indices computed beforehand).

``--root DIR`` times the package of another checkout of the repository
(for example the parent commit unpacked with ``git archive``); the inputs
and the timing are this checkout's. ``--ablation`` also times variants of
this checkout's kernel source, built with the package's nvcc flags; those
that leave a phase out compute wrong grids on purpose (only their time is
read):

* ``launch_only`` — neither the scatter nor the expansion: the launch,
  the masks' zeroing and the block barriers;
* ``no_scatter`` — no point is read: the expansion of empty masks;
* ``no_expand`` — the scatter, no store to the grid;
* ``threads_256``, ``threads_1024`` — other block sizes;
* ``slabs_4``, ``slabs_16`` — other numbers of blocks per frame;
* ``slabs_1_threads_1024``, ``slabs_2_threads_1024``,
  ``slabs_4_threads_1024`` — 1, 2 or 4 blocks of 1024 threads per frame
  (fewer reads of each point, fewer SMs writing);
* ``unroll_4`` — four points in flight per thread instead of eight;
* ``evict_first`` — the 16-byte stores with the streaming hint (``__stcs``).

Prints the card's name and power limit, a line per variant, and last one
JSON object ``{"voxelize_ablation": {...}}``. Exits nonzero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
G = 64

# variant -> replacements in the kernel source
NO_SCATTER = ("for (int i0 = 0; n > 0 && i0 < n_points;",
              "for (int i0 = n_points; n > 0 && i0 < n_points;")
NO_EXPAND = [("for (int j = tid; j < n_vec;", "for (int j = n_vec; j < n_vec;"),
             ("for (int s = tid; s < n_scalar;",
              "for (int s = n_scalar; s < n_scalar;")]
VARIANTS = {
    "launch_only": [NO_SCATTER] + NO_EXPAND,
    "no_scatter": [NO_SCATTER],
    "no_expand": NO_EXPAND,
    "threads_256": [("#define THREADS 512", "#define THREADS 256")],
    "threads_1024": [("#define THREADS 512", "#define THREADS 1024")],
    "slabs_4": [("#define SLABS 8", "#define SLABS 4")],
    "slabs_16": [("#define SLABS 8", "#define SLABS 16")],
    "slabs_1_threads_1024": [("#define SLABS 8", "#define SLABS 1"),
                             ("#define THREADS 512", "#define THREADS 1024")],
    "slabs_2_threads_1024": [("#define SLABS 8", "#define SLABS 2"),
                             ("#define THREADS 512", "#define THREADS 1024")],
    "slabs_4_threads_1024": [("#define SLABS 8", "#define SLABS 4"),
                             ("#define THREADS 512", "#define THREADS 1024")],
    "unroll_4": [("#define UNROLL 8", "#define UNROLL 4")],
    "evict_first": [("vec[j] = expand<ES>(b);",
                     "__stcs(vec + j, expand<ES>(b));")],
}


def log(*a):
    print(*a, flush=True)


def build_variants(kernels, out: Path) -> dict[str, Path]:
    """Compile every variant in parallel (one nvcc each)."""
    src = (kernels.CSRC / "voxelize.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source no longer "
                                   f"has {old!r}")
            text = text.replace(old, new)
        cu, so = out / f"{name}.cu", out / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    paths = {}
    for name, (proc, so) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{text}")
        paths[name] = so
    return paths


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--ablation", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("voxelize_ablation: no CUDA device", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from neural_marionette_tpu_torch import kernels
    from neural_marionette_tpu_torch.ops import voxelize as V
    if Path(kernels.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {kernels.__file__}, not from {root}")
    card = smoke.phase_card()
    kernels.build(("voxelize",))
    device = torch.device("cuda")
    pts = torch.from_numpy(smoke.serving_points(
        smoke.SERVE_B, smoke.SERVE_T, smoke.SERVE_N, seed=31)).to(device)
    F = smoke.SERVE_B * smoke.SERVE_T
    n_bytes = pts.numel() * 4 + F * G ** 3 * 2
    bound = n_bytes / smoke.PEAK_BYTES_PER_S * 1e3
    want = V.voxelize_plain(pts, G, dtype=torch.bfloat16)

    # the yardstick of chip_smoke's timing phase, and the fill alone
    step = torch.tensor([np.float32(2.0 / G + 1e-5)], device=device)
    idx = torch.floor((pts.reshape(F, -1, 3) + 1.0) / step)
    ok = ((idx >= 0) & (idx < G)).all(-1)
    idx = idx.long()
    lin = (torch.arange(F, device=device)[:, None] * G ** 3
           + (idx[..., 0] * G + idx[..., 1]) * G + idx[..., 2])[ok]
    one = torch.ones((), dtype=torch.bfloat16, device=device)

    def library_k1():
        grid = torch.zeros(F * G ** 3, dtype=torch.bfloat16, device=device)
        return grid.index_put_((lin,), one)

    def fill():
        return torch.zeros(F * G ** 3, dtype=torch.bfloat16, device=device)

    def run(fn, n=20):
        ms = smoke.cuda_ms(fn, iters=50, warmup=5)
        dev = smoke.device_events(fn, n)
        return {"ms": ms,
                "device_ms": sum(e.time_range.elapsed_us() for e in dev)
                / n / 1e3, "device_ops_per_call": len(dev) / n,
                "device_ops": sorted({e.name.split("(")[0][:60]
                                      for e in dev})}

    result = {"card": card, "root": str(root), "bound_ms": bound,
              "bytes": n_bytes, "variants": {}}
    calls = {"kernel": lambda: V.voxelize(pts, G, dtype=torch.bfloat16),
             "library_k1": library_k1, "fill": fill}
    for name, fn in calls.items():
        result["variants"][name] = r = run(fn)
        log(f"[voxelize] {name}: {r['ms']:.4f} ms in events, device "
            f"{r['device_ms']:.4f} ms in {r['device_ops_per_call']:g} "
            f"operations per call {r['device_ops']} (bound {bound:.4f})")
    if not torch.equal(V.voxelize(pts, G, dtype=torch.bfloat16), want):
        raise AssertionError("the kernel differs from the plain version")
    if args.ablation:
        own = V._fn
        for name, path in build_variants(
                kernels, kernels.BUILD_DIR / "ablation").items():
            lib = ctypes.CDLL(str(path))
            fn = lib.nm_voxelize
            fn.argtypes = kernels._SIGNATURES["voxelize"]["nm_voxelize"]
            fn.restype = ctypes.c_int
            V._fn = fn
            result["variants"][name] = r = run(
                lambda: V.voxelize(pts, G, dtype=torch.bfloat16))
            r["equal"] = bool(torch.equal(
                V.voxelize(pts, G, dtype=torch.bfloat16), want))
            log(f"[ablation] {name}: {r['ms']:.4f} ms in events, device "
                f"{r['device_ms']:.4f} ms, equal to plain {r['equal']}")
        V._fn = own
    print(card)
    print(json.dumps({"voxelize_ablation": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
