#!/usr/bin/env python3
"""Kernel K2 (``neural_marionette_tpu_torch/csrc/chamfer.cu``, the chamfer
numerator forward and backward) timed at three occupancies, on one NVIDIA
GPU.

    python3 scripts/chamfer_occupancy.py [--root DIR] [--ablation]

Times the forward, the backward without the occupancy gradient (the
training path) and with it, through the package's own entry points
(``ops.losses.chamfer_num`` and ``_chamfer_bwd_cuda``), on the AIST serving
shape: 40 frames of 64^3, K = 24, bfloat16 occupancy, the keypoints and
gradients of ``chip_smoke.py``'s timing phase. Occupancies: the serving
path's (points of ``chip_smoke.serving_points`` voxelized, about 1 %),
30 % at random, and full. Per call: CUDA-event ms, device ms from the
profiler (by kernel), the occupied voxels and the bound
(``chip_smoke.k2_times``).

``--root DIR`` times the package of another checkout of the repository
(for example the parent commit unpacked with ``git archive``), whose entry
points have the same signatures; the inputs and the timing are this
checkout's. ``--ablation`` also times variants of this checkout's kernel
source with one phase left out, each of which computes wrong values on
purpose (only its time is read):

* ``load_only`` — every tile compacts to no voxel: the loads, the scan,
  the partials and the frames' sums, no evaluation;
* ``no_frame_sum`` — no block sums a frame's partials.

Prints the card's name and power limit, a line per occupancy, and last one
JSON object ``{"chamfer_occupancy": {...}}``. Exits nonzero without a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
F, G, K = 40, 64, 24   # the AIST serving window's frames, grid, keypoints

# variant -> replacements in the kernel source
VARIANTS = {
    "load_only": [("  __syncthreads();\n  return (int)base;\n",
                   "  __syncthreads();\n  return (int)(base >> 30);\n")],
    "no_frame_sum": [("  if (!last_of_frame(tickets + m, n_tiles, &s_last)) "
                      "return;\n",
                      "  last_of_frame(tickets + m, n_tiles, &s_last);\n"
                      "  return;\n")],
}


def log(*a):
    print(*a, flush=True)


def build_variants(kernels, out: Path) -> dict[str, Path]:
    """Compile every variant in parallel (one nvcc each)."""
    src = (kernels.CSRC / "chamfer.cu").read_text()
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


def load(kernels, path: Path):
    import ctypes
    lib = ctypes.CDLL(str(path))
    lib.nm_error_string.argtypes = [ctypes.c_int]
    lib.nm_error_string.restype = ctypes.c_char_p
    for fn, argtypes in kernels._SIGNATURES["chamfer"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def summary(times):
    """The JSON-able part of ``chip_smoke.k2_times``' record."""
    return {k: v for k, v in times.items() if not k.endswith("_work")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--ablation", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chamfer_occupancy: no CUDA device", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from neural_marionette_tpu_torch import kernels
    from neural_marionette_tpu_torch.ops import losses as L
    from neural_marionette_tpu_torch.ops import voxelize as V
    if Path(kernels.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {kernels.__file__}, not from {root}")
    card = smoke.phase_card()
    kernels.build(("voxelize", "chamfer"))
    device = torch.device("cuda")
    pts = torch.from_numpy(smoke.serving_points(
        smoke.SERVE_B, smoke.SERVE_T, smoke.SERVE_N, seed=31)).to(device)
    g = np.random.default_rng(32)
    kp = torch.from_numpy(g.uniform(-0.6, 0.6, (F, K, 3)).astype(
        np.float32)).to(device)
    gr = torch.from_numpy(g.uniform(-2.0, 2.0, F).astype(np.float32)).to(
        device)
    grids = {"path": V.voxelize(pts, G, dtype=torch.bfloat16).reshape(F, -1),
             **smoke.k2_dense_grids(F, G, device)}
    result = {"card": card, "root": str(root), "cases": {}}
    for name, occ in grids.items():
        t = summary(smoke.k2_times(kp, occ, gr, G))
        result["cases"][name] = t
        log(f"[occupancy] {name} ({t['occupied_voxels']} voxels): " +
            ", ".join(f"{d} {t[d + '_ms']:.4f} ms (device "
                      f"{t[d + '_device_ms']:.4f}, bound "
                      f"{t[d + '_bound_ms']:.4f})"
                      for d in ("fwd", "bwd", "docc")))
    if args.ablation:
        libs = {name: load(kernels, p) for name, p in build_variants(
            kernels, kernels.BUILD_DIR / "ablation").items()}
        own = kernels.library("chamfer")
        result["ablation"] = {}
        for name, lib in libs.items():
            kernels._LIBS["chamfer"] = lib
            L._lib = None
            for occ_name, occ in grids.items():
                t = summary(smoke.k2_times(kp, occ, gr, G))
                result["ablation"].setdefault(name, {})[occ_name] = t
                log(f"[ablation] {name} {occ_name}: " + ", ".join(
                    f"{d} {t[d + '_ms']:.4f} ms (device "
                    f"{t[d + '_device_ms']:.4f})" for d in ("fwd", "bwd")))
            L._workspace.clear()   # the variants leave the tickets counted
        kernels._LIBS["chamfer"] = own
        L._lib = None
    print(card)
    print(json.dumps({"chamfer_occupancy": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
