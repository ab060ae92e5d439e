#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``neural_marionette_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. the card: its name and power limit, as ``nvidia-smi`` gives them;
2. the build of every kernel in ``neural_marionette_tpu_torch/csrc/``, one
   ``nvcc`` each, all at once, with their ``-Xptxas -v`` lines;
3. K1 (voxelizer) against its plain version on the card at the serving
   shape (4, 10, 4096, 3), G=64, and on the edge cases (out of range on each
   axis, duplicates, ragged N, cell boundaries): occupancy exactly equal;
4. K2 (chamfer numerator, forward) against its plain version on the card at
   M=40, K=24, G=64, occupancy float32 and bfloat16: rtol 1e-5, and two
   kernel runs equal to the bit;
5. the serving path at the full AIST width with weights from a seed: a
   bfloat16 stream of (4, 10, 4096, 3) windows, outputs finite and of the
   expected shapes, and the launch counters showing K1 and K2 on every
   window;
6. one B=1 window in float32 (TF32 off) on the card and on the CPU (plain
   versions), compared within stated tolerances;
7. each kernel's time against its plain version, a PyTorch library call
   and its bound, at the serving path's shapes;
8. where a serving window's time goes: per-layer times of one window and,
   under ``torch.profiler``, the device's busy share and its top kernels.

It prints a ``{"kernels": [...]}`` line, a ``{"stream": ...}`` line, a
``{"profile": ...}`` line, the card's line, and last ``{"ok": true,
"device": {...}}``. Without a card, or without the package beside it, it
exits nonzero before printing a result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, fp32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12

SERVE_B, SERVE_T, SERVE_N = 4, 10, 4096
STREAM_WINDOWS = 16
SAMPLE_NUM = 10


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ timing
def cuda_ms(fn, iters=20, warmup=3):
    """Mean ms of ``fn()`` on the card: CUDA events around ``iters`` calls
    after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ inputs
def serving_points(B, T, N, seed):
    """(B, T, N, 3) float32 windows: a blob of points in [-0.7, 0.7]^3
    drifting across the window, with a few stray points outside [-1, 1]
    (dropped by the voxelizer)."""
    g = np.random.default_rng(seed)
    base = g.normal(0.0, 0.25, (B, 1, N, 3)) * np.array([0.6, 1.0, 0.5])
    drift = np.linspace(-0.2, 0.2, T)[None, :, None, None] * \
        g.uniform(-1, 1, (B, 1, 1, 3))
    pts = np.clip(base + drift, -0.7, 0.7)
    stray = g.random((B, T, N)) < 0.002
    pts[stray] = g.uniform(1.01, 1.2, (int(stray.sum()), 3)) * \
        g.choice([-1.0, 1.0], (int(stray.sum()), 3))
    return pts.astype(np.float32)


def voxel_edge_cases(G, seed=3):
    """name -> (F, N, 3) float32 points on the voxelizer's edges."""
    g = np.random.default_rng(seed)
    step = np.float32(2.0 / G + 1e-5)
    edges = np.arange(0, G + 2, dtype=np.float32) * step - np.float32(1.0)
    boundary = np.stack(np.meshgrid(edges, edges[::3], edges[::5],
                                    indexing="ij"), -1).reshape(1, -1, 3)

    def oob(values):
        out = []
        for axis in range(3):
            for bad in values:
                p = g.uniform(-0.9, 0.9, (1, 64, 3))
                p[0, ::2, axis] = bad
                out.append(p)
        return np.concatenate(out, axis=0)

    cases = {
        "oob_each_axis": oob((1.0 + float(step) * G, 1.3, 1e9, -1e9,
                              -1.0 - float(step) / 2, -1.2)),
        "duplicates": np.zeros((2, 300, 3)) + np.array([0.1, -0.2, 0.3]),
        "ragged_n": g.uniform(-1, 1, (3, 777, 3)),
        "cell_boundaries": boundary,
    }
    return {k: np.ascontiguousarray(v, dtype=np.float32)
            for k, v in cases.items()}


def voxelize_oracle(pts, G):
    """float32 numpy: floor((p + 1) / step), a point dropped when any axis
    is out of [0, G)."""
    step = np.float32(2.0 / G + 1e-5)
    idx = np.floor((pts + np.float32(1.0)) / step)
    ok = ((idx >= 0) & (idx < G)).all(-1)
    out = np.zeros(pts.shape[:-2] + (G, G, G, 1), np.float32)
    for f in np.ndindex(pts.shape[:-2]):
        i = idx[f][ok[f]].astype(np.int64)
        out[f][i[:, 0], i[:, 1], i[:, 2], 0] = 1.0
    return out


# ------------------------------------------------------------------ phases
def phase_card():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    line = res.stdout.strip().splitlines()[0].strip()
    log(f"[card] {line}")
    return line


def phase_build():
    from neural_marionette_tpu_torch import kernels
    t0 = time.perf_counter()
    built = kernels.build()
    wall = time.perf_counter() - t0
    for name, info in built.items():
        log(f"[build] {name}: nvcc {info['seconds']:.2f} s")
        for ln in info["log"].splitlines():
            if "registers" in ln or "bytes stack" in ln or "smem" in ln:
                log(f"[build]   {ln.strip()}")
    log(f"[build] all kernels in {wall:.2f} s (parallel nvcc)")
    for name in kernels.SOURCES:
        kernels.library(name)
    return wall


def phase_k1(device, G):
    """K1 against its plain version (and the numpy oracle): exactly equal.
    Returns the max abs difference from the plain version (0.0)."""
    import torch
    from neural_marionette_tpu_torch.ops import voxelize as V
    cases = {"serving": serving_points(SERVE_B, SERVE_T, SERVE_N, seed=11)}
    cases.update(voxel_edge_cases(G))
    worst = 0.0
    for name, pts in cases.items():
        p = torch.from_numpy(pts).to(device)
        want = voxelize_oracle(pts, G)
        for dtype in (torch.float32, torch.bfloat16):
            got = V.voxelize(p, G, dtype=dtype)
            plain = V.voxelize_plain(p, G, dtype=dtype)
            if got.dtype != dtype or got.shape != pts.shape[:-2] + (G,) * 3 \
                    + (1,):
                raise AssertionError(f"K1 {name}: {got.dtype} "
                                     f"{tuple(got.shape)}")
            worst = max(worst, float((got.float() - plain.float()).abs()
                                     .max()))
            if not torch.equal(got, plain):
                n = int((got != plain).sum())
                raise AssertionError(f"K1 {name} {dtype}: {n} voxels differ "
                                     f"from the plain version")
            if not np.array_equal(got.float().cpu().numpy(), want):
                raise AssertionError(f"K1 {name} {dtype}: differs from the "
                                     f"numpy oracle")
        log(f"[K1] {name} {tuple(pts.shape)}: exactly equal "
            f"({int(want.sum())} occupied voxels)")
    return worst


def phase_k2(device, G, M, K):
    """K2 forward against its plain version: rtol 1e-5 (float32 sums of up
    to G^3 terms in different orders), and two kernel runs equal to the
    bit."""
    import torch
    from neural_marionette_tpu_torch.ops import losses as L
    from neural_marionette_tpu_torch.ops import voxelize as V
    g = np.random.default_rng(5)
    kp = torch.from_numpy(g.uniform(-0.9, 0.9, (M, K, 3)).astype(
        np.float32)).to(device)
    pts = serving_points(1, M, SERVE_N, seed=12).reshape(M, SERVE_N, 3)
    path_occ = V.voxelize(torch.from_numpy(pts).to(device), G).reshape(M, -1)
    dense_occ = torch.from_numpy(
        (g.random((M, G ** 3)) < 0.3).astype(np.float32)).to(device)
    for occ_name, occ in (("path", path_occ), ("dense", dense_occ)):
        for dtype in (torch.float32, torch.bfloat16):
            o = occ.to(dtype).contiguous()
            a = L.chamfer_num(kp, o, G)
            b = L.chamfer_num(kp, o, G)
            plain = L.chamfer_num_plain(kp, o, G)
            if a.shape != (M,) or a.dtype != torch.float32:
                raise AssertionError(f"K2: {a.dtype} {tuple(a.shape)}")
            if not torch.equal(a, b):
                raise AssertionError(f"K2 {occ_name} {dtype}: two runs "
                                     f"differ")
            rel = ((a - plain).abs() / plain.abs().clamp(min=1e-6)).max()
            rel = float(rel)
            if not rel <= 1e-5:
                raise AssertionError(f"K2 {occ_name} {dtype}: max rel err "
                                     f"{rel:.3e} > 1e-5")
            log(f"[K2] {occ_name} occupancy {dtype}: max rel err {rel:.3e}, "
                f"bitwise repeatable")


def _window_outputs(cfg, B, T):
    K, G = cfg.nkeypoints, cfg.grid_size
    return {"keypoints": (B, T, K, 4), "kypt_recon": (B, T, K, 4),
            "R": (B, T, K, 3, 3), "recon_loss": (), "vol_fit_reg": (),
            "separation_loss": (), "graph_traj_loss": (), "kl_kypt": (),
            "kypt_recon_loss": ()}


def phase_stream(marionette, n_windows):
    """A bfloat16 stream of serving windows; returns (host ms from the
    start to the first result and between consecutive results, launches of
    K1, launches of K2).

    Results come lag-1, so gap i (1 <= i <= n-2) is the time the stream
    takes for one window: the host queues window i+1 and waits for window
    i. The first gap pays set-up. The last (the flush) is no window's time:
    while the host sets the pace, the card has nearly finished the last
    window by the time the host asks for it."""
    from neural_marionette_tpu_torch.ops import losses as L
    from neural_marionette_tpu_torch.ops import voxelize as V
    cfg = marionette.cfg
    shapes = _window_outputs(cfg, SERVE_B, SERVE_T)
    windows = [serving_points(SERVE_B, SERVE_T, SERVE_N, seed=100 + i)
               for i in range(n_windows)]
    V.launches = 0
    L.launches = 0
    stamps = []
    results = []
    with marionette.stream(dtype="bfloat16", sample_num=SAMPLE_NUM,
                           outputs=tuple(shapes)) as s:
        t0 = time.perf_counter()
        for res in s.run(windows):
            stamps.append(time.perf_counter())
            results.append(res)
    k1, k2 = V.launches, L.launches
    if len(results) != n_windows:
        raise AssertionError(f"stream gave {len(results)} results for "
                             f"{n_windows} windows")
    for i, res in enumerate(results):
        for k, shape in shapes.items():
            v = res[k]
            if v.shape != shape or not np.isfinite(v).all():
                raise AssertionError(f"window {i} {k}: shape {v.shape} "
                                     f"(want {shape}), finite "
                                     f"{np.isfinite(v).all()}")
    if k1 != n_windows or k2 != n_windows:
        raise AssertionError(f"launches over {n_windows} windows: K1 {k1}, "
                             f"K2 {k2}")
    ms = np.diff([t0] + stamps) * 1e3
    log(f"[stream] {n_windows} windows {SERVE_B}x{SERVE_T}x{SERVE_N}x3 bf16: "
        f"ms to the first result and between results "
        f"{[round(float(x), 2) for x in ms]}")
    log(f"[stream] launches: K1 {k1}, K2 {k2}; outputs finite, shapes "
        f"right")
    return ms, k1, k2


def phase_reference(cfg, seed, card_device):
    """One B=1 window in float32 on the card (kernels) and on the CPU
    (plain versions), same weights, skeleton and noise. Tolerances:
    keypoints 1e-4 absolute (conv stacks in other summation orders, the
    JAX parity record's conv-stack bound); kypt_recon and R 1e-3 absolute
    (the dynamics amplify keypoint differences through the FK chain); loss
    scalars 2e-3 relative or 1e-6 absolute (a loss near zero, such as the
    time-consistency loss of nearly still keypoints, is a difference of
    close numbers). The best-of-N picks must be equal."""
    import torch
    from neural_marionette_tpu_torch.api import Marionette
    from neural_marionette_tpu_torch.models import SkeletonArrays
    from neural_marionette_tpu_torch.ops.voxelize import voxelize
    dev = card_device
    cpu = torch.device("cpu")
    card = Marionette.from_config(cfg, seed=seed, device=dev)
    host = Marionette.from_config(cfg, seed=seed, device=cpu)
    skeleton = card.extract_skeleton()
    for a, b in zip(skeleton, host.extract_skeleton()):
        if not np.array_equal(a, b):
            raise AssertionError("skeleton differs between card and CPU")
    pts = serving_points(1, cfg.Ttot, SERVE_N, seed=21)
    eps = np.random.default_rng(22).standard_normal(
        (cfg.Ttot, 3, 1, cfg.nlatent_kypt)).astype(np.float32)
    outs = {}
    for m, d in ((card, dev), (host, cpu)):
        with torch.inference_mode():
            vox = voxelize(torch.from_numpy(pts).to(d), cfg.grid_size)
            out = m.model.encode_only(
                vox, SkeletonArrays.from_skeleton(skeleton, d), sample_num=3,
                eps=torch.from_numpy(eps).to(d))
        outs[m is card] = {k: v.float().cpu().numpy() for k, v in out.items()
                        if isinstance(v, torch.Tensor)}
    a, b = outs[True], outs[False]
    if not np.array_equal(a["best_index"], b["best_index"]):
        raise AssertionError("best-of-N picks differ between card and CPU")
    errs = {}
    for k, tol in (("keypoints", 1e-4), ("kypt_recon", 1e-3), ("R", 1e-3)):
        errs[k] = float(np.abs(a[k] - b[k]).max())
        if not errs[k] <= tol:
            raise AssertionError(f"{k}: card vs CPU max abs err "
                                 f"{errs[k]:.3e} > {tol}")
    for k in ("recon_loss", "vol_fit_reg", "kypt_const_loss",
              "separation_loss", "sparsity_loss", "local_const_loss",
              "time_const_loss", "sparsity_const_loss", "graph_traj_loss",
              "kl_kypt", "kypt_recon_loss"):
        err = float(abs(a[k] - b[k]))
        errs[k] = err
        if not err <= 2e-3 * abs(float(b[k])) + 1e-6:
            raise AssertionError(f"{k}: card {float(a[k])!r} vs CPU "
                                 f"{float(b[k])!r}")
        log(f"[reference] {k}: card {float(a[k])!r} CPU {float(b[k])!r}")
    log("[reference] B=1 float32 card vs CPU, max abs err: " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()))
    return errs


def phase_timing(device, G, K, launches, errs):
    """Kernel, plain and library times at the serving shapes; returns the
    ``kernels`` records."""
    import torch
    from neural_marionette_tpu_torch.ops import losses as L
    from neural_marionette_tpu_torch.ops import voxelize as V
    from neural_marionette_tpu_torch.ops.coords import coord_maps
    records = []

    # K1: (4, 10, 4096, 3) float32 -> (4, 10, 64, 64, 64, 1) bfloat16
    pts_np = serving_points(SERVE_B, SERVE_T, SERVE_N, seed=31)
    pts = torch.from_numpy(pts_np).to(device)
    F = SERVE_B * SERVE_T
    step = torch.tensor([np.float32(2.0 / G + 1e-5)], device=device)
    idx = torch.floor((pts.reshape(F, SERVE_N, 3) + 1.0) / step)
    ok = ((idx >= 0) & (idx < G)).all(-1)
    idx = idx.long()
    lin = (torch.arange(F, device=device)[:, None] * G ** 3
           + (idx[..., 0] * G + idx[..., 1]) * G + idx[..., 2])[ok]
    grid = torch.zeros(F * G ** 3, dtype=torch.bfloat16, device=device)
    one = torch.ones((), dtype=torch.bfloat16, device=device)
    k1_bytes = pts.numel() * 4 + F * G ** 3 * 2
    k1_ops = F * SERVE_N * 3 * 3     # add, divide, floor per coordinate
    records.append(_record(
        "voxelize", "neural_marionette_tpu_torch/csrc/voxelize.cu",
        "neural_marionette_tpu/ops/pallas/voxelize_kernel.py:70",
        launches["voxelize"], errs["voxelize"],
        cuda_ms(lambda: V.voxelize(pts, G, dtype=torch.bfloat16)),
        cuda_ms(lambda: V.voxelize_plain(pts, G, dtype=torch.bfloat16)),
        cuda_ms(lambda: grid.index_put_((lin,), one)),
        k1_bytes, k1_ops))

    # K2: kp (40, 24, 3) float32, occupancy (40, 64^3) bfloat16 -> (40,)
    occ = V.voxelize(pts, G, dtype=torch.bfloat16).reshape(F, G ** 3)
    g = np.random.default_rng(32)
    kp = torch.from_numpy(g.uniform(-0.6, 0.6, (F, K, 3)).astype(
        np.float32)).to(device)
    vox = coord_maps((G,) * 3, device=device).reshape(1, G ** 3, 3)
    vox = vox.expand(F, -1, -1)

    def library_k2():
        d = torch.cdist(vox, kp).square_().amin(dim=-1)
        return (d * occ).sum(dim=-1)

    # An empty voxel adds exactly 0 to num[m], so the work these inputs need
    # is the min over keypoints at the occupied voxels only (4 FMAs, 8
    # flops, and a min per voxel-keypoint pair; |v|^2, relu and the
    # weighted add per voxel), against one read of the dense grid.
    occupied = int(occ.count_nonzero())
    k2_bytes = kp.numel() * 4 + occ.numel() * 2 + F * 4
    k2_ops = occupied * (K * 9 + 8)
    records.append(_record(
        "chamfer_fwd", "neural_marionette_tpu_torch/csrc/chamfer.cu",
        "neural_marionette_tpu/ops/pallas/chamfer_kernel.py:190",
        launches["chamfer_fwd"], errs["chamfer_fwd"],
        cuda_ms(lambda: L.chamfer_num(kp, occ, G)),
        cuda_ms(lambda: L.chamfer_num_plain(kp, occ, G), iters=5),
        cuda_ms(library_k2, iters=5),
        k2_bytes, k2_ops))
    return records


def _record(name, source, replaces, launches, err, ms, plain_ms, library_ms,
            n_bytes, n_ops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_OPS_PER_S * 1e3
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms}
    log(f"[time] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}: {n_bytes} bytes, {n_ops} ops)")
    return rec


def _layer_ms(model, skeleton, pts, G, reps=5):
    """Host ms of each layer of one window, each between two
    ``torch.cuda.synchronize()`` calls, median of ``reps``. "losses" is the
    rest of ``KyptDetector.forward`` (K2 among it)."""
    import torch
    from neural_marionette_tpu_torch.ops.voxelize import voxelize
    det, dyn = model.kypt_detector, model.dyna_module
    gen = torch.Generator(pts.device).manual_seed(0)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    rows = defaultdict(list)
    with torch.inference_mode():
        for _ in range(reps):
            vox, ms = timed(lambda: voxelize(pts, G, dtype=model.dtype))
            rows["voxelize"].append(ms)
            (_, kp, gauss, first), ms = timed(lambda: det.vox_to_kypt(vox))
            rows["encoder"].append(ms)
            _, ms = timed(lambda: det.kypt_to_vox(gauss, first, vox[:, 0]))
            rows["decoder"].append(ms)
            _, ms = timed(lambda: det(vox))
            rows["detector_total"].append(ms)
            _, ms = timed(lambda: dyn.encode(kp, skeleton,
                                             sample_num=SAMPLE_NUM,
                                             generator=gen))
            rows["vrnn_encode"].append(ms)
    med = {k: float(np.median(v)) for k, v in rows.items()}
    med["losses"] = med["detector_total"] - med["encoder"] - med["decoder"]
    return med


def phase_profile(marionette, n_windows=4):
    """Where a serving window's time goes, after every check has passed:
    the layer times of one window, then a bfloat16 stream of ``n_windows``
    under ``torch.profiler``: the device's busy share (the union of its
    kernel, copy and memset intervals over the wall time), its operations
    per window, the kernels that take the most device time, and the device
    time per call of the port's own kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from neural_marionette_tpu_torch.models import SkeletonArrays
    cfg = marionette.cfg
    stream = marionette.stream(dtype="bfloat16", sample_num=SAMPLE_NUM)
    skeleton = SkeletonArrays.from_skeleton(marionette.extract_skeleton(),
                                            marionette.device)
    pts = torch.from_numpy(serving_points(SERVE_B, SERVE_T, SERVE_N,
                                          seed=51)).to(marionette.device)
    layers = _layer_ms(stream.model, skeleton, pts, cfg.grid_size)
    log("[profile] layers: " + ", ".join(f"{k} {v:.2f} ms"
                                         for k, v in layers.items()))
    ws = [serving_points(SERVE_B, SERVE_T, SERVE_N, seed=200 + i)
          for i in range(n_windows)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in stream.run(ws):
            pass
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler recorded no device operation")
    busy, end = 0.0, -np.inf
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    n = n_windows
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    # the port's own kernels, by the names of their __global__s in csrc/
    ours = {k: v for k, v in by_name.items()
            if "voxelize_kernel" in k or "chamfer_" in k}
    out = {"windows": n, "layers_ms": layers,
           "wall_ms_per_window": wall_us / n / 1e3,
           "device_busy_ms_per_window": busy / n / 1e3,
           "device_busy_share": busy / wall_us,
           "device_ops_per_window": len(dev) / n,
           "top_kernels": [{"name": k[:90], "ms_per_window": v[0] / n / 1e3,
                            "calls_per_window": v[1] / n} for k, v in top],
           "port_kernels": [{"name": k[:90],
                             "device_ms_per_call": v[0] / v[1] / 1e3,
                             "calls_per_window": v[1] / n}
                            for k, v in ours.items()]}
    log(f"[profile] {n} windows: wall {out['wall_ms_per_window']:.2f} ms, "
        f"device busy {out['device_busy_ms_per_window']:.2f} ms per window "
        f"(share {out['device_busy_share']:.3f}), "
        f"{out['device_ops_per_window']:.0f} device operations per window")
    for k in out["port_kernels"]:
        log(f"[profile] port kernel {k['device_ms_per_call']:.4f} ms per "
            f"call, {k['calls_per_window']:.1f} per window: {k['name']}")
    for k in out["top_kernels"]:
        log(f"[profile] {k['ms_per_window']:8.3f} ms "
            f"{k['calls_per_window']:6.1f} per window: {k['name']}")
    return out


# -------------------------------------------------------------------- main
def main() -> int:
    if not (ROOT / "neural_marionette_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the package neural_marionette_tpu_torch is not "
              "beside this script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from neural_marionette_tpu_torch import (MarionetteConfig, adjust_config,
                                             check_supported)
    from neural_marionette_tpu_torch.api import Marionette
    from neural_marionette_tpu_torch.ops import losses as L

    # every float32 comparison runs in full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.perf_counter()

    card = phase_card()
    phase_build()
    cfg = adjust_config(MarionetteConfig(dataset="aist"))
    check_supported(cfg)
    G, K = cfg.grid_size, cfg.nkeypoints
    log(f"[config] AIST preset: grid {G}, K {K}, feat_dim {cfg.feat_dim}, "
        f"T {cfg.Ttot}, nlatent {cfg.nlatent_kypt}, nhidden "
        f"{cfg.nhidden_kypt}")

    errs = {"voxelize": phase_k1(device, G)}
    phase_k2(device, G, SERVE_B * SERVE_T, K)

    marionette = Marionette.from_config(cfg, seed=0, device=device)
    torch.cuda.reset_peak_memory_stats()
    ms, k1, k2 = phase_stream(marionette, STREAM_WINDOWS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {"voxelize": k1, "chamfer_fwd": k2}

    # max_abs_err of K2 at the serving shape, bfloat16 occupancy
    from neural_marionette_tpu_torch.ops import voxelize as V
    pts = torch.from_numpy(serving_points(SERVE_B, SERVE_T, SERVE_N,
                                          seed=41)).to(device)
    occ = V.voxelize(pts, G, dtype=torch.bfloat16).reshape(-1, G ** 3)
    kp = torch.from_numpy(np.random.default_rng(42).uniform(
        -0.6, 0.6, (occ.shape[0], K, 3)).astype(np.float32)).to(device)
    errs["chamfer_fwd"] = float((L.chamfer_num(kp, occ, G)
                                 - L.chamfer_num_plain(kp, occ, G)).abs().max())

    phase_reference(cfg, seed=0, card_device=device)
    records = phase_timing(device, G, K, launches, errs)
    profile = phase_profile(marionette)

    steady = ms[1:-1]   # neither the set-up gap nor the flush (phase_stream)
    stream = {"windows": STREAM_WINDOWS, "B": SERVE_B, "T": SERVE_T,
              "N": SERVE_N, "dtype": "bfloat16", "sample_num": SAMPLE_NUM,
              "mean_ms_per_window": float(steady.mean()),
              "p50_ms_per_window": float(np.percentile(steady, 50)),
              "gaps_ms": [float(x) for x in ms],
              "peak_device_memory_gib": peak, "card": card}
    log(f"[stream] steady windows: mean {stream['mean_ms_per_window']:.2f} "
        f"ms, p50 {stream['p50_ms_per_window']:.2f} ms over {len(steady)}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"stream": stream}))
    print(json.dumps({"profile": profile}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
