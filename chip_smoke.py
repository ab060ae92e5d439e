#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``neural_marionette_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. the card: its name and power limit, as ``nvidia-smi`` gives them;
2. the build of every kernel in ``neural_marionette_tpu_torch/csrc/``, one
   ``nvcc`` each, and of the host data library (``g++``), all at once,
   with the kernels' ``-Xptxas -v`` lines;
3. K1 (voxelizer) against its plain version and a numpy oracle on the card,
   equal to the bit, float32 and bfloat16, at G = 5, 16, 32 and 64 on the
   edge cases (out of range on each axis, NaN and +-inf, duplicates, ragged
   N, cell boundaries, N = 0 and 1, every point in one voxel, F = 1, 3 and
   40) and at the serving shape (4, 10, 4096, 3), G=64: into an output
   poisoned with NaN, aligned and misaligned (every element written,
   nothing around it), and bitwise repeatable;
4. K2 (chamfer numerator, forward) against its plain version on the card at
   M=40, K=24, G=64, occupancy float32 and bfloat16, then on edge frames
   (empty, occupied inside one tile, full, sparse) at G=64 and G=5 for K =
   1, 24 and 64: rtol 1e-5, two kernel runs equal to the bit, an empty
   frame exactly 0, and on G=5 the kernel, the plain version on the card
   and on the CPU equal to the bit;
5. K2 backward against its plain version on the card at M=40, K=24, G=64,
   occupancy float32 and bfloat16, with and without the occupancy
   gradient, and on the same edge frames: dkp rtol 1e-5 plus 2e-5 of its
   terms' magnitude, docc atol 4e-6 max|g|, bitwise repeatable, dkp equal
   with and without docc; and a G=5 case of exact ties and relu at exactly
   0, equal on the card and on the CPU;
6. K3 (conv3d) against its plain version on the card at every distinct
   conv shape of the conv route (``conv_kernel=True``) in an AIST window,
   bfloat16, plus float32-x, channels-last and z-asymmetric cases, bitwise
   repeatable; K4 (fused conv + GroupNorm + LeakyReLU stage) on the
   decoder's two 64^3 stage inputs against its plain version and the
   model's own stages, bitwise repeatable, and its passes one by one: pass
   1's per-brick moment partials against their plain layout, pass 2's
   kernel (``csrc/groupnorm.cu``) against ``_normalize`` within one ulp;
   one window through the routed detector against the route off; then K3
   (per shape: TFLOP/s and share of its bound, beside cuDNN) and K4 (pass
   1, reduce and pass 2 apart) timed (see 12);
7. the serving path at the full AIST width with weights from a seed: a
   bfloat16 stream of (4, 10, 4096, 3) windows asking for its default
   outputs (keypoints, kypt_recon, R: the pruned window, no decoder and
   no loss), outputs finite and of the expected shapes, and the launch
   counters showing K1 on every window and K2 and K3 on none;
8. the same stream on the conv route: K3 44 times per window (the
   encoder's routed convs), keypoints close to the default stream's; and
   a routed stream asking for recon and every loss scalar, which
   launches what every window did before the pruning (K1 and K2 once, K3
   48 times a window), its keypoints, kypt_recon and R equal to the bit
   to the pruned routed stream's;
9. one B=1 window in float32 (TF32 off) on the card and on the CPU (plain
   versions), compared within stated tolerances;
10. the training path at the full AIST width: ``Trainer`` on (4, 10, 4096,
    3) point batches in bfloat16, a detector-phase epoch, a learner-phase
    epoch (detector frozen, skeleton extracted from the trained affinity)
    and a grad_accum=2 step: finite losses and grad_norm, frozen parameters
    unchanged to the bit, K1 and K2 forward on every microbatch, K2
    backward on every detector-phase microbatch and never in the learner
    phase; step times, the device busy share of two profiled steps (after
    a warm-up step under the profiler; the K1 operations it records) and
    the peak memory per phase; then two-phase training: the detector-phase
    epoch's checkpoint and a reference-layout ``.pth`` each start a
    ``pretrained_mode=1`` ``Trainer`` (T = 20), whose detector must equal
    the saved one to the bit before and after a few learner steps; then a
    few steps of each phase on the conv route, K3 48 times per microbatch;
11. one float32 training step (TF32 off) at B=1, T=10 on the card and on
    the CPU: metrics, gradients and updated parameters within stated
    tolerances;
12. each kernel's time against its plain version, a PyTorch library call
    and its bound, at the serving and training paths' shapes (K1's
    yardstick does K1's work: zero a grid, then one ``index_put_`` of
    indices computed beforehand; no one call computes K1's function; K1
    must be one device operation per call); K2
    also with its device time per kernel, its occupied voxels, and its
    times on a 30 % and a fully occupied grid (``k2_times``);
13. where a serving window's time goes, route off and on: per-layer times
    of one window and, under ``torch.profiler`` (a warm-up window first;
    it must record K1 once a window), the device's busy share, its copies
    and its top kernels;
14. the apps at the full AIST width, float32, seeded informative weights:
    ``Marionette.generate`` (a 5-frame clip, Tgen 25, sample_num 3),
    ``interpolate`` (20 frames, anchor_rate 10, sample_num 10000) and
    ``retarget`` (10 frames onto 4096 points, modes ``ours`` and
    ``baseline``), each timed twice: JAX shapes, finite outputs, R
    orthonormal, and K2 forward once per detector forward; the training
    loop's generate step on a bfloat16 model (B 4, T 10, Tcond 3) with
    the conv route on and off, K3 once per routed conv of the detector
    forward and of the decoder, the two routes within stated bounds; and
    generation and interpolation card against CPU (float32, injected
    noise, selections equal or float32 near-ties) within stated
    tolerances;
15. the training CLI (``cli.train``) in-process at the AIST preset in
    bfloat16 on an AIST++-layout tree the script writes (12 train and 4
    test sequences of 40 frames x 20000 points, ~154 MB): the loader's
    batches on the card (4 threads, prefetch) equal to the host's, two
    epochs across the detector -> learner switch with validation
    (semantic, voxel_chamfer) and a checkpoint each, then a resume for one
    epoch on the conv route: the files ``train.py`` writes, finite, the
    resume at the next epoch, and the launches of K1, K2 forward and
    backward and K3 under each run; the loader's ms per batch at 0 and 4
    threads, the detector and learner steps through the loader (p50, and
    the busy share of three profiled steps), the validation's parts and
    the recon occupancy, the epoch seconds; the GIF logging of every epoch
    (all below 10): ``gifs/<epoch>/`` holds the tracked keypoints and
    recon of the first validation batch's 4 clips, and the generated ones
    (the generate step on that batch) only in the learner epochs, each GIF
    decoded by this script's own reader (10 frames, 150 ms, looping), its
    ms per epoch printed beside the epoch seconds; the launches of each run
    count the logging's K1 call per epoch and the generate step's K1, K2
    forward and K3 calls (``CLI_LAUNCHES``, each count derived there); one
    epoch with ``--debug_nans 1`` that completes, and a ``Trainer`` of that
    configuration with a parameter poisoned with NaN that must raise
    ``FloatingPointError``; then the three demo CLIs (``cli.vis_*``) from
    the run's directory, their ``.npy`` outputs checked
    (``cli.vis_generation`` with ``--sample_num 1``, ``CLI_GEN_SAMPLES``:
    the run's time limit);
16. the OBJ textures (``textures`` line): every fixture of
    ``tests/torch_textures/`` (PNG of every colour type, depth and
    interlace; JPEG baseline, extended, progressive and lossless, Huffman
    and arithmetic, at 4:4:4, 4:2:2, 4:2:0, 4:4:0 and sampling factors 3
    and 4, with restart intervals, CMYK and YCCK, without DHT, progressive
    files cut short (block smoothing); BMP with run-length and bitfields;
    TGA at 16 bits; GIF; TIFF of every layout and compression imageio
    reads, every sample type of its tifffile (1-64-bit, signed, float,
    complex, 5-6-5), YCbCr, CMYK and other inks at every depth, CIELab,
    ICCLab and ITULab, the other photometrics, ImageDepth volumes; WebP
    lossless, lossy, with alpha and animated; DDS uncompressed and BC1-BC7;
    QOI; PNM, PFM and PAM as Pillow and OpenCV read them, Pillow's CMYK and
    RGBA extensions; JPEG 2000
    as JP2 and raw codestreams: every mode, 5/3 and 9/7, RCT and ICT,
    layers, tiles, precincts, the five progression orders and POC, every
    code-block style, RGN, SOP/EPH, sYCC, sub-sampled components,
    palettes, patched precision) read by
    ``viz.image_files.read_image`` (JPEG, WebP, QOI, BCn and JPEG 2000,
    and the LZW, PackBits and run-length expansions, in the host libraries
    built on this machine) and ``apps.retarget.texture_rgb``, equal to the
    bit to
    ``MANIFEST.json`` (imageio's pixels on the machine that wrote them);
    the refused files (hierarchical, 12-bit, fractionally sampled,
    lossless YCbCr or without tables or arithmetic-coded JPEG, an
    arithmetic scan past 64 KiB; TIFF JPEG, CCITT, SGI LogLuv, old-style
    LZW, YCbCr subsampling, the depths and sample formats tifffile cannot
    unpack, predictor 3 on integers or in separate tiles; Pillow's PyP;
    OpenCV PNM cut short or with a bad header; truncated GIF, WebP, DDS
    and QOI, a bad LZW code, BMP layouts and a DDS format Pillow refuses;
    PSD, which imageio does not read; JPEG 2000 cut short, without EOC,
    of a colour space Pillow does not unpack or a palette past 256
    colours) raising ``ValueError``
    naming what they are; the host ms of decoding each 1024 x 1024 file
    (baseline and progressive 4:2:0 JPEG, arithmetic sequential and
    progressive 4:2:0 JPEG, CMYK JPEG, GIF, TIFF LZW, WebP lossless and
    lossy, BC1 and BC7 DDS, QOI, JPEG 2000 5/3 and 9/7 with ICT, TIFF of
    32-bit unsigned samples with predictor 2 and 8-bit CIELab); then
    imageio's OpenCV route: every fixture and the Radiance HDR and Sun
    raster fixtures copied under ``.pbm`` and ``.hdr`` (and the latter
    under ``.ras``, ``.png``, an unknown name and ``.sr``) in a temporary
    directory and read by ``read_image``, each equal to the manifest's
    digest of imageio's array or refused where imageio refuses it (the
    CCITT and SGILog TIFFs read through libtiff's codecs; content OpenCV
    does not take read as under its own name), and the host ms of a 1024
    x 1024 run-length Radiance HDR, a 1024 x 1024 16-bit RGB PNG, a 1024 x
    1024 Group 4 TIFF and a 1024 x 1024 LogLuv32 TIFF under ``.pbm``;
    then the renders on the card (``viz/``): the raster's ``splat`` (px 1 and
    2, onto a given frame), the surfels of a 64^3 clip's 10 frames, the
    skeleton meshes of 10 frames and a mesh of ~1e5 faces at the reference
    camera (1025 x 958), each equal to the bit to the port's CPU run of the
    same inputs, their PNGs read back equal to ``to_uint8``;
    ``vis_keypoints`` (arrows and lines) and ``vis_recon`` at the CLI's
    shape (4 videos x 10 frames, K 24, G 64) equal to the bit to the CPU,
    their GIFs decoded equal to the frames; the generation (its first
    sample, ``RENDER_GEN_SAMPLES``: the run's time limit) and
    interpolation output sets of the apps phase's results and the retarget
    sets (10 frames) of its 4096-point surfel target and of a textured OBJ
    the script writes (a PNG texture), then of a smaller textured sphere
    whose texture is a JPEG fixture (a fresh retarget: K1 and K2 forward)
    and of its twin textured with that fixture's expected pixels written
    as a PNG (the same retarget), the two sets' PNGs equal to the bit, and
    the same for a sphere textured with the 1024 x 1024 lossless WebP;
    every PNG and GIF decoded by this
    script's own readers (zlib; LZW): frame counts, sizes, delays, loops,
    each GIF frame within 3/255 mean of its PNG; ms per ``vis_*`` call, per
    rendered frame and per retarget set, split into host (normals,
    samples), card and PNG/GIF encoding; ``extract_skeleton_device`` on the
    card equal to the bit to the host extraction on the train phase's
    trained affinity and on seeded random and tie-heavy affinities at K
    24, its ms and device operations a call;
17. the detector's option sets (``OPTION_SETS``: const_intensity 0, 1, 2
    and 4, affinity_ver 0, 1, 2 and 4, graph_loss_ver 0 and 2, the
    gaussian and no volume fit, max and sum pooling, learned sigmas,
    keypoints_graph none) at the full AIST width in bfloat16: per set a
    few detector steps through ``Trainer`` (p50, peak memory, K1, K2
    forward and backward where the volume fit is chamfer, K3 on the conv
    route for the conv-route set), three pruned stream windows where the
    JAX stream runs the set (K1 once a window, no K2), a float32 step
    card against CPU at a small width, and for affinity_ver 4 the Gumbel
    draw following the generator passed; the float32 card and CPU
    gradients are each held against the port's float64 run on the CPU,
    the card no further from it than a stated multiple of the CPU's
    distance, and for the GroupNorm whose card gradient of set C lies
    furthest from float64 its input, output gradient and weight gradient
    alone (``cudnn.deterministic`` off and on) against float64;
18. the rematerialised detector (``cfg.remat``): a float32 small-width
    step at remat 1 and 2 against the nearest of six remat 0 steps on
    the card, no further than those are from each other; a routed bf16
    B 4 step at remat 0, 1 and 2, whose K3 launches equal
    :func:`routed_remat_launches` (48, 96, 140); bf16 AIST-width detector
    steps through ``Trainer`` at B 6 and 12 (T 10, ``grad_accum`` 1) at
    each value: step ms (p50 after the first) and the peak allocated and
    reserved GiB, whose slopes per folded frame reckon B 24 (240 frames,
    the JAX package's configuration); remat 1 and 2 then run at B 24, or
    at the largest B whose reserved peak the slope reckons under
    ``REMAT_CAP_GIB``;
19. the flagship orchestrator (``cli.flagship``) on the card at the
    flagship's widths (grid 64, K 24, feat 128, bfloat16, B 24 with
    grad_accum 2 then 4, T 10 then 20) on 96 synthetic sequences, 2
    epochs a phase, each phase a ``cli.train`` process, then its three
    demo CLIs: the files of both phases with finite losses, the dynamics
    phase started from the exported detector and kept frozen to the bit,
    the demos' outputs, the summary's keys, each phase's launches of K1
    and K2 (``FLAGSHIP_LAUNCHES``, derived there); seconds per epoch, step
    p50 through the loader, peak memory per phase and the detector step's
    model-FLOPs utilisation;
20. the distributed layer (``parallel/``, ``Trainer(mesh=...)``): the
    training CLI in a process group of one over NCCL
    (``--num_processes 1 --coordinator_address localhost:<port>``) at the
    CPU tests' width, its files, finite losses and launches; two processes
    on the one card over gloo (NCCL refuses two ranks on one device) in
    ``data 2`` and in ``model 2``: each rank's float32 detector- and
    learner-phase step (grad_accum 2) against the one-process card step
    within stated tolerances, the generator states equal to the bit and
    the ranks' parameters equal to each other's; and per topology six
    bfloat16 AIST-width detector steps (B 4, T 10, N 4096): step p50
    against one process, the ms of the gradient ``all_reduce`` and the
    launches of K1 and K2 on each rank. The two processes share one card
    and gloo copies through the host: these times measure neither NCCL nor
    two cards.

It prints a ``{"kernels": [...]}`` line (K2 forward's record with its
launches on the apps, K3's with its launches on the generate step, K1's,
K2's and K3's with their launches under the CLI), a
``{"conv3d_shapes": [...]}`` line, a ``{"stream": ...}`` and a
``{"stream_conv_kernel": ...}`` line, a ``{"profile": ...}`` line, a
``{"train": ...}`` line, an ``{"apps": ...}`` line, a ``{"cli": ...}``
line, a ``{"textures": ...}`` line, a ``{"render": ...}`` line, an
``{"options": ...}`` line, a ``{"remat": ...}`` line (K3's record carries
``launches_remat``), a
``{"flagship": ...}`` line (K1's and K2's records carry
``launches_flagship`` per phase), a ``{"distributed": ...}`` line (K1's
and K2's records carry ``launches_distributed`` per topology and rank, and
K1's, K2's and K3's ``launches_pruned_stream``), the card's line, and
last ``{"ok": true, "device": {...}}``. Without a card, or without the
package beside it, it exits nonzero before printing a result.

    python3 chip_smoke.py --stream-compare ROOT [ROOT ...]

runs, for each checkout ROOT in turn (e.g. the parent unpacked from
``git archive`` and this one), that checkout's own stream phase and
serving profile, route off and on, in a process of its own, and prints a
``{"stream_compare": [...]}`` line.

    python3 chip_smoke.py --distributed-cards

needs four cards: the distributed layer over NCCL with one process per
card (``distributed_cards``), and a ``{"distributed_cards": ...}`` line.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, fp32 outside the
# tensor cores, dense bf16 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12

SERVE_B, SERVE_T, SERVE_N = 4, 10, 4096
STREAM_WINDOWS = 16
SAMPLE_NUM = 10
ROUTED_CONVS = 48   # convs per detector forward on the conv route, AIST
PORT_KERNELS = ("voxelize_kernel", "chamfer_", "conv3d_kernel",
                "groupnorm_act")


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


PROFILER_GAP_S = 0.05


def profiler_gap():
    """An idle gap at the edges of a recorded round. The profiler keeps
    only the device operations whose start it places inside the round, and
    it can place the first operations launched after the round opens
    before it, dropping them (``scripts/profiler_k1_count.py``); a round
    that opens and closes on an idle card loses none."""
    import torch
    torch.cuda.synchronize()
    time.sleep(PROFILER_GAP_S)


def device_events(fn, n=10, attempts=3):
    """The device operations of ``n`` calls of ``fn`` under
    ``torch.profiler`` (not the ``ProfilerStep`` span the schedule adds).
    The profiler records a first round of ``n`` calls as warm-up and drops
    it, and the recorded round opens and closes with ``profiler_gap``:
    otherwise it can miss the device operations of the first calls (up to
    all of them for a call of a few microseconds), which undercounts a
    device time per call. A round that still holds fewer kernels than it
    holds host ``cudaLaunchKernel`` records lost some of them, and is
    recorded again, up to ``attempts`` rounds in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            prof.step()
            profiler_gap()
            for _ in range(n):
                fn()
            profiler_gap()
        events = prof.events()
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")]
        kernels = sum(not e.name.startswith(("Memcpy", "Memset"))
                      for e in dev)
        launches = sum(e.device_type == DeviceType.CPU
                       and e.name.startswith("cudaLaunchKernel")
                       for e in events)
        if kernels >= launches:
            return dev
        log(f"[profiler] round {attempt} of {attempts} recorded {kernels} "
            f"kernels of {launches} launches")
    raise AssertionError(f"the profiler lost kernels in each of {attempts} "
                         f"rounds")


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
        log(f"[build] {name}: {info['seconds']:.2f} s")
        for ln in info["log"].splitlines():
            if "registers" in ln or "bytes stack" in ln or "smem" in ln:
                log(f"[build]   {ln.strip()}")
    log(f"[build] all kernels and the host data library in {wall:.2f} s "
        "(parallel nvcc and g++)")
    for name in kernels.SOURCES + kernels.HOST_SOURCES:
        kernels.library(name)
    return wall


def k1_cases(G, seed=5):
    """name -> (F, N, 3) float32 points for K1's checks at grid G: the edge
    cases of ``voxel_edge_cases``, NaN and +-inf on one axis, empty (N =
    0) and one-point clouds, every point in one voxel (all on one word of
    one block's mask), and F = 1, 3 and 40 random clouds. K1 runs eight
    blocks per frame, each owning a range of its voxels; at G = 5 the last
    four own none."""
    g = np.random.default_rng(seed + G)
    step = np.float32(2.0 / G + 1e-5)
    nonfinite = g.uniform(-0.9, 0.9, (3, 90, 3))
    for axis in range(3):
        nonfinite[axis, 0::3, axis] = np.nan
        nonfinite[axis, 1::3, axis] = np.inf if axis % 2 else -np.inf
    centre = (g.integers(0, G, (40, 1, 3)) + 0.5) * float(step) - 1.0
    cases = voxel_edge_cases(G)
    cases.update({
        "nonfinite": nonfinite,
        "empty_f3": np.zeros((3, 0, 3)),
        "one_point_f1": g.uniform(-0.9, 0.9, (1, 1, 3)),
        "one_voxel_f40": centre + g.uniform(-0.2, 0.2, (40, 500, 3)) *
        float(step),
        "random_f1": g.uniform(-1.05, 1.05, (1, 4096, 3)),
        "random_f3": g.uniform(-1.05, 1.05, (3, 1001, 3)),
        "random_f40": g.uniform(-1.05, 1.05, (40, 333, 3)),
    })
    return {k: np.ascontiguousarray(v, dtype=np.float32)
            for k, v in cases.items()}


def _k1_bits(t):
    import torch
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def phase_k1(device, grids=(5, 16, 32, 64)):
    """K1 against its plain version and the numpy oracle, exactly equal, at
    every grid of ``grids`` on ``k1_cases`` (and, at G = 64, the serving
    shape (4, 10, 4096, 3)), float32 and bfloat16. Per case: the kernel into
    an output poisoned with NaN, at the allocation's start and one element
    past it (no 16-byte alignment, so the scalar head and tail run), must
    write every element and nothing around it; two calls of ``voxelize``
    give the same bits. Returns the max abs difference from the plain
    version (0.0)."""
    import torch
    from neural_marionette_tpu_torch.ops import voxelize as V
    worst, n_checked = 0.0, 0
    for G in grids:
        cases = k1_cases(G)
        if G == 64:
            cases["serving"] = serving_points(SERVE_B, SERVE_T, SERVE_N,
                                              seed=11)
        for name, pts in cases.items():
            p = torch.from_numpy(pts).to(device)
            want = voxelize_oracle(pts, G)
            shape = pts.shape[:-2] + (G,) * 3 + (1,)
            n = int(np.prod(shape))
            for dtype in (torch.float32, torch.bfloat16):
                plain = V.voxelize_plain(p, G, dtype=dtype)
                got = V.voxelize(p, G, dtype=dtype)
                again = V.voxelize(p, G, dtype=dtype)
                if got.dtype != dtype or got.shape != shape:
                    raise AssertionError(f"K1 {name} G={G}: {got.dtype} "
                                         f"{tuple(got.shape)}")
                outs = {"fresh": got}
                for offset in (0, 1):
                    buf = torch.full((n + 2,), float("nan"), dtype=dtype,
                                     device=device)
                    out = buf[offset:offset + n].view(shape)
                    outs[f"poisoned+{offset}"] = V._voxelize_into(p, G, out)
                    rest = torch.cat([buf[:offset], buf[offset + n:]])
                    if not torch.isnan(rest).all():
                        raise AssertionError(f"K1 {name} G={G} {dtype}: "
                                             f"wrote outside its output")
                if not torch.equal(_k1_bits(got), _k1_bits(again)):
                    raise AssertionError(f"K1 {name} G={G} {dtype}: two "
                                         f"calls differ")
                for tag, o in outs.items():
                    if not torch.equal(_k1_bits(o), _k1_bits(plain)):
                        bad = int((_k1_bits(o) != _k1_bits(plain)).sum())
                        raise AssertionError(
                            f"K1 {name} G={G} {dtype} {tag}: {bad} elements "
                            f"differ from the plain version")
                worst = max(worst, float((got.float() - plain.float())
                                         .abs().max()) if n else 0.0)
                if not np.array_equal(got.float().cpu().numpy(), want):
                    raise AssertionError(f"K1 {name} G={G} {dtype}: differs "
                                         f"from the numpy oracle")
                n_checked += 1
            if G == 64 or name == "random_f40":
                log(f"[K1] G={G} {name} {tuple(pts.shape)}: equal to the "
                    f"bit ({int(want.sum())} occupied voxels)")
    log(f"[K1] {n_checked} (grid, case, dtype) checks equal to the bit, "
        f"poisoned and misaligned outputs written in full, repeatable")
    return worst


def k2_edge_frames(G, tile, seed):
    """(4, G^3) float32 occupancy of K2's edge frames: empty; occupied (at
    about 30 %) only inside one tile of the kernel (``tile`` voxels, the
    last whole one); fully occupied; about 5 % occupied at random. At G=5
    (one ragged tile) the second frame is 60 % at random."""
    g = np.random.default_rng(seed)
    G3 = G ** 3
    occ = np.zeros((4, G3), np.float32)
    if G3 > tile:
        t0 = (G3 // tile - 1) * tile
        occ[1, t0:t0 + tile] = g.random(tile) < 0.3
    else:
        occ[1] = g.random(G3) < 0.6
    occ[2] = 1.0
    occ[3] = g.random(G3) < 0.05
    return occ


def k2_edge_keypoints(G, K, seed):
    """(4, K, 3) keypoints for k2_edge_frames: uniform in [-0.9, 0.9]; at
    G=5 on the 0.25 grid, so that with the exact voxel centres every dmin,
    tie and sum is exact in float32."""
    g = np.random.default_rng(seed)
    if G == 5:
        return (g.integers(-4, 5, (4, K, 3)) * 0.25).astype(np.float32)
    return g.uniform(-0.9, 0.9, (4, K, 3)).astype(np.float32)


def _check_k2_fwd(kp, o, G, tag):
    """K2 forward on (kp, o) against its plain version: rtol 1e-5 (float32
    sums of up to G^3 terms in different orders), and two kernel runs equal
    to the bit. Returns (the max rel err, num)."""
    import torch
    from neural_marionette_tpu_torch.ops import losses as L
    M = kp.shape[0]
    a = L.chamfer_num(kp, o, G)
    b = L.chamfer_num(kp, o, G)
    plain = L.chamfer_num_plain(kp, o, G)
    if a.shape != (M,) or a.dtype != torch.float32:
        raise AssertionError(f"K2 {tag}: {a.dtype} {tuple(a.shape)}")
    if not torch.equal(a, b):
        raise AssertionError(f"K2 {tag}: two runs differ")
    rel = float(((a - plain).abs() / plain.abs().clamp(min=1e-6)).max())
    if not rel <= 1e-5:
        raise AssertionError(f"K2 {tag}: max rel err {rel:.3e} > 1e-5")
    return rel, a


def phase_k2(device, G, M, K):
    """K2 forward against its plain version (``_check_k2_fwd``) at the
    serving shape on the path's occupancy and a dense one, then on the edge
    frames (``k2_edge_frames``: empty, one tile, full, sparse) at G and at
    G=5 for K = 1, 24 and 64, float32 and bfloat16. On G=5 the kernel, the
    plain version on the card and on the CPU give equal num to the bit."""
    import torch
    from neural_marionette_tpu_torch import kernels
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
            rel, _ = _check_k2_fwd(kp, occ.to(dtype).contiguous(), G,
                                   f"{occ_name} {dtype}")
            log(f"[K2] {occ_name} occupancy {dtype}: max rel err {rel:.3e}, "
                f"bitwise repeatable")
    tile = kernels.library("chamfer").nm_chamfer_tile_voxels()
    for Ge in (G, 5):
        occ = torch.from_numpy(k2_edge_frames(Ge, tile, 7)).to(device)
        for Ke in (1, 24, 64):
            kpe = torch.from_numpy(k2_edge_keypoints(Ge, Ke, 8)).to(device)
            for dtype in (torch.float32, torch.bfloat16):
                o = occ.to(dtype)
                rel, a = _check_k2_fwd(kpe, o, Ge,
                                       f"edges G={Ge} K={Ke} {dtype}")
                if float(a[0]) != 0.0:
                    raise AssertionError(f"K2 edges G={Ge} K={Ke}: empty "
                                         f"frame num {float(a[0])}")
                if Ge == 5 and not (
                        torch.equal(a, L.chamfer_num_plain(kpe, o, Ge)) and
                        torch.equal(a.cpu(), L.chamfer_num_plain(
                            kpe.cpu(), o.cpu(), Ge))):
                    raise AssertionError(f"K2 G=5 K={Ke} {dtype}: kernel, "
                                         f"plain on the card and CPU differ")
            log(f"[K2] edges G={Ge} K={Ke} (empty, one tile, full, sparse), "
                f"float32 and bfloat16: max rel err {rel:.3e}, bitwise "
                f"repeatable" + (", equal to plain on the card and CPU"
                                 if Ge == 5 else ""))


def _dkp_scale(g, kp, occ, G):
    """(scale (M, K, 1), reach (M,)): per (m, k) the sum of the magnitudes
    of the terms of dkp_k = 2 c_k S_k - 2 P_k, 2 |c_k| sum_v |W_k(v)| + 2
    sum_v |W_k(v)| |v| with the plain version's weights
    (``losses._frame_bwd_weights``; a float32 sum of n terms errs by up
    to about n 2^-24 of it); and per frame the most that moving one voxel's
    weight from one nearest keypoint to another changes a dkp entry,
    2 |g_m| max_v sqrt(relu(dmin(v))) over the occupied voxels."""
    import torch
    from neural_marionette_tpu_torch.ops.coords import coord_maps
    from neural_marionette_tpu_torch.ops.losses import _frame_bwd_weights
    V = coord_maps((G,) * 3, device=kp.device).reshape(-1, 3)
    v2 = (V * V).sum(-1)
    out, reach = [], []
    for m in range(kp.shape[0]):
        c = kp[m]
        W, dmin = _frame_bwd_weights(V, v2, c, occ[m], g[m])
        W = W.abs()
        out.append(2.0 * c.abs() * W.sum(0)[:, None] + 2.0 * (W.T @ V.abs()))
        far = torch.where(occ[m] != 0, dmin.clamp(min=0.0), 0.0).max()
        reach.append(2.0 * g[m].abs() * far.sqrt())
    return torch.stack(out), torch.stack(reach)


def _check_k2_bwd(gr, kp, o, G, tag):
    """K2 backward on (gr, kp, o) against its plain version on the card
    (tolerances: ``phase_k2_bwd``). Returns (dkp max abs err, its share of
    the terms' magnitude, entries with a near-tie voxel moved, docc max abs
    err, dkp, docc)."""
    import torch
    from neural_marionette_tpu_torch.ops import losses as L
    M, K = kp.shape[:2]
    dtype = o.dtype
    gmax = float(gr.abs().max())
    dkp0, none = L._chamfer_bwd_cuda(gr, kp, o, G, False)
    dkp, docc = L._chamfer_bwd_cuda(gr, kp, o, G, True)
    dkp2, docc2 = L._chamfer_bwd_cuda(gr, kp, o, G, True)
    pk, po = L.chamfer_num_bwd_plain(gr, kp, o, G)
    if none is not None or docc.dtype != dtype or dkp.shape != (M, K, 3):
        raise AssertionError(f"K2 bwd: {docc.dtype} {dkp.shape}")
    if not (torch.equal(dkp, dkp2) and torch.equal(docc, docc2)):
        raise AssertionError(f"K2 bwd {tag}: two runs differ")
    if not torch.equal(dkp0, dkp):
        raise AssertionError(f"K2 bwd {tag}: dkp with and without docc "
                             f"differ")
    scale, reach = _dkp_scale(gr, kp, o, G)
    diff = (dkp - pk).abs()
    ek = float(diff.max())
    over = diff > 1e-5 * pk.abs() + 2e-5 * scale
    n_over = int(over.any(dim=-1).sum())
    moved = bool((diff <= reach[:, None, None]).all())
    if n_over > M * K // 100 or not moved:
        raise AssertionError(f"K2 bwd {tag}: dkp max abs err {ek:.3e}; "
                             f"{n_over} of {M * K} entries over the rounding "
                             f"bound, within one moved voxel: {moved}")
    er = float((torch.where(over, 0.0, diff) / scale.clamp(min=1e-30)).max())
    rtol = 8e-3 if dtype == torch.bfloat16 else 0.0
    eo = float((docc.float() - po.float()).abs().max())
    if not torch.allclose(docc.float(), po.float(), rtol=rtol,
                          atol=4e-6 * gmax):
        raise AssertionError(f"K2 bwd {tag}: docc max abs err {eo:.3e}")
    return ek, er, n_over, eo, dkp, docc


def phase_k2_bwd(device, G, M, K):
    """K2 backward against its plain version on the card
    (``_check_k2_bwd``). dkp within rtol 1e-5 plus 2e-5 of the magnitude
    of its summed terms (``_dkp_scale``): dkp_k = 2 c_k S_k - 2 P_k cancels
    two sums of up to ~10^3 at G=64, and the kernel adds a frame's terms in
    a few hundred sequential steps (segments, tiles), the plain version in
    a matmul's order; 2e-5 is 300 * 2^-24. (At tests/test_pallas.py's G=32
    this is near its atol 1e-4.) Beyond that, at most 1 % of the (m, k)
    entries may differ by up to one voxel's weight moved between two
    keypoints (``_dkp_scale``'s reach): a voxel within an ulp of a tie can
    have another nearest keypoint under the kernel's FMA rounding of v.c
    than under the plain matmul's. docc within atol 4e-6 * max|g| (float32)
    and, in bfloat16, one bfloat16 rounding of g * relu(dmin) (rtol 8e-3):
    the kernel's FMAs round v.c otherwise than the plain matmul, and one ulp
    of dmin moves g * relu(dmin) by ~1e-6 (tests/test_pallas.py:167-173).
    Both modes (with and without docc) give the same dkp to the bit, two
    runs agree to the bit. Cases: the serving shape on the path's occupancy
    and a dense one; the edge frames (``k2_edge_frames``: empty, one tile,
    full, sparse; an empty frame's dkp exactly 0) at G and at G=5 for K =
    1, 24 and 64 (at G=5, whose keypoints lie on the 0.25 grid, docc is
    exact and equal on the card, in the plain version on the card and on
    the CPU; dkp is not: a tie of 3 or 5 keypoints makes the weights
    inexact, and then the sums' orders round apart); and a G=5 grid, whose
    voxel centres are exact in float32, with ties and dmin == 0, where the
    kernel, the plain version on the card and on the CPU are equal.
    Returns the max abs dkp error at the training shape, bfloat16
    occupancy."""
    import torch
    from neural_marionette_tpu_torch import kernels
    from neural_marionette_tpu_torch.ops import losses as L
    from neural_marionette_tpu_torch.ops import voxelize as V
    g = np.random.default_rng(6)
    kp = torch.from_numpy(g.uniform(-0.9, 0.9, (M, K, 3)).astype(
        np.float32)).to(device)
    gr = torch.from_numpy(g.uniform(-2.0, 2.0, M).astype(np.float32)).to(
        device)
    pts = serving_points(1, M, SERVE_N, seed=13).reshape(M, SERVE_N, 3)
    path_occ = V.voxelize(torch.from_numpy(pts).to(device), G).reshape(M, -1)
    dense_occ = torch.from_numpy(
        (g.random((M, G ** 3)) < 0.3).astype(np.float32)).to(device)
    err_train = None
    for occ_name, occ in (("path", path_occ), ("dense", dense_occ)):
        for dtype in (torch.float32, torch.bfloat16):
            o = occ.to(dtype).contiguous()
            ek, er, n_over, eo, _, _ = _check_k2_bwd(gr, kp, o, G,
                                                     f"{occ_name} {dtype}")
            if occ_name == "path" and dtype == torch.bfloat16:
                err_train = ek
            log(f"[K2 bwd] {occ_name} occupancy {dtype}: dkp max abs err "
                f"{ek:.3e} ({er:.3e} of the terms' magnitude, {n_over} of "
                f"{M * K} entries with a near-tie voxel moved), docc "
                f"{eo:.3e}; bitwise repeatable")
    tile = kernels.library("chamfer").nm_chamfer_tile_voxels()
    ge = torch.tensor([1.5, -0.75, 0.5, 2.0], device=device)
    for Ge in (G, 5):
        occ = torch.from_numpy(k2_edge_frames(Ge, tile, 7)).to(device)
        for Ke in (1, 24, 64):
            kpe = torch.from_numpy(k2_edge_keypoints(Ge, Ke, 8)).to(device)
            for dtype in (torch.float32, torch.bfloat16):
                o = occ.to(dtype)
                tag = f"edges G={Ge} K={Ke} {dtype}"
                ek, er, n_over, eo, dkp, docc = _check_k2_bwd(ge, kpe, o, Ge,
                                                              tag)
                if bool(dkp[0].any()):
                    raise AssertionError(f"K2 bwd {tag}: empty frame's dkp "
                                         f"not 0")
                if Ge == 5:
                    want = L.chamfer_num_bwd_plain(ge.cpu(), kpe.cpu(),
                                                   o.cpu(), Ge)[1]
                    plain = L.chamfer_num_bwd_plain(ge, kpe, o, Ge)[1]
                    if not (torch.equal(docc.cpu(), want) and
                            torch.equal(plain.cpu(), want)):
                        raise AssertionError(f"K2 bwd {tag}: docc of the "
                                             f"kernel, plain on the card and "
                                             f"CPU differ")
            log(f"[K2 bwd] edges G={Ge} K={Ke} (empty, one tile, full, "
                f"sparse), float32 and bfloat16: dkp max abs err {ek:.3e} "
                f"({n_over} entries with a near-tie voxel moved), docc "
                f"{eo:.3e}; bitwise repeatable" +
                (", docc equal to plain on the card and CPU" if Ge == 5
                 else ""))
    # exact conventions: duplicate keypoints, keypoints on voxel centres
    Gc = 5
    kpc = torch.tensor([[[0.5, 0.5, 0.5], [0.5, 0.5, 0.5], [-1.0, 0.0, 0.5],
                         [0.25, -0.5, 0.0], [0.75, -0.5, 0.0]],
                        [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 0.0, 0.0],
                         [-0.25, 0.5, -1.0], [-0.75, 0.5, -1.0]]])
    occc = torch.from_numpy((np.random.default_rng(9).random((2, Gc ** 3))
                             < 0.6).astype(np.float32))
    occc[:, [31, 62, 93, 112]] = 1.0
    gc = torch.tensor([1.5, -0.75])
    want = L.chamfer_num_bwd_plain(gc, kpc, occc, Gc)
    on_card = [t.to(device) for t in (gc, kpc, occc)]
    for name, got in (("kernel", L._chamfer_bwd_cuda(*on_card, Gc, True)),
                      ("plain on the card",
                       L.chamfer_num_bwd_plain(*on_card, Gc))):
        for a, b in zip(got, want):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"K2 bwd G=5 conventions: {name} "
                                     f"differs from the CPU")
    log("[K2 bwd] G=5 ties and dmin == 0: kernel, plain on the card and "
        "CPU equal")
    return err_train


def bf16_ulp(v):
    """The spacing of bfloat16 values at the magnitudes ``v`` (float32): a
    value in [2^(e-1), 2^e) has 8 significant bits, so ulp 2^(e-8)."""
    import torch
    _, e = torch.frexp(v)
    return torch.ldexp(torch.ones_like(v), e - 8)


def routed_conv_inputs(det, vox, keep=None):
    """Run ``det`` (a detector with ``conv_kernel=True``) on ``vox`` with
    ``ops.conv3d.conv3d`` wrapped: returns (a Counter of the routed convs'
    (x shape, w shape), the x of each call for which ``keep(x, w)`` holds)."""
    import collections
    import torch
    from neural_marionette_tpu_torch.ops import conv3d as K3
    seen, kept = collections.Counter(), []
    original = K3.conv3d

    def recording(x, w, b, packed=None):
        seen[(tuple(x.shape), tuple(w.shape))] += 1
        if keep is not None and keep(x, w):
            kept.append(x)
        return original(x, w, b, packed)

    K3.conv3d = recording
    try:
        with torch.inference_mode():
            det(vox)
    finally:
        K3.conv3d = original
    return seen, kept


def _conv_operands(shape, cout, dtype, device, seed, channels_first=True):
    """x (F, D, H, W, Cin) N(0, 1) in ``dtype`` (stored NCDHW, as the
    model's activations, unless ``channels_first`` is False), w N(0,
    1/fan_in), b N(0, 0.05)."""
    import torch
    g = torch.Generator(device).manual_seed(seed)
    Fr, D, H, W, Cin = shape
    if channels_first:
        x = torch.randn((Fr, Cin, D, H, W), generator=g, device=device,
                        dtype=dtype).permute(0, 2, 3, 4, 1)
    else:
        x = torch.randn(shape, generator=g, device=device, dtype=dtype)
    w = torch.randn((3, 3, 3, Cin, cout), generator=g,
                    device=device) * (27 * Cin) ** -0.5
    b = torch.randn((cout,), generator=g, device=device) * 0.05
    return x, w, b


def phase_k3(device, det, vox):
    """K3 against its plain version on the card at every distinct routed
    conv shape of one AIST window, bfloat16, activations stored NCDHW as in
    the model: within one bfloat16 ulp of the larger magnitude plus 1e-5
    of the largest |plain| (both sum the same exact bf16 products in
    float32, in other orders, then round once), and two launches equal to
    the bit. Also a float32-x case (the output stays float32: 1e-5 of the
    largest |plain|) and a channels-last input, and, as
    tests/test_pallas.py:77 does, z-asymmetric content at the z faces.
    Returns (the routed shapes Counter, max abs err over the bf16 cases)."""
    import torch
    from neural_marionette_tpu_torch.ops import conv3d as K3
    shapes, _ = routed_conv_inputs(det, vox)
    if sum(shapes.values()) != ROUTED_CONVS:
        raise AssertionError(f"{sum(shapes.values())} routed convs per AIST "
                             f"window, want {ROUTED_CONVS}: {shapes}")
    worst = 0.0
    cases = [(xs, ws[-1], torch.bfloat16, True) for xs, ws in sorted(shapes)]
    cases += [((40, 16, 16, 16, 64), 64, torch.float32, True),
              ((40, 2, 2, 2, 72), 72, torch.float32, True),
              ((4, 8, 8, 8, 48), 72, torch.bfloat16, False)]
    for i, (xs, cout, dtype, cf) in enumerate(cases):
        x, w, b = _conv_operands(xs, cout, dtype, device, 70 + i, cf)
        if i == 0:   # z-asymmetric content: every z plane its own scale
            x = x * torch.arange(1, xs[1] + 1, device=device,
                                 dtype=dtype)[None, :, None, None, None]
        a = K3.conv3d(x, w, b)
        a2 = K3.conv3d(x, w, b)
        p = K3.conv3d_plain(x, w, b)
        torch.cuda.synchronize()
        if a.dtype != dtype or a.shape != xs[:4] + (cout,):
            raise AssertionError(f"K3 {xs}->{cout}: {a.dtype} "
                                 f"{tuple(a.shape)}")
        if not torch.equal(a, a2):
            raise AssertionError(f"K3 {xs}->{cout} {dtype}: two runs differ")
        af, pf = a.float(), p.float()
        err = (af - pf).abs()
        top = float(pf.abs().max())
        if dtype == torch.bfloat16:
            tol = bf16_ulp(torch.maximum(af.abs(), pf.abs())) + 1e-5 * top
            worst = max(worst, float(err.max()))
        else:
            tol = 1e-5 * top
        if not bool((err <= tol).all()):
            raise AssertionError(f"K3 {xs}->{cout} {dtype}: max abs err "
                                 f"{float(err.max()):.3e} over its bound "
                                 f"(max |plain| {top:.3e})")
        n_diff = int((a != p).sum())
        log(f"[K3] {xs}->{cout} {str(dtype)[6:]} "
            f"{'NCDHW' if cf else 'NDHWC'} x {shapes.get((xs, (3, 3, 3, xs[-1], cout)), 0)}"
            f"/window: max abs err {float(err.max()):.3e} (max |plain| "
            f"{top:.3e}, {n_diff} of {a.numel()} differ), bitwise "
            f"repeatable")
        del x, a, a2, p, af, pf, err
    return shapes, worst


def decoder_stage_inputs(det, vox):
    """The inputs of the decoder's two 64^3 stages (stage 2: C/2 -> C/4,
    stage 3: C/4 -> C/4) on ``vox``: logical NDHWC bfloat16 views, as the
    route hands them to K3."""
    G = vox.shape[2]
    _, kept = routed_conv_inputs(det, vox, keep=lambda x, w: x.shape[1] == G)
    if len(kept) != 2:
        raise AssertionError(f"{len(kept)} routed 64^3 decoder convs")
    return kept


def phase_k4(device, det, vox):
    """K4 on the decoder's 64^3 stage inputs of one AIST window (as
    ``scripts/bench_fusedstage.py`` drives the JAX kernel, at F=40, 64->32
    and 32->32), with the model's own stage weights. The two entry calls
    are counted; then, against its plain version and against the model's
    own stage (its K3 conv, GroupNorm in float32 over the bf16-stored conv
    output, LeakyReLU, float32 out): max abs err within 2^-6 of the largest
    |reference| (a bf16 rounding of the conv output, carried by the
    GroupNorm's gain of about 1, and one of the output, at the scale of the
    unit-variance output), and two launches equal to the bit; then each
    pass alone (``check_k4_passes``). Returns (launches in the entry run,
    max abs err against the plain version, the stages' inputs)."""
    import torch
    from neural_marionette_tpu_torch.models.blocks import (conv, leaky_relu,
                                                           norm)
    from neural_marionette_tpu_torch.ops import fusedstage as K4
    xs = decoder_stage_inputs(det, vox)
    d = det.kypt_to_vox.decode_voxel_from_combined_representation
    stages = []
    for x, (ci, gi) in zip(xs, ((8, 9), (11, 12))):
        w = d[ci].weight.detach().to(torch.bfloat16).permute(2, 3, 4, 1, 0)
        stages.append((x, w, d[ci].bias.detach(), d[gi].weight.detach(),
                       d[gi].bias.detach(), d[ci], d[gi]))
    K4.launches = K4.pass2_launches = 0
    with torch.inference_mode():
        outs = [K4.fused_stage(*s[:5]) for s in stages]
    torch.cuda.synchronize()
    launches, pass2 = K4.launches, K4.pass2_launches
    if launches != 2 or pass2 != 2:
        raise AssertionError(f"K4 entry run launches {launches}, pass 2 "
                             f"{pass2}, want 2 and 2")
    worst = 0.0
    with torch.inference_mode():
        for i, ((x, w, b, sc, bi, cm, gm), a) in enumerate(zip(stages, outs)):
            a2 = K4.fused_stage(x, w, b, sc, bi)
            if not torch.equal(a, a2):
                raise AssertionError(f"K4 stage {i + 2}: two runs differ")
            del a2
            p = K4.fused_stage_plain(x, w, b, sc, bi)
            model = leaky_relu(norm(gm, conv(cm, x.permute(0, 4, 1, 2, 3),
                                             torch.bfloat16, True)))
            model = model.permute(0, 2, 3, 4, 1)
            for name, ref in (("plain", p), ("model stage", model)):
                err = float((a.float() - ref.float()).abs().max())
                top = float(ref.float().abs().max())
                if name == "plain":
                    worst = max(worst, err)
                if not err <= 2 ** -6 * top:
                    raise AssertionError(f"K4 stage {i + 2} vs {name}: max "
                                         f"abs err {err:.3e}, max |ref| "
                                         f"{top:.3e}")
                log(f"[K4] stage {i + 2} {tuple(x.shape)}->{w.shape[-1]} vs "
                    f"{name}: max abs err {err:.3e} (max |ref| {top:.3e})")
            del p, model
    log(f"[K4] entry run: {launches} launches, the pass-2 kernel {pass2}; "
        f"bitwise repeatable")
    with torch.inference_mode():
        for i, (x, w, b, sc, bi, _, _) in enumerate(stages):
            check_k4_passes(x, w, b, sc, bi, f"stage {i + 2}")
    return launches, worst, stages


def check_k4_passes(x, w, b, sc, bi, tag):
    """K4's passes one by one on the card. Pass 1's moment partials against
    ``brick_partials_plain`` of the plain float32 conv: within 1e-4 of the
    brick's sum of |y| (and of y^2) — both sum the same voxels' float32
    values in other orders, so a partial of another brick or a lost voxel
    shows as an error of order 1. Pass 2 (``csrc/groupnorm.cu``) against
    its plain version ``_normalize`` on the same stored y and partials:
    within one ulp of x's dtype (both round ((y - mean) * inv) * scale +
    bias step by step in float32 and LeakyReLU once to x's dtype; the
    mean and inv are the same tensors), and two launches equal to the
    bit."""
    import torch
    from neural_marionette_tpu_torch.ops import conv3d as K3
    from neural_marionette_tpu_torch.ops import fusedstage as K4
    y, part = K3._launch(x, w, b, stats=True)
    yf = K3._conv_f32(x, w, b)
    want = K3.brick_partials_plain(yf)
    scale = K3.brick_partials_plain(yf.abs())[:, :, :1]
    del yf
    scale = torch.cat((scale, want[:, :, 1:]), dim=2)
    perr = float(((part - want).abs() / scale.clamp(min=1e-30)).max())
    if part.shape != want.shape or not perr <= 1e-4:
        raise AssertionError(f"K4 {tag} pass 1 partials {tuple(part.shape)} "
                             f"vs {tuple(want.shape)}: max error {perr:.3e} "
                             f"of the brick's sums")
    Fr, D, H, W, C = y.shape
    ng = max(C // 16, 1)
    tot = part.sum(dim=1)
    mean, inv = K4.group_stats(tot[:, 0], tot[:, 1], ng,
                               float(D * H * W * (C // ng)), 1e-5)
    a = K4.normalize(y, mean, inv, sc, bi)
    a2 = K4.normalize(y, mean, inv, sc, bi)
    p = K4._normalize(y, tot[:, 0], tot[:, 1], sc, bi, ng, 1e-5)
    torch.cuda.synchronize()
    if not torch.equal(a, a2):
        raise AssertionError(f"K4 {tag} pass 2: two runs differ")
    af, pf = a.float(), p.float()
    err = (af - pf).abs()
    ulp = bf16_ulp(torch.maximum(af.abs(), pf.abs())) if a.dtype == \
        torch.bfloat16 else torch.maximum(af.abs(), pf.abs()) * 2.0 ** -23
    if a.dtype != x.dtype or a.stride() != y.stride() or \
            not bool((err <= ulp).all()):
        raise AssertionError(f"K4 {tag} pass 2 vs _normalize: max abs err "
                             f"{float(err.max()):.3e}, {a.dtype}, strides "
                             f"{a.stride()}")
    log(f"[K4] {tag} pass 1 partials {tuple(part.shape)}: max error "
        f"{perr:.2e} of the brick's sums; pass 2 vs _normalize: max abs err "
        f"{float(err.max()):.3e} ({int((a != p).sum())} of {a.numel()} "
        f"differ), bitwise repeatable")


def _window_outputs(cfg, B, T):
    """The serving window's outputs, the stream's default: the pruned
    window (no decoder, no volume fit, no graph loss)."""
    K = cfg.nkeypoints
    return {"keypoints": (B, T, K, 4), "kypt_recon": (B, T, K, 4),
            "R": (B, T, K, 3, 3)}


def _all_outputs(cfg, B, T):
    """The window's outputs with ``recon`` and every loss scalar: the work
    the stream did for every window before it computed only its
    outputs."""
    G = cfg.grid_size
    out = _window_outputs(cfg, B, T)
    out["recon"] = (B, T, G, G, G, 1)
    for k in ("recon_loss", "vol_fit_reg", "separation_loss",
              "sparsity_loss", "local_const_loss", "time_const_loss",
              "sparsity_const_loss", "intensity_const_loss",
              "graph_traj_loss", "kl_kypt", "kypt_recon_loss"):
        out[k] = ()
    return out


def stream_launches(outputs, n_windows, conv_kernel):
    """The launches a stream of ``n_windows`` windows asking for
    ``outputs`` must make: K1 once a window (the voxelization); K2 forward
    once a window only for ``vol_fit_reg`` (the volume fit); K3, on the
    conv route, once per routed conv of the encoder (the feature and
    spatio-temporal nets, ``ROUTED_CONVS - ROUTED_DECODER_CONVS`` = 44)
    and of the decoder (4 more) only for ``recon`` or ``recon_loss``."""
    decoder = bool({"recon", "recon_loss"} & set(outputs))
    routed = ROUTED_CONVS - (0 if decoder else ROUTED_DECODER_CONVS)
    return {"voxelize": n_windows,
            "chamfer_fwd": n_windows if "vol_fit_reg" in outputs else 0,
            "conv3d": routed * n_windows if conv_kernel else 0}


def phase_stream(marionette, n_windows, conv_kernel=False, shapes=None):
    """A bfloat16 stream of serving windows asking for ``shapes``' keys
    (default: the pruned window, ``_window_outputs``), with the conv route
    off or on (``conv_kernel``); returns (host ms from the start to the
    first result and between consecutive results, {kernel: launches}, the
    results).

    Results come lag-1, so gap i (1 <= i <= n-2) is the time the stream
    takes for one window: the host queues window i+1 and waits for window
    i. The first gap pays set-up. The last (the flush) is no window's time:
    while the host sets the pace, the card has nearly finished the last
    window by the time the host asks for it."""
    from neural_marionette_tpu_torch.ops import conv3d as K3
    from neural_marionette_tpu_torch.ops import losses as L
    from neural_marionette_tpu_torch.ops import voxelize as V
    cfg = marionette.cfg
    if shapes is None:
        shapes = _window_outputs(cfg, SERVE_B, SERVE_T)
    windows = [serving_points(SERVE_B, SERVE_T, SERVE_N, seed=100 + i)
               for i in range(n_windows)]
    stamps = []
    results = []
    with marionette.stream(dtype="bfloat16", sample_num=SAMPLE_NUM,
                           outputs=tuple(shapes),
                           conv_kernel=conv_kernel) as s:
        V.launches = L.launches = K3.launches = 0
        t0 = time.perf_counter()
        for res in s.run(windows):
            stamps.append(time.perf_counter())
            results.append(res)
    got = {"voxelize": V.launches, "chamfer_fwd": L.launches,
           "conv3d": K3.launches}
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
    want = stream_launches(shapes, n_windows, conv_kernel)
    if got != want:
        raise AssertionError(f"launches over {n_windows} windows: {got}, "
                             f"want {want}")
    ms = np.diff([t0] + stamps) * 1e3
    tag = "stream conv_kernel" if conv_kernel else "stream"
    what = "pruned" if len(shapes) == 3 else f"{len(shapes)} outputs"
    log(f"[{tag}] {n_windows} windows {SERVE_B}x{SERVE_T}x{SERVE_N}x3 bf16 "
        f"({what}): ms to the first result and between results "
        f"{[round(float(x), 2) for x in ms]}")
    log(f"[{tag}] launches: K1 {got['voxelize']}, K2 {got['chamfer_fwd']}, "
        f"K3 {got['conv3d']}; outputs finite, shapes right")
    return ms, got, results


def stream_record(ms, n_windows, peak, card, **extra):
    """The steady gaps of a stream: neither the set-up gap nor the flush
    (``phase_stream``)."""
    steady = ms[1:-1]
    return {"windows": n_windows, "B": SERVE_B, "T": SERVE_T, "N": SERVE_N,
            "dtype": "bfloat16", "sample_num": SAMPLE_NUM,
            "mean_ms_per_window": float(steady.mean()),
            "p50_ms_per_window": float(np.percentile(steady, 50)),
            "gaps_ms": [float(x) for x in ms],
            "peak_device_memory_gib": peak, "card": card, **extra}


def compare_streams(routed, default, atol=2e-2):
    """The routed stream's keypoints against the default stream's on the
    same windows: within ``atol`` (5 bfloat16 ulps at the coordinates'
    magnitude 1: the two routes round the bf16 conv outputs apart at about
    one element in a thousand, by one ulp, and the soft-argmax averages
    them). Returns the max abs difference of keypoints and of kypt_recon."""
    kp = max(float(np.abs(a["keypoints"] - b["keypoints"]).max())
             for a, b in zip(routed, default))
    rec = max(float(np.abs(a["kypt_recon"] - b["kypt_recon"]).max())
              for a, b in zip(routed, default))
    log(f"[stream conv_kernel] against the default stream: keypoints max "
        f"abs diff {kp:.3e}, kypt_recon {rec:.3e}")
    if not kp <= atol:
        raise AssertionError(f"routed stream keypoints differ by {kp:.3e} "
                             f"> {atol}")
    return kp, rec


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


def _timed(batches, stamps):
    """Yield ``batches``, synchronising the card and stamping the host
    clock before each one and after the last: gap i is step i's time."""
    import torch
    for b in batches:
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        yield b
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())


def _busy(prof, wall_us):
    """(device busy ms, busy share, {port kernel: device ms}, {device
    operation: [us, calls]}): the union of the profiler's device intervals
    over the wall time, the device time of the port's own kernels (by their
    ``__global__`` names), and every device operation's time and calls."""
    from torch.autograd import DeviceType
    # not the ProfilerStep span a schedule adds on the device's timeline,
    # which covers the whole recorded round
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not e.name.startswith("ProfilerStep")]
    if not dev:
        raise AssertionError("the profiler recorded no device operation")
    busy, end = 0.0, -np.inf
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if e > end:
            busy += e - max(s, end)
            end = e
    ours = defaultdict(float)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
        if any(k in e.name for k in PORT_KERNELS):
            ours[e.name.split("(")[0].split("<")[0].split()[-1]] += \
                e.time_range.elapsed_us() / 1e3
    return busy / 1e3, busy / wall_us, dict(ours), dict(by_name)


def _calls_of(by_name, kernel):
    """Device operations recorded of the port's kernel ``kernel`` (its
    ``__global__`` name)."""
    return sum(calls for name, (_, calls) in by_name.items()
               if kernel in name)


def _top_kernels(by_name, n, per, k=12):
    """The ``k`` device operations that take the most time, per ``per``
    (window or step) over ``n`` of them."""
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:k]
    return [{"name": name[:90], f"ms_per_{per}": us / n / 1e3,
             f"calls_per_{per}": calls / n} for name, (us, calls) in top]


def _train_epoch(trainer, epoch, n_steps, seed, counts, T=SERVE_T,
                 B=SERVE_B):
    """One epoch of ``n_steps`` AIST-width point batches of ``B`` clips of
    ``T`` frames through ``Trainer.train_epoch``, the launch counters set
    to 0 just before it and read just after; returns (record, per-step ms,
    peak GiB)."""
    import torch
    from neural_marionette_tpu_torch.ops import conv3d as K3
    from neural_marionette_tpu_torch.ops import losses as L
    from neural_marionette_tpu_torch.ops import voxelize as V
    batches = [serving_points(B, T, SERVE_N, seed=seed + i)
               for i in range(n_steps)]
    stamps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    V.launches = L.launches = L.bwd_launches = K3.launches = 0
    record = trainer.train_epoch(epoch, _timed(batches, stamps))
    counts.update(voxelize=V.launches, chamfer_fwd=L.launches,
                  chamfer_bwd=L.bwd_launches, conv3d=K3.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return record, np.diff(stamps) * 1e3, peak


def phase_train(cfg, device, card, detector_dir, n_steps=12,
                n_profiled=2):
    """The training path at the full AIST width: ``Trainer`` on (4, 10,
    4096, 3) point batches in bfloat16 with weights from a seed. Epoch 0
    is the detector phase, checkpointed into ``detector_dir`` (the detector
    run of two-phase training), epoch 1 the learner phase (the detector
    frozen, the skeleton extracted from the trained affinity as the learner
    turns on), then one step with grad_accum=2. Checks finite losses and
    grad_norm, frozen parameters unchanged to the bit, and the launch
    counters: K1 and K2 forward once per microbatch, K2 backward once per
    detector-phase microbatch and never in the learner phase. Returns
    (the ``train`` record, the launches of the detector phase, the
    detector's parameters as checkpointed, the trained affinity; the
    skeleton the trainer extracted on the card is checked equal to the
    host extraction of it)."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from neural_marionette_tpu_torch.train import Trainer
    # save_every=2: a checkpoint after epoch 0 (the detector phase) only
    cfg = dataclasses.replace(cfg, detector_start=0, detector_end=1,
                              learner_start=1, affinity_anneal=0,
                              save_every=2)
    trainer = Trainer(cfg, device=device, dtype="bfloat16",
                      logger_path=str(detector_dir))
    params = dict(trainer.model.named_parameters())
    offset = params["dyna_module.offset_param"].detach().clone()
    phases, det_launches, saved = {}, None, None
    for epoch, name in ((0, "detector"), (1, "learner")):
        det_before = {k: v.detach().clone() for k, v in params.items()
                      if k.startswith("kypt_detector.")}
        counts = {}
        record, ms, peak = _train_epoch(trainer, epoch, n_steps,
                                        1000 + 100 * epoch, counts)
        want = {"voxelize": n_steps, "chamfer_fwd": n_steps,
                "chamfer_bwd": n_steps if name == "detector" else 0,
                "conv3d": 0}
        if counts != want:
            raise AssertionError(f"{name} phase launches {counts}, want "
                                 f"{want}")
        expect = {"detector": (True, False), "learner": (False, True)}[name]
        if (record["phase"]["detector"], record["phase"]["learner"]) != \
                expect:
            raise AssertionError(f"epoch {epoch}: phase {record['phase']}")
        bad = {k: v for k, v in record["train"].items()
               if not np.isfinite(v)}
        if bad or not record["train"]["grad_norm"] > 0:
            raise AssertionError(f"{name} phase metrics {record['train']}")
        if name == "learner":
            if trainer.skeleton is None:
                raise AssertionError("no skeleton at learner start")
            for k, v in det_before.items():
                if not torch.equal(params[k].detach(), v):
                    raise AssertionError(f"frozen detector moved: {k}")
        else:
            det_launches = counts
            # as checkpointed at the end of the epoch (the profiled steps
            # below train on)
            saved = {k: v.detach().clone() for k, v in params.items()
                     if k.startswith("kypt_detector.")}
        if not torch.equal(params["dyna_module.offset_param"].detach(),
                           offset):
            raise AssertionError("offset_param moved")
        # more steps of the phase under the profiler: one in its warm-up
        # round (started cold, it misses the first device operations), then
        # the n_profiled it records, between two profiler_gap()s. Without
        # the gap the learner phase's lost a K1 operation now and then
        # (scripts/profiler_k1_count.py); its count is recorded, not held
        pts = [serving_points(SERVE_B, SERVE_T, SERVE_N, seed=5000 + i)
               for i in range(n_profiled + 1)]
        step = trainer.phase_step()
        sk = trainer.phase_skeleton()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            step(trainer.state, torch.from_numpy(pts[0]).to(device), sk)
            torch.cuda.synchronize()
            prof.step()
            profiler_gap()
            t0 = time.perf_counter()
            for p in pts[1:]:
                step(trainer.state, torch.from_numpy(p).to(device), sk)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            profiler_gap()
        busy_ms, share, ours, by_name = _busy(prof, wall_us)
        top = _top_kernels(by_name, n_profiled, "step")
        timed = ms[1:]   # the first step is warm-up
        phases[name] = {
            "steps": n_steps, "timed_steps": len(timed),
            "mean_ms_per_step": float(timed.mean()),
            "p50_ms_per_step": float(np.percentile(timed, 50)),
            "step_ms": [float(x) for x in ms],
            "profiled_steps": n_profiled,
            "k1_profiled": _calls_of(by_name, "voxelize_kernel"),
            "device_busy_ms_per_step": busy_ms / n_profiled,
            "device_busy_share": share,
            "port_kernel_ms_per_step": {k: v / n_profiled
                                        for k, v in ours.items()},
            "top_kernels": top,
            "peak_device_memory_gib": peak, "launches": counts,
            "total_loss": record["train"]["total_loss"],
            "grad_norm": record["train"]["grad_norm"]}
        log(f"[train] {name} phase: {n_steps} steps of "
            f"{SERVE_B}x{SERVE_T}x{SERVE_N}x3 bf16, ms per step "
            f"{[round(float(x), 1) for x in ms]}; busy share {share:.3f}, "
            f"peak {peak:.2f} GiB, launches {counts}, total_loss "
            f"{record['train']['total_loss']:.4f}, grad_norm "
            f"{record['train']['grad_norm']:.4f}")
        log(f"[train] {name} phase, port kernels' device ms per step: "
            + ", ".join(f"{k} {v / n_profiled:.4f}" for k, v in ours.items()))
        for k in top:
            log(f"[train] {name} phase {k['ms_per_step']:8.3f} ms "
                f"{k['calls_per_step']:6.1f} per step: {k['name']}")

    # the trained affinity (frozen in the learner phase) and the skeleton
    # the trainer extracted from it on the card as the learner turned on
    from neural_marionette_tpu_torch.skeleton import extract_skeleton
    with torch.no_grad():
        affinity = trainer.model.kypt_detector.get_affinity().float().cpu()
    affinity = affinity.numpy()
    host_sk = extract_skeleton(affinity)
    for f in ("A", "priority_values", "priority_indices", "parents"):
        if not np.array_equal(getattr(trainer.skeleton, f),
                              getattr(host_sk, f)):
            raise AssertionError(f"train: the skeleton extracted on the card "
                                 f"differs from the host's in {f}")
    log(f"[train] skeleton extracted on the card equal to the host's: "
        f"parents {trainer.skeleton.parents.tolist()}")

    # one detector-phase step with grad_accum=2: two microbatches of 2
    acc = Trainer(dataclasses.replace(cfg, grad_accum=2), device=device,
                  dtype="bfloat16")
    counts = {}
    record, ms, peak = _train_epoch(acc, 0, 1, 3000, counts)
    if counts != {"voxelize": 2, "chamfer_fwd": 2, "chamfer_bwd": 2,
                  "conv3d": 0}:
        raise AssertionError(f"grad_accum=2 launches {counts}")
    if not all(np.isfinite(v) for v in record["train"].values()):
        raise AssertionError(f"grad_accum=2 metrics {record['train']}")
    phases["grad_accum_2"] = {"steps": 1, "step_ms": [float(ms[0])],
                              "peak_device_memory_gib": peak,
                              "launches": counts,
                              "total_loss": record["train"]["total_loss"],
                              "grad_norm": record["train"]["grad_norm"]}
    log(f"[train] grad_accum=2 step: {ms[0]:.1f} ms (first, unwarmed), peak "
        f"{peak:.2f} GiB, launches {counts}")
    return ({"B": SERVE_B, "T": SERVE_T, "N": SERVE_N, "dtype": "bfloat16",
             "phases": phases, "card": card}, det_launches, saved, affinity)


def phase_train_conv(cfg, device, n_steps=(4, 3)):
    """The training path on the conv route: ``Trainer(conv_kernel=True)`` at
    the full AIST width, a detector-phase epoch of ``n_steps[0]`` steps and
    a learner-phase epoch of ``n_steps[1]``, as ``phase_train`` runs them:
    finite losses and grad_norm, frozen parameters unchanged to the bit,
    and K3 launched ``ROUTED_CONVS`` times per microbatch in both phases
    (the frozen detector's forward too). Returns the ``conv_kernel`` entry
    of the ``train`` line (per phase: step ms, peak memory, launches)."""
    import dataclasses
    import torch
    from neural_marionette_tpu_torch.train import Trainer
    cfg = dataclasses.replace(cfg, detector_start=0, detector_end=1,
                              learner_start=1, affinity_anneal=0)
    trainer = Trainer(cfg, device=device, dtype="bfloat16", conv_kernel=True)
    params = dict(trainer.model.named_parameters())
    offset = params["dyna_module.offset_param"].detach().clone()
    out = {}
    for epoch, name in ((0, "detector"), (1, "learner")):
        n = n_steps[epoch]
        det_before = {k: v.detach().clone() for k, v in params.items()
                      if k.startswith("kypt_detector.")}
        counts = {}
        record, ms, peak = _train_epoch(trainer, epoch, n,
                                        7000 + 100 * epoch, counts)
        want = {"voxelize": n, "chamfer_fwd": n,
                "chamfer_bwd": n if name == "detector" else 0,
                "conv3d": ROUTED_CONVS * n}
        if counts != want:
            raise AssertionError(f"conv route {name} phase launches "
                                 f"{counts}, want {want}")
        bad = {k: v for k, v in record["train"].items()
               if not np.isfinite(v)}
        if bad or not record["train"]["grad_norm"] > 0:
            raise AssertionError(f"conv route {name} phase metrics "
                                 f"{record['train']}")
        if name == "learner":
            for k, v in det_before.items():
                if not torch.equal(params[k].detach(), v):
                    raise AssertionError(f"conv route: frozen detector "
                                         f"moved: {k}")
        if not torch.equal(params["dyna_module.offset_param"].detach(),
                           offset):
            raise AssertionError("conv route: offset_param moved")
        timed = ms[1:]   # the first step is warm-up
        out[name] = {"steps": n, "timed_steps": len(timed),
                     "mean_ms_per_step": float(timed.mean()),
                     "p50_ms_per_step": float(np.percentile(timed, 50)),
                     "step_ms": [float(x) for x in ms],
                     "peak_device_memory_gib": peak, "launches": counts,
                     "total_loss": record["train"]["total_loss"],
                     "grad_norm": record["train"]["grad_norm"]}
        log(f"[train conv_kernel] {name} phase: {n} steps, ms per step "
            f"{[round(float(x), 1) for x in ms]}, peak {peak:.2f} GiB, "
            f"launches {counts}, total_loss "
            f"{record['train']['total_loss']:.4f}, grad_norm "
            f"{record['train']['grad_norm']:.4f}")
    return out


def phase_train_pretrained(device, root, saved, n_steps=(4, 2)):
    """Two-phase training at the full AIST width: the dynamics run
    (``derive_training_id`` of the AIST preset with ``pretrained_mode=1``,
    T = 20, the detector frozen from epoch 0) started by ``Trainer`` from
    the detector run's checkpoint under ``<root>/detector/aist_detector``,
    then from a reference-layout ``.pth`` written here (the same detector
    tensors, the dynamics of another seed and a key outside both). Per
    start: the detector equal to ``saved`` to the bit and the dynamics to
    their seeded initial values; a learner-phase epoch of ``n_steps`` (4,
    20, 4096, 3) point batches in bfloat16 with finite losses, K1 and K2
    forward once per step and K2 backward never (counters set to 0 just
    before the epoch and read just after); the detector unchanged to the
    bit after it and the skeleton extracted from the loaded affinity.
    Returns the ``pretrained`` entry of the ``train`` line."""
    import dataclasses
    import torch
    from neural_marionette_tpu_torch import (MarionetteConfig, adjust_config,
                                             derive_training_id)
    from neural_marionette_tpu_torch.models import NeuralMarionette
    from neural_marionette_tpu_torch.skeleton import extract_skeleton
    from neural_marionette_tpu_torch.train import Trainer
    from neural_marionette_tpu_torch.weights import init_weights
    cfg = derive_training_id(adjust_config(MarionetteConfig(
        dataset="aist", pretrained_mode=1)))
    T = cfg.Ttot
    # the dynamics' seeded initial values, drawn on the CPU as Trainer does
    ref = NeuralMarionette(cfg)
    init_weights(ref, torch.Generator().manual_seed(cfg.seed))
    init = {k: v for k, v in ref.state_dict().items()
            if k.startswith("dyna_module.")}
    del ref
    g = np.random.default_rng(61)
    pth = {k: v.detach().cpu() for k, v in saved.items()}
    pth.update({k: torch.from_numpy(g.normal(0, 0.1, v.shape).astype(
        np.float32)) for k, v in init.items()})
    pth["num_batches_seen"] = torch.tensor(7)
    (root / "reference" / "detector").mkdir(parents=True)
    torch.save(pth, root / "reference" / "detector" / "aist_detector.pth")
    del pth
    out = {}
    for start, pretrained_dir, n in (("checkpoint", root, n_steps[0]),
                                     ("reference_pth", root / "reference",
                                      n_steps[1])):
        trainer = Trainer(dataclasses.replace(
            cfg, pretrained_dir=str(pretrained_dir)), device=device,
            dtype="bfloat16")
        params = dict(trainer.model.named_parameters())
        for k, v in params.items():
            want = saved[k] if k in saved else init[k].to(device)
            if not torch.equal(v.detach(), want):
                raise AssertionError(f"pretrained start from {start}: {k} "
                                     f"differs from what was saved or "
                                     f"initialised")
        counts = {}
        record, ms, peak = _train_epoch(trainer, 0, n, 8000, counts,
                                        T=T)
        want = {"voxelize": n, "chamfer_fwd": n, "chamfer_bwd": 0,
                "conv3d": 0}
        if counts != want:
            raise AssertionError(f"pretrained start from {start}: launches "
                                 f"{counts}, want {want}")
        if (record["phase"]["detector"], record["phase"]["learner"]) != \
                (False, True):
            raise AssertionError(f"pretrained start from {start}: phase "
                                 f"{record['phase']}")
        bad = {k: v for k, v in record["train"].items()
               if not np.isfinite(v)}
        if bad or not record["train"]["grad_norm"] > 0:
            raise AssertionError(f"pretrained start from {start}: metrics "
                                 f"{record['train']}")
        for k, v in saved.items():
            if not torch.equal(params[k].detach(), v):
                raise AssertionError(f"pretrained start from {start}: the "
                                     f"frozen detector moved: {k}")
        with torch.no_grad():
            aff = trainer.model.kypt_detector.get_affinity().cpu().numpy()
        for a, b in zip(trainer.skeleton, extract_skeleton(aff)):
            if not np.array_equal(a, b):
                raise AssertionError(f"pretrained start from {start}: the "
                                     f"skeleton is not the loaded "
                                     f"affinity's")
        timed = ms[1:]   # the first step is warm-up
        out[start] = {"T": T, "steps": n, "timed_steps": len(timed),
                      "mean_ms_per_step": float(timed.mean()),
                      "p50_ms_per_step": float(np.percentile(timed, 50)),
                      "step_ms": [float(x) for x in ms],
                      "peak_device_memory_gib": peak, "launches": counts,
                      "total_loss": record["train"]["total_loss"],
                      "grad_norm": record["train"]["grad_norm"]}
        log(f"[train pretrained] from the {start}: detector loaded to the "
            f"bit, dynamics as seeded; {n} learner steps of "
            f"{SERVE_B}x{T}x{SERVE_N}x3 bf16, ms per step "
            f"{[round(float(x), 1) for x in ms]}, peak {peak:.2f} GiB, "
            f"launches {counts}, total_loss "
            f"{record['train']['total_loss']:.4f}; detector unchanged to "
            f"the bit, skeleton of the loaded affinity")
        del trainer, params
        torch.cuda.empty_cache()
    return out


def _informative_weights(net, seed):
    """Seeded weights whose keypoints follow the points, as the CPU tests'
    ``tests/_torch_port.randomize`` makes them: conv kernels N(0, 1/fan_in),
    conv biases N(0, 0.05), the heatmap fusion kernel N(0, 0.7), GroupNorm
    scales 1 + N(0, 0.1), affinity parameters N(0, 1); the dynamics keep
    ``init_weights``' draws. (With the JAX package's initial distributions
    the block convs are N(0, 0.001) and a frame's keypoints move by ~1e-6,
    a few float32 ulps, so the trajectory loss's velocity cosines are
    rounding noise.)"""
    import torch
    from neural_marionette_tpu_torch.weights import init_weights
    gen = torch.Generator().manual_seed(seed)
    init_weights(net, gen)
    det = net.kypt_detector
    fusion = getattr(det.vox_to_kypt, "propagate_heatmaps", [None])[0]
    with torch.no_grad():
        for m in det.modules():
            if isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d)):
                w = m.weight
                out_ch = w.shape[1 if isinstance(
                    m, torch.nn.ConvTranspose3d) else 0]
                sd = 0.7 if m is fusion else (w.numel() / out_ch) ** -0.5
                w.copy_(torch.randn(w.shape, generator=gen) * sd)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.05)
            elif isinstance(m, torch.nn.GroupNorm):
                m.weight.copy_(1 + torch.randn(m.weight.shape,
                                               generator=gen) * 0.1)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.05)
        if det.affinity_params is not None:
            det.affinity_params.copy_(torch.randn(det.affinity_params.shape,
                                                  generator=gen))


def phase_train_reference(cfg, seed, card_device, B=1):
    """One float32 detector-phase step (TF32 off) on the card (kernels) and
    on the CPU (plain versions), same weights and points, at the AIST width
    and T with B=1 (the CPU runs the full-width float32 backward), with
    ``_informative_weights`` from a seed. Every comparison is logged before
    any failure is raised. Tolerances: loss
    scalars 2e-3 relative or 1e-6 absolute; grad_norm 1e-3; gradients, as
    Adam's first moment (1 - b1) * clip(g), per tensor 5e-3 of the tensor's
    largest entry and 1e-3 relative in L2 over all (the float32 gradients
    of the conv stacks are ill-conditioned: at the CPU tests' size the JAX
    package's own float32 gradient lies up to 4.8e-3 per tensor and 3.8e-4
    in L2 from its float64 one); parameters: Adam's first step moves an
    element by about lr * sign(g), so every element within 2 lr and all but
    1/1000 within 5e-5 + 1e-2 |p|."""
    import torch
    from neural_marionette_tpu_torch.models import NeuralMarionette
    from neural_marionette_tpu_torch.ops.voxelize import voxelize
    from neural_marionette_tpu_torch.train import (LossScheduler,
                                                   create_train_state,
                                                   make_train_step)
    sched = LossScheduler(cfg)
    sched.anneal(0)
    pts = serving_points(B, cfg.Ttot, SERVE_N, seed=61)
    out = []
    for dev in (card_device, torch.device("cpu")):
        net = NeuralMarionette(cfg, device=dev)
        _informative_weights(net, seed)
        p = torch.from_numpy(pts).to(dev)
        with torch.no_grad():
            kp = net.kypt_detector.vox_to_kypt(voxelize(p, cfg.grid_size))[1]
        vel = kp[:, 1:, :, :3] - kp[:, :-1, :, :3]
        acc = vel[:, 1:] - vel[:, :-1]
        log(f"[train reference] keypoints on {dev.type}: mean |velocity| "
            f"{float(vel.norm(dim=-1).mean()):.3e}, mean |acceleration| "
            f"{float(acc.norm(dim=-1).mean()):.3e}")
        state = create_train_state(cfg, net, torch.Generator(dev))
        step = make_train_step(net, cfg, sched.active_weights(), True, False,
                               sched.affinity_active)
        t0 = time.perf_counter()
        m = step(state, p)
        m = {k: float(v) for k, v in m.items()}
        log(f"[train reference] float32 step on {dev.type}: "
            f"{time.perf_counter() - t0:.1f} s")
        out.append((m, {n: q.detach().cpu() for n, q in
                        net.named_parameters()},
                    [t.cpu() for t in state.optimizer.mu],
                    state.optimizer.names))
    (mc, pc, muc, names), (mh, ph, muh, _) = out
    failed, errs = [], {}
    for k, v in mh.items():
        err = abs(mc[k] - v)
        tol = 1e-3 * abs(v) if k == "grad_norm" else 2e-3 * abs(v) + 1e-6
        if not err <= tol:
            failed.append(f"{k}: card {mc[k]!r} vs CPU {v!r}")
        errs[k] = err
    log("[train reference] metrics card vs CPU: " + ", ".join(
        f"{k} {mc[k]:.6g}/{mh[k]:.6g}" for k in sorted(mh)))
    err2 = ref2 = 0.0
    rel = {}
    for n, a, b in zip(names, muc, muh):
        scale = float(b.abs().max())
        rel[n] = float((a - b).abs().max()) / scale if scale else 0.0
        if not rel[n] <= 5e-3:
            failed.append(f"gradient {n}: max abs err {rel[n]:.3e} of its "
                          f"largest entry")
        err2 += float(((a - b).double() ** 2).sum())
        ref2 += float((b.double() ** 2).sum())
    l2 = (err2 / ref2) ** 0.5
    if not l2 < 1e-3:
        failed.append(f"gradients: relative L2 error {l2:.3e}")
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:4]
    lr = cfg.lrate
    total = loose = 0
    pmax = 0.0
    for n in names:
        d = (pc[n] - ph[n]).abs()
        pmax = max(pmax, float(d.max()))
        loose += int((d > 5e-5 + 1e-2 * ph[n].abs()).sum())
        total += d.numel()
    if not (pmax <= 2 * lr + 1e-6 and loose <= total // 1000):
        failed.append(f"parameters: max diff {pmax:.3e}, {loose} of {total} "
                      f"outside 5e-5 + 1e-2 |p|")
    log(f"[train reference] gradients: relative L2 {l2:.3e}, worst tensors "
        + ", ".join(f"{n} {v:.3e}" for n, v in worst)
        + f"; parameters: max diff {pmax:.3e} (lr {lr}), {loose} of {total} "
        f"outside 5e-5 + 1e-2 |p|")
    if failed:
        raise AssertionError("train reference: " + "; ".join(failed))
    errs.update(grad_worst_tensor=worst[0][1], grad_l2=l2, param_max=pmax,
                param_loose=loose)
    return errs


# ---------------------------------------------------------------- options
# The detector's option sets, on top of the AIST preset (the CPU tests'
# tests/test_torch_options.py runs the same five against the JAX package)
OPTION_SETS = {
    "ci2_gauss_max_aff0": dict(const_intensity=2, vol_fit_type="gaussian",
                               gaussian_cat_type="max", affinity_ver=0,
                               graph_loss_ver=0),
    "ci0_none_sum_aff1": dict(const_intensity=0, vol_fit_type="none",
                              gaussian_cat_type="sum", affinity_ver=1,
                              graph_loss_ver=2),
    "ci1_aff4_sigma": dict(const_intensity=1, affinity_ver=4, fixed_sigma=0,
                           graph_random_init=1, keypoints_detach=1),
    "ci4_aff2_noconst": dict(const_intensity=4, affinity_ver=2,
                             using_local_const=0, using_time_const=0,
                             using_sparsity_const=0),
    "graph_none": dict(keypoints_graph="none"),
}
# the JAX stream passes no "gumbel" rng, so it cannot run affinity_ver=4
OPTION_STREAM_SETS = ("ci2_gauss_max_aff0", "ci0_none_sum_aff1",
                      "ci4_aff2_noconst", "graph_none")
OPTION_CONV_SET = "ci4_aff2_noconst"
OPTION_STEPS = 4   # detector steps per set; the first is warm-up
# routed convs per detector forward: the feature net 22, the
# spatio-temporal net 22 (const_intensity 2-4), the decoder 4
ROUTED_CONVS_NO_ST = 26


def _option_cfg(cfg, name):
    import dataclasses
    return dataclasses.replace(cfg, detector_start=0, learner_start=10 ** 9,
                               affinity_anneal=0, **OPTION_SETS[name])


def _routed_per_forward(det):
    """Convs of the detector that the conv route puts on K3."""
    import torch
    from neural_marionette_tpu_torch.models.blocks import routes_to_kernel
    return sum(routes_to_kernel(m, torch.bfloat16) for m in det.modules()
               if isinstance(m, torch.nn.Conv3d))


def routed_remat_launches(det, remat):
    """K3 launches of one training forward and backward of a routed
    bfloat16 detector ``det`` (one microbatch) at ``remat``: each routed
    conv launches once in the forward and once more in each region's
    recompute that reaches it. At 1 the regions are each feature net and
    the decoder, so every routed conv launches twice. At 2 each block of a
    feature net and each decoder stage is a region inside those, and every
    routed conv lies in one: three launches, less the routed convs of each
    feature net's last block (``Res3DBlock_1``), which the outer recompute
    does not reach, since PyTorch's non-reentrant checkpoint stops a
    recompute once it has rebuilt the last tensor its region saved, here
    that block's input. The decoder's outer region saves its 1x1 head's
    input last, after every stage."""
    import torch
    from neural_marionette_tpu_torch.models.blocks import routes_to_kernel

    def routed(m):
        return sum(routes_to_kernel(c, torch.bfloat16) for c in m.modules()
                   if isinstance(c, torch.nn.Conv3d))

    total = routed(det)
    if remat >= 2:
        nets = [m for name, m in det.vox_to_kypt.named_children()
                if name in ("extract_features",
                            "extract_spatio_temporal_features")]
        return 3 * total - sum(routed(n[-1]) for n in nets)
    return 2 * total if remat else total


def _option_window(cfg, device, seed, n_windows=3):
    """A bfloat16 stream of ``n_windows`` windows (B 4, T 10, N 4096) of a
    set through ``Marionette.stream`` (seeded weights; a seeded skeleton
    for ``keypoints_graph="none"``, which learns none): outputs finite and
    of the expected shapes; returns (host ms to the first result and
    between results, launches). Gap 1 is a window's steady time
    (``phase_stream``)."""
    import torch
    from neural_marionette_tpu_torch.api import Marionette
    from neural_marionette_tpu_torch.ops import conv3d as K3
    from neural_marionette_tpu_torch.ops import losses as L
    from neural_marionette_tpu_torch.ops import voxelize as V
    from neural_marionette_tpu_torch.skeleton import extract_skeleton
    m = Marionette.from_config(cfg, seed=seed, device=device)
    if cfg.keypoints_graph == "none":
        K = cfg.nkeypoints
        m.skeleton = extract_skeleton(np.random.default_rng(seed).uniform(
            0, 1, (cfg.nneighbor, K, K, 1)).astype(np.float32))
    shapes = _window_outputs(cfg, SERVE_B, SERVE_T)
    windows = [serving_points(SERVE_B, SERVE_T, SERVE_N, seed=seed + j)
               for j in range(n_windows)]
    stamps, results = [], []
    with m.stream(dtype="bfloat16", sample_num=SAMPLE_NUM,
                  outputs=tuple(shapes)) as s:
        torch.cuda.synchronize()
        V.launches = L.launches = L.bwd_launches = K3.launches = 0
        t0 = time.perf_counter()
        for res in s.run(windows):
            stamps.append(time.perf_counter())
            results.append(res)
    counts = {"voxelize": V.launches, "chamfer_fwd": L.launches,
              "chamfer_bwd": L.bwd_launches, "conv3d": K3.launches}
    if len(results) != n_windows:
        raise AssertionError(f"options stream: {len(results)} results")
    for res in results:
        for k, shape in shapes.items():
            v = res[k]
            if v.shape != shape or not np.isfinite(v).all():
                raise AssertionError(f"options window {k}: shape {v.shape} "
                                     f"(want {shape}), finite "
                                     f"{np.isfinite(v).all()}")
    return [float(x) for x in np.diff([t0] + stamps) * 1e3], counts


# how much further from the float64 gradient the card's float32 gradient
# may lie than the CPU's float32 one (``_option_reference``). Measured on
# an H100 (card / CPU distance, worst tensor and L2): set A 0.60 / 0.79,
# B 0.61 / 0.98, C 15.8 / 17.1, D 1.43 / 2.70, E 2.33 / 0.94. Set C's
# card gradient is the float32 cuDNN weight gradient of a feature-net
# conv, 2.3e-4 of its largest entry from float64 (the CPU's worst 1.5e-5).
F64_DISTANCE_MULTIPLE = 20.0


def _tensor_distance(a, b):
    """max |a - b| over the largest |b| (max |a| where b is 0)."""
    a, b = a.double(), b.double()
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / scale if scale else float(
        a.abs().max())


def _grad_distance(grads, ref):
    """(worst tensor of :func:`_tensor_distance`, relative L2 over all, the
    worst tensor's name) of the gradients ``grads`` against ``ref``."""
    err2 = ref2 = worst = 0.0
    name = None
    for k, b in ref.items():
        a = grads[k]
        d = _tensor_distance(a, b)
        if d >= worst:
            worst, name = d, k
        err2 += float(((a.double() - b.double()) ** 2).sum())
        ref2 += float((b.double() ** 2).sum())
    return worst, (err2 / ref2) ** 0.5, name


# the parameter whose card gradient of set C lies furthest from float64:
# the scale of a GroupNorm of the feature net's hourglass (``norm``)
WGRAD_PARAM = "kypt_detector.vox_to_kypt.extract_features.4.encoder_res2." \
    "res_branch.4.weight"


class _CaptureNorm:
    """Within it, the arguments and output gradient of the
    ``F.group_norm`` call on ``weight`` (``models/blocks.norm``) are
    kept."""

    def __init__(self, weight):
        self.weight = weight
        self.args = self.gy = None

    def __enter__(self):
        import torch.nn.functional as F
        self._orig = orig = F.group_norm

        def group_norm(x, groups, weight=None, bias=None, eps=1e-5):
            y = orig(x, groups, weight, bias, eps)
            if weight is self.weight:
                self.args = (x.detach().clone(), groups,
                             bias.detach().clone(), eps)
                y.register_hook(lambda g: setattr(self, "gy",
                                                  g.detach().clone()))
            return y

        F.group_norm = group_norm
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F
        F.group_norm = self._orig

    def weight_grad(self, device, dtype):
        """The weight gradient of the kept call, recomputed alone from its
        input and output gradient, on ``device`` in ``dtype``."""
        import torch.nn.functional as F
        x, groups, b, eps = self.args
        w = self.weight.detach().to(device, dtype).requires_grad_(True)
        y = F.group_norm(x.to(device, dtype), groups, w, b.to(device, dtype),
                         eps)
        y.backward(self.gy.to(device, dtype))
        return w.grad.cpu()


def _wgrad_check(caps, card_device):
    """Where the card's float32 gradient of ``WGRAD_PARAM`` departs from
    float64 (``ROADMAP.md`` Queue 3, set C): the distances
    (``_tensor_distance``) from the float64 run of the GroupNorm's input
    and output gradient on the card and on the CPU, and of its weight
    gradient recomputed alone from the card's own input and output
    gradient on the card (ATen's CUDA GroupNorm backward; TF32 off) with
    ``cudnn.deterministic`` off and on, and on the CPU in float32, each
    against float64 arithmetic on those same operands."""
    import torch
    card, cpu, f64 = caps
    ref = card.weight_grad("cpu", torch.float64)
    out = {}
    for what, i in (("x", 0), ("gy", None)):
        want = f64.gy if i is None else f64.args[i]
        for side, cap in (("card", card), ("cpu", cpu)):
            got = cap.gy if i is None else cap.args[i]
            out[f"{what}_{side}_f64"] = _tensor_distance(got.cpu(), want)
    before = torch.backends.cudnn.deterministic
    try:
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            out[f"wgrad_card_deterministic_{int(det)}"] = _tensor_distance(
                card.weight_grad(card_device, torch.float32), ref)
    finally:
        torch.backends.cudnn.deterministic = before
    out["wgrad_cpu_f32"] = _tensor_distance(
        card.weight_grad("cpu", torch.float32), ref)
    return out


def _option_reference(cfg, card_device, seed):
    """One float32 detector-phase forward and backward (TF32 off) of a set
    on the card (kernels) and on the CPU (plain versions) at a small width
    (grid 32, feat 32, K 8, T 4, B 2, N 1024), same informative weights,
    points and, for version 4, the same uniform draw (made on the CPU).
    Bounds: loss scalars 2e-3 relative or 1e-6 absolute; gradients per
    tensor 2e-2 of the tensor's largest entry and 1e-3 relative in L2 over
    all, the CPU tests' bounds at this size
    (``tests/test_torch_train_step.py``): there a float32 gradient of the
    conv stacks lies up to 9.4e-3 of a tensor's largest entry from the
    float64 one (the port's at the AIST options; the JAX package's 8.9e-3
    with ``keypoints_graph="none"``).

    A third run, the port on the CPU in float64 with the same weights,
    points and draw, is the oracle that neither float32 side is: the
    card's gradient must lie no further from it than 20 times
    (``F64_DISTANCE_MULTIPLE``, set from the five sets' measured ratios,
    at most 17.1) the CPU's float32 gradient, worst tensor and L2 each.
    Returns the largest errors, both distances from float64 and, for
    ``WGRAD_PARAM``, where its card gradient departs from float64
    (``_wgrad_check``)."""
    import dataclasses
    import torch
    from neural_marionette_tpu_torch.models import NeuralMarionette
    from neural_marionette_tpu_torch.models.detector import gumbel_uniform
    from neural_marionette_tpu_torch.ops.voxelize import voxelize
    from neural_marionette_tpu_torch.train import LossScheduler
    from neural_marionette_tpu_torch.train.step import total_loss
    small = dataclasses.replace(cfg, grid_size=32, feat_dim=32, nkeypoints=8,
                                Ttot=4, nlatent_kypt=16, nhidden_kypt=32)
    sched = LossScheduler(small)
    sched.anneal(0)
    pts = serving_points(2, small.Ttot, 1024, seed=seed)
    K, n = small.nkeypoints, small.nneighbor
    uniform = gumbel_uniform((n, K, K - 1), torch.Generator().manual_seed(
        seed)) if small.affinity_ver == 4 else None
    out, caps = [], []
    cpu = torch.device("cpu")
    for dev, dtype in ((card_device, torch.float32), (cpu, torch.float32),
                       (cpu, torch.float64)):
        net = NeuralMarionette(small, dtype=dtype, device=dev)
        _informative_weights(net, seed)
        net.to(dtype)
        vox = voxelize(torch.from_numpy(pts).to(dev),
                       small.grid_size).to(dtype)
        with _CaptureNorm(dict(net.named_parameters())[
                WGRAD_PARAM]) as cap:
            o = net(vox, affinity_active=sched.affinity_active,
                    gumbel=None if uniform is None else uniform.to(dev,
                                                                   dtype))
            tot, m = total_loss(o, sched.active_weights(), dtype, dev)
            tot.backward()
        caps.append(cap)
        out.append(({k: float(v.detach()) for k, v in m.items()},
                    {k: (p.grad if p.grad is not None
                         else torch.zeros_like(p)).detach().cpu()
                     for k, p in net.named_parameters()}))
    (mc, gc), (mh, gh), (_, g64) = out
    failed = [f"{k}: card {mc[k]!r} vs CPU {v!r}" for k, v in mh.items()
              if not abs(mc[k] - v) <= 2e-3 * abs(v) + 1e-6]
    for k, b in gh.items():
        rel = _tensor_distance(gc[k], b)
        if not rel <= 2e-2:
            failed.append(f"gradient {k}: max abs err {rel:.3e} of its "
                          f"largest entry")
    worst, l2, _ = _grad_distance(gc, gh)
    if not l2 < 1e-3:
        failed.append(f"gradients: relative L2 error {l2:.3e}")
    card64, cpu64 = _grad_distance(gc, g64), _grad_distance(gh, g64)
    for what, c, h in zip(("worst tensor", "L2"), card64, cpu64):
        if not c <= F64_DISTANCE_MULTIPLE * h:
            failed.append(f"gradients from float64, {what}: card {c:.3e} "
                          f"above {F64_DISTANCE_MULTIPLE} x the CPU's "
                          f"{h:.3e}")
    if failed:
        raise AssertionError("options reference: " + "; ".join(failed))
    return {"loss_max_rel_err": max(abs(mc[k] - v) / (abs(v) + 1e-30)
                                    for k, v in mh.items()),
            "grad_worst_tensor": worst, "grad_l2": l2,
            "card_f64_worst_tensor": card64[0], "card_f64_l2": card64[1],
            "card_f64_worst_name": card64[2],
            "cpu_f64_worst_tensor": cpu64[0], "cpu_f64_l2": cpu64[1],
            "cpu_f64_worst_name": cpu64[2],
            "total_loss": mh["total_loss"], "wgrad": _wgrad_check(caps, card_device)}


def phase_options(cfg, device, card):
    """The detector's option sets at the full AIST width (grid 64, K 24,
    feat 128, T 10, B 4, N 4096, bfloat16, seeded weights): per set a
    ``Trainer`` detector-phase epoch of ``OPTION_STEPS`` steps (finite
    metrics; the step ms after the first, their p50, peak memory; K1 once
    a step, K2 forward and backward once a step where ``vol_fit_type`` is
    ``chamfer`` and never otherwise, K3 never), one stream window for the
    sets the JAX stream runs (3 pruned windows; K1 once a window, K2
    never), the
    float32 step card against CPU (``_option_reference``); the conv-route
    set again on the conv route (K3 once per routed conv of each forward:
    48 for const_intensity 2-4, 26 for 0-1); and for version 4 the Gumbel
    draw from the generator passed: the same seed, the same affinity to
    the bit on the card, another seed another affinity, and
    ``Trainer.extract_skeleton`` (noise from ``cfg.seed``) twice the same
    skeleton. Returns the ``options`` record."""
    import dataclasses
    import torch
    from neural_marionette_tpu_torch.train import Trainer
    out = {}
    t_phase = time.perf_counter()
    for i, name in enumerate(OPTION_SETS):
        ocfg = _option_cfg(cfg, name)
        chamfer = ocfg.vol_fit_type == "chamfer"
        rec = {}
        for conv_kernel in ((False, True) if name == OPTION_CONV_SET
                            else (False,)):
            trainer = Trainer(ocfg, device=device, dtype="bfloat16",
                              conv_kernel=conv_kernel)
            routed = _routed_per_forward(trainer.model.kypt_detector)
            if conv_kernel and routed != (
                    ROUTED_CONVS if ocfg.const_intensity in (2, 3, 4)
                    else ROUTED_CONVS_NO_ST):
                raise AssertionError(f"options {name}: {routed} routed convs")
            before = {k: v.detach().clone() for k, v in
                      trainer.model.named_parameters()}
            counts = {}
            record, ms, peak = _train_epoch(trainer, 0, OPTION_STEPS,
                                            8000 + 100 * i, counts)
            n = OPTION_STEPS
            want = {"voxelize": n, "chamfer_fwd": n if chamfer else 0,
                    "chamfer_bwd": n if chamfer else 0,
                    "conv3d": routed * n if conv_kernel else 0}
            if counts != want:
                raise AssertionError(f"options {name} (conv_kernel "
                                     f"{conv_kernel}): launches {counts}, "
                                     f"want {want}")
            bad = {k: v for k, v in record["train"].items()
                   if not np.isfinite(v)}
            if bad or not record["train"]["grad_norm"] > 0:
                raise AssertionError(f"options {name}: metrics "
                                     f"{record['train']}")
            params = dict(trainer.model.named_parameters())
            for k in ("kypt_detector.vox_to_kypt.sigmas",
                      "kypt_detector.vox_to_kypt.initial_heatmaps",
                      "kypt_detector.affinity_params"):
                if k in params and torch.equal(params[k].detach(),
                                               before[k]):
                    raise AssertionError(f"options {name}: {k} not trained")
            timed = ms[1:]
            step = {"steps": n, "step_ms": [float(x) for x in ms],
                    "p50_ms_per_step": float(np.percentile(timed, 50)),
                    "mean_ms_per_step": float(timed.mean()),
                    "peak_device_memory_gib": peak, "launches": counts,
                    "routed_convs_per_forward": routed,
                    "total_loss": record["train"]["total_loss"],
                    "vol_fit_reg": record["train"]["vol_fit_reg"],
                    "graph_traj_loss": record["train"]["graph_traj_loss"]}
            rec["train_conv_kernel" if conv_kernel else "train"] = step
            log(f"[options] {name}{' conv_kernel' if conv_kernel else ''}: "
                f"{n} detector steps, ms {[round(x, 1) for x in ms]}, p50 "
                f"{step['p50_ms_per_step']:.2f}, peak {peak:.2f} GiB, "
                f"launches {counts}, total_loss "
                f"{record['train']['total_loss']:.4f}")
            if ocfg.affinity_ver == 4 and not conv_kernel:
                det = trainer.model.kypt_detector
                with torch.no_grad():
                    a, b, c = (det.get_affinity(generator=torch.Generator(
                        device).manual_seed(s)) for s in (5, 5, 6))
                if not torch.equal(a, b) or torch.equal(a, c):
                    raise AssertionError("options: the Gumbel draw does not "
                                         "follow the generator")
                s1, s2 = trainer.extract_skeleton(), trainer.extract_skeleton()
                if not np.array_equal(s1.parents, s2.parents):
                    raise AssertionError("options: extract_skeleton with "
                                         "the Gumbel noise of cfg.seed differs")
                rec["gumbel"] = {"same_seed_equal": True,
                                 "parents": s1.parents.tolist()}
            del trainer, params, before
            torch.cuda.empty_cache()
        if name in OPTION_STREAM_SETS:
            gaps, counts = _option_window(ocfg, device, seed=8500 + 10 * i)
            # the pruned window (``stream_launches``): K1 once a window,
            # no volume fit (K2) whatever the set's vol_fit_type
            want = dict(stream_launches(_window_outputs(ocfg, SERVE_B,
                                                        SERVE_T), 3, False),
                        chamfer_bwd=0)
            if counts != want:
                raise AssertionError(f"options {name} stream launches "
                                     f"{counts}, want {want}")
            rec["stream"] = {"windows": 3, "gaps_ms": gaps,
                             "steady_window_ms": gaps[1],
                             "launches": counts}
            log(f"[options] {name}: stream of 3 windows, ms to the first "
                f"result and between results {[round(x, 1) for x in gaps]}"
                f", launches {counts}")
        rec["reference"] = _option_reference(ocfg, device, seed=8700 + i)
        log(f"[options] {name}: float32 card vs CPU (small width): "
            + ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else
                        f"{k} {v}" for k, v in rec["reference"].items()))
        out[name] = rec
        torch.cuda.empty_cache()
    log(f"[options] phase {time.perf_counter() - t_phase:.1f} s")
    return {"B": SERVE_B, "T": SERVE_T, "N": SERVE_N, "dtype": "bfloat16",
            "sets": out, "card": card}


# ------------------------------------------------------------------- remat
REMAT_SLOPE_B = (6, 12)   # clips a microbatch of the slope: 60, 120 frames
REMAT_FULL_B = 24         # the JAX package's B 24 at grad_accum 1 (240)
REMAT_STEPS = 4           # detector steps a (remat, B); the first warms up
# the most a reckoned reserved peak may reach (of the card's 79.18 GiB): the
# reserved peak runs above its linear reckoning (remat 2, B 24: 73.29 GiB
# against 67.2 reckoned), and a B whose allocated peak reckoned 73 GiB ran
# out of memory
REMAT_CAP_GIB = 72.0
REMAT_REPEATS = 6         # float32 remat 0 steps the card check spans
REMAT_SMALL = dict(grid_size=32, feat_dim=32, nkeypoints=6, Ttot=4,
                   nlatent_kypt=16, nhidden_kypt=32, grad_accum=2)


def _remat_cfg(cfg, remat, **kw):
    import dataclasses
    return dataclasses.replace(cfg, detector_start=0, learner_start=10 ** 9,
                               affinity_anneal=0, remat=remat, **kw)


def _remat_timed(cfg, device, remat, B):
    """``REMAT_STEPS`` bf16 detector steps of ``Trainer`` at the preset's
    width, ``B`` clips of T 10 a step, ``grad_accum`` 1: per-step ms, p50
    of the steps after the first, the process's peak allocated and
    reserved GiB; the launches must be K1 and K2 once a step, K3 never."""
    import gc
    import torch
    from neural_marionette_tpu_torch.train import Trainer
    trainer = Trainer(_remat_cfg(cfg, remat, nbatch=B, grad_accum=1),
                      device=device, dtype="bfloat16")
    counts = {}
    record, ms, peak = _train_epoch(trainer, 0, REMAT_STEPS,
                                    9000 + 100 * B + remat, counts, B=B)
    n = REMAT_STEPS
    if counts != {"voxelize": n, "chamfer_fwd": n, "chamfer_bwd": n,
                  "conv3d": 0}:
        raise AssertionError(f"remat {remat} B {B}: launches {counts}")
    if not all(np.isfinite(v) for v in record["train"].values()):
        raise AssertionError(f"remat {remat} B {B}: metrics "
                             f"{record['train']}")
    out = {"B": B, "frames": B * SERVE_T, "step_ms": [float(x) for x in ms],
           "p50_ms_per_step": float(np.percentile(ms[1:], 50)),
           "peak_gib": peak,
           "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
           "total_loss": record["train"]["total_loss"]}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[remat] remat {remat}, B {B} ({B * SERVE_T} frames): ms per step "
        f"{[round(float(x), 1) for x in ms]}, p50 "
        f"{out['p50_ms_per_step']:.1f}, peak {peak:.2f} GiB (reserved "
        f"{out['peak_reserved_gib']:.2f})")
    return out


def _remat_small_step(cfg, device, remat):
    """One float32 detector step (TF32 off) at ``REMAT_SMALL``'s width on
    ``device``: its metrics, the gradients the optimizer got, the
    parameters after Adam and the generator's state, on the host."""
    import torch
    from neural_marionette_tpu_torch.models import NeuralMarionette
    from neural_marionette_tpu_torch.train import (LossScheduler,
                                                   create_train_state,
                                                   make_train_step)
    c = _remat_cfg(cfg, remat, **REMAT_SMALL)
    net = NeuralMarionette(c, device=device)
    _informative_weights(net, seed=71)
    sched = LossScheduler(c)
    sched.anneal(0)
    state = create_train_state(c, net, torch.Generator(device).manual_seed(
        72))
    grads, update = [], state.optimizer.update

    def capture(gs, trainable):
        grads.extend(g.detach().cpu() for g in gs if g is not None)
        return update(gs, trainable)

    state.optimizer.update = capture
    pts = torch.from_numpy(serving_points(4, c.Ttot, 1024, seed=73))
    metrics = make_train_step(net, c, sched.active_weights(), True, False,
                              True)(state, pts.to(device))
    return {"metrics": [float(metrics[k]) for k in sorted(metrics)],
            "grads": grads,
            "params": [p.detach().cpu() for p in net.parameters()],
            "generator": state.generator.get_state()}


def _max_gap(a, b):
    """The largest absolute difference between two small steps' metrics,
    gradients and parameters (0.0: equal to the bit); inf when their
    generators differ."""
    import torch
    if not torch.equal(a["generator"], b["generator"]):
        return float("inf")
    gap = float(np.max(np.abs(np.subtract(a["metrics"], b["metrics"]))))
    for part in ("grads", "params"):
        for x, y in zip(a[part], b[part]):
            gap = max(gap, float((x - y).abs().max()))
    return gap


def phase_remat(cfg, device, card):
    """The rematerialised detector (``cfg.remat``): the peak memory and
    step time of a bf16 detector step at the preset's width by remat value
    and microbatch, the K3 launches of a routed step at each value
    (:func:`routed_remat_launches`), and a float32 small-width step at
    remat 1 and 2 against remat 0 on the card."""
    import gc
    import torch
    from neural_marionette_tpu_torch.models.detector import remat_level
    from neural_marionette_tpu_torch.train import Trainer
    t_phase = time.perf_counter()
    out = {"card": card, "T": SERVE_T, "N": SERVE_N, "dtype": "bfloat16",
           "grad_accum": 1, "steps": REMAT_STEPS, "cap_gib": REMAT_CAP_GIB}

    # float32, small width: remat 1 and 2 against remat 0. The card's
    # float32 step is not repeatable to the bit (atomics in cuDNN's and
    # the trilinear upsample's backward), so a step is held to the
    # nearest of REMAT_REPEATS remat 0 steps, which must be no further
    # apart than the farthest two of those are from each other. Were the
    # n + 1 steps' gaps exchangeable, a right step would fail this by
    # chance with probability 1 / C(C(n + 1, 2), n): 1 in 20 at n 3
    # (which failed a run), 1 in 54,264 at 6
    ref = [_remat_small_step(cfg, device, 0) for _ in range(REMAT_REPEATS)]
    spread = max(_max_gap(a, b) for i, a in enumerate(ref)
                 for b in ref[i + 1:])
    check = {"remat0_vs_remat0": spread}
    for r in (1, 2):
        step = _remat_small_step(cfg, device, r)
        gap = min(_max_gap(step, a) for a in ref)
        check[f"remat{r}_vs_remat0"] = gap
        if not gap <= spread:
            raise AssertionError(f"remat {r}: the float32 step lies {gap} "
                                 f"from the nearest remat 0 step's, remat 0 "
                                 f"steps up to {spread} from each other")
    out["float32_check"] = check
    log(f"[remat] float32 small-width step on the card: max abs gap to "
        f"remat 0 {check}")

    # routed bf16 B 4 steps: K3 launches per the formula
    routed = {}
    for r in (0, 1, 2):
        trainer = Trainer(_remat_cfg(cfg, r), device=device,
                          dtype="bfloat16", conv_kernel=True)
        det = trainer.model.kypt_detector
        counts = {}
        record, ms, _ = _train_epoch(trainer, 0, 1, 9500 + r, counts)
        want = routed_remat_launches(det, r)
        if remat_level(det.vox_to_kypt) != r or counts != {
                "voxelize": 1, "chamfer_fwd": 1, "chamfer_bwd": 1,
                "conv3d": want}:
            raise AssertionError(f"remat {r} routed step: launches {counts}, "
                                 f"K3 wanted {want}")
        if not all(np.isfinite(v) for v in record["train"].values()):
            raise AssertionError(f"remat {r} routed step: {record['train']}")
        routed[r] = {"launches": counts, "conv3d_wanted": want,
                     "first_step_ms": float(ms[0])}
        del trainer, det
        gc.collect()
        torch.cuda.empty_cache()
    out["routed_b4"] = routed
    log("[remat] routed bf16 B 4 step, K3 launches (forward + one "
        "recompute per region reaching the conv): "
        + ", ".join(f"remat {r} {v['launches']['conv3d']}"
                    for r, v in routed.items()))

    # the slope of the peak with the microbatch, then 240 frames
    runs = {r: {} for r in (0, 1, 2)}
    for r in (0, 1, 2):
        for b in REMAT_SLOPE_B:
            runs[r][b] = _remat_timed(cfg, device, r, b)
    # the slopes of the allocated and of the reserved peak; the reserved
    # one (the allocator's hold on the card, fragmentation included)
    # decides B (REMAT_CAP_GIB)
    b0, b1 = REMAT_SLOPE_B
    frames = (b1 - b0) * SERVE_T
    slope, reserved = ({r: (runs[r][b1][k] - runs[r][b0][k]) / frames
                        for r in runs}
                       for k in ("peak_gib", "peak_reserved_gib"))
    if not all(v > 0 for v in (*slope.values(), *reserved.values())):
        raise AssertionError(f"remat: the peak does not grow with B: "
                             f"{slope}, {reserved}")

    def reckon(r, b):
        return runs[r][b1]["peak_reserved_gib"] + reserved[r] * (b - b1) * \
            SERVE_T

    reckoned = {r: reckon(r, REMAT_FULL_B) for r in runs}
    full = {}
    for r in (1, 2):
        b = REMAT_FULL_B
        while reckon(r, b) > REMAT_CAP_GIB:
            b -= 1
        full[r] = dict(_remat_timed(cfg, device, r, b),
                       reckoned_reserved_gib=reckon(r, b),
                       cut_from_b24=b != REMAT_FULL_B)
        if b != REMAT_FULL_B:
            log(f"[remat] remat {r}: B 24 reckoned at {reckoned[r]:.2f} GiB "
                f"reserved, above {REMAT_CAP_GIB}: ran the largest B "
                f"reckoned under it, {b} ({reckon(r, b):.2f} GiB)")
    out["runs"] = {str(r): {str(b): v for b, v in bs.items()}
                   for r, bs in runs.items()}
    out["gib_per_frame"] = {str(r): v for r, v in slope.items()}
    out["reserved_gib_per_frame"] = {str(r): v for r, v in reserved.items()}
    out["reckoned_b24_reserved_gib"] = {str(r): v
                                        for r, v in reckoned.items()}
    out["full"] = {str(r): v for r, v in full.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    log("[remat] peak GiB a folded frame (B 6 -> 12), allocated / reserved: "
        + ", ".join(f"remat {r} {slope[r]:.4f} / {reserved[r]:.4f}"
                    for r in runs)
        + "; B 24 reckoned reserved " + ", ".join(
            f"remat {r} {v:.1f}" for r, v in reckoned.items()))
    log(f"[remat] phase {out['phase_s']:.1f} s")
    return out


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
    one = torch.ones((), dtype=torch.bfloat16, device=device)

    # No one PyTorch call computes K1's function from the points. The
    # yardstick does the same work as K1's call, with the indices
    # precomputed (above, untimed): allocate and zero the grid, then one
    # index_put_ of ones.
    def library_k1():
        grid = torch.zeros(F * G ** 3, dtype=torch.bfloat16, device=device)
        return grid.index_put_((lin,), one)

    # K1's device time per call from the profiler: every device operation
    # of the call, which must be the kernel alone (no fill, no memset)
    dev = device_events(lambda: V.voxelize(pts, G, dtype=torch.bfloat16))
    k1_device = sum(e.time_range.elapsed_us() for e in dev) / 10e3
    k1_kernel = sum(e.time_range.elapsed_us() for e in dev
                    if "voxelize_kernel" in e.name) / 10e3
    k1_ops = len(dev) / 10
    log(f"[time] voxelize device ms per call: {k1_device:.4f} in "
        f"{k1_ops:g} device operations per call (kernel {k1_kernel:.4f})")
    if k1_ops != 1 or not all("voxelize_kernel" in e.name for e in dev):
        raise AssertionError(f"K1 ran {sorted({e.name for e in dev})}, "
                             f"{k1_ops:g} device operations per call; want "
                             f"the kernel alone")
    k1_bytes = pts.numel() * 4 + F * G ** 3 * 2
    k1_flops = F * SERVE_N * 3 * 3   # add, divide, floor per coordinate
    # Both calls are host-bound (the card idles between them), so their
    # event times follow the host's jitter: the kernel and the yardstick
    # are timed in turns, five rounds each, and the medians kept.
    rounds = {"kernel": [], "library": []}
    for _ in range(5):
        rounds["kernel"].append(cuda_ms(
            lambda: V.voxelize(pts, G, dtype=torch.bfloat16)))
        rounds["library"].append(cuda_ms(library_k1))
    records.append(_record(
        "voxelize", "neural_marionette_tpu_torch/csrc/voxelize.cu",
        "neural_marionette_tpu/ops/pallas/voxelize_kernel.py:70",
        launches["voxelize"], errs["voxelize"],
        float(np.median(rounds["kernel"])),
        cuda_ms(lambda: V.voxelize_plain(pts, G, dtype=torch.bfloat16)),
        float(np.median(rounds["library"])),
        k1_bytes, [(k1_flops, PEAK_FP32_OPS_PER_S)], device_ms=k1_device,
        device_ms_kernel=k1_kernel, device_ops_per_call=k1_ops,
        ms_rounds=rounds["kernel"], library_ms_rounds=rounds["library"],
        library="torch.zeros + index_put_ of precomputed indices"))

    # K2: kp (40, 24, 3) float32, occupancy (40, 64^3) bfloat16 -> (40,);
    # its backward as the training step calls it: g (40,), no occupancy
    # gradient -> dkp (40, 24, 3)
    occ = V.voxelize(pts, G, dtype=torch.bfloat16).reshape(F, G ** 3)
    g = np.random.default_rng(32)
    kp = torch.from_numpy(g.uniform(-0.6, 0.6, (F, K, 3)).astype(
        np.float32)).to(device)
    gr = torch.from_numpy(g.uniform(-2.0, 2.0, F).astype(np.float32)).to(
        device)
    vox = coord_maps((G,) * 3, device=device).reshape(1, G ** 3, 3)
    vox = vox.expand(F, -1, -1)

    def library_k2():
        d = torch.cdist(vox, kp).square_().amin(dim=-1)
        return (d * occ).sum(dim=-1)

    kp_lib = kp.clone().requires_grad_(True)
    d = torch.cdist(vox, kp_lib).square().amin(dim=-1)
    lib_out = ((d * occ).sum(dim=-1) * gr).sum()

    def library_k2_bwd():
        return torch.autograd.grad(lib_out, kp_lib, retain_graph=True)

    t = {"path": k2_times(kp, occ, gr, G)}
    for name, o in k2_dense_grids(F, G, device).items():
        t[name] = k2_times(kp, o, gr, G)
    for direction in ("fwd", "bwd", "docc"):
        log(f"[time] chamfer_{direction} by occupancy: " + ", ".join(
            f"{name} ({r['occupied_voxels']} voxels) "
            f"{r[direction + '_ms']:.4f} ms, device "
            f"{r[direction + '_device_ms']:.4f}, bound "
            f"{r[direction + '_bound_ms']:.4f}" for name, r in t.items()))
    path = t["path"]
    extra = {"occupied_voxels": path["occupied_voxels"]}
    records.append(_record(
        "chamfer_fwd", "neural_marionette_tpu_torch/csrc/chamfer.cu",
        "neural_marionette_tpu/ops/pallas/chamfer_kernel.py:190",
        launches["chamfer_fwd"], errs["chamfer_fwd"], path["fwd_ms"],
        cuda_ms(lambda: L.chamfer_num_plain(kp, occ, G), iters=5),
        cuda_ms(library_k2, iters=5), *path["fwd_work"],
        device_ms=path["fwd_device_ms"],
        device_ms_kernels=path["fwd_kernels"], **extra,
        ms_dense30=t["dense30"]["fwd_ms"], ms_full=t["full"]["fwd_ms"]))
    records.append(_record(
        "chamfer_bwd", "neural_marionette_tpu_torch/csrc/chamfer.cu",
        "neural_marionette_tpu/ops/pallas/chamfer_kernel.py:218",
        launches["chamfer_bwd"], errs["chamfer_bwd"], path["bwd_ms"],
        cuda_ms(lambda: L.chamfer_num_bwd_plain(gr, kp, occ, G), iters=5),
        cuda_ms(library_k2_bwd, iters=5), *path["bwd_work"],
        device_ms=path["bwd_device_ms"],
        device_ms_kernels=path["bwd_kernels"], **extra,
        ms_dense30=t["dense30"]["bwd_ms"], ms_full=t["full"]["bwd_ms"]))
    # with the occupancy gradient (not on the training path): dmin at every
    # voxel and a write of the grid
    log(f"[time] chamfer_bwd with docc: kernel {path['docc_ms']:.4f} ms, "
        f"device {path['docc_device_ms']:.4f} ms "
        f"({path['docc_kernels']}), bound {path['docc_bound_ms']:.4f} ms")
    return records


def k2_dense_grids(F, G, device):
    """K2's dense yardsticks in bfloat16: about 30 % occupied at random,
    and fully occupied."""
    import torch
    g = np.random.default_rng(33)
    return {"dense30": torch.from_numpy(g.random((F, G ** 3)) < 0.3).to(
                device, torch.bfloat16),
            "full": torch.ones((F, G ** 3), dtype=torch.bfloat16,
                               device=device)}


def k2_times(kp, occ, gr, G, iters=20):
    """K2 forward, backward without and with docc on (kp, occ, gr): event
    ms per call (``cuda_ms``), device ms per call from the profiler (all
    the call's device operations, and by kernel), the bound and the work
    behind it. An empty voxel adds exactly 0, so the work these inputs need
    is at the occupied voxels only: per voxel the min over k (4 FMAs, 8
    flops, and a min per keypoint: 9 K), |v|^2, relu and the weighted add
    (8); the backward's weight, and the four sums of its nearest keypoints
    (16 in all); against one read of the grid, kp (and g) and one write of
    num (dkp). docc needs dmin at every voxel and writes the grid."""
    from neural_marionette_tpu_torch.ops import losses as L
    F, K = kp.shape[:2]
    calls = {"fwd": lambda: L.chamfer_num(kp, occ, G),
             "bwd": lambda: L._chamfer_bwd_cuda(gr, kp, occ, G, False),
             "docc": lambda: L._chamfer_bwd_cuda(gr, kp, occ, G, True)}
    occupied = int(occ.count_nonzero())
    grid = occ.numel() * occ.element_size()
    work = {"fwd": (kp.numel() * 4 + grid + F * 4,
                    [(occupied * (K * 9 + 8), PEAK_FP32_OPS_PER_S)]),
            "bwd": (F * 4 + kp.numel() * 4 * 2 + grid,
                    [(occupied * (K * 9 + 16), PEAK_FP32_OPS_PER_S)])}
    work["docc"] = (work["bwd"][0] + grid,
                    [(occ.numel() * (K * 9 + 8) + occupied * (K * 9 + 16),
                      PEAK_FP32_OPS_PER_S)])
    out = {"occupied_voxels": occupied}
    for name, fn in calls.items():
        out[f"{name}_ms"] = cuda_ms(fn, iters=iters)
        by_name = defaultdict(float)
        for e in device_events(fn):
            by_name[e.name.split("(")[0].split("<")[0].split()[-1]] += \
                e.time_range.elapsed_us() / 10e3
        out[f"{name}_device_ms"] = sum(by_name.values())
        out[f"{name}_kernels"] = dict(by_name)
        out[f"{name}_work"] = work[name]
        out[f"{name}_bound_ms"] = max(_bound_ms(*work[name]))
    return out


def _bound_ms(n_bytes, ops):
    """(ms to move ``n_bytes``, ms for ``ops``, a list of (operations, peak
    rate of their type))."""
    return (n_bytes / PEAK_BYTES_PER_S * 1e3,
            sum(n / peak for n, peak in ops) * 1e3)


def _record(name, source, replaces, launches, err, ms, plain_ms, library_ms,
            n_bytes, ops, **extra):
    """A ``kernels`` record; ``ops`` is a list of (operations, peak rate of
    their type)."""
    t_bytes, t_ops = _bound_ms(n_bytes, ops)
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms, **extra}
    log(f"[time] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}: {n_bytes} bytes, "
        f"{sum(n for n, _ in ops):.4g} ops)")
    return rec


def _k3_work(xs, cout, k=3):
    """(bytes, ops) of one bf16 conv: x, w, b read once, y written once."""
    Fr, D, H, W, Cin = xs
    vox = Fr * D * H * W
    n_bytes = 2 * (vox * Cin + k ** 3 * Cin * cout + cout + vox * cout)
    return n_bytes, [(2 * vox * k ** 3 * Cin * cout, PEAK_BF16_OPS_PER_S)]


def phase_route_window(cfg, device, routed, vox):
    """One AIST window (B=4) through the routed bf16 detector and through
    the same weights with the route off (cuDNN): keypoints within 1e-2
    (coordinates in [-1, 1]; the routes round the bf16 conv outputs apart
    by one ulp in about 0.1 % of the elements, and the soft-argmax averages
    heatmaps built from them: at the CPU tests' size they differ by 1.5e-4)
    and the mean abs difference of recon within 1e-2. The weights are
    ``_informative_weights``: with the seeded initial ones the two streams'
    keypoints come out equal to the bit. Returns the max abs keypoint
    difference."""
    import torch
    from neural_marionette_tpu_torch.models import NeuralMarionette
    plain = NeuralMarionette(cfg, dtype=torch.bfloat16, device=device).eval()
    plain.load_state_dict(routed.state_dict())
    with torch.inference_mode():
        a = routed.kypt_detector(vox)
        b = plain.kypt_detector(vox)
    kp = float((a["keypoints"] - b["keypoints"]).abs().max())
    rec = float((a["recon"].float() - b["recon"].float()).abs().mean())
    spread = float(a["keypoints"][..., :3].std(dim=(0, 1)).mean())
    log(f"[route] one window, informative weights, route on vs off: "
        f"keypoints max abs diff {kp:.3e} (their spread over the window "
        f"{spread:.3e}), recon mean abs diff {rec:.3e}")
    if not (kp <= 1e-2 and rec <= 1e-2):
        raise AssertionError(f"route on vs off: keypoints {kp:.3e}, recon "
                             f"{rec:.3e}")
    return kp


def phase_timing_conv(device, shapes, stages, errs):
    """K3 at every distinct routed conv shape of an AIST window (bf16, x
    stored NCDHW), weighted by its calls per window, against its plain
    version, cuDNN's bf16 ``F.conv3d`` at the same shape (timed here only)
    and its bound; K4 at the decoder's stage 3 (F=40, 64^3, 32->32, the
    model's weights and activations) against its plain version,
    ``F.conv3d`` + ``F.group_norm`` + ``F.leaky_relu`` in bf16 and its
    bound, with its device time from the profiler. Returns (the K3 and K4
    records, launches to be filled in from the main paths' runs, the
    per-shape K3 rows)."""
    import torch
    import torch.nn.functional as Fn
    from neural_marionette_tpu_torch.ops import conv3d as K3
    from neural_marionette_tpu_torch.ops import fusedstage as K4
    rows = []
    tot = defaultdict(float)
    for i, ((xs, ws), calls) in enumerate(sorted(shapes.items())):
        cout = ws[-1]
        x, w, b = _conv_operands(xs, cout, torch.bfloat16, device, 90 + i)
        xc = x.permute(0, 4, 1, 2, 3)
        wc = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous()
        bb = b.to(torch.bfloat16)
        n_bytes, ops = _k3_work(xs, cout)
        big = ops[0][0] > 1e11
        K3.packed_operands(w, b)    # packed once, as the route does

        def route_call():
            return K3.conv3d(x, w, b, packed=K3.packed_operands(w, b))

        row = {"x": list(xs), "cout": cout, "calls_per_window": calls,
               "ms": cuda_ms(route_call, iters=5 if big else 20),
               "plain_ms": cuda_ms(lambda: K3.conv3d_plain(x, w, b), iters=3,
                                   warmup=1),
               "library_ms": cuda_ms(lambda: Fn.conv3d(xc, wc, bb, padding=1),
                                     iters=5 if big else 20),
               "bound_ms": max(_bound_ms(n_bytes, ops))}
        row["tflops"] = ops[0][0] / row["ms"] / 1e9
        row["library_tflops"] = ops[0][0] / row["library_ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            tot[k] += calls * row[k]
        tot["bytes"] += calls * n_bytes
        tot["ops"] += calls * ops[0][0]
        log(f"[time] conv3d {xs}->{cout} x{calls}: kernel {row['ms']:.4f} ms "
            f"({row['tflops']:.1f} TFLOP/s, {100 * row['bound_share']:.1f} % "
            f"of its bound), plain {row['plain_ms']:.3f} ms, cuDNN "
            f"{row['library_ms']:.4f} ms ({row['library_tflops']:.1f} "
            f"TFLOP/s), bound {row['bound_ms']:.4f} ms")
        del x, xc
    # K3's record: the sums over the routed convs of one window
    records = [_record(
        "conv3d", "neural_marionette_tpu_torch/csrc/conv3d.cu",
        "neural_marionette_tpu/ops/pallas/conv3d_kernel.py:102",
        None, errs["conv3d"], tot["ms"], tot["plain_ms"],
        tot["library_ms"], int(tot["bytes"]),
        [(tot["ops"], PEAK_BF16_OPS_PER_S)],
        per=f"window ({ROUTED_CONVS} calls; ms, plain_ms, library_ms and "
            f"bound_ms summed over them)")]
    records[0]["bound_ms"] = tot["bound_ms"]   # the sum of per-call bounds
    log(f"[time] conv3d per window: sum of per-call bounds "
        f"{tot['bound_ms']:.4f} ms")

    # K4 at the decoder's stage 3
    x, w, b, sc, bi = stages[1][:5]
    Fr, D, H, W, Cin = x.shape
    cout = w.shape[-1]
    xc = x.permute(0, 4, 1, 2, 3)
    wc = w.permute(4, 3, 0, 1, 2).contiguous()
    bb, sb, bib = (t.to(torch.bfloat16) for t in (b, sc, bi))
    ng = max(cout // 16, 1)

    def library_k4():
        y = Fn.conv3d(xc, wc, bb, padding=1)
        return Fn.leaky_relu(Fn.group_norm(y, ng, sb, bib, 1e-5), 0.01)

    with torch.inference_mode():
        ms = cuda_ms(lambda: K4.fused_stage(x, w, b, sc, bi), iters=5)
        plain_ms = cuda_ms(lambda: K4.fused_stage_plain(x, w, b, sc, bi),
                           iters=3, warmup=1)
        library_ms = cuda_ms(library_k4, iters=5)
        dev = device_events(lambda: K4.fused_stage(x, w, b, sc, bi), n=3)
    pass1 = sum(e.time_range.elapsed_us() for e in dev
                if "conv3d_kernel" in e.name) / 3e3
    pass2 = sum(e.time_range.elapsed_us() for e in dev
                if "groupnorm_act" in e.name) / 3e3
    device_ms = sum(e.time_range.elapsed_us() for e in dev) / 3e3
    vox = Fr * D * H * W
    n_bytes, ops = _k3_work((Fr, D, H, W, Cin), cout)
    n_bytes += 8 * cout                       # scale and bias, float32
    ops.append((9 * vox * cout, PEAK_FP32_OPS_PER_S))  # moments, pass 2
    records.append(_record(
        "fused_stage", "neural_marionette_tpu_torch/csrc/conv3d.cu",
        "neural_marionette_tpu/ops/pallas/fusedstage_kernel.py:117",
        None, errs["fused_stage"], ms, plain_ms,
        library_ms, n_bytes, ops, device_ms=device_ms,
        device_ms_pass1=pass1, device_ms_pass2=pass2,
        device_ms_reduce=device_ms - pass1 - pass2,
        source_pass2="neural_marionette_tpu_torch/csrc/groupnorm.cu",
        pass2_bound_ms=2 * vox * cout * x.element_size() / PEAK_BYTES_PER_S
        * 1e3))
    log(f"[time] fused_stage device ms: pass 1 {pass1:.4f}, reduce "
        f"{device_ms - pass1 - pass2:.4f}, pass 2 {pass2:.4f} (bound "
        f"{records[-1]['pass2_bound_ms']:.4f}), all its device operations "
        f"{device_ms:.4f}")
    return records, rows


def _layer_ms(model, skeleton, pts, G, reps=5):
    """Host ms of each layer of one window, each between two
    ``torch.cuda.synchronize()`` calls, median of ``reps``. "losses" is the
    rest of ``KyptDetector.forward`` (K2 among it); "detector_pruned" the
    detector forward of the stream's default window (the encoder and the
    keypoints: no decoder, no loss)."""
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
            _, ms = timed(lambda: det(vox, outputs=()))
            rows["detector_pruned"].append(ms)
            _, ms = timed(lambda: dyn.encode(kp, skeleton,
                                             sample_num=SAMPLE_NUM,
                                             generator=gen))
            rows["vrnn_encode"].append(ms)
    med = {k: float(np.median(v)) for k, v in rows.items()}
    med["losses"] = med["detector_total"] - med["encoder"] - med["decoder"]
    return med


def _is_copy(name):
    """A device operation that only moves or casts data: ATen's copy and
    cast kernels, memcpys, cuDNN's NCDHW <-> NDHWC conversions."""
    low = name.lower()
    return ("copy" in low or "nchwtonhwc" in low or "nhwctonchw" in low
            or "transpose" in low)


def phase_profile(marionette, n_windows=4, conv_kernel=False,
                  outputs=None):
    """Where a serving window's time goes, after every check has passed:
    the layer times of one window (not with ``outputs``), then a bfloat16
    stream of ``n_windows`` (conv route off or on; the default outputs, the
    pruned window, or ``outputs``) under ``torch.profiler``: the device's
    busy share (the union of its kernel, copy and memset intervals over
    the wall time), its operations per window, the kernels that take the
    most device time, the copies and layout conversions, and the device
    time per call of the port's own kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from neural_marionette_tpu_torch.models import SkeletonArrays
    cfg = marionette.cfg
    tag = "profile conv_kernel" if conv_kernel else "profile"
    if outputs is not None:
        tag += " all outputs"
    stream = marionette.stream(
        dtype="bfloat16", sample_num=SAMPLE_NUM, conv_kernel=conv_kernel,
        **({} if outputs is None else {"outputs": outputs}))
    layers = None
    if outputs is None:
        skeleton = SkeletonArrays.from_skeleton(
            marionette.extract_skeleton(), marionette.device)
        pts = torch.from_numpy(serving_points(SERVE_B, SERVE_T, SERVE_N,
                                              seed=51)).to(marionette.device)
        layers = _layer_ms(stream.model, skeleton, pts, cfg.grid_size)
        log(f"[{tag}] layers: " + ", ".join(f"{k} {v:.2f} ms"
                                            for k, v in layers.items()))
    ws = [serving_points(SERVE_B, SERVE_T, SERVE_N, seed=200 + i)
          for i in range(n_windows)]
    # a window of a stream like it in the profiler's warm-up round: started
    # cold, the profiler misses the first device operations
    warm = marionette.stream(
        dtype="bfloat16", sample_num=SAMPLE_NUM, conv_kernel=conv_kernel,
        **({} if outputs is None else {"outputs": outputs}))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in warm.run(ws[:1]):
            pass
        torch.cuda.synchronize()
        prof.step()
        profiler_gap()
        t0 = time.perf_counter()
        for _ in stream.run(ws):
            pass
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        profiler_gap()
    del warm
    busy_ms, share, _, by_name = _busy(prof, wall_us)
    n = n_windows
    if _calls_of(by_name, "voxelize_kernel") != n:
        raise AssertionError(f"[{tag}] the profiler recorded "
                             f"{_calls_of(by_name, 'voxelize_kernel')} K1 "
                             f"launches in {n} windows")
    # the port's own kernels, by the names of their __global__s in csrc/
    ours = {k: v for k, v in by_name.items()
            if any(p in k for p in PORT_KERNELS)}
    copies = [v for k, v in by_name.items() if _is_copy(k)]
    out = {"windows": n, "conv_kernel": conv_kernel, "layers_ms": layers,
           "copy_ms_per_window": sum(us for us, _ in copies) / n / 1e3,
           "copies_per_window": sum(c for _, c in copies) / n,
           "wall_ms_per_window": wall_us / n / 1e3,
           "device_busy_ms_per_window": busy_ms / n,
           "device_busy_share": share,
           "device_ops_per_window": sum(c for _, c in by_name.values()) / n,
           "top_kernels": _top_kernels(by_name, n, "window"),
           "port_kernels": [{"name": k[:90],
                             "device_ms_per_call": v[0] / v[1] / 1e3,
                             "calls_per_window": v[1] / n}
                            for k, v in ours.items()]}
    log(f"[{tag}] {n} windows: wall {out['wall_ms_per_window']:.2f} ms, "
        f"device busy {out['device_busy_ms_per_window']:.2f} ms per window "
        f"(share {out['device_busy_share']:.3f}), "
        f"{out['device_ops_per_window']:.0f} device operations per window; "
        f"copies and layout conversions {out['copy_ms_per_window']:.2f} ms, "
        f"{out['copies_per_window']:.0f} per window")
    for k in out["port_kernels"]:
        log(f"[{tag}] port kernel {k['device_ms_per_call']:.4f} ms per "
            f"call, {k['calls_per_window']:.1f} per window: {k['name']}")
    for k in out["top_kernels"]:
        log(f"[{tag}] {k['ms_per_window']:8.3f} ms "
            f"{k['calls_per_window']:6.1f} per window: {k['name']}")
    return out


# ------------------------------------------------------------------- apps
APP_N = 4096
ROUTED_DECODER_CONVS = 4   # routed convs of the decoder alone (decode_from_dyna)


def motion_points(T, N, seed):
    """(T, N, 3) float32 points of one clip: a blob drifting across the
    clip, inside [-0.7, 0.7]^3 (the apps voxelize on the host, where a
    point outside [-1, 1] is clamped onto the grid's face)."""
    g = np.random.default_rng(seed)
    base = g.normal(0.0, 0.25, (1, N, 3)) * np.array([0.6, 1.0, 0.5])
    drift = np.linspace(-0.2, 0.2, T)[:, None, None] * g.uniform(-1, 1, 3)
    return np.clip(base + drift, -0.7, 0.7).astype(np.float32)


class _Argmins:
    """Record each ``torch.argmin`` of a run with its input (on the host),
    to compare the selections of two runs."""

    def __init__(self):
        import torch
        self.calls, self._orig = [], torch.argmin

    def __enter__(self):
        import torch

        def rec(x, *a, **k):
            out = self._orig(x, *a, **k)
            self.calls.append((x.detach().float().cpu().numpy(),
                               out.cpu().numpy()))
            return out
        torch.argmin = rec
        return self

    def __exit__(self, *exc):
        import torch
        torch.argmin = self._orig


def compare_selections(card, host, what, rtol=1e-5):
    """The card's and the CPU's argmins of the same rollout: equal, or each
    mismatch a float32 near-tie (the two picks' distances on the card
    within ``rtol`` of each other). Returns the number of near-ties."""
    if len(card.calls) != len(host.calls):
        raise AssertionError(f"{what}: {len(card.calls)} argmins on the card,"
                             f" {len(host.calls)} on the CPU")
    ties = 0
    for i, ((d, a), (_, b)) in enumerate(zip(card.calls, host.calls)):
        if np.array_equal(a, b):
            continue
        da = np.take_along_axis(d, np.expand_dims(a, 0), 0) if d.ndim > 1 \
            else d[a]
        db = np.take_along_axis(d, np.expand_dims(b, 0), 0) if d.ndim > 1 \
            else d[b]
        if not np.all(np.abs(da - db) <= rtol * np.abs(da)):
            raise AssertionError(f"{what}: argmin {i} picks {a} on the card, "
                                 f"{b} on the CPU, distances {da} vs {db}")
        ties += 1
    return ties


def _app_marionette(cfg, device, seed=0):
    """A float32 ``Marionette`` with seeded informative weights."""
    from neural_marionette_tpu_torch.api import Marionette
    from neural_marionette_tpu_torch.models import NeuralMarionette
    net = NeuralMarionette(cfg, device=device)
    _informative_weights(net, seed)
    return Marionette(cfg, net, device)


def _timed_call(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_apps(cfg, device, keep=None):
    """Generation, interpolation and retargeting through the port's
    ``Marionette`` at the full AIST width in float32, with seeded
    informative weights, each called twice (ms of both calls; the first
    pays the set-up): ``generate`` on a 5-frame clip (Tgen 25,
    sample_num 3), ``interpolate`` on a 20-frame clip (anchor_rate 10,
    sample_num 10000), ``retarget`` of a 10-frame clip onto a 4096-point
    target in modes ``ours`` and ``baseline``, then an ``encode`` of the
    source for its rotations. Checks the JAX shapes, finite outputs,
    voxels in {0, 1}, anchors and frozen intensities, skin weights summing
    to 1, R orthonormal, and K2 forward launched once per detector forward
    (counted by a hook on the detector), K1 and K3 never (the apps
    voxelize on the host, and float32 takes no conv route). ``keep``
    receives the second round's results, the clips and the marionette, for
    the render phase."""
    import torch
    from neural_marionette_tpu_torch.ops import conv3d as K3
    from neural_marionette_tpu_torch.ops import losses as L
    from neural_marionette_tpu_torch.ops import voxelize as V
    G, K = cfg.grid_size, cfg.nkeypoints
    m = _app_marionette(cfg, device)
    clip20 = m.voxelize(motion_points(20, APP_N, seed=61))
    source = m.voxelize(motion_points(10, APP_N, seed=62))
    target = motion_points(1, APP_N, seed=63)[0] * np.float32(1.2)
    forwards = [0]
    hook = m.model.kypt_detector.register_forward_pre_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    ms = defaultdict(list)
    V.launches = L.launches = K3.launches = 0
    try:
        for _ in range(2):
            gen, t = _timed_call(lambda: m.generate(clip20[:5], Tcond=5,
                                                    Tgen=25, sample_num=3))
            ms["generate"].append(t)
            itp, t = _timed_call(lambda: m.interpolate(
                clip20, anchor_rate=10, sample_num=10000))
            ms["interpolate"].append(t)
            ret = {}
            for mode in ("ours", "baseline"):
                ret[mode], t = _timed_call(lambda: m.retarget(
                    source, target, mode=mode))
                ms[f"retarget_{mode}"].append(t)
        enc = m.encode(source)
    finally:
        hook.remove()
    launches = {"voxelize": V.launches, "chamfer_fwd": L.launches,
                "conv3d": K3.launches, "detector_forwards": forwards[0]}
    # per round: generate 1, interpolate 1, retarget 2 per mode; then encode
    if (launches["chamfer_fwd"] != forwards[0] or forwards[0] != 2 * 6 + 1
            or V.launches or K3.launches):
        raise AssertionError(f"apps launches {launches}: want K2 forward "
                             f"once per detector forward (13), K1 and K3 "
                             f"never")

    def want(name, v, shape):
        if v.shape != shape or not np.isfinite(v).all():
            raise AssertionError(f"{name}: shape {v.shape} (want {shape}),"
                                 f" finite {np.isfinite(v).all()}")

    want("generate gen_voxels", gen["gen_voxels"], (3, 30, G, G, G, 1))
    want("generate keypoints", gen["keypoints"], (3, 30, K, 4))
    want("generate cond_keypoints", gen["cond_keypoints"], (5, K, 4))
    want("interpolate interp_voxels", itp["interp_voxels"], (20, G, G, G, 1))
    want("interpolate keypoints", itp["keypoints"], (20, K, 4))
    for v in (gen["gen_voxels"], itp["interp_voxels"]):
        if not set(np.unique(v)) <= {0.0, 1.0}:
            raise AssertionError("app voxels not thresholded to {0, 1}")
    kp, det = itp["keypoints"], itp["detected_keypoints"]
    if not (np.array_equal(kp[[0, 10, 19], :, :3], det[[0, 10, 19], :, :3])
            and np.array_equal(kp[:, :, 3], np.broadcast_to(det[0, :, 3],
                                                             (20, K)))):
        raise AssertionError("interpolate: anchors or intensities changed")
    if not np.array_equal(gen["keypoints"][:, :5],
                          np.broadcast_to(gen["cond_keypoints"],
                                          (3, 5, K, 4))):
        raise AssertionError("generate: conditioning keypoints differ")
    for mode, r in ret.items():
        res = r["result"]
        want(f"retarget {mode} new_points", res.new_points, (10, APP_N, 3))
        want(f"retarget {mode} new_keypoints", res.new_keypoints, (10, K, 4))
        want(f"retarget {mode} skin_weights", res.skin_weights, (APP_N, K))
        if not np.allclose(res.skin_weights.sum(-1), 1.0, atol=1e-9):
            raise AssertionError(f"retarget {mode}: skin weights")
    R = enc["R"].astype(np.float64)
    orth = float(np.abs(R @ np.swapaxes(R, -1, -2) - np.eye(3)).max())
    det_err = float(np.abs(np.linalg.det(R) - 1).max())
    if not (orth < 1e-5 and det_err < 1e-5):
        raise AssertionError(f"R not orthonormal: {orth:.2e}, det "
                             f"{det_err:.2e}")
    out = {"ms": {k: [float(x) for x in v] for k, v in ms.items()},
           "breakdown_ms": _app_breakdown(m, clip20, source, target),
           "launches": launches, "R_orthonormal_max_err": orth,
           "R_det_max_err": det_err,
           "shapes": {"generate": [5, 25, 3], "interpolate": [20, 10, 10000],
                      "retarget": [10, APP_N]}}
    log(f"[apps] ms (first, second call): "
        + ", ".join(f"{k} {v[0]:.1f}/{v[1]:.1f}" for k, v in ms.items()))
    log(f"[apps] launches {launches}; R orthonormal to {orth:.1e}")
    if keep is not None:
        keep.update(gen=gen, itp=itp, ret=ret["ours"], clip20=clip20,
                    source=source, target=target, marionette=m)
    del m
    torch.cuda.empty_cache()
    return out


def _app_breakdown(m, clip20, source, target):
    """Where an app call's time goes: its parts timed one by one, each
    synchronised (ms): the detector forward, the VRNN rollout, the decode
    (``decode_from_dyna``, per call), and retargeting's host part."""
    import torch
    from neural_marionette_tpu_torch.apps.common import \
        detect_and_extract_skeleton
    from neural_marionette_tpu_torch.models import SkeletonArrays
    from neural_marionette_tpu_torch.retarget import retarget_motion
    dyn, det_mod = m.model.dyna_module, m.model.kypt_detector
    sk_host = m.extract_skeleton()
    sk = SkeletonArrays.from_skeleton(sk_host, m.device)
    out = {}

    def part(name, fn):
        res, out[name] = _timed_call(fn)
        return res

    with torch.inference_mode():
        for tag, clip in (("generate", clip20[:5]), ("interpolate", clip20),
                          ("retarget", source)):
            det, _ = part(f"{tag}_detector_{len(clip)}_frames",
                          lambda: detect_and_extract_skeleton(m, clip))
            first = m.clip_tensor(clip[:1])[:, 0]
            if tag == "generate":
                gen = torch.Generator(m.device).manual_seed(2)
                cond, roll = part("generate_rollout", lambda: (
                    dyn.generate_many(det["keypoints"], sk, 30, 5, 3,
                                      generator=gen)))
                kp = torch.cat([cond, roll[:1]], dim=1)
                part("generate_decode_30_frames", lambda: (
                    det_mod.decode_from_dyna(kp, det["first_feature"],
                                             first)))
            elif tag == "interpolate":
                gen = torch.Generator(m.device).manual_seed(2)
                sel = part("interpolate_rollout", lambda: dyn.interpolate(
                    det["keypoints"], sk, 10, 10000, generator=gen))
                part("interpolate_decode_20_frames", lambda: (
                    det_mod.decode_from_dyna(sel, det["first_feature"],
                                             first)))
            else:
                enc = part("retarget_encode_10_frames", lambda: dyn.encode(
                    det["keypoints"], sk))
    kp = det["keypoints"][0].cpu().numpy().astype(np.float64)
    R = enc["R"][0].cpu().numpy().astype(np.float64)
    offset = dyn.get_offset(det["keypoints"][:, :1], sk.parents)[0]
    for mode in ("ours", "baseline"):
        t0 = time.perf_counter()
        retarget_motion(sk_host, kp, R, kp[0], R[0], target.astype(
            np.float64), offset.cpu().numpy(), mode=mode)
        out[f"retarget_motion_host_{mode}"] = \
            (time.perf_counter() - t0) * 1e3
    log("[apps] parts, ms: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in out.items()))
    return out


def phase_generate_step(cfg, device, B=4, T=10, Tcond=3, reps=3):
    """The training loop's generate step (``make_generate_step``) on a
    bfloat16 model of the AIST detector preset with Tcond 3, on (4, 10,
    4096, 3) point batches, with the conv route on and off: K3 launched
    once per routed conv of a detector forward (``ROUTED_CONVS``) plus
    once per routed conv of the decoder (``decode_from_dyna``) per step, K1
    and K2 forward once. Route on against off, same weights and noise:
    the detected keypoints within 2e-2 (as the stream's), the generated
    ones within 0.25 (they roll out of bfloat16 detections), and at most
    1 % of the voxels thresholded otherwise. Returns ms per step (first
    and timed), launches, and those differences."""
    import dataclasses
    import torch
    from neural_marionette_tpu_torch.models import NeuralMarionette, \
        SkeletonArrays
    from neural_marionette_tpu_torch.models.blocks import routes_to_kernel
    from neural_marionette_tpu_torch.ops import conv3d as K3
    from neural_marionette_tpu_torch.ops import losses as L
    from neural_marionette_tpu_torch.ops import voxelize as V
    from neural_marionette_tpu_torch.skeleton import extract_skeleton
    from neural_marionette_tpu_torch.train import make_generate_step
    cfg = dataclasses.replace(cfg, Tcond=Tcond)
    pts = torch.from_numpy(serving_points(B, T, SERVE_N, seed=71)).to(device)
    out, runs = {}, {}
    for route in (False, True):
        net = NeuralMarionette(cfg, dtype=torch.bfloat16, device=device,
                               conv_kernel=route).eval()
        _informative_weights(net, seed=0)
        routed = sum(isinstance(mod, torch.nn.Conv3d)
                     and routes_to_kernel(mod, torch.bfloat16)
                     for mod in net.kypt_detector.kypt_to_vox.modules())
        if routed != ROUTED_DECODER_CONVS:
            raise AssertionError(f"decoder routed convs {routed}")
        with torch.no_grad():
            aff = net.kypt_detector.get_affinity().cpu().numpy()
        sk = SkeletonArrays.from_skeleton(extract_skeleton(aff), device)
        step = make_generate_step(net, cfg, sample_num=SAMPLE_NUM)
        ms = []
        for i in range(reps):
            gen = torch.Generator(device).manual_seed(5)
            V.launches = L.launches = K3.launches = 0
            res, t = _timed_call(lambda: step(pts, sk, generator=gen))
            ms.append(t)
            counts = {"voxelize": V.launches, "chamfer_fwd": L.launches,
                      "conv3d": K3.launches}
            k3 = (ROUTED_CONVS + ROUTED_DECODER_CONVS) if route else 0
            if counts != {"voxelize": 1, "chamfer_fwd": 1, "conv3d": k3}:
                raise AssertionError(f"generate step (conv_kernel={route}) "
                                     f"launches {counts}, K3 want {k3}")
        G, K = cfg.grid_size, cfg.nkeypoints
        if (res["gen"].shape != (B, T, G, G, G, 1)
                or res["keypoints"].shape != (B, T, K, 4)
                or not torch.isfinite(res["gen"].float()).all()
                or not torch.isfinite(res["keypoints"]).all()):
            raise AssertionError("generate step outputs")
        runs[route] = {k: res[k].float().cpu().numpy()
                       for k in ("gen", "keypoints")}
        name = "conv_kernel" if route else "default"
        out[name] = {"ms": [float(x) for x in ms], "launches": counts}
        log(f"[generate step] {name}: B {B} T {T} Tcond {Tcond} bf16, ms "
            f"{[round(x, 1) for x in ms]}, launches {counts}")
        del net, step, res
        torch.cuda.empty_cache()
    on, off = runs[True], runs[False]
    kp_cond = float(np.abs(on["keypoints"][:, :Tcond]
                           - off["keypoints"][:, :Tcond]).max())
    kp_gen = float(np.abs(on["keypoints"][:, Tcond:]
                          - off["keypoints"][:, Tcond:]).max())
    flips = float(np.mean((on["gen"] >= 0.5) != (off["gen"] >= 0.5)))
    if not (kp_cond <= 2e-2 and kp_gen <= 0.25 and flips <= 0.01):
        raise AssertionError(f"generate step route on vs off: keypoints "
                             f"{kp_cond:.3e} / {kp_gen:.3e}, voxel flips "
                             f"{flips:.2e}")
    out.update(B=B, T=T, Tcond=Tcond, sample_num=SAMPLE_NUM,
               keypoints_cond_max_abs_diff=kp_cond,
               keypoints_gen_max_abs_diff=kp_gen, voxel_flip_share=flips)
    log(f"[generate step] route on vs off: detected keypoints {kp_cond:.2e},"
        f" generated {kp_gen:.2e}, voxel flips {flips:.2e}")
    return out


def phase_apps_reference(cfg, card_device):
    """Card against CPU (plain versions), float32 with TF32 off, same
    weights, skeleton and injected noise, at the full width: generation
    (Tcond 5, Tgen 2, sample_num 2) and interpolation (T 6, anchor_rate
    3, S 64) through the apps. Tolerances: keypoints 1e-3 absolute (the
    detected ones agree to 1e-4, phase_reference, and the FK chain
    amplifies them), thresholded voxels equal on all but 1e-4 of the grid
    (a voxel within the decoders' agreement of 0.5 may flip); every
    argmin equal, or a float32 near-tie (``compare_selections``)."""
    import torch
    from neural_marionette_tpu_torch.apps.generation import run_generation
    from neural_marionette_tpu_torch.apps.interpolation import \
        run_interpolation
    cpu = torch.device("cpu")
    card = _app_marionette(cfg, card_device)
    host = _app_marionette(cfg, cpu)
    for a, b in zip(card.extract_skeleton(), host.extract_skeleton()):
        if not np.array_equal(a, b):
            raise AssertionError("skeleton differs between card and CPU")
    Z = cfg.nlatent_kypt
    g = np.random.default_rng(81)
    gen_eps = (g.standard_normal((5, 2, 1, Z)), g.standard_normal((2, 2, Z)))
    itp_eps = (g.standard_normal((6, 64, Z)), g.standard_normal((6, 64, Z)))
    clip = card.voxelize(motion_points(6, APP_N, seed=82))
    res, rec = {}, {}
    for m in (card, host):
        def eps(e):
            return tuple(torch.from_numpy(x.astype(np.float32)).to(m.device)
                         for x in e)
        with _Argmins() as r:
            res[m is card] = (
                run_generation(m, clip, Tcond=5, Tgen=2, sample_num=2,
                               eps=eps(gen_eps)),
                run_interpolation(m, clip, anchor_rate=3, sample_num=64,
                                  eps=eps(itp_eps)))
        rec[m is card] = r
    ties = compare_selections(rec[True], rec[False], "apps card vs CPU")
    errs = {}
    (gc, ic), (gh, ih) = res[True], res[False]
    for name, a, b in (("generate keypoints", gc["keypoints"],
                        gh["keypoints"]),
                       ("interpolate keypoints", ic["keypoints"],
                        ih["keypoints"])):
        errs[name] = float(np.abs(a - b).max())
        if not errs[name] <= 1e-3:
            raise AssertionError(f"{name}: card vs CPU {errs[name]:.3e}")
    for name, a, b in (("generate voxels", gc["gen_voxels"],
                        gh["gen_voxels"]),
                       ("interpolate voxels", ic["interp_voxels"],
                        ih["interp_voxels"])):
        errs[name + " mismatch share"] = float(np.mean(a != b))
        if not np.mean(a != b) <= 1e-4:
            raise AssertionError(f"{name}: card vs CPU differ on "
                                 f"{np.mean(a != b):.2e} of the grid")
    errs["argmins"] = len(rec[True].calls)
    errs["argmin_near_ties"] = ties
    log("[apps reference] float32 card vs CPU: " + ", ".join(
        f"{k} {v:.2e}" if isinstance(v, float) else f"{k} {v}"
        for k, v in errs.items()))
    return errs


# --------------------------------------------------------------------- cli
CLI_SEQS = {"train": 12, "test": 4}   # sequences per split
CLI_FRAMES, CLI_POINTS = 40, 20000    # prepare_aistpp.py's --n_points
CLI_B, CLI_N, CLI_WORKERS = 4, 4096, 4
# launches of the two CLI runs. Every epoch: 3 train steps (K1 and K2
# forward each; K2 backward in the detector phase only), 1 eval step (K1,
# K2 forward), the GT voxels of voxel_chamfer (K1) and the GIF logging's
# voxels of the first validation batch (K1; every epoch below 10 logs).
# A learner epoch adds the generate step on that batch (K1 for its voxels,
# K2 forward in its detector forward). So K1 6 (detector epoch) + 7
# (learner epoch) = 13 and K2 forward 4 + 5 = 9 in the first run; K1 7 and
# K2 forward 5 in the resumed learner epoch, whose conv route puts 48
# convs a detector forward on K3 (3 train steps and the eval step) and
# ROUTED_CONVS + ROUTED_DECODER_CONVS = 52 in the generate step.
CLI_LAUNCHES = [{"voxelize": 6 + 7, "chamfer_fwd": 4 + 5, "chamfer_bwd": 3,
                 "conv3d": 0},
                {"voxelize": 7, "chamfer_fwd": 5, "chamfer_bwd": 0,
                 "conv3d": 4 * ROUTED_CONVS + ROUTED_CONVS
                 + ROUTED_DECODER_CONVS}]
CLI_GIF_VIDEOS = 4   # min(log_gif_num 4 of the AIST preset, B 4)
CLI_GEN_SAMPLES = 1  # cli.vis_generation's --sample_num (its default 3)
# SMPL's kinematic tree (24 joints), the parents prepare_aistpp.py reads
SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14,
                16, 17, 18, 19, 20, 21)


def write_aist_tree(root: Path, seed: int = 0) -> int:
    """A dataset tree in the AIST++ prepared layout (prepare_aistpp.py):
    ``aist_plusplus_smpl_joints/{surface,joints,root_aligns}/<split>/
    <seq>.npy`` and ``gt_affinity.npy`` from the SMPL parents; float32
    point clouds of a body-sized blob drifting over the clip, 24 joints
    among them, a yaw per frame. Returns the bytes written."""
    g = np.random.default_rng(seed)
    base = root / "aist_plusplus_smpl_joints"
    total = 0
    for split, n in CLI_SEQS.items():
        for sub in ("surface", "joints", "root_aligns"):
            (base / sub / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            body = (g.normal(0.0, 0.25, (CLI_POINTS, 3))
                    * np.array([0.3, 0.9, 0.2])).astype(np.float32)
            t = np.arange(CLI_FRAMES, dtype=np.float32)[:, None, None]
            drift = t * g.uniform(-0.01, 0.01, 3).astype(np.float32)
            sway = 0.05 * np.sin(0.3 * t + body[None, :, 1:2] * 4)
            pts = body[None] + drift
            pts[..., 0:1] += sway
            joints = pts[:, :24].copy()
            yaw = 0.05 * np.arange(CLI_FRAMES) + i
            c, sn = np.cos(yaw), np.sin(yaw)
            rots = np.zeros((CLI_FRAMES, 3, 3), np.float32)
            rots[:, 0, 0] = rots[:, 2, 2] = c
            rots[:, 0, 2], rots[:, 2, 0], rots[:, 1, 1] = sn, -sn, 1
            name = f"gBR_sBM_c{split[:2]}_d{i:02d}_mBR0_ch01.npy"
            for sub, arr in (("surface", pts), ("joints", joints),
                             ("root_aligns", rots)):
                np.save(base / sub / split / name, arr)
                total += arr.nbytes
    aff = np.zeros((24, 24), np.float32)
    for k, parent in enumerate(SMPL_PARENTS):
        if parent >= 0:
            aff[k, parent] = aff[parent, k] = 1.0
    np.save(base / "gt_affinity.npy", aff)
    return total + aff.nbytes


def cli_argv(data, out, **extra):
    """``cli.train`` flags: the AIST preset (every field ``adjust_config``
    sets, given verbatim), then ``extra``."""
    import dataclasses
    from neural_marionette_tpu_torch import MarionetteConfig, adjust_config
    plain = MarionetteConfig(dataset="aist")
    preset = adjust_config(plain)
    argv = []
    for f in dataclasses.fields(preset):
        v = getattr(preset, f.name)
        if v != getattr(plain, f.name) or f.name == "dataset":
            argv += [f"--{f.name}", str(v)]
    fields = dict(data_root=data, output_root=out, exp_name="smoke",
                  apply_adjust_config=0, nbatch=CLI_B, n_points=CLI_N,
                  num_workers=CLI_WORKERS, is_eval=1, eval_voxel_chamfer=1,
                  detector_start=0, detector_end=1, learner_start=1,
                  affinity_anneal=0, save_every=1,
                  compute_dtype="bfloat16")
    fields.update(extra)
    for k, v in fields.items():
        argv += [f"--{k}", str(v)]
    return argv


def _cli_launches(run):
    """(launches of K1, K2 fwd/bwd and K3 over ``run()``, its result):
    the counters set to 0 just before and read just after."""
    from neural_marionette_tpu_torch.ops import conv3d as K3
    from neural_marionette_tpu_torch.ops import losses as L
    from neural_marionette_tpu_torch.ops import voxelize as V
    V.launches = L.launches = L.bwd_launches = K3.launches = 0
    out = run()
    return dict(voxelize=V.launches, chamfer_fwd=L.launches,
                chamfer_bwd=L.bwd_launches, conv3d=K3.launches), out


def _loader_ms(cfg, workers, epochs=2):
    """Host ms per batch of the train loader at ``workers`` threads over
    ``epochs`` epochs (the files are in the page cache)."""
    from neural_marionette_tpu_torch.data import DataLoader, load_dataset
    ds = load_dataset(True, cfg)
    with DataLoader(ds, cfg.nbatch, seed=cfg.seed,
                    num_workers=workers) as loader:
        t0 = time.perf_counter()
        n = 0
        for epoch in range(epochs):
            ds.log_epoch(epoch)
            n += sum(1 for _ in loader)
        return (time.perf_counter() - t0) * 1e3 / n


def _loader_steps(cfg, device, n_epochs=4, n_profiled=3):
    """A bfloat16 ``Trainer`` stepping on the train loader through
    ``prefetch_to_device``, as the CLI does: per phase (epoch 0 the
    detector, epoch 1 the learner) ``n_epochs`` loader epochs of steps, the
    card synchronised before each batch; then ``n_profiled`` steps under
    the profiler, of a stream that already runs (one step outside the
    profiler, one under a profiler that warms it).

    Taking batch ``k`` from the prefetcher pulls batch ``k + 1`` from the
    loader, and a pull that opens a loader epoch waits for its batch's
    loads, which the loader queues only then. The timed steps are split by
    that pull (``ms_epoch_start``: the gaps that hold one; the loader's
    epochs here are 3 batches, the CLI's one a training epoch). The
    profiled window holds none: the batch whose taking pulls an epoch's
    first batch is taken just before it, so that the window reads the
    steps inside an epoch."""
    import itertools
    import torch
    from torch.profiler import ProfilerActivity, profile
    from neural_marionette_tpu_torch.data import (DataLoader, load_dataset,
                                                  prefetch_to_device)
    from neural_marionette_tpu_torch.train import Trainer
    ds = load_dataset(True, cfg)
    trainer = Trainer(cfg, device=device, dtype="bfloat16")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    with DataLoader(ds, cfg.nbatch, seed=cfg.seed,
                    num_workers=cfg.num_workers) as loader:
        per = len(loader)
        if per < n_profiled:
            raise AssertionError(f"a loader epoch of {per} batches")

        def stream(n):
            return prefetch_to_device(
                (b for _ in range(n) for b in loader), device=device)

        for epoch, name in ((0, "detector"), (1, "learner")):
            ds.log_epoch(epoch)
            stamps = []
            trainer.train_epoch(epoch, _timed(stream(n_epochs), stamps))
            ms = np.diff(stamps) * 1e3
            # gap j: the step of batch j, then taking batch j + 1, which
            # pulls batch j + 2 from the loader
            opens = [j for j in range(1, len(ms))
                     if (j + 2) % per == 0 and j + 2 < len(ms)]
            inner = [j for j in range(1, len(ms)) if j not in opens]
            running = stream(2)
            trainer.train_epoch(epoch, itertools.islice(running, 1))
            with profile(activities=acts):
                trainer.train_epoch(epoch, itertools.islice(running, 1))
            # taking the next batch pulls the first of the loader's second
            # epoch
            first = next(running)
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                trainer.train_epoch(epoch, itertools.chain(
                    [first], itertools.islice(running, n_profiled - 1)))
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            running.close()
            busy_ms, share, _, _ = _busy(prof, wall_us)
            out[name] = {"steps": len(ms), "step_ms": [float(x) for x in ms],
                         "p50_ms_per_step": float(np.percentile(ms[1:], 50)),
                         "mean_ms_per_step": float(ms[1:].mean()),
                         "p50_ms_within_epoch":
                             float(np.percentile(ms[inner], 50)),
                         "ms_epoch_start": [float(ms[j]) for j in opens],
                         "profiled_steps": n_profiled,
                         "profiled_wall_ms_per_step":
                             wall_us / 1e3 / n_profiled,
                         "device_busy_ms_per_step": busy_ms / n_profiled,
                         "device_busy_share": share}
            log(f"[cli] {name} steps through the loader ({CLI_WORKERS} "
                f"threads, prefetch to the card): ms "
                f"{[round(float(x), 1) for x in ms]}, p50 "
                f"{out[name]['p50_ms_per_step']:.2f} of {len(ms) - 1}, "
                f"{out[name]['p50_ms_within_epoch']:.2f} of the "
                f"{len(inner)} inside a loader epoch, those that pull an "
                f"epoch's first batch {[round(float(ms[j]), 1) for j in opens]}; "
                f"{n_profiled} profiled steps inside an epoch: wall "
                f"{wall_us / 1e3 / n_profiled:.1f} ms, busy "
                f"{busy_ms / n_profiled:.1f} ms a step, share {share:.3f}")
    del trainer
    return out


def _semantic_informative(cfg, device):
    """``Trainer.validate``'s semantic score on the validation loader with
    weights whose keypoints follow the points (``_informative_weights``).
    The CLI's seeded weights may leave every keypoint below the 0.2
    intensity threshold, and then every GT joint maps to keypoint 0 and
    the score is 1 by construction; here the histogram must spread over
    more than one keypoint. Returns (score, keypoints hit)."""
    import torch
    from neural_marionette_tpu_torch.data import (DataLoader, load_dataset,
                                                  prefetch_to_device)
    from neural_marionette_tpu_torch.eval import semantic_final
    from neural_marionette_tpu_torch.train import Trainer
    trainer = Trainer(cfg, device=device, dtype="bfloat16")
    _informative_weights(trainer.model, seed=0)
    with DataLoader(load_dataset(False, cfg), cfg.nbatch, seed=cfg.seed,
                    num_workers=CLI_WORKERS) as loader:
        _, scores = trainer.validate(
            0, prefetch_to_device(iter(loader), device=device), ["semantic"])
    hist = scores["semantic"]
    hit = int(np.count_nonzero(hist.sum(0)))
    if hist.shape != (24, cfg.nkeypoints) or hit < 2:
        raise AssertionError(f"semantic with informative weights: histogram "
                             f"{hist.shape}, {hit} keypoints hit")
    score = semantic_final(hist)
    log(f"[cli] semantic with informative weights (validation loader, "
        f"bf16): {score:.4f}, {hit} of {cfg.nkeypoints} keypoints hit")
    del trainer
    torch.cuda.empty_cache()
    return score, hit


def _check_loader_on_card(cfg, device):
    """The validation and train loaders' batches on the card (4 threads,
    prefetch) equal to the same batches built on the host (no threads)."""
    import torch
    from neural_marionette_tpu_torch.data import (DataLoader, load_dataset,
                                                  prefetch_to_device)
    n = 0
    for train in (True, False):
        host_ds, card_ds = load_dataset(train, cfg), load_dataset(train, cfg)
        host = list(DataLoader(host_ds, cfg.nbatch, seed=1, num_workers=0))
        with DataLoader(card_ds, cfg.nbatch, seed=1,
                        num_workers=CLI_WORKERS) as loader:
            card = list(prefetch_to_device(iter(loader), device=device))
        if len(card) != len(host) or not host:
            raise AssertionError(f"loader: {len(card)} batches on the card, "
                                 f"{len(host)} on the host")
        for c, h in zip(card, host):
            if not isinstance(c, tuple) or c[0].device.type != "cuda":
                raise AssertionError("loader: a batch is not a (points, "
                                     "joints) tuple on the card")
            for ct, ht in zip(c, h):
                if not torch.equal(ct.cpu(), torch.from_numpy(ht)):
                    raise AssertionError("loader: the card's batch differs "
                                         "from the host's")
            n += 1
    return n


def _check_cli_files(exp: Path):
    """The files ``train.py`` writes, with its record keys; returns the
    epoch records."""
    for name in ("opt.json", "metrics.jsonl", "semantic_result.csv",
                 "chamfer_result.csv", "affinity_result.json"):
        if not (exp / name).is_file():
            raise AssertionError(f"cli: {name} missing under {exp}")
    records = [json.loads(ln) for ln in
               (exp / "metrics.jsonl").read_text().splitlines()]
    if [r["epoch"] for r in records] != [0, 1, 2]:
        raise AssertionError(f"cli: epochs {[r['epoch'] for r in records]}")
    for r in records:
        if set(r) != {"epoch", "lr", "time", "train", "valid"} or not \
                {"semantic", "voxel_chamfer"} <= set(r["valid"]):
            raise AssertionError(f"cli: record keys {r}")
        bad = [f"{p}/{k}" for p in ("train", "valid")
               for k, v in r[p].items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"cli: epoch {r['epoch']} not finite: {bad}")
    if sorted(os.listdir(exp / "epochs"), key=int) != ["0", "1", "2"]:
        raise AssertionError(f"cli: checkpoints {os.listdir(exp / 'epochs')}")
    hist = np.loadtxt(exp / "semantic_result.csv", delimiter=",")
    if hist.shape != (24, 24) or not np.allclose(hist.sum(1), 1.0):
        raise AssertionError(f"cli: semantic_result.csv {hist.shape}")
    aff = json.loads((exp / "affinity_result.json").read_text())
    if aff["gt_edges"] != 23:
        raise AssertionError(f"cli: affinity_result.json {aff}")
    return records, int(np.count_nonzero(hist.sum(0)))


def _vis_outputs(exp: Path, work: Path, source: Path, G: int):
    """The three demo CLIs on the card from the CLI's output directory:
    generation on a sequence of the tree, interpolation and retargeting on
    their synthetic fallbacks; their ``.npy`` outputs checked, their
    renders present (decoded in the render phase)."""
    from neural_marionette_tpu_torch.cli import (vis_generation,
                                                 vis_interpolation,
                                                 vis_retarget)
    runs = {
        "vis_generation": (vis_generation,
                           ["--source_file", str(source), "--sample_num",
                            str(CLI_GEN_SAMPLES)],
                           {"gen_voxels.npy": (CLI_GEN_SAMPLES, 30, G, G, G,
                                               1),
                            "keypoints.npy": (CLI_GEN_SAMPLES, 30, 24, 4)}),
        "vis_interpolation": (vis_interpolation,
                              ["--source_file", str(work / "absent.npy")],
                              {"interp_voxels.npy": (21, G, G, G, 1),
                               "keypoints.npy": (21, 24, 4)}),
        "vis_retarget": (vis_retarget,
                         ["--source_file", str(work / "absent.npy"),
                          "--target_file", str(work / "absent.obj")],
                         {"retargeted_points.npy": (40, 4096, 3),
                          "retargeted_keypoints.npy": (40, 24, 4)}),
    }
    ms = {}
    for name, (mod, args, want) in runs.items():
        out = work / name
        t0 = time.perf_counter()
        mod.main(["--exp_dir", str(exp), "--out_dir", str(out), *args])
        ms[name] = (time.perf_counter() - t0) * 1e3
        for fname, shape in want.items():
            arr = np.load(out / fname)
            if arr.shape[:len(shape)] != shape or not np.isfinite(arr).all():
                raise AssertionError(f"{name}: {fname} {arr.shape}")
            if "voxels" in fname and not np.isin(arr, (0.0, 1.0)).all():
                raise AssertionError(f"{name}: {fname} not binary")
        pngs, gifs = len(list(out.rglob("*.png"))), len(list(out.rglob(
            "*.gif")))
        if not pngs or not gifs:
            raise AssertionError(f"{name}: {pngs} PNGs, {gifs} GIFs")
        log(f"[cli] {name}: {ms[name]:.0f} ms (load, run, write, render), "
            f"{pngs} PNGs and {gifs} GIFs, outputs {sorted(os.listdir(out))}")
    return ms


def _check_cli_gifs(exp: Path, T: int):
    """``gifs/<epoch>/`` of every epoch: the tracked keypoints and recon,
    and the generated ones only in the learner epochs (1 and 2), each GIF
    decoded by this script's reader: T frames of 192 x 192 (keypoints) or
    192 x 384 (recon), 150 ms a frame, looping. Returns the GIFs read."""
    n = 0
    for epoch, learner in ((0, False), (1, True), (2, True)):
        want = {f"{grp}_{what}_{i}.gif" for grp in
                (("track", "gen") if learner else ("track",))
                for what in ("keypoints", "recon")
                for i in range(CLI_GIF_VIDEOS)}
        gif_dir = exp / "gifs" / str(epoch)
        if set(os.listdir(gif_dir)) != want:
            raise AssertionError(f"cli gifs of epoch {epoch}: "
                                 f"{sorted(os.listdir(gif_dir))}")
        for name in sorted(want):
            frames, delays, loop = read_gif_file(gif_dir / name)
            shape = (T, 192, 384 if "recon" in name else 192, 3)
            if frames.shape != shape or delays != [VIDEO_DELAY_CS] * T \
                    or loop != 0:
                raise AssertionError(f"cli {name} of epoch {epoch}: "
                                     f"{frames.shape}, delays {delays}")
            n += 1
    return n


def _check_debug_nans(work: Path, device):
    """``--debug_nans 1``: one epoch of the CLI that completes, checked
    every step; then a ``Trainer`` of that configuration with a parameter
    poisoned with NaN, stepping on the CLI's loader, must raise
    ``FloatingPointError``. Returns (the run's seconds, the error)."""
    import torch
    from neural_marionette_tpu_torch.cli import train as cli_train
    from neural_marionette_tpu_torch.data import (DataLoader, load_dataset,
                                                  prefetch_to_device)
    from neural_marionette_tpu_torch.train import Trainer
    argv = cli_argv(work / "data", work / "out_nans", nepoch=1,
                    debug_nans=1, exp_name="smoke_nans")
    t0 = time.perf_counter()
    cli_train.train(*cli_train.parse_args(argv))
    run_s = time.perf_counter() - t0
    cfg = cli_train.prepare_config(cli_train.parse_args(argv)[0])
    trainer = Trainer(cfg, device=device, dtype="bfloat16")
    name, p = next((n, p) for n, p in trainer.model.named_parameters()
                   if n.startswith("kypt_detector.") and p.ndim > 1)
    with torch.no_grad():
        p.view(-1)[0] = float("nan")
    ds = load_dataset(True, cfg)
    with DataLoader(ds, cfg.nbatch, seed=cfg.seed,
                    num_workers=CLI_WORKERS) as loader:
        try:
            trainer.train_epoch(0, prefetch_to_device(iter(loader),
                                                      device=device))
        except FloatingPointError as e:
            err = str(e)
        else:
            raise AssertionError(f"debug_nans: a NaN in {name} did not raise")
    del trainer
    torch.cuda.empty_cache()
    log(f"[cli] --debug_nans 1: one epoch completes in {run_s:.1f} s; {name} "
        f"poisoned with NaN raises FloatingPointError: {err[:200]}")
    return run_s, err


def phase_cli(device, card):
    """The training CLI in-process on the card at the AIST preset (full
    width, bfloat16) on an AIST++-layout tree it writes (12 train and 4
    test sequences of 40 frames, 20000 points a frame): two epochs across
    the detector -> learner switch, checkpointing every epoch, with
    validation (semantic and voxel_chamfer); then a resume for one more
    epoch on the conv route. Checks its files and GIFs, the resume, the
    launches of K1, K2 forward and backward and K3 under each run, and the
    loader's batches on the card against the host's; measures the loader,
    the steps through it, their busy share, the validation's parts and the
    GIF logging; checks the semantic score with informative weights and
    ``--debug_nans 1``; runs the demo CLIs from the output directory."""
    import torch
    from neural_marionette_tpu_torch.cli import train as cli_train
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        nbytes = write_aist_tree(work / "data")
        log(f"[cli] AIST++ tree: {CLI_SEQS} sequences of {CLI_FRAMES} frames "
            f"x {CLI_POINTS} points, {nbytes / 1e6:.1f} MB written in "
            f"{time.perf_counter() - t0:.2f} s")
        argv = cli_argv(work / "data", work / "out", nepoch=2)
        cfg, _ = cli_train.parse_args(argv)
        cfg = cli_train.prepare_config(cfg)
        n_checked = _check_loader_on_card(cfg, device)
        loader_ms = {w: _loader_ms(cfg, w) for w in (0, CLI_WORKERS)}
        log(f"[cli] loader: {n_checked} batches on the card equal to the "
            f"host's; ms per batch {loader_ms[0]:.1f} at 0 threads, "
            f"{loader_ms[CLI_WORKERS]:.1f} at {CLI_WORKERS}")

        t0 = time.perf_counter()
        first_launches, first = _cli_launches(
            lambda: cli_train.train(*cli_train.parse_args(argv)))
        first_s = time.perf_counter() - t0
        first_valid = dict(first.validation_stats)
        gif_ms = dict(first.gif_ms)
        del first
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        resumed_launches, resumed = _cli_launches(
            lambda: cli_train.train(*cli_train.parse_args(
                cli_argv(work / "data", work / "out", nepoch=3,
                         conv_kernel=1))))
        resumed_s = time.perf_counter() - t0
        if resumed.start_epoch != 2:
            raise AssertionError(f"cli: resumed at {resumed.start_epoch}")
        resumed_valid = dict(resumed.validation_stats)
        gif_ms.update(resumed.gif_ms)
        del resumed
        torch.cuda.empty_cache()
        if [first_launches, resumed_launches] != CLI_LAUNCHES:
            raise AssertionError(f"cli launches {first_launches}, "
                                 f"{resumed_launches}, want {CLI_LAUNCHES}")
        exp = work / "out" / cfg.training_id / "smoke"
        records, cli_hit = _check_cli_files(exp)
        n_gifs = _check_cli_gifs(exp, cfg.Ttot)
        log(f"[cli] GIF logging, ms per epoch: " + ", ".join(
            f"{e} {v:.0f}" for e, v in sorted(gif_ms.items()))
            + f" (beside the epoch seconds below); {n_gifs} GIFs decoded")
        nans_s, nans_err = _check_debug_nans(work, device)
        for tag, st in (("epochs 0-1", first_valid),
                        ("epoch 2, conv route", resumed_valid)):
            log(f"[cli] validation ({tag}), ms per batch: eval step "
                f"{st['eval_step_ms_per_batch']:.1f}, semantic "
                f"{st['semantic_ms_per_batch']:.1f}, voxel_chamfer "
                f"{st['voxel_chamfer_ms_per_batch']:.1f}; recon occupancy "
                f"{st['recon_occupancy']:.4f}")
        log(f"[cli] epochs: " + ", ".join(
            f"{r['epoch']} {r['time']:.2f} s (semantic "
            f"{r['valid']['semantic']:.4f}, voxel_chamfer "
            f"{r['valid']['voxel_chamfer']:.1f})" for r in records)
            + f"; runs {first_s:.1f} s and {resumed_s:.1f} s; launches "
            f"{first_launches}, resumed on the conv route "
            f"{resumed_launches}")
        log(f"[cli] semantic_result.csv: {cli_hit} of {cfg.nkeypoints} "
            f"keypoints hit" + (" (degenerate: every keypoint below the "
                                "intensity threshold)" if cli_hit == 1
                                else ""))
        semantic = _semantic_informative(cfg, device)
        steps = _loader_steps(cfg, device)
        vis_ms = _vis_outputs(
            exp, work, next((work / "data" / "aist_plusplus_smpl_joints" /
                             "surface" / "test").iterdir()), cfg.grid_size)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    log(f"[cli] phase {phase_s:.1f} s")
    launches = {k: first_launches[k] + resumed_launches[k]
                for k in first_launches}
    return {"dataset_mb": nbytes / 1e6, "sequences": CLI_SEQS,
            "frames": CLI_FRAMES, "points": CLI_POINTS, "B": CLI_B,
            "N": CLI_N, "workers": CLI_WORKERS, "dtype": "bfloat16",
            "loader_ms_per_batch": {str(k): v for k, v in loader_ms.items()},
            "loader_batches_checked": n_checked,
            "steps_through_loader": steps,
            "validation": {"epochs_0_1": first_valid,
                           "epoch_2_conv_route": resumed_valid,
                           "keypoints_hit_cli": cli_hit,
                           "semantic_informative": semantic[0],
                           "keypoints_hit_informative": semantic[1]},
            "epoch_s": [r["time"] for r in records],
            "gif_logging_ms": [gif_ms[e] for e in sorted(gif_ms)],
            "gifs_checked": n_gifs,
            "debug_nans": {"run_s": nans_s, "poisoned_error": nans_err},
            "run_s": [first_s, resumed_s],
            "launches": launches,
            "launches_per_run": [first_launches, resumed_launches],
            "vis_ms": vis_ms, "phase_s": phase_s, "card": card}



# ---------------------------------------------------------------- flagship
FLAGSHIP_SEQS = 96     # train sequences; validation 96 // 4 = 24: one batch
FLAGSHIP_EPOCHS = 2    # a phase
FLAGSHIP_DEMOS = {     # the demos' .npy outputs: leading shape
    "generation": {"gen_voxels.npy": (3, 30, 64, 64, 64, 1),
                   "keypoints.npy": (3, 30, 24, 4)},
    "interpolation": {"interp_voxels.npy": (21, 64, 64, 64, 1),
                      "keypoints.npy": (21, 24, 4)},
    "retarget": {"retargeted_points.npy": (40,),
                 "retargeted_keypoints.npy": (40, 24, 4)},
}
# The JAX script's summary keys (scripts/run_flagship.py)
FLAGSHIP_SUMMARY_KEYS = {
    "nepoch", "sequences", "phase1_sec", "detector_epoch", "phase2_sec",
    "demo_generation", "demo_interpolation", "demo_retarget",
    "phase1_final", "phase1_semantic_csv", "phase2_final",
    "phase2_semantic_csv", "skeleton_parents"}
# Launches of each phase's process, which cli.train prints at its end (each
# process starts with every count at 0). Phase 1 (detector, B 24,
# grad_accum 2): an epoch has 96 // 24 = 4 steps of 2 microbatches, K1, K2
# forward and K2 backward once a microbatch (8 each), one validation batch
# (K1, K2 forward) and the GIF logging's voxels of it (K1; every epoch
# below 10 logs): K1 2 x (8 + 1 + 1) = 20, K2 forward 2 x (8 + 1) = 18,
# K2 backward 2 x 8 = 16. Phase 2 (dynamics, the detector frozen,
# grad_accum 4): 4 steps of 4 microbatches (K1 and K2 forward 16, K2
# backward never), the validation batch (K1, K2 forward), the generate
# step on it (K1, K2 forward in its detector forward) and the GIF logging
# (K1): K1 2 x (16 + 3) = 38, K2 forward 2 x (16 + 2) = 36.
FLAGSHIP_LAUNCHES = {
    "phase1": {"voxelize": 2 * (8 + 1 + 1), "chamfer_fwd": 2 * (8 + 1),
               "chamfer_bwd": 2 * 8, "conv3d": 0},
    "phase2": {"voxelize": 2 * (16 + 3), "chamfer_fwd": 2 * (16 + 2),
               "chamfer_bwd": 0, "conv3d": 0}}


def _check_flagship_phase(logger: Path, learner: bool):
    """A phase's files (those of ``train.py``; ``affinity_result.json``
    once a skeleton exists, so in the dynamics phase) with every logged
    loss finite; returns the epoch records."""
    names = ["opt.json", "metrics.jsonl", "semantic_result.csv"]
    if learner:
        names.append("affinity_result.json")
    for name in names:
        if not (logger / name).is_file():
            raise AssertionError(f"flagship: {name} missing under {logger}")
    records = [json.loads(ln) for ln in
               (logger / "metrics.jsonl").read_text().splitlines()]
    if [r["epoch"] for r in records] != list(range(FLAGSHIP_EPOCHS)):
        raise AssertionError(f"flagship: epochs "
                             f"{[r['epoch'] for r in records]}")
    for r in records:
        bad = [f"{p}/{k}" for p in ("train", "valid")
               for k, v in r[p].items() if not np.isfinite(v)]
        if bad or "semantic" not in r["valid"] or \
                (r["train"]["kypt_recon_loss"] > 0) != learner:
            raise AssertionError(f"flagship: epoch {r['epoch']} of {logger}: "
                                 f"{r}")
    want = [str(e) for e in range(FLAGSHIP_EPOCHS)]
    if sorted(os.listdir(logger / "epochs"), key=int) != want:
        raise AssertionError(f"flagship: checkpoints "
                             f"{os.listdir(logger / 'epochs')}")
    return records


def phase_flagship(card):
    """``cli.flagship`` on the card at the flagship's widths (grid 64, K 24,
    feat 128, bfloat16, B 24 with grad_accum 2 then 4, T 10 then 20) on a
    small schedule: ``FLAGSHIP_SEQS`` synthetic sequences, 2 epochs a
    phase, each phase a ``cli.train`` process, then the three demo CLIs
    from the dynamics phase's last checkpoint. Checks: exit 0; both
    phases' files with finite losses; the exported detector equal to the
    bit to the detector phase's last checkpoint, and the dynamics phase's
    detector equal to the bit to the export after its training (started
    from it, kept frozen); the demos' outputs; the summary's keys; each
    phase's kernel launches (``FLAGSHIP_LAUNCHES``). Returns the
    ``flagship`` record: seconds per epoch, step p50 through the loader
    and peak GiB per phase, the detector step's model-FLOPs utilisation
    (``utils.flops``) and the demos' seconds."""
    import torch
    from neural_marionette_tpu_torch.cli import flagship
    from neural_marionette_tpu_torch.train.checkpoint import load_params_only
    torch.cuda.synchronize()
    torch.cuda.empty_cache()     # the phases' processes share the card
    # what the card holds before the phases' processes start: this process
    # keeps its context and tensors through them
    free, total = torch.cuda.mem_get_info()
    held = {k: v / 2 ** 30 for k, v in (
        ("card_free_gib", free), ("card_total_gib", total),
        ("this_process_allocated_gib", torch.cuda.memory_allocated()),
        ("this_process_reserved_gib", torch.cuda.memory_reserved()))}
    log(f"[flagship] card at the start, GiB: "
        f"{ {k: round(v, 2) for k, v in held.items()} }")
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_flagship_"))
    t0 = time.perf_counter()
    try:
        rc = flagship.main(["--nepoch", str(FLAGSHIP_EPOCHS), "--sequences",
                            str(FLAGSHIP_SEQS), "--root", str(root)])
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"flagship: exit {rc}")
        summary = json.loads((root / "flagship_summary.json").read_text())
        missing = FLAGSHIP_SUMMARY_KEYS - set(summary)
        if missing or summary["card"] != card:
            raise AssertionError(f"flagship summary: missing {missing}, "
                                 f"card {summary.get('card')!r}")
        p1, p2 = (Path(summary[f"{p}_semantic_csv"]).parent
                  for p in ("phase1", "phase2"))
        if [p1.parent, p2.parent] != [root / "output" / flagship.PHASE1_ID,
                                      root / "output" / flagship.PHASE2_ID]:
            raise AssertionError(f"flagship: phases under {p1}, {p2}")
        rec1 = _check_flagship_phase(p1, learner=False)
        rec2 = _check_flagship_phase(p2, learner=True)
        exported, _, _ = load_params_only(
            str(root / "pretrained" / "detector" / "synthetic_detector"))
        last1, _, _ = load_params_only(str(p1))
        first2, _, _ = load_params_only(str(p2), epoch=0)
        last2, _, _ = load_params_only(str(p2))
        det = [k for k in exported if k.startswith("kypt_detector.")]
        for k in det:
            if not (torch.equal(exported[k], last1[k])
                    and torch.equal(first2[k], exported[k])
                    and torch.equal(last2[k], exported[k])):
                raise AssertionError(f"flagship: detector {k} not the "
                                     f"exported one, frozen")
        if not any(not torch.equal(last2[k], exported[k])
                   for k in exported if k.startswith("dyna_module.")):
            raise AssertionError("flagship: the dynamics did not train")
        for name, want in FLAGSHIP_DEMOS.items():
            if summary[f"demo_{name}"] != "ok":
                raise AssertionError(f"flagship demo {name}: "
                                     f"{summary[f'demo_{name}']}")
            for fname, shape in want.items():
                arr = np.load(root / "demo" / name / fname)
                if arr.shape[:len(shape)] != shape or \
                        not np.isfinite(arr).all():
                    raise AssertionError(f"flagship demo {name}: {fname} "
                                         f"{arr.shape}")
        rec = {"sequences": FLAGSHIP_SEQS, "epochs": FLAGSHIP_EPOCHS,
               "seconds": seconds, "card": card, "at_start": held}
        for phase, records in (("phase1", rec1), ("phase2", rec2)):
            stats = summary[f"{phase}_stats"]
            if stats["launches"] != FLAGSHIP_LAUNCHES[phase]:
                raise AssertionError(f"flagship {phase} launches "
                                     f"{stats['launches']}, want "
                                     f"{FLAGSHIP_LAUNCHES[phase]}")
            epochs = [stats["epochs"][str(e)] for e in range(FLAGSHIP_EPOCHS)]
            rec[phase] = {
                "sec": summary[f"{phase}_sec"],
                "epoch_s": [r["time"] for r in records],
                "steps_per_epoch": [e["steps"] for e in epochs],
                "step_ms_p50": [e["step_ms_p50"] for e in epochs],
                "peak_gib": max(e["peak_gib"] for e in epochs),
                "flops_per_step": stats["flops_per_step"],
                "flops_counted": stats["counted"],
                "mfu": stats["mfu"], "launches": stats["launches"],
                "valid_semantic": records[-1]["valid"]["semantic"],
                "valid_recon_loss": records[-1]["valid"]["recon_loss"],
                "valid_kypt_recon_loss":
                    records[-1]["valid"]["kypt_recon_loss"]}
            log(f"[flagship] {phase}: epochs "
                f"{[round(x, 2) for x in rec[phase]['epoch_s']]} s, step "
                f"p50 {[round(x, 1) for x in rec[phase]['step_ms_p50']]} ms "
                f"through the loader, peak {rec[phase]['peak_gib']:.2f} GiB, "
                f"MFU {stats['mfu']:.4f} ({stats['counted']}), launches "
                f"{stats['launches']}")
        rec["demos_s"] = {n: summary[f"demo_{n}_sec"] for n in FLAGSHIP_DEMOS}
        log(f"[flagship] demos, s: {rec['demos_s']}; {seconds:.1f} s in all")
        return rec
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------------ render
RENDER_DELAY_CS, VIDEO_DELAY_CS = 10, 15   # GIF delays, hundredths of a s
VIS_SHAPE = dict(videos=4, T=10)           # the CLI's logged batch
MESH_RES = 158                             # sphere_mesh: 4 * 158^2 ~ 1e5 faces


def read_png_file(path):
    """An 8-bit RGB PNG as (H, W, 3) uint8, with this script's own reader
    (zlib; the port writes every row unfiltered, and any other filter
    fails the check)."""
    import struct
    import zlib
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    W, H, depth, ctype = hdr[:4]
    if (depth, ctype) != (8, 2):
        raise AssertionError(f"{path}: bit depth {depth}, colour type {ctype}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(H, 1 + 3 * W)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: a filtered row")
    return rows[:, 1:].reshape(H, W, 3)


def _lzw_decode(data, mcs, n):
    """GIF's LZW code stream -> ``n`` palette indices."""
    clear, eoi = 1 << mcs, (1 << mcs) + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table, size, prev = list(base), mcs + 1, None
    out = bytearray()
    acc = bits = i = 0
    while True:
        while bits < size:
            acc |= data[i] << bits
            i += 1
            bits += 8
        code = acc & ((1 << size) - 1)
        acc >>= size
        bits -= size
        if code == clear:
            table, size, prev = list(base), mcs + 1, None
            continue
        if code == eoi:
            break
        if code < len(table):
            entry = table[code]
            if prev is not None and len(table) < 4096:
                table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        if len(table) == 1 << size and size < 12:
            size += 1
    if len(out) != n:
        raise AssertionError(f"LZW: {len(out)} indices, want {n}")
    return np.frombuffer(bytes(out), np.uint8)


def read_gif_file(path):
    """A GIF89a as (frames (n, H, W, 3) uint8, delays in hundredths, loop
    count), with this script's own reader (LZW in Python)."""
    import struct
    data = Path(path).read_bytes()
    if data[:6] != b"GIF89a":
        raise AssertionError(f"{path}: not a GIF89a")
    W, H, packed = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)

    def blocks(pos):
        out = bytearray()
        while data[pos]:
            out += data[pos + 1:pos + 1 + data[pos]]
            pos += 1 + data[pos]
        return bytes(out), pos + 1

    frames, delays, loop, delay = [], [], None, None
    while data[pos] != 0x3B:
        kind = data[pos]
        if kind == 0x21:
            label = data[pos + 1]
            body, pos = blocks(pos + 2)
            if label == 0xF9:
                delay = struct.unpack("<H", body[1:3])[0]
            elif label == 0xFF and body.startswith(b"NETSCAPE2.0"):
                loop = struct.unpack("<H", body[12:14])[0]
        elif kind == 0x2C:
            x, y, w, h, p = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
            if (x, y, w, h) != (0, 0, W, H) or p & 0x40 or not p & 0x80:
                raise AssertionError(f"{path}: frame {len(frames)} layout")
            pos += 10
            ncol = 2 << (p & 7)
            table = np.frombuffer(data[pos:pos + 3 * ncol], np.uint8)
            pos += 3 * ncol
            mcs = data[pos]
            body, pos = blocks(pos + 1)
            idx = _lzw_decode(body, mcs, W * H)
            frames.append(table.reshape(-1, 3)[idx].reshape(H, W, 3))
            delays.append(delay)
        else:
            raise AssertionError(f"{path}: block {kind:#x}")
    return np.stack(frames), delays, loop


def check_render_files(root, n_frames, pngs_of=None):
    """Every PNG (size 1025 x 958 unless under ``gifs/``) and GIF under
    ``root`` decoded by this script's readers: each GIF loops, with the
    delay of its kind (100 ms renders, 150 ms videos) and ``n_frames[name]``
    frames when given; a GIF whose frames have PNGs (``pngs_of[gif]`` = the
    PNG directory) within 3/255 mean of them (the palette's error).
    Returns the counts."""
    root = Path(root)
    counts = {"png": 0, "gif": 0, "gif_frames": 0}
    for png in sorted(root.rglob("*.png")):
        img = read_png_file(png)
        if img.shape != (958, 1025, 3):
            raise AssertionError(f"{png}: {img.shape}")
        counts["png"] += 1
    for gif in sorted(root.rglob("*.gif")):
        name = str(gif.relative_to(root))
        frames, delays, loop = read_gif_file(gif)
        want = VIDEO_DELAY_CS if name.startswith("gifs") else RENDER_DELAY_CS
        if loop != 0 or delays != [want] * len(frames):
            raise AssertionError(f"{name}: loop {loop}, delays {delays}")
        if name in (n_frames or {}) and len(frames) != n_frames[name]:
            raise AssertionError(f"{name}: {len(frames)} frames, want "
                                 f"{n_frames[name]}")
        for png in sorted((root / (pngs_of or {}).get(name, "-")).glob(
                "*.png")):
            err = np.abs(frames[int(png.stem)].astype(np.float64)
                         - read_png_file(png)).mean() / 255
            if not err <= 3 / 255:
                raise AssertionError(f"{name} frame {png.stem}: {err:.4f}")
        counts["gif"] += 1
        counts["gif_frames"] += len(frames)
    return counts


def _sync_ms(fn):
    """(result, host ms of ``fn()``, the card synchronised around it)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _equal_on_card_and_cpu(what, fn, device):
    """``fn(device)`` on the card and on the CPU equal to the bit; returns
    the card's result and its ms (second call, synchronised)."""
    import torch
    card = fn(device)
    card, ms = _sync_ms(lambda: fn(device))
    host = fn(torch.device("cpu"))
    if not torch.equal(card.cpu(), host):
        bad = (card.cpu() != host).any(-1).float().mean()
        raise AssertionError(f"render {what}: the card's image differs from "
                             f"the CPU's on {float(bad):.2e} of the pixels")
    return card, ms


def _render_raster(device, work):
    """The raster on the card equal to the bit to the port's CPU run of the
    same inputs, at the reference camera: splat (px 1 and 2, onto a given
    frame), the surfels of a 64^3 clip's 10 frames (estimated normals, the
    generation colours), the skeleton meshes of 10 frames (K 24) and a
    mesh of ~1e5 faces; the frames written as PNGs and read back equal to
    ``to_uint8``. Returns the card's ms."""
    import torch
    from neural_marionette_tpu_torch.ops.voxelize import voxelize_np
    from neural_marionette_tpu_torch.skeleton import extract_skeleton
    from neural_marionette_tpu_torch.viz import raster as R
    from neural_marionette_tpu_torch.viz.image_files import save_png, to_uint8
    cam = R.default_camera()
    g = np.random.default_rng(91)
    ms = {}
    pts = g.uniform(-0.8, 0.8, (20000, 3))
    cols = g.uniform(size=(20000, 3))
    base = g.uniform(size=(cam.H, cam.W, 3)).astype(np.float32)
    for px in (1, 2):
        _, ms[f"splat_px{px}_20000"] = _equal_on_card_and_cpu(
            f"splat px {px}", lambda d: R.splat(
                cam, pts, cols, img=torch.as_tensor(base, device=d), px=px,
                device=d), device)
    clip = motion_points(10, APP_N, seed=92)
    G = 64
    vox = np.stack([voxelize_np(f, G) for f in clip])
    coords = [np.stack(np.nonzero(v[..., 0]), -1) / ((G - 1) / 2) - 1
              for v in vox]
    t0 = time.perf_counter()
    normals = [R.estimate_normals(c) for c in coords]
    ms["estimate_normals_per_frame"] = (time.perf_counter() - t0) * 1e3 / 10
    colors = [np.array([[0.6, 1.0, 0.6]]) * (0.2 + 0.8 * (c[:, 2:] + 1) / 2)
              for c in coords]
    frame = np.concatenate([np.full(len(c), t) for t, c in enumerate(coords)])

    def surfels(d):
        return R.render_surfels_frames(
            cam, torch.as_tensor(np.concatenate(coords), device=d),
            torch.as_tensor(np.concatenate(normals), device=d),
            torch.as_tensor(np.concatenate(colors), device=d),
            torch.as_tensor(frame, device=d), R.blank(cam, 10, device=d))
    surf, t = _equal_on_card_and_cpu("surfels", surfels, device)
    ms["surfels_per_frame"] = t / 10
    sk = extract_skeleton(g.uniform(size=(2, 24, 24, 1)).astype(np.float32))
    kps = g.uniform(-0.6, 0.6, (10, 24, 3))
    meshes = [dict(zip(("verts", "faces", "vert_colors"),
                       R.skeleton_geometry(kp, sk.parents))) for kp in kps]
    skel, t = _equal_on_card_and_cpu("skeleton meshes", lambda d: (
        R.render_mesh_frames(cam, meshes, R.blank(cam, 10, device=d))),
        device)
    ms["skeleton_mesh_per_frame"] = t / 10
    v, f = R.sphere_mesh(0.6, res=MESH_RES)
    vc = g.uniform(size=(len(v), 3)).astype(np.float32)
    big, ms["mesh_1e5_faces"] = _equal_on_card_and_cpu(
        "mesh", lambda d: R.render_mesh(cam, v, f, vert_colors=vc, device=d),
        device)
    samples = R.mesh_batch(cam, [dict(verts=v, faces=f, vert_colors=vc)])
    _, ms["mesh_1e5_faces_device"] = _sync_ms(lambda: R.shade_splat(
        cam, *samples, R.blank(cam, 1, device=device)))
    for name, img in (("surfels", surf[0]), ("skeleton", skel[0]),
                      ("mesh", big)):
        path = work / f"raster_{name}.png"
        t0 = time.perf_counter()
        save_png(img, str(path))
        ms[f"png_{name}"] = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(read_png_file(path), to_uint8(img)):
            raise AssertionError(f"render: {name} PNG differs from to_uint8")
    log(f"[render] raster on the card equal to the bit to the CPU (splat px "
        f"1/2, surfels of 10 frames of a 64^3 clip, 10 skeleton meshes, a "
        f"mesh of {len(f)} faces); PNGs lossless; card ms " + ", ".join(
            f"{k} {x:.1f}" for k, x in ms.items()))
    return dict(ms, mesh_faces=int(len(f)),
                mesh_samples=int(len(samples[0])))


def _vis_inputs(G, K, seed=93):
    """The CLI's logged batch at the AIST preset: 4 clips of 10 frames of
    64^3 voxels, their keypoints (K 24) inside the blob, an affinity, a
    skeleton adjacency and a recon."""
    from neural_marionette_tpu_torch.ops.voxelize import voxelize_np
    from neural_marionette_tpu_torch.skeleton import extract_skeleton
    g = np.random.default_rng(seed)
    n, T = VIS_SHAPE["videos"], VIS_SHAPE["T"]
    pts = serving_points(n, T, SERVE_N, seed)
    vox = np.stack([np.stack([voxelize_np(pts[b, t], G) for t in range(T)])
                    for b in range(n)])
    kp = np.concatenate([g.uniform(-0.5, 0.5, (n, T, K, 3)),
                         g.uniform(0, 1, (n, T, K, 1))], -1)
    aff = g.uniform(size=(2, K, K, 1)).astype(np.float32)
    recon = np.clip(vox + g.uniform(-0.6, 0.6, vox.shape), 0, 1)
    return vox, kp.astype(np.float32), aff, extract_skeleton(aff).A, recon


def _render_vis(device, work, G, K):
    """``vis_keypoints`` (affinity arrows and adjacency lines) and
    ``vis_recon`` on the card at the CLI's shape against the CPU: equal to
    the bit (the compositing is float32 products and sums, one operation a
    kernel), their GIFs decoded with 150 ms delays, equal to the frames
    where a frame has at most 256 colours, else within 3/255 mean (the
    palette's error); ms per call on the card (the second call)."""
    import torch
    from neural_marionette_tpu_torch.viz import visualize as PV
    vox, kp, aff, A, recon = _vis_inputs(G, K)
    exact = inexact = 0
    calls = {
        "keypoints_affinity": lambda d, **k: PV.vis_keypoints(
            vox, kp, affinity=aff, log_num=4, group="track", device=d, **k),
        "keypoints_A": lambda d, **k: PV.vis_keypoints(
            vox, kp, affinity=A, mode="A", log_num=4, group="gen", Tcond=3,
            device=d, **k),
        "recon": lambda d, **k: PV.vis_recon(
            vox, recon, log_num=4, group="track", Tcond=3, device=d, **k)}
    ms = {}
    for name, fn in calls.items():
        fn(device)
        card, ms[name] = _sync_ms(lambda: fn(device))
        host = fn(torch.device("cpu"))
        if not np.array_equal(card, host):
            raise AssertionError(f"vis {name}: card and CPU differ on "
                                 f"{np.any(card != host, -1).mean():.2e}")
        out = work / "vis" / name
        fn(device, logger_path=str(out), nepoch=0)
        for gif in sorted((out / "gifs" / "0").glob("*.gif")):
            frames, delays, loop = read_gif_file(gif)
            i = int(gif.stem.rsplit("_", 1)[1])
            if frames.shape != card[i].shape or delays != [
                    VIDEO_DELAY_CS] * len(frames) or loop != 0:
                raise AssertionError(f"vis {gif.name}: {frames.shape}, "
                                     f"delays {delays}")
            for t, (got, want) in enumerate(zip(frames, card[i])):
                few = len(np.unique(want.reshape(-1, 3), axis=0)) <= 256
                err = np.abs(got.astype(np.float64) - want).mean() / 255
                if (few and err) or err > 3 / 255:
                    raise AssertionError(f"vis {gif.name} frame {t}: mean "
                                         f"error {err:.4f}")
                exact += few
                inexact += not few
    log(f"[render] vis on the card equal to the bit to the CPU at 4 videos x "
        f"10 frames, K {K}, G {G}; GIF frames decoded: {exact} equal (at most "
        f"256 colours), {inexact} within 3/255; ms per call "
        + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
    return dict(ms_per_call=ms, gif_frames_equal=exact,
                gif_frames_within_3_255=inexact)


def _textured_target(work, res=70, texture=None):
    """A textured OBJ the script writes: a UV sphere (4 * res^2 faces) with
    UVs, an MTL and a texture: a 64 x 64 PNG (the port's writer), or a copy
    of the image file ``texture``."""
    from neural_marionette_tpu_torch.viz import raster as R
    from neural_marionette_tpu_torch.viz.image_files import write_png
    work.mkdir(parents=True, exist_ok=True)
    v, f = R.sphere_mesh(0.5, res=res)
    v = v * np.array([0.5, 1.0, 0.4])
    th = np.arctan2(v[:, 1], v[:, 0]) / (2 * np.pi) + 0.5
    lines = ["mtllib target.mtl"]
    lines += [f"v {a:.6f} {b:.6f} {c:.6f}" for a, b, c in v]
    lines += [f"vt {a:.5f} {b:.5f}" for a, b in
              zip(th, (v[:, 2] / 0.2 + 1) / 2)]
    lines += [f"f {a + 1}/{a + 1} {b + 1}/{b + 1} {c + 1}/{c + 1}"
              for a, b, c in f]
    (work / "target.obj").write_text("\n".join(lines) + "\n")
    name = "texture.png" if texture is None else Path(texture).name
    (work / "target.mtl").write_text(f"newmtl m\nmap_Kd {name}\n")
    if texture is None:
        y, x = np.mgrid[0:64, 0:64]
        tex = np.stack([x * 4, y * 4, (x ^ y) * 4], -1).astype(np.uint8)
        write_png(tex, str(work / name))
    else:
        shutil.copyfile(texture, work / name)
    return work / "target.obj", len(f)


# ---------------------------------------------------------------- textures
TEXTURES = ROOT / "tests" / "torch_textures"
TEXTURE_TIMED = ("jpeg_1024_baseline_420.jpg", "jpeg_1024_progressive_420.jpg",
                 "gif_1024.gif", "tiff_1024_lzw.tif",
                 "webp_1024_lossless.webp", "webp_1024_lossy.webp",
                 "jpeg_1024_arith_sequential_420.jpg",
                 "jpeg_1024_arith_progressive_420.jpg", "jpeg_1024_cmyk.jpg",
                 "dds_1024_bc1.dds", "dds_1024_bc7.dds", "qoi_1024.qoi",
                 "jp2_1024_53.jp2", "jp2_1024_97_mct.jp2",
                 "tiff_1024_uint32_deflate_predictor.tif",
                 "tiff_1024_cielab_lzw.tif")
# timed on imageio's OpenCV route: fixtures, and a 16-bit PNG this script
# writes (_png16), each read under a .pbm name
ROUTE_TIMED = ("hdr_1024_rle.hdr", "png_1024_rgb16", "tiff_1024_ccitt_g4.tif",
               "tiff_1024_logluv32.tif")
RENDER_GEN_SAMPLES = 1     # generated samples rendered of the apps' 3
RENDER_JPEG = "jpeg_progressive_420.jpg"   # the JPEG-textured retarget set
JPEG_SET_RES = 40                           # its sphere: 4 * 40^2 faces
RENDER_WEBP = "webp_1024_lossless.webp"    # the WebP-textured retarget set
WEBP_SET_RES = 28                           # its sphere: 4 * 28^2 faces


def _png16(n=1024):
    """(a 16-bit RGB PNG of a smooth n x n image, its samples): rows
    unfiltered, zlib at level 6."""
    import struct
    import zlib

    from neural_marionette_tpu_torch.viz.image_files import (PNG_SIGNATURE,
                                                             _chunk)
    y, x = np.mgrid[0:n, 0:n].astype(np.float64)
    rgb = np.stack([32767 + 30000 * np.sin(x / 37.0) * np.cos(y / 23.0),
                    32767 + 25000 * np.sin((x + 2 * y) / 51.0),
                    32767 + 30000 * np.cos(np.hypot(x - 500, y - 400) / 29.0)],
                   -1).astype(">u2")
    rows = np.zeros((n, 1 + 6 * n), np.uint8)
    rows[:, 1:] = rgb.view(np.uint8).reshape(n, 6 * n)
    data = (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", n, n, 16, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
    return data, rgb.astype(np.uint16)


def _route_check(manifest, decode_image, read_image):
    """imageio's OpenCV route on every fixture (see ``phase_textures``):
    (reads equal to the manifest, refusals, reads of content OpenCV does
    not take equal to the fixture's own)."""
    import hashlib
    equal = refused = own = 0
    for e in manifest["files"] + manifest["route_files"]:
        data = (TEXTURES / e["file"]).read_bytes()
        for ext, want in (e.get("opencv_route") or e["reads"]).items():
            name = "texture" + ext
            try:
                got = decode_image(data, name)
            except ValueError as err:
                if "raises" not in want:
                    raise AssertionError(f"textures route {e['file']} as "
                                         f"{ext}: {err}") from None
                refused += 1
                continue
            if "raises" in want:
                raise AssertionError(f"textures route {e['file']} as {ext}: "
                                     "read; imageio refuses it")
            if "opencv_route" in e and not want["opencv_reads"]:
                # Pillow's content: read as under its own name
                if not np.array_equal(got, read_image(str(TEXTURES
                                                          / e["file"]))):
                    raise AssertionError(f"textures route {e['file']} as "
                                         f"{ext}: not its own reading")
                own += 1
                continue
            # a bitmap: Pillow's bool array holds bytes 0 and 255, as the
            # port's uint8 does
            dtype = want["dtype"].replace("bool", "uint8")
            digest = hashlib.sha256(got.tobytes()).hexdigest()
            if got.size != int(np.prod(want["shape"])) \
                    or str(got.dtype) != dtype or digest != want["sha256"]:
                raise AssertionError(f"textures route {e['file']} as {ext}: "
                                     "differs from the manifest")
            equal += 1
    return equal, refused, own


def _texture_expected(entry, arrays):
    """A manifest entry's expected (H, W, 3) float32 texture: the samples
    and the divisor rounded to float64, divided there, the quotient
    rounded to float32 (the port's rule, ``image_files.unit_interval``)."""
    return (arrays[entry["key"]].astype(np.float64)
            / np.float64(entry["divisor"])).astype(np.float32)


def phase_textures(card, reps=11):
    """Every texture fixture of ``tests/torch_textures/`` through the
    port's ``read_image`` and ``texture_rgb`` (the JPEG, WebP, QOI, BCn and
    JPEG 2000 decoders and the LZW, PackBits and run-length expansions of
    the host libraries built on this machine), held against
    ``MANIFEST.json``:
    equal to the bit to ``expected.npz``, or the SHA-256 of the 1024 x
    1024 files' samples; a refused file must raise ``ValueError`` naming
    what it is.
    Then imageio's OpenCV route (``_route_check``): every fixture copied
    under ``.pbm`` and ``.hdr`` and the Radiance HDR and Sun raster
    fixtures under the names of ``MANIFEST.json``'s ``route_files``, read
    by ``decode_image``: equal to the digest of imageio's array, or
    refused where imageio refuses, or,
    where OpenCV does not take the content, equal to the file's reading
    under its own name.
    Then each 1024 x 1024 file's decode time on the host (p50 and min of
    ``reps`` calls of ``image_files.decode_image`` on the file's bytes, and
    of ``read_image`` with the file read), and those of ``ROUTE_TIMED``
    under a ``.pbm`` name (the PNG checked: its samples' high bytes)."""
    import hashlib
    from neural_marionette_tpu_torch.apps.retarget import texture_rgb
    from neural_marionette_tpu_torch.viz.image_files import (
        decode_image, image_format, read_image)
    t_phase = time.perf_counter()
    full = json.loads((TEXTURES / "MANIFEST.json").read_text())
    manifest = full["files"]
    with np.load(TEXTURES / "expected.npz") as npz:
        arrays = {k: npz[k] for k in npz.files}
    checked, refused, per_format = 0, 0, {}
    for e in manifest:
        path = str(TEXTURES / e["file"])
        fmt = image_format((TEXTURES / e["file"]).read_bytes(), e["file"])
        per_format.setdefault(fmt, {"checked": 0, "refused": 0})
        if "raises" in e:
            try:
                read_image(path)
            except ValueError as err:
                if e["raises"] not in str(err):
                    raise AssertionError(f"textures {e['file']}: {err}; "
                                         f"want {e['raises']!r}") from None
            else:
                raise AssertionError(f"textures {e['file']}: read; it must "
                                     f"raise naming {e['raises']!r}")
            refused += 1
            per_format[fmt]["refused"] += 1
            continue
        img = read_image(path)
        tex = texture_rgb(img)
        if list(tex.shape) != e["shape"] or tex.dtype != np.float32:
            raise AssertionError(f"textures {e['file']}: {tex.shape} "
                                 f"{tex.dtype}, want {e['shape']}")
        if "sha256" in e:
            ok = hashlib.sha256(img.tobytes()).hexdigest() == e["sha256"]
        else:
            ok = np.array_equal(tex, _texture_expected(e, arrays))
        if not ok:
            raise AssertionError(f"textures {e['file']}: differs from the "
                                 "manifest")
        checked += 1
        per_format[fmt]["checked"] += 1
    check_s = time.perf_counter() - t_phase
    t_route = time.perf_counter()
    route = dict(zip(("equal", "refused", "own"),
                     _route_check(full, decode_image, read_image)))
    route["check_s"] = time.perf_counter() - t_route
    png16, samples16 = _png16()
    timed_route = {}
    for name in ROUTE_TIMED:
        data = png16 if name == "png_1024_rgb16" else \
            (TEXTURES / name).read_bytes()
        decode = []
        for _ in range(reps):
            t0 = time.perf_counter()
            img = decode_image(data, name.rsplit(".", 1)[0] + ".pbm")
            decode.append((time.perf_counter() - t0) * 1e3)
        if name == "png_1024_rgb16" and not np.array_equal(
                img, (samples16 >> 8).astype(np.uint8)):
            raise AssertionError("textures route: the 16-bit PNG under .pbm "
                                 "is not its samples' high bytes")
        timed_route[name] = {
            "format": image_format(data, name), "bytes": len(data),
            "pixels": int(img.shape[0] * img.shape[1]), "as": ".pbm",
            "decode_ms_p50": float(np.median(decode)),
            "decode_ms_min": float(np.min(decode)), "reps": reps}
    route["decode"] = timed_route
    times = {}
    for name in TEXTURE_TIMED:
        data = (TEXTURES / name).read_bytes()
        decode, read = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            img = decode_image(data, name)
            decode.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            read_image(str(TEXTURES / name))
            read.append((time.perf_counter() - t0) * 1e3)
        times[name] = {
            "format": image_format(data, name), "bytes": len(data),
            "pixels": int(img.shape[0] * img.shape[1]),
            "decode_ms_p50": float(np.median(decode)),
            "decode_ms_min": float(np.min(decode)),
            "read_image_ms_p50": float(np.median(read)), "reps": reps}
    out = {"card": card, "checked": checked, "refused": refused,
           "fixtures": len(manifest), "per_format": per_format,
           "decode": times, "check_s": check_s, "opencv_route": route,
           "phase_s": time.perf_counter() - t_phase}
    log(f"[textures] {checked} fixtures equal to the manifest, {refused} "
        "refused as it names; 1024 x 1024 decode p50 (min) on the host: "
        + ", ".join(f"{n} {t['decode_ms_p50']:.2f} ({t['decode_ms_min']:.2f})"
                    " ms" for n, t in times.items())
        + f"; OpenCV route {route['equal']} equal, {route['refused']} "
        f"refused, {route['own']} as their own; "
        + ", ".join(f"{n} as .pbm {t['decode_ms_p50']:.2f} ms"
                    for n, t in timed_route.items())
        + f" ({card}); phase {out['phase_s']:.1f} s")
    return out


RETARGET_KINDS = ("surfels", "textured_mesh", "textured_mesh_jpeg",
                  "textured_mesh_jpeg_twin", "textured_mesh_webp",
                  "textured_mesh_webp_twin")
# each twin: the same sphere textured with its fixture's expected pixels as
# a PNG, drawn from the same retarget; its PNGs equal to the bit to its
# fixture's set
TWINS = {"textured_mesh_jpeg_twin": "textured_mesh_jpeg",
         "textured_mesh_webp_twin": "textured_mesh_webp"}


def phase_render(cfg, device, card, apps_keep, trained_affinity):
    """The renders on the card (``viz/``, the demos' render sets) and the
    device skeleton extraction; see the module docstring, phase 16."""
    import hashlib

    import torch
    from neural_marionette_tpu_torch.apps import generation as AG
    from neural_marionette_tpu_torch.apps import interpolation as AI
    from neural_marionette_tpu_torch.apps import retarget as AR
    from neural_marionette_tpu_torch.viz.image_files import write_png
    G, K = cfg.grid_size, cfg.nkeypoints
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_render_"))
    t_phase = time.perf_counter()
    out = {"card": card}
    try:
        out["raster"] = _render_raster(device, work)
        out["vis"] = _render_vis(device, work, G, K)
        # the apps phase's generated clip and interpolation, as the demos
        # save them
        gen, itp, clip20 = (apps_keep[k] for k in ("gen", "itp", "clip20"))
        # the first of the clip's samples (30 frames; the run's time limit)
        gen = dict(gen, gen_voxels=gen["gen_voxels"][:RENDER_GEN_SAMPLES],
                   keypoints=gen["keypoints"][:RENDER_GEN_SAMPLES])
        d = work / "generation"
        stats, t = _sync_ms(lambda: AG.save_outputs(
            gen, str(d), vox_cond=clip20[:5], Tcond=5, device=device))
        S, T = gen["gen_voxels"].shape[:2]
        files = check_render_files(
            d, {f"gen_result_{s}.gif": T for s in range(S)},
            {f"gen_result_{s}.gif": f"gen_result_imgs_{s}" for s in range(S)})
        rg = stats["render_generation"]
        out["generation"] = {
            "ms": t, "frames": rg["frames"], "ms_per_frame": {
                k: rg[k] / rg["frames"]
                for k in ("normals_ms", "render_ms", "encode_ms")},
            "vis_keypoints_ms": stats["vis_keypoints_ms"],
            "vis_recon_ms": stats["vis_recon_ms"], "files": files,
            "voxels_per_frame": float(gen["gen_voxels"].sum() / (S * T))}
        d = work / "interpolation"
        stats, t = _sync_ms(lambda: AI.save_outputs(
            itp, str(d), vox_clip=clip20, device=device))
        out["interpolation"] = {"ms": t, "files": check_render_files(
            d, {"interp_result_0.gif": 20},
            {"interp_result_0.gif": "interp_result_imgs_0"})}
        # the retarget sets: the apps phase's surfel target, then a
        # textured mesh target the script writes
        m = apps_keep["marionette"]
        sets = ("source", "smooth", "skeleton", "overlay")
        # the JPEG and WebP sets' twins: the same sphere textured with the
        # fixture's expected pixels written as a PNG (the JPEG's from
        # expected.npz; the 1024 x 1024 WebP's decoded here and held to
        # imageio's SHA-256), drawn from the same retarget
        entries = {e["file"]: e for e in json.loads(
            (TEXTURES / "MANIFEST.json").read_text())["files"]}
        twin = work / "expected.png"
        with np.load(TEXTURES / "expected.npz") as npz:
            write_png(npz[entries[RENDER_JPEG]["key"]], str(twin))
        from neural_marionette_tpu_torch.viz.image_files import read_image
        webp_px = read_image(str(TEXTURES / RENDER_WEBP))
        if hashlib.sha256(webp_px.tobytes()).hexdigest() != \
                entries[RENDER_WEBP]["sha256"]:
            raise AssertionError("render: the WebP fixture's pixels differ "
                                 "from imageio's")
        twin_webp = work / "expected_webp.png"
        write_png(webp_px[..., :3], str(twin_webp))
        for kind in RETARGET_KINDS:
            if kind == "surfels":
                ret, points, mesh = apps_keep["ret"], apps_keep["target"], None
                faces = 0
            else:
                tex, res = {"textured_mesh": (None, 70),
                            "textured_mesh_jpeg": (
                                TEXTURES / RENDER_JPEG, JPEG_SET_RES),
                            "textured_mesh_jpeg_twin": (
                                twin, JPEG_SET_RES),
                            "textured_mesh_webp": (
                                TEXTURES / RENDER_WEBP, WEBP_SET_RES),
                            "textured_mesh_webp_twin": (
                                twin_webp, WEBP_SET_RES)}[kind]
                obj, faces = _textured_target(work / f"obj_{kind}", res, tex)
                points, mesh = AR.load_target_points(str(obj),
                                                     return_mesh=True)
                if mesh["texture"] is None or mesh["uv"] is None:
                    raise AssertionError("render: the OBJ's texture not read")
                if kind in TWINS:
                    first = out[f"retarget_{TWINS[kind]}"]["mesh"]
                    if not np.array_equal(mesh["texture"], first["texture"]):
                        raise AssertionError(
                            f"render: the texture of {TWINS[kind]} differs "
                            "from its expected pixels")
                else:
                    ret = m.retarget(apps_keep["source"], points)
            d = work / f"retarget_{kind}"
            stats, t = _sync_ms(lambda: AR.save_outputs(
                ret, str(d), source_vox=apps_keep["source"],
                target_mesh=mesh, target_points=points, device=device))
            names = sets + (("textured",) if mesh else ())
            files = check_render_files(
                d, {f"{s}.gif": 10 for s in names},
                {f"{s}.gif": f"{s}_imgs" for s in names})
            if files["gif"] != len(names) or files["png"] != \
                    10 * len(names) + 2:
                raise AssertionError(f"retarget {kind}: files {files}")
            out[f"retarget_{kind}"] = {"ms": t, "points": int(len(points)),
                                       "faces": int(faces), "sets": names,
                                       "split_ms": stats, "files": files}
            if kind in TWINS.values():
                out[f"retarget_{kind}"]["mesh"] = mesh
            elif kind in TWINS:
                # every PNG of the fixture-textured set equal to the bit to
                # its twin's
                pngs = sorted(p.relative_to(d) for p in d.rglob("*.png"))
                jd = work / f"retarget_{TWINS[kind]}"
                if pngs != sorted(p.relative_to(jd)
                                  for p in jd.rglob("*.png")):
                    raise AssertionError(f"render: the files of "
                                         f"{TWINS[kind]} differ from its "
                                         "twin's")
                for rel in pngs:
                    if not np.array_equal(read_png_file(jd / rel),
                                          read_png_file(d / rel)):
                        raise AssertionError(
                            f"render: {rel} of {TWINS[kind]} differs from "
                            "its twin's")
                out[f"retarget_{kind}"]["pngs_equal"] = len(pngs)
                out[f"retarget_{TWINS[kind]}"].pop("mesh")
        out["skeleton_device"] = _render_skeleton(device, trained_affinity)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    g_ = out["generation"]
    log(f"[render] generation: {g_['frames']} frames at 1025 x 958, "
        f"{g_['ms']:.0f} ms; per frame host normals "
        f"{g_['ms_per_frame']['normals_ms']:.1f}, card "
        f"{g_['ms_per_frame']['render_ms']:.1f}, PNG/GIF "
        f"{g_['ms_per_frame']['encode_ms']:.1f} ms; files {g_['files']}")
    for kind in RETARGET_KINDS:
        r = out[f"retarget_{kind}"]
        log(f"[render] retarget sets ({kind}, 10 frames onto {r['points']} "
            f"points): {r['ms']:.0f} ms, split {r['split_ms']}, files "
            f"{r['files']}")
    for kind, first in TWINS.items():
        fixture = RENDER_JPEG if "jpeg" in kind else RENDER_WEBP
        log(f"[render] the {first} retarget set ({fixture}): "
            f"{out[f'retarget_{kind}']['pngs_equal']} PNGs equal to the bit "
            "to its twin's (the expected pixels as a PNG)")
    log(f"[render] phase {out['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    return out


def _render_skeleton(device, trained_affinity):
    """``extract_skeleton_device`` on the card equal to the bit to the host
    extraction on the train phase's trained affinity and on seeded random
    and tie-heavy affinities at K 24; its ms and device operations a
    call."""
    import torch
    from neural_marionette_tpu_torch.skeleton import extract_skeleton
    from neural_marionette_tpu_torch.skeleton_device import (
        extract_skeleton_device, extract_skeleton_host_api)
    cases = {"trained": trained_affinity}
    for s in range(5):
        g = np.random.default_rng(200 + s)
        cases[f"random{s}"] = g.uniform(size=(2, 24, 24, 1)).astype(
            np.float32)
        tie = (g.integers(0, 3, size=(2, 24, 24, 1)) / 2.0).astype(np.float32)
        cases[f"ties{s}"] = tie + g.uniform(0, 1e-3, tie.shape).astype(
            np.float32)
    for name, aff in cases.items():
        host = extract_skeleton(aff)
        dev = extract_skeleton_host_api(aff, device=device)
        for f in ("A", "priority_values", "priority_indices", "parents"):
            a, b = getattr(host, f), getattr(dev, f)
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"skeleton {name}: {f} {b} on the card, "
                                     f"{a} on the host")
    aff = torch.as_tensor(trained_affinity, device=device)
    extract_skeleton_device(aff)
    ms = min(_sync_ms(lambda: extract_skeleton_device(aff))[1]
             for _ in range(3))
    # None when the profiler recorded no device operation at all
    ops = len(device_events(lambda: extract_skeleton_device(aff), n=1)) \
        or None
    log(f"[render] extract_skeleton_device on the card equal to the bit to "
        f"the host on {len(cases)} affinities (trained, random, tie-heavy, K "
        f"24): {ms:.1f} ms a call, {ops} device operations")
    return {"cases": len(cases), "ms": ms, "device_ops_per_call": ops}


# -------------------------------------------------------------------- main
# ------------------------------------------------------------- distributed
# the distributed phase's float32 check at the CPU tests' small width
# (tests/test_torch_parallel.py): B 4 with grad_accum 2, so that data 2
# gives each rank one row of each microbatch
DIST_SMALL = dict(grid_size=32, feat_dim=32, nkeypoints=6, Ttot=4,
                  nlatent_kypt=16, nhidden_kypt=32, grad_accum=2)
DIST_SMALL_B, DIST_SMALL_N = 4, 1024
DIST_PHASES = {   # (config fields, (detector, learner, affinity))
    "detector": (dict(detector_start=0, learner_start=int(1e9),
                      affinity_anneal=0), (True, False, True)),
    "learner": (dict(detector_end=0, learner_start=0, affinity_anneal=0),
                (False, True, True)),
}
DIST_TOPOLOGIES = {"data2": (2, 1), "model2": (1, 2)}
DIST_TIMED_STEPS = 6      # bf16 AIST-width detector steps; the first warms up
DIST_LAUNCH_KEYS = ("voxelize", "chamfer_fwd", "chamfer_bwd")
DIST_ALLREDUCE_REPS = 5


def _dist_job(cfg, device):
    """The inputs of the distributed phase: the small float32 steps (per
    phase: the configuration, loss weights, flags and skeleton; one
    state_dict and one global batch) and the timed AIST-width run."""
    import dataclasses
    import torch
    from neural_marionette_tpu_torch.models import NeuralMarionette
    from neural_marionette_tpu_torch.skeleton import extract_skeleton
    from neural_marionette_tpu_torch.train import LossScheduler
    small = dataclasses.replace(cfg, **DIST_SMALL)
    net = NeuralMarionette(small)
    _informative_weights(net, seed=31)
    with torch.no_grad():
        aff = net.kypt_detector.get_affinity().numpy()
    steps = {}
    for name, (fields, flags) in DIST_PHASES.items():
        c = dataclasses.replace(small, **fields)
        sched = LossScheduler(c)
        sched.anneal(0)
        steps[name] = dict(cfg=dataclasses.asdict(c),
                           weights=sched.active_weights(), flags=flags,
                           skeleton=extract_skeleton(aff) if flags[1]
                           else None)
    timed = dataclasses.replace(cfg, **DIST_PHASES["detector"][0])
    sched = LossScheduler(timed)
    sched.anneal(0)
    return {"state_dict": net.state_dict(), "steps": steps,
            "points": torch.from_numpy(serving_points(
                DIST_SMALL_B, small.Ttot, DIST_SMALL_N, seed=32)),
            "timed": dict(cfg=dataclasses.asdict(timed),
                          weights=sched.active_weights(),
                          points=[torch.from_numpy(serving_points(
                              SERVE_B, SERVE_T, SERVE_N, seed=33 + i))
                              for i in range(DIST_TIMED_STEPS)])}


def _dist_small_step(job, name, device, mesh=None):
    """One float32 step of ``job``'s phase ``name`` (TF32 off), on this
    rank's rows with a ``mesh``; its metrics, parameters, Adam's first
    moment and generator state on the host."""
    import torch
    from neural_marionette_tpu_torch import MarionetteConfig
    from neural_marionette_tpu_torch.models import (NeuralMarionette,
                                                    SkeletonArrays)
    from neural_marionette_tpu_torch.parallel import shard_batch
    from neural_marionette_tpu_torch.train import (create_train_state,
                                                   make_train_step)
    case = job["steps"][name]
    cfg = MarionetteConfig(**case["cfg"])
    net = NeuralMarionette(cfg, device=device)
    net.load_state_dict(job["state_dict"])
    state = create_train_state(cfg, net,
                               torch.Generator(device).manual_seed(7))
    step = make_train_step(net, cfg, case["weights"], *case["flags"],
                           mesh=mesh)
    pts = job["points"]
    if mesh is not None:
        pts = shard_batch(mesh, pts, microbatches=cfg.grad_accum)
    sk = (None if case["skeleton"] is None else
          SkeletonArrays.from_skeleton(case["skeleton"], device))
    metrics = step(state, pts.to(device), sk)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: v.detach().cpu() for k, v in
                       net.named_parameters()},
            "mu": {k: m.cpu() for k, m in zip(state.optimizer.names,
                                              state.optimizer.mu)},
            "generator": state.generator.get_state()}


def _dist_timed(job, device, mesh=None):
    """``DIST_TIMED_STEPS`` bf16 AIST-width detector steps (B 4, T 10, N
    4096; this rank's rows with a ``mesh``): host ms per step between two
    synchronisations, the launches of K1 and K2 under them, and, with a
    mesh, the ms of one gradient ``all_reduce`` (the step's: one flat
    float32 buffer of every parameter) over ``DIST_ALLREDUCE_REPS``."""
    import torch
    from neural_marionette_tpu_torch import MarionetteConfig
    from neural_marionette_tpu_torch.models import NeuralMarionette
    from neural_marionette_tpu_torch.ops import losses as L
    from neural_marionette_tpu_torch.ops import voxelize as V
    from neural_marionette_tpu_torch.parallel import replicate, shard_batch
    from neural_marionette_tpu_torch.parallel.mesh import all_reduce_mean_
    from neural_marionette_tpu_torch.train import (create_train_state,
                                                   make_train_step)
    from neural_marionette_tpu_torch.weights import init_weights
    t = job["timed"]
    cfg = MarionetteConfig(**t["cfg"])
    net = NeuralMarionette(cfg, dtype=torch.bfloat16, device=device)
    init_weights(net, torch.Generator().manual_seed(cfg.seed))
    if mesh is not None:
        replicate(mesh, net)
    state = create_train_state(cfg, net,
                               torch.Generator(device).manual_seed(3))
    step = make_train_step(net, cfg, t["weights"], True, False, True,
                           mesh=mesh)
    ms = []
    V.launches = L.launches = L.bwd_launches = 0
    for pts in t["points"]:
        if mesh is not None:
            pts = shard_batch(mesh, pts)
        pts = pts.to(device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        metrics = step(state, pts)
        torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(float(metrics["total_loss"])):
            raise AssertionError(f"distributed timed step: {metrics}")
    out = {"step_ms": ms, "step_ms_p50": float(np.median(ms[1:])),
           "launches": {"voxelize": V.launches, "chamfer_fwd": L.launches,
                        "chamfer_bwd": L.bwd_launches}}
    if mesh is not None:
        bufs = [torch.zeros_like(p) for p in net.parameters()]
        reps = []
        for _ in range(DIST_ALLREDUCE_REPS):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            all_reduce_mean_(bufs, mesh)
            torch.cuda.synchronize(device)
            reps.append((time.perf_counter() - t0) * 1e3)
        out.update(allreduce_ms=float(np.median(reps)),
                   allreduce_mb=sum(b.numel() for b in bufs) * 4 / 2 ** 20)
    return out


def dist_worker(port, rank, world, data, model, job_path, backend):
    """One rank of the distributed phase on ``cuda:{rank % cards}``, over
    ``backend`` (gloo for several processes on one card, which NCCL
    refuses): the small float32 steps, then the timed run; its results go
    to ``<job_path>.<rank>``."""
    import torch
    from neural_marionette_tpu_torch.parallel import make_mesh
    from neural_marionette_tpu_torch.parallel.distributed import (
        initialize, shutdown, warmup_collectives)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = initialize(f"localhost:{port}", int(world), int(rank),
                        device="cuda", backend=backend)
    try:
        mesh = make_mesh(int(data), int(model))
        warmup_collectives(mesh, device)
        job = torch.load(job_path, weights_only=False)
        res = {name: _dist_small_step(job, name, device, mesh)
               for name in DIST_PHASES}
        res["timed"] = _dist_timed(job, device, mesh)
        torch.save(res, f"{job_path}.{rank}")
    finally:
        shutdown()


def _dist_compare(got, want, lr, what):
    """A rank's small step against the one-process card step. Tolerances
    (the ranks differ only in the order of float32 sums, and cuDNN may
    pick other algorithms for other batch sizes): metrics 1e-4 relative
    plus 1e-6 absolute, ``grad_norm`` 1e-3 (``tests/test_torch_parallel.py``
    and ``tests/test_torch_train_step.py``); Adam's first moment per tensor
    within 1e-3 of its largest entry and 1e-4 relative L2 over all;
    parameters within 2 lr everywhere and all but 1/1000 within 5e-5 +
    1e-2 |p|; the generator state equal to the bit. Returns the errors."""
    import torch
    failed = []
    for k, v in want["metrics"].items():
        tol = (1e-3 * abs(v)) if k == "grad_norm" else (1e-4 * abs(v) + 1e-6)
        if not abs(got["metrics"][k] - v) <= tol:
            failed.append(f"metric {k} {got['metrics'][k]!r} vs {v!r}")
    worst, l2, name = _grad_distance(got["mu"], want["mu"])
    if not worst <= 1e-3 or not l2 <= 1e-4:
        failed.append(f"Adam's first moment: worst tensor {worst:.3e} "
                      f"({name}), L2 {l2:.3e}")
    total = loose = 0
    dmax = 0.0
    for k, b in want["params"].items():
        d = (got["params"][k] - b).abs()
        dmax = max(dmax, float(d.max()))
        loose += int((d > 5e-5 + 1e-2 * b.abs()).sum())
        total += d.numel()
    if dmax > 2 * lr + 1e-6 or loose > total // 1000:
        failed.append(f"parameters: max diff {dmax:.3e}, {loose} of {total} "
                      f"loose")
    if not torch.equal(got["generator"], want["generator"]):
        failed.append("generator state differs")
    if failed:
        raise AssertionError(f"distributed {what}: " + "; ".join(failed))
    return {"grad_worst_tensor": worst, "grad_l2": l2, "param_max_diff": dmax,
            "params_loose": loose,
            "metric_max_rel": max(abs(got["metrics"][k] - v) / (abs(v) + 1e-30)
                                  for k, v in want["metrics"].items())}


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dist_cli(work: Path, tag: str, nproc: int, extra=()):
    """``cli.train`` over NCCL at the small width (4 synthetic sequences:
    one step of B 4, one epoch) in ``nproc`` processes, one per card
    (``--num_processes nproc --mesh_data nproc``; 1: a process group of
    one), with the flags ``extra``; checks every rank's exit and launches
    and rank 0's one finite record. Returns (the record, each rank's
    launches of K1-K3, seconds)."""
    out = work / tag
    argv = [sys.executable, "-m", "neural_marionette_tpu_torch.cli.train",
            "--dataset", "synthetic", "--synthetic_sequences", "4",
            "--apply_adjust_config", "0", "--nbatch", "4", "--nepoch", "1",
            "--output_root", str(out), "--exp_name", tag,
            "--num_workers", "0", "--is_eval", "1", "--detector_start", "0",
            "--detector_end", "1", "--learner_start", "1",
            "--affinity_anneal", "0",
            "--coordinator_address", f"localhost:{_free_port()}",
            "--num_processes", str(nproc), "--mesh_data", str(nproc),
            "--mesh_model", "1", *extra]
    for k, v in DIST_SMALL.items():
        if k != "grad_accum":
            argv += [f"--{k}", str(v)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv + ["--process_id", str(r)], cwd=ROOT,
                              env=dict(os.environ, PYTHONPATH=str(ROOT)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(nproc)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    secs = time.perf_counter() - t0
    launches = []
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or "training complete" not in o:
            raise AssertionError(f"cli.train {tag} rank {r}: rc "
                                 f"{p.returncode}\n{o[-3000:]}")
        line = [ln for ln in o.splitlines()
                if ln.startswith("kernel launches ")][-1]
        launches.append(json.loads(line[len("kernel launches "):]))
        if not launches[-1]["voxelize"] > 0 or \
                not launches[-1]["chamfer_fwd"] > 0:
            raise AssertionError(f"cli.train {tag}: launches {launches}")
    metrics = list(out.rglob("metrics.jsonl"))
    records = [json.loads(ln) for ln in metrics[0].read_text().splitlines()] \
        if len(metrics) == 1 else []
    if len(records) != 1 or not all(
            np.isfinite(v) for part in ("train", "valid")
            for v in records[0][part].values()):
        raise AssertionError(f"cli.train {tag}: records {records}")
    log(f"[distributed] cli.train over NCCL, {nproc} process(es): "
        f"{secs:.1f} s, launches {launches}, total_loss "
        f"{records[0]['train']['total_loss']:.4f}")
    return records[0], launches, secs


def _cli_params(work: Path, tag: str) -> dict:
    """The parameters of ``_dist_cli`` run ``tag``'s epoch-0 checkpoint."""
    import torch
    (state,) = (work / tag).rglob("epochs/0/state.pt")
    return torch.load(state, map_location="cpu", weights_only=True)["model"]


def _dist_group(job_path: Path, data: int, model: int, backend: str):
    """The ranks of a (data, model) mesh running ``dist_worker`` on
    ``job_path``; returns (each rank's results, seconds)."""
    import torch
    port, world = _free_port(), data * model
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--distributed-worker",
         str(port), str(r), str(world), str(data), str(model), str(job_path),
         backend], cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = [p.communicate(timeout=400)[0] for p in procs]
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"distributed {data}x{model} {backend} "
                                 f"rank {r}: rc {p.returncode}\n{o[-3000:]}")
    return ([torch.load(f"{job_path}.{r}", weights_only=False)
             for r in range(world)], time.perf_counter() - t0)


def _dist_topology(job_path, one, lr, topo, data, model, backend, where):
    """One topology's ranks against the one-process card steps
    (``_dist_compare``; every rank's parameters equal to rank 0's), and
    their timed run; returns its record."""
    import torch
    ranks, secs = _dist_group(job_path, data, model, backend)
    rec = {"seconds": secs, "backend": backend, "checks": {}}
    for name in DIST_PHASES:
        for r, res in enumerate(ranks):
            rec["checks"][f"{name}_rank{r}"] = _dist_compare(
                res[name], one[name], lr, f"{topo} {name} rank {r}")
            for k, v in res[name]["params"].items():
                if not torch.equal(v, ranks[0][name]["params"][k]):
                    raise AssertionError(f"distributed {topo} {name}: rank "
                                         f"{r}'s {k} differs from rank 0's")
    rec["timed"] = [res["timed"] for res in ranks]
    rec["step_ms_p50"] = max(t["step_ms_p50"] for t in rec["timed"])
    rec["allreduce_ms"] = max(t["allreduce_ms"] for t in rec["timed"])
    worst = max(v["grad_worst_tensor"] for v in rec["checks"].values())
    log(f"[distributed] {topo} ({where}, {backend}): every rank's small "
        f"float32 steps equal to one process (Adam moment worst "
        f"{worst:.2e}); bf16 AIST width step p50 {rec['step_ms_p50']:.1f} "
        f"ms, all_reduce {rec['allreduce_ms']:.1f} ms of "
        f"{rec['timed'][0]['allreduce_mb']:.1f} MB, launches "
        f"{[t['launches'] for t in rec['timed']]}; {secs:.1f} s")
    return rec


def _dist_references(cfg, device, work: Path):
    """The job of the distributed phase written to ``work``, and the
    one-process card steps and timed run it is held against."""
    import torch
    job = _dist_job(cfg, device)
    job_path = work / "job.pt"
    torch.save(job, job_path)
    one = {name: _dist_small_step(job, name, device) for name in DIST_PHASES}
    timed = _dist_timed(job, device)
    log(f"[distributed] one process, bf16 AIST width: step ms "
        f"{[round(x, 1) for x in timed['step_ms']]}")
    return job_path, one, timed, job["steps"]["detector"]["cfg"]["lrate"]


def phase_distributed(cfg, device, card):
    """The distributed layer on the one card: ``cli.train`` over NCCL in a
    process group of one; then two processes on the card over gloo in
    ``data 2`` and in ``model 2``, each rank's float32 detector- and
    learner-phase step (grad_accum 2) against the one-process card step
    (``_dist_compare``), and a bf16 AIST-width detector run per topology
    (B 4, T 10, N 4096): step p50 against one process, the gradient
    ``all_reduce`` ms, the launches of K1 and K2. Two processes share one
    card and gloo copies every collective through the host, so these times
    measure neither NCCL nor two cards (``--distributed-cards`` does, on a
    machine with four)."""
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    try:
        rec, launches, secs = _dist_cli(work, "nccl", 1)
        out = {"card": card, "cli_nccl": {
            "seconds": secs, "launches": launches[0],
            "total_loss": rec["train"]["total_loss"]}}
        job_path, one, out["one_process"], lr = _dist_references(
            cfg, device, work)
        for topo, (data, model) in DIST_TOPOLOGIES.items():
            out[topo] = _dist_topology(job_path, one, lr, topo, data, model,
                                       "gloo", "2 processes, one card")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[distributed] phase {out['seconds']:.1f} s")
    return out


# the topologies of ``--distributed-cards``, one process per card
DIST_CARD_TOPOLOGIES = {"data2": (2, 1), "model2": (1, 2),
                        "data2_model2": (2, 2)}


def distributed_cards() -> int:
    """``--distributed-cards``, on a machine with four cards: the
    distributed layer over NCCL, one process per card. ``cli.train`` in
    two processes (``--mesh_data 2``) against one process with
    ``--grad_accum 2``, whose convs then run on the same two rows a
    forward (the detector's float32 gradient is ill-conditioned enough
    that other batch sizes give other convolution arithmetic and a
    gradient norm 1e-3 apart): the epoch's training losses within 1e-4
    relative plus 1e-6, ``grad_norm`` 1e-3, and the epoch-0 checkpoint's
    parameters within 2 lr, all but 1/1000 within 5e-5 + 1e-2 |p|, as
    ``tests/test_torch_distributed_cli.py`` (validation runs 4 rows a
    forward in one process and 2 in each of two, so its losses are only
    checked finite); then
    ``DIST_CARD_TOPOLOGIES``, each rank's small float32 steps against the
    one-process card step (``_dist_compare``) and the bf16 AIST-width
    detector run (step p50, gradient ``all_reduce`` ms, launches). Prints
    a ``{"distributed_cards": ...}`` line; exits 2 with fewer than four
    cards."""
    import torch
    if torch.cuda.device_count() < 4:
        print("chip_smoke --distributed-cards: needs four cards",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from neural_marionette_tpu_torch import MarionetteConfig, adjust_config
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = phase_card()
    phase_build()
    cfg = adjust_config(MarionetteConfig(dataset="aist"))
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_cards_"))
    try:
        one_rec, _, _ = _dist_cli(work, "one", 1, ("--grad_accum", "2"))
        two_rec, launches, secs = _dist_cli(work, "two", 2)
        worst = {}
        for k, v in one_rec["train"].items():
            got = two_rec["train"][k]
            tol = 1e-3 * abs(v) if k == "grad_norm" else 1e-4 * abs(v) + 1e-6
            if not abs(got - v) <= tol:
                raise AssertionError(f"cli.train on 2 cards: train {k} "
                                     f"{got!r}, one process {v!r}")
            worst[k] = abs(got - v) / (abs(v) + 1e-30)
        want, got = _cli_params(work, "one"), _cli_params(work, "two")
        lr = one_rec["lr"]
        loose = total = 0
        dmax = 0.0
        for k, b in want.items():
            d = (got[k] - b).abs()
            dmax = max(dmax, float(d.max()))
            loose += int((d > 5e-5 + 1e-2 * b.abs()).sum())
            total += d.numel()
        if dmax > 2 * lr + 1e-6 or loose > total // 1000:
            raise AssertionError(f"cli.train on 2 cards: checkpoint max diff "
                                 f"{dmax:.3e}, {loose} of {total} loose")
        out = {"card": card, "cards": torch.cuda.device_count(),
               "cli_two_cards": {"seconds": secs, "launches": launches,
                                 "train_max_rel_diff": max(worst.values()),
                                 "param_max_diff": dmax,
                                 "params_loose": loose}}
        job_path, one, out["one_process"], lr = _dist_references(
            cfg, torch.device("cuda", 0), work)
        for topo, (data, model) in DIST_CARD_TOPOLOGIES.items():
            out[topo] = _dist_topology(job_path, one, lr, topo, data, model,
                                       "nccl", f"{data * model} cards")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"distributed_cards": out}))
    print(card)
    return 0


# ----------------------------------------------------- stream of two trees
# run in a fresh process from a checkout's root: that checkout's own
# stream phase (its default outputs) and serving profile, one JSON line
STREAM_TREE = """
import json, sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke as c
from neural_marionette_tpu_torch import MarionetteConfig, adjust_config
from neural_marionette_tpu_torch.api import Marionette
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
card = c.phase_card()
c.phase_build()
cfg = adjust_config(MarionetteConfig(dataset="aist"))
m = Marionette.from_config(cfg, seed=0, device=torch.device("cuda"))
out = {}
for route in (False, True):
    ms, launches, _ = c.phase_stream(m, c.STREAM_WINDOWS, conv_kernel=route)
    rec = c.stream_record(ms, c.STREAM_WINDOWS, None, card)
    prof = c.phase_profile(m, conv_kernel=route)
    out["conv_kernel" if route else "default"] = {
        "mean_ms_per_window": rec["mean_ms_per_window"],
        "p50_ms_per_window": rec["p50_ms_per_window"],
        "launches": launches, "layers_ms": prof["layers_ms"],
        "device_busy_ms_per_window": prof["device_busy_ms_per_window"],
        "device_busy_share": prof["device_busy_share"],
        "device_ops_per_window": prof["device_ops_per_window"],
        "wall_ms_per_window": prof["wall_ms_per_window"]}
print("STREAM_TREE " + json.dumps(out), flush=True)
"""


def stream_compare(roots):
    """The stream phase and the serving profile of each checkout in
    ``roots``, in that order, each in a process of its own from its root
    (e.g. the parent from ``git archive`` and this one: parent, change,
    change, parent); prints one ``{"stream_compare": [...]}`` line."""
    rows = []
    for root in roots:
        res = subprocess.run([sys.executable, "-c", STREAM_TREE],
                             cwd=root, capture_output=True, text=True,
                             timeout=900)
        print(res.stdout[-4000:], flush=True)
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith("STREAM_TREE ")]
        if res.returncode != 0 or not line:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        rows.append({"root": str(root), **json.loads(line[-1][12:])})
    print(json.dumps({"stream_compare": rows}))
    return 0


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
    from neural_marionette_tpu_torch.models import NeuralMarionette
    from neural_marionette_tpu_torch.ops import losses as L
    from neural_marionette_tpu_torch.ops.voxelize import voxelize

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

    errs = {"voxelize": phase_k1(device)}
    phase_k2(device, G, SERVE_B * SERVE_T, K)
    errs["chamfer_bwd"] = phase_k2_bwd(device, G, SERVE_B * SERVE_T, K)

    # K3 and K4 at the conv route's shapes, on a routed model whose
    # seeded weights give informative activations
    routed = NeuralMarionette(cfg, dtype=torch.bfloat16, device=device,
                              conv_kernel=True).eval()
    _informative_weights(routed, seed=0)
    vox = voxelize(torch.from_numpy(serving_points(
        SERVE_B, SERVE_T, SERVE_N, seed=51)).to(device), G,
        dtype=torch.bfloat16)
    shapes, errs["conv3d"] = phase_k3(device, routed.kypt_detector, vox)
    k4_launches, errs["fused_stage"], stages = phase_k4(
        device, routed.kypt_detector, vox)
    phase_route_window(cfg, device, routed, vox)
    conv_records, conv_rows = phase_timing_conv(device, shapes, stages, errs)
    del vox, stages, routed
    torch.cuda.empty_cache()

    marionette = Marionette.from_config(cfg, seed=0, device=device)
    torch.cuda.reset_peak_memory_stats()
    ms, launches, results = phase_stream(marionette, STREAM_WINDOWS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    ms_c, launches_c, results_c = phase_stream(marionette, STREAM_WINDOWS,
                                               conv_kernel=True)
    peak_c = torch.cuda.max_memory_allocated() / 2 ** 30
    kp_diff, recon_diff = compare_streams(results_c, results)
    # a stream of recon and every loss scalar, on the conv route, launches
    # what every window launched before the stream pruned its work: K1 and
    # K2 forward once a window, K3 48 times; its default outputs are the
    # pruned routed stream's to the bit (the same windows and noise)
    torch.cuda.reset_peak_memory_stats()
    ms_a, launches_a, results_a = phase_stream(
        marionette, STREAM_WINDOWS, conv_kernel=True,
        shapes=_all_outputs(cfg, SERVE_B, SERVE_T))
    peak_a = torch.cuda.max_memory_allocated() / 2 ** 30
    for a, c in zip(results_a, results_c):
        for k in _window_outputs(cfg, 1, 1):
            if not np.array_equal(a[k], c[k]):
                raise AssertionError(
                    f"stream {k}: the pruned window's differs from the full "
                    f"window's by {float(np.abs(a[k] - c[k]).max()):.3e}")
    log("[stream all outputs conv_kernel] keypoints, kypt_recon and R equal "
        "to the bit to the pruned routed stream's")
    del results, results_c, results_a
    # the kernels line's launches: the stream of every output on the
    # route, which runs all three serving kernels; the pruned streams'
    # counts beside them (launches_pruned_stream)
    pruned_launches = {"stream": launches, "stream_conv_kernel": launches_c}
    launches = dict(launches_a, fused_stage=k4_launches)

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
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        train, det_launches, saved, trained_affinity = phase_train(
            cfg, device, card, work / "detector" / "aist_detector")
        launches["chamfer_bwd"] = det_launches["chamfer_bwd"]
        torch.cuda.empty_cache()
        train["pretrained"] = phase_train_pretrained(device, work, saved)
        del saved
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    train["conv_kernel"] = phase_train_conv(cfg, device)
    torch.cuda.empty_cache()
    phase_train_reference(cfg, seed=0, card_device=device)
    options = phase_options(cfg, device, card)
    torch.cuda.empty_cache()
    apps_keep = {}
    apps = phase_apps(cfg, device, apps_keep)
    apps["generate_step"] = phase_generate_step(cfg, device)
    apps["reference"] = phase_apps_reference(cfg, device)
    torch.cuda.empty_cache()
    # the phases that read device events from the profiler; each recorded
    # round opens and closes on an idle card (profiler_gap), without which
    # the profiler dropped some or all of K1's 10 launches here now and then
    records = phase_timing(device, G, K, launches, errs)
    for rec in conv_records:
        rec["launches"] = launches[rec["name"]]
    records += conv_records
    profile = phase_profile(marionette)
    profile["conv_kernel"] = phase_profile(marionette, conv_kernel=True)
    profile["conv_kernel_all_outputs"] = phase_profile(
        marionette, conv_kernel=True,
        outputs=tuple(_all_outputs(cfg, SERVE_B, SERVE_T)))
    cli = phase_cli(device, card)
    torch.cuda.empty_cache()
    textures = phase_textures(card)
    render = phase_render(cfg, device, card, apps_keep, trained_affinity)
    del apps_keep
    torch.cuda.empty_cache()
    remat = phase_remat(cfg, device, card)
    torch.cuda.empty_cache()
    flag = phase_flagship(card)
    dist = phase_distributed(cfg, device, card)
    # K3's device ms of a window of all its 48 routed convs (the stream
    # asking for recon and every loss), as its kernel ms are
    k3_dev = sum(k["device_ms_per_call"] * k["calls_per_window"]
                 for k in profile["conv_kernel_all_outputs"]["port_kernels"]
                 if "conv3d_kernel" in k["name"])
    records[-2]["device_ms"] = k3_dev   # per window, from the profiler
    for rec in records:   # launches on this slice's paths
        if rec["name"] in pruned_launches["stream"]:
            rec["launches_pruned_stream"] = {
                k: v[rec["name"]] for k, v in pruned_launches.items()}
        if rec["name"] in DIST_LAUNCH_KEYS:
            rec["launches_distributed"] = {
                topo: [t["launches"][rec["name"]] for t in
                       dist[topo]["timed"]] for topo in DIST_TOPOLOGIES}
        if rec["name"] == "chamfer_fwd":
            rec["launches_apps"] = apps["launches"]["chamfer_fwd"]
        elif rec["name"] == "conv3d":
            rec["launches_generate_step"] = \
                apps["generate_step"]["conv_kernel"]["launches"]["conv3d"]
            rec["launches_remat"] = {
                r: v["launches"]["conv3d"]
                for r, v in remat["routed_b4"].items()}
        if rec["name"] in cli["launches"]:
            rec["launches_cli"] = cli["launches"][rec["name"]]
        if rec["name"] in FLAGSHIP_LAUNCHES["phase1"]:
            rec["launches_flagship"] = {
                p: flag[p]["launches"][rec["name"]] for p in FLAGSHIP_LAUNCHES}

    stream = stream_record(ms, STREAM_WINDOWS, peak, card,
                           outputs=sorted(_window_outputs(cfg, 1, 1)),
                           launches=pruned_launches["stream"])
    stream_c = stream_record(ms_c, STREAM_WINDOWS, peak_c, card,
                             conv3d_launches=launches_c["conv3d"],
                             launches=launches_c,
                             keypoints_max_abs_diff=kp_diff,
                             kypt_recon_max_abs_diff=recon_diff)
    stream["all_outputs_conv_kernel"] = stream_record(
        ms_a, STREAM_WINDOWS, peak_a, card, launches=launches_a,
        outputs=sorted(_all_outputs(cfg, 1, 1)))
    for tag, st in (("stream", stream), ("stream conv_kernel", stream_c),
                    ("stream all outputs conv_kernel",
                     stream["all_outputs_conv_kernel"])):
        log(f"[{tag}] steady windows: mean {st['mean_ms_per_window']:.2f} "
            f"ms, p50 {st['p50_ms_per_window']:.2f} ms over "
            f"{STREAM_WINDOWS - 2}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"conv3d_shapes": conv_rows}))
    print(json.dumps({"stream": stream}))
    print(json.dumps({"stream_conv_kernel": stream_c}))
    print(json.dumps({"profile": profile}))
    print(json.dumps({"train": train}))
    print(json.dumps({"apps": apps}))
    print(json.dumps({"cli": cli}))
    print(json.dumps({"textures": textures}))
    print(json.dumps({"render": render}))
    print(json.dumps({"options": options}))
    print(json.dumps({"remat": remat}))
    print(json.dumps({"flagship": flag}))
    print(json.dumps({"distributed": dist}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--distributed-worker"]:
        sys.path.insert(0, str(ROOT))
        sys.exit(dist_worker(*sys.argv[2:]))
    if sys.argv[1:2] == ["--stream-compare"]:
        sys.exit(stream_compare(sys.argv[2:]))
    if sys.argv[1:2] == ["--distributed-cards"]:
        sys.exit(distributed_cards())
    sys.exit(main())
