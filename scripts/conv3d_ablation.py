#!/usr/bin/env python3
"""Where the time of kernel K3 (``neural_marionette_tpu_torch/csrc/
conv3d.cu``) goes, on one NVIDIA GPU.

    python3 scripts/conv3d_ablation.py

Builds timing-only variants of the kernel source, each with one phase
removed or one tiling changed, and times each against the kernel itself
at the conv route's largest shapes (bf16, x stored NCDHW, the weight packed
once), with CUDA events, in two rounds of alternating order. A variant
without a phase computes wrong values on purpose; only its time is read.

Variants:

* ``kernel`` — the source as it is;
* ``no_halo`` — no halo gather (A is left as it is);
* ``no_side_columns`` — the x-runs are gathered, not the columns beside them;
* ``no_weight_loads`` — the weight tiles are not copied;
* ``no_mma`` — no warpgroup MMAs;
* ``nt32_brick_8x8x8`` — the 32-column tile on 8 x 8 x 8 bricks instead of
  4 x 8 x 16;
* ``nt64_brick_2x8x16`` — the 64-column tile on 2 x 8 x 16 bricks instead of
  4 x 8 x 8.

Prints the card's name and power limit, a line per variant and shape, and
last one JSON object ``{"conv3d_ablation": {...}}``. Exits nonzero without
a card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SHAPES = [((40, 64, 64, 64, 64), 32), ((40, 64, 64, 64, 32), 32),
          ((40, 32, 32, 32, 128), 64), ((40, 32, 32, 32, 64), 64),
          ((40, 16, 16, 16, 128), 128), ((40, 16, 16, 16, 64), 64)]

# variant -> (replacements in the source, brick (planes, columns) per N
# tile width that the wrapper must mirror, or None to keep its own)
VARIANTS = {
    "kernel": ([], None),
    "no_halo": ([("    load_halo(c);\n", "")], None),
    "no_side_columns": ([("        if (half == 0)\n", "        if (false)\n"),
                         ("        if (half == XT - 1)\n",
                          "        if (false)\n")], None),
    "no_weight_loads": ([("  auto load_b = [&](int s) {\n    if (s < steps) {",
                          "  auto load_b = [&](int s) {\n    if (s < 0) {")],
                        None),
    "no_mma": ([("          Wgmma<NT>::mma(acc[m],",
                 "          if (false) Wgmma<NT>::mma(acc[m],")], None),
    "nt32_brick_8x8x8": ([("struct Tile<32> { static constexpr int ZT = 4, "
                           "XT = 2; };",
                           "struct Tile<32> { static constexpr int ZT = 8, "
                           "XT = 1; };")],
                         {32: (8, 8), 64: (4, 8), 128: (2, 8)}),
    "nt64_brick_2x8x16": ([("struct Tile<64> { static constexpr int ZT = 4, "
                            "XT = 1; };",
                            "struct Tile<64> { static constexpr int ZT = 2, "
                            "XT = 2; };")],
                          {32: (4, 16), 64: (2, 16), 128: (2, 8)}),
}


def log(*a):
    print(*a, flush=True)


def build(kernels, out: Path) -> dict[str, Path]:
    """Compile every variant in parallel (one nvcc each)."""
    src = (kernels.CSRC / "conv3d.cu").read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (edits, _) in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the source no longer "
                                   f"has {old!r} once")
            text = text.replace(old, new)
        cu, so = out / f"{name}.cu", out / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{text}")
        libs[name] = so
    return libs


def load(kernels, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.nm_error_string.argtypes = [ctypes.c_int]
    lib.nm_error_string.restype = ctypes.c_char_p
    for fn, argtypes in kernels._SIGNATURES["conv3d"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("conv3d_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from neural_marionette_tpu_torch import kernels
    from neural_marionette_tpu_torch.ops import conv3d as K3
    card = smoke.phase_card()
    libs = {name: load(kernels, path) for name, path in
            build(kernels, kernels.BUILD_DIR / "ablation").items()}
    own = dict(K3._BRICK)
    device = torch.device("cuda")
    data = []
    for i, (xs, cout) in enumerate(SHAPES):
        x, w, b = smoke._conv_operands(xs, cout, torch.bfloat16, device,
                                       90 + i)
        data.append((xs, cout, x, w, b, K3.packed_operands(w, b)))
    times: dict[str, dict[str, list]] = {}
    order = list(VARIANTS)
    for rnd in range(2):
        for name in order if rnd == 0 else order[::-1]:
            K3._BRICK.clear()
            K3._BRICK.update(VARIANTS[name][1] or own)
            kernels._LIBS["conv3d"] = libs[name]
            K3._checked.clear()
            for xs, cout, x, w, b, packed in data:
                ms = smoke.cuda_ms(
                    lambda: K3.conv3d(x, w, b, packed=packed), iters=5)
                times.setdefault(name, {}).setdefault(
                    f"{xs}->{cout}", []).append(ms)
    K3._BRICK.clear()
    K3._BRICK.update(own)
    kernels._LIBS.pop("conv3d")
    K3._checked.clear()
    for name, rows in times.items():
        for shape, ms in rows.items():
            log(f"[ablation] {name:18s} {shape:28s} " +
                " ".join(f"{m:.4f}" for m in ms) + " ms")
    print(card)
    print(json.dumps({"conv3d_ablation": {"card": card, "ms": times}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
