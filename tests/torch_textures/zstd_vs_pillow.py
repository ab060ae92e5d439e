"""Zstandard TIFF strips, intact and corrupted, through the port's reader
under ``.png`` (``viz/tiff_pillow.py`` over ``csrc/nm_tiffcodec.cpp``'s
``nm_zstd_decode``) and through imageio, which reads them with Pillow's
libtiff and its libzstd 1.5.7: the two must read the same samples or both
refuse.

    python tests/torch_textures/zstd_vs_pillow.py [--seed 0] [--strips 1500]
        [--large]

Each strip is one grey image's frame from ``make_textures.zstd_compress``
(levels 1-19 and -3, with or without a checksum and a content size,
windows of the level's, 1 KiB or 4 KiB), then, in turn, 1-3 bytes set,
1-3 bytes set, the frame cut, bytes appended. ``--large``: images of
100-500 x 200-600 pixels (several blocks) instead of 1-120 x 1-200.
Prints one JSON line: strips, read equal, refused by both, differing
(and the first differing seeds and indices). Needs Pillow and imageio.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import tempfile
import warnings
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("make_textures",
                                               HERE / "make_textures.py")
MAKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(MAKE)


def strips(seed: int, n: int, large: bool = False):
    """``n`` grey TIFFs of one Zstandard strip each, corrupted in turn."""
    rng = np.random.default_rng(seed)
    for k in range(n):
        if large:
            H, W = int(rng.integers(100, 500)), int(rng.integers(200, 600))
        else:
            H, W = int(rng.integers(1, 120)), int(rng.integers(1, 200))
        t = np.arange(H * W) / rng.uniform(3, 80)
        img = ((np.sin(t) * 100 + rng.normal(0, rng.uniform(0, 30), H * W))
               .astype(np.int64) % 256).astype(np.uint8).reshape(H, W, 1)
        frame = bytearray(MAKE.zstd_compress(
            img.tobytes(), int(rng.choice([1, 3, 9, 19, -3])),
            checksum=bool(rng.integers(0, 2)),
            content_size=bool(rng.integers(0, 2)),
            window_log=int(rng.choice([0, 10, 12]))))
        kind = k % 4
        if kind < 2:
            for _ in range(rng.integers(1, 4)):
                frame[rng.integers(len(frame))] = rng.integers(256)
        elif kind == 2:
            frame = frame[:rng.integers(len(frame) + 1)]
        else:
            frame += bytes(rng.integers(0, 256, rng.integers(1, 20)).astype(
                np.uint8))
        yield MAKE.restriped(MAKE.tiff_file(img, 1), bytes(frame), 50000)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--strips", type=int, default=1500)
    ap.add_argument("--large", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE.parent.parent))
    import imageio.v2 as imageio
    from neural_marionette_tpu_torch.viz.image_files import decode_image
    warnings.filterwarnings("ignore")
    counts = {"strips": 0, "equal": 0, "refused": 0, "differ": 0}
    first = []
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "x.png"
        for k, data in enumerate(strips(args.seed, args.strips, args.large)):
            path.write_bytes(data)
            try:
                want = np.asarray(imageio.imread(path))[..., None]
            except Exception:
                want = None
            try:
                got = decode_image(data, "x.png")
            except ValueError:
                got = None
            counts["strips"] += 1
            if want is None and got is None:
                counts["refused"] += 1
            elif want is not None and got is not None and \
                    got.shape == want.shape and np.array_equal(got, want):
                counts["equal"] += 1
            else:
                counts["differ"] += 1
                first = (first + [k])[:5]
    print(json.dumps({**counts, "seed": args.seed, "large": args.large,
                      "first_differing": first}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
