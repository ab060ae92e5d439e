"""Mutated and truncated texture fixtures through the port's readers, with
the five host libraries (``csrc/nm_host.cpp``, ``csrc/nm_webp.cpp``,
``csrc/nm_dds.cpp``, ``csrc/nm_jp2.cpp``, ``csrc/nm_tiffcodec.cpp``) built
under AddressSanitizer and UndefinedBehaviorSanitizer: every decoder of
them, the JPEG processes (Huffman, arithmetic, lossless, block smoothing),
WebP, BCn, QOI and JPEG 2000, the expansions of GIF, TIFF, BMP and TGA,
and TIFF's CCITT fax and SGILog codecs.

    python tests/torch_textures/asan_mutants.py [--per 1000] [--seed 2024]
        [--formats JPEG2000,...] [--as .pbm]

Builds the libraries with ``g++ -fsanitize=address,undefined
-fno-sanitize-recover=undefined`` into a temporary directory, then runs
itself again with the sanitizer runtimes preloaded. Each small fixture that
the port reads (``MANIFEST.json``: its ``files`` and its Radiance HDR and
Sun raster ``route_files``; with ``--as``, also the fixtures the port
refuses under their own names and reads under that one, the CCITT and
SGILog TIFFs among them; ``--formats`` picks by ``image_format``'s
names, in any case) gives ``--per`` mutants, in turn: 1-4
bytes set anywhere; 1-2 bytes set in its first 64; bytes set then the file
cut; the file cut. Every mutant goes through ``decode_image`` and
``texture_rgb``, named as its fixture or, with ``--as``, with that
extension instead (``.pbm``: the OpenCV route of ``viz/opencv_read.py``):
it must raise ``ValueError`` or give a well-formed finite texture. A
sanitizer report ends the process with a nonzero code. Prints one JSON
line: mutants run, read and raised per format, and seconds.
Needs ``g++`` with its sanitizer runtimes; no imaging library.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
LIBS = ("nm_host", "nm_webp", "nm_dds", "nm_jp2", "nm_tiffcodec")
FLAGS = ("-O1", "-g", "-std=c++17", "-shared", "-fPIC", "-pthread",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=undefined",
         "-fno-omit-frame-pointer")


def build(out: Path) -> None:
    procs = [subprocess.Popen(["g++", *FLAGS, "-o", str(out / f"{n}.so"),
                               str(ROOT / "neural_marionette_tpu_torch"
                                   / "csrc" / f"{n}.cpp")])
             for n in LIBS]
    if any(p.wait() for p in procs):
        raise SystemExit("the sanitizer build failed")


def run(lib_dir: Path, per: int, seed: int, formats: str = "",
        suffix: str = "") -> dict:
    sys.path.insert(0, str(ROOT))
    from neural_marionette_tpu_torch import kernels
    for name in LIBS:
        kernels._LIBS[name] = ctypes.CDLL(str(lib_dir / f"{name}.so"))
    from neural_marionette_tpu_torch.apps.retarget import texture_rgb
    from neural_marionette_tpu_torch.viz import image_files as F
    manifest = json.loads((HERE / "MANIFEST.json").read_text())
    names = [e["file"] for e in manifest["files"] + manifest["route_files"]
             if ("raises" not in e or "sha256" in e.get(
                 "opencv_route", {}).get(suffix, {}))
             and "sha256" not in e and not e.get("large")
             and not e["facts"].get("large")]
    if formats:
        wanted = formats.lower().split(",")
        names = [n for n in names if F.image_format(
            (HERE / n).read_bytes(), n).lower() in wanted]
    rng = np.random.default_rng(seed)
    counts: dict = {}
    t0 = time.perf_counter()
    for name in names:
        base = (HERE / name).read_bytes()
        c = counts.setdefault(F.image_format(base, name),
                              dict(run=0, read=0, raised=0))
        if suffix:
            name = name[:name.rindex(".")] + suffix
        for k in range(per):
            d = bytearray(base)
            kind = k % 4
            if kind in (0, 2):
                for _ in range(rng.integers(1, 5)):
                    d[rng.integers(len(d))] = rng.integers(256)
            elif kind == 1:
                for _ in range(rng.integers(1, 3)):
                    d[rng.integers(min(64, len(d)))] = rng.integers(256)
            if kind >= 2:
                d = d[:rng.integers(len(d) + 1)]
            c["run"] += 1
            try:
                img = F.decode_image(bytes(d), name)
            except ValueError:
                c["raised"] += 1
                continue
            tex = texture_rgb(img)
            assert tex.shape == img.shape[:2] + (3,), name
            assert np.isfinite(tex).all() and 0 <= tex.min() <= tex.max() <= 1
            c["read"] += 1
    return {"mutants": sum(c["run"] for c in counts.values()),
            "per_format": counts,
            "seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--formats", default="",
                    help="only these formats (image_format's names)")
    ap.add_argument("--as", dest="suffix", default="",
                    help="read each fixture under this extension")
    ap.add_argument("--lib-dir", default="")
    args = ap.parse_args()
    if args.lib_dir:       # the second run, under the sanitizers
        print(json.dumps(run(Path(args.lib_dir), args.per, args.seed,
                             args.formats, args.suffix)))
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        build(Path(tmp))
        runtimes = [subprocess.run(["g++", f"-print-file-name={lib}"],
                                   capture_output=True, text=True,
                                   check=True).stdout.strip()
                    for lib in ("libasan.so", "libubsan.so")]
        env = dict(os.environ, LD_PRELOAD=" ".join(runtimes),
                   ASAN_OPTIONS="detect_leaks=0:allocator_may_return_null=1")
        return subprocess.run([sys.executable, __file__, "--per",
                               str(args.per), "--seed", str(args.seed),
                               "--formats", args.formats, "--as",
                               args.suffix, "--lib-dir", tmp],
                              env=env).returncode


if __name__ == "__main__":
    sys.exit(main())
