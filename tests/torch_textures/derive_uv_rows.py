"""Derive libtiff's ``uv_row`` table (uvcode.h: per row of LogLuv24's
(u', v') grid its first u', its number of cells and the cells before it)
from libtiff's own decoding, and print it as the C table of
``csrc/nm_tiffcodec.cpp``.

    python tests/torch_textures/derive_uv_rows.py [--check-opencv]

Needs Pillow (its bundled libtiff, called through ctypes) and, for
``--check-opencv``, OpenCV; the port's library is built with g++.

A LogLuv24 TIFF holding every 14-bit chroma code at a fixed luminance is
read by libtiff with ``SGILOGDATAFMT_FLOAT``, which gives each code's XYZ
as ``LogLuv24toXYZ`` computes it from its cell's centre: u' = ustart[v] +
(u + 0.5) * UV_SQSIZ, v' = UV_VSTART + (v + 0.5) * UV_SQSIZ. From the XYZ
each code's (u', v') follows; v' names its row, the codes of a row are
consecutive (so its cumulative count is its first code), and each row's
ustart is the one value, printed with six decimals as uvcode.h prints it,
that the row's cells give. The table is then checked by recomputing every
code's XYZ with it, in libtiff's arithmetic, at three luminances: each
float must equal libtiff's to the bit, or the script fails.

``--check-opencv`` then writes a 4096 x 4096 LogLuv24 TIFF holding each of
the 2^24 codes once and compares the port's ``decode_opencv`` with
``cv2.imdecode(IMREAD_COLOR)`` on it (8-bit RGB through ``XYZtoRGB24``).
"""
from __future__ import annotations

import argparse
import ctypes
import glob
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
UV_SQSIZ, UV_VSTART = np.float32(0.0035), np.float32(0.016940)
U_NEU, V_NEU = 0.210526316, 0.473684211
TIFFTAG_SGILOGDATAFMT, SGILOGDATAFMT_FLOAT = 65560, 0


def logluv24_tiff(words: np.ndarray) -> bytes:
    """A LogLuv24 TIFF (compression 34677, one strip) of (H, W) 24-bit
    words, written by the fixture generator."""
    from make_textures import tiff_file
    return tiff_file(np.repeat(words.astype(np.uint32)[..., None], 3, -1),
                     32845, compression=34677, bits=16, sample_format=2,
                     sgilog="luv24")


def libtiff():
    import PIL
    from PIL import Image   # noqa: F401  (loads the libraries of libtiff)
    libs = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..",
                                  "pillow.libs", "libtiff*"))
    if not libs:
        raise SystemExit("Pillow's bundled libtiff was not found")
    lib = ctypes.CDLL(libs[0])
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFReadEncodedStrip.restype = ctypes.c_ssize_t
    lib.TIFFReadEncodedStrip.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                         ctypes.c_void_p, ctypes.c_ssize_t]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    return lib


def libtiff_xyz(lib, words: np.ndarray) -> np.ndarray:
    """libtiff's XYZ (float32, (H, W, 3)) of LogLuv24 words."""
    H, W = words.shape
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "uv.tif")
        Path(path).write_bytes(logluv24_tiff(words))
        tif = lib.TIFFOpen(path.encode(), b"r")
        if not tif:
            raise SystemExit("libtiff cannot open the LogLuv24 file")
        lib.TIFFSetField(ctypes.c_void_p(tif),
                         ctypes.c_uint32(TIFFTAG_SGILOGDATAFMT),
                         ctypes.c_int(SGILOGDATAFMT_FLOAT))
        out = np.zeros((H, W, 3), np.float32)
        n = lib.TIFFReadEncodedStrip(ctypes.c_void_p(tif), 0,
                                     out.ctypes.data, out.nbytes)
        lib.TIFFClose(ctypes.c_void_p(tif))
    if n != out.nbytes:
        raise SystemExit(f"libtiff read {n} of {out.nbytes} bytes")
    return out


def xyz_of(rows, codes: np.ndarray, le: int) -> np.ndarray:
    """LogLuv24toXYZ of chroma ``codes`` at 10-bit luminance ``le``, in
    libtiff's arithmetic (double, float constants, float results)."""
    L = np.exp(np.log(2) / 64. * (le + .5) - np.log(2) * 12.)
    ncum = np.array([r[2] for r in rows])
    vi = np.searchsorted(ncum, codes, side="right") - 1
    ui = codes - ncum[vi]
    ustart = np.array([r[0] for r in rows], np.float32)
    u = ustart[vi].astype(np.float64) + (ui + .5) * np.float64(UV_SQSIZ)
    v = np.float64(UV_VSTART) + (vi + .5) * np.float64(UV_SQSIZ)
    total = rows[-1][2] + rows[-1][1]
    u = np.where(codes < total, u, U_NEU)
    v = np.where(codes < total, v, V_NEU)
    s = 1. / (6. * u - 16. * v + 12.)
    x, y = 9. * u * s, 4. * v * s
    return np.stack([x / y * L, np.full_like(x, L), (1. - x - y) / y * L],
                    -1).astype(np.float32)


def derive(lib) -> list:
    le = 768
    codes = np.arange(1 << 14)
    xyz = libtiff_xyz(lib, (le << 14 | codes).reshape(128, 128)).reshape(
        -1, 3).astype(np.float64)
    X, Y, Z = xyz.T
    den = X + 15 * Y + 3 * Z
    u, v = 4 * X / den, 9 * Y / den
    vi = np.rint((v - np.float64(UV_VSTART)) / np.float64(UV_SQSIZ) - .5)
    # the codes past the grid decode to the neutral point
    neutral = np.isclose(u, U_NEU, atol=1e-6) & np.isclose(v, V_NEU,
                                                           atol=1e-6)
    last = int(np.nonzero(~neutral)[0].max()) + 1
    if not neutral[last:].all():
        raise SystemExit("the neutral codes are not the last ones")
    rows = []
    for r in range(int(vi[:last].max()) + 1):
        mine = np.nonzero(vi[:last] == r)[0]
        if mine.size == 0 or np.any(np.diff(mine) != 1):
            raise SystemExit(f"row {r}: its codes are not consecutive")
        start = u[mine] - (mine - mine[0] + .5) * np.float64(UV_SQSIZ)
        ustart = round(float(np.median(start)), 6)
        if np.abs(start - ustart).max() > 2e-7:
            raise SystemExit(f"row {r}: its cells disagree on ustart")
        rows.append((float(np.float32(ustart)), int(mine.size),
                     int(mine[0]), f"{ustart:.6f}"))
    if rows[-1][2] + rows[-1][1] != last:
        raise SystemExit("the rows do not count the codes")
    for le in (100, 768, 1000):
        want = libtiff_xyz(lib, (le << 14 | codes).reshape(128, 128))
        got = xyz_of(rows, codes, le).reshape(128, 128, 3)
        bad = int((want.view(np.uint32) != got.view(np.uint32)).sum())
        if bad:
            raise SystemExit(f"Le {le}: {bad} floats differ from libtiff")
    return rows


def c_table(rows) -> str:
    total = rows[-1][2] + rows[-1][1]
    lines = [f"// UV_NVS {len(rows)} rows, UV_NDIVS {total} codes, derived "
             "by", "// tests/torch_textures/derive_uv_rows.py",
             "constexpr UvRow kUvRow[kUvNVs] = {"]
    items = [f"{{{r[3]}f, {r[1]}, {r[2]}}}," for r in rows]
    line = "   "
    for it in items:
        if len(line) + 1 + len(it) > 79:
            lines.append(line)
            line = "   "
        line += " " + it
    lines.append(line)
    lines.append("};")
    return "\n".join(lines)


def check_opencv() -> None:
    import cv2
    sys.path.insert(0, str(ROOT))
    from neural_marionette_tpu_torch.viz.opencv_read import decode_opencv
    words = np.arange(1 << 24, dtype=np.uint32).reshape(4096, 4096)
    data = logluv24_tiff(words)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    got = decode_opencv(data, "uv.pbm")
    bad = int((got != want[..., ::-1]).any(-1).sum())
    print(f"every 24-bit LogLuv code: {bad} of {1 << 24} pixels differ from "
          "OpenCV's IMREAD_COLOR")
    if bad:
        raise SystemExit(1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check-opencv", action="store_true")
    args = ap.parse_args()
    rows = derive(libtiff())
    print(c_table(rows))
    if args.check_opencv:
        check_opencv()
    return 0


if __name__ == "__main__":
    sys.exit(main())
