"""TIFF through the port's ``viz/tiff.decode_tiff`` against imageio's
bundled tifffile (the JAX retarget path's reader), beyond the fixtures of
``tests/torch_textures/``:

* every (SampleFormat, BitsPerSample) pair of tifffile's ``SAMPLE_DTYPES``
  (and pairs it lacks), in both byte orders, with and without predictor 2,
  written small: the port reads what imageio reads, as imageio's pixels
  under the rule of ``apps.retarget.texture_rgb``, and refuses what imageio
  refuses;
* a TIFF past Pillow's pixel cap, which tifffile reads: the port's samples
  against imageio's by shape and digest (the float texture is not built);
* the Lab rule against Pillow's ``convert("RGB")`` (LittleCMS) on the
  fixtures Pillow opens as LAB.
"""
from __future__ import annotations

import hashlib
import importlib.util
import struct
import warnings
import zlib
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest
from imageio.plugins import _tifffile

from neural_marionette_tpu_torch.apps import retarget as PRT
from neural_marionette_tpu_torch.viz import image_files as F

TEX = Path(__file__).resolve().parent / "torch_textures"
_spec = importlib.util.spec_from_file_location("make_textures",
                                               TEX / "make_textures.py")
MAKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(MAKE)

# tifffile's table, and pairs it lacks
PAIRS = sorted(_tifffile.TIFF.SAMPLE_DTYPES, key=str) + [
    (3, 24), (4, 8), (5, 16), (6, 32), (2, 4)]


def _samples(fmt, bits, rng):
    """(5, 7, 3) samples of the pair's type (5-6-5: its three fields)."""
    if isinstance(bits, tuple):
        return np.stack([rng.integers(0, 1 << b, (5, 7)) for b in bits],
                        -1).astype(np.uint8)
    code = _tifffile.TIFF.SAMPLE_DTYPES.get((fmt, bits))
    dt = np.dtype(code if code and code != "?" else
                  {8: "u1", 16: "u2", 32: "u4"}.get(bits, "u1"))
    if dt.kind == "f":
        return rng.uniform(-0.2, 1.2, (5, 7, 3)).astype(dt)
    if dt.kind == "c":
        return (rng.uniform(-0.2, 1.2, (5, 7, 3))
                + 1j * rng.random((5, 7, 3))).astype(dt)
    hi = 1 << min(bits, 63)
    v = rng.integers(0, hi, (5, 7, 3), dtype=np.uint64)
    if fmt == 2 and dt.kind == "i":
        return (v.astype(dt.str.replace("i", "u"))).view(dt)
    return v.astype(dt)


def _rule(arr):
    """The rule of imageio's array for the texture (make_textures)."""
    if arr.dtype.kind == "c":
        return "complex"
    if arr.dtype.kind == "f":
        return "float"
    if arr.dtype.kind == "i":
        return "signed"
    if arr.dtype.itemsize >= 4:
        return "wide"
    return None


@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("pair", PAIRS, ids=str)
def test_every_sample_type_as_imageio_reads_it(tmp_path, pair, order,
                                               predictor):
    """Each (format, bits) pair written small (RGB, LZW): where imageio
    reads it the port's texture is imageio's pixels under the rule
    (1, 2 and 4 bits scaled, wide integers normalised, signed ones offset,
    complex ones' real parts, floats clipped); where imageio refuses it
    (the depths its unpacker cannot split, the pairs its table lacks) the
    port raises ``ValueError``."""
    fmt, bits = pair
    rng = np.random.default_rng(zlib.crc32(f"{pair}{order}".encode()))
    v = _samples(fmt, bits, rng)
    path = tmp_path / "x.tif"
    path.write_bytes(MAKE.tiff_file(
        v, 2, order=order, compression=5, predictor=predictor,
        sample_format=fmt, bits=bits if bits != 8 * v.dtype.itemsize
        else None))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            arr = np.asarray(imageio.imread(path))
    except Exception:
        with pytest.raises(ValueError, match="TIFF"):
            F.read_image(str(path))
        return
    rule = "scale" if arr.dtype == np.uint8 and bits in (2, 4) else \
        _rule(arr)
    rgb, divisor, _ = MAKE.expected(arr, rule, path)
    want = (rgb.astype(np.float64) / np.float64(divisor)).astype(np.float32)
    got = PRT.texture_rgb(F.read_image(str(path)))
    assert got.dtype == np.float32 and np.array_equal(got, want)


def _strips_tiff(W: int, H: int, rows: int, strip: bytes,
                 last: bytes) -> bytes:
    """A little-endian grey 8-bit TIFF of deflate strips: every strip
    ``strip`` but the last, ``last``."""
    n = -(-H // rows)
    blobs = [strip] * (n - 1) + [last]
    offsets, pos = [], 8
    for b in blobs:
        offsets.append(pos)
        pos += len(b)
    ifd_at = pos + 4 * n * 2
    tags = [(256, 4, 1, W), (257, 4, 1, H), (258, 3, 1, 8), (259, 3, 1, 8),
            (262, 3, 1, 1), (273, 4, n, pos), (277, 3, 1, 1),
            (278, 4, 1, rows), (279, 4, n, pos + 4 * n)]
    ifd = struct.pack("<H", len(tags)) + b"".join(
        struct.pack("<HHII", c, k, cnt, val) for c, k, cnt, val in tags) \
        + b"\0\0\0\0"
    return (b"II*\0" + struct.pack("<I", ifd_at) + b"".join(blobs)
            + struct.pack(f"<{n}I", *offsets)
            + struct.pack(f"<{n}I", *map(len, blobs)) + ifd)


def test_past_pillows_pixel_cap_reads_as_imageio(tmp_path):
    """A grey TIFF of 13379 x 13376 pixels, past the 178,956,970 that
    Pillow (and the port, for the formats imageio reads through Pillow)
    refuses: tifffile has no cap, and the port's samples are imageio's,
    compared by shape and SHA-256 (the float32 texture, 716 MB, is not
    built)."""
    W, H, rows = 13379, 13376, 512
    assert W * H > F.MAX_PIXELS
    y = np.arange(rows)[:, None]
    block = ((np.arange(W)[None] + 3 * y) % 251).astype(np.uint8)
    path = tmp_path / "big.tif"
    path.write_bytes(_strips_tiff(W, H, rows, zlib.compress(
        block.tobytes(), 1), zlib.compress(block[:H % rows].tobytes(), 1)))
    got = F.read_image(str(path))
    shape, digest = got.shape, hashlib.sha256(got).hexdigest()
    del got
    want = np.asarray(imageio.imread(path))
    assert shape == want.shape + (1,)
    assert digest == hashlib.sha256(want).hexdigest()


@pytest.mark.parametrize("name", ["tiff_cielab_pillow.tif",
                                  "tiff_1024_cielab_lzw.tif"])
def test_lab_rule_against_pillow(name):
    """The Lab rule (CIE 1976 inverse, Bradford-adapted sRGB, the sRGB
    curve, rounded) against Pillow's ``convert("RGB")``, which runs the
    same colorimetry through LittleCMS's interpolated 8-bit table: within
    one level on average, and for at least 85 % of the samples (a channel
    near black, where sRGB's curve is steep between the table's nodes,
    differs by more)."""
    from PIL import Image
    path = TEX / name
    with Image.open(path) as im:
        assert im.mode == "LAB"
        pil = np.asarray(im.convert("RGB")).astype(np.int64)
    port = F.read_image(str(path)).astype(np.int64)
    d = np.abs(pil - port)
    assert d.mean() < 1.0 and (d <= 1).mean() >= 0.85, (d.mean(), d.max())
