"""libtiff's CCITT fax and SGILog codecs in the port
(``csrc/nm_tiffcodec.cpp`` through ``viz/opencv_read.py``), against OpenCV
reading the same bytes from a file, as imageio's OpenCV plugin has it read
them (libtiff maps the file, so the word alignment of CCITT RLEW rows
counts from the start of the file):

* seeded random bilevel images, their runs long enough to need every
  make-up code (1792-2560 and the runs past 2560 among them), written by
  Pillow's libtiff in each CCITT coding it writes (T.4 1-D and 2-D, with
  and without fill bits, T.6, modified Huffman byte- and word-aligned),
  in one strip and in several, in either fill order;
* seeded random float images written by ``cv2.imencode`` as LogLuv32
  (34676) and LogLuv24 (34677);
* crafted streams: a T.6 row that enters uncompressed mode, a T.4 file
  whose rows carry no EOL, RLEW strips at odd offsets, a 2-D Group 3 file
  that allows uncompressed mode;
* hypothesis byte flips in the coded data and truncations of every CCITT
  and SGILog fixture: whatever OpenCV reads, the port reads equal, and
  whatever OpenCV refuses, the port refuses with ``ValueError``.

Every comparison is to the bit. The host library is built with g++ on
first use; no card is needed.
"""
from __future__ import annotations

import importlib.util
import io
import json
import os
import struct
import tempfile
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from neural_marionette_tpu_torch.viz import image_files as F
from neural_marionette_tpu_torch.viz import tiff as T

TEX = Path(__file__).resolve().parent / "torch_textures"
_spec = importlib.util.spec_from_file_location("make_textures",
                                               TEX / "make_textures.py")
MAKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(MAKE)
CODEC_FIXTURES = [e["file"] for e in json.loads(
    (TEX / "MANIFEST.json").read_text())["files"]
    if e.get("raises") in ("CCITT", "SGI LogLuv")
    and not e["facts"].get("large")]


def _opencv(data: bytes):
    """OpenCV's IMREAD_COLOR of ``data`` read from a file, as RGB; None
    where it refuses the file."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "texture.pbm")
        Path(path).write_bytes(data)
        img = cv2.imread(path, cv2.IMREAD_COLOR)
    return None if img is None else img[..., ::-1]


def _same_as_opencv(data: bytes) -> bool:
    want = _opencv(data)
    try:
        got = F.decode_image(data, "texture.pbm")
    except ValueError:
        return want is None
    return want is not None and got.dtype == want.dtype and \
        np.array_equal(got, want)


def _bitmap(rng, H, W):
    """Rows of runs: short ones, and long ones (past 2560 where the row
    allows) for the make-up codes."""
    out = np.zeros((H, W), bool)
    for y in range(H):
        x, black = 0, False
        while x < W:
            n = int(rng.choice([rng.integers(0, 9), rng.integers(0, 200),
                                rng.integers(1700, 2800)], p=[.5, .3, .2]))
            out[y, x:x + n] = black
            x, black = x + n, not black
    return out


# (compression, Pillow's tiffinfo)
_PILLOW = {"g3_1d": ("group3", {}), "g3_2d": ("group3", {292: 1}),
           "g3_fill_bits": ("group3", {292: 4}),
           "g3_2d_fill_bits": ("group3", {292: 5}),
           "g4": ("group4", {}), "rle": ("tiff_ccitt", {}),
           "rlew": ("tiff_raw_16", {})}


@pytest.mark.parametrize("width", [37, 2600, 5300])
@pytest.mark.parametrize("coding", sorted(_PILLOW))
def test_pillow_ccitt_reads_as_opencv(coding, width):
    """Random bilevel images written by Pillow's libtiff in each CCITT
    coding, in one strip and in strips of 2 rows, in fill order 1 and 2
    (the widths reach every make-up code)."""
    from PIL import Image, TiffImagePlugin
    rng = np.random.default_rng(width + len(coding))
    img = Image.fromarray(_bitmap(rng, 5, width).astype(np.uint8) * 255
                          ).convert("1")
    compression, tags = _PILLOW[coding]
    for extra in ({}, {278: 2, 266: 2}):
        info = TiffImagePlugin.ImageFileDirectory_v2()
        for tag, value in {**tags, **extra}.items():
            info[tag] = value
        f = io.BytesIO()
        img.save(f, "TIFF", compression=compression, tiffinfo=info)
        assert _same_as_opencv(f.getvalue()), extra
        assert _opencv(f.getvalue()) is not None


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("compression", [34676, 34677])
def test_opencv_sgilog_reads_as_opencv(compression, seed):
    """Random float images (dark, bright past 1, black pixels) written by
    OpenCV's libtiff as LogLuv32 or LogLuv24."""
    rng = np.random.default_rng(seed)
    H, W = (int(v) for v in rng.integers(1, 40, 2))
    img = (rng.uniform(0, 1.6, (H, W, 3)) ** rng.uniform(0.5, 3)).astype(
        np.float32)
    img[rng.random((H, W)) < 0.05] = 0
    ok, enc = cv2.imencode(".tif", img, [cv2.IMWRITE_TIFF_COMPRESSION,
                                         compression])
    assert ok and _same_as_opencv(enc.tobytes())
    assert _opencv(enc.tobytes()) is not None


def _one_strip_tiff(W, H, strip, tags, lead=0):
    """A little-endian TIFF of one strip of coded data (``lead`` bytes
    before it), ``tags`` {tag: (type, values)} over 1-bit grey defaults."""
    fields = {256: (4, [W]), 257: (4, [H]), 258: (3, [1]), 262: (3, [0]),
              273: (4, [8 + lead]), 277: (3, [1]), 278: (4, [H]),
              279: (4, [len(strip)]), **tags}
    at = 8 + lead + len(strip) + (lead + len(strip)) % 2
    ifd = struct.pack("<H", len(fields))
    for tag in sorted(fields):
        kind, values = fields[tag]
        body = struct.pack("<" + {3: "H", 4: "I"}[kind] * len(values),
                           *values)
        ifd += struct.pack("<HHI", tag, kind, len(values)) + body + \
            bytes(4 - len(body))
    return b"II*\x00" + struct.pack("<I", at) + bytes(lead) + strip + \
        bytes((lead + len(strip)) % 2) + ifd + bytes(4)


def _bits(s: str) -> bytes:
    s += "0" * (-len(s) % 8)
    return bytes(int(s[i:i + 8], 2) for i in range(0, len(s), 8))


def test_crafted_ccitt_streams_read_as_opencv():
    """Streams that neither Pillow nor OpenCV writes: uncompressed mode
    entered in a T.6 row (libtiff reports it and reads on), a T.6 stream
    broken by zero bytes (an EOL where a code should be, which ends the
    strip), a T.4 file whose rows carry no EOL (libtiff looks for one,
    finds none and reads the strip again without), a 2-D Group 3 file
    whose options allow uncompressed mode, and RLEW rows whose strip
    starts at an even and at odd offsets of the file (the rows differ)."""
    rng = np.random.default_rng(20)
    rows = _bitmap(rng, 6, 40).astype(np.uint8)
    g4 = MAKE.fax_encode(rows, 4)
    row = MAKE.fax_2d(rows[0], np.zeros(40, np.uint8))
    uncompressed = _bits("1" + "0000001111" + "1" * 20 + row)
    cases = [
        _one_strip_tiff(40, 6, uncompressed, {259: (3, [4])}),
        _one_strip_tiff(40, 6, g4[:len(g4) // 2] + bytes(3) + g4,
                        {259: (3, [4])}),
        _one_strip_tiff(40, 6, MAKE.fax_encode(rows, 3, eol=False),
                        {259: (3, [3])}),
        _one_strip_tiff(40, 6, MAKE.fax_encode(rows, 3, t4=1),
                        {259: (3, [3]), 292: (4, [3])}),
    ]
    for lead in (0, 1, 3):
        cases.append(_one_strip_tiff(40, 6, MAKE.fax_encode(rows, 32771),
                                     {259: (3, [32771])}, lead=lead))
    for data in cases:
        assert _opencv(data) is not None and _same_as_opencv(data)


def _coded_span(data: bytes) -> tuple[int, int]:
    """The first and last byte of a TIFF's strips or tiles."""
    tags = T._Reader(data, "").tags
    tiled = T._TILE_WIDTH in tags
    offsets = tags[T._TILE_OFFSETS if tiled else T._STRIP_OFFSETS]
    counts = tags[T._TILE_COUNTS if tiled else T._STRIP_COUNTS]
    return min(offsets), max(o + c for o, c in zip(offsets, counts))


@settings(max_examples=300, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(name=st.sampled_from(CODEC_FIXTURES),
       flips=st.lists(st.tuples(st.integers(0, 1 << 20),
                                st.integers(1, 255)), min_size=1,
                      max_size=4),
       cut=st.one_of(st.none(), st.integers(0, 1 << 20)))
def test_corrupt_ccitt_and_sgilog_read_as_opencv(name, flips, cut):
    """Bytes of the coded data flipped, and the file cut, in every CCITT
    and SGILog fixture: the port reads what OpenCV reads, to the bit, and
    refuses what it refuses."""
    data = bytearray((TEX / name).read_bytes())
    start, end = _coded_span(bytes(data))
    for pos, mask in flips:
        data[start + pos % (end - start)] ^= mask
    if cut is not None:
        data = data[:cut % (len(data) + 1)]
    assert _same_as_opencv(bytes(data))


def test_directories_as_libtiff_reads_them():
    """Directories that libtiff's TIFFReadDirectory refuses before OpenCV
    decodes anything, refused by the port too: a PlanarConfiguration of
    several values or of a value other than 1 and 2 (read before as
    contiguous samples in the wrong shape, or an IndexError), no
    StripOffsets (a TypeError for JPEG strips), a SamplesPerPixel of 0 or
    past 16 bits (a list of that many extra samples before), a
    RowsPerStrip of 0 (read before as one strip). And the byte count
    libtiff makes up for a lone strip that has none, to the end of the
    file (a JPEG and a CCITT strip read; several LogLuv strips without
    counts are refused)."""
    rgb = np.random.default_rng(5).integers(0, 256, (4, 5, 3)).astype(
        np.uint8).tobytes()
    rgb_tags = {258: (3, [8]), 259: (3, [5]), 262: (3, [2]), 277: (3, [3])}
    lzw = MAKE.lzw_tiff(rgb)
    cases = [_one_strip_tiff(5, 4, lzw, {**rgb_tags, 284: (3, [v])})
             for v in (0, 1, 3)]
    cases.append(_one_strip_tiff(5, 4, lzw, {**rgb_tags, 284: (3, [1, 1])}))
    cases += [_one_strip_tiff(5, 4, lzw, {**rgb_tags, 277: (4, [v])})
              for v in (0, 70000, 1 << 31)]
    cases.append(_one_strip_tiff(5, 4, lzw, {**rgb_tags, 278: (4, [0])}))
    for data in (_one_strip_tiff(5, 4, lzw, rgb_tags),
                 (TEX / "tiff_jpeg.tif").read_bytes()):
        no_offsets = bytearray(data)
        at = no_offsets.index(struct.pack("<HH", 273, 4))
        no_offsets[at:at + 2] = struct.pack("<H", 14609)   # an unknown tag
        cases.append(bytes(no_offsets))
    for name in ("tiff_jpeg.tif", "tiff_ccitt_g3_1d.tif",
                 "tiff_logluv32_opencv.tif"):
        no_counts = bytearray((TEX / name).read_bytes())
        at = no_counts.index(struct.pack("<HH", 279, 4))
        no_counts[at:at + 2] = struct.pack("<H", 3095)     # an unknown tag
        cases.append(bytes(no_counts))
    for data in cases:
        assert _same_as_opencv(data)
    assert _opencv(cases[1]) is not None and _opencv(cases[-2]) is not None
