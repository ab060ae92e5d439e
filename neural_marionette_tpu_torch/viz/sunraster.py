"""Sun raster textures (magic ``59 a6 6a 95``), read as imageio reads them
under each name: through Pillow's ``SunImagePlugin`` where Pillow comes
first (``.ras``, ``.png`` and every other name of Pillow's route,
:func:`decode_sun_pillow`), through OpenCV's SunRasterDecoder where OpenCV
does (``.sr``, ``.pbm`` and the other names of OpenCV's route,
:func:`decode_sun_opencv`). ``image_files.imageio_route`` says which.

The header is eight big-endian 32-bit words: magic, width, height, depth,
length (unused), type, colour map type, colour map length; the colour map
follows it (its length / 3 reds, then as many greens and blues), then the
pixels, each row padded to 16 bits. The two readers differ:

* Pillow: depths 1 (a bitmap: bit 1 black, as its "1;I"), 4 and 8 (grey,
  4-bit levels times 17; with a colour map of type 1, at most 1024 bytes,
  palette indices, entries past the map black), 24 and 32 (BGR and BGRX;
  RGB and RGBX for type 3); types 0, 1, 3, 4 and 5 raw, type 2 Pillow's
  run-length code (0x80 n v: n + 1 copies of v; 0x80 0: one 0x80; runs
  cross rows, and rows are not padded). A colour map at depth 1, 24 or 32
  (Pillow's "unrecognized image mode"), another map type, another depth
  or type, or pixel data cut short is refused.
* OpenCV (``IMREAD_COLOR``, always (H, W, 3) uint8): depths 1 (bit 1
  white), 8 (grey) and, with a colour map of type 1 no longer than 3 x
  2^depth, its colours (entries past the map black); 24 (BGR) and 32 (a
  pad byte, then BGR); types 0 and 1 alone (OpenCV refuses the run-length
  type 2 and RGB type 3). Depth 4, a map at depth 24 or 32, a map of
  another type, or pixel data cut short is refused.

As elsewhere in ``viz/image_files.py``, a 2-D result is (H, W, 1) and a
bitmap is 0 and 255 in uint8.
"""
from __future__ import annotations

import struct

import numpy as np

from .pixels import check_pixels

SUN_MAGIC = b"\x59\xa6\x6a\x95"
# OpenCV's validateInputImageSize
_CV_MAX_SIDE, _CV_MAX_PIXELS = 1 << 20, 1 << 30


def _fail(path: str, what: str):
    raise ValueError(f"{path}: Sun raster: {what}")


def _header(data: bytes, path: str):
    if len(data) < 32 or not data.startswith(SUN_MAGIC):
        _fail(path, "the 32-byte header is cut short")
    return struct.unpack(">8I", data[:32])


def _rows(data: bytes, pos: int, W: int, H: int, depth: int, path: str):
    """(H, stride) uint8: the rows, each padded to 16 bits."""
    stride = (W * depth + 15) // 16 * 2
    if pos + stride * H > len(data):
        _fail(path, f"the pixel data ends after {len(data) - pos} of its "
                    f"{stride * H} bytes")
    return np.frombuffer(data, np.uint8, stride * H, pos).reshape(H, stride)


def _palette(cmap: bytes) -> np.ndarray:
    """A colour map (its reds, greens, blues in turn) as (256, 3) uint8,
    the entries past it black."""
    n = len(cmap) // 3
    lut = np.zeros((256, 3), np.uint8)
    lut[:n] = np.frombuffer(cmap, np.uint8, 3 * n).reshape(3, n).T
    return lut


def _unrle(data: bytes, pos: int, need: int, path: str) -> np.ndarray:
    """Pillow's SunRleDecode: ``need`` bytes from the run-length code."""
    out = bytearray()
    n = len(data)
    while len(out) < need:
        if pos >= n:
            _fail(path, "the run-length data ends early (Pillow: image "
                        "file is truncated)")
        c = data[pos]
        if c != 0x80:
            out.append(c)
            pos += 1
        elif pos + 1 < n and data[pos + 1] == 0:
            out.append(0x80)
            pos += 2
        elif pos + 2 < n:
            out += bytes([data[pos + 2]]) * (data[pos + 1] + 1)
            pos += 3
        else:
            _fail(path, "the run-length data ends early (Pillow: image "
                        "file is truncated)")
    return np.frombuffer(bytes(out[:need]), np.uint8)


def decode_sun_pillow(data: bytes, path: str = "") -> np.ndarray:
    """A Sun raster file as Pillow reads it and imageio gives it (see the
    module docstring): (H, W, 1) uint8 grey or bitmap, or (H, W, 3) uint8
    RGB (a colour map's colours)."""
    _, W, H, depth, _, kind, map_type, map_len = _header(data, path)
    if depth not in (1, 4, 8, 24, 32):
        _fail(path, f"depth {depth} (Pillow: Unsupported Mode/Bit Depth)")
    pos, lut = 32, None
    if map_len:
        if map_len > 1024:
            _fail(path, f"a colour map of {map_len} bytes (Pillow: "
                        "Unsupported Color Palette Length)")
        if map_type != 1:
            _fail(path, f"colour map type {map_type} (Pillow: Unsupported "
                        "Palette Type)")
        if depth not in (4, 8):
            _fail(path, f"a colour map at depth {depth} (Pillow makes no "
                        "image of it: unrecognized image mode)")
        lut = _palette(data[32:32 + map_len])
        pos += map_len
    if kind not in (0, 1, 2, 3, 4, 5):
        _fail(path, f"type {kind} (Pillow: Unsupported Sun Raster file "
                    "type)")
    if W == 0 or H == 0:
        _fail(path, f"an image of {W} x {H} pixels")
    check_pixels(W, H, path, "Sun raster")
    if kind == 2:       # unpadded rows of the run-length code
        row = (W * depth + 7) // 8
        rows = _unrle(data, pos, row * H, path).reshape(H, row)
    else:
        rows = _rows(data, pos, W, H, depth, path)
    if depth >= 24:
        n = depth // 8
        px = rows[:, :W * n].reshape(H, W, n)
        order = [0, 1, 2] if kind == 3 else [2, 1, 0]
        return np.ascontiguousarray(px[..., order])
    bits = np.unpackbits(rows, axis=1)[:, :W * depth].reshape(H, W, depth)
    v = (bits * (1 << np.arange(depth - 1, -1, -1))).sum(-1).astype(np.uint8)
    if depth == 1:
        return (np.uint8(255) * (v == 0))[..., None]
    if lut is not None:
        return lut[v]
    return (v * np.uint8(17) if depth == 4 else v)[..., None]


def decode_sun_opencv(data: bytes, path: str = "") -> np.ndarray:
    """A Sun raster file as OpenCV reads it for ``IMREAD_COLOR`` and
    imageio gives it (see the module docstring): (H, W, 3) uint8 RGB."""
    words = _header(data, path)
    W, H, depth, _, kind, map_type, map_len = struct.unpack(
        ">7i", data[4:32])
    if W <= 0 or H <= 0 or depth not in (1, 8, 24, 32):
        _fail(path, f"{W} x {H} pixels at depth {words[3]}; OpenCV reads "
                    "depths 1, 8, 24 and 32")
    if kind not in (0, 1):
        _fail(path, f"type {words[5]}; OpenCV reads types 0 and 1 (not the "
                    "run-length type 2 or the RGB type 3)")
    if not (map_type == 0 and map_len == 0 or map_type == 1 and depth <= 8
            and 0 < map_len <= 3 << depth):
        _fail(path, f"colour map type {words[6]} of {words[7]} bytes at "
                    f"depth {depth}; OpenCV reads none, or type 1 of at "
                    "most 3 x 2^depth bytes at depth 8 or less")
    if W > _CV_MAX_SIDE or H > _CV_MAX_SIDE or W * H > _CV_MAX_PIXELS:
        _fail(path, f"an image of {W} x {H} pixels, past OpenCV's limits")
    if 32 + map_len > len(data):
        _fail(path, "the colour map is cut short")
    rows = _rows(data, 32 + map_len, W, H, depth, path)
    if depth >= 24:
        n = depth // 8
        px = rows[:, :W * n].reshape(H, W, n)
        order = [2, 1, 0] if n == 3 else [3, 2, 1]
        return np.ascontiguousarray(px[..., order])
    if map_len:
        lut = _palette(data[32:32 + map_len])
    elif depth == 1:
        lut = np.zeros((256, 3), np.uint8)
        lut[1] = 255
    else:
        lut = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    if depth == 1:
        return lut[np.unpackbits(rows, axis=1)[:, :W]]
    return lut[rows[:, :W]]
