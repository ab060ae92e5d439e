"""Radiance HDR (RGBE) textures, read as imageio reads them: no plugin but
OpenCV's opens one, so imageio hands it to OpenCV under every name
(``image_files.imageio_route``), and OpenCV's HdrDecoder reads it with its
copy of Bruce Walter's RGBE reader (``imgcodecs/src/rgbe.cpp``) for
``IMREAD_COLOR``.

* The header, a line at a time as C's ``fgets`` takes lines into 128
  bytes (a longer line is read as several): lines until one that is a lone
  line feed, of which one must be exactly ``FORMAT=32-bit_rle_rgbe``
  (``XYZE`` is not read: "missing FORMAT specifier"); every other line
  (``EXPOSURE``, ``GAMMA``, comments) is skipped and changes no pixel.
  Then one line ``-Y <height> +X <width>`` as ``sscanf`` matches it (no
  other orientation: "missing image size specifier"); the pixels start
  right after that line. A line feed never comes as CR LF.
* The pixels: ``height`` scanlines of ``width`` RGBE pixels. A scanline
  that starts 2, 2 and its width holds four run-length coded channels; a
  scanline that does not is flat, and so is the rest of the image; widths
  below 8 or past 0x7fff are flat throughout. The old run-length form
  (1, 1, 1, n) is not expanded: it is read as flat pixels, as OpenCV reads
  it. Data that ends early or a bad run refuses the file. The expansion
  runs in the host library (``csrc/nm_host.cpp``, ``nm_hdr_unrle``).
* Each pixel as float32: 0 where E is 0, else each of R, G, B times
  2^(E - 136); then OpenCV's ``convertTo(CV_8U, 255)``: times 255 in
  float32, rounded half to even, saturated to 0-255, a value past the
  int range 0 (its cvRound gives INT_MIN). (H, W, 3) uint8 RGB.
"""
from __future__ import annotations

import re

import numpy as np

from ..data import native

_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"
# sscanf(buf, "-Y %d +X %d"): literals, whitespace directives that match
# any run of whitespace (or none), and %d's own skip of leading whitespace
_SIZE = re.compile(rb"-Y[ \t\n\x0b\x0c\r]*([+-]?\d+)[ \t\n\x0b\x0c\r]*\+X"
                   rb"[ \t\n\x0b\x0c\r]*([+-]?\d+)")
# OpenCV's validateInputImageSize
_MAX_SIDE, _MAX_PIXELS = 1 << 20, 1 << 30


def _fail(path: str, what: str):
    raise ValueError(f"{path}: Radiance HDR: {what}")


def _fgets(data: bytes, pos: int):
    """C's fgets into a 128-byte buffer: (the line, the position after it),
    or (None, pos) at the end of the data."""
    if pos >= len(data):
        return None, pos
    end = data.find(b"\n", pos, pos + 127)
    end = pos + 127 if end < 0 else end + 1
    end = min(end, len(data))
    return data[pos:end], end


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32, as rgbe.cpp's rgbe2float:
    float32(2^(E - 136)) times each mantissa, 0 where E is 0."""
    e = rgbe[..., 3].astype(np.int64)
    scale = np.ldexp(np.float64(1.0), e - 136).astype(np.float32)
    out = rgbe[..., :3].astype(np.float32) * scale[..., None]
    out[e == 0] = 0
    return out


def decode_radiance(data: bytes, path: str = "") -> np.ndarray:
    """A Radiance HDR file as OpenCV reads it for ``IMREAD_COLOR`` and
    imageio gives it (see the module docstring): (H, W, 3) uint8 RGB.
    Raises ``ValueError`` with OpenCV's reason where it refuses the file."""
    pos, has_format = 0, False
    while True:
        line, pos = _fgets(data, pos)
        if line is None:
            _fail(path, "RGBE read error (the header ends early)")
        if line == b"\n":
            break
        has_format = has_format or line == _FORMAT
    if not has_format:
        _fail(path, "RGBE bad file format: missing FORMAT specifier (OpenCV "
                    "reads 32-bit_rle_rgbe alone, not XYZE)")
    line, pos = _fgets(data, pos)
    m = _SIZE.match(line or b"")
    if m is None:
        _fail(path, "RGBE bad file format: missing image size specifier "
                    "(OpenCV reads -Y <height> +X <width> alone)")
    H, W = int(m.group(1)), int(m.group(2))
    if W <= 0 or H <= 0:
        _fail(path, f"an image of {W} x {H} pixels")
    if W > _MAX_SIDE or H > _MAX_SIDE or W * H > _MAX_PIXELS:
        _fail(path, f"an image of {W} x {H} pixels, past OpenCV's limits")
    try:
        rgbe, _ = native.hdr_unrle(np.frombuffer(data, np.uint8)[pos:], W, H)
    except ValueError as e:
        _fail(path, str(e).removeprefix("Radiance HDR: "))
    # cvRound past the int range gives INT_MIN, which saturates to 0
    r = np.rint(rgbe_to_float(rgbe) * np.float32(255)).astype(np.float64)
    return np.where(r < 2 ** 31, np.clip(r, 0, 255), 0).astype(np.uint8)
