"""DDS, QOI and PNM textures, read as imageio reads them for the JAX
package's ``apps/retarget._find_texture``; and PSD, which imageio does not
read.

* DDS (Pillow's ``DdsImagePlugin``): the top level of the first surface
  of any DDS Pillow opens (a cube map's first face, an array's first
  element, a volume's first slice, as Pillow reads them): uncompressed
  masks (RGB, RGBA, luminance, luminance + alpha, 8-bit palette), the DX10
  header's 8-bit RGBA UNORM (and SRGB) and the BC1-BC7 blocks, which the
  host library ``csrc/nm_dds.cpp`` decodes as Pillow's ``BcnDecode.c``
  does;
* QOI (Pillow's ``QoiImagePlugin``): every op, 3 or 4 channels, the
  colour space byte ignored; the ops run in ``csrc/nm_host.cpp``;
* PNM: what imageio gives depends on the file's name. A ``.pbm`` or
  ``.pfm`` file goes to imageio's OpenCV plugin (OpenCV reads these ahead
  of Pillow in imageio's order): a bitmap as (H, W, 3) of 0 and 255, a
  float map (``Pf`` grey, ``PF`` colour, either byte order) divided by
  the magnitude of its scale, rounded half to even and saturated to uint8
  (NaN, infinities and values past the int range as 0). Every other name
  goes to Pillow's ``PpmImagePlugin``: P1-P6, ASCII or binary, with
  comments; a bitmap as bool; a maxval other than 255 rescaled to 255 (or,
  for grey past 8 bits, to 65535 as int32, Pillow's mode "I"), rounded
  half to even; ``Pf`` as float32, bottom row first.

A PSD file raises: imageio's Pillow plugin seeks frame 0 of every image,
and Pillow's PSD reader numbers its frames from 1, so imageio reads no
PSD file (the JAX function raises ``EOFError`` on one).

As elsewhere in ``viz/image_files.py``, the samples are imageio's, except
that a 2-D result is (H, W, 1) and a bool bitmap is 0 and 255 in uint8.
"""
from __future__ import annotations

import math
import struct

import numpy as np

from ..data import native

# ------------------------------------------------------------------- DDS
_DDPF_ALPHAPIXELS, _DDPF_FOURCC, _DDPF_PALETTE8 = 0x1, 0x4, 0x20
_DDPF_RGB, _DDPF_LUMINANCE = 0x40, 0x20000
# FourCC -> (BCn format, signed)
_FOURCC = {b"DXT1": ("BC1", False), b"DXT3": ("BC2", False),
           b"DXT5": ("BC3", False), b"BC4U": ("BC4", False),
           b"ATI1": ("BC4", False), b"BC5S": ("BC5", True),
           b"BC5U": ("BC5", False), b"ATI2": ("BC5", False)}
# the DX10 header's DXGI formats Pillow reads -> (BCn format, signed), or
# None for 8-bit RGBA
_DXGI = {70: ("BC1", False), 71: ("BC1", False), 73: ("BC2", False),
         74: ("BC2", False), 76: ("BC3", False), 77: ("BC3", False),
         79: ("BC4", False), 80: ("BC4", False), 82: ("BC5", False),
         83: ("BC5", False), 84: ("BC5", True), 95: ("BC6H", False),
         96: ("BC6H", True), 97: ("BC7", False), 98: ("BC7", False),
         99: ("BC7", False), 27: None, 28: None, 29: None}


def _fail(path: str, what: str):
    raise ValueError(f"{path}: {what}")


def _mask_channel(px: np.ndarray, mask: int) -> np.ndarray:
    """Pillow's DdsRgbDecoder: a mask's field, its trailing zeros shifted
    out, over the field's largest value, times 255, truncated."""
    if mask == 0:
        return np.zeros(px.shape, np.uint8)
    shift = (mask & -mask).bit_length() - 1
    total = mask >> shift
    return ((((px & mask) >> shift) / total) * 255).astype(np.uint8)


def decode_dds(data: bytes, path: str = "") -> np.ndarray:
    """A DDS file's first surface as (H, W, C) uint8: C = 3 RGB, 4 RGBA, 1
    grey, 2 grey + alpha (see the module docstring)."""
    from .image_files import check_pixels   # image_files imports this
    if len(data) < 128 or data[:4] != b"DDS " or \
            struct.unpack_from("<I", data, 4)[0] != 124:
        _fail(path, "DDS: not a DDS file with a 124-byte header")
    height, width = struct.unpack_from("<II", data, 12)
    pfflags, fourcc, bits = struct.unpack_from("<I4sI", data, 80)
    if not width or not height:
        _fail(path, f"DDS: image of {width} x {height} pixels")
    check_pixels(width, height, path, "DDS")
    n = width * height
    if pfflags & _DDPF_RGB:
        masks = struct.unpack_from(
            "<4I" if pfflags & _DDPF_ALPHAPIXELS else "<3I", data, 92)
        step = bits // 8
        raw = np.frombuffer(data[128:128 + n * step], np.uint8)
        # pixels past the end of the file read as zeros, as Pillow's
        # decoder reads them
        raw = np.concatenate([raw, np.zeros(n * step - raw.size, np.uint8)])
        px = np.zeros(n, np.int64)
        for k in range(step):
            px |= raw[k::step].astype(np.int64) << (8 * k)
        return np.stack([_mask_channel(px, m) for m in masks],
                        -1).reshape(height, width, len(masks))
    if pfflags & _DDPF_LUMINANCE:
        if bits == 8:
            channels = 1
        elif bits == 16 and pfflags & _DDPF_ALPHAPIXELS:
            channels = 2
        else:
            _fail(path, f"DDS: luminance at {bits} bits (flags "
                        f"{pfflags:#x}) is not read (Pillow refuses it)")
        return _raw(data, 128, (height, width, channels), path)
    if pfflags & _DDPF_PALETTE8:
        if len(data) < 128 + 1024:
            _fail(path, "DDS: palette truncated")
        palette = np.frombuffer(data, np.uint8, 1024, 128).reshape(256, 4)
        return palette[_raw(data, 128 + 1024, (height, width), path)]
    if not pfflags & _DDPF_FOURCC:
        _fail(path, f"DDS: pixel format flags {pfflags:#x} are not read "
                    "(Pillow refuses them)")
    offset = 128
    if fourcc == b"DX10":
        if len(data) < 148:
            _fail(path, "DDS: DX10 header truncated")
        dxgi = struct.unpack_from("<I", data, 128)[0]
        if dxgi not in _DXGI:
            _fail(path, f"DDS: DXGI format {dxgi} is not read (Pillow "
                        "refuses it)")
        offset, kind = 148, _DXGI[dxgi]
        if kind is None:
            return _raw(data, offset, (height, width, 4), path)
    elif fourcc in _FOURCC:
        kind = _FOURCC[fourcc]
    else:
        _fail(path, f"DDS: pixel format {fourcc!r} is not read (Pillow "
                    "refuses it)")
    fmt, signed = kind
    try:
        return native.bcn_decode(data[offset:], fmt, signed, width, height)
    except ValueError as e:
        _fail(path, f"DDS: {e}")


def _raw(data: bytes, offset: int, shape, path: str) -> np.ndarray:
    n = int(np.prod(shape))
    if offset + n > len(data):
        _fail(path, "DDS: pixel data truncated")
    return np.frombuffer(data, np.uint8, n, offset).reshape(shape)


# ------------------------------------------------------------------- QOI
def decode_qoi(data: bytes, path: str = "") -> np.ndarray:
    """A QOI file as (H, W, 3) or (H, W, 4) uint8 (any channels byte but 3
    reads as RGBA, as Pillow reads it)."""
    from .image_files import check_pixels
    if len(data) < 14 or data[:4] != b"qoif":
        _fail(path, "QOI: not a QOI file")
    width, height = struct.unpack_from(">II", data, 4)
    if not width or not height:
        _fail(path, f"QOI: image of {width} x {height} pixels")
    check_pixels(width, height, path, "QOI")
    channels = 3 if data[12] == 3 else 4
    try:
        px = native.qoi_decode(data[14:], width * height, channels)
    except ValueError as e:
        _fail(path, str(e))
    return px.reshape(height, width, channels)


# ------------------------------------------------------------------- PNM
_WHITESPACE = b" \t\n\x0b\x0c\r"
_PNM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
              b"P6": "RGB", b"Pf": "F"}


class _Header:
    """Pillow's PpmImageFile header reader over the file's bytes."""

    def __init__(self, data: bytes, path: str):
        self.data, self.path, self.pos = data, path, 0

    def byte(self) -> bytes:
        c = self.data[self.pos:self.pos + 1]
        self.pos += len(c)
        return c

    def magic(self) -> bytes:
        magic = b""
        for _ in range(6):
            c = self.byte()
            if not c or c in _WHITESPACE:
                break
            magic += c
        return magic

    def token(self) -> bytes:
        token = b""
        while len(token) <= 10:
            c = self.byte()
            if not c:
                break
            if c in _WHITESPACE:
                if not token:
                    continue
                break
            if c == b"#":               # a comment, to CR, LF or the end
                while self.byte() not in b"\r\n":
                    pass
                continue
            token += c
        if not token:
            _fail(self.path, "PNM: the header ends early")
        if len(token) > 10:
            _fail(self.path, f"PNM: header token too long ({token[:11]!r})")
        return token

    def number(self, kind=int):
        tok = self.token()
        try:
            return kind(tok)
        except ValueError:
            _fail(self.path, f"PNM: bad header field {tok!r}")


def _plain_tokens(body: bytes) -> bytes:
    """Pillow's PpmPlainDecoder comment removal: from each ``#`` through
    the next CR or LF (which goes too), or to the end."""
    out, pos = bytearray(), 0
    while True:
        start = body.find(b"#", pos)
        if start < 0:
            return bytes(out + body[pos:])
        out += body[pos:start]
        ends = [e for e in (body.find(b"\n", start), body.find(b"\r", start))
                if e >= 0]
        if not ends:
            return bytes(out)
        pos = min(ends) + 1


def _pnm_pillow(data: bytes, path: str) -> np.ndarray:
    from .image_files import check_pixels
    h = _Header(data, path)
    magic = h.magic()
    mode = _PNM_MODES.get(magic)
    if mode is None:
        _fail(path, f"PNM: magic {magic!r} is not read (Pillow reads P1-P6 "
                    "and Pf, and its own test formats, which the port "
                    "leaves out)")
    W, H = h.number(), h.number()
    if W <= 0 or H <= 0:
        _fail(path, f"PNM: image of {W} x {H} pixels")
    check_pixels(W, H, path, "PNM")
    if mode == "F":
        scale = h.number(float)
        if scale == 0.0 or not math.isfinite(scale):
            _fail(path, "PNM: a float map's scale must be finite and "
                        "nonzero")
        need = 4 * W * H
        if h.pos + need > len(data):
            _fail(path, "PNM: pixel data truncated")
        v = np.frombuffer(data, "<f4" if scale < 0 else ">f4", W * H, h.pos)
        return v.astype(np.float32).reshape(H, W, 1)[::-1].copy()
    plain = magic in (b"P1", b"P2", b"P3")
    bands = 3 if mode == "RGB" else 1
    if mode == "1":
        if plain:
            digits = b"".join(_plain_tokens(data[h.pos:]).split())
            if digits.translate(None, b"01"):
                _fail(path, "PNM: a plain bitmap holds a digit other than "
                            "0 and 1")
            if len(digits) < W * H:
                _fail(path, "PNM: pixel data truncated")
            bits = np.frombuffer(digits, np.uint8, W * H) == ord("0")
        else:
            stride = (W + 7) // 8
            if h.pos + stride * H > len(data):
                _fail(path, "PNM: pixel data truncated")
            rows = np.frombuffer(data, np.uint8, stride * H, h.pos)
            bits = np.unpackbits(rows.reshape(H, stride),
                                 axis=1)[:, :W] == 0
        return (bits.reshape(H, W, 1) * np.uint8(255)).astype(np.uint8)
    maxval = h.number()
    if not 0 < maxval < 65536:
        _fail(path, f"PNM: maxval {maxval}, not in 1-65535")
    wide = mode == "L" and maxval > 255       # Pillow's mode "I"
    out_max = 65535 if wide else 255
    n = W * H * bands
    if plain:
        tokens = _plain_tokens(data[h.pos:]).split()[:n]
        if len(tokens) < n:
            _fail(path, "PNM: pixel data truncated")
        if any(len(t) > 10 for t in tokens):
            _fail(path, "PNM: a sample token too long")
        try:
            v = np.array([int(t) for t in tokens], np.int64)
        except ValueError:
            _fail(path, "PNM: a sample that is not a number")
        if (v < 0).any() or (v > maxval).any():
            _fail(path, f"PNM: a sample outside 0-{maxval}")
    else:
        size = 1 if maxval < 256 else 2
        if h.pos + n * size > len(data):
            _fail(path, "PNM: pixel data truncated")
        v = np.frombuffer(data, np.uint8 if size == 1 else ">u2", n,
                          h.pos).astype(np.int64)
    if not (maxval == 255 and not plain or maxval == 65535 and wide
            and not plain):
        v = np.minimum(out_max, np.round(v / maxval * out_max)).astype(
            np.int64)
    return v.astype(np.int32 if wide else np.uint8).reshape(H, W, bands)


def _pnm_opencv(data: bytes, path: str, ext: str) -> np.ndarray:
    """A ``.pbm`` bitmap or a ``.pfm`` float map as imageio's OpenCV plugin
    gives it."""
    from .image_files import check_pixels
    h = _Header(data, path)
    magic = h.magic()
    if ext == "pfm" and magic in (b"Pf", b"PF"):
        W, H, scale = h.number(), h.number(), h.number(float)
        if W <= 0 or H <= 0 or scale == 0.0 or not math.isfinite(scale):
            _fail(path, "PFM: bad header")
        check_pixels(W, H, path, "PFM")
        ch = 3 if magic == b"PF" else 1
        need = 4 * W * H * ch
        if h.pos + need > len(data):
            _fail(path, "PFM: pixel data truncated")
        v = np.frombuffer(data, "<f4" if scale < 0 else ">f4", W * H * ch,
                          h.pos).astype(np.float32)
        with np.errstate(invalid="ignore", over="ignore"):
            r = np.rint((v / np.float32(abs(scale))).astype(np.float64))
            ok = np.isfinite(r) & (np.abs(r) < 2 ** 31)
        out = np.where(ok, np.clip(np.where(ok, r, 0), 0, 255), 0)
        return out.astype(np.uint8).reshape(H, W, ch)[::-1].copy()
    if ext == "pbm" and magic in (b"P1", b"P4"):
        img = _pnm_pillow(data, path)     # 255 white, 0 black
        return np.repeat(img, 3, axis=-1)
    _fail(path, f"PNM: a {magic!r} file named .{ext}, which imageio hands "
                "to OpenCV, is not read")


def decode_pnm(data: bytes, path: str = "") -> np.ndarray:
    """A PBM, PGM, PPM or PFM file (see the module docstring): uint8,
    int32 (grey past 8 bits) or float32 (H, W, C)."""
    ext = path.lower().rsplit(".", 1)[-1] if "." in path else ""
    if ext in ("pbm", "pfm"):
        return _pnm_opencv(data, path, ext)
    return _pnm_pillow(data, path)
