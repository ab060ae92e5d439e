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
* PNM: imageio tries Pillow's ``PpmImagePlugin`` and OpenCV in the order
  that ``image_files.imageio_route`` gives for the file's name, and each
  takes the magics it knows (``image_files.opencv_reads``):

  - OpenCV, first for ``.pbm``, ``.pfm``, ``.hdr`` and the other names of
    its route, reads P1-P6 (:func:`pxm_opencv`, its PxM decoder,
    ``IMREAD_COLOR``: always (H, W, 3) uint8, grey replicated, raw 8-bit
    samples unscaled whatever the maxval, 16-bit ones cut to their high
    byte, plain ones clamped to the maxval and scaled to v * 255 // maxval,
    a bitmap as 0 and 255), ``Pf``/``PF`` (:func:`pfm_opencv`, its PFM
    decoder: times float32(1 / |scale|), rounded half to even and
    saturated to uint8, NaN, infinities and values past the int range as
    0; grey as one channel) and ``P7`` (:func:`pam_opencv`, its PAM
    decoder: depth 1 grey and depth 3 colour as (H, W, 3) uint8, the
    colour samples reversed; depths 2 and 4 raise);
  - Pillow, first for every other name, reads P1-P6, ASCII or binary,
    with comments; a bitmap as bool; a maxval other than 255 rescaled to
    255 (or, for grey past 8 bits, to 65535 as int32, Pillow's mode "I"),
    rounded half to even; ``Pf`` as float32, bottom row first;
  - Pillow's extensions ``P0CMYK`` and ``PyCMYK`` (4 bands, made RGB by
    Pillow's formula, the rule of every CMYK texture) and ``PyRGBA``,
    which OpenCV does not know, go to Pillow whatever the name; ``PyP``
    raises (imageio raises ``AttributeError`` on its palette image);
    ``PF`` and ``P7``, which Pillow does not know, go to OpenCV whatever
    the name.

A PSD file raises: imageio's Pillow plugin seeks frame 0 of every image,
and Pillow's PSD reader numbers its frames from 1, so imageio reads no
PSD file (the JAX function raises ``EOFError`` on one).

As elsewhere in ``viz/image_files.py``, the samples are imageio's, except
that a 2-D result is (H, W, 1) and a bool bitmap is 0 and 255 in uint8.
"""
from __future__ import annotations

import math
import re
import struct

import numpy as np

from ..data import native
from .pixels import check_pixels
from .tiff import cmyk_to_rgb

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
              b"P6": "RGB", b"Pf": "F", b"P0CMYK": "CMYK",
              b"PyCMYK": "CMYK", b"PyRGBA": "RGBA", b"PyP": "P"}
_PNM_BANDS = {"L": 1, "RGB": 3, "CMYK": 4, "RGBA": 4}


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
    h = _Header(data, path)
    magic = h.magic()
    mode = _PNM_MODES.get(magic)
    if mode is None:
        _fail(path, f"PNM: magic {magic!r} is not one that Pillow reads")
    if mode == "P":
        _fail(path, "PNM: Pillow's PyP palette file, on which imageio raises "
                    "AttributeError")
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
    bands = _PNM_BANDS.get(mode, 1)
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
    v = v.astype(np.int32 if wide else np.uint8).reshape(H, W, bands)
    return cmyk_to_rgb(v) if mode == "CMYK" else v


# OpenCV's default limits on a decoded image (CV_IO_MAX_IMAGE_WIDTH,
# _HEIGHT and _PIXELS), which imread checks before it decodes
_CV_MAX_SIDE, _CV_MAX_PIXELS = 1 << 20, 1 << 30


class _CvStream:
    """OpenCV's RLByteStream over the file's bytes: a read past the end
    raises, as OpenCV's "Unexpected end of input stream" does."""

    def __init__(self, data: bytes, path: str):
        self.data, self.path, self.pos = data, path, 0

    def byte(self) -> int:
        if self.pos >= len(self.data):
            _fail(self.path, "PNM: OpenCV reads past the end of the file")
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> np.ndarray:
        if self.pos + n > len(self.data):
            _fail(self.path, "PNM: pixel data truncated (OpenCV reads past "
                             "the end of the file)")
        self.pos += n
        return np.frombuffer(self.data, np.uint8, n, self.pos - n)

    def number(self, maxdigits: int = 0) -> int:
        """grfmt_pxm.cpp's ReadNumber: whitespace and ``#`` comments (to CR
        or LF) skipped, any other non-digit an error; then the digits, at
        most ``maxdigits`` of them, and the byte after them read too."""
        c = self.byte()
        while not 48 <= c <= 57:
            if c == 35:                     # '#'
                while c not in (10, 13):
                    c = self.byte()
                c = self.byte()
            elif c in _WHITESPACE:
                while c in _WHITESPACE:
                    c = self.byte()
            else:
                _fail(self.path, f"PNM: OpenCV meets byte {c:#x} where a "
                                 "number belongs")
        val, digits = 0, 0
        while True:
            val = val * 10 + c - 48
            if val > 2 ** 31 - 1:
                _fail(self.path, "PNM: a number past OpenCV's int")
            digits += 1
            if maxdigits and digits >= maxdigits:
                return val
            c = self.byte()
            if not 48 <= c <= 57:
                return val

    def token(self) -> bytes:
        """grfmt_pfm.cpp's read_number: the bytes up to the next whitespace
        (which is read too), at most 2048."""
        out = bytearray()
        while len(out) < 2048:
            c = self.byte()
            if c in _WHITESPACE:
                break
            out.append(c)
        return bytes(out)


def _cv_size(W: int, H: int, path: str) -> None:
    if not (0 < W <= _CV_MAX_SIDE and 0 < H <= _CV_MAX_SIDE
            and W * H <= _CV_MAX_PIXELS):
        _fail(path, f"PNM: an image of {W} x {H} pixels, past OpenCV's "
                    "limits")


def _atoi(token: bytes) -> int:
    m = re.match(rb"[ \t\n\x0b\x0c\r]*([+-]?\d+)", token)
    return int(m.group(1)) if m else 0


def _atof(token: bytes) -> float:
    m = re.match(rb"[ \t\n\x0b\x0c\r]*([+-]?(?:inf(?:inity)?|nan|"
                 rb"(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?))", token,
                 re.IGNORECASE)
    return float(m.group(1)) if m else 0.0


def pfm_opencv(data: bytes, path: str) -> np.ndarray:
    """A ``Pf`` or ``PF`` float map as OpenCV's PFM decoder and imageio
    give it: the magic, then a line feed; width, height and scale each up
    to the next whitespace (C's ``atoi`` and ``atof``); the rows bottom
    first, little-endian where the scale is negative; times float32(1 /
    |scale|), rounded half to even and saturated to uint8 (NaN, infinities
    and values past the int range as 0); grey as one channel."""
    st = _CvStream(data, path)
    ch = 3 if data[1:2] == b"F" else 1
    st.pos = 2
    if st.byte() != 10:
        _fail(path, "PFM: OpenCV wants a line feed after the magic")
    W, H = _atoi(st.token()), _atoi(st.token())
    scale = _atof(st.token())
    _cv_size(W, H, path)
    if not abs(scale) > 0:
        _fail(path, "PFM: a scale of 0 or NaN (OpenCV's assertion)")
    v = st.take(4 * W * H * ch).view("<f4" if scale < 0 else ">f4")
    a = np.float32(1.0 / abs(scale))
    with np.errstate(invalid="ignore", over="ignore"):
        r = np.rint((v.astype(np.float32) * a).astype(np.float64))
        ok = np.isfinite(r) & (np.abs(r) < 2 ** 31)
    out = np.where(ok, np.clip(np.where(ok, r, 0), 0, 255), 0)
    return out.astype(np.uint8).reshape(H, W, ch)[::-1].copy()


def pxm_opencv(data: bytes, path: str) -> np.ndarray:
    """P1-P6 as OpenCV's PxM decoder reads them for ``IMREAD_COLOR`` and
    imageio gives them: always (H, W, 3) uint8, grey replicated and RGB as
    stored. Raw 8-bit samples as they are, whatever the maxval; raw 16-bit
    ones (maxval past 255), big-endian, their high byte; plain samples
    clamped to the maxval, then 8-bit ones scaled to v * 255 // maxval and
    16-bit ones their high byte; a bitmap's 1 black and 0 white (plain:
    one digit a pixel, any nonzero digit black)."""
    st = _CvStream(data, path)
    code = data[1] - 48
    st.pos = 2
    bitmap, colour, binary = code in (1, 4), code in (3, 6), code >= 4
    W, H = st.number(), st.number()
    maxval = 1 if bitmap else st.number()
    if not 0 < maxval < 65536:
        _fail(path, f"PNM: maxval {maxval}, not in 1-65535 (OpenCV)")
    _cv_size(W, H, path)
    if bitmap:
        if binary:
            rows = st.take(H * ((W + 7) // 8)).reshape(H, -1)
            bits = np.unpackbits(rows, axis=1)[:, :W]
        else:
            bits = np.array([st.number(1) != 0 for _ in range(W * H)],
                            np.uint8).reshape(H, W)
        return np.repeat((np.uint8(255) * (bits == 0))[..., None], 3, -1)
    n = W * H * (3 if colour else 1)
    wide = maxval > 255
    if binary:
        v = st.take(n * (2 if wide else 1))
        v = (v.view(">u2") >> 8).astype(np.uint8) if wide else v
    else:
        v = np.minimum(np.array([st.number() for _ in range(n)], np.int64),
                       maxval)
        v = (v >> 8 if wide else v * 255 // maxval).astype(np.uint8)
    v = v.reshape(H, W, 3 if colour else 1)
    return np.ascontiguousarray(v if colour else np.repeat(v, 3, -1))


_PAM_FIELDS = (b"ENDHDR", b"HEIGHT", b"WIDTH", b"DEPTH", b"MAXVAL",
               b"TUPLTYPE")
# TUPLTYPE -> the samples a pixel it needs; "" where the header has none
_PAM_TUPLES = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2,
               b"RGB": 3, b"RGB_ALPHA": 4}


def _pam_line(st: _CvStream):
    """grfmt_pam.cpp's ReadPAMHeaderLine: (field, value), (None, None) for
    a comment; whitespace (blank lines too) skipped first; a field name of
    at most 8 bytes, then its value to the end of the line, trailing
    whitespace cut."""
    c = st.byte()
    while c in _WHITESPACE:
        c = st.byte()
    if c == 35:                                 # '#': to the line's end
        while c not in (10, 13):
            c = st.byte()
        return None, None
    name = bytearray()
    while c not in _WHITESPACE:
        if len(name) == 8:
            _fail(st.path, "PAM: a header field name past 8 bytes")
        name.append(c)
        c = st.byte()
    if bytes(name) not in _PAM_FIELDS:
        _fail(st.path, f"PAM: an unknown header field {bytes(name)!r}")
    if c in (10, 13):
        return bytes(name), b""
    while c in _WHITESPACE:
        c = st.byte()
    value = bytearray()
    while c not in (10, 13):
        if len(value) == 255:
            _fail(st.path, "PAM: a header value past 255 bytes")
        value.append(c)
        c = st.byte()
    return bytes(name), bytes(value).rstrip(_WHITESPACE)


def _pam_number(value: bytes, path: str) -> int:
    """A header value as OpenCV's ParseNumber reads it: C's ``strtol`` of
    base 10 that must take the whole value."""
    m = re.fullmatch(rb"[ \t\n\x0b\x0c\r]*([+-]?\d+)", value)
    if not m:
        _fail(path, f"PAM: header value {value!r} is not a number")
    return int(m.group(1))


def pam_opencv(data: bytes, path: str) -> np.ndarray:
    """A PAM (P7) file as OpenCV's PAM decoder reads it for
    ``IMREAD_COLOR`` and imageio gives it, whatever its name: (H, W, 3)
    uint8. The header: ``P7`` and a line end, then WIDTH, HEIGHT, DEPTH
    and MAXVAL once each (decimal), TUPLTYPE, comments, ENDHDR. A
    tuple type must match the depth; without one, depth 1 is grey (black
    and white at maxval 1) and depth 3 RGB below maxval 256. Samples as
    stored, whatever the maxval (16-bit ones, big-endian, their high
    byte); grey replicated; three samples reversed (OpenCV reads them as
    BGR, and imageio turns BGR to RGB); at maxval 1 each row of W x DEPTH
    bytes holds W bits, most significant first, 1 white and 0 black. Depths
    2 and 4 raise: OpenCV's conversion of them leaves part of its image
    unset, so imageio's pixels are not determined by the file."""
    st = _CvStream(data, path)
    st.pos = 2
    if st.byte() not in (10, 13):
        _fail(path, "PAM: OpenCV wants a line end after P7")
    fields, tuple_type = {}, b""
    while True:
        name, value = _pam_line(st)
        if name is None:
            continue
        if name == b"ENDHDR":
            break
        if name == b"TUPLTYPE":
            if value not in _PAM_TUPLES:
                _fail(path, f"PAM: tuple type {value!r} is not one that "
                            "OpenCV reads")
            tuple_type = value
            continue
        if name in fields:
            _fail(path, f"PAM: header field {name.decode()} twice")
        fields[name] = _pam_number(value, path)
    if len(fields) < 4:
        _fail(path, "PAM: the header lacks "
                    + ", ".join(f.decode() for f in _PAM_FIELDS[1:5]
                                if f not in fields))
    W, H = fields[b"WIDTH"], fields[b"HEIGHT"]
    depth, maxval = fields[b"DEPTH"], fields[b"MAXVAL"]
    if maxval > 65535:
        _fail(path, f"PAM: maxval {maxval}, past 65535")
    if not tuple_type:
        if depth in (1, 3) and maxval < 256:
            tuple_type = b"GRAYSCALE" if depth == 1 else b"RGB"
        else:
            _fail(path, f"PAM: depth {depth} at maxval {maxval} without a "
                        "tuple type (OpenCV cannot tell the format)")
    if _PAM_TUPLES[tuple_type] != depth:
        _fail(path, f"PAM: tuple type {tuple_type.decode()} with depth "
                    f"{depth}")
    if depth in (2, 4):
        _fail(path, f"PAM: depth {depth}; OpenCV's colour conversion of it "
                    "leaves part of the image unset, so imageio's pixels "
                    "are not determined by the file")
    _cv_size(W, H, path)
    wide = maxval > 255
    rows = st.take(H * W * depth * (2 if wide else 1)).reshape(H, -1)
    if maxval == 1:
        bits = np.unpackbits(rows, axis=1)[:, :W]
        return np.repeat((bits * np.uint8(255))[..., None], 3, -1)
    v = (rows.view(">u2") >> 8).astype(np.uint8) if wide else rows
    v = v.reshape(H, W, depth)
    return np.ascontiguousarray(np.repeat(v, 3, -1) if depth == 1
                                else v[..., ::-1])


def decode_pnm(data: bytes, path: str = "") -> np.ndarray:
    """A PBM, PGM, PPM, float map or Pillow extension file as Pillow reads
    it (see the module docstring): (H, W, C) uint8, int32 (Pillow's grey
    past 8 bits) or float32 (its float map). The files that imageio hands
    to OpenCV (by name, or ``PF`` and ``P7`` whatever the name) are read by
    :func:`pxm_opencv`, :func:`pfm_opencv` and :func:`pam_opencv` through
    ``viz/opencv_read.py``."""
    return _pnm_pillow(data, path)
