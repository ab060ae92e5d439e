"""TIFF textures: the first image of a TIFF file, read as the bundled
``tifffile`` of imageio (the JAX package's ``_find_texture``) reads it,
then made a texture under the port's stated rules.

What is read: classic TIFF in both byte orders and BigTIFF; strips and
tiles; ``PlanarConfiguration`` 1 and 2; ``ImageDepth`` above 1 (an SGI
volume, whose first plane is read, as the first page of several is); no
pixel cap (tifffile has none). Every (SampleFormat, BitsPerSample) pair of
tifffile's ``SAMPLE_DTYPES`` that it can unpack: unsigned 1 (bool), 2, 4,
8, 16, 32 and 64 bits; packed RGB 5-6-5; signed 8, 16, 32 and 64 bits;
float 16, 32 and 64 bits; complex 64 and 128 bits. Every photometric
interpretation, tifffile reading the samples whatever it says. Compression
none, LZW, Deflate (8 and 32946), PackBits and LZMA; predictor 2 at every
depth and format (tifffile's ``cumsum`` in the samples' own type: sums
wrap at the container's width, bits OR together) and predictor 3 on float
samples in strips or in tiles that tifffile reads as one block; any other
predictor value ignored, as tifffile ignores it; fill order 2.

What is refused, with a ``ValueError`` that names it, is what tifffile
refuses: the compressions it cannot decompress (JPEG, CCITT, SGI LogLuv
and the others), old-style LZW, a ``YCbCrSubSampling`` other than (1, 1)
(any photometric), sample formats 4 and 5 and every pair its table lacks
(float 24, complex 32, unsigned 64 past its table), mixed sample formats
or depths (but 5-6-5), depths its unpacker cannot split (3, 5, 6, 7, 9-15
and 17-31 bits), planar 5-6-5, predictor 3 on integer or complex samples
and in tiles it reads one by one.

The samples come out as tifffile unpacks them, and :func:`decode_tiff`
then returns the first plane of the first page as (H, W, C) (planar data
transposed) under these rules:

* palette: unsigned indices of at most 16 bits through the colour map
  (uint16, as stored; indices past it black); without a full colour map,
  or with other indices, the indices as grey;
* min-is-white: inverted (an unsigned d-bit v to 2^d - 1 - v, a signed
  sample's bits flipped, a float x to 1 - x), then grey;
* min-is-black: the first sample grey, a second kept;
* CMYK (ink set 1, four samples or more): the inks made 8-bit (below),
  then RGB as Pillow's ``Image.convert("RGB")``; YCbCr (three samples or
  more): made 8-bit, then RGB as libtiff's ``TIFFYCbCrToRGB`` (what
  Pillow gives) under the file's ``YCbCrCoefficients`` and
  ``ReferenceBlackWhite``;
* CIELab, ICCLab and ITULab (8- and 16-bit integer samples): L*, a*, b*
  as each encodes them, then sRGB by :func:`lab_to_rgb` (uint8; fewer than
  three samples: L* alone);
* every other case (RGB; CMYK with another ink set or fewer samples;
  transparency mask, CFA, LogL, LogLuv, linear raw and codes TIFF does not
  define; Lab at other depths): the samples as they are, three or more as
  RGB (a fourth kept), fewer as grey (a second kept).

Then each sample is given a type that states its scale: 1-, 2- and 4-bit
samples scaled to 8 bits (uint8; a value past 2^d - 1, which predictor 2
can give, saturated); 8- and 16-bit unsigned, int8 and int16 as they are;
32- and 64-bit integers normalised to float32 by
``image_files.unit_interval`` (a d-bit unsigned v to v / (2^d - 1), a
signed one offset by 2^(d-1) first); floats as float32; complex samples'
real parts as float32. Made 8-bit for CMYK and YCbCr: 1, 2 and 4 bits
scaled, wider unsigned samples their high byte, signed ones offset first,
floats as ``image_files.to_uint8``.
The LZW and PackBits expansions run in the port's host library; Deflate
in ``zlib`` and LZMA in ``lzma``; each strip or tile is expanded to at
most its own size before the image is laid out.
"""
from __future__ import annotations

import lzma
import struct
import zlib

import numpy as np

from ..data import native

# tag codes read
_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_FILLORDER, _STRIP_OFFSETS, _SAMPLES, _ROWS_PER_STRIP = 266, 273, 277, 278
_STRIP_COUNTS, _PLANAR, _PREDICTOR, _COLORMAP = 279, 284, 317, 320
_TILE_WIDTH, _TILE_LENGTH, _TILE_OFFSETS, _TILE_COUNTS = 322, 323, 324, 325
_INKSET, _EXTRA, _SAMPLE_FORMAT, _DECODE = 332, 338, 339, 433
_YCBCR_COEFFICIENTS, _YCBCR_SUBSAMPLING, _REFERENCE_BLACK_WHITE = 529, 530, 532
_IMAGE_DEPTH, _TILE_DEPTH = 32997, 32998
_INTEGER_TAGS = {_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC,
                 _FILLORDER, _STRIP_OFFSETS, _SAMPLES, _ROWS_PER_STRIP,
                 _STRIP_COUNTS, _PLANAR, _PREDICTOR, _COLORMAP, _TILE_WIDTH,
                 _TILE_LENGTH, _TILE_OFFSETS, _TILE_COUNTS, _INKSET,
                 _SAMPLE_FORMAT, _YCBCR_SUBSAMPLING, _IMAGE_DEPTH,
                 _TILE_DEPTH}

# field type -> (struct code, size)
_TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4), 5: ("2I", 8),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4),
          10: ("2i", 8), 11: ("f", 4), 12: ("d", 8), 13: ("I", 4),
          16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}

# compressions tifffile decompresses without imagecodecs
_READ_COMPRESSION = (1, 5, 8, 32773, 32946, 34925)
_COMPRESSION_NAMES = {
    2: "CCITT RLE", 3: "CCITT Group 3 fax", 4: "CCITT Group 4 fax",
    6: "old-style JPEG", 7: "JPEG", 9: "JBIG (T.85)", 10: "JBIG (T.43)",
    32766: "NeXT", 32771: "CCITT RLEW", 32809: "ThunderScan",
    32895: "IT8 CT padding", 32896: "IT8 line work", 32897: "IT8 monochrome",
    32898: "IT8 binary line art", 32908: "Pixar film", 32909: "Pixar log",
    32947: "Kodak DCS", 34661: "JBIG", 34676: "SGI LogLuv",
    34677: "SGI LogLuv 24", 34712: "JPEG 2000", 34887: "LERC",
    34926: "Zstandard", 34927: "WebP", 50000: "Zstandard", 50001: "WebP",
    52546: "JPEG XL"}
# tifffile's SAMPLE_DTYPES: (SampleFormat, BitsPerSample) -> numpy type
_SAMPLE_DTYPES = {(1, 1): "?", **{(1, b): "B" for b in range(2, 9)},
                  **{(1, b): "H" for b in range(9, 17)},
                  **{(1, b): "I" for b in range(17, 33)}, (1, 64): "Q",
                  (2, 8): "b", (2, 16): "h", (2, 32): "i", (2, 64): "q",
                  (3, 16): "e", (3, 32): "f", (3, 64): "d", (6, 64): "F",
                  (6, 128): "D", (1, (5, 6, 5)): "B"}
# the depths tifffile's unpacker splits (its unpack_ints and frombuffer)
_UNPACKED = (1, 2, 4, 8, 16, 32, 64, 128)
_LAB = (8, 9, 10)           # CIELab, ICCLab, ITULab
# ITULab's default Decode ranges: L*, a*, b* (RFC 2301, section 6.2)
_ITULAB_DECODE = (0.0, 100.0, -85.0, 85.0, -75.0, 125.0)
_REVERSED_BITS = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                          np.uint8)
# the largest output of one input byte: an LZW code (9 bits at least)
# names a string of at most 4096 bytes; a PackBits pair repeats 128
_GROWTH = {5: 8 * 4096 // 9 + 1, 32773: 64}


def _fail(path: str, what: str):
    raise ValueError(f"{path}: TIFF: {what}")


# the tags without which libtiff's TIFFReadDirectory fails where their
# values cannot be read (the others it ignores, "tag ignored")
_LIBTIFF_NEEDS = {_WIDTH, _LENGTH, _BITS, _COMPRESSION, _SAMPLES,
                  _ROWS_PER_STRIP, _PLANAR, _TILE_WIDTH, _TILE_LENGTH, _EXTRA,
                  _SAMPLE_FORMAT, _IMAGE_DEPTH, _TILE_DEPTH, _STRIP_OFFSETS,
                  _TILE_OFFSETS}


# the field types libtiff reads an integer tag from, and the tags it reads
# one value of
_LIBTIFF_INTEGER_TYPES = (1, 3, 4, 6, 8, 9, 13, 16, 17, 18)
_LIBTIFF_ARRAYS = {_STRIP_OFFSETS, _STRIP_COUNTS, _TILE_OFFSETS, _TILE_COUNTS}
_LIBTIFF_SCALAR = {_WIDTH, _LENGTH, _PHOTOMETRIC, _FILLORDER, _SAMPLES,
                   _ROWS_PER_STRIP, _PREDICTOR, _TILE_WIDTH, _TILE_LENGTH,
                   _INKSET, _IMAGE_DEPTH, _TILE_DEPTH, 274}


class _Reader:
    """The header and the first IFD of a TIFF file. ``libtiff``: a tag
    whose values run past the end of the file, an integer tag of another
    field type, or one of the tags libtiff reads one value of with more
    or fewer, is dropped as libtiff's TIFFReadDirectory drops it ("tag
    ignored"), unless libtiff cannot do without it and fails
    (tifffile fails on the first two and reads the rest)."""

    def __init__(self, data: bytes, path: str, libtiff: bool = False):
        self.data, self.path, self.libtiff = data, path, libtiff
        if len(data) < 8 or data[:2] not in (b"II", b"MM"):
            _fail(path, "not a TIFF file")
        self.order = "<" if data[:2] == b"II" else ">"
        version = self.unpack("H", 2)[0]
        if version == 42:
            self.big, first = False, self.unpack("I", 4)[0]
        elif version == 43:
            if len(data) < 16 or self.unpack("HH", 4) != (8, 0):
                _fail(path, "bad BigTIFF header")
            self.big, first = True, self.unpack("Q", 8)[0]
        else:
            _fail(path, f"version {version} is not TIFF")
        self.tags = self.read_ifd(first)

    def unpack(self, fmt: str, pos: int):
        size = struct.calcsize(self.order + fmt)
        if pos < 0 or pos + size > len(self.data):
            _fail(self.path, "a field runs past the end of the file")
        return struct.unpack_from(self.order + fmt, self.data, pos)

    def read_ifd(self, pos: int) -> dict:
        n = self.unpack("Q" if self.big else "H", pos)[0]
        if n > 4096:
            _fail(self.path, f"suspicious number of tags ({n})")
        entry, inline = (20, 8) if self.big else (12, 4)
        pos += 8 if self.big else 2
        self.ifd_end = pos + n * entry      # where the entries end
        # the bytes of the header, the IFD and its values stored apart
        # (libtiff's EstimateStripByteCounts)
        self.meta_bytes = (24 if self.big else 10) + n * entry + (
            8 if self.big else 4)
        tags = {}
        for i in range(n):
            at = pos + i * entry
            code, kind = self.unpack("HH", at)
            count = self.unpack("Q" if self.big else "I", at + 4)[0]
            if _TYPES.get(kind, ("", 0))[1] * count > inline:
                self.meta_bytes += _TYPES[kind][1] * count
            dropped = self.libtiff and code not in _LIBTIFF_NEEDS
            if self.libtiff and code in _INTEGER_TAGS | _LIBTIFF_NEEDS and (
                    kind not in _LIBTIFF_INTEGER_TYPES
                    or code in _LIBTIFF_SCALAR and count != 1):
                if dropped:
                    continue
                _fail(self.path, f"libtiff: Incompatible type or count for "
                                 f"tag {code}")
            if kind not in _TYPES:
                continue           # tifffile warns and skips the tag
            fmt, size = _TYPES[kind]
            if kind in (11, 12) and code in _INTEGER_TAGS:
                if dropped:
                    continue
                _fail(self.path, f"tag {code} holds floating-point values")
            nbytes = size * count
            where = at + (12 if self.big else 8)
            if nbytes > inline:
                where = self.unpack("Q" if self.big else "I", where)[0]
            if nbytes > len(self.data) or where + nbytes > len(self.data):
                if self.libtiff and code in _LIBTIFF_ARRAYS:
                    # libtiff reads the values it needs (one a strip or
                    # tile) from where the count puts them: those the file
                    # holds
                    count = max(0, len(self.data) - where) // size
                    nbytes, where = size * count, min(where, len(self.data))
                elif dropped:
                    continue
                else:
                    _fail(self.path, f"tag {code} runs past the end of the "
                                     "file")
            if kind == 2:
                value = self.data[where:where + count]
            else:   # a rational is two values
                n = count * (2 if fmt[0] == "2" else 1)
                value = struct.unpack_from(f"{self.order}{n}{fmt[-1]}",
                                           self.data, where)
            tags.setdefault(code, value)
        return tags


def _one(tags: dict, code: int, default):
    v = tags.get(code)
    return default if v is None or not len(v) else v[0]


def _per_sample(tags: dict, code: int, default, spp: int):
    """A per-sample tag as tifffile keeps it: one value, or the tuple of
    the first ``spp`` where they differ."""
    v = tags.get(code)
    if v is None or not len(v):
        return default
    v = tuple(v[:spp]) if len(v) > 1 else tuple(v)
    return v[0] if all(x == v[0] for x in v) else v


def _decompress(raw: bytes, compression: int, cap: int, path: str):
    """A strip or tile's bytes, at most ``cap`` of them."""
    if compression == 1:
        return np.frombuffer(raw, np.uint8)
    cap = min(cap, 1 << 62)
    try:
        if compression in _GROWTH:     # the output buffer: what can come
            cap = min(cap, len(raw) * _GROWTH[compression] + 4096)
            return (native.tiff_unlzw if compression == 5 else
                    native.packbits)(raw, cap)
        if compression in (8, 32946):
            out = zlib.decompressobj().decompress(raw, cap)
        else:
            out = lzma.LZMADecompressor().decompress(raw, cap)
        return np.frombuffer(out, np.uint8)
    except (ValueError, zlib.error, lzma.LZMAError) as e:
        msg = str(e).removeprefix("TIFF: ")
        _fail(path, f"compression {compression}: {msg}")


def _unpack_bits(raw: np.ndarray, rows: int, run: int, bits: int):
    """Rows of ``run`` samples of ``bits`` bits (each row padded to a byte,
    the most significant bit first) -> (rows, run) uint8."""
    stride = (run * bits + 7) // 8
    u = np.unpackbits(raw[:rows * stride].reshape(rows, stride), axis=1)
    u = u[:, :run * bits].reshape(rows, run, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (u * weights).sum(-1, dtype=np.uint8)


def _unpack_565(raw: np.ndarray, rows: int, run: int):
    """Packed RGB 5-6-5 -> (rows, run, 3) uint8, as tifffile's
    ``unpack_rgb`` gives it: each pixel a little-endian uint16 whatever the
    file's byte order (its one-byte dtype has none), each field rescaled to
    8 bits (v * 33 // 4 for 5 bits, v * 65 // 16 for 6)."""
    px = raw[:rows * run * 2].view("<u2").astype(np.uint32)
    out = [((px >> s) & m) * k // d for s, m, k, d in
           ((11, 31, 33, 4), (5, 63, 65, 16), (0, 31, 33, 4))]
    return np.stack(out, -1).astype(np.uint8).reshape(rows, run, 3)


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 CMYK -> (..., 3) uint8 RGB, as Pillow's ``cmyk2rgb``:
    each channel (255 - k) - muldiv255(c, 255 - k)."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def _rationals(tags: dict, code: int, default) -> list:
    """A tag of rationals as float32 values (num / den), or ``default``."""
    v = tags.get(code)
    if v is None or len(v) < 2 * len(default):
        return [np.float32(x) for x in default]
    return [np.float32(v[2 * i] / v[2 * i + 1] if v[2 * i + 1] else 0.0)
            for i in range(len(default))]


def _ycbcr_to_rgb(ycc: np.ndarray, tags: dict) -> np.ndarray:
    """(..., 3) uint8 YCbCr -> RGB, as libtiff's ``TIFFYCbCrToRGBInit`` and
    ``TIFFYCbCrtoRGB`` compute it (tif_color.c: float32 coefficients,
    16-bit fixed-point tables, the reference black and white of each
    channel), which is what Pillow's ``convert("RGB")`` gives. The defaults
    are libtiff's: coefficients 0.299, 0.587, 0.114; reference (0, 255,
    128, 255, 128, 255)."""
    f = np.float32
    lr, lg, lb = _rationals(tags, _YCBCR_COEFFICIENTS, (0.299, 0.587, 0.114))
    ref = _rationals(tags, _REFERENCE_BLACK_WHITE,
                     (0.0, 255.0, 128.0, 255.0, 128.0, 255.0))

    def fix(x):     # FIX(CLAMP(x, 0, 2)): float32 * 65536, + 0.5 in double
        x = min(max(x, f(0)), f(2))
        return int(float(f(x * f(65536))) + 0.5)

    f1, f3 = f(2) - f(2) * lr, f(2) - f(2) * lb
    d1, d2 = fix(f1), -fix(lr * f1 / lg)
    d3, d4 = fix(f3), -fix(lb * f3 / lg)

    def code2v(c, rb, rw, cr):    # Code2V, then CLAMPw and the int cast
        den = f(rw - rb)
        v = (c - int(rb)).astype(f) * f(cr) / (den if den != 0 else f(1))
        return np.trunc(np.clip(v, f(-4096), f(4096))).astype(np.int64)

    x = np.arange(-128, 128)
    cr = code2v(x, ref[4] - f(128), ref[5] - f(128), 127)
    cb = code2v(x, ref[2] - f(128), ref[3] - f(128), 127)
    y = code2v(x + 128, ref[0], ref[1], 255)
    cr_r, cb_b = (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16
    cr_g, cb_g = d2 * cr, d4 * cb + 32768
    Y, Cb, Cr = (ycc[..., i].astype(np.intp) for i in range(3))
    rgb = np.stack([y[Y] + cr_r[Cr], y[Y] + ((cb_g[Cb] + cr_g[Cr]) >> 16),
                    y[Y] + cb_b[Cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


# PCS white (D50, as ICC and LittleCMS take it), and XYZ (D50) -> linear
# sRGB: the inverse of sRGB's primaries (0.64, 0.33), (0.30, 0.60), (0.15,
# 0.06) under its white D65 (0.3127, 0.3290), adapted to D50 by Bradford
# (LittleCMS's built-in sRGB profile), in float64, written out so that
# every machine's linear algebra gives the same texture
D50 = (0.9642, 1.0, 0.8249)
XYZ_TO_SRGB = ((3.134186364236819, -1.6172089589982752, -0.49069406400638405),
               (-0.9787485041906941, 1.9161300967735873, 0.03343339915999557),
               (0.07196392780224675, -0.22899387345320327, 1.4057537328964445))


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """(..., 3) float64 CIE L*a*b* (D50) -> (..., 3) uint8 sRGB: XYZ by
    CIE 1976's inverse (white ``D50``), linear sRGB by ``XYZ_TO_SRGB`` (each
    row's three products summed left to right), clipped to [0, 1],
    sRGB's transfer curve, times 255, rounded half to even. This is the
    colorimetry of Pillow's ``convert("RGB")`` of a LAB image (LittleCMS,
    Lab D50 to sRGB); LittleCMS interpolates a table of it, so Pillow's
    pixels differ from these by a level or so inside sRGB's gamut, and by
    more where it clips."""
    fy = (lab[..., 0] + 16.0) / 116.0
    xyz = []
    for f, white in zip((fy + lab[..., 1] / 500.0, fy,
                         fy - lab[..., 2] / 200.0), D50):
        xyz.append(np.where(f > 6.0 / 29.0, f * f * f,
                            3.0 * (6.0 / 29.0) ** 2 * (f - 4.0 / 29.0))
                   * white)
    out = []
    for m in XYZ_TO_SRGB:      # one product and sum at a time: no BLAS
        lin = np.clip(m[0] * xyz[0] + m[1] * xyz[1] + m[2] * xyz[2],
                      0.0, 1.0)
        with np.errstate(invalid="ignore"):
            enc = np.where(lin <= 0.0031308, 12.92 * lin,
                           1.055 * lin ** (1.0 / 2.4) - 0.055)
        out.append(np.rint(enc * 255.0))
    return np.stack(out, -1).astype(np.uint8)


def _lab_samples(img: np.ndarray, photometric: int, bits: int,
                 tags: dict) -> np.ndarray:
    """(H, W, S) 8- or 16-bit integer samples of a Lab image -> (H, W, 3)
    L*, a*, b* (float64). Each sample's bits are read as the encoding
    says, whatever its SampleFormat: t = v / (2^d - 1) of the unsigned
    value. CIELab: L* = 100 t, a* and b* two's complement over 2^(d-8)
    (TIFF 6.0). ICCLab: L* = 100 t, a* = 255 t - 128 (ICC's 8-bit scale,
    and v4's 16-bit one). ITULab: each channel min + t (max - min) over the
    ``Decode`` tag's ranges, by default L* 0-100, a* -85-85, b* -75-125
    (RFC 2301). Fewer than three samples: L* alone, a* = b* = 0."""
    u = img.view(np.uint8 if bits == 8 else np.uint16).astype(np.float64)
    t = u / float((1 << bits) - 1)
    n = 3 if img.shape[-1] >= 3 else 1
    lab = np.zeros(img.shape[:-1] + (3,))
    if photometric == 10:
        d = tags.get(_DECODE)
        rng = ([d[2 * i] / d[2 * i + 1] if d[2 * i + 1] else 0.0
                for i in range(6)] if d is not None and len(d) >= 12
               else _ITULAB_DECODE)
        for c in range(n):
            lab[..., c] = rng[2 * c] + t[..., c] * (rng[2 * c + 1]
                                                    - rng[2 * c])
        return lab
    lab[..., 0] = 100.0 * t[..., 0]
    if photometric == 8:
        s = img.view(np.int8 if bits == 8 else np.int16)[..., 1:n]
        lab[..., 1:n] = s / float(1 << (bits - 8))
    else:
        lab[..., 1:n] = 255.0 * t[..., 1:n] - 128.0
    return lab


def offset_binary(img: np.ndarray) -> np.ndarray:
    """Signed samples offset by 2^(d-1) (the sign bit flipped), as their
    unsigned d-bit values, exact at every width; unsigned ones as they
    are."""
    if img.dtype.kind != "i":
        return img
    u = img.view(img.dtype.str.replace("i", "u"))
    return u ^ u.dtype.type(1 << (8 * img.dtype.itemsize - 1))


def _to_uint8(img: np.ndarray, bits: int) -> np.ndarray:
    """Samples made 8-bit for the CMYK and YCbCr conversions: 1, 2 and 4
    bits scaled, wider unsigned samples their high byte, signed ones
    offset first, float and complex as ``to_uint8`` makes the float
    rule's float32."""
    if img.dtype.kind in "fc":
        with np.errstate(over="ignore"):
            x = np.nan_to_num(img.real.astype(np.float32))
        return (np.clip(x, 0, 1) * 255).astype(np.uint8)
    if bits < 8:
        return _widen(img, bits)
    u = offset_binary(img)
    return (u >> u.dtype.type(8 * u.dtype.itemsize - 8)).astype(np.uint8)


def _widen(img: np.ndarray, bits: int) -> np.ndarray:
    """1-, 2- or 4-bit samples (uint8) scaled to 8 bits, a value past
    2^d - 1 (a predictor's wrapped sum) saturated."""
    top = (1 << bits) - 1
    return np.minimum(img, np.uint8(top)) * np.uint8(255 // top)


def _typed(img: np.ndarray, bits: int) -> np.ndarray:
    """Samples -> the type that states their scale (module docstring)."""
    from .image_files import unit_interval   # image_files imports this
    if img.dtype.kind in "fc":
        with np.errstate(over="ignore"):    # past float32: infinite
            return img.real.astype(np.float32)
    if bits < 8:
        return _widen(img, bits)
    if img.dtype.itemsize >= 4:
        return unit_interval(offset_binary(img), 8 * img.dtype.itemsize)
    return img


def _invert(img: np.ndarray, bits: int) -> np.ndarray:
    """Min-is-white samples inverted (module docstring)."""
    if img.dtype.kind in "fc":
        with np.errstate(over="ignore"):
            return np.float32(1) - img.real.astype(np.float32)
    if img.dtype.kind == "i":
        return ~img
    top = (1 << bits) - 1 if bits < 8 else np.iinfo(img.dtype).max
    return img.dtype.type(top) - np.minimum(img, img.dtype.type(top))


def _keep(img: np.ndarray, colour: bool) -> np.ndarray:
    """Three samples as RGB (a fourth kept), or one as grey (a second
    kept)."""
    keep = 3 if colour and img.shape[-1] >= 3 else 1
    return img[..., :keep + (img.shape[-1] > keep)]


def _contiguous(tags: dict, bits, compression: int, W: int, H: int,
                D: int):
    """Whether tifffile reads the image as one block (its
    ``is_contiguous``): uncompressed 8-64-bit samples, one strip or tile
    or each following the last, tiles only as wide as the image."""
    if compression != 1 or bits not in (8, 16, 32, 64):
        return False
    if _TILE_WIDTH in tags:
        tw, tl = _one(tags, _TILE_WIDTH, 0), _one(tags, _TILE_LENGTH, 0)
        if W != tw or not tl or H % tl or tw % 16 or tl % 16:
            return False
        if _IMAGE_DEPTH in tags and _TILE_DEPTH in tags and (
                H != tl or D % max(1, _one(tags, _TILE_DEPTH, 1))):
            return False
        offsets, counts = tags.get(_TILE_OFFSETS), tags.get(_TILE_COUNTS)
    else:
        offsets, counts = tags.get(_STRIP_OFFSETS), tags.get(_STRIP_COUNTS)
    if not offsets or not counts:
        return False
    return len(offsets) == 1 or all(
        offsets[i] + counts[i] == offsets[i + 1] or counts[i + 1] == 0
        for i in range(min(len(offsets), len(counts)) - 1))


def decode_tiff(data: bytes, path: str = "") -> np.ndarray:
    """The first plane of the first page of a TIFF file as (H, W, C)
    samples (see the module docstring): uint8, uint16 (16-bit samples, or a
    palette's colour map), int8 or int16 (signed samples) or float32
    (float and complex samples, and 32- and 64-bit integers normalised to
    [0, 1]); C = 1 grey, 2 grey + alpha, 3 RGB, 4 RGBA."""
    r = _Reader(data, path)
    tags = r.tags
    W, H = _one(tags, _WIDTH, 0), _one(tags, _LENGTH, 0)
    D = _one(tags, _IMAGE_DEPTH, 1)
    spp = _one(tags, _SAMPLES, 1)
    if not W or not H or not D or not spp:
        _fail(path, f"image of {W} x {H} x {D} pixels, {spp} samples")
    bits = _per_sample(tags, _BITS, 1, spp)
    fmt = _per_sample(tags, _SAMPLE_FORMAT, 1, spp)
    compression = _one(tags, _COMPRESSION, 1)
    photometric = _one(tags, _PHOTOMETRIC, 0)
    planar = 1 if _one(tags, _PLANAR, 1) == 1 else 2   # tifffile's test
    predictor = _one(tags, _PREDICTOR, 1)
    fillorder = _one(tags, _FILLORDER, 1)
    code = _SAMPLE_DTYPES.get((fmt, bits))
    if code is None:
        _fail(path, f"sample format {fmt} at {bits} bits is not a type "
                    "imageio's tifffile reads")
    if compression not in _READ_COMPRESSION:
        name = _COMPRESSION_NAMES.get(compression, "unknown")
        _fail(path, f"compression {compression} ({name}) cannot be "
                    "decompressed (neither imageio's tifffile nor the port "
                    "reads it)")
    sub = tags.get(_YCBCR_SUBSAMPLING)
    if sub is not None and tuple(sub) != (1, 1):
        _fail(path, f"YCbCr subsampling {tuple(sub)} is not read (tifffile "
                    "raises)")
    packed = isinstance(bits, tuple)
    if not packed and bits not in _UNPACKED:
        _fail(path, f"{bits}-bit samples are not read (tifffile's unpacker "
                    "splits 1, 2, 4, 8, 16, 32 and 64 bits)")
    if packed and spp != 3:
        _fail(path, f"5-6-5 samples with {spp} samples a pixel are not read")
    dtype = np.dtype(code)
    if dtype.kind == "b":
        dtype = np.dtype(np.uint8)          # 0 and 1
    tiled = _TILE_WIDTH in tags
    contiguous = _contiguous(tags, bits, compression, W, H, D)
    if predictor == 3 and dtype.char not in "efd":
        _fail(path, f"predictor 3 on {dtype} samples (tifffile raises: not "
                    "a floating point image)")
    if predictor == 3 and tiled and not contiguous:
        _fail(path, "predictor 3 in tiles is not read (tifffile raises)")
    width = 16 if packed else bits          # bits a stored sample
    item = dtype.itemsize
    planes = spp if planar == 2 else 1
    contig = 1 if planar == 2 else 3 if packed else spp
    if tiled:
        tw, tl = _one(tags, _TILE_WIDTH, 0), _one(tags, _TILE_LENGTH, 0)
        td = max(1, _one(tags, _TILE_DEPTH, 1))
        offsets, counts = tags.get(_TILE_OFFSETS), tags.get(_TILE_COUNTS)
        if not tw or not tl:
            _fail(path, f"tiles of {tw} x {tl} pixels")
        across, down = -(-W // tw), -(-H // tl)
        per_plane = -(-D // td) * down * across
        last = (planes - 1) * per_plane + down * across - 1
    else:
        rows_tag = _one(tags, _ROWS_PER_STRIP, H) if len(
            tags.get(_ROWS_PER_STRIP, ())) == 1 else H
        rps = max(1, min(rows_tag, D * H))
        td, per_plane = 1, -(-(D * H) // rps)
        offsets, counts = tags.get(_STRIP_OFFSETS), tags.get(_STRIP_COUNTS)
        last = (planes - 1) * per_plane + (H - 1) // rps
    if offsets is None:
        _fail(path, "no strip or tile offsets")
    if counts is None:
        if compression != 1:
            _fail(path, "no strip or tile byte counts")
        counts = (H * W * D * spp * item,)
    if packed and planar == 2 and not tiled:
        img = _planar_565_strips(data, offsets, counts, compression,
                                 fillorder, max(1, rows_tag) * W, (D, H, W),
                                 path)
        if predictor == 2:
            img = np.cumsum(img, axis=1, dtype=np.uint8)
        return _texture_samples(img, tags, photometric, fmt, bits, spp, path)
    # the strips or tiles of the first depth slice, once the file is known
    # to hold as many: (index, plane, y, x, rows, run)
    if len(offsets) <= last or len(counts) <= last:
        _fail(path, f"{len(offsets)} data offsets for {planes * per_plane} "
                    "strips or tiles")
    if tiled:
        need_blocks = [(p * per_plane + ty * across + tx, p, ty * tl,
                        tx * tw, tl, tw) for p in range(planes)
                       for ty in range(down) for tx in range(across)]
    else:
        need_blocks = [(p * per_plane + y // rps, p, y, 0,
                        min(rps, D * H - y), W) for p in range(planes)
                       for y in range(0, H, rps)]
    order = r.order
    swap = predictor == 3 and contiguous and order == ">"
    blocks = []
    for i, p, y, x, rows, run in need_blocks:
        off, cnt = offsets[i], counts[i]
        if off + cnt > len(data):
            _fail(path, f"strip or tile {i} runs past the end of the file")
        raw = data[off:off + cnt]
        if fillorder == 2:
            raw = _REVERSED_BITS[np.frombuffer(raw, np.uint8)].tobytes()
        depth = td if tiled else 1
        row_bytes = (run * contig * width + 7) // 8 if not packed else \
            run * 2
        need = depth * rows * row_bytes
        buf = _decompress(raw, compression, need, path)
        if buf.size < need:
            _fail(path, f"strip or tile {i} holds {buf.size} of its {need} "
                        "bytes")
        buf = buf[:rows * row_bytes]            # the first depth slice
        blocks.append((p, y, x, _unpack(buf, rows, run, contig, bits, dtype,
                                         order, predictor, swap)))
    out = np.empty((planes, H, W, contig), dtype)
    for p, y, x, block in blocks:
        h, w = min(block.shape[0], H - y), min(block.shape[1], W - x)
        out[p, y:y + h, x:x + w] = block[:h, :w]
    img = out[0] if planar == 1 else out[..., 0].transpose(1, 2, 0)
    return _texture_samples(img, tags, photometric, fmt, bits, spp, path)


def _planar_565_strips(data, offsets, counts, compression, fillorder,
                       strip_size, shape, path):
    """Planar 5-6-5 strips as tifffile lays them out: each strip's pixels
    unpacked to three fields apiece, and the first ``strip_size`` values
    (or fewer, where the strip holds fewer) of each strip, in file order,
    filled one after the other into the (3, D, H, W) planes, the rest
    zero. Returns the first plane of each as (H, W, 3); raises where the
    strips do not fill the first."""
    D, H, W = shape
    plane, runs, at = H * W, [], 0
    for i in range(min(len(offsets), len(counts))):
        if at >= 2 * D * plane + plane:
            break
        off, cnt = offsets[i], counts[i]
        if off + cnt > len(data):
            _fail(path, f"strip {i} runs past the end of the file")
        raw = data[off:off + cnt]
        if fillorder == 2:
            raw = _REVERSED_BITS[np.frombuffer(raw, np.uint8)].tobytes()
        buf = _decompress(raw, compression, 2 * strip_size, path)
        if buf.size % 2:
            _fail(path, f"5-6-5 strip {i} of an odd {buf.size} bytes "
                        "(tifffile raises)")
        v = _unpack_565(buf, 1, buf.size // 2).reshape(-1)[:strip_size]
        runs.append((at, v))
        at += v.size
    if at < plane:
        _fail(path, f"5-6-5 strips hold {at} of the first plane's {plane} "
                    "values")
    out = np.zeros((3, plane), np.uint8)
    for c in range(3):               # plane c's first depth slice
        lo = c * D * plane
        for start, v in runs:
            a, b = max(start, lo), min(start + v.size, lo + plane)
            if a < b:
                out[c, a - lo:b - lo] = v[a - start:b - start]
    return out.reshape(3, H, W).transpose(1, 2, 0)


def _unpack(buf, rows, run, contig, bits, dtype, order, predictor, swap):
    """A strip or tile's bytes -> (rows, run, contig) samples, predictor
    undone as tifffile undoes it."""
    if isinstance(bits, tuple):     # a planar tile: its first values
        block = _unpack_565(buf, rows, run).reshape(-1)[
            :rows * run * contig].reshape(rows, run, contig)
    elif predictor == 3:
        # byte planes, most significant first, differenced along the row
        # with a stride of one pixel's samples (tifffile's decode_floats;
        # where it reads the image as one block from a big-endian file it
        # swaps each sample's bytes first)
        item = dtype.itemsize
        if swap:
            buf = buf.reshape(-1, item)[:, ::-1].reshape(-1)
        u = np.cumsum(buf.reshape(rows, run * item, contig), axis=1,
                      dtype=np.uint8)
        u = u.reshape(rows, item, run, contig).transpose(0, 2, 3, 1)
        return np.ascontiguousarray(u[..., ::-1]).view(
            "<" + dtype.str[1:]).reshape(rows, run, contig)
    elif bits < 8:
        block = _unpack_bits(buf, rows, run * contig, bits).reshape(
            rows, run, contig)
    else:
        block = np.frombuffer(buf.tobytes(), order + dtype.str[1:]).astype(
            dtype).reshape(rows, run, contig)
    if predictor == 2:
        if bits == 1:       # tifffile's bool cumsum: an OR along the row
            return np.cumsum(block.astype(bool), axis=1,
                             dtype=bool).astype(np.uint8)
        block = np.cumsum(block, axis=1, dtype=dtype)
    return block


def _texture_samples(img, tags, photometric, fmt, bits, spp, path):
    """tifffile's samples of the first plane -> the port's (H, W, C)."""
    packed = isinstance(bits, tuple)
    depth = 8 if packed else bits
    if photometric == 3 and fmt == 1 and not packed and bits <= 16:
        cmap = tags.get(_COLORMAP)
        if cmap is not None and len(cmap) >= 3 << bits:
            lut = np.zeros((256 if bits <= 8 else 65536, 3), np.uint16)
            lut[:1 << bits] = (np.asarray(cmap[:3 << bits], np.int64)
                               & 0xFFFF).reshape(3, -1).T
            return lut[img[..., 0]]
    if photometric == 5 and _one(tags, _INKSET, 1) == 1 and spp >= 4:
        return cmyk_to_rgb(_to_uint8(img[..., :4], depth))
    if photometric == 6 and spp >= 3:
        return _ycbcr_to_rgb(_to_uint8(img[..., :3], depth), tags)
    if photometric in _LAB and img.dtype.kind in "ui" and bits in (8, 16):
        return lab_to_rgb(_lab_samples(img, photometric, bits, tags))
    if photometric == 0:
        img = np.concatenate([_invert(img[..., :1], depth), img[..., 1:2]],
                             -1)
    img = _keep(img, photometric not in (0, 1))
    return np.ascontiguousarray(_typed(img, depth))
