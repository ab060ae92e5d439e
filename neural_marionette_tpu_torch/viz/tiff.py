"""TIFF textures: the first image of a TIFF file, read as the bundled
``tifffile`` of imageio (the JAX package's ``_find_texture``) reads it,
then made a texture under the port's stated rules.

What is read: classic TIFF in both byte orders and BigTIFF; strips and
tiles; ``PlanarConfiguration`` 1 and 2; 1, 2, 4, 8 and 16 bits a sample
(unsigned) and 16-, 32- and 64-bit float; photometric min-is-white,
min-is-black, RGB, palette and CMYK (separated, ink set CMYK), with extra
samples; compression none, LZW, Deflate (8 and 32946), PackBits and LZMA;
predictor 2 (horizontal differencing per sample, at 8 and 16 bits) and
predictor 3 (floating point, in strips); fill order 2.

What is refused, with a ``ValueError`` that names it: what tifffile
refuses (JPEG, CCITT and the other compressions it cannot decompress,
old-style LZW, chroma subsampling, mixed sample formats), and what the
port leaves out (signed integer samples, bit depths other than those
above, YCbCr, CIELab and the other photometric interpretations, image
depth above 1). See ``ROADMAP.md``.

The samples come out as tifffile gives them, and :func:`decode_tiff` then
returns the first page as (H, W, C) (planar data transposed), with:
palette indices mapped through the colour map (uint16, as stored);
min-is-white samples inverted; samples of 1, 2 or 4 bits scaled to 8
bits; CMYK made RGB as Pillow's ``Image.convert("RGB")`` does; float
samples as float32. The LZW and PackBits expansions run in the port's host
library; Deflate in ``zlib`` and LZMA in ``lzma``.
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
_INKSET, _EXTRA, _SAMPLE_FORMAT, _YCBCR_SUBSAMPLING = 332, 338, 339, 530
_IMAGE_DEPTH = 32997

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
_PHOTOMETRIC_NAMES = {4: "transparency mask", 6: "YCbCr", 8: "CIELab",
                      9: "ICCLab", 10: "ITULab", 32803: "CFA",
                      32844: "LogL", 32845: "LogLuv", 34892: "linear raw"}
_REVERSED_BITS = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                          np.uint8)


def _fail(path: str, what: str):
    raise ValueError(f"{path}: TIFF: {what}")


class _Reader:
    """The header and the first IFD of a TIFF file."""

    def __init__(self, data: bytes, path: str):
        self.data, self.path = data, path
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
        tags = {}
        for i in range(n):
            at = pos + i * entry
            code, kind = self.unpack("HH", at)
            count = self.unpack("Q" if self.big else "I", at + 4)[0]
            if kind not in _TYPES:
                continue           # tifffile warns and skips the tag
            fmt, size = _TYPES[kind]
            nbytes = size * count
            where = at + (12 if self.big else 8)
            if nbytes > inline:
                where = self.unpack("Q" if self.big else "I", where)[0]
            if nbytes > len(self.data) or where + nbytes > len(self.data):
                _fail(self.path, f"tag {code} runs past the end of the file")
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


def _per_sample(tags: dict, code: int, default, spp: int, path: str,
                what: str):
    v = tags.get(code)
    if v is None:
        return default
    if len(v) > 1:
        v = v[:spp]
        if any(x != v[0] for x in v):
            _fail(path, f"{what} differ between samples ({tuple(v)})")
    return v[0]


def _decompress(raw: bytes, compression: int, cap: int, path: str):
    if compression == 1:
        return np.frombuffer(raw, np.uint8)
    try:
        if compression == 5:
            return native.tiff_unlzw(raw, cap)
        if compression == 32773:
            return native.packbits(raw, cap)
        if compression in (8, 32946):
            return np.frombuffer(zlib.decompress(raw), np.uint8)
        return np.frombuffer(lzma.decompress(raw), np.uint8)
    except (ValueError, zlib.error, lzma.LZMAError) as e:
        msg = str(e).removeprefix("TIFF: ")
        _fail(path, f"compression {compression}: {msg}")


def _unpack_bits(raw: np.ndarray, rows: int, run: int, bits: int):
    """Rows of ``run`` samples of ``bits`` bits (each row padded to a byte)
    -> (rows, run) uint8."""
    stride = (run * bits + 7) // 8
    u = np.unpackbits(raw[:rows * stride].reshape(rows, stride), axis=1)
    u = u[:, :run * bits].reshape(rows, run, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (u * weights).sum(-1, dtype=np.uint8)


def _cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 CMYK -> (..., 3) uint8 RGB, as Pillow's ``cmyk2rgb``:
    each channel (255 - k) - muldiv255(c, 255 - k)."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def decode_tiff(data: bytes, path: str = "") -> np.ndarray:
    """The first page of a TIFF file as (H, W, C) samples (see the module
    docstring): uint8, uint16 (16-bit samples, or a palette's colour map)
    or float32; C = 1 grey, 2 grey + alpha, 3 RGB, 4 RGBA."""
    r = _Reader(data, path)
    tags = r.tags
    W, H = _one(tags, _WIDTH, 0), _one(tags, _LENGTH, 0)
    if not W or not H:
        _fail(path, f"image of {W} x {H} pixels")
    from .image_files import check_pixels   # image_files imports this
    check_pixels(W, H, path, "TIFF")
    spp = _one(tags, _SAMPLES, 1)
    bits = _per_sample(tags, _BITS, 1, spp, path, "bits per sample")
    fmt = _per_sample(tags, _SAMPLE_FORMAT, 1, spp, path, "sample formats")
    compression = _one(tags, _COMPRESSION, 1)
    photometric = _one(tags, _PHOTOMETRIC, 0)
    planar = _one(tags, _PLANAR, 1)
    predictor = _one(tags, _PREDICTOR, 1)
    fillorder = _one(tags, _FILLORDER, 1)
    if compression not in _READ_COMPRESSION:
        name = _COMPRESSION_NAMES.get(compression, "unknown")
        _fail(path, f"compression {compression} ({name}) cannot be "
                    "decompressed (neither imageio's tifffile nor the port "
                    "reads it)")
    sub = tags.get(_YCBCR_SUBSAMPLING)
    if sub is not None and tuple(sub) != (1, 1):
        _fail(path, f"YCbCr subsampling {tuple(sub)} is not read")
    if photometric in _PHOTOMETRIC_NAMES or photometric not in (0, 1, 2, 3,
                                                                 5):
        name = _PHOTOMETRIC_NAMES.get(photometric, "unknown")
        _fail(path, f"photometric interpretation {photometric} ({name}) is "
                    "not read")
    if _one(tags, _IMAGE_DEPTH, 1) != 1:
        _fail(path, "an image depth above 1 is not read")
    if fmt == 2:
        _fail(path, f"signed {bits}-bit samples are not read")
    if not (fmt == 1 and bits in (1, 2, 4, 8, 16)
            or fmt == 3 and bits in (16, 32, 64)):
        _fail(path, f"sample format {fmt} at {bits} bits is not read")
    if photometric == 5 and not (_one(tags, _INKSET, 1) == 1 and spp >= 4
                                 and bits == 8):
        _fail(path, "only 8-bit CMYK separations are read")
    if photometric == 2 and spp < 3 or photometric == 3 and spp != 1:
        _fail(path, f"photometric {photometric} with {spp} samples a pixel")
    if planar not in (1, 2) or spp < 1:
        _fail(path, f"planar configuration {planar}, {spp} samples")
    if predictor not in (1, 2, 3) or predictor == 2 and fmt != 1 \
            or predictor == 3 and fmt != 3 or predictor > 1 and bits < 8:
        _fail(path, f"predictor {predictor} on {bits}-bit samples of "
                    f"format {fmt} is not read")
    tiled = _TILE_WIDTH in tags
    if predictor == 3 and tiled:
        _fail(path, "predictor 3 in tiles is not read (tifffile raises)")
    dtype = np.dtype({1: "u", 3: "f"}[fmt] + str(max(1, bits // 8)))
    if bits < 8:
        dtype = np.dtype(np.uint8)
    item = max(1, bits // 8)
    planes = spp if planar == 2 else 1
    contig = 1 if planar == 2 else spp
    if tiled:
        tw, tl = _one(tags, _TILE_WIDTH, 0), _one(tags, _TILE_LENGTH, 0)
        offsets, counts = tags.get(_TILE_OFFSETS), tags.get(_TILE_COUNTS)
        if not tw or not tl:
            _fail(path, f"tiles of {tw} x {tl} pixels")
        across, down = -(-W // tw), -(-H // tl)
        blocks = [(p, ty * tl, tx * tw, tl, tw) for p in range(planes)
                  for ty in range(down) for tx in range(across)]
    else:
        rps = _one(tags, _ROWS_PER_STRIP, H) if len(
            tags.get(_ROWS_PER_STRIP, ())) == 1 else H
        rps = max(1, min(rps, H))
        offsets, counts = tags.get(_STRIP_OFFSETS), tags.get(_STRIP_COUNTS)
        blocks = [(p, y, 0, min(rps, H - y), W) for p in range(planes)
                  for y in range(0, H, rps)]
    if offsets is None:
        _fail(path, "no strip or tile offsets")
    if counts is None:
        if compression != 1:
            _fail(path, "no strip or tile byte counts")
        counts = (H * W * spp * item,)
    if len(offsets) < len(blocks) or len(counts) < len(blocks):
        _fail(path, f"{len(offsets)} data offsets for {len(blocks)} strips "
                    "or tiles")
    out = np.zeros((planes, H, W, contig), dtype)
    order = r.order
    for i, (p, y, x, rows, run) in enumerate(blocks):
        off, cnt = offsets[i], counts[i]
        if off + cnt > len(data):
            _fail(path, f"strip or tile {i} runs past the end of the file")
        raw = data[off:off + cnt]
        if fillorder == 2:
            raw = _REVERSED_BITS[np.frombuffer(raw, np.uint8)].tobytes()
        row_bytes = (run * contig * bits + 7) // 8
        need = rows * row_bytes
        buf = _decompress(raw, compression, need, path)
        if buf.size < need:
            _fail(path, f"strip or tile {i} holds {buf.size} of its {need} "
                        "bytes")
        buf = buf[:need]
        if predictor == 3:
            # byte planes, most significant first, differenced along the
            # row with a stride of one pixel's samples
            u = np.cumsum(buf.reshape(rows, run * item, contig), axis=1,
                          dtype=np.uint8)
            u = u.reshape(rows, item, run, contig).transpose(0, 2, 3, 1)
            block = np.ascontiguousarray(u[..., ::-1]).view(
                "<" + dtype.str[1:]).reshape(rows, run, contig)
        elif bits < 8:
            block = _unpack_bits(buf, rows, run * contig, bits).reshape(
                rows, run, contig)
        else:
            block = np.frombuffer(buf.tobytes(), order + dtype.str[1:]).astype(
                dtype).reshape(rows, run, contig)
            if predictor == 2:
                block = np.cumsum(block, axis=1, dtype=dtype)
        h, w = min(rows, H - y), min(run, W - x)
        out[p, y:y + h, x:x + w] = block[:h, :w]
    img = out[0] if planar == 1 else out[..., 0].transpose(1, 2, 0)
    return _texture_samples(img, tags, photometric, bits, spp, path)


def _texture_samples(img, tags, photometric, bits, spp, path):
    """tifffile's samples of the first page -> the port's (H, W, C)."""
    if photometric == 3:
        cmap = tags.get(_COLORMAP)
        if cmap is None or len(cmap) < 3 << bits:
            _fail(path, "palette image without a colour map of "
                        f"{3 << bits} entries")
        lut = np.asarray(cmap[:3 << bits], np.uint16).reshape(3, -1).T
        return lut[img[..., 0]]
    if photometric == 5:
        return _cmyk_to_rgb(img[..., :4])
    keep = 3 if photometric == 2 else 1
    img = img[..., :keep + (spp > keep)]
    if img.dtype.kind == "f":
        if photometric == 0:
            _fail(path, "float samples with min-is-white are not read")
        return img.astype(np.float32)
    top = (1 << bits) - 1
    if photometric == 0:
        grey = top - img[..., :1]
        img = np.concatenate([grey, img[..., 1:]], -1) if spp > 1 else grey
    if bits < 8:
        img = img * np.uint8(255 // top)
    return np.ascontiguousarray(img)
