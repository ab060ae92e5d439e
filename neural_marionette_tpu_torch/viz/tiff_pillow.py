"""A TIFF under one of Pillow's names (``.png``, ``.jpg``, an unknown one),
read as imageio 2.37.4's Pillow plugin reads it with Pillow 12.1.0: the
JAX package's ``_find_texture`` calls ``imageio.imread``, which tries
Pillow first for such a name, and Pillow opens a TIFF by its content.

* Open (:func:`open_tiff`): ``TiffImagePlugin``'s header and first
  directory as its ``ImageFileDirectory_v2`` reads them (a tag repeated
  keeps its last value; a tag whose data runs past the end of the file
  ends the directory there), then ``_setup``: the mode and raw mode from
  a copy of its ``OPEN_INFO`` table (:data:`OPEN_INFO`, keyed by byte
  order, photometric, sample formats, fill order, bits per sample and
  extra samples) and the tiles its own decoder reads. A file that
  ``_setup`` refuses with one of the errors Pillow's ``Image.open``
  passes over (an unknown pixel mode or compression, no colour map for a
  palette, ...) is declined: :func:`open_tiff` returns None and imageio
  tries its next plugin, OpenCV. Any other error (width not an integer,
  tile sizes that are not, more pixels than Pillow's decompression-bomb
  limit) makes imageio fail, and raises ``ValueError``.
* Load (:meth:`PillowTiff.read`): uncompressed data through Pillow's own
  raw decoder and unpackers (:data:`UNPACKERS`), tile by tile in file
  order, a predictor ignored; anything else through libtiff
  (``viz/libtiff.py``, strict: TIFFReadEncodedStrip / TIFFReadTile, whose
  codec errors fail): strips or tiles decoded to the host's byte order
  with the predictor undone, then unpacked by the raw mode with its
  16-bit forms made native (Pillow's ``I;16N`` and ``;16N``: a 16-bit
  big-endian file reads right; a big-endian ``I;16BS``, ``I;32BS`` or
  ``F;32BF`` file reads with its bytes swapped, as Pillow reads it).
  Separate planes go one plane to each byte of Pillow's pixel
  (``_pickUnpackers``), associated or unspecified alpha unpremultiplied;
  YCbCr other than contiguous JPEG goes through libtiff's RGBA interface
  (``TIFFRGBAImageGet``), contiguous JPEG through libjpeg's YCbCr to RGB.
  The codecs are those of libtiff that the port has (LZW, Deflate,
  LZMA, Zstandard, PackBits, JPEG, CCITT fax, ThunderScan); WebP fails,
  as Pillow's libtiff is built without it; old-style JPEG, which Pillow
  reads, is refused (:data:`UNREAD_COMPRESSION`). The
  Orientation tag is applied (``ImageOps.exif_transpose`` in
  ``load_end``). A failure raises ``ValueError`` naming the file.
* imageio's array (``imageio/plugins/pillow.py:_apply_transforms``, no
  EXIF rotation of its own): mode "P" converted to the palette's mode,
  RGB (the colour map's high bytes, indices past it black); every other
  mode as ``numpy.asarray`` gives it.

The samples returned are imageio's, each as (H, W, C): "1" uint8 0 and
255 (imageio's bool), "L" and "P" uint8, "LA" and "PA" two channels (a
"PA" image's indices and alpha: imageio does not convert it), "RGB",
"RGBA", "CMYK" and "LAB" uint8 (LAB's L, a, b codes as stored), "I;16"
little-endian and "I;16B" big-endian uint16, "I" int32, "F" float32.
"""
from __future__ import annotations

import struct

import numpy as np

from . import libtiff as L
from . import tiff as T
from .pixels import check_pixels, orient

II, MM = b"II", b"MM"
# Pillow's TiffImagePlugin.OPEN_INFO (PIL/TiffImagePlugin.py:151): (byte
# order, photometric, sample formats, fill order, bits per sample, extra
# samples) -> (mode, raw mode); every entry here has both byte orders
_INFO = (
    (0, (1,), 1, (1,), (), "1", "1;I"), (0, (1,), 2, (1,), (), "1", "1;IR"),
    (1, (1,), 1, (1,), (), "1", "1"), (1, (1,), 2, (1,), (), "1", "1;R"),
    (0, (1,), 1, (2,), (), "L", "L;2I"),
    (0, (1,), 2, (2,), (), "L", "L;2IR"),
    (1, (1,), 1, (2,), (), "L", "L;2"), (1, (1,), 2, (2,), (), "L", "L;2R"),
    (0, (1,), 1, (4,), (), "L", "L;4I"),
    (0, (1,), 2, (4,), (), "L", "L;4IR"),
    (1, (1,), 1, (4,), (), "L", "L;4"), (1, (1,), 2, (4,), (), "L", "L;4R"),
    (0, (1,), 1, (8,), (), "L", "L;I"), (0, (1,), 2, (8,), (), "L", "L;IR"),
    (1, (1,), 1, (8,), (), "L", "L"), (1, (2,), 1, (8,), (), "L", "L"),
    (1, (1,), 2, (8,), (), "L", "L;R"),
    (2, (1,), 1, (8, 8, 8), (), "RGB", "RGB"),
    (2, (1,), 2, (8, 8, 8), (), "RGB", "RGB;R"),
    (2, (1,), 1, (8, 8, 8, 8), (), "RGBA", "RGBA"),
    (2, (1,), 1, (8, 8, 8, 8), (0,), "RGB", "RGBX"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (0, 0), "RGB", "RGBXX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0), "RGB", "RGBXXX"),
    (2, (1,), 1, (8, 8, 8, 8), (1,), "RGBA", "RGBa"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (1, 0), "RGBA", "RGBaX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0), "RGBA", "RGBaXX"),
    (2, (1,), 1, (8, 8, 8, 8), (2,), "RGBA", "RGBA"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (2, 0), "RGBA", "RGBAX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0), "RGBA", "RGBAXX"),
    (2, (1,), 1, (8, 8, 8, 8), (999,), "RGBA", "RGBA"),
    (3, (1,), 1, (1,), (), "P", "P;1"), (3, (1,), 2, (1,), (), "P", "P;1R"),
    (3, (1,), 1, (2,), (), "P", "P;2"), (3, (1,), 2, (2,), (), "P", "P;2R"),
    (3, (1,), 1, (4,), (), "P", "P;4"), (3, (1,), 2, (4,), (), "P", "P;4R"),
    (3, (1,), 1, (8,), (), "P", "P"),
    (3, (1,), 1, (8, 8), (0,), "P", "PX"),
    (3, (1,), 1, (8, 8), (2,), "PA", "PA"),
    (3, (1,), 2, (8,), (), "P", "P;R"),
    (5, (1,), 1, (8, 8, 8, 8), (), "CMYK", "CMYK"),
    (5, (1,), 1, (8, 8, 8, 8, 8), (0,), "CMYK", "CMYKX"),
    (5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0), "CMYK", "CMYKXX"),
    (6, (1,), 1, (8,), (), "L", "L"),
    (6, (1,), 1, (8, 8, 8), (), "RGB", "RGBX"),
    (8, (1,), 1, (8, 8, 8), (), "LAB", "LAB"),
)
OPEN_INFO = {(order,) + key[:5]: key[5:] for key in _INFO
             for order in (II, MM)}
# the entries of one byte order, or whose raw mode names the byte order
OPEN_INFO.update({
    (II, 1, (1,), 1, (12,), ()): ("I;16", "I;12"),
    (II, 0, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (II, 1, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (MM, 1, (1,), 1, (16,), ()): ("I;16B", "I;16B"),
    (II, 1, (1,), 2, (16,), ()): ("I;16", "I;16R"),
    (II, 1, (2,), 1, (16,), ()): ("I", "I;16S"),
    (MM, 1, (2,), 1, (16,), ()): ("I", "I;16BS"),
    (II, 0, (3,), 1, (32,), ()): ("F", "F;32F"),
    (MM, 0, (3,), 1, (32,), ()): ("F", "F;32BF"),
    (II, 1, (1,), 1, (32,), ()): ("I", "I;32N"),
    (II, 1, (2,), 1, (32,), ()): ("I", "I;32S"),
    (MM, 1, (2,), 1, (32,), ()): ("I", "I;32BS"),
    (II, 1, (3,), 1, (32,), ()): ("F", "F;32F"),
    (MM, 1, (3,), 1, (32,), ()): ("F", "F;32BF"),
    (II, 1, (1,), 1, (8, 8), (2,)): ("LA", "LA"),
    (MM, 1, (1,), 1, (8, 8), (2,)): ("LA", "LA"),
    **{(o, 2, (1,), 1, (16,) * n, e): (m, f"{r};16{'L' if o == II else 'B'}")
       for o in (II, MM) for n, e, m, r in (
           (3, (), "RGB", "RGB"), (4, (), "RGBA", "RGBA"),
           (4, (0,), "RGB", "RGBX"), (4, (1,), "RGBA", "RGBa"),
           (4, (2,), "RGBA", "RGBA"))},
    **{(o, 5, (1,), 1, (16,) * 4, ()): ("CMYK",
                                         f"CMYK;16{'L' if o == II else 'B'}")
       for o in (II, MM)},
})
MAX_SAMPLESPERPIXEL = 6
# TiffImagePlugin.COMPRESSION_INFO: the compressions Pillow opens
COMPRESSION_INFO = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4",
                    5: "tiff_lzw", 6: "tiff_jpeg", 7: "jpeg",
                    8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
                    32773: "packbits", 32809: "tiff_thunderscan",
                    32946: "tiff_deflate", 34676: "tiff_sgilog",
                    34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd",
                    50001: "webp"}
# what libtiff decodes for Pillow and the port does not: (compression ->
# name); each is listed in ROADMAP.md
UNREAD_COMPRESSION = {6: "old-style JPEG"}
# what Pillow's libtiff is built without, so that the read fails
UNCONFIGURED = {50001: "WEBP"}
# the header prefixes Pillow's TIFF plugin accepts (TiffImagePlugin.PREFIXES)
PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
            b"MM\x00\x2b", b"II\x2b\x00")
# Pillow's unpackers for the raw modes above: raw mode -> (bits a pixel,
# kind, argument). Kinds: "bits" (1-, 2-, 4-bit levels, most significant
# first; argument (depth, inverted, bits reversed, scaled to 8 bits)),
# "bytes" (argument (the channels taken from each pixel's bytes, bits
# reversed, inverted)), "hi16" (the high bytes of 16-bit samples;
# argument (samples a pixel, channels, big-endian)), "alpha"
# (premultiplied RGBA; argument (bytes a sample, samples a pixel,
# big-endian)), "word" (one sample; argument (numpy type, bits
# reversed)) and "i12" (12-bit samples, most significant first).
UNPACKERS = {
    **{f"1{i}": (1, "bits", (1, "I" in i, "R" in i, True))
       for i in ("", ";I", ";R", ";IR")},
    **{f"L;{d}{i}{r}": (d, "bits", (d, bool(i), bool(r), True))
       for d in (2, 4) for i in ("", "I") for r in ("", "R")},
    **{f"P;{d}": (d, "bits", (d, False, False, False)) for d in (1, 2, 4)},
    "L;I": (8, "bytes", ((0,), False, True)),
    "L;R": (8, "bytes", ((0,), True, False)),
    "P;R": (8, "bytes", ((0,), True, False)),
    "PX": (16, "bytes", ((0,), False, False)),
    "RGB;R": (24, "bytes", ((0, 1, 2), True, False)),
    **{m: (8 * len(m), "bytes", (tuple(range(len(m))), False, False))
       for m in ("L", "P", "LA", "PA", "RGB", "LAB", "RGBA", "CMYK")},
    **{"RGB" + "X" * n: (8 * (3 + n), "bytes", ((0, 1, 2), False, False))
       for n in (1, 2, 3)},
    **{m + "X" * n: (8 * (4 + n), "bytes", ((0, 1, 2, 3), False, False))
       for m in ("RGBA", "CMYK") for n in (1, 2)},
    **{"RGBa" + "X" * n: (8 * (4 + n), "alpha", (1, 4 + n, False))
       for n in (0, 1, 2)},
    **{f"{m};16{o}": (16 * n, "hi16", (n, c, o == "B"))
       for m, n, c in (("RGB", 3, 3), ("RGBX", 4, 3), ("RGBA", 4, 4),
                       ("CMYK", 4, 4))
       for o in "LBN"},
    **{f"RGBa;16{o}": (64, "alpha", (2, 4, o == "B")) for o in "LBN"},
    **{m: (8 * int(t[-1]), "word", (t, m == "I;16R")) for m, t in (
        ("I;16", "<u2"), ("I;16N", "<u2"), ("I;16B", ">u2"),
        ("I;16R", "<u2"), ("I;16S", "<i2"), ("I;16BS", ">i2"),
        ("I;32S", "<i4"), ("I;32BS", ">i4"), ("I;32N", "<i4"), ("I", "<i4"),
        ("F;32F", "<f4"), ("F;32BF", ">f4"), ("F", "<f4"))},
    "I;12": (12, "i12", None),
    # one band of a separate plane (_BANDS)
    **{c: (8, "bytes", ((0,), False, False)) for c in "RGBACMYK"},
}
# the (mode, raw mode) pairs Pillow has an unpacker for (ImagingFindUnpacker)
_VALID = {
    "1": ("1", "1;I", "1;IR", "1;R"),
    "L": ("L", "L;2", "L;2I", "L;2IR", "L;2R", "L;4", "L;4I", "L;4IR",
          "L;4R", "L;I", "L;R"),
    "P": ("P", "P;1", "P;2", "P;4", "P;R", "PX"),
    "LA": ("LA",), "PA": ("PA",),
    "RGB": ("RGB", "RGB;R", "RGBX", "RGBXX", "RGBXXX", "RGB;16L", "RGB;16B",
            "RGB;16N", "RGBX;16L", "RGBX;16B", "RGBX;16N", "R", "G", "B"),
    "RGBA": ("RGBA", "RGBAX", "RGBAXX", "RGBa", "RGBaX", "RGBaXX",
             "RGBA;16L", "RGBA;16B", "RGBA;16N", "RGBa;16L", "RGBa;16B",
             "RGBa;16N", "R", "G", "B", "A"),
    "CMYK": ("CMYK", "CMYKX", "CMYKXX", "CMYK;16L", "CMYK;16B", "CMYK;16N",
             "C", "M", "Y", "K"),
    "LAB": ("LAB", "L", "A", "B"), "I;16": ("I;16", "I;16N", "I;16R", "I;12"),
    "I;16B": ("I;16B", "I;16N"),
    "I": ("I", "I;16S", "I;16BS", "I;32S", "I;32BS", "I;32N"),
    "F": ("F", "F;32F", "F;32BF"),
}
# one band's raw mode (a separate plane of Pillow's raw decoder) -> the
# channel of imageio's array it writes
_BANDS = {"RGB": {"R": 0, "G": 1, "B": 2},
          "RGBA": {"R": 0, "G": 1, "B": 2, "A": 3},
          "CMYK": {"C": 0, "M": 1, "Y": 2, "K": 3},
          "LAB": {"L": 0, "A": 1, "B": 2}}
# the channels of imageio's array and their type for each mode
_CHANNELS = {"1": 1, "L": 1, "P": 1, "LA": 2, "PA": 2, "RGB": 3, "RGBA": 4,
             "CMYK": 4, "LAB": 3, "I;16": 1, "I;16B": 1, "I": 1, "F": 1}
_DTYPE = {"I;16": "<u2", "I;16B": ">u2", "I": "<i4", "F": "<f4"}
# where each byte of Pillow's 4-byte pixel shows in imageio's array (None:
# nowhere), for libtiff's separate planes, which Pillow copies one to a
# byte (a mode's bands: one plane each)
_PIXEL_BYTES = {"RGB": (0, 1, 2, None), "RGBA": (0, 1, 2, 3),
                "CMYK": (0, 1, 2, 3), "LAB": (0, 1, 2, None),
                "LA": (0, None, None, 1), "PA": (0, None, None, 1)}
# Pillow keeps LAB's a and b signed and numpy shows them offset by 128: a
# band copied in as stored reads so
_LAB_OFFSET = np.array([0, 128, 128], np.uint8)


class _Declined(Exception):
    """TiffImageFile._open failed with an error that Image.open passes
    over to try its next format (SyntaxError, and the IndexError,
    TypeError, KeyError, EOFError and struct.error ImageFile turns into
    one)."""


def _refuse(path: str, what: str):
    raise ValueError(f"{path}: TIFF (Pillow): {what}")


# --------------------------------------------------------------- directory
_TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("L", 4), 5: ("L", 8),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("l", 4), 10: ("l", 8),
          11: ("f", 4), 12: ("d", 8), 13: ("L", 4), 16: ("Q", 8)}
# the tags read here whose TiffTags entry has length 1 (a scalar; a tag
# Pillow does not know is one too where it has one value)
_SCALAR = {256, 257, 259, 262, 266, 274, 277, 278, 282, 283, 284, 296, 317,
           322, 323, 32997}
_KNOWN = _SCALAR | {258, 273, 279, 320, 324, 325, 338, 339, 530}


def _value(typ: int, count: int, raw: bytes, endian: str, tag: int):
    """A tag's value as ImageFileDirectory_v2 gives it: bytes for BYTE and
    UNDEFINED, str for ASCII, numbers otherwise (a rational num / den);
    one value where TiffTags gives the tag length 1, else a tuple."""
    if typ == 1:
        return raw
    if typ in (2, 7):
        if typ == 2:
            raw = raw[:-1].decode("latin-1") if raw.endswith(b"\0") else \
                raw.decode("latin-1")
        return raw if tag in _SCALAR or tag not in _KNOWN else (raw,)
    code, size = _TYPES[typ]
    if typ in (5, 10):
        v = struct.unpack(f"{endian}{2 * count}{code}", raw)
        vals = tuple(v[i] / v[i + 1] if v[i + 1] else float("nan")
                     for i in range(0, len(v), 2))
    else:
        vals = struct.unpack(f"{endian}{count}{code}", raw)
    if tag in _SCALAR or tag not in _KNOWN and len(vals) == 1:
        return vals[0]
    return vals


class _Directory:
    """The header and the first IFD as Pillow's TIFF plugin reads them:
    ``tags`` (tag -> value; the last of a repeated tag), ``order``,
    ``offset`` (the IFD's position)."""

    def __init__(self, data: bytes, path: str):
        if data[:4] not in PREFIXES or len(data) < 8:
            raise _Declined("not a TIFF file")
        self.order = data[:2]
        endian = "<" if self.order == II else ">"
        big = data[2] == 43
        if big and len(data) < 16:
            raise _Declined("BigTIFF header cut short")
        first = struct.unpack_from(endian + ("Q" if big else "L"), data,
                                   8 if big else 4)[0]
        if not first:
            raise _Declined("no more images in TIFF file")
        if first >= 1 << 63:
            _refuse(path, "an IFD offset past 2^63 (Pillow: Unable to seek "
                          "to frame)")
        self.offset = first
        self.tags = {}
        types = {}
        pos, end = first, len(data)
        n_size, entry, inline = (8, 20, 8) if big else (2, 12, 4)
        if pos + n_size > end:
            return           # "Corrupt EXIF data": no tags
        n = struct.unpack_from(endian + ("Q" if big else "H"), data, pos)[0]
        pos += n_size
        for _ in range(n):
            if pos + entry > end:
                break
            tag, typ, count = struct.unpack_from(
                endian + ("HHQ" if big else "HHL"), data, pos)
            field = data[pos + entry - inline:pos + entry]
            pos += entry
            if typ not in _TYPES:
                continue
            size = count * _TYPES[typ][1]
            if size > inline:
                at = struct.unpack(endian + ("Q" if big else "L"), field)[0]
                if at + size > end:
                    break        # "Truncated File Read": the rest is lost
                raw = data[at:at + size]
            else:
                raw = field[:size]
            if not raw:
                continue
            types[tag] = (typ, count, raw)
        for tag, (typ, count, raw) in types.items():
            self.tags[tag] = _value(typ, count, raw, endian, tag)

    def get(self, tag, default=None):
        return self.tags.get(tag, default)


# -------------------------------------------------------------------- open
class PillowTiff:
    """A TIFF that Pillow's plugin opened: its mode, raw mode, tiles."""

    def __init__(self, data: bytes, path: str):
        self.data, self.path = data, path
        self.dir = d = _Directory(data, path)
        if 0xBC01 in d.tags:
            _refuse(path, "Windows Media Photo files not yet supported "
                          "(Pillow raises on opening)")
        compression = d.get(259, 1)
        try:
            self.name = COMPRESSION_INFO[compression]
        except (KeyError, TypeError):
            raise _Declined(f"compression {compression!r}") from None
        self.planar = d.get(284, 1)
        photo = d.get(262, 0)
        if self.name == "tiff_jpeg":
            photo = 6
        fillorder = d.get(266, 1)
        if 256 not in d.tags or 257 not in d.tags:
            raise _Declined("Missing dimensions")
        W, H = d.tags[256], d.tags[257]
        if not isinstance(W, int) or not isinstance(H, int):
            _refuse(path, f"dimensions {W!r} x {H!r} (Pillow raises "
                          "\"Invalid dimensions\")")
        self.W, self.H = W, H
        fmt = d.get(339, (1,))
        try:
            if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
                fmt = (1,)
        except TypeError:
            raise _Declined("sample formats") from None
        bps = d.get(258, (1,))
        extra = d.get(338, ())
        self.bps_count = (3 if photo in (2, 6, 8) else 4 if photo == 5 else
                          1) + len(extra)
        spp = d.get(277, 3 if self.name == "tiff_jpeg" and photo in (2, 6)
                    else 1)
        try:
            if spp > MAX_SAMPLESPERPIXEL:
                raise _Declined("Invalid value for samples per pixel")
            if spp < len(bps):
                bps = bps[:spp]
            elif spp > len(bps) and len(bps) == 1:
                bps = bps * spp
        except TypeError:
            raise _Declined("samples per pixel") from None
        if len(bps) != spp:
            raise _Declined("unknown data organization")
        self.bps = bps
        key = (d.order, photo, fmt, fillorder, bps, extra)
        try:
            self.mode, rawmode = OPEN_INFO[key]
        except (KeyError, TypeError):
            raise _Declined(f"unknown pixel mode {key[1:]}") from None
        xres, yres = d.get(282, 1), d.get(283, 1)
        if xres and yres and d.get(296) == 3 and (
                isinstance(xres, (str, bytes))
                or isinstance(yres, (str, bytes))):
            raise _Declined("resolution")        # a TypeError in _setup
        self.libtiff = self.name != "raw"
        if self.libtiff:
            if fillorder == 2:
                key = key[:3] + (1,) + key[4:]
                self.mode, rawmode = OPEN_INFO[key]
            if photo == 6 and self.name == "jpeg" and self.planar == 1:
                rawmode = "RGB"
            elif rawmode == "I;16":
                rawmode = "I;16N"
            elif rawmode.endswith((";16B", ";16L")):
                rawmode = rawmode[:-1] + "N"
            self.tiles = None
        else:
            self.tiles = self._raw_tiles(rawmode)
        self.rawmode = rawmode
        if self.mode in ("P", "PA"):
            cmap = d.get(320)
            if cmap is None:
                raise _Declined("no ColorMap for a palette")
            try:
                self.palette = bytes((b // 256) & 255 for b in cmap)
            except TypeError:
                raise _Declined("ColorMap") from None
        orientation = d.get(274)
        self.orientation = orientation if orientation in range(2, 9) else 1
        if W <= 0 or H <= 0:
            raise _Declined("not identified by this driver")
        check_pixels(W, H, path, "TIFF (Pillow)")

    def _raw_tiles(self, rawmode: str) -> list:
        """_setup's tiles for Pillow's raw decoder: (offset, (x0, y0, x1,
        y1), raw mode, stride)."""
        d, W, H = self.dir, self.W, self.H
        if 273 in d.tags:
            offsets, h, w = d.tags[273], d.get(278, H), W
        elif 324 in d.tags:
            offsets, w, h = d.tags[324], d.get(322), d.get(323)
            if not isinstance(w, int) or not isinstance(h, int):
                _refuse(self.path, "tile sizes that are not integers "
                                   "(Pillow raises \"Invalid tile "
                                   "dimensions\")")
        else:
            raise _Declined("unknown data organization")
        if isinstance(offsets, (int, float)):
            offsets = (offsets,)
        tiles, x, y, layer = [], 0, 0, 0
        try:
            if w == W and h == H and self.planar != 2:
                offsets = offsets[-1:]
            for offset in offsets:
                stride = w * sum(self.bps) / 8 if x + w > W else 0
                tile_rawmode = rawmode
                if self.planar == 2:
                    tile_rawmode = rawmode[layer]
                    stride /= self.bps_count
                tiles.append((offset, (x, y, min(x + w, W), min(y + h, H)),
                              tile_rawmode, int(stride)))
                x += w
                if x >= W:
                    x, y = 0, y + h
                    if y >= H:
                        y = 0
                        layer += 1
        except (TypeError, IndexError):      # turned into a SyntaxError
            raise _Declined("tiles") from None
        return tiles

    # ---------------------------------------------------------------- load
    def read(self) -> np.ndarray:
        """imageio's array of the file as (H, W, C) (module docstring)."""
        if self.mode in ("P", "PA") and len(self.palette) > 768:
            _refuse(self.path, f"a ColorMap of {len(self.palette)} values "
                               "(Pillow: invalid palette size)")
        if self.libtiff:
            img = self._load_libtiff()
        else:
            img = self._load_raw()
        img = orient(img, self.orientation)     # load_end's exif_transpose
        if self.mode == "P":
            lut = np.zeros((256, 3), np.uint8)
            n = len(self.palette) // 3
            pal = np.frombuffer(self.palette, np.uint8)
            lut[:n] = pal[:3 * n].reshape(3, n).T
            return lut[img[..., 0]]
        return img

    def decode(self) -> np.ndarray:
        """The port's samples: :meth:`read`'s array, a CMYK image's inks
        made RGB as Pillow's ``convert("RGB")`` makes them
        (``tiff.cmyk_to_rgb``, the port's CMYK rule)."""
        img = self.read()
        return T.cmyk_to_rgb(img) if self.mode == "CMYK" else img

    def _image(self) -> np.ndarray:
        """Pillow's freshly made image (zeros) as imageio's array."""
        img = np.zeros((self.H, self.W, _CHANNELS[self.mode]),
                       _DTYPE.get(self.mode, np.uint8))
        if self.mode == "LAB":
            img[...] = _LAB_OFFSET
        return img

    def _load_raw(self) -> np.ndarray:
        """ImageFile.load: each tile (in file order, consecutive ones that
        differ only by their offset dropped but the last) through the raw
        decoder: rows of (width * bits + 7) // 8 bytes, ``stride`` apart
        where the tile runs past the image's right edge; a tile whose data
        the file does not hold fails ("image file is truncated")."""
        path = self.path
        tiles = sorted(self.tiles, key=lambda t: t[0])
        kept = [t for k, t in enumerate(tiles) if k + 1 == len(tiles) or
                t[1:] != tiles[k + 1][1:]]
        img = self._image()
        for offset, (x0, y0, x1, y1), rawmode, stride in kept:
            if not all(isinstance(v, int) for v in (offset, x0, y0, x1, y1)):
                _refuse(path, "a tile offset or extent that is not an "
                              "integer (Pillow's decoder raises)")
            if rawmode not in _VALID[self.mode]:
                _refuse(path, f"no unpacker of raw mode {rawmode!r} for "
                              f"mode {self.mode} (Pillow: unknown raw mode "
                              "for given image mode)")
            w, h = x1 - x0, y1 - y0
            if w <= 0 or h <= 0 or x1 > self.W or y1 > self.H:
                _refuse(path, "a tile outside the image (Pillow: tile "
                              "cannot extend outside image)")
            bits = UNPACKERS[rawmode][0]
            row = (w * bits + 7) // 8
            step = stride or row
            if stride and stride < row:
                _refuse(path, f"a stride of {stride} bytes for rows of {row} "
                              "(Pillow's raw decoder: bad configuration)")
            need = (h - 1) * step + row
            if offset + need > len(self.data):
                _refuse(path, f"tile data at {offset} runs past the end of "
                              "the file (Pillow: image file is truncated)")
            flat = np.frombuffer(self.data, np.uint8, need, offset)
            rows = np.lib.stride_tricks.as_strided(flat, (h, row), (step, 1))
            self._put(img, rawmode, rows, w, y0, x0)
        return img

    def _put(self, img, rawmode, rows, w, y0, x0):
        """Unpack ``rows`` (h, bytes) of ``w`` pixels into the image at
        (y0, x0): a whole pixel, or one band of a separate plane."""
        h = rows.shape[0]
        if rawmode in _BANDS.get(self.mode, ()):
            c = _BANDS[self.mode][rawmode]
            v = rows[:, :w]
            img[y0:y0 + h, x0:x0 + w, c] = \
                v ^ _LAB_OFFSET[c] if self.mode == "LAB" else v
            return
        img[y0:y0 + h, x0:x0 + w] = unpack(rawmode, rows, w)

    # ------------------------------------------------------------- libtiff
    def _load_libtiff(self) -> np.ndarray:
        """_load_libtiff: libtiff opens the file itself and reads its first
        directory (``viz/libtiff.directory_checks``; the first of a
        repeated tag), whose size must be Pillow's; then YCbCr through the
        RGBA interface, the rest strip by strip or tile by tile."""
        path, who = self.path, "Pillow"
        if self.rawmode not in _VALID[self.mode]:
            _refuse(path, f"no unpacker of raw mode {self.rawmode!r} for mode "
                          f"{self.mode} (Pillow: unknown raw mode for given "
                          "image mode)")
        r = T._Reader(self.data, path, libtiff=True)
        tags = r.tags
        L.directory_checks(r, tags, path, who)
        W, H = T._one(tags, T._WIDTH, 0), T._one(tags, T._LENGTH, 0)
        if (W, H) != (self.W, self.H):
            _refuse(path, f"libtiff reads {W} x {H} pixels, Pillow "
                          f"{self.W} x {self.H} (decoder error -2)")
        compression = T._one(tags, T._COMPRESSION, 1)
        photometric = T._one(tags, T._PHOTOMETRIC, None)
        planar = T._one(tags, T._PLANAR, 1)
        spp = T._one(tags, T._SAMPLES, 1)
        bits = T._one(tags, T._BITS, 1)
        fmt = T._one(tags, T._SAMPLE_FORMAT, 1)
        if compression in UNCONFIGURED:
            _refuse(path, f"libtiff: {UNCONFIGURED[compression]} compression "
                          "support is not configured (decoder error -2)")
        if compression in UNREAD_COMPRESSION:
            _refuse(path, f"compression {compression} "
                          f"({UNREAD_COMPRESSION[compression]}): libtiff "
                          "decodes it for Pillow, the port has no decoder "
                          "for it")
        if compression in L.SGILOG:
            _refuse(path, "libtiff: Inappropriate photometric interpretation "
                          f"{photometric} for SGILog compression (decoder "
                          "error -2)")
        if photometric == 6 and planar == 1 and spp != 3 \
                and compression != 7:
            _refuse(path, "libtiff: YCbCr with "
                          f"{spp} samples a pixel: Cannot handle zero strip "
                          "size (decoder error -2)")
        if photometric == 6 and not (compression == 7 and planar == 1):
            return self._rgba(r, tags, compression, planar, spp, bits)
        if compression in L.FAX and bits != 1:
            _refuse(path, "libtiff: Bits/sample must be 1 for Group 3/4 "
                          "encoding/decoding (decoder error -2)")
        bands = _CHANNELS[self.mode] if planar == 2 else 1
        if planar == 2 and bands > 1 and bits not in (8, 16):
            _refuse(path, f"separate planes of {bits}-bit samples (decoder "
                          "error -2)")
        img = self._image()
        contig = spp if planar != 2 else 1
        predictor = T._one(tags, T._PREDICTOR, 1) \
            if compression in L.PREDICTED else 1
        tiled = T._TILE_WIDTH in tags
        blks = L.blocks(tags, W, H, spp if planar == 2 else 1, path, who)
        row_bytes = (blks[0][5] * contig * bits + 7) // 8
        ubits = UNPACKERS[self.rawmode][0]
        rps = T._one(tags, T._ROWS_PER_STRIP, 0xFFFFFFFF)
        if tiled and row_bytes * blks[0][4] * blks[0][6] >= 0x7FFFFFFF \
                or not tiled and 0x7FFFFFFF < rps < 0xFFFFFFFF:
            _refuse(path, "a tile past 2^31 bytes, or RowsPerStrip past "
                          "2^31 (Pillow: decoder error -9)")
        if not tiled and row_bytes * bands != (W * ubits + 7) // 8:
            _refuse(path, f"rows of {row_bytes} bytes in {bands} planes for "
                          f"raw mode {self.rawmode} (decoder error -2)")
        L.predictor_checks(predictor, bits, fmt, path, who)
        blks = [b for b in blks if b[1] < bands]
        fax = L.fax_blocks(r, tags, blks, compression, path, who,
                           strict=True) if compression in L.FAX else None
        for k, (i, p, y, x, rows, run, depth) in enumerate(blks):
            if compression == 7:
                buf = self._jpeg(r, tags, i, rows, run, contig, H - y, path)
            elif fax is not None:
                buf = fax[k]
            else:
                buf = L.strip_bytes(r, i, tags, compression,
                                    depth * rows * row_bytes, path, who,
                                    strict=True)
            if bits >= 8:
                buf = L.native_rows(buf, rows, run, contig, bits, fmt,
                                    r.order, predictor, path, who)
            flat = np.ascontiguousarray(buf).reshape(-1)
            h, w = min(rows, H - y), min(run, W - x)
            if bands > 1:
                self._plane(img, flat, row_bytes, h, w, y, x, p, bits)
                continue
            need = (h - 1) * row_bytes + (w * ubits + 7) // 8
            if need > flat.size:
                _refuse(path, f"raw mode {self.rawmode} reads past the tile "
                              "(Pillow's unpacker runs into memory the tile "
                              "does not hold)")
            at = np.lib.stride_tricks.as_strided(
                flat, (h, (w * ubits + 7) // 8), (row_bytes, 1))
            self._put(img, self.rawmode, at, w, y, x)
        if bands > 3 and self.mode == "RGBA":
            extra = list(tags.get(T._EXTRA, ()))
            if not extra and spp > 3:
                extra = [0]        # libtiff: non-colour channels unspecified
            if extra and extra[0] in (0, 1):
                img = _unpremultiply(img)
        return img

    def _plane(self, img, flat, row_bytes, h, w, y, x, p, bits):
        """Separate plane p copied into byte p of Pillow's 4-byte pixel, as
        the RGBA unpacker "R", "G", "B" or "A" copies it (";16N": the high
        byte), which shows in imageio's array as ``_PIXEL_BYTES`` says."""
        c = _PIXEL_BYTES[self.mode][p]
        if c is None:
            return
        rows = np.lib.stride_tricks.as_strided(flat, (h, row_bytes),
                                               (row_bytes, 1))
        v = rows[:, :w] if bits == 8 else rows[:, 1:2 * w:2]
        img[y:y + h, x:x + w, c] = \
            v ^ _LAB_OFFSET[c] if self.mode == "LAB" else v

    def _jpeg(self, r, tags, i, rows, run, contig, left, path):
        """A JPEG strip or tile through libjpeg (``libtiff.jpeg_strip``),
        as libtiff's JPEG codec checks it: the stream's size is the
        segment's (a strip: its rows, the last one those left); four
        components are CMYK as stored (libtiff asks for no conversion; the
        decoder gives them inverted, as Pillow reads a JPEG file's)."""
        px = L.jpeg_strip(r, i, tags, path, "Pillow",
                          ycc=T._one(tags, T._PHOTOMETRIC, 0) == 6)
        seg = rows if T._TILE_WIDTH in tags else min(rows, left)
        if px.shape[:2] != (seg, run) or px.shape[2] != contig:
            _refuse(path, f"JPEG strip or tile {i} of {px.shape[1]} x "
                          f"{px.shape[0]} pixels, {px.shape[2]} components, "
                          f"where libtiff expects {run} x {seg}, {contig} "
                          "(decoder error -2)")
        if contig == 4:         # the decoder's inverted CMYK, as stored
            px = 255 - px
        out = np.zeros((rows, run * contig), np.uint8)
        out[:seg] = px.reshape(seg, run * contig)
        return out.reshape(-1)

    def _rgba(self, r, tags, compression, planar, spp, bits):
        """YCbCr read as RGBA (_decodeAsRGBA): libtiff's TIFFRGBAImageGet,
        as OpenCV's RGBA reads do (``libtiff.rgba_samples`` and
        ``libtiff.rgba``), the alpha dropped."""
        path, who = self.path, "Pillow"
        sub = tuple(tags.get(T._YCBCR_SUBSAMPLING, (2, 2)))[:2]
        if bits != 8 or spp != 3 or sub not in (
                (1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)) \
                or planar == 2 and sub != (1, 1):
            _refuse(path, f"YCbCr of {spp} samples of {bits} bits, "
                          f"sub-sampling {sub} (libtiff's TIFFRGBAImageBegin:"
                          " Can not handle format; decoder error -2)")
        if compression in L.FAX:
            _refuse(path, "libtiff: Bits/sample must be 1 for Group 3/4 "
                          "encoding/decoding (decoder error -2)")
        samples = L.rgba_samples(r, tags, self.W, self.H, spp, bits,
                                 compression, planar, 1, sub, False, path,
                                 who)
        rgb = L.rgba(samples, tags, 6, bits, spp, [], path, who)
        return np.ascontiguousarray(rgb)


def _unpremultiply(px: np.ndarray) -> np.ndarray:
    """Pillow's "RGBa" unpacker: premultiplied RGBA -> RGBA, each colour
    min(255, c * 255 // a); a pixel of alpha 0 all zero."""
    a = px[..., 3:].astype(np.int32)
    c = np.minimum(px[..., :3].astype(np.int32) * 255 // np.maximum(a, 1),
                   255)
    out = np.concatenate([np.where(a == 255, px[..., :3], c), a], -1)
    return np.where(a == 0, 0, out).astype(np.uint8)


def unpack(rawmode: str, rows: np.ndarray, w: int) -> np.ndarray:
    """Pillow's unpacker of ``rawmode`` over (h, bytes) rows -> (h, w, C)
    values of imageio's array (uint8 channels, or one word)."""
    bits, kind, arg = UNPACKERS[rawmode]
    h = rows.shape[0]
    rows = np.ascontiguousarray(rows[:, :(w * bits + 7) // 8])
    if kind == "bits":
        depth, inverted, reverse, scaled = arg
        if reverse:
            rows = T._REVERSED_BITS[rows]
        v = T._unpack_bits(rows, h, w, depth)
        if inverted:
            v = ((1 << depth) - 1) - v
        if scaled:
            v = v * np.uint8(255 // ((1 << depth) - 1))
        return v[..., None]
    if kind == "bytes":
        channels, reverse, inverted = arg
        px = rows.reshape(h, w, bits // 8)[..., list(channels)]
        if reverse:
            px = T._REVERSED_BITS[px]
        return 255 - px if inverted else px
    if kind == "hi16":
        n, channels, big = arg
        return rows.reshape(h, w, n, 2)[..., :channels, 0 if big else 1]
    if kind == "alpha":
        size, n, big = arg
        return _unpremultiply(rows.reshape(h, w, n, size)[
            ..., :4, 0 if big or size == 1 else 1])
    if kind == "i12":
        v = T._unpack_bits(rows, h, w * 12, 1).reshape(h, w, 12)
        weights = (1 << np.arange(11, -1, -1)).astype(np.uint16)
        return (v.astype(np.uint16) * weights).sum(-1, dtype=np.uint16)[
            ..., None]
    code, reverse = arg
    if reverse:
        rows = T._REVERSED_BITS[rows]
    return rows.view(code).reshape(h, w, 1)


def open_tiff(data: bytes, path: str = ""):
    """The TIFF as Pillow's ``Image.open`` opens it, or None where it
    declines (imageio then tries its next plugin); raises ``ValueError``
    where opening fails in a way that makes imageio fail."""
    try:
        return PillowTiff(data, path)
    except _Declined:
        return None
