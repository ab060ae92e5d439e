"""JPEG 2000 textures (a JP2 file or a raw J2K codestream), read as imageio
reads them for the JAX package's ``apps/retarget._find_texture``: through
Pillow's ``Jpeg2KImagePlugin``, which takes the image's size and mode from
the header, and OpenJPEG 2.5, which decodes the codestream tile by tile for
Pillow's ``Jpeg2KDecode.c`` to unpack.

* The mode, as Pillow chooses it. A raw codestream: from SIZ, L (or I;16
  past 8 bits), LA, RGB or RGBA by its component count. A JP2 file: from
  its ``jp2h`` box (``ihdr``'s count and depth; CMYK where a ``colr`` box
  names enumerated colour space 12; P or PA where a ``pclr`` box of 8-bit
  columns follows ``ihdr`` of a grey image, its palette built as Pillow's
  ``ImagePalette.getcolor`` builds it, equal colours kept once); ``res``
  read as Pillow reads it.
* The colour space, as OpenJPEG takes it from the first ``colr`` box
  (sRGB, grey, sYCC, e-sYCC, CMYK; any other, an ICC profile or a raw
  codestream: unspecified, which OpenJPEG takes for sYCC where the first
  component is whole and the second or third sub-sampled, and Pillow
  otherwise reads as grey for 1-2 components, else sRGB),
  and its checks: the signature box, then ``ftyp``, then ``jp2h`` (with
  an ``ihdr``; its ``colr``, ``pclr``, ``cmap`` and ``cdef`` well formed)
  before ``jp2c``, no box of undefined length before the codestream.
  ``cdef`` and ``cmap`` change nothing: OpenJPEG applies neither when it
  decodes tile by tile.
* The codestream, from ``jp2c`` to the end of the file, goes to the host
  library (``csrc/nm_jp2.cpp`` through ``data/native.jp2_decode``), which
  decodes it and unpacks it into the mode as Pillow does; the header's size
  must be the codestream's.
* What imageio makes of the mode: P through its palette (RGB, or RGBA for
  a 4-column palette); PA, L, LA, I;16, RGB, RGBA and CMYK as they are.
  A CMYK image is then made RGB as Pillow's ``convert("RGB")`` does, the
  rule of a CMYK JPEG or TIFF (``ROADMAP.md`` Queue 3).

As elsewhere in ``viz/image_files.py``, a 2-D result is (H, W, 1).
"""
from __future__ import annotations

import struct

import numpy as np

from ..data import native
from .pixels import check_pixels

SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
CODESTREAM = b"\xff\x4f\xff\x51"
# Pillow's modes and OpenJPEG's colour spaces, numbered as nm_jp2_decode
# takes them
MODES = ("L", "P", "PA", "I;16", "LA", "RGB", "RGBA", "CMYK")
SPACES = {16: 1, 17: 2, 18: 3, 24: 4, 12: 5}   # enumcs -> colour space


def _fail(path: str, what: str):
    raise ValueError(f"{path}: JPEG 2000: {what}")


class _Boxes:
    """Pillow's ``BoxReader`` over ``data[start:end]`` (``end`` None: no
    length known), raising ``ValueError`` where it raises."""

    def __init__(self, data: bytes, start: int, end, path: str):
        self.data, self.pos, self.end, self.path = data, start, end, path
        self.remaining = -1

    def _can_read(self, n: int) -> bool:
        if self.end is not None and self.pos + n > self.end:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def read(self, fmt: str):
        n = struct.calcsize(fmt)
        if not self._can_read(n) or self.pos + n > len(self.data):
            _fail(self.path, "the header ends inside a box")
        out = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += n
        if self.remaining > 0:
            self.remaining -= n
        return out

    def sub(self) -> "_Boxes":
        n = self.remaining
        if not self._can_read(n) or self.pos + n > len(self.data):
            _fail(self.path, "the header ends inside a box")
        box = _Boxes(self.data, self.pos, self.pos + n, self.path)
        self.pos += n
        self.remaining = 0
        return box

    def has_next(self) -> bool:
        return self.end is None or self.pos + self.remaining < self.end

    def next_type(self) -> bytes:
        if self.remaining > 0:
            self.pos += self.remaining
        self.remaining = -1
        lbox, tbox = self.read(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.read(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            _fail(self.path, f"a {tbox!r} box of length {lbox}")
        self.remaining = lbox - hlen
        return tbox


class _Palette:
    """Pillow's ``ImagePalette`` as ``getcolor`` fills it: each new colour
    at index len(bytes) // len(mode), overwriting where that index is
    already taken; at most 256 colours."""

    def __init__(self, mode: str, path: str):
        self.mode, self.path = mode, path
        self.bytes, self.colors = bytearray(), {}

    def getcolor(self, color: tuple) -> None:
        if self.mode == "RGB" and len(color) == 4:
            if color[3] != 255:
                _fail(self.path, "a palette of RGBA colours Pillow cannot "
                                 "add to an RGB palette")
            color = color[:3]
        elif self.mode == "RGBA" and len(color) == 3:
            color += (255,)
        if color in self.colors:
            return
        n = len(self.mode)
        index = len(self.bytes) // n
        if index >= 256:
            _fail(self.path, "a palette of more than 256 colours (Pillow "
                             "cannot allocate them)")
        self.colors[color] = index
        if index * n < len(self.bytes):
            self.bytes[index * n:index * n + n] = bytes(color)
        else:
            self.bytes += bytes(color)

    def table(self) -> np.ndarray:
        """(256, 3 or 4) uint8: the entries Pillow's image gets, the rest
        black (and opaque)."""
        n = len(self.mode)
        count = len(self.bytes) // n
        table = np.zeros((256, n), np.uint8)
        if n == 4:
            table[:, 3] = 255
        table[:count] = np.frombuffer(bytes(self.bytes[:count * n]),
                                      np.uint8).reshape(count, n)
        return table


def _pillow_header(data: bytes, path: str):
    """``Jpeg2KImagePlugin._parse_jp2_header``: (width, height, mode,
    palette or None)."""
    top = _Boxes(data, 12, None, path)
    header = None
    while top.has_next():
        tbox = top.next_type()
        if tbox == b"jp2h":
            header = top.sub()
            break
        if tbox == b"ftyp":
            top.read(">4s")
    size = mode = nc = None
    palette = None
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.read(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            elif nc in (1, 2, 3, 4):
                mode = ("L", "LA", "RGB", "RGBA")[nc - 1]
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.read(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.read(">HB")
            depths = header.read(">" + "B" * npc)
            if max(depths, default=0) <= 8:
                palette = _Palette("RGBA" if npc == 4 else "RGB", path)
                for _ in range(ne):
                    palette.getcolor(header.read(">" + "B" * npc))
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.sub()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.read(">HHHHBB")
                    break
    if size is None or mode is None:
        _fail(path, "a malformed JP2 header (no ihdr box giving a mode)")
    return size[0], size[1], mode, palette


def _box(data: bytes, pos: int, end: int, path: str):
    """(type, start of contents, end of box) of the box at ``pos``, as
    OpenJPEG reads box headers (a length of 0: to ``end``)."""
    if pos + 8 > end:
        _fail(path, "a JP2 box header past the end of its parent")
    lbox, tbox = struct.unpack_from(">I4s", data, pos)
    hlen = 8
    if lbox == 1:
        if pos + 16 > end:
            _fail(path, "a JP2 box header past the end of its parent")
        lbox, hlen = struct.unpack_from(">Q", data, pos + 8)[0], 16
    if lbox == 0:
        lbox = end - pos
    if lbox < hlen:
        _fail(path, f"a {tbox!r} box of length {lbox}")
    return tbox, pos + hlen, pos + lbox


def _openjpeg_header(data: bytes, path: str):
    """OpenJPEG's reading of the boxes before the codestream: (the
    codestream's offset, the colour space of the first ``colr``)."""
    pos, n, state = 12, len(data), 0
    space = 0
    while True:
        tbox, body, end = _box(data, pos, n, path)
        if tbox == b"jp2c":
            if state < 2:
                _fail(path, "the codestream box comes before the jp2h box")
            return body, space
        if struct.unpack_from(">I", data, pos)[0] == 0:
            _fail(path, f"a {tbox!r} box of undefined length")
        if end > n:
            _fail(path, f"the {tbox!r} box runs past the end of the file")
        if state == 0:
            if tbox != b"ftyp":
                _fail(path, "the ftyp box must follow the signature box")
            if end - body < 8 or (end - body) % 4:
                _fail(path, "an ftyp box of bad length")
            state = 1
        elif tbox == b"jp2h":
            space = _openjpeg_jp2h(data, body, end, path)
            state = 2
        pos = end


def _openjpeg_jp2h(data: bytes, pos: int, end: int, path: str) -> int:
    """The checks of OpenJPEG's jp2h sub-box readers; the colour space."""
    space, seen = None, set()
    npc = None
    while pos < end:
        tbox, body, box_end = _box(data, pos, end, path)
        if struct.unpack_from(">I", data, pos)[0] == 0:
            _fail(path, f"a {tbox!r} box of undefined length in jp2h")
        if box_end > end:
            _fail(path, "a box inside jp2h runs past it")
        size = box_end - body
        if tbox == b"ihdr" and "ihdr" not in seen:
            if size != 14:
                _fail(path, "an ihdr box of bad size")
            if not 1 <= struct.unpack_from(">H", data, body + 8)[0] <= 16384:
                _fail(path, "an ihdr box with a bad component count")
        elif tbox == b"colr" and "colr" not in seen:
            if size < 3:
                _fail(path, "a colr box of bad size")
            meth = data[body]
            if meth == 1:
                if size != 7:
                    _fail(path, "a colr box of bad size")
                space = SPACES.get(struct.unpack_from(">I", data,
                                                      body + 3)[0], 0)
            else:
                space = 0
        elif tbox == b"pclr":
            if "pclr" in seen or size < 3:
                _fail(path, "a bad or second pclr box")
            ne, npc = struct.unpack_from(">HB", data, body)
            if not 1 <= ne <= 1024 or npc == 0 or size < 3 + npc:
                _fail(path, "a pclr box of bad size")
            widths = [min(4, ((b & 0x7F) + 8) // 8)
                      for b in data[body + 3:body + 3 + npc]]
            if size < 3 + npc + ne * sum(widths):
                _fail(path, "a pclr box of bad size")
        elif tbox == b"cmap":
            if npc is None or "cmap" in seen:
                _fail(path, "a cmap box without a pclr box before it")
            if size < 4 * npc:
                _fail(path, "a cmap box of bad size")
        elif tbox == b"cdef":
            if size < 2:
                _fail(path, "a cdef box of bad size")
            count = struct.unpack_from(">H", data, body)[0]
            if "cdef" in seen or count == 0 or size < 2 + 6 * count:
                _fail(path, "a bad or second cdef box")
        seen.add(tbox.decode("latin-1").strip())
        pos = box_end
    if "ihdr" not in seen:
        _fail(path, "the jp2h box has no ihdr box")
    return 0 if space is None else space


def _pillow_codestream_mode(data: bytes, path: str):
    """``Jpeg2KImagePlugin._parse_codestream``: (width, height, mode)."""
    if len(data) < 6:
        _fail(path, "the codestream ends in its SIZ marker")
    lsiz = struct.unpack_from(">H", data, 4)[0]
    siz = data[4:4 + lsiz]
    if len(siz) < 38:
        _fail(path, "the codestream ends in its SIZ marker")
    _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(
        ">HHIIIIIIIIH", siz)
    if csiz == 1:
        if len(siz) < 39:
            _fail(path, "the codestream ends in its SIZ marker")
        mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = ("LA", "RGB", "RGBA")[csiz - 2]
    else:
        _fail(path, f"{csiz} components (Pillow reads 1-4)")
    return xsiz - xosiz, ysiz - yosiz, mode


def decode_jpeg2000(data: bytes, path: str = "") -> np.ndarray:
    """A JP2 file's or J2K codestream's samples as imageio reads them:
    (H, W, C) uint8 (C = 1 L, 2 LA or PA, 3 RGB, P and CMYK made RGB, 4
    RGBA) or (H, W, 1) uint16 (I;16). Raises ``ValueError`` naming what it
    cannot read."""
    from .tiff import cmyk_to_rgb
    palette = None
    if data.startswith(SIGNATURE):
        width, height, mode, palette = _pillow_header(data, path)
        start, space = _openjpeg_header(data, path)
        stream = data[start:]
    else:
        width, height, mode = _pillow_codestream_mode(data, path)
        stream, space = data, 0
    if width <= 0 or height <= 0:
        _fail(path, f"an image of {width} x {height} pixels")
    check_pixels(width, height, path, "JPEG 2000")
    try:
        img = native.jp2_decode(stream, MODES.index(mode), space, width,
                                height)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if mode == "P":
        img = palette.table()[img[..., 0]]
    elif mode == "CMYK":
        img = cmyk_to_rgb(img)
    return img
