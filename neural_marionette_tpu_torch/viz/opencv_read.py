"""Textures as imageio's OpenCV plugin reads them: the files that
``image_files.imageio_route`` hands to OpenCV first (``.pbm``, ``.pfm``,
``.hdr``, ``.pic``, ``.sr``, ``.pxm``, ``.exr``, ``.dip``) or that no
other plugin opens (Radiance HDR under any name). imageio calls
``cv2.imreadmulti(path, 0, 1, IMREAD_COLOR)`` and turns BGR into RGB
(imageio/plugins/opencv.py:67-122), so each file is (H, W, 3) uint8 RGB,
the first page or frame, as OpenCV 5.0.0's decoders and the codec
libraries it was built with (libpng 1.6.58, libjpeg-turbo 3.1.2, libwebp
0x0210, OpenJPEG 2.5.3, libtiff 4.7.1) read it; a grey float map alone is
(H, W, 1). The port's own decoders give the samples; this module adds
OpenCV's conversion to 8-bit BGR, its EXIF orientation and its refusals,
which name OpenCV's reasons.

* PNG: libpng's transforms as OpenCV sets them (16 bits cut to the high
  byte, palette and grey expanded, alpha stripped with no compositing).
* JPEG: libjpeg-turbo's BGR output (grey replicated); CMYK and YCCK
  through libjpeg's CMYK and OpenCV's own CMYK -> BGR; the whole file
  for arithmetic coding (no 64 KiB feed, which is Pillow's); lossless
  files refused (libjpeg-turbo converts no colour in lossless mode).
* WebP: the first frame, alpha dropped.
* PNG, JPEG, WebP and TIFF: the EXIF orientation (an ``eXIf`` chunk, an
  ``Exif`` APP1 segment, an ``EXIF`` chunk, the TIFF Orientation tag)
  applied as OpenCV's ApplyExifOrientation does.
* JPEG 2000 (:func:`_jpeg2000`): OpenJPEG's whole-image decode with the
  JP2 palette and channel definitions applied, then OpenCV's converters.
* TIFF (:func:`_tiff`): OpenCV's TiffDecoder header checks, then libtiff's
  RGBA interface (TIFFReadRGBAStrip / Tile), which OpenCV uses for 8-bit
  output, with libtiff's codecs (``viz/libtiff.py``): among them CCITT fax
  (T.4 1-D and 2-D, T.6, modified Huffman byte- and word-aligned) and
  SGILog (LogL16, LogLuv32, LogLuv24), decoded by the host library
  (``native.fax_decode``, ``native.sgilog_decode``).
* BMP (:func:`_bmp`) and GIF (:func:`_gif`): OpenCV's own decoders.
* PxM, PAM and PFM: ``texture_formats.pxm_opencv``, ``pam_opencv`` and
  ``pfm_opencv``; Radiance HDR: ``radiance.decode_radiance``; Sun raster:
  ``sunraster.decode_sun_opencv``.
* AVIF waits for the AV1 tables; OpenEXR is not built into that OpenCV
  (``image_files.opencv_reads`` does not take it).
"""
from __future__ import annotations

import struct

import numpy as np

from ..data import native
from . import libtiff as L
from . import tiff as T
from .jpeg2000 import CODESTREAM, SIGNATURE, _box, _openjpeg_header
from .pixels import orient
from .radiance import decode_radiance
from .sunraster import SUN_MAGIC, decode_sun_opencv
from .texture_formats import pam_opencv, pfm_opencv, pxm_opencv


def _fail(path: str, fmt: str, what: str):
    raise ValueError(f"{path}: {fmt} (OpenCV): {what}")


def _rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 -> (H, W, 3): grey replicated, alpha dropped."""
    if img.shape[-1] <= 2:
        return np.ascontiguousarray(np.repeat(img[..., :1], 3, -1))
    return np.ascontiguousarray(img[..., :3])


# --------------------------------------------------------------- EXIF
def exif_orientation(exif: bytes) -> int:
    """The Orientation (0x0112) of an EXIF block (a TIFF header and IFD0)
    as OpenCV's ExifReader reads it; 1 where there is none."""
    if len(exif) < 8 or exif[:4] not in (b"II*\x00", b"MM\x00*"):
        return 1
    o = "<" if exif[:2] == b"II" else ">"
    ifd = struct.unpack_from(o + "I", exif, 4)[0]
    if ifd + 2 > len(exif):
        return 1
    n = struct.unpack_from(o + "H", exif, ifd)[0]
    for i in range(n):
        at = ifd + 2 + 12 * i
        if at + 12 > len(exif):
            break
        if struct.unpack_from(o + "H", exif, at)[0] == 0x0112:
            return struct.unpack_from(o + "H", exif, at + 8)[0]
    return 1


def _png_exif(data: bytes) -> bytes:
    """The eXIf chunk before the image data, or b""."""
    pos = 8
    while pos + 8 <= len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        if kind in (b"IDAT", b"IEND"):
            break
        if kind == b"eXIf":
            return data[pos + 8:pos + 8 + n]
        pos += 12 + n
    return b""


def _jpeg_segments(data: bytes):
    """(marker, body) of each segment of a JPEG file before its first scan
    or frame header."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker in (0xFF, 0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 1 if marker == 0xFF else 2
            continue
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC) \
                or marker in (0xD9, 0xDA):
            return
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        yield marker, data[pos + 4:pos + 2 + n]
        pos += 2 + n


def _jpeg_exif(data: bytes) -> bytes:
    """The TIFF block of the first ``Exif`` APP1 segment, or b""."""
    for marker, body in _jpeg_segments(data):
        if marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            return body[6:]
    return b""


def _webp_exif(data: bytes) -> bytes:
    """The EXIF chunk of a WebP file, or b""."""
    pos = 12
    while pos + 8 <= len(data):
        kind = data[pos:pos + 4]
        n = int.from_bytes(data[pos + 4:pos + 8], "little")
        if kind == b"EXIF":
            return data[pos + 8:pos + 8 + n]
        pos += 8 + n + (n & 1)
    return b""


# ---------------------------------------------------------- PNG, JPEG, WebP
def _png(data: bytes, path: str) -> np.ndarray:
    from .image_files import _decode_png   # image_files imports this
    img = _decode_png(data, path)
    if img.dtype == np.uint16:             # png_set_strip_16
        img = (img >> 8).astype(np.uint8)
    return orient(_rgb(img), exif_orientation(_png_exif(data)))


def _jpeg_space(data: bytes, channels: int) -> str:
    """libjpeg-turbo's guess of a file's colour space (jdapimin.c
    default_decompress_parms, lossless mode): a JFIF APP0 means YCbCr, an
    Adobe APP14's transform 0 RGB or CMYK and another YCbCr or YCCK; with
    neither, three components are RGB and four CMYK."""
    jfif, adobe = False, None
    for marker, body in _jpeg_segments(data):
        if marker == 0xE0 and len(body) >= 14 and body[:5] == b"JFIF\x00":
            jfif = True
        if marker == 0xEE and len(body) >= 12 and body[:5] == b"Adobe":
            adobe = body[11]
    if channels == 1:
        return "grey"
    if channels == 3:
        return "YCbCr" if jfif or adobe not in (None, 0) else "RGB"
    return "YCCK" if adobe not in (None, 0) else "CMYK"


def _jpeg(data: bytes, path: str) -> np.ndarray:
    try:
        info = native.jpeg_info(data)
        space = _jpeg_space(data, info["channels"])
        if info["process"] == "lossless" and space not in ("RGB", "CMYK"):
            _fail(path, "JPEG", f"a lossless {space} file; libjpeg-turbo "
                                "converts no colour in lossless mode, and "
                                "OpenCV asks it for BGR")
        img = native.jpeg_decode(data, whole=True)
    except ValueError as e:
        if str(e).startswith(path):
            raise
        _fail(path, "JPEG", str(e).removeprefix("JPEG: "))
    if img.shape[-1] == 4:
        # libjpeg's CMYK (the port's samples are Pillow's, inverted), then
        # icvCvt_CMYK2BGR_8u_C4C3R: each of c, m, y to k - ((255 - c) * k
        # >> 8)
        c = 255 - img.astype(np.int32)
        k = c[..., 3:]
        img = (k - (((255 - c[..., :3]) * k) >> 8)).astype(np.uint8)
    return orient(_rgb(img), exif_orientation(_jpeg_exif(data)))


def _webp(data: bytes, path: str) -> np.ndarray:
    try:
        img = native.webp_decode(data)
    except ValueError as e:
        _fail(path, "WebP", str(e).removeprefix("WebP: "))
    return orient(_rgb(img), exif_orientation(_webp_exif(data)))


# --------------------------------------------------------------------- BMP
class _Stream:
    """OpenCV's RLByteStream: little-endian reads; past the end raises, as
    its "Unexpected end of input stream"."""

    def __init__(self, data: bytes, path: str):
        self.data, self.path, self.pos = data, path, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            _fail(self.path, "BMP", "Unexpected end of input stream")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def word(self) -> int:
        return int.from_bytes(self.take(2), "little")

    def dword(self) -> int:
        return int.from_bytes(self.take(4), "little", signed=True)


_BMP_RGB, _BMP_RLE8, _BMP_RLE4, _BMP_BITFIELDS = 0, 1, 2, 3


def _bmp(data: bytes, path: str) -> np.ndarray:
    """A BMP as OpenCV's BmpDecoder reads it for 3 channels. The header
    (a BITMAPINFOHEADER or later, or OS/2's 12 bytes): 1, 4, 8, 24, 32 bits
    uncompressed, 16 and 32 bits uncompressed or BI_BITFIELDS, RLE4 at 4
    bits and RLE8 at 8; compression past BI_BITFIELDS fails OpenCV's
    assertion; the 16-bit masks, read after the header's declared size,
    must be 5-5-5 or 5-6-5; 32-bit masks are read from a header of 56
    bytes or more (each field scaled to v * 255 // (2^width - 1)), and
    ignored with a shorter one (bytes B, G, R, X).
    The palette follows the header ((colours used, or 2^bits) x 4 bytes,
    the rest black), the pixels start at the file's offset. 5-bit fields
    shifted up by 3, 6-bit by 2 (no replication). Run-length codes as
    OpenCV runs them: skipped pixels (deltas, ends of line and of image)
    take palette entry 0; a run past the end of its row fails."""
    st = _Stream(data, path)
    st.take(10)
    offset = st.dword()
    size = st.dword()
    if size <= 0:
        _fail(path, "BMP", "a header size of 0 or past 2 GiB")
    palette = np.zeros((256, 3), np.uint8)        # B, G, R
    masks = None                                  # 32 bits: R, G, B
    if size >= 36:
        W, H = st.dword(), st.dword()
        bpp = st.dword() >> 16
        rle = st.dword()
        if not 0 <= rle <= _BMP_BITFIELDS:
            _fail(path, "BMP", f"compression {rle} (OpenCV's assertion "
                               "m_rle_code_ <= BMP_BITFIELDS)")
        st.take(12)
        used = st.dword()
        st.take(size - 36)
        ok = W > 0 and H != 0 and (
            bpp in (1, 4, 8, 24, 32) and rle == _BMP_RGB
            or bpp in (16, 32) and rle in (_BMP_RGB, _BMP_BITFIELDS)
            or bpp == 4 and rle == _BMP_RLE4 or bpp == 8 and rle == _BMP_RLE8)
        if not ok:
            _fail(path, "BMP", f"{bpp} bits a pixel under compression {rle} "
                               f"({W} x {H} pixels) is not read")
        if bpp <= 8:
            if not 0 <= used <= 256:
                _fail(path, "BMP", f"{used} palette colours")
            n = used or 1 << bpp
            pal = np.frombuffer(st.take(4 * n), np.uint8).reshape(n, 4)
            palette[:n] = pal[:, :3]
        elif bpp == 16 and rle == _BMP_BITFIELDS:
            r, g, b = st.dword(), st.dword(), st.dword()
            if (r, g, b) == (0x7C00, 0x3E0, 0x1F):
                bpp = 15
            elif (r, g, b) != (0xF800, 0x7E0, 0x1F):
                _fail(path, "BMP", f"16-bit masks {r:#x}, {g:#x}, {b:#x} "
                                   "(OpenCV reads 5-5-5 and 5-6-5)")
        elif bpp == 16:
            bpp = 15
        if bpp == 32 and rle == _BMP_BITFIELDS and size >= 56:
            masks = struct.unpack_from("<3I", data, 54)
    elif size == 12:
        W, H = st.word(), st.word()
        bpp = st.dword() >> 16
        rle = _BMP_RGB
        if not (W > 0 and H != 0 and bpp in (1, 4, 8, 24, 32)):
            _fail(path, "BMP", f"{bpp} bits a pixel is not read")
        if bpp <= 8:
            n = 1 << bpp
            palette[:n] = np.frombuffer(st.take(3 * n), np.uint8).reshape(
                n, 3)
    else:
        _fail(path, "BMP", f"a header of {size} bytes is not read")
    bottom_up, H = H > 0, abs(H)
    if W > T_MAX_SIDE or H > T_MAX_SIDE or W * H > T_MAX_PIXELS:
        _fail(path, "BMP", f"an image of {W} x {H} pixels, past OpenCV's "
                           "limits")
    if H * W * 3 >= 1 << 30:
        _fail(path, "BMP", "an image past OpenCV's BMP reader's 2^30 bytes")
    st.pos = offset
    if rle in (_BMP_RLE8, _BMP_RLE4):
        try:
            img = _bmp_rle(st, W, H, rle == _BMP_RLE4, palette)
        except _RunPastRow:
            _fail(path, "BMP", "a run past the end of its row (OpenCV's "
                               "decode_rle_bad)")
    else:
        pitch = ((W * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
        rows = np.frombuffer(st.take(pitch * H), np.uint8).reshape(H, pitch)
        if bpp <= 8:
            idx = np.unpackbits(rows, axis=1)[:, :W * bpp].reshape(
                H, W, bpp) if bpp < 8 else rows[:, :W, None]
            if bpp < 8:
                idx = (idx * (1 << np.arange(bpp - 1, -1, -1))).sum(-1)
            else:
                idx = idx[..., 0]
            img = palette[idx]
        elif bpp in (15, 16):
            t = rows[:, :2 * W].copy().view("<u2").astype(np.int32)
            if bpp == 15:
                bgr = [(t << 3) & 0xF8, (t >> 2) & 0xF8, (t >> 7) & 0xF8]
            else:
                bgr = [(t << 3) & 0xF8, (t >> 3) & 0xFC, (t >> 8) & 0xF8]
            img = np.stack(bgr, -1).astype(np.uint8)
        elif masks is not None:
            px = rows[:, :4 * W].copy().view("<u4").astype(np.int64)
            img = np.stack([_mask_field(px, m) for m in masks[::-1]], -1)
        else:
            img = rows[:, :W * (bpp // 8)].reshape(H, W, bpp // 8)[..., :3]
    if bottom_up:
        img = img[::-1]
    return np.ascontiguousarray(img[..., ::-1])


def _mask_field(px: np.ndarray, mask: int) -> np.ndarray:
    """A 32-bit bitfield's channel: its field scaled to 8 bits, v * 255 //
    (2^width - 1); 0 for an empty mask."""
    if not mask:
        return np.zeros(px.shape, np.uint8)
    shift = (mask & -mask).bit_length() - 1
    top = mask >> shift
    return (((px & mask) >> shift) * 255 // top).astype(np.uint8)


class _RunPastRow(Exception):
    """OpenCV's goto decode_rle*_bad: a run past the end of its row."""


def _bmp_rle(st: _Stream, W: int, H: int, rle4: bool,
             palette: np.ndarray) -> np.ndarray:
    """OpenCV's RLE8 / RLE4 loops: (H, W, 3) BGR, rows in file order. The
    position may rest at the end of a row; only FillUniColor (a run of
    RLE8, an end of line, a delta, the end of the image) moves on to the
    next row. A delta of RLE4 moves right alone; its end of image fills
    the row and reads on."""
    out = np.zeros((H, W, 3), np.uint8)
    x = y = 0

    def fill(count: int, colour) -> None:
        nonlocal x, y
        while True:
            end = min(x + count, W)
            out[y, x:end] = colour
            count -= end - x
            x = end
            if x >= W:
                x, y = 0, y + 1
                if y >= H:
                    return
            if count <= 0:
                return

    line_end_flag = 0
    while True:
        word = st.word()
        length, code = word & 255, word >> 8
        if length:                                 # a run
            if x + length > W:
                raise _RunPastRow
            if rle4:
                pair = palette[[code >> 4, code & 15]]
                out[y, x:x + length] = pair[np.arange(length) & 1]
                x += length
            else:
                prev = y
                fill(length, palette[code])
                line_end_flag = y - prev
                if y >= H:
                    break
        elif code > 2:                             # absolute: raw indices
            if x + code > W:
                raise _RunPastRow
            if rle4:
                raw = np.frombuffer(st.take((((code + 1) >> 1) + 1) & ~1),
                                    np.uint8)
                idx = np.stack([raw >> 4, raw & 15], -1).reshape(-1)
            else:
                idx = np.frombuffer(st.take((code + 1) & ~1), np.uint8)
            out[y, x:x + code] = palette[idx[:code]]
            x += code
            line_end_flag = 0
        elif rle4:                                 # end of line or image,
            shift = W - x                          # or a delta
            if code == 2:
                shift = st.byte()
                st.byte()
            fill(shift, palette[0])
            if y >= H:
                break
        else:
            shift, rows = W - x, H - y
            if code or not line_end_flag or shift < W:
                if code == 2:
                    shift, rows = st.byte(), st.byte()
                if code:
                    shift += rows * W
                fill(shift, palette[0])
            line_end_flag = 0
            if y >= H:
                break
    return out


# --------------------------------------------------------------------- GIF
def _gif(data: bytes, path: str) -> np.ndarray:
    """The first frame of a GIF as OpenCV 5's own GifDecoder reads it: on
    a canvas of the logical screen filled with the global table's
    background colour (black without a global table), which the frame's
    transparent index leaves as it is; each other index through the
    frame's table (the local one, else the global one), an index past the
    local table but within the global one through the global one. A frame
    outside the screen, an index past both tables, or no table at all
    fails OpenCV's assertions."""
    from .image_files import _gif_sub_blocks, _le   # image_files imports us
    if len(data) < 13:
        _fail(path, "GIF", "the header is cut short")
    sw, sh, flags = _le(data, 6, 2), _le(data, 8, 2), data[10]
    if sw == 0 or sh == 0:
        _fail(path, "GIF", f"a screen of {sw} x {sh} pixels")
    pos, gtable = 13, None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        if pos + n > len(data):
            _fail(path, "GIF", "Unexpected end of input stream")
        gtable = np.frombuffer(data, np.uint8, n, pos).reshape(-1, 3)
        if data[11] >= len(gtable):
            _fail(path, "GIF", "a background index past the global table")
        pos += n
    transparent = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            _fail(path, "GIF", "no image")
        kind = data[pos]
        pos += 1
        if kind == 0x21:
            if pos >= len(data):
                _fail(path, "GIF", "Unexpected end of input stream")
            label = data[pos]
            body, end = _gif_sub_blocks(data, pos + 1)
            if label == 0xF9 and len(body) >= 4:
                transparent = body[3] if body[0] & 1 else None
            pos = end
        elif kind == 0x2C:
            break
        else:
            _fail(path, "GIF", f"a block of kind {kind:#x}")
    if pos + 9 > len(data):
        _fail(path, "GIF", "Unexpected end of input stream")
    x0, y0, w, h = (_le(data, pos + 2 * i, 2) for i in range(4))
    flags = data[pos + 8]
    pos += 9
    if not (w > 0 and h > 0 and x0 + w <= sw and y0 + h <= sh):
        _fail(path, "GIF", "a frame outside the logical screen (OpenCV's "
                           "assertion left + width <= m_width)")
    table = gtable
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        if pos + n > len(data):
            _fail(path, "GIF", "Unexpected end of input stream")
        table = np.frombuffer(data, np.uint8, n, pos).reshape(-1, 3)
        pos += n
    if table is None:
        _fail(path, "GIF", "no colour table")
    if pos >= len(data):
        _fail(path, "GIF", "Unexpected end of input stream")
    mcs = data[pos]
    if not 2 <= mcs <= 8:
        _fail(path, "GIF", f"LZW minimum code size {mcs}")
    stream = _gif_sub_blocks(data, pos + 1)[0]
    try:
        idx = native.gif_unlzw(stream, mcs, w * h).reshape(h, w)
    except ValueError as e:
        _fail(path, "GIF", str(e).removeprefix("GIF: "))
    if flags & 0x40:
        order = np.concatenate([np.arange(s, h, d) for s, d in
                                ((0, 8), (4, 8), (2, 4), (1, 2))])
        rows = np.empty_like(idx)
        rows[order] = idx
        idx = rows
    lut = np.zeros((256, 3), np.uint8)
    known = np.zeros(256, bool)
    if gtable is not None:
        lut[:len(gtable)], known[:len(gtable)] = gtable, True
    lut[:len(table)], known[:len(table)] = table, True
    if transparent is not None:
        known[transparent] = True
    if not known[idx].all():
        _fail(path, "GIF", "an index past the colour tables (OpenCV's "
                           "assertion in code2pixel)")
    canvas = np.zeros((sh, sw, 3), np.uint8)
    if gtable is not None:
        canvas[:] = gtable[data[11]]
    frame = canvas[y0:y0 + h, x0:x0 + w]
    drawn = idx != transparent if transparent is not None else slice(None)
    frame[drawn] = lut[idx[drawn]]
    return canvas


# ---------------------------------------------------------------- JPEG 2000
# OpenJPEG's colour spaces (opj_jp2_decode's mapping of enumcs)
_UNKNOWN, _SRGB, _GREY, _SYCC, _EYCC, _CMYK = -1, 1, 2, 3, 4, 5
_SPACE_NAMES = {_EYCC: "e-YCC", _CMYK: "CMYK"}


def _jp2_boxes(data: bytes, path: str):
    """The jp2h boxes OpenJPEG applies after decoding: (enumcs or None,
    pclr (entries, sizes, signs) or None, cmap [(cmp, mtyp, pcol)] or None,
    cdef [(cn, typ, asoc)] or None)."""
    pos, n = 12, len(data)
    enumcs = pclr = cmap = cdef = None
    colr_seen = False
    while pos < n:
        tbox, body, end = _box(data, pos, n, path)
        if tbox == b"jp2c":
            break
        if tbox == b"jp2h":
            at = body
            while at < end:
                sub, sbody, send = _box(data, at, end, path)
                if sub == b"colr" and not colr_seen:
                    colr_seen = True
                    if data[sbody] == 1:
                        enumcs = struct.unpack_from(">I", data, sbody + 3)[0]
                elif sub == b"pclr":
                    ne, npc = struct.unpack_from(">HB", data, sbody)
                    b = data[sbody + 3:sbody + 3 + npc]
                    sizes = [(x & 0x7F) + 1 for x in b]
                    signs = [x >> 7 for x in b]
                    widths = [(s + 7) // 8 for s in sizes]
                    p = sbody + 3 + npc
                    entries = np.zeros((ne, npc), np.int64)
                    for i in range(ne):
                        for j in range(npc):
                            entries[i, j] = int.from_bytes(
                                data[p:p + widths[j]], "big")
                            p += widths[j]
                    pclr = (entries, sizes, signs)
                elif sub == b"cmap":
                    cmap = [struct.unpack_from(">HBB", data, sbody + 4 * i)
                            for i in range((send - sbody) // 4)]
                elif sub == b"cdef":
                    k = struct.unpack_from(">H", data, sbody)[0]
                    cdef = [list(struct.unpack_from(">HHH", data,
                                                    sbody + 2 + 6 * i))
                            for i in range(k)]
                at = send
        pos = end
    return enumcs, pclr, cmap, cdef


def _jpeg2000(data: bytes, path: str) -> np.ndarray:
    """A JP2 file or J2K codestream as OpenCV's Jpeg2KOpjDecoder reads it.
    Header: 1-4 components, none signed ("Component i/n is signed"), the
    largest precision at least 8 ("Precision < 8 not supported"). Decode:
    OpenJPEG's opj_decode, then (JP2) the colour space of the first colr
    box (16 sRGB, 17 grey, 18 sYCC, 24 e-sYCC, 12 CMYK, anything else
    unknown), the palette (pclr with cmap: each index clamped to the
    palette, the columns at their own precision) and the channel
    definitions (cdef: colour channels swapped to their association) as
    opj_jp2_decode applies them. Then every component must be whole and at
    the origin ("tiles are not supported"); unknown or unspecified spaces
    are taken for sRGB, which needs three components ("unsupported
    conversion from 1 components"); grey replicates the first; sYCC goes
    through cvtColor's YUV2BGR; e-sYCC and CMYK are refused ("Unsupported
    color space conversion"). Samples are shifted right by the header's
    largest precision less 8."""
    if data.startswith(SIGNATURE):
        start, _ = _openjpeg_header(data, path)
        enumcs, pclr, cmap, cdef = _jp2_boxes(data, path)
        stream = data[start:]
        space = {16: _SRGB, 17: _GREY, 18: _SYCC, 24: _EYCC,
                 12: _CMYK}.get(enumcs, _UNKNOWN)
    else:
        stream, space, pclr, cmap, cdef = data, 0, None, None, None
    try:
        info = native.jp2_info(stream)
    except ValueError as e:
        _fail(path, "JPEG 2000", str(e).removeprefix("JPEG 2000: "))
    comps = info["components"]
    if not 1 <= len(comps) <= 4:
        _fail(path, "JPEG 2000", f"{len(comps)} components (Unsupported "
                                 "number of components)")
    for i, (prec, sgnd, _, _) in enumerate(comps):
        if sgnd:
            _fail(path, "JPEG 2000", f"Component {i}/{len(comps)} is "
                                     "signed")
    max_prec = max(c[0] for c in comps)
    if max_prec < 8:
        _fail(path, "JPEG 2000", "Precision < 8 not supported")
    W, H = info["x1"] - info["x0"], info["y1"] - info["y0"]
    if W > T_MAX_SIDE or H > T_MAX_SIDE or W * H > T_MAX_PIXELS:
        _fail(path, "JPEG 2000", f"an image of {W} x {H} pixels, past "
                                 "OpenCV's limits")
    whole = all(c[2] == 1 and c[3] == 1 for c in comps)
    origin = info["x0"] == 0 and info["y0"] == 0
    if not whole:
        _fail(path, "JPEG 2000", "tiles are not supported (a sub-sampled "
                                 "component)")
    try:
        planes = [p for p in native.jp2_components(stream)]
    except ValueError as e:
        _fail(path, "JPEG 2000", str(e).removeprefix("JPEG 2000: "))
    if pclr is not None and cmap is not None:
        planes = _apply_pclr(planes, pclr, cmap, path)
    if cdef is not None:
        _check_cdef(cdef, len(planes), path)
        planes = _apply_cdef(planes, cdef)
    if space in _SPACE_NAMES:
        _fail(path, "JPEG 2000", "Unsupported color space conversion: "
                                 f"{_SPACE_NAMES[space]} -> BGR")
    if not origin:
        _fail(path, "JPEG 2000", "tiles are not supported (the image does "
                                 "not start at the origin)")
    shift = max_prec - 8
    if space == _GREY:
        chans = [planes[0]] * 3
    elif len(planes) < 3:
        _fail(path, "JPEG 2000", f"unsupported conversion from "
                                 f"{len(planes)} components to 3 for SRGB "
                                 "image decoding")
    else:
        chans = planes[:3]
    rgb = np.stack([(c >> shift).astype(np.uint8) for c in chans], -1)
    if space == _SYCC:
        rgb = _yuv_to_rgb(rgb)
    return rgb


def _apply_pclr(planes, pclr, cmap, path):
    """opj_jp2_check_color's cmap checks and opj_jp2_apply_pclr: each
    channel a component as it is, or a palette column indexed by it (each
    index clamped to the palette). The columns' precisions do not matter
    here: OpenCV shifts by the header's."""
    entries, sizes, _ = pclr
    nch = len(sizes)
    if len(cmap) < nch:
        _fail(path, "JPEG 2000", "a cmap box shorter than its palette")
    cmap = [list(c) for c in cmap[:nch]]
    used = [False] * nch
    for i, (cmp, mtyp, pcol) in enumerate(cmap):
        if cmp >= len(planes) or mtyp not in (0, 1) or pcol >= nch \
                or used[pcol] and mtyp == 1 or mtyp == 0 and pcol != 0 \
                or mtyp == 1 and pcol != i:
            _fail(path, "JPEG 2000", "a cmap box OpenJPEG refuses")
        used[pcol] = True
    if any(not u and c[1] != 0 for u, c in zip(used, cmap)):
        _fail(path, "JPEG 2000", "a palette column without a mapping")
    if len(planes) == 1 and not all(used):
        cmap = [[c[0], 1, i] for i, c in enumerate(cmap)]
    top = len(entries) - 1
    return [planes[cmp] if mtyp == 0 else
            entries[np.clip(planes[cmp], 0, top), pcol].astype(np.int32)
            for cmp, mtyp, pcol in cmap]


def _check_cdef(cdef, n, path):
    """opj_jp2_check_color's checks of the channel definitions."""
    for cn, _, asoc in cdef:
        if cn >= n or asoc not in (0, 65535) and asoc - 1 >= n:
            _fail(path, "JPEG 2000", "a cdef box naming a component past "
                                     "the image's")
    for c in range(n):
        if not any(d[0] == c for d in cdef):
            _fail(path, "JPEG 2000", "Incomplete channel definitions")


def _apply_cdef(planes, cdef):
    """opj_jp2_apply_cdef: each colour channel swapped to its association,
    the later definitions following the swap (the alpha flags it sets do
    not reach OpenCV's three channels)."""
    planes = list(planes)
    cdef = [list(d) for d in cdef]
    for i, (cn, typ, asoc) in enumerate(cdef):
        acn = asoc - 1
        if cn >= len(planes) or asoc in (0, 65535) or acn >= len(planes) \
                or cn == acn or typ != 0:
            continue
        planes[cn], planes[acn] = planes[acn], planes[cn]
        for d in cdef[i + 1:]:
            if d[0] == cn:
                d[0] = acn
            elif d[0] == acn:
                d[0] = cn
    return planes


def _yuv_to_rgb(yuv: np.ndarray) -> np.ndarray:
    """cvtColor(COLOR_YUV2BGR) of 8-bit samples (Y, U, V as OpenJPEG's
    first three components): OpenCV's 14-bit fixed point (U2B 33292, U2G
    -6472, V2G -9519, V2R 18678), saturated; returned as RGB."""
    y, u, v = (yuv[..., i].astype(np.int64) for i in range(3))
    u, v = u - 128, v - 128

    def descale(x):
        return (x + (1 << 13)) >> 14

    r = y + descale(v * 18678)
    g = y + descale(v * -9519 + u * -6472)
    b = y + descale(u * 33292)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# -------------------------------------------------------------------- TIFF
T_MAX_SIDE, T_MAX_PIXELS = 1 << 20, 1 << 30
_OPENCV_COMPRESSION = (1, 5, 7, 8, 32773, 32946) + L.FAX + L.SGILOG


def _tfail(path: str, what: str):
    _fail(path, "TIFF", what)


def _tiff(data: bytes, path: str) -> np.ndarray:
    """The first page of a TIFF as OpenCV reads it for ``IMREAD_COLOR``.

    OpenCV's header checks (TiffDecoder::readHeader): per-sample
    BitsPerSample and SampleFormat that differ fail libtiff's directory
    reading; more than four samples fail ("Unsupported number of
    channels"); past 8 bits, a photometric other than min-is-white, min-
    is-black and RGB (or 2 samples) is read as 8 bits; 4 bits only for a
    palette ("bitsperpixel value is 4 should be palette"); depths other
    than 1, 4, 8, 10, 12, 14, 16, 32 and 64 fail ("Invalid bitsperpixel");
    float samples at 1-16 bits, and complex ones, fail the sample format
    checks.

    Then libtiff's RGBA interface (tif_getimage.c), which OpenCV uses for
    8-bit output: its checks (TIFFRGBAImageOK: 1, 2, 4, 8 or 16 bits, no
    float samples; min-is-white/black and palette, RGB of three colour
    channels or more, CMYK of ink set 1, YCbCr, CIELab of three 8- or
    16-bit samples; transparency masks, ICCLab, ITULab, CFA, linear raw,
    LogL/LogLuv outside SGILog and unknown photometrics refused), its
    put routines (none for 16-bit palette, CMYK or YCbCr: "can not handle
    image"), and what they make of the samples:

    * grey: 1-, 2- and 4-bit levels v to v * 255 // (2^d - 1), 8-bit as
      stored, 16-bit their high byte (signed samples taken unsigned);
      min-is-white inverted;
    * palette: the colour map at 8 bits (its high bytes where any entry is
      past 255);
    * RGB: 16-bit samples to (v + 128) // 257; an unassociated alpha
      premultiplies the colour ((v * a + 127) // 255), an associated or
      unspecified one is dropped;
    * CMYK: each of R, G, B (255 - k) * (255 - c) // 255;
    * YCbCr: libtiff's TIFFYCbCrtoRGB, chroma replicated over each
      sub-sampling block; under JPEG compression libjpeg's own conversion;
    * CIELab: libtiff's TIFFCIELabToXYZ and TIFFXYZToRGB (its sRGB display
      tables) under the file's white point (D50 by default).

    Strips and tiles are decoded as libtiff decodes them
    (``viz/libtiff.py``, shared with Pillow's route): fill order 2
    reverses the bits of the stored bytes of every codec but fax and JPEG;
    LZW new-style or old-style (LSB first, as LZWDecodeCompat, chosen by
    the first two bytes); Deflate; PackBits; JPEG with the JPEGTables tag.
    The predictor applies only under LZW and Deflate, horizontal
    differencing at 8 and 16 bits (1-bit and other depths fail libtiff's
    PredictorSetup), the floating point predictor only on float samples;
    a strip whose codec fails keeps the bytes it decoded, with no
    predictor and no byte swap. Separate planes are found as libtiff
    counts strips, which ignores ImageDepth; byte counts a directory lacks
    are libtiff's estimate. A TIFF without a PhotometricInterpretation
    fails (OpenCV's TIFFGetField).

    CCITT fax data (compression 2, 3 under Group3Options 1-D or 2-D, 4 and
    32771) is decoded by libtiff's fax codec (``native.fax_decode``, its
    own fill order, 1-bit samples only), which reads on past a bad row as
    libtiff does. SGILog data (34676, 34677) is read as
    TIFFRGBAImageBegin reads it, with the codec's 8-bit output: LogL
    (photometric 32844, compression 34676, one sample) as grey through
    L16toGry, LogLuv (32845, three contiguous samples) as RGB through
    LogLuv32toXYZ or LogLuv24toXYZ and XYZtoRGB24; a three-sample LogLuv
    image passes none of OpenCV's header checks of depth and sample format
    (it takes them as its float path's), libtiff's still apply. LogL and
    LogLuv data under another compression are refused as libtiff refuses
    them. The Orientation tag is applied as an EXIF orientation."""
    r = T._Reader(data, path, libtiff=True)
    tags = r.tags
    L.directory_checks(r, tags, path, "OpenCV")
    W, H = T._one(tags, T._WIDTH, 0), T._one(tags, T._LENGTH, 0)
    spp = T._one(tags, T._SAMPLES, 1)
    bits_all = tags.get(T._BITS) or (1,)
    fmts = tags.get(T._SAMPLE_FORMAT) or (1,)
    if len(set(bits_all[:spp])) > 1:
        _tfail(path, "libtiff: Cannot handle different values per sample "
                     "for \"BitsPerSample\"")
    if len(set(fmts[:spp])) > 1:
        _tfail(path, "libtiff: Cannot handle different values per sample "
                     "for \"SampleFormat\"")
    bits, fmt = bits_all[0], fmts[0]
    compression = T._one(tags, T._COMPRESSION, 1)
    photometric = T._one(tags, T._PHOTOMETRIC, None)
    if photometric is None:
        _tfail(path, "failed TIFFGetField(tif, TIFFTAG_PHOTOMETRIC, "
                     "&photometric): no PhotometricInterpretation tag")
    if photometric == 3 and T._COLORMAP not in tags:
        if bits < 8:
            _tfail(path, "libtiff: missing required Colormap")
        photometric = 2 if spp == 3 else 1     # libtiff's guess
    planar = T._one(tags, T._PLANAR, 1)
    extra = list(tags.get(T._EXTRA, ()))
    colour = L.COLOUR_CHANNELS.get(photometric)
    if colour and spp - len(extra) > colour:
        extra += [0] * (spp - colour - len(extra))
    if not W or not H:
        _tfail(path, f"an image of {W} x {H} pixels")
    if W > T_MAX_SIDE or H > T_MAX_SIDE or W * H > T_MAX_PIXELS:
        _tfail(path, f"an image of {W} x {H} pixels, past OpenCV's limits")
    # OpenCV's readHeader
    if not 1 <= spp <= 4:
        _tfail(path, f"{spp} samples a pixel (Unsupported number of "
                     "channels)")
    bpp = bits
    if bpp > 8 and (photometric > 2 or spp not in (1, 3, 4)):
        bpp = 8
    if photometric == 32845 and spp == 3:
        pass        # OpenCV's float (HDR) path, which checks no depth here
    elif bpp == 4 and photometric != 3:
        _tfail(path, "bitsperpixel value is 4 should be palette")
    elif bpp not in (1, 4, 8, 10, 12, 14, 16, 32, 64):
        _tfail(path, f"Invalid bitsperpixel value {bits} (OpenCV reads 1, "
                     "8, 10, 12, 14, 16, 32 or 64)")
    elif fmt not in ((1, 2, 3) if bpp in (32, 64) else (1, 2)):
        _tfail(path, f"sample format {fmt} at {bits} bits (OpenCV's "
                     "sample_format check)")
    # libtiff's TIFFRGBAImageOK and TIFFRGBAImageBegin
    if compression not in _OPENCV_COMPRESSION:
        name = T._COMPRESSION_NAMES.get(compression, "unknown")
        _tfail(path, f"compression {compression} ({name}) is not read "
                     "(libtiff: requested compression method is not "
                     "configured, or the port has no decoder for it)")
    if bits not in (1, 2, 4, 8, 16):
        _tfail(path, f"TIFFRGBAImageOK: Sorry, can not handle images with "
                     f"{bits}-bit samples")
    if fmt == 3:
        _tfail(path, "TIFFRGBAImageOK: Sorry, can not handle images with "
                     "IEEE floating-point samples")
    channels = spp - len(extra)
    lab = photometric == 8
    if photometric in (0, 1, 3):
        if planar == 1 and spp != 1 and bits < 8:
            _tfail(path, "TIFFRGBAImageOK: Sorry, can not handle contiguous "
                         f"data with Samples/pixel={spp} and Bits/sample="
                         f"{bits}")
    elif photometric == 2:
        if channels < 3:
            _tfail(path, "TIFFRGBAImageOK: Sorry, can not handle RGB image "
                         f"with Color channels={channels}")
    elif photometric == 5:
        ink = T._one(tags, T._INKSET, 1)
        if ink != 1 or spp < 4:
            _tfail(path, "TIFFRGBAImageOK: Sorry, can not handle separated "
                         f"image with InkSet={ink}, Samples/pixel={spp}")
    elif lab:
        if spp != 3 or channels != 3 or bits not in (8, 16):
            _tfail(path, "TIFFRGBAImageOK: Sorry, can not handle image with "
                         f"Samples/pixel={spp}, colorchannels={channels} "
                         f"and Bits/sample={bits}")
    elif photometric == 32844:
        if compression != 34676:
            _tfail(path, "TIFFRGBAImageOK: Sorry, LogL data must have "
                         "Compression=34676")
    elif photometric == 32845:
        if compression not in L.SGILOG:
            _tfail(path, "TIFFRGBAImageOK: Sorry, LogLuv data must have "
                         "Compression=34676 or 34677")
        if planar != 1:
            _tfail(path, "TIFFRGBAImageOK: Sorry, can not handle LogLuv "
                         f"images with Planarconfiguration={planar}")
        if spp != 3 or channels != 3:
            _tfail(path, "TIFFRGBAImageOK: Sorry, can not handle image with "
                         f"Samples/pixel={spp}, colorchannels={channels}")
    elif photometric != 6:
        _tfail(path, "TIFFRGBAImageOK: Sorry, can not handle image with "
                     f"PhotometricInterpretation={photometric}")
    if compression in L.SGILOG:
        img = L.sgilog_samples(r, tags, W, H, photometric, compression,
                               spp, path, "OpenCV")
        # "the little white lie": 8-bit grey or RGB to the put routines
        rgb = L.rgba(img, tags, 1 if img.shape[-1] == 1 else 2, 8,
                     img.shape[-1], [], path, "OpenCV")
        return orient(rgb, T._one(tags, L.ORIENTATION, 1))
    if compression in L.FAX:
        if bits != 1:
            _tfail(path, "libtiff: Bits/sample must be 1 for Group 3/4 "
                         "encoding/decoding")
        if spp != 1 and planar == 1:
            _tfail(path, "libtiff: Samples/pixel shall be 1 in planarconfig "
                         "contiguous decoding")
    jpeg_rgb = photometric == 6 and compression == 7 and planar == 1
    kind = 2 if jpeg_rgb else photometric
    if kind == 3 and bits == 16 or kind == 5 and bits != 8 \
            or kind == 6 and (bits != 8 or spp != 3) \
            or kind == 2 and bits not in (8, 16):
        _tfail(path, "libtiff: Sorry, can not handle image (no put routine "
                     f"for photometric {photometric} at {bits} bits)")
    sub = tuple(tags.get(T._YCBCR_SUBSAMPLING, (2, 2)))[:2] \
        if kind == 6 else (1, 1)
    if kind == 6 and sub not in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1),
                                 (4, 2), (4, 4)):
        _tfail(path, f"libtiff: Sorry, can not handle image (YCbCr "
                     f"subsampling {sub})")
    samples = L.rgba_samples(r, tags, W, H, spp, bits, compression,
                             planar, fmt, sub if kind == 6 else None,
                             jpeg_rgb, path, "OpenCV")
    rgb = L.rgba(samples, tags, kind, bits, spp, extra, path, "OpenCV")
    return orient(rgb, T._one(tags, L.ORIENTATION, 1))


# -------------------------------------------------------------- any format
def decode_opencv(data: bytes, path: str = "") -> np.ndarray:
    """A file that ``image_files.opencv_reads`` recognises, as imageio's
    OpenCV plugin reads it: the decoder whose signature it carries (see
    the module docstring). (H, W, 3) uint8 RGB, or (H, W, 1) for a grey
    float map; raises ``ValueError`` naming OpenCV's reason where OpenCV
    refuses the file."""
    from .image_files import (AVIF_WAITS, PNG_SIGNATURE, RADIANCE,
                              image_format)
    if data[:2] == b"BM":
        return _bmp(data, path)
    if data.startswith(RADIANCE):
        return decode_radiance(data, path)
    if data.startswith(b"\xff\xd8\xff"):
        return _jpeg(data, path)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return _webp(data, path)
    if data.startswith(PNG_SIGNATURE):
        return _png(data, path)
    if data.startswith((b"GIF87a", b"GIF89a")):
        return _gif(data, path)
    if data[:1] == b"P":
        return {b"7": pam_opencv, b"f": pfm_opencv, b"F": pfm_opencv}.get(
            data[1:2], pxm_opencv)(data, path)
    if data.startswith(SUN_MAGIC):
        return decode_sun_opencv(data, path)
    if data.startswith((b"II", b"MM")):
        return _tiff(data, path)
    if data.startswith((SIGNATURE, CODESTREAM)):
        return _jpeg2000(data, path)
    if image_format(data) == "AVIF":
        raise ValueError(f"{path}: {AVIF_WAITS}")
    raise ValueError(f"{path}: not a file that OpenCV's decoders take")
