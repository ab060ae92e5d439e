"""Image files of the port, with no imaging library: the renders' PNG and
GIF files, and the textures it reads.

Counterpart of the JAX package's ``viz/raster.save_png`` / ``save_gif``
(imageio) and ``viz/visualize._save_gifs``:

* :func:`to_uint8` — the JAX package's truncating cast;
* :func:`save_png` / :func:`write_png` — 8-bit RGB, zlib, lossless: the
  decoded pixels equal ``to_uint8(img)``;
* :func:`read_png` — any PNG, as Pillow (and imageio) reads it;
* :func:`read_image` / :func:`decode_image` — the OBJ textures of
  ``apps/retarget``, read by the plugin that imageio picks for the file's
  name and content (:func:`imageio_route`, :func:`opencv_reads`): PNG,
  JPEG, BMP, TGA, GIF, TIFF (``viz/tiff_pillow.py``), WebP, DDS, QOI, PNM
  (``viz/texture_formats.py``), Sun raster (``viz/sunraster.py``) or JPEG
  2000 (``viz/jpeg2000.py``) as Pillow reads them; a TIFF under
  tifffile's names as tifffile reads it (``viz/tiff.py``); or, where
  imageio hands the file to OpenCV, as OpenCV's decoders read it for
  ``IMREAD_COLOR`` (``viz/opencv_read.py``, Radiance HDR in
  ``viz/radiance.py``);
* :func:`write_gif` — GIF89a with the loop extension, an adaptive palette
  of at most 256 colours per frame (exact when the frame has no more; else
  a count-weighted median cut, each colour mapped to its nearest entry)
  and the frame delay the caller asks for, in seconds.

The LZW coder of the GIF frames, the PNG row filters, the JPEG and QOI
decoders, the LZW, PackBits and run-length expansions of GIF, TIFF, BMP
and TGA, the WebP decoder, the BCn blocks of DDS and the JPEG 2000
decoder run in the port's host libraries (``csrc/nm_host.cpp``,
``csrc/nm_webp.cpp``, ``csrc/nm_dds.cpp`` and ``csrc/nm_jp2.cpp`` through
``data/native.py``), which raise when they cannot be built.
"""
from __future__ import annotations

import heapq
import struct
import zlib
from pathlib import PurePath

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..data import native
from .jpeg2000 import CODESTREAM, SIGNATURE, decode_jpeg2000
from .pixels import MAX_PIXELS, check_pixels
from .sunraster import SUN_MAGIC, decode_sun_pillow
from .texture_formats import decode_dds, decode_pnm, decode_qoi
from .tiff import cmyk_to_rgb, decode_tiff
from .tiff_pillow import open_tiff

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_uint8(img) -> np.ndarray:
    """``clip(img, 0, 1) * 255`` cast to uint8 by truncation (a tensor is
    cast on its device and copied to the host)."""
    if isinstance(img, torch.Tensor):
        return (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def unit_interval(samples: np.ndarray, bits: int) -> np.ndarray:
    """Unsigned integer samples of ``bits`` bits -> float32 in [0, 1]:
    v / (2^d - 1), the value and the divisor each rounded to float64,
    divided there, the quotient rounded to float32. The one rule of every
    integer texture sample (a signed one goes through
    ``viz/tiff.offset_binary`` first). Below 2^24 it is float32's own
    correctly rounded division (float64's 53 bits are more than 2 x 24 +
    2, so rounding twice changes nothing); for 32- and 64-bit samples it
    is the rule that the fixtures' expected textures follow too."""
    return (samples.astype(np.float64) / float((1 << bits) - 1)).astype(
        np.float32)


# --------------------------------------------------------------------- PNG
def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(rgb: np.ndarray, path: str) -> None:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG (rows unfiltered)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape}")
    H, W, _ = rgb.shape
    rows = np.zeros((H, 1 + 3 * W), np.uint8)   # filter byte 0: none
    rows[:, 1:] = rgb.reshape(H, 3 * W)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(_chunk(b"IEND", b""))


def save_png(img, path: str) -> None:
    """A float image in [0, 1] (array or tensor) as a PNG of
    ``to_uint8(img)``."""
    write_png(to_uint8(img), path)


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _png_chunks(data: bytes, path: str):
    """(kind, body) of each chunk through IEND, each length and CRC
    checked."""
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ValueError(f"{path}: PNG truncated before its IEND chunk")
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        end = pos + 12 + n
        if end > len(data):
            raise ValueError(f"{path}: PNG chunk {kind!r} runs past the end "
                             "of the file")
        body = data[pos + 8:end - 4]
        if zlib.crc32(kind + body) != int.from_bytes(data[end - 4:end],
                                                     "big"):
            raise ValueError(f"{path}: PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end


# bit depths of each colour type, and its samples per pixel
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
_PNG_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: first column and row, column and row step
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unpack_samples(rows: np.ndarray, width: int, depth: int,
                    samples: int) -> np.ndarray:
    """Unfiltered PNG rows (h, stride) -> (h, width, samples) samples,
    uint16 at depth 16, else uint8."""
    h = rows.shape[0]
    if depth == 16:
        return rows.reshape(h, -1).view(">u2")[:, :width * samples].astype(
            np.uint16).reshape(h, width, samples)
    if depth == 8:
        return rows[:, :width * samples].reshape(h, width, samples)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth]
    bits = bits.reshape(h, width, depth).astype(np.uint8)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def _decode_png(data: bytes, path: str) -> np.ndarray:
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _png_chunks(data, path):
        if kind == b"IHDR":
            if header is not None or len(body) != 13:
                raise ValueError(f"{path}: bad PNG IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, method, filt, interlace = header
    if ctype not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[ctype]:
        raise ValueError(f"{path}: PNG colour type {ctype} at bit depth "
                         f"{depth} is not a valid PNG")
    if method != 0 or filt != 0 or interlace > 1 or not 0 < W < 2 ** 31 \
            or not 0 < H < 2 ** 31:
        raise ValueError(f"{path}: bad PNG header {header}")
    if ctype == 3 and (palette is None or len(palette) % 3
                       or not 0 < len(palette) <= 768):
        raise ValueError(f"{path}: paletted PNG without a valid PLTE chunk")
    samples = _PNG_SAMPLES[ctype]
    bits = depth * samples
    passes = []
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(W - x0) // dx), -(-(H - y0) // dy)
        if pw > 0 and ph > 0:
            passes.append((x0, y0, dx, dy, pw, ph, (pw * bits + 7) // 8))
    size = sum(ph * (stride + 1) for *_, ph, stride in passes)
    inflate = zlib.decompressobj()
    try:
        raw = inflate.decompress(b"".join(idat), size)
    except zlib.error as e:
        raise ValueError(f"{path}: PNG image data: {e}") from None
    if len(raw) < size:
        raise ValueError(f"{path}: PNG image data ends early ({len(raw)} of "
                         f"{size} bytes)")
    raw = np.frombuffer(raw, np.uint8)
    img = np.empty((H, W, samples), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy, pw, ph, stride in passes:
        n = ph * (stride + 1)
        rows = native.png_unfilter(raw[pos:pos + n], ph, stride,
                                   max(1, bits // 8))
        img[y0::dy, x0::dx] = _unpack_samples(rows, pw, depth, samples)
        pos += n
    # what Pillow makes of the samples, as imageio returns them
    if ctype == 3:      # palette -> RGB; indices past it are black
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette) // 3] = np.frombuffer(palette, np.uint8).reshape(
            -1, 3)
        return lut[img[..., 0]]
    if depth < 8:       # grey scaled to 8 bits
        return img * np.uint8(255 // ((1 << depth) - 1))
    if depth == 16 and ctype != 0:   # 8 bits a sample: the high byte
        return (img >> 8).astype(np.uint8)
    return img


def read_png(path: str) -> np.ndarray:
    """Any PNG (colour types 0, 2, 3, 4, 6 at every bit depth, Adam7
    interlaced or not; each chunk's length and CRC checked) as (H, W, C):
    C = 1 grey, 2 grey + alpha, 3 RGB (a palette is expanded to it), 4
    RGBA. The samples are Pillow's: uint8, with 1-, 2- and 4-bit grey
    scaled to 8 bits, 16-bit colour cut to its high byte; 16-bit grey is
    uint16."""
    return _decode_png(_read_bytes(path), path)


# --------------------------------------------------------------------- BMP
def _le(data: bytes, pos: int, n: int, signed: bool = False) -> int:
    return int.from_bytes(data[pos:pos + n], "little", signed=signed)


# Pillow's BI_BITFIELDS layouts at 32 bits: (R, G, B, A) masks -> the byte
# of each of R, G, B (and A) in the little-endian pixel
_BMP_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0): (2, 1, 0),
    (0xFF000000, 0xFF0000, 0xFF00, 0): (3, 2, 1),
    (0xFF000000, 0xFF00, 0xFF, 0): (3, 1, 0),
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1, 0),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2, 3),
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0, 3),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0, 2),
    (0, 0, 0, 0): (2, 1, 0, 3)}
# at 16 bits: (R, G, B) masks -> the bits of R, G, B (shift, width)
_BMP_MASKS16 = {(0x7C00, 0x3E0, 0x1F): ((10, 5), (5, 5), (0, 5)),
                (0xF800, 0x7E0, 0x1F): ((11, 5), (5, 6), (0, 5))}
_BMP_COMPRESSION = {0: "BI_RGB", 1: "BI_RLE8", 2: "BI_RLE4",
                    3: "BI_BITFIELDS", 4: "BI_JPEG", 5: "BI_PNG",
                    6: "BI_ALPHABITFIELDS"}


def _unpack16(px: np.ndarray, fields) -> np.ndarray:
    """(H, W) uint16 pixels -> (H, W, 3) uint8 of ``fields`` ((shift,
    width) per channel), each scaled as Pillow does: v * 255 // (2^w - 1)."""
    out = [((px >> s) & ((1 << w) - 1)).astype(np.uint32) * 255
           // ((1 << w) - 1) for s, w in fields]
    return np.stack(out, -1).astype(np.uint8)


def _decode_bmp(data: bytes, path: str) -> np.ndarray:
    """A BMP as Pillow reads it: ``BI_RGB`` at 1, 4, 8 (paletted), 16
    (5-5-5), 24 or 32 bits a pixel (the fourth byte ignored);
    ``BI_RLE8`` / ``BI_RLE4``; ``BI_BITFIELDS`` in the mask layouts Pillow
    accepts (16 bits 5-5-5 and 5-6-5, 24, and seven 32-bit layouts, four
    of them with alpha); bottom-up or top-down. (H, W, 3) uint8, or
    (H, W, 4) RGBA for a 32-bit layout with alpha."""
    if data[:2] != b"BM" or len(data) < 26:
        raise ValueError(f"{path}: not a BMP file")
    offset, hsize = _le(data, 10, 4), _le(data, 14, 4)
    if hsize == 12:
        W, H, bits = _le(data, 18, 2), _le(data, 20, 2), _le(data, 24, 2)
        compression, colors, entry = 0, 0, 3
    elif hsize in (40, 52, 56, 64, 108, 124) and len(data) >= 14 + hsize:
        W, H = _le(data, 18, 4, True), _le(data, 22, 4, True)
        bits, compression = _le(data, 28, 2), _le(data, 30, 4)
        colors, entry = _le(data, 46, 4), 4
    else:
        raise ValueError(f"{path}: BMP header of {hsize} bytes is not read")
    name = _BMP_COMPRESSION.get(compression, str(compression))
    if compression not in (0, 1, 2, 3):
        raise ValueError(f"{path}: BMP compression {compression} ({name}) "
                         "is not read (Pillow reads none of it)")
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{path}: BMP at {bits} bits a pixel is not read")
    if compression in (1, 2) and bits > 8:
        raise ValueError(f"{path}: BMP compression {name} at {bits} bits a "
                         "pixel is not read")
    masks = None
    if compression == 3:
        # the masks follow a 40-byte header; later headers hold them
        if len(data) < 14 + max(hsize, 40) + 12:
            raise ValueError(f"{path}: BMP bitfield masks truncated")
        masks = tuple(_le(data, 54 + 4 * i, 4) for i in range(3)) + (
            _le(data, 66, 4) if hsize >= 56 else 0,)
        if not (bits == 32 and masks in _BMP_MASKS32
                or bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF)
                or bits == 16 and masks[:3] in _BMP_MASKS16):
            raise ValueError(
                f"{path}: BMP bitfields layout at {bits} bits (masks "
                + ", ".join(f"{m:#x}" for m in masks)
                + ") is not one that Pillow reads")
    top_down, H = H < 0, abs(H)
    if W <= 0 or H == 0:
        raise ValueError(f"{path}: BMP of {W} x {H} pixels")
    check_pixels(W, H, path, "BMP")
    lut = None
    if bits <= 8:
        colors = colors or 1 << bits
        if not 0 < colors <= 256:
            raise ValueError(f"{path}: BMP palette of {colors} colours")
        if offset == 14 + hsize:   # Pillow: the palette lies before offset
            offset += 4 * colors
        pal = data[14 + hsize:14 + hsize + entry * colors]
        if len(pal) < entry * colors:
            raise ValueError(f"{path}: BMP palette truncated")
        pal = np.frombuffer(pal, np.uint8).reshape(colors, entry)[:, 2::-1]
        # Pillow reads a palette of grey levels 0, 1, ... (or black and
        # white) as grey: the index is the level
        ramp = (np.array([[0] * 3, [255] * 3]) if colors == 2 else
                np.repeat(np.arange(colors)[:, None], 3, 1))
        lut = np.zeros((256, 3), np.uint8)
        lut[:colors] = pal
        if colors != 2 and np.array_equal(pal, ramp):
            lut = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    if compression in (1, 2):
        idx = native.bmp_unrle(np.frombuffer(data, np.uint8)[offset:], offset,
                               W, H, compression == 2)
        return lut[idx if top_down else idx[::-1]]
    stride = (W * bits + 31) // 32 * 4
    if offset + stride * H > len(data):
        raise ValueError(f"{path}: BMP pixel data truncated")
    rows = np.frombuffer(data, np.uint8, stride * H, offset).reshape(H,
                                                                     stride)
    if not top_down:
        rows = rows[::-1]
    if bits == 16:
        px = rows[:, :2 * W].copy().view("<u2")
        return _unpack16(px, _BMP_MASKS16[masks[:3]] if masks else
                         _BMP_MASKS16[(0x7C00, 0x3E0, 0x1F)])
    if bits >= 24:
        n = bits // 8
        order = (2, 1, 0) if masks is None or n == 3 else _BMP_MASKS32[masks]
        return np.ascontiguousarray(
            rows[:, :W * n].reshape(H, W, n)[..., list(order)])
    return lut[_unpack_samples(rows, W, bits, 1)[..., 0]]


# --------------------------------------------------------------------- TGA
def _tga_header(data: bytes):
    """The fields of an 18-byte TGA header, or None where Pillow would not
    take the file for a TGA."""
    if len(data) < 18:
        return None
    h = dict(id_len=data[0], cmap=data[1], kind=data[2],
             cmap_start=_le(data, 3, 2), cmap_len=_le(data, 5, 2),
             cmap_depth=data[7],
             width=_le(data, 12, 2), height=_le(data, 14, 2),
             depth=data[16], flags=data[17])
    if h["cmap"] not in (0, 1) or h["width"] == 0 or h["height"] == 0 \
            or h["depth"] not in (1, 8, 16, 24, 32) \
            or h["kind"] not in (1, 2, 3, 9, 10, 11):
        return None
    return h


def _tga15(px: np.ndarray) -> np.ndarray:
    """(..., 2) little-endian A1R5G5B5 bytes -> (..., 4) RGBA uint8, as
    Pillow's "BGRA;15Z": each 5-bit field times 255 // 31, alpha 255 where
    the top bit is clear and 0 where it is set."""
    v = px[..., 0].astype(np.uint16) | (px[..., 1].astype(np.uint16) << 8)
    rgb = _unpack16(v, ((10, 5), (5, 5), (0, 5)))
    alpha = np.where(v & 0x8000, 0, 255).astype(np.uint8)
    return np.concatenate([rgb, alpha[..., None]], -1)


def _decode_tga(data: bytes, path: str) -> np.ndarray:
    """A TGA of image type 2 or 10 (true colour: 24 bits (H, W, 3), 32 bits
    or 16 bits A1R5G5B5 (H, W, 4) RGBA, the 16-bit alpha set where the top
    bit is clear, as Pillow reads it), 3 or 11 (grey: 8 bits (H, W, 1), 16
    bits grey + alpha (H, W, 2)) or 1 or 9 (8-bit indices into a 24-bit
    colour map: RGB; a 32- or 16-bit map: RGBA; indices past the map
    black, as Pillow pads it), raw or run-length, with the origin bits
    honoured (bottom-up unless bit 5, mirrored when bit 4)."""
    h = _tga_header(data)
    if h is None:
        raise ValueError(f"{path}: not a TGA file")
    kind, depth = h["kind"], h["depth"]
    mapped = (kind & 7) == 1
    if not ((kind & 7) == 2 and depth in (16, 24, 32)
            or (kind & 7) == 3 and depth in (8, 16)
            or mapped and depth == 8 and h["cmap"]):
        raise ValueError(f"{path}: TGA image type {kind} at {depth} bits is "
                         "not read (types 1, 9 at 8 bits; 2, 10 at 16, 24 "
                         "and 32; 3, 11 at 8 and 16)")
    pos = 18 + h["id_len"]
    lut = None
    if h["cmap"]:
        if h["cmap_depth"] not in (16, 24, 32):
            raise ValueError(f"{path}: TGA colour map of "
                             f"{h['cmap_depth']} bits")
        n, size = h["cmap_len"], h["cmap_depth"] // 8
        if mapped:
            entries = data[pos:pos + n * size]
            if len(entries) < n * size:
                raise ValueError(f"{path}: TGA colour map truncated")
            start = h["cmap_start"]
            entries = np.frombuffer(entries, np.uint8).reshape(n, size)
            lut = np.zeros((max(256, start + n), 4 if size == 2 else size),
                           np.uint8)
            if size == 2:
                lut[:start + n] = _tga15(np.concatenate(
                    [np.zeros((start, 2), np.uint8), entries]))
            else:
                lut[start:start + n] = entries[:, [2, 1, 0, 3][:size]]
        pos += n * size
    W, H, n = h["width"], h["height"], depth // 8
    check_pixels(W, H, path, "TGA")
    if kind & 8:
        px = native.tga_unrle(np.frombuffer(data[pos:], np.uint8), W * H, n)
    else:
        if pos + W * H * n > len(data):
            raise ValueError(f"{path}: TGA pixel data truncated")
        px = np.frombuffer(data, np.uint8, W * H * n, pos)
    px = px.reshape(H, W, n)
    if not h["flags"] & 0x20:
        px = px[::-1]
    if h["flags"] & 0x10:
        px = px[:, ::-1]
    if lut is not None:
        return lut[px[..., 0]]
    if (kind & 7) == 3:
        return np.ascontiguousarray(px)
    if n == 2:
        return _tga15(px)
    return np.ascontiguousarray(px[..., [2, 1, 0, 3][:n]])


# --------------------------------------------------------------------- GIF
def _gif_palette(table: bytes):
    """A GIF colour table as (256, 3) uint8 (entries past it black), or
    None where Pillow drops it: every entry i is the grey (i, i, i), and
    the frame reads as grey levels (mode "L")."""
    pal = np.frombuffer(table, np.uint8).reshape(-1, 3)
    if np.array_equal(pal, np.repeat(np.arange(len(pal))[:, None], 3, 1)):
        return None
    lut = np.zeros((256, 3), np.uint8)
    lut[:len(pal)] = pal
    return lut


def _gif_sub_blocks(data: bytes, pos: int):
    """The data sub-blocks from ``pos`` through their terminator (or the
    end of the file): (joined bytes, position after them)."""
    out = []
    while pos < len(data) and data[pos]:
        n = data[pos]
        out.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n
    return b"".join(out), pos + 1


def _decode_gif(data: bytes, path: str) -> np.ndarray:
    """The first frame of a GIF as Pillow (and imageio) reads it: its
    palette indices through the frame's colour table (the local one, else
    the global one; entries past the table black) as (H, W, 3) uint8, or
    the indices themselves as (H, W, 1) grey where that table is the grey
    ramp 0, 1, 2, ... or there is none. The canvas is the logical screen,
    grown to hold the frame; outside the frame it holds the GCE's
    transparency index, else index 0. Interlaced rows are put in order."""
    if len(data) < 13:
        raise ValueError(f"{path}: GIF header truncated")
    screen_w, screen_h, flags = _le(data, 6, 2), _le(data, 8, 2), data[10]
    pos, table = 13, None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        if pos + n > len(data):
            raise ValueError(f"{path}: GIF global colour table truncated")
        table = _gif_palette(data[pos:pos + n])
        pos += n
    transparency = None
    while True:   # Pillow skips bytes that start no block
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError(f"{path}: GIF holds no image")
        kind = data[pos]
        pos += 1
        if kind == 0x21:            # extension: label, then sub-blocks
            if pos >= len(data):
                raise ValueError(f"{path}: GIF extension truncated")
            label = data[pos]
            pos += 1
            first = None
            if pos < len(data) and data[pos]:
                first = data[pos + 1:pos + 1 + data[pos]]
                if len(first) < data[pos]:
                    raise ValueError(f"{path}: GIF extension truncated")
                pos += 1 + data[pos]
            else:
                pos += 1
            if label == 0xF9 and first is not None and first[0] & 1:
                if len(first) < 4:
                    raise ValueError(f"{path}: GIF graphic control "
                                     "extension truncated")
                transparency = first[3]
            if label != 0xFE or first is not None:
                pos = _gif_sub_blocks(data, pos)[1]
        elif kind == 0x2C:          # image descriptor
            break
    if pos + 9 > len(data):
        raise ValueError(f"{path}: GIF image descriptor truncated")
    x0, y0, w, h = (_le(data, pos + 2 * i, 2) for i in range(4))
    flags = data[pos + 8]
    pos += 9
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        if pos + n > len(data):
            raise ValueError(f"{path}: GIF local colour table truncated")
        table = _gif_palette(data[pos:pos + n])
        pos += n
    if w == 0 or h == 0:
        raise ValueError(f"{path}: GIF frame of {w} x {h} pixels")
    if pos >= len(data):
        raise ValueError(f"{path}: GIF image data truncated")
    mcs = data[pos]
    if not 2 <= mcs <= 8:
        raise ValueError(f"{path}: GIF minimum code size {mcs} is not read")
    check_pixels(max(screen_w, x0 + w), max(screen_h, y0 + h), path, "GIF")
    stream = _gif_sub_blocks(data, pos + 1)[0]
    try:
        idx = native.gif_unlzw(stream, mcs, w * h).reshape(h, w)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if flags & 0x40:                # interlaced: rows in four passes
        order = np.concatenate([np.arange(start, h, step) for start, step
                                in ((0, 8), (4, 8), (2, 4), (1, 2))])
        rows = np.empty_like(idx)
        rows[order] = idx
        idx = rows
    H, W = max(screen_h, y0 + h), max(screen_w, x0 + w)
    canvas = np.full((H, W), 0 if transparency is None else transparency,
                     np.uint8)
    canvas[y0:y0 + h, x0:x0 + w] = idx
    if table is None:
        return canvas[..., None]
    return table[canvas]


# ------------------------------------------------------------- any format
# Radiance HDR's two first lines (OpenCV's HdrDecoder signatures) and
# OpenEXR's magic
RADIANCE = (b"#?RADIANCE", b"#?RGBE")
EXR_MAGIC = b"\x76\x2f\x31\x01"
# TIFF's magic numbers: classic and BigTIFF, as tifffile and OpenCV take
# them; Pillow also takes the two byte orders' numbers swapped
TIFF_MAGIC = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")
_MAGIC = ((PNG_SIGNATURE, "PNG"), (b"\xff\xd8\xff", "JPEG"), (b"BM", "BMP"),
          (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
          *((m, "TIFF") for m in TIFF_MAGIC + (b"MM*\x00", b"II\x00*")),
          (b"DDS ", "DDS"), (b"qoif", "QOI"), (b"8BPS", "PSD"),
          (SIGNATURE, "JPEG2000"), (CODESTREAM, "JPEG2000"),
          (SUN_MAGIC, "SUN"), (RADIANCE[0], "HDR"), (RADIANCE[1], "HDR"),
          (EXR_MAGIC, "EXR"))
READ_FORMATS = ("PNG", "JPEG", "BMP", "TGA", "GIF", "TIFF", "WebP", "DDS",
                "QOI", "PNM", "JPEG2000", "SUN", "HDR")
# the ISO base media brands of Pillow's AVIF plugin
_AVIF_BRANDS = (b"avif", b"avis")
AVIF_WAITS = ("an AVIF image; its AV1 decoding waits until the AV1 "
              "specification's tables (default CDFs, quantizer lookups, "
              "filter taps) are in the repository")
_SPACE = (b" ", b"\t", b"\n", b"\x0b", b"\x0c", b"\r")   # C's isspace


def image_format(data: bytes, path: str = "") -> str:
    """The format of an image file's bytes: by its magic number (PNM by
    ``P1``-``P7``, ``Pf``, ``PF`` or ``PyP`` and a whitespace, or Pillow's
    ``P0CMYK``, ``PyCMYK`` and ``PyRGBA``; JPEG 2000 by the JP2 signature
    box or a codestream's SOC and SIZ; Sun raster, Radiance HDR; PSD,
    OpenEXR, and AVIF by an ``ftyp`` box of brand ``avif`` or ``avis``,
    are named to be refused), else TGA where the header passes Pillow's
    TGA checks or the extension is ``.tga``; "unknown" otherwise."""
    for magic, name in _MAGIC:
        if data.startswith(magic):
            return name
    if data[4:8] == b"ftyp" and (data[8:12] in _AVIF_BRANDS or (
            data[8:12] in (b"mif1", b"msf1") and any(
                data[k:k + 4] in _AVIF_BRANDS
                for k in range(16, min(len(data), 8 + int.from_bytes(
                    data[:4], "big")), 4)))):
        return "AVIF"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[:1] == b"P" and data[1:2] in (b"1", b"2", b"3", b"4", b"5",
                                         b"6", b"7", b"f", b"F") \
            and data[2:3] in _SPACE or data[:3] == b"PyP" and \
            data[3:4] in _SPACE or data[:6] in (b"P0CMYK", b"PyCMYK",
                                                 b"PyRGBA"):
        return "PNM"
    if _tga_header(data) is not None or path.lower().endswith(".tga"):
        return "TGA"
    return "unknown"


# imageio 2.37.4 picks a plugin by the file's extension first
# (imageio/core/imopen.py:183-200, the extension being
# ``Path(name).suffix.lower()``, core/request.py:266), then tries every
# plugin in turn (imopen.py:232-240, in the order of
# imageio/config/plugins.py). Of the plugins it names, three can be
# installed beside it here: pillow (its legacy "-PIL" formats too),
# tifffile (and its legacy "TIFF") and opencv; FreeImage, ITK, GDAL and
# pyav are not. From imageio/config/extensions.py, the extensions whose
# first installed plugin is not Pillow:
_OPENCV_FIRST = (".dip", ".exr", ".hdr", ".pbm", ".pfm", ".pic", ".pxm",
                 ".sr")
_TIFFFILE_FIRST = (".bif", ".btf", ".gel", ".lsm", ".ndpi", ".pcoraw",
                   ".ptif", ".ptiff", ".qpi", ".qptiff", ".rec", ".stk",
                   ".svs", ".tf8", ".tif", ".tiff", ".zif")
# every other extension (and none) tries pillow, then opencv, as does the
# fallback over all plugins (config/plugins.py: pillow, pyav, opencv,
# tifffile, ...)
_FALLBACK = ("pillow", "opencv", "tifffile")


def imageio_route(path: str) -> tuple:
    """The order in which imageio 2.37.4 tries the plugins installed beside
    it (pillow, tifffile, opencv) on a file named ``path``: the plugins of
    its extension's formats, then the rest of the fallback over every
    plugin. The first that opens the file reads it (a plugin that opened it
    and then fails makes imageio fail; a plugin only opens what it knows,
    OpenCV what :func:`opencv_reads`)."""
    ext = PurePath(path).suffix.lower()
    first = (("opencv",) if ext in _OPENCV_FIRST else
             ("tifffile",) if ext in _TIFFFILE_FIRST else ())
    return first + tuple(p for p in _FALLBACK if p not in first)


def opencv_reads(data: bytes) -> bool:
    """``cv2.haveImageReader`` of OpenCV 5.0.0 as imageio's plugin asks it
    (imageio/plugins/opencv.py:57): whether one of the decoders built into
    imageio's OpenCV takes the file's first bytes for its own (BMP,
    Radiance HDR, JPEG, WebP by libwebp's header check, PNG, GIF, PxM
    P1-P6, PAM, PFM, Sun raster, TIFF and BigTIFF, JP2 and J2K; not
    OpenEXR, which that build lacks). AVIF is taken by its ``ftyp`` brand,
    a looser check than libavif's; the port refuses AVIF on either route,
    so the looser check changes only the words of the refusal."""
    if data[:2] == b"BM" or data.startswith(RADIANCE) \
            or data.startswith((b"\xff\xd8\xff", PNG_SIGNATURE, b"GIF87a",
                                b"GIF89a", SUN_MAGIC, *TIFF_MAGIC,
                                SIGNATURE, CODESTREAM)):
        return True
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return _webp_features(data[:32])
    if data[:1] == b"P" and data[1:2] in b"1234567fF" and data[1:2] \
            and data[2:3] in _SPACE:
        return True
    return image_format(data) == "AVIF"


def _webp_features(head: bytes) -> bool:
    """libwebp's WebPGetFeatures on the first 32 bytes, as OpenCV's WebP
    signature check calls it: a RIFF of at least 12 bytes, then a VP8X
    chunk of 10 bytes, or a VP8 key frame (a known profile, shown, its
    first partition within the chunk, the start code, a size) or a VP8L
    header (its signature, version 0)."""
    if len(head) < 32 or int.from_bytes(head[4:8], "little") < 12:
        return False
    tag, size = head[12:16], int.from_bytes(head[16:20], "little")
    p = head[20:]
    if tag == b"VP8X":
        return size == 10
    if tag == b"VP8 ":
        bits = int.from_bytes(p[:3], "little")
        return size >= 10 and not bits & 1 and (bits >> 1) & 7 <= 3 \
            and bool((bits >> 4) & 1) and bits >> 5 < size \
            and p[3:6] == b"\x9d\x01\x2a" \
            and _le(p, 6, 2) & 0x3FFF > 0 and _le(p, 8, 2) & 0x3FFF > 0
    if tag == b"VP8L":
        return size >= 5 and p[0] == 0x2F and p[4] >> 5 == 0
    return False


def _pillow_opens(fmt: str, data: bytes) -> bool:
    """Whether Pillow identifies a file that is not a TIFF (``PF`` and
    ``P7`` are OpenCV's alone; Radiance HDR, OpenEXR and unknown content
    Pillow does not know). A TIFF is opened by ``tiff_pillow.open_tiff``
    in :func:`decode_image`."""
    if fmt == "PNM":
        return data[:2] not in (b"PF", b"P7")
    return fmt not in ("unknown", "HDR", "EXR")


def decode_image(data: bytes, path: str = "") -> np.ndarray:
    """An image file's bytes as (H, W, C) samples, each as imageio reads
    it for the JAX package's ``_find_texture``, by the plugin that imageio
    picks for its name (``path``, which also names the file in errors and
    decides a TGA without a valid header) and content: the first of
    :func:`imageio_route` that opens it. A plugin that opens the file and
    then fails makes imageio fail, and the port raises.

    OpenCV (``viz/opencv_read.decode_opencv``): what
    :func:`opencv_reads` recognises, as OpenCV reads it for
    ``IMREAD_COLOR``: (H, W, 3) uint8 RGB (a grey float map (H, W, 1)),
    EXIF orientation applied (a TIFF through libtiff's RGBA reader and
    codecs, CCITT fax and SGILog among them); Radiance HDR
    (``viz/radiance.py``) reaches it under every name.

    tifffile, first under its names (``.tif``, ``.tiff`` and 15 more): a
    TIFF as tifffile reads it (the first plane of the first page, every
    sample type and photometric interpretation it reads, with no pixel
    cap, ``viz/tiff.decode_tiff``: uint8, uint16, int8, int16 or float32,
    32- and 64-bit integers normalised to float32, under the port's rules
    for palettes, CMYK, YCbCr and Lab).

    Pillow: PNG (:func:`read_png`); JPEG (baseline, extended
    sequential, progressive and lossless; Huffman or arithmetic coding;
    8-bit, 1, 3 or 4 components, sampling factors 1-4; decoded by the host
    library as libjpeg-turbo 3 does, block smoothing included; a CMYK or
    YCCK file's inverted CMYK made RGB as Pillow's ``convert("RGB")``
    does); BMP, TGA and GIF (the first frame; uint8); TIFF as Pillow's
    TIFF plugin reads it (``viz/tiff_pillow.py``: the modes of its
    ``OPEN_INFO`` table, through its own raw decoder or libtiff's
    codecs, imageio's array of that mode: a palette as RGB, 16-bit colour
    as its high bytes, "I;16" uint16, "I" int32, "F" float32, "1" as 0
    and 255; a TIFF it declines goes on to OpenCV); WebP (lossless and
    lossy, the first frame of an animation; RGB, or RGBA where the file
    has alpha; decoded by the host library as libwebp does); DDS, QOI and
    PNM (``viz/texture_formats.py``: uint8, Pillow's PGM past 8 bits
    int32, its float map float32, a CMYK extension made RGB); Sun raster
    (``viz/sunraster.decode_sun_pillow``); JPEG 2000 (a JP2 file or a raw
    codestream, any progression with POC, layers, precincts and tiles,
    every code-block style of Part 1, RGN, SOP/EPH, the 5/3 and 9/7
    wavelets, RCT and ICT, ``viz/jpeg2000.py``: uint8 grey, grey + alpha,
    RGB, RGBA, a palette's colours, CMYK made RGB; uint16 past 8 bits;
    decoded by the host library as OpenJPEG does). A PSD file, which
    imageio does not read, an AVIF file, an OpenEXR file, an unknown file,
    or one that cannot be decoded, raises ``ValueError`` naming the
    format.

    Each sample's type states its scale, which ``apps.retarget.texture_rgb``
    reads from it: uint8 0-255, uint16 0-65535 (either byte order), int8
    and int16 two's complement of 8 and 16 bits, int32 Pillow's mode "I"
    (0-65535; a TIFF's samples past that range are clipped to it),
    float32 the samples themselves (a TIFF's 32- and 64-bit integers
    under tifffile's names are already normalised to [0, 1]). A decoder
    whose samples span less than their type (a TIFF's 1-, 2- and 4-bit
    samples) widens them first."""
    fmt = image_format(data, path)
    for plugin in imageio_route(path):
        if plugin == "opencv" and opencv_reads(data):
            from .opencv_read import decode_opencv
            return decode_opencv(data, path)
        if plugin == "tifffile" and data.startswith(TIFF_MAGIC):
            return decode_tiff(data, path)
        if plugin == "pillow" and fmt == "TIFF":
            # Pillow's TIFF plugin declines (None: the next plugin) or
            # opens it, and what it opens it reads or fails on
            tif = open_tiff(data, path)
            if tif is not None:
                return tif.decode()
        elif plugin == "pillow" and _pillow_opens(fmt, data):
            return _decode_pillow(fmt, data, path)
    if fmt == "EXR":
        raise ValueError(f"{path}: an OpenEXR image; imageio's OpenCV is "
                         "built without OpenEXR and no other plugin of "
                         "imageio's reads it, so the port reads none either")
    raise ValueError(f"{path}: a {fmt} image; no plugin of imageio's opens "
                     f"it, and the port reads {', '.join(READ_FORMATS)} "
                     "images")


def _decode_pillow(fmt: str, data: bytes, path: str) -> np.ndarray:
    """The file as imageio's Pillow plugin reads it."""
    if fmt == "AVIF":
        raise ValueError(f"{path}: {AVIF_WAITS}")
    if fmt == "PSD":
        raise ValueError(f"{path}: a PSD image; imageio reads no PSD file "
                         "(its Pillow plugin seeks frame 0, and Pillow's "
                         "PSD reader numbers its frames from 1), so the "
                         "port reads none either")
    if fmt not in READ_FORMATS:
        raise ValueError(f"{path}: a {fmt} image; the port reads "
                         f"{', '.join(READ_FORMATS)} images")
    if fmt in ("JPEG", "WebP"):
        try:
            img = (native.jpeg_decode if fmt == "JPEG" else
                   native.webp_decode)(data)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
        # Pillow's CMYK (imageio's samples) made RGB, the tiff_cmyk rule
        return cmyk_to_rgb(img) if img.shape[-1] == 4 and fmt == "JPEG" \
            else img
    return {"PNG": _decode_png, "BMP": _decode_bmp, "TGA": _decode_tga,
            "GIF": _decode_gif,
            "DDS": decode_dds, "QOI": decode_qoi, "PNM": decode_pnm,
            "SUN": decode_sun_pillow,
            "JPEG2000": decode_jpeg2000}[fmt](data, path)


def read_image(path: str) -> np.ndarray:
    """:func:`decode_image` of the file at ``path``."""
    return decode_image(_read_bytes(path), path)


# --------------------------------------------------------------------- GIF
def _median_cut(colors: np.ndarray, counts: np.ndarray,
                n_boxes: int) -> list:
    """Split the (n, 3) int colours (weighted by ``counts``) into at most
    ``n_boxes`` boxes: always the box of largest weighted squared error,
    along its axis of largest weighted variance, at its weighted median.
    Returns the boxes as index arrays into ``colors``."""
    def entry(idx):
        c = colors[idx].astype(np.float64)
        w = counts[idx].astype(np.float64)
        mean = (c * w[:, None]).sum(0) / w.sum()
        var = ((c - mean) ** 2 * w[:, None]).sum(0)
        return (-float(var.sum()), int(idx[0]), idx, int(np.argmax(var)))

    heap = [entry(np.arange(len(colors)))]
    done = []
    while heap and len(heap) + len(done) < n_boxes:
        err, _, idx, axis = heapq.heappop(heap)
        if err == 0.0 or len(idx) < 2:
            done.append(idx)
            continue
        order = idx[np.argsort(colors[idx, axis], kind="stable")]
        cum = np.cumsum(counts[order])
        cut = int(np.searchsorted(cum, cum[-1] / 2.0, side="right"))
        cut = min(max(cut, 1), len(order) - 1)
        # keep equal values on one side of the cut
        vals = colors[order, axis]
        while 0 < cut < len(order) and vals[cut] == vals[cut - 1]:
            cut += 1
        if cut == len(order):
            cut = int(np.searchsorted(vals, vals[-1], side="left"))
        if cut == 0:
            done.append(idx)
            continue
        heapq.heappush(heap, entry(order[:cut]))
        heapq.heappush(heap, entry(order[cut:]))
    return done + [h[2] for h in heap]


GIF_COLORS = 256


def quantize(rgb: np.ndarray):
    """(H, W, 3) uint8 -> (palette (n, 3) uint8, indices (H, W) uint8),
    n <= ``GIF_COLORS``: the frame's own colours when they fit, else a
    count-weighted median cut with each colour mapped to its nearest
    palette entry (RGB distance, ``scipy.spatial.cKDTree``)."""
    flat = rgb.reshape(-1, 3).astype(np.int64)
    key = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    uniq, inverse, counts = np.unique(key, return_inverse=True,
                                      return_counts=True)
    colors = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], -1)
    if len(uniq) <= GIF_COLORS:
        return (colors.astype(np.uint8),
                inverse.astype(np.uint8).reshape(rgb.shape[:2]))
    boxes = _median_cut(colors, counts, GIF_COLORS)
    palette = np.stack([
        np.rint((colors[b] * counts[b, None]).sum(0) / counts[b].sum())
        for b in boxes]).astype(np.int64)
    _, nearest = cKDTree(palette.astype(np.float64)).query(
        colors.astype(np.float64))
    return (palette.astype(np.uint8),
            nearest[inverse].astype(np.uint8).reshape(rgb.shape[:2]))


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for s in range(0, len(data), 255):
        block = data[s:s + 255]
        out.append(len(block))
        out += block
    out.append(0)
    return bytes(out)


def write_gif(frames, path: str, delay_s: float) -> None:
    """(T, H, W, 3) uint8 frames as a looping GIF89a, ``delay_s`` seconds a
    frame (stored in hundredths), a local palette per frame."""
    frames = [np.ascontiguousarray(f, dtype=np.uint8) for f in frames]
    if not frames:
        raise ValueError("a GIF needs at least one frame")
    H, W = frames[0].shape[:2]
    if any(f.shape != (H, W, 3) for f in frames):
        raise ValueError("GIF frames must share one (H, W, 3) shape")
    delay = int(round(delay_s * 100))
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", W, H, 0, 0, 0)   # no global colour table
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"
    for f in frames:
        palette, idx = quantize(f)
        bits = max(1, int(np.ceil(np.log2(max(len(palette), 2)))))
        table = np.zeros((1 << bits, 3), np.uint8)
        table[:len(palette)] = palette
        out += b"\x21\xf9\x04" + struct.pack("<BHBB", 0x04, delay, 0, 0)
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0x80 | (bits - 1))
        out += table.tobytes()
        mcs = max(2, bits)
        out.append(mcs)
        out += _sub_blocks(native.gif_lzw(idx, mcs))
    out.append(0x3B)
    with open(path, "wb") as fh:
        fh.write(bytes(out))

