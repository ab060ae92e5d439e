"""Write the texture fixtures of ``tests/test_torch_textures.py`` and their
manifest.

    python tests/torch_textures/make_textures.py

Needs Pillow and imageio (the card's machine has neither): the images are
written with Pillow, or by the small writers below where Pillow cannot
write the case (16-bit colour, 2- and 4-bit grey and Adam7 PNGs; top-down,
4-bit, run-length and bitfield BMPs; 16-bit TGAs; GIF frames with local
tables, offsets, interlace and transparency; TIFFs in both byte orders and
BigTIFF, with tiles, planar samples, predictors, fill order 2, every
compression imageio's tifffile reads, every sample type of its table,
every photometric, ImageDepth volumes; PNM, PFM and PAM for OpenCV and
Pillow's PPM extensions; WebP containers with ALPH chunks and
offset animation frames), by Pillow's own libwebp through ctypes for the
lossy WebP options Pillow does not pass on (filter type and sharpness,
token partitions, segments), by Pillow's own OpenJPEG through ctypes for
the JPEG 2000 options it does not pass on (code-block styles, SOP/EPH, POC,
RGN, sub-sampling), or patched from a Pillow file (a JPEG's
quantization table, sampling factors or frame marker). Each file is then
read back with ``imageio.v2.imread``, as the JAX package's
``apps/retarget._find_texture`` reads it, and ``MANIFEST.json`` records
per file its format facts and the expected texture: where imageio's array
is an RGB image (8-bit samples, 3 channels or more) the JAX function's
own ``/ 255`` then ``[..., :3]``; elsewhere the port's defined result
(grey replicated to RGB, alpha dropped, a sample of d bits divided by
2^d - 1 in float64 and then rounded to float32; the rules of
``expected``). The expected textures of the small files are
``expected.npz`` (the samples, to be divided by the manifest's
``divisor`` in float64 and rounded to float32); those of the 1024 x 1024
files a SHA-256 of the port's samples (imageio's pixels under the
rule). Every file imageio reads also records the SHA-256 of imageio's
array (``imageio_sha256``), and the manifest records the versions of the
tools that made it. Files the port
must refuse carry the word its ``ValueError`` names instead, and what
imageio's own refusal of them says.

imageio picks its plugin by the file's name (``image_files.imageio_route``
in the port), so every fixture also records in ``opencv_route`` what
imageio gives for a copy named ``.pbm`` and one named ``.hdr``, which
OpenCV reads first: the plugin (``opencv`` where ``cv2.haveImageReader``
takes the bytes, else ``pillow``), and the shape, type and SHA-256 of
imageio's array, or its refusal. ``route_files`` are the Radiance HDR and
Sun raster fixtures (``route_cases``: Radiance files written with
``cv2.imwrite`` and by hand, Sun raster files by hand), each with what
imageio gives under its own name and under the other names of
``ROUTE_NAMES``.
Deterministic: a second run writes the same bytes.
"""
from __future__ import annotations

import hashlib
import io
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


# ------------------------------------------------------------- the images
def smooth(H, W, seed):
    """A smooth synthetic RGB texture with some detail."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    p = np.random.default_rng(seed).uniform(0, 2 * np.pi, 3)
    r = 127 + 120 * np.sin(x / 7.3 + p[0]) * np.cos(y / 5.1)
    g = 127 + 110 * np.sin((x + 2 * y) / 9.7 + p[1])
    b = 127 + 120 * np.cos(np.hypot(x - W / 3, y - H / 2) / 4.9 + p[2])
    return np.stack([r, g, b], -1).clip(0, 255).astype(np.uint8)


def textured(H, W, seed):
    """Half smooth, half noise: every sample value and sharp edges."""
    img = smooth(H, W, seed)
    noise = np.random.default_rng(seed + 100).integers(0, 256, (H, W, 3))
    img[:, W // 2:] = noise[:, W // 2:]
    return img


def big(n=1024):
    """The 1024 x 1024 smooth texture of the decode-time fixtures."""
    y, x = np.mgrid[0:n, 0:n].astype(np.float64)
    r = 127 + 120 * np.sin(x / 37.0) * np.cos(y / 23.0)
    g = 127 + 100 * np.sin((x + 2 * y) / 51.0)
    b = 127 + 120 * np.cos(np.hypot(x - 500, y - 400) / 29.0)
    return np.stack([r, g, b], -1).clip(0, 255).astype(np.uint8)


# ---------------------------------------------------------------- writers
def pil_bytes(arr_or_img, fmt, **kw):
    from PIL import Image
    img = arr_or_img if isinstance(arr_or_img, Image.Image) else \
        Image.fromarray(arr_or_img)
    f = io.BytesIO()
    img.save(f, fmt, **kw)
    return f.getvalue()


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filter_rows(raw, bpp, seed):
    """PNG rows (h, stride) with a filter byte each: every filter type, in
    turn from a seeded start, so the reader undoes all five."""
    h, stride = raw.shape
    out = bytearray()
    prev = np.zeros(stride, np.int32)
    start = seed % 5
    for y in range(h):
        cur = raw[y].astype(np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        t = (start + y) % 5
        if t == 0:
            pred = np.zeros_like(cur)
        elif t == 1:
            pred = a
        elif t == 2:
            pred = prev
        elif t == 3:
            pred = (a + prev) >> 1
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, c))
        out.append(t)
        out += ((cur - pred) & 255).astype(np.uint8).tobytes()
        prev = cur
    return bytes(out)


def _pack_rows(samples, depth):
    """(h, w, C) samples -> (h, stride) bytes at ``depth`` bits."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    bits = ((samples[..., 0, None] >> np.arange(depth - 1, -1, -1)) & 1)
    return np.packbits(bits.reshape(h, w * depth).astype(np.uint8), axis=1)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def png_bytes(samples, depth, ctype, interlace=False, palette=None,
              trns=None, seed=0):
    """A PNG of (H, W, C) samples at ``depth`` bits, colour type ``ctype``,
    Adam7 when ``interlace``; rows filtered with every filter type."""
    H, W, C = samples.shape
    bpp = max(1, depth * C // 8)
    if interlace:
        data = b""
        for k, (x0, y0, dx, dy) in enumerate(ADAM7):
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                data += _filter_rows(_pack_rows(sub, depth), bpp, seed + k)
    else:
        data = _filter_rows(_pack_rows(samples, depth), bpp, seed)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    # two IDAT chunks: the reader joins them
    z = zlib.compress(data, 9)
    half = len(z) // 2
    return (out + _chunk(b"IDAT", z[:half]) + _chunk(b"IDAT", z[half:])
            + _chunk(b"IEND", b""))


def bmp_bytes(img, bits=24, top_down=False, palette=None):
    """A BI_RGB BMP (40-byte header) of (H, W, 3) RGB at 24 bits, or of
    (H, W) palette indices at 4 or 8 bits."""
    H, W = img.shape[:2]
    stride = (W * bits + 31) // 32 * 4
    rows = np.zeros((H, stride), np.uint8)
    if bits == 24:
        rows[:, :3 * W] = img[..., ::-1].reshape(H, 3 * W)
    else:
        rows[:, :(W * bits + 7) // 8] = _pack_rows(img[..., None], bits)
    if not top_down:
        rows = rows[::-1]
    pal = b""
    if palette is not None:
        quad = np.zeros((len(palette), 4), np.uint8)
        quad[:, :3] = palette[:, ::-1]
        pal = quad.tobytes()
    offset = 14 + 40 + len(pal)
    head = b"BM" + struct.pack("<IHHI", offset + rows.size, 0, 0, offset)
    info = struct.pack("<IiiHHIIiiII", 40, W, -H if top_down else H, 1, bits,
                       0, rows.size, 2835, 2835,
                       0 if palette is None else len(palette), 0)
    return head + info + pal + rows.tobytes()


def patch_jpeg(data, fn):
    """Apply ``fn(marker, bytearray, payload_start, payload_len)`` to each
    marker segment before the first scan."""
    b = bytearray(data)
    pos = 2
    while pos < len(b):
        m = b[pos + 1]
        n = (b[pos + 2] << 8) | b[pos + 3]
        fn(m, b, pos + 4, n - 2, pos)
        if m == 0xDA:
            break
        pos += 2 + n
    return bytes(b)


def set_byte(marker, offset, value):
    def fn(m, b, p, n, pos):
        if m == marker:
            b[p + offset] = value
    return fn


def set_marker(old, new):
    def fn(m, b, p, n, pos):
        if m == old:
            b[pos + 1] = new
    return fn


def first_scans(data, k):
    """A progressive JPEG's first ``k`` scans, then EOI."""
    sos = [i for i in range(len(data) - 1)
           if data[i] == 0xFF and data[i + 1] == 0xDA]
    return data[:sos[k]] + b"\xff\xd9"


def without_dht(data):
    """A JPEG with its DHT segments (before the first scan) removed."""
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        n = 2 + (data[pos + 2] << 8 | data[pos + 3])
        if data[pos + 1] != 0xC4:
            out += data[pos:pos + n]
        pos += n
    return bytes(out + data[pos:])


def bmp_rle(idx, rle4=False):
    """A BI_RLE8 (or BI_RLE4) code stream of (H, W) palette indices,
    bottom row first: encoded runs of equal indices, absolute runs (padded
    to a 16-bit word) for the rest, an end of line per row and the end of
    the bitmap. A row that is all index 0 after its first run is ended by
    its end of line alone (Pillow pads it with 0)."""
    H, W = idx.shape
    out = bytearray()
    for row in idx[::-1]:
        row = [int(v) for v in row]
        x = 0
        while x < W:
            if not any(row[x:]):          # the rest is index 0: end the row
                break
            n = 1
            if rle4:
                while x + n < W and n < 255 and row[x + n] == row[x + n % 2]:
                    n += 1
            else:
                while x + n < W and n < 255 and row[x + n] == row[x]:
                    n += 1
            if n >= 3 or W - x < 3:
                a, b = row[x], row[x + 1] if rle4 and x + 1 < W else row[x]
                out += bytes([n, (a << 4 | b) if rle4 else a])
                x += n
                continue
            # an absolute run up to the next run of 3 (at least 3 long)
            m = 3
            while x + m < W and m < 255 and not (
                    x + m + 2 < W and row[x + m] == row[x + m + 1]
                    == row[x + m + 2]):
                m += 1
            if rle4:
                m -= m % 2                     # Pillow keeps 2 * (m // 2)
                vals = row[x:x + m]
                body = bytes(vals[i] << 4 | vals[i + 1]
                             for i in range(0, m, 2))
            else:
                body = bytes(row[x:x + m])
            out += bytes([0, m]) + body
            if len(body) % 2:
                out.append(0)
            x += m
        out += b"\x00\x00"
    out += b"\x00\x01"
    return bytes(out)


def bmp_file(pixels, W, H, bits, compression=0, palette=None, masks=None,
             header=40):
    """A BMP of already encoded pixel data (bottom-up unless H < 0), a
    palette of (n, 3) RGB and BI_BITFIELDS masks (after a 40-byte header,
    inside a longer one)."""
    pal = b""
    if palette is not None:
        quad = np.zeros((len(palette), 4), np.uint8)
        quad[:, :3] = np.asarray(palette)[:, ::-1]
        pal = quad.tobytes()
    info = struct.pack("<IiiHHIIiiII", header, W, H, 1, bits, compression,
                       len(pixels), 2835, 2835,
                       0 if palette is None else len(palette), 0)
    if masks is not None:
        m = struct.pack("<4I", *(tuple(masks) + (0,) * 4)[:4])
        info += m[:12] if header == 40 else m
    info += bytes(max(0, 14 + header - 14 - len(info)))
    offset = 14 + len(info) + len(pal)
    head = b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
    return head + info + pal + pixels


def bmp_rows(raw_rows):
    """(H, n) bytes -> padded rows, bottom row first."""
    H, n = raw_rows.shape
    stride = (n + 3) // 4 * 4
    rows = np.zeros((H, stride), np.uint8)
    rows[:, :n] = raw_rows
    return rows[::-1].tobytes()


def tga_file(kind, W, H, depth, pixels, cmap=None, cmap_start=0,
             cmap_depth=0, flags=0x20):
    """A TGA of already encoded pixel data, with an optional colour map of
    already encoded entries."""
    head = struct.pack("<BBBHHBHHHHBB", 0, int(cmap is not None), kind,
                       cmap_start, 0 if cmap is None else
                       len(cmap) // (cmap_depth // 8), cmap_depth, 0, 0, W,
                       H, depth, flags)
    return head + (cmap or b"") + pixels


def tga_rle(px, bpp):
    """TGA run-length packets of (n, bpp) pixels."""
    out = bytearray()
    i, n = 0, len(px)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and np.array_equal(px[j], px[i]):
            j += 1
        if j - i >= 2:
            out.append(0x80 | (j - i - 1))
            out += px[i].tobytes()
            i = j
            continue
        j = i + 1
        while j < n and j - i < 128 and not (
                j + 1 < n and np.array_equal(px[j], px[j + 1])):
            j += 1
        out.append(j - i - 1)
        out += px[i:j].tobytes()
        i = j
    return bytes(out)


def argb1555(rgb, alpha_bit):
    """(..., 3) 8-bit RGB -> little-endian A1R5G5B5 (..., 2) bytes."""
    c = rgb.astype(np.uint16) >> 3
    v = (alpha_bit.astype(np.uint16) << 15) | (c[..., 0] << 10) \
        | (c[..., 1] << 5) | c[..., 2]
    return v.astype("<u2").view(np.uint8).reshape(rgb.shape[:-1] + (2,))


def lzw_gif(idx, mcs):
    """GIF LZW of palette indices (a plain encoder, independent of the
    port's)."""
    clear, eoi = 1 << mcs, (1 << mcs) + 1
    out, acc, nbits = bytearray(), 0, 0
    size = mcs + 1

    def emit(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    table = {(i,): i for i in range(clear)}
    nxt = eoi + 1
    emit(clear)
    w = ()
    for v in (int(x) for x in np.asarray(idx).reshape(-1)):
        wv = w + (v,)
        if wv in table:
            w = wv
            continue
        emit(table[w])
        if nxt < 4096:
            table[wv] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        else:
            emit(clear)
            table = {(i,): i for i in range(clear)}
            nxt, size = eoi + 1, mcs + 1
        w = (v,)
    emit(table[w])
    emit(eoi)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def gif_file(screen, frames, gct=None, bg=0):
    """A GIF: a logical screen (W, H), an optional global table and frames
    (dict: x, y, idx, and optional lct, trans, interlace, mcs, data)."""
    out = bytearray(b"GIF89a")
    flags = 0
    if gct is not None:
        flags = 0x80 | (int(np.log2(len(gct))) - 1)
    out += struct.pack("<HHBBB", screen[0], screen[1], flags, bg, 0)
    if gct is not None:
        out += np.asarray(gct, np.uint8).tobytes()
    for fr in frames:
        if "trans" in fr:
            out += b"\x21\xf9\x04" + struct.pack("<BHBB", 1, 10, fr["trans"],
                                                 0)
        idx = fr["idx"]
        h, w = idx.shape
        lf = 0
        if fr.get("lct") is not None:
            lf = 0x80 | (int(np.log2(len(fr["lct"]))) - 1)
        if fr.get("interlace"):
            lf |= 0x40
            idx = np.concatenate([idx[0::8], idx[4::8], idx[2::4],
                                  idx[1::2]])
        out += b"\x2c" + struct.pack("<HHHHB", fr["x"], fr["y"], w, h, lf)
        if fr.get("lct") is not None:
            out += np.asarray(fr["lct"], np.uint8).tobytes()
        mcs = fr.get("mcs", 8)
        out.append(mcs)
        data = fr.get("data") or lzw_gif(idx, mcs)
        for s in range(0, len(data), 255):
            out.append(len(data[s:s + 255]))
            out += data[s:s + 255]
        out.append(0)
    out.append(0x3B)
    return bytes(out)


def lzw_tiff(data):
    """TIFF LZW of a byte string: codes MSB first, 9 bits after a clear,
    one bit wider once the decoder's table will hold 511, 1023 and 2047
    entries, a clear before the table reaches 4094."""
    out, acc, nbits, size = bytearray(), 0, 0, 9

    def emit(code):
        nonlocal acc, nbits
        acc = (acc << size) | code
        nbits += size
        while nbits >= 8:
            out.append((acc >> (nbits - 8)) & 255)
            nbits -= 8
        acc &= (1 << nbits) - 1

    def widen(n):
        return {512: 10, 1024: 11, 2048: 12}.get(n, size)

    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    emit(256)
    w = b""
    for v in data:
        wv = w + bytes([v])
        if wv in table:
            w = wv
            continue
        emit(table[w])
        table[wv] = nxt
        nxt += 1
        size = widen(nxt)
        if nxt >= 4094:
            emit(256)
            table = {bytes([i]): i for i in range(256)}
            nxt, size = 258, 9
        w = bytes([v])
    if w:
        emit(table[w])
        size = widen(nxt + 1)
    emit(257)
    if nbits:
        out.append((acc << (8 - nbits)) & 255)
    return bytes(out)


def packbits(data):
    """PackBits of a byte string."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n
                                             and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


# T.4's code words (first bit first): terminating codes of runs 0-63,
# make-up codes of 64-1728, the make-up codes of 1792-2560 both colours share
FAX_WHITE = """00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111
01000 001000 000011 110100 110101 101010 101011 0100111 0001100 0001000
0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 00000010
00000011 00011010 00011011 00010010 00010011 00010100 00010101 00010110
00010111 00101000 00101001 00101010 00101011 00101100 00101101 00000100
00000101 00001010 00001011 01010010 01010011 01010100 01010101 00100100
00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010
00110011 00110100""".split()
FAX_WHITE_MAKEUP = """11011 10010 010111 0110111 00110110 00110111 01100100
01100101 01101000 01100111 011001100 011001101 011010010 011010011
011010100 011010101 011010110 011010111 011011000 011011001 011011010
011011011 010011000 010011001 010011010 011000 010011011""".split()
FAX_BLACK = """0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100
0000101 0000111 00000100 00000111 000011000 0000010111 0000011000
0000001000 00001100111 00001101000 00001101100 00000110111 00000101000
00000010111 00000011000 000011001010 000011001011 000011001100
000011001101 000001101000 000001101001 000001101010 000001101011
000011010010 000011010011 000011010100 000011010101 000011010110
000011010111 000001101100 000001101101 000011011010 000011011011
000001010100 000001010101 000001010110 000001010111 000001100100
000001100101 000001010010 000001010011 000000100100 000000110111
000000111000 000000100111 000000101000 000001011000 000001011001
000000101011 000000101100 000001011010 000001100110 000001100111""".split()
FAX_BLACK_MAKEUP = """0000001111 000011001000 000011001001 000001011011
000000110011 000000110100 000000110101 0000001101100 0000001101101
0000001001010 0000001001011 0000001001100 0000001001101 0000001110010
0000001110011 0000001110100 0000001110101 0000001110110 0000001110111
0000001010010 0000001010011 0000001010100 0000001010101 0000001011010
0000001011011 0000001100100 0000001100101""".split()
FAX_EXT_MAKEUP = """00000001000 00000001100 00000001101 000000010010
000000010011 000000010100 000000010101 000000010110 000000010111
000000011100 000000011101 000000011110 000000011111""".split()
FAX_EOL = "000000000001"
FAX_VERTICAL = {0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010",
                -2: "000010", -3: "0000010"}


def fax_run(n, black):
    """The code words of a run of ``n`` pixels of one colour."""
    out = []
    while n >= 2560 + 64 or n == 2560:
        out.append(FAX_EXT_MAKEUP[-1])
        n -= 2560
    if n >= 64:
        m = n // 64
        out.append((FAX_BLACK_MAKEUP if black else FAX_WHITE_MAKEUP)[m - 1]
                   if m <= 27 else FAX_EXT_MAKEUP[m - 28])
        n -= 64 * m
    out.append((FAX_BLACK if black else FAX_WHITE)[n])
    return "".join(out)


def fax_changes(row):
    """The changing elements of a row of 0/1 (1 black, white before it)."""
    return list(np.nonzero(np.diff(np.concatenate(
        [[0], np.asarray(row, np.int8)])))[0]) + [len(row)]


def fax_1d(row):
    """A row in modified Huffman (T.4 one-dimensional) coding."""
    out, pos, black = [], 0, False
    for c in fax_changes(row):
        out.append(fax_run(c - pos, black))
        pos, black = c, not black
    return "".join(out)


def fax_2d(row, ref):
    """A row in modified READ (T.4 two-dimensional, T.6) coding against
    the reference row ``ref``."""
    W = len(row)
    cur, refc = fax_changes(row)[:-1], fax_changes(ref)[:-1]
    out, a0, black = [], -1, False

    def after(changes, x, colour=None):
        for i, c in enumerate(changes):
            # even changes turn to black, odd ones to white
            if c > x and (colour is None or (i % 2 == 0) == colour):
                return c, (changes[i + 1] if i + 1 < len(changes) else W)
        return W, W

    while a0 < W:
        b1, b2 = after(refc, a0, not black)
        a1, _ = after(cur, a0)
        if b2 < a1:                                   # pass
            out.append("0001")
            a0 = b2
        elif abs(a1 - b1) <= 3:                       # vertical
            out.append(FAX_VERTICAL[a1 - b1])
            a0, black = a1, not black
        else:                                         # horizontal
            a2, _ = after(cur, a1)
            out.append("001" + fax_run(a1 - max(a0, 0), black)
                       + fax_run(a2 - a1, not black))
            a0 = a2
    return "".join(out)


def fax_encode(rows, compression, t4=0, eol=True, lsb_first=False):
    """(h, w) 0/1 rows (1 black) as CCITT data: compression 2 (rows
    byte-aligned), 3 (an EOL before each row; ``t4`` bit 0: 2-D coding,
    every other row 1-D, each row tagged; bit 2: fill bits aligning each
    EOL's end to a byte; ``eol`` False leaves the EOLs out), 4 (T.6, ended
    by an EOFB) or 32771 (rows aligned to 16 bits). ``lsb_first``: the
    bits of each byte reversed (FillOrder 2)."""
    bits, ref = "", np.zeros(rows.shape[1], np.uint8)
    for y, row in enumerate(rows):
        if compression == 4:
            bits += fax_2d(row, ref)
        elif compression in (2, 32771):
            bits += fax_1d(row)
            bits += "0" * (-len(bits) % (8 if compression == 2 else 16))
        else:
            if t4 & 4:
                bits += "0" * (-(len(bits) + 12) % 8)
            bits += FAX_EOL if eol else ""
            if t4 & 1:
                bits += "1" + fax_1d(row) if y % 2 == 0 else \
                    "0" + fax_2d(row, ref)
            else:
                bits += fax_1d(row)
        ref = row
    if compression == 4:
        bits += FAX_EOL * 2
    bits += "0" * (-len(bits) % 8)
    data = bytes(int(bits[i:i + 8][::-1] if lsb_first else bits[i:i + 8],
                     2) for i in range(0, len(bits), 8))
    return data


def sgilog_planes(words, nbytes):
    """One row of LogL16 (``nbytes`` 2) or LogLuv32 (4) words in SGILog's
    run-length coding: each byte plane, the most significant first, as
    runs (128 + n - 2, the byte: 2-129 of it) and literals (n, then n
    bytes: 1-127)."""
    out = bytearray()
    for k in range(nbytes - 1, -1, -1):
        plane = [(int(w) >> (8 * k)) & 255 for w in words]
        i = 0
        while i < len(plane):
            j = i
            while j < len(plane) and plane[j] == plane[i] and j - i < 129:
                j += 1
            if j - i >= 2:
                out += bytes([128 + j - i - 2, plane[i]])
                i = j
                continue
            j = i + 1
            while j < len(plane) and j - i < 127 and not (
                    j + 1 < len(plane) and plane[j] == plane[j + 1]):
                j += 1
            out += bytes([j - i]) + bytes(plane[i:j])
            i = j
    return bytes(out)


TIFF_COMPRESS = {1: lambda b: b, 5: lzw_tiff, 8: lambda b: zlib.compress(b, 9),
                 32773: packbits, 34925: lambda b: __import__("lzma").compress(
                     b, format=__import__("lzma").FORMAT_XZ)}


def tiff_file(samples, photometric, order="<", big=False, compression=1,
              planar=1, predictor=1, rows_per_strip=None, tile=None,
              colormap=None, bits=None, sample_format=1, extra=(),
              fillorder=1, extra_tags=(), depth=1, fax=None, sgilog=None):
    """A TIFF of (H, W, S) samples: classic or BigTIFF, either byte order,
    strips or tiles, either planar configuration, predictor 1, 2 or 3, a
    colour map, samples of any width (``bits``, packed per row, the most
    significant bit first) or packed RGB (``bits`` a tuple such as (5, 6,
    5), one integer a pixel), an SGI ``ImageDepth`` (``depth`` planes of
    H / depth rows, one after the other). ``fax``: 1-bit samples coded by
    ``fax_encode`` (its keywords; compression 2, 3, 4 or 32771, the
    Group3Options tag from ``t4``). ``sgilog``: the samples are LogL16
    (``"l16"``) or LogLuv32 (``"luv32"``) words, coded by
    ``sgilog_planes``, or LogLuv24 words (``"luv24"``, three bytes each)."""
    H, W, S = samples.shape
    dt = samples.dtype
    bits = bits or dt.itemsize * 8
    item = dt.itemsize

    def encode_block(block):          # (h, w, c) -> bytes
        h, w, c = block.shape
        if fax is not None:         # the codec's own bit order
            return fax_encode(block[..., 0], compression,
                              lsb_first=fillorder == 2, **fax)
        if predictor == 2:
            d = block.astype(dt)
            d[:, 1:] = block[:, 1:] - block[:, :-1]
            block = d
        if sgilog == "luv24":
            v = block[..., 0].astype(np.uint32)
            raw = np.stack([v >> 16, v >> 8, v], -1).astype(
                np.uint8).tobytes()
        elif sgilog is not None:
            raw = b"".join(sgilog_planes(r[:, 0], 2 if sgilog == "l16" else
                                         4) for r in block)
        elif predictor == 3:
            raw = np.ascontiguousarray(block).astype("<" + dt.str[1:])
            by = raw.view(np.uint8).reshape(h, w, c, item)[..., ::-1]
            by = by.transpose(0, 3, 1, 2).reshape(h, item * w * c)
            diff = by.copy()
            diff[:, c:] = by[:, c:] - by[:, :-c]
            raw = diff.tobytes()
        elif isinstance(bits, tuple):   # packed RGB, one integer a pixel
            v = np.zeros((h, w), np.uint32)
            for i, b in enumerate(bits):
                v = (v << b) | block[..., i].astype(np.uint32)
            raw = v.astype(order + ("u2" if sum(bits) <= 16 else "u4")
                           ).tobytes()
        elif bits != 8 * item:        # most significant bit first
            v = block.reshape(h, w * c).astype(np.uint64)
            b = (v[..., None] >> np.arange(bits - 1, -1, -1, dtype=np.uint64)
                 ) & np.uint64(1)
            raw = np.packbits(b.reshape(h, w * c * bits).astype(np.uint8),
                              axis=1).tobytes()
        else:
            raw = np.ascontiguousarray(block).astype(
                order + dt.str[1:]).tobytes()
        raw = TIFF_COMPRESS.get(compression, lambda b: b)(raw)
        if fillorder == 2:     # the bits of the stored bytes reversed
            raw = bytes(int(f"{x:08b}"[::-1], 2) for x in raw)
        return raw

    planes = [samples] if planar == 1 else [samples[..., i:i + 1]
                                            for i in range(S)]
    blocks = []
    for p in planes:
        if tile is None:
            rps = rows_per_strip or H
            for y in range(0, H, rps):
                blocks.append(encode_block(p[y:y + rps]))
        else:
            tw, tl = tile
            for y in range(0, H, tl):
                for x in range(0, W, tw):
                    t = np.zeros((tl, tw, p.shape[2]), dt)
                    part = p[y:y + tl, x:x + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    blocks.append(encode_block(t))
    first = 16 if big else 8
    data = bytearray()
    offsets = []
    for b in blocks:
        offsets.append(first + len(data))
        data += b
        if len(data) % 2:
            data.append(0)
    tags = [(256, 4, [W]), (257, 4, [H // depth]),
            (258, 3, list(bits) if isinstance(bits, tuple) else [bits] * S),
            (259, 3, [compression]), (262, 3, [photometric]),
            (277, 3, [S]), (284, 3, [planar])]
    if fillorder != 1:
        tags.append((266, 3, [fillorder]))
    if fax and fax.get("t4"):
        tags.append((292, 4, [fax["t4"]]))
    if depth != 1:
        tags.append((32997, 4, [depth]))
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if sample_format != 1:
        tags.append((339, 3, list(sample_format) if isinstance(
            sample_format, tuple) else [sample_format] * S))
    if extra:
        tags.append((338, 3, list(extra)))
    if colormap is not None:
        tags.append((320, 3, list(np.asarray(colormap).T.reshape(-1))))
    cnt_type = 16 if big else 4
    if tile is None:
        tags += [(273, cnt_type, offsets), (278, 4, [rows_per_strip or H]),
                 (279, cnt_type, [len(b) for b in blocks])]
    else:
        tags += [(322, 3, [tile[0]]), (323, 3, [tile[1]]),
                 (324, cnt_type, offsets),
                 (325, cnt_type, [len(b) for b in blocks])]
    tags += list(extra_tags)
    tags.sort()
    fmt = {3: "H", 4: "I", 5: "I", 10: "i", 16: "Q"}   # a rational: two
    ifd_at = first + len(data)
    entry, inline = (20, 8) if big else (12, 4)
    ifd_size = (8 if big else 2) + entry * len(tags) + (8 if big else 4)
    spill = bytearray()
    ifd = bytearray(struct.pack(order + ("Q" if big else "H"), len(tags)))
    for code, kind, values in tags:
        body = struct.pack(order + fmt[kind] * len(values), *values)
        head = struct.pack(order + "HH" + ("Q" if big else "I"), code, kind,
                           len(values) // (2 if kind in (5, 10) else 1))
        if len(body) <= inline:
            ifd += head + body + bytes(inline - len(body))
        else:
            at = ifd_at + ifd_size + len(spill)
            ifd += head + struct.pack(order + ("Q" if big else "I"), at)
            spill += body
            if len(spill) % 2:
                spill.append(0)
    ifd += bytes(8 if big else 4)
    magic = (b"II" if order == "<" else b"MM") + struct.pack(
        order + "H", 43 if big else 42)
    if big:
        header = magic + struct.pack(order + "HHQ", 8, 0, ifd_at)
    else:
        header = magic + struct.pack(order + "I", ifd_at)
    return bytes(header + data + ifd + spill)


# ------------------------------------------- JPEG: the generator's own coder
# What Pillow cannot write: sampling factors 3 and 4, YCCK, arithmetic
# coding (ITU T.81 annex D, as libjpeg's jcarith.c codes it), lossless
# JPEG (annex H) and frames without Huffman tables. The coefficients come
# from an orthonormal DCT (scipy.fft.dctn, which is the JPEG FDCT) of
# edge-padded blocks, quantized by the tables of annex K scaled to a
# quality; libjpeg decodes the files, so imageio is the oracle.
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
QT_ANNEX_K = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103,
     99],
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32])


def jpeg_quant(quality):
    """The annex K tables (natural order) scaled as libjpeg's quality."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((QT_ANNEX_K * scale + 50) // 100, 1, 255)


def ycbcr(rgb):
    """JFIF's RGB -> YCbCr, rounded, as uint8."""
    x = rgb.astype(np.float64)
    y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    cb = -0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2]
    cr = 0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2]
    return np.rint(np.stack([y, cb + 128, cr + 128], -1)).clip(
        0, 255).astype(np.uint8)


def std_huffman():
    """The annex K.3 tables ((counts, values) of DC 0, AC 0, DC 1, AC 1),
    read from a Pillow file, which codes with them."""
    data = pil_bytes(np.zeros((8, 8, 3), np.uint8), "JPEG")
    tables, pos = {}, 2
    while data[pos + 1] != 0xDA:
        n = data[pos + 2] << 8 | data[pos + 3]
        p, end = pos + 4, pos + 2 + n
        while data[pos + 1] == 0xC4 and p < end:
            counts = list(data[p + 1:p + 17])
            tables[data[p]] = (counts, list(data[p + 17:p + 17 + sum(counts)]))
            p += 17 + sum(counts)
        pos += 2 + n
    return [tables[k] for k in (0x00, 0x10, 0x01, 0x11)]


def huffman_codes(counts, values):
    """symbol -> (code, length) of a canonical Huffman table."""
    codes, code, k = {}, 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            codes[values[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


class BitWriter:
    """Huffman-coded bits, MSB first, 0xFF stuffed with 0x00; padded with
    one bits."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, bits):
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.n += bits
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        out, self.out = bytes(self.out), bytearray()
        return out


def _aritab():
    """jaricom.c's table (ITU T.81 table D.2), as libjpeg packs it."""
    rows = (
        (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
        (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
        (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
        (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
        (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
        (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
        (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
        (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
        (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
        (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
        (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
        (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
        (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
        (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
        (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
        (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
        (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
        (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
        (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
        (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
        (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
        (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
        (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
        (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
        (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
        (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
        (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
        (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
        (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
        (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
        (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
        (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
        (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
        (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
        (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
        (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
        (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
        (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))
    return [qe << 16 | mps << 8 | switch << 7 | lps
            for qe, lps, mps, switch in rows]


ARITAB = _aritab()


class ArithEncoder:
    """jcarith.c's QM coder: arith_encode and finish_pass."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = \
            0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def _stacked(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self._emit(self.buffer)
        if self.sc:
            self._zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def _carry(self):
        if self.buffer >= 0:
            self._zeros()
            self._emit(self.buffer + 1)
        self.zc += self.sc
        self.sc = 0

    def encode(self, st, i, val):
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._stacked()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                return

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._stacked()
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
        out = bytes(self.out)
        self.__init__()
        return out


def _segment(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _category(v):
    return int(abs(int(v))).bit_length()


def _bits(v, s):
    return v if v >= 0 else v + (1 << s) - 1


class _ArithState:
    """The statistics of one scan (jcarith.c arith_entropy_encoder)."""

    def __init__(self, dac):
        self.dc = [bytearray(64) for _ in range(16)]
        self.ac = [bytearray(256) for _ in range(16)]
        self.fixed = bytearray([113])
        self.L, self.U, self.K = [0] * 16, [1] * 16, [5] * 16
        for tbl, (L, U, K) in (dac or {}).items():
            self.L[tbl], self.U[tbl], self.K[tbl] = L, U, K

    def dc_value(self, E, tbl, ctx, v):
        """Encode_DC_DIFF (figures F.4, F.6-F.9); returns the new
        context."""
        st = self.dc[tbl]
        if v == 0:
            E.encode(st, ctx, 0)
            return 0
        E.encode(st, ctx, 1)
        if v > 0:
            E.encode(st, ctx + 1, 0)
            i, new = ctx + 2, 4
        else:
            v = -v
            E.encode(st, ctx + 1, 1)
            i, new = ctx + 3, 8
        m, v = 0, v - 1
        if v:
            E.encode(st, i, 1)
            m, v2, i = 1, v >> 1, 20
            while v2:
                E.encode(st, i, 1)
                m, v2, i = m << 1, v2 >> 1, i + 1
        E.encode(st, i, 0)
        if m < (1 << self.L[tbl]) >> 1:
            new = 0
        elif m > (1 << self.U[tbl]) >> 1:
            new += 8
        i += 14
        m >>= 1
        while m:
            E.encode(st, i, 1 if m & v else 0)
            m >>= 1
        return new

    def ac_values(self, E, tbl, zz, ss, se):
        """Encode_AC_Coefficients (figure F.5) of zz[ss..se], already
        point-transformed."""
        st = self.ac[tbl]
        ke = se
        while ke >= ss and zz[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            E.encode(st, i, 0)
            while zz[k] == 0:
                E.encode(st, i + 1, 0)
                i, k = i + 3, k + 1
            v = int(zz[k])
            E.encode(st, i + 1, 1)
            E.encode(self.fixed, 0, 1 if v < 0 else 0)
            v, i = abs(v), i + 2
            m, v = 0, v - 1
            if v:
                E.encode(st, i, 1)
                m, v2 = 1, v >> 1
                if v2:
                    E.encode(st, i, 1)
                    m, i = m << 1, (189 if k <= self.K[tbl] else 217)
                    v2 >>= 1
                    while v2:
                        E.encode(st, i, 1)
                        m, v2, i = m << 1, v2 >> 1, i + 1
            E.encode(st, i, 0)
            i += 14
            m >>= 1
            while m:
                E.encode(st, i, 1 if m & v else 0)
                m >>= 1
            k += 1
        if k <= se:
            E.encode(st, 3 * (k - 1), 1)

    def ac_refine(self, E, tbl, zz, ss, se, al):
        """Encode_AC_Coefficients_SA (figure G.10) of the bit al."""
        st = self.ac[tbl]
        a = np.abs(zz.astype(np.int64))
        ke = se
        while ke > 0 and not a[ke] >> al:
            ke -= 1
        kex = ke
        while kex > 0 and not a[kex] >> (al + 1):
            kex -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                E.encode(st, i, 0)
            while True:
                v = int(a[k]) >> al
                if v:
                    if v >> 1:
                        E.encode(st, i + 2, v & 1)
                    else:
                        E.encode(st, i + 1, 1)
                        E.encode(self.fixed, 0, 1 if zz[k] < 0 else 0)
                    break
                E.encode(st, i + 1, 0)
                i, k = i + 3, k + 1
            k += 1
        if k <= se:
            E.encode(st, 3 * (k - 1), 1)


# libjpeg's jpeg_simple_progression for three components (and for one:
# its first, Y, scans): (components, Ss, Se, Ah, Al)
PROGRESSION = (((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
               ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
               ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
               ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
               ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0))


def jpeg_encode(samples, factors, coding="huffman", progressive=False,
                restart=0, dac=None, tables=True, quality=90, ids=None,
                adobe=None, jfif=True, scans=None):
    """A DCT JPEG of (H, W, C) uint8 samples, already in the colour space
    the file declares (C = 1, 3 or 4), each component sampled at its
    (h, v) of ``factors``: Huffman-coded with the annex K tables (no DHT
    segment when not ``tables``: a Motion-JPEG frame) or arithmetic-coded
    (sequential or progressive, DAC conditioning ``dac`` = {table: (L, U,
    Kx)}), with a DRI of ``restart`` MCUs, JFIF or Adobe (``adobe`` =
    transform) markers and component ``ids``."""
    from scipy.fft import dctn
    H, W, C = samples.shape
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    qt = jpeg_quant(quality)
    comps = []
    for c, (h, v) in enumerate(factors):
        fx, fy = hmax // h, vmax // v
        dw, dh = -(-W * h // hmax), -(-H * v // vmax)
        if hmax % h or vmax % v:     # a fractional ratio: every n-th sample
            plane = samples[np.arange(dh) * vmax // v][
                :, np.arange(dw) * hmax // h, c].astype(np.float64)
        else:
            full = np.pad(samples[..., c].astype(np.float64),
                          ((0, dh * fy - H), (0, dw * fx - W)), mode="edge")
            plane = full.reshape(dh, fy, dw, fx).mean((1, 3))
        bw, bh = mx * h, my * v
        plane = np.pad(plane, ((0, bh * 8 - dh), (0, bw * 8 - dw)),
                       mode="edge")
        blocks = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128
        coef = dctn(blocks, axes=(2, 3), norm="ortho").reshape(bh, bw, 64)
        q = qt[min(c, 1)]
        comps.append(dict(h=h, v=v, dw=dw, dh=dh, tbl=min(c, 1),
                          zz=np.rint(coef / q).astype(np.int64)[..., NATURAL]))
    if scans is None:
        scans = (PROGRESSION if C == 3 else
                 [s for s in PROGRESSION if s[0][0] == 0]) if progressive \
            else [(tuple(range(C)), 0, 63, 0, 0)]
        if progressive and C == 1:
            scans = [((0,),) + s[1:] for s in scans]
    std = std_huffman()
    dc_codes = [huffman_codes(*std[0]), huffman_codes(*std[2])]
    ac_codes = [huffman_codes(*std[1]), huffman_codes(*std[3])]
    out = b"\xff\xd8"
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                     adobe))
    out += _segment(0xDB, b"".join(
        bytes([t]) + qt[t][NATURAL].astype(np.uint8).tobytes()
        for t in range(min(C, 2))))
    sof = (0xCA if progressive else 0xC9) if coding == "arithmetic" else \
        0xC0
    ids = ids or list(range(1, C + 1))
    out += _segment(sof, struct.pack(">BHHB", 8, H, W, C) + b"".join(
        bytes([ids[c], f[0] << 4 | f[1], min(c, 1)])
        for c, f in enumerate(factors)))
    if dac:
        out += _segment(0xCC, b"".join(
            bytes([t, U << 4 | L, 16 + t, K])
            for t, (L, U, K) in sorted(dac.items())))
    if coding == "huffman" and tables:
        out += _segment(0xC4, b"".join(
            bytes([cls << 4 | t]) + bytes(std[2 * t + cls][0])
            + bytes(std[2 * t + cls][1]) for t in range(min(C, 2))
            for cls in (0, 1)))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    for members, ss, se, ah, al in scans:
        out += _segment(0xDA, bytes([len(members)]) + b"".join(
            bytes([ids[c], comps[c]["tbl"] * 17]) for c in members)
            + bytes([ss, se, ah << 4 | al]))
        out += _scan_data([comps[c] for c in members], mx, my, coding,
                          ss, se, ah, al, restart, dac, dc_codes, ac_codes,
                          progressive)
    return out + b"\xff\xd9"


def _scan_data(cs, mx, my, coding, ss, se, ah, al, restart, dac, dc_codes,
               ac_codes, progressive):
    """The entropy-coded segments of one scan, with RSTn markers."""
    if len(cs) == 1:
        c = cs[0]
        units = [[(0, c["zz"][y, x])] for y in range(-(-c["dh"] // 8))
                 for x in range(-(-c["dw"] // 8))]
    else:
        units = [[(i, c["zz"][y * c["v"] + b, x * c["h"] + a])
                  for i, c in enumerate(cs) for b in range(c["v"])
                  for a in range(c["h"])]
                 for y in range(my) for x in range(mx)]
    out = b""
    arith = coding == "arithmetic"
    w, E = BitWriter(), ArithEncoder()
    state = pred = ctx = None
    for n, mcu in enumerate(units):
        if n == 0 or restart and n % restart == 0:
            if n:
                out += (E.finish() if arith else w.flush()) + bytes(
                    [0xFF, 0xD0 + (n // restart - 1) % 8])
            state, pred, ctx = _ArithState(dac), [0] * len(cs), [0] * len(cs)
        for i, zz in mcu:
            tbl = cs[i]["tbl"]
            if ss == 0 and ah == 0:          # DC (and, sequential, AC)
                dc = int(zz[0]) >> al
                if arith:
                    ctx[i] = state.dc_value(E, tbl, ctx[i], dc - pred[i])
                else:
                    s = _category(dc - pred[i])
                    w.put(*dc_codes[tbl][s])
                    w.put(_bits(dc - pred[i], s), s)
                pred[i] = dc
                if progressive:
                    continue
                if arith:
                    state.ac_values(E, tbl, zz, 1, 63)
                    continue
                run = 0
                for k in range(1, 64):
                    v = int(zz[k])
                    if v == 0:
                        run += 1
                        continue
                    while run > 15:
                        w.put(*ac_codes[tbl][0xF0])
                        run -= 16
                    s = _category(v)
                    w.put(*ac_codes[tbl][run << 4 | s])
                    w.put(_bits(v, s), s)
                    run = 0
                if run:
                    w.put(*ac_codes[tbl][0])
            elif ss == 0:                    # DC refinement
                E.encode(state.fixed, 0, (int(zz[0]) >> al) & 1)
            elif ah == 0:                    # AC first
                t = np.sign(zz) * (np.abs(zz) >> al)
                state.ac_values(E, tbl, t, ss, se)
            else:
                state.ac_refine(E, tbl, zz, ss, se, al)
    return out + (E.finish() if arith else w.flush())


def jpeg_lossless(samples, psv, pt=0, restart_rows=0, adobe=None,
                  jfif=False, tables=True):
    """A lossless (SOF3) JPEG of (H, W, C) uint8 samples, one interleaved
    scan with predictor ``psv`` (1-7) and point transform ``pt``,
    Huffman-coded with annex K's DC tables; a DRI every ``restart_rows``
    rows."""
    H, W, C = samples.shape
    x = samples.astype(np.int64) >> pt
    diff = np.zeros_like(x)
    for y in range(H):
        first = y == 0 or restart_rows and y % restart_rows == 0
        for c in range(C):
            row, up = x[y, :, c], x[y - 1, :, c] if y else None
            if first:
                pred = np.concatenate([[1 << (8 - pt - 1)], row[:-1]])
            else:
                ra = np.concatenate([[0], row[:-1]])
                rb, rc = up, np.concatenate([[0], up[:-1]])
                pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                        5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                        7: (ra + rb) >> 1}[psv].copy()
                pred[0] = up[0]
            d = (row - pred) & 0xFFFF
            diff[y, :, c] = np.where(d >= 0x8000, d - 0x10000, d)
    std = std_huffman()
    codes = [huffman_codes(*std[0]), huffman_codes(*std[2])]
    out = b"\xff\xd8"
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                     adobe))
    out += _segment(0xC3, struct.pack(">BHHB", 8, H, W, C) + b"".join(
        bytes([c + 1, 0x11, 0]) for c in range(C)))
    if tables:
        out += _segment(0xC4, b"".join(
            bytes([t]) + bytes(std[2 * t][0]) + bytes(std[2 * t][1])
            for t in range(min(C, 2))))
    if restart_rows:
        out += _segment(0xDD, struct.pack(">H", restart_rows * W))
    out += _segment(0xDA, bytes([C]) + b"".join(
        bytes([c + 1, min(c, 1) << 4]) for c in range(C))
        + bytes([psv, 0, pt]))
    w = BitWriter()
    for y in range(H):
        if y and restart_rows and y % restart_rows == 0:
            out += w.flush() + bytes([0xFF, 0xD0 + (y // restart_rows - 1)
                                      % 8])
        for xx in range(W):
            for c in range(C):
                d = int(diff[y, xx, c])
                s = _category(d)
                w.put(*codes[min(c, 1)][s])
                if s < 16:
                    w.put(_bits(d, s), s)
    return out + w.flush() + b"\xff\xd9"


def psd_file(planes, mode, depth=8, rle=False, palette=None, layers=(),
             resources=b""):
    """A PSD of (C, H, W) channel planes (uint8; 1-bit planes packed per
    row) in Photoshop colour mode ``mode`` (0 bitmap, 1 grey, 2 indexed, 3
    RGB, 4 CMYK, 7 multichannel, 8 duotone, 9 Lab), the merged image raw or
    PackBits (``rle``: a row byte count per row of each channel, then the
    rows), with an indexed file's 768-byte planar ``palette``, image
    resources and ``layers`` = [(top, left, (C, h, w) planes, channel
    ids)] in the layer and mask section."""
    C, H, W = planes.shape[0], planes.shape[1], planes.shape[2]
    if mode == 0:
        W *= 8      # the planes hold packed bits
    out = b"8BPS" + struct.pack(">H6xHIIHH", 1, C, H, planes.shape[2]
                                if mode != 0 else W, depth, mode)
    pal = b"" if palette is None else bytes(palette)
    out += struct.pack(">I", len(pal)) + pal
    out += struct.pack(">I", len(resources)) + resources
    if layers:
        recs, data = b"", b""
        for top, left, lp, ids in layers:
            lc, lh, lw = lp.shape
            recs += struct.pack(">iiiiH", top, left, top + lh, left + lw, lc)
            chans = [b"\x00\x00" + lp[i].tobytes() for i in range(lc)]
            for i, cid in enumerate(ids):
                recs += struct.pack(">hI", cid, len(chans[i]))
            name = b"\x05layer\x00\x00"          # padded to 4 bytes
            extra = struct.pack(">II", 0, 0) + name
            recs += b"8BIMnorm" + bytes([255, 0, 0, 0])
            recs += struct.pack(">I", len(extra)) + extra
            data += b"".join(chans)
        info = struct.pack(">h", len(layers)) + recs + data
        if len(info) % 2:
            info += b"\x00"
        section = struct.pack(">I", len(info)) + info + struct.pack(">I", 0)
        out += struct.pack(">I", len(section)) + section
    else:
        out += struct.pack(">I", 0)
    if not rle:
        return out + b"\x00\x00" + planes.astype(np.uint8).tobytes()
    rows = [packbits(planes[c, y].tobytes()) for c in range(C)
            for y in range(H)]
    return (out + b"\x00\x01" + b"".join(struct.pack(">H", len(r))
                                          for r in rows) + b"".join(rows))


def dds_file(W, H, data, fourcc=b"", dxgi=None, pfflags=0x4, bits=0,
             masks=(0, 0, 0, 0), caps2=0, mipmaps=0):
    """A DDS file: the 124-byte header (a FourCC, or DX10 and ``dxgi``;
    else ``pfflags`` with ``bits`` and ``masks``), then ``data``."""
    if dxgi is not None:
        fourcc = b"DX10"
    head = b"DDS " + struct.pack("<7I", 124, 0x1007 | (0x20000 if mipmaps
                                                      else 0),
                                 H, W, 0, 0, mipmaps) + bytes(44)
    head += struct.pack("<II4sI4I", 32, pfflags, fourcc.ljust(4, b"\0"),
                        bits, *masks)
    head += struct.pack("<5I", 0x1000 | (0x8 if caps2 else 0), caps2, 0, 0, 0)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + bytes(data)


def bc_blocks(n, size, seed, first=None):
    """n seeded random blocks of ``size`` bytes (every such block is valid
    BCn data); ``first`` sets the low bits of each block's first byte, in
    turn, to cover the BC6H or BC7 modes."""
    blocks = np.random.default_rng(seed).integers(0, 256, (n, size),
                                                  dtype=np.uint8)
    if first is not None:
        for k in range(n):
            mask, value = first[k % len(first)]
            blocks[k, 0] = (int(blocks[k, 0]) & ~mask & 0xFF) | value
    return blocks.tobytes()


# BC7's eight modes (the first set bit of byte 0) and the reserved mode 8
BC7_MODES = [(0xFF >> (7 - m), 1 << m) for m in range(8)] + [(0xFF, 0)]
# BC6H's 14 modes: 2 bits 00 and 01, else 5 bits; then two reserved ones
BC6_MODES = [(0x3, 0), (0x3, 1)] + [(0x1F, m) for m in (
    2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23)]


def qoi_ops(W, H, seed, channels=4, colorspace=1):
    """A QOI file of seeded random ops (RGB, RGBA, index, diff, luma and
    runs, a run also past the last pixel) until W x H pixels are coded."""
    rng = np.random.default_rng(seed)
    out = bytearray(b"qoif" + struct.pack(">IIBB", W, H, channels,
                                          colorspace))
    n = 0
    while n < W * H:
        op = rng.integers(6)
        if op == 0:
            out += b"\xfe" + bytes(rng.integers(0, 256, 3, dtype=np.uint8))
        elif op == 1:
            out += b"\xff" + bytes(rng.integers(0, 256, 4, dtype=np.uint8))
        elif op == 2:
            out.append(int(rng.integers(64)))
        elif op == 3:
            out.append(0x40 | int(rng.integers(64)))
        elif op == 4:
            out += bytes([0x80 | int(rng.integers(64)),
                          int(rng.integers(256))])
        else:
            run = int(rng.integers(1, 63))
            out.append(0xC0 | (run - 1))
            n += run - 1
        n += 1
    return bytes(out + b"\x00" * 7 + b"\x01")


def libwebp_encode(rgb, quality=75, **options):
    """A lossy WebP of (H, W, 3) or (H, W, 4) uint8 from Pillow's own
    libwebp, called through ctypes with ``WebPConfig`` fields Pillow does
    not pass on (filter type and sharpness, token partitions, segments)."""
    import ctypes as C
    import glob
    import PIL
    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    for dep in sorted(glob.glob(str(libs / "libsharpyuv*.so*"))):
        C.CDLL(dep, mode=C.RTLD_GLOBAL)
    lib = C.CDLL(sorted(glob.glob(str(libs / "libwebp-*.so*")))[0])
    ints = ("lossless quality method image_hint target_size target_PSNR "
            "segments sns_strength filter_strength filter_sharpness "
            "filter_type autofilter alpha_compression alpha_filtering "
            "alpha_quality pass show_compressed preprocessing partitions "
            "partition_limit emulate_jpeg_size thread_level low_memory "
            "near_lossless exact use_delta_palette use_sharp_yuv qmin "
            "qmax").split()

    class Config(C.Structure):       # encode.h's WebPConfig
        _fields_ = [(n, C.c_float if n in ("quality", "target_PSNR")
                     else C.c_int) for n in ints]

    class Picture(C.Structure):      # encode.h's WebPPicture
        _fields_ = [("use_argb", C.c_int), ("colorspace", C.c_int),
                    ("width", C.c_int), ("height", C.c_int),
                    ("y", C.c_void_p), ("u", C.c_void_p), ("v", C.c_void_p),
                    ("y_stride", C.c_int), ("uv_stride", C.c_int),
                    ("a", C.c_void_p), ("a_stride", C.c_int),
                    ("pad1", C.c_uint32 * 2), ("argb", C.c_void_p),
                    ("argb_stride", C.c_int), ("pad2", C.c_uint32 * 3),
                    ("writer", C.c_void_p), ("custom_ptr", C.c_void_p),
                    ("extra_info_type", C.c_int),
                    ("extra_info", C.c_void_p), ("stats", C.c_void_p),
                    ("error_code", C.c_int), ("progress_hook", C.c_void_p),
                    ("user_data", C.c_void_p), ("pad3", C.c_uint32 * 3),
                    ("pad4", C.c_void_p), ("pad5", C.c_void_p),
                    ("pad6", C.c_uint32 * 8), ("memory_", C.c_void_p),
                    ("memory_argb_", C.c_void_p), ("pad7", C.c_void_p * 2)]

    class Writer(C.Structure):
        _fields_ = [("mem", C.c_void_p), ("size", C.c_size_t),
                    ("max_size", C.c_size_t), ("pad", C.c_uint32)]

    abi = 0x0210
    cfg = Config()
    assert lib.WebPConfigInitInternal(C.byref(cfg), 0, C.c_float(quality),
                                      abi)
    for k, v in options.items():
        setattr(cfg, k, v)
    assert lib.WebPValidateConfig(C.byref(cfg))
    pic = Picture()
    assert lib.WebPPictureInitInternal(C.byref(pic), abi)
    H, W, ch = rgb.shape
    pic.width, pic.height = W, H
    buf = np.ascontiguousarray(rgb, np.uint8)
    imp = lib.WebPPictureImportRGBA if ch == 4 else lib.WebPPictureImportRGB
    assert imp(C.byref(pic), buf.ctypes.data_as(C.c_void_p), W * ch)
    w = Writer()
    lib.WebPMemoryWriterInit(C.byref(w))
    pic.writer = C.cast(lib.WebPMemoryWrite, C.c_void_p).value
    pic.custom_ptr = C.addressof(w)
    assert lib.WebPEncode(C.byref(cfg), C.byref(pic)), pic.error_code
    out = C.string_at(w.mem, w.size)
    lib.WebPPictureFree(C.byref(pic))
    lib.WebPMemoryWriterClear(C.byref(w))
    return out


def riff_chunks(data):
    """(tag, payload) of each chunk of a RIFF WEBP file."""
    out, p = [], 12
    while p + 8 <= len(data):
        n = int.from_bytes(data[p + 4:p + 8], "little")
        out.append((data[p:p + 4], data[p + 8:p + 8 + n]))
        p += 8 + n + (n & 1)
    return out


def riff(*chunks):
    """A RIFF WEBP file of (tag, payload) chunks."""
    body = b"".join(tag + struct.pack("<I", len(d)) + d + b"\0" * (len(d) & 1)
                    for tag, d in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def vp8x(flags, W, H):
    return (b"VP8X", bytes([flags, 0, 0, 0]) + (W - 1).to_bytes(3, "little")
            + (H - 1).to_bytes(3, "little"))


def alph(alpha, method, filt):
    """An ALPH chunk of an (H, W) alpha plane: raw (method 0) or as the
    green of a lossless VP8L stream (method 1, by Pillow's encoder), under
    filter 0-3 (none, horizontal, vertical, gradient)."""
    a = alpha.astype(np.int32)
    pred = np.zeros_like(a)
    if filt == 1:
        pred[:, 1:] = a[:, :-1]
        pred[1:, 0] = a[:-1, 0]
    elif filt == 2:
        pred[1:] = a[:-1]
        pred[0, 1:] = a[0, :-1]
    elif filt == 3:
        pred[0, 1:] = a[0, :-1]
        pred[1:, 0] = a[:-1, 0]
        g = a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1]
        pred[1:, 1:] = np.clip(g, 0, 255)
    res = ((a - pred) & 255).astype(np.uint8)
    if method == 0:
        body = res.tobytes()
    else:
        green = np.repeat(res[..., None], 3, -1)
        chunk = dict(riff_chunks(pil_bytes(green, "WEBP", lossless=True)))
        body = chunk[b"VP8L"][5:]
    return b"ALPH", bytes([filt << 2 | method]) + body


class BoolDecoder:
    """RFC 6386's boolean decoder, recording each (bit, probability)."""

    def __init__(self, data):
        self.data, self.pos = data, 2
        self.value = (data[0] << 8) | data[1]
        self.range, self.count, self.log = 255, 0, []

    def get(self, prob):
        split = 1 + (((self.range - 1) * prob) >> 8)
        bit = int(self.value >= split << 8)
        if bit:
            self.range -= split
            self.value -= split << 8
        else:
            self.range = split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                self.value |= self.data[self.pos] if self.pos < len(
                    self.data) else 0
                self.pos += 1
        self.log.append((bit, prob))
        return bit

    def bits(self, n):
        return sum(self.get(128) << (n - 1 - i) for i in range(n))


def bool_encode(pairs):
    """RFC 6386's boolean encoder of (bit, probability) pairs."""
    out, rng, bottom, count = bytearray(), 255, 0, 24

    def carry():
        i = len(out) - 1
        while out[i] == 255:
            out[i] = 0
            i -= 1
        out[i] += 1
    for bit, prob in pairs:
        split = 1 + (((rng - 1) * prob) >> 8)
        if bit:
            bottom += split
            rng -= split
        else:
            rng = split
        while rng < 128:
            rng <<= 1
            if bottom & (1 << 31):
                carry()
            bottom = (bottom << 1) & 0xFFFFFFFF
            count -= 1
            if not count:
                out.append(bottom >> 24)
                bottom &= (1 << 24) - 1
                count = 8
    if bottom & (1 << (32 - count)):
        carry()
    v = (bottom << (count & 7)) & 0xFFFFFFFF
    for _ in range(count >> 3):
        v = (v << 8) & 0xFFFFFFFF
    for _ in range(4):
        out.append(v >> 24)
        v = (v << 8) & 0xFFFFFFFF
    return bytes(out)


def _c_table(name):
    """A table of the port's csrc/nm_webp.cpp (the RFC's probabilities),
    to walk a VP8 first partition's symbols."""
    src = (HERE.parent.parent / "neural_marionette_tpu_torch" / "csrc"
           / "nm_webp.cpp").read_text()
    body = src[src.index(name):]
    body = body[body.index("{") + 1:body.index("}")]
    return [int(v) for v in body.replace("\n", " ").split(",") if v.strip()]


def vp8_refilter(vp8, simple, level, sharpness, ref_delta=None,
                 mode_delta=None):
    """A VP8 key frame with its loop-filter header rewritten (type, level,
    sharpness, and the ref and mode deltas that libwebp's encoder never
    writes): its first partition walked symbol by symbol and encoded again,
    the token partitions kept as they are."""
    tag = int.from_bytes(vp8[:3], "little")
    n0 = tag >> 5
    W = int.from_bytes(vp8[6:8], "little") & 0x3FFF
    H = int.from_bytes(vp8[8:10], "little") & 0x3FFF
    d = BoolDecoder(vp8[10:10 + n0])
    d.get(128), d.get(128)
    use_segment = d.get(128)
    update_map = 0
    if use_segment:
        update_map = d.get(128)
        if d.get(128):
            d.get(128)
            for _ in range(4):
                if d.get(128):
                    d.bits(8)
            for _ in range(4):
                if d.get(128):
                    d.bits(7)
        seg_p = [d.bits(8) if d.get(128) else 255 for _ in range(3)] \
            if update_map else [255] * 3
    start = len(d.log)
    d.get(128), d.bits(6), d.bits(3)
    if d.get(128) and d.get(128):
        for _ in range(8):
            if d.get(128):
                d.bits(7)
    end = len(d.log)
    d.bits(2)
    d.bits(7)
    for _ in range(5):
        if d.get(128):
            d.bits(5)
    d.get(128)
    for p in _c_table("kCoeffsUpdateProba"):
        if d.get(p):
            d.bits(8)
    skip_p = d.bits(8) if d.get(128) else None
    bmodes = _c_table("kBModesProba")
    tree = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
    mbw = (W + 15) >> 4
    top = [0] * (4 * mbw)
    for _ in range((H + 15) >> 4):
        left = [0] * 4
        for mx in range(mbw):
            if update_map:
                d.get(seg_p[2]) if d.get(seg_p[0]) else d.get(seg_p[1])
            if skip_p is not None:
                d.get(skip_p)
            if d.get(145):
                ymode = (1 if d.get(128) else 3) if d.get(156) else (
                    2 if d.get(163) else 0)
                top[4 * mx:4 * mx + 4] = [ymode] * 4
                left = [ymode] * 4
            else:
                for y in range(4):
                    m = left[y]
                    for x in range(4):
                        prob = bmodes[(top[4 * mx + x] * 10 + m) * 9:][:9]
                        i = tree[d.get(prob[0])]
                        while i > 0:
                            i = tree[2 * i + d.get(prob[i])]
                        m = -i
                        top[4 * mx + x] = m
                    left[y] = m
            if d.get(142) and d.get(114):
                d.get(183)
    new = [(simple, 128)] + [((level >> (5 - i)) & 1, 128) for i in range(6)]
    new += [((sharpness >> (2 - i)) & 1, 128) for i in range(3)]
    deltas = ref_delta is not None
    new += [(int(deltas), 128)]
    if deltas:
        new += [(1, 128)]
        for v in list(ref_delta) + list(mode_delta):
            new += [(1, 128)] + [((abs(v) >> (5 - i)) & 1, 128)
                                 for i in range(6)] + [(int(v < 0), 128)]
    part0 = bool_encode(d.log[:start] + new + d.log[end:])
    tag = (tag & 0x1F) | (len(part0) << 5)
    return tag.to_bytes(3, "little") + vp8[3:10] + part0 + vp8[10 + n0:]


# -------------------------------------------------------------- the cases
# --------------------------------------------------------------- JPEG 2000
def jp2_boxes(data):
    """A JP2 file's top-level boxes as [type, body] pairs."""
    out, pos = [], 0
    while pos < len(data):
        size, kind = struct.unpack_from(">I4s", data, pos)
        size = size or len(data) - pos
        out.append([kind, data[pos + 8:pos + size]])
        pos += size
    return out


def jp2_join(boxes):
    return b"".join(struct.pack(">I", 8 + len(body)) + kind + body
                    for kind, body in boxes)


def jp2_header(data, fn):
    """A JP2 file with its jp2h box's sub-boxes replaced by ``fn`` of
    them."""
    boxes = jp2_boxes(data)
    for box in boxes:
        if box[0] == b"jp2h":
            box[1] = jp2_join(fn(jp2_boxes(box[1])))
    return jp2_join(boxes)


def colr(enumcs=None, icc=None):
    if icc is not None:
        return [b"colr", bytes([2, 0, 0]) + icc]
    return [b"colr", bytes([1, 0, 0]) + struct.pack(">I", enumcs)]


def pclr(entries, depth=7):
    """A pclr box of 8-bit columns and its cmap box."""
    npc = len(entries[0])
    body = struct.pack(">HB", len(entries), npc) + bytes([depth] * npc) \
        + b"".join(bytes(e) for e in entries)
    cmap = b"".join(struct.pack(">HBB", 0, 1, k) for k in range(npc))
    return [[b"pclr", body], [b"cmap", cmap]]


def j2k_markers(cs):
    """The main header's marker segments of a one-tile codestream written
    by OpenJPEG, and its tile's packet data: ({marker: body}, data)."""
    pos, segs = 2, {}
    while True:
        m, n = struct.unpack_from(">HH", cs, pos)
        if m == 0xFF90:
            break
        segs.setdefault(m, cs[pos + 4:pos + 2 + n])
        pos += 2 + n
    psot = struct.unpack_from(">I", cs, pos + 6)[0]
    sod = cs.index(b"\xff\x93", pos + 12) + 2
    return segs, cs[sod:pos + psot]


def j2k_subsampled(rgb, factors=(1, 2, 2)):
    """A three-component codestream whose components are sub-sampled by
    ``factors`` (XRsiz = YRsiz): each component written alone by
    OpenJPEG at its own size, component-position-resolution-layer, and the
    packets joined into one tile (one precinct a resolution, so the order
    of the joined packets is CPRL's)."""
    from PIL import Image
    H, W = rgb.shape[:2]
    parts = [j2k_markers(pil_bytes(Image.fromarray(np.ascontiguousarray(
        rgb[::f, ::f, c])), "JPEG2000", no_jp2=True, num_resolutions=3,
        progression="CPRL")) for c, f in enumerate(factors)]
    for segs, _ in parts[1:]:
        assert segs[0xFF52] == parts[0][0][0xFF52]
        assert segs[0xFF5C] == parts[0][0][0xFF5C]
    siz = struct.pack(">HIIIIIIIIH", 0, W, H, 0, 0, W, H, 0, 0, 3) + b"".join(
        bytes([7, f, f]) for f in factors)
    data = b"".join(d for _, d in parts)
    seg = lambda m, body: struct.pack(">HH", m, len(body) + 2) + body
    return (b"\xff\x4f" + seg(0xFF51, siz) + seg(0xFF52, parts[0][0][0xFF52])
            + seg(0xFF5C, parts[0][0][0xFF5C])
            + struct.pack(">HHHIBB", 0xFF90, 10, 0, 14 + len(data), 0, 1)
            + b"\xff\x93" + data + b"\xff\xd9")


def openjpeg_encode(planes, factors=None, W=None, H=None, rates=(0,),
                    pocs=(), **params):
    """A raw JPEG 2000 codestream from Pillow's own OpenJPEG, called through
    ctypes with the encoder parameters Pillow does not pass on (code-block
    styles, SOP and EPH markers, a region of interest, POC progressions,
    sub-sampled components): ``planes`` are uint8 (h, w) arrays, component
    i at 1 / ``factors[i]`` of the (W, H) grid; ``rates`` the layers'
    compression ratios (0: lossless); ``pocs`` (resno0, compno0, layno1,
    resno1, compno1, progression) tuples; ``params`` fields of
    ``opj_cparameters_t``."""
    import ctypes as C
    import glob
    import os
    import tempfile
    import PIL
    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    lib = C.CDLL(sorted(glob.glob(str(libs / "libopenjp2-*.so*")))[0])
    u32 = C.c_uint32

    class Poc(C.Structure):          # openjpeg.h's opj_poc_t
        _fields_ = [(n, u32) for n in "resno0 compno0 layno1 resno1 compno1 "
                    "layno0 precno0 precno1".split()] + [
            ("prg1", C.c_int), ("prg", C.c_int), ("progorder", C.c_char * 5),
            ("tile", u32)] + [(n, C.c_int32) for n in ("tx0", "tx1", "ty0",
                                                       "ty1")] + [
            (n, u32) for n in "layS resS compS prcS layE resE compE prcE txS "
            "txE tyS tyE dx dy lay_t res_t comp_t prc_t tx0_t ty0_t".split()]

    ints = lambda names: [(n, C.c_int) for n in names.split()]

    class Params(C.Structure):       # openjpeg.h's opj_cparameters_t
        _fields_ = ints("tile_size_on cp_tx0 cp_ty0 cp_tdx cp_tdy "
                        "cp_disto_alloc cp_fixed_alloc cp_fixed_quality") + [
            ("cp_matrice", C.c_void_p), ("cp_comment", C.c_char_p),
            ("csty", C.c_int), ("prog_order", C.c_int), ("POC", Poc * 32),
            ("numpocs", u32), ("tcp_numlayers", C.c_int),
            ("tcp_rates", C.c_float * 100),
            ("tcp_distoratio", C.c_float * 100)] + ints(
            "numresolution cblockw_init cblockh_init mode irreversible "
            "roi_compno roi_shift res_spec") + [
            ("prcw_init", C.c_int * 33), ("prch_init", C.c_int * 33),
            ("infile", C.c_char * 4096), ("outfile", C.c_char * 4096),
            ("index_on", C.c_int), ("index", C.c_char * 4096)] + ints(
            "image_offset_x0 image_offset_y0 subsampling_dx subsampling_dy "
            "decod_format cod_format") + [    # the rest, left as set
            ("rest", C.c_char * 1024)]

    class CmptParm(C.Structure):     # opj_image_cmptparm_t
        _fields_ = [(n, u32) for n in "dx dy w h x0 y0 prec bpp sgnd".split()]

    class Comp(C.Structure):         # opj_image_comp_t
        _fields_ = [(n, u32) for n in "dx dy w h x0 y0 prec bpp sgnd "
                    "resno_decoded factor".split()] + [
            ("data", C.POINTER(C.c_int32)), ("alpha", C.c_uint16)]

    class Image(C.Structure):        # opj_image_t
        _fields_ = [(n, u32) for n in "x0 y0 x1 y1 numcomps".split()] + [
            ("color_space", C.c_int), ("comps", C.POINTER(Comp)),
            ("icc_profile_buf", C.c_void_p), ("icc_profile_len", u32)]

    lib.opj_image_create.restype = C.POINTER(Image)
    lib.opj_create_compress.restype = C.c_void_p
    lib.opj_stream_create_default_file_stream.restype = C.c_void_p
    lib.opj_stream_create_default_file_stream.argtypes = [C.c_char_p, C.c_int]
    factors = factors or [(1, 1)] * len(planes)
    cmpt = (CmptParm * len(planes))()
    for c, (plane, (fx, fy)) in enumerate(zip(planes, factors)):
        cmpt[c].dx, cmpt[c].dy = fx, fy
        cmpt[c].h, cmpt[c].w = plane.shape
        cmpt[c].prec = cmpt[c].bpp = 8
    image = lib.opj_image_create(len(planes), cmpt, 1)
    im = image.contents
    im.x1 = W or planes[0].shape[1]
    im.y1 = H or planes[0].shape[0]
    for c, plane in enumerate(planes):
        a = np.ascontiguousarray(plane, np.int32)
        C.memmove(im.comps[c].data, a.ctypes.data, a.nbytes)
    p = Params()
    lib.opj_set_default_encoder_parameters(C.byref(p))
    p.cp_disto_alloc, p.tcp_numlayers = 1, len(rates)
    for k, r in enumerate(rates):
        p.tcp_rates[k] = r
    for k, (r0, c0, l1, r1, c1, prg) in enumerate(pocs):
        q = p.POC[k]
        q.tile, q.resno0, q.compno0, q.layno1, q.resno1, q.compno1, q.prg1 = \
            1, r0, c0, l1, r1, c1, prg
    p.numpocs = len(pocs)
    for k, v in params.items():
        setattr(p, k, v)
    codec = C.c_void_p(lib.opj_create_compress(0))    # OPJ_CODEC_J2K
    assert lib.opj_setup_encoder(codec, C.byref(p), image)
    fd, path = tempfile.mkstemp(suffix=".j2k")
    os.close(fd)
    stream = C.c_void_p(lib.opj_stream_create_default_file_stream(
        path.encode(), 0))
    ok = lib.opj_start_compress(codec, image, stream) and lib.opj_encode(
        codec, stream) and lib.opj_end_compress(codec, stream)
    lib.opj_stream_destroy(stream)
    lib.opj_destroy_codec(codec)
    lib.opj_image_destroy(image)
    data = Path(path).read_bytes()
    os.unlink(path)
    assert ok, "OpenJPEG refused the parameters"
    return data


def set_precision(cs, comp, bits):
    """A codestream with component ``comp``'s Ssiz set to ``bits`` unsigned
    bits."""
    out = bytearray(cs)
    out[42 + 3 * comp] = bits - 1
    return bytes(out)


def cases():
    """(name, bytes, facts) of every fixture."""
    from PIL import Image
    rgb = textured(29, 37, 1)
    out = []

    def add(name, data, **facts):
        out.append((name, data, facts))

    # JPEG, well formed for the JAX function
    for sub, tag in ((0, "444"), (1, "422"), (2, "420")):
        add(f"jpeg_baseline_{tag}.jpg",
            pil_bytes(rgb, "JPEG", quality=90, subsampling=sub),
            process="baseline", sampling=tag)
    add("jpeg_baseline_411.jpg",
        pil_bytes(rgb, "JPEG", quality=85, subsampling="4:1:1"),
        process="baseline", sampling="4:1:1 (written as 4:2:0)")
    add("jpeg_baseline_420_64x48.jpg",
        pil_bytes(textured(48, 64, 2), "JPEG", quality=75, subsampling=2),
        process="baseline", sampling="420", note="a whole number of MCUs")
    add("jpeg_baseline_420_3x2.jpg",
        pil_bytes(textured(2, 3, 3), "JPEG", quality=95, subsampling=2),
        process="baseline", sampling="420",
        note="chroma 2 samples wide: plain replication, not fancy")
    add("jpeg_baseline_422_5x9.jpg",
        pil_bytes(textured(9, 5, 4), "JPEG", quality=95, subsampling=1),
        process="baseline", sampling="422", note="chroma 3 samples wide")
    add("jpeg_progressive_420.jpg",
        pil_bytes(rgb, "JPEG", quality=90, subsampling=2, progressive=True),
        process="progressive", sampling="420")
    add("jpeg_progressive_444.jpg",
        pil_bytes(rgb, "JPEG", quality=95, subsampling=0, progressive=True),
        process="progressive", sampling="444")
    add("jpeg_progressive_422_optimized.jpg",
        pil_bytes(rgb, "JPEG", quality=70, subsampling=1, progressive=True,
                  optimize=True),
        process="progressive", sampling="422", note="optimized tables")
    add("jpeg_restart_blocks_420.jpg",
        pil_bytes(rgb, "JPEG", quality=90, subsampling=2,
                  restart_marker_blocks=3),
        process="baseline", sampling="420", note="DRI every 3 MCUs")
    add("jpeg_progressive_restart_rows.jpg",
        pil_bytes(rgb, "JPEG", quality=90, subsampling=2, progressive=True,
                  restart_marker_rows=1),
        process="progressive", sampling="420", note="DRI every MCU row")
    add("jpeg_extended_sof1.jpg",
        pil_bytes(rgb, "JPEG", subsampling=2,
                  qtables=[[300] * 64, [400] * 64]),
        process="extended sequential",
        note="16-bit quantization tables (SOF1)")
    add("jpeg_adobe_rgb.jpg",
        pil_bytes(rgb, "JPEG", quality=90, keep_rgb=True),
        process="baseline", note="Adobe APP14 transform 0: RGB, not YCbCr")
    exif = Image.Exif()
    exif[0x0112] = 6
    add("jpeg_exif_orientation6.jpg",
        pil_bytes(rgb, "JPEG", quality=90, exif=exif),
        process="baseline", note="EXIF orientation 6, not applied by "
                                 "imageio.v2.imread")
    # white and black blocks with the DC quantizer raised from 1 to 6: the
    # IDCT gives +-762 and -768, where libjpeg's C range-limit table would
    # wrap and its SIMD versions saturate
    blocks = np.zeros((16, 32, 3), np.uint8)
    blocks[:, :16] = 255
    blocks[8:, 8:24] = 255
    add("jpeg_range_limit.jpg",
        patch_jpeg(pil_bytes(blocks, "JPEG", quality=100, subsampling=0),
                   set_byte(0xDB, 1, 6)),
        process="baseline", note="IDCT output beyond [-512, 511]")
    # a 4:2:2 file with its luma sampling turned from 2x1 into 1x2 (and its
    # size transposed to keep the MCU count): h1v2 upsampling
    h1v2 = pil_bytes(smooth(16, 32, 5), "JPEG", quality=90, subsampling=1)

    def to_h1v2(m, b, p, n, pos):
        if m == 0xC0:
            b[p + 1:p + 3] = (29).to_bytes(2, "big")     # height 32 -> 29
            b[p + 3:p + 5] = (16).to_bytes(2, "big")
            b[p + 7] = 0x12
    add("jpeg_h1v2.jpg", patch_jpeg(h1v2, to_h1v2), process="baseline",
        sampling="Y 1x2 (4:4:0)", note="patched from a 4:2:2 file")
    # grey: imageio gives (H, W), the JAX function keeps 3 columns
    add("jpeg_grey.jpg", pil_bytes(rgb[..., 1], "JPEG", quality=90),
        process="baseline", channels=1)
    add("jpeg_grey_progressive.jpg",
        pil_bytes(rgb[..., 0], "JPEG", quality=80, progressive=True),
        process="progressive", channels=1)
    # the two decode-time fixtures
    add("jpeg_1024_baseline_420.jpg",
        pil_bytes(big(), "JPEG", quality=90, subsampling=2),
        process="baseline", sampling="420", large=True)
    add("jpeg_1024_progressive_420.jpg",
        pil_bytes(big(), "JPEG", quality=90, subsampling=2, progressive=True),
        process="progressive", sampling="420", large=True)
    # JPEG the port refuses, with the word its ValueError names
    base = pil_bytes(rgb, "JPEG", quality=90, subsampling=2)
    add("jpeg_lossless_sof3.jpg", patch_jpeg(base, set_marker(0xC0, 0xC3)),
        raises="lossless", note="frame marker patched to SOF3")
    add("jpeg_hierarchical_sof5.jpg",
        patch_jpeg(base, set_marker(0xC0, 0xC5)),
        raises="hierarchical", note="frame marker patched to SOF5")
    add("jpeg_12bit.jpg", patch_jpeg(base, set_byte(0xC0, 0, 12)),
        raises="12-bit", note="precision patched to 12")
    # JPEG once refused: CMYK, arithmetic, sampling factors above 2
    add("jpeg_cmyk.jpg",
        pil_bytes(Image.fromarray(rgb).convert("CMYK"), "JPEG", quality=90),
        process="baseline", channels=4, rule="cmyk",
        note="Adobe transform 0; imageio gives Pillow's inverted CMYK")
    add("jpeg_arithmetic_sof9.jpg", patch_jpeg(base, set_marker(0xC0, 0xC9)),
        process="arithmetic sequential", note="Huffman data behind a "
        "patched SOF9: libjpeg's arithmetic decoder stops at its error "
        "and the rest of the image is grey")
    add("jpeg_h4v1.jpg", patch_jpeg(base, set_byte(0xC0, 7, 0x41)),
        process="baseline", sampling="Y 4x1, chroma 1x1",
        note="luma sampling patched to 4x1: the data runs out, and "
             "libjpeg leaves the last MCUs zero")
    # the generator's own coder: sampling factors 3 and 4, arithmetic
    # coding, YCCK, Motion-JPEG frames, lossless
    sm = smooth(29, 37, 5)
    ysm, yrgb = ycbcr(sm), ycbcr(rgb)
    for tag, f in (("h3v1", [(3, 1), (1, 1), (1, 1)]),
                   ("h4v2", [(4, 2), (1, 1), (1, 1)]),
                   ("h1v4", [(1, 4), (1, 1), (1, 1)]),
                   ("h4v1_over_h2v1", [(4, 1), (2, 1), (2, 1)])):
        add(f"jpeg_{tag}.jpg", jpeg_encode(ysm, f), process="baseline",
            sampling=tag, note="int_upsample, or h2v1 fancy at 2:1")
    add("jpeg_h3v1_over_h2v1.jpg", jpeg_encode(ysm, [(3, 1), (2, 1),
                                                     (2, 1)]),
        raises="fractional", note="a 3:2 ratio, which libjpeg refuses")
    add("jpeg_motion_frame_no_dht.jpg", jpeg_encode(
        yrgb, [(2, 1), (1, 1), (1, 1)], tables=False), process="baseline",
        note="no DHT segment: annex K's tables, as libjpeg installs them")
    add("jpeg_baseline_420_no_dht.jpg", without_dht(base), process="baseline",
        note="a Pillow file with its DHT removed (its tables are annex K's)")
    add("jpeg_arith_sequential_420.jpg", jpeg_encode(
        yrgb, [(2, 2), (1, 1), (1, 1)], coding="arithmetic"),
        process="arithmetic sequential")
    add("jpeg_arith_sequential_dac_restart.jpg", jpeg_encode(
        ysm, [(2, 1), (1, 1), (1, 1)], coding="arithmetic", restart=3,
        dac={0: (2, 5, 12), 1: (1, 3, 2)}),
        process="arithmetic sequential", note="DAC L, U, Kx; DRI 3 MCUs")
    add("jpeg_arith_progressive_420.jpg", jpeg_encode(
        yrgb, [(2, 2), (1, 1), (1, 1)], coding="arithmetic",
        progressive=True), process="arithmetic progressive")
    add("jpeg_arith_progressive_444_dac_restart.jpg", jpeg_encode(
        yrgb, [(1, 1)] * 3, coding="arithmetic", progressive=True,
        restart=4, dac={0: (0, 4, 20), 1: (3, 7, 40)}),
        process="arithmetic progressive", note="DAC; DRI 4 MCUs")
    add("jpeg_arith_grey.jpg", jpeg_encode(sm[..., :1], [(1, 1)],
                                           coding="arithmetic"),
        process="arithmetic sequential", channels=1)
    add("jpeg_arith_grey_progressive.jpg", jpeg_encode(
        rgb[..., 1:2], [(1, 1)], coding="arithmetic", progressive=True),
        process="arithmetic progressive", channels=1)
    add("jpeg_arith_progressive_dc_only.jpg", jpeg_encode(
        yrgb, [(2, 2), (1, 1), (1, 1)], coding="arithmetic",
        progressive=True, scans=PROGRESSION[:1]),
        process="arithmetic progressive", note="one DC scan: block "
                                               "smoothing of the DC values")
    add("jpeg_arith_1024_past_64k.jpg", jpeg_encode(
        ycbcr(big()), [(2, 2), (1, 1), (1, 1)], coding="arithmetic",
        quality=90), raises="64 KiB", note="Pillow feeds libjpeg 64 KiB "
        "blocks, and the arithmetic decoder cannot wait for the next")
    cmyk = np.asarray(Image.fromarray(rgb).convert("CMYK"))
    ycck = np.concatenate([ycbcr(255 - cmyk[..., :3]), cmyk[..., 3:]], -1)
    add("jpeg_ycck_adobe2.jpg", jpeg_encode(
        ycck, [(2, 2), (1, 1), (1, 1), (2, 2)], adobe=2, jfif=False),
        process="baseline", channels=4, rule="cmyk",
        note="Adobe transform 2: YCCK made CMYK by libjpeg")
    add("jpeg_cmyk_no_adobe.jpg", jpeg_encode(
        cmyk, [(1, 1)] * 4, jfif=False, coding="arithmetic"),
        process="arithmetic sequential", channels=4, rule="cmyk",
        note="no Adobe marker: CMYK, still inverted by Pillow")
    # block smoothing: progressive files whose scans leave coefficients
    # unrefined
    prog = pil_bytes(rgb, "JPEG", quality=90, subsampling=2, progressive=True)
    add("jpeg_progressive_dc_only.jpg", first_scans(prog, 1),
        process="progressive", note="the DC scan only: DC smoothed too")
    add("jpeg_progressive_partial.jpg", first_scans(prog, 4),
        process="progressive", note="four scans: AC estimated")
    add("jpeg_grey_progressive_partial.jpg", first_scans(pil_bytes(
        rgb[..., 0], "JPEG", quality=80, progressive=True), 2),
        process="progressive", channels=1)
    # lossless: the seven predictors, a point transform, restarts
    for psv in range(1, 8):
        add(f"jpeg_lossless_grey_psv{psv}.jpg",
            jpeg_lossless(rgb[..., 1:2], psv), process="lossless",
            channels=1, predictor=psv)
    add("jpeg_lossless_grey_pt2_restart.jpg", jpeg_lossless(
        rgb[..., 1:2], 4, pt=2, restart_rows=5), process="lossless",
        channels=1, predictor=4, point_transform=2, note="DRI every 5 rows")
    add("jpeg_lossless_rgb.jpg", jpeg_lossless(rgb, 6), process="lossless",
        predictor=6, note="no JFIF: libjpeg-turbo 3 takes it for RGB")
    add("jpeg_lossless_rgb_adobe0.jpg", jpeg_lossless(rgb, 7, adobe=0),
        process="lossless", predictor=7)
    add("jpeg_lossless_rgb_jfif.jpg", jpeg_lossless(rgb, 1, jfif=True),
        raises="lossless file in YCbCr", note="libjpeg-turbo converts no "
                                              "colour in lossless mode")
    add("jpeg_lossless_no_dht.jpg", jpeg_lossless(rgb[..., 1:2], 1,
                                                  tables=False),
        raises="Huffman table DC 0 not", note="the lossless decoder "
                                              "installs no default tables")
    add("jpeg_lossless_sof11.jpg", patch_jpeg(jpeg_lossless(
        rgb[..., 1:2], 1), set_marker(0xC3, 0xCB)),
        raises="arithmetic-coded lossless", note="SOF11, which "
                                                 "libjpeg-turbo refuses")

    # PNG
    g = np.random.default_rng(7)
    grey = smooth(29, 37, 6)[..., 0]
    rgba = np.concatenate([rgb, g.integers(0, 256, (29, 37, 1),
                                           dtype=np.uint8)], -1)
    add("png_rgb8.png", pil_bytes(rgb, "PNG"), ctype=2, depth=8)
    add("png_rgba8.png", pil_bytes(rgba, "PNG"), ctype=6, depth=8)
    rgb16 = g.integers(0, 65536, (29, 37, 3)).astype(np.uint16)
    add("png_rgb16.png", png_bytes(rgb16, 16, 2, seed=1), ctype=2, depth=16)
    rgba16 = g.integers(0, 65536, (23, 19, 4)).astype(np.uint16)
    add("png_rgba16_adam7.png", png_bytes(rgba16, 16, 6, interlace=True,
                                          seed=2),
        ctype=6, depth=16, interlace=1)
    add("png_rgb8_adam7.png", png_bytes(rgb, 8, 2, interlace=True, seed=3),
        ctype=2, depth=8, interlace=1)
    add("png_rgb8_adam7_1x1.png", png_bytes(rgb[:1, :1], 8, 2,
                                            interlace=True),
        ctype=2, depth=8, interlace=1, note="one pixel: six empty passes")
    pimg = Image.fromarray(rgb).quantize(colors=200, dither=0)
    add("png_palette8.png", pil_bytes(pimg, "PNG"), ctype=3, depth=8)
    add("png_palette8_trns.png", pil_bytes(pimg, "PNG", transparency=3),
        ctype=3, depth=8, note="tRNS: imageio still returns RGB")
    for colors, depth in ((2, 1), (4, 2), (16, 4)):
        q = Image.fromarray(rgb).quantize(colors=colors, dither=0)
        add(f"png_palette{depth}.png", pil_bytes(q, "PNG"), ctype=3,
            depth=depth)
    idx = np.asarray(Image.fromarray(rgb).quantize(colors=16, dither=0))
    pal = np.asarray(
        Image.fromarray(rgb).quantize(colors=16, dither=0).getpalette()[:48],
        np.uint8).reshape(16, 3)
    add("png_palette4_adam7_trns.png",
        png_bytes(idx[..., None], 4, 3, interlace=True, palette=pal,
                  trns=bytes(range(0, 160, 10)), seed=4),
        ctype=3, depth=4, interlace=1)
    # grey: malformed for the JAX function
    add("png_grey8.png", pil_bytes(grey, "PNG"), ctype=0, depth=8)
    add("png_grey1.png", pil_bytes(Image.fromarray(grey).convert("1"), "PNG"),
        ctype=0, depth=1, note="imageio gives bool")
    for depth in (2, 4):
        s = (grey >> (8 - depth))[..., None]
        add(f"png_grey{depth}.png", png_bytes(s, depth, 0, seed=depth),
            ctype=0, depth=depth, note="imageio scales to 8 bits")
    grey16 = (smooth(29, 37, 8)[..., 2].astype(np.uint16) * 256
              + g.integers(0, 256, (29, 37))).astype(np.uint16)
    add("png_grey16.png", pil_bytes(Image.fromarray(grey16), "PNG"),
        ctype=0, depth=16, note="imageio gives uint16")
    add("png_grey16_adam7.png", png_bytes(grey16[..., None], 16, 0,
                                          interlace=True, seed=5),
        ctype=0, depth=16, interlace=1)
    add("png_grey8_trns.png", png_bytes(grey[..., None], 8, 0,
                                        trns=struct.pack(">H", 7)),
        ctype=0, depth=8)
    la = np.stack([grey, 255 - grey], -1)
    add("png_grey_alpha8.png", pil_bytes(la, "PNG"), ctype=4, depth=8,
        note="imageio gives 2 channels")
    la16 = g.integers(0, 65536, (29, 37, 2)).astype(np.uint16)
    add("png_grey_alpha16.png", png_bytes(la16, 16, 4, seed=6), ctype=4,
        depth=16, note="imageio gives RGBA of the high bytes")

    # BMP
    add("bmp_24.bmp", pil_bytes(rgb, "BMP"), bits=24)
    add("bmp_24_top_down.bmp", bmp_bytes(rgb, top_down=True), bits=24,
        top_down=True)
    add("bmp_32.bmp", pil_bytes(rgba, "BMP"), bits=32,
        note="the fourth byte is ignored")
    add("bmp_palette8.bmp", pil_bytes(pimg, "BMP"), bits=8)
    add("bmp_palette4_top_down.bmp",
        bmp_bytes(idx, bits=4, top_down=True, palette=pal), bits=4,
        top_down=True)
    add("bmp_grey8.bmp", pil_bytes(grey, "BMP"), bits=8,
        note="a grey-ramp palette: imageio gives (H, W)")
    add("bmp_1bit.bmp", pil_bytes(Image.fromarray(grey).convert("1"), "BMP"),
        bits=1, note="black and white: imageio gives bool")

    # TGA
    add("tga_rgb.tga", pil_bytes(rgb, "TGA"), kind=2, depth=24)
    add("tga_rgb_top_left.tga", pil_bytes(rgb, "TGA", orientation=1), kind=2,
        depth=24, origin="top left")
    add("tga_rgba.tga", pil_bytes(rgba, "TGA"), kind=2, depth=32)
    add("tga_rgb_rle.tga", pil_bytes(smooth(29, 37, 9) // 16 * 16, "TGA",
                                     compression="tga_rle"),
        kind=10, depth=24)
    add("tga_rgba_rle_top_left.tga",
        pil_bytes(rgba // 32 * 32, "TGA", compression="tga_rle",
                  orientation=1),
        kind=10, depth=32, origin="top left")
    mirrored = bytearray(pil_bytes(rgb, "TGA", orientation=1))
    mirrored[17] |= 0x10
    add("tga_rgb_top_right.tga", bytes(mirrored), kind=2, depth=24,
        origin="top right (bit 4: mirrored)")
    add("tga_palette.tga", pil_bytes(pimg, "TGA"), kind=1, depth=8,
        note="8-bit indices into a 24-bit colour map")
    add("tga_palette_rle_top_left.tga",
        pil_bytes(Image.fromarray(rgb).quantize(colors=6, dither=0), "TGA",
                  compression="tga_rle", orientation=1),
        kind=9, depth=8, origin="top left")
    add("tga_grey.tga", pil_bytes(grey, "TGA"), kind=3, depth=8)
    add("tga_grey_rle.tga", pil_bytes(grey // 8 * 8, "TGA",
                                      compression="tga_rle"),
        kind=11, depth=8)
    add("tga_rgb_other_extension.dat", pil_bytes(rgb, "TGA", orientation=1),
        kind=2, depth=24, note="not named .tga: found by its header")

    # BMP variants: run-length, 16 bits, bitfields
    pidx = np.asarray(pimg)
    ppal = np.asarray(pimg.getpalette()[:3 * 200], np.uint8).reshape(-1, 3)
    runs = smooth(29, 37, 10)[..., 0] // 40          # long runs
    runs[5, 3:20] = np.arange(17) % 6                # an absolute run
    runs[9, 20:] = 0                                 # a row ended early
    runs[12] = 0
    add("bmp_rle8.bmp", bmp_file(bmp_rle(runs * 30 + pidx % 3), 37, 29, 8,
                                 1, ppal),
        compression="BI_RLE8", note="encoded and absolute runs, rows ended "
                                    "early, an all-zero row")
    pal16 = ppal[:16]
    rle4 = (smooth(29, 37, 11)[..., 1] // 17).astype(np.uint8) % 16
    rle4[3, 4:13] = np.arange(9) % 16
    add("bmp_rle4.bmp", bmp_file(bmp_rle(rle4, True), 37, 29, 4, 2, pal16),
        compression="BI_RLE4")
    # a delta, written as Pillow reads it: two bytes it skips, then the
    # offsets (right 3, up 1)
    delta = bytearray(bmp_rle(runs[:, :10] * 25))
    delta[:0] = b"\x05\x07\x00\x02\xaa\xbb\x03\x01"
    add("bmp_rle8_delta.bmp", bmp_file(bytes(delta), 10, 29, 8, 1, ppal),
        compression="BI_RLE8", note="a delta: Pillow skips two bytes before "
                                    "its offsets")
    v16 = g.integers(0, 65536, (29, 37)).astype("<u2")
    add("bmp_16bit_555.bmp", bmp_file(bmp_rows(v16.view(np.uint8).reshape(
        29, 74)), 37, 29, 16), bits=16, compression="BI_RGB")
    add("bmp_bitfields_565.bmp", bmp_file(bmp_rows(v16.view(np.uint8).reshape(
        29, 74)), 37, 29, 16, 3, masks=(0xF800, 0x7E0, 0x1F)),
        bits=16, compression="BI_BITFIELDS", masks="5-6-5")
    add("bmp_bitfields_555_v5.bmp", bmp_file(bmp_rows(
        v16.view(np.uint8).reshape(29, 74)), 37, -29, 16, 3,
        masks=(0x7C00, 0x3E0, 0x1F, 0), header=124),
        bits=16, compression="BI_BITFIELDS", header=124, top_down=True)
    for tag, masks, order in (
            ("rgba", (0xFF, 0xFF00, 0xFF0000, 0xFF000000), [0, 1, 2, 3]),
            ("xbgr", (0xFF000000, 0xFF0000, 0xFF00, 0), [3, 2, 1, 0]),
            ("bgra", (0xFF0000, 0xFF00, 0xFF, 0xFF000000), [2, 1, 0, 3])):
        quad = rgba[..., np.argsort(order)]
        add(f"bmp_bitfields_32_{tag}.bmp", bmp_file(
            bmp_rows(quad.reshape(29, 148)), 37, 29, 32, 3, masks=masks,
            header=108), bits=32, compression="BI_BITFIELDS", header=108)
    add("bmp_bitfields_24.bmp", bmp_file(bmp_rows(
        rgb[..., ::-1].reshape(29, 111)), 37, 29, 24, 3,
        masks=(0xFF0000, 0xFF00, 0xFF)), bits=24, compression="BI_BITFIELDS")
    add("bmp_bitfields_other.bmp", bmp_file(bmp_rows(
        v16.view(np.uint8).reshape(29, 74)), 37, 29, 16, 3,
        masks=(0xF00, 0xF0, 0xF)), raises="bitfields layout",
        note="4-4-4 masks: Pillow refuses them")
    add("bmp_alphabitfields.bmp", bmp_file(bmp_rows(
        rgba.reshape(29, 148)), 37, 29, 32, 6,
        masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000), header=56),
        raises="BI_ALPHABITFIELDS", note="compression 6: Pillow refuses it")

    # TGA at 16 bits
    abit = g.integers(0, 2, (29, 37))
    px16 = argb1555(rgb, abit)
    add("tga_rgb16.tga", tga_file(2, 37, 29, 16, px16.tobytes()), kind=2,
        depth=16, note="A1R5G5B5; Pillow's alpha is the top bit inverted")
    flat = argb1555(smooth(29, 37, 12) // 32 * 32, abit * 0)
    add("tga_rgb16_rle_bottom_up.tga", tga_file(
        10, 37, 29, 16, tga_rle(flat.reshape(-1, 2), 2), flags=0), kind=10,
        depth=16)
    cmap16 = argb1555(ppal[:40], np.zeros(40, int)).tobytes()
    add("tga_palette16.tga", tga_file(
        1, 37, 29, 8, (pidx % 40 + 5).astype(np.uint8).tobytes(), cmap16,
        cmap_start=5, cmap_depth=16), kind=1, depth=8, cmap_depth=16,
        note="a 16-bit colour map starting at entry 5")
    add("tga_grey_alpha.tga", pil_bytes(la, "TGA"), kind=3, depth=16,
        note="grey + alpha: imageio gives 2 channels")

    # GIF: Pillow's files, and the generator's own writer for the rest
    add("other.gif", pil_bytes(rgb, "GIF"), note="interlaced, as Pillow "
                                                 "writes it")
    add("gif_pillow_not_interlaced.gif", pil_bytes(rgb, "GIF",
                                                   interlace=False))
    frames = [Image.fromarray(textured(29, 37, s)) for s in (20, 21, 22)]
    f = io.BytesIO()
    frames[0].save(f, "GIF", save_all=True, append_images=frames[1:],
                   duration=50, loop=0)
    add("gif_animated.gif", f.getvalue(), frames=3,
        note="imageio reads the first frame")
    add("gif_grey.gif", pil_bytes(grey, "GIF"), note="Pillow's grey GIF")
    idx64 = np.asarray(Image.fromarray(rgb).quantize(colors=64, dither=0))
    pal64 = np.asarray(Image.fromarray(rgb).quantize(
        colors=64, dither=0).getpalette()[:192], np.uint8).reshape(64, 3)
    add("gif_local_table_offset.gif", gif_file(
        (45, 36), [dict(x=5, y=4, idx=idx64, lct=pal64, mcs=6)],
        gct=pal64[::-1]), note="a local table; the frame at (5, 4) of a "
                               "45 x 36 screen; the rest index 0")
    add("gif_transparent_interlaced.gif", gif_file(
        (40, 31), [dict(x=2, y=1, idx=idx64, interlace=True, trans=7,
                        mcs=6)], gct=pal64, bg=3),
        note="interlaced, transparency index 7 fills the screen")
    add("gif_frame_past_screen.gif", gif_file(
        (20, 10), [dict(x=4, y=3, idx=idx64, mcs=7)], gct=np.concatenate(
            [pal64, pal64])), note="the screen grows to hold the frame")
    small = (idx64 % 4).astype(np.uint8)
    add("gif_grey_ramp.gif", gif_file(
        (37, 29), [dict(x=0, y=0, idx=small, mcs=2)],
        gct=np.repeat(np.arange(4)[:, None], 3, 1)),
        note="a table of grey levels 0..3: Pillow reads mode L")
    add("gif_index_past_table.gif", gif_file(
        (37, 29), [dict(x=0, y=0, idx=small, mcs=2)], gct=pal64[:2]),
        note="indices 2 and 3 past a 2-entry table: black")
    trunc = gif_file((37, 29), [dict(x=0, y=0, idx=idx64, mcs=6)],
                     gct=pal64)
    add("gif_truncated.gif", trunc[:len(trunc) // 2], raises="truncated")
    bad = gif_file((37, 29), [dict(x=0, y=0, idx=idx64, mcs=6,
                                   data=lzw_gif(idx64, 6)[:3] + b"\xff" * 40)],
                   gct=pal64)
    add("gif_bad_code.gif", bad, raises="LZW")

    # TIFF: Pillow's files, and the generator's own writer for the rest
    add("other.tif", pil_bytes(rgb, "TIFF"), compression=1)
    add("tiff_rgb_lzw.tif", pil_bytes(rgb, "TIFF", compression="tiff_lzw"),
        compression=5)
    add("tiff_rgb_deflate.tif", pil_bytes(rgb, "TIFF",
                                          compression="tiff_adobe_deflate"),
        compression=8)
    add("tiff_rgb_packbits.tif", pil_bytes(rgb, "TIFF",
                                           compression="packbits"),
        compression=32773)
    add("tiff_rgba_lzw.tif", pil_bytes(rgba, "TIFF", compression="tiff_lzw"),
        compression=5, extra_samples="alpha")
    add("tiff_rgb_lzma_strips.tif", tiff_file(rgb, 2, compression=34925,
                                              rows_per_strip=4),
        compression=34925, rows_per_strip=4)
    add("tiff_rgb_big_endian_lzw_predictor.tif", tiff_file(
        rgb, 2, order=">", compression=5, predictor=2, rows_per_strip=7),
        order="MM", compression=5, predictor=2)
    add("tiff_rgb_tiles_deflate.tif", tiff_file(
        rgb, 2, compression=8, tile=(16, 16)), tiles="16 x 16",
        compression=8, note="partial tiles on the right and bottom")
    add("tiff_rgb_tiles_lzw_predictor.tif", tiff_file(
        rgb, 2, compression=5, tile=(32, 16), predictor=2), tiles="32 x 16",
        compression=5, predictor=2)
    add("tiff_bigtiff_rgb_lzw.tif", tiff_file(rgb, 2, big=True,
                                              compression=5,
                                              rows_per_strip=10),
        bigtiff=True, compression=5)
    add("tiff_bigtiff_big_endian_tiles.tif", tiff_file(
        rgba, 2, big=True, order=">", tile=(16, 32), compression=32773,
        extra=(2,)), bigtiff=True, order="MM", compression=32773)
    add("tiff_rgb_fillorder2.tif", tiff_file(rgb, 2, compression=5,
                                             fillorder=2),
        fillorder=2, compression=5)
    # not RGB images for the JAX function: the port's defined texture
    add("tiff_rgb_planar.tif", tiff_file(rgb, 2, planar=2, compression=32773,
                                         rows_per_strip=8),
        planar=2, rule="planar", note="imageio gives (3, H, W)")
    rgb16t = g.integers(0, 65536, (29, 37, 3)).astype(np.uint16)
    add("tiff_rgb16_big_endian_lzw_predictor.tif", tiff_file(
        rgb16t, 2, order=">", compression=5, predictor=2, rows_per_strip=9),
        depth=16, predictor=2, note="imageio gives uint16")
    add("tiff_rgb16_planar_tiles.tif", tiff_file(
        rgb16t, 2, planar=2, tile=(16, 16), compression=8, predictor=2),
        depth=16, planar=2, rule="planar")
    add("tiff_grey8.tif", pil_bytes(grey, "TIFF", compression="tiff_lzw"),
        note="imageio gives (H, W)")
    add("tiff_grey16.tif", pil_bytes(Image.fromarray(grey16), "TIFF"),
        depth=16)
    add("tiff_grey4.tif", tiff_file((grey >> 4)[..., None], 1, bits=4,
                                    compression=32773), depth=4,
        rule="scale", note="imageio gives the 4-bit samples")
    add("tiff_grey_alpha.tif", pil_bytes(la, "TIFF", compression="tiff_lzw"),
        note="imageio gives 2 channels")
    add("tiff_bilevel.tif", pil_bytes(Image.fromarray(grey).convert("1"),
                                      "TIFF"), depth=1, note="imageio gives "
                                                             "bool")
    add("tiff_miniswhite8.tif", tiff_file(255 - grey[..., None], 0,
                                          compression=5),
        photometric=0, rule="miniswhite")
    bil = (grey > 128).astype(np.uint8)[..., None]
    add("tiff_miniswhite1_fillorder2.tif", tiff_file(1 - bil, 0, bits=1,
                                                     fillorder=2),
        photometric=0, depth=1, fillorder=2, rule="miniswhite")
    f32 = (smooth(29, 37, 13).astype(np.float32) / 200.0 - 0.1)
    add("tiff_float32_grey.tif", pil_bytes(Image.fromarray(f32[..., 0]),
                                           "TIFF"),
        sample_format=3, rule="float", note="values past [0, 1] clipped")
    add("tiff_float32_rgb_predictor3.tif", tiff_file(
        f32, 2, compression=8, predictor=3, sample_format=3,
        rows_per_strip=6), sample_format=3, predictor=3, rule="float")
    add("tiff_float16_big_endian.tif", tiff_file(
        f32[..., :1].astype(np.float16), 1, order=">", sample_format=3,
        compression=5), sample_format=3, depth=16, rule="float")
    cmap_img = Image.fromarray(rgb).quantize(colors=200, dither=0)
    add("tiff_palette8.tif", pil_bytes(cmap_img, "TIFF",
                                       compression="tiff_lzw"),
        rule="palette", note="imageio gives the indices")
    cmap4 = np.zeros((16, 3), np.uint16)
    cmap4[:] = g.integers(0, 65536, (16, 3))
    add("tiff_palette4.tif", tiff_file(rle4[..., None], 3, bits=4,
                                       colormap=cmap4, compression=5),
        rule="palette", depth=4)
    add("tiff_cmyk.tif", pil_bytes(Image.fromarray(rgb).convert("CMYK"),
                                   "TIFF", compression="tiff_lzw"),
        rule="cmyk", note="imageio gives the CMYK samples")
    pages = [Image.fromarray(textured(29, 37, s)) for s in (30, 31)]
    f = io.BytesIO()
    pages[0].save(f, "TIFF", save_all=True, append_images=pages[1:])
    add("tiff_two_pages.tif", f.getvalue(), rule="pages",
        note="imageio gives (2, H, W, 3)")
    # TIFF the port refuses
    add("tiff_jpeg.tif", pil_bytes(rgb, "TIFF", compression="jpeg"),
        raises="JPEG")
    add("tiff_ccitt_g4.tif", pil_bytes(Image.fromarray(grey).convert("1"),
                                       "TIFF", compression="group4"),
        raises="CCITT")
    old = tiff_file(rgb, 2, compression=5)
    start = old.index(lzw_tiff(np.ascontiguousarray(rgb).tobytes())[:8])
    old = bytearray(old)
    old[start] = 0x00                  # an LSB-first stream: no clear code
    add("tiff_old_style_lzw.tif", bytes(old), raises="old-style LZW")
    add("tiff_ycbcr_subsampled.tif", tiff_file(
        rgb, 6, extra_tags=((530, 3, [2, 2]),)), raises="YCbCr subsampling")

    # TIFF once refused: signed samples, YCbCr without subsampling
    signed = (np.arange(29 * 37 * 3).reshape(29, 37, 3) * 977 % 65536
              - 32768).astype(np.int16)
    add("tiff_int8_grey.tif", tiff_file(signed[..., :1].astype(np.int8), 1,
                                        sample_format=2, compression=5),
        sample_format=2, depth=8, rule="signed", note="imageio gives int8")
    add("tiff_int16_rgb_predictor.tif", tiff_file(
        signed, 2, order=">", sample_format=2, compression=8, predictor=2),
        sample_format=2, depth=16, predictor=2, rule="signed",
        note="imageio gives int16")
    add("tiff_ycbcr_lzw.tif", tiff_file(ycbcr(rgb), 6, compression=5,
                                        extra_tags=((530, 3, [1, 1]),)),
        photometric=6, rule="ycbcr", note="imageio gives the YCbCr samples")
    rationals = [int(round(v * 10000)) for v in (0.2126, 1, 0.7152, 1,
                                                 0.0722, 1)]
    add("tiff_ycbcr_bt709_footroom.tif", tiff_file(
        ycbcr(smooth(29, 37, 18)), 6, compression=8, rows_per_strip=7,
        extra_tags=((530, 3, [1, 1]), (529, 5, rationals),
                    (532, 5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240,
                              1]))),
        photometric=6, rule="ycbcr", note="YCbCrCoefficients BT.709, "
                                          "ReferenceBlackWhite 16-235/240")

    # WebP: lossless (VP8L) and lossy (VP8), in every container
    add("other.webp", pil_bytes(rgb, "WEBP", lossless=True), codec="VP8L")
    add("webp_lossless_rgba.webp", pil_bytes(rgba, "WEBP", lossless=True),
        codec="VP8L", note="imageio gives RGBA")
    add("webp_lossless_smooth_method6.webp", pil_bytes(
        smooth(64, 80, 14), "WEBP", lossless=True, method=6), codec="VP8L")
    for colors in (2, 4, 16, 200):
        q = Image.fromarray(rgb).quantize(colors=colors, dither=0)
        add(f"webp_lossless_palette{colors}.webp", pil_bytes(
            q.convert("RGB"), "WEBP", lossless=True), codec="VP8L",
            note="colour indexing" + (", pixels bundled" if colors <= 16
                                      else ""))
    add("webp_lossy_q90.webp", pil_bytes(rgb, "WEBP", quality=90),
        codec="VP8")
    add("webp_lossy_smooth_q50.webp", pil_bytes(smooth(64, 80, 15), "WEBP",
                                                quality=50), codec="VP8")
    add("webp_lossy_q5.webp", pil_bytes(rgb, "WEBP", quality=5), codec="VP8")
    add("webp_lossy_5x9.webp", pil_bytes(textured(9, 5, 4), "WEBP",
                                         quality=80), codec="VP8",
        note="odd sizes: the upsampler's edges")
    add("webp_lossy_rgba.webp", pil_bytes(rgba, "WEBP", quality=80),
        codec="VP8 + ALPH", note="imageio gives RGBA")
    sm = smooth(64, 80, 16)
    add("webp_lossy_simple_filter.webp", libwebp_encode(
        sm, 60, filter_type=0, filter_strength=70), codec="VP8",
        filter="simple")
    add("webp_lossy_sharpness.webp", libwebp_encode(
        sm, 40, filter_type=1, filter_strength=90, filter_sharpness=6),
        codec="VP8", filter="normal, sharpness 6")
    add("webp_lossy_partitions8.webp", libwebp_encode(
        sm, 70, partitions=3), codec="VP8", note="8 token partitions")
    vp8_sm = dict(riff_chunks(pil_bytes(sm, "WEBP", quality=60)))[b"VP8 "]
    add("webp_lossy_lf_deltas.webp", riff((b"VP8 ", vp8_refilter(
        vp8_sm, 0, 25, 2, (5, 0, 0, 0), (-6, 0, 0, 0)))), codec="VP8",
        filter="normal, level 25, sharpness 2, ref delta 5, mode delta -6",
        note="first partition rewritten by the generator")
    add("webp_lossy_simple_lf_deltas.webp", riff((b"VP8 ", vp8_refilter(
        vp8_sm, 1, 10, 7, (-3, 0, 0, 0), (12, 0, 0, 0)))), codec="VP8",
        filter="simple, level 10, sharpness 7, ref delta -3, mode delta 12",
        note="first partition rewritten by the generator")
    add("webp_lossy_one_segment_unfiltered.webp", libwebp_encode(
        rgb, 75, segments=1, filter_strength=0), codec="VP8")
    vp8 = dict(riff_chunks(pil_bytes(rgb, "WEBP", quality=85)))[b"VP8 "]
    alpha = smooth(29, 37, 17)[..., 2]
    for method in (0, 1):
        for filt, fname in enumerate(("none", "horizontal", "vertical",
                                      "gradient")):
            kind = ("raw", "vp8l")[method]
            add(f"webp_alpha_{kind}_{fname}.webp", riff(
                vp8x(0x10, 37, 29), alph(alpha, method, filt),
                (b"VP8 ", vp8)), codec="VP8 + ALPH", alpha=kind,
                alpha_filter=fname)
    anim = [Image.fromarray(textured(29, 37, s)) for s in (40, 41, 42)]
    for tag, kw in (("lossless", dict(lossless=True)),
                    ("lossy", dict(quality=70))):
        f = io.BytesIO()
        anim[0].save(f, "WEBP", save_all=True, append_images=anim[1:],
                     duration=40, **kw)
        add(f"webp_animated_{tag}.webp", f.getvalue(), codec="ANMF",
            note="imageio reads the first frame")
    frame = dict(riff_chunks(pil_bytes(rgba[:20, :25], "WEBP",
                                       lossless=True)))[b"VP8L"]
    anmf = ((2).to_bytes(3, "little") + (1).to_bytes(3, "little")
            + (24).to_bytes(3, "little") + (19).to_bytes(3, "little")
            + (40).to_bytes(3, "little") + b"\x00"
            + b"VP8L" + struct.pack("<I", len(frame)) + frame
            + b"\0" * (len(frame) & 1))
    add("webp_animated_offset_frame.webp", riff(
        vp8x(0x12, 37, 29), (b"ANIM", bytes(4) + b"\x00\x00"),
        (b"ANMF", anmf)), codec="ANMF", note="a 25 x 20 first frame at "
                                             "(4, 2) of a 37 x 29 canvas")
    whole = pil_bytes(rgb, "WEBP", quality=80)
    add("webp_truncated.webp", whole[:len(whole) * 2 // 3],
        raises="truncated")

    # the decode-time fixtures of the new formats
    add("gif_1024.gif", pil_bytes(big(), "GIF"), large=True)
    add("tiff_1024_lzw.tif", pil_bytes(big(), "TIFF",
                                       compression="tiff_lzw"), large=True)
    add("webp_1024_lossless.webp", pil_bytes(big(), "WEBP", lossless=True),
        large=True)
    add("webp_1024_lossy.webp", pil_bytes(big(), "WEBP", quality=90),
        large=True)
    # DDS: Pillow's files, and headers over seeded random blocks
    rgba2 = np.concatenate([rgb, smooth(29, 37, 19)[..., :1]], -1)
    add("dds_rgb.dds", pil_bytes(rgb, "DDS"), pixel_format="RGB masks")
    add("dds_rgba.dds", pil_bytes(rgba2, "DDS"), pixel_format="RGBA masks")
    add("dds_l.dds", pil_bytes(grey, "DDS"), pixel_format="luminance")
    add("dds_la.dds", pil_bytes(Image.fromarray(np.stack(
        [grey, 255 - grey], -1), "LA"), "DDS"),
        pixel_format="luminance + alpha")
    v565 = g.integers(0, 65536, (29, 37)).astype("<u2")
    add("dds_rgb565.dds", dds_file(37, 29, v565.tobytes(), pfflags=0x40,
                                   bits=16, masks=(0xF800, 0x7E0, 0x1F, 0)),
        pixel_format="16-bit 5-6-5 masks")
    pal = g.integers(0, 256, (256, 4), dtype=np.uint8)
    add("dds_palette8.dds", dds_file(37, 29, pal.tobytes() + pidx.tobytes(),
                                     pfflags=0x20, bits=8),
        pixel_format="8-bit palette of RGBA")
    add("dds_dx10_rgba.dds", dds_file(37, 29, rgba2.tobytes(), dxgi=28),
        pixel_format="DX10 R8G8B8A8_UNORM")
    for fmt in ("DXT1", "DXT3", "DXT5"):
        add(f"dds_{fmt.lower()}.dds", pil_bytes(rgba2, "DDS",
                                                pixel_format=fmt),
            pixel_format=fmt, note="Pillow's encoder; 37 x 29")
    add("dds_bc5.dds", pil_bytes(rgb, "DDS", pixel_format="BC5"),
        pixel_format="BC5")
    nblk = 10 * 8
    add("dds_bc1_random.dds", dds_file(37, 29, bc_blocks(nblk, 8, 1),
                                       b"DXT1"),
        pixel_format="DXT1", note="random blocks: both colour modes")
    add("dds_bc4_random.dds", dds_file(37, 29, bc_blocks(nblk, 8, 2),
                                       b"ATI1"), pixel_format="BC4 (ATI1)")
    add("dds_bc5_signed_random.dds", dds_file(37, 29, bc_blocks(nblk, 16, 3),
                                              b"BC5S"),
        pixel_format="BC5S")
    add("dds_bc5_snorm_dx10.dds", dds_file(37, 29, bc_blocks(nblk, 16, 4),
                                           dxgi=84),
        pixel_format="DX10 BC5_SNORM")
    add("dds_bc6h_uf16.dds", dds_file(37, 29, bc_blocks(
        nblk, 16, 5, BC6_MODES), dxgi=95), pixel_format="BC6H_UF16",
        note="random blocks over all 14 modes and two reserved ones")
    add("dds_bc6h_sf16.dds", dds_file(37, 29, bc_blocks(
        nblk, 16, 6, BC6_MODES), dxgi=96), pixel_format="BC6H_SF16")
    add("dds_bc7.dds", dds_file(37, 29, bc_blocks(nblk, 16, 7, BC7_MODES),
                                dxgi=98),
        pixel_format="BC7_UNORM", note="random blocks over all eight "
                                       "modes and the reserved one")
    add("dds_bc7_srgb_mipmaps.dds", dds_file(
        20, 12, bc_blocks(15 + 6 + 2, 16, 8, BC7_MODES), dxgi=99,
        mipmaps=3), pixel_format="BC7_UNORM_SRGB", note="three mip levels: "
                                                        "the top one read")
    add("dds_bc3_cubemap.dds", dds_file(
        16, 16, bc_blocks(16 * 6, 16, 9), b"DXT5", caps2=0xFE00),
        pixel_format="DXT5", note="a cube map: the first face read")
    add("dds_bc1_srgb.dds", dds_file(16, 16, bc_blocks(16, 8, 10), dxgi=72),
        raises="DXGI format 72", note="BC1_UNORM_SRGB: Pillow refuses it")
    add("dds_truncated.dds", dds_file(37, 29, bc_blocks(nblk, 16, 11)[:700],
                                      b"DXT5"), raises="block data")
    # QOI: Pillow's files, and seeded random op streams
    add("qoi_rgb.qoi", pil_bytes(rgb, "QOI"), channels=3)
    add("qoi_rgba.qoi", pil_bytes(rgba2, "QOI"), channels=4)
    add("qoi_ops_rgba.qoi", qoi_ops(37, 29, 1), channels=4,
        note="every op, a run past the last pixel, colour space 1")
    add("qoi_ops_rgb.qoi", qoi_ops(37, 29, 2, channels=3, colorspace=0),
        channels=3)
    add("qoi_truncated.qoi", qoi_ops(37, 29, 3)[:300], raises="ends before")
    # PNM: Pillow reads .pgm, .ppm and .pnm; imageio hands .pbm and .pfm to
    # OpenCV
    bil = grey > 120

    def plain(header, values, per_line=17):
        lines = [" ".join(str(int(v)) for v in values[i:i + per_line])
                 for i in range(0, len(values), per_line)]
        return (header + "\n".join(lines) + "\n").encode()

    add("pnm_bitmap_plain_comments.pnm", b"P1\n# a comment\n37 29\n"
        + plain("", (~bil).ravel().astype(int), 70).replace(b" ", b""),
        magic="P1", note="digits without spaces; imageio gives bool")
    p4 = np.packbits(~bil, axis=1)
    add("pnm_bitmap_raw.pnm", b"P4\n37 29\n" + p4.tobytes(), magic="P4")
    add("pbm_bitmap_raw.pbm", b"P4 37 29\n" + p4.tobytes(), magic="P4",
        note=".pbm: imageio's OpenCV plugin gives 0 / 255 RGB")
    add("pbm_bitmap_plain.pbm", plain("P1\n37 29\n", (~bil).ravel()
                                      .astype(int), 37), magic="P1")
    add("pgm_raw.pgm", pil_bytes(grey, "PPM"), magic="P5")
    add("pgm_plain_maxval100_comments.pgm", plain(
        "P2\n# made by the generator\n37 29 # size\n100\n",
        (grey.ravel() * 100) // 255), magic="P2", maxval=100)
    grey12 = (smooth(29, 37, 20)[..., 0].astype(np.int64) * 16
              + g.integers(0, 16, (29, 37)))
    add("pgm_raw_maxval4095.pgm", b"P5\n37 29\n4095\n" + grey12.astype(
        ">u2").tobytes(), magic="P5", maxval=4095,
        note="imageio gives int32 scaled to 65535")
    add("pgm_raw_maxval65535.pgm", pil_bytes(Image.fromarray(grey16),
                                             "PPM"), magic="P5",
        maxval=65535)
    add("pgm_plain_maxval1000.pgm", plain(
        "P2 37 29 1000\n", (grey12.ravel() * 1000) // 4095), magic="P2",
        maxval=1000)
    add("ppm_raw.ppm", pil_bytes(rgb, "PPM"), magic="P6")
    add("ppm_plain_maxval15.ppm", plain("P3\n37 29\n15\n",
                                        (rgb.ravel() >> 4)), magic="P3",
        maxval=15)
    add("ppm_raw_maxval200.ppm", b"P6\n37 29\n200\n" + (
        rgb.astype(np.int64) * 200 // 255).astype(np.uint8).tobytes(),
        magic="P6", maxval=200)
    add("ppm_raw_maxval1023.ppm", b"P6 37 29 1023\n" + (
        rgb.astype(np.int64) * 4 + g.integers(0, 4, rgb.shape)).astype(
        ">u2").tobytes(), magic="P6", maxval=1023,
        note="16-bit samples: imageio gives 8 bits")
    fmap = (smooth(29, 37, 21).astype(np.float32) / 200.0 - 0.1)
    add("pfm_grey_as_pgm.pgm", b"Pf\n37 29\n-1.0\n" + fmap[::-1, :, 0]
        .astype("<f4").tobytes(), magic="Pf", rule="float",
        note="Pillow's float map, bottom row first")
    add("pfm_grey.pfm", b"Pf\n37 29\n-1.0\n" + (fmap[::-1, :, 0] * 255)
        .astype("<f4").tobytes(), magic="Pf",
        note=".pfm: OpenCV's float map, rounded to uint8")
    add("pfm_rgb_big_endian_scale.pfm", b"PF\n37 29\n2.5\n" + (
        fmap[::-1] * 600).astype(">f4").tobytes(), magic="PF",
        note="scale 2.5: the samples divided by it")
    # PSD: imageio reads none (its Pillow plugin seeks frame 0)
    planes = np.moveaxis(rgb, -1, 0)
    add("psd_rgb_raw.psd", psd_file(planes, 3), raises="PSD")
    add("psd_rgb_rle.psd", psd_file(planes, 3, rle=True), raises="PSD")
    add("psd_layered.psd", psd_file(
        planes, 3, layers=[(2, 3, np.moveaxis(textured(10, 12, 3), -1, 0),
                            (0, 1, 2))]), raises="PSD",
        note="a layer over the merged image")
    # JPEG 2000, written by Pillow's OpenJPEG (JP2 boxes or a raw
    # codestream), or patched from its files
    grey = rgb[..., 0].copy()
    rgba = np.dstack([rgb, textured(29, 37, 5)[..., 1]])
    grey16 = (textured(29, 37, 6)[..., 0].astype(np.uint16) * 257
              + np.arange(37, dtype=np.uint16))
    images = {"l": Image.fromarray(grey),
              "la": Image.fromarray(rgba[..., ::2].copy(), "LA"),
              "rgb": Image.fromarray(rgb), "rgba": Image.fromarray(rgba),
              "i16": Image.fromarray(grey16)}
    for tag, im in images.items():
        for ext, no_jp2 in (("jp2", False), ("j2k", True)):
            add(f"jpeg2000_{tag}.{ext}", pil_bytes(im, "JPEG2000",
                                                   no_jp2=no_jp2),
                mode=im.mode, wavelet="5/3")
    j2k = lambda img=images["rgb"], **kw: pil_bytes(img, "JPEG2000",
                                                     no_jp2=True, **kw)
    add("jpeg2000_rct.j2k", j2k(mct=1), wavelet="5/3", mct="RCT")
    add("jpeg2000_97_ict.jp2", pil_bytes(images["rgb"], "JPEG2000",
                                         irreversible=True, mct=1),
        wavelet="9/7", mct="ICT")
    add("jpeg2000_97_grey.j2k", j2k(images["l"], irreversible=True),
        wavelet="9/7")
    add("jpeg2000_layers.j2k", j2k(quality_layers=[40, 20, 8]),
        wavelet="5/3", note="three quality layers, lossy")
    add("jpeg2000_97_layers.j2k", j2k(irreversible=True, mct=1,
                                      quality_layers=[60, 25, 10]),
        wavelet="9/7", mct="ICT", note="three quality layers")
    add("jpeg2000_tiles_offset.j2k", j2k(offset=(3, 5), tile_offset=(1, 2),
                                         tile_size=(16, 12)),
        wavelet="5/3", note="odd image and tile origins, 12 tiles")
    add("jpeg2000_97_tiles_offset.jp2", pil_bytes(
        images["rgb"], "JPEG2000", offset=(7, 2), tile_offset=(6, 1),
        tile_size=(20, 20), irreversible=True, mct=1), wavelet="9/7",
        mct="ICT")
    add("jpeg2000_precincts.j2k", j2k(precinct_size=(32, 16),
                                      quality_layers=[30, 10]),
        wavelet="5/3", note="precincts and two layers")
    add("jpeg2000_codeblocks_16x4.j2k", j2k(codeblock_size=(16, 4)),
        wavelet="5/3")
    add("jpeg2000_resolutions_1.j2k", j2k(num_resolutions=1), wavelet="5/3",
        note="no wavelet level")
    add("jpeg2000_resolutions_7.jp2", pil_bytes(
        Image.fromarray(textured(64, 64, 7)), "JPEG2000",
        num_resolutions=7, irreversible=True), wavelet="9/7",
        note="six levels")
    for order in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        add(f"jpeg2000_{order.lower()}.j2k", j2k(
            progression=order, precinct_size=(16, 16),
            quality_layers=[30, 12]), wavelet="5/3", progression=order)
    add("jpeg2000_plt.j2k", j2k(plt=True), wavelet="5/3",
        note="PLT markers, skipped")
    add("jpeg2000_comment.jp2", pil_bytes(images["rgb"], "JPEG2000",
                                          comment="a texture"),
        wavelet="5/3", note="a COM marker")
    add("jpeg2000_cinema2k.j2k", j2k(cinema_mode="cinema2k-24"),
        wavelet="9/7", note="three tile-parts, TLM, CPRL")
    add("jpeg2000_1x1.j2k", j2k(Image.fromarray(rgb[:1, :1])),
        wavelet="5/3")
    add("jpeg2000_97_1x2.jp2", pil_bytes(Image.fromarray(rgb[:2, :1]),
                                         "JPEG2000", irreversible=True),
        wavelet="9/7")
    add("jpeg2000_odd_19x7.j2k", j2k(Image.fromarray(textured(7, 19, 8)),
                                     offset=(1, 3), tile_size=(32, 32),
                                     irreversible=True, num_resolutions=3),
        wavelet="9/7", note="odd sizes at odd origins")
    add("jpeg2000_signed.jp2", pil_bytes(images["rgb"], "JPEG2000",
                                         signed=True),
        wavelet="5/3", note="signed samples: read back shifted by 128")
    add("jpeg2000_ycbcr.jp2", pil_bytes(images["rgb"].convert("YCbCr"),
                                        "JPEG2000"),
        wavelet="5/3", note="sYCC, made RGB by Pillow's tables")
    add("jpeg2000_cmyk.jp2", pil_bytes(images["rgb"].convert("CMYK"),
                                       "JPEG2000"),
        wavelet="5/3", rule="cmyk", note="colr 12: imageio gives CMYK")
    add("jpeg2000_subsampled.j2k", j2k_subsampled(rgb), wavelet="5/3",
        note="components 1 and 2 sub-sampled 2 x 2: OpenJPEG takes them "
             "for sYCC, Pillow indexes them by width // 2")
    add("jpeg2000_subsampled_srgb.jp2", jp2_join([
        [b"jP  ", b"\r\n\x87\n"], [b"ftyp", b"jp2 \0\0\0\0jp2 "],
        [b"jp2h", jp2_join([[b"ihdr", struct.pack(">IIHBBBB", 29, 37, 3, 7,
                                                  7, 0, 0)], colr(16)])],
        [b"jp2c", j2k_subsampled(rgb, (1, 1, 3))]]), wavelet="5/3",
        note="component 2 sub-sampled 3 x 3 under an sRGB colr box")
    # the encoder options Pillow does not pass on, through its OpenJPEG
    planes = [rgb[..., c] for c in range(3)]
    opj = lambda **kw: openjpeg_encode(planes, numresolution=4, **kw)
    add("jpeg2000_sop_eph.j2k", opj(csty=6, rates=(30, 10, 0)),
        wavelet="5/3", note="SOP before and EPH after every packet header")
    add("jpeg2000_poc.j2k", opj(rates=(20, 0), pocs=[
        (0, 0, 2, 2, 3, 2), (2, 0, 2, 4, 3, 4)]), wavelet="5/3",
        note="POC: RPCL over resolutions 0-1, CPRL over 2-3")
    for mode, tag in ((1, "bypass"), (2, "reset"), (4, "termall"),
                      (8, "vertically_causal"), (16, "pterm"),
                      (32, "segsym"), (63, "all_styles")):
        add(f"jpeg2000_cblk_{tag}.j2k", opj(mode=mode, irreversible=1,
                                            rates=(40, 12, 3)),
            wavelet="9/7", cblksty=mode, note="code-block style")
    add("jpeg2000_rgn.j2k", opj(roi_compno=0, roi_shift=5), wavelet="5/3",
        note="RGN: component 0 shifted up 5 bit planes")
    add("jpeg2000_420_encoder.j2k", openjpeg_encode(
        [rgb[..., 0], rgb[::2, ::2, 1], rgb[::2, ::2, 2]],
        [(1, 1), (2, 2), (2, 2)], W=37, H=29, numresolution=3,
        irreversible=1), wavelet="9/7",
        note="4:2:0 from the encoder: OpenJPEG's sYCC guess")
    base = pil_bytes(images["l"], "JPEG2000", no_jp2=True)
    add("jpeg2000_precision_5.j2k", set_precision(base, 0, 5),
        note="SIZ patched to 5 bits: clamped, shifted up to 8")
    add("jpeg2000_precision_12.j2k", set_precision(base, 0, 12),
        note="SIZ patched to 12 bits: mode I;16")
    add("jpeg2000_97_precision_10.j2k", set_precision(set_precision(
        set_precision(j2k(irreversible=True, mct=1), 0, 10), 1, 10), 2, 10),
        note="SIZ patched to 10 bits: rounded down to 8")
    jrgb = pil_bytes(images["rgb"], "JPEG2000")
    jrgba = pil_bytes(images["rgba"], "JPEG2000")
    jgrey = pil_bytes(images["l"], "JPEG2000")
    add("jpeg2000_colr_cmyk.jp2", jp2_header(
        jrgba, lambda h: [h[0], colr(12)]), rule="cmyk",
        note="an RGBA file's colr patched to CMYK")
    add("jpeg2000_colr_icc.jp2", jp2_header(
        jrgb, lambda h: [h[0], colr(icc=b"\x00" * 24)]),
        note="an ICC colr: colour space unspecified")
    add("jpeg2000_cdef_reorder.jp2", jp2_header(jrgb, lambda h: h + [[
        b"cdef", struct.pack(">H", 3) + b"".join(struct.pack(
            ">HHH", i, 0, a) for i, a in ((0, 3), (1, 2), (2, 1)))]]),
        note="cdef reverses the channels: not applied")
    palette = [tuple(int(v) for v in c) for c in textured(16, 16, 9)
               .reshape(-1, 3)]
    add("jpeg2000_pclr.jp2", jp2_header(jgrey, lambda h: [
        h[0], colr(16)] + pclr(palette)), mode="P",
        note="a 256-entry palette; equal colours kept once")
    add("jpeg2000_pclr_rgba.jp2", jp2_header(jgrey, lambda h: [
        h[0], colr(16)] + pclr([c + (c[0],) for c in palette[:200]])),
        mode="P", note="a 4-column palette of 200 entries")
    add("jpeg2000_pclr_la.jp2", jp2_header(
        pil_bytes(images["la"], "JPEG2000"),
        lambda h: [h[0], colr(16)] + pclr(palette)), mode="PA",
        note="PA: imageio gives the indices and alpha")
    add("jpeg2000_truncated.jp2", jrgb[:-40], raises="runs past",
        note="cut inside the tile's data")
    add("jpeg2000_no_eoc.j2k", base[:-2], raises="EOC")
    add("jpeg2000_colr_grey_rgb.jp2", jp2_header(
        jrgb, lambda h: [h[0], colr(17)]), raises="Pillow reads no",
        note="grey colour space for three components")
    add("jpeg2000_pclr_300.jp2", jp2_header(jgrey, lambda h: [
        h[0], colr(16)] + pclr([(i % 256, i // 256, 1) for i in range(300)])),
        raises="256 colours", note="Pillow cannot allocate the palette")
    # AVIF stays queued: imageio reads it, the port refuses it naming the
    # format

    # the decode-time fixtures of this slice's formats
    bg = big()
    add("jpeg_1024_arith_sequential_420.jpg", jpeg_encode(
        ycbcr(bg), [(2, 2), (1, 1), (1, 1)], coding="arithmetic",
        quality=75), process="arithmetic sequential", large=True,
        note="under 64 KiB, which imageio needs of an arithmetic JPEG")
    add("jpeg_1024_arith_progressive_420.jpg", jpeg_encode(
        ycbcr(bg), [(2, 2), (1, 1), (1, 1)], coding="arithmetic",
        quality=70, progressive=True), process="arithmetic progressive",
        large=True)
    add("jpeg_1024_cmyk.jpg", pil_bytes(Image.fromarray(bg).convert("CMYK"),
                                        "JPEG", quality=90),
        process="baseline", channels=4, rule="cmyk", large=True)
    add("dds_1024_bc1.dds", pil_bytes(bg, "DDS", pixel_format="DXT1"),
        pixel_format="DXT1", large=True)
    add("dds_1024_bc7.dds", dds_file(1024, 1024, bc_blocks(
        256 * 256, 16, 12, BC7_MODES), dxgi=98), pixel_format="BC7_UNORM",
        large=True, note="random blocks over every mode")
    add("qoi_1024.qoi", pil_bytes(bg // 4 * 4, "QOI"), channels=3,
        large=True)
    add("jp2_1024_53.jp2", pil_bytes(bg, "JPEG2000"), wavelet="5/3",
        large=True)
    add("jp2_1024_97_mct.jp2", pil_bytes(bg, "JPEG2000", irreversible=True,
                                         mct=1), wavelet="9/7", mct="ICT",
        large=True)
    tiff_sample_cases(add)
    pnm_cases(add)
    tiff_codec_cases(add)
    return out


# ---------------------------------------------- TIFF samples and Lab, PNM
# sRGB (D65) -> XYZ (D50) by Bradford, the inverse of the port's stated
# Lab rule's matrix, to make Lab fixtures of the synthetic textures
SRGB_TO_XYZ = np.array([[0.43604125161605095, 0.38511291079815546,
                         0.1430458375857936],
                        [0.2224845402294774, 0.7169050786084573,
                         0.06061038116206523],
                        [0.01392018747137537, 0.09706723869712398,
                         0.7139125738315005]])
D50 = (0.9642, 1.0, 0.8249)
XYZ_TO_SRGB = ((3.134186364236819, -1.6172089589982752, -0.49069406400638405),
               (-0.9787485041906941, 1.9161300967735873, 0.03343339915999557),
               (0.07196392780224675, -0.22899387345320327, 1.4057537328964445))


def srgb_to_lab(rgb):
    """uint8 sRGB -> CIE L*a*b* (D50) float64."""
    c = rgb.astype(np.float64) / 255.0
    lin = np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    xyz = lin @ SRGB_TO_XYZ.T / np.array(D50)
    f = np.where(xyz > (6 / 29) ** 3, np.cbrt(xyz),
                 xyz / (3 * (6 / 29) ** 2) + 4 / 29)
    return np.stack([116 * f[..., 1] - 16, 500 * (f[..., 0] - f[..., 1]),
                     200 * (f[..., 1] - f[..., 2])], -1)


def lab_rule(lab):
    """The port's stated Lab rule (``viz/tiff.lab_to_rgb``): L*a*b* (D50)
    -> XYZ by CIE 1976's inverse -> linear sRGB (the matrix of
    ``viz/tiff.XYZ_TO_SRGB``, each row's products summed left to right) ->
    clipped, sRGB-encoded, times 255, rounded half to even."""
    fy = (lab[..., 0] + 16.0) / 116.0
    fs = (fy + lab[..., 1] / 500.0, fy, fy - lab[..., 2] / 200.0)
    xyz = [np.where(f > 6.0 / 29.0, f * f * f,
                    3.0 * (6.0 / 29.0) ** 2 * (f - 4.0 / 29.0)) * w
           for f, w in zip(fs, D50)]
    out = []
    for m in XYZ_TO_SRGB:
        lin = np.clip(m[0] * xyz[0] + m[1] * xyz[1] + m[2] * xyz[2], 0, 1)
        enc = np.where(lin <= 0.0031308, 12.92 * lin,
                       1.055 * lin ** (1.0 / 2.4) - 0.055)
        out.append(np.rint(enc * 255.0))
    return np.stack(out, -1).astype(np.uint8)


def lab_codes(lab, photometric, bits):
    """L*a*b* -> (H, W, 3) stored samples of a CIELab (8: a*, b* two's
    complement, over 2^(bits-8)), ICCLab (9: a* + 128 on the 8-bit scale)
    or ITULab (10: the default Decode ranges) file of ``bits`` bits."""
    top = (1 << bits) - 1
    dt = np.uint8 if bits == 8 else np.uint16
    L = np.rint(lab[..., 0] / 100 * top)
    if photometric == 8:
        ab = np.rint(lab[..., 1:] * (1 << (bits - 8)))
        ab = ab.clip(-(1 << (bits - 1)), (1 << (bits - 1)) - 1).astype(
            np.int64) & top
    elif photometric == 9:
        ab = np.rint((lab[..., 1:] + 128) / 255 * top)
    else:
        lo, hi = np.array([-85.0, -75.0]), np.array([85.0, 125.0])
        ab = np.rint((lab[..., 1:] - lo) / (hi - lo) * top)
    return np.dstack([L, ab]).clip(0, top).astype(dt)


def lab_from_codes(arr, photometric, bits, decode=None):
    """A Lab file's samples as imageio gives them -> L*a*b*, as the TIFF
    specifications encode it (the rule's reading: ``viz/tiff.py``)."""
    u = arr.astype(np.int64) & ((1 << bits) - 1)
    t = u / float((1 << bits) - 1)
    n = 3 if arr.ndim == 3 and arr.shape[-1] >= 3 else 1
    if arr.ndim == 2:
        t, u = t[..., None], u[..., None]
    lab = np.zeros(t.shape[:-1] + (3,))
    if photometric == 10:
        rng = decode or (0.0, 100.0, -85.0, 85.0, -75.0, 125.0)
        for c in range(n):
            lab[..., c] = rng[2 * c] + t[..., c] * (rng[2 * c + 1]
                                                    - rng[2 * c])
        return lab
    lab[..., 0] = 100.0 * t[..., 0]
    if n == 3 and photometric == 8:
        s = np.where(u[..., 1:3] >= 1 << (bits - 1), u[..., 1:3] - (1 << bits),
                     u[..., 1:3])
        lab[..., 1:] = s / float(1 << (bits - 8))
    elif n == 3:
        lab[..., 1:] = 255.0 * t[..., 1:3] - 128.0
    return lab


def tiff_sample_cases(add):
    """The TIFFs of every sample type, photometric interpretation and depth
    imageio's tifffile reads, and those it refuses."""
    from PIL import Image
    g = np.random.default_rng(1800)
    rgb = textured(29, 37, 40)
    smooth8 = smooth(29, 37, 41)
    wide32 = rgb.astype(np.uint32) * 16843009 + g.integers(
        0, 1 << 24, rgb.shape).astype(np.uint32)
    add("tiff_uint32_rgb_lzw_predictor.tif", tiff_file(
        wide32, 2, compression=5, predictor=2, rows_per_strip=8),
        depth=32, predictor=2, rule="wide", note="imageio gives uint32")
    add("tiff_uint32_grey_big_endian_tiles.tif", tiff_file(
        wide32[..., :1], 1, order=">", tile=(16, 16), compression=8),
        depth=32, order="MM", rule="wide")
    wide64 = rgb.astype(np.uint64) * np.uint64(0x0101010101010101) \
        + g.integers(0, 1 << 56, rgb.shape, dtype=np.uint64)
    add("tiff_uint64_rgb_big_endian_deflate.tif", tiff_file(
        wide64, 2, order=">", compression=8), depth=64, order="MM",
        rule="wide", note="the sample and 2^64 - 1 rounded to float64")
    add("tiff_uint64_rgb_planar_predictor.tif", tiff_file(
        wide64, 2, planar=2, predictor=2, compression=5, rows_per_strip=10),
        depth=64, planar=2, predictor=2, rule="planar+wide")
    s32 = (wide32.astype(np.int64) - (1 << 31)).astype(np.int32)
    add("tiff_int32_rgb_big_endian_predictor.tif", tiff_file(
        s32, 2, order=">", sample_format=2, predictor=2, compression=8),
        sample_format=2, depth=32, predictor=2, rule="signed")
    add("tiff_int32_grey_tiles.tif", tiff_file(
        s32[..., 1:2], 1, sample_format=2, tile=(32, 16), compression=32773),
        sample_format=2, depth=32, rule="signed")
    s64 = (wide64 ^ np.uint64(1 << 63)).view(np.int64)
    add("tiff_int64_grey_lzw.tif", tiff_file(
        s64[..., :1], 1, sample_format=2, compression=5), sample_format=2,
        depth=64, rule="signed")
    add("tiff_int64_rgb_big_endian_planar.tif", tiff_file(
        s64, 2, order=">", sample_format=2, planar=2), sample_format=2,
        depth=64, planar=2, rule="planar+signed")
    cpx = (smooth8.astype(np.float32) / 250.0 - 0.01) + 1j * g.random(
        smooth8.shape).astype(np.float32)
    add("tiff_complex64_grey.tif", tiff_file(
        cpx[..., :1].astype(np.complex64), 1, sample_format=6,
        compression=8), sample_format=6, depth=64, rule="complex",
        note="the real part, as np.asarray(..., np.float32) keeps it")
    add("tiff_complex128_rgb_big_endian_predictor.tif", tiff_file(
        cpx.astype(np.complex128), 2, order=">", sample_format=6,
        predictor=2, compression=5), sample_format=6, depth=128,
        predictor=2, rule="complex")
    f64 = smooth8.astype(np.float64) / 240.0 - 0.02
    add("tiff_float64_rgb_predictor3_big_endian_raw.tif", tiff_file(
        f64, 2, order=">", sample_format=3, predictor=3), sample_format=3,
        depth=64, predictor=3, order="MM", rule="float",
        note="uncompressed: tifffile swaps each sample's bytes before it "
             "undoes the predictor")
    add("tiff_float64_rgb_predictor3_raw.tif", tiff_file(
        f64, 2, sample_format=3, predictor=3), sample_format=3, depth=64,
        predictor=3, rule="float")
    f32 = smooth(32, 32, 47).astype(np.float32) / 240.0 - 0.02
    add("tiff_float32_tiles_predictor3_one_block.tif", tiff_file(
        f32, 2, sample_format=3, predictor=3, tile=(32, 16)),
        sample_format=3, predictor=3, rule="float",
        note="tiles as wide as the image, uncompressed: one block")
    add("tiff_float32_grey_predictor2.tif", tiff_file(
        f64[..., :1].astype(np.float32), 1, sample_format=3, predictor=2,
        compression=8), sample_format=3, predictor=2, rule="float")
    p565 = np.stack([g.integers(0, 1 << b, (29, 37)) for b in (5, 6, 5)],
                    -1).astype(np.uint8)
    add("tiff_rgb565.tif", tiff_file(p565, 2, bits=(5, 6, 5),
                                     compression=5), bits="5-6-5",
        note="imageio gives uint8, each field rescaled")
    add("tiff_rgb565_big_endian_predictor.tif", tiff_file(
        p565, 2, order=">", bits=(5, 6, 5), predictor=2), bits="5-6-5",
        order="MM", predictor=2, note="tifffile reads the pixels "
                                      "little-endian")
    grey2 = g.integers(0, 4, (29, 37, 1)).astype(np.uint8)
    add("tiff_grey2_big_endian.tif", tiff_file(grey2, 1, order=">", bits=2,
                                               compression=32773),
        depth=2, rule="scale")
    add("tiff_grey2_predictor2.tif", tiff_file(grey2, 1, bits=2,
                                               predictor=2),
        depth=2, predictor=2, rule="scale",
        note="tifffile's sums wrap at 8 bits: values past 3, saturated")
    add("tiff_bilevel_predictor2.tif", tiff_file(grey2 & 1, 1, bits=1,
                                                 predictor=2, compression=5),
        depth=1, predictor=2, note="tifffile ORs the bits along the row")
    cmap2 = g.integers(0, 65536, (4, 3))
    add("tiff_palette2_predictor2.tif", tiff_file(
        grey2, 3, bits=2, predictor=2, colormap=cmap2), depth=2,
        predictor=2, rule="palette", note="indices past the map black")
    idx16 = g.integers(0, 65536, (29, 37, 1)).astype(np.uint16)
    add("tiff_palette16.tif", tiff_file(
        idx16, 3, colormap=g.integers(0, 65536, (65536, 3)),
        compression=8), depth=16, rule="palette")
    add("tiff_palette_without_colormap.tif", tiff_file(
        rgb[..., :1], 3, compression=5), note="the indices, as grey")
    add("tiff_rgb_predictor5.tif", tiff_file(rgb, 2, predictor=5),
        predictor=5, note="tifffile ignores an unknown predictor")
    # photometric interpretations
    lab = srgb_to_lab(smooth8)
    add("tiff_cielab_pillow.tif", pil_bytes(Image.frombytes(
        "LAB", (37, 29), lab_codes(lab, 8, 8).tobytes()), "TIFF",
        compression="tiff_lzw"), photometric=8, rule="lab",
        note="Pillow's file, which Pillow opens as LAB")
    add("tiff_cielab16_big_endian.tif", tiff_file(
        lab_codes(lab, 8, 16), 8, order=">", compression=8), photometric=8,
        depth=16, rule="lab")
    add("tiff_cielab_l_only.tif", tiff_file(
        lab_codes(lab, 8, 8)[..., :1], 8), photometric=8, rule="lab")
    add("tiff_icclab.tif", tiff_file(lab_codes(lab, 9, 8), 9,
                                     compression=5), photometric=9,
        rule="lab")
    add("tiff_icclab16_tiles.tif", tiff_file(
        lab_codes(lab, 9, 16), 9, tile=(16, 16), compression=8),
        photometric=9, depth=16, rule="lab")
    add("tiff_itulab.tif", tiff_file(lab_codes(lab, 10, 8), 10,
                                     compression=5), photometric=10,
        rule="lab")
    add("tiff_itulab_decode.tif", tiff_file(
        lab_codes(lab, 10, 8), 10, extra_tags=((433, 10, [
            0, 1, 100, 1, -100, 1, 100, 1, -100, 1, 100, 1]),)),
        photometric=10, rule="lab", decode=[0, 100, -100, 100, -100, 100])
    add("tiff_cielab_float32.tif", tiff_file(
        lab.astype(np.float32) / 100, 8, sample_format=3), photometric=8,
        sample_format=3, rule="float", note="Lab at another depth: the "
                                            "samples")
    add("tiff_cfa16.tif", tiff_file(
        (smooth8[..., :1].astype(np.uint16) * 257), 32803, compression=5),
        photometric=32803, depth=16)
    add("tiff_linear_raw_rgb.tif", tiff_file(rgb, 34892, compression=8),
        photometric=34892)
    add("tiff_transparency_mask.tif", tiff_file(grey2 & 1, 4, bits=1,
                                                compression=32773),
        photometric=4, depth=1)
    add("tiff_logluv_raw.tif", tiff_file(rgb, 32845), photometric=32845,
        note="LogLuv samples without SGILog compression: as stored")
    add("tiff_logl16.tif", tiff_file(
        smooth8[..., 1:2].astype(np.uint16) * 200, 32844, compression=8),
        photometric=32844, depth=16)
    add("tiff_photometric_7.tif", tiff_file(rgb, 7), photometric=7,
        note="a code TIFF does not define")
    cmyk = np.asarray(Image.fromarray(smooth8).convert("CMYK"))
    add("tiff_cmyk16_big_endian.tif", tiff_file(
        cmyk.astype(np.uint16) * 257 + g.integers(0, 257, cmyk.shape).astype(
            np.uint16), 5, order=">", compression=5), photometric=5,
        depth=16, rule="cmyk", note="the high byte, then Pillow's formula")
    add("tiff_cmyk_float32.tif", tiff_file(
        cmyk.astype(np.float32) / 255.0, 5, sample_format=3),
        photometric=5, sample_format=3, rule="cmyk")
    add("tiff_cmyk4.tif", tiff_file(cmyk >> 4, 5, bits=4), photometric=5,
        depth=4, rule="cmyk")
    add("tiff_separated_five_inks.tif", tiff_file(
        np.dstack([cmyk, rgb[..., :1]]), 5, compression=5,
        extra_tags=((332, 3, [2]),)), photometric=5, inkset=2,
        note="not CMYK: the samples")
    add("tiff_ycbcr16.tif", tiff_file(
        ycbcr(smooth8).astype(np.uint16) * 257, 6, compression=8,
        extra_tags=((530, 3, [1, 1]),)), photometric=6, depth=16,
        rule="ycbcr16")
    add("tiff_miniswhite16.tif", tiff_file(
        65535 - smooth8[..., :1].astype(np.uint16) * 257, 0), photometric=0,
        depth=16, rule="miniswhite")
    add("tiff_miniswhite_int16.tif", tiff_file(
        (smooth8[..., :1].astype(np.int16) * 200 - 20000), 0,
        sample_format=2, compression=5), photometric=0, sample_format=2,
        rule="miniswhite+signed")
    add("tiff_miniswhite_float32.tif", tiff_file(
        f64[..., :1].astype(np.float32), 0, sample_format=3),
        photometric=0, sample_format=3, rule="miniswhite+float")
    add("tiff_rgb_two_samples.tif", tiff_file(rgb[..., :2], 2),
        note="photometric RGB with two samples: grey + alpha")
    # image depth above 1: imageio gives the volume, the port its first
    # plane
    vol = np.concatenate([rgb, textured(29, 37, 42), textured(29, 37, 43)])
    add("tiff_depth3_rgb_strips.tif", tiff_file(
        vol, 2, depth=3, rows_per_strip=10, compression=5), image_depth=3,
        rule="depth", note="strips run on across the planes")
    vol2 = np.concatenate([smooth8[:16, :32, :1], rgb[:16, :32, :1]])
    add("tiff_depth2_grey_tiles.tif", tiff_file(
        vol2, 1, depth=2, tile=(16, 16), compression=8), image_depth=2,
        rule="depth")
    add("tiff_depth2_rgb_planar.tif", tiff_file(
        vol[:58], 2, depth=2, planar=2, rows_per_strip=7), image_depth=2,
        planar=2, rule="depth_planar")
    # imageio refuses these, and so does the port
    for bits, dt in ((3, np.uint8), (12, np.uint16), (24, np.uint32)):
        v = g.integers(0, 1 << bits, (29, 37, 3)).astype(dt)
        add(f"tiff_uint{bits}_rgb.tif", tiff_file(v, 2, bits=bits,
                                                  compression=5),
            depth=bits, raises=f"{bits}-bit samples")
    add("tiff_float24.tif", tiff_file(wide32 >> 8, 1, bits=24,
                                      sample_format=3),
        raises="sample format 3 at 24 bits")
    add("tiff_sample_format4.tif", tiff_file(rgb, 2, sample_format=4),
        raises="sample format 4")
    add("tiff_sample_format5.tif", tiff_file(
        wide32.astype(np.uint16), 2, sample_format=5),
        raises="sample format 5")
    add("tiff_mixed_sample_formats.tif", tiff_file(
        rgb, 2, sample_format=(2, 1, 2)), raises="sample format")
    add("tiff_int16_predictor3.tif", tiff_file(
        s32.astype(np.int16), 2, sample_format=2, predictor=3),
        raises="predictor 3")
    add("tiff_float32_predictor3_tiles.tif", tiff_file(
        f32, 2, sample_format=3, predictor=3, tile=(16, 16),
        compression=8), raises="predictor 3 in tiles")
    planar565 = bytearray(tiff_file(p565, 2, bits=(5, 6, 5)))
    at = planar565.index(struct.pack("<HHIH", 284, 3, 1, 1))
    planar565[at + 8] = 2
    add("tiff_rgb565_planar.tif", bytes(planar565), bits="5-6-5",
        planar=2, rule="planar", note="chunky data with PlanarConfiguration "
        "2: tifffile fills the first plane with the fields in turn")
    add("tiff_logluv_sgilog.tif", tiff_file(rgb, 32845, compression=34676),
        raises="SGI LogLuv")
    # the decode-time fixtures of this slice
    bg = big()
    add("tiff_1024_uint32_deflate_predictor.tif", tiff_file(
        bg.astype(np.uint32) * 16843009, 2, compression=8, predictor=2,
        rows_per_strip=64), depth=32, predictor=2, rule="wide", large=True)
    add("tiff_1024_cielab_lzw.tif", pil_bytes(Image.frombytes(
        "LAB", (1024, 1024), lab_codes(srgb_to_lab(bg), 8, 8).tobytes()),
        "TIFF", compression="tiff_lzw", tiffinfo={317: 2}), photometric=8,
        predictor=2, rule="lab", large=True)


def pnm_cases(add):
    """PNM files of every magic OpenCV reads under the names imageio hands
    to it (.pbm, .pfm; PF and PAM under any name), and Pillow's PPM
    extensions."""
    g = np.random.default_rng(1801)
    grey = smooth(29, 37, 44)[..., 0]
    rgb = textured(29, 37, 45)
    add("pbm_grey_raw_maxval100.pbm", b"P5\n37 29\n100\n" + (
        grey // 2).astype(np.uint8).tobytes(), magic="P5", maxval=100,
        note="OpenCV: raw samples unscaled, grey as RGB")
    rgb16 = rgb.astype(np.uint16) * 256 + g.integers(0, 256, rgb.shape)
    add("pbm_rgb_raw16.pbm", b"P6 37 29 65535\n" + rgb16.astype(
        ">u2").tobytes(), magic="P6", maxval=65535,
        note="OpenCV: the high byte")
    grey12 = grey.astype(np.int64) * 16 + g.integers(0, 16, grey.shape)
    add("pbm_grey_plain_maxval4095.pbm", ("P2\n# OpenCV's comment\n37 29\n"
        "4095\n" + " ".join(str(v) for v in grey12.ravel()) + "\n"
        ).encode(), magic="P2", maxval=4095)
    v = (rgb.astype(np.int64) * 100 // 255).ravel()
    v[::97] = 150                       # past the maxval: clamped
    add("pbm_rgb_plain_maxval100.pbm", ("P3 37 29 100\n" + "\n".join(
        " ".join(str(x) for x in v[i:i + 20]) for i in range(0, v.size, 20))
        + "\n").encode(), magic="P3", maxval=100,
        note="OpenCV: clamped to the maxval, v * 255 // maxval")
    add("pfm_rgb_raw.pfm", b"P6\n37 29\n255\n" + rgb.tobytes(),
        magic="P6")
    add("pbm_bitmap_plain_digits.pbm", b"P1\n37 29\n" + (
        48 + g.integers(0, 10, 37 * 29) * g.integers(0, 2, 37 * 29)).astype(
            np.uint8).tobytes() + b"\n", magic="P1",
        note="OpenCV: one digit a pixel, any nonzero one black")
    fmap = (smooth(29, 37, 46).astype(np.float32) / 200.0 - 0.1)
    add("pbm_float_grey.pbm", b"Pf\n37 29\n-0.5\n" + (fmap[::-1, :, 0] * 100)
        .astype("<f4").tobytes(), magic="Pf", note="OpenCV's float map")
    add("ppm_float_colour.ppm", b"PF\n37 29\n3\n" + (fmap[::-1] * 700)
        .astype(">f4").tobytes(), magic="PF",
        note="PF, which Pillow does not read: OpenCV, whatever the name")
    cmyk = np.dstack([rgb, grey])
    add("pnm_p0cmyk.pnm", b"P0CMYK\n37 29\n255\n" + cmyk.tobytes(),
        magic="P0CMYK", rule="cmyk")
    add("ppm_pycmyk_maxval100.ppm", b"PyCMYK\n37 29\n100\n" + (
        cmyk.astype(np.int64) * 100 // 255).astype(np.uint8).tobytes(),
        magic="PyCMYK", maxval=100, rule="cmyk")
    add("pbm_pyrgba.pbm", b"PyRGBA 37 29 255\n" + cmyk.tobytes(),
        magic="PyRGBA", note="OpenCV knows no PyRGBA: Pillow reads it")
    # PAM, which only OpenCV reads, whatever the name
    pam = b"P7\nWIDTH 37\nHEIGHT 29\nDEPTH %d\nMAXVAL %d\n%sENDHDR\n"
    add("pam_rgb.ppm", pam % (3, 255, b"# no tuple type\n") + rgb.tobytes(),
        magic="P7", note="OpenCV reads the samples as BGR: imageio's RGB "
                         "is reversed")
    add("pam_grey16.pgm", pam % (1, 65535, b"TUPLTYPE GRAYSCALE\n")
        + (grey.astype(np.uint16) * 257).astype(">u2").tobytes(),
        magic="P7", maxval=65535, note="the high byte, as RGB")
    add("pam_bits.pbm", pam % (1, 1, b"TUPLTYPE BLACKANDWHITE\n")
        + g.integers(0, 256, (29, 37)).astype(np.uint8).tobytes(),
        magic="P7", maxval=1, note="each row's first 37 bits, 1 white")
    # imageio refuses these, and so does the port
    add("ppm_pyp.ppm", b"PyP\n37 29\n255\n" + grey.tobytes(),
        raises="PyP")
    add("pbm_plain_maxval1000_unterminated.pbm", b"P2\n2 1\n1000\n5 999",
        raises="past the end", note="OpenCV reads a byte past the last "
                                    "number")
    add("pfm_without_line_feed.pfm", b"Pf 37 29 -1.0\n" + fmap[..., 0]
        .astype("<f4").tobytes(), raises="line feed")


def tiff_codec_cases(add):
    """CCITT fax and SGILog TIFFs, which tifffile (and so imageio under a
    TIFF name) refuses and OpenCV's libtiff decodes: written by Pillow's
    libtiff (every CCITT coding it writes, Group3Options, fill order 2,
    strips), by OpenCV's libtiff (LogLuv32 and LogLuv24 from float
    images) and by the writers above (2-D Group 3, tiles, min-is-white,
    rows without EOLs, LogL16, LogLuv in tiles and in fill order 2); and
    the 1024 x 1024 Group 4 and LogLuv32 files of the decode times."""
    import cv2
    from PIL import Image, TiffImagePlugin
    g = np.random.default_rng(2020)
    smooth1 = smooth(29, 37, 50)[..., 0] > 127
    bitmap = smooth1 ^ (g.random(smooth1.shape) < 0.06)   # runs and specks
    mode1 = Image.fromarray(bitmap.astype(np.uint8) * 255).convert("1")

    def pil(compression, **tags):
        info = TiffImagePlugin.ImageFileDirectory_v2()
        for tag, value in tags.items():
            info[int(tag[1:])] = value
        return pil_bytes(mode1, "TIFF", compression=compression,
                         tiffinfo=info)

    ccitt = dict(raises="CCITT")
    add("tiff_ccitt_g3_1d.tif", pil("group3"), writer="Pillow",
        coding="T.4 1-D", **ccitt)
    add("tiff_ccitt_g3_2d.tif", pil("group3", t292=1), writer="Pillow",
        coding="T.4 2-D", **ccitt)
    add("tiff_ccitt_g3_2d_fill_bits.tif", pil("group3", t292=5),
        writer="Pillow", coding="T.4 2-D, EOLs byte-aligned", **ccitt)
    add("tiff_ccitt_g3_fill_bits_lsb.tif", pil("group3", t292=4, t266=2),
        writer="Pillow", coding="T.4 1-D, EOLs byte-aligned, fill order 2",
        **ccitt)
    add("tiff_ccitt_g4_strips_lsb.tif", pil("group4", t278=7, t266=2),
        writer="Pillow", coding="T.6 in 5 strips, fill order 2", **ccitt)
    add("tiff_ccitt_rle.tif", pil("tiff_ccitt"), writer="Pillow",
        coding="modified Huffman, rows byte-aligned", **ccitt)
    add("tiff_ccitt_rlew_pillow.tif", pil("tiff_raw_16"), writer="Pillow",
        coding="modified Huffman, rows word-aligned",
        note="libtiff reads its rows with line length mismatches", **ccitt)
    bits1 = bitmap[..., None].astype(np.uint8)
    add("tiff_ccitt_g3_2d_min_is_white.tif", tiff_file(
        bits1, 0, compression=3, bits=1, rows_per_strip=7,
        fax=dict(t4=1)), coding="T.4 2-D (K = 2) in 5 strips", **ccitt)
    add("tiff_ccitt_g4_tiles.tif", tiff_file(
        bits1, 0, compression=4, bits=1, tile=(16, 16), fax={}),
        coding="T.6 in 16 x 16 tiles", **ccitt)
    add("tiff_ccitt_rlew_strips.tif", tiff_file(
        bits1, 1, compression=32771, bits=1, rows_per_strip=10, fax={}),
        coding="modified Huffman, rows word-aligned, 3 strips", **ccitt)
    add("tiff_ccitt_g3_without_eol.tif", tiff_file(
        bits1, 1, compression=3, bits=1, fax=dict(eol=False)),
        coding="T.4 1-D rows without EOLs",
        note="libtiff finds no EOL and reads the strip again without",
        **ccitt)
    # SGILog: OpenCV writes LogLuv from a float image (its XYZ); the rest
    # are words of the codec's own layout
    hdr = (textured(29, 37, 51).astype(np.float32) / 160) ** 1.6
    hdr[:, :5] *= 0
    for compression, name in ((34676, "32"), (34677, "24")):
        ok, enc = cv2.imencode(".tif", hdr[..., ::-1], [
            cv2.IMWRITE_TIFF_COMPRESSION, compression])
        assert ok
        add(f"tiff_logluv{name}_opencv.tif", enc.tobytes(),
            writer="cv2.imencode", coding=f"LogLuv{name}",
            raises="SGI LogLuv")
    l16 = (smooth(29, 37, 52)[..., 0].astype(np.int64) * 40 + 12000
           + g.integers(0, 40, (29, 37))).astype(np.uint16)
    l16[3, :9] |= 0x8000                    # negative luminance: black
    l16[5, 2:30] = 0x4000                   # runs
    add("tiff_logl16_sgilog.tif", tiff_file(
        l16[..., None], 32844, compression=34676, bits=16, sample_format=2,
        rows_per_strip=8, sgilog="l16"), coding="LogL16", raises="SGI LogLuv")
    le = smooth(29, 37, 53)[..., 0].astype(np.uint32) * 60 + 10000
    uv = g.integers(60, 180, (29, 37, 2)).astype(np.uint32)
    luv32 = le << 16 | uv[..., 0] << 8 | uv[..., 1]
    luv32[:, 20:28] = luv32[:, 20:21]       # runs in every plane
    add("tiff_logluv32_tiles.tif", tiff_file(
        np.repeat(luv32[..., None], 3, -1), 32845, compression=34676,
        bits=16, sample_format=2, tile=(16, 16), sgilog="luv32"),
        coding="LogLuv32 in 16 x 16 tiles", raises="SGI LogLuv")
    luv24 = (smooth(29, 37, 54)[..., 0].astype(np.uint32) + 500) << 14 | \
        g.integers(0, 1 << 14, (29, 37)).astype(np.uint32)
    add("tiff_logluv24_strips_lsb.tif", tiff_file(
        np.repeat(luv24[..., None], 3, -1), 32845, compression=34677,
        bits=16, sample_format=2, rows_per_strip=6, fillorder=2,
        sgilog="luv24"), coding="LogLuv24 in 5 strips, fill order 2",
        note="chroma codes past the grid read as the neutral point",
        raises="SGI LogLuv")
    # the decode-time fixtures of this slice
    n = 1024
    page = big(n)[..., 0] > 127
    page[::64] ^= True                                  # ruled lines
    page ^= np.random.default_rng(2021).random((n, n)) < 0.01
    add("tiff_1024_ccitt_g4.tif", pil_bytes(Image.fromarray(
        page.astype(np.uint8) * 255).convert("1"), "TIFF",
        compression="group4"), writer="Pillow", coding="T.6",
        large=True, raises="CCITT")
    blocky = (big(n)[:, ::16].repeat(16, 1).astype(np.float32) / 180) ** 2
    ok, enc = cv2.imencode(".tif", blocky[..., ::-1], [
        cv2.IMWRITE_TIFF_COMPRESSION, 34676])
    assert ok
    add("tiff_1024_logluv32.tif", enc.tobytes(), writer="cv2.imencode",
        coding="LogLuv32", large=True, raises="SGI LogLuv")


def tiff_page(path):
    """(bits, photometric, Decode ranges or None) of a TIFF's first page as
    imageio's tifffile reads them; None for another format."""
    from imageio.plugins import _tifffile
    if path is None or not str(path).lower().endswith(".tif"):
        return None
    with _tifffile.TiffFile(str(path)) as t:
        page = t.pages[0]
        tag = page.tags.get("Decode")
        decode = None if tag is None else [
            tag.value[i] / tag.value[i + 1] for i in range(0, 12, 2)]
        return page.bitspersample, int(page.photometric), decode


def unit(u, bits):
    """The stated rule of an integer sample: the value and 2^bits - 1
    rounded to float64, divided there, rounded to float32."""
    return (u.astype(np.float64) / float((1 << bits) - 1)).astype(np.float32)


def to_8bit(arr, bits):
    """Inks made 8-bit for the CMYK and YCbCr rules: 1, 2 and 4 bits
    scaled, wider unsigned samples their high byte, float ones clipped,
    times 255 and truncated."""
    if arr.dtype.kind == "f":
        return (np.clip(np.nan_to_num(arr.astype(np.float32)), 0, 1)
                * 255).astype(np.uint8)
    if bits < 8:
        return arr * np.uint8(255 // ((1 << bits) - 1))
    return (arr >> (8 * arr.dtype.itemsize - 8)).astype(np.uint8)


def expected(arr, rule=None, path=None):
    """imageio's array -> (the port's texture samples (H, W, 3), divisor,
    whether the JAX texture is the image's RGB). Without a rule, where
    imageio's array is 8-bit with 3 or more channels the JAX function's
    own ``/ 255`` then ``[..., :3]``; elsewhere grey is replicated, alpha
    dropped, a sample of d bits divided by 2^d - 1 (bool: 0 or 1). The
    rules of the cases that are not RGB images for the JAX function, one
    or several joined by ``+``, in order: ``planar`` (S, H, W) is read as
    (H, W, S); ``pages``: the first page; ``depth``: the first plane of a
    (D, H, W, S) volume, ``depth_planar`` of an (S, D, H, W) one;
    ``palette``: the indices through the file's colour map (as imageio's
    tifffile reads it; indices past it black), / 65535; ``cmyk``: the inks
    made 8-bit (``to_8bit``), then Pillow's ``convert("RGB")`` (of a TIFF's,
    a JPEG's or a PNM's CMYK); ``float``: clipped to [0, 1] (NaN as 0);
    ``complex``: the real part, then ``float``; ``miniswhite``: inverted
    (2^d - 1 - v, a signed sample's bits flipped, 1 - x); ``scale``: 1-,
    2- and 4-bit samples saturated at 2^d - 1 and scaled to 8 bits;
    ``signed``: offset by 2^(d-1), divided by 2^d - 1 (past 16 bits by
    ``unit``); ``wide``: 32- and 64-bit unsigned samples by ``unit``;
    ``ycbcr``: Pillow's open and ``convert("RGB")``, which is libtiff's
    ``TIFFYCbCrToRGB``; ``ycbcr16``: the same of the samples' high bytes;
    ``lab``: the Lab rule of the samples as their photometric encodes them.
    Without a rule an int32 array (Pillow's mode "I" of a PGM past 8 bits,
    0-65535) is divided by 65535. The divisor is 1 where the rule has
    already divided."""
    well = rule is None and arr.ndim == 3 and arr.shape[-1] >= 3 \
        and arr.dtype == np.uint8
    page = tiff_page(path)
    bits = page[0] if page and isinstance(page[0], int) else \
        8 * arr.dtype.itemsize
    divisor = None
    for r in (rule or "").split("+"):
        if r == "planar":
            arr = np.moveaxis(arr, 0, -1)
        elif r == "pages":
            arr = arr[0]
        elif r == "depth":
            arr = arr[0]
        elif r == "depth_planar":
            arr = np.moveaxis(arr[:, 0], 0, -1)
        elif r == "palette":
            from imageio.plugins import _tifffile
            with _tifffile.TiffFile(str(path)) as t:
                cmap = np.asarray(t.pages[0].colormap, np.uint16)
            lut = np.zeros((256 if bits <= 8 else 65536, 3), np.uint16)
            lut[:cmap.shape[1]] = cmap.T
            return np.ascontiguousarray(lut[arr]), 65535, False
        elif r == "cmyk":
            from PIL import Image
            ink = np.ascontiguousarray(to_8bit(arr, bits)[..., :4])
            return np.asarray(Image.fromarray(ink, "CMYK").convert(
                "RGB")), 255, False
        elif r in ("ycbcr", "ycbcr16"):
            from PIL import Image
            if r == "ycbcr16":
                path = io.BytesIO(tiff_file(    # LZW: libtiff's decoder
                    to_8bit(arr, bits), 6, compression=5,
                    extra_tags=((530, 3, [1, 1]),)))
            with Image.open(path) as im:
                return np.asarray(im.convert("RGB")), 255, False
        elif r == "lab":
            lab = lab_from_codes(arr, page[1], bits, page[2])
            return lab_rule(lab), 255, False
        elif r == "complex":
            arr = arr.real.astype(np.float32)
        elif r == "miniswhite":
            if arr.dtype == np.bool_ or arr.dtype.kind == "i":
                arr = ~arr
            elif arr.dtype.kind == "f":
                arr = np.float32(1) - arr.astype(np.float32)
            else:
                top = (1 << bits) - 1
                arr = arr.dtype.type(top) - arr
        elif r == "scale":
            top = (1 << bits) - 1
            arr = np.minimum(arr, np.uint8(top)) * np.uint8(255 // top)
        elif r == "signed":
            d = 8 * arr.dtype.itemsize
            u = arr.view(arr.dtype.str.replace("i", "u")) ^ arr.dtype.type(
                -1 << (d - 1)).view(arr.dtype.str.replace("i", "u"))
            arr = u if d <= 16 else unit(u, d)
        elif r == "wide":
            arr = unit(arr, 8 * arr.dtype.itemsize)
    if arr.dtype.kind == "f":
        arr = np.clip(np.nan_to_num(arr, nan=0.0), 0, 1).astype(np.float32)
        divisor = 1
    elif arr.dtype == np.bool_:
        arr, divisor = arr.astype(np.uint8), 1
    else:
        divisor = 65535 if arr.dtype in (np.uint16, np.int32) else 255
    if arr.ndim == 2:
        arr = arr[..., None]
    rgb = arr[..., :3] if arr.shape[-1] >= 3 else np.repeat(arr[..., :1], 3,
                                                           -1)
    return np.ascontiguousarray(rgb), divisor, well


# ------------------------------------------------- Radiance and Sun raster
def rgbe(rgb):
    """(H, W, 3) float -> (H, W, 4) RGBE bytes, as Walter's float2rgbe:
    the largest channel's frexp exponent shared, each mantissa truncated."""
    v = rgb.max(-1)
    m, e = np.frexp(v)
    scale = np.where(v < 1e-32, 0.0, m * 256.0 / np.where(v > 0, v, 1))
    out = np.zeros(rgb.shape[:2] + (4,), np.uint8)
    out[..., :3] = (rgb * scale[..., None]).astype(np.uint8)
    out[..., 3] = np.where(v < 1e-32, 0, e + 128)
    return out


def hdr_rle_line(line):
    """One scanline of RGBE pixels in the new run-length form (Walter's
    RGBE_WriteBytes_RLE per channel: runs of 4 or more as 128 + n, the
    rest as literals of at most 128)."""
    W = len(line)
    out = bytearray([2, 2, W >> 8, W & 255])
    for c in range(4):
        data = line[:, c].tobytes()
        cur = 0
        while cur < W:
            beg, run = cur, 0
            while run < 4 and beg < W:       # find the next run of 4+
                beg += run
                run = 1
                while beg + run < W and run < 127 and \
                        data[beg + run] == data[beg]:
                    run += 1
            while cur < beg:                 # literals before it
                n = min(128, beg - cur)
                out += bytes([n]) + data[cur:cur + n]
                cur += n
            if run >= 4:
                out += bytes([128 + run, data[beg]])
                cur += run
    return bytes(out)


def radiance_file(px, rle=True, head=None, size=None):
    """A Radiance HDR file of (H, W, 4) RGBE pixels: flat or new-style
    run-length scanlines, under ``head`` (the header lines) and ``size``
    (the resolution line)."""
    H, W = px.shape[:2]
    head = head or b"#?RADIANCE\n# made by hand\nFORMAT=32-bit_rle_rgbe\n"
    size = size or b"-Y %d +X %d\n" % (H, W)
    body = b"".join(hdr_rle_line(px[y]) for y in range(H)) if rle else \
        px.tobytes()
    return head + b"\n" + size + body


def sun_file(W, H, depth, rows, kind=1, cmap=b"", map_type=None):
    """A Sun raster file: the 32-byte header, the colour map, the rows
    (each padded to 16 bits unless run-length coded)."""
    map_type = (1 if cmap else 0) if map_type is None else map_type
    return struct.pack(">8I", 0x59A66A95, W, H, depth, len(rows), kind,
                       map_type, len(cmap)) + cmap + rows


def sun_rows(samples, depth):
    """(H, W[, C]) samples -> rows of ``depth`` bits a pixel, padded to 16
    bits."""
    H = samples.shape[0]
    if depth == 1 or depth == 4:
        bits = np.unpackbits(samples.astype(np.uint8)[..., None], axis=-1)[
            ..., 8 - depth:].reshape(H, -1)
        rows = np.packbits(bits, axis=1)
    else:
        rows = samples.reshape(H, -1)
    pad = (-rows.shape[1]) % 2
    return np.pad(rows, ((0, 0), (0, pad))).astype(np.uint8).tobytes()


def sun_rle(data):
    """Pillow's and the format's byte encoding: runs of 3 or more as 0x80
    n-1 v, a lone 0x80 as 0x80 0x00."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 256 and data[j] == data[i]:
            j += 1
        n = j - i
        if n >= 3 or data[i] == 0x80:
            out += bytes([0x80, n - 1, data[i]]) if n >= 2 or data[i] != \
                0x80 else bytes([0x80, 0])
        else:
            out += bytes(data[i:j])
        i = j
    return bytes(out)


# the names each route fixture is also read under: Pillow's (.ras, .png, an
# unknown one) and OpenCV's (.sr, .pbm, .hdr) routes
ROUTE_NAMES = (".ras", ".png", ".xyz", ".sr", ".pbm", ".hdr")


def route_cases():
    """(name, bytes, facts) of the Radiance HDR and Sun raster fixtures."""
    import cv2
    out = []

    def add(name, data, **facts):
        out.append((name, data, facts))

    rgb = textured(29, 37, 41).astype(np.float64) / 255
    rgb[3, 5] = 0                                 # E = 0
    rgb[:, :4] *= 1.7                             # past 1: saturated
    ok, enc = cv2.imencode(".hdr", rgb[..., ::-1].astype(np.float32))
    assert ok
    add("hdr_rle_opencv.hdr", enc.tobytes(), writer="cv2.imwrite",
        scanlines="new run-length")
    px = rgbe(rgb)
    px[7:9, 10:30] = px[7, 10]                    # runs in every channel
    add("hdr_rle_runs.hdr", radiance_file(px), scanlines="new run-length",
        note="runs and literals")
    add("hdr_header_lines.hdr", radiance_file(px, head=(
        b"#?RGBE\nEXPOSURE=2.5\nGAMMA=2.2\n# comment\n"
        b"FORMAT=32-bit_rle_rgbe\nPRIMARIES=0 0 0 0 0 0 0 0\n"),
        size=b"-Y 29   +X 37 \n"), note="header lines OpenCV skips")
    add("hdr_flat.hdr", radiance_file(px, rle=False), scanlines="flat")
    narrow = rgbe(textured(9, 6, 42).astype(np.float64) / 97)
    add("hdr_narrow_flat.hdr", radiance_file(narrow, rle=False),
        scanlines="flat (width below 8)")
    add("hdr_rle_then_flat.hdr", b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
        b"-Y 29 +X 37\n" + hdr_rle_line(px[0]) + hdr_rle_line(px[1])
        + px[2:].tobytes(),
        scanlines="run-length, then flat from the third scanline")
    old = radiance_file(px, rle=False)
    old = old[:old.index(b"+X 37\n") + 6] + px[0, 0].tobytes() + \
        bytes([1, 1, 1, 200]) + px.tobytes()[8:]
    add("hdr_old_rle.hdr", old, scanlines="old run-length form",
        note="OpenCV reads its repeat marker as a flat pixel")
    add("hdr_old_rle_short.hdr", old[:-800], raises="RGBE read error",
        note="old run-length form read flat: the data ends early")
    add("hdr_xyze.hdr", radiance_file(px, head=(
        b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n")),
        raises="missing FORMAT specifier")
    add("hdr_plus_y.hdr", radiance_file(px, size=b"+Y 29 +X 37\n"),
        raises="missing image size specifier")
    add("hdr_truncated.hdr", radiance_file(px)[:-100],
        raises="RGBE read error")
    add("hdr_bad_run.hdr", radiance_file(px).replace(
        bytes([2, 2, 0, 37]), bytes([2, 2, 0, 36]), 1),
        raises="wrong scanline width")
    n = 1024
    blocky = big(n)[:, ::16].repeat(16, 1).astype(np.float64) / 200
    add("hdr_1024_rle.hdr", radiance_file(rgbe(blocky)), large=True,
        scanlines="new run-length", note="runs of 16")
    # Sun raster
    img = textured(29, 37, 43)
    grey = img[..., 1]
    add("sun_24bit_bgr.ras", sun_file(37, 29, 24, sun_rows(img[..., ::-1],
                                                           24)), depth=24)
    add("sun_24bit_rgb_type3.ras", sun_file(37, 29, 24, sun_rows(img, 24),
                                            kind=3), depth=24,
        note="OpenCV refuses type 3")
    xbgr = np.concatenate([np.full((29, 37, 1), 7, np.uint8),
                           img[..., ::-1]], -1)
    add("sun_32bit.ras", sun_file(37, 29, 32, sun_rows(xbgr, 32)), depth=32,
        note="Pillow reads BGRX, OpenCV XBGR")
    add("sun_8bit_grey.ras", sun_file(37, 29, 8, sun_rows(grey, 8)),
        depth=8)
    cmap = np.stack([np.arange(200) * 7 % 256, np.arange(200) * 3 % 256,
                     255 - np.arange(200)]).astype(np.uint8).tobytes()
    add("sun_8bit_cmap.ras", sun_file(37, 29, 8, sun_rows(grey, 8),
                                      cmap=cmap), depth=8,
        note="200 colours: the higher indices black")
    bitmap = (grey > 128).astype(np.uint8)
    add("sun_1bit.ras", sun_file(37, 29, 1, sun_rows(bitmap, 1)), depth=1)
    add("sun_4bit.ras", sun_file(37, 29, 4, sun_rows(grey >> 4, 4)),
        depth=4, note="Pillow alone")
    add("sun_rle_8bit.ras", sun_file(37, 29, 8, sun_rle(
        np.repeat(grey[:, ::4], 4, 1)[:, :37].tobytes()), kind=2), depth=8,
        note="run-length: Pillow alone")
    add("sun_truncated.ras", sun_file(37, 29, 24, sun_rows(
        img[..., ::-1], 24)[:-300]), raises="Sun raster")
    return out


def route_reads(data, names):
    """What imageio gives for ``data`` under each suffix of ``names``: the
    plugin OpenCV's check leaves it to and imageio's array (shape, type,
    SHA-256) or its refusal."""
    import tempfile

    import cv2
    import imageio.v2 as imageio
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for ext in names:
            path = Path(tmp) / ("texture" + ext)
            path.write_bytes(data)
            read = {"opencv_reads": bool(cv2.haveImageReader(str(path)))}
            try:
                arr = np.asarray(imageio.imread(path))
            except Exception as e:
                read["raises"] = f"{type(e).__name__}: {e}".replace(
                    f"{tmp}/", "")
            else:
                read.update(shape=list(arr.shape), dtype=str(arr.dtype),
                            sha256=hashlib.sha256(arr.tobytes()).hexdigest())
            out[ext] = read
    return out


def versions() -> dict:
    import cv2
    import imageio
    import PIL
    from PIL import features
    return {"imageio": imageio.__version__, "Pillow": PIL.__version__,
            "libwebp": features.version("webp"),
            "libjpeg-turbo": features.version("libjpeg_turbo"),
            "libtiff": features.version("libtiff"),
            "zlib": features.version("zlib"),
            "openjpeg": features.version("jpg_2000"),
            # imageio reads .pbm and .pfm through OpenCV where it is present
            "opencv": cv2.__version__}


def main() -> int:
    import imageio.v2 as imageio
    manifest, arrays = [], {}
    for name, data, facts in cases():
        (HERE / name).write_bytes(data)
        if name.endswith(".png"):   # the facts as the header states them
            assert (facts["depth"], facts["ctype"]) == (data[24], data[25]), \
                (name, data[24], data[25])
        entry = dict(file=name, facts=facts,
                     opencv_route=route_reads(data, (".pbm", ".hdr")))
        if "raises" in facts:
            entry["raises"] = facts.pop("raises")
            try:
                imageio.imread(HERE / name)
            except Exception as e:     # what imageio's refusal says
                entry["imageio_refuses"] = f"{type(e).__name__}: {e}" \
                    .replace(f"{HERE}/", "")     # the message, not the path
            else:
                raise AssertionError(f"imageio reads {name}, which the "
                                     "port must refuse")
            manifest.append(entry)
            continue
        arr = np.asarray(imageio.imread(HERE / name))
        rgb, divisor, well = expected(arr, facts.get("rule"), HERE / name)
        entry.update(imageio_shape=list(arr.shape),
                     imageio_dtype=str(arr.dtype), jax_well_formed=well,
                     shape=list(rgb.shape), divisor=divisor,
                     imageio_sha256=hashlib.sha256(arr.tobytes()).hexdigest())
        if facts.pop("large", False):    # the port's samples, whole
            entry["sha256"] = hashlib.sha256(
                (rgb if facts.get("rule") else arr).tobytes()).hexdigest()
        else:
            entry["key"] = name.replace(".", "_")
            arrays[entry["key"]] = rgb
        manifest.append(entry)
    route = []
    for name, data, facts in route_cases():
        (HERE / name).write_bytes(data)
        entry = dict(file=name, facts=facts,
                     reads=route_reads(data, (name[name.rindex("."):],)
                                       + ROUTE_NAMES))
        if "raises" in facts:
            entry["raises"] = facts.pop("raises")
        if facts.pop("large", False):
            entry["large"] = True
        route.append(entry)
    np.savez_compressed(HERE / "expected.npz", **arrays)
    (HERE / "MANIFEST.json").write_text(json.dumps(
        {"generator": dict(script="tests/torch_textures/make_textures.py",
                           **versions()),
         "files": manifest, "route_files": route}, indent=1) + "\n")
    total = sum(p.stat().st_size for p in HERE.iterdir() if p.is_file())
    print(f"{len(manifest)} fixtures, {total} bytes", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
