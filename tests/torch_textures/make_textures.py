"""Write the texture fixtures of ``tests/test_torch_textures.py`` and their
manifest.

    python tests/torch_textures/make_textures.py

Needs Pillow and imageio (the card's machine has neither): the images are
written with Pillow, or by the small writers below where Pillow cannot
write the case (16-bit colour, 2- and 4-bit grey and Adam7 PNGs; top-down,
4-bit, run-length and bitfield BMPs; 16-bit TGAs; GIF frames with local
tables, offsets, interlace and transparency; TIFFs in both byte orders and
BigTIFF, with tiles, planar samples, predictors, fill order 2 and every
compression imageio's tifffile reads; WebP containers with ALPH chunks and
offset animation frames), by Pillow's own libwebp through ctypes for the
lossy WebP options Pillow does not pass on (filter type and sharpness,
token partitions, segments), or patched from a Pillow file (a JPEG's
quantization table, sampling factors or frame marker). Each file is then
read back with ``imageio.v2.imread``, as the JAX package's
``apps/retarget._find_texture`` reads it, and ``MANIFEST.json`` records
per file its format facts and the expected texture: where imageio's array
is an RGB image (8-bit samples, 3 or 4 channels) the JAX function's own
``/ 255`` then ``[..., :3]``; elsewhere the port's defined result (grey
replicated to RGB, alpha dropped, a sample of d bits divided by 2^d - 1).
The expected textures of the small files are ``expected.npz`` (the
samples, divided by the manifest's ``divisor``); those of the 1024 x 1024
files (JPEG baseline and progressive, GIF, TIFF LZW, WebP lossless and
lossy) a SHA-256 of imageio's uint8 pixels. Every file imageio reads also
records the SHA-256 of imageio's array (``imageio_sha256``), and the
manifest records the versions of the tools that made it. Files the port
must refuse carry the word its ``ValueError`` names instead.
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


TIFF_COMPRESS = {1: lambda b: b, 5: lzw_tiff, 8: lambda b: zlib.compress(b, 9),
                 32773: packbits, 34925: lambda b: __import__("lzma").compress(
                     b, format=__import__("lzma").FORMAT_XZ)}


def tiff_file(samples, photometric, order="<", big=False, compression=1,
              planar=1, predictor=1, rows_per_strip=None, tile=None,
              colormap=None, bits=None, sample_format=1, extra=(),
              fillorder=1, extra_tags=()):
    """A TIFF of (H, W, S) samples: classic or BigTIFF, either byte order,
    strips or tiles, either planar configuration, predictor 1, 2 or 3, a
    colour map, samples of 1, 2 or 4 bits (``bits``, packed per row)."""
    H, W, S = samples.shape
    dt = samples.dtype
    bits = bits or dt.itemsize * 8
    item = dt.itemsize

    def encode_block(block):          # (h, w, c) -> bytes
        h, w, c = block.shape
        if predictor == 2:
            d = block.astype(dt)
            d[:, 1:] = block[:, 1:] - block[:, :-1]
            block = d
        if predictor == 3:
            raw = np.ascontiguousarray(block).astype("<" + dt.str[1:])
            by = raw.view(np.uint8).reshape(h, w, c, item)[..., ::-1]
            by = by.transpose(0, 3, 1, 2).reshape(h, item * w * c)
            diff = by.copy()
            diff[:, c:] = by[:, c:] - by[:, :-c]
            raw = diff.tobytes()
        elif bits < 8:
            v = block.reshape(h, w * c).astype(np.uint8)
            b = (v[..., None] >> np.arange(bits - 1, -1, -1)) & 1
            raw = np.packbits(b.reshape(h, w * c * bits).astype(np.uint8),
                              axis=1).tobytes()
        else:
            raw = np.ascontiguousarray(block).astype(
                order + dt.str[1:]).tobytes()
        raw = TIFF_COMPRESS[compression](raw)
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
    tags = [(256, 4, [W]), (257, 4, [H]), (258, 3, [bits] * S),
            (259, 3, [compression]), (262, 3, [photometric]),
            (277, 3, [S]), (284, 3, [planar])]
    if fillorder != 1:
        tags.append((266, 3, [fillorder]))
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if sample_format != 1:
        tags.append((339, 3, [sample_format] * S))
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
    fmt = {3: "H", 4: "I", 16: "Q"}
    ifd_at = first + len(data)
    entry, inline = (20, 8) if big else (12, 4)
    ifd_size = (8 if big else 2) + entry * len(tags) + (8 if big else 4)
    spill = bytearray()
    ifd = bytearray(struct.pack(order + ("Q" if big else "H"), len(tags)))
    for code, kind, values in tags:
        body = struct.pack(order + fmt[kind] * len(values), *values)
        head = struct.pack(order + "HH" + ("Q" if big else "I"), code, kind,
                           len(values))
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
    add("jpeg_cmyk.jpg",
        pil_bytes(Image.fromarray(rgb).convert("CMYK"), "JPEG", quality=90),
        raises="CMYK")
    add("jpeg_arithmetic_sof9.jpg", patch_jpeg(base, set_marker(0xC0, 0xC9)),
        raises="arithmetic", note="frame marker patched to SOF9")
    add("jpeg_lossless_sof3.jpg", patch_jpeg(base, set_marker(0xC0, 0xC3)),
        raises="lossless", note="frame marker patched to SOF3")
    add("jpeg_hierarchical_sof5.jpg",
        patch_jpeg(base, set_marker(0xC0, 0xC5)),
        raises="hierarchical", note="frame marker patched to SOF5")
    add("jpeg_12bit.jpg", patch_jpeg(base, set_byte(0xC0, 0, 12)),
        raises="12-bit", note="precision patched to 12")
    add("jpeg_h4v1.jpg", patch_jpeg(base, set_byte(0xC0, 7, 0x41)),
        raises="sampling factors", note="luma sampling patched to 4x1")

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
    return out


def expected(arr, rule=None, path=None):
    """imageio's array -> (the port's texture samples (H, W, 3), divisor,
    whether the JAX texture is the image's RGB). Without a rule, where
    imageio's array is 8-bit RGB(A) the JAX function's own ``/ 255`` then
    ``[..., :3]``; elsewhere grey is replicated, alpha dropped, a sample of
    d bits divided by 2^d - 1 (bool: 0 or 1). The rules of the TIFF cases
    that are not RGB images for the JAX function: ``planar`` (S, H, W) is
    read as (H, W, S); ``pages``: the first page; ``palette``: the indices
    through the file's colour map (as imageio's tifffile reads it), / 65535;
    ``cmyk``: Pillow's ``convert("RGB")``; ``float``: clipped to [0, 1]
    (NaN as 0);
    ``miniswhite``: inverted; ``scale``: 4-bit samples scaled to 8 bits."""
    well = rule is None and arr.ndim == 3 and arr.shape[-1] in (3, 4) \
        and arr.dtype == np.uint8
    if rule == "planar":
        arr = np.moveaxis(arr, 0, -1)
    elif rule == "pages":
        arr = arr[0]
    elif rule == "palette":
        from imageio.plugins import _tifffile
        with _tifffile.TiffFile(str(path)) as t:
            cmap = np.asarray(t.pages[0].colormap, np.uint16)
        return np.ascontiguousarray(cmap.T[arr]), 65535, False
    elif rule == "cmyk":
        from PIL import Image
        rgb = np.asarray(Image.fromarray(arr, "CMYK").convert("RGB"))
        return rgb, 255, False
    elif rule == "float":
        arr = np.clip(np.nan_to_num(arr, nan=0.0), 0, 1).astype(np.float32)
        arr = arr if arr.ndim == 3 else arr[..., None]
        rgb = arr[..., :3] if arr.shape[-1] >= 3 else np.repeat(arr[..., :1],
                                                                3, -1)
        return np.ascontiguousarray(rgb), 1, False
    elif rule == "miniswhite":
        arr = ~arr if arr.dtype == np.bool_ else 255 - arr
    elif rule == "scale":
        arr = arr * np.uint8(17)
    if arr.dtype == np.bool_:
        arr, divisor = arr.astype(np.uint8), 1
    else:
        divisor = 65535 if arr.dtype == np.uint16 else 255
    if arr.ndim == 2:
        arr = arr[..., None]
    rgb = arr[..., :3] if arr.shape[-1] >= 3 else np.repeat(arr[..., :1], 3,
                                                           -1)
    return np.ascontiguousarray(rgb), divisor, well


def versions() -> dict:
    import imageio
    import PIL
    from PIL import features
    return {"imageio": imageio.__version__, "Pillow": PIL.__version__,
            "libwebp": features.version("webp"),
            "libjpeg-turbo": features.version("libjpeg_turbo"),
            "zlib": features.version("zlib")}


def main() -> int:
    import imageio.v2 as imageio
    manifest, arrays = [], {}
    for name, data, facts in cases():
        (HERE / name).write_bytes(data)
        if name.endswith(".png"):   # the facts as the header states them
            assert (facts["depth"], facts["ctype"]) == (data[24], data[25]), \
                (name, data[24], data[25])
        entry = dict(file=name, facts=facts)
        if "raises" in facts:
            entry["raises"] = facts.pop("raises")
            manifest.append(entry)
            continue
        arr = np.asarray(imageio.imread(HERE / name))
        rgb, divisor, well = expected(arr, facts.get("rule"), HERE / name)
        entry.update(imageio_shape=list(arr.shape),
                     imageio_dtype=str(arr.dtype), jax_well_formed=well,
                     shape=list(rgb.shape), divisor=divisor,
                     imageio_sha256=hashlib.sha256(arr.tobytes()).hexdigest())
        if facts.pop("large", False):
            entry["sha256"] = entry["imageio_sha256"]
        else:
            entry["key"] = name.replace(".", "_")
            arrays[entry["key"]] = rgb
        manifest.append(entry)
    np.savez_compressed(HERE / "expected.npz", **arrays)
    (HERE / "MANIFEST.json").write_text(json.dumps(
        {"generator": dict(script="tests/torch_textures/make_textures.py",
                           **versions()),
         "files": manifest}, indent=1) + "\n")
    total = sum(p.stat().st_size for p in HERE.iterdir() if p.is_file())
    print(f"{len(manifest)} fixtures, {total} bytes", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
