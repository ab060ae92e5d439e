"""Write the texture fixtures of ``tests/test_torch_textures.py`` and their
manifest.

    python tests/torch_textures/make_textures.py

Needs Pillow and imageio (the card's machine has neither): the images are
written with Pillow, or by the small PNG, BMP and TGA writers below where
Pillow cannot write the case (16-bit colour, 2- and 4-bit grey and Adam7
PNGs, a top-down or 4-bit BMP), or patched from a Pillow file (a JPEG's
quantization table, sampling factors or frame marker). Each file is then
read back with ``imageio.v2.imread``, as the JAX package's
``apps/retarget._find_texture`` reads it, and ``MANIFEST.json`` records
per file its format facts and the expected texture: where imageio's array
is an RGB image (8-bit samples, 3 or 4 channels) the JAX function's own
``/ 255`` then ``[..., :3]``; elsewhere the port's defined result (grey
replicated to RGB, alpha dropped, a sample of d bits divided by 2^d - 1).
The expected textures of the small files are ``expected.npz`` (the
samples, divided by the manifest's ``divisor``); those of the two 1024 x
1024 JPEGs a SHA-256 of imageio's uint8 pixels. Files the port must refuse
carry the word its ``ValueError`` names instead. Deterministic: a second
run writes the same bytes.
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

    # formats the port refuses
    add("other.gif", pil_bytes(rgb, "GIF"), raises="GIF")
    add("other.tif", pil_bytes(rgb, "TIFF"), raises="TIFF")
    add("other.webp", pil_bytes(rgb, "WEBP", lossless=True), raises="WebP")
    return out


def expected(arr):
    """imageio's array -> (samples (H, W, 3), divisor, JAX well formed)."""
    well = arr.ndim == 3 and arr.shape[-1] in (3, 4) and arr.dtype == np.uint8
    if arr.dtype == np.bool_:
        arr, divisor = arr.astype(np.uint8), 1
    else:
        divisor = 65535 if arr.dtype == np.uint16 else 255
    if arr.ndim == 2:
        arr = arr[..., None]
    rgb = arr[..., :3] if arr.shape[-1] >= 3 else np.repeat(arr[..., :1], 3,
                                                           -1)
    return np.ascontiguousarray(rgb), divisor, well


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
        rgb, divisor, well = expected(arr)
        entry.update(imageio_shape=list(arr.shape),
                     imageio_dtype=str(arr.dtype), jax_well_formed=well,
                     shape=list(rgb.shape), divisor=divisor)
        if facts.pop("large", False):
            entry["sha256"] = hashlib.sha256(arr.tobytes()).hexdigest()
        else:
            entry["key"] = name.replace(".", "_")
            arrays[entry["key"]] = rgb
        manifest.append(entry)
    np.savez_compressed(HERE / "expected.npz", **arrays)
    (HERE / "MANIFEST.json").write_text(json.dumps(
        {"generator": "tests/torch_textures/make_textures.py",
         "files": manifest}, indent=1) + "\n")
    total = sum(p.stat().st_size for p in HERE.iterdir() if p.is_file())
    print(f"{len(manifest)} fixtures, {total} bytes", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
