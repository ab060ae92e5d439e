"""The byte-level decoders of the port's texture readers, each against the
code the JAX package's imageio reads the same bytes with: GIF's LZW
(``native.gif_unlzw``) against Pillow, TIFF's LZW and PackBits
(``native.tiff_unlzw``, ``native.packbits``) against the bundled
tifffile's ``decode_lzw`` and ``decode_packbits``, the BMP run-length
expansion (``native.bmp_unrle``) against Pillow's ``BmpRleDecoder``, and the
WebP decoder (``native.webp_decode``) against Pillow's libwebp on
generated images. Well-formed streams decode to the same bytes; random
streams decode to the same bytes wherever the reference reads them, and
raise ``ValueError`` (never crash) elsewhere.
"""
from __future__ import annotations

import importlib.util
import io
import struct
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from imageio.plugins import _tifffile
from PIL import Image

from neural_marionette_tpu_torch.data import native
from neural_marionette_tpu_torch.viz import image_files as F

TEX = Path(__file__).resolve().parent / "torch_textures"
_spec = importlib.util.spec_from_file_location("make_textures",
                                               TEX / "make_textures.py")
MAKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(MAKE)

SETTINGS = dict(deadline=None, database=None,
                suppress_health_check=[HealthCheck.too_slow])


def _data(kind: str, n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, n).astype(np.uint8).tobytes()
    if kind == "runs":
        return np.repeat(rng.integers(0, 4, n // 7 + 1), 7)[:n].astype(
            np.uint8).tobytes()
    return (np.arange(n) % 251).astype(np.uint8).tobytes()


@pytest.mark.parametrize("kind", ["noise", "runs", "ramp"])
@pytest.mark.parametrize("n", [1, 300, 70000])
def test_lzw_and_packbits_round_trip(kind, n):
    """Streams of two independent encoders (the generator's and, for GIF,
    the port's own) decode to their input; tifffile agrees on TIFF's."""
    data = _data(kind, n, n)
    idx = np.frombuffer(data, np.uint8)
    for stream in (MAKE.lzw_gif(idx, 8), native.gif_lzw(idx, 8)):
        assert native.gif_unlzw(stream, 8, n).tobytes() == data
    small = (idx % 4).astype(np.uint8)
    assert np.array_equal(native.gif_unlzw(MAKE.lzw_gif(small, 2), 2, n),
                          small)
    tiff = MAKE.lzw_tiff(data)
    assert native.tiff_unlzw(tiff, n).tobytes() == data
    assert _tifffile.decode_lzw(tiff) == data
    pack = MAKE.packbits(data)
    assert native.packbits(pack, n).tobytes() == data
    assert _tifffile.decode_packbits(pack) == data


def test_lzw_truncated_and_bad_codes_raise():
    """A GIF stream cut short or naming a code not yet in the table, and a
    TIFF strip that does not start with a clear code, raise."""
    idx = np.frombuffer(_data("noise", 500, 1), np.uint8)
    stream = MAKE.lzw_gif(idx, 8)
    with pytest.raises(ValueError, match="truncated"):
        native.gif_unlzw(stream[:len(stream) // 2], 8, 500)
    with pytest.raises(ValueError, match="bad LZW code"):
        native.gif_unlzw(b"\x00\x01\xff\xff\xff", 8, 500)
    with pytest.raises(ValueError, match="old-style"):
        native.tiff_unlzw(b"\x00\x00\x00\x00\x00", 10)


@settings(max_examples=300, **SETTINGS)
@given(body=st.binary(min_size=0, max_size=400), cap=st.integers(0, 3000))
def test_packbits_matches_tifffile_on_any_bytes(body, cap):
    """PackBits reads every byte string: the port's bytes are tifffile's,
    cut at the strip's size."""
    assert native.packbits(body, cap).tobytes() == \
        _tifffile.decode_packbits(body)[:cap]


@settings(max_examples=300, **SETTINGS)
@given(body=st.binary(min_size=0, max_size=300))
def test_tiff_lzw_matches_tifffile_on_any_bytes(body):
    """Random TIFF LZW strips (after a clear code): where tifffile decodes
    one, the port gives its bytes; where tifffile raises, so does the
    port."""
    stream = b"\x80" + body + b"\x00\x00\x00"
    try:
        want = _tifffile.decode_lzw(stream)
    except (ValueError, IndexError, TypeError):
        want = None
    if want is None:
        with pytest.raises(ValueError):
            native.tiff_unlzw(stream, 1 << 16)
        return
    got = native.tiff_unlzw(stream, max(len(want), 1))
    assert got.tobytes() == want[:max(len(want), 1)]


def _gif_file(stream: bytes, w: int, h: int, mcs: int) -> bytes:
    """A one-frame GIF with a 256-entry table around a raw code stream."""
    table = np.arange(768, dtype=np.uint32) * 7 % 256
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0))
    out += table.astype(np.uint8).tobytes()
    out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0) + bytes([mcs])
    for s in range(0, len(stream), 255):
        out += bytes([len(stream[s:s + 255])]) + stream[s:s + 255]
    return bytes(out + b"\x00\x3b")


@settings(max_examples=200, **SETTINGS)
@given(body=st.binary(min_size=1, max_size=120), mcs=st.integers(2, 8),
       w=st.integers(1, 12), h=st.integers(1, 12))
def test_gif_lzw_matches_pillow_on_any_bytes(body, mcs, w, h):
    """Random GIF code streams (after a clear code): where imageio reads
    the frame, the port reads the same pixels; elsewhere it raises."""
    stream = bytes([1 << mcs & 255, (1 << mcs) >> 8]) + body
    data = _gif_file(stream, w, h, mcs)
    try:
        want = np.asarray(imageio.imread(io.BytesIO(data), format="GIF"))
    except Exception:    # Pillow refuses it (OSError, ValueError, ...)
        want = None
    if want is None:
        with pytest.raises(ValueError):
            F.decode_image(data, "x.gif")
        return
    assert np.array_equal(F.decode_image(data, "x.gif"), want)


def _bmp_rle(body: bytes, w: int, h: int, rle4: bool) -> bytes:
    pal = np.stack([np.arange(256) * 3 % 256, np.arange(256) * 5 % 256,
                    np.arange(256)], -1).astype(np.uint8)[:16 if rle4 else 256]
    return MAKE.bmp_file(body, w, h, 4 if rle4 else 8, 2 if rle4 else 1, pal)


@settings(max_examples=300, **SETTINGS)
@given(body=st.binary(min_size=0, max_size=200), w=st.integers(1, 9),
       h=st.integers(1, 9), rle4=st.booleans())
def test_bmp_rle_matches_pillow_on_any_bytes(body, w, h, rle4):
    """Random BI_RLE8 / BI_RLE4 pixel data: where imageio reads the BMP
    (Pillow's decoder, with its reading of deltas and absolute runs), the
    port reads the same pixels; elsewhere it raises."""
    data = _bmp_rle(body, w, h, rle4)
    try:
        want = np.asarray(imageio.imread(io.BytesIO(data), format="BMP"))
    except Exception:
        want = None
    if want is None:
        with pytest.raises(ValueError):
            F.decode_image(data, "x.bmp")
        return
    assert np.array_equal(F.decode_image(data, "x.bmp"), want)


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (17, 16), (33, 50)])
@pytest.mark.parametrize("mode", ["lossless", "lossy", "lossy_alpha"])
def test_webp_matches_libwebp_at_edge_sizes(size, mode):
    """Lossless and lossy WebP (with alpha: VP8X + ALPH) of noise at sizes
    that cut macroblocks and chroma samples: the port's pixels are
    Pillow's libwebp's."""
    h, w = size
    rng = np.random.default_rng(h * 100 + w)
    img = MAKE.smooth(h, w, 3)
    img[::3] = rng.integers(0, 256, img[::3].shape)
    if mode == "lossy_alpha":
        img = np.concatenate([img, rng.integers(0, 256, (h, w, 1),
                                                dtype=np.uint8)], -1)
    data = MAKE.pil_bytes(img, "WEBP", **(dict(lossless=True)
                                          if mode == "lossless"
                                          else dict(quality=60)))
    want = np.asarray(imageio.imread(io.BytesIO(data)))
    assert np.array_equal(native.webp_decode(data), want)


@pytest.mark.parametrize("quality", [0, 30, 100])
@pytest.mark.parametrize("options", [
    dict(filter_type=0, filter_strength=100, filter_sharpness=7),
    dict(filter_type=1, filter_strength=100, filter_sharpness=3,
         partitions=2, segments=2),
    dict(method=0, sns_strength=100, segments=4, partitions=1)])
def test_webp_lossy_options_match_libwebp(quality, options):
    """Lossy WebP written by libwebp with options Pillow does not pass on
    (the simple and normal filters at each end of their strength and
    sharpness, 2 to 4 token partitions, 2 and 4 segments): the port's
    pixels are libwebp's."""
    img = MAKE.textured(40, 56, 9)
    data = MAKE.libwebp_encode(img, quality, **options)
    want = np.asarray(imageio.imread(io.BytesIO(data)))
    assert np.array_equal(native.webp_decode(data), want)


def test_webp_lossless_transform_combinations():
    """Lossless WebP of images that drive each VP8L path: the colour
    indexing of 2 to 256 colours (pixels bundled by 8, 4 and 2), the
    colour cache and the predictor and cross-colour images of a photo-like
    image at methods 0 and 6, and an image of one colour (codes of one
    symbol)."""
    rgb = MAKE.textured(37, 45, 5)
    images = [np.zeros((9, 11, 3), np.uint8) + 77]
    for colors in (2, 3, 5, 17, 256):
        images.append(np.asarray(Image.fromarray(rgb).quantize(
            colors=colors, dither=0).convert("RGB")))
    for img in images + [rgb]:
        for method in (0, 6):
            data = MAKE.pil_bytes(img, "WEBP", lossless=True, method=method)
            want = np.asarray(imageio.imread(io.BytesIO(data)))
            assert np.array_equal(native.webp_decode(data), want)
