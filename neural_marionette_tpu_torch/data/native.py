"""ctypes binding of the port's host libraries: ``csrc/nm_host.cpp`` (the
data layer's loops, the GIF and PNG coders of ``viz/image_files.py``, its
JPEG decoder, and the LZW, PackBits and run-length expansions of its GIF,
TIFF, BMP and TGA readers) and ``csrc/nm_webp.cpp`` (its WebP decoder).

Counterpart of ``neural_marionette_tpu/data/native.py``. The library is
built by ``kernels.py`` with ``g++`` into ``_build/`` at first use. Where
the JAX binding falls back to NumPy when the build fails, this one raises:
a failed build is a fault to see, not a slower path. The NumPy functions
named in each docstring are the plain versions the tests hold it against.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from .. import kernels

_lib: Optional[ctypes.CDLL] = None
_webp: Optional[ctypes.CDLL] = None
_lock = threading.Lock()   # the loader's threads may ask for it at once


def library() -> ctypes.CDLL:
    """The loaded library with its signatures; built on first use, raises
    if it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            lib = kernels.library("nm_host")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i64 = ctypes.c_int64
            lib.nm_voxelize_batch.argtypes = [f32p, i64, i64, ctypes.c_int,
                                              f32p]
            lib.nm_voxelize_batch.restype = None
            lib.nm_normalize_episodic.argtypes = [
                f32p, i64, i64, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_void_p, i64]
            lib.nm_normalize_episodic.restype = None
            lib.nm_crop_strided.argtypes = [f32p, f32p, i64, i64, i64, i64]
            lib.nm_crop_strided.restype = None
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.nm_gif_lzw.argtypes = [u8p, i64, ctypes.c_int, u8p, i64]
            lib.nm_gif_lzw.restype = i64
            lib.nm_png_unfilter.argtypes = [u8p, i64, i64, ctypes.c_int,
                                            u8p]
            lib.nm_png_unfilter.restype = i64
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.nm_tga_unrle.argtypes = [u8p, i64, i64, ctypes.c_int, u8p]
            lib.nm_tga_unrle.restype = i64
            lib.nm_gif_unlzw.argtypes = [u8p, i64, ctypes.c_int, u8p, i64]
            lib.nm_gif_unlzw.restype = i64
            lib.nm_tiff_unlzw.argtypes = [u8p, i64, u8p, i64]
            lib.nm_tiff_unlzw.restype = i64
            lib.nm_packbits.argtypes = [u8p, i64, u8p, i64]
            lib.nm_packbits.restype = i64
            lib.nm_bmp_unrle.argtypes = [u8p, i64, i64, i64, i64,
                                         ctypes.c_int, u8p]
            lib.nm_bmp_unrle.restype = i64
            lib.nm_jpeg_info.argtypes = [u8p, i64, i32p, ctypes.c_char_p,
                                         i64]
            lib.nm_jpeg_info.restype = ctypes.c_int
            lib.nm_jpeg_decode.argtypes = [u8p, i64, u8p, i64,
                                           ctypes.c_char_p, i64]
            lib.nm_jpeg_decode.restype = ctypes.c_int
            lib.nm_version.argtypes = []
            lib.nm_version.restype = ctypes.c_int
            _lib = lib
    return _lib


def webp_library() -> ctypes.CDLL:
    """The loaded WebP decoder (``csrc/nm_webp.cpp``); built on first use,
    raises if it cannot be built."""
    global _webp
    with _lock:
        if _webp is None:
            lib = kernels.library("nm_webp")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            i64 = ctypes.c_int64
            lib.nm_webp_info.argtypes = [u8p, i64, i32p, ctypes.c_char_p, i64]
            lib.nm_webp_info.restype = ctypes.c_int
            lib.nm_webp_decode.argtypes = [u8p, i64, u8p, i64,
                                           ctypes.c_char_p, i64]
            lib.nm_webp_decode.restype = ctypes.c_int
            _webp = lib
    return _webp


def _frames(points: np.ndarray) -> np.ndarray:
    pts = np.ascontiguousarray(points, dtype=np.float32)
    if pts.ndim != 3 or pts.shape[-1] != 3:
        raise ValueError(f"expected (F, N, 3) points, got {pts.shape}")
    return pts


def voxelize_batch(points: np.ndarray, grid_size: int) -> np.ndarray:
    """(F, N, 3) float32 -> (F, G, G, G, 1) float32 occupancy, one thread
    per frame. Plain version: ``ops.voxelize.voxelize_np`` per frame (the
    index clamp: an out-of-range point marks the border voxel)."""
    if grid_size < 1:
        raise ValueError(f"grid_size must be positive, got {grid_size}")
    pts = _frames(points)
    F, N, _ = pts.shape
    out = np.empty((F, grid_size ** 3), dtype=np.float32)
    library().nm_voxelize_batch(pts, F, N, grid_size, out)
    return out.reshape(F, grid_size, grid_size, grid_size, 1)


def normalize_episodic(seq: np.ndarray, scale: float = 1.0,
                       x_trans: float = 0.0, z_trans: float = 0.0,
                       joints: Optional[np.ndarray] = None):
    """``data.pipeline.episodic_normalization`` in float32 (the plain
    version computes in float64): a normalized copy of ``seq`` (T, N, 3),
    and of ``joints`` (T, K, 3) when given."""
    out = _frames(seq).copy()
    T, N, _ = out.shape
    lib = library()
    if joints is None:
        lib.nm_normalize_episodic(out, T, N, scale, x_trans, z_trans, None, 0)
        return out
    j = _frames(joints).copy()
    if j.shape[0] != T:
        raise ValueError(f"joints {j.shape} and points {out.shape} differ "
                         "in frames")
    lib.nm_normalize_episodic(out, T, N, scale, x_trans, z_trans,
                              j.ctypes.data_as(ctypes.c_void_p), j.shape[1])
    return out, j


def crop_strided(seq: np.ndarray, start: int, T: int,
                 sample_rate: int = 1) -> np.ndarray:
    """``data.pipeline.crop_sequence`` for a window that fits: frames
    ``start, start + sample_rate, ...`` (T of them) of ``seq`` (T_in, ...),
    as a float32 copy."""
    src = np.ascontiguousarray(seq, dtype=np.float32)
    if start < 0 or T < 0 or sample_rate < 1 or \
            (T and start + (T - 1) * sample_rate >= src.shape[0]):
        raise ValueError(f"window start {start}, T {T}, rate {sample_rate} "
                         f"does not fit {src.shape[0]} frames")
    out = np.empty((T,) + src.shape[1:], dtype=np.float32)
    frame = int(np.prod(src.shape[1:], dtype=np.int64))
    library().nm_crop_strided(src, out, start, T, sample_rate, frame)
    return out


def gif_lzw(indices: np.ndarray, min_code_size: int) -> bytes:
    """GIF's LZW code stream of a frame's palette ``indices`` (uint8, in
    raster order), without the sub-block framing."""
    idx = np.ascontiguousarray(indices, dtype=np.uint8).reshape(-1)
    if not 2 <= min_code_size <= 8:
        raise ValueError(f"min_code_size {min_code_size} not in 2..8")
    # a code is at most 12 bits a symbol, plus the clear codes
    cap = idx.size * 2 + 64
    out = np.empty(cap, dtype=np.uint8)
    n = library().nm_gif_lzw(idx, idx.size, min_code_size, out, cap)
    if n < 0:
        raise RuntimeError("nm_gif_lzw: output buffer too small")
    return out[:n].tobytes()


def png_unfilter(rows: np.ndarray, height: int, stride: int,
                 bpp: int) -> np.ndarray:
    """The ``(height, stride)`` bytes of a PNG image from its decompressed
    rows (a filter byte, then ``stride`` bytes, per row)."""
    src = np.ascontiguousarray(rows, dtype=np.uint8).reshape(-1)
    if src.size != height * (stride + 1):
        raise ValueError(f"{src.size} bytes for {height} rows of {stride}")
    out = np.empty((height, stride), dtype=np.uint8)
    bad = library().nm_png_unfilter(src, height, stride, bpp, out)
    if bad:
        raise ValueError(f"PNG row {bad - 1}: unknown filter type")
    return out


def tga_unrle(data: np.ndarray, n_pixels: int, bpp: int) -> np.ndarray:
    """The ``n_pixels * bpp`` bytes of a run-length TGA image from its
    packets ``data`` (uint8, from the first packet to the end of the
    file)."""
    src = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    out = np.empty(n_pixels * bpp, dtype=np.uint8)
    if library().nm_tga_unrle(src, src.size, n_pixels, bpp, out) < 0:
        raise ValueError("TGA: the run-length data ends before the image")
    return out


def _bytes(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.ascontiguousarray(
            data, dtype=np.uint8).reshape(-1)


def gif_unlzw(data, min_code_size: int, n_pixels: int) -> np.ndarray:
    """A GIF frame's ``n_pixels`` palette indices (uint8, in the order the
    frame stores its rows) from its LZW code stream ``data`` (the
    sub-blocks joined). Raises ``ValueError`` on a code that names no
    entry, and when the stream ends (or says end-of-information) before
    ``n_pixels`` indices."""
    src = _bytes(data)
    out = np.zeros(n_pixels, np.uint8)
    n = library().nm_gif_unlzw(src, src.size, int(min_code_size), out,
                               n_pixels)
    if n < 0:
        raise ValueError("GIF: a bad LZW code (or minimum code size "
                         f"{min_code_size})")
    if n < n_pixels:
        raise ValueError(f"GIF: the LZW data ends after {n} of {n_pixels} "
                         "pixels (truncated)")
    return out


def tiff_unlzw(data, cap: int) -> np.ndarray:
    """The bytes of a TIFF LZW strip or tile (at most ``cap``), as
    tifffile's ``decode_lzw`` gives them. Raises ``ValueError`` on an
    old-style (LSB-first) stream, one that does not start with a clear
    code, or a code that names no entry."""
    src = _bytes(data)
    out = np.empty(cap, np.uint8)
    n = library().nm_tiff_unlzw(src, src.size, out, cap)
    if n == -1:
        raise ValueError("TIFF: the LZW strip does not start with a clear "
                         "code (old-style LZW is not read)")
    if n < 0:
        raise ValueError("TIFF: a bad LZW code")
    return out[:n]


def packbits(data, cap: int) -> np.ndarray:
    """The bytes of a PackBits strip or tile (at most ``cap``), as
    tifffile's ``decode_packbits`` gives them."""
    src = _bytes(data)
    out = np.empty(cap, np.uint8)
    return out[:library().nm_packbits(src, src.size, out, cap)]


def bmp_unrle(data, file_pos: int, width: int, height: int,
              rle4: bool) -> np.ndarray:
    """The ``height`` rows of ``width`` palette indices (as stored: the
    bottom row first for a bottom-up BMP) of a BI_RLE8 or BI_RLE4 BMP from
    its pixel data ``data``, which starts at byte ``file_pos`` of the file;
    expanded as Pillow does. Raises ``ValueError`` when the data ends before
    the image does."""
    src = _bytes(data)
    out = np.zeros(width * height, np.uint8)
    n = library().nm_bmp_unrle(src, src.size, file_pos, width, height,
                               int(rle4), out)
    if n < 0:
        raise ValueError("BMP: a run-length delta cut short by the end of "
                         "the file")
    if n < width * height:
        raise ValueError(f"BMP: the run-length data ends after {n} of "
                         f"{width * height} pixels")
    return out.reshape(height, width)


JPEG_PROCESSES = ("baseline", "extended sequential", "progressive")
_NO_ROOM = 3   # the decoders' code for memory that runs out


def jpeg_info(data: bytes) -> dict:
    """The frame of a JPEG file: width, height, channels (1 or 3) and
    process (``JPEG_PROCESSES``). Raises ``ValueError`` with the decoder's
    message on a corrupt or unsupported file."""
    src = np.frombuffer(data, np.uint8)
    info = np.zeros(4, np.int32)
    msg = ctypes.create_string_buffer(256)
    if library().nm_jpeg_info(src, src.size, info, msg, len(msg)):
        raise ValueError(msg.value.decode(errors="replace"))
    return dict(width=int(info[0]), height=int(info[1]),
                channels=int(info[2]), process=JPEG_PROCESSES[info[3]])


def jpeg_decode(data: bytes) -> np.ndarray:
    """A JPEG file's pixels as (H, W, channels) uint8, equal to what
    libjpeg-turbo gives Pillow by default. Raises ``ValueError`` with the
    decoder's message on a corrupt or unsupported file."""
    info = jpeg_info(data)
    src = np.frombuffer(data, np.uint8)
    out = np.empty((info["height"], info["width"], info["channels"]),
                   np.uint8)
    msg = ctypes.create_string_buffer(256)
    code = library().nm_jpeg_decode(src, src.size, out, out.size, msg,
                                    len(msg))
    if code == _NO_ROOM:
        raise MemoryError(msg.value.decode(errors="replace"))
    if code:
        raise ValueError(msg.value.decode(errors="replace"))
    return out


def webp_info(data: bytes) -> dict:
    """The facts of a WebP file: width, height (of the canvas), channels
    (3, or 4 where Pillow reads alpha), lossless, animated. Raises
    ``ValueError`` with the decoder's message on a corrupt file."""
    src = np.frombuffer(data, np.uint8)
    info = np.zeros(5, np.int32)
    msg = ctypes.create_string_buffer(256)
    if webp_library().nm_webp_info(src, src.size, info, msg, len(msg)):
        raise ValueError(msg.value.decode(errors="replace"))
    return dict(width=int(info[0]), height=int(info[1]),
                channels=int(info[2]), lossless=bool(info[3]),
                animated=bool(info[4]))


def webp_decode(data: bytes) -> np.ndarray:
    """A WebP file's pixels (the first frame of an animation, on its
    canvas) as (H, W, channels) uint8, equal to what libwebp's
    ``WebPAnimDecoder`` gives Pillow. Raises ``ValueError`` with the
    decoder's message on a corrupt or unsupported file."""
    info = webp_info(data)
    src = np.frombuffer(data, np.uint8)
    out = np.empty((info["height"], info["width"], info["channels"]),
                   np.uint8)
    msg = ctypes.create_string_buffer(256)
    code = webp_library().nm_webp_decode(src, src.size, out, out.size, msg,
                                         len(msg))
    if code == _NO_ROOM:
        raise MemoryError(msg.value.decode(errors="replace"))
    if code:
        raise ValueError(msg.value.decode(errors="replace"))
    return out
