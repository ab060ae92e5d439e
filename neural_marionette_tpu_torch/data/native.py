"""ctypes binding of the port's host library (``csrc/nm_host.cpp``): the
data layer's loops, the GIF and PNG coders of ``viz/image_files.py``, and
its JPEG decoder and TGA run-length expansion.

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


JPEG_PROCESSES = ("baseline", "extended sequential", "progressive")
_JPEG_NO_ROOM = 3   # nm_jpeg_decode's code for memory that runs out


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
    if code == _JPEG_NO_ROOM:
        raise MemoryError(msg.value.decode(errors="replace"))
    if code:
        raise ValueError(msg.value.decode(errors="replace"))
    return out
