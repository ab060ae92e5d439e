"""ctypes binding of the port's host libraries: ``csrc/nm_host.cpp`` (the
data layer's loops, the GIF and PNG coders of ``viz/image_files.py``, its
JPEG and QOI decoders, and the LZW, PackBits and run-length expansions of
its GIF, TIFF, BMP and TGA readers), ``csrc/nm_webp.cpp`` (its WebP
decoder), ``csrc/nm_dds.cpp`` (the BC1-BC7 blocks of its DDS reader),
``csrc/nm_jp2.cpp`` (its JPEG 2000 decoder) and ``csrc/nm_tiffcodec.cpp``
(libtiff's CCITT fax and SGILog codecs of its OpenCV route).

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
_dds: Optional[ctypes.CDLL] = None
_jp2: Optional[ctypes.CDLL] = None
_tiffcodec: Optional[ctypes.CDLL] = None
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
            lib.nm_tiff_unlzw.argtypes = [u8p, i64, u8p, i64,
                                          ctypes.c_int32]
            lib.nm_tiff_unlzw.restype = i64
            lib.nm_tiff_unlzw_compat.argtypes = [u8p, i64, u8p, i64]
            lib.nm_tiff_unlzw_compat.restype = i64
            lib.nm_hdr_unrle.argtypes = [u8p, i64, i64, i64, u8p]
            lib.nm_hdr_unrle.restype = i64
            lib.nm_packbits.argtypes = [u8p, i64, u8p, i64]
            lib.nm_packbits.restype = i64
            lib.nm_bmp_unrle.argtypes = [u8p, i64, i64, i64, i64,
                                         ctypes.c_int, u8p]
            lib.nm_bmp_unrle.restype = i64
            lib.nm_jpeg_info.argtypes = [u8p, i64, i32p, ctypes.c_char_p,
                                         i64]
            lib.nm_jpeg_info.restype = ctypes.c_int
            lib.nm_jpeg_decode.argtypes = [u8p, i64, u8p, i64,
                                           ctypes.c_int32, ctypes.c_char_p,
                                           i64]
            lib.nm_jpeg_decode.restype = ctypes.c_int
            lib.nm_qoi_decode.argtypes = [u8p, i64, i64, ctypes.c_int, u8p]
            lib.nm_qoi_decode.restype = i64
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


def dds_library() -> ctypes.CDLL:
    """The loaded BCn block decoder (``csrc/nm_dds.cpp``); built on first
    use, raises if it cannot be built."""
    global _dds
    with _lock:
        if _dds is None:
            lib = kernels.library("nm_dds")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i64 = ctypes.c_int64
            lib.nm_bcn_decode.argtypes = [u8p, i64, ctypes.c_int,
                                          ctypes.c_int, i64, i64, u8p]
            lib.nm_bcn_decode.restype = ctypes.c_int
            _dds = lib
    return _dds


def jp2_library() -> ctypes.CDLL:
    """The loaded JPEG 2000 decoder (``csrc/nm_jp2.cpp``); built on first
    use, raises if it cannot be built."""
    global _jp2
    with _lock:
        if _jp2 is None:
            lib = kernels.library("nm_jp2")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            i32, i64 = ctypes.c_int32, ctypes.c_int64
            lib.nm_jp2_info.argtypes = [u8p, i64, i32p, ctypes.c_char_p, i64]
            lib.nm_jp2_info.restype = ctypes.c_int
            lib.nm_jp2_decode.argtypes = [u8p, i64, i32, i32, i32, i32, u8p,
                                          i64, ctypes.c_char_p, i64]
            lib.nm_jp2_decode.restype = ctypes.c_int
            lib.nm_jp2_components.argtypes = [
                u8p, i64, np.ctypeslib.ndpointer(np.int32,
                                                 flags="C_CONTIGUOUS"),
                i64, ctypes.c_char_p, i64]
            lib.nm_jp2_components.restype = ctypes.c_int
            _jp2 = lib
    return _jp2


def tiffcodec_library() -> ctypes.CDLL:
    """The loaded CCITT fax and SGILog decoders (``csrc/nm_tiffcodec.cpp``);
    built on first use, raises if it cannot be built."""
    global _tiffcodec
    with _lock:
        if _tiffcodec is None:
            lib = kernels.library("nm_tiffcodec")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            i32, i64 = ctypes.c_int32, ctypes.c_int64
            lib.nm_fax_decode.argtypes = [u8p, i64, i64p, i64p, i64p, i32,
                                          i32, i64, i32, ctypes.c_uint32,
                                          i32, u8p]
            lib.nm_fax_decode.restype = ctypes.c_int
            lib.nm_sgilog_decode.argtypes = [u8p, i64, i64p, i64p, i64p, i32,
                                             i64, i32, i32, u8p]
            lib.nm_sgilog_decode.restype = ctypes.c_int
            _tiffcodec = lib
    return _tiffcodec


def _blocks(offsets, counts, rows):
    return tuple(np.ascontiguousarray(v, np.int64).reshape(-1)
                 for v in (offsets, counts, rows))


def fax_decode(data, offsets, counts, rows, rowpixels: int, rowbytes: int,
               compression: int, options: int = 0,
               fillorder: int = 1) -> np.ndarray:
    """The CCITT strips or tiles of one TIFF (block i: ``counts[i]`` bytes
    at ``offsets[i]`` of the file ``data``, ``rows[i]`` rows of
    ``rowpixels`` pixels) as libtiff's fax codec decodes them, in the order
    given (its run arrays pass from one block to the next): compression 2,
    3 (``options`` its Group3Options, bit 0 for 2-D coding), 4 or 32771;
    ``fillorder`` 2 reads bits least significant first. Returns the
    blocks' packed rows, ``rowbytes`` bytes each, one block after the
    other, 1 for black. Where a block goes wrong, the rows libtiff fills
    are kept and the rest are zero, as OpenCV reads them."""
    src = _bytes(data)
    offs, cnts, rws = _blocks(offsets, counts, rows)
    out = np.zeros(int(rws.sum()) * rowbytes, np.uint8)
    if tiffcodec_library().nm_fax_decode(
            src, src.size, offs, cnts, rws, offs.size, rowpixels, rowbytes,
            compression, options, fillorder, out):
        raise ValueError("CCITT: a strip or tile outside the file, or rows "
                         f"of {rowpixels} pixels in {rowbytes} bytes")
    return out


# nm_sgilog_decode's kinds: the photometric and compression -> kind
SGILOG_KINDS = {(32844, 34676): 0, (32845, 34676): 1, (32845, 34677): 2}


def sgilog_decode(data, offsets, counts, rows, width: int, kind: int,
                  fillorder: int = 1) -> np.ndarray:
    """The SGILog strips or tiles of one TIFF (blocks as for
    ``fax_decode``, rows of ``width`` pixels) as libtiff decodes them for
    its RGBA reader (``SGILOGDATAFMT_8BIT``): ``kind`` 0 LogL16 (one grey
    byte a pixel), 1 LogLuv32 and 2 LogLuv24 (three, RGB). Returns the
    blocks' samples one after the other; a block ends at the first row its
    data cannot complete, the rest zero."""
    src = _bytes(data)
    offs, cnts, rws = _blocks(offsets, counts, rows)
    channels = 1 if kind == 0 else 3
    out = np.zeros(int(rws.sum()) * width * channels, np.uint8)
    if tiffcodec_library().nm_sgilog_decode(src, src.size, offs, cnts, rws,
                                            offs.size, width, kind,
                                            fillorder, out):
        raise ValueError("SGILog: a strip or tile outside the file")
    return out


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
    n = library().nm_tiff_unlzw(src, src.size, out, cap, 0)
    if n == -1:
        raise ValueError("TIFF: the LZW strip does not start with a clear "
                         "code (old-style LZW is not read)")
    if n < 0:
        raise ValueError("TIFF: a bad LZW code")
    return out[:n]


def tiff_unlzw_libtiff(data, cap: int) -> tuple[np.ndarray, bool]:
    """A TIFF LZW strip or tile as libtiff decodes it: new-style (MSB
    first, ``LZWDecode``) or, where it starts with a 0 byte and then an odd
    one, old-style (LSB first, ``LZWDecodeCompat``). Returns (the bytes
    decoded, at most ``cap``; whether the stream was sound): where libtiff
    fails (no clear code first, a code that names no entry), the bytes it
    wrote before the failure."""
    src = _bytes(data)
    out = np.empty(cap, np.uint8)
    if src.size >= 2 and src[0] == 0 and src[1] & 1:
        n = library().nm_tiff_unlzw_compat(src, src.size, out, cap)
    else:
        n = library().nm_tiff_unlzw(src, src.size, out, cap, 1)
    if n >= 0:
        return out[:n], True
    return out[:max(0, -2 - n)], False


# nm_hdr_unrle's failures, in the words of OpenCV's RGBE reader
_HDR_ERRORS = {-1: "RGBE read error (the pixel data ends early)",
               -2: "RGBE bad file format: wrong scanline width",
               -3: "RGBE bad file format: bad scanline data"}


def hdr_unrle(data, width: int, height: int) -> tuple[np.ndarray, int]:
    """The ``height`` x ``width`` RGBE pixels of a Radiance HDR file's
    data (the bytes after its header), as OpenCV's ``RGBE_ReadPixels_RLE``
    reads them: ((height, width, 4) uint8 R, G, B, E, the bytes read).
    Raises ``ValueError`` with OpenCV's words where it fails."""
    src = _bytes(data)
    out = np.zeros(width * height * 4, np.uint8)
    n = library().nm_hdr_unrle(src, src.size, width, height, out)
    if n < 0:
        raise ValueError("Radiance HDR: " + _HDR_ERRORS[int(n)])
    return out.reshape(height, width, 4), int(n)


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


# the frame marker's number (SOFn) -> the coding process it names
JPEG_PROCESSES = {0: "baseline", 1: "extended sequential", 2: "progressive",
                  3: "lossless", 9: "arithmetic sequential",
                  10: "arithmetic progressive"}
_NO_ROOM = 3   # the decoders' code for memory that runs out


def jpeg_info(data: bytes) -> dict:
    """The frame of a JPEG file: width, height, channels (1, 3 or 4) and
    process (``JPEG_PROCESSES``). Raises ``ValueError`` with the decoder's
    message on a corrupt or unsupported file."""
    src = np.frombuffer(data, np.uint8)
    info = np.zeros(4, np.int32)
    msg = ctypes.create_string_buffer(256)
    if library().nm_jpeg_info(src, src.size, info, msg, len(msg)):
        raise ValueError(msg.value.decode(errors="replace"))
    return dict(width=int(info[0]), height=int(info[1]),
                channels=int(info[2]), process=JPEG_PROCESSES[info[3]])


def jpeg_decode(data: bytes, whole: bool = False) -> np.ndarray:
    """A JPEG file's pixels as (H, W, channels) uint8, equal to what
    libjpeg-turbo gives Pillow by default, and so to imageio's array: grey,
    RGB, or the CMYK samples inverted as Pillow's "CMYK;I" reads them.
    ``whole``: libjpeg reads the whole file, as OpenCV's source gives it,
    not only the 64 KiB blocks Pillow has fed it when an arithmetic-coded
    scan starts. Raises ``ValueError`` with the decoder's message on a
    corrupt or unsupported file."""
    info = jpeg_info(data)
    src = np.frombuffer(data, np.uint8)
    out = np.empty((info["height"], info["width"], info["channels"]),
                   np.uint8)
    msg = ctypes.create_string_buffer(256)
    code = library().nm_jpeg_decode(src, src.size, out, out.size,
                                    int(whole), msg, len(msg))
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


def jp2_info(data) -> dict:
    """The main header of a JPEG 2000 codestream: the image area on the
    reference grid (x0, y0, x1, y1) and per component its bits, signedness
    and sub-sampling (``components``: a list of (bits, signed, dx, dy)).
    Raises ``ValueError`` with the decoder's message."""
    src = _bytes(data)
    info = np.zeros(21, np.int32)
    msg = ctypes.create_string_buffer(256)
    if jp2_library().nm_jp2_info(src, src.size, info, msg, len(msg)):
        raise ValueError(msg.value.decode(errors="replace"))
    comps = [tuple(int(v) for v in info[5 + 4 * c:9 + 4 * c])
             for c in range(int(info[4]))]
    return dict(x1=int(info[0]), y1=int(info[1]), x0=int(info[2]),
                y0=int(info[3]), components=comps)


# samples per pixel of each of nm_jp2_decode's modes: L, P, PA, I;16, LA,
# RGB, RGBA, CMYK
_JP2_BANDS = (1, 1, 2, 1, 2, 3, 4, 4)


def jp2_decode(data, mode: int, space: int, width: int,
               height: int) -> np.ndarray:
    """A JPEG 2000 codestream decoded as OpenJPEG decodes it and unpacked
    as Pillow's ``Jpeg2KDecode.c`` unpacks it into an image of ``mode``
    (an index of ``viz.jpeg2000.MODES``) and ``width`` x ``height``, the
    codestream's colour space being ``space`` (0 unspecified, 1 sRGB, 2
    grey, 3 sYCC, 4 e-sYCC, 5 CMYK): (height, width, bands) uint8, uint16
    for I;16; P and PA as palette indices. Raises ``ValueError`` with the
    decoder's message on a corrupt or unsupported codestream."""
    src = _bytes(data)
    bands = _JP2_BANDS[mode]
    out = np.empty((height, width, bands),
                   np.uint16 if mode == 3 else np.uint8)
    msg = ctypes.create_string_buffer(256)
    code = jp2_library().nm_jp2_decode(src, src.size, mode, space, width,
                                       height, out.view(np.uint8).reshape(-1),
                                       out.nbytes, msg, len(msg))
    if code == _NO_ROOM:
        raise MemoryError(msg.value.decode(errors="replace"))
    if code:
        raise ValueError(msg.value.decode(errors="replace"))
    return out


def jp2_components(data) -> np.ndarray:
    """The samples of a JPEG 2000 codestream whose components are all
    whole, as OpenJPEG's ``opj_decode`` leaves them before any JP2 box
    transform: (components, height, width) int32. Raises ``ValueError``
    with the decoder's message on a corrupt or unsupported codestream."""
    info = jp2_info(data)
    src = _bytes(data)
    out = np.empty((len(info["components"]), info["y1"] - info["y0"],
                    info["x1"] - info["x0"]), np.int32)
    msg = ctypes.create_string_buffer(256)
    code = jp2_library().nm_jp2_components(src, src.size, out, out.size,
                                           msg, len(msg))
    if code == _NO_ROOM:
        raise MemoryError(msg.value.decode(errors="replace"))
    if code:
        raise ValueError(msg.value.decode(errors="replace"))
    return out


def qoi_decode(data, n_pixels: int, channels: int) -> np.ndarray:
    """A QOI image's ops (the bytes after its header) into (n_pixels,
    channels) uint8, as Pillow's QoiDecoder reads them (the plain version
    the tests hold it against is Pillow itself). Raises ``ValueError`` when
    the data ends first."""
    src = _bytes(data)
    out = np.empty((n_pixels, channels), np.uint8)
    if library().nm_qoi_decode(src, src.size, n_pixels, channels, out):
        raise ValueError(f"QOI: the data ends before pixel {n_pixels}")
    return out


# BCn formats of nm_bcn_decode: name -> (number, bytes a block, channels)
BCN_FORMATS = {"BC1": (1, 8, 4), "BC2": (2, 16, 4), "BC3": (3, 16, 4),
               "BC4": (4, 8, 1), "BC5": (5, 16, 3), "BC6H": (6, 16, 3),
               "BC7": (7, 16, 4)}


def bcn_decode(data, fmt: str, signed: bool, width: int,
               height: int) -> np.ndarray:
    """The (height, width, channels) uint8 pixels of BCn blocks (``fmt`` of
    ``BCN_FORMATS``; ``signed`` BC5 or BC6H), as Pillow's BcnDecode.c
    decodes them. Raises ``ValueError`` when the data holds too few
    blocks."""
    number, block, channels = BCN_FORMATS[fmt]
    src = _bytes(data)
    out = np.empty((height, width, channels), np.uint8)
    code = dds_library().nm_bcn_decode(src, src.size, number, int(signed),
                                       width, height, out)
    if code:
        need = -(-width // 4) * -(-height // 4) * block
        raise ValueError(f"{fmt}: {src.size} bytes of block data, {need} "
                         "needed")
    return out
