"""PNG and GIF files of the port's renders, with no imaging library.

Counterpart of the JAX package's ``viz/raster.save_png`` / ``save_gif``
(imageio) and ``viz/visualize._save_gifs``:

* :func:`to_uint8` — the JAX package's truncating cast;
* :func:`save_png` / :func:`write_png` — 8-bit RGB, zlib, lossless: the
  decoded pixels equal ``to_uint8(img)``;
* :func:`read_png` — 8-bit RGB or RGBA, non-interlaced (textures, checks);
* :func:`write_gif` — GIF89a with the loop extension, an adaptive palette
  of at most 256 colours per frame (exact when the frame has no more; else
  a count-weighted median cut, each colour mapped to its nearest entry)
  and the frame delay the caller asks for, in seconds.

The LZW coder of the GIF frames and the PNG row filters run in the port's
host library (``csrc/nm_host.cpp`` through ``data/native.py``), which
raises when it cannot be built.
"""
from __future__ import annotations

import heapq
import struct
import zlib

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..data import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_uint8(img) -> np.ndarray:
    """``clip(img, 0, 1) * 255`` cast to uint8 by truncation (a tensor is
    cast on its device and copied to the host)."""
    if isinstance(img, torch.Tensor):
        return (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


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


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB or RGBA, non-interlaced PNG as (H, W, 3 or 4) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in (2, 6) or interlace != 0:
        raise ValueError(f"{path}: only 8-bit RGB/RGBA non-interlaced PNGs "
                         f"are read (bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace})")
    bpp = 3 if ctype == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return native.png_unfilter(raw, H, W * bpp, bpp).reshape(H, W, bpp)


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

