"""libtiff 4.7.1 as two plugins of imageio reach it, with the port's own
decoders: OpenCV through libtiff's RGBA interface (TIFFReadRGBAStrip /
TIFFReadRGBATile, ``viz/opencv_read.py``) and Pillow through
TIFFReadEncodedStrip / TIFFReadTile (``viz/tiff_pillow.py``). The
directory checks of TIFFReadDirectory, the strips and tiles, the codecs
and the predictor are libtiff's in both; what differs is what a codec's
error does. The RGBA interface reads on past it (``strict`` False: the
bytes decoded before it, zeros after), TIFFReadEncodedStrip returns -1 and
Pillow fails (``strict`` True: ``ValueError``). Every error names the
file and the plugin (``who``).

* :func:`directory_checks`, :func:`blocks`, :func:`extent`: the directory,
  and where each strip or tile of the first image lies;
* :func:`strip_bytes`: one strip or tile through LZW (new-style, and
  old-style where libtiff is built with it: OpenCV's), Deflate,
  PackBits, LZMA, ThunderScan or Zstandard; :func:`jpeg_strip`: through
  libjpeg with the JPEGTables tag;
  :func:`fax_blocks`: CCITT fax through ``native.fax_decode``;
* :func:`native_rows`: the bytes of decoded rows in the host's order,
  with the predictor undone as libtiff's PredictorSetup allows it
  (horizontal differencing at 8, 16, 32 and 64 bits, the floating point
  predictor on float samples);
* the RGBA interface: :func:`rgba_samples` (the strips as it reads them),
  :func:`ycbcr_blocks`, :func:`sgilog_samples`, :func:`rgba` (its put
  routines) and :func:`lab_to_rgb`.
"""
from __future__ import annotations

import lzma
import zlib

import numpy as np

from ..data import native
from . import tiff as T

# tags read here besides viz/tiff.py's
ORIENTATION, WHITE_POINT, JPEG_TABLES, T4_OPTIONS = 274, 318, 347, 292
# libtiff's _TIFFGetMaxColorChannels
COLOUR_CHANNELS = {0: 1, 1: 1, 3: 1, 4: 1, 32844: 1, 2: 3, 8: 3, 32845: 3,
                   9: 3, 10: 3, 6: 3, 5: 4}
# libtiff's CCITT fax compressions (tif_fax3.c), its SGILog ones (tif_luv.c)
FAX = (2, 3, 4, 32771)
SGILOG = (34676, 34677)
# the codecs that take a predictor: LZW, Deflate (both codes), LZMA,
# Zstandard
PREDICTED = (5, 8, 32946, 34925, 50000)


def fail(path: str, who: str, what: str):
    raise ValueError(f"{path}: TIFF ({who}): {what}")


def directory_checks(r, tags, path: str, who: str) -> None:
    """What makes libtiff's TIFFReadDirectory fail before the plugin sees
    the image: entries that run past the end of the file
    (TIFFFetchDirectory), a SamplesPerPixel of 0 or past 16 bits, a
    RowsPerStrip of 0 or past 32 bits, a PlanarConfiguration of another
    count than 1 or another value than 1 or 2, no strip (or tile) offsets,
    and no byte counts for more than one strip (one strip's libtiff
    estimates: :func:`extent`)."""
    if r.ifd_end > len(r.data):
        fail(path, who, "libtiff: Can not read TIFF directory (its entries "
                        "run past the end of the file)")
    for tag, name, top in ((T._SAMPLES, "SamplesPerPixel", 0xFFFF),
                           (T._ROWS_PER_STRIP, "RowsPerStrip", 0xFFFFFFFF)):
        value = T._one(tags, tag, 1)
        if not 1 <= value <= top:
            fail(path, who, f"libtiff: Bad value {value} for \"{name}\"")
    planar = tags.get(T._PLANAR)
    if planar is not None and len(planar) != 1:
        fail(path, who, "libtiff: Incorrect count for "
                        "\"PlanarConfiguration\"")
    if planar is not None and planar[0] not in (1, 2):
        fail(path, who, f"libtiff: Bad value {planar[0]} for "
                        "\"PlanarConfiguration\" tag")
    tiled = T._TILE_WIDTH in tags
    offsets = tags.get(T._TILE_OFFSETS if tiled else T._STRIP_OFFSETS)
    if offsets is None:
        field = "TileOffsets" if tiled else "StripOffsets"
        fail(path, who, f"libtiff: TIFF directory is missing required "
                        f"\"{field}\" field")
    if T._STRIP_COUNTS not in tags and not tiled:
        # strips without counts: libtiff estimates one a plane
        H, spp = T._one(tags, T._LENGTH, 0), T._one(tags, T._SAMPLES, 1)
        rps = T._one(tags, T._ROWS_PER_STRIP, H) or H
        per_plane = -(-H // max(1, min(rps, H))) if H else 0
        if T._one(tags, T._PLANAR, 1) == 2 and per_plane != 1 \
                or T._one(tags, T._PLANAR, 1) != 2 and per_plane > 1:
            fail(path, who, "libtiff: TIFF directory is missing required "
                            "\"StripByteCounts\" field")


def blocks(tags, W, H, planes, path: str, who: str):
    """The strips or tiles of the first image, plane by plane: (index,
    plane, y, x, rows, row pixels, depth). Strips are counted as libtiff
    counts them, which ignores ImageDepth."""
    if T._TILE_WIDTH in tags:
        tw, tl = T._one(tags, T._TILE_WIDTH, 0), T._one(tags, T._TILE_LENGTH,
                                                        0)
        td = max(1, T._one(tags, T._TILE_DEPTH, 1))
        D = max(1, T._one(tags, T._IMAGE_DEPTH, 1))
        if not tw or not tl:
            fail(path, who, f"tiles of {tw} x {tl} pixels")
        across, down = -(-W // tw), -(-H // tl)
        per_plane = across * down * -(-D // td)
        return [(p * per_plane + ty * across + tx, p, ty * tl, tx * tw, tl,
                 tw, td) for p in range(planes) for ty in range(down)
                for tx in range(across)]
    rps = T._one(tags, T._ROWS_PER_STRIP, H) or H
    rps = min(rps, H)
    per_plane = -(-H // rps)
    return [(p * per_plane + y // rps, p, y, 0, min(rps, H - y), W, 1)
            for p in range(planes) for y in range(0, H, rps)]


def extent(r, tags, i: int, path: str, who: str) -> tuple[int, int]:
    """Block ``i``'s (offset, byte count) in the file. Without byte counts
    libtiff estimates them (EstimateStripByteCounts): the file's size less
    the header, the IFD and its values stored apart, shared by the planes,
    the last block cut at the end of the file; a block that is empty or
    runs past the end of the file fails the read, as libtiff's
    TIFFFillStrip fails it."""
    tiled = T._TILE_WIDTH in tags
    offsets = tags[T._TILE_OFFSETS if tiled else T._STRIP_OFFSETS]
    counts = tags.get(T._TILE_COUNTS if tiled else T._STRIP_COUNTS)
    if i >= len(offsets):
        fail(path, who, f"no strip or tile {i}")
    if counts is None:
        counts = estimated_counts(r, tags, offsets)
    if i >= len(counts):
        fail(path, who, f"no byte count of strip or tile {i}")
    if counts[i] == 0:
        fail(path, who, f"libtiff: Invalid strip byte count 0, strip {i}")
    if offsets[i] + counts[i] > len(r.data):
        fail(path, who, f"strip or tile {i} runs past the end of the file "
                        "(libtiff: Read error on strip)")
    return offsets[i], counts[i]


def estimated_counts(r, tags, offsets) -> list:
    """libtiff's EstimateStripByteCounts of a compressed image: the file's
    size less the header, the IFD and its values stored apart, shared by
    the planes, the last strip or tile cut at the end of the file."""
    size = len(r.data)
    space = size if size < r.meta_bytes else size - r.meta_bytes
    if T._one(tags, T._PLANAR, 1) == 2:
        space //= max(1, T._one(tags, T._SAMPLES, 1))
    counts = [space] * len(offsets)
    counts[-1] = min(space, max(0, size - offsets[-1]))
    return counts


def strip_bytes(r, i: int, tags, compression: int, need: int, path: str,
                who: str, strict: bool = False):
    """Strip or tile ``i``'s ``need`` bytes as libtiff's codec gives them
    (before the predictor; fill order 2 reverses the bits of each stored
    byte first, as for every codec but fax and JPEG, which take the fill
    order themselves). The RGBA interface reads on past a decoding
    error: LZW, Deflate and PackBits data that fails or ends early gives
    the bytes decoded before, the rest zero, as libtiff's decoders clear
    it; uncompressed data that ends early is not copied, and the strip
    reads as zeros; a Deflate or LZMA stream that is corrupt before the
    strip is full leaves bytes that the file does not determine, and is
    refused (one corrupt past it, as a bad checksum, reads). Returns
    (the bytes, whether the codec succeeded: where it failed, libtiff
    leaves the predictor undone and the bytes in the file's order).
    ``strict`` (TIFFReadEncodedStrip): a block outside the file, a codec's
    error or data that ends before ``need`` bytes fails, LZW is new-style
    only (Pillow's libtiff is built without LZW_COMPAT); returns the
    bytes."""
    tiled = T._TILE_WIDTH in tags
    if strict:
        off, cnt = extent(r, tags, i, path, who)
    else:
        offsets = tags.get(T._TILE_OFFSETS if tiled else T._STRIP_OFFSETS)
        counts = tags.get(T._TILE_COUNTS if tiled else T._STRIP_COUNTS)
        if offsets is None or i >= len(offsets):
            fail(path, who, f"no strip or tile {i}")
        if counts is None and compression != 1:
            counts = estimated_counts(r, tags, offsets)
        off = offsets[i]
        cnt = counts[i] if counts is not None and i < len(counts) else need
        if off + cnt > len(r.data):
            fail(path, who, f"strip or tile {i} runs past the end of the "
                            "file (libtiff: Read error on strip)")
    raw = r.data[off:off + cnt]
    if T._one(tags, T._FILLORDER, 1) == 2:       # TIFFFillStrip's reversal
        raw = T._REVERSED_BITS[np.frombuffer(raw, np.uint8)].tobytes()
    sound = True
    if compression == 1:
        out = np.frombuffer(raw, np.uint8)
        if out.size < need and not strict:
            return np.zeros(need, np.uint8), False
    elif compression == 5:
        out, sound = native.tiff_unlzw_libtiff(raw, need, compat=not strict)
    elif compression == 32773:
        out = native.packbits(raw, need)
    elif compression == 32809:
        out, sound = _thunder(raw, need, tags, i, path, who)
    elif compression == 50000:
        out, status = native.zstd_decode(raw, need)
        if status == native.ZSTD_ERROR:
            fail(path, who, f"strip or tile {i}: libtiff: Error in "
                            "ZSTD_decompressStream()")
        sound = status == native.ZSTD_DECODED
    elif compression in (8, 32946, 34925):
        xz = compression == 34925
        out, sound = _inflate(raw, need, xz, prefix=xz or not strict)
        if out is None:
            codec = "LZMA" if compression == 34925 else "Deflate"
            fail(path, who, f"strip or tile {i}: {codec}: corrupt data "
                            "before the strip's last byte (libtiff: "
                            "Decoding error)")
    if strict:
        if not sound and compression == 5:
            fail(path, who, f"strip or tile {i}: LZW: a code that names no "
                            "entry (libtiff: Corrupted LZW table)")
        if not sound and compression == 32809:
            fail(path, who, f"strip or tile {i}: ThunderScan: a row of "
                            "too few or too many pixels (libtiff: Not "
                            "enough / Too much data at scanline)")
        if not sound and compression == 50000:
            fail(path, who, f"strip or tile {i}: Zstandard: the data ends "
                            f"before its {need} bytes (libtiff: Not enough "
                            "data)")
        if out.size < need:
            fail(path, who, f"strip or tile {i} decodes to {out.size} of "
                            f"its {need} bytes (libtiff: Not enough data)")
        return out[:need]
    full = np.zeros(need, np.uint8)
    full[:out.size] = out[:need]
    return full, sound and out.size >= need


def _inflate(raw: bytes, need: int, xz: bool, prefix: bool):
    """A Deflate (zlib) or LZMA (.xz) stream's first ``need`` bytes (or
    fewer where it ends), and whether libtiff's decoder succeeds; (None,
    False) where the codec fails. ``prefix``: it fails only where the
    stream is corrupt before it gives ``need`` bytes (the RGBA interface
    keeps what a failing Deflate strip decoded, and libtiff's LZMA decoder
    does not fail once the strip is full, so a bad checksum after the
    last block does not reach them); otherwise zlib's check of the
    stream's end, where the strip ends with it, fails too, as libtiff's
    Deflate decoder does."""
    def make():
        return lzma.LZMADecompressor(lzma.FORMAT_XZ) if xz else \
            zlib.decompressobj()
    errors = (lzma.LZMAError, zlib.error)
    try:
        return np.frombuffer(make().decompress(raw, need), np.uint8), True
    except errors:
        if not prefix:
            return None, False
    d, out = make(), bytearray()       # byte by byte, up to the error
    try:
        for k in range(len(raw)):
            out += d.decompress(raw[k:k + 1], need - len(out))
            if len(out) >= need:
                # LZMA succeeds with the strip full, Deflate does not
                return np.frombuffer(bytes(out[:need]), np.uint8), xz
    except errors:
        pass
    return None, False


def jpeg_strip(r, i: int, tags, path: str, who: str,
               ycc: bool | None = None) -> np.ndarray:
    """A JPEG-compressed strip or tile: the JPEGTables stream's tables,
    then the strip's own stream, decoded by libjpeg, which takes the
    colour space it guesses (:func:`jpeg_ycc`) and converts YCbCr to RGB.
    ``ycc``: the colour space libtiff sets for Pillow instead (YCbCr where
    the photometric is YCbCr and Pillow asks for RGB, none otherwise); a
    stream whose guess differs is refused."""
    off, cnt = extent(r, tags, i, path, who)
    raw = r.data[off:off + cnt]
    tables = tags.get(JPEG_TABLES)
    if tables is not None:
        tables = bytes(tables)
        if tables.endswith(b"\xff\xd9") and raw.startswith(b"\xff\xd8"):
            raw = tables[:-2] + raw[2:]
    if ycc is not None and jpeg_ycc(raw) not in (ycc, None):
        fail(path, who, f"JPEG strip or tile {i}: libtiff decodes it "
                        f"{'with' if ycc else 'without'} a YCbCr to RGB "
                        "conversion, its markers and component ids say "
                        "otherwise, and the port's JPEG decoder follows "
                        "them")
    try:
        return native.jpeg_decode(raw, whole=True)
    except ValueError as e:
        fail(path, who, f"JPEG strip or tile {i}: {e}")


def jpeg_ycc(stream: bytes):
    """libjpeg's guess (jdapimin.c default_decompress_parms) whether a
    stream's colour is converted: three components are YCbCr where a JFIF
    APP0 says so, an Adobe APP14 by its transform, the component ids R,
    G, B say no, anything else yes; four are YCCK where an Adobe APP14's
    transform is not 0. False for one component; None where the frame
    header is not found (the decoder's own error then) or there are other
    counts."""
    jfif, adobe, pos = False, None, 2
    while pos + 4 <= len(stream) and stream[pos] == 0xFF:
        marker = stream[pos + 1]
        size = int.from_bytes(stream[pos + 2:pos + 4], "big")
        body = stream[pos + 4:pos + 2 + size]
        if marker == 0xE0 and body[:5] == b"JFIF\x00" and size >= 16:
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and size >= 14:
            adobe = body[11]
        elif marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA, 0xCB) \
                and len(body) >= 6:
            n = body[5]
            ids = tuple(body[6 + 3 * k] for k in range(min(n, 3))
                        if 6 + 3 * k < len(body))
            if n == 1:
                return False
            if n == 4:
                return adobe is not None and adobe != 0
            if n != 3 or len(ids) != 3:
                return None
            if jfif:
                return True
            if adobe is not None:
                return adobe != 0
            return ids != (82, 71, 66)
        pos += 2 + size
    return None


def fax_blocks(r, tags, blocks, compression, path: str, who: str,
               strict: bool = False):
    """Each block's packed 1-bit rows (1 black), decoded by libtiff's fax
    codec in the order given, the codec's run arrays passed from block to
    block. ``strict``: a block that libtiff's decoder fails fails, and one
    that it leaves partly unwritten (a Group 4 block ending early, which
    TIFFReadEncodedStrip accepts) is refused, its other rows being
    whatever the caller's buffer held."""
    ext = [extent(r, tags, i, path, who) for i, *_ in blocks]
    rows = [b[4] * b[6] for b in blocks]
    run = blocks[0][5]
    options = T._one(tags, T4_OPTIONS, 0) if compression == 3 else 0
    rowbytes = (run + 7) // 8
    out, ends = native.fax_decode(r.data, [e[0] for e in ext],
                                  [e[1] for e in ext], rows, run, rowbytes,
                                  compression, options,
                                  T._one(tags, T._FILLORDER, 1))
    for k, end in enumerate(ends if strict else ()):
        if end == native.FAX_FAILED:
            fail(path, who, f"CCITT strip or tile {blocks[k][0]}: the data "
                            "ends before its rows (libtiff: Premature EOF)")
        if end == native.FAX_SHORT:
            fail(path, who, f"CCITT Group 4 strip or tile {blocks[k][0]} "
                            "ends before its last rows, which libtiff "
                            "leaves unwritten in the caller's buffer")
    bounds = np.cumsum([0] + rows) * rowbytes
    return [out[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def _thunder(raw: bytes, need: int, tags, i: int, path: str, who: str):
    """A ThunderScan strip (``native.thunder_decode``): libtiff's codec
    takes 4-bit samples only, and no tiles."""
    bits = T._one(tags, T._BITS, 1)
    if bits != 4:
        fail(path, who, f"libtiff: Wrong bitspersample value ({bits}), "
                        "Thunder decoder only supports 4bits per sample.")
    if T._TILE_WIDTH in tags:
        fail(path, who, "libtiff: ThunderScan tile decoding is not "
                        "implemented.")
    W = T._one(tags, T._WIDTH, 0)
    spp = T._one(tags, T._SAMPLES, 1) if T._one(tags, T._PLANAR, 1) != 2 \
        else 1
    out, status = native.thunder_decode(raw, need, (W * spp * 4 + 7) // 8, W)
    if status == native.THUNDER_FRACTIONAL:
        fail(path, who, f"strip or tile {i}: libtiff: ThunderScan: "
                        "Fractional scanlines cannot be read")
    return out, status == native.THUNDER_DECODED


def predictor_checks(predictor: int, bits: int, fmt: int, path: str,
                     who: str) -> None:
    """libtiff's PredictorSetup: horizontal differencing (2) at 8, 16, 32
    and 64 bits, the floating point predictor (3) on float samples of 16,
    24, 32 and 64 bits; any other value fails."""
    if predictor == 2 and bits not in (8, 16, 32, 64):
        fail(path, who, "libtiff: Horizontal differencing \"Predictor\" not "
                        f"supported with {bits}-bit samples")
    if predictor == 3 and fmt != 3:
        fail(path, who, "libtiff: Floating point \"Predictor\" not "
                        f"supported with {fmt} data format")
    if predictor == 3 and bits not in (16, 24, 32, 64):
        fail(path, who, "libtiff: Floating point \"Predictor\" not "
                        f"supported with {bits}-bit samples")
    if predictor not in (1, 2, 3):
        fail(path, who, f"libtiff: \"Predictor\" value {predictor} not "
                        "supported")


def native_rows(buf: np.ndarray, rows: int, run: int, contig: int,
                bits: int, fmt: int, order: str, predictor: int, path: str,
                who: str) -> np.ndarray:
    """A strip or tile's first ``rows`` decoded rows of ``run`` pixels of
    ``contig`` samples as libtiff returns them: (rows, row bytes) uint8,
    16-, 32- and 64-bit samples in the host's (little-endian) order, the
    predictor undone (:func:`predictor_checks`): horizontal differencing
    summed in each sample's width with a stride of one pixel; the floating
    point predictor's byte planes, most significant first, differenced
    with a stride of one pixel."""
    predictor_checks(predictor, bits, fmt, path, who)
    row_bytes = (run * contig * bits + 7) // 8
    block = buf[:rows * row_bytes].reshape(rows, row_bytes)
    if predictor == 3:
        item = bits // 8
        u = np.cumsum(block.reshape(rows, run * item, contig), axis=1,
                      dtype=np.uint8)
        u = u.reshape(rows, item, run, contig).transpose(0, 2, 3, 1)
        return np.ascontiguousarray(u[..., ::-1]).reshape(rows, row_bytes)
    if bits not in (16, 32, 64):
        if predictor == 2:
            return np.cumsum(block.reshape(rows, run, contig), axis=1,
                             dtype=np.uint8).reshape(rows, row_bytes)
        return block
    word = np.dtype(f"{order}u{bits // 8}")
    v = block.view(word).astype(word.newbyteorder("<"))
    if predictor == 2:
        v = np.cumsum(v.reshape(rows, run, contig), axis=1, dtype=v.dtype)
    return np.ascontiguousarray(v).view(np.uint8).reshape(rows, row_bytes)


# ------------------------------------------------------ the RGBA interface
def rgba_samples(r, tags, W, H, spp, bits, compression, planar, fmt, sub,
                 jpeg_rgb, path, who):
    """The first image's samples as libtiff's RGBA reader gets them:
    (H, W, spp) uint8 or native uint16 (1-, 2- and 4-bit levels unpacked),
    or, for sub-sampled YCbCr, (H, W, 3) with chroma replicated. The
    predictor applies only under LZW and Deflate."""
    order = r.order
    predictor = T._one(tags, T._PREDICTOR, 1) \
        if compression in PREDICTED else 1
    predictor_checks(predictor, bits, fmt, path, who)
    planes = spp if planar == 2 else 1
    contig = 1 if planar == 2 else spp
    blks = blocks(tags, W, H, planes, path, who)
    if sub is not None and sub != (1, 1):
        return ycbcr_blocks(r, tags, blks, W, H, sub, compression, path, who)
    fax = fax_blocks(r, tags, blks, compression, path, who) \
        if compression in FAX else None
    out = np.zeros((planes, H, W, contig), np.uint16 if bits == 16 else
                   np.uint8)
    for k, (i, p, y, x, rows, run, depth) in enumerate(blks):
        if jpeg_rgb or compression == 7:
            block = jpeg_strip(r, i, tags, path, who)
            block = block[:rows, :run].reshape(-1)
            rows_here = min(rows, block.size // max(1, run * contig))
            block = block[:rows_here * run * contig].reshape(rows_here, run,
                                                             contig)
        else:
            row_bytes = (run * contig * bits + 7) // 8
            buf, sound = (fax[k], True) if fax is not None else strip_bytes(
                r, i, tags, compression, depth * rows * row_bytes, path, who)
            if bits < 8:
                block = T._unpack_bits(buf, rows, run * contig, bits).reshape(
                    rows, run, contig)
            elif sound:
                block = native_rows(buf, rows, run, contig, bits, fmt, order,
                                    predictor, path, who).view(
                    out.dtype).reshape(rows, run, contig)
            else:        # the codec failed: no predictor, no byte swap
                block = np.frombuffer(buf[:rows * row_bytes].tobytes(),
                                      out.dtype).reshape(rows, run, contig)
        h, w = min(block.shape[0], H - y), min(block.shape[1], W - x)
        out[p, y:y + h, x:x + w] = block[:h, :w]
    return out[0] if planar == 1 else out[..., 0].transpose(1, 2, 0)


def sgilog_samples(r, tags, W, H, photometric, compression, spp, path, who):
    """An SGILog image's (H, W, 1) grey or (H, W, 3) RGB samples as the
    codec gives them to libtiff's RGBA reader (SGILOGDATAFMT_8BIT)."""
    if photometric == 32844 and spp != 1:
        fail(path, who, "libtiff: Sorry, can not handle LogL image with "
                        f"Samples/pixel={spp}")
    kind = native.SGILOG_KINDS.get((photometric, compression))
    if kind is None:
        fail(path, who, f"libtiff: Inappropriate photometric interpretation "
                        f"{photometric} for SGILog compression; must be "
                        "either LogLUV or LogL")
    channels = 1 if kind == 0 else 3
    blks = blocks(tags, W, H, 1, path, who)
    ext = [extent(r, tags, i, path, who) for i, *_ in blks]
    rows = [b[4] * b[6] for b in blks]
    run = blks[0][5]
    flat = native.sgilog_decode(r.data, [e[0] for e in ext],
                                [e[1] for e in ext], rows, run, kind,
                                T._one(tags, T._FILLORDER, 1))
    out = np.zeros((H, W, channels), np.uint8)
    at = 0
    for (_, _, y, x, rows_here, run_here, _), n in zip(blks, rows):
        block = flat[at:at + n * run_here * channels].reshape(
            n, run_here, channels)
        at += n * run_here * channels
        h, w = min(rows_here, H - y), min(run_here, W - x)
        out[y:y + h, x:x + w] = block[:h, :w]
    return out


def ycbcr_blocks(r, tags, blks, W, H, sub, compression, path, who):
    """Sub-sampled YCbCr data units (hs x vs luma, then Cb and Cr) ->
    (H, W, 3), each unit's chroma replicated over it
    (putcontig8bitYCbCr*tile)."""
    hs, vs = sub
    out = np.zeros((H, W, 3), np.uint8)
    for i, _, y, x, rows, run, _ in blks:
        ux, uy = -(-run // hs), -(-rows // vs)
        unit = hs * vs + 2
        buf, _ = strip_bytes(r, i, tags, compression, ux * uy * unit, path,
                             who)
        u = buf.reshape(uy, ux, unit)
        luma = u[..., :hs * vs].reshape(uy, ux, vs, hs).transpose(
            0, 2, 1, 3).reshape(uy * vs, ux * hs)
        cb = np.repeat(np.repeat(u[..., -2], vs, 0), hs, 1)
        cr = np.repeat(np.repeat(u[..., -1], vs, 0), hs, 1)
        block = np.stack([luma, cb, cr], -1)
        h, w = min(rows, H - y), min(run, W - x)
        out[y:y + h, x:x + w] = block[:h, :w]
    return out


def rgba(img, tags, kind, bits, spp, extra, path, who) -> np.ndarray:
    """libtiff's put routines over the samples -> (H, W, 3) uint8 RGB
    (both plugins drop the alpha of the RGBA raster)."""
    def scale16(v):          # Bitdepth16To8
        return ((v.astype(np.uint32) + 128) // 257).astype(np.uint8)

    if kind in (0, 1):
        v = img[..., 0]
        if bits == 16:
            v = (v >> 8).astype(np.uint8)
            top = 255
        else:
            top = (1 << bits) - 1
            v = (v.astype(np.int32) * 255 // top).astype(np.uint8) \
                if bits < 8 else v.astype(np.uint8)
        if kind == 0:
            v = 255 - v
        return np.repeat(v[..., None], 3, -1)
    if kind == 3:
        cmap = np.asarray(tags[T._COLORMAP], np.int64)
        n = 1 << bits
        if len(cmap) < 3 * n:
            fail(path, who, "libtiff: a Colormap shorter than 3 x 2^bits")
        cmap = cmap[:3 * n].reshape(3, n).T
        if (cmap >= 256).any():
            cmap = cmap >> 8
        return (cmap & 255).astype(np.uint8)[img[..., 0]]
    if kind == 2:
        c = img[..., :3]
        alpha = img[..., 3] if spp >= 4 else None
        unassoc = extra[:1] == [2] and alpha is not None
        if bits == 16:
            c = scale16(c)
            alpha = scale16(alpha) if alpha is not None else None
        c = c.astype(np.uint8)
        if unassoc:
            a = alpha.astype(np.int32)[..., None]
            c = ((c.astype(np.int32) * a + 127) // 255).astype(np.uint8)
        return np.ascontiguousarray(c)
    if kind == 5:
        c = img.astype(np.int32)
        k = 255 - c[..., 3:4]
        return (k * (255 - c[..., :3]) // 255).astype(np.uint8)
    if kind == 6:
        return T._ycbcr_to_rgb(img[..., :3], tags)
    return lab_to_rgb(img, tags, bits, path, who)


def lab_to_rgb(img, tags, bits, path, who) -> np.ndarray:
    """libtiff's CIELab conversion (tif_color.c) in float32, as C computes
    it: TIFFCIELabToXYZ (8-bit L* scaled by 257 and a*, b* by 256) against
    the reference white of the WhitePoint tag (default D50), then
    TIFFXYZToRGB through the sRGB display of tif_getimage.c (its matrix,
    gamma 2.4, 1500-step tables)."""
    f = np.float32
    wp = tags.get(WHITE_POINT)
    if wp is not None and len(wp) >= 4 and wp[1] and wp[3]:
        wx, wy = f(f(wp[0]) / f(wp[1])), f(f(wp[2]) / f(wp[3]))
    else:
        tot = f(f(96.4250) + f(100.0)) + f(82.4680)
        wx, wy = f(f(96.4250) / tot), f(f(100.0) / tot)
    if wy == 0:
        fail(path, who, "libtiff: Invalid value for WhitePoint tag")
    y0 = f(100)
    x0 = f(wx / wy * y0)
    z0 = f(f(f(f(1) - wx) - wy) / wy * y0)
    if bits == 8:
        L = img[..., 0].astype(np.int64) * 257
        a = img[..., 1].astype(np.int8).astype(np.int64) * 256
        b = img[..., 2].astype(np.int8).astype(np.int64) * 256
    else:
        L = img[..., 0].astype(np.int64)
        a = img[..., 1].astype(np.int16).astype(np.int64)
        b = img[..., 2].astype(np.int16).astype(np.int64)
    Lf = L.astype(f) * f(100) / f(65535)
    small = Lf < f(8.856)
    Y = np.where(small, Lf * y0 / f(903.292), f(0))
    cby = np.where(small, f(7.787) * (Y / y0) + f(16) / f(116),
                   (Lf + f(16)) / f(116))
    Y = np.where(small, Y, y0 * cby * cby * cby).astype(f)

    def cube(t, w0):
        return np.where(t < f(0.2069), w0 * (t - f(0.13793)) / f(7.787),
                        w0 * t * t * t).astype(f)

    X = cube(a.astype(f) / f(256) / f(500) + cby, x0)
    Z = cube(cby - b.astype(f) / f(256) / f(200), z0)
    mat = ((3.2410, -1.5374, -0.4986), (-0.9692, 1.8760, 0.0416),
           (0.0556, -0.2040, 1.0570))
    steps = 1500
    step = f(f(100) - f(1)) / f(steps)
    table = (f(255) * np.power(np.arange(steps + 1) / steps,
                               1.0 / float(f(2.4))).astype(f)).astype(f)
    out = []
    for row in mat:
        yc = f(row[0]) * X + f(row[1]) * Y
        yc = (yc + f(row[2]) * Z).astype(f)
        yc = np.minimum(np.maximum(yc, f(1)), f(100))
        i = np.minimum(((yc - f(1)) / step).astype(np.int64), steps)
        v = (table[i].astype(np.float64) + 0.5).astype(np.int64)
        out.append(np.minimum(v, 255))
    return np.stack(out, -1).astype(np.uint8)
