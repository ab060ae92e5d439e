"""The decoders this port's texture reader gained for DDS, QOI, PNM and the
rarer JPEG processes, block by block against Pillow and imageio (the JAX
retarget path's readers) on seeded random data:

* the QM decoder of arithmetic JPEG (random bytes behind SOF9 and SOF10
  headers: libjpeg reads them to its error state and grey, as the port
  does), and the generator's own arithmetic coder over random images;
* block smoothing of progressive files cut after each scan, DC-only
  included, at every sampling of Pillow's encoder and of the generator's;
* lossless JPEG, every predictor and point transform;
* each BC7 mode (and the reserved one), each BC6H mode, unsigned and
  signed, BC1-BC5 with signed BC5, at sizes not a multiple of 4;
* QOI streams of random ops, 3 and 4 channels;
* PNM headers with comments, plain and raw, every maxval class.

The host libraries are built with g++ on first use; no card is needed.
"""
from __future__ import annotations

import importlib.util
import io
import struct
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from neural_marionette_tpu_torch.data import native
from neural_marionette_tpu_torch.viz import image_files as F

TEX = Path(__file__).resolve().parent / "torch_textures"
_spec = importlib.util.spec_from_file_location("make_textures",
                                               TEX / "make_textures.py")
MAKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(MAKE)


def _imageio(data: bytes, tmp_path: Path, name: str) -> np.ndarray:
    path = tmp_path / name
    path.write_bytes(data)
    return np.asarray(imageio.imread(path))


def _same(got: np.ndarray, want: np.ndarray) -> bool:
    return got.dtype == want.dtype and np.array_equal(
        got.reshape(want.shape), want)


# ---------------------------------------------------------- arithmetic JPEG
def _scan_start(data: bytes) -> int:
    sos = data.index(b"\xff\xda")
    return sos + 2 + (data[sos + 2] << 8 | data[sos + 3])


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_qm_decoder_reads_random_data_as_libjpeg(tmp_path, progressive,
                                                 seed):
    """Random entropy-coded bytes (stuffed 0xFF 0x00 pairs and 0xFF fill
    bytes among them) behind an arithmetic frame: the QM decoder's states,
    the error state of a magnitude or spectral overflow (the rest of the
    segment left zero) and the zeros fed once the EOI marker is met give
    libjpeg's pixels."""
    rng = np.random.default_rng(seed)
    img = MAKE.ycbcr(MAKE.textured(21, 27, seed))
    data = MAKE.jpeg_encode(img, [(2, 2), (1, 1), (1, 1)],
                            coding="arithmetic", progressive=progressive,
                            scans=MAKE.PROGRESSION[:1] if progressive
                            else None)
    start = _scan_start(data)
    noise = bytearray(rng.integers(0, 255, 60 * (seed + 1),
                                   dtype=np.uint8).tobytes())
    for at in sorted(rng.integers(0, len(noise), 5), reverse=True):
        noise[at:at] = b"\xff\x00" if at % 3 else b"\xff\xff\x00"
    data = data[:start] + bytes(noise) + b"\xff\xd9"
    want = _imageio(data, tmp_path, "x.jpg")
    assert _same(native.jpeg_decode(data), want)


@pytest.mark.parametrize("case", range(8))
def test_arithmetic_coder_round_trip(tmp_path, case):
    """The generator's arithmetic coder over random images, samplings,
    conditioning and restart intervals: libjpeg and the port decode the
    same pixels."""
    rng = np.random.default_rng(100 + case)
    H, W = (int(v) for v in rng.integers(5, 40, 2))
    samples = MAKE.ycbcr(MAKE.textured(H, W, case))
    factors = [[(1, 1)] * 3, [(2, 1), (1, 1), (1, 1)],
               [(2, 2), (1, 1), (1, 1)], [(1, 2), (1, 1), (1, 1)]][case % 4]
    dac = {0: (int(rng.integers(0, 3)), int(rng.integers(3, 8)),
               int(rng.integers(1, 63))), 1: (1, 4, 9)}
    data = MAKE.jpeg_encode(samples, factors, coding="arithmetic",
                            progressive=case >= 4, dac=dac,
                            restart=int(rng.integers(0, 5)),
                            quality=int(rng.integers(30, 100)))
    want = _imageio(data, tmp_path, "x.jpg")
    assert _same(native.jpeg_decode(data), want)


def test_arithmetic_scan_past_64k_raises_like_imageio(tmp_path):
    """An arithmetic scan whose data runs past the 64 KiB Pillow hands
    libjpeg first: imageio fails, and the port says why."""
    path = TEX / "jpeg_arith_1024_past_64k.jpg"
    with pytest.raises(OSError):
        imageio.imread(path)
    with pytest.raises(ValueError, match="64 KiB"):
        native.jpeg_decode(path.read_bytes())


# ---------------------------------------------------------- block smoothing
@pytest.mark.parametrize("sub", [0, 1, 2])
def test_block_smoothing_after_each_scan(tmp_path, sub):
    """Pillow's progressive files (4:4:4, 4:2:2, 4:2:0; sizes off the MCU
    grid) cut after every scan, the DC-only one first: libjpeg's block
    smoothing (the 5 x 5 DC neighbourhood, the latched coefficient bits)
    to the bit."""
    rgb = MAKE.textured(45, 51, 30 + sub)
    data = MAKE.pil_bytes(rgb, "JPEG", quality=85, subsampling=sub,
                          progressive=True)
    n = data.count(b"\xff\xda")
    for k in range(1, n):
        cut = MAKE.first_scans(data, k)
        want = _imageio(cut, tmp_path, "x.jpg")
        assert _same(native.jpeg_decode(cut), want), k


@pytest.mark.parametrize("h, w", [(8, 8), (16, 40), (23, 9), (57, 33)])
def test_block_smoothing_dc_only_sizes(tmp_path, h, w):
    """A DC-only progressive file (the generator's arithmetic coder and
    Pillow's Huffman one) at sizes that exercise the edge rows and columns
    of the 5 x 5 window and libjpeg's last-iMCU-row arithmetic."""
    rgb = MAKE.textured(h, w, h + w)
    huff = MAKE.first_scans(MAKE.pil_bytes(rgb, "JPEG", quality=75,
                                           subsampling=2, progressive=True),
                            1)
    arith = MAKE.jpeg_encode(MAKE.ycbcr(rgb), [(2, 2), (1, 1), (1, 1)],
                             coding="arithmetic", progressive=True,
                             scans=MAKE.PROGRESSION[:1])
    for data in (huff, arith):
        want = _imageio(data, tmp_path, "x.jpg")
        assert _same(native.jpeg_decode(data), want)


# ------------------------------------------------------------ lossless JPEG
@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_predictors(tmp_path, psv):
    """Each predictor, with and without a point transform and restarts,
    grey and RGB: libjpeg-turbo's samples."""
    rgb = MAKE.textured(19, 23, psv)
    for samples, pt, rows in ((rgb[..., :1], 0, 0), (rgb, psv % 4, 3)):
        data = MAKE.jpeg_lossless(samples, psv, pt=pt, restart_rows=rows)
        want = _imageio(data, tmp_path, "x.jpg")
        assert _same(native.jpeg_decode(data), want)


# --------------------------------------------------------------------- BCn
def _dds_pillow(data: bytes) -> np.ndarray:
    arr = np.asarray(Image.open(io.BytesIO(data)))
    return arr if arr.ndim == 3 else arr[..., None]


@pytest.mark.parametrize("mode", range(9))
def test_bc7_each_mode(mode):
    """BC7 mode 0-7 (partitions, p-bits, rotation, index selection) and
    the reserved mode 8, on random blocks at 37 x 29."""
    blocks = MAKE.bc_blocks(80, 16, 200 + mode, [MAKE.BC7_MODES[mode]])
    data = MAKE.dds_file(37, 29, blocks, dxgi=98)
    assert _same(F.decode_image(data, "x.dds"), _dds_pillow(data))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("mode", range(16))
def test_bc6h_each_mode(mode, signed):
    """BC6H's 14 modes (delta and plain endpoints, 1 or 2 subsets) and two
    reserved ones, unsigned and signed, to Pillow's 8-bit output."""
    blocks = MAKE.bc_blocks(40, 16, 300 + mode, [MAKE.BC6_MODES[mode]])
    data = MAKE.dds_file(22, 13, blocks, dxgi=96 if signed else 95)
    assert _same(F.decode_image(data, "x.dds"), _dds_pillow(data))


@pytest.mark.parametrize("fourcc, size", [
    (b"DXT1", 8), (b"DXT3", 16), (b"DXT5", 16), (b"ATI1", 8), (b"BC4U", 8),
    (b"ATI2", 16), (b"BC5U", 16), (b"BC5S", 16)])
def test_bc1_to_bc5(fourcc, size):
    """BC1 (both colour modes), BC2, BC3, BC4 and BC5, unsigned and
    signed, on random blocks at 5 x 7."""
    data = MAKE.dds_file(5, 7, MAKE.bc_blocks(4, size, size), fourcc)
    assert _same(F.decode_image(data, "x.dds"), _dds_pillow(data))


# --------------------------------------------------------------------- QOI
@pytest.mark.parametrize("seed", range(6))
def test_qoi_random_ops(tmp_path, seed):
    """Random op streams (RGB, RGBA, index, diff, luma, runs) at 3 and 4
    channels and odd sizes: Pillow's pixels."""
    rng = np.random.default_rng(seed)
    W, H = (int(v) for v in rng.integers(1, 30, 2))
    data = MAKE.qoi_ops(W, H, seed, channels=3 + seed % 2,
                        colorspace=seed % 2)
    assert _same(F.decode_image(data, "x.qoi"),
                 _imageio(data, tmp_path, "x.qoi"))


# --------------------------------------------------------------------- PNM
@pytest.mark.parametrize("magic, maxval", [
    (b"P2", 7), (b"P2", 255), (b"P2", 300), (b"P2", 65535), (b"P3", 99),
    (b"P5", 31), (b"P5", 255), (b"P5", 256), (b"P5", 65535), (b"P6", 15),
    (b"P6", 255), (b"P6", 40000)])
def test_pnm_maxval_classes(tmp_path, magic, maxval):
    """Plain and raw grey and colour at maxvals below, at and past 255
    (Pillow's rounding half to even, mode "I" for grey past 8 bits), the
    header's comments included: imageio's array."""
    rng = np.random.default_rng(maxval)
    bands = 3 if magic in (b"P3", b"P6") else 1
    v = rng.integers(0, maxval + 1, (7, 5, bands))
    head = magic + b"\n# a comment\n5 7 # w h\n%d\n" % maxval
    if magic in (b"P2", b"P3"):
        body = " ".join(str(x) for x in v.ravel()).encode()
    else:
        body = v.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
    data = head + body
    want = _imageio(data, tmp_path, "x.ppm" if bands == 3 else "x.pgm")
    assert _same(F.decode_image(data, "x.pgm"), want)


@pytest.mark.parametrize("name", ["x.pbm", "x.pnm"])
@pytest.mark.parametrize("magic", [b"P1", b"P4"])
def test_pnm_bitmaps_by_name(tmp_path, name, magic):
    """A bitmap named .pbm (OpenCV: 0 / 255 RGB) and .pnm (Pillow:
    bool)."""
    bits = np.random.default_rng(5).integers(0, 2, (6, 11)).astype(bool)
    if magic == b"P1":
        data = b"P1\n11 6\n" + "\n".join(
            " ".join(str(int(b)) for b in row) for row in bits).encode() + \
            b"\n"
    else:
        data = b"P4\n11 6\n" + np.packbits(bits, axis=1).tobytes()
    want = _imageio(data, tmp_path, name)
    got = F.decode_image(data, name)
    if want.dtype == bool:
        assert np.array_equal(got[..., 0] == 255, want)
    else:
        assert _same(got, want)


@pytest.mark.parametrize("scale", [-1.0, 1.0, -3.0])
@pytest.mark.parametrize("magic", [b"Pf", b"PF"])
def test_pfm_through_opencv(tmp_path, magic, scale):
    """A float map named .pfm (OpenCV: divided by the scale's magnitude,
    rounded half to even, saturated, NaN and infinities as 0)."""
    rng = np.random.default_rng(int(abs(scale) * 10) + len(magic))
    ch = 3 if magic == b"PF" else 1
    v = rng.uniform(-20, 300, (6, 7, ch)).astype(np.float32)
    v[0, :3, 0] = [np.nan, np.inf, 2.5]
    data = magic + b"\n7 6\n%g\n" % scale + v.astype(
        "<f4" if scale < 0 else ">f4").tobytes()
    assert _same(F.decode_image(data, "x.pfm"),
                 _imageio(data, tmp_path, "x.pfm"))


def _both(data: bytes, tmp_path: Path, name: str):
    """imageio's array of the file, or None where imageio refuses it; and
    the port's samples, or None where it raises ``ValueError``."""
    try:
        want = _imageio(data, tmp_path, name)
    except Exception:
        want = None
    try:
        got = F.decode_image(data, name)
    except ValueError:
        got = None
    return want, got


def _plain(values) -> bytes:
    return " ".join(str(int(v)) for v in np.ravel(values)).encode() + b"\n"


_CV_MAXVALS = [1, 100, 255, 256, 4095, 65535]


@pytest.mark.parametrize("ext", ["pbm", "pfm"])
@pytest.mark.parametrize("magic", [b"P2", b"P3", b"P5", b"P6"])
@pytest.mark.parametrize("maxval", _CV_MAXVALS)
def test_pnm_through_opencv_by_name(tmp_path, ext, magic, maxval):
    """P2, P3, P5 and P6 named .pbm or .pfm, which imageio hands to
    OpenCV, at maxvals below, at and past 255 (a comment in the header;
    plain samples past the maxval, which OpenCV clamps; raw 8-bit ones past
    it, which it keeps): imageio's (H, W, 3) uint8, to the bit."""
    rng = np.random.default_rng(maxval * 7 + magic[1])
    bands = 3 if magic in (b"P3", b"P6") else 1
    top = 255 if maxval < 256 else 65535
    v = rng.integers(0, min(top, 2 * maxval) + 1, (5, 6, bands))
    head = magic + b"\n# OpenCV skips this\n6 5\n%d\n" % maxval
    body = _plain(v) if magic in (b"P2", b"P3") else v.astype(
        np.uint8 if maxval < 256 else ">u2").tobytes()
    want, got = _both(head + body, tmp_path, "x." + ext)
    assert want is not None and want.shape == (5, 6, 3)
    assert got is not None and _same(got, want)


@pytest.mark.parametrize("data", [
    b"P1\n5 2\n0123456789", b"P1 5 2 0 1 0 1 1\n1 1 0 0 0\n",
    b"P4\n9 2\n\xa5\x80\x5a\x00", b"P5\n3 1\n255\n\x01\x02",
    b"P2\n2 1\n1000\n5 999", b"P2\n2 1\n1000\n5 999\n",
    b"P5 2 1 0\n\x01\x02", b"P5 2 1 70000\n\x01\x02",
    b"P6\n#\n1 1\n255\n\x01\x02\x03", b"P3\n1 1\n255\n1 x 3\n",
    b"P5\n0 1\n255\n\x01", b"P5\n2000000 1\n255\n\x01",
    b"Pf\n2 1\n-1.0\n" + np.float32([1.5, 300]).tobytes(),
    b"Pf 2 1 -1.0\n" + np.float32([1.5, 300]).tobytes(),
    b"Pf\n2  1\n-1.0\n" + np.float32([1.5, 300]).tobytes(),
    b"Pf\n2 1\ninf\n" + np.float32([1.5, 300]).tobytes(),
    b"Pf\n2 1\n0\n" + np.float32([1.5, 300]).tobytes(),
    b"Pf\n2 1\n-2.5e0x\n" + np.float32([7.5, 300]).tobytes(),
    b"PF\n1 1\n-4\n" + np.float32([2, 10, 1022]).tobytes()],
    ids=range(19))
@pytest.mark.parametrize("ext", ["pbm", "pfm"])
def test_opencv_headers_and_ends(tmp_path, data, ext):
    """OpenCV's readers of headers and data, byte by byte: a bitmap's
    digits one at a time, a number at the very end of the file (OpenCV
    reads a byte past it and fails), maxval 0 and past 65535, a comment at
    the end of the header, a byte that is not a number, OpenCV's size
    limits, a float map's line feed, empty fields, infinite, zero and
    suffixed scales: the port reads what imageio reads, to the bit, and
    raises where it raises."""
    want, got = _both(data, tmp_path, "x." + ext)
    assert (want is None) == (got is None)
    if want is not None:
        assert _same(got, want)


@pytest.mark.parametrize("name", ["x.ppm", "x.pbm", "x.pgm"])
@pytest.mark.parametrize("magic, maxval", [
    (b"P0CMYK", 255), (b"PyCMYK", 100), (b"PyCMYK", 1000),
    (b"PyRGBA", 255), (b"PyRGBA", 40000), (b"PyP", 255)])
def test_pillow_ppm_extensions(tmp_path, name, magic, maxval):
    """Pillow's own magics, which OpenCV does not know, whatever the name:
    CMYK (made RGB by Pillow's formula, as every CMYK texture) and RGBA at
    maxvals that Pillow rescales, and ``PyP``, on which imageio raises."""
    rng = np.random.default_rng(maxval + magic[1])
    v = rng.integers(0, maxval + 1, (4, 5, 1 if magic == b"PyP" else 4))
    data = magic + b"\n5 4\n%d\n" % maxval + v.astype(
        np.uint8 if maxval < 256 else ">u2").tobytes()
    want, got = _both(data, tmp_path, name)
    if magic == b"PyP":
        assert want is None and got is None
        with pytest.raises(ValueError, match="PyP"):
            F.decode_image(data, name)
        return
    if magic != b"PyRGBA":
        want = np.asarray(Image.fromarray(want, "CMYK").convert("RGB"))
    assert got is not None and _same(got, want)


def _pam(depth, maxval, tuple_type, body, head=b""):
    return (b"P7\n" + head + b"WIDTH 11\nHEIGHT 3\nDEPTH %d\nMAXVAL %d\n"
            % (depth, maxval) + (b"TUPLTYPE " + tuple_type + b"\n"
                                 if tuple_type else b"") + b"ENDHDR\n" + body)


@pytest.mark.parametrize("name", ["x.pbm", "x.ppm"])
@pytest.mark.parametrize("tuple_type", [None, b"GRAYSCALE", b"RGB",
                                        b"BLACKANDWHITE"])
@pytest.mark.parametrize("depth, maxval", [
    (1, 1), (1, 7), (1, 255), (1, 65535), (3, 1), (3, 200), (3, 65535)])
def test_pam_through_opencv(tmp_path, name, tuple_type, depth, maxval):
    """PAM (P7), which imageio hands to OpenCV under any name: grey and
    colour, 8 and 16 bits, maxval 1's bits, with and without a tuple type
    (which must match the depth): the port reads what imageio reads, to
    the bit, and raises where it raises."""
    rng = np.random.default_rng(depth * 100000 + maxval)
    v = rng.integers(0, 256 if maxval == 1 else maxval + 1, (3, 11, depth))
    data = _pam(depth, maxval, tuple_type, v.astype(
        ">u2" if maxval > 255 else np.uint8).tobytes())
    want, got = _both(data, tmp_path, name)
    assert (want is None) == (got is None)
    if want is not None:
        assert _same(got, want)


@pytest.mark.parametrize("data", [
    _pam(1, 255, None, bytes(33), b"# a comment\n\n  \n"),
    b"P7\r" + _pam(1, 255, None, bytes(33))[3:],
    b"P7 " + _pam(1, 255, None, bytes(33))[3:],
    _pam(1, 255, b"GRAYSCALE  ", bytes(33)),
    _pam(1, 255, None, bytes(20)), _pam(1, 255, None, bytes(33), b"WIDTH 3\n"),
    _pam(1, 255, None, bytes(33), b"FOO 1\n"),
    _pam(1, 255, b"FOO", bytes(33)),
    _pam(1, 255, None, bytes(33)).replace(b"MAXVAL 255", b"MAXVAL 0xff"),
    _pam(1, 255, None, bytes(33)).replace(b"MAXVAL 255", b"MAXVAL 255x")],
    ids=range(10))
def test_pam_headers(tmp_path, data):
    """OpenCV's PAM header: comments and blank lines, a CR after the magic
    (a space is refused), trailing spaces, data cut short, a field twice,
    unknown fields and tuple types, values that are not decimal."""
    want, got = _both(data, tmp_path, "x.pbm")
    assert (want is None) == (got is None)
    if want is not None:
        assert _same(got, want)


@pytest.mark.parametrize("depth, tuple_type", [(2, b"GRAYSCALE_ALPHA"),
                                               (4, b"RGB_ALPHA")])
def test_pam_with_alpha_raises_naming_it(depth, tuple_type):
    """Depths 2 and 4: OpenCV converts the first W / 2 or W / 4 pixels of
    each row and leaves the rest of its image unset, so imageio's pixels
    are not the file's; the port raises, naming the depth."""
    data = _pam(depth, 255, tuple_type, bytes(33 * depth))
    with pytest.raises(ValueError, match=f"depth {depth}"):
        F.decode_image(data, "x.ppm")


def test_psd_raises_naming_it():
    """imageio reads no PSD; the port says so."""
    data = (TEX / "psd_rgb_rle.psd").read_bytes()
    with pytest.raises(ValueError, match="PSD"):
        F.decode_image(data, "x.psd")
    assert struct.unpack(">H", data[12:14])[0] == 3
