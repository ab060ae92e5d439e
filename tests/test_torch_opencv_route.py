"""The textures imageio hands to OpenCV: the port's ``read_image`` follows
imageio's choice of plugin (``image_files.imageio_route``,
``image_files.opencv_reads``) and reads what OpenCV reads as OpenCV does
(``viz/opencv_read.py``, ``viz/radiance.py``, ``viz/sunraster.py``).

* the route against imageio's own extension table and plugin order, and
  the content check against ``cv2.haveImageReader``;
* every fixture of ``tests/torch_textures/`` copied under ``.pbm`` and
  ``.hdr``: the port's ``load_obj_mesh`` against the JAX package's on every
  key, to the bit (CCITT and SGILog TIFFs among them, read through
  libtiff's codecs), or both refusing; one fixture of each format under
  ``.pfm``, ``.pic``, ``.sr``, ``.pxm`` and ``.exr``; the Radiance HDR and
  Sun raster fixtures under their own names and under ``.png``, ``.ras``,
  an unknown name, ``.sr``, ``.pbm`` and ``.hdr``; the manifest's
  ``opencv_route`` and ``route_files`` reads against what imageio reads
  now;
* OpenCV's rules on crafted files, against imageio: EXIF orientation,
  Radiance headers and scanlines, Sun raster types, BMP bitfields and
  run-length codes, GIF canvases, libtiff's LZW, YCbCr, CIELab, alpha and
  CMYK, lossless JPEG; the host library's Radiance run-length expansion
  against a plain Python version on random streams.

The host libraries are built with g++ on first use; no card is needed.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import struct
from pathlib import Path

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from imageio.config import known_extensions, known_plugins

from neural_marionette_tpu.apps import retarget as JRT
from neural_marionette_tpu_torch.apps import retarget as PRT
from neural_marionette_tpu_torch.data import native
from neural_marionette_tpu_torch.viz import image_files as F

TEX = Path(__file__).resolve().parent / "torch_textures"
_MANIFEST = json.loads((TEX / "MANIFEST.json").read_text())
FILES = _MANIFEST["files"]
ROUTE_FILES = _MANIFEST["route_files"]
_spec = importlib.util.spec_from_file_location("make_textures",
                                               TEX / "make_textures.py")
MAKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(MAKE)


def _imageio(data: bytes, tmp_path: Path, name: str):
    """imageio's array of ``data`` named ``name``, or None where it
    refuses the file."""
    path = tmp_path / name
    path.write_bytes(data)
    try:
        return np.asarray(imageio.imread(path))
    except Exception:
        return None


def _port(data: bytes, name: str):
    try:
        return F.decode_image(data, name)
    except ValueError:
        return None


def _same(got, want) -> bool:
    """The port's samples against imageio's: a 2-D array is (H, W, 1) in
    the port and a bitmap 0 and 255."""
    if got is None or want is None:
        return got is None and want is None
    if want.dtype == np.bool_:
        want = want.astype(np.uint8) * np.uint8(255)
    return got.dtype == want.dtype and got.size == want.size and \
        np.array_equal(got.reshape(want.shape), want)


def _write_obj(root: Path, data: bytes, name: str) -> Path:
    """A UV-mapped quad whose MTL names ``data`` saved as ``name``."""
    root.mkdir(parents=True, exist_ok=True)
    (root / name).write_bytes(data)
    (root / "target.obj").write_text(
        "mtllib target.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0.5\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "f 1/1 2/2 3/3 4/4\n")
    (root / "target.mtl").write_text(f"newmtl m\nmap_Kd {name}\n")
    return root / "target.obj"


# ----------------------------------------------------------------- route
def _imageio_order(ext: str) -> tuple:
    """imageio's own order of the installed plugins for ``ext``: its
    extension's formats (a legacy "-PIL" format is Pillow's, "TIFF"
    tifffile's), then the fallback over ``known_plugins``."""
    def plugin(name):
        if name in ("pillow", "tifffile", "opencv"):
            return name
        return "pillow" if name.endswith("-PIL") else \
            "tifffile" if name == "TIFF" else None
    order = []
    for fmt in known_extensions.get(ext, ()):
        for name in fmt.priority:
            p = plugin(name)
            if p and p not in order:
                order.append(p)
    for name in known_plugins:
        p = plugin(name)
        if p and p not in order:
            order.append(p)
    return tuple(order)


@pytest.mark.parametrize("ext", sorted(known_extensions) + [".xyz", ".PBM",
                                                           ".Hdr"])
def test_route_is_imageios_extension_list(ext):
    """``imageio_route`` against imageio's extension table, extension by
    extension (an imageio upgrade that moves a plugin shows here)."""
    assert F.imageio_route("texture" + ext) == _imageio_order(ext.lower())


def test_route_without_extension_is_the_fallback():
    """No extension: the fallback over every plugin, in
    ``known_plugins``' order."""
    assert F.imageio_route("texture") == _imageio_order("") == \
        ("pillow", "opencv", "tifffile")
    assert F.imageio_route("dir.v2/texture.tar.pbm")[0] == "opencv"


_SIGNATURES = {
    "bmp": b"BM" + bytes(60), "hdr": b"#?RADIANCE\n", "rgbe": b"#?RGBE\n",
    "hdr_near": b"#?RADIANCX\n", "jpeg": b"\xff\xd8\xff\xe0" + bytes(40),
    "png": F.PNG_SIGNATURE + bytes(40), "gif87": b"GIF87a" + bytes(40),
    "gif89": b"GIF89a" + bytes(40),
    "webp": b"RIFF\x24\x00\x00\x00WEBPVP8 " + bytes(40),
    "webp_short": b"RIFF\x10\x00\x00\x00WEBPVP8 " + bytes(8),
    "p1": b"P1\n", "p6": b"P6 ", "p7": b"P7\n", "pf": b"PF\n",
    "pf_grey": b"Pf\r", "p8": b"P8\n", "p6_nospace": b"P6x",
    "sun": b"\x59\xa6\x6a\x95" + bytes(40),
    "tiff_le": b"II*\x00" + bytes(40), "tiff_be": b"MM\x00*" + bytes(40),
    "bigtiff": b"II+\x00" + bytes(40),
    "jp2": b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(40),
    "j2k": b"\xff\x4f\xff\x51" + bytes(40),
    "avif": b"\x00\x00\x00\x14ftypavif\x00\x00\x00\x00avif",
    "webp_vp8l": b"RIFF\x24\x00\x00\x00WEBPVP8L\x10\x00\x00\x00\x2f"
                 + bytes(20),
    "webp_vp8l_version": b"RIFF\x24\x00\x00\x00WEBPVP8L\x10\x00\x00\x00"
                         b"\x2f\x00\x00\x00\x20" + bytes(20),
    "webp_vp8x": b"RIFF\x24\x00\x00\x00WEBPVP8X\x0a\x00\x00\x00"
                 + bytes(20),
    "webp_vp8": b"RIFF\x24\x00\x00\x00WEBPVP8 \x18\x00\x00\x00\x50\x01"
                b"\x00\x9d\x01\x2a\x05\x00\x03\x00" + bytes(20),
    "exr": b"\x76\x2f\x31\x01" + bytes(40), "dds": b"DDS " + bytes(124),
    "qoi": b"qoif" + bytes(20), "psd": b"8BPS" + bytes(40),
    "p0cmyk": b"P0CMYK 1 1 255\n", "tga": bytes(18) + bytes(4),
}


@pytest.mark.parametrize("case", sorted(_SIGNATURES))
def test_opencv_reads_is_have_image_reader(tmp_path, case):
    """``opencv_reads`` against ``cv2.haveImageReader`` on the first bytes
    of each of OpenCV's formats and their near misses."""
    path = tmp_path / "texture.pbm"
    path.write_bytes(_SIGNATURES[case])
    assert F.opencv_reads(_SIGNATURES[case]) == cv2.haveImageReader(
        str(path))


# -------------------------------------------------- fixtures under OpenCV
def _texture_under(tmp_path, entry, ext):
    """(the port's mesh, the JAX mesh) of a quad textured with the fixture
    copied under ``ext``; None where that side raises."""
    data = (TEX / entry["file"]).read_bytes()
    obj = _write_obj(tmp_path, data, "texture" + ext)
    try:
        p = PRT.load_obj_mesh(str(obj))
    except ValueError as e:
        p = e
    try:
        j = JRT.load_obj_mesh(str(obj))
    except Exception:
        j = None
    return p, j


@pytest.mark.parametrize("ext", [".pbm", ".hdr"])
@pytest.mark.parametrize("entry", FILES, ids=[e["file"] for e in FILES])
def test_fixture_under_opencv_name_reads_like_jax(tmp_path, entry, ext):
    """Every fixture copied under ``.pbm`` and ``.hdr``: where OpenCV reads
    it (imageio's array is RGB uint8; the CCITT and SGILog TIFFs among
    them), the port's mesh is the JAX mesh on every key, to the bit; where
    imageio refuses it, so does the port;
    where Pillow reads it (content OpenCV does not take), the port's
    texture is the one it reads under the fixture's own name, under the
    rules of ``texture_rgb``."""
    read = entry["opencv_route"][ext]
    p, j = _texture_under(tmp_path, entry, ext)
    if "raises" in read:
        assert isinstance(p, ValueError), "imageio refuses it"
        assert j is None
        return
    assert not isinstance(p, ValueError), p
    assert set(p) == set(j)
    rgb = read["dtype"] == "uint8" and len(read["shape"]) == 3 and \
        read["shape"][-1] == 3
    for key in j:
        if key == "texture" and not rgb:
            continue
        assert j[key].dtype == p[key].dtype, key
        assert np.array_equal(j[key], p[key]), key
    if not rgb:
        own = PRT.texture_rgb(F.read_image(str(TEX / entry["file"])))
        assert np.array_equal(p["texture"], own) or read["opencv_reads"]
        if read["opencv_reads"]:     # OpenCV's grey float map: one channel
            assert read["shape"] == list(p["texture"].shape[:2])


_PER_FORMAT = ["png_rgb8.png", "png_palette8_trns.png",
               "jpeg_baseline_420.jpg", "jpeg_exif_orientation6.jpg",
               "jpeg_cmyk.jpg", "bmp_rle8_delta.bmp", "bmp_16bit_555.bmp",
               "gif_transparent_interlaced.gif", "tiff_rgb_lzw.tif",
               "tiff_ycbcr_subsampled.tif", "tiff_jpeg.tif",
               "tiff_cielab_pillow.tif", "webp_lossy_rgba.webp",
               "jpeg2000_ycbcr.jp2", "jpeg2000_pclr_300.jp2",
               "pbm_rgb_raw16.pbm", "pfm_grey.pfm", "pam_rgb.ppm",
               "hdr_rle_opencv.hdr", "sun_24bit_bgr.ras"]


@pytest.mark.parametrize("ext", [".pfm", ".pic", ".sr", ".pxm", ".exr"])
@pytest.mark.parametrize("name", _PER_FORMAT)
def test_each_format_under_the_other_opencv_names(tmp_path, name, ext):
    """One fixture of each format under the other names imageio gives to
    OpenCV first: the port's samples are imageio's."""
    data = (TEX / name).read_bytes()
    want = _imageio(data, tmp_path, "texture" + ext)
    assert want is not None
    assert _same(_port(data, "texture" + ext), want)


@pytest.mark.parametrize("ext", MAKE.ROUTE_NAMES)
@pytest.mark.parametrize("entry", ROUTE_FILES,
                         ids=[e["file"] for e in ROUTE_FILES])
def test_radiance_and_sun_raster_under_every_name(tmp_path, entry, ext):
    """The Radiance HDR and Sun raster fixtures under their own names and
    under Pillow's (.ras, .png, an unknown one) and OpenCV's (.sr, .pbm,
    .hdr): the port's samples are imageio's, or both refuse, the port
    naming imageio's reason; the texture of an RGB read is the JAX
    texture, to the bit."""
    data = (TEX / entry["file"]).read_bytes()
    want = _imageio(data, tmp_path, "texture" + ext)
    if want is None:
        with pytest.raises(ValueError) as err:
            F.decode_image(data, "texture" + ext)
        if "raises" in entry:
            assert entry["raises"] in str(err.value)
        return
    got = F.decode_image(data, "texture" + ext)
    assert _same(got, want)
    if want.ndim == 3 and want.dtype == np.uint8:
        obj = _write_obj(tmp_path / "obj", data, "texture" + ext)
        p, j = PRT.load_obj_mesh(str(obj)), JRT.load_obj_mesh(str(obj))
        assert np.array_equal(p["texture"], j["texture"])


@pytest.mark.parametrize("entry", FILES + ROUTE_FILES,
                         ids=[e["file"] for e in FILES + ROUTE_FILES])
def test_manifest_route_reads_are_what_imageio_reads(tmp_path, entry):
    """The fixtures stay honest: imageio still gives the manifest's array
    (shape, type, SHA-256) or refuses, under each name it records, and
    OpenCV's check still takes the bytes it records."""
    data = (TEX / entry["file"]).read_bytes()
    reads = entry.get("opencv_route") or entry["reads"]
    for ext, read in reads.items():
        path = tmp_path / ("texture" + ext)
        path.write_bytes(data)
        assert cv2.haveImageReader(str(path)) == read["opencv_reads"]
        assert F.opencv_reads(data) == read["opencv_reads"]
        arr = _imageio(data, tmp_path, "texture" + ext)
        if "raises" in read:
            assert arr is None, ext
            continue
        assert list(arr.shape) == read["shape"] and str(arr.dtype) == \
            read["dtype"]
        assert hashlib.sha256(arr.tobytes()).hexdigest() == read["sha256"]


# --------------------------------------------------------- OpenCV's rules
def _exif(orientation: int, order: str = "<") -> bytes:
    head = b"II*\x00" if order == "<" else b"MM\x00*"
    return head + struct.pack(order + "IH", 8, 1) + struct.pack(
        order + "HHIHH", 0x112, 3, 1, orientation, 0) + struct.pack(
        order + "I", 0)


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("fmt", ["JPEG", "PNG", "WEBP", "TIFF"])
def test_exif_orientation(tmp_path, fmt, order):
    """Orientations 0-9 in an EXIF block (a JPEG APP1, a PNG eXIf chunk, a
    WebP EXIF chunk, a TIFF Orientation tag), both byte orders: the
    port's rotation is OpenCV's."""
    rgb = MAKE.textured(5, 7, 11)
    for o in range(10):
        exif = _exif(o, order)
        kw = {"JPEG": dict(quality=100, exif=b"Exif\x00\x00" + exif),
              "WEBP": dict(lossless=True, exif=exif)}.get(fmt, {"exif": exif})
        data = MAKE.pil_bytes(rgb, fmt, **kw)
        assert _same(_port(data, "x.pbm"), _imageio(data, tmp_path, "x.pbm"))


_RADIANCE_HEADS = {
    "plain": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 4 +X 9\n",
    "rgbe": b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y 4 +X 9\n",
    "nul_line": b"#?RADIANCE\n\x00x\nFORMAT=32-bit_rle_rgbe\n\n-Y 4 +X 9\n",
    "format_twice": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\nFORMAT=32-bit_rle"
                    b"_xyze\n\n-Y 4 +X 9\n",
    "xyze_first": b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\nFORMAT=32-bit_rle_"
                  b"rgbe\n\n-Y 4 +X 9\n",
    "format_space": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe \n\n-Y 4 +X 9\n",
    "format_split": b"#?RADIANCE\n" + b"Y" * 127 + b"FORMAT=32-bit_rle_rgbe"
                    b"\n\n-Y 4 +X 9\n",
    "format_on_first": b"#?RGBEFORMAT=32-bit_rle_rgbe\n\n-Y 4 +X 9\n",
    "blank_first": b"#?RADIANCE\n\nFORMAT=32-bit_rle_rgbe\n\n-Y 4 +X 9\n",
    "long_size": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 4 +X 9" +
                 b" " * 130 + b"\n",
    "size_swapped": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+X 9 -Y 4\n",
    "size_tight": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y4+X9\n",
    "size_negative": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y -4 +X 9\n",
    "crlf": b"#?RADIANCE\r\nFORMAT=32-bit_rle_rgbe\r\n\r\n-Y 4 +X 9\r\n",
    "header_only": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n",
}


@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("head", sorted(_RADIANCE_HEADS))
def test_radiance_headers(tmp_path, head, rle):
    """Radiance headers line by line as OpenCV's RGBE reader takes them,
    over flat and run-length scanlines of random RGBE pixels (exponents
    0 and past the int range included)."""
    rng = np.random.default_rng(len(head))
    px = rng.integers(0, 256, (4, 9, 4), dtype=np.uint8)
    px[..., 3] = rng.integers(118, 140, (4, 9))
    px[0, 0, 3], px[1, 1, 3] = 0, 200
    body = b"".join(MAKE.hdr_rle_line(px[y]) for y in range(4)) if rle \
        else px.tobytes()
    data = _RADIANCE_HEADS[head] + body
    assert _same(_port(data, "x.hdr"), _imageio(data, tmp_path, "x.hdr"))


def _rle_reference(src: bytes, W: int, H: int):
    """rgbe.cpp's RGBE_ReadPixels_RLE in plain Python: (pixels, bytes
    read), or the error's code."""
    out, pos = bytearray(), 0
    if W < 8 or W > 0x7FFF:
        return (bytes(src[:W * H * 4]), W * H * 4) \
            if len(src) >= W * H * 4 else -1
    for y in range(H):
        if len(src) - pos < 4:
            return -1
        if src[pos] != 2 or src[pos + 1] != 2 or src[pos + 2] & 0x80:
            need = (H - y) * W * 4
            if len(src) - pos < need:
                return -1
            return bytes(out) + bytes(src[pos:pos + need]), pos + need
        if (src[pos + 2] << 8 | src[pos + 3]) != W:
            return -2
        pos += 4
        chans = []
        for _ in range(4):
            line = bytearray()
            while len(line) < W:
                if len(src) - pos < 2:
                    return -1
                count, value = src[pos], src[pos + 1]
                pos += 2
                if count > 128:
                    if count - 128 > W - len(line):
                        return -3
                    line += bytes([value]) * (count - 128)
                else:
                    if count == 0 or count > W - len(line):
                        return -3
                    line.append(value)
                    if len(src) - pos < count - 1:
                        return -1
                    line += src[pos:pos + count - 1]
                    pos += count - 1
            chans.append(line)
        out += bytes(np.stack([np.frombuffer(c, np.uint8) for c in chans],
                              -1).tobytes())
    return bytes(out), pos


@pytest.mark.parametrize("seed", range(12))
def test_hdr_unrle_against_plain_python(seed):
    """The host library's Radiance expansion against ``_rle_reference``:
    valid run-length images at widths 8-40 and then every prefix and a
    flipped byte of each; random bytes; narrow (flat) widths."""
    rng = np.random.default_rng(seed)
    W, H = int(rng.integers(8, 41)), int(rng.integers(1, 6))
    px = rng.integers(0, 4, (H, W, 4), dtype=np.uint8) * 60
    data = b"".join(MAKE.hdr_rle_line(px[y]) for y in range(H))
    cases = [data, data[:len(data) // 2], bytes(rng.integers(
        0, 256, 300, dtype=np.uint8))]
    flipped = bytearray(data)
    flipped[int(rng.integers(0, len(data)))] ^= 0x81
    cases.append(bytes(flipped))
    for src in cases:
        want = _rle_reference(src, W, H)
        try:
            got, n = native.hdr_unrle(src, W, H)
        except ValueError as e:
            assert isinstance(want, int), e
            assert native._HDR_ERRORS[want] in str(e)
            continue
        assert not isinstance(want, int)
        assert got.tobytes() == want[0] and n == want[1]
    narrow, _ = native.hdr_unrle(px.tobytes()[:4 * 5 * H], 5, H)
    assert narrow.tobytes() == px.tobytes()[:4 * 5 * H]


_SUN_CASES = [(d, k, m) for d in (1, 4, 8, 24, 32) for k in (0, 1, 2, 3, 5)
              for m in ("none", "short", "full", "type2")]


@pytest.mark.parametrize("depth,kind,cmap", _SUN_CASES)
def test_sun_raster_variants(tmp_path, depth, kind, cmap):
    """Sun raster headers of every depth, type and colour map, at an odd
    width, under OpenCV's name (.sr) and Pillow's (.ras): the port's
    samples are imageio's, or both refuse."""
    rng = np.random.default_rng(depth * 10 + kind)
    W, H = 7, 3
    if kind == 2:
        rows = MAKE.sun_rle(np.repeat(rng.integers(0, 250, (H, 4), np.uint8),
                                      4, 1)[:, :W * max(1, depth // 8)]
                            .tobytes()) if depth >= 8 else bytes(
            rng.integers(0, 127, H * 2, dtype=np.uint8))
    else:
        rows = bytes(rng.integers(0, 256, H * ((W * depth + 15) // 16 * 2),
                                  dtype=np.uint8))
    table = {"none": b"", "short": bytes(rng.integers(0, 256, 12,
                                                      dtype=np.uint8)),
             "full": bytes(rng.integers(0, 256, 3 << min(depth, 8),
                                        dtype=np.uint8)),
             "type2": bytes(6)}[cmap]
    data = MAKE.sun_file(W, H, depth, rows, kind=kind, cmap=table,
                         map_type=2 if cmap == "type2" else None)
    for ext in (".sr", ".ras"):
        assert _same(_port(data, "x" + ext), _imageio(data, tmp_path,
                                                       "x" + ext)), ext


def _bmp(bits, hsize, masks, rows, W, H, comp=3, used=0, palette=b""):
    head = struct.pack("<IiiHHIIiiII", hsize, W, H, 1, bits, comp, len(rows),
                       2835, 2835, used, 0)
    head += (struct.pack("<4I", *(tuple(masks) + (0,) * 4)[:4])
             + bytes(100))[:hsize - 40]
    off = 14 + hsize + len(palette)
    return b"BM" + struct.pack("<IHHI", off + len(rows), 0, 0, off) + head \
        + palette + rows


@pytest.mark.parametrize("hsize", [40, 52, 56, 108, 124])
def test_bmp_bitfields(tmp_path, hsize):
    """32-bit bitfields (read from a header of 56 bytes or more, scaled
    fields; ignored below) and 16-bit ones (read after the header: 5-5-5
    and 5-6-5 alone) at each header size."""
    rng = np.random.default_rng(hsize)
    W, H = 5, 3
    px32 = rng.integers(0, 2 ** 32, (H, W), dtype=np.uint64).astype(
        np.uint32).tobytes()
    px16 = b"".join(rng.integers(0, 2 ** 16, W, dtype=np.uint16).tobytes()
                    + bytes(2) for _ in range(H))
    for masks in [(0xFF0000, 0xFF00, 0xFF, 0), (0xFF, 0xFF00, 0xFF0000, 0),
                  (0x3FF00000, 0xFFC00, 0x3FF, 0), (0xF000, 0xF00, 0xF0, 0),
                  (0xFF000000, 0xFF0000, 0xFF00, 0xFF)]:
        data = _bmp(32, hsize, masks, px32, W, H)
        assert _same(_port(data, "x.pbm"), _imageio(data, tmp_path,
                                                     "x.pbm")), masks
    for masks in [(0x7C00, 0x3E0, 0x1F, 0), (0xF800, 0x7E0, 0x1F, 0),
                  (0xF00, 0xF0, 0xF, 0)]:
        data = _bmp(16, hsize, masks, px16, W, H)
        if hsize == 40:      # the masks after the header
            data = _bmp(16, 40, (), struct.pack("<3I", *masks[:3]) + px16,
                        W, H)
        assert _same(_port(data, "x.pbm"), _imageio(data, tmp_path,
                                                     "x.pbm")), masks


_RLE8 = {
    "runs": [(3, 1), (2, 2), (0, 0), (5, 3), (0, 0), (5, 4), (0, 1)],
    "absolute": [(0, 4), "abcd", (1, 5), (0, 0), (5, 6), (0, 0), (5, 7),
                 (0, 1)],
    "delta": [(2, 1), (0, 2), (1, 1), (1, 2), (0, 0), (5, 3), (0, 1)],
    "run_wraps_eol": [(5, 1), (0, 0), (5, 2), (5, 3), (0, 1)],
    "run_past_row": [(6, 1), (0, 1)],
    "no_eof": [(5, 1), (0, 0), (5, 2), (0, 0), (5, 3)],
    "eof_early": [(2, 9), (0, 1)],
}


@pytest.mark.parametrize("rle4", [False, True])
@pytest.mark.parametrize("case", sorted(_RLE8))
def test_bmp_run_length(tmp_path, case, rle4):
    """OpenCV's RLE8 and RLE4 loops on crafted codes (runs, absolute runs,
    deltas, ends of line and image, a run past its row, a missing end):
    the port's pixels are imageio's, or both refuse."""
    out = bytearray()
    for code in _RLE8[case]:
        if isinstance(code, str):
            raw = bytes(ord(c) & 15 for c in code)
            if rle4:
                raw = bytes((raw[i] << 4) | (raw[i + 1] if i + 1 < len(raw)
                                             else 0)
                            for i in range(0, len(raw), 2))
            out += raw + bytes(len(raw) & 1)
        else:
            out += bytes(code)
    palette = bytes(np.arange(64, dtype=np.uint8) * 3 + 7)
    data = _bmp(4 if rle4 else 8, 40, (), bytes(out), 5, 3,
                comp=2 if rle4 else 1, used=16, palette=palette)
    assert _same(_port(data, "x.pbm"), _imageio(data, tmp_path, "x.pbm"))


@pytest.mark.parametrize("transparent", [None, 0, 3])
@pytest.mark.parametrize("background", [0, 3])
@pytest.mark.parametrize("tables", ["global", "local", "both"])
def test_gif_canvas(tmp_path, tables, background, transparent):
    """OpenCV's GIF canvas: the screen filled with the global background
    colour (black without a global table), the frame at its offset, its
    transparent index leaving the canvas, indices past the local table
    through the global one."""
    rng = np.random.default_rng(background)
    idx = rng.integers(0, 6, (4, 5)).astype(np.uint8)
    gct = rng.integers(0, 256, (8, 3)).astype(np.uint8)
    lct = rng.integers(0, 256, (4, 3)).astype(np.uint8)
    frame = dict(idx=idx, x=2, y=1, lct=lct if tables != "global" else
                 None)
    if transparent is not None:
        frame["trans"] = transparent
    data = MAKE.gif_file((9, 7), [frame], gct=None if tables == "local"
                         else gct, bg=background)
    assert _same(_port(data, "x.pbm"), _imageio(data, tmp_path, "x.pbm"))


def _lsb(codes):
    v = n = 0
    out = bytearray()
    for c in codes:
        v |= c << n
        n += 9
        while n >= 8:
            out.append(v & 255)
            v >>= 8
            n -= 8
    return bytes(out) + (bytes([v]) if n else b"")


def _msb(codes):
    v = n = 0
    out = bytearray()
    for c in codes:
        v = (v << 9) | c
        n += 9
        while n >= 8:
            out.append((v >> (n - 8)) & 255)
            n -= 8
    return bytes(out) + (bytes([(v << (8 - n)) & 255]) if n else b"")


_LITS = list(range(10, 22))
_LZW = {"valid": [256] + _LITS + [257], "no_clear": _LITS + [257],
        "bad_mid": [256] + _LITS[:5] + [300] + _LITS[5:] + [257],
        "bad_after_clear": [256, 398] + _LITS + [257],
        "short": [256] + _LITS[:7] + [257], "no_eoi": [256] + _LITS[:7],
        "kwkwk": [256, 10, 258, 11, 12, 13, 14, 15, 16, 17, 257]}


# an old-style stream is found by its clear code: none without one
@pytest.mark.parametrize("case,old", [(c, o) for c in sorted(_LZW)
                                      for o in (False, True)
                                      if not (o and c == "no_clear")])
def test_tiff_lzw_as_libtiff(tmp_path, case, old):
    """libtiff's LZW, new-style and old-style, on sound and broken code
    streams: OpenCV reads on past an error, with the bytes decoded before
    it and zeros after."""
    codes = _LZW[case]
    strip = (_lsb if old else _msb)(codes)
    data = _tiff(6, 2, 1, 1, strip, [(259, 3, [5])])
    assert _same(_port(data, "x.pbm"), _imageio(data, tmp_path, "x.pbm"))


def _tiff(W, H, spp, photometric, strip, tags=()):
    """A little-endian TIFF of 8-bit samples in one strip (``tags``, (tag,
    type, values), added or replacing the defaults): the header, the IFD,
    the strip, then the values that do not fit in their entries."""
    fields = {256: (3, [W]), 257: (3, [H]), 258: (3, [8] * spp),
              259: (3, [1]), 262: (3, [photometric]), 273: (4, [0]),
              277: (3, [spp]), 278: (3, [H]), 279: (4, [len(strip)])}
    fields.update({tag: (kind, values) for tag, kind, values in tags})
    data_at = 8 + 2 + 12 * len(fields) + 4
    extra, ifd = bytearray(), bytearray()
    for tag in sorted(fields):
        kind, values = fields[tag]
        raw = struct.pack("<I", data_at) if tag == 273 else b"".join(
            struct.pack("<" + {3: "H", 4: "I"}[kind], v) for v in values)
        if len(raw) > 4:
            field = struct.pack("<I", data_at + len(strip) + len(extra))
            extra += raw
        else:
            field = raw + bytes(4 - len(raw))
        ifd += struct.pack("<HHI", tag, kind, len(values)) + field
    return b"II*\x00" + struct.pack("<IH", 8, len(fields)) + bytes(ifd) + \
        struct.pack("<I", 0) + strip + bytes(extra)


@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1),
                                 (4, 2), (4, 4)])
def test_tiff_ycbcr_subsampling(tmp_path, sub):
    """Uncompressed YCbCr at every sub-sampling libtiff's RGBA reader
    knows, at an odd size: its chroma replicated over each block and
    libtiff's conversion."""
    hs, vs = sub
    W, H = 7, 5
    ux, uy = -(-W // hs), -(-H // vs)
    rng = np.random.default_rng(hs * 8 + vs)
    units = rng.integers(16, 240, (uy, ux, hs * vs + 2)).astype(np.uint8)
    data = _tiff(W, H, 3, 6, units.tobytes(), [(530, 3, [hs, vs])])
    assert _same(_port(data, "x.pbm"), _imageio(data, tmp_path, "x.pbm"))


@pytest.mark.parametrize("case", ["lab8", "lab16", "lab8_whitepoint",
                                  "rgba16_unassoc", "rgba8_assoc",
                                  "cmyk8", "grey16_miniswhite",
                                  "palette8_8bit_map", "int16_predictor3"])
def test_tiff_rgba_conversions(tmp_path, case):
    """libtiff's RGBA conversions over random samples: CIELab (8 and 16
    bits, the default and a given white point), 16-bit RGBA with
    unassociated alpha (premultiplied), associated alpha (dropped), CMYK,
    16-bit min-is-white, a palette whose colour map holds 8-bit values,
    a predictor tag without a codec that uses it."""
    rng = np.random.default_rng(len(case))
    H, W = 6, 7
    kw, extra = {}, ()
    if case.startswith("lab"):
        bits = 16 if case == "lab16" else 8
        s = rng.integers(0, 1 << bits, (H, W, 3)).astype(
            np.uint16 if bits == 16 else np.uint8)
        photometric = 8
        if case == "lab8_whitepoint":
            extra = ((318, 5, [3127, 10000, 3290, 10000]),)
    elif case.startswith("rgba"):
        bits = 16 if "16" in case else 8
        s = rng.integers(0, 1 << bits, (H, W, 4)).astype(
            np.uint16 if bits == 16 else np.uint8)
        photometric = 2
        kw["extra"] = (2 if "unassoc" in case else 1,)
    elif case == "cmyk8":
        s, photometric = rng.integers(0, 256, (H, W, 4)).astype(np.uint8), 5
    elif case == "grey16_miniswhite":
        s, photometric = rng.integers(0, 65536, (H, W, 1)).astype(
            np.uint16), 0
    elif case == "palette8_8bit_map":
        s, photometric = rng.integers(0, 256, (H, W, 1)).astype(np.uint8), 3
        kw["colormap"] = rng.integers(0, 256, 768).astype(np.uint16)
    else:
        s, photometric = rng.integers(-30000, 30000, (H, W, 3)).astype(
            np.int16), 2
        kw.update(sample_format=2, predictor=3)
    data = MAKE.tiff_file(s, photometric, extra_tags=extra, **kw)
    assert _same(_port(data, "x.pbm"), _imageio(data, tmp_path, "x.pbm"))


@pytest.mark.parametrize("name", ["jpeg_lossless_grey_psv1.jpg",
                                  "jpeg_lossless_rgb.jpg",
                                  "jpeg_lossless_rgb_adobe0.jpg",
                                  "jpeg_lossless_rgb_jfif.jpg",
                                  "jpeg_lossless_sof3.jpg"])
def test_lossless_jpeg_by_colour_space(tmp_path, name):
    """Lossless JPEG under OpenCV: RGB (no JFIF marker, or Adobe transform
    0) is read, grey and YCbCr, which need a colour conversion
    libjpeg-turbo does not make in lossless mode, are refused."""
    data = (TEX / name).read_bytes()
    assert _same(_port(data, "x.pbm"), _imageio(data, tmp_path, "x.pbm"))


@pytest.mark.parametrize("name", ["hdr_rle_runs.hdr", "sun_8bit_cmap.ras",
                                  "sun_32bit.ras"])
def test_byte_flips_in_the_pixels(tmp_path, name):
    """Single bytes of the pixel data flipped: the port's samples are
    imageio's, or both refuse."""
    data = (TEX / name).read_bytes()
    start = data.index(b"+X 37\n") + 6 if name.endswith(".hdr") else 32
    rng = np.random.default_rng(len(name))
    for at in rng.integers(start, len(data), 12):
        for mask in (0x01, 0x80, 0xFF):
            d = bytearray(data)
            d[int(at)] ^= mask
            d = bytes(d)
            for ext in (".hdr", ".ras"):
                assert _same(_port(d, "x" + ext),
                             _imageio(d, tmp_path, "x" + ext)), (at, mask)


def test_refusals_name_opencv_reasons(tmp_path):
    """The refusals name OpenCV's reasons (the words of its messages on
    the fixtures' stderr)."""
    reasons = {"jpeg2000_subsampled.j2k": "tiles are not supported",
               "jpeg2000_precision_5.j2k": "Precision < 8",
               "jpeg2000_signed.jp2": "Component 0/3 is signed",
               "jpeg2000_cmyk.jp2": "CMYK -> BGR",
               "tiff_float16_big_endian.tif": "sample format",
               "tiff_grey2_big_endian.tif": "Invalid bitsperpixel",
               "tiff_float32_grey.tif": "32-bit samples",
               "tiff_rgb_lzma_strips.tif": "not configured",
               "tiff_separated_five_inks.tif": "number of channels",
               "tiff_logluv_raw.tif": "LogLuv data must have Compression="
                                      "34676 or 34677",
               "tiff_logl16.tif": "LogL data must have Compression=34676",
               "bmp_rle4.bmp": "BMP", "gif_frame_past_screen.gif":
               "left + width", "gif_index_past_table.gif": "code2pixel"}
    for name, words in reasons.items():
        with pytest.raises(ValueError, match=words.replace(
                "+", r"\+")) as err:
            F.read_image(str(_copy(tmp_path, name, ".pbm")))
        assert "(OpenCV)" in str(err.value)


def _copy(tmp_path: Path, name: str, ext: str) -> Path:
    path = tmp_path / (Path(name).stem + ext)
    path.write_bytes((TEX / name).read_bytes())
    return path


def test_openexr_is_refused_under_every_name(tmp_path):
    """OpenCV is built without OpenEXR, and no other plugin of imageio's
    reads it: refused under every name, naming that."""
    data = b"\x76\x2f\x31\x01" + bytes(60)
    for ext in (".exr", ".png", ".pbm", ".xyz"):
        assert _imageio(data, tmp_path, "x" + ext) is None
        with pytest.raises(ValueError, match="OpenEXR"):
            F.decode_image(data, "x" + ext)
