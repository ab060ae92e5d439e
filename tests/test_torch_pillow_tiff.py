"""A TIFF texture under one of Pillow's names (``.png``, ``.jpg``, ``.bmp``,
an unknown one): imageio tries its Pillow plugin first, and Pillow opens a
TIFF by its content, so the port reads it as Pillow's TIFF plugin does
(``viz/tiff_pillow.py`` over ``viz/libtiff.py``), and where that plugin
declines it, as OpenCV does (``viz/opencv_read.py``).

* every TIFF fixture of ``tests/torch_textures/`` copied as ``.png``: the
  port's ``load_obj_mesh`` against the JAX package's on every key, equal
  to the bit where imageio's array is (H, W, 3) uint8, else the port's
  texture is imageio's array under ``texture_rgb``'s rule; where imageio
  refuses, both refuse. Ten fixtures of different kinds also under
  ``.jpg``, ``.bmp`` and ``.foo``. ``MANIFEST.json``'s ``pillow_route``
  (the plugin, Pillow's mode, imageio's array or refusal) against what
  imageio reads now, and the port's own samples against its digests;
* the route: a file Pillow declines at open goes on to OpenCV; one that
  Pillow opens and cannot load raises ``ValueError`` naming it, with no
  fall back to the tifffile reading; the open-time rule against Pillow's
  ``Image.open`` on a crafted directory for every key of ``OPEN_INFO``
  and for keys outside it, each read against imageio in strips, tiles and
  separate planes, uncompressed and through libtiff;
* Pillow's rules on crafted files: its unpackers against ``frombytes``,
  the Orientation tag, palettes shorter or longer than 256 colours, JPEG
  strips in YCbCr, grey, RGB and CMYK, a Group 4 strip that ends early,
  its magic numbers with the byte orders swapped, mode "I" as a texture;
* libtiff's rules on both of imageio's routes to it (``.png``, ``.pbm``):
  fill order 2 under every codec, a bad Deflate or LZMA checksum, IFD
  entries cut by the file's end, strips and tiles without byte counts,
  offsets and counts past the file's end, an LZW strip cut short, a
  missing PhotometricInterpretation;
* libtiff's codecs that no fixture but one covers, against Pillow:
  ThunderScan (crafted, and random code streams), Zstandard (libzstd's
  frames of every level, with a checksum, a content size, a small
  window; in strips, tiles and planes; Pillow's own; corrupted strips
  from ``torch_textures/zstd_vs_pillow.py``), WebP (which this Pillow's
  libtiff fails on) and old-style JPEG (which it reads and the port
  refuses);
* hypothesis byte flips and cuts of the TIFF fixtures under ``.png`` (the
  same 300 examples on every run; the open-ended search is
  ``torch_textures/asan_mutants.py --as .png``): the port raises
  ``ValueError`` or returns well-formed samples.

On the CPU, ~22 s on one worker: JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_pillow_tiff.py -q. The host libraries are built with g++
on first use; no card is needed.
"""
from __future__ import annotations

import hashlib
import importlib.util
import io
import json
import struct
import zlib
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image, TiffImagePlugin, UnidentifiedImageError

from neural_marionette_tpu.apps import retarget as JRT
from neural_marionette_tpu_torch.apps import retarget as PRT
from neural_marionette_tpu_torch.viz import image_files as F
from neural_marionette_tpu_torch.viz import opencv_read as O
from neural_marionette_tpu_torch.viz import tiff_pillow as P
from neural_marionette_tpu_torch.viz.tiff import cmyk_to_rgb, decode_tiff

TEX = Path(__file__).resolve().parent / "torch_textures"
FILES = json.loads((TEX / "MANIFEST.json").read_text())["files"]
TIFFS = [e for e in FILES if "pillow_route" in e]
_spec = importlib.util.spec_from_file_location("make_textures",
                                               TEX / "make_textures.py")
MAKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(MAKE)
_spec = importlib.util.spec_from_file_location("zstd_vs_pillow",
                                               TEX / "zstd_vs_pillow.py")
ZSTD = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ZSTD)


def _imageio(data: bytes, path: Path):
    """imageio's array of ``data`` saved at ``path``, or None where it
    refuses the file."""
    path.write_bytes(data)
    try:
        return np.asarray(imageio.imread(path))
    except Exception:
        return None


def _pillow_mode(data: bytes):
    try:
        return Image.open(io.BytesIO(data)).mode
    except Exception:
        return None


def _samples(want, mode):
    """imageio's array as the port's samples: (H, W, C), a bitmap 0 and
    255, Pillow's CMYK made RGB (the port's CMYK rule)."""
    if want.dtype == np.bool_:
        want = want.astype(np.uint8) * np.uint8(255)
    if want.ndim == 2:
        want = want[..., None]
    return cmyk_to_rgb(want) if mode == "CMYK" else want


def _same(data: bytes, name: str, tmp_path: Path) -> bool:
    """The port's samples of ``data`` named ``name`` are imageio's, to the
    bit (both refusing counts as the same)."""
    want = _imageio(data, tmp_path / name)
    try:
        got = F.decode_image(data, name)
    except ValueError:
        return want is None
    if want is None:
        return False
    want = _samples(want, _pillow_mode(data))
    return got.dtype == want.dtype and got.shape == want.shape and \
        got.tobytes() == np.ascontiguousarray(want).tobytes()


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


def _meshes_agree(tmp_path: Path, data: bytes, name: str, read: dict):
    """The port's mesh against the JAX one for ``data`` saved as ``name``,
    imageio's reading ``read`` (the manifest's form) deciding the rule."""
    obj = _write_obj(tmp_path, data, name)
    try:
        p = PRT.load_obj_mesh(str(obj))
    except ValueError as e:
        p = e
    try:
        j = JRT.load_obj_mesh(str(obj))
    except Exception:
        j = None
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
    if not rgb:       # imageio's array under the port's rule
        want = _imageio(data, tmp_path / ("again" + Path(name).suffix))
        rule = PRT.texture_rgb(_samples(want, read.get("mode")))
        assert np.array_equal(p["texture"], rule)
        assert 0 <= p["texture"].min() and p["texture"].max() <= 1


# ------------------------------------------------------------- fixtures
@pytest.mark.parametrize("entry", TIFFS, ids=[e["file"] for e in TIFFS])
def test_fixture_under_png_reads_like_jax(tmp_path, entry):
    """Every TIFF fixture copied as ``.png``: the mesh equals the JAX mesh
    to the bit where imageio's array is (H, W, 3) uint8, else the texture
    is imageio's array under ``texture_rgb``'s rule; both refuse what
    imageio refuses."""
    data = (TEX / entry["file"]).read_bytes()
    _meshes_agree(tmp_path, data, "texture.png", entry["pillow_route"])


_SAMPLED = ["tiff_palette8.tif", "tiff_rgb16_big_endian_lzw_predictor.tif",
            "tiff_cmyk.tif", "tiff_ccitt_g4.tif", "tiff_int16_predictor3.tif",
            "tiff_ycbcr_lzw.tif", "tiff_jpeg.tif", "tiff_grey16.tif",
            "tiff_old_style_lzw.tif", "tiff_cielab_pillow.tif",
            "tiff_float32_grey_predictor2.tif", "tiff_two_pages.tif"]


@pytest.mark.parametrize("ext", [".jpg", ".bmp", ".foo"])
@pytest.mark.parametrize("name", _SAMPLED)
def test_sampled_fixtures_under_other_pillow_names(tmp_path, name, ext):
    """Fixtures of different kinds (palette, 16-bit, CMYK, CCITT, a file
    Pillow declines, YCbCr through the RGBA interface, JPEG, 16-bit grey,
    a load-time failure, LAB codes, float, two pages) under other names
    whose first plugin is Pillow: the port's samples and mesh as under
    ``.png``."""
    data = (TEX / name).read_bytes()
    assert _same(data, "texture" + ext, tmp_path)
    read = next(e for e in TIFFS if e["file"] == name)["pillow_route"]
    _meshes_agree(tmp_path / "obj", data, "texture" + ext, read)


@pytest.mark.parametrize("entry", TIFFS, ids=[e["file"] for e in TIFFS])
def test_manifest_pillow_route_is_what_imageio_reads(tmp_path, entry):
    """The fixtures stay honest: imageio under ``.png`` still opens each
    TIFF with the plugin the manifest records (Pillow in its mode, or
    OpenCV) and gives its array or refuses; the port's samples match the
    digest (Pillow's array, which the port's CMYK rule then converts)."""
    data = (TEX / entry["file"]).read_bytes()
    read = entry["pillow_route"]
    assert MAKE.pillow_read(data) == read
    if "raises" in read:
        with pytest.raises(ValueError, match=entry["file"]):
            F.decode_image(data, entry["file"] + ".png")
        return
    tif = P.open_tiff(data, "texture.png")
    assert (tif is not None) == (read["plugin"] == "pillow")
    arr = tif.read() if tif is not None else F.decode_image(data, "x.png")
    assert arr.size == int(np.prod(read["shape"]))
    assert str(arr.dtype) == read["dtype"].replace("bool", "uint8")
    assert hashlib.sha256(arr.tobytes()).hexdigest() == read["sha256"]
    if tif is not None:
        assert tif.mode == read["mode"]


# ---------------------------------------------------------------- route
_DECLINED = ["tiff_int16_predictor3.tif", "tiff_logluv32_opencv.tif",
             "tiff_miniswhite_int16.tif", "tiff_palette_without_colormap.tif",
             "tiff_depth2_rgb_planar.tif", "tiff_itulab.tif"]


@pytest.mark.parametrize("name", _DECLINED)
def test_declined_at_open_goes_on_to_opencv(tmp_path, name):
    """Files Pillow's TIFF plugin declines (no ``OPEN_INFO`` key: signed
    16-bit RGB, LogLuv, signed min-is-white, a palette without its colour
    map, ITULab; too many separate planes for the raw mode): imageio's next
    plugin is OpenCV, which takes every TIFF, so the port's reading is its
    OpenCV route's, read or refused."""
    data = (TEX / name).read_bytes()
    with pytest.raises(UnidentifiedImageError):
        Image.open(io.BytesIO(data))
    assert P.open_tiff(data, "x.png") is None
    assert F.imageio_route("x.png") == ("pillow", "opencv", "tifffile")
    assert F.opencv_reads(data)
    try:
        want = O.decode_opencv(data, "x.pbm")
    except ValueError:
        with pytest.raises(ValueError, match="OpenCV"):
            F.decode_image(data, "x.png")
    else:
        assert np.array_equal(F.decode_image(data, "x.png"), want)
    assert _same(data, "x.png", tmp_path)


@pytest.mark.parametrize("name", ["tiff_old_style_lzw.tif",
                                  "tiff_bilevel_predictor2.tif",
                                  "tiff_ccitt_rlew_strips.tif",
                                  "tiff_ycbcr_subsampled.tif"])
def test_failure_at_load_raises_naming_it(tmp_path, name):
    """Files Pillow opens and cannot load (old-style LZW, which its
    libtiff is built without; a predictor on 1-bit samples; RLEW strips
    that end early; sub-sampled YCbCr read raw as RGBX): imageio fails,
    and the port raises ``ValueError`` naming the file and Pillow, with no
    fall back to another reading (tifffile's, under ``.tif``, where it
    has one)."""
    data = (TEX / name).read_bytes()
    assert P.open_tiff(data, "texture.png") is not None
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).load()
    assert _imageio(data, tmp_path / "texture.png") is None
    with pytest.raises(ValueError, match=r"texture\.png: TIFF \(Pillow\)"):
        F.decode_image(data, "texture.png")
    if name == "tiff_bilevel_predictor2.tif":
        assert decode_tiff(data, name).shape == (29, 37, 1)


def test_open_time_failure_makes_imageio_fail(tmp_path):
    """An error of Pillow's other than those ``Image.open`` passes over
    (a width that is not an integer; more pixels than Pillow's
    decompression-bomb limit) makes imageio fail, and the port raises
    without trying OpenCV."""
    rgb = np.zeros((2, 3, 3), np.uint8)
    rational = bytearray(MAKE.tiff_file(rgb, 2))
    at = rational.index(struct.pack("<HHI", 256, 4, 1))
    rational[at + 2:at + 4] = struct.pack("<H", 5)
    rational[at + 8:at + 12] = struct.pack("<I", 8)       # -> the header
    bomb = bytearray(MAKE.tiff_file(rgb, 2))
    for tag, value in ((256, 20000), (257, 20000)):
        at = bomb.index(struct.pack("<HHI", tag, 4, 1))
        bomb[at + 8:at + 12] = struct.pack("<I", value)
    for data, words in ((bytes(rational), "Invalid dimensions"),
                        (bytes(bomb), "past the limit")):
        assert _imageio(data, tmp_path / "x.png") is None
        assert F.opencv_reads(data)
        with pytest.raises(ValueError, match=words):
            F.decode_image(data, "x.png")


def _key_case(key, rng):
    """A small TIFF of random samples for an ``OPEN_INFO`` key."""
    order, photo, fmt, fillorder, bps, extra = key
    spp, bits = len(bps), bps[0]
    if fmt == (3,):
        s = rng.standard_normal((7, 19, spp)).astype(np.float32)
    elif fmt == (2,):
        s = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), (7, 19, spp))
        s = s.astype({8: np.int8, 16: np.int16, 32: np.int32}[bits])
    else:
        s = rng.integers(0, 1 << bits, (7, 19, spp), dtype=np.uint64).astype(
            np.uint8 if bits <= 8 else np.uint16 if bits <= 16
            else np.uint32)
    kw = dict(order="<" if order == b"II" else ">", fillorder=fillorder,
              bits=None if bits in (8, 16, 32) else bits,
              sample_format=fmt[0], extra=extra)
    if photo == 3:
        kw["colormap"] = rng.integers(0, 65536, (1 << min(bits, 8), 3)
                                      ).astype(np.uint16)
    if photo == 6 and spp == 3:
        kw["extra_tags"] = ((530, 3, [1, 1]),)
    return s, photo, kw


_KEYS = sorted(TiffImagePlugin.OPEN_INFO, key=str)


@pytest.mark.parametrize("key", _KEYS, ids=[str(k) for k in _KEYS])
def test_open_info_key_read_like_pillow(tmp_path, key):
    """A crafted directory for every key of Pillow's ``OPEN_INFO`` (the
    fixtures cover few of them): the port's table is Pillow's, its mode is
    Pillow's, and the file reads as imageio reads it in one strip, in
    strips of 3 rows and in 16 x 16 tiles, uncompressed (Pillow's raw
    decoder) and LZW (libtiff), and in separate planes."""
    assert P.OPEN_INFO == TiffImagePlugin.OPEN_INFO
    rng = np.random.default_rng(zlib.crc32(str(key).encode()))
    s, photo, kw = _key_case(key, rng)
    for compression in (1, 5):
        for layout in ({}, {"rows_per_strip": 3}, {"tile": (16, 16)},
                       {"planar": 2, "rows_per_strip": 4}):
            data = MAKE.tiff_file(s, photo, compression=compression,
                                  **layout, **kw)
            tif = P.open_tiff(data, "x.png")
            assert tif is not None and tif.mode == _pillow_mode(data)
            assert _same(data, "x.png", tmp_path), (compression, layout)


# directories with no OPEN_INFO key: (sample type, photometric, sample
# format, extra samples)
_OUTSIDE = {"palette16": (np.uint16, 3, 1, ()),
            "int8_rgb": (np.int8, 2, 2, ()),
            "float64": (np.float64, 1, 3, ()),
            "uint32_rgb": (np.uint32, 2, 1, ()),
            "grey_alpha16": (np.uint16, 1, 1, (2,)),
            "cmyk_alpha": (np.uint8, 5, 1, (2,)),
            "lab16": (np.uint16, 8, 1, ()),
            "int16_min_is_white": (np.int16, 0, 2, ())}


@pytest.mark.parametrize("case", sorted(_OUTSIDE))
def test_keys_outside_open_info_are_declined(tmp_path, case):
    """Directories with no ``OPEN_INFO`` key: Pillow's ``Image.open`` does
    not identify them, the port's open-time rule declines them, and both
    go on to OpenCV."""
    dtype, photo, fmt, extra = _OUTSIDE[case]
    spp = {1: 1 + len(extra), 2: 3, 3: 1, 5: 4 + len(extra), 8: 3,
           0: 1}[photo]
    s = np.random.default_rng(len(case)).integers(
        0, 100, (5, 7, spp)).astype(dtype)
    kw = {"colormap": np.zeros((65536, 3), np.uint16)} if photo == 3 else {}
    data = MAKE.tiff_file(s, photo, sample_format=fmt, extra=extra, **kw)
    with pytest.raises(UnidentifiedImageError):
        Image.open(io.BytesIO(data))
    assert P.open_tiff(data, "x.png") is None
    assert _same(data, "x.png", tmp_path)


# -------------------------------------------------------- Pillow's rules
_RAWMODES = sorted((m, r) for m, rs in P._VALID.items() for r in rs
                   if r not in P._BANDS.get(m, ()) and len(r) > 1)


@pytest.mark.parametrize("mode,rawmode", _RAWMODES,
                         ids=[f"{m}-{r}" for m, r in _RAWMODES])
def test_unpacker_is_pillows(mode, rawmode):
    """Each unpacker of the port's table on random rows of odd width
    against Pillow's ``frombytes`` with that raw mode (the "N" forms: this
    little-endian host's order)."""
    rng = np.random.default_rng(len(rawmode) * 31 + len(mode))
    w, h = 13, 3
    bits = P.UNPACKERS[rawmode][0]
    row = (w * bits + 7) // 8
    raw = rng.integers(0, 256, (h, row), dtype=np.uint8)
    if rawmode.startswith("F"):     # finite floats
        raw = rng.standard_normal((h, w)).astype(
            "<f4" if "B" not in rawmode else ">f4").view(np.uint8)
    want = np.asarray(Image.frombytes(mode, (w, h), raw.tobytes(), "raw",
                                      rawmode))
    got = P.unpack(rawmode, raw, w)
    if mode == "1":
        want = want.astype(np.uint8) * np.uint8(255)
    assert np.array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("compression", [1, 5])
@pytest.mark.parametrize("orientation", range(10))
def test_orientation_tag(tmp_path, orientation, compression):
    """The Orientation tag, 0-9, on Pillow's raw decoder and through
    libtiff: ``load_end``'s ``exif_transpose`` (5-8 swap the sides)."""
    s = np.random.default_rng(orientation).integers(0, 256, (5, 7, 3))
    data = MAKE.tiff_file(s.astype(np.uint8), 2, compression=compression,
                          extra_tags=((274, 3, [orientation]),))
    assert _same(data, "x.png", tmp_path)


@pytest.mark.parametrize("ext", [".png", ".pbm"])
@pytest.mark.parametrize("compression", [8, 32946, 34925, 5, 32773])
def test_fill_order_2_reverses_every_codec(tmp_path, compression, ext):
    """Fill order 2 reverses the bits of the stored bytes before LZW,
    PackBits, Deflate and LZMA alike (libtiff's TIFFFillStrip), on Pillow's
    route and on OpenCV's (which took Deflate's bytes as stored before
    this was found)."""
    s = np.random.default_rng(compression).integers(0, 256, (5, 9, 3))
    data = MAKE.tiff_file(s.astype(np.uint8), 2, fillorder=2,
                          compression=compression)
    assert _same(data, "x" + ext, tmp_path)


@pytest.mark.parametrize("ext", [".png", ".pbm"])
@pytest.mark.parametrize("photometric", [2, 6])
@pytest.mark.parametrize("compression", [8, 34925])
def test_bad_checksum(tmp_path, compression, photometric, ext):
    """Each byte of a Deflate strip's Adler-32 and of the end of an LZMA
    strip's .xz stream flipped in turn: libtiff's Deflate decoder fails on
    zlib's check (Pillow fails), its LZMA decoder never reads that far,
    and the RGBA interface (OpenCV, Pillow's YCbCr) keeps what a failing
    strip decoded. The port reads or refuses as imageio does."""
    rgb = np.random.default_rng(3).integers(0, 256, (4, 6, 3)).astype(
        np.uint8)
    kw = {"extra_tags": ((530, 3, [1, 1]),)} if photometric == 6 else {}
    data = MAKE.tiff_file(rgb, photometric, compression=compression, **kw)
    from neural_marionette_tpu_torch.viz import tiff as T
    tags = T._Reader(data, "x").tags
    end = tags[273][0] + tags[279][0]
    for at in range(end - (4 if compression == 8 else 24), end):
        d = bytearray(data)
        d[at] ^= 0x55
        assert _same(bytes(d), "x" + ext, tmp_path), at


@pytest.mark.parametrize("entries", [48, 50, 768, 771])
def test_palette_lengths(tmp_path, entries):
    """A colour map of fewer values than 3 x 256 (Pillow's palette of
    len // 3 colours, indices past it black) or more (Pillow: "invalid
    palette size", imageio fails)."""
    idx = np.arange(40, dtype=np.uint8).reshape(5, 8, 1)
    cmap = (np.arange(entries, dtype=np.uint32) * 997 % 65536).astype(
        np.uint16)
    data = MAKE.tiff_file(idx, 3, extra_tags=((320, 3, list(cmap)),))
    assert _same(data, "x.png", tmp_path)


@pytest.mark.parametrize("mode", ["RGB", "YCbCr", "L", "CMYK"])
def test_jpeg_in_tiff(tmp_path, mode):
    """JPEG strips as Pillow writes them: libtiff's YCbCr to RGB for a
    YCbCr file, no conversion for RGB and grey (their components as
    stored); a CMYK one Pillow writes as raw data."""
    img = Image.fromarray(MAKE.textured(29, 37, 5)).convert(mode)
    data = MAKE.pil_bytes(img, "TIFF", compression="jpeg")
    assert _same(data, "x.png", tmp_path)


def test_group4_strip_that_ends_early_is_refused(tmp_path):
    """A Group 4 strip whose data ends after its first row (half the
    strip, or 2 bytes that make a row of a bad code word): libtiff's
    decoder accepts it and leaves the other rows of Pillow's buffer as
    they were, which the file does not determine; the port refuses it,
    naming that. Where the data ends within the first row (8 bytes),
    Pillow fails and the port raises too."""
    page = np.random.default_rng(4).random((64, 40)) < 0.3
    data = MAKE.pil_bytes(Image.fromarray(page.astype(np.uint8) * 255)
                          .convert("1"), "TIFF", compression="group4")
    from neural_marionette_tpu_torch.viz import tiff as T
    cnt = T._Reader(data, "x").tags[279][0]
    at = data.index(struct.pack("<HHII", 279, 4, 1, cnt))

    def counted(n):         # the strip's byte count set to n
        return data[:at + 8] + struct.pack("<I", n) + data[at + 12:]

    for n in (cnt // 2, 2):
        with pytest.raises(ValueError, match="unwritten"):
            F.decode_image(counted(n), "x.png")
        assert P.open_tiff(counted(n), "x.png") is not None
    assert _imageio(counted(8), tmp_path / "x.png") is None
    assert _same(counted(8), "x.png", tmp_path)


def _renamed(data: bytes, tag: int, kind: int = 4) -> bytes:
    """``data`` with its tag ``tag`` made an unknown one."""
    at = data.index(struct.pack("<HH", tag, kind))
    return data[:at] + struct.pack("<H", 3095) + data[at + 2:]


def _counted(data: bytes, tag: int, count: int, order: str = "<") -> bytes:
    """``data`` with the value count of its LONG tag ``tag`` set."""
    at = data.index(struct.pack(order + "HH", tag, 4))
    return data[:at + 4] + struct.pack(order + "I", count) + data[at + 8:]


def _directory_cases() -> dict:
    from neural_marionette_tpu_torch.viz import tiff as T
    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, (9, 13, 3)).astype(np.uint8)
    one = MAKE.tiff_file(rgb, 2, compression=5)
    end = T._Reader(one, "x").ifd_end
    strips = MAKE.tiff_file(rgb, 2, compression=5, rows_per_strip=3)
    rgb16 = MAKE.tiff_file(rng.integers(0, 65536, (9, 13, 3)).astype(
        np.uint16), 2, compression=5, predictor=2, order=">")
    half = T._Reader(rgb16, "x").tags[279][0] // 2
    at = rgb16.index(struct.pack(">HHI", 279, 4, 1)) + 8
    return {
        "ifd_cut_in_last_entry": one[:end - 2],
        "ifd_cut_after_entries": one[:end + 2],
        "tiles_without_counts": _renamed(MAKE.tiff_file(
            rgb, 2, compression=5, tile=(16, 16)), 325),
        "strips_without_counts": _renamed(strips, 279),
        "planes_without_counts": _renamed(MAKE.tiff_file(
            rgb, 2, compression=5, planar=2), 279),
        "counts_past_the_end": _counted(strips, 279, 1000),
        "offsets_past_the_end": _counted(strips, 273, 1000),
        "lzw_cut_16bit_big_endian_predictor":
            rgb16[:at] + struct.pack(">I", half) + rgb16[at + 4:]}


_DIRECTORIES = _directory_cases()


@pytest.mark.parametrize("ext", [".png", ".pbm"])
@pytest.mark.parametrize("case", sorted(_DIRECTORIES))
def test_libtiff_directories_and_failing_strips(tmp_path, case, ext):
    """libtiff's directory and strip rules on both of imageio's routes to
    it (Pillow's ``.png``, OpenCV's ``.pbm``): IFD entries cut by the end
    of the file fail; tiles, and one strip a plane, without byte counts
    get libtiff's estimate, several strips of a plane fail; byte counts or
    offsets whose count runs past the end of the file give the values the
    strips need; an LZW strip cut short fails Pillow's read, and OpenCV's
    RGBA read keeps its bytes with no predictor and no byte swap."""
    assert _same(_DIRECTORIES[case], "x" + ext, tmp_path)


@pytest.mark.parametrize("spp", [1, 3])
def test_no_photometric(tmp_path, spp):
    """No PhotometricInterpretation tag: Pillow takes min-is-white (one
    sample reads, inverted; three declined), OpenCV's TIFFGetField fails
    (the port's OpenCV route guessed one before)."""
    s = np.random.default_rng(spp).integers(0, 256, (5, 7, spp))
    data = bytearray(MAKE.tiff_file(s.astype(np.uint8), 1, compression=5))
    at = data.index(struct.pack("<HH", 262, 3))
    data[at:at + 2] = struct.pack("<H", 999)          # an unknown tag
    for ext in (".png", ".pbm"):
        assert _same(bytes(data), "x" + ext, tmp_path)


def test_pillow_prefixes_and_int32_rule(tmp_path):
    """Pillow also opens the byte orders' magic numbers swapped ("II\\0*",
    "MM*\\0", which neither OpenCV nor tifffile takes), under Pillow's
    names and under ``.tif``; and mode "I" (signed 16- and 32-bit, unsigned
    32-bit samples) becomes a texture by the clipped int32 rule."""
    s = np.random.default_rng(7).integers(0, 256, (5, 7, 3)).astype(np.uint8)
    data = bytearray(MAKE.tiff_file(s, 2))
    data[2:4] = b"\x00*"
    for name in ("x.png", "x.tif"):
        assert F.image_format(bytes(data)) == "TIFF"
        assert not F.opencv_reads(bytes(data))
        assert _same(bytes(data), name, tmp_path)
    wide = np.random.default_rng(8).integers(-2 ** 31, 2 ** 31, (5, 7, 1))
    data = MAKE.tiff_file(wide.astype(np.int32), 1, sample_format=2)
    img = F.decode_image(data, "x.png")
    assert img.dtype == np.int32 and np.array_equal(img[..., 0],
                                                    wide[..., 0])
    tex = PRT.texture_rgb(img)
    assert 0 <= tex.min() and tex.max() <= 1
    assert np.array_equal(tex[..., 0], (np.clip(wide[..., 0], 0, 65535)
                                        / 65535.0).astype(np.float32))


_FUZZ = [e["file"] for e in TIFFS if not e["facts"].get("large")]


@settings(max_examples=300, deadline=None, database=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(name=st.sampled_from(_FUZZ),
       flips=st.lists(st.tuples(st.integers(0, 1 << 20),
                                st.integers(0, 255)), max_size=4),
       cut=st.one_of(st.none(), st.integers(0, 1 << 20)))
def test_corrupt_tiff_under_png_raises_or_reads(name, flips, cut):
    """Bytes set and the file cut at random in every TIFF fixture, read
    under ``.png``: ``decode_image`` raises ``ValueError`` or returns
    well-formed samples whose texture lies in [0, 1]."""
    data = bytearray((TEX / name).read_bytes())
    for pos, value in flips:
        data[pos % len(data)] = value
    if cut is not None:
        data = data[:cut % (len(data) + 1)]
    try:
        img = F.decode_image(bytes(data), "texture.png")
    except ValueError:
        return
    assert img.ndim == 3 and img.shape[-1] in (1, 2, 3, 4) and img.size
    tex = PRT.texture_rgb(img)
    assert tex.shape == img.shape[:2] + (3,)
    assert np.isfinite(tex).all() and 0 <= tex.min() and tex.max() <= 1


# ------------------------------------------------- codecs beyond fixtures
@pytest.mark.parametrize("case", ["grey", "grey_strips", "odd_width",
                                  "fill_order_2", "palette", "tiles",
                                  "eight_bit"])
def test_thunderscan_reads_as_pillow(tmp_path, case):
    """ThunderScan (compression 32809, libtiff's tif_thunder.c, 4-bit
    samples) under ``.png``: runs, 2- and 3-bit deltas and raw pixels,
    in strips, in fill order 2, as a palette; tiles, which libtiff 4.7
    does not decode ("ThunderScan tile decoding is not implemented"),
    and 8-bit samples, which the codec refuses. The port's samples are
    imageio's to the bit, or both refuse."""
    rng = np.random.default_rng(len(case))
    H, W = (8, 13) if case == "odd_width" else (8, 16)
    walk = (np.cumsum(rng.integers(-2, 3, (H, W)), 1) % 16).astype(np.uint8)
    walk[:, 4:9] = 5
    kw = {"grey_strips": dict(rows_per_strip=3),
          "fill_order_2": dict(fillorder=2, rows_per_strip=3),
          "palette": dict(colormap=rng.integers(0, 65536, (16, 3))),
          "tiles": dict(tile=(16, 16)),
          "eight_bit": dict(bits=8)}.get(case, {})
    photometric = 3 if case == "palette" else 1
    data = MAKE.tiff_file(walk[..., None], photometric,
                          bits=kw.pop("bits", 4), compression=32809, **kw)
    assert P.open_tiff(data, "x.png") is not None
    assert _same(data, "x.png", tmp_path)
    read = _imageio(data, tmp_path / "x.png") is not None
    assert read == (case not in ("tiles", "eight_bit"))


@pytest.mark.parametrize("seed", range(8))
def test_thunderscan_codes_at_random(tmp_path, seed):
    """Random ThunderScan code streams (any run, delta or raw code, too
    few or too many for the rows: libtiff's "Not enough" / "Too much data
    at scanline" fails the read; a run that reaches past a row writes
    nothing; deltas past a row's end are dropped; a run from an odd pixel
    repeats the last two) in one strip of 1-3 rows: the port reads what
    imageio reads under ``.png``, or both refuse."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(25):
        W, H = int(rng.integers(1, 40)), int(rng.integers(1, 4))
        n = int(rng.integers(0, W * H + 4))
        kinds = rng.choice([0x00, 0x40, 0x80, 0xC0], n,
                           p=[0.1, 0.3, 0.3, 0.3])
        low = np.where(kinds == 0, rng.integers(0, 8, n),
                       rng.integers(0, 64, n))
        plain = MAKE.tiff_file(np.zeros((H, W, 1), np.uint8), 1, bits=4)
        data = MAKE.restriped(plain, bytes((kinds | low).astype(np.uint8)),
                          32809)
        assert _same(data, "x.png", tmp_path)


def _webp_and_ojpeg() -> dict:
    rgb = np.random.default_rng(5).integers(0, 256, (16, 24, 3)).astype(
        np.uint8)
    jpeg = MAKE.pil_bytes(rgb, "JPEG", quality=90)
    ojpeg = bytearray(MAKE.restriped(MAKE.tiff_file(
        rgb, 6, extra_tags=((513, 4, [0]), (514, 4, [len(jpeg)]),
                            (530, 3, [2, 2]))), jpeg, 6))
    at = ojpeg.index(struct.pack("<HHI", 513, 4, 1))
    ojpeg[at + 8:at + 12] = struct.pack("<I", len(ojpeg) - len(jpeg))
    return {"webp": MAKE.restriped(MAKE.tiff_file(rgb, 2), MAKE.pil_bytes(
        rgb, "WEBP", lossless=True), 50001), "old_style_jpeg": bytes(ojpeg)}


@pytest.mark.parametrize("case", ["webp", "old_style_jpeg"])
def test_codecs_pillow_reads_or_fails(tmp_path, case):
    """What this Pillow's libtiff does with the compressions the port has
    no decoder for, under ``.png``. WebP (50001): libtiff is built without
    it, Pillow opens the file and fails to load it, imageio fails, and the
    port refuses it the same way. Old-style JPEG (6): Pillow reads it; the
    port refuses it with a ``ValueError`` that names the compression, a
    gap listed in ROADMAP.md Queue 1."""
    data = _webp_and_ojpeg()[case]
    assert P.open_tiff(data, "x.png") is not None
    Image.open(io.BytesIO(data))               # Pillow opens each
    want = _imageio(data, tmp_path / "x.png")
    if case == "webp":
        with pytest.raises(OSError):
            Image.open(io.BytesIO(data)).load()
        assert want is None
        with pytest.raises(ValueError, match="WEBP compression support is "
                                             "not configured"):
            F.decode_image(data, "x.png")
        return
    assert want is not None and want.shape == (16, 24, 3)
    with pytest.raises(ValueError, match=r"x.png: TIFF \(Pillow\): "
                                         r"compression 6 \(old-style JPEG"):
        F.decode_image(data, "x.png")


# zstd_compress's frame parameters (libtiff writes level 9 frames without
# a checksum or content size; other writers set them)
_ZSTD_FRAMES = {"level_1": dict(level=1), "level_19": dict(level=19),
                "level_22": dict(level=22), "level_minus_5": dict(level=-5),
                "checksum": dict(checksum=True),
                "content_size": dict(content_size=True),
                "checksum_content_size": dict(checksum=True,
                                              content_size=True),
                "window_1k": dict(window_log=10)}


def _zstd_image(layout: str, rng) -> tuple:
    """(samples, tiff_file keywords) of a layout of the Zstandard tests."""
    y, x = np.mgrid[0:64, 0:80]
    smooth = (np.sin(x / 9.0) * np.cos(y / 7.0) * 120 + 128).astype(np.int64)
    if layout == "grey_two_blocks":     # past a block of 128 KiB
        g = np.tile(smooth, (6, 5))[:380, :380] + rng.integers(0, 3, (380, 380))
        return g.astype(np.uint8)[..., None], dict(photometric=1)
    rgb = np.stack([smooth, smooth.T[:64, :64].repeat(2, 1)[:, :80],
                    255 - smooth], -1) + rng.integers(0, 4, (64, 80, 3))
    if layout == "rgb16_predictor_big_endian":
        return (rgb * 257).astype(np.uint16), dict(photometric=2, order=">",
                                                   predictor=2)
    if layout == "tiles":
        return rgb.astype(np.uint8), dict(photometric=2, tile=(32, 32))
    return rgb.astype(np.uint8), dict(photometric=2, planar=2,
                                      rows_per_strip=16)


@pytest.mark.parametrize("layout", ["grey_two_blocks",
                                    "rgb16_predictor_big_endian", "tiles",
                                    "planes_in_strips"])
@pytest.mark.parametrize("frame", sorted(_ZSTD_FRAMES))
def test_zstd_reads_as_pillow(tmp_path, monkeypatch, frame, layout):
    """Zstandard (compression 50000, libtiff's tif_zstd.c over libzstd)
    under ``.png``: frames of libzstd's levels (negative, fast, high, ultra:
    raw, RLE and compressed blocks, Huffman literals in one and four
    streams and with the last block's tree, FSE, RLE, predefined and
    repeated sequence tables, repeat offsets), with a checksum, a content
    size, a 1 KiB window; in strips past one block, with 16-bit samples
    and the predictor, in tiles and separate planes. The port's samples
    are imageio's to the bit."""
    samples, kw = _zstd_image(layout, np.random.default_rng(len(layout)))
    monkeypatch.setitem(MAKE.TIFF_COMPRESS, 50000, lambda b: MAKE
                        .zstd_compress(b, **_ZSTD_FRAMES[frame]))
    data = MAKE.tiff_file(samples, kw.pop("photometric"), compression=50000,
                          **kw)
    assert _imageio(data, tmp_path / "x.png") is not None
    assert _same(data, "x.png", tmp_path)


def test_zstd_as_pillow_writes_it(tmp_path):
    """Pillow's own Zstandard TIFFs (libtiff's streaming frames: no
    content size, no checksum), grey, RGB and RGBA, in strips."""
    rng = np.random.default_rng(9)
    for shape in ((37, 29), (200, 300, 3), (64, 64, 4)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        img[: shape[0] // 2] //= 16
        data = MAKE.pil_bytes(img, "TIFF", compression="zstd")
        assert _same(data, "x.png", tmp_path)


@pytest.mark.parametrize("seed", range(8))
def test_zstd_corrupt_strips_as_pillow(tmp_path, seed):
    """Zstandard strips with bytes set, cut or followed by others
    (``torch_textures/zstd_vs_pillow.py``, which runs more): the port
    reads what imageio reads under ``.png``, or both refuse (libzstd's
    errors, including its fast loop over four Huffman streams, which checks
    no stream's end; libtiff's "Not enough data"; a stream that stops once
    its block passes the strip's end, or copies what the data holds of a
    raw block that runs past it)."""
    for trial, data in enumerate(ZSTD.strips(200 + seed, 30)):
        assert _same(data, "x.png", tmp_path), (seed, trial)
