"""OBJ textures in every format the JAX retarget path reads: the port's
``apps/retarget.load_obj_mesh`` (``_find_texture`` over
``viz/image_files.read_image``: PNG, BMP, TGA, GIF and TIFF in NumPy with
the host library's LZW, PackBits and run-length expansions, JPEG and WebP
in the host library's decoders) against the JAX package's (imageio) on the
fixtures of ``tests/torch_textures/``, which ``make_textures.py`` writes
with Pillow and its own writers and describes in ``MANIFEST.json``.

Where the JAX texture is an (H, W, 3) float image in [0, 1] the port's is
equal to the bit, on every key of the mesh. Where it is not (grey: imageio
gives (H, W) and the JAX ``[..., :3]`` keeps 3 columns; grey + alpha: 2
channels; 16-bit samples divided by 255; 1-bit grey as bool; and for TIFF:
palette indices, planar (C, H, W), several pages, CMYK samples, float
samples divided by 255, min-is-white levels) the port's is imageio's
pixels under the rule of ``texture_rgb``'s docstring (``ROADMAP.md``
Queue 3), and the JAX texture differs from it.
"""
from __future__ import annotations

import hashlib
import importlib.util
import io
import json
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from neural_marionette_tpu.apps import retarget as JRT
from neural_marionette_tpu_torch.apps import retarget as PRT
from neural_marionette_tpu_torch.data import native
from neural_marionette_tpu_torch.viz import image_files as F

TEX = Path(__file__).resolve().parent / "torch_textures"
MANIFEST = json.loads((TEX / "MANIFEST.json").read_text())["files"]
with np.load(TEX / "expected.npz") as _npz:
    EXPECTED = {k: _npz[k] for k in _npz.files}
READ = [e for e in MANIFEST if "raises" not in e]
REFUSED = [e for e in MANIFEST if "raises" in e]
_spec = importlib.util.spec_from_file_location("make_textures",
                                               TEX / "make_textures.py")
MAKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(MAKE)


def _ids(entries):
    return [e["file"] for e in entries]


def _expected(entry) -> np.ndarray:
    return EXPECTED[entry["key"]].astype(np.float32) / np.float32(
        entry["divisor"])


def _write_obj(root: Path, texture: Path) -> Path:
    """A UV-mapped quad (two triangles) whose MTL names a copy of
    ``texture``."""
    root.mkdir(parents=True, exist_ok=True)
    (root / texture.name).write_bytes(texture.read_bytes())
    (root / "target.obj").write_text(
        "mtllib target.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0.5\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "f 1/1 2/2 3/3 4/4\n")
    (root / "target.mtl").write_text(f"newmtl m\nmap_Kd {texture.name}\n")
    return root / "target.obj"


@pytest.mark.parametrize("entry", READ, ids=_ids(READ))
def test_texture_reads_like_jax(tmp_path, entry):
    """The port's mesh, texture included, against the JAX one and the
    manifest."""
    obj = _write_obj(tmp_path, TEX / entry["file"])
    p = PRT.load_obj_mesh(str(obj))
    tex = p["texture"]
    assert tex.dtype == np.float32 and tex.shape == tuple(entry["shape"])
    assert 0.0 <= tex.min() and tex.max() <= 1.0
    if "sha256" in entry:
        pixels = F.read_image(str(TEX / entry["file"]))
        assert hashlib.sha256(pixels.tobytes()).hexdigest() == \
            entry["sha256"]
        assert np.array_equal(tex, pixels.astype(np.float32) / 255.0)
    else:
        assert np.array_equal(tex, _expected(entry))
    j = JRT.load_obj_mesh(str(obj))
    assert set(j) == set(p)
    for key in j:
        if key == "texture" and not entry["jax_well_formed"]:
            # a fault of the JAX function that the port does not share:
            # a malformed texture, or (the TIFF rules: planar, CMYK,
            # float) an (H, W, 3) one in [0, 1] that is not the image
            assert j[key].ndim != 3 or j[key].shape[-1] != 3 \
                or j[key].max() > 1 or entry["facts"].get("rule"), \
                "the JAX texture is well formed"
            assert j[key].shape != p[key].shape \
                or not np.array_equal(j[key], p[key]), \
                "the JAX texture is the port's"
            continue
        assert j[key].dtype == p[key].dtype, key
        assert np.array_equal(j[key], p[key]), key


@pytest.mark.parametrize("entry", READ, ids=_ids(READ))
def test_manifest_is_what_imageio_reads(entry):
    """The fixtures stay honest: imageio still gives the manifest's
    pixels, and the expected texture is imageio's under the stated
    rule."""
    arr = np.asarray(imageio.imread(TEX / entry["file"]))
    assert list(arr.shape) == entry["imageio_shape"]
    assert str(arr.dtype) == entry["imageio_dtype"]
    assert hashlib.sha256(arr.tobytes()).hexdigest() == \
        entry["imageio_sha256"]
    if "sha256" in entry:
        assert hashlib.sha256(arr.tobytes()).hexdigest() == entry["sha256"]
        return
    rgb, divisor, well = MAKE.expected(arr, entry["facts"].get("rule"),
                                       TEX / entry["file"])
    assert (divisor, well) == (entry["divisor"], entry["jax_well_formed"])
    assert np.array_equal(rgb, EXPECTED[entry["key"]])


@pytest.mark.parametrize("entry", REFUSED, ids=_ids(REFUSED))
def test_refused_texture_raises_naming_it(tmp_path, entry):
    """What neither imageio nor the port reads (a truncated GIF or WebP, a
    bad LZW code, a BMP bitfields layout or compression Pillow refuses,
    TIFF's JPEG and CCITT compressions, old-style LZW, YCbCr subsampling)
    and the JPEG processes the port's decoder does not read (CMYK,
    arithmetic coding, lossless, hierarchical, 12-bit, sampling factors
    above 2) raise ``ValueError`` naming what they are: a texture that is
    present but unreadable is never dropped."""
    obj = _write_obj(tmp_path, TEX / entry["file"])
    with pytest.raises(ValueError, match=entry["raises"]):
        PRT.load_obj_mesh(str(obj))


def _patched(name, fn):
    data = bytearray((TEX / name).read_bytes())
    fn(data)
    return bytes(data)


def _set(offset, value):
    def fn(data):
        data[offset] = value
    return fn


def _first_scans(k):
    """Keep a progressive JPEG's first ``k`` scans, then EOI."""
    def fn(data):
        sos = [i for i in range(len(data) - 1)
               if data[i] == 0xFF and data[i + 1] == 0xDA]
        data[sos[k]:] = b"\xff\xd9"
    return fn


def _without_dht(data):
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        n = 2 + (data[pos + 2] << 8 | data[pos + 3])
        if data[pos + 1] != 0xC4:
            out += data[pos:pos + n]
        pos += n
    data[:] = out + data[pos:]


def _tiff(**kw):
    """A small TIFF of the generator's writer, in place of the fixture."""
    def fn(data):
        data[:] = MAKE.tiff_file(**kw)
    return fn


_SIGNED = np.arange(-60, 60, dtype=np.int8).reshape(8, 15, 1)

# variants that imageio reads and the port refuses, each listed in
# ROADMAP.md: (fixture, patch, file name, the ValueError's words)
UNREAD = {
    "tiff_signed_samples": ("other.tif", _tiff(
        samples=_SIGNED, photometric=1, sample_format=2), "x.tif",
        "signed 8-bit samples"),
    "tiff_ycbcr_unsubsampled": ("other.tif", _tiff(
        samples=np.zeros((8, 8, 3), np.uint8), photometric=6,
        extra_tags=((530, 3, [1, 1]),)), "x.tif", "YCbCr"),
    "jpeg_without_huffman_tables": ("jpeg_baseline_420.jpg", _without_dht,
                                    "x.jpg", "Huffman table DC 0 not"),
    "jpeg_progressive_unrefined": ("jpeg_progressive_420.jpg",
                                   _first_scans(2), "x.jpg",
                                   "block smoothing"),
}


@pytest.mark.parametrize("case", sorted(UNREAD))
def test_unread_variant_raises(tmp_path, case):
    """Files imageio reads that the port does not (yet): each raises
    ``ValueError`` saying what it is, and imageio does read it."""
    name, patch, out, words = UNREAD[case]
    path = tmp_path / out
    path.write_bytes(_patched(name, patch))
    assert np.asarray(imageio.imread(path)).size
    with pytest.raises(ValueError, match=words):
        F.read_image(str(path))


# variants the port refused until it read them: (fixture, patch, name)
PATCHED = {
    "bmp_rle8": ("bmp_palette8.bmp", _set(30, 1), "x.bmp"),
    "bmp_16bit": ("bmp_24.bmp", _set(28, 16), "x.bmp"),
    "tga_16bit": ("tga_rgb.tga", _set(16, 16), "x.tga"),
}


@pytest.mark.parametrize("case", sorted(PATCHED))
def test_patched_variant_reads_like_imageio(tmp_path, case):
    """A fixture's header patched into another variant (an uncompressed
    palette image read as BI_RLE8, 24-bit pixels read at 16 bits, a TGA
    read as A1R5G5B5): the port's samples are imageio's, to the bit."""
    name, patch, out = PATCHED[case]
    path = tmp_path / out
    path.write_bytes(_patched(name, patch))
    want = np.asarray(imageio.imread(path))
    got = F.read_image(str(path))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_read_image_dispatch_and_samples():
    """``image_format`` by magic number (TGA by its header or extension);
    ``read_image``'s samples per colour type; ``jpeg_info``'s facts."""
    fmt = {e["file"]: F.image_format((TEX / e["file"]).read_bytes(),
                                     e["file"]) for e in MANIFEST}
    for name, want in fmt.items():
        ext = {"jpg": "JPEG", "png": "PNG", "bmp": "BMP", "tga": "TGA",
               "dat": "TGA", "gif": "GIF", "tif": "TIFF", "webp": "WebP"}
        assert want == ext[name.rsplit(".", 1)[1]], name
    assert F.image_format(b"\x00" * 40, "x.tga") == "TGA"
    assert F.image_format(b"\x07" * 40, "x.bin") == "unknown"
    assert F.read_png(str(TEX / "png_grey16.png")).dtype == np.uint16
    assert F.read_png(str(TEX / "png_grey_alpha8.png")).shape == (29, 37, 2)
    assert F.read_png(str(TEX / "png_palette4_adam7_trns.png")).shape == \
        (29, 37, 3)
    assert F.read_image(str(TEX / "jpeg_grey.jpg")).shape == (29, 37, 1)
    info = native.jpeg_info((TEX / "jpeg_progressive_420.jpg").read_bytes())
    assert info == dict(width=37, height=29, channels=3,
                        process="progressive")
    info = native.jpeg_info((TEX / "jpeg_extended_sof1.jpg").read_bytes())
    assert info["process"] == "extended sequential"
    with pytest.raises(ValueError, match="unknown"):
        F.decode_image(b"\x07" * 40, "x.bin")
    # the new formats' samples: grey GIF, 16-bit and float TIFF, a palette
    # TIFF's colour map, RGBA WebP and TGA
    assert F.read_image(str(TEX / "gif_grey_ramp.gif")).shape == (29, 37, 1)
    assert F.read_image(str(TEX / "tiff_grey16.tif")).dtype == np.uint16
    assert F.read_image(str(TEX / "tiff_float32_grey.tif")).dtype == \
        np.float32
    assert F.read_image(str(TEX / "tiff_palette8.tif")).dtype == np.uint16
    assert F.read_image(str(TEX / "tiff_rgb_planar.tif")).shape == \
        (29, 37, 3)
    assert F.read_image(str(TEX / "tga_rgb16.tga")).shape == (29, 37, 4)
    info = native.webp_info((TEX / "webp_lossless_rgba.webp").read_bytes())
    assert info == dict(width=37, height=29, channels=4, lossless=True,
                        animated=False)
    info = native.webp_info(
        (TEX / "webp_animated_offset_frame.webp").read_bytes())
    assert info["animated"] and info["channels"] == 4
    assert native.webp_info((TEX / "webp_lossy_q90.webp").read_bytes()) == \
        dict(width=37, height=29, channels=3, lossless=False, animated=False)


_FUZZ = [e["file"] for e in READ if "sha256" not in e]


@settings(max_examples=1000, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(name=st.sampled_from(_FUZZ),
       flips=st.lists(st.tuples(st.integers(0, 1 << 20),
                                st.integers(0, 255)), max_size=4),
       cut=st.one_of(st.none(), st.integers(0, 1 << 20)))
def test_corrupt_jpeg_and_png_raise_or_read(name, flips, cut):
    """Bytes set and the file cut at random, in every fixture the port
    reads (PNG, JPEG, BMP, TGA, GIF, TIFF, WebP): ``decode_image`` raises
    ``ValueError`` or returns well-formed samples, and never takes the
    process down (the host library bounds-checks every read)."""
    data = bytearray((TEX / name).read_bytes())
    for pos, value in flips:
        data[pos % len(data)] = value
    if cut is not None:
        data = data[:cut % (len(data) + 1)]
    try:
        img = F.decode_image(bytes(data), name)
    except ValueError:
        return
    assert img.ndim == 3 and img.shape[-1] in (1, 2, 3, 4) and img.size
    assert img.dtype in (np.uint8, np.uint16, np.float32)
    tex = PRT.texture_rgb(img)
    assert tex.shape == img.shape[:2] + (3,)
    assert np.isfinite(tex).all() and 0 <= tex.min() and tex.max() <= 1
