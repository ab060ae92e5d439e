"""OBJ textures in every format the JAX retarget path reads: the port's
``apps/retarget.load_obj_mesh`` (``_find_texture`` over
``viz/image_files.read_image``: PNG and BMP/TGA in NumPy, JPEG in the host
library's decoder) against the JAX package's (imageio) on the fixtures of
``tests/torch_textures/``, which ``make_textures.py`` writes with Pillow
and describes in ``MANIFEST.json``.

Where the JAX texture is an (H, W, 3) float image in [0, 1] the port's is
equal to the bit, on every key of the mesh. Where it is not (grey: imageio
gives (H, W) and the JAX ``[..., :3]`` keeps 3 columns; grey + alpha: 2
channels; 16-bit grey divided by 255; 1-bit grey as bool) the port's is
imageio's pixels under the stated rule: grey replicated, alpha dropped, a
sample of d bits divided by 2^d - 1.
"""
from __future__ import annotations

import hashlib
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
            assert j[key].ndim != 3 or j[key].shape[-1] != 3 \
                or j[key].max() > 1, "the JAX texture is well formed"
            continue
        assert j[key].dtype == p[key].dtype, key
        assert np.array_equal(j[key], p[key]), key


@pytest.mark.parametrize("entry", READ, ids=_ids(READ))
def test_manifest_is_what_imageio_reads(entry):
    """The fixtures stay honest: imageio still gives the manifest's
    pixels."""
    arr = np.asarray(imageio.imread(TEX / entry["file"]))
    assert list(arr.shape) == entry["imageio_shape"]
    assert str(arr.dtype) == entry["imageio_dtype"]
    if "sha256" in entry:
        assert hashlib.sha256(arr.tobytes()).hexdigest() == entry["sha256"]
        return
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    rgb = arr[..., :3] if arr.shape[-1] >= 3 else np.repeat(arr[..., :1], 3,
                                                           -1)
    assert np.array_equal(rgb, EXPECTED[entry["key"]])


@pytest.mark.parametrize("entry", REFUSED, ids=_ids(REFUSED))
def test_refused_texture_raises_naming_it(tmp_path, entry):
    """GIF, TIFF, WebP and the JPEG processes the decoder does not read
    (CMYK, arithmetic coding, lossless, hierarchical, 12-bit, sampling
    factors above 2) raise ``ValueError`` naming what they are: a texture
    that is present but unreadable is never dropped."""
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


# variants that imageio reads and the port refuses, each listed in
# ROADMAP.md Queue 1: (fixture, patch, file name, the ValueError's words)
UNREAD = {
    "bmp_rle8": ("bmp_palette8.bmp", _set(30, 1), "x.bmp", "compression 1"),
    "bmp_16bit": ("bmp_24.bmp", _set(28, 16), "x.bmp", "16 bits"),
    "tga_16bit": ("tga_rgb.tga", _set(16, 16), "x.tga", "type 2 at 16"),
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


_FUZZ = [e["file"] for e in READ if e["file"].endswith((".jpg", ".png"))
         and "sha256" not in e]

@settings(max_examples=400, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(name=st.sampled_from(_FUZZ),
       flips=st.lists(st.tuples(st.integers(0, 1 << 20),
                                st.integers(0, 255)), max_size=4),
       cut=st.one_of(st.none(), st.integers(0, 1 << 20)))
def test_corrupt_jpeg_and_png_raise_or_read(name, flips, cut):
    """Bytes set and the file cut at random: ``decode_image`` raises
    ``ValueError`` or returns well-formed samples, and never takes the
    process down (the JPEG decoder bounds-checks every read)."""
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
    assert img.dtype in (np.uint8, np.uint16)
    tex = PRT.texture_rgb(img)
    assert tex.shape == img.shape[:2] + (3,)
    assert np.isfinite(tex).all() and 0 <= tex.min() and tex.max() <= 1
