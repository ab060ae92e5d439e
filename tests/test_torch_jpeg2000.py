"""JPEG 2000 through the port's ``viz/image_files.decode_image`` (the JP2
boxes of ``viz/jpeg2000.py``, the codestream in ``csrc/nm_jp2.cpp``)
against imageio (Pillow over OpenJPEG) on files Pillow writes here with
each encoder option, on codestreams its OpenJPEG writes with the options
Pillow does not pass on, on JP2 headers patched into every variant Pillow
and OpenJPEG treat apart, and on codestreams whose components are
sub-sampled:
equal to the bit where imageio reads the file, ``ValueError`` where it
refuses it.
"""
from __future__ import annotations

import ctypes
import importlib.util
import io
import struct
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest

from neural_marionette_tpu_torch.data import native
from neural_marionette_tpu_torch.viz import image_files as F
from neural_marionette_tpu_torch.viz.tiff import cmyk_to_rgb

TEX = Path(__file__).resolve().parent / "torch_textures"
_spec = importlib.util.spec_from_file_location("make_textures",
                                               TEX / "make_textures.py")
MAKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(MAKE)

RGB = MAKE.textured(29, 37, 11)


def _pillow(mode="RGB", size=None, **kw):
    from PIL import Image
    img = RGB if size is None else MAKE.textured(*size, 12)
    if mode == "I;16":
        im = Image.fromarray(img[..., 0].astype(np.uint16) * 257
                             + np.uint16(5))
    else:
        im = Image.fromarray(img).convert(mode)
    return MAKE.pil_bytes(im, "JPEG2000", **kw)


def _imageio(data: bytes):
    """imageio's samples as the port gives them, or None where it
    refuses the file."""
    from PIL import Image
    try:
        arr = np.asarray(imageio.imread(io.BytesIO(data)))
    except Exception:
        return None
    if Image.open(io.BytesIO(data)).mode == "CMYK":
        arr = cmyk_to_rgb(arr)     # the CMYK rule
    return arr if arr.ndim == 3 else arr[..., None]


def _same_as_imageio(data: bytes):
    want = _imageio(data)
    if want is None:
        with pytest.raises(ValueError, match="JPEG 2000"):
            F.decode_image(data, "x.jp2")
        return
    got = F.decode_image(data, "x.jp2")
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


# encoder options, each read back as a JP2 file and as a raw codestream
OPTIONS = {
    "grey_53": dict(mode="L"),
    "grey_alpha_97": dict(mode="LA", irreversible=True),
    "rgba_97_ict": dict(mode="RGBA", irreversible=True, mct=1),
    "i16_97": dict(mode="I;16", irreversible=True),
    "i16_layers": dict(mode="I;16", quality_layers=[30, 10]),
    "ycbcr_97": dict(mode="YCbCr", irreversible=True),
    "cmyk_97": dict(mode="CMYK", irreversible=True),
    "rct_layers": dict(mct=1, quality_layers=[50, 20, 5]),
    "ict_rate": dict(irreversible=True, mct=1, quality_layers=[80]),
    "ict_fixed_quality": dict(irreversible=True, mct=1,
                              quality_mode="dB", quality_layers=[30, 45]),
    "tiles_97": dict(tile_size=(16, 16), irreversible=True),
    "offset_tiles": dict(offset=(5, 1), tile_offset=(4, 0),
                         tile_size=(13, 9)),
    "precincts_97_rpcl": dict(precinct_size=(16, 16), progression="RPCL",
                              irreversible=True, quality_layers=[20, 6]),
    "precincts_pcrl_tiles": dict(precinct_size=(32, 16), progression="PCRL",
                                 tile_size=(24, 20)),
    "cprl_offset": dict(progression="CPRL", offset=(3, 3),
                        tile_size=(64, 64), precinct_size=(32, 32)),
    "rlcp_layers": dict(progression="RLCP", quality_layers=[40, 15, 4]),
    "codeblocks_4x64": dict(codeblock_size=(4, 64)),
    "codeblocks_32x32_97": dict(codeblock_size=(32, 32), irreversible=True),
    "resolutions_2": dict(num_resolutions=2, irreversible=True),
    "signed_97": dict(signed=True, irreversible=True),
    "signed_grey": dict(mode="L", signed=True),
    "plt_layers": dict(plt=True, quality_layers=[20, 8]),
    "cinema4k": dict(cinema_mode="cinema4k-24"),
    "one_row": dict(size=(1, 37), num_resolutions=1),
    "one_column_97": dict(size=(29, 1), irreversible=True,
                          num_resolutions=1),
}


@pytest.mark.parametrize("raw", [False, True], ids=["jp2", "j2k"])
@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_encoder_options_read_like_imageio(case, raw):
    """A file Pillow writes with each option reads as imageio reads it."""
    kw = dict(OPTIONS[case])
    _same_as_imageio(_pillow(no_jp2=raw, **kw))


def _header(data, fn):
    return MAKE.jp2_header(data, fn)


def _ihdr(**fields):
    def fn(h):
        body = bytearray(h[0][1])
        for key, (at, fmt) in dict(height=(0, ">I"), width=(4, ">I"),
                                   nc=(8, ">H"), bpc=(10, ">B")).items():
            if key in fields:
                body[at:at + struct.calcsize(fmt)] = struct.pack(
                    fmt, fields[key])
        return [[b"ihdr", bytes(body)]] + h[1:]
    return fn


_PALETTE = [tuple(int(v) for v in c) for c in
            MAKE.textured(16, 16, 13).reshape(-1, 3)]
# (the file Pillow writes: "rgb" or "grey", the patch of its jp2h boxes)
HEADERS = {
    "four_components_in_ihdr": ("rgb", _ihdr(nc=4)),
    "two_components_in_ihdr": ("rgb", _ihdr(nc=2)),
    "16_bits_in_ihdr": ("grey", _ihdr(bpc=15)),
    "wider_ihdr": ("rgb", _ihdr(width=38)),
    "shorter_ihdr": ("rgb", _ihdr(height=28)),
    "no_colr": ("rgb", lambda h: h[:1]),
    "colr_first": ("rgb", lambda h: h[::-1]),
    "colr_unknown_space": ("rgb", lambda h: h[:1] + [MAKE.colr(20)]),
    "colr_esycc": ("rgb", lambda h: h[:1] + [MAKE.colr(24)]),
    "colr_sycc": ("rgb", lambda h: h[:1] + [MAKE.colr(18)]),
    "colr_method_3": ("rgb", lambda h: h[:1] + [[b"colr", b"\x03\x00\x00"
                                                 + b"\x00" * 4]]),
    "colr_short": ("rgb", lambda h: h[:1] + [[b"colr", b"\x01\x00\x00"]]),
    "two_colr_grey_first": ("rgb", lambda h: h[:1] + [MAKE.colr(17)]
                            + h[1:]),
    "second_ihdr": ("rgb", lambda h: h[:1] + h),
    "no_ihdr": ("rgb", lambda h: h[1:]),
    "res_box": ("rgb", lambda h: h + [[b"res ", MAKE.jp2_join([[
        b"resc", struct.pack(">HHHHBB", 3, 1, 3, 1, 0, 2)]])]]),
    "res_box_short": ("rgb", lambda h: h + [[b"res ", MAKE.jp2_join([[
        b"resc", b"\x00\x01"]])]]),
    "cdef_zero": ("rgb", lambda h: h + [[b"cdef", b"\x00\x00"]]),
    "pclr": ("grey", lambda h: h[:1] + [MAKE.colr(16)]
             + MAKE.pclr(_PALETTE)),
    "pclr_without_cmap": ("grey", lambda h: h[:1] + [MAKE.colr(16)]
                          + MAKE.pclr(_PALETTE)[:1]),
    "pclr_grey_colr": ("grey", lambda h: h[:1] + [MAKE.colr(17)]
                       + MAKE.pclr(_PALETTE)),
    "pclr_repeated_colours": ("grey", lambda h: h[:1] + [MAKE.colr(16)]
                              + MAKE.pclr([(1, 2, 3)] * 9 + _PALETTE[9:])),
    "pclr_10_entries": ("grey", lambda h: h[:1] + [MAKE.colr(16)]
                        + MAKE.pclr(_PALETTE[:10])),
    "pclr_one_column": ("grey", lambda h: h[:1] + [MAKE.colr(16)]
                        + MAKE.pclr([(i,) for i in range(256)])),
    "pclr_two_columns": ("grey", lambda h: h[:1] + [MAKE.colr(16)]
                         + MAKE.pclr([(i, 255 - i) for i in range(256)])),
    "pclr_rgba_few": ("grey", lambda h: h[:1] + [MAKE.colr(16)]
                      + MAKE.pclr([(1, 2, 3, 4)] * 2 + [(5, 6, 7, 8)])),
    "pclr_16_bit": ("grey", lambda h: h[:1] + [MAKE.colr(16)]
                    + MAKE.pclr([(0, 0, 0)] * 4, depth=15)),
    "cmap_without_pclr": ("grey", lambda h: h + MAKE.pclr(_PALETTE)[1:]),
}


@pytest.mark.parametrize("case", sorted(HEADERS))
def test_patched_header_reads_like_imageio(case):
    """A Pillow file's jp2h boxes patched: Pillow's mode, palette and size,
    OpenJPEG's colour space and checks, as imageio meets them."""
    base, patch = HEADERS[case]
    data = _pillow("L" if base == "grey" else "RGB")
    _same_as_imageio(_header(data, patch))


def _top(data, fn):
    return MAKE.jp2_join(fn(MAKE.jp2_boxes(data)))


# the file's top-level boxes and codestream, patched
FILES = {
    "jpx_brand": lambda d: _top(d, lambda b: [b[0], [b"ftyp", b"jpx "
                                                     + b[1][1][4:]]] + b[2:]),
    "no_ftyp": lambda d: _top(d, lambda b: [b[0]] + b[2:]),
    "box_after_codestream": lambda d: d + MAKE.jp2_join([[b"xml ",
                                                          b"<a/>"]]),
    "bytes_after_codestream": lambda d: d + b"\x00\x01\x02",
    "codestream_to_end": lambda d: d[:d.index(b"jp2c") - 4] + bytes(4)
    + d[d.index(b"jp2c"):],
    "codestream_before_jp2h": lambda d: _top(d, lambda b: b[:2] + b[3:]
                                             + b[2:3]),
    "cut_1": lambda d: d[:-1],
    "cut_2": lambda d: d[:-2],
    "cut_in_data": lambda d: d[:-25],
    "marker_before_eoc": lambda d: d[:-2] + b"\xff\x64\x00\x04ab\xff\xd9",
}


@pytest.mark.parametrize("case", sorted(FILES))
def test_patched_file_reads_like_imageio(case):
    """The box order and the codestream's end, as OpenJPEG checks them."""
    _same_as_imageio(FILES[case](_pillow()))


@pytest.mark.parametrize("factors", [(1, 2, 2), (1, 1, 2), (1, 2, 1),
                                     (2, 2, 2), (1, 3, 3), (2, 4, 4)],
                         ids=lambda f: "x".join(map(str, f)))
def test_subsampled_components_read_like_imageio(factors):
    """Components sub-sampled in the codestream: OpenJPEG's sYCC guess and
    Pillow's indexing by width // factor."""
    _same_as_imageio(MAKE.j2k_subsampled(RGB, factors))


_PLANES = [RGB[..., c] for c in range(3)]
# encoder parameters Pillow does not pass on, through its own OpenJPEG
OPENJPEG = {
    "bypass_97_layers": dict(mode=1, irreversible=1, rates=(50, 20, 6)),
    "reset_termall_53": dict(mode=6),
    "vertically_causal_97": dict(mode=8, irreversible=1, rates=(8,)),
    "segsym_pterm_layers": dict(mode=48, rates=(30, 0)),
    "bypass_vertically_causal_53": dict(mode=9),
    "all_styles_precincts": dict(mode=63, prcw_init=(32, 16), prch_init=(
        32, 16), res_spec=2, csty=1, irreversible=1, rates=(20, 5)),
    "sop_eph_rpcl_97": dict(csty=6, prog_order=2, irreversible=1,
                            rates=(25, 4)),
    "eph_pcrl_mct": dict(csty=4, prog_order=3, tcp_mct=b"\x01"),
    "poc_lrcp_rlcp": dict(rates=(30, 0), pocs=[(0, 0, 2, 3, 3, 0),
                                                (3, 0, 2, 4, 3, 1)]),
    "poc_components": dict(irreversible=1, pocs=[(0, 0, 1, 4, 1, 4),
                                                  (0, 1, 1, 4, 3, 2)]),
    "rgn_97": dict(roi_compno=1, roi_shift=9, irreversible=1, rates=(15,)),
    "rgn_rct_layers": dict(roi_compno=2, roi_shift=3, tcp_mct=b"\x01",
                           rates=(40, 0)),
}


@pytest.mark.parametrize("case", sorted(OPENJPEG))
def test_openjpeg_options_read_like_imageio(case):
    """A codestream OpenJPEG writes with a code-block style, SOP/EPH
    markers, POC progressions or a region of interest reads as imageio
    reads it."""
    kw = dict(OPENJPEG[case])
    for key in ("prcw_init", "prch_init"):
        if key in kw:
            kw[key] = (ctypes.c_int * 33)(*kw[key])
    _same_as_imageio(MAKE.openjpeg_encode(_PLANES, numresolution=4, **kw))


def test_refusals_name_what_they_are():
    """What the port does not read raises naming it: HTJ2K's code-block
    style, packed packet headers, more than 4 components, AVIF; and the
    codestream's facts read by ``jp2_info``."""
    cs = _pillow(no_jp2=True)
    info = native.jp2_info(cs)
    assert info == dict(x1=37, y1=29, x0=0, y0=0,
                        components=[(8, 0, 1, 1)] * 3)
    cod = cs.index(b"\xff\x52")
    styled = bytearray(cs)
    styled[cod + 12] = 0x40
    with pytest.raises(ValueError, match="HTJ2K"):
        F.decode_image(bytes(styled), "x.j2k")
    ppm = cs[:cod] + b"\xff\x60\x00\x03\x00" + cs[cod:]
    with pytest.raises(ValueError, match="PPM"):
        F.decode_image(ppm, "x.j2k")
    five = bytearray(cs)
    struct.pack_into(">H", five, 4, 38 + 15)
    struct.pack_into(">H", five, 40, 5)
    five[42 + 9:42 + 9] = b"\x07\x01\x01\x07\x01\x01"
    with pytest.raises(ValueError, match="5 components"):
        F.decode_image(bytes(five), "x.j2k")
    avif = b"\x00\x00\x00\x1cftypavif\x00\x00\x00\x00avifmif1miaf" + bytes(8)
    assert F.image_format(avif, "x.avif") == "AVIF"
    with pytest.raises(ValueError, match="AVIF"):
        F.decode_image(avif, "x.avif")
