"""The rest of the TIFF forms PIL reads, in the port (`utils/tiff.py`,
`utils/tiff_ycbcr.py`, `utils/ojpeg.py`, `utils/fax.py`, the compiled
`csrc/fax_decode.cc`, `csrc/image_codecs.cc` and `csrc/jpeg_decode.cc`),
against PIL, which the JAX package opens its datasets with: every layout
key of PIL's `TiffImagePlugin.OPEN_INFO` (2-, 4-, 12- and 32-bit, signed and
float samples, FillOrder 2, palette + alpha, YCbCr and CIELab without JPEG)
and every compression of its `COMPRESSION_INFO` (CCITT modified Huffman,
Group 3, Group 4, 32771, old-style JPEG, ThunderScan, old-style LZW),
Predictor 3, libtiff's RGBA reader for YCbCr (every subsampling it has a
routine for, strips and tiles, the tags' coefficients, Orientation), seeded
damage, the committed fixtures and both dataset paths against JAX.

Tolerances: every comparison is bit-equal. For each file the port's
`image_io.open_image` must give PIL's mode and `np.asarray(Image.open(f))`
(a channel axis kept; NaN equal to NaN) and `to_rgba` PIL's
`convert("RGBA")`, or raise a `ValueError` naming the file where PIL
raises (CIELab's `convert("RGBA")` is LittleCMS's transform; `utils/lab.py`
is held to it here on seeded samples and every grid corner). Two readings
PIL makes of damaged data are
refused by name (ROADMAP section 3): Group 4 data that ends before its
strip's last row (libtiff leaves the rest of PIL's strip buffer unwritten,
so PIL's pixels there are whatever its memory held) and Group 3 data that
ends before its strip's last row (libtiff's recovery past the data's end
is not followed). Files are PIL's own where PIL writes the form, else
`tests/torch_image_writers.py`'s. Images are at most 64x80, made from
`np.random.default_rng(seed)`.

The compiled decoders are built here with the host's `c++`; tests that
need them skip, with the reason, only where no C++ compiler exists.
"""

import functools
import hashlib
import io
import json
import os
import sys

import numpy as np
import pytest
from PIL import Image, TiffImagePlugin

from gaussian_splatting_tpu.scene import dataset_readers as jreaders
from gaussian_splatting_torch.scene import dataset_readers
from gaussian_splatting_torch.utils import cuda_build, image_io, tiff
from test_torch_image_forms import (  # noqa: F401  (cxx, fake_cxx: fixtures)
    assert_refused, cxx, fake_cxx, samples, smooth, write_colmap_dataset_of,
)
from test_torch_scene import assert_same_cameras
from torch_image_writers import (
    lzw_compat_encode, ojpeg_tiff, reverse_bits, thunderscan_encode, tiff_bytes,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_tiff_rest")
PREFIX_ORDER = {b"II": "<", b"MM": ">"}


def pil_read(data: bytes):
    """(mode, pixels with a channel axis, convert("RGBA")) by PIL."""
    im = Image.open(io.BytesIO(data))
    a = np.asarray(im)
    return im.mode, a[..., None] if a.ndim == 2 else a, np.asarray(im.convert("RGBA"))


def follows(tmp_path, data: bytes, label="", refusal=None):
    """The port reads `data` as PIL does (mode, pixels with their dtype and
    shape, NaN equal to NaN, RGBA) and returns
    the `Picture`; where PIL raises the port raises a ValueError naming the
    file and this returns None. `refusal`: a pattern of a named refusal the
    port may make where PIL reads (the readings the module docstring names);
    "refused" is returned then."""
    try:
        want = pil_read(data)
    except Exception:  # noqa: BLE001  (any of PIL's errors: the port must raise too)
        want = None
    path = tmp_path / "view.tif"
    path.write_bytes(data)
    if want is None:
        with pytest.raises(ValueError) as err:
            image_io.open_image(path)
        assert str(path) in str(err.value), label
        return None
    try:
        got = image_io.open_image(path)
    except ValueError as err:
        if refusal is not None and str(path) in str(err):
            assert pytest.importorskip("re").search(refusal, str(err)), (label, str(err))
            return "refused"
        raise AssertionError(f"{label}: PIL reads {want[0]}, the port raises {err}") from None
    assert got.mode == want[0], (label, got.mode, want[0])
    assert got.pixels.dtype == want[1].dtype and got.pixels.shape == want[1].shape, (label, got.pixels.dtype,
                                                                                     want[1].dtype)
    np.testing.assert_array_equal(got.pixels, want[1], err_msg=str(label))
    np.testing.assert_array_equal(image_io.to_rgba(got), want[2], err_msg=str(label))
    return got


def jpeg(a, subsampling, restart_rows=None, quality=90) -> bytes:
    buf = io.BytesIO()
    options = {"quality": quality, "subsampling": subsampling}
    if restart_rows:
        options["restart_marker_rows"] = restart_rows
    Image.fromarray(np.ascontiguousarray(a)).save(buf, "JPEG", **options)
    return buf.getvalue()


def pil_tiff(im, **options) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "TIFF", **options)
    return buf.getvalue()


def flips(data: bytes, lo: int, hi: int, seed: int) -> bytes:
    """`data` with 1 to 3 seeded bytes in [lo, hi) XORed with a seeded nonzero byte."""
    rng = np.random.default_rng(seed)
    out = bytearray(data)
    for _ in range(1 + seed % 3):
        out[int(rng.integers(lo, hi))] ^= int(rng.integers(1, 256))
    return bytes(out)


def data_span(data: bytes):
    """(first, end) byte of a TIFF's strips or tiles."""
    tags = Image.open(io.BytesIO(data)).tag_v2
    offsets, counts = tags.get(273) or tags.get(324), tags.get(279) or tags.get(325)
    return min(offsets), max(o + c for o, c in zip(offsets, counts))


# ---- every layout key of PIL's OPEN_INFO ----

def key_samples(photo, fmt, bits, extra, seed):
    """Seeded samples for a layout: (H, W, n) ints, floats for SampleFormat 3."""
    n, depth = len(bits), bits[0]
    shape = (7, 11, n)
    if fmt == 3:
        return np.random.default_rng(seed).normal(0, 300, shape).astype(np.float32)
    if fmt == 2:
        return samples(shape, depth, seed) - (1 << (depth - 1))
    return samples(shape, depth, seed)


def key_files(key):
    """(label, TIFF bytes) of a layout key of OPEN_INFO: uncompressed and
    LZW strips of 3 rows (YCbCr: its data units 1x1)."""
    prefix, photo, fmt, fill, bits, extra = key
    order = PREFIX_ORDER[prefix]
    s = key_samples(photo, fmt[0], bits, extra, len(bits) * 7 + photo)
    colormap = samples((3 << bits[0],), 16, 3).tolist() if photo == 3 else None
    options = dict(order=order, rows_per_strip=3, extra=list(extra) or None, colormap=colormap,
                   sample_format=fmt[0] if fmt != (1,) else None, fill_order=fill if fill != 1 else None)
    if photo == 6 and len(bits) == 3:
        options["ycbcr"] = (1, 1)
    return [(f"{compression}", tiff_bytes(s, bits[0], photo, compression=compression, **options))
            for compression in (1, 5)]


OPEN_INFO_KEYS = sorted(TiffImagePlugin.OPEN_INFO, key=repr)


@pytest.mark.parametrize("key", OPEN_INFO_KEYS, ids=[
    f"{k[0].decode()}-photo{k[1]}-fmt{k[2][0]}-fill{k[3]}-{'x'.join(map(str, k[4]))}-extra{''.join(map(str, k[5]))}"
    for k in OPEN_INFO_KEYS])
def test_every_open_info_key_reads_as_pil(tmp_path, cxx, key):
    """Each layout key of PIL's OPEN_INFO (byte order, photometric,
    SampleFormat, FillOrder, bits, extra samples), uncompressed (PIL's raw
    decoder and its raw modes) and LZW (libtiff): the port gives PIL's mode
    and pixels, and raises where PIL raises; PIL reads at least one of the
    two."""
    read = 0
    for label, data in key_files(key):
        read += follows(tmp_path, data, f"{key} {label}") is not None
    assert read >= 1, key


def compression_file(name: str) -> bytes:
    """A file in one of PIL's COMPRESSION_INFO names."""
    a = smooth(21, 37, 3, 9)
    bw = a[..., 0] > 128
    if name in ("tiff_ccitt", "group3", "group4", "tiff_raw_16"):
        return pil_tiff(Image.fromarray(bw), compression=name, tiffinfo={292: 1} if name == "group3" else {})
    if name == "tiff_jpeg":
        return ojpeg_tiff([jpeg(np.pad(a, ((0, 11), (0, 0), (0, 0)), mode="edge"), 2, 1)], 37, 21,
                          rows_per_strip=16)
    if name == "tiff_thunderscan":
        return tiff_bytes((a[..., :1] >> 4).astype(np.int64), 4, 1, compression=32809, rows_per_strip=8,
                          encode=lambda c: thunderscan_encode(c[..., 0]))
    if name in ("tiff_sgilog", "tiff_sgilog24", "webp"):
        code = {v: k for k, v in TiffImagePlugin.COMPRESSION_INFO.items()}[name]
        return tiff_bytes(a, 8, 2, tags={259: (3, [code])})
    return pil_tiff(Image.fromarray(a), compression=name)


@pytest.mark.parametrize("name", sorted(TiffImagePlugin.COMPRESSION_INFO.values()))
def test_every_compression_reads_as_pil(tmp_path, cxx, name):
    """Each compression of PIL's COMPRESSION_INFO: the port gives PIL's
    pixels, or refuses by name where PIL raises (SGILog, SGILog24, WebP)."""
    data = compression_file(name)
    got = follows(tmp_path, data, name)
    if name in ("tiff_sgilog", "tiff_sgilog24", "webp"):
        assert got is None
        assert_refused(tmp_path, data, r"which PIL refuses too", ".tif")
    else:
        assert got is not None


@pytest.mark.parametrize("table", ["compression", "photometric"])
def test_refused_tables_hold_only_what_pil_refuses(tmp_path, cxx, table):
    """REFUSED_COMPRESSION and REFUSED_PHOTOMETRIC name only forms on which
    PIL raises."""
    s = samples((5, 6, 3), 8, 4)
    for code in (tiff.REFUSED_COMPRESSION if table == "compression" else tiff.REFUSED_PHOTOMETRIC):
        if table == "compression":
            data = tiff_bytes(s, 8, 2, tags={259: (3, [code])})
        else:
            data = tiff_bytes(s, 8, code)
        with pytest.raises(Exception):  # noqa: B017  (any of PIL's errors)
            Image.open(io.BytesIO(data)).load()
        assert follows(tmp_path, data, code) is None


# ---- deep, signed and float samples, Predictor 3, FillOrder 2, palette + alpha ----

NEW_LAYOUTS = [(0, 1, 2), (1, 1, 2), (0, 1, 4), (1, 1, 4), (1, 1, 12), (1, 1, 32), (3, 1, 2), (3, 1, 4),
               (1, 2, 8), (1, 2, 16), (1, 2, 32), (1, 3, 32), (0, 3, 32)]  # (photometric, SampleFormat, bits)
VARIANTS = [(1, None, None), (5, 2, (16, 16)), (8, 2, None), (32773, None, (32, 16)), (34925, None, None),
            (8, 3, None)]  # (compression, predictor, tile)


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("layout", NEW_LAYOUTS, ids=[f"photo{p}-fmt{f}-{b}bit" for p, f, b in NEW_LAYOUTS])
def test_deep_signed_and_float_samples_follow_pil(tmp_path, cxx, layout, order):
    """2-, 4-, 12- and 32-bit grey and palette, signed 8- to 32-bit and
    float32 grey, in strips of 5 rows (the last short) and overhanging
    tiles, uncompressed, LZW, deflate, PackBits and LZMA, Predictor 2 and
    3 where given (libtiff refuses 2 below 8 bits and at 12, and 3 on
    integers: PIL raises, so does the port). "MM" files through libtiff
    come out of PIL byte-swapped for the signed and float raw modes (libtiff
    gives host order, PIL unpacks the file's): the port gives those too."""
    photo, fmt, depth = layout
    h, w = 13, 37
    rng = np.random.default_rng(depth * 3 + photo)
    s = (rng.normal(0, 500, (h, w, 1)).astype(np.float32) if fmt == 3 else
         rng.integers(0, 1 << depth, (h, w, 1)) - ((1 << (depth - 1)) if fmt == 2 else 0))
    colormap = samples((3 << depth,), 16, 1).tolist() if photo == 3 else None
    read = 0
    for compression, predictor, tile in VARIANTS:
        data = tiff_bytes(s, depth, photo, order=order, compression=compression, predictor=predictor,
                          rows_per_strip=5, tile=tile, colormap=colormap, sample_format=fmt if fmt > 1 else None)
        read += follows(tmp_path, data, (compression, predictor, tile)) is not None
    if order == ">" and layout in ((1, 1, 12), (1, 1, 32)):  # OPEN_INFO has them in "II" only
        assert read == 0
    else:
        assert read >= 2


@pytest.mark.parametrize("compression", [5, 8, 50000, 34925])
def test_predictor_3_follows_pil(tmp_path, cxx, compression):
    """libtiff's floating-point predictor (byte planes, most significant
    first, then bytes accumulated across the row) on float32 grey, both
    byte orders, strips and tiles, NaN and infinities among the samples;
    an uncompressed file with the tag (PIL's raw decoder ignores it) and
    Predictor 3 on unsigned samples (libtiff refuses)."""
    from test_torch_tiff_forms import zstd_coder

    rng = np.random.default_rng(compression)
    s = rng.normal(0, 1e3, (19, 45, 1)).astype(np.float32)
    s[0, :3, 0] = [np.nan, np.inf, -np.inf]
    for order in "<>":
        for layout in (dict(rows_per_strip=7), dict(tile=(16, 16))):
            encode = None
            if compression == 50000:
                def encode(chunk):
                    from torch_image_writers import float_difference, sample_bytes

                    return zstd_coder(8)(float_difference(sample_bytes(chunk, 32, "<", 3), 1, 4)[..., None])
            data = tiff_bytes(s, 32, 1, order=order, compression=compression, predictor=3, sample_format=3,
                              encode=encode, **layout)
            assert follows(tmp_path, data, (order, layout)) is not None
    assert follows(tmp_path, tiff_bytes(s, 32, 1, tags={317: (3, [3])}, sample_format=3)) is not None
    unsigned = tiff_bytes(samples((9, 9, 1), 16, 2), 16, 1, compression=compression, tags={317: (3, [3])},
                          encode=zstd_coder(16) if compression == 50000 else None)
    assert follows(tmp_path, unsigned) is None
    assert_refused(tmp_path, unsigned, r"Predictor 3 on SampleFormat \(1,\)", ".tif")


FILL_ORDER_KEYS = sorted(tiff.FILL_ORDER_2, key=repr)


@pytest.mark.parametrize("key", FILL_ORDER_KEYS, ids=[f"photo{p}-{'x'.join(map(str, b))}" for p, b, _ in
                                                      FILL_ORDER_KEYS])
def test_fill_order_2_follows_pil(tmp_path, cxx, key):
    """FillOrder 2 in each layout OPEN_INFO has it for: uncompressed
    through PIL's bit-reversing raw modes (the four it has no unpacker for,
    P;1R, P;2R, P;4R and L;IR, raise: refused), compressed through libtiff,
    which reverses the coded bytes, in both byte orders (16 bits in "II"
    only)."""
    photo, bits, extra = key
    s = samples((9, 21, len(bits)), bits[0], sum(bits) + photo)
    colormap = samples((3 << bits[0],), 16, 5).tolist() if photo == 3 else None
    for order in ("<",) if bits[0] == 16 else "<>":
        for compression in (1, 5, 8, 32773):
            data = tiff_bytes(s, bits[0], photo, order=order, compression=compression, colormap=colormap,
                              fill_order=2, rows_per_strip=4)
            got = follows(tmp_path, data, (order, compression))
            assert (got is None) == (compression == 1 and key in tiff.FILL_ORDER_2_UNPACKED)


@pytest.mark.parametrize("compression", [1, 5, 8])
def test_palette_alpha_and_cielab_follow_pil(tmp_path, cxx, compression):
    """Palette + alpha (PA: index and alpha, the ColorMap's high bytes) and
    8-bit CIELab (LAB: the samples as stored) in both byte orders, strips
    and tiles; PIL-written PA and LAB too."""
    s = samples((11, 35, 3), 8, compression)
    for order in "<>":
        for layout in (dict(rows_per_strip=4), dict(tile=(16, 16))):
            pa = tiff_bytes(s[..., :2], 8, 3, order=order, compression=compression, extra=[2],
                            colormap=samples((768,), 16, 8).tolist(), **layout)
            assert follows(tmp_path, pa, ("PA", order, layout)).mode == "PA"
            lab = tiff_bytes(s, 8, 8, order=order, compression=compression, **layout)
            got = follows(tmp_path, lab, ("LAB", order, layout))
            assert got.mode == "LAB"
            np.testing.assert_array_equal(got.pixels, s)
    name = {1: "raw", 5: "tiff_lzw", 8: "tiff_adobe_deflate"}[compression]
    assert follows(tmp_path, pil_tiff(Image.fromarray(s.astype(np.uint8), "LAB"), compression=name)).mode == "LAB"
    pa = Image.new("PA", (9, 5))
    pa.putpalette(bytes(range(256)) * 3)
    pa.putdata([(i * 7 % 256, i * 13 % 256) for i in range(45)])
    assert follows(tmp_path, pil_tiff(pa, compression=name)).mode == "PA"


def test_cielab_to_rgba_is_littlecms_as_pil_runs_it():
    """PIL's convert("RGBA") of LAB (LittleCMS's 33-point table and its
    tetrahedral 16-bit interpolation): every corner of the table's grid
    and its neighbours, and 200,000 seeded triples, bit for bit."""
    from gaussian_splatting_torch.utils import lab

    nodes = np.unique(np.clip(np.round(np.arange(33) * 255 / 32).astype(int)[:, None] + [-1, 0, 1], 0, 255))
    grid = np.stack(np.meshgrid(nodes, nodes, nodes, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.default_rng(33)
    px = np.concatenate([grid, rng.integers(0, 256, (200_000, 3))]).astype(np.uint8)[None]
    want = np.asarray(Image.fromarray(px, "LAB").convert("RGBA"))
    np.testing.assert_array_equal(lab.lab_to_rgba(px), want)


# ---- YCbCr without JPEG: libtiff's RGBA reader ----

SUBSAMPLINGS = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)]


@pytest.mark.parametrize("sampling", SUBSAMPLINGS, ids=[f"{h}x{v}" for h, v in SUBSAMPLINGS])
def test_ycbcr_data_units_follow_libtiff(tmp_path, cxx, sampling):
    """libtiff's RGBA reader on each subsampling it has a routine for:
    strips and tiles (overhanging ones: the 4x4 routine's 4x2 skew
    included), LZW, deflate, PackBits and LZMA, Predictor 2, image sizes
    with partial units at the right and bottom edges; uncompressed strips
    through PIL's raw mode RGBX (4 bytes a pixel: garbage or a raise)."""
    h, v = sampling
    rng = np.random.default_rng(h * 10 + v)
    for width, height in ((13, 11), (9, 6), (33, 18), (5, 3)):
        s = rng.integers(0, 256, (height, width, 3))
        rows = 2 * v
        for compression, layout, predictor in ((5, dict(rows_per_strip=rows), None),
                                               (8, dict(tile=(16, 16)), None),
                                               (32773, dict(rows_per_strip=4 * v), None),
                                               (34925, dict(tile=(16, 32)), None),
                                               (5, dict(rows_per_strip=rows), 2),
                                               (1, dict(rows_per_strip=rows), None)):
            data = tiff_bytes(s, 8, 6, compression=compression, ycbcr=sampling, predictor=predictor, **layout)
            got = follows(tmp_path, data, (width, height, compression, layout, predictor))
            assert got is not None or compression == 1


@pytest.mark.parametrize("orientation", range(1, 9))
def test_ycbcr_orientation_as_pil_applies_it(tmp_path, cxx, orientation):
    """The RGBA reader leaves the Orientation tag to PIL, whose loader
    transposes the whole image (strips, tiles, one strip)."""
    s = samples((13, 17, 3), 8, orientation)
    for layout in (dict(rows_per_strip=4), dict(tile=(16, 16)), {}):
        got = follows(tmp_path, tiff_bytes(s, 8, 6, compression=5, ycbcr=(2, 2), orientation=orientation,
                                           **layout), layout)
        assert got.pixels.shape[:2] == ((17, 13) if orientation > 4 else (13, 17))


def test_ycbcr_coefficients_reference_black_white_planes_and_refusals(tmp_path, cxx):
    """The YCbCrCoefficients and ReferenceBlackWhite tags (RATIONAL; read
    as libtiff's floats) in TIFFYCbCrToRGBInit's single precision; planes
    at 1x1 (libtiff's separate routine; uncompressed planes PIL's raw
    decoder takes as R, G, B); refused as PIL refuses: planes otherwise
    subsampled, subsamplings without a routine, one-sample YCbCr
    compressed."""
    s = samples((13, 17, 3), 8, 3)
    for ref in ([0, 1, 255, 1, 128, 1, 255, 1, 128, 1, 255, 1], [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1],
                [15, 1, 235, 1, 128, 1, 240, 1, 129, 2, 241, 1]):
        for luma in (None, [299, 1000, 587, 1000, 114, 1000], [2126, 10000, 7152, 10000, 722, 10000]):
            tags = {532: (5, ref)}
            if luma:
                tags[529] = (5, luma)
            assert follows(tmp_path, tiff_bytes(s, 8, 6, compression=8, rows_per_strip=4, ycbcr=(2, 1),
                                                tags=tags), (ref, luma)) is not None
    for compression in (1, 8):
        assert follows(tmp_path, tiff_bytes(s, 8, 6, compression=compression, ycbcr=(1, 1), planar=True,
                                            rows_per_strip=4)) is not None
    subsampled_planes = tiff_bytes(s, 8, 6, compression=8, ycbcr=(1, 1), planar=True, tags={530: (3, [2, 2])})
    assert_refused(tmp_path, subsampled_planes, r"YCbCr in planes subsampled \(2, 2\)", ".tif")
    for sampling in ((3, 3), (2, 4), (8, 8)):
        assert follows(tmp_path, tiff_bytes(s, 8, 6, compression=5, tags={530: (3, list(sampling))})) is None
    one_sample = tiff_bytes(s[..., :1], 8, 6, compression=5)
    assert follows(tmp_path, one_sample) is None
    assert follows(tmp_path, tiff_bytes(s[..., :1], 8, 6)).mode == "L"


# ---- old-style JPEG ----

@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["4:4:4", "4:2:2", "4:2:0"])
def test_old_style_jpeg_strips_follow_pil(tmp_path, cxx, subsampling):
    """Old-style JPEG (compression 6) with its tables in tags and with a
    JPEGInterchangeFormat stream: one JPEG stream for the image, a restart
    interval a strip (libtiff puts the RST markers back), its data units
    through TIFF's YCbCr conversion; image sizes with partial MCUs, one
    strip and many, photometric 2 as 6 (PIL forces 6; libtiff reads both),
    photometric 0 and 1 refused (PIL raises), the subsampling tag left out
    or other than the JPEGInterchangeFormat frame's (the frame's rules)."""
    v = 2 if subsampling == 2 else 1
    for width, height in ((48, 32), (45, 37), (7, 5)):
        a = smooth(-(-height // 16) * 16, width, 3, width)
        for rows in (8 * v, 16, None):
            stream = jpeg(a[:height] if rows is None else a, subsampling, rows // (8 * v) if rows else None)
            for jif in (False, True):
                data = ojpeg_tiff([stream], width, height, rows_per_strip=rows, jif=jif)
                assert follows(tmp_path, data, (width, height, rows, jif)).mode == "RGB"
    a = smooth(32, 48, 3, 1)
    stream = jpeg(a, subsampling, 2 // v)
    for photometric, reads in ((2, True), (6, True), (1, False), (0, False)):
        assert (follows(tmp_path, ojpeg_tiff([stream], 48, 32, rows_per_strip=16, photometric=photometric))
                is not None) == reads
    for tag in (False, (1, 1), (2, 2), (4, 4), (2, 1)):
        data = ojpeg_tiff([stream], 48, 32, rows_per_strip=16, jif=True, subsampling_tag=tag)
        assert follows(tmp_path, data, tag) is not None
        single = ojpeg_tiff([jpeg(a, subsampling)], 48, 32, subsampling_tag=tag)  # one strip: no restarts
        # 4x4 with two 1x1 chroma components is 18 blocks an MCU: libjpeg fails it, so PIL raises
        assert (follows(tmp_path, single, tag) is None) == (tag == (4, 4))
    wrong = (2, 2) if subsampling != 2 else (1, 1)  # tables in tags, data sampled otherwise, strips of 16
    assert_refused(tmp_path, ojpeg_tiff([stream], 48, 32, rows_per_strip=16, subsampling_tag=wrong),
                   r"old-style JPEG whose restart interval", ".tif")


def test_old_style_jpeg_tiles_follow_pil(tmp_path, cxx):
    """Tiles one across (libtiff feeds every tile into one stream a tile
    wide, a restart interval a tile): read; tiles more than one across
    (PIL's pixels past the stream's end are not the picture): refused."""
    for subsampling, v in ((0, 1), (1, 1), (2, 2)):
        for width, height in ((16, 37), (13, 48), (16, 16)):
            a = smooth(-(-height // 16) * 16, 16, 3, width)
            data = ojpeg_tiff([jpeg(a, subsampling, 16 // (8 * v))], width, height, tile=(16, 16))
            assert follows(tmp_path, data, (subsampling, width, height)) is not None
    tiles = [jpeg(smooth(16, 16, 3, k), 0) for k in range(6)]
    data = ojpeg_tiff(tiles, 48, 32, tile=(16, 16), tags={515: (3, [4])})
    assert_refused(tmp_path, data, r"old-style JPEG in tiles more than one across", ".tif")


# ---- CCITT fax, ThunderScan, old-style LZW ----

FAX = [("tiff_ccitt", {}), ("group3", {}), ("group3", {292: 1}), ("group3", {292: 5}), ("group4", {}),
       ("tiff_raw_16", {})]


@pytest.mark.parametrize("fax", FAX, ids=[f"{c}{'-t4_' + str(i[292]) if i else ''}" for c, i in FAX])
def test_pil_written_fax_follows_pil(tmp_path, cxx, fax):
    """PIL's (libtiff's) modified Huffman, Group 3 1-D and 2-D (byte-aligned
    EOLs too), Group 4 and 32771: noise, runs and blocks, widths of 1 to
    80, one strip and strips of 8 rows, photometric 0 and 1, FillOrder 2."""
    compression, info = fax
    rng = np.random.default_rng(len(compression) + len(info))
    read = 0
    for height, width in ((37, 45), (5, 80), (64, 17), (1, 1)):
        for kind in ("noise", "runs", "blocks"):
            if kind == "noise":
                bw = rng.random((height, width)) < 0.4
            elif kind == "runs":
                bw = np.repeat(rng.random((height, 1)) < 0.5, width, 1)
                bw[:, ::7] ^= True
            else:
                bw = np.add.outer(np.arange(height) // 5, np.arange(width) // 9) % 2 == 1
            for extra in ({}, {278: 8}, {262: 0}, {266: 2}):
                data = pil_tiff(Image.fromarray(bw), compression=compression, tiffinfo={**info, **extra})
                got = follows(tmp_path, data, (height, width, kind, extra))
                read += got is not None
    assert read >= 40  # of 48: libtiff's 32771 writer makes files its reader refuses


@pytest.mark.parametrize("fax", FAX[:5], ids=[f"{c}{'-t4_' + str(i[292]) if i else ''}" for c, i in FAX[:5]])
def test_fax_damage_follows_pil(tmp_path, cxx, fax):
    """Seeded byte flips in each fax coding: bad code words end their row
    and decoding goes on (libtiff logs them, PIL reads the image), uncompressed
    mode's extension code ends its row, stale run arrays carry over from
    strip to strip; the port gives PIL's pixels, raises where PIL raises,
    and refuses by name the two readings the module docstring names."""
    compression, info = fax
    rng = np.random.default_rng(11)
    bw = np.add.outer(np.arange(37) // 5, np.arange(45) // 9) % 2 == 1
    bw ^= rng.random(bw.shape) < 0.05
    refusal = r"Group 4 data that ends after" if compression == "group4" else (
        r"premature end of the fax data" if compression == "group3" else None)
    for rows in (None, 8):
        data = pil_tiff(Image.fromarray(bw), compression=compression, tiffinfo={**info, **({278: rows} if rows
                                                                                          else {})})
        lo, hi = data_span(data)
        for seed in range(40):
            follows(tmp_path, flips(data, lo, hi, seed), (rows, seed), refusal)


def test_thunderscan_follows_pil(tmp_path, cxx):
    """ThunderScan (4-bit grey): runs, 2- and 3-bit deltas, raw pixels,
    runs that end a row, odd widths, strips; photometric 0 and 1; seeded
    byte flips (too much or too little data a row fails the strip: PIL
    raises)."""
    rng = np.random.default_rng(5)
    for height, width in ((11, 13), (37, 45), (1, 1), (5, 64)):
        grey = (np.add.outer(np.arange(height), np.arange(width)) // 3 % 16)
        grey[rng.random(grey.shape) < 0.1] = 5
        for photometric in (0, 1):
            for rows in (None, 4):
                data = tiff_bytes(grey[..., None], 4, photometric, compression=32809, rows_per_strip=rows,
                                  encode=lambda c: thunderscan_encode(c[..., 0]))
                assert follows(tmp_path, data, (height, width, photometric, rows)).mode == "L"
    data = tiff_bytes(grey[..., None], 4, 1, compression=32809, rows_per_strip=2,
                      encode=lambda c: thunderscan_encode(c[..., 0]))
    lo, hi = data_span(data)
    for seed in range(60):
        follows(tmp_path, flips(data, lo, hi, seed), seed)


def test_old_style_lzw_follows_pil(tmp_path, cxx):
    """Old-style LZW (codes least significant bit first; libtiff's
    LZWDecodeCompat, which PIL's libtiff has): grey and RGB, Predictor 2,
    tables that fill and clear, strips; seeded byte flips."""
    rng = np.random.default_rng(9)
    for shape, table in (((20, 30, 1), 4000), ((37, 45, 3), 600), ((64, 80, 3), 4000)):
        s = rng.integers(0, 256, shape)
        for predictor in (None, 2):
            data = tiff_bytes(s, 8, 2 if shape[2] == 3 else 1, compression=5, predictor=predictor,
                              rows_per_strip=7, encode=lambda c: lzw_compat_encode(  # c: differenced already
                                  c.astype(np.uint8).tobytes(), table))
            got = follows(tmp_path, data, (shape, predictor))
            np.testing.assert_array_equal(got.pixels, s)
    lo, hi = data_span(data)
    for seed in range(30):
        follows(tmp_path, flips(data, lo, hi, seed), seed)


@pytest.mark.parametrize("form", ["YCbCr LZW 4:2:0", "YCbCr LZW 2:1", "old-style JPEG", "old-style JPEG JIF"])
def test_ycbcr_and_old_jpeg_damage_follows_pil(tmp_path, cxx, form):
    """Seeded byte flips in YCbCr LZW strips (libtiff's RGBA reader goes on
    past a failing strip: what the codec wrote, zeros after) and in
    old-style JPEG strips (a restart marker other than the one expected
    fails libtiff's codec for the rest of the image: zeros)."""
    rng = np.random.default_rng(len(form))
    if form.startswith("YCbCr"):
        data = tiff_bytes(rng.integers(0, 256, (37, 45, 3)), 8, 6, compression=5, rows_per_strip=8,
                          ycbcr=(2, 2) if "4:2:0" in form else (2, 1))
    else:
        a = smooth(32, 48, 3, 3)
        data = ojpeg_tiff([jpeg(a, 2 if form == "old-style JPEG" else 1, 1 if form == "old-style JPEG" else 2)],
                          48, 32, rows_per_strip=16, jif=form.endswith("JIF"))
    lo, hi = data_span(data)
    for seed in range(60):
        follows(tmp_path, flips(data, lo, hi, seed), seed)


def test_failed_fax_build_raises_naming_the_file(tmp_path, fake_cxx):
    """No fallback: a Group 4 TIFF cannot be read without the compiled fax
    decoder, and the error names the file and the source."""
    fake_cxx(fail=True)
    path = tmp_path / "fax.tif"
    path.write_bytes(pil_tiff(Image.fromarray(np.eye(16, dtype=bool)), compression="group4"))
    with pytest.raises(RuntimeError, match=r"(?s)fax\.tif: .*the fax decoder \(csrc/fax_decode\.cc\) could not "
                                           r"be built: .*bad source"):
        image_io.open_image(path)
    assert not cuda_build.host_library_path("fax_decode").exists()


# ---- the committed fixtures ----

@functools.cache
def _readings() -> dict:
    with open(os.path.join(FIXTURES, "sha256.json")) as f:
        return json.load(f)


@functools.cache
def _made() -> dict:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import rest_form_files

    return rest_form_files()


def _digest(pixels) -> str:
    pixels = pixels.astype(np.uint8) if pixels.dtype == bool else pixels
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()


def test_fixtures_are_committed_and_small():
    files = [f for f in os.listdir(FIXTURES) if f.endswith(".tif")]
    assert sorted(files) == sorted(k for k in _readings() if k.endswith(".tif"))
    assert sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES)) < 2 ** 20


@pytest.mark.parametrize("name", sorted(_readings()))
def test_fixture_and_chip_smoke_forms_give_pils_hash(tmp_path, cxx, name):
    """Each committed file, and each 1080p file chip_smoke.py writes
    itself (its old-style JPEG's bytes held to their committed SHA-256):
    PIL's mode, shape and pixels' SHA-256 (and RGBA's, for the small files)
    are the committed ones, and the port gives them."""
    want = _readings()[name]
    if name.endswith(".tif"):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
    else:
        data = _made()[name]
        if "file_sha256" in want:
            assert hashlib.sha256(data).hexdigest() == want["file_sha256"]
    path = tmp_path / "form.tif"
    path.write_bytes(data)
    with Image.open(path) as im:
        pil = np.asarray(im)
        pil_mode = im.mode
        pil_rgba = np.asarray(im.convert("RGBA")) if "rgba_sha256" in want else None
    pil = pil[..., None] if pil.ndim == 2 else pil
    got = image_io.open_image(path)
    for mode, px in ((pil_mode, pil), (got.mode, got.pixels)):
        assert (mode, list(px.shape), _digest(px)) == (want["mode"], want["shape"], want["sha256"])
    if pil_rgba is not None:
        assert _digest(pil_rgba) == _digest(image_io.to_rgba(got)) == want["rgba_sha256"]


# ---- the dataset readers ----

def rest_views(w, h):
    """One view in each new form whose pixels are the picture (RGB)."""
    a = smooth(h, w, 3, 90)
    tall = smooth(-(-h // 16) * 16, w, 3, 90)
    return {
        "v_ycbcr_lzw.tif": tiff_bytes(a, 8, 6, compression=5, rows_per_strip=8, ycbcr=(2, 2)),
        "v_ycbcr_tiles.tif": tiff_bytes(a, 8, 6, compression=8, tile=(16, 16), ycbcr=(4, 2)),
        "v_ojpeg.tif": ojpeg_tiff([jpeg(tall, 2, 1)], w, h, rows_per_strip=16),
        "v_rgb_fill_order_2.tif": tiff_bytes(a, 8, 2, compression=5, fill_order=2, rows_per_strip=8),
    }


@pytest.mark.parametrize("resolution", [1, 2])
def test_colmap_reads_the_rest_as_jax(tmp_path, monkeypatch, cxx, resolution):
    """A COLMAP dataset of views in the new forms (YCbCr LZW and tiled
    deflate, old-style JPEG, RGB with FillOrder 2): the Scene's cameras
    equal the JAX package's, images bit for bit."""
    from test_torch_scene import both_scenes

    w, h = 45, 37
    src = str(tmp_path / "forms")
    write_colmap_dataset_of(src, rest_views(w, h), w, h)
    jscene, scene = both_scenes(tmp_path, monkeypatch, src, eval_split=True, resolution=resolution)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == 4
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())


def rest_refused_views():
    a = smooth(11, 13, 3, 41)
    bw = a[..., 0] > 128
    return {
        "CIELab": (tiff_bytes(a, 8, 8, compression=5), "LAB"),
        "Group 4": (pil_tiff(Image.fromarray(bw), compression="group4"), "1"),
        "palette + alpha": (tiff_bytes(a[..., :2], 8, 3, extra=[2], colormap=list(range(768))), "PA"),
        "12-bit": (tiff_bytes(a[..., :1].astype(np.int64) * 16, 12, 1), "I;16"),
        "float": (tiff_bytes(a[..., :1].astype(np.float32), 32, 1, sample_format=3), "F"),
        "signed 16-bit": (tiff_bytes(a[..., :1].astype(np.int64) - 100, 16, 1, sample_format=2), "I"),
    }


@pytest.mark.parametrize("form", list(rest_refused_views()))
def test_colmap_refuses_new_modes_that_are_not_the_picture(tmp_path, cxx, form):
    """The JAX package's COLMAP path trains on np.asarray of these (L, a, b
    as R, G, B; 0 or 1; index and alpha; 12-bit, float and signed
    values): the port refuses each through load_camera, naming the file as
    images.bin lists it and the mode."""
    data, mode = rest_refused_views()[form]
    src = str(tmp_path / "data")
    write_colmap_dataset_of(src, {"view.tif": data}, 13, 11)
    assert Image.open(os.path.join(src, "images", "view.tif")).mode == mode
    info = dataset_readers.read_colmap_scene(src, None, eval_split=False)
    with pytest.raises(ValueError, match=rf"'view\.tif' in .*images\.bin: .*view\.tif: .*\(mode {mode}\)"):
        dataset_readers.load_camera(info.train_cameras[0], 1)


@pytest.mark.parametrize("white_background", [False, True])
def test_blender_reads_the_rest_as_jax(tmp_path, monkeypatch, cxx, white_background):
    """read_blender_scene on frames in the new forms (palette + alpha,
    YCbCr, old-style JPEG, Group 4, ThunderScan, 2-bit, float, signed 16-bit),
    composited on the background: PIL's convert("RGBA"), bit for bit, then
    load_camera at -r 2."""
    from test_torch_tga import blender_scenes

    w, h = 29, 23
    a = smooth(h, w, 4, 91)
    lum = a[..., 0].astype(np.int64)
    frames = list(rest_views(w, h).values()) + [
        tiff_bytes(a[..., :2], 8, 3, extra=[2], colormap=samples((768,), 16, 3).tolist(), compression=8),
        pil_tiff(Image.fromarray(a[..., 1] > 120), compression="group4"),
        tiff_bytes((lum >> 4)[..., None], 4, 1, compression=32809, encode=lambda c: thunderscan_encode(c[..., 0])),
        tiff_bytes((lum >> 6)[..., None], 2, 0, compression=5),
        tiff_bytes((lum[..., None] - 60).astype(np.float32) * 1.5, 32, 1, sample_format=3, compression=8,
                   predictor=3),
        tiff_bytes(lum[..., None] * 3 - 200, 16, 1, sample_format=2, compression=5, predictor=2),
    ]
    blender_scenes(tmp_path, monkeypatch, frames, white_background, jreaders, dataset_readers)


def test_writers_bit_order_helper():
    """The writers' FillOrder helper reverses each byte's bits."""
    assert reverse_bits(bytes([0x01, 0x80, 0xF0, 0x12])) == bytes([0x80, 0x01, 0x0F, 0x48])
