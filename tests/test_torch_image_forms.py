"""The image forms PIL reads beyond PNG and 1- or 3-component JPEG, in the
port (`utils/bmp.py`, `utils/tiff.py` with JPEG-in-TIFF, the compiled
`csrc/image_codecs.cc` and `csrc/jpeg_decode.cc`), against PIL, which the
JAX package opens its datasets with.

Tolerances: every comparison is bit-equal. For each file the port's
`image_io.open_image` must give PIL's mode and `np.asarray(Image.open(f))`
(a channel axis kept), and `to_rgba` PIL's `convert("RGBA")`. Each form
the port refuses raises a `ValueError` naming the file and the feature.
The files are PIL's own where PIL writes the form, else written here by
the specifications (`tests/torch_image_writers.py`; the 4-component JPEGs
by test_torch_jpeg.py's copy of chip_smoke.py's encoder). Images are at
most 129x97, made from `np.random.default_rng(seed)`.

The compiled decoders are built here with the host's `c++`; tests that
need them skip, with the reason, only where no C++ compiler exists.
"""

import io
import json
import lzma
import os
import shutil
import struct

import numpy as np
import pytest
from PIL import Image

from gaussian_splatting_tpu.scene import colmap as jcolmap
from gaussian_splatting_tpu.scene import dataset_readers as jreaders
from gaussian_splatting_torch.scene import dataset_readers
from gaussian_splatting_torch.utils import bmp, cuda_build, image_io, tiff
from test_torch_jpeg import MSP_4X4, encode_jpeg, fake_cxx, have_cxx  # noqa: F401  (fake_cxx: a fixture)
from test_torch_scene import assert_same_cameras, orbit, orbit_frames
from torch_image_writers import bmp_bytes, lzw_encode, padded_rows, rle_encode, tiff_bytes

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_images")


@pytest.fixture
def cxx():
    if not have_cxx():
        pytest.skip("no host C++ compiler to build csrc/image_codecs.cc and csrc/jpeg_decode.cc")


def pil_read(data: bytes):
    """(mode, pixels with a channel axis, convert("RGBA")) by PIL."""
    im = Image.open(io.BytesIO(data))
    a = np.asarray(im)
    return im.mode, a[..., None] if a.ndim == 2 else a, np.asarray(im.convert("RGBA"))


def assert_like_pil(tmp_path, data: bytes, name="image", suffix=".img"):
    """open_image and to_rgba of `data` as a file equal PIL's reading."""
    path = tmp_path / f"{name}{suffix}"
    path.write_bytes(data)
    mode, want, rgba = pil_read(data)
    got = image_io.open_image(path)
    assert got.mode == mode, (got.mode, mode)
    assert got.pixels.shape == want.shape and got.pixels.dtype.kind == want.dtype.kind, (got.pixels.dtype, want.dtype)
    np.testing.assert_array_equal(got.pixels, want)
    np.testing.assert_array_equal(image_io.to_rgba(got), rgba)
    return got


def assert_follows_pil(tmp_path, data: bytes, label="", suffix=".img"):
    """The port reads `data` as PIL does (mode, pixels with their dtype and
    shape, NaN equal to NaN, RGBA) and returns the `Picture`, or raises
    naming the file where PIL raises and returns None."""
    try:
        want = pil_read(data)
    except Exception:  # noqa: BLE001  (any of PIL's errors: the port must raise too)
        want = None
    path = tmp_path / f"view{suffix}"
    path.write_bytes(data)
    if want is None:
        with pytest.raises(ValueError) as err:
            image_io.open_image(path)
        assert str(path) in str(err.value), label
        return None
    got = image_io.open_image(path)
    assert got.mode == want[0], (label, got.mode, want[0])
    assert got.pixels.dtype == want[1].dtype and got.pixels.shape == want[1].shape, (label, got.pixels.dtype)
    np.testing.assert_array_equal(got.pixels, want[1], err_msg=label)
    np.testing.assert_array_equal(image_io.to_rgba(got), want[2], err_msg=label)
    return got


def assert_refused(tmp_path, data: bytes, match: str, suffix=".img"):
    path = tmp_path / f"refused{suffix}"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match) as err:
        image_io.open_image(path)
    assert str(path) in str(err.value)


def samples(shape, depth, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << depth, shape, dtype=np.int64)


def smooth(h, w, c, seed):
    """Smooth waves with noise: what compresses as photographs do."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 100 * np.sin(xx / (5 + 2 * i) + yy / (7 + i)) for i in range(c)], -1)
    return np.clip(a + rng.normal(0, 10, a.shape), 0, 255).astype(np.uint8)


SIZES = [(1, 1), (7, 5), (67, 45), (129, 97)]  # (width, height)


# ---- CMYK and YCCK JPEG ----

@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("layout", ["4:4:4", "4:2:0 K full", "4:2:0 K subsampled", "4:2:2"])
@pytest.mark.parametrize("adobe", [None, 0, 2, 1])
def test_four_component_jpeg_gives_pils_pixels(tmp_path, cxx, adobe, layout, restart):
    """CMYK (no Adobe marker, or transform 0) and YCCK (transform 2, and 1,
    which libjpeg takes for YCCK too) from the copied baseline encoder:
    PIL's inverted "CMYK" samples and its cmyk2rgb, every size."""
    sampling = {"4:4:4": (1, 1), "4:2:2": (2, 1)}.get(layout, (2, 2))
    for k, (w, h) in enumerate(SIZES):
        data = encode_jpeg(smooth(h, w, 4, k), 90, sampling, restart, adobe=adobe,
                           k_sampled=layout.endswith("subsampled"))
        got = assert_like_pil(tmp_path, data, f"{w}x{h}", ".jpg")
        assert got.mode == "CMYK"


def with_adobe_transform(data: bytes, transform: int) -> bytes:
    at = data.index(b"Adobe")
    return data[:at + 11] + bytes([transform]) + data[at + 12:]


@pytest.mark.parametrize("transform", [0, 2])
@pytest.mark.parametrize("options", ["baseline", "progressive", "optimized", "restart blocks", "4:2:0"])
def test_pil_written_cmyk_jpeg_gives_pils_pixels(tmp_path, cxx, options, transform):
    """PIL's own CMYK JPEGs (an Adobe marker of transform 0), and the same
    files with the marker's transform set to 2, which libjpeg then decodes
    as YCCK: progressive and restart forms of both."""
    kw = {"baseline": {}, "progressive": {"progressive": True}, "optimized": {"optimize": True},
          "restart blocks": {"restart_marker_blocks": 3}, "4:2:0": {"subsampling": "4:2:0"}}[options]
    for k, (w, h) in enumerate(SIZES):
        buf = io.BytesIO()
        Image.fromarray(smooth(h, w, 4, 10 + k), "CMYK").save(buf, "JPEG", quality=85, **kw)
        assert_like_pil(tmp_path, with_adobe_transform(buf.getvalue(), transform), f"{w}x{h}", ".jpg")


# ---- BMP ----

@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_pil_written_bmp_gives_pils_pixels(tmp_path, mode):
    """PIL's BMP writer: 1-bit, grey and palette at 8 bits, 24-bit, and
    RGBA as 32-bit BI_RGB (which PIL reads back as RGB)."""
    for k, (w, h) in enumerate(SIZES):
        a = smooth(h, w, 4, k)
        im = {"1": lambda: Image.fromarray(a[..., 0] > 128), "L": lambda: Image.fromarray(a[..., 0]),
              "P": lambda: Image.fromarray(a[..., :3]).quantize(37), "RGB": lambda: Image.fromarray(a[..., :3]),
              "RGBA": lambda: Image.fromarray(a, "RGBA")}[mode]()
        buf = io.BytesIO()
        im.save(buf, "BMP")
        assert_like_pil(tmp_path, buf.getvalue(), f"{w}x{h}", ".bmp")


@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("header_size,top_down", [(12, False)] + [(n, t) for n in (40, 52, 56, 64, 108, 124)
                                                                  for t in (False, True)])
def test_bmp_palette_headers_give_pils_pixels(tmp_path, header_size, top_down, bits):
    """Every header at 1, 4 and 8 bits, bottom-up and top-down (not OS/2
    1.x, whose height is unsigned), with full palettes and with palettes
    shorter than 2^bits (indices past them black in convert("RGBA"))."""
    for k, (w, h) in enumerate(SIZES[1:]):
        full = header_size == 12 or k % 2 == 1
        n = (1 << bits) if full else max(2, (1 << bits) - 3)
        idx = samples((h, w), bits, k + 1) % min(n + 2, 1 << bits)  # some past a short palette
        rows = _pack_indices(idx, bits)
        data = bmp_bytes(padded_rows(rows[::-1] if top_down else rows), w, h, bits, header_size,
                         palette=samples((n, 3), 8, k), colors=0 if full else n, top_down=top_down)
        assert_like_pil(tmp_path, data, f"{w}x{h}", ".bmp")


def _pack_indices(idx: np.ndarray, bits: int) -> np.ndarray:
    """(H, W) indices packed `bits` to a pixel, most significant first."""
    if bits == 8:
        return idx.astype(np.uint8)
    per = 8 // bits
    H, W = idx.shape
    padded = np.zeros((H, -(-W // per) * per), np.int64)
    padded[:, :W] = idx
    shifts = np.arange(8 - bits, -1, -bits)
    return (padded.reshape(H, -1, per) << shifts).sum(-1).astype(np.uint8)


@pytest.mark.parametrize("case", ["black and white", "grey ramp", "two colours", "two greys at 8 bits",
                                  "sixteen greys at 4 bits"])
def test_bmp_grey_palettes_give_pils_modes(tmp_path, case):
    """PIL's palette rule: black and white -> "1", entry i grey i for all
    -> "L", else "P"; a black-and-white palette on 8-bit data is "1" read
    a bit a pixel, as PIL reads it; a 4-bit grey ramp PIL would read 8
    bits a pixel is refused by name."""
    w, h = 45, 37
    bits, palette = {"black and white": (1, [[0] * 3, [255] * 3]), "grey ramp": (8, [[i] * 3 for i in range(256)]),
                     "two colours": (1, [[10, 20, 30], [200, 100, 0]]),
                     "two greys at 8 bits": (8, [[0] * 3, [255] * 3]),
                     "sixteen greys at 4 bits": (4, [[i] * 3 for i in range(16)])}[case]
    idx = samples((h, w), bits, 3) % len(palette)
    data = bmp_bytes(padded_rows(_pack_indices(idx, bits)), w, h, bits, palette=np.array(palette),
                     colors=len(palette))
    if case == "sixteen greys at 4 bits":
        assert Image.open(io.BytesIO(data)).mode == "L"
        assert_refused(tmp_path, data, "a grey palette at 4 bits", ".bmp")
        return
    got = assert_like_pil(tmp_path, data, suffix=".bmp")
    assert got.mode == {"black and white": "1", "grey ramp": "L", "two colours": "P",
                        "two greys at 8 bits": "1"}[case]


@pytest.mark.parametrize("form", ["BI_RGB 5-5-5", "bitfields 5-6-5", "bitfields 5-5-5",
                                  "bitfields 5-6-5 after a 40-byte header"])
def test_bmp_16_bit_gives_pils_pixels(tmp_path, form):
    """Every 16-bit value (256x256), each channel scaled as PIL's unpacker
    scales it."""
    v = np.arange(65536, dtype="<u2").reshape(256, 256)
    masks = None if form.startswith("BI_RGB") else ((0xF800, 0x7E0, 0x1F) if "5-6-5" in form else
                                                     (0x7C00, 0x3E0, 0x1F))
    data = bmp_bytes(padded_rows(v.view(np.uint8)), 256, 256, 16, 40 if "40" in form else 56,
                     compression=0 if masks is None else 3, masks=masks, masks_after_header="40" in form)
    assert_like_pil(tmp_path, data, suffix=".bmp")


BITFIELD_SETS = {r: m for (b, m), r in bmp.MASK_MODES.items() if b == 32} | {"BGR 24-bit": (0xFF0000, 0xFF00, 0xFF)}


@pytest.mark.parametrize("header_size", [40, 52, 56, 108, 124])
@pytest.mark.parametrize("raw", list(BITFIELD_SETS))
def test_bmp_bitfields_give_pils_pixels(tmp_path, raw, header_size):
    """32-bit BI_BITFIELDS with every mask set PIL lists, and 24-bit
    bitfields. A 40-byte header carries three masks after it and a V2
    header three inside it, so an alpha mask is not read there: where the
    three leave a set PIL does not list, PIL and the port refuse the file."""
    masks = BITFIELD_SETS[raw]
    bits = 24 if len(masks) == 3 else 32
    w, h = 45, 37
    px = samples((h, w, bits // 8), 8, 5).astype(np.uint8)
    data = bmp_bytes(padded_rows(px.reshape(h, -1)), w, h, bits, header_size, compression=3, masks=masks,
                     masks_after_header=header_size == 40)
    try:
        Image.open(io.BytesIO(data))
    except OSError as err:
        assert "bitfields" in str(err)
        assert_refused(tmp_path, data, "BMP bitfields", ".bmp")
        return
    assert_like_pil(tmp_path, data, suffix=".bmp")


@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("rle4", [False, True])
def test_bmp_rle_gives_pils_pixels(tmp_path, cxx, rle4, seed, top_down):
    """RLE8 and RLE4 with every escape PIL reads: encoded runs, absolute
    runs with their word padding, delta (PIL's six-byte reading), end of
    line and end of bitmap; palette and grey ("L") images."""
    w, h = [(45, 37), (129, 97), (7, 5)][seed]
    n = 16 if rle4 else 256
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (h, w))
    idx[:, rng.integers(0, w, w // 3)] = 3  # runs and repeats among noise
    idx[rng.integers(0, h, h // 2), :] = rng.integers(0, n)
    idx[::2, w // 2:] = 0  # trailing zeros: the delta and end-of-line escapes
    grey = seed == 1
    palette = np.repeat(np.arange(n)[:, None], 3, 1) if grey else rng.integers(0, 256, (n, 3))
    rows = rle_encode(idx[::-1] if top_down else idx, rle4)
    data = bmp_bytes(rows, w, h, 4 if rle4 else 8, compression=2 if rle4 else 1, palette=palette, colors=n,
                     top_down=top_down)
    got = assert_like_pil(tmp_path, data, suffix=".bmp")
    assert got.mode == ("L" if grey else "P")
    np.testing.assert_array_equal(got.pixels[..., 0], idx)


def rle_file(body: bytes, rle4=False, w=8, h=3):
    return bmp_bytes(body, w, h, 4 if rle4 else 8, compression=2 if rle4 else 1,
                     palette=np.arange(48).reshape(16, 3), colors=16)


RLE_QUIRKS = {  # PIL's reading of each, which the port follows: pixels or a raise
    "standard four-byte delta": (b"\x03\x05\x00\x02\x02\x00\x02\x07\x00\x00" + b"\x08\x01" * 3 + b"\x00\x01", False),
    "odd RLE4 absolute run": (b"\x00\x05\x12\x34\x56\x00\x00\x00" + b"\x08\x11" * 2 + b"\x00\x01", True),
    "absolute run across the row end": (b"\x06\x02\x00\x04\x01\x02\x03\x04" + b"\x08\x09" * 2 + b"\x00\x01", False),
    "encoded run cut at the row end": (b"\x06\x02\x05\x03\x00\x00" + b"\x08\x09" * 2 + b"\x00\x01", False),
    "end of bitmap early": (b"\x08\x01\x00\x01", False),
    "data ends mid-row": (b"\x08\x01\x03\x02", False),
    "delta without its offsets": (b"\x08\x01" * 2 + b"\x00\x02\x01\x01\x05", False),
    "an odd-offset absolute run": (b"\x01\x07\x00\x03\x01\x02\x03\x00\x00\x00" + b"\x08\x03" * 2 + b"\x00\x01",
                                   False),
}


@pytest.mark.parametrize("quirk", list(RLE_QUIRKS))
def test_bmp_rle_quirks_follow_pil(tmp_path, cxx, quirk):
    body, rle4 = RLE_QUIRKS[quirk]
    data = rle_file(body, rle4)
    try:
        pil_read(data)
    except (ValueError, OSError) as err:
        path = tmp_path / "quirk.bmp"
        path.write_bytes(data)
        with pytest.raises(ValueError) as ours:
            image_io.open_image(path)
        assert str(path) in str(ours.value), (err, ours.value)
        return
    assert_like_pil(tmp_path, data, suffix=".bmp")


def test_bmp_data_offset_quirk_and_zero_offset(tmp_path):
    """A data offset that points at the palette (PIL moves it past the
    palette) and an offset of 0 (the data follows the palette)."""
    w, h = 13, 7
    idx = samples((h, w), 8, 9)
    palette = samples((256, 3), 8, 10)
    for offset in (14 + 40, 0):
        data = bmp_bytes(padded_rows(idx.astype(np.uint8)), w, h, 8, palette=palette, colors=256,
                         data_offset=offset)
        if offset == 0:
            data = data[:10] + bytes(4) + data[14:]
        assert_like_pil(tmp_path, data, suffix=".bmp")


BMP_REFUSALS = {
    "BI_JPEG": (dict(bits=24, compression=4), r"BMP compression 4 \(BI_JPEG\)"),
    "BI_PNG": (dict(bits=24, compression=5), r"BMP compression 5 \(BI_PNG\)"),
    "BI_ALPHABITFIELDS": (dict(bits=32, compression=6), r"BMP compression 6 \(BI_ALPHABITFIELDS\)"),
    "2-bit": (dict(bits=2), r"a BMP of 2 bits per pixel"),
    "masks PIL does not list": (dict(bits=32, compression=3, masks=(0xFF, 0xFF00, 0xFF0000, 0)),
                                r"BMP bitfields at 32 bits"),
    "bitfields at 8 bits": (dict(bits=8, compression=3, masks=(0xE0, 0x1C, 0x3)), r"BMP bitfields at 8 bits"),
    "300 colours": (dict(bits=8, colors=300), r"a BMP palette of 300 colours"),
    "RLE8 at 24 bits": (dict(bits=24, compression=1), r"RLE into mode RGB"),
    "header of 20 bytes": (dict(bits=24, header_size=20), r"a BMP header of 20 bytes"),
    "truncated": (dict(bits=24, truncate=True), r"truncated BMP pixel data"),
}


@pytest.mark.parametrize("case", list(BMP_REFUSALS))
def test_bmp_refusals_name_the_file_and_the_feature(tmp_path, case):
    """Where PIL raises, the port raises, naming the file and the feature."""
    kw, match = BMP_REFUSALS[case]
    kw = dict(kw)
    truncate, header_size = kw.pop("truncate", False), kw.pop("header_size", 40)
    w, h = 8, 4
    colors = kw.get("colors", 0)
    palette = samples((colors, 3), 8, 1) if colors else None
    data = bmp_bytes(bytes(4 * w * h), w, h, header_size=max(header_size, 40), palette=palette, **kw)
    if header_size != 40:
        data = data[:14] + struct.pack("<I", header_size) + data[18:]
    if truncate:
        data = data[:len(data) - 2 * w * h]
    with pytest.raises((OSError, ValueError)):
        Image.open(io.BytesIO(data)).load()
    assert_refused(tmp_path, data, match, ".bmp")


# ---- TIFF ----

@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "packbits"])
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA", "LA", "CMYK", "I;16"])
def test_pil_written_tiff_gives_pils_pixels(tmp_path, cxx, mode, compression):
    """PIL's own TIFF writer (libtiff for every compression)."""
    for k, (w, h) in enumerate(SIZES):
        a = smooth(h, w, 4, 20 + k)
        im = {"1": lambda: Image.fromarray(a[..., 0] > 128), "L": lambda: Image.fromarray(a[..., 0]),
              "P": lambda: Image.fromarray(a[..., :3]).quantize(23), "RGB": lambda: Image.fromarray(a[..., :3]),
              "RGBA": lambda: Image.fromarray(a, "RGBA"), "LA": lambda: Image.fromarray(a[..., :2], "LA"),
              "CMYK": lambda: Image.fromarray(a, "CMYK"),
              "I;16": lambda: Image.fromarray(a[..., 0].astype(np.uint16) * 257 - k)}[mode]()
        buf = io.BytesIO()
        im.save(buf, "TIFF", compression=compression)
        assert_like_pil(tmp_path, buf.getvalue(), f"{w}x{h}", ".tif")


# the layouts of 1, 8 and 16 bits (signed, float, 2-, 4-, 12- and 32-bit,
# palette + alpha, YCbCr and CIELab layouts: tests/test_torch_tiff_rest.py)
LAYOUT_KEYS = sorted((k for k in tiff.LAYOUTS if k[1][0] in (1, 8, 16) and k[0] not in (6, 8)
                      and k != (3, (8, 8), (2,))), key=repr)
# (compression, predictor, byte order, tiles) in turn over each layout's four files
VARIANTS = [(1, None, "<", None), (5, 2, ">", (16, 16)), (8, 2, "<", None), (32773, None, ">", (32, 16)),
            (32946, None, "<", (16, 32)), (5, None, "<", None)]


@pytest.mark.parametrize("key", LAYOUT_KEYS, ids=[f"photo{p}-{'x'.join(map(str, b))}-extra{e}" for p, b, e in
                                                  LAYOUT_KEYS])
def test_every_tiff_layout_gives_pils_pixels(tmp_path, cxx, key):
    """Each (photometric, bits, extra samples) layout the port reads, in
    strips of 5 rows (the last one short) and in tiles that overhang,
    uncompressed, LZW, deflate and PackBits, Predictor 2 where it applies,
    in both byte orders (a 16-bit WhiteIsZero file, which PIL refuses in
    "MM" order, only in "II"); random samples, so every RGBa alpha and
    colour pair comes up."""
    photo, bits, extra = key
    depth, n = bits[0], len(bits)
    h, w = 37, 45
    for i, (compression, predictor, order, tile) in enumerate(VARIANTS):
        if depth == 1 and predictor:
            predictor = None
        if depth == 16 and photo == 0:
            order = "<"
        s = samples((h, w, n), depth, 100 * i + n)
        colormap = samples((3 << depth,), 16, i) if photo == 3 else None
        data = tiff_bytes(s, depth, photo, order=order, compression=compression, predictor=predictor,
                          rows_per_strip=5, tile=tile, extra=extra or None, colormap=colormap)
        assert_like_pil(tmp_path, data, f"v{i}", ".tif")


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation_as_pil_applies_it(tmp_path, orientation):
    """PIL's TIFF loader transposes by the Orientation tag: so does the port."""
    s = samples((5, 9, 3), 8, orientation)
    data = tiff_bytes(s, 8, 2, orientation=orientation)
    got = assert_like_pil(tmp_path, data, suffix=".tif")
    assert got.pixels.shape[:2] == ((9, 5) if orientation > 4 else (5, 9))


@pytest.mark.parametrize("content", ["noise", "few values", "long runs"])
def test_tiff_lzw_code_widths_and_table_resets(tmp_path, cxx, content):
    """LZW strips long enough that the codes grow to 12 bits (libtiff's
    early switch at 511, 1023 and 2047 entries) and the table fills and
    is cleared, from this file's encoder and from libtiff's (PIL)."""
    rng = np.random.default_rng(7)
    h, w = 97, 129
    s = {"noise": lambda: rng.integers(0, 256, (h, w, 3)), "few values": lambda: rng.integers(0, 5, (h, w, 3)),
         "long runs": lambda: np.repeat(rng.integers(0, 256, (h, 1, 3)), w, axis=1)}[content]()
    for data in (tiff_bytes(s, 8, 2, compression=5),
                 tiff_bytes(s, 8, 2, compression=5, predictor=2, rows_per_strip=50)):
        assert_like_pil(tmp_path, data, suffix=".tif")
    buf = io.BytesIO()
    Image.fromarray(s.astype(np.uint8)).save(buf, "TIFF", compression="tiff_lzw")
    assert_like_pil(tmp_path, buf.getvalue(), "pil", ".tif")


def test_tiff_16_bit_rgb_lzw_predictor_both_orders(tmp_path, cxx):
    """The COLMAP view of chip_smoke.py: 16-bit RGB, LZW with Predictor 2,
    "II" and "MM" (the predictor runs on the samples in the file's byte
    order, swapped to the host's): the high bytes, as PIL gives them."""
    s = samples((37, 45, 3), 16, 4)
    for order in "<>":
        got = assert_like_pil(tmp_path, tiff_bytes(s, 16, 2, order=order, compression=5, predictor=2), order,
                              ".tif")
        np.testing.assert_array_equal(got.pixels, s >> 8)


def test_tiff_packbits_runs_past_the_strip_are_cut(tmp_path, cxx):
    """A PackBits run longer than the room left in its strip is cut (libtiff
    discards the rest); a -128 is a no-op."""
    w, h = 9, 2
    body = b"\x80" + bytes([256 - 20, 7])  # 21 copies of 7 for 18 bytes
    for rps in (1, 2):
        data = tiff_bytes(np.zeros((h, w, 1), np.int64), 8, 1, rows_per_strip=rps, compression=32773)
        strips = [body] * (h // rps)
        # put the hand-made strips where the writer put its own, and fix their byte counts
        data = _replace_strips(data, strips)
        assert_like_pil(tmp_path, data, f"rps{rps}", ".tif")


def _replace_strips(data: bytes, strips) -> bytes:
    """`data` (a little-endian TIFF from `tiff_bytes`) with its strips
    replaced by `strips` appended at the end, offsets and counts set."""
    n = struct.unpack("<H", data[8:10])[0]
    out = bytearray(data)
    at = len(out)
    offsets = []
    for s in strips:
        offsets.append(at)
        out += s
        at += len(s)
    for i in range(n):
        tag, typ, count = struct.unpack("<HHI", data[10 + 12 * i:18 + 12 * i])
        if tag in (273, 279):
            values = offsets if tag == 273 else [len(s) for s in strips]
            raw = struct.pack("<" + "I" * count, *values)
            if len(raw) <= 4:
                out[18 + 12 * i:22 + 12 * i] = raw
            else:
                (where,) = struct.unpack("<I", data[18 + 12 * i:22 + 12 * i])
                out[where:where + len(raw)] = raw
    return bytes(out)


def _ycbcr_improper_sampling(s):
    """A YCbCr JPEG-in-TIFF whose strips are sampled 2x2 under a
    YCbCrSubsampling tag of 1x1 (libtiff: Improper JPEG sampling factors)."""
    def strip(c):
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(c).astype(np.uint8)).save(buf, "JPEG", quality=90, subsampling=2)
        return buf.getvalue()
    return tiff_bytes(s, 8, 6, compression=7, encode=strip, tags={530: (3, [1, 1])})


def _half(stream: bytes) -> bytes:
    return stream[:len(stream) // 2]


def refusal_file(case):
    s = samples((6, 8, 3), 8, 1)
    grey = s[..., :1]
    big = tiff_bytes(s, 8, 2, big=True)
    return {
        "BigTIFF": (big[:24 + 20 * struct.unpack("<Q", big[16:24])[0] - 7], "a truncated BigTIFF IFD"),
        "CCITT": (tiff_bytes(grey, 8, 0, tags={259: (3, [3])}), r"CCITT fax at 8 bits"),
        "JPEG-in-TIFF": (_ycbcr_improper_sampling(s), r"libtiff: Improper JPEG sampling factors"),
        "old JPEG": (tiff_bytes(s, 8, 1, tags={259: (3, [6])}), r"old-style JPEG with photometric 1"),
        "WebP": (tiff_bytes(s, 8, 2, tags={259: (3, [50001])}), r"WebP \(compression 50001\), which PIL refuses too"),
        "ZSTD": (tiff_bytes(s, 8, 2, compression=50000, encode=lambda c: b"\x28\xb5\x2f\xfd\x20\x90\x07\x00\x00"),
                 r"corrupt ZSTD data: a reserved block type"),
        "LZMA": (tiff_bytes(s, 8, 2, compression=34925, encode=lambda c: _half(lzma.compress(
            np.ascontiguousarray(c.astype(np.uint8)).tobytes(), lzma.FORMAT_XZ))), r"LZMA data ends short"),
        "old-style LZW": (_replace_strips(tiff_bytes(grey, 8, 1, compression=5), [b"\x00\x01" + bytes(40)]),
                          r"old-style LZW"),
        "Predictor 3": (tiff_bytes(s, 8, 2, compression=5, tags={317: (3, [3])}), r"Predictor 3"),
        "PlanarConfiguration 2": (tiff_bytes(s[..., :2], 8, 1, extra=[2], planar=True),
                                  r"grey \+ alpha in uncompressed planes \(PlanarConfiguration 2"),
        "YCbCr": (tiff_bytes(s, 8, 6), r"PIL's raw mode RGBX reads 4 bytes a pixel"),
        "CIELab": (tiff_bytes(s, 16, 8), r"photometric 8 with 16/16/16 bits"),
        "4-bit": (tiff_bytes(s % 16, 4, 2), r"photometric 2 with 4/4/4 bits"),
        "32-bit": (tiff_bytes(grey, 32, 1, order=">"), r"photometric 1 with 32 bits"),
        "signed": (tiff_bytes(s, 8, 2, sample_format=2), r"SampleFormat \(2, 2, 2\)"),
        "FillOrder 2": (tiff_bytes(grey, 8, 0, fill_order=2), r"FillOrder 2 uncompressed"),
        "palette + alpha": (tiff_bytes(s[..., :2] % 16, 4, 3, extra=[2], colormap=[0] * 48), r"photometric 3 with 4/4"),
        "16-bit WhiteIsZero big-endian": (tiff_bytes(grey, 16, 0, order=">"), r"photometric 0 with 16 bits"),
        "truncated LZW": (_replace_strips(tiff_bytes(grey, 8, 1, compression=5),
                                          [lzw_encode(bytes(range(20)))]), r"LZW data ends"),
    }[case]


REFUSALS = ["BigTIFF", "CCITT", "JPEG-in-TIFF", "old JPEG", "WebP", "ZSTD", "LZMA", "old-style LZW", "Predictor 3",
            "PlanarConfiguration 2", "YCbCr", "CIELab", "4-bit", "32-bit", "signed", "FillOrder 2",
            "palette + alpha", "16-bit WhiteIsZero big-endian", "truncated LZW"]


@pytest.mark.parametrize("case", REFUSALS)
def test_tiff_refusals_name_the_file_and_the_feature(tmp_path, cxx, case):
    """Each out-of-scope form raises a ValueError naming the file and the
    feature (ROADMAP.md section 1 lists them); where PIL raises on the file
    too (the 16-bit WhiteIsZero "MM" file, corrupt data, a BigTIFF cut in
    its IFD, YCbCr strips sampled otherwise than the tag says, a corrupt
    ZSTD frame, an .xz stream that ends short, grey + alpha in uncompressed
    planes, WebP-in-TIFF), so much the more."""
    data, match = refusal_file(case)
    if case in ("16-bit WhiteIsZero big-endian", "truncated LZW", "old-style LZW", "BigTIFF", "JPEG-in-TIFF",
                "ZSTD", "LZMA", "PlanarConfiguration 2", "WebP"):
        with pytest.raises((OSError, ValueError, SyntaxError)):
            Image.open(io.BytesIO(data)).load()
    assert_refused(tmp_path, data, match, ".tif")


def test_to_rgba_refuses_a_mode_it_does_not_convert():
    with pytest.raises(ValueError, match="mode 'YCbCr'"):
        image_io.to_rgba(image_io.Picture(np.zeros((2, 2, 3), np.uint8), "YCbCr"))


def test_open_image_sniffs_each_format(tmp_path, cxx):
    """The BMP, TIFF and PPM signatures, each file named .img; a form PIL
    reads and the port does not (MacPaint, MSP) refused, naming the
    formats the port reads."""
    a = smooth(9, 11, 3, 0)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "BMP")
    got = assert_like_pil(tmp_path, buf.getvalue(), "bmp")
    assert got.mode == "RGB"
    for order in "<>":
        assert_like_pil(tmp_path, tiff_bytes(a, 8, 2, order=order), f"tiff{order}")
    assert_refused(tmp_path, MSP_4X4, "not a PNG, JPEG, BMP, DIB, TIFF, WebP, GIF, PPM / PGM / PBM / PFM, TGA, "
                                      "JPEG 2000, QOI, PCX / DCX, SGI, ICO / CUR, PSD, DDS, AVIF, BLP, FITS, FLI / FLC, "
                                      "FTEX, GBR, ICNS or EPS file")
    got = assert_like_pil(tmp_path, b"P6\n4 4\n255\n" + bytes(48), "ppm")
    assert got.mode == "RGB" and got.pixels.shape == (4, 4, 3)


def test_failed_codec_build_raises_naming_the_file(tmp_path, fake_cxx):
    """No fallback: an LZW TIFF (or an RLE BMP) cannot be read without the
    compiled codecs, and the error names the file; an uncompressed one
    needs no build."""
    fake_cxx(fail=True)
    a = samples((6, 8, 3), 8, 2)
    lzw = tmp_path / "a.tif"
    lzw.write_bytes(tiff_bytes(a, 8, 2, compression=5))
    with pytest.raises(RuntimeError, match=r"(?s)a\.tif: .*the image codecs .* could not be built: .*bad source"):
        image_io.open_image(lzw)
    assert not cuda_build.host_library_path("image_codecs").exists()
    raw = tmp_path / "b.tif"
    raw.write_bytes(tiff_bytes(a, 8, 2))
    np.testing.assert_array_equal(image_io.open_image(raw).pixels, a)


# ---- the committed fixtures ----

FIXTURE_NAMES = sorted(os.path.splitext(f)[0] for f in os.listdir(FIXTURES) if not f.endswith((".npz", ".py")))


def test_image_fixtures_are_committed_in_pairs():
    files = os.listdir(FIXTURES)
    assert len(FIXTURE_NAMES) >= 12
    assert sorted(f[:-4] for f in files if f.endswith(".npz")) == FIXTURE_NAMES
    assert sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in files) < 400 * 2**10


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_image_fixture_pixels_are_pils(tmp_path, cxx, name):
    """PIL's reading of each committed file equals the mode, pixels and
    RGBA committed beside it (which chip_smoke.py holds the port to on the
    card's machine), and so does the port's."""
    path = [os.path.join(FIXTURES, f) for f in os.listdir(FIXTURES) if os.path.splitext(f)[0] == name
            and not f.endswith(".npz")][0]
    with open(path, "rb") as f:
        data = f.read()
    want = np.load(os.path.join(FIXTURES, f"{name}.npz"))
    mode, pixels, rgba = pil_read(data)
    assert mode == str(want["mode"])
    np.testing.assert_array_equal(pixels, want["pixels"])
    np.testing.assert_array_equal(rgba, want["rgba"])
    got = image_io.open_image(path)
    assert got.mode == mode
    np.testing.assert_array_equal(got.pixels, want["pixels"])
    np.testing.assert_array_equal(image_io.to_rgba(got), want["rgba"])


# ---- the dataset readers ----

def write_colmap_dataset_of(d, views, width, height):
    """A COLMAP dataset of `views` ({file name: bytes}) with the JAX
    package's writers, one PINHOLE camera."""
    os.makedirs(os.path.join(d, "sparse", "0"))
    os.makedirs(os.path.join(d, "images"))
    cams = {1: jcolmap.ColmapCamera(id=1, model="PINHOLE", width=width, height=height,
                                    params=np.array([40.0, 40.0, width / 2, height / 2]))}
    images = {}
    for i, (name, data) in enumerate(views.items()):
        R, T = orbit(i, len(views), width, height)
        images[i + 1] = jcolmap.ColmapImage(
            id=i + 1, qvec=jcolmap.rotmat2qvec(R.T), tvec=T, camera_id=1, name=name,
            xys=np.zeros((0, 2)), point3d_ids=np.zeros((0,), np.int64))
        with open(os.path.join(d, "images", name), "wb") as f:
            f.write(data)
    jcolmap.write_cameras_binary(cams, os.path.join(d, "sparse/0/cameras.bin"))
    jcolmap.write_images_binary(images, os.path.join(d, "sparse/0/images.bin"))
    rng = np.random.default_rng(2)
    jcolmap.write_points3d_binary(rng.normal(size=(50, 3)), rng.integers(0, 256, (50, 3)),
                                  rng.uniform(size=50), os.path.join(d, "sparse/0/points3D.bin"))


def colmap_views(w, h):
    """TIFF and BMP views whose np.asarray is the picture (L, RGB, RGBA)."""
    a = smooth(h, w, 4, 30)
    s16 = (a[..., :3].astype(np.int64) << 8) | samples((h, w, 3), 8, 31)
    bmp32 = np.concatenate([a[..., 2::-1], a[..., 3:]], -1).reshape(h, -1)  # BGRA bytes
    buf = io.BytesIO()
    Image.fromarray(a[..., 0]).save(buf, "BMP")
    return {
        "v_tiff16_lzw_pred.tif": tiff_bytes(s16, 16, 2, compression=5, predictor=2, rows_per_strip=7),
        "v_tiff8_tiled_deflate.tif": tiff_bytes(a[..., :3], 8, 2, compression=8, predictor=2, tile=(16, 16)),
        "v_tiff_rgba_packbits.tif": tiff_bytes(a, 8, 2, compression=32773, extra=[2], order=">"),
        "v_tiff_grey.tif": tiff_bytes(a[..., :1], 8, 1),
        "v_tiff_rgba16_assoc.tif": tiff_bytes(a.astype(np.int64) * 257, 16, 2, extra=[1]),
        "v_bmp24.bmp": bmp_bytes(padded_rows(a[..., 2::-1].reshape(h, -1)), w, h, 24),
        "v_bmp32_alpha.bmp": bmp_bytes(padded_rows(bmp32), w, h, 32, 124, compression=3,
                                       masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        "v_bmp_grey.bmp": buf.getvalue(),
        "v_bmp16.bmp": bmp_bytes(padded_rows(samples((h, w), 16, 32).astype("<u2").view(np.uint8)), w, h, 16),
    }


@pytest.mark.parametrize("resolution", [1, 2])
def test_colmap_tiff_and_bmp_views_match_jax(tmp_path, monkeypatch, cxx, resolution):
    """A COLMAP dataset of TIFF and BMP views (16-bit RGB LZW + predictor,
    tiled deflate, PackBits RGBA in "MM", grey, 16-bit associated alpha,
    24- and 32-bit BMP, grey and 16-bit BMP): the Scene's cameras equal the
    JAX package's, images bit for bit."""
    from test_torch_scene import both_scenes

    w, h = 45, 37
    src = str(tmp_path / "forms")
    write_colmap_dataset_of(src, colmap_views(w, h), w, h)
    jscene, scene = both_scenes(tmp_path, monkeypatch, src, eval_split=True, resolution=resolution)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == 9
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())


def refused_views():
    a = smooth(11, 13, 4, 40)
    cmyk, pbuf, onebuf = io.BytesIO(), io.BytesIO(), io.BytesIO()
    Image.fromarray(a, "CMYK").save(cmyk, "JPEG", quality=90)
    Image.fromarray(a[..., :3]).quantize(9).save(pbuf, "BMP")
    Image.fromarray(a[..., 0] > 99).save(onebuf, "BMP")
    return {
        "CMYK JPEG": ("view.jpg", cmyk.getvalue(), "CMYK"),
        "YCCK JPEG": ("view.jpg", encode_jpeg(a, 90, (2, 2), 0, adobe=2), "CMYK"),
        "CMYK TIFF": ("view.tif", tiff_bytes(a, 8, 5, compression=5), "CMYK"),
        "16-bit grey TIFF big-endian": ("view.tif", tiff_bytes(a[..., :1].astype(np.int64) * 300, 16, 1,
                                                                order=">"), "I;16B"),
        "16-bit grey TIFF": ("view.tif", tiff_bytes(a[..., :1].astype(np.int64) * 300, 16, 1), "I;16"),
        "palette BMP": ("view.bmp", pbuf.getvalue(), "P"),
        "1-bit BMP": ("view.bmp", onebuf.getvalue(), "1"),
        "palette TIFF": ("view.tif", tiff_bytes(a[..., :1], 8, 3, colormap=list(range(768))), "P"),
        "grey + alpha TIFF": ("view.tif", tiff_bytes(a[..., :2], 8, 1, extra=[2]), "LA"),
    }


@pytest.mark.parametrize("form", list(refused_views()))
def test_colmap_refuses_modes_that_are_not_the_picture(tmp_path, cxx, form):
    """The JAX package's COLMAP path trains on np.asarray of these (C, M, Y
    as RGB times K as alpha; 16-bit values; indices; 0 or 1; two
    channels): the port refuses each through load_camera, naming the file
    as images.bin lists it and the mode."""
    name, data, mode = refused_views()[form]
    src = str(tmp_path / "data")
    write_colmap_dataset_of(src, {name: data}, 13, 11)
    assert Image.open(os.path.join(src, "images", name)).mode == mode
    info = dataset_readers.read_colmap_scene(src, None, eval_split=False)
    with pytest.raises(ValueError, match=rf"'{name}' in .*images\.bin: .*{name}: .*\(mode {mode}\)"):
        dataset_readers.load_camera(info.train_cameras[0], 1)


@pytest.mark.parametrize("mode", ["I", "F"])
def test_colmap_refuses_32_bit_modes(tmp_path, monkeypatch, mode):
    """PIL's 32-bit integer and float modes (no form the port reads gives
    them) would train as numbers past 1: refused, naming the listing."""
    src = str(tmp_path / "data")
    write_colmap_dataset_of(src, {"view.tif": b""}, 13, 11)
    monkeypatch.setattr(image_io, "open_image", lambda path: image_io.Picture(
        np.zeros((11, 13, 1), np.int32 if mode == "I" else np.float32), mode))
    info = dataset_readers.read_colmap_scene(src, None, eval_split=False)
    with pytest.raises(ValueError, match=rf"'view\.tif' in .*images\.bin: .*\(mode {mode}\)"):
        dataset_readers.load_camera(info.train_cameras[0], 1)


def blender_frames(w, h):
    """Frames (bytes, named .png as the transforms file names them) in the
    forms PIL reads beyond PNG: CMYK and YCCK JPEG, 32-bit BMP with alpha,
    palette and RLE8 BMP, TIFF RGBA (unassociated and associated), 16-bit
    RGB TIFF, grey + alpha TIFF, a 1-bit TIFF."""
    a = smooth(h, w, 4, 50)
    a[..., 3] = np.where(a[..., 3] > 150, 255, np.where(a[..., 3] < 80, 0, a[..., 3]))
    cmyk = io.BytesIO()
    Image.fromarray(a, "CMYK").save(cmyk, "JPEG", quality=92)
    pal = samples((256, 3), 8, 51)
    idx = samples((h, w), 8, 52)
    idx[:, ::2] = 7
    return [
        cmyk.getvalue(),
        encode_jpeg(a, 92, (2, 2), 0, adobe=2),
        bmp_bytes(padded_rows(np.concatenate([a[..., 2::-1], a[..., 3:]], -1).reshape(h, -1)), w, h, 32, 108,
                  compression=3, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        bmp_bytes(padded_rows(idx.astype(np.uint8)), w, h, 8, palette=pal, colors=256),
        bmp_bytes(rle_encode(idx, False), w, h, 8, compression=1, palette=pal, colors=256),
        tiff_bytes(a, 8, 2, extra=[2], compression=5, predictor=2),
        tiff_bytes(a, 8, 2, extra=[1], compression=8),
        tiff_bytes(a[..., :3].astype(np.int64) * 257, 16, 2, compression=5, predictor=2, order=">"),
        tiff_bytes(a[..., 1:3], 8, 1, extra=[2], compression=32773),
        tiff_bytes(a[..., :1] > 128, 1, 0, tile=(16, 16)),
    ]


@pytest.mark.parametrize("white_background", [False, True])
def test_blender_cmyk_bmp_and_tiff_frames_match_jax(tmp_path, monkeypatch, cxx, white_background):
    """read_blender_scene on frames in every form beyond PNG: PIL's
    convert("RGBA") through the composite, bit for bit, then load_camera
    at -r 2."""
    w, h = 45, 37
    frames = blender_frames(w, h)
    d = tmp_path / "scene"
    (d / "train").mkdir(parents=True)
    listing = []
    for i, data in enumerate(frames):
        (d / "train" / f"r_{i}.png").write_bytes(data)
        listing.append({"file_path": f"./train/r_{i}", "transform_matrix": orbit_frames(len(frames))[i]})
    (d / "transforms_train.json").write_text(json.dumps({"camera_angle_x": 0.69, "frames": listing}))
    monkeypatch.setenv("GS_TPU_BLENDER_INIT_POINTS", "50")
    infos = []
    for pkg, name in ((jreaders, "jax"), (dataset_readers, "port")):
        shutil.copytree(d, tmp_path / name)
        np.random.seed(3)
        infos.append(pkg.read_blender_scene(str(tmp_path / name), white_background, eval_split=False))
    want, got = infos
    assert len(got.train_cameras) == len(frames)
    for i, (g, wnt) in enumerate(zip(got.train_cameras, want.train_cameras)):
        np.testing.assert_array_equal(g.image, np.asarray(wnt.image), err_msg=f"frame {i}")
        assert (g.width, g.height, g.fovx, g.fovy) == (wnt.width, wnt.height, wnt.fovx, wnt.fovy)
        assert_same_cameras([dataset_readers.load_camera(g, 2)], [jreaders.load_camera(wnt, 2)])


# ---- JPEG-in-TIFF ----

def pil_jpeg_strip(mode: str, quality: int):
    """A coder for `tiff_bytes(..., encode=...)`: each strip or tile as the
    abbreviated JPEG stream libtiff writes for PIL (PIL's own JPEG-in-TIFF
    of just those samples, one strip), and the JPEGTables bytes it goes
    with (the same for every strip at one quality and mode)."""
    def encode(chunk):
        im = Image.fromarray(np.ascontiguousarray(chunk[..., 0] if chunk.shape[2] == 1 else chunk).astype(np.uint8),
                             mode)
        buf = io.BytesIO()
        im.save(buf, "TIFF", compression="jpeg", quality=quality, strip_size=2**30)
        tags = Image.open(io.BytesIO(buf.getvalue())).tag_v2
        return buf.getvalue()[tags[273][0]:tags[273][0] + tags[279][0]], bytes(tags[347])
    return encode


JPEG_MODES = {"RGB": (2, 3, None), "L": (1, 1, None), "RGBA": (2, 4, [2]), "CMYK": (5, 4, None), "LA": (1, 2, [2])}


def jpeg_tiff(a, mode, quality, tables=True, coder=None, **kw) -> bytes:
    """A JPEG-in-TIFF of `a`'s first channels in `mode`, each strip or tile
    coded by `pil_jpeg_strip` (or by `coder(chunk, encode)`), with the
    JPEGTables tag unless `tables` is False."""
    photometric, n, extra = JPEG_MODES[mode]
    encode = pil_jpeg_strip(mode, quality)
    table_bytes = encode(a[:8, :8, :n])[1]
    tags = {347: (7, list(table_bytes))} if tables else {}
    return tiff_bytes(a[..., :n], 8, photometric, compression=7, extra=extra, tags=tags,
                      encode=(lambda c: coder(c, encode)) if coder else (lambda c: encode(c)[0]), **kw)




@pytest.mark.parametrize("strip_rows", [None, 8, 16])
@pytest.mark.parametrize("quality", [75, 90])
@pytest.mark.parametrize("mode", list(JPEG_MODES))
def test_pil_written_jpeg_tiff_gives_pils_pixels(tmp_path, cxx, mode, quality, strip_rows):
    """PIL's own JPEG-in-TIFF (libtiff: abbreviated strips after a
    JPEGTables tag, the components with no colour conversion): RGB, grey,
    RGBA, CMYK and grey + alpha, q75 and q90, in strips of 8 or 16 rows or
    one strip."""
    a = smooth(45, 67, 4, 60 + quality)
    im = Image.fromarray(np.ascontiguousarray(a[..., 0] if mode == "L" else a[..., :len(mode)]), mode)
    buf = io.BytesIO()
    options = {} if strip_rows is None else {"strip_size": 67 * len(mode) * strip_rows}
    im.save(buf, "TIFF", compression="jpeg", quality=quality, **options)
    got = assert_like_pil(tmp_path, buf.getvalue(), mode, ".tif")
    assert got.mode == mode


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("tile", [(16, 16), (32, 16), (48, 40), None])
@pytest.mark.parametrize("quality", [75, 90])
@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
def test_tiled_jpeg_tiff_gives_pils_pixels(tmp_path, cxx, mode, quality, tile, order):
    """Tiles (which PIL's writer cannot make) and strips of 16 rows, each
    libtiff's abbreviated stream, tiles cropped where they overhang, in
    both byte orders."""
    a = smooth(45, 67, 4, 70)
    data = jpeg_tiff(a, mode, quality, tile=tile, rows_per_strip=None if tile else 16, order=order)
    assert assert_follows_pil(tmp_path, data, f"{mode} {tile}", ".tif") is not None


def _cut(stream: bytes, keep: float, tail: bytes = b"") -> bytes:
    return stream[:int(len(stream) * keep)] + tail


def _flip(stream: bytes) -> bytes:
    b = bytearray(stream)
    at = len(b) // 2
    while 0xFF in b[at - 1:at + 2] or b[at] ^ 0x10 == 0xFF:
        at += 1
    b[at] ^= 0x10
    return bytes(b)


JPEG_TIFF_DAMAGE = {  # what libtiff reads for PIL: pixels, or a raise
    "strips cut in their data": dict(coder=lambda c, e: _cut(e(c)[0], 0.6)),
    "strips cut after a 0xFF": dict(coder=lambda c, e: _cut(e(c)[0], 0.6, b"\xff\xff")),
    "strips cut in their header": dict(coder=lambda c, e: e(c)[0][:12]),
    "a flipped byte in each strip": dict(coder=lambda c, e: _flip(e(c)[0])),
    "full streams, no JPEGTables": dict(coder=lambda c, e: e(c)[0][:2] + e(c)[1][2:-2] + e(c)[0][2:], tables=False),
    "abbreviated streams, no JPEGTables": dict(tables=False),
    "strips shorter than their rows": dict(coder=lambda c, e: e(c[:8])[0]),
    "strips narrower than the image": dict(coder=lambda c, e: e(c[:, :40])[0]),
    "strips taller than their rows": dict(coder=lambda c, e: e(np.concatenate([c, c]))[0]),
    "grey strips in an RGB image": dict(coder=lambda c, e: pil_jpeg_strip("L", 90)(c[..., :1])[0]),
}


@pytest.mark.parametrize("case", list(JPEG_TIFF_DAMAGE))
def test_jpeg_tiff_damage_follows_pil(tmp_path, cxx, case):
    """libtiff hands libjpeg a fake EOI where a strip's bytes end (data cut
    short reads as zeros, as at any marker), checks each frame against its
    strip (components, sampling, size), and needs the tables: the port
    reads what PIL reads and raises where PIL raises. A frame smaller than
    its strip, which libtiff only warns about, leaves PIL's rows
    uninitialised: the port refuses it."""
    a = smooth(45, 67, 4, 80)
    options = dict(JPEG_TIFF_DAMAGE[case])
    data = jpeg_tiff(a, "RGB", 90, rows_per_strip=16, **options)
    got = assert_follows_pil(tmp_path, data, case, ".tif") if "shorter" not in case and "narrower" not in case \
        else None
    if got is None:
        assert_refused(tmp_path, data, "strip or tile 0", ".tif")


def test_jpeg_tiff_tables_as_libtiff_reads_them(tmp_path, cxx):
    """A JPEGTables stream cut short (libtiff's fake EOI fills the rest of
    its last segment), a restart interval in the tables (the strip's SOI
    resets it) and a frame in the tables (libtiff: Bogus JPEGTables
    field)."""
    a = smooth(45, 67, 4, 90)
    encode = pil_jpeg_strip("RGB", 90)
    strips = {}
    tables = encode(a[:8, :8, :3])[1]
    dri = tables[:2] + b"\xff\xdd\x00\x04\x00\x01" + tables[2:]
    full = Image.fromarray(a[:8, :8, :3])
    buf = io.BytesIO()
    full.save(buf, "JPEG", quality=90)
    for name, t in (("cut tables", tables[:-30]), ("a DRI in the tables", dri),
                    ("a frame in the tables", buf.getvalue())):
        strips[name] = tiff_bytes(a[..., :3], 8, 2, compression=7, rows_per_strip=16,
                                  encode=lambda c: encode(c)[0], tags={347: (7, list(t))})
    assert assert_follows_pil(tmp_path, strips["cut tables"], "cut", ".tif") is not None
    assert assert_follows_pil(tmp_path, strips["a DRI in the tables"], "dri", ".tif") is not None
    assert assert_follows_pil(tmp_path, strips["a frame in the tables"], "frame", ".tif") is None


def test_jpeg_tiff_refusals_name_the_file(tmp_path, cxx):
    """YCbCr JPEG-in-TIFF (PIL cannot write it) is read as PIL reads it
    through libtiff's conversion (here streams sampled 1x1, which libtiff
    takes as the first strip's sampling), and refused by name where its
    strips are sampled otherwise than the YCbCrSubsampling tag says; a
    subsampled stream in an RGB TIFF (libtiff: improper sampling factors),
    16-bit samples."""
    a = smooth(45, 67, 4, 95)
    encode = pil_jpeg_strip("RGB", 90)
    tables = encode(a[:8, :8, :3])[1]
    ycbcr = tiff_bytes(a[..., :3], 8, 6, compression=7, rows_per_strip=16, encode=lambda c: encode(c)[0],
                       tags={347: (7, list(tables))})
    assert assert_follows_pil(tmp_path, ycbcr, "ycbcr", ".tif") is not None
    improper = tiff_bytes(a[..., :3], 8, 6, compression=7, rows_per_strip=16, encode=lambda c: encode(c)[0],
                          tags={347: (7, list(tables)), 530: (3, [2, 2])})
    assert assert_follows_pil(tmp_path, improper, "improper", ".tif") is None
    assert_refused(tmp_path, improper, r"sampled 1x1 in a JPEG strip or tile \(libtiff: Improper JPEG sampling", ".tif")

    def subsampled(c):
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(c[..., :3]).astype(np.uint8)).save(buf, "JPEG", quality=90)
        return buf.getvalue()

    data = tiff_bytes(a[..., :3], 8, 2, compression=7, rows_per_strip=16, encode=subsampled)
    assert assert_follows_pil(tmp_path, data, "subsampled", ".tif") is None
    assert_refused(tmp_path, data, r"sampled 2x2 in a JPEG strip or tile \(libtiff: Improper JPEG sampling", ".tif")
    wide = tiff_bytes(a[..., :3].astype(np.int64) * 257, 16, 2, compression=7, encode=lambda c: encode(c // 257)[0],
                      tags={347: (7, list(tables))})
    assert_refused(tmp_path, wide, r"JPEG-in-TIFF at 16 bits", ".tif")


def test_jpeg_tiff_needs_the_compiled_decoder(tmp_path, fake_cxx):
    """No fallback: a JPEG-in-TIFF cannot be read when the compiled JPEG
    decoder cannot be built."""
    a = smooth(17, 19, 3, 96)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "TIFF", compression="jpeg")
    fake_cxx(fail=True)
    path = tmp_path / "view.tif"
    path.write_bytes(buf.getvalue())
    with pytest.raises(RuntimeError):
        image_io.open_image(path)
    assert not cuda_build.host_library_path("jpeg_decode").exists()


TIFF_JPEG_FIXTURES = os.path.join(os.path.dirname(FIXTURES), "torch_tiff_jpeg")
TIFF_JPEG_NAMES = sorted(f[:-4] for f in os.listdir(TIFF_JPEG_FIXTURES) if f.endswith(".npz"))


@pytest.mark.parametrize("name", TIFF_JPEG_NAMES)
def test_jpeg_tiff_fixture_pixels_are_pils(tmp_path, cxx, name):
    """PIL's reading of each small committed JPEG-in-TIFF equals the mode,
    pixels and RGBA committed beside it (which chip_smoke.py holds the
    port to on the card's machine), and so does the port's."""
    path = os.path.join(TIFF_JPEG_FIXTURES, f"{name}.tif")
    with open(path, "rb") as f:
        data = f.read()
    want = np.load(os.path.join(TIFF_JPEG_FIXTURES, f"{name}.npz"))
    mode, pixels, rgba = pil_read(data)
    assert mode == str(want["mode"])
    np.testing.assert_array_equal(pixels, want["pixels"])
    np.testing.assert_array_equal(rgba, want["rgba"])
    got = image_io.open_image(path)
    assert got.mode == mode
    np.testing.assert_array_equal(got.pixels, want["pixels"])
    np.testing.assert_array_equal(image_io.to_rgba(got), want["rgba"])


def test_1080p_jpeg_tiff_fixture_gives_pils_hash(cxx):
    """The 1920x1080 JPEG-in-TIFF PIL wrote: PIL's pixels and the port's
    have the mode, shape and SHA-256 committed in sha256.json, which
    chip_smoke.py holds the port to on the card's machine."""
    import hashlib

    with open(os.path.join(TIFF_JPEG_FIXTURES, "sha256.json")) as f:
        readings = json.load(f)
    assert len(readings) == 1
    for name, want in readings.items():
        path = os.path.join(TIFF_JPEG_FIXTURES, name)
        assert 100_000 <= os.path.getsize(path) <= 300_000
        pil = np.asarray(Image.open(path))
        got = image_io.open_image(path)
        for mode, px in ((Image.open(path).mode, pil), (got.mode, got.pixels)):
            assert (mode, list(px.shape), hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest()) == (
                want["mode"], want["shape"], want["sha256"])


def jpeg_tiff_views(w, h):
    """JPEG-in-TIFF files in every mode PIL writes them (PIL's own strips,
    and RGB tiles from `jpeg_tiff`)."""
    a = smooth(h, w, 4, 97)
    out = {}
    for mode, q in (("RGB", 90), ("L", 75), ("RGBA", 90), ("CMYK", 75), ("LA", 90)):
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(a[..., 0] if mode == "L" else a[..., :len(mode)]), mode).save(
            buf, "TIFF", compression="jpeg", quality=q, strip_size=w * len(mode) * 8)
        out[f"v_jpeg_{mode.lower()}.tif"] = (buf.getvalue(), mode)
    out["v_jpeg_rgb_tiles.tif"] = (jpeg_tiff(a, "RGB", 75, tile=(16, 16)), "RGB")
    return out


@pytest.mark.parametrize("resolution", [1, 2])
def test_colmap_jpeg_tiff_views_match_jax(tmp_path, monkeypatch, cxx, resolution):
    """A COLMAP dataset of JPEG-in-TIFF views in the modes the path trains
    on (RGB strips and tiles, grey, RGBA): the Scene's cameras equal the
    JAX package's, images bit for bit; CMYK and grey + alpha ones are
    refused, naming the file and the mode."""
    from test_torch_scene import both_scenes

    w, h = 45, 37
    views = jpeg_tiff_views(w, h)
    src = str(tmp_path / "forms")
    write_colmap_dataset_of(src, {n: d for n, (d, m) in views.items() if m not in ("CMYK", "LA")}, w, h)
    jscene, scene = both_scenes(tmp_path, monkeypatch, src, eval_split=True, resolution=resolution)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == 4
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())
    for name in ("v_jpeg_cmyk.tif", "v_jpeg_la.tif"):
        data, mode = views[name]
        refused = str(tmp_path / f"refused_{mode}")
        write_colmap_dataset_of(refused, {name: data}, w, h)
        info = dataset_readers.read_colmap_scene(refused, None, eval_split=False)
        with pytest.raises(ValueError, match=rf"'{name}' in .*images\.bin: .*{name}: .*\(mode {mode}\)"):
            dataset_readers.load_camera(info.train_cameras[0], 1)


@pytest.mark.parametrize("white_background", [False, True])
def test_blender_jpeg_tiff_frames_match_jax(tmp_path, monkeypatch, cxx, white_background):
    """read_blender_scene on JPEG-in-TIFF frames in every mode PIL writes
    (RGBA and grey + alpha composited on the background): PIL's
    convert("RGBA"), bit for bit, then load_camera at -r 2."""
    from test_torch_tga import blender_scenes

    frames = [data for data, _ in jpeg_tiff_views(29, 23).values()]
    blender_scenes(tmp_path, monkeypatch, frames, white_background, jreaders, dataset_readers)
