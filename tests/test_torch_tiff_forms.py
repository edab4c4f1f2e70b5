"""The TIFF forms aerial, drone and orthophoto datasets arrive in, in the
port (`utils/tiff.py`, the compiled `csrc/zstd_decode.cc` and
`csrc/jpeg_decode.cc`), against PIL, which the JAX package opens its
datasets with: BigTIFF, PlanarConfiguration 2, JPEG-in-TIFF in YCbCr,
LZMA and ZSTD.

Tolerances: every comparison is bit-equal. For each file the port's
`image_io.open_image` must give PIL's mode and `np.asarray(Image.open(f))`
(a channel axis kept) and `to_rgba` PIL's `convert("RGBA")`, or raise a
`ValueError` naming the file where PIL raises, or where PIL reads the file
as other pixels than the picture (planar layouts, held to PIL's reading
of the same samples stored pixel by pixel). Files are PIL's own where PIL
writes the form (LZMA, ZSTD, BigTIFF uncompressed), else written here by
`tests/torch_image_writers.tiff_bytes` around strips PIL's JPEG encoder,
`zstandard` (a test-only package; the port does not import it) or
`lzma` code. Images are at most 128x128, made from
`np.random.default_rng(seed)`.

The compiled decoders are built here with the host's `c++`; tests that
need them skip, with the reason, only where no C++ compiler exists.
"""

import functools
import hashlib
import io
import json
import lzma
import os
import struct
import sys

import numpy as np
import pytest
import zstandard
from PIL import Image

from gaussian_splatting_tpu.scene import dataset_readers as jreaders
from gaussian_splatting_torch.scene import dataset_readers
from gaussian_splatting_torch.utils import cuda_build, image_io, tiff
from test_torch_image_forms import (  # noqa: F401  (cxx, fake_cxx: fixtures)
    assert_follows_pil, assert_refused, cxx, fake_cxx, pil_read, samples, smooth, write_colmap_dataset_of,
)
from test_torch_scene import assert_same_cameras
from torch_image_writers import jpeg_tables_apart, tiff_bytes

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_tiff_forms")


def pil_tiff(pixels, compression, predictor=None, **options) -> bytes:
    """`pixels` as PIL writes them in a TIFF (libtiff for the compressions)."""
    buf = io.BytesIO()
    info = {317: predictor} if predictor else {}
    Image.fromarray(pixels).save(buf, "TIFF", compression=compression, tiffinfo=info, **options)
    return buf.getvalue()


def zstd_coder(depth=8, order="<", level=3, **options):
    """A coder for `tiff_bytes(..., encode=...)`: each strip or tile (its
    samples, differenced where the file has Predictor 2) one Zstandard
    frame of its sample bytes, as libtiff writes them."""
    compressor = zstandard.ZstdCompressor(level=level, **options)
    return lambda chunk: compressor.compress(sample_bytes_of(chunk, depth, order))


def sample_bytes_of(chunk, depth, order="<"):
    return np.ascontiguousarray(chunk.astype(order + ("u2" if depth == 16 else "u1"))).tobytes()


# ---- BigTIFF ----

@pytest.mark.parametrize("compression", [1, 5, 8, 34925, 50000])
@pytest.mark.parametrize("order", ["<", ">"])
def test_bigtiff_follows_pil(tmp_path, cxx, order, compression):
    """BigTIFF (20-byte entries, LONG8 strip and tile offsets) in both byte
    orders, strips and tiles: PIL reads little-endian ones, and reads a
    big-endian one's header as a classic TIFF's and raises; the port
    follows it."""
    a = smooth(45, 67, 3, 1)
    encode = zstd_coder(8, order) if compression == 50000 else None
    for layout in (dict(rows_per_strip=16), dict(tile=(32, 16)), dict()):
        data = tiff_bytes(a, 8, 2, order=order, compression=compression, big=True, encode=encode, **layout)
        got = assert_follows_pil(tmp_path, data, f"{order} {layout}", ".tif")
        assert (got is None) == (order == ">")
        if got is not None:
            np.testing.assert_array_equal(got.pixels, a)


def test_bigtiff_pil_writes(tmp_path, cxx):
    """The BigTIFF PIL writes (`big_tiff=True`, uncompressed; with a
    compression PIL writes a classic TIFF), and a 16-bit one."""
    a = smooth(45, 67, 3, 2)
    for pixels in (a, np.ascontiguousarray(a[..., 0])):
        buf = io.BytesIO()
        Image.fromarray(pixels).save(buf, "TIFF", big_tiff=True)
        assert buf.getvalue()[:4] == b"II+\x00"
        assert assert_follows_pil(tmp_path, buf.getvalue(), "pil", ".tif") is not None
    s16 = samples((45, 67, 1), 16, 3)
    assert assert_follows_pil(tmp_path, tiff_bytes(s16, 16, 1, big=True, compression=5, predictor=2), "16", ".tif")


def test_bigtiff_header_and_ifd_faults(tmp_path, cxx):
    """A BigTIFF whose IFD is cut short raises where PIL raises; one whose
    header's offset size is not 8 PIL reads uncompressed (its own parser)
    and refuses compressed (libtiff)."""
    a = smooth(21, 35, 3, 4)
    data = tiff_bytes(a, 8, 2, big=True)
    n = struct.unpack("<Q", data[16:24])[0]
    assert assert_follows_pil(tmp_path, data[:24 + 20 * n - 7], "cut", ".tif") is None
    for compression in (1, 5):
        bad = bytearray(tiff_bytes(a, 8, 2, big=True, compression=compression))
        bad[4] = 4
        got = assert_follows_pil(tmp_path, bytes(bad), f"offset size 4, {compression}", ".tif")
        assert (got is None) == (compression != 1)


def test_ifd8_offsets_as_libtiff_and_pil_read_them(tmp_path, cxx):
    """Strip offsets of type SLONG8 (17) or IFD8 (18) in a BigTIFF: libtiff
    reads SLONG8 ones for a compressed file, and refuses IFD8; PIL's own
    parser, which reads an uncompressed one, drops both and raises."""
    a = smooth(21, 35, 3, 6)
    for typ in (17, 18):
        for compression in (1, 8):
            data = tiff_bytes(a, 8, 2, big=True, rows_per_strip=8, compression=compression,
                              tags={273: (typ, [0] * 3)})
            got = assert_follows_pil(tmp_path, data, f"type {typ}, compression {compression}", ".tif")
            assert (got is None) == (compression == 1 or typ == 18)


def test_long8_offsets_in_a_classic_tiff(tmp_path, cxx):
    """PIL's parser reads a LONG8 field in a classic TIFF too (an offset
    past 4 bytes)."""
    a = smooth(21, 35, 3, 5)
    data = tiff_bytes(a, 8, 2, rows_per_strip=4, tags={273: (16, [0] * 6)})
    assert assert_follows_pil(tmp_path, data, "long8", ".tif") is not None


# ---- PlanarConfiguration 2 ----

PLANAR_COMPRESSIONS = [1, 5, 8, 32773, 34925, 50000, 7]


def _planar_samples(key, seed):
    photo, bits, extra = key
    s = samples((23, 37, len(bits)), bits[0], seed)
    if photo == 3:
        s[..., 0] %= 4
    return s


@pytest.mark.parametrize("kind", ["strips", "tiles"])
@pytest.mark.parametrize("compression", PLANAR_COMPRESSIONS)
def test_planar_layouts_read_as_pil_reads_the_picture(tmp_path, cxx, compression, kind):
    """Every layout of more than one sample in planes, each plane's strips
    or tiles in turn (uncompressed, LZW, deflate, PackBits, LZMA, ZSTD
    and, at 8 bits, JPEG with one-component streams). The picture is
    PIL's reading of the same samples (JPEG: each plane's decoded samples)
    stored pixel by pixel, uncompressed: where PIL reads the planes as
    that, the port gives PIL's pixels; where PIL raises or reads other
    pixels (16-bit uncompressed planes, grey + alpha, associated alpha or
    unspecified samples uncompressed, RGBA without ExtraSamples, padded
    layouts in strips), the port refuses by name."""
    layout = dict(tile=(16, 16)) if kind == "tiles" else dict(rows_per_strip=8)
    read = 0
    for key in sorted(tiff.LAYOUTS, key=repr):
        photo, bits, extra = key
        if len(bits) < 2 or (compression == 7 and bits[0] != 8):
            continue
        s = _planar_samples(key, 10 + len(bits))
        options = dict(extra=list(extra) if extra else None, colormap=[0] * 768 if photo == 3 else None)
        coded = dict(layout, compression=compression)
        picture = s
        if compression == 7:
            s = np.repeat(np.repeat(smooth(12, 19, len(bits), 11), 2, 0), 2, 1)[:23, :37].astype(np.int64)
            coder = _grey_jpeg_coder()
            coded.update(encode=lambda c: coder(c)[0], tags={347: (7, list(coder(s[:8, :8, :1])[1]))})
            picture = np.stack([np.asarray(Image.open(io.BytesIO(tiff_bytes(s[..., i:i + 1], 8, 1, **coded))))
                                for i in range(len(bits))], -1)
        elif compression == 50000:
            coded.update(encode=zstd_coder(bits[0]))
        planar = tiff_bytes(s, bits[0], photo, planar=True, **options, **coded)
        try:
            want = pil_read(tiff_bytes(picture, bits[0], photo, **options))
            got = pil_read(planar)
            same = got[0] == want[0] and got[1].shape == want[1].shape and np.array_equal(got[1], want[1])
        except Exception:  # noqa: BLE001  (PIL raises on the planes: the port must too)
            same = False
        label = f"{key} {compression} {kind}"
        if same:
            assert assert_follows_pil(tmp_path, planar, label, ".tif") is not None
            read += 1
        else:
            assert_refused(tmp_path, planar, r"PlanarConfiguration 2", ".tif")
    assert read >= 3


def _grey_jpeg_coder(quality=90):
    """Each plane's strip or tile as PIL's grey JPEG: (abbreviated stream,
    JPEGTables)."""
    def encode(chunk):
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(chunk[..., 0]).astype(np.uint8)).save(buf, "JPEG", quality=quality)
        return jpeg_tables_apart(buf.getvalue())
    return encode


def test_planar_pil_reads_by_plane_offsets(tmp_path, cxx):
    """Uncompressed planes in one strip each, the last strip short, and an
    image that is one strip a plane (PIL reads every plane's offset), RGB
    and CMYK, and 16-bit RGB under LZW with Predictor 2 in both byte
    orders."""
    a = samples((45, 67, 4), 8, 12)
    for rows in (None, 16, 45):
        for photo, n in ((2, 3), (5, 4)):
            data = tiff_bytes(a[..., :n], 8, photo, planar=True, rows_per_strip=rows)
            got = assert_follows_pil(tmp_path, data, f"{rows} {photo}", ".tif")
            np.testing.assert_array_equal(got.pixels, a[..., :n])
    s16 = samples((45, 67, 3), 16, 13)
    for order in "<>":
        got = assert_follows_pil(tmp_path, tiff_bytes(s16, 16, 2, order=order, planar=True, compression=5,
                                                      predictor=2, rows_per_strip=16), order, ".tif")
        np.testing.assert_array_equal(got.pixels, s16 >> 8)


def test_planar_refusals_name_the_layout(tmp_path, cxx):
    """The three layouts PIL reads in planes as other pixels than the
    picture, refused by name: 16-bit uncompressed planes (PIL's raw
    decoder reads them as 8-bit), grey + alpha (PIL reads other pixels
    under compression and raises uncompressed), associated alpha
    uncompressed (PIL: unknown raw mode)."""
    s16 = samples((21, 35, 3), 16, 14)
    la = samples((21, 35, 2), 8, 15)
    rgba = samples((21, 35, 4), 8, 16)
    cases = [
        (tiff_bytes(s16, 16, 2, planar=True), r"16-bit samples in uncompressed planes"),
        (tiff_bytes(la, 8, 1, planar=True, extra=[2], compression=5), r"grey \+ alpha in compressed planes"),
        (tiff_bytes(la, 8, 1, planar=True, extra=[2]), r"grey \+ alpha in uncompressed planes"),
        (tiff_bytes(rgba, 8, 2, planar=True, extra=[1]), r"associated alpha in uncompressed planes"),
    ]
    for data, match in cases:
        assert_refused(tmp_path, data, match, ".tif")
    # PIL reads the 16-bit planes as 8-bit, the grey + alpha LZW planes as other pixels
    for (data, _), contiguous in zip(cases[:2], (tiff_bytes(s16, 16, 2), tiff_bytes(la, 8, 1, extra=[2]))):
        assert not np.array_equal(pil_read(data)[1], pil_read(contiguous)[1])
    for data, _ in cases[2:]:
        with pytest.raises(ValueError, match="unknown raw mode"):
            Image.open(io.BytesIO(data)).load()


# ---- JPEG-in-TIFF in YCbCr ----

SUBSAMPLING = {(1, 1): 0, (2, 1): 1, (2, 2): 2}  # (h, v): PIL's subsampling option


def ycbcr_coder(sampling, quality=90):
    """A coder of YCbCr JPEG strips (PIL's JPEG encoder: JFIF, the chroma
    subsampled `sampling`): (abbreviated stream, JPEGTables). PIL's TIFF
    writer cannot write these (it corrupts the heap)."""
    def encode(chunk):
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(chunk).astype(np.uint8)).save(
            buf, "JPEG", quality=quality, subsampling=SUBSAMPLING[sampling])
        return jpeg_tables_apart(buf.getvalue())
    return encode


def ycbcr_tiff(a, sampling, tag=True, tables=True, coder=None, **layout) -> bytes:
    """A YCbCr JPEG-in-TIFF of `a`: each strip or tile from `coder` (default
    `ycbcr_coder(sampling)`), the YCbCrSubsampling tag `sampling` (or the
    values `tag` where a tuple, none where False), abbreviated streams
    after JPEGTables, or full streams where not `tables`."""
    encode = coder or ycbcr_coder(sampling)
    tags = {} if tag is False else {530: (3, list(sampling if tag is True else tag))}
    if tables:
        tags[347] = (7, list(ycbcr_coder(sampling)(a[:8, :8])[1]))
        body = lambda c: encode(c)[0]  # noqa: E731
    else:
        body = lambda c: b"\xff\xd8" + encode(c)[1][2:-2] + encode(c)[0][2:]  # noqa: E731
    return tiff_bytes(a, 8, 6, compression=7, encode=body, tags=tags, **layout)


@pytest.mark.parametrize("tag", [True, False])
@pytest.mark.parametrize("layout", ["rows 8", "rows 16", "one strip", "tiles 32x16", "tiles 16x16"])
@pytest.mark.parametrize("sampling", list(SUBSAMPLING))
def test_ycbcr_jpeg_tiff_gives_pils_pixels(tmp_path, cxx, sampling, layout, tag):
    """YCbCr JPEG-in-TIFF (photometric 6) at 4:4:4, 4:2:2 and 4:2:0 in
    strips of 8 and 16 rows, one strip and tiles, with the
    YCbCrSubsampling tag or without it (libtiff takes the first strip's
    sampling): PIL's mode "RGB" and its pixels, which are libjpeg's
    conversion and upsampling of each strip on its own."""
    a = smooth(45, 67, 3, 20)
    options = {"rows 8": dict(rows_per_strip=8), "rows 16": dict(rows_per_strip=16), "one strip": {},
               "tiles 32x16": dict(tile=(32, 16)), "tiles 16x16": dict(tile=(16, 16))}[layout]
    got = assert_follows_pil(tmp_path, ycbcr_tiff(a, sampling, tag, **options), f"{sampling} {layout}", ".tif")
    assert got is not None and got.mode == "RGB"
    if layout == "one strip":
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, "JPEG", quality=90, subsampling=SUBSAMPLING[sampling])
        np.testing.assert_array_equal(got.pixels, np.asarray(Image.open(buf)))


def test_ycbcr_jpeg_tiff_rules_follow_libtiff(tmp_path, cxx):
    """libtiff's JPEGPreDecode and JPEGFixupTagsSubsampling, each held to
    PIL: component 0 sampled as the tag says, the others 1x1 (else
    "Improper JPEG sampling factors"); without the tag, the first strip's
    sampling for every strip; the last strip coded at the full strip
    height (read); a frame smaller than its strip (refused: PIL leaves its
    rows uninitialised); full streams without JPEGTables; a tag of one
    value (dropped: the first strip's sampling)."""
    a = smooth(45, 67, 3, 21)
    first = [True]

    def mixed(c):
        s = (2, 1) if first[0] else (2, 2)
        first[0] = False
        return ycbcr_coder(s)(c)

    def taller_last(c):
        return ycbcr_coder((2, 2))(np.concatenate([c, np.zeros((16 - len(c),) + c.shape[1:], c.dtype)]))

    read = {
        "full streams": ycbcr_tiff(a, (2, 2), tables=False, rows_per_strip=16),
        "last strip taller": ycbcr_tiff(a, (2, 2), coder=taller_last, rows_per_strip=16),
        "a one-value tag": ycbcr_tiff(a, (2, 1), tag=(2,), rows_per_strip=16),
    }
    refused = {
        "tag 2x2, frames 1x1": (ycbcr_tiff(a, (1, 1), tag=(2, 2), rows_per_strip=16),
                                r"Improper JPEG sampling factors"),
        "tag 1x1, frames 2x2": (ycbcr_tiff(a, (2, 2), tag=(1, 1), rows_per_strip=16),
                                r"Improper JPEG sampling factors"),
        "no tag, the first strip 2x1": (ycbcr_tiff(a, (2, 2), tag=False, coder=mixed, rows_per_strip=16),
                                        r"Improper JPEG sampling factors"),
        "a frame smaller than its strip": (ycbcr_tiff(a, (2, 2), coder=lambda c: ycbcr_coder((2, 2))(c[:8]),
                                                      rows_per_strip=16), r"smaller than the TIFF's"),
        "YCbCr without JPEG": (tiff_bytes(a, 8, 6), r"PIL's raw mode RGBX reads 4 bytes a pixel"),
        "YCbCr JPEG in planes": (tiff_bytes(a, 8, 6, planar=True, compression=7, rows_per_strip=16,
                                            encode=lambda c: _grey_jpeg_coder()(c)[0]), r"YCbCr JPEG-in-TIFF in"),
    }
    for name, data in read.items():
        assert assert_follows_pil(tmp_path, data, name, ".tif") is not None, name
    for name, (data, match) in refused.items():
        if name != "a frame smaller than its strip":
            assert assert_follows_pil(tmp_path, data, name, ".tif") is None, name
        assert_refused(tmp_path, data, match, ".tif")


def test_rgb_jpeg_tiff_last_strip_may_be_taller(tmp_path, cxx):
    """The last-strip rule holds for JPEG-in-TIFF in every photometric: an
    RGB file whose last strip is coded at the full strip height."""
    from test_torch_image_forms import pil_jpeg_strip

    a = smooth(45, 67, 3, 22)
    encode = pil_jpeg_strip("RGB", 90)

    def taller(c):
        return encode(np.concatenate([c, np.zeros((16 - len(c),) + c.shape[1:], c.dtype)]))[0]

    data = tiff_bytes(a, 8, 2, compression=7, rows_per_strip=16, encode=taller,
                      tags={347: (7, list(encode(a[:8, :8])[1]))})
    assert assert_follows_pil(tmp_path, data, "rgb taller", ".tif") is not None


# ---- LZMA and ZSTD ----

PIL_MODES = {"L": 1, "RGB": 3, "RGBA": 4, "I;16": 1}


def mode_pixels(mode, seed):
    a = smooth(45, 67, 4, seed)
    if mode == "I;16":
        return (a[..., 0].astype(np.uint16) << 8) | a[..., 1]
    return np.ascontiguousarray(a[..., 0] if mode == "L" else a[..., :PIL_MODES[mode]])


@pytest.mark.parametrize("predictor", [None, 2])
@pytest.mark.parametrize("mode", list(PIL_MODES))
@pytest.mark.parametrize("compression", ["zstd", "lzma"])
def test_pil_written_zstd_and_lzma(tmp_path, cxx, compression, mode, predictor):
    """ZSTD and LZMA TIFFs as PIL writes them (libtiff: one stream a strip),
    with and without Predictor 2, in L, RGB, RGBA and I;16, one strip and
    strips of 8 rows."""
    px = mode_pixels(mode, 30)
    for strip in (None, 8):
        options = {} if strip is None else {"strip_size": px.shape[1] * px.itemsize * PIL_MODES[mode] * strip}
        data = pil_tiff(px, compression, predictor, **options)
        got = assert_follows_pil(tmp_path, data, f"{mode} {strip}", ".tif")
        np.testing.assert_array_equal(got.pixels.reshape(px.shape), px)


@pytest.mark.parametrize("compression", [34925, 50000])
def test_zstd_and_lzma_tiles_and_16_bits(tmp_path, cxx, compression):
    """Tiles (PIL cannot write them), 16-bit RGB and both byte orders, with
    and without Predictor 2."""
    a = smooth(45, 67, 3, 31)
    s16 = (a.astype(np.int64) << 8) | samples(a.shape, 8, 32)
    for order in "<>":
        for predictor in (None, 2):
            for s, depth in ((a, 8), (s16, 16)):
                for layout in (dict(tile=(32, 16)), dict(rows_per_strip=7)):
                    encode = zstd_coder(depth, order) if compression == 50000 else None
                    data = tiff_bytes(s, depth, 2, order=order, compression=compression, predictor=predictor,
                                      encode=encode, **layout)
                    got = assert_follows_pil(tmp_path, data, f"{order} {predictor} {depth} {layout}", ".tif")
                    np.testing.assert_array_equal(got.pixels, s if depth == 8 else s >> 8)


ZSTD_FRAMES = {  # how each strip's bytes are coded: PIL is the rule for each
    "level 1": lambda b: zstandard.ZstdCompressor(level=1).compress(b),
    "level 3": lambda b: zstandard.ZstdCompressor(level=3).compress(b),
    "level 9": lambda b: zstandard.ZstdCompressor(level=9).compress(b),
    "level 19": lambda b: zstandard.ZstdCompressor(level=19).compress(b),
    "level 22": lambda b: zstandard.ZstdCompressor(level=22).compress(b),
    "negative level": lambda b: zstandard.ZstdCompressor(level=-5).compress(b),
    "content checksum": lambda b: zstandard.ZstdCompressor(level=3, write_checksum=True).compress(b),
    "no content size": lambda b: zstandard.ZstdCompressor(level=3, write_content_size=False).compress(b),
    "streamed in pieces": lambda b: _streamed(b),
    "two frames": lambda b: (zstandard.ZstdCompressor(level=3).compress(b[:len(b) // 2])
                             + zstandard.ZstdCompressor(level=3).compress(b[len(b) // 2:])),
    "a skippable frame first": lambda b: struct.pack("<II", 0x184D2A50, 3) + b"abc" + ZSTD_FRAMES["level 3"](b),
    "a skippable frame after": lambda b: ZSTD_FRAMES["level 3"](b) + struct.pack("<II", 0x184D2A5F, 2) + b"ab",
    "bytes after the frame": lambda b: ZSTD_FRAMES["level 3"](b) + b"\x01\x02\x03",
    "a frame longer than its strip": lambda b: ZSTD_FRAMES["level 3"](b + bytes(300)),
    "a frame shorter than its strip": lambda b: ZSTD_FRAMES["level 3"](b[:-5]),
    "a frame cut short": lambda b: ZSTD_FRAMES["level 3"](b)[:-9],
    "a frame naming a dictionary": lambda b: _with_dictionary_id(ZSTD_FRAMES["no content size"](b)),
}


def _streamed(b: bytes) -> bytes:
    c = zstandard.ZstdCompressor(level=3).compressobj()
    return b"".join(c.compress(b[i:i + 1000]) for i in range(0, len(b), 1000)) + c.flush()


def _with_dictionary_id(frame: bytes) -> bytes:
    """The frame with a 1-byte dictionary ID in its header (the content
    needs no dictionary; libzstd refuses it all the same)."""
    fhd = frame[4] | 1
    return frame[:4] + bytes([fhd]) + frame[5:6] + b"\x07" + frame[6:]


@pytest.mark.parametrize("case", list(ZSTD_FRAMES))
def test_zstd_frames_follow_pil(tmp_path, cxx, case):
    """Strips of frames `zstandard` makes, wrapped in a TIFF and read by PIL
    too: every level, the content checksum, no content size, a streamed
    frame, and what libtiff's ZSTDDecode makes of more than one frame (the
    first ends the strip), skippable frames, bytes after the frame, frames
    longer, shorter or cut, a dictionary ID. Strips of 16 rows and one
    strip past 128 KiB (blocks of 128 KiB, a window past it), smooth
    pictures, noise (raw blocks) and a flat one (RLE blocks)."""
    big = smooth(128, 128, 3, 40)
    pictures = {"smooth": smooth(45, 67, 3, 41), "noise": samples((45, 67, 3), 8, 42).astype(np.uint8),
                "flat": np.full((45, 67, 3), 77, np.uint8), "big": np.concatenate([big, big[::-1]], 1)}
    for name, px in pictures.items():
        for rows in ((None,) if name == "big" else (16, None)):
            data = tiff_bytes(px, 8, 2, compression=50000, rows_per_strip=rows,
                              encode=lambda c: ZSTD_FRAMES[case](sample_bytes_of(c, 8)))
            got = assert_follows_pil(tmp_path, data, f"{case} {name} {rows}", ".tif")
            if got is not None:
                np.testing.assert_array_equal(got.pixels, px)


LZMA_STREAMS = {
    "preset 0": lambda b: lzma.compress(b, lzma.FORMAT_XZ, preset=0),
    "preset 9 extreme": lambda b: lzma.compress(b, lzma.FORMAT_XZ, preset=9 | lzma.PRESET_EXTREME),
    "CRC32": lambda b: lzma.compress(b, lzma.FORMAT_XZ, lzma.CHECK_CRC32),
    "SHA-256": lambda b: lzma.compress(b, lzma.FORMAT_XZ, lzma.CHECK_SHA256),
    "no check": lambda b: lzma.compress(b, lzma.FORMAT_XZ, lzma.CHECK_NONE),
    "two streams": lambda b: lzma.compress(b[:len(b) // 2], lzma.FORMAT_XZ) + lzma.compress(b[len(b) // 2:],
                                                                                            lzma.FORMAT_XZ),
    "a stream longer than its strip": lambda b: lzma.compress(b + bytes(100), lzma.FORMAT_XZ),
    "a stream shorter than its strip": lambda b: lzma.compress(b[:-3], lzma.FORMAT_XZ),
    "a stream cut short": lambda b: lzma.compress(b, lzma.FORMAT_XZ)[:-40],
    "a stream cut in its index": lambda b: lzma.compress(b, lzma.FORMAT_XZ)[:-13],
    "a bad check": lambda b: _bad_check(lzma.compress(b, lzma.FORMAT_XZ, lzma.CHECK_CRC64)),
    "lzma alone (not .xz)": lambda b: lzma.compress(b, lzma.FORMAT_ALONE),
}


def _bad_check(stream: bytes) -> bytes:
    """An .xz stream whose block check is wrong (the last byte of its first
    block's CRC64, just before the index)."""
    index = stream.rindex(b"\x00", 0, len(stream) - 12 - 4)
    b = bytearray(stream)
    b[index - 1] ^= 0x5A
    return bytes(b)


@pytest.mark.parametrize("case", list(LZMA_STREAMS))
def test_lzma_streams_follow_pil(tmp_path, cxx, case):
    """Strips of .xz streams the standard library makes: presets, every
    check, a second stream (libtiff's decoder takes one), streams longer,
    shorter or cut, a wrong check, the old .lzma form: PIL is the rule."""
    for px in (smooth(45, 67, 3, 50), samples((45, 67, 3), 8, 51).astype(np.uint8)):
        for rows in (16, None):
            data = tiff_bytes(px, 8, 2, compression=34925, rows_per_strip=rows,
                              encode=lambda c: LZMA_STREAMS[case](sample_bytes_of(c, 8)))
            got = assert_follows_pil(tmp_path, data, f"{case} {rows}", ".tif")
            if got is not None:
                np.testing.assert_array_equal(got.pixels, px)


# ---- damaged data ----

def _damaged(name):
    """The file of each form whose strips take the seeded byte flips (a
    picture in steps of 8, so that every coder's tables and matches are
    in play)."""
    a = smooth(64, 96, 3, 60) // 8 * 8
    grey = np.ascontiguousarray(a[..., 1])
    return {
        "ZSTD (PIL, predictor)": lambda: pil_tiff(a, "zstd", 2, strip_size=96 * 3 * 16),
        "ZSTD (PIL, grey)": lambda: pil_tiff(grey, "zstd"),
        "ZSTD level 19 + checksum": lambda: tiff_bytes(a, 8, 2, compression=50000, rows_per_strip=32,
                                                       encode=zstd_coder(level=19, write_checksum=True)),
        "ZSTD level 1, no content size": lambda: tiff_bytes(a, 8, 2, compression=50000, rows_per_strip=32,
                                                            encode=zstd_coder(level=1, write_content_size=False)),
        "LZMA (PIL, predictor)": lambda: pil_tiff(a, "lzma", 2, strip_size=96 * 3 * 16),
        "LZMA (PIL, grey)": lambda: pil_tiff(grey, "lzma"),
        "YCbCr JPEG 4:2:0": lambda: ycbcr_tiff(a, (2, 2), rows_per_strip=16),
        "YCbCr JPEG 4:2:2 tiles": lambda: ycbcr_tiff(a, (2, 1), tile=(32, 32)),
    }[name]()


DAMAGED = ["ZSTD (PIL, predictor)", "ZSTD (PIL, grey)", "ZSTD level 19 + checksum", "ZSTD level 1, no content size",
           "LZMA (PIL, predictor)", "LZMA (PIL, grey)", "YCbCr JPEG 4:2:0", "YCbCr JPEG 4:2:2 tiles"]


@pytest.mark.parametrize("name", DAMAGED)
def test_flipped_bytes_follow_pil(tmp_path, cxx, name):
    """Seeded byte flips in the coded strips (one flip a file, 48 files a
    form; each seed picks the strip, the byte and the bits): the port reads
    PIL's pixels, or raises where PIL raises; a JPEG frame made smaller
    than its strip, which PIL reads with rows it leaves uninitialised, the
    port refuses (ROADMAP.md section 3)."""
    data = _damaged(name)
    tags = Image.open(io.BytesIO(data)).tag_v2
    offsets, counts = (tags[324], tags[325]) if 324 in tags else (tags[273], tags[279])
    outcomes = {"read": 0, "raised": 0}
    for seed in range(48):
        rng = np.random.default_rng(seed)
        i = int(rng.integers(0, len(counts)))
        at = offsets[i] + int(rng.integers(0, counts[i]))
        b = bytearray(data)
        b[at] ^= int(rng.integers(1, 256))
        label = f"{name} seed {seed} byte {at}"
        try:
            got = assert_follows_pil(tmp_path, bytes(b), label, ".tif")
        except ValueError as err:  # the one refusal where PIL reads: its rows left uninitialised
            assert "smaller than the TIFF's" in str(err), label
            got = None
        outcomes["read" if got is not None else "raised"] += 1
    assert outcomes["raised"] > 0


# ---- the compiled decoder, fixtures, dataset paths ----

def test_failed_zstd_build_raises_naming_the_file(tmp_path, fake_cxx):
    """No fallback: a ZSTD TIFF cannot be read without the compiled
    decoder, and the error names the file."""
    data = tiff_bytes(smooth(9, 11, 3, 70), 8, 2, compression=50000, encode=zstd_coder())
    fake_cxx(fail=True)
    path = tmp_path / "a.tif"
    path.write_bytes(data)
    with pytest.raises(RuntimeError, match=r"(?s)a\.tif: .*Zstandard decoder .*zstd_decode\.cc.* could not be built"):
        image_io.open_image(path)
    assert not cuda_build.host_library_path("zstd_decode").exists()


def test_port_imports_no_zstandard():
    """The port's package names neither zstandard nor PIL (tests only)."""
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "gaussian_splatting_torch")
    for folder, _, names in os.walk(root):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(folder, n)) as f:
                    text = f.read()
                assert "import zstandard" not in text and "from PIL" not in text and "import PIL" not in text, n


def _readings():
    with open(os.path.join(FIXTURES, "sha256.json")) as f:
        return json.load(f)


def _digest(pixels) -> str:
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(k for k in _readings() if k.endswith(".tif")))
def test_1080p_fixtures_give_pils_hash(cxx, name):
    """The 1920x1080 ZSTD and LZMA TIFFs PIL wrote: PIL's pixels and the
    port's have the mode, shape and SHA-256 committed in sha256.json, which
    chip_smoke.py holds the port to on the card's machine."""
    want = _readings()[name]
    path = os.path.join(FIXTURES, name)
    assert os.path.getsize(path) < 400_000
    pil = Image.open(path)
    got = image_io.open_image(path)
    for mode, px in ((pil.mode, np.asarray(pil)), (got.mode, got.pixels)):
        px = px[..., None] if px.ndim == 2 else px
        assert (mode, list(px.shape), _digest(px)) == (want["mode"], want["shape"], want["sha256"])


@functools.cache
def _form_files():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import form_files

    return form_files()


@pytest.mark.parametrize("name", sorted(k for k in _readings() if not k.endswith(".tif")))
def test_chip_smoke_forms_give_pils_hash(tmp_path, cxx, name):
    """The 1080p files chip_smoke.py writes on the card (its own JPEG
    encoder and TIFF writer, from its integer-made picture): the file's
    SHA-256 where it is deterministic, and PIL's mode, shape and pixels'
    SHA-256, which the port must give on the card, committed; the port
    gives them here."""
    want = _readings()[name]
    data = _form_files()[name]
    if "file_sha256" in want:
        assert hashlib.sha256(data).hexdigest() == want["file_sha256"]
    path = tmp_path / "form.tif"
    path.write_bytes(data)
    pil = np.asarray(Image.open(path))
    got = image_io.open_image(path)
    for mode, px in ((Image.open(path).mode, pil), (got.mode, got.pixels)):
        assert (mode, list(px.shape), _digest(px)) == (want["mode"], want["shape"], want["sha256"])


def forms_views(w, h):
    """One view in each new form whose pixels are the picture (RGB)."""
    a = smooth(h, w, 3, 80)
    return {
        "v_ycbcr.tif": ycbcr_tiff(a, (2, 2), rows_per_strip=8),
        "v_planar_lzma_big.tif": tiff_bytes(a, 8, 2, planar=True, big=True, compression=34925, rows_per_strip=8),
        "v_zstd.tif": pil_tiff(a, "zstd", 2),
        "v_planar_16.tif": tiff_bytes((a.astype(np.int64) << 8) | 99, 16, 2, planar=True, compression=8,
                                      predictor=2, tile=(16, 16)),
    }


@pytest.mark.parametrize("resolution", [1, 2])
def test_colmap_reads_the_new_forms_as_jax(tmp_path, monkeypatch, cxx, resolution):
    """A COLMAP dataset of views in the new forms (YCbCr JPEG-in-TIFF, a
    planar LZMA BigTIFF, ZSTD with Predictor 2, 16-bit planar deflate
    tiles): the Scene's cameras equal the JAX package's, images bit for
    bit."""
    from test_torch_scene import both_scenes

    w, h = 45, 37
    src = str(tmp_path / "forms")
    write_colmap_dataset_of(src, forms_views(w, h), w, h)
    jscene, scene = both_scenes(tmp_path, monkeypatch, src, eval_split=True, resolution=resolution)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == 4
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())


@pytest.mark.parametrize("white_background", [False, True])
def test_blender_reads_the_new_forms_as_jax(tmp_path, monkeypatch, cxx, white_background):
    """read_blender_scene on frames in the new forms, RGBA planar ones
    included (composited on the background): PIL's convert("RGBA"), bit
    for bit, then load_camera at -r 2."""
    from test_torch_tga import blender_scenes

    w, h = 29, 23
    rgba = smooth(h, w, 4, 81)
    frames = list(forms_views(w, h).values()) + [
        tiff_bytes(rgba, 8, 2, extra=[2], planar=True, compression=50000, rows_per_strip=8, encode=zstd_coder()),
        tiff_bytes(rgba, 8, 2, extra=[1], planar=True, compression=5, tile=(16, 16)),
    ]
    blender_scenes(tmp_path, monkeypatch, frames, white_background, jreaders, dataset_readers)
