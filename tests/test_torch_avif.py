"""The port's AVIF reader (`utils/avif.py`, `csrc/av1_decode.cc`) against PIL
12.1.0 (libavif 1.3.0, dav1d 1.5.1), and both dataset paths on AVIF views
against the JAX package.

Every file is written here by the installed PIL (12.1.0: aom 3.12.1) from seeded
numpy pictures, or is a committed fixture of `tests/fixtures/torch_avif`;
PIL's reading of it is the rule: `image_io.open_image` gives PIL's mode and
pixels bit for bit. AV1's in-loop filters after deblocking, CDEF and loop
restoration (Wiener and self-guided), are held to PIL on files aom writes at
speeds 0-4 or with CDEF asked for, and a test hook of the decoder
(`avif.av1_planes(..., tools=...)`) shows that those files together used
each of their cases; so do screen content's palette mode and intra block
copy (IntraBC) on files aom writes with `tune-content=screen` or from flat
colours; and film grain synthesis on files aom writes with its 16 grain test
vectors (`film-grain-test`), with grain estimated from the picture
(`denoise-noise-level`) or with the parameters of a grain table this module
writes (`film-grain-table`). Image sequences (`avis`, written by PIL's
`save_all`) read as PIL's frame 0, and libavif's choice between their tracks
and the primary item is held to PIL on files whose brands and boxes are
edited (stated beside each case). Superres, which this port does not decode
yet, is refused by name on a PIL-written file whose header bits are edited;
the same file with its high_bitdepth bit set reads as PIL reads it (10- and
12-bit files in full: `test_torch_avif_hbd.py`). Grid images are held to PIL
in `test_torch_avif_grid.py`.
"""

import hashlib
import io
import json
import os
import shutil
import struct

import numpy as np
import pytest
from PIL import Image, features

from gaussian_splatting_tpu.scene import dataset_readers as jreaders
from gaussian_splatting_torch.scene import dataset_readers
from gaussian_splatting_torch.utils import avif, cuda_build, image_io
from test_torch_image_forms import cxx, write_colmap_dataset_of  # noqa: F401  (cxx: a fixture)
from test_torch_jpeg import fake_cxx  # noqa: F401  (a fixture)
from test_torch_scene import assert_same_cameras, orbit_frames

# PIL writes every file of these tests but the committed fixtures, which are
# held to sha256.json where PIL has no AVIF
requires_avif = pytest.mark.skipif(not features.check("avif"), reason="this PIL has no AVIF support")

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_avif")
SIZES = [(1, 1), (7, 5), (65, 33), (130, 67), (256, 200)]  # (width, height)


def picture(h, w, seed, kind="scene", channels=3):
    """Seeded pictures that reach aom's intra tools: "noise"; "gradient";
    "edges" (stripes at three angles: the directional modes and CfL);
    "scene" (smooth shading, edges, a flat patch, a little noise); "grainy"
    (the scene under a film-like grain, for aom's grain estimation); and the
    screen content of `SCREEN_PICTURES` (RGB)."""
    if kind in SCREEN_PICTURES:
        return SCREEN_PICTURES[kind](h, w, seed)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, channels), np.uint8)
    if kind == "gradient":
        a = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1), (xx + yy) * 127 / max(w + h - 2, 1),
                      255 - xx * 200 / max(w - 1, 1)][:channels], -1)
        return a.astype(np.uint8)
    out = []
    for c in range(channels):
        ang = 0.3 + 0.8 * c + rng.uniform(0, 0.2)
        stripes = ((np.cos(ang) * xx + np.sin(ang) * yy) / (3 + 2 * c) % 2 < 1)
        if kind == "edges":
            out.append(np.where(stripes, 40 + 50 * c, 210 - 40 * c))
        else:
            out.append(120 + 70 * np.sin(xx / (9 + 3 * c) + yy / (13 + c)) + 30 * stripes)
    a = np.stack(out, -1).astype(np.float64)
    if kind in ("scene", "grainy"):
        a += rng.normal(0, 4, a.shape)
        a[h // 3:h // 2, w // 5:w // 3] = 90
    if kind == "grainy":
        a += rng.normal(0, 7, a.shape)
    return np.clip(a, 0, 255).astype(np.uint8)


def with_alpha(px, seed):
    h, w = px.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    a = 255 * np.abs(np.sin(xx / (w / 3 + 1) + yy / (h / 2 + 1) + seed))
    a[: h // 4] = 255
    a[h - h // 4:, : w // 4] = 0
    return np.concatenate([px, a.astype(np.uint8)[..., None]], -1)


def pil_avif(px, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "AVIF", **options)
    return buf.getvalue()


def assert_reads_as_pil(tmp_path, data: bytes, label=""):
    """open_image of `data` as a file: PIL's mode, shape and pixels."""
    path = tmp_path / "view.avif"
    path.write_bytes(data)
    im = Image.open(path)
    want = np.asarray(im)
    got = image_io.open_image(path)
    assert got.mode == im.mode, (label, got.mode, im.mode)
    assert got.pixels.shape == want.shape and got.pixels.dtype == want.dtype, (label, got.pixels.shape, want.shape)
    np.testing.assert_array_equal(got.pixels, want, err_msg=label)
    return got


def assert_refused(tmp_path, data: bytes, match: str):
    path = tmp_path / "refused.avif"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match) as err:
        image_io.open_image(path)
    assert str(path) in str(err.value)


# ---- the matrix: quality x speed x subsampling, every size and picture kind ----

KINDS = ("noise", "gradient", "edges", "scene")


@requires_avif
@pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2", "4:4:4", "4:0:0"])
@pytest.mark.parametrize("speed", [5, 6, 10])
@pytest.mark.parametrize("quality", [0, 30, 50, 75, 90, 100])
def test_pil_written_files_read_bit_equal(tmp_path, cxx, quality, speed, subsampling):
    """Each PIL-written file reads as PIL reads it: two of the sizes (the
    largest at speed 5 only at quality 50, where aom is slowest), each
    with its own picture kind."""
    k = (quality // 10 + speed + len(subsampling)) % len(SIZES)
    for i, (w, h) in enumerate((SIZES[k], SIZES[(k + 2) % len(SIZES)])):
        if (w, h) == SIZES[-1] and speed == 5 and quality != 50:
            w, h = SIZES[2]
        kind = KINDS[(k + i + quality) % len(KINDS)]
        data = pil_avif(picture(h, w, quality + speed + i, kind), quality=quality, speed=speed,
                        subsampling=subsampling)
        assert_reads_as_pil(tmp_path, data, f"{w}x{h} {kind}")


@requires_avif
@pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2", "4:4:4", "4:0:0"])
@pytest.mark.parametrize("range_", ["full", "limited"])
def test_both_ranges_read_bit_equal(tmp_path, cxx, range_, subsampling):
    """libyuv's limited-range constants (4:2:0, 4:2:2, 4:4:4) and libavif's
    float path for 4:0:0 at both ranges."""
    for i, (w, h) in enumerate(SIZES[1:4]):
        data = pil_avif(picture(h, w, 40 + i, KINDS[i + 1]), quality=55, range=range_, subsampling=subsampling)
        assert_reads_as_pil(tmp_path, data, f"{w}x{h}")


@requires_avif
@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4", "4:0:0"])
@pytest.mark.parametrize("premultiplied", [False, True])
@pytest.mark.parametrize("range_", ["full", "limited"])
def test_rgba_reads_bit_equal(tmp_path, cxx, range_, premultiplied, subsampling):
    """An alpha item (its own 4:0:0 AV1 stream, `auxl`) gives PIL's "RGBA";
    a `prem` reference un-premultiplies as libavif does (libyuv's
    ARGBUnattenuate). 4:0:0 to RGBA goes through libyuv's I400 rows (at
    limited range they differ from the float path at ten Y codes)."""
    for i, (w, h) in enumerate(SIZES[1:4]):
        for q in (30, 100):
            data = pil_avif(with_alpha(picture(h, w, 50 + i), i), quality=q, subsampling=subsampling,
                            alpha_premultiplied=premultiplied, range=range_)
            got = assert_reads_as_pil(tmp_path, data, f"{w}x{h} q{q}")
            assert got.mode == "RGBA"
    assert (avif.parse(data, "x")["premultiplied"]) == premultiplied


def grey_ramp_400(alpha: bool, premultiplied=False) -> bytes:
    """PIL's lossless full-range 4:0:0 file of every Y code (a 16x16 ramp),
    RGBA with alpha below 255 on odd rows where `alpha`."""
    y = np.arange(256, dtype=np.uint8).reshape(16, 16)
    px = np.repeat(y[..., None], 3, -1)
    if alpha:
        a = np.full((16, 16, 1), 255, np.uint8)
        a[1::2] = 200
        px = np.concatenate([px, a], -1)
    return pil_avif(px, quality=100, subsampling="4:0:0", range="full", alpha_premultiplied=premultiplied,
                    advanced={"enable-palette": "0", "enable-intrabc": "0"})


def with_nclx(data: bytes, mc: int, full: bool) -> bytes:
    """`data` with its `colr` nclx box's matrix_coefficients and range set
    (libavif converts by the container's colour description)."""
    at = data.index(b"nclx") + 4  # colour_primaries, transfer, matrix (2 bytes each), range bit
    out = bytearray(data)
    out[at + 4:at + 6] = mc.to_bytes(2, "big")
    out[at + 6] = 0x80 if full else 0
    return bytes(out)


@requires_avif
@pytest.mark.parametrize("premultiplied", [False, True])
@pytest.mark.parametrize("matrix", [pytest.param(6, id="BT.601"), pytest.param(1, id="BT.709"),
                                    pytest.param(9, id="BT.2020"), pytest.param(0, id="identity")])
def test_400_rgba_at_limited_range_reads_by_libyuvs_rows(tmp_path, cxx, matrix, premultiplied):
    """Every Y code of a 4:0:0 RGBA file at limited range (the nclx box
    edited: matrix and range): libavif converts it by libyuv's
    I400ToARGBMatrix with the matrix's constants (identity with BT.601's),
    ((y * 0x0101 * yg) >> 16) + ygb, >> 6, clamped. BT.2020's constants
    give the float path's bytes at every code."""
    data = with_nclx(grey_ramp_400(True, premultiplied), matrix, False)
    got = assert_reads_as_pil(tmp_path, data, f"matrix {matrix}")
    assert got.mode == "RGBA"


@requires_avif
@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("full", [False, True])
def test_400_files_of_every_matrix_read_or_fail_as_pil(tmp_path, cxx, full, alpha):
    """matrix_coefficients 0-20 on a 4:0:0 file, RGB and RGBA: where PIL
    reads it the port reads it bit-equal; where libavif cannot convert it
    (3, 10, 11, 13, 14, above 15, YCgCo at limited range) PIL raises and
    the port raises a ValueError naming the matrix and the file."""
    base = grey_ramp_400(alpha)
    for mc in range(21):
        data = with_nclx(base, mc, full)
        try:
            np.asarray(Image.open(io.BytesIO(data)))
        except RuntimeError:  # PIL: "Conversion from YUV failed: Reformat failed"
            assert_refused(tmp_path, data, f"matrix_coefficients {mc}")
            continue
        assert_reads_as_pil(tmp_path, data, f"matrix {mc}")


@requires_avif
def test_limited_range_alpha_is_widened_as_libavif_widens_it(tmp_path, cxx):
    """PIL writes full-range alpha; a file whose alpha stream's sequence
    header is edited to limited range (its color_range bit, after
    mono_chrome and color_description_present_flag) reads as PIL reads
    it: libavif widens the alpha, (a - 16) * 255 / 219 rounded."""
    data = pil_avif(with_alpha(picture(64, 128, 55, "gradient"), 2), quality=90)
    alpha = avif.parse(data, "x")["alpha"]
    seq = frame_obu_at(alpha)[1]
    pos = reduced_header_bits(alpha, seq) + 5  # enable_superres, cdef, restoration, high_bitdepth, mono_chrome
    assert (alpha[seq + pos // 8] >> (7 - pos % 8)) & 1 == 0  # no colour description
    pos += 1
    assert (alpha[seq + pos // 8] >> (7 - pos % 8)) & 1 == 1  # full range
    edited_alpha = set_bit(alpha, seq + pos // 8, pos % 8, 0)
    at = data.index(alpha)
    got = assert_reads_as_pil(tmp_path, data[:at] + edited_alpha + data[at + len(alpha):])
    assert got.mode == "RGBA"


@requires_avif
@pytest.mark.parametrize("tiles", [(0, 0, True), (0, 1, False), (1, 0, False), (1, 1, False), (0, 0, False)])
def test_tiles_read_bit_equal(tmp_path, cxx, tiles):
    """tile_rows / tile_cols (log2) 0-1 and autotiling: each tile's symbol
    decoder, CDFs and contexts start afresh."""
    rows, cols, auto = tiles
    data = pil_avif(picture(200, 256, 60 + rows + 2 * cols), quality=60, tile_rows=rows, tile_cols=cols,
                    autotiling=auto)
    assert_reads_as_pil(tmp_path, data, str(tiles))


@requires_avif
def test_exif_orientation_keeps_the_stored_pixels(tmp_path, cxx):
    """PIL keeps an EXIF orientation of 6 in `info` and turns no pixel:
    np.asarray is the picture as stored, and so is the port's."""
    px = picture(33, 65, 70)
    exif = Image.Exif()
    exif[0x0112] = 6
    data = pil_avif(px, quality=80, exif=exif)
    got = assert_reads_as_pil(tmp_path, data)
    assert got.pixels.shape == (33, 65, 3)


@requires_avif
@pytest.mark.parametrize("advanced", [{"deltaq-mode": "3"}, {"deltaq-mode": "1", "delta-lf-mode": "1"},
                                      {"sharpness": "7"}, {"aq-mode": "1"}, {"reduced-tx-type-set": "1"},
                                      {"enable-qm": "1"}, {"enable-qm": "1", "qm-min": "0", "qm-max": "15"},
                                      {"tune-content": "screen", "enable-palette": "0"}])
def test_encoder_options_that_use_decoded_tools_read_bit_equal(tmp_path, cxx, advanced):
    """aom options that change what the frame uses but no refused tool:
    delta q and delta lf, loop filter sharpness, segmentation by aq-mode,
    the reduced transform set, quantizer matrices, screen-content tools (a
    frame that allows IntraBC)."""
    data = pil_avif(picture(130, 160, 81), quality=45, advanced=advanced)
    assert_reads_as_pil(tmp_path, data, str(advanced))


# ---- CDEF and loop restoration (Wiener, self-guided) ----

CDEF_ON = {"enable-cdef": "1"}  # aom 3.12.1 leaves CDEF off for still pictures unless asked
QUALITIES = (20, 50, 85)
SUBSAMPLINGS = ("4:2:0", "4:2:2", "4:4:4", "4:0:0")
# the sizes each speed writes; speed 0 only small ones, where aom is slowest
SPEED_SIZES = {0: [(1, 1), (7, 5), (65, 33), (130, 67)], 1: [(7, 5), (65, 33), (130, 67), (160, 130)],
               2: [(65, 33), (130, 67), (160, 130), (7, 5)], 3: [(130, 67), (257, 131), (256, 200)],
               4: [(257, 131), (256, 200), (130, 67)]}
_WRITTEN = {}


def written(size, kind, seed, alpha=False, **options):
    """(PIL's file of a seeded picture, the tools each of its AV1 items used
    by the decoder's test hook with the item's subsampling). Cached: the
    coverage test reads the files the other tests wrote."""
    key = repr((size, kind, seed, alpha, sorted(options.items())))
    if key not in _WRITTEN:
        w, h = size
        px = picture(h, w, seed, kind)
        data = pil_avif(with_alpha(px, seed) if alpha else px, **options)
        items = avif.parse(data, "x")
        used = []
        for item in ("color", "alpha"):
            if items[item] is not None:
                tools = {}
                seq = avif.av1_planes(items[item], "x", tools=tools)[3]
                used.append({**tools, "item": item, "ss": (seq["mono"], seq["ss_x"], seq["ss_y"])})
        _WRITTEN[key] = data, used
    return _WRITTEN[key]


def matrix_files(quality, subsampling, cdef):
    """The matrix's two files for one quality, subsampling and CDEF setting:
    the speeds (0-4), sizes and picture kinds turn with the case, so that
    the 24 cases together write each speed at each of its sizes."""
    g = QUALITIES.index(quality) * 8 + SUBSAMPLINGS.index(subsampling) * 2 + int(cdef)
    files = []
    for i, speed in enumerate((g % 5, (g + 2) % 5)):
        sizes = SPEED_SIZES[speed]
        options = dict(quality=quality, speed=speed, subsampling=subsampling)
        if cdef:
            options["advanced"] = CDEF_ON
        files.append(dict(size=sizes[(g // 5 + i) % len(sizes)], kind=KINDS[(g + i) % len(KINDS)], seed=g + 7 * i,
                          **options))
    return files


MATRIX = [(q, sub, cdef) for q in QUALITIES for sub in SUBSAMPLINGS for cdef in (False, True)]


@requires_avif
@pytest.mark.parametrize("quality, subsampling, cdef", MATRIX)
def test_files_with_cdef_and_loop_restoration_read_bit_equal(tmp_path, cxx, quality, subsampling, cdef):
    """Files aom writes at speeds 0-4 (loop restoration) and with CDEF on
    read as PIL reads them; sizes that are not multiples of 8 or 64 read
    CDEF's decoded padding past the picture's edge."""
    for f in matrix_files(quality, subsampling, cdef):
        assert_reads_as_pil(tmp_path, written(**f)[0], str(f))


# files of one tool or setting each: name -> `written` arguments
SPECIAL_FILES = {
    "sb-size 128": dict(size=(130, 67), kind="scene", seed=120, quality=50, speed=2,
                        advanced={**CDEF_ON, "sb-size": "128"}),
    "sb-size 64": dict(size=(130, 67), kind="scene", seed=120, quality=50, speed=2,
                       advanced={**CDEF_ON, "sb-size": "64"}),
    "2x2 tiles": dict(size=(384, 384), kind="scene", seed=121, quality=60, speed=4, tile_rows=1, tile_cols=1,
                      advanced=CDEF_ON),
    "RGBA": dict(size=(130, 67), kind="scene", seed=122, alpha=True, quality=50, speed=3, advanced=CDEF_ON),
    "RGBA premultiplied": dict(size=(130, 67), kind="scene", seed=123, alpha=True, quality=50, speed=2,
                               alpha_premultiplied=True, advanced=CDEF_ON),
    "limited range": dict(size=(160, 130), kind="scene", seed=124, quality=40, speed=4, range="limited",
                          advanced=CDEF_ON),
    "full range": dict(size=(160, 130), kind="edges", seed=125, quality=40, speed=4, range="full",
                       advanced=CDEF_ON),
    "switchable": dict(size=(257, 131), kind="gradient", seed=1, quality=85, speed=2),
}


@requires_avif
@pytest.mark.parametrize("name", list(SPECIAL_FILES))
def test_filter_settings_read_bit_equal(tmp_path, cxx, name):
    """aom's superblock size option (libavif passes it on: use_128 follows
    it), 2x2 tiles (the restoration references start afresh in each
    tile), RGBA (the alpha item is a 4:0:0 AV1 that uses the tools too),
    both ranges, a frame of RESTORE_SWITCHABLE: each reads as PIL reads it."""
    data, used = written(**SPECIAL_FILES[name])
    got = assert_reads_as_pil(tmp_path, data, name)
    color = used[0]
    assert max(color["cdef_bits"], color["lr_unit_shift"]) >= 0, color  # the file uses CDEF or restoration
    if name.startswith("sb-size"):
        assert color["use_128"] == (name == "sb-size 128") and color["lr_unit_shift"] >= 0
    if name == "2x2 tiles":
        assert sum(sum(k.values()) for k in color["lr_units"]) > 3  # units in more than one tile
    if name.startswith("RGBA"):
        assert got.mode == "RGBA" and used[1]["item"] == "alpha" and used[1]["cdef_bits"] >= 0
    if name == "switchable":
        assert "switchable" in color["lr_types"]


@requires_avif
@pytest.mark.parametrize("speed", [0, 2, 4])
def test_lossless_files_skip_cdef_and_restoration(tmp_path, cxx, speed):
    """Quality 100 is lossless (CodedLossless and AllLossless): neither
    filter runs, CDEF asked for or not."""
    data, used = written((65, 33) if speed == 0 else (130, 67), "scene", 126 + speed, quality=100, speed=speed,
                         advanced=CDEF_ON)
    assert_reads_as_pil(tmp_path, data)
    assert (used[0]["cdef_bits"], used[0]["lr_unit_shift"]) == (-1, -1)


def flip_to_lr_uv_shift(av1: bytes):
    """The AV1 item with the one frame-header bit flipped that turns
    lr_uv_shift from 0 to 1 and changes no other header field the hook
    shows: the first such bit, found by decoding each flip."""
    frame = frame_obu_at(av1)[0]
    base = {}
    avif.av1_planes(av1, "x", tools=base)
    assert base["lr_uv_shift"] == 0 and base["lr_types"][1:] != ["none", "none"]
    for pos in range(8 * 16):
        byte, bit = frame + pos // 8, pos % 8
        new = set_bit(av1, byte, bit, 1 - ((av1[byte] >> (7 - bit)) & 1))
        tools = {}
        try:
            avif.av1_planes(new, "x", tools=tools)
        except ValueError:
            continue
        if tools["lr_uv_shift"] == 1 and all(tools[k] == base[k] for k in ("lr_types", "lr_unit_shift", "use_128")):
            return new, base, tools
    raise AssertionError("no header bit turns lr_uv_shift to 1")


@requires_avif
def test_lr_uv_shift_read_as_pil_reads_it(tmp_path, cxx):
    """aom 3.12.1 writes lr_uv_shift 0 (chroma units as large as luma's): a
    4:2:0 file whose header bit is flipped to 1 (header bits edited) halves
    the chroma units, which then take more of the tile's symbols; PIL (dav1d)
    reads the edited file and the port reads it alike."""
    data = pil_avif(picture(64, 400, 127, "noise"), quality=20, speed=3)
    av1 = avif.parse(data, "x")["color"]
    new, base, tools = flip_to_lr_uv_shift(av1)
    chroma_units = [sum(t["lr_units"][1].values()) + sum(t["lr_units"][2].values()) for t in (base, tools)]
    assert chroma_units[1] > chroma_units[0], chroma_units
    at = data.index(av1)
    assert_reads_as_pil(tmp_path, data[:at] + new + data[at + len(av1):])


@requires_avif
def test_the_files_together_use_each_case_of_cdef_and_restoration():
    """Through the decoder's test hook: the matrix's and the special files
    (written again where the tests above did not run in this process)
    together used CDEF with cdef_bits 0 and above 0; primary-only,
    secondary-only and both strengths on luma and on chroma; CDEF at 4:2:2;
    Wiener on luma (7 taps) and chroma (5 taps); self-guided with both radii
    and with one radius 0; lr_unit_shift 1 and 2; lr_uv_shift read (its value
    1 only by the edited file above); both filters in 128x128 superblocks."""
    used = [t for case in MATRIX for f in matrix_files(*case) for t in written(**f)[1]]
    used += [t for f in SPECIAL_FILES.values() for t in written(**f)[1]]
    seen = set()
    for t in used:
        if t["cdef_bits"] >= 0 and any(sum(k.values()) for k in t["cdef_blocks"]):
            seen.add(f"cdef_bits {'0' if t['cdef_bits'] == 0 else '>0'}")
            if t["ss"] == (0, 1, 0):
                seen.add("CDEF at 4:2:2")
            if t["use_128"]:
                seen.add("CDEF in 128x128 superblocks")
        for p, kinds in enumerate(t["cdef_blocks"]):
            seen.update(f"CDEF {k} {'luma' if p == 0 else 'chroma'}" for k, n in kinds.items() if n)
        for p, kinds in enumerate(t["lr_units"]):
            seen.update(f"{k} {'luma' if p == 0 else 'chroma'}" for k, n in kinds.items() if n)
            if t["use_128"] and any(kinds.values()):
                seen.add("restoration in 128x128 superblocks")
        if t["lr_unit_shift"] >= 0:
            seen.add(f"lr_unit_shift {t['lr_unit_shift']}")
            if t["ss"] == (0, 1, 1) and t["lr_types"][1:] != ["none", "none"]:
                seen.add("lr_uv_shift read")
    want = {"cdef_bits 0", "cdef_bits >0", "CDEF at 4:2:2", "CDEF in 128x128 superblocks",
            "restoration in 128x128 superblocks", "wiener luma", "wiener chroma", "sgrproj_both luma",
            "sgrproj_one luma", "sgrproj_both chroma", "sgrproj_one chroma", "lr_unit_shift 1", "lr_unit_shift 2",
            "lr_uv_shift read"}
    want |= {f"CDEF {k} {plane}" for k in avif.CDEF_KINDS for plane in ("luma", "chroma")}
    assert want <= seen, sorted(want - seen)


# ---- screen content: palette mode and intra block copy (IntraBC) ----
# aom uses both with `tune-content=screen`, and at PIL's defaults where it
# detects screen content (flat colours); `enable-palette=0` leaves IntraBC
# alone.

SCREEN = {"tune-content": "screen"}
INTRABC_ONLY = {"tune-content": "screen", "enable-palette": "0"}


def cells(h, w, seed, colours=6, cell=20):
    """Flat cells of `colours` random colours: aom's palette."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (colours, 3))
    idx = rng.integers(0, colours, ((h + cell - 1) // cell, (w + cell - 1) // cell))
    return rgb[idx].repeat(cell, 0).repeat(cell, 1)[:h, :w].astype(np.uint8)


def bands(h, w, seed, cell=4):
    """Seven vertical bands of 4-px cells, band k of k + 2 colours: every
    palette size 2-8."""
    out = np.zeros((h, w, 3), np.uint8)
    edges = np.linspace(0, w, 8).astype(int)
    for k in range(7):
        out[:, edges[k]:edges[k + 1]] = cells(h, edges[k + 1] - edges[k], seed + k, k + 2, cell)
    return out


def glyphs(h, w, seed):
    """Text-like: six 7x5 glyphs repeated on a flat ground (IntraBC finds
    the copies), a gradient strip and a noisy corner."""
    rng = np.random.default_rng(seed)
    a = np.zeros((h, w, 3), np.uint8) + rng.integers(0, 256, 3).astype(np.uint8)
    shapes = rng.integers(0, 2, (6, 7, 5)).astype(bool)
    ink = rng.integers(0, 256, 3).astype(np.uint8)
    for y in range(2, h - 8, 9):
        for x in range(3, w - 6, 6):
            a[y:y + 7, x:x + 5][shapes[rng.integers(0, 6)]] = ink
    a[h // 2:h // 2 + 10] = np.linspace(0, 255, w)[None, :, None].astype(np.uint8)
    a[:h // 4, :w // 4] = rng.integers(0, 256, (h // 4, w // 4, 3))
    return a


def shaded_tiles(h, w, seed):
    """A 48x32 tile of glyphs repeated under a horizontal ramp and a little
    noise: IntraBC copies that leave a residual (var-tx trees, the inter
    transform sets)."""
    rng = np.random.default_rng(seed)
    tile = glyphs(32, 48, seed).astype(np.int16)
    a = np.tile(tile, ((h + 31) // 32, (w + 47) // 48, 1))[:h, :w] + (np.arange(w)[None, :, None] // 12)
    return np.clip(a + rng.normal(0, 2, a.shape), 0, 255).astype(np.uint8)


def shaded_squares(h, w, seed):
    """A 64x64 tile of glyphs repeated under ramps both ways and a little
    noise: at speed 0 aom splits an IntraBC block's transforms to var-tx
    depth 2."""
    rng = np.random.default_rng(seed)
    tile = glyphs(64, 64, seed).astype(np.int16)
    a = np.tile(tile, ((h + 63) // 64, (w + 63) // 64, 1))[:h, :w]
    a = a + np.arange(w)[None, :, None] // 8 + np.arange(h)[:, None, None] // 10
    return np.clip(a + rng.normal(0, 2, a.shape), 0, 255).astype(np.uint8)


SCREEN_PICTURES = {"cells": cells, "bands": bands, "glyphs": glyphs, "shaded_tiles": shaded_tiles,
                   "shaded_squares": shaded_squares}


# name -> `written` arguments; sizes that are not multiples of 8 but the
# tiled and 128x128-superblock ones
SCREEN_FILES = {}
for i, sub in enumerate(SUBSAMPLINGS):
    SCREEN_FILES[f"cells at PIL's defaults {sub}"] = dict(size=(203, 131), kind="cells", seed=10 + i,
                                                          subsampling=sub)
    SCREEN_FILES[f"bands, screen, speed 2 {sub}"] = dict(size=(226, 131), kind="bands", seed=20 + i, quality=60,
                                                        speed=2, subsampling=sub, advanced=SCREEN)
    SCREEN_FILES[f"IntraBC alone, speed 2 {sub}"] = dict(size=(193, 129), kind="shaded_tiles", seed=30, quality=60,
                                                        speed=2, subsampling=sub, advanced=INTRABC_ONLY)
SCREEN_FILES.update({
    "IntraBC alone, speed 6": dict(size=(193, 129), kind="shaded_tiles", seed=40, quality=60, speed=6,
                                   advanced=INTRABC_ONLY),
    "IntraBC alone, speed 0": dict(size=(256, 200), kind="shaded_squares", seed=0, quality=85, speed=0,
                                   advanced=INTRABC_ONLY),
    "IntraBC alone, reduced tx set": dict(size=(193, 129), kind="shaded_tiles", seed=41, quality=60, speed=4,
                                          advanced={**INTRABC_ONLY, "reduced-tx-type-set": "1"}),
    "glyphs, speed 10": dict(size=(226, 131), kind="glyphs", seed=42, quality=60, speed=10, advanced=SCREEN),
    "sb-size 128": dict(size=(256, 200), kind="glyphs", seed=43, quality=50, advanced={**SCREEN, "sb-size": "128"}),
    "sb-size 64": dict(size=(256, 200), kind="glyphs", seed=43, quality=50, advanced={**SCREEN, "sb-size": "64"}),
    "2x2 tiles": dict(size=(256, 200), kind="glyphs", seed=44, quality=60, tile_rows=1, tile_cols=1,
                      advanced=SCREEN),
    # IntraBC's source must lie in its own tile, four 64x64 superblocks back
    # in the tile's raster order: 2x2 tiles of 128x100 leave it none
    "2x1 tiles": dict(size=(256, 200), kind="glyphs", seed=44, quality=60, tile_rows=1, advanced=SCREEN),
    "lossless": dict(size=(150, 99), kind="glyphs", seed=45, quality=100, advanced=SCREEN),
    "limited range": dict(size=(203, 131), kind="cells", seed=46, quality=70, range="limited", advanced=SCREEN),
    "RGBA": dict(size=(203, 131), kind="glyphs", seed=47, alpha=True, quality=70, advanced=SCREEN),
    "RGBA premultiplied": dict(size=(203, 131), kind="glyphs", seed=48, alpha=True, quality=70,
                               alpha_premultiplied=True, advanced=SCREEN),
})


@requires_avif
@pytest.mark.parametrize("name", list(SCREEN_FILES))
def test_screen_content_reads_bit_equal(tmp_path, cxx, name):
    """Each file reads as PIL reads it, and uses palette or IntraBC."""
    data, (used, *_) = written(**SCREEN_FILES[name])
    got = assert_reads_as_pil(tmp_path, data, name)
    assert sum(used["palette_y"].values()) + sum(used["intrabc"].values()) > 0, used
    if name.startswith("IntraBC alone"):
        assert sum(used["palette_y"].values()) == 0 and sum(used["intrabc"].values()) > 0, used
    if name.startswith("sb-size"):
        assert used["use_128"] == (name == "sb-size 128")
    if name.startswith("RGBA"):
        assert got.mode == "RGBA"
    if name == "lossless":
        assert (used["cdef_bits"], used["lr_unit_shift"]) == (-1, -1)


@requires_avif
def test_the_screen_files_together_use_each_case_of_palette_and_intrabc():
    """Through the decoder's test hook, over the files above (written again
    where their tests did not run in this process): Y and UV palettes of
    every size 2-8; colours from the palette cache and delta-coded on Y and
    U; V colours delta-coded and raw; IntraBC with its DV predicted from
    the stack and by the default DV, in 64x64 and 128x128 superblocks and
    in tiles; chroma at a half sample and of blocks below 8x8 at 4:2:0 and
    4:2:2; var-tx trees split once and twice (MAX_VARTX_DEPTH); the inter
    transform sets 1-3 (aom writes each)."""
    seen = set()
    for name, f in SCREEN_FILES.items():
        t = written(**f)[1][0]
        seen.update(f"Y palette of {n}" for n, k in t["palette_y"].items() if k)
        seen.update(f"UV palette of {n}" for n, k in t["palette_uv"].items() if k)
        seen.update(f"{plane} colours from the cache" for plane, k in zip("YU", t["palette_cache"]) if k)
        seen.update(f"{plane} colours delta-coded" for plane, k in zip("YU", t["palette_delta"]) if k)
        seen.update(f"V colours {how}" for how, k in t["palette_v"].items() if k)
        seen.update(f"IntraBC DV from the {how}" for how, k in t["intrabc"].items() if k)
        if sum(t["intrabc"].values()):
            seen.add(f"IntraBC in {'128x128' if t['use_128'] else '64x64'} superblocks")
            if "tiles" in name:
                seen.add("IntraBC in tiles")
        for how, k in t["intrabc_chroma"].items():
            if k and t["ss"] in ((0, 1, 1), (0, 1, 0)):
                seen.add(f"IntraBC chroma {how} at {'4:2:0' if t['ss'][2] else '4:2:2'}")
        seen.update(f"var-tx split to depth {d}" for d in (1, 2) if t["vartx_depths"][d])
        seen.update(f"inter tx set {s}" for s in (1, 2, 3) if t["inter_tx_sets"][s])
    want = {f"{p} palette of {n}" for p in ("Y", "UV") for n in range(2, 9)}
    want |= {"Y colours from the cache", "U colours from the cache", "Y colours delta-coded", "U colours delta-coded",
             "V colours delta", "V colours raw", "IntraBC DV from the stack", "IntraBC DV from the default",
             "IntraBC in 64x64 superblocks", "IntraBC in 128x128 superblocks", "IntraBC in tiles",
             "var-tx split to depth 1", "var-tx split to depth 2",
             "inter tx set 1", "inter tx set 2", "inter tx set 3"}
    want |= {f"IntraBC chroma {how} at {sub}" for how in ("fractional", "below_8x8") for sub in ("4:2:0", "4:2:2")}
    assert want <= seen, sorted(want - seen)

# ---- film grain synthesis ----
# aom writes its 16 grain test vectors (`film-grain-test`), grain estimated
# from the picture (`denoise-noise-level`), and the parameters of a grain
# table (`film-grain-table`: a file in its text form, which reaches what
# neither of the others writes: ar_coeff_lag 0 and 1, no luma points with
# chroma points, chroma scaling from luma at 4:4:4, damaged values)

GRAIN_SIZES = [(130, 67), (65, 33), (7, 5), (1, 1), (257, 131), (33, 65), (96, 64)]


@requires_avif
@pytest.mark.parametrize("subsampling", SUBSAMPLINGS)
@pytest.mark.parametrize("vector", range(1, 17))
def test_film_grain_test_vectors_read_bit_equal(tmp_path, cxx, vector, subsampling):
    """Each of aom's test vectors, at both ranges, on two sizes (odd ones and
    ones of several 32x32 noise blocks and stripes) and two picture kinds,
    reads as PIL reads it, with the grain applied."""
    k = vector + SUBSAMPLINGS.index(subsampling)
    for i, range_ in enumerate(("full", "limited")):
        w, h = GRAIN_SIZES[(k + 3 * i) % len(GRAIN_SIZES)]
        data, used = written((w, h), KINDS[(k + i) % len(KINDS)], 200 + k, quality=50, subsampling=subsampling,
                             range=range_, advanced={"film-grain-test": str(vector)})
        assert_reads_as_pil(tmp_path, data, f"{w}x{h} {range_}")
        assert used[0]["film_grain"]["apply_grain"] == 1


@requires_avif
@pytest.mark.parametrize("subsampling", SUBSAMPLINGS)
def test_denoise_noise_level_reads_bit_equal(tmp_path, cxx, subsampling):
    """aom's grain estimated from a textured picture (its denoiser at noise
    levels 10 and 40) reads as PIL reads it. At 4:2:2 aom 3.12.1's denoiser
    gives up ("aom_wiener_denoise_2d doesn't handle different chroma
    subsampling") and writes no grain."""
    for level, size in (("10", (130, 67)), ("40", (257, 131))):
        data, used = written(size, "grainy", 210, quality=60, subsampling=subsampling,
                             advanced={"denoise-noise-level": level})
        assert_reads_as_pil(tmp_path, data, f"level {level}")
        assert used[0]["film_grain"]["apply_grain"] == int(subsampling != "4:2:2")


@requires_avif
@pytest.mark.parametrize("premultiplied", [False, True])
@pytest.mark.parametrize("option, items", [("film-grain-test", (1, 1)), ("color:film-grain-test", (1, 0)),
                                           ("alpha:film-grain-test", (0, 1))])
def test_grain_on_alpha_reads_bit_equal(tmp_path, cxx, option, items, premultiplied):
    """RGBA with grain on the colour and the alpha item, on the colour only
    (libavif's `color:` prefix) and on the alpha only: the alpha's grain is
    synthesised as a 4:0:0 frame's, before the alpha is widened and the
    colour un-premultiplied."""
    for range_ in ("full", "limited"):
        data, used = written((130, 67), "scene", 220, alpha=True, quality=60, range=range_,
                             alpha_premultiplied=premultiplied, advanced={option: "3"})
        got = assert_reads_as_pil(tmp_path, data, range_)
        assert got.mode == "RGBA"
        assert tuple(u["film_grain"]["apply_grain"] for u in used) == items


def grain_table(lag=1, y=((0, 20), (128, 60), (255, 40)), cb=((0, 30), (255, 50)), cr=((0, 40), (200, 30)),
                csfl=0, overlap=1, gss=0, scaling_shift=9, ar_shift=7, seed=1234,
                mults=(128, 192, 256, 128, 192, 256)) -> str:
    """aom's film grain table in its text form (one entry for every
    frame): `p` ar_coeff_lag, ar_coeff_shift, grain_scale_shift,
    scaling_shift, chroma_scaling_from_luma, overlap_flag, the Cb and Cr
    mult / luma mult / offset; the Y, Cb, Cr points; seeded AR
    coefficients (the chroma ones with the luma tap)."""
    n = 2 * lag * (lag + 1)
    rng = np.random.default_rng(lag + seed)
    points = lambda pts: "".join(f" {x} {s}" for x, s in pts)  # noqa: E731
    coeffs = lambda k: "".join(f" {int(c)}" for c in rng.integers(-24, 24, k))  # noqa: E731
    return (f"filmgrn1\nE 0 10000000000000 1 {seed} 1\n"
            f"\tp {lag} {ar_shift} {gss} {scaling_shift} {csfl} {overlap} {' '.join(map(str, mults))}\n"
            f"\tsY {len(y)}{points(y)}\n\tsCb {len(cb)}{points(cb)}\n\tsCr {len(cr)}{points(cr)}\n"
            f"\tcY{coeffs(n)}\n\tcCb{coeffs(n + 1)}\n\tcCr{coeffs(n + 1)}\n")


# name -> (grain_table arguments, save options); each reads as PIL reads it
GRAIN_TABLES = {
    "ar_coeff_lag 0": (dict(lag=0), {}),
    "ar_coeff_lag 1, 4:2:2": (dict(lag=1), dict(subsampling="4:2:2")),
    "ar_coeff_lag 2, 4:4:4": (dict(lag=2, seed=7), dict(subsampling="4:4:4")),
    "ar_coeff_lag 3, no overlap": (dict(lag=3, overlap=0), {}),
    "chroma scaling from luma": (dict(csfl=1), {}),
    "chroma scaling from luma, 4:4:4": (dict(csfl=1, lag=2), dict(subsampling="4:4:4")),
    "no luma points, 4:4:4": (dict(y=()), dict(subsampling="4:4:4")),
    "no luma points, 4:2:2": (dict(y=(), lag=0), dict(subsampling="4:2:2")),
    "Cb points only, 4:4:4": (dict(cr=()), dict(subsampling="4:4:4")),
    "14 luma and 10 chroma points": (dict(y=tuple((18 * i, 10 + 9 * i) for i in range(14)),
                                          cb=tuple((25 * i, 90 - 8 * i) for i in range(10))), {}),
    "one luma point": (dict(y=((100, 80),)), {}),
    "shifts at their least": (dict(gss=0, scaling_shift=8, ar_shift=6, y=((0, 255), (255, 255))), {}),
    "shifts at their most": (dict(gss=3, scaling_shift=11, ar_shift=9), {}),
    "negative mults": (dict(mults=(0, 0, 0, 255, 255, 511)), dict(range="limited")),
    "seed 0, 4:0:0": (dict(seed=0, lag=0), dict(subsampling="4:0:0")),
    "seed 65535, RGBA": (dict(seed=65535), dict(alpha=True)),
}


def grain_table_file(tmp_dir, name):
    """(the file of PIL's reading, its tools) for a GRAIN_TABLES entry: the
    table written to `tmp_dir` and given to aom."""
    table, options = GRAIN_TABLES[name]
    path = os.path.join(tmp_dir, f"grain_{list(GRAIN_TABLES).index(name)}.tbl")
    with open(path, "w") as f:
        f.write(grain_table(**table))
    size = GRAIN_SIZES[list(GRAIN_TABLES).index(name) % len(GRAIN_SIZES)]
    return written(size, "scene", 230, quality=55, **options, advanced={"film-grain-table": path})


@requires_avif
@pytest.mark.parametrize("name", list(GRAIN_TABLES))
def test_film_grain_tables_read_bit_equal(tmp_path, cxx, name):
    """Each grain table's file reads as PIL reads it, with the parameters
    the table gave."""
    data, used = grain_table_file(str(tmp_path), name)
    assert_reads_as_pil(tmp_path, data, name)
    table = GRAIN_TABLES[name][0]
    grain = used[0]["film_grain"]
    assert grain["apply_grain"] == 1
    assert grain["ar_coeff_lag"] == table.get("lag", 1)
    assert grain["num_y_points"] == len(table.get("y", "abc"))


@requires_avif
@pytest.mark.parametrize("case", ["luma points that do not increase", "two luma points of one value",
                                  "Cb points alone at 4:2:0"])
def test_damaged_grain_parameters_fail_as_pil(tmp_path, cxx, case):
    """Parameters dav1d refuses (PIL: Decoding of color planes failed): the
    port raises naming them and the file."""
    table = {"luma points that do not increase": dict(y=((0, 20), (128, 60), (100, 40))),
             "two luma points of one value": dict(y=((0, 20), (128, 60), (128, 40))),
             "Cb points alone at 4:2:0": dict(cr=())}[case]
    path = tmp_path / "grain.tbl"
    path.write_text(grain_table(**table))
    data = pil_avif(picture(67, 130, 240), quality=55, advanced={"film-grain-table": str(path)})
    with pytest.raises(RuntimeError):
        np.asarray(Image.open(io.BytesIO(data)))
    assert_refused(tmp_path, data, "film grain")


@requires_avif
def test_the_grain_files_together_use_each_case_of_film_grain(tmp_path):
    """Through the decoder's test hook, over the files above (written again
    where their tests did not run in this process): ar_coeff_lag 0-3, no
    luma points and some, chroma scaling from luma, chroma points, each of
    overlap_flag and clip_to_restricted_range 0 and 1, grain_scale_shift
    0-3, grain on a 4:0:0 alpha item."""
    used = []
    for vector in range(1, 17):
        for sub in SUBSAMPLINGS:
            k = vector + SUBSAMPLINGS.index(sub)
            for i, range_ in enumerate(("full", "limited")):
                used += written(GRAIN_SIZES[(k + 3 * i) % len(GRAIN_SIZES)], KINDS[(k + i) % len(KINDS)], 200 + k,
                                quality=50, subsampling=sub, range=range_,
                                advanced={"film-grain-test": str(vector)})[1]
    used += [t for name in GRAIN_TABLES for t in grain_table_file(str(tmp_path), name)[1]]
    used += written((130, 67), "scene", 220, alpha=True, quality=60, range="full", alpha_premultiplied=False,
                    advanced={"film-grain-test": "3"})[1]
    seen = set()
    for t in used:
        g = t["film_grain"]
        if not g["apply_grain"]:
            continue
        seen.add(f"ar_coeff_lag {g['ar_coeff_lag']}")
        seen.add("luma points" if g["num_y_points"] else "no luma points")
        if g["chroma_scaling_from_luma"]:
            seen.add("chroma scaling from luma")
        if g["num_cb_points"] and g["num_cr_points"]:
            seen.add("chroma points")
        seen.add(f"overlap_flag {g['overlap_flag']}")
        seen.add(f"clip_to_restricted_range {g['clip_to_restricted_range']}")
        seen.add(f"grain_scale_shift {g['grain_scale_shift']}")
        if t["item"] == "alpha":
            seen.add("grain on alpha")
    want = {f"ar_coeff_lag {k}" for k in range(4)} | {f"grain_scale_shift {k}" for k in range(4)}
    want |= {"luma points", "no luma points", "chroma scaling from luma", "chroma points", "grain on alpha"}
    want |= {f"{k} {v}" for k in ("overlap_flag", "clip_to_restricted_range") for v in (0, 1)}
    assert want <= seen, sorted(want - seen)


# ---- image sequences (avis): frame 0, and libavif's choice of source ----

def pil_sequence(frames, **options) -> bytes:
    """PIL's `save_all` of the frames: an `avis` file (a `moov` with a
    colour track, and an alpha track for RGBA) whose primary item is frame
    0 too."""
    buf = io.BytesIO()
    Image.fromarray(frames[0]).save(buf, "AVIF", save_all=True,
                                    append_images=[Image.fromarray(f) for f in frames[1:]], **options)
    return buf.getvalue()


CONTAINER_BOXES = {b"moov": 0, b"trak": 0, b"mdia": 0, b"minf": 0, b"stbl": 0, b"dinf": 0, b"edts": 0,
                   b"tref": 0, b"stsd": 8, b"av01": 78}  # kind -> bytes before the child boxes


def box_tree(data: bytes, start=0, end=None) -> list:
    """[kind, body, children or None] of each box; the boxes of
    CONTAINER_BOXES split into the bytes before their children and the
    children."""
    out, at, end = [], start, len(data) if end is None else end
    while at < end:
        size, kind = struct.unpack(">I4s", data[at:at + 8])
        body = data[at + 8:at + size]
        if kind in CONTAINER_BOXES:
            k = CONTAINER_BOXES[kind]
            out.append([kind, body[:k], box_tree(body, k)])
        else:
            out.append([kind, body, None])
        at += size
    return out


def box_bytes(nodes) -> bytes:
    return b"".join(box(kind, body + (box_bytes(kids) if kids is not None else b"")) for kind, body, kids in nodes)


def found(nodes, path: str):
    """The first box at a path of kinds from `nodes` ("mdia/minf/stbl")."""
    first, _, rest = path.partition("/")
    node = next(n for n in nodes if n[0] == first.encode())
    return found(node[2], rest) if rest else node


def with_moov(data: bytes, edit) -> bytes:
    """`data` with its `moov` edited by `edit(moov's boxes)` and moved to the
    end of the file, the old one turned into a `free` box of its size (the
    sample offsets into `mdat` stay valid whatever the edit's size)."""
    top = box_tree(data)
    moov = next(n for n in top if n[0] == b"moov")
    out = box_bytes([[b"free", box_bytes(n[2]), None] if n is moov else n for n in top])
    edit(moov[2])
    return out + box_bytes([moov])


def tracks(moov):
    return [n for n in moov if n[0] == b"trak"]


def set_field(node, at: int, fmt: str, value):
    body = bytearray(node[1])
    struct.pack_into(fmt, body, at, value)
    node[1] = bytes(body)


def renamed(node, kind=b"free"):
    node[0] = kind


def stsz_fixed(track, size=None, count=1):
    """stsz's fixed-size form: every sample of `size` bytes (sample 0's
    where None), with stsc's samples per chunk set to `count`."""
    stbl = found(track[2], "mdia/minf/stbl")
    stsz, stsc = found(stbl[2], "stsz"), found(stbl[2], "stsc")
    first = struct.unpack(">I", stsz[1][12:16])[0]
    stsz[1] = stsz[1][:4] + struct.pack(">II", first if size is None else size, count)
    set_field(stsc, 12, ">I", count)


def co64(track):
    stco = found(track[2], "mdia/minf/stbl/stco")
    count = struct.unpack(">I", stco[1][4:8])[0]
    offsets = struct.unpack(f">{count}I", stco[1][8:8 + 4 * count])
    stco[0], stco[1] = b"co64", stco[1][:8] + struct.pack(f">{count}Q", *offsets)


def auxi_urn(track, urn: bytes):
    auxi = found(track[2], "mdia/minf/stbl/stsd/av01/auxi")
    auxi[1] = auxi[1][:4] + urn + b"\0"


def tkhd_size(track, w, h):
    tkhd = found(track[2], "tkhd")
    tkhd[1] = tkhd[1][:-8] + struct.pack(">II", w << 16, h << 16)


def stbl_box(track, kind):
    return found(track[2], f"mdia/minf/stbl/{kind}")


# name -> an edit of a PIL-written RGBA premultiplied 3-frame sequence's
# moov (its colour track first, its alpha track second)
TRACK_EDITS = {
    "unedited": lambda m: None,
    "colour handler vide": lambda m: set_field(found(tracks(m)[0][2], "mdia/hdlr"), 8, "4s", b"vide"),
    "alpha handler pict": lambda m: set_field(found(tracks(m)[1][2], "mdia/hdlr"), 8, "4s", b"pict"),
    "tracks swapped": lambda m: m.append(m.pop(m.index(tracks(m)[0]))),
    "alpha auxi of depth": lambda m: auxi_urn(tracks(m)[1], b"urn:mpeg:mpegB:cicp:systems:auxiliary:depth"),
    "alpha auxi of HEVC's URN": lambda m: auxi_urn(tracks(m)[1], b"urn:mpeg:hevc:2015:auxid:1"),
    "alpha auxi removed": lambda m: renamed(found(tracks(m)[1][2], "mdia/minf/stbl/stsd/av01/auxi")),
    "alpha auxl removed": lambda m: renamed(found(tracks(m)[1][2], "tref/auxl")),
    "alpha track removed": lambda m: m.remove(tracks(m)[1]),
    "alpha entry not av01": lambda m: renamed(found(tracks(m)[1][2], "mdia/minf/stbl/stsd/av01"), b"av02"),
    "alpha av1C removed": lambda m: renamed(found(tracks(m)[1][2], "mdia/minf/stbl/stsd/av01/av1C")),
    "prem removed": lambda m: renamed(found(tracks(m)[0][2], "tref/prem")),
    "colour av1C removed": lambda m: renamed(found(tracks(m)[0][2], "mdia/minf/stbl/stsd/av01/av1C")),
    "colour colr removed": lambda m: renamed(found(tracks(m)[0][2], "mdia/minf/stbl/stsd/av01/colr")),
    "colour colr of BT.709": lambda m: set_field(found(tracks(m)[0][2], "mdia/minf/stbl/stsd/av01/colr"), 8, ">H",
                                                 1),
    "colour entry not av01": lambda m: renamed(found(tracks(m)[0][2], "mdia/minf/stbl/stsd/av01"), b"av02"),
    "colour track id 0": lambda m: set_field(found(tracks(m)[0][2], "tkhd"), 12, ">I", 0),
    "colour tkhd 0x0": lambda m: tkhd_size(tracks(m)[0], 0, 0),
    "colour tkhd removed": lambda m: renamed(found(tracks(m)[0][2], "tkhd")),
    "alpha tkhd larger": lambda m: tkhd_size(tracks(m)[1], 100, 70),
    "colour timescale 0": lambda m: set_field(found(tracks(m)[0][2], "mdia/mdhd"), 20, ">I", 0),
    "mvhd removed": lambda m: renamed(found(m, "mvhd")),
    "no tracks": lambda m: [m.remove(t) for t in tracks(m)],
    "stss and stts removed": lambda m: [renamed(stbl_box(tracks(m)[0], k)) for k in ("stss", "stts")],
    "stsd removed": lambda m: renamed(stbl_box(tracks(m)[0], "stsd")),
    "co64": lambda m: co64(tracks(m)[0]),
    "stsz of fixed size": lambda m: [stsz_fixed(t) for t in tracks(m)],
    "stsz of fixed size, 3 samples": lambda m: stsz_fixed(tracks(m)[0], count=3),
    "stsz of fixed size 1, 3 samples": lambda m: stsz_fixed(tracks(m)[0], size=1, count=3),
    "stsz counting 1 sample": lambda m: set_field(stbl_box(tracks(m)[0], "stsz"), 8, ">I", 1),
    "stsz counting 200 samples": lambda m: set_field(stbl_box(tracks(m)[0], "stsz"), 8, ">I", 200),
    "stsz cut": lambda m: stbl_box(tracks(m)[0], "stsz").__setitem__(1, stbl_box(tracks(m)[0], "stsz")[1][:-4]),
    "stco counting 0 chunks": lambda m: set_field(stbl_box(tracks(m)[0], "stco"), 4, ">I", 0),
    "stco counting 2 chunks": lambda m: set_field(stbl_box(tracks(m)[0], "stco"), 4, ">I", 2),
    "stco cut": lambda m: stbl_box(tracks(m)[0], "stco").__setitem__(1, stbl_box(tracks(m)[0], "stco")[1][:-2]),
    "stco past the end": lambda m: set_field(stbl_box(tracks(m)[0], "stco"), 8, ">I", 10 ** 6),
    "stsc of 1 sample a chunk": lambda m: set_field(stbl_box(tracks(m)[0], "stsc"), 12, ">I", 1),
    "stsc of 5 samples a chunk": lambda m: set_field(stbl_box(tracks(m)[0], "stsc"), 12, ">I", 5),
    "stsc empty": lambda m: set_field(stbl_box(tracks(m)[0], "stsc"), 4, ">I", 0),
    "stsc from chunk 2": lambda m: set_field(stbl_box(tracks(m)[0], "stsc"), 8, ">I", 2),
}


def assert_as_pil(tmp_path, data: bytes, label=""):
    """The file reads as PIL reads it, or PIL raises (opening or loading)
    and so does the port, a ValueError naming the file."""
    try:
        np.asarray(Image.open(io.BytesIO(data)))
    except Exception:  # noqa: BLE001  (SyntaxError, RuntimeError, ZeroDivisionError: each a refusal)
        path = tmp_path / "refused.avif"
        path.write_bytes(data)
        with pytest.raises(ValueError) as err:
            image_io.open_image(path)
        assert str(path) in str(err.value)
        return None
    return assert_reads_as_pil(tmp_path, data, label)


_SEQUENCES = {}


def sequence_of(name):
    """PIL's sequences of seeded pictures, written once a process."""
    if name not in _SEQUENCES:
        rgba = [with_alpha(picture(64, 96, 250 + i, "scene"), i) for i in range(3)]
        _SEQUENCES.update({
            "RGBA premultiplied": pil_sequence(rgba, quality=60, alpha_premultiplied=True),
            "mixed": mixed_sources(pil_sequence(rgba, quality=60),
                                   pil_avif(with_alpha(picture(64, 96, 259, "gradient"), 5), quality=60)),
        })
    return _SEQUENCES[name]


@requires_avif
@pytest.mark.parametrize("edit", list(TRACK_EDITS))
def test_sequence_tracks_read_or_fail_as_pil(tmp_path, cxx, edit):
    """libavif's track rules on an RGBA premultiplied sequence whose `moov`
    is edited: the colour track is the first with an id, chunks and an av01
    entry (its av1C required) that is not an auxiliary; its handler is not
    read; the alpha track is one whose `auxl` names it, its `auxi` (where
    present) an alpha URN; `prem` un-premultiplies; sample 0 comes from
    stco / co64, stsc and stsz (either form), every sample within the file.
    Each file reads as PIL reads it, or raises where PIL raises."""
    data = with_moov(sequence_of("RGBA premultiplied"), TRACK_EDITS[edit])
    assert_as_pil(tmp_path, data, edit)


def mixed_sources(seq: bytes, still: bytes) -> bytes:
    """The sequence `seq` whose primary item (and its alpha item) is the
    still picture's instead of frame 0, its AV1 in a `free` box at the end
    (iloc's extents edited): the tracks and the primary item then show
    different pictures."""
    items = avif.parse(still, "x")
    payload = items["color"] + items["alpha"]
    out = bytearray(seq + box(b"free", payload))
    at = seq.index(b"iloc") + 4
    assert seq[at] == 0 and seq[at + 4] == 0x44  # version 0, 4-byte offsets and lengths
    p = at + 8
    for _ in range(struct.unpack(">H", seq[at + 6:at + 8])[0]):
        item, _, extents = struct.unpack(">HHH", seq[p:p + 6])
        assert extents == 1
        start = len(seq) + 8 + (len(items["color"]) if item == 2 else 0)
        struct.pack_into(">II", out, p + 6, start, len(items["color"] if item == 1 else items["alpha"]))
        p += 14
    return bytes(out)


def with_ftyp(data: bytes, major: bytes, compatible) -> bytes:
    """The file with its 44-byte ftyp's brands replaced (padded with iso8)."""
    assert data[:4] == b"\0\0\0\x2c"
    brands = list(compatible) + [b"iso8"] * (7 - len(compatible))
    return data[:8] + major + b"\0\0\0\0" + b"".join(brands) + data[44:]


def without(data: bytes, kind: bytes) -> bytes:
    at = data.index(kind)
    return data[:at] + b"free" + data[at + 4:]


BRANDS = [(b"avis", (b"avif", b"avis", b"msf1")), (b"avif", (b"avif", b"avis", b"msf1")),
          (b"mif1", (b"avif", b"avis", b"mif1")), (b"msf1", (b"avif", b"avis")), (b"avif", (b"avif", b"mif1")),
          (b"avis", (b"avis", b"msf1")), (b"mif1", (b"avif", b"mif1")), (b"mif1", (b"avis", b"mif1")),
          (b"msf1", (b"avif",)), (b"avis", (b"avif",)), (b"avif", (b"avis",))]


@requires_avif
@pytest.mark.parametrize("boxes", ["both", "no moov", "no meta"])
@pytest.mark.parametrize("major, compatible", BRANDS, ids=[f"{m.decode()}-{'+'.join(c.decode() for c in cs)}"
                                                          for m, cs in BRANDS])
def test_libavifs_choice_of_source_on_edited_brands(tmp_path, cxx, major, compatible, boxes):
    """A sequence whose primary item shows another picture than frame 0:
    a major brand `avis` reads the tracks, `avif` the item, any other the
    tracks where its moov is read; a brand `avif` needs the meta box and
    `avis` the moov, and libavif reads no further once it has them (so a
    file without `avis` never reads its tracks). With the moov or the meta
    box renamed `free`, the file reads or fails as PIL's."""
    data = with_ftyp(sequence_of("mixed"), major, compatible)
    if boxes != "both":
        data = without(data, b"moov" if boxes == "no moov" else b"meta")
    got = assert_as_pil(tmp_path, data, boxes)
    if got is not None:
        want = "tracks" if major == b"avis" or (major != b"avif" and b"avis" in compatible) else "item"
        assert avif.parse(data, "x")["source"] == want


@requires_avif
@pytest.mark.parametrize("grain", [False, True])
@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "RGBA premultiplied"])
def test_sequences_read_as_pils_frame_0(tmp_path, cxx, mode, frames, grain):
    """PIL's sequences of shifted pictures (1 frame: the 3-frame file's
    sample tables cut to its first sample, since PIL writes one frame as a
    still image), with and without grain, read as PIL's frame 0 from their
    tracks."""
    base = picture(67, 130, 260 + frames, "scene")
    pics = [np.roll(base, 5 * i, axis=1) for i in range(3)]
    if mode != "RGB":
        pics = [with_alpha(p, i) for i, p in enumerate(pics)]
    options = dict(quality=55, alpha_premultiplied=mode.endswith("premultiplied"))
    if grain:
        options["advanced"] = {"film-grain-test": "4"}
    data = pil_sequence(pics, **options)
    if frames == 1:
        data = with_moov(data, lambda m: [stsz_fixed(t) for t in tracks(m)])
        assert Image.open(io.BytesIO(data)).n_frames == 1
    got = assert_reads_as_pil(tmp_path, data, mode)
    assert got.mode == mode[:4].strip()
    info = avif.parse(data, "x")
    assert info["source"] == "tracks" and info["premultiplied"] == mode.endswith("premultiplied")
    tools = {}
    avif.av1_planes(info["color"], "x", tools=tools)
    assert tools["film_grain"]["apply_grain"] == int(grain)


@requires_avif
@pytest.mark.parametrize("header, what", [(0x00, "not shown"), (0x30, "inter frame"), (0x80, "show_existing_frame")],
                         ids=["hidden key frame", "inter frame", "show_existing_frame"])
def test_a_sample_0_that_is_not_a_shown_key_frame_is_refused(tmp_path, cxx, header, what):
    """Sample 0 of a PIL-written sequence whose frame header's first byte is
    edited (show_existing_frame, frame_type, show_frame): PIL shows no
    frame 0 (it raises), and the port refuses the frame by name."""
    data = pil_sequence([picture(33, 65, 270 + i) for i in range(3)], quality=60)
    av1 = avif.parse(data, "x")["color"]
    frame = frame_obu_at(av1)[0]
    assert av1[frame] == 0x10  # a shown key frame
    at = data.index(av1) + frame
    data = data[:at] + bytes([header]) + data[at + 1:]
    with pytest.raises(Exception):
        np.asarray(Image.open(io.BytesIO(data)))
    assert_refused(tmp_path, data, what)


# ---- the refusals, each naming the tool and the file ----

def frame_obu_at(av1: bytes):
    """(offset of the frame OBU's payload, offset of the sequence header's
    payload) in an AV1 item."""
    at, found = 0, {}
    while at < len(av1):
        h = av1[at]
        kind, ext = (h >> 3) & 15, (h >> 2) & 1
        at += 1 + ext
        size, shift = 0, 0
        while True:
            b = av1[at]
            at += 1
            size |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        found.setdefault(kind, at)
        at += size
    return found[6], found[1]


def set_bit(data: bytes, byte: int, bit: int, value: int) -> bytes:
    out = bytearray(data)
    mask = 0x80 >> bit
    out[byte] = (out[byte] | mask) if value else (out[byte] & ~mask)
    return bytes(out)


def edited(data: bytes, edit) -> bytes:
    """`data` with its colour item's AV1 bytes edited in place by
    `edit(av1, frame_at, seq_at) -> av1` (the same length)."""
    av1 = avif.parse(data, "x")["color"]
    at = data.index(av1)
    frame, seq = frame_obu_at(av1)
    new = edit(av1, frame, seq)
    assert len(new) == len(av1)
    return data[:at] + new + data[at + len(av1):]


def reduced_header_bits(av1: bytes, seq: int) -> int:
    """The bit offset of enable_superres in a reduced still-picture
    sequence header with one operating point (PIL's): seq_profile (3),
    still_picture, reduced_still_picture_header, seq_level_idx (5), the
    two size widths (4 + 4) and the two sizes (n + 1 bits each), then
    use_128x128_superblock, enable_filter_intra, enable_intra_edge_filter."""
    def bits(pos, n):
        v = 0
        for i in range(n):
            v = 2 * v + ((av1[seq + (pos + i) // 8] >> (7 - (pos + i) % 8)) & 1)
        return v
    wb, hb = bits(10, 4) + 1, bits(14, 4) + 1
    return 18 + wb + hb + 3


def superres_edit(av1, frame, seq):
    """enable_superres := 1 in the sequence header, and the frame header's
    third bit (after disable_cdf_update and allow_screen_content_tools,
    where a reduced header reads use_superres once superres is enabled)
    := 1: the frame uses superres."""
    pos = reduced_header_bits(av1, seq)
    av1 = set_bit(av1, seq + pos // 8, pos % 8, 1)
    return set_bit(av1, frame, 2, 1)


def high_bitdepth_edit(av1, frame, seq):
    """high_bitdepth := 1 (10-bit samples): the bit after enable_superres,
    enable_cdef and enable_restoration."""
    pos = reduced_header_bits(av1, seq) + 3
    return set_bit(av1, seq + pos // 8, pos % 8, 1)


def refused_cases():
    """name: (a function making the bytes, what the error names)."""
    px = picture(130, 160, 90)
    return {
        "superres (header bits edited)": (lambda: edited(pil_avif(px, quality=50), superres_edit), "superres"),
    }


REFUSED = refused_cases()  # made in the test that reads each


@requires_avif
@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_tools_name_the_tool_and_the_file(tmp_path, cxx, case):
    make, what = REFUSED[case]
    assert_refused(tmp_path, make(), what)


@requires_avif
def test_a_file_whose_high_bitdepth_bit_is_set_reads_as_pil(tmp_path, cxx):
    """The one-bit edit that made a 10-bit file (high_bitdepth := 1 in the
    sequence header, av1C and pixi still saying 8 bits) reads as PIL reads
    it: AV1's syntax below the sequence header is the same at 10 bits."""
    data = edited(pil_avif(picture(130, 160, 90), quality=50), high_bitdepth_edit)
    assert avif.av1_planes(avif.parse(data, "x")["color"], "x")[3]["depth"] == 10
    assert_reads_as_pil(tmp_path, data)


def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(body), kind) + body


def with_primary_type(data: bytes, kind: bytes) -> bytes:
    """A PIL-written file whose primary item's `infe` type is `kind`."""
    at = data.index(b"infe") + 4  # the box's body: version and flags, item_ID, protection index, type
    return data[:at + 8] + kind + data[at + 12:]


@requires_avif
@pytest.mark.parametrize("kind", [b"grid", b"tmap"])
def test_grid_and_tmap_items_are_refused(tmp_path, cxx, kind):
    """A PIL-written file whose `av01` primary item is relabelled: as a
    `grid`, its AV1 data is read as an ImageGrid body whose version is not
    0, which PIL refuses (libavif: INVALID_IMAGE_GRID) and so does the
    port, naming the rule; a `tmap` primary item is refused by name."""
    data = pil_avif(picture(33, 65, 95), quality=50)
    assert avif.parse(data, "x")["color"]
    relabelled = with_primary_type(data, kind)
    if kind == b"grid":
        with pytest.raises(RuntimeError, match="Invalid image grid"):
            np.asarray(Image.open(io.BytesIO(relabelled)))
    assert_refused(tmp_path, relabelled, "grid item of ImageGrid version" if kind == b"grid" else "tmap")


# ---- PIL's accept rule and the fall-through ----

def test_avif_is_first_of_pils_init_formats_with_its_accept_rule():
    """`Image.open` tries the formats `Image.preinit` loads (BMP, DIB, GIF,
    JPEG, PPM, PNG), then `Image.init`'s, whose first is AVIF."""
    from PIL import Image as image_module

    names = [name for name, _, _ in image_io.READERS]
    assert names[:7] == ["BMP", "DIB", "GIF", "JPEG", "PPM", "PNG", "AVIF"]
    assert image_module._plugins[0] == "AvifImagePlugin"
    accepts = dict((name, test) for name, test, _ in image_io.READERS)["AVIF"]
    from PIL import AvifImagePlugin
    for head in (b"\0\0\0\x1cftypavif", b"\0\0\0\x1cftypavis", b"\0\0\0\x1cftypmif1", b"\0\0\0\x1cftypmsf1",
                 b"\0\0\0\x1cftypheic", b"\0\0\0\x1cftypisom", b"\0\0\0\x1cftyqavif", b"RIFF\0\0\0\0WEBP"):
        assert bool(accepts(head.ljust(18, b"\0"))) == bool(AvifImagePlugin._accept(head.ljust(16, b"\0"))), head


@requires_avif
def test_other_ftyp_files_pass_on_as_pil_passes_them(tmp_path, cxx):
    """A PPM whose comment puts "ftypavif" at offset 4: PIL's AVIF plugin
    accepts it, libavif cannot parse it (SyntaxError) and PIL's PPM plugin
    reads it; so does the port. A HEIF file with no avif brand: libavif's
    INVALID_FTYP passes it on and nothing else reads it, in PIL (it
    raises) and in the port (a ValueError naming the formats)."""
    ppm = b"P6\n#ftypavif\n3 2\n255\n" + bytes(range(18))
    path = tmp_path / "odd.ppm"
    path.write_bytes(ppm)
    assert Image.open(path).format == "PPM"
    np.testing.assert_array_equal(image_io.open_image(path).pixels, np.asarray(Image.open(path)))
    heif = box(b"ftyp", b"mif1\0\0\0\0mif1heic") + box(b"meta", bytes(4))
    path = tmp_path / "other.heic"
    path.write_bytes(heif)
    with pytest.raises(Exception):
        Image.open(path)
    with pytest.raises(ValueError, match="no avif or avis brand") as err:
        image_io.open_image(path)
    assert str(path) in str(err.value)
    for cut in (40, 200):
        data = pil_avif(picture(33, 65, 97), quality=50)[:cut]
        path.write_bytes(data)
        with pytest.raises(Exception):
            np.asarray(Image.open(path))
        with pytest.raises(ValueError) as err:
            image_io.open_image(path)
        assert str(path) in str(err.value)


@requires_avif
def test_failed_av1_decoder_build_raises_naming_the_source(tmp_path, fake_cxx):
    """AVIF cannot be read without csrc/av1_decode.cc: the read raises,
    naming it and the file; nothing falls back to PIL."""
    fake_cxx(fail=True)
    path = tmp_path / "v.avif"
    path.write_bytes(pil_avif(picture(5, 7, 98), quality=50))
    with pytest.raises(RuntimeError, match="csrc/av1_decode.cc") as err:
        image_io.open_image(path)
    assert str(path) in str(err.value)
    assert not cuda_build.host_library_path("av1_decode").exists()


# ---- the committed fixtures ----

READINGS = json.load(open(os.path.join(FIXTURES, "sha256.json")))


def sha256_of(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(READINGS["files"]))
def test_committed_fixture_reads_as_pil_and_the_json_say(tmp_path, cxx, name):
    """Each fixture (1080p ones included) is the file whose PIL reading
    sha256.json holds, PIL reads it so (where it has AVIF), and the port
    reads it so."""
    want = READINGS["files"][name]
    path = os.path.join(FIXTURES, name)
    assert hashlib.sha256(open(path, "rb").read()).hexdigest() == want["file_sha256"]
    if features.check("avif"):
        im = Image.open(path)
        px = np.asarray(im)
        assert (im.mode, list(px.shape), sha256_of(px)) == (want["mode"], want["shape"], want["sha256"])
    got = image_io.open_image(path)
    assert (got.mode, list(got.pixels.shape), sha256_of(got.pixels)) == (want["mode"], want["shape"], want["sha256"])


def test_decode_split_names_each_step():
    """The split names every step, CDEF, loop restoration and film grain
    among them, on files that use them (and alpha items, whose steps are
    added)."""
    assert avif.SPLIT_KEYS == ("container", "av1_symbols_and_reconstruction", "av1_deblocking", "av1_cdef",
                               "av1_loop_restoration", "av1_film_grain", "yuv_to_rgb")
    for name in ("tiles_2x2_256x256.avif", "rgba_sb128_130x67.avif", "grain_rgba_avis_130x67.avif"):
        data = open(os.path.join(FIXTURES, name), "rb").read()
        split = {}
        avif.decode_avif(data, name, split=split)
        assert sorted(split) == sorted(avif.SPLIT_KEYS) and all(v >= 0 for v in split.values())


# ---- both dataset paths against the JAX package ----

def colmap_views(w, h, filters=False):
    """AVIF views of modes RGB and RGBA (alpha 255 and not), every
    subsampling and both ranges; with `filters`, all written at speed 2
    with CDEF on (CDEF and loop restoration in use)."""
    a = picture(h, w, 110)
    more = dict(speed=2, advanced=CDEF_ON) if filters else {}
    return {
        "v_420.avif": pil_avif(a, quality=70, **more),
        "v_444.avif": pil_avif(picture(h, w, 111, "edges"), quality=90, subsampling="4:4:4", **more),
        "v_422_limited.avif": pil_avif(picture(h, w, 112), quality=50, subsampling="4:2:2", range="limited",
                                       **more),
        "v_400.avif": pil_avif(a, quality=75, subsampling="4:0:0", **more),
        "v_rgba.avif": pil_avif(with_alpha(picture(h, w, 113), 1), quality=80, **more),
        "v_rgba_opaque.avif": pil_avif(np.concatenate([a, np.full((h, w, 1), 255, np.uint8)], -1), quality=80,
                                       **(more or dict(speed=10))),
        "v_lossless.avif": pil_avif(picture(h, w, 114, "gradient"), quality=100, **more),
    }


def screen_views(w, h):
    """AVIF views of screen content (palette and IntraBC): flat cells at
    PIL's defaults, `tune-content=screen` at 4:4:4, at 4:2:2 limited range
    and in RGBA, IntraBC alone at 4:0:0, lossless."""
    return {
        "s_cells.avif": pil_avif(cells(h, w, 130)),
        "s_bands_444.avif": pil_avif(bands(h, w, 131), quality=60, subsampling="4:4:4", advanced=SCREEN),
        "s_glyphs_422_limited.avif": pil_avif(glyphs(h, w, 132), quality=60, subsampling="4:2:2", range="limited",
                                              advanced=SCREEN),
        "s_tiles_400.avif": pil_avif(shaded_tiles(h, w, 133), quality=60, subsampling="4:0:0", advanced=INTRABC_ONLY),
        "s_glyphs_rgba.avif": pil_avif(with_alpha(glyphs(h, w, 134), 2), quality=70, advanced=SCREEN),
        "s_tiles_420.avif": pil_avif(shaded_tiles(h, w, 135), quality=60, speed=2, advanced=SCREEN),
        "s_lossless.avif": pil_avif(glyphs(h, w, 136), quality=100, advanced=SCREEN),
    }


def grain_views(w, h):
    """AVIF views with film grain: test vectors at 4:2:0, at 4:2:2 limited
    range and at 4:4:4, grain estimated from the picture, RGBA 4:0:0 with
    grain on both items, premultiplied RGBA with grain on the colour only."""
    a = picture(h, w, 140)
    return {
        "g_420.avif": pil_avif(a, quality=70, advanced={"film-grain-test": "1"}),
        "g_422_limited.avif": pil_avif(picture(h, w, 141, "edges"), quality=50, subsampling="4:2:2",
                                       range="limited", advanced={"film-grain-test": "6"}),
        "g_444.avif": pil_avif(picture(h, w, 142), quality=80, subsampling="4:4:4",
                               advanced={"film-grain-test": "12"}),
        "g_denoise.avif": pil_avif(picture(h, w, 143, "grainy"), quality=60, advanced={"denoise-noise-level": "25"}),
        "g_400_rgba.avif": pil_avif(with_alpha(a, 3), quality=75, subsampling="4:0:0",
                                    advanced={"film-grain-test": "3"}),
        "g_rgba_premultiplied.avif": pil_avif(with_alpha(picture(h, w, 144), 4), quality=70, alpha_premultiplied=True,
                                              advanced={"color:film-grain-test": "8"}),
    }


def avis_views(w, h):
    """AVIF views written as 3-frame sequences of shifted pictures (RGB,
    RGBA, premultiplied RGBA with grain on both tracks) beside a still one."""
    def frames(seed, alpha=False):
        px = picture(h, w, seed)
        return [with_alpha(np.roll(px, 3 * i, axis=1), i) if alpha else np.roll(px, 3 * i, axis=1) for i in range(3)]
    return {
        "q_rgb.avif": pil_sequence(frames(150), quality=70),
        "q_rgba.avif": pil_sequence(frames(151, True), quality=70, subsampling="4:4:4"),
        "q_rgba_grain.avif": pil_sequence(frames(152, True), quality=60, alpha_premultiplied=True,
                                          advanced={"film-grain-test": "5"}),
        "q_still.avif": pil_avif(picture(h, w, 153), quality=70),
    }


def assert_views_use_grain_and_tracks(views, tracks=True):
    """The views' AV1 used luma and chroma grain with overlap_flag, and
    (with `tracks`) some view was read from its tracks."""
    used, sources = [], []
    for data in views:
        tools, info = {}, avif.parse(data, "x")
        avif.av1_planes(info["color"], "x", tools=tools)
        used.append(tools["film_grain"])
        sources.append(info["source"])
    assert any(g["num_y_points"] and g["num_cb_points"] and g["overlap_flag"] for g in used), used
    assert not tracks or "tracks" in sources


def assert_views_use_screen_tools(views):
    """The views' AV1 used Y palettes, UV palettes and IntraBC."""
    used = []
    for data in views:
        tools = {}
        avif.av1_planes(avif.parse(data, "x")["color"], "x", tools=tools)
        used.append(tools)
    assert any(sum(t["palette_y"].values()) for t in used)
    assert any(sum(t["palette_uv"].values()) for t in used)
    assert any(sum(t["intrabc"].values()) for t in used)


def assert_views_use_both_filters(views):
    """Some view's AV1 used CDEF and some used loop restoration."""
    used = []
    for data in views:
        tools = {}
        avif.av1_planes(avif.parse(data, "x")["color"], "x", tools=tools)
        used.append(tools)
    assert any(any(sum(k.values()) for k in t["cdef_blocks"]) for t in used)
    assert any(t["lr_unit_shift"] >= 0 for t in used)


@requires_avif
@pytest.mark.parametrize("resolution, filters", [pytest.param(1, False, id="1"), pytest.param(2, False, id="2"),
                                                 pytest.param(1, True, id="1-speed2-cdef"),
                                                 pytest.param(1, "screen", id="1-screen"),
                                                 pytest.param(1, "grain", id="1-grain"),
                                                 pytest.param(2, "avis", id="2-avis")])
def test_colmap_avif_views_match_jax(tmp_path, monkeypatch, cxx, resolution, filters):
    """A COLMAP dataset of AVIF views: the Scene's cameras equal the JAX
    package's, images bit for bit; also with views that use CDEF and loop
    restoration, with screen content (palette and IntraBC, 203x131), with
    film grain, and with image sequences (read as frame 0) beside grain."""
    from test_torch_scene import both_scenes

    w, h = (203, 131) if filters == "screen" else (45, 37)
    src = str(tmp_path / "avif")
    if filters == "screen":
        views = screen_views(w, h)
        assert_views_use_screen_tools(views.values())
    elif filters in ("grain", "avis"):
        views = grain_views(w, h) if filters == "grain" else {**avis_views(w, h), **grain_views(w, h)}
        assert_views_use_grain_and_tracks(views.values(), tracks=filters == "avis")
    else:
        views = colmap_views(w, h, filters)
    if filters is True:
        assert_views_use_both_filters(views.values())
    write_colmap_dataset_of(src, views, w, h)
    jscene, scene = both_scenes(tmp_path, monkeypatch, src, eval_split=True, resolution=resolution)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == len(views)
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())


@requires_avif
@pytest.mark.parametrize("white_background, filters", [
    pytest.param(False, False, id="False"), pytest.param(True, False, id="True"),
    pytest.param(True, True, id="True-speed2-cdef"), pytest.param(True, "screen", id="True-screen"),
    pytest.param(True, "grain", id="True-grain"), pytest.param(False, "avis", id="False-avis")])
def test_blender_avif_frames_match_jax(tmp_path, monkeypatch, cxx, white_background, filters):
    """read_blender_scene on AVIF frames (named .png, as the transforms file
    names them): PIL's convert("RGBA") through the composite, bit for bit,
    then load_camera at -r 2; also with frames that use CDEF and loop
    restoration, with screen content (palette and IntraBC), with film
    grain, and with image sequences beside grain."""
    if filters == "screen":
        frames = list(screen_views(203, 131).values())
        assert_views_use_screen_tools(frames)
    elif filters in ("grain", "avis"):
        frames = list(grain_views(45, 37).values())
        if filters == "avis":
            frames = list(avis_views(45, 37).values()) + frames
        assert_views_use_grain_and_tracks(frames, tracks=filters == "avis")
    else:
        frames = list(colmap_views(45, 37, filters).values())
    if filters is True:
        assert_views_use_both_filters(frames)
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
