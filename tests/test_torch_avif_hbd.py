"""10- and 12-bit AVIF (AV1 high bit depth) in the port's reader
(`utils/avif.py`, `csrc/av1_decode.cc`) against PIL 12.1.0 (libavif 1.3.0,
dav1d 1.5.1), and both dataset paths on 10- and 12-bit views against the JAX
package.

PIL's aom writes 8-bit AV1 only, and AV1's syntax below the sequence header
is the same at every depth but for palette colours: so each file here is an
8-bit file relabelled by `torch_image_writers.avif_high_depth` (seq_profile,
high_bitdepth and twelve_bit in every sequence header, the profile-2
subsampling bits where the new profile codes them, and the `av1C` / `pixi`
boxes, or the AV1 data only), which PIL decodes at the new depth. PIL's
reading is the rule: `image_io.open_image` gives PIL's mode and pixels bit for
bit. The relabelled committed fixtures of `tests/fixtures/torch_avif` and the
small files of `tests/fixtures/torch_avif_hbd` are held to `sha256.json`
there; files PIL writes here, to PIL. The YUV -> RGB conversion is held to
libavif's own `avifImageYUVToRGB` (through ctypes, the libavif PIL ships) on
seeded planes of every depth, subsampling, range, matrix and alpha mode.
"""

import ctypes
import hashlib
import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image, features

import torch_image_writers as writers
from gaussian_splatting_tpu.scene import dataset_readers as jreaders
from gaussian_splatting_torch.scene import dataset_readers
from gaussian_splatting_torch.utils import avif, image_io
from test_torch_avif import SIZES, assert_reads_as_pil, colmap_views, grain_views, picture, pil_avif, with_alpha
from test_torch_image_forms import cxx, write_colmap_dataset_of  # noqa: F401  (cxx: a fixture)
from test_torch_scene import assert_same_cameras, orbit_frames

requires_avif = pytest.mark.skipif(not features.check("avif"), reason="this PIL has no AVIF support")
requires_libavif = pytest.mark.skipif(not features.check("avif") or writers.avif_library() is None,
                                      reason="this PIL has no AVIF support or ships no libavif 1.x")

HERE = os.path.dirname(__file__)
FIXTURES = os.path.join(HERE, "fixtures", "torch_avif_hbd")
EIGHT_BIT = os.path.join(HERE, "fixtures", "torch_avif")
GRIDS = os.path.join(HERE, "fixtures", "torch_avif_grid")
READINGS = json.load(open(os.path.join(FIXTURES, "sha256.json")))
PALETTE = ("1080p_screen_420_q60.avif", "1080p_screen_444_q75.avif")


def sha256_of(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def read(*parts) -> bytes:
    with open(os.path.join(*parts), "rb") as f:
        return f.read()


def relabelled(key: str, boxes: bool = True) -> bytes:
    name, depth = key.split("@")
    return writers.avif_high_depth(read(EIGHT_BIT, name), int(depth), boxes)


def reading_of(tmp_path, data: bytes, pil: bool):
    """(mode, shape, SHA-256 of the pixels) by the port, and by PIL where
    `pil` (else None)."""
    path = tmp_path / "view.avif"
    path.write_bytes(data)
    got = image_io.open_image(path)
    want = None
    if pil:
        im = Image.open(path)
        px = np.asarray(im)
        want = (im.mode, list(px.shape), sha256_of(px))
    return (got.mode, list(got.pixels.shape), sha256_of(got.pixels)), want


def depths_said(data: bytes) -> list:
    """Each av01 item's (av1C depth, pixi depths, AV1 sequence header depth)."""
    m = writers.heif_model(data)
    out = []
    for it in m["items"]:
        if it["type"] != b"av01":
            continue
        props = {m["props"][i - 1][0]: m["props"][i - 1][1] for i, _ in m["assoc"].get(it["id"], [])}
        c = props[b"av1C"]
        av1C = 12 if c[2] & 0x60 == 0x60 else 10 if c[2] & 0x40 else 8
        pixi = list(props[b"pixi"][5:]) if b"pixi" in props else []
        out.append((av1C, pixi, writers.av1_color_config(writers.av1_sequence_header(it["payload"]))["depth"]))
    return out


# ---- the committed fixtures, relabelled; the small high-depth fixtures ----

@pytest.mark.parametrize("boxes", [pytest.param(True, id="boxes"), pytest.param(False, id="stream")])
@pytest.mark.parametrize("key", sorted(READINGS["relabelled"]))
def test_relabelled_fixtures_read_as_pil(tmp_path, cxx, key, boxes):
    """Each non-palette fixture of tests/fixtures/torch_avif at 10 and 12
    bits (profiles 0, 1 and 2: 4:2:2 and 12 bits are profile 2), its boxes
    relabelled too or its AV1 data only (PIL reads it where av1C and pixi
    still say 8 bits), reads as sha256.json says PIL 12.1.0 reads it."""
    want = READINGS["relabelled"][key]
    data = relabelled(key, boxes)
    if boxes:
        assert hashlib.sha256(data).hexdigest() == want["file_sha256"]
    got, pil = reading_of(tmp_path, data, features.check("avif"))
    assert got == (want["mode"], want["shape"], want["sha256"])
    assert pil in (None, got)


@pytest.mark.parametrize("name", sorted(READINGS["files"]))
def test_small_fixtures_read_as_pil(tmp_path, cxx, name):
    """The committed small files (4:2:2 at 10 bits, 12 bits at 4:2:0, 4:4:4
    and 4:0:0, RGBA, restoration with CDEF, grids of 10- and 12-bit cells):
    their bytes, PIL's reading and the port's."""
    want = READINGS["files"][name]
    data = read(FIXTURES, name)
    assert hashlib.sha256(data).hexdigest() == want["file_sha256"]
    got, pil = reading_of(tmp_path, data, features.check("avif"))
    assert got == (want["mode"], want["shape"], want["sha256"])
    assert pil in (None, got)
    depth = int(name[3:5])
    for av1C, pixi, stream in depths_said(data):
        assert av1C == stream == depth and set(pixi) <= {depth}, name


def test_relabelling_keeps_the_sampling_and_says_the_depth():
    """avif_high_depth's sequence headers: the profile of the sampling at
    the depth (4:2:2 and 12 bits: 2; 4:4:4: 1), the sampling, range and
    colour description kept; av1C and pixi say the depth, or keep 8 with
    boxes=False."""
    for name in ("mono_7x5.avif", "limited_422_130x67.avif", "1080p_444_q90.avif", "1080p_rgba_q75.avif"):
        data = read(EIGHT_BIT, name)
        before = writers.av1_color_config(writers.av1_sequence_header(avif.parse(data, name)["color"]))
        for depth in (10, 12):
            for boxes in (True, False):
                out = writers.avif_high_depth(data, depth, boxes)
                after = writers.av1_color_config(writers.av1_sequence_header(avif.parse(out, name)["color"]))
                assert after["depth"] == depth
                want_profile = 2 if depth == 12 or (not before["mono"] and before["ss"] == (1, 0)) else \
                    1 if not before["mono"] and before["ss"] == (0, 0) else 0
                assert after["profile"] == want_profile, (name, depth)
                for k in ("mono", "colour", "range", "ss", "csp", "uv_delta", "grain"):
                    assert after[k] == before[k], (name, depth, k)
                said = depth if boxes else 8
                for av1C, pixi, stream in depths_said(out):
                    assert av1C == said and set(pixi) <= {said} and stream == depth, (name, depth, boxes)


@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("name", PALETTE)
def test_relabelled_palette_files_fail_as_pil(tmp_path, cxx, name, depth):
    """Palette colours are coded with BitDepth bits: PIL fails on the
    relabelled screen-content files ("Decoding of color planes failed"),
    and the port refuses them at the first palette block, naming it."""
    path = tmp_path / "palette.avif"
    path.write_bytes(writers.avif_high_depth(read(EIGHT_BIT, name), depth))
    if features.check("avif"):
        with pytest.raises(Exception, match="Decoding of color planes failed"):
            Image.open(path).load()
    with pytest.raises(ValueError, match=f"palette colours at {depth}-bit") as err:
        image_io.open_image(path)
    assert str(path) in str(err.value) and "10-bit samples" not in str(err.value)


# ---- files PIL writes here, relabelled ----

@requires_avif
@pytest.mark.parametrize("depth", [10, 12])
@pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2", "4:4:4", "4:0:0"])
def test_pil_written_files_relabelled_read_as_pil(tmp_path, cxx, subsampling, depth):
    """Every size (1x1 to 256x200) and picture kind at three qualities, RGB
    and RGBA (premultiplied at 4:4:4), both ranges, read as PIL reads them
    at 10 and 12 bits."""
    for i, (w, h) in enumerate(SIZES):
        for quality, kind, alpha in ((20, "noise", False), (60, "edges", True), (95, "scene", False)):
            px = picture(h, w, 300 + 7 * i + quality, kind)
            if alpha:
                px = with_alpha(px, i)
            data = pil_avif(px, quality=quality, subsampling=subsampling, range="limited" if i % 2 else "full",
                            alpha_premultiplied=alpha and subsampling == "4:4:4")
            assert_reads_as_pil(tmp_path, writers.avif_high_depth(data, depth), f"{w}x{h} q{quality} {kind}")


def test_the_files_together_use_each_tool_at_high_depth():
    """Through the decoder's test hook, over the relabelled fixtures and the
    small files: every decode is of 10 or 12 bits, and together they use
    CDEF, the Wiener filter, the self-guided filter with both radii and with
    one, switchable restoration, film grain on luma and chroma with
    overlap_flag and clip_to_restricted_range, IntraBC and 128x128
    superblocks."""
    used = []
    datas = [relabelled(k) for k in READINGS["relabelled"]] + [read(FIXTURES, n) for n in READINGS["files"]]
    for data in datas:
        info = avif.parse(data, "x")
        items = info["color"].cells if isinstance(info["color"], avif._Grid) else [info["color"]]
        for av1 in items:
            tools = {}
            assert avif.av1_planes(av1, "x", tools=tools)[3]["depth"] in (10, 12)
            used.append(tools)
    assert any(sum(sum(k.values()) for k in t["cdef_blocks"]) for t in used)
    assert any(t["lr_units"][p]["wiener"] for t in used for p in range(3))
    assert any(t["lr_units"][p]["sgrproj_both"] for t in used for p in range(3))
    assert any(t["lr_units"][p]["sgrproj_one"] for t in used for p in range(3))
    assert any("switchable" in t["lr_types"] for t in used)
    grain = [t["film_grain"] for t in used]
    assert any(g["num_y_points"] and g["num_cb_points"] and g["overlap_flag"] for g in grain)
    assert any(g["clip_to_restricted_range"] for g in grain)
    assert any(sum(t["intrabc"].values()) for t in used)
    assert any(t["use_128"] for t in used) and any(not t["use_128"] for t in used)


# ---- depths that disagree, limited-range alpha ----

def grid_fixture(name):
    return read(GRIDS, name)


EDITS = {
    # name: (the file, what the port raises, or None where it reads as PIL)
    "alpha item at 12 bits under a 10-bit colour item": (lambda: writers.avif_high_depth(writers.avif_high_depth(
        read(EIGHT_BIT, "rgba_premultiplied_65x33.avif"), 10, items=[1]), 12, items=[2]),
                                                          "12-bit samples for a 10-bit"),
    "alpha item at 10 bits under an 8-bit colour item": (lambda: writers.avif_high_depth(
        read(EIGHT_BIT, "rgba_premultiplied_65x33.avif"), 10, False, items=[2]), "10-bit samples for a 8-bit"),
    "colour item at 12 bits over an 8-bit alpha item": (lambda: writers.avif_high_depth(
        read(EIGHT_BIT, "rgba_sb128_130x67.avif"), 12, items=[1]), "8-bit samples for a 12-bit"),
    "a grid cell at 10 bits among 8-bit cells": (lambda: writers.avif_high_depth(
        grid_fixture("grid_420_2x2.avif"), 10, items=[3]), "mismatched tiles"),
    "the first grid cell at 10 bits": (lambda: writers.avif_high_depth(
        grid_fixture("grid_444_2x2.avif"), 10, False, items=[2]), "mismatched tiles"),
    "an alpha grid cell at 10 bits": (lambda: writers.avif_high_depth(
        grid_fixture("grid_rgba_420_2x2.avif"), 10, False, items=[10]), "alpha grid whose cell 3"),
    "every cell at 12 bits, the grid's pixi still 8": (lambda: writers.avif_high_depth(
        grid_fixture("grid_422_seams_3x2.avif"), 12, items=[2, 3, 4, 5, 6, 7]), None),
    "every cell's AV1 data at 10 bits": (lambda: writers.avif_high_depth(
        grid_fixture("grid_420_crop_170x100.avif"), 10, False), None),
    "a gain map's own item at 10 bits": (lambda: writers.avif_high_depth(
        grid_fixture("gain_map_128x128.avif"), 10, items=[3]), None),
    "a gain map's base at 12 bits": (lambda: writers.avif_high_depth(
        grid_fixture("gain_map_128x128.avif"), 12, items=[1]), None),
}


@requires_avif
@pytest.mark.parametrize("case", list(EDITS))
def test_edited_depths_read_or_fail_as_pil(tmp_path, cxx, case):
    """libavif's rules where the depths of a file's items disagree: an alpha
    item's depth must be its colour's ("Decoding of alpha plane failed"), a
    grid's cells (colour or alpha) one depth ("Invalid image grid"); a
    grid's own pixi is not held to its cells', and a gain map's items are
    decoded on their own."""
    make, what = EDITS[case]
    data = make()
    if what is None:
        assert_reads_as_pil(tmp_path, data, case)
        return
    path = tmp_path / "edited.avif"
    path.write_bytes(data)
    with pytest.raises(Exception, match="Decoding of alpha plane failed|Invalid image grid"):
        Image.open(path).load()
    with pytest.raises(ValueError, match=what):
        image_io.open_image(path)


@requires_avif
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("name", ["rgba_premultiplied_65x33.avif", "rgba_sb128_130x67.avif"])
def test_limited_range_alpha_is_widened_at_its_depth(tmp_path, cxx, name, depth):
    """An alpha stream whose sequence header says limited range (its
    color_range bit cleared) is widened as libavif's avifLimitedToFullY
    widens it at its depth: (a - 16) * 255 / 219 at 8 bits, (a - 64) * 1023
    / 876 at 10, (a - 256) * 4095 / 3504 at 12, rounded."""
    data = read(EIGHT_BIT, name)
    if depth > 8:
        data = writers.avif_high_depth(data, depth)
    alpha = avif.parse(data, name)["alpha"]
    seq = alpha.index(writers.av1_sequence_header(alpha))
    pos = writers.av1_color_config(alpha[seq:])["range_at"]
    assert (alpha[seq + pos // 8] >> (7 - pos % 8)) & 1 == 1
    edited = bytearray(alpha)
    edited[seq + pos // 8] &= 0xFF ^ (1 << (7 - pos % 8))
    at = data.index(alpha)
    got = assert_reads_as_pil(tmp_path, data[:at] + bytes(edited) + data[at + len(alpha):])
    assert got.mode == "RGBA"


# ---- the conversion, held to libavif's avifImageYUVToRGB ----

FORMATS = {"4:4:4": (0, 0), "4:2:2": (1, 0), "4:2:0": (1, 1), "4:0:0": None}
MATRICES = [(6, 1), (1, 1), (9, 9), (5, 1), (12, 1), (12, 9), (0, 1), (4, 1), (7, 1), (2, 2), (8, 1)]  # (mc, cp)


def libavif_rgb(lib, depth, fmt, planes, full, cicp, alpha, premultiplied):
    """libavif's 8-bit RGB(A) of the planes as PIL asks for it (an
    avifRGBImage of its defaults, depth 8, RGB or RGBA), or its avifResult."""
    y = planes[0]
    h, w = y.shape
    at = writers._IMAGE_AT
    im = lib.avifImageCreate(w, h, depth, writers.AVIF_FORMATS[fmt])
    try:
        ctypes.c_int.from_address(im + at["range"]).value = int(full)
        ctypes.c_int.from_address(im + at["premultiplied"]).value = int(premultiplied)
        for k, v in enumerate(cicp):
            ctypes.c_uint16.from_address(im + at["cicp"] + 2 * k).value = v
        assert lib.avifImageAllocatePlanes(im, 1 | (2 if alpha is not None else 0)) == 0
        dtype = np.uint8 if depth == 8 else np.uint16

        def put(ptr_at, rb_at, plane):
            ptr = ctypes.c_void_p.from_address(im + ptr_at).value
            rb = ctypes.c_uint32.from_address(im + rb_at).value
            plane = np.ascontiguousarray(plane.astype(dtype))
            for r in range(plane.shape[0]):
                ctypes.memmove(ptr + r * rb, plane[r].ctypes.data, plane.shape[1] * plane.itemsize)

        for k, plane in enumerate(planes):
            if plane is not None:
                put(at["planes"] + 8 * k, at["row_bytes"] + 4 * k, plane)
        if alpha is not None:
            put(at["alpha"], at["alpha_row_bytes"], alpha)
        rgb = (ctypes.c_uint8 * 64)()  # avifRGBImage: width, height, depth, format, ..., pixels at 48, rowBytes at 56
        a = ctypes.addressof(rgb)
        lib.avifRGBImageSetDefaults(ctypes.c_void_p(a), ctypes.c_void_p(im))
        ctypes.c_uint32.from_address(a + 8).value = 8
        ctypes.c_int.from_address(a + 12).value = 1 if alpha is not None else 0  # AVIF_RGB_FORMAT_RGBA / RGB
        assert lib.avifRGBImageAllocatePixels(ctypes.c_void_p(a)) == 0
        try:
            result = lib.avifImageYUVToRGB(ctypes.c_void_p(im), ctypes.c_void_p(a))
            if result:
                return result
            ch = 4 if alpha is not None else 3
            rb = ctypes.c_uint32.from_address(a + 56).value
            raw = ctypes.string_at(ctypes.c_void_p.from_address(a + 48).value, rb * h)
            return np.frombuffer(raw, np.uint8).reshape(h, rb)[:, :w * ch].reshape(h, w, ch)
        finally:
            lib.avifRGBImageFreePixels(ctypes.c_void_p(a))
    finally:
        lib.avifImageDestroy(im)


def port_rgb(depth, planes, ss, mc, cp, full, alpha, premultiplied):
    y = planes[0]
    h, w = y.shape
    dtype = np.uint8 if depth == 8 else np.uint16
    keep = [None if p is None else np.ascontiguousarray(p.astype(dtype)) for p in (*planes, alpha)]
    out = np.empty((h, w, 3 if alpha is None else 4), np.uint8)
    msg = ctypes.create_string_buffer(256)
    sx, sy = ss or (1, 1)
    lib = avif._library("x")
    if lib.gs_yuv_to_rgb(*[None if p is None else p.ctypes.data for p in keep], w, h, depth, int(ss is None), sx, sy,
                         mc, cp, full, int(premultiplied), out.ctypes.data, msg, len(msg)):
        return msg.value.decode()
    return out


@requires_libavif
@pytest.mark.parametrize("alpha", ["none", "straight", "premultiplied"])
@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_conversion_is_libavifs(cxx, depth, fmt, alpha):
    """gs_yuv_to_rgb against libavif 1.3.0's avifImageYUVToRGB on seeded
    planes: sizes from 1x1 to odd ones, both ranges, BT.601 / 709 / 2020 /
    470BG / chroma-derived, identity, the float path's matrices and YCgCo,
    each alpha mode. libavif's picks above 8 bits: the planes downshifted
    to 8 bits for RGB; its 10-bit rows with alpha (chroma upsampled at 10
    bits); at 12 bits I012's nearest chroma at 4:2:0 RGBA, else the
    downshift; alpha by the float rounding where libyuv's rows do not carry
    it; the float path at the samples' depth, which un-premultiplies in
    float for identity and YCgCo. Where libavif converts by its slow path
    with subsampled chroma or by YCgCo, the port refuses by name."""
    lib = writers.avif_library()
    for fn, args in (("avifRGBImageSetDefaults", [ctypes.c_void_p] * 2), ("avifImageYUVToRGB", [ctypes.c_void_p] * 2),
                     ("avifRGBImageAllocatePixels", [ctypes.c_void_p]), ("avifRGBImageFreePixels", [ctypes.c_void_p])):
        getattr(lib, fn).argtypes = args
    rng = np.random.default_rng(depth * 100 + list(FORMATS).index(fmt) * 10 + len(alpha))
    ss = FORMATS[fmt]
    for h, w in ((9, 13), (8, 14), (1, 1), (2, 3), (5, 1)):
        for full in (0, 1):
            for mc, cp in MATRICES:
                y = rng.integers(0, 1 << depth, (h, w))
                u = v = None
                if ss is not None:
                    u = rng.integers(0, 1 << depth, ((h + ss[1]) >> ss[1], (w + ss[0]) >> ss[0]))
                    v = rng.integers(0, 1 << depth, u.shape)
                a = None if alpha == "none" else rng.integers(0, 1 << depth, (h, w))
                label = (h, w, full, mc, cp)
                want = libavif_rgb(lib, depth, fmt, (y, u, v), full, (cp, 13, mc), a, alpha == "premultiplied")
                got = port_rgb(depth, (y, u, v), ss, mc, cp, full, a, alpha == "premultiplied")
                not_followed = (mc == 8 and ss is not None) or (mc in (4, 7) and ss not in (None, (0, 0)))
                if isinstance(got, str):
                    assert isinstance(want, int) or not_followed, (label, got)
                    assert "matrix_coefficients" in got, label
                    continue
                assert not isinstance(want, int) and not not_followed, (label, want)
                np.testing.assert_array_equal(got, want, err_msg=str(label))


# ---- both dataset paths against the JAX package ----

def high_depth_views(w, h):
    """colmap_views and grain_views (test_torch_avif) relabelled, 10 bits
    for the first half and 12 for the rest."""
    views = {**colmap_views(w, h), **grain_views(w, h)}
    return {name.replace(".avif", f"_{10 if i < len(views) // 2 else 12}.avif"):
            writers.avif_high_depth(data, 10 if i < len(views) // 2 else 12)
            for i, (name, data) in enumerate(views.items())}


@requires_avif
@pytest.mark.parametrize("resolution", [1, 2])
def test_colmap_high_depth_views_match_jax(tmp_path, monkeypatch, cxx, resolution):
    """A COLMAP dataset of 10- and 12-bit AVIF views (4:2:0, 4:4:4, 4:2:2
    limited, 4:0:0, RGBA, lossless, film grain): the Scene's cameras equal
    the JAX package's, images bit for bit."""
    from test_torch_scene import both_scenes

    w, h = 45, 37
    src = str(tmp_path / "avif")
    views = high_depth_views(w, h)
    write_colmap_dataset_of(src, views, w, h)
    jscene, scene = both_scenes(tmp_path, monkeypatch, src, eval_split=True, resolution=resolution)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == len(views)
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())


@requires_avif
@pytest.mark.parametrize("white_background", [False, True])
def test_blender_high_depth_frames_match_jax(tmp_path, monkeypatch, cxx, white_background):
    """read_blender_scene on 10- and 12-bit AVIF frames (named .png, as the
    transforms file names them): PIL's convert("RGBA") through the
    composite, bit for bit, then load_camera at -r 2."""
    frames = list(high_depth_views(45, 37).values())
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


def test_decode_split_keeps_its_keys_at_high_depth():
    """The split of a 10-bit decode names the same steps as at 8 bits."""
    split = {}
    avif.decode_avif(relabelled("grain_rgba_avis_130x67.avif@10"), "x", split=split)
    assert sorted(split) == sorted(avif.SPLIT_KEYS) and all(v >= 0 for v in split.values())
    split = {}
    avif.decode_avif(read(FIXTURES, "hbd10_grid_420_2x2.avif"), "x", split=split)
    assert sorted(split) == sorted(avif.SPLIT_KEYS + (avif.GRID_KEY,))
