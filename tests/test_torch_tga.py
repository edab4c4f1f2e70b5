"""TGA in the port (`utils/tga.py` and `gs_tga_rle_decode` in the compiled
`csrc/image_codecs.cc`) against PIL, which the JAX package opens its
datasets with.

Tolerances: every comparison is bit-equal. For each file the port's
`image_io.open_image` must give PIL's mode and `np.asarray(Image.open(f))`
(a channel axis kept), and `to_rgba` PIL's `convert("RGBA")`; where PIL
raises (truncations, a run across a row's end, 32-bit colour maps, types
and depths it has no raw mode for), the port raises a `ValueError` naming
the file. The files are PIL's own where PIL writes the form, else
`tests/torch_image_writers.tga_bytes`' (every type, depth, origin and
colour map, RLE packets across rows). Images are at most 67x45, made
from `np.random.default_rng(seed)`.
"""

import io
import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from gaussian_splatting_tpu.scene import dataset_readers as jreaders
from gaussian_splatting_torch.scene import dataset_readers
from gaussian_splatting_torch.utils import cuda_build, eps, image_io, tga
from test_torch_image_forms import assert_follows_pil, cxx, write_colmap_dataset_of  # noqa: F401  (cxx)
from test_torch_jpeg import fake_cxx  # noqa: F401  (a fixture)
from test_torch_scene import assert_same_cameras, orbit_frames
from torch_image_writers import tga_bytes, tga_rle

ORIGINS = {"bottom left": 0x00, "bottom right": 0x10, "top left": 0x20, "top right": 0x30}
# (image type of the raw form, bits a pixel) -> channels of the stored pixels
DEPTHS = {(2, 16): 2, (2, 24): 3, (2, 32): 4, (3, 8): 1, (3, 16): 2, (3, 1): 0}


def pixel_rows(h, w, depth, seed, runs=True):
    """(h, row bytes) stored rows at `depth` bits, with runs of equal pixels
    where `runs` (what RLE meets)."""
    rng = np.random.default_rng(seed)
    if depth == 1:
        return np.packbits(rng.integers(0, 2, (h, w)).astype(np.uint8), axis=1)
    nb = depth // 8
    px = rng.integers(0, 256, (h, w, nb)).astype(np.uint8)
    if runs:
        px[:, 1::2] = px[:, 0:w - 1:2]  # pairs of equal pixels
        px[h // 2:, :w // 2] = px[0, 0]
    return px.reshape(h, w * nb)


@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("orientation", [1, -1])
@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "RGB", "RGBA"])
def test_pil_written_tga_gives_pils_pixels(tmp_path, cxx, mode, orientation, rle):
    """What PIL's writer makes: every mode it writes, bottom-up and
    top-down, raw and RLE (a 1-bit RLE file PIL writes and cannot read:
    the port raises too)."""
    rng = np.random.default_rng(2)
    a = (rng.integers(0, 4, (45, 67, 3)) * 60).astype(np.uint8)
    im = {"1": Image.fromarray(a[..., 0] > 60), "L": Image.fromarray(a[..., 0]),
          "LA": Image.fromarray(a[..., :2].copy(), "LA"), "P": Image.fromarray(a).quantize(7),
          "RGB": Image.fromarray(a), "RGBA": Image.fromarray(np.dstack([a, a[..., :1]]))}[mode]
    buf = io.BytesIO()
    im.save(buf, "TGA", rle=rle, orientation=orientation)
    assert_follows_pil(tmp_path, buf.getvalue(), f"{mode} rle {rle}")


@pytest.mark.parametrize("origin", list(ORIGINS))
@pytest.mark.parametrize("form", list(DEPTHS))
def test_every_type_depth_and_origin_gives_pils_pixels(tmp_path, cxx, form, origin):
    """Image types 2 and 3 at every depth PIL reads and types 10 and 11
    (RLE) beside them, in all four origins (0x20: first row on top; 0x10:
    flipped left to right after decoding), an ID field before the pixels."""
    image_type, depth = form
    h, w = 23, 29
    rows = pixel_rows(h, w, depth, depth + image_type)
    flags = ORIGINS[origin]
    got = assert_follows_pil(tmp_path, tga_bytes(rows, w, h, image_type, depth, flags, ident=b"id"), "raw")
    assert got is not None
    assert_follows_pil(tmp_path, tga_bytes(rows, w, h, image_type + 8, depth, flags,
                                        rle=tga_rle(rows, max(depth // 8, 1))), "rle")


@pytest.mark.parametrize("start", [0, 5])
@pytest.mark.parametrize("map_depth", [16, 24, 32])
@pytest.mark.parametrize("image_type", [1, 9, 3, 11])
def test_colour_maps_give_pils_pixels(tmp_path, cxx, image_type, map_depth, start):
    """Colour-mapped types 1 and 9 (mode P) and grey types 3 and 11 with a
    map (mode L, converted through the map as PIL's core "P" image is):
    16-bit maps (RGBA, alpha 0 where the top bit is set), 24-bit maps, a
    first index `start` (that many opaque black entries first), indices
    past the map black; 32-bit maps raise in PIL and in the port."""
    h, w = 19, 23
    n = 40
    entries = np.random.default_rng(map_depth + start).integers(0, 256, n * map_depth // 8).astype(np.uint8)
    rows = np.random.default_rng(3).integers(0, start + n + 9, (h, w)).astype(np.uint8)
    rle = tga_rle(rows, 1) if image_type & 8 else None
    data = tga_bytes(rows, w, h, image_type, 8, 0x20, colormap=entries.tobytes(), map_depth=map_depth,
                     map_start=start, rle=rle)
    got = assert_follows_pil(tmp_path, data, f"type {image_type} map {map_depth}")
    assert (got is None) == (map_depth == 32)


def test_grey_alpha_with_a_colour_map_follows_pil(tmp_path, cxx):
    """A 16-bit grey + alpha image with a map: PIL's core holds it as "PA",
    whose RGBA takes the map's colours and the image's own alpha."""
    rows = np.random.default_rng(4).integers(0, 30, (7, 9, 2)).astype(np.uint8).reshape(7, 18)
    for map_depth in (16, 24):
        entries = np.random.default_rng(5).integers(0, 256, 20 * map_depth // 8).astype(np.uint8).tobytes()
        got = assert_follows_pil(tmp_path, tga_bytes(rows, 9, 7, 3, 16, 0x20, colormap=entries, map_depth=map_depth),
                              str(map_depth))
        assert got.mode == "LA" and got.palette is not None


RLE_QUIRKS = {  # PIL's TgaRleDecode on each: pixels or a raise
    "raw packet across rows": bytes([4, 1, 2, 3, 4, 5, 0, 6]),
    "raw packet across three rows": bytes([8] + list(range(10, 19))),
    "raw packet past the last row": bytes([7] + list(range(10, 18))),
    "run across a row's end": bytes([0x80 | 3, 9, 0x80, 7]),
    "run filling rows exactly": bytes([0x80 | 2, 9, 0x80 | 2, 7, 0x82, 3]),
    "data past the image": bytes([0x82, 1, 0x82, 2, 0x82, 3]) + bytes(40),
    "data ending in a run": bytes([0x81, 1, 0x80]),
    "data ending in a raw packet": bytes([0x81, 1, 1, 5]),
    "no data": b"",
}


@pytest.mark.parametrize("quirk", list(RLE_QUIRKS))
@pytest.mark.parametrize("origin", [0x00, 0x30])
def test_rle_quirks_follow_pil(tmp_path, cxx, quirk, origin):
    data = tga_bytes(None, 3, 3, 11, 8, origin, rle=RLE_QUIRKS[quirk])
    assert_follows_pil(tmp_path, data, quirk)


def test_rle_across_rows_and_long_runs(tmp_path, cxx):
    """Raw packets that run on across rows and runs of 128 pixels on every
    depth, against the same pixels raw."""
    for (image_type, depth), _ in DEPTHS.items():
        if depth == 1:
            continue
        rows = pixel_rows(31, 300, depth, depth, runs=True)
        rows[5] = rows[5, :depth // 8].tolist() * 300  # a row of one colour: runs of 128
        raw = tga_bytes(rows, 300, 31, image_type, depth)
        rle = tga_bytes(rows, 300, 31, image_type + 8, depth, rle=tga_rle(rows, depth // 8, cross_rows=True))
        got = assert_follows_pil(tmp_path, rle, f"{image_type} {depth}")
        path = tmp_path / "raw.tga"
        path.write_bytes(raw)
        np.testing.assert_array_equal(got.pixels, image_io.open_image(path).pixels)


def refused_files():
    rows = pixel_rows(3, 4, 24, 6)
    return {
        "image type 4": tga_bytes(rows, 4, 3, 4, 24),
        "image type 0 (no image)": tga_bytes(rows, 4, 3, 0, 24),
        "true colour at 8 bits": tga_bytes(rows[:, :4], 4, 3, 2, 8),
        "grey at 24 bits": tga_bytes(rows, 4, 3, 3, 24),
        "colour-mapped at 16 bits": tga_bytes(rows[:, :8], 4, 3, 1, 16, colormap=bytes(6)),
        "colour-mapped without a map": tga_bytes(rows[:, :4], 4, 3, 1, 8),
        "RLE colour-mapped without a map": tga_bytes(rows[:, :4], 4, 3, 9, 8, rle=tga_rle(rows[:, :4], 1)),
        "a map on an RGB image": tga_bytes(rows, 4, 3, 2, 24, colormap=bytes(6)),
        "a map on a 1-bit image": tga_bytes(np.zeros((3, 1), np.uint8), 4, 3, 3, 1, colormap=bytes(6)),
        "a map of 8-bit entries": tga_bytes(rows[:, :4], 4, 3, 1, 8, colormap=bytes(2), map_depth=8),
        "a map of 257 entries": tga_bytes(rows[:, :4], 4, 3, 1, 8, colormap=bytes(3 * 250), map_start=7),
        "a map cut by the file's end": tga_bytes(None, 4, 3, 1, 8, colormap=bytes(3 * 10), rle=b"")[:-12],
        "1-bit RLE": tga_bytes(None, 9, 2, 11, 1, rle=bytes([0x81, 0xFF, 0x81, 0x0F])),
        "truncated raw pixels": tga_bytes(rows, 4, 3, 2, 24)[:-1],
        "zero width": tga_bytes(rows, 0, 3, 2, 24),
        "15 bits": tga_bytes(rows[:, :8], 4, 3, 2, 15),
        "a 17-byte header": tga_bytes(rows, 4, 3, 2, 24)[:17],
    }


@pytest.mark.parametrize("case", list(refused_files()))
def test_tga_refusals_name_the_file(tmp_path, cxx, case):
    data = refused_files()[case]
    assert assert_follows_pil(tmp_path, data, case) is None


def test_no_other_format_is_taken_for_a_tga(tmp_path, cxx):
    """TGA has no signature and PIL tries it after its other formats: no
    file of a format the port reads passes TGA's header checks, nor do the
    files PIL writes in the other formats. Those the port reads (ICO, PCX,
    SGI, QOI, DIB, DDS, BLP, ICNS) read as PIL reads them; EPS raises
    naming Ghostscript where there is none, as PIL does; the others each
    raise, naming the formats the port reads."""
    from test_torch_image_forms import FIXTURES

    folders = [FIXTURES, os.path.join(os.path.dirname(FIXTURES), "torch_webp"),
               os.path.join(os.path.dirname(FIXTURES), "torch_jpeg")]
    heads = [open(os.path.join(d, f), "rb").read(18) for d in folders
             for f in os.listdir(d) if not f.endswith((".npz", ".py", ".json"))]
    a = np.random.default_rng(7).integers(0, 256, (20, 24, 3)).astype(np.uint8)
    read = ("ICO", "PCX", "SGI", "QOI", "DIB", "DDS", "BLP", "ICNS")
    for fmt in ("PNG", "JPEG", "PPM", "ICO", "PCX", "SGI", "IM", "DDS", "QOI", "BLP", "DIB", "ICNS", "EPS", "XBM",
                "MSP", "SPIDER"):
        im = Image.fromarray(a).convert({"XBM": "1", "MSP": "1", "BLP": "P", "SPIDER": "F", "ICNS": "RGBA"}
                                        .get(fmt, "RGB"))
        buf = io.BytesIO()
        im.save(buf, fmt)
        heads.append(buf.getvalue()[:18])
        if fmt in read:
            assert assert_follows_pil(tmp_path, buf.getvalue(), fmt) is not None, fmt
        elif fmt == "EPS" and not eps.has_ghostscript():
            path = tmp_path / "other.eps"
            path.write_bytes(buf.getvalue())
            with pytest.raises(ValueError, match="Ghostscript"):
                image_io.open_image(path)
        elif fmt not in ("PNG", "JPEG", "PPM", "EPS"):
            path = tmp_path / f"other.{fmt.lower()}"
            path.write_bytes(buf.getvalue())
            with pytest.raises(ValueError, match="not a PNG, JPEG, BMP, DIB, TIFF, WebP, GIF, PPM / PGM / PBM / PFM, "
                                                 "TGA, JPEG 2000, QOI, PCX / DCX, SGI, ICO / CUR, PSD, DDS, AVIF, BLP, "
                                                 "FITS, FLI / FLC, FTEX, GBR, ICNS or EPS file"):
                image_io.open_image(path)
    assert len(heads) > 30
    assert not any(tga.looks_like_tga(h) for h in heads)


def test_failed_codec_build_raises_naming_the_tga(tmp_path, fake_cxx):
    """No fallback: an RLE TGA cannot be read without the compiled codecs;
    a raw one needs no build."""
    fake_cxx(fail=True)
    rows = pixel_rows(5, 6, 24, 8)
    path = tmp_path / "view.tga"
    path.write_bytes(tga_bytes(rows, 6, 5, 10, 24, rle=tga_rle(rows, 3)))
    with pytest.raises(RuntimeError, match="csrc/image_codecs.cc") as err:
        image_io.open_image(path)
    assert str(path) in str(err.value)
    assert not cuda_build.host_library_path("image_codecs").exists()
    path.write_bytes(tga_bytes(rows, 6, 5, 2, 24))
    assert image_io.open_image(path).mode == "RGB"


# ---- the dataset readers ----

def colmap_views(w, h):
    """TGA views whose np.asarray is the picture (L, RGB, RGBA)."""
    rgb = pixel_rows(h, w, 24, 10)
    rgba = pixel_rows(h, w, 32, 11)
    grey = pixel_rows(h, w, 8, 12)
    return {
        "v_rgb_raw.tga": tga_bytes(rgb, w, h, 2, 24, 0x00),
        "v_rgb_rle_top_right.tga": tga_bytes(rgb, w, h, 10, 24, 0x30, rle=tga_rle(rgb, 3)),
        "v_rgba_rle.tga": tga_bytes(rgba, w, h, 10, 32, 0x28, rle=tga_rle(rgba, 4)),
        "v_rgba_16bit.tga": tga_bytes(pixel_rows(h, w, 16, 13), w, h, 2, 16, 0x20),
        "v_grey_rle.tga": tga_bytes(grey, w, h, 11, 8, 0x10, rle=tga_rle(grey, 1)),
    }


@pytest.mark.parametrize("resolution", [1, 2])
def test_colmap_tga_views_match_jax(tmp_path, monkeypatch, cxx, resolution):
    """A COLMAP dataset of TGA views (raw and RLE, every origin, 16-, 24-
    and 32-bit colour, grey): the Scene's cameras equal the JAX package's,
    images bit for bit."""
    from test_torch_scene import both_scenes

    w, h = 45, 37
    src = str(tmp_path / "forms")
    write_colmap_dataset_of(src, colmap_views(w, h), w, h)
    jscene, scene = both_scenes(tmp_path, monkeypatch, src, eval_split=True, resolution=resolution)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == 5
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())


def refused_views():
    rows = pixel_rows(11, 13, 8, 20)
    la = pixel_rows(11, 13, 16, 21)
    return {
        "colour-mapped": (tga_bytes(rows, 13, 11, 1, 8, colormap=bytes(range(90)), map_depth=24), "P"),
        "colour-mapped RLE": (tga_bytes(rows, 13, 11, 9, 8, colormap=bytes(range(60)), map_depth=16,
                                        rle=tga_rle(rows, 1)), "P"),
        "1-bit": (tga_bytes(pixel_rows(11, 13, 1, 22), 13, 11, 3, 1), "1"),
        "grey + alpha": (tga_bytes(la, 13, 11, 3, 16), "LA"),
        "grey with a colour map": (tga_bytes(rows, 13, 11, 3, 8, colormap=bytes(range(60)), map_depth=24), "L"),
    }


@pytest.mark.parametrize("form", list(refused_views()))
def test_colmap_refuses_tga_modes_that_are_not_the_picture(tmp_path, cxx, form):
    """The JAX package's COLMAP path would train on np.asarray of these
    (indices, 0 or 1, two channels; a grey image with a map, which PIL
    holds as "P", gives its indices and raises in PIL's resize): the port
    refuses each through load_camera, naming the file as images.bin lists
    it and the mode."""
    data, mode = refused_views()[form]
    src = str(tmp_path / "data")
    write_colmap_dataset_of(src, {"view.tga": data}, 13, 11)
    assert Image.open(os.path.join(src, "images", "view.tga")).mode == mode
    info = dataset_readers.read_colmap_scene(src, None, eval_split=False)
    with pytest.raises(ValueError, match=rf"'view\.tga' in .*images\.bin: .*view\.tga: .*\(mode {mode}\)"):
        dataset_readers.load_camera(info.train_cameras[0], 1)


def blender_scenes(tmp_path, monkeypatch, frames, white_background, jax_readers, port_readers):
    """read_blender_scene of both packages on `frames` (bytes, named .png
    as the transforms file names them): PIL's convert("RGBA") through the
    composite, bit for bit, then load_camera at -r 2."""
    d = tmp_path / "scene"
    (d / "train").mkdir(parents=True)
    listing = []
    for i, data in enumerate(frames):
        (d / "train" / f"r_{i}.png").write_bytes(data)
        listing.append({"file_path": f"./train/r_{i}", "transform_matrix": orbit_frames(len(frames))[i]})
    (d / "transforms_train.json").write_text(json.dumps({"camera_angle_x": 0.69, "frames": listing}))
    monkeypatch.setenv("GS_TPU_BLENDER_INIT_POINTS", "50")
    infos = []
    for pkg, name in ((jax_readers, "jax"), (port_readers, "port")):
        shutil.copytree(d, tmp_path / name)
        np.random.seed(3)
        infos.append(pkg.read_blender_scene(str(tmp_path / name), white_background, eval_split=False))
    want, got = infos
    assert len(got.train_cameras) == len(frames)
    for i, (g, wnt) in enumerate(zip(got.train_cameras, want.train_cameras)):
        np.testing.assert_array_equal(g.image, np.asarray(wnt.image), err_msg=f"frame {i}")
        assert (g.width, g.height, g.fovx, g.fovy) == (wnt.width, wnt.height, wnt.fovx, wnt.fovy)
        assert_same_cameras([port_readers.load_camera(g, 2)], [jax_readers.load_camera(wnt, 2)])


@pytest.mark.parametrize("white_background", [False, True])
def test_blender_tga_frames_match_jax(tmp_path, monkeypatch, cxx, white_background):
    """read_blender_scene on frames in every TGA form: 32- and 16-bit RGBA
    raw and RLE, colour-mapped with 16- and 24-bit maps, grey, grey +
    alpha, 1-bit, a grey image with a map."""
    w, h = 29, 23
    rgba = pixel_rows(h, w, 32, 40)
    idx = (pixel_rows(h, w, 8, 41) % 50).astype(np.uint8)
    la = pixel_rows(h, w, 16, 42)
    frames = [tga_bytes(rgba, w, h, 2, 32, 0x08), tga_bytes(rgba, w, h, 10, 32, 0x38, rle=tga_rle(rgba, 4)),
              tga_bytes(pixel_rows(h, w, 16, 43), w, h, 10, 16, 0x20, rle=tga_rle(pixel_rows(h, w, 16, 43), 2)),
              tga_bytes(idx, w, h, 1, 8, colormap=bytes(range(150)), map_depth=24, map_start=3),
              tga_bytes(idx, w, h, 9, 8, 0x30, colormap=bytes(range(100)), map_depth=16, rle=tga_rle(idx, 1)),
              tga_bytes(idx, w, h, 11, 8, rle=tga_rle(idx, 1)), tga_bytes(la, w, h, 3, 16, 0x20),
              tga_bytes(pixel_rows(h, w, 1, 44), w, h, 3, 1),
              tga_bytes(idx, w, h, 3, 8, colormap=bytes(range(100)), map_depth=16)]
    blender_scenes(tmp_path, monkeypatch, frames, white_background, jreaders, dataset_readers)
