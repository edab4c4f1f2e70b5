"""WebP in the port (`utils/webp.py` and the compiled `csrc/webp_decode.cc`)
against PIL, which the JAX package opens its datasets with, and WebP and
GIF views through both dataset paths against the JAX package's readers.

Tolerances: every comparison is bit-equal, lossy files included. For each
file the port's `image_io.open_image` must give PIL's mode and
`np.asarray(Image.open(f))`, and `to_rgba` PIL's `convert("RGBA")`; where
PIL raises (truncated and corrupted files), the port raises a `ValueError`
naming the file. The files are PIL's own (lossy, lossless, alpha,
animations), or VP8X files that `tests/torch_image_writers.py` builds
around PIL-written bitstreams for what PIL's options cannot pick (ALPH
compression and filters, metadata chunks, flags). Images are at most
128x128, made from `np.random.default_rng(seed)`; the decoder is built
here with the host's `c++`.
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
from gaussian_splatting_torch.utils import cuda_build, image_io
from test_torch_image_forms import assert_like_pil, cxx, smooth, write_colmap_dataset_of  # noqa: F401  (cxx)
from test_torch_jpeg import fake_cxx  # noqa: F401  (a fixture)
from test_torch_scene import assert_same_cameras, orbit_frames
from torch_image_writers import (alph_chunk, alpha_filter, gif_bytes, vp8_variant, webp_chunks, webp_simple,
                                 webp_vp8x)

SIZES = [(1, 1), (7, 13), (45, 67), (128, 97)]


def webp(a: np.ndarray, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(a)).save(buf, "WEBP", **options)
    return buf.getvalue()


def pil_outcome(data: bytes):
    """(mode, pixels with a channel axis, RGBA) by PIL, or None where PIL raises."""
    try:
        im = Image.open(io.BytesIO(data))
        a = np.asarray(im)
        return im.mode, a[..., None] if a.ndim == 2 else a, np.asarray(im.convert("RGBA"))
    except Exception:  # noqa: BLE001  (any of PIL's errors: the port must raise too)
        return None


def assert_follows_pil(tmp_path, data: bytes, label: str):
    """The port reads `data` as PIL does, or raises naming the file where
    PIL raises (any form: the port reads the signature, not the name)."""
    path = tmp_path / "view.img"
    path.write_bytes(data)
    want = pil_outcome(data)
    if want is None:
        with pytest.raises(ValueError) as err:
            image_io.open_image(path)
        assert str(path) in str(err.value), label
        return
    got = image_io.open_image(path)
    assert got.mode == want[0], label
    np.testing.assert_array_equal(got.pixels, want[1], err_msg=label)
    np.testing.assert_array_equal(image_io.to_rgba(got), want[2], err_msg=label)


def contents(h, w, c, seed):
    """Smooth waves with noise, and a few flat patches: strong and weak
    loop filtering, many segments and skipped blocks."""
    a = smooth(h, w, c, seed)
    a[h // 3:h // 2, w // 4:w // 2] = 90
    return a


# ---- lossy ----

@pytest.mark.parametrize("method", range(7))
@pytest.mark.parametrize("quality", [0, 10, 50, 90, 100])
def test_lossy_webp_gives_pils_pixels(tmp_path, cxx, quality, method):
    """VP8 at every method and qualities from 0 (strong loop filters, many
    segments) to 100, odd sizes and 1x1: PIL's RGB, fancy upsampling and
    all."""
    for i, (h, w) in enumerate(SIZES):
        got = assert_like_pil(tmp_path, webp(contents(h, w, 3, i + quality), quality=quality, method=method))
        assert got.mode == "RGB"


@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("alpha_quality", [0, 20, 60, 100])
def test_lossy_webp_with_alpha_gives_pils_pixels(tmp_path, cxx, alpha_quality, method):
    """VP8 with an ALPH chunk (compressed losslessly, filtered, levels
    reduced below alpha_quality 100): mode RGBA."""
    for i, (h, w) in enumerate(SIZES):
        a = contents(h, w, 4, 7 + i)
        a[: h // 2, :, 3] = 0
        got = assert_like_pil(tmp_path, webp(a, quality=60, alpha_quality=alpha_quality, method=method))
        assert got.mode == "RGBA"


VP8_VARIANTS = {
    "2 partitions": dict(partitions=2),
    "4 partitions": dict(partitions=4),
    "8 partitions": dict(partitions=8),
    "sharpness 3": dict(sharpness=3),
    "sharpness 7, level 40": dict(sharpness=7, level=40),
    "simple filter": dict(simple=1),
    "simple filter, level 63, sharpness 5": dict(simple=1, level=63, sharpness=5),
    "filter deltas": dict(lf_deltas=(5, -7)),
    "filter deltas, 2 partitions": dict(lf_deltas=(-20, 30), partitions=2),
    "relative segment values": dict(relative_segments=True),
    "no loop filter": dict(level=0),
}


@pytest.mark.parametrize("variant", list(VP8_VARIANTS))
def test_vp8_forms_pil_cannot_write(tmp_path, cxx, variant):
    """VP8 frames PIL wrote, coded again (tests/torch_image_writers.py's
    `vp8_variant`) with what its options cannot pick: 2, 4 or 8 token
    partitions, a loop-filter sharpness above 0, the simple filter, other
    levels, reference and mode filter deltas, relative segment values.
    Coded again unchanged, each frame gives PIL's pixels of the original."""
    for i, (h, w, quality) in enumerate([(45, 67, 50), (128, 97, 10), (33, 130, 0)]):
        vp8 = webp_chunks(webp(contents(h, w, 3, 120 + i), quality=quality))[0][1]
        same = np.asarray(Image.open(io.BytesIO(webp_simple(b"VP8 ", vp8_variant(vp8)))))
        np.testing.assert_array_equal(same, np.asarray(Image.open(io.BytesIO(webp_simple(b"VP8 ", vp8)))))
        assert_like_pil(tmp_path, webp_simple(b"VP8 ", vp8_variant(vp8, **VP8_VARIANTS[variant])))


# ---- lossless ----

def lossless_content(kind, h, w, seed):
    rng = np.random.default_rng(seed)
    if kind.endswith("colours"):
        n = int(kind.split()[0])
        palette = rng.integers(0, 256, (n, 4), dtype=np.uint8)
        return palette[(smooth(h, w, 1, seed)[..., 0].astype(np.int64) * n) // 256]
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    if kind == "repeats":  # runs and recurring colours: backward references and the colour cache
        tile = rng.integers(0, 256, (h, 5, 4), dtype=np.uint8)
        return np.tile(tile, (1, w // 5 + 1, 1))[:, :w]
    return smooth(h, w, 4, seed)


@pytest.mark.parametrize("method,quality", [(0, 0), (2, 30), (4, 75), (5, 100), (6, 90)])
@pytest.mark.parametrize("kind", ["2 colours", "4 colours", "16 colours", "256 colours", "repeats", "noise",
                                  "smooth"])
def test_lossless_webp_gives_pils_pixels(tmp_path, cxx, kind, method, quality):
    """VP8L under method / quality pairs that pick different transforms:
    colour indexing with 1-, 2- and 4-bit bundling and 8-bit indices,
    predictor, cross-colour, subtract-green, meta prefix codes, backward
    references and the colour cache; RGB and RGBA."""
    for i, (h, w) in enumerate(SIZES):
        a = lossless_content(kind, h, w, 10 * i + method)
        for c in (3, 4):
            got = assert_like_pil(tmp_path, webp(a[..., :c], lossless=True, method=method, quality=quality))
            assert got.mode == ("RGBA" if c == 4 else "RGB")


@pytest.mark.parametrize("exact", [True, False])
def test_lossless_rgba_with_transparent_pixels(tmp_path, cxx, exact):
    """exact=True keeps the colour under alpha 0, exact=False lets the
    encoder change it: either way PIL's pixels."""
    for i, (h, w) in enumerate(SIZES):
        a = smooth(h, w, 4, 20 + i)
        a[..., 3] = np.where(a[..., 0] > 128, 0, a[..., 3])
        assert_like_pil(tmp_path, webp(a, lossless=True, exact=exact))


# ---- animations and the extended format ----

@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("transparent_border", [False, True])
def test_animated_webp_gives_frame_0(tmp_path, cxx, transparent_border, lossless):
    """An animation PIL wrote (save_all): frame 0 as PIL gives it. With a
    transparent border PIL crops frame 0 to its opaque box, which lands at
    its offset on the zeroed canvas (the background colour is ignored)."""
    h, w = 40, 50
    first = contents(h, w, 4, 30)
    if transparent_border:  # transparent black around an opaque box
        box = first[11:29, 7:41].copy()
        first[:] = 0
        first[11:29, 7:41] = box
        first[11:29, 7:41, 3] = 255
        first[15:20, 10:20, 3] = 90
    else:
        first[..., 3] = 255
    second = contents(h, w, 4, 31)
    data = webp(first, save_all=True, append_images=[Image.fromarray(second)], lossless=lossless,
                background=(10, 20, 30, 40), duration=40)
    anmf = [p for k, p in webp_chunks(data) if k == b"ANMF"]
    assert len(anmf) == 2
    offset_and_size = [int.from_bytes(anmf[0][i:i + 3], "little") for i in (0, 3, 6, 9)]
    if transparent_border:
        assert offset_and_size != [0, 0, w - 1, h - 1]  # frame 0 is smaller than the canvas
    assert_like_pil(tmp_path, data)


def vp8_and_alpha(h=29, w=43, seed=3):
    a = contents(h, w, 4, seed)
    return webp_chunks(webp(a[..., :3], quality=70))[0], a[..., 3]


@pytest.mark.parametrize("compression", [0, 1])
@pytest.mark.parametrize("alpha_filter_method", range(4))
def test_alph_compressions_and_filters(tmp_path, cxx, compression, alpha_filter_method):
    """ALPH raw (0) or as a header-less VP8L stream of the filtered plane
    in green (1), under each filter: none, horizontal, vertical,
    gradient."""
    vp8, alpha = vp8_and_alpha()
    h, w = alpha.shape
    payload = None
    if compression:
        g = alpha_filter(alpha, alpha_filter_method)
        payload = webp_chunks(webp(np.stack([g, g, g], -1), lossless=True))[0][1][5:]
    data = webp_vp8x(vp8, w, h, alph=alph_chunk(alpha, alpha_filter_method, payload))
    got = assert_like_pil(tmp_path, data)
    assert got.mode == "RGBA"
    np.testing.assert_array_equal(got.pixels[..., 3], alpha)


EXIF_ORIENTATION_6 = (b"Exif\x00\x00MM\x00\x2a\x00\x00\x00\x08\x00\x01\x01\x12\x00\x03\x00\x00\x00\x01"
                      b"\x00\x06\x00\x00\x00\x00\x00\x00")


@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("chunk", ["ICCP", "EXIF", "XMP ", "unknown after", "all"])
def test_vp8x_metadata_chunks_are_skipped(tmp_path, cxx, chunk, lossless):
    """ICCP, EXIF (an Orientation of 6, which PIL does not apply to a
    WebP), XMP and unknown chunks before or after the image."""
    a = contents(21, 35, 4, 40)
    image = webp_chunks(webp(a[..., :3], lossless=lossless, quality=50))[0]
    chunks = {"ICCP": (b"ICCP", b"\x00" * 131), "EXIF": (b"EXIF", EXIF_ORIENTATION_6),
              "XMP ": (b"XMP ", b'<x:xmpmeta xmlns:x="adobe:ns:meta/"/>')}
    if chunk == "unknown after":
        data = webp_vp8x(image, 35, 21, extra_after=[(b"ABCD", b"xyz")])
    elif chunk == "all":
        data = webp_vp8x(image, 35, 21, extra=list(chunks.values()), extra_after=[(b"ABCD", b"xyz")])
    else:
        data = webp_vp8x(image, 35, 21, extra=[chunks[chunk]])
    assert_like_pil(tmp_path, data)


@pytest.mark.parametrize("case", ["ALPH without the alpha flag", "alpha flag without ALPH",
                                  "VP8L with alpha, no flag", "VP8L without alpha, flag"])
def test_vp8x_mode_follows_pil(tmp_path, cxx, case):
    """PIL's mode is libwebp's WebPGetFeatures over the file: the VP8X
    flag, VP8L's header bit in its place, or an ALPH chunk (which the
    demuxer drops without the flag: alpha 255)."""
    vp8, alpha = vp8_and_alpha()
    h, w = alpha.shape
    a = contents(h, w, 4, 41)
    if case == "ALPH without the alpha flag":
        data = webp_vp8x(vp8, w, h, alph=alph_chunk(alpha, 1), flags=0)
    elif case == "alpha flag without ALPH":
        data = webp_vp8x(vp8, w, h, flags=0x10)
    elif case == "VP8L with alpha, no flag":
        data = webp_vp8x(webp_chunks(webp(a, lossless=True))[0], w, h, flags=0)
    else:
        data = webp_vp8x(webp_chunks(webp(a[..., :3], lossless=True))[0], w, h, flags=0x10)
    assert_like_pil(tmp_path, data)


# ---- the 1080p files chip_smoke.py times ----

WEBP_1080P = os.path.join(os.path.dirname(__file__), "fixtures", "torch_webp")
with open(os.path.join(WEBP_1080P, "sha256.json")) as _f:
    WEBP_1080P_READINGS = json.load(_f)


@pytest.mark.parametrize("name", sorted(WEBP_1080P_READINGS))
def test_1080p_webp_fixture_hashes_are_pils(cxx, name):
    """PIL's reading of each committed 1920x1080 file has the mode, shape
    and SHA-256 committed beside it (which chip_smoke.py holds the port to
    on the card's machine), and so has the port's."""
    import hashlib

    want = WEBP_1080P_READINGS[name]
    path = os.path.join(WEBP_1080P, name)
    im = Image.open(path)
    for mode, px in ((im.mode, np.asarray(im)), ((got := image_io.open_image(path)).mode, got.pixels)):
        assert mode == want["mode"] and list(px.shape) == want["shape"]
        assert hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest() == want["sha256"]


# ---- damage ----

def damage_sources():
    a = contents(33, 47, 4, 50)
    first = a.copy()
    first[..., 3] = 0
    first[5:25, 6:40, 3] = 255
    return {
        "lossy": webp(a[..., :3], quality=60),
        "lossy alpha": webp(a, quality=60),
        "lossless": webp(a, lossless=True),
        "animation": webp(first, save_all=True, append_images=[Image.fromarray(a)]),
    }


@pytest.mark.parametrize("kind", list(damage_sources()))
def test_truncated_webp_raises_where_pil_raises(tmp_path, cxx, kind):
    """The file cut after every byte of its headers and at 40 seeded
    points beyond: the port raises naming the file wherever PIL raises."""
    data = damage_sources()[kind]
    rng = np.random.default_rng(60)
    cuts = sorted(set(range(48)) | set(rng.integers(48, len(data), 40).tolist()))
    for cut in cuts:
        assert_follows_pil(tmp_path, data[:cut], f"{kind} cut at {cut} of {len(data)}")


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", list(damage_sources()))
def test_corrupted_webp_follows_pil(tmp_path, cxx, kind, seed):
    """Seeded bytes flipped anywhere (container, headers, partitions,
    prefix codes): PIL's pixels where PIL decodes, a ValueError naming the
    file where it raises."""
    data = damage_sources()[kind]
    rng = np.random.default_rng(70 + seed)
    for _ in range(60):
        at, flip = int(rng.integers(0, len(data))), int(rng.integers(1, 256))
        damaged = bytearray(data)
        damaged[at] ^= flip
        assert_follows_pil(tmp_path, bytes(damaged), f"{kind}: byte {at} ^ {flip}")


@pytest.mark.parametrize("quality", [0, 60])
def test_alph_stream_damaged_at_its_end_follows_pil(tmp_path, cxx, quality):
    """An ALPH stream with colour indexing only and green-only codes is
    decoded by libwebp's DecodeAlphaData, which fails on reading past the
    data only while indices are still missing, reading the window as its
    bit reader holds it: every bit of the stream's last 12 bytes flipped,
    and the stream cut by 1 to 12 bytes."""
    a = contents(37, 45, 4, 130)
    a[..., 3] = (a[..., 3] // 64) * 85  # four levels: a palette, so colour indexing
    chunks = dict(webp_chunks(webp(a, quality=60, alpha_quality=quality)))
    alph, vp8 = chunks[b"ALPH"], chunks[b"VP8 "]
    for at in range(len(alph) - 12, len(alph)):
        for bit in range(8):
            damaged = bytearray(alph)
            damaged[at] ^= 1 << bit
            assert_follows_pil(tmp_path, webp_vp8x((b"VP8 ", vp8), 45, 37, alph=bytes(damaged)), f"{at}.{bit}")
    for cut in range(1, 13):
        assert_follows_pil(tmp_path, webp_vp8x((b"VP8 ", vp8), 45, 37, alph=alph[:-cut]), f"cut {cut}")


def refused_files():
    vp8, alpha = vp8_and_alpha()
    h, w = alpha.shape
    lossless = webp_chunks(webp(contents(h, w, 4, 80), lossless=True))[0]
    simple = webp(contents(h, w, 3, 81), quality=50)
    return {
        "RIFF size past the file": simple[:4] + (len(simple) + 10).to_bytes(4, "little") + simple[8:],
        "reserved VP8X flag": webp_vp8x(vp8, w, h, flags=0x01),
        "canvas not the frame's size": webp_vp8x(vp8, w + 1, h),
        "ALPH before VP8L": webp_vp8x(lossless, w, h, alph=alph_chunk(alpha, 0)),
        "ALPH after the image": webp_vp8x(vp8, w, h, flags=0x10, extra_after=[(b"ALPH", alph_chunk(alpha, 0))]),
        "second VP8X": webp_vp8x(vp8, w, h, extra=[(b"VP8X", bytes(10))]),
        "ALPH compression 2": webp_vp8x(vp8, w, h, alph=b"\x02" + bytes(w * h)),
        "raw ALPH too short": webp_vp8x(vp8, w, h, alph=b"\x00" + bytes(w * h - 1)),
        "not a key frame": webp_vp8x((vp8[0], bytes([vp8[1][0] | 1]) + vp8[1][1:]), w, h),
        "VP8L version 1": webp_vp8x((lossless[0], lossless[1][:4] + bytes([lossless[1][4] | 0x20])
                                     + lossless[1][5:]), w, h),
    }


@pytest.mark.parametrize("case", list(refused_files()))
def test_webp_refusals_name_the_file(tmp_path, cxx, case):
    """Files libwebp refuses: PIL raises, and the port raises a ValueError
    naming the file."""
    data = refused_files()[case]
    assert pil_outcome(data) is None
    path = tmp_path / "refused.webp"
    path.write_bytes(data)
    with pytest.raises(ValueError) as err:
        image_io.open_image(path)
    assert str(path) in str(err.value)


def test_failed_webp_build_raises_naming_the_file(tmp_path, fake_cxx):
    """No fallback: a WebP cannot be read without the compiled decoder,
    and the error names the file and the source."""
    fake_cxx(fail=True)
    path = tmp_path / "view.webp"
    path.write_bytes(webp(contents(9, 11, 3, 90), quality=80))
    with pytest.raises(RuntimeError, match="csrc/webp_decode.cc") as err:
        image_io.open_image(path)
    assert str(path) in str(err.value)
    assert not cuda_build.host_library_path("webp_decode").exists()


# ---- the dataset readers ----

def colmap_views(w, h):
    a = contents(h, w, 4, 100)
    grey = np.repeat(np.arange(256)[:, None], 3, 1)
    return {
        "v_lossy.webp": webp(a[..., :3], quality=85),
        "v_lossy_alpha.webp": webp(a, quality=85, alpha_quality=70),
        "v_lossless_rgba.webp": webp(a, lossless=True),
        "v_lossless_rgb.webp": webp(a[..., :3], lossless=True),
        "v_grey.gif": gif_bytes(a[..., 1], global_palette=grey, interlace=True),
        "v_grey_transparent.gif": gif_bytes(a[..., 2], global_palette=grey, transparency=3),
    }


@pytest.mark.parametrize("resolution", [1, 2])
def test_colmap_webp_and_gif_views_match_jax(tmp_path, monkeypatch, cxx, resolution):
    """A COLMAP dataset of WebP views (lossy and lossless, RGB and RGBA)
    and grey GIFs (mode L): the Scene's cameras equal the JAX package's,
    images bit for bit."""
    from test_torch_scene import both_scenes

    w, h = 45, 37
    src = str(tmp_path / "forms")
    views = colmap_views(w, h)
    write_colmap_dataset_of(src, views, w, h)
    modes = {Image.open(os.path.join(src, "images", n)).mode for n in views}
    assert modes == {"RGB", "RGBA", "L"}
    jscene, scene = both_scenes(tmp_path, monkeypatch, src, eval_split=True, resolution=resolution)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == len(views)
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())


def test_train_cli_on_webp_and_gif_colmap_dataset(tmp_path, monkeypatch, cxx):
    """The train CLI on a COLMAP dataset of WebP (RGB, RGBA) and grey GIF
    views: a few CPU steps, on the JAX package's Scene's cameras and
    images (tensorboard left out: the CLI runs without it)."""
    import sys

    from gaussian_splatting_torch.cli import train
    from test_torch_scene import JaxScene, jgeneral

    monkeypatch.setattr(sys, "stdout", sys.stdout)  # safe_state replaces it
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w, h = 45, 37
    src = str(tmp_path / "data")
    views = colmap_views(w, h)
    write_colmap_dataset_of(src, views, w, h)
    shutil.copytree(src, tmp_path / "jax_data")
    flags = ["--iterations", "3", "--test_iterations", "3", "--save_iterations", "3", "--densify_from_iter",
             "1000", "--eval", "--disable_viewer", "--quiet"]
    scene, trainer = train.main(["-s", src, "-m", str(tmp_path / "model"), *flags], device="cpu")
    assert trainer.iteration == 3 and all(np.isfinite(step["loss"]) for step in trainer.history)
    jgeneral.safe_state(silent=True)
    jscene = JaxScene(source_path=str(tmp_path / "jax_data"), model_path=str(tmp_path / "jax_model"),
                      eval_split=True)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == len(views)
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())


def blender_frames(w, h):
    """WebP frames (lossy, lossy with alpha, lossless RGBA, an animation)
    and palette GIFs (with and without a transparency index, interlaced,
    a local palette, smaller than the screen), named .png as the
    transforms file names them."""
    a = contents(h, w, 4, 110)
    a[..., 3] = np.where(a[..., 3] > 150, 255, np.where(a[..., 3] < 80, 0, a[..., 3]))
    rng = np.random.default_rng(111)
    palette = rng.integers(0, 256, (256, 3))
    idx = (a[..., 0].astype(np.int64) * 37 + a[..., 1]) % 256
    first = a.copy()
    first[:4, :, 3] = 0
    return [
        webp(a[..., :3], quality=80),
        webp(a, quality=80, alpha_quality=50),
        webp(a, lossless=True),
        webp(first, save_all=True, append_images=[Image.fromarray(a)]),
        gif_bytes(idx, global_palette=palette, transparency=7),
        gif_bytes(idx, global_palette=palette, interlace=True),
        gif_bytes(idx[2:-3, 4:], local_palette=palette[::-1], screen=(w, h), offset=(4, 2), transparency=0),
    ]


@pytest.mark.parametrize("white_background", [False, True])
def test_blender_webp_and_gif_frames_match_jax(tmp_path, monkeypatch, cxx, white_background):
    """read_blender_scene on WebP and palette-GIF frames: PIL's
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
    assert Image.open(d / "train" / "r_4.png").mode == "P"
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
