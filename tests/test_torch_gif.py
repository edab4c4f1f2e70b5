"""GIF in the port (`utils/gif.py` and `gs_gif_lzw_decode` in the compiled
`csrc/image_codecs.cc`) against PIL, which the JAX package opens its
datasets with.

Tolerances: every comparison is bit-equal. For each file the port's
`image_io.open_image` must give PIL's mode ("P" or "L") and
`np.asarray(Image.open(f))` of frame 0, and `to_rgba` PIL's
`convert("RGBA")` (or raise where it raises); where PIL raises
(truncated and corrupted files), the port raises a `ValueError` naming
the file. The files are PIL's own or `tests/torch_image_writers.gif_bytes`'
(palettes, extensions, interlacing, offsets, code sizes PIL's writer does
not pick). Images are at most 128x128, made from
`np.random.default_rng(seed)`.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from gaussian_splatting_torch.scene import dataset_readers
from gaussian_splatting_torch.utils import cuda_build, image_io
from test_torch_image_forms import assert_like_pil, cxx, write_colmap_dataset_of  # noqa: F401  (cxx)
from test_torch_jpeg import fake_cxx  # noqa: F401  (a fixture)
from test_torch_webp import assert_follows_pil, pil_outcome
from torch_image_writers import gif_bytes, gif_lzw_encode

SIZES = [(1, 1), (3, 5), (17, 9), (40, 61), (128, 100)]


def indices(h, w, colours, seed):
    return np.random.default_rng(seed).integers(0, colours, (h, w)).astype(np.uint8)


def palette(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 3))


def grey(n):
    return np.repeat(np.arange(n)[:, None], 3, 1)


def forms():
    """{name: (keyword arguments of gif_bytes but the indices, PIL's mode)}."""
    return {
        "global palette": (dict(global_palette=palette(256, 1)), "P"),
        "local palette": (dict(local_palette=palette(256, 2)), "P"),
        "local over global": (dict(global_palette=palette(256, 3), local_palette=palette(256, 4)), "P"),
        "no palette": (dict(), "L"),
        "grey global palette": (dict(global_palette=grey(256)), "L"),
        "grey local under a global palette": (dict(global_palette=palette(256, 5), local_palette=grey(256)), "L"),
        "transparency": (dict(global_palette=palette(256, 6), transparency=17), "P"),
        "grey with transparency": (dict(global_palette=grey(256), transparency=200), "L"),
        "interlaced": (dict(global_palette=palette(256, 7), interlace=True), "P"),
        "GIF87a": (dict(global_palette=palette(256, 8), version=b"GIF87a"), "P"),
        "smaller than the screen": (dict(global_palette=palette(256, 9), screen=(131, 133), offset=(3, 5)), "P"),
        "smaller, transparency fill": (dict(global_palette=palette(256, 10), screen=(131, 133), offset=(3, 5),
                                            transparency=4), "P"),
        "past the screen": (dict(global_palette=palette(256, 11), screen=(2, 2), offset=(1, 1)), "P"),
        "extensions and clears": (dict(global_palette=palette(256, 12), comment=b"a comment", loop=0,
                                       clear_every=9), "P"),
    }


@pytest.mark.parametrize("form", list(forms()))
def test_gif_gives_pils_pixels(tmp_path, cxx, form):
    """Frame 0 of each form at every size, 1x1 and odd sizes among them:
    PIL's mode, indices (or greys), palette and transparency."""
    kw, mode = forms()[form]
    for i, (h, w) in enumerate(SIZES):
        got = assert_like_pil(tmp_path, gif_bytes(indices(h, w, 256, 20 + i), **kw))
        assert got.mode == mode


@pytest.mark.parametrize("bits", range(13))
def test_every_lzw_minimum_code_size(tmp_path, cxx, bits):
    """Minimum code sizes 0 to 12, as PIL's decoder takes them (indices
    past the 16-colour palette black in RGBA; below 2 bits every byte
    after a Clear)."""
    colours = 1 if bits == 0 else min(1 << bits, 256)
    for i, (h, w) in enumerate(SIZES):
        assert_like_pil(tmp_path, gif_bytes(indices(h, w, colours, 30 + i), global_palette=palette(16, bits),
                                            bits=bits, clear_every=int(bits < 2)))


@pytest.mark.parametrize("mode,transparency", [("P", None), ("P", 5), ("L", None), ("L", 5), ("RGB", None),
                                               ("1", None), ("1", 1)])
def test_pil_written_gif_gives_pils_pixels(tmp_path, cxx, mode, transparency):
    """PIL's own GIF writer (a palette quantised from RGB, grey, 1-bit)."""
    a = np.random.default_rng(40).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    im = Image.fromarray(a).convert(mode)
    buf = io.BytesIO()
    im.save(buf, "GIF", **({} if transparency is None else {"transparency": transparency}))
    assert_like_pil(tmp_path, buf.getvalue())


def test_grey_gif_under_a_global_palette_with_transparency_refuses_rgba(tmp_path, cxx):
    """PIL holds an "L" frame under a global palette as "P" and its
    convert("RGBA") with a transparency index raises; so does to_rgba,
    while the pixels are PIL's."""
    data = gif_bytes(indices(9, 11, 256, 50), global_palette=palette(256, 51), local_palette=grey(256),
                     transparency=3)
    im = Image.open(io.BytesIO(data))
    with pytest.raises(ValueError):
        im.convert("RGBA")
    path = tmp_path / "view.gif"
    path.write_bytes(data)
    got = image_io.open_image(path)
    assert got.mode == im.mode == "L"
    np.testing.assert_array_equal(got.pixels[..., 0], np.asarray(im))
    with pytest.raises(ValueError, match="convert_transparent"):
        image_io.to_rgba(got)


def damage_sources():
    return {
        "transparency and extensions": gif_bytes(indices(23, 31, 16, 60), global_palette=palette(16, 61),
                                                 transparency=3, comment=b"c", loop=1),
        "interlaced local palette": gif_bytes(indices(40, 41, 256, 62), local_palette=palette(256, 63),
                                              interlace=True, screen=(50, 45), offset=(3, 2)),
    }


@pytest.mark.parametrize("kind", list(damage_sources()))
def test_truncated_gif_raises_where_pil_raises(tmp_path, cxx, kind):
    """The file cut after every one of its bytes."""
    data = damage_sources()[kind]
    for cut in range(len(data)):
        assert_follows_pil(tmp_path, data[:cut], f"{kind} cut at {cut} of {len(data)}")


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", list(damage_sources()))
def test_corrupted_gif_follows_pil(tmp_path, cxx, kind, seed):
    """Seeded bytes flipped anywhere: PIL's pixels where PIL decodes (codes
    past a short palette, sizes that grow the screen), a ValueError naming
    the file where it raises."""
    data = damage_sources()[kind]
    rng = np.random.default_rng(70 + seed)
    for _ in range(120):
        at, flip = int(rng.integers(0, len(data))), int(rng.integers(1, 256))
        damaged = bytearray(data)
        damaged[at] ^= flip
        assert_follows_pil(tmp_path, bytes(damaged), f"{kind}: byte {at} ^ {flip}")


def literal_lzw(indices, end_after: int) -> bytes:
    """Sub-blocks of 9-bit LZW codes (minimum code size 8) that send each
    index as the first code after a Clear, with an End code after
    `end_after` indices and the rest sent on after it."""
    flat = indices.reshape(-1).astype(np.int64)
    codes = np.stack([np.full_like(flat, 256), flat], 1).reshape(-1)
    codes = np.concatenate([codes[:2 * end_after], [257], codes[2 * end_after:], [257]])
    data = np.packbits(((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8).reshape(-1), bitorder="little")
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255].tobytes()
                    for i in range(0, len(data), 255)) + b"\x00"


@pytest.mark.parametrize("side", [40, 300])
def test_early_end_code_follows_pils_reads(tmp_path, cxx, side):
    """PIL hands GifDecode the file in 64 KiB reads, and an End code before
    the frame is full returns for the next read: in a file whose image data
    spans several reads PIL decodes on past it, in a short file it raises.
    The port does both."""
    idx = indices(side, side, 256, 110)
    data = gif_bytes(idx, global_palette=palette(256, 111), bits=8, image_data=literal_lzw(idx, 500))
    assert (pil_outcome(data) is not None) == (len(data) > 2**16)
    assert_follows_pil(tmp_path, data, f"{side}x{side}, {len(data)} bytes")


def refused_files():
    idx = indices(9, 11, 4, 80)
    pal = palette(4, 81)
    body = gif_lzw_encode(idx, 2)
    return {
        "End code before the frame is full": gif_bytes(idx, global_palette=pal,
                                                       image_data=gif_lzw_encode(idx[:5], 2)),
        "a code past the table": gif_bytes(idx, global_palette=pal, image_data=b"\x02\x04\x7f\x00"),
        "data cut in a sub-block": gif_bytes(idx, global_palette=pal, image_data=body[:len(body) // 2])[:-1],
        "minimum code size 13": gif_bytes(idx, global_palette=pal, bits=13, image_data=body),
        "a frame of no pixels": gif_bytes(idx[:0], global_palette=pal, screen=(11, 9), offset=(2, 2),
                                          image_data=body),
        "no image": b"GIF89a\x0b\x00\x09\x00\x00\x00\x00;",
        "graphic control of 2 bytes": b"GIF89a\x0b\x00\x09\x00\x00\x00\x00!\xf9\x02\x01\x00\x00;",
    }


@pytest.mark.parametrize("case", list(refused_files()))
def test_gif_refusals_name_the_file(tmp_path, cxx, case):
    data = refused_files()[case]
    assert pil_outcome(data) is None
    path = tmp_path / "refused.gif"
    path.write_bytes(data)
    with pytest.raises(ValueError) as err:
        image_io.open_image(path)
    assert str(path) in str(err.value)


def test_failed_codec_build_raises_naming_the_gif(tmp_path, fake_cxx):
    """No fallback: a GIF cannot be read without the compiled codecs."""
    fake_cxx(fail=True)
    path = tmp_path / "view.gif"
    path.write_bytes(gif_bytes(indices(9, 11, 4, 90), global_palette=palette(4, 91)))
    with pytest.raises(RuntimeError, match="csrc/image_codecs.cc") as err:
        image_io.open_image(path)
    assert str(path) in str(err.value)
    assert not cuda_build.host_library_path("image_codecs").exists()


@pytest.mark.parametrize("transparency", [None, 2])
def test_colmap_refuses_a_palette_gif(tmp_path, cxx, transparency):
    """The JAX package's COLMAP path would train on a palette GIF's
    indices: the port refuses it through load_camera, naming the file as
    images.bin lists it and the mode."""
    src = str(tmp_path / "data")
    data = gif_bytes(indices(11, 13, 16, 100), global_palette=palette(16, 101), transparency=transparency)
    write_colmap_dataset_of(src, {"view.gif": data}, 13, 11)
    assert Image.open(os.path.join(src, "images", "view.gif")).mode == "P"
    info = dataset_readers.read_colmap_scene(src, None, eval_split=False)
    with pytest.raises(ValueError, match=r"'view\.gif' in .*images\.bin: .*view\.gif: .*\(mode P\)"):
        dataset_readers.load_camera(info.train_cameras[0], 1)
