"""PPM, PGM, PBM and PFM in the port (`utils/ppm.py`) against PIL, which the
JAX package opens its datasets with.

Tolerances: every comparison is bit-equal (NaN equal to NaN in mode "F").
For each file the port's `image_io.open_image` must give PIL's mode and
`np.asarray(Image.open(f))` (a channel axis kept, the same dtype), and
`to_rgba` PIL's `convert("RGBA")`; where PIL raises (truncations, bad
headers, samples over maxval, the PF and P7 magics PIL 12 does not read),
the port raises a `ValueError` naming the file. The files are PIL's own
where PIL writes the form (P4, P5 at 255 and 65535, P6, Pf), else
`tests/torch_image_writers.pnm_bytes`' (the plain formats, other maxvals,
PIL's extension magics, comments). Images are at most 67x45 (one plain
file spans PIL's 1 MiB reads), made from `np.random.default_rng(seed)`.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from gaussian_splatting_tpu.scene import dataset_readers as jreaders
from gaussian_splatting_torch.scene import dataset_readers
from gaussian_splatting_torch.utils import image_io, ppm
from test_torch_image_forms import assert_follows_pil, write_colmap_dataset_of
from test_torch_scene import assert_same_cameras
from test_torch_webp import pil_outcome
from torch_image_writers import pnm_bytes

MAXVALS = [1, 100, 255, 1000, 65535]
# magic -> bands (PIL's extensions included)
MAGICS = {b"P2": 1, b"P3": 3, b"P5": 1, b"P6": 3, b"P0CMYK": 4, b"PyP": 1, b"PyRGBA": 4, b"PyCMYK": 4}


def samples(shape, top, seed):
    return np.random.default_rng(seed).integers(0, top + 1, shape)


def assert_refused_like_pil(tmp_path, data: bytes, match: str):
    assert pil_outcome(data) is None
    path = tmp_path / "refused.ppm"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match) as err:
        image_io.open_image(path)
    assert str(path) in str(err.value)


@pytest.mark.parametrize("mode", ["1", "L", "I", "I;16", "RGB", "RGBA", "F"])
def test_pil_written_files_give_pils_pixels(tmp_path, mode):
    """What PIL's own writer makes: P4, P5 (8-bit, and 16-bit from "I"),
    P6 (RGBA loses its alpha), Pf."""
    rng = np.random.default_rng(1)
    if mode == "F":
        im = Image.fromarray(rng.normal(100, 150, (45, 67)).astype(np.float32))
    elif mode in ("I", "I;16"):
        im = Image.fromarray(rng.integers(0, 65536, (45, 67)).astype(np.uint16)).convert(mode)
    elif mode == "1":
        im = Image.fromarray(rng.integers(0, 2, (45, 67)).astype(bool))
    else:
        im = Image.fromarray(rng.integers(0, 256, (45, 67, len(mode))).astype(np.uint8).squeeze(), mode)
    buf = io.BytesIO()
    im.save(buf, "PPM")
    got = assert_follows_pil(tmp_path, buf.getvalue(), mode)
    assert got is not None


@pytest.mark.parametrize("maxval", MAXVALS)
@pytest.mark.parametrize("magic", list(MAGICS))
def test_every_magic_and_maxval_gives_pils_pixels(tmp_path, magic, maxval):
    """Binary and plain samples at every maxval: as stored at 255, 16-bit
    P5 raw into "I" at 65535, else round(value / maxval * out_max) (plain
    P2 / P5 over 255 into "I" at 0..65535), samples over maxval in binary
    files clipped."""
    bands = MAGICS[magic]
    top = maxval if magic in (b"P2", b"P3") else (255 if maxval < 256 else 65535)
    v = samples((23, 31, bands), top, maxval + len(magic))
    got = assert_follows_pil(tmp_path, pnm_bytes(magic, v, maxval, plain=magic in (b"P2", b"P3")), f"{magic} {maxval}")
    assert got is not None
    if magic in (b"P2", b"P5"):
        assert got.mode == ("L" if maxval < 256 else "I")


@pytest.mark.parametrize("line", [3, 70, 10_000])
@pytest.mark.parametrize("packed", [False, True])
def test_plain_pbm_gives_pils_bits(tmp_path, packed, line):
    """P1: 1 black, digits with or without whitespace between them, any
    line length; P4 beside it."""
    bits = samples((19, 29), 1, 2)
    assert_follows_pil(tmp_path, pnm_bytes(b"P1", bits, plain=True, packed=packed, line=line), "P1")
    assert_follows_pil(tmp_path, pnm_bytes(b"P4", bits), "P4")


@pytest.mark.parametrize("scale", [-1.0, 1.0, -0.5, 3.25])
def test_pfm_in_both_byte_orders_and_its_float_conversion(tmp_path, scale):
    """Pf: little endian under a negative scale, rows bottom to top, and
    to_rgba's float-to-byte conversion on PIL's edges (NaN, infinities,
    values just under and over 0 and 255)."""
    f = np.random.default_rng(3).normal(120, 200, (13, 17)).astype(np.float32)
    f.flat[:14] = [np.nan, np.inf, -np.inf, 0.5, 100.7, -3, 300, 254.9999, 255.5, -0.5, 1e20, -1e20, 2**31, 127.5]
    got = assert_follows_pil(tmp_path, pnm_bytes(b"Pf", f, scale=scale), str(scale))
    assert got.mode == "F" and got.pixels.dtype == np.float32


def test_to_rgba_of_32_bit_modes_follows_pil():
    """"I" clipped to 0..255; "F" 0.5 -> 0, 100.7 -> 100, -3 -> 0,
    300 -> 255, as PIL's convert("RGBA") gives them."""
    i = np.array([-5, 0, 7, 255, 256, 65535, 2**31 - 1], np.int32).reshape(1, -1, 1)
    f = np.array([0.5, 100.7, -3, 300, np.nan, 254.99], np.float32).reshape(1, -1, 1)
    for mode, px in (("I", i), ("F", f)):
        want = np.asarray(Image.fromarray(px[..., 0], mode).convert("RGBA"))
        np.testing.assert_array_equal(image_io.to_rgba(image_io.Picture(px, mode)), want)
    assert image_io.to_rgba(image_io.Picture(f, "F"))[0, :4, 0].tolist() == [0, 100, 0, 255]


def test_comments_tokens_and_whitespace_in_the_header(tmp_path):
    """PIL's header reading: comments between and inside tokens, any
    whitespace, Python's int() of a token (a sign, underscores), ten bytes
    at most; the data from the byte after the last token's whitespace."""
    v = samples((5, 7, 1), 255, 4).astype(np.uint8).tobytes()
    for head in (b"P5\n# a comment\n7 5\n255\n", b"P5 7#x\n 5\t255\r", b"P5\x0b+7 5 2_55 ", b"P5\n0000000007 5 255\n",
                 b"P5 7\n#c\r5 255 ", b"P5 7 5 2#\n55 "):
        got = assert_follows_pil(tmp_path, head + v, repr(head))
        assert got is not None and got.pixels.shape == (5, 7, 1), head


def plain_cases():
    """{name: a plain P3 file of over 1 MiB of data with comments placed
    against PIL's 1 MiB reads}."""
    v = samples((220, 300, 3), 65535, 5)
    data = pnm_bytes(b"P3", v, 65535, plain=True, data_comment=b"# after the first line")
    start = data.index(b"65535\n") + 6  # PIL's first read of the data starts here
    edge = start + ppm.SAFEBLOCK
    assert len(data) > edge + 1000

    def insert(before: int, text: bytes) -> bytes:
        at = data.rfind(b" ", 0, before)
        return data[:at] + text + data[at:]

    at = data.rfind(b" ", 0, edge - 40)
    ends_on_edge = data[:at] + b" #" + b"z" * (edge - at - 2) + b"\n" + data[at:]
    later = ends_on_edge.index(b"\n", edge + 200)  # PIL's comment end takes the \r after a \n at 0
    return {
        "a comment after the first line": data,
        "a comment across the first read's end": insert(edge - 5, b" #" + b"x" * 10 + b"\n"),
        "a comment in the second read": insert(edge + 50, b" #comment\n"),
        "a comment longer than a read": insert(start + 100, b" #" + b"y" * (ppm.SAFEBLOCK + 10) + b"\n"),
        "a comment ending on the read's first byte": ends_on_edge[:later] + b"\r" + ends_on_edge[later + 1:],
    }


@pytest.mark.parametrize("case", list(plain_cases()))
def test_comments_in_plain_data_and_across_reads(tmp_path, case):
    """PIL's PpmPlainDecoder reads 1 MiB at a time and removes comments read
    by read: a comment in the data, one that runs on across a read or over
    a whole one, and its test for the comment's end (which takes a later
    carriage return where a read starts with the line feed), all as PIL."""
    assert_follows_pil(tmp_path, plain_cases()[case], case)


@pytest.mark.parametrize("case", ["binary", "scaled", "plain", "plain bits", "pfm", "raw 16-bit", "header"])
def test_truncations_raise_as_pil_raises(tmp_path, case):
    """A file cut anywhere in its data (and in its header) raises in PIL:
    the port raises naming the file."""
    v = samples((9, 11, 3), 255, 6)
    data = {
        "binary": pnm_bytes(b"P6", v, 255),
        "scaled": pnm_bytes(b"P6", v % 101, 100),
        "plain": pnm_bytes(b"P3", v, 255, plain=True),
        "plain bits": pnm_bytes(b"P1", v[..., 0] % 2, plain=True, packed=True),
        "pfm": pnm_bytes(b"Pf", v[..., 0].astype(np.float32)),
        "raw 16-bit": pnm_bytes(b"P5", v[..., :1] * 257, 65535),
        "header": b"P6\n11 9\n",
    }[case]
    refused = 0
    for cut in sorted({len(data) - 1, len(data) - 2, len(data) * 3 // 4, len(data) // 2, 8, 3}):
        refused += pil_outcome(data[:cut]) is None
        assert_follows_pil(tmp_path, data[:cut], f"{case} cut at {cut}")
    assert refused >= 4


REFUSALS = {
    "PF (colour PFM)": (b"PF\n3 2\n-1.0\n" + bytes(72), r"colour PFM file \(PF\)"),
    "P7 (PAM)": (b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n" + bytes(6), r"PAM file \(P7\)"),
    "maxval 0": (b"P5\n3 2\n0\n" + bytes(6), r"maxval of 0"),
    "maxval 65536": (b"P5\n3 2\n65536\n" + bytes(12), r"maxval of 65536"),
    "value over maxval": (b"P2 3 1 100 0 1 101\n", r"sample of 101 over maxval 100"),
    "negative value": (b"P2 3 1 100 0 -1 10\n", r"negative sample"),
    "long data token": (b"P2 3 1 100 0 00000000001 10\n", r"data token of more than 10 bytes"),
    "long header token": (b"P5 00000000003 1 255 \x00\x01\x02", r"header token of more than 10 bytes"),
    "not a number": (b"P5 3 1 25a \x00\x01\x02", r"maxval of b'25a'"),
    "bad P1 digit": (b"P1 3 1 0120", r"the byte b'2' in P1 data"),
    "flipped magic byte": (b"P5x\n3 1\n255\n\x00\x01\x02", r"the magic b'P5x'"),
    "zero width": (b"P5 0 1 255 \x00", r"size of 0x1"),
    "PFM scale 0": (b"Pf 1 1 0 " + bytes(4), r"PFM scale of 0.0"),
    "PFM scale inf": (b"Pf 1 1 1e999 " + bytes(4), r"PFM scale of inf"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_name_the_file_and_what_pil_refuses(tmp_path, case):
    data, match = REFUSALS[case]
    assert_refused_like_pil(tmp_path, data, match)


def test_flipped_header_bytes_follow_pil(tmp_path):
    """Each byte of a small P6 header flipped in turn: the port reads what
    PIL reads and raises where PIL raises."""
    data = pnm_bytes(b"P6", samples((3, 4, 3), 255, 7), 255)
    head = data.index(b"255\n") + 4
    for at in range(head):
        for bit in (0x01, 0x20):
            flipped = bytearray(data)
            flipped[at] ^= bit
            assert_follows_pil(tmp_path, bytes(flipped), f"byte {at} ^ {bit}")


# ---- the committed fixtures (PPM and TGA) ----

PPM_TGA_FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_ppm_tga")
PPM_TGA_NAMES = sorted(os.path.splitext(f)[0] for f in os.listdir(PPM_TGA_FIXTURES)
                       if not f.endswith((".npz", ".py")))


def test_ppm_tga_fixtures_are_committed_in_pairs():
    files = os.listdir(PPM_TGA_FIXTURES)
    assert len(PPM_TGA_NAMES) >= 15
    assert sorted(f[:-4] for f in files if f.endswith(".npz")) == PPM_TGA_NAMES
    assert sum(os.path.getsize(os.path.join(PPM_TGA_FIXTURES, f)) for f in files) < 200 * 2**10


@pytest.mark.parametrize("name", PPM_TGA_NAMES)
def test_ppm_tga_fixture_pixels_are_pils(tmp_path, name):
    """PIL's reading of each committed file equals the mode, pixels and
    RGBA committed beside it (which chip_smoke.py holds the port to on the
    card's machine), and so does the port's."""
    path = [os.path.join(PPM_TGA_FIXTURES, f) for f in os.listdir(PPM_TGA_FIXTURES)
            if os.path.splitext(f)[0] == name and not f.endswith(".npz")][0]
    with open(path, "rb") as f:
        data = f.read()
    want = np.load(os.path.join(PPM_TGA_FIXTURES, f"{name}.npz"))
    mode, pixels, rgba = pil_outcome(data)
    assert mode == str(want["mode"])
    np.testing.assert_array_equal(pixels, want["pixels"])
    np.testing.assert_array_equal(rgba, want["rgba"])
    got = image_io.open_image(path)
    assert got.mode == mode and got.pixels.dtype == want["pixels"].dtype
    np.testing.assert_array_equal(got.pixels, want["pixels"])
    np.testing.assert_array_equal(image_io.to_rgba(got), want["rgba"])


# ---- the dataset readers ----

def colmap_views(w, h):
    """PPM / PGM views whose np.asarray is the picture (L and RGB)."""
    rng = np.random.default_rng(10)
    rgb = rng.integers(0, 256, (h, w, 3))
    return {
        "v_p6.ppm": pnm_bytes(b"P6", rgb, 255),
        "v_p6_16bit.ppm": pnm_bytes(b"P6", rgb * 257 + 3, 65535),
        "v_p3_plain.ppm": pnm_bytes(b"P3", rgb, 255, plain=True),
        "v_p5.pgm": pnm_bytes(b"P5", rgb[..., :1], 255),
        "v_p6_maxval_1000.ppm": pnm_bytes(b"P6", rgb * 1000 // 255, 1000),
        "v_p2_maxval_100.pgm": pnm_bytes(b"P2", rgb[..., 1:2] * 100 // 255, 100, plain=True),
    }


@pytest.mark.parametrize("resolution", [1, 2])
def test_colmap_ppm_views_match_jax(tmp_path, monkeypatch, resolution):
    """A COLMAP dataset of PPM and PGM views (binary and plain, 8 and 16
    bits, maxval 100 and 1000): the Scene's cameras equal the JAX
    package's, images bit for bit."""
    from test_torch_scene import both_scenes

    w, h = 45, 37
    src = str(tmp_path / "forms")
    write_colmap_dataset_of(src, colmap_views(w, h), w, h)
    jscene, scene = both_scenes(tmp_path, monkeypatch, src, eval_split=True, resolution=resolution)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == 6
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())


def refused_views():
    v = samples((11, 13, 4), 255, 20)
    return {
        "PBM": (pnm_bytes(b"P4", v[..., 0] % 2), "1"),
        "plain PBM": (pnm_bytes(b"P1", v[..., 0] % 2, plain=True), "1"),
        "16-bit PGM": (pnm_bytes(b"P5", v[..., :1] * 257, 65535), "I"),
        "PGM at maxval 1000": (pnm_bytes(b"P2", v[..., :1] * 3, 1000, plain=True), "I"),
        "PFM": (pnm_bytes(b"Pf", v[..., 0].astype(np.float32)), "F"),
        "P0CMYK": (pnm_bytes(b"P0CMYK", v, 255), "CMYK"),
        "PyP": (pnm_bytes(b"PyP", v[..., :1], 255), "P"),
    }


@pytest.mark.parametrize("form", list(refused_views()))
def test_colmap_refuses_ppm_modes_that_are_not_the_picture(tmp_path, form):
    """The JAX package's COLMAP path would train on np.asarray of these (0
    or 1, 32-bit integers or floats, C M Y K, indices): the port refuses
    each through load_camera, naming the file as images.bin lists it and
    the mode."""
    data, mode = refused_views()[form]
    src = str(tmp_path / "data")
    write_colmap_dataset_of(src, {"view.ppm": data}, 13, 11)
    assert Image.open(os.path.join(src, "images", "view.ppm")).mode == mode
    info = dataset_readers.read_colmap_scene(src, None, eval_split=False)
    with pytest.raises(ValueError, match=rf"'view\.ppm' in .*images\.bin: .*view\.ppm: .*\(mode {mode}\)"):
        dataset_readers.load_camera(info.train_cameras[0], 1)


@pytest.mark.parametrize("white_background", [False, True])
def test_blender_ppm_frames_match_jax(tmp_path, monkeypatch, white_background):
    """read_blender_scene on frames in every PPM form (the RGBA extension
    with its alpha composited; "1", "I", "F", CMYK and "P" through PIL's
    convert("RGBA")), bit for bit, then load_camera at -r 2."""
    from test_torch_tga import blender_scenes

    w, h = 29, 23
    v = samples((h, w, 4), 255, 30)
    f = np.random.default_rng(31).normal(128, 150, (h, w)).astype(np.float32)
    frames = [pnm_bytes(b"P6", v[..., :3], 255), pnm_bytes(b"P6", v[..., :3] * 257, 65535),
              pnm_bytes(b"P3", v[..., :3], 255, plain=True), pnm_bytes(b"P5", v[..., :1] * 200, 65535),
              pnm_bytes(b"P4", v[..., 0] % 2), pnm_bytes(b"P1", v[..., 0] % 2, plain=True, packed=True),
              pnm_bytes(b"Pf", f), pnm_bytes(b"PyRGBA", v, 255), pnm_bytes(b"P0CMYK", v, 255),
              pnm_bytes(b"PyP", v[..., :1], 255)]
    blender_scenes(tmp_path, monkeypatch, frames, white_background, jreaders, dataset_readers)
