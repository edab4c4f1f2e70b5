"""Arithmetic-coded JPEG (SOF9, SOF10, DAC) through the port's compiled
decoder (`csrc/jpeg_decode.cc`), against PIL, which the JAX package reads
its images with.

Tolerances: every comparison is bit-equal, to `np.asarray(Image.open(f))`
(PIL 12 with libjpeg-turbo 3 here), with PIL's mode; where PIL raises, the
port raises a `ValueError` naming the file. The files are libjpeg-turbo's
own arithmetic transcodes of Huffman JPEGs (tests/torch_jpeg_tools.py, as
`jpegtran -arithmetic` writes them), each also held to the port's decode of
its Huffman original; tests that need the transcoder skip, saying why, where
it cannot be built. The committed 1080p files of
tests/fixtures/torch_jpeg_arith are held to sha256.json and to PIL.
"""

import io
import json
import os
import shutil
import struct

import numpy as np
import pytest
from PIL import Image

import torch_jpeg_tools
from gaussian_splatting_tpu.scene import dataset_readers as jreaders
from gaussian_splatting_torch.scene import dataset_readers
from gaussian_splatting_torch.utils import image_io, jpeg
from test_torch_image_forms import cxx, write_colmap_dataset_of  # noqa: F401  (cxx: a fixture)
from test_torch_jpeg import content, encode_jpeg, pil_jpeg, pil_or_error, pil_pixels
from test_torch_scene import assert_same_cameras, orbit_frames
from torch_image_writers import tiff_bytes
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_jpeg_arith")
READINGS = json.load(open(os.path.join(FIXTURES, "sha256.json")))["files"]


@pytest.fixture
def writer(cxx):
    why = torch_jpeg_tools.missing()
    if why:
        pytest.skip(why)
    torch_jpeg_tools.writer()


def port(data: bytes, name="<bytes>"):
    """The compiled decoder's pixels, or its message."""
    try:
        return jpeg.decode_jpeg(data, name)
    except ValueError as err:
        return str(err)


def assert_as_pil(data: bytes, name="<bytes>"):
    """The port reads `data` as PIL does: PIL's pixels, or both raise.
    Returns "pixels" or "raise"."""
    want, got = pil_or_error(data), port(data, name)
    if isinstance(want, str):
        assert isinstance(got, str), f"the port reads a file PIL refuses ({want})"
        assert name in got
        return "raise"
    assert not isinstance(got, str), f"PIL reads a file the port refuses: {got}"
    np.testing.assert_array_equal(got, want)
    return "pixels"


def sof_marker(data: bytes) -> int:
    return next(i for i in range(2, len(data)) if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA))


def scans(data: bytes) -> list:
    out, i = [], data.find(b"\xff\xda")
    while i >= 0:
        out.append(i)
        i = data.find(b"\xff\xda", i + 2)
    return out


# ---- transcodes of Huffman files ----

SUBSAMPLING = ["4:4:4", "4:2:2", "4:2:0", "grey"]
MODES = {"sequential": ({}, {}), "progressive": ({"progressive": True}, {}),
         "restart rows": ({}, {"rows": 1}), "restart blocks": ({}, {"mcus": 3}),
         "progressive restarts": ({"progressive": True}, {"mcus": 2})}
SIZES = [(1, 1), (7, 5), (16, 16), (67, 45), (129, 97)]  # (width, height)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("subsampling", SUBSAMPLING)
def test_transcodes_read_as_pil_and_as_their_huffman_original(writer, subsampling, quality, mode):
    """Every size, smooth and noisy: the arithmetic transcode of a PIL JPEG
    reads as PIL reads it, and as the port reads the Huffman original."""
    save, transcode = MODES[mode]
    options = dict(quality=quality, **save)
    if subsampling != "grey":
        options["subsampling"] = subsampling
    for w, h in SIZES:
        for seed, kind in enumerate(("smooth", "noisy")):
            huffman = pil_jpeg(content(h, w, 1 if subsampling == "grey" else 3, kind, seed), **options)
            data = torch_jpeg_tools.arith(huffman, **transcode)
            assert data[sof_marker(data) + 1] == (0xCA if save else 0xC9) and b"\xff\xcc" in data
            got = jpeg.decode_jpeg(data)
            np.testing.assert_array_equal(got, pil_pixels(data), err_msg=f"{w}x{h} {kind}")
            np.testing.assert_array_equal(got, jpeg.decode_jpeg(huffman), err_msg=f"{w}x{h} {kind}")


@pytest.mark.parametrize("sampling", [(1, 2), (4, 1), (2, 2)])
@pytest.mark.parametrize("restart", [0, 2])
def test_other_ratios_read_as_pil(writer, sampling, restart):
    """4:4:0 and 4x1 (which PIL's writer does not write; the copied
    baseline encoder's files), with and without restart markers."""
    for w, h in ((67, 45), (33, 17)):
        huffman = encode_jpeg(content(h, w, 3, "smooth", 1), 90, sampling)
        data = torch_jpeg_tools.arith(huffman, mcus=restart)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), pil_pixels(data))
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), jpeg.decode_jpeg(huffman))


@pytest.mark.parametrize("form", ["cmyk", "cmyk progressive", "ycck"])
def test_four_components_read_as_pil(writer, form):
    """CMYK (PIL's, sequential and progressive) and YCCK (the copied
    encoder's, Adobe transform 2) transcoded: PIL's inverted mode "CMYK"."""
    a = content(29, 37, 3, "smooth", 1)
    if form == "ycck":
        huffman = encode_jpeg(np.concatenate([a, a[..., :1]], -1), 90, (2, 2), adobe=2)
    else:
        buf = io.BytesIO()
        Image.fromarray(a).convert("CMYK").save(buf, "JPEG", quality=90, progressive=form != "cmyk")
        huffman = buf.getvalue()
    data = torch_jpeg_tools.arith(huffman, mcus=2)
    assert Image.open(io.BytesIO(data)).mode == "CMYK"
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), pil_pixels(data))
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), jpeg.decode_jpeg(huffman))


@pytest.mark.parametrize("quality, subsampling", [(90, "4:2:0"), (75, "4:4:4"), (50, "4:2:2")])
def test_progressive_files_with_bits_left_out_are_smoothed_as_pil(writer, quality, subsampling):
    """jpeg_simple_progression's ten scans cut after each: PIL smooths the
    blocks of an arithmetic progressive file as it smooths a Huffman one."""
    data = torch_jpeg_tools.arith(pil_jpeg(content(45, 67, 3, "smooth", 1), quality=quality,
                                           subsampling=subsampling, progressive=True))
    starts = scans(data)
    assert len(starts) == 10
    for k in range(1, len(starts)):
        cut = data[:starts[k]] + b"\xff\xd9"
        np.testing.assert_array_equal(jpeg.decode_jpeg(cut), pil_pixels(cut), err_msg=f"{k} scans")


# ---- DAC ----

def dac_cases(data: bytes, conditioned: bytes):
    """`data` (default conditioning) and `conditioned` (L 1, U 3, K 2) with
    their DAC segments edited, moved and dropped."""
    i = data.index(b"\xff\xcc")
    n = struct.unpack(">H", data[i + 2:i + 4])[0]
    j = conditioned.index(b"\xff\xcc")
    dac = conditioned[j:j + 2 + n]
    rest = conditioned[:j] + conditioned[j + 2 + n:]

    def edit(at, value):
        out = bytearray(data)
        out[i + at] = value
        return bytes(out)

    sof = rest.index(b"\xff\xc9")
    return {  # name: (data, whether PIL reads it)
        "L 1, U 2": (edit(5, 0x21), True),
        "L over U": (edit(5, 0x12), False),
        "index 32": (edit(4, 0x20), False),
        "DC table 15": (edit(4, 0x0F), True),
        "AC table 15": (edit(8, 0x1F), True),
        "Kx 0": (edit(9, 0), True),
        "Kx 64": (edit(9, 64), True),
        "Kx 200": (edit(9, 200), True),
        "odd length": (data[:i + 3] + bytes([n + 1]) + data[i + 4:i + 2 + n] + b"\0" + data[i + 2 + n:], False),
        "no DAC": (data[:i] + data[i + 2 + n:], True),
        "conditioned, no DAC": (rest, True),
        "DAC before the frame": (rest[:sof] + dac + rest[sof:], True),
        "DAC after SOI": (rest[:2] + dac + rest[2:], True),
        "defaults after it": (conditioned[:j + 2 + n] + bytes.fromhex("ffcc000600101005") + conditioned[j + 2 + n:],
                              True),
        "empty DAC after it": (conditioned[:j + 2 + n] + bytes.fromhex("ffcc0002") + conditioned[j + 2 + n:], True),
    }


DAC_CASES = ["L 1, U 2", "L over U", "index 32", "DC table 15", "AC table 15", "Kx 0", "Kx 64", "Kx 200", "odd length",
             "no DAC", "conditioned, no DAC", "DAC before the frame", "DAC after SOI", "defaults after it",
             "empty DAC after it"]


@pytest.mark.parametrize("case", DAC_CASES)
def test_dac_segments_read_as_pil(writer, case):
    """get_dac's rules: DC L the low nibble and U the high one, L <= U; AC
    Kx as it stands (0 and over 63 read); 16 tables of each class, an
    index past them an error; an odd length an error; the conditioning
    holds from where it is read (before the frame too) until it is read
    again; without DAC the defaults L 0, U 1, Kx 5."""
    huffman = pil_jpeg(content(45, 67, 3, "noisy", 2), quality=90, subsampling="4:2:0")
    data, pil_reads = dac_cases(torch_jpeg_tools.arith(huffman, rows=1),
                                torch_jpeg_tools.arith(huffman, rows=1, L=1, U=3, K=2))[case]
    assert assert_as_pil(data, case) == ("pixels" if pil_reads else "raise")


def test_conditioned_files_read_as_their_huffman_original(writer):
    """DAC conditioning other than the defaults, sequential and progressive,
    at both ends of each range."""
    for L, U, K in ((1, 3, 2), (0, 0, 1), (15, 15, 63), (2, 9, 30)):
        for progressive in (False, True):
            huffman = pil_jpeg(content(45, 67, 3, "noisy", 3), quality=85, progressive=progressive)
            data = torch_jpeg_tools.arith(huffman, L=L, U=U, K=K)
            np.testing.assert_array_equal(jpeg.decode_jpeg(data), pil_pixels(data))
            np.testing.assert_array_equal(jpeg.decode_jpeg(data), jpeg.decode_jpeg(huffman))


# ---- Huffman data under SOF9, and recovery ----

@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:0", "grey"])
@pytest.mark.parametrize("restart", [0, 2])
def test_sof9_patched_huffman_files_read_as_pil(cxx, subsampling, restart):
    """A Huffman file whose SOF0 says SOF9: PIL reads it, its arithmetic
    decoder reading Huffman bits through libjpeg's recovery rules (bad
    codes, runs past 63, magnitude overflows)."""
    options = {"quality": 90, "restart_marker_blocks": restart}
    if subsampling != "grey":
        options["subsampling"] = subsampling
    for seed, (w, h) in enumerate(((40, 24), (67, 45), (129, 97))):
        data = bytearray(pil_jpeg(content(h, w, 1 if subsampling == "grey" else 3, "noisy", seed), **options))
        data[sof_marker(data) + 1] = 0xC9
        assert assert_as_pil(bytes(data)) == "pixels"


@pytest.mark.parametrize("base", ["sequential_restarts", "progressive"])
def test_corrupted_files_read_or_fail_as_pil(writer, base):
    """Seeded byte flips in a small arithmetic file: PIL's pixels where PIL
    returns an image, a ValueError where it raises, each outcome at least
    20 of 150."""
    options = {"progressive": True} if base == "progressive" else {}
    data = torch_jpeg_tools.arith(pil_jpeg(content(12, 16, 3, "noisy", 5), quality=75, subsampling="4:2:0", **options),
                                  mcus=0 if options else 2)
    rng = np.random.default_rng(6)
    outcomes = {"pixels": 0, "raise": 0}
    for _ in range(150):
        bad = bytearray(data)
        for at in rng.integers(2, len(bad), rng.integers(1, 4)):
            bad[at] = int(rng.integers(0, 256))
        outcomes[assert_as_pil(bytes(bad))] += 1
    assert min(outcomes.values()) >= 20, outcomes


def test_truncated_files_read_or_fail_as_pil(writer):
    """Files cut at every few bytes, with and without an EOI after the cut:
    the arithmetic decoder reads zeros past a marker and raises past the
    end of the bytes PIL has (libjpeg cannot suspend it)."""
    a = content(29, 37, 3, "smooth", 1)
    outcomes = {"pixels": 0, "raise": 0}
    for huffman, transcode in ((pil_jpeg(a, quality=90), {}), (pil_jpeg(a, quality=90), {"mcus": 4}),
                               (pil_jpeg(a, quality=90, progressive=True), {})):
        data = torch_jpeg_tools.arith(huffman, **transcode)
        for cut in range(len(data) // 3, len(data), max(1, len(data) // 30)):
            for tail in (b"", b"\xff\xd9"):
                outcomes[assert_as_pil(data[:cut] + tail)] += 1
    assert min(outcomes.values()) >= 20, outcomes


# ---- PIL's 65536-byte blocks ----

def padded(data: bytes, k: int, target: int) -> bytes:
    """`data` with COM segments before scan k's SOS that move it to end
    `target` bytes into the file."""
    at = scans(data)[k]
    gap = target - at - 4
    pad = b""
    while gap > 0:
        n = min(gap, 65533)
        pad += b"\xff\xfe" + struct.pack(">H", n + 2) + bytes(n)
        gap -= n + 4
    return data[:at] + pad + data[at:]


@pytest.mark.parametrize("quality", [40, 60, 80])
def test_scans_past_pils_first_block_read_or_fail_as_pil(writer, quality):
    """A 1080p progressive file (trained_r5's render, committed) padded so
    that a scan's header ends before, at or after 65536 bytes: PIL decodes
    each scan in the call that read its header, with the bytes read by then
    (a multiple of 65536), and raises where the scan's data runs past them;
    the port reads and raises on the same files."""
    name = "1080p_prog_420_q55.jpg"
    assert READINGS[name]["mode"] == "RGB"
    px = np.asarray(Image.open(os.path.join(FIXTURES, name)))
    data = torch_jpeg_tools.arith(pil_jpeg(px[..., None] if px.ndim == 2 else px, quality=quality,
                                           subsampling="4:2:0", progressive=True), rows=8)
    outcomes = {"pixels": 0, "raise": 0}
    for k in range(1, len(scans(data))):
        for target in (65536 - 4000, 65536 - 20, 65536 - 2, 65536 + 3, 131072 + 30):
            if target - scans(data)[k] - 4 >= 8:
                outcomes[assert_as_pil(padded(data, k, target))] += 1
    assert min(outcomes.values()) >= 5, outcomes


@pytest.mark.parametrize("name", sorted(READINGS))
def test_committed_fixture_reads_as_pil_and_the_json_say(cxx, name):
    """Each committed 1080p file: its bytes, and PIL's mode, shape and
    pixels as sha256.json holds them and as PIL reads them here; the port
    gives the same, or raises where PIL does (the quality 95 file, whose
    scan runs past PIL's first 65536 bytes)."""
    import hashlib

    path = os.path.join(FIXTURES, name)
    data = open(path, "rb").read()
    r = READINGS[name]
    assert hashlib.sha256(data).hexdigest() == r["file_sha256"]
    if r.get("pil") == "raises":
        with pytest.raises(ValueError, match="past the bytes PIL has read") as err:
            image_io.open_image(path)
        assert path in str(err.value)
        with pytest.raises(OSError):
            Image.open(path).load()
        return
    pic = image_io.open_image(path)
    assert (pic.mode, list(pic.pixels.shape), hashlib.sha256(pic.pixels.tobytes()).hexdigest()) == \
        (r["mode"], r["shape"], r["sha256"])
    np.testing.assert_array_equal(pic.pixels, np.asarray(Image.open(path)))


# ---- refusals ----

def test_forms_pil_refuses_are_refused_by_name(tmp_path, writer):
    """SOF11 (lossless arithmetic, which libjpeg-turbo does not implement),
    SOF13 (hierarchical), 12-bit samples, SOF10 on a baseline file (its
    scan header, Ss 0 and Se 63, is no progressive one): PIL raises, and
    the port raises naming the file and the form."""
    lossless = torch_jpeg_tools.lossless(content(9, 13, 3, "smooth"), psv=1)
    baseline = pil_jpeg(content(9, 13, 3, "smooth"), quality=90)
    arith = torch_jpeg_tools.arith(baseline)
    s0, s3, s9 = sof_marker(baseline), lossless.index(b"\xff\xc3"), sof_marker(arith)
    cases = {
        "sof10 on baseline": (baseline[:s0 + 1] + b"\xca" + baseline[s0 + 2:], r"a progressive scan 0\.\.63"),
        "sof11": (lossless[:s3 + 1] + b"\xcb" + lossless[s3 + 2:], r"arithmetic-coded lossless JPEG \(SOF11"),
        "sof13": (arith[:s9 + 1] + b"\xcd" + arith[s9 + 2:], r"hierarchical JPEG \(SOF13\)"),
        "12-bit": (arith[:s9 + 4] + b"\x0c" + arith[s9 + 5:], r"12-bit samples"),
    }
    for case, (data, words) in cases.items():
        with pytest.raises(Exception):
            Image.open(io.BytesIO(data)).load()
        path = tmp_path / f"{case}.jpg"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=words) as err:
            jpeg.read_jpeg(path)
        assert str(path) in str(err.value)


# ---- JPEG-in-TIFF, MPO ----

@pytest.mark.parametrize("photometric", [2, 1, 6])
def test_arithmetic_jpeg_in_tiff_strips_read_as_pil(tmp_path, writer, photometric):
    """Compression 7 strips whose streams are arithmetic-coded: PIL's
    libtiff reads them (RGB, grey, YCbCr converted to RGB), and so does the
    port, also a 1080p strip of 183 KB: libtiff hands libjpeg the whole
    strip, so PIL's 65536-byte blocks do not bound it."""
    channels = 1 if photometric == 1 else 3

    def encode(x):
        x = np.ascontiguousarray(x)
        sub = "4:2:0" if photometric == 6 else "4:4:4"
        return torch_jpeg_tools.arith(pil_jpeg(x, quality=90, subsampling=sub) if channels == 3 else
                                      pil_jpeg(x, quality=90), mcus=2)

    a = content(32, 40, channels, "smooth", 2)
    data = tiff_bytes(a, 8, photometric, compression=7, rows_per_strip=16, encode=encode,
                      ycbcr=(2, 2) if photometric == 6 else None)
    path = tmp_path / "arith.tif"
    path.write_bytes(data)
    want = pil_pixels(data)
    got = image_io.open_image(path).pixels
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    if photometric == 2:
        px = np.asarray(Image.open(os.path.join(FIXTURES, "1080p_seq_420_q60_rows4.jpg")))
        big = tiff_bytes(px, 8, 2, compression=7, rows_per_strip=1080,
                         encode=lambda x: torch_jpeg_tools.arith(pil_jpeg(np.ascontiguousarray(x), quality=95,
                                                                          subsampling="4:4:4")))
        assert len(big) > 2 * 65536
        path.write_bytes(big)
        np.testing.assert_array_equal(image_io.open_image(path).pixels, pil_pixels(big))


def mpo_with_frame0(frame0: bytes, frame1: bytes) -> bytes:
    """PIL's two-frame MPO of frames like these, with frame 0's stream
    replaced by `frame0` (after the APP2 "MPF" segment PIL writes) and the
    MP entries' sizes and offsets made to fit."""
    buf = io.BytesIO()
    first = Image.open(io.BytesIO(frame1))
    first.save(buf, "MPO", save_all=True, append_images=[Image.open(io.BytesIO(frame1))])
    mpo = buf.getvalue()
    at = mpo.index(b"\xff\xe2")
    app2 = mpo[at:at + 2 + struct.unpack(">H", mpo[at + 2:at + 4])[0]]
    assert app2[4:8] == b"MPF\0"
    out = bytearray(frame0[:2] + app2 + frame0[2:] + frame1)
    head = 2 + 8  # the MP header ("MM\0*"), from the file's start
    order = ">" if out[head:head + 2] == b"MM" else "<"
    ifd = head + struct.unpack(order + "I", out[head + 4:head + 8])[0]
    for k in range(struct.unpack(order + "H", out[ifd:ifd + 2])[0]):
        tag, _, _, value = struct.unpack(order + "HHII", out[ifd + 2 + 12 * k:ifd + 14 + 12 * k])
        if tag == 0xB002:  # MPEntry: attribute, size, offset, two dependents, per image
            e = head + value
            size0 = len(frame0) + len(app2)
            struct.pack_into(order + "I", out, e + 4, size0)
            struct.pack_into(order + "II", out, e + 16 + 4, len(frame1), size0 - head)
    return bytes(out)


def test_mpo_whose_frame_0_is_arithmetic_reads_as_frame_0(tmp_path, writer):
    """An MPO's frame 0 arithmetic-coded, frame 1 a Huffman JPEG: PIL opens
    it as MPO and np.asarray gives frame 0, which the port reads."""
    a, b = content(29, 37, 3, "smooth", 1), content(29, 37, 3, "noisy", 2)
    data = mpo_with_frame0(torch_jpeg_tools.arith(pil_jpeg(a, quality=90)), pil_jpeg(b, quality=90))
    im = Image.open(io.BytesIO(data))
    assert im.format == "MPO" and im.n_frames == 2
    path = tmp_path / "frames.mpo"
    path.write_bytes(data)
    pic = image_io.open_image(path)
    assert pic.mode == "RGB"
    np.testing.assert_array_equal(pic.pixels, np.asarray(im))


# ---- the dataset paths ----

def assert_datasets_match_jax(tmp_path, monkeypatch, views: dict, w: int, h: int):
    """A COLMAP dataset of `views` ({name: bytes}) at -r 1 and 2, and a
    Blender one of the same files (named .png, as the transforms file names
    them): the port's Scene and read_blender_scene against the JAX
    package's, images bit for bit."""
    from test_torch_scene import both_scenes

    for resolution in (1, 2):
        src = str(tmp_path / f"colmap{resolution}")
        write_colmap_dataset_of(src, views, w, h)
        jscene, scene = both_scenes(tmp_path / f"r{resolution}", monkeypatch, src, eval_split=True,
                                    resolution=resolution)
        assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == len(views)
        assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
        assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())
    d = tmp_path / "blender"
    (d / "train").mkdir(parents=True)
    listing = []
    frames = list(views.values())
    for i, data in enumerate(frames):
        (d / "train" / f"r_{i}.png").write_bytes(data)
        listing.append({"file_path": f"./train/r_{i}", "transform_matrix": orbit_frames(len(frames))[i]})
    (d / "transforms_train.json").write_text(json.dumps({"camera_angle_x": 0.69, "frames": listing}))
    monkeypatch.setenv("GS_TPU_BLENDER_INIT_POINTS", "50")
    infos = []
    for pkg, name in ((jreaders, "jax"), (dataset_readers, "port")):
        shutil.copytree(d, tmp_path / name)
        np.random.seed(3)
        infos.append(pkg.read_blender_scene(str(tmp_path / name), True, eval_split=False))
    want, got = infos
    assert len(got.train_cameras) == len(frames)
    for i, (g, wnt) in enumerate(zip(got.train_cameras, want.train_cameras)):
        np.testing.assert_array_equal(g.image, np.asarray(wnt.image), err_msg=f"frame {i}")
        assert (g.width, g.height, g.fovx, g.fovy) == (wnt.width, wnt.height, wnt.fovx, wnt.fovy)
        assert_same_cameras([dataset_readers.load_camera(g, 2)], [jreaders.load_camera(wnt, 2)])


def test_arithmetic_datasets_match_jax(tmp_path, monkeypatch, writer):
    """COLMAP and Blender datasets of arithmetic views (sequential with
    restarts, progressive, 4:4:4 with DAC conditioning, grey, a SOF9-patched
    Huffman file) read as the JAX package reads them through PIL."""
    w, h = 45, 37
    a = content(h, w, 3, "smooth", 4)
    patched = bytearray(pil_jpeg(a, quality=90))
    patched[sof_marker(patched) + 1] = 0xC9
    views = {
        "seq.jpg": torch_jpeg_tools.arith(pil_jpeg(a, quality=90, subsampling="4:2:0"), rows=1),
        "prog.jpg": torch_jpeg_tools.arith(pil_jpeg(a[::-1].copy(), quality=80, progressive=True)),
        "dac.jpg": torch_jpeg_tools.arith(pil_jpeg(a[:, ::-1].copy(), quality=95, subsampling="4:4:4"),
                                          L=1, U=3, K=9),
        "grey.jpg": torch_jpeg_tools.arith(pil_jpeg(a[..., :1], quality=90)),
        "patched.jpg": bytes(patched),
    }
    assert_datasets_match_jax(tmp_path, monkeypatch, views, w, h)
