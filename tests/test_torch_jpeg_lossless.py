"""Lossless JPEG (SOF3) through the port's compiled decoder
(`csrc/jpeg_decode.cc`), against PIL, which the JAX package reads its
images with.

Tolerances: every comparison is bit-equal, to `np.asarray(Image.open(f))`
(PIL 12 with libjpeg-turbo 3 here), with PIL's mode; where PIL raises, the
port raises a `ValueError` naming the file. The files come from
libjpeg-turbo's own encoder (tests/torch_jpeg_tools.py, as `cjpeg
-lossless` writes them; tests that need it skip, saying why, where it
cannot be built) and from tests/torch_image_writers.py's `lossless_jpeg`,
which writes the sampling factors, markers and scans libjpeg-turbo's
encoder does not.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

import torch_jpeg_tools
from gaussian_splatting_torch.utils import image_io, jpeg
from test_torch_image_forms import cxx  # noqa: F401  (a fixture)
from test_torch_jpeg import content, pil_pixels
from test_torch_jpeg_arith import assert_as_pil, assert_datasets_match_jax
from torch_image_writers import lossless_jpeg, tiff_bytes
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)


@pytest.fixture
def writer(cxx):
    why = torch_jpeg_tools.missing()
    if why:
        pytest.skip(why)
    torch_jpeg_tools.writer()


def stored(a: np.ndarray, pt: int) -> np.ndarray:
    """The samples a lossless file of `a` at point transform `pt` holds."""
    a = a[..., None] if a.ndim == 2 else a
    return (a >> pt) << pt


# ---- libjpeg-turbo's encoder ----

@pytest.mark.parametrize("pt", [0, 1, 7])
@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("channels", [1, 3])
def test_every_predictor_and_point_transform_reads_as_pil(writer, channels, psv, pt):
    """Grey and RGB, smooth and noisy, sizes 1x1 to 64x3, with and without
    restart intervals: PIL's pixels, which are the samples shifted by Pt."""
    for (w, h) in ((1, 1), (7, 5), (37, 29), (64, 3)):
        for seed, kind in enumerate(("smooth", "noisy")):
            a = content(h, w, channels, kind, seed)
            for rows in (0, 1, 2):
                data = torch_jpeg_tools.lossless(a, psv, pt, rows)
                got = jpeg.decode_jpeg(data)
                np.testing.assert_array_equal(got, pil_pixels(data), err_msg=f"{w}x{h} {kind} rows {rows}")
                np.testing.assert_array_equal(got, stored(a, pt))


@pytest.mark.parametrize("psvs", [(1, 1, 1), (2, 5, 7), (6, 3, 4)])
@pytest.mark.parametrize("rows", [0, 1, 3])
def test_one_component_scans_read_as_pil(writer, psvs, rows):
    """One scan per component, each with its own predictor (libjpeg-turbo's
    scan script), with and without restarts; CMYK too (PIL's inverted
    mode)."""
    for channels in (3, 4):
        a = content(29, 37, channels, "smooth", 2)
        data = torch_jpeg_tools.lossless(a, psvs[0], 1, rows, one_component_scans=True, psvs=list(psvs) + [1])
        got = jpeg.decode_jpeg(data)
        np.testing.assert_array_equal(got, pil_pixels(data))
        np.testing.assert_array_equal(got, stored(a, 1) if channels == 3 else 255 - stored(a, 1))


# ---- the writer's forms: sampling, markers ----

SAMPLINGS = {"4:2:0": [(2, 2), (1, 1), (1, 1)], "4:2:2": [(2, 1), (1, 1), (1, 1)], "4:4:0": [(1, 2), (1, 1), (1, 1)],
             "4x1": [(4, 1), (1, 1), (1, 1)], "mixed": [(2, 2), (1, 1), (2, 1)], "2x2 chroma": [(1, 1), (2, 2), (1, 1)]}


@pytest.mark.parametrize("one_scan_each", [False, True])
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_subsampled_components_read_as_pil(cxx, sampling, one_scan_each):
    """Sampling factors libjpeg-turbo's encoder does not write: PIL reads
    them with replicated upsampling (lossless mode turns fancy upsampling
    off); interleaved MCUs with padding samples and rows, or one scan per
    component, with restarts."""
    for (w, h) in ((7, 5), (37, 29), (33, 18)):
        for kind in ("smooth", "noisy"):
            a = content(h, w, 3, kind, 3)
            for psv, pt, rows in ((1, 0, 0), (4, 2, 1), (7, 0, 2), (5, 1, 0)):
                data = lossless_jpeg(a, SAMPLINGS[sampling], psv, pt, rows, one_scan_each)
                np.testing.assert_array_equal(jpeg.decode_jpeg(data), pil_pixels(data),
                                              err_msg=f"{w}x{h} {kind} psv {psv} pt {pt} rows {rows}")


@pytest.mark.parametrize("marker, ids, pil_reads", [
    ("adobe", None, True), (None, None, True), (None, [82, 71, 66], True), (None, [0, 1, 2], True),
    (None, [7, 8, 9], True), ("jfif", [82, 71, 66], False), ("jfif", None, False), ("adobe1", None, False)])
def test_colour_spaces_read_or_fail_as_pil(cxx, marker, ids, pil_reads):
    """libjpeg-turbo converts no colours in lossless mode: three components
    are RGB whatever their ids (1, 2, 3 too) but under a JFIF marker or an
    Adobe transform other than 0, which make them YCbCr, which PIL cannot
    have converted and raises on."""
    a = content(29, 37, 3, "smooth", 5)
    data = lossless_jpeg(a, None, 2, 0, marker=marker, ids=ids)
    assert assert_as_pil(data) == ("pixels" if pil_reads else "raise")
    if pil_reads:
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), a)
    else:
        with pytest.raises(ValueError, match="a lossless YCbCr JPEG"):
            jpeg.decode_jpeg(data)


def test_cmyk_reads_and_ycck_fails_as_pil(writer):
    """Four components: CMYK under no Adobe marker or transform 0, PIL's
    inverted "CMYK"; YCCK (transform 2) raises, as PIL does."""
    a = content(29, 37, 4, "noisy", 6)
    data = torch_jpeg_tools.lossless(a, 6)
    assert Image.open(io.BytesIO(data)).mode == "CMYK"
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), 255 - a)
    i = data.index(b"\xff\xee")
    assert assert_as_pil(data[:i] + data[i + 16:]) == "pixels"
    ycck = bytearray(data)
    ycck[i + 15] = 2
    assert assert_as_pil(bytes(ycck)) == "raise"
    assert assert_as_pil(torch_jpeg_tools.lossless(content(9, 13, 3, "smooth"), colour="ycc")) == "raise"


# ---- what libjpeg refuses ----

def edited(data: bytes, marker: bytes, at: int, value: int) -> bytes:
    """`data` with the byte `at` past its first `marker` set to `value`."""
    out = bytearray(data)
    out[data.index(marker) + at] = value
    return bytes(out)


def refusal_cases(data: bytes, restarts: bytes):
    sos = data.index(b"\xff\xda")
    n = data[sos + 4]
    ss = sos + 5 + 2 * n  # Ss, Se, Ah << 4 | Al
    dht = data.index(b"\xff\xc4")
    dht_n = struct.unpack(">H", data[dht + 2:dht + 4])[0]
    symbols = dht + 4 + 17 + sum(data[dht + 5:dht + 21]) - 1  # the last symbol of table 0
    dri = restarts.index(b"\xff\xdd")
    return {  # name: (data, the port's words)
        "predictor 0": (edited(data, b"\xff\xda", ss - sos, 0), r"a lossless scan with predictor 0"),
        "predictor 8": (edited(data, b"\xff\xda", ss - sos, 8), r"a lossless scan with predictor 8"),
        "Se 63": (edited(data, b"\xff\xda", ss - sos + 1, 63), r"Se 63"),
        "Ah 1": (edited(data, b"\xff\xda", ss - sos + 2, 0x10), r"Ah 1"),
        "Pt 8": (edited(data, b"\xff\xda", ss - sos + 2, 0x08), r"Pt 8"),
        "no Huffman table": (data[:dht] + data[dht + 2 + dht_n:], r"an undefined Huffman table 0/0"),
        "symbol 17": (edited(data, b"\xff\xc4", symbols - dht, 17), r"a lossless Huffman symbol over 16"),
        "restart inside a row": (edited(restarts, b"\xff\xdd", 5, 5), r"a lossless restart interval of 5 MCUs"),
        "restart over a row": (edited(restarts, b"\xff\xdd", 5, 40), r"a lossless restart interval of 40 MCUs"),
        "12-bit": (edited(data, b"\xff\xc3", 4, 12), r"12-bit samples"),
        "SOF11": (edited(data, b"\xff\xc3", 1, 0xCB), r"arithmetic-coded lossless JPEG \(SOF11"),
    }


CASES = ["predictor 0", "predictor 8", "Se 63", "Ah 1", "Pt 8", "no Huffman table", "symbol 17",
         "restart inside a row", "restart over a row", "12-bit", "SOF11"]


@pytest.mark.parametrize("case", CASES)
def test_refusals_name_the_file_and_the_fault(tmp_path, writer, case):
    """Where libjpeg-turbo stops with an error, PIL raises, and the port
    raises naming the file and the fault: a scan header other than Ss 1-7,
    Se 0, Ah 0, Pt 0-7; no Huffman table (lossless mode loads no standard
    one); a symbol over 16; a restart interval that is not whole MCU rows
    (37 MCUs here); a precision other than 8; SOF11."""
    a = content(29, 37, 3, "smooth", 1)
    data, words = refusal_cases(torch_jpeg_tools.lossless(a, 4), torch_jpeg_tools.lossless(a, 4, rows=1))[case]
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).load()
    path = tmp_path / "refused.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=words) as err:
        jpeg.read_jpeg(path)
    assert str(path) in str(err.value)


def test_category_16_reads_as_pil(writer):
    """A difference of category 16 (32768, no extra bits): the last symbol
    of the table made 16, so that the samples coded with it wrap mod 2^16."""
    data = torch_jpeg_tools.lossless(content(29, 37, 3, "noisy", 1), 1)
    dht = data.index(b"\xff\xc4")
    last = dht + 4 + 17 + sum(data[dht + 5:dht + 21]) - 1
    assert assert_as_pil(edited(data, b"\xff\xc4", last - dht, 16)) == "pixels"


def test_a_component_in_no_scan_fails_as_pil(writer):
    """A file of one-component scans that ends after its first: libjpeg-turbo
    reads the other components' samples, which it never wrote (Bogus
    virtual array access), and PIL raises."""
    data = torch_jpeg_tools.lossless(content(29, 37, 3, "smooth", 1), 2, one_component_scans=True)
    second = data.index(b"\xff\xc4", data.index(b"\xff\xda"))
    with pytest.raises(ValueError, match="component 1 is in no scan"):
        jpeg.decode_jpeg(data[:second] + b"\xff\xd9")
    assert assert_as_pil(data[:second] + b"\xff\xd9") == "raise"


# ---- recovery ----

@pytest.mark.parametrize("base", ["rgb_restarts", "grey", "one_component_scans"])
def test_corrupted_files_read_or_fail_as_pil(writer, base):
    """Seeded byte flips in a small lossless file: bad Huffman codes,
    data that ends early (the rest of the MCU row decoded from zeros, the
    rows after it level 2^(7 - Pt) << Pt), restart markers out of place:
    PIL's pixels where PIL returns an image, a ValueError where it raises,
    each outcome at least 20 of 150."""
    if base == "rgb_restarts":
        data = torch_jpeg_tools.lossless(content(12, 16, 3, "smooth", 5), 4, 0, rows=2)
    elif base == "grey":
        data = torch_jpeg_tools.lossless(content(12, 16, 1, "noisy", 5), 7, 1)
    else:
        data = lossless_jpeg(content(12, 16, 3, "smooth", 5), SAMPLINGS["4:2:0"], 5, 2, 2, True)
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
    interleaved, with restarts, one-component scans, grey."""
    a = content(29, 37, 3, "smooth", 1)
    outcomes = {"pixels": 0, "raise": 0}
    for data in (torch_jpeg_tools.lossless(a, 1), torch_jpeg_tools.lossless(a, 6, 1, rows=2),
                 torch_jpeg_tools.lossless(a, 2, one_component_scans=True),
                 torch_jpeg_tools.lossless(a[..., :1], 3, rows=1)):
        for cut in range(len(data) // 3, len(data), max(1, len(data) // 30)):
            for tail in (b"", b"\xff\xd9"):
                outcomes[assert_as_pil(data[:cut] + tail)] += 1
    assert min(outcomes.values()) >= 20, outcomes


# ---- JPEG-in-TIFF ----

@pytest.mark.parametrize("photometric", [2, 1, 6])
def test_lossless_jpeg_in_tiff_strips_read_or_fail_as_pil(tmp_path, cxx, photometric):
    """Compression 7 strips whose streams are lossless: PIL's libtiff reads
    RGB and grey ones, as the port does; a YCbCr TIFF, which libtiff has
    libjpeg convert to RGB, raises in both (no colour conversion in
    lossless mode)."""
    channels = 1 if photometric == 1 else 3
    a = content(32, 40, channels, "smooth", 2)

    def encode(x):
        return lossless_jpeg(np.ascontiguousarray(x), SAMPLINGS["4:2:0"] if photometric == 6 else None, 1,
                             marker=None)

    data = tiff_bytes(a, 8, photometric, compression=7, rows_per_strip=16, encode=encode,
                      ycbcr=(2, 2) if photometric == 6 else None)
    path = tmp_path / "lossless.tif"
    path.write_bytes(data)
    if photometric == 6:
        with pytest.raises(OSError):
            Image.open(path).load()
        with pytest.raises(ValueError, match="a lossless YCbCr JPEG"):
            image_io.open_image(path)
        return
    want = pil_pixels(data)
    np.testing.assert_array_equal(image_io.open_image(path).pixels.reshape(want.shape), want)


# ---- the dataset paths ----

def test_lossless_datasets_match_jax(tmp_path, monkeypatch, writer):
    """COLMAP and Blender datasets of lossless views (predictors 1 and 7,
    Pt 1, subsampled with restarts, one-component scans, grey) read as the
    JAX package reads them through PIL."""
    w, h = 45, 37
    a = content(h, w, 3, "smooth", 4)
    views = {
        "p1.jpg": torch_jpeg_tools.lossless(a, 1),
        "p7pt1.jpg": torch_jpeg_tools.lossless(a[::-1].copy(), 7, 1),
        "sub.jpg": lossless_jpeg(a[:, ::-1].copy(), SAMPLINGS["4:2:0"], 4, 0, 2, marker=None),
        "scans.jpg": lossless_jpeg(a, None, 5, 0, 1, True, psvs=[5, 6, 2]),
        "grey.jpg": torch_jpeg_tools.lossless(a[..., :1], 3, rows=4),
    }
    assert_datasets_match_jax(tmp_path, monkeypatch, views, w, h)
