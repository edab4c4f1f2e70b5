"""The port's PNG codec and resize (`gaussian_splatting_torch/utils/image_io.py`)
against PIL and imageio, which the JAX package reads and writes images with.

Tolerances: every comparison is bit-equal. The resize of LA and RGBA
images is bit-equal too: the port reproduces PIL's premultiplied path
(`La` / `RGBa`), its MULDIV255 on the way in and its truncating division
on the way out.
"""

import io
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from gaussian_splatting_torch.utils import image_io

MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def pixels(h, w, c, seed):
    """Smooth gradients with noise (so PIL's encoder picks several filters),
    and, with an alpha channel, rows of alpha 0 and 255 and random alpha."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 100 * np.sin(xx / (3 + i) + yy / (5 + i)) + rng.normal(0, 20, (h, w))
                  for i in range(c)], -1)
    a = np.clip(a, 0, 255).astype(np.uint8)
    if c in (2, 4):
        a[..., -1] = rng.integers(0, 256, (h, w))
        a[:3, :, -1] = 0
        a[3:6, :, -1] = 255
    return a


def pil_image(a):
    return Image.fromarray(a[..., 0] if a.shape[2] == 1 else a, MODES[a.shape[2]])


def pil_pixels(path):
    a = np.asarray(Image.open(path))
    return a[..., None] if a.ndim == 2 else a


def chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def png_bytes(a, filters, depth=8, color=None, interlace=0, extra=b""):
    """A PNG of uint8 pixels a (H, W, C) whose row y takes filter
    filters[y] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), encoded here by
    the PNG specification's formulas."""
    H, W, C = a.shape
    x = a.astype(np.int64)
    rows = []
    for y in range(H):
        cur = x[y].reshape(-1)
        prev = x[y - 1].reshape(-1) if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(C, np.int64), cur[:-C]])
        upleft = np.concatenate([np.zeros(C, np.int64), prev[:-C]])
        f = filters[y]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        rows.append(bytes([f]) + ((cur - pred) & 255).astype(np.uint8).tobytes())
    color = {1: 0, 2: 4, 3: 2, 4: 6}[C] if color is None else color
    header = struct.pack(">IIBBBBB", W, H, depth, color, 0, 0, interlace)
    return (image_io.PNG_SIGNATURE + chunk(b"IHDR", header) + extra
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def row_filters(path):
    """The set of row filter types in a PNG file."""
    data, pos, idat, header = path.read_bytes(), 8, b"", None
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, color = header[0], header[1], header[3]
    stride = 1 + w * {0: 1, 2: 3, 4: 2, 6: 4}[color]
    raw = zlib.decompress(idat)
    return {raw[y * stride] for y in range(h)}


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_reader_matches_pil_on_pil_files(tmp_path, channels):
    for k, (h, w) in enumerate([(23, 37), (48, 64), (5, 1)]):
        a = pixels(h, w, channels, seed=10 * channels + k)
        path = tmp_path / f"pil_{k}.png"
        pil_image(a).save(path)
        got = image_io.read_png(path)
        assert got.dtype == np.uint8 and got.shape == (h, w, channels)
        np.testing.assert_array_equal(got, pil_pixels(path))
        np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_reader_matches_pil_on_every_filter(tmp_path, channels):
    """Rows cycling through all five filters, runs of Up and Sub rows, and
    files of None / Sub / Up rows only (the reader's vectorised path)."""
    h, w = 23, 37
    a = pixels(h, w, channels, seed=channels)
    cases = {
        "cycle": [y % 5 for y in range(h)],
        "runs": [2, 2, 1, 1, 1, 2, 2, 2, 0, 2, 4, 3, 3, 2, 1, 0, 0, 2, 2, 4, 4, 1, 2],
        "no_avg_paeth": [(2, 2, 1, 0, 2)[y % 5] for y in range(h)],
        "up_first": [2, 2, 2] + [1] * (h - 3),
    }
    seen = set()
    for name, filters in cases.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(png_bytes(a, filters))
        seen |= row_filters(path)
        np.testing.assert_array_equal(image_io.read_png(path), pil_pixels(path), err_msg=name)
        np.testing.assert_array_equal(image_io.read_png(path), a, err_msg=name)
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_writer_decodes_equal_through_pil_and_imageio(tmp_path, channels):
    a = pixels(23, 37, channels, seed=40 + channels)
    path = tmp_path / "w.png"
    image_io.write_png(path, a[..., 0] if channels == 1 else a)
    np.testing.assert_array_equal(pil_pixels(path), a)
    back = imageio.imread(path)
    np.testing.assert_array_equal(back[..., None] if back.ndim == 2 else back, a)
    np.testing.assert_array_equal(image_io.read_png(path), a)


def policy_targets(w, h):
    """The resolution policy's targets (dataset_readers.load_camera):
    -r 2, 4 and 8, and the 1600-pixel width cap when w > 1600 (else a
    non-power-of-two -r)."""
    out = [(round(w / r), round(h / r)) for r in (2, 4, 8)]
    scale = w / 1600 if w > 1600 else w / max(w // 3, 1)
    out.append((int(w / scale), int(h / scale)))
    return out


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_resize_matches_pil(channels):
    """Bit-equal to PIL.Image.resize at its default (BICUBIC) for L, LA,
    RGB and RGBA, down by 2, 4, 8 and to the width cap (1700x40 ->
    1600x37), and where one dimension keeps its size (one pass only)."""
    for k, (h, w) in enumerate([(40, 1700), (48, 64), (23, 37)]):
        a = pixels(h, w, channels, seed=60 + 4 * channels + k)
        im = pil_image(a)
        targets = policy_targets(w, h) + [(w, max(h // 2, 1)), (max(w // 3, 1), h), (w, h)]
        if (w, h) == (1700, 40):
            assert (1600, 37) in targets
        for size in targets:
            got = image_io.resize(a[..., 0] if channels == 1 else a, size)
            want = np.asarray(im.resize(size))
            np.testing.assert_array_equal(got, want, err_msg=f"{MODES[channels]} {w}x{h} -> {size}")
            if channels > 1:
                np.testing.assert_array_equal(image_io.resize(a, size), want)


def test_resize_upscales_like_pil():
    a = pixels(9, 13, 3, seed=7)
    for size in [(26, 18), (20, 9), (13, 30)]:
        np.testing.assert_array_equal(image_io.resize(a, size), np.asarray(pil_image(a).resize(size)))


@pytest.mark.parametrize("case,match", [
    ("16-bit", "16-bit"), ("palette", "palette"), ("interlaced", "interlaced"),
    ("jpeg", "JPEG"), ("text", "not a PNG"), ("2-bit", "2-bit"), ("trns", "tRNS"),
])
def test_reader_refuses_what_it_cannot_read(tmp_path, case, match):
    """The port refuses each of these, naming the file and the feature;
    PIL reads the 16-bit, palette and JPEG files."""
    path = tmp_path / f"{case}.img"
    a = pixels(8, 8, 3, seed=1)
    if case == "16-bit":
        Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(path, format="PNG")
    elif case == "palette":
        pil_image(a).convert("P").save(path, format="PNG")
    elif case == "interlaced":
        path.write_bytes(png_bytes(a, [0] * 8, interlace=1))
    elif case == "jpeg":
        pil_image(a).save(path, format="JPEG")
    elif case == "text":
        path.write_bytes(b"not an image at all")
    elif case == "2-bit":
        path.write_bytes(png_bytes(a[..., :1] // 64, [0] * 8, depth=2))
    else:
        path.write_bytes(png_bytes(a, [0] * 8, extra=chunk(b"tRNS", b"\x00\x00\x00\x00\x00\x00")))
    if case not in ("interlaced", "text", "2-bit", "trns"):
        Image.open(path).load()  # PIL reads it
    with pytest.raises(ValueError, match=match) as err:
        image_io.read_png(path)
    assert str(path) in str(err.value)


def test_reader_checks_crc(tmp_path):
    path = tmp_path / "bad.png"
    data = bytearray(png_bytes(pixels(4, 4, 3, seed=2), [1] * 4))
    data[-20] ^= 0xFF  # inside the IDAT body
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        image_io.read_png(path)


def test_writer_round_trip_large(tmp_path):
    """A 1080p RGB image through the writer and the reader, and through
    PIL's encoder (its adaptive filters) and the reader."""
    rng = np.random.default_rng(3)
    a = np.clip(rng.normal(128, 40, (1080, 1920, 3)), 0, 255).astype(np.uint8)
    image_io.write_png(tmp_path / "a.png", a)
    np.testing.assert_array_equal(image_io.read_png(tmp_path / "a.png"), a)
    buf = io.BytesIO()
    pil_image(a[:200, :300]).save(buf, format="PNG")
    (tmp_path / "b.png").write_bytes(buf.getvalue())
    np.testing.assert_array_equal(image_io.read_png(tmp_path / "b.png"), a[:200, :300])
