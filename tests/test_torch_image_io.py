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


def pack_rows(samples, depth, filters):
    """PNG rows of integer samples (h, w, spp) at `depth` bits: packed
    most significant first (16 bits big-endian), row y filtered with
    filters[y % len(filters)] by the specification's formulas."""
    h, w, spp = samples.shape
    if depth == 16:
        body = samples.astype(">u2").view(np.uint8).reshape(h, w * spp * 2)
    elif depth == 8:
        body = samples.astype(np.uint8).reshape(h, w * spp)
    else:
        per = 8 // depth
        flat = samples.reshape(h, w * spp).astype(np.uint8)
        flat = np.pad(flat, ((0, 0), (0, -flat.shape[1] % per)))
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        body = (flat.reshape(h, -1, per) << shifts).sum(axis=2).astype(np.uint8)
    bpp = max(1, spp * depth // 8)
    x = body.astype(np.int64)
    out = []
    for y in range(h):
        cur, prev = x[y], x[y - 1] if y else np.zeros_like(x[y])
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        f = filters[y % len(filters)]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            q = left + prev - upleft
            pa, pb, pc = np.abs(q - left), np.abs(q - prev), np.abs(q - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([f]) + ((cur - pred) & 255).astype(np.uint8).tobytes())
    return b"".join(out)


def png_form(samples, depth, color, interlace=False, plte=None, trns=None, filters=(0, 1, 2, 3, 4)):
    """A PNG of integer samples (h, w, spp) in any colour type and bit
    depth, Adam7-interlaced if asked, with PLTE and tRNS chunks."""
    h, w, _ = samples.shape
    if interlace:
        raw = b"".join(pack_rows(samples[y0::dy, x0::dx], depth, filters)
                       for x0, y0, dx, dy in image_io.ADAM7 if samples[y0::dy, x0::dx].size)
    else:
        raw = pack_rows(samples, depth, filters)
    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace))
    return (image_io.PNG_SIGNATURE + chunk(b"IHDR", header)
            + (chunk(b"PLTE", plte) if plte is not None else b"")
            + (chunk(b"tRNS", trns) if trns is not None else b"")
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def form_cases():
    """name: PNG bytes of every form PIL reads, 13x11 (odd, so Adam7's
    passes and the packed bytes end part-way), random samples."""
    rng = np.random.default_rng(5)
    h, w = 11, 13

    def samples(spp, depth):
        return rng.integers(0, 1 << depth, (h, w, spp), dtype=np.int64)

    cases = {}
    for depth in (1, 2, 4, 8):
        n = min(1 << depth, 7 if depth > 2 else 1 << depth)  # some indices past a short PLTE
        plte = rng.integers(0, 256, 3 * n, dtype=np.uint8).tobytes()
        idx = samples(1, depth)
        cases[f"palette {depth}-bit"] = png_form(idx, depth, 3, plte=plte)
        cases[f"palette {depth}-bit tRNS"] = png_form(idx, depth, 3, plte=plte,
                                                      trns=rng.integers(0, 256, max(n - 1, 1), dtype=np.uint8).tobytes())
        cases[f"palette {depth}-bit tRNS one clear"] = png_form(idx, depth, 3, plte=plte, trns=b"\xff\x00")
    for depth in (1, 2, 4, 8, 16):
        grey = samples(1, depth)
        cases[f"grey {depth}-bit"] = png_form(grey, depth, 0)
        value = int(grey[0, 0, 0])
        cases[f"grey {depth}-bit tRNS"] = png_form(grey, depth, 0, trns=struct.pack(">H", value))
    cases["grey 16-bit tRNS 255"] = png_form(np.minimum(samples(1, 16), 600), 16, 0, trns=struct.pack(">H", 255))
    for depth in (8, 16):
        rgb = samples(3, depth)
        cases[f"RGB {depth}-bit"] = png_form(rgb, depth, 2)
        key = rgb[1, 2] if depth == 8 else (rgb[1, 2] >> 8) * 257  # a pixel's colour, in PIL's compare
        cases[f"RGB {depth}-bit tRNS"] = png_form(rgb, depth, 2, trns=struct.pack(">3H", *key))
        cases[f"grey + alpha {depth}-bit"] = png_form(samples(2, depth), depth, 4)
        cases[f"RGBA {depth}-bit"] = png_form(samples(4, depth), depth, 6)
    for name in ["palette 4-bit tRNS", "grey 2-bit", "grey 16-bit", "RGB 8-bit tRNS", "grey + alpha 16-bit",
                 "RGBA 8-bit", "RGB 16-bit"]:
        depth = int(name.split()[-2 if name.endswith("tRNS") else -1].split("-")[0])
        spp, color = {"palette": (1, 3), "grey": (1, 0), "RGB": (3, 2), "grey + alpha": (2, 4),
                      "RGBA": (4, 6)}[name.rsplit(" ", 2 if name.endswith("tRNS") else 1)[0]]
        rng2 = np.random.default_rng(len(name))
        a = rng2.integers(0, 1 << depth, (h, w, spp), dtype=np.int64)
        extra = {}
        if color == 3:
            extra = dict(plte=bytes(range(48)), trns=bytes([0, 50, 100, 150]))
        elif name.endswith("tRNS"):
            extra = dict(trns=struct.pack(">3H", *a[0, 0]))
        cases[f"Adam7 {name}"] = png_form(a, depth, color, interlace=True, **extra)
    return cases


FORMS = form_cases()


@pytest.mark.parametrize("name", list(FORMS))
def test_every_png_form_reads_as_pil(tmp_path, name):
    """read_image gives np.asarray(Image.open(f)) (a channel axis kept)
    and open_image PIL's mode and transparency; to_rgba gives PIL's
    convert("RGBA"), bit for bit."""
    path = tmp_path / "form.png"
    path.write_bytes(FORMS[name])
    im = Image.open(path)
    picture = image_io.open_image(path)
    assert picture.mode == im.mode
    assert picture.transparency == im.info.get("transparency")
    np.testing.assert_array_equal(image_io.read_image(path), pil_pixels(path))
    assert image_io.read_image(path).dtype == pil_pixels(path).dtype
    np.testing.assert_array_equal(image_io.to_rgba(picture), np.asarray(Image.open(path).convert("RGBA")))


@pytest.mark.parametrize("case,match", [
    ("16-bit", "16-bit"), ("palette", "palette"), ("interlaced", "interlaced"),
    ("jpeg", "JPEG"), ("text", "not a PNG"), ("2-bit", "2-bit"), ("trns", "tRNS"),
])
def test_reader_refuses_what_it_cannot_read(tmp_path, case, match):
    """The port refuses what PIL's PNG reader refuses, naming the file and
    the feature: a JPEG (read_image reads it) and a file that is no image.
    The 16-bit, palette, interlaced, 2-bit and tRNS files, once refused,
    read as PIL reads them: the same pixels, mode and convert("RGBA")."""
    path = tmp_path / f"{case}.img"
    a = pixels(8, 8, 3, seed=1)
    if case == "16-bit":
        Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(path, format="PNG")
    elif case == "palette":
        pil_image(a).convert("P").save(path, format="PNG")
    elif case == "interlaced":
        path.write_bytes(png_form(a.astype(np.int64), 8, 2, interlace=True))
    elif case == "jpeg":
        pil_image(a).save(path, format="JPEG")
    elif case == "text":
        path.write_bytes(b"not an image at all")
    elif case == "2-bit":
        path.write_bytes(png_bytes(a[..., :1] // 64, [0] * 8, depth=2))
    else:
        path.write_bytes(png_bytes(a, [0] * 8, extra=chunk(b"tRNS", b"\x00\x00\x00\x00\x00\x00")))
    if case in ("jpeg", "text"):
        if case == "jpeg":
            Image.open(path).load()  # PIL reads it
        with pytest.raises(ValueError, match=match) as err:
            image_io.read_png(path)
        assert str(path) in str(err.value)
        return
    np.testing.assert_array_equal(image_io.read_png(path), pil_pixels(path))
    assert image_io.open_png(path).mode == Image.open(path).mode
    np.testing.assert_array_equal(image_io.to_rgba(image_io.open_png(path)),
                                  np.asarray(Image.open(path).convert("RGBA")))


def test_reader_checks_crc(tmp_path):
    """PIL checks the CRC of the chunks before the image data only: a bad
    one there is refused, naming the CRC; a byte flipped in the IDAT body
    (here its zlib checksum) is refused as PIL refuses it, by the data
    stream, not the CRC; a bad IDAT CRC alone reads as PIL reads it."""
    good = png_bytes(pixels(4, 4, 3, seed=2), [1] * 4)
    data = bytearray(good)
    data[-20] ^= 0xFF  # inside the IDAT body
    path = tmp_path / "bad.png"
    path.write_bytes(bytes(data))
    with pytest.raises(Exception):
        np.asarray(Image.open(path))
    with pytest.raises(ValueError, match="broken PNG image data") as err:
        image_io.read_png(path)
    assert str(path) in str(err.value)
    header = bytearray(good)
    header[8 + 8 + 13] ^= 0xFF  # IHDR's CRC
    path.write_bytes(bytes(header))
    with pytest.raises(ValueError, match="CRC"):
        image_io.read_png(path)
    idat_crc = bytearray(good)
    idat_crc[-13] ^= 0xFF  # the IDAT CRC's last byte
    path.write_bytes(bytes(idat_crc))
    np.testing.assert_array_equal(image_io.read_png(path), pil_pixels(path))


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
