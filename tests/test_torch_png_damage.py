"""Damaged PNGs read as PIL 12.1.0 reads them.

PIL checks the CRC of the chunks before the image data only. It reads the
IDAT run without a CRC check, stops its decoder as soon as the last row is
whole, and reads the chunks after it (`load_end`) without a CRC check,
stopping at IEND or at a chunk header it cannot read; a PLTE there never
reaches the image, a tRNS there does. Every file here is made from
`np.random.default_rng(seed)`; PIL's reading of it is the rule: the same
mode, pixels, transparency and `convert("RGBA")`, or a `ValueError`
naming the file where PIL raises.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from gaussian_splatting_torch.utils import image_io
from test_torch_image_io import chunk, pack_rows

SIG = image_io.PNG_SIGNATURE
W, H = 64, 48


def bad_crc(kind, body):
    """A chunk whose CRC is off by one."""
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", (zlib.crc32(kind + body) + 1) & 0xFFFFFFFF)


def ihdr(w=W, h=H, depth=8, color=2, compression=0, filt=0, interlace=0):
    return chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, compression, filt, interlace))


def rgb_picture(seed=0, w=W, h=H):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.int64)


def rgb_stream(seed=0, w=W, h=H, interlace=False):
    """The zlib stream of a random RGB picture, rows Sub-filtered (Adam7's
    passes one after the other where asked)."""
    a = rgb_picture(seed, w, h)
    if interlace:
        raw = b"".join(pack_rows(a[y0::dy, x0::dx], 8, (1,))
                       for x0, y0, dx, dy in image_io.ADAM7 if a[y0::dy, x0::dx].size)
    else:
        raw = pack_rows(a, 8, (1,))
    return zlib.compress(raw), raw


Z, RAW = rgb_stream()
IEND = chunk(b"IEND", b"")
PALETTE = bytes([255, 0, 0, 0, 255, 0, 0, 0, 255])
IDX = np.random.default_rng(1).integers(0, 3, (H, W, 1), dtype=np.int64)
ZP = zlib.compress(pack_rows(IDX, 8, (0,)))
IHDR_P = ihdr(color=3)


def pil_reading(data: bytes):
    """(mode, pixels with a channel axis, transparency, RGBA) as PIL reads
    the bytes, or None where PIL raises."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            px = np.asarray(im)
            return im.mode, px[..., None] if px.ndim == 2 else px, im.info.get("transparency"), \
                np.asarray(im.convert("RGBA"))
    except Exception:  # noqa: BLE001  (any of PIL's errors: the port must raise too)
        return None


def assert_reads_as_pil(tmp_path, data: bytes, label=""):
    """The port reads `data` as PIL does, or raises naming the file where
    PIL raises; returns PIL's reading (None where it raises)."""
    want = pil_reading(data)
    path = tmp_path / "damaged.png"
    path.write_bytes(data)
    if want is None:
        with pytest.raises(ValueError) as err:
            image_io.open_image(path)
        assert str(path) in str(err.value), label
        return None
    got = image_io.open_image(path)
    assert got.mode == want[0], (label, got.mode, want[0])
    assert got.pixels.dtype == want[1].dtype and got.pixels.shape == want[1].shape, label
    np.testing.assert_array_equal(got.pixels, want[1], err_msg=label)
    assert got.transparency == want[2], (label, got.transparency, want[2])
    np.testing.assert_array_equal(image_io.to_rgba(got), want[3], err_msg=label)
    return want


def adam7_stream():
    return rgb_stream(interlace=True)[0]


# name: (bytes, True where PIL reads the picture, False where it raises)
CASES = {
    # the rows of the damage table, each probed against PIL 12.1.0
    "bad CRC on the only IDAT": (SIG + ihdr() + bad_crc(b"IDAT", Z) + IEND, True),
    "bad CRC on the second of two IDATs": (SIG + ihdr() + chunk(b"IDAT", Z[:40]) + bad_crc(b"IDAT", Z[40:]) + IEND,
                                          True),
    "bad CRC on a tEXt after IDAT": (SIG + ihdr() + chunk(b"IDAT", Z) + bad_crc(b"tEXt", b"k\0v") + IEND, True),
    "bad CRC on IEND": (SIG + ihdr() + chunk(b"IDAT", Z) + bad_crc(b"IEND", b""), True),
    "PLTE only after IDAT (every index black)": (SIG + IHDR_P + chunk(b"IDAT", ZP) + chunk(b"PLTE", PALETTE) + IEND,
                                                 True),
    "zlib stream 10 bytes short": (SIG + ihdr() + chunk(b"IDAT", Z[:-10]) + IEND, False),
    "bad CRC on a tEXt before IDAT": (SIG + ihdr() + bad_crc(b"tEXt", b"k\0v") + chunk(b"IDAT", Z) + IEND, False),
    # the image data
    "bad zlib checksum": (SIG + ihdr() + chunk(b"IDAT", Z[:-4] + bytes(4)) + IEND, False),
    "a byte of the deflate data flipped": (SIG + ihdr() + chunk(b"IDAT", Z[:10] + bytes([Z[10] ^ 0xFF]) + Z[11:])
                                           + IEND, False),
    "bytes after the zlib stream": (SIG + ihdr() + chunk(b"IDAT", Z + b"trailing") + IEND, True),
    "a stream of more rows than the image": (SIG + ihdr() + chunk(b"IDAT", zlib.compress(RAW + RAW[:200])) + IEND,
                                             True),
    "a whole stream of too few rows": (SIG + ihdr() + chunk(b"IDAT", zlib.compress(RAW[:-10])) + IEND, False),
    "the file cut inside the zlib checksum": ((SIG + ihdr() + chunk(b"IDAT", Z))[:-6], True),
    "the file cut at the zlib checksum's first byte": ((SIG + ihdr() + chunk(b"IDAT", Z))[:-7], True),
    "a tEXt between two IDATs": (SIG + ihdr() + chunk(b"IDAT", Z[:20]) + chunk(b"tEXt", b"a\0b")
                                 + chunk(b"IDAT", Z[20:]) + IEND, False),
    "empty IDATs around the data": (SIG + ihdr() + chunk(b"IDAT", b"") + chunk(b"IDAT", Z) + chunk(b"IDAT", b"")
                                    + IEND, True),
    "an IDAT after the data running past the end": (SIG + ihdr() + chunk(b"IDAT", Z) + struct.pack(">I", 1000)
                                                    + b"IDAT" + b"x" * 20, False),
    "the last IDAT running past the end, needed": (SIG + ihdr() + chunk(b"IDAT", Z[:30])
                                                   + struct.pack(">I", len(Z) + 1000) + b"IDAT" + Z[30:], True),
    "a stream split over IDATs of one byte": (SIG + ihdr() + b"".join(chunk(b"IDAT", Z[i:i + 1])
                                                                      for i in range(len(Z))) + IEND, True),
    "an unknown chunk (DDAT) inside the image data": (SIG + ihdr() + chunk(b"IDAT", Z[:50]) + chunk(b"DDAT", Z[50:])
                                                      + IEND, True),
    # chunks after the image data
    "a tEXt after the data running past the end": (SIG + ihdr() + chunk(b"IDAT", Z) + struct.pack(">I", 1000)
                                                   + b"tEXt" + b"x" * 20, False),
    "an unknown chunk after the data running past the end": (SIG + ihdr() + chunk(b"IDAT", Z)
                                                             + struct.pack(">I", 1000) + b"abcd" + b"x" * 20, False),
    "a chunk type PIL cannot read after the data": (SIG + ihdr() + chunk(b"IDAT", Z) + chunk(b"t#Xt", b"a")
                                                    + chunk(b"gAMA", b"") + IEND, True),
    "a header cut short after the data": (SIG + ihdr() + chunk(b"IDAT", Z) + b"\0\0\0", True),
    "no IEND": (SIG + ihdr() + chunk(b"IDAT", Z), True),
    "tRNS after the data (RGB)": (SIG + ihdr() + chunk(b"IDAT", Z) + chunk(b"tRNS", struct.pack(">3H", 1, 2, 3))
                                  + IEND, True),
    "tRNS of 2 bytes after the data (RGB)": (SIG + ihdr() + chunk(b"IDAT", Z) + chunk(b"tRNS", b"\0\1") + IEND,
                                             False),
    "tRNS of 4 bytes before the data (RGB)": (SIG + ihdr() + chunk(b"tRNS", bytes(4)) + chunk(b"IDAT", Z) + IEND,
                                              False),
    "cHRM of 5 bytes after the data": (SIG + ihdr() + chunk(b"IDAT", Z) + chunk(b"cHRM", bytes(5)) + IEND, False),
    "gAMA of 2 bytes after the data": (SIG + ihdr() + chunk(b"IDAT", Z) + chunk(b"gAMA", bytes(2)) + IEND, False),
    "pHYs of 2 bytes after the data": (SIG + ihdr() + chunk(b"IDAT", Z) + chunk(b"pHYs", bytes(2)) + IEND, False),
    "sRGB of no bytes after the data": (SIG + ihdr() + chunk(b"IDAT", Z) + chunk(b"sRGB", b"") + IEND, False),
    "IHDR of 2 bytes after the data": (SIG + ihdr() + chunk(b"IDAT", Z) + chunk(b"IHDR", bytes(2)) + IEND, False),
    "IHDR with a filter method after the data": (SIG + ihdr() + chunk(b"IDAT", Z) + ihdr(filt=1) + IEND, False),
    "iCCP of no bytes after the data": (SIG + ihdr() + chunk(b"IDAT", Z) + chunk(b"iCCP", b"") + IEND, False),
    "iCCP of compression method 1 after the data": (SIG + ihdr() + chunk(b"IDAT", Z) + chunk(b"iCCP", b"p\0\1x")
                                                    + IEND, False),
    "zTXt of compression method 1 after the data": (SIG + ihdr() + chunk(b"IDAT", Z) + chunk(b"zTXt", b"k\0\1")
                                                    + IEND, False),
    "zTXt of broken zlib data after the data": (SIG + ihdr() + chunk(b"IDAT", Z) + chunk(b"zTXt", b"k\0\0xyz")
                                                + IEND, True),
    "iTXt of bad UTF-8 after the data": (SIG + ihdr() + chunk(b"IDAT", Z) + chunk(b"iTXt", b"k\0\0\0en\0\0\xff")
                                         + IEND, True),
    "fcTL of 4 bytes after the data": (SIG + ihdr() + chunk(b"IDAT", Z) + chunk(b"fcTL", bytes(4)) + IEND, False),
    "fcTL of a frame past the image after the data": (SIG + ihdr() + chunk(b"IDAT", Z) + chunk(
        b"fcTL", struct.pack(">IIIIIHHBB", 0, W, H, 1, 0, 1, 10, 0, 0)) + IEND, False),
    "fdAT out of sequence after the data": (SIG + ihdr() + chunk(b"IDAT", Z) + chunk(b"fdAT", bytes(8)) + IEND,
                                            False),
    "acTL of 4 bytes after the data": (SIG + ihdr() + chunk(b"IDAT", Z) + chunk(b"acTL", bytes(4)) + IEND, False),
    "chunks after IEND never read": (SIG + ihdr() + chunk(b"IDAT", Z) + IEND + chunk(b"gAMA", b""), True),
    # the header
    "interlace method 2 on Adam7 data (PIL: interlaced)": (SIG + ihdr(interlace=2) + chunk(b"IDAT", adam7_stream())
                                                           + IEND, True),
    "interlace method 2 on plain data": (SIG + ihdr(interlace=2) + chunk(b"IDAT", Z) + IEND, False),
    "filter method 1": (SIG + ihdr(filt=1) + chunk(b"IDAT", Z) + IEND, False),
    "compression method 1": (SIG + ihdr(compression=1) + chunk(b"IDAT", Z) + IEND, True),
    "IEND before IDAT": (SIG + ihdr() + IEND + chunk(b"IDAT", Z), False),
    "a second IHDR before the data": (SIG + ihdr(depth=16) + ihdr() + chunk(b"IDAT", Z) + IEND, True),
    # palettes and transparency
    "palette PNG without PLTE": (SIG + IHDR_P + chunk(b"IDAT", ZP) + IEND, True),
    "palette PNG, tRNS after the data": (SIG + IHDR_P + chunk(b"PLTE", PALETTE) + chunk(b"IDAT", ZP)
                                         + chunk(b"tRNS", b"\x10\x20") + IEND, True),
    "palette PNG, one clear entry after the data": (SIG + IHDR_P + chunk(b"PLTE", PALETTE) + chunk(b"IDAT", ZP)
                                                    + chunk(b"tRNS", b"\xff\x00") + IEND, True),
    "palette PNG without PLTE, with tRNS": (SIG + IHDR_P + chunk(b"tRNS", b"\x10\x20") + chunk(b"IDAT", ZP) + IEND,
                                            True),
    "PLTE before IHDR": (SIG + chunk(b"PLTE", PALETTE) + IHDR_P + chunk(b"IDAT", ZP) + IEND, True),
    "a second PLTE after the data": (SIG + IHDR_P + chunk(b"PLTE", PALETTE) + chunk(b"IDAT", ZP)
                                     + chunk(b"PLTE", PALETTE[::-1]) + IEND, True),
    "IHDR of grey after the data, then a 2-byte tRNS": (SIG + ihdr() + chunk(b"IDAT", Z) + ihdr(color=0)
                                                        + chunk(b"tRNS", b"\0\7") + IEND, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_damaged_png_reads_as_pil_reads_it(tmp_path, name):
    data, reads = CASES[name]
    want = assert_reads_as_pil(tmp_path, data, name)
    assert (want is not None) == reads, f"{name}: PIL {'reads' if want is not None else 'raises'}"


def test_zlib_short_names_the_file_not_zlib(tmp_path):
    """A zlib stream that ends early is refused as PIL refuses it ("image
    file is truncated"), naming the file, not as a bare zlib.error."""
    path = tmp_path / "short.png"
    path.write_bytes(CASES["zlib stream 10 bytes short"][0])
    with pytest.raises(ValueError, match="cut short") as err:
        image_io.open_image(path)
    assert str(path) in str(err.value) and not isinstance(err.value, zlib.error)


def test_palette_png_with_late_plte_reads_black(tmp_path):
    """PIL applies no PLTE that follows the image data: every index reads
    (0, 0, 0, 255) after convert("RGBA"), not the late palette's colours."""
    path = tmp_path / "late.png"
    path.write_bytes(CASES["PLTE only after IDAT (every index black)"][0])
    rgba = image_io.to_rgba(image_io.open_image(path))
    assert (rgba == np.array([0, 0, 0, 255], np.uint8)).all()


def test_large_idat_reads_past_pils_read_size(tmp_path):
    """A 300x300 RGB image in one IDAT of more than PIL_READ bytes and in
    IDATs of 10,000 bytes, each with a bad CRC, read as PIL reads them."""
    z, _ = rgb_stream(7, 300, 300)
    assert len(z) > image_io.PIL_READ
    for body in ([z], [z[i:i + 10_000] for i in range(0, len(z), 10_000)]):
        data = SIG + ihdr(300, 300) + b"".join(bad_crc(b"IDAT", b) for b in body) + IEND
        assert assert_reads_as_pil(tmp_path, data) is not None


def base_files():
    """PNGs with chunks after their image data, for the seeded mutations:
    PIL-written RGB and palette files with text after the data, and this
    module's multi-IDAT file with tRNS, tEXt and zTXt after it."""
    a = rgb_picture(3).astype(np.uint8)
    out = {}
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "PNG")
    pil_rgb = buf.getvalue()
    out["PIL RGB + tEXt after"] = pil_rgb[:-12] + chunk(b"tEXt", b"Comment\0damaged") + IEND
    buf = io.BytesIO()
    Image.fromarray(a).quantize(20).save(buf, "PNG")
    pil_p = buf.getvalue()
    out["PIL P + tRNS after"] = pil_p[:-12] + chunk(b"tRNS", bytes(range(0, 200, 10))) + IEND
    out["split RGB + tRNS, tEXt, zTXt after"] = (
        SIG + ihdr() + chunk(b"IDAT", Z[:100]) + chunk(b"IDAT", Z[100:]) + chunk(b"tRNS", struct.pack(">3H", 5, 6, 7))
        + chunk(b"tEXt", b"k\0v") + chunk(b"zTXt", b"z\0\0" + zlib.compress(b"text")) + IEND)
    return out


BASES = base_files()


def last_idat_crc(data: bytes) -> int:
    """The offset of the CRC of the last IDAT chunk."""
    pos, last = 8, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I", data[pos:pos + 4])[0], data[pos + 4:pos + 8]
        if kind == b"IDAT":
            last = pos + 8 + n
        pos += 12 + n
    return last


def chunk_crcs_after(data: bytes, start: int):
    """The offsets of the CRCs of the chunks that follow byte `start`."""
    pos, out = 8, []
    while pos + 8 <= len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        if pos > start:
            out.append(pos + 8 + n)
        pos += 12 + n
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("base", list(BASES))
def test_mutations_after_the_image_data_read_as_pil(tmp_path, base, seed):
    """Seeded single-byte mutations (a byte replaced or a bit flipped) from
    the last IDAT's CRC to the end of the file, and CRC mutations of every
    IDAT and every chunk after the image data: the port reads what PIL
    reads and refuses where PIL raises."""
    data = BASES[base]
    rng = np.random.default_rng(1000 * seed + len(base))
    start = last_idat_crc(data)
    crcs = chunk_crcs_after(data, 0)
    for i in range(24):
        b = bytearray(data)
        if i % 3 == 2:
            at = int(rng.choice(crcs)) + int(rng.integers(0, 4))
            b[at] ^= int(rng.integers(1, 256))
        else:
            at = int(rng.integers(start, len(data)))
            b[at] = int(rng.integers(0, 256)) if i % 3 else b[at] ^ (1 << int(rng.integers(0, 8)))
        assert_reads_as_pil(tmp_path, bytes(b), f"{base} seed {seed} mutation {i} at {at}")
