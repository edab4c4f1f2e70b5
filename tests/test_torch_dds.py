"""The port's DDS reader (`utils/dds.py`, `csrc/bcn_decode.cc`) against PIL
12.1.0, and both dataset paths on DDS views against the JAX package.

Every file is made here from `np.random.default_rng(seed)` by PIL where PIL
writes the form, else by `tests/torch_image_writers.py`; PIL's reading of
it is the rule: `image_io.open_image` gives PIL's mode and pixels,
`to_rgba` its `convert("RGBA")`, bit for bit, and where PIL raises the port
raises a `ValueError` naming the file. The block formats are held to PIL on
4,096 seeded random blocks each, which reach every BC6H and BC7 mode.
"""

import hashlib
import io
import json
import os
import shutil
import struct
import sys

import numpy as np
import pytest
from PIL import Image

from gaussian_splatting_tpu.scene import dataset_readers as jreaders
from gaussian_splatting_torch.scene import dataset_readers
from gaussian_splatting_torch.utils import cuda_build, dds, image_io
from test_torch_image_forms import assert_follows_pil, cxx, smooth, write_colmap_dataset_of  # noqa: F401
from test_torch_jpeg import fake_cxx  # noqa: F401  (a fixture)
from test_torch_scene import assert_same_cameras, orbit_frames
import torch_image_writers as w

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import dds_form_files, sha256_of  # noqa: E402  (the repo root: phase 5i's files)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_dds")
W, H = 29, 21  # neither a multiple of 4: the last blocks cropped
F, A, RGB, LUM, PAL = w.DDPF_FOURCC, w.DDPF_ALPHAPIXELS, w.DDPF_RGB, w.DDPF_LUMINANCE, w.DDPF_PALETTEINDEXED8
ARGB = (0xFF0000, 0xFF00, 0xFF, 0xFF000000)


def picture(seed=0, w_=W, h=H, c=3):
    return smooth(h, w_, c, seed)


def rgba_picture(seed=1, w_=W, h=H):
    a = smooth(h, w_, 4, seed)
    a[..., 3] = np.where(a[..., 3] > 150, 255, np.where(a[..., 3] < 90, 0, a[..., 3]))
    return a


def pil_save(a, mode=None, **options) -> bytes:
    buf = io.BytesIO()
    im = Image.fromarray(a)
    (im.convert(mode) if mode else im).save(buf, "DDS", **options)
    return buf.getvalue()


def random_blocks(n, seed, size=16) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n * size, dtype=np.uint8).tobytes()


def blocks_of(w_=W, h=H):
    return ((w_ + 3) // 4) * ((h + 3) // 4)


def masked(px, bits, masks, flags=RGB, **kw):
    return w.dds_bytes(w.dds_masked(px, bits, masks), px.shape[1], px.shape[0], flags, bitcount=bits,
                       masks=tuple(masks) + (0,) * (4 - len(masks)), **kw)


def header_size(data: bytes, size: int) -> bytes:
    return data[:4] + struct.pack("<I", size) + data[8:]


# ---- every header form and mode, each bit-equal to PIL (or raised where PIL raises) ----

def dds_cases():
    """name: (bytes, True where PIL reads it, False where PIL raises)."""
    a, rgba = picture(10), rgba_picture(11)
    grey = a[..., 0]
    n = blocks_of()
    dxt1 = w.dds_bytes(w.bc1_blocks(a).tobytes(), W, H, F, b"DXT1")
    bc7 = w.dds_bytes(random_blocks(n, 12), W, H, F, dxgi=98)
    rgb32 = masked(rgba, 32, ARGB, RGB | A)
    pal = np.concatenate([np.random.default_rng(13).integers(0, 256, (256, 3)), np.arange(256)[:, None]], -1)
    p8 = w.dds_bytes(pal.astype(np.uint8).tobytes() + grey.tobytes(), W, H, PAL, bitcount=8)
    cases = {
        # PIL's own writer
        "PIL's RGB": (pil_save(a), True),
        "PIL's RGBA": (pil_save(rgba), True),
        "PIL's L": (pil_save(a, "L"), True),
        "PIL's LA": (pil_save(rgba, "LA"), True),
        "PIL's DXT1": (pil_save(rgba, pixel_format="DXT1"), True),
        "PIL's DXT3": (pil_save(rgba, pixel_format="DXT3"), True),
        "PIL's DXT5": (pil_save(rgba, pixel_format="DXT5"), True),
        "PIL's BC2": (pil_save(rgba, pixel_format="BC2"), True),
        "PIL's BC3": (pil_save(rgba, pixel_format="BC3"), True),
        "PIL's BC5": (pil_save(a, pixel_format="BC5"), True),
        # uncompressed, through the masks
        "A8R8G8B8": (rgb32, True),
        "X8R8G8B8": (masked(a, 32, ARGB[:3]), True),
        "R8G8B8 24-bit": (masked(a, 24, ARGB[:3]), True),
        "B8G8R8 24-bit": (masked(a, 24, (0xFF, 0xFF00, 0xFF0000)), True),
        "R5G6B5": (masked(a, 16, (0xF800, 0x7E0, 0x1F)), True),
        "A1R5G5B5": (masked(rgba, 16, (0x7C00, 0x3E0, 0x1F, 0x8000), RGB | A), True),
        "A4R4G4B4": (masked(rgba, 16, (0xF00, 0xF0, 0xF, 0xF000), RGB | A), True),
        "A2B10G10R10": (masked(rgba, 32, (0x3FF, 0xFFC00, 0x3FF00000, 0xC0000000), RGB | A), True),
        "masks with gaps": (masked(a, 32, (0b1010_0000, 0x0F0F00, 0x3 << 28)), True),
        "a zero mask": (masked(a, 32, (0xFF0000, 0, 0xFF)), True),
        "the alpha flag, alpha mask 0": (masked(a, 32, ARGB[:3], RGB | A), True),
        "the top bit alone": (masked(a, 32, (0x80000000, 0x40000000, 0xFF)), True),
        "48-bit pixels": (w.dds_bytes(np.random.default_rng(14).integers(0, 256, W * H * 6, dtype=np.uint8).tobytes(),
                                      W, H, RGB, bitcount=48, masks=ARGB[:3] + (0,)), True),
        "64-bit pixels with alpha": (w.dds_bytes(np.random.default_rng(15).integers(0, 256, W * H * 8,
                                                                                   dtype=np.uint8).tobytes(),
                                                 W, H, RGB | A, bitcount=64, masks=ARGB), True),
        "4-bit pixels (no bytes: black)": (w.dds_bytes(bytes(64), W, H, RGB, bitcount=4, masks=ARGB[:3] + (0,)), True),
        "12-bit pixels (one byte each)": (w.dds_bytes(a.tobytes(), W, H, RGB, bitcount=12, masks=(0xF0, 0xC, 0x3, 0)),
                                          True),
        "uncompressed cut short (zeros past the end)": (rgb32[:-1000], True),
        "uncompressed cut inside a pixel": (rgb32[:-1001], True),
        "uncompressed with no data": (rgb32[:128], True),
        "the RGB flag with a FourCC (RGB first)": (w.dds_bytes(w.dds_masked(a, 24, ARGB[:3]), W, H, RGB | F, b"DXT1",
                                                               bitcount=24, masks=ARGB[:3] + (0,)), True),
        "the RGB and luminance flags": (w.dds_bytes(w.dds_masked(a, 24, ARGB[:3]), W, H, RGB | LUM, bitcount=24,
                                                    masks=ARGB[:3] + (0,)), True),
        # luminance and palette
        "L8": (w.dds_bytes(grey.tobytes(), W, H, LUM, bitcount=8), True),
        "LA16": (w.dds_bytes(np.stack([grey, rgba[..., 3]], -1).tobytes(), W, H, LUM | A, bitcount=16), True),
        "L8 cut short": (w.dds_bytes(grey.tobytes()[:-1], W, H, LUM, bitcount=8), False),
        "luminance of 16 bits without alpha": (w.dds_bytes(grey.tobytes() * 2, W, H, LUM, bitcount=16), False),
        "luminance of 32 bits": (w.dds_bytes(grey.tobytes() * 4, W, H, LUM | A, bitcount=32), False),
        "P8, an RGBA palette": (p8, True),
        "P8 cut short": (p8[:-5], False),
        "P8 palette cut short": (p8[:600], False),
        "the palette flag with a FourCC (palette first)": (p8[:80] + struct.pack("<I", PAL | F) + b"DXT1" + p8[88:],
                                                            True),
        # block formats by FourCC
        "DXT1 of this writer": (dxt1, True),
        "DXT1 of random blocks": (w.dds_bytes(random_blocks(n, 16, 8), W, H, F, b"DXT1"), True),
        "DXT3 of random blocks": (w.dds_bytes(random_blocks(n, 17), W, H, F, b"DXT3"), True),
        "DXT5 of random blocks": (w.dds_bytes(random_blocks(n, 18), W, H, F, b"DXT5"), True),
        "BC4U": (w.dds_bytes(w.bc4_blocks(grey).tobytes(), W, H, F, b"BC4U"), True),
        "ATI1": (w.dds_bytes(random_blocks(n, 19, 8), W, H, F, b"ATI1"), True),
        "ATI2": (w.dds_bytes(random_blocks(n, 20), W, H, F, b"ATI2"), True),
        "BC5U": (w.dds_bytes(w.bc5_blocks(a).tobytes(), W, H, F, b"BC5U"), True),
        "BC5S": (w.dds_bytes(random_blocks(n, 21), W, H, F, b"BC5S"), True),
        "BC7 5x7": (w.dds_bytes(w.bc7_blocks(rgba[:7, :5]).tobytes(), 5, 7, F, dxgi=98), True),
        "BC7 1x1": (w.dds_bytes(random_blocks(1, 22), 1, 1, F, dxgi=98), True),
        "BC1 13x2": (w.dds_bytes(random_blocks(4, 23, 8), 13, 2, F, dxgi=71), True),
        "BC6H 3x9": (w.dds_bytes(random_blocks(3, 24), 3, 9, F, dxgi=95), True),
        "DXT5 mipmapped": (w.dds_bytes(random_blocks(n + 20, 25), W, H, F, b"DXT5", mipmaps=4), True),
        "BC7 array of 6": (w.dds_bytes(random_blocks(6 * n, 26), W, H, F, dxgi=98, array_size=6), True),
        "DXT1 cube map": (w.dds_bytes(random_blocks(6 * n, 27, 8), W, H, F, b"DXT1", caps=0x1008), True),
        "BC7 one block short": (bc7[:-16], False),
        "DXT1 one byte short": (dxt1[:-1], False),
        "BC7 with bytes after its blocks": (bc7 + b"after", True),
        # the header
        "the DX10 header cut inside its format": (bc7[:130], False),
        "the DX10 header cut after its format": (bc7[:132], False),
        "the header cut at byte 100": (dxt1[:100], False),
        "the signature and 2 bytes": (b"DDS \x7c\x00", False),
        "a header size of 0": (header_size(dxt1, 0), False),
        "a header size of 123": (header_size(dxt1, 123), False),
        "a header size of 125": (header_size(dxt1, 125), False),
        "a width of 0": (w.dds_bytes(random_blocks(n, 28, 8), 0, H, F, b"DXT1"), False),
        "a height of 0": (w.dds_bytes(random_blocks(n, 28, 8), W, 0, F, b"DXT1"), False),
        "past PIL's decompression bomb limit": (w.dds_bytes(b"", 20000, 20000, F, b"DXT1"), False),
        "no pixel format flags": (w.dds_bytes(b"", W, H, 0), False),
        "the alpha-only flag": (w.dds_bytes(b"", W, H, w.DDPF_ALPHAPIXELS | 0x2), False),
    }
    for fourcc in (b"DXT2", b"DXT4", b"BC4S", b"RGBG", b"\0\0\0\0"):
        cases[f"FourCC {fourcc!r}"] = (w.dds_bytes(random_blocks(n, 29), W, H, F, fourcc), False)
    for fmt in (27, 28, 29, 70, 71, 73, 74, 76, 77, 79, 80, 82, 83, 84, 95, 96, 97, 98, 99):
        size = 4 * W * H if fmt < 30 else blocks_of() * (8 if fmt in (70, 71, 79, 80) else 16)
        cases[f"DXGI format {fmt}"] = (w.dds_bytes(random_blocks(size, 30 + fmt, 1), W, H, F, dxgi=fmt), True)
    for fmt in (0, 2, 72, 75, 78, 81, 94, 100):
        cases[f"DXGI format {fmt}"] = (w.dds_bytes(random_blocks(n, 31), W, H, F, dxgi=fmt), False)
    return cases


CASES = dds_cases()


@pytest.mark.parametrize("name", list(CASES))
def test_dds_reads_as_pil_reads_it(tmp_path, cxx, name):
    data, reads = CASES[name]
    got = assert_follows_pil(tmp_path, data, name)
    assert (got is not None) == reads, f"{name}: the port {'reads' if got is not None else 'raises'}"


def test_refusals_name_the_file_and_the_field(tmp_path, cxx):
    """PIL's raises end `open_image` with a ValueError naming the file and
    the header field; a file PIL passes on names every format tried."""
    for name, match in (("a header size of 123", "header size of 123"), ("FourCC b'DXT2'", "DXT2"),
                        ("DXGI format 72", "DXGI format 72"), ("no pixel format flags", "pixel format flags 0"),
                        ("luminance of 32 bits", "luminance bit count of 32"), ("BC7 one block short", "truncated"),
                        ("the signature and 2 bytes", "not a PNG"), ("a width of 0", "0x21")):
        path = tmp_path / "refused.dds"
        path.write_bytes(CASES[name][0])
        with pytest.raises(ValueError, match=match) as err:
            image_io.open_image(path)
        assert str(path) in str(err.value), name


# ---- the block formats on 4,096 random blocks each ----

BLOCK_FORMATS = {  # name: (FourCC or DXGI format, block bytes)
    "DXT1": (b"DXT1", 8), "DXT3": (b"DXT3", 16), "DXT5": (b"DXT5", 16), "BC4U": (b"BC4U", 8),
    "ATI2": (b"ATI2", 16), "BC5S": (b"BC5S", 16), "BC1 (DX10)": (71, 8), "BC4 (DX10)": (80, 8),
    "BC5 SNORM (DX10)": (84, 16), "BC6H UF16": (95, 16), "BC6H SF16": (96, 16), "BC7": (98, 16),
}


def bc6h_mode(block: bytes) -> int:
    """Microsoft's BC6H mode (1 to 14) of a block, 0 for a reserved one."""
    low = block[0] & 3
    if low < 2:
        return low + 1
    m = (2 if low == 2 else 10) + ((block[0] & 0x1F) >> 2)
    return m + 1 if m < 14 else 0


def bc7_mode(block: bytes) -> int:
    """A BC7 block's mode (0 to 7), 8 where its first byte is 0."""
    return (block[0] & -block[0]).bit_length() - 1 if block[0] else 8


@pytest.mark.parametrize("name", list(BLOCK_FORMATS))
def test_random_blocks_read_bit_equal_to_pil(tmp_path, cxx, name):
    """4,096 seeded random blocks (256x256 pixels) of each block format,
    bit-equal to PIL; the BC6H and BC7 images hold every mode, reserved
    ones included."""
    fmt, size = BLOCK_FORMATS[name]
    body = random_blocks(4096, 4000 + size + len(name), size)
    header = {"dxgi": fmt} if isinstance(fmt, int) else {"fourcc": fmt}
    data = w.dds_bytes(body, 256, 256, F, **header)
    assert assert_follows_pil(tmp_path, data, name) is not None
    blocks = [body[i:i + size] for i in range(0, len(body), size)]
    if name.startswith("BC6H"):
        counts = np.bincount([bc6h_mode(b) for b in blocks], minlength=15)
        assert counts.min() >= 1 and counts.sum() == 4096, counts
    if name == "BC7":
        counts = np.bincount([bc7_mode(b) for b in blocks], minlength=9)
        assert counts.min() >= 1 and counts.sum() == 4096, counts


ENCODERS = {  # name: (the writer's blocks and decoded pixels, header)
    "BC1": (lambda a, rgba, half: w.bc1_blocks(a, decoded=True), {"fourcc": b"DXT1"}),
    "BC2": (lambda a, rgba, half: w.bc2_blocks(rgba, decoded=True), {"fourcc": b"DXT3"}),
    "BC3": (lambda a, rgba, half: w.bc3_blocks(rgba, decoded=True), {"fourcc": b"DXT5"}),
    "BC4": (lambda a, rgba, half: w.bc4_blocks(a[..., 1], decoded=True), {"fourcc": b"BC4U"}),
    "BC5": (lambda a, rgba, half: w.bc5_blocks(a, decoded=True), {"fourcc": b"ATI2"}),
    "BC5S": (lambda a, rgba, half: w.bc5_blocks(a, signed=True, decoded=True), {"fourcc": b"BC5S"}),
    "BC6H UF16": (lambda a, rgba, half: w.bc6h_blocks(half, decoded=True), {"dxgi": 95}),
    "BC6H SF16": (lambda a, rgba, half: w.bc6h_blocks(half, signed=True, decoded=True), {"dxgi": 96}),
    "BC7": (lambda a, rgba, half: w.bc7_blocks(rgba, decoded=True), {"dxgi": 98}),
}


@pytest.mark.parametrize("name", list(ENCODERS))
def test_writer_blocks_decode_as_pil_decodes_them(tmp_path, cxx, name):
    """Each encoder of tests/torch_image_writers.py knows what its blocks
    decode to: PIL's pixels, bit for bit (phase 5i holds its block-coded
    training views to that), and the port reads the same."""
    a, rgba = picture(40, 61, 45), rgba_picture(41, 61, 45)
    rgba[..., 3] = np.where(np.arange(61) < 30, 255, rgba[..., 3])  # a constant alpha, kept exactly by BC7
    half = (a.astype(np.float32) / 255).astype(np.float16).view(np.uint16)
    encode, header = ENCODERS[name]
    blocks, decoded = encode(a, rgba, half)
    data = w.dds_bytes(blocks.tobytes(), 61, 45, F, **header)
    got = assert_follows_pil(tmp_path, data, name)
    np.testing.assert_array_equal(got.pixels, decoded, err_msg=name)
    if name == "BC7":
        assert (decoded[:, :28, 3] == 255).all()  # the blocks whose alpha is all 255


# ---- seeded damage: PIL's pixels and RGBA, or a raise where PIL raises ----

def mutants(n, seed):
    """Small DDS files of every kind, a few bytes of their pixel format or
    DX10 headers or data replaced or flipped (the size fields kept, so
    that no mutant asks PIL's Python decoder for millions of pixels), or
    the file cut short."""
    rng = np.random.default_rng(seed)
    a, rgba = picture(50, 13, 9), rgba_picture(51, 13, 9)
    bases = [masked(rgba, 32, ARGB, RGB | A), masked(a, 16, (0xF800, 0x7E0, 0x1F)),
             w.dds_bytes(a[..., 0].tobytes(), 13, 9, LUM, bitcount=8),
             w.dds_bytes(bytes(range(256)) * 4 + a[..., 0].tobytes(), 13, 9, PAL, bitcount=8),
             w.dds_bytes(w.bc1_blocks(a).tobytes(), 13, 9, F, b"DXT1"),
             w.dds_bytes(w.bc3_blocks(rgba).tobytes(), 13, 9, F, b"DXT5"),
             w.dds_bytes(w.bc7_blocks(rgba).tobytes(), 13, 9, F, dxgi=98),
             w.dds_bytes(random_blocks(12, 52), 13, 9, F, dxgi=96)]
    out = []
    for _ in range(n):
        d = bytearray(bases[int(rng.integers(len(bases)))])
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.choice([int(rng.integers(4, 8)), int(rng.integers(76, len(d)))]))
            d[i] = int(rng.integers(0, 256)) if rng.random() < 0.6 else d[i] ^ (1 << int(rng.integers(0, 8)))
        if rng.random() < 0.2:
            d = d[:int(rng.integers(0, len(d)))]
        out.append(bytes(d))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_mutated_files_read_as_pil_reads_them(tmp_path, cxx, seed):
    for i, data in enumerate(mutants(40, 700 + seed)):
        path = tmp_path / "pil.dds"
        path.write_bytes(data)
        try:
            with Image.open(path) as im:
                np.asarray(im)
        except Exception:  # noqa: BLE001  (any of PIL's errors: the port must raise too)
            with pytest.raises(ValueError) as err:
                image_io.open_image(path)
            assert str(path) in str(err.value), f"mutant {i}"
            continue
        assert_follows_pil(tmp_path, data, f"seed {seed} mutant {i}")


# ---- order, fall-through and no fallback ----

def test_dds_follows_dcx_in_pils_order():
    Image.init()
    names = [name for name, _, _ in image_io.READERS]
    assert names.index("DDS") == names.index("DCX") + 1
    assert Image.ID.index("DDS") == Image.ID.index("DCX") + 1
    accepts = dict((name, test) for name, test, _ in image_io.READERS)["DDS"]
    assert accepts(b"DDS |") and not accepts(b"DDS|")


def test_failed_block_decoder_build_raises_naming_the_source(tmp_path, fake_cxx):
    """The block formats cannot be read without csrc/bcn_decode.cc: the read
    raises, naming it and the file; the uncompressed forms need no build."""
    fake_cxx(fail=True)
    path = tmp_path / "v.dds"
    path.write_bytes(CASES["DXT1 of this writer"][0])
    with pytest.raises(RuntimeError, match="csrc/bcn_decode.cc") as err:
        image_io.open_image(path)
    assert str(path) in str(err.value)
    assert not cuda_build.host_library_path("bcn_decode").exists()
    path.write_bytes(CASES["A8R8G8B8"][0])
    assert image_io.open_image(path).pixels.shape == (H, W, 4)


# ---- the committed fixtures ----

READINGS = json.load(open(os.path.join(FIXTURES, "sha256.json")))


@pytest.mark.parametrize("name", sorted(READINGS["files"]))
def test_committed_fixture_reads_as_pil_and_the_json_say(tmp_path, cxx, name):
    want = READINGS["files"][name]
    path = os.path.join(FIXTURES, name)
    im = Image.open(path)
    px = np.asarray(im)
    px = px[..., None] if px.ndim == 2 else px
    assert (im.mode, list(px.shape), sha256_of(px), sha256_of(np.asarray(im.convert("RGBA")))) == \
        (want["mode"], want["shape"], want["sha256"], want["rgba_sha256"])
    got = image_io.open_image(path)
    assert (got.mode, list(got.pixels.shape), sha256_of(got.pixels), sha256_of(image_io.to_rgba(got))) == \
        (want["mode"], want["shape"], want["sha256"], want["rgba_sha256"])


@pytest.mark.parametrize("name", sorted(READINGS["chip_smoke"]))
def test_chip_smoke_dds_files_read_as_the_json_says(tmp_path, cxx, name):
    """Phase 5i's 1080p files, written again here by chip_smoke.py's
    `dds_form_files` (tests/torch_image_writers.py), are the bytes whose
    PIL reading sha256.json holds, and the port reads each as PIL did."""
    want = READINGS["chip_smoke"][name]
    assert len(READINGS["chip_smoke"]) == 18
    data = dds_form_files(names=[name])[name]
    assert hashlib.sha256(data).hexdigest() == want["file_sha256"], name
    assert want["shape"][:2] == [1080, 1920], name
    path = tmp_path / "form.dds"
    path.write_bytes(data)
    pic = image_io.open_image(path)
    assert (pic.mode, list(pic.pixels.shape), sha256_of(pic.pixels)) == \
        (want["mode"], want["shape"], want["sha256"]), name


# ---- both dataset paths against the JAX package ----

def colmap_views(w_, h):
    """Views whose np.asarray is the picture: DDS forms of modes L, RGB and
    RGBA."""
    a, rgba = picture(110, w_, h), rgba_picture(111, w_, h)
    half = (a.astype(np.float32) / 255).astype(np.float16).view(np.uint16)
    n = blocks_of(w_, h)
    return {
        "v_argb.dds": masked(rgba, 32, ARGB, RGB | A),
        "v_xrgb.dds": masked(a, 32, ARGB[:3]),
        "v_565.dds": masked(a, 16, (0xF800, 0x7E0, 0x1F)),
        "v_l8.dds": w.dds_bytes(a[..., 0].tobytes(), w_, h, LUM, bitcount=8),
        "v_dxt1.dds": w.dds_bytes(w.bc1_blocks(a).tobytes(), w_, h, F, b"DXT1"),
        "v_dxt3.dds": w.dds_bytes(w.bc2_blocks(rgba).tobytes(), w_, h, F, b"DXT3"),
        "v_dxt5.dds": w.dds_bytes(w.bc3_blocks(rgba).tobytes(), w_, h, F, b"DXT5"),
        "v_bc4.dds": w.dds_bytes(w.bc4_blocks(a[..., 2]).tobytes(), w_, h, F, b"BC4U"),
        "v_bc5.dds": w.dds_bytes(w.bc5_blocks(a).tobytes(), w_, h, F, b"ATI2"),
        "v_bc5s.dds": w.dds_bytes(random_blocks(n, 112), w_, h, F, b"BC5S"),
        "v_bc1.dds": w.dds_bytes(w.bc1_blocks(a).tobytes(), w_, h, F, dxgi=71),
        "v_bc6h.dds": w.dds_bytes(w.bc6h_blocks(half).tobytes(), w_, h, F, dxgi=95),
        "v_bc6hs.dds": w.dds_bytes(random_blocks(n, 113), w_, h, F, dxgi=96),
        "v_bc7.dds": w.dds_bytes(w.bc7_blocks(rgba).tobytes(), w_, h, F, dxgi=98),
        "v_rgba8.dds": w.dds_bytes(rgba.tobytes(), w_, h, F, dxgi=28),
    }


@pytest.mark.parametrize("resolution", [1, 2])
def test_colmap_dds_views_match_jax(tmp_path, monkeypatch, cxx, resolution):
    """A COLMAP dataset of DDS views in every form and picture mode: the
    Scene's cameras equal the JAX package's, images bit for bit."""
    from test_torch_scene import both_scenes

    w_, h = 45, 37
    src = str(tmp_path / "dds")
    views = colmap_views(w_, h)
    write_colmap_dataset_of(src, views, w_, h)
    jscene, scene = both_scenes(tmp_path, monkeypatch, src, eval_split=True, resolution=resolution)
    assert len(scene.get_train_cameras()) + len(scene.get_test_cameras()) == len(views)
    assert_same_cameras(scene.get_train_cameras(), jscene.get_train_cameras())
    assert_same_cameras(scene.get_test_cameras(), jscene.get_test_cameras())


def refused_views():
    a, rgba = picture(120, 13, 11), rgba_picture(121, 13, 11)
    pal = np.arange(1024, dtype=np.uint32).astype(np.uint8)
    return {
        "palette DDS": (w.dds_bytes(pal.tobytes() + a[..., 0].tobytes(), 13, 11, PAL, bitcount=8), "P"),
        "grey + alpha DDS": (w.dds_bytes(np.stack([a[..., 0], rgba[..., 3]], -1).tobytes(), 13, 11, LUM | A,
                                         bitcount=16), "LA"),
        "PIL's LA DDS": (pil_save(rgba, "LA"), "LA"),
    }


@pytest.mark.parametrize("form", list(refused_views()))
def test_colmap_refuses_dds_modes_that_are_not_the_picture(tmp_path, cxx, form):
    """The JAX package's COLMAP path trains on np.asarray of these (indices;
    grey and alpha): the port refuses each through load_camera, naming the
    file as images.bin lists it and the mode."""
    data, mode = refused_views()[form]
    name = "view.dds"
    src = str(tmp_path / "data")
    write_colmap_dataset_of(src, {name: data}, 13, 11)
    assert Image.open(os.path.join(src, "images", name)).mode == mode
    info = dataset_readers.read_colmap_scene(src, None, eval_split=False)
    with pytest.raises(ValueError, match=rf"'{name}' in .*images\.bin: .*{name}: .*\(mode {mode}\)"):
        dataset_readers.load_camera(info.train_cameras[0], 1)


def blender_frames(w_, h):
    """Frames (named .png, as the transforms file names them) in DDS forms
    of every mode: PIL's convert("RGBA") is what the Blender path reads."""
    a, rgba = picture(130, w_, h), rgba_picture(131, w_, h)
    pal = np.concatenate([np.random.default_rng(132).integers(0, 256, (256, 3)),
                          np.random.default_rng(133).integers(0, 256, (256, 1))], -1).astype(np.uint8)
    n = blocks_of(w_, h)
    return [
        masked(rgba, 32, ARGB, RGB | A),
        masked(a, 24, ARGB[:3]),
        w.dds_bytes(a[..., 1].tobytes(), w_, h, LUM, bitcount=8),
        w.dds_bytes(np.stack([a[..., 0], rgba[..., 3]], -1).tobytes(), w_, h, LUM | A, bitcount=16),
        w.dds_bytes(pal.tobytes() + a[..., 2].tobytes(), w_, h, PAL, bitcount=8),
        w.dds_bytes(random_blocks(n, 134, 8), w_, h, F, b"DXT1"),  # transparent black where c0 <= c1
        w.dds_bytes(w.bc3_blocks(rgba).tobytes(), w_, h, F, b"DXT5"),
        w.dds_bytes(w.bc4_blocks(a[..., 0]).tobytes(), w_, h, F, b"BC4U"),
        w.dds_bytes(w.bc5_blocks(a, signed=True).tobytes(), w_, h, F, b"BC5S"),
        w.dds_bytes(random_blocks(n, 135), w_, h, F, dxgi=95),
        w.dds_bytes(w.bc7_blocks(rgba).tobytes(), w_, h, F, dxgi=99),
        w.dds_bytes(rgba.tobytes(), w_, h, F, dxgi=29),
    ]


@pytest.mark.parametrize("white_background", [False, True])
def test_blender_dds_frames_match_jax(tmp_path, monkeypatch, cxx, white_background):
    """read_blender_scene on DDS frames of every mode: PIL's
    convert("RGBA") through the composite, bit for bit, then load_camera at
    -r 2."""
    w_, h = 45, 37
    frames = blender_frames(w_, h)
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
