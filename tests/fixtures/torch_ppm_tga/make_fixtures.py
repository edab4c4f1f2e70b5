"""Generate the PPM / PGM / PBM / PFM and TGA fixtures of
tests/test_torch_ppm.py, tests/test_torch_tga.py and chip_smoke.py.

Each `<name>.<ext>` is a small image (33x23) in one of the forms, written
by PIL where PIL writes the form, else by tests/torch_image_writers.py
(`pnm_bytes`, `tga_bytes`, `tga_rle`); `<name>.npz` beside it holds PIL's
reading of the file: `mode`, `pixels` (`np.asarray(Image.open(f))`, a
channel axis kept) and `rgba` (`convert("RGBA")`). The machine with the
card has no PIL, so the port's readers are held to these there.

Run from the repo root:  python tests/fixtures/torch_ppm_tga/make_fixtures.py
(a second). The files are checked in; regenerate only if the cases change.
"""

import io
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from torch_image_writers import pnm_bytes, tga_bytes, tga_rle  # noqa: E402

W, H = 33, 23


def content(c, seed):
    """Waves, uint8 (H, W, c), with runs of equal pixels for RLE."""
    yy, xx = np.mgrid[0:H, 0:W]
    a = np.stack([128 + 120 * np.sin(xx / (2 + i + seed) + yy / (3 + i)) for i in range(c)], -1)
    a = np.clip(a, 0, 255).astype(np.uint8)
    a[:, 1::2] = a[:, 0:W - 1:2]
    a[12:, :9] = a[0, 0]
    return a


def pil_saved(im, fmt, **options) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **options)
    return buf.getvalue()


def cases():
    """{file name: bytes}."""
    a = content(4, 1)
    f = (a[..., 0].astype(np.float32) - 100.25) * 1.5
    f[0, :3] = [np.nan, np.inf, -np.inf]
    bgra = a[..., [2, 1, 0, 3]].reshape(H, -1)
    v16 = (a[..., 0].astype(np.int64) << 8 | a[..., 1]).astype("<u2")  # 16-bit TGA pixels, the top bit alpha
    idx = (a[..., 1] // 8).reshape(H, W)
    return {
        "p6_16bit_33x23.ppm": pnm_bytes(b"P6", a[..., :3].astype(np.int64) * 257 + 1, 65535),
        "p5_16bit_33x23.pgm": pil_saved(Image.fromarray(a[..., 0].astype(np.uint16) * 251), "PPM"),
        "p3_plain_maxval_1000_33x23.ppm": pnm_bytes(b"P3", a[..., :3].astype(np.int64) * 1000 // 255, 1000,
                                                    plain=True, header_comment=b"# a comment\n"),
        "p2_plain_maxval_100_33x23.pgm": pnm_bytes(b"P2", a[..., 1:2].astype(np.int64) * 100 // 255, 100,
                                                   plain=True),
        "p1_packed_33x23.pbm": pnm_bytes(b"P1", a[..., 0] > 128, plain=True, packed=True),
        "p4_33x23.pbm": pil_saved(Image.fromarray(a[..., 0] > 100), "PPM"),
        "pf_little_endian_33x23.pfm": pnm_bytes(b"Pf", f, scale=-1.0),
        "pf_big_endian_33x23.pfm": pnm_bytes(b"Pf", f, scale=2.0),
        "pyrgba_33x23.ppm": pnm_bytes(b"PyRGBA", a, 255),
        "rgba_rle_top_right_33x23.tga": tga_bytes(bgra, W, H, 10, 32, 0x38, rle=tga_rle(bgra, 4)),
        "rgb_raw_bottom_left_33x23.tga": pil_saved(Image.fromarray(a[..., :3]), "TGA"),
        "rgba_16bit_33x23.tga": tga_bytes(v16.view(np.uint8).reshape(H, -1), W, H, 2, 16, 0x20),
        "colour_mapped_16bit_start_33x23.tga": tga_bytes(
            idx.astype(np.uint8), W, H, 9, 8, 0x10, colormap=content(2, 2)[0, :30].tobytes(), map_depth=16,
            map_start=4, rle=tga_rle(idx.astype(np.uint8), 1)),
        "palette_rle_33x23.tga": pil_saved(Image.fromarray(a[..., :3]).quantize(12), "TGA", rle=True),
        "grey_alpha_33x23.tga": pil_saved(Image.fromarray(a[..., :2].copy(), "LA"), "TGA", rle=True),
    }


def main():
    for name, data in cases().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        im = Image.open(io.BytesIO(data))
        pixels = np.asarray(im)
        np.savez_compressed(os.path.join(HERE, os.path.splitext(name)[0] + ".npz"), mode=np.array(im.mode),
                            pixels=pixels[..., None] if pixels.ndim == 2 else pixels,
                            rgba=np.asarray(im.convert("RGBA")))
        print(f"{name}: {im.mode} {im.size}, {len(data)} bytes")


if __name__ == "__main__":
    main()
