"""Generate the BMP, TIFF, 4-component JPEG, WebP and GIF fixtures of
tests/test_torch_image_forms.py and chip_smoke.py.

Each `<name>.<ext>` is a small image in a form PIL reads beyond PNG and 1-
or 3-component JPEG, written by PIL where PIL writes the form, else by
tests/torch_image_writers.py (BMP, TIFF, a GIF frame on a larger screen)
or test_torch_jpeg.py's copy of chip_smoke.py's baseline encoder (YCCK
and marker-less CMYK JPEG);
`<name>.npz` beside it holds PIL's reading of the file: `mode`, `pixels`
(`np.asarray(Image.open(f))`, a channel axis kept) and `rgba`
(`convert("RGBA")`). The machine with the card has no PIL, so the port's
readers are held to these there.

Run from the repo root:  python tests/fixtures/torch_images/make_fixtures.py
(a few seconds). The files are checked in; regenerate only if the cases
change.
"""

import io
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, TESTS)
sys.path.insert(0, os.path.dirname(TESTS))

from test_torch_jpeg import encode_jpeg  # noqa: E402
from torch_image_writers import bmp_bytes, gif_bytes, padded_rows, rle_encode, tiff_bytes  # noqa: E402


def content(h, w, c, seed):
    """Waves, uint8 (h, w, c): edges for the JPEGs, few enough distinct
    rows that the pixels committed beside each file stay small."""
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 120 * np.sin(xx / (2 + i + seed) + yy / (3 + i)) for i in range(c)], -1)
    return np.clip(a, 0, 255).astype(np.uint8)


def pil_saved(im, fmt, **options) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **options)
    return buf.getvalue()


def cases():
    """{file name: bytes}."""
    a = content(45, 67, 4, 1)
    b = content(45, 67, 4, 2)
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:45, 0:67]
    low = ((7 * xx + 13 * yy)[..., None] + np.arange(3) * 50) & 255
    wide = (b[..., :3].astype(np.int64) << 8) | low  # 16-bit samples whose low bytes PIL drops
    idx = a[..., 1].astype(np.int64) // 4 * 4  # palette indices: runs, as RLE meets them
    idx[:, ::5] = 9
    idx[::2, 40:] = 0
    palette = rng.integers(0, 256, (256, 3))
    pairs = np.pad(idx % 16, ((0, 0), (0, 1)))
    nibbles = (pairs[:, 0::2] << 4 | pairs[:, 1::2]).astype(np.uint8)  # 4-bit indices, two a byte
    cmyk_prog = pil_saved(Image.fromarray(b, "CMYK"), "JPEG", quality=90, progressive=True)
    framed = np.zeros_like(a)  # an opaque box on transparent black: PIL's animation crops frame 0 to it
    framed[6:38, 9:60] = a[6:38, 9:60] // 16 * 16
    framed[6:38, 9:60, 3] = 255
    quantised = Image.fromarray(a[..., :3]).quantize(64)
    at = cmyk_prog.index(b"Adobe") + 11
    return {
        "cmyk_q90_67x45.jpg": pil_saved(Image.fromarray(a, "CMYK"), "JPEG", quality=90),
        "cmyk_progressive_q90_67x45.jpg": cmyk_prog,
        "ycck_progressive_q90_67x45.jpg": cmyk_prog[:at] + b"\x02" + cmyk_prog[at + 1:],
        "ycck_420_k_full_restarts_67x45.jpg": encode_jpeg(a, 90, (2, 2), 3, adobe=2),
        "ycck_420_k_subsampled_67x45.jpg": encode_jpeg(a, 85, (2, 2), 0, adobe=2, k_sampled=True),
        "cmyk_no_marker_444_67x45.jpg": encode_jpeg(a, 95, (1, 1), 0),
        "rgb16_lzw_predictor_ii_67x45.tif": tiff_bytes(wide[:45, :67], 16, 2, compression=5, predictor=2,
                                                       rows_per_strip=8),
        "rgb16_lzw_predictor_mm_67x45.tif": tiff_bytes(wide[:45, :67], 16, 2, order=">", compression=5, predictor=2),
        "rgba_tiled_deflate_67x45.tif": tiff_bytes(b, 8, 2, compression=8, predictor=2, tile=(32, 16), extra=[2]),
        "rgba16_associated_67x45.tif": tiff_bytes(a.astype(np.int64) * 257, 16, 2, extra=[1], order=">"),
        "cmyk_packbits_67x45.tif": tiff_bytes(a, 8, 5, compression=32773, rows_per_strip=16),
        "white_is_zero_1bit_67x45.tif": tiff_bytes(a[..., :1] > 128, 1, 0, compression=5),
        "palette_lzw_67x45.tif": tiff_bytes(idx[..., None], 8, 3, compression=5,
                                            colormap=list(palette.T.reshape(-1) * 257)),
        "grey16_mm_67x45.tif": tiff_bytes(wide[:45, :67, :1], 16, 1, order=">", compression=32946),
        "rgb_orientation_6_67x45.tif": tiff_bytes(a[..., :3], 8, 2, orientation=6),
        "bgr24_67x45.bmp": pil_saved(Image.fromarray(a[..., :3]), "BMP"),
        "bgra32_bitfields_v5_67x45.bmp": bmp_bytes(
            padded_rows(np.concatenate([a[..., 2::-1], a[..., 3:]], -1).reshape(45, -1)), 67, 45, 32, 124,
            compression=3, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        "rle8_67x45.bmp": bmp_bytes(rle_encode(idx, False), 67, 45, 8, compression=1, palette=palette, colors=256),
        "rle4_67x45.bmp": bmp_bytes(rle_encode(idx % 16, True), 67, 45, 4, compression=2,
                                    palette=palette[:16], colors=16),
        "rgb565_67x45.bmp": bmp_bytes(padded_rows((wide[..., 0] ^ low[..., 1]).astype("<u2").view(np.uint8)),
                                      67, 45, 16, 56, compression=3, masks=(0xF800, 0x7E0, 0x1F)),
        "os2_4bit_67x45.bmp": bmp_bytes(padded_rows(nibbles), 67, 45, 4, 12, palette=palette[:16]),
        "top_down_8bit_67x45.bmp": bmp_bytes(padded_rows(idx[::-1].astype(np.uint8)), 67, 45, 8, palette=palette,
                                             colors=256, top_down=True),
        "lossy_q75_33x23.webp": pil_saved(Image.fromarray(a[:23, :33, :3]), "WEBP", quality=75),
        "lossy_alpha_33x23.webp": pil_saved(Image.fromarray(b[:23, :33]), "WEBP", quality=80, alpha_quality=60),
        "lossless_16_colours_67x45.webp": pil_saved(Image.fromarray(palette[idx % 16].astype(np.uint8)), "WEBP",
                                                    lossless=True),
        "animated_cropped_67x45.webp": pil_saved(Image.fromarray(framed), "WEBP", save_all=True,
                                                 append_images=[Image.new("RGBA", (67, 45), (9, 9, 9, 255))],
                                                 lossless=True),
        "palette_interlaced_67x45.gif": pil_saved(quantised, "GIF", transparency=5, interlace=True),
        "grey_67x45.gif": gif_bytes(a[..., 0]),
        "local_palette_offset_67x45.gif": gif_bytes(idx[3:40, 5:60].astype(np.uint8), local_palette=palette,
                                                    screen=(67, 45), offset=(5, 3), transparency=9),
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
