"""Generate the JPEG 2000 fixtures of tests/test_torch_jp2.py and
chip_smoke.py: files PIL writes (OpenJPEG's encoder) from seeded numpy
pictures, and JP2 files whose boxes are edited around a PIL codestream
(`tests/torch_image_writers.jp2_bytes`).

- small files (64x48), one for each option of PIL's writer:
  reversible 5/3 and irreversible 9/7, with and without the colour
  transform (`mct`), grey, 16-bit grey, grey + alpha, RGBA, tiles with
  tile and image offsets, 1 and 3 resolutions, code-block and precinct
  sizes, the five progression orders, quality layers (rates and dB),
  `signed`, `plt`, a comment and raw codestreams (`no_jp2`); a codestream
  cut into two tile-parts a tile; and the box-edited JP2s: `pclr` +
  `cmap` (P and PA, an RGB and an RGBA palette), `colr` CMYK, sYCC and an
  ICC profile, `cdef` reordering the channels, `res `, the `jpx ` brand;
- three orthophoto-form files: a 1920x1080 RGB 9/7 JP2 in 512x512 tiles,
  RPCL, 3 layers, 128x128 precincts (`ortho_97_rpcl_1920x1080.jp2`), a
  1920x1080 RGB 5/3 lossless raw codestream (`ortho_53_1920x1080.j2k`),
  and an 800x800 RGBA 9/7 frame (`frame_rgba_97_800x800.jp2`);
- `sha256.json`: PIL's reading of each file: its mode, the shape of
  `np.asarray(Image.open(f))` (a channel axis kept) and the SHA-256 of
  those pixels' bytes, and the SHA-256 of its `convert("RGBA")`.

The port is held to these hashes here and on the card's machine, which
has no PIL.

Run from the repo root:  python tests/fixtures/torch_jp2/make_fixtures.py
(about 10 s). The files are checked in; regenerate only if the cases
change.
"""

import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from torch_image_writers import j2k_split_parts, jp2_bytes  # noqa: E402

W, H = 1920, 1080
BIG = ("ortho_97_rpcl_1920x1080.jp2", "ortho_53_1920x1080.j2k", "frame_rgba_97_800x800.jp2")


def picture(h, w, c=3, step=8):
    """Smooth waves in steps of `step` levels: an aerial picture's
    gradients that stay small in a file."""
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 100 * np.sin(xx / (97 + 31 * i) + yy / (143 + 17 * i))
                  + 20 * np.cos((xx + 2 * yy) / (211 + 13 * i)) for i in range(c)], -1)
    return (np.clip(a, 0, 255).astype(np.uint8) // step * step).astype(np.uint8)


def small(h, w, c, seed):
    """Waves with noise at a small size (every bit-plane coded)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 100 * np.sin(xx / (5 + 2 * i) + yy / (7 + i)) for i in range(c)], -1)
    return np.clip(a + rng.normal(0, 4, a.shape), 0, 255).astype(np.uint8)


def pil_j2k(pixels, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "JPEG2000", **options)
    return buf.getvalue()


def frame_rgba(n=800):
    """An 800x800 RGBA frame: the waves inside a soft-edged disc, clear
    outside it, as a NeRF-synthetic frame's object on no background."""
    yy, xx = np.mgrid[0:n, 0:n]
    alpha = np.clip((0.475 * n - np.hypot(xx - n / 2, yy - n / 2)) * 4, 0, 255).astype(np.uint8)
    return np.concatenate([picture(n, n), alpha[..., None]], -1)


def files() -> dict:
    rgb, grey = small(48, 64, 3, 1), small(48, 64, 1, 2)[..., 0]
    rgba, la = small(48, 64, 4, 3), small(48, 64, 2, 4)
    grey16 = (small(40, 56, 1, 5)[..., 0].astype(np.uint16) * 257 ^ np.uint16(0x35)).astype(np.uint16)
    prog = dict(precinct_size=(32, 32), codeblock_size=(8, 8), tile_size=(33, 25), tile_offset=(3, 2),
                offset=(5, 4), quality_layers=[30, 10, 3], irreversible=True, mct=1)
    out = {
        "grey_53.j2k": pil_j2k(grey, no_jp2=True),
        "grey16_53.j2k": pil_j2k(grey16, no_jp2=True),
        "grey_97.jp2": pil_j2k(grey, irreversible=True),
        "la_53.jp2": pil_j2k(la),
        "rgb_53.jp2": pil_j2k(rgb),
        "rgb_53_rct.jp2": pil_j2k(rgb, mct=1),
        "rgb_97.jp2": pil_j2k(rgb, irreversible=True),
        "rgb_97_ict.j2k": pil_j2k(rgb, irreversible=True, mct=1, no_jp2=True),
        "rgba_97_ict.jp2": pil_j2k(rgba, irreversible=True, mct=1),
        "rgb_53_tiles_offsets.jp2": pil_j2k(rgb, tile_size=(32, 24), tile_offset=(5, 3), offset=(7, 6)),
        "rgb_97_tiles_offsets.jp2": pil_j2k(rgb, tile_size=(33, 26), tile_offset=(1, 1), offset=(3, 5),
                                            irreversible=True),
        "rgb_res1.jp2": pil_j2k(rgb, num_resolutions=1),
        "rgb_res3_97.jp2": pil_j2k(rgb, num_resolutions=3, irreversible=True),
        "rgb_cblk_8x32.jp2": pil_j2k(rgb, codeblock_size=(8, 32)),
        "rgb_precincts_64.jp2": pil_j2k(rgb, precinct_size=(64, 64)),
        "rgb_layers_53.jp2": pil_j2k(rgb, quality_layers=[40, 10, 0]),
        "rgb_layers_db_97.jp2": pil_j2k(rgb, quality_mode="dB", quality_layers=[28, 36, 44], irreversible=True),
        "rgb_signed.jp2": pil_j2k(rgb, signed=True),
        "rgb_signed_97.j2k": pil_j2k(rgb, signed=True, irreversible=True, no_jp2=True),
        "rgb_plt.jp2": pil_j2k(rgb, plt=True),
        "rgb_comment.j2k": pil_j2k(rgb, comment="an orthophoto tile", no_jp2=True),
        "rgb_tile_parts.j2k": j2k_split_parts(pil_j2k(rgb, tile_size=(32, 24), no_jp2=True)),
    }
    for order in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        out[f"rgb_{order.lower()}.jp2"] = pil_j2k(rgb, progression=order, **prog)
    cs_grey, cs_la = pil_j2k(grey, no_jp2=True), pil_j2k(la, no_jp2=True)
    cs_rgb, cs_rgba = pil_j2k(rgb, no_jp2=True), pil_j2k(rgba, irreversible=True, mct=1, no_jp2=True)
    rng = np.random.default_rng(6)
    palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    palette[200:210] = palette[3]  # repeated entries: PIL's getcolor keeps the first
    out.update({
        "p_pclr.jp2": jp2_bytes(cs_grey, colr=(1, 16), pclr=palette),
        "p_pclr_rgba.jp2": jp2_bytes(cs_grey, colr=(1, 16), pclr=rng.integers(0, 256, (97, 4), dtype=np.uint8)),
        "pa_pclr.jp2": jp2_bytes(cs_la, colr=(1, 16), pclr=palette),
        "cmyk.jp2": jp2_bytes(cs_rgba, colr=(1, 12)),
        "sycc.jp2": jp2_bytes(cs_rgb, colr=(1, 18)),
        "sycc_rgba.jp2": jp2_bytes(cs_rgba, colr=(1, 18)),
        "icc_rgb.jp2": jp2_bytes(cs_rgb, colr=(2, bytes(range(64)))),
        "cdef_bgra.jp2": jp2_bytes(cs_rgba, cdef=[(0, 0, 3), (1, 0, 2), (2, 0, 1), (3, 1, 0)]),
        "res_dpi.jp2": jp2_bytes(cs_rgb, res=2835),
        "jpx_brand.jp2": jp2_bytes(cs_rgb, brand=b"jpx "),
    })
    ortho = picture(H, W)
    out[BIG[0]] = pil_j2k(ortho, irreversible=True, mct=1, tile_size=(512, 512), progression="RPCL",
                          quality_layers=[100, 50, 25], precinct_size=(128, 128))
    out[BIG[1]] = pil_j2k(picture(H, W, step=16), no_jp2=True)
    out[BIG[2]] = pil_j2k(frame_rgba(), irreversible=True, mct=1, quality_layers=[40, 20])
    return out


def reading(data: bytes) -> dict:
    im = Image.open(io.BytesIO(data))
    px = np.asarray(im)
    px = px[..., None] if px.ndim == 2 else px
    rgba = np.asarray(im.convert("RGBA"))
    return {"mode": im.mode, "shape": list(px.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest(),
            "rgba_sha256": hashlib.sha256(np.ascontiguousarray(rgba).tobytes()).hexdigest()}


def main():
    for name in os.listdir(HERE):
        if name.endswith((".jp2", ".j2k")):
            os.remove(os.path.join(HERE, name))
    readings = {}
    for name, data in sorted(files().items()):
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        readings[name] = reading(data)
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump(readings, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
