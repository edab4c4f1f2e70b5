"""Generate the fixtures of tests/test_torch_avif.py and of chip_smoke.py's
phases 5j, 5k, 5l and 5m: AVIF files written by PIL 12.1.0 (libavif 1.3.0, aom
3.12.1) from seeded numpy pictures, and PIL's reading of each.

- Small files: RGBA with premultiplied alpha (65x33), limited-range 4:2:2
  (130x67), 4:0:0 (7x5), 2x2 tiles (256x256) and an EXIF orientation of 6
  (1x1); and three that use AV1's CDEF and loop restoration: 4:2:2 with
  CDEF (130x67), 4:0:0 with self-guided restoration (160x96), RGBA with
  128x128 superblocks (130x67).
- Seven 1920x1080 files, the views of phase 5j: 4:2:0 at quality 75 and
  PIL's default speed, 4:4:4 at quality 90, 4:0:0, RGBA, limited range,
  2x2 tiles, and 4:2:0 at quality 50 and speed 10.
- Three 1920x1080 files of phase 5k, with CDEF and loop restoration: 4:2:0
  at quality 50 and speed 2 with CDEF on, 4:4:4 at quality 60 and speed 4
  with CDEF on, 4:2:0 at quality 50 and speed 0.
- Three 1920x1080 screen-content files of phase 5l (`screen_picture`,
  desktop-like), with AV1's palette mode and IntraBC: 4:2:0 at quality 60
  with `tune-content=screen` (both tools), the same with palette off
  (IntraBC alone), 4:4:4 at quality 75 with `tune-content=screen`.
- Film grain and image sequences (phase 5m): three 1920x1080 files, aom's
  grain test vector 10 at 4:2:0, grain estimated from a textured picture
  (`denoise-noise-level` 20) at 4:4:4, and an RGBA 3-frame `avis`
  sequence of shifted pictures with grain on colour and alpha (test
  vector 4); and three small ones: test vector 7 at 4:2:2 limited range
  (65x33), `denoise-noise-level` 30 at 4:0:0 (160x96), and an RGBA
  premultiplied 3-frame sequence with grain (test vector 2, 130x67).
- `sha256.json`: for each file, PIL's mode, the shape of
  `np.asarray(Image.open(f))`, the SHA-256 of those pixels' bytes and of
  the file itself. It holds the port to PIL where the machine's PIL has
  no AVIF.

Run from the repo root:  python tests/fixtures/torch_avif/make_fixtures.py
(about 80 s). The files are checked in; regenerate only if the cases change.
"""

import hashlib
import io
import json
import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
CDEF_ON = {"enable-cdef": "1"}  # aom 3.12.1 leaves CDEF off for still pictures unless asked
SCREEN = {"tune-content": "screen"}


def picture(h, w, channels, seed):
    """A render-like picture: smooth shading, oriented edges, a flat patch
    and a little noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    s = max(h, w) / 256.0
    out = []
    for c in range(channels):
        v = 120 + 60 * np.sin(xx / (23 * s + 4 * c) + yy / (31 * s + 3 * c))
        v += 40 * (((np.cos(0.4 + c) * xx + np.sin(0.4 + c) * yy) / (17 * s + 1)) % 2 < 1)
        out.append(v)
    a = np.stack(out, -1) + rng.normal(0, 2.5, (h, w, channels))
    a[h // 3:h // 2, w // 5:w // 3] = 90 + 30 * np.arange(channels)
    return np.clip(a, 0, 255).astype(np.uint8)


def screen_picture(h, w, seed):
    """A desktop-like screen: a flat ground and six windows with title
    bars, one holding a render-like picture, the others lines of glyphs
    (the same 24 shapes, which IntraBC copies) and flat buttons (palette)."""
    rng = np.random.default_rng(seed)
    a = np.empty((h, w, 3), np.uint8)
    a[:] = rng.integers(0, 256, 3)
    s = max(1, h // 270)
    shapes = rng.integers(0, 2, (24, 7, 5)).astype(bool)
    for k in range(6):
        wh, ww = int(rng.integers(h // 5, h // 2)), int(rng.integers(w // 6, w // 2.5))
        y0, x0 = int(rng.integers(0, h - wh)), int(rng.integers(0, w - ww))
        ground, ink, bar = (rng.integers(0, 256, 3) for _ in range(3))
        a[y0:y0 + wh, x0:x0 + ww] = ground
        a[y0:y0 + 12 * s, x0:x0 + ww] = bar
        if k == 0:
            a[y0 + 12 * s:y0 + wh, x0:x0 + ww] = picture(wh - 12 * s, ww, 3, seed)
            continue
        for y in range(y0 + 16 * s, y0 + wh - 9 * s, 10 * s):
            for i in range(int(rng.integers(ww // (6 * s) // 3, ww // (6 * s))) - 1):
                x = x0 + 4 * s + 6 * s * i
                a[y:y + 7 * s, x:x + 5 * s][shapes[rng.integers(0, 24)].repeat(s, 0).repeat(s, 1)] = ink
        for b in range(3):
            by, bx = y0 + wh - 10 * s, x0 + ww - (b + 1) * 30 * s
            if bx > x0:
                a[by:by + 7 * s, bx:bx + 24 * s] = rng.integers(0, 256, 3)
    return a


def textured(h, w, seed):
    """The render-like picture under a film-like grain (what aom's denoiser
    estimates `denoise-noise-level`'s grain from)."""
    rng = np.random.default_rng(seed + 1000)
    return np.clip(picture(h, w, 3, seed) + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)


def shifted(px, n=3):
    """n frames of a picture, each moved 8 pixels right of the last."""
    return [np.ascontiguousarray(np.roll(px, 8 * i, axis=1)) for i in range(n)]


def alpha_picture(h, w, seed):
    a = picture(h, w, 4, seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a[..., 3] = np.clip(255 * np.abs(np.sin(xx / (w / 3 + 1) + yy / (h / 2 + 1))), 0, 255).astype(np.uint8)
    return a


def cases():
    """file name: (picture, PIL's save options)."""
    exif = Image.Exif()
    exif[0x0112] = 6
    return {
        "rgba_premultiplied_65x33.avif": (alpha_picture(33, 65, 1), dict(quality=60, alpha_premultiplied=True)),
        "limited_422_130x67.avif": (picture(67, 130, 3, 2), dict(quality=50, subsampling="4:2:2", range="limited")),
        "mono_7x5.avif": (picture(5, 7, 3, 3), dict(quality=75, subsampling="4:0:0")),
        "tiles_2x2_256x256.avif": (picture(256, 256, 3, 4), dict(quality=70, tile_rows=1, tile_cols=1)),
        "exif6_1x1.avif": (picture(1, 1, 3, 5), dict(quality=90, exif=exif)),
        "1080p_420_q75.avif": (picture(1080, 1920, 3, 10), dict(quality=75)),
        "1080p_444_q90.avif": (picture(1080, 1920, 3, 11), dict(quality=90, subsampling="4:4:4")),
        "1080p_400_q75.avif": (picture(1080, 1920, 3, 12), dict(quality=75, subsampling="4:0:0")),
        "1080p_rgba_q75.avif": (alpha_picture(1080, 1920, 13), dict(quality=75)),
        "1080p_limited_q75.avif": (picture(1080, 1920, 3, 14), dict(quality=75, range="limited")),
        "1080p_tiles_2x2_q75.avif": (picture(1080, 1920, 3, 15), dict(quality=75, tile_rows=1, tile_cols=1)),
        "1080p_420_q50_s10.avif": (picture(1080, 1920, 3, 16), dict(quality=50, speed=10)),
        "cdef_422_130x67.avif": (picture(67, 130, 3, 6), dict(quality=60, speed=4, subsampling="4:2:2",
                                                               advanced=CDEF_ON)),
        "sgrproj_400_160x96.avif": (picture(96, 160, 3, 7), dict(quality=50, speed=4, subsampling="4:0:0")),
        "rgba_sb128_130x67.avif": (alpha_picture(67, 130, 8), dict(quality=50, speed=2,
                                                                  advanced={**CDEF_ON, "sb-size": "128"})),
        "1080p_420_q50_s2_cdef.avif": (picture(1080, 1920, 3, 17), dict(quality=50, speed=2, advanced=CDEF_ON)),
        "1080p_444_q60_s4_cdef.avif": (picture(1080, 1920, 3, 18), dict(quality=60, speed=4, subsampling="4:4:4",
                                                                        advanced=CDEF_ON)),
        "1080p_420_q50_s0.avif": (picture(1080, 1920, 3, 19), dict(quality=50, speed=0)),
        "1080p_screen_420_q60.avif": (screen_picture(1080, 1920, 20), dict(quality=60, advanced=SCREEN)),
        "1080p_intrabc_420_q60.avif": (screen_picture(1080, 1920, 21), dict(quality=60, advanced={
            **SCREEN, "enable-palette": "0"})),
        "1080p_screen_444_q75.avif": (screen_picture(1080, 1920, 22), dict(quality=75, subsampling="4:4:4",
                                                                           advanced=SCREEN)),
        "1080p_grain_420_test10.avif": (picture(1080, 1920, 3, 23), dict(quality=60, advanced={
            "film-grain-test": "10"})),
        "1080p_denoise_444.avif": (textured(1080, 1920, 24), dict(quality=60, subsampling="4:4:4", advanced={
            "denoise-noise-level": "20"})),
        "1080p_grain_rgba_avis.avif": (shifted(alpha_picture(1080, 1920, 25)), dict(quality=60, advanced={
            "film-grain-test": "4"})),
        "grain_422_limited_65x33.avif": (picture(33, 65, 3, 26), dict(quality=50, subsampling="4:2:2",
                                                                     range="limited", advanced={
                                                                         "film-grain-test": "7"})),
        "denoise_400_160x96.avif": (textured(96, 160, 27), dict(quality=55, subsampling="4:0:0", advanced={
            "denoise-noise-level": "30"})),
        "grain_rgba_avis_130x67.avif": (shifted(alpha_picture(67, 130, 28)), dict(
            quality=55, alpha_premultiplied=True, advanced={"film-grain-test": "2"})),
    }


def digest(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def main():
    readings = {}
    for name, (px, options) in cases().items():
        buf = io.BytesIO()
        if isinstance(px, list):  # an image sequence: frame 0 is what PIL reads
            Image.fromarray(px[0]).save(buf, "AVIF", save_all=True,
                                        append_images=[Image.fromarray(p) for p in px[1:]], **options)
        else:
            Image.fromarray(px).save(buf, "AVIF", **options)
        data = buf.getvalue()
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        im = Image.open(io.BytesIO(data))
        a = np.asarray(im)
        readings[name] = {"mode": im.mode, "shape": list(a.shape), "sha256": digest(a.tobytes()),
                          "file_sha256": digest(data)}
        print(f"{name}: {len(data)} bytes, {im.mode} {a.shape}")
    with open(os.path.join(HERE, "sha256.json"), "w") as f:
        json.dump({"pil": Image.__version__, "files": readings}, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
