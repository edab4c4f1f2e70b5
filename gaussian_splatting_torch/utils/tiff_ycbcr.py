"""libtiff's RGBA reader for YCbCr TIFF data, which PIL reads through it.

PIL hands a TIFF whose photometric interpretation is YCbCr (6) and whose
compression is not JPEG (7) to libtiff's `TIFFRGBAImageGet`, one strip or
one row of tiles a call, and keeps R, G and B of what it returns. Old-style
JPEG (compression 6) arrives the same way: libtiff's OJPEG codec hands the
reader the component samples as raw data units. This module is the port's
own copy of the reader's rules for 8-bit, 3-sample, pixel-interleaved data:

- `tif_color.c`: `TIFFYCbCrToRGBInit`'s tables in 16-bit fixed point from
  the YCbCrCoefficients (default 0.299, 0.587, 0.114) and
  ReferenceBlackWhite (default 0, 255, 128, 255, 128, 255) tags, each step
  in C's single precision and truncating casts, and `TIFFYCbCrtoRGB`'s
  clamps;
- `tif_getimage.c`: the data-unit layouts of subsampling 1x1, 1x2, 2x1,
  2x2, 4x1, 4x2 and 4x4 (the only ones it has a routine for): each unit
  its h x v luma samples row by row, then Cb and Cr, which every pixel of
  the unit takes (box replication); partial units at the right and bottom
  edges keep their layout and give only the pixels inside the image; in a
  tile that overhangs the image's right edge the 4x4 routine steps over
  the units past the edge as if they were 4x2's (10 bytes each, not 18),
  so its later unit rows come from other bytes, which PIL shows;
- the Orientation tag, which the reader leaves to PIL: PIL's loader
  transposes the decoded image by it, as it does every TIFF's.
"""

from __future__ import annotations

import numpy as np

SUBSAMPLINGS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))  # (h, v) with a put routine
LUMA = (0.299, 0.587, 0.114)
REFERENCE_BLACK_WHITE = (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)
SHIFT = 16
ONE_HALF = 1 << (SHIFT - 1)


def _f32(x):
    return np.float32(x)


def _clampf(f, lo, hi):
    """tif_color.c's CLAMP on floats: !(f >= lo) ? lo : f > hi ? hi : f (NaN gives lo)."""
    f = np.asarray(f, np.float32)
    return np.where(~(f >= lo), np.float32(lo), np.where(f > hi, np.float32(hi), f)).astype(np.float32)


def _fix(x) -> int:
    """FIX(x): (int32)(x * 65536 + 0.5), x a float promoted to double."""
    return int(np.trunc(np.float64(x) * (1 << SHIFT) + 0.5))


def _code2v(c, rb, rw, cr):
    """Code2V: ((c - (int32)RB) * (float)CR) / (float)(RW - RB or 1), in float."""
    rb, rw = _f32(rb), _f32(rw)
    span = np.float32(rw - rb)
    span = span if span != 0 else np.float32(1)
    return ((np.asarray(c, np.int64) - int(np.trunc(rb))).astype(np.float32) * _f32(cr)) / span


def valid_coefficients(luma, ref) -> str | None:
    """initYCbCrConversion's checks: what is wrong with the tags, or None."""
    if np.isnan(luma[0]) or np.isnan(luma[1]) or np.isnan(luma[2]) or abs(float(luma[1])) < 1e-12:
        return "invalid values for the YCbCrCoefficients tag (libtiff)"
    lo, hi = np.float32(-0x7FFFFFFF + 128), np.float32(0x7FFFFFFF)
    if not all(lo < np.float32(r) < hi for r in ref):
        return "invalid values for the ReferenceBlackWhite tag (libtiff)"
    return None


def tables(luma=LUMA, ref=REFERENCE_BLACK_WHITE):
    """(Y, Cr_r, Cb_b, Cr_g, Cb_g) int64 tables of 256 entries each, as
    TIFFYCbCrToRGBInit builds them."""
    lr, lg, lb = (_f32(v) for v in luma)
    f1 = np.float32(2 - 2 * lr)
    d1 = _fix(_clampf(f1, 0.0, 2.0))
    f2 = np.float32(np.float32(lr * f1) / lg)
    d2 = -_fix(_clampf(f2, 0.0, 2.0))
    f3 = np.float32(2 - 2 * lb)
    d3 = _fix(_clampf(f3, 0.0, 2.0))
    f4 = np.float32(np.float32(lb * f3) / lg)
    d4 = -_fix(_clampf(f4, 0.0, 2.0))
    x = np.arange(-128, 128)
    ref = [_f32(v) for v in ref]
    cr = np.trunc(_clampf(_code2v(x, ref[4] - np.float32(128), ref[5] - np.float32(128), 127), -128.0 * 32,
                          128.0 * 32)).astype(np.int64)
    cb = np.trunc(_clampf(_code2v(x, ref[2] - np.float32(128), ref[3] - np.float32(128), 127), -128.0 * 32,
                          128.0 * 32)).astype(np.int64)
    y = np.trunc(_clampf(_code2v(x + 128, ref[0], ref[1], 255), -128.0 * 32, 128.0 * 32)).astype(np.int64)
    wrap = lambda v: (np.asarray(v, np.int64) + 2**31) % 2**32 - 2**31  # int32 products, as C's
    cr_r = (wrap(d1 * cr) + ONE_HALF) >> SHIFT
    cb_b = (wrap(d3 * cb) + ONE_HALF) >> SHIFT
    cr_g = wrap(d2 * cr)
    cb_g = wrap(wrap(d4 * cb) + ONE_HALF)
    return y, cr_r, cb_b, cr_g, cb_g


def to_rgb(y, cb, cr, tabs) -> np.ndarray:
    """TIFFYCbCrtoRGB of uint8 arrays: (..., 3) uint8."""
    ty, cr_r, cb_b, cr_g, cb_g = tabs
    yy = ty[y]
    r = yy + cr_r[cr]
    g = yy + ((cb_g[cb] + cr_g[cr] + 2**31) % 2**32 - 2**31 >> SHIFT)
    b = yy + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def unit_bytes(width: int, rows: int, h: int, v: int) -> int:
    """The bytes of `rows` rows of data units `width` pixels wide."""
    return -(-width // h) * -(-rows // v) * (h * v + 2)


def units_to_rgb(units: np.ndarray, width: int, rows: int, h: int, v: int, tabs, skip: int = 0) -> np.ndarray:
    """(rows, width, 3) RGB of a block of data units: unit rows of
    ceil(width / h) units each, every unit row followed by the reader's
    skew: the units of a tile past the image's right edge, `skip` pixels,
    over which its put routine steps (skip // h) units of h * v + 2 bytes
    each, or of 10 at 4x4 (the 4x4 routine steps as 4x2's does)."""
    uw, uh, n = -(-width // h), -(-rows // v), h * v + 2
    stride = uw * n + (skip // h) * (10 if (h, v) == (4, 4) else n)
    at = (np.arange(uh)[:, None] * stride + np.arange(uw * n)[None, :]).reshape(-1)
    u = np.asarray(units, np.uint8)[at].reshape(uh, uw, n)
    luma = u[..., :h * v].reshape(uh, uw, v, h).transpose(0, 2, 1, 3).reshape(uh * v, uw * h)
    cb = np.repeat(np.repeat(u[..., h * v], v, 0), h, 1)
    cr = np.repeat(np.repeat(u[..., h * v + 1], v, 0), h, 1)
    return to_rgb(luma[:rows, :width], cb[:rows, :width], cr[:rows, :width], tabs)
