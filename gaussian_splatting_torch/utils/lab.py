"""PIL's `convert("RGBA")` of a CIELab ("LAB") image, as LittleCMS 2.17 gives it.

PIL converts mode LAB through LittleCMS (`ImageCms`): a transform from its
built-in Lab profile (`cmsCreateLab2Profile`, D50) to its built-in sRGB
profile (`cmsCreate_sRGBProfile`), perceptual intent, 8 bits in and out.
This is the port's own copy of what that transform computes:

- the input: PIL hands LittleCMS the a and b bytes with their top bit
  flipped (TIFF stores them signed), each byte b as the 16-bit b * 257;
- LittleCMS resamples its pipeline into a 33 x 33 x 33 table of 16-bit
  values (`OptimizeByResampling`): each node's input q / 65535 in single
  precision, Lab (L * 100, a * 255 - 128, b * 255 - 128) to XYZ under D50
  (`cmsLab2XYZ` in double), XYZ over 1 + 32767 / 32768 to single, the
  inverse of sRGB's colorant matrix (Rec. 709 primaries and D65 adapted to
  D50 by Bradford, each step in LittleCMS's double order) times the same
  factor, summed in double and stored single, the inverse of sRGB's
  parametric curve (type -4: 2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92,
  0.04045) in double, stored single, then `_cmsQuickSaturateWord(v *
  65535)` (a floor after rounding to 1 / 65536);
- each pixel: `TetrahedralInterp16` of the table (16.16 fixed point, its
  rounding `(Rest + 0x8001) + ((Rest + 0x8001) >> 16) >> 16`), then 16 to 8
  bits as `(x * 65281 + 8388608) >> 24`; alpha 255.

Black point compensation, which LittleCMS turns on for a v4 output profile
in the perceptual intent, changes nothing here: both black points are 0.
"""

from __future__ import annotations

import functools

import numpy as np

GRID = 33
MAX_ENCODEABLE_XYZ = 1.0 + 32767.0 / 32768.0
D50 = (0.9642, 1.0, 0.8249)
BRADFORD = ((0.8951, 0.2664, -0.1614), (-0.7502, 1.7135, 0.0367), (0.0389, -0.0685, 1.0296))
SRGB_CURVE = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)


def _inverse(a):
    """_cmsMAT3inverse, in its order of double operations."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det, (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det, (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det, (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _product(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j] for j in range(3)] for i in range(3)]


def _apply(a, v):
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2] for i in range(3)]


def srgb_colorants():
    """sRGB's RGB -> XYZ (D50) matrix as cmsCreateRGBProfile builds it:
    _cmsBuildRGB2XYZtransferMatrix, then _cmsAdaptMatrixToD50 (Bradford)."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    primaries = [[xr, xg, xb], [yr, yg, yb], [(1 - xr - yr), (1 - xg - yg), (1 - xb - yb)]]
    coef = _apply(_inverse(primaries), [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    m = [[coef[0] * xr, coef[1] * xg, coef[2] * xb], [coef[0] * yr, coef[1] * yg, coef[2] * yb],
         [coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)]]
    source = [(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0]  # cmsxyY2XYZ of the white point
    cone_src, cone_dst = _apply(BRADFORD, source), _apply(BRADFORD, list(D50))
    cone = [[cone_dst[0] / cone_src[0], 0.0, 0.0], [0.0, cone_dst[1] / cone_src[1], 0.0],
            [0.0, 0.0, cone_dst[2] / cone_src[2]]]
    adapt = _product(_inverse([list(r) for r in BRADFORD]), _product(cone, [list(r) for r in BRADFORD]))
    return _product(adapt, m)


def _saturate_word(d: np.ndarray) -> np.ndarray:
    """_cmsQuickSaturateWord: d + 0.5 floored after rounding to 1 / 65536
    (its magic-number floor), clamped to 0..65535."""
    d = d + 0.5
    floor = np.floor(np.round((d - 32767.0) * 65536.0) / 65536.0) + 32767
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, floor)).astype(np.int64)


@functools.cache
def table() -> np.ndarray:
    """(33, 33, 33, 3) int64: the 16-bit table LittleCMS resamples the
    transform into, indexed [L, a, b]."""
    f32, f64 = np.float32, np.float64
    q = np.floor(np.arange(GRID) * 65535.0 / (GRID - 1) + 0.5)
    L, A, B = (x.reshape(-1).astype(f32) / f32(65535.0) for x in np.meshgrid(q, q, q, indexing="ij"))
    y = (L.astype(f64) * 100.0 + 16.0) / 116.0
    x = y + 0.002 * (A.astype(f64) * 255.0 - 128.0)
    z = y - 0.005 * (B.astype(f64) * 255.0 - 128.0)
    limit = 24.0 / 116.0

    def f_1(t):
        return np.where(t <= limit, (108.0 / 841.0) * (t - (16.0 / 116.0)), t * t * t)

    xyz = [(f_1(v) * w / MAX_ENCODEABLE_XYZ).astype(f32) for v, w in zip((x, y, z), D50)]
    inverse = [[v * MAX_ENCODEABLE_XYZ for v in row] for row in _inverse(srgb_colorants())]
    g, a, b, c, d = SRGB_CURVE
    disc = (a * d + b) ** g
    out = []
    for row in inverse:
        linear = ((xyz[0].astype(f64) * row[0] + xyz[1].astype(f64) * row[1]) + xyz[2].astype(f64) * row[2])
        r = linear.astype(f32).astype(f64)
        curve = np.where(r >= disc, (np.power(np.maximum(r, disc), 1.0 / g) - b) / a, r / c)
        out.append(_saturate_word(curve.astype(f32).astype(f64) * 65535.0))
    return np.stack(out, -1).reshape(GRID, GRID, GRID, 3)


def _tetrahedral(inputs: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """TetrahedralInterp16 of (N, 3) 16-bit inputs: (N, 3) 16-bit outputs."""
    v = inputs.astype(np.int64)
    scaled = v * (GRID - 1)
    fixed = scaled + (scaled + 0x7FFF) // 0xFFFF  # _cmsToFixedDomain
    i0, r = fixed >> 16, fixed & 0xFFFF
    i1 = np.where(v == 0xFFFF, i0, i0 + 1)
    (x0, y0, z0), (x1, y1, z1), (rx, ry, rz) = i0.T, i1.T, r.T

    def at(x, y, z):
        return lut[x, y, z]

    c0 = at(x0, y0, z0)
    v100, v010, v001 = at(x1, y0, z0), at(x0, y1, z0), at(x0, y0, z1)
    v110, v101, v011, v111 = at(x1, y1, z0), at(x1, y0, z1), at(x0, y1, z1), at(x1, y1, z1)
    xy, yz, zx = rx >= ry, ry >= rz, rz >= rx
    xz = rx >= rz
    cases = [(xy & yz, (v100 - c0, v110 - v100, v111 - v110)),
             (xy & ~yz & zx, (v101 - v001, v111 - v101, v001 - c0)),
             (xy & ~yz & ~zx, (v100 - c0, v111 - v101, v101 - v100)),
             (~xy & xz, (v110 - v010, v010 - c0, v111 - v110)),
             (~xy & ~xz & yz, (v111 - v011, v010 - c0, v011 - v010)),
             (~xy & ~xz & ~yz, (v111 - v011, v011 - v001, v001 - c0))]
    conds = [c[:, None] for c, _ in cases]
    c1, c2, c3 = (np.select(conds, [k[i] for _, k in cases]) for i in range(3))
    rest = c1 * rx[:, None] + c2 * ry[:, None] + c3 * rz[:, None] + 0x8001
    return (c0 + ((rest + (rest >> 16)) >> 16)) & 0xFFFF


def lab_to_rgba(pixels: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8: PIL's convert("RGBA") of (H, W, 3) LAB pixels."""
    h, w = pixels.shape[:2]
    flat = pixels.reshape(-1, 3).astype(np.int64) ^ np.array([0, 0x80, 0x80])
    out = np.empty((h * w, 4), np.uint8)
    out[:, 3] = 255
    lut = table()
    for k in range(0, len(flat), 1 << 20):  # bounded temporaries
        rgb16 = _tetrahedral(flat[k:k + (1 << 20)] * 257, lut)
        out[k:k + (1 << 20), :3] = (rgb16 * 65281 + 8388608) >> 24
    return out.reshape(h, w, 4)
