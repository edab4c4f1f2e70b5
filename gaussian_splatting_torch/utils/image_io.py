"""PNG reading and writing, and PIL's default resize, on zlib and numpy.

The JAX package reads every image with PIL and writes and reads its PNGs
with imageio. Neither is installed where the port runs, so the port keeps
its own:

- `read_png(path)`: 8-bit greyscale, grey + alpha, RGB and RGBA PNGs
  without interlacing, all five row filters; (H, W, C) uint8 with C = 1,
  2, 3 or 4, the pixels PIL gives. Any other file (16-bit, palette,
  bit depths below 8, interlaced, a transparency chunk, JPEG or any
  non-PNG) raises a `ValueError` naming the file and what it cannot read.
- `write_png(path, array)`: 8-bit PNGs, every row with the Sub filter.
- `resize(array, (w, h))`: `PIL.Image.resize(size)` at its default, bit
  for bit: bicubic (a = -0.5) with its support widened by the downscale
  factor, coefficients normalised and held in 22-bit fixed point, a
  horizontal then a vertical pass, each rounded and clipped to uint8; a
  pass is skipped where its dimension does not change. Grey + alpha and
  RGBA are premultiplied first (PIL's `La` / `RGBa` modes) and divided
  back afterwards.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for 8-bit samples (0 grey, 2 RGB, 4 grey +
# alpha, 6 RGBA; 3 is palette, refused)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _refuse(path, what: str):
    raise ValueError(f"{path}: {what}; the port reads 8-bit grey, grey + alpha, RGB and "
                     f"RGBA PNGs without interlacing only")


def _sniff(head: bytes) -> str:
    if head.startswith(b"\xff\xd8\xff"):
        return "a JPEG file"
    return "not a PNG file (no PNG signature)"


def read_png(path) -> np.ndarray:
    """(H, W, C) uint8 pixels of an 8-bit PNG, C = 1, 2, 3 or 4."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        _refuse(path, _sniff(data[:8]))
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos + 8 <= len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tRNS":
            _refuse(path, "a transparency chunk (tRNS)")
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, color, _compression, _filter, interlace = header
    if color == 3:
        _refuse(path, "a palette image (PNG colour type 3)")
    if color not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {color}")
    if depth != 8:
        _refuse(path, f"{depth}-bit samples")
    if interlace:
        _refuse(path, "an interlaced (Adam7) image")
    channels = _CHANNELS[color]
    stride = width * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError(f"{path}: PNG image data too short")
    rows = raw[:height * (stride + 1)].reshape(height, stride + 1)
    filters = rows[:, 0]
    if int(filters.max(initial=0)) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {int(filters.max())}")
    return _unfilter(rows[:, 1:].reshape(height, width, channels), filters)


def _unfilter(raw: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Undo PNG's row filters: raw (H, W, C) uint8 filtered samples, one
    filter type (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) per row."""
    if bool(np.isin(filters, (3, 4)).any()):
        return _unfilter_wavefront(raw, filters)
    # None, Sub and Up only: Sub is a running sum along the row, and each
    # run of Up rows a running sum down the columns from the row above it
    # (uint8 sums wrap mod 256, as PNG's do).
    rows = raw.copy()
    sub = filters == 1
    rows[sub] = np.cumsum(rows[sub], axis=1, dtype=np.uint8)
    up = filters == 2
    if up.any():
        total = np.cumsum(rows, axis=0, dtype=np.uint8)
        # the last row that is not Up at or above each row (-1: none)
        anchor = np.maximum.accumulate(np.where(up, -1, np.arange(len(filters))))
        before = total[np.maximum(anchor - 1, 0)]
        before[anchor <= 0] = 0
        rows = total - before
    return rows


def _unfilter_wavefront(raw: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Every filter, Average and Paeth included. A sample depends on its
    left, upper and upper-left neighbours, so the samples on one
    anti-diagonal (x + y = d) depend only on the two before it: the image
    is decoded in W + H - 1 vectorised steps. In the skewed layout
    s[d, 1 + y] = out[y, d - y] each diagonal is one row of `s`, its left
    neighbours s[d - 1, 1 + y], its upper ones s[d - 1, y] and its upper
    left ones s[d - 2, y]; row 0 of the second axis and every cell outside
    the image stay 0, the value PNG gives to samples off the image."""
    H, W, C = raw.shape
    D = W + H - 1
    ys = np.arange(H)
    d_of = ys[:, None] + np.arange(W)[None, :]  # (H, W) diagonal of each sample
    skew_raw = np.zeros((D, H, C), np.int16)
    skew_raw[d_of, ys[:, None]] = raw
    s = np.zeros((D + 1, H + 1, C), np.int16)  # s[d + 1] holds diagonal d
    f = filters.astype(np.int64)
    for d in range(D):
        y0, y1 = max(0, d - W + 1), min(H, d + 1)
        a = s[d, 1 + y0:1 + y1]  # left
        b = s[d, y0:y1]  # up
        c = s[d - 1, y0:y1] if d > 0 else np.zeros_like(a)  # upper left
        fy = f[y0:y1, None]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([fy == 1, fy == 2, fy == 3, fy == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        s[d + 1, 1 + y0:1 + y1] = (skew_raw[d, y0:y1] + pred) & 255
    return s[1:][d_of, 1 + ys[:, None]].astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path, array: np.ndarray):
    """Write (H, W) or (H, W, C) uint8 pixels, C = 1, 2, 3 or 4, as an
    8-bit PNG whose rows all take the Sub filter, deflated at zlib's level
    1: several times faster than PIL's 6, for a file about a tenth larger."""
    a = np.asarray(array)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, not {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"write_png takes (H, W) or (H, W, 1..4) pixels, not {a.shape}")
    H, W, C = a.shape
    rows = np.empty((H, 1 + W * C), np.uint8)
    rows[:, 0] = 1  # Sub: each sample less the one of the pixel to its left
    body = rows[:, 1:].reshape(H, W, C)
    body[:, 0] = a[:, 0]
    np.subtract(a[:, 1:], a[:, :-1], out=body[:, 1:])  # uint8 arithmetic wraps mod 256
    header = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[C], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))


# ---- PIL.Image.resize(size) at its default: BICUBIC ----

PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8-bit images (Resample.c)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coefficients(in_size: int, out_size: int):
    """PIL's precompute_coeffs + normalize_coeffs_8bpc for the box
    (0, in_size): per output sample its first input sample and ksize
    fixed-point weights (zero past the samples it uses)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale  # bicubic's support, widened when downscaling
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)  # C's truncating casts
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    k = np.arange(ksize)
    used = k[None, :] < xmax[:, None]
    ss = 1.0 / filterscale
    w = np.where(used, _bicubic((k[None, :] + xmin[:, None] - center[:, None] + 0.5) * ss), 0.0)
    total = np.zeros(out_size)
    for j in range(ksize):  # C's left-to-right sum
        total += w[:, j]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * (1 << PRECISION_BITS)),
                     np.trunc(0.5 + w * (1 << PRECISION_BITS))).astype(np.int32)
    index = np.minimum(xmin[:, None] + k[None, :], in_size - 1)
    return index, fixed


def _pass(x: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One resampling pass along `axis` of uint8 x, rounded and clipped."""
    index, fixed = _coefficients(x.shape[axis], out_size)
    # int32, as PIL's sums: 255 times the positive weights stays below 2^31
    acc = np.full(x.shape[:axis] + (out_size,) + x.shape[axis + 1:], 1 << (PRECISION_BITS - 1),
                  np.int32)
    shape = [1] * x.ndim
    shape[axis] = out_size
    for j in range(index.shape[1]):
        acc += np.take(x, index[:, j], axis=axis) * fixed[:, j].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a.astype(np.int64) * b + 128
    return ((t >> 8) + t) >> 8


def resize(array: np.ndarray, size) -> np.ndarray:
    """`PIL.Image.resize(size)` of (H, W) or (H, W, C) uint8 pixels, C = 1
    to 4 (L, LA, RGB, RGBA), `size` = (width, height)."""
    a = np.asarray(array)
    if a.dtype != np.uint8:
        raise ValueError(f"resize takes uint8 pixels, not {a.dtype}")
    out_w, out_h = int(size[0]), int(size[1])
    if (out_w, out_h) == (a.shape[1], a.shape[0]):
        return a.copy()  # PIL copies an image whose size does not change
    squeeze = a.ndim == 2
    x = a[..., None] if squeeze else a
    C = x.shape[2]
    alpha = None
    if C in (2, 4):  # PIL resizes LA and RGBA premultiplied (La, RGBa)
        alpha = x[..., -1:].astype(np.int64)
        x = np.concatenate([_muldiv255(x[..., :-1], alpha), alpha], axis=-1).astype(np.uint8)
    if out_w != x.shape[1]:
        x = _pass(x, 1, out_w)
    if out_h != x.shape[0]:
        x = _pass(x, 0, out_h)
    if alpha is not None:
        alpha = x[..., -1:].astype(np.int64)
        color = x[..., :-1].astype(np.int64)
        keep = (alpha == 0) | (alpha == 255)
        divided = np.minimum(255 * color // np.maximum(alpha, 1), 255)
        x = np.concatenate([np.where(keep, color, divided), alpha], axis=-1).astype(np.uint8)
    return x[..., 0] if squeeze else x
