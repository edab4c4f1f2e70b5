"""Sun raster reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the Sun raster files PIL 12's SunImagePlugin reads, returning an
`image_io.Picture`: a 32-byte big-endian header (width, height, depth,
length, type, colour map type and length), the colour map, then the
pixels. Depth 1 reads "1" from raw "1;I", 4 "L" from "L;4", 8 "L", 24
"RGB" from "RGB" (type 3) or "BGR", 32 "RGB" from "RGBX" (type 3) or
"BGRX"; a colour map (of type 1, at most 1024 bytes, its red, green and
blue runs one after the other as PIL's "RGB;L" palette) turns "L" into
"P". Types 0, 1, 3, 4 and 5 are raw rows padded to 16 bits; type 2 is
run-length coded as PIL's C `sun_rle` decoder reads it
(`image_codecs.sun_rle_decode`, `csrc/image_codecs.cc`; `plain_rle` here
is the same in Python, for the tests): 0x80 0x00 a literal 0x80, 0x80 n v
a run of n + 1 bytes v (carried across rows), any other byte a literal;
its rows are not padded.

A header cut short, another depth, a colour map of another type or over
1024 bytes, another type or a size of 0 raises `image_io.NotThisFormat`
(PIL passes the file on); a colour map on a "1" or "RGB" image (PIL:
unrecognized image mode), pixel data cut short and an image over PIL's
decompression-bomb limit raise a `ValueError` naming the file.
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatting_torch.utils import image_codecs, pil_raw

MAGIC = 0x59A66A95


def accepts(head: bytes) -> bool:
    return len(head) >= 4 and struct.unpack_from(">I", head)[0] == MAGIC


def _modes(depth: int, file_type: int):
    if depth == 1:
        return "1", "1;I"
    if depth == 4:
        return "L", "L;4"
    if depth == 8:
        return "L", "L"
    if depth == 24:
        return "RGB", "RGB" if file_type == 3 else "BGR"
    if depth == 32:
        return "RGB", "RGBX" if file_type == 3 else "BGRX"
    return None


def decode_sun(data: bytes, name: str = "<bytes>", plain: bool = False):
    """The `image_io.Picture` of Sun raster bytes; an RLE image's runs
    compiled, or with `plain` Python (`plain_rle`)."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    def passed(why):
        raise NotThisFormat(f"{name}: {why} (PIL: passed on)")

    if len(data) < 32 or not accepts(data):
        passed("a Sun raster header cut short")
    _, width, height, depth, _, file_type, palette_type, palette_length = struct.unpack(">8I", data[:32])
    modes = _modes(depth, file_type)
    if modes is None:
        passed(f"a Sun raster depth of {depth} (Unsupported Mode/Bit Depth)")
    mode, rawmode = modes
    offset, palette = 32, None
    if palette_length:
        if palette_length > 1024:
            passed(f"a Sun raster colour map of {palette_length} bytes")
        if palette_type != 1:
            passed(f"a Sun raster colour map of type {palette_type}")
        offset += palette_length
        raw = np.frombuffer(data[32:32 + palette_length], np.uint8)
        n = len(raw) // 3
        palette = raw[:3 * n].reshape(3, n).T.copy()  # PIL's "RGB;L": the red run, the green, the blue
        if mode == "L":
            mode, rawmode = "P", rawmode.replace("L", "P")
    if file_type not in (0, 1, 2, 3, 4, 5):
        passed(f"a Sun raster of type {file_type}")
    if width == 0 or height == 0:
        passed(f"a Sun raster of {width}x{height} pixels (an empty size)")
    pil_raw.check_size(width, height, name)
    if palette is not None and mode != "P":
        raise ValueError(f"{name}: a Sun raster colour map on a {mode} image (PIL: unrecognized image mode)")
    if file_type != 2:
        stride = (width * depth + 15) // 16 * 2
        px = pil_raw.raw_tile(data, offset, width, height, mode, rawmode, name, stride, mappable=False)
    else:
        n = pil_raw.row_bytes(rawmode, width)
        rows = (plain_rle(data, offset, n, height) if plain
                else image_codecs.sun_rle_decode(data, offset, n, height, name))
        if rows is None:
            raise ValueError(f"{name}: Sun raster RLE data that ends before the last row (PIL: image file is "
                             f"truncated)")
        px = pil_raw.unpack(rows, rawmode, width, mode)
    return Picture(px, mode, palette if mode == "P" else None)


def plain_rle(data: bytes, start: int, row_bytes: int, rows: int):
    """(rows, row_bytes) uint8: PIL's SunRleDecode.c from byte `start` of
    `data`, or None where the data ends before the last row."""
    out = np.zeros(rows * row_bytes, np.uint8)
    pos, x, y, n_data = start, 0, 0, len(data)
    while True:
        extra = 0
        if pos >= n_data:
            return None
        if data[pos] == 0x80:
            if n_data - pos < 2:
                return None
            n = data[pos + 1]
            if n == 0:
                n, value, pos = 1, 0x80, pos + 2
            else:
                if n_data - pos < 3:
                    return None
                n, value = n + 1, data[pos + 2]
                if x + n > row_bytes:
                    extra, n = n - (row_bytes - x), row_bytes - x
                pos += 3
        else:
            n, value, pos = 1, data[pos], pos + 1
        out[y * row_bytes + x:y * row_bytes + x + n] = value
        while True:
            x += n
            if x >= row_bytes:
                x, y = 0, y + 1
                if y >= rows:
                    return out.reshape(rows, row_bytes)
            if extra == 0:
                break
            n = min(extra, row_bytes)
            out[y * row_bytes:y * row_bytes + n] = value
            extra -= n
