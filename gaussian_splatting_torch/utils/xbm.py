"""X11 bitmap reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the XBM files PIL 12's XbmImagePlugin reads, returning an
`image_io.Picture` in mode "1": PIL's `xbm_head` pattern over the first
512 bytes (the `_width` and `_height` defines, an optional hotspot pair,
then anything up to the last `_bits[]`), then PIL's C `xbm` decoder on the
rest of the file (`image_codecs.xbm_decode`, `csrc/image_codecs.cc`;
`plain_decode` here is the same in Python, for the tests): each byte is
the two characters after the next `x`, each a hex digit or else 0, its
bits least significant first, a set bit True, rows padded to a byte.
PIL's first-bytes test is the 16-byte prefix, blanks stripped, starting
`#define`.

A header the pattern does not match or a size of 0 raises
`image_io.NotThisFormat` (PIL passes the file on); data that ends before
the last row and an image over PIL's decompression-bomb limit raise a
`ValueError` naming the file.
"""

from __future__ import annotations

import re

import numpy as np

from gaussian_splatting_torch.utils import image_codecs, pil_raw

XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
_HEX = np.zeros(256, np.uint8)
for _c in b"0123456789abcdefABCDEF":
    _HEX[_c] = int(chr(_c), 16)


def accepts(head: bytes) -> bool:
    """XbmImagePlugin._accept of the 16-byte prefix PIL tests."""
    return head[:16].lstrip().startswith(b"#define")


def decode_xbm(data: bytes, name: str = "<bytes>", plain: bool = False):
    """The `image_io.Picture` of XBM bytes; the hex text compiled, or
    with `plain` Python (`plain_decode`)."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    m = XBM_HEAD.match(data[:512])
    if not m:
        raise NotThisFormat(f"{name}: no XBM header in the first 512 bytes (PIL: not a XBM file, passed on)")
    width, height = int(m.group("width")), int(m.group("height"))
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: an XBM image of {width}x{height} pixels (PIL: an empty size, passed on)")
    pil_raw.check_size(width, height, name)
    n = (width + 7) // 8
    body = data[m.end():]
    rows = plain_decode(body, n, height) if plain else image_codecs.xbm_decode(body, n, height, name)
    if rows is None:
        raise ValueError(f"{name}: XBM data that ends before the last row (PIL: image file is truncated)")
    bits = (rows[:, :, None] >> np.arange(8, dtype=np.uint8)) & 1
    return Picture(bits.reshape(height, -1)[:, :width, None].astype(bool), "1")


def plain_decode(body: bytes, row_bytes: int, rows: int):
    """(rows, row_bytes) uint8 of PIL's XbmDecode.c on `body`, or None
    where it ends before the last row."""
    out = np.zeros(rows * row_bytes, np.uint8)
    pos = 0
    for i in range(out.size):
        pos = body.find(b"x", pos)
        if pos < 0 or len(body) - pos < 3:
            return None
        out[i] = _HEX[body[pos + 1]] << 4 | _HEX[body[pos + 2]]
        pos += 3
    return out.reshape(rows, row_bytes)
