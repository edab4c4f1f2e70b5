"""XV thumbnail reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the XV thumbnail files PIL 12's XVThumbImagePlugin reads,
returning an `image_io.Picture` in mode "P" with XV's fixed 3-3-2 palette:
`P7 332`, the rest of that line, comment lines (`#` first), a line whose
first two words are the width and height, then one byte a pixel raw.

A file that ends in its comments raises `image_io.NotThisFormat` (PIL
passes the file on); a size line of fewer than two words or a size that
is not a number (PIL: ValueError), pixel data cut short and an image over
PIL's decompression-bomb limit raise a `ValueError` naming the file.
"""

from __future__ import annotations

import numpy as np

from gaussian_splatting_torch.utils import pil_raw

SIGNATURE = b"P7 332"
# XVThumbImagePlugin.PALETTE: r, g, b of 3, 3 and 2 bits
_i = np.arange(256)
PALETTE = np.stack([(_i >> 5) * 255 // 7, (_i >> 2 & 7) * 255 // 7, (_i & 3) * 255 // 3], -1).astype(np.uint8)


def accepts(head: bytes) -> bool:
    return head.startswith(SIGNATURE)


def _line(data: bytes, pos: int):
    """PIL's readline from `pos`: (the line with its b"\\n", the next position)."""
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def decode_xvthumb(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of XV thumbnail bytes."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    _, pos = _line(data, 6)
    while True:
        s, pos = _line(data, pos)
        if not s:
            raise NotThisFormat(f"{name}: an XV thumbnail that ends in its comments (PIL: Unexpected EOF reading "
                                f"XV thumbnail file, passed on)")
        if s[0] != ord("#"):
            break
    words = s.strip().split(maxsplit=2)[:2]
    try:
        width, height = (int(w) for w in words)
    except ValueError:
        raise ValueError(f"{name}: an XV thumbnail size line {s!r} (PIL: ValueError)") from None
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: an XV thumbnail of {width}x{height} pixels (PIL: an empty size, passed on)")
    return Picture(pil_raw.raw_tile(data, pos, width, height, "P", "P", name), "P", PALETTE.copy())
