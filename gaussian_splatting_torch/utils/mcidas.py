"""McIDAS area file reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the McIDAS area files PIL 12's McIdasImagePlugin reads,
returning an `image_io.Picture`: a 256-byte directory of 64 big-endian
words (PIL numbers them from 1), word 11 the bytes a sample (1 "L", 2
"I;16B", 4 "I" from big-endian 32-bit integers), words 10 and 9 the width
and height, then rows raw at the offset of words 34 + 15, each row
`w15 + w10 * w11 * w14` bytes after the last. An "L" or "I;16B" file is
mapped as PIL maps it (`pil_raw.raw_tile`).

A directory cut short or another sample size raises
`image_io.NotThisFormat` (PIL passes the file on); pixel data cut short, a
negative offset and an image over PIL's decompression-bomb limit raise a
`ValueError` naming the file.
"""

from __future__ import annotations

import struct

from gaussian_splatting_torch.utils import pil_raw

SIGNATURE = b"\x00\x00\x00\x00\x00\x00\x00\x04"
MODES = {1: ("L", "L"), 2: ("I;16B", "I;16B"), 4: ("I", "I;32B")}


def accepts(head: bytes) -> bool:
    return head.startswith(SIGNATURE)


def decode_mcidas(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of McIDAS area bytes."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    if len(data) < 256 or not accepts(data):
        raise NotThisFormat(f"{name}: a McIDAS directory cut short (PIL: not an McIdas area file, passed on)")
    w = (0, *struct.unpack(">64i", data[:256]))
    if w[11] not in MODES:
        raise NotThisFormat(f"{name}: McIDAS samples of {w[11]} bytes (PIL: unsupported McIdas format, passed on)")
    mode, rawmode = MODES[w[11]]
    width, height = w[10], w[9]
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: a McIDAS image of {width}x{height} pixels (PIL: an empty size, passed on)")
    offset, stride = w[34] + w[15], w[15] + w[10] * w[11] * w[14]
    return Picture(pil_raw.raw_tile(data, offset, width, height, mode, rawmode, name, stride, 1), mode)
