"""SGI image reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the SGI files PIL 12's SgiImagePlugin reads, returning an
`image_io.Picture`. PIL's mode is its raw mode's prefix
(`SgiImagePlugin.MODES` on bytes per channel, dimension and channel
count): "L" (dimension 1 or 2, one channel), "RGB" (3 channels) and
"RGBA" (4), at 8 bits and at 16 (of which PIL keeps the high byte, so a
16-bit file too gives 8-bit "L", "RGB" or "RGBA"). Rows are stored
bottom-up. Verbatim files hold each channel's plane in turn; RLE files
are decoded by `utils/image_codecs.sgi_rle_decode` (compiled host C++,
PIL's SgiRleDecode.c: the offset and length tables, its bounds checks,
the row buffer kept from row to row, a decode ended early by a last chunk
that is not 0).

A header cut short or a size of 0 raises `image_io.NotThisFormat` (PIL
passes the file on to its next format); any other mode, compression or
bound PIL refuses raises a `ValueError` naming the file and the feature,
as do data that ends early and an image over PIL's decompression-bomb
limit.
"""

from __future__ import annotations

import numpy as np

from gaussian_splatting_torch.utils import image_codecs
from gaussian_splatting_torch.utils.bmp import MAX_PIXELS

SIGNATURE = b"\x01\xda"  # 474, big-endian
HEADER = 512
# (bytes per channel, dimension, channels) -> PIL's raw mode
MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B", (2, 2, 1): "L;16B", (1, 3, 3): "RGB",
         (2, 3, 3): "RGB;16B", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}
SUPPORTED = "the port reads the SGI files PIL reads (SgiImagePlugin)"


def _u16(data: bytes, at: int) -> int:
    return int.from_bytes(data[at:at + 2], "big")


def decode_sgi(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of SGI bytes."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    if len(data) < 12:
        raise NotThisFormat(f"{name}: an SGI header cut short")
    compression, bpc = data[2], data[3]
    dimension, width, height, channels = _u16(data, 4), _u16(data, 6), _u16(data, 8), _u16(data, 10)
    raw = MODES.get((bpc, dimension, channels))
    if raw is None:
        raise ValueError(f"{name}: an SGI image of {bpc} bytes a channel, dimension {dimension} and {channels} "
                         f"channels (PIL: Unsupported SGI image mode); {SUPPORTED}")
    mode = raw.split(";")[0]
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: an SGI image of {width}x{height} pixels (PIL: an empty size, passed on)")
    if width * height > MAX_PIXELS:
        raise ValueError(f"{name}: an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    bands = len(mode)
    if compression == 0:
        plane = width * height * bpc
        if len(data) < HEADER + bands * plane:
            raise ValueError(f"{name}: truncated SGI pixel data ({max(len(data) - HEADER, 0)} of "
                             f"{bands * plane} bytes)")
        samples = np.frombuffer(data, np.uint8, bands * plane, HEADER).reshape(bands, height, width * bpc)
        pixels = samples[:, ::-1, ::bpc].transpose(1, 2, 0)  # rows bottom-up; the high byte of 16 bits
    elif compression == 1:
        rows = image_codecs.sgi_rle_decode(data, bands, width, height, bpc, name)
        pixels = rows[:, ::bpc].reshape(height, width, bands)
    else:
        raise ValueError(f"{name}: SGI compression {compression} (PIL: cannot load this image); {SUPPORTED}")
    return Picture(np.ascontiguousarray(pixels), mode)
