"""PIXAR raster reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the PIXAR files PIL 12's PixarImagePlugin reads, returning an
`image_io.Picture`: a 512-byte little-endian header (the width at byte 418,
the height at 416, the channel / depth pair at 424), then the pixels raw
from byte 1024. PIL reads one pair only, (14, 2), as "RGB"; any other
leaves the image without a mode, and PIL passes the file on.

A header cut short, another channel / depth pair or a size of 0 raises
`image_io.NotThisFormat` (PIL passes the file on); pixel data cut short and
an image over PIL's decompression-bomb limit raise a `ValueError` naming
the file.
"""

from __future__ import annotations

import struct

from gaussian_splatting_torch.utils import pil_raw

SIGNATURE = b"\x80\xe8\x00\x00"


def accepts(head: bytes) -> bool:
    return head.startswith(SIGNATURE)


def decode_pixar(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of PIXAR bytes."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    try:
        height, width, _, _, channels, depth = struct.unpack_from("<6H", data, 416)
    except struct.error:
        raise NotThisFormat(f"{name}: a PIXAR header cut short (PIL: struct.error, passed on)") from None
    if (channels, depth) != (14, 2) or width == 0 or height == 0:
        raise NotThisFormat(f"{name}: a PIXAR image of channels / depth {(channels, depth)}, {width}x{height} "
                            f"pixels (PIL: no mode or an empty size, passed on)")
    return Picture(pil_raw.raw_tile(data, 1024, width, height, "RGB", "RGB", name), "RGB")
