"""FTEX reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the Independence War 2 texture files (.ftc / .ftu) PIL 12's
FtexImagePlugin reads, returning an `image_io.Picture` of the first
format's first mipmap: format 0, DXT1 blocks decoded by PIL's bcn decoder
(`utils/dds.bcn_decode`, `csrc/bcn_decode.cc`), mode "RGBA"; format 1,
raw "RGB". PIL reads only the header, the one format entry and the
mipmap's size and bytes at its offset.

A header cut short or a size of 0 raises `image_io.NotThisFormat` (PIL
passes the file on); a format count other than 1 (PIL: an AssertionError),
another format, a mipmap of fewer bytes than the image and an image over
PIL's decompression-bomb limit raise a `ValueError` naming the file.
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatting_torch.utils import dds
from gaussian_splatting_torch.utils.bmp import MAX_PIXELS

SIGNATURE = b"FTEX"


def decode_ftex(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of FTEX bytes."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    try:
        width, height, _, format_count = struct.unpack_from("<4i", data, 8)
        if format_count != 1:
            raise ValueError(f"{name}: an FTEX file of {format_count} formats (PIL: assert format_count == 1); "
                             f"the port reads the FTEX files PIL reads (FtexImagePlugin)")
        fmt, where = struct.unpack_from("<2i", data, 24)
        if where < 0:
            raise ValueError(f"{name}: an FTEX mipmap at offset {where} (PIL: negative seek value)")
        size = struct.unpack_from("<i", data, where)[0]
    except struct.error:
        raise NotThisFormat(f"{name}: an FTEX header cut short (PIL: struct.error, passed on)") from None
    if size < -1:
        raise ValueError(f"{name}: an FTEX mipmap size of {size} (PIL: read length must be non-negative or -1)")
    body = data[where + 4:] if size == -1 else data[where + 4:where + 4 + size]  # PIL's read(-1) reads to the end
    if fmt not in (0, 1):
        raise ValueError(f"{name}: FTEX texture format {fmt} (PIL: Invalid texture compression format)")
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: an FTEX image of {width}x{height} pixels (PIL: an empty size, passed on)")
    if width * height > MAX_PIXELS:
        raise ValueError(f"{name}: an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    if fmt == 0:
        return Picture(dds.bcn_decode(body, 1, False, width, height, name), "RGBA")
    need = width * height * 3
    if len(body) < need:
        raise ValueError(f"{name}: FTEX pixel data of {len(body)} of its {need} bytes (PIL: image file is "
                         f"truncated)")
    return Picture(np.frombuffer(body, np.uint8, need).reshape(height, width, 3), "RGB")
