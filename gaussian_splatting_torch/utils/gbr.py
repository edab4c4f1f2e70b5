"""GIMP brush reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the GIMP brush files (.gbr) PIL 12's GbrImagePlugin reads,
returning an `image_io.Picture`: a big-endian header (its size, version 1
or 2, width, height, colour depth 1 "L" or 4 "RGBA"; version 2 then
"GIMP" and the spacing), the comment, then the pixels raw. PIL's first-
bytes test reads the header size and the version as big-endian int32s.

A header cut short, a header size below 20, another version or colour
depth, a version 2 without "GIMP" or a size of 0 raises
`image_io.NotThisFormat` (PIL passes the file on); pixel data cut short
(PIL: not enough image data) and an image over PIL's decompression-bomb
limit raise a `ValueError` naming the file.
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatting_torch.utils.bmp import MAX_PIXELS


def accepts(head: bytes) -> bool:
    """GbrImagePlugin._accept: a header size of at least 20 and version 1
    or 2, big-endian."""
    return len(head) >= 8 and struct.unpack_from(">I", head)[0] >= 20 and struct.unpack_from(">I", head, 4)[0] in (1, 2)


def decode_gbr(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of GIMP brush bytes."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    def passed(why):
        raise NotThisFormat(f"{name}: {why} (PIL: not a GIMP brush, passed on)")

    try:
        header_size, version, width, height, depth = struct.unpack_from(">5I", data, 0)
        if header_size < 20 or version not in (1, 2):
            passed(f"a brush header size of {header_size}, version {version}")
        if width == 0 or height == 0:
            passed(f"a brush of {width}x{height} pixels")
        if depth not in (1, 4):
            passed(f"a brush colour depth of {depth}")
        pos = 20
        if version == 2:
            if data[20:24] != b"GIMP":
                passed("a version 2 brush without GIMP")
            struct.unpack_from(">I", data, 24)
            pos = 28
    except struct.error:
        passed("a brush header cut short (struct.error)")
    comment = header_size - pos
    if comment < -1:
        raise ValueError(f"{name}: a brush header size of {header_size} (PIL: read length must be non-negative "
                         f"or -1); the port reads the GIMP brushes PIL reads (GbrImagePlugin)")
    pos = len(data) if comment == -1 else min(pos + comment, len(data))  # PIL's read(-1) reads to the end
    if width * height > MAX_PIXELS:
        raise ValueError(f"{name}: an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    need = width * height * depth
    body = data[pos:pos + need]
    if len(body) < need:
        raise ValueError(f"{name}: brush pixel data of {len(body)} of its {need} bytes (PIL: not enough image "
                         f"data); the port reads the GIMP brushes PIL reads (GbrImagePlugin)")
    return Picture(np.frombuffer(body, np.uint8).reshape(height, width, depth), "L" if depth == 1 else "RGBA")
