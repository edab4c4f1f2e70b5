"""MPEG: opened by PIL 12's MpegImagePlugin, which cannot load it.

PIL opens a stream that starts with a sequence header (00 00 01 B3) as an
"RGB" image of the header's 12-bit width and height, and its load raises
(cannot load this image): it has no MPEG decoder. The port raises where
PIL's load raises, naming the format; a stream cut short in the sizes or
of a size of 0 raises `image_io.NotThisFormat` (PIL passes the file on).
"""

from __future__ import annotations

SIGNATURE = b"\x00\x00\x01\xb3"


def accepts(head: bytes) -> bool:
    return head.startswith(SIGNATURE)


def decode_mpeg(data: bytes, name: str = "<bytes>"):
    """Raise as PIL does on MPEG bytes."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat

    if len(data) < 7:
        raise NotThisFormat(f"{name}: an MPEG sequence header cut short (PIL: IndexError, passed on)")
    width, height = data[4] << 4 | data[5] >> 4, (data[5] & 15) << 8 | data[6]
    if width == 0 or height == 0:
        raise NotThisFormat(f"{name}: an MPEG stream of {width}x{height} pixels (PIL: an empty size, passed on)")
    raise ValueError(f"{name}: an MPEG file of {width}x{height}, which PIL opens and cannot load (PIL: cannot load "
                     f"this image): it has no MPEG decoder")
