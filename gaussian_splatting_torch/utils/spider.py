"""SPIDER reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the SPIDER 2-D images PIL 12's SpiderImagePlugin reads,
returning an `image_io.Picture` in mode "F": a header of 32-bit floats,
big-endian where its first 27 pass PIL's `isSpiderHeader` read so, else
little-endian, then the first image raw (`F;32BF` or `F;32F`) at the
header's length, or at twice it for a stack. PIL tests no first bytes: it
tries this reader on every file that reaches it in its order, and passes
on every file whose header fails the test in both byte orders.

A header that fails the test in both byte orders, cut short, of another
form than a 2-D image (iform 1), of inconsistent stack values or of an
empty size raises `image_io.NotThisFormat` (PIL passes the file on); a
stack or image number that is not finite (PIL: ValueError,
OverflowError), an image of a stack opened at its own header (PIL:
AttributeError), pixel data cut short, a negative header length and an
image over PIL's decompression-bomb limit raise a `ValueError` naming the
file.
"""

from __future__ import annotations

import struct

from gaussian_splatting_torch.utils import pil_raw

IFORMS = (1, 3, -11, -12, -21, -22)


def _is_int(f: float) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def header_length(t) -> int:
    """SpiderImagePlugin.isSpiderHeader of the floats `t`: the header's
    length in bytes, 0 where it is not a SPIDER header."""
    h = (99, *t)
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in IFORMS:
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return 0 if labbyt != labrec * lenbyt else labbyt


def passes_on(head: bytes):
    """Why PIL's reader passes on a file whose first 108 bytes are `head`
    on its header test alone, or None."""
    if len(head) < 108:
        return "a SPIDER header cut short (struct.error)"
    if not (header_length(struct.unpack(">27f", head[:108])) or header_length(struct.unpack("<27f", head[:108]))):
        return "not a SPIDER header in either byte order"
    return None


def decode_spider(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of SPIDER bytes: the first image, mode "F"."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    why = passes_on(data)
    if why:
        raise NotThisFormat(f"{name}: {why} (PIL: not a valid Spider file, passed on)")
    big = True
    t = struct.unpack(">27f", data[:108])
    hdrlen = header_length(t)
    if not hdrlen:
        big, t = False, struct.unpack("<27f", data[:108])
        hdrlen = header_length(t)
    h = (99, *t)
    if int(h[5]) != 1:
        raise NotThisFormat(f"{name}: a SPIDER file of iform {int(h[5])} (PIL: not a Spider 2D image, passed on)")
    width, height = int(h[12]), int(h[2])
    try:
        istack, imgnumber = int(h[24]), int(h[27])
        if istack > 0 and imgnumber == 0:
            int(h[26])  # the stack's image count
    except (ValueError, OverflowError):
        raise ValueError(f"{name}: a SPIDER stack header of {h[24]}, {h[26]}, {h[27]} (PIL: ValueError)") from None
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = hdrlen * 2
    elif istack == 0 and imgnumber > 0:
        raise ValueError(f"{name}: a SPIDER image of a stack, number {imgnumber}, opened on its own (PIL: "
                         f"AttributeError: no stkoffset)")
    else:
        raise NotThisFormat(f"{name}: SPIDER stack values {istack}, {imgnumber} (PIL: inconsistent stack header "
                            f"values, passed on)")
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: a SPIDER image of {width}x{height} pixels (PIL: an empty size, passed on)")
    rawmode = "F;32BF" if big else "F;32F"
    return Picture(pil_raw.raw_tile(data, offset, width, height, "F", rawmode, name), "F")
