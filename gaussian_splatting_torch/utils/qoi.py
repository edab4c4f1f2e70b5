"""QOI reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the QOI files PIL 12's QoiImagePlugin reads, returning an
`image_io.Picture`: mode "RGB" where the header's channel count is 3 and
"RGBA" for any other count; the colour space byte is skipped. The stream
(every op: RGB, RGBA, INDEX, DIFF, LUMA and RUN) is decoded by
`utils/image_codecs.qoi_decode` (compiled host C++) as PIL's Python
decoder reads it: a RUN does not enter its pixel in the index table, a
slot never filled reads as transparent black, the end marker is not read.

A header cut short or a size of 0 raises `image_io.NotThisFormat` (PIL
passes the file on to its next format); a stream that ends before the
last pixel, or an image over PIL's decompression-bomb limit, raises a
`ValueError` naming the file.
"""

from __future__ import annotations

from gaussian_splatting_torch.utils import image_codecs
from gaussian_splatting_torch.utils.bmp import MAX_PIXELS

SIGNATURE = b"qoif"


def decode_qoi(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of QOI bytes."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    if len(data) < 13:
        raise NotThisFormat(f"{name}: a QOI header cut short")
    width, height = int.from_bytes(data[4:8], "big"), int.from_bytes(data[8:12], "big")
    mode = "RGB" if data[12] == 3 else "RGBA"
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: a QOI image of {width}x{height} pixels (PIL: an empty size, passed on)")
    if width * height > MAX_PIXELS:
        raise ValueError(f"{name}: an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    return Picture(image_codecs.qoi_decode(data, 14, len(mode), width, height, name), mode)
