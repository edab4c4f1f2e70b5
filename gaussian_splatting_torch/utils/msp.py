"""Windows Paint (MSP) reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the MSP files PIL 12's MspImagePlugin reads, returning an
`image_io.Picture` in mode "1": a 32-byte header of little-endian words
whose XOR is 0, the width and height at bytes 4 and 6; version 1
(`DanM`) then raw bits, version 2 (`LinS`) a map of each row's coded
length and the rows, run-length coded, as PIL's Python `MspDecoder`
reads them (`image_codecs.msp_decode`, `csrc/image_codecs.cc`;
`plain_decode` here is the same in Python, for the tests): a row of
length 0 is white, a run type of 0 then a count and a byte repeats the
byte, any other type is that many bytes copied (fewer where the row ends);
the bytes of all rows are one stream, laid into the image as raw "1"
rows of (width + 7) // 8 bytes.

A header cut short, a checksum other than 0 or a size of 0 raises
`image_io.NotThisFormat` (PIL passes the file on); a row map or a row cut
short, a run cut short (PIL: OSError), a stream shorter than the image
(PIL: not enough image data), raw data cut short and an image over PIL's
decompression-bomb limit raise a `ValueError` naming the file.
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatting_torch.utils import image_codecs, pil_raw

SIGNATURES = (b"DanM", b"LinS")


def accepts(head: bytes) -> bool:
    return head.startswith(SIGNATURES)


def decode_msp(data: bytes, name: str = "<bytes>", plain: bool = False):
    """The `image_io.Picture` of MSP bytes; version 2's runs compiled, or
    with `plain` Python (`plain_decode`)."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    if len(data) < 32 or not accepts(data):
        raise NotThisFormat(f"{name}: an MSP header cut short (PIL: struct.error, passed on)")
    words = np.frombuffer(data[:32], "<u2")
    if np.bitwise_xor.reduce(words) != 0:
        raise NotThisFormat(f"{name}: an MSP header checksum other than 0 (PIL: bad MSP checksum, passed on)")
    width, height = int(words[2]), int(words[3])
    if width == 0 or height == 0:
        raise NotThisFormat(f"{name}: an MSP image of {width}x{height} pixels (PIL: an empty size, passed on)")
    pil_raw.check_size(width, height, name)
    if data.startswith(b"DanM"):
        return Picture(pil_raw.raw_tile(data, 32, width, height, "1", "1", name), "1")
    n = (width + 7) // 8
    if plain:
        stream = plain_decode(data, height, n * height, name)
    else:
        stream = image_codecs.msp_decode(data, height, n * height, width, name)
    if len(stream) < n * height:
        raise ValueError(f"{name}: MSP rows of {len(stream)} of the image's {n * height} bytes (PIL: not enough "
                         f"image data)")
    rows = np.frombuffer(stream, np.uint8, n * height).reshape(height, n)
    return Picture(pil_raw.unpack(rows, "1", width, "1"), "1")


def plain_decode(data: bytes, height: int, need: int, name: str) -> bytes:
    """The first `need` bytes (or fewer, all there are) of the stream
    PIL's MspDecoder makes of a version 2 file; raises where it raises."""
    if len(data) < 32 + 2 * height:
        raise ValueError(f"{name}: an MSP row map cut short (PIL: Truncated MSP file in row map)")
    rowmap = struct.unpack_from(f"<{height}H", data, 32)
    blank = b"\xff" * ((struct.unpack_from("<H", data, 4)[0] + 7) // 8)
    out, pos = bytearray(), 32 + 2 * height
    for y, rowlen in enumerate(rowmap):
        if rowlen == 0:
            out += blank
            continue
        row = data[pos:pos + rowlen]
        pos += rowlen
        if len(row) != rowlen:
            raise ValueError(f"{name}: MSP row {y} of {len(row)} of its {rowlen} bytes (PIL: Truncated MSP file)")
        i = 0
        while i < rowlen:
            kind = row[i]
            i += 1
            if kind == 0:
                if rowlen - i < 2:
                    raise ValueError(f"{name}: an MSP run cut short in row {y} (PIL: Corrupted MSP file)")
                out += row[i + 1:i + 2] * row[i]
                i += 2
            else:
                out += row[i:i + kind]
                i += kind
        del out[need:]
    return bytes(out[:need])
