"""PCX and DCX reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the PCX files PIL 12's PcxImagePlugin reads, and of DCX files
(DcxImagePlugin: frame 0 of the offset table, read as a PCX at its
offset), returning an `image_io.Picture`. Every branch of PIL's `_open`:

- 1 bit, 1 plane: mode "1";
- 1 bit, 2 or 4 planes: mode "P" from the header's 16-entry palette
  (PIL's raw modes "P;2L" / "P;4L": bit p of a pixel from plane p);
- version 5, 8 bits, 1 plane: "L", or "P" from the 769-byte palette at the
  end of the file (a 12 then 768 bytes) where that palette is not the grey
  ramp; a file shorter than 769 bytes raises, as PIL's seek does;
- version 5, 8 bits, 3 planes: "RGB" (PIL's "RGB;L", a plane a colour).

Each plane's stride is (width * bits + 7) // 8 made even where the
header's stride differs from it, as PIL computes it. The RLE lines are
decoded by `utils/image_codecs.pcx_rle_decode` (compiled host C++, PIL's
PcxDecode.c: a run across a line's end raises, the planes of a padded
stride moved together as PIL moves them, which for 8-bit planes of width
1 or 3 leaves them where they are).

A header cut short or a box of no pixels raises `image_io.NotThisFormat`
(PIL passes the file on to its next format); any other bit and plane
count raises a `ValueError` naming the file (PIL: unknown PCX mode), as do
data that ends early and an image over PIL's decompression-bomb limit.
"""

from __future__ import annotations

import numpy as np

from gaussian_splatting_torch.utils import image_codecs
from gaussian_splatting_torch.utils.bmp import MAX_PIXELS

DCX_MAGIC = 0x3ADE68B1
SUPPORTED = "the port reads the PCX files PIL reads (PcxImagePlugin)"


def _u16(data: bytes, at: int) -> int:
    return int.from_bytes(data[at:at + 2], "little")


def accepts(head: bytes) -> bool:
    """PIL's `PcxImagePlugin._accept`."""
    return len(head) >= 2 and head[0] == 10 and head[1] in (0, 2, 3, 5)


def dcx_accepts(head: bytes) -> bool:
    """PIL's `DcxImagePlugin._accept`."""
    return len(head) >= 4 and int.from_bytes(head[:4], "little") == DCX_MAGIC


def decode_dcx(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of a DCX file's first frame."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat

    offsets = []
    for i in range(1024):
        entry = data[4 + 4 * i:8 + 4 * i]
        if len(entry) < 4:
            raise NotThisFormat(f"{name}: a DCX offset table cut short")
        offset = int.from_bytes(entry, "little")
        if not offset:
            break
        offsets.append(offset)
    if not offsets:
        raise NotThisFormat(f"{name}: a DCX file of no frames (PIL: attempt to seek outside sequence)")
    return decode_pcx(data, name, offsets[0])


def decode_pcx(data: bytes, name: str = "<bytes>", at: int = 0):
    """The `image_io.Picture` of the PCX image at byte `at` of `data`."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    s = data[at:at + 68]
    if not accepts(s):
        raise NotThisFormat(f"{name}: not a PCX file")
    if len(s) < 12:
        raise NotThisFormat(f"{name}: a PCX header cut short")
    x0, y0, x1, y1 = _u16(s, 4), _u16(s, 6), _u16(s, 8) + 1, _u16(s, 10) + 1
    if x1 <= x0 or y1 <= y0:
        raise NotThisFormat(f"{name}: a PCX box of no pixels (PIL: bad PCX image size)")
    if len(s) < 68:
        raise NotThisFormat(f"{name}: a PCX header cut short")
    version, bits, planes, provided_stride = s[1], s[3], s[65], _u16(s, 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = raw = "1"
    elif bits == 1 and planes in (2, 4):
        mode, raw = "P", f"P;{planes}L"
        palette = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = raw = "L"
        if len(data) < 769:
            raise ValueError(f"{name}: a PCX of 8-bit grey or palette shorter than its 769-byte palette "
                             f"(PIL: Invalid argument, seeking before the file's start); {SUPPORTED}")
        tail = data[-769:]
        if tail[0] == 12 and tail[1:] != bytes(np.arange(256, dtype=np.uint8).repeat(3)):
            mode = raw = "P"
            palette = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
    elif version == 5 and bits == 8 and planes == 3:
        mode, raw = "RGB", "RGB;L"
    else:
        raise ValueError(f"{name}: a PCX of version {version}, {bits} bits and {planes} planes "
                         f"(PIL: unknown PCX mode); {SUPPORTED}")
    width, height = x1 - x0, y1 - y0
    if width * height > MAX_PIXELS:
        raise ValueError(f"{name}: an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    stride = (width * bits + 7) // 8
    if provided_stride != stride:
        stride += stride % 2
    unpack_bits = {"1": 1, "P;2L": 2, "P;4L": 4, "RGB;L": 24}.get(raw, 8)
    lines = image_codecs.pcx_rle_decode(data, at + 128, planes * stride, width, unpack_bits, height, name)
    return Picture(_unpack(lines, raw, width), mode, palette)


def _unpack(lines: np.ndarray, raw: str, width: int) -> np.ndarray:
    """(H, W, C) pixels of PCX lines in PIL's raw mode `raw`."""
    if raw in ("L", "P"):
        return np.ascontiguousarray(lines[:, :width, None])
    if raw == "RGB;L":
        return np.ascontiguousarray(lines[:, :3 * width].reshape(-1, 3, width).transpose(0, 2, 1))
    plane = (width + 7) // 8
    bits = np.unpackbits(lines, axis=1)
    if raw == "1":
        return bits[:, :width, None] != 0
    value = np.zeros((len(lines), width), np.uint8)
    for p in range(int(raw[2])):  # P;2L / P;4L: bit p of a pixel from plane p
        value |= bits[:, 8 * plane * p:8 * plane * p + width] << p
    return value[..., None]
