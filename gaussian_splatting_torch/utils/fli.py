"""FLI / FLC reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the Autodesk animation files PIL 12's FliImagePlugin reads,
returning an `image_io.Picture` of frame 0 in mode "P" with its palette:

- `_open`'s checks: magic 0xAF11 (FLI) or 0xAF12 (FLC), flags 0 or 3, and
  zeros at bytes 20-22, 42-80 and 88-128.
- The palette: a grey ramp, set from the first COLOR_256 (4) or COLOR_64
  (11, each value shifted left by 2) subchunk of the chunk at byte 128, or
  of the chunk after a 0xF100 prefix chunk there; each packet skips
  entries and sets a count of them (0: 256).
- Frame 0 is decoded from byte 128, where PIL starts it whether or not a
  prefix chunk is there (a prefix chunk then fails as data PIL does not
  recognise), by PIL's load loop (reads of the frame's size, the decoder
  called on all that is not yet consumed) around PIL's C FliDecode:
  `image_codecs.fli_decode` (`csrc/image_codecs.cc`), or `plain_decode` here (the
  same rules in Python, for the tests), into a zero image.

The COLMAP path refuses "P" by name (`scene/dataset_readers._NOT_THE_PICTURE`);
the Blender path's `image_io.to_rgba` applies the palette.

A header that fails PIL's checks, a palette or first chunk cut short, a
palette index past 255, a frame count of 0, a file that ends before
frame 0's size or a size of 0 raises `image_io.NotThisFormat` (PIL passes the file on); a frame
that PIL's decoder fails on, a frame cut short and an image over PIL's
decompression-bomb limit raise a `ValueError` naming the file.
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatting_torch.utils import image_codecs
from gaussian_splatting_torch.utils.bmp import MAX_PIXELS

MAGICS = (0xAF11, 0xAF12)
# PIL's messages for its decoders' error codes
ERRORS = {-1: "buffer overrun", -2: "broken data stream", -3: "unrecognized data stream contents"}


def _i16(b: bytes, at: int = 0) -> int:
    return struct.unpack_from("<H", b, at)[0]


def _i32(b: bytes, at: int = 0) -> int:
    return struct.unpack_from("<I", b, at)[0]


def accepts(head: bytes) -> bool:
    """FliImagePlugin._accept: 16 bytes or more, magic 0xAF11 or 0xAF12,
    flags 0 or 3."""
    return len(head) >= 16 and _i16(head, 4) in MAGICS and _i16(head, 14) in (0, 3)


def decode_fli(data: bytes, name: str = "<bytes>", plain: bool = False):
    """The `image_io.Picture` of FLI / FLC bytes: frame 0, mode "P"; the
    frame's decoder compiled, or with `plain` Python (`plain_decode`)."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    s = data[:128]
    if not (accepts(s) and s[20:22] == bytes(2) and s[42:80] == bytes(38) and s[88:] == bytes(40)):
        raise NotThisFormat(f"{name}: not an FLI / FLC file (PIL: not an FLI/FLC file, passed on)")
    width, height = _i16(s, 8), _i16(s, 10)
    try:
        palette = _palette(data, name)
        if _i16(s, 6) == 0:  # seek(0) past n_frames: PIL's EOFError
            raise EOFError
        if len(data) <= 128:
            raise EOFError
        _i32(data[128:132])  # the frame's size: PIL's EOFError or struct.error
    except (struct.error, IndexError, EOFError):
        raise NotThisFormat(f"{name}: an FLI header or first chunk cut short (PIL: passed on)") from None
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: an FLI image of {width}x{height} pixels (PIL: an empty size, passed on)")
    if width * height > MAX_PIXELS:
        raise ValueError(f"{name}: an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    return Picture(_frame0(data, width, height, name, plain)[..., None], "P", palette)


def _palette(data: bytes, name) -> np.ndarray:
    """(256, 3) uint8: PIL's `_open` palette walk."""
    palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    pos = 128
    s = data[pos:pos + 16]
    pos += len(s)
    if _i16(s, 4) == 0xF100:  # a prefix chunk
        pos = 128 + _i32(s)
        s = data[pos:pos + 16]
        pos += len(s)
    if _i16(s, 4) == 0xF1FA:
        chunk_size = None
        for _ in range(_i16(s, 6)):
            if chunk_size is not None:
                pos = max(pos + chunk_size - 6, 0)
            s = data[pos:pos + 6]
            pos += len(s)
            kind = _i16(s, 4)
            if kind in (4, 11):
                _set_palette(data, pos, palette, 2 if kind == 11 else 0)
                break
            chunk_size = _i32(s)
            if not chunk_size:
                break
    return palette


def _set_palette(data: bytes, pos: int, palette: np.ndarray, shift: int) -> None:
    """FliImageFile._palette: packets of (skip, count, count RGB triples)
    from `pos`; an entry past 255 or a triple cut short is PIL's IndexError."""
    i = 0
    packets = _i16(data[pos:pos + 2])
    pos += 2
    for _ in range(packets):
        s = data[pos:pos + 2]
        pos += len(s)
        i += s[0]
        n = s[1] or 256
        s = data[pos:pos + 3 * n]
        pos += len(s)
        for k in range(0, len(s), 3):
            if i > 255:
                raise IndexError
            palette[i] = [(s[k] << shift) & 0xFF, (s[k + 1] << shift) & 0xFF, (s[k + 2] << shift) & 0xFF]
            i += 1


def _frame0(data: bytes, width: int, height: int, name, plain: bool) -> np.ndarray:
    """ImageFile.load of frame 0's tile: reads of the frame's size from
    byte 128, each added to what the decoder has not consumed, the decoder
    called after each; a read that gives nothing is PIL's truncation."""
    im = np.zeros((height, width), np.uint8)
    framesize, pos, buf = _i32(data, 128), 128, b""
    decode = plain_decode if plain else lambda b, frame: image_codecs.fli_decode(b, frame, name)
    while True:
        s = data[pos:pos + framesize]
        pos += len(s)
        if not s:
            raise ValueError(f"{name}: an FLI frame cut short (PIL: image file is truncated)")
        buf += s
        n, err = decode(buf, im)
        if n < 0:
            break
        buf = buf[n:]
    if err < 0:
        raise ValueError(f"{name}: FLI frame 0: {ERRORS[err]} (PIL: {ERRORS[err]} when reading image file)")
    return im


def plain_decode(buf: bytes, im: np.ndarray):
    """PIL's FliDecode on `buf` into `im` (H, W) uint8: (consumed, 0) where
    it wants more, (-1, error code) where it ends (0 done, -1 overrun, -2
    broken, -3 unknown data)."""
    ysize, xsize = im.shape
    flat = im.reshape(-1)
    nbytes = len(buf)
    if nbytes < 4:
        return 0, 0
    framesize = struct.unpack_from("<I", buf, 0)[0]  # compared unsigned, as PIL's build does
    if nbytes + nbytes % 2 < framesize:
        return 0, 0
    if nbytes < 8:
        return -1, -1
    if _i16(buf, 4) != 0xF1FA:
        return -1, -3
    chunks, ptr, left = _i16(buf, 6), 16, nbytes - 16
    for _ in range(chunks):
        if left < 10:
            return -1, -1
        d = ptr + 6
        end = ptr + left

        def oob(k):
            return d + k > end

        kind = _i16(buf, ptr + 4)
        if kind == 7:  # SS2
            lines = _i16(buf, d)
            d += 2
            y = line = 0
            while line < lines and y < ysize:
                row = y * xsize
                if oob(2):
                    return -1, -1
                packets = _i16(buf, d)
                d += 2
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets
                        if y >= ysize:
                            return -1, -1
                        row = y * xsize
                    else:
                        flat[row + xsize - 1] = packets & 0xFF
                    if oob(2):
                        return -1, -1
                    packets = _i16(buf, d)
                    d += 2
                p = x = 0
                while p < packets:
                    if oob(2):
                        return -1, -1
                    x += buf[d]
                    if buf[d + 1] >= 128:
                        if oob(4):
                            return -1, -1
                        i = 256 - buf[d + 1]
                        if x + 2 * i > xsize:
                            break
                        flat[row + x:row + x + 2 * i] = np.tile(np.frombuffer(buf, np.uint8, 2, d + 2), i)
                        x += 2 * i
                        d += 4
                    else:
                        i = 2 * buf[d + 1]
                        if x + i > xsize:
                            break
                        if oob(2 + i):
                            return -1, -1
                        flat[row + x:row + x + i] = np.frombuffer(buf, np.uint8, i, d + 2)
                        d += 2 + i
                        x += i
                    p += 1
                if p < packets:
                    break
                line += 1
                y += 1
            if line < lines:
                return -1, -1
        elif kind == 12:  # LC
            y = _i16(buf, d)
            ymax = y + _i16(buf, d + 2)
            d += 4
            while y < ymax and y < ysize:
                row = y * xsize
                if oob(1):
                    return -1, -1
                packets = buf[d]
                d += 1
                p = x = i = 0
                while p < packets:
                    if oob(2):
                        return -1, -1
                    x += buf[d]
                    if buf[d + 1] & 0x80:
                        i = 256 - buf[d + 1]
                        if x + i > xsize:
                            break
                        if oob(3):
                            return -1, -1
                        flat[row + x:row + x + i] = buf[d + 2]
                        d += 3
                    else:
                        i = buf[d + 1]
                        if x + i > xsize:
                            break
                        if oob(2 + i):
                            return -1, -1
                        flat[row + x:row + x + i] = np.frombuffer(buf, np.uint8, i, d + 2)
                        d += i + 2
                    p += 1
                    x += i
                if p < packets:
                    break
                y += 1
            if y < ymax:
                return -1, -1
        elif kind == 13:  # BLACK
            flat[:] = 0
        elif kind == 15:  # BRUN
            for y in range(ysize):
                row = y * xsize
                d += 1
                x = 0
                while x < xsize:
                    if oob(2):
                        return -1, -1
                    if buf[d] & 0x80:
                        i = 256 - buf[d]
                        if x + i > xsize:
                            break
                        if oob(i + 1):
                            return -1, -1
                        flat[row + x:row + x + i] = np.frombuffer(buf, np.uint8, i, d + 1)
                        d += i + 1
                    else:
                        i = buf[d]
                        if x + i > xsize:
                            break
                        flat[row + x:row + x + i] = buf[d + 1]
                        d += 2
                    x += i
                if x != xsize:
                    return -1, -1
        elif kind == 16:  # COPY
            if 2147483647 // xsize < ysize:
                return -1, -1
            if d + xsize * ysize > end:
                return ptr, 0
            flat[:] = np.frombuffer(buf, np.uint8, xsize * ysize, d)
        elif kind not in (4, 11, 18):
            return -1, -3
        advance = struct.unpack_from("<i", buf, ptr)[0]
        if advance == 0:
            return -1, -2
        if advance < 0 or advance > left:
            return -1, -1
        ptr += advance
        left -= advance
    return -1, 0
