"""IFUNC Image Memory (IM) reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the IM files PIL 12's ImImagePlugin reads, returning an
`image_io.Picture` of frame 0:

- The header: lines of `Key: value` (a `\\r` before a line skipped, a line
  of over 100 bytes or that the pattern does not match passing the file
  on), up to a NUL or 0x1A; "Image size (x*y)", "File size (no of
  images)" and "Scale (x,y)" read as numbers, "Image type" through PIL's
  `OPEN` table to a mode and raw mode ("PA image" to mode "LA" and raw
  mode "PA;L", which PIL cannot load). Defaults: "L", 512x512.
- The data after the 0x1A that ends the header, and after a "Lut"'s 768
  bytes (its red, green and blue runs): a colour LUT turns "L" or "P"
  into "P" and "LA" or "PA" into "PA" with that palette; a grey one
  leaves the mode and the pixels as they are, as does any LUT on "RGB".
- The pixels bottom-up: raw (`pil_raw`; "L", "P" and "I;16*" mapped as
  PIL maps them), "RGB3" / "RYB3" as three planes into green, red and
  blue, and "L*n" floats of n bits other than 8, 16 and 32 through PIL's C
  bit decoder (`image_codecs.im_bit_decode`, `csrc/image_codecs.cc`;
  `plain_bits` here is the same in Python, for the tests).

PIL tests no first bytes: it tries this reader on every file that reaches
it in its order. No line feed in the first 100 bytes, a header PIL's
parse rejects, a header of no known key, a size that is one number, an
empty mode or size, no 0x1A and a LUT cut short raise
`image_io.NotThisFormat` (PIL passes the file on); a value that is not a
number (PIL: ValueError), a size of other than two numbers or not of
integers, a mode PIL does not know or cannot load, pixel data cut short
and an image over PIL's decompression-bomb limit raise a `ValueError`
naming the file.
"""

from __future__ import annotations

import re

import numpy as np

from gaussian_splatting_torch.utils import image_codecs, pil_raw

COMMENT, FRAMES, LUT, SCALE, SIZE, MODE = ("Comment", "File size (no of images)", "Lut", "Scale (x,y)",
                                           "Image size (x*y)", "Image type")
TAGS = (COMMENT, "Date", "Digitalization equipment", FRAMES, LUT, "Name", SCALE, SIZE, MODE)
# ImImagePlugin.OPEN: image type -> (mode, raw mode)
OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"), "RYB image": ("RGB", "RLB"),
    "B1 image": ("1", "1"), "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"),
    "L 32 S image": ("I", "I;32"), "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
    "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")
SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")


def passes_on(head: bytes):
    """Why PIL's reader passes on a file whose first 100 bytes are
    `head`, or None."""
    return None if b"\n" in head[:100] else "no line feed in the first 100 bytes"


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def decode_im(data: bytes, name: str = "<bytes>", plain: bool = False):
    """The `image_io.Picture` of IM bytes: frame 0; "L*n" floats' bits
    compiled, or with `plain` Python (`plain_bits`)."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    def passed(why):
        raise NotThisFormat(f"{name}: {why} (PIL: not an IM file, passed on)")

    why = passes_on(data)
    if why:
        passed(why)
    info = {MODE: "L", SIZE: (512, 512), FRAMES: 1}
    rawmode, n, pos = "L", 0, 0
    while True:
        s = data[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s, pos = s + data[pos:end], end
        if len(s) > 100:
            passed("a header line of more than 100 bytes")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = SPLIT.match(s)
        if not m:
            passed(f"a header line {s[:40]!r} (Syntax error in IM header)")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in (FRAMES, SCALE, SIZE):
            try:
                v = tuple(map(_number, v.replace("*", ",").split(",")))
            except ValueError:
                raise ValueError(f"{name}: an IM {k} of {v!r} (PIL: could not convert string to float)") from None
            if len(v) == 1:
                v = v[0]
        elif k == MODE and v in OPEN:
            v, rawmode = OPEN[v]
        info[k] = v
        n += k in TAGS
    if not n:
        passed("no known key in the header")
    size, mode = info[SIZE], info[MODE]
    while s and not s.startswith(b"\x1a"):
        s = data[pos:pos + 1]
        pos += len(s)
    if not s:
        passed("no 0x1A after the header (File truncated)")
    palette = None
    if LUT in info:
        lut = data[pos:pos + 768]
        pos += len(lut)
        if len(lut) < 768:
            passed(f"a LUT of {len(lut)} of its 768 bytes (IndexError)")
        planes = np.frombuffer(lut, np.uint8).reshape(3, 256)
        grey = (planes[0] == planes[1]).all() and (planes[1] == planes[2]).all()
        if mode in ("L", "LA", "P", "PA") and not grey:
            mode, rawmode = ("P", "P") if mode in ("L", "P") else ("PA", "PA;L")
            palette = planes.T.copy()
    if not isinstance(size, tuple):
        passed(f"an image size of {size!r} (TypeError)")
    if not mode or size[0] <= 0 or size[1] <= 0:
        passed(f"an IM image of mode {mode!r} and size {size} (an empty mode or size)")
    if max(1, size[0]) * max(1, size[1]) > pil_raw.MAX_PIXELS:
        raise ValueError(f"{name}: an image of more than {pil_raw.MAX_PIXELS} pixels (PIL's decompression bomb "
                         f"limit)")
    if len(size) != 2 or not all(isinstance(d, int) for d in size):
        raise ValueError(f"{name}: an IM image size of {size} (PIL: the core takes two integers)")
    width, height = size
    if mode not in pil_raw.BANDS:
        raise ValueError(f"{name}: an IM image of mode {mode!r} (PIL: unrecognized image mode)")
    bits = _bits_of(rawmode)
    if bits is not None:
        if mode != "F":
            raise ValueError(f"{name}: raw mode {rawmode!r} for an image of mode {mode} (PIL: unknown raw mode "
                             f"for given image mode)")
        need = height * ((width * bits + 7) // 8)
        if len(data) - pos < need:
            raise ValueError(f"{name}: IM image data of {max(len(data) - pos, 0)} of its {need} bytes (PIL: image "
                             f"file is truncated)")
        px = (plain_bits(data[pos:pos + need], bits, width, height) if plain
              else image_codecs.im_bit_decode(data[pos:pos + need], bits, width, height, name))
        return Picture(px[..., None], "F")
    if rawmode in ("RGB;T", "RYB;T"):
        px = pil_raw.new(mode, width, height)
        for band, plane in zip("GRB", range(3)):
            pil_raw.decode_tile(data, pos + plane * width * height, width, height, mode, band, 0, -1, name, px)
    else:
        px = pil_raw.raw_tile(data, pos, width, height, mode, rawmode, name, 0, -1)
    if mode == "P" and palette is None:
        palette = np.zeros((0, 3), np.uint8)  # no LUT: PIL's core palette of no entries, every colour black
    return Picture(px, mode, palette)


def _bits_of(rawmode: str):
    """The bits a sample of a raw mode PIL reads with its bit decoder
    ("F;n", n not 8, 16 or 32), or None."""
    if rawmode.startswith("F;"):
        try:
            bits = int(rawmode[2:])
        except ValueError:
            return None
        return None if bits in (8, 16, 32) else bits
    return None


def plain_bits(data: bytes, bits: int, width: int, height: int) -> np.ndarray:
    """(height, width) float32: PIL's Bit.c with IM's arguments (bits, pad
    8, fill 3, no sign, bottom-up) on `data`, which holds every row: each
    byte put above the bits held (a new row sets the count to 0 and keeps
    the bits), each sample the low `bits`."""
    out = np.zeros((height, width), np.float32)
    mask = (1 << bits) - 1
    x, y, buf, count = 0, height - 1, 0, 0
    for byte in data:
        buf = (buf | byte << count) & 0xFFFFFFFFFFFFFFFF
        count += 8
        while count >= bits:
            value = buf & mask
            if count > 32:
                buf = byte >> (8 - (count - bits))
            else:
                buf >>= bits
            count -= bits
            out[y, x] = value
            x += 1
            if x >= width:
                y -= 1
                if y < 0:
                    return out
                x, count = 0, 0
    return out
