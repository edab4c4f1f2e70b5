"""GIF reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of frame 0 of a GIF as PIL 12's GifImagePlugin opens and loads it,
returning an `image_io.Picture`:

- GIF87a and GIF89a; the logical screen, grown to hold a frame that
  reaches past it;
- the global palette, or the frame's local one; a palette whose entry i
  is grey i for every entry is no palette (PIL's `_is_palette_needed`):
  mode "L", else "P"; an "L" frame under a global palette keeps it, and
  `to_rgba` converts it as PIL does (through the palette);
- the graphic-control extension's transparency index, kept as PIL's
  `info["transparency"]`, which `to_rgba` applies; comment, application
  and other extensions skipped, as PIL skips them;
- the frame at its offset on a canvas filled with the transparency index,
  else 0 (PIL's `load_prepare` for frame 0);
- the image data by `image_codecs.gif_lzw_decode` (compiled host C++,
  built at first use), rows in order or interlaced.

Where PIL raises (a file cut short in its blocks or its image data, an
LZW code past the table, a frame of no pixels, an image past PIL's
decompression-bomb limit), this raises a `ValueError` naming the file.
"""

from __future__ import annotations

import numpy as np

from gaussian_splatting_torch.utils import image_codecs
from gaussian_splatting_torch.utils.bmp import MAX_PIXELS

SIGNATURES = (b"GIF87a", b"GIF89a")
SUPPORTED = "the port reads the GIF files PIL reads (GifImagePlugin), frame 0"


class _Reader:
    """A file's bytes read as PIL's GIF plugin reads its file: `read`
    gives fewer bytes at the end, `data` one sub-block (None for a
    terminator or the end)."""

    def __init__(self, data: bytes, name: str):
        self.buf, self.pos, self.name = data, 0, name

    def read(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def data(self):
        s = self.read(1)
        return self.read(s[0]) if s and s[0] else None

    def refuse(self, what: str):
        raise ValueError(f"{self.name}: {what}; {SUPPORTED}")


def _is_palette_needed(p: bytes) -> bool:
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2]) for i in range(0, len(p) - len(p) % 3, 3))


def _palette(f: _Reader, bits: int):
    """A palette of 2 << (bits - 1) entries, or False where it is the grey
    ramp PIL drops; a palette cut short raises as PIL's read of it does."""
    p = f.read(3 << bits)
    if len(p) % 3:
        f.refuse("a palette cut short")
    return np.frombuffer(p, np.uint8).reshape(-1, 3) if _is_palette_needed(p) else False


def decode_gif(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of GIF bytes: frame 0, PIL's pixels (with a
    channel axis), mode "P" or "L", palette and transparency."""
    from gaussian_splatting_torch.utils.image_io import Picture

    f = _Reader(data, name)
    s = f.read(13)
    if s[:6] not in SIGNATURES:
        f.refuse("not a GIF file (no GIF87a or GIF89a signature)")
    if len(s) < 13:
        f.refuse("a GIF screen descriptor cut short")
    width, height = int.from_bytes(s[6:8], "little"), int.from_bytes(s[8:10], "little")
    flags = s[10]
    global_palette = None
    if flags & 128:
        p = _palette(f, (flags & 7) + 1)
        if p is not False:
            global_palette = p
    # the blocks before frame 0's image data (GifImageFile._seek(0))
    s = f.read(1)
    if not s or s == b";":
        f.refuse("a GIF file without an image")
    palette, transparency, frame = None, None, None
    while True:
        if not s:
            s = f.read(1)
        if not s or s == b";":
            break
        if s == b"!":
            s = f.read(1)
            if not s:
                f.refuse("a GIF extension cut short")
            block = f.data()
            if s[0] == 249 and block is not None:  # graphic control
                if len(block) < 3 or (block[0] & 1 and len(block) < 4):
                    f.refuse("a GIF graphic-control extension of fewer than 4 bytes")
                if block[0] & 1:
                    transparency = block[3]
            elif s[0] == 254:  # comment: every sub-block is read here
                while block:
                    block = f.data()
                s = None
                continue
            elif s[0] == 255 and block is not None and block.startswith(b"NETSCAPE2.0"):
                f.data()
            while f.data():
                pass
        elif s == b",":
            d = f.read(9)
            if len(d) < 9:
                f.refuse("a GIF image descriptor cut short")
            x0, y0 = int.from_bytes(d[0:2], "little"), int.from_bytes(d[2:4], "little")
            x1, y1 = x0 + int.from_bytes(d[4:6], "little"), y0 + int.from_bytes(d[6:8], "little")
            width, height = max(x1, width), max(y1, height)
            if width * height > MAX_PIXELS:
                f.refuse(f"an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
            interlace = bool(d[8] & 64)
            if d[8] & 128:
                palette = _palette(f, (d[8] & 7) + 1)
            bits = f.read(1)
            if not bits:
                f.refuse("a GIF frame without its LZW minimum code size")
            frame = (x0, y0, x1, y1, interlace, bits[0])
            break
        s = None
    if frame is None:
        f.refuse("a GIF file without an image")
    if width <= 0 or height <= 0:
        f.refuse(f"a GIF image of {width}x{height} pixels")
    colours = palette if palette is not None else global_palette
    mode = "L" if colours is None or colours is False else "P"
    canvas = np.full((height, width), 0 if transparency is None else transparency, np.uint8)
    x0, y0, x1, y1, interlace, bits = frame
    if x0 == 0 and x1 == 0:  # PIL's setimage reads such a tile as the whole image
        x1, y1, y0 = width, height, 0
    if x1 <= x0 or y1 <= y0:
        f.refuse(f"a GIF frame of {x1 - x0}x{y1 - y0} pixels (PIL: tile cannot extend outside image)")
    image_codecs.gif_lzw_decode(data[f.pos:], bits, interlace, canvas[y0:y1, x0:x1], name)
    # an "L" frame keeps the global palette, which PIL's convert applies
    return Picture(canvas[..., None], mode, colours if mode == "P" else global_palette, transparency)


def open_gif(path):
    """The `image_io.Picture` of a GIF file."""
    with open(path, "rb") as f:
        return decode_gif(f.read(), str(path))
