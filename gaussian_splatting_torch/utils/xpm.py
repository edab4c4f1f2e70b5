"""X11 pixmap reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the XPM files PIL 12's XpmImagePlugin reads, returning an
`image_io.Picture`: `/* XPM */`, the lines up to the first that starts
`"w h colours chars`, one line a colour, of which PIL reads the first
`c` key (`#rrggbb` hex, or `None`, which sets the transparency to the
pixel key and adds no colour), then the pixel rows through PIL's Python
`XpmDecoder`: every line's text between its first and last quote, cut
into keys of `chars` bytes, a first `/* pixels */` line skipped, until
the image's bytes are there. Up to 256 colours read "P" (a key's index
among the colours, the palette their values), more read "RGB" (a key's
colour).

A file that ends before the header line or a colour line whose `c` key
has no value raises `image_io.NotThisFormat` (PIL passes the file on); a
size, count or key width that is not a number, a colour of no `c` key or
of another spec, a key width of 0, a pixel key not among the colours, a
stream shorter than the image, data cut short and an image over PIL's
decompression-bomb limit raise a `ValueError` naming the file; so does an
"RGB" image's `to_rgba` where a colour is `None` (PIL: TypeError).
"""

from __future__ import annotations

import re

import numpy as np

from gaussian_splatting_torch.utils import pil_raw

SIGNATURE = b"/* XPM */"
XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def accepts(head: bytes) -> bool:
    return head.startswith(SIGNATURE)


class _Lines:
    """PIL's fp.readline over the file's bytes."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def readline(self) -> bytes:
        end = self.data.find(b"\n", self.pos)
        end = len(self.data) if end < 0 else end + 1
        line, self.pos = self.data[self.pos:end], end
        return line


def decode_xpm(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of XPM bytes."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    def refuse(what):
        raise ValueError(f"{name}: {what}; the port reads the XPM files PIL reads (XpmImagePlugin)")

    fp = _Lines(data, 9)
    while True:
        line = fp.readline()
        if not line:
            raise NotThisFormat(f"{name}: an XPM file without a header line (PIL: broken XPM file, passed on)")
        m = XPM_HEAD.match(line)
        if m:
            break
    try:
        width, height, count, bpp = (int(g) for g in m.groups())
    except ValueError:
        refuse(f"an XPM header line {line[:40]!r} (PIL: ValueError)")
    palette, transparency = {}, None
    for _ in range(count):
        line = fp.readline().rstrip()
        c = line[1:bpp + 1]
        s = line[bpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                if i + 1 >= len(s):
                    raise NotThisFormat(f"{name}: an XPM colour key without a value (PIL: IndexError, passed on)")
                rgb = s[i + 1]
                if rgb == b"None":
                    transparency = c
                elif rgb.startswith(b"#"):
                    try:
                        v = int(rgb[1:], 16)
                    except ValueError:
                        refuse(f"an XPM colour {rgb!r} (PIL: ValueError)")
                    palette[c] = bytes(((v >> 16) & 255, (v >> 8) & 255, v & 255))
                else:
                    refuse(f"an XPM colour {rgb!r} (PIL: cannot read this XPM file)")
                break
        else:
            refuse(f"an XPM colour line {line[:40]!r} without a c key (PIL: cannot read this XPM file)")
    mode = "RGB" if count > 256 else "P"
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: an XPM image of {width}x{height} pixels (PIL: an empty size, passed on)")
    pil_raw.check_size(width, height, name)
    index = {key: (i,) for i, key in enumerate(palette)} if mode == "P" else {k: tuple(v) for k, v in palette.items()}
    need = width * height * (3 if mode == "RGB" else 1)
    chunks, got, pixel_header = [], 0, False
    while got < need:
        line = fp.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not pixel_header:
            pixel_header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        if bpp == 0:
            refuse("an XPM key width of 0 (PIL: range() arg 3 must not be zero)")
        values = _lookup(line, bpp, index, name)
        chunks.append(values)
        got += values.size
    out = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
    if len(out) < need:
        refuse(f"XPM rows of {len(out)} of the image's {need} bytes (PIL: not enough image data)")
    px = out[:need].reshape(height, width, -1)
    if mode == "P":
        pal = np.frombuffer(b"".join(palette.values()), np.uint8).reshape(-1, 3)
        return Picture(px, "P", pal.copy(), transparency)
    return Picture(px, "RGB", None, transparency)


def _lookup(line: bytes, bpp: int, index: dict, name) -> np.ndarray:
    """The bytes PIL's XpmDecoder adds for one line's keys: each key's
    palette index ("P") or colour ("RGB"), the keys looked up once each;
    a key not among the colours raises."""
    full = len(line) // bpp
    keys = np.frombuffer(line, np.uint8, full * bpp).reshape(full, bpp)
    found, inverse = np.unique(keys.view(np.dtype((np.void, bpp)))[:, 0], return_inverse=True)
    table = []
    for key in [k.tobytes() for k in found] + ([line[full * bpp:]] if len(line) % bpp else []):
        if key not in index:
            raise ValueError(f"{name}: an XPM pixel key {key!r} not among the colours (PIL: KeyError or "
                             f"ValueError); the port reads the XPM files PIL reads (XpmImagePlugin)")
        table.append(index[key])
    width = len(next(iter(index.values()))) if index else 1
    values = np.array(table, np.uint8).reshape(-1, width)
    out = values[inverse.ravel()].ravel()
    return np.concatenate([out, values[-1]]) if len(line) % bpp else out
