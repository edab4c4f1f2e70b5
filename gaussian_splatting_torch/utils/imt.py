"""IM Tools reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the IM Tools files PIL 12's ImtImagePlugin reads, returning an
`image_io.Picture` in mode "L": text lines of `key value` (`width`,
`height`, `pixel n8`; lines starting `*` are comments) up to a form feed
(0x0C), then the pixels raw. PIL tests no first bytes: it tries this
reader on every file that reaches it in its order, so each rule that
passes a file on is PIL's own (`_open`'s buffer of 100-byte reads, kept
here byte for byte).

No line feed in the first 100 bytes, or a header that leaves no mode or
an empty size, raises `image_io.NotThisFormat` (PIL passes the file on);
a width or height that is not a number (PIL: ValueError), a header that
ends without a form feed (PIL: cannot load this image), pixel data cut
short and an image over PIL's decompression-bomb limit raise a
`ValueError` naming the file.
"""

from __future__ import annotations

import re

from gaussian_splatting_torch.utils import pil_raw

FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def passes_on(head: bytes):
    """Why PIL's reader passes on a file whose first 100 bytes are
    `head`, or None."""
    return None if b"\n" in head[:100] else "no line feed in the first 100 bytes"


def decode_imt(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of IM Tools bytes."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    why = passes_on(data)
    if why:
        raise NotThisFormat(f"{name}: {why} (PIL: not an IM Tools file, passed on)")
    buffer = data[:100]
    pos = len(buffer)  # the file position of PIL's reads
    width = height = 0
    mode, offset = "", None

    def read(n):
        nonlocal pos
        out = data[pos:pos + n]
        pos += len(out)
        return out

    def number(v):
        try:
            return int(v)
        except ValueError:
            raise ValueError(f"{name}: an IM Tools size of {v!r} (PIL: invalid literal for int())") from None

    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = read(1)
        if not s:
            break
        if s == b"\x0c":
            offset = pos - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord("*"):
            continue
        m = FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            width = number(v)
        elif k == b"height":
            height = number(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: an IM Tools header of mode {mode!r} and size {width}x{height} (PIL: not "
                            f"identified, passed on)")
    pil_raw.check_size(width, height, name)
    if offset is None:
        raise ValueError(f"{name}: an IM Tools header without a form feed (PIL: cannot load this image)")
    return Picture(pil_raw.raw_tile(data, offset, width, height, "L", "L", name), "L")
