"""WMF and EMF: opened by PIL 12's WmfImagePlugin, which cannot load them.

Where no WMF handler is installed (PIL installs one only on Windows), PIL
opens a placeable metafile (D7 CD C6 9A 00 00: its bounding box in units
of the header's units per inch, scaled to 72 dots per inch) or an enhanced
metafile (01 00 00 00 and ` EMF` at byte 40: its bounding box) as an
"RGB" stub, and its load raises (cannot find loader for this WMF file).
The port raises where PIL raises, naming the format. `_open`'s own
raises are kept: a placeable header of 0 units per inch raises (PIL:
Invalid inch, a ValueError), as does an EMF whose frame has no width or
height (PIL: ZeroDivisionError); a header cut short, a placeable file
without the standard metafile header, an 01 00 00 00 file without ` EMF`
or a size of 0 or less raises `image_io.NotThisFormat` (PIL passes the
file on).
"""

from __future__ import annotations

import struct

PLACEABLE = b"\xd7\xcd\xc6\x9a\x00\x00"
EMF = b"\x01\x00\x00\x00"


def accepts(head: bytes) -> bool:
    return head.startswith((PLACEABLE, EMF))


def decode_wmf(data: bytes, name: str = "<bytes>"):
    """Raise as PIL does on WMF / EMF bytes."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat

    s = data[:44]
    try:
        if s.startswith(PLACEABLE):
            fmt = "WMF"
            inch = struct.unpack_from("<H", s, 14)[0]
            if inch == 0:
                raise ValueError(f"{name}: a placeable WMF of 0 units per inch (PIL: Invalid inch)")
            x0, y0, x1, y1 = struct.unpack_from("<4h", s, 6)
            size = ((x1 - x0) * 72 // inch, (y1 - y0) * 72 // inch)
            if s[22:26] != b"\x01\x00\t\x00":
                raise NotThisFormat(f"{name}: a placeable WMF without the standard metafile header (PIL: "
                                    f"Unsupported WMF file format, passed on)")
        elif s.startswith(EMF) and s[40:44] == b" EMF":
            fmt = "EMF"
            x0, y0, x1, y1, f0, f1, f2, f3 = struct.unpack_from("<8i", s, 8)
            if f2 == f0 or f3 == f1:
                raise ValueError(f"{name}: an EMF frame of no width or height (PIL: ZeroDivisionError)")
            size = (x1 - x0, y1 - y0)
        else:
            raise NotThisFormat(f"{name}: not a WMF or EMF file (PIL: Unsupported file format, passed on)")
    except struct.error:
        raise NotThisFormat(f"{name}: a WMF header cut short (PIL: struct.error, passed on)") from None
    if size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat(f"{name}: a {fmt} file of {size[0]}x{size[1]} pixels (PIL: an empty size, passed on)")
    if size[0] * size[1] > 2 * 89478485:
        raise ValueError(f"{name}: an image of more than {2 * 89478485} pixels (PIL's decompression bomb limit)")
    raise ValueError(f"{name}: a {fmt} file of {size[0]}x{size[1]}, which PIL opens as a stub and cannot load (PIL: "
                     f"cannot find loader for this WMF file): it has no WMF handler off Windows")
