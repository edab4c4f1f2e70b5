"""IPTC/NAA reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the IPTC/NAA files PIL 12's IptcImagePlugin reads, returning an
`image_io.Picture`: fields of 0x1C, a record and a dataset number, and a
length (two bytes, or 1-4 bytes after a first byte over 128), up to the
first image data field (8, 10). The image's layers and component flag are
field (3, 60), its width and height (3, 20) and (3, 30), its compression
(3, 120): 1 raw, 5 JPEG. The data of every (8, 10) field in a row, with a
`P5` header before raw data, is opened again through the whole order of
readers (`image_io.open_image`), as PIL's load opens it. One layer
without the component flag is "L"; three or four with it are "RGB" or
"CMYK" of one band, the one field (3, 65) names (default the first; 0
the last, as PIL's index -1), the others 0, as PIL's `Image.merge` of
blank "L" bands and the data.

PIL tests no first bytes: it tries this reader on every file that reaches
it in its order. A first byte other than 0x1C, a record PIL does not
know, a field cut short, a missing (3, 60), (3, 20) or (3, 30) field or an
empty mode or size raises `image_io.NotThisFormat` (PIL passes the file
on); a field length over 132 or an unknown or missing compression (PIL:
OSError), no image data field (PIL: cannot load this image), a band past
the mode's, data that is not "L" where PIL merges bands (PIL: ValueError)
and an image the nested open refuses raise a `ValueError` naming the
file. Data whose image is not "L" at the header's size where PIL keeps
it as it is: PIL's array then reads the other image's memory as the
header's "L" (and past its rows), which the port refuses, naming it.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)
COMPRESSION = {1: "raw", 5: "jpeg"}


def _i(c: bytes) -> int:
    return int.from_bytes((b"\0\0\0\0" + c)[-4:], "big")


def passes_on(head: bytes):
    """Why PIL's reader passes on a file whose first 5 bytes are `head`
    on its first field alone, or None."""
    s = head[:5]
    if not s.strip(b"\0"):
        return "no IPTC field (KeyError: (3, 60))"
    if len(s) < 3 or s[0] != 0x1C or s[1] not in RECORDS:
        return "not an IPTC field"
    return None


class _Fields:
    def __init__(self, data: bytes, name: str, passed):
        self.data, self.pos, self.name, self.passed = data, 0, name, passed

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + max(n, 0)]
        self.pos += len(out)
        return out

    def field(self):
        """IptcImageFile.field: (tag, size), or (None, 0) at the end."""
        s = self.read(5)
        if not s.strip(b"\0"):
            return None, 0
        if len(s) < 3 or s[0] != 0x1C or s[1] not in RECORDS:
            self.passed("not an IPTC field (invalid IPTC/NAA file)")
        if len(s) < 4:
            self.passed("an IPTC field cut short (IndexError)")
        size = s[3]
        if size > 132:
            raise ValueError(f"{self.name}: an IPTC field length of {size} (PIL: illegal field length in IPTC/NAA "
                             f"file)")
        if size == 128:
            size = 0
        elif size > 128:
            size = _i(self.read(size - 128))
        else:
            if len(s) < 5:
                self.passed("an IPTC field cut short (struct.error)")
            size = s[3] << 8 | s[4]
        return (s[1], s[2]), size


def decode_iptc(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of IPTC/NAA bytes."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    def passed(why):
        raise NotThisFormat(f"{name}: {why} (PIL: passed on)")

    fields = _Fields(data, name, passed)
    info = {}
    while True:
        offset = fields.pos
        tag, size = fields.field()
        if not tag or tag == (8, 10):
            break
        value = fields.read(size) if size else None
        if tag in info:
            info[tag] = (info[tag] + [value]) if isinstance(info[tag], list) else [info[tag], value]
        else:
            info[tag] = value
    try:
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
        mode, band = "", None
        if layers == 1 and not component:
            mode = "L"
        else:
            if layers == 3 and component:
                mode = "RGB"
            elif layers == 4 and component:
                mode = "CMYK"
            band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
        width, height = _i(info[(3, 20)]), _i(info[(3, 30)])
    except (KeyError, IndexError, TypeError) as err:
        passed(f"IPTC image fields that PIL cannot read ({type(err).__name__})")
    try:
        compression = COMPRESSION[_i(info[(3, 120)])]
    except TypeError:
        passed("an IPTC compression field that PIL cannot read (TypeError)")
    except KeyError:
        raise ValueError(f"{name}: an unknown or missing IPTC compression (PIL: Unknown IPTC image "
                         f"compression)") from None
    if not mode or width <= 0 or height <= 0:
        passed(f"an IPTC image of mode {mode!r} and size {width}x{height} (an empty mode or size)")
    if width * height > 2 * 89478485:
        raise ValueError(f"{name}: an image of more than {2 * 89478485} pixels (PIL's decompression bomb limit)")
    if tag != (8, 10):
        raise ValueError(f"{name}: an IPTC file without image data (PIL: cannot load this image)")
    fields.pos = offset

    def fault(why):  # a field PIL's load cannot read: an error there ends the open
        raise ValueError(f"{name}: {why} in the IPTC image data (PIL: raised in its load)")

    fields.passed = fault
    body = [b"P5\n%d %d\n255\n" % (width, height)] if compression == "raw" else []
    while True:
        kind, size = fields.field()
        if kind != (8, 10):
            break
        body.append(fields.read(size))
    inner = _open_nested(b"".join(body), name)
    n_bands = {"L": 1, "RGB": 3, "CMYK": 4}[mode]
    if band is not None and not -n_bands <= band < n_bands:
        raise ValueError(f"{name}: IPTC band {band + 1} of a {mode} image (PIL: list assignment index out of range)")
    if band is not None and inner.mode != "L":
        raise ValueError(f"{name}: IPTC data of mode {inner.mode} for one band of a {mode} image (PIL: image has "
                         f"wrong mode)")
    if inner.mode != "L" or inner.pixels.shape[:2] != (height, width):
        raise ValueError(f"{name}: IPTC data of mode {inner.mode}, {inner.pixels.shape[1]}x{inner.pixels.shape[0]}, "
                         f"for a {mode} image of {width}x{height}: PIL's array reads that image's memory as the "
                         f"header's; the port reads the IPTC images whose data is the header's L image")
    if band is None:
        return Picture(inner.pixels, "L")
    px = np.zeros((height, width, n_bands), np.uint8)
    px[..., band] = inner.pixels[..., 0]
    return Picture(px, mode)


def _open_nested(data: bytes, name: str):
    """`image_io.open_image` of the extracted bytes, as PIL's load opens
    them; a refusal names the IPTC file."""
    from gaussian_splatting_torch.utils.image_io import open_image

    with tempfile.TemporaryDirectory(prefix="iptc_") as tmp:
        path = os.path.join(tmp, "image_data")
        with open(path, "wb") as f:
            f.write(data)
        try:
            return open_image(path)
        except ValueError as err:
            raise ValueError(f"{name}: its IPTC image data: {str(err).replace(path, 'the data')}") from None
