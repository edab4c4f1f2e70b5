"""ICO and CUR reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the icons (PIL 12's IcoImagePlugin) and cursors
(CurImagePlugin) PIL reads, returning an `image_io.Picture`:

- ICO: the directory's entries sorted as PIL sorts them (by area, largest
  first; among equal areas by colour depth, lowest first: the bit count,
  else log2 of the colour count, else 256), and the first one read. A PNG
  entry is read by `image_io.open_png`'s reader in its own mode, with no
  transparency kept (PIL does not pass the PNG's on). A BMP entry is a
  DIB (`bmp.bitmap`) at half its height, converted to "RGBA", whose alpha
  is, where the directory says 32 bits, every fourth byte of the bitmap's
  rows, else the AND mask that ends the entry (bit 1 transparent), as
  PIL takes it.
- CUR: the first entry, or a later one wider and taller than it, read as
  PIL's BmpImageFile reads a bitmap at the entry's offset, at half its
  height, with no mask; a 32-bit `BI_RGB` bitmap at byte 22 (a one-entry
  cursor's) keeps its fourth byte as alpha ("RGBA"), as PIL does.

Where PIL's open of the file fails in a way that passes it on to its next
format (an empty directory, an entry or header cut short, a size of 0),
this raises `image_io.NotThisFormat`; every other failure raises a
`ValueError` naming the file and the feature, as PIL raises.
"""

from __future__ import annotations

import math

import numpy as np

from gaussian_splatting_torch.utils import bmp
from gaussian_splatting_torch.utils.bmp import _u16, _u32

ICO_SIGNATURE, CUR_SIGNATURE = b"\0\0\1\0", b"\0\0\2\0"


def decode_ico(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of an ICO file's largest entry."""
    from gaussian_splatting_torch.utils.image_io import PNG_SIGNATURE, NotThisFormat, Picture, png_picture, to_rgba

    count = _u16(data, 4)
    entries = []
    for i in range(count):
        e = data[6 + 16 * i:22 + 16 * i]
        if len(e) < 16:
            raise NotThisFormat(f"{name}: an ICO directory cut short at entry {i}")
        w, h, colors, bpp = e[0] or 256, e[1] or 256, e[2], _u16(e, 6)
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256
        entries.append((w * h, depth, _u32(e, 8), _u32(e, 12), bpp))
    if not entries:
        raise NotThisFormat(f"{name}: an ICO directory of no entries")
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    _, _, size, offset, bpp = entries[0]
    if data[offset:offset + 8] == PNG_SIGNATURE:
        pic = png_picture(data[offset:], name)
        picture = Picture(pic.pixels, pic.mode, pic.palette)
    else:
        dib, start = bmp.bitmap(data, name, offset, halve=True)
        h, w = dib.pixels.shape[:2]
        rgba = to_rgba(dib)
        if bpp == 32:  # the bitmap's fourth bytes, bottom-up
            alpha = np.frombuffer(data[start:start + w * h * 4][3::4], np.uint8)
            if alpha.size < w * h:
                bmp._refuse(name, "an icon's 32-bit bitmap cut short (PIL: buffer is not large enough)")
            rgba[..., 3] = alpha[:w * h].reshape(h, w)[::-1]
        else:  # the AND mask at the entry's end, rows padded to 32 bits, bit 1 transparent
            stride = (w + 31) // 32 * 4
            at = offset + size - stride * h
            if at < 0:
                bmp._refuse(name, f"an icon's AND mask at byte {at} (PIL: negative seek value)")
            mask = data[at:at + stride * h]
            if len(mask) < stride * (h - 1) + (w + 7) // 8:  # the last row's padding is not read
                bmp._refuse(name, "an icon's AND mask cut short (PIL: not enough image data)")
            mask = np.frombuffer(mask.ljust(stride * h, b"\0"), np.uint8).reshape(h, stride)
            bits = np.unpackbits(mask, axis=1)[:, :w]
            rgba[..., 3] = np.where(bits[::-1], 0, 255)
        picture = Picture(rgba, "RGBA")
    if min(picture.pixels.shape[:2]) <= 0:
        raise NotThisFormat(f"{name}: an icon of no pixels (PIL: an empty size, passed on)")
    return picture


def decode_cur(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of a CUR file: PIL's pick of its entries."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat

    if len(data) < 6:
        raise NotThisFormat(f"{name}: a CUR header cut short")
    pick, pos = b"", 6
    try:  # PIL's loop as it stands: its short reads and its IndexErrors
        for _ in range(_u16(data, 4)):
            e = data[pos:pos + 16]
            pos += len(e)
            if not pick:
                pick = e
            elif e[0] > pick[0] and e[1] > pick[1]:
                pick = e
    except IndexError:
        raise NotThisFormat(f"{name}: a CUR directory cut short") from None
    if not pick:
        raise NotThisFormat(f"{name}: a CUR directory of no entries (PIL: No cursors were found)")
    if len(pick) < 16:
        raise NotThisFormat(f"{name}: a CUR directory entry cut short")
    at = _u32(pick, 12)  # at 0 PIL reads the bitmap where its reads of the directory ended
    return bmp.bitmap(data, name, at or pos, cur_alpha=at == 22, halve=True)[0]
