"""PSD reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the Photoshop files PIL 12's PsdImagePlugin reads, returning an
`image_io.Picture` of the merged image (`PsdImagePlugin._maketile`; the
layers are not read). The modes of `PsdImagePlugin.MODES`: bitmap at 1
bit "1" (a set bit 255, as PIL reads it, though Photoshop's set bit is
black), grey, duotone and multichannel at 8 bits "L", indexed "P" (its
palette the 768 bytes of colour mode data, stored a plane a colour; with
other colour mode data PIL keeps no palette, and its colours are black),
RGB "RGB" ("RGBA" with exactly 4 channels), CMYK "CMYK" (each sample
inverted, as PIL stores it: 255 less the file's byte) and Lab "LAB" (L as
stored, a and b with their top bit flipped, as PIL's LAB bands hold them;
`to_rgba` gives it alpha 0, as PIL's `convert("RGBA")` does). Channels beyond the mode's are not read. Each channel
is raw or PackBits; PackBits is decoded by
`utils/image_codecs.pil_packbits_decode` (compiled host C++, PIL's
PackDecode.c, which cuts a run at its row's end, where libtiff's cuts it
at the strip's: not the TIFF reader's `packbits_decode`), each channel
from its offset on as PIL reads it (the byte counts place the channels,
they do not end the rows).

A header cut short, another bit depth or colour mode, or a size of 0
raises `image_io.NotThisFormat` (PIL passes the file on to its next
format, and no other reads it); fewer channels than the mode needs, ZIP
compression (PIL: cannot load this image), data that ends early and an
image over PIL's decompression-bomb limit raise a `ValueError` naming the
file and the feature.
"""

from __future__ import annotations

import numpy as np

from gaussian_splatting_torch.utils import image_codecs
from gaussian_splatting_torch.utils.bmp import MAX_PIXELS

SIGNATURE = b"8BPS"
# (Photoshop colour mode, bits) -> (PIL's mode, channels it reads)
MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1), (3, 8): ("RGB", 3),
         (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}
SUPPORTED = "the port reads the PSD files PIL reads (PsdImagePlugin)"


class _File:
    """PIL's reads and seeks on the bytes: a read stops at the end, a seek
    may pass it."""

    def __init__(self, data: bytes, name: str):
        self.data, self.name, self.pos = data, name, 0

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + max(n, 0)]
        self.pos += len(out)
        return out

    def u(self, n: int) -> int:
        """A big-endian unsigned of n bytes (PIL's i16 / i32 of a read)."""
        from gaussian_splatting_torch.utils.image_io import NotThisFormat

        b = self.read(n)
        if len(b) < n:
            raise NotThisFormat(f"{self.name}: a PSD section cut short at byte {self.pos}")
        return int.from_bytes(b, "big")


def decode_psd(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of PSD bytes: PIL's merged image."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    f = _File(data, name)
    s = f.read(26)
    if len(s) < 26 or not s.startswith(SIGNATURE) or s[4:6] != b"\0\1":
        raise NotThisFormat(f"{name}: not a PSD file (PIL: a version-1 Photoshop header)")
    channels, height, width, bits, colour = (int.from_bytes(s[a:b], "big")
                                             for a, b in ((12, 14), (14, 18), (18, 22), (22, 24), (24, 26)))
    if (colour, bits) not in MODES:
        raise NotThisFormat(f"{name}: a PSD of colour mode {colour} at {bits} bits (PIL: no mode for it)")
    mode, needs = MODES[(colour, bits)]
    if needs > channels:
        raise ValueError(f"{name}: a PSD of mode {mode} with {channels} channels (PIL: not enough channels); "
                         f"{SUPPORTED}")
    if mode == "RGB" and channels == 4:
        mode, needs = "RGBA", 4
    palette = None
    size = f.u(4)
    if size:
        colour_data = f.read(size)
        if mode == "P" and size == 768 and len(colour_data) == 768:
            palette = np.frombuffer(colour_data, np.uint8).reshape(3, 256).T.copy()
    if mode == "P" and palette is None:
        palette = np.zeros((0, 3), np.uint8)  # PIL keeps no palette: every colour black
    size = f.u(4)  # image resources, walked as PIL walks them
    if size:
        end = f.pos + size
        while f.pos < end:
            f.read(4)
            f.u(2)
            length = f.read(1)
            if not length:
                raise NotThisFormat(f"{name}: a PSD image resource cut short")
            if not len(f.read(length[0])) & 1:
                f.read(1)
            if len(f.read(f.u(4))) & 1:
                f.read(1)
    size = f.u(4)  # layer and mask information, skipped
    if size:
        end = f.pos + size
        f.u(4)
        f.pos = end
    compression = f.u(2)
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: a PSD of {width}x{height} pixels (PIL: an empty size, passed on)")
    if width * height > MAX_PIXELS:
        raise ValueError(f"{name}: an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    row_bytes = (width + 7) // 8 if mode == "1" else width
    offset = f.pos
    planes = []
    if compression == 0:
        for c in range(needs):
            if len(data) < offset + row_bytes * height:
                raise ValueError(f"{name}: truncated PSD pixel data in channel {c}; {SUPPORTED}")
            planes.append(np.frombuffer(data, np.uint8, row_bytes * height, offset).reshape(height, row_bytes))
            offset += width * height
    elif compression == 1:
        counts = f.read(needs * height * 2)
        if len(counts) < needs * height * 2:
            raise NotThisFormat(f"{name}: a PSD byte count table cut short")
        counts = np.frombuffer(counts, ">u2").astype(np.int64).reshape(needs, height).sum(1)
        offset = f.pos
        for c in range(needs):
            planes.append(image_codecs.pil_packbits_decode(data, offset, row_bytes, height, name))
            offset += int(counts[c])
    else:
        raise ValueError(f"{name}: PSD compression {compression} (PIL: cannot load this image); {SUPPORTED}")
    if mode == "1":
        return Picture(np.unpackbits(planes[0], axis=1)[:, :width, None] != 0, mode)
    pixels = np.stack(planes, axis=-1)
    if mode == "CMYK":  # PIL's "C;I" raw modes: stored inverted
        pixels = 255 - pixels
    elif mode == "LAB":  # PIL's "A" and "B" bands of LAB: a and b as signed bytes
        pixels[..., 1:] ^= 0x80
    # LAB: PIL's core leaves the fourth byte 0, which convert("RGBA") takes for alpha
    return Picture(np.ascontiguousarray(pixels), mode, palette, 0 if mode == "LAB" else None)
