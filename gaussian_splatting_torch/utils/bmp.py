"""BMP and DIB reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the BMP files PIL reads (PIL 12's BmpImagePlugin), and of its
DIBs (`DibImageFile`: no file header, the info header at byte 0, the
pixels right after the header, its masks and its colour table), returning
an `image_io.Picture`; `bitmap` is PIL's `_bitmap`, which the icon and
cursor readers (`utils/ico.py`) share:

- headers: OS/2 1.x (12 bytes), BITMAPINFOHEADER (40), its V2 / V3 / V4 /
  V5 forms (52, 56, 108, 124) and the OS/2 2.x header (64); rows
  bottom-up, or top-down under a negative height; rows padded to 4 bytes;
- 1, 4 and 8 bits with a palette: mode "P" (the PLTE's colours, indices
  past a short palette black in `to_rgba`), "1" where the palette is
  black and white (2 entries), "L" where entry i is grey i for every
  entry, as PIL picks them;
- 16 bits: 5-5-5 by default, 5-6-5 or 5-5-5 under `BI_BITFIELDS` masks
  (each channel scaled as v * 255 // max), mode "RGB";
- 24 bits "RGB"; 32 bits `BI_RGB` "RGB" (the fourth byte dropped, as PIL
  does); 32 bits `BI_BITFIELDS` with the masks PIL knows, "RGBA" where a
  mask names alpha (and for all-zero masks), else "RGB";
- RLE8 and RLE4 (`utils/image_codecs.bmp_rle_decode`, compiled host C++),
  with PIL's reading of their escapes.

Everything else raises a `ValueError` naming the file and the feature, as
PIL raises: other header sizes and bit counts, `BI_JPEG` / `BI_PNG` and
`BI_ALPHABITFIELDS`, bitfield masks PIL does not list, palettes of more
than 256 colours, RLE into modes other than "P" and "L", data that ends
early. An image over PIL's decompression-bomb limit raises too.
"""

from __future__ import annotations

import numpy as np

from gaussian_splatting_torch.utils import image_codecs

MAX_PIXELS = 2 * 89478485  # PIL raises DecompressionBombError past this
RAW, RLE8, RLE4, BITFIELDS = 0, 1, 2, 3
HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)  # the info headers PIL reads
COMPRESSION_NAMES = {4: "BI_JPEG", 5: "BI_PNG", 6: "BI_ALPHABITFIELDS"}
# bits -> (mode, raw mode) before the compression and palette decide
BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"),
            32: ("RGB", "BGRX")}
# (bits, masks) -> raw mode under BI_BITFIELDS; the 32-bit masks are
# (r, g, b, a), the others (r, g, b). A raw mode names the bytes in order.
MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
SUPPORTED = "the port reads the BMP files PIL reads (BmpImagePlugin)"


def _refuse(name, what: str):
    raise ValueError(f"{name}: {what}; {SUPPORTED}")


def _u16(data: bytes, at: int) -> int:
    return int.from_bytes(data[at:at + 2], "little")


def _u32(data: bytes, at: int) -> int:
    return int.from_bytes(data[at:at + 4], "little")


def open_bmp(path):
    """The `image_io.Picture` of a BMP file."""
    with open(path, "rb") as f:
        return decode_bmp(f.read(), str(path))


def decode_bmp(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of BMP bytes: PIL's pixels (with a channel
    axis) and mode, and the palette of mode "P"."""
    if not data.startswith(b"BM"):
        _refuse(name, "not a BMP file (no BM signature)")
    if len(data) < 18:
        _refuse(name, "a truncated BMP file header")
    return bitmap(data, name, 14, _u32(data, 10))[0]


def dib_accepts(head: bytes) -> bool:
    """PIL's `_dib_accept`: a DIB (a BMP without its file header) starts
    with the size of a header PIL reads."""
    return len(head) >= 4 and _u32(head, 0) in HEADER_SIZES


def decode_dib(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of a DIB (PIL's DibImageFile): the info
    header at byte 0 and, as PIL reads it, the pixels right after the
    header, its BI_BITFIELDS masks and, at 1 to 8 bits, its colour table."""
    return bitmap(data, name, 0)[0]


def bitmap(data: bytes, name: str, pos: int, offset: int = 0, cur_alpha: bool = False, halve: bool = False):
    """PIL's `BmpImageFile._bitmap` on `data`: the info header at `pos`,
    the pixels at `offset` (0: where PIL's reads of the header, masks and
    colour table end). `cur_alpha`: a 32-bit `BI_RGB` bitmap keeps its
    fourth byte as alpha ("RGBA"), as PIL does for a cursor's bitmap at
    byte 22; `halve`: an icon's or cursor's bitmap, whose height counts
    the AND mask too, read at half its height. Returns the `Picture` and
    the byte its pixels start at. Where PIL's open fails in a way that
    passes the file on to its next format, this raises
    `image_io.NotThisFormat`."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    if len(data) < pos + 4:
        raise NotThisFormat(f"{name}: a BMP info header cut short before its size")
    header_size = _u32(data, pos)
    if header_size not in HEADER_SIZES:
        _refuse(name, f"a BMP header of {header_size} bytes")
    header = data[pos + 4:pos + header_size]
    if len(header) != header_size - 4:
        _refuse(name, "a truncated BMP header")
    pos += header_size
    direction = -1  # rows bottom-up
    if header_size == 12:
        width, height, bits = _u16(header, 0), _u16(header, 2), _u16(header, 6)
        compression, colors, padding = RAW, 0, 3
    else:
        if header[7] == 0xFF:  # a negative height: rows top-down
            direction, height = 1, 2**32 - _u32(header, 4)
        else:
            height = _u32(header, 4)
        width, bits, compression = _u32(header, 0), _u16(header, 10), _u32(header, 12)
        colors, padding = _u32(header, 28), 4
        if compression == BITFIELDS:
            if len(header) >= 48:  # the masks inside a V2 and later header
                masks = [_u32(header, 36 + 4 * i) for i in range(4 if len(header) >= 52 else 3)]
            else:  # after a 40-byte header
                if len(data) < pos + 12:
                    raise NotThisFormat(f"{name}: BMP bitfield masks cut short")
                masks = [_u32(data, pos + 4 * i) for i in range(3)]
                pos += 12
            masks += [0] * (4 - len(masks))
    if halve:
        height //= 2
    if width * height > MAX_PIXELS:
        _refuse(name, f"an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    colors = colors or 1 << bits
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors  # PIL's reading of a data offset that points at the palette
    if bits not in BIT2MODE:
        _refuse(name, f"a BMP of {bits} bits per pixel")
    mode, raw = BIT2MODE[bits]
    if compression == BITFIELDS:
        key = (bits, tuple(masks) if bits == 32 else tuple(masks[:3]))
        if key not in MASK_MODES:
            _refuse(name, f"BMP bitfields at {bits} bits with masks "
                          + ", ".join(f"0x{m:X}" for m in key[1]))
        raw = MASK_MODES[key]
        if "A" in raw:
            mode = "RGBA"
    elif compression == RAW and bits == 32 and cur_alpha:
        mode, raw = "RGBA", "BGRA"
    elif compression not in (RAW, RLE8, RLE4):
        _refuse(name, f"BMP compression {compression}"
                      + (f" ({COMPRESSION_NAMES[compression]})" if compression in COMPRESSION_NAMES else ""))
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            _refuse(name, f"a BMP palette of {colors} colours")
        table = data[pos:pos + padding * colors]
        pos += len(table)
        greys = (0, 255) if colors == 2 else range(colors)
        if all(table[i * padding:i * padding + 3] == bytes([v & 255]) * 3 for i, v in enumerate(greys)):
            mode = raw = "1" if colors == 2 else "L"
        else:
            if colors > 256:
                _refuse(name, f"a BMP palette of {colors} colours (PIL: invalid palette size)")
            entries = np.frombuffer(table[:len(table) // padding * padding], np.uint8).reshape(-1, padding)
            palette = np.ascontiguousarray(entries[:, 2::-1])  # BGR(X) -> RGB
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: a BMP of {width}x{height} pixels (PIL: an empty size, passed on)")
    start = offset or pos
    if compression in (RLE8, RLE4):
        if mode not in ("P", "L"):
            _refuse(name, f"RLE into mode {mode} (PIL: unknown raw mode)")
        rows = image_codecs.bmp_rle_decode(data, start, compression == RLE4, width, height, name)
    else:
        if raw == "L" and bits < 8:
            _refuse(name, f"a grey palette at {bits} bits, which PIL reads 8 bits a pixel")
        stride = ((width * bits + 31) >> 3) & ~3
        need = stride * (height - 1) + (width * bits + 7) // 8  # PIL's raw decoder skips no last padding
        if start + need > len(data):
            _refuse(name, f"truncated BMP pixel data ({max(len(data) - start, 0)} of {need} bytes)")
        body = data[start:start + stride * height].ljust(stride * height, b"\0")
        rows = _unpack(np.frombuffer(body, np.uint8).reshape(height, stride), raw, width)
    if rows.ndim == 2:
        rows = rows[..., None]
    return Picture(np.ascontiguousarray(rows[::-1] if direction == -1 else rows), mode, palette), start


def _unpack(rows: np.ndarray, raw: str, width: int) -> np.ndarray:
    """The pixels of (H, stride) row bytes in PIL's raw mode `raw`."""
    if raw in ("1", "P;1", "P;4"):
        depth = 4 if raw == "P;4" else 1
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        values = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(len(rows), -1)[:, :width]
        return values != 0 if raw == "1" else values
    if raw in ("P", "L"):
        return rows[:, :width]
    if raw.startswith("BGR;"):
        v = rows[:, :2 * width].view("<u2").astype(np.int64)
        if raw == "BGR;16":
            r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
            return np.stack([r * 255 // 31, g * 255 // 63, b * 255 // 31], -1).astype(np.uint8)
        r, g, b = (v >> 10) & 31, (v >> 5) & 31, v & 31
        return np.stack([r * 255 // 31, g * 255 // 31, b * 255 // 31], -1).astype(np.uint8)
    px = rows[:, :len(raw) * width].reshape(len(rows), width, len(raw))
    return px[..., [raw.index(c) for c in ("RGBA" if "A" in raw else "RGB")]]
