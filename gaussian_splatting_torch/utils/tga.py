"""TGA (Targa) reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the TGA files PIL 12's TgaImagePlugin reads, returning an
`image_io.Picture`:

- image types 1 and 9 (colour-mapped, 8 bits) mode "P"; 2 and 10 (true
  colour) "RGB" at 24 bits (BGR), "RGBA" at 32 bits (BGRA) and at 16 bits
  (PIL's "BGRA;15Z": 5 bits a colour scaled as v * 255 // 31, alpha 0
  where the top bit is set); 3 and 11 (grey) "1", "L" or "LA" at 1, 8 or
  16 bits; the types of 9 and above run-length coded;
- colour maps of 16-bit (RGBA, as "BGRA;15Z") and 24-bit (BGR) entries,
  the map's first index (`start`) as PIL takes it: that many entries of
  zero bytes before the map (black; opaque in a 16-bit map); a map on a
  grey image is kept as PIL's core keeps it (the image stays "L" or "LA"
  and `to_rgba` converts through the map);
- the four origins: bit 0x20 of the descriptor puts the first row at the
  top, bit 0x10 flips the image left to right after decoding, as PIL's
  `load_end` does;
- RLE as PIL's C TgaRleDecode reads it (`utils/image_codecs.tga_rle_decode`,
  compiled host C++): a raw packet may run on across rows, a run packet
  that would cross the end of its row raises (PIL: buffer overrun), data
  past the last row is ignored.

Everything else raises a `ValueError` naming the file, where PIL raises:
image types 0, 4-8 and 12 and up, bit counts other than 1, 8, 16, 24 and
32, type and depth pairs PIL has no raw mode for (PIL: cannot load this
image), a colour-mapped type without a map, 32-bit and other map depths,
maps of more than 256 entries, a map on an RGB, RGBA or "1" image, 1-bit
RLE (from which PIL reads no pixel), data that ends early. An image over
PIL's decompression-bomb limit raises too.
"""

from __future__ import annotations

import numpy as np

from gaussian_splatting_torch.utils import image_codecs

MAX_PIXELS = 2 * 89478485  # PIL raises DecompressionBombError past this
HEADER = 18
# (image type & 7, bits per pixel) -> PIL's raw mode
RAW_MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z", (2, 24): "BGR",
             (2, 32): "BGRA"}
SUPPORTED = "the port reads the TGA files PIL reads (TgaImagePlugin)"


def _refuse(name, what: str):
    raise ValueError(f"{name}: {what}; {SUPPORTED}")


def looks_like_tga(head: bytes) -> bool:
    """PIL's first checks of a TGA header (a colour-map type of 0 or 1, a
    non-zero size, 1, 8, 16, 24 or 32 bits a pixel); TGA has no signature."""
    return (len(head) >= HEADER and head[1] in (0, 1) and _u16(head, 12) > 0 and _u16(head, 14) > 0
            and head[16] in (1, 8, 16, 24, 32))


def _u16(data: bytes, at: int) -> int:
    return int.from_bytes(data[at:at + 2], "little")


def open_tga(path):
    """The `image_io.Picture` of a TGA file."""
    with open(path, "rb") as f:
        return decode_tga(f.read(), str(path))


def decode_tga(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of TGA bytes: PIL's pixels (with a channel
    axis) and mode, and the colour map as the palette."""
    from gaussian_splatting_torch.utils.image_io import Picture

    if not looks_like_tga(data):
        _refuse(name, "not a TGA file (PIL's header checks fail)")
    id_len, map_type, image_type, depth, flags = data[0], data[1], data[2], data[16], data[17]
    width, height = _u16(data, 12), _u16(data, 14)
    if image_type in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif image_type in (1, 9):
        mode = "P" if map_type else "L"
    elif image_type in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        _refuse(name, f"TGA image type {image_type} (PIL: unknown TGA mode)")
    if width * height > MAX_PIXELS:
        _refuse(name, f"an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    pos = HEADER + id_len
    palette = None
    if map_type:
        start, size, map_depth = _u16(data, 3), _u16(data, 5), data[7]
        if map_depth not in (16, 24, 32):
            _refuse(name, f"a TGA colour map of {map_depth}-bit entries (PIL: unknown TGA map depth)")
        entry = map_depth // 8
        table = data[pos:pos + entry * size]
        pos += len(table)
        if map_depth == 32:
            _refuse(name, "a TGA colour map of 32-bit entries (PIL: unrecognized raw mode)")
        if mode not in ("P", "L", "LA"):
            _refuse(name, f"a colour map on a TGA of mode {mode} (PIL: unrecognized image mode)")
        if start + len(table) // entry > 256:
            _refuse(name, f"a TGA colour map of {start + len(table) // entry} entries (PIL: invalid palette size)")
        # PIL prepends `start` entries of zero bytes, which BGRA;15Z reads as opaque black
        entries = np.frombuffer(bytes(entry * start) + table[:len(table) // entry * entry], np.uint8)
        entries = entries.reshape(-1, entry)
        palette = _bgra15z(entries.view("<u2")[:, 0]) if entry == 2 else np.ascontiguousarray(entries[:, ::-1])
    raw = RAW_MODES.get((image_type & 7, depth))
    if raw is None:
        _refuse(name, f"TGA image type {image_type} at {depth} bits (PIL: cannot load this image)")
    if mode == "L" and raw == "P":
        _refuse(name, f"a colour-mapped TGA (type {image_type}) without a colour map (PIL: unknown raw mode)")
    stride = (width * depth + 7) // 8
    if image_type & 8:
        if depth == 1:
            _refuse(name, "a 1-bit RLE TGA, from which PIL reads no pixel (PIL: image file is truncated)")
        rows = image_codecs.tga_rle_decode(data, pos, depth // 8, stride, height, name)
    else:
        if len(data) - pos < stride * height:
            _refuse(name, f"truncated TGA pixel data ({max(len(data) - pos, 0)} of {stride * height} bytes)")
        rows = np.frombuffer(data, np.uint8, stride * height, pos).reshape(height, stride)
    pixels = _unpack(rows, raw, width)
    if not flags & 0x20:  # rows bottom-up
        pixels = pixels[::-1]
    if flags & 0x10:  # PIL's load_end flips left to right
        pixels = pixels[:, ::-1]
    return Picture(np.ascontiguousarray(pixels), mode, palette)


def _bgra15z(v: np.ndarray) -> np.ndarray:
    """PIL's "BGRA;15Z" unpacker of 16-bit little-endian values: RGBA."""
    v = v.astype(np.int64)
    return np.stack([((v >> 10) & 31) * 255 // 31, ((v >> 5) & 31) * 255 // 31, (v & 31) * 255 // 31,
                     np.where(v >> 15, 0, 255)], -1).astype(np.uint8)


def _unpack(rows: np.ndarray, raw: str, width: int) -> np.ndarray:
    """(H, W, C) pixels of (H, stride) row bytes in PIL's raw mode `raw`."""
    h = len(rows)
    if raw == "1":
        return np.unpackbits(rows, axis=1)[:, :width, None] != 0
    if raw == "BGRA;15Z":
        return _bgra15z(rows[:, :2 * width].view("<u2"))
    channels = {"P": 1, "L": 1, "LA": 2, "BGR": 3, "BGRA": 4}[raw]
    px = rows[:, :channels * width].reshape(h, width, channels)
    return px[..., [2, 1, 0, 3][:channels]] if raw.startswith("BGR") else px
