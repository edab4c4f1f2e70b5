"""ICNS reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the macOS icon files PIL 12's IcnsImagePlugin reads, returning
an `image_io.Picture` of the icon PIL loads: the largest (width, height,
scale) of `IcnsFile.SIZES` that has a block, (512, 512, 2) above (512,
512, 1). Every reader of that size whose block is there runs, in PIL's
order:

- a PNG (`image_io.png_picture` on the file from the block on) or a JPEG
  2000 (`utils/jp2.decode_jp2` on the block's bytes, then PIL's
  `convert("RGBA")`, `image_io.to_rgba`) becomes the icon: the PNG's mode,
  pixels and palette (its transparency is not carried over, as in PIL),
  the JPEG 2000's RGBA, held to PIL's size setter, which refuses a size
  that no listed size matches;
- it32 (after its four zero bytes), ih32, il32 and is32 are RGB: raw
  where the block is width x height x 3 bytes, else three bands of PIL's
  PackBits-like runs (`icns_rle_decode`: `image_codecs.icns_rle_decode`,
  `csrc/image_codecs.cc`, or `plain_rle` here for the tests), each band
  from where the last ended, read past the block if the runs go on;
- t8mk, h8mk, l8mk and s8mk are the alpha of the RGB icon, which turns it
  "RGBA".

The pixels are those of the loaded image: `np.asarray` of an icon PIL has
not loaded packs an "RGB" icon as RGBX and fails on other modes (PIL's
`tobytes` takes the raw mode before it loads), which neither dataset path
reads, as both load first.

A block table cut short or with a block size of 0 or less, and a file with
no icon PIL lists, raise `image_io.NotThisFormat` (PIL passes the file on);
a band that does not end where its pixels do, data cut short, an entry of
another format, an icon of no RGB, a size PIL's setter refuses and an image
over PIL's decompression-bomb limit raise a `ValueError` naming the file.
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatting_torch.utils import image_codecs
from gaussian_splatting_torch.utils.bmp import MAX_PIXELS

SIGNATURE = b"icns"
PNG, JP2 = b"\x89PNG\r\n\x1a\n", (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")
JP2_BOX = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
# IcnsFile.SIZES: (width, height, scale) -> its blocks and their readers, in PIL's order
SIZES = {
    (512, 512, 2): [(b"ic10", "png")], (512, 512, 1): [(b"ic09", "png")],
    (256, 256, 2): [(b"ic14", "png")], (256, 256, 1): [(b"ic08", "png")],
    (128, 128, 2): [(b"ic13", "png")],
    (128, 128, 1): [(b"ic07", "png"), (b"it32", "32t"), (b"t8mk", "mk")],
    (64, 64, 1): [(b"icp6", "png")], (32, 32, 2): [(b"ic12", "png")],
    (48, 48, 1): [(b"ih32", "32"), (b"h8mk", "mk")],
    (32, 32, 1): [(b"icp5", "png"), (b"il32", "32"), (b"l8mk", "mk")],
    (16, 16, 2): [(b"ic11", "png")],
    (16, 16, 1): [(b"icp4", "png"), (b"is32", "32"), (b"s8mk", "mk")],
}


def _refuse(name, what: str):
    raise ValueError(f"{name}: {what}; the port reads the icns files PIL reads (IcnsImagePlugin)")


def decode_icns(data: bytes, name: str = "<bytes>", plain: bool = False):
    """The `image_io.Picture` of icns bytes; the RGB bands' runs compiled,
    or with `plain` Python (`plain_rle`)."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    blocks = {}
    try:
        filesize, i = struct.unpack_from(">I", data, 4)[0], 8
        pos = 8
        while i < filesize:
            sig, size = struct.unpack_from(">4sI", data, pos)
            if size <= 0:
                raise NotThisFormat(f"{name}: an icns block of size {size} (PIL: invalid block header, passed on)")
            i += 8
            blocks[sig] = (i, size - 8)
            pos += size
            i += size - 8
    except struct.error:
        raise NotThisFormat(f"{name}: an icns block table cut short (PIL: struct.error, passed on)") from None
    sizes = [size for size, readers in SIZES.items() if any(code in blocks for code, _ in readers)]
    if not sizes:
        raise NotThisFormat(f"{name}: an icns file with no icon (PIL: No 32bit icon resources found, passed on)")
    best = max(sizes)
    w, h = best[0] * best[2], best[1] * best[2]
    if w * h > MAX_PIXELS:
        _refuse(name, f"an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    whole = rgb = alpha = None
    for code, kind in SIZES[best]:
        if code not in blocks:
            continue
        start, length = blocks[code]
        if kind == "png":
            whole = _png_or_jp2(data, start, length, name)
        elif kind == "mk":
            alpha = np.frombuffer(data[start:start + w * h], np.uint8)
            if alpha.size < w * h:
                _refuse(name, f"an icns mask of {alpha.size} of its {w * h} bytes (PIL: buffer is not large enough)")
        else:
            if kind == "32t":
                if data[start:start + 4] != bytes(4):
                    _refuse(name, "an it32 block without its four zero bytes (PIL: Unknown signature)")
                start, length = start + 4, length - 4
            rgb = _rgb(data, start, length, w, h, name, plain)
    if whole is not None:
        _size_setter(sizes, whole.pixels.shape[1], whole.pixels.shape[0], name)
        return whole
    if rgb is None:
        _refuse(name, f"an icns icon of {w}x{h} with a mask and no RGB (PIL: KeyError 'RGB')")
    if alpha is None:
        return Picture(rgb, "RGB")
    return Picture(np.concatenate([rgb, alpha.reshape(h, w, 1)], axis=2), "RGBA")


def _png_or_jp2(data: bytes, start: int, length: int, name):
    """PIL's `read_png_or_jpeg2000`: a PNG read from the block on, or a
    JPEG 2000 of the block's bytes converted to RGBA."""
    from gaussian_splatting_torch.utils import jp2
    from gaussian_splatting_torch.utils.image_io import Picture, png_picture, to_rgba

    sig = data[start:start + 12]
    if sig.startswith(PNG):
        png = png_picture(data[start:], name)
        if png.pixels.shape[0] * png.pixels.shape[1] > MAX_PIXELS:
            _refuse(name, f"a PNG entry of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
        return Picture(png.pixels, png.mode, png.palette)
    if sig.startswith(JP2) or sig == JP2_BOX:
        if length < -1:
            _refuse(name, f"a JPEG 2000 entry of {length} bytes (PIL: read length must be non-negative or -1)")
        pic = jp2.decode_jp2(data[start:] if length == -1 else data[start:start + length], name)  # read(-1): all
        return Picture(pic.pixels if pic.mode == "RGBA" else to_rgba(pic), "RGBA")
    _refuse(name, "an icns entry that is neither PNG nor JPEG 2000 (PIL: Unsupported icon subimage format)")


def _size_setter(sizes, width: int, height: int, name) -> None:
    """IcnsImageFile's size setter: some listed size's width a whole
    multiple `scale` of `width` (floor division) whose height divided by
    `height` equals it."""
    for s in sizes:
        simple = s[0] * s[2], s[1] * s[2]
        if simple[1] / height == simple[0] // width:
            return
    _refuse(name, f"an icns entry of {width}x{height}, none of its sizes (PIL: This is not one of the allowed "
                  f"sizes of this image)")


def _rgb(data: bytes, start: int, length: int, w: int, h: int, name, plain: bool) -> np.ndarray:
    """(h, w, 3) uint8: PIL's `read_32`."""
    n = w * h
    if length == 3 * n:
        raw = data[start:start + length]
        if len(raw) < 3 * n:
            _refuse(name, f"raw icns RGB of {len(raw)} of its {3 * n} bytes (PIL: not enough image data)")
        return np.frombuffer(raw, np.uint8).reshape(h, w, 3)
    out = np.empty((h, w, 3), np.uint8)
    pos = start
    for band in range(3):
        values, left, pos = icns_rle_decode(data, pos, n, name, plain)
        if left != 0:
            _refuse(name, f"an icns RGB band {band} that does not end with its pixels (PIL: Error reading channel "
                          f"[{left} left])")
        if values.size < n:
            _refuse(name, f"an icns RGB band {band} of {values.size} of its {n} bytes (PIL: buffer is not large "
                          f"enough)")
        out[..., band] = values.reshape(h, w)
    return out


def icns_rle_decode(data: bytes, start: int, n: int, name, plain: bool = False):
    """One band of `n` pixels from `start`: (its bytes, what is left of its
    count (0: whole, negative: a run past the band), the offset after
    it); compiled (`image_codecs.icns_rle_decode`), or with `plain` Python."""
    return plain_rle(data, start, n) if plain else image_codecs.icns_rle_decode(data, start, n, name)


def plain_rle(data: bytes, start: int, n: int):
    """PIL's `read_32` loop for one band, in Python."""
    parts, left, pos = [], n, start
    while left > 0:
        byte = data[pos:pos + 1]
        pos += len(byte)
        if not byte:
            break
        if byte[0] & 0x80:
            block = byte[0] - 125
            value = data[pos:pos + 1]
            pos += len(value)
            parts.append(value * block)
        else:
            block = byte[0] + 1
            chunk = data[pos:pos + block]
            pos += len(chunk)
            parts.append(chunk)
        left -= block
    return np.frombuffer(b"".join(parts)[:n], np.uint8), left, pos
