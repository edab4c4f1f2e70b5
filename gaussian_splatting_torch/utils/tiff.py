"""TIFF reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL, which reads a TIFF's
first image (frame 0) with its TiffImagePlugin: uncompressed strips and
tiles by its own raw decoder, everything compressed through libtiff. This
is the port's reader of the forms photogrammetry and capture tools write,
returning an `image_io.Picture`:

- classic TIFF in either byte order ("II" and "MM"), the first IFD,
  strips (the last one short) and tiles (cropped where they overhang),
  `PlanarConfiguration` 1;
- compression none (1), PackBits (32773), LZW (5, libtiff's new style),
  deflate (8, 32946) and JPEG (7: 8-bit samples, each strip or tile an
  abbreviated JPEG stream after the JPEGTables tag's tables, decoded by
  the compiled JPEG decoder as libtiff decodes it, with no colour
  conversion, `utils/jpeg.decode_tiff_jpeg`); `Predictor` 2 (horizontal
  differencing per sample, 8 and 16 bits, in the sample's own unsigned
  arithmetic) under LZW and deflate, where libtiff applies it;
- photometric WhiteIsZero (0: "1" and "L" inverted; 16 bits "I;16" as
  stored, as PIL reads it), BlackIsZero (1), RGB (2), palette (3, the
  ColorMap's high bytes) and CMYK (5);
- 1, 8 and 16 bits a sample, in PIL's modes: "1", "L", "I;16" (little
  endian) / "I;16B" (big endian), "LA", "RGB", "RGBA", "P", "CMYK"; 16-bit
  RGB, RGBA and CMYK as their high bytes;
- ExtraSamples: unassociated alpha (2) gives "RGBA" / "LA", associated
  alpha (1) "RGBA" divided back as PIL's "RGBa" unpacker divides, an
  unspecified sample (0) is dropped;
- the Orientation tag (274) applied after decoding, as PIL's TIFF loader
  does (`ImageOps.exif_transpose`).

LZW and PackBits run in compiled host C++ (`utils/image_codecs`), JPEG in
the compiled JPEG decoder, deflate in zlib, the rest in numpy. Everything
else raises a `ValueError` naming the file and the feature: BigTIFF;
old-style JPEG (6), JPEG in YCbCr (photometric 6, which PIL reads through
libtiff's YCbCr-to-RGB conversion), CCITT (2, 3, 4), WebP, ZSTD, LZMA and
the other compressions; old-style LZW; `Predictor` 3;
`PlanarConfiguration` 2; `FillOrder` 2; signed and floating-point
samples; YCbCr, CIELab and other photometrics; depths other than 1, 8 and
16; layouts PIL does not know; corrupt or truncated data (where libtiff
reports an error, PIL raises). An image over PIL's decompression-bomb
limit raises too.
"""

from __future__ import annotations

import math
import zlib

import numpy as np

from gaussian_splatting_torch.utils import image_codecs, jpeg

MAX_PIXELS = 2 * 89478485  # PIL raises DecompressionBombError past this
SIGNATURES = (b"II*\x00", b"MM\x00*", b"II\x00*", b"MM*\x00", b"II+\x00", b"MM\x00+")  # PIL's prefixes
SUPPORTED = ("the port reads classic TIFF, uncompressed, PackBits, LZW, deflate or JPEG (not in YCbCr), 1, 8 "
             "or 16 bits, grey, RGB(A), palette or CMYK")

# tags
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILL_ORDER, STRIP_OFFSETS = 256, 257, 258, 259, 262, 266, 273
ORIENTATION, SAMPLES, ROWS_PER_STRIP, STRIP_COUNTS, PLANAR, PREDICTOR = 274, 277, 278, 279, 284, 317
COLORMAP, TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS, EXTRA, SAMPLE_FORMAT = (
    320, 322, 323, 324, 325, 338, 339)
JPEG_TABLES = 347  # UNDEFINED: kept as bytes
# integer field types: byte, short, long, sbyte, sshort, slong
_INT_TYPES = {1: "u1", 3: "u2", 4: "u4", 6: "i1", 8: "i2", 9: "i4"}

NONE, LZW, JPEG, DEFLATE, ADOBE_DEFLATE, PACKBITS = 1, 5, 7, 32946, 8, 32773
REFUSED_COMPRESSION = {
    2: "CCITT modified Huffman (compression 2)", 3: "CCITT Group 3 (compression 3)",
    4: "CCITT Group 4 (compression 4)", 6: "old-style JPEG-in-TIFF (compression 6)",
    32771: "16-bit padded raw data (compression 32771)",
    32809: "ThunderScan (compression 32809)", 34676: "SGILog (compression 34676)",
    34677: "SGILog24 (compression 34677)", 34925: "LZMA (compression 34925)",
    50000: "ZSTD (compression 50000)", 50001: "WebP (compression 50001)",
}
REFUSED_PHOTOMETRIC = {4: "a transparency mask (photometric 4)", 6: "YCbCr (photometric 6)",
                       8: "CIELab (photometric 8)", 9: "ICCLab (photometric 9)", 10: "ITULab (photometric 10)"}
# (photometric, bits per sample, extra samples) -> (PIL's mode, how the
# samples become it); the forms of PIL's OPEN_INFO at 1, 8 and 16 bits
# that the port reads
LAYOUTS = {
    (0, (1,), ()): ("1", "invert"), (1, (1,), ()): ("1", "grey"),
    (0, (8,), ()): ("L", "invert"), (1, (8,), ()): ("L", "grey"),
    (0, (16,), ()): ("I;16", "grey"), (1, (16,), ()): ("I;16", "grey"),
    (1, (8, 8), (2,)): ("LA", "take"),
    (3, (1,), ()): ("P", "take"), (3, (8,), ()): ("P", "take"), (3, (8, 8), (0,)): ("P", "take"),
}
for _bits in (8, 16):
    LAYOUTS[(2, (_bits,) * 3, ())] = ("RGB", "take")
    LAYOUTS[(5, (_bits,) * 4, ())] = ("CMYK", "take")
    for _extra, _layout in (((), ("RGBA", "take")), ((0,), ("RGB", "take")), ((1,), ("RGBA", "unpremultiply")),
                            ((2,), ("RGBA", "take"))):
        LAYOUTS[(2, (_bits,) * 4, _extra)] = _layout
for _pad in (1, 2):  # 8-bit layouts with unspecified samples after the alpha
    for _first, _layout in ((0, ("RGB", "take")), (1, ("RGBA", "unpremultiply")), (2, ("RGBA", "take"))):
        LAYOUTS[(2, (8,) * (4 + _pad), (_first,) + (0,) * _pad)] = _layout
    LAYOUTS[(5, (8,) * (4 + _pad), (0,) * _pad)] = ("CMYK", "take")
LAYOUTS[(2, (8,) * 4, (999,))] = ("RGBA", "take")  # Corel Draw 10's ExtraSamples, in PIL's table


def _refuse(name, what: str):
    raise ValueError(f"{name}: {what}; {SUPPORTED}")


def open_tiff(path):
    """The `image_io.Picture` of a TIFF file."""
    with open(path, "rb") as f:
        return decode_tiff(f.read(), str(path))


def _tags(data: bytes, name: str):
    """(byte order, {tag: tuple of ints}) of the first IFD. Tags of other
    types, and tags whose data lies past the file, are left out, as PIL
    leaves them out."""
    order = "<" if data[:2] == b"II" else ">"
    if data[2:4] in (b"+\x00", b"\x00+"):
        _refuse(name, "BigTIFF")
    if len(data) < 8:
        _refuse(name, "a truncated TIFF header")
    at = int.from_bytes(data[4:8], "little" if order == "<" else "big")
    if at + 2 > len(data):
        _refuse(name, "a TIFF whose first IFD lies past the end of the file")
    (n,) = np.frombuffer(data, order + "u2", 1, at)
    if at + 2 + 12 * int(n) > len(data):
        _refuse(name, "a truncated TIFF IFD")
    entries = np.frombuffer(data, np.dtype([("tag", order + "u2"), ("type", order + "u2"),
                                            ("count", order + "u4"), ("value", "V4")]), int(n), at + 2)
    tags = {}
    for tag, typ, count, value in entries.tolist():
        if tag == JPEG_TABLES and typ == 7:  # UNDEFINED bytes
            typ = 1
        elif typ not in _INT_TYPES or count == 0:
            continue
        size = count * int(_INT_TYPES[typ][1])
        if size <= 4:
            raw = bytes(value)[:size]
        else:
            where = int.from_bytes(bytes(value), "little" if order == "<" else "big")
            raw = data[where:where + size]
            if len(raw) != size:
                continue
        tags[tag] = tuple(np.frombuffer(raw, order + _INT_TYPES[typ], count).tolist())
    return order, tags


def decode_tiff(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of the first image of TIFF bytes: PIL's pixels
    (with a channel axis) and mode, and the palette of mode "P"."""
    from gaussian_splatting_torch.utils.image_io import Picture

    if not data.startswith(SIGNATURES):
        _refuse(name, "not a TIFF file (no TIFF signature)")
    order, tags = _tags(data, name)

    def one(tag, default=None):
        return tags[tag][0] if tag in tags else default

    compression = one(COMPRESSION, NONE)
    if compression in REFUSED_COMPRESSION:
        _refuse(name, REFUSED_COMPRESSION[compression])
    if compression not in (NONE, LZW, JPEG, DEFLATE, ADOBE_DEFLATE, PACKBITS):
        _refuse(name, f"TIFF compression {compression}")
    photo = one(PHOTOMETRIC, 0)
    if compression == JPEG and photo == 6:
        _refuse(name, "JPEG-in-TIFF (compression 7) in YCbCr (photometric 6), which PIL reads through libtiff's "
                      "YCbCr-to-RGB conversion")
    if photo in REFUSED_PHOTOMETRIC or photo not in (0, 1, 2, 3, 5):
        _refuse(name, REFUSED_PHOTOMETRIC.get(photo, f"photometric interpretation {photo}"))
    if one(FILL_ORDER, 1) != 1:
        _refuse(name, f"FillOrder {one(FILL_ORDER)} (the bits of a byte least significant first)")
    if WIDTH not in tags or LENGTH not in tags:
        _refuse(name, "a TIFF without its ImageWidth or ImageLength")
    width, height = one(WIDTH), one(LENGTH)
    if width * height > MAX_PIXELS:
        _refuse(name, f"an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    sample_format = tags.get(SAMPLE_FORMAT, (1,))
    if set(sample_format) != {1}:
        _refuse(name, f"SampleFormat {sample_format} (signed or floating-point samples)")
    # PIL's reading of BitsPerSample against SamplesPerPixel
    bits, extra = tags.get(BITS, (1,)), tags.get(EXTRA, ())
    spp = one(SAMPLES, 1)
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp:
        _refuse(name, f"{len(bits)} BitsPerSample values for {spp} samples per pixel (PIL: unknown data "
                      f"organization)")
    if spp > 1 and one(PLANAR, 1) == 2:
        _refuse(name, "PlanarConfiguration 2 (each sample in its own plane)")
    if any(b not in (1, 8, 16) for b in bits) or len(set(bits)) > 1:
        _refuse(name, f"{'/'.join(map(str, bits))}-bit samples")
    depth = bits[0]
    if compression == JPEG and depth != 8:
        _refuse(name, f"JPEG-in-TIFF at {depth} bits a sample (libtiff reads 8)")
    layout = LAYOUTS.get((photo, bits, extra))
    if layout is None or (depth == 16 and photo == 0 and order == ">"):
        _refuse(name, f"photometric {photo} with {'/'.join(map(str, bits))} bits and extra samples "
                      f"{extra} (a layout PIL does not read as the port does)")
    mode, how = layout
    if mode == "I;16" and order == ">":
        mode = "I;16B"
    predictor = one(PREDICTOR, 1) if compression in (LZW, DEFLATE, ADOBE_DEFLATE) else 1
    if predictor == 3:
        _refuse(name, "Predictor 3 (floating-point differencing)")
    if predictor not in (1, 2) or (predictor == 2 and depth == 1):
        _refuse(name, f"Predictor {predictor} at {depth} bits (libtiff refuses it)")

    canvas = _samples(data, name, tags, order, compression, predictor, width, height, spp, depth)
    if depth == 1:
        samples = np.unpackbits(canvas, axis=1)[:, :width, None]
    elif depth == 8:
        samples = canvas[:, :width * spp].reshape(height, width, spp)
    else:
        samples = canvas[:, :2 * width * spp].view(order + "u2").reshape(height, width, spp)
    palette = None
    if how == "invert":
        pixels = 1 - samples if depth == 1 else 255 - samples
    elif how == "unpremultiply":
        pixels = _unpremultiply(_high_bytes(samples[..., :4]))
    else:
        pixels = samples if mode.startswith("I;16") else _high_bytes(samples[..., :len(mode)])
    if mode == "1":
        pixels = pixels != 0
    elif mode == "I;16":
        pixels = pixels.astype(np.uint16)
    elif mode == "P":
        if COLORMAP not in tags:
            _refuse(name, "a palette TIFF without its ColorMap")
        cmap = np.asarray(tags[COLORMAP], np.int64) // 256
        n = len(cmap) // 3
        palette = np.stack([cmap[:n], cmap[n:2 * n], cmap[2 * n:3 * n]], -1).astype(np.uint8)
        pixels = pixels[..., :1]
    return Picture(np.ascontiguousarray(_orient(pixels, one(ORIENTATION, 1))), mode, palette)


def _high_bytes(samples: np.ndarray) -> np.ndarray:
    return (samples >> 8).astype(np.uint8) if samples.dtype.itemsize == 2 else samples.astype(np.uint8)


def _unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """PIL's "RGBa" unpacker: each colour times 255 over alpha, clipped;
    alpha 0 gives (0, 0, 0, 0), alpha 255 the colour as stored."""
    a = rgba[..., 3:].astype(np.int64)
    rgb = np.minimum(rgba[..., :3].astype(np.int64) * 255 // np.maximum(a, 1), 255)
    rgb = np.where(a == 255, rgba[..., :3], np.where(a == 0, 0, rgb))
    return np.concatenate([rgb, a], -1).astype(np.uint8)


def _orient(pixels: np.ndarray, orientation: int) -> np.ndarray:
    """PIL's exif_transpose for Orientation 2..8 on (H, W, C) pixels."""
    t = pixels.transpose(1, 0, 2)
    return {2: pixels[:, ::-1], 3: pixels[::-1, ::-1], 4: pixels[::-1], 5: t, 6: t[:, ::-1],
            7: t[::-1, ::-1], 8: t[::-1]}.get(orientation, pixels)


def _samples(data, name, tags, order, compression, predictor, width, height, spp, depth) -> np.ndarray:
    """(height, row bytes) of the image's decoded sample bytes, the strips
    or tiles decoded (and un-differenced) one by one and put in place."""
    tiled = TILE_OFFSETS in tags
    if tiled:
        if TILE_WIDTH not in tags or TILE_LENGTH not in tags:
            _refuse(name, "a tiled TIFF without its TileWidth or TileLength")
        cw, ch = tags[TILE_WIDTH][0], tags[TILE_LENGTH][0]
        offsets, counts = tags[TILE_OFFSETS], tags.get(TILE_COUNTS)
        if cw <= 0 or ch <= 0 or (depth == 1 and cw % 8):
            _refuse(name, f"tiles of {cw}x{ch} at {depth} bits")
    elif STRIP_OFFSETS in tags:
        cw, ch = width, min(tags.get(ROWS_PER_STRIP, (height,))[0], height)
        offsets, counts = tags[STRIP_OFFSETS], tags.get(STRIP_COUNTS)
        if ch <= 0:
            _refuse(name, "RowsPerStrip 0")
    else:
        _refuse(name, "a TIFF with neither strips nor tiles (PIL: unknown data organization)")
    across, down = math.ceil(width / cw), math.ceil(height / ch)
    if len(offsets) < across * down:
        _refuse(name, f"{len(offsets)} strip or tile offsets for {across * down} strips or tiles")
    if compression != NONE and (counts is None or len(counts) < across * down):
        _refuse(name, "a compressed TIFF without a byte count for each strip or tile")
    if compression == NONE and (cw, ch) == (width, height):
        offsets = offsets[-1:]  # PIL: a strip or tile that covers the image reads from the last offset
    row_bytes = (cw * spp * depth + 7) // 8
    tables = bytes(tags.get(JPEG_TABLES, ()))
    canvas = np.zeros((down * ch, across * row_bytes), np.uint8)
    for i in range(across * down):
        x, y = i % across, (i // across) * ch
        rows = min(ch, height - y) if (compression == NONE or not tiled) else ch
        size = rows * row_bytes
        off = offsets[i]
        if compression == NONE:  # PIL's raw decoder: the rows in the image, from the offset
            chunk = np.frombuffer(data, np.uint8, min(size, max(len(data) - off, 0)), min(off, len(data)))
            if len(chunk) < size:
                _refuse(name, f"truncated TIFF data (strip or tile {i})")
        else:
            coded = data[off:off + counts[i]]
            if len(coded) < counts[i]:
                _refuse(name, f"truncated TIFF data (strip or tile {i} lies past the end of the file)")
            where = f"{name}: strip or tile {i}"
            if compression == JPEG:
                chunk = jpeg.decode_tiff_jpeg(tables, coded, rows, cw, spp, where).reshape(-1)
            else:
                chunk = _decompress(coded, size, compression, where)
        chunk = chunk.reshape(rows, row_bytes)
        if predictor == 2:
            chunk = _undifference(chunk, cw, spp, order + ("u2" if depth == 16 else "u1"))
        canvas[y:y + rows, x * row_bytes:(x + 1) * row_bytes] = chunk
    return canvas[:height, :(width * spp * depth + 7) // 8]


def _decompress(coded: bytes, size: int, compression: int, name: str) -> np.ndarray:
    if compression == LZW:
        return image_codecs.lzw_decode(coded, size, name)
    if compression == PACKBITS:
        return image_codecs.packbits_decode(coded, size, name)
    try:
        out = zlib.decompressobj().decompress(coded, size)
    except zlib.error as err:
        raise ValueError(f"{name}: corrupt deflate data ({err})") from None
    if len(out) < size:
        raise ValueError(f"{name}: deflate data ends {size - len(out)} bytes short of its strip or tile")
    return np.frombuffer(out, np.uint8)


def _undifference(chunk: np.ndarray, cw: int, spp: int, dtype: str) -> np.ndarray:
    """Predictor 2: each sample plus the one of the pixel to its left, along
    each row, in the sample's own unsigned arithmetic (a cumulative sum that
    wraps as libtiff's does); 16-bit samples in the file's byte order."""
    rows = len(chunk)
    values = chunk.view(dtype).reshape(rows, cw, spp)
    summed = np.cumsum(values, axis=1, dtype=values.dtype.newbyteorder("="))
    return summed.astype(dtype).view(np.uint8).reshape(rows, -1)
