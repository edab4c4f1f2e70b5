"""TIFF reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL, which reads a TIFF's
first image (frame 0) with its TiffImagePlugin: uncompressed strips and
tiles by its own raw decoder, everything compressed through libtiff. This
is the port's reader of the forms photogrammetry and capture tools write,
returning an `image_io.Picture`:

- classic TIFF in either byte order ("II" and "MM") and little-endian
  BigTIFF ("II+", 20-byte IFD entries, LONG8 offsets; PIL reads a
  big-endian one's header as a classic TIFF's and finds no image), the
  first IFD, strips (the last one short) and tiles (cropped where they
  overhang);
- `PlanarConfiguration` 1, and 2 (each sample's strips or tiles in turn)
  where PIL reads the layout in planes as the picture (`PLANAR_READS`):
  8-bit RGB, RGBA and CMYK in every coding (uncompressed, PIL's raw
  decoder reads each plane from its own offsets), 16-bit ones and
  associated alpha compressed (libtiff), unspecified extra samples in
  compressed tiles;
- compression none (1), PackBits (32773), LZW (5, libtiff's new style),
  deflate (8, 32946), LZMA (34925: one .xz stream a strip, by the
  standard library's liblzma, as libtiff's LZMADecode reads it), ZSTD
  (50000: Zstandard frames as libtiff's ZSTDDecode reads them, by the
  compiled decoder `csrc/zstd_decode.cc`, `utils/zstd.py`) and JPEG (7:
  8-bit samples, each strip or tile a JPEG stream after the JPEGTables
  tag's tables, decoded by the compiled JPEG decoder as libtiff decodes
  it, `utils/jpeg.decode_tiff_jpeg`: with no colour conversion, or in
  YCbCr (photometric 6, 3 samples) converted to RGB with libjpeg's
  upsampling, as libtiff's JPEGCOLORMODE_RGB gives it to PIL, the
  subsampling from the YCbCrSubsampling tag or, without it, from the
  first strip's frame (libtiff's JPEGFixupTagsSubsampling)); `Predictor`
  2 (horizontal differencing per sample, 8 and 16 bits, in the sample's
  own unsigned arithmetic) under LZW, deflate, LZMA and ZSTD, where
  libtiff applies it;
- photometric WhiteIsZero (0: "1" and "L" inverted; 16 bits "I;16" as
  stored, as PIL reads it), BlackIsZero (1), RGB (2), palette (3, the
  ColorMap's high bytes), CMYK (5) and YCbCr under JPEG (6, mode "RGB");
- 1, 8 and 16 bits a sample, in PIL's modes: "1", "L", "I;16" (little
  endian) / "I;16B" (big endian), "LA", "RGB", "RGBA", "P", "CMYK"; 16-bit
  RGB, RGBA and CMYK as their high bytes;
- ExtraSamples: unassociated alpha (2) gives "RGBA" / "LA", associated
  alpha (1) "RGBA" divided back as PIL's "RGBa" unpacker divides, an
  unspecified sample (0) is dropped;
- the Orientation tag (274) applied after decoding, as PIL's TIFF loader
  does (`ImageOps.exif_transpose`).

LZW and PackBits run in compiled host C++ (`utils/image_codecs`), JPEG
and ZSTD in their compiled decoders, deflate in zlib, LZMA in lzma, the
rest in numpy. Everything else raises a `ValueError` naming the file and
the feature: old-style JPEG (6), CCITT (2, 3, 4), WebP (which PIL's
libtiff is built without) and the other compressions; old-style LZW;
`Predictor` 3; the planar layouts PIL does not read as the picture
(16-bit uncompressed planes, which it reads as 8-bit; grey + alpha
planes; associated alpha or unspecified samples in uncompressed planes;
RGBA without ExtraSamples in compressed planes, which it reads as
associated alpha); `FillOrder` 2; signed and floating-point samples;
YCbCr without JPEG, CIELab and other photometrics; depths other than 1,
8 and 16; layouts PIL does not know; corrupt or truncated data (where
libtiff reports an error, PIL raises). An image over PIL's
decompression-bomb limit raises too.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
import zlib

import numpy as np

from gaussian_splatting_torch.utils import image_codecs, jpeg, zstd

MAX_PIXELS = 2 * 89478485  # PIL raises DecompressionBombError past this
SIGNATURES = (b"II*\x00", b"MM\x00*", b"II\x00*", b"MM*\x00", b"II+\x00", b"MM\x00+")  # PIL's prefixes
SUPPORTED = ("the port reads classic and little-endian BigTIFF, uncompressed, PackBits, LZW, deflate, LZMA, ZSTD "
             "or JPEG (YCbCr included), 1, 8 or 16 bits, grey, RGB(A), palette or CMYK, in planes where PIL reads "
             "them as the picture")

# tags
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILL_ORDER, STRIP_OFFSETS = 256, 257, 258, 259, 262, 266, 273
ORIENTATION, SAMPLES, ROWS_PER_STRIP, STRIP_COUNTS, PLANAR, PREDICTOR = 274, 277, 278, 279, 284, 317
COLORMAP, TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS, EXTRA, SAMPLE_FORMAT = (
    320, 322, 323, 324, 325, 338, 339)
OFFSET_TAGS = (STRIP_OFFSETS, STRIP_COUNTS, TILE_OFFSETS, TILE_COUNTS)
JPEG_TABLES, YCBCR_SUBSAMPLING = 347, 530  # JPEGTables: UNDEFINED, kept as bytes
# integer field types PIL keeps: byte, short, long, sbyte, sshort, slong,
# long8; libtiff, which reads the compressed forms for PIL, also takes
# slong8 for the strip and tile offsets and counts (not ifd8)
_INT_TYPES = {1: "u1", 3: "u2", 4: "u4", 6: "i1", 8: "i2", 9: "i4", 16: "u8"}
_LIBTIFF_TYPES = {17: "i8"}

NONE, LZW, JPEG, DEFLATE, ADOBE_DEFLATE, PACKBITS, LZMA, ZSTD = 1, 5, 7, 32946, 8, 32773, 34925, 50000
COMPRESSIONS = (NONE, LZW, JPEG, DEFLATE, ADOBE_DEFLATE, PACKBITS, LZMA, ZSTD)
REFUSED_COMPRESSION = {
    2: "CCITT modified Huffman (compression 2)", 3: "CCITT Group 3 (compression 3)",
    4: "CCITT Group 4 (compression 4)", 6: "old-style JPEG-in-TIFF (compression 6)",
    32771: "16-bit padded raw data (compression 32771)",
    32809: "ThunderScan (compression 32809)", 34676: "SGILog (compression 34676)",
    34677: "SGILog24 (compression 34677)",
    50001: "WebP (compression 50001), which PIL refuses too (its libtiff is built without WebP)",
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
YCBCR_LAYOUT = ((6, (8,) * 3, ()), ("RGB", "take"))  # under JPEG: libtiff converts to RGB
# PlanarConfiguration 2: where PIL reads a layout in planes as the picture,
# uncompressed (its raw decoder, each plane by `rawmode[layer]`) or
# compressed (libtiff and PIL's per-band unpackers), in strips or tiles;
# unspecified samples it reads only from compressed tiles
_EVERY = {(coded, kind) for coded in ("uncompressed", "compressed") for kind in ("strips", "tiles")}
_COMPRESSED = {("compressed", "strips"), ("compressed", "tiles")}
PLANAR_READS = {(2, (8,) * 3, ()): _EVERY, (2, (8,) * 4, (2,)): _EVERY, (2, (8,) * 4, (999,)): _EVERY,
                (5, (8,) * 4, ()): _EVERY, (2, (8,) * 4, ()): {("uncompressed", "strips")},
                (2, (8,) * 4, (1,)): _COMPRESSED}
for _key in LAYOUTS:
    if _key[1][0] == 16 and _key[0] in (2, 5) and _key[2] in ((), (1,), (2,)) and _key != (2, (16,) * 4, ()):
        PLANAR_READS[_key] = _COMPRESSED
    elif _key[0] in (2, 5) and 0 in _key[2]:
        PLANAR_READS[_key] = {("compressed", "tiles")}


def _refuse(name, what: str):
    raise ValueError(f"{name}: {what}; {SUPPORTED}")


def open_tiff(path):
    """The `image_io.Picture` of a TIFF file."""
    with open(path, "rb") as f:
        return decode_tiff(f.read(), str(path))


def _tags(data: bytes, name: str):
    """(byte order, {tag: tuple of ints}, {tag: field type}, BigTIFF header
    fault or None) of the first IFD. Tags of other types, and tags whose
    data lies past the file, are left out, as PIL leaves them out; the
    offsets and counts of strips and tiles are kept in libtiff's types
    too. PIL takes only "II+" for BigTIFF (its header check reads byte 2),
    so "MM" with 43 is read as a classic TIFF, as PIL reads it."""
    order = "<" if data[:2] == b"II" else ">"
    big = data[:4] == b"II+\x00"
    head = 16 if big else 8
    if len(data) < head:
        _refuse(name, "a truncated TIFF header")
    endian = "little" if order == "<" else "big"
    fault = None
    if big:
        at = int.from_bytes(data[8:16], endian)
        if data[4:8] != b"\x08\x00\x00\x00":  # libtiff: offset size 8, then a 0 word
            fault = f"a BigTIFF header with offset size {int.from_bytes(data[4:6], endian)} and word " \
                    f"{int.from_bytes(data[6:8], endian)} (libtiff: Invalid BigTIFF header)"
    else:
        at = int.from_bytes(data[4:8], endian)
    count_size, entry, inline = (8, 20, 8) if big else (2, 12, 4)
    if at + count_size > len(data):
        _refuse(name, "a TIFF whose first IFD lies past the end of the file")
    n = int.from_bytes(data[at:at + count_size], endian)
    if at + count_size + entry * n > len(data):
        _refuse(name, f"a truncated {'BigTIFF' if big else 'TIFF'} IFD")
    entries = np.frombuffer(data, np.dtype([("tag", order + "u2"), ("type", order + "u2"),
                                            ("count", order + ("u8" if big else "u4")), ("value", f"V{inline}")]),
                            n, at + count_size)
    tags, types = {}, {}
    for tag, typ, count, value in entries.tolist():
        if tag == JPEG_TABLES and typ == 7:  # UNDEFINED bytes
            typ = 1
        elif count == 0 or not (typ in _INT_TYPES or (typ in _LIBTIFF_TYPES and tag in OFFSET_TAGS)):
            continue
        kind = _INT_TYPES.get(typ) or _LIBTIFF_TYPES[typ]
        size = count * int(kind[1])
        if size <= inline:
            raw = bytes(value)[:size]
        else:
            where = int.from_bytes(bytes(value), endian)
            raw = data[where:where + size]
            if len(raw) != size:
                continue
        tags[tag] = tuple(np.frombuffer(raw, order + kind, count).tolist())
        types[tag] = typ
    return order, tags, types, fault


def decode_tiff(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of the first image of TIFF bytes: PIL's pixels
    (with a channel axis) and mode, and the palette of mode "P"."""
    from gaussian_splatting_torch.utils.image_io import Picture

    if not data.startswith(SIGNATURES):
        _refuse(name, "not a TIFF file (no TIFF signature)")
    order, tags, types, header_fault = _tags(data, name)

    def one(tag, default=None):
        return tags[tag][0] if tag in tags else default

    compression = one(COMPRESSION, NONE)
    if compression in REFUSED_COMPRESSION:
        _refuse(name, REFUSED_COMPRESSION[compression])
    if compression not in COMPRESSIONS:
        _refuse(name, f"TIFF compression {compression}")
    if header_fault and compression != NONE:  # libtiff opens the compressed forms for PIL
        _refuse(name, header_fault)
    if compression == NONE:  # PIL's raw decoder reads the offsets PIL's own parser keeps
        for tag in OFFSET_TAGS:
            if types.get(tag) in _LIBTIFF_TYPES:
                del tags[tag]
    photo = one(PHOTOMETRIC, 0)
    if (photo in REFUSED_PHOTOMETRIC and not (photo == 6 and compression == JPEG)) or photo not in (0, 1, 2, 3, 5, 6):
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
    planar = spp > 1 and one(PLANAR, 1) == 2
    if any(b not in (1, 8, 16) for b in bits) or len(set(bits)) > 1:
        _refuse(name, f"{'/'.join(map(str, bits))}-bit samples")
    depth = bits[0]
    if compression == JPEG and depth != 8:
        _refuse(name, f"JPEG-in-TIFF at {depth} bits a sample (libtiff reads 8)")
    key = (photo, bits, extra)
    layout = YCBCR_LAYOUT[1] if key == YCBCR_LAYOUT[0] else LAYOUTS.get(key)
    if layout is None or (depth == 16 and photo == 0 and order == ">"):
        _refuse(name, f"photometric {photo} with {'/'.join(map(str, bits))} bits and extra samples "
                      f"{extra} (a layout PIL does not read as the port does)")
    if planar:
        coded = "uncompressed" if compression == NONE else "compressed"
        kind = "tiles" if TILE_OFFSETS in tags else "strips"
        if (coded, kind) not in PLANAR_READS.get(key, ()):
            _refuse(name, _planar_fault(key, coded, kind))
    mode, how = layout
    if mode == "I;16" and order == ">":
        mode = "I;16B"
    predictor = one(PREDICTOR, 1) if compression in (LZW, DEFLATE, ADOBE_DEFLATE, LZMA, ZSTD) else 1
    if predictor == 3:
        _refuse(name, "Predictor 3 (floating-point differencing)")
    if predictor not in (1, 2) or (predictor == 2 and depth == 1):
        _refuse(name, f"Predictor {predictor} at {depth} bits (libtiff refuses it)")

    chunks = _Chunks(data, name, tags, compression, width, height, spp, depth, planar)
    ycbcr = _ycbcr_subsampling(data, tags, chunks) if photo == 6 else None
    canvas = _samples(data, name, chunks, order, compression, predictor, ycbcr, tags)
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


def _planar_fault(key, coded: str, kind: str) -> str:
    """Why a layout in planes (PlanarConfiguration 2) is refused: PIL
    raises on it, or reads it as other pixels than the picture."""
    photo, bits, extra = key
    where = f"{coded} planes (PlanarConfiguration 2, {kind})"
    if photo == 1 and extra == (2,):
        return f"grey + alpha in {where}, which PIL reads as other pixels than the picture or refuses (unknown " \
               f"raw mode)"
    if photo == 6:
        return f"YCbCr JPEG-in-TIFF in {where} (PIL: decoder error)"
    if coded == "uncompressed" and bits[0] == 16:
        return f"16-bit samples in {where}, which PIL's raw decoder reads as 8-bit"
    if coded == "uncompressed" and extra[:1] == (1,):
        return f"associated alpha in {where} (PIL: unknown raw mode)"
    if photo == 2 and extra == () and len(bits) == 4:
        return f"RGBA without ExtraSamples in {where}, which PIL reads as other pixels than the picture"
    return f"photometric {photo} with {'/'.join(map(str, bits))} bits and extra samples {extra} in {where}, which " \
           f"PIL does not read as the picture"


class _Chunks:
    """The strips or tiles of an image: their size (`cw` x `ch`), how many
    across and down, and each one's offset and byte count; with
    PlanarConfiguration 2, `planes` runs of `across * down` of them, one
    sample each."""

    def __init__(self, data, name, tags, compression, width, height, spp, depth, planar):
        self.tiled = TILE_OFFSETS in tags
        if self.tiled:
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
        self.planes = spp if planar else 1
        self.across, self.down = math.ceil(width / cw), math.ceil(height / ch)
        n = self.across * self.down * self.planes
        if len(offsets) < n:
            _refuse(name, f"{len(offsets)} strip or tile offsets for {n} strips or tiles")
        if compression != NONE and (counts is None or len(counts) < n):
            _refuse(name, "a compressed TIFF without a byte count for each strip or tile")
        if compression == NONE and (cw, ch) == (width, height) and not planar:
            offsets = offsets[-1:]  # PIL: a strip or tile that covers the image reads from the last offset
        self.cw, self.ch, self.offsets, self.counts = cw, ch, offsets, counts
        self.width, self.height, self.depth = width, height, depth
        self.spp = 1 if planar else spp  # samples in each strip or tile


def _ycbcr_subsampling(data, tags, chunks):
    """(horizontal, vertical) chroma subsampling of a YCbCr JPEG-in-TIFF as
    libtiff takes it: the YCbCrSubsampling tag's (a tag whose count is not
    2 is dropped), else component 0's sampling factors in the first strip's
    or tile's frame (JPEGFixupTagsSubsampling), else TIFF's default 2x2."""
    if len(tags.get(YCBCR_SUBSAMPLING, ())) == 2:
        return tags[YCBCR_SUBSAMPLING]
    off = chunks.offsets[0]
    first = data[off:off + chunks.counts[0]] if off else b""
    return _frame_subsampling(first, 3) or (2, 2)


def _frame_subsampling(stream: bytes, spp: int):
    """JPEGFixupTagsSubsamplingSec: walk the markers of `stream` to its
    first frame header and give component 0's (h, v) where every other
    component is sampled 1x1 and h and v are 1, 2 or 4, else None."""
    at, n = 0, len(stream)
    while True:
        while at < n and stream[at] != 0xFF:
            at += 1
        while at < n and stream[at] == 0xFF:
            at += 1
        if at >= n:
            return None
        marker = stream[at]
        at += 1
        if marker == 0xD8:  # SOI
            continue
        if at + 2 > n:
            return None
        length = (stream[at] << 8) | stream[at + 1]
        at += 2
        if marker in (0xC4, 0xDA, 0xDB, 0xDD, 0xFE) or 0xE0 <= marker <= 0xEF:
            if length < 2:
                return None
            at += length - 2
            continue
        if marker not in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA) or length != 8 + 3 * spp or at + 6 + 3 * spp > n:
            return None
        comps = stream[at + 6:at + 6 + 3 * spp]
        h, v = comps[1] >> 4, comps[1] & 15
        if any(comps[3 * i + 1] != 0x11 for i in range(1, spp)) or h not in (1, 2, 4) or v not in (1, 2, 4):
            return None
        return h, v


def _samples(data, name, chunks, order, compression, predictor, ycbcr, tags) -> np.ndarray:
    """(height, row bytes) of the image's decoded sample bytes, pixel
    interleaved: the strips or tiles decoded (and un-differenced) one by
    one and put in place; planes (PlanarConfiguration 2) decoded each into
    its own canvas and interleaved."""
    c = chunks
    width, height, depth = c.width, c.height, c.depth
    row_bytes = (c.cw * c.spp * depth + 7) // 8
    tables = bytes(tags.get(JPEG_TABLES, ()))
    per_plane = c.across * c.down
    planes = []
    for plane in range(c.planes):
        canvas = np.zeros((c.down * c.ch, c.across * row_bytes), np.uint8)
        for j in range(per_plane):
            i = plane * per_plane + j
            x, y = j % c.across, (j // c.across) * c.ch
            rows = min(c.ch, height - y) if (compression == NONE or not c.tiled) else c.ch
            size = rows * row_bytes
            off = c.offsets[i]
            if compression == NONE:  # PIL's raw decoder: the rows in the image, from the offset
                chunk = np.frombuffer(data, np.uint8, min(size, max(len(data) - off, 0)), min(off, len(data)))
                if len(chunk) < size:
                    _refuse(name, f"truncated TIFF data (strip or tile {i})")
            else:
                coded = data[off:off + c.counts[i]]
                if len(coded) < c.counts[i]:
                    _refuse(name, f"truncated TIFF data (strip or tile {i} lies past the end of the file)")
                where = f"{name}: strip or tile {i}"
                if compression == JPEG:
                    last = not c.tiled and j == per_plane - 1  # libtiff takes a taller frame in the last strip
                    chunk = jpeg.decode_tiff_jpeg(tables, coded, rows, c.cw, c.spp, where, ycbcr, last).reshape(-1)
                else:
                    chunk = _decompress(coded, size, compression, where)
            chunk = chunk.reshape(rows, row_bytes)
            if predictor == 2:
                chunk = _undifference(chunk, c.cw, c.spp, order + ("u2" if depth == 16 else "u1"))
            canvas[y:y + rows, x * row_bytes:(x + 1) * row_bytes] = chunk
        planes.append(canvas[:height, :(width * c.spp * depth + 7) // 8])
    if len(planes) == 1:
        return planes[0]
    unit = np.uint16 if depth == 16 else np.uint8  # interleave whole samples, in the file's byte order
    return np.stack([p.view(unit) for p in planes], -1).view(np.uint8).reshape(height, -1)


def _decompress(coded: bytes, size: int, compression: int, name: str) -> np.ndarray:
    if compression == LZW:
        return image_codecs.lzw_decode(coded, size, name)
    if compression == PACKBITS:
        return image_codecs.packbits_decode(coded, size, name)
    if compression == ZSTD:
        return zstd.decode_tiff_zstd(coded, size, name)
    if compression == LZMA:
        return _lzma(coded, size, name)
    try:
        out = zlib.decompressobj().decompress(coded, size)
    except zlib.error as err:
        raise ValueError(f"{name}: corrupt deflate data ({err})") from None
    if len(out) < size:
        raise ValueError(f"{name}: deflate data ends {size - len(out)} bytes short of its strip or tile")
    return np.frombuffer(out, np.uint8)


class _LzmaStream(ctypes.Structure):
    """liblzma's lzma_stream (lzma/base.h), its reserved fields included."""
    _fields_ = [("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_size_t), ("total_in", ctypes.c_uint64),
                ("next_out", ctypes.c_void_p), ("avail_out", ctypes.c_size_t), ("total_out", ctypes.c_uint64),
                ("allocator", ctypes.c_void_p), ("internal", ctypes.c_void_p), ("reserved", ctypes.c_void_p * 4),
                ("seek_pos", ctypes.c_uint64), ("reserved_int", ctypes.c_uint64 * 3),
                ("reserved_enum", ctypes.c_int * 2)]


LZMA_OK, LZMA_STREAM_END, LZMA_BUF_ERROR = 0, 1, 10  # BUF_ERROR: no progress, the input spent
LZMA_ERRORS = {5: "out of memory", 6: "memory limit reached", 7: "not an .xz stream", 8: "unsupported options",
               9: "corrupt data", 11: "programming error"}


@functools.cache
def _liblzma():
    """The liblzma the standard library's `lzma` module is built on (already
    loaded with it), its decoder entry points typed."""
    import _lzma  # noqa: F401  (loads liblzma into the process)

    lib = ctypes.CDLL(ctypes.util.find_library("lzma") or "liblzma.so.5")
    lib.lzma_stream_decoder.argtypes = [ctypes.POINTER(_LzmaStream), ctypes.c_uint64, ctypes.c_uint32]
    lib.lzma_code.argtypes = [ctypes.POINTER(_LzmaStream), ctypes.c_int]
    lib.lzma_end.argtypes = [ctypes.POINTER(_LzmaStream)]
    lib.lzma_stream_decoder.restype = lib.lzma_code.restype = ctypes.c_int
    lib.lzma_end.restype = None
    return lib


def _lzma(coded: bytes, size: int, name: str) -> np.ndarray:
    """libtiff's LZMADecode, on the standard library's liblzma: one .xz
    stream decoder (no concatenated streams, no memory limit), called
    until the strip or tile is full; an error or the stream's end before
    that raises. An error reported by the call that fills the strip (its
    block check, say) is one libtiff prints and PIL reads past, as it
    stops at a full strip before anything later."""
    lib = _liblzma()
    stream = _LzmaStream()
    if lib.lzma_stream_decoder(ctypes.byref(stream), 2**64 - 1, 0) != LZMA_OK:
        raise RuntimeError(f"{name}: liblzma could not start a stream decoder")
    out = np.empty(size, np.uint8)
    src = ctypes.create_string_buffer(coded, len(coded))
    stream.next_in, stream.avail_in = ctypes.addressof(src), len(coded)
    stream.next_out, stream.avail_out = out.ctypes.data, size
    error = None
    try:
        while stream.avail_out > 0:
            ret = lib.lzma_code(ctypes.byref(stream), 0)  # LZMA_RUN
            if ret in (LZMA_STREAM_END, LZMA_BUF_ERROR):
                break
            if ret != LZMA_OK:
                error = LZMA_ERRORS.get(ret, f"liblzma error {ret}")
                break
    finally:
        lib.lzma_end(ctypes.byref(stream))
    if stream.avail_out:
        why = f"corrupt LZMA data ({error})" if error else "LZMA data ends short"
        raise ValueError(f"{name}: {why}: {stream.avail_out} bytes short of its strip or tile")
    return out


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


def _undifference(chunk: np.ndarray, cw: int, spp: int, dtype: str) -> np.ndarray:
    """Predictor 2: each sample plus the one of the pixel to its left, along
    each row, in the sample's own unsigned arithmetic (a cumulative sum that
    wraps as libtiff's does); 16-bit samples in the file's byte order."""
    rows = len(chunk)
    values = chunk.view(dtype).reshape(rows, cw, spp)
    summed = np.cumsum(values, axis=1, dtype=values.dtype.newbyteorder("="))
    return summed.astype(dtype).view(np.uint8).reshape(rows, -1)
