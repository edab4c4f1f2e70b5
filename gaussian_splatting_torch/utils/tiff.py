"""TIFF reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL, which reads a TIFF's
first image (frame 0) with its TiffImagePlugin: uncompressed strips and
tiles by its own raw decoder and raw modes, everything compressed through
libtiff. This is the port's reader of every TIFF PIL 12.1.0 (libtiff
4.7.1) reads, returning an `image_io.Picture`:

- classic TIFF in either byte order ("II" and "MM") and little-endian
  BigTIFF ("II+", 20-byte IFD entries, LONG8 offsets; PIL reads a
  big-endian one's header as a classic TIFF's and finds no image), the
  first IFD, strips (the last one short) and tiles (cropped where they
  overhang);
- every layout key of PIL's OPEN_INFO (`LAYOUTS`, `SAMPLE_LAYOUTS`): 1, 2,
  4, 8, 12 (mode "I;16"), 16 and 32 (mode "I") bits, unsigned, signed
  (SampleFormat 2: 8 bits "L" as stored, 16 and 32 "I") and float32
  (SampleFormat 3: "F"); grey (2- and 4-bit scaled as PIL's unpackers
  scale), RGB(A), palette ("P" at 1 to 8 bits, palette + alpha "PA"),
  CMYK, YCbCr and CIELab ("LAB", the samples as stored); 16-bit RGB, RGBA
  and CMYK as their high bytes; "MM" signed and float samples through
  libtiff come out byte-swapped, as PIL unpacks libtiff's host-order
  samples with the file's raw mode; layouts PIL has in "II" only
  (`LITTLE_ENDIAN_ONLY`) refused in "MM";
- FillOrder 2 where OPEN_INFO has the layout (`FILL_ORDER_2`): each byte's
  bits reversed (PIL's raw modes; libtiff reverses the coded bytes), but
  uncompressed in the four raw modes PIL has no unpacker for
  (`FILL_ORDER_2_UNPACKED`);
- `PlanarConfiguration` 1, and 2 (each sample's strips or tiles in turn)
  where PIL reads the layout in planes as the picture (`PLANAR_READS`),
  YCbCr at 1x1 too;
- compression none (1), PackBits (32773), LZW (5, new style and libtiff's
  old style, codes least significant bit first), deflate (8, 32946), LZMA
  (34925: one .xz stream a strip, by the standard library's liblzma, as
  libtiff's LZMADecode reads it), ZSTD (50000: `utils/zstd.py`), JPEG (7:
  `jpeg.decode_tiff_jpeg`, libtiff's JPEG codec; YCbCr with libjpeg's
  conversion), old-style JPEG (6: `utils/ojpeg.py`), CCITT modified
  Huffman (2), Group 3 (3), Group 4 (4) and 32771 (`utils/fax.py`, the
  compiled `csrc/fax_decode.cc`), ThunderScan (32809); `Predictor` 2
  (horizontal differencing in the sample's own unsigned arithmetic, 8, 16
  and 32 bits) and 3 (libtiff's floating-point differencing) under LZW,
  deflate, LZMA and ZSTD, where libtiff applies them;
- YCbCr (photometric 6) without JPEG through libtiff's RGBA reader
  (`utils/tiff_ycbcr.py`: data units at every subsampling it has a routine
  for, TIFF's YCbCr -> RGB), uncompressed through PIL's raw mode RGBX (four
  bytes a pixel); old-style JPEG the same way (PIL reads it as YCbCr);
- ExtraSamples: unassociated alpha (2) gives "RGBA" / "LA" / "PA",
  associated alpha (1) "RGBA" divided back as PIL's "RGBa" unpacker
  divides, an unspecified sample (0) is dropped;
- the Orientation tag (274) applied after decoding, as PIL's TIFF loader
  does (`ImageOps.exif_transpose`).

LZW, PackBits and ThunderScan run in compiled host C++
(`utils/image_codecs`), CCITT in its own (`utils/fax`), JPEG and ZSTD in
their compiled decoders, deflate in zlib, LZMA in lzma, the rest in numpy.
Everything PIL refuses raises a `ValueError` naming the file and the
feature: SGILog and SGILog24, WebP (which PIL's libtiff is built without),
the photometrics and layouts PIL has no key for, 64-bit and RGB floats,
big-endian BigTIFF, the planar layouts PIL does not read as the picture,
corrupt or truncated data where libtiff reports an error and PIL raises.
Two readings PIL makes of damaged fax data are refused too: a Group 4
strip that ends before its last row (PIL's pixels there are whatever its
strip buffer held) and a Group 3 strip that does (libtiff's recovery past
the data's end is not followed). An image over PIL's decompression-bomb
limit raises too.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
import zlib

import numpy as np

from gaussian_splatting_torch.utils import fax, image_codecs, jpeg, ojpeg, tiff_ycbcr, zstd

MAX_PIXELS = 2 * 89478485  # PIL raises DecompressionBombError past this
SIGNATURES = (b"II*\x00", b"MM\x00*", b"II\x00*", b"MM*\x00", b"II+\x00", b"MM\x00+")  # PIL's prefixes
SUPPORTED = ("the port reads every TIFF PIL reads: classic and little-endian BigTIFF, uncompressed, PackBits, LZW "
             "(old style too), deflate, LZMA, ZSTD, JPEG, old-style JPEG, CCITT (modified Huffman, Group 3, Group 4, "
             "32771) or ThunderScan, every layout of PIL's OPEN_INFO (1 to 32 bits, signed and float samples, "
             "FillOrder 2, grey, RGB(A), palette (+ alpha), CMYK, YCbCr, CIELab), in planes where PIL reads them as "
             "the picture")

# tags
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILL_ORDER, STRIP_OFFSETS = 256, 257, 258, 259, 262, 266, 273
ORIENTATION, SAMPLES, ROWS_PER_STRIP, STRIP_COUNTS, PLANAR, PREDICTOR = 274, 277, 278, 279, 284, 317
COLORMAP, TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS, EXTRA, SAMPLE_FORMAT = (
    320, 322, 323, 324, 325, 338, 339)
OFFSET_TAGS = (STRIP_OFFSETS, STRIP_COUNTS, TILE_OFFSETS, TILE_COUNTS)
JPEG_TABLES, YCBCR_SUBSAMPLING = 347, 530  # JPEGTables: UNDEFINED, kept as bytes
YCBCR_COEFFICIENTS, REFERENCE_BLACK_WHITE = 529, 532  # RATIONAL, kept as float32
# integer field types PIL keeps: byte, short, long, sbyte, sshort, slong,
# long8; libtiff, which reads the compressed forms for PIL, also takes
# slong8 for the strip and tile offsets and counts (not ifd8)
_INT_TYPES = {1: "u1", 3: "u2", 4: "u4", 6: "i1", 8: "i2", 9: "i4", 16: "u8"}
_LIBTIFF_TYPES = {17: "i8"}

NONE, LZW, JPEG, DEFLATE, ADOBE_DEFLATE, PACKBITS, LZMA, ZSTD = 1, 5, 7, 32946, 8, 32773, 34925, 50000
CCITT_RLE, CCITT_G3, CCITT_G4, OJPEG, CCITT_RLEW, THUNDERSCAN = 2, 3, 4, 6, 32771, 32809
FAX = (CCITT_RLE, CCITT_G3, CCITT_G4, CCITT_RLEW)
COMPRESSIONS = (NONE, LZW, JPEG, DEFLATE, ADOBE_DEFLATE, PACKBITS, LZMA, ZSTD, OJPEG, THUNDERSCAN) + FAX
REFUSED_COMPRESSION = {
    34676: "SGILog (compression 34676), which PIL refuses too (no layout for its LogL / LogLuv photometrics)",
    34677: "SGILog24 (compression 34677), which PIL refuses too (no layout for its LogLuv photometric)",
    50001: "WebP (compression 50001), which PIL refuses too (its libtiff is built without WebP)",
}
REFUSED_PHOTOMETRIC = {4: "a transparency mask (photometric 4), which PIL refuses too (no layout)",
                       9: "ICCLab (photometric 9), which PIL refuses too (no layout)",
                       10: "ITULab (photometric 10), which PIL refuses too (no layout)",
                       32844: "LogL (photometric 32844), which PIL refuses too (no layout)",
                       32845: "LogLuv (photometric 32845), which PIL refuses too (no layout)"}
# (photometric, bits per sample, extra samples) -> (PIL's mode, how the
# samples become it): the keys of PIL's OPEN_INFO with SampleFormat 1
LAYOUTS = {
    (0, (1,), ()): ("1", "invert"), (1, (1,), ()): ("1", "grey"),
    (0, (2,), ()): ("L", "invert"), (1, (2,), ()): ("L", "scale"),
    (0, (4,), ()): ("L", "invert"), (1, (4,), ()): ("L", "scale"),
    (0, (8,), ()): ("L", "invert"), (1, (8,), ()): ("L", "grey"),
    (1, (12,), ()): ("I;16", "grey"),
    (0, (16,), ()): ("I;16", "grey"), (1, (16,), ()): ("I;16", "grey"),
    (1, (32,), ()): ("I", "grey"),
    (1, (8, 8), (2,)): ("LA", "take"),
    (3, (1,), ()): ("P", "take"), (3, (2,), ()): ("P", "take"), (3, (4,), ()): ("P", "take"),
    (3, (8,), ()): ("P", "take"), (3, (8, 8), (0,)): ("P", "take"), (3, (8, 8), (2,)): ("PA", "take"),
    (6, (8,), ()): ("L", "grey"), (8, (8,) * 3, ()): ("LAB", "take"),
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
YCBCR_LAYOUT = ((6, (8,) * 3, ()), ("RGB", "take"))  # libtiff converts to RGB (JPEG, or its RGBA reader)
# (photometric, SampleFormat, bits) -> PIL's mode: the signed (2) and
# floating-point (3) keys of OPEN_INFO, one sample; signed 8-bit is "L" as
# stored
SAMPLE_LAYOUTS = {(1, 2, 8): "L", (1, 2, 16): "I", (1, 2, 32): "I", (1, 3, 32): "F", (0, 3, 32): "F"}
# layouts OPEN_INFO has in "II" order only
LITTLE_ENDIAN_ONLY = {(0, (16,), ()), (1, (12,), ()), (1, (32,), ())}
# FillOrder 2: the keys OPEN_INFO has (PIL reads them as FillOrder 1 with
# each byte's bits reversed), and among them those whose raw mode PIL's raw
# decoder has no unpacker for (it reads an uncompressed one of them not)
FILL_ORDER_2 = {(p, (b,), ()) for p in (0, 1, 3) for b in (1, 2, 4, 8)} | {(1, (16,), ()), (2, (8,) * 3, ())}
FILL_ORDER_2_UNPACKED = {(0, (8,), ()), (3, (1,), ()), (3, (2,), ()), (3, (4,), ())}
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
        if tag in (YCBCR_COEFFICIENTS, REFERENCE_BLACK_WHITE) and typ in (5, 11) and count:  # libtiff's floats
            size = count * (8 if typ == 5 else 4)
            where = int.from_bytes(bytes(value), endian) if size > inline else None
            raw = bytes(value)[:size] if where is None else data[where:where + size]
            if len(raw) == size:
                if typ == 5:
                    nd = np.frombuffer(raw, order + "u4").astype(np.float32).reshape(-1, 2)
                    tags[tag] = tuple(np.where(nd[:, 1] == 0, np.float32(0), nd[:, 0] / np.where(
                        nd[:, 1] == 0, np.float32(1), nd[:, 1])).astype(np.float32).tolist())
                else:
                    tags[tag] = tuple(np.frombuffer(raw, order + "f4").tolist())
                types[tag] = typ
            continue
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
    (with a channel axis) and mode, and the palette of modes "P" and "PA"."""
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
    if compression == OJPEG and one(PHOTOMETRIC, 0) not in (2, 6):
        _refuse(name, f"old-style JPEG with photometric {one(PHOTOMETRIC, 0)} (libtiff's RGBA reader fails it: PIL "
                      f"raises)")
    photo = 6 if compression == OJPEG else one(PHOTOMETRIC, 0)  # PIL: old-style JPEG is YCbCr
    if photo in REFUSED_PHOTOMETRIC or photo not in (0, 1, 2, 3, 5, 6, 8):
        _refuse(name, REFUSED_PHOTOMETRIC.get(photo, f"photometric interpretation {photo}, which PIL refuses too "
                                                     f"(no layout)"))
    fill_order = one(FILL_ORDER, 1)
    if WIDTH not in tags or LENGTH not in tags:
        _refuse(name, "a TIFF without its ImageWidth or ImageLength")
    width, height = one(WIDTH), one(LENGTH)
    if width * height > MAX_PIXELS:
        _refuse(name, f"an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    sample_format = tags.get(SAMPLE_FORMAT, (1,))
    if len(sample_format) > 1 and set(sample_format) == {1}:
        sample_format = (1,)  # PIL keeps one value where every sample is unsigned
    # PIL's reading of BitsPerSample against SamplesPerPixel
    bits, extra = tags.get(BITS, (1,)), tags.get(EXTRA, ())
    spp = one(SAMPLES, 3 if compression == OJPEG and one(PHOTOMETRIC, 0) in (2, 6) else 1)
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp:
        _refuse(name, f"{len(bits)} BitsPerSample values for {spp} samples per pixel (PIL: unknown data "
                      f"organization)")
    planar = spp > 1 and one(PLANAR, 1) == 2
    depth = bits[0]
    key = (photo, bits, extra)
    if sample_format == (1,):
        layout = YCBCR_LAYOUT[1] if key == YCBCR_LAYOUT[0] else LAYOUTS.get(key)
        if order == ">" and key in LITTLE_ENDIAN_ONLY:
            layout = None
    else:
        mode = SAMPLE_LAYOUTS.get((photo, sample_format[0], depth)) if len(sample_format) == 1 else None
        layout = (mode, "take") if mode and spp == 1 and not extra else None
    if layout is None:
        _refuse(name, f"photometric {photo} with {'/'.join(map(str, bits))} bits, SampleFormat {sample_format} "
                      f"and extra samples {extra} (a layout PIL does not read: unknown pixel mode)")
    if fill_order != 1:
        if fill_order != 2 or sample_format != (1,) or key not in FILL_ORDER_2 or (order == ">" and depth == 16):
            _refuse(name, f"FillOrder {fill_order} with this layout (PIL: unknown pixel mode)")
        if compression == NONE and key in FILL_ORDER_2_UNPACKED:
            _refuse(name, "FillOrder 2 uncompressed in a layout PIL's raw decoder has no unpacker for (PIL: unknown "
                          "raw mode)")
    if compression in (JPEG, OJPEG) and depth != 8:
        _refuse(name, f"JPEG-in-TIFF at {depth} bits a sample (libtiff reads 8)")
    if compression in FAX and depth != 1:
        _refuse(name, f"CCITT fax at {depth} bits a sample (libtiff: Bits/sample must be 1 for Group 3/4)")
    if compression == THUNDERSCAN and depth != 4:
        _refuse(name, f"ThunderScan at {depth} bits a sample (libtiff: its decoder only supports 4 bits)")
    ycbcr_planes = photo == 6 and planar and compression not in (JPEG, OJPEG) and key == YCBCR_LAYOUT[0]
    if ycbcr_planes and compression != NONE and _subsampling(tags) != (1, 1):
        _refuse(name, f"YCbCr in planes subsampled {_subsampling(tags)} (libtiff's RGBA reader reads planes only "
                      f"at 1x1)")
    if planar and not ycbcr_planes:
        coded = "uncompressed" if compression == NONE else "compressed"
        kind = "tiles" if TILE_OFFSETS in tags else "strips"
        if (coded, kind) not in PLANAR_READS.get(key, ()):
            _refuse(name, _planar_fault(key, coded, kind))
    mode, how = layout
    if mode == "I;16" and order == ">" and depth == 16:
        mode = "I;16B"
    predictor = one(PREDICTOR, 1) if compression in (LZW, DEFLATE, ADOBE_DEFLATE, LZMA, ZSTD) else 1
    if predictor not in (1, 2, 3) or (predictor == 2 and depth not in (8, 16, 32)):
        _refuse(name, f"Predictor {predictor} at {depth} bits (libtiff refuses it)")
    if predictor == 3 and sample_format != (3,):
        _refuse(name, f"Predictor 3 on SampleFormat {sample_format} (libtiff refuses floating-point differencing "
                      f"of other samples)")

    chunks = _Chunks(data, name, tags, compression, width, height, spp, depth, planar)
    orientation = one(ORIENTATION, 1)
    if photo == 6 and compression not in (JPEG, NONE) and spp == 3 and not planar:
        pixels = _rgba_reader(data, name, tags, chunks, compression, predictor, fill_order)
        return Picture(np.ascontiguousarray(_orient(pixels, orientation)), mode)
    if photo == 6 and compression == NONE and spp == 3 and not planar:
        pixels = _raw_rgbx(data, name, chunks)
        return Picture(np.ascontiguousarray(_orient(pixels, orientation)), mode)
    if ycbcr_planes:  # uncompressed: PIL's raw decoder takes each plane as R, G, B; else libtiff converts
        canvas = _samples(data, name, chunks, order, compression, predictor, None, tags, fill_order)
        pixels = canvas.reshape(height, width, 3)
        if compression != NONE:
            pixels = tiff_ycbcr.to_rgb(pixels[..., 0], pixels[..., 1], pixels[..., 2], _ycbcr_tables(name, tags))
        return Picture(np.ascontiguousarray(_orient(pixels, orientation)), mode)
    if photo == 6 and compression not in (JPEG, NONE):
        _refuse(name, "one-sample or planar YCbCr (libtiff's RGBA reader: can not handle the format)")
    ycbcr = _ycbcr_subsampling(data, tags, chunks) if photo == 6 else None
    canvas = _samples(data, name, chunks, order, compression, predictor, ycbcr, tags, fill_order)
    samples = _unpack(canvas, width, height, spp, depth, order, sample_format[0])
    if compression != NONE and order == ">" and sample_format != (1,) and depth > 8:
        samples = samples.byteswap()  # libtiff gives host order, PIL unpacks it as the file's ("I;16BS", ...)
    palette = None
    if how == "invert":
        pixels = 1 - samples if depth == 1 else 255 - _scale(samples, depth)
    elif how == "scale":
        pixels = _scale(samples, depth)
    elif how == "unpremultiply":
        pixels = _unpremultiply(_high_bytes(samples[..., :4]))
    elif mode in ("I", "F"):
        pixels = samples.astype("<i4" if mode == "I" else "<f4")
    elif mode.startswith("I;16"):
        pixels = samples
    else:
        pixels = _high_bytes(samples[..., :len(mode)])
    if mode == "1":
        pixels = pixels != 0
    elif mode == "I;16":
        pixels = pixels.astype(np.uint16)
    elif mode in ("P", "PA"):
        if COLORMAP not in tags:
            _refuse(name, "a palette TIFF without its ColorMap")
        cmap = np.asarray(tags[COLORMAP], np.int64) // 256
        n = len(cmap) // 3
        palette = np.stack([cmap[:n], cmap[n:2 * n], cmap[2 * n:3 * n]], -1).astype(np.uint8)
        pixels = pixels[..., :len(mode)]
    return Picture(np.ascontiguousarray(_orient(pixels, orientation)), mode, palette)


def _scale(samples: np.ndarray, depth: int) -> np.ndarray:
    """PIL's L;2 and L;4 unpackers: 2- and 4-bit grey spread over 0..255."""
    return samples * (255 // ((1 << depth) - 1)) if depth in (2, 4) else samples


def _unpack(canvas: np.ndarray, width: int, height: int, spp: int, depth: int, order: str, fmt: int) -> np.ndarray:
    """(height, width, spp) samples of (height, row bytes) sample bytes in
    the file's byte order: below 8 bits and at 12 packed most significant
    bit first (uint8 / uint16), 8 bits as bytes (signed ones too, as PIL's
    "L" keeps them), 16 and 32 bits in the byte order, unsigned, signed or
    float by the SampleFormat."""
    if depth == 8:
        return canvas[:, :width * spp].reshape(height, width, spp)
    if depth % 8:
        bits = np.unpackbits(canvas, axis=1)[:, :width * spp * depth].reshape(height, width * spp, depth)
        values = (bits.astype(np.uint16) << np.arange(depth - 1, -1, -1, dtype=np.uint16)).sum(-1, dtype=np.uint16)
        return values.astype(np.uint8 if depth < 8 else np.uint16).reshape(height, width, spp)
    kind = "f" if fmt == 3 else "i" if fmt == 2 else "u"
    n = depth // 8
    return canvas[:, :n * width * spp].view(f"{order}{kind}{n}").reshape(height, width, spp)


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


def _samples(data, name, chunks, order, compression, predictor, ycbcr, tags, fill_order=1) -> np.ndarray:
    """(height, row bytes) of the image's decoded sample bytes, pixel
    interleaved, in the file's byte order: the strips or tiles decoded (and
    un-differenced) one by one and put in place; planes
    (PlanarConfiguration 2) decoded each into its own canvas and
    interleaved."""
    c = chunks
    width, height, depth = c.width, c.height, c.depth
    row_bytes = (c.cw * c.spp * depth + 7) // 8
    tables = bytes(tags.get(JPEG_TABLES, ()))
    per_plane = c.across * c.down
    planes, fax_decoder = [], None
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
                if fill_order == 2:
                    chunk = _REVERSED[chunk]
            else:
                where = f"{name}: strip or tile {i}"
                coded = _coded(data, name, c, i, fill_order if compression != JPEG else 1)
                if compression == JPEG:
                    last = not c.tiled and j == per_plane - 1  # libtiff takes a taller frame in the last strip
                    chunk = jpeg.decode_tiff_jpeg(tables, coded, rows, c.cw, c.spp, where, ycbcr, last).reshape(-1)
                elif compression in FAX:
                    fax_decoder = fax_decoder or fax.Decoder(compression, tags, c.cw, name)
                    chunk = fax_decoder.decode(coded, rows, where)
                elif compression == THUNDERSCAN:
                    chunk = image_codecs.thunderscan_decode(coded, c.cw, rows, where)
                else:
                    chunk = _decompress(coded, size, compression, where)
            chunk = chunk.reshape(rows, row_bytes)
            if predictor == 2:
                chunk = _undifference(chunk, c.cw, c.spp, f"{order}u{depth // 8}")
            elif predictor == 3:
                chunk = _float_accumulate(chunk, c.spp, depth // 8, order)
            canvas[y:y + rows, x * row_bytes:(x + 1) * row_bytes] = chunk
        planes.append(canvas[:height, :(width * c.spp * depth + 7) // 8])
    if len(planes) == 1:
        return planes[0]
    unit = np.uint16 if depth == 16 else np.uint8  # interleave whole samples, in the file's byte order
    return np.stack([p.view(unit) for p in planes], -1).view(np.uint8).reshape(height, -1)


_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)  # FillOrder 2


def _coded(data: bytes, name: str, chunks, i: int, fill_order: int) -> bytes:
    """The coded bytes of strip or tile `i`, their bits reversed under
    FillOrder 2 (libtiff reverses them before the codec reads them)."""
    off, count = chunks.offsets[i], chunks.counts[i]
    coded = data[off:off + count]
    if len(coded) < count:
        _refuse(name, f"truncated TIFF data (strip or tile {i} lies past the end of the file)")
    return _REVERSED[np.frombuffer(coded, np.uint8)].tobytes() if fill_order == 2 else coded


def _float_accumulate(chunk: np.ndarray, spp: int, bps: int, order: str) -> np.ndarray:
    """Predictor 3 (libtiff's fpAcc) on each row: each byte plus the one
    `spp` bytes before it, then the byte planes (most significant first)
    put back together as samples; returned in the file's byte order."""
    rows, n = chunk.shape
    summed = np.empty_like(chunk)
    for r in range(spp):
        summed[:, r::spp] = np.cumsum(chunk[:, r::spp], axis=1, dtype=np.uint8)
    big = summed.reshape(rows, bps, n // bps).transpose(0, 2, 1)  # each sample's bytes, big-endian
    return np.ascontiguousarray(big if order == ">" else big[:, :, ::-1]).reshape(rows, n)


def _rgba_reader(data, name, tags, chunks, compression, predictor, fill_order) -> np.ndarray:
    """(height, width, 3) RGB of 8-bit YCbCr strips or tiles as libtiff's
    RGBA reader gives it to PIL (`utils/tiff_ycbcr.py`): PIL asks for one
    strip, or one row of tiles, a call; a strip or tile the codec cannot
    decode keeps what it gave (the rest zero), as the reader goes on past
    errors."""
    c = chunks
    ojpeg_image = ojpeg.Image(data, tags, c, name) if compression == OJPEG else None
    h, v = ojpeg_image.subsampling if ojpeg_image else _subsampling(tags)  # OJPEG: its frame's
    if (h, v) not in tiff_ycbcr.SUBSAMPLINGS:
        _refuse(name, f"YCbCr subsampling {h}x{v} (libtiff's RGBA reader has no routine for it)")
    tabs = _ycbcr_tables(name, tags)
    width, height = c.width, c.height
    out = np.zeros((height, width, 3), np.uint8)
    for row in range(c.down):
        y = row * c.ch
        rows = min(c.ch, height - y)
        block = np.zeros((rows, c.across * c.cw, 3), np.uint8)
        for x in range(c.across):
            i = row * c.across + x
            size = tiff_ycbcr.unit_bytes(c.cw, c.ch if c.tiled else rows, h, v)
            # a strip is read as whole unit rows of TIFFScanlineSize bytes a
            # pixel row (the unit row's bytes over v, rounded down): at 4x4 an
            # odd number of units a row reads short, the rest zero
            scanline = -(-c.cw // h) * (h * v + 2) // v
            want = size if c.tiled else min(size, -(-rows // v) * v * scanline)
            units = np.zeros(size, np.uint8)
            units[:want] = ojpeg_image.units_of(i, want) if ojpeg_image else \
                _decode_units(data, name, c, i, compression, fill_order, want)
            if predictor == 2 and scanline % 3 == 0:  # horAcc8 over each scanline, 3 bytes apart
                units[:want] = _undifference(units[:want].reshape(-1, scanline), scanline // 3, 3, "u1").reshape(-1)
            inside = min(c.cw, width - x * c.cw)
            block[:, x * c.cw:x * c.cw + inside] = tiff_ycbcr.units_to_rgb(units, inside, rows, h, v, tabs,
                                                                            c.cw - inside)
        out[y:y + rows] = block[:, :width]
    return out


def _subsampling(tags) -> tuple:
    """YCbCrSubsampling as libtiff takes it for its RGBA reader (2x2 without the tag)."""
    return tuple(tags[YCBCR_SUBSAMPLING][:2]) if len(tags.get(YCBCR_SUBSAMPLING, ())) >= 2 else (2, 2)


def _ycbcr_tables(name, tags):
    """libtiff's YCbCr to RGB tables from the YCbCrCoefficients and
    ReferenceBlackWhite tags (a tag of another count keeps its default)."""
    luma = tags.get(YCBCR_COEFFICIENTS, ())
    ref = tags.get(REFERENCE_BLACK_WHITE, ())
    luma = luma if len(luma) == 3 else tiff_ycbcr.LUMA
    ref = ref if len(ref) == 6 else tiff_ycbcr.REFERENCE_BLACK_WHITE
    fault = tiff_ycbcr.valid_coefficients(luma, ref)
    if fault:
        _refuse(name, fault)
    return tiff_ycbcr.tables(luma, ref)


def _decode_units(data, name, chunks, i, compression, fill_order, size) -> np.ndarray:
    """`size` bytes of YCbCr data units of strip or tile `i`: what the codec
    gives, zero past it where it fails or the data lie past the file's end
    (libtiff's reader goes on)."""
    off, count = chunks.offsets[i], chunks.counts[i]
    coded = data[off:off + count]
    if fill_order == 2:
        coded = _REVERSED[np.frombuffer(coded, np.uint8)].tobytes()
    out = np.zeros(size, np.uint8)
    got = _decompress_partial(coded, size, compression, f"{name}: strip or tile {i}")
    out[:len(got)] = got
    return out


def _decompress_partial(coded: bytes, size: int, compression: int, name: str) -> np.ndarray:
    """Up to `size` bytes of a strip or tile: all of them, or what the codec
    wrote before it failed."""
    if compression == LZW:
        return image_codecs.lzw_decode(coded, size, name, partial=True)
    if compression == PACKBITS:
        return image_codecs.packbits_decode(coded, size, name, partial=True)
    if compression in (DEFLATE, ADOBE_DEFLATE):
        inflate, out = zlib.decompressobj(), b""
        try:
            return np.frombuffer(inflate.decompress(coded, size), np.uint8)
        except zlib.error:
            inflate = zlib.decompressobj()
            for k in range(len(coded)):  # again a byte at a time: zlib drops a failing call's output
                try:
                    out += inflate.decompress(coded[k:k + 1], size - len(out))
                except zlib.error:
                    break
            return np.frombuffer(out[:size], np.uint8)
    try:
        return _decompress(coded, size, compression, name)
    except ValueError:
        return np.zeros(0, np.uint8)


def _raw_rgbx(data, name, chunks) -> np.ndarray:
    """Uncompressed 3-sample YCbCr as PIL's raw decoder reads it, its raw
    mode "RGBX": four bytes a pixel from each strip's or tile's offset (a
    row `stride` bytes apart: the raw mode's own row, or the tile's three
    bytes a pixel where the tile overhangs the image), the first three
    taken as R, G and B."""
    c = chunks
    out = np.zeros((c.height, c.width, 3), np.uint8)
    for i in range(c.across * c.down):
        x0, y0 = (i % c.across) * c.cw, (i // c.across) * c.ch
        w, rows = min(c.cw, c.width - x0), min(c.ch, c.height - y0)
        stride = 3 * c.cw if c.tiled and x0 + c.cw > c.width else 4 * w
        if stride < 4 * w:
            _refuse(name, "uncompressed YCbCr tiles over the image's edge, whose row is shorter than PIL's raw mode "
                          "RGBX reads (PIL: codec configuration error)")
        need = stride * (rows - 1) + 4 * w
        off = c.offsets[i]
        if off + need > len(data):
            _refuse(name, f"truncated TIFF data (strip or tile {i}; PIL's raw mode RGBX reads 4 bytes a pixel)")
        rows_of = np.lib.stride_tricks.as_strided(np.frombuffer(data, np.uint8, need, off), (rows, 4 * w),
                                                  (stride, 1))
        out[y0:y0 + rows, x0:x0 + w] = rows_of.reshape(rows, w, 4)[..., :3]
    return out


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
