"""PIL's raw decoder and its unpackers, for the formats that lay their
pixels out raw behind a header (IM, IMT, McIDAS, PIXAR, SPIDER, SUN, XV
thumbnails, MSP).

PIL loads a "raw" tile one of two ways. Where the file is opened by its
path, the tile is the only one and its raw mode is the image's mode and
one of `MAPMODES`, it maps the file (`map_tile`): the rows are the file's
bytes at `offset + y * stride` (a stride of 0 or less is the row's own
length), bottom-up where the tile's y step is negative; where the
mapping check fails (`offset + height * stride` past the file's end) it
goes on to the decoder. The decoder (`decode_tile`, PIL's Raw.c) unpacks
rows of (bits x width + 7) // 8 bytes with `stride - that` bytes skipped
between them (a stride below the row's length is a configuration error),
and needs every row: data that ends before the last one raises (PIL:
image file is truncated).

`unpack` is PIL's Unpack.c for the raw modes these formats use: the bits
of "1" (MSB first; "1;I" inverted), 2- and 4-bit palette indices and
4-bit grey (scaled by 17), bytes, interleaved RGB / BGR / RGBX / BGRX,
line-interleaved planes ("RGB;L", "RGBA;L", "RGBX;L", "CMYK;L",
"YCbCr;L", "LA;L", "PA;L": each row every band's run in turn), one band
of an RGB image ("R", "G", "B"), 16- and 32-bit integers of either byte
order and 8- to 32-bit integers ("F;32" unsigned) and floats into "F".

The pixels are those of `np.asarray` of PIL's image, with a channel axis:
bool for "1", uint8 for the byte modes, uint16 for "I;16" / "I;16L"
(little endian) and "I;16B" (big endian), int32 for "I", float32 for "F".
"""

from __future__ import annotations

import numpy as np

# PIL's Image._MAPMODES and the bytes of a pixel of each in PIL's core: the modes whose raw tiles PIL maps
# (its "RGBX", "RGBA" and "CMYK" map too, but no reader here has a tile of one in its own raw mode)
MAPMODES = {"L": 1, "P": 1, "I;16": 2, "I;16L": 2, "I;16B": 2}
MAX_PIXELS = 2 * 89478485  # PIL raises DecompressionBombError past this
BANDS = {"1": 1, "L": 1, "P": 1, "I": 1, "F": 1, "I;16": 1, "I;16L": 1, "I;16B": 1, "LA": 2, "PA": 2,
         "RGB": 3, "YCbCr": 3, "RGBA": 4, "CMYK": 4}
DTYPES = {"1": np.bool_, "I": np.dtype("<i4"), "F": np.dtype("<f4"), "I;16": np.dtype("<u2"),
          "I;16L": np.dtype("<u2"), "I;16B": np.dtype(">u2")}
# raw mode -> its bits a pixel
BITS = {"1": 1, "1;I": 1, "P;2": 2, "L;4": 4, "P;4": 4, "L": 8, "P": 8, "R": 8, "G": 8, "B": 8,
        "F;8": 8, "F;8S": 8, "LA;L": 16, "PA;L": 16, "I;16": 16, "I;16L": 16, "I;16B": 16, "F;16": 16,
        "F;16S": 16, "RGB": 24, "BGR": 24, "RGB;L": 24, "YCbCr;L": 24, "RGBX": 32, "BGRX": 32, "RGBA;L": 32,
        "RGBX;L": 32, "CMYK;L": 32, "I;32": 32, "I;32S": 32, "I;32B": 32, "F;32": 32, "F;32F": 32,
        "F;32BF": 32}
# the raw modes PIL's unpackers take for each image mode
UNPACKERS = {
    "1": ("1", "1;I"), "L": ("L", "L;4"), "P": ("P", "P;2", "P;4"), "LA": ("LA;L",), "PA": ("PA;L",),
    "RGB": ("RGB", "BGR", "RGBX", "BGRX", "RGB;L", "RGBX;L", "R", "G", "B"), "RGBA": ("RGBA;L",),
    "CMYK": ("CMYK;L",), "YCbCr": ("YCbCr;L",), "I": ("I;32", "I;32S", "I;32B"), "I;16": ("I;16",),
    "I;16L": ("I;16L",), "I;16B": ("I;16B",),
    "F": ("F;8", "F;8S", "F;16", "F;16S", "F;32", "F;32F", "F;32BF"),
}


def row_bytes(rawmode: str, width: int) -> int:
    return (BITS[rawmode] * width + 7) // 8


def check_mode(mode: str, rawmode: str, name: str) -> None:
    """Raise where PIL's decoder for `rawmode` cannot fill `mode`."""
    if mode not in BANDS:
        raise ValueError(f"{name}: an image of mode {mode!r} (PIL: unrecognized image mode)")
    if rawmode not in UNPACKERS[mode]:
        raise ValueError(f"{name}: raw mode {rawmode!r} for an image of mode {mode} (PIL: unknown raw mode for "
                         f"given image mode)")


def check_size(width: int, height: int, name: str) -> None:
    if width * height > MAX_PIXELS:
        raise ValueError(f"{name}: an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")


def new(mode: str, width: int, height: int) -> np.ndarray:
    """PIL's new image of `mode`: zeros, with a channel axis."""
    return np.zeros((height, width, BANDS[mode]), DTYPES.get(mode, np.uint8))


def _bits(rows: np.ndarray, bits: int, width: int) -> np.ndarray:
    """(h, width) of the `bits`-bit fields of each row, MSB first."""
    per = 8 // bits
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    fields = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return fields.reshape(len(rows), -1)[:, :width] if per > 1 else rows[:, :width]


def unpack(rows: np.ndarray, rawmode: str, width: int, mode: str) -> np.ndarray:
    """(h, width, bands) in `mode`'s dtype: PIL's unpacker `rawmode` on
    each row of `rows` ((h, >= row_bytes) uint8). "R", "G" and "B" fill
    their band and leave the others 0."""
    h = len(rows)
    rows = np.ascontiguousarray(rows[:, :row_bytes(rawmode, width)])
    if rawmode in ("1", "1;I"):
        px = _bits(rows, 1, width).astype(bool)
        return (px if rawmode == "1" else ~px)[..., None]
    if rawmode in ("P;2", "P;4", "L;4"):
        px = _bits(rows, int(rawmode[-1]), width).astype(np.uint8)
        return (px * 17 if rawmode == "L;4" else px)[..., None]
    if rawmode in ("L", "P"):
        return rows[..., None]
    if rawmode in ("R", "G", "B"):
        out = np.zeros((h, width, 3), np.uint8)
        out[..., "RGB".index(rawmode)] = rows
        return out
    if rawmode in ("RGB", "BGR", "RGBX", "BGRX"):
        px = rows.reshape(h, width, len(rawmode))[..., :3]
        return np.ascontiguousarray(px[..., ::-1] if rawmode.startswith("B") else px)
    if rawmode.endswith(";L") and rawmode[:-2] in ("RGB", "RGBA", "RGBX", "CMYK", "YCbCr", "LA", "PA"):
        bands = len(rawmode[:-2]) if rawmode[:-2] != "YCbCr" else 3
        px = rows.reshape(h, bands, width).transpose(0, 2, 1)
        return np.ascontiguousarray(px[..., :3] if rawmode == "RGBX;L" else px)
    kind = {"I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2", "I;32": "<i4", "I;32S": "<i4", "I;32B": ">i4",
            "F;8": "u1", "F;8S": "i1", "F;16": "<u2", "F;16S": "<i2", "F;32": "<u4", "F;32F": "<f4",
            "F;32BF": ">f4"}[rawmode]
    px = rows.view(kind)[..., None]
    return px.astype(DTYPES[mode])


def decode_tile(data: bytes, offset: int, width: int, height: int, mode: str, rawmode: str, stride: int,
                ystep: int, name: str, into: np.ndarray = None) -> np.ndarray:
    """PIL's raw decoder on the file `data` from `offset`: rows of
    `rawmode` `stride` bytes apart (0: packed), bottom-up where `ystep` is
    negative, unpacked into `into` (default a new image of `mode`)."""
    check_mode(mode, rawmode, name)
    out = new(mode, width, height) if into is None else into
    n = row_bytes(rawmode, width)
    if stride and stride < n:
        raise ValueError(f"{name}: a row stride of {stride} bytes below the row's {n} (PIL: decoder error -8)")
    step = stride or n
    if offset < 0:
        raise ValueError(f"{name}: image data at offset {offset} (PIL: negative seek value)")
    need = offset + (height - 1) * step + n
    if len(data) < need:
        raise ValueError(f"{name}: image data of {max(len(data) - offset, 0)} of its {need - offset} bytes "
                         f"(PIL: image file is truncated)")
    rows = np.lib.stride_tricks.as_strided(np.frombuffer(data, np.uint8, offset=offset), (height, n), (step, 1))
    px = unpack(rows, rawmode, width, mode)
    px = px[::-1] if ystep < 0 else px
    if rawmode in ("R", "G", "B"):
        out[..., "RGB".index(rawmode)] = px[..., "RGB".index(rawmode)]
    else:
        out[...] = px
    return out


def map_tile(data: bytes, offset: int, width: int, height: int, mode: str, stride: int, ystep: int,
             name: str):
    """PIL's mapping of a raw tile whose raw mode is the image's mode (one
    of MAPMODES) in a file opened by its path: the image, or None where
    PIL's check sends the tile to the decoder."""
    if offset < 0:
        raise ValueError(f"{name}: image data at offset {offset} (PIL: Tile offset cannot be negative)")
    if offset + height * stride > len(data):
        return None
    row = width * MAPMODES[mode]
    step = stride if stride > 0 else row
    if offset + height * step > len(data):
        raise ValueError(f"{name}: image data of {len(data) - offset} of its {height * step} bytes (PIL: buffer "
                         f"is not large enough)")
    rows = np.lib.stride_tricks.as_strided(np.frombuffer(data, np.uint8, offset=offset), (height, row), (step, 1))
    px = rows.view(DTYPES.get(mode, np.uint8))[..., None]
    return np.ascontiguousarray(px[::-1] if ystep < 0 else px)


def raw_tile(data: bytes, offset: int, width: int, height: int, mode: str, rawmode: str, name: str,
             stride: int = 0, ystep: int = 1, mappable: bool = True) -> np.ndarray:
    """PIL's load of one raw tile of a file opened by its path: mapped
    where PIL maps it, else decoded. A tile whose arguments are a raw mode
    and a stride alone (SUN's) is never mapped (`mappable` False)."""
    check_size(width, height, name)
    if not -2**31 <= stride < 2**31:  # PIL's core takes the stride as a C int
        raise ValueError(f"{name}: a row stride of {stride} bytes (PIL: OverflowError, not a C int)")
    if mappable and rawmode == mode and mode in MAPMODES:
        px = map_tile(data, offset, width, height, mode, stride, ystep, name)
        if px is not None:
            return px
    return decode_tile(data, offset, width, height, mode, rawmode, stride, ystep, name)
