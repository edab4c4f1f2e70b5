"""The compiled byte loops of the BMP, TIFF, GIF, TGA, QOI, PCX, SGI, PSD, FLI and ICNS readers
(`csrc/image_codecs.cc`).

LZW, PackBits and ThunderScan (TIFF), RLE8 / RLE4 (BMP), GIF's LZW, TGA's RLE, QOI's ops, PCX's and SGI's RLE,
PIL's PackBits (PSD), PIL's FliDecode (FLI) and an icns band's runs run per code, packet or byte,
so they are host C++, built by `cuda_build.build_host` at first use and
loaded with ctypes. Nothing falls back to another implementation: if the
library cannot be built, the read raises, naming the file.
"""

from __future__ import annotations

import ctypes

import numpy as np

from gaussian_splatting_torch.utils import cuda_build


def _library(name: str):
    try:
        lib = cuda_build.load_host("image_codecs")
    except RuntimeError as err:
        raise RuntimeError(f"{name}: the image codecs (csrc/image_codecs.cc) could not be built: "
                           f"{err}") from err
    if not hasattr(lib, "_gs_typed"):
        buf = (ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p)
        for fn in (lib.gs_lzw_decode, lib.gs_packbits_decode):
            fn.argtypes, fn.restype = list(buf), ctypes.c_int
        lib.gs_thunderscan_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                              ctypes.c_void_p]
        lib.gs_thunderscan_decode.restype = ctypes.c_int
        lib.gs_bmp_rle_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
        lib.gs_bmp_rle_decode.restype = ctypes.c_int
        lib.gs_gif_lzw_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        lib.gs_gif_lzw_decode.restype = ctypes.c_int
        lib.gs_tga_rle_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        lib.gs_tga_rle_decode.restype = ctypes.c_int
        L, P = ctypes.c_longlong, ctypes.c_void_p
        typed = {"gs_qoi_decode": [ctypes.c_char_p, L, L, ctypes.c_int, L, P],
                 "gs_pcx_rle_decode": [ctypes.c_char_p, L, L, L, L, ctypes.c_int, L, P],
                 "gs_sgi_rle_decode": [ctypes.c_char_p, L, ctypes.c_int, L, L, ctypes.c_int, P],
                 "gs_pil_packbits_decode": [ctypes.c_char_p, L, L, L, L, P]}
        for fn_name, argtypes in typed.items():
            getattr(lib, fn_name).argtypes, getattr(lib, fn_name).restype = argtypes, ctypes.c_int
        lib.gs_fli_decode.argtypes, lib.gs_fli_decode.restype = [ctypes.c_char_p, L, P, L, L, P], L
        lib.gs_icns_rle_decode.argtypes, lib.gs_icns_rle_decode.restype = [ctypes.c_char_p, L, L, L, P, P, P], L
        lib.gs_codec_error.argtypes, lib.gs_codec_error.restype = [], ctypes.c_char_p
        lib._gs_typed = True
    return lib


def _stream(fn_name: str, data: bytes, size: int, name: str, partial: bool = False) -> np.ndarray:
    lib = _library(name)
    out = np.zeros(size, np.uint8)
    produced = ctypes.c_longlong(0)
    if getattr(lib, fn_name)(data, len(data), out.ctypes.data, size, ctypes.addressof(produced)):
        if partial:
            return out[:produced.value]
        raise ValueError(f"{name}: {lib.gs_codec_error().decode()}")
    return out


def lzw_decode(data: bytes, size: int, name: str, partial: bool = False) -> np.ndarray:
    """The `size` bytes of one TIFF strip or tile coded in LZW (libtiff's
    new style, or its old style, codes least significant bit first, as its
    LZWDecodeCompat reads it); raises a `ValueError` naming `name` on
    corrupt or short data, or with `partial` returns the bytes decoded
    before the fault."""
    return _stream("gs_lzw_decode", data, size, name, partial)


def packbits_decode(data: bytes, size: int, name: str, partial: bool = False) -> np.ndarray:
    """The `size` bytes of one TIFF strip or tile coded in PackBits (with
    `partial`, what short data gives)."""
    return _stream("gs_packbits_decode", data, size, name, partial)


def thunderscan_decode(data: bytes, width: int, rows: int, name: str) -> np.ndarray:
    """(rows * ceil(width / 2)) bytes of 4-bit grey: one ThunderScan strip
    or tile as libtiff's ThunderDecode reads it, rows of `width` pixels;
    raises a `ValueError` naming `name` where libtiff reports an error."""
    lib = _library(name)
    out = np.zeros(rows * ((width + 1) // 2), np.uint8)
    if lib.gs_thunderscan_decode(data, len(data), width, rows, out.ctypes.data):
        raise ValueError(f"{name}: {lib.gs_codec_error().decode()}")
    return out


def bmp_rle_decode(data: bytes, start: int, rle4: bool, width: int, height: int, name: str) -> np.ndarray:
    """(height, width) uint8, one byte a pixel in the file's row order: the
    RLE8 or RLE4 bitmap of a BMP file `data` from byte `start`, as PIL's
    BmpRleDecoder reads it; raises where PIL raises (a delta escape cut
    short, fewer pixels than the image holds)."""
    lib = _library(name)
    out = np.zeros((height, width), np.uint8)
    produced = ctypes.c_longlong(0)
    if lib.gs_bmp_rle_decode(data, len(data), start, int(rle4), width, out.size, out.ctypes.data,
                             ctypes.addressof(produced)):
        raise ValueError(f"{name}: {lib.gs_codec_error().decode()}")
    if produced.value < out.size:
        raise ValueError(f"{name}: the BMP's RLE data gives {produced.value} of its {out.size} pixels "
                         f"(PIL: not enough image data)")
    return out


PIL_READ = 65536  # PIL's ImageFile.MAXBLOCK: the bytes of each read it hands a decoder


def gif_lzw_decode(data: bytes, bits: int, interlace: bool, frame: np.ndarray, name: str) -> None:
    """Decode one GIF frame's image data into `frame`, a (height, width)
    uint8 view of the canvas: `data` runs from the byte after the LZW
    minimum code size `bits` to the end of the file, as PIL's GifDecode
    reads it in PIL_READ-byte reads; raises a `ValueError` naming `name`
    where PIL raises (data that ends before the frame is full, a code past
    the table)."""
    lib = _library(name)
    if lib.gs_gif_lzw_decode(data, len(data), PIL_READ, bits, int(interlace), frame.ctypes.data,
                             frame.strides[0], frame.shape[1], frame.shape[0]):
        raise ValueError(f"{name}: {lib.gs_codec_error().decode()}")


def tga_rle_decode(data: bytes, start: int, depth: int, row_bytes: int, rows: int, name: str) -> np.ndarray:
    """(rows, row_bytes) uint8 in the file's row order: the RLE pixel data of
    a TGA file `data` from byte `start`, `depth` bytes a pixel, as PIL's
    TgaRleDecode reads it; raises a `ValueError` naming `name` where PIL
    raises (a run across the end of a row, data that ends early)."""
    lib = _library(name)
    out = np.empty((rows, row_bytes), np.uint8)
    if lib.gs_tga_rle_decode(data, len(data), start, depth, row_bytes, rows, out.ctypes.data):
        raise ValueError(f"{name}: {lib.gs_codec_error().decode()}")
    return out


def _run(name: str, fn_name: str, *args) -> None:
    lib = _library(name)
    if getattr(lib, fn_name)(*args):
        raise ValueError(f"{name}: {lib.gs_codec_error().decode()}")


def qoi_decode(data: bytes, start: int, bands: int, width: int, height: int, name: str) -> np.ndarray:
    """(height, width, bands) uint8: the QOI stream of a file `data` from
    byte `start`, as PIL's QoiDecoder reads it; raises a `ValueError`
    naming `name` where the stream ends before the last pixel."""
    out = np.empty((height, width, bands), np.uint8)
    _run(name, "gs_qoi_decode", data, len(data), start, bands, width * height, out.ctypes.data)
    return out


def pcx_rle_decode(data: bytes, start: int, line_bytes: int, width: int, bits: int, rows: int,
                   name: str) -> np.ndarray:
    """(rows, line_bytes) uint8: the RLE lines of a PCX file `data` from
    byte `start`, each line every plane of a row, as PIL's PcxDecode reads
    them (the planes of a padded stride moved together; `bits` those of
    PIL's raw mode); raises where PIL raises (a run across a line's end,
    data that ends early)."""
    out = np.empty((rows, line_bytes), np.uint8)
    _run(name, "gs_pcx_rle_decode", data, len(data), start, line_bytes, width, bits, rows, out.ctypes.data)
    return out


def sgi_rle_decode(data: bytes, bands: int, width: int, height: int, bpc: int, name: str) -> np.ndarray:
    """(height, width * bands * bpc) uint8 top-down: the RLE image of an SGI
    file `data` as PIL's SgiRleDecode reads it, channels interleaved, 16-bit
    samples big-endian; rows the decode does not reach are zero. Raises
    where PIL raises (an offset or run out of bounds)."""
    out = np.zeros((height, width * bands * bpc), np.uint8)
    _run(name, "gs_sgi_rle_decode", data, len(data), bands, width, height, bpc, out.ctypes.data)
    return out


def pil_packbits_decode(data: bytes, start: int, row_bytes: int, rows: int, name: str) -> np.ndarray:
    """(rows, row_bytes) uint8: PackBits rows from byte `start` of `data`
    as PIL's PackDecode reads them, each row cut at its end (libtiff's
    `packbits_decode` cuts only at the strip's end); raises where the data
    ends before the last row."""
    out = np.empty((rows, row_bytes), np.uint8)
    _run(name, "gs_pil_packbits_decode", data, len(data), start, row_bytes, rows, out.ctypes.data)
    return out


def fli_decode(buf: bytes, im: np.ndarray, name: str):
    """One call of PIL's FliDecode on `buf` into the (H, W) uint8 frame
    `im`: (bytes consumed, 0) where it wants more input, (-1, error code)
    where it ends (0 done, -1 overrun, -2 broken, -3 unknown data)."""
    lib = _library(name)
    err = ctypes.c_int(0)
    n = lib.gs_fli_decode(buf, len(buf), im.ctypes.data, im.shape[1], im.shape[0], ctypes.addressof(err))
    return n, err.value


def icns_rle_decode(data: bytes, start: int, n: int, name: str):
    """One icns band of `n` pixels from byte `start` of `data` as PIL's
    read_32 reads it: (its bytes, what is left of its count (0: whole,
    negative: a run past the band), the offset after it)."""
    lib = _library(name)
    out = np.empty(n, np.uint8)
    got, end = ctypes.c_longlong(0), ctypes.c_longlong(0)
    left = lib.gs_icns_rle_decode(data, len(data), start, n, out.ctypes.data, ctypes.addressof(got),
                                  ctypes.addressof(end))
    return out[:got.value], left, end.value
