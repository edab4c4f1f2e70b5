"""The compiled Zstandard decoder of the TIFF reader (`csrc/zstd_decode.cc`).

A ZSTD-compressed TIFF (compression 50000) holds Zstandard frames (RFC
8878), one stream a strip or tile; PIL reads them through libtiff's
ZSTDDecode, which calls libzstd's ZSTD_decompressStream until the strip
is full or a frame ends. The decoder is host C++, built by
`cuda_build.build_host` at first use and loaded with ctypes. Nothing
falls back to another implementation: if the library cannot be built,
the read raises, naming the file.
"""

from __future__ import annotations

import ctypes

import numpy as np

from gaussian_splatting_torch.utils import cuda_build


def _library(name: str):
    try:
        lib = cuda_build.load_host("zstd_decode")
    except RuntimeError as err:
        raise RuntimeError(f"{name}: the Zstandard decoder (csrc/zstd_decode.cc) could not be built: {err}") from err
    if not hasattr(lib, "_gs_typed"):
        lib.gs_zstd_decode_tiff.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
        lib.gs_zstd_decode_tiff.restype = ctypes.c_int
        lib.gs_zstd_error.argtypes, lib.gs_zstd_error.restype = [], ctypes.c_char_p
        lib._gs_typed = True
    return lib


def decode_tiff_zstd(data: bytes, size: int, name: str) -> np.ndarray:
    """The `size` bytes of one TIFF strip or tile coded in ZSTD, as
    libtiff's ZSTDDecode gives them to PIL; raises a `ValueError` naming
    `name` where libzstd reports an error or the strip comes out short."""
    lib = _library(name)
    out = np.empty(size, np.uint8)
    if lib.gs_zstd_decode_tiff(data, len(data), out.ctypes.data, size):
        raise ValueError(f"{name}: {lib.gs_zstd_error().decode()}")
    return out
