"""CCITT fax strips and tiles of a TIFF, by the compiled `csrc/fax_decode.cc`.

libtiff decodes a fax-coded TIFF for PIL (tif_fax3.c); the port's decoder
follows it (see the source's header): modified Huffman (compression 2) and
its word-aligned form (32771), Group 3 1-D and 2-D (compression 3, the
T4Options tag's bit 0) and Group 4 (compression 4). It is host C++, built by
`cuda_build.build_host` at first use and loaded with ctypes. Nothing falls
back to another implementation: if it cannot be built, the read raises,
naming the file.
"""

from __future__ import annotations

import ctypes

import numpy as np

from gaussian_splatting_torch.utils import cuda_build

T4_OPTIONS = 292
MODES = {2: 0, 32771: 1, 3: 2, 4: 4}  # compression -> gs_fax_decode's mode (Group 3: 3 with 2-D coding)


def _library(name: str):
    try:
        lib = cuda_build.load_host("fax_decode")
    except RuntimeError as err:
        raise RuntimeError(f"{name}: the fax decoder (csrc/fax_decode.cc) could not be built: {err}") from err
    if not hasattr(lib, "_gs_typed"):
        lib.gs_fax_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
        lib.gs_fax_runs.argtypes, lib.gs_fax_runs.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
        lib.gs_fax_decode.restype = ctypes.c_int
        lib.gs_fax_error.argtypes, lib.gs_fax_error.restype = [], ctypes.c_char_p
        lib._gs_typed = True
    return lib


def mode_of(compression: int, tags: dict) -> int:
    """gs_fax_decode's mode: 0 MH, 1 MH word-aligned, 2 / 3 Group 3 1-D / 2-D, 4 Group 4."""
    return 3 if compression == 3 and tags.get(T4_OPTIONS, (0,))[0] & 1 else MODES[compression]


class Decoder:
    """The fax decoder of one image: its run arrays live as long as it
    does and carry over from strip to strip, as libtiff's do."""

    def __init__(self, compression: int, tags: dict, width: int, name: str):
        self.lib = _library(name)
        self.mode, self.width = mode_of(compression, tags), width
        self.runs = np.zeros(self.lib.gs_fax_runs(width, self.mode), np.uint32)

    def decode(self, coded: bytes, rows: int, name: str) -> np.ndarray:
        """(rows * ceil(width / 8)) bytes of packed bits, 1 for black: one
        strip or tile; raises a `ValueError` naming `name` where libtiff
        fails the strip, and where a Group 4 strip ends (its data, or an
        EOFB) before its last row, whose rows libtiff leaves unwritten in
        PIL's strip buffer (PIL's pixels there are whatever that memory
        held)."""
        row_bytes = (self.width + 7) // 8
        out = np.zeros(rows * row_bytes, np.uint8)
        done = ctypes.c_int(0)
        if self.lib.gs_fax_decode(coded, len(coded), self.mode, self.width, rows, out.ctypes.data, row_bytes,
                                  self.runs.ctypes.data, ctypes.addressof(done)):
            raise ValueError(f"{name}: {self.lib.gs_fax_error().decode()}")
        if done.value < rows:
            raise ValueError(f"{name}: Group 4 data that ends after {done.value} of its {rows} rows (libtiff leaves "
                             f"the rest of PIL's strip buffer unwritten)")
        return out
