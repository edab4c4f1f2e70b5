"""FITS reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the FITS files PIL 12's FitsImagePlugin reads, returning an
`image_io.Picture`. PIL's `_open` is followed card by card: 80-byte cards
from the first, a header unit's END moving to the next 2880-byte boundary,
the first header whose NAXIS is not 0 giving the image (the cards of every
header read so far in one table, as PIL keeps them), the data found at
the first card read after that header's unit. The mode comes from BITPIX:
8 "L", 16 "I;16", 32 "I", -32 and -64 "F", each read by PIL's raw decoder
with its little-endian raw mode from FITS's big-endian data, so that a
16-bit 258 reads 513 and -64 reads the first half of its bytes as
float32; the rows bottom-up (NAXIS 1 is one column). A binary table with
ZIMAGE = T and ZCMPTYPE 'GZIP_1  ' is PIL's FitsGzipDecoder: the rest of
the file from the end of the table gunzipped (the standard library's
`gzip`, as PIL calls it), of every 4-byte word its last min(ZBITPIX // 8,
4) bytes, the rows reversed.

The COLMAP path trains only on "L" (`scene/dataset_readers._NOT_THE_PICTURE`
names the others); `image_io.to_rgba` converts every mode as PIL does.

A first card that is not SIMPLE = T, a missing keyword, another BITPIX or
a size of 0 raises `image_io.NotThisFormat` (PIL passes the file on); a
file that ends in its headers, a header with no image, a value PIL cannot
read as a number, image data cut short, a gzip stream that does not
decompress and an image over PIL's decompression-bomb limit raise a
`ValueError` naming the file.
"""

from __future__ import annotations

import gzip
import math
import zlib

import numpy as np

from gaussian_splatting_torch.utils.bmp import MAX_PIXELS

SIGNATURE = b"SIMPLE"
MODES = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}
DTYPES = {"L": np.uint8, "I;16": "<u2", "I": "<i4", "F": "<f4"}


def _refuse(name, what: str):
    raise ValueError(f"{name}: {what}; the port reads the FITS files PIL reads (FitsImagePlugin)")


class _Headers(dict):
    """PIL's header table: a missing keyword is a KeyError, which PIL's
    open turns into a pass."""

    def __init__(self, name):
        super().__init__()
        self.name = name

    def __missing__(self, key):
        from gaussian_splatting_torch.utils.image_io import NotThisFormat

        raise NotThisFormat(f"{self.name}: a FITS header without {key.decode()} (PIL: KeyError, passed on)")

    def number(self, key: bytes) -> int:
        try:
            return int(self[key])
        except ValueError:
            _refuse(self.name, f"a FITS {key.decode()} of {self[key]!r}, which is not a number")


def _size(headers: _Headers, prefix: bytes):
    naxis = headers.number(prefix + b"NAXIS")
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, headers.number(prefix + b"NAXIS1")
    return headers.number(prefix + b"NAXIS1"), headers.number(prefix + b"NAXIS2")


def _parse(headers: _Headers):
    """PIL's `_parse_headers`: (decoder, offset, size, mode, bitpix), or
    None where the header has no image (NAXIS 0)."""
    prefix, decoder, offset = b"", "raw", 0
    if headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T" \
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '":
        table = _size(headers, b"") or (0, 0)
        offset = table[0] * table[1] * (headers.number(b"BITPIX") // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _size(headers, prefix)
    if not size:
        return None
    bitpix = headers.number(prefix + b"BITPIX")
    return decoder, offset, size, MODES.get(bitpix, ""), bitpix


def decode_fits(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of FITS bytes."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    headers, in_header, found, pos = _Headers(name), False, None, 0
    while True:
        card = data[pos:pos + 80]
        pos += len(card)
        if not card:
            _refuse(name, "a FITS file that ends in its headers (PIL: Truncated FITS file)")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_header = True
        elif headers and not in_header:
            break  # the data unit
        elif keyword == b"END":
            pos = math.ceil(pos / 2880) * 2880
            if not found:
                found = _parse(headers)
            in_header = False
            continue
        if found:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(SIGNATURE) or value != b"T"):
            raise NotThisFormat(f"{name}: not a FITS file (PIL: Not a FITS file, passed on)")
        headers[keyword] = value
    if not found:
        _refuse(name, "a FITS file with no image data (PIL: No image data)")
    decoder, offset, (width, height), mode, bitpix = found
    offset += min(pos, len(data)) - 80  # PIL's tell() after the card that ended the header
    if not mode or width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: a FITS image of {width}x{height} pixels at BITPIX {bitpix} (PIL: not "
                            f"identified, passed on)")
    if width * height > MAX_PIXELS:
        _refuse(name, f"an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    dtype = np.dtype(DTYPES[mode])
    need = width * height * dtype.itemsize
    if decoder == "raw":
        body = data[offset:offset + need] if offset >= 0 else b""
        if offset < 0 or len(body) < need:
            _refuse(name, f"FITS image data of {len(body)} of its {need} bytes (PIL: image file is truncated)")
        rows = np.frombuffer(body, dtype).reshape(height, width)[::-1]
    else:
        rows = _gzip_rows(data[max(offset, 0):], bitpix, width, height, dtype, name)
    return Picture(np.ascontiguousarray(rows)[..., None], mode)


def _gzip_rows(body: bytes, zbitpix: int, width: int, height: int, dtype, name) -> np.ndarray:
    """PIL's FitsGzipDecoder: of each 4-byte word of the gunzipped data its
    last min(ZBITPIX // 8, 4) bytes (none for a ZBITPIX below 8; a word the
    data cuts gives the bytes it has), rows of `width` words, the rows
    reversed, set as raw in the image's mode."""
    try:
        value = np.frombuffer(gzip.decompress(body), np.uint8)
    except (OSError, EOFError, zlib.error) as err:
        _refuse(name, f"a FITS gzip tile that does not decompress ({err})")
    keep = min(zbitpix // 8, 4)
    need = width * height * dtype.itemsize
    stream = np.zeros(0, np.uint8)
    if keep > 0:
        at = (4 * np.arange(width * height, dtype=np.int64).reshape(height, width, 1) + (4 - keep)
              + np.arange(keep))[::-1].reshape(-1)
        stream = value[at[at < value.size]]
    if stream.size < need:
        _refuse(name, f"FITS gzip data of {stream.size} of its {need} bytes (PIL: not enough image data)")
    return np.frombuffer(stream[:need].tobytes(), dtype).reshape(height, width)
