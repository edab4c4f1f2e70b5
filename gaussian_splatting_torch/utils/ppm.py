"""PPM, PGM, PBM and PFM reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the files PIL 12's PpmImagePlugin reads, returning an
`image_io.Picture`:

- magics: P1 / P4 (PBM) mode "1"; P2 / P5 (PGM) mode "L", or "I" when
  maxval is over 255; P3 / P6 (PPM) mode "RGB"; Pf (grey PFM) mode "F",
  rows bottom to top, little endian under a negative scale, else big
  endian; PIL's extensions P0CMYK, PyP, PyRGBA and PyCMYK (modes "CMYK",
  "P" without a palette, "RGBA", "CMYK");
- the header as PIL reads it: a magic of up to six bytes, tokens of at
  most ten bytes (a "#" skips to the end of its line, inside a token
  too), Python's `int` / `float` of each, 0 < maxval < 65536, one
  whitespace byte before the data;
- binary samples (P4 to P6 and the extensions): at maxval 255 as stored;
  a P5 at maxval 65535 as 16-bit big-endian "I"; at any other maxval
  PIL's PpmDecoder, min(out_max, round(value / maxval * out_max)) with
  Python's round half to even on a double, out_max 65535 for "I" and 255
  otherwise (so a 16-bit P6 becomes 8-bit RGB);
- plain samples (P1 to P3) as PIL's PpmPlainDecoder reads them: the file
  in reads of PIL's SAFEBLOCK bytes, comments removed from each (one may
  run on into the next reads), tokens split across reads stitched, P1's
  digits with or without whitespace between them; values over maxval,
  tokens over ten bytes and any other byte in P1's data raise. A numpy
  tokenizer parses plain decimal tokens; a read holding any other token
  (a sign, an underscore) goes through Python's `int`, as PIL does.

Everything else raises a `ValueError` naming the file: data that ends
early (PIL: image file is truncated, or not enough image data), a bad
header, a size over PIL's decompression-bomb limit. The magics PIL's PPM
plugin does not take, PF (colour PFM) and P7 (PAM), raise
`image_io.NotThisFormat` with that reason: the file goes on to the later
readers, as in PIL (a `P7 332` file is an XV thumbnail).
"""

from __future__ import annotations

import math

import numpy as np

MAX_PIXELS = 2 * 89478485  # PIL raises DecompressionBombError past this
SAFEBLOCK = 1024 * 1024  # PIL's ImageFile.SAFEBLOCK: each read of the plain decoder
WHITESPACE = b" \t\n\x0b\x0c\r"
MAX_TOKEN = 10  # PIL's limit on a header or data token
MODES = {
    b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
    b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK",
}
REFUSED_MAGICS = {b"PF": "a colour PFM file (PF), which PIL 12 does not read",
                  b"P7": "a PAM file (P7), which PIL does not read"}
BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
SUPPORTED = "the port reads the PPM, PGM, PBM and PFM files PIL reads (PpmImagePlugin)"
_IS_SPACE = np.zeros(256, bool)
_IS_SPACE[list(WHITESPACE)] = True
_IS_DIGIT = np.zeros(256, bool)
_IS_DIGIT[list(b"0123456789")] = True


def accepts(head: bytes) -> bool:
    """PIL's PpmImagePlugin._accept: "P" then one of 0-6, f, y."""
    return len(head) >= 2 and head.startswith(b"P") and head[1] in b"0123456fy"


def refused_magic(head: bytes):
    """The refusal of a magic PIL does not read, or None."""
    return next((why for magic, why in REFUSED_MAGICS.items() if head.startswith(magic)), None)


def _refuse(name, what: str):
    raise ValueError(f"{name}: {what}; {SUPPORTED}")


def open_ppm(path):
    """The `image_io.Picture` of a PPM, PGM, PBM or PFM file."""
    with open(path, "rb") as f:
        return decode_ppm(f.read(), str(path))


class _Reader:
    """The header's bytes one at a time, as PIL's fp.read(1) gives them."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def byte(self) -> bytes:
        c = self.data[self.pos:self.pos + 1]
        self.pos += len(c)
        return c

    def magic(self) -> bytes:
        magic = b""
        for _ in range(6):
            c = self.byte()
            if not c or c in WHITESPACE:
                break
            magic += c
        return magic

    def token(self, name) -> bytes:
        token = b""
        while len(token) <= MAX_TOKEN:
            c = self.byte()
            if not c:
                break
            if c in WHITESPACE:
                if not token:
                    continue
                break
            if c == b"#":  # the rest of the line; at the end of the file b"" is "in" b"\r\n"
                while self.byte() not in b"\r\n":
                    pass
                continue
            token += c
        if not token:
            _refuse(name, "the file ends in its header (PIL: Reached EOF while reading header)")
        if len(token) > MAX_TOKEN:
            _refuse(name, f"a header token of more than {MAX_TOKEN} bytes, {token!r} (PIL: Token too long)")
        return token


def _number(cast, token: bytes, name, what: str):
    try:
        return cast(token)
    except ValueError:
        _refuse(name, f"a {what} of {token!r}, which is not a number")


def decode_ppm(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of PPM / PGM / PBM / PFM bytes: PIL's pixels
    (with a channel axis) and mode."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    why = refused_magic(data)
    if why:  # PIL's PPM plugin does not take these magics: the file goes on through the order (P7 332: XV)
        raise NotThisFormat(f"{name}: {why}; {SUPPORTED}")
    if not accepts(data[:2]):
        _refuse(name, "not a PPM, PGM, PBM or PFM file")
    r = _Reader(data)
    magic = r.magic()
    if magic not in MODES:
        _refuse(name, f"the magic {magic!r}, which PIL does not read")
    mode = MODES[magic]
    width = _number(int, r.token(name), name, "width")
    height = _number(int, r.token(name), name, "height")
    plain = magic in (b"P1", b"P2", b"P3")
    maxval = None
    if mode == "F":
        scale = _number(float, r.token(name), name, "scale")
        if scale == 0.0 or not math.isfinite(scale):
            _refuse(name, f"a PFM scale of {scale} (PIL: scale must be finite and non-zero)")
    elif mode != "1":
        maxval = _number(int, r.token(name), name, "maxval")
        if not 0 < maxval < 65536:
            _refuse(name, f"a maxval of {maxval} (PIL: maxval must be greater than 0 and less than 65536)")
        if maxval > 255 and mode == "L":
            mode = "I"
    if width <= 0 or height <= 0:
        _refuse(name, f"a size of {width}x{height}")
    if width * height > MAX_PIXELS:
        _refuse(name, f"an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    start, bands = r.pos, BANDS[mode]
    count = width * height * bands
    if plain:
        if mode == "1":
            values = _plain_bits(data, start, count, name) == ord("0")  # "0" is white
        else:
            values = _scaled(_plain_values(data, start, count, maxval, name), maxval, mode, clip=False)
    elif mode == "1":  # P4: rows of bits, most significant first, 1 black
        stride = (width + 7) // 8
        rows = _raw(data, start, height * stride, name).reshape(height, stride)
        values = np.unpackbits(rows, axis=1)[:, :width] == 0
    elif mode == "F":
        floats = _raw(data, start, 4 * count, name).view("<f4" if scale < 0 else ">f4")
        values = floats.reshape(height, width)[::-1].astype("<f4")
    elif maxval == 255:
        values = _raw(data, start, count, name)
    elif maxval == 65535 and mode == "I":  # PIL's raw decoder, "I;16B"
        values = _raw(data, start, 2 * count, name).view(">u2").astype("<i4")
    else:  # PIL's PpmDecoder: whole pixels, then PIL raises on the shortfall
        wide = maxval > 255
        got = min(len(data) - start, count * (2 if wide else 1))
        pixels = got // ((2 if wide else 1) * bands)
        if pixels < width * height:
            _refuse(name, f"data for {pixels} of its {width * height} pixels (PIL: not enough image data)")
        stored = np.frombuffer(data, ">u2" if wide else np.uint8, count, start)
        values = _scaled(stored, maxval, mode, clip=True)
    palette = np.zeros((0, 3), np.uint8) if mode == "P" else None
    return Picture(np.ascontiguousarray(values.reshape(height, width, bands)), mode, palette)


def _raw(data: bytes, start: int, size: int, name) -> np.ndarray:
    """PIL's raw decoder: `size` bytes from `start`, or a truncation."""
    if len(data) - start < size:
        _refuse(name, f"truncated data ({max(len(data) - start, 0)} of {size} bytes; PIL: image file is "
                      f"truncated)")
    return np.frombuffer(data, np.uint8, size, start)


def _scaled(values: np.ndarray, maxval: int, mode: str, clip: bool) -> np.ndarray:
    """round(value / maxval * out_max) as PIL computes it (a double, Python's
    round half to even; np.rint rounds so too), clipped at out_max by the
    binary decoder; int32 for "I", else uint8."""
    out_max = 65535 if mode == "I" else 255
    v = np.rint(values.astype(np.float64) / maxval * out_max)
    if clip:
        v = np.minimum(v, out_max)
    return v.astype("<i4" if mode == "I" else np.uint8)


# ---- the plain formats, as PIL's PpmPlainDecoder reads them ----

class _Blocks:
    """The file from `start` in SAFEBLOCK reads, with PIL's comment removal
    (`_ignore_comments`, whose comment may span reads)."""

    def __init__(self, data: bytes, start: int):
        self.data, self.pos, self.spans = data, start, False

    def read(self) -> bytes:
        block = self.data[self.pos:self.pos + SAFEBLOCK]
        self.pos += len(block)
        return block

    @staticmethod
    def _comment_end(block: bytes, start: int = 0) -> int:
        a, b = block.find(b"\n", start), block.find(b"\r", start)
        return min(a, b) if a * b > 0 else max(a, b)  # PIL's test, quirk at index 0 included

    def without_comments(self, block: bytes) -> bytes:
        if self.spans:
            while block:
                end = self._comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.read()
        self.spans = False
        while True:
            at = block.find(b"#")
            if at == -1:
                break
            end = self._comment_end(block, at)
            if end != -1:
                block = block[:at] + block[end + 1:]
            else:
                block = block[:at]
                self.spans = True
                break
        return block


def _plain_bits(data: bytes, start: int, count: int, name) -> np.ndarray:
    """P1's first `count` digits (uint8 "0" / "1"), whitespace optional."""
    reads, parts, have = _Blocks(data, start), [], 0
    while have != count:
        block = reads.read()
        if not block:
            break
        a = np.frombuffer(reads.without_comments(block), np.uint8)
        digits = a[~_IS_SPACE[a]]
        bad = (digits != ord("0")) & (digits != ord("1"))
        if bad.any():  # PIL checks every digit of the read
            _refuse(name, f"the byte {bytes([digits[np.argmax(bad)]])!r} in P1 data (PIL: Invalid token for "
                          f"this mode)")
        parts.append(digits[:count - have])
        have += len(parts[-1])
    if have < count:
        _refuse(name, f"{have} of its {count} samples (PIL: not enough image data)")
    return np.concatenate(parts)


def _plain_values(data: bytes, start: int, count: int, maxval: int, name) -> np.ndarray:
    """The first `count` sample values of P2 / P3 data (int64)."""
    reads, parts, have, half = _Blocks(data, start), [], 0, b""
    while have != count:
        block = reads.read()
        if not block:
            if not half:
                break
            block = b" "  # the last token, unfinished at the end of the file
        block = reads.without_comments(block)
        if half:
            block, half = half + block, b""
        a = np.frombuffer(block, np.uint8)
        space = _IS_SPACE[a]
        edge = np.flatnonzero(np.diff(np.concatenate([[True], space, [True]]).astype(np.int8)))
        starts, ends = edge[0::2], edge[1::2]  # each run of non-whitespace bytes
        if len(block) and not space[-1]:  # the read may have cut its last token
            half = block[starts[-1]:]
            starts, ends = starts[:-1], ends[:-1]
            if len(half) > MAX_TOKEN:
                _refuse(name, f"a data token of more than {MAX_TOKEN} bytes (PIL: Token too long)")
        starts, ends = starts[:count - have], ends[:count - have]
        parts.append(_token_values(a, starts, ends, maxval, name))
        have += len(parts[-1])
    if have < count:
        _refuse(name, f"{have} of its {count} samples (PIL: not enough image data)")
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def _token_values(a: np.ndarray, starts: np.ndarray, ends: np.ndarray, maxval: int, name) -> np.ndarray:
    """The values of the tokens a[starts[i]:ends[i]], checked in order as
    PIL checks them."""
    lengths = ends - starts
    other = np.cumsum(np.concatenate([[0], ~_IS_DIGIT[a]]))
    plain = (other[ends] == other[starts]) & (lengths <= MAX_TOKEN)
    if not plain.all():  # a sign, an underscore, a long token: PIL's own loop
        return np.array([_one_token(bytes(a[s:e]), maxval, name) for s, e in zip(starts, ends)], np.int64)
    values = np.zeros(len(starts), np.int64)
    for j in range(int(lengths.max(initial=0))):  # Horner's rule, one digit place of every token at a time
        inside = lengths > j
        digit = a[np.minimum(starts + j, len(a) - 1)].astype(np.int64) - ord("0")
        values = np.where(inside, values * 10 + digit, values)
    over = values > maxval
    if over.any():
        _refuse(name, f"a sample of {values[np.argmax(over)]} over maxval {maxval} (PIL: Channel value too "
                      f"large for this mode)")
    return values


def _one_token(token: bytes, maxval: int, name) -> int:
    if len(token) > MAX_TOKEN:
        _refuse(name, f"a data token of more than {MAX_TOKEN} bytes (PIL: Token too long)")
    value = _number(int, token, name, "sample")
    if value < 0:
        _refuse(name, f"a negative sample, {value}")
    if value > maxval:
        _refuse(name, f"a sample of {value} over maxval {maxval} (PIL: Channel value too large for this mode)")
    return value
