"""JPEG 2000 reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL. PIL reads a JPEG 2000
file in two steps, and this module follows both:

- its Python plugin (Jpeg2KImagePlugin) decides the size and mode: from a
  raw codestream's SIZ (Csiz components: 1 "L" or, above 8 bits, "I;16",
  2 "LA", 3 "RGB", 4 "RGBA"), or from a JP2's header box: `ihdr` the same
  way, a `colr` box of enumerated CMYK (12) on 4 components "CMYK", a
  `pclr` box on "L" / "LA" "P" / "PA" with the palette PIL's
  `ImagePalette.getcolor` builds from its entries (each colour kept once);
  `res ` and the `jpx ` brand change no pixel;
- OpenJPEG 2.5 decodes it tile by tile. Its JP2 reader checks the boxes
  (signature, file type, header, `ihdr`, `colr`, `pclr`, `cmap`, `cdef`),
  takes the colour space from the first `colr` box (enumerated 16 sRGB,
  17 grey, 18 sYCC, 24 e-sYCC, 12 CMYK; anything else unspecified, which
  PIL reads by the number of components, or as sYCC where components 1 or
  2 are subsampled) and applies no palette or channel definition: PIL
  unpacks the codestream's components as they are, subsampled ones by its
  own strides, sYCC converted by its own YCbCr tables. A JPX file with
  several codestreams reads as its first. The codestream is decoded by the
  compiled `csrc/jp2_decode.cc` (host C++, built at first use; no
  fallback), which also applies PIL's unpackers: every JPEG 2000 Part 1
  feature (SOP / EPH, PPM / PPT, POC, the six code-block styles, RGN,
  subsampling, unknown markers) as OpenJPEG decodes it for PIL, HTJ2K
  (JPEG 2000 Part 15, ITU-T T.814: the HT block coder's cleanup, SigProp
  and MagRef passes, its CAP and CPF markers) as OpenJPEG 2.5's HT decoder
  reads it, and what OpenJPEG 2.5 makes of Part 2 (ITU-T T.801): Rsiz bit
  15, the MCT / MCC / MCO records (whose offset array becomes the DC level
  shift), CBD (each component's precision and sign), every other Part 2
  marker skipped as an unknown one; samples of 1 to 31 bits (above 16,
  PIL's "I;16" for grey and its 8-bit modes otherwise, rounded down as
  its unpackers do); damaged files included.

Where PIL raises (more than 4 components among such files), this raises a
`ValueError` naming the file; it refuses no file PIL reads.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from gaussian_splatting_torch.utils import cuda_build
from gaussian_splatting_torch.utils.bmp import MAX_PIXELS

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"
SIGNATURES = (JP2_SIGNATURE, J2K_SIGNATURE)
# PIL's modes, in the decoder's order
MODES = ("L", "P", "PA", "I;16", "LA", "RGB", "RGBA", "CMYK")
# a JP2 colr box's enumerated colour space -> OpenJPEG's (OPJ_CLRSPC_*:
# 0 unspecified, 1 sRGB, 2 grey, 3 sYCC, 4 e-sYCC, 5 CMYK); any other
# (or an ICC profile, or no colr box) is unspecified, which PIL reads by
# the number of components
COLOUR_SPACES = {16: 1, 17: 2, 18: 3, 24: 4, 12: 5}
UNSPECIFIED_SPACE = 0


class _Boxes:
    """PIL's `BoxReader` over `data` from `pos`: its reads, its checks
    and its errors (`length` < 0: no known end)."""

    def __init__(self, data: bytes, pos: int = 0, length: int = -1):
        self.data, self.pos, self.length, self.remaining = data, pos, length, -1

    def _can_read(self, n: int) -> bool:
        if self.length >= 0 and self.pos + n > self.length:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def read(self, n: int) -> bytes:
        if not self._can_read(n):
            raise ValueError("Not enough data in header")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += len(chunk)
        if len(chunk) < n:
            raise ValueError(f"Expected to read {n} bytes but only got {len(chunk)}.")
        if self.remaining > 0:
            self.remaining -= n
        return chunk

    def fields(self, form: str) -> tuple:
        return struct.unpack(form, self.read(struct.calcsize(form)))

    def boxes(self) -> "_Boxes":
        n = self.remaining
        return _Boxes(self.read(n), 0, n)

    def has_next(self) -> bool:
        return self.pos + self.remaining < self.length if self.length >= 0 else True

    def next_type(self) -> bytes:
        if self.remaining > 0:
            self.pos += self.remaining
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.fields(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise ValueError("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


def _getcolor_palette(entries: list[tuple], rgba: bool) -> np.ndarray:
    """The palette PIL's `ImagePalette.getcolor` builds from `entries` (a
    colour met before is not added again), as PIL's core holds it."""
    width = 4 if rgba else 3
    raw, colours = bytearray(), {}
    for colour in entries:
        if rgba and len(colour) == 3:
            colour += (255,)
        if not rgba and len(colour) == 4:
            if colour[3] != 255:
                raise ValueError("cannot add non-opaque RGBA color to RGB palette")
            colour = colour[:3]
        if colour in colours:
            continue
        index = len(raw) // width
        if index >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        colours[colour] = index
        if index * width < len(raw):
            raw = raw[:index * width] + bytes(colour) + raw[index * width + width:]
        else:
            raw += bytes(colour)
    n = len(raw) // width
    return np.frombuffer(bytes(raw[:n * width]), np.uint8).reshape(n, width)


def _pil_header(data: bytes):
    """PIL's `Jpeg2KImageFile._open`: (size, mode, palette); raises where
    it raises."""
    if data.startswith(J2K_SIGNATURE):
        siz = data[4:4 + struct.unpack(">H", data[4:6])[0]]
        _, _, xsiz, ysiz, xosiz, yosiz, *_, csiz = struct.unpack_from(">HHIIIIIIIIH", siz)
        if csiz == 1:
            mode = "I;16" if (struct.unpack_from(">B", siz, 38)[0] & 0x7F) + 1 > 8 else "L"
        elif 2 <= csiz <= 4:
            mode = ("LA", "RGB", "RGBA")[csiz - 2]
        else:
            raise ValueError(f"unable to determine J2K image mode ({csiz} components)")
        _pil_comments(data, 4 + len(siz))
        return (xsiz - xosiz, ysiz - yosiz), mode, None
    reader = _Boxes(data, len(JP2_SIGNATURE))
    header = None
    while reader.has_next():
        kind = reader.next_type()
        if kind == b"jp2h":
            header = reader.boxes()
            break
        if kind == b"ftyp":
            reader.fields(">4s")
    if header is None:
        raise ValueError("no JP2 header box")
    size = mode = nc = palette = None
    while header.has_next():
        kind = header.next_type()
        if kind == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            if nc == 1:
                mode = "I;16" if (bpc & 0x7F) > 8 else "L"
            elif 2 <= nc <= 4:
                mode = ("LA", "RGB", "RGBA")[nc - 2]
        elif kind == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif kind == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            if max(header.fields(">" + "B" * npc), default=0) <= 8:
                palette = _getcolor_palette([header.fields(">" + "B" * npc) for _ in range(ne)], npc == 4)
                mode = "P" if mode == "L" else "PA"
        elif kind == b"res ":
            res = header.boxes()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise ValueError(f"Malformed JP2 header ({nc} components)" if nc else "Malformed JP2 header")
    at = reader.pos  # the end of the header box
    if data[at:at + 12].endswith(b"jp2c" + J2K_SIGNATURE):
        at += 12
        _pil_comments(data, at + _i16(data, at))
    return size, mode, palette


def _i16(data: bytes, at: int) -> int:
    if at + 2 > len(data):
        raise ValueError("truncated marker segment")
    return struct.unpack_from(">H", data, at)[0]


def _pil_comments(data: bytes, at: int) -> None:
    """PIL's `_parse_comment`: it walks the main header's marker segments
    after SIZ to the first COM, SOT or EOC, and raises where a segment's
    length cannot be read."""
    while True:
        marker = data[at:at + 2]
        if not marker:
            return
        if len(marker) < 2:
            raise ValueError("truncated marker")
        if marker[1] in (0x90, 0xD9):
            return
        length = _i16(data, at + 2)
        if marker[1] == 0x64:
            return
        at += 2 + length


def _opj_boxes(data: bytes):
    """OpenJPEG's JP2 reader (opj_jp2_read_header_procedure and its box
    handlers): (codestream offset, colour space, ihdr width, ihdr height);
    raises where it fails."""
    n = len(data)
    state = 0  # 1 signature, 2 file type, 4 header
    info = {"ihdr": None, "enumcs": 0, "colr": False, "pclr": None, "cmap": False, "cdef": False}
    pos = 0
    while pos + 8 <= n:
        lbox, kind = struct.unpack_from(">I4s", data, pos)
        hlen = 8
        if lbox == 0:
            lbox = n - pos
        elif lbox == 1:
            if pos + 16 > n:
                break
            high, lbox = struct.unpack_from(">II", data, pos + 8)
            if high:
                raise ValueError("Cannot handle box sizes higher than 2^32")
            hlen = 16
        if kind == b"jp2c":
            if not state & 4:
                raise ValueError("bad placed jpeg codestream")
            space = COLOUR_SPACES.get(info["enumcs"], UNSPECIFIED_SPACE)
            return pos + hlen, space, info["ihdr"][0], info["ihdr"][1]
        if lbox == 0:
            raise ValueError("Cannot handle box of undefined sizes")
        if lbox < hlen:
            raise ValueError(f"invalid box size {lbox}")
        body = data[pos + hlen:pos + lbox]
        if pos + lbox > n:
            raise ValueError(f"Invalid box size {lbox} for box {kind!r}")
        if kind == b"jP  ":
            if state != 0 or len(body) != 4 or body != b"\r\n\x87\n":
                raise ValueError("Error with JP signature Box")
            state |= 1
        elif kind == b"ftyp":
            if state != 1 or len(body) < 8 or (len(body) - 8) % 4:
                raise ValueError("Error with FTYP signature Box")
            state |= 2
        elif kind == b"jp2h":
            _opj_jp2h(body, info)
            state |= 4
        elif kind in _IMAGE_BOXES:
            if state & 4:  # a misplaced box read anyway once the header is read
                _IMAGE_BOXES[kind](body, info)
        elif not state & 1 or not state & 2:
            raise ValueError("Malformed JP2 file format: the first boxes must be the signature and file type")
        pos += lbox
    raise ValueError("no codestream box (Expected a SOC marker)")


def _opj_jp2h(body: bytes, info: dict) -> None:
    pos, has_ihdr = 0, False
    while pos < len(body):
        if len(body) - pos < 8:
            raise ValueError("Cannot handle box of less than 8 bytes")
        lbox, kind = struct.unpack_from(">I4s", body, pos)
        hlen = 8
        if lbox == 1:
            if len(body) - pos < 16:
                raise ValueError("Cannot handle XL box of less than 16 bytes")
            high, lbox = struct.unpack_from(">II", body, pos + 8)
            if high:
                raise ValueError("Cannot handle box sizes higher than 2^32")
            hlen = 16
        if lbox == 0:
            raise ValueError("Cannot handle box of undefined sizes")
        if lbox < hlen:
            raise ValueError("Box length is inconsistent.")
        if lbox > len(body) - pos:
            raise ValueError("Stream error while reading JP2 Header box: box length is inconsistent.")
        if kind in _IMAGE_BOXES:
            _IMAGE_BOXES[kind](body[pos + hlen:pos + lbox], info)
        has_ihdr |= kind == b"ihdr"
        pos += lbox
    if not has_ihdr:
        raise ValueError("Stream error while reading JP2 Header box: no 'ihdr' box.")


def _ihdr(b: bytes, info: dict) -> None:
    if info["ihdr"] is not None:
        return
    if len(b) != 14:
        raise ValueError("Bad image header box (bad size)")
    h, w, nc = struct.unpack_from(">IIH", b)
    if not 1 <= nc <= 16384:
        raise ValueError("Invalid number of components (ihdr)")
    info["ihdr"] = (w, h)
    info["nc"] = nc


def _colr(b: bytes, info: dict) -> None:
    if len(b) < 3:
        raise ValueError("Bad COLR header box (bad size)")
    if info["colr"]:
        return
    if b[0] == 1:
        if len(b) < 7:
            raise ValueError(f"Bad COLR header box (bad size: {len(b)})")
        info["enumcs"] = struct.unpack_from(">I", b, 3)[0]
        info["colr"] = True
    elif b[0] == 2:
        info["colr"] = True


def _bpcc(b: bytes, info: dict) -> None:
    if info["ihdr"] is None or info["nc"] != len(b):
        raise ValueError("Bad BPCC header box (bad size)")


def _pclr(b: bytes, info: dict) -> None:
    if info["pclr"] is not None or len(b) < 3:
        raise ValueError("Invalid PCLR box")
    ne, npc = struct.unpack_from(">HB", b)
    if not 1 <= ne <= 1024 or npc == 0 or len(b) < 3 + npc:
        raise ValueError(f"Invalid PCLR box. Reports {ne} entries, {npc} columns")
    width = sum(min(4, ((d & 0x7F) + 8) >> 3) for d in b[3:3 + npc])
    if len(b) < 3 + npc + ne * width:
        raise ValueError("Invalid PCLR box (too short)")
    info["pclr"] = npc


def _cmap(b: bytes, info: dict) -> None:
    if info["pclr"] is None:
        raise ValueError("Need to read a PCLR box before the CMAP box.")
    if info["cmap"]:
        raise ValueError("Only one CMAP box is allowed.")
    if len(b) < 4 * info["pclr"]:
        raise ValueError("Insufficient data for CMAP box.")
    info["cmap"] = True


def _cdef(b: bytes, info: dict) -> None:
    if info["cdef"] or len(b) < 2:
        raise ValueError("Insufficient data for CDEF box.")
    (count,) = struct.unpack_from(">H", b)
    if count == 0:
        raise ValueError("Number of channel description is equal to zero in CDEF box.")
    if len(b) < 2 + 6 * count:
        raise ValueError("Insufficient data for CDEF box.")
    info["cdef"] = True


_IMAGE_BOXES = {b"ihdr": _ihdr, b"colr": _colr, b"bpcc": _bpcc, b"pclr": _pclr, b"cmap": _cmap, b"cdef": _cdef}


def _library(name):
    try:
        lib = cuda_build.load_host("jp2_decode")
    except RuntimeError as err:
        raise RuntimeError(f"{name}: the JPEG 2000 decoder (csrc/jp2_decode.cc) could not be built: {err}") from err
    if not hasattr(lib, "_gs_typed"):
        lib.gs_jp2_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        lib.gs_jp2_decode.restype = ctypes.c_int
        lib.gs_jp2_segments.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
        lib.gs_jp2_segments.restype = ctypes.c_longlong
        lib.gs_jp2_error.argtypes, lib.gs_jp2_error.restype = [], ctypes.c_char_p
        lib._gs_typed = True
    return lib


def _raise(name, what: str):
    raise ValueError(f"{name}: {what} (JPEG 2000: PIL fails on this file)")


def open_jp2(path):
    """The `image_io.Picture` of a JP2 / JPX file or a raw JPEG 2000
    codestream, with PIL's mode, pixels and palette."""
    from gaussian_splatting_torch.utils.image_io import Picture

    with open(path, "rb") as f:
        data = f.read()
    try:
        (width, height), mode, palette = _pil_header(data)
        if data.startswith(J2K_SIGNATURE):
            start, space, ihdr_w, ihdr_h = 0, UNSPECIFIED_SPACE, 0, 0
        else:
            start, space, ihdr_w, ihdr_h = _opj_boxes(data)
    except (ValueError, struct.error) as err:
        _raise(path, str(err))
    if width <= 0 or height <= 0 or width * height > MAX_PIXELS:  # PIL's decompression bomb limit
        raise ValueError(f"{path}: a JPEG 2000 image of {width}x{height} pixels")
    lib = _library(path)
    bpp = 1 if mode in ("L", "P") else 2 if mode == "I;16" else 4
    out = np.zeros((height, width, bpp), np.uint8)
    codestream = data[start:]
    if lib.gs_jp2_decode(codestream, len(codestream), MODES.index(mode), space, width, height, ihdr_w, ihdr_h,
                         out.ctypes.data):
        _raise(path, lib.gs_jp2_error().decode())
    if mode == "I;16":
        pixels = out.view("<u2")
    elif mode in ("LA", "PA"):
        pixels = np.ascontiguousarray(out[..., [0, 3]])
    elif mode == "RGB":
        pixels = np.ascontiguousarray(out[..., :3])
    else:
        pixels = out
    return Picture(pixels, mode, palette)


def segments(data: bytes) -> list[tuple[int, int]]:
    """The (offset, length) of every code-block's coded data in a raw
    codestream (Part 1 and HT code-blocks alike), in decoding order (for
    tests that damage code-block bodies only)."""
    lib = _library("codestream")
    count = lib.gs_jp2_segments(data, len(data), None, 0)
    if count < 0:
        raise ValueError(lib.gs_jp2_error().decode())
    out = np.zeros((max(count, 1), 2), np.int64)
    lib.gs_jp2_segments(data, len(data), out.ctypes.data, count)
    return [(int(a), int(b)) for a, b in out[:count]]
