"""Image reading, PNG writing, and PIL's default resize, on zlib and numpy.

The JAX package reads every image with PIL and writes and reads its PNGs
with imageio. Neither is installed where the port runs, so the port keeps
its own:

- `open_image(path)`: the dataset readers' entry. It tries the readers
  in PIL's `Image.ID` order on the file's first bytes, as `Image.open`
  does (`READERS`): a BMP and a DIB to `utils/bmp.py`, a GIF to
  `utils/gif.py` (frame 0), a JPEG to the compiled JPEG decoder
  (`utils/jpeg.py`, PIL's bits: grey, RGB, and CMYK from CMYK and YCCK
  files), a PPM / PGM / PBM / PFM (PIL's magics: P1 to P6, Pf and its
  extensions) to `utils/ppm.py`, a PNG to `open_png`, an AVIF to
  `utils/avif.py` (the HEIF container, grid images too; the AV1 intra
  frame, its deblocking and libavif's YUV -> RGB by
  `csrc/av1_decode.cc`), a CUR and an ICO to
  `utils/ico.py`, a PCX and a DCX to `utils/pcx.py`, a DDS to
  `utils/dds.py` (uncompressed, luminance, palette and BC1-BC7 surfaces,
  the blocks by `csrc/bcn_decode.cc`), a JPEG 2000 file (a
  JP2 / JPX file or a raw codestream) to `utils/jp2.py`, a TIFF to
  `utils/tiff.py` (every TIFF PIL reads: fax, old-style JPEG, YCbCr,
  CIELab, 1- to 32-bit, signed and float samples included), a PSD to
  `utils/psd.py`, a QOI to `utils/qoi.py`, an SGI image to
  `utils/sgi.py`, a file that passes TGA's header checks to
  `utils/tga.py` (TGA has no signature; PIL tries it after all of those)
  and a WebP to `utils/webp.py` (lossy, lossless, alpha, frame 0 of an
  animation), a BLP to `utils/blp.py`, an EPS to
  `utils/eps.py` (PIL's parse, then Ghostscript where `gs` runs, as PIL
  does), a FITS to `utils/fits.py`, an FLI / FLC to `utils/fli.py`
  (frame 0), an FTEX to `utils/ftex.py`, a GIMP brush to `utils/gbr.py`
  and an icns to `utils/icns.py`; an IM file to `utils/im.py`, an IM
  Tools file to `utils/imt.py`, an IPTC/NAA file to `utils/iptc.py` (its
  image data opened again through these readers), a McIDAS area to
  `utils/mcidas.py`, an MSP to `utils/msp.py`, a PhotoCD to
  `utils/pcd.py`, a PIXAR raster to `utils/pixar.py`, a SPIDER image to
  `utils/spider.py`, a Sun raster to `utils/sun.py`, an XBM to
  `utils/xbm.py`, an XPM to `utils/xpm.py` and an XV thumbnail to
  `utils/xvthumb.py` (IM, IMT, IPTC, PCD and SPIDER test no first bytes
  in PIL: every file that reaches them goes through their rules); BUFR,
  GRIB and HDF5, which PIL opens as stubs it cannot load, and MPEG and
  WMF / EMF, whose load PIL cannot run, raise naming the format. The pixels are those of
  PIL's loaded image, which both dataset paths read. A reader that gives up as PIL's plugin does
  (`NotThisFormat`) passes the file to the next one, as PIL does; anything
  no reader takes raises a `ValueError` naming the file and the formats
  the port reads. It returns a `Picture`: the pixels as
  `np.asarray(Image.open(f))` gives them, with PIL's mode, palette and
  transparency, which `to_rgba` turns into PIL's `convert("RGBA")`.
  `read_image(path)` is its pixels.
- `open_png(path)` / `read_png(path)`: every PNG PIL reads, in PIL's
  modes: grey at 1 bit ("1"), 2, 4 and 8 bits ("L", scaled to 0..255),
  16 bits ("I;16"); RGB at 8 and 16 bits ("RGB", the high byte);
  palette at 1, 2, 4 and 8 bits ("P"); grey + alpha at 8 bits ("LA") and
  16 bits ("RGBA", the high bytes); RGBA at 8 and 16 bits ("RGBA");
  Adam7 interlacing; a tRNS chunk kept as PIL's `info["transparency"]`.
  All five row filters. Damaged files read as PIL reads them
  (`png_picture`: CRCs checked only before the image data, the chunks
  after it read as PIL's `load_end` reads them); a file that is not a
  PNG, or that PIL refuses, raises a `ValueError` naming the file and what
  is wrong.
- `write_png(path, array)`: 8-bit PNGs, every row with the Sub filter.
- `resize(array, (w, h))`: `PIL.Image.resize(size)` at its default, bit
  for bit: bicubic (a = -0.5) with its support widened by the downscale
  factor, coefficients normalised and held in 22-bit fixed point, a
  horizontal then a vertical pass, each rounded and clipped to uint8; a
  pass is skipped where its dimension does not change. Grey + alpha and
  RGBA are premultiplied first (PIL's `La` / `RGBa` modes) and divided
  back afterwards.
"""

from __future__ import annotations

import re
import struct
import zlib
from typing import Any, NamedTuple, Optional

import numpy as np

from gaussian_splatting_torch.utils import (avif, blp, bmp, dds, eps, fits, fli, ftex, gbr, gif, icns, ico, im, imt,
                                            iptc, jp2, jpeg, lab, mcidas, mpeg, msp, pcd, pcx, pixar, ppm, psd, qoi,
                                            sgi, spider, sun, tga, tiff, webp, wmf, xbm, xpm, xvthumb, ycbcr)

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# 8-bit channels -> PNG colour type (0 grey, 4 grey + alpha, 2 RGB, 6 RGBA),
# for the writer
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
# PNG colour type -> samples per pixel
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# (bit depth, colour type) -> PIL's mode (PngImagePlugin._MODES)
PNG_MODES = {
    (1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L", (16, 0): "I;16",
    (8, 2): "RGB", (16, 2): "RGB",
    (1, 3): "P", (2, 3): "P", (4, 3): "P", (8, 3): "P",
    (8, 4): "LA", (16, 4): "RGBA",
    (8, 6): "RGBA", (16, 6): "RGBA",
}
# Adam7's passes: first column and row, column and row steps
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_SIMPLE_PALETTE = re.compile(rb"^\xff*\x00\xff*$")


class Picture(NamedTuple):
    """A decoded image as PIL holds it.

    pixels: (H, W, C) as `np.asarray(Image.open(f))` gives them, with a
      channel axis kept for one channel: uint8 for "L", "LA", "RGB",
      "RGBA", "CMYK" (PIL's inverted CMYK JPEG samples, a TIFF's as
      stored), "YCbCr" (Y, Cb, Cr), "P" and "PA" (palette indices), bool
      for "1", uint16 for "I;16" and "I;16L" (little endian) and "I;16B"
      (big endian, as PIL's array), int32 for "I" and float32 for "F"
      (little endian).
    mode: PIL's mode.
    palette: mode "P": (N, 3) uint8, the palette's entries (PNG's PLTE,
      a BMP's colour table, a TIFF's ColorMap, a GIF's palette, a TGA's
      colour map, a PCX's 16 or 256 entries, a PSD's colour mode data, of
      no entries where PIL keeps none), or (N, 4) with each entry's alpha
      (a TGA's 16-bit map, a DDS's RGBA palette); a GIF of mode "L" (a grey-ramp local palette)
      keeps its global palette here, and a grey TGA ("L" or "LA") its
      colour map, which PIL's core holds the image with (as "P" or "PA")
      and `convert` applies.
    transparency: for "LAB", the alpha PIL's `convert("RGBA")` gives
      where it is not 255: 0 for a PSD's, whose bands PIL reads one by
      one and whose fourth byte it leaves 0. Else PIL's
      `info["transparency"]`: an int for "1" (0 or 255), "L" and "I;16"
      (the tRNS value) and for "P" whose tRNS clears
      one entry only (its index); an (r, g, b) tuple for "RGB"; the tRNS
      bytes (alpha per palette entry) for other "P" files; None without a
      tRNS chunk.
    """
    pixels: np.ndarray
    mode: str
    palette: Optional[np.ndarray] = None
    transparency: Any = None


def _refuse(path, what: str):
    raise ValueError(f"{path}: {what}; the port reads PNG files of every colour type and bit "
                     f"depth PIL reads")


JPEG_SIGNATURE = b"\xff\xd8\xff"  # SOI and the first marker's 0xFF, as PIL sniffs it
BMP_SIGNATURE = b"BM"


FORMATS = ("PNG, JPEG, BMP, DIB, TIFF, WebP, GIF, PPM / PGM / PBM / PFM, TGA, JPEG 2000, QOI, PCX / DCX, SGI, "
           "ICO / CUR, PSD, DDS, AVIF, BLP, FITS, FLI / FLC, FTEX, GBR, ICNS, EPS, IM, IM Tools, IPTC, McIDAS, MSP, "
           "PhotoCD, PIXAR, SPIDER, Sun raster, XBM, XPM or XV thumbnail")


class NotThisFormat(ValueError):
    """A reader's file that PIL's plugin for the format gives up on in a
    way that passes the file on to the next plugin (its `_open` raised
    SyntaxError, IndexError, TypeError, KeyError, EOFError or
    struct.error, or the size it read is empty): `open_image` tries the
    next reader in PIL's order. Any other `ValueError` of a reader ends
    `open_image`, as any other error ends PIL's `Image.open`."""


def _open_jpeg(path) -> Picture:
    pixels = jpeg.read_jpeg(path)
    return Picture(pixels, {1: "L", 3: "RGB", 4: "CMYK"}[pixels.shape[2]])


def _stub(fmt: str):
    """PIL's stub plugins (BUFR, GRIB, HDF5): the file opens as a 1x1 "F"
    image, and its load raises, as no handler is installed."""
    def read(path) -> Picture:
        raise ValueError(f"{path}: a {fmt} file, which PIL opens as a stub and cannot load (PIL: cannot find "
                         f"loader for this {fmt} file)")
    return read


def _of_bytes(decode):
    def read(path) -> Picture:
        with open(path, "rb") as f:
            return decode(f.read(), str(path))
    return read


def _sniffed(passes_on, n: int, decode):
    """A reader PIL tries on every file that reaches it: the first `n`
    bytes decide the files its `_open` passes on at once (`passes_on`),
    without reading the rest."""
    def read(path) -> Picture:
        with open(path, "rb") as f:
            why = passes_on(f.read(n))
            if why:
                raise NotThisFormat(f"{path}: {why} (PIL: passed on)")
            f.seek(0)
            return decode(f.read(), str(path))
    return read


def _always(head: bytes) -> bool:
    """No first-bytes test: PIL registers no `_accept` for the format."""
    return True


# The readers in PIL's `Image.ID` order (the formats `Image.preinit` loads,
# then `Image.init`'s, AVIF first of those), each with PIL's test of the
# file's first bytes.
# TGA has no signature: PIL tries it after every format before it, so a
# TGA whose first bytes a CUR, PCX, DIB or ICO reader takes reads as
# PIL reads it, through that reader first. IM, IMT, IPTC, PCD and SPIDER
# have none either: every file that reaches them goes through their
# `_open`, which passes it on or reads it, as in PIL. PIL tests the first
# 16 bytes (XBM's test, which strips blanks first, is the one that sees
# the difference).
READERS = (
    ("BMP", lambda head: head.startswith(BMP_SIGNATURE), bmp.open_bmp),
    ("DIB", bmp.dib_accepts, _of_bytes(bmp.decode_dib)),
    ("GIF", lambda head: head.startswith(gif.SIGNATURES), gif.open_gif),
    ("JPEG", lambda head: head.startswith(JPEG_SIGNATURE), _open_jpeg),
    ("PPM", lambda head: ppm.accepts(head) or ppm.refused_magic(head), ppm.open_ppm),
    ("PNG", lambda head: head.startswith(PNG_SIGNATURE), lambda path: open_png(path)),
    ("AVIF", avif.accepts, _of_bytes(avif.decode_avif)),  # the first of Image.init's formats
    ("BLP", blp.accepts, _of_bytes(blp.decode_blp)),
    ("BUFR", lambda head: head.startswith((b"BUFR", b"ZCZC")), _stub("BUFR")),
    ("CUR", lambda head: head.startswith(ico.CUR_SIGNATURE), _of_bytes(ico.decode_cur)),
    ("PCX", pcx.accepts, _of_bytes(pcx.decode_pcx)),
    ("DCX", pcx.dcx_accepts, _of_bytes(pcx.decode_dcx)),
    ("DDS", lambda head: head.startswith(dds.SIGNATURE), _of_bytes(dds.decode_dds)),
    ("EPS", eps.accepts, eps.open_eps),
    ("FITS", lambda head: head.startswith(fits.SIGNATURE), _of_bytes(fits.decode_fits)),
    ("FLI", fli.accepts, _of_bytes(fli.decode_fli)),
    ("FTEX", lambda head: head.startswith(ftex.SIGNATURE), _of_bytes(ftex.decode_ftex)),
    ("GBR", gbr.accepts, _of_bytes(gbr.decode_gbr)),
    ("GRIB", lambda head: len(head) >= 8 and head.startswith(b"GRIB") and head[7] == 1, _stub("GRIB")),
    ("HDF5", lambda head: head.startswith(b"\x89HDF\r\n\x1a\n"), _stub("HDF5")),
    ("JPEG2000", lambda head: head.startswith(jp2.SIGNATURES), jp2.open_jp2),  # Jpeg2KImagePlugin._accept
    ("ICNS", lambda head: head.startswith(icns.SIGNATURE), _of_bytes(icns.decode_icns)),
    ("ICO", lambda head: head.startswith(ico.ICO_SIGNATURE), _of_bytes(ico.decode_ico)),
    ("IM", _always, _sniffed(im.passes_on, 100, im.decode_im)),
    ("IMT", _always, _sniffed(imt.passes_on, 100, imt.decode_imt)),
    ("IPTC", _always, _sniffed(iptc.passes_on, 5, iptc.decode_iptc)),
    ("MCIDAS", mcidas.accepts, _of_bytes(mcidas.decode_mcidas)),
    ("MPEG", mpeg.accepts, _of_bytes(mpeg.decode_mpeg)),
    ("TIFF", lambda head: head.startswith(tiff.SIGNATURES), tiff.open_tiff),
    ("MSP", msp.accepts, _of_bytes(msp.decode_msp)),
    ("PCD", _always, _sniffed(pcd.passes_on, 2048 + 1539, pcd.decode_pcd)),
    ("PIXAR", pixar.accepts, _of_bytes(pixar.decode_pixar)),
    ("PSD", lambda head: head.startswith(psd.SIGNATURE), _of_bytes(psd.decode_psd)),
    ("QOI", lambda head: head.startswith(qoi.SIGNATURE), _of_bytes(qoi.decode_qoi)),
    ("SGI", lambda head: head.startswith(sgi.SIGNATURE), _of_bytes(sgi.decode_sgi)),
    ("SPIDER", _always, _sniffed(spider.passes_on, 108, spider.decode_spider)),
    ("SUN", sun.accepts, _of_bytes(sun.decode_sun)),
    ("TGA", tga.looks_like_tga, tga.open_tga),
    ("WEBP", lambda head: head.startswith(b"RIFF") and head[8:12] == b"WEBP", webp.open_webp),
    ("WMF", wmf.accepts, _of_bytes(wmf.decode_wmf)),
    ("XBM", xbm.accepts, _of_bytes(xbm.decode_xbm)),
    ("XPM", xpm.accepts, _of_bytes(xpm.decode_xpm)),
    ("XVTHUMB", xvthumb.accepts, _of_bytes(xvthumb.decode_xvthumb)),
)


def open_image(path) -> Picture:
    """The `Picture` of a PNG, JPEG, BMP, DIB, TIFF, WebP, GIF, PPM / PGM /
    PBM / PFM, TGA, JPEG 2000, QOI, PCX / DCX, SGI, ICO / CUR, PSD, DDS,
    AVIF, BLP, FITS, FLI / FLC, FTEX, GBR, ICNS, EPS, IM, IM Tools, IPTC,
    McIDAS, MSP, PhotoCD, PIXAR, SPIDER, Sun raster, XBM, XPM or XV
    thumbnail file, PIL's pixels and mode (of the loaded image). The readers are tried in PIL's order (`READERS`)
    on the file's first bytes; one that gives up as PIL's plugin gives up
    (`NotThisFormat`) passes the file to the next, any other refusal
    raises. JPEG (mode "L", "RGB" or "CMYK", and the strips and tiles of a
    JPEG-in-TIFF, old-style ones too), WebP ("RGB" or "RGBA") and JPEG
    2000 (Part 1, Part 2 and HTJ2K; "L", "I;16", "LA", "RGB", "RGBA",
    "CMYK", "P", "PA") are decoded by compiled decoders, TIFF's CCITT fax
    by its own, and BMP's RLE, TIFF's LZW (both styles), PackBits and
    ThunderScan, GIF's LZW, TGA's RLE, QOI's ops, PCX's and SGI's RLE and
    PSD's PackBits by the compiled codecs, DDS's BC1-BC7 blocks by the
    compiled block decoder, AVIF ("RGB" or "RGBA"; `utils/avif.py`) by the
    compiled AV1 intra decoder and libavif's YUV -> RGB, each built at
    first use; if one
    cannot be built this raises. TIFF: every form PIL reads
    (`utils/tiff.py`), in its modes "1", "L", "I;16", "I;16B", "I", "F",
    "LA", "P", "PA", "RGB", "RGBA", "CMYK", "LAB". QOI "RGB" / "RGBA"; PCX
    and DCX "1", "P", "L", "RGB"; SGI "L", "RGB", "RGBA" (16-bit too);
    ICO a PNG entry's mode or "RGBA", CUR a BMP's; PSD "1", "L", "P",
    "RGB", "RGBA", "CMYK", "LAB"; DDS "L", "LA", "P", "RGB", "RGBA"; BLP
    "RGB" / "RGBA" (BLP2's DXT blocks by the compiled block decoder, a
    BLP1's JPEG by the JPEG decoder); FITS "L", "I;16", "I", "F"; FLI / FLC
    "P" (frame 0 by the compiled FLI decoder); FTEX "RGB" / "RGBA"; GBR
    "L" / "RGBA"; ICNS "RGB" / "RGBA" or a PNG entry's mode (its runs by
    the compiled codecs); EPS the mode of the PNM Ghostscript draws, where
    `gs` runs (else it raises, as PIL does); IM "1", "L", "P", "PA", "LA",
    "RGB", "RGBA", "CMYK", "YCbCr", "I", "I;16", "I;16L", "I;16B", "F"
    (its bit-packed floats by the compiled codecs); IM Tools "L"; IPTC
    "L", or "RGB" / "CMYK" of one band; McIDAS "L", "I;16B", "I"; MSP and
    XBM "1" (MSP's runs and XBM's hex text by the compiled codecs);
    PhotoCD "RGB" (its YCC rows by the compiled codecs); PIXAR "RGB";
    SPIDER "F"; Sun raster "1", "L", "P", "RGB" (its RLE by the compiled
    codecs); XPM "P" or "RGB"; XV thumbnails "P". BUFR, GRIB and HDF5,
    which PIL opens as stubs and cannot load, and MPEG and WMF / EMF,
    whose load raises in PIL, raise naming the format."""
    with open(path, "rb") as f:
        head = f.read(tga.HEADER)
    passed = []
    for _, accepts, read in READERS:
        if accepts(head):
            try:
                return read(path)
            except NotThisFormat as err:
                passed.append(str(err))
    raise ValueError(f"{path}: not a {FORMATS} file; the port reads those image formats"
                     + "".join(f" ({why})" for why in passed))


def read_image(path) -> np.ndarray:
    """`np.asarray(Image.open(path))` of any file `open_image` reads, with
    a channel axis kept (`open_image(path).pixels`)."""
    return open_image(path).pixels


def _sniff(head: bytes) -> str:
    if head.startswith(JPEG_SIGNATURE):
        return "a JPEG file (read_image reads it)"
    return "not a PNG file (no PNG signature)"


def read_png(path) -> np.ndarray:
    """`np.asarray(Image.open(path))` of a PNG, with a channel axis kept."""
    return open_png(path).pixels


def open_png(path) -> Picture:
    """The `Picture` of a PNG file, in PIL's mode for its colour type and
    bit depth."""
    with open(path, "rb") as f:
        return png_picture(f.read(), path)


PIL_READ = 65536  # ImageFile.MAXBLOCK: the most image data each of PIL's reads hands its decoder
_CID = re.compile(rb"^[A-Za-z0-9_]{4}$")  # PngStream's is_cid: four word characters
_TEXT_CHUNK = 1024 * 1024  # PngImagePlugin.MAX_TEXT_CHUNK


class _PngStream:
    """What PIL's PngStream keeps of the chunks it has read: the header's
    mode, size and interlace flag, the palette (only a PLTE read while the
    mode is "P" and before the image data), the transparency, and the
    APNG counters its chunk checks use."""

    def __init__(self):
        self.mode, self.size, self.header, self.interlace = None, (0, 0), None, False
        self.palette, self.transparency = None, None
        self.seq, self.frames, self.bbox = None, None, False

    def fault(self, cid: bytes, s: bytes, before_data: bool):
        """Run PIL's handler of chunk `cid` on its body `s`: update the
        state and return None, or return what PIL raises."""
        if cid == b"IHDR":
            if len(s) < 13:
                return "Truncated IHDR chunk"
            self.size = struct.unpack(">II", s[:8])
            mode = PNG_MODES.get((s[8], s[9]))
            if mode is not None:
                self.mode, self.header = mode, struct.unpack(">IIBBBBB", s[:13])
            self.interlace |= s[12] != 0
            return "unknown filter category" if s[11] else None
        if cid == b"PLTE":
            if self.mode == "P" and before_data:  # a PLTE after the image data never reaches the image
                self.palette = s
        elif cid == b"tRNS":
            need = {"1": 2, "L": 2, "I;16": 2, "RGB": 6}.get(self.mode, 0)
            if len(s) < need:
                return f"a tRNS chunk of {len(s)} bytes for mode {self.mode} (struct.error)"
            if self.mode == "P":
                if _SIMPLE_PALETTE.match(s):
                    self.transparency = s.index(b"\x00")
                else:
                    self.transparency = s
            elif self.mode == "1":
                self.transparency = 255 if _u16(s, 0) else 0
            elif self.mode in ("L", "I;16"):
                self.transparency = _u16(s, 0)
            elif self.mode == "RGB":
                self.transparency = tuple(_u16(s, 2 * i) for i in range(3))
        elif cid == b"gAMA" and len(s) < 4 or cid == b"cHRM" and len(s) % 4:
            return f"a {cid.decode()} chunk of {len(s)} bytes (struct.error)"
        elif cid == b"sRGB" and not s or cid == b"pHYs" and len(s) < 9 or cid == b"acTL" and len(s) < 8:
            return f"a truncated {cid.decode()} chunk"
        elif cid == b"acTL":
            n = _u32(s, 0)
            if self.frames is not None:
                self.frames = None
            elif 0 < n <= 0x80000000:
                self.frames = n
        elif cid == b"fcTL":
            if len(s) < 26:
                return "APNG contains truncated fcTL chunk"
            seq = _u32(s, 0)
            if seq != (0 if self.seq is None else self.seq + 1):
                return "APNG contains frame sequence errors"
            self.seq = seq
            x, y = _u32(s, 12), _u32(s, 16)
            if x + _u32(s, 4) > self.size[0] or y + _u32(s, 8) > self.size[1]:
                return "APNG contains invalid frames"
            self.bbox = True
        elif cid == b"iCCP":
            at = s.find(b"\x00") + 1
            if at >= len(s):
                return "an iCCP chunk cut short (IndexError)"
            if s[at]:
                return f"Unknown compression method {s[at]} in iCCP chunk"
            return _inflate_text(s[at + 1:])
        elif cid in (b"zTXt", b"iTXt"):
            return self._text(cid, s)
        return None

    @staticmethod
    def _text(cid: bytes, s: bytes):
        """What PIL's text handlers raise on: a zTXt of another compression
        method, and compressed text past PIL's limit."""
        _, _, value = s.partition(b"\x00")
        if cid == b"zTXt":
            if value and value[0]:
                return f"Unknown compression method {value[0]} in zTXt chunk"
            return _inflate_text(value[1:])
        if cid == b"iTXt" and len(value) >= 2 and value[0] and not value[1] and value[2:].count(b"\x00") >= 2:
            return _inflate_text(value[2:].split(b"\x00", 2)[2])
        return None


def _inflate_text(data: bytes):
    """PngImagePlugin._safe_zlib_decompress's raise: text that inflates
    past PIL's limit (zlib's own errors PIL passes over)."""
    d = zlib.decompressobj()
    try:
        d.decompress(data, _TEXT_CHUNK)
    except zlib.error:
        return None
    return "Decompressed data too large for PngImagePlugin.py" if d.unconsumed_tail else None


def _u32(data: bytes, at: int) -> int:
    return int.from_bytes(data[at:at + 4], "big")


def _chunk_head(data: bytes, pos: int):
    """PngStream.read at `pos`: (chunk type, length), or None where PIL's
    read raises (struct.error: fewer than 4 bytes; SyntaxError: a type
    that is not four word characters)."""
    head = data[pos:pos + 8]
    if len(head) < 4 or not _CID.match(head[4:]):
        return None
    return head[4:], _u32(head, 0)


def png_picture(data: bytes, path) -> Picture:
    """The `Picture` of PNG bytes (`open_png`), read as PIL 12.1.0 reads
    them. The chunks before the image data are PIL's `_open`: each one's
    CRC is checked and any fault refuses the file. The image data is the
    run of IDAT chunks that starts there, with no CRC check, inflated as
    PIL's decoder reads it (PIL_READ bytes at a time, done as soon as the
    last row is whole). The chunks after it are PIL's `load_end`: no CRC
    check, reading stops at IEND, at a chunk header PIL cannot read or at
    an APNG frame; a tRNS there sets the transparency, a PLTE there does
    nothing (a palette image with no PLTE before its data reads every
    index as black), and a chunk that PIL's handler raises on, or whose
    body runs past the end, refuses the file. `path` names the bytes in a
    refusal."""
    if not data.startswith(PNG_SIGNATURE):
        _refuse(path, _sniff(data[:8]))
    png, pos = _PngStream(), len(PNG_SIGNATURE)
    while True:
        head = _chunk_head(data, pos)
        if head is None:
            raise ValueError(f"{path}: a broken PNG chunk header at byte {pos}")
        kind, n = head
        if kind in (b"IDAT", b"IEND", b"fdAT"):
            break
        body = data[pos + 8:pos + 8 + n]
        if len(body) < n:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        fault = png.fault(kind, body, before_data=True)
        if fault:
            raise ValueError(f"{path}: PNG chunk {kind!r}: {fault}")
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(crc) < 4 or zlib.crc32(kind + body) != _u32(crc, 0):
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        pos += 12 + n
    if kind == b"fdAT":
        raise ValueError(f"{path}: an APNG frame chunk (fdAT) before any IDAT; the port reads a PNG's IDAT image")
    if kind != b"IDAT" or png.header is None:
        raise ValueError(f"{path}: PNG without IDAT, or without an IHDR of a colour type and bit depth PNG has")
    (width, height), (_, _, depth, color, *_), mode = png.size, png.header, png.mode  # load_end cannot change them
    if width == 0 or height == 0:
        raise ValueError(f"{path}: a PNG header of {width}x{height} pixels")
    spp = _SAMPLES[color]
    passes = _passes(width, height, png.interlace)
    need = sum(ph * (-(-(pw * spp * depth) // 8) + 1) for *_, pw, ph in passes)
    raw, pos = _image_data(data, pos, n, need, path)
    animated = png.frames is not None and png.frames + (not png.bbox) > 1
    while True:  # load_end: from the CRC of the chunk where the decoder finished
        head = _chunk_head(data, pos + 4)
        if head is None or head[0] == b"IEND" or head[0] == b"fcTL" and animated:
            break
        kind, n = head
        pos += 12
        body = data[pos:pos + n]
        if len(body) < n:
            raise ValueError(f"{path}: PNG chunk {kind!r} runs past the end of the file (PIL: Truncated File Read)")
        if kind == b"fdAT":
            fault = "APNG contains truncated fDAT chunk" if n < 4 else (
                None if png.seq is not None and _u32(body, 0) == png.seq + 1 else "APNG contains frame sequence errors")
            png.seq = _u32(body, 0) if fault is None else png.seq
        else:
            fault = None if kind == b"IDAT" else png.fault(kind, body, before_data=False)
        if fault:
            raise ValueError(f"{path}: PNG chunk {kind!r} after the image data: {fault}")
        pos += n
    samples = _decode_samples(path, raw, width, height, depth, spp, passes)
    return _to_mode(samples, depth, color, mode, png.palette, png.transparency)


def _passes(width, height, interlace):
    """(first column, first row, column step, row step, width, height) of
    each non-empty pass: the whole image, or Adam7's seven."""
    out = []
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw > 0 and ph > 0:
            out.append((x0, y0, dx, dy, pw, ph))
    return out


def _image_data(data: bytes, pos: int, n: int, need: int, path):
    """The `need` inflated bytes of the run of IDAT chunks whose first
    header is at `pos` (body length `n`), fed to zlib as PIL's load_read
    hands them to its decoder, and the offset of the end of the chunk in
    which the last byte came: PIL's reads stop there."""
    inflate, out, got = zlib.decompressobj(), [], 0
    while True:
        start = pos + 8
        for at in range(start, start + n, PIL_READ):
            piece = data[at:min(at + PIL_READ, start + n)]
            if not piece:
                raise ValueError(f"{path}: PNG image data cut short (PIL: image file is truncated)")
            try:
                more = inflate.decompress(piece, need - got)
            except zlib.error as err:
                raise ValueError(f"{path}: broken PNG image data ({err}; PIL: broken data stream)") from None
            out.append(more)
            got += len(more)
            if got == need:
                return b"".join(out), start + n
        pos = start + n + 4
        head = _chunk_head(data, pos)
        if head is None or head[0] not in (b"IDAT", b"DDAT"):
            what = "an APNG frame chunk (fdAT) inside the image data" if head and head[0] == b"fdAT" else \
                "PNG image data cut short (PIL: image file is truncated)"
            raise ValueError(f"{path}: {what}")
        n = head[1]


def _decode_samples(path, raw, width, height, depth, spp, passes) -> np.ndarray:
    """(H, W, spp) integer samples of a PNG's inflated image data: each
    pass (`_passes`) unfiltered on its own and its samples unpacked (bit
    depths below 8 packed most significant first, 16 bits big-endian)."""
    out = np.zeros((height, width, spp), np.uint16 if depth == 16 else np.uint8)
    bpp = max(1, spp * depth // 8)  # the filters' byte distance to the pixel on the left
    pos = 0
    for x0, y0, dx, dy, pw, ph in passes:
        stride = -(-(pw * spp * depth) // 8)
        size = ph * (stride + 1)
        rows = np.frombuffer(raw, np.uint8, size, pos).reshape(ph, stride + 1)
        pos += size
        filters = rows[:, 0]
        if int(filters.max(initial=0)) > 4:
            raise ValueError(f"{path}: unknown PNG row filter {int(filters.max())}")
        body = _unfilter(rows[:, 1:].reshape(ph, stride // bpp, bpp), filters).reshape(ph, stride)
        if depth == 16:
            values = (body[:, 0::2].astype(np.uint16) << 8) | body[:, 1::2]
        elif depth == 8:
            values = body
        else:
            shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
            values = ((body[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(ph, -1)
        out[y0::dy, x0::dx] = values[:, :pw * spp].reshape(ph, pw, spp)
    return out


def _to_mode(samples, depth, color, mode, plte, transparency) -> Picture:
    """A PNG's samples in PIL's mode, as its unpacker gives them, with the
    palette PIL took (`plte`: a PLTE read before the image data, or None)
    and PIL's `info["transparency"]`."""
    palette = None
    if mode == "1":
        pixels = samples != 0
    elif mode == "L":
        pixels = samples * (255 // ((1 << depth) - 1))  # L;2 and L;4 scale to 0..255
    elif mode in ("I;16", "P"):
        pixels = samples
        if mode == "P":  # no PLTE: PIL's core palette, every entry black
            plte = plte or b""
            palette = np.frombuffer(plte[:len(plte) // 3 * 3], np.uint8).reshape(-1, 3)
    else:
        pixels = (samples >> 8).astype(np.uint8) if depth == 16 else samples
        if color == 4 and depth == 16:  # LA;16B: PIL reads it as RGBA
            pixels = np.concatenate([pixels[..., :1].repeat(3, axis=2), pixels[..., 1:]], axis=2)
    return Picture(pixels, mode, palette, transparency)


def _u16(data: bytes, at: int) -> int:
    return int.from_bytes(data[at:at + 2].ljust(2, b"\x00"), "big")


def to_rgba(picture: Picture) -> np.ndarray:
    """PIL's `convert("RGBA")` of a `Picture`: (H, W, 4) uint8. Grey
    ("1" as 0 / 255, "L", "I;16" and "I;16B" clipped at 255) and RGB take
    alpha 0 where the colour equals the transparency's low byte(s), 255
    elsewhere; a palette image takes its entries' colours (black past the
    palette) and the tRNS alphas (255 past them); "LA" spreads its grey;
    "PA" takes its palette's colours and its own alpha;
    "CMYK" is PIL's cmyk2rgb, each colour (255 - k) - c (255 - k) / 255
    in PIL's rounded division; an "L" GIF that keeps its global palette
    takes the palette's colours (with a transparency index PIL raises, and
    so does this); a grey TGA with a colour map ("L" or "LA") takes the
    map's colours, "LA" its own alpha; "I" is clipped to 0..255; "F" is
    0 at or below 0 (and NaN), 255 at or above 255, else truncated, as
    PIL's float-to-byte conversion; "LAB" is LittleCMS's Lab (D50) to sRGB
    transform as PIL runs it (`utils/lab.py`), its alpha 255 or the
    transparency's; "YCbCr" is PIL's fixed-point YCbCr -> RGB
    (`utils/ycbcr.py`), alpha 255; "I;16L" is clipped as "I;16". Any other
    mode raises, naming it."""
    px, mode, t = picture.pixels, picture.mode, picture.transparency
    if mode == "RGBA":
        return px.copy()
    if mode == "PA" or (mode == "LA" and picture.palette is not None):  # "PA": the palette's colours, the alpha
        return np.concatenate([_palette_table(picture.palette)[px[..., 0], :3], px[..., 1:]], axis=2)
    if mode == "LA":
        return np.concatenate([px[..., :1].repeat(3, axis=2), px[..., 1:]], axis=2)
    if mode == "LAB":  # LittleCMS's Lab -> sRGB transform, as PIL runs it
        rgba = lab.lab_to_rgba(px)
        if t is not None:  # the fourth byte PIL's core holds, which the transform copies to alpha
            rgba[..., 3] = t
        return rgba
    if mode == "CMYK":
        nk = 255 - px[..., 3:].astype(np.int64)
        rgb = nk - _muldiv255(px[..., :3], nk)
        return np.concatenate([rgb, np.full_like(nk, 255)], axis=2).astype(np.uint8)
    if mode == "L" and picture.palette is not None:
        if t is not None:  # PIL's core holds the image as "P", which convert_transparent refuses
            raise ValueError("to_rgba: conversion from P to RGBA not supported in convert_transparent (an L "
                             "GIF with a global palette and a transparency index)")
        mode = "P"
    if mode == "P":
        table = _palette_table(picture.palette)
        if isinstance(t, int):
            table[t, 3] = 0
        elif t is not None:
            table[:len(t), 3] = np.frombuffer(t[:256], np.uint8)
        return table[px[..., 0]]
    if mode == "YCbCr":  # PIL's ConvertYCbCr.c
        return np.concatenate([ycbcr.ycbcr_to_rgb(px), np.full(px.shape[:2] + (1,), 255, np.uint8)], axis=2)
    if mode == "RGB" and isinstance(t, bytes):  # an XPM colour of None read as "RGB": PIL's convert fails on its key
        raise ValueError("to_rgba: an RGB image whose transparency is a pixel key (PIL: TypeError, 'bytes' "
                         "object cannot be interpreted as an integer)")
    if mode == "RGB":
        t = (t, t, t) if isinstance(t, int) else t  # a grey tRNS read after the image data: every channel's key
        rgb, key = px, None if t is None else np.array([v & 0xFF for v in t], np.uint8)
    elif mode in ("1", "L", "I;16", "I;16L", "I;16B", "I", "F"):
        if mode == "1":
            grey = np.where(px, 255, 0).astype(np.uint8)
        elif mode.startswith("I"):
            grey = np.clip(px, 0, 255).astype(np.uint8)
        elif mode == "F":  # comparisons with NaN fail: 0
            grey = np.where(px >= 255, 255, np.where(px > 0, px, 0)).astype(np.uint8)
        else:
            grey = px
        rgb, key = grey.repeat(3, axis=2), None if t is None else np.full(3, t & 0xFF, np.uint8)
    else:
        raise ValueError(f"to_rgba: no conversion of mode {mode!r} to RGBA")
    alpha = np.full(rgb.shape[:2] + (1,), 255, np.uint8)
    if key is not None:
        alpha[(rgb == key).all(axis=2)] = 0
    return np.concatenate([rgb, alpha], axis=2)


def _palette_table(palette: np.ndarray) -> np.ndarray:
    """(256, 4) RGBA of a palette's entries: black past its end, alpha 255
    where the palette has none."""
    table = np.zeros((256, 4), np.uint8)
    table[:, 3] = 255
    table[:len(palette), :palette.shape[1]] = palette
    return table


def _unfilter(raw: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Undo PNG's row filters: raw (H, W, C) uint8 filtered samples, one
    filter type (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) per row."""
    if bool(np.isin(filters, (3, 4)).any()):
        return _unfilter_wavefront(raw, filters)
    # None, Sub and Up only: Sub is a running sum along the row, and each
    # run of Up rows a running sum down the columns from the row above it
    # (uint8 sums wrap mod 256, as PNG's do).
    rows = raw.copy()
    sub = filters == 1
    rows[sub] = np.cumsum(rows[sub], axis=1, dtype=np.uint8)
    up = filters == 2
    if up.any():
        total = np.cumsum(rows, axis=0, dtype=np.uint8)
        # the last row that is not Up at or above each row (-1: none)
        anchor = np.maximum.accumulate(np.where(up, -1, np.arange(len(filters))))
        before = total[np.maximum(anchor - 1, 0)]
        before[anchor <= 0] = 0
        rows = total - before
    return rows


def _unfilter_wavefront(raw: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Every filter, Average and Paeth included. A sample depends on its
    left, upper and upper-left neighbours, so the samples on one
    anti-diagonal (x + y = d) depend only on the two before it: the image
    is decoded in W + H - 1 vectorised steps. In the skewed layout
    s[d, 1 + y] = out[y, d - y] each diagonal is one row of `s`, its left
    neighbours s[d - 1, 1 + y], its upper ones s[d - 1, y] and its upper
    left ones s[d - 2, y]; row 0 of the second axis and every cell outside
    the image stay 0, the value PNG gives to samples off the image."""
    H, W, C = raw.shape
    D = W + H - 1
    ys = np.arange(H)
    d_of = ys[:, None] + np.arange(W)[None, :]  # (H, W) diagonal of each sample
    skew_raw = np.zeros((D, H, C), np.int16)
    skew_raw[d_of, ys[:, None]] = raw
    s = np.zeros((D + 1, H + 1, C), np.int16)  # s[d + 1] holds diagonal d
    f = filters.astype(np.int64)
    for d in range(D):
        y0, y1 = max(0, d - W + 1), min(H, d + 1)
        a = s[d, 1 + y0:1 + y1]  # left
        b = s[d, y0:y1]  # up
        c = s[d - 1, y0:y1] if d > 0 else np.zeros_like(a)  # upper left
        fy = f[y0:y1, None]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([fy == 1, fy == 2, fy == 3, fy == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        s[d + 1, 1 + y0:1 + y1] = (skew_raw[d, y0:y1] + pred) & 255
    return s[1:][d_of, 1 + ys[:, None]].astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path, array: np.ndarray):
    """Write (H, W) or (H, W, C) uint8 pixels, C = 1, 2, 3 or 4, as an
    8-bit PNG whose rows all take the Sub filter, deflated at zlib's level
    1: several times faster than PIL's 6, for a file about a tenth larger."""
    a = np.asarray(array)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, not {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"write_png takes (H, W) or (H, W, 1..4) pixels, not {a.shape}")
    H, W, C = a.shape
    rows = np.empty((H, 1 + W * C), np.uint8)
    rows[:, 0] = 1  # Sub: each sample less the one of the pixel to its left
    body = rows[:, 1:].reshape(H, W, C)
    body[:, 0] = a[:, 0]
    np.subtract(a[:, 1:], a[:, :-1], out=body[:, 1:])  # uint8 arithmetic wraps mod 256
    header = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[C], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))


# ---- PIL.Image.resize(size) at its default: BICUBIC ----

PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8-bit images (Resample.c)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coefficients(in_size: int, out_size: int):
    """PIL's precompute_coeffs + normalize_coeffs_8bpc for the box
    (0, in_size): per output sample its first input sample and ksize
    fixed-point weights (zero past the samples it uses)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale  # bicubic's support, widened when downscaling
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)  # C's truncating casts
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    k = np.arange(ksize)
    used = k[None, :] < xmax[:, None]
    ss = 1.0 / filterscale
    w = np.where(used, _bicubic((k[None, :] + xmin[:, None] - center[:, None] + 0.5) * ss), 0.0)
    total = np.zeros(out_size)
    for j in range(ksize):  # C's left-to-right sum
        total += w[:, j]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * (1 << PRECISION_BITS)),
                     np.trunc(0.5 + w * (1 << PRECISION_BITS))).astype(np.int32)
    index = np.minimum(xmin[:, None] + k[None, :], in_size - 1)
    return index, fixed


def _pass(x: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One resampling pass along `axis` of uint8 x, rounded and clipped."""
    index, fixed = _coefficients(x.shape[axis], out_size)
    # int32, as PIL's sums: 255 times the positive weights stays below 2^31
    acc = np.full(x.shape[:axis] + (out_size,) + x.shape[axis + 1:], 1 << (PRECISION_BITS - 1),
                  np.int32)
    shape = [1] * x.ndim
    shape[axis] = out_size
    for j in range(index.shape[1]):
        acc += np.take(x, index[:, j], axis=axis) * fixed[:, j].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a.astype(np.int64) * b + 128
    return ((t >> 8) + t) >> 8


def resize(array: np.ndarray, size) -> np.ndarray:
    """`PIL.Image.resize(size)` of (H, W) or (H, W, C) uint8 pixels, C = 1
    to 4 (L, LA, RGB, RGBA), `size` = (width, height)."""
    a = np.asarray(array)
    if a.dtype != np.uint8:
        raise ValueError(f"resize takes uint8 pixels, not {a.dtype}")
    out_w, out_h = int(size[0]), int(size[1])
    if (out_w, out_h) == (a.shape[1], a.shape[0]):
        return a.copy()  # PIL copies an image whose size does not change
    squeeze = a.ndim == 2
    x = a[..., None] if squeeze else a
    C = x.shape[2]
    alpha = None
    if C in (2, 4):  # PIL resizes LA and RGBA premultiplied (La, RGBa)
        alpha = x[..., -1:].astype(np.int64)
        x = np.concatenate([_muldiv255(x[..., :-1], alpha), alpha], axis=-1).astype(np.uint8)
    if out_w != x.shape[1]:
        x = _pass(x, 1, out_w)
    if out_h != x.shape[0]:
        x = _pass(x, 0, out_h)
    if alpha is not None:
        alpha = x[..., -1:].astype(np.int64)
        color = x[..., :-1].astype(np.int64)
        keep = (alpha == 0) | (alpha == 255)
        divided = np.minimum(255 * color // np.maximum(alpha, 1), 255)
        x = np.concatenate([np.where(keep, color, divided), alpha], axis=-1).astype(np.uint8)
    return x[..., 0] if squeeze else x
