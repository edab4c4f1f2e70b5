"""Old-style JPEG-in-TIFF (compression 6), as libtiff's tif_ojpeg.c hands
it to its RGBA reader for PIL.

PIL reads every old-style JPEG TIFF as YCbCr (it forces photometric 6) and
libtiff decodes it through its RGBA reader (`utils/tiff_ycbcr.py`): its
OJPEG codec builds one JPEG stream and gives the reader libjpeg's raw data
(each component at its own sampling, no upsampling, no libjpeg colour
conversion) packed into TIFF's YCbCr data units; the reader converts them
with TIFF's tables. The stream is built as libtiff builds it:

- the tables: from the JPEGInterchangeFormat stream where the tag is set
  (its markers up to and including the SOS, as libtiff reads them), else
  from the JPEGQTables, JPEGDCTables and JPEGACTables tags (one table of
  each a component, 64 quantisation bytes; 16 counts and the values) with
  JPEGProc 1 (baseline) and JPEGRestartInterval;
- the frame: the image's width and height (strips: one stream for the
  whole image) or the tile's; component 0 sampled as the JPEGInterchange
  stream's frame says, else as YCbCrSubsampling (default 2x2), the others
  1x1;
- the data: each strip's or tile's bytes, with an RST marker (RST0, RST1,
  ... modulo 8) between strips, as libtiff inserts it, then EOI.

The stream is decoded once by the compiled JPEG decoder's raw output
(`jpeg.decode_raw`: the same Huffman, IDCT and damage rules as every JPEG
the port reads) and each strip's or tile's data units cut from it. Where a
restart marker is not the one expected, libtiff's resync_to_restart fails
the codec for the rest of the image: from that MCU row on the reader gets
no data and its zeroed buffer gives the units.
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatting_torch.utils import jpeg

JPEG_PROC, JIF, JIF_LENGTH, RESTART_INTERVAL, Q_TABLES, DC_TABLES, AC_TABLES = 512, 513, 514, 515, 519, 520, 521
YCBCR_SUBSAMPLING = 530


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _header_from_tags(data: bytes, tags: dict, spp: int, name: str) -> bytes:
    """DQT, DHT and DRI segments from the JPEG table tags, and the frame's
    and scan's component layout (table i for component i)."""
    if tags.get(JPEG_PROC, (1,))[0] != 1:
        raise ValueError(f"{name}: old-style JPEG with JPEGProc {tags[JPEG_PROC][0]} (libtiff reads baseline only)")
    out = b""
    for tag, kind in ((Q_TABLES, "quantisation"), (DC_TABLES, "DC"), (AC_TABLES, "AC")):
        offsets = tags.get(tag, ())
        if len(offsets) < spp:
            raise ValueError(f"{name}: old-style JPEG without its {kind} table for each of {spp} components")
        for i, off in enumerate(offsets[:spp]):
            if tag == Q_TABLES:
                table = data[off:off + 64]
                if len(table) < 64:
                    raise ValueError(f"{name}: old-style JPEG quantisation table {i} past the end of the file")
                out += _segment(0xDB, bytes([i]) + table)
            else:
                counts = data[off:off + 16]
                table = data[off:off + 16 + sum(counts)]
                if len(counts) < 16 or len(table) < 16 + sum(counts):
                    raise ValueError(f"{name}: old-style JPEG {kind} table {i} past the end of the file")
                out += _segment(0xC4, bytes([(16 if tag == AC_TABLES else 0) | i]) + table)
    interval = tags.get(RESTART_INTERVAL, (0,))[0]
    if interval:
        out += _segment(0xDD, struct.pack(">H", interval))
    return out


def _jif_header(data: bytes, tags: dict, name: str):
    """(the JPEGInterchangeFormat stream's markers before its frame, its
    frame's body, its scan's body)."""
    at, end = tags[JIF][0], tags[JIF][0] + tags.get(JIF_LENGTH, (len(data),))[0]
    stream = data[at:min(end, len(data))]
    if stream[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: old-style JPEG whose JPEGInterchangeFormat stream has no SOI")
    pos, tables, sof, sos = 2, b"", None, None
    while pos + 4 <= len(stream) and sos is None:
        if stream[pos] != 0xFF:
            raise ValueError(f"{name}: old-style JPEG whose JPEGInterchangeFormat stream is corrupt")
        marker = stream[pos + 1]
        n = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        body = stream[pos + 4:pos + 2 + n]
        if marker in (0xC0, 0xC1):
            sof = body
        elif marker == 0xDA:
            sos = body
        elif marker in (0xDB, 0xC4, 0xDD):
            tables += _segment(marker, body)
        elif marker in (0xC2, 0xC3) or 0xC5 <= marker <= 0xCF and marker not in (0xC8, 0xCC):
            raise ValueError(f"{name}: old-style JPEG with frame type 0x{marker:02X} (libtiff reads baseline only)")
        pos += 2 + n
    if sof is None or sos is None:
        raise ValueError(f"{name}: old-style JPEG whose JPEGInterchangeFormat stream has no frame or scan header")
    return tables, sof, sos


def _restart_interval(segments: bytes) -> int:
    """The DRI's interval among marker segments (0 without one)."""
    at = 0
    while at + 4 <= len(segments):
        n = struct.unpack(">H", segments[at + 2:at + 4])[0]
        if segments[at + 1] == 0xDD:
            return struct.unpack(">H", segments[at + 4:at + 6])[0]
        at += 2 + n
    return 0


class Image:
    """The data units of an old-style JPEG image, decoded once: libtiff
    feeds every strip (or tile) of the image into one stream, a strip a
    restart interval."""

    def __init__(self, data: bytes, tags: dict, chunks, name: str):
        self.data, self.chunks, self.name = data, chunks, name
        c, spp = chunks, 3
        if c.tiled and c.across > 1:
            raise ValueError(f"{name}: old-style JPEG in tiles more than one across (libtiff feeds every tile into "
                             f"one stream a tile wide and fails the reads past its end: PIL's pixels are not the "
                             f"picture)")
        # libtiff's strile size: strips the image's width by its length,
        # tiles the tile's width by the tiles' length in all
        self.sof_x, self.sof_y = c.cw, (c.down * c.ch if c.tiled else c.height)
        if JIF in tags:
            self.tables, sof, self.sos = _jif_header(data, tags, name)
            comps = [sof[6 + 3 * i:9 + 3 * i] for i in range(sof[5])]
            self.subsampling = (comps[0][1] >> 4, comps[0][1] & 15)
            y, x = struct.unpack(">HH", sof[1:5])
            if (y < c.height and y < self.sof_y) or (x < c.width and x < c.cw) or x > c.cw:
                raise ValueError(f"{name}: old-style JPEG whose frame is {x}x{y} for strips or tiles {c.cw} wide "
                                 f"in an image of {c.width}x{c.height} (libtiff: unexpected JPEG frame size)")
            self.sof_y = y
        else:
            self.tables = _header_from_tags(data, tags, spp, name)
            sub = tags.get(YCBCR_SUBSAMPLING, (2, 2))
            self.subsampling = tuple(sub[:2]) if len(sub) >= 2 else (2, 2)
            comps = [bytes([1, (self.subsampling[0] << 4) | self.subsampling[1], 0])] + \
                [bytes([i + 1, 0x11, i]) for i in range(1, spp)]
            self.sos = bytes([spp]) + b"".join(bytes([i + 1, (i << 4) | i]) for i in range(spp)) + b"\x00\x3f\x00"
        if len(comps) != spp or any(comp[1] != 0x11 for comp in comps[1:]):
            raise ValueError(f"{name}: old-style JPEG whose frame is not one subsampled luma and two 1x1 chroma "
                             f"components (libtiff decompresses it otherwise)")
        h, v = self.subsampling
        if c.down > 1 and c.ch % (8 * v):
            raise ValueError(f"{name}: old-style JPEG strips or tiles of {c.ch} rows, not whole MCU rows at "
                             f"vertical subsampling {v}")
        interval = _restart_interval(self.tables)
        per_strile = -(-c.cw // (8 * h)) * (c.ch // (8 * v))
        if c.down > 1 and interval != per_strile:
            raise ValueError(f"{name}: old-style JPEG whose restart interval ({interval} MCUs) is not its strips' "
                             f"or tiles' {per_strile} MCUs at {h}x{v} (the data are sampled otherwise than the "
                             f"frame says; the port does not follow libjpeg's resync on them)")
        self.comps = b"".join(comps)
        self.units = None

    def _stream(self) -> bytes:
        """The JPEG stream libtiff builds: header, each strip's or tile's
        data with RST markers between them, EOI."""
        c = self.chunks
        sof = struct.pack(">BHHB", 8, self.sof_y, self.sof_x, 3) + self.comps
        parts = [b"\xff\xd8", self.tables, _segment(0xC0, sof), _segment(0xDA, self.sos)]
        n = c.across * c.down
        for k in range(n):
            off, count = c.offsets[k], c.counts[k]
            parts.append(self.data[off:off + count])
            if k < n - 1:
                parts.append(bytes([0xFF, 0xD0 + k % 8]))
        return b"".join(parts) + b"\xff\xd9"

    def units_of(self, i: int, size: int) -> np.ndarray:
        """`size` bytes of data units of strip or tile `i`: the unit rows of
        its band of the stream, zero past them."""
        h, v = self.subsampling
        c = self.chunks
        if self.units is None:
            ((_, y), (_, cb), (_, cr)), good = jpeg.decode_raw(self._stream(), self.name)
            uw, uh = -(-self.sof_x // h), -(-self.sof_y // v)
            luma = y[:uh * v, :uw * h].reshape(uh, v, uw, h).transpose(0, 2, 1, 3).reshape(uh, uw, h * v)
            self.units = np.concatenate([luma, cb[:uh, :uw, None], cr[:uh, :uw, None]], -1).reshape(uh, -1)
            self.units[8 * good:] = 0  # an MCU row (8 unit rows) libtiff's codec failed: the reader's zeros
        band = -(-c.ch // v)
        units = self.units[i * band:(i + 1) * band].reshape(-1)
        out = np.zeros(size, np.uint8)
        out[:min(size, len(units))] = units[:size]
        return out
