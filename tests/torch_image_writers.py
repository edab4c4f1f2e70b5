"""Writers of the BMP, TIFF, GIF, WebP, PPM, TGA, DIB, QOI, PCX / DCX, SGI,
ICO / CUR, PSD, DDS, BLP, FTEX, GBR, FITS, FLI / FLC, ICNS and EPS forms
PIL reads but does not write (or writes only some of), for the tests of
`utils/bmp.py`, `utils/tiff.py`, `utils/gif.py`, `utils/webp.py`,
`utils/ppm.py`, `utils/tga.py`, `utils/qoi.py`, `utils/pcx.py`,
`utils/sgi.py`, `utils/ico.py`, `utils/psd.py`, `utils/dds.py` and the
readers of the forms after them, for the fixtures' `make_fixtures.py`
scripts and for chip_smoke.py's phases 5h, 5i, 5n and 5o, which run where
there is no PIL.
Imports neither JAX nor the port: each file is built from the formats'
specifications, and PIL's read of it is the rule the port is held to.

- `tiff_bytes`: classic TIFF or BigTIFF in either byte order, strips or
  tiles, PlanarConfiguration 1 or 2, compression none / PackBits / LZW
  (libtiff's new style, its encoder's code-width and table-full rules) /
  deflate / LZMA (an .xz stream, as libtiff's LZMA codec writes), or each
  strip or tile from a coder the caller gives (JPEG, ZSTD), Predictor 2
  and 3, any photometric, 1- to 32-bit, signed and float samples,
  FillOrder 2, YCbCr data units at any subsampling, ExtraSamples,
  ColorMap, Orientation and raw extra tags (RATIONAL ones too);
  `jpeg_tables_apart` splits a JPEG into the abbreviated stream and the
  JPEGTables libtiff writes; `ojpeg_tiff` builds an old-style JPEG TIFF
  from baseline streams' pieces (tables in tags or a JPEGInterchangeFormat
  stream); `thunderscan_encode` and `lzw_compat_encode` (old-style LZW,
  codes least significant bit first) code strips libtiff reads.
- `bmp_bytes`: every header size, bit count and row order, palettes of
  any length, BI_BITFIELDS masks in or after the header, and RLE8 / RLE4
  bitmaps from `rle_encode`, which uses every escape.
- `gif_bytes`: GIF87a / GIF89a, a global and / or local palette, a
  graphic-control extension with a transparency index, comment and
  application extensions, interlaced rows, a frame at an offset on a
  screen of any size, any LZW minimum code size (`gif_lzw_encode`: codes
  least significant bit first, the width grown as the decoder grows it, a
  Clear when the table is full).
- `webp_vp8x`: an extended WebP (VP8X) around a bitstream PIL wrote, with
  an ALPH chunk of either compression and any filter (`alph_chunk`, its
  filters as libwebp's), and ICCP, EXIF, XMP or unknown chunks.
- `vp8_variant`: a PIL-made VP8 frame coded again with 2, 4 or 8 token
  partitions, another loop-filter sharpness, type or level, reference and
  mode filter deltas, or relative segment values (`bool_encode`: RFC
  6386's boolean encoder).
- `pnm_bytes`: PBM, PGM, PPM and grey PFM and PIL's extension magics,
  binary or plain (decimal samples, P1's digits packed or spaced), at any
  maxval, with comments in the header and the data and any line length.
- `tga_bytes` / `tga_rle`: TGA of every image type, depth and origin, an
  ID field, 16-, 24- and 32-bit colour maps from any first index, and RLE
  packets of any length (runs within a row, raw packets across rows).
- `jp2_bytes`: a JP2 (or JPX) file around a raw JPEG 2000 codestream PIL
  wrote, with any `ihdr`, `colr` (enumerated or an ICC profile), `pclr` +
  `cmap`, `cdef` and `res ` boxes and any brand; `j2k_markers` /
  `j2k_join` take a codestream apart into its marker segments and tile-part
  data and put it together again (tile-parts split, markers added or
  edited, lengths and Psot recomputed).
- `dib_bytes`: a BMP's DIB, no file header.
- `qoi_bytes` / `qoi_encode`: QOI with every op (RGB, RGBA, INDEX, DIFF,
  LUMA, RUN) as the reference encoder picks them, vectorised, or raw ops.
- `pcx_bytes` / `pcx_lines` / `pcx_rle` and `dcx_bytes`: PCX of any
  version, bit and plane count, stride and palette (16 entries in the
  header, 256 after the data), and DCX of PCX frames.
- `sgi_bytes` / `sgi_rle_rows`: SGI verbatim or RLE, 8 or 16 bits.
- `icon_bytes` / `icon_dib` / `png_bytes`: ICO and CUR of PNG and BMP
  entries, with AND masks.
- `psd_bytes` / `packbits_rows` / `psd_resource`: PSD's merged image, raw
  or PackBits, any colour mode, depth and channel count, colour mode data,
  resources and a layer section.
- `dds_bytes` / `dds_masked`: a DDS header of any size field, pixel
  format flags, FourCC, bit count, masks, mipmap count and DX10 header
  (DXGI format, array size) before any body; uncompressed pixels packed
  through any bit masks. `bc1_blocks`, `bc2_blocks`, `bc3_blocks`,
  `bc4_blocks` (signed too), `bc5_blocks`, `bc6h_blocks` (mode 11, UF16
  or SF16) and `bc7_blocks` (mode 6) encode 4x4 blocks, vectorised:
  endpoints from each block's extremes, each pixel the nearest index.
- `lossless_jpeg`: lossless JPEG (SOF3, T.81 Annex H) of any predictor
  1-7 and point transform, with any sampling factors (which libjpeg-turbo's
  encoder resets to 1x1), restart intervals of whole MCU rows, interleaved
  or one-component scans (a predictor each), under an Adobe, JFIF or no
  marker; each Huffman table optimal for its component's differences
  (libjpeg's jpeg_gen_optimal_table).
- `blp1_bytes` / `blp2_bytes`: BLP1 (a JPEG split into the shared header
  and mipmap 0, or a BGRA palette and indices) and BLP2 (palette or DXT
  blocks from `bc1_blocks` / `bc2_blocks` / `bc3_blocks`), any header
  field, offsets and lengths; `ftex_bytes`: FTEX of DXT1 or raw RGB;
  `gbr_bytes`: GIMP brushes v1 / v2; `fits_bytes` / `fits_gzip_bytes` /
  `fits_unit` / `fits_card`: FITS at each BITPIX, IMAGE extensions and
  GZIP_1 tile tables; `fli_bytes` / `fli_frame` / `fli_chunk` and the
  chunk writers `fli_palette`, `fli_brun`, `fli_lc`, `fli_ss2`; `icns_bytes`
  / `icns_rgb` / `icns_rle`: icns blocks, Apple's RLE bands; `eps_bytes`:
  EPS text or a DOS EPS binary header.
`rle_chunks` is the vectorised run finder the RLE writers share.
"""

import lzma
import os
import re
import struct
import zlib

import numpy as np


# ---- TIFF ----

def lzw_encode(data: bytes) -> bytes:
    """libtiff's LZWEncode: a Clear first, 9 to 12-bit codes most
    significant bit first, the width grown when the next entry would not
    fit, a Clear when the table reaches 4094 entries, EOI last."""
    codes, widths = [256], [9]
    nbits, free, table = 9, 258, {}

    def grow():
        nonlocal nbits, free, table
        free += 1
        if free == 4094:
            codes.append(256), widths.append(nbits)
            nbits, free, table = 9, 258, {}
        elif free > (1 << nbits) - 1:
            nbits += 1

    if data:
        w = data[0]
        for b in data[1:]:
            c = table.get((w << 8) | b)
            if c is not None:
                w = c
                continue
            codes.append(w), widths.append(nbits)
            table[(w << 8) | b] = free
            grow()
            w = b
        codes.append(w), widths.append(nbits)
        grow()  # LZWPostEncode counts an entry for the last code too
    codes.append(257), widths.append(nbits)
    c, wd = np.asarray(codes, np.int64), np.asarray(widths)
    bits = (c[:, None] >> (11 - np.arange(12))) & 1
    return np.packbits(bits[np.arange(12)[None, :] >= 12 - wd[:, None]].astype(np.uint8)).tobytes()


def lzw_compat_encode(data: bytes, table_limit: int = 4000) -> bytes:
    """Old-style LZW as libtiff's LZWDecodeCompat reads it: codes least
    significant bit first, a Clear first, the width grown one entry later
    than the new style (when the decoder's next entry passes 2^n - 1), a
    Clear when the table reaches `table_limit` entries, EOI last."""
    codes, table, free, w = [256], {}, 258, None
    for b in data:
        if w is None:
            w = b
            continue
        c = table.get((w << 8) | b)
        if c is not None:
            w = c
            continue
        codes.append(w)
        table[(w << 8) | b] = free
        free += 1
        if free == table_limit:
            codes.append(256)
            table, free = {}, 258
        w = b
    if w is not None:
        codes.append(w)
    return _pack_lsb(codes + [257])


def _pack_lsb(codes) -> bytes:
    """Codes least significant bit first at the widths LZWDecodeCompat
    reads them: 9 bits after a Clear, one more each time its next entry
    passes 2^n - 1."""
    acc, have, out = 0, 0, bytearray()
    nbits, free, first = 9, 258, True
    for code in codes:
        acc |= code << have
        have += nbits
        while have >= 8:
            out.append(acc & 255)
            acc >>= 8
            have -= 8
        if code == 256:
            nbits, free, first = 9, 258, True
        elif first:
            first = False
        else:
            free += 1
            if free > (1 << nbits) - 1:
                nbits = min(nbits + 1, 12)
    if have:
        out.append(acc & 255)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits with runs (2..128 equal bytes), literals (1..128 bytes) and
    a -128 no-op before each run."""
    a = np.frombuffer(data, np.uint8)
    out = bytearray()
    if not len(a):
        return bytes(out)
    starts = np.flatnonzero(np.concatenate([[True], a[1:] != a[:-1]]))
    ends = np.concatenate([starts[1:], [len(a)]])
    literal = bytearray()

    def flush():
        for i in range(0, len(literal), 128):
            part = literal[i:i + 128]
            out.extend(bytes([len(part) - 1]) + part)
        literal.clear()

    for s, e in zip(starts.tolist(), ends.tolist()):
        if e - s == 1:
            literal.append(int(a[s]))
            continue
        flush()
        for i in range(s, e, 128):
            n = min(128, e - i)
            if n == 1:
                out.extend(bytes([0, int(a[s])]))
            else:
                out.extend(bytes([0x80, 257 - n, int(a[s])]))
    flush()
    return bytes(out)


def difference(samples: np.ndarray) -> np.ndarray:
    """Predictor 2's encoding of (rows, width, spp) samples: each less the
    one of the pixel to its left, in their own unsigned type."""
    out = samples.copy()
    out[:, 1:] = samples[:, 1:] - samples[:, :-1]
    return out


def float_difference(row_bytes: np.ndarray, spp: int, bps: int) -> np.ndarray:
    """Predictor 3's encoding (libtiff's fpDiff) of (rows, row bytes) of
    samples in the host's (little-endian) order: each row's samples split
    into byte planes, most significant first, then each byte less the one
    `spp` bytes before it."""
    rows = len(row_bytes)
    planes = row_bytes.reshape(rows, -1, bps)[:, :, ::-1].transpose(0, 2, 1).reshape(rows, -1)
    out = planes.copy()
    out[:, spp:] = planes[:, spp:] - planes[:, :-spp]
    return out


def reverse_bits(data: bytes) -> bytes:
    """Each byte's bits in the other order (FillOrder 2)."""
    table = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
    return data.translate(table)


def sample_bytes(samples: np.ndarray, depth: int, order: str, sample_format: int = 1) -> np.ndarray:
    """(rows, row bytes) of (rows, width, spp) samples at `depth` bits:
    below 8 bits and at 12 packed most significant bit first, each row
    padded to a byte; 8, 16 and 32 bits in the byte order; `sample_format`
    2 signed, 3 IEEE floating point (32 bits)."""
    rows = len(samples)
    if depth % 8:
        bits = (samples.astype(np.int64).reshape(rows, -1)[..., None] >> np.arange(depth - 1, -1, -1)) & 1
        return np.packbits(bits.reshape(rows, -1).astype(np.uint8), axis=1)
    kind = {1: "u", 2: "i", 3: "f"}[sample_format]
    dt = order + kind + str(depth // 8)
    return np.ascontiguousarray(samples.astype(dt)).view(np.uint8).reshape(rows, -1)


def ycbcr_units(samples: np.ndarray, h: int, v: int) -> np.ndarray:
    """(unit rows, unit row bytes) of libtiff's YCbCr data units for (rows,
    width, 3) Y, Cb, Cr samples subsampled h x v: each unit its h * v luma
    samples row by row, then one Cb and one Cr (the unit's top-left
    chroma); a partial unit at the right or bottom edge repeats the last
    column or row."""
    rows, width = samples.shape[:2]
    uh, uw = -(-rows // v), -(-width // h)
    padded = np.pad(samples, ((0, uh * v - rows), (0, uw * h - width), (0, 0)), mode="edge")
    luma = padded[..., 0].reshape(uh, v, uw, h).transpose(0, 2, 1, 3).reshape(uh, uw, h * v)
    chroma = padded[::v, ::h, 1:]
    return np.concatenate([luma, chroma], -1).astype(np.uint8).reshape(uh, -1)


COMPRESS = {1: lambda b: b, 5: lzw_encode, 8: lambda b: zlib.compress(b, 6), 32946: lambda b: zlib.compress(b, 1),
            32773: packbits_encode, 34925: lambda b: lzma.compress(b, lzma.FORMAT_XZ, lzma.CHECK_NONE)}
TYPE_CODES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 6: "b", 7: "B", 8: "h", 9: "i", 10: "i", 11: "f", 12: "d", 16: "Q",
              17: "q", 18: "Q"}  # ..., LONG8, SLONG8, IFD8 (RATIONAL as num, den pairs)


def n_values(typ: int, vals) -> int:
    """A tag's count: RATIONAL and SRATIONAL values are given as pairs."""
    return len(vals) // 2 if typ in (5, 10) else len(vals)


def tiff_bytes(samples, depth, photometric, order="<", compression=1, predictor=None, rows_per_strip=None,
               tile=None, extra=None, colormap=None, orientation=None, tags=None, encode=None, planar=False,
               big=False, sample_format=None, fill_order=None, ycbcr=None) -> bytes:
    """A TIFF of (H, W, spp) integer `samples` at `depth` bits.
    `tile` = (width, height) writes tiles (zero-padded where they
    overhang), else strips of `rows_per_strip` rows; `planar` writes
    PlanarConfiguration 2 (each sample's strips or tiles in turn, each
    chunk one sample); `big` a BigTIFF (20-byte entries, LONG8 offsets);
    `tags` adds or replaces raw tags {tag: (type, values)} (1 BYTE, 3
    SHORT, 4 LONG, 5 RATIONAL as (num, den) pairs, 7 UNDEFINED, 16 LONG8, 17 SLONG8, 18 IFD8); `encode` (a strip's or tile's
    samples -> its bytes) replaces the compression's own coder, as JPEG
    (7) and ZSTD (50000) need. `depth` 1, 2, 4, 8, 12, 16 or 32;
    `sample_format` 2 (signed) or 3 (floats) writes SampleFormat;
    `predictor` 3 libtiff's floating-point differencing; `fill_order` 2
    writes FillOrder 2 and stores every strip's or tile's bytes (coded or
    not) bit-reversed; `ycbcr` = (h, v) stores (H, W, 3) Y, Cb, Cr samples
    in libtiff's data units (`ycbcr_units`) under YCbCrSubsampling (h, v)."""
    samples = np.asarray(samples)
    H, W, n = samples.shape
    planes = [samples[..., i:i + 1] for i in range(n)] if planar else [samples]
    if tile:
        tw, th = tile
        across, down = -(-W // tw), -(-H // th)
        chunks = []
        for plane in planes:
            padded = np.zeros((down * th, across * tw, plane.shape[2]), samples.dtype)
            padded[:H, :W] = plane
            chunks += [padded[r * th:(r + 1) * th, c * tw:(c + 1) * tw] for r in range(down) for c in range(across)]
    else:
        rps = rows_per_strip or H
        chunks = [plane[y:y + rps] for plane in planes for y in range(0, H, rps)]
    fmt = sample_format or 1
    if predictor == 2 and depth % 8 == 0:  # on the samples' bits, as unsigned integers
        kind = {1: "u", 2: "i", 3: "f"}[fmt]
        chunks = [difference(ch.astype(f"{kind}{depth // 8}").view(f"u{depth // 8}")) for ch in chunks]
        fmt = 1
    if encode is None:
        if ycbcr:
            raw = [ycbcr_units(ch, *ycbcr) for ch in chunks]
        elif predictor == 3 and depth % 8 == 0:
            raw = [float_difference(sample_bytes(ch, depth, "<", fmt), ch.shape[2], depth // 8) for ch in chunks]
        else:
            raw = [sample_bytes(ch, depth, order, fmt) for ch in chunks]
        bodies = [COMPRESS[compression](r.tobytes()) for r in raw]
    else:
        bodies = [encode(ch) for ch in chunks]
    if fill_order == 2:
        bodies = [reverse_bits(b) for b in bodies]
    offset_type = 16 if big else 4
    t = {256: (4, [W]), 257: (4, [H]), 258: (3, [depth] * n), 259: (3, [compression]), 262: (3, [photometric]),
         277: (3, [n])}
    if tile:
        t.update({322: (3, [tile[0]]), 323: (3, [tile[1]]), 324: (offset_type, [0] * len(bodies)),
                  325: (4, [len(b) for b in bodies])})
    else:
        t.update({273: (offset_type, [0] * len(bodies)), 278: (3, [rows_per_strip or H]),
                  279: (4, [len(b) for b in bodies])})
    if planar:
        t[284] = (3, [2])
    if predictor:
        t[317] = (3, [predictor])
    if extra is not None:
        t[338] = (3, list(extra))
    if colormap is not None:
        t[320] = (3, list(colormap))
    if orientation:
        t[274] = (3, [orientation])
    if sample_format:
        t[339] = (3, [sample_format] * n)
    if fill_order:
        t[266] = (3, [fill_order])
    if ycbcr:
        t[530] = (3, list(ycbcr))
    t.update(tags or {})
    offsets_tag = 324 if tile else 273
    # the header, the IFD, the tags' own data, then the strips or tiles
    entry, inline, count, word = (20, 8, "Q", "Q") if big else (12, 4, "I", "I")
    ifd_at, n_tags = (16 if big else 8), len(t)
    data_at = ifd_at + (8 if big else 2) + entry * n_tags + inline
    blobs, entries = b"", []
    packed = {}
    for tag in sorted(t):
        typ, vals = t[tag]
        packed[tag] = struct.pack(order + TYPE_CODES[typ] * len(vals), *vals)
    strips_at = data_at + sum(len(v) + len(v) % 2 for v in packed.values() if len(v) > inline)
    offsets, at = [], strips_at
    for b in bodies:
        offsets.append(at)
        at += len(b)
    packed[offsets_tag] = struct.pack(order + TYPE_CODES[t[offsets_tag][0]] * len(offsets), *offsets)
    for tag in sorted(t):
        typ, vals = t[tag]
        raw = packed[tag]
        if len(raw) <= inline:
            entries.append(struct.pack(order + "HH" + count, tag, typ, n_values(typ, vals)) + raw.ljust(inline, b"\0"))
        else:
            entries.append(struct.pack(order + "HH" + count + word, tag, typ, n_values(typ, vals),
                                       data_at + len(blobs)))
            blobs += raw + b"\0" * (len(raw) % 2)
    if big:
        head = (b"II+\0" if order == "<" else b"MM\0+") + struct.pack(order + "HHQ", 8, 0, ifd_at)
    else:
        head = (b"II*\0" if order == "<" else b"MM\0*") + struct.pack(order + "I", ifd_at)
    return (head + struct.pack(order + ("Q" if big else "H"), n_tags) + b"".join(entries)
            + struct.pack(order + word, 0) + blobs + b"".join(bodies))


def jpeg_tables_apart(stream: bytes):
    """(abbreviated stream, JPEGTables) of one JPEG: the stream without its
    DQT and DHT segments, and those segments between SOI and EOI, as
    libtiff writes a JPEG-in-TIFF's strips and tag."""
    pos, tables, rest = 2, [], []
    while stream[pos + 1] != 0xDA:
        n = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        (tables if stream[pos + 1] in (0xDB, 0xC4) else rest).append(stream[pos:pos + 2 + n])
        pos += 2 + n
    return b"\xff\xd8" + b"".join(rest) + stream[pos:], b"\xff\xd8" + b"".join(tables) + b"\xff\xd9"


def thunderscan_encode(rows: np.ndarray) -> bytes:
    """ThunderScan (compression 32809) of (rows, width) 4-bit samples, as
    libtiff's ThunderDecode reads it, each row on its own: a run of the
    last pixel (code 0, up to 63), three 2-bit or two 3-bit deltas from it
    where they fit, else a raw pixel."""
    two = {0: 0, 1: 1, -1: 3}
    three = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    out = bytearray()
    for row in np.asarray(rows, np.int64):
        w, x, last = len(row), 0, 0
        while x < w:
            run = 0
            while x + run < w and run < 63 and row[x + run] == last:
                run += 1
            if run >= 2:
                out.append(run)
                x += run
                continue
            d = [int(v) - int(p) for p, v in zip([last] + list(row[x:x + 2]), row[x:x + 3])]
            if x + 3 <= w and all(k in two for k in d):
                out.append(0x40 | two[d[0]] << 4 | two[d[1]] << 2 | two[d[2]])
                x, last = x + 3, int(row[x + 2])
            elif x + 2 <= w and all(k in three for k in d[:2]):
                out.append(0x80 | three[d[0]] << 3 | three[d[1]])
                x, last = x + 2, int(row[x + 1])
            else:
                out.append(0xC0 | int(row[x]))
                x, last = x + 1, int(row[x])
    return bytes(out)


def jpeg_segments(stream: bytes):
    """(header segments up to and including SOS as (marker, body) pairs,
    entropy-coded data split at its RST markers) of a baseline JPEG."""
    pos, segments = 2, []
    while True:
        marker = stream[pos + 1]
        n = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        segments.append((marker, stream[pos + 4:pos + 2 + n]))
        pos += 2 + n
        if marker == 0xDA:
            break
    end = stream.rindex(b"\xff\xd9")
    return segments, re.split(rb"\xff[\xd0-\xd7]", stream[pos:end])


def ojpeg_tiff(streams, width, height, spp=3, rows_per_strip=None, tile=None, jif=False, photometric=6,
               order="<", tags=None, subsampling_tag=True) -> bytes:
    """An old-style JPEG-in-TIFF (compression 6) from baseline JPEG streams
    (PIL's): one stream for the image whose restart intervals are the
    strips, each interval one strip's data (libtiff puts the RST markers
    back between strips), or one stream a tile. The tables go into
    JPEGQTables / JPEGDCTables / JPEGACTables (one each a component) with
    JPEGProc 1 and JPEGRestartInterval, or with `jif` into a
    JPEGInterchangeFormat stream that ends with the SOS (the first
    stream's header). YCbCrSubsampling is the frame's, unless
    `subsampling_tag` is False (no tag) or a pair to write."""
    segments, _ = jpeg_segments(streams[0])
    bodies = [body for s in streams for body in jpeg_segments(s)[1]]
    sof = [b for m, b in segments if m == 0xC0][0]
    comps = [(sof[6 + 3 * i], sof[7 + 3 * i], sof[8 + 3 * i]) for i in range(sof[5])]
    sos = [b for m, b in segments if m == 0xDA][0]
    scan = {sos[1 + 2 * i]: sos[2 + 2 * i] for i in range(sos[0])}
    qt, dc, ac, dri = {}, {}, {}, 0
    for m, b in segments:
        if m == 0xDB:
            at = 0
            while at < len(b):
                qt[b[at] & 15] = b[at + 1:at + 65]
                at += 65
        elif m == 0xC4:
            at = 0
            while at < len(b):
                n = sum(b[at + 1:at + 17])
                (ac if b[at] >> 4 else dc)[b[at] & 15] = b[at + 1:at + 17 + n]
                at += 17 + n
        elif m == 0xDD:
            dri = struct.unpack(">H", b)[0]
    blobs = {}
    t = {259: (3, [6]), 277: (3, [spp])}
    if jif:
        header = b"\xff\xd8" + b"".join(bytes([0xFF, m]) + struct.pack(">H", len(b) + 2) + b for m, b in segments)
        blobs[513] = [header]
        t[514] = (4, [len(header)])
    else:
        blobs[519] = [qt[c[2]] for c in comps]
        blobs[520] = [dc[scan[c[0]] >> 4] for c in comps]
        blobs[521] = [ac[scan[c[0]] & 15] for c in comps]
        t[512] = (3, [1])
        t[515] = (3, [dri])
    if subsampling_tag is True:
        t[530] = (3, [comps[0][1] >> 4, comps[0][1] & 15])
    elif subsampling_tag:
        t[530] = (3, list(subsampling_tag))
    t.update(tags or {})
    for tag, values in blobs.items():
        t[tag] = (4, [0] * len(values))
    it = iter(bodies)
    data = tiff_bytes(np.zeros((height, width, spp), np.int64), 8, photometric, order=order, compression=6,
                      rows_per_strip=rows_per_strip, tile=tile, tags=t, encode=lambda chunk: next(it))
    return _append_tag_blobs(data, order, blobs)


def _append_tag_blobs(data: bytes, order: str, blobs) -> bytes:
    """`data` (a classic TIFF) with each tag of `blobs` ({tag: [bytes, ...]})
    pointing at its blobs, appended at the end of the file."""
    out = bytearray(data)
    ifd = struct.unpack(order + "I", data[4:8])[0]
    n = struct.unpack(order + "H", data[ifd:ifd + 2])[0]
    for k in range(n):
        entry = ifd + 2 + 12 * k
        tag, typ, count = struct.unpack(order + "HHI", data[entry:entry + 8])
        if tag not in blobs:
            continue
        offsets = []
        for blob in blobs[tag]:
            offsets.append(len(out))
            out += blob
            if len(out) % 2:
                out += b"\0"
        packed = struct.pack(order + "I" * count, *offsets)
        where = entry + 8 if count == 1 else struct.unpack(order + "I", data[entry + 8:entry + 12])[0]
        out[where:where + len(packed)] = packed
    return bytes(out)


# ---- BMP ----

def rle_encode(indices: np.ndarray, rle4: bool) -> bytes:
    """RLE8 / RLE4 of (H, W) palette indices (bottom row first, as a BMP
    stores them), as PIL's BmpRleDecoder reads it: encoded runs of equal
    values (RLE4: of a repeated pair), absolute runs of 3 or more (RLE4: an
    even count of 4 or more, PIL reading n / 2 bytes) with their word
    padding (counted from the file's pixel data, which `bmp_bytes` puts at
    an even offset), a row's trailing zeros skipped by a delta escape in
    PIL's six-byte reading (0, 2, two skipped bytes, right, up) on every
    other row and by end of line on the others, an empty row by a delta one
    row up, end of bitmap last."""
    out = bytearray()
    H, W = indices.shape
    for y in range(H - 1, -1, -1):
        row = [int(v) for v in indices[y]]
        end = len(row)
        while end and row[end - 1] == 0:
            end -= 1
        x, literal = 0, []

        def flush():
            i = 0
            while len(literal) - i >= (4 if rle4 else 3):
                n = min(len(literal) - i, 254)
                n -= n % 2 if rle4 else 0
                part = literal[i:i + n]
                data = bytes((part[k] << 4) | part[k + 1] for k in range(0, n, 2)) if rle4 else bytes(part)
                out.extend(bytes([0, n]) + data + b"\x00" * (len(data) % 2))
                i += n
            for k in range(i, len(literal), 2):  # what is left: encoded runs of one or two pixels
                pair = literal[k:k + 2]
                if rle4:
                    out.extend(bytes([len(pair), (pair[0] << 4) | (pair[-1] if len(pair) == 2 else 0)]))
                else:
                    out.extend(b"".join(bytes([1, v]) for v in pair))
            literal.clear()

        while x < end:
            if rle4:  # a pair repeated, and one more of its first value
                run = 0
                while x + run + 2 <= end and run + 2 <= 254 and row[x + run:x + run + 2] == row[x:x + 2]:
                    run += 2
                if run and x + run < end and row[x + run] == row[x]:
                    run += 1
            else:
                run = 1
                while x + run < end and run < 255 and row[x + run] == row[x]:
                    run += 1
            if run >= 3:
                flush()
                out.extend(bytes([run, (row[x] << 4) | row[x + 1] if rle4 else row[x]]))
                x += run
            else:
                literal.append(row[x])
                x += 1
        flush()
        if end == 0:  # an empty row: a delta one row up (end of line would add nothing at x = 0)
            out.extend(bytes([0, 2, 0, 0, 0, 1]))
        elif W - end <= 255 and y % 2 == 0 and y > 0:
            out.extend(bytes([0, 2, 0, 0, W - end, 0]))
        else:
            out.extend(b"\x00\x00")
    return bytes(out + b"\x00\x01")


def bmp_bytes(rows: bytes, width: int, height: int, bits: int, header_size: int = 40, compression: int = 0,
              palette=None, colors: int = 0, masks=None, masks_after_header: bool = False, top_down: bool = False,
              data_offset=None) -> bytes:
    """A BMP file of raw pixel-data bytes `rows` (in the file's order, each
    row padded to 4 bytes unless RLE): the 14-byte file header, a header of
    `header_size` bytes (12: OS/2 1.x, with 3-byte palette entries), a
    palette of (N, 3) RGB entries, BI_BITFIELDS masks inside a V2+ header or
    after a 40-byte one."""
    if header_size == 12:
        header = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        header = struct.pack("<IiiHHIIiiII", header_size, width, -height if top_down else height, 1, bits,
                             compression, len(rows), 2835, 2835, colors, 0)
        if masks is not None and not masks_after_header:
            header += struct.pack("<" + "I" * len(masks), *masks)
        header = header.ljust(header_size, b"\0")
        if masks is not None and masks_after_header:
            header += struct.pack("<III", *masks[:3])
    table = b""
    if palette is not None:
        pal = np.asarray(palette, np.uint8)[:, ::-1]  # RGB -> BGR
        if header_size != 12:
            pal = np.concatenate([pal, np.zeros((len(pal), 1), np.uint8)], 1)
        table = pal.tobytes()
    offset = 14 + len(header) + len(table) if data_offset is None else data_offset
    gap = max(0, offset - (14 + len(header) + len(table)))
    return (b"BM" + struct.pack("<IHHI", offset + len(rows), 0, 0, offset) + header + table + b"\0" * gap
            + rows)


def padded_rows(row_bytes: np.ndarray) -> bytes:
    """(H, n) row bytes, bottom row first in the file, each padded to 4."""
    H, n = row_bytes.shape
    out = np.zeros((H, (n + 3) // 4 * 4), np.uint8)
    out[:, :n] = row_bytes
    return out[::-1].tobytes()


# ---- GIF ----

def gif_lzw_encode(indices: np.ndarray, bits: int, clear_every: int = 0) -> bytes:
    """GIF's LZW of the indices (each below 1 << max(bits, 1)) with minimum
    code size `bits`, in 255-byte sub-blocks and a terminator: a Clear
    first, the code width grown after the code with which the decoder's
    table reaches 1 << width entries (up to 12 bits), a Clear when the table
    is full or, with `clear_every`, after that many codes; End last. Below
    2 bits the decoder's table never grows its codes: use clear_every=1,
    which sends every byte as the first code after a Clear."""
    clear, end = 1 << bits, (1 << bits) + 1
    codes, widths = [], []
    width, free, table = bits + 1, clear + 2, {}

    def emit(code):
        codes.append(code), widths.append(width)

    def reset():
        nonlocal width, free, table, first
        emit(clear)
        width, free, table, first = bits + 1, clear + 2, {}, True

    first = True
    reset()
    data = [int(v) for v in np.asarray(indices).reshape(-1)]
    w, count = data[0], 0
    for b in data[1:]:
        c = table.get((w, b))
        if c is not None:
            w = c
            continue
        emit(w)
        count += 1
        # the decoder's table reaches 1 << width with this code (not with
        # the first after a Clear, which adds no entry)
        if free == 1 << width and width < 12 and not first:
            width += 1
        first = False
        if free < 4096:
            table[(w, b)] = free
            free += 1
        if free >= 4096 or (clear_every and count % clear_every == 0):
            reset()
        w = b
    emit(w)
    emit(end)
    acc = nbits = 0
    out = bytearray()
    for c, wd in zip(codes, widths):
        acc |= c << nbits
        nbits += wd
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 255)
    blocks = bytearray()
    for i in range(0, len(out), 255):
        chunk = out[i:i + 255]
        blocks += bytes([len(chunk)]) + chunk
    return bytes(blocks) + b"\x00"


def _interlaced_rows(h: int) -> list:
    return [y for start, step in ((0, 8), (4, 8), (2, 4), (1, 2)) for y in range(start, h, step)]


def gif_bytes(indices: np.ndarray, global_palette=None, local_palette=None, transparency=None, interlace=False,
              version=b"GIF89a", screen=None, offset=(0, 0), bits=None, comment=None, loop=None,
              clear_every=0, image_data=None) -> bytes:
    """A one-frame GIF of (h, w) palette indices; palettes are (n, 3) with
    n a power of two from 2 to 256. `bits` defaults to the palette's bits
    (at least 2), `screen` to the frame's size; `image_data` replaces the
    LZW sub-blocks."""
    h, w = indices.shape
    sw, sh = screen or (w, h)
    out = bytearray(version + struct.pack("<HH", sw, sh))
    if global_palette is not None:
        n = len(global_palette)
        out += bytes([0x80 | (n.bit_length() - 2), 0, 0]) + np.asarray(global_palette, np.uint8).tobytes()
    else:
        out += b"\x00\x00\x00"
    if loop is not None:
        out += b"!\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"
    if comment is not None:
        out += b"!\xfe" + bytes([len(comment)]) + comment + b"\x00"
    if transparency is not None:
        out += b"!\xf9\x04\x01\x00\x00" + bytes([transparency]) + b"\x00"
    flags = 0x40 if interlace else 0
    if local_palette is not None:
        flags |= 0x80 | (len(local_palette).bit_length() - 2)
    out += b"," + struct.pack("<HHHH", offset[0], offset[1], w, h) + bytes([flags])
    if local_palette is not None:
        out += np.asarray(local_palette, np.uint8).tobytes()
    palette = local_palette if local_palette is not None else global_palette
    if bits is None:
        bits = max(2, (len(palette) - 1).bit_length() if palette is not None else 8)
    rows = indices[_interlaced_rows(h)] if interlace else indices
    out += bytes([bits]) + (image_data if image_data is not None else gif_lzw_encode(rows, bits, clear_every))
    return bytes(out) + b";"


# ---- WebP ----

def _riff_chunk(fourcc: bytes, payload: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(payload)) + payload + b"\x00" * (len(payload) & 1)


def webp_chunks(data: bytes) -> list:
    """(fourcc, payload) of each chunk of a RIFF WebP file."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        size = struct.unpack_from("<I", data, pos + 4)[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def alpha_filter(alpha: np.ndarray, method: int) -> np.ndarray:
    """libwebp's forward alpha filters: 0 none, 1 horizontal, 2 vertical,
    3 gradient; the first row predicted from the left (its first pixel
    from 0), the first column from above."""
    a = alpha.astype(np.int64)
    pred = np.zeros_like(a)
    if method == 0:
        return alpha.copy()
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    if method == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif method == 2:
        pred[1:, 1:] = a[:-1, 1:]
    else:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 255).astype(np.uint8)


def alph_chunk(alpha: np.ndarray, method: int, lossless_payload: bytes = None) -> bytes:
    """An ALPH payload: compression 0 (the filtered plane as it is) or 1
    (`lossless_payload`: a VP8L stream of the filtered plane in green,
    without its 5-byte header)."""
    if lossless_payload is None:
        return bytes([method << 2]) + alpha_filter(alpha, method).tobytes()
    return bytes([1 | method << 2]) + lossless_payload


def webp_vp8x(image_chunk, width: int, height: int, alph: bytes = None, extra=(), flags: int = None,
              extra_after=()) -> bytes:
    """An extended WebP: VP8X, the chunks of `extra`, ALPH (if given), the
    image chunk (fourcc, payload), then the chunks of `extra_after`.
    `flags` defaults to the alpha flag where there is an ALPH chunk and
    the ICCP / EXIF / XMP flags of the chunks given."""
    named = {b"ICCP": 0x20, b"EXIF": 0x08, b"XMP ": 0x04}
    if flags is None:
        flags = (0x10 if alph is not None else 0) | sum(named.get(k, 0) for k, _ in (*extra, *extra_after))
    body = _riff_chunk(b"VP8X", bytes([flags, 0, 0, 0]) + struct.pack("<I", width - 1)[:3]
                       + struct.pack("<I", height - 1)[:3])
    body += b"".join(_riff_chunk(k, v) for k, v in extra)
    if alph is not None:
        body += _riff_chunk(b"ALPH", alph)
    body += _riff_chunk(*image_chunk) + b"".join(_riff_chunk(k, v) for k, v in extra_after)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


# ---- VP8 variants: what PIL's encoder options cannot pick ----
# A PIL-made VP8 frame is parsed into the boolean decisions (bit,
# probability) of its first partition and of each macroblock row's tokens
# (RFC 6386's syntax), fixed-length header fields are rewritten or
# inserted, and the decisions are coded again (RFC 6386 7.3's encoder) into
# 1, 2, 4 or 8 token partitions. The coefficient and mode probability tables
# are read from the port's decoder source, which the lossy tests hold to PIL.

_WEBP_DECODER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "gaussian_splatting_torch", "csrc", "webp_decode.cc")
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT3456 = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
            (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))


def _vp8_tables():
    with open(_WEBP_DECODER) as f:
        src = f.read()

    def table(name, shape):
        body = re.search(re.escape(name) + r"\[[^=]*=\s*\{(.*?)\};", src, re.S).group(1)
        return np.array([int(v) for v in re.findall(r"\d+", body)]).reshape(shape)

    return (table("kCoeffsProba0", (4, 8, 3, 11)), table("kCoeffsUpdateProba", (4, 8, 3, 11)),
            table("kBModesProba", (10, 10, 9)))


class _Decisions:
    """RFC 6386's boolean decoder, keeping every (bit, probability) it reads."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.log = data, 0, []
        self.value = (self._byte() << 8) | self._byte()
        self.range, self.count = 255, 0

    def _byte(self):
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def bit(self, prob):
        split = 1 + (((self.range - 1) * prob) >> 8)
        bit = int(self.value >= split << 8)
        if bit:
            self.range -= split
            self.value -= split << 8
        else:
            self.range = split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                self.value |= self._byte()
        self.log.append((bit, prob))
        return bit

    def literal(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n):
        v = self.literal(n)
        return -v if self.literal(1) else v


def bool_encode(decisions) -> bytes:
    """RFC 6386 7.3's boolean encoder, flushed with its four bytes."""
    out, rng, bottom, count = bytearray(), 255, 0, 24
    for bit, prob in decisions:
        split = 1 + (((rng - 1) * prob) >> 8)
        if bit:
            bottom += split
            rng -= split
        else:
            rng = split
        while rng < 128:
            rng <<= 1
            if bottom & (1 << 31):  # carry into the bytes written
                i = len(out) - 1
                while out[i] == 255:
                    out[i] = 0
                    i -= 1
                out[i] += 1
            bottom = (bottom << 1) & 0xFFFFFFFF
            count -= 1
            if count == 0:
                out.append(bottom >> 24)
                bottom &= (1 << 24) - 1
                count = 8
    v = bottom
    if v & (1 << (32 - count)):
        i = len(out) - 1
        while out[i] == 255:
            out[i] = 0
            i -= 1
        out[i] += 1
    v = (v << (count & 7)) & 0xFFFFFFFF
    for _ in range(count >> 3):
        v = (v << 8) & 0xFFFFFFFF
    for _ in range(4):
        out.append(v >> 24)
        v = (v << 8) & 0xFFFFFFFF
    return bytes(out)


def _coefficients(br, probas, ctx, n):
    """One block's tokens from position n; the position after its last
    non-zero coefficient."""
    p = probas[_BANDS[n]][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            p = probas[_BANDS[n]][0]
            if n == 16:
                return 16
        nxt = probas[_BANDS[n + 1]]
        if not br.bit(p[2]):
            p = nxt[1]
        else:
            if not br.bit(p[3]):
                if br.bit(p[4]):
                    br.bit(p[5])
            elif not br.bit(p[6]):
                if not br.bit(p[7]):
                    br.bit(159)
                else:
                    br.bit(165), br.bit(145)
            else:
                bit1 = br.bit(p[8])
                for prob in _CAT3456[2 * bit1 + br.bit(p[9 + bit1])]:
                    br.bit(prob)
            p = nxt[2]
        br.bit(128)  # the sign
        n += 1
    return 16


def _vp8_parse(payload: bytes):
    """The first partition's decisions with the index of each header field
    of `vp8_variant`, the token decisions of each macroblock row, and the
    frame's partition count."""
    proba0, update, bmodes = _vp8_tables()
    tag = payload[0] | payload[1] << 8 | payload[2] << 16
    w, h = (payload[6] | payload[7] << 8) & 0x3FFF, (payload[8] | payload[9] << 8) & 0x3FFF
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    first = tag >> 5
    br = _Decisions(payload[10:10 + first])
    fields = {}
    br.literal(2)  # colour space, clamping
    use_segment = br.literal(1)
    update_map, seg_probs = 0, [255] * 3
    if use_segment:
        update_map = br.literal(1)
        if br.literal(1):
            fields["absolute_delta"] = len(br.log)
            br.literal(1)
            for bits in (7,) * 4 + (6,) * 4:
                if br.literal(1):
                    br.signed(bits)
        if update_map:
            seg_probs = [br.literal(8) if br.literal(1) else 255 for _ in range(3)]
    for name, bits in (("simple", 1), ("level", 6), ("sharpness", 3), ("use_lf_delta", 1)):
        fields[name] = len(br.log)
        value = br.literal(bits)
    if value and br.literal(1):
        for _ in range(8):
            if br.literal(1):
                br.signed(6)
    fields["partitions"] = len(br.log)
    n_parts = 1 << br.literal(2)
    br.literal(7)
    for _ in range(5):
        if br.literal(1):
            br.signed(4)
    br.literal(1)
    probas = proba0.copy()
    for idx in np.ndindex(*update.shape):
        if br.bit(int(update[idx])):
            probas[idx] = br.literal(8)
    use_skip = br.literal(1)
    skip_p = br.literal(8) if use_skip else 0
    sizes = [int.from_bytes(payload[10 + first + 3 * i:13 + first + 3 * i], "little") for i in range(n_parts - 1)]
    at = 10 + first + 3 * (n_parts - 1)
    parts = []
    for size in sizes + [len(payload) - at - sum(sizes)]:
        parts.append(_Decisions(payload[at:at + size]))
        at += size
    intra_t, nz, nz_dc, rows = [0] * (4 * mb_w), [0] * mb_w, [0] * mb_w, []
    for mb_y in range(mb_h):
        intra_l, blocks = [0] * 4, []
        for mb_x in range(mb_w):
            if update_map:
                br.bit(seg_probs[1]) if not br.bit(seg_probs[0]) else br.bit(seg_probs[2])
            skip = br.bit(skip_p) if use_skip else 0
            i4x4 = not br.bit(145)
            top = intra_t[4 * mb_x:4 * mb_x + 4]
            if not i4x4:
                ymode = (1 if br.bit(128) else 3) if br.bit(156) else (2 if br.bit(163) else 0)
                top, intra_l = [ymode] * 4, [ymode] * 4
            else:
                for y in range(4):
                    ymode = intra_l[y]
                    for x in range(4):
                        p = bmodes[top[x]][ymode]
                        if not br.bit(p[0]):
                            ymode = 0
                        elif not br.bit(p[1]):
                            ymode = 1
                        elif not br.bit(p[2]):
                            ymode = 2
                        elif not br.bit(p[3]):
                            ymode = 3 if not br.bit(p[4]) else (4 if not br.bit(p[5]) else 5)
                        else:
                            ymode = 6 if not br.bit(p[6]) else (
                                7 if not br.bit(p[7]) else (8 if not br.bit(p[8]) else 9))
                        top[x] = ymode
                    intra_l[y] = ymode
            intra_t[4 * mb_x:4 * mb_x + 4] = top
            if br.bit(142) and br.bit(114):
                br.bit(183)
            blocks.append((skip, i4x4))
        tokens = parts[mb_y & (n_parts - 1)]
        start, left_nz, left_dc = len(tokens.log), 0, 0
        for mb_x, (skip, i4x4) in enumerate(blocks):
            if skip:
                left_nz = nz[mb_x] = 0
                if not i4x4:
                    left_dc = nz_dc[mb_x] = 0
                continue
            first_coeff = 0
            if not i4x4:
                n = _coefficients(tokens, probas[1], nz_dc[mb_x] + left_dc, 0)
                left_dc = nz_dc[mb_x] = int(n > 0)
                first_coeff = 1
            tnz, lnz = nz[mb_x] & 0x0F, left_nz & 0x0F
            out_t = out_l = 0
            for y in range(4):
                left = (lnz >> y) & 1
                for x in range(4):
                    n = _coefficients(tokens, probas[3 if i4x4 else 0], left + ((tnz >> x) & 1), first_coeff)
                    left = int(n > first_coeff)
                    tnz = (tnz & ~(1 << x)) | (left << x)
                out_l |= left << y
            out_t = tnz
            for ch in (4, 6):
                tnz, lnz = (nz[mb_x] >> ch) & 3, (left_nz >> ch) & 3
                for y in range(2):
                    left = (lnz >> y) & 1
                    for x in range(2):
                        left = int(_coefficients(tokens, probas[2], left + ((tnz >> x) & 1), 0) > 0)
                        tnz = (tnz & ~(1 << x)) | (left << x)
                    out_l |= left << (ch + y)
                out_t |= tnz << ch
            nz[mb_x], left_nz = out_t, out_l
        rows.append(tokens.log[start:])
    return br.log, fields, rows, tag


def vp8_variant(payload: bytes, partitions: int = 1, sharpness=None, simple=None, level=None,
                lf_deltas=None, relative_segments=False) -> bytes:
    """A VP8 frame payload with the decisions of `payload` (a key frame of
    one token partition) in `partitions` token partitions (1, 2, 4, 8; rows
    round-robin) and, where given, the loop filter's sharpness (0-7), type
    (simple 1 or normal 0) and level (0-63), its reference / mode deltas
    (`lf_deltas` = (ref_frame_0, mode_0), each -63..63, inserted where the
    frame has none), or the segment quantizers and filter levels made
    relative to the frame's (the absolute-delta bit cleared)."""
    log, fields, rows, tag = _vp8_parse(payload)
    log = list(log)

    def put(name, bits, value):
        at = fields[name]
        log[at:at + bits] = [((value >> (bits - 1 - i)) & 1, 128) for i in range(bits)]

    for name, bits, value in (("sharpness", 3, sharpness), ("simple", 1, simple), ("level", 6, level)):
        if value is not None:
            put(name, bits, value)
    put("partitions", 2, partitions.bit_length() - 1)
    if relative_segments:
        put("absolute_delta", 1, 0)
    if lf_deltas is not None:
        at = fields["use_lf_delta"]
        assert log[at][0] == 0, "the frame has loop-filter deltas already"
        inserted = [(1, 128), (1, 128)]  # use deltas, update them
        for group in range(2):
            for i in range(4):
                value = lf_deltas[group] if i == 0 else 0
                inserted.append((int(i == 0), 128))
                if i == 0:
                    inserted += [((abs(value) >> (5 - b)) & 1, 128) for b in range(6)] + [(int(value < 0), 128)]
        log[at:at + 1] = inserted
    first = bool_encode(log)
    parts = [bool_encode([d for y, row in enumerate(rows) if y % partitions == k for d in row])
             for k in range(partitions)]
    head = ((tag & 0x1F) | len(first) << 5).to_bytes(3, "little") + payload[3:10]
    sizes = b"".join(len(p).to_bytes(3, "little") for p in parts[:-1])
    return head + first + sizes + b"".join(parts)


def webp_simple(fourcc: bytes, payload: bytes) -> bytes:
    """A simple WebP: RIFF, WEBP and one VP8 or VP8L chunk."""
    body = _riff_chunk(fourcc, payload)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


# ---- PPM ----

def pnm_bytes(magic: bytes, samples, maxval=None, plain=False, header_comment=b"", data_comment=b"",
              line=70, packed=False, scale=-1.0) -> bytes:
    """A PBM / PGM / PPM / PFM file of `magic` holding (H, W[, C]) `samples`
    (P1 / P4: 1 is black; Pf: floats, rows written bottom to top, little
    endian under a negative `scale`). Binary samples are one byte at
    maxval < 256, else two big-endian; plain ones decimal, `line` bytes a
    line at most, P1's digits without spaces where `packed`.
    `header_comment` goes after the magic, `data_comment` after the first
    line of plain data."""
    a = np.asarray(samples)
    h, w = a.shape[:2]
    head = magic + b"\n" + header_comment + b"%d %d\n" % (w, h)
    if magic == b"Pf":
        order = "<f4" if scale < 0 else ">f4"
        return head + (b"%r\n" % scale) + np.ascontiguousarray(a.reshape(h, w)[::-1]).astype(order).tobytes()
    if maxval is not None:
        head += b"%d\n" % maxval
    if magic == b"P4":
        return head + np.packbits(a.reshape(h, w).astype(np.uint8), axis=1).tobytes()
    if not plain:
        return head + a.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
    tokens = [b"%d" % v for v in a.reshape(-1)]
    sep = b"" if packed else b" "
    lines, cur = [], b""
    for t in tokens:
        if cur and len(cur) + len(sep) + len(t) > line:
            lines.append(cur)
            cur = t
        else:
            cur = cur + sep + t if cur else t
    lines.append(cur)
    if data_comment:
        lines.insert(1, data_comment)
    return head + b"\n".join(lines) + b"\n"


# ---- TGA ----

def tga_rle(rows: np.ndarray, depth: int, cross_rows=True) -> bytes:
    """RLE packets of (H, row bytes) pixel rows in file order, `depth`
    bytes a pixel: runs of 2 to 128 equal pixels within a row, raw packets
    of up to 128 pixels for the rest, which run on across rows where
    `cross_rows` (PIL reads both)."""
    px = np.ascontiguousarray(rows).reshape(len(rows), -1, depth)
    out = bytearray()
    pending = []

    def flush():
        while pending:
            take = pending[:128]
            del pending[:128]
            out.append(len(take) - 1)
            out.extend(b"".join(take))

    for row in px:
        vals = [bytes(p) for p in row]
        i = 0
        while i < len(vals):
            j = i
            while j + 1 < len(vals) and vals[j + 1] == vals[i] and j + 1 - i < 127:
                j += 1
            if j > i:
                flush()
                out.append(0x80 | (j - i))
                out.extend(vals[i])
            else:
                pending.append(vals[i])
            i = j + 1
        if not cross_rows:
            flush()
    flush()
    return bytes(out)


def tga_bytes(rows: np.ndarray, width: int, height: int, image_type: int, depth: int, flags: int = 0x20,
              colormap: bytes = None, map_depth: int = 24, map_start: int = 0, ident: bytes = b"",
              rle: bytes = None) -> bytes:
    """A TGA file: the 18-byte header, the ID field, the colour map (raw
    entries, `map_depth` bits each, from index `map_start`), then the pixel
    rows (H, row bytes) in file order, or the RLE packets `rle`."""
    n_map = 0 if colormap is None else len(colormap) // (map_depth // 8)
    head = struct.pack("<BBBHHBHHHHBB", len(ident), int(colormap is not None), image_type, map_start, n_map,
                       map_depth if colormap is not None else 0, 0, 0, width, height, depth, flags)
    body = rle if rle is not None else np.ascontiguousarray(rows).tobytes()
    return head + ident + (colormap or b"") + body


# ---- JPEG 2000 ----

def jp2_box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(body), kind) + body


def jp2_bytes(codestream: bytes, components: int = None, bpc: int = 7, colr=(1, 16), pclr=None, cdef=None,
              res=None, brand=b"jp2 ", size=None, after_header=b"", extra_header=b"") -> bytes:
    """A JP2 file: the signature and file-type boxes, a header box (`ihdr`
    of the codestream's size and `components`, or `size`; `colr`: (1,
    enumerated space), or (2, ICC bytes); `pclr`: (entries (N, C) uint8,
    with a `cmap` mapping component 0 through every column); `cdef`:
    [(channel, type, association)]; `res `: a capture resolution), then
    `after_header` boxes and the codestream box."""
    x1, y1, x0, y0 = struct.unpack_from(">IIII", codestream, 8)
    if components is None:
        components = struct.unpack_from(">H", codestream, 40)[0]
    w, h = size or (x1 - x0, y1 - y0)
    header = jp2_box(b"ihdr", struct.pack(">IIHBBBB", h, w, components, bpc, 7, 0, 0))
    if colr is not None:
        header += jp2_box(b"colr", struct.pack(">BBBI", 1, 0, 0, colr[1]) if colr[0] == 1
                          else bytes([2, 0, 0]) + colr[1])
    if pclr is not None:
        entries = np.asarray(pclr, np.uint8)
        n, c = entries.shape
        header += jp2_box(b"pclr", struct.pack(">HB", n, c) + bytes([7] * c) + entries.tobytes())
        header += jp2_box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, i) for i in range(c)))
    if cdef is not None:
        header += jp2_box(b"cdef", struct.pack(">H", len(cdef)) + b"".join(struct.pack(">HHH", *d) for d in cdef))
    if res is not None:
        header += jp2_box(b"res ", jp2_box(b"resc", struct.pack(">HHHHBB", res, 1, res, 1, 0, 0)))
    return (jp2_box(b"jP  ", b"\r\n\x87\n") + jp2_box(b"ftyp", brand + b"\0\0\0\0" + brand)
            + jp2_box(b"jp2h", header + extra_header) + after_header + jp2_box(b"jp2c", codestream))


def j2k_markers(codestream: bytes):
    """A raw codestream taken apart: (main header segments [(marker,
    body)] after SOC, tile-parts [(Isot, TPsot, TNsot, [(marker, body)],
    data)]) from a codestream whose tile-parts give their Psot."""
    pos, main, parts = 2, [], []
    while True:
        marker = struct.unpack_from(">H", codestream, pos)[0]
        if marker == 0xFF90:
            break
        n = struct.unpack_from(">H", codestream, pos + 2)[0]
        main.append((marker, codestream[pos + 4:pos + 2 + n]))
        pos += 2 + n
    while struct.unpack_from(">H", codestream, pos)[0] == 0xFF90:
        isot, psot, tpsot, tnsot = struct.unpack_from(">HIBB", codestream, pos + 4)
        end, at, segments = pos + psot, pos + 12, []
        while struct.unpack_from(">H", codestream, at)[0] != 0xFF93:
            marker, n = struct.unpack_from(">HH", codestream, at)
            segments.append((marker, codestream[at + 4:at + 2 + n]))
            at += 2 + n
        parts.append((isot, tpsot, tnsot, segments, codestream[at + 2:end]))
        pos = end
    return main, parts


def j2k_join(main, parts, end=b"\xff\xd9") -> bytes:
    """The codestream of `j2k_markers`' pieces, lengths and Psot computed."""
    def segment(marker, body):
        return struct.pack(">HH", marker, 2 + len(body)) + body

    out = b"\xff\x4f" + b"".join(segment(m, b) for m, b in main)
    for isot, tpsot, tnsot, segments, data in parts:
        header = b"".join(segment(m, b) for m, b in segments)
        out += struct.pack(">HHHIBB", 0xFF90, 10, isot, 12 + len(header) + 2 + len(data), tpsot, tnsot)
        out += header + b"\xff\x93" + data
    return out + end


def j2k_split_parts(codestream: bytes, pieces: int = 2) -> bytes:
    """The codestream with each tile's data cut into `pieces` tile-parts
    (TNsot set), the first keeping the tile-part header's segments."""
    main, parts = j2k_markers(codestream)
    out = []
    for isot, _, _, segments, data in parts:
        cuts = [len(data) * k // pieces for k in range(pieces + 1)]
        for k in range(pieces):
            out.append((isot, k, pieces, segments if k == 0 else [], data[cuts[k]:cuts[k + 1]]))
    return j2k_join(main, out)


# ---- DIB, QOI, PCX / DCX, SGI, ICO / CUR, PSD ----

def dib_bytes(rows: bytes, width: int, height: int, bits: int, *args, **kw) -> bytes:
    """A DIB: `bmp_bytes` without its 14-byte file header (the pixels right
    after the header, its masks and its colour table)."""
    return bmp_bytes(rows, width, height, bits, *args, **kw)[14:]


def rle_chunks(atoms: np.ndarray, max_run: int, max_lit: int, min_run: int = 2):
    """Run-length chunks of each row of (R, W) atoms: (flat start, count,
    is_run) in stream order. Runs of `min_run` or more equal atoms become
    run chunks of at most `max_run`; the atoms between them literal chunks
    of at most `max_lit`, never across a row."""
    R, W = atoms.shape
    flat = atoms.ravel()
    change = np.ones(R * W, bool)
    change[1:] = flat[1:] != flat[:-1]
    change[::W] = True
    start = np.nonzero(change)[0]
    length = np.diff(np.append(start, R * W))
    is_run = length >= min_run
    row = start // W
    new_group = is_run.copy()
    new_group[0] = True
    new_group[1:] |= (row[1:] != row[:-1]) | is_run[:-1]
    gid = np.cumsum(new_group) - 1
    g_start, g_run = start[new_group], is_run[new_group]
    g_len = np.bincount(gid, weights=length).astype(np.int64)
    cap = np.where(g_run, max_run, max_lit)
    n = -(-g_len // cap)
    c_gid = np.repeat(np.arange(len(n)), n)
    k = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    c_start = g_start[c_gid] + k * cap[c_gid]
    c_count = np.minimum(cap[c_gid], g_len[c_gid] - k * cap[c_gid])
    return c_start, c_count, g_run[c_gid]


def _emit(flat: np.ndarray, headers: np.ndarray, c_start, payload_len, copy) -> np.ndarray:
    """The atom stream of chunks: each chunk's header atom, then its payload
    (`payload_len` atoms of `flat` from its start where `copy`, else its
    first atom `payload_len` times)."""
    n = 1 + payload_len
    total = int(n.sum())
    cid = np.repeat(np.arange(len(n)), n)
    k = np.arange(total) - np.repeat(np.cumsum(n) - n, n)
    src = c_start[cid] + np.where(copy[cid], k - 1, 0)
    out = flat[np.clip(src, 0, len(flat) - 1)].astype(flat.dtype)
    out[k == 0] = headers
    return out


def qoi_encode(px: np.ndarray) -> bytes:
    """The QOI ops of (H, W, 3 or 4) uint8 pixels, as the reference encoder
    chooses them: RUN for a pixel equal to the one before (runs of 62 at
    most), INDEX where the pixel is in the table, else DIFF, LUMA, RGB, or
    RGBA where alpha changes. Vectorised: the table slot of a pixel holds
    the last pixel before it that started something other than a run."""
    h, w, c = px.shape
    p = np.full((h * w, 4), 255, np.uint8)
    p[:, :c] = px.reshape(-1, c)
    prev = np.concatenate([np.array([[0, 0, 0, 255]], np.uint8), p[:-1]])
    same = (p == prev).all(1)
    new = np.nonzero(~same)[0]
    hsh = (p[new].astype(np.int64) @ np.array([3, 5, 7, 11])) % 64
    order = np.lexsort((new, hsh))
    before = np.full(len(new), -1)
    grp = hsh[order]
    before[order[1:]] = np.where(grp[1:] == grp[:-1], new[order[:-1]], -1)
    seen = np.where(before[:, None] >= 0, p[np.maximum(before, 0)], 0)
    index = (seen == p[new]).all(1)
    d = (p[new].astype(np.int16) - prev[new]).astype(np.int8).astype(np.int64)
    dr, dg, db = d[:, 0], d[:, 1], d[:, 2]
    same_a = p[new, 3] == prev[new, 3]
    diff = same_a & (np.abs(d[:, :3] + 0.5) < 2).all(1)
    gr, gb = ((dr - dg + 128) & 255) - 128, ((db - dg + 128) & 255) - 128
    luma = same_a & ~diff & (dg >= -32) & (dg < 32) & (gr >= -8) & (gr < 8) & (gb >= -8) & (gb < 8)
    op = np.select([index, diff, luma, same_a], [0, 1, 2, 3], 4)  # 3 RGB, 4 RGBA
    size = np.array([1, 1, 2, 4, 5])[op]
    # the runs: maximal stretches of `same`, cut at 62
    s_idx = np.nonzero(same)[0]
    starts = s_idx[np.r_[True, np.diff(s_idx) > 1]] if len(s_idx) else s_idx
    ends = s_idx[np.r_[np.diff(s_idx) > 1, True]] + 1 if len(s_idx) else s_idx
    run_len = ends - starts
    n_runs = -(-run_len // 62)
    pos = np.concatenate([new, np.repeat(starts, n_runs)])
    rid = np.repeat(np.arange(len(starts)), n_runs)
    k = np.arange(int(n_runs.sum())) - np.repeat(np.cumsum(n_runs) - n_runs, n_runs)
    run_bytes = np.minimum(62, run_len[rid] - 62 * k)
    tie = np.concatenate([np.zeros(len(new)), 1 + k])  # a run's bytes come before the next new pixel
    nbytes = np.concatenate([size, np.ones(len(k), np.int64)])
    order = np.lexsort((tie, pos))
    off = np.zeros(len(order), np.int64)
    off[order] = np.cumsum(nbytes[order]) - nbytes[order]
    out = np.zeros(int(nbytes.sum()), np.uint8)
    o_new, o_run = off[:len(new)], off[len(new):]
    out[o_run] = 0xC0 | (run_bytes - 1)
    q = p[new]
    m = op == 0
    out[o_new[m]] = hsh[m]
    m = op == 1
    out[o_new[m]] = 0x40 | (dr[m] + 2) << 4 | (dg[m] + 2) << 2 | (db[m] + 2)
    m = op == 2
    out[o_new[m]] = 0x80 | (dg[m] + 32)
    out[o_new[m] + 1] = (gr[m] + 8) << 4 | (gb[m] + 8)
    for code, width in ((3, 3), (4, 4)):
        m = op == code
        out[o_new[m]] = 0xFE if code == 3 else 0xFF
        for j in range(width):
            out[o_new[m] + 1 + j] = q[m, j]
    return out.tobytes()


def qoi_bytes(px: np.ndarray = None, channels: int = None, colorspace: int = 0, width: int = None,
              height: int = None, ops: bytes = None, end: bool = True) -> bytes:
    """A QOI file: its 14-byte header (the pixels' size and channel count
    unless given), the ops of `px` (`qoi_encode`) or the raw `ops` given,
    and the 8-byte end marker."""
    if px is not None:
        height, width = px.shape[:2] if height is None else (height, width)
        channels = px.shape[2] if channels is None else channels
    body = qoi_encode(px) if ops is None else ops
    return (b"qoif" + struct.pack(">IIBB", width, height, channels, colorspace) + body
            + (bytes(7) + b"\x01" if end else b""))


def pcx_rle(lines: np.ndarray) -> bytes:
    """PCX's RLE of (H, line bytes) lines: runs of up to 63 equal bytes as
    a count byte (0xC0 | n) and the byte, a lone byte below 0xC0 as itself;
    no run crosses a line."""
    lines = np.ascontiguousarray(lines, np.uint8)
    flat = lines.ravel()
    c_start, c_count, _ = rle_chunks(lines, 63, 1, min_run=1)
    lone = (c_count == 1) & (flat[c_start] < 0xC0)
    n = np.where(lone, 1, 2)
    cid = np.repeat(np.arange(len(n)), n)
    k = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    value = flat[c_start[cid]]
    head = (k == 0) & ~lone[cid]
    return np.where(head, 0xC0 | c_count[cid], value).astype(np.uint8).tobytes()


def pcx_lines(pixels: np.ndarray, bits: int, planes: int, stride: int) -> np.ndarray:
    """(H, planes * stride) PCX lines of (H, W) indices (1 bit a plane:
    bit p of each index in plane p, most significant bit first) or of
    (H, W, planes) bytes (8 bits: a plane a channel), each plane padded to
    `stride` bytes."""
    h = pixels.shape[0]
    out = np.zeros((h, planes, stride), np.uint8)
    for p in range(planes):
        if bits == 1:
            packed = np.packbits(((pixels >> p) & 1).astype(np.uint8), axis=1)
        else:
            packed = pixels[..., p]
        out[:, p, :packed.shape[1]] = packed
    return out.reshape(h, planes * stride)


def pcx_bytes(lines: np.ndarray, width: int, height: int, bits: int, planes: int, version: int = 5,
              stride: int = None, header_palette=None, tail_palette=None, box=None, body: bytes = None) -> bytes:
    """A PCX file: the 128-byte header (the box from (0, 0) unless `box`,
    a plane's `stride` as the header states it, the 16-entry palette), the
    RLE of `lines` (or `body`), then a 12 and 256 RGB entries where
    `tail_palette` is given."""
    x0, y0, x1, y1 = box if box is not None else (0, 0, width - 1, height - 1)
    if stride is None:
        stride = lines.shape[1] // planes
    pal16 = np.zeros(48, np.uint8) if header_palette is None else np.asarray(header_palette, np.uint8).ravel()
    head = (struct.pack("<BBBBHHHHHH", 10, version, 1, bits, x0, y0, x1, y1, 300, 300) + pal16.tobytes()
            + struct.pack("<BBHHHH", 0, planes, stride, 1, width, height)).ljust(128, b"\0")
    tail = b"" if tail_palette is None else b"\x0c" + np.asarray(tail_palette, np.uint8).tobytes()
    return head + (pcx_rle(lines) if body is None else body) + tail


def dcx_bytes(frames) -> bytes:
    """A DCX file: its magic, the offset of each PCX frame, a 0, the frames."""
    offset = 4 + 4 * (len(frames) + 1)
    table = b""
    for frame in frames:
        table += struct.pack("<I", offset)
        offset += len(frame)
    return struct.pack("<I", 0x3ADE68B1) + table + b"\0\0\0\0" + b"".join(frames)


def sgi_rle_rows(rows: np.ndarray, bpc: int):
    """SGI's RLE of (R, W) samples (one channel of one row each): per row
    its stream (copy chunks 0x80 | n, then n samples; run chunks n, then
    the sample; a 0 to end the row; each count and sample `bpc` bytes, big
    endian) and its length in bytes."""
    atoms = np.ascontiguousarray(rows, np.uint16 if bpc == 2 else np.uint8)
    R, W = atoms.shape
    flat = atoms.ravel()
    c_start, c_count, c_run = rle_chunks(atoms, 127, 127, min_run=3)
    row = c_start // W
    # a terminator after each row's last chunk
    term = np.full(R, R * W)
    starts = np.concatenate([c_start, term])
    rows_of = np.concatenate([row, np.arange(R)])
    order = np.lexsort((starts, rows_of))
    headers = np.concatenate([np.where(c_run, c_count, 0x80 | c_count), np.zeros(R, np.int64)])[order]
    payload = np.concatenate([np.where(c_run, 1, c_count), np.zeros(R, np.int64)])[order]
    copy = np.concatenate([~c_run, np.zeros(R, bool)])[order]
    stream = _emit(flat, headers, starts[order], payload, copy)
    lengths = np.bincount(rows_of[order], weights=1 + payload, minlength=R).astype(np.int64) * bpc
    data = stream.astype(">u2").tobytes() if bpc == 2 else stream.astype(np.uint8).tobytes()
    return data, lengths


def sgi_bytes(px: np.ndarray, bpc: int = 1, rle: bool = False, dimension: int = None, compression: int = None,
              name: bytes = b"view") -> bytes:
    """An SGI image of (H, W, C) samples (uint16 where `bpc` is 2), rows
    stored bottom-up: the 512-byte header, then each channel's plane
    (verbatim) or the offset and length tables and each row's RLE."""
    h, w, c = px.shape
    if dimension is None:
        dimension = 3 if c > 1 else 2
    comp = int(rle) if compression is None else compression
    head = (struct.pack(">hBBHHHHii4s80si", 474, comp, bpc, dimension, w, h, c, 0, (1 << 8 * bpc) - 1, b"",
                        name, 0)).ljust(512, b"\0")
    planes = np.ascontiguousarray(px[::-1].transpose(2, 0, 1))  # (C, H, W), the bottom row first
    if not rle:
        return head + (planes.astype(">u2").tobytes() if bpc == 2 else planes.astype(np.uint8).tobytes())
    data, lengths = sgi_rle_rows(planes.reshape(c * h, w), bpc)
    offsets = 512 + 8 * c * h + np.cumsum(lengths) - lengths
    return head + offsets.astype(">u4").tobytes() + lengths.astype(">u4").tobytes() + data


def packbits_rows(rows: np.ndarray):
    """PackBits of each of (R, n) byte rows on its own (PSD's): literal
    chunks (n - 1, then n bytes) and runs (257 - n, then the byte) of at
    most 128; the bytes and each row's length."""
    rows = np.ascontiguousarray(rows, np.uint8)
    R, W = rows.shape
    flat = rows.ravel()
    c_start, c_count, c_run = rle_chunks(rows, 128, 128, min_run=3)
    c_run = c_run & (c_count > 1)
    headers = np.where(c_run, 257 - c_count, c_count - 1)
    payload = np.where(c_run, 1, c_count)
    stream = _emit(flat, headers, c_start, payload, ~c_run)
    lengths = np.bincount(c_start // W, weights=1 + payload, minlength=R).astype(np.int64)
    return stream.astype(np.uint8).tobytes(), lengths


def psd_bytes(planes: np.ndarray, colour_mode: int, bits: int = 8, channels: int = None, compression: int = 0,
              colour_data: bytes = b"", resources: bytes = b"", layers: bytes = b"", width: int = None) -> bytes:
    """A PSD file of (C, H, row bytes) channel planes (1 bit: rows packed,
    most significant bit first): the header (`channels` defaults to C),
    the colour mode data, image resources and layer section as given, then
    the merged image, raw or PackBits (the byte counts of every row of
    every channel, then the rows)."""
    planes = np.ascontiguousarray(planes, np.uint8)
    c, h, row_bytes = planes.shape
    if width is None:
        width = row_bytes * 8 if bits == 1 else row_bytes
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, c if channels is None else channels, h, width, bits,
                                 colour_mode)
    out = (head + struct.pack(">I", len(colour_data)) + colour_data + struct.pack(">I", len(resources))
           + resources + struct.pack(">I", len(layers)) + layers + struct.pack(">H", compression))
    if compression != 1:
        return out + planes.tobytes()
    data, lengths = packbits_rows(planes.reshape(c * h, row_bytes))
    return out + lengths.astype(">u2").tobytes() + data


def psd_resource(ident: int, data: bytes, name: bytes = b"") -> bytes:
    """One image resource block: 8BIM, its id, its Pascal name padded to
    even, its data padded to even."""
    pname = bytes([len(name)]) + name
    pname += b"\0" * (len(pname) & 1)
    return b"8BIM" + struct.pack(">H", ident) + pname + struct.pack(">I", len(data)) + data + b"\0" * (len(data) & 1)


def icon_bytes(entries, kind: int = 1) -> bytes:
    """An ICO (`kind` 1) or CUR (2) file of (width, height, colours, bit
    count, image bytes) entries in that order, each image after the
    directory (a width or height of 256 stored as 0)."""
    offset = 6 + 16 * len(entries)
    head, body = struct.pack("<HHH", 0, kind, len(entries)), b""
    for w, h, colors, bpp, data in entries:
        head += struct.pack("<BBBBHHII", w % 256, h % 256, colors, 0, 1, bpp, len(data), offset)
        offset += len(data)
        body += data
    return head + body


def icon_dib(rows: bytes, width: int, height: int, bits: int, and_mask: np.ndarray = None, **kw) -> bytes:
    """An icon's bitmap: a DIB whose header states twice the height (the
    XOR bitmap's rows, then the AND mask's) and, unless None, the (H, W)
    AND mask after it (1 transparent), rows bottom-up padded to 32 bits."""
    dib = dib_bytes(rows, width, 2 * height, bits, **kw)
    if and_mask is None:
        return dib
    stride = (width + 31) // 32 * 4
    packed = np.zeros((height, stride), np.uint8)
    bits_ = np.packbits(np.asarray(and_mask, np.uint8), axis=1)
    packed[:, :bits_.shape[1]] = bits_
    return dib + packed[::-1].tobytes()


def png_bytes(px: np.ndarray) -> bytes:
    """An 8-bit PNG of (H, W, C) uint8 pixels, C = 1 to 4 (grey, grey +
    alpha, RGB, RGBA), every row with filter 0: an icon's PNG entry."""
    h, w, c = px.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)
    rows[:, 1:] = px.reshape(h, -1)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    head = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 2: 4, 3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head) + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


# ---- DDS ----

DDPF_ALPHAPIXELS, DDPF_FOURCC, DDPF_PALETTEINDEXED8, DDPF_RGB, DDPF_LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000


def dds_bytes(body: bytes, width: int, height: int, pf_flags: int, fourcc: bytes = b"\0\0\0\0", bitcount: int = 0,
              masks=(0, 0, 0, 0), dxgi: int = None, mipmaps: int = 0, array_size: int = 1, header_size: int = 124,
              caps: int = 0x1000) -> bytes:
    """A DDS file: "DDS ", the 124-byte header (its size field
    `header_size`), a DX10 header where `dxgi` is given (FourCC "DX10"),
    then `body`."""
    flags = 0x1 | 0x2 | 0x4 | 0x1000 | (0x20000 if mipmaps else 0)
    head = (b"DDS " + struct.pack("<7I", header_size, flags, height, width, 0, 0, mipmaps) + bytes(44)
            + struct.pack("<2I", 32, pf_flags) + (b"DX10" if dxgi is not None else fourcc)
            + struct.pack("<5I", bitcount, *masks) + struct.pack("<5I", caps, 0, 0, 0, 0))
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, array_size, 0)
    return head + body


def dds_masked(px: np.ndarray, bitcount: int, masks) -> bytes:
    """(H, W, C) uint8 pixels packed `bitcount // 8` bytes a pixel, little
    endian, channel i scaled to its mask's width and shifted into it."""
    h, w, _ = px.shape
    value = np.zeros((h, w), np.uint64)
    for i, mask in enumerate(masks):
        if mask:
            shift = (mask & -mask).bit_length() - 1
            total = mask >> shift
            q = (px[..., i].astype(np.uint64) * np.uint64(total) + np.uint64(127)) // np.uint64(255)
            value |= (q << np.uint64(shift)) & np.uint64(mask)
    step = bitcount // 8
    return value.astype("<u8").view(np.uint8).reshape(h, w, 8)[..., :step].tobytes()


def texel_blocks(px: np.ndarray) -> np.ndarray:
    """(blocks, 16, C) int64: the 4x4 blocks of (H, W, C) pixels in rows of
    blocks, the last row and column repeated to a multiple of 4."""
    h, w, c = px.shape
    a = np.pad(px, ((0, -h % 4), (0, -w % 4), (0, 0)), mode="edge").astype(np.int64)
    bh, bw = a.shape[0] // 4, a.shape[1] // 4
    return a.reshape(bh, 4, bw, 4, c).transpose(0, 2, 1, 3, 4).reshape(bh * bw, 16, c)


def untexel(blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    """(h, w, C) uint8 of (blocks, 16, C) values: `texel_blocks` undone,
    cropped."""
    bh, bw = -(-h // 4), -(-w // 4)
    c = blocks.shape[-1]
    a = blocks.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(4 * bh, 4 * bw, c)
    return np.ascontiguousarray(a[:h, :w]).astype(np.uint8)


def _nearest(values: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """(blocks, 16) the index of the palette entry (blocks, K, C) nearest
    each value (blocks, 16, C), squared distance, the first of ties."""
    small = max(int(np.abs(values).max(initial=0)), int(np.abs(palette).max(initial=0))) < 4096
    v, p = (values.astype(np.int32), palette.astype(np.int32)) if small else (values, palette)
    d = ((v[:, :, None, :] - p[:, None, :, :]) ** 2).sum(-1)
    return d.argmin(-1)


def _pick(palette: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """(blocks, 16, C): each pixel's palette entry."""
    return np.take_along_axis(palette, idx[..., None], 1)


def _pack_indices(idx: np.ndarray, bits: int) -> np.ndarray:
    """(blocks, 16 * bits // 8) uint8: per-pixel indices, pixel 0 in the
    lowest bits."""
    word = np.zeros(len(idx), np.uint64)
    for i in range(16):
        word |= idx[:, i].astype(np.uint64) << np.uint64(bits * i)
    return word.astype("<u8").view(np.uint8).reshape(-1, 8)[:, :2 * bits]


def _widen565(c: np.ndarray) -> np.ndarray:
    r, g, b = (c >> 11) << 3, ((c >> 5) & 63) << 2, (c & 31) << 3
    return np.stack([r | r >> 5, g | g >> 6, b | b >> 5], -1)


def _bc1(t: np.ndarray, always_four: bool):
    """BC1 colour blocks of texels `t` (blocks, 16, 3+) and the colours they
    decode to (blocks, 16, 3)."""
    hi, lo = t[..., :3].max(1), t[..., :3].min(1)
    c0 = (hi[:, 0] >> 3) << 11 | (hi[:, 1] >> 2) << 5 | hi[:, 2] >> 3
    c1 = (lo[:, 0] >> 3) << 11 | (lo[:, 1] >> 2) << 5 | lo[:, 2] >> 3
    e0, e1 = _widen565(c0), _widen565(c1)
    palette = np.stack([e0, e1, (2 * e0 + e1) // 3, (e0 + 2 * e1) // 3], 1)
    idx = _nearest(t[..., :3], palette)
    if not always_four:  # equal endpoints decode as three colours and transparent black: index 0 only
        idx[c0 == c1] = 0
    out = np.zeros((len(t), 8), np.uint8)
    out[:, 0:2] = c0.astype("<u2").view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = c1.astype("<u2").view(np.uint8).reshape(-1, 2)
    out[:, 4:8] = _pack_indices(idx, 2)[:, :4]
    return out, _pick(palette, idx)


def _bc4(t: np.ndarray, signed: bool):
    """BC4 blocks of values `t` (blocks, 16) and the values they decode to
    (blocks, 16, 1)."""
    a0, a1 = t.max(1), t.min(1)
    pal = np.stack([a0, a1] + [((7 - i) * a0 + i * a1) // 7 for i in range(1, 7)], 1)
    idx = _nearest(t[..., None], pal[..., None])
    idx[a0 == a1] = 0
    out = np.zeros((len(t), 8), np.uint8)
    shift = 128 if signed else 0
    out[:, 0], out[:, 1] = (a0 - shift) & 255, (a1 - shift) & 255
    out[:, 2:8] = _pack_indices(idx, 3)[:, :6]
    return out, _pick(pal[..., None], idx)


def _result(blocks, decoded, px, decoded_px):
    return (blocks, untexel(decoded_px, *px.shape[:2])) if decoded else blocks


def bc1_blocks(px: np.ndarray, decoded: bool = False):
    """(blocks, 8) uint8 BC1 blocks of (H, W, 3+) pixels: the block's
    per-channel maximum and minimum as 5:6:5 endpoints (the first above
    the second, or equal with every index 0), each pixel the nearest of the
    four colours. With `decoded`, also the (H, W, 4) pixels they decode to."""
    t = texel_blocks(px)
    blocks, rgb = _bc1(t, False)
    return _result(blocks, decoded, px, np.concatenate([rgb, np.full_like(rgb[..., :1], 255)], -1))


def bc4_blocks(values: np.ndarray, signed: bool = False, decoded: bool = False):
    """(blocks, 8) uint8 BC4 blocks of (H, W) or (H, W, 1) uint8 values:
    the block's maximum and minimum as endpoints (eight interpolated
    values; where they are equal every index 0), each pixel the nearest.
    `signed` (BC5S) writes each endpoint as int8, value - 128. With
    `decoded`, also the (H, W, 1) values they decode to."""
    v = values.reshape(values.shape[0], values.shape[1], 1)
    blocks, out = _bc4(texel_blocks(v)[..., 0], signed)
    return _result(blocks, decoded, v, out)


def bc2_blocks(px: np.ndarray, decoded: bool = False):
    """(blocks, 16) uint8 BC2 (DXT3): 4-bit alpha (the top bits), then a
    BC1 colour block (decoded as four colours) of (H, W, 4) pixels."""
    t = texel_blocks(px)
    a = t[..., 3] >> 4
    colour, rgb = _bc1(t, True)
    blocks = np.concatenate([(a[:, 0::2] | a[:, 1::2] << 4).astype(np.uint8), colour], 1)
    return _result(blocks, decoded, px, np.concatenate([rgb, a[..., None] * 17], -1))


def bc3_blocks(px: np.ndarray, decoded: bool = False):
    """(blocks, 16) uint8 BC3 (DXT5): a BC4 alpha block, then a BC1 colour
    block (decoded as four colours) of (H, W, 4) pixels."""
    t = texel_blocks(px)
    alpha, a = _bc4(t[..., 3], False)
    colour, rgb = _bc1(t, True)
    return _result(np.concatenate([alpha, colour], 1), decoded, px, np.concatenate([rgb, a], -1))


def bc5_blocks(px: np.ndarray, signed: bool = False, decoded: bool = False):
    """(blocks, 16) uint8 BC5: BC4 blocks of red and green (blue decodes
    as 0, or 128 where `signed`)."""
    t = texel_blocks(px)
    (r, dr), (g, dg) = _bc4(t[..., 0], signed), _bc4(t[..., 1], signed)
    return _result(np.concatenate([r, g], 1), decoded, px,
                   np.concatenate([dr, dg, np.full_like(dr, 128 if signed else 0)], -1))


def _bits_to_bytes(fields) -> np.ndarray:
    """(blocks, 16) uint8 from (values (blocks,) or (blocks, k), bits) in
    the block's order, least significant bit first."""
    cols = []
    for values, bits in fields:
        v = np.asarray(values, np.int64)
        v = v[:, None] if v.ndim == 1 else v
        for j in range(v.shape[1]):
            cols.append((v[:, j, None] >> np.arange(bits)) & 1)
    bitmap = np.concatenate(cols, 1).astype(np.uint8)
    assert bitmap.shape[1] == 128, bitmap.shape
    return np.packbits(bitmap, axis=1, bitorder="little")


def _index_fields(idx: np.ndarray, bits: int):
    """Pixel 0's index, one bit short (its top bit 0), then the others."""
    return [(idx[:, 0], bits - 1)] + [(idx[:, 1:], bits)]


WEIGHTS4 = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64])


def bc6h_blocks(half_bits: np.ndarray, signed: bool = False, decoded: bool = False):
    """(blocks, 16) uint8 BC6H mode 11 (one region, 10-bit endpoints,
    4-bit indices) of (H, W, 3) non-negative half floats (their uint16
    bits): each value's 10-bit code (the half's bits / 31 for UF16, / 62
    for SF16, where the decoder multiplies back), the block's minimum and
    maximum code as endpoints, each pixel the nearest of the 16 weights in
    unquantised space, swapped so that pixel 0's index fits its 3 bits.
    With `decoded`, also the (H, W, 3) uint8 they decode to: the weighted
    sum, (v * 31) / 64 (UF16) or / 32 (SF16) as a half, clamped to [0, 1]
    and truncated to 8 bits."""
    top = 510 if signed else 1022
    q = np.clip(np.rint(half_bits.astype(np.float64) / (62 if signed else 31)), 0, top).astype(np.int64)
    t = texel_blocks(q)
    e0, e1 = t.min(1), t.max(1)

    def unq(v):
        return np.where(v == 0, 0, ((v << 15) + 0x4000) >> 9)

    w0, w1 = (64 - WEIGHTS4)[None, :, None], WEIGHTS4[None, :, None]
    pal = (unq(e0)[:, None, :] * w0 + unq(e1)[:, None, :] * w1) >> 6
    idx = _nearest(unq(t), pal)
    swap = idx[:, 0] >= 8
    e0[swap], e1[swap] = e1[swap].copy(), e0[swap].copy()
    idx[swap] = 15 - idx[swap]
    fields = [(np.full(len(t), 0b00011), 5)] + [(e[:, c], 10) for e in (e0, e1) for c in range(3)]
    blocks = _bits_to_bytes(fields + _index_fields(idx, 4))
    v = _pick(pal, np.where(swap[:, None], 15 - idx, idx))
    half = ((v * 31) >> (5 if signed else 6)).astype(np.uint16).view(np.float16).astype(np.float32)
    out = np.where(half > 1, 255, (np.clip(half, 0, 1) * np.float32(255)).astype(np.int64))
    return _result(blocks, decoded, half_bits, out)


def bc7_blocks(px: np.ndarray, decoded: bool = False):
    """(blocks, 16) uint8 BC7 mode 6 (RGBA 7-bit endpoints with a p-bit
    each, 4-bit indices) of (H, W, 4) pixels: the block's per-channel
    minimum and maximum as endpoints, their p-bits the low bits of the
    block's minimum and maximum alpha, each pixel the nearest of the 16
    weights, swapped so that pixel 0's index fits its 3 bits. With
    `decoded`, also the (H, W, 4) pixels they decode to."""
    t = texel_blocks(px)
    p0, p1 = t[..., 3].min(1) & 1, t[..., 3].max(1) & 1  # alpha's low bits: a constant alpha kept exactly
    lo, hi = t.min(1) >> 1, t.max(1) >> 1
    d0, d1 = lo << 1 | p0[:, None], hi << 1 | p1[:, None]
    pal = ((64 - WEIGHTS4)[None, :, None] * d0[:, None, :] + WEIGHTS4[None, :, None] * d1[:, None, :] + 32) >> 6
    idx = _nearest(t, pal)
    decoded_px = _pick(pal, idx)
    swap = idx[:, 0] >= 8
    lo[swap], hi[swap] = hi[swap].copy(), lo[swap].copy()
    p0[swap], p1[swap] = p1[swap].copy(), p0[swap].copy()
    idx[swap] = 15 - idx[swap]
    fields = [(np.full(len(t), 1 << 6), 7)] + [(e[:, c], 7) for c in range(4) for e in (lo, hi)]
    return _result(_bits_to_bytes(fields + [(p0, 1), (p1, 1)] + _index_fields(idx, 4)), decoded, px, decoded_px)



# ---- lossless JPEG ----

def _optimal_huffman(freq):
    """libjpeg's jpeg_gen_optimal_table (JPEG Annex K.2): (counts of code
    lengths 1..16, symbols in code order) for the frequencies `freq` of
    symbols 0..len(freq) - 1, one code point kept free (no all-ones code)."""
    freq = [int(f) for f in freq] + [0] * (256 - len(freq)) + [1]
    codesize, others = [0] * 257, [-1] * 257
    while True:
        c1 = c2 = -1
        for i in range(257):  # the least frequency, the highest symbol of a tie
            if freq[i] and (c1 < 0 or freq[i] <= freq[c1]):
                c1 = i
        for i in range(257):
            if freq[i] and i != c1 and (c2 < 0 or freq[i] <= freq[c2]):
                c2 = i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        for c in (c1, c2):
            codesize[c] += 1
            while others[c] >= 0:
                c = others[c]
                codesize[c] += 1
        tail = c1
        while others[tail] >= 0:
            tail = others[tail]
        others[tail] = c2
    bits = [0] * 33
    for i in range(257):
        if codesize[i]:
            bits[codesize[i]] += 1
    for i in range(32, 16, -1):  # lengths over 16 moved up the tree
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the reserved symbol's code
    order = sorted((c, j) for j, c in enumerate(codesize[:256]) if c)
    return bits[1:17], [j for _, j in order]


def _canonical(counts, symbols):
    """Code and length of each symbol (arrays over 0..255) of a JPEG table."""
    code, length = np.zeros(256, np.int64), np.zeros(256, np.int64)
    c, p = 0, 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            code[symbols[p]], length[symbols[p]] = c, n
            c, p = c + 1, p + 1
        c <<= 1
    return code, length


def pack_msb(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Each value's `length` low bits (every length <= 32), most significant
    first, as bytes: the last byte padded with ones, each 0xFF followed by a
    stuffed 0x00 (JPEG's entropy-coded data)."""
    values, lengths = np.asarray(values, np.uint64), np.asarray(lengths, np.int64)
    ends = np.cumsum(lengths)
    starts = ends - lengths
    nbits = int(ends[-1]) if len(ends) else 0
    word, off = starts // 32, starts % 32
    window = values << (64 - off - lengths).astype(np.uint64)
    hi = (window >> np.uint64(32)).astype(np.float64)
    lo = (window & np.uint64(0xFFFFFFFF)).astype(np.float64)
    n_words = nbits // 32 + 2
    words = (np.bincount(word, hi, n_words) + np.bincount(word + 1, lo, n_words)).astype(np.uint64)
    data = bytearray(words.astype(">u4").tobytes()[:(nbits + 7) // 8])
    if nbits % 8:
        data[-1] |= (1 << (8 - nbits % 8)) - 1
    return bytes(data).replace(b"\xff", b"\xff\x00")


def _lossless_differences(x: np.ndarray, psv: int, pt: int, first_rows) -> np.ndarray:
    """The differences (int64) of samples `x` (already shifted right by
    `pt`) from their predictions (T.81 H.1.2.1): Ra, Rb, Rc as predictor
    `psv` combines them; each row's first sample from Rb; the rows in
    `first_rows` (the first of the scan and of each restart interval) from
    2^(7 - pt), then Ra."""
    x = x.astype(np.int64)
    ra, rb, rc = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    ra[:, 1:], rb[1:, :], rc[1:, 1:] = x[:, :-1], x[:-1, :], x[:-1, :-1]
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
            7: (ra + rb) >> 1}[psv].copy()
    pred[:, 0] = rb[:, 0]
    for r in first_rows:
        pred[r, 0] = 1 << (7 - pt)
        pred[r, 1:] = x[r, :-1]
    return x - pred


def lossless_jpeg(pixels, sampling=None, psv=1, pt=0, restart_rows=0, one_component_scans=False, psvs=None,
                  marker="adobe", ids=None) -> bytes:
    """Lossless JPEG (SOF3) bytes of (H, W, C) or (H, W) uint8 `pixels`,
    the channels as components, each coded with its own Huffman table (up
    to 4). `sampling`: each component's (h, v) (default 1x1); a subsampled
    component is the block means of its channel (rounded half up, the
    image's edge repeated). `psv` / `pt`: the predictor and point
    transform; `psvs`: each scan's predictor. `restart_rows`: MCU rows per
    restart interval (0: none); with `one_component_scans`, each scan has
    its own DRI, and a component sampled v rows high restarts where
    libjpeg-turbo's decoder does, at the first row of the v that hold the
    restart. `marker`: "adobe" (transform 0), "adobe1" (transform 1),
    "jfif" or None; `ids`: the component ids (default 1, 2, ...)."""
    a = np.asarray(pixels)
    a = a[..., None] if a.ndim == 2 else a
    H, W, C = a.shape
    sampling = sampling or [(1, 1)] * C
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    ids = ids or list(range(1, C + 1))
    mcux, mcuy = -(-W // hmax), -(-H // vmax)
    planes = []
    for i, (h, v) in enumerate(sampling):
        fx, fy = hmax // h, vmax // v
        bw, bh = -(-W * h // hmax), -(-H * v // vmax)
        p = np.pad(a[..., i].astype(np.int64), ((0, bh * fy - H), (0, bw * fx - W)), mode="edge")
        planes.append((p.reshape(bh, fy, bw, fx).sum(axis=(1, 3)) * 2 + fx * fy) // (2 * fx * fy))
    scans = [[i] for i in range(C)] if one_component_scans else [list(range(C))]
    psvs = psvs or [psv] * len(scans)

    diffs = []
    for i, p in enumerate(planes):
        scan = next(k for k, sc in enumerate(scans) if i in sc)
        v = sampling[i][1]
        rows = restart_rows * (v if len(scans[scan]) > 1 else 1)
        first = sorted({0} | ({(r // v) * v for r in range(rows, p.shape[0], rows)} if rows else set()))
        diffs.append(_lossless_differences(p.astype(np.int64) >> pt, psvs[scan], pt, first))

    def category(d):
        s = np.zeros(d.shape, np.int64)
        for k in range(1, 17):
            s[np.abs(d) >= (1 << (k - 1))] = k
        return s

    tables = []
    for i, d in enumerate(diffs):
        counts, symbols = _optimal_huffman(np.bincount(category(d).ravel(), minlength=17))
        tables.append((counts, symbols, _canonical(counts, symbols)))

    def segment(code, body):
        return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body

    out = b"\xff\xd8"
    if marker == "jfif":
        out += segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    elif marker in ("adobe", "adobe1"):
        out += segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 1 if marker == "adobe1" else 0))
    out += segment(0xC3, struct.pack(">BHHB", 8, H, W, C) + b"".join(
        bytes([ids[i], h << 4 | v, 0]) for i, (h, v) in enumerate(sampling)))
    out += segment(0xC4, b"".join(bytes([i]) + bytes(t[0]) + bytes(t[1]) for i, t in enumerate(tables)))
    for k, sc in enumerate(scans):
        if len(sc) > 1:  # MCUs of h x v samples of each component, in order
            per_row = mcux
            parts, comp = [], []
            for i in sc:
                h, v = sampling[i]
                d = np.pad(diffs[i], ((0, mcuy * v - diffs[i].shape[0]), (0, mcux * h - diffs[i].shape[1])))
                parts.append(d.reshape(mcuy, v, mcux, h).transpose(0, 2, 1, 3).reshape(mcuy, mcux, v * h))
                comp += [i] * (v * h)
            stream = np.concatenate(parts, axis=2).reshape(mcuy, -1)
            comp = np.tile(np.array(comp), mcux)
        else:
            per_row = diffs[sc[0]].shape[1]
            stream, comp = diffs[sc[0]], np.full(per_row, sc[0])
        cats = category(stream)
        codes = np.zeros(stream.shape, np.int64)
        lens = np.zeros(stream.shape, np.int64)
        for i in sc:
            sel = np.broadcast_to(comp == i, stream.shape)
            code, length = tables[i][2]
            codes[sel], lens[sel] = code[cats[sel]], length[cats[sel]]
        extra = np.where(stream > 0, stream, stream + (1 << cats) - 1)
        extra = np.where(cats == 16, 0, extra)
        values = (codes << np.where(cats == 16, 0, cats)) | extra
        lengths = lens + np.where(cats == 16, 0, cats)
        step = restart_rows or stream.shape[0]
        pieces = [pack_msb(values[r:r + step].ravel(), lengths[r:r + step].ravel())
                  for r in range(0, stream.shape[0], step)]
        if restart_rows:
            out += segment(0xDD, struct.pack(">H", restart_rows * per_row))
        out += segment(0xDA, bytes([len(sc)]) + b"".join(bytes([ids[i], i << 4]) for i in sc)
                       + bytes([psvs[k], 0, pt]))
        out += b"".join(piece + (bytes([0xFF, 0xD0 + n % 8]) if n < len(pieces) - 1 else b"")
                        for n, piece in enumerate(pieces))
    return out + b"\xff\xd9"


# ---- BLP, FTEX, GBR, FITS, FLI / FLC, ICNS, EPS and the stubs ----

def blp1_bytes(width: int, height: int, compression: int = 1, alpha: int = 0, encoding: int = 5, subtype: int = 0,
               palette=None, indices: bytes = b"", jpeg: bytes = b"", header_size: int = None, offsets=None,
               lengths=None) -> bytes:
    """A BLP1 file: "BLP1", compression (0 JPEG, 1 palette), the alpha
    field, the size, encoding, subtype, 16 mipmap offsets and lengths,
    then for a palette file 256 BGRA entries (`palette` (N, 4) in B, G, R,
    A order, zero-padded to 256) and the indices, for a JPEG file the
    shared header's length and its first `header_size` bytes of `jpeg`
    (default: up to its first SOS segment's end), mipmap 0 the rest.
    `offsets` / `lengths` override mipmap 0's (and the others')."""
    head = b"BLP1" + struct.pack("<iIIIii", compression, alpha, width, height, encoding, subtype)
    if compression == 0:
        if header_size is None:
            sos = jpeg.index(b"\xff\xda")
            header_size = sos + 2 + int.from_bytes(jpeg[sos + 2:sos + 4], "big")
        shared, body = jpeg[:header_size], jpeg[header_size:]
        start = len(head) + 128 + 4 + len(shared)
        tail = struct.pack("<I", len(shared)) + shared + body
    else:
        pal = np.zeros((256, 4), np.uint8) if palette is None else np.asarray(palette, np.uint8)
        pal = np.pad(pal, ((0, 256 - len(pal)), (0, 0)))
        start, body = len(head) + 128 + 1024, indices
        tail = pal.tobytes() + indices
    offs = list(offsets) if offsets is not None else [start] + [0] * 15
    lens = list(lengths) if lengths is not None else [len(body)] + [0] * 15
    return head + struct.pack("<16I16I", *offs, *lens) + tail


def blp2_bytes(width: int, height: int, body: bytes, compression: int = 1, encoding: int = 1, alpha_depth: int = 0,
               alpha_encoding: int = 0, palette=None, offsets=None, lengths=None, mips: int = 0) -> bytes:
    """A BLP2 file: "BLP2", the compression field (1: palette or DXT),
    encoding (1 palette, 2 DXT, 3 raw BGRA), alpha depth, alpha encoding
    (0 DXT1, 1 DXT3, 7 DXT5), the mipmap flag, the size, 16 mipmap
    offsets and lengths, 256 BGRA palette entries, then mipmap 0 `body`."""
    head = b"BLP2" + struct.pack("<i4bII", compression, encoding, alpha_depth, alpha_encoding, mips, width, height)
    pal = np.zeros((256, 4), np.uint8) if palette is None else np.asarray(palette, np.uint8)
    pal = np.pad(pal, ((0, 256 - len(pal)), (0, 0)))
    start = len(head) + 128 + 1024
    offs = list(offsets) if offsets is not None else [start] + [0] * 15
    lens = list(lengths) if lengths is not None else [len(body)] + [0] * 15
    return head + struct.pack("<16I16I", *offs, *lens) + pal.tobytes() + body


def ftex_bytes(width: int, height: int, body: bytes, fmt: int = 1, mipmaps: int = 1, format_count: int = 1,
               where: int = None, mipmap_size: int = None, version: int = 1) -> bytes:
    """An FTEX file (.ftc / .ftu): "FTEX", version, size, mipmap and
    format counts, one format entry (0 DXT1, 1 raw RGB) pointing at
    `where` (default: right after it), there mipmap 0's size and `body`."""
    where = 32 if where is None else where
    head = b"FTEX" + struct.pack("<7i", version, width, height, mipmaps, format_count, fmt, where)
    head = head.ljust(where, b"\0")
    return head + struct.pack("<i", len(body) if mipmap_size is None else mipmap_size) + body


def gbr_bytes(px: np.ndarray, version: int = 2, comment: bytes = b"brush\0", spacing: int = 10,
              header_size: int = None, magic: bytes = b"GIMP") -> bytes:
    """A GIMP brush: big-endian header size, version (1 or 2), width,
    height and colour depth (1 grey, 4 RGBA), for version 2 "GIMP" and the
    spacing, the comment, then the (H, W, 1 or 4) uint8 pixels raw."""
    h, w, c = px.shape
    fixed = 20 if version == 1 else 28
    size = fixed + len(comment) if header_size is None else header_size
    head = struct.pack(">5I", size, version, w, h, c)
    if version != 1:
        head += magic + struct.pack(">I", spacing)
    return head + comment + np.ascontiguousarray(px).tobytes()


def fits_card(key: str, value: str = None) -> bytes:
    """One 80-byte FITS header card: the keyword, and "= " and the value
    right-aligned in column 30 (strings as given, quoted)."""
    card = key.ljust(8)
    if value is not None:
        card += "= " + value.rjust(20)
    return card.ljust(80).encode()


def fits_unit(cards, data: bytes = b"", pad: bool = True) -> bytes:
    """A header unit of `cards` ((key, value) pairs) and END, padded to
    2880 bytes, then `data` padded to 2880 (with `pad`)."""
    head = b"".join(fits_card(k, v) for k, v in cards) + fits_card("END")
    head = head.ljust(-(-len(head) // 2880) * 2880, b" ")
    return head + (data.ljust(-(-len(data) // 2880) * 2880, b"\0") if pad else data)


FITS_DTYPES = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}


def fits_bytes(samples: np.ndarray, bitpix: int, cards=(), empty_primary: bool = False, pad: bool = True) -> bytes:
    """A FITS file of (H, W) `samples` at BITPIX `bitpix` (8, 16, 32, -32,
    -64), big-endian, rows bottom-up as FITS stores them (the first row
    of `samples` last); `empty_primary`: the image in an IMAGE extension
    after a primary HDU of NAXIS 0. `cards`: more (key, value) cards."""
    h, w = samples.shape
    data = np.ascontiguousarray(samples[::-1]).astype(FITS_DTYPES[bitpix]).tobytes()
    axes = [("BITPIX", str(bitpix)), ("NAXIS", "2"), ("NAXIS1", str(w)), ("NAXIS2", str(h))]
    if not empty_primary:
        return fits_unit([("SIMPLE", "T")] + axes + list(cards), data, pad)
    primary = fits_unit([("SIMPLE", "T"), ("BITPIX", "8"), ("NAXIS", "0")])
    return primary + fits_unit([("XTENSION", "'IMAGE   '")] + axes + [("PCOUNT", "0"), ("GCOUNT", "1")]
                               + list(cards), data, pad)


def fits_gzip_bytes(samples: np.ndarray, zbitpix: int = 8, members: int = 1, pad: bool = False, cards=()) -> bytes:
    """A tile-compressed FITS (a BINTABLE extension with ZIMAGE = T and
    ZCMPTYPE 'GZIP_1  ') of (H, W) integer `samples`: a primary HDU of
    NAXIS 0, then the table (one 8-byte descriptor a row), the heap after
    it the samples as 4-byte big-endian words, bottom row first, gzipped
    in `members` gzip members (one a tile of rows). `pad`: the heap padded
    to 2880 bytes as FITS pads a data unit (PIL's gzip read then fails)."""
    import gzip

    h, w = samples.shape
    words = np.ascontiguousarray(samples[::-1]).astype(">u4").tobytes()
    step = -(-h // members) * w * 4
    heap = b"".join(gzip.compress(words[i:i + step], mtime=0) for i in range(0, len(words), step))
    table = struct.pack(">II", len(heap), 0)
    cards_ = [("XTENSION", "'BINTABLE'"), ("BITPIX", "8"), ("NAXIS", "2"), ("NAXIS1", "8"), ("NAXIS2", "1"),
              ("PCOUNT", str(len(heap))), ("GCOUNT", "1"), ("TFIELDS", "1"), ("TFORM1", "'1PB     '"),
              ("ZIMAGE", "T"), ("ZBITPIX", str(zbitpix)), ("ZNAXIS", "2"), ("ZNAXIS1", str(w)),
              ("ZNAXIS2", str(h)), ("ZCMPTYPE", "'GZIP_1  '")] + list(cards)
    return fits_unit([("SIMPLE", "T"), ("BITPIX", "8"), ("NAXIS", "0")]) + fits_unit(cards_, table + heap, pad)


def fli_chunk(kind: int, body: bytes) -> bytes:
    """An FLI subchunk: size (6 + body, padded to even), type, body."""
    body += b"\0" * (len(body) % 2)
    return struct.pack("<IH", 6 + len(body), kind) + body


def fli_frame(chunks, kind: int = 0xF1FA) -> bytes:
    """An FLI frame chunk (0xF1FA) of its subchunks."""
    body = b"".join(chunks)
    return struct.pack("<IHH8x", 16 + len(body), kind, len(chunks)) + body


def fli_bytes(width: int, height: int, frames, magic: int = 0xAF12, flags: int = 3, speed: int = 70,
              prefix: bytes = None, header=None) -> bytes:
    """An FLI (magic 0xAF11) or FLC (0xAF12) file: the 128-byte header
    (`header`: {offset: bytes} written over it), a 0xF100 prefix chunk
    where `prefix` is given, then the frame chunks."""
    body = (struct.pack("<IH", 6 + len(prefix), 0xF100) + prefix if prefix is not None else b"") + b"".join(frames)
    head = bytearray(struct.pack("<IHHHHHHI", 128 + len(body), magic, len(frames), width, height, 8, flags, speed)
                     .ljust(128, b"\0"))
    head[80:84] = struct.pack("<I", 128)
    for at, b in (header or {}).items():
        head[at:at + len(b)] = b
    return bytes(head) + body


def fli_palette(palette: np.ndarray, kind: int = 4, start: int = 0) -> bytes:
    """A COLOR_256 (4) or COLOR_64 (11) subchunk of one packet setting
    entries from `start`: (N, 3) uint8 (N 256 written as count 0)."""
    n = len(palette)
    return fli_chunk(kind, struct.pack("<HBB", 1, start, n % 256) + np.asarray(palette, np.uint8).tobytes())


def fli_brun(indices: np.ndarray) -> bytes:
    """A BRUN (15) subchunk of (H, W) uint8 indices: per row a packet
    count byte, then runs (a positive count, one byte) of 3 or more equal
    bytes and literals (a negative count) of the rest, at most 127 a
    packet (vectorised)."""
    rows = np.ascontiguousarray(indices, np.uint8)
    h, w = rows.shape
    flat = rows.ravel()
    c_start, c_count, is_run = rle_chunks(rows, 127, 127, min_run=3)
    headers = np.where(is_run, c_count, 256 - c_count).astype(np.uint8)
    stream = _emit(flat, headers, c_start, np.where(is_run, 1, c_count), ~is_run)
    row = c_start // w
    first = np.ones(len(row), bool)
    first[1:] = row[1:] != row[:-1]
    at = (np.cumsum(1 + np.where(is_run, 1, c_count)) - (1 + np.where(is_run, 1, c_count)))[first]
    counts = (np.bincount(row, minlength=h) & 255).astype(np.uint8)
    return fli_chunk(15, np.insert(stream, at, counts).tobytes())


def fli_lc(first: int, lines) -> bytes:
    """An LC (12) subchunk: the first line, the line count, then per line
    its packets, each (skip, literal bytes) or (skip, (count, value)) for
    a run."""
    out = struct.pack("<HH", first, len(lines))
    for packets in lines:
        out += bytes([len(packets)])
        for skip, p in packets:
            out += bytes([skip]) + (bytes([256 - p[0], p[1]]) if isinstance(p, tuple) else bytes([len(p)]) + p)
    return fli_chunk(12, out)


def fli_ss2(lines) -> bytes:
    """An SS2 (7) subchunk: per line its flag words (0xC000 | skip lines
    as 65536 - n, or 0x8000 | the last byte), then its packets, each
    (skip, literal words as bytes) or (skip, (count, 2 bytes)) for a run."""
    out = struct.pack("<H", len(lines))
    for flags, packets in lines:
        for f in flags:
            out += struct.pack("<H", f)
        out += struct.pack("<H", len(packets))
        for skip, p in packets:
            out += bytes([skip]) + (bytes([256 - p[0]]) + p[1] if isinstance(p, tuple) else bytes([len(p) // 2]) + p)
    return fli_chunk(7, out)


def icns_rle(band: np.ndarray) -> bytes:
    """One band of an icns 32-bit icon in Apple's RLE: runs of 3 to 130
    equal bytes as (count + 125, byte), literals of 1 to 128 bytes as
    (count - 1, bytes) (vectorised)."""
    b = np.ascontiguousarray(band, np.uint8).reshape(1, -1)
    c_start, c_count, is_run = rle_chunks(b, 130, 128, min_run=3)
    headers = np.where(is_run, c_count + 125, c_count - 1).astype(np.uint8)
    return _emit(b.ravel(), headers, c_start, np.where(is_run, 1, c_count), ~is_run).tobytes()


def icns_bytes(entries, size: int = None) -> bytes:
    """An icns file: "icns", the file size (or `size`), then each (type,
    body) block with its 8-byte header."""
    body = b"".join(struct.pack(">4sI", kind, 8 + len(data)) + data for kind, data in entries)
    return b"icns" + struct.pack(">I", 8 + len(body) if size is None else size) + body


def icns_rgb(px: np.ndarray, rle: bool = True, it32: bool = False) -> bytes:
    """An it32 / ih32 / il32 / is32 body of (H, W, 3) uint8: each band in
    Apple's RLE (or the pixels raw, interleaved), it32's four zero bytes
    first."""
    if rle:
        body = b"".join(icns_rle(px[..., k]) for k in range(3))
    else:
        body = np.ascontiguousarray(px[..., :3]).tobytes()
    return (b"\0\0\0\0" if it32 else b"") + body


def eps_bytes(bbox=(0, 0, 64, 48), lines=(), adobe: bytes = b"%!PS-Adobe-3.0 EPSF-3.0",
              dos: bool = False, body: bytes = b"0 0 moveto 10 10 lineto stroke\nshowpage\n") -> bytes:
    """An EPS file: the "%!PS-Adobe" line, a %%BoundingBox, `lines` of more
    header comments (bytes), %%EndComments, then `body`; `dos` puts it in
    a DOS EPS binary header (0xC6D3D0C5, the PostScript's offset and
    length, no preview)."""
    text = b"\n".join([adobe] + ([b"%%%%BoundingBox: %d %d %d %d" % tuple(bbox)] if bbox else [])
                      + list(lines) + [b"%%EndComments", body])
    if not dos:
        return text
    return struct.pack("<IIIIIIIH", 0xC6D3D0C5, 30, len(text), 0, 0, 0, 0, 0xFFFF) + text
