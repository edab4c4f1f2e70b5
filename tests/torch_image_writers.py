"""Writers of the BMP and TIFF forms PIL reads but does not write, for the
tests of `utils/bmp.py` and `utils/tiff.py` and for
`tests/fixtures/torch_images/make_fixtures.py`. Imports neither JAX nor the
port: each file is built from the formats' specifications, and PIL's read
of it is the rule the port is held to.

- `tiff_bytes`: classic TIFF in either byte order, strips or tiles,
  compression none / PackBits / LZW (libtiff's new style, its encoder's
  code-width and table-full rules) / deflate, Predictor 2, any
  photometric, ExtraSamples, ColorMap, Orientation and raw extra tags.
- `bmp_bytes`: every header size, bit count and row order, palettes of
  any length, BI_BITFIELDS masks in or after the header, and RLE8 / RLE4
  bitmaps from `rle_encode`, which uses every escape.
"""

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


def sample_bytes(samples: np.ndarray, depth: int, order: str) -> np.ndarray:
    """(rows, row bytes) of (rows, width, spp) samples at `depth` bits."""
    rows = len(samples)
    if depth == 1:
        return np.packbits(samples[..., 0].astype(np.uint8), axis=1)
    dt = order + ("u2" if depth == 16 else "u1")
    return np.ascontiguousarray(samples.astype(dt)).view(np.uint8).reshape(rows, -1)


COMPRESS = {1: lambda b: b, 5: lzw_encode, 8: lambda b: zlib.compress(b, 6), 32946: lambda b: zlib.compress(b, 1),
            32773: packbits_encode}


def tiff_bytes(samples, depth, photometric, order="<", compression=1, predictor=None, rows_per_strip=None,
               tile=None, extra=None, colormap=None, orientation=None, tags=None) -> bytes:
    """A classic TIFF of (H, W, spp) integer `samples` at `depth` bits.
    `tile` = (width, height) writes tiles (zero-padded where they
    overhang), else strips of `rows_per_strip` rows; `tags` adds or
    replaces raw tags {tag: (type, values)} (3 SHORT, 4 LONG)."""
    samples = np.asarray(samples)
    H, W, n = samples.shape
    if tile:
        tw, th = tile
        across, down = -(-W // tw), -(-H // th)
        padded = np.zeros((down * th, across * tw, n), samples.dtype)
        padded[:H, :W] = samples
        chunks = [padded[r * th:(r + 1) * th, c * tw:(c + 1) * tw] for r in range(down) for c in range(across)]
    else:
        rps = rows_per_strip or H
        chunks = [samples[y:y + rps] for y in range(0, H, rps)]
    if predictor == 2:
        chunks = [difference(ch.astype(np.uint16 if depth == 16 else np.uint8)) for ch in chunks]
    bodies = [COMPRESS[compression](sample_bytes(ch, depth, order).tobytes()) for ch in chunks]
    t = {256: (4, [W]), 257: (4, [H]), 258: (3, [depth] * n), 259: (3, [compression]), 262: (3, [photometric]),
         277: (3, [n])}
    if tile:
        t.update({322: (3, [tile[0]]), 323: (3, [tile[1]]), 324: (4, [0] * len(bodies)),
                  325: (4, [len(b) for b in bodies])})
    else:
        t.update({273: (4, [0] * len(bodies)), 278: (3, [rows_per_strip or H]),
                  279: (4, [len(b) for b in bodies])})
    if predictor:
        t[317] = (3, [predictor])
    if extra is not None:
        t[338] = (3, list(extra))
    if colormap is not None:
        t[320] = (3, list(colormap))
    if orientation:
        t[274] = (3, [orientation])
    t.update(tags or {})
    offsets_tag = 324 if tile else 273
    # the header, the IFD, the tags' own data, then the strips or tiles
    ifd_at, n_tags = 8, len(t)
    data_at = ifd_at + 2 + 12 * n_tags + 4
    blobs, entries = b"", []
    packed = {}
    for tag in sorted(t):
        typ, vals = t[tag]
        packed[tag] = struct.pack(order + ("H" if typ == 3 else "I") * len(vals), *vals)
    strips_at = data_at + sum(len(v) + len(v) % 2 for v in packed.values() if len(v) > 4)
    offsets, at = [], strips_at
    for b in bodies:
        offsets.append(at)
        at += len(b)
    packed[offsets_tag] = struct.pack(order + "I" * len(offsets), *offsets)
    for tag in sorted(t):
        typ, vals = t[tag]
        raw = packed[tag]
        if len(raw) <= 4:
            entries.append(struct.pack(order + "HHI", tag, typ, len(vals)) + raw.ljust(4, b"\0"))
        else:
            entries.append(struct.pack(order + "HHII", tag, typ, len(vals), data_at + len(blobs)))
            blobs += raw + b"\0" * (len(raw) % 2)
    head = (b"II*\0" if order == "<" else b"MM\0*") + struct.pack(order + "I", ifd_at)
    return (head + struct.pack(order + "H", n_tags) + b"".join(entries) + struct.pack(order + "I", 0) + blobs
            + b"".join(bodies))


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
