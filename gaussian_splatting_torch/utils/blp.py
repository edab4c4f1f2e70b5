"""BLP reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the Blizzard texture files PIL 12's BlpImagePlugin reads,
returning an `image_io.Picture` of mipmap 0 in mode "RGBA" where the
header's alpha field is not 0, else "RGB":

- BLP1, compression 0: a JPEG, the shared header and mipmap 0's bytes
  joined, decoded by the compiled JPEG decoder (`utils/jpeg.py`) as PIL's
  JpegImageFile reads it with libjpeg's colour space set to CMYK (a
  4-component frame's samples as stored, YCCK too, then inverted as PIL's
  "CMYK;I"), converted to RGB (`image_io.to_rgba`'s rules) and laid into
  the image as raw "BGR": red and blue swapped, alpha 255, the JPEG's
  pixels taken as one stream at the BLP's width.
- BLP1, compression 1 and encoding 4 or 5, and BLP2 encoding 1: 256 BGRA
  palette entries, then mipmap 0's bytes, every one an index (BLP1 reads
  them right after the palette, BLP2 from mipmap 0's offset); each index
  gives its entry's R, G, B, and its A where the image has alpha.
- BLP2 encoding 2: DXT1, DXT3 or DXT5 blocks by PIL's own Python decoders,
  which differ from its bcn decoder (`blp_dxt_decode`): the stream of
  whole 4x4 blocks is laid out at the image's width, so a width that is
  not a multiple of 4 shears the rows as it does in PIL, and DXT3 / DXT5
  without alpha read their RGBA bytes as RGB.

Every byte stream is set into the image as PIL's raw decoder sets it: the
first width x height pixels, at the image's width; a shorter one raises.
A header cut short or a size of 0 raises `image_io.NotThisFormat` (PIL
passes the file on); the compressions and encodings PIL does not read
(PIL: BLPFormatError, a NotImplementedError), the tables, palette, JPEG
or blocks cut short (PIL: Truncated File Read), a JPEG PIL fails on and
an image over PIL's decompression-bomb limit raise a `ValueError` naming
the file.
"""

from __future__ import annotations

import struct

import numpy as np

from gaussian_splatting_torch.utils import dds, jpeg
from gaussian_splatting_torch.utils.bmp import MAX_PIXELS

SIGNATURES = (b"BLP1", b"BLP2")
DXT = {0: 1, 1: 3, 7: 5}  # BLP2's alpha encoding -> DXT1, DXT3, DXT5
TRUNCATED = "(PIL: Truncated File Read)"


def accepts(head: bytes) -> bool:
    return head.startswith(SIGNATURES)


def _refuse(name, what: str):
    raise ValueError(f"{name}: {what}; the port reads the BLP files PIL reads (BlpImagePlugin)")


def decode_blp(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of BLP bytes: PIL's mipmap 0."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    blp1 = data.startswith(b"BLP1")
    try:
        compression = struct.unpack_from("<i", data, 4)[0]
        if blp1:
            alpha = struct.unpack_from("<I", data, 8)[0] != 0
            width, height, encoding = struct.unpack_from("<IIi", data, 12)
            alpha_encoding, offset = None, 28
        else:
            encoding, alpha, alpha_encoding = struct.unpack_from("<3b", data, 8)
            alpha = alpha != 0
            width, height = struct.unpack_from("<II", data, 12)
            offset = 20
    except struct.error:
        raise NotThisFormat(f"{name}: a BLP header cut short (PIL: struct.error, passed on)") from None
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: a BLP image of {width}x{height} pixels (PIL: an empty size, passed on)")
    if width * height > MAX_PIXELS:
        raise ValueError(f"{name}: an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    mode = "RGBA" if alpha else "RGB"
    tables = _read(data, offset, 128, name, "BLP mipmap tables")
    offsets, lengths = struct.unpack("<16I", tables[:64]), struct.unpack("<16I", tables[64:])
    pos = offset + 128
    if blp1:
        if compression == 0:
            stream = _blp1_jpeg(data, pos, offsets, lengths, len(mode), name)
        elif compression != 1:
            _refuse(name, f"BLP1 compression {compression} (PIL: Unsupported BLP compression)")
        elif encoding not in (4, 5):
            _refuse(name, f"BLP1 encoding {encoding} (PIL: Unsupported BLP encoding)")
        else:
            palette = _read(data, pos, 1024, name, "a BLP palette")
            stream = _bgra(data, pos + 1024, lengths[0], palette, alpha, name)
    else:
        palette = _read(data, pos, 1024, name, "a BLP palette")
        if compression != 1:
            _refuse(name, f"BLP2 compression {compression} (PIL: Unknown BLP compression)")
        if encoding == 1:
            stream = _bgra(data, offsets[0], lengths[0], palette, alpha, name)
        elif encoding == 2:
            if alpha_encoding not in DXT:
                _refuse(name, f"BLP2 alpha encoding {alpha_encoding} (PIL: Unsupported alpha encoding)")
            kind = DXT[alpha_encoding]
            need = (height + 3) // 4 * ((width + 3) // 4) * (8 if kind == 1 else 16)
            blocks = data[offsets[0]:offsets[0] + need]
            if len(blocks) < need:
                _refuse(name, f"BLP DXT{kind} blocks of {len(blocks)} of their {need} bytes {TRUNCATED}")
            stream = blp_dxt_decode(blocks, kind, alpha, width, height, name)
        else:
            _refuse(name, f"BLP2 encoding {encoding} (PIL: Unknown BLP encoding)")
    return Picture(_as_raw(stream, width, height, len(mode), name), mode)


def _read(data: bytes, at: int, n: int, name, what: str) -> bytes:
    """PIL's `_safe_read` of `n` bytes at `at`: all of them, or a raise."""
    out = data[at:at + max(n, 0)]
    if len(out) < n:
        _refuse(name, f"{what} of {len(out)} of their {n} bytes {TRUNCATED}")
    return out


def _bgra(data: bytes, at: int, length: int, palette: bytes, alpha: bool, name) -> np.ndarray:
    """PIL's `_read_bgra`: each of the `length` bytes at `at` an index into
    the BGRA `palette`, giving R, G, B (and A with `alpha`)."""
    entries = np.frombuffer(palette, np.uint8).reshape(256, 4)[:, [2, 1, 0, 3] if alpha else [2, 1, 0]]
    return entries[np.frombuffer(_read(data, at, length, name, "BLP palette indices"), np.uint8)].ravel()


def _blp1_jpeg(data: bytes, pos: int, offsets, lengths, channels, name) -> np.ndarray:
    """A BLP1's JPEG mipmap 0 as PIL's `_decode_jpeg_stream` reads it: the
    shared header, the bytes up to mipmap 0's offset skipped, mipmap 0's
    bytes; the JPEG read with jpegmode "CMYK", converted to RGB, set as
    raw "BGR"."""
    from gaussian_splatting_torch.utils.image_io import Picture, to_rgba

    size = struct.unpack("<I", _read(data, pos, 4, name, "a BLP JPEG header size"))[0]
    header = _read(data, pos + 4, size, name, "a BLP JPEG header")
    pos += 4 + size
    skip = offsets[0] - pos
    _read(data, pos, skip, name, "the bytes before a BLP's JPEG mipmap")
    pos += max(skip, 0)
    stream = header + _read(data, pos, lengths[0], name, "a BLP JPEG mipmap")
    px = jpeg._decode_compiled(stream, f"{name} (its JPEG)", as_cmyk=True)
    if px.shape[0] * px.shape[1] > MAX_PIXELS:
        _refuse(name, f"a BLP JPEG of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    if px.shape[2] == 4:
        rgb = to_rgba(Picture(px, "CMYK"))[..., :3]
    elif px.shape[2] == 1:
        rgb = px.repeat(3, axis=2)
    else:
        rgb = px
    bgr = np.ascontiguousarray(rgb).reshape(-1, 3)[:, ::-1]
    if channels == 4:
        bgr = np.concatenate([bgr, np.full((len(bgr), 1), 255, np.uint8)], axis=1)
    return bgr.ravel()


def _as_raw(stream: np.ndarray, width: int, height: int, channels: int, name) -> np.ndarray:
    """PIL's `set_as_raw`: the first width x height pixels of a byte stream
    of `channels` bytes each, at the image's width; a shorter stream
    raises (PIL: not enough image data)."""
    need = width * height * channels
    if stream.size < need:
        _refuse(name, f"BLP pixel data of {stream.size} of its {need} bytes (PIL: not enough image data)")
    return stream[:need].reshape(height, width, channels)


def blp_dxt_decode(blocks: bytes, kind: int, alpha: bool, width: int, height: int, name: str,
                   plain: bool = False) -> np.ndarray:
    """The byte stream PIL's BLP decoders yield for DXT`kind` (1, 3, 5)
    `blocks` of an image `width` x `height`: every row of 4 pixels of every
    block, rows of blocks in order, 3 bytes a pixel for DXT1 without alpha,
    else 4; by `csrc/bcn_decode.cc`, or with `plain` by numpy
    (`plain_dxt`, for the tests)."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    channels = 3 if kind == 1 and not alpha else 4
    if plain:
        return plain_dxt(blocks, kind, alpha, bw, bh).ravel()
    out = np.empty((4 * bh, 4 * bw, channels), np.uint8)
    if dds._library(name).gs_blp_dxt_decode(blocks, len(blocks), kind, int(alpha), width, height, out.ctypes.data):
        _refuse(name, f"BLP DXT{kind} blocks cut short {TRUNCATED}")
    return out.ravel()


def plain_dxt(blocks: bytes, kind: int, alpha: bool, bw: int, bh: int) -> np.ndarray:
    """(4 bh, 4 bw, 3 or 4) uint8: PIL's `decode_dxt1` / `decode_dxt3` /
    `decode_dxt5` of `bh` rows of `bw` blocks, vectorised over blocks."""
    b = np.frombuffer(blocks, np.uint8, bw * bh * (8 if kind == 1 else 16)).reshape(bw * bh, -1).astype(np.int64)
    colour = b if kind == 1 else b[:, 8:]
    c0, c1 = colour[:, 0] | colour[:, 1] << 8, colour[:, 2] | colour[:, 3] << 8
    code = colour[:, 4] | colour[:, 5] << 8 | colour[:, 6] << 16 | colour[:, 7] << 24

    def unpack(c):
        return np.stack([((c >> 11) & 0x1F) << 3, ((c >> 5) & 0x3F) << 2, (c & 0x1F) << 3], -1)[:, None, :]

    e0, e1 = unpack(c0), unpack(c1)
    ctl = (code[:, None] >> (2 * np.arange(16))) & 3  # (blocks, 16)
    four = np.ones_like(c0, bool) if kind != 1 else c0 > c1
    f = four[:, None, None]
    third = np.where(f, (2 * e0 + e1) // 3, (e0 + e1) // 2)
    fourth = np.where(f, (2 * e1 + e0) // 3, 0)
    rgb = np.select([ctl[..., None] == 0, ctl[..., None] == 1, ctl[..., None] == 2], [e0, e1, third], fourth)
    if kind == 1:
        a = np.where((ctl == 3) & ~four[:, None], 0, 255)
    elif kind == 3:
        p = np.arange(16)
        a = ((b[:, p // 2] >> (4 * (p & 1))) & 0xF) * 17
    else:
        bits = np.zeros(len(b), np.int64)
        for k in range(6):
            bits |= b[:, 2 + k] << (8 * k)
        ac = (bits[:, None] >> (3 * np.arange(16))) & 7
        a0, a1 = b[:, :1], b[:, 1:2]
        a = np.select([ac == 0, ac == 1, a0 > a1, ac == 6, ac == 7],
                      [a0 + 0 * ac, a1 + 0 * ac, ((8 - ac) * a0 + (ac - 1) * a1) // 7, 0, 255],
                      ((6 - ac) * a0 + (ac - 1) * a1) // 5)
    px = np.concatenate([rgb, a[..., None]], -1)
    if kind == 1 and not alpha:
        px = px[..., :3]
    c = px.shape[-1]
    return px.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(4 * bh, 4 * bw, c).astype(np.uint8)
