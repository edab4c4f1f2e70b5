"""AVIF reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL. PIL 12 reads an AVIF
file through libavif 1.3.0, which parses the HEIF container, hands the
primary item's AV1 data to dav1d and converts the decoded YUV to RGB for
PIL's 8-bit `avifRGBImage`. This module follows those three steps:

- the container, with libavif's rules (`parse`): `ftyp` (a major or
  compatible brand `avif`, or `avis`), then `meta` (`hdlr` "pict" first,
  `pitm`, `iloc` versions 0-2 with construction methods 0 (file) and 1
  (`idat`), `iinf` / `infe` versions 2-3, `iprp` / `ipco` / `ipma`, `iref`
  `auxl` and `prem`) and the properties `av1C`, `ispe`, `pixi`, `colr`
  (`nclx`, ICC), `auxC` (the alpha URNs), `irot`, `imir`, `clap`. PIL's
  mode is "RGBA" where an alpha item is attached to the primary item,
  else "RGB". PIL keeps `irot` / `imir` as an EXIF orientation and never
  turns, mirrors or crops the pixels (`np.asarray(Image.open(f))` is the
  decoded picture as it is stored), so neither does this reader;
- the AV1 data, decoded by `csrc/av1_decode.cc` (host C++, built by
  `cuda_build.build_host` at first use; no fallback: a failed build
  raises naming the file): a still picture's key frame or intra-only
  frame, 8-bit, 4:2:0, 4:2:2, 4:4:4 or 4:0:0, with AV1's screen-content
  tools (palette mode and intra block copy) and in-loop filters
  (deblocking, CDEF, loop restoration by the Wiener and self-guided
  filters);
- YUV -> RGB(A) as libavif does it for PIL, in `csrc/av1_decode.cc`'s
  `gs_yuv_to_rgb`: libyuv's 8-bit fixed-point rows with its bilinear
  chroma upsampling where libavif picks libyuv (BT.601, BT.709 and
  BT.2020 matrices, full or limited range, and 4:0:0 to RGBA by its
  I400 rows), libavif's own float path elsewhere (identity, 4:0:0 to RGB,
  other matrices); the alpha item's
  own AV1 stream as the alpha channel (widened to full range where its
  sequence header says limited, as libavif does), un-premultiplied as
  libavif does where a `prem` reference says the colour is premultiplied.

Where PIL's plugin passes a file on (no `ftyp` at offset 4 or a major
brand other than `avif`, `avis`, `mif1`, `msf1`; libavif's
INVALID_FTYP, BMFF_PARSE_FAILED, TRUNCATED_DATA and NO_CONTENT, which
PIL's decoder raises as SyntaxError), this raises
`image_io.NotThisFormat`. What PIL raises otherwise, and the AV1 tools
this port does not decode yet (superres, film grain, 10- and 12-bit
samples, `grid` and `tmap` items, an `avis` image sequence), and the
colour matrices libavif cannot convert, raise a
`ValueError` naming the tool and the file.
"""

from __future__ import annotations

import ctypes
import struct
import time

import numpy as np

from gaussian_splatting_torch.utils import cuda_build
from gaussian_splatting_torch.utils.bmp import MAX_PIXELS

MAJOR_BRANDS = (b"avif", b"avis", b"mif1", b"msf1")  # AvifImagePlugin._accept
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")
# libavif's "last split" of one decode, in seconds (see `decode_avif(..., split=...)`)
SPLIT_KEYS = ("container", "av1_symbols_and_reconstruction", "av1_deblocking", "av1_cdef", "av1_loop_restoration",
              "yuv_to_rgb")
AV1_KEYS = SPLIT_KEYS[1:5]  # the AV1 decoder's own steps, an alpha item's added in
# which tools a frame used: `av1_planes(..., tools=...)` (gs_av1_decode's `tools`)
RESTORATION_TYPES = ("none", "wiener", "sgrproj", "switchable")
CDEF_KINDS = ("primary", "secondary", "both")
LR_KINDS = ("wiener", "sgrproj_both", "sgrproj_one")


def accepts(head: bytes) -> bool:
    """AvifImagePlugin._accept: an `ftyp` box at offset 4 whose major
    brand is one of PIL's four."""
    return head[4:8] == b"ftyp" and head[8:12] in MAJOR_BRANDS


class _Passed(Exception):
    """libavif failed in a way PIL raises as SyntaxError (passed on)."""


def _boxes(data: bytes, start: int, end: int):
    """(type, body start, body end) of each box in data[start:end], as
    libavif's avifROStreamReadBoxHeader reads them."""
    at = start
    while at < end:
        if end - at < 8:
            raise _Passed("a box header cut short (BMFF_PARSE_FAILED)")
        size, kind = struct.unpack(">I4s", data[at:at + 8])
        head = 8
        if size == 1:
            if end - at < 16:
                raise _Passed("a box header cut short (BMFF_PARSE_FAILED)")
            size = struct.unpack(">Q", data[at + 8:at + 16])[0]
            head = 16
        elif size == 0:
            size = end - at
        if kind == b"uuid":
            head += 16
        if size < head:
            raise _Passed("a box smaller than its header (BMFF_PARSE_FAILED)")
        if at + size > end:
            raise _Passed("a box past the end of the file (TRUNCATED_DATA)")
        yield kind, at + head, at + size
        at += size


def _full(data: bytes, at: int):
    return data[at], int.from_bytes(data[at + 1:at + 4], "big"), at + 4


def _uint(data: bytes, at: int, n: int) -> int:
    if n == 0:
        return 0
    return int.from_bytes(data[at:at + n], "big")


class _Item:
    def __init__(self, item_id: int):
        self.id = item_id
        self.type = b""
        self.extents = []  # (offset, length)
        self.method = 0
        self.props = []  # (kind, body)
        self.refs = {}  # kind -> [to ids]


def parse(data: bytes, name: str) -> dict:
    """The primary item's AV1 data, its alpha item's, and the properties
    libavif reads, from an AVIF file's boxes."""
    brands, meta = None, None
    for kind, s, e in _boxes(data, 0, len(data)):
        if brands is None:
            if kind != b"ftyp":
                raise _Passed("no ftyp box first (INVALID_FTYP)")
            if e - s < 8:
                raise _Passed("an ftyp box cut short (BMFF_PARSE_FAILED)")
            brands = [data[s:s + 4]] + [data[i:i + 4] for i in range(s + 8, e - 3, 4)]
            if b"avif" not in brands and b"avis" not in brands:
                raise _Passed("no avif or avis brand (INVALID_FTYP)")
        elif kind == b"meta" and meta is None:
            meta = (s, e)
        elif kind == b"moov":
            raise ValueError(f"{name}: an AVIF image sequence (avis / moov); the port reads still AVIF images")
    if meta is None:
        raise _Passed("no meta box (NO_CONTENT)")
    items: dict[int, _Item] = {}
    primary, idat, props = None, b"", []

    def item(i):
        return items.setdefault(i, _Item(i))

    s, e = meta
    s = _full(data, s)[2]
    first = True
    for kind, bs, be in _boxes(data, s, e):
        if first and kind != b"hdlr":
            raise _Passed("the meta box does not start with hdlr (BMFF_PARSE_FAILED)")
        first = False
        if kind == b"hdlr":
            if data[bs + 8:bs + 12] != b"pict":
                raise _Passed("an hdlr box whose handler is not pict (BMFF_PARSE_FAILED)")
        elif kind == b"pitm":
            v, _, p = _full(data, bs)
            primary = _uint(data, p, 2 if v == 0 else 4)
        elif kind == b"idat":
            idat = data[bs:be]
        elif kind == b"iloc":
            v, _, p = _full(data, bs)
            if v > 2:
                raise _Passed(f"an iloc box of version {v} (BMFF_PARSE_FAILED)")
            off_size, len_size = data[p] >> 4, data[p] & 15
            base_size, index_size = data[p + 1] >> 4, (data[p + 1] & 15) if v in (1, 2) else 0
            p += 2
            count = _uint(data, p, 2 if v < 2 else 4)
            p += 2 if v < 2 else 4
            for _ in range(count):
                it = item(_uint(data, p, 2 if v < 2 else 4))
                p += 2 if v < 2 else 4
                if v in (1, 2):
                    it.method = data[p + 1] & 15
                    p += 2
                p += 2  # data_reference_index
                base = _uint(data, p, base_size)
                p += base_size
                n = _uint(data, p, 2)
                p += 2
                for _ in range(n):
                    p += index_size
                    off = _uint(data, p, off_size)
                    p += off_size
                    length = _uint(data, p, len_size)
                    p += len_size
                    it.extents.append((base + off, length))
            if p > be:
                raise _Passed("an iloc box cut short (BMFF_PARSE_FAILED)")
        elif kind == b"iinf":
            v, _, p = _full(data, bs)
            p += 2 if v == 0 else 4
            for k2, s2, e2 in _boxes(data, p, be):
                if k2 != b"infe":
                    continue
                v2, _, q = _full(data, s2)
                if v2 < 2:
                    continue
                it = item(_uint(data, q, 2 if v2 == 2 else 4))
                q += (2 if v2 == 2 else 4) + 2
                it.type = data[q:q + 4]
        elif kind == b"iprp":
            for k2, s2, e2 in _boxes(data, bs, be):
                if k2 == b"ipco":
                    props = [(k3, data[s3:e3]) for k3, s3, e3 in _boxes(data, s2, e2)]
                elif k2 == b"ipma":
                    v2, f2, q = _full(data, s2)
                    count = _uint(data, q, 4)
                    q += 4
                    for _ in range(count):
                        it = item(_uint(data, q, 2 if v2 < 1 else 4))
                        q += 2 if v2 < 1 else 4
                        n = data[q]
                        q += 1
                        for _ in range(n):
                            if f2 & 1:
                                index = _uint(data, q, 2) & 0x7FFF
                                q += 2
                            else:
                                index = data[q] & 0x7F
                                q += 1
                            it.props.append(index)
        elif kind == b"iref":
            v, _, p = _full(data, bs)
            n = 2 if v == 0 else 4
            for k2, s2, e2 in _boxes(data, p, be):
                q = s2
                src = item(_uint(data, q, n))
                q += n
                count = _uint(data, q, 2)
                q += 2
                src.refs.setdefault(k2, []).extend(_uint(data, q + n * i, n) for i in range(count))
    for it in items.values():
        it.props = [props[i - 1] for i in it.props if 0 < i <= len(props)]
    if primary is None or primary not in items:
        raise _Passed("no primary item (NO_CONTENT)")
    colour = items[primary]
    if colour.type in (b"grid", b"tmap"):
        what = "tiled image" if colour.type == b"grid" else "tone-mapped image"
        raise ValueError(f"{name}: a {colour.type.decode()} primary item (an AVIF {what}); the port reads "
                         "single-image AVIF files")
    if colour.type != b"av01":
        raise ValueError(f"{name}: a primary item of type {colour.type!r} (PIL: Failed to decode image)")
    alpha = None
    for it in items.values():
        if it is colour or it.type != b"av01" or primary not in it.refs.get(b"auxl", []):
            continue
        for kind, body in it.props:
            if kind == b"auxC" and body[4:].split(b"\0")[0] in ALPHA_URNS:
                alpha = it
                break
        if alpha is not None:
            break
    premultiplied = alpha is not None and alpha.id in colour.refs.get(b"prem", [])

    def payload(it):
        out = bytearray()
        for off, length in it.extents:
            src = idat if it.method == 1 else data
            if off + length > len(src):
                raise _Passed("an item's data past the end of the file (TRUNCATED_DATA)")
            out += src[off:off + length]
        return bytes(out)

    for it in (colour, alpha):
        if it is None:
            continue
        kinds = [kind for kind, _ in it.props]
        if b"av1C" not in kinds or b"ispe" not in kinds:
            raise _Passed(f"an av01 item without its {'av1C' if b'av1C' not in kinds else 'ispe'} property "
                          "(BMFF_PARSE_FAILED)")
    info = {"color": payload(colour), "alpha": payload(alpha) if alpha is not None else None,
            "premultiplied": premultiplied, "nclx": None, "ispe": None}
    for kind, body in colour.props:
        if kind == b"colr" and body[:4] == b"nclx" and info["nclx"] is None:
            cp, tc, mc = struct.unpack(">HHH", body[4:10])
            info["nclx"] = (cp, tc, mc, body[10] >> 7)
        elif kind == b"ispe" and info["ispe"] is None:
            info["ispe"] = struct.unpack(">II", body[4:12])
    return info


def _library(name: str):
    try:
        lib = cuda_build.load_host("av1_decode")
    except RuntimeError as err:
        raise RuntimeError(f"{name}: the AV1 decoder (csrc/av1_decode.cc) could not be built: {err}") from err
    if not hasattr(lib, "_gs_typed"):
        P = ctypes.c_void_p
        lib.gs_av1_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong, P, P, P, P, P, P, ctypes.c_char_p,
                                      ctypes.c_int]
        lib.gs_av1_decode.restype = ctypes.c_int
        i = ctypes.c_int
        lib.gs_yuv_to_rgb.argtypes = [P, P, P, P, i, i, i, i, i, i, i, i, i, P, ctypes.c_char_p, i]
        lib.gs_yuv_to_rgb.restype = ctypes.c_int
        lib._gs_typed = True
    return lib


def decode_avif(data: bytes, name: str = "<bytes>", split: dict | None = None):
    """The `image_io.Picture` of AVIF bytes: PIL's mode ("RGB", or "RGBA"
    with an alpha item) and pixels. `split`, where given, receives the
    seconds of each step (`SPLIT_KEYS`)."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    t0 = time.perf_counter()
    try:
        info = parse(data, name)
    except _Passed as why:
        raise NotThisFormat(f"{name}: {why} (PIL: SyntaxError, passed on)") from None
    except (IndexError, struct.error):
        raise NotThisFormat(f"{name}: AVIF boxes cut short (BMFF_PARSE_FAILED; PIL: SyntaxError, passed on)") from None
    if info["ispe"] is not None and info["ispe"][0] * info["ispe"][1] > MAX_PIXELS:
        raise ValueError(f"{name}: an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    times = {SPLIT_KEYS[0]: time.perf_counter() - t0}
    y, u, v, seq = av1_planes(info["color"], name, times)
    h, w = y.shape
    if info["ispe"] is not None and info["ispe"] != (w, h):
        iw, ih = info["ispe"]
        raise ValueError(f"{name}: an AV1 frame of {w}x{h} in an item whose ispe says {iw}x{ih}")
    cp, mc, full = seq["cp"], seq["mc"], seq["full_range"]
    if info["nclx"] is not None:  # libavif: the container's colour description wins
        cp, _, mc, full = info["nclx"]
    a = None
    if info["alpha"] is not None:
        part = {}
        a, _, _, alpha_seq = av1_planes(info["alpha"], name, part)
        if not alpha_seq["full_range"]:  # libavif widens limited-range alpha: (a - 16) * 255 / 219, rounded
            a = np.clip(((a.astype(np.int32) - 16) * 255 + 109) // 219, 0, 255).astype(np.uint8)
        for key in AV1_KEYS:
            times[key] += part[key]
        if a.shape != y.shape:
            raise ValueError(f"{name}: an alpha item of {a.shape[1]}x{a.shape[0]} for a {w}x{h} image "
                             "(PIL: Failed to decode image)")
    t1 = time.perf_counter()
    out = np.empty((h, w, 4 if a is not None else 3), np.uint8)
    msg = ctypes.create_string_buffer(512)
    lib = _library(name)
    ptr = (lambda x: None if x is None else x.ctypes.data)
    if lib.gs_yuv_to_rgb(y.ctypes.data, ptr(u), ptr(v), ptr(a), w, h, seq["mono"], seq["ss_x"], seq["ss_y"], mc, cp,
                         full, int(info["premultiplied"]), out.ctypes.data, msg, len(msg)):
        raise ValueError(f"{name}: {msg.value.decode()}; the port converts AVIF colour as libavif does for the "
                         "BT.601, BT.709 and BT.2020 matrices, identity, and 4:0:0")
    times[SPLIT_KEYS[-1]] = time.perf_counter() - t1
    if split is not None:
        split.update(times)
    return Picture(out, "RGBA" if a is not None else "RGB")


def av1_planes(av1: bytes, name: str, times=None, tools=None):
    """(Y, U, V, info) of one AV1 image item: 8-bit planes (U and V None
    for 4:0:0) and its sequence header's colour description. `times`,
    where given, receives the seconds of the decoder's steps (`AV1_KEYS`);
    `tools` (a test hook) which tools the frame used: "use_128",
    "cdef_bits" (-1 without CDEF), "lr_unit_shift" (-1 without loop
    restoration), "lr_uv_shift", "lr_types" (each plane's frame restoration
    type), "cdef_blocks" (per plane, the 8x8 blocks CDEF filtered with
    each `CDEF_KINDS` of strengths), "lr_units" (per plane, the units of
    each of `LR_KINDS`), "palette_y" and "palette_uv" (the palette blocks of
    each size 2-8), "palette_cache" and "palette_delta" (the Y and U colours
    taken from the palette cache and delta-coded), "palette_v" (UV palettes
    whose V colours are "delta"- or "raw"-coded), "intrabc" (IntraBC blocks
    whose DV prediction came from the "stack" or the "default" DV),
    "vartx_depths" (var-tx transform blocks at depth 0, 1, 2),
    "inter_tx_sets" (inter transform blocks of tx set 0-3, 0 where no type
    is read) and "intrabc_chroma" (IntraBC chroma predictions at a
    "fractional" position, and of blocks "below_8x8")."""
    lib = _library(name)
    info = np.zeros(16, np.int32)
    msg = ctypes.create_string_buffer(512)
    if lib.gs_av1_decode(av1, len(av1), info.ctypes.data, None, None, None, None, None, msg, len(msg)):
        raise ValueError(f"{name}: {msg.value.decode()}; the port reads AVIF files of 8-bit AV1 still pictures")
    w, h, mono, sx, sy = (int(v) for v in info[:5])
    if w * h > MAX_PIXELS:
        raise ValueError(f"{name}: an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    info[10], info[11] = w, h
    y = np.empty((h, w), np.uint8)
    cw, ch = (w + sx) >> sx, (h + sy) >> sy
    u = v = None
    if not mono:
        u, v = np.empty((ch, cw), np.uint8), np.empty((ch, cw), np.uint8)
    t = np.zeros(len(AV1_KEYS), np.float64)
    used = np.zeros(64, np.int32)
    if lib.gs_av1_decode(av1, len(av1), info.ctypes.data, y.ctypes.data, None if mono else u.ctypes.data,
                         None if mono else v.ctypes.data, t.ctypes.data, used.ctypes.data, msg, len(msg)):
        raise ValueError(f"{name}: {msg.value.decode()}; the port reads AVIF files of 8-bit AV1 still pictures")
    if times is not None:
        times.update(zip(AV1_KEYS, t.tolist()))
    if tools is not None:
        tools.update(use_128=int(used[0]), cdef_bits=int(used[1]), lr_unit_shift=int(used[2]),
                     lr_uv_shift=int(used[3]), lr_types=[RESTORATION_TYPES[int(k)] for k in used[4:7]],
                     cdef_blocks=[dict(zip(CDEF_KINDS, used[7 + 3 * p:10 + 3 * p].tolist())) for p in range(3)],
                     lr_units=[dict(zip(LR_KINDS, used[16 + 3 * p:19 + 3 * p].tolist())) for p in range(3)],
                     palette_y=dict(zip(range(2, 9), used[32:39].tolist())),
                     palette_uv=dict(zip(range(2, 9), used[39:46].tolist())),
                     palette_cache=used[46:48].tolist(), palette_delta=used[48:50].tolist(),
                     palette_v=dict(delta=int(used[50]), raw=int(used[51])),
                     intrabc=dict(stack=int(used[52]), default=int(used[53])), vartx_depths=used[54:57].tolist(),
                     inter_tx_sets=used[57:61].tolist(),
                     intrabc_chroma=dict(fractional=int(used[61]), below_8x8=int(used[62])))
    return y, u, v, {"mono": mono, "ss_x": sx, "ss_y": sy, "cp": int(info[6]), "tc": int(info[7]),
                     "mc": int(info[8]), "full_range": int(info[9])}
