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
  (`nclx`, ICC), `auxC` (the alpha URNs), `irot`, `imir`, `clap`; or,
  where libavif picks the tracks of an image sequence (`avis`), the
  `moov` box's colour and alpha tracks (`tkhd`, `mdhd`, `tref` `auxl` and
  `prem`, the `av01` sample entry's `av1C`, `colr` and `auxi`) and their
  sample 0 by `stco` / `co64`, `stsc` and `stsz`: PIL shows frame 0. PIL's
  mode is "RGBA" where an alpha item or track is attached to the colour,
  else "RGB". PIL keeps `irot` / `imir` as an EXIF orientation and never
  turns, mirrors or crops the pixels (`np.asarray(Image.open(f))` is the
  decoded picture as it is stored), so neither does this reader;
- the AV1 data, decoded by `csrc/av1_decode.cc` (host C++, built by
  `cuda_build.build_host` at first use; no fallback: a failed build
  raises naming the file): a key frame or intra-only frame, 8-bit,
  4:2:0, 4:2:2, 4:4:4 or 4:0:0, with AV1's screen-content tools (palette
  mode and intra block copy), in-loop filters (deblocking, CDEF, loop
  restoration by the Wiener and self-guided filters) and film grain
  synthesis, which dav1d applies for PIL (on an alpha item too);
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
PIL's decoder raises as SyntaxError, for the track boxes too), this
raises `image_io.NotThisFormat`. What PIL raises otherwise, and the AV1
tools this port does not decode yet (superres, 10- and 12-bit samples,
`grid` and `tmap` items), and the colour matrices libavif cannot
convert, raise a `ValueError` naming the tool and the file.
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
              "av1_film_grain", "yuv_to_rgb")
AV1_KEYS = SPLIT_KEYS[1:6]  # the AV1 decoder's own steps, an alpha item's added in
# which tools a frame used: `av1_planes(..., tools=...)` (gs_av1_decode's `tools`)
RESTORATION_TYPES = ("none", "wiener", "sgrproj", "switchable")
CDEF_KINDS = ("primary", "secondary", "both")
LR_KINDS = ("wiener", "sgrproj_both", "sgrproj_one")
# the film grain parameters the hook reports, in gs_av1_decode's order (tools[63:72])
FILM_GRAIN_KEYS = ("apply_grain", "ar_coeff_lag", "num_y_points", "num_cb_points", "num_cr_points",
                   "chroma_scaling_from_luma", "overlap_flag", "clip_to_restricted_range", "grain_scale_shift")


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


def _top_level(data: bytes):
    """(the major brand, meta (start, end) or None, moov (start, end) or
    None) as libavif's avifParse reads the file's boxes: `ftyp` first; a
    brand `avif` needs a `meta` box and `avis` a `moov`, and the parse ends
    as soon as the boxes the brands need are read (a `moov` after them is
    never parsed)."""
    brands = major = meta = moov = None
    need_meta = need_moov = False
    for kind, s, e in _boxes(data, 0, len(data)):
        if brands is None:
            if kind != b"ftyp":
                raise _Passed("no ftyp box first (INVALID_FTYP)")
            if e - s < 8:
                raise _Passed("an ftyp box cut short (BMFF_PARSE_FAILED)")
            major = data[s:s + 4]
            brands = [major] + [data[i:i + 4] for i in range(s + 8, e - 3, 4)]
            if b"avif" not in brands and b"avis" not in brands:
                raise _Passed("no avif or avis brand (INVALID_FTYP)")
            need_meta, need_moov = b"avif" in brands, b"avis" in brands
        elif kind == b"ftyp":
            raise _Passed("a second ftyp box (BMFF_PARSE_FAILED)")
        elif kind == b"meta":
            if meta is not None:
                raise _Passed("a second meta box (BMFF_PARSE_FAILED)")
            meta = (s, e)
        elif kind == b"moov":
            if moov is not None:
                raise _Passed("a second moov box (BMFF_PARSE_FAILED)")
            moov = (s, e)
        if (not need_meta or meta is not None) and (not need_moov or moov is not None):
            break
    if brands is None:
        raise _Passed("no ftyp box (INVALID_FTYP)")
    if (need_meta and meta is None) or (need_moov and moov is None):
        raise _Passed(f"no {'meta' if need_meta and meta is None else 'moov'} box for the file's brands "
                      "(TRUNCATED_DATA)")
    return major, meta, moov


def parse(data: bytes, name: str) -> dict:
    """The AV1 data of the picture PIL shows and of its alpha, and the
    properties libavif reads. libavif's AVIF_DECODER_SOURCE_AUTO picks the
    source: a major brand `avis` reads the tracks of the `moov` box (frame
    0 of an image sequence), a major brand `avif` the primary item of the
    `meta` box, any other the tracks where the `moov` box was read, else
    the primary item. "source" says which ("tracks" or "item")."""
    major, meta, moov = _top_level(data)
    items = _meta_items(data, meta) if meta is not None else None
    tracks = _tracks(data, moov) if moov is not None else []
    if major == b"avis" or (major != b"avif" and tracks):
        return _from_tracks(data, tracks, name)
    if items is None:
        raise _Passed("no meta box (NO_CONTENT)")
    return _from_items(data, *items, name)


def _meta_items(data: bytes, meta):
    """(items by id, the primary item's id, the idat bytes) of the `meta`
    box, with libavif's checks of its boxes."""
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
    return items, primary, idat


def _colour(info: dict, props) -> dict:
    """The first `nclx` colour box of an item or a sample entry: libavif
    converts by it where present."""
    for kind, body in props:
        if kind == b"colr" and body[:4] == b"nclx" and info["nclx"] is None:
            cp, tc, mc = struct.unpack(">HHH", body[4:10])
            info["nclx"] = (cp, tc, mc, body[10] >> 7)
    return info


def _from_items(data: bytes, items: dict, primary, idat: bytes, name: str) -> dict:
    """The primary item and its alpha item (libavif's item source)."""
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
            "premultiplied": premultiplied, "nclx": None, "size": None, "source": "item"}
    for kind, body in colour.props:
        if kind == b"ispe" and info["size"] is None:
            info["size"] = struct.unpack(">II", body[4:12])
    return _colour(info, colour.props)


class _Track:
    def __init__(self):
        self.id = 0
        self.size = (0, 0)  # tkhd's width, height
        self.timescale = 0
        self.refs = {}  # tref kind -> [track ids]
        self.entries = []  # stsd: (format, [(kind, body)] of its child boxes)
        self.chunks = []  # stco / co64 offsets
        self.to_chunk = []  # stsc: (first_chunk, samples_per_chunk)
        self.sample_size, self.sizes = 0, []  # stsz: the fixed size, else each sample's


def _tracks(data: bytes, moov) -> list:
    """The `trak` boxes of the `moov` box, as libavif's avifParseMovieBox
    reads them: tkhd (its id and size), mdia / mdhd (the timescale), tref,
    and stbl's stsd, stco / co64, stsc and stsz. Where libavif fails on a
    box (BMFF_PARSE_FAILED), this raises `_Passed`."""
    tracks = []
    for kind, s, e in _boxes(data, *moov):
        if kind != b"trak":
            continue
        t, seen = _Track(), set()
        for k2, s2, e2 in _boxes(data, s, e):
            if k2 in (b"tkhd", b"mdia") and k2 in seen:
                raise _Passed(f"a second {k2.decode()} box in a track (BMFF_PARSE_FAILED)")
            seen.add(k2)
            if k2 == b"tkhd":
                v, _, p = _full(data, s2)
                if v > 1:
                    raise _Passed(f"a tkhd box of version {v} (BMFF_PARSE_FAILED)")
                t.id = _uint(data, p + (16 if v else 8), 4)
                p += (32 if v else 20) + 16 + 36  # times, id, duration; reserved, layer, volume; matrix
                if p + 8 > e2:
                    raise _Passed("a tkhd box cut short (BMFF_PARSE_FAILED)")
                t.size = (_uint(data, p, 4) >> 16, _uint(data, p + 4, 4) >> 16)
                if 0 in t.size:
                    raise _Passed("a track of width or height 0 (BMFF_PARSE_FAILED)")
            elif k2 == b"tref":
                for k3, s3, e3 in _boxes(data, s2, e2):
                    t.refs.setdefault(k3, []).extend(_uint(data, q, 4) for q in range(s3, e3 - 3, 4))
            elif k2 == b"mdia":
                _media(data, s2, e2, t)
        if not {b"tkhd", b"mdia"} <= seen:
            raise _Passed(f"a track without its {'tkhd' if b'tkhd' not in seen else 'mdia'} box (BMFF_PARSE_FAILED)")
        tracks.append(t)
    if not tracks:
        raise _Passed("a moov box without tracks (BMFF_PARSE_FAILED)")
    return tracks


def _media(data: bytes, s: int, e: int, t: _Track):
    for kind, bs, be in _boxes(data, s, e):
        if kind == b"mdhd":
            v, _, p = _full(data, bs)
            t.timescale = _uint(data, p + (16 if v == 1 else 8), 4)
        elif kind == b"minf":
            for k2, s2, e2 in _boxes(data, bs, be):
                if k2 == b"stbl":
                    _sample_table(data, s2, e2, t)


def _sample_table(data: bytes, s: int, e: int, t: _Track):
    def counted(at, end, width):
        """(entry_count, where the entries start) of a box whose version and
        flags are at `at`, its entries of `width` bytes within `end`."""
        count = _uint(data, at + 4, 4)
        if at + 8 + count * width > end:
            raise _Passed("a sample table box cut short (BMFF_PARSE_FAILED)")
        return count, at + 8

    for kind, bs, be in _boxes(data, s, e):
        if kind in (b"stco", b"co64"):
            n = 8 if kind == b"co64" else 4
            count, p = counted(bs, be, n)
            t.chunks = [_uint(data, p + n * i, n) for i in range(count)]
        elif kind == b"stsc":
            count, p = counted(bs, be, 12)
            t.to_chunk = [(_uint(data, p + 12 * i, 4), _uint(data, p + 12 * i + 4, 4)) for i in range(count)]
        elif kind == b"stsz":
            if bs + 12 > be:
                raise _Passed("an stsz box cut short (BMFF_PARSE_FAILED)")
            t.sample_size = _uint(data, bs + 4, 4)
            if t.sample_size == 0:
                count, p = counted(bs + 4, be, 4)
                t.sizes = [_uint(data, p + 4 * i, 4) for i in range(count)]
        elif kind == b"stsd":
            count, p = _uint(data, bs + 4, 4), bs + 8
            for k2, s2, e2 in list(_boxes(data, p, be))[:count]:
                kids = [(k3, data[s3:e3]) for k3, s3, e3 in _boxes(data, s2 + 78, e2)] if k2 == b"av01" else []
                t.entries.append((k2, kids))


def _samples(t: _Track, size: int) -> list:
    """(offset, size) of every sample of a track, as libavif's
    avifCodecDecodeInputFillFromSampleTable lays them out: each chunk's
    sample count from the last stsc entry whose first chunk is at or before
    it, sizes from stsz; a chunk of no samples, a sample stsz does not
    size, or one past the end of the file fails (BMFF_PARSE_FAILED)."""
    out, k = [], 0
    for index, offset in enumerate(t.chunks):
        count = next((n for first, n in reversed(t.to_chunk) if first <= index + 1), 0)
        if count == 0:
            raise _Passed("a chunk of no samples (BMFF_PARSE_FAILED)")
        for _ in range(count):
            if t.sample_size:
                length = t.sample_size
            elif k < len(t.sizes):
                length = t.sizes[k]
            else:
                raise _Passed("a sample table whose stsz sizes fewer samples than its chunks hold "
                              "(BMFF_PARSE_FAILED)")
            if offset + length > size:
                raise _Passed("a sample past the end of the file (BMFF_PARSE_FAILED)")
            out.append((offset, length))
            offset += length
            k += 1
    return out


def _from_tracks(data: bytes, tracks: list, name: str) -> dict:
    """Frame 0 of libavif's track source: the colour track is the first
    track with an id, chunks and an `av01` sample entry that is no other
    track's auxiliary (`tref` `auxl`); its alpha the first such track whose
    `auxl` names it and whose entry's `auxi` (where present) is an alpha
    URN; `prem` in the colour track's `tref` un-premultiplies."""
    def usable(t):
        return t.id and t.chunks and any(fmt == b"av01" for fmt, _ in t.entries)

    def props(t):
        return next(kids for fmt, kids in t.entries if fmt == b"av01")

    colour = next((t for t in tracks if usable(t) and not t.refs.get(b"auxl")), None)
    if colour is None:
        raise _Passed("no AV1 colour track (NO_CONTENT)")
    if b"av1C" not in [kind for kind, _ in props(colour)]:
        raise _Passed("an av01 colour track without its av1C (BMFF_PARSE_FAILED)")
    alpha = None
    for t in tracks:
        if usable(t) and t.refs.get(b"auxl", [None])[0] == colour.id:
            urns = [body[4:].split(b"\0")[0] for kind, body in props(t) if kind == b"auxi"]
            if not urns or urns[0] in ALPHA_URNS:
                alpha = t
                break
    samples = [_samples(t, len(data)) for t in (colour, alpha) if t is not None]
    if colour.timescale == 0:
        raise ValueError(f"{name}: an AVIF image sequence whose colour track has no timescale (mdhd; PIL: "
                         "ZeroDivisionError)")
    if alpha is not None and alpha.size != colour.size:
        raise ValueError(f"{name}: an alpha track of {alpha.size[0]}x{alpha.size[1]} for a "
                         f"{colour.size[0]}x{colour.size[1]} colour track (PIL: Decoding of alpha plane failed)")
    (off, length), *_ = samples[0]
    info = {"color": data[off:off + length], "alpha": None, "size": colour.size, "nclx": None, "source": "tracks",
            "premultiplied": alpha is not None and alpha.id in colour.refs.get(b"prem", [])}
    if alpha is not None:
        off, length = samples[1][0]
        info["alpha"] = data[off:off + length]
    return _colour(info, props(colour))


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
    if info["size"] is not None and info["size"][0] * info["size"][1] > MAX_PIXELS:
        raise ValueError(f"{name}: an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    times = {SPLIT_KEYS[0]: time.perf_counter() - t0}
    y, u, v, seq = av1_planes(info["color"], name, times)
    h, w = y.shape
    if info["size"] is not None and info["size"] != (w, h):
        iw, ih = info["size"]
        where = "an item whose ispe" if info["source"] == "item" else "a track whose tkhd"
        raise ValueError(f"{name}: an AV1 frame of {w}x{h} in {where} says {iw}x{ih}")
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
    is read), "intrabc_chroma" (IntraBC chroma predictions at a
    "fractional" position, and of blocks "below_8x8") and "film_grain"
    (the frame's film grain parameters, `FILM_GRAIN_KEYS`; all 0 without
    grain)."""
    lib = _library(name)
    info = np.zeros(16, np.int32)
    msg = ctypes.create_string_buffer(512)
    if lib.gs_av1_decode(av1, len(av1), info.ctypes.data, None, None, None, None, None, msg, len(msg)):
        raise ValueError(f"{name}: {msg.value.decode()}; the port reads AVIF files of 8-bit AV1 pictures")
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
    used = np.zeros(72, np.int32)
    if lib.gs_av1_decode(av1, len(av1), info.ctypes.data, y.ctypes.data, None if mono else u.ctypes.data,
                         None if mono else v.ctypes.data, t.ctypes.data, used.ctypes.data, msg, len(msg)):
        raise ValueError(f"{name}: {msg.value.decode()}; the port reads AVIF files of 8-bit AV1 pictures")
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
                     intrabc_chroma=dict(fractional=int(used[61]), below_8x8=int(used[62])),
                     film_grain=dict(zip(FILM_GRAIN_KEYS, used[63:72].tolist())))
    return y, u, v, {"mono": mono, "ss_x": sx, "ss_y": sy, "cp": int(info[6]), "tc": int(info[7]),
                     "mc": int(info[8]), "full_range": int(info[9])}
