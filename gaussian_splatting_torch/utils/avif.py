"""AVIF reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL. PIL 12 reads an AVIF
file through libavif 1.3.0, which parses the HEIF container, hands the
primary item's AV1 data to dav1d and converts the decoded YUV to RGB for
PIL's 8-bit `avifRGBImage`. This module follows those three steps:

- the container, with libavif's rules (`parse`): `ftyp` (a major or
  compatible brand `avif`, or `avis`), then `meta` (`hdlr` "pict" first,
  `pitm`, `iloc` versions 0-2 with construction methods 0 (file) and 1
  (`idat`), `iinf` / `infe` versions 2-3, `iprp` / `ipco` / `ipma`, `iref`
  `auxl`, `prem` and `dimg`) and the properties `av1C`, `ispe`, `pixi`,
  `colr` (`nclx`, ICC), `auxC` (the alpha URNs), `irot`, `imir`, `clap`;
  a `grid` primary item (a tiled image: its ImageGrid body, its `av01`
  cells in `dimg` order, its alpha grid or an alpha item for each cell)
  with libavif's grid rules, each cell decoded on its own and the cells
  copied into whole planes, cropped to the output size, before one
  conversion; or,
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
  raises naming the file): a key frame or intra-only frame of 8-, 10- or
  12-bit samples (profiles 0, 1 and 2), 4:2:0, 4:2:2, 4:4:4 or 4:0:0,
  with AV1's screen-content tools (palette mode at 8 bits, intra block
  copy), in-loop filters (deblocking, CDEF, loop restoration by the
  Wiener and self-guided filters) and film grain synthesis, which dav1d
  applies for PIL (on an alpha item too);
- YUV -> RGB(A) as libavif does it for PIL, in `csrc/av1_decode.cc`'s
  `gs_yuv_to_rgb`: libyuv's fixed-point rows with its bilinear chroma
  upsampling where libavif picks libyuv (BT.601, BT.709 and BT.2020
  matrices, full or limited range, and 4:0:0 to RGBA by its I400 rows;
  above 8 bits its 10- and 12-bit rows, or the planes downshifted to 8
  bits first, as libavif picks them), libavif's own float path elsewhere
  (identity, 4:0:0 to RGB, other matrices); the alpha item's own AV1
  stream as the alpha channel (widened to full range where its sequence
  header says limited, as libavif does; brought to 8 bits as libavif
  brings it), un-premultiplied as libavif does where a `prem` reference
  says the colour is premultiplied.

Where PIL's plugin passes a file on (no `ftyp` at offset 4 or a major
brand other than `avif`, `avis`, `mif1`, `msf1`; libavif's
INVALID_FTYP, BMFF_PARSE_FAILED, TRUNCATED_DATA and NO_CONTENT, which
PIL's decoder raises as SyntaxError, for the track boxes too), this
raises `image_io.NotThisFormat`. What PIL raises otherwise, and the AV1
tools this port does not decode yet (superres, palette colours at 10
and 12 bits, `tmap` primary items, items whose AV1 frame libavif scales
to their `ispe`), and the colour matrices libavif cannot convert, raise
a `ValueError` naming the tool and the file.
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
GRID_KEY = "grid_copies"  # a grid's copies of its cells into the whole planes (a grid's split only)
# what the AV1 decoder reads, named where it refuses a stream
READS = ("the port reads AVIF files of 8-, 10- and 12-bit AV1 key frames, without superres or palette colours "
         "above 8 bits")
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
        self.unknown_essential = False  # an essential property of a kind libavif does not know
        self.aux_for = 0  # libavif's auxForID: the last item this item's `auxl` names
        self.dimg_for, self.dimg_index = 0, 0  # the last `dimg` reference to this item: its grid, its place


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
                                index, essential = _uint(data, q, 2) & 0x7FFF, data[q] >> 7
                                q += 2
                            else:
                                index, essential = data[q] & 0x7F, data[q] >> 7
                                q += 1
                            it.props.append((index, essential))
        elif kind == b"iref":
            v, _, p = _full(data, bs)
            n = 2 if v == 0 else 4
            for k2, s2, e2 in _boxes(data, p, be):
                q = s2
                src = item(_uint(data, q, n))
                q += n
                count = _uint(data, q, 2)
                q += 2
                to = [_uint(data, q + n * i, n) for i in range(count)]
                src.refs.setdefault(k2, []).extend(to)
                if k2 == b"auxl" and to:
                    src.aux_for = to[-1]
                elif k2 == b"dimg":  # derived images refer the other way: each cell names its grid
                    if b"dimg" in src.refs and len(src.refs[b"dimg"]) > len(to):
                        raise _Passed(f"a second dimg box from item {src.id} (BMFF_PARSE_FAILED)")
                    for i, cell in enumerate(to):
                        item(cell).dimg_for, item(cell).dimg_index = src.id, i
    for it in items.values():
        it.unknown_essential = any(essential and props[i - 1][0] not in KNOWN_PROPERTIES
                                   for i, essential in it.props if 0 < i <= len(props))
        it.props = [props[i - 1] for i, _ in it.props if 0 < i <= len(props)]
    return items, primary, idat


def _colour(info: dict, props) -> dict:
    """The first `nclx` colour box of an item or a sample entry: libavif
    converts by it where present."""
    for kind, body in props:
        if kind == b"colr" and body[:4] == b"nclx" and info["nclx"] is None:
            cp, tc, mc = struct.unpack(">HHH", body[4:10])
            info["nclx"] = (cp, tc, mc, body[10] >> 7)
    return info


class _Grid:
    """A `grid` item as libavif lays it out: its ImageGrid body (rows and
    columns, the output size) and its cells in `dimg` order (each cell's AV1
    data and `ispe` size)."""

    def __init__(self, rows, cols, width, height, cells, sizes):
        self.rows, self.cols, self.width, self.height = rows, cols, width, height
        self.cells, self.sizes = cells, sizes


# the item properties libavif knows (read.c's supportedTypes): an essential
# property of another kind makes it skip the item, and refuse it as a cell
KNOWN_PROPERTIES = (b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"clap", b"irot", b"imir", b"pixi", b"a1op",
                    b"lsel", b"a1lx", b"clli")
IMAGE_SIZE_LIMIT, IMAGE_DIMENSION_LIMIT = 16384 * 16384, 32768  # libavif's defaults, which PIL keeps


def _too_large(w: int, h: int) -> bool:
    """libavif's avifDimensionsTooLarge at its default limits."""
    return w > IMAGE_SIZE_LIMIT // h or w > IMAGE_DIMENSION_LIMIT or h > IMAGE_DIMENSION_LIMIT


def _payload(data: bytes, idat: bytes, it) -> bytes:
    out = bytearray()
    for off, length in it.extents:
        src = idat if it.method == 1 else data
        if off + length > len(src):
            raise _Passed("an item's data past the end of the file (TRUNCATED_DATA)")
        out += src[off:off + length]
    return bytes(out)


def _prop(it, kind: bytes):
    return next((body for k, body in it.props if k == kind), None)


def _check_items(items: dict):
    """libavif's check of every image item (`av01` or `grid`) it does not
    skip for an unknown essential property: an `ispe` of a size other than
    0 and within its limits (BMFF_PARSE_FAILED)."""
    for it in items.values():
        if it.unknown_essential or it.type not in (b"av01", b"grid"):
            continue
        ispe = _prop(it, b"ispe")
        if ispe is None:
            raise _Passed(f"an item of type {it.type.decode()} without its ispe property (BMFF_PARSE_FAILED)")
        w, h = struct.unpack(">II", ispe[4:12])
        if w == 0 or h == 0 or _too_large(w, h):
            raise _Passed(f"an item of size {w}x{h} (ispe; BMFF_PARSE_FAILED)")


def _grid_error(name: str, rule: str) -> ValueError:
    return ValueError(f"{name}: an AVIF grid item {rule} (libavif: INVALID_IMAGE_GRID; PIL: Failed to decode image)")


def _grid(data: bytes, items: dict, grid, idat: bytes, name: str) -> _Grid:
    """A `grid` item's ImageGrid body and cells, with libavif's rules
    (avifParseImageGridBox, avifFillDimgIdxToItemIdxArray). What libavif
    fails as INVALID_IMAGE_GRID (PIL: Failed to decode image) raises a
    ValueError naming the rule; its parse failures (PIL: SyntaxError)
    raise `_Passed`."""
    body = _payload(data, idat, grid)
    if not body or body[0] != 0:
        raise _grid_error(name, f"of ImageGrid version {body[0]}" if body else "with an empty ImageGrid body")
    field = 4 if len(body) > 1 and body[1] & 1 else 2
    if len(body) < 4 + 2 * field:
        raise _grid_error(name, f"whose ImageGrid body is cut short ({len(body)} bytes)")
    if len(body) > 4 + 2 * field:
        raise _grid_error(name, f"whose ImageGrid body has {len(body) - 4 - 2 * field} bytes after the output size")
    rows, cols = body[2] + 1, body[3] + 1
    width, height = _uint(body, 4, field), _uint(body, 4 + field, field)
    if width == 0 or height == 0 or _too_large(width, height):
        raise _grid_error(name, f"of output size {width}x{height}")
    cells = [it for it in items.values() if it.dimg_for == grid.id]
    if len(cells) != rows * cols:
        raise _grid_error(name, f"of {rows}x{cols} cells with {len(cells)} dimg references")
    order = [None] * len(cells)
    for it in cells:
        if it.dimg_index >= len(cells) or order[it.dimg_index] is not None:
            raise _grid_error(name, f"whose dimg references name a cell twice (item {it.id})")
        order[it.dimg_index] = it
    out = _grid_cells(data, idat, rows, cols, width, height, order, name)
    _check_pixi(grid, _prop(order[0], b"av1C"))
    return out


def _grid_cells(data: bytes, idat: bytes, rows, cols, width, height, order, name: str) -> _Grid:
    """The cells of a grid in `dimg` order, with libavif's rules
    (avifDecoderGenerateImageGridTiles, avifDecoderItemValidateProperties):
    each an `av01` item of no unknown essential property, with data; the
    first with an `av1C`, the others with one equal in every field."""
    for it in order:
        if it.type != b"av01":
            raise _grid_error(name, f"with a cell (item {it.id}) of type {it.type!r}")
        if it.unknown_essential:
            raise _grid_error(name, f"with a cell (item {it.id}) of an unknown essential property")
        if sum(n for _, n in it.extents) == 0:
            raise _Passed(f"a grid cell (item {it.id}) with no data")
    first = _prop(order[0], b"av1C")
    if first is None:
        raise _grid_error(name, "whose first cell has no av1C property")
    for it in order[1:]:
        config = _prop(it, b"av1C")
        if config is None:
            raise _Passed(f"a grid cell (item {it.id}) without its av1C property (BMFF_PARSE_FAILED)")
        if config[1:3] != first[1:3]:
            raise _Passed(f"a grid cell (item {it.id}) whose av1C differs from the first cell's (BMFF_PARSE_FAILED)")
    sizes = [struct.unpack(">II", _prop(it, b"ispe")[4:12]) for it in order]
    return _Grid(rows, cols, width, height, [_payload(data, idat, it) for it in order], sizes)


def _check_pixi(it, config: bytes):
    """libavif: each plane depth of a `pixi` property is the av1C's depth
    (BMFF_PARSE_FAILED)."""
    pixi = _prop(it, b"pixi")
    if pixi is None or len(config) < 3:
        return
    depth = 12 if config[2] & 0x60 == 0x60 else 10 if config[2] & 0x40 else 8
    if any(d != depth for d in pixi[5:5 + pixi[4]]):
        raise _Passed(f"an item whose pixi depths {list(pixi[5:5 + pixi[4]])} are not its av1C's {depth} "
                      "(BMFF_PARSE_FAILED)")


def _alpha_urn(it) -> bool:
    auxc = _prop(it, b"auxC")
    return auxc is not None and auxc[4:].split(b"\0")[0] in ALPHA_URNS


def _alpha_item(items: dict, colour, name: str):
    """libavif's avifMetaFindAlphaItem: the first `av01` or `grid` item with
    data and no unknown essential property whose `auxl` names the colour
    and whose `auxC` is an alpha URN. Else, for a grid, the one such item
    whose `auxl` names each cell (in item order), as a list: libavif lays
    them out as the colour's grid; None where a cell has none."""
    for it in items.values():
        if sum(n for _, n in it.extents) and not it.unknown_essential and it.type in (b"av01", b"grid") \
                and it.aux_for == colour.id and _alpha_urn(it):
            return it
    if colour.type != b"grid":
        return None
    per_cell = []
    for cell in items.values():
        if cell.dimg_for != colour.id:
            continue
        aux = [it for it in items.values() if it.aux_for == cell.id and _alpha_urn(it)]
        if not aux:
            return None
        if len(aux) > 1 or aux[0].dimg_for:
            raise _grid_error(name, f"whose cell {cell.id} has {len(aux)} alpha items, or one that is a grid's cell")
        per_cell.append(aux[0])
    return per_cell


def _from_items(data: bytes, items: dict, primary, idat: bytes, name: str) -> dict:
    """The primary item and its alpha item (libavif's item source). A
    `grid` item's "color" (or "alpha") is a `_Grid`, else the AV1 bytes."""
    if primary is None or primary not in items:
        raise _Passed("no primary item (NO_CONTENT)")
    colour = items[primary]
    if colour.type == b"tmap":
        raise ValueError(f"{name}: a tmap primary item (an AVIF tone-mapped image); the port reads AVIF files of "
                         "av01 and grid items")
    if colour.type not in (b"av01", b"grid"):
        raise ValueError(f"{name}: a primary item of type {colour.type!r} (PIL: Failed to decode image)")
    if colour.unknown_essential or not sum(n for _, n in colour.extents):
        raise ValueError(f"{name}: a primary item with no data or an unknown essential property (libavif: "
                         "MISSING_IMAGE_ITEM; PIL: Failed to decode image)")
    _check_items(items)
    alpha = _alpha_item(items, colour, name)

    def source(it):
        if it.type == b"grid":
            return _grid(data, items, it, idat, name)
        if _prop(it, b"av1C") is None:
            raise _Passed("an av01 item without its av1C property (BMFF_PARSE_FAILED)")
        _check_pixi(it, _prop(it, b"av1C"))
        return _payload(data, idat, it)

    info = {"color": source(colour), "alpha": None, "nclx": None, "source": "item",
            "premultiplied": isinstance(alpha, _Item) and alpha.id in colour.refs.get(b"prem", []),
            "size": struct.unpack(">II", _prop(colour, b"ispe")[4:12])}
    if isinstance(alpha, list):  # an alpha item for each cell of the colour grid
        g = info["color"]
        info["alpha"] = _grid_cells(data, idat, g.rows, g.cols, g.width, g.height, alpha, name)
    elif alpha is not None:
        info["alpha"] = source(alpha)
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
        lib.gs_yuv_to_rgb.argtypes = [P, P, P, P, i, i, i, i, i, i, i, i, i, i, P, ctypes.c_char_p, i]
        lib.gs_yuv_to_rgb.restype = ctypes.c_int
        lib._gs_typed = True
    return lib


def decode_avif(data: bytes, name: str = "<bytes>", split: dict | None = None):
    """The `image_io.Picture` of AVIF bytes: PIL's mode ("RGB", or "RGBA"
    with an alpha item) and pixels. `split`, where given, receives the
    seconds of each step (`SPLIT_KEYS`, the AV1 steps summed over a grid's
    cells, and `GRID_KEY` for a grid)."""
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
    times = {SPLIT_KEYS[0]: time.perf_counter() - t0, **dict.fromkeys(AV1_KEYS, 0.0)}
    y, u, v, seq = _planes(info["color"], name, times, "colour")
    h, w = y.shape
    if not isinstance(info["color"], _Grid) and info["size"] is not None and info["size"] != (w, h):
        iw, ih = info["size"]
        where = "an item whose ispe" if info["source"] == "item" else "a track whose tkhd"
        raise ValueError(f"{name}: an AV1 frame of {w}x{h} in {where} says {iw}x{ih}")
    cp, mc, full = seq["cp"], seq["mc"], seq["full_range"]
    if info["nclx"] is not None:  # libavif: the container's colour description wins
        cp, _, mc, full = info["nclx"]
    a = None
    if info["alpha"] is not None:
        a, _, _, alpha_seq = _planes(info["alpha"], name, times, "alpha")
        what = "an alpha grid" if isinstance(info["alpha"], _Grid) else "an alpha item"
        if a.shape != y.shape:
            raise ValueError(f"{name}: {what} of {a.shape[1]}x{a.shape[0]} for a {w}x{h} image "
                             "(PIL: Failed to decode image)")
        if alpha_seq["depth"] != seq["depth"]:
            raise ValueError(f"{name}: {what} of {alpha_seq['depth']}-bit samples for a {seq['depth']}-bit image "
                             "(libavif: the alpha plane's depth is the colour's; PIL: Decoding of alpha plane failed)")
    t1 = time.perf_counter()
    out = np.empty((h, w, 4 if a is not None else 3), np.uint8)
    msg = ctypes.create_string_buffer(512)
    lib = _library(name)
    ptr = (lambda x: None if x is None else x.ctypes.data)
    if lib.gs_yuv_to_rgb(y.ctypes.data, ptr(u), ptr(v), ptr(a), w, h, seq["depth"], seq["mono"], seq["ss_x"],
                         seq["ss_y"], mc, cp, full, int(info["premultiplied"]), out.ctypes.data, msg, len(msg)):
        raise ValueError(f"{name}: {msg.value.decode()}; the port converts AVIF colour as libavif does for the "
                         "BT.601, BT.709 and BT.2020 matrices, identity, and 4:0:0")
    times[SPLIT_KEYS[-1]] = time.perf_counter() - t1
    if isinstance(info["color"], _Grid) and info["size"] != (w, h):
        out = _as_pil_sizes(out, info["size"], name)
    if split is not None:
        split.update(times)
    return Picture(out, "RGBA" if a is not None else "RGB")


def _as_pil_sizes(out, size, name):
    """PIL's picture where a grid's output size is not its `ispe`: PIL's
    size is the `ispe`, and its raw decoder reads that many rows of that
    many pixels from the front of libavif's RGB(A) buffer of the output
    size; where the buffer is too short, PIL's load raises."""
    iw, ih = size
    c = out.shape[2]
    flat = out.reshape(-1)
    if flat.size < iw * ih * c:
        raise ValueError(f"{name}: an AVIF grid of output {out.shape[1]}x{out.shape[0]} under an ispe of {iw}x{ih} "
                         "(PIL: image file is truncated)")
    return np.ascontiguousarray(flat[:iw * ih * c].reshape(ih, iw, c))


def _planes(item, name, times, what):
    """(Y, U, V, sequence info) of one AV1 item, or of a `_Grid`'s cells
    laid out as libavif's avifDecoderDataCopyTileToImage lays them out:
    each cell at (column x cell width, row x cell height), the right column
    and the bottom row cut to the output size (chroma to
    `(w + ss_x) >> ss_x`), with libavif's checks of the cells
    (INVALID_IMAGE_GRID). An alpha item's Y is widened to full range where
    its sequence header says limited, as libavif does, a grid's cell by
    cell. Adds the AV1 steps' seconds to `times`; a grid's copies under
    `GRID_KEY`."""
    def one(av1):
        part = {}
        y, u, v, seq = av1_planes(av1, name, part)
        for key in AV1_KEYS:
            times[key] += part[key]
        if what == "alpha" and not seq["full_range"]:
            # libavif's avifLimitedToFullY: (a - 16) * 255 / 219 rounded at 8 bits, (a - 64) * 1023 / 876 at
            # 10, (a - 256) * 4095 / 3504 at 12
            s = seq["depth"] - 8
            lo, span, top = 16 << s, 219 << s, (1 << seq["depth"]) - 1
            y = np.clip(((y.astype(np.int32) - lo) * top + span // 2) // span, 0, top).astype(y.dtype)
        return y, u, v, seq

    if not isinstance(item, _Grid):
        return one(item)

    def bad(rule):
        return ValueError(f"{name}: an AVIF {what} grid {rule} (libavif: INVALID_IMAGE_GRID; PIL: Failed to decode "
                          "image)")

    g, W, H = item, item.width, item.height
    keys = ("mono", "ss_x", "ss_y", "full_range", "cp", "tc", "mc", "depth") if what == "colour" else ("depth",)
    copy_s = 0.0
    for k, (av1, size) in enumerate(zip(g.cells, g.sizes)):
        y, u, v, seq = one(av1)
        ch, cw = y.shape
        if (cw, ch) != size:
            raise ValueError(f"{name}: a grid cell whose AV1 frame is {cw}x{ch} and its ispe {size[0]}x{size[1]} "
                             "(libavif scales it; the port reads cells of their ispe's size)")
        if k == 0:
            first, first_seq = (cw, ch), seq
            if cw * g.cols < W or ch * g.rows < H:
                raise bad(f"whose {g.rows}x{g.cols} cells of {cw}x{ch} do not cover its {W}x{H}")
            if cw * (g.cols - 1) >= W or ch * (g.rows - 1) >= H:
                raise bad(f"whose last row or column of {cw}x{ch} cells lies outside its {W}x{H}")
            if cw < 64 or ch < 64:
                raise bad(f"of {cw}x{ch} cells (libavif: at least 64x64)")
            odd = (seq["ss_x"] and (W % 2 or cw % 2)) or (seq["ss_y"] and (H % 2 or ch % 2))
            if what == "colour" and not seq["mono"] and odd:
                raise bad(f"of {cw}x{ch} cells in {W}x{H}, odd where the chroma is subsampled")
            sx, sy = seq["ss_x"], seq["ss_y"]
            Y = np.empty((H, W), y.dtype)
            U = V = None
            if u is not None:
                U, V = (np.empty(((H + sy) >> sy, (W + sx) >> sx), y.dtype) for _ in range(2))
        elif (cw, ch) != first or any(seq[key] != first_seq[key] for key in keys):
            raise bad(f"whose cell {k} differs from its first cell in size, subsampling, range, colour "
                      "description or bit depth (mismatched tiles)")
        t = time.perf_counter()
        r, c = divmod(k, g.cols)
        x0, y0 = c * cw, r * ch
        w, h = min(cw, W - x0), min(ch, H - y0)
        Y[y0:y0 + h, x0:x0 + w] = y[:h, :w]
        if U is not None:
            cx, cy, cwc, chc = x0 >> sx, y0 >> sy, (w + sx) >> sx, (h + sy) >> sy
            U[cy:cy + chc, cx:cx + cwc] = u[:chc, :cwc]
            V[cy:cy + chc, cx:cx + cwc] = v[:chc, :cwc]
        copy_s += time.perf_counter() - t
    times[GRID_KEY] = times.get(GRID_KEY, 0.0) + copy_s
    return Y, U, V, first_seq


def av1_planes(av1: bytes, name: str, times=None, tools=None):
    """(Y, U, V, info) of one AV1 image item: its planes (U and V None for
    4:0:0), uint8 at 8 bits and uint16 at 10 and 12, and its sequence
    header's colour description and bit depth ("depth"). `times`,
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
        raise ValueError(f"{name}: {msg.value.decode()}; {READS}")
    w, h, mono, sx, sy, depth = (int(v) for v in info[:6])
    if w * h > MAX_PIXELS:
        raise ValueError(f"{name}: an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    info[10], info[11], info[12] = w, h, depth
    dtype = np.uint8 if depth == 8 else np.uint16
    y = np.empty((h, w), dtype)
    cw, ch = (w + sx) >> sx, (h + sy) >> sy
    u = v = None
    if not mono:
        u, v = np.empty((ch, cw), dtype), np.empty((ch, cw), dtype)
    t = np.zeros(len(AV1_KEYS), np.float64)
    used = np.zeros(72, np.int32)
    if lib.gs_av1_decode(av1, len(av1), info.ctypes.data, y.ctypes.data, None if mono else u.ctypes.data,
                         None if mono else v.ctypes.data, t.ctypes.data, used.ctypes.data, msg, len(msg)):
        raise ValueError(f"{name}: {msg.value.decode()}; {READS}")
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
                     "mc": int(info[8]), "full_range": int(info[9]), "depth": depth}
