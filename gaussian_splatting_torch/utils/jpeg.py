"""JPEG decoding that gives PIL's pixels bit for bit.

The JAX package reads its datasets' images with PIL, which decodes JPEG
with libjpeg-turbo at its defaults. PIL is not installed where the port
runs, so the port keeps its own decoder in two forms:

- `csrc/jpeg_decode.cc`, compiled host C++ (built at first use by
  `utils/cuda_build.py`): what `decode_jpeg` and `read_jpeg` run;
- the plain version here, in Python and numpy, the specification the
  compiled one is held to: `decode_jpeg(data, plain=True)`. Nothing falls
  back to it.

The compiled decoder also reads the strips and tiles of a JPEG-in-TIFF as
libtiff reads them (`decode_tiff_jpeg`, which `utils/tiff.py` calls): the
JPEGTables stream first, no colour conversion. Beyond the plain version,
which stays as it is and refuses these by name, it reads 4-component
(CMYK and YCCK) files, arithmetic coding and lossless JPEG:

- arithmetic-coded sequential (SOF9) and progressive (SOF10) frames, as
  jdarith.c decodes them (T.81 Annex D's decoder with libjpeg's fixed 0.5
  state for AC signs and refinement bits, DAC conditioning that holds
  from where it is read until the next SOI; a bad arithmetic code leaves
  the rest of its restart interval undecoded, blocks zero in a sequential
  scan and as earlier scans left them in a progressive one), with the
  smoothing and the scan-order rules of the Huffman path. PIL hands
  libjpeg a file in 65536-byte blocks and libjpeg's arithmetic decoder
  cannot wait for the next: a scan whose data is not in the blocks read
  by the time it starts is refused, as PIL raises on it (in a 1080p view,
  past about quality 60 at 4:2:0). A JPEG-in-TIFF strip has no such limit:
  libtiff hands libjpeg the whole strip.
- lossless frames (SOF3, T.81 Annex H) as libjpeg-turbo 3 decodes them:
  predictors 1-7, point transforms 0-7, interleaved and one-component
  scans, restart intervals of whole MCU rows, replicated chroma (no fancy
  upsampling); no colour conversion, so three components are RGB unless
  a JFIF marker or an Adobe transform other than 0 says YCbCr, which is
  refused, as PIL raises on it.

Both follow libjpeg-turbo 3's C code at PIL's defaults: Huffman-coded
8-bit baseline, extended (SOF1) and progressive (SOF2) frames,
interleaved and non-interleaved scans, restart intervals; the integer
"islow" inverse DCT in the 16-bit arithmetic of its SIMD form (the one
PIL runs: products and some sums wrap to 16 bits, each pass saturates);
block smoothing of progressive files whose scans leave coefficient bits
out (jdcoefct.c's decompress_smooth_data, with its 5x5 neighbourhood of
DC values); fancy upsampling of chroma at ratios 2x1 (h2v1), 2x2 (h2v2)
and 1x2 (h1v2), replication for other integral ratios and where
libjpeg-turbo uses it (h2v1 and h2v2 on components 2 or fewer samples
wide); jdcolor.c's fixed-point YCbCr -> RGB. The colour space follows
libjpeg-turbo's rule (jdapimin.c): one component is grey; three are RGB
under an Adobe marker with transform 0 or component ids 'R', 'G', 'B'
(without a JFIF marker), else YCbCr. The output is (H, W, C) uint8 with
C = 1 or 3, as `np.asarray(Image.open(f))` gives it (with C = 1 kept as
an axis, the layout of `image_io.read_png`). No EXIF rotation is applied:
PIL's `Image.open` applies none.

Where libjpeg only warns, the decoders carry on as it does: bytes before
a marker are skipped (jdmarker.c next_marker); a bad Huffman code decodes
as symbol 0; a run past the last coefficient lands where libjpeg's padded
natural order puts it; entropy-coded data that ends early at a marker is
read as zeros for the rest of that MCU, and the rest of its restart
interval stays zero (jdhuff.c's insufficient_data); restart markers out
of sequence or missing take jpeg_resync_to_restart's three actions; a
progressive scan out of order, or a sequential scan that does not cover
0..63, is decoded as it stands.

Every other form raises a `ValueError` naming the file and the feature,
as PIL raises on it: hierarchical frames (SOF5-7, SOF13-15, DHP, EXP),
arithmetic-coded lossless ones (SOF11), precisions other than 8 bits, 2
components, a height set by a DNL marker, a fractional chroma ratio, an
image over PIL's decompression-bomb limit, truncated or corrupt data where
libjpeg stops with an error (the plain decoder also refuses arithmetic
coding, lossless frames and 4 components).
"""

from __future__ import annotations

import ctypes
import re

import numpy as np

from gaussian_splatting_torch.utils import cuda_build

# zig-zag scan position -> natural (row-major) index in the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])
# jutils.c's jpeg_natural_order: 16 extra entries of 63, where a corrupt
# run past the last coefficient lands
_NAT = ZIGZAG.tolist() + [63] * 16

SUPPORTED = ("the port reads the 8-bit JPEGs PIL reads: Huffman- and arithmetic-coded baseline and progressive, "
             "and lossless, with 1, 3 or 4 components (its plain decoder: Huffman-coded, 1 or 3 components)")
MAX_DIMENSION = 65500  # JPEG_MAX_DIMENSION
MAX_PIXELS = 2 * 89478485  # PIL raises DecompressionBombError past this
MAX_BLOCKS_IN_MCU = 10  # D_MAX_BLOCKS_IN_MCU

M_SOF0, M_SOF1, M_SOF2, M_DHT, M_DAC, M_SOI, M_EOI, M_SOS = 0xC0, 0xC1, 0xC2, 0xC4, 0xCC, 0xD8, 0xD9, 0xDA
M_DQT, M_DNL, M_DRI, M_DHP, M_EXP, M_APP0, M_APP14, M_COM = 0xDB, 0xDC, 0xDD, 0xDE, 0xDF, 0xE0, 0xEE, 0xFE


class _Refused(Exception):
    """A form the decoder does not read; the message names it."""


def _corrupt(what: str):
    raise _Refused(f"corrupt data: {what}")


def refusal(sof: int) -> str | None:
    """What a start-of-frame marker other than SOF0-2 is, for its refusal."""
    if sof == 3:
        return "lossless JPEG (SOF3)"
    if sof in (5, 6, 7):
        return f"hierarchical JPEG (SOF{sof})"
    if sof >= 9 and sof != 12:
        return f"arithmetic coding (SOF{sof})"
    return None


def _s16(x: int) -> int:
    """x as a JCOEF (a 16-bit short) holds it."""
    return ((x + 32768) & 0xFFFF) - 32768


# ---- Huffman tables ----------------------------------------------------------

def _huffman_lut(counts, symbols, is_dc: bool) -> list:
    """libjpeg's jpeg_make_d_derived_tbl as a 16-bit lookup: entry
    (length << 8) | symbol for every 16-bit window that starts with a code,
    0 where none does (a bad code: libjpeg reads 17 bits and decodes 0)."""
    if sum(counts) > 256:
        _corrupt("a Huffman table of more than 256 codes")
    lut = np.zeros(1 << 16, np.int32)
    code, p = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            sym = symbols[p]
            if is_dc and sym > 15:
                _corrupt("a DC Huffman symbol over 15")
            span = 16 - length
            lut[code << span:(code + 1) << span] = (length << 8) | sym
            code += 1
            p += 1
        if code >= (1 << length):
            _corrupt("a Huffman table whose codes overflow")
        code <<= 1
    return lut.tolist()


def _std_ac(head: str) -> list:
    rest = sorted(({0x00, 0xF0} | {r << 4 | s for r in range(16) for s in range(1, 11)}) - set(bytes.fromhex(head)))
    return list(bytes.fromhex(head)) + rest


# jstdhuff.c's tables (JPEG Annex K.3 to K.6), which libjpeg-turbo puts in
# Huffman slots 0 and 1 that no DHT has filled by the first scan
STD_HUFFMAN = {  # (0 DC / 1 AC, slot): (code counts of lengths 1..16, symbols)
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], _std_ac(
        "01020300041105122131410613516107227114328191a108234" "2b1c11552d1f02433627282090a16")),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], _std_ac(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f1")),
}


# ---- the marker stream --------------------------------------------------------

class _Component:
    def __init__(self, index, cid, h, v, tq):
        self.index, self.id, self.h, self.v, self.tq = index, cid, h, v, tq
        self.quant = None  # latched at the component's first scan, as libjpeg does


_MARKER = re.compile(rb"\xff+([^\x00\xff])")
_STUFFED = re.compile(rb"\xff+\x00")


class _Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.qt = [None] * 4
        self.huff = {}  # (0 DC / 1 AC, slot) -> (code counts per length, symbols)
        self.restart_interval = 0
        self.frame = None
        self.jfif = False
        self.adobe = None  # Adobe APP14 transform, when present
        self.scans = 0
        self.last_good = 0  # jdcoefct.c's last_good_iMCU_row
        self.image_done = False  # a single-scan file's scan is decoded

    def _marker_at(self, pos):
        """libjpeg's next_marker from `pos`: the first 0xFF run followed by
        a byte that is neither 0 nor 0xFF (anything before it is skipped,
        as extraneous data); a match object, or a refusal at the end."""
        m = _MARKER.search(self.data, pos)
        if m is None:
            raise _Refused("truncated data")
        return m

    def run(self):
        try:
            self._markers()
        except _Refused as e:
            # PIL ends a single-scan file once its rows are out: running out
            # of data while reading the markers after them is not an error
            if str(e) != "truncated data" or not self.image_done:
                raise
        return self._finish()

    def _stretch_end(self, pos):
        """The marker that ends the entropy-coded data from `pos`. Where none
        does, a multi-scan file is truncated (PIL reads all of its scans
        before any row); a single-scan file is decoded up to the end of the
        file, truncated only if libjpeg's read-ahead reaches it (None)."""
        m = _MARKER.search(self.data, pos)
        if m is None and self.multi:
            raise _Refused("truncated data")
        return m

    # one marker segment at a time, as libjpeg's read_markers
    def _markers(self):
        data = self.data
        if data[:3] != b"\xff\xd8\xff":
            raise _Refused("not a JPEG file (no SOI marker)")
        pos, marker = 2, None
        while True:
            if marker is None:  # libjpeg reads the next marker unless a scan stopped at one
                m = self._marker_at(pos)
                pos, marker = m.end(), m.group(1)[0]
            if marker == M_EOI:
                break
            if self.scans == 0 and marker < 0xC0:
                # PIL reads the header up to the first scan itself, and knows
                # no marker below 0xC0
                _corrupt(f"an unknown marker 0x{marker:02x}")
            if 0xD0 <= marker <= 0xD7 or marker == 0x01:
                marker = None  # standalone markers: ignored as libjpeg does
                continue
            if marker == M_SOI:
                _corrupt("a second SOI marker")
            if marker in (M_SOF0, M_SOF1, M_SOF2, M_DHT, M_DQT, M_DRI, M_SOS, M_DAC):
                if pos + 2 > len(data):
                    raise _Refused("truncated data")
                length = int.from_bytes(data[pos:pos + 2], "big")
                if length < 2:
                    _corrupt(f"a marker segment of length {length}")
                body = data[pos + 2:pos + length]
                if len(body) != length - 2:
                    raise _Refused("truncated data")
                pos += length
            if marker in (M_SOF0, M_SOF1, M_SOF2):
                self._sof(marker, body)
            elif 0xC0 <= marker <= 0xCF and refusal(marker - 0xC0):
                raise _Refused(refusal(marker - 0xC0))
            elif marker == M_DAC:
                raise _Refused("arithmetic coding (a DAC marker)")
            elif marker in (M_DHP, M_EXP):
                raise _Refused("hierarchical JPEG (a DHP or EXP marker)")
            elif marker == M_DHT:
                self._dht(body)
            elif marker == M_DQT:
                self._dqt(body)
            elif marker == M_DRI:
                if len(body) != 2:
                    _corrupt("a DRI segment whose length is not 4")
                self.restart_interval = int.from_bytes(body, "big")
            elif marker == M_SOS:
                pos, marker = self._sos(body, pos)
                self.image_done = not self.multi
                continue
            elif 0xE0 <= marker <= 0xEF or marker in (M_COM, M_DNL):
                # skipped (libjpeg's skip_variable and get_interesting_appn:
                # a length below 2 skips nothing past it)
                if pos + 2 > len(data):
                    raise _Refused("truncated data")
                length = int.from_bytes(data[pos:pos + 2], "big")
                body = data[pos + 2:pos + max(length, 2)]
                if len(body) != max(length, 2) - 2:
                    raise _Refused("truncated data")
                pos += max(length, 2)
                if marker == M_APP0 and len(body) >= 14 and body[:5] == b"JFIF\x00":
                    self.jfif = True
                elif marker == M_APP14 and len(body) >= 12 and body[:5] == b"Adobe":
                    self.adobe = body[11]
                if self.scans == 0 and len(body) < 7 and (
                        marker == M_APP0 and body[:4] == b"JFIF" or marker == M_APP14 and body[:5] == b"Adobe"):
                    _corrupt("a short JFIF or Adobe segment")  # PIL's header parser reads 7 bytes
            else:
                _corrupt(f"an unknown marker 0x{marker:02x}")
            marker = None
        if self.frame is None or not self.scans:
            _corrupt("no image data before EOI")

    def _sof(self, marker, body):
        if self.frame is not None:
            _corrupt("a second frame header")
        if len(body) < 6:
            _corrupt("a short frame header")
        precision = body[0]
        height, width, n = int.from_bytes(body[1:3], "big"), int.from_bytes(body[3:5], "big"), body[5]
        if precision != 8:
            raise _Refused(f"{precision}-bit samples")
        if len(body) != 6 + 3 * n:
            _corrupt("a frame header whose length does not match its components")
        if n not in (1, 3):
            raise _Refused(f"{n} colour components" + (" (CMYK or YCCK)" if n == 4 else ""))
        if height == 0:
            raise _Refused("a DNL height (0 in the frame header)")
        if width == 0:
            _corrupt("an image 0 samples wide")
        if max(width, height) > MAX_DIMENSION:
            raise _Refused(f"an image dimension over {MAX_DIMENSION}")
        if width * height > MAX_PIXELS:
            raise _Refused(f"an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
        comps = []
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4):
                _corrupt(f"component {i}'s sampling factors")
            comps.append(_Component(i, cid, h, v, tq))
        hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
        for c in comps:
            if hmax % c.h or vmax % c.v:
                raise _Refused(f"component {c.index}'s sampling factors {c.h}x{c.v} "
                               f"(a fractional chroma ratio)")
        self.frame = (width, height, comps, hmax, vmax, marker == M_SOF2)
        self.mcux = -(-width // (8 * hmax))
        self.mcuy = -(-height // (8 * vmax))
        for c in comps:
            c.bw = -(-(width * c.h) // hmax)  # samples: ceil(W h / hmax)
            c.bh = -(-(height * c.v) // vmax)
            c.nbx, c.nby = -(-c.bw // 8), -(-c.bh // 8)  # blocks a non-interleaved scan covers
            c.stride, c.rows = self.mcux * c.h, self.mcuy * c.v  # blocks the MCUs hold
            c.coef = [0] * (c.stride * c.rows * 64)
            c.bits = [-1] * 64  # progressive: the Al of each coefficient so far (-1: none)
            c.prev_bits = [-1] * 64  # the same before the component's latest scan

    def _dht(self, body):
        p = 0
        while p < len(body):
            if p + 17 > len(body):
                _corrupt("a short Huffman table")
            index = body[p]
            counts = list(body[p + 1:p + 17])
            n = sum(counts)
            if n > 256 or p + 17 + n > len(body):
                _corrupt("a Huffman table longer than its segment")
            kind, slot = index >> 4, index & 15
            if kind > 1 or slot > 3:
                _corrupt(f"a Huffman table index 0x{index:02x}")
            self.huff[kind, slot] = (counts, list(body[p + 17:p + 17 + n]))
            p += 17 + n

    def _dqt(self, body):
        p = 0
        while p < len(body):
            pq, tq = body[p] >> 4, body[p] & 15
            size = 128 if pq else 64  # any nonzero precision reads 16-bit entries
            if tq > 3 or p + 1 + size > len(body):
                _corrupt("a quantisation table")
            raw = np.frombuffer(body[p + 1:p + 1 + size], ">u2" if pq else np.uint8).astype(np.int64)
            table = np.zeros(64, np.int64)
            table[ZIGZAG] = raw
            self.qt[tq] = table
            p += 1 + size

    # ---- scans ----

    def _sos(self, body, pos):
        """One scan: its header, then its entropy-coded data as libjpeg reads
        it. Returns the position and the marker the marker reader goes on
        with (the one that ended the scan's data)."""
        if self.frame is None:
            _corrupt("a scan before the frame header")
        width, height, comps, hmax, vmax, progressive = self.frame
        if len(body) < 1 or len(body) != 4 + 2 * body[0] or not 1 <= body[0] <= 4:
            _corrupt("a scan header")
        n = body[0]
        scomps, tables = [], []
        for i in range(n):
            cid, t = body[1 + 2 * i], body[2 + 2 * i]
            # jdmarker.c get_sos's lookup: the first component with this id
            # whose index is not below the scan slot (it tests the scan list
            # at the component's index for a free entry)
            match = next((c for c in comps if c.id == cid and c.index >= i), None)
            if match is None or match in scomps:
                _corrupt(f"a scan of component id {cid}")
            scomps.append(match)
            tables.append((t >> 4, t & 15))
        ss, se, ah, al = body[1 + 2 * n], body[2 + 2 * n], body[3 + 2 * n] >> 4, body[3 + 2 * n] & 15
        if self.scans == 0:
            # jdinput.c initial_setup; jdhuff.c's std_huff_tables at the decoder's start
            self.multi = progressive or n < len(comps)
            if not progressive:
                for key, table in STD_HUFFMAN.items():
                    self.huff.setdefault(key, table)
        elif not self.multi:
            _corrupt("a second scan in a single-scan file")
        if n > 1 and sum(c.h * c.v for c in scomps) > MAX_BLOCKS_IN_MCU:
            _corrupt(f"an MCU of more than {MAX_BLOCKS_IN_MCU} blocks")
        for c in scomps:
            if c.quant is None:
                if c.tq > 3 or self.qt[c.tq] is None:
                    _corrupt(f"component {c.index} has no quantisation table")
                c.quant = self.qt[c.tq].copy()
        self.scans += 1
        if progressive:
            self._check_progression(scomps, ss, se, ah, al)

        def lut(kind, slot):
            if (kind, slot) not in self.huff:
                _corrupt(f"a scan uses an undefined Huffman table {kind}/{slot}")
            return _huffman_lut(*self.huff[kind, slot], kind == 0)

        if not progressive:
            dc, ac = [], []
            for t in tables:
                dc.append(lut(0, t[0]))
                ac.append(lut(1, t[1]))
        elif ss == 0 and ah == 0:
            dc = [lut(0, t[0]) for t in tables]
        elif ss > 0:
            ac = lut(1, tables[0][1])

        # per block of the scan in decoding order: the component's slot and
        # the block's first coefficient in its component's list
        if n == 1:
            c = scomps[0]
            bases = [(r * c.stride + x) * 64 for r in range(c.nby) for x in range(c.nbx)]
            order, per_mcu = [(0, b) for b in bases], 1
            mcu_row = [(r // c.v) for r in range(c.nby) for _ in range(c.nbx)]
        else:
            order = []
            for my in range(self.mcuy):
                for mx in range(self.mcux):
                    for slot, c in enumerate(scomps):
                        for by in range(c.v):
                            row = (my * c.v + by) * c.stride + mx * c.h
                            order.extend((slot, (row + bx) * 64) for bx in range(c.h))
            per_mcu = sum(c.h * c.v for c in scomps)
            mcu_row = [my for my in range(self.mcuy) for _ in range(self.mcux)]
        coefs = [c.coef for c in scomps]
        n_mcu = len(order) // per_mcu
        ri = self.restart_interval
        span = ri if ri else n_mcu

        data = self.data
        m = self._stretch_end(pos)  # the marker that ends the data the decoder reads
        pending = False  # whether the decoder stands at `m` (libjpeg's unread_marker)
        insufficient = False
        expect = 0  # next_restart_num
        for s, first in enumerate(range(0, n_mcu, span)):
            flag = insufficient  # last_good is set before a restart is processed
            if s:
                # process_restart: read_restart_marker, jpeg_resync_to_restart
                if m is None:
                    raise _Refused("truncated data")
                marker = m.group(1)[0]
                while True:
                    if marker == 0xD0 + expect:
                        action = 1
                    elif marker < 0xC0:
                        action = 2  # not a marker: scan on
                    elif not 0xD0 <= marker <= 0xD7:
                        action = 3  # a marker that is not RSTn: stay before it
                    elif marker in (0xD0 + ((expect + 1) & 7), 0xD0 + ((expect + 2) & 7)):
                        action = 3  # one of the next two restarts
                    elif marker in (0xD0 + ((expect - 1) & 7), 0xD0 + ((expect - 2) & 7)):
                        action = 2  # a restart already past
                    else:
                        action = 1
                    if action == 2:
                        m = self._marker_at(m.end())
                        marker = m.group(1)[0]
                        continue
                    break
                if action == 1:
                    pos, pending = m.end(), False
                    m = self._stretch_end(pos)
                    insufficient = False
                else:
                    pending = True
                expect = (expect + 1) & 7
            part = order[first * per_mcu:(first + span) * per_mcu]
            if m is None:  # a single-scan file whose data runs to its end
                reader = _TrackedBits(_STUFFED.sub(b"\xff", data[pos:].rstrip(b"\xff")))
                _sequential_tracked(reader, part, coefs, dc, ac)
                continue
            reader = _Bits(b"" if pending else _STUFFED.sub(b"\xff", data[pos:m.start()]))
            done = 0
            if not insufficient:
                if not progressive:
                    done = _sequential(reader, part, per_mcu, coefs, dc, ac)
                elif ss == 0 and ah == 0:
                    done = _dc_first(reader, part, per_mcu, coefs, dc, al)
                elif ss == 0:
                    done = _dc_refine(reader, part, per_mcu, coefs, al)
                elif ah == 0:
                    done = _ac_first(reader, part, coefs[0], ac, ss, se, al)
                else:
                    done = _ac_refine(reader, part, coefs[0], ac, ss, se, al)
                insufficient = reader.insufficient
            # jdcoefct.c consume_data sets last_good_iMCU_row before each MCU it starts
            # with data left: the interval's first MCU by the flag as it was
            # before the restart, the others while decoding went on
            if done >= 2:
                self.last_good = mcu_row[first + done - 1]
            elif not flag:
                self.last_good = mcu_row[first]
        if m is None:
            return len(data), None
        return m.end(), m.group(1)[0]

    def _check_progression(self, scomps, ss, se, ah, al):
        """jdphuff.c's start_pass: a bad band or successive-approximation
        pair is an error; a scan out of order is only a warning there, and
        decoded as it stands."""
        if ss == 0 and se != 0 or ss > 0 and (ss > se or se > 63 or len(scomps) != 1):
            _corrupt(f"a progressive scan {ss}..{se} of {len(scomps)} components")
        if ah and al != ah - 1 or al > 13:
            _corrupt(f"a progressive scan with Ah {ah}, Al {al}")
        for c in scomps:
            for k in range(min(ss, 1), max(se, 9) + 1):
                c.prev_bits[k] = c.bits[k] if self.scans > 1 else 0
            for k in range(ss, se + 1):
                c.bits[k] = al

    # ---- reconstruction ----

    def _finish(self):
        width, height, comps, hmax, vmax, progressive = self.frame
        smooth = progressive and _smoothing_ok(comps)
        planes = []
        for c in comps:
            coef = np.array(c.coef, np.int64).reshape(c.rows, c.stride, 64)
            if c.quant is None:  # a component no scan reached: libjpeg's zeroed multipliers
                quant = np.zeros(64, np.int64)
            else:
                quant = c.quant
                if smooth:
                    coef = _smooth(coef, c, quant, self.mcuy, self.last_good, self.scans)
            pixels = idct_islow(coef.reshape(-1, 64), quant)
            plane = pixels.reshape(c.rows, c.stride, 8, 8).transpose(0, 2, 1, 3)
            plane = plane.reshape(c.rows * 8, c.stride * 8)[:c.bh, :c.bw]
            planes.append(upsample(plane, hmax // c.h, vmax // c.v)[:height, :width])
        if len(comps) == 1:
            return planes[0][..., None]
        if self.jfif:
            rgb = False
        elif self.adobe is not None:
            rgb = self.adobe == 0
        else:
            rgb = [c.id for c in comps] == [82, 71, 66]  # 'R', 'G', 'B'
        if rgb:
            return np.stack(planes, axis=-1)
        return ycc_to_rgb(*planes)


# ---- entropy decoding ----------------------------------------------------------

# Zero words appended when a decode reads past a stretch's data: one MCU of
# at most 10 blocks, each at most 64 codes of 17 bits with 15 more, fits in
# them, and the decoders stop at the end of the MCU in which the data ran out.
_PAD_WORDS = 704


class _Bits:
    """Bits of one stretch of entropy-coded data, most significant first,
    read 32 at a time into an accumulator; zeros past the end, as libjpeg
    stuffs them after a marker. `insufficient` is set by `done_mcu` once
    an MCU has read past the data (jdhuff.c's insufficient_data)."""

    def __init__(self, seg: bytes):
        self.size = len(seg)
        pad = b"\x00" * (-len(seg) % 4 + 4)
        self.words = np.frombuffer(seg + pad, ">u4").astype(np.int64).tolist()
        self.acc, self.n, self.w = 0, 0, 0
        self.insufficient = False

    def save(self):
        return self.acc, self.n, self.w

    def load(self, state):
        self.acc, self.n, self.w = state

    def done_mcu(self) -> bool:
        """Whether the MCU just decoded read past the data."""
        self.insufficient = self.w * 32 - self.n > 8 * self.size
        return self.insufficient

    def refill(self):
        if self.w >= len(self.words):
            self.words.extend([0] * _PAD_WORDS)
        self.acc = ((self.acc & ((1 << self.n) - 1)) << 32) | self.words[self.w]
        self.w += 1
        self.n += 32

    def bits(self, s):
        if self.n < s:
            self.refill()
        self.n -= s
        return (self.acc >> self.n) & ((1 << s) - 1)

    def huff(self, lut):
        if self.n < 17:
            self.refill()
        e = lut[(self.acc >> (self.n - 16)) & 0xFFFF]
        if not e:  # a bad code: libjpeg's jpeg_huff_decode reads 17 bits, gives 0
            self.n -= 17
            return 0
        self.n -= e >> 8
        return e & 255


class _TrackedBits(_Bits):
    """`_Bits` over data that runs to the end of the file, with
    libjpeg-turbo's slow-path bit buffer beside it: a fill reads bytes
    until 57 bits are buffered, and one that reaches the end of the file
    suspends, which PIL reports as a truncated file."""

    def __init__(self, seg: bytes):
        super().__init__(seg)
        self.used, self.read = 0, 0  # bits consumed, bytes read

    def _need(self, k):
        if 8 * self.read - self.used < k:
            self.read = (self.used + 57 + 7) // 8
            if self.read > self.size:
                raise _Refused("truncated data")

    def bits(self, s):
        self._need(s)
        self.used += s
        return super().bits(s)

    def huff(self, lut):
        self._need(8)  # HUFF_DECODE's lookahead
        if self.n < 17:
            self.refill()
        e = lut[(self.acc >> (self.n - 16)) & 0xFFFF]
        length = e >> 8 if e else 17
        if length <= 8:
            self.used += length
        else:  # jpeg_huff_decode: 9 bits, then one at a time
            self._need(9)
            self.used += 9
            for _ in range(length - 9):
                self._need(1)
                self.used += 1
        return super().huff(lut)


def _sequential_tracked(r, part, coefs, dcs, acs):
    """`_sequential` through a `_TrackedBits` reader."""
    preds = [0] * len(coefs)
    for slot, base in part:
        co = coefs[slot]
        s = r.huff(dcs[slot])
        if s:
            preds[slot] += _extend(r.bits(s), s)
        co[base] = _s16(preds[slot])
        k = 1
        while k < 64:
            rs = r.huff(acs[slot])
            s = rs & 15
            if s:
                k += rs >> 4
                co[base + _NAT[k]] = _extend(r.bits(s), s)
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break


def _extend(v, s):
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _sequential(reader, part, per_mcu, coefs, dcs, acs) -> int:
    """Baseline / extended sequential blocks (jdhuff.c decode_mcu) of one
    restart interval; the number of MCUs decoded (the last one the one
    that ran out of data, if any). The reader's methods are inlined: this
    is the hot loop of a sequential file."""
    acc, n, w = reader.save()
    words, nat = reader.words, _NAT
    nw, end_bits = len(words), 8 * reader.size
    preds = [0] * len(coefs)
    done, bi = 0, 0
    for slot, base in part:
        co, dclut, aclut = coefs[slot], dcs[slot], acs[slot]
        if n < 17:
            if w >= nw:
                words.extend([0] * _PAD_WORDS)
                nw = len(words)
            acc = ((acc & ((1 << n) - 1)) << 32) | words[w]
            w += 1
            n += 32
        e = dclut[(acc >> (n - 16)) & 0xFFFF]
        if e:
            n -= e >> 8
            s = e & 255
        else:
            n -= 17
            s = 0
        if s:
            if n < s:
                if w >= nw:
                    words.extend([0] * _PAD_WORDS)
                    nw = len(words)
                acc = ((acc & ((1 << n) - 1)) << 32) | words[w]
                w += 1
                n += 32
            n -= s
            v = (acc >> n) & ((1 << s) - 1)
            preds[slot] += v - (1 << s) + 1 if v < (1 << (s - 1)) else v
        co[base] = ((preds[slot] + 32768) & 0xFFFF) - 32768
        k = 1
        while k < 64:
            if n < 17:
                if w >= nw:
                    words.extend([0] * _PAD_WORDS)
                    nw = len(words)
                acc = ((acc & ((1 << n) - 1)) << 32) | words[w]
                w += 1
                n += 32
            e = aclut[(acc >> (n - 16)) & 0xFFFF]
            if e:
                n -= e >> 8
                rs = e & 255
            else:
                n -= 17
                rs = 0
            s = rs & 15
            if s:
                k += rs >> 4
                if n < s:
                    if w >= nw:
                        words.extend([0] * _PAD_WORDS)
                        nw = len(words)
                    acc = ((acc & ((1 << n) - 1)) << 32) | words[w]
                    w += 1
                    n += 32
                n -= s
                v = (acc >> n) & ((1 << s) - 1)
                co[base + nat[k]] = v - (1 << s) + 1 if v < (1 << (s - 1)) else v
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break
        bi += 1
        if bi == per_mcu:
            bi = 0
            done += 1
            if w * 32 - n > end_bits:
                break
    reader.load((acc, n, w))
    reader.done_mcu()
    return done


def _dc_first(r, part, per_mcu, coefs, dcs, al) -> int:
    preds = [0] * len(coefs)
    done = 0
    for i, (slot, base) in enumerate(part):
        s = r.huff(dcs[slot])
        if s:
            preds[slot] += _extend(r.bits(s), s)
        coefs[slot][base] = _s16(preds[slot] << al)
        if (i + 1) % per_mcu == 0:
            done += 1
            if r.done_mcu():
                break
    return done


def _dc_refine(r, part, per_mcu, coefs, al) -> int:
    done = 0
    for i, (slot, base) in enumerate(part):
        if r.bits(1):
            coefs[slot][base] = _s16(coefs[slot][base] | 1 << al)
        if (i + 1) % per_mcu == 0:
            done += 1
            if r.done_mcu():
                break
    return done


def _ac_first(r, part, co, lut, ss, se, al) -> int:
    eobrun = 0
    done = 0
    for _, base in part:
        done += 1
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            rs = r.huff(lut)
            run, s = rs >> 4, rs & 15
            if s:
                k += run
                co[base + _NAT[k]] = _s16(_extend(r.bits(s), s) << al)
            elif run == 15:
                k += 15
            else:
                eobrun = (1 << run) - 1
                if run:
                    eobrun += r.bits(run)
                break
            k += 1
        if r.done_mcu():
            break
    return done


def _ac_refine(r, part, co, lut, ss, se, al) -> int:
    """jdphuff.c decode_mcu_AC_refine: new coefficients of +-1 << al and a
    correction bit for each coefficient already nonzero."""
    p1, m1 = 1 << al, -1 << al
    eobrun = 0
    done = 0
    for _, base in part:
        done += 1
        k = ss
        if not eobrun:
            while k <= se:
                rs = r.huff(lut)
                run, s = rs >> 4, rs & 15
                if s:  # a size other than 1 is only a warning
                    s = p1 if r.bits(1) else m1
                elif run != 15:
                    eobrun = 1 << run
                    if run:
                        eobrun += r.bits(run)
                    break
                while k <= se:
                    i = base + _NAT[k]
                    if co[i]:
                        if r.bits(1) and not co[i] & p1:
                            co[i] = _s16(co[i] + (p1 if co[i] >= 0 else m1))
                    else:
                        run -= 1
                        if run < 0:
                            break
                    k += 1
                if s:
                    co[base + _NAT[k]] = s
                k += 1
        if eobrun:
            while k <= se:
                i = base + _NAT[k]
                if co[i] and r.bits(1) and not co[i] & p1:
                    co[i] = _s16(co[i] + (p1 if co[i] >= 0 else m1))
                k += 1
            eobrun -= 1
        if r.done_mcu():
            break
    return done


# ---- block smoothing ------------------------------------------------------------

# jdcoefct.c's smoothing_ok / decompress_smooth_data: coefficients 1..9 in
# zig-zag order, their natural positions, and the 5x5 DC kernels (rows
# above to below, columns left to right) that estimate each one; the first
# set where the component has AC data, the second where it has none
# (change_dc), which also re-estimates the DC.
_SMOOTH_POS = [1, 8, 16, 9, 2, 3, 10, 17, 24]


_K_AC = np.array([
    [[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-7, 50, 0, -50, 7], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]],
    [[0, 0, -7, 0, 0], [0, 0, 50, 0, 0], [0, 0, 0, 0, 0], [0, 0, -50, 0, 0], [0, 0, 7, 0, 0]],
    [[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0], [0, 0, 13, 0, 0], [0, 0, -1, 0, 0]],
    [[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0, 0, 0, 0, 0], [1, -10, 0, 10, -1], [0, 1, 0, -1, 0]],
    [[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-1, 13, -24, 13, -1], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]],
], np.int64)
_K_DC = np.array([
    [[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3], [-3, 13, 0, -13, 3], [-1, -1, 0, 1, 1]],
    [[-1, -3, -3, -3, -1], [-1, 13, 38, 13, -1], [0, 0, 0, 0, 0], [1, -13, -38, -13, 1], [1, 3, 3, 3, 1]],
    [[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0], [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]],
    [[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0, 0, 0, 0, 0], [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]],
    [[0, 0, 0, 0, 0], [0, 2, -5, 2, 0], [1, 7, -14, 7, 1], [0, 2, -5, 2, 0], [0, 0, 0, 0, 0]],
    [[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, 2, 0, -2, 0], [0, 1, 0, -1, 0], [0, 0, 0, 0, 0]],
    [[0, 0, 0, 0, 0], [0, 1, -3, 1, 0], [0, 0, 0, 0, 0], [0, -1, 3, -1, 0], [0, 0, 0, 0, 0]],
    [[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, -3, 0, 3, 0], [0, 1, 0, -1, 0], [0, 0, 0, 0, 0]],
    [[0, 0, 0, 0, 0], [0, 1, 2, 1, 0], [0, 0, 0, 0, 0], [0, -1, -2, -1, 0], [0, 0, 0, 0, 0]],
], np.int64)
_K_DC00 = np.array([[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6], [-8, 42, 152, 42, -8], [-6, 6, 42, 6, -6],
                    [-2, -6, -8, -6, -2]], np.int64)


def _smoothing_ok(comps) -> bool:
    """jdcoefct.c smoothing_ok: every component has its quantisation table
    with DC and the first 9 AC steps nonzero and some DC data, and some
    component has coefficient bits 1..9 still missing."""
    useful = False
    for c in comps:
        if c.quant is None or any(c.quant[p] == 0 for p in [0] + _SMOOTH_POS) or c.bits[0] < 0:
            return False
        useful |= any(b != 0 for b in c.bits[1:10])
    return useful


def _smoothing_rows(n: int, v: int, n_imcu: int):
    """For each of a component's `n` real block rows (`v` to an iMCU row,
    `n_imcu` iMCU rows), the block rows decompress_smooth_data takes as the
    two above, itself and the two below. It places a row at iMCU row i,
    block row b as i * block_rows + b of block_rows * n_imcu, where
    block_rows counts the real rows of row i: the edge row stands in for
    a row off the image, except that in an iMCU row short of the last the
    row two below may be a padding row, and in a last iMCU row that has
    fewer real rows than `v` the count is off."""
    rows, last = [], n_imcu - 1
    for r in range(n):
        imcu, b = divmod(r, v)
        block_rows = v if imcu < last else (n % v or v)
        at, count = imcu * block_rows + b, block_rows * n_imcu
        p = r - 1 if at > 0 else r
        pp = r - 2 if at > 1 else p
        nx = r + 1 if at < count - 1 else r
        rows.append((pp, p, r, nx, r + 2 if at < count - 2 else nx))
    return rows


def _smoothing_columns(n: int):
    """The block columns it takes for each of `n`: the edge column where
    one is off the image."""
    return [[min(max(b + d, 0), n - 1) for d in (-2, -1, 0, 1, 2)] for b in range(n)]


def _smooth(coef, c, quant, n_imcu, last_good, scans):
    """decompress_smooth_data's estimates for the real blocks of one
    component: coef (rows, stride, 64) -> a smoothed copy."""
    out = coef.copy()
    nby, nbx = c.nby, c.nbx
    rows = np.array(_smoothing_rows(nby, c.v, n_imcu))  # (nby, 5)
    cols = np.array(_smoothing_columns(nbx))  # (nbx, 5)
    dc = coef[:, :, 0]
    grid = dc[rows[:, :, None, None], cols[None, None, :, :]]  # (nby, 5 rows, nbx, 5 cols)
    grid = grid.transpose(0, 2, 1, 3)  # (nby, nbx, 5, 5)
    prev = [b if scans > 1 else -1 for b in c.prev_bits]
    imcu = np.arange(nby) // c.v
    use_prev = imcu > last_good  # rows the last scan did not reach with data
    q = quant.astype(np.int64)
    work = out[:nby, :nbx]
    for latch, sel in ((c.bits, ~use_prev), (prev, use_prev)):
        if not sel.any():
            continue
        bits = latch[1:10]
        change_dc = all(b == -1 for b in bits)
        g = grid[sel]
        wsel = work[sel]
        kernels = _K_DC if change_dc else _K_AC
        for j, kern in enumerate(kernels):
            al = bits[j]
            pos = _SMOOTH_POS[j]
            if al == 0:
                continue
            num = q[0] * (g * kern).sum(axis=(-2, -1))
            qq = int(q[pos])
            pred = (((qq << 7) + np.abs(num)) // (qq << 8))
            if al > 0:
                pred = np.minimum(pred, (1 << al) - 1)
            pred = np.where(num >= 0, pred, -pred)
            wsel[..., pos] = np.where(wsel[..., pos] == 0, (pred + 32768) % 65536 - 32768, wsel[..., pos])
        if change_dc:
            num = q[0] * (g * _K_DC00).sum(axis=(-2, -1))
            q0 = int(q[0])
            pred = ((q0 << 7) + np.abs(num)) // (q0 << 8)
            pred = np.where(num >= 0, pred, -pred)
            wsel[..., 0] = (pred + 32768) % 65536 - 32768
        work[sel] = wsel
    return out


# ---- reconstruction ------------------------------------------------------------

CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100, FIX_0_765366865 = 2446, 3196, 4433, 6270
FIX_0_899976223, FIX_1_175875602, FIX_1_501321110, FIX_1_847759065 = 7373, 9633, 12299, 15137
FIX_1_961570560, FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16069, 16819, 20995, 25172


def _i16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def _descale(x, n):
    """(x + half) >> n of a 32-bit lane: the sum wraps to 32 bits first."""
    return ((((x + (1 << (n - 1))) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)) >> n


def _idct_pass(s, descale):
    """One pass of libjpeg-turbo's SIMD islow IDCT (jidctint-avx2.asm) on
    eight int16 inputs s[0..7] (int64 arrays): the butterfly's products in
    32 bits (pmaddwd), its sums in0 +- in4, in7 + in3 and in5 + in1 in 16
    bits, the rest in 32 bits, each output descaled and saturated to 16
    bits (packssdw)."""
    i0, i1, i2, i3, i4, i5, i6, i7 = s
    f054, f076, f184 = FIX_0_541196100, FIX_0_765366865, FIX_1_847759065
    tmp3 = i2 * (f054 + f076) + i6 * f054
    tmp2 = i2 * f054 + i6 * (f054 - f184)
    tmp0 = _i16(i0 + i4) << CONST_BITS
    tmp1 = _i16(i0 - i4) << CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    f117, f196, f039 = FIX_1_175875602, FIX_1_961570560, FIX_0_390180644
    f029, f089, f150 = FIX_0_298631336, FIX_0_899976223, FIX_1_501321110
    f205, f256, f307 = FIX_2_053119869, FIX_2_562915447, FIX_3_072711026
    z3, z4 = _i16(i7 + i3), _i16(i5 + i1)
    z3p = z3 * (f117 - f196) + z4 * f117
    z4p = z3 * f117 + z4 * (f117 - f039)
    t0 = i7 * (f029 - f089) - i1 * f089 + z3p
    t3 = i1 * (f150 - f089) - i7 * f089 + z4p
    t1 = i5 * (f205 - f256) - i3 * f256 + z4p
    t2 = i3 * (f307 - f256) - i5 * f256 + z3p
    outs = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return [np.clip(_descale(o, descale), -32768, 32767) for o in outs]


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's SIMD jsimd_idct_islow (PIL's) of (N, 64) JCOEF
    blocks (natural order, row = vertical frequency) with the 64 steps of
    `quant`: (N, 8, 8) uint8 samples. Dequantisation is a 16-bit product
    (pmullw, the steps wrapped to ISLOW_MULT_TYPE); a block whose rows 1..7
    are all zero takes the column pass's shortcut, DC << PASS1_BITS in 16
    bits; the row pass's outputs saturate to -128..127 before +128."""
    q = _i16(np.asarray(quant, np.int64)).reshape(8, 8)
    c = np.asarray(coef, np.int64).reshape(-1, 8, 8)
    deq = _i16(c * q)
    cols = _idct_pass([deq[:, k, :] for k in range(8)], CONST_BITS - PASS1_BITS)
    ws = np.stack(cols, axis=1)  # (N, row, column)
    dc_only = ~c[:, 1:, :].any(axis=(1, 2))
    ws[dc_only] = _i16(deq[dc_only, 0, :] << PASS1_BITS)[:, None, :]
    rows = _idct_pass([ws[:, :, k] for k in range(8)], CONST_BITS + PASS1_BITS + 3)
    out = np.stack(rows, axis=2)
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


def upsample(plane: np.ndarray, hr: int, vr: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of one component's real samples (its
    MCU padding already cut) by (hr, vr): h2v1 and h2v2 "fancy"
    (triangular) where the component is more than 2 samples wide, h1v2
    always fancy, replication for every other integral ratio (int_upsample)
    and for h2v1 / h2v2 on narrow components. Edges take the nearest real
    sample."""
    x = plane.astype(np.int32)
    if (hr, vr) == (1, 1):
        return plane
    fancy = (hr, vr) == (1, 2) or (hr, vr) in ((2, 1), (2, 2)) and x.shape[1] > 2
    if not fancy:
        return np.repeat(np.repeat(plane, hr, axis=1), vr, axis=0)
    if vr == 2:
        above = np.concatenate([x[:1], x[:-1]])
        below = np.concatenate([x[1:], x[-1:]])
        near3 = 3 * x
        if hr == 1:  # h1v2: (3 near + far + 1 or 2) >> 2
            out = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
            out[0::2] = (near3 + above + 1) >> 2
            out[1::2] = (near3 + below + 2) >> 2
            return out.astype(np.uint8)
        cols = np.empty((2 * x.shape[0], x.shape[1]), np.int32)  # h2v2's column sums
        cols[0::2] = near3 + above
        cols[1::2] = near3 + below
        left = np.concatenate([cols[:, :1], cols[:, :-1]], axis=1)
        right = np.concatenate([cols[:, 1:], cols[:, -1:]], axis=1)
        out = np.empty((cols.shape[0], 2 * cols.shape[1]), np.int32)
        out[:, 0::2] = (3 * cols + left + 8) >> 4
        out[:, 1::2] = (3 * cols + right + 7) >> 4
        return out.astype(np.uint8)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)  # h2v1
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out.astype(np.uint8)


def _color_tables():
    """jdcolor.c's build_ycc_rgb_table (SCALEBITS 16)."""
    one_half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128

    def fix(f):
        return int(f * (1 << 16) + 0.5)
    return ((fix(1.40200) * x + one_half) >> 16, (fix(1.77200) * x + one_half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + one_half)


CR_R, CB_B, CR_G, CB_G = _color_tables()


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert of uint8 planes: (H, W, 3) uint8."""
    y = y.astype(np.int64)
    r = y + CR_R[cr]
    g = y + ((CB_G[cb] + CR_G[cr]) >> 16)
    b = y + CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# ---- entry points --------------------------------------------------------------

def decode_jpeg(data: bytes, name: str = "<bytes>", plain: bool = False) -> np.ndarray:
    """(H, W, C) uint8 pixels of JPEG `data`, C = 1 or 3, PIL's bits. The
    compiled decoder unless `plain`; a form it does not read raises a
    `ValueError` naming `name` and the form."""
    data = bytes(data)
    if plain:
        try:
            return _Decoder(data).run()
        except _Refused as e:
            raise ValueError(f"{name}: {e}; {SUPPORTED}") from None
    return _decode_compiled(data, name)


def read_jpeg(path, plain: bool = False) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), str(path), plain)


def _library():
    lib = cuda_build.load_host("jpeg_decode")
    if not hasattr(lib, "_gs_typed"):
        lib.gs_jpeg_probe.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p]
        lib.gs_jpeg_probe.restype = ctypes.c_int
        lib.gs_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p,
                                       ctypes.c_longlong]
        lib.gs_jpeg_decode.restype = ctypes.c_int
        lib.gs_jpeg_decode_tiff.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char_p, ctypes.c_longlong,
                                            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p]
        lib.gs_jpeg_decode_tiff.restype = ctypes.c_int
        lib.gs_jpeg_raw_layout.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p]
        lib.gs_jpeg_raw_layout.restype = ctypes.c_int
        lib.gs_jpeg_decode_raw.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                                           ctypes.c_void_p]
        lib.gs_jpeg_decode_raw.restype = ctypes.c_int
        lib.gs_jpeg_error.argtypes = []
        lib.gs_jpeg_error.restype = ctypes.c_char_p
        lib._gs_typed = True
    return lib


def _decode_compiled(data: bytes, name: str) -> np.ndarray:
    lib = _library()
    shape = (ctypes.c_int * 3)()
    if lib.gs_jpeg_probe(data, len(data), ctypes.addressof(shape)):
        raise ValueError(f"{name}: {lib.gs_jpeg_error().decode()}; {SUPPORTED}")
    out = np.empty(tuple(shape), np.uint8)
    if lib.gs_jpeg_decode(data, len(data), out.ctypes.data, out.nbytes):
        raise ValueError(f"{name}: {lib.gs_jpeg_error().decode()}; {SUPPORTED}")
    return out


def decode_tiff_jpeg(tables: bytes, data: bytes, height: int, width: int, channels: int,
                     name: str = "<bytes>", ycbcr=None, last: bool = False) -> np.ndarray:
    """(height, width, channels) uint8: one strip or tile of a JPEG-in-TIFF
    (compression 7) as libtiff reads it for PIL, by the compiled decoder:
    the JPEGTables stream `tables` (b"": none) first, then the strip's
    abbreviated stream `data`; every component as decoded (no colour
    conversion, every component sampled 1x1), or with `ycbcr` = (h, v),
    a YCbCr frame whose first component is sampled (h, v) and the others
    1x1, converted to RGB (libtiff's JPEGCOLORMODE_RGB). `last`: the
    image's last strip, whose frame may be taller than its rows (libtiff
    reads the rows it needs). A frame that does not match the strip, and
    every form the decoder refuses, raise a `ValueError` naming `name`."""
    lib = _library()
    out = np.empty((height, width, channels), np.uint8)
    h, v = ycbcr or (0, 0)
    if lib.gs_jpeg_decode_tiff(tables, len(tables), data, len(data), height, width, channels, h, v, int(last),
                               out.ctypes.data):
        raise ValueError(f"{name}: {lib.gs_jpeg_error().decode()}")
    return out


def decode_raw(data: bytes, name: str = "<bytes>"):
    """libjpeg's raw data output of a JPEG stream, by the compiled decoder,
    as libtiff's old-style JPEG codec takes it: ([((h, v), plane), ...],
    good), each component's samples at its own sampling (h, v its sampling
    factors), whole blocks of whole MCU rows (the plane padded past the
    image as the IDCT fills it), no upsampling and no colour conversion;
    `good` the MCU rows delivered before a restart marker other than the
    one expected, at which libtiff's codec fails for good. Raises a
    `ValueError` naming `name` where the decoder refuses the stream."""
    lib = _library()
    layout = (ctypes.c_int * 19)()
    if lib.gs_jpeg_raw_layout(data, len(data), ctypes.addressof(layout)):
        raise ValueError(f"{name}: {lib.gs_jpeg_error().decode()}")
    n = layout[0]
    shapes = [(layout[3 + 4 * i], layout[4 + 4 * i], layout[6 + 4 * i], layout[5 + 4 * i]) for i in range(n)]
    out = np.empty(sum(ph * pw for _, _, ph, pw in shapes), np.uint8)
    good = ctypes.c_int(0)
    if lib.gs_jpeg_decode_raw(data, len(data), out.ctypes.data, out.nbytes, ctypes.addressof(good)):
        raise ValueError(f"{name}: {lib.gs_jpeg_error().decode()}")
    planes, at = [], 0
    for h, v, ph, pw in shapes:
        planes.append(((h, v), out[at:at + ph * pw].reshape(ph, pw)))
        at += ph * pw
    return planes, good.value
