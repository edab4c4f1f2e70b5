"""JPEG decoding that gives PIL's pixels bit for bit.

The JAX package reads its datasets' images with PIL, which decodes JPEG
with libjpeg-turbo at its defaults. PIL is not installed where the port
runs, so the port keeps its own decoder in two forms:

- `csrc/jpeg_decode.cc`, compiled host C++ (built at first use by
  `utils/cuda_build.py`): what `decode_jpeg` and `read_jpeg` run;
- the plain version here, in Python and numpy, the specification the
  compiled one is held to: `decode_jpeg(data, plain=True)`. Nothing falls
  back to it.

Both follow libjpeg-turbo's C code at its defaults: Huffman-coded 8-bit
baseline, extended (SOF1) and progressive (SOF2) frames, interleaved and
non-interleaved scans, restart intervals; the integer "islow" IDCT
(jidctint.c) and its range-limit table; fancy upsampling of chroma at
ratios 2x1 (h2v1), 2x2 (h2v2) and 1x2 (h1v2), replication where
libjpeg-turbo uses it (h2v1 and h2v2 on components 2 or fewer samples
wide); jdcolor.c's fixed-point YCbCr -> RGB. The colour space follows
libjpeg-turbo's rule (jdapimin.c): one component is grey; three are RGB
under an Adobe marker with transform 0 or component ids 'R', 'G', 'B'
(without a JFIF marker), else YCbCr. The output is (H, W, C) uint8 with
C = 1 or 3, as `np.asarray(Image.open(f))` gives it (with C = 1 kept as
an axis, the layout of `image_io.read_png`). No EXIF rotation is applied:
PIL's `Image.open` applies none.

Every other form raises a `ValueError` naming the file and the feature:
arithmetic coding, lossless and hierarchical frames, precisions other
than 8 bits, 2 or 4 components, a height set by a DNL marker, other chroma
ratios, a progressive file whose scans leave coefficient bits out (where
libjpeg smooths the blocks), coefficients whose inverse DCT leaves the
range where libjpeg-turbo's SIMD IDCT (PIL's) and its C code agree,
truncated or corrupt data.
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
_ZZ = ZIGZAG.tolist()

SUPPORTED = ("the port reads Huffman-coded 8-bit baseline and progressive JPEGs with "
             "1 or 3 components")
# chroma ratios (largest factor / component's factor, across x down) with a
# path in libjpeg-turbo's upsampler that the port reproduces
RATIOS = ((1, 1), (2, 1), (2, 2), (1, 2))
MAX_DIMENSION = 65500  # JPEG_MAX_DIMENSION
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


# ---- Huffman tables ----------------------------------------------------------

def _huffman_lut(counts, symbols, is_dc: bool) -> list:
    """libjpeg's jpeg_make_d_derived_tbl as a 16-bit lookup: entry
    (length << 8) | symbol for every 16-bit window that starts with a code,
    0 where none does."""
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


# ---- the marker stream --------------------------------------------------------

class _Component:
    def __init__(self, index, cid, h, v, tq):
        self.index, self.id, self.h, self.v, self.tq = index, cid, h, v, tq
        self.quant = None  # latched at the component's first scan, as libjpeg does


class _Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.qt = [None] * 4
        self.huff = {}  # (0 DC / 1 AC, slot) -> (code counts per length, symbols)
        self.restart_interval = 0
        self.frame = None
        self.jfif = False
        self.adobe = None  # Adobe APP14 transform, when present

    # one marker segment at a time, as libjpeg's read_markers
    def run(self):
        data = self.data
        if data[:2] != b"\xff\xd8":
            raise _Refused("not a JPEG file (no SOI marker)")
        pos = 2
        while True:
            pos, marker = self._next_marker(pos)
            if marker == M_EOI:
                break
            if 0xD0 <= marker <= 0xD7 or marker == 0x01:
                continue  # standalone markers: stray RSTs are ignored as libjpeg does
            if marker == M_SOI:
                _corrupt("a second SOI marker")
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
                pos = self._sos(body, pos)
            elif marker == M_APP0:
                if len(body) >= 14 and body[:5] == b"JFIF\x00":
                    self.jfif = True
            elif marker == M_APP14:
                if len(body) >= 12 and body[:5] == b"Adobe":
                    self.adobe = body[11]
            elif not (0xE0 <= marker <= 0xEF or marker in (M_COM, M_DNL)):
                _corrupt(f"an unknown marker 0x{marker:02x}")
            # other APPn, COM and DNL segments are skipped, as libjpeg skips them
        if self.frame is None or not self.scans:
            _corrupt("no image data before EOI")
        return self._finish()

    def _next_marker(self, pos):
        """The next marker at `pos` (fill bytes 0xFF skipped); anything but a
        marker there is corrupt."""
        data = self.data
        if pos >= len(data):
            raise _Refused("truncated data")
        if data[pos] != 0xFF:
            _corrupt(f"a byte 0x{data[pos]:02x} where a marker belongs")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise _Refused("truncated data")
        return pos + 1, data[pos]

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
        comps = []
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                _corrupt(f"component {i}'s sampling factors or quantisation table")
            if any(c.id == cid for c in comps):
                _corrupt("two components with one id")
            comps.append(_Component(i, cid, h, v, tq))
        hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
        for c in comps:
            if hmax % c.h or vmax % c.v:
                raise _Refused(f"component {c.index}'s sampling factors {c.h}x{c.v} "
                               f"(a fractional chroma ratio)")
            if (hmax // c.h, vmax // c.v) not in RATIOS:
                raise _Refused(f"a {hmax // c.h}x{vmax // c.v} chroma subsampling ratio "
                               f"(component {c.index})")
        self.frame = (width, height, comps, hmax, vmax, marker == M_SOF2)
        self.mcux = -(-width // (8 * hmax))
        self.mcuy = -(-height // (8 * vmax))
        self.scans = 0
        for c in comps:
            c.bw = -(-(width * c.h) // hmax)  # samples: ceil(W h / hmax)
            c.bh = -(-(height * c.v) // vmax)
            c.nbx, c.nby = -(-c.bw // 8), -(-c.bh // 8)  # blocks a non-interleaved scan covers
            c.stride, c.rows = self.mcux * c.h, self.mcuy * c.v  # blocks the MCUs hold
            c.coef = [0] * (c.stride * c.rows * 64)
            c.bits = [-1] * 64  # progressive: the Al of each coefficient so far (-1: none)
            c.scanned = False

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
            size = 128 if pq else 64
            if tq > 3 or pq > 1 or p + 1 + size > len(body):
                _corrupt("a quantisation table")
            raw = np.frombuffer(body[p + 1:p + 1 + size], ">u2" if pq else np.uint8).astype(np.int64)
            table = np.zeros(64, np.int64)
            table[ZIGZAG] = raw
            self.qt[tq] = table
            p += 1 + size

    # ---- scans ----

    def _sos(self, body, pos):
        if self.frame is None:
            _corrupt("a scan before the frame header")
        width, height, comps, hmax, vmax, progressive = self.frame
        if len(body) < 1 or len(body) != 4 + 2 * body[0] or not 1 <= body[0] <= 4:
            _corrupt("a scan header")
        n = body[0]
        scomps, tables = [], []
        for i in range(n):
            cid, t = body[1 + 2 * i], body[2 + 2 * i]
            match = [c for c in comps if c.id == cid]
            if not match or match[0] in scomps:
                _corrupt(f"a scan of component id {cid}")
            scomps.append(match[0])
            tables.append((t >> 4, t & 15))
        ss, se, ah, al = body[1 + 2 * n], body[2 + 2 * n], body[3 + 2 * n] >> 4, body[3 + 2 * n] & 15
        if n > 1 and sum(c.h * c.v for c in scomps) > MAX_BLOCKS_IN_MCU:
            _corrupt(f"an MCU of more than {MAX_BLOCKS_IN_MCU} blocks")
        for c in scomps:
            if c.quant is None:
                if self.qt[c.tq] is None:
                    _corrupt(f"component {c.index} has no quantisation table")
                c.quant = self.qt[c.tq].copy()
        if progressive:
            self._check_progression(scomps, ss, se, ah, al)
        elif (ss, se, ah, al) != (0, 63, 0, 0):
            _corrupt("a sequential scan that is not 0..63 at full precision")
        elif any(c.scanned for c in scomps):
            _corrupt("a component in two sequential scans")
        for c in scomps:
            c.scanned = True
        end, segments = self._entropy_segments(pos)
        # per block of the scan in decoding order: the component's slot and
        # the block's first coefficient in its component's list
        if n == 1:
            c = scomps[0]
            bases = [(r * c.stride + x) * 64 for r in range(c.nby) for x in range(c.nbx)]
            order, per_mcu = [(0, b) for b in bases], 1
        else:
            order = []
            for my in range(self.mcuy):
                for mx in range(self.mcux):
                    for slot, c in enumerate(scomps):
                        for by in range(c.v):
                            row = (my * c.v + by) * c.stride + mx * c.h
                            order.extend((slot, (row + bx) * 64) for bx in range(c.h))
            per_mcu = sum(c.h * c.v for c in scomps)
        ri = self.restart_interval
        n_mcu = len(order) // per_mcu
        n_seg = -(-n_mcu // ri) if ri else 1
        if len(segments) < n_seg or any(segments[n_seg:]):
            _corrupt("restart markers that do not match the restart interval")
        blocks = per_mcu * (ri if ri else n_mcu)
        coefs = [c.coef for c in scomps]

        def lut(kind, slot):
            if (kind, slot) not in self.huff:
                _corrupt(f"a scan uses an undefined Huffman table {kind}/{slot}")
            return _huffman_lut(*self.huff[kind, slot], kind == 0)

        if not progressive or (ss == 0 and ah == 0):
            dc = [lut(0, t[0]) for t in tables]
        if not progressive:
            ac = [lut(1, t[1]) for t in tables]
        elif ss > 0:
            ac = lut(1, tables[0][1])
        for s in range(n_seg):
            seg = segments[s]
            part = order[s * blocks:(s + 1) * blocks]
            reader = _Bits(seg)
            if not progressive:
                _sequential(reader, part, coefs, dc, ac)
            elif ss == 0 and ah == 0:
                _dc_first(reader, part, coefs, dc, al)
            elif ss == 0:
                _dc_refine(reader, part, coefs, al)
            elif ah == 0:
                _ac_first(reader, part, coefs[0], ac, ss, se, al)
            else:
                _ac_refine(reader, part, coefs[0], ac, ss, se, al)
            reader.check_end()
        self.scans += 1
        return end

    def _check_progression(self, scomps, ss, se, ah, al):
        """jdphuff.c's start_pass checks; its warnings (a scan out of order)
        are refusals here."""
        if ss == 0 and se != 0 or ss > 0 and (ss > se or se > 63 or len(scomps) != 1):
            _corrupt(f"a progressive scan {ss}..{se} of {len(scomps)} components")
        if ah and al != ah - 1 or al > 13:
            _corrupt(f"a progressive scan with Ah {ah}, Al {al}")
        for c in scomps:
            if ss > 0 and c.bits[0] < 0:
                _corrupt("an AC scan before the component's DC scan")
            for k in range(ss, se + 1):
                if ah != max(c.bits[k], 0):
                    _corrupt("a progressive scan out of order")
                c.bits[k] = al

    def _entropy_segments(self, pos):
        """The scan's entropy-coded data from `pos` to the next marker that is
        not RSTn, split at its restart markers (checked to run D0, D1, ...),
        with stuffed bytes (0xFF 0x00) undone. Returns the end and the
        segments."""
        data = self.data
        segments, start, expect = [], pos, 0
        for m in _MARKER.finditer(data, pos):
            marker = m.group(1)[0]
            if 0xD0 <= marker <= 0xD7:
                if not self.restart_interval:
                    _corrupt("a restart marker without a restart interval")
                if marker != 0xD0 + expect:
                    _corrupt("a restart marker out of sequence")
                expect = (expect + 1) & 7
                segments.append(_STUFFED.sub(b"\xff", data[start:m.start()]))
                start = m.end()
                continue
            segments.append(_STUFFED.sub(b"\xff", data[start:m.start()]))
            return m.start(), segments
        raise _Refused("truncated data")

    # ---- reconstruction ----

    def _finish(self):
        width, height, comps, hmax, vmax, progressive = self.frame
        if progressive and any(b != 0 for c in comps for b in c.bits):
            raise _Refused("a progressive file whose scans leave coefficient bits out")
        for c in comps:
            if c.quant is None:
                _corrupt(f"component {c.index} has no scan")
        planes = []
        for c in comps:
            coef = np.array(c.coef, np.int64).reshape(-1, 64)
            # ISLOW_MULT_TYPE is a short: the table's entries wrap to 16 bits
            q = c.quant.astype(np.uint16).view(np.int16).astype(np.int64)
            pixels = idct_islow((coef * q).reshape(-1, 8, 8))
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


_MARKER = re.compile(rb"\xff+([^\x00\xff])")
_STUFFED = re.compile(rb"\xff+\x00")


# ---- entropy decoding ----------------------------------------------------------

class _Bits:
    """Bits of one entropy-coded segment, most significant first, read 32 at
    a time into an accumulator; zeros past the end, as libjpeg pads, but a
    segment whose decode reads past its end is corrupt (`check_end`)."""

    def __init__(self, seg: bytes):
        self.size = len(seg)
        pad = b"\x00" * (-len(seg) % 4 + 4)
        self.words = np.frombuffer(seg + pad, ">u4").astype(np.int64).tolist()
        # a refill past the data's words and one word of zeros is corrupt
        self.limit = len(self.words)
        self.acc, self.n, self.w = 0, 0, 0

    def save(self):
        return self.acc, self.n, self.w

    def load(self, state):
        self.acc, self.n, self.w = state

    def check_end(self):
        if self.w * 32 - self.n > 8 * self.size:
            _corrupt("entropy-coded data shorter than its blocks")

    def refill(self):
        if self.w >= self.limit:
            _corrupt("entropy-coded data shorter than its blocks")
        self.acc = ((self.acc & ((1 << self.n) - 1)) << 32) | self.words[self.w]
        self.w += 1
        self.n += 32

    def bits(self, s):
        if self.n < s:
            self.refill()
        self.n -= s
        return (self.acc >> self.n) & ((1 << s) - 1)

    def huff(self, lut):
        if self.n < 16:
            self.refill()
        e = lut[(self.acc >> (self.n - 16)) & 0xFFFF]
        if not e:
            _corrupt("a bad Huffman code")
        self.n -= e >> 8
        return e & 255


def _extend(v, s):
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _sequential(reader, part, coefs, dcs, acs):
    """Baseline / extended sequential blocks (jdhuff.c decode_mcu): the
    reader's methods inlined, the hot loop of a sequential file."""
    acc, n, w = reader.save()
    words, zz = reader.words, _ZZ
    nw = reader.limit
    preds = [0] * len(coefs)
    for slot, base in part:
        co, dclut, aclut = coefs[slot], dcs[slot], acs[slot]
        if n < 16:
            if w >= nw:
                _corrupt("entropy-coded data shorter than its blocks")
            acc = ((acc & ((1 << n) - 1)) << 32) | words[w]
            w += 1
            n += 32
        e = dclut[(acc >> (n - 16)) & 0xFFFF]
        if not e:
            _corrupt("a bad Huffman code")
        n -= e >> 8
        s = e & 255
        if s:
            if n < s:
                if w >= nw:
                    _corrupt("entropy-coded data shorter than its blocks")
                acc = ((acc & ((1 << n) - 1)) << 32) | words[w]
                w += 1
                n += 32
            n -= s
            v = (acc >> n) & ((1 << s) - 1)
            preds[slot] += v - (1 << s) + 1 if v < (1 << (s - 1)) else v
        co[base] = preds[slot]
        k = 1
        while k < 64:
            if n < 16:
                if w >= nw:
                    _corrupt("entropy-coded data shorter than its blocks")
                acc = ((acc & ((1 << n) - 1)) << 32) | words[w]
                w += 1
                n += 32
            e = aclut[(acc >> (n - 16)) & 0xFFFF]
            if not e:
                _corrupt("a bad Huffman code")
            n -= e >> 8
            rs = e & 255
            s = rs & 15
            if s:
                k += rs >> 4
                if k > 63:
                    _corrupt("a coefficient index over 63")
                if n < s:
                    if w >= nw:
                        _corrupt("entropy-coded data shorter than its blocks")
                    acc = ((acc & ((1 << n) - 1)) << 32) | words[w]
                    w += 1
                    n += 32
                n -= s
                v = (acc >> n) & ((1 << s) - 1)
                co[base + zz[k]] = v - (1 << s) + 1 if v < (1 << (s - 1)) else v
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break
    reader.load((acc, n, w))


def _dc_first(r, part, coefs, dcs, al):
    preds = [0] * len(coefs)
    for slot, base in part:
        s = r.huff(dcs[slot])
        if s:
            preds[slot] += _extend(r.bits(s), s)
        coefs[slot][base] = preds[slot] << al


def _dc_refine(r, part, coefs, al):
    for slot, base in part:
        if r.bits(1):
            coefs[slot][base] |= 1 << al


def _ac_first(r, part, co, lut, ss, se, al):
    eobrun = 0
    for _, base in part:
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            rs = r.huff(lut)
            run, s = rs >> 4, rs & 15
            if s:
                k += run
                if k > se:
                    _corrupt("a coefficient index past the scan's band")
                co[base + _ZZ[k]] = _extend(r.bits(s), s) << al
            elif run == 15:
                k += 15
            else:
                eobrun = (1 << run) - 1
                if run:
                    eobrun += r.bits(run)
                break
            k += 1


def _ac_refine(r, part, co, lut, ss, se, al):
    """jdphuff.c decode_mcu_AC_refine: new coefficients of +-1 << al and a
    correction bit for each coefficient already nonzero."""
    p1, m1 = 1 << al, -1 << al
    eobrun = 0
    for _, base in part:
        k = ss
        if not eobrun:
            while k <= se:
                rs = r.huff(lut)
                run, s = rs >> 4, rs & 15
                if s:
                    if s != 1:
                        _corrupt("a refinement coefficient of size over 1")
                    s = p1 if r.bits(1) else m1
                elif run != 15:
                    eobrun = 1 << run
                    if run:
                        eobrun += r.bits(run)
                    break
                while k <= se:
                    i = base + _ZZ[k]
                    if co[i]:
                        if r.bits(1) and not co[i] & p1:
                            co[i] += p1 if co[i] >= 0 else m1
                    else:
                        run -= 1
                        if run < 0:
                            break
                    k += 1
                if s:
                    if k > se:
                        _corrupt("a coefficient index past the scan's band")
                    co[base + _ZZ[k]] = s
                k += 1
        if eobrun:
            while k <= se:
                i = base + _ZZ[k]
                if co[i] and r.bits(1) and not co[i] & p1:
                    co[i] += p1 if co[i] >= 0 else m1
                k += 1
            eobrun -= 1


# ---- reconstruction ------------------------------------------------------------

CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100, FIX_0_765366865 = 2446, 3196, 4433, 6270
FIX_0_899976223, FIX_1_175875602, FIX_1_501321110, FIX_1_847759065 = 7373, 9633, 12299, 15137
FIX_1_961570560, FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16069, 16819, 20995, 25172


def _idct_1d(s):
    """jidctint.c's butterfly on the eight inputs s[0..7] (int64 arrays):
    the eight outputs before their descale."""
    z2, z3 = s[2], s[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 - z3 * FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (s[0] + s[4]) << CONST_BITS
    tmp1 = (s[0] - s[4]) << CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = s[7], s[5], s[3], s[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0, t1, t2, t3 = t0 * FIX_0_298631336, t1 * FIX_2_053119869, t2 * FIX_3_072711026, t3 * FIX_1_501321110
    z1, z2 = z1 * -FIX_0_899976223, z2 * -FIX_2_562915447
    z3, z4 = z3 * -FIX_1_961570560 + z5, z4 * -FIX_0_390180644 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


RANGE_REFUSAL = ("an inverse DCT sample outside -512..511 (where libjpeg-turbo's SIMD and C "
                 "IDCTs differ)")


def idct_islow(blocks: np.ndarray) -> np.ndarray:
    """libjpeg's jpeg_idct_islow of dequantised (N, 8, 8) int64 blocks
    (row = vertical frequency): columns, then rows, then the range-limit
    table indexed with RANGE_MASK. (N, 8, 8) uint8 samples.

    The table equals a clamp on -512..511, and PIL's build (the SIMD IDCT,
    16-bit arithmetic) gives neither beyond it: a sample there is refused.
    No encoder's output comes near it (binary noise at quality 1 peaks at
    378)."""
    cols = _idct_1d([blocks[:, k, :] for k in range(8)])
    ws = np.stack([_descale(c, CONST_BITS - PASS1_BITS) for c in cols], axis=1)
    rows = _idct_1d([ws[:, :, k] for k in range(8)])
    out = np.stack([_descale(r, CONST_BITS + PASS1_BITS + 3) for r in rows], axis=2)
    if out.size and (out.min() < -512 or out.max() > 511):
        raise _Refused(RANGE_REFUSAL)
    return RANGE_LIMIT[out & 1023]


def _range_limit() -> np.ndarray:
    """jdmaster.c's prepare_range_limit_table seen from IDCT_range_limit
    (sample_range_limit + CENTERJSAMPLE), for indexes 0..1023: x + 128 for
    x < 128, 255 to 511, 0 from 512, and x - 896 from 896."""
    x = np.arange(1024)
    return np.select([x < 128, x < 512, x < 896], [x + 128, 255, 0], x - 896).astype(np.uint8)


RANGE_LIMIT = _range_limit()


def upsample(plane: np.ndarray, hr: int, vr: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of one component's real samples (its
    MCU padding already cut) by (hr, vr) in (1, 2): h2v1 and h2v2 "fancy"
    (triangular) where the component is more than 2 samples wide, else
    replication; h1v2 always fancy. Edges take the nearest real sample."""
    x = plane.astype(np.int32)
    if (hr, vr) == (1, 1):
        return plane
    if hr == 2 and x.shape[1] <= 2:
        return np.repeat(np.repeat(plane, 2, axis=1), vr, axis=0)
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
