"""A JPEG 2000 Part 1 encoder for tests (ITU-T T.800), numpy and the
standard library only.

PIL's writer (OpenJPEG's encoder driven by PIL) sets none of the Part 1
features that other encoders write: SOP and EPH markers, packed packet
headers (PPM, PPT), progression order changes (POC), the six code-block
styles, regions of interest (RGN) and component subsampling. This module
writes them, at small sizes (up to 64x64 in the tests) and for one
1920x1080 fixture, so that PIL's reading of each file is the rule the
port's decoder is held to:

- reversible 5/3 lifting (with the standard's symmetric extension and
  sample parities) and the RCT, DC level shift, 8-bit samples, guard bits
  and band exponents as OpenJPEG writes them (G = 2, e_b = 8 + gain);
- tier 1 (Annex D): the MQ coder (Annex C, OpenJPEG's termination rule:
  a final 0xFF is dropped), the significance, refinement and clean-up
  passes with their contexts, and each code-block style: BYPASS (raw
  passes after the fourth bit-plane's clean-up, bit-stuffed after 0xFF),
  RESET, TERMALL, VSC (stripe-causal contexts), PTERM and SEGSYM (the
  1010 symbol after each clean-up pass); segments end where the decoder's
  rule (opj_t2_init_seg's maxpasses) ends them;
- RGN maxshift per component: the coefficients of a rectangle scaled up by
  the shift;
- tier 2 (Annex B): tag trees, inclusion, zero bit-planes, pass counts,
  Lblock, a length per segment, bit stuffing, packets in any progression
  order, walked as opj_pi_next_* walk them, under a POC list in the main
  header and in a tile's first tile-part header (its entries after the
  main header's, as OpenJPEG reads them; each packet written once);
- quality layers given as the passes each layer carries (cumulative per
  code-block), a file made lossy by leaving passes out;
- tiles, tile offsets, image offsets, tile-parts;
- SOP / EPH markers, packet headers in PPM (main header) or PPT (tile-part
  headers) segments, split over several segments at any size;
- samples of 1 to 31 bits, unsigned or signed (Ssiz's sign bit, no DC
  level shift), and Part 2's MCT, MCC, MCO and CBD segments (ITU-T T.801)
  for marker edits.

`encode` returns a raw codestream; `torch_image_writers.jp2_bytes` puts
one in JP2 boxes.
"""

from __future__ import annotations

import functools
import os
import struct

import numpy as np

BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32
ALL_STYLES = 63
HT, HT_MIXED = 0x40, 0x80  # T.814's code-block style bits: HT code-blocks, and HT or Part 1 by code-block
ORDERS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
GUARD_BITS = 2

# ---- the MQ coder (Annex C) ----

MQ_TABLE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0), (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0),
    (0x0221, 38, 33, 0), (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0), (0x3801, 10, 14, 0),
    (0x3001, 11, 17, 0), (0x2401, 12, 18, 0), (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0), (0x3801, 19, 17, 0), (0x3401, 20, 18, 0),
    (0x3001, 21, 19, 0), (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0), (0x1C01, 25, 22, 0),
    (0x1801, 26, 23, 0), (0x1601, 27, 24, 0), (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0), (0x0521, 34, 31, 0), (0x0441, 35, 32, 0),
    (0x02A1, 36, 33, 0), (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0), (0x0085, 40, 37, 0),
    (0x0049, 41, 38, 0), (0x0025, 42, 39, 0), (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
)
QE = [t[0] for t in MQ_TABLE]
NMPS = [t[1] for t in MQ_TABLE]
NLPS = [t[2] for t in MQ_TABLE]
SWITCH = [t[3] for t in MQ_TABLE]
CTX_MAG, CTX_AGG, CTX_UNI, NCTX = 14, 17, 18, 19


def reset_contexts(state, mps):
    for k in range(NCTX):
        state[k], mps[k] = 0, 0
    state[CTX_UNI], state[CTX_AGG], state[0] = 46, 3, 4


class MQ:
    """The MQ encoder of one segment; the context states live outside it
    (they carry over from one segment to the next)."""

    def __init__(self, state, mps):
        self.state, self.mps = state, mps
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.out = bytearray(b"\0")  # the byte before the segment, dropped

    def _byteout(self):
        out = self.out
        if out[-1] == 0xFF:
            out.append((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        elif self.c < 0x8000000:
            out.append((self.c >> 19) & 0xFF)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            out[-1] += 1
            if out[-1] == 0xFF:
                self.c &= 0x7FFFFFF
                out.append((self.c >> 20) & 0xFF)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                out.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8

    def encode(self, d, cx):
        state, mps = self.state, self.mps
        s = state[cx]
        qe = QE[s]
        a = self.a - qe
        if d == mps[cx]:
            if a & 0x8000:
                self.a = a
                self.c += qe
                return
            if a < qe:
                a = qe
            else:
                self.c += qe
            state[cx] = NMPS[s]
        else:
            if a < qe:
                self.c += qe
            else:
                a = qe
            if SWITCH[s]:
                mps[cx] ^= 1
            state[cx] = NLPS[s]
        while True:
            a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if a & 0x8000:
                break
        self.a = a

    def numbytes(self) -> int:
        return len(self.out) - 1

    def flush(self) -> bytes:
        """Termination (C.2.9) as OpenJPEG's opj_mqc_flush: a last 0xFF is
        left out."""
        temp = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= temp:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        data = bytes(self.out[1:])
        return data[:-1] if data and data[-1] == 0xFF else data


class Raw:
    """The raw (bypass) coder of one segment: bits most significant first,
    7 in the byte after a 0xFF (OpenJPEG's opj_mqc_bypass_enc)."""

    def __init__(self):
        self.out, self.c, self.ct = bytearray(), 0, 8

    def bit(self, d):
        self.ct -= 1
        self.c |= d << self.ct
        if self.ct == 0:
            self.out.append(self.c)
            self.ct = 7 if self.c == 0xFF else 8
            self.c = 0

    def numbytes(self) -> int:
        return len(self.out)

    def flush(self) -> bytes:
        full = 7 if self.out and self.out[-1] == 0xFF else 8
        if self.ct < full:  # pad the open byte with 0, 1, 0, ...
            fill = 0
            while self.ct > 0:
                self.ct -= 1
                self.c |= fill << self.ct
                fill ^= 1
            self.out.append(self.c)
        elif self.out and self.out[-1] == 0xFF:  # a last 0xFF: the decoder reads 1s past the end anyway
            self.out.pop()
        return bytes(self.out)


# ---- tier 1 (Annex D) ----

NB_NW, NB_N, NB_NE, NB_W, NB_E, NB_SW, NB_S, NB_SE = (1 << k for k in range(8))
NEG_N, NEG_W, NEG_E, NEG_S = (1 << k for k in range(8, 12))
SIG, VISIT, REFINED, NB_ALL = 1 << 12, 1 << 13, 1 << 14, 0xFF


def _zc_table(orient):
    table = []
    for f in range(256):
        h = bool(f & NB_W) + bool(f & NB_E)
        v = bool(f & NB_N) + bool(f & NB_S)
        d = bool(f & NB_NW) + bool(f & NB_NE) + bool(f & NB_SW) + bool(f & NB_SE)
        if orient == 3:
            hv = h + v
            n = (8 if d >= 3 else (7 if hv >= 1 else 6) if d == 2 else (5 if hv >= 2 else 4 if hv == 1 else 3)
                 if d == 1 else (2 if hv >= 2 else hv))
        else:
            if orient == 1:
                h, v = v, h
            n = 8 if h == 2 else (7 if v >= 1 else 6 if d >= 1 else 5) if h == 1 else (
                4 if v == 2 else 3 if v == 1 else 2 if d >= 2 else d)
        table.append(n)
    return table


ZC = [_zc_table(o) for o in range(4)]


def _sc_table():
    table = []
    for f in range(4096):
        def contrib(sig, neg):
            return (-1 if f & neg else 1) if f & sig else 0
        h = max(-1, min(1, contrib(NB_W, NEG_W) + contrib(NB_E, NEG_E)))
        v = max(-1, min(1, contrib(NB_N, NEG_N) + contrib(NB_S, NEG_S)))
        if h == 0 and v == 0:
            ctx, x = 9, 0
        elif h == 0:
            ctx, x = 10, int(v < 0)
        else:
            ctx, x = (13 if h * v > 0 else 11 if h * v < 0 else 12), int(h < 0)
        table.append((ctx, x))
    return table


SC = _sc_table()  # indexed by a sample's flags & 0xFFF


class Block:
    """One code-block's coded passes: `segments` [(first pass, passes,
    bytes)], `cuts[n]` the bytes that carry the first n passes, `numbps` the
    bit-planes the decoder counts before the ROI shift; `ht_first`: an HT
    block's passes in its cleanup segment (placeholder passes and the
    cleanup pass), None for a Part 1 block."""

    def __init__(self, numbps, passes, segments, cuts, ht_first=None):
        self.numbps, self.passes, self.segments, self.cuts = numbps, passes, segments, cuts
        self.ht_first = ht_first


def max_passes(style: int, previous: int | None) -> int:
    """opj_t2_init_seg's maxpasses of a segment after one of `previous`."""
    if style & TERMALL:
        return 1
    if style & BYPASS:
        return 10 if previous is None else 2 if previous in (1, 10) else 1
    return 109


def encode_block(coeffs: np.ndarray, orient: int, style: int, roishift: int, keep: int | None) -> Block:
    """Tier 1 of one code-block of integer coefficients (magnitudes already
    scaled by any ROI shift): its passes, the first `keep` of them (None:
    all), in segments where the decoder ends them."""
    h, w = coeffs.shape
    mag = [int(v) for v in np.abs(coeffs).ravel()]
    negs = [int(v) for v in (coeffs < 0).ravel()]
    top = max(mag, default=0)
    k_total = top.bit_length()
    numbps = k_total - roishift
    total = max(0, 3 * k_total - 2)
    npasses = total if keep is None else min(keep, total)
    if npasses == 0:
        return Block(numbps, 0, [], [0])
    stride = w + 2
    flags = [0] * (stride * (h + 2))
    zc = ZC[orient]
    vsc = bool(style & VSC)
    state, mps = [0] * NCTX, [0] * NCTX
    reset_contexts(state, mps)
    coder = None
    segments, marks = [], []
    seg_first, seg_max, seg_passes, raw = 0, None, 0, False
    bp, passtype = k_total - 1, 2
    stripes = [(k, min(k + 4, h)) for k in range(0, h, 4)]

    def set_sig(i, y, neg):
        flags[i] |= SIG
        flags[i - 1] |= NB_E | (NEG_E if neg else 0)
        flags[i + 1] |= NB_W | (NEG_W if neg else 0)
        if not (vsc and y % 4 == 0):
            up = i - stride
            flags[up - 1] |= NB_SE
            flags[up] |= NB_S | (NEG_S if neg else 0)
            flags[up + 1] |= NB_SW
        down = i + stride
        flags[down - 1] |= NB_NE
        flags[down] |= NB_N | (NEG_N if neg else 0)
        flags[down + 1] |= NB_NW

    def sign(i, d, y, enc):
        neg = negs[d]
        ctx, x = SC[flags[i] & 0xFFF]
        enc(neg ^ x, ctx)
        set_sig(i, y, neg)

    for p in range(npasses):
        if coder is None:  # a new segment: its length and its coder, by the decoder's rules
            seg_max = max_passes(style, seg_max)
            seg_first, seg_passes = p, 0
            raw = bool(style & BYPASS) and passtype < 2 and bp + 1 <= numbps - 4  # the decoder's bpno_plus_one
            coder = Raw() if raw else MQ(state, mps)
        one = 1 << bp
        if raw:
            rbit = coder.bit
            if passtype == 0:
                for k0, k1 in stripes:
                    for x in range(w):
                        for y in range(k0, k1):
                            i = (y + 1) * stride + x + 1
                            f = flags[i]
                            if not f & (SIG | VISIT) and f & NB_ALL:
                                d = y * w + x
                                bit = 1 if mag[d] & one else 0
                                rbit(bit)
                                if bit:
                                    rbit(negs[d])
                                    set_sig(i, y, negs[d])
                                flags[i] |= VISIT
            else:
                for k0, k1 in stripes:
                    for x in range(w):
                        for y in range(k0, k1):
                            i = (y + 1) * stride + x + 1
                            if flags[i] & (SIG | VISIT) == SIG:
                                rbit(1 if mag[y * w + x] & one else 0)
                                flags[i] |= REFINED
        else:
            enc = coder.encode
            if passtype == 0:
                for k0, k1 in stripes:
                    for x in range(w):
                        for y in range(k0, k1):
                            i = (y + 1) * stride + x + 1
                            f = flags[i]
                            if not f & (SIG | VISIT) and f & NB_ALL:
                                d = y * w + x
                                bit = 1 if mag[d] & one else 0
                                enc(bit, zc[f & NB_ALL])
                                if bit:
                                    sign(i, d, y, enc)
                                flags[i] |= VISIT
            elif passtype == 1:
                for k0, k1 in stripes:
                    for x in range(w):
                        for y in range(k0, k1):
                            i = (y + 1) * stride + x + 1
                            f = flags[i]
                            if f & (SIG | VISIT) == SIG:
                                ctx = CTX_MAG + 2 if f & REFINED else CTX_MAG + 1 if f & NB_ALL else CTX_MAG
                                enc(1 if mag[y * w + x] & one else 0, ctx)
                                flags[i] |= REFINED
            else:
                mask = SIG | VISIT | NB_ALL
                for k0, k1 in stripes:
                    for x in range(w):
                        i0 = (k0 + 1) * stride + x + 1
                        y0 = k0
                        if k1 - k0 == 4 and not (flags[i0] & mask or flags[i0 + stride] & mask
                                                 or flags[i0 + 2 * stride] & mask or flags[i0 + 3 * stride] & mask):
                            run = next((r for r in range(4) if mag[(k0 + r) * w + x] & one), 4)
                            if run == 4:
                                enc(0, CTX_AGG)
                                continue
                            enc(1, CTX_AGG)
                            enc(run >> 1, CTX_UNI)
                            enc(run & 1, CTX_UNI)
                            sign(i0 + run * stride, (k0 + run) * w + x, k0 + run, enc)
                            y0 = k0 + run + 1
                        for y in range(y0, k1):
                            i = (y + 1) * stride + x + 1
                            f = flags[i]
                            if not f & (SIG | VISIT):
                                d = y * w + x
                                bit = 1 if mag[d] & one else 0
                                enc(bit, zc[f & NB_ALL])
                                if bit:
                                    sign(i, d, y, enc)
                for k in range(len(flags)):
                    flags[k] &= ~VISIT
                if style & SEGSYM:
                    for s in (1, 0, 1, 0):
                        enc(s, CTX_UNI)
        if style & RESET and not raw:
            reset_contexts(state, mps)
        seg_passes += 1
        if seg_passes == seg_max or p == npasses - 1:
            segments.append((seg_first, seg_passes, coder.flush()))
            marks.append((len(segments) - 1, None))
            coder = None
        else:
            marks.append((len(segments), coder.numbytes()))
        passtype += 1
        if passtype == 3:
            passtype, bp = 0, bp - 1
    # the bytes that carry the first n passes: a segment's end, or inside a
    # segment the bytes written and 3 more (OpenJPEG's rate estimate)
    starts = [0]
    for _, _, payload in segments:
        starts.append(starts[-1] + len(payload))
    cuts = [0]
    for s, nb in marks:
        size = len(segments[s][2])
        cuts.append(max(cuts[-1], starts[s] + (size if nb is None else min(nb + 3, size))))
    return Block(numbps, npasses, segments, cuts)


# ---- the HT block coder (ITU-T T.814) ----

HT_VLC_TABLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "gaussian_splatting_torch",
                             "csrc", "ht_vlc_tables.h")
MEL_EXPONENTS = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)  # T.814's MEL_E, by state


@functools.cache
def ht_vlc_decoding_tables() -> tuple:
    """The port's CxtVLC decoding tables (csrc/ht_vlc_tables.h): for the
    first line pair and the others, 1024 entries (context << 7 | 7 VLC
    bits) of length | u_off << 3 | rho << 4 | e_1 << 8 | e_k << 12."""
    with open(HT_VLC_TABLES) as f:
        text = f.read()
    tables = []
    for name in ("HT_VLC_TABLE0", "HT_VLC_TABLE1"):
        body = text.split(f"{name}[1024] = {{", 1)[1].split("};", 1)[0]
        tables.append(tuple(int(v, 16) for v in body.replace(",", " ").split()))
    return tuple(tables)


@functools.cache
def ht_vlc_encoding_tables() -> tuple:
    """The inverse of the decoding tables, by enumeration: for each table,
    {(context, rho, emb): (codeword, length, e_k)}, emb being the samples
    whose exponent reaches the quad's bound (0: u_off 0). Among the
    codewords a quad may take (e_1 = emb & e_k) the one with the most e_k
    bits, as OpenJPH's encoder picks; each is checked to decode to itself."""
    out = []
    for table in ht_vlc_decoding_tables():
        words = {}  # (context, rho, u_off, e_k, e_1) -> (codeword, length)
        for cx in range(8):
            for bits in range(128):
                e = table[cx << 7 | bits]
                n = e & 7
                words.setdefault((cx, e >> 4 & 15, e >> 3 & 1, e >> 12 & 15, e >> 8 & 15), (bits & ((1 << n) - 1), n))
        enc = {}
        for (cx, rho, u_off, e_k, e_1), (cwd, n) in words.items():
            for emb in range(16):
                if emb & ~rho or (emb == 0) != (u_off == 0) or emb & e_k != e_1:
                    continue
                best = enc.get((cx, rho, emb))
                if best is None or bin(e_k).count("1") >= bin(best[2]).count("1"):
                    enc[(cx, rho, emb)] = (cwd, n, e_k)
        for (cx, rho, emb), (cwd, n, e_k) in enc.items():
            e = table[cx << 7 | cwd]
            assert e & 7 == n and e >> 4 & 15 == rho and e >> 12 & 15 == e_k and e >> 8 & 15 == emb & e_k
        assert all((cx, rho, emb) in enc for cx in range(8) for rho in range(16) for emb in range(16)
                   if not emb & ~rho and (cx or rho)), "a quad with no codeword"
        out.append(enc)
    return tuple(out)


class _Mel:
    """The MEL coder: bits most significant first, 7 in the byte after 0xFF."""

    def __init__(self):
        self.buf, self.tmp, self.remaining, self.run, self.k = bytearray(), 0, 8, 0, 0

    def bit(self, v):
        self.tmp = self.tmp << 1 | v
        self.remaining -= 1
        if self.remaining == 0:
            self.buf.append(self.tmp)
            self.remaining = 7 if self.tmp == 0xFF else 8
            self.tmp = 0

    def event(self, v):
        e = MEL_EXPONENTS[self.k]
        if not v:
            self.run += 1
            if self.run == 1 << e:
                self.bit(1)
                self.run, self.k = 0, min(self.k + 1, 12)
            return
        self.bit(0)
        for b in range(e - 1, -1, -1):
            self.bit(self.run >> b & 1)
        self.run, self.k = 0, max(self.k - 1, 0)


class _Backward:
    """A stream written from its end (VLC, MagRef): bits least significant
    first; after a byte above 0x8F the next holds 7 bits where they are all
    ones. `buf` holds the bytes last first."""

    def __init__(self, first=None):
        if first is None:  # MagRef: as if after a byte above 0x8F
            self.buf, self.tmp, self.used, self.gt8f = bytearray(), 0, 0, True
        else:  # VLC: the segment's last byte, and a first nibble of 0xF under the VLC's first bits
            self.buf, self.tmp, self.used, self.gt8f = bytearray([first]), 0xF, 4, True

    def put(self, cwd, n):
        while n > 0:
            avail = 8 - self.gt8f - self.used
            t = min(avail, n)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used, avail, n, cwd = self.used + t, avail - t, n - t, cwd >> t
            if avail == 0:
                if self.gt8f and self.tmp != 0x7F:
                    self.gt8f = False  # an eighth bit
                    continue
                self.buf.append(self.tmp)
                self.gt8f, self.tmp, self.used = self.tmp > 0x8F, 0, 0

    def flush(self) -> bytes:
        if self.used:
            self.buf.append(self.tmp)
            self.tmp = self.used = 0
        return bytes(self.buf[::-1])


class _Forward:
    """A stream written from its start (MagSgn, SigProp): bits least
    significant first, 7 in the byte after 0xFF."""

    def __init__(self):
        self.buf, self.tmp, self.used, self.max = bytearray(), 0, 0, 8

    def put(self, cwd, n):
        while n > 0:
            t = min(self.max - self.used, n)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used, cwd, n = self.used + t, cwd >> t, n - t
            if self.used >= self.max:
                self.buf.append(self.tmp)
                self.max, self.tmp, self.used = 7 if self.tmp == 0xFF else 8, 0, 0

    def flush(self, fill) -> bytes:
        """The stream, its last byte's free bits set to `fill` (the decoder
        reads 0xFF past MagSgn's end and 0 past SigProp's); a MagSgn byte
        of 0xFF at the end is left out."""
        if self.used:
            self.tmp |= ((1 << (self.max - self.used)) - 1) << self.used if fill else 0
            if not (fill and self.tmp == 0xFF):
                self.buf.append(self.tmp)
        elif fill and self.max == 7:
            self.buf.pop()
        return bytes(self.buf)


def _uvlc(u):
    """u's prefix (codeword, length) and suffix (value, length), T.814 Table 3."""
    if u == 1:
        return (1, 1), (0, 0)
    if u == 2:
        return (2, 2), (0, 0)
    if u <= 4:
        return (4, 3), (u - 3, 1)
    if u <= 32:  # u_ext (u above 32) is not written: OpenJPEG 2.5 does not read it
        return (0, 3), (u - 5, 5)
    raise ValueError(f"u_q {u} needs T.814's u_ext")


def _exponent(mu):
    return (2 * mu - 1).bit_length() if mu else 0


def ht_cleanup(mu: np.ndarray, neg: np.ndarray) -> bytes:
    """The HT cleanup pass of one code-block's magnitudes `mu` at its
    cleanup bit-plane (signs `neg`): MagSgn forward, then MEL forward and
    VLC backward, Scup in the last 12 bits; the quads in line pairs, their
    contexts, exponent bounds and UVLC codes by the decoder's rules."""
    h, w = mu.shape
    mu, neg = mu.tolist(), neg.tolist()
    enc0, enc1 = ht_vlc_encoding_tables()
    mel, vlc, ms = _Mel(), _Backward(0xFF), _Forward()
    exps = [[_exponent(m) for m in row] for row in mu]

    def sample(x, y):
        return mu[y][x] if x < w and y < h else 0

    def prev(x, y):  # (significance, exponent) of row y - 1's column x
        return (mu[y - 1][x] > 0, exps[y - 1][x]) if 0 <= x < w else (False, 0)

    for y in range(0, h, 2):
        first = y == 0
        enc, c_q = (enc0 if first else enc1), 0
        for x in range(0, w, 4):
            quads = []
            for qx in (x, x + 2):
                if qx >= w or (qx > x and x + 2 >= w):
                    break
                pos = [(qx, y), (qx, y + 1), (qx + 1, y), (qx + 1, y + 1)]
                ms_ = [sample(px, py) for px, py in pos]
                rho = sum(1 << n for n in range(4) if ms_[n])
                if first:
                    cx, kappa = c_q, 1
                    c_q = (rho & 1 | rho >> 1 & 1) | (rho >> 2 & 1) << 1 | (rho >> 3 & 1) << 2
                else:
                    nb = [prev(qx + d, y) for d in (-1, 0, 1, 2)]
                    cx = c_q | (nb[0][0] | nb[1][0]) | (nb[2][0] | nb[3][0]) << 2
                    gamma = bin(rho).count("1") > 1
                    kappa = max(1, max(e for _, e in nb) - 1) if gamma else 1
                    c_q = (rho >> 2 & 1 | rho >> 3 & 1) << 1
                e_n = [_exponent(m) for m in ms_]
                big_u = max(max(e_n), kappa) if rho else 0
                u = big_u - kappa if rho else 0
                emb = sum(1 << n for n in range(4) if u and e_n[n] == big_u)
                e_k = 0
                if cx == 0:
                    mel.event(rho != 0)
                if cx or rho:
                    cwd, n, e_k = enc[(cx, rho, emb)]
                    vlc.put(cwd, n)
                quads.append((rho, u, big_u, e_k, pos))
            u0 = quads[0][1]
            u1 = quads[1][1] if len(quads) > 1 else 0
            if u0 and u1:
                if first:
                    both = u0 > 2 and u1 > 2
                    mel.event(both)
                    if both:
                        u0, u1 = u0 - 2, u1 - 2
                    elif u0 > 2:
                        (p0, s0) = _uvlc(u0)
                        vlc.put(*p0)
                        vlc.put(u1 - 1, 1)
                        vlc.put(*s0)
                        u0 = u1 = 0
                if u0:
                    (p0, s0), (p1, s1) = _uvlc(u0), _uvlc(u1)
                    for code in (p0, p1, s0, s1):
                        vlc.put(*code)
            elif u0 or u1:
                p, s = _uvlc(u0 or u1)
                vlc.put(*p)
                vlc.put(*s)
            for rho, _, big_u, e_k, pos in quads:
                for n, (px, py) in enumerate(pos):
                    if rho >> n & 1:
                        m = big_u - (e_k >> n & 1)
                        ms.put(2 * (mu[py][px] - 1) + neg[py][px], m)
    # MEL and VLC meet in one byte where their bits do not overlap (OpenJPH's terminate_mel_vlc)
    if mel.run:
        mel.bit(1)
    mel_tmp = (mel.tmp << mel.remaining) & 0xFF
    mel_mask, vlc_mask = (0xFF << mel.remaining) & 0xFF, 0xFF >> (8 - vlc.used)
    if mel_mask | vlc_mask:
        fuse = mel_tmp | vlc.tmp
        if not ((fuse ^ mel_tmp) & mel_mask | (fuse ^ vlc.tmp) & vlc_mask) and fuse != 0xFF and len(vlc.buf) > 1:
            mel.buf.append(fuse)
        else:
            mel.buf.append(mel_tmp)
            vlc.buf.append(vlc.tmp)
    scup = len(mel.buf) + len(vlc.buf)
    if scup > 4079:
        raise ValueError(f"Scup {scup} above 4079")
    out = bytearray(ms.flush(True) + bytes(mel.buf) + bytes(vlc.buf[::-1]))
    out[-1] = scup >> 4
    out[-2] = (out[-2] & 0xF0) | (scup & 0xF)
    return bytes(out)


# the significance a newly significant sample of row r (0-3) of a column
# passes on, in 4-bit columns: below it, and rows r - 1 to r + 1 of the next
SIGPROP_SPREAD = (0x32, 0x74, 0xE8, 0xC0)


def ht_refinement(mag: np.ndarray, neg: np.ndarray, plane: int, passes: int, causal: bool) -> bytes:
    """The HT refinement segment of one code-block: SigProp (forward)
    and, with `passes` 3, MagRef (backward) at bit-plane `plane` - 1 of
    the magnitudes `mag`, the cleanup pass having coded bit-planes from
    `plane` up. Stripes of 4 rows, 8 columns a 32-bit word (a nibble a
    column): the candidates, their order and the signs after each 4
    columns as OpenJPEG's decoder walks them (VSC: `causal`)."""
    h, w = mag.shape
    sig = (mag >> plane) > 0
    bit = ((mag >> (plane - 1)) & 1).astype(bool)
    groups, stripes = (w + 7) // 8 + 1, (h + 3) // 4
    full = 0xFFFFFFFF

    def words(a, s):
        out = [0] * (groups + 1)
        for y in range(4 * s, min(4 * s + 4, h)):
            for x in range(w):
                if a[y, x]:
                    out[x // 8] |= 1 << (4 * (x % 8) + y - 4 * s)
        return out

    sigs = [words(sig, s) for s in range(stripes)] + [[0] * (groups + 1)]
    sp = _Forward()
    prop = [0] * (groups + 1)  # the membership the previous stripe passes down
    for s in range(stripes):
        cur, nxt = sigs[s], sigs[s + 1]
        rows = min(4, h - 4 * s)
        pattern = (0x11111111, 0x33333333, 0x77777777, full)[rows - 1]
        mbr, prev, nprev = [0] * (groups + 1), 0, 0
        for g in range((w + 7) // 8):
            t = cur[g] | prev >> 28 | (cur[g] << 4) & full | cur[g] >> 4 | (cur[g + 1] << 28) & full
            prev = cur[g]
            z = t | (t & 0x77777777) << 1 | (t & 0xEEEEEEEE) >> 1
            mbr[g] = z & ~cur[g] & full | prop[g]
            t = nxt[g] | nprev >> 28 | (nxt[g] << 4) & full | nxt[g] >> 4 | (nxt[g + 1] << 28) & full
            nprev = nxt[g]
            if not causal:
                mbr[g] |= (t & 0x11111111) << 3
            mbr[g] &= ~cur[g] & full
        prop = [0] * (groups + 1)
        for g in range((w + 7) // 8):
            m, new = mbr[g] & pattern, 0
            inv = ~cur[g] & pattern
            if m:
                for n in (0, 4):
                    end = min(n + 4, w - 8 * g)
                    for j in range(n, end):
                        for r in range(4):
                            mask = 1 << (4 * j + r)
                            if m & mask:
                                b = bool(bit[4 * s + r, 8 * g + j])
                                sp.put(int(b), 1)
                                if b:
                                    new |= mask
                                    m |= (SIGPROP_SPREAD[r] << (4 * j)) & inv
                    for j in range(n, end):
                        for r in range(4):
                            if new & (1 << (4 * j + r)):
                                sp.put(int(neg[4 * s + r, 8 * g + j]), 1)
                    if n == 4:
                        t = new >> 28
                        t |= (t & 0xE) >> 1 | (t & 7) << 1
                        mbr[g + 1] |= t & ~cur[g + 1] & full
            new |= cur[g]
            ux = (new & 0x88888888) >> 3
            tx = (ux | ux << 4 | ux >> 4) & full
            if g > 0:
                prop[g - 1] |= (ux << 28) & ~nxt[g - 1] & full
            prop[g] |= tx & ~nxt[g] & full
            prop[g + 1] |= ux >> 28 & ~nxt[g + 1]
    out = sp.flush(False)
    if passes < 3:
        return out
    mr = _Backward()
    for s in range(stripes):
        for g in range((w + 7) // 8):
            word = sigs[s][g]
            for j in range(8):
                for r in range(4):
                    if word >> (4 * j + r) & 1:
                        mr.put(int(bit[4 * s + r, 8 * g + j]), 1)
    return out + mr.flush()


def encode_ht_block(coeffs: np.ndarray, plane: int, passes: int, style: int, placeholders: int = 0) -> Block:
    """One HT code-block of integer coefficients: the cleanup pass at
    bit-plane `plane` and, with `passes` 2 or 3, the refinement segment
    (SigProp, MagRef) one plane below; `numbps` such that the zero
    bit-plane tag tree codes K - 1 - plane (OpenJPEG places the cleanup
    there), less `placeholders`, whose three empty passes each are counted
    before the cleanup pass. A block with nothing significant at `plane`
    has no pass."""
    mag = np.abs(coeffs).astype(np.int64)
    neg = (coeffs < 0).astype(np.int64)
    mu = mag >> plane
    if not mu.any():
        return Block(plane + 1, 0, [], [0])
    cleanup = ht_cleanup(mu, neg)
    segments = [(0, 3 * placeholders + 1, cleanup)]
    if passes > 1:
        if plane < 1:
            raise ValueError("HT refinement passes need a cleanup plane above 0")
        segments.append((3 * placeholders + 1, passes - 1,
                         ht_refinement(mag, neg, plane, passes, bool(style & VSC))))
    total = sum(len(s[2]) for s in segments)
    cuts = [0] * (3 * placeholders + 1) + [len(cleanup)] + [total] * (passes - 1)
    return Block(plane + 1 + placeholders, 3 * placeholders + passes, segments, cuts, 3 * placeholders + 1)


# ---- the 5/3 wavelet (F.4.8.2) ----

def _fwd53_1d(x: np.ndarray, i0: int):
    """Forward 5/3 lifting along axis 0 of `x` (first sample at absolute
    index i0): (low-pass, high-pass) arrays."""
    n = x.shape[0]
    if n == 1:
        return (x.copy(), x[:0]) if i0 % 2 == 0 else (x[:0], 2 * x)
    xp = np.pad(x, [(2, 2)] + [(0, 0)] * (x.ndim - 1), mode="reflect").astype(np.int64)
    par = (np.arange(-2, n + 2) + i0) % 2
    y = xp.copy()
    for p in range(1, n + 3):
        if par[p] == 1:
            y[p] = xp[p] - np.floor_divide(xp[p - 1] + xp[p + 1], 2)
    for p in range(1, n + 3):
        if par[p] == 0:
            y[p] = xp[p] + np.floor_divide(y[p - 1] + y[p + 1] + 2, 4)
    y = y[2:n + 2]
    par = par[2:n + 2]
    return y[par == 0], y[par == 1]


# OpenJPEG's inverse 9/7 constants (csrc/jp2_decode.cc): the low-pass
# samples scaled by K, the high-pass by 2 / K, then four lifting steps
K97, TWO_INV_K97 = 1.230174105, 1.625732422
LIFT97 = (-0.443506852, -0.882911075, 0.052980118, 1.586134342)


def _fwd97_1d(x: np.ndarray, i0: int):
    """Forward 9/7 along axis 0 of `x` (first sample at absolute index
    i0), in float64: the exact inverse of OpenJPEG's inverse transform
    (its lifting steps undone in reverse order, its scales divided out).
    (low-pass, high-pass) arrays."""
    n = x.shape[0]
    y = x.astype(np.float64).copy()
    if n == 1:
        return (y, y[:0]) if i0 % 2 == 0 else (y[:0], y)
    cas = i0 % 2
    left = [p - 1 if p > 0 else p + 1 for p in range(n)]
    right = [p + 1 if p + 1 < n else p - 1 for p in range(n)]
    for s in (3, 2, 1, 0):
        for p in range(cas if s % 2 == 0 else 1 - cas, n, 2):
            y[p] = y[p] - (y[left[p]] + y[right[p]]) * LIFT97[s]
    low = np.arange(n) % 2 == cas
    y[low] /= K97
    y[~low] /= TWO_INV_K97
    return y[low], y[~low]


def forward_dwt(a: np.ndarray, x0: int, y0: int, levels: int, irreversible: bool = False):
    """The tile-component `a` (rows, columns; its first sample at (x0, y0))
    in `levels` decompositions (5/3 in integers, or 9/7 in float64): [LL,
    (HL, LH, HH) of resolution 1, ...]."""
    one = _fwd97_1d if irreversible else _fwd53_1d
    bands = []
    cur, u0, v0 = a.astype(np.float64 if irreversible else np.int64), x0, y0
    for _ in range(levels):
        lo_v, hi_v = one(cur, v0) if cur.shape[0] else (cur, cur)
        ll, hl = (one(lo_v.T, u0) if lo_v.shape[1] else (lo_v.T, lo_v.T))
        lh, hh = (one(hi_v.T, u0) if hi_v.shape[1] else (hi_v.T, hi_v.T))
        bands.append((hl.T, lh.T, hh.T))
        cur, u0, v0 = ll.T, -(-u0 // 2), -(-v0 // 2)
    return [cur] + bands[::-1]


# ---- geometry (B.5 - B.7), as opj_tcd_init_tile ----

def ceildiv(a, b):
    return -(-a // b)


def ceilpow2(a, n):
    return -(-a >> n)


class Codeblock:
    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.block = None


class Precinct:
    def __init__(self):
        self.cw = self.ch = 0
        self.blocks = []


class Band:
    def __init__(self, bandno, x0, y0, x1, y1, numbps):
        self.bandno, self.x0, self.y0, self.x1, self.y1, self.numbps = bandno, x0, y0, x1, y1, numbps
        self.precincts = []

    def empty(self):
        return self.x1 <= self.x0 or self.y1 <= self.y0


class Resolution:
    def __init__(self):
        self.bands = []


def tile_component(tx0, ty0, tx1, ty1, dx, dy, levels, cblk, precincts, gains_expn, guard=GUARD_BITS):
    """Resolutions, bands, precincts and code-blocks of one
    tile-component: (x0, y0, x1, y1, [Resolution])."""
    tcx0, tcy0, tcx1, tcy1 = ceildiv(tx0, dx), ceildiv(ty0, dy), ceildiv(tx1, dx), ceildiv(ty1, dy)
    numres = levels + 1
    out = []
    step = 0
    for r in range(numres):
        res = Resolution()
        level = numres - 1 - r
        res.x0, res.y0 = ceilpow2(tcx0, level), ceilpow2(tcy0, level)
        res.x1, res.y1 = ceilpow2(tcx1, level), ceilpow2(tcy1, level)
        pdx, pdy = precincts[r]
        res.pdx, res.pdy = pdx, pdy
        px0, py0 = (res.x0 >> pdx) << pdx, (res.y0 >> pdy) << pdy
        px1, py1 = ceilpow2(res.x1, pdx) << pdx, ceilpow2(res.y1, pdy) << pdy
        res.pw = 0 if res.x0 == res.x1 else (px1 - px0) >> pdx
        res.ph = 0 if res.y0 == res.y1 else (py1 - py0) >> pdy
        if r == 0:
            cbgx0, cbgy0, cbgw, cbgh, nb = px0, py0, pdx, pdy, 1
        else:
            cbgx0, cbgy0, cbgw, cbgh, nb = ceilpow2(px0, 1), ceilpow2(py0, 1), pdx - 1, pdy - 1, 3
        cbw, cbh = min(cblk[0], cbgw), min(cblk[1], cbgh)
        for b in range(nb):
            if r == 0:
                bandno = 0
                bx0, by0, bx1, by1 = res.x0, res.y0, res.x1, res.y1
            else:
                bandno = b + 1
                xb, yb = bandno & 1, bandno >> 1
                bx0 = ceilpow2(tcx0 - (xb << level), level + 1)
                by0 = ceilpow2(tcy0 - (yb << level), level + 1)
                bx1 = ceilpow2(tcx1 - (xb << level), level + 1)
                by1 = ceilpow2(tcy1 - (yb << level), level + 1)
            expn = gains_expn[bandno]
            band = Band(bandno, bx0, by0, bx1, by1, expn + guard - 1)
            band.step = step
            step += 1
            res.bands.append(band)
            if band.empty():
                continue
            for k in range(res.pw * res.ph):
                pr = Precinct()
                gx0 = cbgx0 + (k % res.pw) * (1 << cbgw)
                gy0 = cbgy0 + (k // res.pw) * (1 << cbgh)
                prx0, pry0 = max(gx0, band.x0), max(gy0, band.y0)
                prx1, pry1 = min(gx0 + (1 << cbgw), band.x1), min(gy0 + (1 << cbgh), band.y1)
                bx0_, by0_ = (prx0 >> cbw) << cbw, (pry0 >> cbh) << cbh
                bx1_, by1_ = ceilpow2(prx1, cbw) << cbw, ceilpow2(pry1, cbh) << cbh
                pr.cw, pr.ch = max(0, (bx1_ - bx0_) >> cbw), max(0, (by1_ - by0_) >> cbh)
                for j in range(pr.cw * pr.ch):
                    x = bx0_ + ((j % pr.cw) << cbw)
                    y = by0_ + ((j // pr.cw) << cbh)
                    pr.blocks.append(Codeblock(max(x, prx0), max(y, pry0), min(x + (1 << cbw), prx1),
                                               min(y + (1 << cbh), pry1)))
                band.precincts.append(pr)
        out.append(res)
    return (tcx0, tcy0, tcx1, tcy1, out)


# ---- tier 2 (Annex B) ----

class Bits:
    """Packet-header bits (opj_bio_write): 7 bits in the byte after 0xFF;
    flushed to a byte, with one more byte after a final 0xFF."""

    def __init__(self):
        self.out, self.buf, self.ct = bytearray(), 0, 8

    def put(self, bit):
        if self.ct == 0:
            self._byteout()
        self.ct -= 1
        self.buf |= bit << self.ct

    def _byteout(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        self.out.append(self.buf >> 8)

    def write(self, value, n):
        for k in range(n - 1, -1, -1):
            self.put((value >> k) & 1)

    def flush(self) -> bytes:
        self._byteout()
        if self.ct == 7:
            self._byteout()
        return bytes(self.out)


class TagTree:
    def __init__(self, w, h):
        self.parent, sizes, first = [], [(w, h)], [0]
        total = 0
        while True:
            lw, lh = sizes[-1]
            total += lw * lh
            if lw * lh <= 1:
                break
            sizes.append(((lw + 1) // 2, (lh + 1) // 2))
            first.append(total)
        self.parent = [-1] * total
        for lv in range(len(sizes) - 1):
            lw, lh = sizes[lv]
            nw = sizes[lv + 1][0]
            for j in range(lh):
                for i in range(lw):
                    self.parent[first[lv] + j * lw + i] = first[lv + 1] + (j // 2) * nw + i // 2
        self.value = [999] * total
        self.low = [0] * total
        self.known = [False] * total

    def set(self, leaf, value):
        node = leaf
        while node >= 0 and self.value[node] > value:
            self.value[node] = value
            node = self.parent[node]

    def encode(self, bits: Bits, leaf, threshold):
        path, node = [], leaf
        while self.parent[node] >= 0:
            path.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bits.put(1)
                        self.known[node] = True
                    break
                bits.put(0)
                low += 1
            self.low[node] = low
            if not path:
                break
            node = path.pop()


def _passes_code(bits: Bits, n):
    if n == 1:
        bits.put(0)
    elif n == 2:
        bits.write(0b10, 2)
    elif n <= 5:
        bits.write(0b1100 | (n - 3), 4)
    elif n <= 36:
        bits.write((0b1111 << 5) | (n - 6), 9)
    else:
        bits.write((0b111111111 << 7) | (n - 37), 16)


class PrecinctState:
    """What tier 2 remembers of one precinct of one band between its packets."""

    def __init__(self, pr: Precinct, passes_by_layer):
        self.pr = pr
        self.incl = TagTree(pr.cw, pr.ch) if pr.blocks else None
        self.imsb = TagTree(pr.cw, pr.ch) if pr.blocks else None
        self.layers = passes_by_layer  # per block: cumulative passes at the end of each layer
        self.sent = [0] * len(pr.blocks)  # passes sent so far
        self.lblock = [3] * len(pr.blocks)
        self.segmax = [None] * len(pr.blocks)  # per block: [maxpasses of each segment so far]
        if pr.blocks:
            for k, cb in enumerate(pr.blocks):
                first = next((L for L, n in enumerate(self.layers[k]) if n > 0), 999)
                self.incl.set(k, first)
                if cb.block.passes:
                    self.imsb.set(k, cb.band_numbps - cb.block.numbps)


def _segments_of(style, first_pass, npasses, segmax: list):
    """The pass counts that passes [first_pass, first_pass + npasses) of a
    block put in each of the decoder's segments; `segmax` holds the
    maxpasses of each segment opened so far (extended here)."""
    pieces = []
    p, end = first_pass, first_pass + npasses
    while p < end:
        total, s = 0, 0  # the segment holding pass p
        while True:
            if s == len(segmax):
                segmax.append(max_passes(style, segmax[-1] if segmax else None))
            if p < total + segmax[s]:
                break
            total += segmax[s]
            s += 1
        n = min(end, total + segmax[s]) - p
        pieces.append(n)
        p += n
    return pieces


def packet(states: list, layer: int, style: int):
    """One packet of the bands' precinct states at `layer`: (header,
    body)."""
    bits = Bits()
    blocks_in = []
    any_data = any(st.layers[k][layer] > st.sent[k] for st in states if st.pr.blocks
                   for k in range(len(st.pr.blocks)))
    if not any_data:
        bits.put(0)
        return bits.flush(), b""
    bits.put(1)
    for st in states:
        if not st.pr.blocks:
            continue
        for k, cb in enumerate(st.pr.blocks):
            target = st.layers[k][layer]
            new = target - st.sent[k]
            if st.sent[k] == 0:
                st.incl.encode(bits, k, layer + 1)
            else:
                bits.put(1 if new else 0)
            if not new:
                continue
            if st.sent[k] == 0:
                st.imsb.encode(bits, k, 999)
            _passes_code(bits, new)
            if st.segmax[k] is None:
                st.segmax[k] = []
            if cb.block.ht_first is None:
                pieces = _segments_of(style, st.sent[k], new, st.segmax[k])
            elif st.sent[k] == 0:  # T.814: the cleanup segment, then the refinement segment
                first = cb.block.ht_first
                pieces = [first] + ([new - first] if new > first else [])
            else:
                pieces = [new]
            lengths, at = [], st.sent[k]
            for n in pieces:
                lengths.append(cb.block.cuts[at + n] - cb.block.cuts[at])
                at += n
            need = 0
            for n, length in zip(pieces, lengths):
                lg = n.bit_length() - 1
                need = max(need, length.bit_length() - lg)
            inc = max(0, need - st.lblock[k])
            bits.write((1 << (inc + 1)) - 2, inc + 1)
            st.lblock[k] += inc
            for n, length in zip(pieces, lengths):
                bits.write(length, st.lblock[k] + n.bit_length() - 1)
            blocks_in.append((cb, st.sent[k], target))
            st.sent[k] = target
    header = bits.flush()
    body = b"".join(bytes(_block_bytes(cb.block))[cb.block.cuts[a]:cb.block.cuts[b]] for cb, a, b in blocks_in)
    return header, body


def _block_bytes(block: Block) -> bytes:
    if not hasattr(block, "_data"):
        block._data = b"".join(payload for _, _, payload in block.segments)
    return block._data


# ---- progression (opj_pi_next_*) ----

def progression(entries, comps, tile, numlayers):
    """The (layer, resolution, component, precinct) of every packet of a
    tile in the order opj_pi_next_* walk them under `entries` [(order,
    RS, CS, LYE, RE, CE)] (each packet once: OpenJPEG's include array).
    `comps`: [(dx, dy, [Resolution])]."""
    tx0, ty0, tx1, ty1 = tile
    seen = set()
    out = []

    def emit(l, r, c, p):
        key = (l, r, c, p)
        if key not in seen:
            seen.add(key)
            out.append(key)

    def steps(cs):
        sx = sy = 0
        for c in cs:
            dx, dy, ress = comps[c]
            for r, res in enumerate(ress):
                level = len(ress) - 1 - r
                if res.pdx + level < 32 and dx <= 0xFFFFFFFF // (1 << (res.pdx + level)):
                    d = dx * (1 << (res.pdx + level))
                    sx = d if not sx else min(sx, d)
                if res.pdy + level < 32 and dy <= 0xFFFFFFFF // (1 << (res.pdy + level)):
                    d = dy * (1 << (res.pdy + level))
                    sy = d if not sy else min(sy, d)
        return sx, sy

    def position(c, r, x, y, l1):
        dx, dy, ress = comps[c]
        if r >= len(ress):
            return
        res = ress[r]
        level = len(ress) - 1 - r
        trx0, try0 = ceildiv(tx0, dx << level), ceildiv(ty0, dy << level)
        trx1, try1 = ceildiv(tx1, dx << level), ceildiv(ty1, dy << level)
        rpx, rpy = res.pdx + level, res.pdy + level
        if not (y % (dy << rpy) == 0 or (y == ty0 and (try0 << level) % (1 << rpy))):
            return
        if not (x % (dx << rpx) == 0 or (x == tx0 and (trx0 << level) % (1 << rpx))):
            return
        if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
            return
        prci = (ceildiv(x, dx << level) >> res.pdx) - (trx0 >> res.pdx)
        prcj = (ceildiv(y, dy << level) >> res.pdy) - (try0 >> res.pdy)
        for lay in range(l1):
            emit(lay, r, c, prci + prcj * res.pw)

    for order, rs, cs, lye, re, ce in entries:
        lye = min(lye, numlayers)
        ce = min(ce, len(comps))
        if cs >= len(comps) or order > 4:  # opj_pi_next_*: "invalid compno0/compno1", or no order: no packet
            continue
        if order in (0, 1):
            outer = [(lay, r) for lay in range(lye) for r in range(rs, re)] if order == 0 else \
                [(lay, r) for r in range(rs, re) for lay in range(lye)]
            for lay, r in outer:
                for c in range(cs, ce):
                    ress = comps[c][2]
                    if r >= len(ress):
                        continue
                    for p in range(ress[r].pw * ress[r].ph):
                        emit(lay, r, c, p)
        elif order in (2, 3):
            sx, sy = steps(range(len(comps)))
            if not sx or not sy:
                continue
            ys = list(range_steps(ty0, ty1, sy))
            xs = list(range_steps(tx0, tx1, sx))
            if order == 2:
                for r in range(rs, re):
                    for y in ys:
                        for x in xs:
                            for c in range(cs, ce):
                                position(c, r, x, y, lye)
            else:
                for y in ys:
                    for x in xs:
                        for c in range(cs, ce):
                            for r in range(rs, min(re, len(comps[c][2]))):
                                position(c, r, x, y, lye)
        else:
            for c in range(cs, ce):
                sx, sy = steps([c])
                if not sx or not sy:
                    break
                for y in range_steps(ty0, ty1, sy):
                    for x in range_steps(tx0, tx1, sx):
                        for r in range(rs, min(re, len(comps[c][2]))):
                            position(c, r, x, y, lye)
    return out


def range_steps(a, b, step):
    v = a
    while v < b:
        yield v
        v += step - v % step


# ---- the codestream ----

def _segment(marker, body: bytes) -> bytes:
    return struct.pack(">HH", marker, 2 + len(body)) + body


def components_of(pixels: np.ndarray, subsampling, offset):
    """The component planes a subsampled image holds: component c's sample
    (u, v) is the pixel at reference-grid (u dx, v dy), the image starting
    at `offset` (x0, y0)."""
    h, w, nc = pixels.shape
    x0, y0 = offset
    planes = []
    for c in range(nc):
        dx, dy = subsampling[c]
        us = np.arange(ceildiv(x0, dx), ceildiv(x0 + w, dx))
        vs = np.arange(ceildiv(y0, dy), ceildiv(y0 + h, dy))
        planes.append(pixels[np.ix_(vs * dy - y0, us * dx - x0)][..., c])
    return planes


def encode(pixels, *, levels=5, cblk=(6, 6), precincts=None, layers=None, progression_order="LRCP", mct=False,
           tile=None, tile_offset=(0, 0), offset=(0, 0), tile_parts=1, style=0, sop=False, eph=False,
           headers=None, split=None, poc=None, tile_poc=None, subsampling=None, roi=None, roi_rect=None,
           planes=None, nsop=None, precision=8, irreversible=False, ht_passes=1, cap=True, placeholders=0,
           guard=GUARD_BITS, signed=False, max_expn=31) -> bytes:
    """A raw JPEG 2000 codestream of `pixels` ((h, w, c) integers of
    `precision` bits, 1 to 31: uint8, uint16 or uint32, or with `signed`
    int32 samples of that range, written with Ssiz's sign bit and no DC
    level shift; c in 1..4; subsampled components take the samples
    `components_of` picks).

    levels: decompositions; cblk: code-block width / height exponents;
    precincts: [(PPx, PPy)] per resolution (None: the maximum); layers:
    cumulative passes per code-block at the end of each layer (None: one
    layer of every pass); progression_order: a name of ORDERS; tile: (w,
    h) or None for one tile; tile_parts: tile-parts a tile (split at packet
    boundaries); style: the code-block style bits; sop / eph: the
    markers; headers: None, "ppm" or "ppt"; split: the largest Ippm / Ippt
    body per marker segment (several segments); poc: [(RS, CS, LYE, RE,
    CE, order name)] in the main header; tile_poc: {tile index: POC list}
    in that tile's first tile-part header; subsampling: [(dx, dy)] per
    component; roi: {component: shift} (RGN, maxshift), scaling up the
    coefficients of `roi_rect` (x0, y0, x1, y1 on the image) or of the
    whole component; planes: the bit-plane below which passes are left out
    (lossy); nsop: Nsop of each packet from its index (default the index);
    precision: bits a sample; irreversible: the 9/7 wavelet (and the ICT
    with `mct`), coefficients quantised with steps 2^-gain (guard bits
    `guard`); max_expn: the largest band exponent written (QCD holds 5
    bits, so 31 at most: above 29 bits the high bands' exponents are cut
    to it, their 9/7 steps growing to match; smaller values make bands
    of fewer bit-planes, which the coefficients must fit).

    HTJ2K (ITU-T T.814): `style` with HT (0x40) codes every code-block with
    the HT block coder (`encode_ht_block`): its cleanup pass at bit-plane
    `planes` (default 0), with `ht_passes` 2 or 3 the SigProp and MagRef
    passes below it, `placeholders` empty pass triples counted before the
    cleanup pass; Rsiz bit 14 is set and, with `cap`, the CAP (Part 15
    capabilities, MAGB) and CPF markers written.
    """
    pix = pixels[..., None] if pixels.ndim == 2 else pixels
    h, w, nc = pix.shape
    subsampling = subsampling or [(1, 1)] * nc
    planes_in = components_of(pix, subsampling, offset)
    x0, y0 = offset
    x1, y1 = x0 + w, y0 + h
    tdx, tdy = tile or (x1, y1)
    tx0g, ty0g = tile_offset if tile else (0, 0)
    tw, th = ceildiv(x1 - tx0g, tdx), ceildiv(y1 - ty0g, tdy)
    numres = levels + 1
    precincts = precincts or [(15, 15)] * numres
    if len(precincts) != numres:
        raise ValueError(f"{len(precincts)} precinct sizes for {numres} resolutions")
    numlayers = len(layers) if layers else 1
    roi = roi or {}
    use_mct = bool(mct) and nc >= 3
    prec = precision
    # e_b: reversible, or 9/7 steps 2^(prec - e_b) = 2^-gain
    gains = [min(g, max_expn) for g in (prec, prec + 1, prec + 1, prec + 2)]
    ht = bool(style & HT)
    siz = struct.pack(">HIIIIIIIIH", 0x4000 if ht else 0, x1, y1, x0, y0, tdx, tdy, tx0g, ty0g, nc)
    siz += b"".join(struct.pack(">BBB", prec - 1 | (0x80 if signed else 0), dx, dy) for dx, dy in subsampling)
    scod = (1 if precincts != [(15, 15)] * numres else 0) | (2 if sop else 0) | (4 if eph else 0)
    cod = struct.pack(">BBHB", scod, ORDERS[progression_order], numlayers, int(use_mct))
    cod += struct.pack(">BBBBB", levels, cblk[0] - 2, cblk[1] - 2, style, 0 if irreversible else 1)
    if scod & 1:
        cod += bytes(ppx | ppy << 4 for ppx, ppy in precincts)
    expns = [gains[0]] + gains[1:] * levels
    if irreversible:
        qcd = bytes([guard << 5 | 2]) + b"".join(struct.pack(">H", g << 11) for g in expns)
    else:
        qcd = bytes([guard << 5]) + bytes(g << 3 for g in expns)
    room = 1 if nc <= 256 else 2

    def poc_body(entries):
        out = b""
        for rs, cs, lye, re, ce, order in entries:
            out += struct.pack(">B", rs) + cs.to_bytes(room, "big") + struct.pack(">HB", lye, re)
            out += ce.to_bytes(room, "big") + struct.pack(">B", ORDERS[order] if isinstance(order, str) else order)
        return out

    main = [(0xFF51, siz)]
    if ht and cap:
        magb = max(gains) + guard - 1 - (planes or 0)
        # Pcap: Part 15; Ccap15: HT code-blocks only, one HT set, MAGB (B = MAGB - 8 from 9 to 27)
        main.append((0xFF50, struct.pack(">IH", 1 << 17, max(0, min(magb, 27) - 8))))
        main.append((0xFF59, struct.pack(">H", 0)))  # CPF: Pcpf 0
    main += [(0xFF52, cod), (0xFF5C, qcd)]
    for c, s in sorted(roi.items()):
        main.append((0xFF5E, c.to_bytes(room, "big") + bytes([0, s])))
    if poc:
        main.append((0xFF5F, poc_body(poc)))

    # components: DC shift, RCT
    samples = [p.astype(np.int64) - (0 if signed else 1 << (prec - 1)) for p in planes_in]
    steps = [2.0 ** -(g - prec) for g in gains]
    tiles_out = []
    for tno in range(tw * th):
        p, q = tno % tw, tno // tw
        t = (max(tx0g + p * tdx, x0), max(ty0g + q * tdy, y0), min(tx0g + (p + 1) * tdx, x1),
             min(ty0g + (q + 1) * tdy, y1))
        comps = []
        coefs = []
        for c in range(nc):
            dx, dy = subsampling[c]
            geo = tile_component(*t, dx, dy, levels, cblk, precincts, gains, guard)
            tcx0, tcy0, tcx1, tcy1, ress = geo
            cx0, cy0 = ceildiv(x0, dx), ceildiv(y0, dy)
            coefs.append(samples[c][tcy0 - cy0:tcy1 - cy0, tcx0 - cx0:tcx1 - cx0])
            comps.append((dx, dy, ress, geo))
        if use_mct and coefs[0].shape == coefs[1].shape == coefs[2].shape:  # else the flag alone
            r, g, b = coefs[0], coefs[1], coefs[2]
            if irreversible:  # the ICT, in float64
                r, g, b = r.astype(np.float64), g.astype(np.float64), b.astype(np.float64)
                coefs[0] = 0.299 * r + 0.587 * g + 0.114 * b
                coefs[1] = -0.16875 * r - 0.331260 * g + 0.5 * b
                coefs[2] = 0.5 * r - 0.41869 * g - 0.08131 * b
            else:
                coefs[0], coefs[1], coefs[2] = np.floor_divide(r + 2 * g + b, 4), b - g, r - g
        states = {}
        for c in range(nc):
            dx, dy, ress, (tcx0, tcy0, tcx1, tcy1, _) = comps[c]
            bands = forward_dwt(coefs[c], tcx0, tcy0, levels, irreversible)
            shift = roi.get(c, 0)
            for r, res in enumerate(ress):
                arrays = [bands[0]] if r == 0 else list(bands[r])
                level = numres - 1 - r
                for band, arr in zip(res.bands, arrays):
                    if band.empty():
                        continue
                    if irreversible:  # dead-zone quantisation by the band's step
                        arr = np.sign(arr) * np.floor(np.abs(arr) / steps[band.bandno])
                    arr = np.array(arr, np.int64)
                    if shift:
                        mask = np.ones(arr.shape, bool)
                        if roi_rect is not None:
                            rx0, ry0, rx1, ry1 = roi_rect
                            lev = level if r == 0 else level + 1
                            ux0 = (ceildiv(rx0 + x0, dx) >> lev) - band.x0
                            uy0 = (ceildiv(ry0 + y0, dy) >> lev) - band.y0
                            ux1 = ceilpow2(ceildiv(rx1 + x0, dx), lev) - band.x0
                            uy1 = ceilpow2(ceildiv(ry1 + y0, dy), lev) - band.y0
                            mask[:] = False
                            mask[max(0, uy0):max(0, uy1), max(0, ux0):max(0, ux1)] = True
                        arr = np.where(mask, np.sign(arr) * (np.abs(arr) << shift), arr)
                    for pr in band.precincts:
                        for cb in pr.blocks:
                            sub = arr[cb.y0 - band.y0:cb.y1 - band.y0, cb.x0 - band.x0:cb.x1 - band.x0]
                            if ht:
                                cb.block = encode_ht_block(sub, planes or 0, ht_passes, style, placeholders)
                                cb.band_numbps = band.numbps
                                if int(np.abs(sub).max(initial=0)) >> band.numbps:
                                    raise ValueError(f"coefficients past {band.numbps} bit-planes: more guard bits")
                                continue
                            total = None
                            if planes is not None:
                                k_total = int(np.abs(sub).max(initial=0)).bit_length()
                                total = max(0, 1 + 3 * (k_total - 1 - planes)) if k_total > planes else 0
                            cb.block = encode_block(sub, band.bandno, style, shift, total)
                            cb.band_numbps = band.numbps
            for r, res in enumerate(ress):
                for pno in range(res.pw * res.ph):
                    sts = []
                    for band in res.bands:
                        if band.empty():
                            continue
                        pr = band.precincts[pno]
                        per_block = []
                        for cb in pr.blocks:
                            n = cb.block.passes
                            if layers:
                                cum = [n if v is None else min(v, n) for v in layers]
                                for L in range(1, len(cum)):
                                    cum[L] = max(cum[L], cum[L - 1])
                            else:
                                cum = [n]
                            per_block.append(cum)
                        sts.append(PrecinctState(pr, per_block))
                    states[(r, c, pno)] = sts
        # opj_j2k_read_poc adds a tile-part header's entries to the main header's
        listed = list(poc or []) + list((tile_poc or {}).get(tno, []))
        entries = [(ORDERS[o] if isinstance(o, str) else o, rs, cs, lye, re, ce) for rs, cs, lye, re, ce, o in listed]
        if not entries:
            entries = [(ORDERS[progression_order], 0, 0, numlayers, numres, nc)]
        walk = progression(entries, [(dx, dy, ress) for dx, dy, ress, _ in comps], t, numlayers)
        packets = []
        for n, (lay, r, c, pno) in enumerate(walk):
            hdr, body = packet(states[(r, c, pno)], lay, style)
            if eph:
                hdr += b"\xff\x92"
            mark = struct.pack(">HHH", 0xFF91, 4, (n if nsop is None else nsop(n)) & 0xFFFF) if sop else b""
            packets.append((mark, hdr, body))
        tiles_out.append((tno, packets))

    # tile-parts
    parts = []
    for tno, packets in tiles_out:
        cuts = [len(packets) * k // tile_parts for k in range(tile_parts + 1)]
        for k in range(tile_parts):
            group = packets[cuts[k]:cuts[k + 1]]
            parts.append((tno, k, tile_parts, group))
    out_parts = []
    ppm_chunks = []
    zppt = {}
    for tno, k, n, group in parts:
        markers = []
        if k == 0 and tile_poc and tno in tile_poc:
            markers.append((0xFF5F, poc_body(tile_poc[tno])))
        hdrs = b"".join(hd for _, hd, _ in group)
        if headers == "ppt":  # Zppt counts on over the tile's tile-parts
            size = split or 65533
            for at in range(0, max(len(hdrs), 1), size):
                z = zppt[tno] = zppt.get(tno, -1) + 1
                markers.append((0xFF61, bytes([z]) + hdrs[at:at + size]))
            data = b"".join(mark + bd for mark, _, bd in group)
        elif headers == "ppm":
            ppm_chunks.append(struct.pack(">I", len(hdrs)) + hdrs)
            data = b"".join(mark + bd for mark, _, bd in group)
        else:
            data = b"".join(mark + hd + bd for mark, hd, bd in group)
        out_parts.append((tno, k, n, markers, data))
    if headers == "ppm":  # Ippm may run on into the next segment, Nppm may not (opj_j2k_merge_ppm)
        size = split or 65532
        bodies = [bytearray()]
        for chunk in ppm_chunks:
            for at in range(len(chunk)):
                if len(bodies[-1]) == size or (at == 0 and len(bodies[-1]) + 4 > size):
                    bodies.append(bytearray())
                bodies[-1].append(chunk[at])
        ppm = [(0xFF60, bytes([z]) + bytes(b)) for z, b in enumerate(bodies)]
        at = [m for m, _ in main].index(0xFF5C) + 1
        main = main[:at] + ppm + main[at:]
    out = b"\xff\x4f" + b"".join(_segment(m, b) for m, b in main)
    for tno, k, n, markers, data in out_parts:
        hdr = b"".join(_segment(m, b) for m, b in markers)
        out += struct.pack(">HHHIBB", 0xFF90, 10, tno, 12 + len(hdr) + 2 + len(data), k, n)
        out += hdr + b"\xff\x93" + data
    return out + b"\xff\xd9"


# ---- Part 2 marker segments (ITU-T T.801 Annex A) ----
#
# Each gives a (marker, body) pair for `torch_image_writers.j2k_join`.

MCT, MCC, MCO, CBD = 0xFF74, 0xFF75, 0xFF77, 0xFF78


def mct(index, element, values, array=2, zmct=0, ymct=0):
    """MCT: record `index` of `values` as element type `element` (0 int16,
    taken modulo 2^16; 1 int32; 2 float32; 3 float64), array type `array`
    (0 dependency, 1 decorrelation, 2 offset)."""
    if element == 0:
        body = struct.pack(f">{len(values)}H", *(v & 0xFFFF for v in values))
    else:
        body = struct.pack(">" + "xifd"[element] * len(values), *values)
    return MCT, struct.pack(">HHH", zmct, index | array << 8 | element << 10, ymct) + body


def mcc(index, n, offset=0, deco=0, reversible=1, kind=1, collections=1, order=None):
    """MCC: collection `index` of array decorrelation (`kind` 1) over
    components 0..n-1 (or `order`), naming MCT records `offset` and `deco`
    (0: none), `collections` times (Qmcc)."""
    order = list(range(n)) if order is None else order
    body = struct.pack(">HBHH", 0, index, 0, collections)
    for _ in range(collections):
        body += bytes([kind]) + struct.pack(">H", n) + bytes(order) + struct.pack(">H", n) + bytes(order)
        body += bytes([reversible, offset, deco])
    return MCC, body


def mco(*stages):
    """MCO: Nmco and the MCC index of each stage."""
    return MCO, bytes([len(stages)]) + bytes(stages)


def edited(cs: bytes, main_add=(), part_add=(), rsiz=None, main_edit=None) -> bytes:
    """`cs` with (marker, body) segments added after SIZ (`main_add`) and at
    the head of every tile-part header (`part_add`), Rsiz set, or the main
    header's segments passed through `main_edit`."""
    from torch_image_writers import j2k_join, j2k_markers

    main, parts = j2k_markers(cs)
    main = main[:1] + list(main_add) + main[1:]
    if rsiz is not None:
        main = [(m, struct.pack(">H", rsiz) + b[2:] if m == 0xFF51 else b) for m, b in main]
    main = main_edit(main) if main_edit else main
    return j2k_join(main, [(i, t, n, list(part_add) + s, d) for i, t, n, s, d in parts])


def cbd(depths):
    """CBD: Ncbd and each component's depth byte (bits - 1, bit 7 the
    sign)."""
    return CBD, struct.pack(">H", len(depths)) + bytes(depths)


def deep_samples(a, bits, signed=False, seed=0, headroom=0):
    """The 8-bit picture `a` as samples of `bits` bits: its values in the
    top 8 bits (less `headroom`, which keeps the 5/3 coefficients of 31-bit
    samples within OpenJPEG's 30 bit-planes), seeded noise below; uint32,
    or int32 about 0 with `signed`."""
    k = bits - 8 - headroom
    rng = np.random.default_rng(seed)
    v = ((a.astype(np.int64) - 128) << k) + rng.integers(0, 1 << k, a.shape)
    return v.astype(np.int32) if signed else (v + (1 << (bits - 1))).astype(np.uint32)
