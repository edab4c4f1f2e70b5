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
  headers) segments, split over several segments at any size.

`encode` returns a raw codestream; `torch_image_writers.jp2_bytes` puts
one in JP2 boxes.
"""

from __future__ import annotations

import struct

import numpy as np

BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32
ALL_STYLES = 63
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
    bit-planes the decoder counts before the ROI shift."""

    def __init__(self, numbps, passes, segments, cuts):
        self.numbps, self.passes, self.segments, self.cuts = numbps, passes, segments, cuts


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


def forward_dwt(a: np.ndarray, x0: int, y0: int, levels: int):
    """The tile-component `a` (rows, columns; its first sample at (x0, y0))
    in `levels` decompositions: [LL, (HL, LH, HH) of resolution 1, ...]."""
    bands = []
    cur, u0, v0 = a.astype(np.int64), x0, y0
    for _ in range(levels):
        lo_v, hi_v = _fwd53_1d(cur, v0) if cur.shape[0] else (cur, cur)
        ll, hl = (_fwd53_1d(lo_v.T, u0) if lo_v.shape[1] else (lo_v.T, lo_v.T))
        lh, hh = (_fwd53_1d(hi_v.T, u0) if hi_v.shape[1] else (hi_v.T, hi_v.T))
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


def tile_component(tx0, ty0, tx1, ty1, dx, dy, levels, cblk, precincts, gains_expn):
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
            band = Band(bandno, bx0, by0, bx1, by1, expn + GUARD_BITS - 1)
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
            pieces = _segments_of(style, st.sent[k], new, st.segmax[k])
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
           planes=None, nsop=None) -> bytes:
    """A raw JPEG 2000 codestream of `pixels` ((h, w, c) uint8, c in 1..4;
    subsampled components take the samples `components_of` picks).

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
    (lossy); nsop: Nsop of each packet from its index (default the index).
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
    gains = [8, 9, 9, 10]
    prec = 8
    siz = struct.pack(">HIIIIIIIIH", 0, x1, y1, x0, y0, tdx, tdy, tx0g, ty0g, nc)
    siz += b"".join(struct.pack(">BBB", prec - 1, dx, dy) for dx, dy in subsampling)
    scod = (1 if precincts != [(15, 15)] * numres else 0) | (2 if sop else 0) | (4 if eph else 0)
    cod = struct.pack(">BBHB", scod, ORDERS[progression_order], numlayers, int(use_mct))
    cod += struct.pack(">BBBBB", levels, cblk[0] - 2, cblk[1] - 2, style, 1)
    if scod & 1:
        cod += bytes(ppx | ppy << 4 for ppx, ppy in precincts)
    qcd = bytes([GUARD_BITS << 5]) + bytes(g << 3 for g in [gains[0]] + gains[1:] * levels)
    room = 1 if nc <= 256 else 2

    def poc_body(entries):
        out = b""
        for rs, cs, lye, re, ce, order in entries:
            out += struct.pack(">B", rs) + cs.to_bytes(room, "big") + struct.pack(">HB", lye, re)
            out += ce.to_bytes(room, "big") + struct.pack(">B", ORDERS[order] if isinstance(order, str) else order)
        return out

    main = [(0xFF51, siz), (0xFF52, cod), (0xFF5C, qcd)]
    for c, s in sorted(roi.items()):
        main.append((0xFF5E, c.to_bytes(room, "big") + bytes([0, s])))
    if poc:
        main.append((0xFF5F, poc_body(poc)))

    # components: DC shift, RCT
    samples = [p.astype(np.int64) - (1 << (prec - 1)) for p in planes_in]
    tiles_out = []
    for tno in range(tw * th):
        p, q = tno % tw, tno // tw
        t = (max(tx0g + p * tdx, x0), max(ty0g + q * tdy, y0), min(tx0g + (p + 1) * tdx, x1),
             min(ty0g + (q + 1) * tdy, y1))
        comps = []
        coefs = []
        for c in range(nc):
            dx, dy = subsampling[c]
            geo = tile_component(*t, dx, dy, levels, cblk, precincts, gains)
            tcx0, tcy0, tcx1, tcy1, ress = geo
            cx0, cy0 = ceildiv(x0, dx), ceildiv(y0, dy)
            coefs.append(samples[c][tcy0 - cy0:tcy1 - cy0, tcx0 - cx0:tcx1 - cx0])
            comps.append((dx, dy, ress, geo))
        if use_mct and coefs[0].shape == coefs[1].shape == coefs[2].shape:  # else the flag alone
            r, g, b = coefs[0], coefs[1], coefs[2]
            coefs[0], coefs[1], coefs[2] = np.floor_divide(r + 2 * g + b, 4), b - g, r - g
        states = {}
        for c in range(nc):
            dx, dy, ress, (tcx0, tcy0, tcx1, tcy1, _) = comps[c]
            bands = forward_dwt(coefs[c], tcx0, tcy0, levels)
            shift = roi.get(c, 0)
            for r, res in enumerate(ress):
                arrays = [bands[0]] if r == 0 else list(bands[r])
                level = numres - 1 - r
                for band, arr in zip(res.bands, arrays):
                    if band.empty():
                        continue
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
        main = main[:3] + ppm + main[3:]
    out = b"\xff\x4f" + b"".join(_segment(m, b) for m, b in main)
    for tno, k, n, markers, data in out_parts:
        hdr = b"".join(_segment(m, b) for m, b in markers)
        out += struct.pack(">HHHIBB", 0xFF90, 10, tno, 12 + len(hdr) + 2 + len(data), k, n)
        out += hdr + b"\xff\x93" + data
    return out + b"\xff\xd9"
