"""The port's JPEG decoders (`utils/jpeg.py`, plain; `csrc/jpeg_decode.cc`,
compiled) against PIL, which the JAX package reads its images with.

Tolerances: every comparison is bit-equal, to `np.asarray(Image.open(f))`
(PIL 12 with libjpeg-turbo here). Each refused form raises a `ValueError`
that names the file and the form, the same message from both decoders.

The compiled decoder is built here with the host's `c++`; its tests skip,
with the reason, only where no C++ compiler exists. `encode_jpeg` below is
a copy of chip_smoke.py's baseline encoder (PIL cannot write 4:4:0, the
1x2 chroma ratio).
"""

import io
import os
import shutil
import stat
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from gaussian_splatting_torch.utils import cuda_build, image_io, jpeg
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

FIXTURES = Path(__file__).parent / "fixtures" / "torch_jpeg"


# ---- chip_smoke.py's baseline encoder, copied ----

ENC_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# JPEG Annex K: the example quantisation tables (K.1, K.2; natural order) and
# Huffman tables (K.3 to K.6): code counts per length, then symbols. The AC
# tables list a few symbols by hand, then every other (run, size) in order.
Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
Q_CHROMA = np.full(64, 99)
Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56,
                                                         47, 66]
_AC_SYMBOLS = [0x00, 0xF0] + [r << 4 | s for r in range(16) for s in range(1, 11)]


def _ac_symbols(head_hex):
    head = list(bytes.fromhex(head_hex))
    return head + sorted(set(_AC_SYMBOLS) - set(head))


HUFFMAN = {  # (class, table id): (counts of lengths 1..16, symbols)
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], _ac_symbols(
        "01020300041105122131410613516107227114328191a108234" "2b1c11552d1f02433627282090a16")),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], _ac_symbols(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f1")),
}


def _scaled(table, quality):
    """libjpeg's jpeg_quality_scaling and jpeg_add_quant_table (baseline)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((table * scale + 50) // 100, 1, 255)


def _codes(counts, symbols):
    """Canonical Huffman codes: code and length per symbol (256 entries)."""
    code, length = np.zeros(256, np.int64), np.zeros(256, np.int64)
    c, p = 0, 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            code[symbols[p]], length[symbols[p]] = c, n
            c, p = c + 1, p + 1
        c <<= 1
    return code, length


def _pack(values, lengths):
    """Bits (each value's `length` low bits, most significant first) as
    bytes, the last byte padded with ones; every value <= 32 bits."""
    ends = np.cumsum(lengths)
    starts = ends - lengths
    nbits = int(ends[-1]) if len(ends) else 0
    word, off = starts // 32, starts % 32
    window = values.astype(np.uint64) << (64 - off - lengths).astype(np.uint64)
    hi = (window >> np.uint64(32)).astype(np.float64)
    lo = (window & np.uint64(0xFFFFFFFF)).astype(np.float64)
    n_words = nbits // 32 + 2
    words = (np.bincount(word, hi, n_words) + np.bincount(word + 1, lo, n_words)).astype(np.uint64)
    data = bytearray(words.astype(">u4").tobytes()[:(nbits + 7) // 8])
    if nbits % 8:
        data[-1] |= (1 << (8 - nbits % 8)) - 1
    return bytes(data).replace(b"\xff", b"\xff\x00")


# the table (quantisation and Huffman) of each component: luma for Y (or
# C) and K, chroma for the other two
TABLE_OF = np.array([0, 1, 1, 0])


def _entropy(coefs, comp, tables):
    """Huffman-code quantised blocks (B, 64, zig-zag order) of one
    restart segment, `comp` the component of each block: DC differences
    per component, AC as (run, size) symbols with ZRL and EOB; each
    component's tables by TABLE_OF."""
    B = len(coefs)
    dc = coefs[:, 0]
    diff = np.empty(B, np.int64)
    for c in np.unique(comp):
        idx = np.nonzero(comp == c)[0]
        diff[idx] = np.diff(dc[idx], prepend=0)
    comp = TABLE_OF[comp]
    b_idx, k = np.nonzero(coefs[:, 1:])
    k = k + 1
    first = np.ones(len(k), bool)
    first[1:] = b_idx[1:] != b_idx[:-1]
    prev = np.where(first, 0, np.roll(k, 1))
    run = k - prev - 1
    last = np.zeros(B, np.int64)
    last[b_idx] = k  # the last nonzero index of each block (0: none)
    eob_blocks = np.nonzero(last < 63)[0]
    zrl_of = np.repeat(np.arange(len(k)), run // 16)

    def size(x):
        return np.where(x == 0, 0, np.floor(np.log2(np.maximum(np.abs(x), 1))).astype(np.int64) + 1)

    def extra(x, s):
        return np.where(x < 0, x + (1 << s) - 1, x)

    s_dc = size(diff)
    ac_val = coefs[b_idx, k]
    s_ac = size(ac_val)
    sym = (run % 16) << 4 | s_ac
    dc_code, dc_len = (np.array([t[0][i] for t in tables]) for i in range(2))  # (2, 256) each
    ac_code, ac_len = (np.array([t[1][i] for t in tables]) for i in range(2))
    cb = comp[b_idx]
    keys = np.concatenate([np.arange(B) * 130, b_idx[zrl_of] * 130 + 2 * k[zrl_of] - 1,
                           b_idx * 130 + 2 * k, eob_blocks * 130 + 129])
    ce, cz = comp[eob_blocks], comp[b_idx[zrl_of]]
    values = np.concatenate([
        (dc_code[comp, s_dc] << s_dc) | extra(diff, s_dc), ac_code[cz, 0xF0],
        (ac_code[cb, sym] << s_ac) | extra(ac_val, s_ac), ac_code[ce, 0x00]])
    lengths = np.concatenate([dc_len[comp, s_dc] + s_dc, ac_len[cz, 0xF0], ac_len[cb, sym] + s_ac, ac_len[ce, 0x00]])
    order = np.argsort(keys, kind="stable")
    return _pack(values[order], lengths[order])


def encode_jpeg(pixels, quality=95, sampling=(2, 2), restart_interval=0, adobe=None, k_sampled=False):
    """Baseline bytes of (H, W, 3), (H, W[, 1]) or (H, W, 4) uint8 `pixels`:
    the first component sampled (h, v) = `sampling` times the second and
    third's, a float DCT, the Annex K tables at libjpeg's `quality`
    scaling, and `restart_interval` MCUs between restart markers (0: none).
    3 channels are RGB, written as YCbCr under a JFIF marker. 4 channels
    are CMYK as libjpeg takes it (the samples the file stores for CMYK):
    with `adobe` 2 written as YCCK (libjpeg's cmyk_ycck_convert: YCbCr of
    255 - C, 255 - M, 255 - Y, K kept) under an Adobe marker of transform
    2, else as stored, under an Adobe marker of transform `adobe` (0) or
    none (None); K sampled as the first component, or as the second and
    third where `k_sampled`."""
    a = np.asarray(pixels, np.float64)
    a = a[..., None] if a.ndim == 2 else a
    H, W, C = a.shape
    grey = C == 1
    hs, vs = (1, 1) if grey else sampling
    mcux, mcuy = -(-W // (8 * hs)), -(-H // (8 * vs))
    a = np.pad(a, ((0, mcuy * 8 * vs - H), (0, mcux * 8 * hs - W), (0, 0)), mode="edge")
    factors = [(hs, vs)] + [(1, 1)] * min(C - 1, 2) + ([(1, 1) if k_sampled else (hs, vs)] if C == 4 else [])
    if grey:
        planes = [a[..., 0]]
    else:
        if C == 4 and adobe != 2:
            planes = [a[..., i] for i in range(4)]
        else:
            r, g, b = (255 - a[..., i] if C == 4 else a[..., i] for i in range(3))
            y = 0.299 * r + 0.587 * g + 0.114 * b
            cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
            cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
            planes = [y, cb, cr] + ([a[..., 3]] if C == 4 else [])
        planes = [p if f == (hs, vs) else p.reshape(mcuy * 8, vs, mcux * 8, hs).mean(axis=(1, 3))
                  for p, f in zip(planes, factors)]
    qts = [_scaled(Q_LUMA, quality), _scaled(Q_CHROMA, quality)]
    x = np.arange(8)
    M = np.sqrt(np.where(x[:, None] == 0, 1 / 8, 2 / 8)) * np.cos((2 * x[None, :] + 1) * x[:, None] * np.pi / 16)
    blocks = []
    for i, p in enumerate(planes):
        rows, cols = p.shape[0] // 8, p.shape[1] // 8
        t = (p - 128).reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)
        f = M @ t @ M.T
        q = np.round(f.reshape(rows, cols, 64) / qts[TABLE_OF[i]]).astype(np.int64)[..., ENC_ZIGZAG]
        h, v = factors[i]
        blocks.append(q.reshape(mcuy, v, mcux, h, 64).transpose(0, 2, 1, 3, 4).reshape(mcuy * mcux, h * v, 64))
    mcu = np.concatenate(blocks, axis=1)  # (MCUs, blocks per MCU, 64) in scan order
    comp = np.array([i for i, (h, v) in enumerate(factors) for _ in range(h * v)])
    tables = [((_codes(*HUFFMAN[0, t])), _codes(*HUFFMAN[1, t])) for t in range(2)]
    per = restart_interval or len(mcu)
    segs = [_entropy(mcu[s:s + per].reshape(-1, 64), np.tile(comp, len(mcu[s:s + per])), tables)
            for s in range(0, len(mcu), per)]
    scan = b"".join(seg + (bytes([0xFF, 0xD0 + i % 8]) if i < len(segs) - 1 else b"")
                    for i, seg in enumerate(segs))

    def segment(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    sof = struct.pack(">BHHB", 8, H, W, C) + b"".join(
        bytes([i + 1, h << 4 | v, TABLE_OF[i]]) for i, (h, v) in enumerate(factors))
    sos = bytes([C]) + b"".join(bytes([i + 1, TABLE_OF[i] * 0x11]) for i in range(C))
    dqt = b"".join(bytes([t]) + qts[t][ENC_ZIGZAG].astype(np.uint8).tobytes() for t in range(1 if grey else 2))
    dht = b"".join(bytes([c << 4 | t]) + bytes(HUFFMAN[c, t][0]) + bytes(HUFFMAN[c, t][1])
                   for c in range(2) for t in range(1 if grey else 2))
    if C == 4:
        app = segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe)) if adobe is not None else b""
    else:
        app = segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out = (b"\xff\xd8" + app
           + segment(0xDB, dqt) + segment(0xC0, sof) + segment(0xC4, dht)
           + (segment(0xDD, struct.pack(">H", restart_interval)) if restart_interval else b"")
           + segment(0xDA, sos + bytes([0, 63, 0])) + scan + b"\xff\xd9")
    return out


# ---- helpers ----

def content(h, w, channels, kind, seed=0):
    """uint8 (h, w, channels): smooth gradients and waves, or uniform noise."""
    rng = np.random.default_rng(seed)
    if kind == "noisy":
        return rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 100 * np.sin(xx / (4 + 2 * i) + yy / (7 + i)) for i in range(channels)], -1)
    return np.clip(a, 0, 255).astype(np.uint8)


def pil_jpeg(a, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a[..., 0] if a.shape[2] == 1 else a).save(buf, "JPEG", **options)
    return buf.getvalue()


def pil_pixels(data: bytes) -> np.ndarray:
    """(H, W, C) uint8: PIL's pixels with a grey image's channel axis kept."""
    a = np.asarray(Image.open(io.BytesIO(data)))
    return a[..., None] if a.ndim == 2 else a


def have_cxx() -> bool:
    return shutil.which(os.environ.get("CXX") or "c++") is not None


@pytest.fixture(params=["plain", "compiled"])
def decode(request):
    """decode(data, name) by the plain or the compiled decoder."""
    if request.param == "plain":
        return lambda data, name="<bytes>": jpeg.decode_jpeg(data, name, plain=True)
    if not have_cxx():
        pytest.skip("no host C++ compiler to build csrc/jpeg_decode.cc")
    return lambda data, name="<bytes>": jpeg.decode_jpeg(data, name)


@pytest.fixture
def compiled():
    if not have_cxx():
        pytest.skip("no host C++ compiler to build csrc/jpeg_decode.cc")
    return lambda data, name="<bytes>": jpeg.decode_jpeg(data, name)


# ---- PIL's pixels ----

SUBSAMPLING = ["4:4:4", "4:2:2", "4:2:0", "grey"]
MODES = {"baseline": {}, "progressive": {"progressive": True}, "optimized": {"optimize": True},
         "restart_blocks": {"restart_marker_blocks": 3}, "restart_rows": {"restart_marker_rows": 1}}
SIZES = [(1, 1), (7, 5), (16, 16), (67, 45), (129, 97)]  # (width, height)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("quality", [50, 95, 100])
@pytest.mark.parametrize("subsampling", SUBSAMPLING)
def test_decoder_gives_pils_pixels(decode, subsampling, quality, mode):
    """Every size, on smooth and on noisy content, bit-equal to PIL."""
    options = dict(quality=quality, **MODES[mode])
    if subsampling != "grey":
        options["subsampling"] = subsampling
    for w, h in SIZES:
        for seed, kind in enumerate(("smooth", "noisy")):
            a = content(h, w, 1 if subsampling == "grey" else 3, kind, seed)
            data = pil_jpeg(a, **options)
            got = decode(data)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, pil_pixels(data), err_msg=f"{w}x{h} {kind}")


@pytest.mark.parametrize("sampling", [(1, 1), (2, 1), (2, 2), (1, 2)])
def test_baseline_encoder_files_give_pils_pixels(decode, sampling):
    """Files of the copied encoder: the 1x2 ratio (h1v2 upsampling, which
    PIL cannot write), the others beside it, with and without restart
    markers, and grey (a non-interleaved baseline scan)."""
    for w, h in SIZES + [(3, 2), (2, 3)]:
        a = content(h, w, 3, "smooth", 3)
        a = np.clip(a.astype(int) + np.random.default_rng(4).integers(-20, 21, a.shape), 0, 255)
        for restart in (0, 1, 5):
            for px in (a, a[..., :1]):
                data = encode_jpeg(px.astype(np.uint8), 90, sampling, restart)
                np.testing.assert_array_equal(decode(data), pil_pixels(data),
                                              err_msg=f"{w}x{h} restart {restart} C={px.shape[2]}")


@pytest.mark.parametrize("quality", [1, 100])
def test_saturated_edges_reach_the_range_limit(decode, quality, monkeypatch):
    """Black and white noise: IDCT outputs past the sample range go through
    the range-limit table's saturated entries, as PIL's do."""
    reach = [0]
    descale = jpeg._descale

    def spy(x, n):
        out = descale(x, n)
        if n == jpeg.CONST_BITS + jpeg.PASS1_BITS + 3:
            reach[0] = max(reach[0], int(np.abs(out).max()))
        return out

    monkeypatch.setattr(jpeg, "_descale", spy)
    for seed in range(4):
        a = (np.random.default_rng(seed).integers(0, 2, (40, 56, 3)) * 255).astype(np.uint8)
        for subsampling in ("4:4:4", "4:2:0"):
            data = pil_jpeg(a, quality=quality, subsampling=subsampling)
            np.testing.assert_array_equal(decode(data), pil_pixels(data))
    jpeg.decode_jpeg(pil_jpeg(a, quality=quality), plain=True)
    assert 128 < reach[0] <= 511  # saturated, and inside the range both IDCTs agree on


def coefficient_jpeg(dc: int) -> bytes:
    """A grey 8x8 baseline JPEG of one block whose only coefficient is the
    DC `dc`, every quantisation step 16: each sample before the range limit
    is 2 dc (its inverse DCT is dc x 16 / 8)."""
    tables = [(_codes(*HUFFMAN[0, 0]), _codes(*HUFFMAN[1, 0]))] * 2
    block = np.zeros((1, 64), np.int64)
    block[0, 0] = dc
    scan = _entropy(block, np.array([0]), tables)

    def segment(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    dht = b"".join(bytes([c << 4]) + bytes(HUFFMAN[c, 0][0]) + bytes(HUFFMAN[c, 0][1]) for c in range(2))
    return (b"\xff\xd8" + segment(0xDB, bytes([0] + [16] * 64))
            + segment(0xC0, struct.pack(">BHHB", 8, 8, 8, 1) + bytes([1, 0x11, 0]))
            + segment(0xC4, dht) + segment(0xDA, bytes([1, 1, 0, 0, 63, 0])) + scan + b"\xff\xd9")


@pytest.mark.parametrize("sample", [254, 510, 560, 1040])
def test_idct_beyond_the_agreed_range_is_refused(decode, sample):
    """Inside -512..511 libjpeg's range-limit table and PIL agree (a
    saturating clamp). Beyond it PIL, whose libjpeg-turbo runs the SIMD
    IDCT, gives neither the C code's table nor a clamp (560: 255, where the
    table gives 0; 1040: 0, where it gives 144, the 16-bit DC shortcut
    wrapping). The decoders run that arithmetic, so nothing is refused:
    every sample equals PIL's."""
    data = coefficient_jpeg(sample // 2)
    want = pil_pixels(data)
    assert int(want[0, 0, 0]) == {254: 255, 510: 255, 560: 255, 1040: 0}[sample]
    np.testing.assert_array_equal(decode(data, "block.jpg"), want)


# Custom tables for hand-made entropy-coded data: every DC category at 5
# bits (code = category), every AC symbol at 8 bits (code = its index in
# SWEEP_AC); the 8-bit codes 242..255 are no code at all.
SWEEP_DC = ([0, 0, 0, 0, 16] + [0] * 11, list(range(16)))
SWEEP_AC_SYMBOLS = [0x00, 0xF0] + [r << 4 | s for r in range(16) for s in range(1, 16)]
SWEEP_AC = ([0] * 7 + [len(SWEEP_AC_SYMBOLS)] + [0] * 8, SWEEP_AC_SYMBOLS)


def grey_jpeg(scan: bytes, quant, width, height) -> bytes:
    """A grey baseline JPEG (SOF1 where a step needs 16 bits) with the
    SWEEP tables around entropy-coded `scan`."""
    def segment(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    q = np.asarray(quant, np.int64)[ENC_ZIGZAG]
    wide = bool(q.max() > 255)
    dqt = bytes([0x10 if wide else 0]) + (q.astype(">u2").tobytes() if wide else q.astype(np.uint8).tobytes())
    dht = (bytes([0x00]) + bytes(SWEEP_DC[0]) + bytes(SWEEP_DC[1])
           + bytes([0x10]) + bytes(SWEEP_AC[0]) + bytes(SWEEP_AC[1]))
    return (b"\xff\xd8" + segment(0xDB, dqt)
            + segment(0xC1 if wide else 0xC0, struct.pack(">BHHB", 8, height, width, 1) + bytes([1, 0x11, 0]))
            + segment(0xC4, dht) + segment(0xDA, bytes([1, 1, 0, 0, 63, 0])) + scan + b"\xff\xd9")


def blocks_jpeg(blocks_zz, quant, width, height) -> bytes:
    """`grey_jpeg` of quantised blocks (B, 64) in zig-zag order."""
    tables = [(_codes(*SWEEP_DC), _codes(*SWEEP_AC))]
    scan = _entropy(np.asarray(blocks_zz, np.int64), np.zeros(len(blocks_zz), np.int64), tables)
    return grey_jpeg(scan, quant, width, height)


def sweep_blocks(seed):
    """16 blocks of DC-only, first-row-only (the column pass's shortcut) and
    scattered coefficients at magnitudes up to 32767, and steps of 1, up
    to 255, up to 65535 (16-bit, wrapping in the IDCT) or 255."""
    rng = np.random.default_rng(seed)
    mags = [2, 8, 64, 512, 2048, 8192, 16383, 32767]
    zz = np.zeros((16, 64), np.int64)
    first_row = [list(ENC_ZIGZAG).index(k) for k in range(1, 8)]
    for b in range(16):
        kind, m = rng.integers(0, 4), mags[rng.integers(0, len(mags))]
        dc = min(m, 16000 if kind == 0 else 8000)
        zz[b, 0] = rng.integers(-dc, dc + 1)
        if kind == 1:
            zz[b, first_row] = rng.integers(-m, m + 1, 7)
        elif kind > 1:
            k = rng.integers(1, 20)
            zz[b, rng.choice(np.arange(1, 64), k, replace=False)] = rng.integers(-m, m + 1, k)
    zz[:, 0] = np.clip(zz[:, 0], -16000, 16000)  # DC differences within 15 bits
    quant = [np.full(64, 1), rng.integers(1, 256, 64), rng.integers(1, 65536, 64), np.full(64, 255)][seed % 4]
    return zz, quant


@pytest.mark.parametrize("seed", range(8))
def test_idct_sweep_gives_pils_pixels(decode, seed):
    """The SIMD IDCT's 16-bit arithmetic: dequantised products, the DC
    shortcut and the sums that wrap, and each pass's saturation, against
    PIL on coefficients and steps up to their limits."""
    zz, quant = sweep_blocks(seed)
    data = blocks_jpeg(zz, quant, 32, 32)
    np.testing.assert_array_equal(decode(data), pil_pixels(data))


# ---- refusals ----

def patched(data: bytes, offset_of, value: bytes) -> bytes:
    at = offset_of(data)
    return data[:at] + value + data[at + len(value):]


def sof_at(data: bytes) -> int:
    """Offset of the first start-of-frame marker's second byte."""
    for m in (b"\xff\xc0", b"\xff\xc1", b"\xff\xc2"):
        if m in data:
            return data.index(m) + 1
    raise AssertionError("no SOF0-2")


def with_sof(data: bytes, precision: int, comps) -> bytes:
    """`data` with its frame header replaced by one of `comps` (id, h, v)."""
    at = sof_at(data) - 1
    length = struct.unpack(">H", data[at + 2:at + 4])[0]
    H, W = struct.unpack(">HH", data[at + 5:at + 9])
    body = struct.pack(">BHHB", precision, H, W, len(comps)) + b"".join(
        bytes([cid, h << 4 | v, 0]) for cid, h, v in comps)
    return data[:at + 2] + struct.pack(">H", len(body) + 2) + body + data[at + 2 + length:]


def progressive_without_last_scan(data: bytes) -> bytes:
    """A progressive file cut before its last scan (the last refinement)."""
    last = data.rindex(b"\xff\xda")
    return data[:last] + b"\xff\xd9"


def refusal_cases():
    a = content(24, 40, 3, "smooth")
    rgb = pil_jpeg(a, quality=90)
    cmyk = io.BytesIO()
    Image.fromarray(a).convert("CMYK").save(cmyk, "JPEG")
    sof = sof_at(rgb)
    return {  # name: (data, what the message names, whether PIL reads the file)
        # SOF9 on Huffman data: PIL reads it, the arithmetic decoder reading
        # Huffman bits through libjpeg's recovery rules
        "arithmetic": (patched(rgb, lambda d: sof, b"\xc9"), None, True),
        # SOF3 on a JFIF file: libjpeg-turbo converts no colours in lossless
        # mode, so PIL raises, and so does the compiled decoder
        "lossless": (patched(rgb, lambda d: sof, b"\xc3"), r"a lossless YCbCr JPEG \(libjpeg-turbo converts no "
                     r"colours in lossless mode", False),
        "hierarchical": (patched(rgb, lambda d: sof, b"\xc5"), r"hierarchical JPEG \(SOF5\)", False),
        "12-bit": (patched(rgb, lambda d: sof + 3, b"\x0c"), r"12-bit samples", False),
        "cmyk": (cmyk.getvalue(), None, True),  # decoded now by the compiled decoder
        "two components": (with_sof(rgb, 8, [(1, 1, 1), (2, 1, 1)]), r"2 colour components", False),
        "dnl height": (patched(rgb, lambda d: sof + 4, b"\x00\x00"), r"a DNL height", False),
        "4x1 ratio": (with_sof(rgb, 8, [(1, 4, 1), (2, 1, 1), (3, 1, 1)]),
                      None, True),  # decoded now: libjpeg's int_upsample replicates
        "fractional ratio": (with_sof(rgb, 8, [(1, 3, 1), (2, 2, 1), (3, 1, 1)]),
                             r"component 1's sampling factors 2x1 \(a fractional chroma ratio\)", False),
        "truncated": (rgb[:len(rgb) // 2], r"truncated data", False),
        "bits left out": (progressive_without_last_scan(pil_jpeg(a, quality=90, progressive=True)),
                          None, True),  # decoded now: PIL's block smoothing
        "not a JPEG": (b"\x89PNG\r\n\x1a\n" + bytes(32), r"not a JPEG file", False),
    }


# The forms the compiled decoder reads (or refuses as PIL does, for what
# the file does wrong) and the plain one, frozen, refuses, by the words of
# its refusal
PLAIN_REFUSES = {"cmyk": r"4 colour components \(CMYK or YCCK\)", "arithmetic": r"arithmetic coding \(SOF9\)",
                 "lossless": r"lossless JPEG \(SOF3\)"}
# Refused where PIL raises too: hierarchical JPEG, 12-bit samples, 2
# components, a DNL height, a fractional chroma ratio, truncated data, a
# file that is not a JPEG.


@pytest.mark.parametrize("case", list(refusal_cases()))
def test_refusals_name_the_file_and_the_form(tmp_path, case):
    """Each form the decoders refuse raises, naming the file and the form;
    a case whose form is read now (no message) gives PIL's pixels (a
    4-component or arithmetic-coded file from the compiled decoder only: the
    plain one refuses it, naming it). The SOF3 file the compiled decoder
    refuses for its scan header, as PIL does, and the plain one as lossless
    JPEG."""
    data, match, pil_reads = refusal_cases()[case]
    if pil_reads:
        Image.open(io.BytesIO(data)).load()
    elif case in ("lossless", "hierarchical"):
        with pytest.raises(OSError):
            Image.open(io.BytesIO(data)).load()  # PIL refuses it too
    if match is None:
        for plain in (False, True) if have_cxx() else (True,):
            if plain and case in PLAIN_REFUSES:
                with pytest.raises(ValueError, match=PLAIN_REFUSES[case]):
                    jpeg.decode_jpeg(data, case, plain=True)
                continue
            np.testing.assert_array_equal(jpeg.decode_jpeg(data, case, plain=plain), pil_pixels(data))
        return
    if case == "truncated":
        with pytest.raises(OSError, match="(?i)truncated"):
            Image.open(io.BytesIO(data)).load()  # PIL refuses it too
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(data)
    messages = []
    for plain in (False, True) if have_cxx() else (True,):
        own_words = plain and case in PLAIN_REFUSES
        with pytest.raises(ValueError, match=PLAIN_REFUSES[case] if own_words else match) as err:
            jpeg.read_jpeg(path, plain=plain)
        assert str(path) in str(err.value)
        if not own_words:
            messages.append(str(err.value))
    assert len(set(messages)) == 1, messages


# What PIL reads and the decoders still refuse, by the words of the refusal
# (ROADMAP.md section 1): nothing now. Hierarchical JPEG, which they refuse,
# PIL raises on too.
STILL_REFUSED = ()
# What the compiled decoder reads (or refuses where PIL raises, by what the
# file does wrong) and the plain one, frozen, refuses by these words; a
# seeded flip that lands on one is counted by its words, and the compiled
# decoder is held to PIL there.
PLAIN_ONLY_REFUSED = ("CMYK or YCCK", "arithmetic coding", "lossless JPEG")


def pil_or_error(data: bytes):
    try:
        return pil_pixels(data)
    except Exception as err:  # PIL raises OSError, SyntaxError, UnidentifiedImageError ...
        return f"PIL: {type(err).__name__}"


@pytest.mark.parametrize("base", ["baseline_restarts", "progressive", "grey_restart_rows"])
def test_decoders_agree_on_corrupted_files(compiled, base):
    """Seeded byte flips in a small file: the compiled decoder gives the
    plain one's pixels or its error message, whichever that is, and both
    give PIL's pixels where PIL returns an image and raise where PIL
    raises. The only exceptions allowed are forms still refused (none
    now), and files that only the plain decoder refuses (4-component,
    arithmetic-coded, lossless) and the compiled one reads, each counted
    by name (none at these seeds); where the compiled decoder raises on
    such a file for what the file does wrong, it is held to PIL."""
    if base == "grey_restart_rows":  # flips that wipe the AC table's DHT leave libjpeg's standard one
        data = bytearray(pil_jpeg(content(21, 35, 1, "noisy", 5), quality=75, restart_marker_rows=1))
    else:
        options = {"restart_marker_blocks": 2} if base == "baseline_restarts" else {"progressive": True}
        data = bytearray(pil_jpeg(content(21, 35, 3, "noisy", 5), quality=75, subsampling="4:2:0", **options))
    rng = np.random.default_rng(6)
    outcomes, exceptions = {"pixels": 0, "raise": 0}, {}
    for _ in range(150):
        bad = bytearray(data)
        for at in rng.integers(2, len(bad), rng.integers(1, 4)):
            bad[at] = int(rng.integers(0, 256))
        results = []
        for decoder in (lambda d: jpeg.decode_jpeg(d, plain=True), compiled):
            try:
                results.append(decoder(bytes(bad)))
            except ValueError as err:
                results.append(str(err))
        got = results[0]
        only = [f for f in PLAIN_ONLY_REFUSED if isinstance(got, str) and f in got and got != results[1]]
        if only:
            if not isinstance(results[1], str):  # read by the compiled decoder only
                exceptions[only[0]] = exceptions.get(only[0], 0) + 1
            got = results[1]  # held to PIL below
        elif isinstance(got, str) or isinstance(results[1], str):
            assert got == results[1]
        else:
            np.testing.assert_array_equal(got, results[1])
        want = pil_or_error(bytes(bad))
        if isinstance(want, str) and isinstance(got, str):
            outcomes["raise"] += 1
        elif isinstance(got, str):
            form = [f for f in STILL_REFUSED if f in got]
            assert form, f"PIL reads a file the decoders refuse: {got}"
            exceptions[form[0]] = exceptions.get(form[0], 0) + 1
        else:
            assert not isinstance(want, str), f"the decoders read a file PIL refuses ({want})"
            np.testing.assert_array_equal(got, want)
            outcomes["pixels"] += 1
    assert exceptions == {}
    assert min(outcomes.values()) >= 20, outcomes  # both outcomes well exercised


# Marker segments cut short by the end of the file after a single-scan
# image's rows: PIL ignores running out there, but libjpeg reads a segment
# byte by byte and raises on a fault in what it has read first. name: (the
# bytes after the scan, the compiled decoder's words, or None: PIL's pixels)
AFTER_THE_ROWS = {
    "second SOF": (b"\xff\xc1\x00\x11\x08\x00", r"a second frame header"),
    "second SOF, no length": (b"\xff\xc0", r"a second frame header"),
    "DHT count over its segment": (b"\xff\xc4\x00\x20\x00" + bytes([0, 0, 200] + [0] * 13),
                                   r"a Huffman table longer than its segment"),
    "DHT index 0x25": (b"\xff\xc4\x00\x40\x25" + bytes([0, 1] + [0] * 14) + b"\x00", r"a Huffman table index 0x25"),
    "DHT short table": (b"\xff\xc4\x00\x0a\x00\x01", r"a short Huffman table"),
    "DQT index 5": (b"\xff\xdb\x00\x43\x05\x01\x02", r"a quantisation table"),
    "DRI length 5": (b"\xff\xdd\x00\x05\x00", r"a DRI segment whose length is not 4"),
    "SOS length": (b"\xff\xda\x00\x20\x01", r"a scan header"),
    "SOS component id": (b"\xff\xda\x00\x08\x01\x07\x00", r"a scan of component id 7"),
    "DAC index": (b"\xff\xcc\x00\x10\x40\x10", r"a DAC table index 0x40"),
    "APP1 cut short": (b"\xff\xe1\x00\x40Exif\x00\x00", None),
    "DHT cut short, sound so far": (b"\xff\xc4\x00\x40\x00" + bytes([0, 1] + [0] * 14), None),
    "COM cut short": (b"\xff\xfe\x00\x30abc", None),
}


@pytest.mark.parametrize("case", list(AFTER_THE_ROWS))
def test_segments_cut_short_after_the_rows_read_or_fail_as_pil(compiled, case):
    """A baseline file whose EOI is replaced by a marker segment cut short:
    where what libjpeg reads of it first is a fault (a second frame
    header, before its length; a Huffman table's counts or index; a DQT
    index; a DRI or SOS length; a scan's component id; a DAC index), PIL
    raises and so does the compiled decoder; else both give the pixels.
    (The plain decoder, frozen, reads them all.)"""
    tail, words = AFTER_THE_ROWS[case]
    data = pil_jpeg(content(24, 40, 3, "smooth"), quality=90)[:-2] + tail
    if words is None:
        np.testing.assert_array_equal(compiled(data), pil_pixels(data))
        return
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(ValueError, match=words):
        compiled(data)


# ---- libjpeg's recovery, case by case ----

def scan_starts(data: bytes) -> list:
    out, i = [], data.find(b"\xff\xda")
    while i >= 0:
        out.append(i)
        i = data.find(b"\xff\xda", i + 2)
    return out


def entropy_start(data: bytes) -> int:
    sos = data.index(b"\xff\xda")
    return sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")


def restart_offsets(data: bytes) -> list:
    return [i for i in range(entropy_start(data), len(data) - 1)
            if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]


class _BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, value, n):
        self.bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]

    def data(self) -> bytes:
        bits = self.bits + [1] * (-len(self.bits) % 8)
        out = bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))
        return out.replace(b"\xff", b"\xff\x00")


def hand_coded(kind: str) -> bytes:
    """Two grey 8x8 blocks in the SWEEP tables: a run past coefficient 63
    (ZRL three times, then run 15 size 2 from index 49), or a bad AC code
    (an 8-bit window no code starts, which libjpeg reads as 17 bits of
    symbol 0), each followed by an ordinary block."""
    w = _BitWriter()
    ac = {sym: i for i, sym in enumerate(SWEEP_AC_SYMBOLS)}
    w.put(5, 5), w.put(0b10110, 5)  # DC category 5: +22
    if kind == "run past 63":
        for _ in range(3):
            w.put(ac[0xF0], 8)
        w.put(ac[0xF2], 8), w.put(0b11, 2)  # lands on natural index 63, value 3
    else:
        w.put(0xF7, 8), w.put(0b101100110, 9)  # no code: 17 bits read, symbol 0 (EOB)
    w.put(3, 5), w.put(0b100, 3)  # block 2: DC +4 more
    w.put(ac[0x12], 8), w.put(0b01, 2)  # run 1, size 2: -2 at index 2
    w.put(ac[0x00], 8)
    return grey_jpeg(w.data(), np.full(64, 4), 16, 8)


def recovery_cases():
    a = content(64, 80, 3, "smooth", 1)
    d = pil_jpeg(a, quality=90)
    sos, dqt, start = d.index(b"\xff\xda"), d.index(b"\xff\xdb"), entropy_start(d)
    r = pil_jpeg(a, quality=90, restart_marker_blocks=3)
    rst = restart_offsets(r)
    p = pil_jpeg(a, quality=90, progressive=True)
    scans = scan_starts(p)
    parts = [p[scans[j]:(scans[j + 1] if j + 1 < len(scans) else len(p) - 2)] for j in range(len(scans))]
    head = p[:scans[0]]

    def flipped(data, at, bit):
        b = bytearray(data)
        b[at] ^= 1 << bit
        return bytes(b)

    def restart(data, k, value):
        b = bytearray(data)
        b[rst[k] + 1:rst[k] + 2] = value
        return bytes(b)

    return {
        "extraneous bytes before SOS": d[:sos] + b"\x12\x34" + d[sos:],
        "extraneous bytes and stuffing before DQT": d[:dqt] + b"\x00\xff\x00\x55" + d[dqt:],
        "extraneous bytes before EOI": d[:-2] + b"\x01\x02\x03" + d[-2:],
        "flipped entropy byte 1": flipped(d, start + 100, 3),
        "flipped entropy byte 2": flipped(d, start + 700, 6),
        "flipped entropy byte 3": flipped(d, len(d) - 40, 0),
        "bad Huffman code": hand_coded("bad code"),
        "run past 63": hand_coded("run past 63"),
        "data ends early at EOI": d[:(start + len(d)) // 2] + b"\xff\xd9",
        "data ends early at a restart": r[:rst[1] - 30] + r[rst[1]:],
        "restart out of sequence": restart(r, 1, b"\xd5"),
        "restart one ahead": restart(r, 2, b"\xd4"),
        "restart one behind": restart(r, 3, b"\xd2"),
        "restart missing": r[:rst[2]] + r[rst[2] + 2:],
        "restart turned into garbage": restart(r, 1, b"\x42"),
        "restart turned into APP3": restart(r, 4, b"\xe3"),
        "scans out of order": head + b"".join(parts[j] for j in [0, 1, 2, 3, 4, 6, 5, 7, 8, 9]) + b"\xff\xd9",
        "a scan repeated": head + b"".join(parts[j] for j in [0, 6, 1, 2, 3, 4, 5, 7, 8, 9]) + b"\xff\xd9",
        "refinement before its first scan": head + b"".join(parts[j] for j in [0, 1, 2, 3, 4, 5, 9, 7, 8, 6]) + b"\xff\xd9",
        "sequential scan not 0..63": patched(d, lambda x: sos + 2 + 2 + 1 + 6, b"\x05\x3e"),
        "missing EOI after enough trailing bytes": d[:-2] + bytes(20),
        "no DHT: libjpeg's standard tables": without_dht(encode_jpeg(content(64, 80, 3, "noisy", 1), 90)),
    }


def without_dht(data: bytes) -> bytes:
    """`data` without its DHT segments (they hold the standard tables)."""
    while b"\xff\xc4" in data:
        at = data.index(b"\xff\xc4")
        data = data[:at] + data[at + 2 + int.from_bytes(data[at + 2:at + 4], "big"):]
    return data


@pytest.mark.parametrize("case", list(recovery_cases()))
def test_recovery_gives_pils_pixels(decode, case):
    """Where libjpeg warns and carries on, both decoders give PIL's pixels."""
    data = recovery_cases()[case]
    want = pil_or_error(data)
    assert not isinstance(want, str), want  # PIL reads every case
    np.testing.assert_array_equal(decode(data, case), want)


def progressive_cuts():
    """Progressive files cut after each of their scans (EOI kept), so block
    smoothing runs with every pattern of coefficient bits left out: DC only
    (the 5x5 DC interpolation), bands and refinements missing, 4:2:0 with a
    padding block row (its row two below), 4:2:2, 4:4:4, grey, and images
    one and two blocks wide."""
    for h, w, c, sub, q in [(35, 21, 3, "4:2:0", 75), (97, 129, 3, "4:2:0", 90), (40, 17, 3, "4:2:2", 95),
                            (45, 67, 3, "4:4:4", 90), (45, 67, 1, None, 85), (24, 16, 3, "4:2:0", 50)]:
        options = dict(quality=q, progressive=True)
        if sub:
            options["subsampling"] = sub
        data = pil_jpeg(content(h, w, c, "noisy" if h % 2 else "smooth", 3), **options)
        yield f"{w}x{h} {sub or 'grey'}", [data[:at] + b"\xff\xd9" for at in scan_starts(data)[1:]]


@pytest.mark.parametrize("name", [name for name, _ in progressive_cuts()])
def test_block_smoothing_gives_pils_pixels(decode, name):
    cuts = dict(progressive_cuts())[name]
    for k, data in enumerate(cuts):
        np.testing.assert_array_equal(decode(data), pil_pixels(data), err_msg=f"cut after {k + 1} scans")


# ---- the committed fixtures ----

FIXTURE_NAMES = sorted(p.stem for p in FIXTURES.glob("*.jpg"))


def test_fixtures_are_committed_in_pairs():
    assert len(FIXTURE_NAMES) >= 22
    assert sorted(p.stem for p in FIXTURES.glob("*.npz")) == FIXTURE_NAMES
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 1.5 * 2**20
    assert max(p.stat().st_size for p in FIXTURES.iterdir()) <= 400 * 2**10


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_pixels_are_pils(decode, name):
    """PIL's decode of each committed file equals the pixels committed
    beside it (which chip_smoke.py holds the decoders to on the card's
    machine, where there is no PIL), and so does the decoder's."""
    data = (FIXTURES / f"{name}.jpg").read_bytes()
    want = np.load(FIXTURES / f"{name}.npz")["pixels"]
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), want)
    got = decode(data, name)
    np.testing.assert_array_equal(got[..., 0] if want.ndim == 2 else got, want)


# ---- read_image ----

# a 4x4 MacPaint (MSP) image, mode "1", all white, as PIL writes it: its 32-byte header, then each
# row's bytes; PIL reads it, the port does not
MSP_4X4 = (b"DanM\x04\x00\x04\x00\x01\x00\x01\x00\x01\x00\x01\x00\x04\x00\x04\x00\x00\x00\x00\x00*,"
           + bytes(6) + b"\xf0" * 4)


def test_read_image_dispatches_on_the_signature(tmp_path, compiled, monkeypatch):
    a = content(20, 30, 3, "smooth")
    png, jpg, junk_bmp, other = (tmp_path / n for n in ("a.png", "a.jpg", "a.bmp", "a.msp"))
    image_io.write_png(png, a)
    jpg.write_bytes(pil_jpeg(a, quality=90))
    junk_bmp.write_bytes(b"BM" + bytes(64))
    other.write_bytes(MSP_4X4)  # PIL reads it, the port does not

    def no_plain(*args):
        raise AssertionError("read_image reached the plain decoder")

    monkeypatch.setattr(jpeg, "_Decoder", no_plain)
    np.testing.assert_array_equal(image_io.read_image(png), a)
    np.testing.assert_array_equal(image_io.read_image(jpg), pil_pixels(jpg.read_bytes()))
    with pytest.raises(ValueError, match="a BMP header of 0 bytes") as err:
        image_io.read_image(junk_bmp)  # the BMP reader's refusal
    assert str(junk_bmp) in str(err.value)
    with pytest.raises(ValueError, match="not a PNG, JPEG, BMP, DIB, TIFF, WebP, GIF, PPM / PGM / PBM / PFM, TGA, "
                                         "JPEG 2000, QOI, PCX / DCX, SGI, ICO / CUR, PSD, DDS, AVIF, BLP, FITS, "
                                         "FLI / FLC, FTEX, GBR, ICNS or EPS file") as err:
        image_io.read_image(other)
    assert str(other) in str(err.value)
    with pytest.raises(ValueError, match="JPEG"):
        image_io.read_png(jpg)  # read_png still refuses JPEG


# ---- the host build ----

FAKE_CXX = """#!/bin/sh
# stand-in host compiler: count the calls, then fail or run the real one
echo call >> "{calls}"
[ "{fail}" = "1" ] && {{ echo "error: bad source"; exit 2; }}
exec "{real}" "$@"
"""


@pytest.fixture
def fake_cxx(tmp_path, monkeypatch):
    """Install a stand-in `c++` (on PATH, or named by CXX) and a fresh
    build directory; the loaded library is forgotten before and after."""
    def install(fail, via="PATH"):
        bindir = tmp_path / "bin"
        bindir.mkdir(exist_ok=True)
        cxx = bindir / "c++"
        cxx.write_text(FAKE_CXX.format(calls=tmp_path / "calls", fail=int(fail),
                                       real=shutil.which("c++") or "/bin/false"))
        cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
        if via == "PATH":
            monkeypatch.delenv("CXX", raising=False)
            monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
        else:
            monkeypatch.setenv("CXX", str(cxx))
        monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
        cuda_build.load_host.cache_clear()
        return tmp_path / "calls"

    yield install
    cuda_build.load_host.cache_clear()


@pytest.mark.parametrize("via", ["PATH", "CXX"])
def test_failed_host_build_raises_and_nothing_falls_back(tmp_path, fake_cxx, via):
    fake_cxx(fail=True, via=via)
    path = tmp_path / "a.jpg"
    path.write_bytes(pil_jpeg(content(8, 8, 3, "smooth"), quality=90))
    with pytest.raises(RuntimeError, match="bad source"):
        image_io.read_image(path)
    assert not cuda_build.host_library_path("jpeg_decode").exists()
    assert not list(cuda_build.BUILD_DIR.glob("*.tmp.so"))


def test_missing_host_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="host C\\+\\+ compiler 'c\\+\\+' not found"):
        cuda_build.build_host()


def test_host_build_and_its_reuse(fake_cxx):
    """The real compiler behind a counting stand-in: one build, then reuse;
    the .cu sources stay the kernels' list; one build per host source."""
    if shutil.which("c++") is None:
        pytest.skip("no host C++ compiler (c++) on this machine")
    calls = fake_cxx(fail=False)
    hosts = ["av1_decode", "bcn_decode", "fax_decode", "image_codecs", "jp2_decode", "jpeg_decode", "webp_decode",
             "zstd_decode"]
    assert cuda_build.host_sources() == hosts
    assert not set(hosts) & set(cuda_build.sources())
    cuda_build.build_host()
    path = cuda_build.host_library_path("jpeg_decode")
    assert path.exists() and path.parent == cuda_build.BUILD_DIR
    cuda_build.build_host()
    data = pil_jpeg(content(9, 13, 3, "noisy"), quality=80)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), pil_pixels(data))
    assert calls.read_text().count("call") == len(hosts)
