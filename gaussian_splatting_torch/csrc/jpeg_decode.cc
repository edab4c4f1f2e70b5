// JPEG decoding for the dataset readers: host C++, built with the host
// compiler by utils/cuda_build.py at first use and loaded with ctypes.
//
// The same decoder as the plain version in utils/jpeg.py, step for step:
// the same checks in the same order with the same messages, the same bits
// out (PIL's: libjpeg-turbo 3's C code at its defaults), and beyond it
// 4-component (CMYK and YCCK) files, which the plain version refuses.
// Huffman-coded 8-bit baseline, extended and progressive frames with 1, 3
// or 4 components;
// restart intervals with jpeg_resync_to_restart's recovery; libjpeg's
// recovery from corrupt entropy-coded data (bad codes decode as 0, runs
// past coefficient 63 land on the padded natural order, data that ends
// early reads as zeros and leaves the rest of its restart interval zero);
// the "islow" IDCT in the 16-bit arithmetic of its SIMD form; block
// smoothing of progressive files with coefficient bits left out; fancy
// upsampling at chroma ratios 2x1, 2x2 and 1x2, replication at other
// integral ratios and for h2v1 / h2v2 on components 2 or fewer samples
// wide; jdcolor.c's fixed-point YCbCr -> RGB; for 4 components
// jdapimin.c's rule (YCCK under an Adobe marker whose transform is not 0,
// else CMYK as stored), jdcolor.c's ycck_cmyk_convert on the same tables,
// and PIL's "CMYK;I" unpacking, which inverts every sample.
//
// Beyond the plain version too: arithmetic coding (SOF9, SOF10 with DAC
// conditioning) as jdarith.c decodes it, within PIL's 65536-byte blocks
// (kPilBlock), and lossless frames (SOF3) as libjpeg-turbo 3's jddiffct.c,
// jdlhuff.c and jdlossls.c decode them, with no colour conversion and no
// fancy upsampling. Everything else is refused by name, where PIL raises:
// hierarchical frames, SOF11, lossless YCbCr.
//
// The strips and tiles of a JPEG-in-TIFF (compression 7) are read as
// libtiff's tif_jpeg.c reads them for PIL: the JPEGTables tag's tables-only
// stream first (its DQT and DHT segments kept for the strip, as libjpeg
// keeps them across jpeg_read_header; a frame or scan in it is refused,
// libtiff's "Bogus JPEGTables field"), then the abbreviated stream, whose
// SOI resets the restart interval and the JFIF / Adobe markers. libtiff
// reads every photometric but YCbCr with no colour conversion (JCS_UNKNOWN
// in and out), so the components come out as decoded, 1 to 4 of them,
// every sampling factor 1. YCbCr (photometric 6) PIL reads with libtiff's
// JPEGCOLORMODE_RGB: the first component sampled as the YCbCrSubsampling
// tag says and the others 1x1 (libtiff's "Improper JPEG sampling factors"),
// converted YCbCr -> RGB whatever the markers say, upsampled as libjpeg
// upsamples (each strip its own stream: nothing crosses strips). The
// frame must match the strip or tile: its components the samples per
// pixel, its size the strip's rows (the tile's) by the width (libtiff's
// checks; a smaller frame, which libtiff only warns about, leaves rows of
// PIL's image uninitialised, and is refused; the last strip of an image
// may be coded taller, of which libtiff reads the rows it needs). Where a
// stream's bytes end, libtiff's source manager hands libjpeg a fake EOI
// marker at every further read, so each stream is read here followed by
// (0xFF, EOI) pairs, longer than any marker segment: entropy-coded data
// that ends early stops at that marker (zeros for the rest of its MCU and
// interval), a segment cut short reads those bytes, as libjpeg does.
//
// Old-style JPEG-in-TIFF (compression 6) libtiff decodes with libjpeg's
// raw data output (utils/ojpeg.py builds the stream as libtiff does): the
// components' samples at their own sampling, whole MCUs, no upsampling and
// no colour conversion; a restart marker other than the one expected fails
// libtiff's codec for the rest of the image (its resync_to_restart raises),
// which gs_jpeg_decode_raw reports as the MCU rows delivered before it.
//
// Interface (plain C; every entry returns 0 or an error, whose message
// gs_jpeg_error gives for the calling thread):
//   gs_jpeg_decode(data, size, out, cap, hwc, as_cmyk)
//                                         hwc[0..2] = height, width, channels, then (out not null)
//                                         (H, W, C) uint8 into out (cap bytes); as_cmyk: a
//                                         4-component frame as stored (PIL's jpegmode "CMYK")
//   gs_jpeg_decode_tiff(tables, tables_size, data, size, height, width, channels, ycbcr_h, ycbcr_v,
//                       last_strip, out)
//                                         a JPEG-in-TIFF strip or tile, (H, W, C) uint8; ycbcr_h 0:
//                                         no colour conversion
//   gs_jpeg_raw_layout(data, size, layout) components, size, and each one's sampling and raw plane size
//   gs_jpeg_decode_raw(data, size, out, cap, good_rows)
//                                         libjpeg's raw data output: each component's samples at its
//                                         own sampling (no upsampling, no colour conversion), for
//                                         old-style JPEG-in-TIFF (utils/ojpeg.py)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

struct Refused {
  std::string msg;
};

[[noreturn]] void refuse(const std::string& msg) { throw Refused{msg}; }
[[noreturn]] void corrupt(const std::string& what) { throw Refused{"corrupt data: " + what}; }
[[noreturn]] void truncated() { refuse("truncated data"); }

// PIL hands libjpeg a JPEG file in blocks of ImageFile.MAXBLOCK bytes, each
// call with the bytes read so far; a scan that libjpeg starts in a call is
// decoded in it, and its arithmetic decoder, unlike the Huffman one, cannot
// wait for the next block (jdarith.c's get_byte: JERR_CANT_SUSPEND).
const int64_t kPilBlock = 65536;
const char* const kPastRead =
    "arithmetic-coded data past the bytes PIL has read when libjpeg decodes its scan (PIL reads a file in "
    "65536-byte blocks and libjpeg's arithmetic decoder cannot wait for the next: broken data stream)";

std::string fmt(const char* f, int a, int b = 0, int c = 0) {
  char buf[256];
  std::snprintf(buf, sizeof buf, f, a, b, c);
  return buf;
}

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jutils.c's jpeg_natural_order: 16 extra entries of 63 for corrupt runs
int natural(int k) { return k < 64 ? kZigzag[k] : 63; }

const int kMaxDimension = 65500;           // JPEG_MAX_DIMENSION
const int64_t kMaxPixels = 2 * 89478485LL;  // PIL's DecompressionBombError limit
const int kMaxBlocksInMcu = 10;            // D_MAX_BLOCKS_IN_MCU

inline int16_t s16(int64_t x) { return static_cast<int16_t>(static_cast<uint16_t>(x & 0xFFFF)); }

bool refusal(int sof, std::string* msg) {
  if ((sof >= 5 && sof <= 7) || sof >= 13) {
    *msg = fmt("hierarchical JPEG (SOF%d)", sof);
  } else if (sof == 11) {
    *msg = "arithmetic-coded lossless JPEG (SOF11; libjpeg-turbo: arithmetic coding is not implemented for it)";
  } else {
    return false;
  }
  return true;
}

// jpeg_make_d_derived_tbl as a 16-bit lookup: (length << 8) | symbol for
// every 16-bit window that starts with a code, 0 where none does (a bad
// code: libjpeg reads 17 bits and decodes 0).
struct HuffSpec {
  bool defined = false;
  int counts[16];
  std::vector<uint8_t> symbols;
};

std::vector<uint16_t> huffman_lut(const HuffSpec& t, bool is_dc, bool lossless = false) {
  int total = 0;
  for (int l = 0; l < 16; ++l) total += t.counts[l];
  if (total > 256) corrupt("a Huffman table of more than 256 codes");
  std::vector<uint16_t> lut(1 << 16, 0);
  uint32_t code = 0;
  int p = 0;
  for (int length = 1; length <= 16; ++length) {
    for (int i = 0; i < t.counts[length - 1]; ++i) {
      int sym = t.symbols[p];
      if (is_dc && sym > (lossless ? 16 : 15))
        corrupt(lossless ? "a lossless Huffman symbol over 16" : "a DC Huffman symbol over 15");
      if (code < (1u << length)) {
        int span = 16 - length;
        uint16_t e = static_cast<uint16_t>((length << 8) | sym);
        std::fill(lut.begin() + (code << span), lut.begin() + ((code + 1) << span), e);
      }
      ++code;
      ++p;
    }
    if (code >= (1u << length)) corrupt("a Huffman table whose codes overflow");
    code <<= 1;
  }
  return lut;
}

// jstdhuff.c's tables (JPEG Annex K.3 to K.6), put in Huffman slots 0 and 1
// that no DHT has filled by the first sequential scan.
void std_table(int kind, int slot, HuffSpec* t) {
  static const int counts[4][16] = {
      {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
      {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},
      {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
      {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119}};
  static const char* heads[2] = {
      "010203000411051221314106135161072271143281" "91a1082342b1c11552d1f02433627282090a16",
      "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f1"};
  const int* c = counts[kind * 2 + slot];
  std::copy(c, c + 16, t->counts);
  t->symbols.clear();
  if (kind == 0) {
    for (int s = 0; s < 12; ++s) t->symbols.push_back(static_cast<uint8_t>(s));
  } else {
    bool used[256] = {false};
    const char* h = heads[slot];
    for (size_t i = 0; i + 1 < std::strlen(h); i += 2) {
      int b = static_cast<int>(std::strtol(std::string(h + i, 2).c_str(), nullptr, 16));
      t->symbols.push_back(static_cast<uint8_t>(b));
      used[b] = true;
    }
    for (int b = 0; b < 256; ++b) {
      bool valid = b == 0x00 || b == 0xF0 || ((b & 15) >= 1 && (b & 15) <= 10);
      if (valid && !used[b]) t->symbols.push_back(static_cast<uint8_t>(b));
    }
  }
  t->defined = true;
}

struct Component {
  int index = 0, id = 0, h = 1, v = 1, tq = 0;
  bool latched = false;
  int64_t quant[64] = {};  // natural order, as the DQT gave it (UINT16)
  int bw = 0, bh = 0, nbx = 0, nby = 0, stride = 0, rows = 0;
  std::vector<int16_t> coef;  // JCOEF
  int bits[64] = {}, prev_bits[64] = {};
  std::vector<uint8_t> plane;  // lossless: the samples (bh x bw)
};

// Bits of one stretch of entropy-coded data, most significant first, in
// 32-bit words; zeros past the end, as libjpeg stuffs them after a marker.
// `tracked` adds libjpeg-turbo's slow-path bit buffer, for data that runs to
// the end of the file: a fill that reaches it is PIL's truncation.
struct Bits {
  const uint8_t* seg;
  int64_t size, w = 0;
  uint64_t acc = 0;
  int n = 0;
  bool insufficient = false, tracked = false;
  int64_t used = 0, read = 0;

  explicit Bits(const std::vector<uint8_t>& s) : seg(s.data()), size(static_cast<int64_t>(s.size())) {}
  uint32_t word(int64_t i) const {
    uint32_t x = 0;
    for (int64_t b = 4 * i; b < 4 * i + 4; ++b) x = (x << 8) | (b < size ? seg[b] : 0u);
    return x;
  }
  void refill() {
    acc = ((acc & ((uint64_t(1) << n) - 1)) << 32) | word(w);
    ++w;
    n += 32;
  }
  void need(int k) {
    if (8 * read - used < k) {
      read = (used + 64) / 8;
      if (read > size) truncated();
    }
  }
  int bits(int s) {
    if (tracked) {
      need(s);
      used += s;
    }
    if (n < s) refill();
    n -= s;
    return static_cast<int>((acc >> n) & ((uint64_t(1) << s) - 1));
  }
  int huff(const uint16_t* lut) {
    if (n < 17) refill();
    uint16_t e = lut[(acc >> (n - 16)) & 0xFFFF];
    if (tracked) {  // HUFF_DECODE's lookahead, then jpeg_huff_decode's bits
      need(8);
      int length = e ? e >> 8 : 17;
      if (length <= 8) {
        used += length;
      } else {
        need(9);
        used += 9;
        for (int i = 9; i < length; ++i) {
          need(1);
          used += 1;
        }
      }
    }
    if (!e) {
      n -= 17;
      return 0;
    }
    n -= e >> 8;
    return e & 255;
  }
  // Whether the MCU just decoded read past the data (insufficient_data).
  bool done_mcu() {
    insufficient = !tracked && w * 32 - n > 8 * size;
    return insufficient;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ---- arithmetic decoding (T.81 Annex D, as jdarith.c does it) ----

// Table D.2 (jaricom.c's jpeg_aritab): Qe, the next index after an LPS and
// after an MPS, the MPS switch; entry 113 is libjpeg's fixed 0.5 estimate.
const uint16_t kQe[114] = {
    0x5a1d, 0x2586, 0x1114, 0x080b, 0x03d8, 0x01da, 0x00e5, 0x006f, 0x0036, 0x001a, 0x000d, 0x0006, 0x0003,
    0x0001, 0x5a7f, 0x3f25, 0x2cf2, 0x207c, 0x17b9, 0x1182, 0x0cef, 0x09a1, 0x072f, 0x055c, 0x0406, 0x0303,
    0x0240, 0x01b1, 0x0144, 0x00f5, 0x00b7, 0x008a, 0x0068, 0x004e, 0x003b, 0x002c, 0x5ae1, 0x484c, 0x3a0d,
    0x2ef1, 0x261f, 0x1f33, 0x19a8, 0x1518, 0x1177, 0x0e74, 0x0bfb, 0x09f8, 0x0861, 0x0706, 0x05cd, 0x04de,
    0x040f, 0x0363, 0x02d4, 0x025c, 0x01f8, 0x01a4, 0x0160, 0x0125, 0x00f6, 0x00cb, 0x00ab, 0x008f, 0x5b12,
    0x4d04, 0x412c, 0x37d8, 0x2fe8, 0x293c, 0x2379, 0x1edf, 0x1aa9, 0x174e, 0x1424, 0x119c, 0x0f6b, 0x0d51,
    0x0bb6, 0x0a40, 0x5832, 0x4d1c, 0x438e, 0x3bdd, 0x34ee, 0x2eae, 0x299a, 0x2516, 0x5570, 0x4ca9, 0x44d9,
    0x3e22, 0x3824, 0x32b4, 0x2e17, 0x56a8, 0x4f46, 0x47e5, 0x41cf, 0x3c3d, 0x375e, 0x5231, 0x4c0f, 0x4639,
    0x415e, 0x5627, 0x50e7, 0x4b85, 0x5597, 0x504f, 0x5a10, 0x5522, 0x59eb, 0x5a1d};
const uint8_t kNextLps[114] = {
    1,  14, 16, 18, 20, 23, 25, 28,  30,  33,  35,  9,   10,  12,  15,  36,  38,  39,  40,  42,  43,  45, 46,
    48, 49, 51, 52, 54, 56, 57, 59,  60,  62,  63,  32,  33,  37,  64,  65,  67,  68,  69,  70,  72,  73, 74,
    75, 77, 78, 79, 48, 50, 50, 51,  52,  53,  54,  55,  56,  57,  58,  59,  61,  61,  65,  80,  81,  82, 83,
    84, 86, 87, 87, 72, 72, 74, 74,  75,  77,  77,  80,  88,  89,  90,  91,  92,  93,  86,  88,  95,  96, 97,
    99, 99, 93, 95, 101, 102, 103, 104, 99, 105, 106, 107, 103, 105, 108, 109, 110, 111, 110, 112, 112, 113};
const uint8_t kNextMps[114] = {
    1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 13, 15, 16, 17,  18,  19,  20,  21, 22, 23,
    24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 9,  37, 38, 39, 40,  41,  42,  43,  44, 45, 46,
    47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63,  32,  65,  66,  67, 68, 69,
    70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 48, 81, 82, 83, 84, 85, 86,  87,  71,  89,  90, 91, 92,
    93, 94, 86, 96, 97, 98, 99, 100, 93, 102, 103, 104, 99, 106, 107, 103, 109, 107, 111, 109, 111, 113};
const uint8_t kSwitch[114] = {1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                              0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                              0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0,
                              0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1, 0};

// jdarith.c's decoder state over the raw bytes of one restart interval: the
// C and A registers and the bit counter CT (-16 until the first two bytes
// are in). A byte is read only when renormalisation needs it. 0xFF 0x00 is
// a stuffed 0xFF; at a marker the marker is kept (`marker`) and zeros are
// read from then on. Reading at or past `limit` raises: the end of the
// bytes PIL has handed libjpeg in the call that decodes the scan (its
// arithmetic decoder cannot suspend for more) or of the stream.
struct Arith {
  const uint8_t* data;
  int64_t pos, limit;
  bool marker;
  int64_t c = 0, a = 0;
  int ct = -16;

  Arith(const uint8_t* d, int64_t p, int64_t lim, bool at_marker) : data(d), pos(p), limit(lim), marker(at_marker) {}
  int byte() {
    if (pos >= limit) refuse(kPastRead);
    return data[pos++];
  }
  // Statistics bins hold (MPS << 7) | state index, as libjpeg keeps them.
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int d = 0;
        if (!marker) {
          d = byte();
          if (d == 0xFF) {
            do d = byte();
            while (d == 0xFF);
            if (d == 0) {
              d = 0xFF;
            } else {
              marker = true;
              d = 0;
            }
          }
        }
        c = (c << 8) | d;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st, i = sv & 0x7F;
    int64_t qe = kQe[i];
    int nl = (kSwitch[i] << 7) | kNextLps[i], nm = kNextMps[i];
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional exchange: the MPS after all
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// ---- reconstruction ----

const int64_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433, F_0_765 = 6270, F_0_899 = 7373,
              F_1_175 = 9633, F_1_501 = 12299, F_1_847 = 15137, F_1_961 = 16069,
              F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

inline int64_t i16(int64_t x) { return s16(x); }

// (x + half) >> n of a 32-bit lane: the sum wraps to 32 bits first.
inline int64_t descale32(int64_t x, int n) {
  int32_t v = static_cast<int32_t>(static_cast<uint32_t>((x + (int64_t(1) << (n - 1))) & 0xFFFFFFFF));
  return v >> n;
}

// One pass of libjpeg-turbo's SIMD islow IDCT (jidctint-avx2.asm) on the
// int16 inputs s[0..7] at stride `is`: products in 32 bits (pmaddwd), the
// sums in0 +- in4, in7 + in3 and in5 + in1 in 16 bits, the rest in 32
// bits, each output descaled and saturated to 16 bits (packssdw).
inline void idct_pass(const int64_t* s, int is, int descale, int64_t* o) {
  int64_t i0 = s[0], i1 = s[is], i2 = s[2 * is], i3 = s[3 * is], i4 = s[4 * is], i5 = s[5 * is],
          i6 = s[6 * is], i7 = s[7 * is];
  int64_t tmp3 = i2 * (F_0_541 + F_0_765) + i6 * F_0_541;
  int64_t tmp2 = i2 * F_0_541 + i6 * (F_0_541 - F_1_847);
  int64_t tmp0 = i16(i0 + i4) * 8192, tmp1 = i16(i0 - i4) * 8192;
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t z3 = i16(i7 + i3), z4 = i16(i5 + i1);
  int64_t z3p = z3 * (F_1_175 - F_1_961) + z4 * F_1_175;
  int64_t z4p = z3 * F_1_175 + z4 * (F_1_175 - F_0_390);
  int64_t t0 = i7 * (F_0_298 - F_0_899) - i1 * F_0_899 + z3p;
  int64_t t3 = i1 * (F_1_501 - F_0_899) - i7 * F_0_899 + z4p;
  int64_t t1 = i5 * (F_2_053 - F_2_562) - i3 * F_2_562 + z4p;
  int64_t t2 = i3 * (F_3_072 - F_2_562) - i5 * F_2_562 + z3p;
  int64_t outs[8] = {tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                     tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3};
  for (int k = 0; k < 8; ++k) o[k] = std::min<int64_t>(std::max<int64_t>(descale32(outs[k], descale), -32768), 32767);
}

// jsimd_idct_islow of one block (natural order, row = vertical frequency)
// with the wrapped steps q -> 8x8 samples at `out`: 16-bit dequantisation
// (pmullw); a block whose rows 1..7 are zero takes the column pass's
// shortcut, DC << 2 in 16 bits; the outputs saturate to -128..127 + 128.
void idct_islow(const int16_t* coef, const int64_t* q, uint8_t* out, int64_t stride) {
  int64_t deq[64], ws[64], col[8], row[8];
  bool dc_only = true;
  for (int i = 0; i < 64; ++i) {
    deq[i] = i16(int64_t(coef[i]) * q[i]);
    if (i >= 8 && coef[i]) dc_only = false;
  }
  if (dc_only) {
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c) ws[r * 8 + c] = i16(deq[c] * 4);
  } else {
    for (int c = 0; c < 8; ++c) {
      idct_pass(deq + c, 8, 11, col);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = col[r];
    }
  }
  for (int r = 0; r < 8; ++r) {
    idct_pass(ws + r * 8, 1, 18, row);
    for (int c = 0; c < 8; ++c)
      out[r * stride + c] = static_cast<uint8_t>(std::min<int64_t>(std::max<int64_t>(row[c], -128), 127) + 128);
  }
}

// jdcoefct.c decompress_smooth_data's estimates: coefficients 1..9 in
// zig-zag order at their natural positions, and the 5x5 DC kernels (rows
// above to below, columns left to right) that estimate each; the first five
// where the component has AC data, the nine (and the DC) where it has none.
const int kSmoothPos[9] = {1, 8, 16, 9, 2, 3, 10, 17, 24};
const int kAc[5][25] = {
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0, 0, 0, 7, 0, 0},
    {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0, 0, 0, -1, 0, 0},
    {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1, 0, 1, 0, -1, 0},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
const int kDc[9][25] = {
    {-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3, -3, 13, 0, -13, 3, -1, -1, 0, 1, 1},
    {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0, 1, -13, -38, -13, 1, 1, 3, 3, 3, 1},
    {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2, 0, 0, 0, 1, 0, 0},
    {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0, 1, 0, 0, 0, -1},
    {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0, 0, 0, 0, 0, 0}};
const int kDc00[25] = {-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8,
                       -6, 6, 42, 6, -6, -2, -6, -8, -6, -2};

int64_t smooth_pred(int64_t num, int64_t q, int al) {
  int64_t pred = ((q << 7) + (num < 0 ? -num : num)) / (q << 8);
  if (al > 0 && pred >= (int64_t(1) << al)) pred = (int64_t(1) << al) - 1;
  return num < 0 ? -pred : pred;
}

// The smoothed coefficients of a component's real blocks (a copy). The
// neighbours: the edge block where one is off the image. Rows are placed as
// decompress_smooth_data places them, at iMCU row i, block row b as
// i * block_rows + b of block_rows * n_imcu (block_rows: the real rows of
// row i), so a row two below may be padding, and a short last iMCU row
// counts them off.
std::vector<int16_t> smooth(const Component& c, int n_imcu, int last_good, int scans) {
  std::vector<int16_t> out(c.coef);
  int prev[64];
  for (int k = 0; k < 64; ++k) prev[k] = scans > 1 ? c.prev_bits[k] : -1;
  auto dc = [&](int r, int b) { return int64_t(c.coef[(int64_t(r) * c.stride + b) * 64]); };
  int last = n_imcu - 1;
  for (int r = 0; r < c.nby; ++r) {
    int imcu = r / c.v, b = r % c.v;
    int block_rows = imcu < last ? c.v : (c.nby % c.v ? c.nby % c.v : c.v);
    int at = imcu * block_rows + b, count = block_rows * n_imcu;
    int p = at > 0 ? r - 1 : r, pp = at > 1 ? r - 2 : p;
    int nx = at < count - 1 ? r + 1 : r;
    int src_rows[5] = {pp, p, r, nx, at < count - 2 ? r + 2 : nx};
    const int* bits = r / c.v > last_good ? prev : c.bits;
    bool change_dc = true;
    for (int k = 1; k <= 9; ++k) change_dc = change_dc && bits[k] == -1;
    int nk = change_dc ? 9 : 5;
    for (int b = 0; b < c.nbx; ++b) {
      int64_t g[25];
      for (int i = 0; i < 5; ++i)
        for (int j = 0; j < 5; ++j) g[i * 5 + j] = dc(src_rows[i], std::min(std::max(b + j - 2, 0), c.nbx - 1));
      int16_t* w = out.data() + (int64_t(r) * c.stride + b) * 64;
      for (int k = 0; k < nk; ++k) {
        int al = bits[k + 1], pos = kSmoothPos[k];
        if (al == 0) continue;
        const int* kern = change_dc ? kDc[k] : kAc[k];
        int64_t sum = 0;
        for (int i = 0; i < 25; ++i) sum += kern[i] * g[i];
        if (w[pos] == 0) w[pos] = s16(smooth_pred(c.quant[0] * sum, c.quant[pos], al));
      }
      if (change_dc) {
        int64_t sum = 0;
        for (int i = 0; i < 25; ++i) sum += kDc00[i] * g[i];
        w[0] = s16(smooth_pred(c.quant[0] * sum, c.quant[0], 0));
      }
    }
  }
  return out;
}

// libjpeg-turbo's upsampling of a component's real samples (bh x bw, row
// stride `ps`) by (hr, vr) into a plane of H x W.
// `fancy_ok` false: replication only (lossless frames, whose
// min_DCT_scaled_size of 1 turns jinit_upsampler's do_fancy off).
void upsample(const uint8_t* in, int64_t ps, int bw, int bh, int hr, int vr, uint8_t* out, int W,
              int H, bool fancy_ok = true) {
  if (hr == 1 && vr == 1) {
    for (int y = 0; y < H; ++y) std::memcpy(out + int64_t(y) * W, in + y * ps, W);
    return;
  }
  bool fancy = fancy_ok && ((hr == 1 && vr == 2) || (((hr == 2 && vr == 1) || (hr == 2 && vr == 2)) && bw > 2));
  if (!fancy) {  // replication (int_upsample, h2v1_upsample, h2v2_upsample)
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) out[int64_t(y) * W + x] = in[(y / vr) * ps + x / hr];
    return;
  }
  std::vector<int> cols(bw);
  for (int y = 0; y < H; ++y) {
    uint8_t* o = out + int64_t(y) * W;
    if (vr == 1) {  // h2v1
      const uint8_t* r = in + y * ps;
      for (int i = 0; i < bw; ++i) {
        int x3 = 3 * r[i], left = r[std::max(i - 1, 0)], right = r[std::min(i + 1, bw - 1)];
        if (2 * i < W) o[2 * i] = static_cast<uint8_t>((x3 + left + 1) >> 2);
        if (2 * i + 1 < W) o[2 * i + 1] = static_cast<uint8_t>((x3 + right + 2) >> 2);
      }
      continue;
    }
    int r = y >> 1;
    int far = (y & 1) ? std::min(r + 1, bh - 1) : std::max(r - 1, 0);
    const uint8_t* near_row = in + r * ps;
    const uint8_t* far_row = in + far * ps;
    if (hr == 1) {  // h1v2
      int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>((3 * near_row[x] + far_row[x] + bias) >> 2);
      continue;
    }
    for (int i = 0; i < bw; ++i) cols[i] = 3 * near_row[i] + far_row[i];  // h2v2
    for (int i = 0; i < bw; ++i) {
      int c3 = 3 * cols[i], left = cols[std::max(i - 1, 0)], right = cols[std::min(i + 1, bw - 1)];
      if (2 * i < W) o[2 * i] = static_cast<uint8_t>((c3 + left + 8) >> 4);
      if (2 * i + 1 < W) o[2 * i + 1] = static_cast<uint8_t>((c3 + right + 7) >> 4);
    }
  }
}

int64_t fix16(double f) { return static_cast<int64_t>(f * 65536 + 0.5); }

inline uint8_t clamp255(int64_t x) { return static_cast<uint8_t>(x < 0 ? 0 : x > 255 ? 255 : x); }

// ---- the marker stream ----

const int M_SOF0 = 0xC0, M_SOF1 = 0xC1, M_SOF2 = 0xC2, M_SOF3 = 0xC3, M_DHT = 0xC4, M_SOF9 = 0xC9, M_SOF10 = 0xCA,
          M_DAC = 0xCC, M_SOI = 0xD8,
          M_EOI = 0xD9, M_SOS = 0xDA, M_DQT = 0xDB, M_DNL = 0xDC, M_DRI = 0xDD, M_DHP = 0xDE,
          M_EXP = 0xDF, M_APP0 = 0xE0, M_APP14 = 0xEE, M_COM = 0xFE;

// A marker found by libjpeg's next_marker: the 0xFF run starts at `start`,
// the code follows, the segment goes on at `end`.
struct Marker {
  bool found = false;
  int64_t start = 0, end = 0;
  int code = 0;
};

struct Decoder {
  const uint8_t* data;
  int64_t size;
  bool header_only;
  bool have_qt[4] = {false, false, false, false};
  int64_t qt[4][64];
  HuffSpec huff[2][4];
  int restart_interval = 0;
  bool have_frame = false, progressive = false, jfif = false, multi = false, image_done = false;
  // a JPEG-in-TIFF stream (libtiff's reading), and the strip's or tile's
  // height, width and samples per pixel
  bool tiff = false, tables_only = false, taller_ok = false, raw = false;
  int64_t raw_fail = -1;  // raw output: the MCU at whose restart libtiff's old-style JPEG codec fails
  int want_h = 0, want_w = 0, want_c = 0, want_hs = 0, want_vs = 0;  // want_hs 0: no YCbCr conversion
  int adobe = -1;
  bool as_cmyk = false;  // a BLP1's JPEG: PIL sets libjpeg's jpeg_color_space to JCS_CMYK, so YCCK is not converted
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0, scans = 0, last_good = 0;
  std::vector<Component> comps;
  // arithmetic coding (SOF9, SOF10): each table's DAC conditioning (DC L
  // and U, AC Kx; get_soi's defaults), and PIL's decode call (kPilBlock)
  bool arith = false, lossless = false;
  int dac_l[16], dac_u[16], dac_k[16];
  int64_t pil_call = 1;

  Decoder(const uint8_t* d, int64_t n, bool header) : data(d), size(n), header_only(header) { dac_defaults(); }

  void dac_defaults() {
    std::fill(dac_l, dac_l + 16, 0);
    std::fill(dac_u, dac_u + 16, 1);
    std::fill(dac_k, dac_k + 16, 5);
  }

  // The first 0xFF run from `pos` followed by a byte that is neither 0 nor
  // 0xFF (what lies before it is skipped, as extraneous data).
  Marker find_marker(int64_t pos) const {
    Marker m;
    for (int64_t i = pos; i < size; ++i) {
      if (data[i] != 0xFF) continue;
      int64_t j = i;
      while (j < size && data[j] == 0xFF) ++j;
      if (j >= size) break;
      if (data[j] != 0) {
        m.found = true;
        m.start = i;
        m.code = data[j];
        m.end = j + 1;
        return m;
      }
      i = j;
    }
    return m;
  }
  Marker marker_at(int64_t pos) const {
    Marker m = find_marker(pos);
    if (!m.found) truncated();
    return m;
  }
  // The marker that ends the entropy-coded data from `pos`; none is
  // truncation in a multi-scan file, the end of the file in a single-scan one.
  Marker stretch_end(int64_t pos) const {
    Marker m = find_marker(pos);
    if (!m.found && multi) truncated();
    return m;
  }
  // The bytes of the restart interval from `pos` that marker `m` ends
  // (none found: a single-scan file whose data runs to its end), stuffing
  // undone; none where the interval reads as data that ended (`pending`).
  std::vector<uint8_t> interval(int64_t pos, const Marker& m, bool pending) const {
    if (!m.found) {
      int64_t to = size;
      while (to > pos && data[to - 1] == 0xFF) --to;
      return unstuff(pos, to);
    }
    return pending ? std::vector<uint8_t>() : unstuff(pos, m.start);
  }

  // Entropy-coded bytes from `from` to `to`, stuffing (0xFF+ 0x00) undone.
  std::vector<uint8_t> unstuff(int64_t from, int64_t to) const {
    std::vector<uint8_t> seg;
    seg.reserve(static_cast<size_t>(std::max<int64_t>(to - from, 0)));
    for (int64_t i = from; i < to;) {
      if (data[i] != 0xFF) {
        seg.push_back(data[i++]);
        continue;
      }
      while (i < to && data[i] == 0xFF) ++i;
      seg.push_back(0xFF);  // a 0x00 follows inside a stretch
      ++i;
    }
    return seg;
  }

  void run() {
    try {
      markers();
    } catch (const Refused& r) {
      // PIL ends a single-scan file once its rows are out: running out of
      // data while reading the markers after them is not an error
      if (r.msg != "truncated data" || !image_done) throw;
    }
  }

  // The markers in order; a header-only run stops after the frame header.
  void markers() {
    // PIL's JPEG plugin takes FF D8 FF; libjpeg, which libtiff hands a
    // strip, only FF D8
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8 || (!tiff && (size < 3 || data[2] != 0xFF)))
      refuse("not a JPEG file (no SOI marker)");
    int64_t pos = 2;
    int marker = -1;
    for (;;) {
      if (marker < 0) {
        Marker m = marker_at(pos);
        pos = m.end;
        marker = m.code;
      }
      if (marker == M_EOI) break;
      if (scans == 0 && marker < 0xC0) corrupt(fmt("an unknown marker 0x%02x", marker));
      if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) {
        marker = -1;
        continue;
      }
      if (marker == M_SOI) corrupt("a second SOI marker");
      const uint8_t* body = nullptr;
      int blen = 0;
      const bool frame = marker == M_SOF0 || marker == M_SOF1 || marker == M_SOF2 || marker == M_SOF3 ||
                         marker == M_SOF9 || marker == M_SOF10;
      // After a single-scan file's rows PIL ignores running out of data, but
      // not a fault libjpeg finds first: get_sof's and get_sos's first
      // checks come before they read a byte, and `partial` what they check
      // of a segment cut short.
      if (image_done && frame) corrupt("a second frame header");
      if (frame || marker == M_DHT || marker == M_DQT || marker == M_DRI || marker == M_SOS || marker == M_DAC) {
        if (pos + 2 > size) truncated();
        int length = (data[pos] << 8) | data[pos + 1];
        if (length < 2) corrupt(fmt("a marker segment of length %d", length));
        if (pos + length > size) {
          if (image_done) partial(marker, data + pos + 2, static_cast<int>(size - pos - 2), length - 2);
          truncated();
        }
        body = data + pos + 2;
        blen = length - 2;
        pos += length;
      }
      std::string why;
      if (tables_only && (marker == M_SOS || (marker >= 0xC0 && marker <= 0xCF && marker != M_DHT && marker != M_DAC)))
        refuse(fmt("a JPEGTables stream with a frame or scan marker 0x%02x (libtiff: Bogus JPEGTables field)",
                   marker));
      if (frame) {
        sof(marker, body, blen);
        if (header_only) return;
      } else if (marker >= 0xC0 && marker <= 0xCF && refusal(marker - 0xC0, &why)) {
        refuse(why);
      } else if (marker == M_DAC) {
        dac(body, blen, true);
      } else if (marker == M_DHP || marker == M_EXP) {
        refuse("hierarchical JPEG (a DHP or EXP marker)");
      } else if (marker == M_DHT) {
        dht(body, blen);
      } else if (marker == M_DQT) {
        dqt(body, blen);
      } else if (marker == M_DRI) {
        if (blen != 2) corrupt("a DRI segment whose length is not 4");
        restart_interval = (body[0] << 8) | body[1];
      } else if (marker == M_SOS) {
        pos = sos(body, blen, pos, &marker);
        image_done = !multi;
        // libtiff reads a single-scan strip's rows and then finishes it,
        // ignoring what jpeg_finish_decompress reports of the markers after;
        // its old-style JPEG codec (raw output) stops at the rows too
        if ((tiff || raw) && image_done) return;
        continue;
      } else if ((marker >= 0xE0 && marker <= 0xEF) || marker == M_COM || marker == M_DNL) {
        // skipped; a length below 2 skips nothing past it
        if (pos + 2 > size) truncated();
        int length = std::max((data[pos] << 8) | data[pos + 1], 2);
        if (pos + length > size) truncated();
        const uint8_t* b = data + pos + 2;
        int n = length - 2;
        pos += length;
        if (marker == M_APP0 && n >= 14 && std::memcmp(b, "JFIF\0", 5) == 0) {
          jfif = true;
        } else if (marker == M_APP14 && n >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
          adobe = b[11];
        }
        if (scans == 0 && n < 7 &&
            ((marker == M_APP0 && n >= 4 && std::memcmp(b, "JFIF", 4) == 0) ||
             (marker == M_APP14 && n >= 5 && std::memcmp(b, "Adobe", 5) == 0)))
          corrupt("a short JFIF or Adobe segment");
      } else {
        corrupt(fmt("an unknown marker 0x%02x", marker));
      }
      marker = -1;
    }
    if (tables_only) return;
    if (!have_frame || scans == 0) corrupt("no image data before EOI");
  }

  // libtiff's JPEGTables stream, read before a strip or tile (tables only);
  // the strip's SOI then resets what get_soi resets.
  void read_tables(const uint8_t* t, int64_t n, const uint8_t* strip, int64_t strip_size) {
    data = t;
    size = n;
    tables_only = true;
    markers();
    tables_only = false;
    data = strip;
    size = strip_size;
    restart_interval = 0;
    jfif = false;
    adobe = -1;
    dac_defaults();
  }

  void sof(int marker, const uint8_t* b, int n) {
    if (have_frame) corrupt("a second frame header");
    if (n < 6) corrupt("a short frame header");
    int precision = b[0];
    height = (b[1] << 8) | b[2];
    width = (b[3] << 8) | b[4];
    int nc = b[5];
    if (precision != 8) refuse(fmt("%d-bit samples", precision));
    if (n != 6 + 3 * nc) corrupt("a frame header whose length does not match its components");
    if (tiff) {
      if (nc != want_c)
        refuse(fmt("a JPEG strip or tile of %d components for %d samples a pixel (libtiff: Improper JPEG "
                   "component count)", nc, want_c));
      if ((width > want_w || height > want_h) && !(taller_ok && width == want_w))
        refuse(fmt("a JPEG strip or tile of %dx%d, larger than the TIFF's %dx", width, height, want_w) +
               fmt("%d (libtiff: JPEG strip/tile size exceeds expected dimensions)", want_h));
      if (width != want_w || height < want_h)
        refuse(fmt("a JPEG strip or tile of %dx%d, smaller than the TIFF's %dx", width, height, want_w) +
               fmt("%d (libtiff: JPEG strip/tile size less than expected)", want_h));
    }
    if (nc != 1 && nc != 3 && nc != 4 && !(tiff && nc == 2)) refuse(fmt("%d colour components", nc));
    if (height == 0) refuse("a DNL height (0 in the frame header)");
    if (width == 0) corrupt("an image 0 samples wide");
    if (std::max(width, height) > kMaxDimension) refuse(fmt("an image dimension over %d", kMaxDimension));
    if (int64_t(width) * height > kMaxPixels)
      refuse("an image of more than " + std::to_string(kMaxPixels) + " pixels (PIL's decompression bomb limit)");
    for (int i = 0; i < nc; ++i) {
      Component c;
      c.index = i;
      c.id = b[6 + 3 * i];
      c.h = b[7 + 3 * i] >> 4;
      c.v = b[7 + 3 * i] & 15;
      c.tq = b[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) corrupt(fmt("component %d's sampling factors", i));
      const bool luma = tiff && want_hs && i == 0;  // YCbCr: component 0 sampled as the tag says
      const int want_h_s = luma ? want_hs : 1, want_v_s = luma ? want_vs : 1;
      if (tiff && (c.h != want_h_s || c.v != want_v_s))
        refuse(fmt("component %d sampled %dx%d in a JPEG strip or tile (libtiff: Improper JPEG sampling ", i, c.h,
                   c.v) + fmt("factors; %dx%d expected)", want_h_s, want_v_s));
      comps.push_back(c);
    }
    for (const Component& c : comps) {
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (const Component& c : comps)
      if (hmax % c.h || vmax % c.v)
        refuse(fmt("component %d's sampling factors %dx%d (a fractional chroma ratio)", c.index, c.h, c.v));
    if (raw && marker != M_SOF0 && marker != M_SOF1 && marker != M_SOF2)
      refuse(fmt("an old-style JPEG stream with a SOF%d frame (libtiff reads baseline only)", marker - 0xC0));
    have_frame = true;
    progressive = marker == M_SOF2 || marker == M_SOF10;
    arith = marker == M_SOF9 || marker == M_SOF10;
    lossless = marker == M_SOF3;
    const int unit = lossless ? 1 : 8;  // a lossless data unit is one sample
    mcux = (width + unit * hmax - 1) / (unit * hmax);
    mcuy = (height + unit * vmax - 1) / (unit * vmax);
    if (header_only) return;
    for (Component& c : comps) {
      c.bw = static_cast<int>((int64_t(width) * c.h + hmax - 1) / hmax);
      c.bh = static_cast<int>((int64_t(height) * c.v + vmax - 1) / vmax);
      if (lossless) {
        c.nbx = c.bw;
        c.nby = c.bh;
        c.plane.assign(int64_t(c.bw) * c.bh, 0);
        continue;
      }
      c.nbx = (c.bw + 7) / 8;
      c.nby = (c.bh + 7) / 8;
      c.stride = mcux * c.h;
      c.rows = mcuy * c.v;
      c.coef.assign(int64_t(c.stride) * c.rows * 64, 0);
      std::fill(c.bits, c.bits + 64, -1);
      std::fill(c.prev_bits, c.prev_bits + 64, -1);
    }
  }

  void dht(const uint8_t* b, int n) {
    int p = 0;
    while (p < n) {
      if (p + 17 > n) corrupt("a short Huffman table");
      int index = b[p];
      int total = 0;
      for (int l = 0; l < 16; ++l) total += b[p + 1 + l];
      if (total > 256 || p + 17 + total > n) corrupt("a Huffman table longer than its segment");
      int kind = index >> 4, slot = index & 15;
      if (kind > 1 || slot > 3) corrupt(fmt("a Huffman table index 0x%02x", index));
      HuffSpec& t = huff[kind][slot];
      t.defined = true;
      for (int l = 0; l < 16; ++l) t.counts[l] = b[p + 1 + l];
      t.symbols.assign(b + p + 17, b + p + 17 + total);
      p += 17 + total;
    }
  }

  // What jdmarker.c checks of a segment cut short (`n` of its `len` body
  // bytes at `b`) before it runs out and PIL's source suspends: libjpeg
  // reads a segment byte by byte, so a fault in what it has read raises.
  void partial(int marker, const uint8_t* b, int n, int len) {
    if (marker == M_DAC) {
      dac(b, n & ~1, false);
    } else if (marker == M_DRI) {
      if (len != 2) corrupt("a DRI segment whose length is not 4");
    } else if (marker == M_SOS && n >= 1) {
      if (len != 4 + 2 * b[0] || b[0] < 1 || b[0] > 4) corrupt("a scan header");
      std::vector<Component*> sc;
      for (int i = 0; i < b[0] && 3 + 2 * i <= n; ++i) sc.push_back(scan_component(b[1 + 2 * i], i, sc));
    } else if (marker == M_DHT) {
      int p = 0;
      for (; len - p > 16; p += 17) {
        if (p + 17 > n) return;
        int total = 0;
        for (int l = 0; l < 16; ++l) total += b[p + 1 + l];
        if (total > 256 || p + 17 + total > len) corrupt("a Huffman table longer than its segment");
        if (p + 17 + total > n) return;
        if ((b[p] >> 4) > 1 || (b[p] & 15) > 3) corrupt(fmt("a Huffman table index 0x%02x", b[p]));
        p += total;
      }
      if (p != len) corrupt("a short Huffman table");
    } else if (marker == M_DQT) {
      for (int p = 0; p < len && p < n; p += 1 + ((b[p] >> 4) ? 128 : 64))
        if ((b[p] & 15) > 3) corrupt("a quantisation table");
    }
  }

  // jdmarker.c get_dac: (Tc << 4 | Tb, value) pairs; DC: L the low nibble,
  // U the high one, L <= U; AC: Kx as it stands. `whole`: the segment's
  // every byte is there.
  void dac(const uint8_t* b, int n, bool whole) {
    if (whole && n % 2) corrupt("a DAC segment of odd length");
    for (int p = 0; p + 1 < n; p += 2) {
      int index = b[p], val = b[p + 1];
      if (index >= 32) corrupt(fmt("a DAC table index 0x%02x", index));
      if (index >= 16) {
        dac_k[index - 16] = val;
      } else {
        dac_l[index] = val & 15;
        dac_u[index] = val >> 4;
        if (dac_l[index] > dac_u[index]) corrupt(fmt("a DAC value 0x%02x (L over U)", val));
      }
    }
  }

  void dqt(const uint8_t* b, int n) {
    int p = 0;
    while (p < n) {
      int pq = b[p] >> 4, tq = b[p] & 15;
      int sz = pq ? 128 : 64;  // any nonzero precision reads 16-bit entries
      if (tq > 3 || p + 1 + sz > n) corrupt("a quantisation table");
      for (int k = 0; k < 64; ++k)
        qt[tq][kZigzag[k]] = pq ? (b[p + 1 + 2 * k] << 8) | b[p + 2 + 2 * k] : b[p + 1 + k];
      have_qt[tq] = true;
      p += 1 + sz;
    }
  }

  // One scan: its header, then its entropy-coded data as libjpeg reads it.
  // Returns the position the marker reader goes on from, with the marker
  // that ended the data in *next (-1 where the data ran to the file's end).
  int64_t sos(const uint8_t* b, int n, int64_t pos, int* next) {
    if (!have_frame) corrupt("a scan before the frame header");
    if (n < 1 || n != 4 + 2 * b[0] || b[0] < 1 || b[0] > 4) corrupt("a scan header");
    int ns = b[0];
    std::vector<Component*> sc;
    int td[4], ta[4];
    for (int i = 0; i < ns; ++i) {
      sc.push_back(scan_component(b[1 + 2 * i], i, sc));
      td[i] = b[2 + 2 * i] >> 4;
      ta[i] = b[2 + 2 * i] & 15;
    }
    int ss = b[1 + 2 * ns], se = b[2 + 2 * ns], ah = b[3 + 2 * ns] >> 4, al = b[3 + 2 * ns] & 15;
    if (scans == 0) {
      multi = progressive || ns < static_cast<int>(comps.size());
      if (!progressive && !arith && !lossless)
        for (int kind = 0; kind < 2; ++kind)
          for (int slot = 0; slot < 2; ++slot)
            if (!huff[kind][slot].defined) std_table(kind, slot, &huff[kind][slot]);
      if (lossless) lossless_colour();
    } else if (!multi) {
      corrupt("a second scan in a single-scan file");
    }
    if (ns > 1) {
      int blocks = 0;
      for (Component* c : sc) blocks += c->h * c->v;
      if (blocks > kMaxBlocksInMcu) corrupt(fmt("an MCU of more than %d blocks", kMaxBlocksInMcu));
    }
    for (Component* c : sc) {
      if (!c->latched && !lossless) {
        if (c->tq > 3 || !have_qt[c->tq]) corrupt(fmt("component %d has no quantisation table", c->index));
        std::copy(qt[c->tq], qt[c->tq] + 64, c->quant);
        c->latched = true;
      }
    }
    ++scans;
    if (lossless) return lossless_scan(sc, td, ss, se, ah, al, pos, next);
    if (progressive) check_progression(sc, ss, se, ah, al);

    auto lut = [&](int kind, int slot) {
      if (slot > 3 || !huff[kind][slot].defined) corrupt(fmt("a scan uses an undefined Huffman table %d/%d", kind, slot));
      return huffman_lut(huff[kind][slot], kind == 0);
    };
    std::vector<std::vector<uint16_t>> dc, ac;
    if (!arith && !progressive) {
      for (int i = 0; i < ns; ++i) {
        dc.push_back(lut(0, td[i]));
        ac.push_back(lut(1, ta[i]));
      }
    } else if (!arith && ss == 0 && ah == 0) {
      for (int i = 0; i < ns; ++i) dc.push_back(lut(0, td[i]));
    } else if (!arith && ss > 0) {
      ac.push_back(lut(1, ta[0]));
    }
    // arithmetic coding: the statistics (jdarith.c's dc_stats, ac_stats) and
    // where reading the scan's bytes must stop
    std::vector<uint8_t> dc_stats(16 * 64), ac_stats(16 * 256);
    uint8_t fixed = 113;
    int64_t limit = size;
    if (arith && !tiff && !raw) {
      pil_call = std::max(pil_call, (pos + kPilBlock - 1) / kPilBlock);
      limit = std::min(size, pil_call * kPilBlock);
    }

    int64_t n_mcu = ns == 1 ? int64_t(sc[0]->nbx) * sc[0]->nby : int64_t(mcux) * mcuy;
    auto mcu_row = [&](int64_t m) -> int {
      return ns == 1 ? static_cast<int>((m / sc[0]->nbx) / sc[0]->v) : static_cast<int>(m / mcux);
    };
    int64_t ri = restart_interval;
    int64_t span = ri ? ri : n_mcu;

    Marker m = stretch_end(pos);
    bool pending = false, insufficient = false;
    int expect = 0;
    for (int64_t first = 0, s = 0; first < n_mcu; first += span, ++s) {
      bool flag = insufficient;
      if (s) {  // process_restart: read_restart_marker, jpeg_resync_to_restart
        if (!m.found) truncated();
        if (raw && m.code != 0xD0 + expect) {  // libtiff's OJPEG resync_to_restart fails the decoding
          raw_fail = first;
          break;
        }
        if (resync(&m, expect, limit)) {
          pos = m.end;
          pending = false;
          m = stretch_end(pos);
          insufficient = false;
        } else {
          pending = true;
        }
        expect = (expect + 1) & 7;
      }
      int64_t last = std::min(n_mcu, first + span);
      const std::vector<uint8_t> seg = arith ? std::vector<uint8_t>() : interval(pos, m, pending);
      Bits bits(seg);
      bits.tracked = !m.found;
      Arith ar(data, pos, limit, pending);
      // jdarith.c's start_pass and process_restart: the statistics of the
      // scan's tables and the DC predictions start again
      for (int i = 0; i < ns && arith; ++i) {
        if (!progressive || (ss == 0 && ah == 0)) std::fill_n(dc_stats.begin() + 64 * td[i], 64, 0);
        if (!progressive || ss) std::fill_n(ac_stats.begin() + 256 * ta[i], 256, 0);
      }
      int preds[4] = {0, 0, 0, 0}, ctx[4] = {0, 0, 0, 0};
      int eobrun = 0;
      bool failed = false;  // jdarith.c's ct == -1: a bad arithmetic code ends the interval
      int64_t done = 0;
      for (int64_t mc = first; mc < last && !insufficient; ++mc) {
        for (int i = 0; i < ns && !failed; ++i) {
          Component* c = sc[i];
          int bh = ns == 1 ? 1 : c->v, bwid = ns == 1 ? 1 : c->h;
          for (int by = 0; by < bh && !failed; ++by) {
            for (int bx = 0; bx < bwid && !failed; ++bx) {
              int64_t block;
              if (ns == 1) {
                block = (mc / c->nbx) * c->stride + mc % c->nbx;
              } else {
                int64_t my = mc / mcux, mx = mc % mcux;
                block = (my * c->v + by) * c->stride + mx * c->h + bx;
              }
              int16_t* co = c->coef.data() + block * 64;
              if (arith) {
                uint8_t* dcs = dc_stats.data() + 64 * td[i];
                uint8_t* acs = ac_stats.data() + 256 * ta[i];
                if (!progressive) {
                  failed = !arith_dc(ar, dcs, td[i], &ctx[i], &preds[i]);
                  if (!failed) {
                    co[0] = s16(preds[i]);
                    failed = !arith_ac(ar, acs, ta[i], co, 1, 63, 0, &fixed);
                  }
                } else if (ss == 0 && ah == 0) {
                  failed = !arith_dc(ar, dcs, td[i], &ctx[i], &preds[i]);
                  if (!failed) co[0] = s16(int64_t(preds[i]) << al);
                } else if (ss == 0) {
                  if (ar.decode(&fixed)) co[0] = s16(co[0] | (1 << al));
                } else if (ah == 0) {
                  failed = !arith_ac(ar, acs, ta[0], co, ss, se, al, &fixed);
                } else {
                  failed = !arith_ac_refine(ar, acs, co, ss, se, al, &fixed);
                }
              } else if (!progressive) {
                sequential_block(bits, co, dc[i].data(), ac[i].data(), &preds[i]);
              } else if (ss == 0 && ah == 0) {
                int t = bits.huff(dc[i].data());
                if (t) preds[i] += extend(bits.bits(t), t);
                co[0] = s16(int64_t(preds[i]) * (int64_t(1) << al));
              } else if (ss == 0) {
                if (bits.bits(1)) co[0] = s16(co[0] | (1 << al));
              } else if (ah == 0) {
                ac_first_block(bits, co, ac[0].data(), ss, se, al, &eobrun);
              } else {
                ac_refine_block(bits, co, ac[0].data(), ss, se, al, &eobrun);
              }
            }
          }
        }
        ++done;
        if (!arith) insufficient = bits.done_mcu();  // the arithmetic decoder reads zeros past a marker
      }
      if (!m.found) continue;
      // consume_data sets last_good_iMCU_row before each MCU it starts with
      // data left: the interval's first by the flag as it was before the
      // restart, the others while decoding went on
      if (done >= 2) {
        last_good = mcu_row(first + done - 1);
      } else if (!flag) {
        last_good = mcu_row(first);
      }
    }
    if (!m.found) {
      *next = -1;
      return size;
    }
    *next = m.code;
    return m.end;
  }

  // get_sos's lookup of scan slot `slot`'s component id: the first component
  // with it whose index is not below the slot, and not in the scan yet.
  Component* scan_component(int cid, int slot, const std::vector<Component*>& sc) {
    for (Component& c : comps)
      if (c.id == cid && c.index >= slot) {
        if (std::find(sc.begin(), sc.end(), &c) != sc.end()) break;
        return &c;
      }
    corrupt(fmt("a scan of component id %d", cid));
  }

  // process_restart's read_restart_marker, then jpeg_resync_to_restart's
  // three actions on the marker `m` that ended an interval, RSTn with n =
  // `expect` wanted: true where a marker is taken and the next interval's
  // data follows it, false where it stays (the interval reads as data that
  // ended). Reading a marker through `limit` raises (arithmetic coding).
  bool resync(Marker* m, int expect, int64_t limit) {
    int action;
    for (;;) {
      if (m->end > limit) refuse(kPastRead);
      int mk = m->code;
      if (mk == 0xD0 + expect) {
        action = 1;
      } else if (mk < 0xC0) {
        action = 2;
      } else if (mk < 0xD0 || mk > 0xD7) {
        action = 3;
      } else if (mk == 0xD0 + ((expect + 1) & 7) || mk == 0xD0 + ((expect + 2) & 7)) {
        action = 3;
      } else if (mk == 0xD0 + ((expect - 1) & 7) || mk == 0xD0 + ((expect - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action != 2) return action == 1;
      *m = marker_at(m->end);
    }
  }

  // ---- arithmetic coding: jdarith.c's decode_mcu and its progressive
  // forms, on statistics bins laid out as there (a DC table's 64: S0, SS,
  // SP, SN of each of five contexts from 0, X1.. from 20, M2.. 14 past;
  // an AC table's 256: SE, S0, SP..X of coefficient k from 3 (k - 1), X2..
  // from 189 (k <= Kx) or 217). False where libjpeg finds a bad arithmetic
  // code, a magnitude or a run that overflows: the rest of the restart
  // interval is not decoded.

  // A DC difference (F.1.4.4.1, Figures F.19 to F.24) into *pred (16 bits),
  // the context of the next from its size against the table's L and U.
  bool arith_dc(Arith& ar, uint8_t* stats, int tbl, int* ctx, int* pred) const {
    uint8_t* st = stats + *ctx;
    if (ar.decode(st) == 0) {
      *ctx = 0;
      return true;
    }
    int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m) {
      st = stats + 20;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < ((1 << dac_l[tbl]) >> 1)) {
      *ctx = 0;
    } else if (m > ((1 << dac_u[tbl]) >> 1)) {
      *ctx = 12 + sign * 4;
    } else {
      *ctx = 4 + sign * 4;
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    *pred = (*pred + (sign ? -v : v)) & 0xFFFF;
    return true;
  }

  // AC coefficients ss..se (F.1.4.4.2, Figure F.20), scaled by 2^al; the
  // sign on the fixed 0.5 bin.
  bool arith_ac(Arith& ar, uint8_t* stats, int tbl, int16_t* co, int ss, int se, int al, uint8_t* fixed) const {
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (ar.decode(st)) break;  // end of block
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) return false;
      }
      int sign = ar.decode(fixed);
      st += 2;
      int m = ar.decode(st);
      if (m && ar.decode(st)) {
        m <<= 1;
        st = stats + (k <= dac_k[tbl] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) return false;
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      co[natural(k)] = s16(int64_t(sign ? -v : v) << al);
    }
    return true;
  }

  // An AC refinement scan's block (G.1.3.3): a correction bit for each
  // coefficient already nonzero (added, not or-ed, as jdarith.c does), a
  // new one of +-2^al; the end of block is coded only past the last one
  // that was nonzero before.
  static bool arith_ac_refine(Arith& ar, uint8_t* stats, int16_t* co, int ss, int se, int al, uint8_t* fixed) {
    const int p1 = 1 << al, m1 = -(1 << al);
    int kex = se;
    for (; kex > 0; --kex)
      if (co[natural(kex)]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;
      for (;;) {
        int16_t* c = co + natural(k);
        if (*c) {
          if (ar.decode(st + 2)) *c = s16(*c + (*c < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(st + 1)) {
          *c = static_cast<int16_t>(ar.decode(fixed) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) return false;
      }
    }
    return true;
  }

  // ---- lossless (T.81 Annex H), as libjpeg-turbo 3's jddiffct.c,
  // jdlhuff.c and jdlossls.c decode it ----

  // jdapimin.c's colour space in lossless mode, where libjpeg-turbo converts
  // no colours (jdcolor.c: "Unsupported color conversion request"): three
  // components are RGB but under a JFIF marker or an Adobe transform other
  // than 0 (whatever their ids), four CMYK but under an Adobe transform; a
  // YCbCr JPEG-in-TIFF is converted to RGB, so refused too.
  void lossless_colour() const {
    const int nc = channels();
    bool ycc = tiff ? want_hs != 0 : (nc == 3 && (jfif || adobe > 0)) || (nc == 4 && adobe > 0 && !as_cmyk);
    if (ycc)
      refuse(std::string("a lossless ") + (nc == 4 ? "YCCK" : "YCbCr") +
             " JPEG (libjpeg-turbo converts no colours in lossless mode: Unsupported color conversion request)");
  }

  // One lossless scan: Ss is the predictor, Se and Ah 0, Al the point
  // transform Pt. Each sample is a Huffman-coded difference (category 16:
  // 32768, no extra bits) from its prediction, mod 2^16; the first row of
  // the scan, of each restart interval (whole MCU rows) and after the data
  // ran out predicts from 2^(7 - Pt) then Ra, every other row's first
  // sample from Rb. Rows are undifferenced a whole iMCU row at a time, after
  // its MCU rows are decoded (so a restart or a reset at an MCU row inside
  // it counts from its first row), and padding samples and rows are decoded
  // and dropped. The samples are the low 8 bits of the values shifted left
  // by Pt.
  int64_t lossless_scan(const std::vector<Component*>& sc, const int* td, int psv, int se, int ah, int pt,
                        int64_t pos, int* next) {
    const int ns = static_cast<int>(sc.size());
    if (psv < 1 || psv > 7 || se != 0 || ah != 0 || pt > 7)
      corrupt(fmt("a lossless scan with predictor %d, Se %d, ", psv, se) + fmt("Ah %d, Pt %d", ah, pt));
    const int64_t per_row = ns == 1 ? sc[0]->bw : mcux;  // MCUs in an MCU row
    if (restart_interval % per_row)
      refuse(fmt("a lossless restart interval of %d MCUs, not whole rows of %d (libjpeg-turbo: Invalid restart "
                 "interval)", restart_interval, static_cast<int>(per_row)));
    std::vector<std::vector<uint16_t>> dc;
    for (int i = 0; i < ns; ++i) {
      if (td[i] > 3 || !huff[0][td[i]].defined) corrupt(fmt("a scan uses an undefined Huffman table 0/%d", td[i]));
      dc.push_back(huffman_lut(huff[0][td[i]], true, true));
      sc[i]->latched = true;  // its samples written (libjpeg does not zero them first)
    }
    // each component's differences of one iMCU row, and its undifferenced
    // rows (this one and the one above)
    std::vector<std::vector<int32_t>> diff(ns);
    std::vector<std::vector<uint16_t>> prev(ns), cur(ns);
    std::vector<int64_t> dw(ns);
    for (int i = 0; i < ns; ++i) {
      dw[i] = ns == 1 ? sc[i]->bw : int64_t(mcux) * sc[i]->h;
      diff[i].assign(dw[i] * sc[i]->v, 0);
      prev[i].assign(sc[i]->bw, 0);
      cur[i].assign(sc[i]->bw, 0);
    }
    bool first_row[4] = {true, true, true, true};  // by component index
    const int64_t restart_rows = restart_interval / per_row;
    int64_t rows_to_go = restart_rows;

    Marker m = stretch_end(pos);
    bool pending = false, insufficient = false;
    int expect = 0;
    struct Stream {
      std::vector<uint8_t> seg;
      Bits bits;
      explicit Stream(std::vector<uint8_t> s) : seg(std::move(s)), bits(seg) {}
    };
    auto stream = [&]() {
      auto st = std::make_unique<Stream>(interval(pos, m, pending));
      st->bits.tracked = !m.found;
      return st;
    };
    std::unique_ptr<Stream> in = stream();

    for (int64_t r = 0; r < mcuy; ++r) {
      const bool last_imcu = r == mcuy - 1;
      const Component* c0 = sc[0];
      const int mcu_rows = ns > 1 ? 1 : (last_imcu ? (c0->bh % c0->v ? c0->bh % c0->v : c0->v) : c0->v);
      for (int y = 0; y < mcu_rows; ++y) {
        if (restart_interval && rows_to_go == 0) {  // jddiffct.c process_restart
          if (!m.found) truncated();
          if (resync(&m, expect, size)) {
            pos = m.end;
            pending = false;
            m = stretch_end(pos);
            insufficient = false;
          } else {
            pending = true;
          }
          expect = (expect + 1) & 7;
          in = stream();
          std::fill(first_row, first_row + 4, true);
          rows_to_go = restart_rows;
        }
        if (insufficient) {  // jdlhuff.c decode_mcus: zeros, and the undifferencers start again
          for (int i = 0; i < ns; ++i) {
            const int rows = ns > 1 ? sc[i]->v : 1;
            std::fill_n(diff[i].begin() + (ns > 1 ? 0 : y) * dw[i], rows * dw[i], 0);
          }
          std::fill(first_row, first_row + 4, true);
        } else {
          Bits& bits = in->bits;
          for (int64_t mc = 0; mc < per_row; ++mc) {
            for (int i = 0; i < ns; ++i) {
              const Component* c = sc[i];
              const int bh = ns > 1 ? c->v : 1, bwid = ns > 1 ? c->h : 1;
              for (int by = 0; by < bh; ++by)
                for (int bx = 0; bx < bwid; ++bx) {
                  int t = bits.huff(dc[i].data()), d = 0;
                  if (t == 16) {
                    d = 32768;
                  } else if (t) {
                    d = extend(bits.bits(t), t);
                  }
                  diff[i][((ns > 1 ? by : y)) * dw[i] + mc * bwid + bx] = d;
                }
            }
          }
          insufficient = bits.done_mcu();
        }
        if (restart_interval) --rows_to_go;
      }
      for (int i = 0; i < ns; ++i) {  // undifference and scale the iMCU row's real rows
        Component* c = sc[i];
        const int rows = last_imcu ? (c->bh % c->v ? c->bh % c->v : c->v) : c->v;
        for (int row = 0; row < rows; ++row) {
          const int64_t y = r * c->v + row;
          if (y >= c->bh) break;
          undifference(diff[i].data() + row * dw[i], prev[i].data(), first_row[c->index], psv, pt, c->bw,
                       cur[i].data());
          first_row[c->index] = false;
          uint8_t* out = c->plane.data() + y * c->bw;
          for (int x = 0; x < c->bw; ++x) out[x] = static_cast<uint8_t>(cur[i][x] << pt);
          std::swap(prev[i], cur[i]);
        }
      }
    }
    if (!m.found) {
      *next = -1;
      return size;
    }
    *next = m.code;
    return m.end;
  }

  // jdlossls.c's undifferencers on one row of `width` samples, `prev` the
  // row above.
  static void undifference(const int32_t* diff, const uint16_t* prev, bool first, int psv, int pt, int width,
                           uint16_t* out) {
    int64_t ra = ((first ? int64_t(1) << (7 - pt) : int64_t(prev[0])) + diff[0]) & 0xFFFF;
    out[0] = static_cast<uint16_t>(ra);
    int64_t rb = first ? 0 : prev[0];
    for (int x = 1; x < width; ++x) {
      int64_t p;
      if (first) {
        p = ra;
      } else {
        int64_t rc = rb;
        rb = prev[x];
        switch (psv) {
          case 1: p = ra; break;
          case 2: p = rb; break;
          case 3: p = rc; break;
          case 4: p = ra + rb - rc; break;
          case 5: p = ra + ((rb - rc) >> 1); break;
          case 6: p = rb + ((ra - rc) >> 1); break;
          default: p = (ra + rb) >> 1; break;
        }
      }
      ra = (diff[x] + p) & 0xFFFF;
      out[x] = static_cast<uint16_t>(ra);
    }
  }

  // jdphuff.c's start_pass: a bad band or successive-approximation pair is
  // an error; a scan out of order is decoded as it stands.
  void check_progression(const std::vector<Component*>& sc, int ss, int se, int ah, int al) {
    int ns = static_cast<int>(sc.size());
    if ((ss == 0 && se != 0) || (ss > 0 && (ss > se || se > 63 || ns != 1)))
      corrupt(fmt("a progressive scan %d..%d of %d components", ss, se, ns));
    if ((ah && al != ah - 1) || al > 13) corrupt(fmt("a progressive scan with Ah %d, Al %d", ah, al));
    for (Component* c : sc) {
      for (int k = std::min(ss, 1); k <= std::max(se, 9); ++k) c->prev_bits[k] = scans > 1 ? c->bits[k] : 0;
      for (int k = ss; k <= se; ++k) c->bits[k] = al;
    }
  }

  static void sequential_block(Bits& bits, int16_t* co, const uint16_t* dc, const uint16_t* ac, int* pred) {
    int s = bits.huff(dc);
    if (s) *pred += extend(bits.bits(s), s);
    co[0] = s16(*pred);
    for (int k = 1; k < 64;) {
      int rs = bits.huff(ac);
      int t = rs & 15;
      if (t) {
        k += rs >> 4;
        co[natural(k)] = static_cast<int16_t>(extend(bits.bits(t), t));
        ++k;
      } else if (rs == 0xF0) {
        k += 16;
      } else {
        break;
      }
    }
  }

  static void ac_first_block(Bits& bits, int16_t* co, const uint16_t* lut, int ss, int se, int al, int* eobrun) {
    if (*eobrun) {
      --*eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = bits.huff(lut);
      int run = rs >> 4, s = rs & 15;
      if (s) {
        k += run;
        co[natural(k)] = s16(int64_t(extend(bits.bits(s), s)) * (int64_t(1) << al));
      } else if (run == 15) {
        k += 15;
      } else {
        *eobrun = (1 << run) - 1;
        if (run) *eobrun += bits.bits(run);
        break;
      }
    }
  }

  // jdphuff.c decode_mcu_AC_refine (a new coefficient's size other than 1
  // is only a warning there).
  static void ac_refine_block(Bits& bits, int16_t* co, const uint16_t* lut, int ss, int se, int al,
                              int* eobrun) {
    int p1 = 1 << al, m1 = -(1 << al);
    int k = ss;
    if (!*eobrun) {
      for (; k <= se; ++k) {
        int rs = bits.huff(lut);
        int run = rs >> 4, s = rs & 15;
        if (s) {
          s = bits.bits(1) ? p1 : m1;
        } else if (run != 15) {
          *eobrun = 1 << run;
          if (run) *eobrun += bits.bits(run);
          break;
        }
        for (; k <= se; ++k) {
          int16_t* c = co + natural(k);
          if (*c) {
            if (bits.bits(1) && !(*c & p1)) *c = s16(*c + (*c >= 0 ? p1 : m1));
          } else if (--run < 0) {
            break;
          }
        }
        if (s) co[natural(k)] = static_cast<int16_t>(s);
      }
    }
    if (*eobrun) {
      for (; k <= se; ++k) {
        int16_t* c = co + natural(k);
        if (*c && bits.bits(1) && !(*c & p1)) *c = s16(*c + (*c >= 0 ? p1 : m1));
      }
      --*eobrun;
    }
  }

  int channels() const { return static_cast<int>(comps.size()); }

  // jdcoefct.c smoothing_ok
  bool smoothing_ok() const {
    if (!progressive) return false;
    bool useful = false;
    for (const Component& c : comps) {
      if (!c.latched || c.quant[0] == 0 || c.bits[0] < 0) return false;
      for (int k = 0; k < 9; ++k)
        if (c.quant[kSmoothPos[k]] == 0) return false;
      for (int k = 1; k <= 9; ++k) useful = useful || c.bits[k] != 0;
    }
    return useful;
  }

  // libjpeg's raw data output (jpeg_read_raw_data): each component's
  // samples at its own sampling, whole blocks of whole MCU rows (stride x
  // rows blocks, 8 x 8 samples each), no upsampling and no colour
  // conversion, one plane after another
  void raw_planes(uint8_t* out) {
    bool smooth_on = smoothing_ok();
    for (const Component& c : comps) {
      int64_t q[64];
      for (int k = 0; k < 64; ++k) q[k] = c.latched ? i16(c.quant[k]) : 0;
      std::vector<int16_t> smoothed;
      const int16_t* coef = c.coef.data();
      if (smooth_on) {
        smoothed = smooth(c, mcuy, last_good, scans);
        coef = smoothed.data();
      }
      int64_t ps = int64_t(c.stride) * 8;
      for (int64_t by = 0; by < c.rows; ++by)
        for (int64_t bx = 0; bx < c.stride; ++bx)
          idct_islow(coef + (by * c.stride + bx) * 64, q, out + by * 8 * ps + bx * 8, ps);
      out += ps * c.rows * 8;
    }
  }

  void finish(uint8_t* out) {
    int64_t npx = int64_t(width) * height;
    bool smooth_on = smoothing_ok();
    std::vector<std::vector<uint8_t>> planes(comps.size());
    for (size_t ci = 0; ci < comps.size() && lossless; ++ci) {
      const Component& c = comps[ci];
      if (!c.latched)
        refuse(fmt("a lossless JPEG whose component %d is in no scan (libjpeg-turbo reads samples it never wrote: "
                   "Bogus virtual array access)", c.index));
      planes[ci].resize(npx);
      upsample(c.plane.data(), c.bw, c.bw, c.bh, hmax / c.h, vmax / c.v, planes[ci].data(), width, height, false);
    }
    for (size_t ci = 0; ci < comps.size() && !lossless; ++ci) {
      const Component& c = comps[ci];
      int64_t q[64];  // ISLOW_MULT_TYPE: the steps wrapped to 16 bits; zero where no scan latched them
      for (int k = 0; k < 64; ++k) q[k] = c.latched ? i16(c.quant[k]) : 0;
      std::vector<int16_t> smoothed;
      const int16_t* coef = c.coef.data();
      if (smooth_on) {
        smoothed = smooth(c, mcuy, last_good, scans);
        coef = smoothed.data();
      }
      int64_t ps = int64_t(c.stride) * 8;
      std::vector<uint8_t> padded(ps * c.rows * 8);
      for (int64_t by = 0; by < c.rows; ++by)
        for (int64_t bx = 0; bx < c.stride; ++bx)
          idct_islow(coef + (by * c.stride + bx) * 64, q, padded.data() + by * 8 * ps + bx * 8, ps);
      planes[ci].resize(npx);
      upsample(padded.data(), ps, c.bw, c.bh, hmax / c.h, vmax / c.v, planes[ci].data(), width, height);
    }
    if (comps.size() == 1) {
      std::memcpy(out, planes[0].data(), npx);
      return;
    }
    if (tiff && !want_hs) {  // libtiff's JCS_UNKNOWN: the components as decoded
      const int64_t nc = static_cast<int64_t>(comps.size());
      for (int64_t i = 0; i < npx; ++i)
        for (int64_t k = 0; k < nc; ++k) out[nc * i + k] = planes[k][i];
      return;
    }
    if (comps.size() == 4 && (adobe <= 0 || as_cmyk)) {  // CMYK as stored, inverted as PIL's "CMYK;I" unpacks it
      for (int64_t i = 0; i < npx; ++i)
        for (int k = 0; k < 4; ++k) out[4 * i + k] = static_cast<uint8_t>(255 - planes[k][i]);
      return;
    }
    bool rgb;
    if (lossless) {  // lossless_colour refused every conversion
      rgb = true;
    } else if (tiff) {  // YCbCr, libtiff's JCS_YCbCr -> JCS_RGB
      rgb = false;
    } else if (comps.size() == 4) {
      rgb = false;
    } else if (jfif) {
      rgb = false;
    } else if (adobe >= 0) {
      rgb = adobe == 0;
    } else {
      rgb = comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;  // 'R', 'G', 'B'
    }
    if (rgb) {
      for (int64_t i = 0; i < npx; ++i)
        for (int k = 0; k < 3; ++k) out[3 * i + k] = planes[k][i];
      return;
    }
    // jdcolor.c's build_ycc_rgb_table and ycc_rgb_convert (SCALEBITS 16);
    // ycck_cmyk_convert gives 255 minus the same sums through the range
    // limit, which PIL's inversion turns back into the clamped sums, K
    // inverted
    int64_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    const int64_t half = int64_t(1) << 15;
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (fix16(1.40200) * x + half) >> 16;
      cb_b[i] = (fix16(1.77200) * x + half) >> 16;
      cr_g[i] = -fix16(0.71414) * x;
      cb_g[i] = -fix16(0.34414) * x + half;
    }
    const uint8_t *y = planes[0].data(), *cb = planes[1].data(), *cr = planes[2].data();
    const int64_t c = static_cast<int64_t>(comps.size());
    for (int64_t i = 0; i < npx; ++i) {
      out[c * i] = clamp255(y[i] + cr_r[cr[i]]);
      out[c * i + 1] = clamp255(y[i] + ((cb_g[cb[i]] + cr_g[cr[i]]) >> 16));
      out[c * i + 2] = clamp255(y[i] + cb_b[cb[i]]);
      if (c == 4) out[c * i + 3] = static_cast<uint8_t>(255 - planes[3][i]);
    }
  }
};

int fail(const std::string& msg) {
  g_error = msg;
  return 1;
}

}  // namespace

extern "C" {

// The frame's (height, width, channels) into `hwc`, then where `out` is not
// null its pixels; `as_cmyk`: a 4-component frame read as CMYK whatever its
// Adobe transform (PIL's jpegmode "CMYK", which a BLP1's JPEG is read with).
int gs_jpeg_decode(const uint8_t* data, long long size, uint8_t* out, long long capacity, int* hwc,
                   int as_cmyk) {
  try {
    Decoder d(data, size, out == nullptr);
    d.as_cmyk = as_cmyk != 0;
    d.run();
    hwc[0] = d.height;
    hwc[1] = d.width;
    hwc[2] = d.channels();
    if (out == nullptr) return 0;
    if (int64_t(d.width) * d.height * d.channels() > capacity) return fail("output buffer too small");
    d.finish(out);
    return 0;
  } catch (const Refused& r) {
    return fail(r.msg);
  } catch (const std::bad_alloc&) {
    return fail("out of host memory");
  }
}

// `out` takes height x width x channels bytes; `tables_size` 0: no
// JPEGTables tag.
int gs_jpeg_decode_tiff(const uint8_t* tables, long long tables_size, const uint8_t* data, long long size,
                        int height, int width, int channels, int ycbcr_h, int ycbcr_v, int last_strip,
                        uint8_t* out) {
  try {
    auto with_eoi = [](const uint8_t* p, long long n) {  // libtiff's fake EOI at every read past the end
      std::vector<uint8_t> v(p, p + n);
      for (int i = 0; i < 32769; ++i) {
        v.push_back(0xFF);
        v.push_back(M_EOI);
      }
      return v;
    };
    const std::vector<uint8_t> strip = with_eoi(data, size);
    Decoder d(strip.data(), static_cast<int64_t>(strip.size()), false);
    d.tiff = true;
    d.want_h = height;
    d.want_w = width;
    d.want_c = channels;
    d.want_hs = ycbcr_h;
    d.want_vs = ycbcr_v;
    d.taller_ok = last_strip != 0;
    if (tables_size > 0) {
      const std::vector<uint8_t> t = with_eoi(tables, tables_size);
      d.read_tables(t.data(), static_cast<int64_t>(t.size()), strip.data(), static_cast<int64_t>(strip.size()));
    }
    d.run();
    if (d.height == height) {
      d.finish(out);
    } else {  // the last strip coded taller: its first `height` rows
      std::vector<uint8_t> frame(int64_t(d.width) * d.height * channels);
      d.finish(frame.data());
      std::memcpy(out, frame.data(), int64_t(width) * height * channels);
    }
    return 0;
  } catch (const Refused& r) {
    return fail(r.msg);
  } catch (const std::bad_alloc&) {
    return fail("out of host memory");
  }
}

// layout[0..2] = components, height, width; then per component h, v and
// its raw plane's width and height (whole MCUs)
int gs_jpeg_raw_layout(const uint8_t* data, long long size, int* layout) {
  try {
    Decoder d(data, size, true);
    d.raw = true;
    d.run();
    layout[0] = static_cast<int>(d.comps.size());
    layout[1] = d.height;
    layout[2] = d.width;
    for (size_t i = 0; i < d.comps.size(); ++i) {
      layout[3 + 4 * i] = d.comps[i].h;
      layout[4 + 4 * i] = d.comps[i].v;
      layout[5 + 4 * i] = d.mcux * d.comps[i].h * 8;
      layout[6 + 4 * i] = d.mcuy * d.comps[i].v * 8;
    }
    return 0;
  } catch (const Refused& r) {
    return fail(r.msg);
  } catch (const std::bad_alloc&) {
    return fail("out of host memory");
  }
}

// The raw planes of gs_jpeg_raw_layout, back to back, into `out` (`capacity`
// bytes); *good_rows: the iMCU rows libtiff's old-style JPEG codec delivers
// before a restart marker that is not the one expected (its resync fails
// the decoding for good).
int gs_jpeg_decode_raw(const uint8_t* data, long long size, uint8_t* out, long long capacity, int* good_rows) {
  try {
    Decoder d(data, size, false);
    d.raw = true;
    d.run();
    int64_t need = 0;
    for (const Component& c : d.comps) need += int64_t(c.stride) * 8 * c.rows * 8;
    if (need > capacity) return fail("output buffer too small");
    d.raw_planes(out);
    *good_rows = static_cast<int>(d.raw_fail < 0 ? d.mcuy : d.raw_fail / d.mcux);
    return 0;
  } catch (const Refused& r) {
    return fail(r.msg);
  } catch (const std::bad_alloc&) {
    return fail("out of host memory");
  }
}

const char* gs_jpeg_error() { return g_error.c_str(); }

}  // extern "C"
