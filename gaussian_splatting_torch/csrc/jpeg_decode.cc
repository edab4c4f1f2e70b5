// JPEG decoding for the dataset readers: host C++, built with the host
// compiler by utils/cuda_build.py at first use and loaded with ctypes.
//
// The same decoder as the plain version in utils/jpeg.py, step for step:
// the same checks in the same order with the same messages, the same bits
// out (PIL's: libjpeg-turbo's C code at its defaults). Huffman-coded 8-bit
// baseline, extended and progressive frames with 1 or 3 components;
// restart intervals; the "islow" IDCT (jidctint.c) with its range-limit
// table; fancy upsampling at chroma ratios 2x1, 2x2 and 1x2 (replication
// for h2v1 / h2v2 on components 2 or fewer samples wide); jdcolor.c's
// fixed-point YCbCr -> RGB. Everything else is refused by name.
//
// Interface (plain C; every entry returns 0 or an error, whose message
// gs_jpeg_error gives for the calling thread):
//   gs_jpeg_probe(data, size, hwc)        hwc[0..2] = height, width, channels
//   gs_jpeg_decode(data, size, out, cap)  (H, W, C) uint8 into out (cap bytes)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

struct Refused {
  std::string msg;
};

[[noreturn]] void refuse(const std::string& msg) { throw Refused{msg}; }
[[noreturn]] void corrupt(const std::string& what) { throw Refused{"corrupt data: " + what}; }

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

const int kMaxDimension = 65500;   // JPEG_MAX_DIMENSION
const int kMaxBlocksInMcu = 10;    // D_MAX_BLOCKS_IN_MCU

bool refusal(int sof, std::string* msg) {
  if (sof == 3) {
    *msg = "lossless JPEG (SOF3)";
  } else if (sof >= 5 && sof <= 7) {
    *msg = fmt("hierarchical JPEG (SOF%d)", sof);
  } else if (sof >= 9 && sof != 12) {
    *msg = fmt("arithmetic coding (SOF%d)", sof);
  } else {
    return false;
  }
  return true;
}

// jpeg_make_d_derived_tbl as a 16-bit lookup: (length << 8) | symbol for
// every 16-bit window that starts with a code, 0 where none does.
struct HuffSpec {
  bool defined = false;
  int counts[16];
  std::vector<uint8_t> symbols;
};

std::vector<uint16_t> huffman_lut(const HuffSpec& t, bool is_dc) {
  int total = 0;
  for (int l = 0; l < 16; ++l) total += t.counts[l];
  if (total > 256) corrupt("a Huffman table of more than 256 codes");
  std::vector<uint16_t> lut(1 << 16, 0);
  uint32_t code = 0;
  int p = 0;
  for (int length = 1; length <= 16; ++length) {
    for (int i = 0; i < t.counts[length - 1]; ++i) {
      int sym = t.symbols[p];
      if (is_dc && sym > 15) corrupt("a DC Huffman symbol over 15");
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

struct Component {
  int index, id, h, v, tq;
  bool latched = false;
  int64_t quant[64];  // natural order, wrapped to 16 bits as ISLOW_MULT_TYPE
  int bw, bh, nbx, nby, stride, rows;
  std::vector<int32_t> coef;
  int bits[64];
  bool scanned = false;
};

// Bits of one entropy-coded segment, most significant first, in 32-bit
// words; zeros past the end. A refill past the data's words and one word
// of zeros is corrupt, as is a decode that reads past the data (check_end).
struct Bits {
  const uint8_t* seg;
  int64_t size, limit, w = 0;
  uint64_t acc = 0;
  int n = 0;

  Bits(const std::vector<uint8_t>& s) : seg(s.data()), size(static_cast<int64_t>(s.size())) {
    limit = (size + 3) / 4 + 1;
  }
  uint32_t word(int64_t i) const {
    uint32_t x = 0;
    for (int64_t b = 4 * i; b < 4 * i + 4; ++b) x = (x << 8) | (b < size ? seg[b] : 0u);
    return x;
  }
  void refill() {
    if (w >= limit) corrupt("entropy-coded data shorter than its blocks");
    acc = ((acc & ((uint64_t(1) << n) - 1)) << 32) | word(w);
    ++w;
    n += 32;
  }
  int bits(int s) {
    if (n < s) refill();
    n -= s;
    return static_cast<int>((acc >> n) & ((uint64_t(1) << s) - 1));
  }
  int huff(const uint16_t* lut) {
    if (n < 16) refill();
    uint16_t e = lut[(acc >> (n - 16)) & 0xFFFF];
    if (!e) corrupt("a bad Huffman code");
    n -= e >> 8;
    return e & 255;
  }
  void check_end() const {
    if (w * 32 - n > 8 * size) corrupt("entropy-coded data shorter than its blocks");
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ---- reconstruction ----

const int64_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433, F_0_765 = 6270, F_0_899 = 7373,
              F_1_175 = 9633, F_1_501 = 12299, F_1_847 = 15137, F_1_961 = 16069,
              F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

// jidctint.c's butterfly: in[0..7] at stride `is`, outputs before descale.
inline void idct_1d(const int64_t* s, int is, int64_t* o) {
  int64_t z2 = s[2 * is], z3 = s[6 * is];
  int64_t z1 = (z2 + z3) * F_0_541;
  int64_t tmp2 = z1 - z3 * F_1_847;
  int64_t tmp3 = z1 + z2 * F_0_765;
  int64_t tmp0 = (s[0] + s[4 * is]) * (int64_t(1) << 13);
  int64_t tmp1 = (s[0] - s[4 * is]) * (int64_t(1) << 13);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = s[7 * is], t1 = s[5 * is], t2 = s[3 * is], t3 = s[1 * is];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  int64_t z4 = t1 + t3;
  int64_t z5 = (z3 + z4) * F_1_175;
  t0 *= F_0_298;
  t1 *= F_2_053;
  t2 *= F_3_072;
  t3 *= F_1_501;
  z1 *= -F_0_899;
  z2 *= -F_2_562;
  z3 = z3 * -F_1_961 + z5;
  z4 = z4 * -F_0_390 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  o[0] = tmp10 + t3;
  o[1] = tmp11 + t2;
  o[2] = tmp12 + t1;
  o[3] = tmp13 + t0;
  o[4] = tmp13 - t0;
  o[5] = tmp12 - t1;
  o[6] = tmp11 - t2;
  o[7] = tmp10 - t3;
}

// jdmaster.c's IDCT_range_limit (sample_range_limit + CENTERJSAMPLE) for
// indexes 0..1023 (RANGE_MASK): x + 128 below 128, 255 to 511, 0 from 512,
// x - 896 from 896.
struct RangeLimit {
  uint8_t v[1024];
  RangeLimit() {
    for (int x = 0; x < 1024; ++x)
      v[x] = static_cast<uint8_t>(x < 128 ? x + 128 : x < 512 ? 255 : x < 896 ? 0 : x - 896);
  }
};

const uint8_t* range_limit() {
  static const RangeLimit table;
  return table.v;
}

// One dequantised block (row = vertical frequency) -> 8x8 samples at `out`.
// The range-limit table equals a clamp on -512..511; PIL's build (the SIMD
// IDCT) gives neither beyond it, so a sample there is refused.
void idct_islow(const int32_t* coef, const int64_t* q, uint8_t* out, int64_t stride) {
  const uint8_t* limit = range_limit();
  int64_t in[64], ws[64], col[8], row[8];
  for (int i = 0; i < 64; ++i) in[i] = int64_t(coef[i]) * q[i];
  for (int c = 0; c < 8; ++c) {
    idct_1d(in + c, 8, col);
    for (int r = 0; r < 8; ++r) ws[r * 8 + c] = (col[r] + (int64_t(1) << 10)) >> 11;
  }
  for (int r = 0; r < 8; ++r) {
    idct_1d(ws + r * 8, 1, row);
    for (int c = 0; c < 8; ++c) {
      int64_t v = (row[c] + (int64_t(1) << 17)) >> 18;
      if (v < -512 || v > 511)
        refuse("an inverse DCT sample outside -512..511 (where libjpeg-turbo's SIMD and C IDCTs differ)");
      out[r * stride + c] = limit[v & 1023];
    }
  }
}

// libjpeg-turbo's upsampling of a component's real samples (bh x bw, row
// stride `ps`) by (hr, vr) into a plane of H x W.
void upsample(const uint8_t* in, int64_t ps, int bw, int bh, int hr, int vr, uint8_t* out, int W,
              int H) {
  if (hr == 1 && vr == 1) {
    for (int y = 0; y < H; ++y) std::memcpy(out + int64_t(y) * W, in + y * ps, W);
    return;
  }
  if (hr == 2 && bw <= 2) {  // replication
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) out[int64_t(y) * W + x] = in[(y / vr) * ps + x / 2];
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

const int M_SOF0 = 0xC0, M_SOF1 = 0xC1, M_SOF2 = 0xC2, M_DHT = 0xC4, M_DAC = 0xCC, M_SOI = 0xD8,
          M_EOI = 0xD9, M_SOS = 0xDA, M_DQT = 0xDB, M_DNL = 0xDC, M_DRI = 0xDD, M_DHP = 0xDE,
          M_EXP = 0xDF, M_APP0 = 0xE0, M_APP14 = 0xEE, M_COM = 0xFE;

struct Decoder {
  const uint8_t* data;
  int64_t size;
  bool header_only;
  bool have_qt[4] = {false, false, false, false};
  int64_t qt[4][64];
  HuffSpec huff[2][4];
  int restart_interval = 0;
  bool have_frame = false, progressive = false, jfif = false;
  int adobe = -1;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0, scans = 0;
  std::vector<Component> comps;

  Decoder(const uint8_t* d, int64_t n, bool header) : data(d), size(n), header_only(header) {}

  int64_t next_marker(int64_t pos, int* marker) {
    if (pos >= size) refuse("truncated data");
    if (data[pos] != 0xFF) corrupt(fmt("a byte 0x%02x where a marker belongs", data[pos]));
    while (pos < size && data[pos] == 0xFF) ++pos;
    if (pos >= size) refuse("truncated data");
    *marker = data[pos];
    return pos + 1;
  }

  // The markers in order; a header-only run stops after the frame header.
  void run() {
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) refuse("not a JPEG file (no SOI marker)");
    int64_t pos = 2;
    for (;;) {
      int marker;
      pos = next_marker(pos, &marker);
      if (marker == M_EOI) break;
      if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
      if (marker == M_SOI) corrupt("a second SOI marker");
      if (pos + 2 > size) refuse("truncated data");
      int length = (data[pos] << 8) | data[pos + 1];
      if (length < 2) corrupt(fmt("a marker segment of length %d", length));
      if (pos + length > size) refuse("truncated data");
      const uint8_t* body = data + pos + 2;
      int blen = length - 2;
      pos += length;
      std::string why;
      if (marker == M_SOF0 || marker == M_SOF1 || marker == M_SOF2) {
        sof(marker, body, blen);
        if (header_only) return;
      } else if (marker >= 0xC0 && marker <= 0xCF && refusal(marker - 0xC0, &why)) {
        refuse(why);
      } else if (marker == M_DAC) {
        refuse("arithmetic coding (a DAC marker)");
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
        pos = sos(body, blen, pos);
      } else if (marker == M_APP0) {
        if (blen >= 14 && std::memcmp(body, "JFIF\0", 5) == 0) jfif = true;
      } else if (marker == M_APP14) {
        if (blen >= 12 && std::memcmp(body, "Adobe", 5) == 0) adobe = body[11];
      } else if (!((marker >= 0xE0 && marker <= 0xEF) || marker == M_COM || marker == M_DNL)) {
        corrupt(fmt("an unknown marker 0x%02x", marker));
      }
    }
    if (!have_frame || scans == 0) corrupt("no image data before EOI");
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
    if (nc != 1 && nc != 3) refuse(fmt("%d colour components", nc) + (nc == 4 ? " (CMYK or YCCK)" : ""));
    if (height == 0) refuse("a DNL height (0 in the frame header)");
    if (width == 0) corrupt("an image 0 samples wide");
    if (std::max(width, height) > kMaxDimension) refuse(fmt("an image dimension over %d", kMaxDimension));
    for (int i = 0; i < nc; ++i) {
      Component c;
      c.index = i;
      c.id = b[6 + 3 * i];
      c.h = b[7 + 3 * i] >> 4;
      c.v = b[7 + 3 * i] & 15;
      c.tq = b[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        corrupt(fmt("component %d's sampling factors or quantisation table", i));
      for (const Component& o : comps)
        if (o.id == c.id) corrupt("two components with one id");
      comps.push_back(c);
    }
    for (const Component& c : comps) {
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (const Component& c : comps) {
      if (hmax % c.h || vmax % c.v)
        refuse(fmt("component %d's sampling factors %dx%d (a fractional chroma ratio)", c.index, c.h, c.v));
      int hr = hmax / c.h, vr = vmax / c.v;
      if (!((hr == 1 && vr == 1) || (hr == 2 && vr == 1) || (hr == 2 && vr == 2) || (hr == 1 && vr == 2)))
        refuse(fmt("a %dx%d chroma subsampling ratio (component %d)", hr, vr, c.index));
    }
    have_frame = true;
    progressive = marker == M_SOF2;
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    if (header_only) return;
    for (Component& c : comps) {
      c.bw = static_cast<int>((int64_t(width) * c.h + hmax - 1) / hmax);
      c.bh = static_cast<int>((int64_t(height) * c.v + vmax - 1) / vmax);
      c.nbx = (c.bw + 7) / 8;
      c.nby = (c.bh + 7) / 8;
      c.stride = mcux * c.h;
      c.rows = mcuy * c.v;
      c.coef.assign(int64_t(c.stride) * c.rows * 64, 0);
      std::fill(c.bits, c.bits + 64, -1);
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

  void dqt(const uint8_t* b, int n) {
    int p = 0;
    while (p < n) {
      int pq = b[p] >> 4, tq = b[p] & 15;
      int sz = pq ? 128 : 64;
      if (tq > 3 || pq > 1 || p + 1 + sz > n) corrupt("a quantisation table");
      for (int k = 0; k < 64; ++k)
        qt[tq][kZigzag[k]] = pq ? (b[p + 1 + 2 * k] << 8) | b[p + 2 + 2 * k] : b[p + 1 + k];
      have_qt[tq] = true;
      p += 1 + sz;
    }
  }

  // The scan's entropy-coded data from `pos` to the next marker that is not
  // RSTn, split at its restart markers, stuffing undone. Returns the end.
  int64_t entropy_segments(int64_t pos, std::vector<std::vector<uint8_t>>* segments) {
    segments->emplace_back();
    int expect = 0;
    int64_t i = pos;
    while (i < size) {
      uint8_t b = data[i];
      if (b != 0xFF) {
        segments->back().push_back(b);
        ++i;
        continue;
      }
      int64_t j = i;
      while (j < size && data[j] == 0xFF) ++j;
      if (j >= size) break;
      int m = data[j];
      if (m == 0) {
        segments->back().push_back(0xFF);
        i = j + 1;
      } else if (m >= 0xD0 && m <= 0xD7) {
        if (!restart_interval) corrupt("a restart marker without a restart interval");
        if (m != 0xD0 + expect) corrupt("a restart marker out of sequence");
        expect = (expect + 1) & 7;
        segments->emplace_back();
        i = j + 1;
      } else {
        return i;
      }
    }
    refuse("truncated data");
  }

  int64_t sos(const uint8_t* b, int n, int64_t pos) {
    if (!have_frame) corrupt("a scan before the frame header");
    if (n < 1 || n != 4 + 2 * b[0] || b[0] < 1 || b[0] > 4) corrupt("a scan header");
    int ns = b[0];
    std::vector<Component*> sc;
    int td[4], ta[4];
    for (int i = 0; i < ns; ++i) {
      int cid = b[1 + 2 * i], t = b[2 + 2 * i];
      Component* match = nullptr;
      for (Component& c : comps)
        if (c.id == cid) match = &c;
      if (!match || std::find(sc.begin(), sc.end(), match) != sc.end())
        corrupt(fmt("a scan of component id %d", cid));
      sc.push_back(match);
      td[i] = t >> 4;
      ta[i] = t & 15;
    }
    int ss = b[1 + 2 * ns], se = b[2 + 2 * ns], ah = b[3 + 2 * ns] >> 4, al = b[3 + 2 * ns] & 15;
    if (ns > 1) {
      int blocks = 0;
      for (Component* c : sc) blocks += c->h * c->v;
      if (blocks > kMaxBlocksInMcu) corrupt(fmt("an MCU of more than %d blocks", kMaxBlocksInMcu));
    }
    for (Component* c : sc) {
      if (!c->latched) {
        if (!have_qt[c->tq]) corrupt(fmt("component %d has no quantisation table", c->index));
        for (int k = 0; k < 64; ++k) c->quant[k] = static_cast<int16_t>(static_cast<uint16_t>(qt[c->tq][k]));
        c->latched = true;
      }
    }
    if (progressive) {
      check_progression(sc, ss, se, ah, al);
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      corrupt("a sequential scan that is not 0..63 at full precision");
    } else {
      for (Component* c : sc)
        if (c->scanned) corrupt("a component in two sequential scans");
    }
    for (Component* c : sc) c->scanned = true;
    std::vector<std::vector<uint8_t>> segments;
    int64_t end = entropy_segments(pos, &segments);

    int64_t per_mcu, n_mcu;
    if (ns == 1) {
      per_mcu = 1;
      n_mcu = int64_t(sc[0]->nbx) * sc[0]->nby;
    } else {
      per_mcu = 0;
      for (Component* c : sc) per_mcu += c->h * c->v;
      n_mcu = int64_t(mcux) * mcuy;
    }
    int64_t ri = restart_interval;
    int64_t n_seg = ri ? (n_mcu + ri - 1) / ri : 1;
    bool extra = false;
    for (size_t s = static_cast<size_t>(n_seg); s < segments.size(); ++s) extra |= !segments[s].empty();
    if (static_cast<int64_t>(segments.size()) < n_seg || extra)
      corrupt("restart markers that do not match the restart interval");

    auto lut = [&](int kind, int slot) {
      if (slot > 3 || !huff[kind][slot].defined) corrupt(fmt("a scan uses an undefined Huffman table %d/%d", kind, slot));
      return huffman_lut(huff[kind][slot], kind == 0);
    };
    std::vector<std::vector<uint16_t>> dc, ac;
    if (!progressive || (ss == 0 && ah == 0))
      for (int i = 0; i < ns; ++i) dc.push_back(lut(0, td[i]));
    if (!progressive) {
      for (int i = 0; i < ns; ++i) ac.push_back(lut(1, ta[i]));
    } else if (ss > 0) {
      ac.push_back(lut(1, ta[0]));
    }

    int64_t mcus_per_seg = ri ? ri : n_mcu;
    for (int64_t s = 0; s < n_seg; ++s) {
      Bits bits(segments[s]);
      int preds[4] = {0, 0, 0, 0};
      int eobrun = 0;
      int64_t m_end = std::min(n_mcu, (s + 1) * mcus_per_seg);
      for (int64_t m = s * mcus_per_seg; m < m_end; ++m) {
        for (int i = 0; i < ns; ++i) {
          Component* c = sc[i];
          int bh = ns == 1 ? 1 : c->v, bwid = ns == 1 ? 1 : c->h;
          for (int by = 0; by < bh; ++by) {
            for (int bx = 0; bx < bwid; ++bx) {
              int64_t block;
              if (ns == 1) {
                block = (m / c->nbx) * c->stride + m % c->nbx;
              } else {
                int64_t my = m / mcux, mx = m % mcux;
                block = (my * c->v + by) * c->stride + mx * c->h + bx;
              }
              int32_t* co = c->coef.data() + block * 64;
              if (!progressive) {
                sequential_block(bits, co, dc[i].data(), ac[i].data(), &preds[i]);
              } else if (ss == 0 && ah == 0) {
                int t = bits.huff(dc[i].data());
                if (t) preds[i] += extend(bits.bits(t), t);
                co[0] = preds[i] * (1 << al);
              } else if (ss == 0) {
                if (bits.bits(1)) co[0] |= 1 << al;
              } else if (ah == 0) {
                ac_first_block(bits, co, ac[0].data(), ss, se, al, &eobrun);
              } else {
                ac_refine_block(bits, co, ac[0].data(), ss, se, al, &eobrun);
              }
            }
          }
        }
      }
      bits.check_end();
    }
    ++scans;
    return end;
  }

  void check_progression(const std::vector<Component*>& sc, int ss, int se, int ah, int al) {
    int ns = static_cast<int>(sc.size());
    if ((ss == 0 && se != 0) || (ss > 0 && (ss > se || se > 63 || ns != 1)))
      corrupt(fmt("a progressive scan %d..%d of %d components", ss, se, ns));
    if ((ah && al != ah - 1) || al > 13) corrupt(fmt("a progressive scan with Ah %d, Al %d", ah, al));
    for (Component* c : sc) {
      if (ss > 0 && c->bits[0] < 0) corrupt("an AC scan before the component's DC scan");
      for (int k = ss; k <= se; ++k) {
        if (ah != std::max(c->bits[k], 0)) corrupt("a progressive scan out of order");
        c->bits[k] = al;
      }
    }
  }

  static void sequential_block(Bits& bits, int32_t* co, const uint16_t* dc, const uint16_t* ac,
                               int* pred) {
    int s = bits.huff(dc);
    if (s) *pred += extend(bits.bits(s), s);
    co[0] = *pred;
    for (int k = 1; k < 64;) {
      int rs = bits.huff(ac);
      int t = rs & 15;
      if (t) {
        k += rs >> 4;
        if (k > 63) corrupt("a coefficient index over 63");
        co[kZigzag[k]] = extend(bits.bits(t), t);
        ++k;
      } else if (rs == 0xF0) {
        k += 16;
      } else {
        break;
      }
    }
  }

  static void ac_first_block(Bits& bits, int32_t* co, const uint16_t* lut, int ss, int se, int al,
                             int* eobrun) {
    if (*eobrun) {
      --*eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = bits.huff(lut);
      int run = rs >> 4, s = rs & 15;
      if (s) {
        k += run;
        if (k > se) corrupt("a coefficient index past the scan's band");
        co[kZigzag[k]] = extend(bits.bits(s), s) * (1 << al);
      } else if (run == 15) {
        k += 15;
      } else {
        *eobrun = (1 << run) - 1;
        if (run) *eobrun += bits.bits(run);
        break;
      }
    }
  }

  // jdphuff.c decode_mcu_AC_refine.
  static void ac_refine_block(Bits& bits, int32_t* co, const uint16_t* lut, int ss, int se, int al,
                              int* eobrun) {
    int p1 = 1 << al, m1 = -(1 << al);
    int k = ss;
    if (!*eobrun) {
      for (; k <= se; ++k) {
        int rs = bits.huff(lut);
        int run = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) corrupt("a refinement coefficient of size over 1");
          s = bits.bits(1) ? p1 : m1;
        } else if (run != 15) {
          *eobrun = 1 << run;
          if (run) *eobrun += bits.bits(run);
          break;
        }
        for (; k <= se; ++k) {
          int32_t* c = co + kZigzag[k];
          if (*c) {
            if (bits.bits(1) && !(*c & p1)) *c += *c >= 0 ? p1 : m1;
          } else if (--run < 0) {
            break;
          }
        }
        if (s) {
          if (k > se) corrupt("a coefficient index past the scan's band");
          co[kZigzag[k]] = s;
        }
      }
    }
    if (*eobrun) {
      for (; k <= se; ++k) {
        int32_t* c = co + kZigzag[k];
        if (*c && bits.bits(1) && !(*c & p1)) *c += *c >= 0 ? p1 : m1;
      }
      --*eobrun;
    }
  }

  int channels() const { return static_cast<int>(comps.size()); }

  void finish(uint8_t* out) {
    if (progressive)
      for (const Component& c : comps)
        for (int k = 0; k < 64; ++k)
          if (c.bits[k] != 0) refuse("a progressive file whose scans leave coefficient bits out");
    for (const Component& c : comps)
      if (!c.latched) corrupt(fmt("component %d has no scan", c.index));
    int64_t npx = int64_t(width) * height;
    std::vector<std::vector<uint8_t>> planes(comps.size());
    for (size_t ci = 0; ci < comps.size(); ++ci) {
      const Component& c = comps[ci];
      int64_t ps = int64_t(c.stride) * 8;
      std::vector<uint8_t> padded(ps * c.rows * 8);
      for (int64_t by = 0; by < c.rows; ++by)
        for (int64_t bx = 0; bx < c.stride; ++bx)
          idct_islow(c.coef.data() + (by * c.stride + bx) * 64, c.quant,
                     padded.data() + by * 8 * ps + bx * 8, ps);
      planes[ci].resize(npx);
      upsample(padded.data(), ps, c.bw, c.bh, hmax / c.h, vmax / c.v, planes[ci].data(), width, height);
    }
    if (comps.size() == 1) {
      std::memcpy(out, planes[0].data(), npx);
      return;
    }
    bool rgb;
    if (jfif) {
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
    // jdcolor.c's build_ycc_rgb_table and ycc_rgb_convert (SCALEBITS 16)
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
    for (int64_t i = 0; i < npx; ++i) {
      out[3 * i] = clamp255(y[i] + cr_r[cr[i]]);
      out[3 * i + 1] = clamp255(y[i] + ((cb_g[cb[i]] + cr_g[cr[i]]) >> 16));
      out[3 * i + 2] = clamp255(y[i] + cb_b[cb[i]]);
    }
  }
};

int fail(const std::string& msg) {
  g_error = msg;
  return 1;
}

}  // namespace

extern "C" {

int gs_jpeg_probe(const uint8_t* data, long long size, int* hwc) {
  try {
    Decoder d(data, size, true);
    d.run();
    hwc[0] = d.height;
    hwc[1] = d.width;
    hwc[2] = d.channels();
    return 0;
  } catch (const Refused& r) {
    return fail(r.msg);
  } catch (const std::bad_alloc&) {
    return fail("out of host memory");
  }
}

int gs_jpeg_decode(const uint8_t* data, long long size, uint8_t* out, long long capacity) {
  try {
    Decoder d(data, size, false);
    d.run();
    if (int64_t(d.width) * d.height * d.channels() > capacity) return fail("output buffer too small");
    d.finish(out);
    return 0;
  } catch (const Refused& r) {
    return fail(r.msg);
  } catch (const std::bad_alloc&) {
    return fail("out of host memory");
  }
}

const char* gs_jpeg_error() { return g_error.c_str(); }

}  // extern "C"
