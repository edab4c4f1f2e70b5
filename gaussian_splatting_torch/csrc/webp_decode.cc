// WebP decoding for the dataset readers: host C++, built with the host
// compiler by utils/cuda_build.py at first use and loaded with ctypes by
// utils/webp.py, which walks the RIFF container (VP8X, ALPH, ANIM / ANMF)
// and places the frame on its canvas. Everything here follows libwebp 1.6
// as PIL's WebPAnimDecoder runs it (RGBA out, fancy upsampling, no
// dithering), so the pixels are PIL's, bit for bit.
//
// - VP8L, the lossless bitstream (RFC 9649): the header; the predictor
//   (14 modes), cross-colour, subtract-green and colour-indexing transforms
//   (pixel bundling for 16 colours or fewer), undone in reverse order; the
//   colour cache; simple and normal prefix codes, the meta prefix codes of
//   an entropy image; LZ77 backward references with the 120-entry distance
//   map. libwebp's end-of-stream rule: reading past the data (at least 64
//   bits) fails the image.
// - ALPH (the extended format's alpha): raw or a header-less VP8L stream
//   whose green channel is the alpha; filters none, horizontal, vertical
//   and gradient with libwebp's first-row and first-column rules.
// - VP8, the lossy bitstream (RFC 6386), key frames: libwebp's boolean
//   decoder (its end-of-data rule: a macroblock row or partition read past
//   its data fails the image), segments, token partitions, probability
//   updates, intra prediction with libwebp's 127 / 129 borders and its
//   top-right rule for 4x4 blocks, dequantisation into int16, the WHT and
//   the IDCT (the full transform in the 16-bit arithmetic of libwebp's
//   SSE2 form, the DC-only and three-coefficient forms in its C form), the
//   simple and normal loop filters.
// - YUV 4:2:0 -> RGBA: libwebp's fancy upsampler (UPSAMPLE_FUNC: two
//   roundings, rows in pairs, the edge rows on their own) and VP8YUVToR /
//   G / B (14-bit products, a 6-bit shift, clamped).
//
// Interface (plain C; every entry returns 0 or 1, the message of a 1 in
// gs_webp_error for the calling thread):
//   gs_webp_info(data, n, declared, lossless, out)  out[0..2] = width,
//       height, VP8L's alpha bit; libwebp's VP8GetInfo / VP8LGetInfo checks
//   gs_webp_decode(data, n, lossless, alpha, alpha_n, out, stride)
//       RGBA into out (rows `stride` bytes apart); `alpha` is the ALPH
//       payload of a VP8 frame (NULL: opaque)
// `data` is a chunk's payload with its pad byte, as libwebp reads it.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

struct Failure {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Failure{msg}; }

// ---------------------------------------------------------------- VP8L --

const int kMaxCodeLength = 15;
const int kFastBits = 8;
const int kNumLiteral = 256, kNumLength = 24, kNumDistance = 40;
const int kAlphabetSize[5] = {kNumLiteral + kNumLength, kNumLiteral, kNumLiteral, kNumLiteral, kNumDistance};
const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
// (dy << 4) | (8 - dx) of the 120 short distance codes (RFC 9649 4.2.2)
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1b,
    0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d,
    0x68, 0x02, 0x67, 0x69, 0x12, 0x1e, 0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

// libwebp's VP8LBitReader: a 64-bit window of the stream, least
// significant bit first, refilled a byte at a time while bytes remain.
// Past the end it reads what the window holds (zeros beyond the last
// byte; from its start again at exactly 64 bits, as libwebp's shift wraps),
// and the end of stream is more bits consumed than the data holds (at
// least 64). Which of these a corrupt stream meets decides its pixels where
// libwebp tolerates it (the 8-bit alpha path), so they are kept exactly.
class LosslessBits {
 public:
  LosslessBits(const uint8_t* data, size_t size) : buf_(data), len_(size) {
    pos_ = size < 8 ? size : 8;
    for (size_t i = 0; i < pos_; ++i) val_ |= uint64_t(data[i]) << (8 * i);
  }
  uint32_t prefetch() const { return static_cast<uint32_t>(val_ >> (bit_pos_ & 63)); }
  void skip(int n) { bit_pos_ += n; }
  uint32_t read(int n) {  // VP8LReadBits
    if (!eos_ && n <= 24) {
      const uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos_ += n;
      shift_bytes();
      return v;
    }
    set_eos();
    return 0;
  }
  void fill() {  // VP8LFillBitWindow
    if (bit_pos_ >= 32) shift_bytes();
  }
  bool eos() const { return eos_ || (pos_ == len_ && bit_pos_ > 64); }  // VP8LIsEndOfStream
  bool eos_flag() const { return eos_; }
  void mark_eos() { eos_ = eos(); }

 private:
  void shift_bytes() {
    while (bit_pos_ >= 8 && pos_ < len_) {
      val_ = (val_ >> 8) | uint64_t(buf_[pos_++]) << 56;
      bit_pos_ -= 8;
    }
    if (eos()) set_eos();
  }
  void set_eos() {
    eos_ = true;
    bit_pos_ = 0;
  }
  const uint8_t* buf_;
  size_t len_, pos_ = 0;
  uint64_t val_ = 0;
  int bit_pos_ = 0;
  bool eos_ = false;
};

// A canonical prefix code, as VP8LBuildHuffmanTable accepts it: not all
// lengths zero, no length over 15, complete unless it has one symbol
// (which reads no bits).
class PrefixCode {
 public:
  bool build(const std::vector<int>& lengths, int alphabet) {
    int count[kMaxCodeLength + 1] = {0};
    for (int s = 0; s < alphabet; ++s) {
      if (lengths[s] > kMaxCodeLength) return false;
      ++count[lengths[s]];
    }
    if (count[0] == alphabet) return false;
    int offset[kMaxCodeLength + 2];
    offset[1] = 0;
    for (int len = 1; len <= kMaxCodeLength; ++len) offset[len + 1] = offset[len] + count[len];
    const int total = offset[kMaxCodeLength + 1];
    sorted_.assign(total, 0);
    for (int s = 0; s < alphabet; ++s)
      if (lengths[s] > 0) sorted_[offset[lengths[s]]++] = static_cast<uint16_t>(s);
    if (total == 1) {
      single_ = sorted_[0];
      return true;
    }
    single_ = -1;
    int num_nodes = 1, num_open = 1;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      num_open <<= 1;
      num_nodes += num_open;
      num_open -= count[len];
      if (num_open < 0) return false;
    }
    if (num_nodes != 2 * total - 1) return false;
    std::copy(count, count + kMaxCodeLength + 1, count_);
    fast_.assign(1 << kFastBits, 0);
    int code = 0, index = 0;
    for (int len = 1; len <= kMaxCodeLength; ++len, code <<= 1) {
      for (int k = 0; k < count[len]; ++k, ++code) {
        const int sym = sorted_[index++];
        if (len > kFastBits) continue;
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int hi = rev; hi < (1 << kFastBits); hi += 1 << len) fast_[hi] = static_cast<uint16_t>(len << 12 | sym);
      }
    }
    return true;
  }
  // libwebp's ReadSymbol: an 8-bit root lookup, and for a longer code
  // its remaining bits from a second look at the window 8 bits on
  int read(LosslessBits& br) const {
    if (single_ >= 0) return single_;
    const uint32_t bits = br.prefetch();
    const uint16_t e = fast_[bits & ((1 << kFastBits) - 1)];
    if (e) {
      br.skip(e >> 12);
      return e & 0xfff;
    }
    br.skip(kFastBits);
    const uint32_t more = br.prefetch();
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      code |= (len <= kFastBits ? bits >> (len - 1) : more >> (len - 1 - kFastBits)) & 1;
      const int n = count_[len];
      if (code - first < n) {
        br.skip(len - kFastBits);
        return sorted_[index + code - first];
      }
      index += n;
      first = (first + n) << 1;
      code <<= 1;
    }
    return 0;  // not reached: the code is complete
  }
  bool trivial() const { return single_ >= 0; }
  int single() const { return single_; }

 private:
  int single_ = -1;
  int count_[kMaxCodeLength + 1] = {0};
  std::vector<uint16_t> sorted_;
  std::vector<uint16_t> fast_;
};

int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }

uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (c0 >> s) & 0xff, b = (c1 >> s) & 0xff, c = (c2 >> s) & 0xff;
    out |= clip255(static_cast<uint32_t>(a + b - c)) << s;
  }
  return out;
}

uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
    out |= clip255(static_cast<uint32_t>(a + (a - b) / 2)) << s;
  }
  return out;
}

uint32_t select(uint32_t t, uint32_t l, uint32_t tl) {
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (t >> s) & 0xff, b = (l >> s) & 0xff, c = (tl >> s) & 0xff;
    pa_minus_pb += std::abs(b - c) - std::abs(a - c);
  }
  return pa_minus_pb <= 0 ? t : l;
}

uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TL, uint32_t TR) {
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select(T, L, TL);
    case 12: return clamped_add_subtract_full(L, T, TL);
    case 13: return clamped_add_subtract_half(L, T, TL);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp reads them
  }
}

int color_delta(int8_t pred, int8_t color) { return (static_cast<int>(pred) * color) >> 5; }

enum { kPredictor = 0, kCrossColor = 1, kSubtractGreen = 2, kColorIndexing = 3 };

struct Transform {
  int type;
  int bits;
  int xsize, ysize;  // the image's size before this transform's packing
  std::vector<uint32_t> data;
};

struct CodeGroup {
  PrefixCode code[5];  // green + lengths + cache, red, blue, alpha, distance
};

// An entropy-coded image's codes: the colour cache, the meta prefix codes
// (each pixel's group, from the entropy image) and the groups in use.
struct Codes {
  int cache_bits = 0, meta_bits = 0, meta_xsize = 0;
  std::vector<uint32_t> meta;
  std::vector<CodeGroup> groups;
  bool rba_trivial = true;  // every group libwebp keeps reads red, blue and alpha with no bits
};

class Lossless {
 public:
  explicit Lossless(LosslessBits& br) : br_(br) {}

  // The ARGB pixels of a level-0 stream of xsize x ysize (transforms undone).
  // `alpha`: an ALPH stream, which libwebp decodes by DecodeAlphaData where
  // colour indexing is its only transform and it reads only green.
  std::vector<uint32_t> image(int xsize, int ysize, bool alpha = false) {
    int width = xsize;
    while (br_.read(1)) read_transform(width, ysize);
    const Codes codes = read_codes(width, ysize, true);
    std::vector<uint32_t> pixels(static_cast<size_t>(width) * ysize);
    if (alpha && transforms_.size() == 1 && transforms_[0].type == kColorIndexing && codes.cache_bits == 0 &&
        codes.rba_trivial)
      decode_indices(pixels, width, ysize, codes);
    else
      decode_pixels(pixels, width, ysize, codes);
    for (int i = static_cast<int>(transforms_.size()) - 1; i >= 0; --i) undo(transforms_[i], pixels);
    return pixels;
  }

 private:
  LosslessBits& br_;
  std::vector<Transform> transforms_;
  unsigned seen_ = 0;

  void check_eos() {
    if (br_.eos()) fail("VP8L data ends early");
  }

  // A sub-image (a transform's data, the entropy image, a palette).
  std::vector<uint32_t> stream(int xsize, int ysize) {
    const Codes codes = read_codes(xsize, ysize, false);
    std::vector<uint32_t> data(static_cast<size_t>(xsize) * ysize);
    decode_pixels(data, xsize, ysize, codes);
    return data;
  }

  Codes read_codes(int width, int ysize, bool level0) {
    Codes c;
    if (br_.read(1)) {
      c.cache_bits = br_.read(4);
      if (c.cache_bits < 1 || c.cache_bits > 11)
        fail("VP8L colour cache of " + std::to_string(c.cache_bits) + " bits");
    }
    int num_groups = 1;
    if (level0 && br_.read(1)) {
      c.meta_bits = br_.read(3) + 2;
      c.meta_xsize = subsample(width, c.meta_bits);
      c.meta = stream(c.meta_xsize, subsample(ysize, c.meta_bits));
      for (uint32_t& p : c.meta) {
        p = (p >> 8) & 0xffff;
        num_groups = std::max(num_groups, static_cast<int>(p) + 1);
      }
    }
    // every group's codes are read and checked; only the used ones are
    // kept. libwebp keeps every group unless there are more than 1000 or
    // more than pixels, and checks red, blue and alpha in those it keeps.
    const bool only_used = num_groups > 1000 || num_groups > static_cast<int64_t>(width) * ysize;
    std::vector<int> slot(num_groups, -1);
    if (c.meta.empty()) {
      slot[0] = 0;
    } else {
      for (uint32_t g : c.meta)
        if (slot[g] < 0) slot[g] = 0;
    }
    int used = 0;
    for (int& s : slot)
      if (s == 0) s = used++;
    c.groups.resize(used);
    CodeGroup scratch;
    for (int g = 0; g < num_groups; ++g) {
      CodeGroup& into = slot[g] >= 0 ? c.groups[slot[g]] : scratch;
      for (int j = 0; j < 5; ++j)
        read_code(kAlphabetSize[j] + (j == 0 && c.cache_bits ? 1 << c.cache_bits : 0), into.code[j]);
      if (slot[g] >= 0 || !only_used)
        c.rba_trivial &= into.code[1].trivial() && into.code[2].trivial() && into.code[3].trivial();
    }
    for (uint32_t& p : c.meta) p = slot[p];
    return c;
  }

  void read_transform(int& xsize, int ysize) {
    const int type = br_.read(2);
    if (seen_ & (1u << type)) fail("a VP8L transform used twice");
    seen_ |= 1u << type;
    Transform t{type, 0, xsize, ysize, {}};
    if (type == kPredictor || type == kCrossColor) {
      t.bits = br_.read(3) + 2;
      t.data = stream(subsample(xsize, t.bits), subsample(ysize, t.bits));
    } else if (type == kColorIndexing) {
      const int num_colors = br_.read(8) + 1;
      t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      xsize = subsample(xsize, t.bits);
      std::vector<uint32_t> palette = stream(num_colors, 1);
      t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);  // past the colours: transparent black
      t.data[0] = palette[0];
      for (int i = 1; i < num_colors; ++i) t.data[i] = add_pixels(palette[i], t.data[i - 1]);
    }
    transforms_.push_back(std::move(t));
  }

  void read_code(int alphabet, PrefixCode& code) {
    std::vector<int> lengths(std::max(alphabet, 256), 0);
    if (br_.read(1)) {  // simple: one or two symbols of length 1
      const int num_symbols = br_.read(1) + 1;
      const int first_bits = br_.read(1) ? 8 : 1;
      lengths[br_.read(first_bits)] = 1;
      if (num_symbols == 2) lengths[br_.read(8)] = 1;
    } else {
      std::vector<int> cl(19, 0);
      const int num_codes = br_.read(4) + 4;
      for (int i = 0; i < num_codes; ++i) cl[kCodeLengthOrder[i]] = br_.read(3);
      PrefixCode lengths_code;
      if (!lengths_code.build(cl, 19)) fail("a VP8L code-length code that is not a prefix code");
      int max_symbol = alphabet;
      if (br_.read(1)) {
        const int nbits = 2 + 2 * br_.read(3);
        max_symbol = 2 + br_.read(nbits);
        if (max_symbol > alphabet) fail("a VP8L code with more lengths than symbols");
      }
      int symbol = 0, prev = 8;
      while (symbol < alphabet) {
        if (max_symbol-- == 0) break;
        br_.fill();
        const int len = lengths_code.read(br_);
        if (len < 16) {
          lengths[symbol++] = len;
          if (len) prev = len;
        } else {
          static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
          int repeat = br_.read(kExtra[len - 16]) + kOffset[len - 16];
          if (symbol + repeat > alphabet) fail("a VP8L code-length run past the alphabet");
          const int value = len == 16 ? prev : 0;
          while (repeat-- > 0) lengths[symbol++] = value;
        }
      }
    }
    check_eos();
    if (!code.build(lengths, alphabet)) fail("a VP8L prefix code that is not complete");
  }

  int copy_value(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + static_cast<int>(br_.read(extra)) + 1;
  }

  static int plane_distance(int xsize, int code) {
    if (code > 120) return code - 120;
    const int dist_code = kCodeToPlane[code - 1];
    const int dist = (dist_code >> 4) * xsize + 8 - (dist_code & 0xf);
    return dist >= 1 ? dist : 1;
  }

  const CodeGroup& group_at(const Codes& c, int col, int row) const {
    return c.groups[c.meta.empty() ? 0 : c.meta[(row >> c.meta_bits) * c.meta_xsize + (col >> c.meta_bits)]];
  }

  // libwebp's DecodeImageData (the window refilled where it refills it):
  // reading past the end fails the image.
  void decode_pixels(std::vector<uint32_t>& data, int width, int height, const Codes& c) {
    const int64_t total = static_cast<int64_t>(width) * height;
    std::vector<uint32_t> cache(c.cache_bits ? 1u << c.cache_bits : 0);
    const int cache_shift = 32 - c.cache_bits;
    int64_t pos = 0, cached = 0;
    int col = 0, row = 0;
    auto flush_cache = [&]() {
      for (; cached < pos; ++cached) cache[(0x1e35a7bdu * data[cached]) >> cache_shift] = data[cached];
    };
    while (pos < total) {
      const CodeGroup& g = group_at(c, col, row);
      br_.fill();
      const int code = g.code[0].read(br_);
      if (br_.eos()) break;
      if (code < kNumLiteral) {
        const uint32_t red = g.code[1].read(br_);
        br_.fill();
        const uint32_t blue = g.code[2].read(br_);
        const uint32_t alpha = g.code[3].read(br_);
        if (br_.eos()) break;
        data[pos++] = alpha << 24 | red << 16 | static_cast<uint32_t>(code) << 8 | blue;
        if (++col >= width) {
          col = 0;
          ++row;
        }
      } else if (code < kNumLiteral + kNumLength) {
        const int length = copy_value(code - kNumLiteral);
        const int dist_symbol = g.code[4].read(br_);
        br_.fill();
        const int dist = plane_distance(width, copy_value(dist_symbol));
        if (br_.eos()) break;
        if (pos < dist || total - pos < length) fail("a VP8L backward reference outside the image");
        for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
      } else if (code < kNumLiteral + kNumLength + static_cast<int>(cache.size())) {
        flush_cache();
        data[pos++] = cache[code - kNumLiteral - kNumLength];
        if (++col >= width) {
          col = 0;
          ++row;
        }
      } else {
        fail("a VP8L colour cache code without a colour cache");
      }
    }
    check_eos();
  }

  // libwebp's DecodeAlphaData: green (palette indices) only, and reading
  // past the end fails the image only where indices are still missing.
  void decode_indices(std::vector<uint32_t>& data, int width, int height, const Codes& c) {
    const int64_t total = static_cast<int64_t>(width) * height;
    int64_t pos = 0;
    int col = 0, row = 0;
    while (!br_.eos_flag() && pos < total) {
      const CodeGroup& g = group_at(c, col, row);
      br_.fill();
      const int code = g.code[0].read(br_);
      if (code < kNumLiteral) {
        data[pos++] = static_cast<uint32_t>(code) << 8;
        if (++col >= width) {
          col = 0;
          ++row;
        }
      } else if (code < kNumLiteral + kNumLength) {
        const int length = copy_value(code - kNumLiteral);
        const int dist_symbol = g.code[4].read(br_);
        br_.fill();
        const int dist = plane_distance(width, copy_value(dist_symbol));
        if (pos < dist || total - pos < length) fail("a VP8L backward reference outside the image");
        for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
      } else {
        fail("a VP8L colour cache code without a colour cache");
      }
      br_.mark_eos();
    }
    if (br_.eos() && pos < total) fail("VP8L data ends early");
  }

  void undo(const Transform& t, std::vector<uint32_t>& pixels) {
    const int w = t.xsize, h = t.ysize;
    if (t.type == kSubtractGreen) {
      for (uint32_t& p : pixels) {
        const uint32_t green = (p >> 8) & 0xff;
        p = (p & 0xff00ff00u) | ((((p >> 16) + green) & 0xff) << 16) | ((p + green) & 0xff);
      }
    } else if (t.type == kPredictor) {
      const int tiles = subsample(w, t.bits);
      uint32_t* out = pixels.data();
      out[0] = add_pixels(out[0], 0xff000000u);
      for (int x = 1; x < w; ++x) out[x] = add_pixels(out[x], out[x - 1]);
      for (int y = 1; y < h; ++y) {
        uint32_t* cur = out + static_cast<size_t>(y) * w;
        const uint32_t* up = cur - w;
        const uint32_t* modes = t.data.data() + static_cast<size_t>(y >> t.bits) * tiles;
        cur[0] = add_pixels(cur[0], up[0]);
        for (int x = 1; x < w; ++x) {
          const int mode = (modes[x >> t.bits] >> 8) & 0xf;
          // the top-right of the last column is the first pixel of this row
          cur[x] = add_pixels(cur[x], predict(mode, cur[x - 1], up[x], up[x - 1], up[x + 1]));
        }
      }
    } else if (t.type == kCrossColor) {
      const int tiles = subsample(w, t.bits);
      for (int y = 0; y < h; ++y) {
        uint32_t* cur = pixels.data() + static_cast<size_t>(y) * w;
        const uint32_t* codes = t.data.data() + static_cast<size_t>(y >> t.bits) * tiles;
        for (int x = 0; x < w; ++x) {
          const uint32_t m = codes[x >> t.bits];
          const int8_t g2r = static_cast<int8_t>(m & 0xff), g2b = static_cast<int8_t>((m >> 8) & 0xff);
          const int8_t r2b = static_cast<int8_t>((m >> 16) & 0xff);
          const uint32_t argb = cur[x];
          const int8_t green = static_cast<int8_t>(argb >> 8);
          int red = (argb >> 16) & 0xff, blue = argb & 0xff;
          red = (red + color_delta(g2r, green)) & 0xff;
          blue = (blue + color_delta(g2b, green) + color_delta(r2b, static_cast<int8_t>(red))) & 0xff;
          cur[x] = (argb & 0xff00ff00u) | static_cast<uint32_t>(red) << 16 | static_cast<uint32_t>(blue);
        }
      }
    } else {  // colour indexing, packed 8 >> bits bits an index
      const int packed_w = subsample(w, t.bits);
      std::vector<uint32_t> out(static_cast<size_t>(w) * h);
      const int bits_per = 8 >> t.bits, per_byte = 1 << t.bits, mask = (1 << bits_per) - 1;
      for (int y = 0; y < h; ++y) {
        const uint32_t* src = pixels.data() + static_cast<size_t>(y) * packed_w;
        uint32_t* dst = out.data() + static_cast<size_t>(y) * w;
        for (int x = 0; x < w; ++x) {
          const uint32_t packed = (src[x >> t.bits] >> 8) & 0xff;
          dst[x] = t.data[(packed >> (bits_per * (x & (per_byte - 1)))) & mask];
        }
      }
      pixels.swap(out);
    }
  }
};

// The ARGB pixels of a VP8L bitstream with its header.
std::vector<uint32_t> decode_lossless(const uint8_t* data, size_t n, int& width, int& height) {
  LosslessBits br(data, n);
  if (br.read(8) != 0x2f) fail("not a VP8L bitstream (no 0x2f signature)");
  width = br.read(14) + 1;
  height = br.read(14) + 1;
  br.read(1);
  if (br.read(3) != 0) fail("a VP8L bitstream of an unknown version");
  if (br.eos()) fail("VP8L header cut short");
  Lossless dec(br);
  return dec.image(width, height);
}

// ---------------------------------------------------------------- ALPH --

void unfilter_rows(uint8_t* plane, int width, int height, int filter) {
  for (int y = 0; y < height; ++y) {
    uint8_t* out = plane + static_cast<size_t>(y) * width;
    const uint8_t* prev = y ? out - width : nullptr;
    if (filter == 1 || (filter >= 2 && prev == nullptr)) {  // horizontal, and the first row of the others
      uint8_t pred = prev ? prev[0] : 0;
      for (int i = 0; i < width; ++i) pred = out[i] = static_cast<uint8_t>(pred + out[i]);
    } else if (filter == 2) {
      for (int i = 0; i < width; ++i) out[i] = static_cast<uint8_t>(prev[i] + out[i]);
    } else if (filter == 3) {
      uint8_t top = prev[0], top_left = top, left = top;
      for (int i = 0; i < width; ++i) {
        top = prev[i];
        const int g = left + top - top_left;
        left = static_cast<uint8_t>(out[i] + ((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255));
        top_left = top;
        out[i] = left;
      }
    }
  }
}

std::vector<uint8_t> decode_alpha(const uint8_t* data, size_t n, int width, int height) {
  if (n <= 1) fail("an ALPH chunk without data");
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3, reserved = data[0] >> 6;
  if (method > 1 || pre > 1 || reserved != 0)
    fail("an ALPH header of compression " + std::to_string(method) + ", pre-processing " + std::to_string(pre) +
         ", reserved bits " + std::to_string(reserved));
  std::vector<uint8_t> plane(static_cast<size_t>(width) * height);
  if (method == 0) {
    if (n - 1 < plane.size()) fail("ALPH data shorter than the image");
    std::memcpy(plane.data(), data + 1, plane.size());
  } else {
    LosslessBits br(data + 1, n - 1);
    Lossless dec(br);
    const std::vector<uint32_t> argb = dec.image(width, height, true);
    for (size_t i = 0; i < plane.size(); ++i) plane[i] = (argb[i] >> 8) & 0xff;
  }
  unfilter_rows(plane.data(), width, height, filter);
  return plane;
}

// ----------------------------------------------------------------- VP8 --

// RFC 6386 13.5: default token probabilities, [type][band][context][node]
const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
      1,  98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
     78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
      1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
     77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
      1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
     37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
      1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
      1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
     80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
      1,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198,  35, 237, 223, 193, 187, 162, 160, 145, 155,  62,
    131,  45, 198, 221, 172, 176, 220, 157, 252, 221,   1,
     68,  47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
      1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
     81,  99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
      1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
     99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
     23,  91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
      1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
     44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
      1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
     94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
     22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
      1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
     35,  77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
      1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
     45,  99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
      1,   1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203,   1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137,   1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253,   9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175,  13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
     73,  17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
      1,  95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239,  90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155,  77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
      1,  24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201,  51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
     69,  46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
      1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
      1,  16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190,  36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
      1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
      1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213,  62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
     55,  93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202,  24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126,  38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
     61,  46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
      1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
     39,  77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
      1,  52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124,  74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
     24,  71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
      1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
     28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
      1,  81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
     20,  95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
      1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
     47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
      1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141,  84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
     42,  80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
      1,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
// RFC 6386 13.4: probabilities that each token probability is updated
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
// RFC 6386 11.5: key-frame 4x4 mode probabilities, [above][left][node] in libwebp's mode order
const uint8_t kBModesProba[10][10][9] = {
    231, 120,  48,  89, 115, 113, 120, 152, 112,
    152, 179,  64, 126, 170, 118,  46,  70,  95,
    175,  69, 143,  80,  85,  82,  72, 155, 103,
     56,  58,  10, 171, 218, 189,  17,  13, 152,
    114,  26,  17, 163,  44, 195,  21,  10, 173,
    121,  24,  80, 195,  26,  62,  44,  64,  85,
    144,  71,  10,  38, 171, 213, 144,  34,  26,
    170,  46,  55,  19, 136, 160,  33, 206,  71,
     63,  20,   8, 114, 114, 208,  12,   9, 226,
     81,  40,  11,  96, 182,  84,  29,  16,  36,
    134, 183,  89, 137,  98, 101, 106, 165, 148,
     72, 187, 100, 130, 157, 111,  32,  75,  80,
     66, 102, 167,  99,  74,  62,  40, 234, 128,
     41,  53,   9, 178, 241, 141,  26,   8, 107,
     74,  43,  26, 146,  73, 166,  49,  23, 157,
     65,  38, 105, 160,  51,  52,  31, 115, 128,
    104,  79,  12,  27, 217, 255,  87,  17,   7,
     87,  68,  71,  44, 114,  51,  15, 186,  23,
     47,  41,  14, 110, 182, 183,  21,  17, 194,
     66,  45,  25, 102, 197, 189,  23,  18,  22,
     88,  88, 147, 150,  42,  46,  45, 196, 205,
     43,  97, 183, 117,  85,  38,  35, 179,  61,
     39,  53, 200,  87,  26,  21,  43, 232, 171,
     56,  34,  51, 104, 114, 102,  29,  93,  77,
     39,  28,  85, 171,  58, 165,  90,  98,  64,
     34,  22, 116, 206,  23,  34,  43, 166,  73,
    107,  54,  32,  26,  51,   1,  81,  43,  31,
     68,  25, 106,  22,  64, 171,  36, 225, 114,
     34,  19,  21, 102, 132, 188,  16,  76, 124,
     62,  18,  78,  95,  85,  57,  50,  48,  51,
    193, 101,  35, 159, 215, 111,  89,  46, 111,
     60, 148,  31, 172, 219, 228,  21,  18, 111,
    112, 113,  77,  85, 179, 255,  38, 120, 114,
     40,  42,   1, 196, 245, 209,  10,  25, 109,
     88,  43,  29, 140, 166, 213,  37,  43, 154,
     61,  63,  30, 155,  67,  45,  68,   1, 209,
    100,  80,   8,  43, 154,   1,  51,  26,  71,
    142,  78,  78,  16, 255, 128,  34, 197, 171,
     41,  40,   5, 102, 211, 183,   4,   1, 221,
     51,  50,  17, 168, 209, 192,  23,  25,  82,
    138,  31,  36, 171,  27, 166,  38,  44, 229,
     67,  87,  58, 169,  82, 115,  26,  59, 179,
     63,  59,  90, 180,  59, 166,  93,  73, 154,
     40,  40,  21, 116, 143, 209,  34,  39, 175,
     47,  15,  16, 183,  34, 223,  49,  45, 183,
     46,  17,  33, 183,   6,  98,  15,  32, 183,
     57,  46,  22,  24, 128,   1,  54,  17,  37,
     65,  32,  73, 115,  28, 128,  23, 128, 205,
     40,   3,   9, 115,  51, 192,  18,   6, 223,
     87,  37,   9, 115,  59,  77,  64,  21,  47,
    104,  55,  44, 218,   9,  54,  53, 130, 226,
     64,  90,  70, 205,  40,  41,  23,  26,  57,
     54,  57, 112, 184,   5,  41,  38, 166, 213,
     30,  34,  26, 133, 152, 116,  10,  32, 134,
     39,  19,  53, 221,  26, 114,  32,  73, 255,
     31,   9,  65, 234,   2,  15,   1, 118,  73,
     75,  32,  12,  51, 192, 255, 160,  43,  51,
     88,  31,  35,  67, 102,  85,  55, 186,  85,
     56,  21,  23, 111,  59, 205,  45,  37, 192,
     55,  38,  70, 124,  73, 102,   1,  34,  98,
    125,  98,  42,  88, 104,  85, 117, 175,  82,
     95,  84,  53,  89, 128, 100, 113, 101,  45,
     75,  79, 123,  47,  51, 128,  81, 171,   1,
     57,  17,   5,  71, 102,  57,  53,  41,  49,
     38,  33,  13, 121,  57,  73,  26,   1,  85,
     41,  10,  67, 138,  77, 110,  90,  47, 114,
    115,  21,   2,  10, 102, 255, 166,  23,   6,
    101,  29,  16,  10,  85, 128, 101, 196,  26,
     57,  18,  10, 102, 102, 213,  34,  20,  43,
    117,  20,  15,  36, 163, 128,  68,   1,  26,
    102,  61,  71,  37,  34,  53,  31, 243, 192,
     69,  60,  71,  38,  73, 119,  28, 222,  37,
     68,  45, 128,  34,   1,  47,  11, 245, 171,
     62,  17,  19,  70, 146,  85,  55,  62,  70,
     37,  43,  37, 154, 100, 163,  85, 160,   1,
     63,   9,  92, 136,  28,  64,  32, 201,  85,
     75,  15,   9,   9,  64, 255, 184, 119,  16,
     86,   6,  28,   5,  64, 255,  25, 248,   1,
     56,   8,  17, 132, 137, 255,  55, 116, 128,
     58,  15,  20,  82, 135,  57,  26, 121,  40,
    164,  50,  31, 137, 154, 133,  25,  35, 218,
     51, 103,  44, 131, 131, 123,  31,   6, 158,
     86,  40,  64, 135, 148, 224,  45, 183, 128,
     22,  26,  17, 131, 240, 154,  14,   1, 209,
     45,  16,  21,  91,  64, 222,   7,   1, 197,
     56,  21,  39, 155,  60, 138,  23, 102, 213,
     83,  12,  13,  54, 192, 255,  68,  47,  28,
     85,  26,  85,  85, 128, 128,  32, 146, 171,
     18,  11,   7,  63, 144, 171,   4,   4, 246,
     35,  27,  10, 146, 174, 171,  12,  26, 128,
    190,  80,  35,  99, 180,  80, 126,  54,  45,
     85, 126,  47,  87, 176,  51,  41,  20,  32,
    101,  75, 128, 139, 118, 146, 116, 128,  85,
     56,  41,  15, 176, 236,  85,  37,   9,  62,
     71,  30,  17, 119, 118, 255,  17,  18, 138,
    101,  38,  60, 138,  55,  70,  43,  26, 142,
    146,  36,  19,  30, 171, 255,  97,  27,  20,
    138,  45,  61,  62, 219,   1,  81, 188,  64,
     32,  41,  20, 117, 151, 142,  20,  21, 163,
    112,  19,  12,  61, 195, 128,  48,   4,  24,
};

const int kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
const uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,  17,  18,  19,  20,  20,  21,  21,
    22,  22,  23,  23,  24,  25,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,
    40,  41,  42,  43,  44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,  59,  60,
    61,  62,  63,  64,  65,  66,  67,  68,  69,  70,  71,  72,  73,  74,  75,  76,  76,  77,  78,  79,  80,  81,
    82,  83,  84,  85,  86,  87,  88,  89,  91,  93,  95,  96,  98,  100, 101, 102, 104, 106, 108, 110, 112, 114,
    116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
const uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,  19,  20,  21,  22,  23,  24,  25,
    26,  27,  28,  29,  30,  31,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,
    48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,  70,  72,  74,  76,  78,  80,
    82,  84,  86,  88,  90,  92,  94,  96,  98,  100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128,
    131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201,
    205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

// libwebp's intra modes: 4x4 modes in this order; the 16x16 and chroma
// modes are DC, TM, VE and HE, and DC's forms without top or left follow.
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED, B_HD_PRED,
       B_HU_PRED, B_DC_PRED_NOTOP = 4, B_DC_PRED_NOLEFT = 5, B_DC_PRED_NOTOPLEFT = 6 };

// VP8's boolean decoder as libwebp's VP8BitReader runs it, one byte at a
// time (the same bits as its wider loads). Past the data it shifts in one
// byte of zeros and sets `eof`, which fails the image.
class BoolReader {
 public:
  void init(const uint8_t* start, size_t size) {
    buf_ = start;
    end_ = start + size;
    value_ = 0;
    bits_ = -8;
    range_ = 255 - 1;
    eof = false;
    load();
  }
  int bit(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    const int bit = value > split;
    if (bit) {
      range -= split;
      value_ -= static_cast<uint64_t>(split + 1) << pos;
    } else {
      range = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(range));
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return bit;
  }
  int signed_value(int v) {  // libwebp's VP8GetSigned: a bit at 1/2 choosing the sign of v
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = range_ >> 1;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    const int32_t mask = static_cast<int32_t>(split - value) >> 31;
    bits_ -= 1;
    range_ += static_cast<uint32_t>(mask);
    range_ |= 1;
    value_ -= static_cast<uint64_t>((split + 1) & static_cast<uint32_t>(mask)) << pos;
    return (v ^ mask) - mask;
  }
  int value(int nbits) {
    int v = 0;
    while (nbits-- > 0) v |= bit(0x80) << nbits;
    return v;
  }
  int signed_value_bits(int nbits) {
    const int v = value(nbits);
    return value(1) ? -v : v;
  }
  bool eof = false;

 private:
  void load() {
    if (buf_ < end_) {
      bits_ += 8;
      value_ = (value_ << 8) | *buf_++;
    } else if (!eof) {
      value_ <<= 8;
      bits_ += 8;
      eof = true;
    } else {
      bits_ = 0;
    }
  }
  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  int bits_ = -8;
  uint32_t range_ = 254;
};

const int BPS = 32;                          // libwebp's work-buffer stride
const int Y_OFF = BPS * 1 + 8;               // luma block, a row of top samples above
const int U_OFF = Y_OFF + BPS * 16 + BPS;    // chroma blocks side by side
const int V_OFF = U_OFF + 16;
const int YUV_SIZE = BPS * 17 + BPS * 9;
const int kScan[16] = {0 + 0 * BPS, 4 + 0 * BPS, 8 + 0 * BPS, 12 + 0 * BPS, 0 + 4 * BPS, 4 + 4 * BPS,
                       8 + 4 * BPS, 12 + 4 * BPS, 0 + 8 * BPS, 4 + 8 * BPS, 8 + 8 * BPS, 12 + 8 * BPS,
                       0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

// --- transforms ---

inline int16_t w16(int v) { return static_cast<int16_t>(v); }
inline int16_t mulhi(int16_t a, int k) { return static_cast<int16_t>((static_cast<int32_t>(a) * k) >> 16); }

// libwebp's Transform_SSE2 for one block: every step in wrapping 16-bit
// lanes (the C form's int arithmetic gives the same within VP8's ranges).
void transform_full(const int16_t* in, uint8_t* dst) {
  const int k1 = 20091, k2 = -30068;
  int16_t t[4][4];  // t[column][row] after the vertical pass
  for (int i = 0; i < 4; ++i) {
    const int16_t in0 = in[i], in1 = in[4 + i], in2 = in[8 + i], in3 = in[12 + i];
    const int16_t a = w16(in0 + in2), b = w16(in0 - in2);
    const int16_t c = w16(w16(in1 - in3) + w16(mulhi(in1, k2) - mulhi(in3, k1)));
    const int16_t d = w16(w16(in1 + in3) + w16(mulhi(in1, k1) + mulhi(in3, k2)));
    t[i][0] = w16(a + d);
    t[i][1] = w16(b + c);
    t[i][2] = w16(b - c);
    t[i][3] = w16(a - d);
  }
  for (int r = 0; r < 4; ++r) {
    const int16_t T0 = t[0][r], T1 = t[1][r], T2 = t[2][r], T3 = t[3][r];
    const int16_t dc = w16(T0 + 4);
    const int16_t a = w16(dc + T2), b = w16(dc - T2);
    const int16_t c = w16(w16(T1 - T3) + w16(mulhi(T1, k2) - mulhi(T3, k1)));
    const int16_t d = w16(w16(T1 + T3) + w16(mulhi(T1, k1) + mulhi(T3, k2)));
    const int16_t o[4] = {w16(a + d), w16(b + c), w16(b - c), w16(a - d)};
    uint8_t* row = dst + r * BPS;
    for (int x = 0; x < 4; ++x) row[x] = clip8(row[x] + (o[x] >> 3));
  }
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_dc(const int16_t* in, uint8_t* dst) {
  const int DC = in[0] + 4;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) dst[x + y * BPS] = clip8(dst[x + y * BPS] + (DC >> 3));
}

void transform_ac3(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]);
  const int c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int dcs[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y) {
    uint8_t* row = dst + y * BPS;
    const int v[4] = {dcs[y] + d1, dcs[y] + c1, dcs[y] - c1, dcs[y] - d1};
    for (int x = 0; x < 4; ++x) row[x] = clip8(row[x] + (v[x] >> 3));
  }
}

void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  switch (bits >> 30) {
    case 3: transform_full(src, dst); break;
    case 2: transform_ac3(src, dst); break;
    case 1: transform_dc(src, dst); break;
    default: break;
  }
}

void do_uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (!(bits & 0xff)) return;
  const int offsets[4] = {0, 4, 4 * BPS, 4 * BPS + 4};
  for (int b = 0; b < 4; ++b) {
    if (bits & 0xaa)
      transform_full(src + 16 * b, dst + offsets[b]);
    else if (src[16 * b])
      transform_dc(src + 16 * b, dst + offsets[b]);
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// --- intra prediction (libwebp dsp/dec.c), on the BPS work buffer ---

#define DST(x, y) dst[(x) + (y) * BPS]

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - tl);
}

void pred4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int X = dst[-1 - BPS], A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
            H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      for (int y = 0; y < 4; ++y) std::memset(dst + y * BPS, dc >> 3, 4);
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {static_cast<uint8_t>(avg3(X, A, B)), static_cast<uint8_t>(avg3(A, B, C)),
                               static_cast<uint8_t>(avg3(B, C, D)), static_cast<uint8_t>(avg3(C, D, E))};
      for (int y = 0; y < 4; ++y) std::memcpy(dst + y * BPS, vals, 4);
      break;
    }
    case B_HE_PRED: {
      std::memset(dst + 0 * BPS, avg3(X, I, J), 4);
      std::memset(dst + 1 * BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    }
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // B_HU_PRED
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
}

#undef DST

// 16x16 luma (size 16) and 8x8 chroma (size 8) predictions
void pred_block(int mode, uint8_t* dst, int size) {
  const int shift = size == 16 ? 5 : 4;
  int dc = 0;
  switch (mode) {
    case B_DC_PRED:
      dc = 1 << (shift - 1);
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      dc >>= shift;
      break;
    case B_TM_PRED: true_motion(dst, size); return;
    case B_VE_PRED:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
      return;
    case B_HE_PRED:
      for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
      return;
    case B_DC_PRED_NOTOP:
      dc = 1 << (shift - 2);
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      dc >>= shift - 1;
      break;
    case B_DC_PRED_NOLEFT:
      dc = 1 << (shift - 2);
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      dc >>= shift - 1;
      break;
    default: dc = 0x80; break;  // no top, no left
  }
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dc, size);
}

int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? B_DC_PRED_NOTOPLEFT : B_DC_PRED_NOLEFT;
    return mb_y == 0 ? B_DC_PRED_NOTOP : B_DC_PRED;
  }
  return mode;
}

// --- loop filter (libwebp dsp/dec.c, RFC 6386 15) ---

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  return std::abs(p[-2 * step] - p[-step]) > thresh || std::abs(p[step] - p[0]) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// `step` crosses the edge, `along` runs along it
void simple_edge(uint8_t* p, int step, int along, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += along)
    if (needs_filter(p, step, t2)) filter2(p, step);
}

void normal_edge(uint8_t* p, int step, int along, int size, int thresh, int ithresh, int hev_t, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += along) {
    if (!needs_filter2(p, step, t2, ithresh)) continue;
    if (hev(p, step, hev_t))
      filter2(p, step);
    else if (mb_edge)
      filter6(p, step);
    else
      filter4(p, step);
  }
}

struct FilterInfo {
  int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MacroBlock {
  int segment = 0, skip = 0, is_i4x4 = 0, uvmode = 0;
  uint8_t imodes[16] = {0};
  int16_t coeffs[384];
  uint32_t non_zero_y = 0, non_zero_uv = 0;
};

class Lossy {
 public:
  void decode(const uint8_t* data, size_t size, const uint8_t* alpha, size_t alpha_size, uint8_t* out,
              int stride) {
    parse_headers(data, size);
    planes();
    filter();
    std::vector<uint8_t> a;
    if (alpha) a = decode_alpha(alpha, alpha_size, width_, height_);
    emit(out, stride, alpha ? a.data() : nullptr);
  }

 private:
  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
  BoolReader br_;
  std::vector<BoolReader> parts_;
  int num_parts_minus_one_ = 0;
  // segment header
  int use_segment_ = 0, update_map_ = 0, absolute_delta_ = 1;
  int quantizer_[4] = {0}, filter_strength_[4] = {0};
  uint8_t segments_[3] = {255, 255, 255};
  // filter header
  int simple_ = 0, level_ = 0, sharpness_ = 0, use_lf_delta_ = 0;
  int ref_lf_delta_[4] = {0}, mode_lf_delta_[4] = {0};
  int filter_type_ = 0;
  // quantizers per segment: y1 dc/ac, y2 dc/ac, uv dc/ac
  int y1_[4][2], y2_[4][2], uv_[4][2];
  uint8_t proba_[4][8][3][11];
  int use_skip_proba_ = 0, skip_p_ = 0;
  FilterInfo fstrengths_[4][2];
  // frame planes, whole macroblocks
  std::vector<uint8_t> Y_, U_, V_;
  std::vector<FilterInfo> finfo_;
  int y_stride_ = 0, uv_stride_ = 0;

  void parse_headers(const uint8_t* buf, size_t size) {
    if (size < 10) fail("VP8 frame header cut short");
    const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
    const int key_frame = !(bits & 1), profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
    const uint32_t partition_length = bits >> 5;
    if (!key_frame) fail("a VP8 frame that is not a key frame");
    if (profile > 3) fail("VP8 profile " + std::to_string(profile));
    if (!show) fail("a VP8 frame that is not shown");
    if (buf[3] != 0x9d || buf[4] != 0x01 || buf[5] != 0x2a) fail("no VP8 start code");
    width_ = ((buf[7] << 8) | buf[6]) & 0x3fff;
    height_ = ((buf[9] << 8) | buf[8]) & 0x3fff;
    if (width_ == 0 || height_ == 0) fail("a VP8 frame of zero size");
    mb_w_ = (width_ + 15) >> 4;
    mb_h_ = (height_ + 15) >> 4;
    buf += 10;
    size -= 10;
    if (partition_length > size) fail("VP8 first partition longer than the data");
    br_.init(buf, partition_length);
    buf += partition_length;
    size -= partition_length;
    br_.value(1);  // colour space
    br_.value(1);  // clamping type: libwebp always clamps
    // segment header
    use_segment_ = br_.value(1);
    if (use_segment_) {
      update_map_ = br_.value(1);
      if (br_.value(1)) {  // update data
        absolute_delta_ = br_.value(1);
        for (int s = 0; s < 4; ++s) quantizer_[s] = br_.value(1) ? br_.signed_value_bits(7) : 0;
        for (int s = 0; s < 4; ++s) filter_strength_[s] = br_.value(1) ? br_.signed_value_bits(6) : 0;
      }
      if (update_map_)
        for (int s = 0; s < 3; ++s) segments_[s] = static_cast<uint8_t>(br_.value(1) ? br_.value(8) : 255);
    } else {
      update_map_ = 0;
    }
    if (br_.eof) fail("VP8 segment header cut short");
    // filter header
    simple_ = br_.value(1);
    level_ = br_.value(6);
    sharpness_ = br_.value(3);
    use_lf_delta_ = br_.value(1);
    if (use_lf_delta_ && br_.value(1)) {
      for (int i = 0; i < 4; ++i)
        if (br_.value(1)) ref_lf_delta_[i] = br_.signed_value_bits(6);
      for (int i = 0; i < 4; ++i)
        if (br_.value(1)) mode_lf_delta_[i] = br_.signed_value_bits(6);
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
    if (br_.eof) fail("VP8 filter header cut short");
    // token partitions
    num_parts_minus_one_ = (1 << br_.value(2)) - 1;
    const size_t last = num_parts_minus_one_;
    if (size < 3 * last) fail("VP8 partition sizes cut short");
    parts_.assign(last + 1, BoolReader());
    const uint8_t* sz = buf;
    const uint8_t* start = buf + 3 * last;
    size_t left = size - 3 * last;
    for (size_t p = 0; p < last; ++p, sz += 3) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      parts_[p].init(start, psize);
      start += psize;
      left -= psize;
    }
    parts_[last].init(start, left);
    if (start >= buf + size) fail("VP8 token partitions cut short");
    // quantizers
    const int base_q0 = br_.value(7);
    const int dqy1_dc = br_.value(1) ? br_.signed_value_bits(4) : 0;
    const int dqy2_dc = br_.value(1) ? br_.signed_value_bits(4) : 0;
    const int dqy2_ac = br_.value(1) ? br_.signed_value_bits(4) : 0;
    const int dquv_dc = br_.value(1) ? br_.signed_value_bits(4) : 0;
    const int dquv_ac = br_.value(1) ? br_.signed_value_bits(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int s = 0; s < 4; ++s) {
      int q;
      if (use_segment_) {
        q = quantizer_[s];
        if (!absolute_delta_) q += base_q0;
      } else if (s > 0) {
        std::copy(y1_[0], y1_[0] + 2, y1_[s]);
        std::copy(y2_[0], y2_[0] + 2, y2_[s]);
        std::copy(uv_[0], uv_[0] + 2, uv_[s]);
        continue;
      } else {
        q = base_q0;
      }
      y1_[s][0] = kDcTable[clip(q + dqy1_dc, 127)];
      y1_[s][1] = kAcTable[clip(q, 127)];
      y2_[s][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      y2_[s][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (y2_[s][1] < 8) y2_[s][1] = 8;
      uv_[s][0] = kDcTable[clip(q + dquv_dc, 117)];
      uv_[s][1] = kAcTable[clip(q + dquv_ac, 127)];
    }
    br_.value(1);  // refresh entropy probabilities: ignored on a key frame
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba_[t][b][c][p] = static_cast<uint8_t>(
                br_.bit(kCoeffsUpdateProba[t][b][c][p]) ? br_.value(8) : kCoeffsProba0[t][b][c][p]);
    use_skip_proba_ = br_.value(1);
    if (use_skip_proba_) skip_p_ = br_.value(8);
    precompute_filter_strengths();
  }

  void precompute_filter_strengths() {
    if (filter_type_ == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base_level = level_;
      if (use_segment_) {
        base_level = filter_strength_[s];
        if (!absolute_delta_) base_level += level_;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& info = fstrengths_[s][i4x4];
        int level = base_level;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * level + ilevel;
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }

  void parse_intra_mode(MacroBlock& mb, uint8_t* top, uint8_t* left) {
    if (update_map_)
      mb.segment = !br_.bit(segments_[0]) ? br_.bit(segments_[1]) : br_.bit(segments_[2]) + 2;
    else
      mb.segment = 0;
    if (use_skip_proba_) mb.skip = br_.bit(skip_p_);
    mb.is_i4x4 = !br_.bit(145);
    if (!mb.is_i4x4) {
      const int ymode = br_.bit(156) ? (br_.bit(128) ? B_TM_PRED : B_HE_PRED) : (br_.bit(163) ? B_VE_PRED : B_DC_PRED);
      mb.imodes[0] = static_cast<uint8_t>(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = mb.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          ymode = !br_.bit(prob[0])   ? B_DC_PRED
                  : !br_.bit(prob[1]) ? B_TM_PRED
                  : !br_.bit(prob[2]) ? B_VE_PRED
                  : !br_.bit(prob[3]) ? (!br_.bit(prob[4]) ? B_HE_PRED : (!br_.bit(prob[5]) ? B_RD_PRED : B_VR_PRED))
                                      : (!br_.bit(prob[6]) ? B_LD_PRED
                                                           : (!br_.bit(prob[7]) ? B_VL_PRED
                                                                                : (!br_.bit(prob[8]) ? B_HD_PRED
                                                                                                     : B_HU_PRED)));
          top[x] = static_cast<uint8_t>(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = static_cast<uint8_t>(ymode);
      }
    }
    mb.uvmode = !br_.bit(142) ? B_DC_PRED : !br_.bit(114) ? B_VE_PRED : br_.bit(183) ? B_TM_PRED : B_HE_PRED;
  }

  static int large_value(BoolReader& br, const uint8_t* p) {
    int v;
    if (!br.bit(p[3])) {
      v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
    } else if (!br.bit(p[6])) {
      if (!br.bit(p[7])) {
        v = 5 + br.bit(159);
      } else {
        v = 7 + 2 * br.bit(165);
        v += br.bit(145);
      }
    } else {
      const int bit1 = br.bit(p[8]);
      const int bit0 = br.bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // Tokens of one block from position n; returns the position after the
  // last non-zero one (libwebp's GetCoeffs). Products land in int16.
  int coeffs(BoolReader& br, int type, int ctx, const int dq[2], int n, int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.bit(p[0])) return n;
      while (!br.bit(p[1])) {
        p = proba_[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      const uint8_t(*p_ctx)[11] = proba_[type][kBands[n + 1]];
      int v;
      if (!br.bit(p[2])) {
        v = 1;
        p = p_ctx[1];
      } else {
        v = large_value(br, p);
        p = p_ctx[2];
      }
      out[kZigzag[n]] = static_cast<int16_t>(br.signed_value(v) * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= nz > 3 ? 3 : nz > 1 ? 2 : dc_nz;
    return nz_coeffs;
  }

  // libwebp's ParseResiduals; returns whether every coefficient is zero
  int residuals(MacroBlock& block, uint8_t& mb_nz, uint8_t& mb_nz_dc, uint8_t& left_nz, uint8_t& left_nz_dc,
                BoolReader& br) {
    const int seg = block.segment;
    int16_t* dst = block.coeffs;
    std::memset(dst, 0, sizeof(block.coeffs));
    int first, ac_type;
    if (!block.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = mb_nz_dc + left_nz_dc;
      const int nz = coeffs(br, 1, ctx, y2_[seg], 0, dc);
      mb_nz_dc = left_nz_dc = nz > 0;
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = static_cast<int16_t>(dc0);
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint32_t tnz = mb_nz & 0x0f, lnz = left_nz & 0x0f, non_zero_y = 0, non_zero_uv = 0;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = coeffs(br, ac_type, ctx, y1_[seg], first, dst);
        l = nz > first;
        tnz = (tnz >> 1) | (l << 7);
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | (l << 7);
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = mb_nz >> (4 + ch);
      lnz = left_nz >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = coeffs(br, 2, ctx, uv_[seg], 0, dst);
          l = nz > 0;
          tnz = (tnz >> 1) | (l << 3);
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | (l << 5);
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= (tnz << 4) << ch;
      out_l_nz |= (lnz & 0xf0) << ch;
    }
    mb_nz = static_cast<uint8_t>(out_t_nz);
    left_nz = static_cast<uint8_t>(out_l_nz);
    block.non_zero_y = non_zero_y;
    block.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  void planes() {
    y_stride_ = mb_w_ * 16;
    uv_stride_ = mb_w_ * 8;
    Y_.assign(static_cast<size_t>(y_stride_) * mb_h_ * 16, 0);
    U_.assign(static_cast<size_t>(uv_stride_) * mb_h_ * 8, 0);
    V_.assign(U_.size(), 0);
    finfo_.assign(static_cast<size_t>(mb_w_) * mb_h_, FilterInfo());
    std::vector<uint8_t> intra_t(4 * mb_w_, B_DC_PRED);
    uint8_t intra_l[4];
    std::vector<uint8_t> nz(mb_w_, 0), nz_dc(mb_w_, 0);
    std::vector<MacroBlock> row(mb_w_);
    std::vector<uint8_t> top_y(16 * mb_w_), top_u(8 * mb_w_), top_v(8 * mb_w_);
    std::vector<uint8_t> yuv(YUV_SIZE, 0);
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      std::memset(intra_l, B_DC_PRED, 4);
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) parse_intra_mode(row[mb_x], &intra_t[4 * mb_x], intra_l);
      if (br_.eof) fail("VP8 first partition ends early");
      BoolReader& tokens = parts_[mb_y & num_parts_minus_one_];
      uint8_t left_nz = 0, left_nz_dc = 0;
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        MacroBlock& block = row[mb_x];
        int skip = use_skip_proba_ ? block.skip : 0;
        if (!skip) {
          skip = residuals(block, nz[mb_x], nz_dc[mb_x], left_nz, left_nz_dc, tokens);
        } else {
          left_nz = nz[mb_x] = 0;
          if (!block.is_i4x4) left_nz_dc = nz_dc[mb_x] = 0;
          block.non_zero_y = block.non_zero_uv = 0;
        }
        if (filter_type_ > 0) {
          FilterInfo& f = finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x];
          f = fstrengths_[block.segment][block.is_i4x4];
          f.inner |= !skip;
        }
        if (tokens.eof) fail("VP8 token partition ends early");
      }
      reconstruct_row(mb_y, row, yuv.data(), top_y, top_u, top_v);
    }
  }

  // libwebp's ReconstructRow: predictions from the unfiltered neighbours in
  // the BPS work buffer, then the residuals; the row goes to the planes.
  void reconstruct_row(int mb_y, const std::vector<MacroBlock>& row, uint8_t* yuv, std::vector<uint8_t>& top_y,
                       std::vector<uint8_t>& top_u, std::vector<uint8_t>& top_v) {
    uint8_t* const y_dst = yuv + Y_OFF;
    uint8_t* const u_dst = yuv + U_OFF;
    uint8_t* const v_dst = yuv + V_OFF;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      const MacroBlock& block = row[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, &top_y[16 * mb_x], 16);
        std::memcpy(u_dst - BPS, &top_u[8 * mb_x], 8);
        std::memcpy(v_dst - BPS, &top_v[8 * mb_x], 8);
      }
      const int16_t* coeffs = block.coeffs;
      uint32_t bits = block.non_zero_y;
      if (block.is_i4x4) {
        uint8_t* const top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w_ - 1)
            std::memset(top_right, top_y[16 * mb_x + 15], 4);
          else
            std::memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
        }
        for (int r = 1; r <= 3; ++r) std::memcpy(top_right + 4 * r * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* const dst = y_dst + kScan[n];
          pred4(block.imodes[n], dst);
          do_transform(bits, coeffs + n * 16, dst);
        }
      } else {
        pred_block(check_mode(mb_x, mb_y, block.imodes[0]), y_dst, 16);
        if (bits != 0)
          for (int n = 0; n < 16; ++n, bits <<= 2) do_transform(bits, coeffs + n * 16, y_dst + kScan[n]);
      }
      const int uv_mode = check_mode(mb_x, mb_y, block.uvmode);
      pred_block(uv_mode, u_dst, 8);
      pred_block(uv_mode, v_dst, 8);
      do_uv_transform(block.non_zero_uv >> 0, coeffs + 16 * 16, u_dst);
      do_uv_transform(block.non_zero_uv >> 8, coeffs + 20 * 16, v_dst);
      if (mb_y < mb_h_ - 1) {
        std::memcpy(&top_y[16 * mb_x], y_dst + 15 * BPS, 16);
        std::memcpy(&top_u[8 * mb_x], u_dst + 7 * BPS, 8);
        std::memcpy(&top_v[8 * mb_x], v_dst + 7 * BPS, 8);
      }
      uint8_t* y_out = &Y_[static_cast<size_t>(mb_y) * 16 * y_stride_ + mb_x * 16];
      uint8_t* u_out = &U_[static_cast<size_t>(mb_y) * 8 * uv_stride_ + mb_x * 8];
      uint8_t* v_out = &V_[static_cast<size_t>(mb_y) * 8 * uv_stride_ + mb_x * 8];
      for (int j = 0; j < 16; ++j) std::memcpy(y_out + j * y_stride_, y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(u_out + j * uv_stride_, u_dst + j * BPS, 8);
        std::memcpy(v_out + j * uv_stride_, v_dst + j * BPS, 8);
      }
    }
  }

  // libwebp's DoFilter over the macroblocks in raster order: each row after
  // the rows above it, the left edge, the inner vertical edges, the top
  // edge, the inner horizontal edges.
  void filter() {
    if (filter_type_ == 0) return;
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        const FilterInfo& f = finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x];
        const int limit = f.limit;
        if (limit == 0) continue;
        const int ys = y_stride_, uvs = uv_stride_;
        uint8_t* y = &Y_[static_cast<size_t>(mb_y) * 16 * ys + mb_x * 16];
        if (filter_type_ == 1) {
          if (mb_x > 0) simple_edge(y, 1, ys, limit + 4);
          if (f.inner)
            for (int k = 4; k < 16; k += 4) simple_edge(y + k, 1, ys, limit);
          if (mb_y > 0) simple_edge(y, ys, 1, limit + 4);
          if (f.inner)
            for (int k = 4; k < 16; k += 4) simple_edge(y + k * ys, ys, 1, limit);
        } else {
          uint8_t* u = &U_[static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8];
          uint8_t* v = &V_[static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8];
          const int il = f.ilevel, hv = f.hev_thresh;
          if (mb_x > 0) {
            normal_edge(y, 1, ys, 16, limit + 4, il, hv, true);
            normal_edge(u, 1, uvs, 8, limit + 4, il, hv, true);
            normal_edge(v, 1, uvs, 8, limit + 4, il, hv, true);
          }
          if (f.inner) {
            for (int k = 4; k < 16; k += 4) normal_edge(y + k, 1, ys, 16, limit, il, hv, false);
            normal_edge(u + 4, 1, uvs, 8, limit, il, hv, false);
            normal_edge(v + 4, 1, uvs, 8, limit, il, hv, false);
          }
          if (mb_y > 0) {
            normal_edge(y, ys, 1, 16, limit + 4, il, hv, true);
            normal_edge(u, uvs, 1, 8, limit + 4, il, hv, true);
            normal_edge(v, uvs, 1, 8, limit + 4, il, hv, true);
          }
          if (f.inner) {
            for (int k = 4; k < 16; k += 4) normal_edge(y + k * ys, ys, 1, 16, limit, il, hv, false);
            normal_edge(u + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
            normal_edge(v + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
          }
        }
      }
    }
  }

  static inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
  static inline uint8_t yuv_clip(int v) { return static_cast<uint8_t>((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255); }

  static void yuv_to_rgba(int y, int u, int v, uint8_t* rgba) {
    rgba[0] = yuv_clip(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    rgba[1] = yuv_clip(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    rgba[2] = yuv_clip(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
    rgba[3] = 0xff;
  }

  // libwebp's UPSAMPLE_FUNC for one pair of rows (bottom_y may be null).
  static void upsample(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u, const uint8_t* top_v,
                       const uint8_t* cur_u, const uint8_t* cur_v, uint8_t* top_dst, uint8_t* bottom_dst,
                       int len) {
    const int last_pair = (len - 1) >> 1;
    int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
    yuv_to_rgba(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
    if (bottom_y) yuv_to_rgba(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
    for (int x = 1; x <= last_pair; ++x) {
      const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
      const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
      const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
      const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
      yuv_to_rgba(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, top_dst + 4 * (2 * x - 1));
      yuv_to_rgba(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 4 * (2 * x));
      if (bottom_y) {
        yuv_to_rgba(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1, bottom_dst + 4 * (2 * x - 1));
        yuv_to_rgba(bottom_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1, bottom_dst + 4 * (2 * x));
      }
      tl_u = t_u;
      tl_v = t_v;
      l_u = u;
      l_v = v;
    }
    if (!(len & 1)) {
      yuv_to_rgba(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst + 4 * (len - 1));
      if (bottom_y)
        yuv_to_rgba(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                    bottom_dst + 4 * (len - 1));
    }
  }

  // EmitFancyRGB over the whole frame: row 0 on its own, then the pairs
  // (2k - 1, 2k) between chroma rows k - 1 and k, then the last row of an
  // even height on its own; the alpha plane into A.
  void emit(uint8_t* out, int stride, const uint8_t* alpha) {
    const uint8_t* y = Y_.data();
    const uint8_t* u = U_.data();
    const uint8_t* v = V_.data();
    const int ys = y_stride_, uvs = uv_stride_;
    upsample(y, nullptr, u, v, u, v, out, nullptr, width_);
    int row = 0;
    for (; row + 2 < height_; row += 2) {
      const int k = row / 2 + 1;
      upsample(y + (row + 1) * ys, y + (row + 2) * ys, u + (k - 1) * uvs, v + (k - 1) * uvs, u + k * uvs,
               v + k * uvs, out + static_cast<size_t>(row + 1) * stride, out + static_cast<size_t>(row + 2) * stride,
               width_);
    }
    if (!(height_ & 1)) {
      const int k = (height_ - 1) / 2;
      upsample(y + (height_ - 1) * ys, nullptr, u + k * uvs, v + k * uvs, u + k * uvs, v + k * uvs,
               out + static_cast<size_t>(height_ - 1) * stride, nullptr, width_);
    }
    if (alpha)
      for (int r = 0; r < height_; ++r)
        for (int x = 0; x < width_; ++x) out[static_cast<size_t>(r) * stride + 4 * x + 3] = alpha[r * width_ + x];
  }
};

}  // namespace

extern "C" {

const char* gs_webp_error() { return g_error.c_str(); }

int gs_webp_info(const uint8_t* data, long long n, long long declared, int lossless, int* out) {
  if (lossless) {
    if (n < 5 || data[0] != 0x2f || (data[4] >> 5) != 0) {
      g_error = "not a VP8L bitstream of version 0";
      return 1;
    }
    const uint32_t bits = data[1] | (data[2] << 8) | (data[3] << 16) | (static_cast<uint32_t>(data[4]) << 24);
    out[0] = (bits & 0x3fff) + 1;
    out[1] = ((bits >> 14) & 0x3fff) + 1;
    out[2] = (bits >> 28) & 1;
    return 0;
  }
  if (n < 10 || data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) {
    g_error = "not a VP8 key frame (no start code)";
    return 1;
  }
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const int w = ((data[7] << 8) | data[6]) & 0x3fff, h = ((data[9] << 8) | data[8]) & 0x3fff;
  if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= static_cast<uint64_t>(declared) ||
      w == 0 || h == 0) {
    g_error = "a VP8 frame header libwebp refuses (not a shown key frame of profile 0-3, a first partition "
              "past the chunk, or a zero size)";
    return 1;
  }
  out[0] = w;
  out[1] = h;
  out[2] = 0;
  return 0;
}

int gs_webp_decode(const uint8_t* data, long long n, int lossless, const uint8_t* alpha, long long alpha_n,
                   uint8_t* out, int stride) {
  try {
    if (lossless) {
      int w = 0, h = 0;
      const std::vector<uint32_t> argb = decode_lossless(data, static_cast<size_t>(n), w, h);
      for (int y = 0; y < h; ++y) {
        uint8_t* row = out + static_cast<size_t>(y) * stride;
        for (int x = 0; x < w; ++x) {
          const uint32_t p = argb[static_cast<size_t>(y) * w + x];
          row[4 * x + 0] = (p >> 16) & 0xff;
          row[4 * x + 1] = (p >> 8) & 0xff;
          row[4 * x + 2] = p & 0xff;
          row[4 * x + 3] = p >> 24;
        }
      }
    } else {
      Lossy dec;
      dec.decode(data, static_cast<size_t>(n), alpha, static_cast<size_t>(alpha_n), out, stride);
    }
  } catch (const Failure& f) {
    g_error = f.msg;
    return 1;
  } catch (const std::bad_alloc&) {
    g_error = "out of memory";
    return 1;
  }
  return 0;
}

}  // extern "C"
