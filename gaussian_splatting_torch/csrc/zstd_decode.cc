// Zstandard decoding for the TIFF reader: host C++, built with the host
// compiler by utils/cuda_build.py at first use and loaded with ctypes.
//
// A ZSTD-compressed TIFF strip (compression 50000) is read as libtiff's
// ZSTDDecode reads it for PIL: ZSTD_decompressStream is called until the
// strip is full, the input is spent or a frame ends (libzstd returns 0 at
// a frame's end, and the loop stops there), and a strip left short is an
// error. Frames follow RFC 8878: the header (window descriptor, a
// dictionary ID, which is refused as libtiff loads none, the single-segment
// flag, the content size), skippable frames, raw / RLE / compressed
// blocks, literals raw, RLE or Huffman-coded in 1 or 4 streams (tables
// given, their weights direct or FSE-coded, or repeated), sequences with
// predefined, RLE, FSE-coded or repeated tables, the repeat offsets, and the
// XXH64 content checksum.
//
// Corrupt data is decoded as libzstd 1.5.7 decodes it, with its checks in
// its order, so that the pixels PIL reads from a damaged file, or its
// error, come out the same: the bit reader is zstd's BIT_DStream (its
// reload states, the overflow it reports, the bits it hands out past the
// end), FSE_readNCount and the FSE weight decoder's tail are copied, the
// Huffman literals take libzstd's paths (one stream: the X1 decoder, which
// checks that the stream ends exactly; four streams: HUF_selectDecoder's
// choice of X1 or X2, and for 11-bit tables with every stream at least 8
// bytes the fast loops, which check no stream end and read on into the
// bytes below a stream), and a frame decodes in one pass when its content
// size is known, fits the strip and the frame lies whole in the strip, else
// block by block through the streaming buffer (a block's output then at
// most the block maximum; after the strip is full, one more block is
// decoded, as ZSTD_decompressStream decodes the next block before it finds
// no room to flush it).
//
// Interface (plain C; returns 0 or 1, whose message gs_zstd_error gives
// for the calling thread):
//   gs_zstd_decode_tiff(data, size, out, out_size)   one strip or tile

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }
[[noreturn]] void corrupt(const char* what) { fail(std::string("corrupt ZSTD data: ") + what); }

inline uint32_t rd16(const uint8_t* p) { return uint32_t(p[0]) | uint32_t(p[1]) << 8; }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | uint32_t(p[2]) << 16; }
inline uint32_t rd32(const uint8_t* p) { return rd16(p) | rd16(p + 2) << 16; }
inline uint64_t rd64(const uint8_t* p) { return uint64_t(rd32(p)) | uint64_t(rd32(p + 4)) << 32; }
inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }
inline int ctz64(uint64_t v) { return v ? __builtin_ctzll(v) : 64; }

// ---- zstd's BIT_DStream (bitstream.h, 64-bit container) ----

enum BitStatus { kUnfinished = 0, kEndOfBuffer = 1, kCompleted = 2, kOverflow = 3 };

struct BitD {
  uint64_t container = 0;
  unsigned consumed = 0;
  const uint8_t* ptr = nullptr;
  const uint8_t* start = nullptr;
  const uint8_t* limit = nullptr;
  bool zero_filled = false;  // ptr moved to zstd's static zero word after an overflow

  // BIT_initDStream; false where libzstd returns an error
  bool init(const uint8_t* src, size_t size) {
    if (size < 1) return false;
    start = src;
    limit = src + 8;
    zero_filled = false;
    uint8_t last = src[size - 1];
    if (size >= 8) {
      ptr = src + size - 8;
      container = rd64(ptr);
      consumed = last ? 8 - highbit32(last) : 0;
      return last != 0;
    }
    ptr = src;
    container = src[0];
    for (size_t i = size - 1; i >= 1; --i) container += uint64_t(src[i]) << (8 * i);
    consumed = last ? 8 - highbit32(last) : 0;
    if (!last) return false;
    consumed += unsigned(8 - size) * 8;
    return true;
  }
  uint64_t look(unsigned nb) const {
    return (container >> ((64u - consumed - nb) & 63u)) & ((uint64_t(1) << nb) - 1);
  }
  uint64_t look_fast(unsigned nb) const { return (container << (consumed & 63u)) >> ((64u - nb) & 63u); }
  void skip(unsigned nb) { consumed += nb; }
  uint64_t read(unsigned nb) {
    uint64_t v = look(nb);
    skip(nb);
    return v;
  }
  uint64_t read_fast(unsigned nb) {
    uint64_t v = look_fast(nb);
    skip(nb);
    return v;
  }
  BitStatus reload_internal() {
    ptr -= consumed >> 3;
    consumed &= 7;
    container = rd64(ptr);
    return kUnfinished;
  }
  BitStatus reload_fast() {
    if (zero_filled || ptr < limit) return kOverflow;
    return reload_internal();
  }
  BitStatus reload() {
    if (consumed > 64) {
      zero_filled = true;
      return kOverflow;
    }
    if (ptr >= limit) return reload_internal();
    if (ptr == start) return consumed < 64 ? kEndOfBuffer : kCompleted;
    unsigned bytes = consumed >> 3;
    BitStatus result = kUnfinished;
    if (ptr - bytes < start) {
      bytes = unsigned(ptr - start);
      result = kEndOfBuffer;
    }
    ptr -= bytes;
    consumed -= bytes * 8;
    container = rd64(ptr);
    return result;
  }
  bool at_end() const { return !zero_filled && ptr == start && consumed == 64; }
};

// ---- FSE (entropy_common.c, fse_decompress.c) ----

// FSE_readNCount: the normalized counts; returns the header's bytes
size_t read_ncount(int16_t* norm, unsigned* max_sv, unsigned* table_log, const uint8_t* src, size_t size) {
  if (size < 8) {
    uint8_t buffer[8] = {0};
    std::memcpy(buffer, src, size);
    size_t n = read_ncount(norm, max_sv, table_log, buffer, 8);
    if (n > size) corrupt("an FSE table header past its section");
    return n;
  }
  const uint8_t* ip = src;
  const uint8_t* iend = src + size;
  unsigned max_sv1 = *max_sv + 1, charnum = 0;
  std::fill(norm, norm + max_sv1, 0);
  uint32_t bits = rd32(ip);
  int nb = int(bits & 0xF) + 5;
  if (nb > 15) corrupt("an FSE table log over 15");
  bits >>= 4;
  int bit_count = 4;
  *table_log = unsigned(nb);
  int remaining = (1 << nb) + 1, threshold = 1 << nb;
  nb++;
  bool previous0 = false;
  for (;;) {
    if (previous0) {
      int repeats = __builtin_ctz(~bits | 0x80000000u) >> 1;
      while (repeats >= 12) {
        charnum += 3 * 12;
        if (ip <= iend - 7) {
          ip += 3;
        } else {
          bit_count -= int(8 * (iend - 7 - ip));
          bit_count &= 31;
          ip = iend - 4;
        }
        bits = rd32(ip) >> bit_count;
        repeats = __builtin_ctz(~bits | 0x80000000u) >> 1;
      }
      charnum += 3 * repeats;
      bits >>= 2 * repeats;
      bit_count += 2 * repeats;
      charnum += bits & 3;
      bit_count += 2;
      if (charnum >= max_sv1) break;
      if (ip <= iend - 7 || ip + (bit_count >> 3) <= iend - 4) {
        ip += bit_count >> 3;
        bit_count &= 7;
      } else {
        bit_count -= int(8 * (iend - 4 - ip));
        bit_count &= 31;
        ip = iend - 4;
      }
      bits = rd32(ip) >> bit_count;
    }
    {
      int max = (2 * threshold - 1) - remaining;
      int count;
      if (int(bits & uint32_t(threshold - 1)) < max) {
        count = int(bits & uint32_t(threshold - 1));
        bit_count += nb - 1;
      } else {
        count = int(bits & uint32_t(2 * threshold - 1));
        if (count >= threshold) count -= max;
        bit_count += nb;
      }
      count--;
      if (count >= 0) {
        remaining -= count;
      } else {
        remaining += count;
      }
      norm[charnum++] = int16_t(count);
      previous0 = count == 0;
      if (remaining < threshold) {
        if (remaining <= 1) break;
        nb = highbit32(uint32_t(remaining)) + 1;
        threshold = 1 << (nb - 1);
      }
      if (charnum >= max_sv1) break;
      if (ip <= iend - 7 || ip + (bit_count >> 3) <= iend - 4) {
        ip += bit_count >> 3;
        bit_count &= 7;
      } else {
        bit_count -= int(8 * (iend - 4 - ip));
        bit_count &= 31;
        ip = iend - 4;
      }
      bits = rd32(ip) >> bit_count;
    }
  }
  if (remaining != 1) corrupt("FSE counts that do not fill their table");
  if (charnum > max_sv1) corrupt("an FSE table of too many symbols");
  if (bit_count > 32) corrupt("an FSE table header read past its end");
  *max_sv = charnum - 1;
  ip += (bit_count + 7) >> 3;
  return size_t(ip - src);
}

// the spread of FSE_buildDTable / ZSTD_buildFSETable: each cell's symbol,
// and the cells' next-state counters
struct FseCell {
  uint16_t symbol;
  uint8_t nb_bits;
  uint16_t new_state;
};

std::vector<FseCell> build_fse(const int16_t* norm, unsigned max_sv, unsigned table_log) {
  const uint32_t size = 1u << table_log;
  std::vector<FseCell> t(size);
  std::vector<uint32_t> next(max_sv + 1);
  uint32_t high = size - 1;
  for (unsigned s = 0; s <= max_sv; ++s) {
    if (norm[s] == -1) {
      t[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  const uint32_t mask = size - 1, step = (size >> 1) + (size >> 3) + 3;
  uint32_t pos = 0;
  for (unsigned s = 0; s <= max_sv; ++s)
    for (int i = 0; i < norm[s]; ++i) {
      t[pos].symbol = uint16_t(s);
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  if (pos != 0) corrupt("FSE counts that do not spread over their table");
  for (uint32_t u = 0; u < size; ++u) {
    uint32_t state = next[t[u].symbol]++;
    t[u].nb_bits = uint8_t(table_log - highbit32(state));
    t[u].new_state = uint16_t((state << t[u].nb_bits) - size);
  }
  return t;
}

struct FseState {
  const FseCell* table;
  uint32_t state;
  void init(BitD& b, unsigned log, const FseCell* t) {
    table = t;
    state = uint32_t(b.read(log));
    b.reload();
  }
  uint8_t decode(BitD& b) {
    const FseCell& c = table[state];
    state = c.new_state + uint32_t(b.read(c.nb_bits));
    return uint8_t(c.symbol);
  }
};

// FSE_decompress_wksp (max log 6, 255 symbols of room): the Huffman weights
size_t fse_weights(uint8_t* dst, const uint8_t* src, size_t size) {
  int16_t norm[256];
  unsigned max_sv = 255, log = 0;
  size_t header = read_ncount(norm, &max_sv, &log, src, size);
  if (log > 6) corrupt("an FSE table log over 6 for Huffman weights");
  // HUF_READ_STATS_WORKSPACE_SIZE, FSE_DECOMPRESS_WKSP_SIZE(6, 11) bytes,
  // against what this table and its symbols need
  const size_t need = 4 * (1 + (size_t(1) << log) + 1 + (2 * (max_sv + 1) + (size_t(1) << log) + 8 + 3) / 4 + 128 + 1);
  if (need > 4 * (65 + 1 + 24 + 128 + 1)) corrupt("an FSE table of Huffman weights over libzstd's workspace");
  std::vector<FseCell> t = build_fse(norm, max_sv, log);
  BitD b;
  if (!b.init(src + header, size - header)) corrupt("a Huffman weight stream without its end mark");
  FseState s1, s2;
  s1.init(b, log, t.data());
  s2.init(b, log, t.data());
  if (b.reload() == kOverflow) corrupt("a Huffman weight stream cut short");
  uint8_t* op = dst;
  uint8_t* const omax = dst + 255;
  uint8_t* const olimit = omax - 3;
  while ((b.reload() == kUnfinished) & (op < olimit)) {
    op[0] = s1.decode(b);
    op[1] = s2.decode(b);
    op[2] = s1.decode(b);
    op[3] = s2.decode(b);
    op += 4;
  }
  for (;;) {
    if (op > omax - 2) corrupt("too many Huffman weights");
    *op++ = s1.decode(b);
    if (b.reload() == kOverflow) {
      *op++ = s2.decode(b);
      break;
    }
    if (op > omax - 2) corrupt("too many Huffman weights");
    *op++ = s2.decode(b);
    if (b.reload() == kOverflow) {
      *op++ = s1.decode(b);
      break;
    }
  }
  return size_t(op - dst);
}

// ---- Huffman (huf_decompress.c) ----

struct Huff {
  bool defined = false;
  bool x2 = false;  // the table type libzstd built (HUF_selectDecoder), which a repeat reuses
  int log = 0;      // the decoding table's log: max(code table log, 11)
  std::vector<uint8_t> sym, bits;  // per index of `log` bits
  // X2's pair entries: the second symbol and the pair's bits, 0 for none
  std::vector<uint8_t> sym2, bits2;
};

// HUF_readStats + the table (X1's, which X2's derives from): returns the
// bytes of the tree description
size_t read_huffman(Huff& h, const uint8_t* src, size_t size) {
  if (size == 0) corrupt("an empty Huffman tree description");
  uint8_t w[256] = {0};
  size_t header = src[0], consumed, n;
  if (header >= 128) {
    n = header - 127;
    consumed = (n + 1) / 2;
    if (consumed + 1 > size) corrupt("a Huffman tree description past its section");
    if (n >= 256) corrupt("too many Huffman weights");
    for (size_t i = 0; i < n; i += 2) {
      w[i] = src[1 + i / 2] >> 4;
      w[i + 1] = src[1 + i / 2] & 15;
    }
  } else {
    consumed = header;
    if (consumed + 1 > size) corrupt("a Huffman tree description past its section");
    n = fse_weights(w, src + 1, consumed);
  }
  uint32_t rank[13] = {0}, total = 0;
  for (size_t i = 0; i < n; ++i) {
    if (w[i] > 12) corrupt("a Huffman weight over 12");
    rank[w[i]]++;
    total += (1u << w[i]) >> 1;
  }
  if (total == 0) corrupt("Huffman weights all zero");
  int log = highbit32(total) + 1;
  if (log > 12) corrupt("a Huffman table log over 12");
  uint32_t rest = (1u << log) - total;
  if ((1u << highbit32(rest)) != rest) corrupt("Huffman weights that do not sum to a power of 2");
  w[n] = uint8_t(highbit32(rest) + 1);
  rank[w[n]]++;
  if (rank[1] < 2 || (rank[1] & 1)) corrupt("an odd count of the longest Huffman codes");
  const size_t symbols = n + 1;
  // the canonical code: weight by weight (longest codes first), symbols in order
  h.log = std::max(log, 11);
  const int shift = h.log - log;
  h.sym.assign(size_t(1) << h.log, 0);
  h.bits.assign(size_t(1) << h.log, 0);
  uint32_t at = 0;
  for (int wt = 1; wt <= log; ++wt)
    for (size_t s = 0; s < symbols; ++s) {
      if (w[s] != wt) continue;
      uint32_t len = (1u << (wt - 1)) << shift;
      for (uint32_t u = 0; u < len; ++u) {
        h.sym[at + u] = uint8_t(s);
        h.bits[at + u] = uint8_t(log + 1 - wt);
      }
      at += len;
    }
  h.defined = true;
  return consumed + 1;
}

void make_x2(Huff& h) {
  const size_t size = size_t(1) << h.log, mask = size - 1;
  h.sym2.assign(size, 0);
  h.bits2.assign(size, 0);
  for (size_t v = 0; v < size; ++v) {
    int l1 = h.bits[v];
    size_t v2 = (v << l1) & mask;
    int l2 = h.bits[v2];
    if (l1 + l2 <= h.log) {
      h.sym2[v] = h.sym[v2];
      h.bits2[v] = uint8_t(l1 + l2);
    }
  }
}

// HUF_decodeSymbolX1 / X2 on a bit reader
inline void dec_x1(const Huff& h, BitD& b, uint8_t*& p) {
  size_t v = size_t(b.look_fast(unsigned(h.log)));
  *p++ = h.sym[v];
  b.skip(h.bits[v]);
}

inline void dec_x2(const Huff& h, BitD& b, uint8_t*& p) {
  size_t v = size_t(b.look_fast(unsigned(h.log)));
  p[0] = h.sym[v];
  if (h.bits2[v]) {
    p[1] = h.sym2[v];
    b.skip(h.bits2[v]);
    p += 2;
  } else {
    p[1] = 0;  // the table's unused second byte
    b.skip(h.bits[v]);
    p += 1;
  }
}

// HUF_decodeStreamX1
void stream_x1(const Huff& h, BitD& b, uint8_t* p, uint8_t* end) {
  if (end - p > 3) {
    while ((b.reload() == kUnfinished) & (p < end - 3))
      for (int k = 0; k < 4; ++k) dec_x1(h, b, p);
  } else {
    b.reload();
  }
  while (p < end) dec_x1(h, b, p);
}

// HUF_decodeStreamX2 (with HUF_decodeLastSymbolX2's clamp)
void stream_x2(const Huff& h, BitD& b, uint8_t* p, uint8_t* end) {
  if (end - p >= 8) {
    if (h.log <= 11) {
      while ((b.reload() == kUnfinished) & (p < end - 9))
        for (int k = 0; k < 5; ++k) dec_x2(h, b, p);
    } else {
      while ((b.reload() == kUnfinished) & (p < end - 7))
        for (int k = 0; k < 4; ++k) dec_x2(h, b, p);
    }
  } else {
    b.reload();
  }
  if (end - p >= 2) {
    while ((b.reload() == kUnfinished) & (p <= end - 2)) dec_x2(h, b, p);
    while (p <= end - 2) dec_x2(h, b, p);
  }
  if (p < end) {
    size_t v = size_t(b.look_fast(unsigned(h.log)));
    *p = h.sym[v];
    if (!h.bits2[v]) {
      b.skip(h.bits[v]);
    } else if (b.consumed < 64) {
      b.skip(h.bits2[v]);
      if (b.consumed > 64) b.consumed = 64;
    }
  }
}

void one_stream(const Huff& h, uint8_t* dst, size_t n, const uint8_t* src, size_t size) {
  BitD b;
  if (!b.init(src, size)) corrupt("a Huffman stream without its end mark");
  if (h.x2) {
    stream_x2(h, b, dst, dst + n);
  } else {
    stream_x1(h, b, dst, dst + n);
  }
  if (!b.at_end()) corrupt("a Huffman stream that does not end with its literals");
}

// HUF_decompress4X{1,2}_usingDTable_internal_fast (the C loops): returns
// false where libzstd takes the generic decoder instead
bool four_streams_fast(const Huff& h, uint8_t* dst, size_t n, const uint8_t* src, size_t size) {
  if (n == 0 || size < 10) {
    if (n == 0) return false;
    corrupt("four Huffman streams in fewer than 10 bytes");
  }
  if (h.log != 11) return false;
  size_t l1 = rd16(src), l2 = rd16(src + 2), l3 = rd16(src + 4);
  size_t l4 = size - (l1 + l2 + l3 + 6);  // wraps where the table overruns, as size_t does
  const uint8_t* iend[4] = {src + 6, src + 6 + l1, src + 6 + l1 + l2, src + 6 + l1 + l2 + l3};
  if (l1 < 8 || l2 < 8 || l3 < 8 || l4 < 8) return false;
  if (l4 > size) corrupt("a Huffman jump table past its section");
  const uint8_t* ip[4] = {iend[1] - 8, iend[2] - 8, iend[3] - 8, src + size - 8};
  const size_t seg = (n + 3) / 4;
  uint8_t* const oend = dst + n;
  uint8_t* op[4] = {dst, dst + seg, dst + 2 * seg, dst + 3 * seg};
  if (op[3] >= oend) return false;
  uint64_t bits[4];
  for (int s = 0; s < 4; ++s) {
    uint8_t last = ip[s][7];
    bits[s] = (rd64(ip[s]) | 1) << (last ? 8 - highbit32(last) : 0);
  }
  const uint8_t* const ilowest = src;
  uint8_t* ostop[4] = {op[1], op[2], op[3], oend};
  auto reload = [&](int s) {
    int z = ctz64(bits[s]);
    ip[s] -= z >> 3;
    bits[s] = (rd64(ip[s]) | 1) << (z & 7);
  };
  for (;;) {
    size_t iters = size_t(ip[0] - ilowest) / 7;
    if (h.x2) {
      for (int s = 0; s < 4; ++s) iters = std::min(iters, size_t(ostop[s] - op[s]) / 10);
    } else {
      iters = std::min(iters, size_t(oend - op[3]) / 5);
    }
    uint8_t* olimit = op[3] + iters * 5;
    if (op[3] == olimit) break;
    bool crossed = false;
    for (int s = 1; s < 4; ++s) crossed = crossed || ip[s] < ip[s - 1];
    if (crossed) break;
    do {
      for (int s = 0; s < 4; ++s) {
        for (int k = 0; k < 5; ++k) {
          size_t v = size_t(bits[s] >> 53);
          if (h.x2) {
            op[s][0] = h.sym[v];
            op[s][1] = h.bits2[v] ? h.sym2[v] : 0;
            bits[s] <<= (h.bits2[v] ? h.bits2[v] : h.bits[v]);
            op[s] += h.bits2[v] ? 2 : 1;
          } else {
            op[s][k] = h.sym[v];
            bits[s] <<= h.bits[v];
          }
        }
        if (!h.x2) op[s] += 5;
        reload(s);
      }
    } while (op[3] < olimit);
  }
  uint8_t* seg_end = dst;
  for (int s = 0; s < 4; ++s) {
    seg_end = seg <= size_t(oend - seg_end) ? seg_end + seg : oend;
    if (op[s] > seg_end) corrupt("a Huffman stream past its segment");
    if (ip[s] < iend[s] - 8) corrupt("a Huffman stream read past its start");
    BitD b;
    b.container = rd64(ip[s]);
    b.consumed = unsigned(ctz64(bits[s]));
    b.start = ilowest;
    b.limit = ilowest + 8;
    b.ptr = ip[s];
    if (h.x2) {
      stream_x2(h, b, op[s], seg_end);
    } else {
      stream_x1(h, b, op[s], seg_end);
    }
  }
  return true;
}

// HUF_decompress4X{1,2}_usingDTable_internal_body: the generic decoders
void four_streams_generic(const Huff& h, uint8_t* dst, size_t n, const uint8_t* src, size_t size) {
  if (size < 10) corrupt("four Huffman streams in fewer than 10 bytes");
  if (n < 6) corrupt("four Huffman streams of fewer than 6 literals");
  size_t l1 = rd16(src), l2 = rd16(src + 2), l3 = rd16(src + 4);
  size_t l4 = size - (l1 + l2 + l3 + 6);
  if (l4 > size) corrupt("a Huffman jump table past its section");
  const uint8_t* is[4] = {src + 6, src + 6 + l1, src + 6 + l1 + l2, src + 6 + l1 + l2 + l3};
  size_t lens[4] = {l1, l2, l3, l4};
  const size_t seg = (n + 3) / 4;
  uint8_t* const oend = dst + n;
  uint8_t* start[4] = {dst, dst + seg, dst + 2 * seg, dst + 3 * seg};
  if (start[3] > oend) corrupt("four Huffman streams of too few literals");
  BitD b[4];
  for (int s = 0; s < 4; ++s)
    if (!b[s].init(is[s], lens[s])) corrupt("a Huffman stream without its end mark");
  uint8_t* op[4] = {start[0], start[1], start[2], start[3]};
  uint8_t* const olimit = h.x2 ? oend - 7 : oend - 3;
  bool go = true;
  if (size_t(oend - op[3]) >= 8) {
    while (go & (op[3] < olimit)) {
      for (int s = 0; s < 4; ++s)
        for (int k = 0; k < 4; ++k) {
          if (h.x2) {
            dec_x2(h, b[s], op[s]);
          } else {
            dec_x1(h, b[s], op[s]);
          }
        }
      bool all = true;
      for (int s = 0; s < 4; ++s) all = (b[s].reload_fast() == kUnfinished) & all;
      go = all;
    }
  }
  for (int s = 0; s < 3; ++s)
    if (op[s] > start[s + 1]) corrupt("a Huffman stream past its segment");
  for (int s = 0; s < 4; ++s) {
    uint8_t* end = s < 3 ? start[s + 1] : oend;
    if (h.x2) {
      stream_x2(h, b[s], op[s], end);
    } else {
      stream_x1(h, b[s], op[s], end);
    }
  }
  if (!(b[0].at_end() & b[1].at_end() & b[2].at_end() & b[3].at_end()))
    corrupt("a Huffman stream that does not end with its literals");
}

// HUF_selectDecoder: true for X2
bool select_x2(size_t n, size_t csize) {
  static const uint32_t kTime[16][2][2] = {
      {{0, 0}, {1, 1}},         {{0, 0}, {1, 1}},         {{150, 216}, {381, 119}}, {{170, 205}, {514, 112}},
      {{177, 199}, {539, 110}}, {{197, 194}, {644, 107}}, {{221, 192}, {735, 107}}, {{256, 189}, {881, 106}},
      {{359, 188}, {1167, 109}}, {{582, 187}, {1570, 114}}, {{688, 187}, {1712, 122}}, {{825, 186}, {1965, 136}},
      {{976, 185}, {2131, 150}}, {{1180, 186}, {2070, 175}}, {{1377, 185}, {1731, 202}}, {{1412, 185}, {1695, 202}}};
  uint32_t q = csize >= n ? 15 : uint32_t(csize * 16 / n);
  uint32_t d256 = uint32_t(n >> 8);
  uint32_t t0 = kTime[q][0][0] + kTime[q][0][1] * d256;
  uint32_t t1 = kTime[q][1][0] + kTime[q][1][1] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

// ---- sequences (zstd_decompress_block.c) ----

// zstd_decompress_block.c's LL_base, LL_bits, ML_base, ML_bits and the
// predefined distributions (RFC 8878 3.1.1.3.2.2)
const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12,
                              13, 14, 15, 16, 18, 20, 22, 24, 28, 32, 40, 48, 64,
                              0x80, 0x100, 0x200, 0x400, 0x800, 0x1000, 0x2000, 0x4000, 0x8000, 0x10000};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
                              21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
                              43, 47, 51, 59, 67, 83, 99, 0x83, 0x103, 0x203, 0x403, 0x803, 0x1003, 0x2003,
                              0x4003, 0x8003, 0x10003};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct SeqCell {
  uint32_t base;
  uint8_t extra;   // additional bits
  uint8_t nb_bits;  // state bits
  uint16_t next;
};

struct SeqTable {
  std::vector<SeqCell> cells;
  unsigned log = 0;
};

SeqTable seq_table(const int16_t* norm, unsigned max_sv, unsigned log, int kind) {
  std::vector<FseCell> f = build_fse(norm, max_sv, log);
  SeqTable t;
  t.log = log;
  t.cells.resize(f.size());
  for (size_t u = 0; u < f.size(); ++u) {
    unsigned s = f[u].symbol;
    SeqCell& c = t.cells[u];
    c.nb_bits = f[u].nb_bits;
    c.next = f[u].new_state;
    if (kind == 0) {
      c.base = kLLBase[s];
      c.extra = kLLBits[s];
    } else if (kind == 1) {
      c.base = s < 2 ? s : (1u << s) - 3;  // OF_base: libzstd's offset + 3 coding
      c.extra = uint8_t(s);
    } else {
      c.base = kMLBase[s];
      c.extra = kMLBits[s];
    }
  }
  return t;
}

SeqTable rle_table(unsigned s, int kind) {
  SeqTable t;
  t.log = 0;
  t.cells.resize(1);
  SeqCell& c = t.cells[0];
  c.nb_bits = 0;
  c.next = 0;
  if (kind == 0) {
    c.base = kLLBase[s];
    c.extra = kLLBits[s];
  } else if (kind == 1) {
    c.base = s < 2 ? s : (1u << s) - 3;
    c.extra = uint8_t(s);
  } else {
    c.base = kMLBase[s];
    c.extra = kMLBits[s];
  }
  return t;
}

struct SeqState {
  const SeqCell* table;
  uint32_t state;
  void init(BitD& b, const SeqTable& t) {
    table = t.cells.data();
    state = uint32_t(b.read(t.log));
    b.reload();
  }
};

// ---- XXH64 ----

const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL, P3 = 1609587929392839161ULL,
               P4 = 9650029242287828579ULL, P5 = 2870177450012600261ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (p + 32 <= end) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += uint64_t(n);
  while (p + 8 <= end) {
    h ^= xround(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(rd32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---- frames ----

const uint64_t kUnknown = ~uint64_t(0);

struct Header {
  bool skippable = false;
  size_t size = 0;  // bytes of the header
  uint64_t content = kUnknown, window = 0, block_max = 0;
  bool checksum = false;
  uint32_t dict_id = 0;
};

// ZSTD_getFrameHeader: false where the input holds too little of it
bool frame_header(const uint8_t* p, size_t n, Header& h) {
  if (n < 4) return false;
  uint32_t magic = rd32(p);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    if (n < 8) return false;
    h.skippable = true;
    h.size = 8;
    return true;
  }
  if (magic != 0xFD2FB528u) corrupt("not a Zstandard frame (unknown magic number)");
  if (n < 5) return false;
  const uint8_t fhd = p[4];
  const unsigned dict_code = fhd & 3, checksum = (fhd >> 2) & 1, single = (fhd >> 5) & 1, fcs_code = fhd >> 6;
  static const size_t kDict[4] = {0, 1, 2, 4}, kFcs[4] = {0, 2, 4, 8};
  const size_t size = 5 + !single + kDict[dict_code] + kFcs[fcs_code] + (single && !fcs_code);
  if (n < size) return false;
  if (fhd & 0x08) corrupt("a frame header's reserved bit set");
  size_t at = 5;
  uint64_t window = 0;
  if (!single) {
    const uint8_t wd = p[at++];
    const unsigned wlog = (wd >> 3) + 10;
    if (wlog > 31) corrupt("a window over 2 GiB");
    window = uint64_t(1) << wlog;
    window += (window >> 3) * (wd & 7);
  }
  uint32_t dict = 0;
  if (dict_code == 1) dict = p[at];
  if (dict_code == 2) dict = rd16(p + at);
  if (dict_code == 3) dict = rd32(p + at);
  at += kDict[dict_code];
  uint64_t content = kUnknown;
  if (fcs_code == 0 && single) content = p[at];
  if (fcs_code == 1) content = rd16(p + at) + 256;
  if (fcs_code == 2) content = rd32(p + at);
  if (fcs_code == 3) content = rd64(p + at);
  if (single) window = content;
  h.skippable = false;
  h.size = size;
  h.content = content;
  h.window = window;
  h.block_max = std::min<uint64_t>(window, 128 * 1024);
  h.checksum = checksum;
  h.dict_id = dict;
  return true;
}

// ZSTD_findFrameCompressedSize: the frame's bytes, or 0 where they are not all there
size_t frame_compressed_size(const uint8_t* p, size_t n, const Header& h) {
  size_t at = h.size;
  for (;;) {
    if (n - at < 3) return 0;
    uint32_t bh = rd24(p + at);
    unsigned type = (bh >> 1) & 3;
    size_t csize = type == 1 ? 1 : bh >> 3;
    if (type == 3) return 0;
    if (3 + csize > n - at) return 0;
    at += 3 + csize;
    if (bh & 1) break;
  }
  if (h.checksum) {
    if (n - at < 4) return 0;
    at += 4;
  }
  return at;
}

struct Frame {
  Header h;
  std::vector<uint8_t> out;  // the frame's content so far (its history)
  bool one_pass = false;  // the frame decodes in one pass into the strip
  // the entropy kept across blocks
  Huff huff;
  bool lit_entropy = false, fse_entropy = false;
  SeqTable ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
};

SeqTable predefined(int kind) {
  if (kind == 0) return seq_table(kLLDefault, 35, 6, 0);
  if (kind == 1) return seq_table(kOFDefault, 28, 5, 1);
  return seq_table(kMLDefault, 52, 6, 2);
}

// ZSTD_buildSeqTable: returns the header's bytes
size_t build_seq_table(Frame& f, SeqTable& t, int type, int kind, const uint8_t* p, size_t n) {
  static const unsigned kMax[3] = {35, 31, 52}, kLog[3] = {9, 8, 9};
  switch (type) {
    case 1:  // RLE
      if (!n) corrupt("a sequence table cut short");
      if (p[0] > kMax[kind]) corrupt("a sequence RLE symbol out of range");
      t = rle_table(p[0], kind);
      return 1;
    case 0:  // predefined
      t = predefined(kind);
      return 0;
    case 3:  // repeat
      if (!f.fse_entropy) corrupt("a repeated sequence table before any");
      return 0;
    default: {
      int16_t norm[53];
      unsigned max_sv = kMax[kind], log = 0;
      size_t header = read_ncount(norm, &max_sv, &log, p, n);
      if (log > kLog[kind]) corrupt("a sequence table log over its maximum");
      t = seq_table(norm, max_sv, log, kind);
      return header;
    }
  }
}

// ZSTD_decodeLiteralsBlock: the literals into `lit`; returns the section's bytes
size_t literals(Frame& f, const uint8_t* p, size_t n, std::vector<uint8_t>& lit, uint64_t capacity) {
  if (n < 2) corrupt("a compressed block of fewer than 2 bytes");
  const unsigned type = p[0] & 3, size_format = (p[0] >> 2) & 3;
  const uint64_t expected = std::min<uint64_t>(f.h.block_max, capacity);
  if (type == 3 || type == 2) {  // repeat / compressed
    if (type == 3 && !f.lit_entropy) corrupt("repeated Huffman literals before any");
    if (n < 5) corrupt("a literals section header cut short");
    size_t header, count, csize;
    bool single = false;
    uint32_t lhc = rd32(p);
    if (size_format < 2) {
      single = size_format == 0;
      header = 3;
      count = (lhc >> 4) & 0x3FF;
      csize = (lhc >> 14) & 0x3FF;
    } else if (size_format == 2) {
      header = 4;
      count = (lhc >> 4) & 0x3FFF;
      csize = lhc >> 18;
    } else {
      header = 5;
      count = (lhc >> 4) & 0x3FFFF;
      csize = (lhc >> 22) + (size_t(p[4]) << 10);
    }
    if (count > f.h.block_max) corrupt("more literals than a block holds");
    if (!single && count < 6) corrupt("four Huffman streams of fewer than 6 literals");
    if (csize + header > n) corrupt("a literals section past its block");
    if (expected < count) corrupt("more literals than the output holds");
    lit.assign(count + 64, 0);
    const uint8_t* src = p + header;
    size_t src_size = csize;
    if (type == 2) {
      Huff h;
      size_t tree = read_huffman(h, src, src_size);
      if (!single) {
        if (count == 0) corrupt("no literals for four Huffman streams");
        if (src_size == 0) corrupt("four Huffman streams in no bytes");
        h.x2 = select_x2(count, src_size);
      }
      if (tree >= src_size) corrupt("a Huffman tree description that fills its section");
      if (h.x2) make_x2(h);
      f.huff = h;
      src += tree;
      src_size -= tree;
    }
    const Huff& h = f.huff;
    if (single) {
      one_stream(h, lit.data(), count, src, src_size);
    } else if (!four_streams_fast(h, lit.data(), count, src, src_size)) {
      four_streams_generic(h, lit.data(), count, src, src_size);
    }
    lit.resize(count);
    f.lit_entropy = true;
    return csize + header;
  }
  size_t header, count;
  switch (size_format) {
    case 1:
      header = 2;
      count = rd16(p) >> 4;
      break;
    case 3:
      header = 3;
      if (n < (type == 0 ? 3u : 4u)) corrupt("a literals section header cut short");
      count = rd24(p) >> 4;
      break;
    default:
      header = 1;
      count = p[0] >> 3;
  }
  if (type == 1 && size_format == 1 && n < 3) corrupt("a literals section header cut short");
  if (count > f.h.block_max) corrupt("more literals than a block holds");
  if (expected < count) corrupt("more literals than the output holds");
  if (type == 0) {
    if (header + count > n) corrupt("raw literals past their block");
    lit.assign(p + header, p + header + count);
    return header + count;
  }
  lit.assign(count, p[header]);
  return header + 1;
}

// ZSTD_decompressBlock_internal for a compressed block of `n` bytes, its
// output appended to the frame's; `capacity`: the room libzstd gives the
// block (one pass: the strip's room left; streaming: the block maximum)
void compressed_block(Frame& f, const uint8_t* p, size_t n, uint64_t capacity) {
  if (n > f.h.block_max) corrupt("a compressed block over the block maximum");
  std::vector<uint8_t> lit;
  size_t used = literals(f, p, n, lit, capacity);
  p += used;
  n -= used;
  // the output's limit for this block (ZSTD_allocateLiteralsBuffer's placement)
  const uint64_t bmax = f.h.block_max;
  uint64_t limit;
  if (f.one_pass && capacity > bmax + 32 + lit.size() + 32) {
    limit = bmax + 32;
  } else if (lit.size() <= 65536) {
    limit = capacity;
  } else {
    limit = std::min(bmax, capacity);
  }
  // ZSTD_decodeSeqHeaders
  if (n < 1) corrupt("a sequences section cut short");
  const uint8_t* ip = p;
  const uint8_t* iend = p + n;
  int nseq = *ip++;
  if (nseq > 0x7F) {
    if (nseq == 0xFF) {
      if (ip + 2 > iend) corrupt("a sequence count cut short");
      nseq = int(rd16(ip)) + 0x7F00;
      ip += 2;
    } else {
      if (ip >= iend) corrupt("a sequence count cut short");
      nseq = ((nseq - 0x80) << 8) + *ip++;
    }
  }
  std::vector<uint8_t>& out = f.out;
  const size_t block_start = out.size();
  if (nseq == 0) {
    if (ip != iend) corrupt("bytes after an empty sequences section");
  } else {
    if (ip + 1 > iend) corrupt("a sequences section cut short");
    if (*ip & 3) corrupt("a sequence table mode's reserved bits set");
    const int lt = *ip >> 6, ot = (*ip >> 4) & 3, mt = (*ip >> 2) & 3;
    ip++;
    ip += build_seq_table(f, f.ll, lt, 0, ip, size_t(iend - ip));
    ip += build_seq_table(f, f.of, ot, 1, ip, size_t(iend - ip));
    ip += build_seq_table(f, f.ml, mt, 2, ip, size_t(iend - ip));
    if (capacity == 0) corrupt("sequences with no room for their output");
    f.fse_entropy = true;
    BitD b;
    if (!b.init(ip, size_t(iend - ip))) corrupt("a sequence stream without its end mark");
    SeqState sl, so, sm;
    sl.init(b, f.ll);
    so.init(b, f.of);
    sm.init(b, f.ml);
    uint64_t prev[3] = {f.rep[0], f.rep[1], f.rep[2]};
    size_t lit_at = 0;
    for (; nseq; --nseq) {
      const SeqCell& l = sl.table[sl.state];
      const SeqCell& m = sm.table[sm.state];
      const SeqCell& o = so.table[so.state];
      uint64_t ml = m.base, ll = l.base, offset;
      const unsigned lb = l.extra, mb = m.extra, ob = o.extra, total = lb + mb + ob;
      if (ob > 1) {
        offset = o.base + b.read_fast(ob);
        prev[2] = prev[1];
        prev[1] = prev[0];
        prev[0] = offset;
      } else {
        const unsigned ll0 = l.base == 0;
        if (ob == 0) {
          offset = prev[ll0];
          prev[1] = prev[!ll0];
          prev[0] = offset;
        } else {
          offset = o.base + ll0 + b.read_fast(1);
          uint64_t temp = offset == 3 ? prev[0] - 1 : prev[offset];
          temp -= !temp;
          if (offset != 1) prev[2] = prev[1];
          prev[1] = prev[0];
          prev[0] = offset = temp;
        }
      }
      if (mb > 0) ml += b.read_fast(mb);
      if (total >= 57 - (9 + 9 + 8)) b.reload();
      if (lb > 0) ll += b.read_fast(lb);
      if (nseq != 1) {
        sl.state = l.next + uint32_t(b.read(l.nb_bits));
        sm.state = m.next + uint32_t(b.read(m.nb_bits));
        so.state = o.next + uint32_t(b.read(o.nb_bits));
        b.reload();
      }
      // ZSTD_execSequence
      const uint64_t written = out.size() - block_start;
      if (ll + ml > limit - written) corrupt("a sequence past the block's room");
      if (ll > lit.size() - lit_at) corrupt("a sequence past its literals");
      out.insert(out.end(), lit.begin() + long(lit_at), lit.begin() + long(lit_at + ll));
      lit_at += ll;
      if (offset > out.size()) corrupt("a match offset before the frame's start");
      size_t from = out.size() - size_t(offset);
      for (uint64_t k = 0; k < ml; ++k) out.push_back(out[from + k]);
    }
    if (!b.at_end()) corrupt("a sequence stream that does not end with its sequences");
    for (int i = 0; i < 3; ++i) f.rep[i] = uint32_t(prev[i]);
    const uint64_t written = out.size() - block_start;
    if (lit.size() - lit_at > limit - written) corrupt("the last literals past the block's room");
    out.insert(out.end(), lit.begin() + long(lit_at), lit.end());
    return;
  }
  if (lit.size() > limit) corrupt("the last literals past the block's room");
  out.insert(out.end(), lit.begin(), lit.end());
}

// libtiff's ZSTDDecode for one strip: `out` takes `size` bytes
void decode_strip(const uint8_t* in, size_t n, uint8_t* dst, size_t size) {
  // ZSTD_decompressStream from a new stream: the first frame (or skippable
  // frame) at the start of the input, decoded until it ends, the input is
  // spent or the strip is full; libtiff calls again only where none of
  // these, which the first call never leaves
  Frame f;
  if (!frame_header(in, n, f.h)) fail("ZSTD data ends inside its frame header (the strip is short)");
  if (f.h.skippable) fail("a skippable ZSTD frame where the strip's data begins (the strip is short)");
  const size_t cframe = f.h.content != kUnknown && f.h.content <= size ? frame_compressed_size(in, n, f.h) : 0;
  f.one_pass = cframe != 0;
  if (f.h.dict_id) fail("a ZSTD frame that names a dictionary (libtiff loads none)");
  if (!f.one_pass && std::max<uint64_t>(f.h.window, 1024) > (uint64_t(1) << 27) + 1)
    fail("a ZSTD window over 128 MiB (libzstd's limit)");
  size_t at = f.h.size;
  bool full_at_block_end = false;  // streaming: the strip filled exactly at a block's end
  // streaming into a buffer of the content size, where that is the smaller
  const bool bounded = !f.one_pass && f.h.content != kUnknown && f.h.content <= f.h.window + 2 * f.h.block_max + 64;
  for (;;) {
    if (n - at < 3) {
      if (f.one_pass) corrupt("a frame cut short");
      break;  // no more input
    }
    const uint32_t bh = rd24(in + at);
    const bool last = bh & 1;
    const unsigned type = (bh >> 1) & 3;
    const size_t bsize = bh >> 3;
    if (type == 3) corrupt("a reserved block type");
    const size_t csize = type == 1 ? 1 : bsize;
    if (!f.one_pass && csize > f.h.block_max) corrupt("a block over the block maximum");
    const size_t before = f.out.size();
    if (n - at - 3 < csize) {  // the block is not all there: a raw one streams what is
      if (f.one_pass) corrupt("a block past its frame");
      if (type == 0) f.out.insert(f.out.end(), in + at + 3, in + n);
      break;
    }
    const uint8_t* body = in + at + 3;
    const uint64_t capacity = f.one_pass ? size - before : f.h.block_max;
    if (type == 0) {
      if (f.one_pass && bsize > capacity) corrupt("a raw block past the output");
      f.out.insert(f.out.end(), body, body + bsize);
    } else if (type == 1) {
      if (f.one_pass && bsize > capacity) corrupt("an RLE block past the output");
      f.out.insert(f.out.end(), bsize, body[0]);
    } else {
      compressed_block(f, body, csize, capacity);
    }
    at += 3 + csize;
    const size_t produced = f.out.size() - before;
    if (!f.one_pass && produced > f.h.block_max) corrupt("a block's output over the block maximum");
    if (bounded && f.out.size() > f.h.content) corrupt("more output than the frame's content size");
    if (last && f.h.content != kUnknown && f.out.size() != f.h.content)
      corrupt("a frame whose content is not its content size");
    if (!f.one_pass) {
      if (full_at_block_end && produced) break;  // decoded, but no room to flush it
      if (f.out.size() > size) break;            // the strip filled inside this block
      full_at_block_end = f.out.size() == size;
    }
    if (last) {
      if (f.h.checksum) {
        if (n - at < 4) {
          if (f.one_pass) corrupt("a frame's checksum cut short");
          break;
        }
        if (rd32(in + at) != uint32_t(xxh64(f.out.data(), f.out.size()))) corrupt("a wrong content checksum");
      }
      break;
    }
  }
  if (f.out.size() < size) {
    char msg[96];
    std::snprintf(msg, sizeof msg, "ZSTD data gives %zu of its strip's %zu bytes", f.out.size(), size);
    fail(msg);
  }
  std::memcpy(dst, f.out.data(), size);
}

}  // namespace

extern "C" {

int gs_zstd_decode_tiff(const uint8_t* data, long long size, uint8_t* out, long long out_size) {
  try {
    decode_strip(data, size_t(size), out, size_t(out_size));
    return 0;
  } catch (const Error& e) {
    g_error = e.msg;
    return 1;
  } catch (const std::bad_alloc&) {
    g_error = "out of host memory";
    return 1;
  }
}

const char* gs_zstd_error() { return g_error.c_str(); }

}  // extern "C"
