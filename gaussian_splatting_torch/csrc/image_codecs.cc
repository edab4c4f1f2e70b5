// The byte loops of the BMP, TIFF, GIF, TGA, QOI, PCX, SGI, PSD, FLI, ICNS, SUN, MSP,
// XBM, PCD and IM readers:
// host C++, built with the host compiler by utils/cuda_build.py at first use
// and loaded with ctypes (utils/image_codecs.py). Each decoder runs per
// code, packet or byte, which Python cannot do at 1080p; everything else of
// the formats (headers, IFDs, blocks, unpacking, the predictor, palettes)
// is numpy and Python in utils/bmp.py, utils/tiff.py, utils/gif.py,
// utils/tga.py, utils/qoi.py, utils/pcx.py, utils/sgi.py, utils/psd.py,
// utils/fli.py, utils/icns.py, utils/sun.py, utils/msp.py, utils/xbm.py,
// utils/pcd.py and utils/im.py (each of those also holds a plain Python
// version of its loop, which the tests hold this one to).
//
// - gs_lzw_decode: TIFF's LZW as libtiff 4's LZWDecode reads it (new style,
//   codes most significant bit first, 9 to 12 bits, the width growing one
//   code early: at 511, 1023 and 2047 entries), or where the strip starts
//   with an old-style Clear (0x00 then a byte with its low bit set) as its
//   LZWDecodeCompat does (codes least significant bit first, the width
//   growing at 512, 1024 and 2048, no check of a code against the table);
//   a strip or tile into exactly `size` bytes, *produced the bytes written
//   before a fault (libtiff's RGBA reader goes on with them).
// - gs_packbits_decode: TIFF's PackBits as libtiff's PackBitsDecode (runs
//   past the end cut, -128 a no-op).
// - gs_thunderscan_decode: ThunderScan 4-bit grey as libtiff's
//   ThunderDecodeRow (tif_thunder.c): runs of the last pixel, 2- and 3-bit
//   deltas, raw pixels, each row on from where the last stopped; a row of
//   more or fewer pixels than its width fails.
// - gs_bmp_rle_decode: BMP's RLE8 and RLE4 as PIL's BmpRleDecoder
//   (BmpImagePlugin.py) reads them, quirks included: a run in encoded mode
//   is cut at the end of its row, an absolute run is not; an RLE4 absolute
//   run of n pixels reads n / 2 bytes (an odd n loses its last pixel but
//   still advances x by n); the word padding after an absolute run follows
//   the position in the file; a delta escape skips two bytes and takes
//   its right and up counts from the two after them.
// - gs_gif_lzw_decode: one GIF frame's image data as PIL's GifDecode.c
//   reads it: sub-blocks (decoded only once whole), variable-width LZW
//   codes least significant bit first from min_code_size + 1 bits up to
//   12, the width growing when the next free entry reaches it, Clear and
//   End codes, a first code after Clear that may not be a string, a full
//   table kept until the next Clear; rows in order or in the four
//   interlaced passes. It stops when the frame is full. PIL hands the
//   decoder the file in reads of `chunk` bytes: a sub-block is decoded only
//   once all of it has been read, and an End code before the frame is full
//   returns for another read, after which decoding goes on past the End
//   code. Where no read is left (the file's end), or at a code past the
//   table, it fails.
// - gs_tga_rle_decode: TGA's run-length coding as PIL's TgaRleDecode.c
//   reads it: a packet header, then one pixel repeated (a run, top bit set)
//   or that many pixels (a raw packet); a raw packet runs on into the next
//   rows, a run that would cross the end of its row fails (PIL: buffer
//   overrun); decoding stops at the last row, and data that ends before it
//   fails (PIL: image file is truncated).
// - gs_qoi_decode: QOI as PIL's QoiDecoder (QoiImagePlugin.py, a Python
//   decoder) reads it: every op (RGB, RGBA, INDEX, DIFF, LUMA, RUN), the
//   index table filled by every op but RUN (a table slot never filled
//   reads as 0, 0, 0, 0), the end marker not read; data that ends before
//   the last pixel fails.
// - gs_pcx_rle_decode: PCX's run-length coding as PIL's PcxDecode.c: a
//   byte of the two top bits set is a run of its low six bits of the next
//   byte, any other byte a literal; each line of `line_bytes` bytes (all
//   planes) is unpacked on its own, after PIL's memmove of the planes of a
//   padded stride together (for 1-bit planes (width + 7) / 8 bytes apart,
//   for 8-bit ones a width apart, where the line holds more than one);
//   a run across a line's end fails (PIL: buffer overrun), data that ends
//   before the last line fails.
// - gs_sgi_rle_decode: SGI's RLE as PIL's SgiRleDecode.c: the offset and
//   length tables, each row and channel from its own offset, 8- or 16-bit
//   atoms, a count of 0 ending the row, PIL's bounds checks (a row past
//   the width or the buffer fails), a last chunk that is not a 0 ending
//   the decode with the rows so far, the row buffer kept from row to row,
//   a length of 2^31 or more (negative as PIL's int) decoding nothing.
// - gs_pil_packbits_decode: PackBits as PIL's PackDecode.c (PSD): each
//   row on its own, runs and literals cut at the row's end (not carried
//   into the next row), -128 a no-op; data that ends before the last row
//   fails.
//
// Interface (plain C; every entry returns 0 or 1, the message of a 1 in
// gs_codec_error for the calling thread):
//   gs_lzw_decode(in, n, out, size, produced)
//   gs_packbits_decode(in, n, out, size, produced)
//   gs_thunderscan_decode(in, n, width, rows, out)
//   gs_bmp_rle_decode(file, file_size, start, rle4, width, want, out, produced)
//   gs_gif_lzw_decode(in, n, chunk, min_code_size, interlace, out, stride, width, height)
//   gs_tga_rle_decode(file, file_size, start, depth, row_bytes, rows, out)
//   gs_qoi_decode(file, file_size, start, bands, pixels, out)
//   gs_pcx_rle_decode(file, file_size, start, line_bytes, xsize, bits, rows, out)
//   gs_sgi_rle_decode(file, file_size, bands, xsize, ysize, bpc, out)
//   gs_pil_packbits_decode(file, file_size, start, row_bytes, rows, out)
//   gs_sun_rle_decode(file, file_size, start, row_bytes, rows, out)
//   gs_msp_decode(file, file_size, ysize, blank, out, cap, produced)
//   gs_xbm_decode(text, n, size, out)
//   gs_pcd_decode(blocks, xsize, ysize, L, CB, GB, CR, GR, out)
//   gs_im_bit_decode(in, n, bits, xsize, ysize, out)
// - gs_fli_decode: one call of PIL's FliDecode.c on the bytes PIL's load
//   loop has read of frame 0 (utils/fli.py runs that loop): nothing until
//   the frame chunk's size is there (one pad byte allowed), a chunk that is
//   not 0xF1FA fails (unrecognized data), then its subchunks into the
//   image: the palette chunks (4, 11) and PSTAMP (18) skipped, SS2 (7,
//   word deltas with line-skip and last-byte flag words), LC (12, byte
//   deltas from a first line), BLACK (13), BRUN (15, a packet count byte
//   ignored, positive counts runs, negative literals; a row not filled
//   exactly fails) and COPY (16; where the chunk holds fewer bytes than the
//   image it returns the bytes before the subchunk as consumed); a packet
//   past a row's end ends the chunk's lines, which then fail; data past
//   the subchunk fails (buffer overrun), an unknown subchunk or a size of 0
//   fails.
// - gs_icns_rle_decode: one band of an icns 32-bit icon as PIL's read_32
//   (IcnsImagePlugin.py) reads it: a byte with its top bit set is a run of
//   (byte - 125) copies of the next byte, else a literal of byte + 1 bytes,
//   until the band's pixels are counted off; runs and literals cut by the
//   file's end add fewer bytes than they count.
// - gs_sun_rle_decode: Sun raster RLE as PIL's SunRleDecode.c: 0x80 0x00
//   a literal 0x80, 0x80 n v a run of n + 1 bytes v (the part past a row's
//   end carried into the next rows), any other byte a literal; rows of
//   `row_bytes` bytes, not padded. Fails where the data ends before the
//   last row.
// - gs_msp_decode: MSP version 2 as PIL's Python MspDecoder: the row map
//   of `ysize` 16-bit lengths at byte 32, each row's runs (type 0: a count
//   and a byte repeated; else that many bytes copied, fewer where the row
//   ends), a row of length 0 a white row of `blank` 0xFF bytes; the rows'
//   bytes one stream, of which the first `cap` are written and *produced
//   counts all. Fails (PIL: OSError) at a row map or row cut short or a
//   run cut short, wherever in the file.
// - gs_xbm_decode: the hex text of an XBM as PIL's XbmDecode.c: each byte
//   the two characters after the next 'x' (a character that is not a hex
//   digit counts 0). Fails where the text ends before the last row.
// - gs_pcd_decode: PhotoCD's base image as PIL's PcdDecode.c: each block
//   of 3 x xsize bytes two luma rows and their shared chroma, pixel x
//   taking chroma (x + 4 xsize) / 2 and (x + 5 xsize) / 2 of the block,
//   then PIL's "YCC;P" unpacker through the tables the caller passes
//   (utils/pcd.py: L, CB, GB, CR, GR), clipped to 0..255.
// - gs_im_bit_decode: PIL's Bit.c with an IM file's arguments (pad 8,
//   fill 3: each byte put above the bits held, each sample the low
//   `bits`; a new row sets the count to 0 and keeps the bits; no sign;
//   bottom-up) into float32 samples; the caller passes every row's bytes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

int fail(const std::string& msg) {
  g_error = msg;
  return 1;
}

const int kClear = 256, kEoi = 257, kFirst = 258, kBitsMin = 9, kBitsMax = 12;
const int kTableSize = (1 << kBitsMax) + 1024;  // libtiff's CSIZE

struct Entry {
  int next;  // the entry this one extends (-1: none)
  int length;
  uint8_t value, firstchar;
};

// Old-style LZW, as libtiff's LZWDecodeCompat: codes least significant bit
// first, the width grown when the next entry passes 2^n - 1 (one entry
// later than the new style), no check of a code against the table: an
// entry not yet filled has length 0 and fails as libtiff fails.
int lzw_decode_compat(const uint8_t* in, long long n, uint8_t* out, long long size, long long* produced) {
  std::vector<Entry> table(kTableSize, Entry{-1, 0, 0, 0});
  for (int c = 0; c < 256; ++c) table[c] = Entry{-1, 1, static_cast<uint8_t>(c), static_cast<uint8_t>(c)};
  int nbits = kBitsMin, mask = (1 << nbits) - 1, free_ent = -1, max_ent = mask - 1;
  int old = 0;
  uint64_t acc = 0;
  int have = 0;
  int64_t left = 8 * static_cast<int64_t>(n), pos = 0;
  long long op = 0;
  auto next_code = [&]() {
    if (left < nbits) return kEoi;
    while (have < nbits) {
      acc |= static_cast<uint64_t>(pos < n ? in[pos] : 0) << have;
      ++pos;
      have += 8;
    }
    int code = static_cast<int>(acc & mask);
    acc >>= nbits;
    have -= nbits;
    left -= nbits;
    return code;
  };
  auto done = [&](int rc) {
    *produced = op;
    return rc;
  };
  while (op < size) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        for (int c = kFirst; c < kTableSize; ++c) table[c] = Entry{-1, 0, 0, 0};
        free_ent = kFirst;
        nbits = kBitsMin;
        mask = (1 << nbits) - 1;
        max_ent = mask;
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return done(fail("corrupt old-style LZW data (a code after Clear that is not a byte)"));
      out[op++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= kTableSize) return done(fail("corrupt old-style LZW data (the table is full)"));
    Entry& e = table[free_ent];
    e.next = old;
    e.firstchar = table[old].firstchar;
    e.length = table[old].length + 1;
    e.value = code < free_ent ? table[code].firstchar : e.firstchar;
    if (++free_ent > max_ent) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      mask = (1 << nbits) - 1;
      max_ent = mask;
    }
    old = code;
    const Entry& s = table[code];
    if (code < 256) {
      out[op++] = s.value;
      continue;
    }
    if (s.length == 0) return done(fail("corrupt old-style LZW data (a string of length 0)"));
    long long len = s.length, keep = len < size - op ? len : size - op;
    int c = code;
    for (long long i = len - 1; i >= 0; --i) {
      if (i < keep) out[op + i] = table[c].value;
      c = table[c].next;
    }
    op += keep;
  }
  if (op < size)
    return done(fail("old-style LZW data ends " + std::to_string(size - op) + " bytes short of its strip or tile"));
  return done(0);
}

}  // namespace

extern "C" {

const char* gs_codec_error() { return g_error.c_str(); }

// *produced: the bytes written before a fault (all `size` on success)
int gs_lzw_decode(const uint8_t* in, long long n, uint8_t* out, long long size, long long* produced) {
  if (n >= 2 && in[0] == 0 && (in[1] & 1)) return lzw_decode_compat(in, n, out, size, produced);
  std::vector<Entry> table(kTableSize, Entry{-1, 0, 0, 0});
  for (int c = 0; c < 256; ++c) table[c] = Entry{-1, 1, static_cast<uint8_t>(c), static_cast<uint8_t>(c)};
  // libtiff starts a strip with no table: its first code must be a Clear
  int nbits = kBitsMin, mask = (1 << nbits) - 1, free_ent = -1, max_ent = mask - 1;
  int old = kClear;
  uint64_t acc = 0;
  int64_t left = 8 * static_cast<int64_t>(n), pos = 0;
  int have = 0;
  long long op = 0;
  auto done = [&](int rc) {
    *produced = op;
    return rc;
  };
  // the next code; data that runs out reads as EOI (libtiff: a strip "not
  // terminated with EOI code")
  auto next_code = [&]() {
    if (left < nbits) return kEoi;
    while (have < nbits) {
      acc = (acc << 8) | in[pos++];
      have += 8;
    }
    have -= nbits;
    left -= nbits;
    return static_cast<int>((acc >> have) & mask);
  };
  while (op < size) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      nbits = kBitsMin;
      mask = (1 << nbits) - 1;
      max_ent = mask - 1;
      free_ent = kFirst;
      do {
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return done(fail("corrupt LZW data (a code after Clear that is not a byte)"));
      out[op++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    if (free_ent < kFirst) return done(fail("corrupt LZW data (no Clear code before the first string)"));
    if (code > free_ent) return done(fail("corrupt LZW data (a code past the table)"));
    Entry& e = table[free_ent];
    e.next = old;
    e.firstchar = table[old].firstchar;
    e.length = table[old].length + 1;
    e.value = code < free_ent ? table[code].firstchar : e.firstchar;
    if (++free_ent > max_ent) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      mask = (1 << nbits) - 1;
      max_ent = mask - 1;
      if (free_ent >= kTableSize) free_ent = -1;  // only a Clear or EOI may follow
    }
    old = code;
    const Entry& s = table[code];
    if (code < 256) {
      out[op++] = s.value;
      continue;
    }
    if (s.length == 0) return done(fail("corrupt LZW data (a string of length 0)"));
    // the string from its last byte back; a string longer than the room
    // left keeps its first bytes
    long long len = s.length, keep = len < size - op ? len : size - op;
    int c = code;
    for (long long i = len - 1; i >= 0; --i) {
      if (i < keep) out[op + i] = table[c].value;
      c = table[c].next;
    }
    op += keep;
  }
  if (op < size)
    return done(fail("LZW data ends " + std::to_string(size - op) + " bytes short of its strip or tile"));
  return done(0);
}

int gs_packbits_decode(const uint8_t* in, long long n, uint8_t* out, long long size, long long* produced) {
  long long ip = 0, op = 0;
  while (ip < n && op < size) {
    int count = static_cast<int8_t>(in[ip++]);
    if (count < 0) {
      if (count == -128) continue;
      long long run = -count + 1;
      if (run > size - op) run = size - op;
      if (ip >= n) break;
      std::memset(out + op, in[ip++], run);
      op += run;
    } else {
      long long run = count + 1;
      if (run > size - op) run = size - op;
      if (run > n - ip) break;
      std::memcpy(out + op, in + ip, run);
      op += run;
      ip += run;
    }
  }
  *produced = op;
  if (op < size)
    return fail("PackBits data ends " + std::to_string(size - op) + " bytes short of its strip or tile");
  return 0;
}

// ThunderScan 4-bit grey as libtiff's ThunderDecodeRow / ThunderDecode:
// each row of `width` pixels decoded on from where the last one stopped,
// two pixels a byte, high nibble first; a run that would pass the row's end
// writes nothing (libtiff counts it without writing it), more or fewer
// pixels than the row holds fail.
int gs_thunderscan_decode(const uint8_t* in, long long n, int width, int rows, uint8_t* out) {
  static const int two[4] = {0, 1, 0, -1}, three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const long long row_bytes = (static_cast<long long>(width) + 1) / 2;
  long long ip = 0;
  for (int r = 0; r < rows; ++r) {
    uint8_t* op = out + r * row_bytes;
    uint8_t* const op0 = op;
    unsigned last = 0;
    long long npixels = 0;
    const long long maxpixels = width;
    auto set = [&](unsigned v) {
      last = v & 0xf;
      if (npixels < maxpixels) {
        if (npixels++ & 1)
          *op++ |= static_cast<uint8_t>(last);
        else
          op[0] = static_cast<uint8_t>(last << 4);
      }
    };
    while (ip < n && npixels < maxpixels) {
      int c = in[ip++], d;
      switch (c & 0xc0) {
        case 0x00: {
          int k = c & 0x3f;
          if (npixels & 1) {
            op[0] |= static_cast<uint8_t>(last);
            last = *op++;
            ++npixels;
            --k;
          } else {
            last |= last << 4;
          }
          npixels += k;
          if (npixels <= maxpixels)
            for (; k > 0; k -= 2) *op++ = static_cast<uint8_t>(last);
          if (k == -1) *--op &= 0xf0;
          last &= 0xf;
          break;
        }
        case 0x40:
          if ((d = (c >> 4) & 3) != 2) set(static_cast<unsigned>(static_cast<int>(last) + two[d]));
          if ((d = (c >> 2) & 3) != 2) set(static_cast<unsigned>(static_cast<int>(last) + two[d]));
          if ((d = c & 3) != 2) set(static_cast<unsigned>(static_cast<int>(last) + two[d]));
          break;
        case 0x80:
          if ((d = (c >> 3) & 7) != 4) set(static_cast<unsigned>(static_cast<int>(last) + three[d]));
          if ((d = c & 7) != 4) set(static_cast<unsigned>(static_cast<int>(last) + three[d]));
          break;
        default:
          set(static_cast<unsigned>(c));
      }
    }
    if (npixels != maxpixels) {
      uint8_t* end = op0 + (maxpixels + 1) / 2;
      if (op < end) std::memset(op, 0, end - op);
      return fail(std::string(npixels < maxpixels ? "Not enough" : "Too much") + " ThunderScan data at row " +
                  std::to_string(r) + " (" + std::to_string(npixels) + " != " + std::to_string(maxpixels) +
                  " pixels; libtiff fails the strip)");
    }
  }
  return 0;
}

// `out` takes the first `want` bytes of the decoded rows (one byte a pixel,
// the file's row order); *produced is how many the data gave, which may be
// fewer (PIL then raises).
int gs_bmp_rle_decode(const uint8_t* file, long long file_size, long long start, int rle4, int width,
                      long long want, uint8_t* out, long long* produced) {
  long long pos = start, len = 0, x = 0;
  auto emit = [&](uint8_t v) {
    if (len < want) out[len] = v;
    ++len;
  };
  while (len < want && width > 0) {
    if (pos + 1 >= file_size) break;  // the count or its byte is missing
    int count = file[pos], byte = file[pos + 1];
    pos += 2;
    if (count) {  // encoded mode, cut at the end of the row
      if (x + count > width) count = static_cast<int>(width - x > 0 ? width - x : 0);
      for (int i = 0; i < count; ++i) emit(static_cast<uint8_t>(rle4 ? (i % 2 ? byte & 15 : byte >> 4) : byte));
      x += count;
    } else if (byte == 0) {  // end of line
      while (len % width) emit(0);
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta, as PIL reads it
      if (pos + 2 > file_size) break;
      pos += 2;
      if (pos + 2 > file_size) return fail("a BMP RLE delta escape without its offsets");
      long long right = file[pos], up = file[pos + 1];
      pos += 2;
      for (long long i = 0, m = right + up * width; i < m; ++i) emit(0);
      x = len % width;
    } else {  // absolute mode
      long long need = rle4 ? byte / 2 : byte;
      long long got = need < file_size - pos ? need : (file_size - pos > 0 ? file_size - pos : 0);
      for (long long i = 0; i < got; ++i) {
        if (rle4) {
          emit(file[pos + i] >> 4);
          emit(file[pos + i] & 15);
        } else {
          emit(file[pos + i]);
        }
      }
      pos += got;
      if (got < need) break;
      x += byte;
      if (pos % 2) ++pos;  // word padding, by the position in the file
    }
  }
  *produced = len < want ? len : want;
  return 0;
}

// `in` is the file from the byte after the minimum code size to its end;
// `out` the frame's first pixel on the canvas, rows `stride` bytes apart.
int gs_gif_lzw_decode(const uint8_t* in, long long n, long long chunk, int bits, int interlace, uint8_t* out,
                      long long stride, int width, int height) {
  if (bits < 0 || bits > 12) return fail("a GIF LZW minimum code size of " + std::to_string(bits));
  const int kGifTable = 4096, clear = 1 << bits, end = clear + 1;
  int pass = interlace ? 1 : 0, step = interlace ? 8 : 1;
  long long x = 0, y = 0;
  uint8_t* row = out;
  bool full = false;
  auto put = [&](uint8_t v) {  // PIL's NEWLINE at the end of each row
    row[x] = v;
    if (++x < width) return;
    x = 0;
    y += step;
    while (y >= height) {
      if (pass == 1) {
        y = 4;
        pass = 2;
      } else if (pass == 2) {
        step = 4;
        y = 2;
        pass = 3;
      } else if (pass == 3) {
        step = 2;
        y = 1;
        pass = 0;
      } else {
        full = true;
        return;
      }
    }
    row = out + y * stride;
  };
  std::vector<uint8_t> data(kGifTable), stack(kGifTable);
  std::vector<int> link(kGifTable);
  int state = 1, next = 0, codesize = 0, codemask = 0, lastdata = 0, lastcode = 0, blocksize = 0, bitcount = 0;
  uint32_t bitbuffer = 0;
  long long pos = 0, read = chunk < n ? chunk : n;  // the bytes PIL has read so far
  const std::string truncated = "GIF image data ends before the frame is full (PIL: image file is truncated)";
  auto read_more = [&]() {  // PIL's next read; false at the file's end
    if (read >= n) return false;
    read = n - read > chunk ? read + chunk : n;
    return true;
  };
  const std::string broken = "corrupt GIF LZW data (PIL: broken data stream)";
  while (!full) {
    if (state == 1) {  // after a Clear: an empty table
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      state = 2;
    }
    while (bitcount < codesize) {
      if (blocksize > 0) {
        bitbuffer |= static_cast<uint32_t>(in[pos++]) << bitcount;
        bitcount += 8;
        --blocksize;
      } else if (pos < read && read - pos >= in[pos] + 1LL) {  // a sub-block is decoded once all of it is read
        blocksize = in[pos++];
      } else if (!read_more()) {
        return fail(truncated);
      }
    }
    int c = static_cast<int>(bitbuffer & static_cast<uint32_t>(codemask));
    bitbuffer >>= codesize;
    bitcount -= codesize;
    if (c == clear) {
      if (state != 2) state = 1;
      continue;
    }
    if (c == end) {  // PIL returns for another read, then decodes on past the End code
      if (!read_more()) return fail(truncated);
      continue;
    }
    int top = kGifTable;
    if (state == 2) {  // the first code after a Clear is a byte
      if (c > clear) return fail(broken);
      lastdata = lastcode = c;
      state = 3;
    } else {
      const int thiscode = c;
      if (c > next) return fail(broken);
      if (c == next) {  // the string being defined: the last one and its first byte
        stack[--top] = static_cast<uint8_t>(lastdata);
        c = lastcode;
      }
      while (c >= clear) {
        if (top <= 0 || c >= kGifTable) return fail(broken);
        stack[--top] = data[c];
        c = link[c];
      }
      lastdata = c;
      if (next < kGifTable) {  // a full table stays as it is until a Clear
        data[next] = static_cast<uint8_t>(c);
        link[next] = lastcode;
        if (next == codemask && codesize < 12) {
          ++codesize;
          codemask = (1 << codesize) - 1;
        }
        ++next;
      }
      lastcode = thiscode;
    }
    put(static_cast<uint8_t>(lastdata));
    for (int i = top; i < kGifTable && !full; ++i) put(stack[i]);
  }
  return 0;
}

// `out` takes `rows` rows of `row_bytes` bytes in the file's row order;
// `depth` is the bytes of a pixel.
int gs_tga_rle_decode(const uint8_t* in, long long n, long long start, int depth, long long row_bytes,
                      long long rows, uint8_t* out) {
  if (depth < 1 || row_bytes < 1 || rows < 1) return fail("a TGA RLE image without pixels");
  const std::string truncated = "TGA RLE data ends before the last row (PIL: image file is truncated)";
  long long pos = start, x = 0, y = 0;
  while (true) {
    if (pos >= n) return fail(truncated);
    const int head = in[pos];
    long long count = static_cast<long long>(depth) * ((head & 0x7F) + 1);
    if (head & 0x80) {  // a run: one pixel, repeated within its row
      if (n - pos < 1 + depth) return fail(truncated);
      if (x + count > row_bytes)
        return fail("a TGA RLE run that crosses the end of its row at row " + std::to_string(y) +
                    " (PIL: buffer overrun when reading image file)");
      uint8_t* row = out + y * row_bytes;
      for (long long i = 0; i < count; i += depth) std::memcpy(row + x + i, in + pos + 1, depth);
      pos += 1 + depth;
      x += count;
      if (x >= row_bytes) {
        x = 0;
        if (++y >= rows) return 0;
      }
      continue;
    }
    if (n - pos < 1 + count) return fail(truncated);  // a raw packet, read whole
    const uint8_t* src = in + pos + 1;
    pos += 1 + count;
    while (count > 0) {  // it may run on into the rows below
      long long take = count < row_bytes - x ? count : row_bytes - x;
      std::memcpy(out + y * row_bytes + x, src, take);
      src += take;
      count -= take;
      x += take;
      if (x >= row_bytes) {
        x = 0;
        if (++y >= rows) return 0;
      }
    }
  }
}

// `out` takes `pixels` pixels of `bands` (3 or 4) bytes; the stream starts
// at `start`, after the 14-byte header.
int gs_qoi_decode(const uint8_t* in, long long n, long long start, int bands, long long pixels, uint8_t* out) {
  const std::string truncated = "QOI data ends before the last pixel (PIL: the stream runs out)";
  uint8_t index[64][4] = {};  // PIL's dict: a slot never filled reads 0, 0, 0, 0
  uint8_t px[4] = {0, 0, 0, 255};
  long long pos = start, done = 0;
  while (done < pixels) {
    if (pos >= n) return fail(truncated);
    const int b = in[pos++];
    long long repeat = 0;  // 0: one pixel that enters the table
    if (b == 0xFE) {  // QOI_OP_RGB
      if (n - pos < 3) return fail(truncated);
      std::memcpy(px, in + pos, 3);
      pos += 3;
    } else if (b == 0xFF) {  // QOI_OP_RGBA
      if (n - pos < 4) return fail(truncated);
      std::memcpy(px, in + pos, 4);
      pos += 4;
    } else if ((b >> 6) == 0) {  // QOI_OP_INDEX
      std::memcpy(px, index[b & 63], 4);
    } else if ((b >> 6) == 1) {  // QOI_OP_DIFF
      px[0] = static_cast<uint8_t>(px[0] + ((b >> 4) & 3) - 2);
      px[1] = static_cast<uint8_t>(px[1] + ((b >> 2) & 3) - 2);
      px[2] = static_cast<uint8_t>(px[2] + (b & 3) - 2);
    } else if ((b >> 6) == 2) {  // QOI_OP_LUMA
      if (pos >= n) return fail(truncated);
      const int b2 = in[pos++];
      const int dg = (b & 63) - 32;
      px[0] = static_cast<uint8_t>(px[0] + dg + ((b2 >> 4) & 15) - 8);
      px[1] = static_cast<uint8_t>(px[1] + dg);
      px[2] = static_cast<uint8_t>(px[2] + dg + (b2 & 15) - 8);
    } else {  // QOI_OP_RUN: PIL does not enter the run's pixel in the table
      repeat = (b & 63) + 1;
    }
    if (repeat == 0) {
      std::memcpy(index[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64], px, 4);
      repeat = 1;
    }
    for (long long i = 0; i < repeat && done < pixels; ++i, ++done) std::memcpy(out + done * bands, px, bands);
  }
  return 0;
}

// `out` takes `rows` lines of `line_bytes` bytes (every plane of a row),
// planes moved together as PIL moves them; `xsize` is the width in pixels,
// `bits` those of PIL's raw mode (1, 2 and 4 for "1", "P;2L", "P;4L", 8
// for "L" and "P", 24 for "RGB;L").
int gs_pcx_rle_decode(const uint8_t* in, long long n, long long start, long long line_bytes, long long xsize,
                      int bits, long long rows, uint8_t* out) {
  if (line_bytes < 1 || xsize < 1 || rows < 1) return fail("a PCX image without pixels");
  const std::string truncated = "PCX data ends before the last row (PIL: image file is truncated)";
  long long pos = start, x = 0;
  for (long long y = 0; y < rows;) {
    uint8_t* line = out + y * line_bytes;
    if (pos >= n) return fail(truncated);
    if ((in[pos] & 0xC0) == 0xC0) {  // a run
      if (n - pos < 2) return fail(truncated);
      const int count = in[pos] & 0x3F;
      if (x + count > line_bytes)
        return fail("a PCX run that crosses the end of its row at row " + std::to_string(y) +
                    " (PIL: buffer overrun when reading image file)");
      std::memset(line + x, in[pos + 1], count);
      x += count;
      pos += 2;
    } else {
      line[x++] = in[pos++];
    }
    if (x >= line_bytes) {  // PcxDecode.c's plane shuffle: planes `plane` bytes apart
      long long plane = xsize, bands = line_bytes / xsize, stride = 0;
      if (bits == 2 || bits == 4) {
        plane = (xsize + 7) / 8;
        bands = bits;
        stride = line_bytes / bits;
      } else if (bands != 0) {
        stride = line_bytes / bands;
      }
      if (stride > plane) {
        for (long long i = 1; i < bands; ++i) std::memmove(line + i * plane, line + i * stride, plane);
      }
      x = 0;
      ++y;
    }
  }
  return 0;
}

namespace {

// SgiRleDecode.c's expandrow / expandrow2: 0 a row ended by a 0 count,
// 1 a last chunk that is not 0, -1 a bound passed.
int sgi_row(uint8_t* dest, const uint8_t* src, long long n, int z, long long xsize, const uint8_t* end, int bpc) {
  long long x = 0;
  for (; n > 0; --n) {
    if (src + (bpc - 1) > end) return -1;
    int pixel = src[bpc - 1];
    src += bpc;
    if (n == 1 && pixel != 0) return 1;
    int count = pixel & 0x7F;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + static_cast<long long>(bpc) * count > end) return -1;
      while (count--) {
        std::memcpy(dest, src, bpc);
        src += bpc;
        dest += z * bpc;
      }
    } else {
      if (src + (bpc - 1) + (bpc == 2 ? 1 : 0) > end) return -1;
      while (count--) {
        std::memcpy(dest, src, bpc);
        dest += z * bpc;
      }
      src += bpc;
    }
  }
  return 0;
}

}  // namespace

// `out` takes the image's `ysize` rows top-down, each `xsize` pixels of
// `bands` interleaved channels of `bpc` bytes as the file stores them;
// rows the decode does not reach stay as `out` holds them (zeros).
int gs_sgi_rle_decode(const uint8_t* file, long long n, int bands, long long xsize, long long ysize, int bpc,
                      uint8_t* out) {
  const long long header = 512, bufsize = n - header, tablen = bands * ysize;
  const std::string overrun = "SGI RLE data past its row or its file (PIL: buffer overrun when reading image file)";
  if (bufsize < 8 * tablen) return fail(overrun);
  const uint8_t* ptr = file + header;
  const uint8_t* end = ptr + bufsize - 1;
  auto u32 = [&](long long at) {
    return (static_cast<uint32_t>(ptr[at]) << 24) | (static_cast<uint32_t>(ptr[at + 1]) << 16) |
           (static_cast<uint32_t>(ptr[at + 2]) << 8) | ptr[at + 3];
  };
  const long long row_bytes = xsize * bands * bpc;
  std::vector<uint8_t> buffer(static_cast<size_t>(row_bytes), 0);
  for (long long row = 0; row < ysize; ++row) {
    for (int c = 0; c < bands; ++c) {
      uint32_t offset = u32(4 * (row + c * ysize));
      const uint32_t length = u32(4 * (tablen + row + c * ysize));
      if (offset < header) return fail(overrun);
      offset -= header;
      // PIL passes the length as an int: one of 2^31 or more skips the row's channel
      const int status = sgi_row(buffer.data() + c * bpc, ptr + offset, static_cast<int32_t>(length), bands,
                                 xsize, end, bpc);
      if (status == -1) return fail(overrun);
      if (status == 1) return 0;
    }
    std::memcpy(out + (ysize - 1 - row) * row_bytes, buffer.data(), row_bytes);  // rows bottom-up
  }
  return 0;
}

// `out` takes `rows` rows of `row_bytes` bytes from the stream at `start`.
int gs_pil_packbits_decode(const uint8_t* in, long long n, long long start, long long row_bytes, long long rows,
                           uint8_t* out) {
  if (row_bytes < 1 || rows < 1) return fail("a PackBits image without pixels");
  const std::string truncated = "PackBits data ends before the last row (PIL: image file is truncated)";
  long long pos = start, x = 0;
  for (long long y = 0; y < rows;) {
    uint8_t* row = out + y * row_bytes;
    if (pos >= n) return fail(truncated);
    const int b = in[pos];
    if (b & 0x80) {
      if (b == 0x80) {  // a no-op
        ++pos;
        continue;
      }
      if (n - pos < 2) return fail(truncated);
      long long count = 257 - b;
      if (count > row_bytes - x) count = row_bytes - x;  // cut at the row's end
      std::memset(row + x, in[pos + 1], count);
      x += count;
      pos += 2;
    } else {
      const long long size = b + 2;
      if (n - pos < size) return fail(truncated);
      long long count = size - 1;
      if (count > row_bytes - x) count = row_bytes - x;
      std::memcpy(row + x, in + pos + 1, count);
      x += count;
      pos += size;
    }
    if (x >= row_bytes) {
      x = 0;
      ++y;
    }
  }
  return 0;
}

// PIL's FliDecode.c. `status` and `errcode` as PIL's decoder returns them:
// the bytes consumed (>= 0, more input wanted) or -1 (done; `errcode` 0, or
// -1 overrun, -2 broken, -3 unknown data).
long long gs_fli_decode(const uint8_t* buf, long long bytes, uint8_t* im, long long xsize, long long ysize,
                  int* errcode) {
  auto i16 = [](const uint8_t* p) { return int(p[0]) | int(p[1]) << 8; };
  auto i32 = [](const uint8_t* p) {
    return int32_t(uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24);
  };
  *errcode = 0;
  if (bytes < 4) return 0;
  const uint8_t* ptr = buf;
  const long long framesize = uint32_t(i32(ptr));  // compared unsigned, as PIL's build does
  if (bytes + (bytes % 2) < framesize) return 0;  // one pad byte allowed
  if (bytes < 8) return *errcode = -1, -1;
  if (i16(ptr + 4) != 0xF1FA) return *errcode = -3, -1;
  const int chunks = i16(ptr + 6);
  ptr += 16;
  bytes -= 16;
  for (int c = 0; c < chunks; ++c) {
    if (bytes < 10) return *errcode = -1, -1;
    const uint8_t* data = ptr + 6;
    auto oob = [&](long long off) { return data + off > ptr + bytes; };
    long long x = 0, y = 0, i = 0;
    switch (i16(ptr + 4)) {
      case 4:
      case 11:
      case 18:
        break;
      case 7: {  // SS2
        const int lines = i16(data);
        data += 2;
        int l = 0;
        for (l = 0, y = 0; l < lines && y < ysize; ++l, ++y) {
          uint8_t* out = im + y * xsize;
          if (oob(2)) return *errcode = -1, -1;
          int packets = i16(data);
          data += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {
              y += 65536 - packets;
              if (y >= ysize) return *errcode = -1, -1;
              out = im + y * xsize;
            } else {
              out[xsize - 1] = uint8_t(packets);
            }
            if (oob(2)) return *errcode = -1, -1;
            packets = i16(data);
            data += 2;
          }
          int p = 0;
          for (p = 0, x = 0; p < packets; ++p) {
            if (oob(2)) return *errcode = -1, -1;
            x += data[0];
            if (data[1] >= 128) {
              if (oob(4)) return *errcode = -1, -1;
              i = 256 - data[1];
              if (x + i + i > xsize) break;
              for (long long j = 0; j < i; ++j) {
                out[x++] = data[2];
                out[x++] = data[3];
              }
              data += 4;
            } else {
              i = 2 * static_cast<long long>(data[1]);
              if (x + i > xsize) break;
              if (oob(2 + i)) return *errcode = -1, -1;
              std::memcpy(out + x, data + 2, i);
              data += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) return *errcode = -1, -1;
        break;
      }
      case 12: {  // LC
        y = i16(data);
        const long long ymax = y + i16(data + 2);
        data += 4;
        for (; y < ymax && y < ysize; ++y) {
          uint8_t* out = im + y * xsize;
          if (oob(1)) return *errcode = -1, -1;
          const int packets = *data++;
          int p = 0;
          for (p = 0, x = 0; p < packets; ++p, x += i) {
            if (oob(2)) return *errcode = -1, -1;
            x += data[0];
            if (data[1] & 0x80) {
              i = 256 - data[1];
              if (x + i > xsize) break;
              if (oob(3)) return *errcode = -1, -1;
              std::memset(out + x, data[2], i);
              data += 3;
            } else {
              i = data[1];
              if (x + i > xsize) break;
              if (oob(2 + i)) return *errcode = -1, -1;
              std::memcpy(out + x, data + 2, i);
              data += i + 2;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) return *errcode = -1, -1;
        break;
      }
      case 13:  // BLACK
        std::memset(im, 0, xsize * ysize);
        break;
      case 15:  // BRUN
        for (y = 0; y < ysize; ++y) {
          uint8_t* out = im + y * xsize;
          data += 1;  // the packet count, ignored
          for (x = 0; x < xsize; x += i) {
            if (oob(2)) return *errcode = -1, -1;
            if (data[0] & 0x80) {
              i = 256 - data[0];
              if (x + i > xsize) break;
              if (oob(i + 1)) return *errcode = -1, -1;
              std::memcpy(out + x, data + 1, i);
              data += i + 1;
            } else {
              i = data[0];
              if (x + i > xsize) break;
              std::memset(out + x, data[1], i);
              data += 2;
            }
          }
          if (x != xsize) return *errcode = -1, -1;
        }
        break;
      case 16:  // COPY
        if (INT32_MAX / xsize < ysize) return *errcode = -1, -1;
        if (data + xsize * ysize > ptr + bytes) return ptr - buf;
        for (y = 0; y < ysize; ++y) {
          std::memcpy(im + y * xsize, data, xsize);
          data += xsize;
        }
        break;
      default:
        return *errcode = -3, -1;
    }
    const long long advance = i32(ptr);
    if (advance == 0) return *errcode = -2, -1;
    if (advance < 0 || advance > bytes) return *errcode = -1, -1;
    ptr += advance;
    bytes -= advance;
  }
  return -1;
}

// One band of `size` bytes from `start`: *end the offset after the last
// byte read; returns what is left of the band's count (0: whole; negative:
// a packet past its end; positive: the file ended), and *got the bytes the
// band took (fewer than `size` where runs or literals were cut short).
long long gs_icns_rle_decode(const uint8_t* in, long long n, long long start, long long size, uint8_t* out,
                             long long* got, long long* end) {
  long long pos = start, left = size, at = 0;
  auto put = [&](const uint8_t* src, long long count) {
    const long long room = size - at;  // bytes past the band's pixels are dropped: PIL's band keeps the first ones
    if (count > room) count = room;
    if (count > 0) std::memcpy(out + at, src, count);
    at += count > 0 ? count : 0;
  };
  while (left > 0) {
    if (pos >= n) break;
    const int b = in[pos++];
    long long block;
    if (b & 0x80) {
      block = b - 125;
      if (pos < n) {
        const uint8_t v = in[pos++];
        for (long long k = 0; k < block; ++k) put(&v, 1);
      }
    } else {
      block = b + 1;
      const long long have = std::min(block, n - pos);
      put(in + pos, have);
      pos += have;
    }
    left -= block;
  }
  *got = at;
  *end = pos;
  return left;
}

int gs_sun_rle_decode(const uint8_t* in, long long n, long long start, long long row_bytes, long long rows,
                      uint8_t* out) {
  long long pos = start, x = 0, y = 0;
  for (;;) {
    long long count, extra = 0;
    uint8_t value;
    if (pos >= n) return fail("Sun raster RLE data that ends before the last row");
    if (in[pos] == 0x80) {
      if (n - pos < 2) return fail("Sun raster RLE data that ends before the last row");
      count = in[pos + 1];
      if (count == 0) {
        count = 1, value = 0x80, pos += 2;
      } else {
        if (n - pos < 3) return fail("Sun raster RLE data that ends before the last row");
        count += 1, value = in[pos + 2];
        if (x + count > row_bytes) extra = count - (row_bytes - x), count = row_bytes - x;
        pos += 3;
      }
    } else {
      count = 1, value = in[pos], pos += 1;
    }
    std::memset(out + y * row_bytes + x, value, count);
    for (;;) {
      x += count;
      if (x >= row_bytes) {
        x = 0;
        if (++y >= rows) return 0;
      }
      if (extra == 0) break;
      count = std::min(extra, row_bytes);
      std::memset(out + y * row_bytes, value, count);
      extra -= count;
    }
  }
}

int gs_msp_decode(const uint8_t* in, long long n, long long ysize, long long blank, uint8_t* out, long long cap,
                  long long* produced) {
  long long at = 0;
  auto put = [&](const uint8_t* src, long long count, bool repeat) {
    for (long long k = 0; k < count; ++k, ++at)
      if (at < cap) out[at] = repeat ? *src : src[k];
  };
  if (n < 32 + 2 * ysize) return fail("an MSP row map cut short (PIL: Truncated MSP file in row map)");
  long long pos = 32 + 2 * ysize;
  const uint8_t white = 0xFF;
  for (long long y = 0; y < ysize; ++y) {
    const long long rowlen = in[32 + 2 * y] | in[33 + 2 * y] << 8;
    if (rowlen == 0) {
      put(&white, blank, true);
      continue;
    }
    if (n - pos < rowlen)
      return fail("MSP row " + std::to_string(y) + " cut short (PIL: Truncated MSP file)");
    const uint8_t* row = in + pos;
    pos += rowlen;
    long long i = 0;
    while (i < rowlen) {
      const int kind = row[i++];
      if (kind == 0) {
        if (rowlen - i < 2) return fail("an MSP run cut short in row " + std::to_string(y) +
                                        " (PIL: Corrupted MSP file)");
        put(row + i + 1, row[i], true);
        i += 2;
      } else {
        put(row + i, std::min<long long>(kind, rowlen - i), false);
        i += kind;
      }
    }
  }
  *produced = at;
  return 0;
}

static inline int hex_value(uint8_t c) {
  if (c >= '0' && c <= '9') return c - '0';
  if (c >= 'a' && c <= 'f') return c - 'a' + 10;
  if (c >= 'A' && c <= 'F') return c - 'A' + 10;
  return 0;
}

int gs_xbm_decode(const uint8_t* in, long long n, long long size, uint8_t* out) {
  long long pos = 0;
  for (long long i = 0; i < size; ++i) {
    const void* hit = pos < n ? std::memchr(in + pos, 'x', n - pos) : nullptr;
    if (!hit) return fail("XBM data that ends before the last row");
    pos = static_cast<const uint8_t*>(hit) - in;
    if (n - pos < 3) return fail("XBM data that ends before the last row");
    out[i] = static_cast<uint8_t>(hex_value(in[pos + 1]) << 4 | hex_value(in[pos + 2]));
    pos += 3;
  }
  return 0;
}

int gs_pcd_decode(const uint8_t* in, long long xsize, long long ysize, const int16_t* lum, const int16_t* cb,
                  const int16_t* gb, const int16_t* cr, const int16_t* gr, uint8_t* out) {
  auto clip = [](int v) { return static_cast<uint8_t>(v <= 0 ? 0 : v >= 255 ? 255 : v); };
  for (long long y = 0; y < ysize; ++y) {
    const uint8_t* block = in + (y / 2) * 3 * xsize;
    const uint8_t* luma = block + (y % 2) * xsize;
    uint8_t* o = out + y * xsize * 3;
    for (long long x = 0; x < xsize; ++x, o += 3) {
      const int l = lum[luma[x]], c1 = block[(x + 4 * xsize) / 2], c2 = block[(x + 5 * xsize) / 2];
      o[0] = clip(l + cr[c2]);
      o[1] = clip(l + gr[c2] + gb[c1]);
      o[2] = clip(l + cb[c1]);
    }
  }
  return 0;
}

int gs_im_bit_decode(const uint8_t* in, long long n, int bits, long long xsize, long long ysize, float* out) {
  const unsigned long long mask = (1ull << bits) - 1;
  unsigned long long buffer = 0;
  long long count = 0, x = 0, y = ysize - 1;
  for (long long k = 0; k < n; ++k) {
    const uint8_t byte = in[k];
    buffer |= static_cast<unsigned long long>(byte) << count;
    count += 8;
    while (count >= bits) {
      const unsigned long long value = buffer & mask;
      if (count > 32) {
        buffer = byte >> (8 - (count - bits));
      } else {
        buffer >>= bits;
      }
      count -= bits;
      out[y * xsize + x] = static_cast<float>(value);
      if (++x >= xsize) {
        if (--y < 0) return 0;
        x = 0, count = 0;
      }
    }
  }
  return fail("IM image data that ends before the last row");
}

}  // extern "C"
