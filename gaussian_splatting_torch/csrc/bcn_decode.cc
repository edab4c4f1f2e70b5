// The block-compressed surfaces of a DDS file: host C++, built with the host
// compiler by utils/cuda_build.py at first use and loaded with ctypes
// (utils/dds.py, which reads the header and the uncompressed forms).
//
// gs_bcn_decode decodes the 4x4 blocks of one surface, in rows of blocks
// from the top left, into an (height, width, channels) uint8 image, the
// blocks past the right and bottom edges cropped, as PIL 12.1.0's bcn
// decoder gives them (found against PIL's output; Microsoft's BC6H and BC7
// format documentation for the layouts):
//
// - BC1 (DXT1), 8 bytes, RGBA: two 5:6:5 colours widened by repeating their
//   top bits; where the first is not above the second, the third colour is
//   their mean and the fourth transparent black, else the thirds between
//   them (integer division). BC2 (DXT3) and BC3 (DXT5), 16 bytes: the same
//   colour block after 8 bytes of alpha, always with the thirds; BC2's
//   alpha 4 bits a pixel (v * 17), BC3's a BC4 block.
// - BC4, 8 bytes, L: two 8-bit values, then six interpolated ((7 - i) a0 +
//   i a1) / 7 where a0 > a1, else four ((5 - i) a0 + i a1) / 5, 0 and 255;
//   3 bits a pixel. BC5, 16 bytes, RGB: two BC4 blocks for red and green,
//   blue 0; BC5S (signed) reads each endpoint as int8 + 128 and goes on as
//   BC4 does, blue 128.
// - BC6H, 16 bytes, RGB: the 14 modes (a reserved mode gives black), their
//   endpoint bit layouts, the first endpoint sign-extended where signed,
//   the others where signed or transformed, the deltas added modulo the
//   endpoint precision and, unlike the specification, not sign-extended
//   again (PIL reads the sum as a 16-bit signed value: negative only at 16
//   bits), unquantisation, 3-bit (two regions) or 4-bit indices with their
//   anchors, the weighted sum truncated (no rounding term), then (v * 31) /
//   64 (UF16) or (|v| * 31) / 32 with its sign (SF16) as a half float,
//   clamped to [0, 1] and truncated to 8 bits.
// - BC7, 16 bytes, RGBA: the 8 modes (partitions, rotation, index
//   selection, p-bits, the 2- and 3-subset partition and anchor tables);
//   a block whose first byte is 0 (no mode bit) reads (0, 0, 0, 255).
//
// It returns 0, or 1 where `size` holds fewer than the blocks the image
// needs (PIL: image file is truncated).
//
// gs_blp_dxt_decode decodes a BLP2 file's DXT1, DXT3 or DXT5 blocks as
// PIL's own Python decoders in BlpImagePlugin.py do, which differ from its
// bcn decoder above: the 5:6:5 colours are shifted up without repeating
// their top bits, DXT3 and DXT5 always take the thirds, DXT1's fourth
// colour is transparent black only where the first is not above the
// second, and the pixels are written as PIL's decoders yield them: every
// row of four pixels of every block, in rows of blocks (an image
// 4 * ceil(h / 4) rows by 4 * ceil(w / 4) pixels), RGB for DXT1 without
// alpha, else RGBA. utils/blp.py lays that stream out at the image's width,
// as PIL's raw decoder does.

#include <cstdint>
#include <cstring>

namespace {

struct Rgba {
  uint8_t r, g, b, a;
};

inline int get_bit(const uint8_t* s, int i) { return (s[i >> 3] >> (i & 7)) & 1; }

inline int get_bits(const uint8_t* s, int at, int n) {
  int v = 0;
  for (int k = 0; k < n; ++k) v |= get_bit(s, at + k) << k;
  return v;
}

// ---- BC1 to BC5 ----

Rgba from_565(unsigned x) {
  int r = (x & 0xF800) >> 8, g = (x & 0x7E0) >> 3, b = (x & 0x1F) << 3;
  return {uint8_t(r | r >> 5), uint8_t(g | g >> 6), uint8_t(b | b >> 5), 255};
}

void bc1_colours(const uint8_t* s, bool always_four, Rgba* out) {
  unsigned c0 = s[0] | s[1] << 8, c1 = s[2] | s[3] << 8;
  uint32_t lut = s[4] | s[5] << 8 | s[6] << 16 | uint32_t(s[7]) << 24;
  Rgba p[4] = {from_565(c0), from_565(c1), {}, {}};
  if (c0 > c1 || always_four) {
    p[2] = {uint8_t((2 * p[0].r + p[1].r) / 3), uint8_t((2 * p[0].g + p[1].g) / 3),
            uint8_t((2 * p[0].b + p[1].b) / 3), 255};
    p[3] = {uint8_t((p[0].r + 2 * p[1].r) / 3), uint8_t((p[0].g + 2 * p[1].g) / 3),
            uint8_t((p[0].b + 2 * p[1].b) / 3), 255};
  } else {
    p[2] = {uint8_t((p[0].r + p[1].r) / 2), uint8_t((p[0].g + p[1].g) / 2), uint8_t((p[0].b + p[1].b) / 2), 255};
    p[3] = {0, 0, 0, 0};
  }
  for (int i = 0; i < 16; ++i) out[i] = p[(lut >> (2 * i)) & 3];
}

// A BC4 block's 16 values, written `stride` bytes apart.
void bc4_values(const uint8_t* s, bool sign, uint8_t* out, int stride) {
  int a0 = sign ? int(int8_t(s[0])) + 128 : s[0], a1 = sign ? int(int8_t(s[1])) + 128 : s[1];
  uint8_t a[8] = {uint8_t(a0), uint8_t(a1)};
  if (a0 > a1) {
    for (int i = 1; i < 7; ++i) a[i + 1] = uint8_t(((7 - i) * a0 + i * a1) / 7);
  } else {
    for (int i = 1; i < 5; ++i) a[i + 1] = uint8_t(((5 - i) * a0 + i * a1) / 5);
    a[6] = 0;
    a[7] = 255;
  }
  uint64_t lut = 0;
  for (int i = 0; i < 6; ++i) lut |= uint64_t(s[2 + i]) << (8 * i);
  for (int i = 0; i < 16; ++i) out[i * stride] = a[(lut >> (3 * i)) & 7];
}

// ---- the BC7 and BC6H tables ----

// Subset of each pixel (bit i: pixel i) for the 64 two-subset partitions.
const uint16_t PARTITION2[64] = {
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80, 0xC800, 0xFFEC, 0xFE80, 0xE800, 0xFFE8,
    0xFF00, 0xFFF0, 0xF000, 0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310, 0x3100, 0x8CCE, 0x088C, 0x3110,
    0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C, 0xAAAA, 0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696,
    0xA55A, 0x73CE, 0x13C8, 0x324C, 0x3BDC, 0x6996, 0xC33C, 0x9966, 0x0660, 0x0272, 0x04E4, 0x4E40, 0x2720,
    0xC936, 0x936C, 0x39C6, 0x639C, 0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22};

// Subset of each pixel (bits 2i, 2i + 1: pixel i) for the 64 three-subset partitions.
const uint32_t PARTITION3[64] = {
    0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000, 0xA0A05050, 0x5555A0A0, 0x5A5A5050,
    0xAA550000, 0xAA555500, 0xAAAA5500, 0x90909090, 0x94949494, 0xA4A4A4A4, 0xA9A59450, 0x2A0A4250,
    0xA5945040, 0x0A425054, 0xA5A5A500, 0x55A0A0A0, 0xA8A85454, 0x6A6A4040, 0xA4A45000, 0x1A1A0500,
    0x0050A4A4, 0xAAA59090, 0x14696914, 0x69691400, 0xA08585A0, 0xAA821414, 0x50A4A450, 0x6A5A0200,
    0xA9A58000, 0x5090A0A8, 0xA8A09050, 0x24242424, 0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50,
    0x500AA550, 0xAAAA4444, 0x66660000, 0xA5A0A5A0, 0x50A050A0, 0x69286928, 0x44AAAA44, 0x66666600,
    0xAA444444, 0x54A854A8, 0x95809580, 0x96969600, 0xA85454A8, 0x80959580, 0xAA141414, 0x96960000,
    0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000, 0x40804080, 0xA9A8A9A8, 0xAAAAAA44, 0x2A4A5254};

// The anchor pixel of subset 1 of the two-subset partitions, and of
// subsets 1 and 2 of the three-subset ones (subset 0's is pixel 0).
const uint8_t ANCHOR2[64] = {15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
                             15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
                             15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
                             6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t ANCHOR3_1[64] = {3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
                               3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
                               8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
                               3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t ANCHOR3_2[64] = {15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
                               15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
                               15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
                               15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};

const int WEIGHTS2[4] = {0, 21, 43, 64};
const int WEIGHTS3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const int WEIGHTS4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const int* weights(int bits) { return bits == 2 ? WEIGHTS2 : bits == 3 ? WEIGHTS3 : WEIGHTS4; }

int subset_of(int subsets, int partition, int pixel) {
  if (subsets == 2) return (PARTITION2[partition] >> pixel) & 1;
  if (subsets == 3) return (PARTITION3[partition] >> (2 * pixel)) & 3;
  return 0;
}

bool is_anchor(int subsets, int partition, int pixel) {
  if (pixel == 0) return true;
  if (subsets == 2) return pixel == ANCHOR2[partition];
  if (subsets == 3) return pixel == ANCHOR3_1[partition] || pixel == ANCHOR3_2[partition];
  return false;
}

// ---- BC7 ----

struct Bc7Mode {
  int subsets, partition_bits, rotation_bits, selector_bits, colour_bits, alpha_bits, endpoint_pbit, shared_pbit,
      index_bits, index2_bits;
};

const Bc7Mode BC7_MODES[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0}, {3, 6, 0, 0, 5, 0, 0, 0, 2, 0},
    {2, 6, 0, 0, 7, 0, 1, 0, 2, 0}, {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

int widen(int v, int bits) {  // v of `bits` bits to 8, its top bits repeated below
  int x = (v << (8 - bits)) & 0xFF;
  return x | x >> bits;
}

void bc7_block(const uint8_t* s, Rgba* out) {
  if (s[0] == 0) {
    for (int i = 0; i < 16; ++i) out[i] = {0, 0, 0, 255};
    return;
  }
  int mode = 0;
  while (!((s[0] >> mode) & 1)) ++mode;
  const Bc7Mode& m = BC7_MODES[mode];
  int at = mode + 1;
  int partition = get_bits(s, at, m.partition_bits);
  at += m.partition_bits;
  int rotation = get_bits(s, at, m.rotation_bits);
  at += m.rotation_bits;
  int selector = get_bits(s, at, m.selector_bits);
  at += m.selector_bits;
  int n = 2 * m.subsets, ep[6][4];
  for (int c = 0; c < 3; ++c)
    for (int e = 0; e < n; ++e, at += m.colour_bits) ep[e][c] = get_bits(s, at, m.colour_bits);
  for (int e = 0; e < n; ++e, at += m.alpha_bits) ep[e][3] = m.alpha_bits ? get_bits(s, at, m.alpha_bits) : 255;
  int cb = m.colour_bits, ab = m.alpha_bits;
  if (m.endpoint_pbit || m.shared_pbit) {
    for (int e = 0; e < n; ++e) {
      int p = m.endpoint_pbit ? get_bit(s, at + e) : get_bit(s, at + e / 2);
      for (int c = 0; c < 3; ++c) ep[e][c] = ep[e][c] << 1 | p;
      if (ab) ep[e][3] = ep[e][3] << 1 | p;
    }
    at += m.endpoint_pbit ? n : n / 2;
    ++cb;
    if (ab) ++ab;
  }
  for (int e = 0; e < n; ++e) {
    for (int c = 0; c < 3; ++c) ep[e][c] = widen(ep[e][c], cb);
    if (ab) ep[e][3] = widen(ep[e][3], ab);
  }
  int colour_at = at, alpha_at = at + 16 * m.index_bits - m.subsets;
  const int *w1 = weights(m.index_bits), *w2 = m.index2_bits ? weights(m.index2_bits) : w1;
  for (int i = 0; i < 16; ++i) {
    int sub = subset_of(m.subsets, partition, i);
    int bits1 = m.index_bits - is_anchor(m.subsets, partition, i);
    int i1 = get_bits(s, colour_at, bits1), wc, wa;
    colour_at += bits1;
    if (m.index2_bits) {
      int bits2 = m.index2_bits - (i == 0);
      int i2 = get_bits(s, alpha_at, bits2);
      alpha_at += bits2;
      wc = selector ? w2[i2] : w1[i1];
      wa = selector ? w1[i1] : w2[i2];
    } else {
      wc = wa = w1[i1];
    }
    const int *e0 = ep[2 * sub], *e1 = ep[2 * sub + 1];
    uint8_t v[4];
    for (int c = 0; c < 4; ++c) {
      int w = c < 3 ? wc : wa;
      v[c] = uint8_t(((64 - w) * e0[c] + w * e1[c] + 32) >> 6);
    }
    if (rotation) {
      uint8_t t = v[rotation - 1];
      v[rotation - 1] = v[3];
      v[3] = t;
    }
    out[i] = {v[0], v[1], v[2], v[3]};
  }
}

// ---- BC6H ----

enum { R0, G0, B0, R1, G1, B1, R2, G2, B2, R3, G3, B3 };

// One field of a BC6H mode's endpoint bits, in the block's order: `count`
// bits of endpoint value `value` (r0 g0 b0 of region 0's first endpoint,
// r1 g1 b1 its second, r2 ... r3 ... region 1's), from bit `low` upwards,
// or from bit `low` downwards where `count` is negative.
struct Field {
  int8_t value, low, count;
};

struct Bc6Mode {
  int regions, transformed, endpoint_bits, delta_bits[3];
  Field fields[24];
};

// Microsoft's BC6H modes 1 to 14 (their mode bits: 00, 01, 00010, 00110, ...,
// 11110, 00011, 00111, 01011, 01111).
const Bc6Mode BC6_MODES[14] = {
    {2, 1, 10, {5, 5, 5}, {{G2, 4, 1}, {B2, 4, 1}, {B3, 4, 1}, {R0, 0, 10}, {G0, 0, 10}, {B0, 0, 10}, {R1, 0, 5},
                           {G3, 4, 1}, {G2, 0, 4}, {G1, 0, 5}, {B3, 0, 1}, {G3, 0, 4}, {B1, 0, 5}, {B3, 1, 1},
                           {B2, 0, 4}, {R2, 0, 5}, {B3, 2, 1}, {R3, 0, 5}, {B3, 3, 1}}},
    {2, 1, 7, {6, 6, 6}, {{G2, 5, 1}, {G3, 4, 1}, {G3, 5, 1}, {R0, 0, 7}, {B3, 0, 1}, {B3, 1, 1}, {B2, 4, 1},
                          {G0, 0, 7}, {B2, 5, 1}, {B3, 2, 1}, {G2, 4, 1}, {B0, 0, 7}, {B3, 3, 1}, {B3, 5, 1},
                          {B3, 4, 1}, {R1, 0, 6}, {G2, 0, 4}, {G1, 0, 6}, {G3, 0, 4}, {B1, 0, 6}, {B2, 0, 4},
                          {R2, 0, 6}, {R3, 0, 6}}},
    {2, 1, 11, {5, 4, 4}, {{R0, 0, 10}, {G0, 0, 10}, {B0, 0, 10}, {R1, 0, 5}, {R0, 10, 1}, {G2, 0, 4}, {G1, 0, 4},
                           {G0, 10, 1}, {B3, 0, 1}, {G3, 0, 4}, {B1, 0, 4}, {B0, 10, 1}, {B3, 1, 1}, {B2, 0, 4},
                           {R2, 0, 5}, {B3, 2, 1}, {R3, 0, 5}, {B3, 3, 1}}},
    {2, 1, 11, {4, 5, 4}, {{R0, 0, 10}, {G0, 0, 10}, {B0, 0, 10}, {R1, 0, 4}, {R0, 10, 1}, {G3, 4, 1}, {G2, 0, 4},
                           {G1, 0, 5}, {G0, 10, 1}, {G3, 0, 4}, {B1, 0, 4}, {B0, 10, 1}, {B3, 1, 1}, {B2, 0, 4},
                           {R2, 0, 4}, {B3, 0, 1}, {B3, 2, 1}, {R3, 0, 4}, {G2, 4, 1}, {B3, 3, 1}}},
    {2, 1, 11, {4, 4, 5}, {{R0, 0, 10}, {G0, 0, 10}, {B0, 0, 10}, {R1, 0, 4}, {R0, 10, 1}, {B2, 4, 1}, {G2, 0, 4},
                           {G1, 0, 4}, {G0, 10, 1}, {B3, 0, 1}, {G3, 0, 4}, {B1, 0, 5}, {B0, 10, 1}, {B2, 0, 4},
                           {R2, 0, 4}, {B3, 1, 1}, {B3, 2, 1}, {R3, 0, 4}, {B3, 4, 1}, {B3, 3, 1}}},
    {2, 1, 9, {5, 5, 5}, {{R0, 0, 9}, {B2, 4, 1}, {G0, 0, 9}, {G2, 4, 1}, {B0, 0, 9}, {B3, 4, 1}, {R1, 0, 5},
                          {G3, 4, 1}, {G2, 0, 4}, {G1, 0, 5}, {B3, 0, 1}, {G3, 0, 4}, {B1, 0, 5}, {B3, 1, 1},
                          {B2, 0, 4}, {R2, 0, 5}, {B3, 2, 1}, {R3, 0, 5}, {B3, 3, 1}}},
    {2, 1, 8, {6, 5, 5}, {{R0, 0, 8}, {G3, 4, 1}, {B2, 4, 1}, {G0, 0, 8}, {B3, 2, 1}, {G2, 4, 1}, {B0, 0, 8},
                          {B3, 3, 1}, {B3, 4, 1}, {R1, 0, 6}, {G2, 0, 4}, {G1, 0, 5}, {B3, 0, 1}, {G3, 0, 4},
                          {B1, 0, 5}, {B3, 1, 1}, {B2, 0, 4}, {R2, 0, 6}, {R3, 0, 6}}},
    {2, 1, 8, {5, 6, 5}, {{R0, 0, 8}, {B3, 0, 1}, {B2, 4, 1}, {G0, 0, 8}, {G2, 5, 1}, {G2, 4, 1}, {B0, 0, 8},
                          {G3, 5, 1}, {B3, 4, 1}, {R1, 0, 5}, {G3, 4, 1}, {G2, 0, 4}, {G1, 0, 6}, {G3, 0, 4},
                          {B1, 0, 5}, {B3, 1, 1}, {B2, 0, 4}, {R2, 0, 5}, {B3, 2, 1}, {R3, 0, 5}, {B3, 3, 1}}},
    {2, 1, 8, {5, 5, 6}, {{R0, 0, 8}, {B3, 1, 1}, {B2, 4, 1}, {G0, 0, 8}, {B2, 5, 1}, {G2, 4, 1}, {B0, 0, 8},
                          {B3, 5, 1}, {B3, 4, 1}, {R1, 0, 5}, {G3, 4, 1}, {G2, 0, 4}, {G1, 0, 5}, {B3, 0, 1},
                          {G3, 0, 4}, {B1, 0, 6}, {B2, 0, 4}, {R2, 0, 5}, {B3, 2, 1}, {R3, 0, 5}, {B3, 3, 1}}},
    {2, 0, 6, {6, 6, 6}, {{R0, 0, 6}, {G3, 4, 1}, {B3, 0, 1}, {B3, 1, 1}, {B2, 4, 1}, {G0, 0, 6}, {G2, 5, 1},
                          {B2, 5, 1}, {B3, 2, 1}, {G2, 4, 1}, {B0, 0, 6}, {G3, 5, 1}, {B3, 3, 1}, {B3, 5, 1},
                          {B3, 4, 1}, {R1, 0, 6}, {G2, 0, 4}, {G1, 0, 6}, {G3, 0, 4}, {B1, 0, 6}, {B2, 0, 4},
                          {R2, 0, 6}, {R3, 0, 6}}},
    {1, 0, 10, {10, 10, 10}, {{R0, 0, 10}, {G0, 0, 10}, {B0, 0, 10}, {R1, 0, 10}, {G1, 0, 10}, {B1, 0, 10}}},
    {1, 1, 11, {9, 9, 9}, {{R0, 0, 10}, {G0, 0, 10}, {B0, 0, 10}, {R1, 0, 9}, {R0, 10, 1}, {G1, 0, 9}, {G0, 10, 1},
                           {B1, 0, 9}, {B0, 10, 1}}},
    {1, 1, 12, {8, 8, 8}, {{R0, 0, 10}, {G0, 0, 10}, {B0, 0, 10}, {R1, 0, 8}, {R0, 11, -2}, {G1, 0, 8},
                           {G0, 11, -2}, {B1, 0, 8}, {B0, 11, -2}}},
    {1, 1, 16, {4, 4, 4}, {{R0, 0, 10}, {G0, 0, 10}, {B0, 0, 10}, {R1, 0, 4}, {R0, 15, -6}, {G1, 0, 4},
                           {G0, 15, -6}, {B1, 0, 4}, {B0, 15, -6}}},
};

int sign_extend(int v, int bits) { return (v & (1 << (bits - 1))) ? v - (1 << bits) : v; }

int unquantize(int v, int bits, bool sign) {
  if (!sign) {
    if (bits >= 15 || v == 0) return v;
    if (v == (1 << bits) - 1) return 0xFFFF;
    return ((v << 15) + 0x4000) >> (bits - 1);
  }
  v = int16_t(v & 0xFFFF);
  if (bits >= 16) return v;
  int negative = v < 0, x = negative ? -v : v;
  if (x != 0) x = x >= (1 << (bits - 1)) - 1 ? 0x7FFF : ((x << 15) + 0x4000) >> (bits - 1);
  return negative ? -x : x;
}

float half_to_float(unsigned h) {  // a finite half's exact value (no half here reaches infinity)
  unsigned e = (h >> 10) & 0x1F, m = h & 0x3FF;
  float v = e ? float(m | 0x400) * (1.0f / 1024.0f) : float(m) * (1.0f / 1024.0f);
  int shift = e ? int(e) - 15 : -14;
  for (; shift > 0; --shift) v *= 2.0f;
  for (; shift < 0; ++shift) v *= 0.5f;
  return (h & 0x8000) ? -v : v;
}

uint8_t bc6_channel(int v, bool sign) {
  unsigned h;
  if (sign)
    h = v < 0 ? 0x8000 | unsigned((-v * 31) / 32) : unsigned((v * 31) / 32);
  else
    h = unsigned((v * 31) / 64);
  float f = half_to_float(h & 0xFFFF);
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return uint8_t(f * 255.0f);
}

int bc6_mode_index(const uint8_t* s) {  // 0..13, or -1 for a reserved mode
  int low = s[0] & 3, five = s[0] & 0x1F;
  if (low < 2) return low;
  int index = (low == 2 ? 2 : 10) + (five >> 2);
  return index < 14 ? index : -1;
}

void bc6_block(const uint8_t* s, bool sign, Rgba* out) {
  int mode = bc6_mode_index(s);
  if (mode < 0) {
    for (int i = 0; i < 16; ++i) out[i] = {0, 0, 0, 0};
    return;
  }
  const Bc6Mode& m = BC6_MODES[mode];
  int at = mode < 2 ? 2 : 5;
  int ep[12] = {};
  for (const Field& f : m.fields) {
    if (f.count == 0) break;
    int n = f.count > 0 ? f.count : -f.count, step = f.count > 0 ? 1 : -1;
    for (int k = 0; k < n; ++k) ep[f.value] |= get_bit(s, at++) << (f.low + step * k);
  }
  int partition = m.regions == 2 ? get_bits(s, at, 5) : 0;
  at += m.regions == 2 ? 5 : 0;
  int n = 6 * m.regions, bits = m.endpoint_bits, mask = (1 << bits) - 1;
  if (sign)
    for (int c = 0; c < 3; ++c) ep[c] = sign_extend(ep[c], bits);
  if (sign || m.transformed)
    for (int e = 3; e < n; ++e) ep[e] = sign_extend(ep[e], m.delta_bits[e % 3]);
  if (m.transformed)  // not sign-extended again: a signed sum stays below 2^bits, negative only at 16 bits
    for (int e = 3; e < n; ++e) ep[e] = (ep[e] + ep[e % 3]) & mask;
  for (int e = 0; e < n; ++e) ep[e] = unquantize(ep[e], bits, sign);
  int index_bits = m.regions == 2 ? 3 : 4;
  const int* w = weights(index_bits);
  for (int i = 0; i < 16; ++i) {
    int region = subset_of(m.regions, partition, i);
    int b = index_bits - is_anchor(m.regions, partition, i);
    int wi = w[get_bits(s, at, b)];
    at += b;
    const int *e0 = ep + 6 * region, *e1 = e0 + 3;
    uint8_t v[3];
    for (int c = 0; c < 3; ++c) v[c] = bc6_channel((e0[c] * (64 - wi) + e1[c] * wi) >> 6, sign);
    out[i] = {v[0], v[1], v[2], 255};
  }
}

}  // namespace

extern "C" int gs_bcn_decode(const uint8_t* data, long long size, int n, int sign, long long width,
                             long long height, uint8_t* out) {
  long long bw = (width + 3) / 4, bh = (height + 3) / 4, bs = (n == 1 || n == 4) ? 8 : 16;
  if (size < bw * bh * bs) return 1;
  int channels = n == 4 ? 1 : (n == 5 || n == 6) ? 3 : 4;
  Rgba px[16];
  uint8_t grey[16];
  for (long long by = 0; by < bh; ++by) {
    for (long long bx = 0; bx < bw; ++bx, data += bs) {
      switch (n) {
        case 1: bc1_colours(data, false, px); break;
        case 2:
          bc1_colours(data + 8, true, px);
          for (int i = 0; i < 16; ++i) px[i].a = uint8_t(((data[i / 2] >> (4 * (i & 1))) & 15) * 17);
          break;
        case 3:
          bc1_colours(data + 8, true, px);
          bc4_values(data, false, &px[0].a, 4);
          break;
        case 4: bc4_values(data, false, grey, 1); break;
        case 5:
          for (Rgba& p : px) p = {0, 0, uint8_t(sign ? 128 : 0), 0};
          bc4_values(data, sign, &px[0].r, 4);
          bc4_values(data + 8, sign, &px[0].g, 4);
          break;
        case 6: bc6_block(data, sign, px); break;
        default: bc7_block(data, px); break;
      }
      for (int j = 0; j < 4; ++j) {
        long long y = 4 * by + j;
        if (y >= height) break;
        for (int i = 0; i < 4; ++i) {
          long long x = 4 * bx + i;
          if (x >= width) break;
          uint8_t* dst = out + (y * width + x) * channels;
          if (n == 4) {
            dst[0] = grey[4 * j + i];
          } else {
            const Rgba& p = px[4 * j + i];
            dst[0] = p.r, dst[1] = p.g, dst[2] = p.b;
            if (channels == 4) dst[3] = p.a;
          }
        }
      }
    }
  }
  return 0;
}

namespace {

void blp_565(unsigned c, int* rgb) {
  rgb[0] = int((c >> 11) & 0x1F) << 3;
  rgb[1] = int((c >> 5) & 0x3F) << 2;
  rgb[2] = int(c & 0x1F) << 3;
}

}  // namespace

// `kind` 1 (DXT1), 3 (DXT3) or 5 (DXT5); `alpha` DXT1's four channels;
// `out` takes (4 * ceil(height / 4), 4 * ceil(width / 4), 3 or 4) bytes.
extern "C" int gs_blp_dxt_decode(const uint8_t* data, long long size, int kind, int alpha, long long width,
                                 long long height, uint8_t* out) {
  const long long bw = (width + 3) / 4, bh = (height + 3) / 4, bs = kind == 1 ? 8 : 16;
  if (size < bw * bh * bs) return 1;
  const int channels = (kind == 1 && !alpha) ? 3 : 4;
  const long long row = 4 * bw * channels;
  for (long long by = 0; by < bh; ++by) {
    for (long long bx = 0; bx < bw; ++bx, data += bs) {
      const uint8_t* colour = kind == 1 ? data : data + 8;
      const unsigned c0 = colour[0] | colour[1] << 8, c1 = colour[2] | colour[3] << 8;
      const uint32_t code = uint32_t(colour[4]) | uint32_t(colour[5]) << 8 | uint32_t(colour[6]) << 16 |
                            uint32_t(colour[7]) << 24;
      int e0[3], e1[3];
      blp_565(c0, e0);
      blp_565(c1, e1);
      const bool four = kind != 1 || c0 > c1;
      uint64_t alpha_bits = 0;
      for (int k = 0; k < 6; ++k) alpha_bits |= uint64_t(data[2 + k]) << (8 * k);
      for (int p = 0; p < 16; ++p) {
        const int ctl = (code >> (2 * p)) & 3;
        int rgb[3], a = 255;
        for (int c = 0; c < 3; ++c) {
          if (ctl == 0) rgb[c] = e0[c];
          else if (ctl == 1) rgb[c] = e1[c];
          else if (ctl == 2) rgb[c] = four ? (2 * e0[c] + e1[c]) / 3 : (e0[c] + e1[c]) / 2;
          else rgb[c] = four ? (2 * e1[c] + e0[c]) / 3 : 0;
        }
        if (kind == 1) {
          if (ctl == 3 && !four) a = 0;
        } else if (kind == 3) {
          a = ((data[p / 2] >> (4 * (p & 1))) & 0xF) * 17;
        } else {
          const int a0 = data[0], a1 = data[1], ac = int((alpha_bits >> (3 * p)) & 7);
          if (ac == 0) a = a0;
          else if (ac == 1) a = a1;
          else if (a0 > a1) a = ((8 - ac) * a0 + (ac - 1) * a1) / 7;
          else if (ac == 6) a = 0;
          else if (ac == 7) a = 255;
          else a = ((6 - ac) * a0 + (ac - 1) * a1) / 5;
        }
        uint8_t* dst = out + (4 * by + p / 4) * row + (4 * bx + p % 4) * channels;
        dst[0] = uint8_t(rgb[0]), dst[1] = uint8_t(rgb[1]), dst[2] = uint8_t(rgb[2]);
        if (channels == 4) dst[3] = uint8_t(a);
      }
    }
  }
  return 0;
}
