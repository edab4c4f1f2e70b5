// AV1 intra decoding for AVIF images, following the AV1 Bitstream & Decoding
// Process Specification section by section (dav1d, which PIL's libavif
// decodes with, is bit-exact to it):
//
//   5.3-5.9, 5.11  OBUs, the sequence header (full and reduced), the
//                  uncompressed header of a shown key frame or an intra-only
//                  frame, tile info, the tile group;
//   8.2            the symbol decoder, CDF adaptation, disable_cdf_update;
//   5.11.5-5.11.39 intra mode info, transform sizes and types, coefficients;
//   5.11.46-50     palette mode info, the palette cache and colour tokens;
//   5.11.23-26, 5.11.31-32, 7.10.2
//                  IntraBC: use_intrabc, the spatial motion vector stack,
//                  the DV's prediction and read_mv at integer precision, the
//                  variable transform tree of an inter block and the inter
//                  transform sets;
//   7.11.2         intra prediction (DC, directional with edge filter and
//                  upsampling, smooth, Paeth, CfL, recursive filter intra);
//   7.11.3-4       IntraBC's prediction (the inter prediction process from
//                  the current frame, bilinear), palette prediction;
//   7.12-7.13      dequantization (quantizer matrices too) and the inverse
//                  transforms (DCT 4-64, ADST 4/8/16, identity, WHT) with
//                  the spec's rounding;
//   7.14           the deblocking loop filter, with delta lf and segments;
//   5.9.19, 7.15   CDEF, the constrained directional enhancement filter;
//   5.9.20, 5.11.57-58, 7.17
//                  loop restoration: the Wiener filter and the self-guided
//                  filter, per restoration unit and per 64-row stripe;
//   5.9.30, 7.18.3 film grain synthesis: the grain templates with their
//                  auto-regressive filter, the scaling lookups, the noise
//                  stripes with their block and stripe overlaps, the blend
//                  into the planes (dav1d applies it for PIL, bit-equal).
//
// Samples are 8, 10 or 12 bits (BitDepth): the decoder is a template on its
// sample type, uint8_t at 8 bits and uint16_t above, and every step takes
// the specification's BitDepth form (the quantizer lookups, the transforms'
// clamps, the clips, the prediction bases, the IntraBC and Wiener rounding,
// the loop filter's limits, CDEF's strengths and damping, the self-guided
// filter's shifts, the film grain's shift, scaling and ranges).
// What a frame *uses* of the tools this file does not decode (superres,
// palette colours above 8 bits, inter frames) ends the decode with a
// message naming the tool; so do film grain parameters dav1d refuses. The
// output is Y, U, V planes of the stream's depth (Y alone for 4:0:0).
// gs_yuv_to_rgb converts them to 8-bit RGB as libavif 1.3.0 does for PIL
// (libyuv's fixed-point rows and filtered chroma upsampling, its 10- and
// 12-bit rows, a downshift to 8 bits first, or libavif's own float path
// where libyuv declines).
#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <memory>
#include <string>
#include <vector>

#include "av1_tables.h"

namespace {

struct Refused {
  std::string what;
};
[[noreturn]] void fail(const std::string& what) { throw Refused{what}; }

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
inline int round2(int64_t x, int n) { return n == 0 ? (int)x : (int)((x + ((int64_t)1 << (n - 1))) >> n); }
inline int round2signed(int64_t x, int n) { return x >= 0 ? round2(x, n) : -round2(-x, n); }
inline int floor_log2(uint32_t x) { return 31 - __builtin_clz(x); }

// ---------------------------------------------------------------- constants
enum { KEY_FRAME = 0, INTER_FRAME = 1, INTRA_ONLY_FRAME = 2, SWITCH_FRAME = 3 };
enum {
  BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8, BLOCK_16X16, BLOCK_16X32,
  BLOCK_32X16, BLOCK_32X32, BLOCK_32X64, BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64,
  BLOCK_128X128, BLOCK_4X16, BLOCK_16X4, BLOCK_8X32, BLOCK_32X8, BLOCK_16X64, BLOCK_64X16,
  BLOCK_INVALID
};
enum {
  PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A,
  PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4
};
enum {
  DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED,
  SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED
};
enum {
  TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16, TX_16X8, TX_16X32,
  TX_32X16, TX_32X64, TX_64X32, TX_4X16, TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16
};
enum {
  DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST,
  ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST
};
enum { TX_SET_DCTONLY, TX_SET_INTRA_1, TX_SET_INTRA_2 };
enum { TX_SET_INTER_1 = 1, TX_SET_INTER_2, TX_SET_INTER_3 };
enum { MV_JOINT_ZERO, MV_JOINT_HNZVZ, MV_JOINT_HZVNZ, MV_JOINT_HNZVNZ };
const int MAX_VARTX_DEPTH = 2, MAX_REF_MV_STACK_SIZE = 8, REF_CAT_LEVEL = 640, MV_BORDER = 128;
const int INTRABC_DELAY_PIXELS = 256;
enum { TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT };
enum { ONLY_4X4, TX_MODE_LARGEST, TX_MODE_SELECT };

const int Num_4x4_Blocks_Wide[22] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 1, 4, 2, 8, 4, 16};
const int Num_4x4_Blocks_High[22] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 4, 1, 8, 2, 16, 4};
const int Mi_Width_Log2[22] = {0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 0, 2, 1, 3, 2, 4};
const int Mi_Height_Log2[22] = {0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4, 3, 4, 5, 4, 5, 2, 0, 3, 1, 4, 2};
inline int block_width(int b) { return 4 * Num_4x4_Blocks_Wide[b]; }
inline int block_height(int b) { return 4 * Num_4x4_Blocks_High[b]; }

const uint8_t Subsampled_Size[22][2][2] = {
    {{BLOCK_4X4, BLOCK_4X4}, {BLOCK_4X4, BLOCK_4X4}},
    {{BLOCK_4X8, BLOCK_4X4}, {BLOCK_INVALID, BLOCK_4X4}},
    {{BLOCK_8X4, BLOCK_INVALID}, {BLOCK_4X4, BLOCK_4X4}},
    {{BLOCK_8X8, BLOCK_8X4}, {BLOCK_4X8, BLOCK_4X4}},
    {{BLOCK_8X16, BLOCK_8X8}, {BLOCK_INVALID, BLOCK_4X8}},
    {{BLOCK_16X8, BLOCK_INVALID}, {BLOCK_8X8, BLOCK_8X4}},
    {{BLOCK_16X16, BLOCK_16X8}, {BLOCK_8X16, BLOCK_8X8}},
    {{BLOCK_16X32, BLOCK_16X16}, {BLOCK_INVALID, BLOCK_8X16}},
    {{BLOCK_32X16, BLOCK_INVALID}, {BLOCK_16X16, BLOCK_16X8}},
    {{BLOCK_32X32, BLOCK_32X16}, {BLOCK_16X32, BLOCK_16X16}},
    {{BLOCK_32X64, BLOCK_32X32}, {BLOCK_INVALID, BLOCK_16X32}},
    {{BLOCK_64X32, BLOCK_INVALID}, {BLOCK_32X32, BLOCK_32X16}},
    {{BLOCK_64X64, BLOCK_64X32}, {BLOCK_32X64, BLOCK_32X32}},
    {{BLOCK_64X128, BLOCK_64X64}, {BLOCK_INVALID, BLOCK_32X64}},
    {{BLOCK_128X64, BLOCK_INVALID}, {BLOCK_64X64, BLOCK_64X32}},
    {{BLOCK_128X128, BLOCK_128X64}, {BLOCK_64X128, BLOCK_64X64}},
    {{BLOCK_4X16, BLOCK_4X8}, {BLOCK_INVALID, BLOCK_4X8}},
    {{BLOCK_16X4, BLOCK_INVALID}, {BLOCK_8X4, BLOCK_8X4}},
    {{BLOCK_8X32, BLOCK_8X16}, {BLOCK_INVALID, BLOCK_4X16}},
    {{BLOCK_32X8, BLOCK_INVALID}, {BLOCK_16X8, BLOCK_16X4}},
    {{BLOCK_16X64, BLOCK_16X32}, {BLOCK_INVALID, BLOCK_8X32}},
    {{BLOCK_64X16, BLOCK_INVALID}, {BLOCK_32X16, BLOCK_32X8}},
};

const uint8_t Max_Tx_Size_Rect[22] = {TX_4X4,   TX_4X8,   TX_8X4,   TX_8X8,   TX_8X16,  TX_16X8,
                                      TX_16X16, TX_16X32, TX_32X16, TX_32X32, TX_32X64, TX_64X32,
                                      TX_64X64, TX_64X64, TX_64X64, TX_64X64, TX_4X16,  TX_16X4,
                                      TX_8X32,  TX_32X8,  TX_16X64, TX_64X16};
const int Max_Tx_Depth[22] = {0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 4, 4, 4, 2, 2, 3, 3, 4, 4};

const int Tx_Width[19] = {4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64};
const int Tx_Height[19] = {4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16};
const int Tx_Width_Log2[19] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4, 5, 5, 6, 2, 4, 3, 5, 4, 6};
const int Tx_Height_Log2[19] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5, 4, 6, 5, 4, 2, 5, 3, 6, 4};
const uint8_t Tx_Size_Sqr[19] = {TX_4X4,   TX_8X8,   TX_16X16, TX_32X32, TX_64X64, TX_4X4, TX_4X4,
                                 TX_8X8,   TX_8X8,   TX_16X16, TX_16X16, TX_32X32, TX_32X32, TX_4X4,
                                 TX_4X4,   TX_8X8,   TX_8X8,   TX_16X16, TX_16X16};
const uint8_t Tx_Size_Sqr_Up[19] = {TX_4X4,   TX_8X8,   TX_16X16, TX_32X32, TX_64X64, TX_8X8,   TX_8X8,
                                    TX_16X16, TX_16X16, TX_32X32, TX_32X32, TX_64X64, TX_64X64, TX_16X16,
                                    TX_16X16, TX_32X32, TX_32X32, TX_64X64, TX_64X64};
const uint8_t Split_Tx_Size[19] = {TX_4X4,   TX_4X4,   TX_8X8,   TX_16X16, TX_32X32, TX_4X4,  TX_4X4,
                                   TX_8X8,   TX_8X8,   TX_16X16, TX_16X16, TX_32X32, TX_32X32, TX_4X8,
                                   TX_8X4,   TX_8X16,  TX_16X8,  TX_16X32, TX_32X16};
const uint8_t Adjusted_Tx_Size[19] = {TX_4X4,   TX_8X8,   TX_16X16, TX_32X32, TX_32X32, TX_4X8,   TX_8X4,
                                      TX_8X16,  TX_16X8,  TX_16X32, TX_32X16, TX_32X32, TX_32X32, TX_4X16,
                                      TX_16X4,  TX_8X32,  TX_32X8,  TX_16X32, TX_32X16};
// where each transform size's quantizer matrix starts (the 64-point sizes
// use the 32-point ones, as their coefficients do)
const int Qm_Offset[19] = {0,    16,   80,   336,  336,  1360, 1392, 1424, 1552, 1680,
                           2192, 336,  336,  2704, 2768, 2832, 3088, 1680, 2192};
const int Transform_Row_Shift[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2};

const int Mode_To_Angle[13] = {0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0};
const int Intra_Mode_Context[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
const int Filter_Intra_Mode_To_Intra_Dir[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED};
const int Mode_To_Txfm[14] = {DCT_DCT,  ADST_DCT, DCT_ADST,  DCT_DCT,  ADST_ADST, ADST_DCT, DCT_ADST,
                              DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST,  ADST_ADST, DCT_DCT};
const int Tx_Type_Intra_Inv_Set1[7] = {IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
const int Tx_Type_Intra_Inv_Set2[5] = {IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
const int Tx_Type_Inter_Inv_Set1[16] = {IDTX,         V_DCT,        H_DCT,     V_ADST,
                                        H_ADST,       V_FLIPADST,   H_FLIPADST, DCT_DCT,
                                        ADST_DCT,     DCT_ADST,     FLIPADST_DCT, DCT_FLIPADST,
                                        ADST_ADST,    FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
const int Tx_Type_Inter_Inv_Set2[12] = {IDTX,         V_DCT,        H_DCT,     DCT_DCT,
                                        ADST_DCT,     DCT_ADST,     FLIPADST_DCT, DCT_FLIPADST,
                                        ADST_ADST,    FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
const int Tx_Type_Inter_Inv_Set3[2] = {IDTX, DCT_DCT};
// Tx_Type_In_Set_Inter[set][type], as bit masks over the 16 types
const int Tx_Type_In_Set_Inter[4] = {0x0001, 0xFFFF, 0x0FFF, 0x0201};

// CDEF (7.15)
const int Cdef_Uv_Dir[2][2][8] = {{{0, 1, 2, 3, 4, 5, 6, 7}, {1, 2, 2, 2, 3, 4, 6, 0}},
                                  {{7, 0, 2, 4, 5, 6, 6, 6}, {0, 1, 2, 3, 4, 5, 6, 7}}};
const int Cdef_Directions[8][2][2] = {{{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}}, {{0, 1}, {1, 2}},
                                      {{1, 1}, {2, 2}},   {{1, 0}, {2, 1}},  {{1, 0}, {2, 0}}, {{1, 0}, {2, -1}}};
const int Cdef_Pri_Taps[2][2] = {{4, 2}, {3, 3}};
const int Cdef_Sec_Taps[2][2] = {{2, 1}, {2, 1}};
const int Div_Table[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};

// loop restoration (5.9.20, 5.11.58, 7.17)
enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };
const int Remap_Lr_Type[4] = {RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ};
const int Wiener_Taps_Min[3] = {-5, -23, -17}, Wiener_Taps_Max[3] = {10, 8, 46}, Wiener_Taps_K[3] = {1, 2, 3};
const int Wiener_Taps_Mid[3] = {3, -7, 15};
const int Sgrproj_Xqd_Min[2] = {-96, -32}, Sgrproj_Xqd_Max[2] = {31, 95}, Sgrproj_Xqd_Mid[2] = {-32, 31};
enum { SGRPROJ_PRJ_SUBEXP_K = 4, SGRPROJ_PRJ_BITS = 7, SGRPROJ_RST_BITS = 4, SGRPROJ_MTABLE_BITS = 20,
       SGRPROJ_RECIP_BITS = 12, SGRPROJ_SGR_BITS = 8 };

const int Segmentation_Feature_Bits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
const int Segmentation_Feature_Signed[8] = {1, 1, 1, 1, 1, 0, 0, 0};
const int Segmentation_Feature_Max[8] = {255, 63, 63, 63, 63, 7, 0, 0};
enum { SEG_LVL_ALT_Q = 0, SEG_LVL_ALT_LF_Y_V = 1, SEG_LVL_SKIP = 6 };

const int Sig_Ref_Diff_Offset[3][5][2] = {
    {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
    {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
    {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
const int Mag_Ref_Offset_With_Tx_Class[3][3][2] = {
    {{0, 1}, {1, 0}, {1, 1}}, {{0, 1}, {1, 0}, {0, 2}}, {{0, 1}, {1, 0}, {2, 0}}};
const int Coeff_Base_Pos_Ctx_Offset[3] = {26, 31, 36};
const int Square_Ctx_Offset[5][5] = {
    {0, 1, 6, 6, 21}, {1, 6, 6, 21, 21}, {6, 6, 21, 21, 21}, {6, 21, 21, 21, 21}, {21, 21, 21, 21, 21}};

// Coeff_Base_Ctx_Offset[txSz][row][col] of the specification: the square
// pattern, the first two rows 11 in tall sizes, the first two columns 16
// in wide ones (the DC position 0 in all).
int coeff_base_ctx_offset(int txSz, int row, int col) {
  if (row == 0 && col == 0) return 0;
  int w = Tx_Width[txSz], h = Tx_Height[txSz];
  if (h > w && row < 2) return 11;
  if (w > h && col < 2) return 16;
  return Square_Ctx_Offset[row][col];
}

const int Cos128_Lookup[65] = {
    4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973, 3948, 3920, 3889, 3857, 3822, 3784,
    3745, 3703, 3659, 3612, 3564, 3513, 3461, 3406, 3349, 3290, 3229, 3166, 3102, 3035, 2967, 2896, 2824,
    2751, 2675, 2598, 2520, 2440, 2359, 2276, 2191, 2106, 2019, 1931, 1842, 1751, 1660, 1567, 1474, 1380,
    1285, 1189, 1092, 995,  897,  799,  700,  601,  501,  401,  301,  201,  101,  0};
const int Sinpi[5] = {0, 1321, 2482, 3344, 3803};
const int Intra_Edge_Kernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};

// ------------------------------------------------------------- bit reader
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;  // in bits
  BitReader(const uint8_t* d, size_t n) : data(d), size(n) {}
  int bit() {
    size_t byte = pos >> 3;
    if (byte >= size) fail("a header read past the end of its OBU");
    int b = (data[byte] >> (7 - (pos & 7))) & 1;
    pos++;
    return b;
  }
  uint32_t f(int n) {
    uint32_t x = 0;
    for (int i = 0; i < n; i++) x = 2 * x + bit();
    return x;
  }
  int su(int n) {
    int v = (int)f(n);
    int sign = 1 << (n - 1);
    if (v & sign) v -= 2 * sign;
    return v;
  }
  uint32_t ns(uint32_t n) {
    int w = floor_log2(n) + 1;
    uint32_t m = (1u << w) - n;
    uint32_t v = f(w - 1);
    if (v < m) return v;
    return (v << 1) - m + f(1);
  }
  uint32_t uvlc() {
    int lz = 0;
    while (!bit()) {
      if (++lz >= 32) return UINT32_MAX;
    }
    return lz >= 32 ? UINT32_MAX : f(lz) + (1u << lz) - 1;
  }
  void byte_align() { pos = (pos + 7) & ~(size_t)7; }
};

uint64_t leb128(const uint8_t* d, size_t n, size_t& at) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) {
    if (at >= n) fail("an OBU size cut short");
    uint8_t b = d[at++];
    v |= (uint64_t)(b & 0x7f) << (i * 7);
    if (!(b & 0x80)) return v;
  }
  return v;
}

// ---------------------------------------------------------- symbol decoder
struct SymbolDecoder {
  // The spec's SymbolValue / SymbolRange; its bit reads past the tile's
  // end (SymbolMaxBits) are zeros, which a zero-padded 64-bit window gives.
  const uint8_t *p, *end;
  uint64_t win;
  int cnt;
  uint32_t value, range;
  bool adapt;
  void refill() {
    while (cnt <= 56) {
      uint64_t b = p < end ? *p++ : 0;
      win |= b << (56 - cnt);
      cnt += 8;
    }
  }
  uint32_t read_bits(int n) {
    if (n == 0) return 0;
    if (cnt < n) refill();
    uint32_t r = (uint32_t)(win >> (64 - n));
    win <<= n;
    cnt -= n;
    return r;
  }
  void init(const uint8_t* d, size_t sz, bool disable_update) {
    p = d;
    end = d + sz;
    win = 0;
    cnt = 0;
    int num_bits = (int)std::min<size_t>(sz * 8, 15);
    uint32_t buf = read_bits(num_bits);
    uint32_t padded = buf << (15 - num_bits);
    value = ((1u << 15) - 1) ^ padded;
    range = 1u << 15;
    adapt = !disable_update;
  }
  int symbol(uint16_t* cdf, int N) {
    uint32_t cur = range, prev;
    int sym = -1;
    do {
      sym++;
      prev = cur;
      uint32_t f = (1u << 15) - cdf[sym];
      cur = ((range >> 8) * (f >> 6) >> 1) + 4 * (uint32_t)(N - sym - 1);
    } while (value < cur);
    range = prev - cur;
    value -= cur;
    int bits = 15 - floor_log2(range);
    range <<= bits;
    value = read_bits(bits) ^ (((value + 1) << bits) - 1);
    if (adapt) {
      int rate = 3 + (cdf[N] > 15) + (cdf[N] > 31) + std::min(floor_log2(N), 2);
      uint32_t tmp = 0;
      for (int i = 0; i < N - 1; i++) {
        if (i == sym) tmp = 1u << 15;
        if (tmp < cdf[i])
          cdf[i] -= (uint16_t)((cdf[i] - tmp) >> rate);
        else
          cdf[i] += (uint16_t)((tmp - cdf[i]) >> rate);
      }
      cdf[N] += (cdf[N] < 32);
    }
    return sym;
  }
  int boolean() {
    uint16_t cdf[3] = {1 << 14, 1 << 15, 0};
    bool a = adapt;
    adapt = false;
    int b = symbol(cdf, 2);
    adapt = a;
    return b;
  }
  uint32_t literal(int n) {
    uint32_t x = 0;
    for (int i = 0; i < n; i++) x = 2 * x + boolean();
    return x;
  }
};

// --------------------------------------------------------------- the CDFs
struct Cdfs {
  uint16_t y_mode[5][5][14];
  uint16_t uv_mode_cfl_not_allowed[13][14];
  uint16_t uv_mode_cfl_allowed[13][15];
  uint16_t angle_delta[8][8];
  uint16_t partition_w8[4][5];
  uint16_t partition_w16[4][11];
  uint16_t partition_w32[4][11];
  uint16_t partition_w64[4][11];
  uint16_t partition_w128[4][9];
  uint16_t tx_8x8[3][3];
  uint16_t tx_16x16[3][4];
  uint16_t tx_32x32[3][4];
  uint16_t tx_64x64[3][4];
  uint16_t filter_intra[22][3];
  uint16_t filter_intra_mode[6];
  uint16_t intra_tx_set1[2][13][8];
  uint16_t intra_tx_set2[3][13][6];
  uint16_t cfl_sign[9];
  uint16_t cfl_alpha[6][17];
  uint16_t palette_y_mode[7][3][3];
  uint16_t palette_uv_mode[2][3];
  uint16_t palette_y_size[7][8], palette_uv_size[7][8];
  uint16_t palette_color[2][7][5][9];
  uint16_t intrabc[3];
  uint16_t txfm_split[21][3];
  uint16_t inter_tx_set1[2][17], inter_tx_set2[13], inter_tx_set3[4][3];
  // MV_INTRABC_CONTEXT's motion vector CDFs ([comp]: 0 rows, 1 columns)
  uint16_t mv_joint[5], mv_class[2][12], mv_class0_bit[2][3], mv_sign[2][3], mv_bit[2][10][3];
  uint16_t skip[3][3];
  uint16_t segment_id[3][9];
  uint16_t delta_q[5];
  uint16_t delta_lf[5];
  uint16_t delta_lf_multi[4][5];
  uint16_t use_wiener[3], use_sgrproj[3], restoration_type[4];
  // coefficients, for the frame's qindex context
  uint16_t txb_skip[5][13][3];
  uint16_t eob_pt_16[2][2][6];
  uint16_t eob_pt_32[2][2][7];
  uint16_t eob_pt_64[2][2][8];
  uint16_t eob_pt_128[2][2][9];
  uint16_t eob_pt_256[2][2][10];
  uint16_t eob_pt_512[2][11];
  uint16_t eob_pt_1024[2][12];
  uint16_t eob_extra[5][2][9][3];
  uint16_t dc_sign[2][3][3];
  uint16_t coeff_base_eob[5][2][4][4];
  uint16_t coeff_base[5][2][42][5];
  uint16_t coeff_br[5][2][21][5];

  void init(int base_q_idx) {
    memcpy(y_mode, Default_Intra_Frame_Y_Mode_Cdf, sizeof y_mode);
    memcpy(uv_mode_cfl_not_allowed, Default_Uv_Mode_Cfl_Not_Allowed_Cdf, sizeof uv_mode_cfl_not_allowed);
    memcpy(uv_mode_cfl_allowed, Default_Uv_Mode_Cfl_Allowed_Cdf, sizeof uv_mode_cfl_allowed);
    memcpy(angle_delta, Default_Angle_Delta_Cdf, sizeof angle_delta);
    memcpy(partition_w8, Default_Partition_W8_Cdf, sizeof partition_w8);
    memcpy(partition_w16, Default_Partition_W16_Cdf, sizeof partition_w16);
    memcpy(partition_w32, Default_Partition_W32_Cdf, sizeof partition_w32);
    memcpy(partition_w64, Default_Partition_W64_Cdf, sizeof partition_w64);
    memcpy(partition_w128, Default_Partition_W128_Cdf, sizeof partition_w128);
    memcpy(tx_8x8, Default_Tx_8x8_Cdf, sizeof tx_8x8);
    memcpy(tx_16x16, Default_Tx_16x16_Cdf, sizeof tx_16x16);
    memcpy(tx_32x32, Default_Tx_32x32_Cdf, sizeof tx_32x32);
    memcpy(tx_64x64, Default_Tx_64x64_Cdf, sizeof tx_64x64);
    memcpy(filter_intra, Default_Filter_Intra_Cdfs, sizeof filter_intra);
    memcpy(filter_intra_mode, Default_Filter_Intra_Mode_Cdf, sizeof filter_intra_mode);
    memcpy(intra_tx_set1, Default_Intra_Tx_Type_Set1_Cdf, sizeof intra_tx_set1);
    memcpy(intra_tx_set2, Default_Intra_Tx_Type_Set2_Cdf, sizeof intra_tx_set2);
    memcpy(cfl_sign, Default_Cfl_Sign_Cdf, sizeof cfl_sign);
    memcpy(cfl_alpha, Default_Cfl_Alpha_Cdf, sizeof cfl_alpha);
    memcpy(palette_y_mode, Default_Palette_Y_Mode_Cdf, sizeof palette_y_mode);
    memcpy(palette_uv_mode, Default_Palette_Uv_Mode_Cdf, sizeof palette_uv_mode);
    memcpy(palette_y_size, Default_Palette_Y_Size_Cdf, sizeof palette_y_size);
    memcpy(palette_uv_size, Default_Palette_Uv_Size_Cdf, sizeof palette_uv_size);
    memcpy(palette_color, Default_Palette_Color_Cdf, sizeof palette_color);
    intrabc[0] = 30531;
    intrabc[1] = 32768;
    intrabc[2] = 0;
    memcpy(txfm_split, Default_Txfm_Split_Cdf, sizeof txfm_split);
    memcpy(inter_tx_set1, Default_Inter_Tx_Type_Set1_Cdf, sizeof inter_tx_set1);
    memcpy(inter_tx_set2, Default_Inter_Tx_Type_Set2_Cdf, sizeof inter_tx_set2);
    memcpy(inter_tx_set3, Default_Inter_Tx_Type_Set3_Cdf, sizeof inter_tx_set3);
    memcpy(mv_joint, Default_Mv_Joint_Cdf, sizeof mv_joint);
    for (int c = 0; c < 2; c++) {
      memcpy(mv_class[c], Default_Mv_Class_Cdf, sizeof mv_class[c]);
      memcpy(mv_class0_bit[c], Default_Mv_Class0_Bit_Cdf, sizeof mv_class0_bit[c]);
      memcpy(mv_sign[c], Default_Mv_Sign_Cdf, sizeof mv_sign[c]);
      memcpy(mv_bit[c], Default_Mv_Bit_Cdf, sizeof mv_bit[c]);
    }
    memcpy(skip, Default_Skip_Cdf, sizeof skip);
    memcpy(segment_id, Default_Segment_Id_Cdf, sizeof segment_id);
    memcpy(delta_q, Default_Delta_Q_Cdf, sizeof delta_q);
    memcpy(delta_lf, Default_Delta_Lf_Cdf, sizeof delta_lf);
    for (int i = 0; i < 4; i++) memcpy(delta_lf_multi[i], Default_Delta_Lf_Cdf, sizeof delta_lf);
    memcpy(use_wiener, Default_Use_Wiener_Cdf, sizeof use_wiener);
    memcpy(use_sgrproj, Default_Use_Sgrproj_Cdf, sizeof use_sgrproj);
    memcpy(restoration_type, Default_Restoration_Type_Cdf, sizeof restoration_type);
    int q = base_q_idx <= 20 ? 0 : base_q_idx <= 60 ? 1 : base_q_idx <= 120 ? 2 : 3;
    memcpy(txb_skip, Default_Txb_Skip_Cdf[q], sizeof txb_skip);
    memcpy(eob_pt_16, Default_Eob_Pt_16_Cdf[q], sizeof eob_pt_16);
    memcpy(eob_pt_32, Default_Eob_Pt_32_Cdf[q], sizeof eob_pt_32);
    memcpy(eob_pt_64, Default_Eob_Pt_64_Cdf[q], sizeof eob_pt_64);
    memcpy(eob_pt_128, Default_Eob_Pt_128_Cdf[q], sizeof eob_pt_128);
    memcpy(eob_pt_256, Default_Eob_Pt_256_Cdf[q], sizeof eob_pt_256);
    memcpy(eob_pt_512, Default_Eob_Pt_512_Cdf[q], sizeof eob_pt_512);
    memcpy(eob_pt_1024, Default_Eob_Pt_1024_Cdf[q], sizeof eob_pt_1024);
    memcpy(eob_extra, Default_Eob_Extra_Cdf[q], sizeof eob_extra);
    memcpy(dc_sign, Default_Dc_Sign_Cdf[q], sizeof dc_sign);
    memcpy(coeff_base_eob, Default_Coeff_Base_Eob_Cdf[q], sizeof coeff_base_eob);
    memcpy(coeff_base, Default_Coeff_Base_Cdf[q], sizeof coeff_base);
    memcpy(coeff_br, Default_Coeff_Br_Cdf[q], sizeof coeff_br);
  }
};

// --------------------------------------------------------- 1-D transforms
inline int cos128_of(int angle) {
  int a = angle & 255;
  if (a <= 64) return Cos128_Lookup[a];
  if (a <= 128) return -Cos128_Lookup[128 - a];
  if (a <= 192) return -Cos128_Lookup[a - 128];
  return Cos128_Lookup[256 - a];
}
inline int brev(int numBits, int x) {
  int r = 0;
  for (int i = 0; i < numBits; i++) r |= ((x >> i) & 1) << (numBits - 1 - i);
  return r;
}
// cos128 and sin128 of every angle (mod 256), and each size's bit reversal
struct TxTables {
  int cos[256], sin[256];
  uint8_t rev[7][64];
  TxTables() {
    for (int a = 0; a < 256; a++) {
      cos[a] = cos128_of(a);
      sin[a] = cos128_of(a - 64);
    }
    for (int n = 2; n <= 6; n++)
      for (int i = 0; i < (1 << n); i++) rev[n][i] = (uint8_t)brev(n, i);
  }
};
const TxTables kTx;

struct Tx1D {
  int32_t T[64];
  int lo, hi;  // the clamp of the Hadamard steps (dav1d's intermediate clip)
  void B(int a, int b, int angle, int flip) {
    int c = kTx.cos[angle & 255], sn = kTx.sin[angle & 255];
    int64_t x = (int64_t)T[a] * c - (int64_t)T[b] * sn;
    int64_t y = (int64_t)T[a] * sn + (int64_t)T[b] * c;
    T[a] = round2(x, 12);
    T[b] = round2(y, 12);
    if (flip) std::swap(T[a], T[b]);
  }
  void H(int a, int b, int flip) {
    if (flip) std::swap(a, b);
    int32_t x = T[a], y = T[b];
    T[a] = clip3(lo, hi, x + y);
    T[b] = clip3(lo, hi, x - y);
  }
  void dct(int n) {
    int n0 = 1 << n;
    int32_t copy[64];
    memcpy(copy, T, sizeof(int32_t) * n0);
    for (int i = 0; i < n0; i++) T[i] = copy[kTx.rev[n][i]];
    if (n == 6)
      for (int i = 0; i < 16; i++) B(32 + i, 63 - i, 63 - 4 * brev(4, i), 0);
    if (n >= 5)
      for (int i = 0; i < 8; i++) B(16 + i, 31 - i, 6 + (brev(3, 7 - i) << 3), 0);
    if (n == 6)
      for (int i = 0; i < 16; i++) H(32 + i * 2, 33 + i * 2, i & 1);
    if (n >= 4)
      for (int i = 0; i < 4; i++) B(8 + i, 15 - i, 12 + (brev(2, 3 - i) << 4), 0);
    if (n >= 5)
      for (int i = 0; i < 8; i++) H(16 + 2 * i, 17 + 2 * i, i & 1);
    if (n == 6)
      for (int i = 0; i < 4; i++)
        for (int j = 0; j < 2; j++) B(62 - i * 4 - j, 33 + i * 4 + j, 60 - 16 * brev(2, i) + 64 * j, 1);
    if (n >= 3)
      for (int i = 0; i < 2; i++) B(4 + i, 7 - i, 56 - 32 * i, 0);
    if (n >= 4)
      for (int i = 0; i < 4; i++) H(8 + 2 * i, 9 + 2 * i, i & 1);
    if (n >= 5)
      for (int i = 0; i < 2; i++)
        for (int j = 0; j < 2; j++) B(30 - 4 * i - j, 17 + 4 * i + j, 24 + (j << 6) + ((1 - i) << 5), 1);
    if (n == 6)
      for (int i = 0; i < 8; i++)
        for (int j = 0; j < 2; j++) H(32 + i * 4 + j, 35 + i * 4 - j, i & 1);
    for (int i = 0; i < 2; i++) B(2 * i, 1 + 2 * i, 32 + 16 * i, 1 - i);
    if (n >= 3)
      for (int i = 0; i < 2; i++) H(4 + 2 * i, 5 + 2 * i, i);
    if (n >= 4)
      for (int i = 0; i < 2; i++) B(14 - i, 9 + i, 48 + 64 * i, 1);
    if (n >= 5)
      for (int i = 0; i < 4; i++)
        for (int j = 0; j < 2; j++) H(16 + 4 * i + j, 19 + 4 * i - j, i & 1);
    if (n == 6)
      for (int i = 0; i < 2; i++)
        for (int j = 0; j < 4; j++) B(61 - i * 8 - j, 34 + i * 8 + j, 56 - i * 32 + (j >> 1) * 64, 1);
    for (int i = 0; i < 2; i++) H(i, 3 - i, 0);
    if (n >= 3) B(6, 5, 32, 1);
    if (n >= 4)
      for (int i = 0; i < 2; i++)
        for (int j = 0; j < 2; j++) H(8 + 4 * i + j, 11 + 4 * i - j, i);
    if (n >= 5)
      for (int i = 0; i < 4; i++) B(29 - i, 18 + i, 48 + (i >> 1) * 64, 1);
    if (n == 6)
      for (int i = 0; i < 4; i++)
        for (int j = 0; j < 4; j++) H(32 + 8 * i + j, 39 + 8 * i - j, i & 1);
    if (n >= 3)
      for (int i = 0; i < 4; i++) H(i, 7 - i, 0);
    if (n >= 4)
      for (int i = 0; i < 2; i++) B(13 - i, 10 + i, 32, 1);
    if (n >= 5)
      for (int i = 0; i < 2; i++)
        for (int j = 0; j < 4; j++) H(16 + i * 8 + j, 23 + i * 8 - j, i);
    if (n == 6)
      for (int i = 0; i < 8; i++) B(59 - i, 36 + i, i < 4 ? 48 : 112, 1);
    if (n >= 4)
      for (int i = 0; i < 8; i++) H(i, 15 - i, 0);
    if (n >= 5)
      for (int i = 0; i < 4; i++) B(27 - i, 20 + i, 32, 1);
    if (n == 6) {
      for (int i = 0; i < 8; i++) H(32 + i, 47 - i, 0);
      for (int i = 0; i < 8; i++) H(48 + i, 63 - i, 1);
    }
    if (n >= 5)
      for (int i = 0; i < 16; i++) H(i, 31 - i, 0);
    if (n == 6)
      for (int i = 0; i < 8; i++) B(55 - i, 40 + i, 32, 1);
    if (n == 6)
      for (int i = 0; i < 32; i++) H(i, 63 - i, 0);
  }
  void adst4() {
    int64_t s0 = (int64_t)Sinpi[1] * T[0], s1 = (int64_t)Sinpi[2] * T[0], s2 = (int64_t)Sinpi[3] * T[1];
    int64_t s3 = (int64_t)Sinpi[4] * T[2], s4 = (int64_t)Sinpi[1] * T[2], s5 = (int64_t)Sinpi[2] * T[3];
    int64_t s6 = (int64_t)Sinpi[4] * T[3];
    int32_t a7 = T[0] - T[2];
    int32_t b7 = a7 + T[3];
    s0 = s0 + s3;
    s1 = s1 - s4;
    s3 = s2;
    s2 = (int64_t)Sinpi[3] * b7;
    s0 = s0 + s5;
    s1 = s1 - s6;
    int64_t x0 = s0 + s3, x1 = s1 + s3, x2 = s2, x3 = s0 + s1;
    x3 = x3 - s3;
    T[0] = round2(x0, 12);
    T[1] = round2(x1, 12);
    T[2] = round2(x2, 12);
    T[3] = round2(x3, 12);
  }
  // half_btf of the reference decoders: Round2(w0 * in0 + w1 * in1, 12)
  static int32_t btf(int w0, int32_t in0, int w1, int32_t in1) {
    return round2((int64_t)w0 * in0 + (int64_t)w1 * in1, 12);
  }
  int32_t cl(int64_t v) const { return (int32_t)(v < lo ? lo : (v > hi ? hi : v)); }
  void adst8() {
    const int* c = Cos128_Lookup;  // cospi[k] = Cos128_Lookup[k] for k <= 64
    int32_t b[8], o[8];
    b[0] = T[7]; b[1] = T[0]; b[2] = T[5]; b[3] = T[2];
    b[4] = T[3]; b[5] = T[4]; b[6] = T[1]; b[7] = T[6];
    for (int i = 0; i < 4; i++) {
      int a = 4 + 16 * i;
      o[2 * i] = btf(c[a], b[2 * i], c[64 - a], b[2 * i + 1]);
      o[2 * i + 1] = btf(c[64 - a], b[2 * i], -c[a], b[2 * i + 1]);
    }
    for (int i = 0; i < 4; i++) {
      b[i] = cl((int64_t)o[i] + o[i + 4]);
      b[i + 4] = cl((int64_t)o[i] - o[i + 4]);
    }
    o[0] = b[0]; o[1] = b[1]; o[2] = b[2]; o[3] = b[3];
    o[4] = btf(c[16], b[4], c[48], b[5]);
    o[5] = btf(c[48], b[4], -c[16], b[5]);
    o[6] = btf(-c[48], b[6], c[16], b[7]);
    o[7] = btf(c[16], b[6], c[48], b[7]);
    b[0] = cl((int64_t)o[0] + o[2]); b[1] = cl((int64_t)o[1] + o[3]);
    b[2] = cl((int64_t)o[0] - o[2]); b[3] = cl((int64_t)o[1] - o[3]);
    b[4] = cl((int64_t)o[4] + o[6]); b[5] = cl((int64_t)o[5] + o[7]);
    b[6] = cl((int64_t)o[4] - o[6]); b[7] = cl((int64_t)o[5] - o[7]);
    o[0] = b[0]; o[1] = b[1]; o[4] = b[4]; o[5] = b[5];
    o[2] = btf(c[32], b[2], c[32], b[3]);
    o[3] = btf(c[32], b[2], -c[32], b[3]);
    o[6] = btf(c[32], b[6], c[32], b[7]);
    o[7] = btf(c[32], b[6], -c[32], b[7]);
    T[0] = o[0]; T[1] = -o[4]; T[2] = o[6]; T[3] = -o[2];
    T[4] = o[3]; T[5] = -o[7]; T[6] = o[5]; T[7] = -o[1];
  }
  void adst16() {
    const int* c = Cos128_Lookup;
    static const int perm[16] = {15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12, 1, 14};
    int32_t b[16], o[16];
    for (int i = 0; i < 16; i++) b[i] = T[perm[i]];
    for (int i = 0; i < 8; i++) {
      int a = 2 + 8 * i;
      o[2 * i] = btf(c[a], b[2 * i], c[64 - a], b[2 * i + 1]);
      o[2 * i + 1] = btf(c[64 - a], b[2 * i], -c[a], b[2 * i + 1]);
    }
    for (int i = 0; i < 8; i++) {
      b[i] = cl((int64_t)o[i] + o[i + 8]);
      b[i + 8] = cl((int64_t)o[i] - o[i + 8]);
    }
    for (int i = 0; i < 8; i++) o[i] = b[i];
    o[8] = btf(c[8], b[8], c[56], b[9]);
    o[9] = btf(c[56], b[8], -c[8], b[9]);
    o[10] = btf(c[40], b[10], c[24], b[11]);
    o[11] = btf(c[24], b[10], -c[40], b[11]);
    o[12] = btf(-c[56], b[12], c[8], b[13]);
    o[13] = btf(c[8], b[12], c[56], b[13]);
    o[14] = btf(-c[24], b[14], c[40], b[15]);
    o[15] = btf(c[40], b[14], c[24], b[15]);
    for (int i = 0; i < 4; i++) {
      b[i] = cl((int64_t)o[i] + o[i + 4]);
      b[i + 4] = cl((int64_t)o[i] - o[i + 4]);
      b[8 + i] = cl((int64_t)o[8 + i] + o[12 + i]);
      b[12 + i] = cl((int64_t)o[8 + i] - o[12 + i]);
    }
    for (int i = 0; i < 16; i++) o[i] = b[i];
    for (int k = 4; k <= 12; k += 8) {
      o[k] = btf(c[16], b[k], c[48], b[k + 1]);
      o[k + 1] = btf(c[48], b[k], -c[16], b[k + 1]);
      o[k + 2] = btf(-c[48], b[k + 2], c[16], b[k + 3]);
      o[k + 3] = btf(c[16], b[k + 2], c[48], b[k + 3]);
    }
    for (int k = 0; k < 16; k += 4) {
      b[k] = cl((int64_t)o[k] + o[k + 2]);
      b[k + 1] = cl((int64_t)o[k + 1] + o[k + 3]);
      b[k + 2] = cl((int64_t)o[k] - o[k + 2]);
      b[k + 3] = cl((int64_t)o[k + 1] - o[k + 3]);
    }
    for (int i = 0; i < 16; i++) o[i] = b[i];
    for (int k = 2; k < 16; k += 4) {
      o[k] = btf(c[32], b[k], c[32], b[k + 1]);
      o[k + 1] = btf(c[32], b[k], -c[32], b[k + 1]);
    }
    static const int out[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
    for (int i = 0; i < 16; i++) T[i] = (i & 1) ? -o[out[i]] : o[out[i]];
  }
  void identity(int n) {
    int n0 = 1 << n;
    for (int i = 0; i < n0; i++) {
      int64_t t = T[i];
      if (n == 2) T[i] = round2(t * 5793, 12);
      else if (n == 3) T[i] = (int32_t)(t * 2);
      else if (n == 4) T[i] = round2(t * 11586, 12);
      else T[i] = (int32_t)(t * 4);
    }
  }
  void wht(int shift) {
    int32_t a = T[0] >> shift, c = T[1] >> shift, d = T[2] >> shift, b = T[3] >> shift;
    a += c;
    d -= b;
    int32_t e = (a - d) >> 1;
    b = e - b;
    c = e - c;
    a -= b;
    d += c;
    T[0] = a; T[1] = b; T[2] = c; T[3] = d;
  }
};

// ------------------------------------------------------------------ decoder
struct SeqHeader {
  int profile = 0, still_picture = 0, reduced = 0;
  int timing_info_present = 0, decoder_model_info_present = 0, equal_picture_interval = 0;
  int buffer_delay_length = 0, buffer_removal_time_length = 0, frame_presentation_time_length = 0;
  int op_cnt = 1;
  int op_idc[32] = {0};
  int decoder_model_present_for_op[32] = {0};
  int frame_width_bits = 0, frame_height_bits = 0, max_w = 0, max_h = 0;
  int frame_id_numbers_present = 0, delta_frame_id_length = 0, additional_frame_id_length = 0;
  int use_128 = 0, enable_filter_intra = 0, enable_intra_edge_filter = 0;
  int enable_order_hint = 0, order_hint_bits = 0;
  int seq_force_screen_content_tools = 2, seq_force_integer_mv = 2;
  int enable_superres = 0, enable_cdef = 0, enable_restoration = 0;
  int bit_depth = 8, mono = 0, cp = 2, tc = 2, mc = 2, color_range = 0, ss_x = 1, ss_y = 1;
  int separate_uv_delta_q = 0, film_grain_params_present = 0;
  bool seen = false;
};

template <typename Pixel>
struct Decoder {
  SeqHeader seq;
  int BitDepth = 8, PixelMax = 255;  // from the sequence header
  // frame header
  int frame_type = 0, show_frame = 1, showable_frame = 0, error_resilient = 0, disable_cdf_update = 0;
  int allow_screen_content_tools = 0, allow_intrabc = 0, FrameIsIntra = 1;
  int FrameWidth = 0, FrameHeight = 0, MiCols = 0, MiRows = 0;
  int TileCols = 1, TileRows = 1, TileColsLog2 = 0, TileRowsLog2 = 0, TileSizeBytes = 4;
  int MiColStarts[65], MiRowStarts[65];
  int base_q_idx = 0, DeltaQYDc = 0, DeltaQUDc = 0, DeltaQUAc = 0, DeltaQVDc = 0, DeltaQVAc = 0;
  int using_qmatrix = 0, qm_y = 15, qm_u = 15, qm_v = 15;
  int segmentation_enabled = 0, FeatureEnabled[8][8] = {{0}}, FeatureData[8][8] = {{0}};
  int SegIdPreSkip = 0, LastActiveSegId = 0;
  int delta_q_present = 0, delta_q_res = 0, delta_lf_present = 0, delta_lf_res = 0, delta_lf_multi = 0;
  int LosslessArray[8] = {0}, CodedLossless = 0, AllLossless = 0;
  int loop_filter_level[4] = {0}, loop_filter_sharpness = 0, loop_filter_delta_enabled = 0;
  int loop_filter_ref_deltas[8] = {1, 0, 0, 0, -1, 0, -1, -1}, loop_filter_mode_deltas[2] = {0, 0};
  int TxMode = 0, reduced_tx_set = 0;
  int NumPlanes = 3;
  int CdefDamping = 3, cdef_bits = 0;
  int cdef_y_pri[8] = {0}, cdef_y_sec[8] = {0}, cdef_uv_pri[8] = {0}, cdef_uv_sec[8] = {0};
  int FrameRestorationType[3] = {0}, LoopRestorationSize[3] = {0}, UsesLr = 0, lr_unit_shift = 0, lr_uv_shift = 0;
  // film_grain_params (5.9.30): points[plane][i] = (value, scaling); the
  // AR coefficients, mults and offsets as coded (plus 128, 128, 256)
  struct FilmGrain {
    int apply_grain = 0, grain_seed = 0, num_points[3] = {0}, points[3][16][2] = {{{0}}};
    int chroma_scaling_from_luma = 0, grain_scaling_minus_8 = 0, ar_coeff_lag = 0;
    int ar_coeffs[3][25] = {{0}}, ar_coeff_shift_minus_6 = 0, grain_scale_shift = 0;
    int mult[3] = {0}, luma_mult[3] = {0}, offset[3] = {0}, overlap_flag = 0, clip_to_restricted_range = 0;
  } fg;
  bool frame_done = false;

  // frame state, per 4x4 (mi) unit
  int stride_mi = 0;
  std::vector<uint8_t> YModes, UVModes, MiSizes, Skips, SegmentIds, InterTxSizes, IsInters;
  std::vector<uint8_t> PaletteSizes[2], PaletteColors[2];  // 8 colours per mi
  std::vector<int16_t> Mvs;  // IntraBC's DV per mi: row, column (1/8 sample)
  std::vector<uint8_t> Decoded;  // the mi has been decoded in this frame
  std::vector<int8_t> DeltaLFs;  // 4 per mi
  std::vector<uint8_t> TxTypes;  // per luma 4x4
  std::vector<uint8_t> LfTxSizes[3];
  // planes (with room for whole superblocks past the frame's edge)
  int pw[3] = {0}, ph[3] = {0};
  std::vector<Pixel> plane[3];

  // tile state
  int MiRowStart, MiRowEnd, MiColStart, MiColEnd, CurrentQIndex;
  int DeltaLF[4];
  Cdfs cdf, frame_cdf;
  SymbolDecoder sd;
  std::vector<uint8_t> AboveLevelContext[3], AboveDcContext[3], LeftLevelContext[3], LeftDcContext[3];
  std::vector<int8_t> cdef_idx;
  uint8_t BlockDecoded[3][34][34];  // [-1..32]
  // loop restoration: each plane's units (5.11.58) and the references their
  // coefficients are coded against (reset at each tile's start)
  struct LrUnit {
    int type = RESTORE_NONE, set = 0;
    int wiener[2][3] = {{0}};  // [pass: 0 vertical, 1 horizontal][tap]
    int xqd[2] = {0};
  };
  int unitRows[3] = {0}, unitCols[3] = {0};
  std::vector<LrUnit> LrUnits[3];
  int RefLrWiener[3][2][3], RefSgrXqd[3][2];
  // the deblocked planes, which CDEF reads and loop restoration reads above
  // and below each stripe
  std::vector<Pixel> deblocked[3];
  // which tools the frame used (gs_av1_decode's `tools`; a test hook)
  int tools[72] = {0};

  // block state
  int MiRow, MiCol, MiSize, HasChroma, AvailU, AvailL, AvailUChroma, AvailLChroma;
  int segment_id, skip, Lossless, YMode, UVMode, AngleDeltaY, AngleDeltaUV;
  int CflAlphaU, CflAlphaV, use_filter_intra, filter_intra_mode, TxSize, ReadDeltas;
  int MaxLumaW, MaxLumaH, PlaneTxType;
  // palette (5.11.46): sizes, colours, colour index maps ([row][column])
  int PaletteSizeY, PaletteSizeUV;
  int palette_colors_y[8], palette_colors_u[8], palette_colors_v[8];
  uint8_t ColorMapY[64][64], ColorMapUV[64][64];
  // IntraBC: is_inter (use_intrabc), its DV (row, column), the motion
  // vector stack
  int is_inter, Mv[2];
  int NumMvFound, RefStackMv[MAX_REF_MV_STACK_SIZE][2], WeightStack[MAX_REF_MV_STACK_SIZE];
  int32_t Quant[1024];
  // per-decoder working buffers (a decoder is per thread): the dequantized block
  // (zeros between blocks), the coefficient levels read so far with 4
  // zero rows and columns of padding, CfL's luma
  int32_t D[64][64] = {{0}};
  uint8_t lv[(32 + 4) * (32 + 4)];
  int L[64][64];
  const int16_t* cur_scan = nullptr;  // the last coeffs() call's scan and eob, for reconstruct()
  int cur_eob = 0;

  Pixel& P(int p, int y, int x) { return plane[p][(size_t)y * pw[p] + x]; }
  int clip1(int v) const { return clip3(0, PixelMax, v); }
  size_t mi(int r, int c) const { return (size_t)r * stride_mi + c; }

  // -------------------------------------------------------------- headers
  void sequence_header(BitReader& b) {
    SeqHeader& s = seq;
    s = SeqHeader();
    s.seen = true;
    s.profile = b.f(3);
    s.still_picture = b.f(1);
    s.reduced = b.f(1);
    if (s.profile > 2) fail("an AV1 sequence profile above 2");
    if (s.reduced) {
      s.op_idc[0] = 0;
      b.f(5);  // seq_level_idx
    } else {
      s.timing_info_present = b.f(1);
      if (s.timing_info_present) {
        b.f(32);
        b.f(32);
        s.equal_picture_interval = b.f(1);
        if (s.equal_picture_interval) b.uvlc();
        s.decoder_model_info_present = b.f(1);
        if (s.decoder_model_info_present) {
          int buffer_delay_length = b.f(5) + 1;
          b.f(32);
          s.buffer_removal_time_length = b.f(5) + 1;
          s.frame_presentation_time_length = b.f(5) + 1;
          s.buffer_delay_length = buffer_delay_length;
        }
      }
      int initial_display_delay_present = b.f(1);
      s.op_cnt = b.f(5) + 1;
      for (int i = 0; i < s.op_cnt; i++) {
        s.op_idc[i] = b.f(12);
        int level = b.f(5);
        if (level > 7) b.f(1);
        if (s.decoder_model_info_present) {
          s.decoder_model_present_for_op[i] = b.f(1);
          if (s.decoder_model_present_for_op[i]) {
            int n = s.buffer_delay_length;
            b.f(n);
            b.f(n);
            b.f(1);
          }
        }
        if (initial_display_delay_present) {
          if (b.f(1)) b.f(4);
        }
      }
    }
    s.frame_width_bits = b.f(4) + 1;
    s.frame_height_bits = b.f(4) + 1;
    s.max_w = b.f(s.frame_width_bits) + 1;
    s.max_h = b.f(s.frame_height_bits) + 1;
    if (!s.reduced) s.frame_id_numbers_present = b.f(1);
    if (s.frame_id_numbers_present) {
      s.delta_frame_id_length = b.f(4) + 2;
      s.additional_frame_id_length = b.f(3) + 1;
    }
    s.use_128 = b.f(1);
    s.enable_filter_intra = b.f(1);
    s.enable_intra_edge_filter = b.f(1);
    if (!s.reduced) {
      b.f(1);  // enable_interintra_compound
      b.f(1);  // enable_masked_compound
      b.f(1);  // enable_warped_motion
      b.f(1);  // enable_dual_filter
      s.enable_order_hint = b.f(1);
      if (s.enable_order_hint) {
        b.f(1);  // enable_jnt_comp
        b.f(1);  // enable_ref_frame_mvs
      }
      int choose = b.f(1);
      s.seq_force_screen_content_tools = choose ? 2 : b.f(1);
      if (s.seq_force_screen_content_tools > 0) {
        int choose_mv = b.f(1);
        s.seq_force_integer_mv = choose_mv ? 2 : b.f(1);
      } else {
        s.seq_force_integer_mv = 2;
      }
      if (s.enable_order_hint) s.order_hint_bits = b.f(3) + 1;
    }
    s.enable_superres = b.f(1);
    s.enable_cdef = b.f(1);
    s.enable_restoration = b.f(1);
    // color_config
    int high_bitdepth = b.f(1);
    if (s.profile == 2 && high_bitdepth) s.bit_depth = b.f(1) ? 12 : 10;
    else s.bit_depth = high_bitdepth ? 10 : 8;
    s.mono = s.profile == 1 ? 0 : b.f(1);
    if (b.f(1)) {
      s.cp = b.f(8);
      s.tc = b.f(8);
      s.mc = b.f(8);
    }
    if (s.mono) {
      s.color_range = b.f(1);
      s.ss_x = s.ss_y = 1;
      s.separate_uv_delta_q = 0;
    } else {
      if (s.cp == 1 && s.tc == 13 && s.mc == 0) {
        s.color_range = 1;
        s.ss_x = s.ss_y = 0;
      } else {
        s.color_range = b.f(1);
        if (s.profile == 0) {
          s.ss_x = s.ss_y = 1;
        } else if (s.profile == 1) {
          s.ss_x = s.ss_y = 0;
        } else {
          if (s.bit_depth == 12) {
            s.ss_x = b.f(1);
            s.ss_y = s.ss_x ? b.f(1) : 0;
          } else {
            s.ss_x = 1;
            s.ss_y = 0;
          }
        }
        if (s.ss_x && s.ss_y) b.f(2);  // chroma_sample_position
      }
      s.separate_uv_delta_q = b.f(1);
    }
    s.film_grain_params_present = b.f(1);
    BitDepth = s.bit_depth;
    PixelMax = (1 << BitDepth) - 1;
  }

  int read_delta_q(BitReader& b) { return b.f(1) ? b.su(7) : 0; }

  int get_qindex(int ignoreDeltaQ, int segmentId) {
    if (segmentation_enabled && FeatureEnabled[segmentId][SEG_LVL_ALT_Q]) {
      int data = FeatureData[segmentId][SEG_LVL_ALT_Q];
      int q = base_q_idx + data;
      if (!ignoreDeltaQ && delta_q_present) q = CurrentQIndex + data;
      return clip3(0, 255, q);
    }
    if (!ignoreDeltaQ && delta_q_present) return CurrentQIndex;
    return base_q_idx;
  }

  static int tile_log2(int blk, int target) {
    int k = 0;
    while ((blk << k) < target) k++;
    return k;
  }

  void frame_header(BitReader& b, int temporal_id, int spatial_id) {
    const SeqHeader& s = seq;
    if (!s.seen) fail("a frame before the sequence header");
    int idLen = s.frame_id_numbers_present ? s.additional_frame_id_length + s.delta_frame_id_length : 0;
    if (s.reduced) {
      frame_type = KEY_FRAME;
      FrameIsIntra = 1;
      show_frame = 1;
      showable_frame = 0;
      error_resilient = 1;
    } else {
      if (b.f(1)) fail("show_existing_frame (a frame shown from an AV1 sequence's references)");
      frame_type = b.f(2);
      FrameIsIntra = frame_type == INTRA_ONLY_FRAME || frame_type == KEY_FRAME;
      if (!FrameIsIntra) fail("an inter frame (AV1 inter prediction)");
      show_frame = b.f(1);
      // the picture shown is the first frame decoded: a hidden one is not it
      if (!show_frame) fail("a frame that is not shown (show_frame 0) first in the AV1 data");
      if (show_frame && s.decoder_model_info_present && !s.equal_picture_interval)
        b.f(s.frame_presentation_time_length);
      showable_frame = show_frame ? frame_type != KEY_FRAME : b.f(1);
      if (frame_type == SWITCH_FRAME || (frame_type == KEY_FRAME && show_frame)) error_resilient = 1;
      else error_resilient = b.f(1);
    }
    disable_cdf_update = b.f(1);
    allow_screen_content_tools = s.seq_force_screen_content_tools == 2 ? b.f(1) : s.seq_force_screen_content_tools;
    // force_integer_mv: 1 in an intra frame whatever is coded (IntraBC's DVs
    // are whole samples)
    if (allow_screen_content_tools && s.seq_force_integer_mv == 2) b.f(1);
    if (s.frame_id_numbers_present) b.f(idLen);  // current_frame_id
    int frame_size_override_flag = s.reduced ? 0 : b.f(1);
    b.f(s.order_hint_bits);  // order_hint
    // primary_ref_frame: PRIMARY_REF_NONE for intra frames
    if (s.decoder_model_info_present) {
      int buffer_removal_time_present = b.f(1);
      if (buffer_removal_time_present) {
        for (int op = 0; op < s.op_cnt; op++) {
          if (s.decoder_model_present_for_op[op]) {
            int idc = s.op_idc[op];
            int inT = (idc >> temporal_id) & 1, inS = (idc >> (spatial_id + 8)) & 1;
            if (idc == 0 || (inT && inS)) b.f(s.buffer_removal_time_length);
          }
        }
      }
    }
    allow_intrabc = 0;
    int refresh_frame_flags = (frame_type == KEY_FRAME && show_frame) ? 0xFF : (int)b.f(8);
    if (refresh_frame_flags != 0xFF && error_resilient && s.enable_order_hint)
      for (int i = 0; i < 8; i++) b.f(s.order_hint_bits);
    // frame_size
    if (frame_size_override_flag) {
      FrameWidth = b.f(s.frame_width_bits) + 1;
      FrameHeight = b.f(s.frame_height_bits) + 1;
    } else {
      FrameWidth = s.max_w;
      FrameHeight = s.max_h;
    }
    if (s.enable_superres && b.f(1)) fail("superres (AV1 frame super-resolution)");
    MiCols = 2 * ((FrameWidth + 7) >> 3);
    MiRows = 2 * ((FrameHeight + 7) >> 3);
    if (b.f(1)) {  // render_and_frame_size_different
      b.f(16);
      b.f(16);
    }
    if (allow_screen_content_tools) allow_intrabc = b.f(1);
    if (!(s.reduced || disable_cdf_update)) b.f(1);  // disable_frame_end_update_cdf: one frame, no effect
    // loop filter deltas: setup_past_independence
    int def_ref[8] = {1, 0, 0, 0, -1, 0, -1, -1};
    memcpy(loop_filter_ref_deltas, def_ref, sizeof def_ref);
    loop_filter_mode_deltas[0] = loop_filter_mode_deltas[1] = 0;
    tile_info(b);
    // quantization_params
    base_q_idx = b.f(8);
    DeltaQYDc = read_delta_q(b);
    DeltaQUDc = DeltaQUAc = DeltaQVDc = DeltaQVAc = 0;
    if (NumPlanes > 1) {
      int diff_uv_delta = s.separate_uv_delta_q ? b.f(1) : 0;
      DeltaQUDc = read_delta_q(b);
      DeltaQUAc = read_delta_q(b);
      if (diff_uv_delta) {
        DeltaQVDc = read_delta_q(b);
        DeltaQVAc = read_delta_q(b);
      } else {
        DeltaQVDc = DeltaQUDc;
        DeltaQVAc = DeltaQUAc;
      }
    }
    using_qmatrix = b.f(1);
    if (using_qmatrix) {
      qm_y = b.f(4);
      qm_u = b.f(4);
      qm_v = s.separate_uv_delta_q ? (int)b.f(4) : qm_u;
    }
    // segmentation_params
    segmentation_enabled = b.f(1);
    memset(FeatureEnabled, 0, sizeof FeatureEnabled);
    memset(FeatureData, 0, sizeof FeatureData);
    if (segmentation_enabled) {
      for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
          int v = 0;
          FeatureEnabled[i][j] = b.f(1);
          if (FeatureEnabled[i][j]) {
            int bits = Segmentation_Feature_Bits[j], lim = Segmentation_Feature_Max[j];
            if (Segmentation_Feature_Signed[j]) v = clip3(-lim, lim, b.su(1 + bits));
            else v = clip3(0, lim, (int)b.f(bits));
          }
          FeatureData[i][j] = v;
        }
    }
    SegIdPreSkip = 0;
    LastActiveSegId = 0;
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++)
        if (FeatureEnabled[i][j]) {
          LastActiveSegId = i;
          if (j >= 5) SegIdPreSkip = 1;
        }
    // delta_q_params / delta_lf_params
    delta_q_res = delta_q_present = 0;
    if (base_q_idx > 0) delta_q_present = b.f(1);
    if (delta_q_present) delta_q_res = b.f(2);
    delta_lf_present = delta_lf_res = delta_lf_multi = 0;
    if (delta_q_present) {
      if (!allow_intrabc) delta_lf_present = b.f(1);
      if (delta_lf_present) {
        delta_lf_res = b.f(2);
        delta_lf_multi = b.f(1);
      }
    }
    CodedLossless = 1;
    for (int sid = 0; sid < 8; sid++) {
      int q = get_qindex(1, sid);
      LosslessArray[sid] = q == 0 && DeltaQYDc == 0 && DeltaQUAc == 0 && DeltaQUDc == 0 && DeltaQVAc == 0 &&
                           DeltaQVDc == 0;
      if (!LosslessArray[sid]) CodedLossless = 0;
    }
    AllLossless = CodedLossless;  // no superres: FrameWidth == UpscaledWidth
    // loop_filter_params
    loop_filter_level[0] = loop_filter_level[1] = loop_filter_level[2] = loop_filter_level[3] = 0;
    loop_filter_sharpness = 0;
    loop_filter_delta_enabled = 0;
    if (!(CodedLossless || allow_intrabc)) {
      loop_filter_level[0] = b.f(6);
      loop_filter_level[1] = b.f(6);
      if (NumPlanes > 1 && (loop_filter_level[0] || loop_filter_level[1])) {
        loop_filter_level[2] = b.f(6);
        loop_filter_level[3] = b.f(6);
      }
      loop_filter_sharpness = b.f(3);
      loop_filter_delta_enabled = b.f(1);
      if (loop_filter_delta_enabled) {
        if (b.f(1)) {  // loop_filter_delta_update
          for (int i = 0; i < 8; i++)
            if (b.f(1)) loop_filter_ref_deltas[i] = b.su(7);
          for (int i = 0; i < 2; i++)
            if (b.f(1)) loop_filter_mode_deltas[i] = b.su(7);
        }
      }
    }
    // cdef_params
    cdef_bits = 0;
    CdefDamping = 3;
    memset(cdef_y_pri, 0, sizeof cdef_y_pri);
    memset(cdef_y_sec, 0, sizeof cdef_y_sec);
    memset(cdef_uv_pri, 0, sizeof cdef_uv_pri);
    memset(cdef_uv_sec, 0, sizeof cdef_uv_sec);
    if (!(CodedLossless || allow_intrabc || !s.enable_cdef)) {
      CdefDamping = b.f(2) + 3;
      cdef_bits = b.f(2);
      for (int i = 0; i < (1 << cdef_bits); i++) {
        cdef_y_pri[i] = b.f(4);
        cdef_y_sec[i] = b.f(2);
        if (cdef_y_sec[i] == 3) cdef_y_sec[i] += 1;
        if (NumPlanes > 1) {
          cdef_uv_pri[i] = b.f(4);
          cdef_uv_sec[i] = b.f(2);
          if (cdef_uv_sec[i] == 3) cdef_uv_sec[i] += 1;
        }
      }
    }
    // lr_params
    UsesLr = 0;
    lr_unit_shift = lr_uv_shift = 0;
    FrameRestorationType[0] = FrameRestorationType[1] = FrameRestorationType[2] = RESTORE_NONE;
    if (!(AllLossless || allow_intrabc || !s.enable_restoration)) {
      int usesChromaLr = 0;
      for (int i = 0; i < NumPlanes; i++) {
        FrameRestorationType[i] = Remap_Lr_Type[b.f(2)];
        if (FrameRestorationType[i] != RESTORE_NONE) {
          UsesLr = 1;
          if (i > 0) usesChromaLr = 1;
        }
      }
      if (UsesLr) {
        if (s.use_128) {
          lr_unit_shift = b.f(1) + 1;
        } else {
          lr_unit_shift = b.f(1);
          if (lr_unit_shift) lr_unit_shift += b.f(1);  // lr_unit_extra_shift
        }
        LoopRestorationSize[0] = 256 >> (2 - lr_unit_shift);  // RESTORATION_TILESIZE_MAX
        lr_uv_shift = (s.ss_x && s.ss_y && usesChromaLr) ? (int)b.f(1) : 0;
        LoopRestorationSize[1] = LoopRestorationSize[2] = LoopRestorationSize[0] >> lr_uv_shift;
      }
    }
    // read_tx_mode
    if (CodedLossless) TxMode = ONLY_4X4;
    else TxMode = b.f(1) ? TX_MODE_SELECT : TX_MODE_LARGEST;
    // frame_reference_mode, skip_mode_params: nothing for intra frames
    reduced_tx_set = b.f(1);
    // global_motion_params: nothing for intra frames
    fg = FilmGrain();
    if (s.film_grain_params_present && (show_frame || showable_frame)) film_grain_params(b);
  }

  // 5.9.30, with dav1d's checks of the values (each refused by name)
  void film_grain_params(BitReader& b) {
    const SeqHeader& s = seq;
    fg.apply_grain = b.f(1);
    if (!fg.apply_grain) return;
    fg.grain_seed = b.f(16);
    // update_grain: 1 in an intra frame
    auto points = [&](int p, int most) {
      fg.num_points[p] = b.f(4);
      if (fg.num_points[p] > most)
        fail("film grain with " + std::to_string(fg.num_points[p]) + " " + (p ? "chroma" : "luma") +
             " scaling points (at most " + std::to_string(most) + ")");
      for (int i = 0; i < fg.num_points[p]; i++) {
        fg.points[p][i][0] = b.f(8);
        fg.points[p][i][1] = b.f(8);
        if (i && fg.points[p][i - 1][0] >= fg.points[p][i][0])
          fail("film grain scaling points whose values do not increase");
      }
    };
    points(0, 14);
    fg.chroma_scaling_from_luma = s.mono ? 0 : b.f(1);
    if (!(s.mono || fg.chroma_scaling_from_luma || (s.ss_x && s.ss_y && fg.num_points[0] == 0))) {
      points(1, 10);
      points(2, 10);
      if (s.ss_x && s.ss_y && !fg.num_points[1] != !fg.num_points[2])
        fail("film grain at 4:2:0 with scaling points for one chroma plane only");
    }
    fg.grain_scaling_minus_8 = b.f(2);
    fg.ar_coeff_lag = b.f(2);
    int numPosLuma = 2 * fg.ar_coeff_lag * (fg.ar_coeff_lag + 1);
    int numPosChroma = numPosLuma;
    if (fg.num_points[0]) {
      numPosChroma = numPosLuma + 1;
      for (int i = 0; i < numPosLuma; i++) fg.ar_coeffs[0][i] = b.f(8);
    }
    for (int p = 1; p < 3; p++)
      if (fg.chroma_scaling_from_luma || fg.num_points[p])
        for (int i = 0; i < numPosChroma; i++) fg.ar_coeffs[p][i] = b.f(8);
    fg.ar_coeff_shift_minus_6 = b.f(2);
    fg.grain_scale_shift = b.f(2);
    for (int p = 1; p < 3; p++)
      if (fg.num_points[p]) {
        fg.mult[p] = b.f(8);
        fg.luma_mult[p] = b.f(8);
        fg.offset[p] = b.f(9);
      }
    fg.overlap_flag = b.f(1);
    fg.clip_to_restricted_range = b.f(1);
  }

  void tile_info(BitReader& b) {
    int sbCols = seq.use_128 ? ((MiCols + 31) >> 5) : ((MiCols + 15) >> 4);
    int sbRows = seq.use_128 ? ((MiRows + 31) >> 5) : ((MiRows + 15) >> 4);
    int sbShift = seq.use_128 ? 5 : 4;
    int sbSize = sbShift + 2;
    int maxTileWidthSb = 4096 >> sbSize;
    int maxTileAreaSb = (4096 * 2304) >> (2 * sbSize);
    int minLog2TileCols = tile_log2(maxTileWidthSb, sbCols);
    int maxLog2TileCols = tile_log2(1, std::min(sbCols, 64));
    int maxLog2TileRows = tile_log2(1, std::min(sbRows, 64));
    int minLog2Tiles = std::max(minLog2TileCols, tile_log2(maxTileAreaSb, sbRows * sbCols));
    if (b.f(1)) {  // uniform_tile_spacing_flag
      TileColsLog2 = minLog2TileCols;
      while (TileColsLog2 < maxLog2TileCols) {
        if (b.f(1)) TileColsLog2++;
        else break;
      }
      int tileWidthSb = (sbCols + (1 << TileColsLog2) - 1) >> TileColsLog2;
      int i = 0;
      for (int start = 0; start < sbCols; start += tileWidthSb) MiColStarts[i++] = start << sbShift;
      MiColStarts[i] = MiCols;
      TileCols = i;
      int minLog2TileRows = std::max(minLog2Tiles - TileColsLog2, 0);
      TileRowsLog2 = minLog2TileRows;
      while (TileRowsLog2 < maxLog2TileRows) {
        if (b.f(1)) TileRowsLog2++;
        else break;
      }
      int tileHeightSb = (sbRows + (1 << TileRowsLog2) - 1) >> TileRowsLog2;
      i = 0;
      for (int start = 0; start < sbRows; start += tileHeightSb) MiRowStarts[i++] = start << sbShift;
      MiRowStarts[i] = MiRows;
      TileRows = i;
    } else {
      int widestTileSb = 0, start = 0, i;
      for (i = 0; start < sbCols; i++) {
        if (i >= 64) fail("more than 64 tile columns");
        MiColStarts[i] = start << sbShift;
        int maxWidth = std::min(sbCols - start, maxTileWidthSb);
        int sizeSb = b.ns(maxWidth) + 1;
        widestTileSb = std::max(sizeSb, widestTileSb);
        start += sizeSb;
      }
      MiColStarts[i] = MiCols;
      TileCols = i;
      TileColsLog2 = tile_log2(1, TileCols);
      int area = minLog2Tiles > 0 ? (sbRows * sbCols) >> (minLog2Tiles + 1) : sbRows * sbCols;
      int maxTileHeightSb = std::max(area / widestTileSb, 1);
      start = 0;
      for (i = 0; start < sbRows; i++) {
        if (i >= 64) fail("more than 64 tile rows");
        MiRowStarts[i] = start << sbShift;
        int maxHeight = std::min(sbRows - start, maxTileHeightSb);
        int sizeSb = b.ns(maxHeight) + 1;
        start += sizeSb;
      }
      MiRowStarts[i] = MiRows;
      TileRows = i;
      TileRowsLog2 = tile_log2(1, TileRows);
    }
    if (TileColsLog2 > 0 || TileRowsLog2 > 0) {
      b.f(TileRowsLog2 + TileColsLog2);  // context_update_tile_id
      TileSizeBytes = b.f(2) + 1;
    }
  }

  // ------------------------------------------------------------ allocation
  void alloc_frame() {
    if ((BitDepth > 8) != (sizeof(Pixel) > 1)) fail("a sequence header of another bit depth than the first");
    NumPlanes = seq.mono ? 1 : 3;
    stride_mi = MiCols + 32;
    size_t n = (size_t)stride_mi * (MiRows + 32);
    YModes.assign(n, 0);
    UVModes.assign(n, 0);
    MiSizes.assign(n, 0);
    Skips.assign(n, 0);
    SegmentIds.assign(n, 0);
    InterTxSizes.assign(n, 0);
    IsInters.assign(n, 0);
    for (int p = 0; p < 2; p++) {
      PaletteSizes[p].assign(n, 0);
      PaletteColors[p].assign(n * 8, 0);
    }
    Mvs.assign(n * 2, 0);
    Decoded.assign(n, 0);
    DeltaLFs.assign(n * 4, 0);
    TxTypes.assign(n, 0);
    for (int p = 0; p < 3; p++) LfTxSizes[p].assign(n, 0);
    cdef_idx.assign(n, -1);
    for (int p = 0; p < NumPlanes; p++) {
      int sx = p ? seq.ss_x : 0, sy = p ? seq.ss_y : 0;
      pw[p] = ((MiCols * 4 + 160) >> sx) + 16;
      ph[p] = ((MiRows * 4 + 160) >> sy) + 16;
      plane[p].assign((size_t)pw[p] * ph[p], 0);
    }
    for (int p = 0; p < 3; p++) {
      AboveLevelContext[p].assign(MiCols + 64, 0);
      AboveDcContext[p].assign(MiCols + 64, 0);
      LeftLevelContext[p].assign(MiRows + 64, 0);
      LeftDcContext[p].assign(MiRows + 64, 0);
    }
    for (int p = 0; p < NumPlanes; p++) {
      if (FrameRestorationType[p] == RESTORE_NONE) continue;
      int sx = p ? seq.ss_x : 0, sy = p ? seq.ss_y : 0;
      unitRows[p] = count_units_in_frame(LoopRestorationSize[p], round2(FrameHeight, sy));
      unitCols[p] = count_units_in_frame(LoopRestorationSize[p], round2(FrameWidth, sx));
      LrUnits[p].assign((size_t)unitRows[p] * unitCols[p], LrUnit());
    }
  }
  static int count_units_in_frame(int unitSize, int frameSize) {
    return std::max((frameSize + (unitSize >> 1)) / unitSize, 1);
  }

  // ------------------------------------------------------------ tile data
  bool is_inside(int r, int c) const {
    return c >= MiColStart && c < MiColEnd && r >= MiRowStart && r < MiRowEnd;
  }

  void decode_tile() {
    for (int p = 0; p < 3; p++) {
      std::fill(AboveLevelContext[p].begin(), AboveLevelContext[p].end(), 0);
      std::fill(AboveDcContext[p].begin(), AboveDcContext[p].end(), 0);
    }
    for (int i = 0; i < 4; i++) DeltaLF[i] = 0;
    for (int p = 0; p < NumPlanes; p++)
      for (int pass = 0; pass < 2; pass++) {
        RefSgrXqd[p][pass] = Sgrproj_Xqd_Mid[pass];
        for (int i = 0; i < 3; i++) RefLrWiener[p][pass][i] = Wiener_Taps_Mid[i];
      }
    int sbSize = seq.use_128 ? BLOCK_128X128 : BLOCK_64X64;
    int sbSize4 = Num_4x4_Blocks_Wide[sbSize];
    for (int r = MiRowStart; r < MiRowEnd; r += sbSize4) {
      for (int p = 0; p < 3; p++) {
        std::fill(LeftLevelContext[p].begin(), LeftLevelContext[p].end(), 0);
        std::fill(LeftDcContext[p].begin(), LeftDcContext[p].end(), 0);
      }
      for (int c = MiColStart; c < MiColEnd; c += sbSize4) {
        ReadDeltas = delta_q_present;
        clear_block_decoded_flags(r, c, sbSize4);
        read_lr(r, c, sbSize);
        decode_partition(r, c, sbSize);
      }
    }
  }

  // 5.11.57: the restoration units whose top-left corner falls in the
  // superblock at (r, c)
  void read_lr(int r, int c, int bSize) {
    if (allow_intrabc) return;
    int w = Num_4x4_Blocks_Wide[bSize], h = Num_4x4_Blocks_High[bSize];
    for (int p = 0; p < NumPlanes; p++) {
      if (FrameRestorationType[p] == RESTORE_NONE) continue;
      int sx = p ? seq.ss_x : 0, sy = p ? seq.ss_y : 0;
      int unitSize = LoopRestorationSize[p];
      int rowStart = (r * (4 >> sy) + unitSize - 1) / unitSize;
      int rowEnd = std::min(unitRows[p], ((r + h) * (4 >> sy) + unitSize - 1) / unitSize);
      int colStart = (c * (4 >> sx) + unitSize - 1) / unitSize;
      int colEnd = std::min(unitCols[p], ((c + w) * (4 >> sx) + unitSize - 1) / unitSize);
      for (int ur = rowStart; ur < rowEnd; ur++)
        for (int uc = colStart; uc < colEnd; uc++) read_lr_unit(p, LrUnits[p][(size_t)ur * unitCols[p] + uc]);
    }
  }

  // 5.11.58
  void read_lr_unit(int p, LrUnit& u) {
    int frameType = FrameRestorationType[p];
    if (frameType == RESTORE_WIENER) u.type = sd.symbol(cdf.use_wiener, 2) ? RESTORE_WIENER : RESTORE_NONE;
    else if (frameType == RESTORE_SGRPROJ) u.type = sd.symbol(cdf.use_sgrproj, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
    else u.type = sd.symbol(cdf.restoration_type, 3);
    if (u.type == RESTORE_WIENER) {
      for (int pass = 0; pass < 2; pass++) {
        int first = p ? 1 : 0;  // chroma: a 5-tap filter
        u.wiener[pass][0] = 0;
        for (int j = first; j < 3; j++) {
          int v = decode_signed_subexp_with_ref_bool(Wiener_Taps_Min[j], Wiener_Taps_Max[j] + 1, Wiener_Taps_K[j],
                                                     RefLrWiener[p][pass][j]);
          u.wiener[pass][j] = v;
          RefLrWiener[p][pass][j] = v;
        }
      }
    } else if (u.type == RESTORE_SGRPROJ) {
      u.set = (int)sd.literal(4);  // SGRPROJ_PARAMS_BITS
      for (int i = 0; i < 2; i++) {
        int radius = Sgr_Params[u.set][i * 2], lo = Sgrproj_Xqd_Min[i], hi = Sgrproj_Xqd_Max[i];
        int v = 0;
        if (radius)
          v = decode_signed_subexp_with_ref_bool(lo, hi + 1, SGRPROJ_PRJ_SUBEXP_K, RefSgrXqd[p][i]);
        else if (i == 1)
          v = clip3(lo, hi, (1 << SGRPROJ_PRJ_BITS) - RefSgrXqd[p][0]);
        u.xqd[i] = v;
        RefSgrXqd[p][i] = v;
      }
    }
  }

  int decode_signed_subexp_with_ref_bool(int low, int high, int k, int r) {
    return decode_unsigned_subexp_with_ref_bool(high - low, k, r - low) + low;
  }
  int decode_unsigned_subexp_with_ref_bool(int mx, int k, int r) {
    int v = decode_subexp_bool(mx, k);
    if ((r << 1) <= mx) return inverse_recenter(r, v);
    return mx - 1 - inverse_recenter(mx - 1 - r, v);
  }
  int decode_subexp_bool(int numSyms, int k) {
    int i = 0, mk = 0;
    while (true) {
      int b2 = i ? k + i - 1 : k;
      int a = 1 << b2;
      if (numSyms <= mk + 3 * a) return ns_symbols(numSyms - mk) + mk;
      if (!sd.literal(1)) return (int)sd.literal(b2) + mk;
      i++;
      mk += a;
    }
  }
  int ns_symbols(int n) {  // NS(n): ns(n) read with L(1)
    int w = floor_log2((uint32_t)n) + 1;
    int m = (1 << w) - n;
    int v = (int)sd.literal(w - 1);
    if (v < m) return v;
    return (v << 1) - m + (int)sd.literal(1);
  }
  static int inverse_recenter(int r, int v) {
    if (v > 2 * r) return v;
    if (v & 1) return r - ((v + 1) >> 1);
    return r + (v >> 1);
  }

  void clear_block_decoded_flags(int r, int c, int sbSize4) {
    for (int p = 0; p < NumPlanes; p++) {
      int sx = p ? seq.ss_x : 0, sy = p ? seq.ss_y : 0;
      int sbWidth4 = (MiColEnd - c) >> sx, sbHeight4 = (MiRowEnd - r) >> sy;
      for (int y = -1; y <= (sbSize4 >> sy); y++)
        for (int x = -1; x <= (sbSize4 >> sx); x++) {
          int v;
          if (y < 0 && x < sbWidth4) v = 1;
          else if (x < 0 && y < sbHeight4) v = 1;
          else v = 0;
          BlockDecoded[p][y + 1][x + 1] = (uint8_t)v;
        }
      BlockDecoded[p][(sbSize4 >> sy) + 1][0] = 0;
    }
  }
  int block_decoded(int p, int y, int x) const { return BlockDecoded[p][y + 1][x + 1]; }

  uint16_t* partition_cdf(int bsl, int ctx) {
    switch (bsl) {
      case 1: return cdf.partition_w8[ctx];
      case 2: return cdf.partition_w16[ctx];
      case 3: return cdf.partition_w32[ctx];
      case 4: return cdf.partition_w64[ctx];
      default: return cdf.partition_w128[ctx];
    }
  }

  static int size_of(int w4, int h4) {
    for (int b = 0; b < BLOCK_INVALID; b++)
      if (Num_4x4_Blocks_Wide[b] == w4 && Num_4x4_Blocks_High[b] == h4) return b;
    return BLOCK_INVALID;
  }
  static int partition_subsize(int p, int b) {
    int w4 = Num_4x4_Blocks_Wide[b], h4 = Num_4x4_Blocks_High[b];
    switch (p) {
      case PARTITION_NONE: return b;
      case PARTITION_HORZ: case PARTITION_HORZ_A: case PARTITION_HORZ_B: return size_of(w4, h4 / 2);
      case PARTITION_VERT: case PARTITION_VERT_A: case PARTITION_VERT_B: return size_of(w4 / 2, h4);
      case PARTITION_SPLIT: return size_of(w4 / 2, h4 / 2);
      case PARTITION_HORZ_4: return size_of(w4, h4 / 4);
      default: return size_of(w4 / 4, h4);
    }
  }

  void decode_partition(int r, int c, int bSize) {
    if (r >= MiRows || c >= MiCols) return;
    int availU = is_inside(r - 1, c), availL = is_inside(r, c - 1);
    int num4x4 = Num_4x4_Blocks_Wide[bSize];
    int half = num4x4 >> 1, quarter = half >> 1;
    int hasRows = (r + half) < MiRows, hasCols = (c + half) < MiCols;
    int partition;
    if (bSize < BLOCK_8X8) {
      partition = PARTITION_NONE;
    } else {
      int bsl = Mi_Width_Log2[bSize];
      int above = availU && (Mi_Width_Log2[MiSizes[mi(r - 1, c)]] < bsl);
      int left = availL && (Mi_Height_Log2[MiSizes[mi(r, c - 1)]] < bsl);
      uint16_t* pc = partition_cdf(bsl, left * 2 + above);
      int N = bsl == 1 ? 4 : bsl == 5 ? 8 : 10;
      auto prob = [&](int k) { return (int)pc[k] - (k ? (int)pc[k - 1] : 0); };
      if (hasRows && hasCols) {
        partition = sd.symbol(pc, N);
      } else if (hasCols) {
        int psum = prob(PARTITION_VERT) + prob(PARTITION_SPLIT);
        if (bsl > 1) {
          psum += prob(PARTITION_HORZ_A) + prob(PARTITION_VERT_A) + prob(PARTITION_VERT_B);
          if (bSize != BLOCK_128X128) psum += prob(PARTITION_VERT_4);
        }
        uint16_t tmp[3] = {(uint16_t)((1 << 15) - psum), 1 << 15, 0};
        bool a = sd.adapt;
        sd.adapt = false;
        partition = sd.symbol(tmp, 2) ? PARTITION_SPLIT : PARTITION_HORZ;
        sd.adapt = a;
      } else if (hasRows) {
        int psum = prob(PARTITION_HORZ) + prob(PARTITION_SPLIT);
        if (bsl > 1) {
          psum += prob(PARTITION_HORZ_A) + prob(PARTITION_HORZ_B) + prob(PARTITION_VERT_A);
          if (bSize != BLOCK_128X128) psum += prob(PARTITION_HORZ_4);
        }
        uint16_t tmp[3] = {(uint16_t)((1 << 15) - psum), 1 << 15, 0};
        bool a = sd.adapt;
        sd.adapt = false;
        partition = sd.symbol(tmp, 2) ? PARTITION_SPLIT : PARTITION_VERT;
        sd.adapt = a;
      } else {
        partition = PARTITION_SPLIT;
      }
    }
    int subSize = partition_subsize(partition, bSize);
    int splitSize = partition_subsize(PARTITION_SPLIT, bSize);
    switch (partition) {
      case PARTITION_NONE: decode_block(r, c, subSize); break;
      case PARTITION_HORZ:
        decode_block(r, c, subSize);
        if (hasRows) decode_block(r + half, c, subSize);
        break;
      case PARTITION_VERT:
        decode_block(r, c, subSize);
        if (hasCols) decode_block(r, c + half, subSize);
        break;
      case PARTITION_SPLIT:
        decode_partition(r, c, subSize);
        decode_partition(r, c + half, subSize);
        decode_partition(r + half, c, subSize);
        decode_partition(r + half, c + half, subSize);
        break;
      case PARTITION_HORZ_A:
        decode_block(r, c, splitSize);
        decode_block(r, c + half, splitSize);
        decode_block(r + half, c, subSize);
        break;
      case PARTITION_HORZ_B:
        decode_block(r, c, subSize);
        decode_block(r + half, c, splitSize);
        decode_block(r + half, c + half, splitSize);
        break;
      case PARTITION_VERT_A:
        decode_block(r, c, splitSize);
        decode_block(r + half, c, splitSize);
        decode_block(r, c + half, subSize);
        break;
      case PARTITION_VERT_B:
        decode_block(r, c, subSize);
        decode_block(r, c + half, splitSize);
        decode_block(r + half, c + half, splitSize);
        break;
      case PARTITION_HORZ_4:
        for (int i = 0; i < 4; i++)
          if (i < 3 || r + quarter * 3 < MiRows) decode_block(r + quarter * i, c, subSize);
        break;
      default:
        for (int i = 0; i < 4; i++)
          if (i < 3 || c + quarter * 3 < MiCols) decode_block(r, c + quarter * i, subSize);
        break;
    }
  }

  void decode_block(int r, int c, int subSize) {
    if (subSize == BLOCK_INVALID) fail("an invalid block size");
    MiRow = r;
    MiCol = c;
    MiSize = subSize;
    int bw4 = Num_4x4_Blocks_Wide[subSize], bh4 = Num_4x4_Blocks_High[subSize];
    if (bh4 == 1 && seq.ss_y && (MiRow & 1) == 0) HasChroma = 0;
    else if (bw4 == 1 && seq.ss_x && (MiCol & 1) == 0) HasChroma = 0;
    else HasChroma = NumPlanes > 1;
    AvailU = is_inside(r - 1, c);
    AvailL = is_inside(r, c - 1);
    AvailUChroma = AvailU;
    AvailLChroma = AvailL;
    if (HasChroma) {
      if (seq.ss_y && bh4 == 1) AvailUChroma = is_inside(r - 2, c);
      if (seq.ss_x && bw4 == 1) AvailLChroma = is_inside(r, c - 2);
    } else {
      AvailUChroma = AvailLChroma = 0;
    }
    intra_frame_mode_info();
    palette_tokens();
    read_block_tx_size();
    if (skip) reset_block_context(bw4, bh4);
    for (int y = 0; y < bh4; y++) {
      if (r + y >= MiRows) break;
      for (int x = 0; x < bw4; x++) {
        if (c + x >= MiCols) break;
        size_t k = mi(r + y, c + x);
        YModes[k] = (uint8_t)YMode;
        UVModes[k] = (uint8_t)UVMode;
        Skips[k] = (uint8_t)skip;
        MiSizes[k] = (uint8_t)MiSize;
        SegmentIds[k] = (uint8_t)segment_id;
        IsInters[k] = (uint8_t)is_inter;
        Mvs[k * 2] = (int16_t)Mv[0];
        Mvs[k * 2 + 1] = (int16_t)Mv[1];
        PaletteSizes[0][k] = (uint8_t)PaletteSizeY;
        PaletteSizes[1][k] = (uint8_t)PaletteSizeUV;
        for (int i = 0; i < PaletteSizeY; i++) PaletteColors[0][k * 8 + i] = (uint8_t)palette_colors_y[i];
        for (int i = 0; i < PaletteSizeUV; i++) PaletteColors[1][k * 8 + i] = (uint8_t)palette_colors_u[i];
        Decoded[k] = 1;
        for (int i = 0; i < 4; i++) DeltaLFs[k * 4 + i] = (int8_t)DeltaLF[i];
      }
    }
    if (is_inter) predict_intrabc();
    residual();
  }

  void intra_frame_mode_info() {
    skip = 0;
    if (SegIdPreSkip) intra_segment_id();
    read_skip();
    if (!SegIdPreSkip) intra_segment_id();
    read_cdef();
    read_delta_qindex();
    read_delta_lf();
    ReadDeltas = 0;
    is_inter = allow_intrabc ? sd.symbol(cdf.intrabc, 2) : 0;  // use_intrabc
    PaletteSizeY = PaletteSizeUV = 0;
    use_filter_intra = 0;
    AngleDeltaY = AngleDeltaUV = 0;
    CflAlphaU = CflAlphaV = 0;
    Mv[0] = Mv[1] = 0;
    YMode = UVMode = DC_PRED;
    if (is_inter) {  // DC_PRED modes, no palette, filter intra or CfL; BILINEAR
      find_mv_stack();
      assign_dv();
      return;
    }
    int above = Intra_Mode_Context[AvailU ? (int)YModes[mi(MiRow - 1, MiCol)] : (int)DC_PRED];
    int left = Intra_Mode_Context[AvailL ? (int)YModes[mi(MiRow, MiCol - 1)] : (int)DC_PRED];
    YMode = sd.symbol(cdf.y_mode[above][left], 13);
    int use_angle_delta = MiSize >= BLOCK_8X8;
    if (use_angle_delta && YMode >= V_PRED && YMode <= D67_PRED)
      AngleDeltaY = sd.symbol(cdf.angle_delta[YMode - V_PRED], 7) - 3;
    if (HasChroma) {
      int cflAllowed;
      if (Lossless && get_plane_residual_size(MiSize, 1) == BLOCK_4X4) cflAllowed = 1;
      else if (!Lossless && std::max(block_width(MiSize), block_height(MiSize)) <= 32) cflAllowed = 1;
      else cflAllowed = 0;
      if (cflAllowed) UVMode = sd.symbol(cdf.uv_mode_cfl_allowed[YMode], 14);
      else UVMode = sd.symbol(cdf.uv_mode_cfl_not_allowed[YMode], 13);
      if (UVMode == UV_CFL_PRED) read_cfl_alphas();
      if (use_angle_delta && UVMode >= V_PRED && UVMode <= D67_PRED)
        AngleDeltaUV = sd.symbol(cdf.angle_delta[UVMode - V_PRED], 7) - 3;
    }
    // MiSize >= BLOCK_8X8 in the enum's order: 4x16 and 16x4 blocks too
    if (MiSize >= BLOCK_8X8 && block_width(MiSize) <= 64 && block_height(MiSize) <= 64 &&
        allow_screen_content_tools)
      palette_mode_info();
    if (seq.enable_filter_intra && YMode == DC_PRED && PaletteSizeY == 0 &&
        std::max(block_width(MiSize), block_height(MiSize)) <= 32) {
      use_filter_intra = sd.symbol(cdf.filter_intra[MiSize], 2);
      if (use_filter_intra) filter_intra_mode = sd.symbol(cdf.filter_intra_mode, 5);
    }
  }

  // ------------------------------------------------------------ palette
  // Palette colours are coded with BitDepth bits; above 8 bits the port
  // reads no palette block (no writer makes one to hold it to).
  void refuse_high_depth_palette() {
    if (BitDepth > 8)
      fail("palette colours at " + std::to_string(BitDepth) + "-bit (AV1 palette mode at high bit depth)");
  }

  // 5.11.46
  void palette_mode_info() {
    int bsizeCtx = Mi_Width_Log2[MiSize] + Mi_Height_Log2[MiSize] - 2;
    if (YMode == DC_PRED) {
      int ctx = (AvailU && PaletteSizes[0][mi(MiRow - 1, MiCol)] > 0) +
                (AvailL && PaletteSizes[0][mi(MiRow, MiCol - 1)] > 0);
      if (sd.symbol(cdf.palette_y_mode[bsizeCtx][ctx], 2)) {
        refuse_high_depth_palette();
        PaletteSizeY = sd.symbol(cdf.palette_y_size[bsizeCtx], 7) + 2;
        read_palette_colors(0, PaletteSizeY, palette_colors_y);
        tools[32 + PaletteSizeY - 2]++;
      }
    }
    if (HasChroma && UVMode == DC_PRED) {
      if (sd.symbol(cdf.palette_uv_mode[PaletteSizeY > 0], 2)) {
        refuse_high_depth_palette();
        PaletteSizeUV = sd.symbol(cdf.palette_uv_size[bsizeCtx], 7) + 2;
        read_palette_colors(1, PaletteSizeUV, palette_colors_u);
        if (sd.literal(1)) {  // delta_encode_palette_colors_v
          int bits = 8 - 4 + (int)sd.literal(2);
          palette_colors_v[0] = (int)sd.literal(8);
          for (int idx = 1; idx < PaletteSizeUV; idx++) {
            int delta = (int)sd.literal(bits);
            if (delta && sd.literal(1)) delta = -delta;
            int val = palette_colors_v[idx - 1] + delta;
            if (val < 0) val += 256;
            if (val >= 256) val -= 256;
            palette_colors_v[idx] = clip3(0, 255, val);
          }
          tools[50]++;
        } else {
          for (int idx = 0; idx < PaletteSizeUV; idx++) palette_colors_v[idx] = (int)sd.literal(8);
          tools[51]++;
        }
        tools[39 + PaletteSizeUV - 2]++;
      }
    }
  }

  // The Y (plane 0) or U (plane 1) colours: from the cache, one literal,
  // then ascending deltas (at least 1 for Y), sorted.
  void read_palette_colors(int plane, int n, int* colors) {
    int cache[16];
    int cacheN = get_palette_cache(plane, cache);
    int idx = 0;
    for (int i = 0; i < cacheN && idx < n; i++)
      if (sd.literal(1)) colors[idx++] = cache[i];
    tools[46 + plane] += idx;
    if (idx < n) {
      colors[idx++] = (int)sd.literal(8);
      int paletteBits = 0;
      if (idx < n) paletteBits = 8 - 3 + (int)sd.literal(2);
      for (; idx < n; idx++) {
        int delta = (int)sd.literal(paletteBits) + (plane == 0);
        colors[idx] = std::min(255, colors[idx - 1] + delta);
        int range = 256 - colors[idx] - (plane == 0);
        paletteBits = std::min(paletteBits, ceil_log2(range));
        tools[48 + plane]++;
      }
    }
    std::sort(colors, colors + n);
  }
  static int ceil_log2(int x) {
    if (x < 2) return 0;
    int i = 1, p = 2;
    while (p < x) {
      i++;
      p <<= 1;
    }
    return i;
  }

  // get_palette_cache: the above and left blocks' colours merged, ascending,
  // without repeats; the above block only inside the same 64-row band
  int get_palette_cache(int plane, int* cache) {
    int aboveN = ((MiRow * 4) % 64) && AvailU ? PaletteSizes[plane][mi(MiRow - 1, MiCol)] : 0;
    int leftN = AvailL ? PaletteSizes[plane][mi(MiRow, MiCol - 1)] : 0;
    const uint8_t* above = aboveN ? &PaletteColors[plane][mi(MiRow - 1, MiCol) * 8] : nullptr;
    const uint8_t* left = leftN ? &PaletteColors[plane][mi(MiRow, MiCol - 1) * 8] : nullptr;
    int a = 0, l = 0, n = 0;
    auto add = [&](int v) {
      if (n == 0 || v != cache[n - 1]) cache[n++] = v;
    };
    while (a < aboveN && l < leftN) {
      int aboveC = above[a], leftC = left[l];
      if (leftC < aboveC) {
        add(leftC);
        l++;
      } else {
        add(aboveC);
        a++;
        if (leftC == aboveC) l++;
      }
    }
    while (a < aboveN) add(above[a++]);
    while (l < leftN) add(left[l++]);
    return n;
  }

  // 5.11.49: each colour index map, the first index then the anti-diagonals
  // (the wavefront) by the colour context; past the mi grid's edge the map
  // repeats its last column and row
  void palette_tokens() {
    int bh = block_height(MiSize), bw = block_width(MiSize);
    int onH = std::min(bh, (MiRows - MiRow) * 4), onW = std::min(bw, (MiCols - MiCol) * 4);
    if (PaletteSizeY) read_color_map(0, ColorMapY, PaletteSizeY, bw, bh, onW, onH);
    if (PaletteSizeUV) {
      bw >>= seq.ss_x;
      bh >>= seq.ss_y;
      onW >>= seq.ss_x;
      onH >>= seq.ss_y;
      if (bw < 4) {
        bw += 2;
        onW += 2;
      }
      if (bh < 4) {
        bh += 2;
        onH += 2;
      }
      read_color_map(1, ColorMapUV, PaletteSizeUV, bw, bh, onW, onH);
    }
  }
  void read_color_map(int plane, uint8_t (*map)[64], int n, int bw, int bh, int onW, int onH) {
    map[0][0] = (uint8_t)ns_symbols(n);
    for (int i = 1; i < onH + onW - 1; i++)
      for (int j = std::min(i, onW - 1); j >= std::max(0, i - onH + 1); j--) {
        int order[8];
        int ctx = palette_color_context(map, i - j, j, n, order);
        map[i - j][j] = (uint8_t)order[sd.symbol(cdf.palette_color[plane][n - 2][ctx], n)];
      }
    for (int i = 0; i < onH; i++)
      for (int j = onW; j < bw; j++) map[i][j] = map[i][onW - 1];
    for (int i = onH; i < bh; i++)
      for (int j = 0; j < bw; j++) map[i][j] = map[onH - 1][j];
  }
  // get_palette_color_context: the colours ordered by the neighbours' scores
  // (left 2, above-left 1, above 2); the context of the top three's hash
  static int palette_color_context(uint8_t (*map)[64], int r, int c, int n, int* order) {
    int scores[8] = {0};
    for (int i = 0; i < 8; i++) order[i] = i;
    if (c > 0) scores[map[r][c - 1]] += 2;
    if (r > 0 && c > 0) scores[map[r - 1][c - 1]] += 1;
    if (r > 0) scores[map[r - 1][c]] += 2;
    for (int i = 0; i < 3; i++) {
      int maxScore = scores[i], maxIdx = i;
      for (int j = i + 1; j < n; j++)
        if (scores[j] > maxScore) {
          maxScore = scores[j];
          maxIdx = j;
        }
      if (maxIdx != i) {
        int maxOrder = order[maxIdx];
        for (int k = maxIdx; k > i; k--) {
          scores[k] = scores[k - 1];
          order[k] = order[k - 1];
        }
        scores[i] = maxScore;
        order[i] = maxOrder;
      }
    }
    int hash = 0;
    for (int i = 0; i < 3; i++) hash += scores[i] * Palette_Color_Hash_Multipliers[i];
    return Palette_Color_Context[hash];
  }

  // ------------------------------------------------------------- IntraBC
  // find_mv_stack (7.10.2) for IntraBC: only the spatial candidates (an
  // intra frame has no temporal ones), and among them only IntraBC blocks
  // (RefFrame INTRA_FRAME, is_inter); the global motion vector is zero
  void find_mv_stack() {
    int bw4 = Num_4x4_Blocks_Wide[MiSize], bh4 = Num_4x4_Blocks_High[MiSize];
    NumMvFound = 0;
    scan_row(-1);
    scan_col(-1);
    if (std::max(bw4, bh4) <= 16) scan_point(-1, bw4);
    int numNearest = NumMvFound;
    for (int idx = 0; idx < numNearest; idx++) WeightStack[idx] += REF_CAT_LEVEL;
    scan_point(-1, -1);
    scan_row(-3);
    scan_col(-3);
    if (bh4 > 1) scan_row(-5);
    if (bw4 > 1) scan_col(-5);
    sorting(0, numNearest);
    sorting(numNearest, NumMvFound);
    // extra_search adds no candidate in an intra frame (none has
    // RefFrame > INTRA_FRAME): the rest of the first two are the global mv
    for (int idx = NumMvFound; idx < 2; idx++) RefStackMv[idx][0] = RefStackMv[idx][1] = 0;
    // context_and_clamping
    int mbToTop = -(MiRow * 4 * 8), mbToBottom = (MiRows - bh4 - MiRow) * 4 * 8;
    int mbToLeft = -(MiCol * 4 * 8), mbToRight = (MiCols - bw4 - MiCol) * 4 * 8;
    for (int idx = 0; idx < NumMvFound; idx++) {
      int br = MV_BORDER + bh4 * 4 * 8, bc = MV_BORDER + bw4 * 4 * 8;
      RefStackMv[idx][0] = clip3(mbToTop - br, mbToBottom + br, RefStackMv[idx][0]);
      RefStackMv[idx][1] = clip3(mbToLeft - bc, mbToRight + bc, RefStackMv[idx][1]);
    }
  }
  void scan_row(int deltaRow) {
    int bw4 = Num_4x4_Blocks_Wide[MiSize];
    int end4 = std::min(std::min(bw4, MiCols - MiCol), 16);
    int deltaCol = 0, useStep16 = bw4 >= 16;
    if (std::abs(deltaRow) > 1) {
      deltaRow += MiRow & 1;
      deltaCol = 1 - (MiCol & 1);
    }
    for (int i = 0; i < end4;) {
      int mvRow = MiRow + deltaRow, mvCol = MiCol + deltaCol + i;
      if (!is_inside(mvRow, mvCol)) break;
      int len = std::min(bw4, Num_4x4_Blocks_Wide[MiSizes[mi(mvRow, mvCol)]]);
      if (std::abs(deltaRow) > 1) len = std::max(2, len);
      if (useStep16) len = std::max(4, len);
      add_ref_mv_candidate(mvRow, mvCol, len * 2);
      i += len;
    }
  }
  void scan_col(int deltaCol) {
    int bh4 = Num_4x4_Blocks_High[MiSize];
    int end4 = std::min(std::min(bh4, MiRows - MiRow), 16);
    int deltaRow = 0, useStep16 = bh4 >= 16;
    if (std::abs(deltaCol) > 1) {
      deltaRow = 1 - (MiRow & 1);
      deltaCol += MiCol & 1;
    }
    for (int i = 0; i < end4;) {
      int mvRow = MiRow + deltaRow + i, mvCol = MiCol + deltaCol;
      if (!is_inside(mvRow, mvCol)) break;
      int len = std::min(bh4, Num_4x4_Blocks_High[MiSizes[mi(mvRow, mvCol)]]);
      if (std::abs(deltaCol) > 1) len = std::max(2, len);
      if (useStep16) len = std::max(4, len);
      add_ref_mv_candidate(mvRow, mvCol, len * 2);
      i += len;
    }
  }
  // a point counts where it is inside the tile and already decoded
  void scan_point(int deltaRow, int deltaCol) {
    int mvRow = MiRow + deltaRow, mvCol = MiCol + deltaCol;
    if (is_inside(mvRow, mvCol) && Decoded[mi(mvRow, mvCol)]) add_ref_mv_candidate(mvRow, mvCol, 4);
  }
  // add_ref_mv_candidate and search_stack: IntraBC DVs are whole samples, so
  // lower_mv_precision leaves them as they are
  void add_ref_mv_candidate(int mvRow, int mvCol, int weight) {
    size_t k = mi(mvRow, mvCol);
    if (!IsInters[k]) return;
    int r = Mvs[k * 2], c = Mvs[k * 2 + 1];
    int idx = 0;
    while (idx < NumMvFound && !(RefStackMv[idx][0] == r && RefStackMv[idx][1] == c)) idx++;
    if (idx < NumMvFound) {
      WeightStack[idx] += weight;
    } else if (NumMvFound < MAX_REF_MV_STACK_SIZE) {
      RefStackMv[NumMvFound][0] = r;
      RefStackMv[NumMvFound][1] = c;
      WeightStack[NumMvFound] = weight;
      NumMvFound++;
    }
  }
  void sorting(int start, int end) {
    while (end > start) {
      int newEnd = start;
      for (int idx = start + 1; idx < end; idx++)
        if (WeightStack[idx - 1] < WeightStack[idx]) {
          std::swap(WeightStack[idx - 1], WeightStack[idx]);
          std::swap(RefStackMv[idx - 1][0], RefStackMv[idx][0]);
          std::swap(RefStackMv[idx - 1][1], RefStackMv[idx][1]);
          newEnd = idx;
        }
      end = newEnd;
    }
  }
  // assign_mv for IntraBC: the first nonzero of the stack's two, else the
  // default DV (a superblock up, or a superblock and INTRABC_DELAY_PIXELS
  // left in the tile's first superblock row); then read_mv under
  // MV_INTRABC_CONTEXT with force_integer_mv
  void assign_dv() {
    int pr = RefStackMv[0][0], pc = RefStackMv[0][1];
    if (pr == 0 && pc == 0) {
      pr = RefStackMv[1][0];
      pc = RefStackMv[1][1];
    }
    int fromStack = pr != 0 || pc != 0;
    if (!fromStack) {
      int sbSize4 = seq.use_128 ? 32 : 16;
      if (MiRow - sbSize4 < MiRowStart) {
        pr = 0;
        pc = -(sbSize4 * 4 + INTRABC_DELAY_PIXELS) * 8;
      } else {
        pr = -(sbSize4 * 4 * 8);
        pc = 0;
      }
    }
    tools[52 + !fromStack]++;
    int joint = sd.symbol(cdf.mv_joint, 4);
    int dr = 0, dc = 0;
    if (joint == MV_JOINT_HZVNZ || joint == MV_JOINT_HNZVNZ) dr = read_mv_component(0);
    if (joint == MV_JOINT_HNZVZ || joint == MV_JOINT_HNZVNZ) dc = read_mv_component(1);
    Mv[0] = pr + dr;
    Mv[1] = pc + dc;
    if ((Mv[0] & 7) || (Mv[1] & 7)) fail("an IntraBC DV of a fraction of a sample (damaged AV1 data)");
  }
  // read_mv_component with force_integer_mv (mv_fr 3) and no high precision
  // (mv_hp 1): magnitudes of whole samples
  int read_mv_component(int comp) {
    int sign = sd.symbol(cdf.mv_sign[comp], 2);
    int mvClass = sd.symbol(cdf.mv_class[comp], 11);
    int mag;
    if (mvClass == 0) {
      mag = ((sd.symbol(cdf.mv_class0_bit[comp], 2) << 3) | (3 << 1) | 1) + 1;
    } else {
      int d = 0;
      for (int i = 0; i < mvClass; i++) d |= sd.symbol(cdf.mv_bit[comp][i], 2) << i;
      mag = (2 << (mvClass + 2)) + ((d << 3) | (3 << 1) | 1) + 1;
    }
    return sign ? -mag : mag;
  }

  // 7.11.3 for IntraBC: each plane's whole block from the current frame
  // (before any filter; the filters are off with allow_intrabc) at the
  // block's DV, by the BILINEAR filter (7.11.3.2's rounding for isCompound
  // 0: InterRound0 3 and InterRound1 11, 5 and 9 at 12 bits). The spec's
  // someUseIntra is always 1 here (an IntraBC block's RefFrame[0] is
  // INTRA_FRAME), so the chroma of a block below 8x8 is predicted whole
  // from this block's DV. Samples clamp to the frame's mi grid
  // (RefUpscaledWidth[-1] = MiCols * MI_SIZE).
  void predict_intrabc() {
    Pixel out[128 * 128];
    const int InterRound0 = BitDepth == 12 ? 5 : 3, InterRound1 = BitDepth == 12 ? 9 : 11;
    for (int p = 0; p < 1 + 2 * HasChroma; p++) {
      int sx = p ? seq.ss_x : 0, sy = p ? seq.ss_y : 0;
      int planeSz = get_plane_residual_size(MiSize, p);
      int w = block_width(planeSz), h = block_height(planeSz);
      int baseX = (MiCol >> sx) * 4, baseY = (MiRow >> sy) * 4;
      int lastX = ((MiCols * 4) >> sx) - 1, lastY = ((MiRows * 4) >> sy) - 1;
      // positions in 1/16 sample: whole part and filter index
      int px = (baseX << 4) + ((2 * Mv[1]) >> sx), py = (baseY << 4) + ((2 * Mv[0]) >> sy);
      int x0 = px >> 4, y0 = py >> 4, fx = px & 15, fy = py & 15;
      if (p > 0 && (fx || fy)) tools[61]++;
      if ((Num_4x4_Blocks_Wide[MiSize] == 1 && sx) || (Num_4x4_Blocks_High[MiSize] == 1 && sy)) tools[62]++;
      auto ref = [&](int i, int j) { return (int)P(p, clip3(0, lastY, y0 + i), clip3(0, lastX, x0 + j)); };
      auto horiz = [&](int i, int j) {
        return round2((128 - 8 * fx) * ref(i, j) + 8 * fx * ref(i, j + 1), InterRound0);
      };
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
          out[i * w + j] = (Pixel)clip1(round2((128 - 8 * fy) * horiz(i, j) + 8 * fy * horiz(i + 1, j), InterRound1));
      for (int i = 0; i < h; i++) memcpy(&P(p, baseY + i, baseX), out + i * w, w * sizeof(Pixel));
    }
  }

  void intra_segment_id() {
    if (segmentation_enabled) read_segment_id();
    else segment_id = 0;
    Lossless = LosslessArray[segment_id];
  }

  static int neg_deinterleave(int diff, int ref, int max) {
    if (!ref) return diff;
    if (ref >= max - 1) return max - diff - 1;
    if (2 * ref < max) {
      if (diff <= 2 * ref) {
        if (diff & 1) return ref + ((diff + 1) >> 1);
        return ref - (diff >> 1);
      }
      return diff;
    }
    if (diff <= 2 * (max - ref - 1)) {
      if (diff & 1) return ref + ((diff + 1) >> 1);
      return ref - (diff >> 1);
    }
    return max - (diff + 1);
  }

  void read_segment_id() {
    int prevUL = (AvailU && AvailL) ? SegmentIds[mi(MiRow - 1, MiCol - 1)] : -1;
    int prevU = AvailU ? SegmentIds[mi(MiRow - 1, MiCol)] : -1;
    int prevL = AvailL ? SegmentIds[mi(MiRow, MiCol - 1)] : -1;
    int pred;
    if (prevU == -1) pred = prevL == -1 ? 0 : prevL;
    else if (prevL == -1) pred = prevU;
    else pred = prevUL == prevU ? prevU : prevL;
    if (skip) {
      segment_id = pred;
      return;
    }
    int ctx;
    if (prevUL < 0) ctx = 0;
    else if (prevUL == prevU && prevUL == prevL) ctx = 2;
    else if (prevUL == prevU || prevUL == prevL || prevU == prevL) ctx = 1;
    else ctx = 0;
    int s = sd.symbol(cdf.segment_id[ctx], 8);
    segment_id = clip3(0, LastActiveSegId, neg_deinterleave(s, pred, LastActiveSegId + 1));
  }

  void read_skip() {
    if (SegIdPreSkip && segmentation_enabled && FeatureEnabled[segment_id][SEG_LVL_SKIP]) {
      skip = 1;
      return;
    }
    int ctx = (AvailU ? Skips[mi(MiRow - 1, MiCol)] : 0) + (AvailL ? Skips[mi(MiRow, MiCol - 1)] : 0);
    skip = sd.symbol(cdf.skip[ctx], 2);
  }

  void read_cdef() {
    if (skip || CodedLossless || !seq.enable_cdef || allow_intrabc) return;
    int r = MiRow & ~15, c = MiCol & ~15;
    if (cdef_idx[mi(r, c)] == -1) {
      int v = (int)sd.literal(cdef_bits);
      int w4 = Num_4x4_Blocks_Wide[MiSize], h4 = Num_4x4_Blocks_High[MiSize];
      for (int y = r; y < r + h4; y += 16)
        for (int x = c; x < c + w4; x += 16) cdef_idx[mi(y, x)] = (int8_t)v;
    }
  }

  void read_delta_qindex() {
    int sbSize = seq.use_128 ? BLOCK_128X128 : BLOCK_64X64;
    if (MiSize == sbSize && skip) return;
    if (ReadDeltas) {
      int abs = sd.symbol(cdf.delta_q, 4);
      if (abs == 3) {
        int rem = (int)sd.literal(3) + 1;
        abs = (int)sd.literal(rem) + (1 << rem) + 1;
      }
      if (abs) {
        int sign = (int)sd.literal(1);
        int reduced = sign ? -abs : abs;
        CurrentQIndex = clip3(1, 255, CurrentQIndex + reduced * (1 << delta_q_res));
      }
    }
  }

  void read_delta_lf() {
    int sbSize = seq.use_128 ? BLOCK_128X128 : BLOCK_64X64;
    if (MiSize == sbSize && skip) return;
    if (ReadDeltas && delta_lf_present) {
      int count = 1;
      if (delta_lf_multi) count = NumPlanes > 1 ? 4 : 2;
      for (int i = 0; i < count; i++) {
        int abs = sd.symbol(delta_lf_multi ? cdf.delta_lf_multi[i] : cdf.delta_lf, 4);
        if (abs == 3) {
          int rem = (int)sd.literal(3) + 1;
          abs = (int)sd.literal(rem) + (1 << rem) + 1;
        }
        if (abs) {
          int sign = (int)sd.literal(1);
          int reduced = sign ? -abs : abs;
          DeltaLF[i] = clip3(-63, 63, DeltaLF[i] + reduced * (1 << delta_lf_res));
        }
      }
    }
  }

  void read_cfl_alphas() {
    int signs = sd.symbol(cdf.cfl_sign, 8);
    int signU = (signs + 1) / 3, signV = (signs + 1) % 3;
    if (signU) {
      CflAlphaU = 1 + sd.symbol(cdf.cfl_alpha[(signU - 1) * 3 + signV], 16);
      if (signU == 1) CflAlphaU = -CflAlphaU;
    } else {
      CflAlphaU = 0;
    }
    if (signV) {
      CflAlphaV = 1 + sd.symbol(cdf.cfl_alpha[(signV - 1) * 3 + signU], 16);
      if (signV == 1) CflAlphaV = -CflAlphaV;
    } else {
      CflAlphaV = 0;
    }
  }

  int get_plane_residual_size(int subsize, int p) const {
    int sx = p ? seq.ss_x : 0, sy = p ? seq.ss_y : 0;
    return Subsampled_Size[subsize][sx][sy];
  }

  // the neighbours' transform sizes; a skipped inter block counts as one
  // transform of its block's size
  int get_above_tx_width(int row, int col) {
    if (row == MiRow) {
      if (!AvailU) return 64;
      if (Skips[mi(row - 1, col)] && IsInters[mi(row - 1, col)]) return block_width(MiSizes[mi(row - 1, col)]);
    }
    return Tx_Width[InterTxSizes[mi(row - 1, col)]];
  }
  int get_left_tx_height(int row, int col) {
    if (col == MiCol) {
      if (!AvailL) return 64;
      if (Skips[mi(row, col - 1)] && IsInters[mi(row, col - 1)]) return block_height(MiSizes[mi(row, col - 1)]);
    }
    return Tx_Height[InterTxSizes[mi(row, col - 1)]];
  }

  // 5.11.15-17: an inter block's transform tree (var-tx), else one size
  void read_block_tx_size() {
    int bw4 = Num_4x4_Blocks_Wide[MiSize], bh4 = Num_4x4_Blocks_High[MiSize];
    if (TxMode == TX_MODE_SELECT && MiSize > BLOCK_4X4 && is_inter && !skip && !Lossless) {
      int maxTxSz = Max_Tx_Size_Rect[MiSize];
      int txW4 = Tx_Width[maxTxSz] / 4, txH4 = Tx_Height[maxTxSz] / 4;
      for (int row = MiRow; row < MiRow + bh4; row += txH4)
        for (int col = MiCol; col < MiCol + bw4; col += txW4) read_var_tx_size(row, col, maxTxSz, 0);
    } else {
      read_tx_size(!skip || !is_inter);
      for (int row = MiRow; row < std::min(MiRows, MiRow + bh4); row++)
        for (int col = MiCol; col < std::min(MiCols, MiCol + bw4); col++) InterTxSizes[mi(row, col)] = (uint8_t)TxSize;
    }
  }

  void read_var_tx_size(int row, int col, int txSz, int depth) {
    if (row >= MiRows || col >= MiCols) return;
    int split = 0;
    if (txSz != TX_4X4 && depth != MAX_VARTX_DEPTH) {
      int above = get_above_tx_width(row, col) < Tx_Width[txSz];
      int left = get_left_tx_height(row, col) < Tx_Height[txSz];
      int size = std::min(64, std::max(block_width(MiSize), block_height(MiSize)));
      int maxTxSz = find_tx_size(size, size);
      int ctx = (Tx_Size_Sqr_Up[txSz] != maxTxSz) * 3 + (TX_64X64 - maxTxSz) * 6 + above + left;
      split = sd.symbol(cdf.txfm_split[ctx], 2);
    }
    int w4 = Tx_Width[txSz] / 4, h4 = Tx_Height[txSz] / 4;
    if (split) {
      int sub = Split_Tx_Size[txSz];
      int stepW = Tx_Width[sub] / 4, stepH = Tx_Height[sub] / 4;
      for (int i = 0; i < h4; i += stepH)
        for (int j = 0; j < w4; j += stepW) read_var_tx_size(row + i, col + j, sub, depth + 1);
    } else {
      for (int i = 0; i < h4; i++)
        for (int j = 0; j < w4; j++) InterTxSizes[mi(row + i, col + j)] = (uint8_t)txSz;
      TxSize = txSz;
      tools[54 + depth]++;
    }
  }
  static int find_tx_size(int w, int h) {
    int t = 0;
    while (Tx_Width[t] != w || Tx_Height[t] != h) t++;
    return t;
  }

  void read_tx_size(int allowSelect) {
    if (Lossless) {
      TxSize = TX_4X4;
      return;
    }
    int maxRect = Max_Tx_Size_Rect[MiSize];
    int maxDepth = Max_Tx_Depth[MiSize];
    TxSize = maxRect;
    if (MiSize > BLOCK_4X4 && allowSelect && TxMode == TX_MODE_SELECT) {
      // an inter neighbour counts with its block's size
      int aboveW = 0, leftH = 0;
      if (AvailU) {
        size_t k = mi(MiRow - 1, MiCol);
        aboveW = IsInters[k] ? block_width(MiSizes[k]) : get_above_tx_width(MiRow, MiCol);
      }
      if (AvailL) {
        size_t k = mi(MiRow, MiCol - 1);
        leftH = IsInters[k] ? block_height(MiSizes[k]) : get_left_tx_height(MiRow, MiCol);
      }
      int ctx = (aboveW >= Tx_Width[maxRect]) + (leftH >= Tx_Height[maxRect]);
      int depth;
      if (maxDepth > 3) depth = sd.symbol(cdf.tx_64x64[ctx], 3);
      else if (maxDepth == 3) depth = sd.symbol(cdf.tx_32x32[ctx], 3);
      else if (maxDepth == 2) depth = sd.symbol(cdf.tx_16x16[ctx], 3);
      else depth = sd.symbol(cdf.tx_8x8[ctx], 2);
      for (int i = 0; i < depth; i++) TxSize = Split_Tx_Size[TxSize];
    }
  }

  void reset_block_context(int bw4, int bh4) {
    for (int p = 0; p < 1 + 2 * HasChroma; p++) {
      int sx = p ? seq.ss_x : 0, sy = p ? seq.ss_y : 0;
      for (int i = MiCol >> sx; i <= ((MiCol + bw4 - 1) >> sx); i++) {
        AboveLevelContext[p][i] = 0;
        AboveDcContext[p][i] = 0;
      }
      for (int i = MiRow >> sy; i <= ((MiRow + bh4 - 1) >> sy); i++) {
        LeftLevelContext[p][i] = 0;
        LeftDcContext[p][i] = 0;
      }
    }
  }

  int get_tx_size(int p, int txSz) {
    if (p == 0) return txSz;
    int uvTx = Max_Tx_Size_Rect[get_plane_residual_size(MiSize, p)];
    if (Tx_Width[uvTx] == 64 || Tx_Height[uvTx] == 64) {
      if (Tx_Width[uvTx] == 16) return TX_16X32;
      if (Tx_Height[uvTx] == 16) return TX_32X16;
      return TX_32X32;
    }
    return uvTx;
  }

  void residual() {
    int widthChunks = std::max(1, block_width(MiSize) >> 6);
    int heightChunks = std::max(1, block_height(MiSize) >> 6);
    for (int chunkY = 0; chunkY < heightChunks; chunkY++)
      for (int chunkX = 0; chunkX < widthChunks; chunkX++) {
        for (int p = 0; p < 1 + HasChroma * 2; p++) {
          int planeSz = get_plane_residual_size(MiSize, p);
          if (planeSz == BLOCK_INVALID) fail("an invalid chroma block size");
          int num4x4W = Num_4x4_Blocks_Wide[planeSz], num4x4H = Num_4x4_Blocks_High[planeSz];
          if (is_inter && !Lossless && p == 0) {  // the chunk's transform tree
            transform_tree((MiCol + (chunkX << 4)) * 4, (MiRow + (chunkY << 4)) * 4, std::min(64, num4x4W * 4),
                           std::min(64, num4x4H * 4));
            continue;
          }
          int txSz = Lossless ? TX_4X4 : get_tx_size(p, TxSize);
          int stepX = Tx_Width[txSz] >> 2, stepY = Tx_Height[txSz] >> 2;
          int sx = p ? seq.ss_x : 0, sy = p ? seq.ss_y : 0;
          int baseX = (MiCol >> sx) * 4, baseY = (MiRow >> sy) * 4;
          for (int y = 0; y < std::min(num4x4H, 16 >> sy); y += stepY)
            for (int x = 0; x < std::min(num4x4W, 16 >> sx); x += stepX)
              transform_block(p, baseX, baseY, txSz, x + ((chunkX << 4) >> sx), y + ((chunkY << 4) >> sy));
        }
      }
  }

  void transform_tree(int startX, int startY, int w, int h) {
    if (startX >= MiCols * 4 || startY >= MiRows * 4) return;
    int txSz = InterTxSizes[mi(startY >> 2, startX >> 2)];
    if (w <= Tx_Width[txSz] && h <= Tx_Height[txSz]) {
      transform_block(0, startX, startY, find_tx_size(w, h), 0, 0);
    } else if (w > h) {
      transform_tree(startX, startY, w / 2, h);
      transform_tree(startX + w / 2, startY, w / 2, h);
    } else if (w < h) {
      transform_tree(startX, startY, w, h / 2);
      transform_tree(startX, startY + h / 2, w, h / 2);
    } else {
      transform_tree(startX, startY, w / 2, h / 2);
      transform_tree(startX + w / 2, startY, w / 2, h / 2);
      transform_tree(startX, startY + h / 2, w / 2, h / 2);
      transform_tree(startX + w / 2, startY + h / 2, w / 2, h / 2);
    }
  }

  void transform_block(int p, int baseX, int baseY, int txSz, int x, int y) {
    int startX = baseX + 4 * x, startY = baseY + 4 * y;
    int sx = p ? seq.ss_x : 0, sy = p ? seq.ss_y : 0;
    int row = (startY << sy) >> 2, col = (startX << sx) >> 2;
    int sbMask = seq.use_128 ? 31 : 15;
    int subBlockMiRow = row & sbMask, subBlockMiCol = col & sbMask;
    int stepX = Tx_Width[txSz] >> 2, stepY = Tx_Height[txSz] >> 2;
    int maxX = (MiCols * 4) - 1, maxY = (MiRows * 4) - 1;
    if (startX >= (maxX >> sx) || startY >= (maxY >> sy)) return;
    if (!is_inter) {  // an IntraBC block was predicted whole (predict_intrabc)
      if (p == 0 ? PaletteSizeY : PaletteSizeUV) {
        predict_palette(p, startX, startY, x, y, txSz);
      } else {
        int isCfl = p > 0 && UVMode == UV_CFL_PRED;
        int mode = p == 0 ? YMode : (isCfl ? DC_PRED : UVMode);
        int log2W = Tx_Width_Log2[txSz], log2H = Tx_Height_Log2[txSz];
        predict_intra(p, startX, startY, (p == 0 ? AvailL : AvailLChroma) || x > 0,
                      (p == 0 ? AvailU : AvailUChroma) || y > 0,
                      block_decoded(p, (subBlockMiRow >> sy) - 1, (subBlockMiCol >> sx) + stepX),
                      block_decoded(p, (subBlockMiRow >> sy) + stepY, (subBlockMiCol >> sx) - 1), mode, log2W, log2H);
        if (isCfl) predict_chroma_from_luma(p, startX, startY, txSz);
      }
      if (p == 0) {
        MaxLumaW = startX + stepX * 4;
        MaxLumaH = startY + stepY * 4;
      }
    }
    if (!skip) {
      int eob = coeffs(p, startX, startY, txSz);
      if (eob > 0) reconstruct(p, startX, startY, txSz);
    }
    for (int i = 0; i < stepY; i++)
      for (int j = 0; j < stepX; j++) {
        int rr = (row >> sy) + i, cc = (col >> sx) + j;
        if (rr < MiRows + 16 && cc < MiCols + 16) LfTxSizes[p][mi(rr, cc)] = (uint8_t)txSz;
        int by = (subBlockMiRow >> sy) + i, bx = (subBlockMiCol >> sx) + j;
        if (by <= 32 && bx <= 32) BlockDecoded[p][by + 1][bx + 1] = 1;
      }
  }

  // 7.11.4: the block's colours by its colour index map, (x, y) the
  // transform block's place in the map in 4-sample units
  void predict_palette(int p, int startX, int startY, int x, int y, int txSz) {
    const int* palette = p == 0 ? palette_colors_y : (p == 1 ? palette_colors_u : palette_colors_v);
    uint8_t(*map)[64] = p == 0 ? ColorMapY : ColorMapUV;
    for (int i = 0; i < Tx_Height[txSz]; i++)
      for (int j = 0; j < Tx_Width[txSz]; j++)
        P(p, startY + i, startX + j) = (Pixel)palette[map[y * 4 + i][x * 4 + j]];
  }

  // ------------------------------------------------------- coefficients
  int get_tx_set(int txSz) {
    int sqr = Tx_Size_Sqr[txSz], up = Tx_Size_Sqr_Up[txSz];
    if (up > TX_32X32) return TX_SET_DCTONLY;
    if (is_inter) {
      if (reduced_tx_set || up == TX_32X32) return TX_SET_INTER_3;
      if (sqr == TX_16X16) return TX_SET_INTER_2;
      return TX_SET_INTER_1;
    }
    if (up == TX_32X32) return TX_SET_DCTONLY;
    if (reduced_tx_set) return TX_SET_INTRA_2;
    if (sqr == TX_16X16) return TX_SET_INTRA_2;
    return TX_SET_INTRA_1;
  }

  static int get_tx_class(int t) {
    if (t == V_DCT || t == V_ADST || t == V_FLIPADST) return TX_CLASS_VERT;
    if (t == H_DCT || t == H_ADST || t == H_FLIPADST) return TX_CLASS_HORIZ;
    return TX_CLASS_2D;
  }

  int compute_tx_type(int p, int txSz, int x4, int y4) {
    if (Lossless || Tx_Size_Sqr_Up[txSz] > TX_32X32) return DCT_DCT;
    int set = get_tx_set(txSz);
    if (p == 0) return TxTypes[mi(y4, x4)];
    if (is_inter) {  // the co-located luma type where the chroma set has it
      int t = TxTypes[mi(std::max(MiRow, y4 << seq.ss_y), std::max(MiCol, x4 << seq.ss_x))];
      return (Tx_Type_In_Set_Inter[set] >> t) & 1 ? t : DCT_DCT;
    }
    if (set == TX_SET_DCTONLY) return DCT_DCT;
    return Mode_To_Txfm[UVMode];  // every Mode_To_Txfm type is in both intra sets
  }

  // scans
  std::vector<int16_t> scans[19][3];  // [txSz][0 default, 1 mrow, 2 mcol]
  const int16_t* get_scan(int txSz) {
    if (txSz == TX_16X64) return scan_for(TX_16X32, 0);
    if (txSz == TX_64X16) return scan_for(TX_32X16, 0);
    if (Tx_Size_Sqr_Up[txSz] == TX_64X64) return scan_for(TX_32X32, 0);
    if (PlaneTxType == IDTX) return scan_for(txSz, 0);
    int preferRow = PlaneTxType == V_DCT || PlaneTxType == V_ADST || PlaneTxType == V_FLIPADST;
    int preferCol = PlaneTxType == H_DCT || PlaneTxType == H_ADST || PlaneTxType == H_FLIPADST;
    if (preferRow) return scan_for(txSz, 1);
    if (preferCol) return scan_for(txSz, 2);
    return scan_for(txSz, 0);
  }
  const int16_t* scan_for(int txSz, int kind) {
    std::vector<int16_t>& s = scans[txSz][kind];
    if (s.empty()) {
      int w = Tx_Width[txSz], h = Tx_Height[txSz];
      if (kind == 1) {
        for (int i = 0; i < w * h; i++) s.push_back((int16_t)i);
      } else if (kind == 2) {
        for (int i = 0; i < w * h; i++) s.push_back((int16_t)((i % h) * w + i / h));
      } else {
        for (int d = 0; d < w + h - 1; d++) {
          int lo = std::max(0, d - (w - 1)), hi = std::min(h - 1, d);
          bool up;  // rows decreasing along the diagonal
          if (w == h) up = (d % 2) == 0;
          else up = w > h;
          if (up)
            for (int r = hi; r >= lo; r--) s.push_back((int16_t)(r * w + d - r));
          else
            for (int r = lo; r <= hi; r++) s.push_back((int16_t)(r * w + d - r));
        }
      }
    }
    return s.data();
  }

  int coeffs(int p, int startX, int startY, int txSz) {
    int x4 = startX >> 2, y4 = startY >> 2, w4 = Tx_Width[txSz] >> 2, h4 = Tx_Height[txSz] >> 2;
    int txSzCtx = (Tx_Size_Sqr[txSz] + Tx_Size_Sqr_Up[txSz] + 1) >> 1;
    int ptype = p > 0;
    // Quant is not cleared: every scan position below eob is written, and
    // none past it is read
    int eob = 0, culLevel = 0, dcCategory = 0;
    // all_zero context
    int maxX4 = MiCols, maxY4 = MiRows;
    if (p > 0) {
      maxX4 >>= seq.ss_x;
      maxY4 >>= seq.ss_y;
    }
    int w = Tx_Width[txSz], h = Tx_Height[txSz];
    int ctx;
    if (p == 0) {
      int top = 0, left = 0;
      for (int k = 0; k < w4; k++)
        if (x4 + k < maxX4) top = std::max(top, (int)AboveLevelContext[p][x4 + k]);
      for (int k = 0; k < h4; k++)
        if (y4 + k < maxY4) left = std::max(left, (int)LeftLevelContext[p][y4 + k]);
      top = std::min(top, 255);
      left = std::min(left, 255);
      if (block_width(MiSize) == w && block_height(MiSize) == h) ctx = 0;
      else if (top == 0 && left == 0) ctx = 1;
      else if (top == 0 || left == 0) ctx = 2 + (std::max(top, left) > 3);
      else if (std::max(top, left) <= 3) ctx = 4;
      else if (std::min(top, left) <= 3) ctx = 5;
      else ctx = 6;
    } else {
      int above = 0, left = 0;
      for (int i = 0; i < w4; i++)
        if (x4 + i < maxX4) above |= AboveLevelContext[p][x4 + i] | AboveDcContext[p][x4 + i];
      for (int i = 0; i < h4; i++)
        if (y4 + i < maxY4) left |= LeftLevelContext[p][y4 + i] | LeftDcContext[p][y4 + i];
      ctx = (above != 0) + (left != 0);
      ctx += 7;
      int planeSz = get_plane_residual_size(MiSize, p);
      if (block_width(planeSz) * block_height(planeSz) > w * h) ctx += 3;
    }
    int all_zero = sd.symbol(cdf.txb_skip[txSzCtx][ctx], 2);
    if (all_zero) {
      if (p == 0)
        for (int i = 0; i < w4; i++)
          for (int j = 0; j < h4; j++) TxTypes[mi(y4 + j, x4 + i)] = DCT_DCT;
    } else {
      if (p == 0) transform_type(x4, y4, txSz);
      PlaneTxType = compute_tx_type(p, txSz, x4, y4);
      const int16_t* scan = get_scan(txSz);
      cur_scan = scan;
      int eobMultisize = std::min(Tx_Width_Log2[txSz], 5) + std::min(Tx_Height_Log2[txSz], 5) - 4;
      int txClass = get_tx_class(PlaneTxType);
      int ectx = txClass == TX_CLASS_2D ? 0 : 1;
      int eobPt;
      switch (eobMultisize) {
        case 0: eobPt = sd.symbol(cdf.eob_pt_16[ptype][ectx], 5) + 1; break;
        case 1: eobPt = sd.symbol(cdf.eob_pt_32[ptype][ectx], 6) + 1; break;
        case 2: eobPt = sd.symbol(cdf.eob_pt_64[ptype][ectx], 7) + 1; break;
        case 3: eobPt = sd.symbol(cdf.eob_pt_128[ptype][ectx], 8) + 1; break;
        case 4: eobPt = sd.symbol(cdf.eob_pt_256[ptype][ectx], 9) + 1; break;
        case 5: eobPt = sd.symbol(cdf.eob_pt_512[ptype], 10) + 1; break;
        default: eobPt = sd.symbol(cdf.eob_pt_1024[ptype], 11) + 1; break;
      }
      eob = eobPt < 2 ? eobPt : ((1 << (eobPt - 2)) + 1);
      int eobShift = eobPt - 3;
      if (eobShift >= 0) {
        if (sd.symbol(cdf.eob_extra[txSzCtx][ptype][eobPt - 3], 2)) eob += 1 << eobShift;
        for (int i = 1; i < std::max(0, eobPt - 2); i++) {
          eobShift = std::max(0, eobPt - 2) - 1 - i;
          if (sd.literal(1)) eob += 1 << eobShift;
        }
      }
      int adj = Adjusted_Tx_Size[txSz];
      int bwl = Tx_Width_Log2[adj], txh = Tx_Height[adj];
      // the levels read so far, padded by 4 zero columns and rows: the
      // neighbours past the block's right and bottom edges read 0, as the
      // specification's bounds checks make them count
      const int S = (1 << bwl) + 4;
      memset(lv, 0, (size_t)S * (txh + 4));
      int sig[5], magoff[3];
      for (int idx = 0; idx < 5; idx++) sig[idx] = Sig_Ref_Diff_Offset[txClass][idx][0] * S + Sig_Ref_Diff_Offset[txClass][idx][1];
      for (int idx = 0; idx < 3; idx++)
        magoff[idx] = Mag_Ref_Offset_With_Tx_Class[txClass][idx][0] * S + Mag_Ref_Offset_With_Tx_Class[txClass][idx][1];
      for (int c = eob - 1; c >= 0; c--) {
        int pos = scan[c];
        int level;
        int row = pos >> bwl, col = pos - (row << bwl);
        const uint8_t* l = lv + row * S + col;
        if (c == eob - 1) {
          int ectx2;
          if (c == 0) ectx2 = 0;
          else if (c <= (txh << bwl) / 8) ectx2 = 1;
          else if (c <= (txh << bwl) / 4) ectx2 = 2;
          else ectx2 = 3;
          level = sd.symbol(cdf.coeff_base_eob[txSzCtx][ptype][ectx2], 3) + 1;
        } else {
          int mag = 0;
          for (int idx = 0; idx < 5; idx++) mag += std::min((int)l[sig[idx]], 3);
          int bctx = std::min((mag + 1) >> 1, 4);
          if (txClass == TX_CLASS_2D) {
            if (row == 0 && col == 0) bctx = 0;
            else bctx += coeff_base_ctx_offset(txSz, std::min(row, 4), std::min(col, 4));
          } else {
            int idx = txClass == TX_CLASS_VERT ? row : col;
            bctx += Coeff_Base_Pos_Ctx_Offset[std::min(idx, 2)];
          }
          level = sd.symbol(cdf.coeff_base[txSzCtx][ptype][bctx], 4);
        }
        if (level > 2) {
          int mag = l[magoff[0]] + l[magoff[1]] + l[magoff[2]];  // each at most 15
          mag = std::min((mag + 1) >> 1, 6);
          int brctx;
          if (pos == 0) brctx = mag;
          else if (txClass == TX_CLASS_2D) brctx = (row < 2 && col < 2) ? mag + 7 : mag + 14;
          else if (txClass == TX_CLASS_HORIZ) brctx = col == 0 ? mag + 7 : mag + 14;
          else brctx = row == 0 ? mag + 7 : mag + 14;
          for (int idx = 0; idx < 4; idx++) {
            int br = sd.symbol(cdf.coeff_br[std::min(txSzCtx, 3)][ptype][brctx], 4);
            level += br;
            if (br < 3) break;
          }
        }
        lv[row * S + col] = (uint8_t)level;
        Quant[pos] = level;
      }
      for (int c = 0; c < eob; c++) {
        int pos = scan[c];
        int sign = 0;
        if (Quant[pos] != 0) {
          if (c == 0) {
            int dcSign = 0;
            for (int k = 0; k < w4; k++)
              if (x4 + k < maxX4) {
                int s = AboveDcContext[p][x4 + k];
                if (s == 1) dcSign--;
                else if (s == 2) dcSign++;
              }
            for (int k = 0; k < h4; k++)
              if (y4 + k < maxY4) {
                int s = LeftDcContext[p][y4 + k];
                if (s == 1) dcSign--;
                else if (s == 2) dcSign++;
              }
            int dctx = dcSign < 0 ? 1 : dcSign > 0 ? 2 : 0;
            sign = sd.symbol(cdf.dc_sign[ptype][dctx], 2);
          } else {
            sign = (int)sd.literal(1);
          }
        }
        if (Quant[pos] > 14) {
          int length = 0, golomb_length_bit;
          do {
            length++;
            golomb_length_bit = (int)sd.literal(1);
            if (length > 32) fail("a Golomb code longer than 32 bits (damaged AV1 data)");
          } while (!golomb_length_bit);
          uint32_t xg = 1;
          for (int i = length - 2; i >= 0; i--) xg = (xg << 1) | sd.literal(1);
          Quant[pos] = (int32_t)(xg + 14);
        }
        if (pos == 0 && Quant[pos] > 0) dcCategory = sign ? 1 : 2;
        Quant[pos] &= 0xFFFFF;
        culLevel += Quant[pos];
        if (sign) Quant[pos] = -Quant[pos];
      }
      culLevel = std::min(63, culLevel);
    }
    cur_eob = eob;
    for (int i = 0; i < w4; i++) {
      AboveLevelContext[p][x4 + i] = (uint8_t)culLevel;
      AboveDcContext[p][x4 + i] = (uint8_t)dcCategory;
    }
    for (int i = 0; i < h4; i++) {
      LeftLevelContext[p][y4 + i] = (uint8_t)culLevel;
      LeftDcContext[p][y4 + i] = (uint8_t)dcCategory;
    }
    return eob;
  }

  void transform_type(int x4, int y4, int txSz) {
    int set = get_tx_set(txSz);
    int TxType = DCT_DCT;
    int q = segmentation_enabled ? get_qindex(1, segment_id) : base_q_idx;
    if (is_inter) tools[57 + (q > 0 ? set : 0)]++;
    if (set > 0 && q > 0 && is_inter) {
      if (set == TX_SET_INTER_1)
        TxType = Tx_Type_Inter_Inv_Set1[sd.symbol(cdf.inter_tx_set1[Tx_Size_Sqr[txSz]], 16)];
      else if (set == TX_SET_INTER_2)
        TxType = Tx_Type_Inter_Inv_Set2[sd.symbol(cdf.inter_tx_set2, 12)];
      else
        TxType = Tx_Type_Inter_Inv_Set3[sd.symbol(cdf.inter_tx_set3[Tx_Size_Sqr[txSz]], 2)];
    } else if (set > 0 && q > 0) {
      int intraDir = use_filter_intra ? Filter_Intra_Mode_To_Intra_Dir[filter_intra_mode] : YMode;
      if (set == TX_SET_INTRA_1)
        TxType = Tx_Type_Intra_Inv_Set1[sd.symbol(cdf.intra_tx_set1[Tx_Size_Sqr[txSz]][intraDir], 7)];
      else
        TxType = Tx_Type_Intra_Inv_Set2[sd.symbol(cdf.intra_tx_set2[Tx_Size_Sqr[txSz]][intraDir], 5)];
    }
    for (int i = 0; i < (Tx_Width[txSz] >> 2); i++)
      for (int j = 0; j < (Tx_Height[txSz] >> 2); j++) TxTypes[mi(y4 + j, x4 + i)] = (uint8_t)TxType;
  }

  // ----------------------------------------------------- reconstruction
  int dc_q(int b) { return Dc_Qlookup[(BitDepth - 8) >> 1][clip3(0, 255, b)]; }
  int ac_q(int b) { return Ac_Qlookup[(BitDepth - 8) >> 1][clip3(0, 255, b)]; }

  int32_t Residual[64][64];

  void reconstruct(int p, int x, int y, int txSz) {
    int pels = Tx_Width[txSz] * Tx_Height[txSz];
    int dqShift = pels > 1024 ? 2 : pels > 256 ? 1 : 0;
    int log2W = Tx_Width_Log2[txSz], log2H = Tx_Height_Log2[txSz];
    int w = 1 << log2W, h = 1 << log2H;
    int tw = std::min(32, w), th = std::min(32, h);
    int t = PlaneTxType;
    int flipUD = t == FLIPADST_DCT || t == FLIPADST_ADST || t == V_FLIPADST || t == FLIPADST_FLIPADST;
    int flipLR = t == DCT_FLIPADST || t == ADST_FLIPADST || t == H_FLIPADST || t == FLIPADST_FLIPADST;
    int qindex = get_qindex(0, segment_id);
    int dcQ, acQ;
    if (p == 0) {
      dcQ = dc_q(qindex + DeltaQYDc);
      acQ = ac_q(qindex);
    } else if (p == 1) {
      dcQ = dc_q(qindex + DeltaQUDc);
      acQ = ac_q(qindex + DeltaQUAc);
    } else {
      dcQ = dc_q(qindex + DeltaQVDc);
      acQ = ac_q(qindex + DeltaQVAc);
    }
    // the quantizer matrix (7.12.3): not for lossless blocks, level 15 or
    // the identity and 1-D transform types (their matrix is flat)
    int qmLevel = p == 0 ? qm_y : (p == 1 ? qm_u : qm_v);
    const uint8_t* qm = nullptr;
    if (using_qmatrix && !Lossless && qmLevel < 15 && PlaneTxType < IDTX)
      qm = Quantizer_Matrix[qmLevel][p > 0] + Qm_Offset[txSz];
    // only the eob scan positions can hold coefficients; D is all zeros
    // between calls (the positions set are cleared again below)
    int rows = 0, twLog2 = std::min(log2W, 5);
    for (int c = 0; c < cur_eob; c++) {
      int pos = cur_scan[c], i = pos >> twLog2, j = pos & (tw - 1);
      int32_t qv = Quant[pos];
      if (!qv) continue;
      int q = pos == 0 ? dcQ : acQ;
      if (qm) q = round2((int64_t)q * qm[j * th + i], 5);
      int64_t dq = ((int64_t)std::abs(qv) * q) & 0xFFFFFF;
      dq >>= dqShift;
      if (qv < 0) dq = -dq;
      D[i][j] = clip3(-(1 << (7 + BitDepth)), (1 << (7 + BitDepth)) - 1, (int)dq);
      rows = std::max(rows, i + 1);
    }
    inverse_transform_2d(D, txSz, log2W, log2H, rows);
    for (int c = 0; c < cur_eob; c++) D[cur_scan[c] >> twLog2][cur_scan[c] & (tw - 1)] = 0;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int xx = flipLR ? (w - j - 1) : j, yy = flipUD ? (h - i - 1) : i;
        Pixel& px = P(p, y + yy, x + xx);
        px = (Pixel)clip1(px + Residual[i][j]);
      }
  }

  void inverse_transform_2d(int32_t (*D)[64], int txSz, int log2W, int log2H, int rows) {
    int w = 1 << log2W, h = 1 << log2H;
    int rowShift = Lossless ? 0 : Transform_Row_Shift[txSz];
    int colShift = Lossless ? 0 : 4;
    int t = PlaneTxType;
    int rowType, colType;  // 0 DCT, 1 ADST, 2 identity
    switch (t) {
      case DCT_DCT: rowType = 0; colType = 0; break;
      case ADST_DCT: rowType = 0; colType = 1; break;
      case DCT_ADST: rowType = 1; colType = 0; break;
      case ADST_ADST: rowType = 1; colType = 1; break;
      case FLIPADST_DCT: rowType = 0; colType = 1; break;
      case DCT_FLIPADST: rowType = 1; colType = 0; break;
      case FLIPADST_FLIPADST: case ADST_FLIPADST: case FLIPADST_ADST: rowType = 1; colType = 1; break;
      case IDTX: rowType = 2; colType = 2; break;
      case V_DCT: rowType = 2; colType = 0; break;
      case H_DCT: rowType = 0; colType = 2; break;
      case V_ADST: case V_FLIPADST: rowType = 2; colType = 1; break;
      default: rowType = 1; colType = 2; break;  // H_ADST, H_FLIPADST
    }
    // the clamps of 7.13.3: the row transform's input and steps at BitDepth +
    // 8 bits, the column transform's at Max(BitDepth + 6, 16)
    const int rowMax = (1 << (BitDepth + 7)) - 1, colMax = (1 << (std::max(BitDepth + 6, 16) - 1)) - 1;
    Tx1D tx;
    tx.lo = -rowMax - 1;
    tx.hi = rowMax;
    // a row of zero coefficients transforms to zeros (every 1-D transform
    // here is linear with Round2(0) = 0): only the `rows` up to the last
    // nonzero one are computed
    for (int i = 0; i < h; i++) {
      if (i >= rows) {
        for (int j = 0; j < w; j++) Residual[i][j] = 0;
        continue;
      }
      for (int j = 0; j < w; j++) tx.T[j] = (i < 32 && j < 32) ? D[i][j] : 0;
      if (std::abs(log2W - log2H) == 1)
        for (int j = 0; j < w; j++) tx.T[j] = round2((int64_t)tx.T[j] * 2896, 12);
      if (Lossless) {
        tx.wht(2);
      } else {
        for (int j = 0; j < w; j++) tx.T[j] = clip3(-rowMax - 1, rowMax, tx.T[j]);
        if (rowType == 0) tx.dct(log2W);
        else if (rowType == 1) {
          if (log2W == 2) tx.adst4();
          else if (log2W == 3) tx.adst8();
          else tx.adst16();
        } else {
          tx.identity(log2W);
        }
      }
      for (int j = 0; j < w; j++) Residual[i][j] = round2(tx.T[j], rowShift);
    }
    if (!Lossless)
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) Residual[i][j] = clip3(-colMax - 1, colMax, Residual[i][j]);
    tx.lo = -colMax - 1;
    tx.hi = colMax;
    for (int j = 0; j < w; j++) {
      for (int i = 0; i < h; i++) tx.T[i] = Residual[i][j];
      if (Lossless) {
        tx.wht(0);
      } else if (colType == 0) {
        tx.dct(log2H);
      } else if (colType == 1) {
        if (log2H == 2) tx.adst4();
        else if (log2H == 3) tx.adst8();
        else tx.adst16();
      } else {
        tx.identity(log2H);
      }
      for (int i = 0; i < h; i++) Residual[i][j] = Lossless ? tx.T[i] : round2(tx.T[i], colShift);
    }
  }

  // ---------------------------------------------------- intra prediction
  int AboveRowBuf[64 * 2 + 64 + 32], LeftColBuf[64 * 2 + 64 + 32];
  int* AboveRow = AboveRowBuf + 16;
  int* LeftCol = LeftColBuf + 16;
  Pixel pred[64][64];

  int is_smooth(int row, int col, int p) {
    int mode = p == 0 ? YModes[mi(row, col)] : UVModes[mi(row, col)];
    return mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED;
  }
  int get_filter_type(int p) {
    int aboveSmooth = 0, leftSmooth = 0;
    if (p == 0 ? AvailU : AvailUChroma) {
      int r = MiRow - 1, c = MiCol;
      if (p > 0) {
        if (seq.ss_x && !(MiCol & 1)) c++;
        if (seq.ss_y && (MiRow & 1)) r--;
      }
      aboveSmooth = is_smooth(r, c, p);
    }
    if (p == 0 ? AvailL : AvailLChroma) {
      int r = MiRow, c = MiCol - 1;
      if (p > 0) {
        if (seq.ss_x && (MiCol & 1)) c--;
        if (seq.ss_y && !(MiRow & 1)) r++;
      }
      leftSmooth = is_smooth(r, c, p);
    }
    return aboveSmooth || leftSmooth;
  }
  static int edge_strength(int w, int h, int filterType, int delta) {
    int d = std::abs(delta), blkWh = w + h, s = 0;
    if (filterType == 0) {
      if (blkWh <= 8) { if (d >= 56) s = 1; }
      else if (blkWh <= 12) { if (d >= 40) s = 1; }
      else if (blkWh <= 16) { if (d >= 40) s = 1; }
      else if (blkWh <= 24) { if (d >= 8) s = 1; if (d >= 16) s = 2; if (d >= 32) s = 3; }
      else if (blkWh <= 32) { if (d >= 1) s = 1; if (d >= 4) s = 2; if (d >= 32) s = 3; }
      else { if (d >= 1) s = 3; }
    } else {
      if (blkWh <= 8) { if (d >= 40) s = 1; if (d >= 64) s = 2; }
      else if (blkWh <= 16) { if (d >= 20) s = 1; if (d >= 48) s = 2; }
      else if (blkWh <= 24) { if (d >= 4) s = 3; }
      else { if (d >= 1) s = 3; }
    }
    return s;
  }
  static int use_upsample(int w, int h, int filterType, int delta) {
    int d = std::abs(delta), blkWh = w + h;
    if (d <= 0 || d >= 40) return 0;
    return filterType == 0 ? blkWh <= 16 : blkWh <= 8;
  }
  void edge_filter(int* buf, int sz, int strength) {
    if (!strength) return;
    int edge[160];
    for (int i = 0; i < sz; i++) edge[i] = buf[i - 1];
    for (int i = 1; i < sz; i++) {
      int s = 0;
      for (int j = 0; j < 5; j++) {
        int k = clip3(0, sz - 1, i - 2 + j);
        s += Intra_Edge_Kernel[strength - 1][j] * edge[k];
      }
      buf[i - 1] = (s + 8) >> 4;
    }
  }
  void upsample(int* buf, int numPx) {
    int dup[80];
    dup[0] = buf[-1];
    for (int i = -1; i < numPx; i++) dup[i + 2] = buf[i];
    dup[numPx + 2] = buf[numPx - 1];
    buf[-2] = dup[0];
    for (int i = 0; i < numPx; i++) {
      int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
      s = clip1(round2(s, 4));
      buf[2 * i - 1] = s;
      buf[2 * i] = dup[i + 2];
    }
  }

  void predict_intra(int p, int x, int y, int haveLeft, int haveAbove, int haveAboveRight, int haveBelowLeft,
                     int mode, int log2W, int log2H) {
    int w = 1 << log2W, h = 1 << log2H;
    int sx = p ? seq.ss_x : 0, sy = p ? seq.ss_y : 0;
    int maxX = ((MiCols * 4) >> sx) - 1, maxY = ((MiRows * 4) >> sy) - 1;
    const int half = 1 << (BitDepth - 1);  // the missing edges' value
    if (haveAbove == 0 && haveLeft == 1) {
      for (int i = -1; i < w + h; i++) AboveRow[i] = P(p, y, x - 1);
    } else if (haveAbove == 0 && haveLeft == 0) {
      for (int i = -1; i < w + h; i++) AboveRow[i] = half - 1;
    } else {
      int aboveLimit = std::min(maxX, x + (haveAboveRight ? 2 * w : w) - 1);
      for (int i = 0; i < w + h; i++) AboveRow[i] = P(p, y - 1, std::min(aboveLimit, x + i));
    }
    if (haveLeft == 0 && haveAbove == 1) {
      for (int i = -1; i < w + h; i++) LeftCol[i] = P(p, y - 1, x);
    } else if (haveLeft == 0 && haveAbove == 0) {
      for (int i = -1; i < w + h; i++) LeftCol[i] = half + 1;
    } else {
      int leftLimit = std::min(maxY, y + (haveBelowLeft ? 2 * h : h) - 1);
      for (int i = 0; i < w + h; i++) LeftCol[i] = P(p, std::min(leftLimit, y + i), x - 1);
    }
    int corner;
    if (haveAbove && haveLeft) corner = P(p, y - 1, x - 1);
    else if (haveAbove) corner = P(p, y - 1, x);
    else if (haveLeft) corner = P(p, y, x - 1);
    else corner = half;
    AboveRow[-1] = corner;
    LeftCol[-1] = corner;

    if (p == 0 && use_filter_intra) {
      int w4 = w >> 2, h2 = h >> 1;
      for (int i2 = 0; i2 < h2; i2++)
        for (int j4 = 0; j4 < w4; j4++) {
          int pv[7];
          for (int i = 0; i < 7; i++) {
            if (i < 5) {
              if (i2 == 0) pv[i] = AboveRow[(j4 << 2) + i - 1];
              else if (j4 == 0 && i == 0) pv[i] = LeftCol[(i2 << 1) - 1];
              else pv[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
            } else {
              if (j4 == 0) pv[i] = LeftCol[(i2 << 1) + i - 5];
              else pv[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
            }
          }
          for (int i = 0; i < 8; i++) {
            int pr = 0;
            for (int j = 0; j < 7; j++) pr += Filter_Intra_Taps[filter_intra_mode][i][j] * pv[j];
            pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] = (Pixel)clip1(round2signed(pr, 4));
          }
        }
    } else if (mode >= V_PRED && mode <= D67_PRED) {
      int angleDelta = p == 0 ? AngleDeltaY : AngleDeltaUV;
      int pAngle = Mode_To_Angle[mode] + angleDelta * 3;
      int upsampleAbove = 0, upsampleLeft = 0;
      if (seq.enable_intra_edge_filter) {
        if (pAngle != 90 && pAngle != 180) {
          if (pAngle > 90 && pAngle < 180 && (w + h) >= 24) {
            int v = round2(LeftCol[0] * 5 + AboveRow[-1] * 6 + AboveRow[0] * 5, 4);
            LeftCol[-1] = v;
            AboveRow[-1] = v;
          }
          int filterType = get_filter_type(p);
          if (haveAbove) {
            int strength = edge_strength(w, h, filterType, pAngle - 90);
            int numPx = std::min(w, maxX - x + 1) + (pAngle < 90 ? h : 0) + 1;
            edge_filter(AboveRow, numPx, strength);
          }
          if (haveLeft) {
            int strength = edge_strength(w, h, filterType, pAngle - 180);
            int numPx = std::min(h, maxY - y + 1) + (pAngle > 180 ? w : 0) + 1;
            edge_filter(LeftCol, numPx, strength);
          }
          upsampleAbove = use_upsample(w, h, filterType, pAngle - 90);
          if (upsampleAbove) upsample(AboveRow, w + (pAngle < 90 ? h : 0));
          upsampleLeft = use_upsample(w, h, filterType, pAngle - 180);
          if (upsampleLeft) upsample(LeftCol, h + (pAngle > 180 ? w : 0));
        }
      }
      int dx = 0, dy = 0;
      if (pAngle < 90) dx = Dr_Intra_Derivative[pAngle];
      else if (pAngle > 90 && pAngle < 180) dx = Dr_Intra_Derivative[180 - pAngle];
      if (pAngle > 90 && pAngle < 180) dy = Dr_Intra_Derivative[pAngle - 90];
      else if (pAngle > 180) dy = Dr_Intra_Derivative[270 - pAngle];
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int v;
          if (pAngle < 90) {
            int idx = (i + 1) * dx;
            int base = (idx >> (6 - upsampleAbove)) + (j << upsampleAbove);
            int shift = ((idx << upsampleAbove) >> 1) & 0x1F;
            int maxBaseX = (w + h - 1) << upsampleAbove;
            if (base < maxBaseX) v = round2(AboveRow[base] * (32 - shift) + AboveRow[base + 1] * shift, 5);
            else v = AboveRow[maxBaseX];
          } else if (pAngle > 90 && pAngle < 180) {
            int idx = (j << 6) - (i + 1) * dx;
            int base = idx >> (6 - upsampleAbove);
            if (base >= -(1 << upsampleAbove)) {
              int shift = ((idx * (1 << upsampleAbove)) >> 1) & 0x1F;
              v = round2(AboveRow[base] * (32 - shift) + AboveRow[base + 1] * shift, 5);
            } else {
              idx = (i << 6) - (j + 1) * dy;
              base = idx >> (6 - upsampleLeft);
              int shift = ((idx * (1 << upsampleLeft)) >> 1) & 0x1F;
              v = round2(LeftCol[base] * (32 - shift) + LeftCol[base + 1] * shift, 5);
            }
          } else if (pAngle > 180) {
            int idx = (j + 1) * dy;
            int base = (idx >> (6 - upsampleLeft)) + (i << upsampleLeft);
            int shift = ((idx << upsampleLeft) >> 1) & 0x1F;
            int maxBaseY = (w + h - 1) << upsampleLeft;
            if (base < maxBaseY) v = round2(LeftCol[base] * (32 - shift) + LeftCol[base + 1] * shift, 5);
            else v = LeftCol[maxBaseY];
          } else if (pAngle == 90) {
            v = AboveRow[j];
          } else {
            v = LeftCol[i];
          }
          pred[i][j] = (Pixel)v;
        }
    } else if (mode == SMOOTH_PRED) {
      const uint8_t* wX = Sm_Weights + (w - 4);
      const uint8_t* wY = Sm_Weights + (h - 4);
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int s = wY[i] * AboveRow[j] + (256 - wY[i]) * LeftCol[h - 1] + wX[j] * LeftCol[i] +
                  (256 - wX[j]) * AboveRow[w - 1];
          pred[i][j] = (Pixel)round2(s, 9);
        }
    } else if (mode == SMOOTH_V_PRED) {
      const uint8_t* wY = Sm_Weights + (h - 4);
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
          pred[i][j] = (Pixel)round2(wY[i] * AboveRow[j] + (256 - wY[i]) * LeftCol[h - 1], 8);
    } else if (mode == SMOOTH_H_PRED) {
      const uint8_t* wX = Sm_Weights + (w - 4);
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
          pred[i][j] = (Pixel)round2(wX[j] * LeftCol[i] + (256 - wX[j]) * AboveRow[w - 1], 8);
    } else if (mode == DC_PRED) {
      int avg;
      if (haveLeft && haveAbove) {
        int sum = 0;
        for (int k = 0; k < w; k++) sum += AboveRow[k];
        for (int k = 0; k < h; k++) sum += LeftCol[k];
        avg = (sum + ((w + h) >> 1)) / (w + h);
      } else if (haveLeft) {
        int sum = 0;
        for (int k = 0; k < h; k++) sum += LeftCol[k];
        avg = (sum + (h >> 1)) >> log2H;
      } else if (haveAbove) {
        int sum = 0;
        for (int k = 0; k < w; k++) sum += AboveRow[k];
        avg = (sum + (w >> 1)) >> log2W;
      } else {
        avg = half;
      }
      for (int i = 0; i < h; i++) std::fill(pred[i], pred[i] + w, (Pixel)avg);
    } else {  // PAETH
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int base = AboveRow[j] + LeftCol[i] - AboveRow[-1];
          int pLeft = std::abs(base - LeftCol[i]), pTop = std::abs(base - AboveRow[j]);
          int pTopLeft = std::abs(base - AboveRow[-1]);
          int v;
          if (pLeft <= pTop && pLeft <= pTopLeft) v = LeftCol[i];
          else if (pTop <= pTopLeft) v = AboveRow[j];
          else v = AboveRow[-1];
          pred[i][j] = (Pixel)v;
        }
    }
    for (int i = 0; i < h; i++) memcpy(&P(p, y + i, x), pred[i], w * sizeof(Pixel));
  }

  void predict_chroma_from_luma(int p, int startX, int startY, int txSz) {
    int w = Tx_Width[txSz], h = Tx_Height[txSz];
    int sx = seq.ss_x, sy = seq.ss_y;
    int alpha = p == 1 ? CflAlphaU : CflAlphaV;
    int64_t lumaAvg = 0;
    for (int i = 0; i < h; i++) {
      int lumaY = std::min((startY + i) << sy, MaxLumaH - (1 << sy));
      for (int j = 0; j < w; j++) {
        int lumaX = std::min((startX + j) << sx, MaxLumaW - (1 << sx));
        int t = 0;
        for (int dy = 0; dy <= sy; dy++)
          for (int dx = 0; dx <= sx; dx++) t += P(0, lumaY + dy, lumaX + dx);
        int v = t << (3 - sx - sy);
        L[i][j] = v;
        lumaAvg += v;
      }
    }
    int avg = round2(lumaAvg, Tx_Width_Log2[txSz] + Tx_Height_Log2[txSz]);
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        Pixel& px = P(p, startY + i, startX + j);
        int scaled = round2signed((int64_t)alpha * (L[i][j] - avg), 6);
        px = (Pixel)clip1(px + scaled);
      }
  }

  // --------------------------------------------------------- loop filter
  void loop_filter() {
    if (!loop_filter_level[0] && !loop_filter_level[1]) return;
    for (int p = 0; p < NumPlanes; p++) {
      if (p > 0 && !loop_filter_level[p + 1]) continue;
      int sx = p ? seq.ss_x : 0, sy = p ? seq.ss_y : 0;
      for (int pass = 0; pass < 2; pass++) {
        int rowStep = p == 0 ? 1 : (1 << sy), colStep = p == 0 ? 1 : (1 << sx);
        for (int row = 0; row < MiRows; row += rowStep)
          for (int col = 0; col < MiCols; col += colStep) edge_loop_filter(p, pass, row, col, sx, sy);
      }
    }
  }

  int filter_level(int row, int col, int p, int pass) {
    size_t k = mi(row, col);
    int segment = SegmentIds[k];
    int deltaLF = delta_lf_multi ? DeltaLFs[k * 4 + (p == 0 ? pass : p + 1)] : DeltaLFs[k * 4];
    int i = p == 0 ? pass : p + 1;
    int base = clip3(0, 63, deltaLF + loop_filter_level[i]);
    int lvlSeg = base;
    int feature = SEG_LVL_ALT_LF_Y_V + i;
    if (segmentation_enabled && FeatureEnabled[segment][feature])
      lvlSeg = clip3(0, 63, lvlSeg + FeatureData[segment][feature]);
    if (loop_filter_delta_enabled) {
      int nShift = lvlSeg >> 5;
      lvlSeg += loop_filter_ref_deltas[0] * (1 << nShift);  // every block is intra
      lvlSeg = clip3(0, 63, lvlSeg);
    }
    return lvlSeg;
  }

  void edge_loop_filter(int p, int pass, int row, int col, int sx, int sy) {
    int dx = pass == 0 ? 1 : 0, dy = pass == 1 ? 1 : 0;
    int x = col * 4, y = row * 4;
    row |= sy;
    col |= sx;
    int onScreen;
    if (x >= FrameWidth) onScreen = 0;
    else if (y >= FrameHeight) onScreen = 0;
    else if (pass == 0 && x == 0) onScreen = 0;
    else if (pass == 1 && y == 0) onScreen = 0;
    else onScreen = 1;
    if (!onScreen) return;
    int xP = x >> sx, yP = y >> sy;
    int prevRow = row - (dy << sy), prevCol = col - (dx << sx);
    int txSz = LfTxSizes[p][mi(row >> sy, col >> sx)];
    int prevTxSz = LfTxSizes[p][mi(prevRow >> sy, prevCol >> sx)];
    int isTxEdge = pass == 0 ? (xP % Tx_Width[txSz] == 0) : (yP % Tx_Height[txSz] == 0);
    int applyFilter = isTxEdge;  // intra blocks: every transform edge, block edges among them
    if (!applyFilter) return;
    int baseSize = pass == 0 ? std::min(Tx_Width[prevTxSz], Tx_Width[txSz])
                             : std::min(Tx_Height[prevTxSz], Tx_Height[txSz]);
    int filterSize = p == 0 ? std::min(16, baseSize) : std::min(8, baseSize);
    int lvl = filter_level(row, col, p, pass);
    if (lvl == 0) lvl = filter_level(prevRow, prevCol, p, pass);
    if (lvl == 0) return;
    int shift = loop_filter_sharpness > 4 ? 2 : (loop_filter_sharpness > 0 ? 1 : 0);
    int limit = loop_filter_sharpness > 0 ? clip3(1, 9 - loop_filter_sharpness, lvl >> shift)
                                          : std::max(1, lvl >> shift);
    int blimit = 2 * (lvl + 2) + limit;
    int thresh = lvl >> 4;
    for (int i = 0; i < 4; i++)
      sample_filtering(xP + dy * i, yP + dx * i, p, limit, blimit, thresh, dy, filterSize);
  }

  // 7.14.6.2-4, the limits and the narrow filter's range shifted by
  // BitDepth - 8
  void sample_filtering(int x, int y, int p, int limit, int blimit, int thresh, int dy, int filterSize) {
    Pixel* q = &P(p, y, x);
    const int step = dy ? pw[p] : 1;
    auto F = [q, step](int k) -> Pixel& { return q[k * step]; };
    const int bd = BitDepth - 8, one = 1 << bd;
    limit <<= bd;
    blimit <<= bd;
    thresh <<= bd;
    int q0 = F(0), q1 = F(1), q2 = F(2), q3 = F(3);
    int p0 = F(-1), p1 = F(-2), p2 = F(-3), p3 = F(-4);
    int hevMask = std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
    int filterLen;
    if (filterSize == 4) filterLen = 4;
    else if (p != 0) filterLen = 6;
    else if (filterSize == 8) filterLen = 8;
    else filterLen = 16;
    int mask = std::abs(p1 - p0) <= limit && std::abs(q1 - q0) <= limit &&
               std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 <= blimit;
    if (filterLen >= 6) mask = mask && std::abs(p2 - p1) <= limit && std::abs(q2 - q1) <= limit;
    if (filterLen >= 8) mask = mask && std::abs(p3 - p2) <= limit && std::abs(q3 - q2) <= limit;
    if (!mask) return;
    int flatMask = 0, flatMask2 = 0;
    if (filterSize >= 8) {
      if (filterLen == 6)
        flatMask = std::abs(p1 - p0) <= one && std::abs(q1 - q0) <= one && std::abs(p2 - p0) <= one &&
                   std::abs(q2 - q0) <= one;
      else
        flatMask = std::abs(p1 - p0) <= one && std::abs(q1 - q0) <= one && std::abs(p2 - p0) <= one &&
                   std::abs(q2 - q0) <= one && std::abs(p3 - p0) <= one && std::abs(q3 - q0) <= one;
    }
    if (filterSize >= 16) {
      int q4 = F(4), q5 = F(5), q6 = F(6), p4 = F(-5), p5 = F(-6), p6 = F(-7);
      flatMask2 = std::abs(p6 - p0) <= one && std::abs(q6 - q0) <= one && std::abs(p5 - p0) <= one &&
                  std::abs(q5 - q0) <= one && std::abs(p4 - p0) <= one && std::abs(q4 - q0) <= one;
    }
    if (filterSize == 4 || !flatMask) {
      const int lo = -(1 << (BitDepth - 1)), hi = (1 << (BitDepth - 1)) - 1, mid = 0x80 << bd;
      auto c4 = [lo, hi](int v) { return clip3(lo, hi, v); };
      int ps1 = p1 - mid, ps0 = p0 - mid, qs0 = q0 - mid, qs1 = q1 - mid;
      int filter = hevMask ? c4(ps1 - qs1) : 0;
      filter = c4(filter + 3 * (qs0 - ps0));
      int filter1 = c4(filter + 4) >> 3;
      int filter2 = c4(filter + 3) >> 3;
      F(0) = (Pixel)(c4(qs0 - filter1) + mid);
      F(-1) = (Pixel)(c4(ps0 + filter2) + mid);
      if (!hevMask) {
        filter = round2(filter1, 1);
        F(1) = (Pixel)(c4(qs1 - filter) + mid);
        F(-2) = (Pixel)(c4(ps1 + filter) + mid);
      }
    } else {
      int log2Size = (filterSize == 8 || !flatMask2) ? 3 : 4;
      int n = log2Size == 4 ? 6 : (p == 0 ? 3 : 2);
      int n2 = (log2Size == 3 && p == 0) ? 0 : 1;
      int v[16], out[16];
      for (int k = -(n + 1); k <= n; k++) v[k + 8] = F(k);
      for (int i = -n; i < n; i++) {
        int t = 0;
        for (int j = -n; j <= n; j++) {
          int pp = clip3(-(n + 1), n, i + j);
          int tap = std::abs(j) <= n2 ? 2 : 1;
          t += v[pp + 8] * tap;
        }
        out[i + 8] = round2(t, log2Size);
      }
      for (int i = -n; i < n; i++) F(i) = (Pixel)out[i + 8];
    }
  }

  // ---------------------------------------------------------------- CDEF
  // 7.15: every 8x8 block of a 64x64 whose cdef_idx is not -1, unless all
  // four of its 4x4 units are skip, is filtered from the deblocked frame
  // (`deblocked`) into `plane`, which starts as its copy.
  void cdef() {
    tools[1] = seq.enable_cdef && !CodedLossless && !allow_intrabc ? cdef_bits : -1;
    for (int fbr = 0; fbr < MiRows; fbr += 16)
      for (int fbc = 0; fbc < MiCols; fbc += 16) {
        int idx = cdef_idx[mi(fbr, fbc)];
        if (idx == -1) continue;
        for (int r = fbr; r < std::min(fbr + 16, MiRows); r += 2)
          for (int c = fbc; c < std::min(fbc + 16, MiCols); c += 2) {
            if (Skips[mi(r, c)] && Skips[mi(r + 1, c)] && Skips[mi(r, c + 1)] && Skips[mi(r + 1, c + 1)]) continue;
            cdef_block(r, c, idx);
          }
      }
  }

  // the strengths and the damping shifted by coeffShift = BitDepth - 8
  void cdef_block(int r, int c, int idx) {
    const int coeffShift = BitDepth - 8;
    int var = 0;
    int yDir = cdef_direction(r, c, var);
    int priStr = cdef_y_pri[idx] << coeffShift, secStr = cdef_y_sec[idx] << coeffShift;
    int dir = priStr == 0 ? 0 : yDir;
    int varStr = (var >> 6) ? std::min(floor_log2((uint32_t)(var >> 6)), 12) : 0;
    int adjusted = var ? (priStr * (4 + varStr) + 8) >> 4 : 0;
    cdef_filter(0, r, c, adjusted, secStr, CdefDamping + coeffShift, dir);
    count_cdef(0, priStr, secStr);
    if (NumPlanes == 1) return;
    priStr = cdef_uv_pri[idx] << coeffShift;
    secStr = cdef_uv_sec[idx] << coeffShift;
    dir = priStr == 0 ? 0 : Cdef_Uv_Dir[seq.ss_x][seq.ss_y][yDir];
    for (int p = 1; p < 3; p++) {
      cdef_filter(p, r, c, priStr, secStr, CdefDamping - 1 + coeffShift, dir);
      count_cdef(p, priStr, secStr);
    }
  }
  // tools[7 + 3 * plane + k]: 8x8 blocks filtered with a primary strength
  // only (k 0), a secondary only (1), or both (2), as signalled
  void count_cdef(int p, int pri, int sec) {
    if (pri || sec) tools[7 + 3 * p + (pri && sec ? 2 : (pri ? 0 : 1))]++;
  }

  int cdef_direction(int r, int c, int& var) {
    int cost[8] = {0}, partial[8][15] = {{0}};
    int x0 = c * 4, y0 = r * 4;
    const Pixel* src = deblocked[0].data();
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++) {
        int x = (src[(size_t)(y0 + i) * pw[0] + x0 + j] >> (BitDepth - 8)) - 128;
        partial[0][i + j] += x;
        partial[1][i + j / 2] += x;
        partial[2][i] += x;
        partial[3][3 + i - j / 2] += x;
        partial[4][7 + i - j] += x;
        partial[5][3 - i / 2 + j] += x;
        partial[6][j] += x;
        partial[7][i / 2 + j] += x;
      }
    for (int i = 0; i < 8; i++) {
      cost[2] += partial[2][i] * partial[2][i];
      cost[6] += partial[6][i] * partial[6][i];
    }
    cost[2] *= Div_Table[8];
    cost[6] *= Div_Table[8];
    for (int i = 0; i < 7; i++) {
      cost[0] += (partial[0][i] * partial[0][i] + partial[0][14 - i] * partial[0][14 - i]) * Div_Table[i + 1];
      cost[4] += (partial[4][i] * partial[4][i] + partial[4][14 - i] * partial[4][14 - i]) * Div_Table[i + 1];
    }
    cost[0] += partial[0][7] * partial[0][7] * Div_Table[8];
    cost[4] += partial[4][7] * partial[4][7] * Div_Table[8];
    for (int i = 1; i < 8; i += 2) {
      for (int j = 0; j < 5; j++) cost[i] += partial[i][3 + j] * partial[i][3 + j];
      cost[i] *= Div_Table[8];
      for (int j = 0; j < 3; j++)
        cost[i] += (partial[i][j] * partial[i][j] + partial[i][10 - j] * partial[i][10 - j]) * Div_Table[2 * j + 2];
    }
    int bestCost = 0, yDir = 0;
    for (int i = 0; i < 8; i++)
      if (cost[i] > bestCost) {
        bestCost = cost[i];
        yDir = i;
      }
    var = (bestCost - cost[(yDir + 4) & 7]) >> 10;
    return yDir;
  }

  // constrain() of 7.15.2 with its damping shift worked out once per strength
  static int constrain(int diff, int threshold, int dampingAdj) {
    int a = std::abs(diff);
    int val = std::min(a, std::max(0, threshold - (a >> dampingAdj)));
    return diff < 0 ? -val : val;
  }

  void cdef_filter(int p, int r, int c, int priStr, int secStr, int damping, int dir) {
    int sx = p ? seq.ss_x : 0, sy = p ? seq.ss_y : 0;
    int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy, w = 8 >> sx, h = 8 >> sy;
    // the block and the 2 samples its taps reach on each side, -1 where a
    // sample is not available: a sample is where its 4x4 unit lies in the
    // frame (MiRows x MiCols), the decoded padding past the picture's edge
    // included (cdef_get_at, is_inside_filter_region)
    int rows = (MiRows * 4) >> sy, cols = (MiCols * 4) >> sx;
    const int S = 12;
    int buf[S * S];
    for (int i = -2; i < h + 2; i++)
      for (int j = -2; j < w + 2; j++) {
        int y = y0 + i, x = x0 + j;
        bool ok = y >= 0 && x >= 0 && y < rows && x < cols;
        buf[(i + 2) * S + j + 2] = ok ? deblocked[p][(size_t)y * pw[p] + x] : -1;
      }
    // the 12 taps: (offset, weight, strength, damping shift); a zero
    // strength's taps add nothing but still bound the clip
    struct Tap {
      int off, weight, strength, adj;
    } taps[12];
    int nt = 0;
    int priAdj = priStr ? std::max(0, damping - floor_log2((uint32_t)priStr)) : 0;
    int secAdj = secStr ? std::max(0, damping - floor_log2((uint32_t)secStr)) : 0;
    const int odd = (priStr >> (BitDepth - 8)) & 1;
    for (int k = 0; k < 2; k++)
      for (int sign = -1; sign <= 1; sign += 2) {
        const int* d = Cdef_Directions[dir][k];
        taps[nt++] = {sign * (d[0] * S + d[1]), Cdef_Pri_Taps[odd][k], priStr, priAdj};
        for (int dirOff = -2; dirOff <= 2; dirOff += 4) {
          d = Cdef_Directions[(dir + dirOff) & 7][k];
          taps[nt++] = {sign * (d[0] * S + d[1]), Cdef_Sec_Taps[odd][k], secStr, secAdj};
        }
      }
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        const int* s0 = buf + (i + 2) * S + j + 2;
        int x = *s0, sum = 0, mx = x, mn = x;
        for (const Tap& t : taps) {
          int v = s0[t.off];
          if (v < 0) continue;
          sum += t.weight * constrain(v - x, t.strength, t.adj);
          mx = std::max(v, mx);
          mn = std::min(v, mn);
        }
        P(p, y0 + i, x0 + j) = (Pixel)clip3(mn, mx, x + ((8 + sum - (sum < 0)) >> 4));
      }
  }

  // ---------------------------------------------------- loop restoration
  // 7.17: each plane's pixels, a rectangle at a time where one restoration
  // unit meets one stripe (64 luma rows, 8 rows up), read from the CDEF
  // output (`plane`) inside the stripe and from the deblocked frame up to
  // 2 rows above and below it (get_source_sample, 7.17.6), into `out`.
  void loop_restoration() {
    for (int p = 0; p < NumPlanes; p++) {
      if (FrameRestorationType[p] == RESTORE_NONE) continue;
      int sx = p ? seq.ss_x : 0, sy = p ? seq.ss_y : 0;
      int unitSize = LoopRestorationSize[p];
      int endX = round2(FrameWidth, sx) - 1, endY = round2(FrameHeight, sy) - 1;
      for (const LrUnit& u : LrUnits[p])
        if (u.type != RESTORE_NONE) tools[16 + 3 * p + lr_kind(u)]++;
      std::vector<Pixel> out(plane[p]);
      // the luma 4x4 rows of the spec's walk, in runs of one stripe and
      // one unit row
      for (int row = 0; row * 4 < FrameHeight;) {
        auto stripe = [](int rw) { return (rw * 4 + 8) / 64; };
        auto unit_row = [&](int rw) { return std::min(unitRows[p] - 1, ((rw * 4 + 8) >> sy) / unitSize); };
        int next = row + 1;
        while (next * 4 < FrameHeight && stripe(next) == stripe(row) && unit_row(next) == unit_row(row)) next++;
        int y0 = (row * 4) >> sy, y1 = std::min(endY, ((next * 4) >> sy) - 1);
        int stripeStart = (-8 + stripe(row) * 64) >> sy, stripeEnd = stripeStart + (64 >> sy) - 1;
        for (int uc = 0; uc < unitCols[p]; uc++) {
          const LrUnit& u = LrUnits[p][(size_t)unit_row(row) * unitCols[p] + uc];
          int x0 = uc * unitSize, x1 = uc == unitCols[p] - 1 ? endX : std::min(endX, x0 + unitSize - 1);
          if (u.type == RESTORE_NONE || x0 > x1 || y0 > y1) continue;
          Window win(*this, p, x0, y0, x1 - x0 + 1, y1 - y0 + 1, endX, endY, stripeStart, stripeEnd);
          if (u.type == RESTORE_WIENER) wiener_filter(win, u, out.data(), pw[p]);
          else self_guided_filter(win, u, out.data(), pw[p]);
        }
        row = next;
      }
      plane[p].swap(out);
    }
  }
  // tools[16 + 3 * plane + k]: the plane's units filtered by Wiener (k 0),
  // by the self-guided filter with both radii (1), or with one radius 0 (2)
  static int lr_kind(const LrUnit& u) {
    if (u.type == RESTORE_WIENER) return 0;
    return Sgr_Params[u.set][0] && Sgr_Params[u.set][2] ? 1 : 2;
  }

  // The samples get_source_sample gives around a w x h rectangle at (x0,
  // y0): 3 more on each side (the Wiener taps; the 5x5 box sums at one
  // sample past the rectangle).
  struct Window {
    static const int M = 3;
    int x0, y0, w, h, stride;
    std::vector<int> v;
    Window(Decoder& d, int p, int x0_, int y0_, int w_, int h_, int endX, int endY, int stripeStart, int stripeEnd)
        : x0(x0_), y0(y0_), w(w_), h(h_), stride(w_ + 2 * M), v((size_t)(h_ + 2 * M) * (w_ + 2 * M)) {
      for (int i = -M; i < h + M; i++) {
        int y = clip3(0, endY, y0 + i);
        const Pixel* src = d.plane[p].data();
        if (y < stripeStart) {
          y = std::max(stripeStart - 2, y);
          src = d.deblocked[p].data();
        } else if (y > stripeEnd) {
          y = std::min(stripeEnd + 2, y);
          src = d.deblocked[p].data();
        }
        const Pixel* line = src + (size_t)y * d.pw[p];
        for (int j = -M; j < w + M; j++) at(i, j) = line[clip3(0, endX, x0 + j)];
      }
    }
    int& at(int i, int j) { return v[(size_t)(i + M) * stride + j + M]; }
  };

  // 7.17.4, with 7.11.3.2's rounding for isCompound 0 (InterRound0 3 and
  // InterRound1 11, 5 and 9 at 12 bits)
  void wiener_filter(Window& win, const LrUnit& u, Pixel* out, int stride) {
    const int InterRound0 = BitDepth == 12 ? 5 : 3, InterRound1 = BitDepth == 12 ? 9 : 11, FILTER_BITS = 7;
    int f[2][7];  // [0] vertical, [1] horizontal
    for (int pass = 0; pass < 2; pass++) {
      f[pass][3] = 128;
      for (int i = 0; i < 3; i++) {
        int c = u.wiener[pass][i];
        f[pass][i] = f[pass][6 - i] = c;
        f[pass][3] -= 2 * c;
      }
    }
    int offset = 1 << (BitDepth + FILTER_BITS - InterRound0 - 1);
    int limit = (1 << (BitDepth + 1 + FILTER_BITS - InterRound0)) - 1;
    int w = win.w, h = win.h;
    std::vector<int> inter((size_t)(h + 6) * w);
    for (int r = 0; r < h + 6; r++)
      for (int c = 0; c < w; c++) {
        int s = 0;
        for (int t = 0; t < 7; t++) s += f[1][t] * win.at(r - 3, c + t - 3);
        inter[(size_t)r * w + c] = clip3(-offset, limit - offset, round2(s, InterRound0));
      }
    for (int r = 0; r < h; r++)
      for (int c = 0; c < w; c++) {
        int s = 0;
        for (int t = 0; t < 7; t++) s += f[0][t] * inter[(size_t)(r + t) * w + c];
        out[(size_t)(win.y0 + r) * stride + win.x0 + c] = (Pixel)clip1(round2(s, InterRound1));
      }
  }

  // 7.17.3's box filter of one pass (pass 0: r = 2, a and b on every other
  // row; pass 1: r = 1) over the rectangle: F, in SGRPROJ_RST_BITS; the
  // variance from sums brought to 8 bits (Round2 by 2 * (BitDepth - 8) and
  // BitDepth - 8)
  void box_filter(Window& win, int set, int pass, std::vector<int>& F) {
    int r = Sgr_Params[set][pass * 2], s = Sgr_Params[set][pass * 2 + 1];
    int n = (2 * r + 1) * (2 * r + 1);
    int oneOverN = ((1 << SGRPROJ_RECIP_BITS) + (n / 2)) / n;
    int w = win.w, h = win.h, aw = w + 2;
    std::vector<int> A((size_t)(h + 2) * aw), B((size_t)(h + 2) * aw);
    for (int i = -1; i < h + 1; i++) {
      if (pass == 0 && !((win.y0 + i) & 1)) continue;  // only odd rows are read
      for (int j = -1; j < w + 1; j++) {
        int a = 0, b = 0;
        for (int dy = -r; dy <= r; dy++)
          for (int dx = -r; dx <= r; dx++) {
            int c = win.at(i + dy, j + dx);
            a += c * c;
            b += c;
          }
        int a8 = round2(a, 2 * (BitDepth - 8)), b8 = round2(b, BitDepth - 8);
        int p = std::max(0, a8 * n - b8 * b8);
        int z = (int)round2((int64_t)p * s, SGRPROJ_MTABLE_BITS);
        int a2 = z >= 255 ? 256 : (z == 0 ? 1 : ((z << SGRPROJ_SGR_BITS) + (z / 2)) / (z + 1));
        int64_t b2 = (int64_t)((1 << SGRPROJ_SGR_BITS) - a2) * b * oneOverN;
        A[(size_t)(i + 1) * aw + j + 1] = a2;
        B[(size_t)(i + 1) * aw + j + 1] = round2(b2, SGRPROJ_RECIP_BITS);
      }
    }
    F.assign((size_t)h * w, 0);
    for (int i = 0; i < h; i++) {
      int odd = (win.y0 + i) & 1;
      int shift = pass == 0 && odd ? 4 : 5;
      for (int j = 0; j < w; j++) {
        int a = 0, b = 0;
        for (int dy = -1; dy <= 1; dy++)
          for (int dx = -1; dx <= 1; dx++) {
            int weight;
            if (pass == 0) weight = ((win.y0 + i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
            else weight = (dx == 0 || dy == 0) ? 4 : 3;
            if (!weight) continue;
            size_t k = (size_t)(i + dy + 1) * aw + j + dx + 1;
            a += weight * A[k];
            b += weight * B[k];
          }
        int v = a * win.at(i, j) + b;
        F[(size_t)i * w + j] = round2(v, SGRPROJ_SGR_BITS + shift - SGRPROJ_RST_BITS);
      }
    }
  }

  // 7.17.3
  void self_guided_filter(Window& win, const LrUnit& u, Pixel* out, int stride) {
    std::vector<int> flt0, flt1;
    int r0 = Sgr_Params[u.set][0], r1 = Sgr_Params[u.set][2];
    if (r0) box_filter(win, u.set, 0, flt0);
    if (r1) box_filter(win, u.set, 1, flt1);
    int w0 = u.xqd[0], w1 = u.xqd[1], w2 = (1 << SGRPROJ_PRJ_BITS) - w0 - w1;
    for (int i = 0; i < win.h; i++)
      for (int j = 0; j < win.w; j++) {
        int uu = win.at(i, j) << SGRPROJ_RST_BITS;
        int v = w1 * uu;
        v += w0 * (r0 ? flt0[(size_t)i * win.w + j] : uu);
        v += w2 * (r1 ? flt1[(size_t)i * win.w + j] : uu);
        int s = round2(v, SGRPROJ_RST_BITS + SGRPROJ_PRJ_BITS);
        out[(size_t)(win.y0 + i) * stride + win.x0 + j] = (Pixel)clip1(s);
      }
  }

  // --------------------------------------------------------- film grain
  // 7.18.3: the film grain synthesis process, on the output planes after
  // loop restoration (GrainMin -128 << (BitDepth - 8), GrainMax 127 at 8
  // bits, 511 at 10, 2047 at 12). dav1d applies the same noise in 32x32
  // blocks; the stripes here are the spec's.
  int RandomRegister = 0;
  int get_random_number(int bits) {  // 7.18.3.2
    int r = RandomRegister;
    int bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
    r = (r >> 1) | (bit << 15);
    RandomRegister = r;
    return (r >> (16 - bits)) & ((1 << bits) - 1);
  }

  void film_grain() {
    if (!fg.apply_grain) return;
    const int subX = seq.ss_x, subY = seq.ss_y, w = FrameWidth, h = FrameHeight;
    const int bd = BitDepth - 8, GrainCenter = 128 << bd, GrainMin = -GrainCenter;
    const int GrainMax = (256 << bd) - 1 - GrainCenter;
    // 7.18.3.3: the grain templates, luma 73x82, chroma by the subsampling
    static thread_local int16_t Grain[3][73][82];
    int shift = 12 - BitDepth + fg.grain_scale_shift;
    RandomRegister = fg.grain_seed;
    for (int y = 0; y < 73; y++)
      for (int x = 0; x < 82; x++)
        Grain[0][y][x] = fg.num_points[0] ? round2(Gaussian_Sequence[get_random_number(11)], shift) : 0;
    const int lag = fg.ar_coeff_lag, arShift = fg.ar_coeff_shift_minus_6 + 6;
    for (int y = 3; y < 73; y++)
      for (int x = 3; x < 82 - 3; x++) {
        int sum = 0, pos = 0;
        for (int dr = -lag; dr <= 0; dr++)
          for (int dc = -lag; dc <= lag; dc++) {
            if (dr == 0 && dc == 0) break;
            sum += Grain[0][y + dr][x + dc] * (fg.ar_coeffs[0][pos++] - 128);
          }
        Grain[0][y][x] = clip3(GrainMin, GrainMax, Grain[0][y][x] + round2(sum, arShift));
      }
    const int chromaW = subX ? 44 : 82, chromaH = subY ? 38 : 73;
    bool noisy[3] = {fg.num_points[0] > 0, false, false};
    for (int p = 1; p < NumPlanes; p++) {
      noisy[p] = fg.num_points[p] > 0 || fg.chroma_scaling_from_luma;
      RandomRegister = fg.grain_seed ^ (p == 1 ? 0xb524 : 0x49d8);
      for (int y = 0; y < chromaH; y++)
        for (int x = 0; x < chromaW; x++)
          Grain[p][y][x] = noisy[p] ? round2(Gaussian_Sequence[get_random_number(11)], shift) : 0;
    }
    if (NumPlanes > 1)
      for (int y = 3; y < chromaH; y++)
        for (int x = 3; x < chromaW - 3; x++) {
          int sum[3] = {0, 0, 0}, pos = 0;
          for (int dr = -lag; dr <= 0; dr++)
            for (int dc = -lag; dc <= lag; dc++) {
              if (dr == 0 && dc == 0) {
                if (fg.num_points[0] > 0) {
                  int luma = 0, lumaX = ((x - 3) << subX) + 3, lumaY = ((y - 3) << subY) + 3;
                  for (int i = 0; i <= subY; i++)
                    for (int j = 0; j <= subX; j++) luma += Grain[0][lumaY + i][lumaX + j];
                  luma = round2(luma, subX + subY);
                  for (int p = 1; p < 3; p++) sum[p] += luma * (fg.ar_coeffs[p][pos] - 128);
                }
                break;
              }
              for (int p = 1; p < 3; p++) sum[p] += (fg.ar_coeffs[p][pos] - 128) * Grain[p][y + dr][x + dc];
              pos++;
            }
          for (int p = 1; p < 3; p++)
            if (noisy[p]) Grain[p][y][x] = clip3(GrainMin, GrainMax, Grain[p][y][x] + round2(sum[p], arShift));
        }
    // 7.18.3.4: the scaling lookups (chroma scaled from luma takes luma's),
    // read through scale_lut, which interpolates between entries above 8 bits
    int ScalingLut[3][256];
    for (int p = 0; p < NumPlanes; p++) {
      int src = (p == 0 || fg.chroma_scaling_from_luma) ? 0 : p, n = fg.num_points[src];
      const int(*pt)[2] = fg.points[src];
      if (n == 0) {
        for (int i = 0; i < 256; i++) ScalingLut[p][i] = 0;
        continue;
      }
      for (int i = 0; i < pt[0][0]; i++) ScalingLut[p][i] = pt[0][1];
      for (int i = 0; i < n - 1; i++) {
        int deltaY = pt[i + 1][1] - pt[i][1], deltaX = pt[i + 1][0] - pt[i][0];
        int delta = deltaY * ((65536 + (deltaX >> 1)) / deltaX);
        for (int x = 0; x < deltaX; x++) ScalingLut[p][pt[i][0] + x] = pt[i][1] + ((x * delta + 32768) >> 16);
      }
      for (int i = pt[n - 1][0]; i < 256; i++) ScalingLut[p][i] = pt[n - 1][1];
    }
    // 7.18.3.5: noise stripes of 34 luma rows (32 and 2 of overlap), one
    // random offset per 32x32 block shared by the planes, blended at the
    // block edges where overlap_flag is set; then the noise image, blended
    // at the stripe edges
    int pwN[3], phN[3];
    for (int p = 0; p < NumPlanes; p++) {
      pwN[p] = p ? (w + subX) >> subX : w;
      phN[p] = p ? (h + subY) >> subY : h;
    }
    const int sw = w + 2 * 34;  // a stripe's columns: blocks may reach past the frame's right edge
    std::vector<int16_t> stripe[2][3], noise[3];
    for (int k = 0; k < 2; k++)
      for (int p = 0; p < NumPlanes; p++) stripe[k][p].assign((size_t)34 * sw, 0);
    for (int p = 0; p < NumPlanes; p++) noise[p].assign((size_t)pwN[p] * phN[p], 0);
    auto blend = [&](int old, int g, int w0, int w1) {
      return clip3(GrainMin, GrainMax, round2(old * w0 + g * w1, 5));
    };
    int lumaNum = 0;
    for (int y = 0; y < (h + 1) / 2; y += 16, lumaNum++) {
      std::vector<int16_t>* cur = stripe[lumaNum & 1];
      const std::vector<int16_t>* prev = stripe[(lumaNum + 1) & 1];
      RandomRegister = fg.grain_seed;
      RandomRegister ^= ((lumaNum * 37 + 178) & 255) << 8;
      RandomRegister ^= ((lumaNum * 173 + 105) & 255);
      for (int x = 0; x < (w + 1) / 2; x += 16) {
        int rand = get_random_number(8), offsetX = rand >> 4, offsetY = rand & 15;
        for (int p = 0; p < NumPlanes; p++) {
          int sx = p ? subX : 0, sy = p ? subY : 0;
          int ox = sx ? 6 + offsetX : 9 + offsetX * 2, oy = sy ? 6 + offsetY : 9 + offsetY * 2;
          for (int i = 0; i < (34 >> sy); i++)
            for (int j = 0; j < (34 >> sx); j++) {
              int g = Grain[p][oy + i][ox + j];
              int16_t& at = cur[p][(size_t)i * sw + (sx ? x : x * 2) + j];
              if (!sx && j < 2 && fg.overlap_flag && x > 0) g = blend(at, g, j == 0 ? 27 : 17, j == 0 ? 17 : 27);
              else if (sx && j == 0 && fg.overlap_flag && x > 0) g = blend(at, g, 23, 22);
              at = (int16_t)g;
            }
        }
      }
      for (int p = 0; p < NumPlanes; p++) {
        int sy = p ? subY : 0, rows = 32 >> sy;
        for (int i = 0; i < rows; i++) {
          int yy = (lumaNum << (5 - sy)) + i;
          if (yy >= phN[p]) break;
          for (int xx = 0; xx < pwN[p]; xx++) {
            int g = cur[p][(size_t)i * sw + xx];
            if (fg.overlap_flag && lumaNum > 0) {
              int old = prev[p][(size_t)(i + rows) * sw + xx];
              if (!sy && i < 2) g = blend(old, g, i == 0 ? 27 : 17, i == 0 ? 17 : 27);
              else if (sy && i < 1) g = blend(old, g, 23, 22);
            }
            noise[p][(size_t)yy * pwN[p] + xx] = (int16_t)g;
          }
        }
      }
    }
    auto scale_lut = [&](int p, int index) {
      int x = index >> bd, rem = index - (x << bd);
      if (bd == 0 || x == 255) return ScalingLut[p][x];
      int start = ScalingLut[p][x], end = ScalingLut[p][x + 1];
      return start + round2((end - start) * rem, bd);
    };
    // 7.18.3.5: the noise added to the planes, chroma first (it is scaled
    // by the luma before the luma's noise)
    int minValue = 0, maxLuma = PixelMax, maxChroma = PixelMax;
    if (fg.clip_to_restricted_range) {
      minValue = 16 << bd;
      maxLuma = 235 << bd;
      maxChroma = seq.mc == 0 ? maxLuma : 240 << bd;  // MC_IDENTITY
    }
    const int ScalingShift = fg.grain_scaling_minus_8 + 8;
    for (int p = 1; p < NumPlanes; p++) {
      if (!noisy[p]) continue;
      for (int y = 0; y < phN[p]; y++)
        for (int x = 0; x < pwN[p]; x++) {
          int lumaX = x << subX, lumaY = y << subY, lumaNextX = std::min(lumaX + 1, w - 1);
          int averageLuma = subX ? round2(P(0, lumaY, lumaX) + P(0, lumaY, lumaNextX), 1) : P(0, lumaY, lumaX);
          int orig = P(p, y, x), merged = averageLuma;
          if (!fg.chroma_scaling_from_luma) {
            int combined = averageLuma * (fg.luma_mult[p] - 128) + orig * (fg.mult[p] - 128);
            merged = clip1((combined >> 6) + (fg.offset[p] - 256) * (1 << bd));
          }
          int n = round2(scale_lut(p, merged) * noise[p][(size_t)y * pwN[p] + x], ScalingShift);
          P(p, y, x) = (Pixel)clip3(minValue, maxChroma, orig + n);
        }
    }
    if (fg.num_points[0] > 0)
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
          int orig = P(0, y, x);
          int n = round2(scale_lut(0, orig) * noise[0][(size_t)y * w + x], ScalingShift);
          P(0, y, x) = (Pixel)clip3(minValue, maxLuma, orig + n);
        }
  }

  // ------------------------------------------------------------ the OBUs
  void tile_group(const uint8_t* d, size_t sz) {
    BitReader b(d, sz);
    int NumTiles = TileCols * TileRows;
    int tg_start = 0, tg_end = NumTiles - 1;
    if (NumTiles > 1 && b.f(1)) {
      int bits = TileColsLog2 + TileRowsLog2;
      tg_start = b.f(bits);
      tg_end = b.f(bits);
    }
    b.byte_align();
    size_t at = b.pos / 8;
    for (int t = tg_start; t <= tg_end; t++) {
      int tileRow = t / TileCols, tileCol = t % TileCols;
      size_t tileSize;
      if (t == tg_end) {
        tileSize = sz - at;
      } else {
        if (at + TileSizeBytes > sz) fail("a tile size cut short");
        tileSize = 0;
        for (int i = 0; i < TileSizeBytes; i++) tileSize |= (size_t)d[at + i] << (8 * i);
        tileSize += 1;
        at += TileSizeBytes;
        if (at + tileSize > sz) fail("a tile longer than its tile group");
      }
      MiRowStart = MiRowStarts[tileRow];
      MiRowEnd = MiRowStarts[tileRow + 1];
      MiColStart = MiColStarts[tileCol];
      MiColEnd = MiColStarts[tileCol + 1];
      CurrentQIndex = base_q_idx;
      cdf = frame_cdf;
      sd.init(d + at, tileSize, disable_cdf_update != 0);
      decode_tile();
      at += tileSize;
    }
    if (tg_end == NumTiles - 1) frame_done = true;
  }

  void decode(const uint8_t* d, size_t n) {
    size_t at = 0;
    bool have_frame_header = false;
    while (at < n && !frame_done) {
      uint8_t h = d[at++];
      if (h & 0x80) fail("an OBU with its forbidden bit set");
      int type = (h >> 3) & 15, ext = (h >> 2) & 1, has_size = (h >> 1) & 1;
      int temporal_id = 0, spatial_id = 0;
      if (ext) {
        if (at >= n) fail("an OBU extension cut short");
        temporal_id = d[at] >> 5;
        spatial_id = (d[at] >> 3) & 3;
        at++;
      }
      size_t size = has_size ? (size_t)leb128(d, n, at) : n - at;
      if (size > n - at) fail("an OBU longer than its data");
      const uint8_t* body = d + at;
      if (type == 1) {
        BitReader b(body, size);
        sequence_header(b);
      } else if (type == 3 || type == 6) {
        if (have_frame_header && type == 3) fail("a second frame header");
        BitReader b(body, size);
        NumPlanes = seq.mono ? 1 : 3;
        frame_header(b, temporal_id, spatial_id);
        have_frame_header = true;
        alloc_frame();
        frame_cdf.init(base_q_idx);
        if (type == 6) {
          b.byte_align();
          size_t hb = b.pos / 8;
          tile_group(body + hb, size - hb);
        }
      } else if (type == 4) {
        if (!have_frame_header) fail("a tile group before its frame header");
        tile_group(body, size);
      } else if (type == 7 || type == 8) {
        // redundant frame headers and tile lists: not needed for one frame
      }
      at += size;
    }
    if (!frame_done) fail("no complete frame in the AV1 data");
  }
};


// ------------------------------------------------------------ YUV -> RGB
// libyuv's YuvConstants (yg, yb, ub, ug, vg, vr) as its C rows use them;
// its x86 rows give the same bytes (their 16-bit saturation only happens
// where the result clamps anyway).
struct YuvConst {
  int yg, yb, ub, ug, vg, vr;
};
const YuvConst kI601 = {18997, -1160, 128, 25, 52, 102}, kJPEG = {16320, 32, 113, 22, 46, 90};
const YuvConst kH709 = {18997, -1160, 128, 14, 34, 115}, kF709 = {16320, 32, 119, 12, 30, 101};
const YuvConst k2020 = {19003, -1160, 128, 12, 42, 107}, kV2020 = {16320, 32, 120, 11, 37, 94};

// libavif's choice of libyuv constants (reformat_libyuv.c), or nullptr
// where libavif uses its own conversion.
const YuvConst* libyuv_constants(int full, int mc, int cp) {
  if (mc == 12) {  // chroma-derived NCL: by the colour primaries
    if (cp == 1 || cp == 2) mc = 1;
    else if (cp == 5 || cp == 6) mc = 6;
    else if (cp == 9) mc = 9;
    else return nullptr;
  }
  switch (mc) {
    case 1: return full ? &kF709 : &kH709;
    case 2: case 5: case 6: return full ? &kJPEG : &kI601;
    case 9: return full ? &kV2020 : &k2020;
    default: return nullptr;
  }
}

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// y16: Y widened to 16 bits as libyuv's rows widen it (y * 0x0101 from 8
// bits, (y << 6) | (y >> 4) from 10, (y << 4) | (y >> 8) from 12); u, v:
// chroma at 8 bits
inline void yuv_pixel(int y16, int u, int v, const YuvConst& k, uint8_t* rgb) {
  int y1 = (int)(((uint32_t)y16 * (uint32_t)k.yg) >> 16) + k.yb;
  int ui = u - 128, vi = v - 128;
  rgb[0] = clamp255((y1 + vi * k.vr) >> 6);
  rgb[1] = clamp255((y1 - (ui * k.ug + vi * k.vg)) >> 6);
  rgb[2] = clamp255((y1 + ui * k.ub) >> 6);
}

inline int widen_y(int y, int depth) {
  return depth == 8 ? y * 0x0101 : (y << (16 - depth)) | (y >> (2 * depth - 16));
}

// libyuv's ScaleRowUp2_Linear_Any (and its _16 form): a half-width row to
// dst_width samples.
template <typename T>
void up2_linear(const T* s, T* d, int dst_width) {
  int work = (dst_width - 1) & ~1;
  d[0] = s[0];
  for (int x = 0; x < work / 2; x++) {
    d[1 + 2 * x] = (T)((s[x] * 3 + s[x + 1] + 2) >> 2);
    d[2 + 2 * x] = (T)((s[x] + s[x + 1] * 3 + 2) >> 2);
  }
  d[dst_width - 1] = s[(dst_width - 1) / 2];
}

// libyuv's ScaleRowUp2_Bilinear_Any (and its _16 form): rows sa (near) and
// sb to two rows.
template <typename T>
void up2_bilinear(const T* sa, const T* sb, T* da, T* db, int dst_width) {
  int work = (dst_width - 1) & ~1;
  da[0] = (T)((3 * sa[0] + sb[0] + 2) >> 2);
  db[0] = (T)((sa[0] + 3 * sb[0] + 2) >> 2);
  for (int x = 0; x < work / 2; x++) {
    const T *s = sa + x, *t = sb + x;
    da[1 + 2 * x] = (T)((s[0] * 9 + s[1] * 3 + t[0] * 3 + t[1] + 8) >> 4);
    da[2 + 2 * x] = (T)((s[0] * 3 + s[1] * 9 + t[0] + t[1] * 3 + 8) >> 4);
    db[1 + 2 * x] = (T)((s[0] * 3 + s[1] + t[0] * 9 + t[1] * 3 + 8) >> 4);
    db[2 + 2 * x] = (T)((s[0] + s[1] * 3 + t[0] * 3 + t[1] * 9 + 8) >> 4);
  }
  int l = (dst_width - 1) / 2;
  da[dst_width - 1] = (T)((3 * sa[l] + sb[l] + 2) >> 2);
  db[dst_width - 1] = (T)((sa[l] + 3 * sb[l] + 2) >> 2);
}

// libyuv's YUV -> ARGB rows over planes of `depth`-bit samples (chroma
// strides (w + ss_x) >> ss_x) into out (ch bytes a pixel): the chroma
// upsampled at its own depth, bilinear at 4:2:0 (I420ToARGBMatrixBilinear:
// row 0 from chroma row 0, then pairs of rows between chroma rows k and k +
// 1, an even height's last row from the last chroma row) and linear at
// 4:2:2, or `nearest` (I012ToARGBMatrix), then brought to 8 bits by
// clamp255(c >> (depth - 8)).
template <typename T>
void libyuv_rows(const T* yp, const T* up, const T* vp, int w, int h, int depth, int ss_x, int ss_y, bool nearest,
                 int ch, const YuvConst& k, uint8_t* out) {
  int cw = (w + ss_x) >> ss_x, cs = depth - 8;
  std::vector<T> ru(w), rv(w), ru2(w), rv2(w);
  auto emit = [&](int j, const T* U, const T* V) {
    const T* Y = yp + (size_t)j * w;
    uint8_t* o = out + (size_t)j * w * ch;
    for (int i = 0; i < w; i++)
      yuv_pixel(widen_y(Y[i], depth), std::min(255, U[i] >> cs), std::min(255, V[i] >> cs), k, o + i * ch);
  };
  if (!ss_x && !ss_y) {
    for (int j = 0; j < h; j++) emit(j, up + (size_t)j * w, vp + (size_t)j * w);
  } else if (nearest) {
    for (int j = 0; j < h; j++) {
      const T *u0 = up + (size_t)(j >> ss_y) * cw, *v0 = vp + (size_t)(j >> ss_y) * cw;
      for (int i = 0; i < w; i++) {
        ru[i] = u0[i >> ss_x];
        rv[i] = v0[i >> ss_x];
      }
      emit(j, ru.data(), rv.data());
    }
  } else if (!ss_y) {
    for (int j = 0; j < h; j++) {
      up2_linear(up + (size_t)j * cw, ru.data(), w);
      up2_linear(vp + (size_t)j * cw, rv.data(), w);
      emit(j, ru.data(), rv.data());
    }
  } else {
    up2_linear(up, ru.data(), w);
    up2_linear(vp, rv.data(), w);
    emit(0, ru.data(), rv.data());
    int kk = 0, j = 1;
    for (int y = 0; y < h - 2; y += 2, kk++) {
      const T *u0 = up + (size_t)kk * cw, *v0 = vp + (size_t)kk * cw;
      up2_bilinear(u0, u0 + cw, ru.data(), ru2.data(), w);
      up2_bilinear(v0, v0 + cw, rv.data(), rv2.data(), w);
      emit(j++, ru.data(), rv.data());
      emit(j++, ru2.data(), rv2.data());
    }
    if (!(h & 1) && h > 1) {
      up2_linear(up + (size_t)kk * cw, ru.data(), w);
      up2_linear(vp + (size_t)kk * cw, rv.data(), w);
      emit(j, ru.data(), rv.data());
    }
  }
}

// libavif's Kr / Kb of a matrix (avifCalcYUVCoefficients), for its own
// float path; false where libavif has none this port follows.
bool kr_kb(int mc, float& kr, float& kb) {
  switch (mc) {
    case 1: kr = 0.2126f; kb = 0.0722f; return true;
    case 4: kr = 0.30f; kb = 0.11f; return true;
    case 2: case 5: case 6: kr = 0.299f; kb = 0.114f; return true;
    case 7: kr = 0.212f; kb = 0.087f; return true;
    case 9: kr = 0.2627f; kb = 0.0593f; return true;
    default: return false;
  }
}


// The stream's sequence header (the last one before its end), read alone.
SeqHeader read_sequence_header(const uint8_t* data, size_t n) {
  Decoder<uint8_t> dec;
  size_t at = 0;
  while (at < n) {
    uint8_t h = data[at++];
    int type = (h >> 3) & 15, ext = (h >> 2) & 1, has_size = (h >> 1) & 1;
    if (ext) at++;
    size_t sz = has_size ? (size_t)leb128(data, n, at) : n - at;
    if (sz > n - at) fail("an OBU longer than its data");
    if (type == 1) {
      BitReader b(data + at, sz);
      dec.sequence_header(b);
    }
    at += sz;
  }
  if (!dec.seq.seen) fail("no AV1 sequence header");
  return dec.seq;
}

// gs_av1_decode's decode of a frame of Pixel samples (see below).
template <typename Pixel>
int decode_frame(const uint8_t* data, size_t size, int* info, void* yv, void* uv, void* vv, double* times, int* tools,
                 char* msg, int msglen) {
  std::unique_ptr<Decoder<Pixel>> dec(new Decoder<Pixel>());
  auto t0 = std::chrono::steady_clock::now();
  dec->decode(data, size);
  auto t1 = std::chrono::steady_clock::now();
  dec->loop_filter();
  auto t2 = std::chrono::steady_clock::now();
  for (int p = 0; p < dec->NumPlanes; p++) dec->deblocked[p] = dec->plane[p];
  dec->cdef();
  auto t3 = std::chrono::steady_clock::now();
  dec->loop_restoration();
  auto t4 = std::chrono::steady_clock::now();
  dec->film_grain();
  auto t5 = std::chrono::steady_clock::now();
  const SeqHeader& s = dec->seq;
  int W = dec->FrameWidth, H = dec->FrameHeight;
  int vals[10] = {W, H, s.mono, s.ss_x, s.ss_y, s.bit_depth, s.cp, s.tc, s.mc, s.color_range};
  memcpy(info, vals, sizeof vals);
  if (W != info[10] || H != info[11]) {
    snprintf(msg, msglen, "an AV1 frame of %dx%d where the item's size is %dx%d", W, H, info[10], info[11]);
    return 1;
  }
  Pixel *y = (Pixel*)yv, *u = (Pixel*)uv, *v = (Pixel*)vv;
  for (int r = 0; r < H; r++) memcpy(y + (size_t)r * W, &dec->P(0, r, 0), W * sizeof(Pixel));
  if (!s.mono) {
    int cw = (W + s.ss_x) >> s.ss_x, ch = (H + s.ss_y) >> s.ss_y;
    for (int r = 0; r < ch; r++) {
      memcpy(u + (size_t)r * cw, &dec->P(1, r, 0), cw * sizeof(Pixel));
      memcpy(v + (size_t)r * cw, &dec->P(2, r, 0), cw * sizeof(Pixel));
    }
  }
  if (times) {
    times[0] = std::chrono::duration<double>(t1 - t0).count();
    times[1] = std::chrono::duration<double>(t2 - t1).count();
    times[2] = std::chrono::duration<double>(t3 - t2).count();
    times[3] = std::chrono::duration<double>(t4 - t3).count();
    times[4] = std::chrono::duration<double>(t5 - t4).count();
  }
  if (tools) {
    int* k = dec->tools;
    k[0] = s.use_128;
    k[2] = dec->UsesLr ? dec->lr_unit_shift : -1;
    k[3] = dec->lr_uv_shift;
    for (int p = 0; p < 3; p++) k[4 + p] = dec->FrameRestorationType[p];
    const auto& g = dec->fg;
    int grain[9] = {g.apply_grain, g.ar_coeff_lag, g.num_points[0], g.num_points[1], g.num_points[2],
                    g.chroma_scaling_from_luma, g.overlap_flag, g.clip_to_restricted_range, g.grain_scale_shift};
    memcpy(k + 63, grain, sizeof grain);
    memcpy(tools, k, sizeof dec->tools);
  }
  return 0;
}

// The alpha channel (8-bit) into RGBA (a nullptr: RGB out, nothing to do),
// the colour un-premultiplied where it is premultiplied, as libavif does:
// libyuv's ARGBUnattenuateRow (x86), (f * 257 * ia) >> 16 through pmulhuw,
// packed with signed saturation.
int unpremultiply(const uint8_t* a, int w, int h, int premultiplied, uint8_t* out) {
  if (!a) return 0;
  for (size_t i = 0, n = (size_t)w * h; i < n; i++) {
    uint8_t al = a[i];
    uint8_t* o = out + i * 4;
    o[3] = al;
    if (!premultiplied || al == 255) continue;
    uint32_t ia = al == 0 ? 0 : (al == 1 ? 0xffff : 0x10000 / al);
    for (int c = 0; c < 3; c++) {
      uint32_t t = ((uint32_t)o[c] * 257u * ia) >> 16;
      o[c] = t > 32767 ? 0 : (uint8_t)(t > 255 ? 255 : t);
    }
  }
  return 0;
}

// libavif's own float path (unorm tables of the samples' depth, then 0.5 +
// clamped * 255), for identity, 4:0:0 to RGB and the matrices libyuv has no
// constants for, at 4:4:4. `unmultiply`: libavif's slow path, which
// un-premultiplies each pixel in float by its alpha (a, of `depth` bits)
// before the 8-bit store.
template <typename T>
void float_path(const T* yp, const T* up, const T* vp, const T* a, int w, int h, int depth, int mono,
                       bool identity, float kr, float kb, int full, bool unmultiply, int ch, uint8_t* out) {
  const int n = 1 << depth, s = depth - 8, mx = n - 1;
  float kg = 1.0f - kr - kb;
  std::vector<float> tY(n), tUV(n);
  for (int i = 0; i < n; i++) {
    tY[i] = full ? (float)i / (float)mx : (float)(i - (16 << s)) / (float)(219 << s);
    tUV[i] = identity ? tY[i] : (full ? (float)(i - (n >> 1)) / (float)mx : (float)(i - (n >> 1)) / (float)(224 << s));
  }
  auto u8 = [](float v) { return (uint8_t)(0.5f + v * 255.0f); };
  auto c01 = [](float v) { return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v); };
  for (int j = 0; j < h; j++) {
    uint8_t* o = out + (size_t)j * w * ch;
    for (int i = 0; i < w; i++) {
      float Y = tY[yp[(size_t)j * w + i]], R = Y, G = Y, B = Y;
      if (!mono) {
        float Cb = tUV[up[(size_t)j * w + i]], Cr = tUV[vp[(size_t)j * w + i]];
        if (identity) {
          R = Cr;
          G = Y;
          B = Cb;
        } else {
          R = Y + (2 * (1 - kr)) * Cr;
          B = Y + (2 * (1 - kb)) * Cb;
          G = Y - ((2 * ((kr * (1 - kr) * Cr) + (kb * (1 - kb) * Cb))) / kg);
        }
      }
      float rgb[3] = {c01(R), c01(G), c01(B)};
      if (unmultiply) {
        float A = c01((float)a[(size_t)j * w + i] / (float)mx);
        for (float& c : rgb) c = A == 0.0f ? 0.0f : (A < 1.0f ? std::min(c / A, 1.0f) : c);
      }
      for (int c = 0; c < 3; c++) o[i * ch + c] = u8(rgb[c]);
    }
  }
}

// libyuv's Convert16To8Plane at libavif's scale: clamp255(v >> (depth - 8)).
std::vector<uint8_t> downshift(const uint16_t* p, size_t n, int depth) {
  std::vector<uint8_t> out(n);
  for (size_t i = 0; i < n; i++) out[i] = (uint8_t)std::min(255, p[i] >> (depth - 8));
  return out;
}

}  // namespace

extern "C" {

// Decode one AV1 image item. info (out, 16 ints): width, height, mono,
// ss_x, ss_y, bit depth, colour primaries, transfer, matrix, full range;
// (in) at 10-12 the width, height and bit depth the caller expects. With
// y == nullptr only the headers are read. The planes are written with
// strides width and (width + ss_x) >> ss_x, of uint8_t samples at 8 bits
// and uint16_t above. times (out, 5 doubles):
// seconds in symbol decoding with reconstruction, in the deblocking filter,
// in CDEF, in loop restoration and in film grain synthesis. tools (out, 72
// ints, or nullptr), which
// tools the frame used: use_128x128_superblock; cdef_bits (-1: no CDEF);
// lr_unit_shift (-1: no loop restoration); lr_uv_shift; each plane's
// FrameRestorationType (RESTORE_NONE, WIENER, SGRPROJ, SWITCHABLE); at 7 + 3
// * plane + k the 8x8 blocks CDEF filtered with a primary strength only (k
// 0), a secondary only (1), both (2); at 16 + 3 * plane + k the restoration
// units of Wiener (k 0), of self-guided with both radii (1), with one (2);
// at 32 + n - 2 and 39 + n - 2 the Y and UV palette blocks of n colours; at
// 46 and 47 the Y and U colours taken from the palette cache, at 48 and 49
// those delta-coded; at 50 and 51 the UV palettes whose V colours are
// delta-coded and raw; at 52 and 53 the IntraBC blocks whose DV prediction
// came from the stack and from the default DV; at 54 + d the var-tx
// transform blocks at depth d; at 57 + s the inter transform blocks of tx
// set s (0: none read); at 61 the IntraBC chroma predictions at a
// fractional position, at 62 those of blocks below 8x8 at subsampling; at
// 63-71 the film grain: apply_grain, ar_coeff_lag, num_y_points,
// num_cb_points, num_cr_points, chroma_scaling_from_luma, overlap_flag,
// clip_to_restricted_range, grain_scale_shift.
// Returns 0, or 1 with a message in msg.
int gs_av1_decode(const uint8_t* data, long long size, int* info, void* y, void* u, void* v, double* times,
                  int* tools, char* msg, int msglen) {
  try {
    SeqHeader s = read_sequence_header(data, (size_t)size);
    if (y == nullptr) {
      int vals[10] = {s.max_w, s.max_h, s.mono, s.ss_x, s.ss_y, s.bit_depth, s.cp, s.tc, s.mc, s.color_range};
      memcpy(info, vals, sizeof vals);
      return 0;
    }
    if (s.bit_depth != info[12]) fail("an AV1 stream of " + std::to_string(s.bit_depth) + "-bit samples where " +
                                      std::to_string(info[12]) + " were expected");
    if (s.bit_depth == 8) return decode_frame<uint8_t>(data, (size_t)size, info, y, u, v, times, tools, msg, msglen);
    return decode_frame<uint16_t>(data, (size_t)size, info, y, u, v, times, tools, msg, msglen);
  } catch (const Refused& r) {
    snprintf(msg, msglen, "%s", r.what.c_str());
    return 1;
  } catch (const std::exception& e) {
    snprintf(msg, msglen, "the AV1 decoder failed (%s)", e.what());
    return 1;
  }
}


// YUV planes of `depth` bits (uint8_t samples at 8, uint16_t above; chroma
// strides (w + ss_x) >> ss_x) to interleaved 8-bit RGB or RGBA as libavif
// 1.3.0 converts for PIL's 8-bit avifRGBImage. a: the alpha plane or
// nullptr (RGB out); premultiplied: un-premultiply as libavif does. Above 8
// bits libavif (probed through avifImageYUVToRGB) picks:
// - libyuv's matrices, RGB out: every plane downshifted to 8 bits, then the
//   8-bit rows;
// - libyuv's matrices, RGBA out: at 10 bits the 10-bit rows with alpha
//   (I010 / I210 / I410AlphaToARGBMatrixFilter: chroma upsampled at 10
//   bits, alpha >> 2); at 12 bits and 4:2:0 I012ToARGBMatrix (nearest
//   chroma), alpha by libavif's float rounding; at 12 bits and 4:2:2 or
//   4:4:4 every plane (alpha too) downshifted, then the 8-bit rows;
// - 4:0:0 to RGBA by libyuv's I400 rows: Y downshifted, alpha by libavif's
//   float rounding (0.5 + a / (2^depth - 1) * 255);
// - the float path at the samples' depth, alpha by the float rounding.
// The colour is un-premultiplied after the conversion (libyuv's rows),
// except in libavif's slow path (identity, but for 8-bit full range, and
// YCgCo), which un-premultiplies in float. Returns 0, or 1 with a message where the port
// does not follow libavif's conversion.
int gs_yuv_to_rgb(const void* yv, const void* uv, const void* vv, const void* av, int w, int h, int depth, int mono,
                  int ss_x, int ss_y, int mc, int cp, int full, int premultiplied, uint8_t* out, char* msg,
                  int msglen) {
  int ch = av ? 4 : 3;
  // where libavif's conversion fails (PIL: "Reformat failed"): the
  // matrices it has no conversion for, and identity with subsampled chroma
  if (mc == 3 || mc == 10 || mc == 11 || mc == 13 || mc == 14 || mc > 15 || (mc == 8 && !full) ||
      (mc == 0 && !mono && (ss_x || ss_y))) {
    snprintf(msg, msglen, "an AVIF colour matrix (matrix_coefficients %d%s) libavif cannot convert (PIL: Reformat "
             "failed)", mc, full ? "" : ", limited range");
    return 1;
  }
  const YuvConst* k = libyuv_constants(full, mc, cp);
  const YuvConst* km = mono && av ? libyuv_constants(full, mc == 0 ? 6 : mc, cp) : nullptr;
  bool identity = mc == 0 && !mono;
  float kr = 0, kb = 0;
  bool floating = !(km || (!mono && !identity && k));
  if (floating && !mono && !identity && !kr_kb(mc, kr, kb)) {
    snprintf(msg, msglen, "an AVIF colour matrix (matrix_coefficients %d) libavif converts by a path the port does not follow", mc);
    return 1;
  }
  if (floating && !mono && !identity && (ss_x || ss_y)) {
    snprintf(msg, msglen, "chroma subsampling with a colour matrix (matrix_coefficients %d) libyuv does not cover", mc);
    return 1;
  }
  size_t n = (size_t)w * h, cn = mono ? 0 : (size_t)((w + ss_x) >> ss_x) * ((h + ss_y) >> ss_y);
  // libavif's slow path: the float path of the identity and YCgCo modes (4:0:0 by its matrix too), but for
  // its 8-bit full-range identity rows
  bool slow_unmultiply = floating && (mc == 0 || mc == 8) && premultiplied && av && !(depth == 8 && full && identity);
  if (depth == 8) {
    const uint8_t *yp = (const uint8_t*)yv, *up = (const uint8_t*)uv, *vp = (const uint8_t*)vv;
    const uint8_t* a = (const uint8_t*)av;
    if (km) {
      // libavif converts 4:0:0 to RGBA by libyuv's I400ToARGBMatrix where
      // libyuv has constants (identity takes BT.601's)
      for (size_t i = 0; i < n; i++) yuv_pixel(widen_y(yp[i], 8), 128, 128, *km, out + i * 4);
    } else if (!floating) {
      libyuv_rows(yp, up, vp, w, h, 8, ss_x, ss_y, false, ch, *k, out);
    } else {
      float_path(yp, up, vp, a, w, h, 8, mono, identity, kr, kb, full, slow_unmultiply, ch, out);
    }
    return unpremultiply(a, w, h, premultiplied && !slow_unmultiply, out);
  }
  const uint16_t *yp = (const uint16_t*)yv, *up = (const uint16_t*)uv, *vp = (const uint16_t*)vv;
  const uint16_t* a = (const uint16_t*)av;
  std::vector<uint8_t> a8;
  if (a) {
    // libavif's avifReformatAlpha, where libyuv's rows do not carry it
    a8.resize(n);
    float mx = (float)((1 << depth) - 1);
    for (size_t i = 0; i < n; i++) a8[i] = (uint8_t)std::min(255, (int)(0.5f + ((float)a[i] / mx) * 255.0f));
  }
  if (km) {
    std::vector<uint8_t> y8 = downshift(yp, n, depth);
    for (size_t i = 0; i < n; i++) yuv_pixel(widen_y(y8[i], 8), 128, 128, *km, out + i * 4);
  } else if (!floating && (!a || (depth == 12 && !(ss_x && ss_y)))) {
    std::vector<uint8_t> y8 = downshift(yp, n, depth), u8 = downshift(up, cn, depth), v8 = downshift(vp, cn, depth);
    libyuv_rows(y8.data(), u8.data(), v8.data(), w, h, 8, ss_x, ss_y, false, ch, *k, out);
    if (a) a8 = downshift(a, n, depth);
  } else if (!floating) {
    libyuv_rows(yp, up, vp, w, h, depth, ss_x, ss_y, depth == 12, ch, *k, out);
    if (depth == 10) a8 = downshift(a, n, depth);
  } else {
    float_path(yp, up, vp, a, w, h, depth, mono, identity, kr, kb, full, slow_unmultiply, ch, out);
  }
  return unpremultiply(a ? a8.data() : nullptr, w, h, premultiplied && !slow_unmultiply, out);
}

}  // extern "C"
