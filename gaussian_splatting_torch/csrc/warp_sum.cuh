// Sums of 9 per-lane values over a warp, in a fixed order, shared by the
// compositing backward (composite_bwd.cu, the per-entry gradient rows) and
// the routing (route_grads.cu, the per-Gaussian sums of those rows).
//
// A transpose-reduce by recursive halving with __shfl_xor_sync: at each
// level a lane keeps half of its values and receives its partner's copy of
// that half, so 9 values take 5 + 3 + 2 + 1 + 1 = 12 shuffles (9 separate
// shfl_down trees take 45) and end spread over 9 fixed lanes
// (field_of_lane), which store them with one instruction. The order of the
// additions is fixed, so two runs give the same bits.

#pragma once

#include <cuda_runtime.h>

namespace gs {

constexpr int kFields = 9;
constexpr unsigned kFullMask = 0xffffffffu;

// One level of the transpose-reduce: of the pair (lo, hi) a lower lane
// keeps lo and an upper lane (lane & mask) keeps hi, each adding the
// partner's copy of the value it keeps.
__device__ __forceinline__ float fold(bool upper, float lo, float hi, int mask) {
  return (upper ? hi : lo) + __shfl_xor_sync(kFullMask, upper ? lo : hi, mask);
}

// Sums each of the 9 fields over the warp in 12 shuffles. Returns, in
// every lane, the warp's sum of field field_of_lane(lane); lanes for which
// that is -1 return a sum of padding. Every lane of the warp must call it.
__device__ __forceinline__ float warp_sum9(const float (&a)[kFields], int lane) {
  static_assert(kFields == 9, "the halving schedule is written for 9 fields");
  float v5[5], v3[3], v2[2];
#pragma unroll
  for (int i = 0; i < 5; ++i) v5[i] = fold(lane & 16, a[i], i + 5 < 9 ? a[i + 5] : 0.0f, 16);
#pragma unroll
  for (int i = 0; i < 3; ++i) v3[i] = fold(lane & 8, v5[i], i + 3 < 5 ? v5[i + 3] : 0.0f, 8);
#pragma unroll
  for (int i = 0; i < 2; ++i) v2[i] = fold(lane & 4, v3[i], i + 2 < 3 ? v3[i + 2] : 0.0f, 4);
  const float v = fold(lane & 2, v2[0], v2[1], 2);
  return v + __shfl_xor_sync(kFullMask, v, 1);
}

// The field whose warp sum warp_sum9 leaves in `lane`, or -1: the halving
// levels read backwards (sizes 9, 5, 3, 2 at masks 16, 8, 4, 2; an upper
// lane keeps the second half). Odd lanes repeat their even neighbour and
// are given -1, so exactly one lane owns each field.
__device__ __forceinline__ int field_of_lane(int lane) {
  if (lane & 1) return -1;
  const int sizes[4] = {9, 5, 3, 2};
  int pos = 0;
#pragma unroll
  for (int level = 3; level >= 0; --level) {
    if (lane & (16 >> level)) {
      pos += (sizes[level] + 1) / 2;
      if (pos >= sizes[level]) return -1;
    }
  }
  return pos;
}

}  // namespace gs
