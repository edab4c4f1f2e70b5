// The per-(pixel, entry) blend arithmetic, shared by the forward kernel
// (composite_fwd.cu) and the backward kernel (composite_bwd.cu).
//
// The backward replays the forward's decisions (skip, stop) from the same
// inputs, so both must compute them from bit-identical values. nvcc would
// otherwise choose for itself which multiplies and adds to contract into
// FMAs, which can differ between the two kernels. Here every operation is
// pinned: fmaf where a contraction saves an instruction, the
// round-to-nearest intrinsics (never contracted) elsewhere. Both kernels
// therefore round identically. The plain torch version
// (ops/composite.py::_pair) rounds every operation on its own, so it can
// differ from the kernels by an FMA's rounding, and expf from the CPU's
// exp by an ulp; that flips a threshold decision on a few pixels.

#pragma once

#include <cuda_runtime.h>

namespace gs {

constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

struct Pair {
  float dx, dy;  // mean2d - pixel
  float g;       // exp(power)
  float raw;     // opacity * g, before the clamp
  float alpha;   // min(0.99, raw)
};

// Entry (mean m, conic a b c, opacity op) against pixel (px, py):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy     skip if power > 0
//   alpha = min(0.99, op exp(power))             skip unless alpha >= 1/255
// Returns whether the entry is taken (not skipped). It has no branch: the
// exp is computed even for a skipped entry, because an early return inside
// the caller's divergent per-pixel loop costs a reconvergence region per
// call, which made the forward kernel 10 % slower than this form.
__device__ __forceinline__ bool pair_alpha(float mx, float my, float a, float b, float c,
                                           float op, float px, float py, Pair& r) {
  r.dx = __fsub_rn(mx, px);
  r.dy = __fsub_rn(my, py);
  const float quad = fmaf(__fmul_rn(a, r.dx), r.dx, __fmul_rn(__fmul_rn(c, r.dy), r.dy));
  const float power = fmaf(-0.5f, quad, -__fmul_rn(__fmul_rn(b, r.dx), r.dy));
  r.g = expf(power);
  r.raw = __fmul_rn(op, r.g);
  r.alpha = r.raw > kAlphaMax ? kAlphaMax : r.raw;  // keeps a NaN, as torch.clamp_max
  return !(power > 0.0f) & (r.alpha >= kAlphaMin);  // so a NaN alpha is skipped
}

// The transmittance after blending a taken entry, T (1 - alpha); the pixel
// stops, before blending the entry, if it is below kTEps.
__device__ __forceinline__ float transmit(float T, float alpha) { return fmaf(-T, alpha, T); }

}  // namespace gs
