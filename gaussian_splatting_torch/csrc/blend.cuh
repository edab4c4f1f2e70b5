// The per-(pixel, entry) blend arithmetic, shared by the forward kernel
// (composite_fwd.cu) and the backward kernel (composite_bwd.cu), with the
// pieces of their layout that must agree: the entry's box (reach), the
// pixel a lane owns (unit_pixel) and the instantiation and block size each
// tile geometry runs (block_shape, dispatch).
//
// The backward replays the forward's decisions (skip, stop) from the same
// inputs, so both must compute them from bit-identical values. nvcc would
// otherwise choose for itself which multiplies and adds to contract into
// FMAs, which can differ between the two kernels. Here every operation is
// pinned: fmaf where a contraction saves an instruction, the
// round-to-nearest intrinsics (never contracted) elsewhere. Both kernels
// therefore round identically. The plain torch version
// (ops/composite.py::_pair) rounds the same FMAs once (through float64) on
// CUDA tensors, where it is the kernels' reference, so there it differs
// only where a float64 sum meets a float32 tie; on the CPU it rounds every
// operation on its own, and the CPU's exp differs from expf by an ulp.
// Either can flip a threshold decision on a pixel.

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

// Half-width and half-height, in pixels, of the box outside which an entry
// cannot be taken: where |px - mx| > reach.x or |py - my| > reach.y,
// pair_alpha skips the pixel, so leaving the pair out changes nothing.
// Taken needs op exp(-Q / 2) >= 1/255 with Q = a dx^2 + 2 b dx dy + c dy^2,
// so Q <= t = 2 ln(255 op), and the ellipse Q <= t spans |dx| <= sqrt(t c /
// det), |dy| <= sqrt(t a / det), det = a c - b^2. Widened for pair_alpha's
// float rounding: its Q is off by less than 8 u kappa relative (u = 2^-24,
// kappa <= (a + c)^2 / det bounds the conic's condition), here 16 u kappa +
// 1e-3, plus 1e-3 on t and 0.01 pixel. A conic that is not positive
// definite or not finite culls nothing (+inf); op below 1/255 culls every
// pixel (-1). The plain twin is ops/composite.py::reach_box.
__device__ __forceinline__ float2 reach(float a, float b, float c, float op) {
  const double da = a, dc = c;
  const double det = da * dc - static_cast<double>(b) * b;
  if (!(a > 0.0f) || !(det > 0.0) || !(det < INFINITY)) return make_float2(INFINITY, INFINITY);
  const double t = 2.0 * log(255.0 * static_cast<double>(op));
  if (!(t > -1e-3)) return make_float2(-1.0f, -1.0f);  // also a NaN opacity, never taken
  const double kappa = (da + dc) * (da + dc) / det;
  const double tq = fmax(t, 0.0) * (1.0 + 1e-3 + 16.0 * 5.9604645e-8 * kappa) + 1e-3;
  return make_float2(static_cast<float>(sqrt(tq * dc / det)) + 0.01f,
                     static_cast<float>(sqrt(tq * da / det)) + 0.01f);
}

// Tile geometries. 32x32, 32x16 and 16x16 have compile-time
// instantiations (TILE_W, TILE_H > 0): 256 threads, kPix = TILE_W TILE_H /
// 256 pixels each, units of whole rows (unit_pixel below). Every other
// tile_w x tile_h with tile_w, tile_h >= 1 and at most kMaxTilePixels
// pixels runs the same kernels instantiated for its kPix only (TILE_W =
// TILE_H = 0, the geometry an argument): kPix is the least of 1, 2, 4, 8,
// 16 with tile_w tile_h <= 256 kPix, and the block has tile_w tile_h / kPix
// threads rounded up to whole warps (at most 256; 64 at 8x8). Slots past
// the tile's pixels start done and are never written.
constexpr int kMaxThreads = 256;
constexpr int kMaxTilePixels = 16 * kMaxThreads;

struct BlockShape {
  int pix;      // pixels per thread (0: a geometry the kernels do not take)
  int threads;  // threads per block
};

__host__ __device__ inline BlockShape block_shape(int tile_w, int tile_h) {
  if (tile_w < 1 || tile_h < 1 || tile_w > kMaxTilePixels || tile_h > kMaxTilePixels ||
      tile_w * tile_h > kMaxTilePixels)
    return {0, 0};
  const int tpx = tile_w * tile_h;
  int pix = 1;
  while (tpx > kMaxThreads * pix) pix *= 2;
  return {pix, ((tpx + pix - 1) / pix + 31) / 32 * 32};
}

// The pixel (x, y inside the tile) of `lane` in unit k of `warp`, each
// thread with kPix pixels. Compiled geometries (TILE_W > 0, 256 threads):
// warp w owns the band of R = 32 / kUnitW rows from w R; its unit k is the
// kUnitW x R block at column k kUnitW (8 x 4 at 32x32, 16 x 2 at 32x16 and
// 16x16), so that a unit is compact: a splat's box misses it, or its pixels
// are all done, more often than a 32-pixel row's. Any other geometry
// (TILE_W = 0, tile_w the tile's width): unit k of warp w is the 32 pixels
// (w kPix + k) 32 .. + 31 of the tile in row-major order, so a warp owns 32
// kPix consecutive pixels; y >= tile_h marks a slot past the tile. The
// plain twin is ops/composite.py::unit_of_pixel.
template <int TILE_W, int kPix>
__device__ __forceinline__ int2 unit_pixel(int warp, int k, int lane, int tile_w) {
  if constexpr (TILE_W > 0) {
    constexpr int kUnitW = TILE_W / kPix;
    static_assert(TILE_W % kPix == 0 && 32 % kUnitW == 0, "a unit must be 32 pixels of whole rows");
    return make_int2(k * kUnitW + lane % kUnitW, warp * (32 / kUnitW) + lane / kUnitW);
  } else {
    const int p = (warp * kPix + k) * 32 + lane;
    return make_int2(p % tile_w, p / tile_w);
  }
}

// Calls fn.template run<TILE_W, TILE_H, kPix>(threads) for the kernel
// instantiation that takes tile_w x tile_h, and returns what it returns;
// cudaErrorInvalidValue for a geometry none takes. Both kernels dispatch
// through it, so they run the same layout at every geometry.
template <typename Fn>
cudaError_t dispatch(int tile_w, int tile_h, const Fn& fn) {
  if (tile_w == 32 && tile_h == 32) return fn.template run<32, 32, 4>(kMaxThreads);
  if (tile_w == 32 && tile_h == 16) return fn.template run<32, 16, 2>(kMaxThreads);
  if (tile_w == 16 && tile_h == 16) return fn.template run<16, 16, 1>(kMaxThreads);
  const BlockShape b = block_shape(tile_w, tile_h);
  switch (b.pix) {
    case 1: return fn.template run<0, 0, 1>(b.threads);
    case 2: return fn.template run<0, 0, 2>(b.threads);
    case 4: return fn.template run<0, 0, 4>(b.threads);
    case 8: return fn.template run<0, 0, 8>(b.threads);
    case 16: return fn.template run<0, 0, 16>(b.threads);
    default: return cudaErrorInvalidValue;
  }
}

// Fills out[0..2] with `kernel`'s registers per thread, the block size
// `threads` and its resident blocks per SM; returns the cudaError_t.
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
  out[0] = attr.numRegs;
  out[1] = threads;
  out[2] = blocks;
  return err;
}

}  // namespace gs
