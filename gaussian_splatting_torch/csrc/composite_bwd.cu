// The VJP of the front-to-back blend (backward of composite_fwd.cu).
//
// Replaces the TPU kernel gaussian_splatting_tpu/ops/composite_pallas.py::
// _bwd_kernel; the plain torch version is
// gaussian_splatting_torch/ops/composite.py::composite_bwd_torch.
//
// Inputs: the forward's sorted entries and per-Gaussian fields, its image
// (with background, (H, W, 3)) and final transmittance (H, W), and their
// cotangents g (H, W, 3) and g_ft (H, W). Output: one row of 9 gradients
// per entry, (K, 9) float32: d mean2d x, y; d conic a, b, c; d rgb r, g, b;
// d opacity. The row of sorted entry s goes to row entry_src[s], its
// emission index, so each Gaussian's rows end up contiguous for the
// routing kernel (route_grads.cu).
//
// Per pixel, entries in FORWARD order. The forward's skip and stop
// decisions are replayed with the forward's own arithmetic (blend.cuh), so
// the transmittance T_i before each entry is bit-identical to the
// forward's; the optional `replay_t` output holds the final T as a check.
// The suffix colour term is TOTAL - prefix:
//   TOTAL    = sum_c g_c image_c + g_ft T_final
//   prefix_i = sum_{j <= i} cg_j alpha_j T_j,      cg_i = sum_c g_c rgb_ic
//   dL/dalpha_i = T_i cg_i - (TOTAL - prefix_i) / (1 - alpha_i)
// `image` includes T_final * bg, so TOTAL carries the background's share.
// The alpha clamp's gradient is gated: none where op * G >= 0.99 (d rgb
// still flows). With dpower = dL/dalpha * op * G:
//   d op = dL/dalpha * G
//   d a = -0.5 dx^2 dpower, d b = -dx dy dpower, d c = -0.5 dy^2 dpower
//   d mx = -(a dx + b dy) dpower, d my = -(c dy + b dx) dpower
//   d rgb = g * alpha_i T_i
//
// What bounds it on an H100: as the forward, FP32 instruction throughput
// (about 13 operations and an exp per evaluated pair, some 40 more per
// blended pair) against 36 B written per entry and 32 B read per pixel;
// and here also the per-entry sums over the tile's pixels.
//
// What the design does about it. One CTA of 256 threads per tile; each
// thread owns TILE_W*TILE_H/256 pixels, laid out so that a warp covers a
// compact band of rows (at 32x32, warp w owns rows 4w..4w+3), and keeps
// their T, prefix, TOTAL and cotangent in registers. Entries are staged in
// shared memory 256 at a time, as in the forward. For each entry a thread
// sums its pixels' 9 terms; a warp then reduces them with shuffles, unless
// no lane of the warp blended the entry (a warp vote skips the shuffles,
// which is common for splats smaller than a tile). Per-warp partials go to
// shared memory and, every 32 entries, are summed in warp order and
// written out. Fixed reduction orders and no atomics: two runs give the
// same bits. Entries past the block's exit (every pixel done) get zero
// rows, so every row of every tile range is written exactly once.
//
// The TPU kernel's means (visits, MXU triangular-matmul prefix scans and
// moment matmuls, bf16 operand splits, log-space T) are not carried over.

#include <cuda_runtime.h>

#include "blend.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = kThreads;  // entries staged per round: one per thread
constexpr int kSub = 32;          // entries per flush of the per-warp partials
constexpr int kFields = 9;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // complete in lane 0
}

template <int TILE_W, int TILE_H>
__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const int* __restrict__ gauss_id,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_stop,
                     const int* __restrict__ entry_src,
                     const float2* __restrict__ means2d,
                     const float* __restrict__ conic,
                     const float* __restrict__ rgb,
                     const float* __restrict__ opacity,
                     const float* __restrict__ image,
                     const float* __restrict__ final_t,
                     const float* __restrict__ g_image,
                     const float* __restrict__ g_final_t,
                     float* __restrict__ rows,
                     float* __restrict__ replay_t,  // may be null
                     int width, int height, int grid_x) {
  static_assert((TILE_W * TILE_H) % kThreads == 0, "tile must split evenly over the block");
  constexpr int kPix = TILE_W * TILE_H / kThreads;  // pixels per thread

  __shared__ float2 s_mean[kBatch];
  __shared__ float4 s_conic_op[kBatch];  // a, b, c, opacity
  __shared__ float4 s_rgb[kBatch];       // r, g, b, unused
  __shared__ float s_part[kSub][kWarps][kFields];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tile = blockIdx.x;
  const int x0 = (tile % grid_x) * TILE_W;
  const int y0 = (tile / grid_x) * TILE_H;
  const int start = tile_start[tile];
  const int stop = tile_stop[tile];

  float px[kPix], py[kPix], T[kPix], pfx[kPix], total[kPix], g[kPix][3];
  bool done[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = (warp * kPix + k) * 32 + lane;  // row-major inside the tile
    const int x = x0 + p % TILE_W;
    const int y = y0 + p / TILE_W;
    px[k] = static_cast<float>(x);
    py[k] = static_cast<float>(y);
    T[k] = 1.0f;
    pfx[k] = 0.0f;
    done[k] = x >= width || y >= height;
    if (done[k]) {
      total[k] = g[k][0] = g[k][1] = g[k][2] = 0.0f;
    } else {
      const long long pix = static_cast<long long>(y) * width + x;
      g[k][0] = g_image[3 * pix + 0];
      g[k][1] = g_image[3 * pix + 1];
      g[k][2] = g_image[3 * pix + 2];
      total[k] = g[k][0] * image[3 * pix + 0] + g[k][1] * image[3 * pix + 1] +
                 g[k][2] * image[3 * pix + 2] + g_final_t[pix] * final_t[pix];
    }
  }

  int next = start;  // first entry of the tile not yet given a row
  for (int base = start; base < stop; base += kBatch) {
    bool all_done = true;
#pragma unroll
    for (int k = 0; k < kPix; ++k) all_done = all_done && done[k];
    // Also the barrier that keeps the previous batch's shared memory alive
    // until every thread has finished reading it.
    if (__syncthreads_count(all_done) == kThreads) break;

    const int e = base + threadIdx.x;
    if (e < stop) {
      const int gid = gauss_id[e];
      s_mean[threadIdx.x] = means2d[gid];
      s_conic_op[threadIdx.x] =
          make_float4(conic[3 * gid], conic[3 * gid + 1], conic[3 * gid + 2], opacity[gid]);
      s_rgb[threadIdx.x] = make_float4(rgb[3 * gid], rgb[3 * gid + 1], rgb[3 * gid + 2], 0.0f);
    }
    __syncthreads();

    const int n = min(kBatch, stop - base);
    for (int j0 = 0; j0 < n; j0 += kSub) {
      const int m = min(kSub, n - j0);
      for (int jj = 0; jj < m; ++jj) {
        const int j = j0 + jj;
        const float2 mean = s_mean[j];
        const float4 co = s_conic_op[j];
        const float4 c = s_rgb[j];
        float acc[kFields];
#pragma unroll
        for (int f = 0; f < kFields; ++f) acc[f] = 0.0f;
        bool any = false;
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          if (done[k]) continue;
          gs::Pair r;
          if (!gs::pair_alpha(mean.x, mean.y, co.x, co.y, co.z, co.w, px[k], py[k], r)) continue;
          const float test = gs::transmit(T[k], r.alpha);
          if (test < gs::kTEps) {
            done[k] = true;
            continue;
          }
          any = true;
          const float cg = g[k][0] * c.x + g[k][1] * c.y + g[k][2] * c.z;
          const float w = r.alpha * T[k];
          pfx[k] += cg * w;
          const float dalpha = T[k] * cg - (total[k] - pfx[k]) / (1.0f - r.alpha);
          if (r.raw < gs::kAlphaMax) {  // the gated clamp
            const float dpower = dalpha * r.raw;
            acc[0] += -(co.x * r.dx + co.y * r.dy) * dpower;
            acc[1] += -(co.z * r.dy + co.y * r.dx) * dpower;
            acc[2] += -0.5f * r.dx * r.dx * dpower;
            acc[3] += -r.dx * r.dy * dpower;
            acc[4] += -0.5f * r.dy * r.dy * dpower;
            acc[8] += dalpha * r.g;
          }
          acc[5] += g[k][0] * w;
          acc[6] += g[k][1] * w;
          acc[7] += g[k][2] * w;
          T[k] = test;
        }
        if (__any_sync(0xffffffffu, any)) {
#pragma unroll
          for (int f = 0; f < kFields; ++f) acc[f] = warp_sum(acc[f]);
        }
        if (lane == 0) {  // zeros where the warp blended nothing
#pragma unroll
          for (int f = 0; f < kFields; ++f) s_part[jj][warp][f] = acc[f];
        }
      }
      __syncthreads();
      // m * 9 sums over the warps, in warp order, one per thread
      for (int t = threadIdx.x; t < m * kFields; t += kThreads) {
        const int jj = t / kFields;
        const int f = t % kFields;
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += s_part[jj][w][f];
        rows[static_cast<long long>(entry_src[base + j0 + jj]) * kFields + f] = s;
      }
      __syncthreads();  // s_part is rewritten by the next kSub entries
    }
    next = base + n;
  }

  // Entries after the block's exit: every pixel was done, zero rows.
  for (int t = threadIdx.x; t < (stop - next) * kFields; t += kThreads) {
    rows[static_cast<long long>(entry_src[next + t / kFields]) * kFields + t % kFields] = 0.0f;
  }

  if (replay_t != nullptr) {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int p = (warp * kPix + k) * 32 + lane;
      const int x = x0 + p % TILE_W;
      const int y = y0 + p / TILE_W;
      if (x < width && y < height) replay_t[static_cast<long long>(y) * width + x] = T[k];
    }
  }
}

template <int TILE_W, int TILE_H>
cudaError_t launch(const void* const* in, void* rows, void* replay_t, int width, int height,
                   cudaStream_t stream) {
  const int grid_x = (width + TILE_W - 1) / TILE_W;
  const int grid_y = (height + TILE_H - 1) / TILE_H;
  composite_bwd_kernel<TILE_W, TILE_H><<<grid_x * grid_y, kThreads, 0, stream>>>(
      static_cast<const int*>(in[0]), static_cast<const int*>(in[1]),
      static_cast<const int*>(in[2]), static_cast<const int*>(in[3]),
      static_cast<const float2*>(in[4]), static_cast<const float*>(in[5]),
      static_cast<const float*>(in[6]), static_cast<const float*>(in[7]),
      static_cast<const float*>(in[8]), static_cast<const float*>(in[9]),
      static_cast<const float*>(in[10]), static_cast<const float*>(in[11]),
      static_cast<float*>(rows), static_cast<float*>(replay_t), width, height, grid_x);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) of device `device` and
// returns the cudaError_t of the launch (0 on success). Supported tile
// geometries: 32x32, 32x16, 16x16; any other returns cudaErrorInvalidValue.
// All pointers are device pointers to contiguous arrays: gauss_id,
// entry_src (K,) int32; tile_start/tile_stop (num_tiles,) int32; means2d
// (P,2), conic (P,3), rgb (P,3), opacity (P,) float32; image, g_image
// (H,W,3), final_t, g_final_t (H,W) float32; out rows (K,9) float32 and
// replay_t (H,W) float32 or null.
extern "C" int gs_composite_bwd(const void* gauss_id, const void* tile_start,
                                const void* tile_stop, const void* entry_src,
                                const void* means2d, const void* conic, const void* rgb,
                                const void* opacity, const void* image, const void* final_t,
                                const void* g_image, const void* g_final_t, void* rows,
                                void* replay_t, int width, int height, int tile_w, int tile_h,
                                int device, void* stream) {
  if (width <= 0 || height <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* in[12] = {gauss_id, tile_start, tile_stop, entry_src, means2d, conic,
                        rgb,      opacity,    image,     final_t,   g_image, g_final_t};
  const auto s = static_cast<cudaStream_t>(stream);
  if (tile_w == 32 && tile_h == 32) return launch<32, 32>(in, rows, replay_t, width, height, s);
  if (tile_w == 32 && tile_h == 16) return launch<32, 16>(in, rows, replay_t, width, height, s);
  if (tile_w == 16 && tile_h == 16) return launch<16, 16>(in, rows, replay_t, width, height, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* gs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
