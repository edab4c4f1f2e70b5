// Front-to-back alpha compositing of depth-sorted tile entries (forward).
//
// Replaces the TPU kernel gaussian_splatting_tpu/ops/composite_pallas.py::
// _fwd_kernel (with its helpers _visit_meta, _chunk_geometry, _blend_state)
// plus the background epilogue of render_tiles_pallas. It computes what the
// INRIA reference's forward.cu::renderCUDA computes; the plain torch version
// is gaussian_splatting_torch/ops/composite.py::composite_fwd_torch.
//
// Semantics, per pixel (global integer pixel coordinates), entries front
// to back (the per-pair arithmetic is blend.cuh's, shared with the
// backward kernel so that it replays these decisions exactly):
//   d = mean2d - pixel
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy       skip if power > 0
//   alpha = min(0.99, opacity * exp(power))         skip unless alpha >= 1/255
//   test  = T (1 - alpha)                           stop (sticky) if test < 1e-4,
//                                                   before compositing the entry
//   C += rgb * (alpha T); T = test
// Output image = C + T bg and final_t = T in (H, W, 3) / (H, W) layout. An
// empty tile gives bg and 1; pixels of edge tiles outside the image start
// done and are not written, so any image size works.
//
// What bounds it on an H100: per evaluated (pixel, entry) pair about a
// dozen FP32 operations and one exp (SFU), against ~40 B read per entry
// (id + 9 fields) and 16 B written per pixel. At 67 TFLOP/s and 3.35 TB/s
// an entry's bytes cost as much as ~60 pairs' operations, and each entry
// is evaluated by up to all 1024 pixels of its 32x32 tile, so the kernel
// is bound by FP32 instruction throughput and the SFU, not by bytes.
//
// What the design does about it. One CTA of 256 threads per tile; each
// thread owns TILE_W*TILE_H/256 pixels (4 at 32x32) and keeps their colour
// and transmittance in registers, so every entry staged in shared memory is
// loaded once per thread and reused for all of its pixels. Entries are
// gathered by sorted id (one per thread, 256 per batch) into shared memory;
// all threads then read the same entry (a broadcast, no bank conflicts).
// Each pixel stops on its own, and the block leaves the loop once
// __syncthreads_count shows every thread's pixels done, which is where a
// trained scene saves most of its work. No atomics; every output element
// is written once. Making it fast (fewer wasted lanes after divergence,
// cheaper exp, batch culling) is later work.
//
// The TPU kernel's means (pixels on sublanes, MXU triangular-matmul prefix
// scans, bf16 operand splits, log-space transmittance, the visit grid) are
// not carried over: they exist for the TPU's vector and matrix units.

#include <cuda_runtime.h>

#include "blend.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = kThreads;  // entries staged per round: one per thread

template <int TILE_W, int TILE_H>
__global__ void __launch_bounds__(kThreads)
composite_fwd_kernel(const int* __restrict__ gauss_id,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_stop,
                     const float2* __restrict__ means2d,
                     const float* __restrict__ conic,
                     const float* __restrict__ rgb,
                     const float* __restrict__ opacity,
                     const float* __restrict__ bg,
                     float* __restrict__ image,
                     float* __restrict__ final_t,
                     int width, int height, int grid_x) {
  static_assert((TILE_W * TILE_H) % kThreads == 0, "tile must split evenly over the block");
  constexpr int kPix = TILE_W * TILE_H / kThreads;  // pixels per thread

  __shared__ float2 s_mean[kBatch];
  __shared__ float4 s_conic_op[kBatch];  // a, b, c, opacity
  __shared__ float4 s_rgb[kBatch];       // r, g, b, unused

  const int tile = blockIdx.x;
  const int x0 = (tile % grid_x) * TILE_W;
  const int y0 = (tile / grid_x) * TILE_H;
  const int start = tile_start[tile];
  const int stop = tile_stop[tile];

  float px[kPix], py[kPix], T[kPix], C[kPix][3];
  bool done[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = threadIdx.x + k * kThreads;  // row-major inside the tile
    const int x = x0 + p % TILE_W;
    const int y = y0 + p / TILE_W;
    px[k] = static_cast<float>(x);
    py[k] = static_cast<float>(y);
    T[k] = 1.0f;
    C[k][0] = C[k][1] = C[k][2] = 0.0f;
    done[k] = x >= width || y >= height;
  }

  for (int base = start; base < stop; base += kBatch) {
    bool all_done = true;
#pragma unroll
    for (int k = 0; k < kPix; ++k) all_done = all_done && done[k];
    // Also the barrier that keeps the previous batch's shared memory alive
    // until every thread has finished reading it.
    if (__syncthreads_count(all_done) == kThreads) break;

    const int e = base + threadIdx.x;
    if (e < stop) {
      const int g = gauss_id[e];
      s_mean[threadIdx.x] = means2d[g];
      s_conic_op[threadIdx.x] =
          make_float4(conic[3 * g], conic[3 * g + 1], conic[3 * g + 2], opacity[g]);
      s_rgb[threadIdx.x] = make_float4(rgb[3 * g], rgb[3 * g + 1], rgb[3 * g + 2], 0.0f);
    }
    __syncthreads();

    const int n = min(kBatch, stop - base);
    for (int j = 0; j < n; ++j) {
      const float2 m = s_mean[j];
      const float4 co = s_conic_op[j];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (done[k]) continue;
        gs::Pair r;
        if (!gs::pair_alpha(m.x, m.y, co.x, co.y, co.z, co.w, px[k], py[k], r)) continue;
        const float test = gs::transmit(T[k], r.alpha);
        if (test < gs::kTEps) {
          done[k] = true;
          continue;
        }
        const float4 c = s_rgb[j];
        const float w = r.alpha * T[k];
        C[k][0] += c.x * w;
        C[k][1] += c.y * w;
        C[k][2] += c.z * w;
        T[k] = test;
      }
    }
  }

  const float b0 = bg[0], b1 = bg[1], b2 = bg[2];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = threadIdx.x + k * kThreads;
    const int x = x0 + p % TILE_W;
    const int y = y0 + p / TILE_W;
    if (x >= width || y >= height) continue;
    const long long pix = static_cast<long long>(y) * width + x;
    image[3 * pix + 0] = C[k][0] + T[k] * b0;
    image[3 * pix + 1] = C[k][1] + T[k] * b1;
    image[3 * pix + 2] = C[k][2] + T[k] * b2;
    final_t[pix] = T[k];
  }
}

template <int TILE_W, int TILE_H>
cudaError_t launch(const void* gauss_id, const void* tile_start, const void* tile_stop,
                   const void* means2d, const void* conic, const void* rgb,
                   const void* opacity, const void* bg, void* image, void* final_t,
                   int width, int height, cudaStream_t stream) {
  const int grid_x = (width + TILE_W - 1) / TILE_W;
  const int grid_y = (height + TILE_H - 1) / TILE_H;
  composite_fwd_kernel<TILE_W, TILE_H><<<grid_x * grid_y, kThreads, 0, stream>>>(
      static_cast<const int*>(gauss_id), static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_stop), static_cast<const float2*>(means2d),
      static_cast<const float*>(conic), static_cast<const float*>(rgb),
      static_cast<const float*>(opacity), static_cast<const float*>(bg),
      static_cast<float*>(image), static_cast<float*>(final_t), width, height, grid_x);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) of device `device` and
// returns the cudaError_t of the launch (0 on success). Supported tile
// geometries: 32x32, 32x16, 16x16; any other returns cudaErrorInvalidValue.
// All pointers are device pointers to contiguous arrays: gauss_id (K,) int32,
// tile_start/tile_stop (num_tiles,) int32, means2d (P,2), conic (P,3),
// rgb (P,3), opacity (P,), bg (3,) float32; image (H,W,3), final_t (H,W).
extern "C" int gs_composite_fwd(const void* gauss_id, const void* tile_start,
                                const void* tile_stop, const void* means2d,
                                const void* conic, const void* rgb, const void* opacity,
                                const void* bg, void* image, void* final_t, int width,
                                int height, int tile_w, int tile_h, int device,
                                void* stream) {
  if (width <= 0 || height <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  if (tile_w == 32 && tile_h == 32)
    return launch<32, 32>(gauss_id, tile_start, tile_stop, means2d, conic, rgb, opacity, bg,
                          image, final_t, width, height, s);
  if (tile_w == 32 && tile_h == 16)
    return launch<32, 16>(gauss_id, tile_start, tile_stop, means2d, conic, rgb, opacity, bg,
                          image, final_t, width, height, s);
  if (tile_w == 16 && tile_h == 16)
    return launch<16, 16>(gauss_id, tile_start, tile_stop, means2d, conic, rgb, opacity, bg,
                          image, final_t, width, height, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* gs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
