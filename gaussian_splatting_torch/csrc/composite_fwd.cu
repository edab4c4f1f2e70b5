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
// done and are not written, so any image size works. The image may be a
// strip of a larger frame (the multi-device step, parallel/sharding.py):
// its first row is global pixel row origin_y, so a pixel's y coordinate is
// origin_y + its row in the strip, while the output rows and the y >= height
// test are the strip's own. origin_y = 0 is a whole frame.
//
// What bounds it on an H100: not bytes. Against ~40 B read per entry (id
// + 9 fields) and 16 B written per pixel, each evaluated pair runs a few
// dozen instructions (the quadratic form, an accurate expf, the alpha,
// stop and blend tests, 3 FMAs, the vote) and one MUFU. The card issues
// per warp, so a unit of 32 pixels costs all of it when any one of its
// pixels is open (not done, inside the entry's box). Everything else
// (staging, box tests, votes, barriers) takes 0.069 of its 0.378 ms (the
// pair work taken out); the rest is about 74 issue slots per open unit at
// the published boost clock, about twice its instructions: it waits on
// each unit's chain of dependent operations, the exp among them, not on
// issue, and not on the block's barriers (warps that stage their own
// entries, with no barrier, were no faster).
//
// What the design does about it. One CTA of 256 threads per tile; each
// thread owns TILE_W*TILE_H/256 pixels and keeps their colour and
// transmittance in registers. (That is the compiled geometries, 32x32,
// 32x16 and 16x16. Any other tile of up to 4096 pixels runs the same code
// in a block sized to it, 32-pixel units of consecutive pixels, with
// slots past the tile done from the start: blend.cuh's block_shape.)
// The backward's layout (composite_bwd.cu),
// through the same blend.cuh helpers: warp w owns a band of whole rows
// (rows 4w..4w+3 at 32x32) cut into 32-pixel units (8 x 4 at 32x32,
// unit_pixel), which a splat's box misses, or whose pixels are all done,
// more often than 32-pixel rows. Entries are staged in shared memory 128
// at a time with their box (reach); one warp vote skips a unit with no
// open pixel, and the rest of the pixel loop is branch-free (selects). A
// done pixel carries px = NaN, so the box test is its only test before
// the vote and no flag is kept beside it, and the box test's dx is
// pair_alpha's own. The cull skips only pairs that pair_alpha would skip,
// and every pixel adds its entries in the same order with the same
// arithmetic, so the outputs are the bits of the earlier row-per-warp
// form. The block leaves once __syncthreads_count shows every pixel done.
// No atomics; every output element is written once.
//
// Timed against its alternatives at the render path's inputs (scratch
// copies of this file, not kept; NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// the earlier form (32-pixel rows, no cull) 0.574 ms; units, box cull and
// votes with done flags and 256 entries a batch 0.447; this form 0.378.
// Tried and lost: no box cull (units voted on done pixels only) 0.516; a
// band test per (entry, warp) before the units 0.463 (a branch around the
// unit loop); per-warp lists of the entries whose box meets the band
// 0.400; one vote per entry for all 4 units 0.400; warps staging their own
// 32 or 64 entries 0.391-0.392; 5 resident blocks asked of
// __launch_bounds__ (51 registers) 0.402; reach in float32 0.391; 256 or 64
// entries a batch, 2 to 4 blocks, two entries unrolled, w = 0 for pairs not
// blended: 0.376-0.386.
//
// gs_composite_fwd_unculled runs the same kernel with every entry's box
// infinite (no cull): a check, on no path, that the cull changes no bit.
//
// The TPU kernel's means (pixels on sublanes, MXU triangular-matmul prefix
// scans, bf16 operand splits, log-space transmittance, the visit grid) are
// not carried over: they exist for the TPU's vector and matrix units.

#include <cuda_runtime.h>

#include "blend.cuh"
#include "warp_sum.cuh"  // gs::kFullMask

namespace {

constexpr int kThreads = gs::kMaxThreads;  // threads per block at a compiled geometry
constexpr int kBatch = 128;                // entries staged per round

// TILE_W, TILE_H > 0: a compiled geometry (256 threads, units of whole
// rows); 0: the geometry tile_w x tile_h of the arguments, in blocks of
// blockDim.x threads (blend.cuh's block_shape). kCull false stages an
// infinite box for every entry: the same blend with no cull.
template <int TILE_W, int TILE_H, int kPix, bool kCull>
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
                     int width, int height, int grid_x, int origin_y, int tile_w, int tile_h) {
  constexpr bool kCompiled = TILE_W > 0;
  static_assert(!kCompiled || TILE_W * TILE_H == kThreads * kPix,
                "tile must split evenly over the block");
  static_assert(kBatch <= kThreads, "one thread stages each entry of a batch");
  const int threads = kCompiled ? kThreads : blockDim.x;
  const int tw = kCompiled ? TILE_W : tile_w;
  const int th = kCompiled ? TILE_H : tile_h;

  __shared__ float2 s_mean[kBatch];
  __shared__ float4 s_conic_op[kBatch];  // a, b, c, opacity
  __shared__ float4 s_rgb[kBatch];       // r, g, b, unused
  __shared__ float2 s_reach[kBatch];     // reach of each entry

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tile = blockIdx.x;
  const int x0 = (tile % grid_x) * tw;
  const int y0 = (tile / grid_x) * th;
  const int start = tile_start[tile];
  const int stop = tile_stop[tile];

  // A pixel that is done (stopped, outside the image, or a slot past the
  // tile) has px = NaN: its box test then fails, so no flag needs to be
  // kept beside it.
  float px[kPix], py[kPix], T[kPix], C[kPix][3];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int2 q = gs::unit_pixel<TILE_W, kPix>(warp, k, lane, tw);
    const int x = x0 + q.x;
    const int y = y0 + q.y;
    px[k] = x >= width || y >= height || (!kCompiled && q.y >= th) ? NAN : static_cast<float>(x);
    py[k] = static_cast<float>(origin_y + y);
    T[k] = 1.0f;
    C[k][0] = C[k][1] = C[k][2] = 0.0f;
  }

  // Stages entry base + i of the tile's list into slot i of the batch.
  const auto stage = [&](int i, int base) {
    const int e = base + i;
    if (e >= stop) return;
    const int g = gauss_id[e];
    s_mean[i] = means2d[g];
    const float4 co = make_float4(conic[3 * g], conic[3 * g + 1], conic[3 * g + 2], opacity[g]);
    s_conic_op[i] = co;
    s_rgb[i] = make_float4(rgb[3 * g], rgb[3 * g + 1], rgb[3 * g + 2], 0.0f);
    s_reach[i] = kCull ? gs::reach(co.x, co.y, co.z, co.w) : make_float2(INFINITY, INFINITY);
  };

  for (int base = start; base < stop; base += kBatch) {
    bool all_done = true;
#pragma unroll
    for (int k = 0; k < kPix; ++k) all_done = all_done && isnan(px[k]);
    // Also the barrier that keeps the previous batch's shared memory alive
    // until every thread has finished reading it.
    if (__syncthreads_count(all_done) == threads) break;

    if constexpr (kCompiled) {
      if (threadIdx.x < kBatch) stage(threadIdx.x, base);
    } else {  // a block may have fewer threads than a batch has entries
      for (int i = threadIdx.x; i < kBatch; i += threads) stage(i, base);
    }
    __syncthreads();

    const int n = min(kBatch, stop - base);
    for (int j = 0; j < n; ++j) {
      const float2 mean = s_mean[j];
      const float4 co = s_conic_op[j];
      const float4 c = s_rgb[j];
      const float2 box = s_reach[j];
      // Branch-free but for one vote per unit: a unit with no open pixel
      // (stopped or outside the box) is skipped; in the others every lane
      // runs the pair and keeps what a blended pair adds.
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        // pair_alpha's own dx, dy: not open where px is NaN (done)
        const bool open = fabsf(__fsub_rn(mean.x, px[k])) <= box.x &&
                          fabsf(__fsub_rn(mean.y, py[k])) <= box.y;
        if (!__any_sync(gs::kFullMask, open)) continue;
        gs::Pair r;
        const bool taken =
            gs::pair_alpha(mean.x, mean.y, co.x, co.y, co.z, co.w, px[k], py[k], r) & open;
        const float test = gs::transmit(T[k], r.alpha);
        const bool stops = taken & (test < gs::kTEps);
        const bool blend = taken & !stops;
        px[k] = stops ? NAN : px[k];
        const float w = r.alpha * T[k];
        C[k][0] = blend ? C[k][0] + c.x * w : C[k][0];
        C[k][1] = blend ? C[k][1] + c.y * w : C[k][1];
        C[k][2] = blend ? C[k][2] + c.z * w : C[k][2];
        T[k] = blend ? test : T[k];
      }
    }
  }

  const float b0 = bg[0], b1 = bg[1], b2 = bg[2];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int2 q = gs::unit_pixel<TILE_W, kPix>(warp, k, lane, tw);
    const int x = x0 + q.x;
    const int y = y0 + q.y;
    if (x >= width || y >= height || (!kCompiled && q.y >= th)) continue;
    const long long pix = static_cast<long long>(y) * width + x;
    image[3 * pix + 0] = C[k][0] + T[k] * b0;
    image[3 * pix + 1] = C[k][1] + T[k] * b1;
    image[3 * pix + 2] = C[k][2] + T[k] * b2;
    final_t[pix] = T[k];
  }
}

struct Args {
  const void *gauss_id, *tile_start, *tile_stop, *means2d, *conic, *rgb, *opacity, *bg;
  void *image, *final_t;
  int width, height, tile_w, tile_h, origin_y;
};

template <bool kCull>
struct Launch {
  const Args& a;
  cudaStream_t stream;
  template <int TILE_W, int TILE_H, int kPix>
  cudaError_t run(int threads) const {
    const int grid_x = (a.width + a.tile_w - 1) / a.tile_w;
    const int grid_y = (a.height + a.tile_h - 1) / a.tile_h;
    composite_fwd_kernel<TILE_W, TILE_H, kPix, kCull><<<grid_x * grid_y, threads, 0, stream>>>(
        static_cast<const int*>(a.gauss_id), static_cast<const int*>(a.tile_start),
        static_cast<const int*>(a.tile_stop), static_cast<const float2*>(a.means2d),
        static_cast<const float*>(a.conic), static_cast<const float*>(a.rgb),
        static_cast<const float*>(a.opacity), static_cast<const float*>(a.bg),
        static_cast<float*>(a.image), static_cast<float*>(a.final_t), a.width, a.height, grid_x,
        a.origin_y, a.tile_w, a.tile_h);
    return cudaGetLastError();
  }
};

struct Occupancy {
  int* out;
  template <int TILE_W, int TILE_H, int kPix>
  cudaError_t run(int threads) const {
    return gs::occupancy(composite_fwd_kernel<TILE_W, TILE_H, kPix, true>, threads, out);
  }
};

template <bool kCull>
int launch_geometry(const Args& a, int device, void* stream) {
  if (a.width <= 0 || a.height <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return gs::dispatch(a.tile_w, a.tile_h, Launch<kCull>{a, static_cast<cudaStream_t>(stream)});
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) of device `device` and
// returns the cudaError_t of the launch (0 on success). Tile geometries:
// tile_w, tile_h >= 1 with tile_w * tile_h <= 4096 (blend.cuh); any other
// returns cudaErrorInvalidValue. All pointers are device pointers to
// contiguous arrays: gauss_id (K,) int32, tile_start/tile_stop (num_tiles,)
// int32, means2d (P,2), conic (P,3), rgb (P,3), opacity (P,), bg (3,)
// float32; image (H,W,3), final_t (H,W). origin_y: the global pixel row of
// the image's first row (0: a whole frame).
extern "C" int gs_composite_fwd(const void* gauss_id, const void* tile_start,
                                const void* tile_stop, const void* means2d,
                                const void* conic, const void* rgb, const void* opacity,
                                const void* bg, void* image, void* final_t, int width,
                                int height, int tile_w, int tile_h, int origin_y, int device,
                                void* stream) {
  return launch_geometry<true>({gauss_id, tile_start, tile_stop, means2d, conic, rgb, opacity,
                                bg, image, final_t, width, height, tile_w, tile_h, origin_y},
                               device, stream);
}

// The same with no box cull, arguments as gs_composite_fwd: its outputs
// must equal gs_composite_fwd's bit for bit.
extern "C" int gs_composite_fwd_unculled(const void* gauss_id, const void* tile_start,
                                         const void* tile_stop, const void* means2d,
                                         const void* conic, const void* rgb,
                                         const void* opacity, const void* bg, void* image,
                                         void* final_t, int width, int height, int tile_w,
                                         int tile_h, int origin_y, int device, void* stream) {
  return launch_geometry<false>({gauss_id, tile_start, tile_stop, means2d, conic, rgb, opacity,
                                 bg, image, final_t, width, height, tile_w, tile_h, origin_y},
                                device, stream);
}

// Fills out[0..2] with the kernel's registers per thread, threads per
// block and resident blocks per SM on device `device`, for a tile geometry
// as above; returns the cudaError_t.
extern "C" int gs_composite_fwd_occupancy(int tile_w, int tile_h, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return gs::dispatch(tile_w, tile_h, Occupancy{out});
}

extern "C" const char* gs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
