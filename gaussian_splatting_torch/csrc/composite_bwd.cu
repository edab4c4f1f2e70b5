// The VJP of the front-to-back blend (backward of composite_fwd.cu).
//
// Replaces the TPU kernel gaussian_splatting_tpu/ops/composite_pallas.py::
// _bwd_kernel; the plain torch version is
// gaussian_splatting_torch/ops/composite.py::composite_bwd_torch.
//
// Inputs: the forward's sorted entries and per-Gaussian fields, its image
// (with background, (H, W, 3)) and final transmittance (H, W), and their
// cotangents g (H, W, 3) and g_ft (H, W); origin_y, the global pixel row of
// the image's first row, as in the forward (a strip of the multi-device
// step; 0 for a whole frame). Output: one row of 9 gradients
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
// Layout. One CTA of 256 threads per tile; each thread owns
// TILE_W*TILE_H/256 pixels and keeps their T, prefix, TOTAL and cotangent
// in registers. Warp w owns a band of whole rows (rows 4w..4w+3 at 32x32),
// cut into 32-pixel units (8 x 4 blocks at 32x32, blend.cuh's unit_pixel,
// as in the forward). Entries are staged in shared memory 128 at a time
// with their fields and a box (blend.cuh's reach). Every row of every tile
// range is written exactly once; entries past the block's exit (every
// pixel done) get zero rows. Fixed reduction orders and no atomics: two
// runs give the same bits. Those are the compiled geometries (32x32,
// 32x16, 16x16); any other tile of up to 4096 pixels runs the same code in
// a block sized to it (blend.cuh's block_shape: 64 threads at 8x8), with
// units of 32 consecutive pixels, slots past the tile done from the start,
// and the flush summing the warps the block has. Every warp is whole, so
// the warp votes and sums see 32 lanes.
//
// What bounds it on an H100. The pair work is the forward's (about 13
// operations and an exp per pair that can be taken, a box test for the
// others, two thirds of those evaluated on the trained model) plus some
// 47 per blended pair, against 36 B written per entry and 32 B read per
// pixel: FP32 issue, not bytes. But the card issues per warp: a unit costs its whole pair
// arithmetic when any one of its 32 pixels is open (not stopped), and on
// the trained model most pixels stop early and not together. On top of it
// each entry needs, per warp band in which any lane blended it, a sum of 9
// fields over 32 lanes (the SM retires one warp-wide shuffle per clock
// against four FP32 instructions), and the warps' sums are added up.
//
// What the earlier form lost, at the train path's inputs (copies of it
// with those lines changed, timed on an NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md): of its 1.44 ms, about 0.45 ms went to 9 separate shfl_down
// trees per (entry, band), 45 shuffles, and to flushing the warps'
// partials every 32 entries between two barriers; about 0.13 ms to the
// IEEE division; 101 registers held it to 2 blocks per SM. Its units were
// 32-pixel rows, which open and blended pixels leave partly idle more
// often than compact blocks.
//
// What this form does about it (each choice timed against its alternative
// in the same way; PERF.md):
//   - 8 x 4 units, which a tile's open and blended pixels fill better than
//     rows.
//   - A box cull: pixels outside the box where alpha >= 1/255 can hold
//     are not open, and one vote skips a unit with no open pixel; the rest
//     of the pixel loop is branch-free (selects), measured faster than a
//     branch at each skip or stop.
//   - A transpose-reduce (warp_sum.cuh, shared with the routing kernel):
//     the 9 per-lane sums are folded by recursive halving with
//     __shfl_xor_sync in 12 shuffles, and end spread over 9 fixed lanes,
//     which store them with one instruction. The warp vote still skips
//     bands that blended nothing.
//   - Moments of dpower per pixel (5 sums); the entry's conic turns them
//     into d mean2d and d conic once per entry, in the flush.
//   - The partials of a whole batch are flushed at the next batch's two
//     barriers, so the flush adds none. The flush runs beside the staging
//     of the next batch, so the conic it reads is double-buffered.
//   - __fdividef for the division (1 - alpha >= 0.01) and
//     __launch_bounds__ for 3 blocks per SM (at most 80 registers).
// Tried and slower: 128 threads (4 bands, 8 pixels a thread), 2 or 4
// blocks per SM, and skipping warps whose pixels all stopped every 32
// entries (a vote that costs more than it saves once units are compact).
//
// Not used, and why:
//   - Tensor cores. The per-entry sums reduce nonlinear per-pair terms;
//     there is no product with reuse. An mma against a ones operand would
//     need 3xTF32 splits to keep float32 accuracy, and fragment shuffles
//     that cost what they save.
//   - TMA. Entries are gathered by id as 4-16-byte scattered loads, not
//     tiles, and a tile of the trained model has about 5 batches of 128.
//
// The TPU kernel's means (visits, MXU triangular-matmul prefix scans and
// moment matmuls, bf16 operand splits, log-space T) are not carried over.

#include <cuda_runtime.h>

#include "blend.cuh"
#include "warp_sum.cuh"

namespace {

constexpr int kThreads = gs::kMaxThreads;  // threads per block at a compiled geometry
// Resident blocks per SM: at most 80 registers a thread (65,536 / 768 is
// 85, rounded down to the allocation unit of 8). Not asked of the larger
// runtime geometries (8 or 16 pixels a thread), which would spill.
constexpr int kMinBlocks = 3;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 128;  // entries staged per round; their partials fill s_part
using gs::kFields;

// Writes the rows of entries base .. base + n - 1 of the sorted list from
// the partials of the block's `warps` warps, summed in warp order. Fields
// 0-4 of a partial are moments of dpower (sum dpower dx, dpower dy, dpower
// dx^2, dpower dx dy, dpower dy^2); the entry's conic (a, b, c) turns them
// into d mean2d and d conic here, once per entry instead of once per pixel.
__device__ __forceinline__ void flush(const float (&part)[kBatch][kWarps][kFields],
                                      const float4* __restrict__ conic_op, int base, int n,
                                      const int* __restrict__ entry_src,
                                      float* __restrict__ rows, int threads, int warps) {
  for (int t = threadIdx.x; t < n * kFields; t += threads) {
    const int j = t / kFields;
    const int f = t % kFields;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < warps; ++w) s += part[j][w][f];
    float v = s;  // d rgb, d opacity
    if (f < 2) {  // d mean2d needs both first moments
      float s_other = 0.0f;
#pragma unroll
      for (int w = 0; w < warps; ++w) s_other += part[j][w][1 - f];
      const float4 co = conic_op[j];
      v = f == 0 ? -(co.x * s + co.y * s_other)   // d mx = -(a Sx + b Sy)
                 : -(co.z * s + co.y * s_other);  // d my = -(c Sy + b Sx)
    }
    if (f == 2 || f == 4) v = -0.5f * s;  // d a, d c
    if (f == 3) v = -s;                   // d b
    rows[static_cast<long long>(entry_src[base + j]) * kFields + f] = v;
  }
}

// TILE_W, TILE_H > 0: a compiled geometry (256 threads, units of whole
// rows); 0: the geometry tile_w x tile_h of the arguments, in blocks of
// blockDim.x threads (blend.cuh's block_shape), as the forward.
template <int TILE_W, int TILE_H, int kPix>
__global__ void __launch_bounds__(kThreads, TILE_W > 0 || kPix <= 4 ? kMinBlocks : 1)
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
                     int width, int height, int grid_x, int origin_y, int tile_w, int tile_h) {
  constexpr bool kCompiled = TILE_W > 0;
  static_assert(!kCompiled || TILE_W * TILE_H == kThreads * kPix,
                "tile must split evenly over the block");
  static_assert(kBatch <= kThreads, "one thread stages each entry of a batch");
  const int threads = kCompiled ? kThreads : blockDim.x;
  const int warps = kCompiled ? kWarps : threads / 32;
  const int tw = kCompiled ? TILE_W : tile_w;
  const int th = kCompiled ? TILE_H : tile_h;

  __shared__ float2 s_mean[kBatch];
  // a, b, c, opacity, of two batches by parity: the flush of one batch
  // reads its conics while the next batch's are staged.
  __shared__ float4 s_conic_op[2][kBatch];
  __shared__ float4 s_rgb[kBatch];    // r, g, b, unused
  __shared__ float2 s_reach[kBatch];  // reach of each entry
  // Each warp's sums of the batch's entries, flushed at the next batch's
  // barriers: the flush needs none of its own.
  __shared__ float s_part[kBatch][kWarps][kFields];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int my_field = gs::field_of_lane(lane);
  const int tile = blockIdx.x;
  const int x0 = (tile % grid_x) * tw;
  const int y0 = (tile / grid_x) * th;
  const int start = tile_start[tile];
  const int stop = tile_stop[tile];

  float px[kPix], py[kPix], T[kPix], pfx[kPix], total[kPix], g[kPix][3];
  bool done[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int2 q = gs::unit_pixel<TILE_W, kPix>(warp, k, lane, tw);
    const int x = x0 + q.x;
    const int y = y0 + q.y;
    px[k] = static_cast<float>(x);
    py[k] = static_cast<float>(origin_y + y);
    T[k] = 1.0f;
    pfx[k] = 0.0f;
    done[k] = x >= width || y >= height || (!kCompiled && q.y >= th);
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
  int pending = 0;   // entries of the previous batch whose partials s_part holds
  int cur = 0;       // the half of s_conic_op this batch is staged in
  // Stages entry base + i of the tile's list into slot i of the batch.
  const auto stage = [&](int i, int base) {
    const int e = base + i;
    if (e >= stop) return;
    const int gid = gauss_id[e];
    s_mean[i] = means2d[gid];
    const float4 co = make_float4(conic[3 * gid], conic[3 * gid + 1], conic[3 * gid + 2],
                                  opacity[gid]);
    s_conic_op[cur][i] = co;
    s_rgb[i] = make_float4(rgb[3 * gid], rgb[3 * gid + 1], rgb[3 * gid + 2], 0.0f);
    s_reach[i] = gs::reach(co.x, co.y, co.z, co.w);
  };
  for (int base = start; base < stop; base += kBatch) {
    bool all_done = true;
#pragma unroll
    for (int k = 0; k < kPix; ++k) all_done = all_done && done[k];
    // Also the barrier after which the previous batch's staged entries and
    // partials are complete and no longer read by the pair loop.
    if (__syncthreads_count(all_done) == threads) break;
    // Reads s_part and the previous batch's half of s_conic_op; the staging
    // below writes only the other half.
    flush(s_part, s_conic_op[cur ^ 1], next - pending, pending, entry_src, rows, threads, warps);

    if constexpr (kCompiled) {
      if (threadIdx.x < kBatch) stage(threadIdx.x, base);
    } else {  // a block may have fewer threads than a batch has entries
      for (int i = threadIdx.x; i < kBatch; i += threads) stage(i, base);
    }
    __syncthreads();  // staged, and the flush's reads of s_part are over

    const int n = min(kBatch, stop - base);
    for (int j = 0; j < n; ++j) {
      const float2 mean = s_mean[j];
      const float4 co = s_conic_op[cur][j];
      const float4 c = s_rgb[j];
      const float2 box = s_reach[j];
      float acc[kFields];  // moments of dpower (see flush), d rgb, d opacity
#pragma unroll
      for (int f = 0; f < kFields; ++f) acc[f] = 0.0f;
      bool any = false;
      // Branch-free but for one vote per unit: a unit with no open pixel
      // (stopped or outside the box) is skipped; in the others every lane
      // runs the pair and keeps what a blended pair adds.
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const bool open = !(done[k] || fabsf(px[k] - mean.x) > box.x || fabsf(py[k] - mean.y) > box.y);
        if (!__any_sync(gs::kFullMask, open)) continue;
        gs::Pair r;
        const bool taken =
            gs::pair_alpha(mean.x, mean.y, co.x, co.y, co.z, co.w, px[k], py[k], r) & open;
        const float test = gs::transmit(T[k], r.alpha);
        const bool stops = taken & (test < gs::kTEps);
        const bool blend = taken & !stops;
        done[k] = done[k] | stops;
        any = any | blend;
        const float cg = g[k][0] * c.x + g[k][1] * c.y + g[k][2] * c.z;
        const float w = blend ? r.alpha * T[k] : 0.0f;
        pfx[k] = blend ? pfx[k] + cg * w : pfx[k];
        // 1 - alpha >= 0.01: the approximate reciprocal rounds, decides nothing
        const float dalpha = T[k] * cg - __fdividef(total[k] - pfx[k], 1.0f - r.alpha);
        const bool gate = blend & (r.raw < gs::kAlphaMax);  // the gated clamp
        const float dpower = gate ? dalpha * r.raw : 0.0f;
        const float tx = dpower * r.dx, ty = dpower * r.dy;
        acc[0] += tx;
        acc[1] += ty;
        acc[2] += tx * r.dx;
        acc[3] += tx * r.dy;
        acc[4] += ty * r.dy;
        acc[5] += g[k][0] * w;
        acc[6] += g[k][1] * w;
        acc[7] += g[k][2] * w;
        acc[8] += gate ? dalpha * r.g : 0.0f;
        T[k] = blend ? test : T[k];
      }
      // zeros where no lane of the warp blended the entry
      const float v = __any_sync(gs::kFullMask, any) ? gs::warp_sum9(acc, lane) : 0.0f;
      if (my_field >= 0) s_part[j][warp][my_field] = v;
    }
    pending = n;
    next = base + n;
    cur ^= 1;
  }
  __syncthreads();  // the last batch's partials are complete
  flush(s_part, s_conic_op[cur ^ 1], next - pending, pending, entry_src, rows, threads, warps);

  // Entries after the block's exit: every pixel was done, zero rows.
  for (int t = threadIdx.x; t < (stop - next) * kFields; t += threads) {
    rows[static_cast<long long>(entry_src[next + t / kFields]) * kFields + t % kFields] = 0.0f;
  }

  if (replay_t != nullptr) {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int2 q = gs::unit_pixel<TILE_W, kPix>(warp, k, lane, tw);
      const int x = x0 + q.x;
      const int y = y0 + q.y;
      if (x < width && y < height && (kCompiled || q.y < th))
        replay_t[static_cast<long long>(y) * width + x] = T[k];
    }
  }
}

struct Args {
  const void* in[12];  // gauss_id .. g_final_t, in the entry point's order
  void *rows, *replay_t;
  int width, height, tile_w, tile_h, origin_y;
};

struct Launch {
  const Args& a;
  cudaStream_t stream;
  template <int TILE_W, int TILE_H, int kPix>
  cudaError_t run(int threads) const {
    const int grid_x = (a.width + a.tile_w - 1) / a.tile_w;
    const int grid_y = (a.height + a.tile_h - 1) / a.tile_h;
    const void* const* in = a.in;
    composite_bwd_kernel<TILE_W, TILE_H, kPix><<<grid_x * grid_y, threads, 0, stream>>>(
        static_cast<const int*>(in[0]), static_cast<const int*>(in[1]),
        static_cast<const int*>(in[2]), static_cast<const int*>(in[3]),
        static_cast<const float2*>(in[4]), static_cast<const float*>(in[5]),
        static_cast<const float*>(in[6]), static_cast<const float*>(in[7]),
        static_cast<const float*>(in[8]), static_cast<const float*>(in[9]),
        static_cast<const float*>(in[10]), static_cast<const float*>(in[11]),
        static_cast<float*>(a.rows), static_cast<float*>(a.replay_t), a.width, a.height, grid_x,
        a.origin_y, a.tile_w, a.tile_h);
    return cudaGetLastError();
  }
};

struct Occupancy {
  int* out;
  template <int TILE_W, int TILE_H, int kPix>
  cudaError_t run(int threads) const {
    return gs::occupancy(composite_bwd_kernel<TILE_W, TILE_H, kPix>, threads, out);
  }
};

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) of device `device` and
// returns the cudaError_t of the launch (0 on success). Tile geometries:
// tile_w, tile_h >= 1 with tile_w * tile_h <= 4096 (blend.cuh); any other
// returns cudaErrorInvalidValue. All pointers are device pointers to
// contiguous arrays: gauss_id, entry_src (K,) int32; tile_start/tile_stop
// (num_tiles,) int32; means2d (P,2), conic (P,3), rgb (P,3), opacity (P,)
// float32; image, g_image (H,W,3), final_t, g_final_t (H,W) float32; out
// rows (K,9) float32 and replay_t (H,W) float32 or null. origin_y: the
// global pixel row of the image's first row (0: a whole frame).
extern "C" int gs_composite_bwd(const void* gauss_id, const void* tile_start,
                                const void* tile_stop, const void* entry_src,
                                const void* means2d, const void* conic, const void* rgb,
                                const void* opacity, const void* image, const void* final_t,
                                const void* g_image, const void* g_final_t, void* rows,
                                void* replay_t, int width, int height, int tile_w, int tile_h,
                                int origin_y, int device, void* stream) {
  if (width <= 0 || height <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{{gauss_id, tile_start, tile_stop, entry_src, means2d, conic, rgb, opacity, image,
                final_t, g_image, g_final_t},
               rows, replay_t, width, height, tile_w, tile_h, origin_y};
  return gs::dispatch(tile_w, tile_h, Launch{a, static_cast<cudaStream_t>(stream)});
}

// Fills out[0..2] with the kernel's registers per thread, threads per
// block and resident blocks per SM on device `device`, for a tile geometry
// as above; returns the cudaError_t.
extern "C" int gs_composite_bwd_occupancy(int tile_w, int tile_h, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return gs::dispatch(tile_w, tile_h, Occupancy{out});
}

extern "C" const char* gs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
