// Per-Gaussian sums of the backward's entry rows (gradient routing).
//
// Replaces, at its one call site, the TPU kernel gaussian_splatting_tpu/
// ops/relayout.py::_to_rows_kernel: a (9, K) -> (K, 9) transpose that
// existed only to pin an XLA layout for the boundary gathers of the
// routing's prefix sums (composite_pallas.py:701-749). What that call site
// computes is the sum of each Gaussian's 9 gradient columns over its
// entries, and that is what this kernel computes; the plain torch version
// is gaussian_splatting_torch/ops/composite.py::route_grads_torch. The
// transpose itself, the function _to_rows_kernel computes, has its own
// counterpart in csrc/relayout.cu, which the routing does not need.
//
// composite_bwd.cu writes each entry's row at its emission index, and
// emission runs are contiguous by Gaussian id, so Gaussian g owns rows
// [offset[g], offset[g] + count[g]) of the (K, 9) buffer. No sort, no
// atomics, and no prefix differences: the TPU path took run sums as
// differences of a global prefix sum and had to centre each column on its
// mean to keep the rounding of large prefixes out of small runs
// (composite_pallas.py:709-725). Only the rows of runs are read, never the
// capacity's padding; a Gaussian with no rows gets zeros. The order of the
// additions depends only on the run lengths, so two runs give the same
// bits.
//
// What bounds it on an H100: bytes. It reads 36 B per kept entry and 8 B of
// run bounds per Gaussian, writes 36 B per Gaussian, and does 9 adds per
// entry. But the work of one Gaussian is its run, and runs are skewed: at
// the train path's inputs (the trained model at 1080p, camera angle 0) the
// median is 9 rows, p99.9 140 and the longest 1,044. The earlier form gave
// each (Gaussian, field) one thread that walked the run one row at a time,
// so a warp lasted as long as the longest of its 3-4 runs, one dependent
// step per row: at the same model's runs before training (longest 1,026,
// p99.9 130), cutting every run to 130 rows took 0.025 of its 0.056 ms
// (PERF.md).
//
// What this form does about it. A block takes 32 consecutive Gaussians,
// a warp 4 of them. Lane l sums rows l, l + 32, ... of a run (its 9
// fields), the first 32 rows of the warp's 4 runs with all their loads in
// flight together, so a warp waits for memory about once, not once per
// row; the 4 sums then meet in the 12-shuffle transpose-reduce of
// warp_sum.cuh, and the 9 lanes that hold a Gaussian's sums store its
// 36 B with one instruction. A run longer than kBlockRun rows is left to
// the whole block after that, one run at a time (256 rows a round, the 8
// warps' sums added in warp order), so no warp walks a long run alone.
// Timed forms (scratch copies of this file, not kept, at those runs before
// training, NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// this form 0.0301 ms, 0.0296 with every run cut to 130 rows; a warp per
// 4 Gaussians without the block tier 0.0347 (0.0283 cut); one warp per
// Gaussian 0.0438; 8 lanes per Gaussian, 10 shuffles for 4 of them,
// 0.0376; 288-float windows read coalesced and put in field order by a
// rotation 0.0440; the earlier thread per (Gaussian, field) with runs
// over 32 rows left to the warp 0.0387; a block per 1,024-row chunk with
// a second launch for runs cut by a chunk edge 0.0808-0.0865 (a search
// for the chunk's first Gaussian and a reduction per Gaussian cost more
// than the balance saves).

#include <cuda_runtime.h>

#include "warp_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerWarp = 4;
constexpr int kPerBlock = kWarps * kPerWarp;
constexpr int kBlockRun = 256;  // longer runs are summed by the whole block
using gs::kFields;

__global__ void __launch_bounds__(kThreads)
route_grads_kernel(const float* __restrict__ rows, const int* __restrict__ offset,
                   const int* __restrict__ count, float* __restrict__ out, int num_points) {
  __shared__ int s_off[kPerBlock], s_cnt[kPerBlock];
  __shared__ float s_part[kWarps][kFields];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gb = blockIdx.x * kPerBlock;
  const int g0 = gb + warp * kPerWarp;
  // Lanes 0-3 read the bounds of the warp's 4 runs (0 rows past the end);
  // shuffles hand them round, shared memory keeps them for the block.
  int my_off = 0, my_cnt = 0;
  if (lane < kPerWarp && g0 + lane < num_points) {
    my_off = offset[g0 + lane];
    my_cnt = count[g0 + lane];
  }
  const bool my_long = lane < kPerWarp && my_cnt > kBlockRun;
  if (lane < kPerWarp) {
    s_off[warp * kPerWarp + lane] = my_off;
    s_cnt[warp * kPerWarp + lane] = my_cnt;
  }
  float a[kPerWarp][kFields];
  int cnt[kPerWarp];
  bool keep[kPerWarp];  // summed here, not by the block
  const float* run[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int n = __shfl_sync(gs::kFullMask, my_cnt, i);
    keep[i] = n <= kBlockRun;
    cnt[i] = keep[i] ? n : 0;
    run[i] = rows + static_cast<long long>(__shfl_sync(gs::kFullMask, my_off, i)) * kFields;
  }
  // The first 32 rows of all 4 runs, their loads in flight together.
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) a[i][f] = lane < cnt[i] ? run[i][lane * kFields + f] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
#pragma unroll 4
    for (int r = lane + 32; r < cnt[i]; r += 32) {
#pragma unroll
      for (int f = 0; f < kFields; ++f) a[i][f] += run[i][static_cast<long long>(r) * kFields + f];
    }
  }
  const int field = gs::field_of_lane(lane);
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const float v = gs::warp_sum9(a[i], lane);
    const int g = g0 + i;
    if (field >= 0 && g < num_points && keep[i])
      out[static_cast<long long>(g) * kFields + field] = v;
  }
  // Runs longer than kBlockRun rows: the whole block, one run at a time.
  if (!__syncthreads_or(my_long)) return;
  for (int q = 0; q < kPerBlock; ++q) {
    const int n = s_cnt[q];
    if (n <= kBlockRun) continue;
    const float* r0 = rows + static_cast<long long>(s_off[q]) * kFields;
    float b[kFields];
#pragma unroll
    for (int f = 0; f < kFields; ++f) b[f] = 0.0f;
#pragma unroll 4
    for (int r = threadIdx.x; r < n; r += kThreads) {
#pragma unroll
      for (int f = 0; f < kFields; ++f) b[f] += r0[static_cast<long long>(r) * kFields + f];
    }
    const float v = gs::warp_sum9(b, lane);
    if (field >= 0) s_part[warp][field] = v;
    __syncthreads();
    if (threadIdx.x < kFields) {
      float t = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += s_part[w][threadIdx.x];
      out[static_cast<long long>(gb + q) * kFields + threadIdx.x] = t;
    }
    __syncthreads();
  }
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) of device `device` and
// returns the cudaError_t of the launch (0 on success). Device pointers to
// contiguous arrays: rows (K,9) float32, offset/count (P,) int32, out (P,9)
// float32.
extern "C" int gs_route_grads(const void* rows, const void* offset, const void* count,
                              void* out, int num_points, int device, void* stream) {
  if (num_points < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (num_points == 0) return cudaSuccess;
  const int blocks = (num_points + kPerBlock - 1) / kPerBlock;
  route_grads_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(offset),
      static_cast<const int*>(count), static_cast<float*>(out), num_points);
  return cudaGetLastError();
}

extern "C" const char* gs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
