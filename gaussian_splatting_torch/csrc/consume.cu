// Column sums of a row-major (K, R) float32 table, 1 <= R <= 32, any K, in
// two forms: one that reads row-major blocks and one that first stages each
// block through shared memory as (R, rows).
//
// Replaces the two consumer kernels of the profiler's `gforms` stage:
//   - tools/profile_stages.py::_sum_rows_kernel (`gs_consume_rows`): the sums
//     of a row-major table, (K, R) -> (1, R);
//   - tools/profile_stages.py::_sum_t_kernel (`gs_consume_t`): the same sums,
//     (K, R) -> (R, 1), each block transposed in the kernel first.
// The plain torch versions are gaussian_splatting_torch/tools/consumers.py::
// consume_rows_torch and consume_t_torch.
//
// The TPU kernels carry the sum across a sequential grid. On the card the
// blocks run in no order, so each call is two launches: pass 1 writes one
// partial sum per (block, column), pass 2 sums each column's partials in a
// fixed order. There are no atomics, so two runs give the same bits. Every
// sum is taken in an order that depends on K and R alone.
//
// What bounds it on an H100: bytes. It reads 4 R bytes per row and does one
// add per element. Pass 1 gives each block kRowsPerBlock rows (a contiguous
// run of kRowsPerBlock * R floats), so K = 1.9 M rows make ~930 blocks, seven
// per SM:
//   - rows form: the block reads its run with consecutive threads on
//     consecutive addresses. It uses R * floor(256 / R) threads, so the
//     column of each thread is the same at every step (its index mod R).
//     The block's per-column sums come from shared memory, each summed by
//     one thread in thread order.
//   - transposed form: the block stages kStage = 256 rows at a time, read
//     the same coalesced way (each thread issues 8 loads before it stores
//     any), into a shared tile laid out [column][row]. The tile's row
//     stride is kStage + ceil(32 / R): the 32 elements a warp writes then
//     lie in fewer than 64 consecutive banks' worth of words, so at most two
//     lanes share a bank. Warp w then owns columns w, w + 8, ...; each lane
//     sums every 32nd row of its columns from the tile (conflict-free), and
//     a shuffle tree reduces each column over the warp. Two barriers per
//     slab. Two 128-row tiles used in turn (one barrier) measured slower on
//     an H100 at K = 1.9 M (0.102 against 0.077 ms): 53 registers a thread
//     cut the blocks per SM from 6 to 4.
// Pass 2 gives each column one block of kThreads threads: strided
// sequential sums, a shuffle tree per warp, then the eight warp sums in
// order. Its reads (~930 R floats) are small beside pass 1's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 2048;
constexpr int kStage = 256;  // rows staged at a time by the transposed form
constexpr int kMaxCols = 32;
constexpr int kColsPerWarp = kMaxCols / kWarps;
constexpr int kBatch = 8;  // loads a thread issues before it stores them

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows form, pass 1: partials[b * r + c] = sum of column c over block b's rows.
__global__ void __launch_bounds__(kThreads)
sum_rows_partial_kernel(const float* __restrict__ x, float* __restrict__ partials,
                        long long k, int r) {
  __shared__ float part[kThreads];
  const int threads = r * (kThreads / r);  // a multiple of r: each thread keeps its column
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  const long long rows = k - row0 < kRowsPerBlock ? k - row0 : kRowsPerBlock;
  const float* src = x + row0 * r;
  const long long n = rows * r;
  float acc = 0.0f;
  if (threadIdx.x < threads) {
#pragma unroll 8
    for (long long e = threadIdx.x; e < n; e += threads) acc += src[e];
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < r) {
    float s = 0.0f;
    for (int t = threadIdx.x; t < threads; t += r) s += part[t];
    partials[static_cast<long long>(blockIdx.x) * r + threadIdx.x] = s;
  }
}

// Transposed form, pass 1: each kStage-row slab staged as (r, kStage) first.
__global__ void __launch_bounds__(kThreads)
sum_t_partial_kernel(const float* __restrict__ x, float* __restrict__ partials, long long k,
                     int r) {
  __shared__ float tile[kMaxCols * (kStage + 32)];
  const int stride = kStage + (32 + r - 1) / r;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[kColsPerWarp];
#pragma unroll
  for (int i = 0; i < kColsPerWarp; ++i) acc[i] = 0.0f;

  const long long row0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  const long long end = k - row0 < kRowsPerBlock ? k : row0 + kRowsPerBlock;
  for (long long s0 = row0; s0 < end; s0 += kStage) {
    const int rows = static_cast<int>(end - s0 < kStage ? end - s0 : kStage);
    const float* src = x + s0 * r;
    const int n = rows * r;
    for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
      float v[kBatch];  // kBatch loads in flight before any store
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        v[u] = e < n ? src[e] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        if (e < n) {
          const int row = e / r;
          tile[(e - row * r) * stride + row] = v[u];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kColsPerWarp; ++i) {
      const int c = warp + i * kWarps;
      if (c < r) {
        const float* col = tile + c * stride;
        for (int row = lane; row < rows; row += 32) acc[i] += col[row];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kColsPerWarp; ++i) {
    const int c = warp + i * kWarps;
    if (c < r) {  // uniform across the warp
      const float s = warp_sum(acc[i]);
      if (lane == 0) partials[static_cast<long long>(blockIdx.x) * r + c] = s;
    }
  }
}

// Pass 2: out[c] = sum over blocks b of partials[b * r + c]; one block per column.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partials, float* __restrict__ out, int blocks,
                    int r) {
  __shared__ float warp_part[kWarps];
  const int c = blockIdx.x;
  float s = 0.0f;
  for (int b = threadIdx.x; b < blocks; b += kThreads) s += partials[static_cast<long long>(b) * r + c];
  s = warp_sum(s);
  if (threadIdx.x % 32 == 0) warp_part[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int w = 0; w < kWarps; ++w) t += warp_part[w];
    out[c] = t;
  }
}

int pass1_blocks(long long k) {
  const long long b = (k + kRowsPerBlock - 1) / kRowsPerBlock;
  return b > 0x7fffffffLL ? -1 : static_cast<int>(b);
}

int consume(bool transposed, const void* x, void* partials, long long partial_rows, void* out,
            long long k, int r, int device, void* stream) {
  if (k < 0 || r < 1 || r > kMaxCols) return cudaErrorInvalidValue;
  const int blocks = pass1_blocks(k);
  if (blocks < 0 || blocks > partial_rows) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    if (transposed) {
      sum_t_partial_kernel<<<blocks, kThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<float*>(partials), k, r);
    } else {
      sum_rows_partial_kernel<<<blocks, kThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<float*>(partials), k, r);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  sum_partials_kernel<<<r, kThreads, 0, st>>>(static_cast<const float*>(partials),
                                             static_cast<float*>(out), blocks, r);
  return cudaGetLastError();
}

}  // namespace

// Each launches its two kernels on `stream` (a cudaStream_t) of device
// `device` and returns the first failing launch's cudaError_t (0 on success).
// Device pointers to contiguous float32 arrays: x (k, r); partials, scratch
// of (partial_rows, r), where partial_rows >= ceil(k / 2048) (kRowsPerBlock);
// out, r floats.
extern "C" int gs_consume_rows(const void* x, void* partials, long long partial_rows, void* out,
                               long long k, int r, int device, void* stream) {
  return consume(false, x, partials, partial_rows, out, k, r, device, stream);
}

extern "C" int gs_consume_t(const void* x, void* partials, long long partial_rows, void* out,
                            long long k, int r, int device, void* stream) {
  return consume(true, x, partials, partial_rows, out, k, r, device, stream);
}

extern "C" const char* gs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
