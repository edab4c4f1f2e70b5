// Column sums of a row-major (K, R) float32 table, 1 <= R <= 32, any K, in
// two forms: one that returns them as a row, (1, R), and one that returns
// them as a column, (R, 1), with the transpose applied to each block's
// partial sums.
//
// Replaces the two consumer kernels of the profiler's `gforms` stage:
//   - tools/profile_stages.py::_sum_rows_kernel (`gs_consume_rows`): the sums
//     of a row-major table, (K, R) -> (1, R);
//   - tools/profile_stages.py::_sum_t_kernel (`gs_consume_t`): the same sums,
//     (K, R) -> (R, 1). The TPU kernel transposes each block in the kernel to
//     feed its lanes; that is how the TPU computes the function, not part of
//     what it computes.
// The plain torch versions are gaussian_splatting_torch/tools/consumers.py::
// consume_rows_torch and consume_t_torch.
//
// The TPU kernels carry the sum across a sequential grid. On the card the
// blocks run in no order, so each call is two launches: pass 1 writes one
// partial sum per (block, column), pass 2 sums each column's partials in a
// fixed order. There are no atomics, so two runs give the same bits. Every
// sum is taken in an order that depends on K and R alone (and, for the
// transposed form, on whether x is 16-byte aligned).
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
//   - transposed form: the block reads its run as float4 where R % 4 == 0
//     (and x is 16-byte aligned; else as floats), consecutive threads on
//     consecutive addresses, 8 loads in flight per thread, each thread
//     keeping the same 4 columns at every load and their sums in registers.
//     Only then is the transpose applied, once, to the per-thread partials:
//     they are staged as (R, slots) in shared memory and warp w sums columns
//     w, w + 8, ... with a shuffle tree. One barrier per block. An earlier
//     form staged the data itself, 256 rows at a time as (R, 256),
//     with two barriers per slab: 0.0775 ms at (1.9 M, 16) on an H100 80GB
//     HBM3 at 700 W, 1.10x x.sum(0) (PERF.md).
// Pass 2 gives each column one block of kThreads threads: strided
// sequential sums, a shuffle tree per warp, then the eight warp sums in
// order. Its reads (~930 R floats) are small beside pass 1's.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 2048;
constexpr int kMaxCols = 32;
constexpr int kBatch = 8;  // loads a thread issues before it uses them

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void add(float (&acc)[4], const float4& v) {
  acc[0] += v.x;
  acc[1] += v.y;
  acc[2] += v.z;
  acc[3] += v.w;
}

__device__ __forceinline__ void add(float (&acc)[1], float v) { acc[0] += v; }

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

// Transposed form, pass 1, reading V floats at a time (V = 4 needs r % 4 ==
// 0 and a 16-byte aligned x). Thread t < threads owns the V columns of
// group t % groups at every load and sums them in registers; the block's
// partials are then staged as (r, slots) and each column summed by a warp.
template <int V>
__global__ void __launch_bounds__(kThreads)
sum_t_partial_kernel(const float* __restrict__ x, float* __restrict__ partials, long long k,
                     int r) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  // r * (slots + 1) <= V * kThreads + r floats
  __shared__ float part[V * kThreads + kMaxCols];
  const int groups = r / V;              // V-float groups per row
  const int slots = kThreads / groups;   // threads per group: a column's partials
  const int threads = groups * slots;    // a multiple of groups: each thread keeps its columns
  const int stride = slots + 1;          // a column's row in `part`, padded against bank conflicts
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const long long row0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  const long long rows = k - row0 < kRowsPerBlock ? k - row0 : kRowsPerBlock;
  const Vec* src = reinterpret_cast<const Vec*>(x + row0 * r);
  const int n = static_cast<int>(rows) * groups;  // Vecs in the block's rows
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  if (threadIdx.x < threads) {
    for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * threads) {
      Vec v[kBatch];  // kBatch loads in flight before any add
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * threads;
        if (e < n) v[u] = src[e];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (e0 + u * threads < n) add(acc, v[u]);
      }
    }
    const int c0 = (threadIdx.x % groups) * V;
#pragma unroll
    for (int i = 0; i < V; ++i) part[(c0 + i) * stride + threadIdx.x / groups] = acc[i];
  }
  __syncthreads();  // the one barrier of the block
  for (int c = warp; c < r; c += kWarps) {  // warp w sums columns w, w + 8, ...
    float s = 0.0f;
    for (int j = lane; j < slots; j += 32) s += part[c * stride + j];
    s = warp_sum(s);
    if (lane == 0) partials[static_cast<long long>(blockIdx.x) * r + c] = s;
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

// Whether the transposed form reads x four floats at a time.
bool vec4(const void* x, int r) { return r % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0; }

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
    if (transposed && vec4(x, r)) {
      sum_t_partial_kernel<4><<<blocks, kThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<float*>(partials), k, r);
    } else if (transposed) {
      sum_t_partial_kernel<1><<<blocks, kThreads, 0, st>>>(
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

// Fills out[0..2] with the registers per thread, threads per block and
// resident blocks per SM of the transposed form's first pass on device
// `device`, as it runs for r columns of an aligned table; returns the
// cudaError_t.
extern "C" int gs_consume_t_occupancy(int r, int device, int* out) {
  if (r < 1 || r > kMaxCols) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* kernel = r % 4 == 0 ? reinterpret_cast<const void*>(sum_t_partial_kernel<4>)
                                  : reinterpret_cast<const void*>(sum_t_partial_kernel<1>);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  out[0] = attr.numRegs;
  out[1] = kThreads;
  out[2] = blocks;
  return err;
}

extern "C" const char* gs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
