// Transpose of an (R, K) float32 array to (K, R), 1 <= R <= 32, any K.
//
// Replaces two TPU kernels that compute this function:
//   - gaussian_splatting_tpu/ops/relayout.py::_to_rows_kernel, the streaming
//     transpose that pinned an XLA layout in the backward's gradient routing
//     (composite_pallas.py:732, R = 9). Its call site is served on the card
//     by csrc/route_grads.cu, which sums the rows directly; this kernel is
//     the counterpart of the function itself. The TPU version pads its output
//     to a multiple of its 2048-wide block; this one writes exactly K rows
//     (callers read rows < K only).
//   - tools/profile_stages.py::tkern, the same transpose in blocks of 2048 at
//     R = 16 (the profiler's `micro` stage).
// The plain torch version is gaussian_splatting_torch/ops/relayout.py::
// relayout_to_rows_torch (`x.t().contiguous()`).
//
// What bounds it on an H100: bytes. It reads and writes 4 R bytes per column
// and does no arithmetic. Each block of kThreads threads owns kTile = 256
// columns:
//   - it reads them row by row, each warp 128 contiguous bytes of one row
//     (coalesced along K), into a shared tile laid out [column][row]; each
//     thread issues the loads of up to 8 rows before it stores any, so that
//     enough reads are in flight to cover the memory's latency;
//   - the block's output is the contiguous run of kTile * R floats starting
//     at row k0 of the (K, R) output, so it writes that run with consecutive
//     threads on consecutive addresses (whole rows of R floats, coalesced).
// Shared-memory banks: the tile's row stride is R rounded up to an odd
// number. Filling it, the 32 lanes of a warp write 32 consecutive columns of
// one row, addresses 32 multiples of an odd stride: 32 different banks.
// Draining it, consecutive lanes read consecutive elements of the run, which
// for odd R are consecutive addresses; for even R the padding word skips one
// bank every R elements, so at most two lanes of a warp share a bank.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;  // columns per block, one per thread
constexpr int kMaxRows = 32;
constexpr int kBatch = 8;  // loads a thread issues before it stores them

__global__ void __launch_bounds__(kThreads)
relayout_to_rows_kernel(const float* __restrict__ x, float* __restrict__ out, long long k,
                        int r) {
  __shared__ float tile[kTile * (kMaxRows + 1)];
  const int stride = r | 1;  // odd row stride: no bank conflicts filling the tile
  const long long k0 = static_cast<long long>(blockIdx.x) * kTile;
  const int cols = static_cast<int>(k - k0 < kTile ? k - k0 : kTile);

  // Thread c owns column c (kTile == kThreads). Its loads go out kBatch at a
  // time before any is stored, so each thread keeps kBatch reads in flight.
  const int c = threadIdx.x;
  if (c < cols) {
    const float* src = x + k0 + c;
    for (int j0 = 0; j0 < r; j0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        v[u] = j0 + u < r ? src[static_cast<long long>(j0 + u) * k] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j0 + u < r) tile[c * stride + j0 + u] = v[u];
      }
    }
  }
  __syncthreads();

  float* dst = out + k0 * r;
  const int n = cols * r;
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int col = e / r;
    dst[e] = tile[col * stride + (e - col * r)];
  }
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) of device `device` and
// returns the cudaError_t of the launch (0 on success). Device pointers to
// contiguous arrays: x (r, k) float32, out (k, r) float32.
extern "C" int gs_relayout_to_rows(const void* x, void* out, long long k, int r, int device,
                                   void* stream) {
  if (k < 0 || r < 1 || r > kMaxRows) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k == 0) return cudaSuccess;
  const long long blocks = (k + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  relayout_to_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), k, r);
  return cudaGetLastError();
}

extern "C" const char* gs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
