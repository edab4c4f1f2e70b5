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
// [offset[g], offset[g] + count[g]) of the (K, 9) buffer. One thread per
// (Gaussian, field) sums its column of that run in order and writes one
// element of the (P, 9) output. No sort, no atomics, and no prefix
// differences: the TPU path took run sums as differences of a global prefix
// sum and had to centre each column on its mean to keep the rounding of
// large prefixes out of small runs (composite_pallas.py:709-725). Here the
// error is that of a sequential float32 sum over one run, and two runs
// give the same bits.
//
// What bounds it on an H100: bytes. It reads 36 B per kept entry and 8 B of
// run bounds per Gaussian, writes 36 B per Gaussian, and does 9 adds per
// entry. Thread i owns element i of the (P, 9) output, so a warp writes 128
// contiguous bytes, and at each step reads the current 36-byte row of each
// of its 3-4 Gaussians, whose runs are neighbours in the buffer.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 9;

__global__ void __launch_bounds__(kThreads)
route_grads_kernel(const float* __restrict__ rows, const int* __restrict__ offset,
                   const int* __restrict__ count, float* __restrict__ out, int num_points) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(num_points) * kFields) return;
  const int g = static_cast<int>(i / kFields);
  const int f = static_cast<int>(i % kFields);
  const long long first = offset[g];
  const long long last = first + count[g];
  float acc = 0.0f;
  for (long long r = first; r < last; ++r) acc += rows[r * kFields + f];
  out[i] = acc;
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
  const long long threads = static_cast<long long>(num_points) * kFields;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  route_grads_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(offset),
      static_cast<const int*>(count), static_cast<float*>(out), num_points);
  return cudaGetLastError();
}

extern "C" const char* gs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
