// qsgd_quantize: bucketed QSGD stochastic quantization against supplied
// uniforms.
//
// Replaces the TPU kernel src/repro/kernels/qsgd.py (qsgd_quantize ->
// _kernel).  Per row (bucket) of x [rows, n] float32 with uniforms u of
// the same shape:
//   norm = ||x||_2; safe = norm > 0 ? norm : 1
//   level = |x| / safe * s; low = floor(level)
//   xi = low + (u < level - low)
//   out = norm > 0 ? norm * sign(x) * xi / s : 0
// The uniforms come in as an operand, as on the TPU, so the kernel needs
// no random generator of its own and is deterministic given its inputs.
//
// What bounds it on an H100: memory.  It must read x and u and write out:
// 12 bytes per element, for about ten float32 operations per element.
// Dispatch sends a whole leaf as one row, so a row can hold 512Ki
// elements (2 MiB), more than one SM's shared memory; the norm is a
// reduction across the whole row.  Design: one block of 1024 threads
// per row, looping over the row twice (sum of squares, then quantize);
// the second read of x mostly hits L2.  A row per block leaves most SMs
// idle when a launch holds few rows; splitting long rows over several
// blocks (a partial-sum pass, then the quantize pass) is a later change.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
qsgd_quantize_kernel(const float* __restrict__ x, const float* __restrict__ u,
                     float* __restrict__ out, long long n, float s) {
  __shared__ float scratch[32];
  const long long base = static_cast<long long>(blockIdx.x) * n;
  const float* __restrict__ xr = x + base;
  const int tid = threadIdx.x;

  float sq = 0.0f;
  for (long long i = tid; i < n; i += kThreads) {
    const float v = xr[i];
    sq += v * v;
  }
  const float norm = sqrtf(qs::block_sum<kThreads>(sq, scratch));
  const float safe = norm > 0.0f ? norm : 1.0f;
  for (long long i = tid; i < n; i += kThreads) {
    const float v = xr[i];
    const float level = fabsf(v) / safe * s;
    const float low = floorf(level);
    const float xi = low + (u[base + i] < level - low ? 1.0f : 0.0f);
    const float q = norm * qs::sign_of(v) * xi / s;
    out[base + i] = norm > 0.0f ? q : 0.0f;
  }
}

}  // namespace

extern "C" int qs_qsgd_quantize_f32(const float* x, const float* u,
                                    float* out, long long rows, long long n,
                                    int s, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  qsgd_quantize_kernel<<<static_cast<unsigned>(rows), kThreads, 0, st>>>(
      x, u, out, n, static_cast<float>(s));
  return static_cast<int>(cudaGetLastError());
}
