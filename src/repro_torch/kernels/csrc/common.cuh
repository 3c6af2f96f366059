// Block-wide reductions shared by the compression kernels, and the
// float32 <-> storage-type conversions shared by the serving kernels.
//
// Each reduction reduces within a warp by shuffles, writes one partial
// per warp to shared memory and lets every thread add the partials up,
// so all threads leave with the same value after one __syncthreads().
// The caller passes one of two scratch rows and alternates between them
// from one reduction to the next: a row is written again only after the
// barrier of the reduction in between, so no second barrier is needed.
// Sums of floats are taken in a fixed order for a fixed block size, so a
// launch is deterministic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace qs {

constexpr unsigned FULL = 0xffffffffu;

template <int THREADS>
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "block size");
  v = __reduce_add_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) total += scratch[w];
  return total;
}

template <int THREADS>
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) total += scratch[w];
  return total;
}

template <int THREADS>
__device__ __forceinline__ float block_max(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = scratch[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) total = fmaxf(total, scratch[w]);
  return total;
}

// jnp.sign / torch.sign for finite floats: -1, 0 or +1
__device__ __forceinline__ float sign_of(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// storage type -> float32 (exact) and float32 -> storage type (round to
// nearest even, as torch's .to(dtype) does)
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// warp-wide sum (every lane leaves with the total)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

}  // namespace qs
