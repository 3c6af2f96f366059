// Block-wide reductions, the block-wide prefix scan and the bisection
// threshold shared by the compression kernels, and the float32 <->
// storage-type conversions and lane-group helpers shared by the serving
// kernels.
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

// Exclusive prefix sum of one int per thread, in thread order; every
// thread also leaves with the block's total.  Same scratch discipline as
// the reductions above (alternate rows between consecutive calls).
template <int THREADS>
__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch,
                                                    int& total) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "block size");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    const int s = scratch[w];
    before += w < warp ? s : 0;
    total += s;
  }
  return before + incl - v;
}

// The survivor threshold of repro's Top_k kernels (topk_compress.py
// _bisect_threshold), shared by topk_compress and topk_compact so that
// the two cannot drift: hi = max|x|, lo = 0; `iters` rounds of
// mid = 0.5f*(lo+hi) and an int32 count of |x| >= mid (count > k raises
// lo, else lowers hi); thr = count(|x| >= hi) >= k ? hi : lo.  Every
// count is a block-wide integer reduction, so the threshold is
// bit-identical to the plain version.  `value(i)` reads element i of
// the row; int reductions alternate over iscratch's rows starting at
// `buf` (updated), the max uses `fscratch`.
template <int THREADS, typename ValueFn>
__device__ __forceinline__ float bisect_threshold(ValueFn value, long long n,
                                                  int k, int iters,
                                                  int (&iscratch)[2][32],
                                                  float* fscratch,
                                                  int& buf) {
  float m = 0.0f;
  for (long long i = threadIdx.x; i < n; i += THREADS)
    m = fmaxf(m, fabsf(value(i)));
  float hi = block_max<THREADS>(m, fscratch);
  float lo = 0.0f;
  auto count_ge = [&](float t) -> int {
    int c = 0;
    for (long long i = threadIdx.x; i < n; i += THREADS)
      c += fabsf(value(i)) >= t;
    c = block_sum<THREADS>(c, iscratch[buf]);
    buf ^= 1;
    return c;
  };
  for (int it = 0; it < iters; ++it) {
    const float mid = 0.5f * (lo + hi);
    if (count_ge(mid) > k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return count_ge(hi) >= k ? hi : lo;
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

// The decode kernels' (flash_decode, paged_decode) lane-group helpers:
// 16-byte vector -> float32 elements
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// 8-byte vector of int8 levels -> float32 elements
__device__ __forceinline__ void unpack(const uint2& u, float (&f)[8]) {
  const uint32_t w[2] = {u.x, u.y};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * i + b] = static_cast<float>(
          static_cast<int32_t>(w[i] << (24 - 8 * b)) >> 24);
}

// merge (mb, lb, ob) into (ma, la, oa): log-sum-exp rescaling
template <int N>
__device__ __forceinline__ void merge(float& ma, float& la, float (&oa)[N],
                                      float mb, float lb,
                                      const float (&ob)[N]) {
  const float m = fmaxf(ma, mb);
  const float a = expf(ma - m), c = expf(mb - m);
  la = la * a + lb * c;
#pragma unroll
  for (int e = 0; e < N; ++e) oa[e] = oa[e] * a + ob[e] * c;
  ma = m;
}

}  // namespace qs
