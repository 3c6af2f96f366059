// flash_decode: single-token GQA decode attention over a ring KV cache
// under a slot-validity mask.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_decode_fwd -> _decode_kernel).  Inputs: q [B, 1, H, hd]; k, v
// [B, C, KV, hd] in q's type (float32 or bfloat16); valid [B, C] bytes,
// one mask per row (the TPU kernel takes one [C] mask for the batch,
// because repro's engine runs its slots one at a time; the port runs the
// slot batch at once).  Output [B, 1, H, hd] in q's type.
//
// As on the TPU, the [G, C] score tile of one (row, kv head) pair fits
// on chip whole (C is the cache length, bounded by max_len), so a plain
// masked softmax does: s = q.k * hd^-0.5, masked to -1e30; p = exp(s -
// max); o = (p @ v) / max(sum p, 1e-30).  A row with no valid slot gets
// the uniform average, as the TPU kernel's does (the engine never asks
// for one: each step writes the slot it reads).  One block owns one (row,
// kv head) pair and its G query heads: K is staged through shared memory
// 32 tokens at a time for the scores, the G x C scores stay in shared
// memory, and V is staged the same way for the weighted sum.
//
// What bounds it on an H100: the bytes of K and V (2 bytes an element in
// bf16).  One block per (row, kv head) keeps few SMs busy at small batch;
// a split over C is a later change.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // cache slots staged at a time
constexpr float kNegInf = -1e30f;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const uint8_t* __restrict__ valid, T* __restrict__ out,
                    int H, int KV, int hd, int C, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / KV, h = blockIdx.x % KV;
  const int G = H / KV;
  const int hdp = hd + 1;
  float* q_s = smem;               // [G, hd], pre-scaled
  float* s_s = q_s + G * hd;       // [G, C] scores, then exp(s - max)
  float* t_s = s_s + G * C;        // [kTile, hdp] staged K or V
  float* o_s = t_s + kTile * hdp;  // [G, hd]
  float* l_s = o_s + G * hd;       // [G]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q_base = (static_cast<long long>(b) * H + h * G) * hd;
  const long long kv_row = static_cast<long long>(b) * C;

  for (int e = tid; e < G * hd; e += kThreads) {
    q_s[e] = qs::to_f32(q[q_base + e]) * scale;
    o_s[e] = 0.0f;
  }
  for (int c0 = 0; c0 < C; c0 += kTile) {
    const int n = min(kTile, C - c0);
    __syncthreads();  // q_s is ready; the previous tile is consumed
    for (int e = tid; e < n * hd; e += kThreads) {
      const int t = e / hd, d = e % hd;
      t_s[t * hdp + d] =
          qs::to_f32(k[((kv_row + c0 + t) * KV + h) * hd + d]);
    }
    __syncthreads();
    for (int e = tid; e < G * n; e += kThreads) {
      const int g = e / n, t = e % n;
      float acc = 0.0f;
      for (int d = 0; d < hd; ++d) acc += q_s[g * hd + d] * t_s[t * hdp + d];
      s_s[g * C + c0 + t] = valid[kv_row + c0 + t] ? acc : kNegInf;
    }
  }
  __syncthreads();
  for (int g = warp; g < G; g += kThreads / 32) {
    float mx = kNegInf;
    for (int c = lane; c < C; c += 32) mx = fmaxf(mx, s_s[g * C + c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(qs::FULL, mx, off));
    float sum = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float p = expf(s_s[g * C + c] - mx);
      s_s[g * C + c] = p;
      sum += p;
    }
    sum = qs::warp_sum(sum);
    if (lane == 0) l_s[g] = sum;
  }
  for (int c0 = 0; c0 < C; c0 += kTile) {
    const int n = min(kTile, C - c0);
    __syncthreads();  // probabilities are final; the previous tile consumed
    for (int e = tid; e < n * hd; e += kThreads) {
      const int t = e / hd, d = e % hd;
      t_s[t * hdp + d] =
          qs::to_f32(v[((kv_row + c0 + t) * KV + h) * hd + d]);
    }
    __syncthreads();
    for (int e = tid; e < G * hd; e += kThreads) {
      const int g = e / hd, d = e % hd;
      float acc = o_s[e];
      for (int t = 0; t < n; ++t)
        acc += s_s[g * C + c0 + t] * t_s[t * hdp + d];
      o_s[e] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * hd; e += kThreads) {
    const float l = fmaxf(l_s[e / hd], 1e-30f);
    out[q_base + e] = qs::from_f32<T>(o_s[e] / l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v,
           const uint8_t* valid, void* out, int B, int H, int KV, int hd,
           int C, float scale, cudaStream_t st) {
  const int G = H / KV;
  const size_t smem = sizeof(float) *
      (2 * static_cast<size_t>(G) * hd + static_cast<size_t>(G) * C +
       static_cast<size_t>(kTile) * (hd + 1) + G);
  auto kern = flash_decode_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<static_cast<unsigned>(B * KV), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, static_cast<T*>(out), H, KV, hd, C,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: float32 (bf16 = 0) or bfloat16 (1); valid: [B, C] bytes.
extern "C" int qs_flash_decode(const void* q, const void* k, const void* v,
                               const uint8_t* valid, void* out, int B, int H,
                               int KV, int hd, int C, float scale, int bf16,
                               void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, valid, out, B, H, KV, hd, C,
                                      scale, st)
              : launch<float>(q, k, v, valid, out, B, H, KV, hd, C, scale,
                              st);
}
