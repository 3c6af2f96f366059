// flash_attention: causal (optionally sliding-window) GQA attention
// forward over a whole sequence (prefill).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_fwd -> _kernel).  Inputs: q [B, S, H, D]; k, v
// [B, S, KV, D], all in one type (float32 or bfloat16), H a multiple of
// KV.  Output [B, S, H, D] in q's type.  Query i attends to keys
// j <= i, and only to j > i - window when window > 0.
//
// What it computes is the TPU body's arithmetic, not its block
// structure: q scaled by D^-0.5 in float32, float32 scores, masked
// scores set to the finite -1e30, and per query row a running max m,
// normaliser l and float32 accumulator o (online softmax):
//   m' = max(m, max_j s_j); p_j = exp(s_j - m'); alpha = exp(m - m');
//   l = l * alpha + sum_j p_j; o = o * alpha + sum_j p_j v_j;
// the output is o / max(l, 1e-30).  The finite -1e30 matters: a row
// whose first staged keys all lie outside its window accumulates exp(0)
// terms until its first live key, whose alpha = exp(-1e30 - m') = 0
// wipes them, exactly as on the TPU (-INFINITY would give NaN there).
//
// Design: one block per (64-row query tile, query head, batch row); the
// grid is indexed by query head, not by kv head, so gemma3's one kv head
// still gives H * S / 64 blocks, and the heads of a group read the same K
// and V through L2.  The block stages its query tile once (float32,
// pre-scaled) and walks the keys the tile can see in tiles of 32 (K and
// V converted to float32 in shared memory): from the first key inside
// the window of the tile's first row to the tile's last row, so fully
// masked tiles are never visited (the TPU's pl.when(relevant)).  Scores
// are float32 FMAs from shared memory, 2 rows x 4 keys per thread with
// float4 loads; the online-softmax statistics of a row live in the
// registers of the 8 lanes that share it (butterfly shuffles give every
// lane the same bits); the accumulator o lives in registers, 8 (or 4)
// rows x D/32 (or D/16) columns per thread.  D is a template parameter
// (the repo's head widths: 16, 32, 64, 80, 128, 256), so the accumulator
// has a fixed size.
//
// What bounds it on an H100: float32 operations, 4 * D per live
// (query, key) pair and query head, at the card's 67 TFLOP/s outside
// the tensor cores (the bytes of q, k, v and the output are far less).
// This kernel uses no tensor cores and runs one 140 KB block per SM at
// D = 256; bf16 wgmma with TMA-fed K/V stages is the redesign.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 32;  // keys staged per tile
constexpr float kNegInf = -1e30f;

template <int D>
struct Geometry {
  static_assert(D % 16 == 0 && D >= 16 && D <= 256, "head width");
  // the accumulator: kLanes threads across a row of o, kCols columns
  // each (lane + kLanes * j); kRowGroups groups of rows, kRows rows each
  // (group + kRowGroups * i)
  static constexpr int kLanes = D % 32 == 0 ? 32 : 16;
  static constexpr int kCols = D / kLanes;
  static constexpr int kRowGroups = kThreads / kLanes;
  static constexpr int kRows = kBQ / kRowGroups;
  // row strides of the staged tiles, in floats: +4 keeps float4
  // alignment and spreads the rows read together over the banks
  static constexpr int kQKStride = D + 4;
  static constexpr int kPStride = kBK + 4;
  static constexpr int kSmemFloats = kBQ * kQKStride + kBK * kQKStride +
                                     kBK * D + kBQ * kPStride + 2 * kBQ;
};

// Stage `rows` rows of D elements (row stride `stride` elements) into
// shared memory as float32 times `mul`; rows at or past `valid` are 0.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* __restrict__ src,
                                      long long stride, int rows, int valid,
                                      float* __restrict__ dst,
                                      int dst_stride, float mul) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[r * dst_stride + d] =
        r < valid ? qs::to_f32(src[r * stride + d]) * mul : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int H, int KV, int window, float scale) {
  using G = Geometry<D>;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                          // [kBQ, kQKStride]
  float* k_s = q_s + kBQ * G::kQKStride;      // [kBK, kQKStride]
  float* v_s = k_s + kBK * G::kQKStride;      // [kBK, D]
  float* p_s = v_s + kBK * D;                 // [kBQ, kPStride]
  float* alpha_s = p_s + kBQ * G::kPStride;   // [kBQ]
  float* l_s = alpha_s + kBQ;                 // [kBQ]

  // the longest query tiles (most keys) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_rows = min(kBQ, S - q0);
  const int tid = threadIdx.x;
  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KV) * D;
  const long long q_off = (static_cast<long long>(b) * S + q0) * q_stride +
                          static_cast<long long>(h) * D;
  const long long kv_off = static_cast<long long>(b) * S * kv_stride +
                           static_cast<long long>(kvh) * D;

  stage<T, D>(q + q_off, q_stride, kBQ, q_rows, q_s, G::kQKStride, scale);

  // scores: rows sr and sr + 32, keys sc + 8 j; the 8 lanes of a row are
  // lanes 8 r' .. 8 r' + 7 of one warp
  const int sr = tid >> 3, sc = tid & 7;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.0f, 0.0f};
  // accumulator: rows og + kRowGroups i, columns oc + kLanes j
  const int oc = tid % G::kLanes, og = tid / G::kLanes;
  float o[G::kRows][G::kCols];
#pragma unroll
  for (int i = 0; i < G::kRows; ++i)
#pragma unroll
    for (int j = 0; j < G::kCols; ++j) o[i][j] = 0.0f;

  // keys the tile can see: from the first key inside the first row's
  // window to the last row (causal)
  const int q_last = q0 + q_rows - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = k_first / kBK * kBK; k0 <= q_last; k0 += kBK) {
    const int k_rows = min(kBK, S - k0);
    __syncthreads();  // the previous tile's K, V, p and alpha are consumed
    stage<T, D>(k + kv_off + k0 * kv_stride, kv_stride, kBK, k_rows, k_s,
                G::kQKStride, 1.0f);
    stage<T, D>(v + kv_off + k0 * kv_stride, kv_stride, kBK, k_rows, v_s, D,
                1.0f);
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[2], c[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            q_s + (sr + 32 * i) * G::kQKStride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(
            k_s + (sc + 8 * j) * G::kQKStride + d);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float acc = s[i][j];
          acc = fmaf(a[i].x, c[j].x, acc);
          acc = fmaf(a[i].y, c[j].y, acc);
          acc = fmaf(a[i].z, c[j].z, acc);
          acc = fmaf(a[i].w, c[j].w, acc);
          s[i][j] = acc;
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = sr + 32 * i;
      const int qpos = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + sc + 8 * j;
        const bool live =
            kpos <= qpos && (window <= 0 || kpos > qpos - window);
        s[i][j] = live ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(qs::FULL, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[row * G::kPStride + sc + 8 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(qs::FULL, sum, off);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
      if (sc == 0) alpha_s[row] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < G::kRows; ++i) {
      const float al = alpha_s[og + G::kRowGroups * i];
#pragma unroll
      for (int j = 0; j < G::kCols; ++j) o[i][j] *= al;
    }
#pragma unroll 2
    for (int t = 0; t < kBK; t += 4) {
      float4 p[G::kRows];
#pragma unroll
      for (int i = 0; i < G::kRows; ++i)
        p[i] = *reinterpret_cast<const float4*>(
            p_s + (og + G::kRowGroups * i) * G::kPStride + t);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[G::kCols];
#pragma unroll
        for (int j = 0; j < G::kCols; ++j)
          vv[j] = v_s[(t + u) * D + oc + G::kLanes * j];
#pragma unroll
        for (int i = 0; i < G::kRows; ++i) {
          const float pu = u == 0 ? p[i].x
                           : u == 1 ? p[i].y
                           : u == 2 ? p[i].z
                                    : p[i].w;
#pragma unroll
          for (int j = 0; j < G::kCols; ++j)
            o[i][j] = fmaf(pu, vv[j], o[i][j]);
        }
      }
    }
  }

  if (sc == 0) {
    l_s[sr] = l_run[0];
    l_s[sr + 32] = l_run[1];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < G::kRows; ++i) {
    const int row = og + G::kRowGroups * i;
    if (row >= q_rows) continue;
    const float l = fmaxf(l_s[row], 1e-30f);
    T* dst = out + q_off + row * q_stride;
#pragma unroll
    for (int j = 0; j < G::kCols; ++j)
      dst[oc + G::kLanes * j] = qs::from_f32<T>(o[i][j] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int window, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * Geometry<D>::kSmemFloats;
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int S, int H, int KV, int D, int window, float scale,
             cudaStream_t st) {
  switch (D) {
#define QS_FLASH_D(n) \
  case n:             \
    return launch<T, n>(q, k, v, out, B, S, H, KV, window, scale, st);
    QS_FLASH_D(16)
    QS_FLASH_D(32)
    QS_FLASH_D(64)
    QS_FLASH_D(80)
    QS_FLASH_D(128)
    QS_FLASH_D(256)
#undef QS_FLASH_D
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, S, H, D], k / v [B, S, KV, D], out [B, S, H, D]: float32 (bf16 =
// 0) or bfloat16 (1); D one of 16, 32, 64, 80, 128, 256; window <= 0 =
// causal.
extern "C" int qs_flash_attention(const void* q, const void* k,
                                  const void* v, void* out, int B, int S,
                                  int H, int KV, int D, int window,
                                  float scale, int bf16, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(q, k, v, out, B, S, H, KV, D,
                                        window, scale, st)
              : launch_d<float>(q, k, v, out, B, S, H, KV, D, window, scale,
                                st);
}
