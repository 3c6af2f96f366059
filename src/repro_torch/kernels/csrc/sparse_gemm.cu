// sparse_gemm and qdq_gemm: the compressed-weight serving GEMMs.
//
// Replaces the TPU kernels src/repro/kernels/sparse_gemm.py
// (sparse_gemm -> _sparse_kernel, qdq_gemm -> _qdq_kernel).
//
// sparse_gemm: y[m, r] = sum_s val[r, s] * x[m, idx[r, s]] over compact
// Top_k buffers idx/val [R, kcap] (row-local input indices, ascending,
// the sentinel idx = row_len after the row's survivors).  The TPU kernel
// decodes a dense weight tile in VMEM with a one-hot contraction and feeds
// the MXU; on Hopper that would spend row_len / k more work on zeros.
// Here one warp owns one output row r: its lanes hold the row's live
// slots 32 at a time, gather x[m, idx] (x stays in L2: at decode it is
// max_batch rows of d_model) and each lane's partial sums are reduced
// across the warp.  A row stops at the first 32 slots that are all
// sentinels, so Yi-6B's rows (k_row 41 or 110 of kcap 128) read 64 or 128
// slots, not the sentinel tail beyond.  What bounds it: the bytes of the
// live (idx, val) pairs, 8 per survivor, plus x and y; the gathers of x
// are scattered 4-byte reads that L2 serves.
//
// qdq_gemm: y = x @ (levels * scale).T over int8 QSGD levels [R, n] and
// a per-row f32 scale [R, 1], dequantized as the TPU kernel does (levels
// times scale, then the dot) and accumulated in f32.  It is bound by the
// bytes of the levels (Yi-6B's head: 64000 x 4096 int8, 262 MB).  Design:
// a block of 8 warps owns 32 rows (4 per warp); x is staged in shared
// memory 8 rows by 512 columns at a time, so each level is read from
// device memory once per 8 activation rows; lanes read 4 levels (one
// 32-bit word) and a float4 of x per activation row.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kSparseWarps = 8;  // output rows per block
constexpr int kSparseMT = 8;     // activation rows per pass over a row

template <typename T>
__global__ void __launch_bounds__(kSparseWarps * 32)
sparse_gemm_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                   const float* __restrict__ val, float* __restrict__ out,
                   int M, int R, int n, int kcap) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kSparseWarps + (threadIdx.x >> 5);
  if (r >= R) return;  // uniform across the warp
  const int* __restrict__ ir = idx + static_cast<long long>(r) * kcap;
  const float* __restrict__ vr = val + static_cast<long long>(r) * kcap;
  for (int m0 = 0; m0 < M; m0 += kSparseMT) {
    float acc[kSparseMT];
#pragma unroll
    for (int i = 0; i < kSparseMT; ++i) acc[i] = 0.0f;
    for (int s0 = 0; s0 < kcap; s0 += 32) {
      const int s = s0 + lane;
      const int c = s < kcap ? ir[s] : n;
      const bool live = c >= 0 && c < n;
      if (!__any_sync(qs::FULL, live)) break;  // sentinels only from here
      if (live) {
        const float v = vr[s];
#pragma unroll
        for (int i = 0; i < kSparseMT; ++i) {
          const int m = m0 + i;
          if (m < M) acc[i] += v * qs::to_f32(x[static_cast<long long>(m) * n + c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kSparseMT; ++i) {
      const float y = qs::warp_sum(acc[i]);
      const int m = m0 + i;
      if (lane == 0 && m < M) out[static_cast<long long>(m) * R + r] = y;
    }
  }
}

constexpr int kQdqWarps = 8;
constexpr int kQdqRowsPerWarp = 4;
constexpr int kQdqMT = 8;      // activation rows staged per pass
constexpr int kQdqTile = 512;  // columns staged per pass

template <typename T>
__global__ void __launch_bounds__(kQdqWarps * 32)
qdq_gemm_kernel(const T* __restrict__ x, const int8_t* __restrict__ lv,
                const float* __restrict__ scale, float* __restrict__ out,
                int M, int R, int n) {
  __shared__ __align__(16) float xs[kQdqMT][kQdqTile];
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * kQdqWarps + (threadIdx.x >> 5)) *
                 kQdqRowsPerWarp;
  for (int m0 = 0; m0 < M; m0 += kQdqMT) {
    float acc[kQdqRowsPerWarp][kQdqMT];
#pragma unroll
    for (int i = 0; i < kQdqRowsPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < kQdqMT; ++j) acc[i][j] = 0.0f;
    for (int c0 = 0; c0 < n; c0 += kQdqTile) {
      __syncthreads();  // the previous tile is consumed
      for (int e = threadIdx.x; e < kQdqMT * kQdqTile; e += blockDim.x) {
        const int mm = e / kQdqTile, c = e % kQdqTile;
        const int m = m0 + mm, col = c0 + c;
        xs[mm][c] = (m < M && col < n)
                        ? qs::to_f32(x[static_cast<long long>(m) * n + col])
                        : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kQdqRowsPerWarp; ++i) {
        const int r = r0 + i;
        if (r >= R) break;  // uniform across the warp
        const float sc = scale[r];
        const int8_t* __restrict__ lr = lv + static_cast<long long>(r) * n;
        for (int c = lane * 4; c < kQdqTile && c0 + c < n; c += 128) {
          const char4 q4 = *reinterpret_cast<const char4*>(lr + c0 + c);
          const float w0 = static_cast<float>(q4.x) * sc;
          const float w1 = static_cast<float>(q4.y) * sc;
          const float w2 = static_cast<float>(q4.z) * sc;
          const float w3 = static_cast<float>(q4.w) * sc;
#pragma unroll
          for (int j = 0; j < kQdqMT; ++j) {
            const float4 xv = *reinterpret_cast<const float4*>(&xs[j][c]);
            acc[i][j] += xv.x * w0 + xv.y * w1 + xv.z * w2 + xv.w * w3;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kQdqRowsPerWarp; ++i) {
#pragma unroll
      for (int j = 0; j < kQdqMT; ++j) {
        const float y = qs::warp_sum(acc[i][j]);
        const int r = r0 + i, m = m0 + j;
        if (lane == 0 && r < R && m < M)
          out[static_cast<long long>(m) * R + r] = y;
      }
    }
  }
}

template <typename T>
int launch_sparse(const void* x, const int* idx, const float* val,
                  float* out, int M, int R, int n, int kcap,
                  cudaStream_t st) {
  const unsigned blocks = (R + kSparseWarps - 1) / kSparseWarps;
  sparse_gemm_kernel<T><<<blocks, kSparseWarps * 32, 0, st>>>(
      static_cast<const T*>(x), idx, val, out, M, R, n, kcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_qdq(const void* x, const int8_t* lv, const float* scale,
               float* out, int M, int R, int n, cudaStream_t st) {
  const int rows_per_block = kQdqWarps * kQdqRowsPerWarp;
  const unsigned blocks = (R + rows_per_block - 1) / rows_per_block;
  qdq_gemm_kernel<T><<<blocks, kQdqWarps * 32, 0, st>>>(
      static_cast<const T*>(x), lv, scale, out, M, R, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [M, n] float32 (x_bf16 = 0) or bfloat16 (1); idx int32 / val f32
// [R, kcap]; out: [M, R] float32.
extern "C" int qs_sparse_gemm(const void* x, const int* idx,
                              const float* val, float* out, int M, int R,
                              int n, int kcap, int x_bf16, void* stream) {
  if (M <= 0 || R <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_sparse<__nv_bfloat16>(x, idx, val, out, M, R, n,
                                               kcap, st)
                : launch_sparse<float>(x, idx, val, out, M, R, n, kcap, st);
}

// x: [M, n] float32 or bfloat16; levels int8 [R, n] (n a multiple of 4);
// scale f32 [R]; out: [M, R] float32.
extern "C" int qs_qdq_gemm(const void* x, const int8_t* lv,
                           const float* scale, float* out, int M, int R,
                           int n, int x_bf16, void* stream) {
  if (M <= 0 || R <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_qdq<__nv_bfloat16>(x, lv, scale, out, M, R, n, st)
                : launch_qdq<float>(x, lv, scale, out, M, R, n, st);
}
