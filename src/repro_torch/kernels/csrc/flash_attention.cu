// flash_attention: causal (optionally sliding-window) GQA attention
// forward over a whole sequence (prefill).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_fwd -> _kernel).  Inputs: q [B, S, H, D]; k, v
// [B, S, KV, D], all in one type, H a multiple of KV, D one of the
// repo's head widths (16, 32, 64, 80, 112, 128, 256).  Output
// [B, S, H, D] in q's type.  Query i attends to keys j <= i, and only to
// j > i - window when window > 0.
//
// What it computes is the TPU body's arithmetic, not its block
// structure: float32 scores scaled by D^-0.5, masked scores set to the
// finite -1e30, and per query row a running max m, normaliser l and
// float32 accumulator o (online softmax):
//   m' = max(m, max_j s_j); p_j = exp(s_j - m'); alpha = exp(m - m');
//   l = l * alpha + sum_j p_j; o = o * alpha + sum_j p_j v_j;
// the output is o / max(l, 1e-30).  The finite -1e30 matters: a row
// whose first staged keys all lie outside its window accumulates exp(0)
// terms until its first live key, whose alpha = exp(-1e30 - m') = 0
// wipes them, exactly as on the TPU (-INFINITY would give NaN there).
//
// Two routes, chosen by dtype in the wrapper (kernels/flash_attention.py):
//
// bfloat16 (every card path): tensor cores.  What bounds it on an H100 is
// the bf16 tensor-core rate, 4 * D operations per live (query, key) pair
// and query head at 989 TFLOP/s: 0.0025-0.035 ms at gemma3-1b's and
// Yi-6B's prefill shapes, where the float32 FMA kernel below takes
// 0.47-1.79 ms (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).  The design:
// - S = Q K^T and O += P V on mma.sync m16n8k16 (bf16 in, float32
//   accumulate).  The scale D^-0.5 (times log2 e, for exp2) multiplies
//   the float32 scores, never bf16 q; P is cast to bf16 only as the A
//   operand of P V, the one rounding over the plain version.  Operands
//   come from shared memory by ldmatrix (V transposed by ldmatrix.trans);
//   each row of a staged tile is padded by 16 bytes, so the 8 rows one
//   ldmatrix reads fall on distinct banks.
// - GQA packing: the M dimension of a tile runs over (position, head)
//   pairs of one kv group, position-major, so a K/V tile is staged once
//   for all G query heads (gemma3-1b: 16 positions x 4 heads a 64-row
//   tile).
// - 4 warps; each owns two 16-row fragments of a 128-row tile up to
//   D = 128 (every K / V fragment it reads from shared memory feeds two
//   products) and one of a 64-row tile at D = 256 (whose accumulator is
//   D / 2 = 128 registers a thread).  A thread keeps its rows' m and l
//   and its share of the accumulator in registers.
// - K/V tiles of 64 keys double-buffered by cp.async (16-byte copies,
//   zero-filled past S): the next tile loads while this one computes.
//   Keys outside every row's window are never staged (the TPU's
//   pl.when(relevant)); a key tile inside every row's range skips the
//   per-score mask.
// - Causal balance (attention_schedule in the wrapper): blocks take the
//   longest tiles first, and without a window (every tile's keys start
//   at 0, so the longest tile would set the launch's length) the tiles
//   that see more than half the longest tile's keys are split into two
//   blocks, one per half of their key tiles; each publishes its (m, l, o)
//   and the second to finish merges them, so no block walks more than
//   about half the longest tile.  One launch still.
// mma.sync rather than wgmma: wgmma needs shared-memory descriptors for
// swizzled tile layouts and TMA tensor maps, which could not be built and
// checked against a compiler before the card calls; mma.sync runs the
// same tensor cores at a lower share of their peak (operands through
// registers, 4 warps that stall together during the softmax).  wgmma
// with a TMA-fed ring of K/V stages, a producer warp and two consumer
// warpgroups taking turns between softmax and products is the next step.
// Measured on the same card: 0.061 / 0.091 / 0.061 ms at gemma3-1b's
// windowed, global and ragged prefill, 0.20-0.22 ms at Yi-6B's heads,
// against 0.132-0.136 / 0.047-0.049 / 0.087 / 0.079 ms for
// scaled_dot_product_attention (cuDNN) (tools/bench_flash_kernels.py;
// PERF.md).
//
// float32 (the CPU-parity agreements on the card, at 1e-4): the FMA
// kernel.  TF32 would break those agreements, and full float32
// has no tensor-core path.  One block per (64-row query tile, query
// head, batch row) stages its query tile once (float32, pre-scaled) and
// walks the keys the tile can see in tiles of 32 (converted to float32 in
// shared memory); scores are float32 FMAs, 2 rows x 4 keys a thread with
// float4 loads; the online-softmax statistics of a row live in the 8
// lanes that share it; the accumulator o lives in registers.  It is
// bound by float32 operations at 67 TFLOP/s and runs one 140 KB block
// per SM at D = 256.
#include <cuda_runtime.h>

#include <cuda_bf16.h>

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

// Stage `rows` rows of D floats (row stride `stride` floats) into shared
// memory times `mul`; rows at or past `valid` are 0.
template <int D>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      long long stride, int rows, int valid,
                                      float* __restrict__ dst,
                                      int dst_stride, float mul) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[r * dst_stride + d] =
        r < valid ? src[r * stride + d] * mul : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int S, int H, int KV, int window, float scale) {
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

  stage<D>(q + q_off, q_stride, kBQ, q_rows, q_s, G::kQKStride, scale);

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
    stage<D>(k + kv_off + k0 * kv_stride, kv_stride, kBK, k_rows, k_s,
             G::kQKStride, 1.0f);
    stage<D>(v + kv_off + k0 * kv_stride, kv_stride, kBK, k_rows, v_s, D,
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
    float* dst = out + q_off + row * q_stride;
#pragma unroll
    for (int j = 0; j < G::kCols; ++j) dst[oc + G::kLanes * j] = o[i][j] / l;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int window, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * Geometry<D>::kSmemFloats;
  auto kern = flash_attention_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, KV,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int S, int H, int KV, int D, int window, float scale,
             cudaStream_t st) {
  switch (D) {
#define QS_FLASH_D(n) \
  case n:             \
    return launch<n>(q, k, v, out, B, S, H, KV, window, scale, st);
    QS_FLASH_D(16)
    QS_FLASH_D(32)
    QS_FLASH_D(64)
    QS_FLASH_D(80)
    QS_FLASH_D(112)
    QS_FLASH_D(128)
    QS_FLASH_D(256)
#undef QS_FLASH_D
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16), GQA-packed 64-row tiles
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBK = 64;        // keys per staged tile
constexpr int kNT = kBK / 8;   // score n-tiles of 8 keys
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Geometry {
  static_assert(D % 16 == 0 && D >= 16 && D <= 256, "head width");
  // 16-row fragments a warp owns: two up to D = 128, so that each K / V
  // fragment read from shared memory feeds two products; one at D = 256,
  // where the accumulator of one fragment is already D / 2 registers
  static constexpr int kRW = D <= 128 ? 2 : 1;
  static constexpr int kBM = 64 * kRW;  // packed (position, head) rows
  // bf16 elements per staged row: (D + 8) * 2 bytes is an odd multiple
  // of 16, so the 8 rows of one ldmatrix hit 8 distinct bank groups
  static constexpr int kStride = D + 8;
  static constexpr int kKV = kBK * kStride;    // one K or V stage
  static constexpr int kChunks = D / 8;        // 16-byte chunks in a row
  // Q, then two stages of K, then two of V
  static constexpr int kSmemBytes = (kBM * kStride + 4 * kKV) * 2;
  // floats of one half of a split tile's state: per thread its rows' m
  // and l and its accumulator values, value-major ([value][thread])
  static constexpr int kHalfFloats = kRW * (D / 2 + 4) * kThreads;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-filled (nothing read) unless `full`
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col): bf16 operands, float32 sums
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// stage kBK keys from k0 (one kv head; rows past S zero-filled)
template <int D>
__device__ __forceinline__ void stage_kv(const __nv_bfloat16* __restrict__ src,
                                         long long stride, int k0, int S,
                                         __nv_bfloat16* dst) {
  using Geo = Geometry<D>;
  for (int c = threadIdx.x; c < kBK * Geo::kChunks; c += kThreads) {
    const int r = c / Geo::kChunks, ch = c % Geo::kChunks;
    const bool ok = k0 + r < S;
    const __nv_bfloat16* from =
        ok ? src + (k0 + r) * stride + ch * 8 : src;
    cp_async16(smem_addr(dst + r * Geo::kStride + ch * 8), from, ok);
  }
}

// One tile of kBM packed (position, head) rows R0 .. R0 + kBM - 1 of kv
// head `kvh` (row R: position R / G, head kvh * G + R % G); warp w owns
// the 16-row fragments at rows 64 f + 16 w, f < kRW.  half < 0: all the
// keys the tile sees.  half = 0 / 1: the first / second half of its key
// tiles; each half publishes its (m, l, o) to `scratch` (two halves' room)
// and takes a ticket, and the second to finish merges the other's state
// into its own (log-sum-exp rescaling), writes the tile and resets the
// ticket to 0.
template <int D>
__device__ __forceinline__ void attend_tile(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    __nv_bfloat16* smem, int b, int kvh, int R0, int S, int H, int KV,
    int window, float scale_log2, int half = -1, float* scratch = nullptr,
    int* ticket = nullptr) {
  using Geo = Geometry<D>;
  constexpr int kRW = Geo::kRW, kBM = Geo::kBM;
  constexpr int kNO = D / 8;  // accumulator n-tiles of 8 columns
  __nv_bfloat16* q_s = smem;
  __nv_bfloat16* k_s = q_s + kBM * Geo::kStride;  // 2 stages
  __nv_bfloat16* v_s = k_s + 2 * Geo::kKV;        // 2 stages
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KV) * D;
  const __nv_bfloat16* q_b = q + static_cast<long long>(b) * S * q_stride +
                             static_cast<long long>(kvh) * G * D;
  __nv_bfloat16* out_b = out + static_cast<long long>(b) * S * q_stride +
                         static_cast<long long>(kvh) * G * D;
  const __nv_bfloat16* k_b = k + static_cast<long long>(b) * S * kv_stride +
                             static_cast<long long>(kvh) * D;
  const __nv_bfloat16* v_b = v + static_cast<long long>(b) * S * kv_stride +
                             static_cast<long long>(kvh) * D;

  // keys the tile can see: from the first position's window start to the
  // last position (causal)
  const int pos_first = R0 / G;
  const int pos_last = min(S - 1, (R0 + kBM - 1) / G);
  const int k_begin =
      (window > 0 ? max(0, pos_first - window + 1) : 0) / kBK * kBK;
  const int n_kt = (pos_last - k_begin) / kBK + 1;
  const int j_begin = half == 1 ? n_kt / 2 : 0;
  const int j_end = half == 0 ? n_kt / 2 : n_kt;

  for (int c = tid; c < kBM * Geo::kChunks; c += kThreads) {
    const int r = c / Geo::kChunks, ch = c % Geo::kChunks;
    const int R = R0 + r, pos = R / G;
    const bool ok = pos < S;
    const __nv_bfloat16* from =
        ok ? q_b + pos * q_stride + (R % G) * D + ch * 8 : q_b;
    cp_async16(smem_addr(q_s + r * Geo::kStride + ch * 8), from, ok);
  }
  stage_kv<D>(k_b, kv_stride, k_begin + j_begin * kBK, S, k_s);
  stage_kv<D>(v_b, kv_stride, k_begin + j_begin * kBK, S, v_s);
  cp_async_commit();

  // this thread's rows: fragment f, half h (rows +0 / +8 of the fragment)
  int row[kRW][2], pos[kRW][2];
  float m[kRW][2], l[kRW][2], o[kRW][kNO][4];
#pragma unroll
  for (int f = 0; f < kRW; ++f) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[f][h] = 64 * f + 16 * warp + (lane >> 2) + 8 * h;
      pos[f][h] = (R0 + row[f][h]) / G;
      m[f][h] = -1e30f;
      l[f][h] = 0.0f;
    }
#pragma unroll
    for (int jo = 0; jo < kNO; ++jo)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[f][jo][e] = 0.0f;
  }

  // ldmatrix row addresses of this lane: A (Q) rows lane % 16, column
  // half lane / 16; B (K) keys lane % 8 + 8 (lane / 16), column half
  // (lane / 8) % 2; V (transposed) keys lane % 8 + 8 ((lane / 8) % 2),
  // column half lane / 16
  const uint32_t q_lane = smem_addr(q_s + (16 * warp + (lane & 15)) *
                                              Geo::kStride +
                                    (lane >> 4) * 8);
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = k_begin + j * kBK;
    const int stage = (j - j_begin) & 1;
    if (j + 1 < j_end) {
      stage_kv<D>(k_b, kv_stride, k0 + kBK, S, k_s + (stage ^ 1) * Geo::kKV);
      stage_kv<D>(v_b, kv_stride, k0 + kBK, S, v_s + (stage ^ 1) * Geo::kKV);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: this stage is in
    __syncthreads();

    const __nv_bfloat16* ks = k_s + stage * Geo::kKV;
    const __nv_bfloat16* vs = v_s + stage * Geo::kKV;
    float s[kRW][kNT][4];
#pragma unroll
    for (int f = 0; f < kRW; ++f)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[f][n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[kRW][4];
#pragma unroll
      for (int f = 0; f < kRW; ++f)
        ldsm_x4(a[f], q_lane + (64 * f * Geo::kStride + kk * 16) * 2);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, smem_addr(ks + (np * 16 + k_row) * Geo::kStride +
                              kk * 16 + k_col));
#pragma unroll
        for (int f = 0; f < kRW; ++f) {
          mma16816(s[f][2 * np], a[f], bb[0], bb[1]);
          mma16816(s[f][2 * np + 1], a[f], bb[2], bb[3]);
        }
      }
    }

    // mask (where some key of the tile is outside some row's range), then
    // the online softmax of each row (the 4 lanes of a quad hold one
    // row's 64 scores)
    const bool all_live = k0 + kBK - 1 <= pos_first &&
                          (window <= 0 || k0 > pos_last - window);
#pragma unroll
    for (int f = 0; f < kRW; ++f) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = pos[f][h];
        float mx = m[f][h];
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + n * 8 + 2 * (lane & 3) + e;
            const bool live =
                all_live || (key <= p && (window <= 0 || key > p - window));
            float& x = s[f][n][2 * h + e];
            x = live ? x * scale_log2 : -1e30f;
            mx = fmaxf(mx, x);
          }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(qs::FULL, mx, off));
        const float alpha = exp2f(m[f][h] - mx);
        m[f][h] = mx;
        float sum = 0.0f;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[f][n][2 * h + e];
            x = exp2f(x - mx);
            sum += x;
          }
        }
        l[f][h] = l[f][h] * alpha + sum;  // this lane's share of the row
#pragma unroll
        for (int jo = 0; jo < kNO; ++jo) {
          o[f][jo][2 * h] *= alpha;
          o[f][jo][2 * h + 1] *= alpha;
        }
      }
    }

    // O += P V: the score fragments of keys 16 kk .. 16 kk + 15 are the A
    // operand as they lie (cast to bf16 here, the one extra rounding)
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[kRW][4];
#pragma unroll
      for (int f = 0; f < kRW; ++f) {
        a[f][0] = pack_bf16(s[f][2 * kk][0], s[f][2 * kk][1]);
        a[f][1] = pack_bf16(s[f][2 * kk][2], s[f][2 * kk][3]);
        a[f][2] = pack_bf16(s[f][2 * kk + 1][0], s[f][2 * kk + 1][1]);
        a[f][3] = pack_bf16(s[f][2 * kk + 1][2], s[f][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, smem_addr(vs + (kk * 16 + v_row) * Geo::kStride +
                                    dp * 16 + v_col));
#pragma unroll
        for (int f = 0; f < kRW; ++f) {
          mma16816(o[f][2 * dp], a[f], bb[0], bb[1]);
          mma16816(o[f][2 * dp + 1], a[f], bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int f = 0; f < kRW; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        l[f][h] += __shfl_xor_sync(qs::FULL, l[f][h], off);
  if (half >= 0) {
    // publish this half's state, coalesced: value i of thread t at
    // [i * kThreads + t]
    float* mine = scratch + half * Geo::kHalfFloats + tid;
    float* other = scratch + (1 - half) * Geo::kHalfFloats + tid;
#pragma unroll
    for (int f = 0; f < kRW; ++f) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mine[(4 * f + h) * kThreads] = m[f][h];
        mine[(4 * f + 2 + h) * kThreads] = l[f][h];
      }
#pragma unroll
      for (int jo = 0; jo < kNO; ++jo)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine[(4 * kRW + (f * kNO + jo) * 4 + e) * kThreads] = o[f][jo][e];
    }
    __threadfence();
    __syncthreads();
    __shared__ int last_s;
    if (tid == 0) last_s = atomicAdd(ticket, 1) == 1;
    __syncthreads();
    if (!last_s) return;
    __threadfence();
#pragma unroll
    for (int f = 0; f < kRW; ++f) {
      float a[2], c[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mo = __ldcg(other + (4 * f + h) * kThreads);
        const float mx = fmaxf(m[f][h], mo);
        a[h] = exp2f(m[f][h] - mx);
        c[h] = exp2f(mo - mx);
        l[f][h] = l[f][h] * a[h] +
                  __ldcg(other + (4 * f + 2 + h) * kThreads) * c[h];
      }
#pragma unroll
      for (int jo = 0; jo < kNO; ++jo)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[f][jo][e] = o[f][jo][e] * a[e / 2] +
                        __ldcg(other + (4 * kRW + (f * kNO + jo) * 4 + e) *
                                           kThreads) *
                            c[e / 2];
    }
    if (tid == 0) *ticket = 0;
  }
  // the output tile goes through q_s (free now) for 16-byte stores
#pragma unroll
  for (int f = 0; f < kRW; ++f) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float den = fmaxf(l[f][h], 1e-30f);
#pragma unroll
      for (int jo = 0; jo < kNO; ++jo)
        *reinterpret_cast<__nv_bfloat162*>(
            q_s + row[f][h] * Geo::kStride + jo * 8 + 2 * (lane & 3)) =
            __floats2bfloat162_rn(o[f][jo][2 * h] / den,
                                  o[f][jo][2 * h + 1] / den);
    }
  }
  __syncthreads();
  for (int c = tid; c < kBM * Geo::kChunks; c += kThreads) {
    const int r = c / Geo::kChunks, ch = c % Geo::kChunks;
    const int R = R0 + r, p = R / G;
    if (p < S)
      *reinterpret_cast<uint4*>(out_b + p * q_stride + (R % G) * D +
                                ch * 8) =
          *reinterpret_cast<const uint4*>(q_s + r * Geo::kStride + ch * 8);
  }
  __syncthreads();  // q_s is free for the next tile
}

// grid (work items, KV, B): the n_split longest tiles are split in two
// halves of their key tiles, items 2i and 2i+1 taking the halves of tile
// n-1-i; the rest take one tile each, the longest first.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ scratch,
                          int* __restrict__ tickets, int S, int H, int KV,
                          int window, float scale_log2, int n_tiles,
                          int n_split) {
  constexpr int kBM = Geometry<D>::kBM;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int item = blockIdx.x;
  if (item < 2 * n_split) {
    const long long unit =
        (static_cast<long long>(b) * KV + kvh) * n_split + item / 2;
    attend_tile<D>(q, k, v, out, smem, b, kvh, (n_tiles - 1 - item / 2) * kBM,
                   S, H, KV, window, scale_log2, item & 1,
                   scratch + unit * 2 * Geometry<D>::kHalfFloats,
                   tickets + unit);
    return;
  }
  attend_tile<D>(q, k, v, out, smem, b, kvh,
                 (n_tiles - 1 - (item - n_split)) * kBM, S, H, KV, window,
                 scale_log2);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* scratch, int* tickets, int B, int S, int H, int KV,
           int window, float scale, int n_split, cudaStream_t st) {
  constexpr int smem = Geometry<D>::kSmemBytes;
  auto kern = flash_attention_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = H / KV;
  const long long rows = static_cast<long long>(S) * G;
  constexpr int kBM = Geometry<D>::kBM;
  const int n_tiles = static_cast<int>((rows + kBM - 1) / kBM);
  if (n_split < 0 || n_split > n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_tiles + n_split, KV, B);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), scratch, tickets, S, H, KV, window,
      scale * kLog2e, n_tiles, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace

// float32: q [B, S, H, D], k / v [B, S, KV, D], out [B, S, H, D]; D one
// of 16, 32, 64, 80, 112, 128, 256; window <= 0 = causal.  The FMA kernel.
extern "C" int qs_flash_attention(const void* q, const void* k,
                                  const void* v, void* out, int B, int S,
                                  int H, int KV, int D, int window,
                                  float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  return launch_d(q, k, v, out, B, S, H, KV, D, window, scale,
                  static_cast<cudaStream_t>(stream));
}

// bfloat16, the same layout: the tensor-core kernel.  n_split > 0
// (causal) splits the n_split longest tiles' keys in two halves, with
// scratch of B * KV * n_split times the geometry's scratch floats and
// B * KV * n_split zeroed int32 tickets (the kernel leaves them zero).
extern "C" int qs_flash_attention_bf16(const void* q, const void* k,
                                       const void* v, void* out,
                                       float* scratch, int* tickets, int B,
                                       int S, int H, int KV, int D,
                                       int window, float scale, int n_split,
                                       void* stream) {
  if (B <= 0 || S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define QS_FLASH_TC_D(n) \
  case n:                \
    return tc::launch<n>(q, k, v, out, scratch, tickets, B, S, H, KV, \
                         window, scale, n_split, st);
    QS_FLASH_TC_D(16)
    QS_FLASH_TC_D(32)
    QS_FLASH_TC_D(64)
    QS_FLASH_TC_D(80)
    QS_FLASH_TC_D(112)
    QS_FLASH_TC_D(128)
    QS_FLASH_TC_D(256)
#undef QS_FLASH_TC_D
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tensor-core kernel's geometry at head width D, which the wrapper
// sizes its schedule, scratch and shared-memory check by: geo[0] packed
// rows a tile, geo[1] keys a staged K / V tile, geo[2] dynamic shared
// memory of a block in bytes, geo[3] scratch floats of one split tile.
extern "C" int qs_flash_attention_bf16_geometry(int D, int* geo) {
  switch (D) {
#define QS_FLASH_TC_GEO(n)                                \
  case n:                                                 \
    geo[0] = tc::Geometry<n>::kBM;                        \
    geo[1] = tc::kBK;                                     \
    geo[2] = tc::Geometry<n>::kSmemBytes;                 \
    geo[3] = 2 * tc::Geometry<n>::kHalfFloats;            \
    return 0;
    QS_FLASH_TC_GEO(16)
    QS_FLASH_TC_GEO(32)
    QS_FLASH_TC_GEO(64)
    QS_FLASH_TC_GEO(80)
    QS_FLASH_TC_GEO(112)
    QS_FLASH_TC_GEO(128)
    QS_FLASH_TC_GEO(256)
#undef QS_FLASH_TC_GEO
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
