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
// Three kernels, picked inside the one launch:
//
// * Decode batches, M <= kDecodeMaxM = 8 where x fits a block's shared
//   memory (every serving shape in bfloat16): one block a SM stages all of
//   x once, transposed into records of a column's activation rows (16
//   bytes at M = 8 in bfloat16), so a live slot costs one shared-memory
//   read where it cost M scattered gathers.  A warp walks a batch of 2-4
//   output rows of its block's contiguous range 32 slots a round, without
//   a branch; up to two rounds of the next batch load while this one is
//   summed (as many as it walked), and rows still walking load further
//   rounds together.  A row stops in the round that holds its first
//   sentinel.  The batch's partial sums leave by one reduce-scatter
//   across the warp.  What bounds it: the live (idx, val) slots (8 bytes
//   a slot) and the latency of their loads, one a batch, and staging,
//   which reads all of x from L2 in every block (PERF.md).
// * Other batches below the tiled kernel's M (the warp-per-row kernel):
//   one warp owns one output row r; its lanes hold the row's live slots 32
//   at a time, gather x[m, idx] from L1/L2 and reduce each lane's partial
//   sums across the warp.  A row stops at the first 32 slots that are all
//   sentinels.
// * Prefill widths: a block owns kTileM = 128 activation rows and a slab of
//   128 or 256 output rows (16 or 32 warps of kTileRowsPerWarp rows).  It
//   walks x in chunks of 64 KB: a chunk lands row-major in shared memory by
//   cp.async (coalesced, in flight while the previous chunk is computed)
//   and is transposed to column-major words (xs[c][m]), so each staged
//   element serves every row of the slab that touches it.  Lane l holds
//   activation rows l, l + 32, l + 64, l + 96 and a warp owns its output
//   rows: for each live slot it reads one uniform (idx, val) pair and its
//   four x values, all conflict-free.  Indices ascend, so a row's slots
//   inside a chunk are one run: each row keeps a cursor and a batch of 32
//   slots in shared memory, counts the batch's slots below the chunk's end
//   with one ballot, and stops at its first sentinel.  The output tile
//   leaves through shared memory, stored coalesced along r.  What bounds
//   it: the L2 reads of x, (R / slab) * M * n elements, and the shared-
//   memory reads, FMAs and bookkeeping of each (slot, activation row) and
//   (row, chunk).  No tensor cores: the weights are about 1 % dense, so a
//   densified tile would waste 99 % of the MMA work, and val is float32,
//   which bf16 or TF32 operands would round.  Each output is summed over
//   its slots in ascending order (ref.sparse_gemm_tiled_ref models the
//   tiled walk).
//
// qdq_gemm: y = x @ (levels * scale).T over int8 QSGD levels [R, n] and
// a per-row f32 scale [R, 1].  The scale is folded out of the row's sum,
// y[m, r] = scale[r] * sum_c x[m, c] * levels[r, c], which changes only
// the rounding (ref.qdq_gemm_factored_ref).  It is bound by the bytes of
// the levels (Yi-6B's head: 64000 x 4096 int8, 262 MB), read once for
// every 8 activation rows.  Levels become floats by a byte permute and
// one subtract (I2F runs at a quarter of the FMA rate).  Two kernels:
//
// * bfloat16 x, 2 <= M, rows a multiple of 64 (qdq_mma_kernel): 16 weight
//   rows are the A side of mma.sync m16n8k16 and 8 activation rows the n
//   side, so M = 2 .. 8 cost one pass over the levels and no more FMAs
//   than M = 1.  The sum of each 256 columns leaves the tensor cores and
//   is added in IEEE float32: summed whole there, Yi-6B-wide rows of 11008
//   lost 1.3e-5 of the largest output, past the 1e-5 the kernel is held
//   to (PERF.md).
// * Otherwise (qdq_gemm_kernel): templated on the activation rows a pass
//   has (1, 2, 4 or 8; passes of 8 beyond); each block stages its pass's
//   rows of x once, as float32, and its warps stream the levels kQdqRows
//   rows at a time, 16 levels a lane, copied by cp.async into a per-warp
//   double buffer, so each x value read from shared memory serves
//   kQdqRows weight rows.  Rows whose length is not a multiple of 16,
//   level pointers not 16-byte aligned and the tail of a row past its
//   last 512-column block take 4-byte loads.  A warp's partial sums leave
//   through a reduce-scatter across its lanes, one output per lane.
//
// Both walk the rows in a grid of one wave of blocks, each with the same
// number of row groups, so x is staged once per block.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

// Reduce-scatter of a lane's C values over the warp's lanes, halving the
// values kept at each of the offsets O, O / 2, .., 1 while more than one
// is left (then plain butterfly adds).  Afterwards a[0 .. max(C / 32, 1))
// hold the warp's sums of values base, base + 1, ..
template <int C, int O, int V>
__device__ __forceinline__ void reduce_scatter(float (&a)[V], int lane,
                                               int& base) {
  if constexpr (O > 0) {
    if constexpr (C > 1) {
      constexpr int h = C / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float send = up ? a[i] : a[i + h];
        const float keep = up ? a[i + h] : a[i];
        a[i] = keep + __shfl_xor_sync(qs::FULL, send, O);
      }
      if (up) base += h;
      reduce_scatter<h, O / 2>(a, lane, base);
    } else {
      a[0] += __shfl_xor_sync(qs::FULL, a[0], O);
      reduce_scatter<1, O / 2>(a, lane, base);
    }
  }
}

// 16-byte copies from device to shared memory that do not wait
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// as cp_async16, reading `bytes` (16 or 0: zeros) from src
__device__ __forceinline__ void cp_async16_fill(void* dst, const void* src,
                                                int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

// ---------------------------------------------------------------------------
// sparse_gemm at decode widths: x staged once a block, a column a record
// ---------------------------------------------------------------------------

constexpr int kDecodeMaxM = 8;        // activation rows the kernel takes
constexpr int kDecodeWarps = 16;      // a block: one a SM
constexpr int kDecodeSmem = 232448;   // staged x may fill a block's 227 KB

// 2..32 bytes as one shared-memory access (two for 32)
template <int B>
struct VecOf;
template <>
struct VecOf<2> { using type = uint16_t; };
template <>
struct VecOf<4> { using type = uint32_t; };
template <>
struct VecOf<8> { using type = uint2; };
template <>
struct VecOf<16> { using type = uint4; };
struct alignas(16) Uint4x2 { uint4 a, b; };
template <>
struct VecOf<32> { using type = Uint4x2; };

// x staged as records: column c's MP activation rows (rows past M are
// zeros) side by side in raw storage U (bfloat16 bits or float32), so a
// live slot reads its column's MP values in one shared-memory access.
// Staging reads x row by row, 16 bytes (kVC columns) a thread, and writes
// kVC records; record c sits at c ^ ((c / kVC) % kVC), so the kVC records
// one thread writes at a time fall in different bank groups across the
// quarter-warp.  A warp walks kRB output rows at once: kRB * MP sums a
// lane (16 from 4 activation rows up), reduce-scattered across the warp.
template <typename U, int MP>
struct Decode {
  static constexpr int kBytes = MP * static_cast<int>(sizeof(U));
  using Vec = typename VecOf<kBytes>::type;
  union Rec {
    Vec w;
    U v[MP];
  };
  static constexpr int kVC = 16 / static_cast<int>(sizeof(U));
  static constexpr int kRB = MP >= 4 ? 16 / MP : 4;  // output rows a batch
  static constexpr int kNV = kRB * MP;               // sums a lane
  __device__ __forceinline__ static int at(int c) {
    return c ^ ((c / kVC) & (kVC - 1));
  }
};

// rounds of 32 slots of a batch's rows in flight at most
constexpr int kDecodeDepth = 2;

// word s / element j of 16 bytes (of bfloat16 bits / float32)
__device__ __forceinline__ uint32_t word_of(const uint4& v, int s) {
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}
__device__ __forceinline__ uint16_t elem_of(const uint4& r, int j,
                                            uint16_t) {
  return static_cast<uint16_t>(word_of(r, j >> 1) >> (16 * (j & 1)));
}
__device__ __forceinline__ float elem_of(const uint4& r, int j, float) {
  return __uint_as_float(word_of(r, j));
}

__device__ __forceinline__ float u_to_f32(uint16_t u) {
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}
__device__ __forceinline__ float u_to_f32(float u) { return u; }

// Shared memory of the decode kernel: x as records, whole 16-byte groups
// of columns.
__host__ __device__ inline long long decode_records(int n, int vc) {
  return (static_cast<long long>(n) + vc - 1) / vc * vc;
}
__host__ __device__ inline long long decode_x_bytes(int n, int mp,
                                                    int x_bytes) {
  return decode_records(n, 16 / x_bytes) * mp * x_bytes;
}

template <typename U, int MP>
__global__ void __launch_bounds__(kDecodeWarps * 32, 1)
sparse_gemm_decode_kernel(const U* __restrict__ x, const int* __restrict__ idx,
                          const float* __restrict__ val,
                          float* __restrict__ out, int M, int R, int n,
                          int kcap, int rows_per_block, int vec) {
  using D = Decode<U, MP>;
  using Vec = typename D::Vec;
  using Rec = typename D::Rec;
  constexpr int kRB = D::kRB, kNV = D::kNV, kVC = D::kVC;
  constexpr int kD = kDecodeDepth;
  constexpr unsigned kAll = (1u << kRB) - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  Vec* xs = reinterpret_cast<Vec*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r_beg = blockIdx.x * rows_per_block;
  const int r_end = min(R, r_beg + rows_per_block);
  const int batches = max(0, (r_end - r_beg + kRB - 1) / kRB);

  // Slot 32 j + lane of row i of batch q where row i is in `rows` (else,
  // past r_end and past kcap: the sentinel n).
  auto load = [&](int& c, float& v, int q, int i, int j, unsigned rows) {
    const int r = r_beg + q * kRB + i, s = 32 * j + lane;
    c = n;
    v = 0.0f;
    if (((rows >> i) & 1u) && r < r_end && s < kcap) {
      const long long o = static_cast<long long>(r) * kcap + s;
      c = __ldg(idx + o);
      v = __ldg(val + o);
    }
  };
  // cc[j] / cn[j] hold round j of every row of this batch / the next.
  // `depth` rounds of the next batch load while this one is summed: as
  // many as the last batch's rows walked, up to kD (the rows of one
  // matrix have one k).
  int cc[kD][kRB], cn[kD][kRB];
  float vc[kD][kRB], vn[kD][kRB];
  int depth = 1;
#pragma unroll
  for (int i = 0; i < kRB; ++i) load(cn[0][i], vn[0][i], warp, i, 0, kAll);

  // Stage x.  The first batch's first round lands while the first loads
  // of x are in flight; rows it fills load their second round before
  // anything waits on x.
  bool first = true;
  auto second_round = [&]() {
    if (!first) return;
    first = false;
    unsigned full = 0;
#pragma unroll
    for (int i = 0; i < kRB; ++i)
      full |= (__all_sync(qs::FULL, cn[0][i] >= 0 && cn[0][i] < n) ? 1u : 0u)
              << i;
    if (full && kcap > 32) {
      depth = 2;
#pragma unroll
      for (int i = 0; i < kRB; ++i) load(cn[1][i], vn[1][i], warp, i, 1, full);
    }
  };
  if (vec) {
    const long long groups = decode_records(n, kVC) / kVC;
    for (long long g0 = 0; g0 < groups; g0 += blockDim.x) {
      const long long g = g0 + threadIdx.x;
      uint4 row[MP];
#pragma unroll
      for (int m = 0; m < MP; ++m)
        row[m] = m < M && g < groups
                     ? __ldg(reinterpret_cast<const uint4*>(
                                 x + static_cast<long long>(m) * n) + g)
                     : make_uint4(0, 0, 0, 0);
      second_round();
      if (g < groups) {
#pragma unroll
        for (int j = 0; j < kVC; ++j) {
          Rec rec;
#pragma unroll
          for (int m = 0; m < MP; ++m) rec.v[m] = elem_of(row[m], j, U());
          xs[D::at(static_cast<int>(g) * kVC + j)] = rec.w;
        }
      }
    }
  } else {
    for (int col = threadIdx.x; col < n; col += blockDim.x) {
      Rec rec;
#pragma unroll
      for (int m = 0; m < MP; ++m)
        rec.v[m] = m < M ? x[static_cast<long long>(m) * n + col] : U(0);
      xs[D::at(col)] = rec.w;
    }
  }
  second_round();
  __syncthreads();

  int ahead = depth;  // rounds of the batch in cn in flight
  for (int q = warp; q < batches; q += kDecodeWarps) {
    const int now = ahead;
#pragma unroll
    for (int j = 0; j < kD; ++j)
#pragma unroll
      for (int i = 0; i < kRB; ++i) {
        cc[j][i] = cn[j][i];
        vc[j][i] = vn[j][i];
      }
    const bool more = q + kDecodeWarps < batches;
    auto prefetch = [&](int from, int to) {
#pragma unroll
      for (int j = 0; j < kD; ++j)
        if (more && j >= from && j < to) {
#pragma unroll
          for (int i = 0; i < kRB; ++i)
            load(cn[j][i], vn[j][i], q + kDecodeWarps, i, j, kAll);
        }
    };
    prefetch(0, depth);
    ahead = depth;
    float acc[kNV];
#pragma unroll
    for (int t = 0; t < kNV; ++t) acc[t] = 0.0f;
    // Rows walk 32 slots a round; a row stops in the round that holds its
    // first sentinel (an index outside [0, n)), whose later slots are not
    // added.  Each step runs for all the batch's rows at once (they are
    // independent) and without a branch: slots not taken read record 0
    // and add nothing.  Rounds not in flight load for the rows walking.
    unsigned walking = kAll;
    int rounds = 0;
    auto walk = [&](const int (&c)[kRB], const float (&v)[kRB]) {
      unsigned stop[kRB];
#pragma unroll
      for (int i = 0; i < kRB; ++i)
        stop[i] = __ballot_sync(qs::FULL, !(c[i] >= 0 && c[i] < n) ||
                                              !((walking >> i) & 1u));
#pragma unroll
      for (int i = 0; i < kRB; ++i) {
        const bool take =
            stop[i] ? lane < __ffs(static_cast<int>(stop[i])) - 1 : true;
        Rec rec;
        rec.w = xs[D::at(take ? c[i] : 0)];
#pragma unroll
        for (int m = 0; m < MP; ++m) {
          const float f = fmaf(v[i], u_to_f32(rec.v[m]), acc[m * kRB + i]);
          acc[m * kRB + i] = take ? f : acc[m * kRB + i];
        }
      }
#pragma unroll
      for (int i = 0; i < kRB; ++i)
        if (stop[i]) walking &= ~(1u << i);
      ++rounds;
    };
#pragma unroll
    for (int j = 0; j < kD; ++j) {
      if (!walking || 32 * j >= kcap) break;
      if (j >= now) {
#pragma unroll
        for (int i = 0; i < kRB; ++i)
          load(cc[j][i], vc[j][i], q, i, j, walking);
      }
      walk(cc[j], vc[j]);
    }
    for (int j = kD; walking && 32 * j < kcap; ++j) {
      int c[kRB];
      float v[kRB];
#pragma unroll
      for (int i = 0; i < kRB; ++i) load(c[i], v[i], q, i, j, walking);
      walk(c, v);
    }
    // as many rounds of the next batch in flight as this one walked
    depth = min(max(rounds, 1), kD);
    if (depth > ahead) {
      prefetch(ahead, depth);
      ahead = depth;
    }
    // sums: value t = m * kRB + i is activation row m of batch row i
    int base = 0;
    reduce_scatter<kNV, 16>(acc, lane, base);
    constexpr int kKept = kNV >= 32 ? kNV / 32 : 1;
    if (kNV >= 32 || (lane & (32 / kNV - 1)) == 0) {
#pragma unroll
      for (int t = 0; t < kKept; ++t) {
        const int m = (base + t) / kRB;
        const int r = r_beg + q * kRB + (base + t) % kRB;
        if (m < M && r < r_end) out[static_cast<long long>(m) * R + r] = acc[t];
      }
    }
  }
}

// Blocks of the decode kernel and rows a block: one block a SM, but no
// more than give each warp a batch of output rows (every block stages the
// whole of x, so blocks beyond that only add L2 reads).
void decode_grid(int R, int rb, int sms, int& blocks, int& rows) {
  const int per_round = kDecodeWarps * rb;
  const int want = (R + per_round - 1) / per_round;
  blocks = want < sms ? want : sms;
  if (blocks < 1) blocks = 1;
  rows = (R + blocks - 1) / blocks;
}

// activation rows a record holds: M rounded up to a power of two
inline int decode_rows(int M) { return M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8; }

int sm_count();

template <typename U, int MP>
int launch_decode_mp(const void* x, const int* idx, const float* val,
                     float* out, int M, int R, int n, int kcap,
                     cudaStream_t st) {
  auto kern = sparse_gemm_decode_kernel<U, MP>;
  const long long smem = decode_x_bytes(n, MP, sizeof(U));
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0, rows = 0;
  decode_grid(R, Decode<U, MP>::kRB, sm_count(), blocks, rows);
  const int vec = n % Decode<U, MP>::kVC == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  kern<<<blocks, kDecodeWarps * 32, static_cast<size_t>(smem), st>>>(
      static_cast<const U*>(x), idx, val, out, M, R, n, kcap, rows, vec);
  return static_cast<int>(cudaGetLastError());
}

// whether the decode kernel takes [M, n] x of x_bytes an element
bool decode_fits(int M, int n, int x_bytes) {
  return M >= 1 && M <= kDecodeMaxM &&
         decode_x_bytes(n, decode_rows(M), x_bytes) <= kDecodeSmem;
}

template <typename U>
int launch_decode(const void* x, const int* idx, const float* val,
                  float* out, int M, int R, int n, int kcap,
                  cudaStream_t st) {
  switch (decode_rows(M)) {
    case 1:
      return launch_decode_mp<U, 1>(x, idx, val, out, M, R, n, kcap, st);
    case 2:
      return launch_decode_mp<U, 2>(x, idx, val, out, M, R, n, kcap, st);
    case 4:
      return launch_decode_mp<U, 4>(x, idx, val, out, M, R, n, kcap, st);
    default:
      return launch_decode_mp<U, 8>(x, idx, val, out, M, R, n, kcap, st);
  }
}

// ---------------------------------------------------------------------------
// sparse_gemm at prefill widths: the tiled kernel
// ---------------------------------------------------------------------------

// Where the tiled kernel wins.  Below 128 activation rows its time hardly
// moves with M (a block stages and walks a whole 128-row tile), while the
// warp-per-row kernel's grows with M: on an NVIDIA H100 80GB HBM3 at 700 W
// the tiled one won from M = 48 at 6912 x 1152 (R x n) and from M = 64 at
// 11008 x 4096, but lost up to M = 128 at 1152 x 6912 and 4096 x 11008,
// where its 128-row slabs make 9 and 32 blocks.  So it takes M >=
// kTiledMinM only where those blocks fill a third of the SMs, and every M
// >= kTiledAlwaysM.
constexpr int kTiledMinM = 48;
constexpr int kTiledAlwaysM = 256;
constexpr int kTileM = 128;           // activation rows a block
constexpr int kTileRowsPerWarp = 8;   // output rows a warp owns
constexpr int kTileXBytes = 65536;    // one staged chunk of x
// the staged chunk and the landing chunk (then half the out tile)
constexpr int kTileRegion = 2 * kTileXBytes;

// A block of W warps: kR output rows; after the chunk region, the rows'
// slot batches and their cursors.
template <int W>
struct TileShape {
  static constexpr int kR = W * kTileRowsPerWarp;
  static constexpr int kOutStride = kR + 1;  // floats a row of the out tile
  static constexpr int kSmem = kTileRegion + kR * 32 * 8 + 2 * kR * 4;
  static_assert(64 * kOutStride * 4 <= kTileRegion, "out tile fits");
};

// A chunk of x lands row-major in `land`: row mm's 16-byte unit u (columns
// kVec u ..) at mm * 32 + (u ^ (mm & 7)), so that 8 consecutive rows' units
// fall in 8 different bank groups.  It is then stored in `xs` as 32-bit
// words of raw storage: a word holds two bfloat16 activation rows (l + 64 w
// and l + 64 w + 32 in plane w) or one float32 row (l + 32 w).  Staged
// column c is kWords words; lane l's rows at c are words l + 32 w, so every
// read and write of a warp is conflict-free.
template <typename U>
struct Tile {
  static constexpr int kPerWord = 4 / sizeof(U);          // rows a word
  static constexpr int kWords = kTileM / kPerWord;         // words a column
  static constexpr int kPlanes = kWords / 32;              // words a lane
  static constexpr int kCols = kTileXBytes / (kWords * 4);  // a chunk
  static constexpr int kVec = 16 / sizeof(U);  // columns a 16-byte unit
  static_assert(kCols / kVec == 32, "a landed row is 32 units");
};

// the lane's four activation rows (l, l + 32, l + 64, l + 96) at staged
// column c, as floats
__device__ __forceinline__ void tile_x4(const uint32_t* xs, int c, int lane,
                                        float (&f)[4], uint16_t) {
  const uint32_t* w = xs + c * Tile<uint16_t>::kWords + lane;
  const uint32_t a = w[0], b = w[32];
  f[0] = __uint_as_float(a << 16);
  f[1] = __uint_as_float(a & 0xffff0000u);
  f[2] = __uint_as_float(b << 16);
  f[3] = __uint_as_float(b & 0xffff0000u);
}
__device__ __forceinline__ void tile_x4(const uint32_t* xs, int c, int lane,
                                        float (&f)[4], uint32_t) {
  const uint32_t* w = xs + c * Tile<uint32_t>::kWords + lane;
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = __uint_as_float(w[32 * j]);
}

// Start copying columns [c0, c1) of activation rows [m0, m0 + kTileM) into
// `land` (zeros past M and past c1).  `vec`: rows a multiple of 16 bytes
// apart and x 16-byte aligned; otherwise the units are loaded element by
// element (and have landed when this returns).
template <typename U>
__device__ __forceinline__ void tile_issue(uint4* land,
                                           const U* __restrict__ x, int M,
                                           int n, int m0, int c0, int c1,
                                           bool vec) {
  constexpr int kV = Tile<U>::kVec;
  for (int e = threadIdx.x; e < kTileM * 32; e += blockDim.x) {
    const int mm = e >> 5, u = e & 31;
    const int m = m0 + mm, c = c0 + u * kV;
    uint4* dst = land + mm * 32 + (u ^ (mm & 7));
    const U* src = x + static_cast<long long>(m) * n + c;
    if (vec) {
      const bool in = m < M && c < c1;
      cp_async16_fill(dst, in ? src : x, in ? 16 : 0);
    } else {
      union {
        uint4 w;
        U u[kV];
      } t;
#pragma unroll
      for (int i = 0; i < kV; ++i)
        t.u[i] = (m < M && c + i < c1) ? src[i] : U(0);
      *dst = t.w;
    }
  }
  cp_async_commit();
}

// landed chunk -> staged words
__device__ __forceinline__ void tile_transpose(uint32_t* xs,
                                               const uint4* land, uint16_t) {
  using G = Tile<uint16_t>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int it = warp; it < G::kPlanes * 32; it += blockDim.x >> 5) {
    const int w = it >> 5, u = it & 31;
    const int ma = lane + 64 * w, mb = ma + 32;
    const uint4 a = land[ma * 32 + (u ^ (ma & 7))];
    const uint4 b = land[mb * 32 + (u ^ (mb & 7))];
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
    uint32_t* dst = xs + u * 8 * G::kWords + lane + 32 * w;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      dst[(2 * q) * G::kWords] = __byte_perm(aw[q], bw[q], 0x5410);
      dst[(2 * q + 1) * G::kWords] = __byte_perm(aw[q], bw[q], 0x7632);
    }
  }
}
__device__ __forceinline__ void tile_transpose(uint32_t* xs,
                                               const uint4* land, uint32_t) {
  using G = Tile<uint32_t>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int it = warp; it < G::kPlanes * 32; it += blockDim.x >> 5) {
    const int w = it >> 5, u = it & 31;
    const int m = lane + 32 * w;
    const uint4 a = land[m * 32 + (u ^ (m & 7))];
    uint32_t* dst = xs + u * 4 * G::kWords + lane + 32 * w;
    dst[0] = a.x;
    dst[G::kWords] = a.y;
    dst[2 * G::kWords] = a.z;
    dst[3 * G::kWords] = a.w;
  }
}

template <typename U, int W>
__global__ void __launch_bounds__(W * 32, 1)
sparse_gemm_tiled_kernel(const U* __restrict__ x, const int* __restrict__ idx,
                         const float* __restrict__ val,
                         float* __restrict__ out, int M, int R, int n,
                         int kcap, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem);
  uint4* land = reinterpret_cast<uint4*>(smem + kTileXBytes);
  float* tile = reinterpret_cast<float*>(smem);  // after the last chunk
  constexpr int kR = TileShape<W>::kR;
  constexpr int kOutStride = TileShape<W>::kOutStride;
  // each row's batch of 32 slots (index, value bits), the batch's first
  // slot and the row's next slot within the batch
  int2* slots = reinterpret_cast<int2*>(smem + kTileRegion);
  int* sbase = reinterpret_cast<int*>(slots + kR * 32);
  int* soff = sbase + kR;
  constexpr int kCols = Tile<U>::kCols;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kR, m0 = blockIdx.y * kTileM;

  // Load slots [b, b + 32) of local row rl into its batch.  Slots past
  // kcap, rows past R and indices outside [0, n) read as the sentinel n.
  auto refill = [&](int rl, int b) {
    const int r = r0 + rl, s = b + lane;
    int c = n;
    float v = 0.0f;
    if (r < R && s < kcap) {
      const long long o = static_cast<long long>(r) * kcap + s;
      c = __ldg(idx + o);
      v = __ldg(val + o);
      if (c < 0 || c > n) c = n;
    }
    __syncwarp();  // every lane is done with the old batch
    slots[rl * 32 + lane] = make_int2(c, __float_as_int(v));
    __syncwarp();
  };
  // acc += the slots [from, to) of a row's batch bs.  Indices ascend, so
  // each lies in the chunk; the clamp keeps a row that breaks that (a
  // damaged checkpoint) inside shared memory.
  auto run = [&](float (&a)[4], const int2* bs, int from, int to, int c0) {
#pragma unroll 2
    for (int s = from; s < to; ++s) {
      const int2 cv = bs[s];
      float f[4];
      tile_x4(xs, min(static_cast<unsigned>(cv.x - c0), kCols - 1u), lane, f,
              U());
      const float v = __int_as_float(cv.y);
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = fmaf(v, f[j], a[j]);
    }
  };
  // after a row's run to `end` in its batch: while the run filled the
  // batch, load the next one and go on; then keep the row's next slot
  auto finish = [&](float (&a)[4], int rl, int end, int c0, int c1) {
    const int2* bs = slots + rl * 32;
    if (end == 32) {
      int b = sbase[rl];
      do {
        b += 32;
        refill(rl, b);
        end = __popc(__ballot_sync(qs::FULL, bs[lane].x < c1));
        run(a, bs, 0, end, c0);
      } while (end == 32);
      if (lane == 0) sbase[rl] = b;
    }
    if (lane == 0) soff[rl] = end;
  };

  tile_issue<U>(land, x, M, n, m0, 0, min(n, kCols), vec != 0);
  float acc[kTileRowsPerWarp][4];
#pragma unroll
  for (int i = 0; i < kTileRowsPerWarp; ++i) {
    const int rl = warp * kTileRowsPerWarp + i;
    refill(rl, 0);
    if (lane == 0) sbase[rl] = soff[rl] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  for (int c0 = 0; c0 < n; c0 += kCols) {
    const int c1 = min(n, c0 + kCols);
    cp_async_wait<0>();
    __syncthreads();  // the chunk has landed and the previous one is consumed
    tile_transpose(xs, land, U());
    __syncthreads();
    // the next chunk lands while this one is computed
    if (c1 < n)
      tile_issue<U>(land, x, M, n, m0, c1, min(n, c1 + kCols), vec != 0);
    // each row's run in this chunk: from its next slot to the batch's
    // count of indices below c1 (packed: count << 8 | next slot)
    int span[kTileRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kTileRowsPerWarp; ++i) {
      const int rl = warp * kTileRowsPerWarp + i;
      const unsigned below =
          __ballot_sync(qs::FULL, slots[rl * 32 + lane].x < c1);
      span[i] = (__popc(below) << 8) | soff[rl];
    }
#pragma unroll
    for (int i = 0; i < kTileRowsPerWarp; ++i) {
      const int rl = warp * kTileRowsPerWarp + i;
      const int end = span[i] >> 8;
      run(acc[i], slots + rl * 32, span[i] & 255, end, c0);
      finish(acc[i], rl, end, c0, c1);
    }
  }
  // The output tile leaves in two passes of 64 activation rows through
  // the chunk region, stored coalesced along r.
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTileRowsPerWarp; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        tile[(lane + 32 * jj) * kOutStride + warp * kTileRowsPerWarp + i] =
            acc[i][2 * p + jj];
    __syncthreads();
    for (int e = threadIdx.x; e < 64 * kR; e += blockDim.x) {
      const int mm = e / kR, rr = e % kR;
      const int m = m0 + 64 * p + mm, r = r0 + rr;
      if (m < M && r < R)
        out[static_cast<long long>(m) * R + r] = tile[mm * kOutStride + rr];
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

// SMs of the current card (cached per device)
int sm_count() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) cached[dev] = sms;
  return sms;
}

template <typename U, int W>
int launch_tiled_w(const void* x, const int* idx, const float* val,
                   float* out, int M, int R, int n, int kcap,
                   cudaStream_t st) {
  auto kern = sparse_gemm_tiled_kernel<U, W>;
  constexpr int kSmem = TileShape<W>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = n % Tile<U>::kVec == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  constexpr int kR = TileShape<W>::kR;
  const dim3 grid((R + kR - 1) / kR, (M + kTileM - 1) / kTileM);
  kern<<<grid, W * 32, kSmem, st>>>(static_cast<const U*>(x), idx, val, out,
                                    M, R, n, kcap, vec);
  return static_cast<int>(cudaGetLastError());
}

bool take_tiled(int M, int R) {
  if (M >= kTiledAlwaysM) return true;
  if (M < kTiledMinM) return false;
  const long long blocks =
      static_cast<long long>((M + kTileM - 1) / kTileM) *
      ((R + TileShape<16>::kR - 1) / TileShape<16>::kR);
  return 3 * blocks >= sm_count();
}

// 32 warps a block (256 output rows: half the L2 reads of x) where that
// still gives at least half a wave of blocks, else 16 (128 rows)
template <typename U>
int launch_tiled(const void* x, const int* idx, const float* val, float* out,
                 int M, int R, int n, int kcap, cudaStream_t st) {
  const long long wide = static_cast<long long>((M + kTileM - 1) / kTileM) *
                         ((R + TileShape<32>::kR - 1) / TileShape<32>::kR);
  if (2 * wide >= sm_count())
    return launch_tiled_w<U, 32>(x, idx, val, out, M, R, n, kcap, st);
  return launch_tiled_w<U, 16>(x, idx, val, out, M, R, n, kcap, st);
}

// ---------------------------------------------------------------------------
// qdq_gemm
// ---------------------------------------------------------------------------

constexpr int kQdqWarps = 8;
constexpr int kQdqRows = 8;         // weight rows a warp streams together
constexpr int kQdqVec = 512;        // columns a warp covers, 16 bytes a lane
constexpr int kQdqNarrow = 128;     // columns a warp covers, 4 bytes a lane
constexpr int kQdqMaxSmem = 232448;  // a block's shared memory on sm_90
// each warp's two stages of kQdqRows x 512 levels
constexpr int kQdqStageBytes = kQdqWarps * 2 * kQdqRows * kQdqVec;

// Where staged x keeps logical column c.  Inside the 16-byte region
// (c < n16) each 512-column block is stored so that the float4 of lane l
// for its level word g (columns 16 l + 4 g .. + 3) sits at (32 g + l) * 4:
// a warp's float4 reads are contiguous.  qdq_col is the inverse.
__device__ __forceinline__ int qdq_col(int p, int n16) {
  if (p >= n16) return p;
  const int w = p & (kQdqVec - 1);
  return (p - w) + 16 * ((w >> 2) & 31) + 4 * (w >> 7) + (w & 3);
}

// Four int8 levels packed in w as exact floats: each byte, biased by 128,
// becomes the low mantissa byte of 2^23, and 2^23 + 128 is subtracted.
__device__ __forceinline__ void levels4(uint32_t w, float (&f)[4]) {
  const uint32_t b = w ^ 0x80808080u;
  f[0] = __fsub_rn(__uint_as_float(__byte_perm(b, 0x4B000000u, 0x7440)),
                   8388736.0f);
  f[1] = __fsub_rn(__uint_as_float(__byte_perm(b, 0x4B000000u, 0x7441)),
                   8388736.0f);
  f[2] = __fsub_rn(__uint_as_float(__byte_perm(b, 0x4B000000u, 0x7442)),
                   8388736.0f);
  f[3] = __fsub_rn(__uint_as_float(__byte_perm(b, 0x4B000000u, 0x7443)),
                   8388736.0f);
}

// acc += four levels times x's four columns, in column order
__device__ __forceinline__ float dot4(const float (&f)[4], const float4& xv,
                                      float acc) {
  acc = fmaf(f[0], xv.x, acc);
  acc = fmaf(f[1], xv.y, acc);
  acc = fmaf(f[2], xv.z, acc);
  return fmaf(f[3], xv.w, acc);
}

// One pass of MT activation rows (blockIdx.y) against every weight row.
// acc[j * kQdqRows + i]: activation row j of the pass, weight row i of the
// warp's group.  Each warp walks its row groups' 512-column tiles in one
// sequence and copies tile t + 1's levels into its other stage while it
// computes tile t (the first tile of the next group during the last of
// this one); each lane reads back only the bytes it copied.
template <typename T, int MT>
__global__ void __launch_bounds__(kQdqWarps * 32)
qdq_gemm_kernel(const T* __restrict__ x, const int8_t* __restrict__ lv,
                const float* __restrict__ scale, float* __restrict__ out,
                int M, int R, int n, int n16) {
  extern __shared__ __align__(16) float xq[];  // [MT][n] (qdq_col), stages
  constexpr int V = kQdqRows * MT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint4* stages = reinterpret_cast<uint4*>(xq + MT * n) +
                  warp * 2 * kQdqRows * 32;
  const int m0 = blockIdx.y * MT;
  for (int e = threadIdx.x; e < MT * n; e += blockDim.x) {
    const int j = e / n, p = e - j * n;
    const int m = m0 + j;
    xq[e] = m < M
                ? qs::to_f32(x[static_cast<long long>(m) * n + qdq_col(p, n16)])
                : 0.0f;
  }
  __syncthreads();
  const int gw = blockIdx.x * kQdqWarps + warp, nw = gridDim.x * kQdqWarps;
  const int groups = (R + kQdqRows - 1) / kQdqRows;
  const int mine = gw < groups ? (groups - 1 - gw) / nw + 1 : 0;
  const int per = n16 / kQdqVec;  // 512-column tiles a row
  const int tiles = mine * per;
  auto issue = [&](int t) {
    if (t < tiles) {
      const int gi = t / per, c = (t - gi * per) * kQdqVec;
      const int r0 = (gw + gi * nw) * kQdqRows;
      uint4* dst = stages + (t & 1) * kQdqRows * 32 + lane;
#pragma unroll
      for (int i = 0; i < kQdqRows; ++i)
        if (r0 + i < R)
          cp_async16(dst + i * 32,
                     lv + static_cast<long long>(r0 + i) * n + c + 16 * lane);
    }
    cp_async_commit();
  };
  issue(0);
  for (int gi = 0; gi < mine; ++gi) {
    const int r0 = (gw + gi * nw) * kQdqRows;
    float acc[V];
#pragma unroll
    for (int t = 0; t < V; ++t) acc[t] = 0.0f;
    for (int k = 0; k < per; ++k) {
      const int t = gi * per + k, c = k * kQdqVec;
      issue(t + 1);
      cp_async_wait<1>();  // tile t has landed
      const uint4* src = stages + (t & 1) * kQdqRows * 32 + lane;
      uint4 q[kQdqRows];
#pragma unroll
      for (int i = 0; i < kQdqRows; ++i)
        q[i] = r0 + i < R ? src[i * 32] : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float4 xv[MT];
#pragma unroll
        for (int j = 0; j < MT; ++j)
          xv[j] = *reinterpret_cast<const float4*>(
              xq + j * n + c + (32 * g + lane) * 4);
#pragma unroll
        for (int i = 0; i < kQdqRows; ++i) {
          float f[4];
          levels4(g == 0   ? q[i].x
                  : g == 1 ? q[i].y
                  : g == 2 ? q[i].z
                           : q[i].w,
                  f);
#pragma unroll
          for (int j = 0; j < MT; ++j)
            acc[j * kQdqRows + i] = dot4(f, xv[j], acc[j * kQdqRows + i]);
        }
      }
    }
    const int8_t* __restrict__ rows = lv + static_cast<long long>(r0) * n;
    for (int c0 = n16; c0 < n; c0 += kQdqNarrow) {
      const int c = c0 + 4 * lane;
      if (c < n) {
        uint32_t q[kQdqRows];
#pragma unroll
        for (int i = 0; i < kQdqRows; ++i)
          q[i] = r0 + i < R
                     ? __ldcs(reinterpret_cast<const unsigned int*>(
                           rows + static_cast<long long>(i) * n + c))
                     : 0u;
        float4 xv[MT];
#pragma unroll
        for (int j = 0; j < MT; ++j)
          xv[j] = *reinterpret_cast<const float4*>(xq + j * n + c);
#pragma unroll
        for (int i = 0; i < kQdqRows; ++i) {
          float f[4];
          levels4(q[i], f);
#pragma unroll
          for (int j = 0; j < MT; ++j)
            acc[j * kQdqRows + i] = dot4(f, xv[j], acc[j * kQdqRows + i]);
        }
      }
    }
    int base = 0;
    reduce_scatter<V, 16>(acc, lane, base);
    constexpr int kKept = V >= 32 ? V / 32 : 1;
    // below 32 values, 32 / V lanes hold each sum: the lowest one writes
    if (V >= 32 || (lane & (32 / V - 1)) == 0) {
#pragma unroll
      for (int t = 0; t < kKept; ++t) {
        const int r = r0 + (base + t) % kQdqRows;
        const int m = m0 + (base + t) / kQdqRows;
        if (r < R && m < M)
          out[static_cast<long long>(m) * R + r] = scale[r] * acc[t];
      }
    }
  }
  cp_async_wait<0>();
}

// ---- qdq_gemm on the tensor cores (bfloat16 x) ----
//
// mma.sync m16n8k16 with 16 weight rows as A (levels, exact in bf16: at
// most 8 significant bits) and a pass's 8 activation rows as the n side
// (rows past M are zeros); every product is exact in f32 and only the
// order of the sums changes.  The contraction may take the 16 k of a step
// in any order that A and B share: lane (g = lane / 4, t = lane % 4) loads
// 16 levels of rows g and g + 8 at columns 16 t .. 16 t + 15 of a 64-column
// block (one 16-byte load each, whole sectors across the warp), and its
// k = 2t, 2t + 1, 2t + 8, 2t + 9 of step s are columns 16 t + 4 s + 0 .. 3.
// B is staged in that fragment order, so a step's B is one conflict-free
// 8-byte read.  A warp holds two 16-row groups; the next block's levels
// are loaded while this one is multiplied.
constexpr int kMmaDepth = 4;  // 64-column blocks of levels in flight a lane

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// four int8 levels -> two bfloat16 pairs (levels 0, 1 and 2, 3): the exact
// float's upper half is its bfloat16
__device__ __forceinline__ void levels4_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  float f[4];
  levels4(w, f);
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

__global__ void __launch_bounds__(kQdqWarps * 32)
qdq_mma_kernel(const __nv_bfloat16* __restrict__ x,
               const int8_t* __restrict__ lv, const float* __restrict__ scale,
               float* __restrict__ out, int M, int R, int n) {
  extern __shared__ __align__(16) uint2 bfrag[];  // [n / 16][32 lanes]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * 8;
  const uint16_t* xr = reinterpret_cast<const uint16_t*>(x);
  for (int e = threadIdx.x; e < n / 16 * 32; e += blockDim.x) {
    const int step = e >> 5, l = e & 31;   // step = 64-column block * 4 + s
    const int m = m0 + (l >> 2);
    const int c = (step >> 2) * 64 + 16 * (l & 3) + 4 * (step & 3);
    uint2 b = make_uint2(0, 0);
    if (m < M) {
      const uint16_t* src = xr + static_cast<long long>(m) * n + c;
      b = make_uint2(src[0] | (static_cast<uint32_t>(src[1]) << 16),
                     src[2] | (static_cast<uint32_t>(src[3]) << 16));
    }
    bfrag[e] = b;
  }
  __syncthreads();
  const int blocks64 = n / 64;
  const int step_rows = gridDim.x * kQdqWarps * 16;
  for (int r0 = (blockIdx.x * kQdqWarps + warp) * 16; r0 < R;
       r0 += step_rows) {
    // the lane's two weight rows: r0 + g (h = 0) and r0 + 8 + g (h = 1)
    const int8_t* src[2];
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h + g;
      live[h] = r < R;
      src[h] = lv + static_cast<long long>(live[h] ? r : 0) * n + 16 * t;
    }
    auto load = [&](uint4 (&a)[2], int kb) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[h] = live[h] && kb < blocks64
                   ? __ldcs(reinterpret_cast<const uint4*>(src[h] + 64 * kb))
                   : make_uint4(0, 0, 0, 0);
    };
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    uint4 ring[kMmaDepth][2];
#pragma unroll
    for (int u = 0; u < kMmaDepth; ++u) load(ring[u], u);
    for (int kb0 = 0; kb0 < blocks64; kb0 += kMmaDepth) {
      // the tensor cores' sum of each 256 columns, added in IEEE float32
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int u = 0; u < kMmaDepth; ++u) {
        const int kb = kb0 + u;
        if (kb < blocks64) {
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            uint32_t a[4];
            levels4_bf16(word_of(ring[u][0], s), a[0], a[2]);
            levels4_bf16(word_of(ring[u][1], s), a[1], a[3]);
            mma_bf16(part, a, bfrag[(kb * 4 + s) * 32 + lane]);
          }
        }
        load(ring[u], kb + kMmaDepth);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += part[i];
    }
    // acc: rows r0 + g (0, 1) and r0 + 8 + g (2, 3); activation rows
    // m0 + 2 t (0, 2) and m0 + 2 t + 1 (1, 3)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + g + 8 * (i >> 1);
      const int m = m0 + 2 * t + (i & 1);
      if (r < R && m < M)
        out[static_cast<long long>(m) * R + r] = scale[r] * acc[i];
    }
  }
}

// blocks for `groups` units of work over sms * per_sm resident blocks, so
// that every block gets the same number of units (but the last)
int even_blocks(int groups, int resident) {
  const int per = (groups + resident - 1) / resident;
  return (groups + per - 1) / per;
}

int launch_qdq_mma(const void* x, const int8_t* lv, const float* scale,
                   float* out, int M, int R, int n, cudaStream_t st) {
  const int smem = n * 16;  // 8 rows of bfloat16 x
  cudaError_t err = cudaFuncSetAttribute(
      qdq_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, qdq_mma_kernel, kQdqWarps * 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int sms = sm_count();
  const int groups = (R + kQdqWarps * 16 - 1) / (kQdqWarps * 16);
  const dim3 grid(static_cast<unsigned>(even_blocks(groups, sms * per_sm)),
                  static_cast<unsigned>((M + 7) / 8));
  qdq_mma_kernel<<<grid, kQdqWarps * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), lv, scale, out, M, R, n);
  return static_cast<int>(cudaGetLastError());
}

// activation rows a pass stages: the least power of two >= M, at most 8,
// halved while they do not fit a block's shared memory (0: not even one)
int qdq_pass_rows(int M, int n) {
  int mt = M >= 8 ? 8 : M > 4 ? 8 : M > 2 ? 4 : M;
  while (mt > 0 &&
         static_cast<long long>(mt) * n * 4 + kQdqStageBytes > kQdqMaxSmem)
    mt /= 2;
  return mt;
}

template <typename T, int MT>
int launch_qdq_mt(const void* x, const int8_t* lv, const float* scale,
                  float* out, int M, int R, int n, cudaStream_t st) {
  auto kern = qdq_gemm_kernel<T, MT>;
  const int smem = MT * n * 4 + kQdqStageBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int sms = sm_count();
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, kQdqWarps * 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int groups = (R + kQdqWarps * kQdqRows - 1) / (kQdqWarps * kQdqRows);
  const int n16 = n % 16 == 0 && reinterpret_cast<uintptr_t>(lv) % 16 == 0
                      ? n / kQdqVec * kQdqVec
                      : 0;
  const dim3 grid(static_cast<unsigned>(even_blocks(groups, sms * per_sm)),
                  static_cast<unsigned>((M + MT - 1) / MT));
  kern<<<grid, kQdqWarps * 32, smem, st>>>(static_cast<const T*>(x), lv,
                                           scale, out, M, R, n, n16);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_qdq(const void* x, const int8_t* lv, const float* scale,
               float* out, int M, int R, int n, cudaStream_t st) {
  if (std::is_same<T, __nv_bfloat16>::value && M > 1 && n % 64 == 0 &&
      n * 16 <= kQdqMaxSmem && reinterpret_cast<uintptr_t>(lv) % 16 == 0)
    return launch_qdq_mma(x, lv, scale, out, M, R, n, st);
  switch (qdq_pass_rows(M, n)) {
    case 1:
      return launch_qdq_mt<T, 1>(x, lv, scale, out, M, R, n, st);
    case 2:
      return launch_qdq_mt<T, 2>(x, lv, scale, out, M, R, n, st);
    case 4:
      return launch_qdq_mt<T, 4>(x, lv, scale, out, M, R, n, st);
    case 8:
      return launch_qdq_mt<T, 8>(x, lv, scale, out, M, R, n, st);
    default:  // a row of x does not fit a block's shared memory
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// As qs_sparse_gemm, on the kernel `route` names: 0 the warp-per-row
// kernel, 1 the tiled one, 2 the decode one, -1 the one the shapes pick
// (the decode kernel where M <= kDecodeMaxM and x fits its staging, else
// take_tiled).
extern "C" int qs_sparse_gemm_route(const void* x, const int* idx,
                                    const float* val, float* out, int M,
                                    int R, int n, int kcap, int x_bf16,
                                    int route, void* stream) {
  if (M <= 0 || R <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route < 0)
    route = decode_fits(M, n, x_bf16 ? 2 : 4) ? 2 : take_tiled(M, R);
  if (route == 2 && !decode_fits(M, n, x_bf16 ? 2 : 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 2)
    return x_bf16 ? launch_decode<uint16_t>(x, idx, val, out, M, R, n, kcap,
                                            st)
                  : launch_decode<float>(x, idx, val, out, M, R, n, kcap,
                                         st);
  if (route == 1)
    return x_bf16 ? launch_tiled<uint16_t>(x, idx, val, out, M, R, n, kcap,
                                           st)
                  : launch_tiled<uint32_t>(x, idx, val, out, M, R, n, kcap,
                                           st);
  return x_bf16 ? launch_sparse<__nv_bfloat16>(x, idx, val, out, M, R, n,
                                               kcap, st)
                : launch_sparse<float>(x, idx, val, out, M, R, n, kcap, st);
}

// x: [M, n] float32 (x_bf16 = 0) or bfloat16 (1); idx int32 / val f32
// [R, kcap]; out: [M, R] float32.
extern "C" int qs_sparse_gemm(const void* x, const int* idx,
                              const float* val, float* out, int M, int R,
                              int n, int kcap, int x_bf16, void* stream) {
  return qs_sparse_gemm_route(x, idx, val, out, M, R, n, kcap, x_bf16, -1,
                              stream);
}

// The tiled kernel's geometry: the crossover Ms (take_tiled), activation
// rows a block, output rows a block of 16 and of 32 warps, columns a chunk
// (float32, bfloat16 x), shared memory bytes of a 32-warp block.
extern "C" int qs_sparse_gemm_geometry(int* geo) {
  geo[0] = kTiledMinM;
  geo[1] = kTiledAlwaysM;
  geo[2] = kTileM;
  geo[3] = TileShape<16>::kR;
  geo[4] = TileShape<32>::kR;
  geo[5] = Tile<uint32_t>::kCols;
  geo[6] = Tile<uint16_t>::kCols;
  geo[7] = TileShape<32>::kSmem;
  return 0;
}

// The decode kernel's geometry: the most activation rows it takes, the
// most bytes of staged x, warps a block.
extern "C" int qs_sparse_gemm_decode_geometry(int* geo) {
  geo[0] = kDecodeMaxM;
  geo[1] = kDecodeSmem;
  geo[2] = kDecodeWarps;
  return 0;
}

// x: [M, n] float32 or bfloat16; levels int8 [R, n] (n a multiple of 4,
// rows 4-byte aligned); scale f32 [R]; out: [M, R] float32.
extern "C" int qs_qdq_gemm(const void* x, const int8_t* lv,
                           const float* scale, float* out, int M, int R,
                           int n, int x_bf16, void* stream) {
  if (M <= 0 || R <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_qdq<__nv_bfloat16>(x, lv, scale, out, M, R, n, st)
                : launch_qdq<float>(x, lv, scale, out, M, R, n, st);
}
