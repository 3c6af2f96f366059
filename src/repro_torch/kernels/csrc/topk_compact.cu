// topk_compact: the bisection-threshold Top_k of each row of an
// error-compensated accumulator, written in the compact wire form of the
// sparse_allgather sync: survivor slots (idx, val) in ascending index
// order, the sentinel (n, 0) in empty slots, the fused error memory and
// the per-row count.
//
// Replaces the TPU kernel src/repro/kernels/topk_compress.py
// (topk_compact -> _compact_kernel).  Per row of acc [rows, n] float32:
//   thr as topk_compress (common.cuh: bisect_threshold bit for bit);
//   mask = |acc| >= thr && |acc| > 0;  pos = survivors before it;
//   emit = mask && pos < kcap;  cnt = sum(emit)
//   sel = emit ? acc : 0, or with sign: emit ? sign(acc)*||sel||_2/max(cnt,1) : 0
//   idx[pos] = j, val[pos] = sel[j] for emitted j; (n, 0) in slots >= cnt
//   mem = acc - sel   (survivors past kcap keep their value)
// The counts decide the wire-bit ledger, so they agree bit for bit with
// the plain version (ref.topk_compact_ref); so do idx and the memory,
// and val for plain Top_k.  Only the SignTop_k norm is a float sum in
// another order.
//
// What bounds it on an H100: memory.  The function reads the row once
// and writes the memory once (8 bytes per element) plus the 8-byte
// slots.  Two designs, by row length (kernels/topk_compress.py
// compact_geometry mirrors the choice; the wrapper passes the rows a
// block):
//
// - Rows of up to 12,288 floats (the sparse wire's are gemma3-1b's
//   1152): topk_compress's short-row design.  A warp a row up to 2048
//   floats (eight rows a block, fewer where their slots would not fit
//   half an SM's shared memory; no block barrier), else a block of 4, 8
//   or 12 warps a row.  The row is loaded once into registers with
//   16-byte loads (9 float4s a lane at 1152) and the threshold is
//   common.cuh's row_threshold, the same code as topk_compress's, so the
//   threshold is its float.  Element (j, lane, q) is index 4 (32 j +
//   lane) + q (with RW warps: 4 (32 RW j + 32 w + lane) + q), so
//   ascending index order is j, warp, lane, q: for each j, four ballots
//   (one per q) give each lane the survivors of the lower lanes, the
//   warps' totals cross through shared memory (RW > 1), and a running
//   carry counts the j's before.  Emitted slots are written into shared
//   memory, pre-filled with the sentinel and reusing the row's three
//   histograms' space; the SignTop_k norm is a sum over the emitted
//   values in registers; the memory goes out from registers as 16-byte
//   stores, and the kcap slots as coalesced 16-byte stores.
// - Longer rows: one block of 1024 threads a row, the row re-read from
//   device memory on each of bisect_threshold's 26 counting passes, and
//   a tiled block-wide exclusive scan of the survivor mask in index
//   order; SignTop_k writes its values in a second pass over the
//   emitted slots.
// The TPU kernel's chunked one-hot matmul scatter exists because the TPU
// has no vector scatter; it has no counterpart here.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr long long kShortMaxElems = 12288;  // longer rows: the scan kernel
constexpr long long kWarpMaxElems = 2048;    // rows a warp holds
constexpr int kSmemMax = 232448;             // a block's shared memory
constexpr int kDefaultSmem = 48 * 1024;      // without the opt-in

// ints of a row's shared-memory area: its three 256-bin histograms, and
// after the threshold its kcap slots (idx, then val) in the same space
__host__ __device__ constexpr long long row_area(int kcap) {
  return 2LL * ((kcap + 3) / 4 * 4) > 3 * 256 ? 2LL * ((kcap + 3) / 4 * 4)
                                              : 3 * 256;
}

// Rows of up to kShortMaxElems floats: RW warps a row (RW = 1: `group`
// rows a block, a warp each), the row in registers, V4 float4s a thread,
// slots past n NaN (no count sees them).  `vec`: 16-byte loads and
// stores of acc and mem; `svec`: of idx and val.
template <int RW, int V4>
__global__ void __launch_bounds__(RW == 1 ? 256 : RW * 32)
topk_compact_rows_kernel(const float* __restrict__ acc, int* __restrict__ idx,
                         float* __restrict__ val, float* __restrict__ mem,
                         int* __restrict__ cnt_out, long long rows,
                         long long n, int k, int kcap, int iters, int sign,
                         int vec, int svec, int group) {
  static_assert(V4 * 4 <= 64, "emitted bits");
  constexpr int T = RW * 32;  // threads a row
  extern __shared__ __align__(16) int areas[];
  __shared__ int iscr[2][RW];
  __shared__ unsigned uscr[2][RW];
  __shared__ float fscr[2][RW];
  const int grp = RW == 1 ? static_cast<int>(threadIdx.x >> 5) : 0;
  const int t = static_cast<int>(threadIdx.x) % T;
  const int lane = t & 31;
  const long long row = static_cast<long long>(blockIdx.x) * group + grp;
  if (row >= rows) return;  // uniform across the row's group
  int* const area = areas + grp * row_area(kcap);
  const float* __restrict__ src = acc + row * n;
  auto index = [&](int j) -> long long { return 4LL * (j * T + t); };
  const float nan = __uint_as_float(0x7fc00000u);
  auto load = [&](int j) -> float4 {
    const long long i = index(j);
    if (vec)
      return i < n ? __ldg(reinterpret_cast<const float4*>(src + i))
                   : make_float4(nan, nan, nan, nan);
    float e[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) e[q] = i + q < n ? __ldg(src + i + q) : nan;
    return make_float4(e[0], e[1], e[2], e[3]);
  };
  qs::RowGroup<RW> g{iscr, uscr, fscr, 0};
  float4 v[V4];
  const float thr = qs::row_threshold<RW>(
      load, v, k, iters, reinterpret_cast<int (*)[256]>(area), g);

  // the histograms' last reads are done: their space takes the slots,
  // each holding the sentinel until a survivor lands in it
  g.sync();
  int* const sidx = area;
  float* const sval = reinterpret_cast<float*>(area + (kcap + 3) / 4 * 4);
  for (int s = t; s < kcap; s += T) {
    sidx[s] = static_cast<int>(n);
    sval[s] = 0.0f;
  }
  g.sync();

  auto kept = [&](float x) {
    const float a = fabsf(x);
    return a >= thr && a > 0.0f;
  };
  const unsigned lower = (1u << lane) - 1u;
  int carry = 0;                   // survivors of the j's before
  float sq = 0.0f;                 // emitted values' squares, index order
  unsigned long long emitted = 0;  // bit 4 j + q: element (j, q) emitted
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    const bool s[4] = {kept(v[j].x), kept(v[j].y), kept(v[j].z),
                       kept(v[j].w)};
    int below = 0, mine = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned b = __ballot_sync(qs::FULL, s[q]);
      below += __popc(b & lower);
      mine += __popc(b);
    }
    int total;
    int pos = carry + g.warp_scan(mine, total) + below;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (s[q]) {
        if (pos < kcap) {
          const float x = qs::comp(v[j], q);
          sidx[pos] = static_cast<int>(index(j) + q);
          sval[pos] = x;
          sq = __fadd_rn(sq, __fmul_rn(x, x));  // not contracted: the model's
          emitted |= 1ull << (4 * j + q);
        }
        ++pos;
      }
    }
    carry += total;
  }
  const int cnt = carry < kcap ? carry : kcap;
  // the norm: each thread's squares in index order, the warp's
  // butterfly, the warps in order (ref.topk_compact_rows_ref, bit for
  // bit).  repro computes sign(acc) * norm / denom; sign * norm is
  // exact, so (sign * norm) / denom == sign * (norm / denom) bit for
  // bit.  A row of one float: its magnitude, exactly (ref.sign_norm)
  const float norm = n == 1 ? fabsf(__ldg(src)) : sqrtf(g.fsum(sq));
  const float scale = norm / fmaxf(static_cast<float>(cnt), 1.0f);
  auto sel_of = [&](float x, int bit) {
    return (emitted >> bit) & 1ull ? (sign ? qs::sign_of(x) * scale : x)
                                   : 0.0f;
  };

  float* __restrict__ mrow = mem + row * n;
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    const long long i = index(j);
    const float4 x = v[j];
    const float4 m = make_float4(x.x - sel_of(x.x, 4 * j),
                                 x.y - sel_of(x.y, 4 * j + 1),
                                 x.z - sel_of(x.z, 4 * j + 2),
                                 x.w - sel_of(x.w, 4 * j + 3));
    if (vec) {
      if (i < n) *reinterpret_cast<float4*>(mrow + i) = m;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (i + q < n) mrow[i + q] = qs::comp(m, q);
    }
  }

  g.sync();  // every thread's slots are in shared memory
  int* __restrict__ irow = idx + row * kcap;
  float* __restrict__ vrow = val + row * kcap;
  auto out_val = [&](int s, float x) {
    return sign && s < cnt ? qs::sign_of(x) * scale : x;
  };
  if (svec) {
    for (int s4 = t; s4 < kcap / 4; s4 += T) {
      const int4 a = reinterpret_cast<const int4*>(sidx)[s4];
      const float4 b = reinterpret_cast<const float4*>(sval)[s4];
      reinterpret_cast<int4*>(irow)[s4] = a;
      reinterpret_cast<float4*>(vrow)[s4] =
          make_float4(out_val(4 * s4, b.x), out_val(4 * s4 + 1, b.y),
                      out_val(4 * s4 + 2, b.z), out_val(4 * s4 + 3, b.w));
    }
  } else {
    for (int s = t; s < kcap; s += T) {
      irow[s] = sidx[s];
      vrow[s] = out_val(s, sval[s]);
    }
  }
  if (t == 0) cnt_out[row] = cnt;
}

template <int RW, int V4>
int launch_rows(const float* acc, int* idx, float* val, float* mem, int* cnt,
                long long rows, long long n, int k, int kcap, int iters,
                int sign, int vec, int svec, int group, cudaStream_t st) {
  const int smem = static_cast<int>(group * row_area(kcap) * sizeof(int));
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_compact_rows_kernel<RW, V4>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((rows + group - 1) / group);
  topk_compact_rows_kernel<RW, V4>
      <<<blocks, RW == 1 ? 32 * group : 32 * RW, smem, st>>>(
          acc, idx, val, mem, cnt, rows, n, k, kcap, iters, sign, vec, svec,
          group);
  return static_cast<int>(cudaGetLastError());
}

// Longer rows: one block a row, the row read from device memory on every
// counting pass, slots by a block-wide scan in tiles of THREADS elements.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
topk_compact_scan_kernel(const float* __restrict__ acc, int* __restrict__ idx,
                         float* __restrict__ val, float* __restrict__ mem,
                         int* __restrict__ cnt_out, long long n, int k,
                         int kcap, int iters, int sign) {
  __shared__ int iscratch[2][32];
  __shared__ float fscratch[2][32];

  const long long row = blockIdx.x;
  const float* __restrict__ src = acc + row * n;
  float* __restrict__ mrow = mem + row * n;
  int* __restrict__ irow = idx + row * kcap;
  float* __restrict__ vrow = val + row * kcap;
  const int tid = threadIdx.x;
  auto value = [&](long long i) -> float { return __ldg(src + i); };

  int buf = 0;
  const float thr = qs::bisect_threshold<THREADS>(value, n, k, iters,
                                                  iscratch, fscratch[0], buf);

  // slots: a scan of the survivor mask over tiles of THREADS elements in
  // index order; `carry` counts the survivors of the tiles before
  int carry = 0;
  float sq = 0.0f;
  for (long long base = 0; base < n; base += THREADS) {
    const long long i = base + tid;
    const float v = i < n ? value(i) : 0.0f;
    const float a = fabsf(v);
    const int survivor = (i < n && a >= thr && a > 0.0f) ? 1 : 0;
    int total;
    const int pos = carry + qs::block_exclusive_scan<THREADS>(
                                survivor, iscratch[buf], total);
    buf ^= 1;
    carry += total;
    if (i >= n) continue;
    if (survivor && pos < kcap) {
      irow[pos] = static_cast<int>(i);
      if (sign) {
        sq += v * v;            // value and memory written below
      } else {
        vrow[pos] = v;
        mrow[i] = v - v;
      }
    } else {
      mrow[i] = v;
    }
  }
  const int cnt = carry < kcap ? carry : kcap;
  if (sign) {
    const float norm = sqrtf(qs::block_sum<THREADS>(sq, fscratch[1]));
    const float scale = norm / fmaxf(static_cast<float>(cnt), 1.0f);
    // the block_sum's barrier orders the idx stores above before these
    // reads (global memory is coherent within a block at a barrier)
    for (int s = tid; s < cnt; s += THREADS) {
      const long long j = irow[s];
      const float v = value(j);
      const float sel = qs::sign_of(v) * scale;
      vrow[s] = sel;
      mrow[j] = v - sel;
    }
  }
  for (int s = cnt + tid; s < kcap; s += THREADS) {
    irow[s] = static_cast<int>(n);
    vrow[s] = 0.0f;
  }
  if (tid == 0) cnt_out[row] = cnt;
}

}  // namespace

// `group`: rows a block of the warp-a-row kernel (rows up to 2048
// floats: 1, 2, 4 or 8, their slots within a block's shared memory);
// 1 for longer rows.
extern "C" int qs_topk_compact_f32(const float* acc, int* idx, float* val,
                                   float* mem, int* cnt, long long rows,
                                   long long n, int k, int kcap, int iters,
                                   int sign, int group, void* stream) {
  if (rows <= 0) return 0;
  if (kcap < 1 || kcap > n) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > kShortMaxElems) {
    if (group != 1) return static_cast<int>(cudaErrorInvalidValue);
    topk_compact_scan_kernel<1024>
        <<<static_cast<unsigned>(rows), 1024, 0, st>>>(
            acc, idx, val, mem, cnt, n, k, kcap, iters, sign);
    return static_cast<int>(cudaGetLastError());
  }
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(acc) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(mem) % 16 == 0;
  const int svec = kcap % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(val) % 16 == 0;
  const bool warp = n <= kWarpMaxElems;
  if ((group != 1 && group != 2 && group != 4 && group != 8) ||
      (!warp && group != 1) ||
      group * row_area(kcap) * static_cast<long long>(sizeof(int)) > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
#define QS_ROWS(RW, V4)                                                     \
  launch_rows<RW, V4>(acc, idx, val, mem, cnt, rows, n, k, kcap, iters,   \
                      sign, vec, svec, group, st)
  if (n > 8192) return QS_ROWS(12, 8);
  if (n > 4096) return QS_ROWS(8, 8);
  if (n > 2048) return QS_ROWS(4, 8);
  // a warp a row: ceil(n / 128) float4s a lane, rounded up to one of these
  const long long v4 = (n + 127) / 128;
  if (v4 <= 1) return QS_ROWS(1, 1);
  if (v4 <= 2) return QS_ROWS(1, 2);
  if (v4 <= 4) return QS_ROWS(1, 4);
  if (v4 <= 6) return QS_ROWS(1, 6);
  if (v4 <= 9) return QS_ROWS(1, 9);  // gemma3-1b's 1152 floats: 9 exactly
  if (v4 <= 12) return QS_ROWS(1, 12);
  return QS_ROWS(1, 16);
#undef QS_ROWS
}
