// Block-wide reductions, the block-wide prefix scan, the bisection
// threshold and the short-row select-and-replay threshold (with the
// prologue that loads a short row and takes it) shared by the
// compression kernels, and the float32 <->
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

// ---------------------------------------------------------------------------
// The short-row threshold: exact order statistics, then a scalar replay
// ---------------------------------------------------------------------------
//
// Let a(j) be the j-th largest |x| of a row, counted with multiplicity,
// NaN left out (fabsf(NaN) >= t is false and fmaxf skips it), a(j) = -inf
// past the last.  bisect_threshold's test count(|x| >= mid) > k is exactly
// a(k+1) >= mid, its last test count(|x| >= hi) >= k is exactly
// a(k) >= hi, and hi starts at max(0, a(1)).  So once a(1), a(k) and
// a(k+1) are known, its `iters` rounds replay on one thread, in the same
// float32 operations, to the same threshold bit for bit
// (ref.topk_threshold_select_ref; tests/test_torch_topk_select.py).
//
// For |x| >= 0 the order of the floats is the order of their bits, so
// a(k) is found by a radix select on the bits, 8 at a time from the top:
// a histogram of the digit over the elements that match the digits
// chosen so far, and the digit where the count from the top reaches k.
// After a digit, where a(k) is the largest (or the smallest) element of
// its bin, one max (min) over the bin ends the search.  a(k+1) is a(k)
// where at least k + 1 elements reach a(k), else the largest element
// below it.  Every step is an integer count or an integer max / min, so
// the order of the sums does not matter.

// The RW warps that own one row: a warp (RW = 1, no block barrier) or a
// whole block (RW > 1).  Reductions leave every thread of the group with
// the result; a block's alternate between two scratch rows, so one
// __syncthreads() each suffices (as in block_sum above).
template <int RW>
struct RowGroup {
  int (*iscr)[RW];     // [2][RW]
  unsigned (*uscr)[RW];
  float (*fscr)[RW];
  int buf;

  __device__ __forceinline__ void sync() const {
    if constexpr (RW == 1) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  }
  __device__ __forceinline__ int sum(int v) {
    v = __reduce_add_sync(FULL, v);
    if constexpr (RW == 1) {
      return v;
    } else {
      if ((threadIdx.x & 31) == 0) iscr[buf][threadIdx.x >> 5] = v;
      __syncthreads();
      int t = 0;
#pragma unroll
      for (int w = 0; w < RW; ++w) t += iscr[buf][w];
      buf ^= 1;
      return t;
    }
  }
  template <bool MAX>
  __device__ __forceinline__ unsigned extreme(unsigned v) {
    v = MAX ? __reduce_max_sync(FULL, v) : __reduce_min_sync(FULL, v);
    if constexpr (RW == 1) {
      return v;
    } else {
      if ((threadIdx.x & 31) == 0) uscr[buf][threadIdx.x >> 5] = v;
      __syncthreads();
      unsigned t = uscr[buf][0];
#pragma unroll
      for (int w = 1; w < RW; ++w)
        t = MAX ? max(t, uscr[buf][w]) : min(t, uscr[buf][w]);
      buf ^= 1;
      return t;
    }
  }
  // an exclusive scan of one warp-uniform int a warp over the group's
  // warps in order: the sum of the warps before this one (0 for a lone
  // warp); `total` gets the group's sum
  __device__ __forceinline__ int warp_scan(int v, int& total) {
    if constexpr (RW == 1) {
      total = v;
      return 0;
    } else {
      const int me = static_cast<int>(threadIdx.x >> 5);
      if ((threadIdx.x & 31) == 0) iscr[buf][me] = v;
      __syncthreads();
      int before = 0, t = 0;
#pragma unroll
      for (int w = 0; w < RW; ++w) {
        const int s = iscr[buf][w];
        before += w < me ? s : 0;
        t += s;
      }
      buf ^= 1;
      total = t;
      return before;
    }
  }
  // a float sum in a fixed order (a warp's butterfly, then the warps in
  // order): deterministic for a fixed RW
  __device__ __forceinline__ float fsum(float v) {
    v = warp_sum(v);
    if constexpr (RW == 1) {
      return v;
    } else {
      if ((threadIdx.x & 31) == 0) fscr[buf][threadIdx.x >> 5] = v;
      __syncthreads();
      float t = 0.0f;
#pragma unroll
      for (int w = 0; w < RW; ++w) t += fscr[buf][w];
      buf ^= 1;
      return t;
    }
  }
};

// |x|'s bits, or kAbsent for NaN (left out of every count)
constexpr unsigned kAbsent = 0xffffffffu;
__device__ __forceinline__ unsigned abs_key(float v) {
  const unsigned u = __float_as_uint(v) & 0x7fffffffu;
  return u > 0x7f800000u ? kAbsent : u;
}

// The digit (bits shift .. shift + 7) at which the count of a group's
// matching elements, from the top, reaches `need`: bins h[0 .. 256) read
// by every warp of the group, lane l holding bins 8 l .. 8 l + 7.  Returns
// false where fewer than `need` elements match; else sets digit, need (its
// rank inside the bin) and in_bin (the bin's count).
__device__ __forceinline__ bool pick_digit(const int* h, int& need,
                                           int& digit, int& in_bin) {
  const int lane = threadIdx.x & 31;
  const int4 lo = reinterpret_cast<const int4*>(h)[2 * lane];
  const int4 hi = reinterpret_cast<const int4*>(h)[2 * lane + 1];
  const int b[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  int t = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) t += b[j];
  int incl = t;  // count in lanes >= this one
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_down_sync(FULL, incl, off);
    if (lane + off < 32) incl += y;
  }
  const int above = incl - t;
  const unsigned at = __ballot_sync(FULL, above < need && need <= incl);
  if (!at) return false;
  const int src = __ffs(at) - 1;
  int d = 0, r = 0, c = 0;
  if (lane == src) {
    int cum = above;
#pragma unroll
    for (int j = 7; j >= 0; --j) {
      if (r == 0 && cum + b[j] >= need) {  // r >= 1 once found
        d = 8 * lane + j;
        r = need - cum;
        c = b[j];
      }
      cum += b[j];
    }
  }
  digit = __shfl_sync(FULL, d, src);
  need = __shfl_sync(FULL, r, src);
  in_bin = __shfl_sync(FULL, c, src);
  return true;
}

// The short-row threshold: `each(f)` calls f(v) on every element of this
// thread's share of the row (NaN for a padding slot: left out); `hist`
// holds three 256-bin histograms for the group; `a1` is the row's largest
// key (abs_key; 0 for a row of NaN).  Returns the threshold of
// bisect_threshold bit for bit.
template <int RW, typename Each>
__device__ __forceinline__ float select_threshold(Each each, unsigned a1,
                                                  int k, int iters,
                                                  int (*hist)[256],
                                                  RowGroup<RW>& g) {
  constexpr int T = RW * 32;
  const int t = threadIdx.x % T;
  // a(k): a radix select on the bits; kAbsent where fewer than k keys
  unsigned ak = kAbsent;
  {
    unsigned prefix = 0, mask = 0;
    int need = k;
    for (int shift = 24, p = 0; shift >= 0; shift -= 8, ++p) {
      int* h = hist[p % 3];
      each([&](float v) {
        const unsigned u = abs_key(v);
        if (u != kAbsent && (u & mask) == prefix)
          atomicAdd(h + ((u >> shift) & 255u), 1);
      });
      g.sync();
      int digit, in_bin;
      const bool found = pick_digit(h, need, digit, in_bin);
      // the histogram after the next is free: its readers have passed the
      // barrier above, its writers come after the next one
      for (int i = t; i < 256; i += T) hist[(p + 2) % 3][i] = 0;
      if (!found) break;
      prefix |= static_cast<unsigned>(digit) << shift;
      mask |= 255u << shift;
      if (shift == 0) {
        ak = prefix;
        break;
      }
      if (need == 1 || need == in_bin) {
        // a(k) is the bin's largest (smallest) element.  Both extremes
        // are reduced and the loop's state is read through constants: a
        // warp collective under a condition, with the lambda reading the
        // mutable prefix, miscompiled where registers spilled (PERF.md).
        const unsigned pm = prefix, mm = mask;
        unsigned top = 0u, bottom = kAbsent;
        each([&](float v) {
          const unsigned u = abs_key(v);
          const bool in = u != kAbsent && (u & mm) == pm;
          top = in ? max(top, u) : top;
          bottom = in ? min(bottom, u) : bottom;
        });
        top = g.template extreme<true>(top);
        bottom = g.template extreme<false>(bottom);
        ak = need == 1 ? top : bottom;
        break;
      }
    }
  }
  // a(k+1): a(k) again where k + 1 keys reach it, else the largest below
  // (kAbsent where a(k) is: no key reaches it)
  const unsigned akc = ak;
  int ge = 0;
  unsigned below = 0;
  each([&](float v) {
    const unsigned u = abs_key(v);
    if (u != kAbsent) {
      ge += u >= akc;
      below = u < akc ? max(below, u + 1) : below;
    }
  });
  ge = g.sum(ge);
  below = g.template extreme<true>(below);  // the largest below, plus one
  const unsigned ak1 = akc == kAbsent ? kAbsent
                       : ge >= k + 1  ? akc
                       : below        ? below - 1
                                      : kAbsent;
  // the serial loop's rounds, replayed
  float hi = __uint_as_float(a1), lo = 0.0f;
  for (int it = 0; it < iters; ++it) {
    const float mid = 0.5f * (lo + hi);
    if (ak1 != kAbsent && __uint_as_float(ak1) >= mid) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return ak != kAbsent && __uint_as_float(ak) >= hi ? hi : lo;
}

// component q of a float4
__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// f(x) on each of a thread's V4 x 4 elements, slot (j, q) by slot
template <int V4, typename F>
__device__ __forceinline__ void each4(const float4 (&v)[V4], F f) {
#pragma unroll
  for (int j = 0; j < V4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) f(comp(v[j], q));
}

// The short-row kernels' prologue (topk_compress's topk_rows_kernel and
// topk_compact's topk_compact_rows_kernel): the thread's share of the row
// into registers, v[j] = load(j) (NaN in slots past the row), the row's
// a(1), then select_threshold.  `hist` holds the group's three 256-bin
// histograms; the first two are cleared here, the third by
// select_threshold.  Returns bisect_threshold's threshold bit for bit.
template <int RW, int V4, typename Load>
__device__ __forceinline__ float row_threshold(Load load, float4 (&v)[V4],
                                               int k, int iters,
                                               int (*hist)[256],
                                               RowGroup<RW>& g) {
  constexpr int T = RW * 32;
  const int t = threadIdx.x % T;
#pragma unroll
  for (int j = 0; j < V4; ++j) v[j] = load(j);
  for (int i = t; i < 2 * 256; i += T) hist[i >> 8][i & 255] = 0;
  unsigned m = 0;
  each4(v, [&](float x) {
    const unsigned u = abs_key(x);
    if (u != kAbsent) m = max(m, u);
  });
  const unsigned a1 = g.template extreme<true>(m);
  if constexpr (RW == 1) __syncwarp();  // the cleared histograms
  return select_threshold<RW>([&](auto f) { each4(v, f); }, a1, k, iters,
                              hist, g);
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

// ---------------------------------------------------------------------------
// The row's sum of squares in one order that no launch geometry changes
// (kernels/ref.py:tree_sq_ref, used by qsgd and the cluster SignTop_k).
// A row of n floats is cut into groups of four, each summed as
// ((a^2 + b^2) + c^2) + d^2 (no fused multiply-add; past n, zeros); the
// groups are added by the adjacent-pair tree over their count rounded up
// to a power of two (the missing ones zeros, x + 0 == x).  A row's units
// of kTreeUnit floats are aligned subtrees of that tree, so any split of
// the units over a cluster's blocks gives the same float: each block sums
// whole units (unit_sums) and publishes them, and every block then adds
// all the row's units in the tree (units_tree).
// ---------------------------------------------------------------------------

constexpr int kTreeUnit = 2048;  // floats a unit: 512 groups

__device__ __forceinline__ float group_sq(float a, float b, float c,
                                          float d) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c)),
      __fmul_rn(d, d));
}

// the adjacent-pair tree over a warp's 32 lanes (lane i's value the i-th
// leaf); every lane leaves with the root, since a + b == b + a
__device__ __forceinline__ float lane_tree(float v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// The sums of units [u0, u1) of a row into units[0, u1 - u0): load(g) is
// group g's four floats (g the row's group index; zeros past the row),
// sq(e) their group value.  A segment of THREADS groups is summed by its
// warps' lane trees and then over the warps; a unit is 512 / THREADS
// segments.  kInFlight segments' loads are issued before any of their
// trees runs (a load must not wait behind the shuffles of the one
// before).  Every thread of the block calls it (block barriers inside);
// `part` is shared scratch.
template <int THREADS, typename Load, typename Sq>
__device__ __forceinline__ void unit_sums(long long u0, long long u1,
                                          Load load, Sq sq,
                                          float (&part)[32][THREADS / 32],
                                          float* units) {
  constexpr int kWarps = THREADS / 32;
  constexpr int kSegs = 512 / THREADS;  // segments a unit
  constexpr int kInFlight = 8;
  static_assert(kSegs >= 1 && 512 % THREADS == 0, "unit layout");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long segs = (u1 - u0) * kSegs;
  const long long g0 = u0 * 512 + threadIdx.x;
  for (long long b0 = 0; b0 < segs; b0 += 32) {
    const int nb = static_cast<int>(min(32LL, segs - b0));
    for (int s0 = 0; s0 < nb; s0 += kInFlight) {
      float4 e[kInFlight];
#pragma unroll
      for (int a = 0; a < kInFlight; ++a)
        e[a] = s0 + a < nb ? load(g0 + (b0 + s0 + a) * THREADS)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int a = 0; a < kInFlight; ++a) {
        const float t = lane_tree(sq(e[a]));
        if (lane == 0 && s0 + a < nb) part[s0 + a][warp] = t;
      }
    }
    __syncthreads();
    if (warp == 0) {
      float w[kWarps];
#pragma unroll
      for (int i = 0; i < kWarps; ++i) w[i] = lane < nb ? part[lane][i] : 0.0f;
#pragma unroll
      for (int step = 1; step < kWarps; step <<= 1)
#pragma unroll
        for (int i = 0; i + step < kWarps; i += 2 * step) w[i] += w[i + step];
      float v = w[0];
      if (kSegs == 2) v += __shfl_xor_sync(FULL, v, 1);
      if (lane < nb && lane % kSegs == 0) units[(b0 + lane) / kSegs] = v;
    }
    __syncthreads();
  }
}

// group g's four floats of a row of n (zeros past n): 16-byte loads where
// `Vec` (n a multiple of 4, the row 16-byte aligned), else four
template <bool Vec>
__device__ __forceinline__ float4 load_group(const float* __restrict__ row,
                                             long long n, long long g) {
  const long long i = 4 * g;
  if (Vec)
    return i < n ? __ldg(reinterpret_cast<const float4*>(row) + g)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float e[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) e[q] = i + q < n ? __ldg(row + i + q) : 0.0f;
  return make_float4(e[0], e[1], e[2], e[3]);
}

// Warp-wide (call from one whole warp): the tree over a row's `count`
// unit sums, unit j read by unit(j).  Lane l takes L = max(1, P / 32)
// adjacent units (P: count rounded up to a power of two) and adds them by
// the tree (a binary counter), then the lanes' sums meet in lane_tree.
template <typename Unit>
__device__ __forceinline__ float units_tree(long long count, Unit unit) {
  long long P = 1;
  while (P < count) P <<= 1;
  const long long L = P > 32 ? P / 32 : 1;
  const long long j0 = (threadIdx.x & 31) * L;
  float stack[40];
  int top = 0;
  for (long long i = 0; i < L; ++i) {
    float v = j0 + i < count ? unit(j0 + i) : 0.0f;
    int lvl = 0;
    for (long long c = i; c & 1; c >>= 1) v = stack[lvl++] + v;
    stack[lvl] = v;
    top = lvl;
  }
  return lane_tree(stack[top]);
}

}  // namespace qs
