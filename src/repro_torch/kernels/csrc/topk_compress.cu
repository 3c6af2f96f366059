// topk_compress: bisection-threshold Top_k of each row of an
// error-compensated accumulator, with the optional SignTop_k scale and
// the fused error memory.
//
// Replaces the TPU kernel src/repro/kernels/topk_compress.py
// (topk_compress -> _kernel, _bisect_threshold).  Per row of acc
// [rows, n] float32:
//   hi = max|acc|, lo = 0; 24 rounds of mid = 0.5f*(lo+hi) and an int32
//   count of |acc| >= mid (count > k raises lo, else lowers hi);
//   thr = count(|acc| >= hi) >= k ? hi : lo;
//   mask = |acc| >= thr && |acc| > 0;  cnt = sum(mask)
//   sel = mask ? acc : 0, or with sign: mask ? sign(acc)*||sel||_2/max(cnt,1) : 0
//   mem = acc - sel
// This is repro's survivor rule, not torch.topk's: it decides the
// wire-bit ledger, so the counts must agree exactly.
//
// What bounds it on an H100: memory.  The function must read each
// element once and write two (sel, mem): 12 bytes per element, against
// about 2 x 26 compare-and-add operations per element, well below the
// card's float32 rate per byte.  A serial bisection reads the row 26
// times, so the row must stay on chip (in registers or L2).  Two
// designs, by row length:
//
// - Rows of up to 12,288 floats (the main path's RowTopK rows are 4096,
//   gemma3-1b's 1152): the row stays in registers, a warp a row up to 2048
//   floats (36 a lane at 1152; eight rows a block, no block barrier), else
//   a block of 4, 8 or 12 warps a row (32 floats a thread at 4096).  The
//   threshold is common.cuh's select_threshold: the serial loop's 24
//   rounds need only a(1), a(k) and a(k+1), the largest, k-th and (k+1)-th
//   largest |x|, so these are selected exactly (a radix select on the
//   bits of |x|, a 256-bin shared-memory histogram of the next 8 bits per
//   pass, usually ending after two by a max or min over the bin) and the
//   rounds are replayed on each thread in the same float32 operations.
//   Counts are integer sums, so the threshold is the plain version's bit
//   for bit.  No block barrier stands between the passes of a warp's row,
//   and a block's row takes about 8 (26 block reductions bounded the time
//   of a bisection over a block's shared memory, PERF.md).
// - Longer rows (up to dispatch's max_row, 512Ki floats = 2 MiB, from
//   the global TopK operator) do not fit one SM: each row is spread over
//   a thread-block cluster of CS = 8 or 16 blocks (the wrapper picks,
//   kernels/topk_compress.py:cluster_geometry), each block owning a
//   contiguous chunk.  One pass finds the chunk's max and how many
//   elements equal it; then each counting pass takes kLevels = 3
//   bisection levels at once: from (lo, hi) the next three levels of
//   mids form a tree of 7 floats, each computed with the serial
//   expression 0.5f*(lo+hi) from its own (lo, hi), so each is the float
//   the serial loop would reach.  One pass counts |x| >= mid for all of
//   them; the blocks publish their integer counts in their own shared
//   memory, cluster-sync, read every block's counts through distributed
//   shared memory (one load per thread, all ranks at once), and each
//   walks the levels to the same new (lo, hi): 24 rounds take 8 passes.
//   Only elements in [lo, hi) are compared against the tree: every mid
//   lies in [lo, hi], so an element at or above hi counts for every mid
//   (its count, count(|x| >= hi), is known from the walk) and one below
//   lo for none.  After the first pass few elements are left in the
//   band, and the second pass lists their magnitudes in shared memory (a
//   quarter of the chunk, at most 8192); bands only shrink, so while the
//   list held the whole band the later passes read it alone.  The chunk
//   itself is read four times (max, the first two passes, the output),
//   from L2 after the first (ResNet-50's 16 rows of 2 MiB fit the 50 MB
//   L2): staging it in shared memory instead allowed one block an SM
//   and took 1.25x as long at [16, 524288] (PERF.md).  Where hi exceeds
//   FLT_MAX / 2, lo + hi may overflow to a mid above hi, and the row is
//   counted in full instead.  The final count(|x| >= hi) is then known
//   without a pass.  Integer sums are order-free, so the threshold is
//   bit-identical to the plain version.  The SignTop_k norm is a float
//   sum in the one order common.cuh's unit_sums / units_tree give
//   (kernels/ref.py:tree_sq_ref over the survivors): the row's units of
//   2048 floats split over the blocks, each unit summed by a fixed tree,
//   all the units then added by the same tree in every block, so the
//   scale is one float at either cluster size (the tuner's choice,
//   kernels/autotune.py) and differs from the plain version's only by
//   the order of its sum.
//   Cluster barriers are hardware: no scratch, no ticket, one launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr long long kShortMaxElems = 12288;  // longer rows take a cluster

// Rows of up to kShortMaxElems floats: RW warps a row (RW = 1: eight rows
// a block, no block barrier), the row in registers, V4 float4s a thread;
// the load and the threshold are common.cuh's row_threshold (a(1), then
// select_threshold), shared with topk_compact.  Slot (j, q) of thread
// t holds element 4 (j T + t) + q (`vec`: 16-byte loads) or (4 j + q) T +
// t, T = 32 RW; slots past n hold NaN, which no count sees.
template <int RW, int V4>
__global__ void __launch_bounds__(RW == 1 ? 256 : RW * 32)
topk_rows_kernel(const float* __restrict__ acc, float* __restrict__ sel,
                 float* __restrict__ mem, int* __restrict__ cnt_out,
                 long long rows, long long n, int k, int iters, int sign,
                 int vec) {
  constexpr int kGroups = RW == 1 ? 8 : 1;  // rows a block
  constexpr int T = RW * 32;                // threads a row
  __shared__ __align__(16) int hist[kGroups][3][256];
  __shared__ int iscr[2][RW];
  __shared__ unsigned uscr[2][RW];
  __shared__ float fscr[2][RW];
  const int grp = RW == 1 ? static_cast<int>(threadIdx.x >> 5) : 0;
  const int t = static_cast<int>(threadIdx.x) % T;
  const long long row = static_cast<long long>(blockIdx.x) * kGroups + grp;
  if (row >= rows) return;  // uniform across the row's group
  const float* __restrict__ src = acc + row * n;
  auto index = [&](int j, int q) -> long long {
    return vec ? 4LL * (j * T + t) + q : (4LL * j + q) * T + t;
  };
  const float nan = __uint_as_float(0x7fc00000u);
  auto load = [&](int j) -> float4 {
    if (vec) {
      const long long i = index(j, 0);
      return i < n ? __ldg(reinterpret_cast<const float4*>(src + i))
                   : make_float4(nan, nan, nan, nan);
    }
    float e[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long i = index(j, q);
      e[q] = i < n ? __ldg(src + i) : nan;
    }
    return make_float4(e[0], e[1], e[2], e[3]);
  };
  qs::RowGroup<RW> g{iscr, uscr, fscr, 0};
  float4 v[V4];
  const float thr = qs::row_threshold<RW>(load, v, k, iters, hist[grp], g);

  auto kept = [&](float x) {
    const float a = fabsf(x);
    return a >= thr && a > 0.0f;
  };
  float* __restrict__ sel_r = sel + row * n;
  float* __restrict__ mem_r = mem + row * n;
  auto write = [&](float scale) {
    auto out = [&](float x) {
      return kept(x) ? (sign ? qs::sign_of(x) * scale : x) : 0.0f;
    };
#pragma unroll
    for (int j = 0; j < V4; ++j) {
      if (vec) {
        const long long i = index(j, 0);
        if (i < n) {
          const float4 s = make_float4(out(v[j].x), out(v[j].y),
                                       out(v[j].z), out(v[j].w));
          *reinterpret_cast<float4*>(sel_r + i) = s;
          *reinterpret_cast<float4*>(mem_r + i) = make_float4(
              v[j].x - s.x, v[j].y - s.y, v[j].z - s.z, v[j].w - s.w);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const long long i = index(j, q);
          if (i < n) {
            const float x = qs::comp(v[j], q);
            const float s = out(x);
            sel_r[i] = s;
            mem_r[i] = x - s;
          }
        }
      }
    }
  };
  int c = 0;
  float sq = 0.0f;
  qs::each4(v, [&](float x) {
    if (kept(x)) {
      c += 1;
      sq += x * x;
    }
  });
  if (!sign) write(0.0f);
  const int cnt = g.sum(c);
  // a row of one float: its magnitude, exactly (ref.sign_norm); x * x
  // would overflow past 1.8e19.  n is uniform, so the group's sum is too
  const float norm = n == 1 ? fabsf(__ldg(src)) : sqrtf(g.fsum(sq));
  // repro computes sign(acc) * norm / denom; sign * norm is exact, so
  // (sign * norm) / denom == sign * (norm / denom) bit for bit
  if (sign) write(norm / fmaxf(static_cast<float>(cnt), 1.0f));
  if (t == 0) cnt_out[row] = cnt;
}

template <int RW, int V4>
int launch_rows(const float* acc, float* sel, float* mem, int* cnt,
                long long rows, long long n, int k, int iters, int sign,
                int vec, cudaStream_t st) {
  const unsigned blocks =
      static_cast<unsigned>(RW == 1 ? (rows + 7) / 8 : rows);
  topk_rows_kernel<RW, V4><<<blocks, RW == 1 ? 256 : RW * 32, 0, st>>>(
      acc, sel, mem, cnt, rows, n, k, iters, sign, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// long rows: one thread-block cluster per row
// ---------------------------------------------------------------------------

constexpr int kLevels = 3;                    // bisection levels a pass
constexpr int kMids = (1 << kLevels) - 1;     // mids of one pass's tree
constexpr int kMaxCluster = 16;
// chunks up to this many floats take 256-thread blocks (four an SM),
// longer ones 512-thread blocks (two an SM)
constexpr int kSmallChunk = 8192;
// lo + hi cannot overflow while hi <= FLT_MAX / 2
constexpr float kNoOverflow = 0x1.fffffep+126f;

// floats of the band list a block keeps in shared memory
__host__ __device__ constexpr int band_cap(long long chunk) {
  return chunk / 4 > 8192 ? 8192 : (chunk / 4 < 256 ? 256 : chunk / 4);
}
// the most units of the SignTop_k tree a block of `chunk` floats takes:
// ceil(ceil(n / 2048) / cs) <= ceil(chunk / 2048), as cs * chunk >= n
__host__ __device__ constexpr long long units_cap(long long chunk) {
  return (chunk + qs::kTreeUnit - 1) / qs::kTreeUnit;
}

// sum / max over groups of W consecutive lanes (every lane of a group
// leaves with its group's result); a fixed tree, so deterministic
template <int W, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(qs::FULL, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(qs::FULL, v, off));
  return v;
}

// Calls f4(i, float4) on the groups of four and f1(i, float) on the rest
// of a block's chunk, 16-byte loads where `vec`; i is the index within
// the chunk.
template <int THREADS, typename F4, typename F1>
__device__ __forceinline__ void visit_chunk(const float* __restrict__ src,
                                            int len, bool vec, F4 f4,
                                            F1 f1) {
  const int tid = threadIdx.x;
  int i0 = 0;
  if (vec) {
    const int n4 = len >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (int i = tid; i < n4; i += THREADS) f4(4 * i, __ldg(g4 + i));
    i0 = 4 * n4;
  }
  for (int i = i0 + tid; i < len; i += THREADS) f1(i, __ldg(src + i));
}

// tallies |v| against the pass's tree of mids where it lies in the band
// [lo, hi) (or everywhere, `full`); returns whether it does
__device__ __forceinline__ bool tally(float v, bool full, float lo, float hi,
                                      const float (&mid)[kMids],
                                      int (&c)[kMids]) {
  const float a = fabsf(v);
  const bool in = full || (a >= lo && a < hi);
  if (in) {
#pragma unroll
    for (int j = 0; j < kMids; ++j) c[j] += a >= mid[j];
  }
  return in;
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
topk_cluster_kernel(const float* __restrict__ acc, float* __restrict__ sel,
                    float* __restrict__ mem, int* __restrict__ cnt_out,
                    long long n, long long chunk, int k, int iters,
                    int sign, int vec, long long ub) {
  constexpr int kWarps = THREADS / 32;
  // the transposed reductions below run on whole warps
  static_assert((kMids + 1) * kWarps % 32 == 0 &&
                (kMids + 1) * kMaxCluster % 32 == 0 &&
                (kMids + 1) * kMaxCluster <= THREADS, "reduction layout");
  // |x| of the band, from the second pass; then this block's units of
  // the SignTop_k tree, read by the cluster
  extern __shared__ float band[];
  __shared__ float part[32][kWarps];
  __shared__ int warp_i[kWarps][kMids + 1];
  __shared__ float warp_f[kWarps];
  // what a block publishes to the cluster, two rounds alternating: a
  // round's values are rewritten only after the next cluster barrier,
  // which every reader of the round passes only after reading them
  __shared__ int pub_i[2][kMids + 1];
  __shared__ float pub_f[2];
  __shared__ int tot_i[kMids + 1];
  __shared__ float tot_f;
  __shared__ int band_n;

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x / cs;
  const long long beg = min(n, rank * chunk);
  const int len = static_cast<int>(min(n, beg + chunk) - beg);
  const float* __restrict__ src = acc + row * n + beg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cap = band_cap(chunk);
  int buf = 0;
  if (tid == 0) band_n = 0;

  // pass 0: the chunk's max |x| and how many elements equal it
  float m = 0.0f;
  int meq = 0;
  auto see = [&](float v) {
    const float a = fabsf(v);
    if (a > m) {
      m = a;
      meq = 1;
    } else if (a == m) {
      meq += 1;
    }
  };
  visit_chunk<THREADS>(
      src, len, vec,
      [&](int, float4 v) {
        see(v.x);
        see(v.y);
        see(v.z);
        see(v.w);
      },
      [&](int, float v) { see(v); });
  {
    // |x| >= 0, so float order is the order of the bits
    const float mw = __uint_as_float(__reduce_max_sync(qs::FULL,
                                                       __float_as_uint(m)));
    const int cw = __reduce_add_sync(qs::FULL, m == mw ? meq : 0);
    if (lane == 0) {
      warp_f[warp] = mw;
      warp_i[warp][0] = cw;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const float mv = lane < kWarps ? warp_f[lane] : 0.0f;
    const float mb = warp_max(mv);
    const int cb = group_sum<32>(lane < kWarps && mv == mb
                                     ? warp_i[lane][0] : 0);
    if (lane == 0) {
      pub_f[buf] = mb;
      pub_i[buf][0] = cb;
    }
  }
  cluster.sync();
  if (warp == 0) {
    // lane r reads block r's (max, count) through distributed shared
    // memory, all ranks at once
    float mv = 0.0f;
    int cv = 0;
    if (lane < cs) {
      mv = *cluster.map_shared_rank(&pub_f[buf], lane);
      cv = *cluster.map_shared_rank(&pub_i[buf][0], lane);
    }
    const float mc = warp_max(mv);
    const int cc = group_sum<32>(mv == mc ? cv : 0);
    if (lane == 0) {
      tot_f = mc;
      tot_i[0] = cc;
    }
  }
  __syncthreads();
  buf ^= 1;

  float lo = 0.0f, hi = tot_f;
  int cnt_hi = tot_i[0];  // count(|x| >= hi)
  const bool full = !(hi <= kNoOverflow);

  for (int pass = 0, done = 0; done < iters; ++pass, done += kLevels) {
    // the pass's tree: node j's children 2j+1 (hi = mid) and 2j+2
    // (lo = mid), each mid from its own (lo, hi) as the serial loop has it
    float mid[kMids], nlo[kMids], nhi[kMids];
    nlo[0] = lo;
    nhi[0] = hi;
#pragma unroll
    for (int j = 0; j < kMids; ++j) {
      mid[j] = 0.5f * (nlo[j] + nhi[j]);
      if (2 * j + 2 < kMids) {
        nlo[2 * j + 1] = nlo[j];
        nhi[2 * j + 1] = mid[j];
        nlo[2 * j + 2] = mid[j];
        nhi[2 * j + 2] = nhi[j];
      }
    }
    int c[kMids];
#pragma unroll
    for (int j = 0; j < kMids; ++j) c[j] = 0;
    // The second pass also lists the |x| in its band; bands only shrink,
    // so while the list held them all, later passes read the list alone.
    // (Its order is the atomics' and varies; the counts do not.)
    const bool build = pass == 1 && !full;
    if (pass >= 2 && !full && band_n <= cap) {
      for (int i = tid; i < band_n; i += THREADS)
        tally(band[i], false, lo, hi, mid, c);
    } else {
      auto note = [&](float v) {
        if (tally(v, full, lo, hi, mid, c) && build) {
          const int at = atomicAdd(&band_n, 1);
          if (at < cap) band[at] = fabsf(v);
        }
      };
      visit_chunk<THREADS>(
          src, len, vec,
          [&](int, float4 v) {
            note(v.x);
            note(v.y);
            note(v.z);
            note(v.w);
          },
          [&](int, float v) { note(v); });
    }
#pragma unroll
    for (int j = 0; j < kMids; ++j) {
      const int s = __reduce_add_sync(qs::FULL, c[j]);
      if (lane == 0) warp_i[warp][j] = s;
    }
    __syncthreads();
    if (tid < (kMids + 1) * kWarps) {
      // thread j * kWarps + w adds warp w's count of mid j
      const int j = tid / kWarps, w = tid % kWarps;
      const int s = group_sum<kWarps>(j < kMids ? warp_i[w][j] : 0);
      if (w == 0 && j < kMids) pub_i[buf][j] = s;
    }
    cluster.sync();
    if (tid < (kMids + 1) * kMaxCluster) {
      // thread j * 16 + r reads block r's count of mid j: all at once
      const int j = tid / kMaxCluster, r = tid % kMaxCluster;
      const int s = group_sum<kMaxCluster>(
          j < kMids && r < cs ? cluster.map_shared_rank(&pub_i[buf][0], r)[j]
                              : 0);
      if (r == 0 && j < kMids) tot_i[j] = s;
    }
    __syncthreads();
    buf ^= 1;
    // walk the levels this pass has (the last pass may have fewer)
    const int levels = min(kLevels, iters - done);
    const int base = full ? 0 : cnt_hi;
    int node = 0;
    for (int l = 0; l < levels; ++l) {
      const float md = 0.5f * (lo + hi);
      const int cm = base + tot_i[node];
      if (cm > k) {
        lo = md;
        node = 2 * node + 2;
      } else {
        hi = md;
        cnt_hi = cm;
        node = 2 * node + 1;
      }
    }
  }
  const float thr = cnt_hi >= k ? hi : lo;

  // survivors: their count (and SignTop_k's sum of squares) over the
  // cluster, and the outputs
  float* __restrict__ sel_c = sel + row * n + beg;
  float* __restrict__ mem_c = mem + row * n + beg;
  auto out_of = [&](float v, float scale) -> float {
    const float a = fabsf(v);
    if (!(a >= thr && a > 0.0f)) return 0.0f;
    return sign ? qs::sign_of(v) * scale : v;
  };
  auto write = [&](int i, float v, float scale) {
    const float s = out_of(v, scale);
    sel_c[i] = s;
    mem_c[i] = v - s;
  };
  auto write4 = [&](int i, float4 v, float scale) {
    const float4 s = make_float4(out_of(v.x, scale), out_of(v.y, scale),
                                 out_of(v.z, scale), out_of(v.w, scale));
    *reinterpret_cast<float4*>(sel_c + i) = s;
    *reinterpret_cast<float4*>(mem_c + i) =
        make_float4(v.x - s.x, v.y - s.y, v.z - s.z, v.w - s.w);
  };
  int cs_cnt = 0;
  auto keep = [&](float v) {
    const float a = fabsf(v);
    if (a >= thr && a > 0.0f) cs_cnt += 1;
  };
  // SignTop_k: the count and the survivors' squares over the row's units
  // (the tree's order), which the scale waits for
  const long long units = (n + qs::kTreeUnit - 1) / qs::kTreeUnit;
  float* __restrict__ my_units = band + cap;
  if (sign) {
    const float* __restrict__ row_src = acc + row * n;
    auto kept = [&](float v) {
      const float a = fabsf(v);
      const bool in = a >= thr && a > 0.0f;
      cs_cnt += in;
      return in ? v : 0.0f;
    };
    const long long u0 = min(units, rank * ub), u1 = min(units, u0 + ub);
    auto sq = [&](const float4& e) {
      return qs::group_sq(kept(e.x), kept(e.y), kept(e.z), kept(e.w));
    };
    if (vec)
      qs::unit_sums<THREADS>(
          u0, u1,
          [&](long long g) { return qs::load_group<true>(row_src, n, g); },
          sq, part, my_units);
    else
      qs::unit_sums<THREADS>(
          u0, u1,
          [&](long long g) { return qs::load_group<false>(row_src, n, g); },
          sq, part, my_units);
  } else {
    // no scale to wait for: count while writing
    visit_chunk<THREADS>(
        src, len, vec,
        [&](int i, float4 v) {
          keep(v.x);
          keep(v.y);
          keep(v.z);
          keep(v.w);
          write4(i, v, 0.0f);
        },
        [&](int i, float v) {
          keep(v);
          write(i, v, 0.0f);
        });
  }
  {
    const int cw = __reduce_add_sync(qs::FULL, cs_cnt);
    if (lane == 0) warp_i[warp][0] = cw;
  }
  __syncthreads();
  if (warp == 0) {
    const int cb = group_sum<32>(lane < kWarps ? warp_i[lane][0] : 0);
    if (lane == 0) pub_i[buf][0] = cb;
  }
  cluster.sync();
  if (warp == 0) {
    const int cv = lane < cs ? *cluster.map_shared_rank(&pub_i[buf][0], lane)
                             : 0;
    const int cc = group_sum<32>(cv);
    float sc = 0.0f;
    if (sign)
      sc = qs::units_tree(units, [&](long long j) {
        return cluster.map_shared_rank(band + cap,
                                       static_cast<int>(j / ub))[j % ub];
      });
    if (lane == 0) {
      tot_i[0] = cc;
      tot_f = sc;
      if (rank == 0) cnt_out[row] = cc;
    }
  }
  // no block may leave while another still reads its shared memory
  cluster.sync();
  if (sign) {
    const int cnt = tot_i[0];
    const float norm = sqrtf(tot_f);
    const float scale = norm / fmaxf(static_cast<float>(cnt), 1.0f);
    visit_chunk<THREADS>(
        src, len, vec,
        [&](int i, float4 v) { write4(i, v, scale); },
        [&](int i, float v) { write(i, v, scale); });
  }
}

// The kernel's launch for rows of `chunk`-float chunks: its block size
// (256 threads for a short chunk, four blocks an SM; 512 for a long one,
// two an SM), shared memory (the band list) and cluster size, with the
// attributes set that a cluster of 16 and the shared memory need.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const void* fn;
};

int cluster_launch(ClusterLaunch& l, long long rows, int cs, long long chunk,
                   cudaStream_t st) {
  const long long floats = band_cap(chunk) + units_cap(chunk);
  if (floats * static_cast<long long>(sizeof(float)) > 232448 - 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(floats * sizeof(float));
  const bool small = chunk <= kSmallChunk;
  l = {};
  l.fn = small ? reinterpret_cast<const void*>(topk_cluster_kernel<256>)
               : reinterpret_cast<const void*>(topk_cluster_kernel<512>);
  cudaError_t err = cudaFuncSetAttribute(
      l.fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  l.cfg.gridDim = dim3(static_cast<unsigned>(rows * cs));
  l.cfg.blockDim = dim3(small ? 256 : 512);
  l.cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  l.cfg.stream = st;
  l.attr.id = cudaLaunchAttributeClusterDimension;
  l.attr.val.clusterDim.x = static_cast<unsigned>(cs);
  l.attr.val.clusterDim.y = 1;
  l.attr.val.clusterDim.z = 1;
  l.cfg.attrs = &l.attr;
  l.cfg.numAttrs = 1;
  return static_cast<int>(err);
}

}  // namespace

// Rows of up to 12,288 floats: a warp a row up to 2048 floats, else a
// block of 4, 8 or 12 warps (up to 4096, 8192, 12288 floats).
extern "C" int qs_topk_compress_f32(const float* acc, float* sel, float* mem,
                                    int* cnt, long long rows, long long n,
                                    int k, int iters, int sign,
                                    void* stream) {
  if (rows <= 0) return 0;
  if (n > kShortMaxElems) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(acc) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(sel) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(mem) % 16 == 0;
#define QS_ROWS(RW, V4) \
  launch_rows<RW, V4>(acc, sel, mem, cnt, rows, n, k, iters, sign, vec, st)
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

// Longer rows: a cluster of cs (8 or 16) blocks per row, block r owning
// elements [r * chunk, (r + 1) * chunk) (chunk a multiple of 4, cs *
// chunk >= n, no block empty).
extern "C" int qs_topk_compress_cluster_f32(const float* acc, float* sel,
                                            float* mem, int* cnt,
                                            long long rows, long long n,
                                            int k, int iters, int sign,
                                            int cs, long long chunk,
                                            void* stream) {
  if (rows <= 0) return 0;
  if ((cs != 8 && cs != 16) || chunk <= 0 || chunk % 4 ||
      static_cast<long long>(cs) * chunk < n || (cs - 1) * chunk >= n ||
      chunk > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  ClusterLaunch l;
  const int err =
      cluster_launch(l, rows, cs, chunk, static_cast<cudaStream_t>(stream));
  if (err) return err;
  // 16-byte loads and stores where every chunk starts on a 16-byte
  // boundary of all three rows
  int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(acc) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(sel) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(mem) % 16 == 0;
  // units of the SignTop_k tree a block: ceil(ceil(n / 2048) / cs)
  long long ub = ((n + qs::kTreeUnit - 1) / qs::kTreeUnit + cs - 1) / cs;
  void* args[] = {&acc, &sel, &mem, &cnt, &n, &chunk, &k, &iters, &sign,
                  &vec, &ub};
  const cudaError_t e = cudaLaunchKernelExC(&l.cfg, l.fn, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of cs blocks, each owning `chunk` floats, the card
// holds at once (cudaOccupancyMaxActiveClusters; 0: such a cluster does
// not schedule), or minus a cudaError_t.
extern "C" int qs_topk_cluster_capacity(int cs, long long chunk) {
  if (cs < 1 || cs > kMaxCluster || chunk <= 0)
    return -static_cast<int>(cudaErrorInvalidValue);
  ClusterLaunch l;
  const int err = cluster_launch(l, cs, cs, chunk, nullptr);
  if (err) return -err;
  int clusters = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, l.fn,
                                                       &l.cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused size is an answer, not a sticky fault
    return e == cudaErrorInvalidClusterSize ? 0 : -static_cast<int>(e);
  }
  return clusters;
}
