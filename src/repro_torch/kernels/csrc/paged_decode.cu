// paged_decode: single-token GQA decode attention over a shared KV page
// pool, read through per-request block tables, split over the pages.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (paged_decode_fwd -> _paged_kernel).  Inputs: q [B, 1, H, hd]; the pool
// kp/vp [n_pages, ps, KV, hd] (float32 or bfloat16 like q, or int8 levels
// with per-token-slot f32 scales ks/vs [n_pages, ps]); tables [B, P] int32
// (-1 = unallocated, clamped to page 0: such entries only cover positions
// at or past the row's length); lengths [B] int32.  Output [B, 1, H, hd]
// in q's type.  Slot t of logical page j holds position j * ps + t, and a
// position is live iff it is below the row's length.
//
// What it computes is the TPU kernel's masked softmax: q pre-scaled by
// hd^-0.5 in float32, dead positions masked on the score and on p itself,
// so that a dead position adds exactly 0, a part with no live position
// has l = 0 and o = 0, and a row of length 0 writes exact zeros (o / max(l,
// 1e-30) with o = l = 0).  This differs from flash_decode, whose masked
// slots keep p = exp(-1e30 - m) and give a row with no valid slot the
// uniform average of V.
//
// What bounds it on an H100: the bytes of the live K and V pages (2 bytes
// an element in bf16, 1 in int8), about 0.3-0.5 us at Yi-6B's batch 8.  On
// the TPU the block table rides in as scalar prefetch, BlockSpec index
// maps gather the pages and the grid walks a row's pages in order.  One
// block per (row, kv head) gave 32 blocks on 132 SMs at Yi-6B's batch 8,
// so the row's pages are split, as flash_decode splits its cache:
//
// - Grid (split, kv head x head group, row).  A block takes `pb`
//   consecutive logical pages of one row (pages_per_block, the wrapper's
//   geometry; 64 positions at pb = 4, ps = 16) and up to GT of the
//   group's G query heads (the wrapper takes GT <= 4: Yi-6B's 8 heads a
//   group in two blocks, so that 8 positions fit in flight).  It reads
//   its own table entries.  Only the row's live splits, the first
//   max(1, ceil(length / (pb * ps))), do work: a block past them exits at
//   once, and no position at or past the length is read.
// - A group of LPS lanes reads one position's K row and V row (16-byte
//   loads of float32 or bfloat16, 8-byte loads of int8 levels, at
//   ((page * ps + slot) * KV + h) * hd, hd contiguous), 2-8 positions in
//   flight; each lane keeps its slice of the pre-scaled query rows in
//   registers and the scores are finished by shuffles in the group (an
//   int8 score and p times the slot's scale once, not per element).
// - Each lane group keeps a running (m, l, o) in float32 registers; the
//   groups of a warp, then the warps (through shared memory), are merged
//   with the log-sum-exp rescaling.
// - One live split: the block writes the output.  Several: each writes
//   its partial (m, l, o) to scratch the wrapper allocated and takes a
//   ticket from a per-(row, kv head, head group) counter; the last of the
//   live splits merges them (weights in chunks through shared memory, so
//   any number of splits), writes the output and resets the counter.
//   One device launch per call.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMergeChunk = 64;   // splits whose weights the merge stages
constexpr float kNegInf = -1e30f;

template <typename TP>
struct PoolVec {
  using type = uint4;  // 16 bytes: 4 float32 or 8 bfloat16
};
template <>
struct PoolVec<int8_t> {
  using type = uint2;  // 8 bytes: 8 int8 levels
};

// T: float or __nv_bfloat16 (q, out); TP: T or int8_t (the pool); GT:
// query heads a block serves; NV: vectors of a position's row each lane
// reads.
template <typename T, typename TP, int GT, int NV>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const TP* __restrict__ kp,
                    const TP* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_o, int* __restrict__ tickets,
                    int H, int KV, int hd, int n_pages, int ps, int P,
                    int pb, int lps, float scale) {
  using Vec = typename PoolVec<TP>::type;
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  constexpr int kEpv = sizeof(Vec) / sizeof(TP);  // elements of a vector
  constexpr int kE = NV * kEpv;                   // elements a lane holds
  // positions a lane group has in flight: as many (up to 8) as the
  // registers left beside the running state (2 GT kE floats) allow, each
  // costing its K and V vectors and its GT scores
  constexpr int kVecRegs = sizeof(Vec) / 4;
  constexpr int kFree = (160 - 2 * GT * kE) / (2 * kVecRegs * NV + GT);
  constexpr int kU = kFree >= 8 ? 8 : (kFree >= 4 ? 4 : 2);
  extern __shared__ __align__(16) float smem[];
  float* o_s = smem;                         // [kWarps][GT][hd]
  float* m_s = o_s + kWarps * GT * hd;       // [kWarps][GT]
  float* l_s = m_s + kWarps * GT;            // [kWarps][GT]
  float* w_s = l_s + kWarps * GT;            // [kMergeChunk][GT]
  float* mt_s = w_s + kMergeChunk * GT;      // [GT]
  float* lt_s = mt_s + GT;                   // [GT]
  __shared__ int last_s;

  const int split = blockIdx.x;
  const int hgroups = gridDim.y / KV;
  const int kvh = blockIdx.y / hgroups, hg = blockIdx.y % hgroups;
  const int b = blockIdx.z;
  const int span = pb * ps;                  // positions a split covers
  const int len = min(max(lengths[b], 0), P * ps);
  const int n_live = min(static_cast<int>(gridDim.x),
                         max(1, (len + span - 1) / span));
  if (split >= n_live) return;               // no live position here

  const int G = H / KV;
  const int g0 = kvh * G + hg * GT;            // first query head served
  const int n_heads = min(GT, G - hg * GT);    // heads served
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nvec = hd / kEpv;                  // vectors in a position's row
  const int gl = lane % lps, grp = lane / lps;
  const int groups = kWarps * (32 / lps);      // lane groups in the block
  const int my_group = warp * (32 / lps) + grp;
  const int c0 = split * span, c1 = min(len, c0 + span);  // live positions

  // this lane's slice of the pre-scaled query rows
  float qr[GT][kE];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vec = gl + lps * i;
#pragma unroll
      for (int e = 0; e < kEpv; ++e) {
        const int d = vec * kEpv + e;
        qr[g][i * kEpv + e] =
            g < n_heads && vec < nvec
                ? qs::to_f32(q[(static_cast<long long>(b) * H + g0 + g) * hd +
                               d]) * scale
                : 0.0f;
      }
    }
  }

  float m[GT], l[GT], o[GT][kE];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < kE; ++e) o[g][e] = 0.0f;
  }

  const int* row_table = tables + static_cast<long long>(b) * P;

  // every lane runs every iteration (the shuffles need the whole warp); a
  // position past the live ones is read from nowhere and weighs nothing
  for (int base = c0; base < c1; base += kU * groups) {
    Vec kb[kU][NV], vb[kU][NV];
    bool in[kU];
    float ksc[kU], vsc[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int s = base + u * groups + my_group;
      in[u] = s < c1;
      long long row = 0;
      if (in[u]) {
        const int j = s / ps;
        const int page = min(max(__ldg(row_table + j), 0), n_pages - 1);
        row = static_cast<long long>(page) * ps + (s - j * ps);
      }
      ksc[u] = kQuant && in[u] ? __ldg(ks + row) : 1.0f;
      vsc[u] = kQuant && in[u] ? __ldg(vs + row) : 1.0f;
      const long long off = (row * KV + kvh) * hd;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vec = gl + lps * i;
        if (in[u] && vec < nvec) {
          kb[u][i] = *reinterpret_cast<const Vec*>(kp + off + vec * kEpv);
          vb[u][i] = *reinterpret_cast<const Vec*>(vp + off + vec * kEpv);
        } else {
          kb[u][i] = Vec{};
          vb[u][i] = Vec{};
        }
      }
    }
    float sc[kU][GT];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int g = 0; g < GT; ++g) sc[u][g] = 0.0f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float kf[kEpv];
        qs::unpack(kb[u][i], kf);
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int e = 0; e < kEpv; ++e)
            sc[u][g] = fmaf(qr[g][i * kEpv + e], kf[e], sc[u][g]);
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      if (off >= lps) break;
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int g = 0; g < GT; ++g)
          sc[u][g] += __shfl_xor_sync(qs::FULL, sc[u][g], off);
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        sc[u][g] = in[u] ? sc[u][g] * ksc[u] : kNegInf;
        mx = fmaxf(mx, sc[u][g]);
      }
      const float alpha = expf(m[g] - mx);
      float p[kU];
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        p[u] = in[u] ? expf(sc[u][g] - mx) : 0.0f;  // dead: exactly 0
        sum += p[u];
      }
      l[g] = l[g] * alpha + sum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < kE; ++e) o[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float pv = p[u] * vsc[u];
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          float vf[kEpv];
          qs::unpack(vb[u][i], vf);
#pragma unroll
          for (int e = 0; e < kEpv; ++e)
            o[g][i * kEpv + e] = fmaf(pv, vf[e], o[g][i * kEpv + e]);
        }
      }
    }
  }

  // merge the lane groups of the warp (lanes gl of every group hold the
  // same slice of the row); a group that saw no live position has m =
  // -1e30, l = 0, o = 0 and adds nothing
  for (int off = lps; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float ob[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e)
        ob[e] = __shfl_xor_sync(qs::FULL, o[g][e], off);
      const float mb = __shfl_xor_sync(qs::FULL, m[g], off);
      const float lb = __shfl_xor_sync(qs::FULL, l[g], off);
      qs::merge(m[g], l[g], o[g], mb, lb, ob);
    }
  }
  // then the warps of the block, through shared memory
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vec = gl + lps * i;
        if (vec < nvec) {
#pragma unroll
          for (int e = 0; e < kEpv; ++e)
            o_s[(warp * GT + g) * hd + vec * kEpv + e] = o[g][i * kEpv + e];
        }
      }
      if (gl == 0) {
        m_s[warp * GT + g] = m[g];
        l_s[warp * GT + g] = l[g];
      }
    }
  }
  __syncthreads();
  if (tid < GT) {
    float mt = kNegInf;
    for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, m_s[w * GT + tid]);
    float lt = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(m_s[w * GT + tid] - mt);
      w_s[w * GT + tid] = a;
      lt += l_s[w * GT + tid] * a;
    }
    mt_s[tid] = mt;
    lt_s[tid] = lt;
  }
  __syncthreads();

  if (n_live == 1) {
    for (int e = tid; e < n_heads * hd; e += kThreads) {
      const int g = e / hd, d = e % hd;
      float acc = 0.0f;
      for (int w = 0; w < kWarps; ++w)
        acc += o_s[(w * GT + g) * hd + d] * w_s[w * GT + g];
      out[(static_cast<long long>(b) * H + g0 + g) * hd + d] =
          qs::from_f32<T>(acc / fmaxf(lt_s[g], 1e-30f));
    }
    return;
  }

  // several live splits: publish this block's partial (16-byte stores:
  // hd is a multiple of 8), take a ticket
  const long long unit = static_cast<long long>(b) * gridDim.y + blockIdx.y;
  const long long first = unit * gridDim.x * GT;  // this unit's partials
  const int n4 = GT * hd / 4;
  float4* po4 = reinterpret_cast<float4*>(part_o + (first + split * GT) * hd);
  for (int e4 = tid; e4 < n4; e4 += kThreads) {
    const int e = 4 * e4, g = e / hd, d = e % hd;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int w = 0; w < kWarps; ++w) {
      const float a = w_s[w * GT + g];
      const float4 x =
          *reinterpret_cast<const float4*>(o_s + (w * GT + g) * hd + d);
      acc.x += x.x * a;
      acc.y += x.y * a;
      acc.z += x.z * a;
      acc.w += x.w * a;
    }
    po4[e4] = acc;
  }
  if (tid < GT) {
    part_m[first + split * GT + tid] = mt_s[tid];
    part_l[first + split * GT + tid] = lt_s[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(tickets + unit, 1) == n_live - 1;
  __syncthreads();
  if (!last_s) return;

  // the last live split of this (row, kv head, head group) merges them
  __threadfence();
  if (tid < GT) {
    float mt = kNegInf;
    for (int sp = 0; sp < n_live; ++sp)
      mt = fmaxf(mt, __ldcg(part_m + first + sp * GT + tid));
    float lt = 0.0f;
    for (int sp = 0; sp < n_live; ++sp)
      lt += __ldcg(part_l + first + sp * GT + tid) *
            expf(__ldcg(part_m + first + sp * GT + tid) - mt);
    mt_s[tid] = mt;
    lt_s[tid] = lt;
  }
  const float4* all4 = reinterpret_cast<const float4*>(part_o + first * hd);
  const int nout4 = n_heads * hd / 4;
  constexpr int kPer = (GT * 256 / 4 + kThreads - 1) / kThreads;
  float4 acc[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int s0 = 0; s0 < n_live; s0 += kMergeChunk) {
    const int ns = min(kMergeChunk, n_live - s0);
    __syncthreads();  // mt_s is ready; the previous chunk's weights used
    for (int i = tid; i < ns * GT; i += kThreads)
      w_s[i] = expf(__ldcg(part_m + first + s0 * GT + i) - mt_s[i % GT]);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int e4 = tid + r * kThreads;
      if (e4 < nout4) {
        const int g = 4 * e4 / hd;
#pragma unroll 8
        for (int sp = 0; sp < ns; ++sp) {
          const float4 x = __ldcg(all4 + (s0 + sp) * n4 + e4);
          const float a = w_s[sp * GT + g];
          acc[r].x += x.x * a;
          acc[r].y += x.y * a;
          acc[r].z += x.z * a;
          acc[r].w += x.w * a;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int e4 = tid + r * kThreads;
    if (e4 < nout4) {
      const int e = 4 * e4, g = e / hd, d = e % hd;
      const float den = fmaxf(lt_s[g], 1e-30f);
      T* dst = out + (static_cast<long long>(b) * H + g0 + g) * hd + d;
      dst[0] = qs::from_f32<T>(acc[r].x / den);
      dst[1] = qs::from_f32<T>(acc[r].y / den);
      dst[2] = qs::from_f32<T>(acc[r].z / den);
      dst[3] = qs::from_f32<T>(acc[r].w / den);
    }
  }
  if (tid == 0) tickets[unit] = 0;
}

template <typename T, typename TP, int GT, int NV>
int launch(const void* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* tables, const int* lengths, void* out,
           float* pm, float* pl, float* po, int* tickets, int B, int H,
           int KV, int hd, int n_pages, int ps, int P, int pb, int lps,
           float scale, cudaStream_t st) {
  const int G = H / KV;
  const int hgroups = (G + GT - 1) / GT;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kWarps) * GT * hd +
                       2 * kWarps * GT + kMergeChunk * GT + 2 * GT);
  auto kern = paged_decode_kernel<T, TP, GT, NV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + pb - 1) / pb, KV * hgroups, B);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), ks, vs, tables, lengths,
      static_cast<T*>(out), pm, pl, po, tickets, H, KV, hd, n_pages, ps, P,
      pb, lps, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TP, int NV>
int launch_g(int GT, const void* q, const void* kp, const void* vp,
             const float* ks, const float* vs, const int* tables,
             const int* lengths, void* out, float* pm, float* pl, float* po,
             int* tickets, int B, int H, int KV, int hd, int n_pages, int ps,
             int P, int pb, int lps, float scale, cudaStream_t st) {
  switch (GT) {
#define QS_PAGED_GT(n)                                                       \
  case n:                                                                    \
    return launch<T, TP, n, NV>(q, kp, vp, ks, vs, tables, lengths, out, pm, \
                                pl, po, tickets, B, H, KV, hd, n_pages, ps,  \
                                P, pb, lps, scale, st);
    QS_PAGED_GT(1)
    QS_PAGED_GT(2)
    QS_PAGED_GT(4)
    QS_PAGED_GT(8)
#undef QS_PAGED_GT
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_bf16: q (and an fp pool) is bfloat16 (1) or float32 (0); quant: the
// pool holds int8 levels with f32 slot scales ks / vs.  hd a multiple of 8
// up to 256; GT (query heads a block serves) 1, 2, 4 or 8; pb pages a
// split.  With more than one split (P > pb): part_m / part_l [B, KV,
// ceil(G / GT), splits, GT] and part_o [..., GT, hd] (16-byte aligned)
// float32 scratch and tickets [B * KV * ceil(G / GT)] int32, all zero.
extern "C" int qs_paged_decode(const void* q, const void* kp, const void* vp,
                               const float* ks, const float* vs,
                               const int* tables, const int* lengths,
                               void* out, float* part_m, float* part_l,
                               float* part_o, int* tickets, int B, int H,
                               int KV, int hd, int n_pages, int ps, int P,
                               int pb, int GT, float scale, int q_bf16,
                               int quant, void* stream) {
  if (B <= 0) return 0;
  if (hd % 8 != 0 || hd > 256 || pb < 1 || ps < 1 || P < 1 || n_pages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // lanes per position: the row's vectors over at most 32 lanes, a power
  // of two so that lane groups tile the warp
  const int nvec = hd / (quant ? 8 : (q_bf16 ? 8 : 4));
  const int nv = nvec > 32 ? 2 : 1;
  int lps = 1;
  while (lps * nv < nvec) lps <<= 1;
  const auto args = [&](auto launcher) {
    return launcher(GT, q, kp, vp, ks, vs, tables, lengths, out, part_m,
                    part_l, part_o, tickets, B, H, KV, hd, n_pages, ps, P,
                    pb, lps, scale, st);
  };
  if (q_bf16 && quant)
    return args(launch_g<__nv_bfloat16, int8_t, 1>);
  if (q_bf16) return args(launch_g<__nv_bfloat16, __nv_bfloat16, 1>);
  if (quant) return args(launch_g<float, int8_t, 1>);
  return nv == 2 ? args(launch_g<float, float, 2>)
                 : args(launch_g<float, float, 1>);
}
