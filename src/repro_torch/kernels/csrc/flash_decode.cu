// flash_decode: single-token GQA decode attention over a ring KV cache
// under a slot-validity mask, split over the cache length
// (flash-decoding).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_decode_fwd -> _decode_kernel).  Inputs: q [B, 1, H, hd]; k, v
// [B, C, KV, hd] in q's type (float32 or bfloat16); valid [B, C] bytes,
// one mask per row (the TPU kernel takes one [C] mask for the batch,
// because repro's engine runs its slots one at a time; the port runs the
// slot batch at once).  Output [B, 1, H, hd] in q's type.
//
// What it computes is the TPU kernel's masked softmax: s = q.k with q
// pre-scaled by hd^-0.5 in float32, masked slots set to the finite
// -1e30, p = exp(s - max), o = (p @ v) / max(sum p, 1e-30).  A row with
// no valid slot gets the uniform average of V, as the TPU kernel's does.
//
// What bounds it on an H100: the bytes of K and V, 2 * C * KV * hd
// elements a row, which is 1-2 us at gemma3-1b's and Yi-6B's decode
// shapes.  The TPU kernel's block, one (row, kv head) with its whole
// [G, C] score tile on chip, gave B * KV blocks: 4 blocks on 132 SMs at
// gemma3-1b's batch 4, 0.61-1.37 ms a call (NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md).  So the cache is split:
//
// - Grid (split, kv head x head group, row).  Each block takes a
//   contiguous chunk of `chunk` slots of one (row, kv head) and up to GT
//   of its G query heads (GT = 8 covers every config; more heads take
//   more head groups).  The wrapper picks the split count so that the
//   grid holds about two waves of blocks of at least 64 slots
//   (flash_attention.decode_splits).
// - A group of LPS lanes reads one slot's K row and V row with 16-byte
//   loads, neighbouring lanes on neighbouring addresses, 2-8 slots ahead
//   (as many as the registers allow);
//   each lane keeps its slice of the G pre-scaled query rows in
//   registers and the G scores are finished by shuffles in the group.
// - Each lane group keeps a running (m, l, o[G, its slice]) in float32
//   registers (online softmax over its slots); the groups of a warp, then
//   the warps of the block (through shared memory), are merged with the
//   log-sum-exp rescaling.  No [G, C] tile exists anywhere, so the cache
//   length is bounded by nothing but the partial buffers.
// - One split: the block writes the output.  Several: each block writes
//   its partial (m, l, o) to scratch the wrapper allocated, takes a ticket
//   from a per-(row, kv head, head group) counter, and the last block to
//   finish merges the partials (all (m, l) in one round of loads, o in
//   16-byte loads, 8 splits in flight per thread), writes the output and
//   resets the counter to 0 for the next launch.  That keeps one device launch per call:
//   the decode step is host-bound once this kernel is fast, so a second
//   combine kernel would add a launch to every layer of every step.
// Measured on the same card: 0.013 / 0.018 ms at gemma3-1b's 1024- and
// 2304-slot rings and 0.015 ms at Yi-6B's, against 0.015 / 0.028 /
// 0.031 ms for scaled_dot_product_attention (PERF.md).
//
// The finite -1e30 carries the TPU kernel's semantics through the split:
// a lane group, warp, block or split whose slots are all masked ends with
// m = -1e30 and l = its slot count; merged with anything live, its weight
// exp(-1e30 - M) is exactly 0, and merged only with other empty parts
// (a row with no valid slot) the weights are all exp(0) = 1, so the row
// gets sum(V) / C, the uniform average.  Parts that saw no slot at all
// carry l = 0 and o = 0 and add nothing either way.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 128;   // qs_flash_decode_max_splits
constexpr float kNegInf = -1e30f;

// T: float or __nv_bfloat16; GT: query heads a block serves; NV: 16-byte
// vectors of a slot row each lane reads (hd * sizeof(T) / 16 over the
// group's lanes, rounded up).
template <typename T, int GT, int NV>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const uint8_t* __restrict__ valid, T* __restrict__ out,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_o, int* __restrict__ tickets,
                    int H, int KV, int hd, int C, int chunk, int lps,
                    float scale) {
  constexpr int kEpv = 16 / sizeof(T);  // elements of one vector
  constexpr int kE = NV * kEpv;         // elements a lane holds of a row
  // slots a lane group has in flight: as many (up to 8) as the registers
  // left beside the running state (2 GT kE floats) allow, each costing
  // its K and V vectors (8 NV) and its GT scores
  constexpr int kFree = (160 - 2 * GT * kE) / (8 * NV + GT);
  constexpr int kU = kFree >= 8 ? 8 : (kFree >= 4 ? 4 : 2);
  extern __shared__ __align__(16) float smem[];
  float* o_s = smem;                         // [kWarps][GT][hd]
  float* m_s = o_s + kWarps * GT * hd;       // [kWarps][GT]
  float* l_s = m_s + kWarps * GT;            // [kWarps][GT]
  float* w_s = l_s + kWarps * GT;            // [kMaxSplits][GT]
  float* pl_s = w_s + kMaxSplits * GT;       // [kMaxSplits][GT]
  float* mt_s = pl_s + kMaxSplits * GT;      // [GT]
  float* lt_s = mt_s + GT;                   // [GT]
  __shared__ int last_s;

  const int splits = gridDim.x, split = blockIdx.x;
  const int hgroups = gridDim.y / KV;
  const int kvh = blockIdx.y / hgroups, hg = blockIdx.y % hgroups;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int g0 = kvh * G + hg * GT;            // first query head served
  const int n_heads = min(GT, G - hg * GT);    // heads served
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nvec = hd / kEpv;                  // vectors in a slot row
  const int gl = lane % lps, grp = lane / lps;
  const int groups = kWarps * (32 / lps);      // lane groups in the block
  const int my_group = warp * (32 / lps) + grp;
  const int c0 = split * chunk, c1 = min(C, c0 + chunk);

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

  const uint8_t* row_valid = valid + static_cast<long long>(b) * C;
  const long long kv_stride = static_cast<long long>(KV) * hd;
  const T* k_row = k + static_cast<long long>(b) * C * kv_stride +
                   static_cast<long long>(kvh) * hd;
  const T* v_row = v + static_cast<long long>(b) * C * kv_stride +
                   static_cast<long long>(kvh) * hd;

  // every lane runs every iteration (the shuffles need the whole warp);
  // a slot past the chunk is read from nowhere and weighs nothing
  for (int base = c0; base < c1; base += kU * groups) {
    uint4 kb[kU][NV], vb[kU][NV];
    bool in[kU], live[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int s = base + u * groups + my_group;
      in[u] = s < c1;
      live[u] = in[u] && row_valid[in[u] ? s : c0];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vec = gl + lps * i;
        if (in[u] && vec < nvec) {
          const long long off = s * kv_stride + vec * kEpv;
          kb[u][i] = *reinterpret_cast<const uint4*>(k_row + off);
          vb[u][i] = *reinterpret_cast<const uint4*>(v_row + off);
        } else {
          kb[u][i] = make_uint4(0, 0, 0, 0);
          vb[u][i] = make_uint4(0, 0, 0, 0);
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
        sc[u][g] = live[u] ? sc[u][g] : kNegInf;
        mx = fmaxf(mx, sc[u][g]);
      }
      const float alpha = expf(m[g] - mx);
      float p[kU];
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        p[u] = in[u] ? expf(sc[u][g] - mx) : 0.0f;
        sum += p[u];
      }
      l[g] = l[g] * alpha + sum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < kE; ++e) o[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          float vf[kEpv];
          qs::unpack(vb[u][i], vf);
#pragma unroll
          for (int e = 0; e < kEpv; ++e)
            o[g][i * kEpv + e] = fmaf(p[u], vf[e], o[g][i * kEpv + e]);
        }
      }
    }
  }

  // merge the lane groups of the warp (lanes gl of every group hold the
  // same slice of the row)
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

  const long long unit = static_cast<long long>(b) * gridDim.y + blockIdx.y;
  if (splits == 1) {
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

  // several splits: publish this block's partial (16-byte stores: hd is
  // a multiple of 8), take a ticket
  const long long first = unit * splits * GT;  // this unit's partials
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
  if (tid == 0) last_s = atomicAdd(tickets + unit, 1) == splits - 1;
  __syncthreads();
  if (!last_s) return;

  // the last block of this (row, kv head, head group) merges every split:
  // all (m, l) in one round of loads, then the weights, then o with many
  // loads in flight per thread
  __threadfence();
  for (int i = tid; i < splits * GT; i += kThreads) {
    w_s[i] = __ldcg(part_m + first + i);
    pl_s[i] = __ldcg(part_l + first + i);
  }
  __syncthreads();
  if (tid < GT) {
    float mt = kNegInf;
    for (int sp = 0; sp < splits; ++sp) mt = fmaxf(mt, w_s[sp * GT + tid]);
    float lt = 0.0f;
    for (int sp = 0; sp < splits; ++sp) {
      const float a = expf(w_s[sp * GT + tid] - mt);
      w_s[sp * GT + tid] = a;
      lt += pl_s[sp * GT + tid] * a;
    }
    lt_s[tid] = lt;
  }
  __syncthreads();
  const float4* all4 = reinterpret_cast<const float4*>(part_o + first * hd);
  for (int e4 = tid; e4 < n_heads * hd / 4; e4 += kThreads) {
    const int e = 4 * e4, g = e / hd, d = e % hd;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) {
      const float4 x = __ldcg(all4 + sp * n4 + e4);
      const float a = w_s[sp * GT + g];
      acc.x += x.x * a;
      acc.y += x.y * a;
      acc.z += x.z * a;
      acc.w += x.w * a;
    }
    const float den = fmaxf(lt_s[g], 1e-30f);
    T* dst = out + (static_cast<long long>(b) * H + g0 + g) * hd + d;
    dst[0] = qs::from_f32<T>(acc.x / den);
    dst[1] = qs::from_f32<T>(acc.y / den);
    dst[2] = qs::from_f32<T>(acc.z / den);
    dst[3] = qs::from_f32<T>(acc.w / den);
  }
  if (tid == 0) tickets[unit] = 0;
}

template <typename T, int GT, int NV>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid,
           void* out, float* part_m, float* part_l, float* part_o,
           int* tickets, int B, int H, int KV, int hd, int C, int splits,
           int chunk, int lps, float scale, cudaStream_t st) {
  const int G = H / KV;
  const int hgroups = (G + GT - 1) / GT;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kWarps) * GT * hd +
                       2 * kWarps * GT + 2 * kMaxSplits * GT + 2 * GT);
  auto kern = flash_decode_kernel<T, GT, NV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(splits, KV * hgroups, B);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, static_cast<T*>(out), part_m, part_l,
      part_o, tickets, H, KV, hd, C, chunk, lps, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NV>
int launch_g(int GT, const void* q, const void* k, const void* v,
             const uint8_t* valid, void* out, float* pm, float* pl,
             float* po, int* tickets, int B, int H, int KV, int hd, int C,
             int splits, int chunk, int lps, float scale, cudaStream_t st) {
  switch (GT) {
#define QS_DECODE_GT(n)                                                     \
  case n:                                                                   \
    return launch<T, n, NV>(q, k, v, valid, out, pm, pl, po, tickets, B, H, \
                            KV, hd, C, splits, chunk, lps, scale, st);
    QS_DECODE_GT(1)
    QS_DECODE_GT(2)
    QS_DECODE_GT(4)
    QS_DECODE_GT(8)
#undef QS_DECODE_GT
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, out: float32 (bf16 = 0) or bfloat16 (1); valid: [B, C] bytes;
// hd a multiple of 8 up to 256; GT (query heads a block serves) 1, 2, 4
// or 8; part_m / part_l [B, KV, ceil(G / GT), splits, GT] and part_o
// [..., GT, hd] (16-byte aligned) float32 scratch and tickets
// [B * KV * ceil(G / GT)] int32, all zero, when splits > 1 (unused at
// splits = 1).
extern "C" int qs_flash_decode(const void* q, const void* k, const void* v,
                               const uint8_t* valid, void* out,
                               float* part_m, float* part_l, float* part_o,
                               int* tickets, int B, int H, int KV, int hd,
                               int C, int GT, int splits, int chunk,
                               float scale, int bf16, void* stream) {
  if (B <= 0) return 0;
  if (hd % 8 != 0 || hd > 256 || splits < 1 || splits > kMaxSplits ||
      chunk < 1 || static_cast<long long>(splits) * chunk < C)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // lanes per slot: the row's 16-byte vectors over at most 32 lanes, a
  // power of two so that lane groups tile the warp
  const int nvec = hd * (bf16 ? 2 : 4) / 16;
  const int nv = nvec > 32 ? 2 : 1;
  int lps = 1;
  while (lps * nv < nvec) lps <<= 1;
  if (bf16)
    return launch_g<__nv_bfloat16, 1>(GT, q, k, v, valid, out, part_m,
                                      part_l, part_o, tickets, B, H, KV, hd,
                                      C, splits, chunk, lps, scale, st);
  return nv == 2
             ? launch_g<float, 2>(GT, q, k, v, valid, out, part_m, part_l,
                                  part_o, tickets, B, H, KV, hd, C, splits,
                                  chunk, lps, scale, st)
             : launch_g<float, 1>(GT, q, k, v, valid, out, part_m, part_l,
                                  part_o, tickets, B, H, KV, hd, C, splits,
                                  chunk, lps, scale, st);
}

// The most splits one (row, kv head) may take: the merge keeps a weight
// per split and head in shared memory.  The wrapper caps its split count
// by it.
extern "C" int qs_flash_decode_max_splits() { return kMaxSplits; }
