// paged_decode: single-token GQA decode attention over a shared KV page
// pool, read through per-request block tables.
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
// On the TPU the block table rides in as scalar prefetch and BlockSpec
// index maps gather the pages; the grid walks the pages in order and
// carries the online-softmax state in VMEM scratch.  On Hopper one block
// owns one (row, kv head) pair with the G = H / KV query heads of its
// group.  It loads its own table entries and walks the row's pages in
// tiles of `pb` pages (the pages-per-block geometry): each tile's K and V
// are staged in shared memory as float32 (int8 pages times their slot
// scale), the G x (pb * ps) scores are taken against the staged K, and
// the running max m, normalizer l and f32 accumulator o are updated once
// per tile.  Only the pages that hold live positions are read.  Dead
// positions are masked on the score and on p itself, so a row of length
// 0 reads no page and writes exact zeros (o = 0, l = 0, 0 / 1e-30).
//
// What bounds it on an H100: the bytes of the live K and V pages (2 bytes
// an element in bf16, 1 in int8).  One block per (row, kv head) keeps few
// SMs busy at small batch (Yi-6B at batch 8: 32 blocks); splitting a long
// row across blocks (flash-decoding's split-K) is a later change.
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

template <typename TQ, typename TP, bool QUANT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TP* __restrict__ kp,
                    const TP* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, TQ* __restrict__ out,
                    int H, int KV, int hd, int n_pages, int ps, int P,
                    int pb, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / KV, h = blockIdx.x % KV;
  const int G = H / KV;
  const int T = pb * ps;  // tokens per tile
  const int hdp = hd + 1;  // padded rows: conflict-free column reads
  float* q_s = smem;             // [G, hd], pre-scaled
  float* k_s = q_s + G * hd;     // [T, hdp]
  float* v_s = k_s + T * hdp;    // [T, hdp]
  float* p_s = v_s + T * hdp;    // [G, T] scores, then probabilities
  float* o_s = p_s + G * T;      // [G, hd]
  float* m_s = o_s + G * hd;     // [G]
  float* l_s = m_s + G;          // [G]
  float* a_s = l_s + G;          // [G] rescale of the previous tiles
  const int tid = threadIdx.x;
  const int len = lengths[b];
  const long long q_base = (static_cast<long long>(b) * H + h * G) * hd;

  for (int e = tid; e < G * hd; e += kThreads) {
    q_s[e] = qs::to_f32(q[q_base + e]) * scale;
    o_s[e] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.0f;
  }
  const int n_used = min(P, (max(len, 0) + ps - 1) / ps);
  for (int j0 = 0; j0 < n_used; j0 += pb) {
    __syncthreads();  // the previous tile is consumed (and q_s is ready)
    for (int e = tid; e < T * hd; e += kThreads) {
      const int t = e / hd, d = e % hd;
      const int j = j0 + t / ps, slot = t % ps;
      float kv = 0.0f, vv = 0.0f;
      if (j < P) {
        const int page = min(max(tables[static_cast<long long>(b) * P + j],
                                 0), n_pages - 1);
        const long long row = static_cast<long long>(page) * ps + slot;
        const long long off = (row * KV + h) * hd + d;
        kv = qs::to_f32(kp[off]);
        vv = qs::to_f32(vp[off]);
        if (QUANT) {
          kv *= ks[row];
          vv *= vs[row];
        }
      }
      k_s[t * hdp + d] = kv;
      v_s[t * hdp + d] = vv;
    }
    __syncthreads();
    for (int e = tid; e < G * T; e += kThreads) {
      const int g = e / T, t = e % T;
      float acc = 0.0f;
      for (int d = 0; d < hd; ++d) acc += q_s[g * hd + d] * k_s[t * hdp + d];
      p_s[e] = (j0 * ps + t < len) ? acc : kNegInf;
    }
    __syncthreads();
    for (int g = tid; g < G; g += kThreads) {
      const float m_prev = m_s[g];
      float m_new = m_prev;
      for (int t = 0; t < T; ++t) m_new = fmaxf(m_new, p_s[g * T + t]);
      float sum = 0.0f;
      for (int t = 0; t < T; ++t) {
        const float p = (j0 * ps + t < len) ? expf(p_s[g * T + t] - m_new)
                                            : 0.0f;
        p_s[g * T + t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      a_s[g] = alpha;
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = m_new;
    }
    __syncthreads();
    for (int e = tid; e < G * hd; e += kThreads) {
      const int g = e / hd, d = e % hd;
      float acc = o_s[e] * a_s[g];
      for (int t = 0; t < T; ++t) acc += p_s[g * T + t] * v_s[t * hdp + d];
      o_s[e] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * hd; e += kThreads) {
    const float l = fmaxf(l_s[e / hd], 1e-30f);
    out[q_base + e] = qs::from_f32<TQ>(o_s[e] / l);
  }
}

size_t smem_bytes(int G, int hd, int T) {
  return sizeof(float) *
         (static_cast<size_t>(G) * hd * 2 + static_cast<size_t>(T) * (hd + 1) * 2 +
          static_cast<size_t>(G) * T + 3 * static_cast<size_t>(G));
}

template <typename TQ, typename TP, bool QUANT>
int launch(const void* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int* tables, const int* lengths, void* out,
           int B, int H, int KV, int hd, int n_pages, int ps, int P, int pb,
           float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(H / KV, hd, pb * ps);
  auto kern = paged_decode_kernel<TQ, TP, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<static_cast<unsigned>(B * KV), kThreads, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), ks, vs, tables, lengths,
      static_cast<TQ*>(out), H, KV, hd, n_pages, ps, P, pb, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_bf16: q (and an fp pool) is bfloat16 (1) or float32 (0); quant: the
// pool holds int8 levels with f32 slot scales ks / vs.
extern "C" int qs_paged_decode(const void* q, const void* kp, const void* vp,
                               const float* ks, const float* vs,
                               const int* tables, const int* lengths,
                               void* out, int B, int H, int KV, int hd,
                               int n_pages, int ps, int P, int pb,
                               float scale, int q_bf16, int quant,
                               void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && quant)
    return launch<__nv_bfloat16, int8_t, true>(
        q, kp, vp, ks, vs, tables, lengths, out, B, H, KV, hd, n_pages, ps,
        P, pb, scale, st);
  if (q_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, kp, vp, ks, vs, tables, lengths, out, B, H, KV, hd, n_pages, ps,
        P, pb, scale, st);
  if (quant)
    return launch<float, int8_t, true>(q, kp, vp, ks, vs, tables, lengths,
                                       out, B, H, KV, hd, n_pages, ps, P, pb,
                                       scale, st);
  return launch<float, float, false>(q, kp, vp, ks, vs, tables, lengths, out,
                                     B, H, KV, hd, n_pages, ps, P, pb, scale,
                                     st);
}
