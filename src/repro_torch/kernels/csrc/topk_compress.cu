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
// card's float32 rate per byte.  But the bisection reads the row 26
// times.  Design: one block per row.  A row of up to 12,288 floats
// (48 KB; the main path's RowTopK rows are 4096) is staged once in
// shared memory, so the 26 counting passes read shared memory and
// device memory is touched once in each direction.  Longer rows (up to
// dispatch's max_row, 512Ki floats = 2 MiB, from the global TopK
// operator) do not fit one SM and re-read the row from device memory
// (mostly L2) on every pass, with 1024 threads; that path is right but
// not fast, and is left for a later change (a cluster of blocks sharing
// one row through distributed shared memory would keep it on chip).
// The threshold is common.cuh's bisect_threshold, shared with
// topk_compact: every count is a block-wide integer reduction, so it is
// bit-identical to the plain version; only the SignTop_k norm is a
// float sum in another order.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr long long kSmemMaxElems = 12288;  // 48 KB of float32

template <int THREADS, bool SMEM>
__global__ void __launch_bounds__(THREADS)
topk_compress_kernel(const float* __restrict__ acc, float* __restrict__ sel,
                     float* __restrict__ mem, int* __restrict__ cnt_out,
                     long long n, int k, int iters, int sign) {
  extern __shared__ float row_smem[];
  __shared__ int iscratch[2][32];
  __shared__ float fscratch[2][32];

  const long long base = static_cast<long long>(blockIdx.x) * n;
  const float* __restrict__ src = acc + base;
  const int tid = threadIdx.x;

  if (SMEM) {
    for (long long i = tid; i < n; i += THREADS) row_smem[i] = src[i];
    __syncthreads();
  }
  auto value = [&](long long i) -> float {
    return SMEM ? row_smem[i] : __ldg(src + i);
  };

  int buf = 0;
  const float thr = qs::bisect_threshold<THREADS>(value, n, k, iters,
                                                  iscratch, fscratch[0], buf);

  int c = 0;
  float sq = 0.0f;
  for (long long i = tid; i < n; i += THREADS) {
    const float v = value(i);
    const float a = fabsf(v);
    if (a >= thr && a > 0.0f) {
      c += 1;
      sq += v * v;
    }
  }
  const int cnt = qs::block_sum<THREADS>(c, iscratch[buf]);
  float scale = 0.0f;
  if (sign) {
    const float norm = sqrtf(qs::block_sum<THREADS>(sq, fscratch[1]));
    const float denom = fmaxf(static_cast<float>(cnt), 1.0f);
    scale = norm / denom;
    // repro computes sign(acc) * norm / denom; sign * norm is exact, so
    // (sign * norm) / denom == sign * (norm / denom) bit for bit
  }
  for (long long i = tid; i < n; i += THREADS) {
    const float v = value(i);
    const float a = fabsf(v);
    float s = 0.0f;
    if (a >= thr && a > 0.0f) s = sign ? qs::sign_of(v) * scale : v;
    sel[base + i] = s;
    mem[base + i] = v - s;
  }
  if (tid == 0) cnt_out[blockIdx.x] = cnt;
}

}  // namespace

extern "C" int qs_topk_compress_f32(const float* acc, float* sel, float* mem,
                                    int* cnt, long long rows, long long n,
                                    int k, int iters, int sign,
                                    void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(rows));
  if (n <= kSmemMaxElems) {
    const size_t smem = static_cast<size_t>(n) * sizeof(float);
    // The kernel's own 512 B of reduction scratch plus a 48 KB row pass
    // the default 48 KB per-block limit: opt in to the row's size.
    const cudaError_t err = cudaFuncSetAttribute(
        topk_compress_kernel<256, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    topk_compress_kernel<256, true><<<grid, 256, smem, st>>>(
        acc, sel, mem, cnt, n, k, iters, sign);
  } else {
    topk_compress_kernel<1024, false><<<grid, 1024, 0, st>>>(
        acc, sel, mem, cnt, n, k, iters, sign);
  }
  return static_cast<int>(cudaGetLastError());
}
