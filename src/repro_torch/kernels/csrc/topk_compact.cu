// topk_compact: the bisection-threshold Top_k of each row of an
// error-compensated accumulator, written in the compact wire form of the
// sparse_allgather sync: survivor slots (idx, val) in ascending index
// order, the sentinel (n, 0) in empty slots, the fused error memory and
// the per-row count.
//
// Replaces the TPU kernel src/repro/kernels/topk_compress.py
// (topk_compact -> _compact_kernel).  Per row of acc [rows, n] float32:
//   thr as topk_compress (common.cuh bisect_threshold, shared);
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
// slots; the bisection's 26 counting passes are integer compares on a
// row staged in shared memory.  Design: one block per row, the row
// staged once in shared memory (rows up to 12,288 floats; the main
// path's rows are 1,152, 4.6 KB, with 128 threads so that many rows are
// in flight per SM), the threshold, then a tiled block-wide exclusive
// scan of the survivor mask in index order with a running carry that
// gives every survivor its slot and lets each thread store its own
// survivors directly.  The TPU kernel's chunked one-hot matmul scatter
// exists because the TPU has no vector scatter; it has no counterpart
// here.  SignTop_k needs the emitted survivors' norm before any value is
// written, so its values and memories are written in a second pass over
// the emitted slots.  Rows longer than 12,288 floats re-read the row from
// device memory on every pass, as topk_compress's global path does.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr long long kSmemMaxElems = 12288;  // 48 KB of float32
constexpr long long kSmallRow = 2048;       // rows served by 128 threads

template <int THREADS, bool SMEM>
__global__ void __launch_bounds__(THREADS)
topk_compact_kernel(const float* __restrict__ acc, int* __restrict__ idx,
                    float* __restrict__ val, float* __restrict__ mem,
                    int* __restrict__ cnt_out, long long n, int k, int kcap,
                    int iters, int sign) {
  extern __shared__ float row_smem[];
  __shared__ int iscratch[2][32];
  __shared__ float fscratch[2][32];

  const long long row = blockIdx.x;
  const float* __restrict__ src = acc + row * n;
  float* __restrict__ mrow = mem + row * n;
  int* __restrict__ irow = idx + row * kcap;
  float* __restrict__ vrow = val + row * kcap;
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
    const float denom = fmaxf(static_cast<float>(cnt), 1.0f);
    // repro computes sign(acc) * norm / denom; sign * norm is exact, so
    // (sign * norm) / denom == sign * (norm / denom) bit for bit
    const float scale = norm / denom;
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

template <int THREADS>
int launch_smem(const float* acc, int* idx, float* val, float* mem, int* cnt,
                long long rows, long long n, int k, int kcap, int iters,
                int sign, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  // a 48 KB row plus the kernel's own scratch passes the default 48 KB
  // per block: opt in to the row's size
  const cudaError_t err = cudaFuncSetAttribute(
      topk_compact_kernel<THREADS, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_compact_kernel<THREADS, true>
      <<<dim3(static_cast<unsigned>(rows)), THREADS, smem, st>>>(
          acc, idx, val, mem, cnt, n, k, kcap, iters, sign);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qs_topk_compact_f32(const float* acc, int* idx, float* val,
                                   float* mem, int* cnt, long long rows,
                                   long long n, int k, int kcap, int iters,
                                   int sign, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= kSmallRow)
    return launch_smem<128>(acc, idx, val, mem, cnt, rows, n, k, kcap,
                            iters, sign, st);
  if (n <= kSmemMaxElems)
    return launch_smem<256>(acc, idx, val, mem, cnt, rows, n, k, kcap,
                            iters, sign, st);
  topk_compact_kernel<1024, false>
      <<<dim3(static_cast<unsigned>(rows)), 1024, 0, st>>>(
          acc, idx, val, mem, cnt, n, k, kcap, iters, sign);
  return static_cast<int>(cudaGetLastError());
}
