// qsgd_quantize: bucketed QSGD stochastic quantization against supplied
// uniforms.
//
// Replaces the TPU kernel src/repro/kernels/qsgd.py (qsgd_quantize ->
// _kernel).  Per row (bucket) of x [rows, n] float32 with uniforms u of
// the same shape:
//   norm = ||x||_2; safe = norm > 0 ? norm : 1
//   level = |x| / safe * s; low = floor(level)
//   xi = low + (u < level - low)
//   out = norm > 0 ? norm * sign(x) * xi / s : 0
// The uniforms come in as an operand, as on the TPU, so the kernel needs
// no random generator of its own and is deterministic given its inputs.
//
// What bounds it on an H100: memory.  It must read x and u and write out:
// 12 bytes per element, for about ten float32 operations per element.
// Dispatch sends a whole leaf as one row, so a row can hold 512Ki
// elements (2 MiB), more than one SM holds; the norm is a reduction
// across the whole row, and the quantization cannot start before it.
// Design: a thread-block cluster of cs = 1-16 blocks of 512 threads a
// row (the wrapper picks, kernels/qsgd.py:qsgd_geometry: the most blocks
// a row that keep every row's blocks on the card at once; or the caller's
// `cluster`), block r owning the contiguous chunk [r chunk, (r + 1)
// chunk) for the quantization.  The norm is summed first, in the one
// order common.cuh's unit_sums / units_tree give (kernels/ref.py:
// tree_sq_ref): the row's units of 2048 floats are split over the
// blocks, ceil(units / cs) each; each block sums its units by a fixed
// tree (16-byte loads, eight in flight a thread) and publishes them in its
// shared memory; after a cluster barrier every block reads all the row's
// unit sums through distributed shared memory and adds them by the same
// tree, so every block, at every cluster size, has the same float norm:
// deterministic, no atomics, no second launch, and no geometry that the
// tuner (kernels/autotune.py) can pick changes an output.  The
// quantization streams the chunk again, x (mostly from L2) and u, and
// writes out once, all 16-byte accesses.  A block arrives at a second
// cluster barrier after its reads of the others' sums and waits on it
// only at its end, so that no block leaves while another still reads its
// sums.  Holding the chunk in registers instead (x read once) caps a
// block at 32,768 floats (512 threads x 64 registers): ResNet-50's
// [16, 524288] then needs 256 blocks at one an SM, three waves of the 7
// clusters of 16 the card holds, and took 0.086 ms against this design's
// 0.063 (PERF.md §6).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;  // loads in flight a thread
// the most dynamic shared memory a block may take (an H100 SM's 227 KB)
constexpr long long kMaxSmem = 232448;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" : : : "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" : : : "memory");
}

// f(i, load(i)) for each i in [0, count) of this thread's share (i =
// threadIdx.x + a multiple of kThreads), kUnroll loads issued before
// their f's run.
template <typename T, typename Load, typename F>
__device__ __forceinline__ void stream(long long count, Load load, F f) {
  for (long long i0 = threadIdx.x; i0 < count;
       i0 += static_cast<long long>(kThreads) * kUnroll) {
    T e[kUnroll];
#pragma unroll
    for (int a = 0; a < kUnroll; ++a) {
      const long long i = i0 + static_cast<long long>(a) * kThreads;
      if (i < count) e[a] = load(i);
    }
#pragma unroll
    for (int a = 0; a < kUnroll; ++a) {
      const long long i = i0 + static_cast<long long>(a) * kThreads;
      if (i < count) f(i, e[a]);
    }
  }
}

template <typename T>
struct Pair {
  T x, u;
};

// `vec`: 16-byte accesses (n a multiple of 4, all three rows aligned);
// `ub`: units of the norm's tree a block.
__global__ void __launch_bounds__(kThreads)
qsgd_cluster_kernel(const float* __restrict__ x, const float* __restrict__ u,
                    float* __restrict__ out, long long n, long long chunk,
                    float s, int vec, long long ub) {
  extern __shared__ float units[];  // this block's unit sums, read by all
  __shared__ float part[32][kThreads / 32];
  __shared__ float norm_sh;

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x / cs;
  const long long beg = min(n, rank * chunk);
  const long long len = min(n, beg + chunk) - beg;
  const long long base = row * n + beg;
  const float* __restrict__ xr = x + row * n;
  const float* __restrict__ xc = x + base;
  const float* __restrict__ uc = u + base;
  float* __restrict__ oc = out + base;
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(xc);
  const float4* __restrict__ u4 = reinterpret_cast<const float4*>(uc);
  float4* __restrict__ o4 = reinterpret_cast<float4*>(oc);

  // the norm: this block's units of the row, then all the row's units
  const long long count = (n + qs::kTreeUnit - 1) / qs::kTreeUnit;
  const long long u0 = min(count, rank * ub), u1 = min(count, u0 + ub);
  auto sq = [](const float4& e) { return qs::group_sq(e.x, e.y, e.z, e.w); };
  if (vec)
    qs::unit_sums<kThreads>(
        u0, u1, [&](long long g) { return qs::load_group<true>(xr, n, g); },
        sq, part, units);
  else
    qs::unit_sums<kThreads>(
        u0, u1, [&](long long g) { return qs::load_group<false>(xr, n, g); },
        sq, part, units);
  cluster.sync();
  if (threadIdx.x < 32) {
    const float tot = qs::units_tree(count, [&](long long j) {
      return cluster.map_shared_rank(units, static_cast<int>(j / ub))[j % ub];
    });
    if (threadIdx.x == 0) norm_sh = sqrtf(tot);
  }
  __syncthreads();
  cluster_arrive();  // this block's reads of the other blocks are done
  const float norm = norm_sh;
  const float safe = norm > 0.0f ? norm : 1.0f;
  auto quant = [&](float e, float ue) {
    const float level = fabsf(e) / safe * s;
    const float low = floorf(level);
    const float xi = low + (ue < level - low ? 1.0f : 0.0f);
    const float q = norm * qs::sign_of(e) * xi / s;
    return norm > 0.0f ? q : 0.0f;
  };
  // x and u both loaded before any level is computed
  if (vec) {
    stream<Pair<float4>>(
        len / 4,
        [&](long long i) {
          return Pair<float4>{__ldg(x4 + i), __ldg(u4 + i)};
        },
        [&](long long i, const Pair<float4>& e) {
          o4[i] = make_float4(quant(e.x.x, e.u.x), quant(e.x.y, e.u.y),
                              quant(e.x.z, e.u.z), quant(e.x.w, e.u.w));
        });
  } else {
    stream<Pair<float>>(
        len,
        [&](long long i) {
          return Pair<float>{__ldg(xc + i), __ldg(uc + i)};
        },
        [&](long long i, const Pair<float>& e) { oc[i] = quant(e.x, e.u); });
  }
  cluster_wait();  // no block leaves while another may read its sum
}

struct QsgdLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
};

// units of the norm's tree a block of a cluster of cs takes in rows of n
long long units_per_block(long long n, int cs) {
  const long long count = (n + qs::kTreeUnit - 1) / qs::kTreeUnit;
  return (count + cs - 1) / cs;
}

int qsgd_launch(QsgdLaunch& l, long long rows, int cs, long long ub,
                cudaStream_t st) {
  l = {};
  const long long smem = ub * static_cast<long long>(sizeof(float));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (cs > 8)
    err = cudaFuncSetAttribute(qsgd_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(qsgd_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  l.cfg.gridDim = dim3(static_cast<unsigned>(rows * cs));
  l.cfg.blockDim = dim3(kThreads);
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

// A cluster of cs (1, 2, 4, 8 or 16) blocks a row, block r owning
// elements [r * chunk, (r + 1) * chunk) (chunk a multiple of 4, cs *
// chunk >= n, no block empty).
extern "C" int qs_qsgd_quantize_f32(const float* x, const float* u,
                                    float* out, long long rows, long long n,
                                    int s, int cs, long long chunk,
                                    void* stream) {
  if (rows <= 0) return 0;
  if ((cs != 1 && cs != 2 && cs != 4 && cs != 8 && cs != 16) || chunk <= 0 ||
      chunk % 4 || static_cast<long long>(cs) * chunk < n ||
      (cs > 1 && (cs - 1) * chunk >= n))
    return static_cast<int>(cudaErrorInvalidValue);
  QsgdLaunch l;
  long long ub = units_per_block(n, cs);
  const int err =
      qsgd_launch(l, rows, cs, ub, static_cast<cudaStream_t>(stream));
  if (err) return err;
  // 16-byte accesses where every chunk starts on a 16-byte boundary of
  // all three rows
  int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(out) % 16 == 0;
  float sf = static_cast<float>(s);
  void* args[] = {&x, &u, &out, &n, &chunk, &sf, &vec, &ub};
  const cudaError_t e = cudaLaunchKernelExC(
      &l.cfg, reinterpret_cast<const void*>(qsgd_cluster_kernel), args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// How many of the kernel's blocks the current card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times its SMs), or minus
// a cudaError_t.
extern "C" int qs_qsgd_resident_blocks() {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, qsgd_cluster_kernel, kThreads, 0);
  return e == cudaSuccess ? sms * per_sm : -static_cast<int>(e);
}
