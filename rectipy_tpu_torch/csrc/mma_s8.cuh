// The tensor-core pieces of the batched int8 x int8 and int4 x int8
// products, for NVIDIA Hopper (sm_90a): int8_mm_mma_kernel and
// int8_mm_t_mma_kernel (int8_matvec.cu) and int4_mm_mma_kernel
// (int4_matvec.cu) share them.  mma.sync m16n8k32 s8 x s8 -> s32 (exact
// int32 sums), the cp.async copies of the activations' stage, the streaming
// 16-byte loads of W, and the thread block clusters in which the chunks of
// columns of one strip of W's rows add their sums through distributed
// shared memory: the epilogue, the split into chunks, and how many such
// clusters fit on the card at once.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>
#include <utility>

namespace mmas8 {

namespace cg = cooperative_groups;

// A 16-byte copy from device to shared memory that uses no registers
// (cp.async); bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void copy16(void* smem, const void* gmem, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

// Wait until at most `pending` groups of this thread's cp.async copies are
// in flight (0 <= pending <= 3).
__device__ __forceinline__ void wait_copies(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

// 16 bytes of W, read once: not kept in L1, and L2 fetches the surrounding
// 256 bytes (the block's other warps read them next).
__device__ __forceinline__ uint4 load_w16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// c += a * b on the tensor cores: a 16 x 32 int8 tile (row fragment), a
// 32 x 8 int8 tile (column fragment), exact int32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The epilogue of a block of kWarps warps whose M is W's rows (kTiles
// m-tiles of 16 rows a warp, N the trials, 4 n-tiles of 8): once the stage
// is used up, the C fragments go to the shared `red` ([trial][row of the
// block], kPitch ints a trial); the blocks of the cluster (the chunks of
// columns of the strip) add their sums through distributed shared memory,
// block `rank` every chunks-th run of 32 * kWarps sums, and write
// out[b0 + b, i] = (float(sum) * row_scale[i]) * act_scale[b0 + b] for the
// nb trials and the rows below n_out.
template <int kWarps, int kTiles, int kPitch, int kMaxCluster>
__device__ __forceinline__ void rows_cluster_epilogue(const int (&c)[kTiles][4][4], int* red,
                                                      int nb, int b0,
                                                      const float* __restrict__ row_scale,
                                                      const float* __restrict__ act_scale,
                                                      float* __restrict__ out, int n_out) {
  constexpr int kThreads = 32 * kWarps;
  constexpr int kWarpRows = 16 * kTiles;
  constexpr int kRows = kWarps * kWarpRows;
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kTiles; ++u)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)  // element i: m-row g + 8 (i / 2), trial 2t + i % 2
        red[(8 * nt + 2 * t + (i & 1)) * kPitch + warp * kWarpRows + 16 * u + g +
            8 * (i >> 1)] = c[u][nt][i];
  cluster.sync();
  const int chunks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int* peer[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    peer[q] = q < chunks ? cluster.map_shared_rank(red, q) : red;
  constexpr int kEach = 8;  // sums a thread reduces at once: all their reads in flight
  for (int i0 = rank * kThreads + threadIdx.x; i0 < nb * kRows;
       i0 += kEach * chunks * kThreads) {
    int sum[kEach];
#pragma unroll
    for (int e = 0; e < kEach; ++e) {
      const int idx = i0 + e * chunks * kThreads;
      const int off = (idx / kRows) * kPitch + idx % kRows;
      sum[e] = 0;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < chunks && idx < nb * kRows) sum[e] += peer[q][off];
    }
#pragma unroll
    for (int e = 0; e < kEach; ++e) {
      const int idx = i0 + e * chunks * kThreads;
      const int b = idx / kRows, i = blockIdx.x * kRows + idx % kRows;
      if (idx < nb * kRows && i < n_out)
        out[static_cast<size_t>(b0 + b) * n_out + i] =
            __fmul_rn(__fmul_rn(static_cast<float>(sum[e]), row_scale[i]), act_scale[b0 + b]);
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// The split of n_in into chunks of columns (a multiple of block_k, none
// empty) for `clusters` clusters (strips x groups of trials): as many
// chunks, at most kMax, as the clusters of all strips still fit on the card
// at once, fit[c] being how many clusters of c blocks do.
template <int kMax>
inline void column_chunks(int clusters, int n_in, int block_k, const std::array<int, kMax + 1>& fit,
                          int* chunks, int* cols) {
  int c = kMax;
  while (c > 1 && fit[c] < clusters) --c;
  int k = (n_in + c - 1) / c;
  k = (k + block_k - 1) / block_k * block_k;
  *cols = k > 0 ? k : block_k;
  *chunks = n_in > 0 ? (n_in + *cols - 1) / *cols : 1;
}

// fit[c]: how many clusters of c = 1..kMax blocks of `kernel` (`threads`
// threads, `smem` bytes of dynamic shared memory, clusters along y) fit on
// the current device at once (cudaOccupancyMaxActiveClusters).  Asked once
// per device and kernel; the first ask also lets the kernel take `smem`
// bytes, which above 48 KB it takes only when asked for.
template <int kMax>
cudaError_t cluster_fits(const void* kernel, int threads, int smem,
                         std::array<int, kMax + 1>* fit) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, std::array<int, kMax + 1>> fits;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(dev, kernel);
  auto it = fits.find(key);
  if (it == fits.end()) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = 1;
    cluster.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    std::array<int, kMax + 1> f;
    f[0] = 0;
    for (int c = 1; c <= kMax; ++c) {
      cfg.gridDim = dim3(1, c, 1);
      cluster.val.clusterDim.y = c;
      e = cudaOccupancyMaxActiveClusters(&f[c], kernel, &cfg);
      if (e != cudaSuccess) return e;
    }
    it = fits.emplace(key, f).first;
  }
  *fit = it->second;
  return cudaSuccess;
}

// Launch `kernel` (`threads` threads, `smem` bytes of dynamic shared
// memory) on a grid of (strips, chunks of columns, groups of trials), the
// chunks of a strip and group one cluster: as many chunks as column_chunks
// gives for what fits on the card.  The kernel takes `args` and, last, the
// columns of a chunk.
template <int kMax, typename... Params, typename... Args>
cudaError_t launch_column_clusters(void (*kernel)(Params...), int threads, int smem, int strips,
                                   int groups, int n_in, int block_k, cudaStream_t st,
                                   Args... args) {
  std::array<int, kMax + 1> fit;
  cudaError_t e = cluster_fits<kMax>(reinterpret_cast<const void*>(kernel), threads, smem, &fit);
  if (e != cudaSuccess) return e;
  int chunks, cols;
  column_chunks<kMax>(strips * groups, n_in, block_k, fit, &chunks, &cols);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = chunks;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(strips, chunks, groups);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args..., cols);
}

}  // namespace mmas8
