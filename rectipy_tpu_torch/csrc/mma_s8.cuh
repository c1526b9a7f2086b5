// The tensor-core pieces of the batched int8 x int8 and int4 x int8
// products, for NVIDIA Hopper (sm_90a): int8_mm_mma_kernel (int8_matvec.cu)
// and int4_mm_mma_kernel (int4_matvec.cu) share them, int8_mm_mma_kernel
// and block_int8_mma_kernel (block_int8.cu) one k loop (rows_mma_sums), and
// int8_mm_t and int4_mm_t are two instances of one kernel here
// (cols_t_mma_kernel).
// mma.sync m16n8k32 s8 x s8 -> s32 (exact int32 sums), the cp.async copies
// of the activations' stage, the streaming loads of W, the byte transposes
// and the nibble unpack, and the thread block clusters in which the chunks
// of one strip of W add their sums through distributed shared memory: the
// epilogues, the split into chunks, and how many such clusters fit on the
// card at once.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <atomic>
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

// 8 and 4 bytes of W, read once, as load_w16.
__device__ __forceinline__ uint2 load_w8(const void* p) {
  uint2 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t load_w4(const void* p) {
  uint32_t v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.u32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

// Word c of the 4 x 4 byte transpose of the words r0..r3: byte k of the
// result is byte c of word r_k.
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                           uint32_t out[4]) {
  const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
  const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
  out[0] = __byte_perm(lo01, lo23, 0x5410);  // r0.b0 r1.b0 r2.b0 r3.b0
  out[1] = __byte_perm(lo01, lo23, 0x7632);  // r0.b1 r1.b1 r2.b1 r3.b1
  out[2] = __byte_perm(hi01, hi23, 0x5410);
  out[3] = __byte_perm(hi01, hi23, 0x7632);
}

// The low (weights 0, 2, 4, 6) and high (1, 3, 5, 7) nibbles of a word of
// packed int4 weights (offset binary) as signed bytes, n - 8 each: n + 0x78
// stays inside its byte, and flipping the byte's top bit then takes 0x80 off
// (n >= 8) or adds 0x80 (n < 8, giving n - 8 mod 256).  Three or four
// integer instructions; __vsub4 takes more.
__device__ __forceinline__ int lo_nibbles(uint32_t u) {
  return static_cast<int>(((u & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u);
}
__device__ __forceinline__ int hi_nibbles(uint32_t u) {
  return static_cast<int>((((u >> 4) & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u);
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

// ------------------------------------------ products whose M is W's rows
// The geometry and the k loop that int8_mm_mma_kernel (int8_matvec.cu) and
// block_int8_mma_kernel (block_int8.cu) share; their header notes say why.
// A thread block of kRowWarps warps owns kRowBlockRows rows of W (kRowTiles
// m-tiles of 16 rows a warp) and up to kRowTrials trials (4 n-tiles of 8).
constexpr int kRowWarps = 4;
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kRowTiles = 2;                          // m-tiles of 16 rows a warp
constexpr int kRowWarpRows = 16 * kRowTiles;
constexpr int kRowBlockRows = kRowWarps * kRowWarpRows;  // rows of W a thread block
constexpr int kRowTrials = 32;                        // trials a thread block (4 n-tiles)
constexpr int kRowBlockK = 128;                       // columns of a k-block, loaded at once
constexpr int kRowSub = kRowBlockK / 64;              // its sub-blocks of two k-steps
constexpr int kRowRing = 2;                           // k-blocks of W in flight a lane
constexpr int kRowPassCols = 2048;                    // columns staged at once at most
constexpr int kRowParts = 4;                          // parts of the stage, waited for one by one
// Bytes a trial's row takes in the stage: 64 mod 128, so that the 16-byte
// reads of a quarter-warp (2 trials x 4 column offsets) hit distinct banks;
// a multiple of 16 for cp.async.
constexpr int kRowStride = kRowPassCols / 128 * 128 + 64;
static_assert(kRowParts <= 4, "wait_copies waits for at most 3 pending groups");
static_assert(kRowPassCols % kRowBlockK == 0 && kRowBlockK % 64 == 0, "whole k-blocks a pass");

// c = the int32 sums of the warp's kRowTiles m-tiles and 4 n-tiles over K
// columns, in passes of at most kRowPassCols.  For each pass the lanes
// first put their loads of W's first kRowRing k-blocks in flight; the
// thread block then stages the pass's columns of the n-tiles' trials in
// rows of kRowStride bytes, zeros past the pass and past the nb trials
// (kVecStage: 16-byte cp.async copies in kRowParts parts, each waited for
// only when the k loop reaches it; else byte loads); and each 16-byte B read
// of the stage serves the warp's kRowTiles m-tiles.
// - load_w(col, end, w): w[m] = the 16 bytes at columns col..col+15 of the
//   lane's row m (rows g and g + 8 of each m-tile, m = 2 * tile + half),
//   zeros where the row is out or at columns from `end` on;
// - src(b, col): the address of column col of trial b of the thread
//   block's trials (read 16 bytes on where kVecStage, else one byte);
// - fresh: the first pass is staged (false: the stage still holds it from
//   the thread block's previous call, which needs K <= kRowPassCols);
//   used: a previous call read the stage, so restaging waits for all warps.
template <bool kVecStage, class LoadW, class Src>
__device__ __forceinline__ void rows_mma_sums(int (&c)[kRowTiles][4][4], unsigned char* smem,
                                              int K, int nb, bool fresh, bool used,
                                              const LoadW& load_w, const Src& src) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // the fragments' group and thread in group
  const int ntiles = (nb + 7) / 8;        // n-tiles with a trial in them
  const unsigned char* s_lane = smem + g * kRowStride + 16 * t;  // trial g, columns 16t..
#pragma unroll
  for (int u = 0; u < kRowTiles; ++u)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[u][nt][i] = 0;

  for (int p0 = 0; p0 < K; p0 += kRowPassCols) {
    const int pcols = min(kRowPassCols, K - p0);
    const int blocks = (pcols + kRowBlockK - 1) / kRowBlockK;
    const bool stage = fresh || p0 > 0;
    uint4 ring[kRowRing][kRowSub][2 * kRowTiles];  // kRowRing k-blocks ahead
    // zeros (and no load) past the pass
    auto load = [&](int kb, uint4 (&w)[kRowSub][2 * kRowTiles]) {
#pragma unroll
      for (int h = 0; h < kRowSub; ++h)
        load_w(p0 + kb * kRowBlockK + 64 * h + 16 * t, p0 + pcols, w[h]);
    };
#pragma unroll
    for (int d = 0; d < kRowRing; ++d) load(d, ring[d]);

    // the stage, in kRowParts parts of `part` k-blocks
    const int span = blocks * kRowBlockK;
    const int part = (blocks + kRowParts - 1) / kRowParts;
    if (stage) {
      if (p0 > 0 || used) __syncthreads();  // the previous stage is used up
      if constexpr (kVecStage) {  // pcols is a multiple of 16: a copy is all in or all out
#pragma unroll
        for (int q = 0; q < kRowParts; ++q) {
          const int k0 = min(span, q * part * kRowBlockK) / 16;
          const int n = min(span, (q + 1) * part * kRowBlockK) / 16 - k0;  // copies a trial
          for (int e = threadIdx.x; e < 8 * ntiles * n; e += kRowThreads) {
            const int b = e / n, k = 16 * (k0 + e % n);
            const bool ok = b < nb && k < pcols;
            copy16(smem + b * kRowStride + k, src(ok ? b : 0, p0 + (ok ? k : 0)), ok ? 16 : 0);
          }
          asm volatile("cp.async.commit_group;\n" ::);
        }
      } else {
        for (int e = threadIdx.x; e < 8 * ntiles * span; e += kRowThreads) {
          const int b = e / span, k = e % span;
          smem[b * kRowStride + k] = (b < nb && k < pcols)
              ? static_cast<unsigned char>(__ldg(src(b, p0 + k)))
              : static_cast<unsigned char>(0);
        }
      }
    }

    for (int kb0 = 0; kb0 < blocks; kb0 += kRowRing) {
#pragma unroll
      for (int d = 0; d < kRowRing; ++d) {
        const int kb = kb0 + d;
        if (kb >= blocks) break;
        if (stage && kb % part == 0) {  // the stage's part kb / part has landed, for all
          wait_copies(kRowParts - 1 - kb / part);
          __syncthreads();
        }
        uint4 w[kRowSub][2 * kRowTiles];
#pragma unroll
        for (int h = 0; h < kRowSub; ++h)
#pragma unroll
          for (int m = 0; m < 2 * kRowTiles; ++m) w[h][m] = ring[d][h][m];
        load(kb + kRowRing, ring[d]);
        // A fragment of m-tile u, k-step 0 of a sub-block: rows g, g + 8 at
        // columns 16t..16t+3 (k slots 4t..4t+3) and 16t+4..16t+7 (k slots
        // 16+4t..16+4t+3); k-step 1 the same at columns 16t+8..16t+15.  The
        // B fragments of trial 8nt + g are the same columns of the stage:
        // one 16-byte read.
#pragma unroll
        for (int h = 0; h < kRowSub; ++h)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (nt >= ntiles) break;
            const uint4 bv = *reinterpret_cast<const uint4*>(s_lane + 8 * nt * kRowStride +
                                                             kb * kRowBlockK + 64 * h);
#pragma unroll
            for (int u = 0; u < kRowTiles; ++u) {
              const uint4* a = w[h] + 2 * u;  // rows g and g + 8 of m-tile u
              mma_s8(c[u][nt], a[0].x, a[1].x, a[0].y, a[1].y, bv.x, bv.y);
              mma_s8(c[u][nt], a[0].z, a[1].z, a[0].w, a[1].w, bv.z, bv.w);
            }
          }
      }
    }
  }
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

// ------------------------------------------- the transposed products
// out[b, j] = float(sum_i W[i, j] * vq[b, i]) * act_scale[b] from row-major
// W: int8_mm_t (kBytes = 8: int8 W, `pitch` = n_in bytes a row) and
// int4_mm_t (kBytes = 4: packed int4 W, `pitch` = the packed stride).  The
// design is int8_matvec.cu's header note on int8_mm_t; in short:
// - mma.sync m16n8k32 s8 with M = W's columns j (the outputs), N = the
//   trials, K = W's rows i.  Lane (g, t) = (lane / 4, lane % 4) loads
//   kBytes bytes of each of rows 8t..8t+7 of a 32-row k-step: columns
//   8g..8g+7 of a warp's 64, a byte each for int8, a nibble each for int4.
//   transpose4 makes words of one byte position x four rows; for int4 the
//   low and the high nibbles of such a word are two columns (lo_nibbles,
//   hi_nibbles).  Either way column 8g + 2u + h at rows 8t..8t+3 (k slots
//   4t..4t+3) and 8t+4..8t+7 (k slots 16+4t..16+4t+3) are row g + 8h of
//   m-tile u: a permutation of k that the B fragments share, so that lane
//   (g, t)'s B registers of n-tile nt are the 8 bytes of trial 8nt + g at
//   rows 8t..8t+7 of the staged vq.
// - Loads: a lane loads only where its first column is below n_in.  Then
//   its bytes end inside the row: for int8 n_in % 8 == 0; for int4 the load
//   starts at a multiple of 4 below ceil(n_in / 2) <= pitch, a multiple of
//   16.  A skipped load holds zero weights (0 for int8, nibbles of 8 for
//   int4); rows past the pass load nothing and meet zeros in the stage.
// - A block is kWarps warps (64 columns each) x a chunk of rows x 32
//   trials; the chunks of a strip are one thread block cluster that adds
//   its int32 sums through distributed shared memory and writes the
//   epilogue: no scratch in device memory and one launch.
constexpr int kTTrials = 32;               // trials a block (4 n-tiles)
constexpr int kTStep = 32;                 // rows of W a k-step (m16n8k32)
constexpr int kTWarpCols = 64;             // columns of a warp: lane group g owns 8g..8g+7
constexpr int kTRing = 2;                  // k-steps of W in flight a lane
constexpr int kTPartRows = 512;            // rows of a full pass's part of the stage
constexpr int kTMaxCluster = 8;            // chunks of rows (the portable cluster size)
constexpr int kTRedPitch = kTWarpCols + 1; // ints a trial in the sums' buffer

// Bytes a trial's row takes in the stage of a pass of `rows` rows: 32 mod
// 128, so that the 8-byte reads of a half-warp (4 trials x 4 row offsets)
// hit distinct banks; a multiple of 16 for cp.async.
__host__ __device__ constexpr int t_stage_stride(int rows) { return (rows + 127) / 128 * 128 + 32; }

// The dynamic shared memory of a block of kWarps warps for passes of `rows`
// rows: the stage, then the sums.
template <int kWarps>
constexpr int t_smem(int rows) {
  return kTTrials * t_stage_stride(rows) > kWarps * kTTrials * kTRedPitch * 4
             ? kTTrials * t_stage_stride(rows)
             : kWarps * kTTrials * kTRedPitch * 4;
}

// An instance: kBytes (8: int8 W, 4: packed int4), kWarps warps a block,
// registers for kBlocksPerSm blocks an SM (the wave the launch aims for),
// passes of at most kPassRows rows of vq, staged in parts of kTPartRows.
// Grid: (column strips of 64 * kWarps, chunks of rows_per_chunk rows,
// groups of kTTrials trials); the chunks of a strip and group are one
// cluster.  kVecStage: n_out % 16 == 0 and vq 16-byte aligned (the stage by
// cp.async, else byte by byte).
template <int kBytes, int kWarps, int kBlocksPerSm, int kPassRows, bool kVecStage>
__global__ void __launch_bounds__(32 * kWarps, kBlocksPerSm)
cols_t_mma_kernel(const uint8_t* __restrict__ w, const int8_t* __restrict__ vq,
                  const float* __restrict__ act_scale, float* __restrict__ out, int n_out,
                  int n_in, int pitch, int n_rows, int rows_per_chunk) {
  static_assert(kBytes == 8 || kBytes == 4, "int8 or packed int4 weights");
  constexpr int kParts = kPassRows / kTPartRows;  // parts of the stage, waited for one by one
  static_assert(kParts >= 1 && kParts <= 4, "wait_copies waits for at most 3 pending groups");
  constexpr int kThreads = 32 * kWarps;
  constexpr int kCols = kWarps * kTWarpCols;  // columns of a block
  constexpr int kWords = kBytes / 4;          // words of a row a lane loads
  constexpr uint32_t kZero = kBytes == 4 ? 0x88888888u : 0u;  // zero weights
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // the fragments' group and thread in group
  const int b0 = blockIdx.z * kTTrials;
  const int nb = min(kTTrials, n_rows - b0);
  const int ntiles = (nb + 7) / 8;  // n-tiles with a trial in them
  const int r0 = blockIdx.y * rows_per_chunk;
  const int rows = max(0, min(n_out, r0 + rows_per_chunk) - r0);  // a chunk may be empty
  const int stride = t_stage_stride(min(rows_per_chunk, kPassRows));
  const int jw = blockIdx.x * kCols + warp * kTWarpCols;  // the warp's first column
  const bool col_ok = jw + 8 * g < n_in;  // the lane loads
  const unsigned char* s_lane = smem + g * stride + 8 * t;  // trial g, rows 8t..8t+7

  int c[4][4][4];  // m-tile u, n-tile nt, fragment element
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[u][nt][i] = 0;

  for (int p0 = 0; p0 < rows; p0 += kPassRows) {  // one pass at N = 10,000
    const int prows = min(kPassRows, rows - p0);
    const int steps = (prows + kTStep - 1) / kTStep;
    const int rp = r0 + p0;
    if (p0 > 0) __syncthreads();  // the previous pass's stage is used up
    // row 8t of the pass at the lane's columns
    const uint8_t* w_lane = w + (static_cast<size_t>(rp) + 8 * t) * pitch +
                            (col_ok ? (jw + 8 * g) * kBytes / 8 : 0);
    uint32_t ring[kTRing][8][kWords];  // rows 8t..8t+7 of a k-step, kTRing steps ahead
    auto load_w = [&](int s, uint32_t (&wr)[8][kWords]) {  // zeros (and no load) past the pass
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int k = s * kTStep + 8 * t + r;
        const uint8_t* p = w_lane + static_cast<size_t>(s * kTStep + r) * pitch;
        if constexpr (kBytes == 8) {
          const uint2 v = (col_ok && k < prows) ? load_w8(p) : make_uint2(kZero, kZero);
          wr[r][0] = v.x;
          wr[r][1] = v.y;
        } else {
          wr[r][0] = (col_ok && k < prows) ? load_w4(p) : kZero;
        }
      }
    };
#pragma unroll
    for (int d = 0; d < kTRing; ++d) load_w(d, ring[d]);

    // stage vq[b0 + b, rp .. rp + 32 steps) for the trials of the n-tiles in
    // use, zeros past the pass and past the trials: in kParts parts of
    // `part` k-steps, each waited for only when the k loop reaches it
    const int span = steps * kTStep;
    const int part = (steps + kParts - 1) / kParts;
    if constexpr (kVecStage) {  // prows is a multiple of 16: a copy is all in or all out
#pragma unroll
      for (int q = 0; q < kParts; ++q) {
        const int k0 = min(span, q * part * kTStep) / 16;
        const int n = min(span, (q + 1) * part * kTStep) / 16 - k0;  // 16-byte copies a trial
        for (int idx = threadIdx.x; idx < 8 * ntiles * n; idx += kThreads) {
          const int b = idx / n, k = 16 * (k0 + idx % n);
          const bool ok = b < nb && k < prows;
          copy16(smem + b * stride + k, ok ? vq + static_cast<size_t>(b0 + b) * n_out + rp + k : vq,
                 ok ? 16 : 0);
        }
        asm volatile("cp.async.commit_group;\n" ::);
      }
    } else {
      for (int idx = threadIdx.x; idx < 8 * ntiles * span; idx += kThreads) {
        const int b = idx / span, k = idx % span;
        smem[b * stride + k] = (b < nb && k < prows)
            ? static_cast<unsigned char>(__ldg(vq + static_cast<size_t>(b0 + b) * n_out + rp + k))
            : static_cast<unsigned char>(0);
      }
    }

    for (int s0 = 0; s0 < steps; s0 += kTRing) {
#pragma unroll
      for (int d = 0; d < kTRing; ++d) {
        const int s = s0 + d;
        if (s >= steps) break;
        if (s % part == 0) {  // the stage's part s / part has landed, for every thread
          wait_copies(kParts - 1 - s / part);
          __syncthreads();
        }
        uint32_t wr[8][kWords];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < kWords; ++q) wr[r][q] = ring[d][r][q];
        load_w(s + kTRing, ring[d]);
        // lo[c]: column 8g + c at rows 8t..8t+3 (k slots 4t..4t+3);
        // hi[c]: the same column at rows 8t+4..8t+7 (k slots 16+4t..16+4t+3)
        uint32_t lo[8], hi[8];
        if constexpr (kBytes == 8) {
          transpose4(wr[0][0], wr[1][0], wr[2][0], wr[3][0], lo);
          transpose4(wr[0][1], wr[1][1], wr[2][1], wr[3][1], lo + 4);
          transpose4(wr[4][0], wr[5][0], wr[6][0], wr[7][0], hi);
          transpose4(wr[4][1], wr[5][1], wr[6][1], wr[7][1], hi + 4);
        } else {  // byte u of the 4 rows: columns 8g + 2u (low nibbles) and + 1 (high)
          uint32_t a[4], b[4];
          transpose4(wr[0][0], wr[1][0], wr[2][0], wr[3][0], a);
          transpose4(wr[4][0], wr[5][0], wr[6][0], wr[7][0], b);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            lo[2 * u] = static_cast<uint32_t>(lo_nibbles(a[u]));
            lo[2 * u + 1] = static_cast<uint32_t>(hi_nibbles(a[u]));
            hi[2 * u] = static_cast<uint32_t>(lo_nibbles(b[u]));
            hi[2 * u + 1] = static_cast<uint32_t>(hi_nibbles(b[u]));
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= ntiles) break;
          const uint2 bv = *reinterpret_cast<const uint2*>(s_lane + 8 * nt * stride + s * kTStep);
#pragma unroll
          for (int u = 0; u < 4; ++u)  // rows g, g + 8 of m-tile u: columns 8g + 2u, + 1
            mma_s8(c[u][nt], lo[2 * u], lo[2 * u + 1], hi[2 * u], hi[2 * u + 1], bv.x, bv.y);
        }
      }
    }
  }

  // the sums by trial and column in shared memory (the stage is used up)
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  int* red = reinterpret_cast<int*>(smem);  // [warp][trial][column of the warp]
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)  // element i: m-row g + 8 (i / 2), trial 2t + i % 2
        red[(warp * kTTrials + 8 * nt + 2 * t + (i & 1)) * kTRedPitch + 8 * g + 2 * u + (i >> 1)] =
            c[u][nt][i];
  // the chunks of the cluster add their sums through distributed shared
  // memory: block `rank` reduces every chunks-th run of kThreads sums
  cluster.sync();
  const int chunks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int* peer[kTMaxCluster];
#pragma unroll
  for (int q = 0; q < kTMaxCluster; ++q) peer[q] = q < chunks ? cluster.map_shared_rank(red, q) : red;
  constexpr int kEach = 8;  // sums a thread reduces at once: all their reads in flight
  for (int i0 = rank * kThreads + threadIdx.x; i0 < nb * kCols; i0 += kEach * chunks * kThreads) {
    int sum[kEach];
#pragma unroll
    for (int e = 0; e < kEach; ++e) {
      const int idx = i0 + e * chunks * kThreads;
      const int b = idx / kCols, col = idx % kCols;
      const int off = ((col / kTWarpCols) * kTTrials + b) * kTRedPitch + col % kTWarpCols;
      sum[e] = 0;
#pragma unroll
      for (int q = 0; q < kTMaxCluster; ++q)
        if (q < chunks && idx < nb * kCols) sum[e] += peer[q][off];
    }
#pragma unroll
    for (int e = 0; e < kEach; ++e) {
      const int idx = i0 + e * chunks * kThreads;
      const int b = idx / kCols, j = blockIdx.x * kCols + idx % kCols;
      if (idx < nb * kCols && j < n_in)
        out[static_cast<size_t>(b0 + b) * n_in + j] =
            __fmul_rn(static_cast<float>(sum[e]), act_scale[b0 + b]);
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// The split of n_out into chunks of rows for cols_t_mma_kernel (a multiple
// of kTStep; one cluster of at most kTMaxCluster chunks): as many chunks as
// fill a card of `sms` SMs with one wave of kBlocksPerSm blocks an SM.
template <int kWarps, int kBlocksPerSm>
void t_row_chunks(int n_out, int n_in, int n_rows, int sms, int* chunks, int* rows) {
  const int strips = (n_in + kWarps * kTWarpCols - 1) / (kWarps * kTWarpCols);
  const int groups = (n_rows + kTTrials - 1) / kTTrials;
  int c = sms * kBlocksPerSm / (strips * groups);
  c = c < 1 ? 1 : (c > kTMaxCluster ? kTMaxCluster : c);
  const int r = (n_out + c - 1) / c;
  *rows = (r + kTStep - 1) / kTStep * kTStep;
  *chunks = c;
}

// Launch an instance of cols_t_mma_kernel on `st`: w (n_out rows of `pitch`
// bytes), vq (n_rows, n_out) int8, act_scale (n_rows,) f32, out (n_rows,
// n_in) f32.
template <int kBytes, int kWarps, int kBlocksPerSm, int kPassRows>
cudaError_t launch_cols_t(const void* w, const int8_t* vq, const float* as, float* out, int n_out,
                          int n_in, int pitch, int n_rows, cudaStream_t st) {
  if (n_out <= 0)
    return cudaMemsetAsync(out, 0, static_cast<size_t>(n_rows) * n_in * sizeof(float), st);
  const bool vec_stage = n_out % 16 == 0 && reinterpret_cast<uintptr_t>(vq) % 16 == 0;
  auto* kernel = vec_stage ? cols_t_mma_kernel<kBytes, kWarps, kBlocksPerSm, kPassRows, true>
                           : cols_t_mma_kernel<kBytes, kWarps, kBlocksPerSm, kPassRows, false>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  // dynamic shared memory above 48 KB is taken only when asked for, once
  // per device and instance
  static std::atomic<unsigned long long> asked[2];
  if (!(asked[vec_stage].load() >> dev & 1ull)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             t_smem<kWarps>(kPassRows));
    if (e != cudaSuccess) return e;
    asked[vec_stage].fetch_or(1ull << dev);
  }
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  int chunks, rows;
  t_row_chunks<kWarps, kBlocksPerSm>(n_out, n_in, n_rows, sms, &chunks, &rows);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_in + kWarps * kTWarpCols - 1) / (kWarps * kTWarpCols), chunks,
                     (n_rows + kTTrials - 1) / kTTrials);
  cfg.blockDim = dim3(32 * kWarps);
  cfg.dynamicSmemBytes = t_smem<kWarps>(rows < kPassRows ? rows : kPassRows);
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = chunks;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const uint8_t*>(w), vq, as, out, n_out, n_in,
                            pitch, n_rows, rows);
}

}  // namespace mmas8
