// int8 x int8 matvecs of the int8_master coupling, forward and transposed,
// for NVIDIA Hopper (sm_90a).
//
// These replace no Pallas kernel: the JAX package computes them as XLA dots
// with int32 accumulation (rectipy_tpu/ops/quant.py::int8_dot, int8_dot_t).
// PyTorch has no exact int8 matvec on the GPU (torch._int_mm wants more than
// 16 rows; a float32 copy is inexact past 2^24 and writes 4 bytes per weight),
// so the port carries its own.  They run twice per time step of every
// int8_master training epoch.
//
//   int8_mv:   out[i] = (float(sum_j wq[i, j] * xq[j]) * row_scale[i]) * act_scale
//   int8_mv_t: out[j] =  float(sum_i wq[i, j] * vq[i]) * act_scale
//
// The integer sums are exact (the wrapper refuses a fan-in that could
// overflow int32), so both kernels agree bit for bit with the plain version
// whatever the order of summation.  act_scale is a device pointer: it is the
// scale quant_vec computed on the card, and reading it on the host would
// synchronise every step.
//
// Bound.  Each call must read wq once: n_out * n_in bytes, 1.0e8 at N =
// 10,000, twice the H100's 50 MB L2, so it streams from HBM: at least 30 us
// at the data-sheet 3.35 TB/s.  The vectors (10 KB each way) do not move it.
// These are derived figures, not measurements.
//
// Design against that bound:
// - int8_mv: one warp per output row, 8 rows per block.  Lanes read 16-byte
//   vectors of the row (streaming hint) and of xq (read-only cache; 10 KB
//   shared by all rows), neighbouring lanes on neighbouring addresses, and
//   __dp4a sums four byte products into an int32 per instruction.  A warp
//   shuffle reduces the row; lane 0 writes the float epilogue in the JAX
//   package's order.
// - int8_mv_t: the transposed product reads the same row-major wq.  A block
//   owns a strip of columns (each thread 16 adjacent columns, one 16-byte
//   load per row) and a chunk of rows; each thread keeps 16 int32 sums.  The
//   block stages its strip's sums in shared memory and adds them to an int32
//   scratch with atomics on consecutive addresses; a second small kernel
//   applies the scale.  Integer atomics make the result exact and
//   deterministic.
// - When n_in is not a multiple of 16, or a pointer is not 16-byte aligned,
//   scalar instantiations run instead: the same sums one byte at a time.
//
// The batched forms, for B rows of activations (B trials of run_batch and
// fit_bptt_batch, each with its own activation scale, as the JAX package's
// vmap gives each trial its own quant_vec scale):
//
//   int8_mm:   out[b, i] = (float(sum_j wq[i, j] * xq[b, j]) * row_scale[i]) * act_scale[b]
//   int8_mm_t: out[b, j] =  float(sum_i wq[i, j] * vq[b, i]) * act_scale[b]
//
// They replace no Pallas kernel either: under vmap XLA makes the int8 dots
// of rectipy_tpu/ops/quant.py batched dots.  Bound at N = 10,000 and B = 32:
// W must still be read once, 1.0e8 bytes (30 us at 3.35 TB/s), and the
// 2*B*N^2 = 6.4e9 integer operations take 3 us at the tensor cores'
// 1,979 TOP/s; so the bound is the bytes.  On the CUDA cores with __dp4a
// (about 64 four-byte products a clock per SM) the products alone take some
// 50 us at B = 32, above that bound: both main instances therefore run on
// the tensor cores (int8_mm_mma_kernel and mma_s8.cuh's cols_t_mma_kernel);
// the __dp4a kernels stay for the shapes their routes do not take and as
// the tensor cores' yardstick.
//
// Design against re-reading: int8_mv's one-warp-per-row form, kept for B
// rows, would make each warp read all B activation rows per W row, 3.2 GB
// from L2 per call at B = 32.  Instead:
// - int8_mm on the tensor cores (route "mma": n_in % 8 == 0 and wq 8-byte
//   aligned; int8_mm_mma_kernel).  mma.sync m16n8k32 s8 x s8 -> s32 with
//   M = W's rows i (the outputs), N = the trials, K = W's columns j: A[i][j]
//   = W[i, j] and B[j][b] = xq[b, j], both K-major as they lie.
//   - A fragments straight from W's rows, no byte transposes: lane (g, t)
//     = (lane / 4, lane % 4) loads 16 bytes, columns 16t..16t+15 of a
//     64-column sub-block, of rows g and g + 8 of each m-tile (one 16-byte
//     load where n_in % 16 == 0 and wq is 16-byte aligned, else two of 8).
//     Its first 8 bytes are k-step 0's registers and the last 8 k-step
//     1's: k slots 4t..4t+3 and 16+4t..16+4t+3 hold columns 16t..16t+3 and
//     16t+4..16t+7 (+8 for step 1), a permutation of k that the B fragments
//     share; the integer sum does not depend on the order of k.
//   - B fragments: under that permutation lane (g, t)'s four B registers of
//     n-tile nt (both k-steps) are the 16 bytes of trial 8 nt + g at the
//     same columns: one 16-byte read of the block's stage of xq, whose
//     trial rows are padded to 64 mod 128 bytes so that a quarter-warp's
//     reads hit distinct banks.
//   - xq is staged once per block, not once per 16 rows: a block owns 128
//     rows (4 warps x 2 m-tiles) and a chunk of columns, and copies the
//     chunk of all its trials (cp.async where n_in % 16 == 0 and xq is
//     16-byte aligned, byte loads otherwise; zeros past the chunk and the
//     trials) in passes of at most 2,048 columns, each in four parts that
//     the k loop waits for one by one, after the first W loads are out.
//     The chunks of a strip are one thread block cluster that adds its
//     int32 sums through distributed shared memory and writes the
//     epilogue, as int8_mm_t's does.  At N = 10,000: 79 strips x 3 chunks
//     of 3,456 columns (the last 3,088, whose last k-block holds 16), two
//     passes each, so the stage reads 79 x 32 x 10,000 bytes = 25 MB from
//     L2 a call (the __dp4a kernel's 16-row blocks read 200 MB), against
//     W's 100 MB from HBM.
//   - W streams from HBM straight into registers in k-blocks of two
//     sub-blocks (a lane's loads of a row are 64 bytes apart, so a warp's
//     two load instructions read 128 contiguous bytes of each of 8 rows),
//     one k-block (256 bytes a lane) ahead of the one in use, with loads
//     that skip L1 and ask L2 for the surrounding 256 bytes.  2 m-tiles x
//     4 n-tiles x 4 = 32 int32 sums a lane; n-tiles past the trials are
//     skipped; rows past n_out load nothing and are not written.
//   - One wave: the number of chunks is the largest (at most 8) for which
//     the clusters of all strips fit on the card at once, as the runtime
//     reports it (cudaOccupancyMaxActiveClusters, asked once per device),
//     and the shared memory is one size for every shape: two blocks an SM.
//   - What bounds it: the W stream in this load pattern.  With the
//     products replaced by an XOR the kernel took its full time, and with
//     the stage left out as well most of it (the tensor cores' work is
//     about 3 us at B = 32).  Tried and slower (a throwaway timing script,
//     no figures kept): three blocks an SM (79 clusters of 5 did not all
//     fit on the card's GPCs at once, so a second wave ran; 4 chunks with
//     a second pass once the fit was read), a one-pass stage of 3,456
//     columns, one 64-column sub-block a k-block with a ring of 2, 3 or 4,
//     two with a ring of 3, four with a ring of 1 or 2, 8 stage parts, 8
//     warps a block, 4 m-tiles a warp (spills) or 1, bulk L2 prefetches of
//     each row ahead of the loads, a row's two sub-blocks loaded back to
//     back, and a 128-byte L2 hint.
// - int8_mm's __dp4a instances (route "scalar"; "vec" only through the C
//   launch, its conditions being inside "mma"'s): a block of 4 warps owns
//   16 rows of W and up to 32 trials.  For each 512-byte chunk of the
//   inputs, the block stages the chunk of all its trials' activations in
//   shared memory once (16 KB); each warp streams 16 bytes of each of its 4
//   rows per lane and multiplies them with every trial's 16 bytes from
//   shared memory (4 rows x 32 trials of int32 sums in registers, 16 __dp4a
//   per 16-byte shared load).  Each sum reduces across the warp with
//   __reduce_add_sync; lane b writes trial b's epilogue, in int8_mv's order.
//   A B above 32 takes a second group of blocks, which reads W again, on
//   every route.
// - int8_mm_t on the tensor cores (route "mma": n_in % 8 == 0 and wq 8-byte
//   aligned; mmas8::cols_t_mma_kernel in mma_s8.cuh, whose other instance
//   is int4_mm_t's on packed nibbles).  mma.sync m16n8k32 s8 x s8 -> s32 with
//   M = W's columns j (the outputs), N = the trials, K = W's rows i: A[j][i]
//   = W[i, j], B[i][b] = vq[b, i].  (wgmma wants 8-bit operands K-major in
//   shared memory, which row-major W is not, so it would need the same
//   transpose through shared memory.)
//   - A fragments from row-major W by byte transposes in registers: lane
//     (g, t) = (lane / 4, lane % 4) loads 8 bytes, columns 8g..8g+7, of each
//     of the rows 8t..8t+7 of a 32-row k-step, and four transpose4 calls
//     turn the 8 x 8 bytes into 16 words of one column x four rows.  A
//     fragment's k slots 4t + e and 16 + 4t + e then hold rows 8t + e and
//     8t + 4 + e: a permutation of k, which the B fragments share, and the
//     integer sum does not depend on the order of k.  Column 8g + 2u + h is
//     row g + 8h of m-tile u (four m-tiles), so a warp owns 64 columns, and
//     the 8 lanes that share t read 64 contiguous bytes of one row.
//   - B fragments without a transpose: under that permutation, lane (g, t)'s
//     two B registers of n-tile nt are the 8 bytes of trial 8 nt + g at rows
//     8t..8t+7 of the step: one 8-byte read of the block's stage of vq.  The
//     block stages its chunk of rows of all its trials (cp.async where n_out
//     and vq allow 16-byte copies, byte loads otherwise), zeros past the
//     chunk and past the trials, each trial row padded to 32 mod 128 bytes
//     so that a half-warp's 8-byte reads hit distinct banks.  The copies go
//     out in four parts after the first W loads, and the k loop waits for
//     each part when it reaches it (a barrier each): staged whole before
//     the loop, the stage held up the start of the W stream.
//   - W streams from HBM straight into registers, two k-steps (128 bytes a
//     lane) ahead of their use, with loads that skip L1 and ask L2 for the
//     surrounding 256 bytes (the block's four warps read 256 contiguous
//     bytes of a row).  4 m-tiles x 4 n-tiles x 4 = 64 int32 sums a lane;
//     n-tiles past the trials are skipped.
//   - A block is 4 warps (256 columns) x a chunk of rows x 32 trials; the
//     rows are split into as many chunks as fill the card with one wave of
//     kMcBlocksPerSm blocks an SM, at most 8 (8 chunks of 1,280 rows at
//     N = 10,000: 320 blocks).  The chunks of a column strip are one thread
//     block cluster: each block leaves its sums in shared memory, and after
//     a cluster barrier block q reads every chunk's sums of its share of
//     the strip through distributed shared memory, adds them and writes
//     float(sum) * act_scale[b] as the JAX package rounds it.  No scratch
//     in device memory, no atomics and no second launch.  (A first version
//     added the chunks with int32 atomics into a zeroed scratch and let the
//     strip's last block scale; it needed the zeroing launch and ran level
//     with this one.  Pushing the sums to their owner instead of pulling
//     them ran slower, and so did 2 or 4 blocks an SM, fewer chunks, and B
//     fragments read through L1 instead of the stage; a third k-step in
//     flight gained nothing that held from one build to the next.)
//   - What holds it back (PERF.md): the fixed cost of the cluster barriers
//     and the reduce after the k loop, and the W stream in this load
//     pattern (64 bytes of 4 rows a warp instruction), which reaches a
//     smaller share of the HBM rate than int8_mv's 16-byte loads of one
//     row.
// - int8_mm_t's other routes ("vec": n_in % 4 == 0 and wq 4-byte aligned;
//   "scalar"): int4_mv_t's scheme on bytes.  A block owns a strip of 512
//   columns (4 adjacent columns a thread, one 4-byte load per row) and a
//   chunk of rows; a thread takes four rows at a time, transposes the 4 x 4
//   bytes with __byte_perm so that a word holds one column's four rows, and
//   __dp4a's it against each trial's four activations of those rows, which
//   the block staged in shared memory (read as a broadcast).  4 columns x 32
//   trials of int32 sums live in registers.  Each block stores its chunk's
//   sums plainly to an int32 scratch (chunks x B x n_in), and a second
//   kernel sums the chunks and applies the scale.
// - Non-aligned shapes take scalar instantiations: the same blocks, one byte
//   at a time.
// The sums are integers, exact in any order, so all agree bit for bit with
// the plain versions.  The tensor-core pieces that int4_mm's kernel shares
// (mma_s8, the cp.async stage, the clusters' epilogue, chunks and fit), and
// the whole tensor-core int8_mm_t, live in mma_s8.cuh.
//
// Interface: plain C functions, loaded with ctypes; they launch on the
// caller's stream, never synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8.cuh"

namespace {

using mmas8::load_w16;
using mmas8::load_w8;
using mmas8::mma_s8;
using mmas8::transpose4;

constexpr int kMvThreads = 256;             // int8_mv: 8 warps, one row each
constexpr int kMvRows = kMvThreads / 32;
constexpr int kTThreads = 128;              // int8_mv_t: threads per block
constexpr int kTCols = 16;                  // int8_mv_t: columns per thread (vector path)

__device__ __forceinline__ int dp16(const int4 a, const int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  acc = __dp4a(a.w, b.w, acc);
  return acc;
}

template <bool kVec>
__global__ void __launch_bounds__(kMvThreads)
int8_mv_kernel(const int8_t* __restrict__ wq, const int8_t* __restrict__ xq,
               const float* __restrict__ row_scale, const float* __restrict__ act_scale,
               float* __restrict__ out, int n_out, int n_in) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMvRows + (threadIdx.x >> 5);
  if (row >= n_out) return;
  const int8_t* w = wq + static_cast<size_t>(row) * n_in;
  int acc = 0;
  if constexpr (kVec) {
    const int4* w16 = reinterpret_cast<const int4*>(w);
    const int4* x16 = reinterpret_cast<const int4*>(xq);
    const int nv = n_in / 16;
#pragma unroll 4
    for (int c = lane; c < nv; c += 32) acc = dp16(__ldcs(w16 + c), __ldg(x16 + c), acc);
  } else {
#pragma unroll 4
    for (int c = lane; c < n_in; c += 32)
      acc += static_cast<int>(__ldg(w + c)) * static_cast<int>(__ldg(xq + c));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0)
    out[row] = __fmul_rn(__fmul_rn(static_cast<float>(acc), row_scale[row]), *act_scale);
}

// Sign-extended byte k (0..3) of a 32-bit word.
__device__ __forceinline__ int sbyte(uint32_t u, int k) {
  return static_cast<int>(static_cast<int8_t>((u >> (8 * k)) & 0xffu));
}

template <bool kVec>
__global__ void __launch_bounds__(kTThreads)
int8_mv_t_kernel(const int8_t* __restrict__ wq, const int8_t* __restrict__ vq,
                 int* __restrict__ acc_out, int n_out, int n_in, int rows_per_chunk) {
  constexpr int kCols = kVec ? kTCols : 1;
  constexpr int kStrip = kTThreads * kCols;
  __shared__ int strip[kStrip];
  const int col0 = blockIdx.x * kStrip + threadIdx.x * kCols;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(n_out, r0 + rows_per_chunk);
  int acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0;
  if (col0 < n_in) {
    if constexpr (kVec) {
#pragma unroll 4
      for (int r = r0; r < r1; ++r) {
        const int4 w = __ldcs(reinterpret_cast<const int4*>(wq + static_cast<size_t>(r) * n_in + col0));
        const int v = static_cast<int>(__ldg(vq + r));
        const uint32_t words[4] = {static_cast<uint32_t>(w.x), static_cast<uint32_t>(w.y),
                                   static_cast<uint32_t>(w.z), static_cast<uint32_t>(w.w)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[4 * q + k] += sbyte(words[q], k) * v;
        }
      }
    } else {
#pragma unroll 4
      for (int r = r0; r < r1; ++r)
        acc[0] += static_cast<int>(__ldg(wq + static_cast<size_t>(r) * n_in + col0)) *
                  static_cast<int>(__ldg(vq + r));
    }
  }
  // stage the strip's sums so that each warp's atomics hit consecutive words
#pragma unroll
  for (int c = 0; c < kCols; ++c) strip[threadIdx.x * kCols + c] = acc[c];
  __syncthreads();
  const int strip0 = blockIdx.x * kStrip;
  for (int k = threadIdx.x; k < kStrip; k += kTThreads) {
    const int j = strip0 + k;
    if (j < n_in && strip[k] != 0) atomicAdd(acc_out + j, strip[k]);
  }
}

__global__ void scale_kernel(const int* __restrict__ acc, const float* __restrict__ act_scale,
                             float* __restrict__ out, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n) out[j] = __fmul_rn(static_cast<float>(acc[j]), *act_scale);
}

// ------------------------------------------------------------- batched
constexpr int kMmWarps = 4;                    // int8_mm: warps per block
constexpr int kMmThreads = 32 * kMmWarps;
constexpr int kMmRowsPerWarp = 4;
constexpr int kMmRows = kMmWarps * kMmRowsPerWarp;  // rows of W per block
constexpr int kTrials = 32;                    // trials per block (both kernels)
constexpr int kMmChunk = 512;                  // input bytes staged per trial and pass

template <bool kVec>
__global__ void __launch_bounds__(kMmThreads)
int8_mm_kernel(const int8_t* __restrict__ wq, const int8_t* __restrict__ xq,
               const float* __restrict__ row_scale, const float* __restrict__ act_scale,
               float* __restrict__ out, int n_out, int n_in, int n_rows) {
  __shared__ int4 xs[kTrials * kMmChunk / 16];  // 16 KB: the chunk of every trial
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * kTrials;
  const int nb = min(kTrials, n_rows - b0);
  const int row0 = blockIdx.x * kMmRows + warp * kMmRowsPerWarp;
  int acc[kMmRowsPerWarp][kTrials];
#pragma unroll
  for (int r = 0; r < kMmRowsPerWarp; ++r)
#pragma unroll
    for (int b = 0; b < kTrials; ++b) acc[r][b] = 0;
  const int8_t* xb = reinterpret_cast<const int8_t*>(xs);
  for (int k0 = 0; k0 < n_in; k0 += kMmChunk) {
    // this chunk's 16 bytes of each row, issued before the staging so that
    // the loads from device memory overlap it
    int4 w[kMmRowsPerWarp];
    if constexpr (kVec) {
      const int k = k0 + 16 * lane;
#pragma unroll
      for (int r = 0; r < kMmRowsPerWarp; ++r)
        w[r] = (row0 + r < n_out && k < n_in)
                   ? __ldcs(reinterpret_cast<const int4*>(wq + static_cast<size_t>(row0 + r) * n_in + k))
                   : make_int4(0, 0, 0, 0);
    }
    __syncthreads();  // the previous chunk is consumed
    if constexpr (kVec) {
#pragma unroll
      for (int j = 0; j < kTrials * kMmChunk / 16 / kMmThreads; ++j) {  // all in flight
        const int idx = threadIdx.x + j * kMmThreads;
        const int b = idx / (kMmChunk / 16);
        const int k = k0 + 16 * (idx % (kMmChunk / 16));
        xs[idx] = (b < nb && k < n_in)
                      ? __ldg(reinterpret_cast<const int4*>(xq + static_cast<size_t>(b0 + b) * n_in + k))
                      : make_int4(0, 0, 0, 0);
      }
    } else {
      int8_t* xw = reinterpret_cast<int8_t*>(xs);
      for (int idx = threadIdx.x; idx < kTrials * kMmChunk; idx += kMmThreads) {
        const int b = idx / kMmChunk;
        const int k = k0 + idx % kMmChunk;
        xw[idx] = (b < nb && k < n_in) ? __ldg(xq + static_cast<size_t>(b0 + b) * n_in + k)
                                       : static_cast<int8_t>(0);
      }
    }
    __syncthreads();
    if constexpr (kVec) {
#pragma unroll
      for (int b = 0; b < kTrials; ++b) {
        const int4 x = xs[b * (kMmChunk / 16) + lane];
#pragma unroll
        for (int r = 0; r < kMmRowsPerWarp; ++r) acc[r][b] = dp16(w[r], x, acc[r][b]);
      }
    } else {
#pragma unroll 1
      for (int q = 0; q < kMmChunk / 32; ++q) {
        const int kk = q * 32 + lane;
        const int k = k0 + kk;
        int ws[kMmRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kMmRowsPerWarp; ++r)
          ws[r] = (row0 + r < n_out && k < n_in)
                      ? static_cast<int>(__ldg(wq + static_cast<size_t>(row0 + r) * n_in + k))
                      : 0;
#pragma unroll
        for (int b = 0; b < kTrials; ++b) {
          const int x = static_cast<int>(xb[b * kMmChunk + kk]);
#pragma unroll
          for (int r = 0; r < kMmRowsPerWarp; ++r) acc[r][b] += ws[r] * x;
        }
      }
    }
  }
  // reduce each (row, trial) sum across the warp; lane b keeps trial b's
#pragma unroll
  for (int r = 0; r < kMmRowsPerWarp; ++r) {
    int mine = 0;
#pragma unroll
    for (int b = 0; b < kTrials; ++b) {
      const int sum = __reduce_add_sync(0xffffffffu, acc[r][b]);
      if (lane == b) mine = sum;
    }
    const int row = row0 + r;
    if (row < n_out && lane < nb)
      out[static_cast<size_t>(b0 + lane) * n_out + row] =
          __fmul_rn(__fmul_rn(static_cast<float>(mine), row_scale[row]), act_scale[b0 + lane]);
  }
}

constexpr int kMtThreads = 128;  // int8_mm_t: threads per block
constexpr int kMtCols = 4;       // columns per thread
constexpr int kMtStrip = kMtThreads * kMtCols;
constexpr int kMtBlocks = 512;   // int8_mm_t: blocks to aim for
constexpr int kMtMaxRows = 512;  // rows per chunk at most (the staged activations)

// The 4 bytes of wq at row r, columns col0..col0+3 (zero outside the matrix),
// as one little-endian word.
template <bool kVec>
__device__ __forceinline__ uint32_t row_word(const int8_t* __restrict__ wq, int r, int r1,
                                             int col0, int n_in) {
  if (r >= r1 || col0 >= n_in) return 0u;
  const int8_t* p = wq + static_cast<size_t>(r) * n_in + col0;
  if constexpr (kVec) {
    return __ldcs(reinterpret_cast<const unsigned int*>(p));
  } else {
    uint32_t u = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col0 + c < n_in) u |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + c))) << (8 * c);
    return u;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kMtThreads)
int8_mm_t_kernel(const int8_t* __restrict__ wq, const int8_t* __restrict__ vq,
                 int* __restrict__ partial, int n_out, int n_in, int n_rows,
                 int rows_per_chunk) {
  // the chunk's activations, word q of trial b at vs[q * kTrials + b]:
  // rows 4q..4q+3 of the chunk, zero past its end
  __shared__ uint32_t vs[kMtMaxRows / 4 * kTrials];
  const int b0 = blockIdx.z * kTrials;
  const int nb = min(kTrials, n_rows - b0);
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(n_out, r0 + rows_per_chunk);
  const int words = (r1 - r0 + 3) / 4;
  for (int idx = threadIdx.x; idx < words * kTrials; idx += kMtThreads) {
    const int q = idx / kTrials, b = idx % kTrials;
    uint32_t u = 0;
    if (b < nb) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = r0 + 4 * q + k;
        if (r < r1)
          u |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(vq + static_cast<size_t>(b0 + b) * n_out + r)))
               << (8 * k);
      }
    }
    vs[idx] = u;
  }
  __syncthreads();
  const int col0 = blockIdx.x * kMtStrip + threadIdx.x * kMtCols;
  int acc[kMtCols][kTrials];
#pragma unroll
  for (int c = 0; c < kMtCols; ++c)
#pragma unroll
    for (int b = 0; b < kTrials; ++b) acc[c][b] = 0;
  if (col0 < n_in) {
#pragma unroll 2
    for (int q = 0; q < words; ++q) {
      const int r = r0 + 4 * q;
      uint32_t col[4];
      transpose4(row_word<kVec>(wq, r, r1, col0, n_in), row_word<kVec>(wq, r + 1, r1, col0, n_in),
                 row_word<kVec>(wq, r + 2, r1, col0, n_in), row_word<kVec>(wq, r + 3, r1, col0, n_in),
                 col);
#pragma unroll
      for (int b = 0; b < kTrials; ++b) {
        const int v = static_cast<int>(vs[q * kTrials + b]);
#pragma unroll
        for (int c = 0; c < kMtCols; ++c) acc[c][b] = __dp4a(static_cast<int>(col[c]), v, acc[c][b]);
      }
    }
  }
  // this chunk's sums: partial[(chunk * n_rows + b) * n_in + col]
#pragma unroll
  for (int b = 0; b < kTrials; ++b) {
    if (b >= nb) break;
    int* dst = partial + (static_cast<size_t>(blockIdx.y) * n_rows + b0 + b) * n_in;
#pragma unroll
    for (int c = 0; c < kMtCols; ++c)
      if (col0 + c < n_in) dst[col0 + c] = acc[c][b];
  }
}

// out[b, j] = float(sum over the chunks of partial[c, b, j]) * act_scale[b].
__global__ void mm_t_reduce_kernel(const int* __restrict__ partial, int chunks, int n_rows,
                                   const float* __restrict__ act_scale, float* __restrict__ out,
                                   int n_in) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (j >= n_in) return;
  int sum = 0;
  for (int c = 0; c < chunks; ++c) sum += partial[(static_cast<size_t>(c) * n_rows + b) * n_in + j];
  out[static_cast<size_t>(b) * n_in + j] = __fmul_rn(static_cast<float>(sum), act_scale[b]);
}

// The chunks of rows int8_mm_t_launch splits n_out into, and the rows of each
// (a multiple of 4, at most kMtMaxRows).
void mm_t_chunks(int n_out, int n_in, int n_rows, int* chunks, int* rows) {
  if (n_out <= 0 || n_in <= 0 || n_rows <= 0) {
    *chunks = 0;
    *rows = 0;
    return;
  }
  const int strips = (n_in + kMtStrip - 1) / kMtStrip;
  const int groups = (n_rows + kTrials - 1) / kTrials;
  int c = kMtBlocks / (strips * groups);
  c = c < 1 ? 1 : c;
  int r = (n_out + c - 1) / c;
  r = (r + 3) / 4 * 4;
  r = r > kMtMaxRows ? kMtMaxRows : r;
  *rows = r;
  *chunks = (n_out + r - 1) / r;
}

// --------------------------------------------- int8_mm_t on the tensor cores
// mmas8::cols_t_mma_kernel with 8 bytes (8 int8 columns) of a row a lane
// (header note): 4 warps (256 columns) a block, a wave of 3 blocks an SM,
// passes of at most 2,048 rows.
constexpr int kMcWarps = 4;
constexpr int kMcBlocksPerSm = 3;
constexpr int kMcPassRows = 2048;

// ----------------------------------------------- int8_mm on the tensor cores
// The geometry and the k loop are mmas8::rows_mma_sums' (kRow*).
constexpr int kMaMaxCluster = 8;                    // chunks of columns (the portable cluster size)
constexpr int kMaBlocksPerSm = 2;                   // blocks an SM (the stage's shared memory)
constexpr int kMaRedPitch = mmas8::kRowBlockRows + 4;  // ints a trial in the sums' buffer
static_assert(kTrials == mmas8::kRowTrials, "a group of trials is one thread block's");
// one size of shared memory for every shape (the stage, then the sums), so
// that what fits on the card does not depend on the shape
constexpr int kMaSmem = kTrials * mmas8::kRowStride > kTrials * kMaRedPitch * 4
                            ? kTrials * mmas8::kRowStride : kTrials * kMaRedPitch * 4;

// The tensor-core int8_mm (header note).  Grid: (strips of kRowBlockRows
// rows, chunks of cols_per_chunk columns, groups of kTrials trials); the
// chunks of a strip and group are one cluster.  kW16: n_in % 16 == 0 and wq
// 16-byte aligned (one 16-byte load where two 8-byte loads go otherwise);
// kVecStage: n_in % 16 == 0 and xq 16-byte aligned.
template <bool kW16, bool kVecStage>
__global__ void __launch_bounds__(mmas8::kRowThreads, kMaBlocksPerSm)
int8_mm_mma_kernel(const int8_t* __restrict__ wq, const int8_t* __restrict__ xq,
                   const float* __restrict__ row_scale, const float* __restrict__ act_scale,
                   float* __restrict__ out, int n_out, int n_in, int n_rows, int cols_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // the fragments' group
  const int b0 = blockIdx.z * kTrials;
  const int nb = min(kTrials, n_rows - b0);
  const int c0 = blockIdx.y * cols_per_chunk;
  const int cols = max(0, min(n_in, c0 + cols_per_chunk) - c0);  // a chunk may be empty
  // the warp's first row
  const int row0 = blockIdx.x * mmas8::kRowBlockRows + warp * mmas8::kRowWarpRows;

  // the lane's rows g and g + 8 of each m-tile (m = 2 * tile + half), from
  // the chunk's first column
  const int8_t* w_row[2 * mmas8::kRowTiles];
  bool row_ok[2 * mmas8::kRowTiles];
#pragma unroll
  for (int m = 0; m < 2 * mmas8::kRowTiles; ++m) {
    const int r = row0 + 16 * (m >> 1) + 8 * (m & 1) + g;
    row_ok[m] = r < n_out;
    w_row[m] = wq + static_cast<size_t>(row_ok[m] ? r : 0) * n_in + c0;
  }
  const auto load_w = [&](int col, int end, uint4 (&w)[2 * mmas8::kRowTiles]) {
#pragma unroll
    for (int m = 0; m < 2 * mmas8::kRowTiles; ++m) {
      const int8_t* p = w_row[m] + col;
      if constexpr (kW16) {
        w[m] = (row_ok[m] && col < end) ? load_w16(p) : make_uint4(0u, 0u, 0u, 0u);
      } else {  // n_in % 8 == 0: each 8 bytes all in or all out
        const uint2 lo = (row_ok[m] && col < end) ? load_w8(p) : make_uint2(0u, 0u);
        const uint2 hi = (row_ok[m] && col + 8 < end) ? load_w8(p + 8) : make_uint2(0u, 0u);
        w[m] = make_uint4(lo.x, lo.y, hi.x, hi.y);
      }
    }
  };
  const auto src = [&](int b, int col) {  // xq[b0 + b, c0 + col]
    return xq + static_cast<size_t>(b0 + b) * n_in + c0 + col;
  };

  int c[mmas8::kRowTiles][4][4];  // m-tile, n-tile, fragment element
  mmas8::rows_mma_sums<kVecStage>(c, smem, cols, nb, true, false, load_w, src);

  // the chunks' sums by trial and row, added across the cluster
  mmas8::rows_cluster_epilogue<mmas8::kRowWarps, mmas8::kRowTiles, kMaRedPitch, kMaMaxCluster>(
      c, reinterpret_cast<int*>(smem), nb, b0, row_scale, act_scale, out, n_out);
}

template <bool kW16, bool kVecStage>
cudaError_t launch_mm_mma(const int8_t* w, const int8_t* x, const float* rs, const float* as,
                          float* out, int n_out, int n_in, int n_rows, cudaStream_t st) {
  return mmas8::launch_column_clusters<kMaMaxCluster>(
      int8_mm_mma_kernel<kW16, kVecStage>, mmas8::kRowThreads, kMaSmem,
      (n_out + mmas8::kRowBlockRows - 1) / mmas8::kRowBlockRows, (n_rows + kTrials - 1) / kTrials,
      n_in, mmas8::kRowBlockK, st, w, x, rs, as, out, n_out, n_in, n_rows);
}
}  // namespace

// wq: (n_out, n_in) int8 row-major; xq: (n_in,) int8; row_scale: (n_out,)
// f32; act_scale: one f32 on the device; out: (n_out,) f32.  vec = 1 selects
// the 16-byte path: the caller sets it only when n_in % 16 == 0 and wq and xq
// are 16-byte aligned.
extern "C" int int8_mv_launch(const void* wq, const void* xq, const void* row_scale,
                              const void* act_scale, void* out, int n_out, int n_in, int vec,
                              void* stream) {
  if (n_out <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n_out + kMvRows - 1) / kMvRows;
  const auto* w = static_cast<const int8_t*>(wq);
  const auto* x = static_cast<const int8_t*>(xq);
  const auto* rs = static_cast<const float*>(row_scale);
  const auto* as = static_cast<const float*>(act_scale);
  auto* o = static_cast<float*>(out);
  if (vec) int8_mv_kernel<true><<<blocks, kMvThreads, 0, st>>>(w, x, rs, as, o, n_out, n_in);
  else int8_mv_kernel<false><<<blocks, kMvThreads, 0, st>>>(w, x, rs, as, o, n_out, n_in);
  return static_cast<int>(cudaGetLastError());
}

// wq: (n_out, n_in) int8 row-major; vq: (n_out,) int8; act_scale: one f32 on
// the device; acc: (n_in,) int32 scratch, zeroed by the caller; out: (n_in,)
// f32.  vec = 1 selects the 16-byte path: the caller sets it only when
// n_in % 16 == 0 and wq is 16-byte aligned.
extern "C" int int8_mv_t_launch(const void* wq, const void* vq, const void* act_scale,
                                void* acc, void* out, int n_out, int n_in, int vec,
                                void* stream) {
  if (n_in <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const int8_t*>(wq);
  const auto* v = static_cast<const int8_t*>(vq);
  auto* a = static_cast<int*>(acc);
  if (n_out > 0) {
    const int strip = kTThreads * (vec ? kTCols : 1);
    const int strips = (n_in + strip - 1) / strip;
    // about 1,024 blocks in all (eight per SM), each a chunk of rows
    int chunks = 1024 / strips;
    chunks = chunks < 1 ? 1 : (chunks > n_out ? n_out : chunks);
    const int rows = (n_out + chunks - 1) / chunks;
    chunks = (n_out + rows - 1) / rows;
    const dim3 grid(strips, chunks);
    if (vec) int8_mv_t_kernel<true><<<grid, kTThreads, 0, st>>>(w, v, a, n_out, n_in, rows);
    else int8_mv_t_kernel<false><<<grid, kTThreads, 0, st>>>(w, v, a, n_out, n_in, rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scale_kernel<<<(n_in + 255) / 256, 256, 0, st>>>(a, static_cast<const float*>(act_scale),
                                                    static_cast<float*>(out), n_in);
  return static_cast<int>(cudaGetLastError());
}

// The routes of int8_mm_launch and int8_mm_t_launch (ops/quant.py::int8_mm_route
// and int8_mm_t_route pick one).
constexpr int kRouteScalar = 0, kRouteVec = 1, kRouteMma = 2;

// wq: (n_out, n_in) int8 row-major; xq: (n_rows, n_in) int8 row-major;
// row_scale: (n_out,) f32; act_scale: (n_rows,) f32; out: (n_rows, n_out)
// f32.  route: kRouteMma (the caller sets it only when n_in % 8 == 0 and wq
// is 8-byte aligned), kRouteVec (the __dp4a kernel's 16-byte path: n_in %
// 16 == 0 and wq and xq 16-byte aligned) or kRouteScalar.
extern "C" int int8_mm_launch(const void* wq, const void* xq, const void* row_scale,
                              const void* act_scale, void* out, int n_out, int n_in, int n_rows,
                              int route, void* stream) {
  if (n_out <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const int8_t*>(wq);
  const auto* x = static_cast<const int8_t*>(xq);
  const auto* rs = static_cast<const float*>(row_scale);
  const auto* as = static_cast<const float*>(act_scale);
  auto* o = static_cast<float*>(out);
  if (route == kRouteMma) {
    const bool w16 = n_in % 16 == 0 && reinterpret_cast<uintptr_t>(wq) % 16 == 0;
    const bool vec_stage = n_in % 16 == 0 && reinterpret_cast<uintptr_t>(xq) % 16 == 0;
    cudaError_t e;
    if (w16) e = vec_stage ? launch_mm_mma<true, true>(w, x, rs, as, o, n_out, n_in, n_rows, st)
                           : launch_mm_mma<true, false>(w, x, rs, as, o, n_out, n_in, n_rows, st);
    else e = vec_stage ? launch_mm_mma<false, true>(w, x, rs, as, o, n_out, n_in, n_rows, st)
                       : launch_mm_mma<false, false>(w, x, rs, as, o, n_out, n_in, n_rows, st);
    return static_cast<int>(e);
  }
  const dim3 grid((n_out + kMmRows - 1) / kMmRows, (n_rows + kTrials - 1) / kTrials);
  if (route == kRouteVec)
    int8_mm_kernel<true><<<grid, kMmThreads, 0, st>>>(w, x, rs, as, o, n_out, n_in, n_rows);
  else int8_mm_kernel<false><<<grid, kMmThreads, 0, st>>>(w, x, rs, as, o, n_out, n_in, n_rows);
  return static_cast<int>(cudaGetLastError());
}

// The int32 elements of the scratch that int8_mm_t_launch needs for these
// arguments on `route`: chunks x n_rows x n_in partial sums for the
// __dp4a routes, none for the tensor cores.
extern "C" long long int8_mm_t_scratch(int n_out, int n_in, int n_rows, int route) {
  if (n_in <= 0 || n_rows <= 0) return 0;
  if (route == kRouteMma) return 0;
  int chunks, rows;
  mm_t_chunks(n_out, n_in, n_rows, &chunks, &rows);
  return static_cast<long long>(chunks) * n_rows * n_in;
}

// wq: (n_out, n_in) int8 row-major; vq: (n_rows, n_out) int8 row-major;
// act_scale: (n_rows,) f32; scratch: int32, int8_mm_t_scratch(n_out, n_in,
// n_rows, route) elements, written before it is read; out: (n_rows, n_in)
// f32.  route: kRouteMma (the caller sets it only when n_in % 8 == 0 and wq
// is 8-byte aligned), kRouteVec (4-byte loads of wq: n_in % 4 == 0 and wq
// 4-byte aligned) or kRouteScalar.
extern "C" int int8_mm_t_launch(const void* wq, const void* vq, const void* act_scale,
                                void* scratch, void* out, int n_out, int n_in, int n_rows,
                                int route, void* stream) {
  if (n_in <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const int8_t*>(wq);
  const auto* v = static_cast<const int8_t*>(vq);
  const auto* as = static_cast<const float*>(act_scale);
  auto* p = static_cast<int*>(scratch);
  auto* o = static_cast<float*>(out);
  if (route == kRouteMma) {
    return static_cast<int>(mmas8::launch_cols_t<8, kMcWarps, kMcBlocksPerSm, kMcPassRows>(
        w, v, as, o, n_out, n_in, n_in, n_rows, st));
  }
  int chunks, rows;
  mm_t_chunks(n_out, n_in, n_rows, &chunks, &rows);
  if (chunks > 0) {
    const dim3 grid((n_in + kMtStrip - 1) / kMtStrip, chunks, (n_rows + kTrials - 1) / kTrials);
    if (route == kRouteVec)
      int8_mm_t_kernel<true><<<grid, kMtThreads, 0, st>>>(w, v, p, n_out, n_in, n_rows, rows);
    else int8_mm_t_kernel<false><<<grid, kMtThreads, 0, st>>>(w, v, p, n_out, n_in, n_rows, rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 rgrid((n_in + 255) / 256, n_rows);
  mm_t_reduce_kernel<<<rgrid, 256, 0, st>>>(p, chunks, n_rows, as, o, n_in);
  return static_cast<int>(cudaGetLastError());
}
