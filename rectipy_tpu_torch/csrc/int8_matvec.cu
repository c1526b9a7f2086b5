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
// 1,979 TOP/s; so the bound is the bytes.  These kernels multiply on the
// CUDA cores with __dp4a (about 64 four-byte products a clock per SM, some
// 50 us for 8e8 __dp4a at B = 32), which caps them above that bound: the
// tensor-core form (mma.sync or wgmma on int8) is later work.
//
// Design against re-reading: int8_mv's one-warp-per-row form, kept for B
// rows, would make each warp read all B activation rows per W row, 3.2 GB
// from L2 per call at B = 32.  Instead:
// - int8_mm: a block of 4 warps owns 16 rows of W and up to 32 trials.  For
//   each 512-byte chunk of the inputs, the block stages the chunk of all its
//   trials' activations in shared memory once (16 KB); each warp streams
//   16 bytes of each of its 4 rows per lane and multiplies them with every
//   trial's 16 bytes from shared memory (4 rows x 32 trials of int32 sums in
//   registers, 16 __dp4a per 16-byte shared load).  W is read once for the
//   32 trials; a B above 32 takes a second group of blocks, which reads W
//   again.  Each sum reduces across the warp with __reduce_add_sync; lane b
//   writes trial b's epilogue, in int8_mv's order.
// - int8_mm_t: int4_mv_t's scheme on bytes.  A block owns a strip of 512
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
// The sums are integers, exact in any order, so both agree bit for bit with
// the plain versions.
//
// Interface: plain C functions, loaded with ctypes; they launch on the
// caller's stream, never synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// wq: (n_out, n_in) int8 row-major; xq: (n_rows, n_in) int8 row-major;
// row_scale: (n_out,) f32; act_scale: (n_rows,) f32; out: (n_rows, n_out)
// f32.  vec = 1 selects the 16-byte path: the caller sets it only when
// n_in % 16 == 0 and wq and xq are 16-byte aligned.
extern "C" int int8_mm_launch(const void* wq, const void* xq, const void* row_scale,
                              const void* act_scale, void* out, int n_out, int n_in, int n_rows,
                              int vec, void* stream) {
  if (n_out <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_out + kMmRows - 1) / kMmRows, (n_rows + kTrials - 1) / kTrials);
  const auto* w = static_cast<const int8_t*>(wq);
  const auto* x = static_cast<const int8_t*>(xq);
  const auto* rs = static_cast<const float*>(row_scale);
  const auto* as = static_cast<const float*>(act_scale);
  auto* o = static_cast<float*>(out);
  if (vec) int8_mm_kernel<true><<<grid, kMmThreads, 0, st>>>(w, x, rs, as, o, n_out, n_in, n_rows);
  else int8_mm_kernel<false><<<grid, kMmThreads, 0, st>>>(w, x, rs, as, o, n_out, n_in, n_rows);
  return static_cast<int>(cudaGetLastError());
}

// The int32 elements of the scratch that int8_mm_t_launch needs for these
// arguments (chunks x n_rows x n_in).
extern "C" long long int8_mm_t_scratch(int n_out, int n_in, int n_rows) {
  int chunks, rows;
  mm_t_chunks(n_out, n_in, n_rows, &chunks, &rows);
  return static_cast<long long>(chunks) * (n_rows > 0 ? n_rows : 0) * (n_in > 0 ? n_in : 0);
}

// wq: (n_out, n_in) int8 row-major; vq: (n_rows, n_out) int8 row-major;
// act_scale: (n_rows,) f32; partial: int32 scratch of
// int8_mm_t_scratch(n_out, n_in, n_rows) elements, written before it is
// read; out: (n_rows, n_in) f32.  vec = 1 selects the 4-byte loads of wq:
// the caller sets it only when n_in % 4 == 0 and wq is 4-byte aligned.
extern "C" int int8_mm_t_launch(const void* wq, const void* vq, const void* act_scale,
                                void* partial, void* out, int n_out, int n_in, int n_rows,
                                int vec, void* stream) {
  if (n_in <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int chunks, rows;
  mm_t_chunks(n_out, n_in, n_rows, &chunks, &rows);
  auto* p = static_cast<int*>(partial);
  if (chunks > 0) {
    const dim3 grid((n_in + kMtStrip - 1) / kMtStrip, chunks, (n_rows + kTrials - 1) / kTrials);
    const auto* w = static_cast<const int8_t*>(wq);
    const auto* v = static_cast<const int8_t*>(vq);
    if (vec) int8_mm_t_kernel<true><<<grid, kMtThreads, 0, st>>>(w, v, p, n_out, n_in, n_rows, rows);
    else int8_mm_t_kernel<false><<<grid, kMtThreads, 0, st>>>(w, v, p, n_out, n_in, n_rows, rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 rgrid((n_in + 255) / 256, n_rows);
  mm_t_reduce_kernel<<<rgrid, 256, 0, st>>>(p, chunks, n_rows, static_cast<const float*>(act_scale),
                                            static_cast<float*>(out), n_in);
  return static_cast<int>(cudaGetLastError());
}
