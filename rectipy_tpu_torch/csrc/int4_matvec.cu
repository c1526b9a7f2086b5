// int4 x int8 matvecs of the int4 and int4_master couplings, forward and
// transposed, on weights packed two per byte, for NVIDIA Hopper (sm_90a).
//
// They replace the packed-int4 Pallas matvec of
// benchmarks/i4pack_microbench.py (make_i4pack_matvec), whose products are
// exact and whose sums are exact, and the XLA int4 x int8 dots of the JAX
// package's int4 couplings (rectipy_tpu/ops/quant.py::int4_dot, int4_dot_t).
//
// Layout (rectipy_tpu_torch/ops/quant.py::pack_int4): row i of the
// (n_out, n_in) weights takes `stride` bytes; byte k holds W[i, 2k] + 8 in
// its low nibble and W[i, 2k+1] + 8 in its high nibble (offset binary, any
// value in [-8, 7]); the nibbles past n_in hold 8, a zero weight.  pack_int4
// rounds the stride up to 16 bytes: a tight row at N = 10,000 is 5,000
// bytes, 8 mod 16, so every other row would start off a 16-byte boundary.
//
//   int4_mv:   out[i] = (float(sum_j W[i, j] * xq[j]) * row_scale[i]) * act_scale
//   int4_mv_t: out[j] =  float(sum_i W[i, j] * vq[i]) * act_scale
//
// The integer sums are exact (the wrapper refuses a fan-in at which
// 8 * 127 * n could overflow int32), so both kernels agree bit for bit with
// the plain version whatever the order of summation.  act_scale is a device
// pointer (quant_vec's scale, computed on the card).
//
// Bound.  Each call must read the packed W once: n_out * ceil(n_in / 2)
// bytes, 5.0e7 at N = 10,000 (15 us at the data-sheet 3.35 TB/s) and
// 1.03e8 at N = 14,336 (31 us).  At N = 10,000 that is about the H100's
// 50 MB L2, so part of W may stay in L2 from one call to the next and a call
// may read faster than HBM allows.  These are derived figures, not
// measurements.
//
// Design against that bound:
// - int4_mv: one warp per output row, 8 rows per block.  Each lane loads 16
//   bytes of the row (32 weights; streaming hint) and the 32 bytes of xq
//   that they multiply (read-only cache).  In each 32-bit word, the low
//   nibbles (weights 0, 2, 4, 6 of the word) and the high nibbles (1, 3, 5,
//   7) become four signed bytes each (lo_nibbles, hi_nibbles); __byte_perm
//   picks the even and the odd bytes of xq; two __dp4a sum the eight
//   products into an int32.  The last n_in % 32 weights go one per lane; a
//   warp shuffle reduces the row; lane 0 writes the epilogue in the JAX
//   package's order.
// - int4_mv_t: int8_mv_t's scheme on nibbles.  A block owns a strip of
//   columns (each thread 32 adjacent columns, one 16-byte load per row) and
//   a chunk of rows, with 32 int32 sums per thread.  A thread takes four
//   rows at a time: eight __byte_perm transpose each 4 x 4 block of bytes,
//   so that one 32-bit word holds one column pair of the four rows, and two
//   __dp4a against the four activations add a column each.  The nibbles
//   stay offset by 8 in the products; 8 * the sum of vq over the chunk comes
//   off once at the end.  The block stages its strip's sums in shared memory
//   and stores them, coalesced, as its chunk's row of an int32 scratch
//   (chunks x n_in); a second kernel sums each column over the chunks (8
//   lanes of chunks per column, then shared memory) and applies the scale.
//   (int8_mv_t's int32 atomics into one zeroed row add a cost that does not
//   shrink with N: about a thousand blocks each add a whole strip.)
// - When the stride is not a multiple of 16, or a pointer is not 16-byte
//   aligned, scalar instantiations run: the same sums one nibble at a time.
//
// The batched forms, for B rows of activations (B trials of run_batch and
// fit_bptt_batch, each with its own activation scale, as the JAX package's
// vmap gives each trial its own quant_vec scale, rectipy_tpu/ops/quant.py:
// 180-191 and rectipy_tpu/dsl/lower.py:95):
//
//   int4_mm:   out[b, i] = (float(sum_j W[i, j] * xq[b, j]) * row_scale[i]) * act_scale[b]
//   int4_mm_t: out[b, j] =  float(sum_i W[i, j] * vq[b, i]) * act_scale[b]
//
// Bound at N = 10,000 and B = 32: the packed W must still be read once,
// 5.0e7 bytes (15 us at 3.35 TB/s); the 2*B*N^2 = 6.4e9 operations take 3 us
// at the int8 tensor-core rate, so the bound is the bytes.  On the CUDA
// cores with __dp4a (about 64 four-byte products a clock per SM) the products
// alone take some 50 us, above that bound, so int4_mm runs on the tensor
// cores (int4_mm_mma_kernel); int4_mm_t and the __dp4a int4_mm still run on
// the CUDA cores.  All sums are exact, so every kernel agrees bit for bit
// with the plain versions.
// - The trap: int4_mv's one-warp-per-row form, kept for B rows, would make
//   each warp read all B activation rows per W row.
// - int4_mm on the tensor cores (route "mma": stride % 16 == 0 and wp
//   16-byte aligned, which every pack_int4 output is; int4_mm_mma_kernel):
//   int8_mm_mma_kernel's scheme (int8_matvec.cu) on nibbles, with the
//   pieces both share in mma_s8.cuh.  mma.sync m16n8k32 s8 x s8 -> s32 with
//   M = W's rows, N = the trials, K = W's columns; the int4 tensor-core
//   path is left alone (the H100's data sheet gives it no dense rate), so
//   each nibble becomes a signed byte in registers.
//   - A fragments from the packed rows: lane (g, t) = (lane / 4, lane % 4)
//     makes one 16-byte streaming load (columns 32t..32t+31 of a 128-column
//     k-block) of rows g and g + 8 of each m-tile.  Word s of it holds
//     columns 32t+8s..32t+8s+7: its low nibbles (the even columns) become
//     a0 (row g) and a1 (row g + 8) of k-step s, its high nibbles (the odd
//     ones) a2 and a3 (lo_nibbles / hi_nibbles: mask, shift, n - 8).  So k
//     slot 4t+i holds column 32t+8s+2i and slot 16+4t+i column 32t+8s+2i+1:
//     a permutation of k, and the integer sum does not depend on the order.
//   - B fragments under the same permutation: the block stages xq with each
//     16-byte word split into its even and odd bytes (split_even_odd), so
//     that trial 8nt+g's B registers of the four k-steps are two 16-byte
//     shared reads (columns 32t..32t+15, then +16..+31).  Each trial row of
//     the stage is padded to 16 mod 32 bytes, so that a quarter-warp's reads
//     (2 trials x 4 lanes 32 bytes apart) hit distinct banks.  Where n_in %
//     16 == 0 and xq is 16-byte aligned, cp.async copies the words in parts
//     after the first W loads are out, and each thread splits the words it
//     copied once its part has landed (no extra barrier); otherwise each
//     byte is loaded and stored at its split position.
//   - The grid is int8_mm's: a block owns a strip of rows and a chunk of
//     columns, the chunks of a strip are one thread block cluster that adds
//     its int32 sums through distributed shared memory and writes the
//     epilogue in int4_mv's order, and the chunk count is the largest (at
//     most 8) for which the clusters of all strips fit on the card at once
//     (cudaOccupancyMaxActiveClusters, asked once per device).  But a block
//     owns 256 rows (4 warps x 4 m-tiles), not 128: W's bytes per column are
//     half of int8's, so the xq stage, which every strip reads, weighs twice
//     as much against them; 256-row strips halve it (40 strips x 32 x 10,000
//     bytes = 13 MB of L2 reads at N = 10,000, against W's 50 MB).  Two
//     k-blocks (32 bytes a row) of W are in flight a lane; 4 m-tiles x 4
//     n-tiles x 4 = 64 int32 sums; the stage is waited for in two parts.
//   - Where the trouble lies: (1) the last k-block of a row: at N = 10,000 a
//     row holds 78 k-blocks and 16 columns, so lanes t = 1..3 of the last
//     would read the next row.  A lane loads only when its first column lies
//     inside the pass; its 16 bytes then start below ceil(n_in / 2) at a
//     multiple of 16, hence end inside the stride.  A skipped load is 0x88
//     bytes (zero weights), and the stage holds zeros past n_in and past the
//     trials, so that nothing is read past xq.  (2) Ragged B (7 or 5 trials):
//     n-tiles past the trials are skipped and no row past n_rows is
//     written.  (3) W of about L2's size at N = 10,000: a timed loop may read
//     part of it from L2 (N = 14,336's 103 MB cannot).
//   - What bounds it: the W stream with its unpacking in this load pattern;
//     with the products replaced by an XOR, and the stage left out as well,
//     the kernel kept most of its time.  Tried and slower (a throwaway
//     timing script, no figures kept): 128-row strips with two or three
//     k-blocks of 256 columns in flight, or four of 128; __vsub4 for the
//     unpack; four stage parts; one 4,096-column pass at one block an SM;
//     8 warps a block of 2 m-tiles each; and at most 4 chunks (slower at N
//     = 10,000, faster at 14,336).
// - int4_mm's __dp4a instances (route "scalar"; "vec" only through the C
//   launch, its conditions being inside "mma"'s): int8_mm's __dp4a scheme on
//   nibbles.  A block of 4 warps owns 16 rows of W and up to 32 trials.  For
//   each chunk of 1,024 inputs it stages the chunk of all its trials'
//   activations in shared memory once (32 KB), each 16-byte word of xq split
//   as it is stored into its even and odd bytes (__byte_perm), which are
//   what the low and the high nibbles multiply; each word of a trial's
//   chunk is stored so that lane l's two words sit 32 words apart and a
//   warp's reads are conflict-free.  Each warp streams 16 packed bytes (32
//   weights) of each of its 4 rows per lane, unpacks them once and
//   multiplies them with every trial's 32 activations: 4 rows x 32 trials of
//   int32 sums in registers, 8 __dp4a per row and trial.  Each sum reduces
//   across the warp with __reduce_add_sync; lane b writes trial b's
//   epilogue in int4_mv's order.
// - int4_mm_t: int8_mm_t's __dp4a scheme on nibbles.  A block owns a strip of
//   512 columns (4 adjacent columns a thread: 2 packed bytes a row) and a
//   chunk of rows, with the chunk's activations of its 32 trials staged in
//   shared memory as words of 4 rows (read as broadcasts).  A thread takes
//   4 rows at a time: two __byte_perm gather the 4 rows' bytes of its column
//   pairs, lo_nibbles and hi_nibbles unpack them into 4 words of one column
//   x 4 rows (signed), and __dp4a takes each against every trial's word: 4
//   columns x 32 trials of int32 sums.  Each block stores its chunk's sums to
//   an int32 scratch (chunks x B x n_in) and a second kernel sums the chunks
//   and applies the scale.
// - A B above 32 takes a second group of blocks, which reads W again.
//   Non-aligned shapes take scalar instantiations: the same blocks, one
//   nibble at a time.
//
// Interface: plain C functions, loaded with ctypes; they launch on the
// caller's stream, never synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8.cuh"

namespace {

constexpr int kMvThreads = 256;  // int4_mv: 8 warps, one row each
constexpr int kMvRows = kMvThreads / 32;
constexpr int kTThreads = 64;    // int4_mv_t: threads per block
constexpr int kTCols = 32;       // int4_mv_t: columns (16 bytes) per thread, vector path
constexpr int kTBlocks = 1024;   // int4_mv_t: blocks to aim for (about 8 per SM)
constexpr int kRCols = 32;       // reduce: columns per block (one warp wide)
constexpr int kRLanes = 8;       // reduce: lanes of chunks per column

// Weight j of a packed row, in [-8, 7].
__device__ __forceinline__ int nibble(const uint8_t* row, int j) {
  const int b = __ldg(row + (j >> 1));
  return ((j & 1) ? (b >> 4) : (b & 15)) - 8;
}

// The low (weights 0, 2, 4, 6) and high (1, 3, 5, 7) nibbles of a packed word
// as signed bytes, n - 8 each: n + 0x78 stays inside its byte, and flipping
// the byte's top bit then takes 0x80 off (n >= 8) or adds 0x80 (n < 8, giving
// n - 8 mod 256).  Three or four integer instructions; __vsub4 takes more.
__device__ __forceinline__ int lo_nibbles(uint32_t u) {
  return static_cast<int>(((u & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u);
}
__device__ __forceinline__ int hi_nibbles(uint32_t u) {
  return static_cast<int>((((u >> 4) & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u);
}

// acc + the 8 weights of the packed word u times the 8 activations of the
// words a (activations 0-3) and b (4-7).
__device__ __forceinline__ int dot8(uint32_t u, uint32_t a, uint32_t b, int acc) {
  acc = __dp4a(lo_nibbles(u), static_cast<int>(__byte_perm(a, b, 0x6420)), acc);
  return __dp4a(hi_nibbles(u), static_cast<int>(__byte_perm(a, b, 0x7531)), acc);
}

template <bool kVec>
__global__ void __launch_bounds__(kMvThreads)
int4_mv_kernel(const uint8_t* __restrict__ wp, const int8_t* __restrict__ xq,
               const float* __restrict__ row_scale, const float* __restrict__ act_scale,
               float* __restrict__ out, int n_out, int n_in, int stride) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMvRows + (threadIdx.x >> 5);
  if (row >= n_out) return;
  const uint8_t* w = wp + static_cast<size_t>(row) * stride;
  int acc = 0;
  int j0 = 0;  // the first weight of the one-per-lane part
  if constexpr (kVec) {
    const int4* w16 = reinterpret_cast<const int4*>(w);
    const int4* x16 = reinterpret_cast<const int4*>(xq);
    const int nv = n_in / 32;
#pragma unroll 4
    for (int c = lane; c < nv; c += 32) {
      const int4 u = __ldcs(w16 + c);
      const int4 a = __ldg(x16 + 2 * c);
      const int4 b = __ldg(x16 + 2 * c + 1);
      acc = dot8(static_cast<uint32_t>(u.x), a.x, a.y, acc);
      acc = dot8(static_cast<uint32_t>(u.y), a.z, a.w, acc);
      acc = dot8(static_cast<uint32_t>(u.z), b.x, b.y, acc);
      acc = dot8(static_cast<uint32_t>(u.w), b.z, b.w, acc);
    }
    j0 = nv * 32;
  }
  for (int j = j0 + lane; j < n_in; j += 32)
    acc += nibble(w, j) * static_cast<int>(__ldg(xq + j));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0)
    out[row] = __fmul_rn(__fmul_rn(static_cast<float>(acc), row_scale[row]), *act_scale);
}

template <bool kVec>
__global__ void __launch_bounds__(kTThreads)
int4_mv_t_kernel(const uint8_t* __restrict__ wp, const int8_t* __restrict__ vq,
                 int* __restrict__ partial, int n_out, int n_in, int stride,
                 int rows_per_chunk) {
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
      // col0 is a multiple of 32, so its 16 bytes lie inside the row
      const uint8_t* base = wp + col0 / 2;
      int vsum = 0;
#pragma unroll 2
      for (int r = r0; r < r1; r += 4) {
        // four rows at a time: words[i][q] is word q of row r + i; a row
        // past the chunk holds zero weights against a zero activation
        uint32_t words[4][4];
        uint32_t v4 = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          int v = 0;
          if (r + i < r1) {
            const int4 w = __ldcs(reinterpret_cast<const int4*>(
                base + static_cast<size_t>(r + i) * stride));
            words[i][0] = static_cast<uint32_t>(w.x);
            words[i][1] = static_cast<uint32_t>(w.y);
            words[i][2] = static_cast<uint32_t>(w.z);
            words[i][3] = static_cast<uint32_t>(w.w);
            v = static_cast<int>(__ldg(vq + r + i));
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) words[i][q] = 0x88888888u;
          }
          vsum += v;
          v4 |= (static_cast<uint32_t>(v) & 0xffu) << (8 * i);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // transpose the 4 x 4 bytes: t[k] holds byte k of word q of the
          // four rows, i.e. columns 8q + 2k (low nibbles) and 8q + 2k + 1
          // (high nibbles) of rows r..r+3, against the four activations
          const uint32_t x0 = __byte_perm(words[0][q], words[1][q], 0x5140);
          const uint32_t x1 = __byte_perm(words[0][q], words[1][q], 0x7362);
          const uint32_t y0 = __byte_perm(words[2][q], words[3][q], 0x5140);
          const uint32_t y1 = __byte_perm(words[2][q], words[3][q], 0x7362);
          const uint32_t t[4] = {__byte_perm(x0, y0, 0x5410), __byte_perm(x0, y0, 0x7632),
                                 __byte_perm(x1, y1, 0x5410), __byte_perm(x1, y1, 0x7632)};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int lo = static_cast<int>(t[k] & 0x0F0F0F0Fu);
            const int hi = static_cast<int>((t[k] >> 4) & 0x0F0F0F0Fu);
            acc[8 * q + 2 * k] = __dp4a(lo, static_cast<int>(v4), acc[8 * q + 2 * k]);
            acc[8 * q + 2 * k + 1] = __dp4a(hi, static_cast<int>(v4), acc[8 * q + 2 * k + 1]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] -= 8 * vsum;  // the nibbles' offset
    } else {
#pragma unroll 4
      for (int r = r0; r < r1; ++r)
        acc[0] += nibble(wp + static_cast<size_t>(r) * stride, col0) *
                  static_cast<int>(__ldg(vq + r));
    }
  }
  // stage the strip's sums so that each warp stores consecutive words
#pragma unroll
  for (int c = 0; c < kCols; ++c) strip[threadIdx.x * kCols + c] = acc[c];
  __syncthreads();
  const int strip0 = blockIdx.x * kStrip;
  int* row = partial + static_cast<size_t>(blockIdx.y) * n_in;
  for (int k = threadIdx.x; k < kStrip; k += kTThreads) {
    const int j = strip0 + k;
    if (j < n_in) row[j] = strip[k];
  }
}

// out[j] = float(sum over the chunks of partial[c, j]) * act_scale.
__global__ void __launch_bounds__(kRCols * kRLanes)
reduce_scale_kernel(const int* __restrict__ partial, int chunks,
                    const float* __restrict__ act_scale, float* __restrict__ out, int n) {
  __shared__ int lanes[kRLanes][kRCols];
  const int j = blockIdx.x * kRCols + threadIdx.x;
  int sum = 0;
  if (j < n) {
#pragma unroll 4
    for (int c = threadIdx.y; c < chunks; c += kRLanes)
      sum += partial[static_cast<size_t>(c) * n + j];
  }
  lanes[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && j < n) {
#pragma unroll
    for (int l = 1; l < kRLanes; ++l) sum += lanes[l][threadIdx.x];
    out[j] = __fmul_rn(static_cast<float>(sum), *act_scale);
  }
}

// The chunks of rows int4_mv_t_launch splits n_out into, and the rows of each.
void t_chunks(int n_out, int n_in, int vec, int* chunks, int* rows) {
  if (n_out <= 0) {
    *chunks = 0;
    *rows = 0;
    return;
  }
  const int strip = kTThreads * (vec ? kTCols : 1);
  const int strips = (n_in + strip - 1) / strip;
  int c = kTBlocks / strips;
  c = c < 1 ? 1 : (c > n_out ? n_out : c);
  *rows = (n_out + c - 1) / c;
  *chunks = (n_out + *rows - 1) / *rows;
}

// ------------------------------------------------------------- batched
constexpr int kMmWarps = 4;                          // int4_mm: warps per block
constexpr int kMmThreads = 32 * kMmWarps;
constexpr int kMmRowsPerWarp = 4;
constexpr int kMmRows = kMmWarps * kMmRowsPerWarp;   // rows of W per block
constexpr int kTrials = 32;                          // trials per block (both kernels)
constexpr int kMmChunk = 1024;                       // inputs staged per trial and pass
constexpr int kMmWords = kMmChunk / 16;              // 16-byte words of a trial's chunk

// The even and the odd bytes of the 16 activations of a: the x, y words of
// the result are activations 0, 2, 4, 6 and 1, 3, 5, 7; z, w the same of
// 8-15 (the operands of dot8's two __dp4a).
__device__ __forceinline__ int4 split_even_odd(const int4 a) {
  const uint32_t x = static_cast<uint32_t>(a.x), y = static_cast<uint32_t>(a.y);
  const uint32_t z = static_cast<uint32_t>(a.z), w = static_cast<uint32_t>(a.w);
  return make_int4(static_cast<int>(__byte_perm(x, y, 0x6420)),
                   static_cast<int>(__byte_perm(x, y, 0x7531)),
                   static_cast<int>(__byte_perm(z, w, 0x6420)),
                   static_cast<int>(__byte_perm(z, w, 0x7531)));
}

template <bool kVec>
__global__ void __launch_bounds__(kMmThreads)
int4_mm_kernel(const uint8_t* __restrict__ wp, const int8_t* __restrict__ xq,
               const float* __restrict__ row_scale, const float* __restrict__ act_scale,
               float* __restrict__ out, int n_out, int n_in, int stride, int n_rows) {
  // 32 KB: the chunk of every trial; on the vector path word j of trial b
  // (activations 16j..16j+15, split_even_odd) at b * kMmWords + (j & 1) * 32
  // + j / 2, on the scalar path byte k of trial b at b * kMmChunk + k
  __shared__ int4 xs[kTrials * kMmWords];
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
    // this chunk's 16 packed bytes (32 weights) of each row, unpacked,
    // issued before the staging so that the loads overlap it; weights past
    // the matrix are zero (nibbles of 8)
    int lo[kMmRowsPerWarp][4], hi[kMmRowsPerWarp][4];
    if constexpr (kVec) {
      const int k = k0 + 32 * lane;
#pragma unroll
      for (int r = 0; r < kMmRowsPerWarp; ++r) {
        const int4 u = (row0 + r < n_out && k < n_in)
                           ? __ldcs(reinterpret_cast<const int4*>(
                                 wp + static_cast<size_t>(row0 + r) * stride + k / 2))
                           : make_int4(0x88888888, 0x88888888, 0x88888888, 0x88888888);
        const uint32_t words[4] = {static_cast<uint32_t>(u.x), static_cast<uint32_t>(u.y),
                                   static_cast<uint32_t>(u.z), static_cast<uint32_t>(u.w)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          lo[r][q] = lo_nibbles(words[q]);
          hi[r][q] = hi_nibbles(words[q]);
        }
      }
    }
    __syncthreads();  // the previous chunk is consumed
    if constexpr (kVec) {
#pragma unroll 4
      for (int j = 0; j < kTrials * kMmWords / kMmThreads; ++j) {  // four in flight
        const int idx = threadIdx.x + j * kMmThreads;
        const int b = idx / kMmWords;
        const int w = idx % kMmWords;
        const int k = k0 + 16 * w;
        const int4 a = (b < nb && k < n_in)
                           ? __ldg(reinterpret_cast<const int4*>(
                                 xq + static_cast<size_t>(b0 + b) * n_in + k))
                           : make_int4(0, 0, 0, 0);
        xs[b * kMmWords + (w & 1) * 32 + (w >> 1)] = split_even_odd(a);
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
        const int4 x0 = xs[b * kMmWords + lane];       // activations 0-15 of the lane's 32
        const int4 x1 = xs[b * kMmWords + 32 + lane];  // and 16-31
#pragma unroll
        for (int r = 0; r < kMmRowsPerWarp; ++r) {
          int a = acc[r][b];
          a = __dp4a(lo[r][0], x0.x, a);
          a = __dp4a(hi[r][0], x0.y, a);
          a = __dp4a(lo[r][1], x0.z, a);
          a = __dp4a(hi[r][1], x0.w, a);
          a = __dp4a(lo[r][2], x1.x, a);
          a = __dp4a(hi[r][2], x1.y, a);
          a = __dp4a(lo[r][3], x1.z, a);
          acc[r][b] = __dp4a(hi[r][3], x1.w, a);
        }
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
                      ? nibble(wp + static_cast<size_t>(row0 + r) * stride, k)
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

constexpr int kMtThreads = 128;  // int4_mm_t: threads per block
constexpr int kMtCols = 4;       // columns per thread (2 packed bytes a row)
constexpr int kMtStrip = kMtThreads * kMtCols;
constexpr int kMtBlocks = 512;   // int4_mm_t: blocks to aim for
constexpr int kMtMaxRows = 512;  // rows per chunk at most (the staged activations)

// Sign-extended byte k (0..3) of a 32-bit word.
__device__ __forceinline__ int sbyte(uint32_t u, int k) {
  return static_cast<int>(static_cast<int8_t>((u >> (8 * k)) & 0xffu));
}

// The 2 packed bytes of row r at columns col0..col0+3 (col0 a multiple of 4),
// as the low half of a word; rows past the chunk hold zero weights.
__device__ __forceinline__ uint32_t pair_bytes(const uint8_t* __restrict__ wp, int r, int r1,
                                               int col0, int stride) {
  if (r >= r1) return 0x8888u;
  return __ldcs(reinterpret_cast<const unsigned short*>(wp + static_cast<size_t>(r) * stride +
                                                        col0 / 2));
}

template <bool kVec>
__global__ void __launch_bounds__(kMtThreads)
int4_mm_t_kernel(const uint8_t* __restrict__ wp, const int8_t* __restrict__ vq,
                 int* __restrict__ partial, int n_out, int n_in, int stride, int n_rows,
                 int rows_per_chunk) {
  // the chunk's activations, word q of trial b at vs[q * kTrials + b]: rows
  // 4q..4q+3 of the chunk, zero past its end
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
          u |= static_cast<uint32_t>(static_cast<uint8_t>(
                   __ldg(vq + static_cast<size_t>(b0 + b) * n_out + r)))
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
      int col[kMtCols];  // column col0 + c of rows r..r+3, signed bytes
      if constexpr (kVec) {
        const uint32_t x = pair_bytes(wp, r, r1, col0, stride) |
                           (pair_bytes(wp, r + 1, r1, col0, stride) << 16);
        const uint32_t y = pair_bytes(wp, r + 2, r1, col0, stride) |
                           (pair_bytes(wp, r + 3, r1, col0, stride) << 16);
        const uint32_t t0 = __byte_perm(x, y, 0x6420);  // byte 0 of the 4 rows: columns 0, 1
        const uint32_t t1 = __byte_perm(x, y, 0x7531);  // byte 1: columns 2, 3
        col[0] = lo_nibbles(t0);
        col[1] = hi_nibbles(t0);
        col[2] = lo_nibbles(t1);
        col[3] = hi_nibbles(t1);
      } else {
#pragma unroll
        for (int c = 0; c < kMtCols; ++c) {
          uint32_t u = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int w = (r + k < r1 && col0 + c < n_in)
                              ? nibble(wp + static_cast<size_t>(r + k) * stride, col0 + c)
                              : 0;
            u |= (static_cast<uint32_t>(w) & 0xffu) << (8 * k);
          }
          col[c] = static_cast<int>(u);
        }
      }
#pragma unroll
      for (int b = 0; b < kTrials; ++b) {
        const int v = static_cast<int>(vs[q * kTrials + b]);
#pragma unroll
        for (int c = 0; c < kMtCols; ++c) acc[c][b] = __dp4a(col[c], v, acc[c][b]);
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

// The chunks of rows int4_mm_t_launch splits n_out into, and the rows of each
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

// ----------------------------------------------- int4_mm on the tensor cores
constexpr int kQaWarps = 4;
constexpr int kQaThreads = 32 * kQaWarps;
constexpr int kQaTiles = 4;                         // m-tiles of 16 rows a warp
constexpr int kQaWarpRows = 16 * kQaTiles;
constexpr int kQaRows = kQaWarps * kQaWarpRows;     // rows of W a block
constexpr int kQaBlockK = 128;                      // columns of a k-block: 16 bytes a lane and row
constexpr int kQaRing = 2;                          // k-blocks of W in flight a lane
constexpr int kQaPassCols = 2048;                   // columns of xq staged at once at most
constexpr int kQaParts = 2;                         // parts of the stage, waited for one by one
constexpr int kQaMaxCluster = 8;                    // chunks of columns (the portable cluster size)
constexpr int kQaBlocksPerSm = 2;                   // blocks an SM (the stage's shared memory)
constexpr int kQaRedPitch = kQaRows + 4;            // ints a trial in the sums' buffer
static_assert(kQaParts <= 4, "wait_copies waits for at most 3 pending groups");
static_assert(kQaPassCols % kQaBlockK == 0, "whole k-blocks a pass");
// Bytes a trial's row takes in the stage: 16 mod 32, so that the 16-byte
// reads of a quarter-warp (2 trials x 4 lanes 32 bytes apart) hit distinct
// banks; a multiple of 16 for cp.async.
constexpr int kQaStride = kQaPassCols + 16;
// one size of shared memory for every shape (the stage, then the sums), so
// that what fits on the card does not depend on the shape
constexpr int kQaSmem = kTrials * kQaStride > kTrials * kQaRedPitch * 4
                            ? kTrials * kQaStride : kTrials * kQaRedPitch * 4;
constexpr uint32_t kZeroWeights = 0x88888888u;      // 8 nibbles of 8: zero weights

// The stage position of activation j (0..15) of a 16-byte word once split:
// split_even_odd's order (the even bytes of the first 8, their odd bytes,
// the same of the last 8).
__host__ __device__ constexpr int split_pos(int j) { return (j & 8) + (j & 1) * 4 + (j & 7) / 2; }

// The tensor-core int4_mm (header note).  Grid: (strips of kQaRows rows,
// chunks of cols_per_chunk columns, groups of kTrials trials); the chunks of
// a strip and group are one cluster.  The caller takes this kernel only when
// stride % 16 == 0 and wp is 16-byte aligned; kVecStage: n_in % 16 == 0 and
// xq 16-byte aligned (the stage by cp.async, else byte by byte).
template <bool kVecStage>
__global__ void __launch_bounds__(kQaThreads, kQaBlocksPerSm)
int4_mm_mma_kernel(const uint8_t* __restrict__ wp, const int8_t* __restrict__ xq,
                   const float* __restrict__ row_scale, const float* __restrict__ act_scale,
                   float* __restrict__ out, int n_out, int n_in, int stride, int n_rows,
                   int cols_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // the fragments' group and thread in group
  const int b0 = blockIdx.z * kTrials;
  const int nb = min(kTrials, n_rows - b0);
  const int ntiles = (nb + 7) / 8;  // n-tiles with a trial in them
  const int c0 = blockIdx.y * cols_per_chunk;
  const int cols = max(0, min(n_in, c0 + cols_per_chunk) - c0);  // a chunk may be empty
  const int row0 = blockIdx.x * kQaRows + warp * kQaWarpRows;  // the warp's first row
  const unsigned char* s_lane = smem + g * kQaStride + 32 * t;  // trial g, columns 32t.. of a k-block

  // the lane's packed rows g and g + 8 of each m-tile (m = 2 * tile + half),
  // at its 16 bytes (columns 32t..32t+31) of the chunk's first k-block
  const uint8_t* w_row[2 * kQaTiles];
  bool row_ok[2 * kQaTiles];
#pragma unroll
  for (int m = 0; m < 2 * kQaTiles; ++m) {
    const int r = row0 + 16 * (m >> 1) + 8 * (m & 1) + g;
    row_ok[m] = r < n_out;
    w_row[m] = wp + static_cast<size_t>(row_ok[m] ? r : 0) * stride + c0 / 2 + 16 * t;
  }

  int c[kQaTiles][4][4];  // m-tile, n-tile, fragment element
#pragma unroll
  for (int u = 0; u < kQaTiles; ++u)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[u][nt][i] = 0;

  for (int p0 = 0; p0 < cols; p0 += kQaPassCols) {  // one pass at N = 10,000
    const int pcols = min(kQaPassCols, cols - p0);
    const int blocks = (pcols + kQaBlockK - 1) / kQaBlockK;
    if (p0 > 0) __syncthreads();  // the previous pass's stage is used up
    uint4 ring[kQaRing][2 * kQaTiles];  // kQaRing k-blocks ahead
    // zero weights (and no load) past the pass: a lane that loads starts
    // inside the pass, at a multiple of 16 bytes below ceil(n_in / 2) <=
    // stride, so its 16 bytes never reach the next row
    auto load_w = [&](int kb, uint4 (&w)[2 * kQaTiles]) {
      const int k = kb * kQaBlockK + 32 * t;  // the lane's first column in the pass
#pragma unroll
      for (int m = 0; m < 2 * kQaTiles; ++m)
        w[m] = (row_ok[m] && k < pcols)
                   ? mmas8::load_w16(w_row[m] + (p0 + kb * kQaBlockK) / 2)
                   : make_uint4(kZeroWeights, kZeroWeights, kZeroWeights, kZeroWeights);
    };
#pragma unroll
    for (int d = 0; d < kQaRing; ++d) load_w(d, ring[d]);

    // stage xq[b0 + b, c0 + p0 .. + blocks k-blocks) for the trials of the
    // n-tiles in use, zeros past the pass and past the trials, each 16-byte
    // word split into its even and odd bytes: in kQaParts parts of `part`
    // k-blocks, each waited for only when the k loop reaches it
    const int span = blocks * kQaBlockK;
    const int part = (blocks + kQaParts - 1) / kQaParts;
    const int8_t* x_pass = xq + static_cast<size_t>(b0) * n_in + c0 + p0;
    // part q's 16-byte words of each trial: [k0, k0 + n)
    auto part_words = [&](int q, int& k0, int& n) {
      k0 = min(span, q * part * kQaBlockK) / 16;
      n = min(span, (q + 1) * part * kQaBlockK) / 16 - k0;
    };
    if constexpr (kVecStage) {  // pcols is a multiple of 16: a copy is all in or all out
#pragma unroll
      for (int q = 0; q < kQaParts; ++q) {
        int k0, n;
        part_words(q, k0, n);
        for (int idx = threadIdx.x; idx < 8 * ntiles * n; idx += kQaThreads) {
          const int b = idx / n, k = 16 * (k0 + idx % n);
          const bool ok = b < nb && k < pcols;
          mmas8::copy16(smem + b * kQaStride + k,
                        ok ? x_pass + static_cast<size_t>(b) * n_in + k : xq, ok ? 16 : 0);
        }
        asm volatile("cp.async.commit_group;\n" ::);
      }
    } else {  // byte loads, each stored at its split position
      for (int idx = threadIdx.x; idx < 8 * ntiles * span; idx += kQaThreads) {
        const int b = idx / span, k = idx % span;
        smem[b * kQaStride + (k & ~15) + split_pos(k & 15)] =
            (b < nb && k < pcols)
                ? static_cast<unsigned char>(__ldg(x_pass + static_cast<size_t>(b) * n_in + k))
                : static_cast<unsigned char>(0);
      }
    }

    for (int kb0 = 0; kb0 < blocks; kb0 += kQaRing) {
#pragma unroll
      for (int d = 0; d < kQaRing; ++d) {
        const int kb = kb0 + d;
        if (kb >= blocks) break;
        if (kb % part == 0) {  // the stage's part kb / part has landed, for every thread
          mmas8::wait_copies(kQaParts - 1 - kb / part);
          if constexpr (kVecStage) {  // each thread splits the words it copied
            int k0, n;
            part_words(kb / part, k0, n);
            for (int idx = threadIdx.x; idx < 8 * ntiles * n; idx += kQaThreads) {
              int4* p = reinterpret_cast<int4*>(smem + (idx / n) * kQaStride +
                                                16 * (k0 + idx % n));
              *p = split_even_odd(*p);
            }
          }
          __syncthreads();
        }
        uint4 w[2 * kQaTiles];
#pragma unroll
        for (int m = 0; m < 2 * kQaTiles; ++m) w[m] = ring[d][m];
        load_w(kb + kQaRing, ring[d]);
        // word s of a packed row: columns 32t+8s..32t+8s+7; lo holds the
        // even ones (k slots 4t..4t+3 of k-step s), hi the odd ones (k
        // slots 16+4t..16+4t+3), as signed bytes
        uint32_t lo[2 * kQaTiles][4], hi[2 * kQaTiles][4];
#pragma unroll
        for (int m = 0; m < 2 * kQaTiles; ++m) {
          const uint32_t words[4] = {w[m].x, w[m].y, w[m].z, w[m].w};
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            lo[m][s] = static_cast<uint32_t>(lo_nibbles(words[s]));
            hi[m][s] = static_cast<uint32_t>(hi_nibbles(words[s]));
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= ntiles) break;
          // trial 8nt + g's split columns 32t..32t+31 of the k-block: the
          // even and the odd bytes of k-steps 0, 1 and then 2, 3
          const unsigned char* sb = s_lane + 8 * nt * kQaStride + kb * kQaBlockK;
          const uint4 b01 = *reinterpret_cast<const uint4*>(sb);
          const uint4 b23 = *reinterpret_cast<const uint4*>(sb + 16);
          const uint32_t bv[8] = {b01.x, b01.y, b01.z, b01.w, b23.x, b23.y, b23.z, b23.w};
#pragma unroll
          for (int u = 0; u < kQaTiles; ++u)
#pragma unroll
            for (int s = 0; s < 4; ++s)  // rows g and g + 8 of m-tile u
              mmas8::mma_s8(c[u][nt], lo[2 * u][s], lo[2 * u + 1][s], hi[2 * u][s],
                            hi[2 * u + 1][s], bv[2 * s], bv[2 * s + 1]);
        }
      }
    }
  }

  // the chunks' sums by trial and row, added across the cluster
  mmas8::rows_cluster_epilogue<kQaWarps, kQaTiles, kQaRedPitch, kQaMaxCluster>(
      c, reinterpret_cast<int*>(smem), nb, b0, row_scale, act_scale, out, n_out);
}

template <bool kVecStage>
cudaError_t launch_mm_mma(const uint8_t* w, const int8_t* x, const float* rs, const float* as,
                          float* out, int n_out, int n_in, int stride, int n_rows,
                          cudaStream_t st) {
  return mmas8::launch_column_clusters<kQaMaxCluster>(
      int4_mm_mma_kernel<kVecStage>, kQaThreads, kQaSmem, (n_out + kQaRows - 1) / kQaRows,
      (n_rows + kTrials - 1) / kTrials, n_in, kQaBlockK, st, w, x, rs, as, out, n_out, n_in,
      stride, n_rows);
}

}  // namespace

// wp: (n_out, stride) uint8, packed rows of n_in weights; xq: (n_in,) int8;
// row_scale: (n_out,) f32; act_scale: one f32 on the device; out: (n_out,)
// f32.  vec = 1 selects the 16-byte path: the caller sets it only when
// stride % 16 == 0 and wp and xq are 16-byte aligned.
extern "C" int int4_mv_launch(const void* wp, const void* xq, const void* row_scale,
                              const void* act_scale, void* out, int n_out, int n_in, int stride,
                              int vec, void* stream) {
  if (n_out <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n_out + kMvRows - 1) / kMvRows;
  const auto* w = static_cast<const uint8_t*>(wp);
  const auto* x = static_cast<const int8_t*>(xq);
  const auto* rs = static_cast<const float*>(row_scale);
  const auto* as = static_cast<const float*>(act_scale);
  auto* o = static_cast<float*>(out);
  if (vec) int4_mv_kernel<true><<<blocks, kMvThreads, 0, st>>>(w, x, rs, as, o, n_out, n_in, stride);
  else int4_mv_kernel<false><<<blocks, kMvThreads, 0, st>>>(w, x, rs, as, o, n_out, n_in, stride);
  return static_cast<int>(cudaGetLastError());
}

// The int32 elements of the scratch that int4_mv_t_launch needs for these
// arguments (chunks x n_in).
extern "C" long long int4_mv_t_scratch(int n_out, int n_in, int vec) {
  int chunks, rows;
  t_chunks(n_out, n_in, vec, &chunks, &rows);
  return static_cast<long long>(chunks) * (n_in > 0 ? n_in : 0);
}

// wp: (n_out, stride) uint8, packed rows of n_in weights; vq: (n_out,) int8;
// act_scale: one f32 on the device; partial: int32 scratch of
// int4_mv_t_scratch(n_out, n_in, vec) elements, written before it is read;
// out: (n_in,) f32.  vec = 1 selects the 16-byte path: the caller sets it
// only when stride % 16 == 0 and wp is 16-byte aligned.
extern "C" int int4_mv_t_launch(const void* wp, const void* vq, const void* act_scale,
                                void* partial, void* out, int n_out, int n_in, int stride,
                                int vec, void* stream) {
  if (n_in <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint8_t*>(wp);
  const auto* v = static_cast<const int8_t*>(vq);
  auto* p = static_cast<int*>(partial);
  int chunks, rows;
  t_chunks(n_out, n_in, vec, &chunks, &rows);
  if (chunks > 0) {
    const int strip = kTThreads * (vec ? kTCols : 1);
    const dim3 grid((n_in + strip - 1) / strip, chunks);
    if (vec) int4_mv_t_kernel<true><<<grid, kTThreads, 0, st>>>(w, v, p, n_out, n_in, stride, rows);
    else int4_mv_t_kernel<false><<<grid, kTThreads, 0, st>>>(w, v, p, n_out, n_in, stride, rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  reduce_scale_kernel<<<(n_in + kRCols - 1) / kRCols, dim3(kRCols, kRLanes), 0, st>>>(
      p, chunks, static_cast<const float*>(act_scale), static_cast<float*>(out), n_in);
  return static_cast<int>(cudaGetLastError());
}

// The routes of int4_mm_launch (ops/quant.py::int4_mm_route picks one).
constexpr int kRouteScalar = 0, kRouteVec = 1, kRouteMma = 2;

// The batched forward product.  wp: (n_out, stride) uint8, packed rows of
// n_in weights; xq: (n_rows, n_in) int8, contiguous; row_scale: (n_out,) f32;
// act_scale: (n_rows,) f32 on the device; out: (n_rows, n_out) f32.  route:
// kRouteMma (the tensor cores; the caller sets it only when stride is a
// multiple of 16 and wp 16-byte aligned), kRouteVec (the __dp4a kernel's
// 16-byte path: stride and n_in multiples of 16, wp and xq 16-byte aligned)
// or kRouteScalar.
extern "C" int int4_mm_launch(const void* wp, const void* xq, const void* row_scale,
                              const void* act_scale, void* out, int n_out, int n_in, int stride,
                              int n_rows, int route, void* stream) {
  if (n_out <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint8_t*>(wp);
  const auto* x = static_cast<const int8_t*>(xq);
  const auto* rs = static_cast<const float*>(row_scale);
  const auto* as = static_cast<const float*>(act_scale);
  auto* o = static_cast<float*>(out);
  if (route == kRouteMma) {
    const bool vec_stage = n_in % 16 == 0 && reinterpret_cast<uintptr_t>(xq) % 16 == 0;
    return static_cast<int>(
        vec_stage ? launch_mm_mma<true>(w, x, rs, as, o, n_out, n_in, stride, n_rows, st)
                  : launch_mm_mma<false>(w, x, rs, as, o, n_out, n_in, stride, n_rows, st));
  }
  const dim3 grid((n_out + kMmRows - 1) / kMmRows, (n_rows + kTrials - 1) / kTrials);
  if (route == kRouteVec)
    int4_mm_kernel<true><<<grid, kMmThreads, 0, st>>>(w, x, rs, as, o, n_out, n_in, stride, n_rows);
  else
    int4_mm_kernel<false><<<grid, kMmThreads, 0, st>>>(w, x, rs, as, o, n_out, n_in, stride, n_rows);
  return static_cast<int>(cudaGetLastError());
}

// The int32 elements of the scratch that int4_mm_t_launch needs for these
// arguments (chunks x n_rows x n_in).
extern "C" long long int4_mm_t_scratch(int n_out, int n_in, int n_rows) {
  int chunks, rows;
  mm_t_chunks(n_out, n_in, n_rows, &chunks, &rows);
  return static_cast<long long>(chunks) * n_rows * (n_in > 0 ? n_in : 0);
}

// The batched transposed product.  wp: (n_out, stride) uint8, packed rows of
// n_in weights; vq: (n_rows, n_out) int8, contiguous; act_scale: (n_rows,)
// f32 on the device; partial: int32 scratch of int4_mm_t_scratch(n_out,
// n_in, n_rows) elements, written before it is read; out: (n_rows, n_in)
// f32.  vec = 1 selects the 2-byte loads of the packed rows: the caller sets
// it only when stride is a multiple of 16 and wp 16-byte aligned.
extern "C" int int4_mm_t_launch(const void* wp, const void* vq, const void* act_scale,
                                void* partial, void* out, int n_out, int n_in, int stride,
                                int n_rows, int vec, void* stream) {
  if (n_in <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint8_t*>(wp);
  const auto* v = static_cast<const int8_t*>(vq);
  auto* p = static_cast<int*>(partial);
  int chunks, rows;
  mm_t_chunks(n_out, n_in, n_rows, &chunks, &rows);
  if (chunks > 0) {
    const dim3 grid((n_in + kMtStrip - 1) / kMtStrip, chunks, (n_rows + kTrials - 1) / kTrials);
    if (vec)
      int4_mm_t_kernel<true><<<grid, kMtThreads, 0, st>>>(w, v, p, n_out, n_in, stride, n_rows, rows);
    else
      int4_mm_t_kernel<false><<<grid, kMtThreads, 0, st>>>(w, v, p, n_out, n_in, stride, n_rows, rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mm_t_reduce_kernel<<<dim3((n_in + 255) / 256, n_rows), 256, 0, st>>>(
      p, chunks, n_rows, static_cast<const float*>(act_scale), static_cast<float*>(out), n_in);
  return static_cast<int>(cudaGetLastError());
}
