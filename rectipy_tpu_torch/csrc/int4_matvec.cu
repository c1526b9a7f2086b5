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
//   7) become four signed bytes each with a mask and __vsub4; __byte_perm
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
// Interface: plain C functions, loaded with ctypes; they launch on the
// caller's stream, never synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

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

// acc + the 8 weights of the packed word u times the 8 activations of the
// words a (activations 0-3) and b (4-7).
__device__ __forceinline__ int dot8(uint32_t u, uint32_t a, uint32_t b, int acc) {
  const int lo = static_cast<int>(__vsub4(u & 0x0F0F0F0Fu, 0x08080808u));
  const int hi = static_cast<int>(__vsub4((u >> 4) & 0x0F0F0F0Fu, 0x08080808u));
  acc = __dp4a(lo, static_cast<int>(__byte_perm(a, b, 0x6420)), acc);
  return __dp4a(hi, static_cast<int>(__byte_perm(a, b, 0x7531)), acc);
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
