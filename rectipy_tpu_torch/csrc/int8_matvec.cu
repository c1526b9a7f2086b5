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
