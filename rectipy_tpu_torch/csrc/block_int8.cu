// The gathered int8 block contraction of a quantized block-sparse coupling,
// for NVIDIA Hopper (sm_90a):
//
//   out[b, r*bs + i] = float(sum_c sum_j bq[r, c, i, j] * xq[b, idx[r, c], j])
//                      * row_scale[r, i]
//
// with bq (n_br, cb, bs, bs) int8, row_scale (n_br, bs) float32, xq
// (B, n_src, bs) int8 (B rows of activations cut into bs-long blocks) and
// idx (n_br, cb) int32.  The caller multiplies by the activation scale
// afterwards, in its own order and dtype.
//
// It replaces no Pallas kernel: the JAX package computes this contraction as
// an XLA einsum with int32 sums (rectipy_tpu/ops/quant.py::block_int8_mv,
// the stack form at :399-438, and the frozen int8 block path of
// rectipy_tpu/dsl/lower.py:513-530).  PyTorch has no int8 batched product on
// the card (torch.bmm refuses int8 there; torch._int_mm is 2-D and wants at
// least 17 rows), and a float32 copy of the blocks per step would stream
// four times the bytes.  Its callers:
// - node couplings pass idx = cols, with the quantized source viewed as
//   (B, nb_in, bs);
// - the delayed BlockSparseLinear edge passes its quantized gathered stack
//   viewed as (B, n_br * cb, bs), with idx = arange(n_br * cb).
//
// Bound.  Each call must read bq once, n_br * cb * bs^2 bytes: 2.05e9 at the
// million-neuron cell (1,954 block rows x 4 source blocks x 512^2), far above
// the 50 MB L2, so it streams from HBM: about 0.61 ms at the data-sheet
// 3.35 TB/s for one trial.  The activations and outputs add B * 5N bytes.
// The 2 * B * N * cb * bs integer operations (6.6e10 at B = 16) take 0.03
// ms at the tensor cores' int8 rate, so the bytes bound it; on the CUDA
// cores' __dp4a they come close to the bytes at B = 16.  These are derived
// figures, not measurements.
//
// Design (a first, simple one; wgmma/TMA are later work):
// - One thread block of 8 warps per (block row r, tile of 128 rows i, group
//   of up to 16 trials).  The block first stages, for each of its trials,
//   the cb source blocks idx[r, 0..cb-1] in shared memory, one after the
//   other: cb * bs bytes a trial (2 KB at cb = 4, bs = 512; 32 KB for 16
//   trials), with 16-byte copies where the shapes allow.
// - A warp then takes one row i at a time: its cb * bs weights are cb
//   segments of bs contiguous bytes, which the lanes read 16 bytes each
//   (neighbouring lanes on neighbouring addresses, streaming loads), and
//   __dp4a multiplies each 16-byte piece with every trial's 16 bytes from
//   shared memory into int32 sums held in registers (one per trial).
// - __reduce_add_sync sums each trial's row across the warp; lane t writes
//   trial t's float(sum) * row_scale[r, i].
// - bs % 16 == 0 with 16-byte aligned bq and xq takes 16-byte pieces;
//   bs % 4 == 0 with 4-byte alignment 4-byte pieces; anything else (the
//   reference's tests use bs = 4 and 16; a bs of 20 also takes the 4-byte
//   pieces) one byte at a time.
// The sums are integers, exact in any order (the wrapper refuses a cb * bs
// that could overflow int32), so the kernel agrees bit for bit with the
// plain version.
//
// Interface: a plain C function, loaded with ctypes; it launches on the
// caller's stream, never synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;       // rows of a block row a thread block owns
constexpr int kMaxTrials = 16;   // trials a thread block carries
constexpr int kSmemMax = 227 * 1024;

// V: bytes a lane reads at once (16, 4 or 1).
template <int V>
__global__ void __launch_bounds__(kThreads)
block_int8_mv_kernel(const int8_t* __restrict__ bq, const float* __restrict__ row_scale,
                     const int8_t* __restrict__ xq, const int32_t* __restrict__ idx,
                     float* __restrict__ out, int n_br, int cb, int bs, int n_src,
                     int n_trials, int trials_per_block, int stride) {
  extern __shared__ int4 smem4[];
  int8_t* xs = reinterpret_cast<int8_t*>(smem4);
  const int r = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int b0 = blockIdx.z * trials_per_block;
  const int tb = min(trials_per_block, n_trials - b0);
  const int nv = bs / V;        // pieces in a bs-long segment
  const int q_all = cb * nv;    // pieces in a row

  // stage: trial t, source block c -> xs[t * stride + c * bs + j]
  for (int u = threadIdx.x; u < tb * q_all; u += kThreads) {
    const int t = u / q_all;
    const int rem = u - t * q_all;
    const int c = rem / nv;
    const int p = rem - c * nv;
    const int8_t* src = xq + (static_cast<size_t>(b0 + t) * n_src + idx[r * cb + c]) * bs;
    int8_t* dst = xs + t * stride + c * bs;
    if constexpr (V == 16) {
      reinterpret_cast<int4*>(dst)[p] = reinterpret_cast<const int4*>(src)[p];
    } else if constexpr (V == 4) {
      reinterpret_cast<int*>(dst)[p] = reinterpret_cast<const int*>(src)[p];
    } else {
      dst[p] = src[p];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_end = min(row0 + kRows, bs);
  const size_t seg = static_cast<size_t>(bs) * bs;  // bytes between a row's segments
  for (int i = row0 + warp; i < row_end; i += kWarps) {
    int acc[kMaxTrials];
#pragma unroll
    for (int t = 0; t < kMaxTrials; ++t) acc[t] = 0;
    const int8_t* wrow = bq + (static_cast<size_t>(r) * cb * bs + i) * bs;
#pragma unroll 4
    for (int q = lane; q < q_all; q += 32) {
      const int c = q / nv;
      const int off = (q - c * nv) * V;
      const int8_t* w = wrow + c * seg + off;
      const int8_t* x = xs + c * bs + off;
      if constexpr (V == 16) {
        const int4 a = __ldcs(reinterpret_cast<const int4*>(w));
#pragma unroll
        for (int t = 0; t < kMaxTrials; ++t) {
          if (t < tb) {
            const int4 b = *reinterpret_cast<const int4*>(x + t * stride);
            int s = __dp4a(a.x, b.x, acc[t]);
            s = __dp4a(a.y, b.y, s);
            s = __dp4a(a.z, b.z, s);
            acc[t] = __dp4a(a.w, b.w, s);
          }
        }
      } else if constexpr (V == 4) {
        const int a = __ldcs(reinterpret_cast<const int*>(w));
#pragma unroll
        for (int t = 0; t < kMaxTrials; ++t) {
          if (t < tb) acc[t] = __dp4a(a, *reinterpret_cast<const int*>(x + t * stride), acc[t]);
        }
      } else {
        const int a = w[0];
#pragma unroll
        for (int t = 0; t < kMaxTrials; ++t) {
          if (t < tb) acc[t] += a * static_cast<int>(x[t * stride]);
        }
      }
    }
    int mine = 0;
#pragma unroll
    for (int t = 0; t < kMaxTrials; ++t) {
      if (t < tb) {
        const int s = __reduce_add_sync(0xffffffffu, acc[t]);
        if (lane == t) mine = s;
      }
    }
    if (lane < tb) {
      const int row = r * bs + i;
      out[static_cast<size_t>(b0 + lane) * n_br * bs + row] =
          static_cast<float>(mine) * row_scale[row];
    }
  }
}

template <int V>
int launch(const int8_t* bq, const float* rs, const int8_t* xq, const int32_t* idx, float* out,
           int n_br, int cb, int bs, int n_src, int n_trials, cudaStream_t st) {
  const int stride = (cb * bs + 15) & ~15;  // a trial's staged bytes, 16-byte aligned
  int per_block = kSmemMax / stride;
  if (per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  per_block = per_block < kMaxTrials ? per_block : kMaxTrials;
  per_block = per_block < n_trials ? per_block : n_trials;
  const int smem = per_block * stride;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_int8_mv_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(n_br, (bs + kRows - 1) / kRows, (n_trials + per_block - 1) / per_block);
  block_int8_mv_kernel<V><<<grid, kThreads, smem, st>>>(bq, rs, xq, idx, out, n_br, cb, bs,
                                                        n_src, n_trials, per_block, stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bq: (n_br, cb, bs, bs) int8; row_scale: (n_br, bs) f32; xq: (n_trials,
// n_src, bs) int8; idx: (n_br, cb) int32, every entry in [0, n_src); out:
// (n_trials, n_br * bs) f32.  All contiguous on the device.  The route
// follows bs and the alignment of bq and xq (16-, 4- or 1-byte pieces).
extern "C" int block_int8_mv_launch(const void* bq, const void* row_scale, const void* xq,
                                    const void* idx, void* out, int n_br, int cb, int bs,
                                    int n_src, int n_trials, void* stream) {
  if (n_br <= 0 || n_trials <= 0 || bs <= 0 || cb <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const int8_t*>(bq);
  const auto* rs = static_cast<const float*>(row_scale);
  const auto* x = static_cast<const int8_t*>(xq);
  const auto* ix = static_cast<const int32_t*>(idx);
  auto* o = static_cast<float*>(out);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(bq) | reinterpret_cast<uintptr_t>(xq);
  if (bs % 16 == 0 && addr % 16 == 0)
    return launch<16>(w, rs, x, ix, o, n_br, cb, bs, n_src, n_trials, st);
  if (bs % 4 == 0 && addr % 4 == 0)
    return launch<4>(w, rs, x, ix, o, n_br, cb, bs, n_src, n_trials, st);
  return launch<1>(w, rs, x, ix, o, n_br, cb, bs, n_src, n_trials, st);
}
