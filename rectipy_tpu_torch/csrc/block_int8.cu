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
// Design, two routes (ops/quant.py::block_int8_mv_route picks one):
// - "mma", on the tensor cores (bs % 32 == 0, bq and xq 16-byte aligned).
//   For each block row r the product is an int8 GEMM: M = the bs rows i,
//   K = the cb * bs gathered columns, N = the trials; int8_mm_mma_kernel's
//   (int8_matvec.cu) with another stage and W address, on the k loop the
//   two share (mma_s8.cuh's rows_mma_sums).  mma.sync m16n8k32 s8 x s8 -> s32
//   with A fragments straight from the blocks' rows and B fragments from a
//   staged copy of the gathered sources, under the k-permutation the two
//   share (mma_s8.cuh):
//   - a tile is kRowBlockRows = 128 rows of one block row (4 warps of 2
//     m-tiles of 16 rows) for up to kRowTrials = 32 trials (4 n-tiles of
//     8), so that W streams once for B <= 32; n-tiles past the trials are
//     skipped;
//   - the stage: cp.async copies, 16 bytes each, of each trial's cb
//     segments xq[b, idx[r, c], :] one after the other, rows padded to 64
//     mod 128 bytes so that a quarter-warp's 16-byte B reads hit distinct
//     banks, in passes of at most kRowPassCols columns and four parts that
//     the k loop waits for one by one, after the first W loads are out;
//     zeros past the pass and past the trials;
//   - a thread block stages its block row once and walks several tiles on
//     that stage (where cb * bs takes one pass): K is short (2,048 columns,
//     256 KB of W a tile at the million-neuron cell), so one tile a block
//     paid the stage's wait and 64 KB of L2 reads (B = 32) for every 256 KB
//     of W.  mma_tiles_per_block takes the most tiles, a power of two, that
//     leave kMmaMinWaves waves of blocks: all 4 at the million-neuron cell,
//     one at the delay edge's 196 block rows;
//   - lane (g, t) loads 16 bytes of rows g and g + 8 of each m-tile at
//     gathered columns 16t..16t+15 of each 64-column sub-block: the piece
//     of block (r, k / bs) at offset k % bs (bs % 16 == 0 keeps a piece
//     inside one segment); bytes 0-7 are k-step 0's A registers, bytes
//     8-15 k-step 1's, and the B registers of trial 8 nt + g are the same
//     16 bytes of its staged row;
//   - each k-block of 128 columns is loaded kRowRing k-blocks ahead of its
//     use, with loads that skip L1 (load_w16);
//   - the epilogue writes each C fragment's float(sum) * row_scale straight
//     to out: a quarter-warp's stores fill whole 32-byte sectors.
//   One B fragment read from shared memory serves both m-tiles of a warp:
//   0.5 bytes of shared reads for each byte of W, against the __dp4a
//   route's B bytes.
// - "vec16", "vec4", "scalar", on the CUDA cores' __dp4a (the first
//   design, the yardstick of "mma" and the route of the shapes it does not
//   take): one thread block of 8 warps per (block row r, tile of 128 rows
//   i, group of up to 16 trials).  The block first stages, for each of its
//   trials, the cb source blocks idx[r, 0..cb-1] in shared memory, one
//   after the other.  A warp then takes one row i at a time: its cb * bs
//   weights are cb segments of bs contiguous bytes, which the lanes read
//   16, 4 or 1 bytes at a time (neighbouring lanes on neighbouring
//   addresses, streaming loads), and __dp4a multiplies each piece with
//   every trial's piece from shared memory into int32 sums held in
//   registers; __reduce_add_sync sums each trial's row across the warp.
//   "vec16" wants bs % 16 == 0 with 16-byte aligned bq and xq, "vec4" bs %
//   4 == 0 with 4-byte alignment, "scalar" nothing (the reference's tests
//   use bs = 4, 16 and 20).  Each warp reads B bytes of shared memory for
//   every byte of W: about 3.3e10 bytes at B = 16, which bounds it there.
// The route.  chip_smoke.py's phase 33 times "mma" in turns with "vec16" at
// the million-neuron shape (NVIDIA H100 80GB HBM3, 700 W): 0.684, 0.692,
// 0.718, 0.740, 0.776 and 0.858 ms at B = 1, 2, 4, 8, 16 and 32 against
// 0.834, 0.868, 0.947, 1.128, 1.588 and 3.114 (90% to 77% of the byte
// bound against 74% to 21%), and 0.0815 against 0.1214 ms at the delay
// edge's stack for one trial.  The measurement found no cut-off in B: the
// tensor cores take every call their shapes allow, and the __dp4a pieces
// only the shapes they do not.  Tried and slower at B = 16 and 32 (a
// throwaway timing script, no figures kept): one tile a thread block, two
// tiles, three blocks an SM, a ring of 3 k-blocks, 2, 8 or 16 warps a
// block (8 and 16 spill).
// The sums are integers, exact in any order (the wrapper refuses a cb * bs
// that could overflow int32), so both routes agree bit for bit with the
// plain version.
//
// Interface: a plain C function, loaded with ctypes; it launches on the
// caller's stream, never synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8.cuh"

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

// ------------------------------------------------------- on the tensor cores
// The geometry and the k loop are mmas8::rows_mma_sums' (kRow*), as
// int8_mm_mma_kernel's: a tile is kRowBlockRows rows of one block row.
constexpr int kMmaBlocksPerSm = 2;
constexpr int kMmaMinWaves = 4;  // waves of thread blocks a call keeps

// Grid: (block rows x chunks of tiles_per_block tiles of kRowBlockRows rows,
// the chunk fastest; groups of kRowTrials trials).  A thread block stages
// its block row's sources once (once a pass where cb * bs needs more than
// one) and walks its tiles.  Needs bs % 32 == 0 and bq, xq 16-byte aligned.
__global__ void __launch_bounds__(mmas8::kRowThreads, kMmaBlocksPerSm)
block_int8_mma_kernel(const int8_t* __restrict__ bq, const float* __restrict__ row_scale,
                      const int8_t* __restrict__ xq, const int32_t* __restrict__ idx,
                      float* __restrict__ out, int n_br, int cb, int bs, int n_src,
                      int n_trials, int tiles, int tiles_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // the fragments' group and thread in group
  const int chunks = (tiles + tiles_per_block - 1) / tiles_per_block;
  const int r = blockIdx.x / chunks;
  const int tile0 = (blockIdx.x - r * chunks) * tiles_per_block;
  const int tile1 = min(tile0 + tiles_per_block, tiles);
  const int b0 = blockIdx.y * mmas8::kRowTrials;
  const int nb = min(mmas8::kRowTrials, n_trials - b0);
  const int K = cb * bs;  // the gathered columns of a row
  const size_t seg = static_cast<size_t>(bs) * bs;
  const int8_t* w_r = bq + static_cast<size_t>(r) * cb * seg;  // block row r's cb blocks
  const int32_t* idx_r = idx + r * cb;
  const size_t n_out = static_cast<size_t>(n_br) * bs;
  // gathered column col of trial b: xq[b0 + b, idx[r, col / bs], col % bs]
  const auto src = [&](int b, int col) {
    const int blk = col / bs;
    return xq + (static_cast<size_t>(b0 + b) * n_src + __ldg(idx_r + blk)) * bs + (col - blk * bs);
  };

  for (int tile = tile0; tile < tile1; ++tile) {
    const int row0 = tile * mmas8::kRowBlockRows + warp * mmas8::kRowWarpRows;  // warp's first
    // the lane's rows g and g + 8 of each m-tile (m = 2 * u + half): their
    // offsets inside a block
    size_t w_row[2 * mmas8::kRowTiles];
    bool row_ok[2 * mmas8::kRowTiles];
#pragma unroll
    for (int m = 0; m < 2 * mmas8::kRowTiles; ++m) {
      const int i = row0 + 16 * (m >> 1) + 8 * (m & 1) + g;
      row_ok[m] = i < bs;
      w_row[m] = static_cast<size_t>(row_ok[m] ? i : 0) * bs;
    }
    // gathered columns col..col + 15 (inside one segment, bs % 16 == 0):
    // block (r, col / bs) at offset col % bs
    const auto load_w = [&](int col, int end, uint4 (&w)[2 * mmas8::kRowTiles]) {
      const bool ok = col < end;
      const int kk = ok ? col : 0;
      const int blk = kk / bs;
      const int8_t* w_k = w_r + blk * seg + (kk - blk * bs);
#pragma unroll
      for (int m = 0; m < 2 * mmas8::kRowTiles; ++m)
        w[m] = (row_ok[m] && ok) ? mmas8::load_w16(w_k + w_row[m]) : make_uint4(0u, 0u, 0u, 0u);
    };

    int c[mmas8::kRowTiles][4][4];  // m-tile, n-tile, fragment element
    mmas8::rows_mma_sums<true>(c, smem, K, nb, K > mmas8::kRowPassCols || tile == tile0,
                               tile > tile0, load_w, src);

    // element i of C fragment (u, nt): row g + 8 (i / 2) of m-tile u, trial
    // 8 nt + 2t + i % 2
#pragma unroll
    for (int u = 0; u < mmas8::kRowTiles; ++u)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = row0 + 16 * u + g + 8 * (i >> 1);
          const int b = 8 * nt + 2 * t + (i & 1);
          if (row < bs && b < nb) {
            const size_t o = static_cast<size_t>(r) * bs + row;
            out[(b0 + b) * n_out + o] =
                __fmul_rn(static_cast<float>(c[u][nt][i]), row_scale[o]);
          }
        }
  }
}

// The row tiles a thread block walks: the most, a power of two, that still
// leave kMmaMinWaves waves of thread blocks (n_br * chunks * groups of
// them, kMmaBlocksPerSm an SM), so that a stage serves many rows while the
// last, partial wave stays a small share of the call.
cudaError_t mma_tiles_per_block(int n_br, int tiles, int groups, int* per) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long wave = static_cast<long long>(sms) * kMmaBlocksPerSm;
  *per = 1;
  while (2 * *per <= tiles &&
         static_cast<long long>(n_br) * ((tiles + 2 * *per - 1) / (2 * *per)) * groups >=
             kMmaMinWaves * wave)
    *per *= 2;
  return cudaSuccess;
}

int launch_mma(const int8_t* bq, const float* rs, const int8_t* xq, const int32_t* idx,
               float* out, int n_br, int cb, int bs, int n_src, int n_trials, cudaStream_t st) {
  const int tiles = (bs + mmas8::kRowBlockRows - 1) / mmas8::kRowBlockRows;
  const int groups = (n_trials + mmas8::kRowTrials - 1) / mmas8::kRowTrials;
  int tiles_per_block = 1;
  const cudaError_t e = mma_tiles_per_block(n_br, tiles, groups, &tiles_per_block);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int chunks = (tiles + tiles_per_block - 1) / tiles_per_block;
  const int first = min(n_trials, mmas8::kRowTrials);  // the widest group
  const int smem = 8 * ((first + 7) / 8) * mmas8::kRowStride;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_int8_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(n_br * chunks, groups);
  block_int8_mma_kernel<<<grid, mmas8::kRowThreads, smem, st>>>(
      bq, rs, xq, idx, out, n_br, cb, bs, n_src, n_trials, tiles, tiles_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The routes of block_int8_mv_launch (ops/quant.py::_BLOCK_ROUTES).
constexpr int kRouteScalar = 0, kRouteVec4 = 1, kRouteVec16 = 2, kRouteMma = 3;

// bq: (n_br, cb, bs, bs) int8; row_scale: (n_br, bs) f32; xq: (n_trials,
// n_src, bs) int8; idx: (n_br, cb) int32, every entry in [0, n_src); out:
// (n_trials, n_br * bs) f32.  All contiguous on the device.  route: kRouteMma
// (bs % 32 == 0, bq and xq 16-byte aligned), kRouteVec16 (bs % 16 == 0, the
// same alignment), kRouteVec4 (bs % 4 == 0, 4-byte aligned) or
// kRouteScalar; a route whose conditions fail returns cudaErrorInvalidValue.
extern "C" int block_int8_mv_launch(const void* bq, const void* row_scale, const void* xq,
                                    const void* idx, void* out, int n_br, int cb, int bs,
                                    int n_src, int n_trials, int route, void* stream) {
  if (n_br <= 0 || n_trials <= 0 || bs <= 0 || cb <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const int8_t*>(bq);
  const auto* rs = static_cast<const float*>(row_scale);
  const auto* x = static_cast<const int8_t*>(xq);
  const auto* ix = static_cast<const int32_t*>(idx);
  auto* o = static_cast<float*>(out);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(bq) | reinterpret_cast<uintptr_t>(xq);
  switch (route) {
    case kRouteMma:
      if (bs % 32 != 0 || addr % 16 != 0) break;
      return launch_mma(w, rs, x, ix, o, n_br, cb, bs, n_src, n_trials, st);
    case kRouteVec16:
      if (bs % 16 != 0 || addr % 16 != 0) break;
      return launch<16>(w, rs, x, ix, o, n_br, cb, bs, n_src, n_trials, st);
    case kRouteVec4:
      if (bs % 4 != 0 || addr % 4 != 0) break;
      return launch<4>(w, rs, x, ix, o, n_br, cb, bs, n_src, n_trials, st);
    case kRouteScalar:
      return launch<1>(w, rs, x, ix, o, n_br, cb, bs, n_src, n_trials, st);
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
