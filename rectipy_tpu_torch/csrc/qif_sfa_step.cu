// Fused explicit-Euler step of a QIF(+SFA) spiking population with a dense
// coupling, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rectipy_tpu/ops/kernels.py::
// make_qif_sfa_pallas_step (kernel body kernels.py:80-109).  For neuron i:
//
//   s_in   = sum_j W[i, j] * s[j]          f32 sums; a bf16 W takes s rounded
//                                          to bf16, as the TPU kernel does
//   reset  = (v - thresh >= 0) ? 1 : 0     from the pre-update v
//   spikes = reset / dt
//   v'     = (v + dt*((v*v + (eta - x) + inp)/tau + k*s_in)) * (1 - reset)
//            + reset * v_reset
//   s'     = s + dt*(-s/tau_s + spikes)
//   x'     = x + dt*(-x/tau_x + alpha*spikes)
//
// Bound.  The step must read W once: N*N*sizeof(W) bytes, 200 MB in bf16 and
// 400 MB in f32 at N = 10,000.  That is far above the H100's 50 MB L2, so W
// streams from HBM every step, and at the data-sheet 3.35 TB/s the step takes
// at least ~60 us (bf16) or ~119 us (f32).  The state vectors (five reads and
// three writes of N floats, 0.3 MB) do not move that bound.  These are derived
// figures, not measurements.
//
// Design against that bound:
// - W stays row-major: the TPU kernel's transposed, tile-padded copy served
//   the MXU's lane layout and has no purpose here.  One block owns one output
//   row, so no sum crosses blocks, and N small blocks keep every SM busy up to
//   the last row.
// - Threads read 16-byte vectors of W[i, :] (4 f32 or 8 bf16 values) and the
//   matching s values, neighbouring threads on neighbouring addresses, so each
//   W byte is read once in full 128-byte lines.  W is loaded with the
//   streaming hint (it is used once per step); s (40 KB at N = 10,000) is
//   shared by all rows and is read through the read-only cache.  The loop is
//   unrolled so each thread keeps several loads in flight (row_dot.cuh, which
//   the generic fused step shares).
// - The row sum reduces by warp shuffles, then across the block's warps in
//   shared memory; thread 0 runs the QIF+SFA epilogue for neuron i.
// - When n is not a multiple of the vector width, or W or s is not 16-byte
//   aligned, the scalar instantiation runs instead: the same arithmetic with
//   one element per thread and load.  Nothing is padded.
//
// The B-row form (qif_sfa_rows_launch) is the same step for B independent
// trials that share W: the TPU kernel as the JAX package's run_batch runs it
// under vmap.  W must still be read once per group of 32 trials: 0.0598 ms in
// bf16 and 0.1195 ms in f32 at 3.35 TB/s (N = 10,000), plus 0.0030 ms of the
// trials' states.
// - The trap: the single-row form, one block per row, would re-read all B
//   source rows s[b, :] per W row, 12.8 GB from L2 per step at B = 32.
//
// A bf16 W with n % 8 == 0, ld_s % 4 == 0 and W and s 16-byte aligned takes
// the tensor cores (qif_sfa_rows_mma_kernel), the MXU's bf16 x bf16 -> f32
// product of the TPU kernel (kernels.py:88-92).  It replaces a CUDA-core
// instance that ran at 18% of the bound: its 2*B*N^2 = 6.4e9 operations on
// 210 MB are 30 operations a byte, above the CUDA cores' ridge (67 TFLOP/s
// over 3.35 TB/s, 20 a byte), so it was bound by its FMAs at >= 0.096 ms;
// the tensor cores' ridge is 295 a byte (989 TFLOP/s), so there the step is
// bound by its bytes (0.0628 ms) and its products take 0.0065 ms.
// - mma.sync m16n8k16 bf16 x bf16 -> f32: A = 16 rows of W x 16 k, B = 16 k x
//   8 trials; four n-tiles cover a block's 32 trials.  (wgmma would gain
//   nothing where the products take a tenth of the bytes' time.)
// - W goes from HBM straight into registers: lane l loads 16 bytes (8 bf16)
//   of rows l/4 and l/4 + 8 at k-offset 8 (l % 4) of a 32-wide k-slab, which
//   are two k16 A-fragments once k is permuted (fragment 1 takes the first
//   and second 4-byte words of each row's 16 bytes, fragment 2 the third and
//   fourth).  The sum over k does not depend on the order of k, so the same
//   permutation applied to the B-fragments is exact, and then a lane's
//   B-fragments of one n-tile are one 16-byte shared load of its trial's s
//   at the same 8 inputs.
// - A block owns 80 rows of W and 32 trials: 125 blocks at N = 10,000, one
//   wave of one block an SM.  Its ten warps are 5 row tiles x 2 parts of K:
//   every chunk of 384 inputs is split 192 / 192.  Each lane keeps a chunk
//   of W loads in flight, 6 slabs x 2 x 16 B in registers (a ring), which
//   across the card is about 7.7 MB: Little's law at 3.35 TB/s wants 3-4 MB
//   for a microsecond of HBM latency.
// - The trials' s goes through L2 once per block (125 x 1.28 MB = 160 MB per
//   step; 16-row blocks read 800 MB): each chunk of the 32 trials' f32 s is
//   copied with cp.async while the previous chunk is used, and each thread
//   rounds the values it copied itself to bf16 (RNE, as the TPU kernel and
//   torch's .to(bfloat16) round) into one of two shared buffers, each trial
//   row padded to 64 mod 128 bytes so that the 16-byte reads of a
//   quarter-warp (two trials) hit 32 distinct banks.  One barrier a chunk.
// - The tensor cores' f32 sums may truncate: each slab's two products start
//   from zero and their sum (32 terms, about 0.016) is added to f32
//   registers by ordinary round-to-nearest adds, so no biased error grows
//   over the 625 k16 steps of a row.
// - The two K parts meet in shared memory; the accumulator fragment gives
//   each lane 2 rows x 2 trials of every n-tile, so no shuffle is needed:
//   each part runs the shared epilogue for two n-tiles, masking rows >= n
//   and trials >= the group's count.
// - What it tried and left (PERF.md): 16- and 64-row blocks at two
//   an SM (the 128-register cap spilled), s held in registers, L2
//   prefetches of W further ahead, longer chunks with a shorter ring,
//   producer warps on mbarriers, a barrier per K part.  What holds it back
//   (the probes below, timed by chip_smoke.py): the W stream in this load
//   pattern, the fragment reads and the barrier between chunks.
//
// A f32 W with n % 4 == 0, ld_s % 4 == 0 and W and s 16-byte aligned takes
// qif_sfa_rows_tiled_kernel on the CUDA cores (route 3, "tiled"): TF32 would
// change its numbers.  Its 3.2e9 FMAs at N = 10,000, B = 32 take 0.096 ms at
// the f32 peak, 80% of W's 0.1195 ms of bytes, so it must stream W near the
// HBM rate and keep the FMA pipe about 80% busy at once.  Its sums are
// rows_tiled.cuh's (whose header note gives the design): 80-row strips, W
// and s through a cp.async ring in shared memory, a register micro-tile of
// 10 rows x 8 trials a lane (18 shared loads feed 320 FMAs), eight K parts
// that meet in shared memory, and each (trial, row) sum through the shared
// epilogue once, rows >= n and trials >= the group's count masked.  As the
// route of an aligned f32 W it replaces the vector instance below, which ran
// at 42% of its bound (PERF.md).
//
// Every other B-row launch (a f32 or bf16 W that is not aligned as above)
// runs qif_sfa_rows_kernel on the CUDA cores.  Its f32 vector instance (route
// 1, "vec") stays reachable through the C entry as a yardstick; no Python
// route picks it.
// - A block of 4 warps owns 16 rows of W and up to 32 trials.  For each
//   chunk of 128 inputs, it stages that chunk of every trial's s in shared
//   memory once (16 KB; rounded to bf16 for a bf16 W, as the single-row
//   kernel rounds it): with asynchronous copies (cp.async) into two buffers
//   on the vector path, so that the next chunk's copies fly while this one
//   is used; each warp streams 4 values of each of its 4 rows per lane
//   (16-byte f32 loads, lane l at inputs 4l..4l+3 of the chunk, so the
//   shared reads are conflict-free), a chunk ahead of their use, and
//   multiplies them with every trial's 4 values:
//   4 rows x 32 trials of f32 sums in registers, 16 FMAs per 16-byte shared
//   load.  W is read once for the 32 trials; more trials take another group
//   of blocks.  (A first version staged with plain loads and loaded each
//   chunk's W when it was used, and ran slower than its plain PyTorch
//   version; PERF.md.)
// - A reduce-scatter of 31 shuffles leaves lane b with trial b's row sum,
//   and lane b runs the epilogue (the single-row kernel's, shared) for
//   (trial b, row).
// - The states may be rows of a wider buffer (a row stride per operand; 0
//   for an operand shared by every trial), so the node's (B, 3N) state is
//   read in place; the output is (B, 3, N).

// Interface: plain C functions, loaded with ctypes; they launch on the
// caller's stream, never synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "row_dot.cuh"
#include "rows_mma.cuh"
#include "rows_tiled.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct StepParams {
  float dt, inv_dt, inv_tau, inv_tau_s, inv_tau_x, k, alpha, thresh, v_reset;
};

// The QIF+SFA update of one neuron from its coupling input s_in.
__device__ __forceinline__ void qif_sfa_update(float s_in, float vi, float si, float xi,
                                               float eta, float inp, const StepParams& p,
                                               float* v_out, float* s_out, float* x_out) {
  const float reset = (vi - p.thresh >= 0.f) ? 1.f : 0.f;
  const float spikes = reset * p.inv_dt;
  const float dv = (vi * vi + (eta - xi) + inp) * p.inv_tau + p.k * s_in;
  const float ds = -si * p.inv_tau_s + spikes;
  const float dx = -xi * p.inv_tau_x + p.alpha * spikes;
  *v_out = (vi + p.dt * dv) * (1.f - reset) + reset * p.v_reset;
  *s_out = si + p.dt * ds;
  *x_out = xi + p.dt * dx;
}

template <typename WT, bool kVec>
__global__ void __launch_bounds__(kThreads)
qif_sfa_step_kernel(const WT* __restrict__ W, const float* __restrict__ v,
                    const float* __restrict__ s, const float* __restrict__ x,
                    const float* __restrict__ eta, const float* __restrict__ inp,
                    float* __restrict__ v_out, float* __restrict__ s_out,
                    float* __restrict__ x_out, int n, StepParams p) {
  __shared__ float warp_sums[kWarps];
  const int i = blockIdx.x;
  float acc = rowdot::partial_dot<WT, kVec, kThreads>(W + static_cast<size_t>(i) * n, s, n);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x != 0) return;

  float s_in = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_in += warp_sums[w];
  qif_sfa_update(s_in, v[i], s[i], x[i], eta[i], inp[i], p, v_out + i, s_out + i, x_out + i);
}

// ------------------------------------------------------------- B rows
constexpr int kRWarps = 4;
constexpr int kRThreads = 32 * kRWarps;
constexpr int kRRowsPerWarp = 4;
constexpr int kRRows = kRWarps * kRRowsPerWarp;  // rows of W per block
constexpr int kRTrials = 32;                     // trials per block
constexpr int kRChunk = 128;                     // inputs staged per trial and pass

// cp.async copies, the scalar weight load and the reduce-scatter of the B-row
// kernels (row_dot.cuh, which the generic fused step's B-row kernel shares).
using rowdot::copy16;
using rowdot::copy_commit;
using rowdot::copy_wait;
using rowdot::load1;
using rowdot::reduce_scatter;
static_assert(rowdot::kWarpTrials == kRTrials, "one trial per lane");

// Four consecutive f32 weights of a row (16 bytes; streaming hint).
__device__ __forceinline__ float4 raw4(const float* __restrict__ w) {
  return __ldcs(reinterpret_cast<const float4*>(w));
}

template <typename WT, bool kVec>
__global__ void __launch_bounds__(kRThreads)
qif_sfa_rows_kernel(const WT* __restrict__ W, const float* __restrict__ v,
                    const float* __restrict__ s, const float* __restrict__ x,
                    const float* __restrict__ eta, const float* __restrict__ inp, long long ld_v,
                    long long ld_s, long long ld_x, long long ld_eta, long long ld_inp,
                    float* __restrict__ out, int n, int n_rows, StepParams p) {
  constexpr bool kBf16 = std::is_same<WT, __nv_bfloat16>::value;
  static_assert(!(kVec && kBf16), "an aligned bf16 W takes qif_sfa_rows_mma_kernel");
  constexpr int kVecs = kRTrials * kRChunk / 4;  // float4s of a staged chunk
  __shared__ float4 ss[2][kVecs];  // 2 x 16 KB: the chunk of every trial, double-buffered
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * kRTrials;
  const int nb = min(kRTrials, n_rows - b0);
  const int row0 = blockIdx.x * kRRows + warp * kRRowsPerWarp;
  const int chunks = (n + kRChunk - 1) / kRChunk;
  float acc[kRRowsPerWarp][kRTrials];
#pragma unroll
  for (int r = 0; r < kRRowsPerWarp; ++r)
#pragma unroll
    for (int b = 0; b < kRTrials; ++b) acc[r][b] = 0.f;

  // chunk c of every trial's s into buffer c & 1: asynchronous 16-byte copies
  // on the vector path (zeros past the data), plain loads otherwise
  auto stage = [&](int c) {
    const int k0 = c * kRChunk;
    if constexpr (kVec) {
#pragma unroll
      for (int j = 0; j < kVecs / kRThreads; ++j) {
        const int idx = threadIdx.x + j * kRThreads;
        const int b = idx / (kRChunk / 4);
        const int k = k0 + 4 * (idx % (kRChunk / 4));
        const bool ok = b < nb && k < n;
        copy16(&ss[c & 1][idx], ok ? s + (b0 + b) * ld_s + k : s, ok ? 16 : 0);
      }
    } else {
      float* sf = reinterpret_cast<float*>(ss[c & 1]);
      for (int idx = threadIdx.x; idx < kRTrials * kRChunk; idx += kRThreads) {
        const int b = idx / kRChunk;
        const int k = k0 + idx % kRChunk;
        const float val = (b < nb && k < n) ? __ldg(s + (b0 + b) * ld_s + k) : 0.f;
        sf[idx] = kBf16 ? rowdot::bf16_round(val) : val;
      }
    }
    copy_commit();
  };

  stage(0);
  float4 wraw[kRRowsPerWarp];  // the next chunk's weights
  if constexpr (kVec) {
#pragma unroll
    for (int r = 0; r < kRRowsPerWarp; ++r)
      wraw[r] = (row0 + r < n && 4 * lane < n)
                    ? raw4(W + static_cast<size_t>(row0 + r) * n + 4 * lane)
                    : float4{};
  }
  for (int c = 0; c < chunks; ++c) {
    const int k0 = c * kRChunk;
    float4 w[kRRowsPerWarp];
    if constexpr (kVec) {
      // this chunk's 4 weights of each row per lane, loaded during the
      // previous chunk; then the next chunk's, which fly while this one is
      // used (without that the loads' latency set the kernel's pace)
#pragma unroll
      for (int r = 0; r < kRRowsPerWarp; ++r) w[r] = wraw[r];
      const int k = k0 + kRChunk + 4 * lane;
#pragma unroll
      for (int r = 0; r < kRRowsPerWarp; ++r)
        wraw[r] = (row0 + r < n && k < n) ? raw4(W + static_cast<size_t>(row0 + r) * n + k)
                                          : float4{};
    }
    if (c + 1 < chunks) {  // the next chunk's copies fly while this one is used
      stage(c + 1);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();  // chunk c is in shared memory for every thread
    if constexpr (kVec) {
#pragma unroll
      for (int b = 0; b < kRTrials; ++b) {
        const float4 sv = ss[c & 1][b * (kRChunk / 4) + lane];
#pragma unroll
        for (int r = 0; r < kRRowsPerWarp; ++r) {
          acc[r][b] = fmaf(w[r].x, sv.x, acc[r][b]);
          acc[r][b] = fmaf(w[r].y, sv.y, acc[r][b]);
          acc[r][b] = fmaf(w[r].z, sv.z, acc[r][b]);
          acc[r][b] = fmaf(w[r].w, sv.w, acc[r][b]);
        }
      }
    } else {
      const float* sf = reinterpret_cast<const float*>(ss[c & 1]);
#pragma unroll 1
      for (int q = 0; q < kRChunk / 32; ++q) {
        const int kk = 32 * q + lane;
        const int k = k0 + kk;
        float w1[kRRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRRowsPerWarp; ++r)
          w1[r] = (row0 + r < n && k < n) ? load1<WT>(W + static_cast<size_t>(row0 + r) * n + k)
                                          : 0.f;
#pragma unroll
        for (int b = 0; b < kRTrials; ++b) {
          const float sv = sf[b * kRChunk + kk];
#pragma unroll
          for (int r = 0; r < kRRowsPerWarp; ++r) acc[r][b] = fmaf(w1[r], sv, acc[r][b]);
        }
      }
    }
    __syncthreads();  // buffer c & 1 is free for chunk c + 2
  }
#pragma unroll
  for (int r = 0; r < kRRowsPerWarp; ++r) {
    const float s_in = reduce_scatter(acc[r], lane);
    const int i = row0 + r;
    if (i < n && lane < nb) {
      const long long b = b0 + lane;
      float* o = out + b * 3 * n;
      qif_sfa_update(s_in, v[b * ld_v + i], s[b * ld_s + i], x[b * ld_x + i],
                     eta[b * ld_eta + i], inp[b * ld_inp + i], p, o + i, o + n + i,
                     o + 2 * n + i);
    }
  }
}

// ------------------------------------------- B rows, bf16 W, tensor cores
// The block geometry, mma_bf16 and bf16x2 (rows_mma.cuh, which the generic
// fused step's tensor-core B-row kernel shares).
using rowmma::bf16x2;
using rowmma::kMBf16Bytes;
using rowmma::kMChunk;
using rowmma::kMKSplit;
using rowmma::kMQuads;
using rowmma::kMRows;
using rowmma::kMRowTiles;
using rowmma::kMSlabs;
using rowmma::kMSmem;
using rowmma::kMStage;
using rowmma::kMStride;
using rowmma::kMThreads;
using rowmma::mma_bf16;
static_assert(rowmma::kRTrials == kRTrials, "one trial per lane");
static_assert(rowmma::kMSumBytes <= kMBf16Bytes,
              "the K parts' partial sums must fit the staging buffers");

// Probes of what holds the kernel back (chip_smoke.py times them beside it):
// kProbe bit 1 skips the staging of s, bit 2 replaces the products with XORs
// (the fragments are still read), bit 4 skips the barrier between chunks.
// Their outputs are meaningless; qif_sfa_rows_launch runs kProbe = 0 alone.
constexpr int kProbeNoStaging = 1, kProbeNoMma = 2, kProbeNoBarrier = 4;

// The aligned bf16 B-row step (header note).  Warp w owns rows 16 (w %
// kMRowTiles) .. +16 of the block's and the part w / kMRowTiles of K in every
// chunk of kMChunk inputs.
template <int kProbe>
__global__ void __launch_bounds__(kMThreads, 1)
qif_sfa_rows_mma_kernel(const __nv_bfloat16* __restrict__ W, const float* __restrict__ v,
                        const float* __restrict__ s, const float* __restrict__ x,
                        const float* __restrict__ eta, const float* __restrict__ inp,
                        long long ld_v, long long ld_s, long long ld_x, long long ld_eta,
                        long long ld_inp, float* __restrict__ out, int n, int n_rows,
                        StepParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ss = smem;  // [2][kRTrials * kMStride] bf16
  float4* sf = reinterpret_cast<float4*>(smem + kMBf16Bytes);  // [kRTrials * kMQuads] f32
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // the fragments' group and thread in group
  const int tile = warp % kMRowTiles, part = warp / kMRowTiles;
  const int b0 = blockIdx.y * kRTrials;
  const int nb = min(kRTrials, n_rows - b0);
  const int row = blockIdx.x * kMRows + 16 * tile + g;  // and row + 8
  const int kw = part * 32 * kMSlabs + 8 * t;  // the lane's inputs in a chunk: kw + 32 j + [0, 8)
  const bool ok_lo = row < n, ok_hi = row + 8 < n;
  const __nv_bfloat16* w_lo = W + static_cast<size_t>(ok_lo ? row : 0) * n + kw;
  const __nv_bfloat16* w_hi = W + static_cast<size_t>(ok_hi ? row + 8 : 0) * n + kw;
  const int chunks = (n + kMChunk - 1) / kMChunk;

  uint4 ring[kMSlabs][2];  // W of rows (row, row + 8), a chunk ahead of its use
  auto load_w = [&](int c, int j) {
    const int k = c * kMChunk + 32 * j;
    const bool in = kw + k < n;  // n % 8 == 0: the lane's 8 inputs are all in or all out
    ring[j][0] = (ok_lo && in) ? __ldcs(reinterpret_cast<const uint4*>(w_lo + k)) : uint4{};
    ring[j][1] = (ok_hi && in) ? __ldcs(reinterpret_cast<const uint4*>(w_hi + k)) : uint4{};
  };
  auto fetch_s = [&](int c) {  // chunk c of the trials' s: cp.async, zeros past the data
#pragma unroll
    for (int q = 0; q < kMStage; ++q) {
      const int idx = threadIdx.x + q * kMThreads;
      const int b = idx / kMQuads;
      const int k = c * kMChunk + 4 * (idx % kMQuads);
      const bool ok = b < nb && k < n;
      if (idx < kRTrials * kMQuads)
        copy16(&sf[idx], ok ? s + (b0 + b) * ld_s + k : s, ok ? 16 : 0);
    }
    copy_commit();
  };
  auto store_s = [&](int buf) {  // this thread's own copies, rounded to bf16 on the way in
    copy_wait<0>();
#pragma unroll
    for (int q = 0; q < kMStage; ++q) {
      const int idx = threadIdx.x + q * kMThreads;
      if (idx < kRTrials * kMQuads) {
        const float4 f = sf[idx];
        *reinterpret_cast<uint2*>(&ss[buf * kRTrials * kMStride + (idx / kMQuads) * kMStride +
                                      8 * (idx % kMQuads)]) =
            make_uint2(bf16x2(f.x, f.y), bf16x2(f.z, f.w));
      }
    }
  };

  fetch_s(0);
#pragma unroll
  for (int j = 0; j < kMSlabs; ++j) load_w(0, j);
  store_s(0);
  __syncthreads();
  float acc[4][4];  // n-tile, fragment element: rows (row, row + 8) x trials 8 nt + 2 t + {0, 1}
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  // trial 8 nt + g's inputs kw + 32 j + [0, 8) of the chunk in buffer 0
  const unsigned char* s_lane = ss + g * kMStride + 2 * kw;
  for (int c = 0; c < chunks; ++c) {
    const bool more = c + 1 < chunks && !(kProbe & kProbeNoStaging);
    if (more) fetch_s(c + 1);  // flies while this chunk is used
    const unsigned char* sb = s_lane + (c & 1) * (kRTrials * kMStride);
#pragma unroll
    for (int j = 0; j < kMSlabs; ++j) {
      const uint4 lo = ring[j][0], hi = ring[j][1];
      load_w(c + 1, j);  // zeros (and no load) past the last chunk
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint4 bv = *reinterpret_cast<const uint4*>(sb + 8 * nt * kMStride + 64 * j);
        float d[4];
        if constexpr (kProbe & kProbeNoMma) {
          d[0] = __uint_as_float(lo.x ^ hi.x ^ bv.x);
          d[1] = __uint_as_float(lo.y ^ hi.y ^ bv.y);
          d[2] = __uint_as_float(lo.z ^ hi.z ^ bv.z);
          d[3] = __uint_as_float(lo.w ^ hi.w ^ bv.w);
        } else {
          // k-slab as two k16 fragments: words 0, 1 of each row's 16 bytes, then 2, 3
          mma_bf16(d, lo.x, hi.x, lo.y, hi.y, bv.x, bv.y, 0.f, 0.f, 0.f, 0.f);
          mma_bf16(d, lo.z, hi.z, lo.w, hi.w, bv.z, bv.w, d[0], d[1], d[2], d[3]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] += d[i];  // round-to-nearest f32 adds
      }
    }
    if (more) store_s((c + 1) & 1);
    if (!(kProbe & kProbeNoBarrier)) __syncthreads();  // chunk c used up, chunk c + 1 staged
  }
  // the K parts' sums meet; part q keeps the n-tiles nt % kMKSplit == q
  if constexpr (kProbe & kProbeNoBarrier) __syncthreads();
  float* red = reinterpret_cast<float*>(ss);  // [part][tile][nt][i][lane]
  auto at = [&](int q, int nt, int i) {
    return red + (((q * kMRowTiles + tile) * 4 + nt) * 4 + i) * 32 + lane;
  };
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    if (nt % kMKSplit != part)
#pragma unroll
      for (int i = 0; i < 4; ++i) *at(part, nt, i) = acc[nt][i];
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    if (nt % kMKSplit != part) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      for (int q = 0; q < kMKSplit; ++q)
        if (q != part) acc[nt][i] += *at(q, nt, i);
      const int tb = 8 * nt + 2 * t + (i & 1);
      const int r = row + 8 * (i >> 1);
      if (tb < nb && r < n) {
        const long long b = b0 + tb;
        float* o = out + b * 3 * n;
        qif_sfa_update(acc[nt][i], v[b * ld_v + r], s[b * ld_s + r], x[b * ld_x + r],
                       eta[b * ld_eta + r], inp[b * ld_inp + r], p, o + r, o + n + r,
                       o + 2 * n + r);
      }
    }
  }
}

// Dynamic shared memory above 48 KB is taken only when asked for, once per
// kernel and device.
template <typename K>
cudaError_t allow_smem(K* kernel, int bytes, std::atomic<unsigned long long>& asked) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (!(asked.load() >> dev & 1ull)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    asked.fetch_or(1ull << dev);
  }
  return cudaSuccess;
}

template <int kProbe>
cudaError_t launch_rows_mma(const void* W, const float* v, const float* s, const float* x,
                            const float* eta, const float* inp, long long ld_v, long long ld_s,
                            long long ld_x, long long ld_eta, long long ld_inp, float* out,
                            int n, int n_rows, const StepParams& p, cudaStream_t st) {
  auto* kernel = qif_sfa_rows_mma_kernel<kProbe>;
  static std::atomic<unsigned long long> asked{0};
  const cudaError_t e = allow_smem(kernel, kMSmem, asked);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + kMRows - 1) / kMRows, (n_rows + kRTrials - 1) / kRTrials);
  kernel<<<grid, kMThreads, kMSmem, st>>>(static_cast<const __nv_bfloat16*>(W), v, s, x, eta,
                                          inp, ld_v, ld_s, ld_x, ld_eta, ld_inp, out, n, n_rows,
                                          p);
  return cudaGetLastError();
}

// ------------------------------------------------- B rows, f32 W, tiled
// The geometry (rows_tiled.cuh): 10 rows x 8 trials a lane (a warp: 8 row
// groups x 4 trial groups, all 80 rows of the strip), 8 warps each on an
// eighth of every chunk, a ring of 3 chunks of 128 inputs (173 KB of shared
// memory).
using QifTile = rowtile::Geometry<10, 8, 1, 8, 128, 3>;
static_assert(rowtile::kTrials == kRTrials, "32 trials a block");

// The aligned f32 B-row step (header note): the block's sums, then each
// thread's (trial, row) pairs through the epilogue, consecutive threads on
// consecutive rows.
template <class G, int kProbe>
__global__ void __launch_bounds__(G::kThreads, 1)
qif_sfa_rows_tiled_kernel(const float* __restrict__ W, const float* __restrict__ v,
                          const float* __restrict__ s, const float* __restrict__ x,
                          const float* __restrict__ eta, const float* __restrict__ inp,
                          long long ld_v, long long ld_s, long long ld_x, long long ld_eta,
                          long long ld_inp, float* __restrict__ out, int n, int n_rows,
                          StepParams p) {
  extern __shared__ __align__(16) unsigned char tsmem[];
  float* sums = reinterpret_cast<float*>(tsmem);
  const int b0 = blockIdx.y * kRTrials;
  const int nb = min(kRTrials, n_rows - b0);
  const int row0 = blockIdx.x * G::kRows;
  rowtile::block_sums<G, kProbe>(W, s, ld_s, n, nb, b0, row0, sums);
  __syncthreads();
  for (int e = threadIdx.x; e < kRTrials * G::kRows; e += G::kThreads) {
    const int t = e / G::kRows, r = e % G::kRows, i = row0 + r;
    if (t < nb && i < n) {
      const long long b = b0 + t;
      float* o = out + b * 3 * n;
      qif_sfa_update(rowtile::part_sum<G>(sums, t, r), v[b * ld_v + i], s[b * ld_s + i],
                     x[b * ld_x + i], eta[b * ld_eta + i], inp[b * ld_inp + i], p, o + i,
                     o + n + i, o + 2 * n + i);
    }
  }
}

template <class G, int kProbe>
cudaError_t launch_rows_tiled(const void* W, const float* v, const float* s, const float* x,
                              const float* eta, const float* inp, long long ld_v,
                              long long ld_s, long long ld_x, long long ld_eta, long long ld_inp,
                              float* out, int n, int n_rows, const StepParams& p,
                              cudaStream_t st) {
  auto* kernel = qif_sfa_rows_tiled_kernel<G, kProbe>;
  static std::atomic<unsigned long long> asked{0};
  const cudaError_t e = allow_smem(kernel, G::kSmem, asked);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + G::kRows - 1) / G::kRows, (n_rows + kRTrials - 1) / kRTrials);
  kernel<<<grid, G::kThreads, G::kSmem, st>>>(static_cast<const float*>(W), v, s, x, eta, inp,
                                              ld_v, ld_s, ld_x, ld_eta, ld_inp, out, n, n_rows,
                                              p);
  return cudaGetLastError();
}

template <typename WT, bool kVec>
void launch(const void* W, const void* v, const void* s, const void* x, const void* eta,
            const void* inp, void* v_out, void* s_out, void* x_out, int n,
            const StepParams& p, cudaStream_t stream) {
  qif_sfa_step_kernel<WT, kVec><<<n, kThreads, 0, stream>>>(
      static_cast<const WT*>(W), static_cast<const float*>(v), static_cast<const float*>(s),
      static_cast<const float*>(x), static_cast<const float*>(eta),
      static_cast<const float*>(inp), static_cast<float*>(v_out), static_cast<float*>(s_out),
      static_cast<float*>(x_out), n, p);
}

}  // namespace

// W: (n, n) row-major, f32 (w_bf16 = 0) or bf16 (w_bf16 = 1).  v, s, x, eta,
// inp: (n,) f32.  v_out, s_out, x_out: (n,) f32, distinct from the inputs.
// vec = 1 selects the 16-byte-vector loop; the caller sets it only when n is
// a multiple of the vector width (4 f32, 8 bf16) and W and s are 16-byte
// aligned.
extern "C" int qif_sfa_step_launch(const void* W, int w_bf16, int vec, const void* v,
                                   const void* s, const void* x, const void* eta,
                                   const void* inp, void* v_out, void* s_out, void* x_out,
                                   int n, float dt, float inv_dt, float inv_tau,
                                   float inv_tau_s, float inv_tau_x, float k, float alpha,
                                   float thresh, float v_reset, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const StepParams p{dt, inv_dt, inv_tau, inv_tau_s, inv_tau_x, k, alpha, thresh, v_reset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bf16) {
    if (vec) launch<__nv_bfloat16, true>(W, v, s, x, eta, inp, v_out, s_out, x_out, n, p, st);
    else launch<__nv_bfloat16, false>(W, v, s, x, eta, inp, v_out, s_out, x_out, n, p, st);
  } else {
    if (vec) launch<float, true>(W, v, s, x, eta, inp, v_out, s_out, x_out, n, p, st);
    else launch<float, false>(W, v, s, x, eta, inp, v_out, s_out, x_out, n, p, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The B-row step.  W: (n, n) row-major, f32 (w_bf16 = 0) or bf16 (w_bf16 =
// 1).  v, s, x, eta, inp: f32, row b of each at b * ld_<name> (ld 0: one row
// shared by every trial), n contiguous values each.  out: (n_rows, 3, n) f32
// (v', s', x' of each trial), distinct from the inputs.  route: 0 scalar
// loads (any W); 1 the vector loads of W and asynchronous copies of s on the
// CUDA cores (f32, the yardstick of route 3); 2 the tensor cores (bf16); 3 the tiled
// CUDA-core kernel (f32).  Routes 1-3 need n a multiple of the vector width
// (4 f32, 8 bf16), ld_s a multiple of 4 and W and s 16-byte aligned; any
// other pairing of route and type is refused (cudaErrorInvalidValue).
extern "C" int qif_sfa_rows_launch(const void* W, int w_bf16, int route, const void* v,
                                   const void* s, const void* x, const void* eta,
                                   const void* inp, long long ld_v, long long ld_s,
                                   long long ld_x, long long ld_eta, long long ld_inp, void* out,
                                   int n, int n_rows, float dt, float inv_dt, float inv_tau,
                                   float inv_tau_s, float inv_tau_x, float k, float alpha,
                                   float thresh, float v_reset, void* stream) {
  if (n <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  const StepParams p{dt, inv_dt, inv_tau, inv_tau_s, inv_tau_x, k, alpha, thresh, v_reset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kRRows - 1) / kRRows, (n_rows + kRTrials - 1) / kRTrials);
  const auto* pv = static_cast<const float*>(v);
  const auto* ps = static_cast<const float*>(s);
  const auto* px = static_cast<const float*>(x);
  const auto* pe = static_cast<const float*>(eta);
  const auto* pi = static_cast<const float*>(inp);
  auto* po = static_cast<float*>(out);
#define QIF_ROWS(WT, VEC)                                                                     \
  qif_sfa_rows_kernel<WT, VEC><<<grid, kRThreads, 0, st>>>(                                   \
      static_cast<const WT*>(W), pv, ps, px, pe, pi, ld_v, ld_s, ld_x, ld_eta, ld_inp, po, n, \
      n_rows, p)
  switch (route | (w_bf16 ? 4 : 0)) {
    case 0: QIF_ROWS(float, false); break;
    case 1: QIF_ROWS(float, true); break;
    case 3:
      return static_cast<int>(launch_rows_tiled<QifTile, 0>(
          W, pv, ps, px, pe, pi, ld_v, ld_s, ld_x, ld_eta, ld_inp, po, n, n_rows, p, st));
    case 4: QIF_ROWS(__nv_bfloat16, false); break;
    case 6:
      return static_cast<int>(launch_rows_mma<0>(W, pv, ps, px, pe, pi, ld_v, ld_s, ld_x, ld_eta,
                                                 ld_inp, po, n, n_rows, p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef QIF_ROWS
  return static_cast<int>(cudaGetLastError());
}

// The probes of the tensor-core B-row kernel (kProbe above), for timing:
// probe 3 streams W and reads the fragments, with the barrier between chunks;
// probe 7 the same without the barrier.  Same operands as
// qif_sfa_rows_launch with a bf16 W; the output is meaningless.
extern "C" int qif_sfa_rows_probe_launch(int probe, const void* W, const void* v, const void* s,
                                         const void* x, const void* eta, const void* inp,
                                         long long ld_v, long long ld_s, long long ld_x,
                                         long long ld_eta, long long ld_inp, void* out, int n,
                                         int n_rows, void* stream) {
  if (n <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  const StepParams p{};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* pv = static_cast<const float*>(v);
  const auto* ps = static_cast<const float*>(s);
  const auto* px = static_cast<const float*>(x);
  const auto* pe = static_cast<const float*>(eta);
  const auto* pi = static_cast<const float*>(inp);
  auto* po = static_cast<float*>(out);
  constexpr int kFragmentsBarrier = kProbeNoStaging | kProbeNoMma;
  constexpr int kFragments = kFragmentsBarrier | kProbeNoBarrier;
  if (probe == kFragmentsBarrier)
    return static_cast<int>(launch_rows_mma<kFragmentsBarrier>(
        W, pv, ps, px, pe, pi, ld_v, ld_s, ld_x, ld_eta, ld_inp, po, n, n_rows, p, st));
  if (probe == kFragments)
    return static_cast<int>(launch_rows_mma<kFragments>(W, pv, ps, px, pe, pi, ld_v, ld_s, ld_x,
                                                        ld_eta, ld_inp, po, n, n_rows, p, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The probes of the tiled f32 B-row kernel (rowtile::kProbe*), for timing:
// probe 1 streams W and s through the ring and reads the micro-tiles'
// operands without the FMAs; probe 2 skips the copies of s; probe 4 streams
// W and s through the ring and reads nothing (no FMAs).  Same operands
// as qif_sfa_rows_launch with a f32 W on route 3; the output is meaningless.
extern "C" int qif_sfa_rows_tiled_probe_launch(int probe, const void* W, const void* v,
                                               const void* s, const void* x, const void* eta,
                                               const void* inp, long long ld_v, long long ld_s,
                                               long long ld_x, long long ld_eta,
                                               long long ld_inp, void* out, int n, int n_rows,
                                               void* stream) {
  if (n <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  const StepParams p{};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* pv = static_cast<const float*>(v);
  const auto* ps = static_cast<const float*>(s);
  const auto* px = static_cast<const float*>(x);
  const auto* pe = static_cast<const float*>(eta);
  const auto* pi = static_cast<const float*>(inp);
  auto* po = static_cast<float*>(out);
  if (probe == rowtile::kProbeNoFma)
    return static_cast<int>(launch_rows_tiled<QifTile, rowtile::kProbeNoFma>(
        W, pv, ps, px, pe, pi, ld_v, ld_s, ld_x, ld_eta, ld_inp, po, n, n_rows, p, st));
  if (probe == rowtile::kProbeNoStaging)
    return static_cast<int>(launch_rows_tiled<QifTile, rowtile::kProbeNoStaging>(
        W, pv, ps, px, pe, pi, ld_v, ld_s, ld_x, ld_eta, ld_inp, po, n, n_rows, p, st));
  if (probe == rowtile::kProbeNoReads)
    return static_cast<int>(launch_rows_tiled<QifTile, rowtile::kProbeNoReads>(
        W, pv, ps, px, pe, pi, ld_v, ld_s, ld_x, ld_eta, ld_inp, po, n, n_rows, p, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
