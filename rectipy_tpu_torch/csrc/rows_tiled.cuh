// The CUDA-core sums of a B-row step on a f32 W, for NVIDIA Hopper (sm_90a):
// s_in[b, i] = sum_j W[i, j] * s[b, j] for a block's strip of rows of W and
// its group of up to 32 trials, with f32 products and f32 sums (fmaf), as
// the plain version computes them; only the order of the sum differs.
// qif_sfa_rows_tiled_kernel (qif_sfa_step.cu) runs it; the pieces do not
// depend on the QIF epilogue, so the generic fused step's B-row kernel can
// share them, as both share rows_mma.cuh on a bf16 W.
//
// Bound.  W is read once per group of 32 trials: 400 MB at N = 10,000, 0.1195
// ms at 3.35 TB/s; its 3.2e9 FMAs take 0.096 ms at the f32 peak (67 TFLOP/s),
// 80% of the bytes' time.  So the step must stream W near the HBM rate and
// keep the FMA pipe about 80% busy at once.  (Derived figures.)
//
// Design (Geometry below; qif_sfa_step.cu's QifTile picks the numbers):
// - A block owns kRows rows of W (a strip; 80: 125 blocks at N = 10,000, one
//   wave of one block an SM) and 32 trials, so s crosses L2 once per strip
//   (125 x 1.28 MB = 160 MB a step; 16-row strips read 800 MB).
// - W and s reach shared memory by a ring of kStages chunks of kChunk inputs
//   (cp.async, 16 bytes a copy; zeros, and no read, past row n or column n),
//   kStages - 1 chunks in flight while one is used: 10 MB of W across the
//   card at QifTile's 3 x 128, where Little's law at 3.35 TB/s wants 3-4 MB
//   for a microsecond of HBM latency.  One barrier a chunk.  A staged row
//   (kRows of W, then 32 of s, each kChunk floats) is padded to 4 mod 32
//   floats, so that the 16-byte reads of up to 8 consecutive rows at one k
//   fall in 8 distinct groups of 4 banks.
// - A lane owns a micro-tile of kR rows x kT trials and sums 4 consecutive
//   inputs at a time: kR + kT 16-byte shared loads feed 4 kR kT FMAs.  A warp
//   is kRG row groups x kTG trial groups (lane = tg + kTG rg; rows rg + kRG i,
//   trials tg + kTG j), so that one load serves the lanes of a row group (W)
//   or of a trial group (s).  Shared memory delivers 32 floats a clock to the
//   lanes, broadcast or not, against 128 FMAs: kR kT / (kR + kT) must be
//   near 4 or above, or the loads and not the FMAs set the pace.  QifTile's
//   10 x 8 a lane (80 sums) gives 4.4; the 4 x 4 of a first version gave 2.
// - The block's warps are kRowTiles row tiles x kKSplit parts of each chunk;
//   the parts' sums meet in shared memory after the last chunk, summed in
//   the order of the parts, and each thread takes (trial, row) pairs with
//   consecutive threads on consecutive rows for the epilogue.
// - A lane's sum runs over its part of every chunk in order of the inputs,
//   one fmaf each; the parts add up in order.  Rows >= n and trials >= the
//   group's count sum zeros and are masked by the caller.
// - What was tried and left (PERF.md): 4 x 4 and 5 x 8 lane tiles,
//   chunks of 32 and 64 inputs with deeper rings, a ring of 2, bulk copies
//   (cp.async.bulk, one a staged row, on mbarriers), L2 prefetches of W
//   ahead of the ring (by lines or by bulk prefetch), each block starting at
//   its own chunk, and the order of the FMAs in a micro-tile.  What holds it
//   back (the probes below, timed by chip_smoke.py): the ring's W stream
//   alone takes most of the kernel's time.
// Needs n % 4 == 0, W and s 16-byte aligned and ld_s % 4 == 0 (so every
// 16-byte copy lies inside a row); anything else takes the scalar route.

#pragma once

#include <stdint.h>

#include "row_dot.cuh"

namespace rowtile {

constexpr int kTrials = 32;  // trials per block

template <int R, int T, int RowTiles, int KSplit, int Chunk, int Stages>
struct Geometry {
  static constexpr int kR = R, kT = T, kRowTiles = RowTiles, kKSplit = KSplit;
  static constexpr int kChunk = Chunk, kStages = Stages;
  static constexpr int kTG = kTrials / kT;  // trial groups of a warp (lanes along the trials)
  static constexpr int kRG = 32 / kTG;      // row groups of a warp
  static constexpr int kWarpRows = kRG * kR;
  static constexpr int kRows = kWarpRows * kRowTiles;  // rows of W per block
  static constexpr int kWarps = kRowTiles * kKSplit;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kPart = kChunk / kKSplit;  // inputs of a chunk per K part
  static constexpr int kPitch = kChunk + 4;       // floats per staged row; = 4 mod 32
  static constexpr int kQuads = kChunk / 4;       // 16-byte copies per staged row
  static constexpr int kStageRows = kRows + kTrials;
  static constexpr int kStageFloats = kStageRows * kPitch;
  static constexpr int kCopies = (kStageRows * kQuads + kThreads - 1) / kThreads;  // a thread's
  // the parts' sums: [part][trial][row], each trial's row padded to kRG mod
  // 32 floats, so that a warp's stores (row groups x trial groups) and the
  // epilogue's loads (consecutive rows) hit distinct banks
  static constexpr int kSumPitch = kRows + ((kRG - kRows) % 32 + 32) % 32;
  static constexpr int kSumFloats = kKSplit * kTrials * kSumPitch;
  static constexpr int kSmem =
      4 * (kStages * kStageFloats > kSumFloats ? kStages * kStageFloats : kSumFloats);
  static_assert(kT * kTG == kTrials && kRG * kTG == 32, "a warp covers the 32 trials");
  static_assert(kPart % 4 == 0 && kChunk % 32 == 0, "whole 16-byte reads; pitch 4 mod 32");
  static_assert(kThreads % kQuads == 0, "a thread copies at one input of every chunk");
  static_assert(kRG <= 8 && kTG <= 8, "at most 8 rows of one read share the banks");
  static_assert(kStages >= 2, "a ring");
};

// Probes of what holds the sums back (chip_smoke.py times them beside the
// kernel): kProbeNoFma folds the loaded operands by XORs into one register
// instead of the FMAs (the shared loads stay), kProbeNoStaging skips the
// copies of s, kProbeNoReads skips the loads and the FMAs (the ring's stream
// alone).  Their sums are meaningless.
constexpr int kProbeNoFma = 1, kProbeNoStaging = 2, kProbeNoReads = 4;

// The block's sums of rows row0 .. row0 + kRows and trials b0 .. b0 + nb
// (nb <= 32; s row b at s + b * ld_s) into smem, [part][trial][row] (pitch
// kSumPitch); the caller adds the parts (part_sum) after a barrier.  smem:
// G::kSmem bytes, 16-byte aligned.  Every thread of the block calls it.
template <class G, int kProbe = 0>
__device__ __forceinline__ void block_sums(const float* __restrict__ W,
                                           const float* __restrict__ s, long long ld_s, int n,
                                           int nb, int b0, int row0, float* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = warp % G::kRowTiles, part = warp / G::kRowTiles;
  const int tg = lane % G::kTG, rg = lane / G::kTG;
  const int chunks = (n + G::kChunk - 1) / G::kChunk;

  // This thread's copies: staged rows tid / kQuads + q (kThreads / kQuads)
  // at inputs 4 (tid % kQuads) of every chunk; rows < kRows are W's, the
  // rest s's.  nullptr where the row does not exist (zeros).
  const int kq = 4 * (tid % G::kQuads);
  const float* src[G::kCopies];
#pragma unroll
  for (int q = 0; q < G::kCopies; ++q) {
    const int r = tid / G::kQuads + q * (G::kThreads / G::kQuads);
    src[q] = nullptr;
    if (r < G::kRows) {
      if (row0 + r < n) src[q] = W + static_cast<size_t>(row0 + r) * n + kq;
    } else if (r < G::kStageRows && r - G::kRows < nb) {
      src[q] = s + (b0 + r - G::kRows) * ld_s + kq;
    }
  }
  auto fetch = [&](int c) {  // chunk c into slot c % kStages; past the last, an empty group
    if (c < chunks) {
      float* st = smem + (c % G::kStages) * G::kStageFloats + kq;
      const int k0 = c * G::kChunk;
      const bool in = k0 + kq < n;  // n % 4 == 0: the 4 inputs are all in or all out
#pragma unroll
      for (int q = 0; q < G::kCopies; ++q) {
        const int r = tid / G::kQuads + q * (G::kThreads / G::kQuads);
        if (r < G::kStageRows && !((kProbe & kProbeNoStaging) && r >= G::kRows)) {
          const bool ok = in && src[q] != nullptr;
          rowdot::copy16(st + r * G::kPitch, ok ? src[q] + k0 : W, ok ? 16 : 0);
        }
      }
    }
    rowdot::copy_commit();
  };

#pragma unroll
  for (int c = 0; c < G::kStages - 1; ++c) fetch(c);
  float acc[G::kR][G::kT];
#pragma unroll
  for (int i = 0; i < G::kR; ++i)
#pragma unroll
    for (int j = 0; j < G::kT; ++j) acc[i][j] = 0.f;
  // the lane's first W row and first s row in a slot, at its part's inputs
  const int w_off = (tile * G::kWarpRows + rg) * G::kPitch + part * G::kPart;
  const int s_off = (G::kRows + tg) * G::kPitch + part * G::kPart;
  for (int c = 0; c < chunks; ++c) {
    rowdot::copy_wait<G::kStages - 2>();
    __syncthreads();  // chunk c is staged, and every thread is done with chunk c - 1
    fetch(c + G::kStages - 1);  // into chunk c - 1's slot
    const float* st = smem + (c % G::kStages) * G::kStageFloats;
    if constexpr (kProbe & kProbeNoReads) continue;
    const float* wp = st + w_off;
    const float* sp = st + s_off;
#pragma unroll
    for (int k = 0; k < G::kPart; k += 4) {
      float4 b[G::kT];  // the lane's trials at inputs k .. k + 3, then row by row
#pragma unroll
      for (int j = 0; j < G::kT; ++j)
        b[j] = *reinterpret_cast<const float4*>(sp + j * G::kTG * G::kPitch + k);
#pragma unroll
      for (int i = 0; i < G::kR; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(wp + i * G::kRG * G::kPitch + k);
        if constexpr (kProbe & kProbeNoFma) {
          uint32_t h = __float_as_uint(a.x) ^ __float_as_uint(a.y) ^ __float_as_uint(a.z) ^
                       __float_as_uint(a.w);
          if (i == 0) {
#pragma unroll
            for (int j = 0; j < G::kT; ++j)
              h ^= __float_as_uint(b[j].x) ^ __float_as_uint(b[j].y) ^ __float_as_uint(b[j].z) ^
                   __float_as_uint(b[j].w);
          }
          acc[i][0] = __uint_as_float(__float_as_uint(acc[i][0]) ^ h);
        } else {  // each sum takes inputs k, k + 1, k + 2, k + 3 in turn
#pragma unroll
          for (int j = 0; j < G::kT; ++j) acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
#pragma unroll
          for (int j = 0; j < G::kT; ++j) acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
#pragma unroll
          for (int j = 0; j < G::kT; ++j) acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
#pragma unroll
          for (int j = 0; j < G::kT; ++j) acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
        }
      }
    }
  }
  rowdot::copy_wait<0>();  // only empty groups are left; the ring becomes the sums
  __syncthreads();
#pragma unroll
  for (int i = 0; i < G::kR; ++i)
#pragma unroll
    for (int j = 0; j < G::kT; ++j)
      smem[(part * kTrials + tg + G::kTG * j) * G::kSumPitch + tile * G::kWarpRows + rg +
           G::kRG * i] = acc[i][j];
}

// The block's sum of trial t (of its group), row r (of its strip), after
// block_sums and a barrier: the K parts added in order.
template <class G>
__device__ __forceinline__ float part_sum(const float* smem, int t, int r) {
  float v = smem[t * G::kSumPitch + r];
#pragma unroll
  for (int q = 1; q < G::kKSplit; ++q) v += smem[(q * kTrials + t) * G::kSumPitch + r];
  return v;
}

}  // namespace rowtile
