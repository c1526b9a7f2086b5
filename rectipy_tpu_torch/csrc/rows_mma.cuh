// The tensor-core pieces of the B-row steps on a bf16 W, for NVIDIA Hopper
// (sm_90a): qif_sfa_rows_mma_kernel (qif_sfa_step.cu) and
// generic_fused_rows_mma_kernel (generic_fused_step.cuh) share them, as
// both share row_dot.cuh.
//
// The block geometry (qif_sfa_step.cu's header note says why): a block owns
// kMRows = 80 rows of W and 32 trials, 125 blocks at N = 10,000, one an SM.
// Its ten warps are 5 row tiles x 2 parts of K: each chunk of kMChunk = 384
// inputs is split 192 / 192, 6 k-slabs of 32 a warp.  Each trial's chunk is
// staged as f32 (cp.async) and rounded to bf16 into one of two buffers, each
// trial row padded to 64 mod 128 bytes (kMStride) so that the 16-byte
// fragment reads of a quarter-warp hit 32 distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "row_dot.cuh"

namespace rowmma {

constexpr int kRTrials = rowdot::kWarpTrials;   // trials per block, 32
constexpr int kMRowTiles = 5;                   // warps along the rows, 16 rows of W each
constexpr int kMKSplit = 2;                     // warps along K: each sums its part of a chunk
constexpr int kMSlabs = 6;                      // 32-wide k-slabs per warp and chunk
constexpr int kMThreads = 32 * kMRowTiles * kMKSplit;
constexpr int kMRows = 16 * kMRowTiles;         // rows of W per block: 125 blocks at N = 10,000
constexpr int kMChunk = 32 * kMSlabs * kMKSplit;  // inputs of each trial per chunk
constexpr int kMStride = 2 * kMChunk + 64;      // bytes per staged trial row; = 64 mod 128
constexpr int kMQuads = kMChunk / 4;            // float4s of a trial per chunk
constexpr int kMStage = (kRTrials * kMQuads + kMThreads - 1) / kMThreads;  // float4s a thread stages
constexpr int kMBf16Bytes = 2 * kRTrials * kMStride;             // two rounded chunks
constexpr int kMSmem = kMBf16Bytes + kRTrials * kMChunk * 4;      // and one f32 chunk
// bytes of one coupling's partial sums where the K parts meet: [part][tile]
// [n-tile][fragment element][lane] f32
constexpr int kMSumBytes = kMKSplit * kMRowTiles * 4 * 4 * 32 * 4;

// d = a * b + c on the tensor cores: a 16 x 16 bf16 tile of W (row-major
// fragment), a 16 x 8 bf16 tile of the sources (column fragment), f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1, float c0,
                                         float c1, float c2, float c3) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(c0), "f"(c1), "f"(c2),
        "f"(c3));
}

// Two floats rounded to bf16 (RNE), lo in the low half: memory order.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return reinterpret_cast<uint32_t&>(h);
}

}  // namespace rowmma
