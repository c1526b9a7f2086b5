// One block's share of a dense row product, sum_j w[j] * s[j], shared by the
// fused step kernels (qif_sfa_step.cu, generic_fused_step.cuh).
//
// W is streamed once per step (it is used once and is far larger than L2),
// so it is loaded with the streaming hint in 16-byte vectors (4 f32 or 8 bf16
// values), neighbouring threads on neighbouring addresses; s is shared by
// every row and is read through the read-only cache.  A bf16 W takes s
// rounded to bf16, as the TPU kernels do, and every product is summed in f32.
// The unrolled loops keep several loads in flight per thread.  The scalar
// loops take n not a multiple of the vector width and pointers that are not
// 16-byte aligned.
//
// Below partial_dot: what the B-row kernels share (qif_sfa_rows_kernel and
// generic_fused_rows_kernel), a warp per few rows of W with one trial per
// lane: cp.async copies of the trials' source chunks into shared memory, a
// scalar weight load, and the reduce-scatter that leaves each lane its
// trial's row sum.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace rowdot {

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bf16 -> f32 is a 16-bit shift; a 32-bit word holds element 2c in its low
// half and element 2c + 1 in its high half (little endian).
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// This thread's share (threads of a kThreads-wide block) of sum_j w[j] * s[j]
// over one row of length n.  kVec needs n a multiple of the vector width and
// w and s 16-byte aligned.
template <typename WT, bool kVec, int kThreads>
__device__ __forceinline__ float partial_dot(const WT* __restrict__ w,
                                             const float* __restrict__ s, int n) {
  constexpr bool kBf16 = std::is_same<WT, __nv_bfloat16>::value;
  float acc = 0.f;
  if constexpr (kVec && !kBf16) {
    const float4* w4 = reinterpret_cast<const float4*>(w);
    const float4* s4 = reinterpret_cast<const float4*>(s);
    const int nv = n / 4;
#pragma unroll 4
    for (int c = threadIdx.x; c < nv; c += kThreads) {
      const float4 a = __ldcs(w4 + c);
      const float4 b = __ldg(s4 + c);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  } else if constexpr (kVec && kBf16) {
    const uint4* w8 = reinterpret_cast<const uint4*>(w);
    const float4* s4 = reinterpret_cast<const float4*>(s);
    const int nv = n / 8;
#pragma unroll 4
    for (int c = threadIdx.x; c < nv; c += kThreads) {
      const uint4 a = __ldcs(w8 + c);
      const float4 b0 = __ldg(s4 + 2 * c);
      const float4 b1 = __ldg(s4 + 2 * c + 1);
      acc = fmaf(bf16_lo(a.x), bf16_round(b0.x), acc);
      acc = fmaf(bf16_hi(a.x), bf16_round(b0.y), acc);
      acc = fmaf(bf16_lo(a.y), bf16_round(b0.z), acc);
      acc = fmaf(bf16_hi(a.y), bf16_round(b0.w), acc);
      acc = fmaf(bf16_lo(a.z), bf16_round(b1.x), acc);
      acc = fmaf(bf16_hi(a.z), bf16_round(b1.y), acc);
      acc = fmaf(bf16_lo(a.w), bf16_round(b1.z), acc);
      acc = fmaf(bf16_hi(a.w), bf16_round(b1.w), acc);
    }
  } else if constexpr (kBf16) {
    const unsigned short* wu = reinterpret_cast<const unsigned short*>(w);
#pragma unroll 4
    for (int c = threadIdx.x; c < n; c += kThreads) {
      const float a = __uint_as_float(static_cast<uint32_t>(__ldg(wu + c)) << 16);
      acc = fmaf(a, bf16_round(__ldg(s + c)), acc);
    }
  } else {
#pragma unroll 4
    for (int c = threadIdx.x; c < n; c += kThreads) {
      acc = fmaf(__ldcs(w + c), __ldg(s + c), acc);
    }
  }
  return acc;
}

// A 16-byte copy from device to shared memory that uses no registers
// (cp.async, sm_80 and later); bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void copy16(void* smem, const void* gmem, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// One weight of a row as f32 (read-only cache).
template <typename WT>
__device__ __forceinline__ float load1(const WT* __restrict__ w) {
  if constexpr (std::is_same<WT, __nv_bfloat16>::value) {
    return __uint_as_float(static_cast<uint32_t>(
                               __ldg(reinterpret_cast<const unsigned short*>(w))) << 16);
  } else {
    return __ldg(w);
  }
}

constexpr int kWarpTrials = 32;  // one trial per lane

// One step of the reduce-scatter: lanes with bit kOff set keep the upper half
// of v[0..2 kOff) and send the lower half to their partner, the others the
// reverse.  kOff is a template argument so that every index is a constant
// and v stays in registers.
template <int kOff>
__device__ __forceinline__ void scatter_step(float (&v)[kWarpTrials], int lane) {
  const bool upper = (lane & kOff) != 0;
#pragma unroll
  for (int i = 0; i < kOff; ++i) {
    const float send = upper ? v[i] : v[i + kOff];
    const float keep = upper ? v[i + kOff] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
}

// After this, lane l holds in v[0] the sum over the warp's lanes of v[l]: a
// reduce-scatter of 31 shuffles (16 + 8 + 4 + 2 + 1).
__device__ __forceinline__ float reduce_scatter(float (&v)[kWarpTrials], int lane) {
  scatter_step<16>(v, lane);
  scatter_step<8>(v, lane);
  scatter_step<4>(v, lane);
  scatter_step<2>(v, lane);
  scatter_step<1>(v, lane);
  return v[0];
}

}  // namespace rowdot
