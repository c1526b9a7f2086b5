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
// Interface: a plain C function, loaded with ctypes; it launches on the
// caller's stream, never synchronises, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_dot.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct StepParams {
  float dt, inv_dt, inv_tau, inv_tau_s, inv_tau_x, k, alpha, thresh, v_reset;
};

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
  const float vi = v[i];
  const float si = s[i];
  const float xi = x[i];
  const float reset = (vi - p.thresh >= 0.f) ? 1.f : 0.f;
  const float spikes = reset * p.inv_dt;
  const float dv = (vi * vi + (eta[i] - xi) + inp[i]) * p.inv_tau + p.k * s_in;
  const float ds = -si * p.inv_tau_s + spikes;
  const float dx = -xi * p.inv_tau_x + p.alpha * spikes;
  v_out[i] = (vi + p.dt * dv) * (1.f - reset) + reset * p.v_reset;
  s_out[i] = si + p.dt * ds;
  x_out[i] = xi + p.dt * dx;
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
