// Generic fused explicit-Euler step (or one derivative, for Heun) of a
// population node whose vector field is tile-local, for NVIDIA Hopper
// (sm_90a).  The node's own equations arrive as a generated source
// (rectipy_tpu_torch/dsl/cuda.py) that includes this header and defines a
// `Program`: the shape (K couplings, V state rows, P per-neuron parameter
// rows, C scalar parameters, S spike specs, E external input slots), the
// spike wiring and the tail, the vector field with the coupling sums handed
// in.
//
// Replaces the Pallas TPU kernel rectipy_tpu/ops/generic_fused.py::
// attach_generic_fused_step (kernel body generic_fused.py:165-222).  For
// neuron i:
//
//   acc_c   = sum_j W_c[i, j] * src_c[j]      f32 sums; a bf16 W takes src
//                                             rounded to bf16
//   r_s     = (y[spike_var(s)] - thresh >= 0) ? 1 : 0   pre-update state
//   e       = gather(drive_i, acc, r/dt)      the external slots, in the
//                                             plain version's order
//   d       = tail(y, p, c, e)                the node's vector field
//   y'_v    = y_v + dt*d_v, then new*(1 - r) + r*reset_val for a state row a
//             hard-resetting spike spec owns; or d itself in derivative mode
//
// Bound.  The step must read every W_c once: K*N*N*sizeof(W) bytes (200 MB
// for one bf16 coupling at N = 10,000), far above the H100's 50 MB L2, so W
// streams from HBM every step: at least ~60 us per bf16 coupling at the
// data-sheet 3.35 TB/s.  The per-neuron rows (a few times 40 KB) and the
// tail's arithmetic (tens of operations per neuron) do not move that bound.
// These are derived figures, not measurements.
//
// Design against that bound (that of qif_sfa_step.cu): one 256-thread block
// per output row, W row-major and unpadded, 16-byte streaming loads through
// rowdot::partial_dot (row_dot.cuh) with K partial sums per thread, a warp
// shuffle reduction and then one in shared memory; thread 0 runs the
// epilogue for neuron i.  The scalar instantiation takes n not a multiple of
// the vector width and pointers that are not 16-byte aligned.  Scalar
// parameters travel as doubles in the kernel's argument struct, so a
// template compiles once whatever their values.
//
// Interface: a plain C function per generated source, loaded with ctypes; it
// launches on the caller's stream, never synchronises, and returns
// cudaGetLastError().

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "generic_fused_math.cuh"
#include "row_dot.cuh"

namespace gf {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// array length for a count that may be 0 (device code may call it too)
template <int X>
__host__ __device__ constexpr int at_least_one() { return X > 0 ? X : 1; }

template <class Prog>
struct Args {
  const void* W[Prog::K];
  const float* src[Prog::K];
  const float* drive;
  const float* state[Prog::V];
  const float* vec[at_least_one<Prog::P>()];
  float* out[Prog::V];
  double c[at_least_one<Prog::C>()];
  int n;
  float dt, thresh, reset_val;
};

template <class Prog, typename WT, bool kVec>
__global__ void __launch_bounds__(kThreads) generic_fused_step_kernel(const Args<Prog> a) {
  constexpr int K = Prog::K, V = Prog::V, P = Prog::P, S = Prog::S;
  __shared__ float warp_sums[K][kWarps];
  const int i = blockIdx.x;
  const size_t row = static_cast<size_t>(i) * a.n;
  float acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    acc[c] = rowdot::partial_dot<WT, kVec, kThreads>(static_cast<const WT*>(a.W[c]) + row,
                                                     a.src[c], a.n);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[c] += __shfl_down_sync(0xffffffffu, acc[c], off);
    if ((threadIdx.x & 31) == 0) warp_sums[c][threadIdx.x >> 5] = acc[c];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

#pragma unroll
  for (int c = 0; c < K; ++c) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += warp_sums[c][w];
    acc[c] = sum;
  }
  float y[V];
#pragma unroll
  for (int v = 0; v < V; ++v) y[v] = a.state[v][i];
  float p[at_least_one<P>()];
#pragma unroll
  for (int j = 0; j < P; ++j) p[j] = a.vec[j][i];
  float r[at_least_one<S>()], spk[at_least_one<S>()];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    r[s] = (y[Prog::spike_var(s)] - a.thresh >= 0.f) ? 1.f : 0.f;
    spk[s] = r[s] / a.dt;
  }
  float e[Prog::E];
  Prog::gather(e, acc, a.drive[i], spk);
  float d[V];
  Prog::tail(y, p, a.c, e, d);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if constexpr (Prog::kDerivative) {
      a.out[v][i] = d[v];
    } else {
      float nv = y[v] + a.dt * d[v];
      const int s = Prog::reset_spec(v);
      if (s >= 0) nv = nv * (1.f - r[s]) + r[s] * a.reset_val;
      a.out[v][i] = nv;
    }
  }
}

// ptrs: K W matrices ((n, n) row-major, f32 or bf16 by w_bf16), K source
// rows, the drive row, V state rows, P per-neuron rows, then V output rows
// (all (n,) f32; the outputs distinct from the inputs).  scalars: C doubles.
// vec = 1 selects the 16-byte-vector loop; the caller sets it only when n is
// a multiple of the vector width (4 f32, 8 bf16) and every W and source row
// is 16-byte aligned.
template <class Prog>
int launch(const uint64_t* ptrs, const double* scalars, int n, int w_bf16, int vec, float dt,
           float thresh, float reset_val, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  constexpr int K = Prog::K, V = Prog::V, P = Prog::P, C = Prog::C;
  Args<Prog> a{};
  int k = 0;
  for (int c = 0; c < K; ++c) a.W[c] = reinterpret_cast<const void*>(ptrs[k++]);
  for (int c = 0; c < K; ++c) a.src[c] = reinterpret_cast<const float*>(ptrs[k++]);
  a.drive = reinterpret_cast<const float*>(ptrs[k++]);
  for (int v = 0; v < V; ++v) a.state[v] = reinterpret_cast<const float*>(ptrs[k++]);
  for (int j = 0; j < P; ++j) a.vec[j] = reinterpret_cast<const float*>(ptrs[k++]);
  for (int v = 0; v < V; ++v) a.out[v] = reinterpret_cast<float*>(ptrs[k++]);
  for (int j = 0; j < C; ++j) a.c[j] = scalars[j];
  a.n = n;
  a.dt = dt;
  a.thresh = thresh;
  a.reset_val = reset_val;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bf16) {
    if (vec) generic_fused_step_kernel<Prog, __nv_bfloat16, true><<<n, kThreads, 0, st>>>(a);
    else generic_fused_step_kernel<Prog, __nv_bfloat16, false><<<n, kThreads, 0, st>>>(a);
  } else {
    if (vec) generic_fused_step_kernel<Prog, float, true><<<n, kThreads, 0, st>>>(a);
    else generic_fused_step_kernel<Prog, float, false><<<n, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gf

// The generated source's entry point: one per template structure.
#define GF_DEFINE_LAUNCH(PROG)                                                          \
  extern "C" int generic_fused_step_launch(const uint64_t* ptrs, const double* scalars, \
                                           int n, int w_bf16, int vec, float dt,       \
                                           float thresh, float reset_val, void* stream) { \
    return gf::launch<PROG>(ptrs, scalars, n, w_bf16, vec, dt, thresh, reset_val, stream); \
  }
