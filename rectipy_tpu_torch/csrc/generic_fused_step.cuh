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
// The B-row form (generic_fused_rows_launch) is the same step for B
// independent trials that share the couplings, the parameters and the
// scalars: the TPU kernel as the JAX package's run_batch runs it under vmap
// (rectipy_tpu/network.py:1698).  Bound: W must still be read once per group
// of 32 trials, K*N*N*sizeof(W) bytes (200 MB a bf16 coupling at N = 10,000,
// ~60 us at 3.35 TB/s); but its 2*K*B*N^2 products (6.4e9 at B = 32) on the
// CUDA cores' f32 FMAs take ~96 us at the data-sheet 67 TFLOP/s, so this
// kernel is bound by its operations.  (The tensor cores are a later step.)
// - The trap: the single-trial form, one block per row, would re-read all B
//   source rows per W row (12.8 GB from L2 a step at B = 32 and K = 1).
// - The scheme of qif_sfa_rows_kernel (qif_sfa_step.cu): a block of 4 warps
//   owns 4 * R rows of W and up to 32 trials, R = 4 / K rows a warp (4 for
//   one coupling, 2 for two, 1 from three on), so that the K * R * 32 f32
//   sums a lane keeps stay at 128 registers.  For each chunk of 128 inputs
//   the block stages that chunk of every trial's K sources in shared memory
//   once (16 KB a coupling; dynamic shared memory, two buffers): with
//   asynchronous copies (cp.async) on the vector path, so that the next
//   chunk's copies fly while this one is used.  Each lane streams 4 weights
//   of each of its rows a chunk (16 bytes of a f32 W, 8 of a bf16 one; lane l
//   at inputs 4l..4l+3, so the shared reads are conflict-free), a chunk
//   ahead of their use, and multiplies them with every trial's 4 values.
//   A bf16 W takes the sources rounded to bf16 (RNE), as the single-trial
//   kernel does: each thread rounds the values it copied itself once they
//   have landed, before the chunk's barrier.
// - A reduce-scatter of 31 shuffles (row_dot.cuh) leaves lane b with trial
//   b's sum of each coupling for each row, and lane b runs the epilogue of
//   the single-trial kernel (neuron_update, shared) for (trial b, row).
// - Every per-trial operand is rows of a wider buffer (a row stride per
//   operand; 0 for one shared by every trial), so the node's (B, V*n) state
//   is read in place, and the output is written in that layout, (B, V, n).
// - The scalar instantiation (n not a multiple of 4, a W or source pointer
//   not 16-byte aligned, a source row stride not a multiple of 4) stages
//   with plain loads and reads W one weight a lane.
//
// Interface: plain C functions per generated source, loaded with ctypes;
// they launch on the caller's stream, never synchronise, and return
// cudaGetLastError().

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// One neuron's update from its coupling sums acc, states y and per-neuron
// parameters p: the spikes of the pre-update state, the external slots, the
// tail, then the Euler update and the hard resets (or, in derivative mode,
// the vector field itself) into res.
template <class Prog>
__device__ __forceinline__ void neuron_update(const float* acc, const float* y, const float* p,
                                              const double* c, float drive, float dt,
                                              float thresh, float reset_val, float* res) {
  constexpr int V = Prog::V, S = Prog::S;
  float r[at_least_one<S>()], spk[at_least_one<S>()];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    r[s] = (y[Prog::spike_var(s)] - thresh >= 0.f) ? 1.f : 0.f;
    spk[s] = r[s] / dt;
  }
  float e[Prog::E];
  Prog::gather(e, acc, drive, spk);
  float d[V];
  Prog::tail(y, p, c, e, d);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if constexpr (Prog::kDerivative) {
      res[v] = d[v];
    } else {
      float nv = y[v] + dt * d[v];
      const int s = Prog::reset_spec(v);
      if (s >= 0) nv = nv * (1.f - r[s]) + r[s] * reset_val;
      res[v] = nv;
    }
  }
}

template <class Prog, typename WT, bool kVec>
__global__ void __launch_bounds__(kThreads) generic_fused_step_kernel(const Args<Prog> a) {
  constexpr int K = Prog::K, V = Prog::V, P = Prog::P;
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
  float res[V];
  neuron_update<Prog>(acc, y, p, a.c, a.drive[i], a.dt, a.thresh, a.reset_val, res);
#pragma unroll
  for (int v = 0; v < V; ++v) a.out[v][i] = res[v];
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

// ------------------------------------------------------------- B rows
constexpr int kRWarps = 4;
constexpr int kRThreads = 32 * kRWarps;
constexpr int kRTrials = rowdot::kWarpTrials;  // trials per block, one a lane
constexpr int kRChunk = 128;                   // inputs staged per trial and pass
constexpr int kRVecs = kRTrials * kRChunk / 4;  // float4s of one coupling's staged chunk

// rows of W a warp owns: K * R * 32 sums a lane stay at 128 registers
template <int K>
__host__ __device__ constexpr int rows_per_warp() { return K >= 4 ? 1 : 4 / K; }

// dynamic shared memory of the B-row kernel: two buffers of K staged chunks
template <int K>
constexpr int rows_smem() { return 2 * K * kRVecs * 16; }

template <class Prog>
struct RowArgs {
  const void* W[Prog::K];
  const float* src[Prog::K];
  long long ld_src[Prog::K];
  const float* drive;
  long long ld_drive;
  const float* state[Prog::V];
  long long ld_state[Prog::V];
  const float* vec[at_least_one<Prog::P>()];
  float* out;  // (n_rows, V, n) with row stride ld_out
  long long ld_out;
  double c[at_least_one<Prog::C>()];
  int n, n_rows;
  float dt, thresh, reset_val;
};

// 4 consecutive weights of a row as f32: from 16 bytes of a f32 W or 8 of a
// bf16 one (memory order: the low half of a word first)
__device__ __forceinline__ float4 widen(const float4 w) { return w; }
__device__ __forceinline__ float4 widen(const uint2 w) {
  return make_float4(rowdot::bf16_lo(w.x), rowdot::bf16_hi(w.x), rowdot::bf16_lo(w.y),
                     rowdot::bf16_hi(w.y));
}

template <class Prog, typename WT, bool kVec>
__global__ void __launch_bounds__(kRThreads) generic_fused_rows_kernel(const RowArgs<Prog> a) {
  constexpr int K = Prog::K, V = Prog::V, P = Prog::P;
  constexpr int R = rows_per_warp<K>();
  constexpr bool kBf16 = std::is_same<WT, __nv_bfloat16>::value;
  using Raw = typename std::conditional<kBf16, uint2, float4>::type;
  extern __shared__ float4 gf_stage[];  // [2][K][kRVecs]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = a.n;
  const int b0 = blockIdx.y * kRTrials;
  const int nb = min(kRTrials, a.n_rows - b0);
  const int row0 = (blockIdx.x * kRWarps + warp) * R;
  const int chunks = (n + kRChunk - 1) / kRChunk;
  float acc[K][R][kRTrials];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int b = 0; b < kRTrials; ++b) acc[k][r][b] = 0.f;

  // chunk ch of every trial's K sources into buffer ch & 1: asynchronous
  // 16-byte copies on the vector path (zeros past the data), plain loads
  // (rounded to bf16 for a bf16 W) otherwise
  auto stage = [&](int ch) {
    const int k0 = ch * kRChunk;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float4* dst = gf_stage + ((ch & 1) * K + k) * kRVecs;
      const float* src = a.src[k];
      const long long ld = a.ld_src[k];
      if constexpr (kVec) {
#pragma unroll
        for (int j = 0; j < kRVecs / kRThreads; ++j) {
          const int idx = threadIdx.x + j * kRThreads;
          const int b = idx / (kRChunk / 4);
          const int kk = k0 + 4 * (idx % (kRChunk / 4));
          const bool ok = b < nb && kk < n;
          rowdot::copy16(&dst[idx], ok ? src + (b0 + b) * ld + kk : src, ok ? 16 : 0);
        }
      } else {
        float* sf = reinterpret_cast<float*>(dst);
        for (int idx = threadIdx.x; idx < kRTrials * kRChunk; idx += kRThreads) {
          const int b = idx / kRChunk;
          const int kk = k0 + idx % kRChunk;
          const float val = (b < nb && kk < n) ? __ldg(src + (b0 + b) * ld + kk) : 0.f;
          sf[idx] = kBf16 ? rowdot::bf16_round(val) : val;
        }
      }
    }
    rowdot::copy_commit();
  };

  // the 4 weights of row row0 + r of coupling k at inputs kk..kk+3 (zeros
  // past the matrix)
  auto load_raw = [&](int k, int r, int kk) -> Raw {
    const int i = row0 + r;
    if (i < n && kk < n)
      return __ldcs(reinterpret_cast<const Raw*>(static_cast<const WT*>(a.W[k]) +
                                                 static_cast<size_t>(i) * n + kk));
    return Raw{};
  };

  stage(0);
  Raw wraw[K][R];  // the next chunk's weights (vector path)
  if constexpr (kVec) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int r = 0; r < R; ++r) wraw[k][r] = load_raw(k, r, 4 * lane);
  }
  for (int ch = 0; ch < chunks; ++ch) {
    const int k0 = ch * kRChunk;
    float4 w[K][R];
    if constexpr (kVec) {
      // this chunk's weights, loaded during the previous chunk; then the
      // next chunk's, which fly while this one is used
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int r = 0; r < R; ++r) w[k][r] = widen(wraw[k][r]);
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int r = 0; r < R; ++r) wraw[k][r] = load_raw(k, r, k0 + kRChunk + 4 * lane);
    }
    if (ch + 1 < chunks) {  // the next chunk's copies fly while this one is used
      stage(ch + 1);
      rowdot::copy_wait<1>();
    } else {
      rowdot::copy_wait<0>();
    }
    if constexpr (kVec && kBf16) {  // this thread's own copies of chunk ch have landed
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float4* buf = gf_stage + ((ch & 1) * K + k) * kRVecs;
#pragma unroll
        for (int j = 0; j < kRVecs / kRThreads; ++j) {
          float4& q = buf[threadIdx.x + j * kRThreads];
          q = make_float4(rowdot::bf16_round(q.x), rowdot::bf16_round(q.y),
                          rowdot::bf16_round(q.z), rowdot::bf16_round(q.w));
        }
      }
    }
    __syncthreads();  // chunk ch is in shared memory for every thread
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float4* buf = gf_stage + ((ch & 1) * K + k) * kRVecs;
      if constexpr (kVec) {
#pragma unroll
        for (int b = 0; b < kRTrials; ++b) {
          const float4 sv = buf[b * (kRChunk / 4) + lane];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[k][r][b] = fmaf(w[k][r].x, sv.x, acc[k][r][b]);
            acc[k][r][b] = fmaf(w[k][r].y, sv.y, acc[k][r][b]);
            acc[k][r][b] = fmaf(w[k][r].z, sv.z, acc[k][r][b]);
            acc[k][r][b] = fmaf(w[k][r].w, sv.w, acc[k][r][b]);
          }
        }
      } else {
        const float* sf = reinterpret_cast<const float*>(buf);
        const WT* Wk = static_cast<const WT*>(a.W[k]);
#pragma unroll 1
        for (int q = 0; q < kRChunk / 32; ++q) {
          const int kk = 32 * q + lane;
          const int kg = k0 + kk;
          float w1[R];
#pragma unroll
          for (int r = 0; r < R; ++r)
            w1[r] = (row0 + r < n && kg < n)
                        ? rowdot::load1<WT>(Wk + static_cast<size_t>(row0 + r) * n + kg)
                        : 0.f;
#pragma unroll
          for (int b = 0; b < kRTrials; ++b) {
            const float sv = sf[b * kRChunk + kk];
#pragma unroll
            for (int r = 0; r < R; ++r) acc[k][r][b] = fmaf(w1[r], sv, acc[k][r][b]);
          }
        }
      }
    }
    __syncthreads();  // buffer ch & 1 is free for chunk ch + 2
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float sums[K];
#pragma unroll
    for (int k = 0; k < K; ++k) sums[k] = rowdot::reduce_scatter(acc[k][r], lane);
    const int i = row0 + r;
    if (i < n && lane < nb) {
      const long long b = b0 + lane;
      float y[V];
#pragma unroll
      for (int v = 0; v < V; ++v) y[v] = a.state[v][b * a.ld_state[v] + i];
      float p[at_least_one<P>()];
#pragma unroll
      for (int j = 0; j < P; ++j) p[j] = a.vec[j][i];
      float res[V];
      neuron_update<Prog>(sums, y, p, a.c, a.drive[b * a.ld_drive + i], a.dt, a.thresh,
                          a.reset_val, res);
      float* o = a.out + b * a.ld_out + i;
#pragma unroll
      for (int v = 0; v < V; ++v) o[static_cast<size_t>(v) * n] = res[v];
    }
  }
}

template <class Prog, typename WT, bool kVec>
int launch_rows_instance(const RowArgs<Prog>& a, cudaStream_t st) {
  constexpr int kSmem = rows_smem<Prog::K>();
  // above 48 KB only after this (K >= 2); asked once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      generic_fused_rows_kernel<Prog, WT, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  constexpr int kRows = kRWarps * rows_per_warp<Prog::K>();
  const dim3 grid((a.n + kRows - 1) / kRows, (a.n_rows + kRTrials - 1) / kRTrials);
  generic_fused_rows_kernel<Prog, WT, kVec><<<grid, kRThreads, kSmem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: K W matrices ((n, n) row-major, f32 or bf16 by w_bf16), K source
// bases, the drive base, V state bases, P per-neuron rows ((n,), shared by
// every trial), then the output base.  lds: the row strides (in floats) of
// the K sources, the drive, the V states and the output; row b of an operand
// starts at base + b * ld (ld 0: one row shared by every trial), n
// contiguous f32 each.  The output, (n_rows, V, n) f32 at row stride ld_out
// (>= V * n), must not overlap an input.  scalars: C doubles.  vec = 1
// selects the 16-byte loads of W and the asynchronous copies of the
// sources: the caller sets it only when n % 4 == 0, every W and source base
// is 16-byte aligned and every source row stride a multiple of 4.
template <class Prog>
int launch_rows(const uint64_t* ptrs, const long long* lds, const double* scalars, int n,
                int n_rows, int w_bf16, int vec, float dt, float thresh, float reset_val,
                void* stream) {
  if (n <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  constexpr int K = Prog::K, V = Prog::V, P = Prog::P, C = Prog::C;
  RowArgs<Prog> a{};
  int k = 0, l = 0;
  for (int c = 0; c < K; ++c) a.W[c] = reinterpret_cast<const void*>(ptrs[k++]);
  for (int c = 0; c < K; ++c) {
    a.src[c] = reinterpret_cast<const float*>(ptrs[k++]);
    a.ld_src[c] = lds[l++];
  }
  a.drive = reinterpret_cast<const float*>(ptrs[k++]);
  a.ld_drive = lds[l++];
  for (int v = 0; v < V; ++v) {
    a.state[v] = reinterpret_cast<const float*>(ptrs[k++]);
    a.ld_state[v] = lds[l++];
  }
  for (int j = 0; j < P; ++j) a.vec[j] = reinterpret_cast<const float*>(ptrs[k++]);
  a.out = reinterpret_cast<float*>(ptrs[k++]);
  a.ld_out = lds[l++];
  for (int j = 0; j < C; ++j) a.c[j] = scalars[j];
  a.n = n;
  a.n_rows = n_rows;
  a.dt = dt;
  a.thresh = thresh;
  a.reset_val = reset_val;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bf16) {
    return vec ? launch_rows_instance<Prog, __nv_bfloat16, true>(a, st)
               : launch_rows_instance<Prog, __nv_bfloat16, false>(a, st);
  }
  return vec ? launch_rows_instance<Prog, float, true>(a, st)
             : launch_rows_instance<Prog, float, false>(a, st);
}

}  // namespace gf

// The generated source's entry points: one pair per template structure.
#define GF_DEFINE_LAUNCH(PROG)                                                              \
  extern "C" int generic_fused_step_launch(const uint64_t* ptrs, const double* scalars,     \
                                           int n, int w_bf16, int vec, float dt,           \
                                           float thresh, float reset_val, void* stream) {   \
    return gf::launch<PROG>(ptrs, scalars, n, w_bf16, vec, dt, thresh, reset_val, stream);  \
  }                                                                                         \
  extern "C" int generic_fused_rows_launch(const uint64_t* ptrs, const long long* lds,      \
                                           const double* scalars, int n, int n_rows,        \
                                           int w_bf16, int vec, float dt, float thresh,     \
                                           float reset_val, void* stream) {                 \
    return gf::launch_rows<PROG>(ptrs, lds, scalars, n, n_rows, w_bf16, vec, dt, thresh,    \
                                 reset_val, stream);                                        \
  }
