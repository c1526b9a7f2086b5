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
// under vmap.  Bound at N = 10,000: W must still be read once, 0.0598 ms in
// bf16 and 0.1195 ms in f32 at 3.35 TB/s; the 2*B*N^2 products (6.4e9 at
// B = 32) take 0.096 ms on the CUDA cores' 67 TFLOP/s of f32 FMAs, which is
// the larger bound for bf16 W.  (A tensor-core form is later work.)
// - The trap: the single-row form, one block per row, would re-read all B
//   source rows s[b, :] per W row, 12.8 GB from L2 per step at B = 32.
// - A block of 4 warps owns 16 rows of W and up to 32 trials.  For each
//   chunk of 128 inputs, it stages that chunk of every trial's s in shared
//   memory once (16 KB; rounded to bf16 for a bf16 W, as the single-row
//   kernel rounds it), with asynchronous copies (cp.async) into two buffers
//   so that the next chunk's copies fly while this one is used; each warp
//   streams 4 values of each of its 4 rows per lane (16-byte f32 or 8-byte
//   bf16 loads, lane l at inputs 4l..4l+3 of the chunk, so the shared reads
//   are conflict-free), a chunk ahead of their use, and multiplies them with
//   every trial's 4 values:
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

#include <type_traits>

#include "row_dot.cuh"

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

// Four consecutive weights of a row as loaded (16 bytes of f32, 8 of bf16;
// streaming hint), and as floats.
template <typename WT>
struct Raw;
template <>
struct Raw<float> {
  using T = float4;
};
template <>
struct Raw<__nv_bfloat16> {
  using T = uint2;
};
template <typename WT>
__device__ __forceinline__ typename Raw<WT>::T raw4(const WT* __restrict__ w) {
  return __ldcs(reinterpret_cast<const typename Raw<WT>::T*>(w));
}
__device__ __forceinline__ float4 cvt4(float4 a) { return a; }
__device__ __forceinline__ float4 cvt4(uint2 u) {
  return make_float4(rowdot::bf16_lo(u.x), rowdot::bf16_hi(u.x), rowdot::bf16_lo(u.y),
                     rowdot::bf16_hi(u.y));
}

template <typename WT>
__device__ __forceinline__ float load1(const WT* __restrict__ w) {
  if constexpr (std::is_same<WT, __nv_bfloat16>::value) {
    return __uint_as_float(static_cast<uint32_t>(
                               __ldg(reinterpret_cast<const unsigned short*>(w))) << 16);
  } else {
    return __ldg(w);
  }
}

// One step of the reduce-scatter: lanes with bit kOff set keep the upper half
// of v[0..2 kOff) and send the lower half to their partner, the others the
// reverse.  kOff is a template argument so that every index is a constant
// and v stays in registers.
template <int kOff>
__device__ __forceinline__ void scatter_step(float (&v)[kRTrials], int lane) {
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
__device__ __forceinline__ float reduce_scatter(float (&v)[kRTrials], int lane) {
  scatter_step<16>(v, lane);
  scatter_step<8>(v, lane);
  scatter_step<4>(v, lane);
  scatter_step<2>(v, lane);
  scatter_step<1>(v, lane);
  return v[0];
}

template <typename WT, bool kVec>
__global__ void __launch_bounds__(kRThreads)
qif_sfa_rows_kernel(const WT* __restrict__ W, const float* __restrict__ v,
                    const float* __restrict__ s, const float* __restrict__ x,
                    const float* __restrict__ eta, const float* __restrict__ inp, long long ld_v,
                    long long ld_s, long long ld_x, long long ld_eta, long long ld_inp,
                    float* __restrict__ out, int n, int n_rows, StepParams p) {
  constexpr bool kBf16 = std::is_same<WT, __nv_bfloat16>::value;
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
  typename Raw<WT>::T wraw[kRRowsPerWarp];  // the next chunk's weights, as loaded
  if constexpr (kVec) {
#pragma unroll
    for (int r = 0; r < kRRowsPerWarp; ++r)
      wraw[r] = (row0 + r < n && 4 * lane < n)
                    ? raw4<WT>(W + static_cast<size_t>(row0 + r) * n + 4 * lane)
                    : typename Raw<WT>::T{};
  }
  for (int c = 0; c < chunks; ++c) {
    const int k0 = c * kRChunk;
    float4 w[kRRowsPerWarp];
    if constexpr (kVec) {
      // this chunk's 4 weights of each row per lane, loaded during the
      // previous chunk; then the next chunk's, which fly while this one is
      // used (without that the loads' latency set the kernel's pace)
#pragma unroll
      for (int r = 0; r < kRRowsPerWarp; ++r) w[r] = cvt4(wraw[r]);
      const int k = k0 + kRChunk + 4 * lane;
#pragma unroll
      for (int r = 0; r < kRRowsPerWarp; ++r)
        wraw[r] = (row0 + r < n && k < n) ? raw4<WT>(W + static_cast<size_t>(row0 + r) * n + k)
                                          : typename Raw<WT>::T{};
    }
    if (c + 1 < chunks) {  // the next chunk's copies fly while this one is used
      stage(c + 1);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    if constexpr (kVec && kBf16) {  // this thread's own copies, rounded as the TPU kernel rounds s
#pragma unroll
      for (int j = 0; j < kVecs / kRThreads; ++j) {
        const int idx = threadIdx.x + j * kRThreads;
        float4 t = ss[c & 1][idx];
        t = make_float4(rowdot::bf16_round(t.x), rowdot::bf16_round(t.y),
                        rowdot::bf16_round(t.z), rowdot::bf16_round(t.w));
        ss[c & 1][idx] = t;
      }
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
// (v', s', x' of each trial), distinct from the inputs.  vec = 1 selects the
// vector loads of W and the asynchronous copies of s: the caller sets it only
// when n and ld_s are multiples of 4 and W and s are 16-byte aligned.
extern "C" int qif_sfa_rows_launch(const void* W, int w_bf16, int vec, const void* v,
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
  if (w_bf16) {
    if (vec) QIF_ROWS(__nv_bfloat16, true);
    else QIF_ROWS(__nv_bfloat16, false);
  } else {
    if (vec) QIF_ROWS(float, true);
    else QIF_ROWS(float, false);
  }
#undef QIF_ROWS
  return static_cast<int>(cudaGetLastError());
}
