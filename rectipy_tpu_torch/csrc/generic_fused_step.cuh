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
// ~60 us at 3.35 TB/s).  Its 2*K*B*N^2 products (6.4e9 at B = 32) take ~96
// us on the CUDA cores' f32 FMAs (67 TFLOP/s) and ~6.5 us on the tensor
// cores' bf16 (989 TFLOP/s).  So a bf16 W belongs on the tensor cores,
// where the step is bound by its bytes.  A f32 W stays on the CUDA cores,
// since TF32 would change its numbers; there its FMAs take 80% of its
// bytes' time (0.096 of 0.1195 ms a coupling), so the step must stream W
// near the HBM rate and keep the FMA pipe busy at once.
// - The trap: the single-trial form, one block per row, would re-read all B
//   source rows per W row (12.8 GB from L2 a step at B = 32 and K = 1).
//
// A bf16 W with n % 8 == 0, every W and source base 16-byte aligned and
// every source row stride a multiple of 4 takes the tensor cores
// (generic_fused_rows_mma_kernel, route 2): the MXU's bf16 x bf16 -> f32
// product of the TPU kernel (generic_fused.py:183-187, the sources cast to
// W's dtype), which mma.sync m16n8k16 computes on sources rounded to bf16
// (RNE).  It is qif_sfa_rows_mma_kernel's scheme (qif_sfa_step.cu, whose
// header note gives the reasons; its geometry and mma pieces are shared in
// rows_mma.cuh): a block owns 80 rows of W and 32 trials (125 blocks at
// N = 10,000, one an SM), ten warps = 5 row tiles x 2 parts of each chunk's
// 384 inputs; W goes from HBM straight into a register ring of 16-byte loads
// with the k-permutation that makes a lane's B fragments one 16-byte shared
// load; each chunk of the 32 trials' f32 sources is copied with cp.async a
// chunk ahead and rounded to bf16 by the thread that copied it, into one of
// two padded buffers, one barrier a chunk; each slab's products start from
// zero and are added to the f32 sums by round-to-nearest adds.  What the
// generic step adds:
// - K couplings in turn, not side by side: a W ring per coupling would
//   multiply the ring's 48 registers a lane by K.  The block runs coupling
//   0's chunks over all n, then coupling 1's, and so on, through one ring
//   and one pair of staging buffers (the last chunk of coupling c prefetches
//   chunk 0 of coupling c + 1), and keeps K sets of accumulator fragments
//   (16 f32 registers each).  Each W is still read once.
// - The two K parts' sums of all K couplings meet in shared memory (the
//   staging buffers, or K * rowmma::kMSumBytes where that is larger); the
//   accumulator fragment gives each lane 2 rows x 2 trials of each n-tile,
//   and each part runs the generated epilogue (neuron_update) for two
//   n-tiles' (trial, row) pairs, masking rows >= n and trials >= the
//   group's count.  Derivative mode (Heun) comes through the epilogue.
// - The epilogue loads every input of a lane's 8 updates before it stores
//   the first result: in one wave of blocks every block's epilogue comes
//   last, so updates in turn, each waiting for its loads behind the
//   previous one's stores, were most of the gap to the QIF kernel.
//
// A f32 W of at most kTiledMaxK (5) couplings with n % 4 == 0, every W and
// source base 16-byte aligned and every source row stride a multiple of 4
// takes generic_fused_rows_tiled_kernel on the CUDA cores (route 3,
// "tiled"), which sums as qif_sfa_rows_tiled_kernel does (qif_sfa_step.cu):
// rows_tiled.cuh's block_sums over an 80-row strip and a group of 32
// trials (125 blocks at N = 10,000, one wave of one block an SM), W and the
// sources through a cp.async ring in shared memory, a register micro-tile
// of 10 rows x 8 trials a lane, eight K parts that meet in shared memory
// (GenericTile, the QIF kernel's geometry).  The sources cross L2 once per
// strip and coupling (160 MB a coupling at B = 32), where the vector
// instance below, at 16 rows a block for K = 1 and 8 for K = 2, read 800 MB
// and 3.2 GB.  What the generic step adds:
// - K couplings in turn: block_sums of coupling 0 over all n, then of
//   coupling 1, and so on, so that each W is still read once per trial
//   group.  block_sums ends by laying its parts' sums over the ring; after
//   a barrier each thread adds the parts of its (trial, row) pairs
//   (part_sum) into an area of its own beside the ring, [K][32][80] f32 (10
//   KB a coupling), and a second barrier frees the ring for the next
//   coupling's chunks.  Keeping the earlier couplings' sums in registers
//   across the next block_sums would not fit: its micro-tile alone takes
//   most of the 255 registers a thread.  The ring (177 KB) and K areas fit
//   the 227 KB a block may have up to K = 5; more couplings take the vector
//   instance (ops/generic_fused.py's generic_rows_route says so from the
//   shapes).  Draining and refilling the ring costs about two chunks of 79
//   per coupling.
// - The epilogue takes a thread's 10 (trial, row) pairs with consecutive
//   threads on consecutive rows and loads every input of them (the K sums,
//   the V states, the drive, the P per-neuron rows) before it stores the
//   first result, for the reason above; rows >= n and trials >= the group's
//   count are masked.  Derivative mode (Heun) comes through neuron_update.
// - Its probes (rowtile::kProbe*: no FMAs, no staging of the sources, the
//   ring's stream alone) are launched through generic_fused_rows_tiled_
//   probe_launch for timing.
//
// Every other B-row launch (a W that is not aligned as above; a f32 W of
// more than kTiledMaxK couplings) runs generic_fused_rows_kernel on the
// CUDA cores, and its f32 and bf16 vector instances stay the tiled and
// tensor-core kernels' yardsticks (route 1 through the C entry point):
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
#include "rows_mma.cuh"
#include "rows_tiled.cuh"

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

// ------------------------------------------- B rows, bf16 W, tensor cores
// the launch's route codes (ops/generic_fused.py's _ROWS_ROUTES)
constexpr int kRouteScalar = 0, kRouteVec = 1, kRouteMma = 2, kRouteTiled = 3;

// dynamic shared memory of the tensor-core B-row kernel: the staging
// buffers, or the K couplings' partial sums where the two K parts meet
template <int K>
__host__ __device__ constexpr int rows_mma_smem() {
  return rowmma::kMSmem > K * rowmma::kMSumBytes ? rowmma::kMSmem : K * rowmma::kMSumBytes;
}

// The aligned bf16 B-row step (header note).  Warp w owns rows 16 (w %
// kMRowTiles) .. +16 of the block's and the part w / kMRowTiles of every
// chunk of kMChunk inputs, for each coupling in turn.
template <class Prog>
__global__ void __launch_bounds__(rowmma::kMThreads, 1)
    generic_fused_rows_mma_kernel(const RowArgs<Prog> a) {
  using namespace rowmma;
  constexpr int K = Prog::K, V = Prog::V, P = Prog::P;
  static_assert(rowmma::kRTrials == gf::kRTrials, "one trial per lane");
  static_assert(rows_mma_smem<K>() <= 232448, "the K couplings' sums must fit shared memory");
  extern __shared__ __align__(16) unsigned char gf_mma_smem[];
  unsigned char* ss = gf_mma_smem;  // [2][kRTrials * kMStride] bf16
  float4* sf = reinterpret_cast<float4*>(gf_mma_smem + kMBf16Bytes);  // [kRTrials * kMQuads]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // the fragments' group and thread in group
  const int tile = warp % kMRowTiles, part = warp / kMRowTiles;
  const int n = a.n;
  const int b0 = blockIdx.y * kRTrials;
  const int nb = min(kRTrials, a.n_rows - b0);
  const int row = blockIdx.x * kMRows + 16 * tile + g;  // and row + 8
  const int kw = part * 32 * kMSlabs + 8 * t;  // the lane's inputs in a chunk: kw + 32 j + [0, 8)
  const bool ok_lo = row < n, ok_hi = row + 8 < n;
  const int chunks = (n + kMChunk - 1) / kMChunk;
  // the lane's first inputs of rows (row, row + 8) in coupling c's W
  auto lane_w = [&](int c, int r8) {
    const int r = row + r8;
    return static_cast<const __nv_bfloat16*>(a.W[c]) + static_cast<size_t>(r < n ? r : 0) * n +
           kw;
  };

  uint4 ring[kMSlabs][2];  // W of rows (row, row + 8), a chunk ahead of its use
  // slab j of the chunk at input k0 of the W whose lane pointers are w_lo,
  // w_hi (zeros, and no load, past the data)
  auto load_w = [&](const __nv_bfloat16* w_lo, const __nv_bfloat16* w_hi, int k0, int j) {
    const int k = k0 + 32 * j;
    const bool in = kw + k < n;  // n % 8 == 0: the lane's 8 inputs are all in or all out
    ring[j][0] = (ok_lo && in) ? __ldcs(reinterpret_cast<const uint4*>(w_lo + k)) : uint4{};
    ring[j][1] = (ok_hi && in) ? __ldcs(reinterpret_cast<const uint4*>(w_hi + k)) : uint4{};
  };
  // chunk ch of the trials' rows of one source: cp.async, zeros past the data
  auto fetch_s = [&](const float* src, long long ld, int ch) {
#pragma unroll
    for (int q = 0; q < kMStage; ++q) {
      const int idx = threadIdx.x + q * kMThreads;
      const int b = idx / kMQuads;
      const int k = ch * kMChunk + 4 * (idx % kMQuads);
      const bool ok = b < nb && k < n;
      if (idx < kRTrials * kMQuads)
        rowdot::copy16(&sf[idx], ok ? src + (b0 + b) * ld + k : src, ok ? 16 : 0);
    }
    rowdot::copy_commit();
  };
  auto store_s = [&](int buf) {  // this thread's own copies, rounded to bf16 on the way in
    rowdot::copy_wait<0>();
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
  // trial 8 nt + g's inputs kw + 32 j + [0, 8) of the chunk in buffer 0
  const unsigned char* s_lane = ss + g * kMStride + 2 * kw;
  // the products of the chunk in the ring and in buffer buf into acc (one
  // coupling's 4 n-tiles), loading each slab's next chunk into the ring
  // as its weights are taken (from w_lo, w_hi at input k_next; none when
  // w_lo is null)
  auto chunk = [&](float (&acc)[4][4], int buf, const __nv_bfloat16* w_lo,
                   const __nv_bfloat16* w_hi, int k_next) {
    const unsigned char* sb = s_lane + buf * (kRTrials * kMStride);
#pragma unroll
    for (int j = 0; j < kMSlabs; ++j) {
      const uint4 lo = ring[j][0], hi = ring[j][1];
      if (w_lo != nullptr) load_w(w_lo, w_hi, k_next, j);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint4 bv = *reinterpret_cast<const uint4*>(sb + 8 * nt * kMStride + 64 * j);
        float d[4];
        // k-slab as two k16 fragments: words 0, 1 of each row's 16 bytes, then 2, 3
        mma_bf16(d, lo.x, hi.x, lo.y, hi.y, bv.x, bv.y, 0.f, 0.f, 0.f, 0.f);
        mma_bf16(d, lo.z, hi.z, lo.w, hi.w, bv.z, bv.w, d[0], d[1], d[2], d[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] += d[i];  // round-to-nearest f32 adds
      }
    }
  };

  fetch_s(a.src[0], a.ld_src[0], 0);
#pragma unroll
  for (int j = 0; j < kMSlabs; ++j) load_w(lane_w(0, 0), lane_w(0, 8), 0, j);
  store_s(0);
  __syncthreads();
  // coupling, n-tile, fragment element: rows (row, row + 8) x trials 8 nt + 2 t + {0, 1}
  float acc[K][4][4];
#pragma unroll
  for (int c = 0; c < K; ++c)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][nt][i] = 0.f;
  int buf = 0;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    // the chunks of coupling c but its last: the next chunk of the same W
    // and source fly while this one is used
    const __nv_bfloat16 *w_lo = lane_w(c, 0), *w_hi = lane_w(c, 8);
    for (int ch = 0; ch + 1 < chunks; ++ch) {
      fetch_s(a.src[c], a.ld_src[c], ch + 1);
      chunk(acc[c], buf, w_lo, w_hi, (ch + 1) * kMChunk);
      buf ^= 1;
      store_s(buf);
      __syncthreads();  // this chunk used up, the next one staged
    }
    // its last chunk: coupling c + 1's first flies meanwhile
    if (c + 1 < K) {
      const int cn = c + 1 < K ? c + 1 : c;  // (no index past the arrays, even unused)
      fetch_s(a.src[cn], a.ld_src[cn], 0);
      chunk(acc[c], buf, lane_w(cn, 0), lane_w(cn, 8), 0);
      buf ^= 1;
      store_s(buf);
    } else {
      chunk(acc[c], buf, nullptr, nullptr, 0);
    }
    __syncthreads();
  }
  // the K parts' sums meet; part q keeps the n-tiles nt % kMKSplit == q
  float* red = reinterpret_cast<float*>(gf_mma_smem);  // [coupling][part][tile][nt][i][lane]
  auto at = [&](int c, int q, int nt, int i) {
    return red + ((((c * kMKSplit + q) * kMRowTiles + tile) * 4 + nt) * 4 + i) * 32 + lane;
  };
#pragma unroll
  for (int c = 0; c < K; ++c)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      if (nt % kMKSplit != part)
#pragma unroll
        for (int i = 0; i < 4; ++i) *at(c, part, nt, i) = acc[c][nt][i];
  __syncthreads();
  // The lane's 8 (trial, row) pairs: n-tile nt = kMKSplit h + part, element
  // i, so rows row + 8 (i >> 1) and trial 8 nt + 2 t + (i & 1).  Every input
  // of the 8 updates is loaded before the first result is stored: the
  // operands are plain pointers of the argument struct, so the compiler
  // may not move a load past a store, and one update after another would
  // pay a memory latency each (at N = 10,000 every block's epilogue ends
  // the one wave, so those latencies add to the kernel's time).
  static_assert(kMKSplit == 2, "a part owns every other n-tile");
  constexpr int kPairs = 2 * 4;
  float sums[kPairs][K], y[kPairs][V], drive[kPairs];
  float p[2][at_least_one<P>()];  // per-neuron rows of rows row, row + 8
  bool ok[kPairs];
  long long bs[kPairs];
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int j = 0; j < P; ++j)
      p[half][j] = row + 8 * half < n ? a.vec[j][row + 8 * half] : 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * h + i;
      const int tb = 8 * (kMKSplit * h + part) + 2 * t + (i & 1);
      const int r = row + 8 * (i >> 1);
      ok[e] = tb < nb && r < n;
      bs[e] = b0 + tb;
#pragma unroll
      for (int c = 0; c < K; ++c)  // this part's sum (a select, no indexed registers) + the other's
        sums[e][c] = (part ? acc[c][kMKSplit * h + 1][i] : acc[c][kMKSplit * h][i]) +
                     *at(c, 1 - part, kMKSplit * h + part, i);
      if (ok[e]) {
#pragma unroll
        for (int v = 0; v < V; ++v) y[e][v] = a.state[v][bs[e] * a.ld_state[v] + r];
        drive[e] = a.drive[bs[e] * a.ld_drive + r];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kPairs; ++e) {
    if (!ok[e]) continue;
    const int r = row + 8 * ((e & 3) >> 1);
    float res[V];
    neuron_update<Prog>(sums[e], y[e], p[(e & 3) >> 1], a.c, drive[e], a.dt, a.thresh,
                        a.reset_val, res);
    float* o = a.out + bs[e] * a.ld_out + r;
#pragma unroll
    for (int v = 0; v < V; ++v) o[static_cast<size_t>(v) * n] = res[v];
  }
}

template <class Prog>
int launch_rows_mma(const RowArgs<Prog>& a, cudaStream_t st) {
  constexpr int kSmem = rows_mma_smem<Prog::K>();
  // above 48 KB only after this; asked once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      generic_fused_rows_mma_kernel<Prog>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.n + rowmma::kMRows - 1) / rowmma::kMRows,
                  (a.n_rows + kRTrials - 1) / kRTrials);
  generic_fused_rows_mma_kernel<Prog><<<grid, rowmma::kMThreads, kSmem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- B rows, f32 W, tiled
// The geometry (rows_tiled.cuh; qif_sfa_step.cu's QifTile): 10 rows x 8
// trials a lane (a warp: 8 row groups x 4 trial groups, all 80 rows of the
// strip), 8 warps each on an eighth of every chunk, a ring of 3 chunks of
// 128 inputs (177 KB of shared memory).
using GenericTile = rowtile::Geometry<10, 8, 1, 8, 128, 3>;
static_assert(rowtile::kTrials == kRTrials, "32 trials a block");

// bytes of one coupling's sums beside the ring, [kRTrials][kRows] f32
constexpr int kTiledSumBytes = kRTrials * GenericTile::kRows * 4;
// the most couplings whose sums fit beside the ring in 227 KB
constexpr int kTiledMaxK = (232448 - GenericTile::kSmem) / kTiledSumBytes;

// dynamic shared memory of the tiled kernel: the ring, then K couplings' sums
template <int K>
__host__ __device__ constexpr int rows_tiled_smem() {
  return GenericTile::kSmem + K * kTiledSumBytes;
}

// The aligned f32 B-row step (header note): each coupling's block_sums in
// turn, its parts added into the coupling's sums beside the ring, then each
// thread's (trial, row) pairs through the epilogue.  kProbe: rowtile's
// probes, whose outputs are meaningless.
template <class Prog, int kProbe>
__global__ void __launch_bounds__(GenericTile::kThreads, 1)
    generic_fused_rows_tiled_kernel(const RowArgs<Prog> a) {
  using G = GenericTile;
  constexpr int K = Prog::K, V = Prog::V, P = Prog::P;
  constexpr int kSums = kRTrials * G::kRows;     // one coupling's (trial, row) pairs
  constexpr int kPairs = kSums / G::kThreads;    // a thread's
  static_assert(kSums % G::kThreads == 0, "whole pairs a thread");
  static_assert(rows_tiled_smem<K>() <= 232448, "the K couplings' sums must fit shared memory");
  extern __shared__ __align__(16) unsigned char gf_tiled_smem[];
  float* ring = reinterpret_cast<float*>(gf_tiled_smem);
  float* sums = ring + G::kSmem / 4;  // [K][kRTrials][kRows]
  const int n = a.n;
  const int b0 = blockIdx.y * kRTrials;
  const int nb = min(kRTrials, a.n_rows - b0);
  const int row0 = blockIdx.x * G::kRows;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    rowtile::block_sums<G, kProbe>(static_cast<const float*>(a.W[c]), a.src[c], a.ld_src[c], n,
                                   nb, b0, row0, ring);
    __syncthreads();  // the parts' sums lie over the ring
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int e = threadIdx.x + j * G::kThreads;
      sums[c * kSums + e] = rowtile::part_sum<G>(ring, e / G::kRows, e % G::kRows);
    }
    if (c + 1 < K) __syncthreads();  // the ring is free for the next coupling's chunks
  }
  // The thread's pairs e = threadIdx.x + j kThreads: trial e / kRows, row
  // row0 + e % kRows, consecutive threads on consecutive rows; it reads back
  // only the sums it wrote.  Every input of its updates is loaded before the
  // first result is stored (the tensor-core kernel's note above).
  float acc[kPairs][K], y[kPairs][V], drive[kPairs], p[kPairs][at_least_one<P>()];
  bool ok[kPairs];
  long long bs[kPairs];
  int rs[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int e = threadIdx.x + j * G::kThreads;
    const int t = e / G::kRows;
    rs[j] = row0 + e % G::kRows;
    bs[j] = b0 + t;
    ok[j] = t < nb && rs[j] < n;
#pragma unroll
    for (int c = 0; c < K; ++c) acc[j][c] = sums[c * kSums + e];
    if (ok[j]) {
#pragma unroll
      for (int v = 0; v < V; ++v) y[j][v] = a.state[v][bs[j] * a.ld_state[v] + rs[j]];
      drive[j] = a.drive[bs[j] * a.ld_drive + rs[j]];
#pragma unroll
      for (int q = 0; q < P; ++q) p[j][q] = a.vec[q][rs[j]];
    }
  }
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    if (!ok[j]) continue;
    float res[V];
    neuron_update<Prog>(acc[j], y[j], p[j], a.c, drive[j], a.dt, a.thresh, a.reset_val, res);
    float* o = a.out + bs[j] * a.ld_out + rs[j];
#pragma unroll
    for (int v = 0; v < V; ++v) o[static_cast<size_t>(v) * n] = res[v];
  }
}

template <class Prog, int kProbe>
int launch_rows_tiled(const RowArgs<Prog>& a, cudaStream_t st) {
  if constexpr (Prog::K > kTiledMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    constexpr int kSmem = rows_tiled_smem<Prog::K>();
    // above 48 KB only after this; asked once per instantiation
    static const cudaError_t attr =
        cudaFuncSetAttribute(generic_fused_rows_tiled_kernel<Prog, kProbe>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((a.n + GenericTile::kRows - 1) / GenericTile::kRows,
                    (a.n_rows + kRTrials - 1) / kRTrials);
    generic_fused_rows_tiled_kernel<Prog, kProbe><<<grid, GenericTile::kThreads, kSmem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
}

// The argument struct of one B-row launch (launch_rows' operands).
template <class Prog>
RowArgs<Prog> row_args(const uint64_t* ptrs, const long long* lds, const double* scalars, int n,
                       int n_rows, float dt, float thresh, float reset_val) {
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
  return a;
}

// ptrs: K W matrices ((n, n) row-major, f32 or bf16 by w_bf16), K source
// bases, the drive base, V state bases, P per-neuron rows ((n,), shared by
// every trial), then the output base.  lds: the row strides (in floats) of
// the K sources, the drive, the V states and the output; row b of an operand
// starts at base + b * ld (ld 0: one row shared by every trial), n
// contiguous f32 each.  The output, (n_rows, V, n) f32 at row stride ld_out
// (>= V * n), must not overlap an input.  scalars: C doubles.  route:
// kRouteMma, the tensor cores (a bf16 W only), kRouteTiled, the tiled
// CUDA-core kernel (a f32 W of at most kTiledMaxK couplings only), and
// kRouteVec, the 16-byte loads of W and the asynchronous copies of the
// sources on the CUDA cores, want n % 4 == 0 (n % 8 == 0 for kRouteMma),
// every W and source base 16-byte aligned and every source row stride a
// multiple of 4; the caller checks that (ops/generic_fused.py's
// generic_rows_route).  kRouteScalar takes anything.  A route a W type or
// K does not take is refused (cudaErrorInvalidValue).
template <class Prog>
int launch_rows(const uint64_t* ptrs, const long long* lds, const double* scalars, int n,
                int n_rows, int w_bf16, int route, float dt, float thresh, float reset_val,
                void* stream) {
  if (n <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  if (route < kRouteScalar || route > kRouteTiled || (route == kRouteMma && !w_bf16) ||
      (route == kRouteTiled && (w_bf16 || Prog::K > kTiledMaxK)))
    return static_cast<int>(cudaErrorInvalidValue);
  const RowArgs<Prog> a =
      row_args<Prog>(ptrs, lds, scalars, n, n_rows, dt, thresh, reset_val);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteMma) return launch_rows_mma<Prog>(a, st);
  if (route == kRouteTiled) return launch_rows_tiled<Prog, 0>(a, st);
  const bool vec = route == kRouteVec;
  if (w_bf16) {
    return vec ? launch_rows_instance<Prog, __nv_bfloat16, true>(a, st)
               : launch_rows_instance<Prog, __nv_bfloat16, false>(a, st);
  }
  return vec ? launch_rows_instance<Prog, float, true>(a, st)
             : launch_rows_instance<Prog, float, false>(a, st);
}

// The probes of the tiled kernel (rowtile::kProbe*), for timing: probe 1
// streams W and the sources through the ring and reads the micro-tiles'
// operands without the FMAs; probe 2 skips the copies of the sources; probe
// 4 streams W and the sources through the ring and reads nothing.  Same
// operands as launch_rows on kRouteTiled; the output is meaningless.
template <class Prog>
int launch_rows_tiled_probe(const uint64_t* ptrs, const long long* lds, const double* scalars,
                            int n, int n_rows, int probe, void* stream) {
  if (n <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  const RowArgs<Prog> a = row_args<Prog>(ptrs, lds, scalars, n, n_rows, 1.f, 0.f, 0.f);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (probe == rowtile::kProbeNoFma) return launch_rows_tiled<Prog, rowtile::kProbeNoFma>(a, st);
  if (probe == rowtile::kProbeNoStaging)
    return launch_rows_tiled<Prog, rowtile::kProbeNoStaging>(a, st);
  if (probe == rowtile::kProbeNoReads)
    return launch_rows_tiled<Prog, rowtile::kProbeNoReads>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace gf

// The generated source's entry points, one set per template structure.
#define GF_DEFINE_LAUNCH(PROG)                                                              \
  extern "C" int generic_fused_step_launch(const uint64_t* ptrs, const double* scalars,     \
                                           int n, int w_bf16, int vec, float dt,           \
                                           float thresh, float reset_val, void* stream) {   \
    return gf::launch<PROG>(ptrs, scalars, n, w_bf16, vec, dt, thresh, reset_val, stream);  \
  }                                                                                         \
  extern "C" int generic_fused_rows_launch(const uint64_t* ptrs, const long long* lds,      \
                                           const double* scalars, int n, int n_rows,        \
                                           int w_bf16, int route, float dt, float thresh,   \
                                           float reset_val, void* stream) {                 \
    return gf::launch_rows<PROG>(ptrs, lds, scalars, n, n_rows, w_bf16, route, dt, thresh,  \
                                 reset_val, stream);                                        \
  }                                                                                         \
  extern "C" int generic_fused_rows_tiled_probe_launch(                                     \
      const uint64_t* ptrs, const long long* lds, const double* scalars, int n, int n_rows, \
      int probe, void* stream) {                                                            \
    return gf::launch_rows_tiled_probe<PROG>(ptrs, lds, scalars, n, n_rows, probe, stream); \
  }
