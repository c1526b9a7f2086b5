// Fused adam step + per-row int8 requantization of an int8_master coupling,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rectipy_tpu/ops/fused_opt.py::_kernel (built
// by _build_pallas, dispatched by adam_requant).  For each row i of the
// float32 master W with adam moments m, v and gradient g:
//
//   m'    = b1*m + (1-b1)*g
//   v'    = b2*v + (1-b2)*(g*g)
//   W'    = W - (lr*(m'/bc1)) / (sqrt(v'/bc2) + eps)      optax.adam
//   scale = max(max_j |W'[i, j]|, 1e-30) / 127            quantize_rows
//   wq    = clip(rint(W'/scale), -127, 127) as int8       round half to even
//
// Every operation is written with the round-to-nearest intrinsics in the
// plain version's order (ops/fused_opt.py::adam_leaf and quantize_rows), so
// nvcc contracts nothing into an FMA; the plain version's own kernels may
// round a division by a host scalar differently, and the check on the card
// states the tolerance that leaves.  bc1, bc2 and lr come from the wrapper,
// computed by the same helper the plain version uses.
//
// Bound.  The step reads W, m, v, g and writes W', m', v' (4 bytes each) and
// wq (1 byte): 29 bytes per weight, 2.9e9 bytes at N = 10,000, so at least
// 0.866 ms at the data-sheet 3.35 TB/s.  It does about 15 flops per weight,
// far under the float32 peak.  These are derived figures, not measurements.
//
// Design against that bound: one block per row, since the per-row maximum
// needs the whole row.  Pass 1 streams the row's W, m, v, g with 16-byte
// loads (streaming hint), writes m', v', W' and reduces |W'| to the row's
// maximum (warp shuffles, then shared memory).  Pass 2 re-reads the W' this
// same thread wrote -- a 10,000-column row is 40 KB, still in L2 -- and
// writes wq four bytes at a time.  When the row length is not a multiple of
// 4, or a pointer is not 16-byte aligned, a scalar instantiation runs.
//
// Interface: a plain C function, loaded with ctypes; it launches on the
// caller's stream, never synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct AdamParams {
  float b1, one_minus_b1, b2, one_minus_b2, bc1, bc2, lr, eps;
};

struct Upd {
  float w, m, v;
};

__device__ __forceinline__ Upd adam(float w, float m, float v, float g, const AdamParams& p) {
  Upd u;
  u.m = __fadd_rn(__fmul_rn(p.b1, m), __fmul_rn(p.one_minus_b1, g));
  u.v = __fadd_rn(__fmul_rn(p.b2, v), __fmul_rn(p.one_minus_b2, __fmul_rn(g, g)));
  const float mh = __fdiv_rn(u.m, p.bc1);
  const float vh = __fdiv_rn(u.v, p.bc2);
  u.w = __fsub_rn(w, __fdiv_rn(__fmul_rn(p.lr, mh), __fadd_rn(__fsqrt_rn(vh), p.eps)));
  return u;
}

__device__ __forceinline__ int8_t quant(float w, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(w, scale)), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
adam_requant_kernel(const float* __restrict__ W, const float* __restrict__ M,
                    const float* __restrict__ V, const float* __restrict__ G,
                    float* __restrict__ W_out, float* __restrict__ M_out,
                    float* __restrict__ V_out, int8_t* __restrict__ wq,
                    float* __restrict__ scale_out, int n_cols, AdamParams p) {
  __shared__ float warp_max[kWarps];
  __shared__ float row_scale;
  const size_t base = static_cast<size_t>(blockIdx.x) * n_cols;
  float amax = 0.f;
  if constexpr (kVec) {
    const int nv = n_cols / 4;
    const float4* w4 = reinterpret_cast<const float4*>(W + base);
    const float4* m4 = reinterpret_cast<const float4*>(M + base);
    const float4* v4 = reinterpret_cast<const float4*>(V + base);
    const float4* g4 = reinterpret_cast<const float4*>(G + base);
    float4* wo4 = reinterpret_cast<float4*>(W_out + base);
    float4* mo4 = reinterpret_cast<float4*>(M_out + base);
    float4* vo4 = reinterpret_cast<float4*>(V_out + base);
#pragma unroll 2
    for (int c = threadIdx.x; c < nv; c += kThreads) {
      const float4 w = __ldcs(w4 + c), m = __ldcs(m4 + c), v = __ldcs(v4 + c),
                   g = __ldcs(g4 + c);
      const Upd a = adam(w.x, m.x, v.x, g.x, p), b = adam(w.y, m.y, v.y, g.y, p),
                c2 = adam(w.z, m.z, v.z, g.z, p), d = adam(w.w, m.w, v.w, g.w, p);
      wo4[c] = make_float4(a.w, b.w, c2.w, d.w);
      __stcs(mo4 + c, make_float4(a.m, b.m, c2.m, d.m));
      __stcs(vo4 + c, make_float4(a.v, b.v, c2.v, d.v));
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(a.w), fabsf(b.w)), fmaxf(fabsf(c2.w), fabsf(d.w))));
    }
  } else {
    for (int c = threadIdx.x; c < n_cols; c += kThreads) {
      const Upd a = adam(W[base + c], M[base + c], V[base + c], G[base + c], p);
      W_out[base + c] = a.w;
      M_out[base + c] = a.m;
      V_out[base + c] = a.v;
      amax = fmaxf(amax, fabsf(a.w));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_down_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = warp_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) r = fmaxf(r, warp_max[w]);
    const float s = __fdiv_rn(fmaxf(r, 1e-30f), 127.f);
    row_scale = s;
    scale_out[blockIdx.x] = s;
  }
  __syncthreads();
  const float s = row_scale;
  // pass 2: each thread re-reads the W' it wrote itself (no other thread's
  // writes are read, so no further ordering is needed)
  if constexpr (kVec) {
    const int nv = n_cols / 4;
    const float4* wo4 = reinterpret_cast<const float4*>(W_out + base);
    char4* q4 = reinterpret_cast<char4*>(wq + base);
#pragma unroll 4
    for (int c = threadIdx.x; c < nv; c += kThreads) {
      const float4 w = wo4[c];
      q4[c] = make_char4(quant(w.x, s), quant(w.y, s), quant(w.z, s), quant(w.w, s));
    }
  } else {
    for (int c = threadIdx.x; c < n_cols; c += kThreads) wq[base + c] = quant(W_out[base + c], s);
  }
}

}  // namespace

// W, M, V, G: (n_rows, n_cols) f32 row-major inputs; W_out, M_out, V_out:
// (n_rows, n_cols) f32 outputs, distinct from the inputs; wq: (n_rows,
// n_cols) int8; scale: (n_rows,) f32.  vec = 1 selects the 16-byte path: the
// caller sets it only when n_cols % 4 == 0 and every pointer is 16-byte
// aligned.
extern "C" int adam_requant_launch(const void* W, const void* M, const void* V, const void* G,
                                   void* W_out, void* M_out, void* V_out, void* wq, void* scale,
                                   int n_rows, int n_cols, int vec, float b1, float one_minus_b1,
                                   float b2, float one_minus_b2, float bc1, float bc2, float lr,
                                   float eps, void* stream) {
  if (n_rows <= 0 || n_cols <= 0) return static_cast<int>(cudaSuccess);
  const AdamParams p{b1, one_minus_b1, b2, one_minus_b2, bc1, bc2, lr, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const float*>(W);
  const auto* m = static_cast<const float*>(M);
  const auto* v = static_cast<const float*>(V);
  const auto* g = static_cast<const float*>(G);
  auto* wo = static_cast<float*>(W_out);
  auto* mo = static_cast<float*>(M_out);
  auto* vo = static_cast<float*>(V_out);
  auto* q = static_cast<int8_t*>(wq);
  auto* sc = static_cast<float*>(scale);
  if (vec)
    adam_requant_kernel<true><<<n_rows, kThreads, 0, st>>>(w, m, v, g, wo, mo, vo, q, sc, n_cols, p);
  else
    adam_requant_kernel<false><<<n_rows, kThreads, 0, st>>>(w, m, v, g, wo, mo, vo, q, sc, n_cols, p);
  return static_cast<int>(cudaGetLastError());
}
