// Fused STDP weight update (the pair rule with hard or soft bounds, or the
// reward-modulated rule), for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the update to XLA, which
// fuses the pair rule into one read-modify-write pass over W
// (rectipy_tpu/network.py:4085-4089, rectipy_tpu/edges.py:1262-1264).
// Eager PyTorch cannot fuse it: its plain version (ops/stdp.py) makes about
// ten full passes over the plastic tensor a step.  For each stored synapse
// (i post, j pre), with the traces already decayed and every constant
// rounded to the weights' type by the caller:
//
//   pot = a_plus * (spk_post[i] * x_pre[j])       dense (n_out, n_in)
//   dep = a_minus * (x_post[i] * spk_pre[j])
//   pot = (a_plus * spk_post[i]) * x_pre[j]        blocks (n_br, cb, bs, bs):
//   dep = (a_minus * x_post[i]) * spk_pre[j]       i = r*bs + row, j = cols[r, c]*bs + col
//
//   hard:   W' = clip((W + pot) - dep)
//   soft:   W' = clip((W + pot*(w_max - W)) - dep*(W - w_min))
//   reward: E' = E*d_e + (pot - dep);  W' = clip(W + r*E')
//
// clip(w) = min(max(w, w_min), w_max), NaN passed through.  Each operation
// is written with a round-to-nearest intrinsic in the plain version's order
// (rectipy_tpu/edges.py:945-998, the order the port's plain version keeps),
// so nvcc contracts nothing into an FMA; a bfloat16 value is rounded to
// bfloat16 after every operation, as eager PyTorch rounds each operation's
// result.  So the kernel equals its plain version bit for bit.  The reward
// r is read on the device from a 0-dim tensor: nothing synchronises.
//
// Bound.  Each step reads W (and E) and writes W' (and E'), once each, plus
// four O(N) vectors: at N = 10,000 dense float32, 800 MB, so at least
// 0.24 ms at the data-sheet 3.35 TB/s; the N = 100,352 network's 196 x 4 x
// 512^2 float32 blocks, 1.64 GB, at least 0.49 ms.  About 8 operations per
// synapse, far under any peak.  These are derived figures, not measurements.
//
// Design against that bound: the plastic tensor is a sequence of rows
// (a dense row i, or a block row (r, c, row) of bs entries), one thread
// block per row in a grid-stride loop over rows, one thread per entry of
// the row: consecutive threads read consecutive addresses of W, and the
// row's post-synaptic values and pre-synaptic base are loaded once per
// row.  The O(N) pre-synaptic vectors are re-read for every row from L1/L2.
// Simple first; widening the loads is later work.
//
// Interface: a plain C function, loaded with ctypes; it launches on the
// caller's stream, never synchronises, and returns cudaGetLastError().  W'
// and E' are buffers of their own (the wrapper allocates them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
enum Mode { kHard = 0, kSoft = 1, kReward = 2 };

// T: the storage type; V: the type a value is held in between operations
// (float for float32 and bfloat16, double for float64).
template <typename T>
struct Arith;

template <>
struct Arith<float> {
  using V = float;
  static __device__ __forceinline__ V load(const float* p, int64_t i) { return p[i]; }
  static __device__ __forceinline__ V ldg(const float* p, int64_t i) { return __ldg(p + i); }
  static __device__ __forceinline__ void store(float* p, int64_t i, V v) { p[i] = v; }
  static __device__ __forceinline__ V mul(V a, V b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ V add(V a, V b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ V sub(V a, V b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ V clip(V w, V lo, V hi) {
    return w != w ? w : fminf(fmaxf(w, lo), hi);
  }
};

template <>
struct Arith<double> {
  using V = double;
  static __device__ __forceinline__ V load(const double* p, int64_t i) { return p[i]; }
  static __device__ __forceinline__ V ldg(const double* p, int64_t i) { return __ldg(p + i); }
  static __device__ __forceinline__ void store(double* p, int64_t i, V v) { p[i] = v; }
  static __device__ __forceinline__ V mul(V a, V b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ V add(V a, V b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ V sub(V a, V b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ V clip(V w, V lo, V hi) {
    return w != w ? w : fmin(fmax(w, lo), hi);
  }
};

template <>
struct Arith<__nv_bfloat16> {
  using V = float;  // every V here holds a bfloat16 value exactly
  static __device__ __forceinline__ V round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ V load(const __nv_bfloat16* p, int64_t i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ V ldg(const __nv_bfloat16* p, int64_t i) {
    return __bfloat162float(__ldg(p + i));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, V v) {
    p[i] = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ V mul(V a, V b) { return round(__fmul_rn(a, b)); }
  static __device__ __forceinline__ V add(V a, V b) { return round(__fadd_rn(a, b)); }
  static __device__ __forceinline__ V sub(V a, V b) { return round(__fsub_rn(a, b)); }
  static __device__ __forceinline__ V clip(V w, V lo, V hi) {
    return w != w ? w : fminf(fmaxf(w, lo), hi);
  }
};

template <typename V>
struct Consts {
  V a_plus, a_minus, w_min, w_max, d_e;
};

// n_rows rows of row_len entries; blocks: row = (r*cb + c)*bs + row-in-block
// and row_len = bs; dense: row = i and row_len = n_in.
template <typename T, int kMode, bool kBlocks>
__global__ void __launch_bounds__(kThreads)
stdp_update_kernel(const T* __restrict__ W, T* __restrict__ W_out, const T* __restrict__ E,
                   T* __restrict__ E_out, const T* __restrict__ x_pre,
                   const T* __restrict__ x_post, const T* __restrict__ spk_pre,
                   const T* __restrict__ spk_post, const int64_t* __restrict__ cols,
                   const T* __restrict__ reward, int64_t n_rows, int row_len, int cb, int bs,
                   Consts<typename Arith<T>::V> k) {
  using A = Arith<T>;
  using V = typename A::V;
  V r = V(0);
  if constexpr (kMode == kReward) r = A::ldg(reward, 0);
  for (int64_t row = blockIdx.x; row < n_rows; row += gridDim.x) {
    int64_t post = row, pre0 = 0;
    if constexpr (kBlocks) {
      const int64_t rc = row / bs;  // (r, c) of the block
      post = (rc / cb) * bs + (row - rc * bs);
      pre0 = __ldg(cols + rc) * bs;
    }
    const V sp = A::ldg(spk_post, post), xq = A::ldg(x_post, post);
    V a_sp = V(0), a_xq = V(0);
    if constexpr (kBlocks) {
      a_sp = A::mul(k.a_plus, sp);
      a_xq = A::mul(k.a_minus, xq);
    }
    const int64_t base = row * row_len;
    for (int j = threadIdx.x; j < row_len; j += kThreads) {
      const V xp = A::ldg(x_pre, pre0 + j), s = A::ldg(spk_pre, pre0 + j);
      V pot, dep;
      if constexpr (kBlocks) {
        pot = A::mul(a_sp, xp);
        dep = A::mul(a_xq, s);
      } else {
        pot = A::mul(k.a_plus, A::mul(sp, xp));
        dep = A::mul(k.a_minus, A::mul(xq, s));
      }
      V w = A::load(W, base + j);
      if constexpr (kMode == kHard) {
        w = A::sub(A::add(w, pot), dep);
      } else if constexpr (kMode == kSoft) {
        w = A::sub(A::add(w, A::mul(pot, A::sub(k.w_max, w))),
                   A::mul(dep, A::sub(w, k.w_min)));
      } else {
        const V e = A::add(A::mul(A::load(E, base + j), k.d_e), A::sub(pot, dep));
        A::store(E_out, base + j, e);
        w = A::add(w, A::mul(r, e));
      }
      A::store(W_out, base + j, A::clip(w, k.w_min, k.w_max));
    }
  }
}

template <typename T, int kMode>
cudaError_t launch(const void* W, void* W_out, const void* E, void* E_out, const void* x_pre,
                   const void* x_post, const void* spk_pre, const void* spk_post,
                   const void* cols, const void* reward, int64_t n_rows, int row_len, int cb,
                   int bs, Consts<typename Arith<T>::V> k, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = static_cast<int64_t>(sms > 0 ? sms : 1) * kBlocksPerSm;
  const unsigned grid = static_cast<unsigned>(n_rows < want ? n_rows : want);
  const auto* w = static_cast<const T*>(W);
  auto* wo = static_cast<T*>(W_out);
  const auto* e = static_cast<const T*>(E);
  auto* eo = static_cast<T*>(E_out);
  const auto* xp = static_cast<const T*>(x_pre);
  const auto* xq = static_cast<const T*>(x_post);
  const auto* sp = static_cast<const T*>(spk_pre);
  const auto* sq = static_cast<const T*>(spk_post);
  const auto* c = static_cast<const int64_t*>(cols);
  const auto* r = static_cast<const T*>(reward);
  if (cols != nullptr)
    stdp_update_kernel<T, kMode, true><<<grid, kThreads, 0, st>>>(
        w, wo, e, eo, xp, xq, sp, sq, c, r, n_rows, row_len, cb, bs, k);
  else
    stdp_update_kernel<T, kMode, false><<<grid, kThreads, 0, st>>>(
        w, wo, e, eo, xp, xq, sp, sq, c, r, n_rows, row_len, cb, bs, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_mode(int mode, const void* W, void* W_out, const void* E, void* E_out,
                          const void* x_pre, const void* x_post, const void* spk_pre,
                          const void* spk_post, const void* cols, const void* reward,
                          int64_t n_rows, int row_len, int cb, int bs,
                          Consts<typename Arith<T>::V> k, cudaStream_t st) {
  switch (mode) {
    case kHard:
      return launch<T, kHard>(W, W_out, E, E_out, x_pre, x_post, spk_pre, spk_post, cols,
                              reward, n_rows, row_len, cb, bs, k, st);
    case kSoft:
      return launch<T, kSoft>(W, W_out, E, E_out, x_pre, x_post, spk_pre, spk_post, cols,
                              reward, n_rows, row_len, cb, bs, k, st);
    case kReward:
      return launch<T, kReward>(W, W_out, E, E_out, x_pre, x_post, spk_pre, spk_post, cols,
                                reward, n_rows, row_len, cb, bs, k, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 float64, 2 bfloat16; mode: 0 hard, 1 soft, 2 reward.
// W, W_out (and, for reward, E, E_out): n_rows * row_len entries; x_pre,
// spk_pre: the n_in pre-synaptic values; x_post, spk_post: the n_out
// post-synaptic ones; cols: NULL for the dense layout (row_len = n_in), else
// the (n_br, cb) int64 block-column table (row_len = bs, n_rows = n_br * cb
// * bs); reward: a 0-dim value of the weights' type, read on the device.
// The constants are values of the weights' type (the caller rounds them).
extern "C" int stdp_update_launch(int dtype, int mode, const void* W, void* W_out,
                                  const void* E, void* E_out, const void* x_pre,
                                  const void* x_post, const void* spk_pre, const void* spk_post,
                                  const void* cols, const void* reward, long long n_rows,
                                  int row_len, int cb, int bs, double a_plus, double a_minus,
                                  double w_min, double w_max, double d_e, void* stream) {
  if (n_rows <= 0 || row_len <= 0) return static_cast<int>(cudaSuccess);
  if (mode == kReward && (E == nullptr || E_out == nullptr || reward == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cols != nullptr && (cb <= 0 || bs != row_len)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    const Consts<double> k{a_plus, a_minus, w_min, w_max, d_e};
    err = dispatch_mode<double>(mode, W, W_out, E, E_out, x_pre, x_post, spk_pre, spk_post, cols,
                                reward, n_rows, row_len, cb, bs, k, st);
  } else {
    const Consts<float> k{static_cast<float>(a_plus), static_cast<float>(a_minus),
                          static_cast<float>(w_min), static_cast<float>(w_max),
                          static_cast<float>(d_e)};
    if (dtype == 0)
      err = dispatch_mode<float>(mode, W, W_out, E, E_out, x_pre, x_post, spk_pre, spk_post,
                                 cols, reward, n_rows, row_len, cb, bs, k, st);
    else if (dtype == 2)
      err = dispatch_mode<__nv_bfloat16>(mode, W, W_out, E, E_out, x_pre, x_post, spk_pre,
                                         spk_post, cols, reward, n_rows, row_len, cb, bs, k, st);
    else
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
