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
// 0.239 ms at the data-sheet 3.35 TB/s (bfloat16 0.119, reward 0.478); the
// N = 100,352 network's 196 x 4 x 512^2 float32 blocks, 1.64 GB, at least
// 0.491 ms.  About 8 operations per synapse, far under the float32 peak;
// a bfloat16 entry rounds after each of them, so its instruction count,
// not its bytes, may bind (see route "tile" below).
//
// Two routes of one arithmetic (synapse() below), so both equal the plain
// version bit for bit.  Times below: chip_smoke.py's stdp timings on an
// H100 80GB HBM3 at 700 W, at the paths' shapes, in turns in one call.
//
// Route "row" (the first design): the plastic tensor is a sequence of rows
// (a dense row i, or a block row (r, c, row) of bs entries), one thread
// block per row in a grid-stride loop over rows, one thread per entry of
// the row, one scalar load of W each.  An SM then holds at most 2,048
// threads x 4 bytes, about 8 KB of W in flight (4 KB at bfloat16), where
// keeping 3.35 TB/s busy at a few hundred ns of latency needs about 2 MB
// across the 132 SMs, 15 KB each.  So it stops at 62% of the bound on
// dense float32, 64% in reward mode (E's loads double what is in flight),
// 37% at bfloat16 (half the bytes in flight) and 40% on blocks of 512,
// where each block row of 512 entries also pays two 64-bit divisions, the
// dependent cols load and the post-synaptic loads before its first load of
// W.  It stays for shapes the tile route does not take (a row not a whole
// number of 16-byte pieces, or an address not 16-byte aligned).
//
// Route "tile": a thread block takes a tile of tile_rows rows x a strip of
// lanes x kV columns of one segment (the dense matrix, or one (r, c)
// block), kV = 16 bytes of values (float32 4, bfloat16 8, float64 2).
// Each thread loads its kV pre-synaptic traces and spikes once, with 16-byte
// loads, and keeps them in registers for all its rows; the tile's
// post-synaptic values (for blocks already multiplied by a_+ and a_-) are
// staged once in shared memory; cols[r, c] is read once a thread block, so
// no row pays a division or a dependent load.  A thread walks its rows
// kTileUnroll at a time, issuing those rows' 16-byte loads of W (and E)
// before it uses any of them, and stores W' (E') with 16-byte stores;
// loads and stores of W and E are streaming (evict-first): each is touched
// once.  A row shorter than kTileThreads pieces (blocks of 512 float32:
// 128 lanes) leaves kTileThreads / lanes row groups in the thread block,
// which walk alternate rows.  __launch_bounds__ keeps kTileMinBlocks
// thread blocks an SM (the launch checks that they fit), so an SM keeps
// at least 3 x 256 threads x 4 rows x 16 bytes = 48 KB of W in flight
// (96 KB with E), three times what the bound needs.  The wrapper (ops/stdp.py) computes
// the plan (lanes, strips, tile_rows, the grid) and this file checks it.
// It reaches about 89% of the bound on dense float32 and in reward mode,
// 90% on the blocks.  At bfloat16 the arithmetic binds before the bytes:
// ten roundings an entry on the soft rule, which as single conversions
// (F2F, a slow pipe) kept a first version of this route below half the
// bound; Two<> rounds two entries with one packed conversion, 35 SASS
// instructions an entry in all, and the tile reaches about 78%.  The next step, for the
// float types, would be a ring of W rows through shared memory fed by
// cp.async or TMA bulk copies, one producer warp ahead of the arithmetic;
// at about 90% it is not worth its code here.
//
// Interface: a plain C function, loaded with ctypes; it launches on the
// caller's stream, never synchronises, and returns cudaGetLastError().  W'
// and E' are buffers of their own (the wrapper allocates them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// route "row"
constexpr int kThreads = 256;
// route "tile" (ops/stdp.py's TILE_* constants mirror these)
constexpr int kTileThreads = 256;
constexpr int kTileMinBlocks = 3;  // resident thread blocks an SM: at most 85 registers
constexpr int kTileUnroll = 4;     // rows whose loads a thread issues before using them
constexpr int kTileMaxRows = 512;  // rows of a tile (its staged post-synaptic values)
enum Mode { kHard = 0, kSoft = 1, kReward = 2 };
enum Route { kRow = 0, kTile = 1 };

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

// Two entries at once, the tile route's arithmetic: each operation is
// Arith<T>'s on both lanes.  The bfloat16 instance rounds both results with
// one packed conversion (F2FP), the same round to nearest even as two
// single ones (F2F) in half the conversions.
template <typename T>
struct Two {
  using S = Arith<T>;
  struct V {
    typename S::V a, b;
  };
  static __device__ __forceinline__ V mul(V x, V y) { return {S::mul(x.a, y.a), S::mul(x.b, y.b)}; }
  static __device__ __forceinline__ V add(V x, V y) { return {S::add(x.a, y.a), S::add(x.b, y.b)}; }
  static __device__ __forceinline__ V sub(V x, V y) { return {S::sub(x.a, y.a), S::sub(x.b, y.b)}; }
  static __device__ __forceinline__ V clip(V w, V lo, V hi) {
    return {S::clip(w.a, lo.a, hi.a), S::clip(w.b, lo.b, hi.b)};
  }
};

template <>
struct Two<__nv_bfloat16> {
  using S = Arith<__nv_bfloat16>;
  struct V {
    float a, b;
  };
  static __device__ __forceinline__ V round(float x, float y) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const unsigned u = *reinterpret_cast<const unsigned*>(&h);
    return {__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u)};
  }
  static __device__ __forceinline__ V mul(V x, V y) {
    return round(__fmul_rn(x.a, y.a), __fmul_rn(x.b, y.b));
  }
  static __device__ __forceinline__ V add(V x, V y) {
    return round(__fadd_rn(x.a, y.a), __fadd_rn(x.b, y.b));
  }
  static __device__ __forceinline__ V sub(V x, V y) {
    return round(__fsub_rn(x.a, y.a), __fsub_rn(x.b, y.b));
  }
  static __device__ __forceinline__ V clip(V w, V lo, V hi) {
    return {S::clip(w.a, lo.a, hi.a), S::clip(w.b, lo.b, hi.b)};
  }
};

// 16-byte pieces: kN values of T to and from Arith<T>::V.  ld: through the
// read-only cache (the pre-synaptic vectors, read by many thread blocks);
// ld_stream / st_stream: evict-first (W and E, touched once).
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(float4 r, float (&v)[4]) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  static __device__ __forceinline__ void ld(const float* p, float (&v)[4]) {
    unpack(__ldg(reinterpret_cast<const float4*>(p)), v);
  }
  static __device__ __forceinline__ void ld_stream(const float* p, float (&v)[4]) {
    unpack(__ldcs(reinterpret_cast<const float4*>(p)), v);
  }
  static __device__ __forceinline__ void st_stream(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Pack<double> {
  static constexpr int kN = 2;
  static __device__ __forceinline__ void ld(const double* p, double (&v)[2]) {
    const double2 r = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = r.x;
    v[1] = r.y;
  }
  static __device__ __forceinline__ void ld_stream(const double* p, double (&v)[2]) {
    const double2 r = __ldcs(reinterpret_cast<const double2*>(p));
    v[0] = r.x;
    v[1] = r.y;
  }
  static __device__ __forceinline__ void st_stream(double* p, const double (&v)[2]) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  // a bfloat16 widens exactly by its 16 bits on top of a float's
  static __device__ __forceinline__ void halves(unsigned u, float& lo, float& hi) {
    lo = __uint_as_float(u << 16);
    hi = __uint_as_float(u & 0xffff0000u);
  }
  // lo, hi hold bfloat16 values exactly (every stored value is a rounded
  // result or a bound): their upper halves are the bfloat16s
  static __device__ __forceinline__ unsigned two(float lo, float hi) {
    return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
  }
  static __device__ __forceinline__ void unpack(uint4 r, float (&v)[8]) {
    halves(r.x, v[0], v[1]);
    halves(r.y, v[2], v[3]);
    halves(r.z, v[4], v[5]);
    halves(r.w, v[6], v[7]);
  }
  static __device__ __forceinline__ void ld(const __nv_bfloat16* p, float (&v)[8]) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
  static __device__ __forceinline__ void ld_stream(const __nv_bfloat16* p, float (&v)[8]) {
    unpack(__ldcs(reinterpret_cast<const uint4*>(p)), v);
  }
  static __device__ __forceinline__ void st_stream(__nv_bfloat16* p, const float (&v)[8]) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(two(v[0], v[1]), two(v[2], v[3]), two(v[4], v[5]), two(v[6], v[7])));
  }
};

template <typename V>
struct Consts {
  V a_plus, a_minus, w_min, w_max, d_e;
};

// One synapse: W' (and, in reward mode, E' in e) from W = w, the row's
// post-synaptic pair (pa, pb) and the column's pre-synaptic trace and
// spike (xp, s).  Dense: pa = spk_post[i], pb = x_post[i]; blocks: pa =
// a_plus*spk_post[i], pb = a_minus*x_post[i] (each layout's order above).
// A: Arith<T> (one entry) or Two<T> (two).
template <typename A, int kMode, bool kBlocks, typename V = typename A::V>
__device__ __forceinline__ V synapse(V w, V& e, V pa, V pb, V xp, V s, V r, const Consts<V>& k) {
  V pot, dep;
  if constexpr (kBlocks) {
    pot = A::mul(pa, xp);
    dep = A::mul(pb, s);
  } else {
    pot = A::mul(k.a_plus, A::mul(pa, xp));
    dep = A::mul(k.a_minus, A::mul(pb, s));
  }
  if constexpr (kMode == kHard) {
    w = A::sub(A::add(w, pot), dep);
  } else if constexpr (kMode == kSoft) {
    w = A::sub(A::add(w, A::mul(pot, A::sub(k.w_max, w))), A::mul(dep, A::sub(w, k.w_min)));
  } else {
    e = A::add(A::mul(e, k.d_e), A::sub(pot, dep));
    w = A::add(w, A::mul(r, e));
  }
  return A::clip(w, k.w_min, k.w_max);
}

// Route "row": n_rows rows of row_len entries; blocks: row = (r*cb + c)*bs
// + row-in-block and row_len = bs; dense: row = i and row_len = n_in.
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
    V pa = A::ldg(spk_post, post), pb = A::ldg(x_post, post);
    if constexpr (kBlocks) {
      pa = A::mul(k.a_plus, pa);
      pb = A::mul(k.a_minus, pb);
    }
    const int64_t base = row * row_len;
    for (int j = threadIdx.x; j < row_len; j += kThreads) {
      V e = V(0);
      if constexpr (kMode == kReward) e = A::load(E, base + j);
      const V w = synapse<A, kMode, kBlocks>(A::load(W, base + j), e, pa, pb,
                                             A::ldg(x_pre, pre0 + j), A::ldg(spk_pre, pre0 + j),
                                             r, k);
      if constexpr (kMode == kReward) A::store(E_out, base + j, e);
      A::store(W_out, base + j, w);
    }
  }
}

// Route "tile": thread block b takes strip b % strips of tile (b / strips)
// % row_tiles of segment b / (strips * row_tiles); a segment is seg_rows
// rows of row_len entries (dense: the one (n_out, n_in) matrix; blocks:
// block r*cb + c, seg_rows = row_len = bs).  Thread t is lane t % lanes of
// row group t / lanes: columns [(strip*lanes + lane)*kV, +kV) of the
// tile's rows group, group + groups, ...  (groups = kTileThreads / lanes).
template <typename T, int kMode, bool kBlocks>
__global__ void __launch_bounds__(kTileThreads, kTileMinBlocks)
stdp_update_tile_kernel(const T* __restrict__ W, T* __restrict__ W_out, const T* __restrict__ E,
                        T* __restrict__ E_out, const T* __restrict__ x_pre,
                        const T* __restrict__ x_post, const T* __restrict__ spk_pre,
                        const T* __restrict__ spk_post, const int64_t* __restrict__ cols,
                        const T* __restrict__ reward, int seg_rows, int row_len, int cb,
                        int lanes, int strips, int tile_rows, int row_tiles,
                        Consts<typename Arith<T>::V> k) {
  using A = Arith<T>;
  using V = typename A::V;
  using P = Pack<T>;
  constexpr int kV = P::kN;
  __shared__ V post_a[kTileMaxRows], post_b[kTileMaxRows];
  const unsigned tile = blockIdx.x / strips;  // the launch keeps the grid below 2^31
  const int strip = static_cast<int>(blockIdx.x % strips);
  const int row0 = static_cast<int>(tile % row_tiles) * tile_rows;
  const int64_t seg = tile / row_tiles;
  const int rows = min(tile_rows, seg_rows - row0);
  int64_t post0 = row0, pre0 = 0;
  if constexpr (kBlocks) {
    post0 += (seg / cb) * seg_rows;
    pre0 = __ldg(cols + seg) * row_len;
  }
  for (int i = threadIdx.x; i < rows; i += kTileThreads) {
    V pa = A::ldg(spk_post, post0 + i), pb = A::ldg(x_post, post0 + i);
    if constexpr (kBlocks) {
      pa = A::mul(k.a_plus, pa);
      pb = A::mul(k.a_minus, pb);
    }
    post_a[i] = pa;
    post_b[i] = pb;
  }
  __syncthreads();
  const int groups = kTileThreads / lanes, group = threadIdx.x / lanes;
  const int col = (strip * lanes + threadIdx.x % lanes) * kV;
  if (group >= groups || col >= row_len) return;
  V xp[kV], s[kV];
  P::ld(x_pre + pre0 + col, xp);
  P::ld(spk_pre + pre0 + col, s);
  using A2 = Two<T>;
  using V2 = typename A2::V;
  V r = V(0);
  if constexpr (kMode == kReward) r = A::ldg(reward, 0);
  const Consts<V2> k2{{k.a_plus, k.a_plus}, {k.a_minus, k.a_minus}, {k.w_min, k.w_min},
                      {k.w_max, k.w_max}, {k.d_e, k.d_e}};
  const int64_t base = (seg * seg_rows + row0) * static_cast<int64_t>(row_len) + col;
  for (int i0 = group; i0 < rows; i0 += groups * kTileUnroll) {
    V w[kTileUnroll][kV], e[kTileUnroll][kV];
#pragma unroll
    for (int u = 0; u < kTileUnroll; ++u) {
      const int i = i0 + u * groups;
      if (i < rows) {
        P::ld_stream(W + base + static_cast<int64_t>(i) * row_len, w[u]);
        if constexpr (kMode == kReward)
          P::ld_stream(E + base + static_cast<int64_t>(i) * row_len, e[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kTileUnroll; ++u) {
      const int i = i0 + u * groups;
      if (i < rows) {
        const V2 pa{post_a[i], post_a[i]}, pb{post_b[i], post_b[i]};
#pragma unroll
        for (int j = 0; j < kV; j += 2) {
          V2 e2{};
          if constexpr (kMode == kReward) e2 = {e[u][j], e[u][j + 1]};
          const V2 w2 = synapse<A2, kMode, kBlocks>({w[u][j], w[u][j + 1]}, e2, pa, pb,
                                                    {xp[j], xp[j + 1]}, {s[j], s[j + 1]}, {r, r},
                                                    k2);
          w[u][j] = w2.a;
          w[u][j + 1] = w2.b;
          if constexpr (kMode == kReward) {
            e[u][j] = e2.a;
            e[u][j + 1] = e2.b;
          }
        }
        P::st_stream(W_out + base + static_cast<int64_t>(i) * row_len, w[u]);
        if constexpr (kMode == kReward)
          P::st_stream(E_out + base + static_cast<int64_t>(i) * row_len, e[u]);
      }
    }
  }
}

// The launch geometry, from the wrapper: grid thread blocks; route "tile"
// also lanes, strips and tile_rows (row_tiles and the segments follow).
struct Plan {
  int route;
  int64_t grid;
  int lanes, strips, tile_rows;
};

struct Args {
  const void *W, *E, *x_pre, *x_post, *spk_pre, *spk_post, *cols, *reward;
  void *W_out, *E_out;
  int64_t n_rows;
  int row_len, cb, bs;
};

template <typename T, int kMode, bool kBlocks>
cudaError_t launch_tile(const Args& a, const Plan& p, Consts<typename Arith<T>::V> k,
                        cudaStream_t st) {
  constexpr int kV = Pack<T>::kN;
  auto kernel = stdp_update_tile_kernel<T, kMode, kBlocks>;
  // the design's bytes in flight need kTileMinBlocks resident thread blocks
  static int per_sm = -1;
  if (per_sm < 0) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTileThreads, 0);
    if (err != cudaSuccess) return err;
  }
  if (per_sm < kTileMinBlocks) return cudaErrorLaunchOutOfResources;
  const int64_t seg_rows = kBlocks ? a.bs : a.n_rows, segments = a.n_rows / seg_rows;
  const int vecs = a.row_len / kV;
  const int64_t row_tiles = (seg_rows + p.tile_rows - 1) / p.tile_rows;
  const bool aligned = ((reinterpret_cast<uintptr_t>(a.W) | reinterpret_cast<uintptr_t>(a.W_out) |
                         reinterpret_cast<uintptr_t>(a.x_pre) |
                         reinterpret_cast<uintptr_t>(a.spk_pre) |
                         reinterpret_cast<uintptr_t>(a.E) | reinterpret_cast<uintptr_t>(a.E_out)) &
                        15) == 0;
  if (!aligned || a.row_len % kV != 0 || p.lanes < 1 || p.lanes > kTileThreads ||
      p.strips < 1 || static_cast<int64_t>(p.strips) * p.lanes < vecs ||
      static_cast<int64_t>(p.strips - 1) * p.lanes >= vecs || p.tile_rows < 1 ||
      p.tile_rows > kTileMaxRows || seg_rows > INT32_MAX ||
      p.grid != segments * row_tiles * p.strips || p.grid > INT32_MAX)
    return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(p.grid), kTileThreads, 0, st>>>(
      static_cast<const T*>(a.W), static_cast<T*>(a.W_out), static_cast<const T*>(a.E),
      static_cast<T*>(a.E_out), static_cast<const T*>(a.x_pre), static_cast<const T*>(a.x_post),
      static_cast<const T*>(a.spk_pre), static_cast<const T*>(a.spk_post),
      static_cast<const int64_t*>(a.cols), static_cast<const T*>(a.reward),
      static_cast<int>(seg_rows), a.row_len, a.cb, p.lanes, p.strips, p.tile_rows,
      static_cast<int>(row_tiles), k);
  return cudaGetLastError();
}

template <typename T, int kMode, bool kBlocks>
cudaError_t launch(const Args& a, const Plan& p, Consts<typename Arith<T>::V> k,
                   cudaStream_t st) {
  if (p.route == kTile) return launch_tile<T, kMode, kBlocks>(a, p, k, st);
  if (p.route != kRow || p.grid < 1 || p.grid > INT32_MAX) return cudaErrorInvalidValue;
  stdp_update_kernel<T, kMode, kBlocks><<<static_cast<unsigned>(p.grid), kThreads, 0, st>>>(
      static_cast<const T*>(a.W), static_cast<T*>(a.W_out), static_cast<const T*>(a.E),
      static_cast<T*>(a.E_out), static_cast<const T*>(a.x_pre), static_cast<const T*>(a.x_post),
      static_cast<const T*>(a.spk_pre), static_cast<const T*>(a.spk_post),
      static_cast<const int64_t*>(a.cols), static_cast<const T*>(a.reward), a.n_rows,
      a.row_len, a.cb, a.bs, k);
  return cudaGetLastError();
}

template <typename T, int kMode>
cudaError_t dispatch_layout(const Args& a, const Plan& p, Consts<typename Arith<T>::V> k,
                            cudaStream_t st) {
  return a.cols != nullptr ? launch<T, kMode, true>(a, p, k, st)
                           : launch<T, kMode, false>(a, p, k, st);
}

template <typename T>
cudaError_t dispatch_mode(int mode, const Args& a, const Plan& p,
                          Consts<typename Arith<T>::V> k, cudaStream_t st) {
  switch (mode) {
    case kHard:
      return dispatch_layout<T, kHard>(a, p, k, st);
    case kSoft:
      return dispatch_layout<T, kSoft>(a, p, k, st);
    case kReward:
      return dispatch_layout<T, kReward>(a, p, k, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 float64, 2 bfloat16; mode: 0 hard, 1 soft, 2 reward;
// route: 0 "row", 1 "tile".  W, W_out (and, for reward, E, E_out): n_rows *
// row_len entries; x_pre, spk_pre: the n_in pre-synaptic values; x_post,
// spk_post: the n_out post-synaptic ones; cols: NULL for the dense layout
// (row_len = n_in), else the (n_br, cb) int64 block-column table (row_len =
// bs, n_rows = n_br * cb * bs); reward: a 0-dim value of the weights' type,
// read on the device.  grid: the thread blocks; for route "tile" lanes,
// strips and tile_rows as ops/stdp.py's stdp_update_plan makes them (a plan
// or an address this file does not take returns cudaErrorInvalidValue).
// The constants are values of the weights' type (the caller rounds them).
extern "C" int stdp_update_launch(int dtype, int mode, int route, const void* W, void* W_out,
                                  const void* E, void* E_out, const void* x_pre,
                                  const void* x_post, const void* spk_pre, const void* spk_post,
                                  const void* cols, const void* reward, long long n_rows,
                                  int row_len, int cb, int bs, long long grid, int lanes,
                                  int strips, int tile_rows, double a_plus, double a_minus,
                                  double w_min, double w_max, double d_e, void* stream) {
  if (n_rows <= 0 || row_len <= 0) return static_cast<int>(cudaSuccess);
  if (mode == kReward && (E == nullptr || E_out == nullptr || reward == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cols != nullptr && (cb <= 0 || bs != row_len || n_rows % bs != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{W, E, x_pre, x_post, spk_pre, spk_post, cols, reward, W_out, E_out, n_rows,
               row_len, cb, bs};
  const Plan p{route, grid, lanes, strips, tile_rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    const Consts<double> k{a_plus, a_minus, w_min, w_max, d_e};
    err = dispatch_mode<double>(mode, a, p, k, st);
  } else {
    const Consts<float> k{static_cast<float>(a_plus), static_cast<float>(a_minus),
                          static_cast<float>(w_min), static_cast<float>(w_max),
                          static_cast<float>(d_e)};
    if (dtype == 0)
      err = dispatch_mode<float>(mode, a, p, k, st);
    else if (dtype == 2)
      err = dispatch_mode<__nv_bfloat16>(mode, a, p, k, st);
    else
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
