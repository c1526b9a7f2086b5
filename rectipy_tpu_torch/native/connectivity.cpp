// Native connectivity sampling for large populations: the port's own copy
// of rectipy_tpu/native/connectivity.cpp, the same code, so that the same
// seed gives the same connectivity in both packages, bit for bit.
//
// The pure-numpy fixed-fan-in sampler (utility.random_connectivity) sorts an
// (n, m) random matrix -- O(n m log m) host time and O(n m) memory, which at
// N=100k is ~1e10 key sorts and 40 GB of scratch.  This module samples each
// row's fan-in directly with Floyd's algorithm: O(n k) time, O(k) scratch.
//
// Exposed via ctypes (plain C ABI); deterministic given `seed` (splitmix64
// keyed per row).

#include <cstdint>
#include <cstring>

namespace {

// splitmix64: tiny, high-quality, seedable
inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

inline uint64_t bounded(uint64_t& state, uint64_t bound) {
  // Lemire's nearly-divisionless bounded sampling
  uint64_t x = splitmix64(state);
  __uint128_t mul = ( __uint128_t )x * ( __uint128_t )bound;
  return (uint64_t)(mul >> 64);
}

// open-addressing set sized to the row fan-in
struct SmallSet {
  int64_t* slots;
  int64_t capacity;

  void init(int64_t* storage, int64_t cap) {
    slots = storage;
    capacity = cap;
    memset(slots, 0xff, sizeof(int64_t) * cap);  // -1 sentinel
  }
  bool insert(int64_t v) {  // returns false if already present
    uint64_t h = (uint64_t)v * 0x9e3779b97f4a7c15ULL;
    int64_t idx = (int64_t)(h % (uint64_t)capacity);
    while (true) {
      if (slots[idx] == -1) {
        slots[idx] = v;
        return true;
      }
      if (slots[idx] == v) return false;
      idx = (idx + 1) % capacity;
    }
  }
};

}  // namespace

extern "C" {

// Sample `n_conns` distinct column indices in [0, m) for each of `n` rows
// (Floyd's algorithm).  cols_out must hold n * n_conns int64 entries.
// scratch must hold at least 4 * n_conns int64 entries (the per-row set).
// Returns 0 on success, nonzero on invalid arguments.
int sample_fixed_fanin(int64_t n, int64_t m, int64_t n_conns, uint64_t seed,
                       int64_t* cols_out, int64_t* scratch) {
  if (n <= 0 || m <= 0 || n_conns <= 0 || n_conns > m) return 1;
  int64_t cap = 4 * n_conns;
  SmallSet set;
  for (int64_t row = 0; row < n; ++row) {
    uint64_t state = seed ^ (0xdeadbeefcafef00dULL + (uint64_t)row * 0x100000001b3ULL);
    set.init(scratch, cap);
    int64_t* out = cols_out + row * n_conns;
    int64_t written = 0;
    for (int64_t j = m - n_conns; j < m; ++j) {
      int64_t t = (int64_t)bounded(state, (uint64_t)(j + 1));
      if (set.insert(t)) {
        out[written++] = t;
      } else {
        set.insert(j);
        out[written++] = j;
      }
    }
  }
  return 0;
}

// Block-sparse fixed-fan-in sampling (ops/sparse.py block_random_connectivity
// fast path).  For every neuron i of block-row r, sample `fan_in` distinct
// picks from the candidate pool [0, source_blocks*bs) with Floyd's algorithm
// and write weight `w` into the preallocated
// (nb_out, source_blocks, bs, bs) float32 block tensor at
// blocks[r, pick / bs, i, pick % bs].  The numpy construction (argsort of a
// (bs, cand) random matrix per block-row) costs minutes at N=1e6 on one
// host core; this is O(nb_out * bs * fan_in) writes at memory speed.
// scratch must hold 4 * fan_in int64 entries.  Deterministic per seed
// (splitmix64 keyed per neuron).  Returns 0 on success.
int sample_block_fanin(int64_t nb_out, int64_t source_blocks, int64_t bs,
                       int64_t fan_in, uint64_t seed, float w,
                       float* blocks, int64_t* scratch) {
  const int64_t cand = source_blocks * bs;
  if (nb_out <= 0 || source_blocks <= 0 || bs <= 0 || fan_in <= 0 ||
      fan_in > cand)
    return 1;
  const int64_t cap = 4 * fan_in;
  SmallSet set;
  for (int64_t r = 0; r < nb_out; ++r) {
    float* row_blocks = blocks + r * source_blocks * bs * bs;
    for (int64_t i = 0; i < bs; ++i) {
      uint64_t state =
          seed ^ (0xdeadbeefcafef00dULL +
                  (uint64_t)(r * bs + i) * 0x100000001b3ULL);
      set.init(scratch, cap);
      for (int64_t j = cand - fan_in; j < cand; ++j) {
        int64_t t = (int64_t)bounded(state, (uint64_t)(j + 1));
        int64_t pick;
        if (set.insert(t)) {
          pick = t;
        } else {
          set.insert(j);
          pick = j;
        }
        const int64_t c = pick / bs, col = pick % bs;
        row_blocks[(c * bs + i) * bs + col] = w;
      }
    }
  }
  return 0;
}

}  // extern "C"
