// Native host-data engine of the PyTorch port, a copy of
// rcgan_tpu/native/data_engine.cpp (the same code, so the same streams).
//
// The reference's input pipeline is pure-Python NumPy: O(dataset) label
// corruption loops (mnist/model.py:821-832, cifar10/common/data/cifar10.py:
// 35-38).  Here label corruption (one xoshiro256** stream per call, seeded
// by SplitMix64) and epoch shuffling are native, exposed through a C ABI
// consumed via ctypes (rcgan_tpu_torch/native/__init__.py).
//
// Build: g++ -O3 -march=native -shared -fPIC -o <lib> data_engine.cpp, done
// at first use by the Python wrapper into rcgan_tpu_torch/_build/, the
// library's name keyed by a digest of this file.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// SplitMix64 → xoshiro256** seeding; fast, reproducible, good enough for
// data augmentation (NOT for crypto).
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    uint64_t z = seed;
    for (int i = 0; i < 4; ++i) {
      z += 0x9e3779b97f4a7c15ULL;
      uint64_t t = z;
      t = (t ^ (t >> 30)) * 0xbf58476d1ce4e5b9ULL;
      t = (t ^ (t >> 27)) * 0x94d049bb133111ebULL;
      s[i] = t ^ (t >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }
  inline uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  inline double uniform() {  // [0, 1)
    return (next() >> 11) * 0x1.0p-53;
  }
  inline uint64_t below(uint64_t n) {  // unbiased [0, n)
    uint64_t mask = ~0ULL;
    // rejection sampling on the low bits
    uint64_t lim = n * ((mask / n));
    uint64_t v;
    do {
      v = next();
    } while (v >= lim);
    return v % n;
  }
};

}  // namespace

extern "C" {

// Sample out[i] ~ Categorical(C[labels[i], :]) via row CDF walk.
// labels: n int32 in [0, k); c: k*k row-stochastic float64.
void corrupt_labels(uint64_t seed, int64_t n, int32_t k,
                    const int32_t* labels, const double* c, int32_t* out) {
  Rng rng(seed);
  for (int64_t i = 0; i < n; ++i) {
    const double* row = c + static_cast<int64_t>(labels[i]) * k;
    double u = rng.uniform();
    double acc = 0.0;
    int32_t j = 0;
    for (; j < k - 1; ++j) {
      acc += row[j];
      if (u < acc) break;
    }
    out[i] = j;
  }
}

// The full per-example label tuple of SURVEY §0 in one pass:
//   y_real ~ C[y], y_gen uniform (or = y_real when real_match),
//   y_fake ~ C[y_gen], weights = C_inv[y_real].
void make_label_tuple(uint64_t seed, int64_t n, int32_t k, int32_t real_match,
                      const int32_t* y_actual, const double* c,
                      const double* c_inv, int32_t* y_real, int32_t* y_gen,
                      int32_t* y_fake, float* weights) {
  Rng rng(seed);
  for (int64_t i = 0; i < n; ++i) {
    const double* row = c + static_cast<int64_t>(y_actual[i]) * k;
    double u = rng.uniform();
    double acc = 0.0;
    int32_t j = 0;
    for (; j < k - 1; ++j) {
      acc += row[j];
      if (u < acc) break;
    }
    y_real[i] = j;

    int32_t g = real_match ? j : static_cast<int32_t>(rng.below(k));
    y_gen[i] = g;

    const double* grow = c + static_cast<int64_t>(g) * k;
    u = rng.uniform();
    acc = 0.0;
    int32_t f = 0;
    for (; f < k - 1; ++f) {
      acc += grow[f];
      if (u < acc) break;
    }
    y_fake[i] = f;

    const double* wrow = c_inv + static_cast<int64_t>(j) * k;
    float* wout = weights + i * k;
    for (int32_t t = 0; t < k; ++t) wout[t] = static_cast<float>(wrow[t]);
  }
}

// Fisher–Yates permutation of [0, n) — the epoch shuffle.
void shuffle_indices(uint64_t seed, int64_t n, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  Rng rng(seed);
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = static_cast<int64_t>(rng.below(static_cast<uint64_t>(i + 1)));
    int64_t t = out[i];
    out[i] = out[j];
    out[j] = t;
  }
}

// Gather rows into a contiguous batch buffer: out[b] = src[idx[b]].
// row_bytes covers arbitrary dtypes; this is the hot per-iteration copy.
void gather_rows(const uint8_t* src, const int64_t* idx, int64_t n_idx,
                 int64_t row_bytes, uint8_t* out) {
  for (int64_t b = 0; b < n_idx; ++b) {
    std::memcpy(out + b * row_bytes, src + idx[b] * row_bytes,
                static_cast<size_t>(row_bytes));
  }
}

// Gather int32 labels (avoids memcpy-per-4-bytes overhead).
void gather_i32(const int32_t* src, const int64_t* idx, int64_t n_idx,
                int32_t* out) {
  for (int64_t b = 0; b < n_idx; ++b) out[b] = src[idx[b]];
}

int32_t abi_version() { return 1; }

}  // extern "C"
