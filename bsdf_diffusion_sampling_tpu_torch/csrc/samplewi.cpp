// Native inverse-CDF sampler over flattened 2-D pdf grids: the host twin
// of `data/tabulated.py`, loaded through ctypes by `native/samplewilib.py`.
//
// Given B flattened res x res pdf grids, draw n samples from each by CDF
// inversion with in-cell jitter, returning coordinates in [-1,1]^2 (the
// disk parameterization; callers rescale to their angular domains). It
// stands in for the `samplewi` module the reference implementation imports
// but does not ship.
//
// From the `#include` lines on, this file is the JAX package's
// `native/samplewi.cpp` byte for byte, so both draw the same samples for
// the same seed.

#include <cstdint>
#include <cmath>
#include <vector>

namespace {

// xorshift128+ — deterministic, seedable, fast enough for host datasets.
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    s0 = seed ^ 0x9E3779B97F4A7C15ULL;
    s1 = (seed << 21) | 0x2545F4914F6CDD1DULL;
    for (int i = 0; i < 8; i++) next();
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
};

}  // namespace

extern "C" int samplewi(const float* pdf, int64_t batch, int res,
                        int64_t n_samples, uint64_t seed, float* out) {
  if (res <= 0 || batch <= 0 || n_samples <= 0) return -1;
  const int64_t g = static_cast<int64_t>(res) * res;
  std::vector<double> cdf(g);
  for (int64_t b = 0; b < batch; b++) {
    const float* row = pdf + b * g;
    double acc = 0.0;
    for (int64_t i = 0; i < g; i++) {
      double v = row[i] > 0.0f ? row[i] : 0.0;
      acc += v;
      cdf[i] = acc;
    }
    if (acc <= 0.0) return -2;  // all-zero pdf row
    const double inv = 1.0 / acc;
    for (int64_t i = 0; i < g; i++) cdf[i] *= inv;

    Rng rng(seed + static_cast<uint64_t>(b) * 0x9E3779B97F4A7C15ULL);
    float* dst = out + b * n_samples * 2;
    for (int64_t s = 0; s < n_samples; s++) {
      const double u = rng.uniform();
      // binary search: first index with cdf[idx] >= u
      int64_t lo = 0, hi = g - 1;
      while (lo < hi) {
        const int64_t mid = (lo + hi) / 2;
        if (cdf[mid] < u)
          lo = mid + 1;
        else
          hi = mid;
      }
      const int64_t ix = lo / res, iy = lo % res;
      const double jx = rng.uniform(), jy = rng.uniform();
      dst[2 * s + 0] = static_cast<float>((ix + jx) / res * 2.0 - 1.0);
      dst[2 * s + 1] = static_cast<float>((iy + jy) / res * 2.0 - 1.0);
    }
  }
  return 0;
}
