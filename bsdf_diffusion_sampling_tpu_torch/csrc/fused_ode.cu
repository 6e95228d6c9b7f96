// Fused disk-domain sample+pdf (K1) and pdf-query (K2) kernels for Hopper.
//
// K1 replaces the JAX package's `ops/fused_ode.py::_fused_sample_pdf_kernel`
// (pallas_call at :684); K2 replaces `_fused_pdf_kernel` (pallas_call at :1017)
// with its loops `_disk_ode_loop` and `_disk_pdf_exact_loop`.
//
// One thread per sample. Weights (the velocity net and the base heads, 3,220
// floats at width 32) are staged in shared memory once per block and read as
// warp-wide broadcasts; the ODE state and its two forward-mode tangent streams
// live in registers; arithmetic is fp32 FMA on the CUDA cores, no tensor
// cores. Built without --use_fast_math: the sigmoid uses expf and an IEEE
// divide.
//
// Bound: operations. Per sample K1 does ~27k fp32 MACs against 108 bytes of
// I/O (K2 exact ~89k MACs against 108 bytes), far above the card's
// FLOP-per-byte ridge, so the kernel is limited by FMA throughput and by the
// shared-memory loads that feed it. The design answers that with: the
// condition's part of the first layer (cond_enc @ W0[3:]) computed once per
// sample and kept in shared memory; float4 weight loads, each feeding 12 FMAs
// (primal and two tangents); tangents carried across steps so K1 and the
// reverse K2 take one 2x2 det at the end (the same function as the product of
// per-step dets, since det is multiplicative); only width 32 instantiated, so
// every loop over the net unrolls and the activations stay in registers.
//
// Layouts: inputs and outputs are plain row-major (N, d) float32 tensors.
// Packed weights, float32, each matrix (in, out) row-major as in the JAX
// package: velocity W0 (25, H), W1..W_{NL-1} (H, H), W_out (H, 2); then base
// W0 (14, 16), b0 (16), W1 (16, 4), b1 (4).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int XD = 2;            // ODE state dim (disk)
constexpr int CD = 22;           // cond_enc dim: PE(omega_i, 5 bands)
constexpr int IN = XD + 1 + CD;  // velocity input [x, alpha, cond_enc]
constexpr int BIN = 14;          // base heads read cond_enc[:, :14] = PE(omega_i, 3 bands)
constexpr int BH = 16;           // base hidden width
constexpr int BASE_FLOATS = BIN * BH + BH + BH * 4 + 4;
constexpr int BLOCK = 128;
constexpr float LOG_2PI = 1.8378770664093453f;
constexpr float TWO_PI = 6.283185307179586f;
constexpr float DET_GUARD = 1e-20f;  // fused_ode.py:925-926

template <int H, int NL>
struct Net {
  static_assert(H % 4 == 0, "hidden width must be a multiple of 4");
  static constexpr int WH = IN * H;                 // first hidden->hidden matrix
  static constexpr int WO = WH + (NL - 1) * H * H;  // output matrix (H, 2)
  static constexpr int VEL = WO + H * XD;           // velocity floats
  static constexpr int TOTAL = VEL + BASE_FLOATS;
};

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

// Block-wide copy of the packed weights into shared memory.
template <int TOTAL>
__device__ __forceinline__ void stage_weights(float* sw, const float* __restrict__ w) {
  for (int k = threadIdx.x; k < TOTAL; k += BLOCK) sw[k] = w[k];
  __syncthreads();
}

// cp[j * BLOCK] = (cond_enc @ W0[3:])[j]: the step-invariant part of layer 0.
template <int H>
__device__ __forceinline__ void cond_proj(const float* sw, const float (&c)[CD], float* cp) {
#pragma unroll
  for (int j = 0; j < H; ++j) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < CD; ++k) s = fmaf(c[k], sw[(XD + 1 + k) * H + j], s);
    cp[j * BLOCK] = s;
  }
}

// Base heads: biased 14 -> 16 (SiLU) -> 4 on cond_enc[:, :14];
// outputs (loc0, loc1, ls0, ls1).
__device__ __forceinline__ void base_heads(const float* bw, const float (&c)[CD],
                                           float (&loc)[2], float (&ls)[2]) {
  const float* w0 = bw;
  const float* b0 = w0 + BIN * BH;
  const float* w1 = b0 + BH;
  const float* b1 = w1 + BH * 4;
  float o[4] = {b1[0], b1[1], b1[2], b1[3]};
#pragma unroll
  for (int j = 0; j < BH; ++j) {
    float z = b0[j];
#pragma unroll
    for (int k = 0; k < BIN; ++k) z = fmaf(c[k], w0[k * BH + j], z);
    const float a = z * sigmoid(z);
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] = fmaf(a, w1[j * 4 + q], o[q]);
  }
  loc[0] = o[0];
  loc[1] = o[1];
  ls[0] = o[2];
  ls[1] = o[3];
}

// Shared-memory reads by byte address. Each MLP evaluation first passes the
// addresses through `fresh`, an empty asm the compiler cannot see through:
// without it the compiler hoists the loop-invariant weight loads out of the
// ODE loop and spills the ~2,900 hoisted floats to local memory.
__device__ __forceinline__ uint32_t fresh(uint32_t a) {
  asm volatile("" : "+r"(a)::"memory");
  return a;
}
__device__ __forceinline__ float lds(uint32_t a) {
  float v;
  asm("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ float2 lds2(uint32_t a) {
  float2 v;
  asm("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}
__device__ __forceinline__ float4 lds4(uint32_t a) {
  float4 v;
  asm("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];" : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a));
  return v;
}

// Velocity at [x, alpha, cond_enc] (primal only). `sa`: shared address of
// the weights; `ca`: shared address of this thread's cp[0], stride BLOCK.
template <int H, int NL>
__device__ __forceinline__ void mlp_primal(uint32_t sa, uint32_t ca, float x0, float x1, float alpha,
                                           float (&v)[2]) {
  using N = Net<H, NL>;
  sa = fresh(sa);
  ca = fresh(ca);
  float h[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float z = fmaf(x0, lds(sa + 4 * j),
                         fmaf(x1, lds(sa + 4 * (H + j)),
                              fmaf(alpha, lds(sa + 4 * (2 * H + j)), lds(ca + 4 * j * BLOCK))));
    h[j] = z * sigmoid(z);
  }
#pragma unroll
  for (int l = 0; l < NL - 1; ++l) {
    const uint32_t wl = sa + 4 * (N::WH + l * H * H);
    float hn[H];
#pragma unroll
    for (int j = 0; j < H; j += 4) {
      float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float4 w4 = lds4(wl + 4 * (i * H + j));
        z[0] = fmaf(h[i], w4.x, z[0]);
        z[1] = fmaf(h[i], w4.y, z[1]);
        z[2] = fmaf(h[i], w4.z, z[2]);
        z[3] = fmaf(h[i], w4.w, z[3]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) hn[j + q] = z[q] * sigmoid(z[q]);
    }
#pragma unroll
    for (int j = 0; j < H; ++j) h[j] = hn[j];
  }
  const uint32_t wo = sa + 4 * N::WO;
  v[0] = 0.0f;
  v[1] = 0.0f;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float2 w2 = lds2(wo + 4 * (i * XD));
    v[0] = fmaf(h[i], w2.x, v[0]);
    v[1] = fmaf(h[i], w2.y, v[1]);
  }
}

// Velocity and two forward-mode tangents. m[k][r] is tangent k of state
// component r; tv[k] = J @ m[k] with J = dv/dx. Only the two x columns of
// layer 0 carry a tangent.
template <int H, int NL>
__device__ __forceinline__ void mlp_tangent(uint32_t sa, uint32_t ca, float x0, float x1, float alpha,
                                            const float (&m)[2][2], float (&v)[2], float (&tv)[2][2]) {
  using N = Net<H, NL>;
  sa = fresh(sa);
  ca = fresh(ca);
  float h[H], g0[H], g1[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float wx0 = lds(sa + 4 * j), wx1 = lds(sa + 4 * (H + j));
    const float z = fmaf(x0, wx0, fmaf(x1, wx1, fmaf(alpha, lds(sa + 4 * (2 * H + j)), lds(ca + 4 * j * BLOCK))));
    const float s = sigmoid(z);
    const float d = s * (1.0f + z * (1.0f - s));
    h[j] = z * s;
    g0[j] = d * fmaf(m[0][0], wx0, m[0][1] * wx1);
    g1[j] = d * fmaf(m[1][0], wx0, m[1][1] * wx1);
  }
#pragma unroll
  for (int l = 0; l < NL - 1; ++l) {
    const uint32_t wl = sa + 4 * (N::WH + l * H * H);
    float hn[H], gn0[H], gn1[H];
#pragma unroll
    for (int j = 0; j < H; j += 4) {
      float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float t0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float t1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float4 w4 = lds4(wl + 4 * (i * H + j));
        const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          z[q] = fmaf(h[i], wq[q], z[q]);
          t0[q] = fmaf(g0[i], wq[q], t0[q]);
          t1[q] = fmaf(g1[i], wq[q], t1[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float s = sigmoid(z[q]);
        const float d = s * (1.0f + z[q] * (1.0f - s));
        hn[j + q] = z[q] * s;
        gn0[j + q] = d * t0[q];
        gn1[j + q] = d * t1[q];
      }
    }
#pragma unroll
    for (int j = 0; j < H; ++j) {
      h[j] = hn[j];
      g0[j] = gn0[j];
      g1[j] = gn1[j];
    }
  }
  const uint32_t wo = sa + 4 * N::WO;
  float o[2] = {0.0f, 0.0f}, p[2] = {0.0f, 0.0f}, q[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float2 w2 = lds2(wo + 4 * (i * XD));
    o[0] = fmaf(h[i], w2.x, o[0]);
    o[1] = fmaf(h[i], w2.y, o[1]);
    p[0] = fmaf(g0[i], w2.x, p[0]);
    p[1] = fmaf(g0[i], w2.y, p[1]);
    q[0] = fmaf(g1[i], w2.x, q[0]);
    q[1] = fmaf(g1[i], w2.y, q[1]);
  }
  v[0] = o[0];
  v[1] = o[1];
  tv[0][0] = p[0];
  tv[0][1] = p[1];
  tv[1][0] = q[0];
  tv[1][1] = q[1];
}

// Philox4x32-10 (Salmon et al., SC'11) on counter c with key (k0, k1).
__device__ __forceinline__ void philox4x32_10(uint32_t (&c)[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// Top 24 bits -> [0, 1) (fused_ode.py:612-617).
__device__ __forceinline__ float unit24(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// Two standard normals for sample `idx` under `seed`: Philox4x32-10 keyed by
// the seed, counter (idx, 0, 0); eps_k = sqrt(-2 log u1) cos(2 pi u2) from
// words (2k, 2k+1), u1 clipped to [1e-7, 1 - 1e-7] (fused_ode.py:619-621).
__device__ __forceinline__ void normal2(uint64_t seed, uint64_t idx, float (&e)[2]) {
  uint32_t c[4] = {(uint32_t)idx, (uint32_t)(idx >> 32), 0u, 0u};
  philox4x32_10(c, (uint32_t)seed, (uint32_t)(seed >> 32));
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float u1 = fminf(fmaxf(unit24(c[2 * k]), 1e-7f), 1.0f - 1e-7f);
    const float u2 = unit24(c[2 * k + 1]);
    e[k] = sqrtf(-2.0f * logf(u1)) * cosf(TWO_PI * u2);
  }
}

// K1: base heads -> x0 = loc + eps * exp(ls) -> T forward Euler steps with
// carried tangents -> pdf = N(x0) / det.
template <int H, int NL, bool PRNG>
__global__ void __launch_bounds__(BLOCK)
    sample_pdf_disk_kernel(const float* __restrict__ cond, const float* __restrict__ eps,
                           const long long* __restrict__ seed, const float* __restrict__ w,
                           float* __restrict__ x_out, float* __restrict__ pdf_out,
                           float* __restrict__ x0_out, int n, int T) {
  using N = Net<H, NL>;
  __shared__ __align__(16) float sw[N::TOTAL];
  __shared__ float scp[H * BLOCK];
  stage_weights<N::TOTAL>(sw, w);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;

  float c[CD];
#pragma unroll
  for (int k = 0; k < CD; ++k) c[k] = cond[(size_t)i * CD + k];
  float* cp = scp + threadIdx.x;
  cond_proj<H>(sw, c, cp);
  const uint32_t sa = (uint32_t)__cvta_generic_to_shared(sw);
  const uint32_t ca = (uint32_t)__cvta_generic_to_shared(cp);
  float loc[2], ls[2];
  base_heads(sw + N::VEL, c, loc, ls);

  float e[2];
  if (PRNG) {
    normal2((uint64_t)seed[0], (uint64_t)i, e);
  } else {
    e[0] = eps[2 * (size_t)i];
    e[1] = eps[2 * (size_t)i + 1];
  }
  const float x00 = loc[0] + e[0] * expf(ls[0]);
  const float x01 = loc[1] + e[1] * expf(ls[1]);
  const float log_p0 = -LOG_2PI - ls[0] - ls[1] - 0.5f * (e[0] * e[0] + e[1] * e[1]);

  const float h = 1.0f / (float)T;
  float x0 = x00, x1 = x01;
  float m[2][2] = {{1.0f, 0.0f}, {0.0f, 1.0f}};
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    float v[2], tv[2][2];
    mlp_tangent<H, NL>(sa, ca, x0, x1, (float)t * h, m, v, tv);
    x0 += h * v[0];
    x1 += h * v[1];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      m[k][0] += h * tv[k][0];
      m[k][1] += h * tv[k][1];
    }
  }
  const float det = m[0][0] * m[1][1] - m[1][0] * m[0][1];
  x_out[2 * (size_t)i] = x0;
  x_out[2 * (size_t)i + 1] = x1;
  pdf_out[i] = expf(log_p0) / det;
  x0_out[2 * (size_t)i] = x00;
  x0_out[2 * (size_t)i + 1] = x01;
}

// K2: pdf of a given x. EXACT: for t = T-1..0 a reverse-Euler warm start,
// `newton_iters` closed-form 2x2 Newton solves of y = x + h v(x, t/T), then
// the forward det at the converged x; pdf = p0 / prod det. Otherwise reverse
// Euler (alpha = 1 - t/T) with carried tangents; pdf = p0 * det.
template <int H, int NL, bool EXACT>
__global__ void __launch_bounds__(BLOCK)
    pdf_disk_kernel(const float* __restrict__ x_in, const float* __restrict__ cond,
                    const float* __restrict__ w, float* __restrict__ pdf_out,
                    float* __restrict__ x0_out, int n, int T, int newton_iters) {
  using N = Net<H, NL>;
  __shared__ __align__(16) float sw[N::TOTAL];
  __shared__ float scp[H * BLOCK];
  stage_weights<N::TOTAL>(sw, w);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;

  float c[CD];
#pragma unroll
  for (int k = 0; k < CD; ++k) c[k] = cond[(size_t)i * CD + k];
  float* cp = scp + threadIdx.x;
  cond_proj<H>(sw, c, cp);
  const uint32_t sa = (uint32_t)__cvta_generic_to_shared(sw);
  const uint32_t ca = (uint32_t)__cvta_generic_to_shared(cp);
  float loc[2], ls[2];  // taken first, so that c[] is dead during the ODE loop
  base_heads(sw + N::VEL, c, loc, ls);

  const float h = 1.0f / (float)T;
  float y0 = x_in[2 * (size_t)i], y1 = x_in[2 * (size_t)i + 1];
  float det_acc = 1.0f;
  if (EXACT) {
    const float eye[2][2] = {{1.0f, 0.0f}, {0.0f, 1.0f}};
#pragma unroll 1
    for (int t = T - 1; t >= 0; --t) {
      const float alpha = (float)t * h;
      float v[2];
      mlp_primal<H, NL>(sa, ca, y0, y1, alpha, v);
      float g0 = y0 - h * v[0], g1 = y1 - h * v[1];
#pragma unroll 1
      for (int it = 0;; ++it) {
        float vg[2], tv[2][2];
        mlp_tangent<H, NL>(sa, ca, g0, g1, alpha, eye, vg, tv);
        const float a = 1.0f + h * tv[0][0];
        const float b = h * tv[1][0];
        const float cc = h * tv[0][1];
        const float d = 1.0f + h * tv[1][1];
        const float det = a * d - b * cc;
        if (it == newton_iters) {
          det_acc *= det;
          break;
        }
        const float f0 = g0 + h * vg[0] - y0;
        const float f1 = g1 + h * vg[1] - y1;
        const float dg = fabsf(det) > DET_GUARD ? det : 1.0f;
        g0 -= (d * f0 - b * f1) / dg;
        g1 -= (-cc * f0 + a * f1) / dg;
      }
      y0 = g0;
      y1 = g1;
    }
  } else {
    float m[2][2] = {{1.0f, 0.0f}, {0.0f, 1.0f}};
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      float v[2], tv[2][2];
      mlp_tangent<H, NL>(sa, ca, y0, y1, 1.0f - (float)t * h, m, v, tv);
      y0 -= h * v[0];
      y1 -= h * v[1];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        m[k][0] -= h * tv[k][0];
        m[k][1] -= h * tv[k][1];
      }
    }
    det_acc = m[0][0] * m[1][1] - m[1][0] * m[0][1];
  }

  const float z0 = (y0 - loc[0]) / expf(ls[0]);
  const float z1 = (y1 - loc[1]) / expf(ls[1]);
  const float p0 = expf(-LOG_2PI - ls[0] - ls[1] - 0.5f * (z0 * z0 + z1 * z1));
  pdf_out[i] = EXACT ? p0 / det_acc : p0 * det_acc;
  x0_out[2 * (size_t)i] = y0;
  x0_out[2 * (size_t)i + 1] = y1;
}

inline int blocks_for(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

extern "C" {

// Widths other than (hidden 32, 3 hidden layers) are refused with
// cudaErrorInvalidValue; the Python wrapper checks first.
int bsdf_fused_sample_pdf_disk(const float* cond, const float* eps, const long long* seed,
                               const float* w, float* x, float* pdf, float* x0, int n, int T,
                               int hidden, int layers, void* stream) {
  if (hidden != 32 || layers != 3 || n <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (eps != nullptr) {
    sample_pdf_disk_kernel<32, 3, false>
        <<<blocks_for(n), BLOCK, 0, s>>>(cond, eps, seed, w, x, pdf, x0, n, T);
  } else {
    sample_pdf_disk_kernel<32, 3, true>
        <<<blocks_for(n), BLOCK, 0, s>>>(cond, eps, seed, w, x, pdf, x0, n, T);
  }
  return (int)cudaGetLastError();
}

int bsdf_fused_pdf_disk(const float* x, const float* cond, const float* w, float* pdf,
                        float* x0, int n, int T, int exact, int newton_iters, int hidden,
                        int layers, void* stream) {
  if (hidden != 32 || layers != 3 || n <= 0 || T <= 0 || newton_iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (exact) {
    pdf_disk_kernel<32, 3, true>
        <<<blocks_for(n), BLOCK, 0, s>>>(x, cond, w, pdf, x0, n, T, newton_iters);
  } else {
    pdf_disk_kernel<32, 3, false>
        <<<blocks_for(n), BLOCK, 0, s>>>(x, cond, w, pdf, x0, n, T, newton_iters);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
