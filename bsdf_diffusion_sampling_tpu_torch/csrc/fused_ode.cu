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
// divide. The MLP, the transport and the Philox generator are in
// ode_mlp.cuh, shared with K3 and K4.
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

#include "ode_mlp.cuh"

namespace {

using namespace ode;
constexpr float DET_GUARD = 1e-20f;  // fused_ode.py:925-926

// Two standard normals for sample `idx` under `seed`: Philox4x32-10 keyed by
// the seed, counter (idx, 0, 0); eps_k = Box-Muller on words (2k, 2k+1).
__device__ __forceinline__ void normal2(uint64_t seed, uint64_t idx, float (&e)[2]) {
  uint32_t c[4] = {(uint32_t)idx, (uint32_t)(idx >> 32), 0u, 0u};
  philox4x32_10(c, (uint32_t)seed, (uint32_t)(seed >> 32));
  e[0] = box_muller(c[0], c[1]);
  e[1] = box_muller(c[2], c[3]);
}

// K1: base heads -> x0 = loc + eps * exp(ls) -> T forward Euler steps with
// carried tangents -> pdf = N(x0) / det.
template <int H, int NL, bool PRNG>
__global__ void __launch_bounds__(BLOCK)
    sample_pdf_disk_kernel(const float* __restrict__ cond, const float* __restrict__ eps,
                           const long long* __restrict__ seed, const float* __restrict__ w,
                           float* __restrict__ x_out, float* __restrict__ pdf_out,
                           float* __restrict__ x0_out, int n, int T) {
  using N = Net<H, NL, 2>;
  __shared__ __align__(16) float sw[N::TOTAL];
  __shared__ float scp[H * BLOCK];
  stage_weights(sw, w, N::TOTAL);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;

  float c[CD];
#pragma unroll
  for (int k = 0; k < CD; ++k) c[k] = cond[(size_t)i * CD + k];
  float* cp = scp + threadIdx.x;
  cond_proj<H, 2>(sw, c, cp);
  const uint32_t sa = (uint32_t)__cvta_generic_to_shared(sw);
  const uint32_t ca = (uint32_t)__cvta_generic_to_shared(cp);
  float o[4];
  base_heads(sw + N::VEL, c, o);
  const float loc[2] = {o[0], o[1]}, ls[2] = {o[2], o[3]};

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

  float x0 = x00, x1 = x01, det;
  transport<H, NL, 2, true>(sa, ca, x0, x1, T, false, det);
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
  using N = Net<H, NL, 2>;
  __shared__ __align__(16) float sw[N::TOTAL];
  __shared__ float scp[H * BLOCK];
  stage_weights(sw, w, N::TOTAL);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;

  float c[CD];
#pragma unroll
  for (int k = 0; k < CD; ++k) c[k] = cond[(size_t)i * CD + k];
  float* cp = scp + threadIdx.x;
  cond_proj<H, 2>(sw, c, cp);
  const uint32_t sa = (uint32_t)__cvta_generic_to_shared(sw);
  const uint32_t ca = (uint32_t)__cvta_generic_to_shared(cp);
  float o[4];  // taken first, so that c[] is dead during the ODE loop
  base_heads(sw + N::VEL, c, o);
  const float loc[2] = {o[0], o[1]}, ls[2] = {o[2], o[3]};

  const float h = 1.0f / (float)T;
  float y0 = x_in[2 * (size_t)i], y1 = x_in[2 * (size_t)i + 1];
  float det_acc = 1.0f;
  if (EXACT) {
    const float eye[2][2] = {{1.0f, 0.0f}, {0.0f, 1.0f}};
#pragma unroll 1
    for (int t = T - 1; t >= 0; --t) {
      const float alpha = (float)t * h;
      const float ye[2] = {y0, y1};
      float v[2];
      mlp_primal<H, NL, 2>(sa, ca, ye, alpha, v);
      float g0 = y0 - h * v[0], g1 = y1 - h * v[1];
#pragma unroll 1
      for (int it = 0;; ++it) {
        const float ge[2] = {g0, g1};
        float vg[2], tv[2][2];
        mlp_tangent<H, NL, 2>(sa, ca, ge, alpha, eye, vg, tv);
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
    transport<H, NL, 2, true>(sa, ca, y0, y1, T, true, det_acc);
  }

  const float z0 = (y0 - loc[0]) / expf(ls[0]);
  const float z1 = (y1 - loc[1]) / expf(ls[1]);
  const float p0 = expf(-LOG_2PI - ls[0] - ls[1] - 0.5f * (z0 * z0 + z1 * z1));
  pdf_out[i] = EXACT ? p0 / det_acc : p0 * det_acc;
  x0_out[2 * (size_t)i] = y0;
  x0_out[2 * (size_t)i + 1] = y1;
}

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
