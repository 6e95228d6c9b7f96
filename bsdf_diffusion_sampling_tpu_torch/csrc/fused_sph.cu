// Fused spherical sample+pdf kernel (K4) and exact pdf query (K2s) for
// Hopper.
//
// K4 replaces the JAX package's `ops/fused_ode.py::_fused_sample_pdf_sph_kernel`
// (pallas_call at :1534) with `_spherical_ode_loop` and `_log_i0_lanes`. Per
// sample: the base heads (loc_theta, log_scale, loc_phi, softplus(conc) +
// 1e-3) over cond_enc[:, :14]; theta0 = loc_theta + eps_g (exp(log_scale) +
// 1e-3) with eps_g Gaussian; phi0 von Mises by Best-Fisher rejection, 16
// fixed rounds, the first accepted one kept (round 0's angle if none is, as
// the JAX package's XLA sampler does), wrapped to [-pi, pi) by a floor mod;
// log p0 = Gaussian(theta0), normalised by -log_scale (the trained quirk), +
// von Mises(phi0) with the A&S log I0; T forward Euler steps on the encoded
// state (theta, sin phi, cos phi) with carried tangents; pdf = p0 / det.
//
// The draw is given (eps (N, 2) = (eps_g, phi0)) or made in-kernel from a
// 64-bit seed: Philox4x32-10 keyed by the seed on counters (g lo, g hi, j,
// 0), j = 0..12, with g = row0 + i the sample's global row (row0 is 0 for a
// whole batch, the shard's first row for a shard of one), gives 52 words a
// sample, of which words 0, 1 feed Box-Muller for
// eps_g and words 2 + 3r + (0, 1, 2) the three uniforms of Best-Fisher round
// r, each clipped to [1e-7, 1 - 1e-7] (`ops/fused_ode.py::philox_spherical_draws`
// reproduces the stream in numpy).
//
// The design is K1's (ode_mlp_tc.cuh): a warp takes 32 samples, one lane a
// sample for the heads, the draw (the Best-Fisher loop exits a lane at a
// time; the warp meets again before the transport) and log p0; then two
// tiles of 16 samples, each sample three rows (primal and two tangent
// streams), whose three hidden 32 x 32 products a step run on mma.sync
// m16n8k8 in 3xTF32 (fp32 accuracy); layer 0, its condition part (once a
// sample) and the output layer on the CUDA cores; one det a sample at the
// end. The MLP's sigmoid is __expf and __frcp_rn; the base heads' is expf
// and an IEEE divide, as in the draw's host reproduction.
//
// Bound: operations. At width 32 and 4 hidden layers a sample takes ~78k
// multiply-adds at T = 8 (3,264 primal and 2 x 3,232 tangent a step)
// against 36 bytes in and 20 out: 2.47 ms at 2^20 samples on the fp32 CUDA
// cores (67 TFLOP/s). The 72k of them that are hidden products run 3 passes
// on the tensor cores, ~0.9 ms at 495 TFLOP/s TF32; the ~1,040 sigmoids a
// sample, the operand splits and layer 0 stay on the CUDA cores and cost as
// much, so neither unit alone bounds the kernel. As for K1, latency limits
// it: 168 registers a thread, 3 blocks of 128 an SM (fused_ode.cu). PERF.md
// has its time, registers and blocks an SM.
//
// K2s, the exact pdf query of x = (theta, phi), replaces no TPU kernel: the
// JAX package runs `ode/flow.py:ode_pdf_exact` under XLA, and the port ran
// it as plain PyTorch, hundreds of small ops on every row of the wavefront,
// twice a bounce of a neural-sphere render with the exact pdf (the CLI's
// default), nearly all of that render's device time. Per row: the Newton
// inverse of the forward Euler map for t = T-1..0 (a reverse-Euler warm
// start, `newton_iters` closed-form 2x2 Newton updates with the det guard,
// det(I + h J) at the converged point into the product), which is K2's loop
// (`ode_tc::newton_tile`) on the spherical encoding, the input tangents the
// encoded identity; then the base heads and log p0 at the recovered x0 as
// `models/base_density.py::spherical_log_prob_from_heads` takes them
// (theta's Gaussian normalised by -log_scale, phi's von Mises with K4's
// log I0, softplus and 1e-3 epsilons); pdf = p0 / prod det. The design is
// K4's and K2's: a warp takes 32 rows in two tiles of 16, each row three
// streams whose hidden 32 x 32 products run on mma.sync in 3xTF32, the
// weights staged once a block, layer 0's condition part once a row.
//
// Bound: operations. At T = 8 and 2 Newton iterations a row takes ~260k
// multiply-adds (per step a primal warm start of 3,264 and three S = 3
// evaluations of 3,264 + 2 x 3,232) against 96 bytes in and 12 out: ~8.2
// ms at 2^20 rows on the fp32 CUDA cores, of which ~1.1 ms is the hidden
// products' TF32 tensor-core time. As for K2, latency limits it: 168
// registers a thread, 3 blocks of 128 an SM. PERF.md has its time.
//
// The routed draw (`sph_draw_routed_kernel`) and query
// (`sph_query_routed_kernel`) are K4 and K2s over the rows of many samplers
// at once, as a scene of several full-sphere matballs routes them
// (`render/integrator.py`): the rows come sorted by sampler in segments
// padded to a block, and each block stages the weights of its segment's
// sampler from a stacked buffer, then runs K4's or K2s's warp code
// (`draw_warp`, `query_warp`) unchanged. A routed row's draw is keyed by its
// wavefront index, so it equals what K4 over the whole wavefront draws for
// that row.

#include "ode_mlp.cuh"
#include "ode_mlp_tc.cuh"

namespace {

using namespace ode;
constexpr int H = 32, NL = 4, XE = 3;
constexpr float EPS_SPH = 1e-3f;  // base_density._EPS_SPHERICAL
constexpr int VM_ROUNDS = 16;
constexpr int WORDS = 2 + 3 * VM_ROUNDS;    // Box-Muller pair + 16 rounds of 3
constexpr int BLOCKS = (WORDS + 3) / 4;     // Philox blocks a sample
constexpr size_t SMEM = ode_tc::TcNet<H, NL, XE>::SMEM_FLOATS * sizeof(float);  // 39.1 KB

// A&S 9.8.1 / 9.8.2 (models/von_mises.py)
__device__ __forceinline__ float log_i0(float x) {
  const float I0_SMALL[7] = {1.0f, 3.5156229f, 3.0899424f, 1.2067492f, 0.2659732f, 0.0360768f, 0.0045813f};
  const float I0_LARGE[9] = {0.39894228f, 0.01328592f, 0.00225319f, -0.00157565f, 0.00916281f,
                             -0.02057706f, 0.02635537f, -0.01647633f, 0.00392377f};
  x = fabsf(x);
  const float q = x / 3.75f;
  const float ts = q * q;
  float ps = 0.0f;
#pragma unroll
  for (int k = 6; k >= 0; --k) ps = ps * ts + I0_SMALL[k];
  const float xs = fmaxf(x, 1e-6f);
  const float tl = 3.75f / xs;
  float pl = 0.0f;
#pragma unroll
  for (int k = 8; k >= 0; --k) pl = pl * tl + I0_LARGE[k];
  return x <= 3.75f ? logf(ps) : xs - 0.5f * logf(xs) + logf(pl);
}

// torch's softplus (beta 1, threshold 20)
__device__ __forceinline__ float softplus(float x) { return x > 20.0f ? x : log1pf(expf(x)); }

// Floor mod, the sign of the result that of b, as torch.remainder and
// jnp.mod take it (fmodf alone truncates toward zero).
__device__ __forceinline__ float floor_mod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r += b;
  return r;
}

__device__ __forceinline__ float clip_u(uint32_t w) { return fminf(fmaxf(unit24(w), 1e-7f), 1.0f - 1e-7f); }

// Best-Fisher von Mises draw on the words of one sample (models/von_mises.py).
__device__ __forceinline__ float von_mises(const uint32_t (&wd)[4 * BLOCKS], float loc, float conc) {
  const float kappa = fmaxf(conc, 1e-12f);
  const float tau = 1.0f + sqrtf(1.0f + 4.0f * kappa * kappa);
  const float rho = (tau - sqrtf(2.0f * tau)) / (2.0f * kappa);
  const float r = (1.0f + rho * rho) / (2.0f * rho);
  float sel = 0.0f;
#pragma unroll
  for (int k = 0; k < VM_ROUNDS; ++k) {
    const float u0 = clip_u(wd[2 + 3 * k]), u1 = clip_u(wd[3 + 3 * k]), u2 = clip_u(wd[4 + 3 * k]);
    const float z = cosf(PI * u0);
    const float f = (1.0f + r * z) / (r + z);
    const float c = kappa * (r - f);
    const bool accept = (c * (2.0f - c) - u1 > 0.0f) || (logf(c / u1) + 1.0f - c >= 0.0f);
    const float sgn = (float)((u2 > 0.5f) - (u2 < 0.5f));  // jnp.sign(u2 - 0.5)
    if (k == 0 || accept) sel = sgn * acosf(fminf(fmaxf(f, -1.0f), 1.0f));
    if (accept) break;
  }
  if (kappa < 1e-6f) return clip_u(wd[2]) * 2.0f * PI - PI;  // uniform on the circle
  return floor_mod(sel + loc + PI, TWO_PI) - PI;
}

// One warp's K4 work: the samples w0 .. w0 + 31 (those past n run on a zero
// condition and draw, and store nothing), the weights staged in smem.
// Philox keys on the 64-bit seed s at the counter of `row_of(i)`, sample
// i's row of the wavefront.
template <bool PRNG, typename RowOf>
__device__ __forceinline__ void draw_warp(float* smem, const float* __restrict__ cond, const float* __restrict__ eps,
                                          uint64_t s, RowOf row_of, float* __restrict__ x_out,
                                          float* __restrict__ pdf_out, float* __restrict__ x0_out, int n, int T,
                                          int w0, int warp, int lane) {
  using C = ode_tc::TcNet<H, NL, XE>;
  const int i = w0 + lane;
  const bool live = i < n;

  float c[CD];
#pragma unroll
  for (int k = 0; k < CD; ++k) c[k] = live ? cond[(size_t)i * CD + k] : 0.0f;
  float o[4];
  base_heads(smem + C::BASE, c, o);
  const float loc_t = o[0], ls = o[1], loc_p = o[2], conc = softplus(o[3]) + EPS_SPH;

  float eps_g = 0.0f, phi0 = 0.0f;
  if (PRNG) {
    const uint64_t g = row_of(i);
    uint32_t wd[4 * BLOCKS];
#pragma unroll
    for (int b = 0; b < BLOCKS; ++b) {
      uint32_t ctr[4] = {(uint32_t)g, (uint32_t)(g >> 32), (uint32_t)b, 0u};
      philox4x32_10(ctr, (uint32_t)s, (uint32_t)(s >> 32));
#pragma unroll
      for (int q = 0; q < 4; ++q) wd[4 * b + q] = ctr[q];
    }
    eps_g = box_muller(wd[0], wd[1]);
    phi0 = von_mises(wd, loc_p, conc);
  } else if (live) {
    eps_g = eps[2 * (size_t)i];
    phi0 = eps[2 * (size_t)i + 1];
  }
  const float theta0 = loc_t + eps_g * (expf(ls) + EPS_SPH);
  const float kap = fmaxf(conc, 1e-12f);
  const float log_p0 = -0.5f * LOG_2PI - ls - 0.5f * eps_g * eps_g + kap * cosf(phi0 - loc_p) - LOG_2PI -
                       log_i0(kap);

  float* st = smem + C::STATE + warp * 32 * ode_tc::ST;
  st[lane * ode_tc::ST] = theta0;
  st[lane * ode_tc::ST + 1] = phi0;
  __syncwarp();
  ode_tc::transport_warp<H, NL, XE>(smem, cond, w0, n, T, warp, lane);
  if (!live) return;
  x_out[2 * (size_t)i] = st[lane * ode_tc::ST];
  x_out[2 * (size_t)i + 1] = st[lane * ode_tc::ST + 1];
  pdf_out[i] = expf(log_p0) / st[lane * ode_tc::ST + 2];
  x0_out[2 * (size_t)i] = theta0;
  x0_out[2 * (size_t)i + 1] = phi0;
}

// One warp's K2s work: the exact pdf of x = (theta, phi) and the recovered
// x0 of rows w0 .. w0 + 31 (those past n run from x = 0 on a zero condition
// and store nothing), the weights staged in smem.
__device__ __forceinline__ void query_warp(float* smem, const float* __restrict__ x_in,
                                           const float* __restrict__ cond, float* __restrict__ pdf_out,
                                           float* __restrict__ x0_out, int n, int T, int newton_iters, int w0,
                                           int warp, int lane) {
  using C = ode_tc::TcNet<H, NL, XE>;
  const int i = w0 + lane;
  const bool live = i < n;

  float* st = smem + C::STATE + warp * 32 * ode_tc::ST;
  st[lane * ode_tc::ST] = live ? x_in[2 * (size_t)i] : 0.0f;
  st[lane * ode_tc::ST + 1] = live ? x_in[2 * (size_t)i + 1] : 0.0f;
  __syncwarp();
  ode_tc::for_each_tile<H, NL, XE, true, ode_tc::WARPS>(
      smem, cond, w0, n, warp, lane,
      [&](uint32_t sa, uint32_t ca, float (&s0)[2], float (&s1)[2], float (&det)[2]) {
        ode_tc::newton_tile<H, NL, XE>(sa, ca, s0, s1, T, newton_iters, det, lane);
      });
  if (!live) return;

  float c[CD];
#pragma unroll
  for (int k = 0; k < CD; ++k) c[k] = cond[(size_t)i * CD + k];
  float o[4];
  base_heads(smem + C::BASE, c, o);
  const float loc_t = o[0], ls = o[1], loc_p = o[2], conc = softplus(o[3]) + EPS_SPH;
  const float theta0 = st[lane * ode_tc::ST], phi0 = st[lane * ode_tc::ST + 1], det = st[lane * ode_tc::ST + 2];
  const float z = (theta0 - loc_t) / (expf(ls) + EPS_SPH);
  const float log_gauss = -0.5f * LOG_2PI - ls - 0.5f * z * z;
  const float log_vm = conc * cosf(phi0 - loc_p) - LOG_2PI - log_i0(conc);
  pdf_out[i] = expf(log_gauss + log_vm) / det;
  x0_out[2 * (size_t)i] = theta0;
  x0_out[2 * (size_t)i + 1] = phi0;
}

template <bool PRNG>
__global__ void __launch_bounds__(BLOCK)
    sample_pdf_sph_kernel(const float* __restrict__ cond, const float* __restrict__ eps,
                          const long long* __restrict__ seed, const float* __restrict__ w,
                          float* __restrict__ x_out, float* __restrict__ pdf_out, float* __restrict__ x0_out,
                          int n, int T, long long row0) {
  extern __shared__ __align__(16) float smem[];
  ode_tc::stage<H, NL, XE>(smem, w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = blockIdx.x * BLOCK + warp * 32;
  if (w0 >= n) return;  // warp-uniform
  draw_warp<PRNG>(smem, cond, eps, PRNG ? (uint64_t)seed[0] : 0ull,
                  [&](int i) { return (uint64_t)row0 + (uint64_t)i; }, x_out, pdf_out, x0_out, n, T, w0, warp,
                  lane);
}

// K2s: the exact pdf of x = (theta, phi) and the recovered x0.
__global__ void __launch_bounds__(BLOCK, 3)
    pdf_sph_kernel(const float* __restrict__ x_in, const float* __restrict__ cond, const float* __restrict__ w,
                   float* __restrict__ pdf_out, float* __restrict__ x0_out, int n, int T, int newton_iters) {
  extern __shared__ __align__(16) float smem[];
  ode_tc::stage<H, NL, XE>(smem, w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = blockIdx.x * BLOCK + warp * 32;
  if (w0 >= n) return;  // warp-uniform
  query_warp(smem, x_in, cond, pdf_out, x0_out, n, T, newton_iters, w0, warp, lane);
}

// The routed draw and query: many samplers' rows in one launch. The rows
// come sorted by sampler, each sampler's segment padded to a whole block
// (BLOCK rows), so block k's rows all belong to sampler tile_ball[k], whose
// packed weights (row tile_ball[k] of w, `stride` floats a row) it stages;
// a block whose entry is negative (past the last segment) exits at once.
// The draw keys Philox on the sampler's seed at the counter of the row's
// wavefront index rows[i] (a padding slot's, 0 or more, is drawn and not
// used), so every row draws what K4 over the whole wavefront draws there.
__global__ void __launch_bounds__(BLOCK)
    sph_draw_routed_kernel(const float* __restrict__ cond, const long long* __restrict__ rows,
                           const int* __restrict__ tile_ball, const long long* __restrict__ seeds,
                           const float* __restrict__ w, int stride, float* __restrict__ x_out,
                           float* __restrict__ pdf_out, float* __restrict__ x0_out, int n, int T) {
  const int b = tile_ball[blockIdx.x];
  if (b < 0) return;  // block-uniform
  extern __shared__ __align__(16) float smem[];
  ode_tc::stage<H, NL, XE>(smem, w + (size_t)b * stride);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = blockIdx.x * BLOCK + warp * 32;
  if (w0 >= n) return;  // warp-uniform
  draw_warp<true>(smem, cond, nullptr, (uint64_t)seeds[b],
                  [&](int i) { return (uint64_t)max(rows[i], 0ll); }, x_out, pdf_out, x0_out, n, T, w0, warp,
                  lane);
}

__global__ void __launch_bounds__(BLOCK, 3)
    sph_query_routed_kernel(const float* __restrict__ x_in, const float* __restrict__ cond,
                            const int* __restrict__ tile_ball, const float* __restrict__ w, int stride,
                            float* __restrict__ pdf_out, float* __restrict__ x0_out, int n, int T, int newton_iters) {
  const int b = tile_ball[blockIdx.x];
  if (b < 0) return;  // block-uniform
  extern __shared__ __align__(16) float smem[];
  ode_tc::stage<H, NL, XE>(smem, w + (size_t)b * stride);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = blockIdx.x * BLOCK + warp * 32;
  if (w0 >= n) return;  // warp-uniform
  query_warp(smem, x_in, cond, pdf_out, x0_out, n, T, newton_iters, w0, warp, lane);
}

}  // namespace

extern "C" {

// Widths other than (hidden 32, 4 hidden layers) are refused with
// cudaErrorInvalidValue; the Python wrapper checks first. `row0` is the
// global row of the launch's first sample (the Philox route).
int bsdf_fused_sample_pdf_spherical(const float* cond, const float* eps, const long long* seed, long long row0,
                                    const float* w, float* x, float* pdf, float* x0, int n, int T, int hidden,
                                    int layers, void* stream) {
  if (hidden != H || layers != NL || n <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (eps != nullptr) {
    sample_pdf_sph_kernel<false><<<blocks_for(n), BLOCK, SMEM, s>>>(cond, eps, seed, w, x, pdf, x0, n, T, row0);
  } else {
    sample_pdf_sph_kernel<true><<<blocks_for(n), BLOCK, SMEM, s>>>(cond, eps, seed, w, x, pdf, x0, n, T, row0);
  }
  return (int)cudaGetLastError();
}

// K2s. Widths other than (hidden 32, 4 hidden layers) are refused with
// cudaErrorInvalidValue, as are n <= 0, T <= 0 and newton_iters < 0; the
// Python wrapper checks first.
int bsdf_fused_pdf_spherical(const float* x, const float* cond, const float* w, float* pdf, float* x0, int n,
                             int T, int newton_iters, int hidden, int layers, void* stream) {
  if (hidden != H || layers != NL || n <= 0 || T <= 0 || newton_iters < 0) return (int)cudaErrorInvalidValue;
  pdf_sph_kernel<<<blocks_for(n), BLOCK, SMEM, (cudaStream_t)stream>>>(x, cond, w, pdf, x0, n, T, newton_iters);
  return (int)cudaGetLastError();
}

// The routed draw and query over `n` slots (a multiple of BLOCK): `w` holds
// one packed sampler a row, `stride` floats apart, `tile_ball` one entry a
// block of slots. Widths other than (hidden 32, 4 hidden layers) are refused
// with cudaErrorInvalidValue, as are n not a positive multiple of BLOCK, T
// <= 0 and newton_iters < 0; the Python wrappers check first.
int bsdf_sph_draw_routed(const float* cond, const long long* rows, const int* tile_ball, const long long* seeds,
                         const float* w, int stride, float* x, float* pdf, float* x0, int n, int T, int hidden,
                         int layers, void* stream) {
  if (hidden != H || layers != NL || n <= 0 || n % BLOCK || T <= 0) return (int)cudaErrorInvalidValue;
  sph_draw_routed_kernel<<<n / BLOCK, BLOCK, SMEM, (cudaStream_t)stream>>>(cond, rows, tile_ball, seeds, w, stride,
                                                                        x, pdf, x0, n, T);
  return (int)cudaGetLastError();
}

int bsdf_sph_query_routed(const float* x, const float* cond, const int* tile_ball, const float* w, int stride,
                          float* pdf, float* x0, int n, int T, int newton_iters, int hidden, int layers,
                          void* stream) {
  if (hidden != H || layers != NL || n <= 0 || n % BLOCK || T <= 0 || newton_iters < 0) {
    return (int)cudaErrorInvalidValue;
  }
  sph_query_routed_kernel<<<n / BLOCK, BLOCK, SMEM, (cudaStream_t)stream>>>(x, cond, tile_ball, w, stride, pdf, x0,
                                                                         n, T, newton_iters);
  return (int)cudaGetLastError();
}

// Resources of instantiation `which` (0: K4 with eps, 1: K4 with Philox, 2:
// K2s, 3: the routed draw, 4: the routed query): out = {registers, local
// bytes, blocks an SM, shared bytes}.
int bsdf_fused_sph_kernel_info(int which, int* out) {
  if (which == 0) return ode_tc::kernel_info(sample_pdf_sph_kernel<false>, SMEM, out);
  if (which == 1) return ode_tc::kernel_info(sample_pdf_sph_kernel<true>, SMEM, out);
  if (which == 2) return ode_tc::kernel_info(pdf_sph_kernel, SMEM, out);
  if (which == 3) return ode_tc::kernel_info(sph_draw_routed_kernel, SMEM, out);
  if (which == 4) return ode_tc::kernel_info(sph_query_routed_kernel, SMEM, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
