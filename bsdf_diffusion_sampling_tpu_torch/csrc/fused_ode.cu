// Fused disk-domain sample+pdf (K1) and pdf-query (K2) kernels for Hopper.
//
// K1 replaces the JAX package's `ops/fused_ode.py::_fused_sample_pdf_kernel`
// (pallas_call at :684); K2 replaces `_fused_pdf_kernel` (pallas_call at :1017)
// with its loops `_disk_ode_loop` and `_disk_pdf_exact_loop`.
//
// K1 runs the velocity MLP on the tensor cores (ode_mlp_tc.cuh). A warp
// takes 32 samples: one lane a sample for the base heads, the draw and log
// p0; then two tiles of 16 samples, each sample three rows (primal and two
// forward-mode tangent streams), through T Euler steps whose two hidden
// 32 x 32 products run on mma.sync m16n8k8 in 3xTF32 (fp32 accuracy), layer
// 0 and the output layer on the CUDA cores; one 2x2 det a sample at the
// end; the MLP's sigmoid is __expf and __frcp_rn. K2 keeps the
// one-thread-a-sample fp32 MLP of ode_mlp.cuh: the weights (3,220 floats at
// width 32) in shared memory read as warp-wide broadcasts, state and
// tangents in registers, the sigmoid expf and an IEEE divide. Built without
// --use_fast_math.
//
// Bound: operations. Per sample K1 does ~27k multiply-adds against 108
// bytes of I/O (K2 exact ~89k against 108 bytes), far above the card's
// FLOP-per-byte ridge. Of K1's, 2 x 3 x 32 x 32 a step are tensor-core
// products, 3 passes each: at 495 TFLOP/s TF32 that is ~0.3 ms at 2^20
// samples, against 0.85 ms for all of K1's work on the fp32 CUDA cores
// (67 TFLOP/s). What is left on the CUDA cores, ~400 sigmoids a sample,
// the operand splits and layer 0, is comparable, so neither unit alone
// bounds the kernel. What limits it is latency: a tile's activations,
// accumulators and split operands take ~120 registers, ptxas gives 168 a
// thread (capped at 128 it spills), so 3 blocks of 128 fit an SM, 3 warps a
// scheduler to hide the mma, shared-load and SFU latencies. PERF.md has its
// time, registers and blocks an SM. Both kernels take the condition's part of the first layer (cond_enc @ W0[3:])
// once a sample, and carry the tangents across the steps so K1 and the
// reverse K2 take one 2x2 det at the end (the same function as the product
// of per-step dets, since det is multiplicative).
//
// Layouts: inputs and outputs are plain row-major (N, d) float32 tensors.
// Packed weights, float32, each matrix (in, out) row-major as in the JAX
// package: velocity W0 (25, H), W1..W_{NL-1} (H, H), W_out (H, 2); then base
// W0 (14, 16), b0 (16), W1 (16, 4), b1 (4).

#include "ode_mlp.cuh"
#include "ode_mlp_tc.cuh"

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
// carried tangents -> pdf = N(x0) / det. Rows past n run on a zero condition
// and draw, and store nothing.
template <int H, int NL, bool PRNG>
__global__ void __launch_bounds__(BLOCK)
    sample_pdf_disk_kernel(const float* __restrict__ cond, const float* __restrict__ eps,
                           const long long* __restrict__ seed, const float* __restrict__ w,
                           float* __restrict__ x_out, float* __restrict__ pdf_out,
                           float* __restrict__ x0_out, int n, int T) {
  using C = ode_tc::TcNet<H, NL, 2>;
  extern __shared__ __align__(16) float smem[];
  ode_tc::stage<H, NL, 2>(smem, w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = blockIdx.x * BLOCK + warp * 32;
  if (w0 >= n) return;  // warp-uniform
  const int i = w0 + lane;
  const bool live = i < n;

  float c[CD];
#pragma unroll
  for (int k = 0; k < CD; ++k) c[k] = live ? cond[(size_t)i * CD + k] : 0.0f;
  float o[4];
  base_heads(smem + C::BASE, c, o);
  const float loc[2] = {o[0], o[1]}, ls[2] = {o[2], o[3]};

  float e[2] = {0.0f, 0.0f};
  if (PRNG) {
    normal2((uint64_t)seed[0], (uint64_t)i, e);
  } else if (live) {
    e[0] = eps[2 * (size_t)i];
    e[1] = eps[2 * (size_t)i + 1];
  }
  const float x00 = loc[0] + e[0] * expf(ls[0]);
  const float x01 = loc[1] + e[1] * expf(ls[1]);
  const float log_p0 = -LOG_2PI - ls[0] - ls[1] - 0.5f * (e[0] * e[0] + e[1] * e[1]);

  float* st = smem + C::STATE + warp * 32 * ode_tc::ST;
  st[lane * ode_tc::ST] = x00;
  st[lane * ode_tc::ST + 1] = x01;
  __syncwarp();
  ode_tc::transport_warp<H, NL, 2>(smem, cond, w0, n, T, warp, lane);
  if (!live) return;
  x_out[2 * (size_t)i] = st[lane * ode_tc::ST];
  x_out[2 * (size_t)i + 1] = st[lane * ode_tc::ST + 1];
  pdf_out[i] = expf(log_p0) / st[lane * ode_tc::ST + 2];
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

constexpr size_t K1_SMEM = ode_tc::TcNet<32, 3, 2>::SMEM_FLOATS * sizeof(float);  // 30.8 KB

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
        <<<blocks_for(n), BLOCK, K1_SMEM, s>>>(cond, eps, seed, w, x, pdf, x0, n, T);
  } else {
    sample_pdf_disk_kernel<32, 3, true>
        <<<blocks_for(n), BLOCK, K1_SMEM, s>>>(cond, eps, seed, w, x, pdf, x0, n, T);
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

// Resources of K1's instantiation `which` (0: eps, 1: Philox): out =
// {registers, local bytes, blocks an SM, shared bytes}.
int bsdf_fused_ode_kernel_info(int which, int* out) {
  if (which == 0) return ode_tc::kernel_info(sample_pdf_disk_kernel<32, 3, false>, K1_SMEM, out);
  if (which == 1) return ode_tc::kernel_info(sample_pdf_disk_kernel<32, 3, true>, K1_SMEM, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
