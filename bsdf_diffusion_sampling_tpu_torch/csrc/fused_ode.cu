// Fused disk-domain sample+pdf (K1) and pdf-query (K2) kernels for Hopper.
//
// K1 replaces the JAX package's `ops/fused_ode.py::_fused_sample_pdf_kernel`
// (pallas_call at :684); K2 replaces `_fused_pdf_kernel` (pallas_call at :1017)
// with its loops `_disk_ode_loop` and `_disk_pdf_exact_loop`.
//
// Both run the velocity MLP on the tensor cores (ode_mlp_tc.cuh). A warp
// takes 32 samples: one lane a sample for the base heads, the draw, p0 and
// the stores; then two tiles of 16 samples, each sample three rows (primal
// and two forward-mode tangent streams) or one (primal alone), whose two
// hidden 32 x 32 products run on mma.sync m16n8k8 in 3xTF32 (fp32
// accuracy), layer 0 and the output layer on the CUDA cores; the MLP's
// sigmoid is __expf and __frcp_rn. K1 and the reverse K2 carry the tangents
// across the T steps and take one 2x2 det at the end (the same function as
// the product of per-step dets, since det is multiplicative). The exact K2
// solves each forward step for its preimage by Newton in the tile: the
// 2x2 solves are lane-local, since every lane of a quad holds its rows'
// velocity and Jacobian (`ode_tc::newton_tile`, which the spherical exact
// query K2s in fused_sph.cu shares). Built without --use_fast_math.
//
// Bound: operations. Per sample K1 and the reverse K2 do ~27k
// multiply-adds against 108 bytes of I/O, the exact K2 at 2 Newton
// iterations ~89k, far above the card's FLOP-per-byte ridge. Of K1's, 2 x
// 3 x 32 x 32 a step are tensor-core products, 3 passes each: at 495
// TFLOP/s TF32 that is ~0.3 ms at 2^20 samples, against 0.85 ms for all of
// K1's work on the fp32 CUDA cores (67 TFLOP/s). What is left on the CUDA
// cores, ~400 sigmoids a sample, the operand splits and layer 0, is
// comparable, so neither unit alone bounds the kernels. What limits them is
// latency: a tile's activations, accumulators and split operands take
// ~120 registers, so 3 blocks of 128 fit an SM (capped at 128 registers a
// thread they spill), 3 warps a scheduler to hide the mma, shared-load and
// SFU latencies. PERF.md has their times, registers and blocks an SM. Both
// take the condition's part of the first layer (cond_enc @ W0[3:]) once a
// sample.
//
// Layouts: inputs and outputs are plain row-major (N, d) float32 tensors.
// Packed weights, float32, each matrix (in, out) row-major as in the JAX
// package: velocity W0 (25, H), W1..W_{NL-1} (H, H), W_out (H, 2); then base
// W0 (14, 16), b0 (16), W1 (16, 4), b1 (4).

#include "ode_mlp.cuh"
#include "ode_mlp_tc.cuh"

namespace {

using namespace ode;

// Two standard normals for sample `idx` under `seed`: Philox4x32-10 keyed by
// the seed, counter (idx, 0, 0) with idx the sample's global row (the
// launch's row0 + its row); eps_k = Box-Muller on words (2k, 2k+1).
__device__ __forceinline__ void normal2(uint64_t seed, uint64_t idx, float (&e)[2]) {
  uint32_t c[4] = {(uint32_t)idx, (uint32_t)(idx >> 32), 0u, 0u};
  philox4x32_10(c, (uint32_t)seed, (uint32_t)(seed >> 32));
  e[0] = box_muller(c[0], c[1]);
  e[1] = box_muller(c[2], c[3]);
}

// K1: base heads -> x0 = loc + eps * exp(ls) -> T forward Euler steps with
// carried tangents -> pdf = N(x0) / det. Rows past n run on a zero condition
// and draw, and store nothing. The in-kernel draw of row i is that of global
// row row0 + i, so a launch over rows [row0, row0 + n) of a larger batch
// draws what one launch over the whole batch draws for them.
template <int H, int NL, bool PRNG>
__global__ void __launch_bounds__(BLOCK)
    sample_pdf_disk_kernel(const float* __restrict__ cond, const float* __restrict__ eps,
                           const long long* __restrict__ seed, const float* __restrict__ w,
                           float* __restrict__ x_out, float* __restrict__ pdf_out,
                           float* __restrict__ x0_out, int n, int T, long long row0) {
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
    normal2((uint64_t)seed[0], (uint64_t)row0 + (uint64_t)i, e);
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

// K2: pdf of a given x. EXACT: the Newton inverse of the forward map
// (`ode_tc::newton_tile`, shared with K2s), pdf = p0 / prod det. Otherwise
// reverse Euler (alpha = 1 - t/T) with carried tangents, pdf = p0 * det.
// Rows past n run from x = 0 on a zero condition and store nothing.
template <int H, int NL, bool EXACT>
__global__ void __launch_bounds__(BLOCK, 3)
    pdf_disk_kernel(const float* __restrict__ x_in, const float* __restrict__ cond,
                    const float* __restrict__ w, float* __restrict__ pdf_out,
                    float* __restrict__ x0_out, int n, int T, int newton_iters) {
  using C = ode_tc::TcNet<H, NL, 2>;
  extern __shared__ __align__(16) float smem[];
  ode_tc::stage<H, NL, 2>(smem, w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = blockIdx.x * BLOCK + warp * 32;
  if (w0 >= n) return;  // warp-uniform
  const int i = w0 + lane;
  const bool live = i < n;

  float* st = smem + C::STATE + warp * 32 * ode_tc::ST;
  st[lane * ode_tc::ST] = live ? x_in[2 * (size_t)i] : 0.0f;
  st[lane * ode_tc::ST + 1] = live ? x_in[2 * (size_t)i + 1] : 0.0f;
  __syncwarp();
  if constexpr (EXACT) {
    ode_tc::for_each_tile<H, NL, 2, true, ode_tc::WARPS>(
        smem, cond, w0, n, warp, lane,
        [&](uint32_t sa, uint32_t ca, float (&s0)[2], float (&s1)[2], float (&det)[2]) {
          ode_tc::newton_tile<H, NL, 2>(sa, ca, s0, s1, T, newton_iters, det, lane);
        });
  } else {
    ode_tc::transport_warp<H, NL, 2>(smem, cond, w0, n, T, warp, lane, true);
  }
  if (!live) return;

  float c[CD];
#pragma unroll
  for (int k = 0; k < CD; ++k) c[k] = cond[(size_t)i * CD + k];
  float o[4];
  base_heads(smem + C::BASE, c, o);
  const float loc[2] = {o[0], o[1]}, ls[2] = {o[2], o[3]};
  const float y0 = st[lane * ode_tc::ST], y1 = st[lane * ode_tc::ST + 1], det = st[lane * ode_tc::ST + 2];
  const float z0 = (y0 - loc[0]) / expf(ls[0]);
  const float z1 = (y1 - loc[1]) / expf(ls[1]);
  const float p0 = expf(-LOG_2PI - ls[0] - ls[1] - 0.5f * (z0 * z0 + z1 * z1));
  pdf_out[i] = EXACT ? p0 / det : p0 * det;
  x0_out[2 * (size_t)i] = y0;
  x0_out[2 * (size_t)i + 1] = y1;
}

constexpr size_t SMEM = ode_tc::TcNet<32, 3, 2>::SMEM_FLOATS * sizeof(float);  // K1 and K2: 30.8 KB

}  // namespace

extern "C" {

// Widths other than (hidden 32, 3 hidden layers) are refused with
// cudaErrorInvalidValue; the Python wrapper checks first. `row0` is the
// global row of the launch's first sample (the Philox route; 0 for a whole
// batch).
int bsdf_fused_sample_pdf_disk(const float* cond, const float* eps, const long long* seed,
                               long long row0, const float* w, float* x, float* pdf, float* x0,
                               int n, int T, int hidden, int layers, void* stream) {
  if (hidden != 32 || layers != 3 || n <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (eps != nullptr) {
    sample_pdf_disk_kernel<32, 3, false>
        <<<blocks_for(n), BLOCK, SMEM, s>>>(cond, eps, seed, w, x, pdf, x0, n, T, row0);
  } else {
    sample_pdf_disk_kernel<32, 3, true>
        <<<blocks_for(n), BLOCK, SMEM, s>>>(cond, eps, seed, w, x, pdf, x0, n, T, row0);
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
        <<<blocks_for(n), BLOCK, SMEM, s>>>(x, cond, w, pdf, x0, n, T, newton_iters);
  } else {
    pdf_disk_kernel<32, 3, false>
        <<<blocks_for(n), BLOCK, SMEM, s>>>(x, cond, w, pdf, x0, n, T, newton_iters);
  }
  return (int)cudaGetLastError();
}

// Resources of instantiation `which` (0: K1 with eps, 1: K1 with Philox; 2:
// exact K2, 3: reverse K2): out = {registers, local bytes, blocks an SM,
// shared bytes}.
int bsdf_fused_ode_kernel_info(int which, int* out) {
  switch (which) {
    case 0: return ode_tc::kernel_info(sample_pdf_disk_kernel<32, 3, false>, SMEM, out);
    case 1: return ode_tc::kernel_info(sample_pdf_disk_kernel<32, 3, true>, SMEM, out);
    case 2: return ode_tc::kernel_info(pdf_disk_kernel<32, 3, true>, SMEM, out);
    case 3: return ode_tc::kernel_info(pdf_disk_kernel<32, 3, false>, SMEM, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
