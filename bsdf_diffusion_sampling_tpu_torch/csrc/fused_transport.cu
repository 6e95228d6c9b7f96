// Fused T-step Euler transport kernel (K3) for Hopper.
//
// Replaces the JAX package's `ops/fused_ode.py::_fused_ode_kernel`
// (pallas_call at :373): x_out = T Euler steps of the velocity net from x_in,
// forward (alpha = t/T, x += v/T) or reverse (alpha = 1 - t/T, x -= v/T), on
// the disk (the net reads x) or the spherical domain (the net reads theta,
// sin phi, cos phi), with or without the product of the step dets. Without
// the det the kernel writes 0 there, as the TPU kernel leaves that lane 0.
//
// Instantiated for the nets its callers run: disk 32 x 3 with and without
// the det; spherical 32 x 4 with and without the det (the spherical
// reverse-Euler pdf query and its transport); spherical 64 x 6 without the
// det (rectify's teacher pairs at T = 128). T is a runtime loop.
//
// Bound: operations. A spherical 32 x 4 step with the det is ~9.7k fp32
// multiply-adds against 8 bytes in and 12 out a sample; the 64 x 6 primal
// step ~20.9k. The design is K1's: one thread a sample, the velocity weights
// in shared memory read as broadcasts, the condition's part of layer 0
// computed once a sample and kept in shared memory, state and tangents in
// registers, one det at the end. The 64 x 6 weights (89 KB) and the
// condition part (32 KB) take dynamic shared memory above the 48 KB default.
// No tensor cores.

#include "ode_mlp.cuh"

namespace {

using namespace ode;

template <int H, int NL, int XE, bool JAC>
__global__ void __launch_bounds__(BLOCK)
    transport_kernel(const float* __restrict__ x_in, const float* __restrict__ cond, const float* __restrict__ w,
                     float* __restrict__ x_out, float* __restrict__ det_out, int n, int T, int reverse) {
  using N = Net<H, NL, XE>;
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;
  float* scp = smem + N::VEL;
  stage_weights(sw, w, N::VEL);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;

  float c[CD];
#pragma unroll
  for (int k = 0; k < CD; ++k) c[k] = cond[(size_t)i * CD + k];
  float* cp = scp + threadIdx.x;
  cond_proj<H, XE>(sw, c, cp);
  const uint32_t sa = (uint32_t)__cvta_generic_to_shared(sw);
  const uint32_t ca = (uint32_t)__cvta_generic_to_shared(cp);

  float s0 = x_in[2 * (size_t)i], s1 = x_in[2 * (size_t)i + 1], det;
  transport<H, NL, XE, JAC>(sa, ca, s0, s1, T, reverse != 0, det);
  x_out[2 * (size_t)i] = s0;
  x_out[2 * (size_t)i + 1] = s1;
  det_out[i] = det;
}

template <int H, int NL, int XE, bool JAC>
int launch(const float* x, const float* cond, const float* w, float* x_out, float* det, int n, int T, int reverse,
           cudaStream_t s) {
  using N = Net<H, NL, XE>;
  const size_t smem = (size_t)(N::VEL + H * BLOCK) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(transport_kernel<H, NL, XE, JAC>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  transport_kernel<H, NL, XE, JAC><<<blocks_for(n), BLOCK, smem, s>>>(x, cond, w, x_out, det, n, T, reverse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `xe` is the net's x-input width: 2 (disk) or 3 (spherical). Nets other
// than those listed above are refused with cudaErrorInvalidValue; the Python
// wrapper checks first.
int bsdf_fused_transport(const float* x, const float* cond, const float* w, float* x_out, float* det, int n, int T,
                         int xe, int reverse, int with_jac, int hidden, int layers, void* stream) {
  if (n <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (xe == 2 && hidden == 32 && layers == 3)
    return with_jac ? launch<32, 3, 2, true>(x, cond, w, x_out, det, n, T, reverse, s)
                    : launch<32, 3, 2, false>(x, cond, w, x_out, det, n, T, reverse, s);
  if (xe == 3 && hidden == 32 && layers == 4)
    return with_jac ? launch<32, 4, 3, true>(x, cond, w, x_out, det, n, T, reverse, s)
                    : launch<32, 4, 3, false>(x, cond, w, x_out, det, n, T, reverse, s);
  if (xe == 3 && hidden == 64 && layers == 6 && !with_jac)
    return launch<64, 6, 3, false>(x, cond, w, x_out, det, n, T, reverse, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
