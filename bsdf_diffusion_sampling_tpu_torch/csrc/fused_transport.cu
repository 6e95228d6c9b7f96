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
// det (rectify's teacher pairs at T = 128). T is a runtime loop, and so is
// the direction.
//
// The design is K1's and K4's (ode_mlp_tc.cuh): a warp takes 32 samples
// and runs them as two tiles of 16 through the T steps; the hidden
// products run on mma.sync m16n8k8 in 3xTF32 (fp32 accuracy); layer 0, its
// condition part (once a sample) and the output layer stay on the CUDA
// cores. With the det a sample is three rows of a tile (primal and two
// tangent streams) and one 2x2 det is taken at the end; without it one row,
// and a hidden layer is a third of the products. x0 is read from memory:
// there are no base heads and no draw. Ragged rows run from x0 = 0 on a zero
// condition and store nothing.
//
// Bound: operations. A spherical 32 x 4 step with the det is ~9.7k
// multiply-adds a sample against 8 bytes in and 12 out; the 64 x 6 primal
// step ~20.9k. The 64 x 6 net's five hidden layers of fragments (hi and lo
// of each weight, 32 KB a layer) take 160 KB of shared memory, so its blocks
// are 8 warps, one block an SM, so that more warps share one copy; the
// other nets take blocks of 4 warps, several an SM. The launch bounds name
// those blocks an SM (3 for the 32-wide nets, K1's and K4's with the det;
// 1 for the 64-wide one): without a minimum, ptxas cut the primal nets to
// 64 and 128 registers and spilled a few values to reach them. PERF.md has
// the times, registers and blocks an SM.

#include "ode_mlp.cuh"
#include "ode_mlp_tc.cuh"

namespace {

using namespace ode;

template <int H, int NL, int XE, int NW>
using Tc = ode_tc::TcNet<H, NL, XE, false, NW>;  // velocity only: no base heads

constexpr int NW64 = 8;  // warps a block of the 64 x 6 net

template <int H, int NL, int XE, bool JAC, int NW>
__global__ void __launch_bounds__(32 * NW, NW == NW64 ? 1 : 3)
    transport_kernel(const float* __restrict__ x_in, const float* __restrict__ cond, const float* __restrict__ w,
                     float* __restrict__ x_out, float* __restrict__ det_out, int n, int T, int reverse) {
  using C = Tc<H, NL, XE, NW>;
  extern __shared__ __align__(16) float smem[];
  ode_tc::stage<H, NL, XE, false, NW>(smem, w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = blockIdx.x * C::THREADS + warp * 32;
  if (w0 >= n) return;  // warp-uniform
  const int i = w0 + lane;
  const bool live = i < n;

  float* st = smem + C::STATE + warp * 32 * ode_tc::ST;
  st[lane * ode_tc::ST] = live ? x_in[2 * (size_t)i] : 0.0f;
  st[lane * ode_tc::ST + 1] = live ? x_in[2 * (size_t)i + 1] : 0.0f;
  __syncwarp();
  ode_tc::transport_warp<H, NL, XE, JAC ? 3 : 1, false, NW>(smem, cond, w0, n, T, warp, lane, reverse != 0);
  if (!live) return;
  x_out[2 * (size_t)i] = st[lane * ode_tc::ST];
  x_out[2 * (size_t)i + 1] = st[lane * ode_tc::ST + 1];
  det_out[i] = st[lane * ode_tc::ST + 2];
}

// Grants the kernel its dynamic shared memory where that is above 48 KB.
template <int H, int NL, int XE, bool JAC, int NW>
cudaError_t prepare(size_t& smem) {
  smem = (size_t)Tc<H, NL, XE, NW>::SMEM_FLOATS * sizeof(float);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(transport_kernel<H, NL, XE, JAC, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int H, int NL, int XE, bool JAC, int NW>
int launch(const float* x, const float* cond, const float* w, float* x_out, float* det, int n, int T, int reverse,
           cudaStream_t s) {
  size_t smem;
  const cudaError_t e = prepare<H, NL, XE, JAC, NW>(smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = 32 * NW;
  transport_kernel<H, NL, XE, JAC, NW><<<(n + threads - 1) / threads, threads, smem, s>>>(x, cond, w, x_out, det, n,
                                                                                         T, reverse);
  return (int)cudaGetLastError();
}

template <int H, int NL, int XE, bool JAC, int NW>
int info(int* out) {
  size_t smem;
  const cudaError_t e = prepare<H, NL, XE, JAC, NW>(smem);
  if (e != cudaSuccess) return (int)e;
  return ode_tc::kernel_info(transport_kernel<H, NL, XE, JAC, NW>, smem, out, 32 * NW);
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
    return with_jac ? launch<32, 3, 2, true, 4>(x, cond, w, x_out, det, n, T, reverse, s)
                    : launch<32, 3, 2, false, 4>(x, cond, w, x_out, det, n, T, reverse, s);
  if (xe == 3 && hidden == 32 && layers == 4)
    return with_jac ? launch<32, 4, 3, true, 4>(x, cond, w, x_out, det, n, T, reverse, s)
                    : launch<32, 4, 3, false, 4>(x, cond, w, x_out, det, n, T, reverse, s);
  if (xe == 3 && hidden == 64 && layers == 6 && !with_jac)
    return launch<64, 6, 3, false, NW64>(x, cond, w, x_out, det, n, T, reverse, s);
  return (int)cudaErrorInvalidValue;
}

// Resources of instantiation `which` (0: disk 32 x 3 with the det, 1:
// without; 2: spherical 32 x 4 with the det, 3: without; 4: spherical 64 x 6
// without): out = {registers, local bytes, blocks an SM, shared bytes}.
int bsdf_fused_transport_kernel_info(int which, int* out) {
  switch (which) {
    case 0: return info<32, 3, 2, true, 4>(out);
    case 1: return info<32, 3, 2, false, 4>(out);
    case 2: return info<32, 4, 3, true, 4>(out);
    case 3: return info<32, 4, 3, false, 4>(out);
    case 4: return info<64, 6, 3, false, NW64>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
