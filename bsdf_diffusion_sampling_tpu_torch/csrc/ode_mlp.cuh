// Device code shared by the fused ODE kernels (fused_ode.cu: K1, K2;
// fused_sph.cu: K4; fused_transport.cu: K3): the net's sizes, the
// base-density heads, the state encoding and its tangent, the
// shared-memory reads, and the in-kernel Philox generator. The velocity
// MLP and the Euler transport run on the tensor cores (ode_mlp_tc.cuh).
//
// Domains differ only in how the state x = (x0, x1) enters the net: the
// disk net reads x as it is (XE = 2 input columns), the spherical nets read
// (theta, sin phi, cos phi) (XE = 3). The velocity input is [x_enc, alpha,
// cond_enc] with cond_enc = PE(omega_i, 5 bands), 22 columns.
//
// Packed weights, float32, each matrix (in, out) row-major as in the JAX
// package: velocity W0 (XE + 23, H), W1..W_{NL-1} (H, H), W_out (H, 2); then,
// for the sampling kernels, base W0 (14, 16), b0 (16), W1 (16, 4), b1 (4).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ode {

constexpr int CD = 22;   // cond_enc dim: PE(omega_i, 5 bands)
constexpr int BIN = 14;  // base heads read cond_enc[:, :14] = PE(omega_i, 3 bands)
constexpr int BH = 16;   // base hidden width
constexpr int BASE_FLOATS = BIN * BH + BH + BH * 4 + 4;
constexpr int BLOCK = 128;
constexpr float LOG_2PI = 1.8378770664093453f;
constexpr float PI = 3.141592653589793f;
constexpr float TWO_PI = 6.283185307179586f;

// Offsets, in floats, of the packed velocity weights.
template <int H, int NL, int XE>
struct Net {
  static constexpr int IN = XE + 1 + CD;            // velocity input width
  static constexpr int WH = IN * H;                 // first hidden->hidden matrix
  static constexpr int WO = WH + (NL - 1) * H * H;  // output matrix (H, 2)
};

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

// Base heads: biased 14 -> 16 (SiLU) -> 4 on cond_enc[:, :14]. Disk: (loc0,
// loc1, ls0, ls1); spherical: (loc_theta, log_scale, loc_phi, conc_raw).
__device__ __forceinline__ void base_heads(const float* bw, const float (&c)[CD], float (&o)[4]) {
  const float* w0 = bw;
  const float* b0 = w0 + BIN * BH;
  const float* w1 = b0 + BH;
  const float* b1 = w1 + BH * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) o[q] = b1[q];
#pragma unroll
  for (int j = 0; j < BH; ++j) {
    float z = b0[j];
#pragma unroll
    for (int k = 0; k < BIN; ++k) z = fmaf(c[k], w0[k * BH + j], z);
    const float a = z * sigmoid(z);
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] = fmaf(a, w1[j * 4 + q], o[q]);
  }
}

// Shared-memory reads by byte address. Each MLP evaluation first passes the
// addresses through `fresh`, an empty asm the compiler cannot see through:
// without it the compiler hoists the loop-invariant weight loads out of the
// ODE loop and spills the hoisted floats to local memory.
__device__ __forceinline__ uint32_t fresh(uint32_t a) {
  asm volatile("" : "+r"(a)::"memory");
  return a;
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

// The net's input columns for state (s0, s1): disk (s0, s1); spherical
// (theta, sin phi, cos phi) with d/dphi (sin phi, cos phi) = (cos phi, -sin phi),
// so state tangent m[k] enters as (m[k][0], cos phi m[k][1], -sin phi m[k][1]).
template <int XE>
__device__ __forceinline__ void encode(float s0, float s1, float (&xe)[XE]);
template <>
__device__ __forceinline__ void encode<2>(float s0, float s1, float (&xe)[2]) {
  xe[0] = s0;
  xe[1] = s1;
}
template <>
__device__ __forceinline__ void encode<3>(float s0, float s1, float (&xe)[3]) {
  xe[0] = s0;
  sincosf(s1, &xe[1], &xe[2]);
}
template <int XE>
__device__ __forceinline__ void encode_tangent(const float (&xe)[XE], const float (&m)[2][2], float (&mi)[2][XE]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    mi[k][0] = m[k][0];
    if (XE == 2) {
      mi[k][1] = m[k][1];
    } else {
      mi[k][1] = xe[XE - 1] * m[k][1];
      mi[k][XE - 1] = -xe[1] * m[k][1];
    }
  }
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

// Top 24 bits -> [0, 1) (the TPU kernels' `fused_ode.py:612-617`).
__device__ __forceinline__ float unit24(uint32_t bits) { return (float)(bits >> 8) * (1.0f / 16777216.0f); }

// Box-Muller on a word pair, u1 clipped to [1e-7, 1 - 1e-7] (fused_ode.py:619-621).
__device__ __forceinline__ float box_muller(uint32_t w1, uint32_t w2) {
  const float u1 = fminf(fmaxf(unit24(w1), 1e-7f), 1.0f - 1e-7f);
  return sqrtf(-2.0f * logf(u1)) * cosf(TWO_PI * unit24(w2));
}

inline int blocks_for(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace ode
