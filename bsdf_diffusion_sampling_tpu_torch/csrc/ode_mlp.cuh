// Device code shared by the fused ODE kernels (fused_ode.cu: K1, K2;
// fused_sph.cu: K4; fused_transport.cu: K3): the velocity MLP with its two
// forward-mode tangent streams, the base-density heads, the Euler transport
// and the in-kernel Philox generator. K1, K4 and K3 take the heads, Philox,
// the state encoding and the shared-memory reads from here and run their
// MLP and transport on the tensor cores (ode_mlp_tc.cuh); the scalar MLP
// and transport below serve K2 alone.
//
// The MLP here runs one thread per sample. The packed weights are staged in
// shared memory once per block and read as warp-wide broadcasts; the ODE
// state and its tangents live in registers; arithmetic is fp32 FMA on the
// CUDA cores.
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

template <int H, int NL, int XE>
struct Net {
  static_assert(H % 4 == 0, "hidden width must be a multiple of 4");
  static constexpr int IN = XE + 1 + CD;            // velocity input width
  static constexpr int WH = IN * H;                 // first hidden->hidden matrix
  static constexpr int WO = WH + (NL - 1) * H * H;  // output matrix (H, 2)
  static constexpr int VEL = WO + H * 2;            // velocity floats
  static constexpr int TOTAL = VEL + BASE_FLOATS;   // with the base heads
};

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

// Block-wide copy of the first `count` packed floats into shared memory.
__device__ __forceinline__ void stage_weights(float* sw, const float* __restrict__ w, int count) {
  for (int k = threadIdx.x; k < count; k += BLOCK) sw[k] = w[k];
  __syncthreads();
}

// cp[j * BLOCK] = (cond_enc @ W0[XE + 1:])[j]: the step-invariant part of layer 0.
template <int H, int XE>
__device__ __forceinline__ void cond_proj(const float* sw, const float (&c)[CD], float* cp) {
#pragma unroll
  for (int j = 0; j < H; ++j) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < CD; ++k) s = fmaf(c[k], sw[(XE + 1 + k) * H + j], s);
    cp[j * BLOCK] = s;
  }
}

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

// Layer-0 pre-activation for unit j: x_enc . W0[:XE, j] + alpha W0[XE, j] + cp[j].
template <int H, int XE>
__device__ __forceinline__ float layer0(uint32_t sa, uint32_t ca, const float (&xe)[XE], float alpha, int j) {
  float z = fmaf(alpha, lds(sa + 4 * (XE * H + j)), lds(ca + 4 * j * BLOCK));
#pragma unroll
  for (int k = XE - 1; k >= 0; --k) z = fmaf(xe[k], lds(sa + 4 * (k * H + j)), z);
  return z;
}

// Velocity at [x_enc, alpha, cond_enc] (primal only). `sa`: shared address
// of the weights; `ca`: shared address of this thread's cp[0], stride BLOCK.
template <int H, int NL, int XE>
__device__ __forceinline__ void mlp_primal(uint32_t sa, uint32_t ca, const float (&xe)[XE], float alpha,
                                           float (&v)[2]) {
  using N = Net<H, NL, XE>;
  sa = fresh(sa);
  ca = fresh(ca);
  float h[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float z = layer0<H, XE>(sa, ca, xe, alpha, j);
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
    const float2 w2 = lds2(wo + 4 * (i * 2));
    v[0] = fmaf(h[i], w2.x, v[0]);
    v[1] = fmaf(h[i], w2.y, v[1]);
  }
}

// Velocity and two forward-mode tangents. mi[k][c] is tangent k of input
// column c (c < XE); tv[k] = J_enc @ mi[k]. Only the XE x columns of layer 0
// carry a tangent.
template <int H, int NL, int XE>
__device__ __forceinline__ void mlp_tangent(uint32_t sa, uint32_t ca, const float (&xe)[XE], float alpha,
                                            const float (&mi)[2][XE], float (&v)[2], float (&tv)[2][2]) {
  using N = Net<H, NL, XE>;
  sa = fresh(sa);
  ca = fresh(ca);
  float h[H], g0[H], g1[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    float wx[XE];
#pragma unroll
    for (int k = 0; k < XE; ++k) wx[k] = lds(sa + 4 * (k * H + j));
    float z = fmaf(alpha, lds(sa + 4 * (XE * H + j)), lds(ca + 4 * j * BLOCK));
#pragma unroll
    for (int k = XE - 1; k >= 0; --k) z = fmaf(xe[k], wx[k], z);
    const float s = sigmoid(z);
    const float d = s * (1.0f + z * (1.0f - s));
    h[j] = z * s;
    float t0 = mi[0][XE - 1] * wx[XE - 1], t1 = mi[1][XE - 1] * wx[XE - 1];
#pragma unroll
    for (int k = XE - 2; k >= 0; --k) {
      t0 = fmaf(mi[0][k], wx[k], t0);
      t1 = fmaf(mi[1][k], wx[k], t1);
    }
    g0[j] = d * t0;
    g1[j] = d * t1;
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
    const float2 w2 = lds2(wo + 4 * (i * 2));
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

// T Euler steps x += sg * v(x, alpha_t) with sg = +-1/T: forward (alpha =
// t/T) or reverse (alpha = 1 - t/T, x -= v/T). With JAC, the two tangent
// streams d(state)/d(x_start) ride along and one 2x2 det is taken at the end:
// det(prod_t (I + sg J_t)) = prod_t det(I + sg J_t), since det is
// multiplicative. Without JAC, det is left 0.
template <int H, int NL, int XE, bool JAC>
__device__ __forceinline__ void transport(uint32_t sa, uint32_t ca, float& s0, float& s1, int T, bool reverse,
                                          float& det) {
  const float h = 1.0f / (float)T;
  const float sg = reverse ? -h : h;
  float m[2][2] = {{1.0f, 0.0f}, {0.0f, 1.0f}};
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const float alpha = reverse ? 1.0f - (float)t * h : (float)t * h;
    float xe[XE], v[2];
    encode<XE>(s0, s1, xe);
    if (JAC) {
      float mi[2][XE], tv[2][2];
      encode_tangent<XE>(xe, m, mi);
      mlp_tangent<H, NL, XE>(sa, ca, xe, alpha, mi, v, tv);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        m[k][0] += sg * tv[k][0];
        m[k][1] += sg * tv[k][1];
      }
    } else {
      mlp_primal<H, NL, XE>(sa, ca, xe, alpha, v);
    }
    s0 += sg * v[0];
    s1 += sg * v[1];
  }
  det = JAC ? m[0][0] * m[1][1] - m[1][0] * m[0][1] : 0.0f;
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
