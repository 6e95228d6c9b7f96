// Tensor-core velocity MLP, Euler transport and Newton inverse of every
// fused ODE kernel: the sample+pdf kernels (fused_ode.cu: K1; fused_sph.cu:
// K4), the pdf queries (fused_ode.cu: K2, disk, exact by `newton_tile` or
// reverse; fused_sph.cu: K2s, spherical, exact by `newton_tile`) and the
// generic transport (fused_transport.cu: K3).
//
// Tile. A warp runs 32 samples: one lane a sample for the per-sample scalar
// work (base heads, draw, log p0, det, stores), then two tiles of 16 samples
// for the transport. In a tile each sample is S rows: with the det (S = 3)
// its primal activations and its two forward-mode tangent streams, held at
// the same fragment position of three m16 x H tiles (P, G0, G1); without it
// (S = 1: K3's primal transports, the exact queries' warm starts) the
// primal tile alone, with no silu' products and no det. Row r of each tile
// is sample r of the tile. Lane (g = lane / 4, t = lane % 4) holds rows g
// and g + 8, columns 8 nn + 2 t and 8 nn + 2 t + 1 of each n8 tile nn: the
// accumulator layout of mma.m16n8k8 (c0, c1 row g; c2, c3 row g + 8). So
// silu(z) and silu'(z) * t of one unit are register-local, and the state
// (x, and the 2 x 2 tangent matrix m) of rows g and g + 8 is kept by the
// four lanes of a quad alike.
//
// Fragments. The hidden layers 1..NL-1 (H x H) run on
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32. A layer's output in
// accumulator layout is the next layer's A operand with no shuffle: the k
// index of each k8 chunk kk is permuted, A column t <-> unit 8 kk + 2 t and
// A column t + 4 <-> unit 8 kk + 2 t + 1, so (a0, a1, a2, a3) = (c0, c2, c1,
// c3) of n8 tile kk, and the weights are staged with the same permutation:
// b0 = W[8 kk + 2 t][8 nn + g], b1 = W[8 kk + 2 t + 1][8 nn + g]. They are
// staged once a block, in that fragment order, one float4 (hi b0, hi b1, lo
// b0, lo b1) a lane for each (layer, kk, nn): a warp reads 512 contiguous
// bytes, conflict-free.
//
// Precision: 3xTF32. Each operand is split a = hi + lo, hi =
// cvt.rna.tf32.f32(a), lo = cvt.rna.tf32.f32(a - hi); a product is lo*hi +
// hi*lo + hi*hi into an fp32 accumulator (lo*lo dropped): about fp32
// accuracy (tests/test_torch_tc_precision.py emulates it on the CPU). The
// weights are split when staged, the activations once a layer in
// registers. Single-pass TF32 keeps ~3 decimal digits and would miss the
// kernels' gates.
//
// Steps: forward (alpha = t/T, x += v/T) or reverse (alpha = 1 - t/T,
// x -= v/T, the tangents likewise), a runtime flag. Width H = 8 NT: 32
// (NT = 4) or 64 (NT = 8). A hidden layer is 3 x S x NT^2 mma.sync: 144 at
// width 32 with the det, 48 without it, 192 at width 64 without it.
//
// Thin layers stay on the CUDA cores, written straight into the
// accumulator layout: layer 0's x columns and alpha (K = XE + 1) plus the
// condition's part cp (computed once a sample, kept in the warp's shared
// tile in accumulator order); the output layer (H -> 2), a partial dot a
// lane reduced across the quad with two __shfl_xor_sync. The sigmoid of
// the MLP's units is __expf and a correctly rounded reciprocal (__frcp_rn),
// fewer instructions than expf and an IEEE divide; chip_smoke.py holds
// K1, K2, K4 and K3 to their gates with it, also on weights that move x by
// O(1). The base heads keep ode_mlp.cuh's accurate sigmoid: K4's draw is
// held against its host reproduction.

#pragma once

#include "ode_mlp.cuh"

namespace ode_tc {

using namespace ode;

constexpr int WARPS = BLOCK / 32;  // warps a block, unless a kernel asks for more
constexpr int TILE = 16;          // samples a tile: the rows of an m16 tile
constexpr int TILES = 32 / TILE;  // tiles a warp
constexpr int ST = 3;             // floats a sample in the warp's state tile: x (or x0) and det

// Shared memory of a block of NW warps, in floats: W0 (IN, H), W_out (H, 2)
// and, with HEADS, the base heads row-major as packed; the hidden layers in
// fragment order; per warp, one tile's cp in accumulator order and the 32
// samples' state.
template <int H, int NL, int XE, bool HEADS = true, int NW = WARPS>
struct TcNet {
  using N = Net<H, NL, XE>;
  static_assert(H % 8 == 0, "hidden width must be a multiple of 8");
  static constexpr int NT = H / 8;                         // n8 tiles of an output = k8 chunks of an input
  static constexpr int THREADS = 32 * NW;
  static constexpr int WOUT = N::IN * H;
  static constexpr int BASE = WOUT + 2 * H;
  static constexpr int FRAG = (BASE + (HEADS ? BASE_FLOATS : 0) + 3) / 4 * 4;
  static constexpr int FRAG_LAYER = NT * NT * 32 * 4;      // hi and lo of b0, b1, each lane, each (kk, nn)
  static constexpr int CP = FRAG + (NL - 1) * FRAG_LAYER;
  static constexpr int CP_WARP = NT * 32 * 4;
  static constexpr int STATE = CP + NW * CP_WARP;
  static constexpr int SMEM_FLOATS = STATE + NW * 32 * ST;
  static_assert(WOUT % 4 == 0 && FRAG % 4 == 0, "float4 reads need 16-byte offsets");
};

__device__ __forceinline__ float sigmoid_fast(float z) { return __frcp_rn(1.0f + __expf(-z)); }

__device__ __forceinline__ uint32_t to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

// d += a * b on the tensor cores, TF32 operands, fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block-wide staging of the packed weights (see ode_mlp.cuh) into `s`;
// without HEADS the pack ends at W_out (K3's velocity-only pack).
template <int H, int NL, int XE, bool HEADS = true, int NW = WARPS>
__device__ __forceinline__ void stage(float* s, const float* __restrict__ w) {
  using N = Net<H, NL, XE>;
  using C = TcNet<H, NL, XE, HEADS, NW>;
  constexpr int NT = C::NT, TH = C::THREADS;
  for (int k = threadIdx.x; k < N::WH; k += TH) s[k] = w[k];
  for (int k = threadIdx.x; k < 2 * H + (HEADS ? BASE_FLOATS : 0); k += TH) s[C::WOUT + k] = w[N::WO + k];
  float4* frag = reinterpret_cast<float4*>(s + C::FRAG);
  for (int e = threadIdx.x; e < (NL - 1) * NT * NT * 32; e += TH) {
    const int lane = e & 31, f = e >> 5;  // f = (l NT + kk) NT + nn
    const int nn = f % NT, kk = (f / NT) % NT, l = f / (NT * NT);
    const int g = lane >> 2, t = lane & 3;
    const float* wl = w + N::WH + l * H * H;
    uint32_t h0, l0, h1, l1;
    split(wl[(8 * kk + 2 * t) * H + 8 * nn + g], h0, l0);
    split(wl[(8 * kk + 2 * t + 1) * H + 8 * nn + g], h1, l1);
    frag[e] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0), __uint_as_float(l1));
  }
  __syncthreads();
}

// cp = cond_enc @ W0[XE + 1:] for the tile whose row 0 is sample `row0`,
// this lane's rows and columns, stored in accumulator order: float4 (nn,
// lane) = (row g: c, c + 1; row g + 8: c, c + 1), c = 8 nn + 2 t. Rows at or
// past n read a zero condition.
template <int H, int XE>
__device__ __forceinline__ void cond_proj_tile(const float* s, const float* __restrict__ cond, int row0, int n,
                                               float* cpw, int lane) {
  constexpr int NT = H / 8;
  const int ra = row0 + (lane >> 2), rb = ra + 8, t = lane & 3;
  float acc[NT][4];
#pragma unroll
  for (int nn = 0; nn < NT; ++nn) acc[nn][0] = acc[nn][1] = acc[nn][2] = acc[nn][3] = 0.0f;
#pragma unroll
  for (int k = 0; k < CD; ++k) {
    const float ca = ra < n ? cond[(size_t)ra * CD + k] : 0.0f;
    const float cb = rb < n ? cond[(size_t)rb * CD + k] : 0.0f;
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
      const float2 wv = *reinterpret_cast<const float2*>(s + (XE + 1 + k) * H + 8 * nn + 2 * t);
      acc[nn][0] = fmaf(ca, wv.x, acc[nn][0]);
      acc[nn][1] = fmaf(ca, wv.y, acc[nn][1]);
      acc[nn][2] = fmaf(cb, wv.x, acc[nn][2]);
      acc[nn][3] = fmaf(cb, wv.y, acc[nn][3]);
    }
  }
  float4* dst = reinterpret_cast<float4*>(cpw);
#pragma unroll
  for (int nn = 0; nn < NT; ++nn) dst[nn * 32 + lane] = make_float4(acc[nn][0], acc[nn][1], acc[nn][2], acc[nn][3]);
}

// Layer 0 on the CUDA cores into the accumulator layout: a[0] = silu(z),
// a[1 + k] = silu'(z) * (mi[k] . W0[:XE]) (S = 3 only; mi is not read at
// S = 1), z = x_enc . W0[:XE] + alpha W0[XE] + cp. Element q of a tile is
// row g + 8 (q >> 1), column c + (q & 1).
template <int H, int XE, int S>
__device__ __forceinline__ void layer0_tile(uint32_t sa, uint32_t cpa, const float (&xe)[2][XE],
                                            const float (&mi)[2][2][XE], float alpha, float (&a)[S][H / 8][4],
                                            int lane) {
  static_assert(S == 1 || S == 3, "a tile carries the primal stream, or it and two tangent streams");
  constexpr int NT = H / 8;
  const int t = lane & 3;
#pragma unroll
  for (int nn = 0; nn < NT; ++nn) {
    const int c = 8 * nn + 2 * t;
    const float4 cp4 = lds4(cpa + 16 * (nn * 32 + lane));
    const float cpv[4] = {cp4.x, cp4.y, cp4.z, cp4.w};
    const float2 wa = lds2(sa + 4 * (XE * H + c));
    float2 wx[XE];
#pragma unroll
    for (int k = 0; k < XE; ++k) wx[k] = lds2(sa + 4 * (k * H + c));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = q >> 1, e = q & 1;
      float z = fmaf(alpha, e ? wa.y : wa.x, cpv[q]);
#pragma unroll
      for (int k = XE - 1; k >= 0; --k) z = fmaf(xe[r][k], e ? wx[k].y : wx[k].x, z);
      const float s = sigmoid_fast(z);
      a[0][nn][q] = z * s;
      if constexpr (S == 3) {
        const float wl = e ? wx[XE - 1].y : wx[XE - 1].x;
        float t0 = mi[r][0][XE - 1] * wl, t1 = mi[r][1][XE - 1] * wl;
#pragma unroll
        for (int k = XE - 2; k >= 0; --k) {
          const float wk = e ? wx[k].y : wx[k].x;
          t0 = fmaf(mi[r][0][k], wk, t0);
          t1 = fmaf(mi[r][1][k], wk, t1);
        }
        const float d = s * (1.0f + z * (1.0f - s));
        a[1][nn][q] = d * t0;
        a[2][nn][q] = d * t1;
      }
    }
  }
}

// One hidden layer on the tensor cores, in place: a <- silu(a W) for the
// primal tile, silu'(a_P W) * (a_k W) for the tangent tiles (S = 3). `fl`:
// shared address of the layer's fragments plus this lane's 16 bytes.
template <int NT, int S>
__device__ __forceinline__ void hidden_tc(uint32_t fl, float (&a)[S][NT][4]) {
  float z[S][NT][4];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) z[s][nn][0] = z[s][nn][1] = z[s][nn][2] = z[s][nn][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    uint32_t ah[S][4], al[S][4];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float av[4] = {a[s][kk][0], a[s][kk][2], a[s][kk][1], a[s][kk][3]};  // (c0, c2, c1, c3)
#pragma unroll
      for (int q = 0; q < 4; ++q) split(av[q], ah[s][q], al[s][q]);
    }
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
      const float4 b = lds4(fl + 16 * 32 * (kk * NT + nn));
      const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
      const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        mma_tf32(z[s][nn], al[s], bh0, bh1);
        mma_tf32(z[s][nn], ah[s], bl0, bl1);
        mma_tf32(z[s][nn], ah[s], bh0, bh1);
      }
    }
  }
#pragma unroll
  for (int nn = 0; nn < NT; ++nn)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float zp = z[0][nn][q];
      const float s = sigmoid_fast(zp);
      a[0][nn][q] = zp * s;
      if constexpr (S == 3) {
        const float d = s * (1.0f + zp * (1.0f - s));
        a[1][nn][q] = d * z[1][nn][q];
        a[2][nn][q] = d * z[2][nn][q];
      }
    }
}

// Output layer (H -> 2) on the CUDA cores: o[stream][row][j] for rows g and
// g + 8, each lane's partial dot over its columns summed across the quad
// (every lane of the quad ends with the same sums).
template <int NT, int S>
__device__ __forceinline__ void output_tc(uint32_t wo, const float (&a)[S][NT][4], float (&o)[S][2][2], int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int s = 0; s < S; ++s) o[s][0][0] = o[s][0][1] = o[s][1][0] = o[s][1][1] = 0.0f;
#pragma unroll
  for (int nn = 0; nn < NT; ++nn) {
    const float4 w4 = lds4(wo + 4 * 2 * (8 * nn + 2 * t));  // W_out[c][0], W_out[c][1], W_out[c + 1][0], [1]
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        o[s][r][0] = fmaf(a[s][nn][2 * r + 1], w4.z, fmaf(a[s][nn][2 * r], w4.x, o[s][r][0]));
        o[s][r][1] = fmaf(a[s][nn][2 * r + 1], w4.w, fmaf(a[s][nn][2 * r], w4.y, o[s][r][1]));
      }
  }
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        o[s][r][j] += __shfl_xor_sync(0xffffffffu, o[s][r][j], 1);
        o[s][r][j] += __shfl_xor_sync(0xffffffffu, o[s][r][j], 2);
      }
}

// One velocity evaluation of rows g and g + 8 of one tile: layer 0, the
// hidden layers on the tensor cores, the output layer. o[0][r] is the
// velocity of row r; with S = 3, o[1 + k][r] = J_enc mi[r][k], the
// tangent streams (mi is not read at S = 1). Each lane of a quad ends with
// its rows' sums. `sa`: shared address of the block's weights; `ca`: of
// the warp's cp tile. All 32 lanes must call it together.
template <int H, int NL, int XE, int S, bool HEADS = true, int NW = WARPS>
__device__ __forceinline__ void velocity_tile(uint32_t sa, uint32_t ca, const float (&xe)[2][XE],
                                              const float (&mi)[2][2][XE], float alpha, float (&o)[S][2][2],
                                              int lane) {
  using C = TcNet<H, NL, XE, HEADS, NW>;
  constexpr int NT = C::NT;
  const uint32_t w = fresh(sa), cpa = fresh(ca);
  float a[S][NT][4];
  layer0_tile<H, XE, S>(w, cpa, xe, mi, alpha, a, lane);
#pragma unroll 1
  for (int l = 0; l < NL - 1; ++l) hidden_tc<NT, S>(w + 4 * (C::FRAG + l * C::FRAG_LAYER) + 16 * lane, a);
  output_tc<NT, S>(w + 4 * C::WOUT, a, o, lane);
}

// T Euler steps of rows g and g + 8 of one tile: forward (alpha = t/T,
// x += v/T) or, with `reverse`, alpha = 1 - t/T and x -= v/T. With S = 3
// the two tangent streams ride along (stepped by the same +-1/T) and one
// 2x2 det is taken at the end: det(prod_t (I + sg J_t)) = prod_t det(I +
// sg J_t), since det is multiplicative. With S = 1 det is 0.
template <int H, int NL, int XE, int S = 3, bool HEADS = true, int NW = WARPS>
__device__ __forceinline__ void transport_tile(uint32_t sa, uint32_t ca, float (&s0)[2], float (&s1)[2], int T,
                                               bool reverse, float (&det)[2], int lane) {
  const float h = 1.0f / (float)T;
  const float sg = reverse ? -h : h;
  float m[2][2][2] = {{{1.0f, 0.0f}, {0.0f, 1.0f}}, {{1.0f, 0.0f}, {0.0f, 1.0f}}};
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const float alpha = reverse ? 1.0f - (float)t * h : (float)t * h;
    float xe[2][XE], mi[2][2][XE];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      encode<XE>(s0[r], s1[r], xe[r]);
      if constexpr (S == 3) encode_tangent<XE>(xe[r], m[r], mi[r]);
    }
    float o[S][2][2];
    velocity_tile<H, NL, XE, S, HEADS, NW>(sa, ca, xe, mi, alpha, o, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (S == 3) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          m[r][k][0] += sg * o[1 + k][r][0];
          m[r][k][1] += sg * o[1 + k][r][1];
        }
      }
      s0[r] += sg * o[0][r][0];
      s1[r] += sg * o[0][r][1];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) det[r] = S == 3 ? m[r][0][0] * m[r][1][1] - m[r][1][0] * m[r][0][1] : 0.0f;
}

// Exact pdf queries' inverse of the forward Euler map for rows g and g + 8
// of one tile: for t = T-1..0, y = the target, a reverse-Euler warm start g
// = y - h v(y, t/T), then `newton_iters` closed-form 2x2 Newton updates of g
// for g + h v(g, t/T) = y (a det with |det| <= 1e-20 taken as 1), then
// det(I + h J) at the converged g into det, and y = g. One loop takes both
// the updates and the det, so the kernel holds one S = 3 evaluation and one
// S = 1. The input tangents are the encoded identity: stream k of the S = 3
// evaluation is column k of J, the Jacobian in the state (s0, s1). XE = 2
// (disk: K2) reads the state as it is; XE = 3 (spherical: K2s) through
// `encode` and `encode_tangent`, as `transport_tile` does.
constexpr float DET_GUARD = 1e-20f;  // the JAX package's fused_ode.py:925-926

template <int H, int NL, int XE>
__device__ __forceinline__ void newton_tile(uint32_t sa, uint32_t ca, float (&y0)[2], float (&y1)[2], int T,
                                            int newton_iters, float (&det)[2], int lane) {
  const float eye[2][2] = {{1.0f, 0.0f}, {0.0f, 1.0f}};
  const float h = 1.0f / (float)T;
  det[0] = det[1] = 1.0f;
#pragma unroll 1
  for (int t = T - 1; t >= 0; --t) {
    const float alpha = (float)t * h;
    float xe[2][XE], mi[2][2][XE];
#pragma unroll
    for (int r = 0; r < 2; ++r) encode<XE>(y0[r], y1[r], xe[r]);
    float v[1][2][2];
    velocity_tile<H, NL, XE, 1>(sa, ca, xe, mi, alpha, v, lane);  // S = 1 reads no tangent
    float g0[2], g1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      g0[r] = y0[r] - h * v[0][r][0];
      g1[r] = y1[r] - h * v[0][r][1];
    }
#pragma unroll 1
    for (int it = 0;; ++it) {  // warp-uniform: newton_iters is the same for every lane
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        encode<XE>(g0[r], g1[r], xe[r]);
        encode_tangent<XE>(xe[r], eye, mi[r]);
      }
      float o[3][2][2];
      velocity_tile<H, NL, XE, 3>(sa, ca, xe, mi, alpha, o, lane);
      const bool last = it == newton_iters;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float a = 1.0f + h * o[1][r][0];
        const float b = h * o[2][r][0];
        const float c = h * o[1][r][1];
        const float d = 1.0f + h * o[2][r][1];
        const float dt = a * d - b * c;
        if (last) {
          det[r] *= dt;
        } else {
          const float f0 = g0[r] + h * o[0][r][0] - y0[r];
          const float f1 = g1[r] + h * o[0][r][1] - y1[r];
          const float dg = fabsf(dt) > DET_GUARD ? dt : 1.0f;
          g0[r] -= (d * f0 - b * f1) / dg;
          g1[r] -= (-c * f0 + a * f1) / dg;
        }
      }
      if (last) break;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      y0[r] = g0[r];
      y1[r] = g1[r];
    }
  }
}

// A warp's 32 samples, whose first is `w0`, one tile of 16 at a time; a
// tile wholly at or past n is skipped. For each tile `body(sa, ca, s0, s1,
// det)` maps the state (s0, s1) of the lane's rows g and g + 8, read from
// the warp's state tile `st` (sample j at st[j ST]), to (s0, s1, det),
// written back. `sa`: shared address of the block's weights; `ca`: of the
// warp's cp tile, which holds the tile's condition part. The caller has
// written the state and synced the warp.
template <int H, int NL, int XE, bool HEADS, int NW, typename Body>
__device__ __forceinline__ void for_each_tile(float* smem, const float* __restrict__ cond, int w0, int n, int warp,
                                              int lane, Body&& body) {
  using C = TcNet<H, NL, XE, HEADS, NW>;
  float* cpw = smem + C::CP + warp * C::CP_WARP;
  float* st = smem + C::STATE + warp * 32 * ST;
  const uint32_t sa = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ca = (uint32_t)__cvta_generic_to_shared(cpw);
#pragma unroll 1
  for (int q = 0; q < TILES; ++q) {
    if (w0 + q * TILE >= n) break;  // warp-uniform
    cond_proj_tile<H, XE>(smem, cond, w0 + q * TILE, n, cpw, lane);
    float s0[2], s1[2], det[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = q * TILE + (lane >> 2) + 8 * r;
      s0[r] = st[j * ST];
      s1[r] = st[j * ST + 1];
    }
    __syncwarp();
    body(sa, ca, s0, s1, det);
    __syncwarp();
    if ((lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = q * TILE + (lane >> 2) + 8 * r;
        st[j * ST] = s0[r];
        st[j * ST + 1] = s1[r];
        st[j * ST + 2] = det[r];
      }
    }
  }
  __syncwarp();
}

// The transport of a warp's 32 samples: x0 in and (x, det) out through the
// warp's state tile, as `for_each_tile` says.
template <int H, int NL, int XE, int S = 3, bool HEADS = true, int NW = WARPS>
__device__ __forceinline__ void transport_warp(float* smem, const float* __restrict__ cond, int w0, int n, int T,
                                               int warp, int lane, bool reverse = false) {
  for_each_tile<H, NL, XE, HEADS, NW>(
      smem, cond, w0, n, warp, lane,
      [&](uint32_t sa, uint32_t ca, float (&s0)[2], float (&s1)[2], float (&det)[2]) {
        transport_tile<H, NL, XE, S, HEADS, NW>(sa, ca, s0, s1, T, reverse, det, lane);
      });
}

// Registers, local bytes and blocks an SM of one kernel at `threads` a block
// and `smem` bytes of dynamic shared memory: out = {regs, local bytes, blocks
// an SM, static + dynamic shared bytes}. A kernel above 48 KB must have been
// granted its dynamic shared memory first (cudaFuncSetAttribute).
template <typename K>
int kernel_info(K kernel, size_t smem, int* out, int threads = BLOCK) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = (int)(attr.sharedSizeBytes + smem);
  return 0;
}

}  // namespace ode_tc
