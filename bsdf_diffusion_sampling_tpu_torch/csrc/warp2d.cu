// The piecewise-bilinear 2D warp on Hopper, and its two users: the envmap
// emitter (render/envmap.py) and the measured RGL BRDF (bsdf/measured.py).
//
// Replaces no TPU kernel: the JAX package runs bsdf/marginal2d.py and its
// users under XLA. The port's plain versions (bsdf/marginal2d.py,
// render/envmap.py, bsdf/measured.py) are chains of 45 to 858 small
// whole-wavefront PyTorch operations a call, most of them the unrolled
// binary searches over gathered CDF values; here each public entry point
// is one launch, one thread a row:
//   env_sample_kernel   sample_env: warp sample, uv -> direction, bilinear
//                       radiance, solid-angle pdf
//   env_eval_kernel     eval_env
//   env_pdf_kernel      pdf_env
//   brdf_query_kernel   eval_brdf, pdf_brdf, eval_pdf_brdf, eval_lum (MODE):
//                       half vector, spherical coordinates, vndf invert,
//                       luminance eval, rgb / ndf / sigma lookups, Jacobian
//   brdf_sample_kernel  sample_brdf: luminance warp sample, vndf warp
//                       sample, reflect
// All share the warp's device functions (warp_sample, warp_invert,
// warp_eval) over a blend of NSL parameter slices: 1 for the envmap, 2 for
// an isotropic RGL file (the two bracketing theta_i slices), 4 for an
// anisotropic one (the four bracketing (phi_i, theta_i) slices), in the
// order of marginal2d.py::slice_weights. Table sizes are arguments.
//
// What bounds it: neither rate. A row reads ~40 bytes of rows and writes up
// to 16, and its table reads (~15 dependent ones, from tables of under
// 0.4 MB that stay in L2) are latency: each binary-search step waits on the
// previous one. Enough rows in flight (one thread a row, small register
// footprint, tables through the read-only path) hide it.
//
// Every product, sum and difference is rounded on its own (this file is
// built with -fmad=false), in the plain version's order; a division by a
// constant is a product with its reciprocal, as PyTorch computes
// `tensor / python_float` on the card; the 3x3 rotations are FMA chains in
// k order and the 3-element sums add components 0 and 2 first, as the
// card's float32 matrix product and last-dim reduction do. The math
// library's functions are the ones PyTorch's kernels call. So kernel and
// plain version agree on the card to the bit (chip_smoke.py, phase 6b).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr double kPi = 3.141592653589793;

// PyTorch's float32 view of a Python float, and the reciprocal by which it
// multiplies in `tensor / c` on the card: taken in double, then rounded.
__device__ __forceinline__ float f32(double c) { return (float)c; }
__device__ __forceinline__ float inv(double c) { return (float)(1.0 / c); }

// torch.clamp: NaN passes through.
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

struct V3 {
    float x, y, z;
};

// Row i's offsets in size_t: 3 * i and 2 * i pass int32 from 2^31 / 3 rows.
__device__ __forceinline__ V3 load3(const float* p, int i) {
    const size_t o = 3 * size_t(i);
    return {ld(p + o), ld(p + o + 1), ld(p + o + 2)};
}

__device__ __forceinline__ void store3(float* p, int i, V3 v) {
    const size_t o = 3 * size_t(i);
    p[o] = v.x;
    p[o + 1] = v.y;
    p[o + 2] = v.z;
}

// (x, y, z) @ m.T for a row-major 3x3 m.
__device__ __forceinline__ V3 rotate(const float* m, V3 d) {
    V3 r;
    r.x = __fmaf_rn(d.z, ld(m + 2), __fmaf_rn(d.y, ld(m + 1), d.x * ld(m + 0)));
    r.y = __fmaf_rn(d.z, ld(m + 5), __fmaf_rn(d.y, ld(m + 4), d.x * ld(m + 3)));
    r.z = __fmaf_rn(d.z, ld(m + 8), __fmaf_rn(d.y, ld(m + 7), d.x * ld(m + 6)));
    return r;
}

// A sum over 3 components, as the card's last-dim reduction of PyTorch
// adds them: components 0 and 2 first (one thread's), then 1.
__device__ __forceinline__ float dot3(V3 a, V3 b) { return (a.x * b.x + a.z * b.z) + a.y * b.y; }

// ------------------------------------------------------------------ the warp

// One warp's tables, each (P, H, W) or (P, H), float32, contiguous.
struct Warp {
    const float* density;
    const float* cond;
    const float* marg;
    int H, W;
};

// The blended slice set of a row: flat slice index and weight.
template <int NSL>
struct Slices {
    int p[NSL];
    float w[NSL];
};

// marginal2d.py::bracket on an increasing grid of n: (index, weight).
__device__ __forceinline__ void bracket(const float* grid, int n, float v, int& idx, float& w) {
    if (n == 1) {
        idx = 0;
        w = 0.0f;
        return;
    }
    int lo = 0, hi = n;  // torch.searchsorted(right=True)
    while (lo < hi) {
        int mid = lo + ((hi - lo) >> 1);
        if (!(ld(grid + mid) > v)) lo = mid + 1;
        else hi = mid;
    }
    idx = min(max(lo - 1, 0), n - 2);
    float g0 = ld(grid + idx);
    w = clampf((v - g0) / clamp_min(ld(grid + idx + 1) - g0, f32(1e-12)), 0.0f, 1.0f);
}

// marginal2d.py::slice_weights; NSL 1 only for a one-entry theta grid, where
// the plain version's second entry carries weight 0.
template <int NSL>
__device__ __forceinline__ Slices<NSL> slice_weights(const float* tgrid, int Pt, const float* pgrid, int Pp,
                                                     float theta, float phi) {
    Slices<NSL> s;
    int ti;
    float tw;
    bracket(tgrid, Pt, theta, ti, tw);
    int ti1 = min(ti + 1, Pt - 1);
    if constexpr (NSL == 1) {
        s.p[0] = ti;
        s.w[0] = 1.0f - tw;
    } else if constexpr (NSL == 2) {
        s.p[0] = ti;
        s.w[0] = 1.0f - tw;
        s.p[1] = ti1;
        s.w[1] = tw;
    } else {
        int pi;
        float pw;
        bracket(pgrid, Pp, phi, pi, pw);
        int pi1 = min(pi + 1, Pp - 1);
        float t0 = 1.0f - tw;
        s.p[0] = pi * Pt + ti;
        s.w[0] = (1.0f - pw) * t0;
        s.p[1] = pi1 * Pt + ti;
        s.w[1] = pw * t0;
        s.p[2] = pi * Pt + ti1;
        s.w[2] = (1.0f - pw) * tw;
        s.p[3] = pi1 * Pt + ti1;
        s.w[3] = pw * tw;
    }
    return s;
}

// sum over the slices of weight * table[slice, k, j] (j < 0: a (P, H)
// table), k and j clamped to the table as marginal2d.py::_at clamps them.
template <int NSL>
__device__ __forceinline__ float blend(const float* table, int H, int W, const Slices<NSL>& s, int k, int j) {
    k = min(max(k, 0), H - 1);
    float out = 0.0f;
#pragma unroll
    for (int i = 0; i < NSL; ++i) {
        float v = j < 0 ? ld(table + (size_t)s.p[i] * H + k)
                        : ld(table + ((size_t)s.p[i] * H + k) * W + min(max(j, 0), W - 1));
        v = s.w[i] * v;
        out = i == 0 ? v : out + v;
    }
    return out;
}

template <int NSL>
__device__ __forceinline__ float marg_at(const Warp& w, const Slices<NSL>& s, int k) {
    return blend(w.marg, w.H, w.W, s, k, -1);
}

template <int NSL>
__device__ __forceinline__ float row_density(const Warp& w, const Slices<NSL>& s, int k) {
    return blend(w.cond, w.H, w.W, s, k, w.W - 1);
}

template <int NSL>
__device__ __forceinline__ float cond_at(const Warp& w, const Slices<NSL>& s, int k, float t, int j) {
    return (1.0f - t) * blend(w.cond, w.H, w.W, s, k, j) + t * blend(w.cond, w.H, w.W, s, k + 1, j);
}

template <int NSL>
__device__ __forceinline__ float dens_at(const Warp& w, const Slices<NSL>& s, int k, float t, int j) {
    return (1.0f - t) * blend(w.density, w.H, w.W, s, k, j) + t * blend(w.density, w.H, w.W, s, k + 1, j);
}

// marginal2d.py::_invert_linear_cdf, `/ step` as `* (1 / step)`.
__device__ __forceinline__ float invert_linear_cdf(float c0, float d0, float d1, float inv_step, float target) {
    float a = d1 - d0;
    float rhs = clamp_min((target - c0) * inv_step, 0.0f);
    float disc = clamp_min(d0 * d0 + (2.0f * a) * rhs, 0.0f);
    float t = (2.0f * rhs) / clamp_min(d0 + sqrtf(disc), f32(1e-20));
    return clampf(t, 0.0f, 1.0f);
}

__device__ __forceinline__ float eval_linear_cdf(float c0, float d0, float d1, float step, float t) {
    return c0 + step * (d0 * t + ((0.5f * (d1 - d0)) * t) * t);
}

// marginal2d.py::_cell: (cell index, fraction) of x on n vertices.
__device__ __forceinline__ void cell(float x, int n, int& i, float& f) {
    float xf = clampf(x * (float)(n - 1), 0.0f, f32((double)(n - 1) - 1e-6));
    i = min(max((int)xf, 0), n - 1);
    f = xf - (float)i;
}

// The steps of a warp's sizes, as the plain version rounds them.
struct Steps {
    float dx, dy, inv_dx, inv_dy;
};

__device__ __forceinline__ Steps steps(const Warp& w) {
    double dx = 1.0 / (double)(w.W - 1), dy = 1.0 / (double)(w.H - 1);
    return {f32(dx), f32(dy), inv(dx), inv(dy)};
}

// marginal2d.py::warp_sample: pos (x, y) and the density there.
template <int NSL>
__device__ __forceinline__ float warp_sample(const Warp& w, const Slices<NSL>& s, float u1, float u2, float& x,
                                             float& y) {
    const Steps st = steps(w);
    int lo = 0, hi = w.H - 2;
    while (lo < hi) {
        int mid = (lo + hi + 1) >> 1;
        if (marg_at(w, s, mid) <= u2) lo = mid;
        else hi = mid - 1;
    }
    const int k = lo;
    float m0 = row_density(w, s, k), m1 = row_density(w, s, k + 1);
    float t = invert_linear_cdf(marg_at(w, s, k), m0, m1, st.inv_dy, u2);
    y = ((float)k + t) * st.dy;

    float target = u1 * ((1.0f - t) * m0 + t * m1);
    lo = 0;
    hi = w.W - 2;
    while (lo < hi) {
        int mid = (lo + hi + 1) >> 1;
        if (cond_at(w, s, k, t, mid) <= target) lo = mid;
        else hi = mid - 1;
    }
    const int j = lo;
    float d0 = dens_at(w, s, k, t, j), d1 = dens_at(w, s, k, t, j + 1);
    float sx = invert_linear_cdf(cond_at(w, s, k, t, j), d0, d1, st.inv_dx, target);
    x = ((float)j + sx) * st.dx;
    return (1.0f - sx) * d0 + sx * d1;
}

// marginal2d.py::warp_invert: u (u1, u2) of pos (x, y) and the density there.
template <int NSL>
__device__ __forceinline__ float warp_invert(const Warp& w, const Slices<NSL>& s, float x, float y, float& u1,
                                             float& u2) {
    const Steps st = steps(w);
    int k, j;
    float t, sx;
    cell(y, w.H, k, t);
    float m0 = row_density(w, s, k), m1 = row_density(w, s, k + 1);
    u2 = eval_linear_cdf(marg_at(w, s, k), m0, m1, st.dy, t);
    cell(x, w.W, j, sx);
    float d0 = dens_at(w, s, k, t, j), d1 = dens_at(w, s, k, t, j + 1);
    float cx = eval_linear_cdf(cond_at(w, s, k, t, j), d0, d1, st.dx, sx);
    u1 = cx / clamp_min((1.0f - t) * m0 + t * m1, f32(1e-20));
    return (1.0f - sx) * d0 + sx * d1;
}

// marginal2d.py::warp_eval.
template <int NSL>
__device__ __forceinline__ float warp_eval(const Warp& w, const Slices<NSL>& s, float x, float y) {
    int k, j;
    float t, sx;
    cell(y, w.H, k, t);
    cell(x, w.W, j, sx);
    float d0 = dens_at(w, s, k, t, j), d1 = dens_at(w, s, k, t, j + 1);
    return (1.0f - sx) * d0 + sx * d1;
}

// ---------------------------------------------------------------- the envmap

// An envmap: radiance (h, w, 3), its one-slice warp, the two rotations.
struct Env {
    const float* data;
    int h, w;
    Warp warp;
    const float* to_world;
    const float* to_local;
};

// envmap.py::_dir_to_uv of a world direction.
__device__ __forceinline__ void dir_to_uv(const Env& e, V3 d, float& u, float& v) {
    V3 l = rotate(e.to_local, d);
    u = (1.0f + atan2f(l.x, -l.z) * inv(kPi)) * 0.5f;
    v = acosf(clampf(l.y, -1.0f, 1.0f)) * inv(kPi);
}

// envmap.py::eval_env at texture coordinates (u, v).
__device__ __forceinline__ V3 env_radiance(const Env& e, float u, float v) {
    float x = clampf(u * (float)e.w - 0.5f, 0.0f, f32((double)(e.w - 1) - 1e-3));
    float y = clampf(v * (float)e.h - 0.5f, 0.0f, f32((double)(e.h - 1) - 1e-3));
    int x0 = min(max((int)x, 0), e.w - 1), y0 = min(max((int)y, 0), e.h - 1);
    float fx = x - (float)x0, fy = y - (float)y0;
    int x1 = min(x0 + 1, e.w - 1), y1 = min(y0 + 1, e.h - 1);
    const float* a = e.data + 3 * ((size_t)y0 * e.w + x0);
    const float* b = e.data + 3 * ((size_t)y0 * e.w + x1);
    const float* c = e.data + 3 * ((size_t)y1 * e.w + x0);
    const float* d = e.data + 3 * ((size_t)y1 * e.w + x1);
    float out[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        float lo = ld(a + ch) * (1.0f - fx) + ld(b + ch) * fx;
        float hi = ld(c + ch) * (1.0f - fx) + ld(d + ch) * fx;
        out[ch] = lo * (1.0f - fy) + hi * fy;
    }
    return {out[0], out[1], out[2]};
}

// envmap.py::_uv_pdf_to_solid_angle.
__device__ __forceinline__ float uv_pdf_to_solid_angle(float pdf_uv, float v) {
    return pdf_uv / (f32(2.0 * kPi * kPi) * clamp_min(sinf(v * f32(kPi)), f32(1e-6)));
}

__global__ void __launch_bounds__(kThreads) env_sample_kernel(Env e, const float* __restrict__ u2, int n,
                                                              float* __restrict__ d_out, float* __restrict__ rad,
                                                              float* __restrict__ pdf) {
    int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    Slices<1> s;
    s.p[0] = 0;
    s.w[0] = 1.0f;
    float x, y;
    float pdf_uv = warp_sample(e.warp, s, ld(u2 + 2 * size_t(i)), ld(u2 + 2 * size_t(i) + 1), x, y);
    float phi = (2.0f * x - 1.0f) * f32(kPi);
    float theta = y * f32(kPi);
    float st = sinf(theta);
    V3 dl = {st * sinf(phi), cosf(theta), -st * cosf(phi)};
    V3 d = rotate(e.to_world, dl);
    float u, v;
    dir_to_uv(e, d, u, v);
    store3(d_out, i, d);
    store3(rad, i, env_radiance(e, u, v));
    pdf[i] = uv_pdf_to_solid_angle(pdf_uv, y);
}

__global__ void __launch_bounds__(kThreads) env_eval_kernel(Env e, const float* __restrict__ d_in, int n,
                                                            float* __restrict__ rad) {
    int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    float u, v;
    dir_to_uv(e, load3(d_in, i), u, v);
    store3(rad, i, env_radiance(e, u, v));
}

__global__ void __launch_bounds__(kThreads) env_pdf_kernel(Env e, const float* __restrict__ d_in, int n,
                                                           float* __restrict__ pdf) {
    int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    float u, v;
    dir_to_uv(e, load3(d_in, i), u, v);
    Slices<1> s;
    s.p[0] = 0;
    s.w[0] = 1.0f;
    pdf[i] = uv_pdf_to_solid_angle(warp_eval(e.warp, s, u, v), v);
}


// ------------------------------------------------------- the measured BRDF

// A measured BRDF (measured.py::MeasuredBRDF): the two warps, which share
// its (phi_i, theta_i) grids, and its lookup tables.
struct Brdf {
    Warp vndf, lum;
    const float* tgrid;
    int Pt;
    const float* pgrid;  // the phi_i grid, nullptr for an isotropic file
    int Pp;
    const float* rgb;  // (Pp * Pt, 3, rh, rw)
    int rh, rw;
    const float* ndf;  // (2, ndf_w)
    int ndf_w;
    const float* sigma;  // (2, sigma_w)
    int sigma_w;
};

__device__ __forceinline__ float theta2u(float theta) { return sqrtf(clamp_min(theta * f32(2.0 / kPi), 0.0f)); }
__device__ __forceinline__ float phi2u(float phi) { return phi * inv(2.0 * kPi) + 0.5f; }

// measured.py::_spherical.
__device__ __forceinline__ void spherical(V3 w, float& theta, float& phi) {
    theta = acosf(clampf(w.z, -1.0f, 1.0f));
    phi = atan2f(w.y, w.x);
}

// measured.py::_lookup_2d of a (2, wx) table.
__device__ __forceinline__ float lookup_2d(const float* table, int hy, int wx, float ux, float uy) {
    float xf = clampf(ux * (float)(wx - 1), 0.0f, f32((double)(wx - 1) - 1e-6));
    float yf = clampf(uy * (float)(hy - 1), 0.0f, f32((double)(hy - 1) - 1e-6));
    int x0 = min(max((int)xf, 0), wx - 1), y0 = min(max((int)yf, 0), hy - 1);
    float fx = xf - (float)x0, fy = yf - (float)y0;
    int x1 = min(x0 + 1, wx - 1), y1 = min(y0 + 1, hy - 1);
    return ((ld(table + y0 * wx + x0) * (1.0f - fx)) * (1.0f - fy) + (ld(table + y0 * wx + x1) * fx) * (1.0f - fy)) +
           (ld(table + y1 * wx + x0) * (1.0f - fx)) * fy + (ld(table + y1 * wx + x1) * fx) * fy;
}

// measured.py::_rgb_lookup at unit-square s over the row's slices.
template <int NSL>
__device__ __forceinline__ V3 rgb_lookup(const Brdf& b, const Slices<NSL>& s, float sx, float sy) {
    float xf = clampf(sx * (float)(b.rw - 1), 0.0f, f32((double)(b.rw - 1) - 1e-6));
    float yf = clampf(sy * (float)(b.rh - 1), 0.0f, f32((double)(b.rh - 1) - 1e-6));
    int x0 = min(max((int)xf, 0), b.rw - 1), y0 = min(max((int)yf, 0), b.rh - 1);
    float fx = xf - (float)x0, fy = yf - (float)y0;
    int x1 = min(x0 + 1, b.rw - 1), y1 = min(y0 + 1, b.rh - 1);
    const size_t plane = (size_t)b.rh * b.rw;
    float out[3];
#pragma unroll
    for (int i = 0; i < NSL; ++i) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            const float* t = b.rgb + ((size_t)s.p[i] * 3 + ch) * plane;
            float v = ((ld(t + y0 * b.rw + x0) * (1.0f - fx)) * (1.0f - fy) +
                       (ld(t + y0 * b.rw + x1) * fx) * (1.0f - fy)) +
                      (ld(t + y1 * b.rw + x0) * (1.0f - fx)) * fy + (ld(t + y1 * b.rw + x1) * fx) * fy;
            v = s.w[i] * v;
            out[ch] = i == 0 ? v : out[ch] + v;
        }
    }
    return {out[0], out[1], out[2]};
}

// measured.py::_solid_angle_jacobian.
__device__ __forceinline__ float jacobian(float u_x, float theta_m, V3 wo, V3 wm) {
    float dot = fabsf(dot3(wo, wm));
    return (4.0f * dot) * clamp_min((f32(2.0 * kPi * kPi) * u_x) * sinf(theta_m), f32(1e-6));
}

template <int NSL>
__device__ __forceinline__ Slices<NSL> brdf_slices(const Brdf& b, float theta_i, float phi_i) {
    return slice_weights<NSL>(b.tgrid, b.Pt, b.pgrid, b.Pp, theta_i, phi_i);
}

// Which outputs brdf_query_kernel writes.
enum Mode { kEval = 0, kPdf = 1, kEvalPdf = 2, kLum = 3 };

// measured.py::eval_brdf / pdf_brdf / eval_pdf_brdf / eval_lum.
template <int NSL, int MODE>
__global__ void __launch_bounds__(kThreads) brdf_query_kernel(Brdf b, const float* __restrict__ wi_in,
                                                              const float* __restrict__ wo_in, int n,
                                                              float* __restrict__ f_out,
                                                              float* __restrict__ pdf_out) {
    int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    V3 wi = load3(wi_in, i), wo = load3(wo_in, i);
    bool active = (wi.z > 0.0f) & (wo.z > 0.0f);
    V3 h = {wi.x + wo.x, wi.y + wo.y, wi.z + wo.z};
    float norm = clamp_min(sqrtf(dot3(h, h)), f32(1e-12));
    V3 wm = {h.x / norm, h.y / norm, h.z / norm};
    float theta_i, phi_i, theta_m, phi_m;
    spherical(wi, theta_i, phi_i);
    spherical(wm, theta_m, phi_m);
    float u_x = theta2u(theta_m);
    float uy = phi2u(phi_m - phi_i);
    float u_y = uy - floorf(uy);
    Slices<NSL> s = brdf_slices<NSL>(b, theta_i, phi_i);
    float sx, sy;
    float vndf_pdf = warp_invert(b.vndf, s, u_x, u_y, sx, sy);
    if constexpr (MODE != kPdf) {
        V3 fr = rgb_lookup(b, s, sx, sy);
        float d = lookup_2d(b.ndf, 2, b.ndf_w, u_x, u_y);
        float sig = lookup_2d(b.sigma, 2, b.sigma_w, theta2u(theta_i), phi2u(phi_i));
        float ratio = d / clamp_min(4.0f * sig, f32(1e-12));
        fr = {clamp_min(fr.x * ratio, 0.0f), clamp_min(fr.y * ratio, 0.0f), clamp_min(fr.z * ratio, 0.0f)};
        if (!active) fr = {0.0f, 0.0f, 0.0f};
        if constexpr (MODE == kLum) {
            f_out[i] = (f32(0.2126) * fr.x + f32(0.7152) * fr.y) + f32(0.0722) * fr.z;
        } else {
            store3(f_out, i, fr);
        }
    }
    if constexpr (MODE == kPdf || MODE == kEvalPdf) {
        float lum_pdf = warp_eval(b.lum, s, sx, sy);
        float pdf = (vndf_pdf * lum_pdf) / jacobian(u_x, theta_m, wo, wm);
        pdf_out[i] = active ? pdf : 0.0f;
    }
}

// measured.py::sample_brdf.
template <int NSL>
__global__ void __launch_bounds__(kThreads) brdf_sample_kernel(Brdf b, const float* __restrict__ u_in,
                                                               const float* __restrict__ wi_in, int n,
                                                               float* __restrict__ wo_out,
                                                               float* __restrict__ pdf_out) {
    int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    V3 wi = load3(wi_in, i);
    float theta_i, phi_i;
    spherical(wi, theta_i, phi_i);
    Slices<NSL> s = brdf_slices<NSL>(b, theta_i, phi_i);
    float sx, sy, mx, my;
    float lum_pdf = warp_sample(b.lum, s, ld(u_in + 2 * size_t(i)), ld(u_in + 2 * size_t(i) + 1), sx, sy);
    float vndf_pdf = warp_sample(b.vndf, s, sx, sy, mx, my);
    float theta_m = (mx * mx) * f32(kPi / 2.0);
    float phi_m = (my - 0.5f) * f32(2.0 * kPi) + phi_i;
    float st = sinf(theta_m), ct = cosf(theta_m);
    V3 wm = {st * cosf(phi_m), st * sinf(phi_m), ct};
    float k = 2.0f * dot3(wi, wm);
    V3 wo = {k * wm.x - wi.x, k * wm.y - wi.y, k * wm.z - wi.z};
    float pdf = (vndf_pdf * lum_pdf) / jacobian(mx, theta_m, wo, wm);
    store3(wo_out, i, wo);
    pdf_out[i] = (wo.z > 0.0f) & (wi.z > 0.0f) ? pdf : 0.0f;
}

int blocks(int n) { return int((int64_t(n) + kThreads - 1) / kThreads); }

Warp make_warp(const float* density, const float* cond, const float* marg, int H, int W) {
    return {density, cond, marg, H, W};
}

template <int MODE>
int query(int nsl, const Brdf& b, const float* wi, const float* wo, int n, float* f, float* pdf, cudaStream_t s) {
    switch (nsl) {
        case 1: brdf_query_kernel<1, MODE><<<blocks(n), kThreads, 0, s>>>(b, wi, wo, n, f, pdf); break;
        case 2: brdf_query_kernel<2, MODE><<<blocks(n), kThreads, 0, s>>>(b, wi, wo, n, f, pdf); break;
        case 4: brdf_query_kernel<4, MODE><<<blocks(n), kThreads, 0, s>>>(b, wi, wo, n, f, pdf); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

template <typename K>
int info(K kernel, int* out) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return (int)e;
    int nb = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = nb;
    out[3] = (int)attr.sharedSizeBytes;
    return 0;
}

}  // namespace

extern "C" {

// The envmap entry points. `warp` tables (1, H, W), (1, H, W), (1, H);
// `data` (h, w, 3); the rotations row-major 3x3; rows (n, 2) or (n, 3).
// which: 0 sample (u2 -> d, radiance, pdf), 1 eval (d -> radiance), 2 pdf
// (d -> pdf). Returns the launch's CUDA error.
int bsdf_warp2d_env(int which, const float* data, int h, int w, const float* density, const float* cond,
                    const float* marg, int H, int W, const float* to_world, const float* to_local, const float* in,
                    int n, float* d_out, float* rad, float* pdf, void* stream) {
    Env e{data, h, w, make_warp(density, cond, marg, H, W), to_world, to_local};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (which) {
        case 0: env_sample_kernel<<<blocks(n), kThreads, 0, s>>>(e, in, n, d_out, rad, pdf); break;
        case 1: env_eval_kernel<<<blocks(n), kThreads, 0, s>>>(e, in, n, rad); break;
        case 2: env_pdf_kernel<<<blocks(n), kThreads, 0, s>>>(e, in, n, pdf); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// The measured BRDF's entry points. Each warp's tables as above with P =
// Pp * Pt slices; `pgrid` null for an isotropic file; nsl 1, 2 or 4.
// which: 0 eval (f (n, 3)), 1 pdf, 2 eval and pdf, 3 luminance of eval
// (f (n,)), 4 sample (a = u (n, 2), b = wi: f = wo (n, 3), pdf); else a =
// wi, b = wo.
int bsdf_warp2d_brdf(int which, int nsl, const float* v_density, const float* v_cond, const float* v_marg, int vH,
                     int vW, const float* l_density, const float* l_cond, const float* l_marg, int lH, int lW,
                     const float* tgrid, int Pt, const float* pgrid, int Pp, const float* rgb, int rh, int rw,
                     const float* ndf, int ndf_w, const float* sigma, int sigma_w, const float* a, const float* b,
                     int n, float* f, float* pdf, void* stream) {
    Brdf br{make_warp(v_density, v_cond, v_marg, vH, vW), make_warp(l_density, l_cond, l_marg, lH, lW),
            tgrid, Pt, pgrid, Pp, rgb, rh, rw, ndf, ndf_w, sigma, sigma_w};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (which) {
        case kEval: return query<kEval>(nsl, br, a, b, n, f, pdf, s);
        case kPdf: return query<kPdf>(nsl, br, a, b, n, f, pdf, s);
        case kEvalPdf: return query<kEvalPdf>(nsl, br, a, b, n, f, pdf, s);
        case kLum: return query<kLum>(nsl, br, a, b, n, f, pdf, s);
        case 4:
            switch (nsl) {
                case 1: brdf_sample_kernel<1><<<blocks(n), kThreads, 0, s>>>(br, a, b, n, f, pdf); break;
                case 2: brdf_sample_kernel<2><<<blocks(n), kThreads, 0, s>>>(br, a, b, n, f, pdf); break;
                case 4: brdf_sample_kernel<4><<<blocks(n), kThreads, 0, s>>>(br, a, b, n, f, pdf); break;
                default: return (int)cudaErrorInvalidValue;
            }
            return (int)cudaGetLastError();
        default: return (int)cudaErrorInvalidValue;
    }
}

// Resources of kernel `which` (0 env sample, 1 env eval, 2 env pdf, 3
// eval_pdf over 2 slices, 4 over 4, 5 sample over 2, 6 over 4): out =
// {registers, local bytes, blocks an SM, shared bytes} at 256 threads.
int bsdf_warp2d_kernel_info(int which, int* out) {
    switch (which) {
        case 0: return info(env_sample_kernel, out);
        case 1: return info(env_eval_kernel, out);
        case 2: return info(env_pdf_kernel, out);
        case 3: return info(brdf_query_kernel<2, kEvalPdf>, out);
        case 4: return info(brdf_query_kernel<4, kEvalPdf>, out);
        case 5: return info(brdf_sample_kernel<2>, out);
        case 6: return info(brdf_sample_kernel<4>, out);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
