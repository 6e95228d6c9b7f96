// K5: closest-hit and any-hit traversal of the 8-wide BVH table on Hopper.
//
// Replaces the JAX package's render/traverse8.py:251 _traverse_kernel and
// :63 _turn (pallas_call :383). The TPU kernel walks packets of S x 128 rays
// with one shared scalar stack and G DMA slots in flight; here one thread
// walks one ray with its own stack (STACK8_DEPTH = 64 entries, 256 bytes of
// local memory), reading the 64-byte table rows it visits as four float4
// loads through the read-only cache. See render/traverse8.py for the
// contract and bvh8.py for the table layout:
//   node row: lanes 0:3 lo, 3:6 hi, 12 child base row, 13 child flags
//   tri row:  lanes 0:3 v0, 3:6 e1, 6:9 e2, 9 prim id
//   meta word: base row in bits 0..24, flags ((count-1)<<3 | axis<<1 | leaf)
//   from bit 25.
//
// What bounds it: the larger of the slab and triangle operations over the
// fp32 rate and the rays' bytes (57 a ray) over the memory rate; the two
// come out close at the render's rays. chip_smoke.py works the bound out
// from the plain walker's visit and test counts. The kernel runs far above
// it, latency-bound on each ray's chain of dependent row loads. This first
// version spends nothing on coherence: no compact node layout, no
// warp-level traversal, no persistent threads.
//
// Every product, sum and difference is rounded on its own (__fmul_rn and
// friends are never contracted into FMAs), in the order the plain PyTorch
// walker computes them, so kernel and plain version agree to the bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStack = 64;        // STACK8_DEPTH
constexpr int kMaxVisits = 8192;  // MAX_VISITS
constexpr unsigned kBaseMask = (1u << 25) - 1u;
constexpr float kInf = 1e30f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float4 row4(const float* table, unsigned row, int lane) {
    return __ldg(reinterpret_cast<const float4*>(table + 16 * (size_t)row + lane));
}

template <bool kAnyHit>
__global__ void __launch_bounds__(128) traverse8_kernel(
    const float* __restrict__ table, unsigned root_meta, const float* __restrict__ ro,
    const float* __restrict__ rd, const float* __restrict__ ird, const float* __restrict__ t_max,
    const uint8_t* __restrict__ active, int n, float* __restrict__ t_out, int* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out, int* __restrict__ n_trunc) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float t_best = -kInf, hu = 0.0f, hv = 0.0f;
    int prim = -1;
    if (active[i]) {
        const float ox = ro[3 * i], oy = ro[3 * i + 1], oz = ro[3 * i + 2];
        const float dx = rd[3 * i], dy = rd[3 * i + 1], dz = rd[3 * i + 2];
        const float ix = ird[3 * i], iy = ird[3 * i + 1], iz = ird[3 * i + 2];
        const float tm = t_max[i];
        const float t_stop = mul(tm, 0.9999f);
        t_best = tm;
        unsigned stack[kStack];
        int sp = 0, visits = 0;
        bool truncated = false;
        unsigned cur = root_meta;
        while (true) {
            const unsigned base = cur & kBaseMask;
            const unsigned flags = cur >> 25;
            const int cnt = (int)((flags >> 3) & 7u) + 1;
            if (flags & 1u) {
                // leaf: the nearest valid triangle, ties to the largest prim
                float lt = kInf, lu = 0.0f, lv = 0.0f;
                int lp = -1;
                for (int k = 0; k < cnt; ++k) {
                    const float4 a = row4(table, base + k, 0);
                    const float4 b = row4(table, base + k, 4);
                    const float4 c = row4(table, base + k, 8);
                    const float v0x = a.x, v0y = a.y, v0z = a.z;
                    const float e1x = a.w, e1y = b.x, e1z = b.y;
                    const float e2x = b.z, e2y = b.w, e2z = c.x;
                    const float px = sub(mul(dy, e2z), mul(dz, e2y));
                    const float py = sub(mul(dz, e2x), mul(dx, e2z));
                    const float pz = sub(mul(dx, e2y), mul(dy, e2x));
                    const float det = add(add(mul(e1x, px), mul(e1y, py)), mul(e1z, pz));
                    const bool ok_det = fabsf(det) > 1e-12f;
                    const float inv_det = ok_det ? __fdiv_rn(1.0f, det) : 0.0f;
                    const float sx = sub(ox, v0x), sy = sub(oy, v0y), sz = sub(oz, v0z);
                    const float u = mul(add(add(mul(sx, px), mul(sy, py)), mul(sz, pz)), inv_det);
                    const float qx = sub(mul(sy, e1z), mul(sz, e1y));
                    const float qy = sub(mul(sz, e1x), mul(sx, e1z));
                    const float qz = sub(mul(sx, e1y), mul(sy, e1x));
                    const float v = mul(add(add(mul(dx, qx), mul(dy, qy)), mul(dz, qz)), inv_det);
                    const float t = mul(add(add(mul(e2x, qx), mul(e2y, qy)), mul(e2z, qz)), inv_det);
                    const int p = (int)c.y;
                    const bool valid = ok_det && u >= 0.0f && v >= 0.0f && add(u, v) <= 1.0f &&
                                       t > 1e-4f && t < t_best;
                    if (valid && (t < lt || (t == lt && p > lp))) {
                        lt = t; lp = p; lu = u; lv = v;
                    }
                }
                if (lp >= 0) {
                    t_best = lt; prim = lp; hu = lu; hv = lv;
                }
            } else {
                // inner: slab-test the children, push the hit ones far to
                // near along the node's sort axis (nearest on top)
                const unsigned axis = (flags >> 1) & 3u;
                const float dax = axis == 0 ? dx : (axis == 1 ? dy : dz);
                const bool sign_pos = dax > 0.0f;
                for (int j = 0; j < 8; ++j) {
                    const int k = sign_pos ? 7 - j : j;
                    if (k >= cnt) continue;
                    const float4 a = row4(table, base + k, 0);
                    const float4 b = row4(table, base + k, 4);
                    const float t0x = mul(sub(a.x, ox), ix), t1x = mul(sub(a.w, ox), ix);
                    const float t0y = mul(sub(a.y, oy), iy), t1y = mul(sub(b.x, oy), iy);
                    const float t0z = mul(sub(a.z, oz), iz), t1z = mul(sub(b.y, oz), iz);
                    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
                    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
                    if (tn <= tf && tf > 1e-5f && tn < t_best) {
                        const float4 m = row4(table, base + k, 12);
                        if (sp < kStack) {
                            stack[sp++] = ((unsigned)m.y << 25) | (unsigned)m.x;
                        } else {
                            truncated = true;
                        }
                    }
                }
            }
            ++visits;
            if (kAnyHit && t_best < t_stop) break;
            if (sp == 0) break;
            if (visits >= kMaxVisits) {
                truncated = true;
                break;
            }
            cur = stack[--sp];
        }
        if (truncated) atomicAdd(n_trunc, 1);
    }
    t_out[i] = t_best;
    prim_out[i] = prim;
    u_out[i] = hu;
    v_out[i] = hv;
}

}  // namespace

extern "C" int bsdf_traverse8(const float* table, unsigned root_meta, const float* ro, const float* rd,
                              const float* ird, const float* t_max, const uint8_t* active, int n,
                              int any_hit, float* t_out, int* prim_out, float* u_out, float* v_out,
                              int* n_trunc, void* stream) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (any_hit) {
        traverse8_kernel<true><<<blocks, threads, 0, s>>>(table, root_meta, ro, rd, ird, t_max, active, n,
                                                          t_out, prim_out, u_out, v_out, n_trunc);
    } else {
        traverse8_kernel<false><<<blocks, threads, 0, s>>>(table, root_meta, ro, rd, ird, t_max, active,
                                                           n, t_out, prim_out, u_out, v_out, n_trunc);
    }
    return (int)cudaGetLastError();
}
