// K5: closest-hit and any-hit traversal of the 8-wide BVH on Hopper.
//
// Replaces the JAX package's render/traverse8.py:251 _traverse_kernel and
// :63 _turn (pallas_call :383). The TPU kernel walks packets of S x 128 rays
// with one shared scalar stack and G DMA slots in flight; here one thread
// walks one ray with its own stack of STACK8_DEPTH = 64 entries, and the
// warps are persistent (Aila & Laine 2009): as many as fit on the card,
// each taking the next 32 rays from a counter when its last ray ends, so a
// warp slot is not held by the slowest warp of a block. See
// render/traverse8.py for the contract and render/bvh8.py for the packed
// layout the kernel reads (the plain walker reads the row table):
//   node record (256 bytes, one a child block): lo x, lo y, lo z, hi x,
//     hi y, hi z of the 8 children (8 floats each), their 8 meta words, pad
//   tri record (48 bytes): v0, e1, e2, prim id (as a float)
//   meta word: base in bits 0..24 (a node record, or a leaf's first tri
//     record), flags ((count-1)<<3 | axis<<1 | leaf) from bit 25.
//
// What bounds it: the larger of the slab and triangle operations over the
// fp32 rate and the bytes (the rays' 57 each, the packed layout once) over
// the memory rate; chip_smoke.py works the bound out from the plain walker's
// visit and test counts. The kernel runs far above it: it is latency-bound
// on each ray's chain of dependent node visits, and a warp runs as long as
// its longest ray. The packed layout shortens each link of the chain: a
// node visit is 14 independent 16-byte loads of one record (two 128-byte
// lines), all issued before any slab test, where the row table needed two
// loads a child and then a third, dependent one for each hit child's meta.
// The stack stays in local memory (256 bytes a thread, mostly in L1): a
// `[depth][thread]` stack in shared memory (32 KB a block of 128) ran 14%
// slower on the H100, with 6 blocks an SM against 8 and less L1 left to the
// records (PERF.md, PR 5).
//
// Every product, sum and difference is rounded on its own (__fmul_rn and
// friends are never contracted into FMAs), in the order the plain PyTorch
// walker computes them, and the children are pushed in its order, so kernel
// and plain version agree to the bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 64;        // STACK8_DEPTH
constexpr int kMaxVisits = 8192;  // MAX_VISITS
constexpr unsigned kBaseMask = (1u << 25) - 1u;
constexpr float kInf = 1e30f;
constexpr int kRecord = 16;  // int4 a node record
constexpr int kTri = 3;      // float4 a tri record

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Component c of v; c is a constant once the loops are unrolled.
__device__ __forceinline__ int comp(const int4& v, int c) { return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w; }

// Field f (0..6: lo x, lo y, lo z, hi x, hi y, hi z, meta) of child k.
__device__ __forceinline__ int field(const int4 (&q)[14], int f, int k) { return comp(q[2 * f + (k >> 2)], k & 3); }

// Ray i's walk and its outputs.
template <bool kAnyHit>
__device__ __forceinline__ void trace(
    int i, const int4* __restrict__ nodes, const float4* __restrict__ tris, unsigned root_meta,
    const float* __restrict__ ro, const float* __restrict__ rd, const float* __restrict__ ird,
    const float* __restrict__ t_max, const uint8_t* __restrict__ active, float* __restrict__ t_out,
    int* __restrict__ prim_out, float* __restrict__ u_out, float* __restrict__ v_out, int* __restrict__ n_trunc) {
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
        auto push = [&](unsigned m) {
            if (sp < kStack) {
                stack[sp++] = m;
            } else {
                truncated = true;
            }
        };
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
                    const float4* tr = tris + kTri * (size_t)(base + k);
                    const float4 a = __ldg(tr), b = __ldg(tr + 1), c = __ldg(tr + 2);
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
                // inner: the whole record in 14 independent loads, slab-test
                // the children, push the hit ones far to near along the
                // node's sort axis (nearest on top)
                const int4* rec = nodes + kRecord * (size_t)base;
                int4 q[14];
#pragma unroll
                for (int j = 0; j < 14; ++j) q[j] = __ldg(rec + j);
                unsigned hit = 0;
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    const float t0x = mul(sub(__int_as_float(field(q, 0, k)), ox), ix);
                    const float t1x = mul(sub(__int_as_float(field(q, 3, k)), ox), ix);
                    const float t0y = mul(sub(__int_as_float(field(q, 1, k)), oy), iy);
                    const float t1y = mul(sub(__int_as_float(field(q, 4, k)), oy), iy);
                    const float t0z = mul(sub(__int_as_float(field(q, 2, k)), oz), iz);
                    const float t1z = mul(sub(__int_as_float(field(q, 5, k)), oz), iz);
                    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
                    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
                    if (k < cnt && tn <= tf && tf > 1e-5f && tn < t_best) hit |= 1u << k;
                }
                const unsigned axis = (flags >> 1) & 3u;
                const float dax = axis == 0 ? dx : (axis == 1 ? dy : dz);
                if (dax > 0.0f) {
#pragma unroll
                    for (int k = 7; k >= 0; --k)
                        if ((hit >> k) & 1u) push((unsigned)field(q, 6, k));
                } else {
#pragma unroll
                    for (int k = 0; k < 8; ++k)
                        if ((hit >> k) & 1u) push((unsigned)field(q, 6, k));
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

// Persistent warps: each takes the next 32 rays from the counter `next`.
template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) traverse8_kernel(
    const int4* __restrict__ nodes, const float4* __restrict__ tris, unsigned root_meta,
    const float* __restrict__ ro, const float* __restrict__ rd, const float* __restrict__ ird,
    const float* __restrict__ t_max, const uint8_t* __restrict__ active, int n, float* __restrict__ t_out,
    int* __restrict__ prim_out, float* __restrict__ u_out, float* __restrict__ v_out, int* __restrict__ n_trunc,
    int* __restrict__ next) {
    const int lane = threadIdx.x & 31;
    while (true) {
        int first = 0;
        if (lane == 0) first = atomicAdd(next, 32);
        first = __shfl_sync(0xffffffffu, first, 0);
        if (first >= n) return;
        if (first + lane < n)
            trace<kAnyHit>(first + lane, nodes, tris, root_meta, ro, rd, ird, t_max, active, t_out, prim_out, u_out,
                           v_out, n_trunc);
    }
}

// As many blocks as fit on the card at once, and no more than the rays need.
template <bool kAnyHit>
int launch(const int* nodes, const float* tris, unsigned root_meta, const float* ro, const float* rd,
           const float* ird, const float* t_max, const uint8_t* active, int n, float* t_out, int* prim_out,
           float* u_out, float* v_out, int* n_trunc, int* next, cudaStream_t s) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, traverse8_kernel<kAnyHit>, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    const int need = (n + kThreads - 1) / kThreads;
    const int blocks = need < sms * per_sm ? need : sms * per_sm;
    traverse8_kernel<kAnyHit><<<blocks, kThreads, 0, s>>>(
        reinterpret_cast<const int4*>(nodes), reinterpret_cast<const float4*>(tris), root_meta, ro, rd, ird, t_max,
        active, n, t_out, prim_out, u_out, v_out, n_trunc, next);
    return (int)cudaGetLastError();
}

template <typename K>
int info(K kernel, int* out) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = blocks;
    out[3] = (int)attr.sharedSizeBytes;
    return 0;
}

}  // namespace

extern "C" {

// `nodes` (n_blocks, 64) int32 and `tris` (n_prims, 12) float32 as
// render/bvh8.py packs them, 16-byte aligned; `root_meta` the packed root;
// `next` a zeroed int the warps take their rays from.
int bsdf_traverse8(const int* nodes, const float* tris, unsigned root_meta, const float* ro, const float* rd,
                   const float* ird, const float* t_max, const uint8_t* active, int n, int any_hit, float* t_out,
                   int* prim_out, float* u_out, float* v_out, int* n_trunc, int* next, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return any_hit ? launch<true>(nodes, tris, root_meta, ro, rd, ird, t_max, active, n, t_out, prim_out, u_out,
                                  v_out, n_trunc, next, s)
                   : launch<false>(nodes, tris, root_meta, ro, rd, ird, t_max, active, n, t_out, prim_out, u_out,
                                   v_out, n_trunc, next, s);
}

// Resources of instantiation `which` = any_hit: out = {registers, local
// bytes, blocks an SM, shared bytes} at 128 threads.
int bsdf_traverse8_kernel_info(int which, int* out) {
    switch (which) {
        case 0: return info(traverse8_kernel<false>, out);
        case 1: return info(traverse8_kernel<true>, out);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
