// Native BVH builder: top-down binned SAH, C ABI for ctypes.
//
// The Python/numpy recursive builder in render/bvh.py takes minutes on the
// 61k-triangle matpreview scene (one numpy dispatch per node); this C++
// version builds in milliseconds. Splits use the binned surface-area
// heuristic (16 bins on the longest centroid axis, cost = C_trav +
// SA_l/SA * n_l + SA_r/SA * n_r), falling back to a median split when
// binning degenerates — SAH matters doubly on TPU because the lockstep
// wavefront traversal's iteration count is set by the WORST ray, so tree
// quality bounds the whole wavefront. Node layout expected by the device
// traversal:
//   - DFS preorder node order; an inner node's left child is node+1
//   - inner nodes store the RIGHT child index in `left[]`, count[] == 0
//   - leaves store the first reordered-primitive index in `left[]`,
//     count[] == primitive count (<= max_leaf)
//   - prims[] is the primitive permutation (leaf ranges contiguous)
//
// Build: g++ -O2 -shared -fPIC bvh_build.cpp -o libbvh_build.so

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

constexpr int kBins = 16;
// Beyond this depth SAH is abandoned for balanced median splits: SAH can
// produce arbitrarily lopsided partitions, but the device traversal stack
// is fixed (STACK_DEPTH in render/bvh.py) and silently drops pushes on
// overflow. Median splits from depth d bound total depth by
// d + ceil(log2(n / max_leaf)); with the 2^24 primitive cap enforced in
// build_bvh this keeps max depth <= 24 + 22 = 46 < STACK_DEPTH(48). Also
// bounds the host-side build recursion.
constexpr int kSahDepthLimit = 24;

struct Box {
    float mn[3] = {1e30f, 1e30f, 1e30f};
    float mx[3] = {-1e30f, -1e30f, -1e30f};
    void grow(const float* l, const float* h) {
        for (int a = 0; a < 3; ++a) {
            mn[a] = std::min(mn[a], l[a]);
            mx[a] = std::max(mx[a], h[a]);
        }
    }
    void grow(const Box& o) { grow(o.mn, o.mx); }
    float half_area() const {
        float dx = std::max(mx[0] - mn[0], 0.0f);
        float dy = std::max(mx[1] - mn[1], 0.0f);
        float dz = std::max(mx[2] - mn[2], 0.0f);
        return dx * dy + dy * dz + dz * dx;
    }
};

struct Builder {
    const float *lo, *hi;   // (n, 3) per-prim bounds
    std::vector<float> cen; // (n, 3) centroids
    int max_leaf;
    // outputs
    float *bb_min, *bb_max;
    int32_t *left, *count;
    int64_t *prims;
    int n_nodes = 0;
    int64_t cursor = 0;
    int max_depth = 0;

    int new_node() { return n_nodes++; }

    void make_leaf(int node, int64_t* idx, int64_t n) {
        left[node] = (int32_t)cursor;
        count[node] = (int32_t)n;
        for (int64_t i = 0; i < n; ++i) prims[cursor++] = idx[i];
    }

    int build(int64_t* idx, int64_t n, int depth) {
        int node = new_node();
        max_depth = std::max(max_depth, depth);
        Box bounds;
        for (int64_t i = 0; i < n; ++i)
            bounds.grow(lo + 3 * idx[i], hi + 3 * idx[i]);
        for (int a = 0; a < 3; ++a) {
            bb_min[3 * node + a] = bounds.mn[a];
            bb_max[3 * node + a] = bounds.mx[a];
        }
        if (n <= max_leaf) {
            make_leaf(node, idx, n);
            return node;
        }

        // centroid bounds + longest axis
        float cmn[3] = {1e30f, 1e30f, 1e30f};
        float cmx[3] = {-1e30f, -1e30f, -1e30f};
        for (int64_t i = 0; i < n; ++i) {
            const float* c = cen.data() + 3 * idx[i];
            for (int a = 0; a < 3; ++a) {
                cmn[a] = std::min(cmn[a], c[a]);
                cmx[a] = std::max(cmx[a], c[a]);
            }
        }
        int axis = 0;
        float ext = cmx[0] - cmn[0];
        for (int a = 1; a < 3; ++a) {
            if (cmx[a] - cmn[a] > ext) {
                ext = cmx[a] - cmn[a];
                axis = a;
            }
        }

        int64_t mid = -1;
        if (ext > 1e-12f && depth < kSahDepthLimit) {
            // binned SAH along the longest axis
            Box bin_box[kBins];
            int64_t bin_cnt[kBins] = {0};
            const float scale = kBins / ext;
            auto bin_of = [&](int64_t p) {
                int b = (int)((cen[3 * p + axis] - cmn[axis]) * scale);
                return std::min(std::max(b, 0), kBins - 1);
            };
            for (int64_t i = 0; i < n; ++i) {
                int b = bin_of(idx[i]);
                bin_box[b].grow(lo + 3 * idx[i], hi + 3 * idx[i]);
                bin_cnt[b]++;
            }
            // sweep: suffix areas, then prefix scan picking min cost
            float right_area[kBins];
            Box acc;
            int64_t right_n[kBins];
            int64_t rn = 0;
            for (int b = kBins - 1; b > 0; --b) {
                acc.grow(bin_box[b]);
                rn += bin_cnt[b];
                right_area[b] = acc.half_area();
                right_n[b] = rn;
            }
            Box lacc;
            int64_t ln = 0;
            float best_cost = 1e30f;
            int best_split = -1;
            const float inv_root = 1.0f / std::max(bounds.half_area(), 1e-30f);
            for (int b = 1; b < kBins; ++b) {
                lacc.grow(bin_box[b - 1]);
                ln += bin_cnt[b - 1];
                if (ln == 0 || right_n[b] == 0) continue;
                float cost = 1.0f + (lacc.half_area() * ln +
                                     right_area[b] * right_n[b]) * inv_root;
                if (cost < best_cost) {
                    best_cost = cost;
                    best_split = b;
                }
            }
            float leaf_cost = (float)n;
            if (best_split > 0 &&
                (best_cost < leaf_cost || n > max_leaf)) {
                int64_t* it = std::partition(
                    idx, idx + n,
                    [&](int64_t p) { return bin_of(p) < best_split; });
                mid = it - idx;
                if (mid == 0 || mid == n) mid = -1;  // degenerate partition
            }
        }
        if (mid < 0) {  // fallback: median split
            mid = n / 2;
            const float* c = cen.data();
            std::nth_element(idx, idx + mid, idx + n,
                             [c, axis](int64_t a, int64_t b) {
                                 return c[3 * a + axis] < c[3 * b + axis];
                             });
        }

        build(idx, mid, depth + 1);  // left child == node + 1
        int r = build(idx + mid, n - mid, depth + 1);
        left[node] = (int32_t)r;
        count[node] = 0;
        return node;
    }
};

}  // namespace

extern "C" {

// Returns the node count; caller provides arrays sized for 2*n nodes.
// *max_depth_out receives the deepest node's depth (root = 0) so the
// caller can assert it fits the fixed device traversal stack.
int bvh_build(const float *lo, const float *hi, int64_t n, int max_leaf,
              float *bb_min, float *bb_max, int32_t *left, int32_t *count,
              int64_t *prims, int32_t *max_depth_out) {
    Builder b;
    b.lo = lo;
    b.hi = hi;
    b.max_leaf = max_leaf;
    b.cen.resize(3 * n);
    for (int64_t i = 0; i < 3 * n; ++i) b.cen[i] = 0.5f * (lo[i] + hi[i]);
    b.bb_min = bb_min;
    b.bb_max = bb_max;
    b.left = left;
    b.count = count;
    b.prims = prims;
    std::vector<int64_t> idx(n);
    for (int64_t i = 0; i < n; ++i) idx[i] = i;
    b.build(idx.data(), n, 0);
    *max_depth_out = b.max_depth;
    return b.n_nodes;
}

}  // extern "C"
