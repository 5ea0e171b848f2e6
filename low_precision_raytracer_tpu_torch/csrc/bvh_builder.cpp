// Host BVH builder, C++: a median-split BVH over primitives (a copy of the
// JAX package's native/bvh_builder.cpp, built and loaded by
// low_precision_raytracer_tpu_torch/models/native.py).
//
// The same topology rules as models/bvh.py:build_bvh:
//   - node AABB = union of member primitive AABBs (fp32)
//   - split on the widest axis (strict > comparisons, x wins ties)
//   - median split at size/2 with a STABLE sort keyed by (key, prim id),
//     so the numpy and native builders produce bit-identical arrays
//   - preorder node emission (node before children, lc subtree before rc)
//   - parent links for stackless traversal; roots get parent = -1
//
// Exposed via a C ABI for ctypes; the caller preallocates 2*n-1 node slots.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Builder {
    const float* prim_lo;   // (n, 3)
    const float* prim_hi;   // (n, 3)
    const float* split_key; // (n, 3)
    int leaf_size;

    float* aabb_lo;  // (cap, 3)
    float* aabb_hi;  // (cap, 3)
    int32_t* parent;
    int32_t* lc;
    int32_t* rc;
    int32_t* leaf_offset;
    int32_t* leaf_count;
    int32_t* prim_out;

    int32_t n_nodes = 0;
    int32_t n_prims_out = 0;

    int32_t build(int64_t* idx, int64_t size, int32_t parent_id) {
        if (size == 0) return -1;

        float lo[3], hi[3];
        for (int k = 0; k < 3; ++k) {
            lo[k] = prim_lo[idx[0] * 3 + k];
            hi[k] = prim_hi[idx[0] * 3 + k];
        }
        for (int64_t i = 1; i < size; ++i) {
            for (int k = 0; k < 3; ++k) {
                lo[k] = std::min(lo[k], prim_lo[idx[i] * 3 + k]);
                hi[k] = std::max(hi[k], prim_hi[idx[i] * 3 + k]);
            }
        }

        int32_t node = n_nodes++;
        std::memcpy(aabb_lo + node * 3, lo, sizeof(lo));
        std::memcpy(aabb_hi + node * 3, hi, sizeof(hi));
        parent[node] = parent_id;
        lc[node] = -1;
        rc[node] = -1;
        leaf_offset[node] = 0;
        leaf_count[node] = 0;

        if (size <= leaf_size) {
            leaf_offset[node] = n_prims_out;
            leaf_count[node] = (int32_t)size;
            for (int64_t i = 0; i < size; ++i)
                prim_out[n_prims_out++] = (int32_t)idx[i];
            return node;
        }

        float width[3] = {hi[0] - lo[0], hi[1] - lo[1], hi[2] - lo[2]};
        int axis = 0;
        if (width[1] > width[0] && width[1] > width[2]) axis = 1;
        else if (width[2] > width[0] && width[2] > width[1]) axis = 2;

        const float* key = split_key;
        std::stable_sort(idx, idx + size, [key, axis](int64_t a, int64_t b) {
            float ka = key[a * 3 + axis], kb = key[b * 3 + axis];
            // NaN keys sort LAST (like numpy), and NaN==NaN falls through to
            // the index tie-break: without this, comp(x, NaN) == comp(NaN, x)
            // == false makes NaN "equivalent" to every key while finite keys
            // still order — not a strict weak ordering, UB in stable_sort.
            bool na = ka != ka, nb = kb != kb;
            if (na != nb) return nb;
            if (!na && ka != kb) return ka < kb;
            return a < b;
        });

        int64_t half = size / 2;
        lc[node] = build(idx, half, node);
        rc[node] = build(idx + half, size - half, node);
        return node;
    }
};

} // namespace

extern "C" {

// Returns the number of nodes written (root at index 0), or -1 on error.
// Output buffers must hold at least 2*n_prims - 1 node slots and n_prims
// prim slots.
int32_t lprt_build_bvh(
    const float* prim_lo, const float* prim_hi, const float* split_key,
    int64_t n_prims, int32_t leaf_size,
    float* aabb_lo, float* aabb_hi,
    int32_t* parent, int32_t* lc, int32_t* rc,
    int32_t* leaf_offset, int32_t* leaf_count, int32_t* prim_out) {
    if (n_prims <= 0 || leaf_size <= 0) return -1;
    std::vector<int64_t> idx(n_prims);
    for (int64_t i = 0; i < n_prims; ++i) idx[i] = i;
    Builder b{prim_lo, prim_hi, split_key, leaf_size,
              aabb_lo, aabb_hi, parent, lc, rc, leaf_offset, leaf_count, prim_out};
    b.build(idx.data(), n_prims, -1);
    return b.n_nodes;
}

// Per-triangle AABBs + first-vertex split keys in one pass
// (triangle_aabbs equivalent; hot for large meshes at load time).
void lprt_triangle_aabbs(
    const float* positions, const int32_t* indices, int64_t n_tris,
    float* tri_lo, float* tri_hi, float* tri_key) {
    for (int64_t t = 0; t < n_tris; ++t) {
        const int32_t* tri = indices + t * 3;
        const float* v0 = positions + (int64_t)tri[0] * 3;
        for (int k = 0; k < 3; ++k) {
            float lo = v0[k], hi = v0[k];
            for (int j = 1; j < 3; ++j) {
                float v = positions[(int64_t)tri[j] * 3 + k];
                lo = std::min(lo, v);
                hi = std::max(hi, v);
            }
            tri_lo[t * 3 + k] = lo;
            tri_hi[t * 3 + k] = hi;
            tri_key[t * 3 + k] = v0[k];
        }
    }
}

} // extern "C"
