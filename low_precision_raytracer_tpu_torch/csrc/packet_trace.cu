// Packet BVH trace (K6): closest hit or any hit over a table of any size.
//
// Replaces the TPU kernel ops/traversal_pallas.py:_kernel (fallback='mxu3',
// the leaf walk at :188-426), reached through trace_rays_packet and
// trace_rays_packet_sorted.  Plain version: ops/dense_trace.py:
// dense_trace_multi_plain (the leaves only prune, so the function is K1b's;
// see ops/packet_trace.py).
//
// What it computes, per ray: the M-shift test against the instance
// triangles of the coefficient table (rows n[0..8] | e[0..2], as in K1b),
// a hit also needing mind < t < maxd, tri != skip and a finite t.  Closest
// hit: the (t, tri, row)-lexicographic minimum, t = 1e5 / ids -1 on a
// miss.  Any hit: tri = 0 if some triangle accepts, else -1; t = 1e5,
// u = v = 0, obj = -1 either way.
//
// Design: one thread per ray, an ordered depth-first walk of an implicit
// 4-ary tree with a per-thread stack.  Level 0 is the leaves (32
// consecutive rows of the morton-ordered table each, with their widened
// world AABBs); node i of level l + 1 is the union of nodes 4i .. 4i + 3 of
// level l (ops/packet_trace.py:build_tree), up to one root.  Popping an
// internal node slab-tests its children (the test of ops/dense_trace.py:
// ray_aabb_entry, 0.02 of slop, axes with non-finite slab distances
// skipped) and pushes those the segment enters, farthest first, so the
// nearest entry is visited next.  A node whose entry lies beyond the best t
// so far is skipped when it is pushed and again when it is popped (closest
// hit; `<=` keeps a node whose entry equals the best t, since it may hold
// an equal-t hit with a smaller tri); any hit stops at its first accepted
// row.  The boxes are conservative and ties go by (t, tri, row), so the
// result does not depend on the walk: it equals the plain version's global
// minimum bit for bit.  Dead lanes (maxd <= mind) walk nothing.
//
// The stack holds at most 3 entries per internal level + 1, which
// LPRT_MAX_STACK covers for up to LPRT_MAX_LEVELS levels; the entry point
// refuses a deeper tree, and a push past the stack sets *status (the
// wrapper raises), so no walk is ever cut short silently.
//
// What bounds it on the H100: operations, by the data — per live ray a slab
// test (34 ops) per box it enters before its hit and ~40 f32 operations per
// row of each leaf it tests.  The table (48 B/row, 98 MB at 2M rows) is
// read through the read-only cache; neighbouring rays (screen order, or
// the morton sort of incoherent launches) share leaves.  None of the TPU
// kernel's packet scheduling (512-ray packets sharing a leaf list, the
// list rows and their SMEM pipeline, 7-bit quantised bounds, the overflow
// walk, GSZ grouping for the MXU, the streamed table, screen tiling) has a
// counterpart here.  Built with --fmad=false so the test rounds like its
// plain version.

#include <cuda_runtime.h>
#include <math.h>

#define LPRT_LEAF 32
#define LPRT_FAN 4
#define LPRT_MAX_LEVELS 16
#define LPRT_MAX_STACK (3 * (LPRT_MAX_LEVELS - 1) + 1)
#define LPRT_IDX_BITS 27

namespace {

// Slab-entry bound of the ray against box b = [lo3 | hi3]; false when the
// ray's segment [0, maxd) cannot enter it (as in dense_multi.cu).
__device__ __forceinline__ bool box_entry(const float* __restrict__ b, float ox,
                                          float oy, float oz, float ix,
                                          float iy, float iz, float maxd,
                                          float* entry) {
  const float big = 3e38f, slop = 0.02f;
  float tmin = -big, tmax = big;
  bool any_fin = false;
  const float o[3] = {ox, oy, oz};
  const float inv[3] = {ix, iy, iz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float t1 = (__ldg(b + a) - o[a]) * inv[a];
    float t2 = (__ldg(b + 3 + a) - o[a]) * inv[a];
    if (isfinite(t1) && isfinite(t2)) {
      tmin = fmaxf(tmin, fminf(t1, t2));
      tmax = fminf(tmax, fmaxf(t1, t2));
      any_fin = true;
    }
  }
  float e = fmaxf(tmin - slop, 0.f);
  *entry = e;
  return any_fin && (tmin <= tmax + slop) && (tmax + slop >= 0.f) && (e < maxd);
}

__global__ void packet_trace_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const int* __restrict__ skip, const float* __restrict__ mind,
    const float* __restrict__ maxd, const float4* __restrict__ coef,
    const int* __restrict__ tri_id, const int* __restrict__ obj_id,
    const float* __restrict__ boxes, const int* __restrict__ levels,
    int n_levels, int R, int TI, int find_any, float* __restrict__ t_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ tri_out, int* __restrict__ obj_out,
    int* __restrict__ status) {
  __shared__ int s_off[LPRT_MAX_LEVELS], s_n[LPRT_MAX_LEVELS];
  if (threadIdx.x < n_levels) {
    s_off[threadIdx.x] = levels[threadIdx.x];
    s_n[threadIdx.x] = levels[n_levels + threadIdx.x];
  }
  __syncthreads();

  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float ox = orig[3 * r], oy = orig[3 * r + 1], oz = orig[3 * r + 2];
  float dx = dir[3 * r], dy = dir[3 * r + 1], dz = dir[3 * r + 2];
  float mn = mind[r], mx = maxd[r];
  int sk = skip[r];

  float bt = 1e5f, bu = 0.f, bv = 0.f;
  int btri = -1, brow = -1;
  if (mx > mn) {
    float ix = 1.f / dx, iy = 1.f / dy, iz = 1.f / dz;
    int st_node[LPRT_MAX_STACK];  // (level << LPRT_IDX_BITS) | index
    float st_ent[LPRT_MAX_STACK];
    int sp = 0;
    const int top = n_levels - 1;
    float e;
    if (box_entry(boxes + 6 * s_off[top], ox, oy, oz, ix, iy, iz, mx, &e)) {
      st_node[0] = top << LPRT_IDX_BITS;
      st_ent[0] = e;
      sp = 1;
    }
    bool blocked = false;
    while (sp > 0) {
      --sp;
      const int node = st_node[sp];
      if (!find_any && st_ent[sp] > bt) continue;
      const int lvl = node >> LPRT_IDX_BITS;
      const int idx = node & ((1 << LPRT_IDX_BITS) - 1);
      if (lvl == 0) {
        const int k1 = min(TI, (idx + 1) * LPRT_LEAF);
        for (int k = idx * LPRT_LEAF; k < k1; ++k) {
          float4 a = __ldg(coef + 3 * k), b = __ldg(coef + 3 * k + 1),
                 c = __ldg(coef + 3 * k + 2);
          // rows: a = n0 n1 n2 n3, b = n4 n5 n6 n7, c = n8 e0 e1 e2
          float Oz = b.z * ox + b.w * oy + c.x * oz + c.w;
          float Dz = b.z * dx + b.w * dy + c.x * dz;
          float Ox = a.x * ox + a.y * oy + a.z * oz + c.y;
          float Oy = a.w * ox + b.x * oy + b.y * oz + c.z;
          float Dx = a.x * dx + a.y * dy + a.z * dz;
          float Dy = a.w * dx + b.x * dy + b.y * dz;
          float t = -Oz / Dz;
          float u = Ox + t * Dx;
          float v = Oy + t * Dy;
          int tri = __ldg(tri_id + k);
          bool acc = (u > 0.f) && (v > 0.f) && (u + v < 1.f) && (t > mn) &&
                     (t < mx) && (tri != sk) && isfinite(t);
          if (!acc) continue;
          if (find_any) {
            blocked = true;
            break;
          }
          if (t < bt || (t == bt && (tri < btri || (tri == btri && k < brow)))) {
            bt = t;
            bu = u;
            bv = v;
            btri = tri;
            brow = k;
          }
        }
        if (blocked) break;
        continue;
      }
      // children of an internal node, sorted farthest entry first
      const int cl = lvl - 1;
      const int c0 = idx * LPRT_FAN;
      const int c1 = min(c0 + LPRT_FAN, s_n[cl]);
      float ce[LPRT_FAN];
      int cn[LPRT_FAN];
      int n = 0;
      for (int c = c0; c < c1; ++c) {
        if (!box_entry(boxes + 6 * (s_off[cl] + c), ox, oy, oz, ix, iy, iz, mx, &e))
          continue;
        if (!find_any && e > bt) continue;
        int j = n++;
        while (j > 0 && ce[j - 1] <= e) {  // equal entries: the lower index on top
          ce[j] = ce[j - 1];
          cn[j] = cn[j - 1];
          --j;
        }
        ce[j] = e;
        cn[j] = c;
      }
      if (sp + n > LPRT_MAX_STACK) {
        atomicOr(status, 1);
        break;
      }
      for (int j = 0; j < n; ++j) {
        st_node[sp] = (cl << LPRT_IDX_BITS) | cn[j];
        st_ent[sp] = ce[j];
        ++sp;
      }
    }
    if (blocked) btri = 0;
  }
  if (find_any) {
    t_out[r] = 1e5f;
    u_out[r] = 0.f;
    v_out[r] = 0.f;
    tri_out[r] = btri;
    obj_out[r] = -1;
    return;
  }
  t_out[r] = bt;
  u_out[r] = bu;
  v_out[r] = bv;
  tri_out[r] = btri;
  obj_out[r] = brow >= 0 ? __ldg(obj_id + brow) : -1;
}

}  // namespace

extern "C" int lprt_packet_trace(const float* orig, const float* dir,
                                 const int* skip, const float* mind,
                                 const float* maxd, const float* coef,
                                 const int* tri_id, const int* obj_id,
                                 const float* boxes, const int* levels,
                                 int n_levels, int R, int TI, int find_any,
                                 float* t_out, float* u_out, float* v_out,
                                 int* tri_out, int* obj_out, int* status,
                                 void* stream) {
  if (n_levels < 1 || n_levels > LPRT_MAX_LEVELS ||
      (long long)TI > ((long long)LPRT_LEAF << LPRT_IDX_BITS))
    return (int)cudaErrorInvalidValue;
  const int block = 128;
  const int grid = (R + block - 1) / block;
  if (grid > 0) {
    packet_trace_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        orig, dir, skip, mind, maxd, reinterpret_cast<const float4*>(coef),
        tri_id, obj_id, boxes, levels, n_levels, R, TI, find_any, t_out, u_out,
        v_out, tri_out, obj_out, status);
  }
  return (int)cudaGetLastError();
}
