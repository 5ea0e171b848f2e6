// Device code shared by the trace kernels: K1a (dense_trace.cu), K1b
// (dense_multi.cu) and K6 (packet_trace.cu).
//
// - tri_test: the M-shift test of one ray against one coefficient row
//   (n[0..8] row-major | e[0..2]): Oz = n[6:9].o + e[2], Dz = n[6:9].d,
//   Ox/Oy/Dx/Dy likewise, t = -Oz/Dz, u = Ox + t Dx, v = Oy + t Dy, accepted
//   by the band form FORM (ops/dense_trace.py:Band): strict u > 0, v > 0,
//   u + v < 1 ('mxu3'), or the f32 'both' test, strict inside an error band
//   and band-widened outside it, in the dense kernel's form
//   (dense_pallas.py:_kernel :393-418, the S rows scaled by sband as
//   _mxu_tables :888-900 builds them) or the packet kernel's
//   (traversal_pallas.py:_kernel :369-394).  Plain version:
//   ops/dense_trace.py:m_shift_test and band_accept.
// - box_entry: the conservative slab test of ops/dense_trace.py:
//   ray_aabb_entry (0.02 of slop, axes with non-finite slab distances
//   skipped).
// - tree_trace_kernel<LEAF, FORM>: closest or any hit over a table of any
//   size, one thread per ray walking an implicit 4-ary tree of boxes
//   (ops/dense_trace.py:build_tree) whose leaves each hold LEAF consecutive
//   rows: K1b walks its 128-row chunks, K6 its 32-row leaves.
//
// Every expression keeps the plain versions' order of operations, and the
// sources build with --fmad=false, so a kernel rounds like its plain
// version and equals it bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define LPRT_FORM_STRICT 0  // 'mxu3'
#define LPRT_FORM_DENSE 1   // K1's f32 'both': k = (sband, c1, c3)
#define LPRT_FORM_PACKET 2  // K6's f32 'both': k = (d12, d1, -)

#define LPRT_FAN 4
#define LPRT_MAX_LEVELS 16
#define LPRT_MAX_STACK (3 * (LPRT_MAX_LEVELS - 1) + 1)
#define LPRT_IDX_BITS 27

namespace lprt {

struct Band {
  float k0, k1, k2;
};

// c: the row n[0..8] | e[0..2].  -> the acceptance before the distance,
// skip and finiteness gates; t, u, v through the references.
template <int FORM>
__device__ __forceinline__ bool tri_test(const float* c, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, const Band& b, float& t,
                                         float& u, float& v) {
  float Oz = c[6] * ox + c[7] * oy + c[8] * oz + c[11];
  float Dz = c[6] * dx + c[7] * dy + c[8] * dz;
  float Ox = c[0] * ox + c[1] * oy + c[2] * oz + c[9];
  float Oy = c[3] * ox + c[4] * oy + c[5] * oz + c[10];
  float Dx = c[0] * dx + c[1] * dy + c[2] * dz;
  float Dy = c[3] * dx + c[4] * dy + c[5] * dz;
  t = -Oz / Dz;
  float t_dx = t * Dx, t_dy = t * Dy;
  u = Ox + t_dx;
  v = Oy + t_dy;
  bool strict = (u > 0.f) && (v > 0.f) && (u + v < 1.f);
  if (FORM == LPRT_FORM_STRICT) return strict;
  // the S rows |n| . |o| + |e| and |n| . |d| (K1 folds sband into |n|, |e|)
  float a[8];
  const int col[8] = {0, 1, 2, 3, 4, 5, 9, 10};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = fabsf(c[col[i]]);
    if (FORM == LPRT_FORM_DENSE) a[i] = a[i] * b.k0;
  }
  float aox = fabsf(ox), aoy = fabsf(oy), aoz = fabsf(oz);
  float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
  float s_ox = a[0] * aox + a[1] * aoy + a[2] * aoz + a[6];
  float s_oy = a[3] * aox + a[4] * aoy + a[5] * aoz + a[7];
  float s_dx = a[0] * adx + a[1] * ady + a[2] * adz;
  float s_dy = a[3] * adx + a[4] * ady + a[5] * adz;
  float eu, ev;
  if (FORM == LPRT_FORM_DENSE) {
    eu = s_ox + t * s_dx + b.k1 * fabsf(Ox) + b.k2 * fabsf(t_dx);
    ev = s_oy + t * s_dy + b.k1 * fabsf(Oy) + b.k2 * fabsf(t_dy);
  } else {
    eu = (b.k0 * s_ox + t * b.k0 * s_dx + b.k1 * (fabsf(Ox) + 3.f * fabsf(t_dx))) * 0.2f;
    ev = (b.k0 * s_oy + t * b.k0 * s_dy + b.k1 * (fabsf(Oy) + 3.f * fabsf(t_dy))) * 0.2f;
  }
  float w = 1.f - u - v;
  float ew = eu + ev;
  bool ambiguous = (u >= -eu && u <= 0.f) || (v >= -ev && v <= 0.f) ||
                   (w >= -ew && w <= 0.f);
  bool dtype_accept = (u > -eu) && (v > -ev) && (u + v < 1.f + eu + ev);
  return ambiguous ? strict : dtype_accept;
}

// Slab-entry bound of the ray against box b = [lo3 | hi3]; false when the
// ray's segment [0, maxd) cannot enter it.
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

// The tree walk.  What it computes, per ray: the tri_test<FORM> of every
// row, a hit also needing mind < t < maxd, tri != skip and a finite t.
// Closest hit: the (t, tri, row)-lexicographic minimum, t = 1e5 / ids -1 on
// a miss.  Any hit: tri = 0 if some row accepts, else -1; t = 1e5,
// u = v = 0, obj = -1 either way.
//
// Design: an ordered depth-first walk with a per-thread stack.  Level 0 is
// the leaf boxes (rows [LEAF i, LEAF i + LEAF) each); node i of level l + 1
// is the union of nodes 4i .. 4i + 3 of level l, up to one root.  Popping an
// internal node slab-tests its children and pushes those the segment
// enters, farthest first, so the nearest entry is visited next.  A node
// whose entry lies beyond the best t so far is skipped when it is pushed
// and again when it is popped (closest hit; `<=` keeps a node whose entry
// equals the best t, since it may hold an equal-t hit with a smaller tri);
// any hit stops at its first accepted row.  The boxes are conservative and
// ties go by (t, tri, row), so the result does not depend on the walk: it
// equals the plain version's global minimum bit for bit.  Dead lanes
// (maxd <= mind) walk nothing.
//
// The stack holds at most 3 entries per internal level + 1, which
// LPRT_MAX_STACK covers for up to LPRT_MAX_LEVELS levels; the entry points
// refuse a deeper tree, and a push past the stack sets *status (the
// wrapper raises), so no walk is ever cut short silently.
template <int LEAF, int FORM>
__global__ void tree_trace_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const int* __restrict__ skip, const float* __restrict__ mind,
    const float* __restrict__ maxd, const float4* __restrict__ coef,
    const int* __restrict__ tri_id, const int* __restrict__ obj_id,
    const float* __restrict__ boxes, const int* __restrict__ levels,
    int n_levels, int R, int TI, int find_any, Band band,
    float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ tri_out,
    int* __restrict__ obj_out, int* __restrict__ status) {
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
        const int k1 = min(TI, (idx + 1) * LEAF);
        for (int k = idx * LEAF; k < k1; ++k) {
          float4 q0 = __ldg(coef + 3 * k), q1 = __ldg(coef + 3 * k + 1),
                 q2 = __ldg(coef + 3 * k + 2);
          const float c[12] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                               q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
          float t, u, v;
          bool geom = tri_test<FORM>(c, ox, oy, oz, dx, dy, dz, band, t, u, v);
          int tri = __ldg(tri_id + k);
          bool acc = geom && (t > mn) && (t < mx) && (tri != sk) && isfinite(t);
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
      for (int ch = c0; ch < c1; ++ch) {
        if (!box_entry(boxes + 6 * (s_off[cl] + ch), ox, oy, oz, ix, iy, iz, mx, &e))
          continue;
        if (!find_any && e > bt) continue;
        int j = n++;
        while (j > 0 && ce[j - 1] <= e) {  // equal entries: the lower index on top
          ce[j] = ce[j - 1];
          cn[j] = cn[j - 1];
          --j;
        }
        ce[j] = e;
        cn[j] = ch;
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

// Launch tree_trace_kernel<LEAF, form> on `stream`; -> cudaError_t.
template <int LEAF>
int launch_tree_trace(const float* orig, const float* dir, const int* skip,
                      const float* mind, const float* maxd, const float* coef,
                      const int* tri_id, const int* obj_id, const float* boxes,
                      const int* levels, int n_levels, int R, int TI,
                      int find_any, int form, float k0, float k1, float k2,
                      float* t_out, float* u_out, float* v_out, int* tri_out,
                      int* obj_out, int* status, void* stream) {
  if (n_levels < 1 || n_levels > LPRT_MAX_LEVELS || form < 0 || form > 2 ||
      (long long)TI > ((long long)LEAF << LPRT_IDX_BITS))
    return (int)cudaErrorInvalidValue;
  const int block = 128;
  const int grid = (R + block - 1) / block;
  if (grid == 0) return (int)cudaGetLastError();
  const Band band = {k0, k1, k2};
  const float4* c4 = reinterpret_cast<const float4*>(coef);
  cudaStream_t s = (cudaStream_t)stream;
#define LPRT_TREE_ARGS                                                          \
  orig, dir, skip, mind, maxd, c4, tri_id, obj_id, boxes, levels, n_levels, R, \
      TI, find_any, band, t_out, u_out, v_out, tri_out, obj_out, status
  if (form == LPRT_FORM_STRICT)
    tree_trace_kernel<LEAF, LPRT_FORM_STRICT><<<grid, block, 0, s>>>(LPRT_TREE_ARGS);
  else if (form == LPRT_FORM_DENSE)
    tree_trace_kernel<LEAF, LPRT_FORM_DENSE><<<grid, block, 0, s>>>(LPRT_TREE_ARGS);
  else
    tree_trace_kernel<LEAF, LPRT_FORM_PACKET><<<grid, block, 0, s>>>(LPRT_TREE_ARGS);
#undef LPRT_TREE_ARGS
  return (int)cudaGetLastError();
}

}  // namespace lprt
