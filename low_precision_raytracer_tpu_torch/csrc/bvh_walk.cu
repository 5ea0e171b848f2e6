// The two-level BVH walk: closest hit or any hit over the TLAS of the
// frame's objects and the BLAS of their meshes.
//
// Replaces no Pallas kernel: the JAX package runs this walk as XLA code,
// a lax.while_loop over every ray in lockstep
// (low_precision_raytracer_tpu/ops/traversal.py:trace_rays, :79-323; the
// reference renderer's stackless walk, rt/rtrt/cuda.hpp:415-631).  Plain
// version: ops/traversal.py:trace_rays_plain.  Two kernels: the walk
// (bvh_walk_stack_kernel, lprt_bvh_walk_stack; wrapper trace_rays) and its
// reference on the card, the file's first form kept as it was written
// (bvh_walk_kernel, lprt_bvh_walk; wrapper trace_rays_reference, on no
// render path).
//
// What they compute, per ray: the JAX state machine's result.  In TLAS mode
// the ray tests a node's box with the scene slab test (additive slop); an
// entered leaf (one object) transforms the ray into object space by the
// object's W2L matrix and switches the ray to its mesh's BLAS, the TLAS
// cursor already moved past the leaf.  In BLAS mode the object slab test
// (multiplicative slop, and t1max < best_t in f32) gates the node; an
// entered leaf tests its triangles in leaf order (the M-shift test with
// error bounds, 'both' or 'dtype'); popping above the BLAS root returns the
// ray to TLAS mode.  Closest hit keeps an f32 best_t under a strict <; any
// hit stops at the first accepted triangle.  A ray takes at most max_iters
// steps.  Out: f32 t/u/v, i32 tri/obj, t = 1e5 and ids -1 on a miss;
// optionally per-ray counts (TLAS steps, BLAS steps, triangle tests,
// objects entered).
//
// Arithmetic: every render-dtype operation is computed in float and
// rounded to the dtype (rd<DT>), which for +, -, *, / of bf16 or fp16
// operands is the correctly rounded result (float has at least 2p + 2
// bits); (Oz, Dz, t) and the 'both' re-test are f32; in bf16 three values
// keep their last op in f32, and the f32 dot products, the re-test's u, v
// and the transform's rows are multiply-add chains (fma32), as XLA
// computes the JAX function on the CPU.  The sources build
// with --fmad=false and keep the plain version's order of operations, so
// the kernel equals it bit for bit.  The slab test skips an axis whose two
// slab distances are not both finite (a zero direction component, an fp16
// quotient that overflows), with the f32 maximum cast to the dtype (inf in
// bf16 and fp16) as the no-axis sentinel.
//
// The reference (bvh_walk_kernel) is the JAX machine itself: one thread a
// ray in the caller's order, one node a step by the parent links, each
// internal node visited from its parent and from each child.
//
// The walk (bvh_walk_stack_kernel), three changes that keep every result:
// - the same depth-first order on a short per-ray stack: an entered
//   internal node pushes its right child and goes to its left, a box is
//   tested when the walk reaches it (a popped right child after its left
//   sibling's subtree, under the best_t the JAX machine tests it with), an
//   entered TLAS leaf switches to the BLAS on top of the TLAS entries and
//   the BLAS's last pop returns to the TLAS.  Each node is visited once, so
//   a ray takes no more steps than the JAX machine, whose max_iters never
//   binds (each TLAS node is visited at most three times, each BLAS node
//   at most three times an instance entered): max_iters stays as a guard;
// - dead rays unwalked, and on an incoherent launch the live rays packed
//   (ops/traversal.py:launch_order): thread r takes ray order[r] (ray r
//   without an order) and writes its result there.  A ray with maxd <=
//   mind (or a NaN) accepts nothing (every accept needs mind < t < maxd),
//   so its thread writes the miss record and zero counts at once; the
//   order puts the live rays first, so they fill whole warps;
// - the exact zero-axis rule on BLAS boxes (rule_enters; its proof below):
//   where the object-space direction's dtype value d_a is exactly +-0, a
//   box that box_hit enters is entered only when lo_a - pad <= o_a <= hi_a
//   + pad.  fp16 'dtype' has no proven pad and keeps box_hit alone.
//
// What bounds it on the H100: operations, by the data: per ray a slab test
// (~30 dtype ops, each with its rounding) per node it steps through, a
// 4x4 transform per object it enters, and ~90 operations per triangle it
// tests (~40 more in the 'both' re-test).  The tables are small (81,934
// triangles and ~41k BLAS nodes at colonnade-8M) and stay in L2.
//
// Proof of the rule's pad (ops/walk_pad.py computes it).  Let a ray in
// object space (o, d in the dtype's values, as the test reads them) have
// d_a == 0 exactly, and let the test accept a triangle of a leaf L at a
// parameter t (the dtype path's f32 t, or under 'both' the re-test's t32).
// Every accept needs mind < t < maxd, and in closest hit t < best_t, so
// |t| <= R = max(|mind|, |maxd|) and |t| <= max(|mind|, |best_t|).
// (1) No overflow: the rule applies only where the ray is finite, Os =
//     sum|o_i|, Ds = sum|d_i| and R are at most 2^40, and the host gives an
//     infinite pad to a triangle with a row entry above 2^40 or not finite;
//     so in bf16 and f32 no intermediate of the test (at most ~2^124)
//     overflows.  In fp16 an accepted u is finite, so every term of its
//     chain is; the band eu can overflow (3 |t Dx| > 65504), and then
//     'dtype' accepts any finite (u, v): that form takes no rule.  Under
//     fp16 'both' an infinite eu leaves the non-ambiguous branch only with
//     u, v, w > 0, inside the bound below.
// (2) The computed point.  Let O be the test's rounded o - v2 and P' = v2
//     + O + t d (exact).  P'_a = v2_a + O_a differs from o_a by the
//     rounding of O_a alone (d_a = 0): |o_a - P'_a| <= eO (|o_a| + |v2_a|)
//     + eta, eO = (1 + 2^-24)(1 + e) - 1, e the dtype's unit roundoff, eta
//     its subnormal half-spacing.  The exact edge coordinates of P' under
//     the row (u*, v*, z*) = M (P' - v2) are sum_i m_xi O_i + t sum_i m_xi
//     d_i.  By the standard model each rounded op is x (1 + th) (+ eta for
//     a product), |th| <= e, so |u - u*| <= g3 SA + g4 |t| SB + e/(1-e) |u|
//     + 8 eta (1 + |t|), SA = sum_i |m_0i| |O_i| (|O_i| <= (1 + eO)(|o_i|
//     + |v2_i|) + eta), SB = sum_i |m_0i| |d_i|, g_k = k e / (1 - k e); v
//     likewise.  The computed eu is at most (1 + g16) 0.2 ((2 d1 + d2) SA +
//     (4 d1 + d2) |t| SB) + 32 eta (1 + |t|) (its chain of non-negative
//     terms, each op at most (1 + e) over its exact value).  The f32 z row
//     gives t = -Oz / Dz rounded twice, so |z*| <= g7 |t| SB2 + (g3 + e')
//     (1 + 2^-24) sum_i |m_2i| (|o_i| + |v2_i|) + (8 2^-150 + eta)(1 +
//     sum|m_2i|)(1 + |t|), g over f32 and e' = e in bf16 (its z row reads
//     o - v2 unrounded), else 0.
// (3) The barycentrics.  An accept of the dtype branch ('dtype', or
//     'both' outside the band) has u > -eu, v > -ev and rd(u + v) <
//     rd(rd(1 + eu) + ev), so u + v < (1 + g3)(1 + eu + ev) and |u|, |v|
//     <= (1 + g3)(1 + 2 H), H >= eu + ev the bound above; under 'both' u,
//     v > 0 and either w > 0 or the same sum.  So u* >= -(eu + Eu), v* >=
//     -(ev + Ev), w* = 1 - u* - v* >= -(g3 + (1 + g3)(eu + ev) + Eu + Ev),
//     and their negative parts sum to at most dS = (2 + g3) H + 2 (Eu +
//     Ev) + g3.  The f32 re-test accepts u32, v32 > 0 and u32 + v32 < 1, with
//     Eu32 <= g3 (SA32 + |t32| SB32) + 2^-24 / (1 - 2^-24) (f32 rows, O32
//     = o - v2_f32 rounded once): dS32 = 2 (Eu32 + Ev32).
// (4) The place.  With N = M^-1 (the host's float64 inverse, each entry
//     within eN of the exact one by its residual), P'_a = w* V2_a + u* V0_a
//     + v* V1_a + N_a2 z*, V2 = v2, V0 = v2 + N e_0, V1 = v2 + N e_1.  With
//     the negative parts above, P'_a lies within dS S_a + |N_a2| Z of
//     [min_k V_k,a, max_k V_k,a] (S_a that range's width), which lies
//     within dev_a of the leaf's box on a.  So o_a lies within pad_a =
//     dev_a + S_a dS + Q_a Z + eO (|o_a| + |v2_a|) + eta of the leaf's box,
//     each term linear in X = (1, |o_i|, |t| |d_i|, |t|), and the same
//     holds on every axis for o_b + t d_b.
// (5) The tree.  A leaf takes the largest coefficients over its triangles
//     and branches, a node the largest of its children's plus any excess of
//     a child's box over its own: the bound holds for every box above the
//     leaf.  Folded to four numbers (c0 the largest constant, cO the
//     largest |o_i| coefficient, cT the largest |t| |d_i| one, ct the |t|
//     one; grown by 2^-16, plus 2^-40 of the box's size, rounded up to
//     f32): pad_a <= P0 + |t| P1, P0 = c0 + cO Os, P1 = cT Ds + ct.
// (6) |t|.  tr = R (any hit) or min(R, max(|mind|, |best_t|)) (closest
//     hit: a hit that can still win, ties included).  On the ray's longest
//     axis b (|d_b| > 0), |t| |d_b| <= W + P0 + P1 |t|, W the distance from
//     o_b to the box's far side on b: where |d_b| > P1, |t| <= tb = (W +
//     P0) / (|d_b| - P1).  So pad = P0 + min(tr, tb) P1 bounds pad_a, and a
//     box with o_a outside [lo_a - pad, hi_a + pad] holds no accepted
//     point.  The kernel computes these in float64 (the plain version op
//     for op, so their verdicts agree bit for bit); their rounding (a few
//     2^-53) sits far inside the 2^-16 and 2^-40 margins and the 2^-40
//     growth of tb.
// So skipping such a box changes no accepted hit: the walk tests every box
// that can hold one in the JAX order under the same best_t, and so keeps
// every hit, tie and any-hit choice.


#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kStats = 4;

template <int DT>
__device__ __forceinline__ float rd(float x) {
  if (DT == 1) return __bfloat162float(__float2bfloat16_rn(x));
  if (DT == 2) return __half2float(__float2half_rn(x));
  return x;
}

// a b + c rounded once to f32, as the plain version forms it: the exact
// product and the sum in double, then rounded (XLA's fused multiply-add
// on the CPU; see ops/triangle.py)
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// ops/triangle.py:dot3, fma(a2, b2, fma(a0, b0, a1 b1))
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return fma32(a[2], b[2], fma32(a[0], b[0], a[1] * b[1]));
}

struct Consts {
  float scene_slop, object_slop, d1, d2, point2, big;
};

// ops/aabb.py:slab, then the scene or the object acceptance
template <int DT, bool SCENE>
__device__ __forceinline__ bool box_hit(const float* o, const float* d, const float* box,
                                        const Consts& c, float& t1max, float& t2min) {
  bool updated = false;
  t1max = -c.big;
  t2min = c.big;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t1 = rd<DT>(rd<DT>(box[k] - o[k]) / d[k]);
    const float t2 = rd<DT>(rd<DT>(box[3 + k] - o[k]) / d[k]);
    if (isfinite(t1) && isfinite(t2)) {
      t1max = fmaxf(t1max, fminf(t1, t2));
      t2min = fminf(t2min, fmaxf(t1, t2));
      updated = true;
    }
  }
  if (SCENE) {
    const float s = rd<DT>(t2min + c.scene_slop);
    return updated && t1max <= s && 0.0f <= s;
  }
  return updated && t1max <= rd<DT>(t2min * c.object_slop) && 0.0f <= t2min;
}

template <int DT>
__device__ __forceinline__ float err3(float a, float b, float cc, const Consts& c) {
  const float s = rd<DT>(rd<DT>(fabsf(a) + fabsf(b)) + fabsf(cc));
  return rd<DT>(rd<DT>(c.d1 * s) + rd<DT>(c.d2 * s));
}

// ops/triangle.py:ray_triangle for one (ray, triangle); true when accepted,
// with the hit's f32 (t, u, v)
template <int DT, int FB>
__device__ __forceinline__ bool tri_test(const float* o, const float* d, const float* row,
                                         const float* row32, float best_t, float mind,
                                         float maxd, const Consts& c, float& t_out,
                                         float& u_out, float& v_out) {
  const float* v2 = row;
  const float* m = row + 3;
  float O[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) O[k] = rd<DT>(o[k] - v2[k]);
  const float ox0 = rd<DT>(O[0] * m[0]), ox1 = rd<DT>(O[1] * m[1]), ox2 = rd<DT>(O[2] * m[2]);
  const float dx0 = rd<DT>(d[0] * m[0]), dx1 = rd<DT>(d[1] * m[1]), dx2 = rd<DT>(d[2] * m[2]);
  const float oy0 = rd<DT>(O[0] * m[3]), oy1 = rd<DT>(O[1] * m[4]), oy2 = rd<DT>(O[2] * m[5]);
  const float dy0 = rd<DT>(d[0] * m[3]), dy1 = rd<DT>(d[1] * m[4]), dy2 = rd<DT>(d[2] * m[5]);
  const float Ox = rd<DT>(rd<DT>(ox0 + ox1) + ox2), Dx = rd<DT>(rd<DT>(dx0 + dx1) + dx2);
  const float Oy = rd<DT>(rd<DT>(oy0 + oy1) + oy2), Dy = rd<DT>(rd<DT>(dy0 + dy1) + dy2);
  // bf16: the z row's O, t Dx's Dx and the reported u, v keep their last
  // op in f32, as XLA computes the JAX function on the CPU
  // (ops/triangle.py's docstring)
  constexpr bool kExcess = DT == 1;
  float Oz;
  if (kExcess) {
    const float Oe[3] = {o[0] - v2[0], o[1] - v2[1], o[2] - v2[2]};
    Oz = dot3(Oe, m + 6);
  } else {
    Oz = dot3(O, m + 6);
  }
  const float Dz = dot3(d, m + 6);
  const float inv_dz = 1.0f / Dz;
  const float t = -Oz * inv_dz;
  const float Dx_w = kExcess ? rd<DT>(dx0 + dx1) + dx2 : Dx;
  const float Dy_w = kExcess ? rd<DT>(dy0 + dy1) + dy2 : Dy;
  const float t_dx = rd<DT>(t * Dx_w), t_dy = rd<DT>(t * Dy_w);
  const float u = rd<DT>(Ox + t_dx), v = rd<DT>(Oy + t_dy);
  const float u_w = kExcess ? Ox + t_dx : u, v_w = kExcess ? Oy + t_dy : v;
  const float t_dt = rd<DT>(t);
  const float e_ox = err3<DT>(ox0, ox1, ox2, c), e_dx = err3<DT>(dx0, dx1, dx2, c);
  const float e_oy = err3<DT>(oy0, oy1, oy2, c), e_dy = err3<DT>(dy0, dy1, dy2, c);
  const float eu = rd<DT>(rd<DT>(rd<DT>(e_ox + rd<DT>(t_dt * e_dx)) +
                                 rd<DT>(c.d1 * rd<DT>(fabsf(Ox) + rd<DT>(3.0f * fabsf(t_dx))))) *
                          c.point2);
  const float ev = rd<DT>(rd<DT>(rd<DT>(e_oy + rd<DT>(t_dt * e_dy)) +
                                 rd<DT>(c.d1 * rd<DT>(fabsf(Oy) + rd<DT>(3.0f * fabsf(t_dy))))) *
                          c.point2);
  const bool valid_t = t > mind && t < best_t && t < maxd;
  const float w = rd<DT>(rd<DT>(1.0f - u) - v);
  const bool dtype_accept = u > -eu && v > -ev && rd<DT>(u + v) < rd<DT>(rd<DT>(1.0f + eu) + ev);
  if (FB == 1) {  // 'dtype'
    t_out = t;
    u_out = u_w;
    v_out = v_w;
    return valid_t && dtype_accept;
  }
  const float euv = rd<DT>(ev + eu);
  const bool ambiguous = (u >= -eu && u <= 0.0f) || (v >= -ev && v <= 0.0f) ||
                         (w >= -euv && w <= 0.0f);
  if (!ambiguous) {
    t_out = t;
    u_out = u_w;
    v_out = v_w;
    return valid_t && dtype_accept;
  }
  // the full fp32 re-test of the dtype-space local ray
  const float* v2f = row32;
  const float* mf = row32 + 3;
  const float O32[3] = {o[0] - v2f[0], o[1] - v2f[1], o[2] - v2f[2]};
  const float Ox32 = dot3(O32, mf), Dx32 = dot3(d, mf);
  const float Oy32 = dot3(O32, mf + 3), Dy32 = dot3(d, mf + 3);
  const float Oz32 = dot3(O32, mf + 6), Dz32 = dot3(d, mf + 6);
  const float t32 = -Oz32 / Dz32;
  const float u32 = fma32(t32, Dx32, Ox32);
  const float v32 = fma32(t32, Dy32, Oy32);
  t_out = t32;
  u_out = u32;
  v_out = v32;
  return valid_t && t32 > mind && t32 < best_t && t32 < maxd && u32 > 0.0f && v32 > 0.0f &&
         u32 + v32 < 1.0f;
}

// ops/traversal.py:transform_ray: each row of rot @ x the f32 chain
// fma(r2, x2, fma(r1, x1, r0 x0)), rounded once to the dtype
template <int DT>
__device__ __forceinline__ void transform(const float* w, const float* ow, const float* dw,
                                          float* ol, float* dl) {
  float o4[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* r = w + 4 * i;
    o4[i] = rd<DT>(rd<DT>(fma32(r[2], ow[2], fma32(r[1], ow[1], r[0] * ow[0]))) + r[3]);
    dl[i] = rd<DT>(fma32(r[2], dw[2], fma32(r[1], dw[1], r[0] * dw[0])));
  }
  const float ww = rd<DT>(rd<DT>((w[12] * ow[0] + w[13] * ow[1]) + w[14] * ow[2]) + w[15]);
#pragma unroll
  for (int i = 0; i < 3; ++i) ol[i] = rd<DT>(o4[i] / ww);
}

__device__ __forceinline__ int next_node(bool hit_from_parent, bool is_leaf, bool from_lc,
                                         int lc, int rc, int parent) {
  if (hit_from_parent && !is_leaf) return lc >= 0 ? lc : (rc >= 0 ? rc : parent);
  if (from_lc) return rc >= 0 ? rc : parent;
  return parent;
}

struct Tables {
  const float* orig;       // (R, 3) the rays in the render dtype's values
  const float* dir;
  const int* skip;         // (R,)
  const float* mind;       // (R,) f32
  const float* maxd;
  const float* tlas_box;   // (NT, 6) [lo | hi]
  const int* tlas_link;    // (NT, 5) [parent, lc, rc, leaf_offset, leaf_count]
  const int* tlas_prim;    // object ids in leaf order
  const float* w2l;        // (O, 16) row-major, the dtype's values
  const int* obj_mesh;     // (O,)
  const int* blas_root;    // (n_meshes,)
  const float* blas_box;   // (NB, 6)
  const int* blas_link;    // (NB, 5)
  const int* blas_prim;    // global triangle ids in leaf order
  const float* tri_dt;     // (T, 12) [v2 | m], the dtype's values
  const float* tri_f32;    // (T, 12) the f32 shadows
};

struct Outs {
  float *t, *u, *v;
  int *tri, *obj, *stats;
};

template <int DT, bool ANY, int FB>
__global__ void __launch_bounds__(128) bvh_walk_kernel(Tables tb, Outs out, int R, int max_iters,
                                                       Consts c) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float ow[3], dw[3], ol[3], dl[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ow[k] = ol[k] = tb.orig[3 * r + k];
    dw[k] = dl[k] = tb.dir[3 * r + k];
  }
  const int skip = tb.skip[r];
  const float mind = tb.mind[r], maxd = tb.maxd[r];
  const float mind_dt = rd<DT>(mind), maxd_dt = rd<DT>(maxd);
  int mode = 0, tl = -1, tc = 0, bl = -1, bc = -1, obj = 0;
  float best_t = 1e5f, best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1, best_obj = -1;
  bool done = false;
  int n_tlas = 0, n_blas = 0, n_tri = 0, n_enter = 0;
  for (int it = 0; it < max_iters; ++it) {
    if (done || (mode == 0 && tc < 0)) break;
    if (mode == 0) {
      const int* lk = tb.tlas_link + 5 * tc;
      const int parent = lk[0], lc = lk[1], rc = lk[2], leaf_off = lk[3], leaf_cnt = lk[4];
      float tmin, tmax;
      const bool hit = box_hit<DT, true>(ow, dw, tb.tlas_box + 6 * tc, c, tmin, tmax) &&
                       tmin < maxd_dt && tmax > mind_dt;
      const bool from_parent = tl == parent;
      const bool is_leaf = leaf_cnt > 0;
      const bool from_lc = !from_parent && tl == lc;
      tl = tc;
      tc = next_node(from_parent && hit, is_leaf, from_lc, lc, rc, parent);
      ++n_tlas;
      if (from_parent && hit && is_leaf) {
        obj = tb.tlas_prim[leaf_off];
        transform<DT>(tb.w2l + 16 * obj, ow, dw, ol, dl);
        bc = tb.blas_root[tb.obj_mesh[obj]];
        bl = -1;
        mode = 1;
        ++n_enter;
      }
    } else {
      const int* lk = tb.blas_link + 5 * bc;
      const int parent = lk[0], lc = lk[1], rc = lk[2], leaf_off = lk[3], leaf_cnt = lk[4];
      float tmin, tmax;
      const bool hit = box_hit<DT, false>(ol, dl, tb.blas_box + 6 * bc, c, tmin, tmax) &&
                       tmin < best_t && tmin < maxd_dt && tmax > mind_dt;
      const bool from_parent = bl == parent;
      const bool is_leaf = leaf_cnt > 0;
      const bool from_lc = !from_parent && bl == lc;
      if (from_parent && hit && is_leaf) {
        for (int k = 0; k < leaf_cnt; ++k) {
          const int tri = tb.blas_prim[leaf_off + k];
          if (tri == skip || done) continue;
          float t, u, v;
          ++n_tri;
          if (tri_test<DT, FB>(ol, dl, tb.tri_dt + 12 * tri, tb.tri_f32 + 12 * tri, best_t, mind,
                               maxd, c, t, u, v)) {
            best_t = t;
            best_u = u;
            best_v = v;
            best_tri = tri;
            best_obj = obj;
            if (ANY) done = true;
          }
        }
      }
      const int nb = next_node(from_parent && hit, is_leaf, from_lc, lc, rc, parent);
      bl = bc;
      bc = nb;
      if (nb < 0) mode = 0;
      ++n_blas;
    }
  }
  out.t[r] = best_t;
  out.u[r] = best_u;
  out.v[r] = best_v;
  out.tri[r] = best_tri;
  out.obj[r] = best_obj;
  if (out.stats) {
    int* s = out.stats + kStats * r;
    s[0] = n_tlas;
    s[1] = n_blas;
    s[2] = n_tri;
    s[3] = n_enter;
  }
}

template <int DT, bool ANY, int FB>
cudaError_t launch(const Tables& tb, const Outs& out, int R, int max_iters, const Consts& c,
                   cudaStream_t stream) {
  const int threads = 128;
  if (R > 0)
    bvh_walk_kernel<DT, ANY, FB><<<(R + threads - 1) / threads, threads, 0, stream>>>(
        tb, out, R, max_iters, c);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_dt(const Tables& tb, const Outs& out, int R, int find_any, int fb,
                      int max_iters, const Consts& c, cudaStream_t s) {
  if (find_any)
    return fb ? launch<DT, true, 1>(tb, out, R, max_iters, c, s)
              : launch<DT, true, 0>(tb, out, R, max_iters, c, s);
  return fb ? launch<DT, false, 1>(tb, out, R, max_iters, c, s)
            : launch<DT, false, 0>(tb, out, R, max_iters, c, s);
}

// ---------------------------------------------------------------------------
// the walk: a short stack, dead rays unwalked, the zero-axis rule

// the stack holds at most one right child a level of the TLAS and the BLAS;
// the wrapper refuses deeper trees
constexpr int kStack = 64;
constexpr double kTbMargin = 1.0 + 0x1p-40;  // ops/walk_pad.py:TB_MARGIN
constexpr double kMag = 0x1p40;               // ops/walk_pad.py:MAG

// may the rule apply to a ray in object space (ops/walk_pad.py:ray_reach's
// `ok`, and an axis with d[a] == 0)
__device__ __forceinline__ bool rule_ray(const float* o, const float* d, float mind,
                                         float maxd) {
  const double Os = (fabs((double)o[0]) + fabs((double)o[1])) + fabs((double)o[2]);
  const double Ds = (fabs((double)d[0]) + fabs((double)d[1])) + fabs((double)d[2]);
  const double reach = fmax(fabs((double)mind), fabs((double)maxd));
  return (d[0] == 0.0f || d[1] == 0.0f || d[2] == 0.0f) && isfinite(o[0]) && isfinite(o[1]) &&
         isfinite(o[2]) && isfinite(d[0]) && isfinite(d[1]) && isfinite(d[2]) && Os <= kMag &&
         Ds <= kMag && reach <= kMag;
}

// ops/walk_pad.py:rule_enters (ray_reach, box_pad), op for op in float64:
// false where an axis with d[a] == 0 exactly has o[a] outside the box grown
// by the pad
template <bool ANY>
__device__ __forceinline__ bool rule_enters(const float* o, const float* d, const float* box,
                                         const float4 c, float mind, float maxd,
                                         float best_t) {
  const double Os = (fabs((double)o[0]) + fabs((double)o[1])) + fabs((double)o[2]);
  const double Ds = (fabs((double)d[0]) + fabs((double)d[1])) + fabs((double)d[2]);
  const double amind = fabs((double)mind);
  const double reach = fmax(amind, fabs((double)maxd));
  const double tr = ANY ? reach : fmin(reach, fmax(amind, fabs((double)best_t)));
  const double P0 = (double)c.x + (double)c.y * Os;
  const double P1 = (double)c.z * Ds + (double)c.w;
  int b = 0;
  float ab = fabsf(d[0]);
  if (fabsf(d[1]) > ab) { b = 1; ab = fabsf(d[1]); }
  if (fabsf(d[2]) > ab) { b = 2; ab = fabsf(d[2]); }
  const double ob = (double)o[b];
  const double W = fmax((double)box[3 + b] - ob, ob - (double)box[b]);
  const double den = (double)ab - P1;
  double tt = tr;
  if (den > 0.0) tt = fmin(tr, (W + P0) / den * kTbMargin);
  const double pad = P0 + tt * P1;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (d[k] == 0.0f) {
      const double ok = (double)o[k];
      if (ok < (double)box[k] - pad || ok > (double)box[3 + k] + pad) return false;
    }
  }
  return true;
}

__device__ __forceinline__ void write_out(const Outs& out, int q, float t, float u, float v,
                                          int tri, int obj, int n_tlas, int n_blas, int n_tri,
                                          int n_enter) {
  out.t[q] = t;
  out.u[q] = u;
  out.v[q] = v;
  out.tri[q] = tri;
  out.obj[q] = obj;
  if (out.stats) {
    int* s = out.stats + kStats * q;
    s[0] = n_tlas;
    s[1] = n_blas;
    s[2] = n_tri;
    s[3] = n_enter;
  }
}

template <int DT, bool ANY, int FB, bool RULE>
__global__ void __launch_bounds__(128)
    bvh_walk_stack_kernel(Tables tb, const int* order, const float4* pad4, Outs out, int R,
                          int max_iters, Consts c) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int q = order ? order[r] : r;
  const float mind = tb.mind[q], maxd = tb.maxd[q];
  if (!(maxd > mind)) {  // a dead ray: the miss record
    write_out(out, q, 1e5f, 0.0f, 0.0f, -1, -1, 0, 0, 0, 0);
    return;
  }
  float ow[3], dw[3], ol[3], dl[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ow[k] = ol[k] = tb.orig[3 * q + k];
    dw[k] = dl[k] = tb.dir[3 * q + k];
  }
  const int skip = tb.skip[q];
  const float mind_dt = rd<DT>(mind), maxd_dt = rd<DT>(maxd);
  int stack[kStack];
  int sp = 0, base = 0, node = 0, obj = 0;
  bool blas = false, use_rule = false;
  float best_t = 1e5f, best_u = 0.0f, best_v = 0.0f;
  int best_tri = -1, best_obj = -1;
  bool done = false;
  int n_tlas = 0, n_blas = 0, n_tri = 0, n_enter = 0;
  for (int it = 0; it < max_iters && !done; ++it) {
    if (!blas) {
      ++n_tlas;
      const int* lk = tb.tlas_link + 5 * node;
      float tmin, tmax;
      const bool hit = box_hit<DT, true>(ow, dw, tb.tlas_box + 6 * node, c, tmin, tmax) &&
                       tmin < maxd_dt && tmax > mind_dt;
      if (hit) {
        if (lk[4] > 0) {  // an object: walk its BLAS on top of the TLAS entries
          obj = tb.tlas_prim[lk[3]];
          transform<DT>(tb.w2l + 16 * obj, ow, dw, ol, dl);
          ++n_enter;
          if (RULE) use_rule = rule_ray(ol, dl, mind, maxd);
          blas = true;
          base = sp;
          node = tb.blas_root[tb.obj_mesh[obj]];
          continue;
        }
        const int lc = lk[1], rc = lk[2];
        if (lc >= 0) {
          if (rc >= 0) stack[sp++] = rc;
          node = lc;
          continue;
        }
        if (rc >= 0) {
          node = rc;
          continue;
        }
      }
      if (sp == 0) break;
      node = stack[--sp];
    } else {
      ++n_blas;
      const int* lk = tb.blas_link + 5 * node;
      const float* box = tb.blas_box + 6 * node;
      float tmin, tmax;
      bool hit = box_hit<DT, false>(ol, dl, box, c, tmin, tmax) && tmin < best_t &&
                 tmin < maxd_dt && tmax > mind_dt;
      if (RULE && hit && use_rule) hit = rule_enters<ANY>(ol, dl, box, pad4[node], mind, maxd,
                                                          best_t);
      if (hit) {
        const int leaf_cnt = lk[4];
        if (leaf_cnt > 0) {
          const int leaf_off = lk[3];
          for (int k = 0; k < leaf_cnt; ++k) {
            const int tri = tb.blas_prim[leaf_off + k];
            if (tri == skip) continue;
            float t, u, v;
            ++n_tri;
            if (tri_test<DT, FB>(ol, dl, tb.tri_dt + 12 * tri, tb.tri_f32 + 12 * tri, best_t,
                                 mind, maxd, c, t, u, v)) {
              best_t = t;
              best_u = u;
              best_v = v;
              best_tri = tri;
              best_obj = obj;
              if (ANY) {
                done = true;
                break;
              }
            }
          }
        } else {
          const int lc = lk[1], rc = lk[2];
          if (lc >= 0) {
            if (rc >= 0) stack[sp++] = rc;
            node = lc;
            continue;
          }
          if (rc >= 0) {
            node = rc;
            continue;
          }
        }
      }
      if (sp == base) {  // above the BLAS root: back to the TLAS
        blas = false;
        if (sp == 0) break;
      }
      node = stack[--sp];
    }
  }
  write_out(out, q, best_t, best_u, best_v, best_tri, best_obj, n_tlas, n_blas, n_tri,
            n_enter);
}

template <int DT, bool ANY, int FB>
cudaError_t launch_stack(const Tables& tb, const int* order, const float4* pad4, const Outs& out,
                         int R, int max_iters, const Consts& c, cudaStream_t s) {
  const int threads = 128, blocks = (R + threads - 1) / threads;
  if (R > 0) {
    if (pad4)
      bvh_walk_stack_kernel<DT, ANY, FB, true><<<blocks, threads, 0, s>>>(tb, order, pad4, out,
                                                                          R, max_iters, c);
    else
      bvh_walk_stack_kernel<DT, ANY, FB, false><<<blocks, threads, 0, s>>>(tb, order, pad4, out,
                                                                           R, max_iters, c);
  }
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_stack_dt(const Tables& tb, const int* order, const float4* pad4,
                            const Outs& out, int R, int find_any, int fb, int max_iters,
                            const Consts& c, cudaStream_t s) {
  if (find_any)
    return fb ? launch_stack<DT, true, 1>(tb, order, pad4, out, R, max_iters, c, s)
              : launch_stack<DT, true, 0>(tb, order, pad4, out, R, max_iters, c, s);
  return fb ? launch_stack<DT, false, 1>(tb, order, pad4, out, R, max_iters, c, s)
            : launch_stack<DT, false, 0>(tb, order, pad4, out, R, max_iters, c, s);
}

}  // namespace

// dt: 0 fp32, 1 bf16, 2 fp16; fallback: 0 'both', 1 'dtype'; the float
// constants already rounded to the dtype (big: the f32 maximum in it);
// stats: null or (R, 4) i32.
extern "C" int lprt_bvh_walk(const float* orig, const float* dir, const int* skip,
                             const float* mind, const float* maxd, const float* tlas_box,
                             const int* tlas_link, const int* tlas_prim, const float* w2l,
                             const int* obj_mesh, const int* blas_root, const float* blas_box,
                             const int* blas_link, const int* blas_prim, const float* tri_dt,
                             const float* tri_f32, int R, int dt, int find_any, int fallback,
                             int max_iters, float scene_slop, float object_slop, float d1,
                             float d2, float point2, float big, float* t_out, float* u_out,
                             float* v_out, int* tri_out, int* obj_out, int* stats,
                             void* stream) {
  const Tables tb{orig, dir, skip, mind, maxd, tlas_box, tlas_link, tlas_prim,
                  w2l, obj_mesh, blas_root, blas_box, blas_link, blas_prim, tri_dt, tri_f32};
  const Outs out{t_out, u_out, v_out, tri_out, obj_out, stats};
  const Consts c{scene_slop, object_slop, d1, d2, point2, big};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == 0) return launch_dt<0>(tb, out, R, find_any, fallback, max_iters, c, s);
  if (dt == 1) return launch_dt<1>(tb, out, R, find_any, fallback, max_iters, c, s);
  if (dt == 2) return launch_dt<2>(tb, out, R, find_any, fallback, max_iters, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The walk: lprt_bvh_walk's arguments, and order: null (ray r on thread r)
// or (R,) i32 the launch order (a permutation of the rays); pad4: null (no
// rule) or (NB, 4) f32 the BLAS nodes' pads (ops/walk_pad.py:node_pads).
// Dead rays (maxd <= mind) get the miss record and zero counts unwalked.
extern "C" int lprt_bvh_walk_stack(const float* orig, const float* dir, const int* skip,
                                   const float* mind, const float* maxd, const float* tlas_box,
                                   const int* tlas_link, const int* tlas_prim, const float* w2l,
                                   const int* obj_mesh, const int* blas_root,
                                   const float* blas_box, const int* blas_link,
                                   const int* blas_prim, const float* tri_dt,
                                   const float* tri_f32, const int* order, const float* pad4,
                                   int R, int dt, int find_any, int fallback, int max_iters,
                                   float scene_slop, float object_slop, float d1, float d2,
                                   float point2, float big, float* t_out, float* u_out,
                                   float* v_out, int* tri_out, int* obj_out, int* stats,
                                   void* stream) {
  const Tables tb{orig, dir, skip, mind, maxd, tlas_box, tlas_link, tlas_prim,
                  w2l, obj_mesh, blas_root, blas_box, blas_link, blas_prim, tri_dt, tri_f32};
  const Outs out{t_out, u_out, v_out, tri_out, obj_out, stats};
  const Consts c{scene_slop, object_slop, d1, d2, point2, big};
  const float4* p4 = reinterpret_cast<const float4*>(pad4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == 0)
    return launch_stack_dt<0>(tb, order, p4, out, R, find_any, fallback, max_iters, c, s);
  if (dt == 1)
    return launch_stack_dt<1>(tb, order, p4, out, R, find_any, fallback, max_iters, c, s);
  if (dt == 2)
    return launch_stack_dt<2>(tb, order, p4, out, R, find_any, fallback, max_iters, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
