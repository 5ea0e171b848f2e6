// The warp walk of a tree of boxes over a coefficient table, shared by K1b
// (dense_multi.cu: the chunk tree and its 32-row slice boxes) and K6
// (packet_trace.cu: the packet BVH, whose level-1 nodes are exactly its
// 128-row chunks and whose leaves are its 32-row slices).
//
// chunk_walk_kernel<FORM, PACK, ANY, PERSIST, EXACT0>: closest or any hit
// (or, under PACK, K1b's packed epilogue) under every acceptance form.
// `boxes` and `levels` hold a 4-ary tree whose level 0 is the 128-row
// chunks, `slices` the 32-row slice boxes (4 a chunk), `lanes` the table
// re-laid for the walk (ops/dense_trace.py:lane_table; 12 floats a row, 28
// in a sub-f32 form).
// - Each lane walks its ray's tree nearest entry first with a stack in
//   shared memory of `stack_cap` entries (3 (levels - 1) + 1,
//   ops/dense_trace.py:walk_stack); a push past it sets *status (the
//   wrapper raises), so no walk is cut short silently.
// - A lane whose walk reaches a chunk slab-tests the chunk's four slices and
//   waits with those its segment enters.  The warp then takes its waiting
//   chunks one at a time: the lanes waiting on that chunk
//   (__match_any_sync) form a group, and each ray of the group is tested
//   by all 32 lanes against its slices, one row a lane (a slice's rows are
//   ROW / 4 16-byte loads coalesced across the warp); the group's rays run
//   back to back, so after the first their row loads hit L1.  (Keeping a
//   group's slices in registers instead was slower on the H100: the
//   registers it took halved the warps an SM holds.)  A ballot finds
//   the lanes whose row would accept (their triangle ids, for the skip test,
//   are read for those lanes alone); their (t, tri, row) reach the ray's
//   lane by shuffles in (t, tri, row) order (closest hit), their keys by a
//   warp minimum (pack), or the ray is blocked and leaves the walk at once
//   (any hit).
// - PERSIST: a grid of resident blocks pulls rays from a counter
//   (status[1]), so a lane whose ray finishes takes the next one.
// - EXACT0: the boxes are tested by box_entry_exact0 (exact on a zero
//   direction axis, K6), else by box_entry (K1b).
// The boxes are conservative under either rule and ties go by (t, tri, row),
// so the result does not depend on the walk or on which lanes test which
// rows: it equals the plain version's global minimum bit for bit.  A slice
// is skipped when the segment does not enter it (it holds no accepted row)
// and, in closest hit without pack, when its entry lies beyond the best t;
// under pack a slice beyond the best t is still tested, since its rows take
// part in their chunk's key minimum.
//
// Why the boxes stay conservative under a widened acceptance (LPRT_WIDENED:
// the sub-f32 bands and 'dtype'), whose test accepts points outside its
// triangle.  The walk grows each box it tests for the ray it tests it for
// (walk_box, from WalkPads; ops/band_pad.py carries the arithmetic in
// full).  The claim: every point P = o + t d that a row accepts, at a t the
// walk still has to keep, lies in the row's slice box and in each box above
// it, grown for the ray.
// 1. The row's f32 coefficients map P to edge coordinates (u, v, z) = n P +
//    e, whose inverse maps (u, v, 0) to u V0 + v V1 + w V2 (w = 1 - u - v):
//    the triangle the f32 row describes.  If u, v, w >= -du, -dv, -dw, each
//    coordinate of P lies within (du + dv + dw) span_a of the vertices'
//    range on axis a (span_a its extent there): only negative weights pull
//    P outside, by at most their size times span_a.  The plane is the f32
//    plane in every form (t = -Oz / Dz from columns 6-8 and 11), so P sits
//    on it as closely as under the strict test, whose tolerance the boxes'
//    widening (models/scene.py:_group_aabbs) already covers, as it covers
//    the vertex range of the f32 row's triangle against the true one.
// 2. du: the kernel's u (tri_test_oz) is within dev_u of P's exact u:
//    the band rows b differ from the f32 rows n by |b_i - n_i| (read from
//    the table), the operand q from the ray by eps_q |o_i| + eta (2^-8
//    bf16, 2^-11 fp16, 0 in fp32; eta the type's subnormal half-spacing),
//    every product of the sub-f32 forms is exact in f32 and every sum rounds
//    in f32 (gamma_8), so dev_u = sum_i c_i (|o_i| + |t d_i|) + constants,
//    c_i = |b_i - n_i| + (eps_q + gamma_8) |b_i|.  Under 'dtype' the test
//    also accepts u > -eu, and the kernel's eu is itself at most a sum of
//    the same form, from the S rows, |Ox| and |t Dx|.  Under 'both' a lane
//    outside the band passes only with u, v and w all computed > 0, and a
//    lane inside it takes the strict f32 test.  dw <= du + dv plus the
//    rounding of w and of the compare, which a relative margin of 2^-16 and
//    an absolute 2^-20 cover (|u|, |v| <= 1 + 2 (eu + ev) where accepted).
// 3. So the row's pad on axis a is Delta span_a, Delta = 2 (1 + 2^-16)
//    (du + dv) + 2^-20: linear in (1, O_i, T_i, T_t) with O_i >= |o_i| and
//    |q_i|, T_i >= |t| |d_i| and |t| |q'_i|, T_t >= |t|.  A slice or chunk
//    box takes the largest coefficient of its rows, a node the largest of
//    its children's, so a grown node holds every grown box below it; a box
//    keeps four numbers, c0 (the constant), cO (O_i), cT (T_i), ct (T_t),
//    each the largest over its axes (and i), so with Os = sum_i O_i and Ds
//    = sum_i T_i / |t| its pad on every axis is at most c0 + cO Os + |t| (cT
//    Ds + ct).  A row whose plane columns are not all finite (a triangle of
//    no area) accepts nothing, since the kernel accepts a finite t only and
//    t = -Oz / Dz is then NaN or infinite for every finite ray: its pad is
//    0.  A row with a finite plane whose pad is not finite takes one that
//    covers every point the ray reaches.
// 4. The pad grows with |t|, so it is taken at tr >= |t| of every point
//    the walk still has to keep (pad_t): in any hit and under pack the
//    ray's reach (WalkPads::ray.z: max(|mind|, |maxd|), and on each axis a
//    where |d_a| > P1_a the scene's bound (W_a + P0_a) / (|d_a| - P1_a), P
//    lying in the root box grown by P0_a + P1_a |t| and |t| |d_a| from o on
//    a); in closest hit also max(|mind|, best t), since a hit that can still
//    win has t <= the best t (ties included), the best t starts at the miss
//    value 1e5 that no winner reaches, and a box tested while the best t
//    was larger was grown more, so it holds what it must.  A box also
//    bounds |t| of an accepted point inside it: the point lies in the box
//    grown by P0 + P1 |t| (P0 = c0 + cO Os, P1 = cT Ds + ct) and |t| |d_la|
//    from o on the ray's longest axis la, so |t| <= (W + P0) / (|d_la| -
//    P1) where |d_la| > P1, W the distance from o to the box's far side on
//    la: the box is grown at the smaller of that and tr.  The ray's Os,
//    Ds and reach and the box's four numbers are rounded up to f32 by the
//    wrapper, and here every step rounds the way that grows the box (the
//    pad's sums and the bound's numerator up, its denominator down, its
//    quotient lifted past the exact one; the operands are >= 0) and each
//    grown bound outward, so the box tested holds the box grown by the
//    exact pad.  The wrapper
//    raises where a live ray's largest pad is not finite or its slab
//    distances could overflow on its longest axis (band_pad.check_reach),
//    since box_entry enters no box whose slab distances are all infinite.
// 5. The slab test then finds the segment entering each grown box no later
//    than t, within its 0.02 slop, as for the strict walk; on a zero
//    direction axis (EXACT0) P_a = o_a, and P lies in the grown box, so the
//    origin does: the rule's LPRT_ZERO_AXIS_MARGIN is needed only for the
//    strict test's rounding, as before.  Ties, the any-hit exit and the
//    packed rule are untouched, so the walk equals the all-row scan
//    (trace_common.cuh:scan_trace_kernel) bit for bit.
// Plain version of the pad: ops/band_pad.py (band_pad.grow: the box as
// walk_box grows it); its bound is checked in float64 on random rows and
// rays, and the padded walk emulated against the all-row plain version, by
// tests/test_torch_band_walk.py.

#pragma once

#include "trace_common.cuh"

#define LPRT_WALK_CHUNK 128
#define LPRT_WALK_SLICES 4  // 32-row slices per chunk: one row per lane each
#define LPRT_WALK_BLOCK 128
#define LPRT_WALK_MIN_BLOCKS 8  // resident blocks an SM: at most 64 registers a thread
// ... under a widened form, whose band test holds more values live: at
// most 128 registers a thread
#define LPRT_WALK_MIN_BLOCKS_WIDE 4
// The forms K6 is built for: 'mxu3' and the packet kernel's band in each
// precision and acceptance (K1b takes every form, LPRT_FORMS).
#define LPRT_PACKET_FORMS(X) X(0) X(2) X(6) X(10) X(14) X(18) X(22)

namespace lprt {
namespace walk {

constexpr unsigned FULL = 0xffffffffu;

// A widened form's pads (ops/band_pad.py): per tree box and per slice box
// c = (c0, cO, cT, ct), per ray r = (Os, Ds, reach, 0); the ray's pad at
// |t| <= tr is c0 + cO Os + tr (cT Ds + ct) on every axis (null pointers in
// the other forms).
struct WalkPads {
  const float4* __restrict__ box;
  const float4* __restrict__ slice;
  const float4* __restrict__ ray;
};

// one lane's ray and its walk
struct Walker {
  int r = -1;  // the ray, -1: none
  float ox, oy, oz, dx, dy, dz, mn, mx, ix, iy, iz;
  int sk;
  // a widened form's ray pad (WalkPads::ray), and the ray's longest axis la
  // with o and |d| on it
  float ps = 0.f, pd = 0.f, pr = 0.f, ol = 0.f, adl = 0.f;
  int la = 0;
  float bt = 1e5f, bu = 0.f, bv = 0.f;
  int btri = -1, brow = -1;
  PackedBest pb;
  bool blocked = false;
  int sp = 0;
  int pend = -1;      // the chunk this lane waits on
  unsigned smask = 0;  // ... and its slices to test
};

// box i of `b` (6 floats a box) against w's ray; under a widened form
// grown by the ray's pad at |t| <= min(tr, tb), tb the box's own bound on
// |t| of an accepted point inside it (on the ray's longest axis la, with
// P0 = c0 + cO Os and P1 = cT Ds + ct: |t| |d_la| <= W + P0 + P1 |t|, W
// the distance from o to the box's far side on la), from c = pads[i];
// every operation rounds the way that makes the box larger (the pad's
// operands are >= 0), each bound outward, so the box tested holds the box
// grown by the exact pad.
template <bool EXACT0, bool WIDE>
__device__ __forceinline__ bool walk_box(const float* __restrict__ b, const float4* pads, int i,
                                         const Walker& w, float tr, float* entry) {
  const float* bb = b + 6 * i;
  if (!WIDE) {
    return EXACT0 ? box_entry_exact0(bb, w.ox, w.oy, w.oz, w.ix, w.iy, w.iz, w.mx, entry)
                  : box_entry(bb, w.ox, w.oy, w.oz, w.ix, w.iy, w.iz, w.mx, entry);
  }
  float v[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = __ldg(bb + k);
  const float4 c = __ldg(pads + i);
  const float P0 = __fmaf_ru(c.y, w.ps, c.x), P1 = __fmaf_ru(c.z, w.pd, c.w);
  const float lo = w.la == 0 ? v[0] : (w.la == 1 ? v[1] : v[2]);
  const float hi = w.la == 0 ? v[3] : (w.la == 1 ? v[4] : v[5]);
  const float num = __fadd_ru(fmaxf(__fsub_ru(hi, w.ol), __fsub_ru(w.ol, lo)), P0);
  const float den = __fsub_rd(w.adl, P1);
  // __fdividef is at most 2 ulp off for a divisor in [2^-126, 2^126]; the
  // factor 1 + 2^-20, rounded up, lifts it past the exact quotient
  if (den >= 0x1p-126f && den <= 0x1p126f)
    tr = fminf(tr, __fmul_ru(__fdividef(num, den), 1.f + 0x1p-20f));
  const float p = __fmaf_ru(tr, P1, P0);
  auto g = [&](int k) { return k < 3 ? __fsub_rd(v[k], p) : __fadd_ru(v[k], p); };
  return EXACT0 ? box_entry_exact0_at(g, w.ox, w.oy, w.oz, w.ix, w.iy, w.iz, w.mx, entry)
                : box_entry_at(g, w.ox, w.oy, w.oz, w.ix, w.iy, w.iz, w.mx, entry);
}


template <int FORM, bool PACK, bool ANY, bool PERSIST, bool EXACT0>
__global__ void __launch_bounds__(LPRT_WALK_BLOCK, LPRT_WIDENED(FORM)
                                                       ? LPRT_WALK_MIN_BLOCKS_WIDE
                                                       : LPRT_WALK_MIN_BLOCKS)
chunk_walk_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
                  const int* __restrict__ skip, const float* __restrict__ mind,
                  const float* __restrict__ maxd, const float4* __restrict__ lanes,
                  const int* __restrict__ tri_id, const int* __restrict__ obj_id,
                  const float* __restrict__ boxes, const float* __restrict__ slices,
                  const int* __restrict__ levels, int n_levels, int R, int TI,
                  int stack_cap, Band band, WalkPads pads, float* __restrict__ t_out,
                  float* __restrict__ u_out, float* __restrict__ v_out,
                  int* __restrict__ tri_out, int* __restrict__ obj_out,
                  int* __restrict__ status) {
  extern __shared__ int2 s_stack[];  // entry e of thread i at [e * blockDim.x + i]
  __shared__ int s_off[LPRT_MAX_LEVELS], s_n[LPRT_MAX_LEVELS];
  if (threadIdx.x < n_levels) {
    s_off[threadIdx.x] = levels[threadIdx.x];
    s_n[threadIdx.x] = levels[n_levels + threadIdx.x];
  }
  __syncthreads();

  static_assert(!PACK || !ANY, "the packed epilogue is closest hit");
  constexpr int ROW = LPRT_ROW(FORM);  // floats a row: 12, or 28 with the band rows
  constexpr int LMASK = LPRT_WALK_CHUNK - 1;  // the packed key's local-row bits
  const int lane = threadIdx.x & 31;
  const int bd = blockDim.x;
  int2* st = s_stack + threadIdx.x;
  const int top = n_levels - 1;
  constexpr bool WIDE = LPRT_WIDENED(FORM);
  Walker w;
  // the |t| up to which a box is grown: the ray's reach in any hit and
  // under pack, else no farther than the best hit so far
  auto pad_t = [&](float best) {
    return (ANY || PACK) ? w.pr : fminf(w.pr, fmaxf(fabsf(w.mn), best));
  };

  auto begin = [&](int rr) {
    w = Walker();
    w.r = rr;
    if (rr < 0) return;
    w.ox = orig[3 * rr];
    w.oy = orig[3 * rr + 1];
    w.oz = orig[3 * rr + 2];
    w.dx = dir[3 * rr];
    w.dy = dir[3 * rr + 1];
    w.dz = dir[3 * rr + 2];
    w.mn = mind[rr];
    w.mx = maxd[rr];
    w.sk = skip[rr];
    if (!(w.mx > w.mn)) return;  // a dead lane walks nothing
    w.ix = 1.f / w.dx;
    w.iy = 1.f / w.dy;
    w.iz = 1.f / w.dz;
    if (WIDE) {
      const float4 rp = pads.ray[rr];
      w.ps = rp.x;
      w.pd = rp.y;
      w.pr = rp.z;
      const float ax = fabsf(w.dx), ay = fabsf(w.dy), az = fabsf(w.dz);
      w.la = (ax >= ay && ax >= az) ? 0 : (ay >= az ? 1 : 2);
      w.ol = w.la == 0 ? w.ox : (w.la == 1 ? w.oy : w.oz);
      w.adl = w.la == 0 ? ax : (w.la == 1 ? ay : az);
    }
    float e;
    if (walk_box<EXACT0, WIDE>(boxes, pads.box, s_off[top], w, pad_t(w.bt), &e)) {
      st[0] = make_int2(top << LPRT_IDX_BITS, __float_as_int(e));
      w.sp = 1;
    }
  };
  auto finish = [&]() {
    const int rr = w.r;
    if (PACK) {  // (t, row, pk) into (t_out, tri_out, obj_out)
      t_out[rr] = w.pb.t;
      tri_out[rr] = w.pb.row;
      obj_out[rr] = w.pb.pk();
    } else if (ANY) {
      t_out[rr] = 1e5f;
      u_out[rr] = 0.f;
      v_out[rr] = 0.f;
      tri_out[rr] = w.blocked ? 0 : -1;
      obj_out[rr] = -1;
    } else {
      t_out[rr] = w.bt;
      u_out[rr] = w.bu;
      v_out[rr] = w.bv;
      tri_out[rr] = w.btri;
      obj_out[rr] = w.brow >= 0 ? __ldg(obj_id + w.brow) : -1;
    }
    w.r = -1;
  };

  bool more = PERSIST;  // warp-uniform: the counter may still hand out rays
  if (!PERSIST) {
    const int rr = blockIdx.x * bd + threadIdx.x;
    begin(rr < R ? rr : -1);
  }
  while (true) {
    if (PERSIST && more) {  // lanes without a ray take the next ones
      const unsigned idle = __ballot_sync(FULL, w.r < 0);
      if (idle) {
        int base = 0;
        if (lane == 0) base = atomicAdd(status + 1, __popc(idle));
        base = __shfl_sync(FULL, base, 0);
        if (base + __popc(idle) >= R) more = false;
        if (w.r < 0) {
          const int rr = base + __popc(idle & ((1u << lane) - 1u));
          begin(rr < R ? rr : -1);
        }
      }
    }
    // walk to the next chunk whose slices the segment enters
    if (w.r >= 0) {
      while (w.sp > 0) {
        --w.sp;
        const int2 ent = st[w.sp * bd];
        const float best = PACK ? w.pb.t : w.bt;
        if (!ANY && __int_as_float(ent.y) > best) continue;
        const int lvl = ent.x >> LPRT_IDX_BITS;
        const int idx = ent.x & ((1 << LPRT_IDX_BITS) - 1);
        const float tr = pad_t(best);
        if (lvl == 0) {
          unsigned m = 0;
#pragma unroll
          for (int q = 0; q < LPRT_WALK_SLICES; ++q) {
            const int sl = LPRT_WALK_SLICES * idx + q;
            float es;
            if (sl * 32 < TI &&
                walk_box<EXACT0, WIDE>(slices, pads.slice, sl, w, tr, &es) &&
                (ANY || PACK || es <= best))
              m |= 1u << q;
          }
          if (m) {
            w.pend = idx;
            w.smask = m;
            break;
          }
          continue;
        }
        // children of an internal node, pushed farthest entry first (equal
        // entries: the lower index on top)
        const int cl = lvl - 1;
        const int c0 = idx * LPRT_FAN;
        float ce[LPRT_FAN];
        int cn[LPRT_FAN];
        int n = 0;
#pragma unroll
        for (int q = 0; q < LPRT_FAN; ++q) {
          const int ch = c0 + q;
          float e = -1.f;  // entries are >= 0; -1 marks a child not pushed
          if (ch < s_n[cl] &&
              walk_box<EXACT0, WIDE>(boxes, pads.box, s_off[cl] + ch, w, tr, &e)) {
            if (!ANY && e > best) e = -1.f;
          } else {
            e = -1.f;
          }
          ce[q] = e;
          cn[q] = ch;
          n += e >= 0.f;
        }
        const int pairs[5][2] = {{0, 1}, {2, 3}, {0, 2}, {1, 3}, {1, 2}};
#pragma unroll
        for (int pq = 0; pq < 5; ++pq) {
          const int a = pairs[pq][0], b = pairs[pq][1];
          if (ce[b] > ce[a] || (ce[b] == ce[a] && cn[b] > cn[a])) {
            const float te = ce[a];
            const int tn = cn[a];
            ce[a] = ce[b];
            cn[a] = cn[b];
            ce[b] = te;
            cn[b] = tn;
          }
        }
        if (w.sp + n > stack_cap) {
          atomicOr(status, 1);
          w.sp = 0;
          break;
        }
#pragma unroll
        for (int q = 0; q < LPRT_FAN; ++q) {
          if (q < n) {
            st[(w.sp + q) * bd] = make_int2((cl << LPRT_IDX_BITS) | cn[q], __float_as_int(ce[q]));
          }
        }
        w.sp += n;
      }
      if (w.pend < 0) finish();
    }

    unsigned pmask = __ballot_sync(FULL, w.pend >= 0);
    if (pmask == 0) {
      if (!more) break;
      continue;
    }
    // the warp's waiting chunks, one group of lanes at a time
    const unsigned groups = __match_any_sync(FULL, w.pend);
    while (pmask) {
      const int leader = __ffs(pmask) - 1;
      const int chunk = __shfl_sync(FULL, w.pend, leader);
      unsigned g = __shfl_sync(FULL, groups, leader) & pmask;
      pmask &= ~g;
      const int kbase = chunk * LPRT_WALK_CHUNK;
      while (g) {
        const int owner = __ffs(g) - 1;
        g &= g - 1;
        const float ox = __shfl_sync(FULL, w.ox, owner), oy = __shfl_sync(FULL, w.oy, owner),
                    oz = __shfl_sync(FULL, w.oz, owner), dx = __shfl_sync(FULL, w.dx, owner),
                    dy = __shfl_sync(FULL, w.dy, owner), dz = __shfl_sync(FULL, w.dz, owner),
                    mn = __shfl_sync(FULL, w.mn, owner), mx = __shfl_sync(FULL, w.mx, owner);
        const int sk = __shfl_sync(FULL, w.sk, owner);
        const unsigned m = __shfl_sync(FULL, w.smask, owner);
        float qo[6];  // a sub-f32 form's ray operand, rounded once per ray
        if (LPRT_OPERAND(FORM)) make_operand<FORM>(ox, oy, oz, dx, dy, dz, qo);
#pragma unroll
        for (int q = 0; q < LPRT_WALK_SLICES; ++q) {
          if (!(m & (1u << q))) continue;
          const int k = kbase + 32 * q + lane;
          float t, u, v;
          // row 32 q + lane of the chunk: ROW / 4 16-byte loads coalesced
          // across the warp (lane_table), from L1 for the group's later rays
          const float4* src =
              lanes + (size_t)(LPRT_WALK_SLICES * chunk + q) * (8 * ROW) + lane;
          float c[ROW];
#pragma unroll
          for (int j = 0; j < ROW / 4; ++j) {
            const float4 p = __ldg(src + 32 * j);
            c[4 * j] = p.x;
            c[4 * j + 1] = p.y;
            c[4 * j + 2] = p.z;
            c[4 * j + 3] = p.w;
          }
          const bool geom = tri_test<FORM>(c, ox, oy, oz, dx, dy, dz, qo, band, t, u, v);
          const bool in = k < TI && geom && (t > mn) && (t < mx) && isfinite(t);
          // the triangle id matters only where a row would accept: read it
          // for those lanes alone
          if (!__any_sync(FULL, in)) continue;
          const int tri = in ? __ldg(tri_id + k) : -1;
          bool acc = in && tri != sk;
          if (ANY) {
            if (__any_sync(FULL, acc)) {
              if (lane == owner) {
                w.blocked = true;
                w.sp = 0;
              }
              break;
            }
            continue;
          }
          if (PACK) {
            acc = acc && t > 0.f;
            const int key = acc ? ((__float_as_int(t) & ~LMASK) | (32 * q + lane)) : INT_MAX;
            const int kmin = __reduce_min_sync(FULL, key);
            if (kmin != INT_MAX) {
              const int wl = kmin & 31;
              const float wt = __shfl_sync(FULL, t, wl), wu = __shfl_sync(FULL, u, wl),
                          wv = __shfl_sync(FULL, v, wl);
              if (lane == owner && kmin < w.pb.kmin) {
                w.pb.kmin = kmin;
                w.pb.ct = wt;
                w.pb.cu = wu;
                w.pb.cv = wv;
              }
            }
            continue;
          }
          unsigned hits = __ballot_sync(FULL, acc);
          while (hits) {
            const int wl = __ffs(hits) - 1;
            hits &= hits - 1;
            const float wt = __shfl_sync(FULL, t, wl), wu = __shfl_sync(FULL, u, wl),
                        wv = __shfl_sync(FULL, v, wl);
            const int wtri = __shfl_sync(FULL, tri, wl);
            const int wk = kbase + 32 * q + wl;
            if (lane == owner &&
                (wt < w.bt || (wt == w.bt && (wtri < w.btri || (wtri == w.btri && wk < w.brow))))) {
              w.bt = wt;
              w.bu = wu;
              w.bv = wv;
              w.btri = wtri;
              w.brow = wk;
            }
          }
        }
        if (PACK && lane == owner) w.pb.end_chunk(kbase, LMASK);
      }
    }
    w.pend = -1;
  }
}

template <int FORM, bool PACK, bool ANY, bool PERSIST, bool EXACT0>
int launch_walk(const float* orig, const float* dir, const int* skip, const float* mind,
                const float* maxd, const float4* lanes, const int* tri_id, const int* obj_id,
                const float* boxes, const float* slices, const int* levels, int n_levels,
                int R, int TI, int stack_cap, Band band, WalkPads pads, float* t_out,
                float* u_out, float* v_out, int* tri_out, int* obj_out, int* status,
                cudaStream_t s) {
  auto kernel = chunk_walk_kernel<FORM, PACK, ANY, PERSIST, EXACT0>;
  const size_t smem = sizeof(int2) * (size_t)stack_cap * LPRT_WALK_BLOCK;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int grid = (R + LPRT_WALK_BLOCK - 1) / LPRT_WALK_BLOCK;
  if (PERSIST) {  // resident blocks only: they pull the rays from status[1]
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, LPRT_WALK_BLOCK, smem)) !=
            cudaSuccess)
      return (int)e;
    const int resident = sms * per_sm > 0 ? sms * per_sm : 1;
    if (grid > resident) grid = resident;
  }
  if (grid == 0) return (int)cudaGetLastError();
  kernel<<<grid, LPRT_WALK_BLOCK, smem, s>>>(orig, dir, skip, mind, maxd, lanes, tri_id, obj_id,
                                       boxes, slices, levels, n_levels, R, TI, stack_cap, band,
                                       pads, t_out, u_out, v_out, tri_out, obj_out, status);
  return (int)cudaGetLastError();
}

template <int FORM, bool PACK, bool ANY, bool EXACT0>
int launch_walk_p(int persist, const float* orig, const float* dir, const int* skip,
                  const float* mind, const float* maxd, const float4* lanes, const int* tri_id,
                  const int* obj_id, const float* boxes, const float* slices,
                  const int* levels, int n_levels, int R, int TI, int stack_cap, Band band,
                  WalkPads pads, float* t_out, float* u_out, float* v_out, int* tri_out,
                  int* obj_out, int* status, cudaStream_t s) {
  return persist ? launch_walk<FORM, PACK, ANY, true, EXACT0>(
                       orig, dir, skip, mind, maxd, lanes, tri_id, obj_id, boxes, slices,
                       levels, n_levels, R, TI, stack_cap, band, pads, t_out, u_out, v_out,
                       tri_out, obj_out, status, s)
                 : launch_walk<FORM, PACK, ANY, false, EXACT0>(
                       orig, dir, skip, mind, maxd, lanes, tri_id, obj_id, boxes, slices,
                       levels, n_levels, R, TI, stack_cap, band, pads, t_out, u_out, v_out,
                       tri_out, obj_out, status, s);
}

// The walk's entry: checks the arguments, then launches the form's kernel
// (PACKABLE: K1b, every form and the packed epilogue under
// LPRT_PACK_FORMS; else K6, LPRT_PACKET_FORMS); -> cudaError_t.
template <bool PACKABLE, bool EXACT0>
int launch_walk_forms(const float* orig, const float* dir, const int* skip, const float* mind,
                      const float* maxd, const float* lanes, const int* tri_id,
                      const int* obj_id, const float* boxes, const float* slices,
                      const int* levels, const float* box_pads, const float* slice_pads,
                      const float* ray_pads, int n_levels, int R, int TI, int find_any, int pack,
                      int form, int stack_cap, int persist, float k0, float k1, float k2,
                      float* t_out, float* u_out, float* v_out, int* tri_out, int* obj_out,
                      int* status, void* stream) {
  if (n_levels < 1 || n_levels > LPRT_MAX_LEVELS || !valid_form(form) || stack_cap < 1 ||
      stack_cap > LPRT_MAX_STACK || (long long)TI > ((long long)LPRT_WALK_CHUNK << LPRT_IDX_BITS) ||
      (pack && (!PACKABLE || find_any || !valid_pack_form(form))) ||
      (LPRT_WIDENED(form) && (!box_pads || !slice_pads || !ray_pads)))
    return (int)cudaErrorInvalidValue;
  const Band band = {k0, k1, k2};
  const WalkPads pads = {reinterpret_cast<const float4*>(box_pads),
                         reinterpret_cast<const float4*>(slice_pads),
                         reinterpret_cast<const float4*>(ray_pads)};
  const float4* l4 = reinterpret_cast<const float4*>(lanes);
  cudaStream_t s = (cudaStream_t)stream;
#define LPRT_WALK_ARGS                                                                      \
  persist, orig, dir, skip, mind, maxd, l4, tri_id, obj_id, boxes, slices, levels, n_levels, \
      R, TI, stack_cap, band, pads, t_out, u_out, v_out, tri_out, obj_out, status, s
#define LPRT_WALK_FORM(f)                                                  \
  if (form == (f))                                                         \
    return find_any ? launch_walk_p<(f), false, true, EXACT0>(LPRT_WALK_ARGS) \
                    : launch_walk_p<(f), false, false, EXACT0>(LPRT_WALK_ARGS);
  if constexpr (PACKABLE) {
#define LPRT_WALK_PACK_FORM(f) \
  if (pack && form == (f)) return launch_walk_p<(f), true, false, EXACT0>(LPRT_WALK_ARGS);
    LPRT_PACK_FORMS(LPRT_WALK_PACK_FORM)
#undef LPRT_WALK_PACK_FORM
    LPRT_FORMS(LPRT_WALK_FORM)
  } else {
    LPRT_PACKET_FORMS(LPRT_WALK_FORM)
  }
#undef LPRT_WALK_FORM
#undef LPRT_WALK_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace walk
}  // namespace lprt
