// The warp walk of a tree of boxes over a coefficient table, shared by K1b
// (dense_multi.cu: the chunk tree and its 32-row slice boxes) and K6
// (packet_trace.cu: the packet BVH, whose level-1 nodes are exactly its
// 128-row chunks and whose leaves are its 32-row slices).
//
// chunk_walk_kernel<FORM, PACK, ANY, PERSIST, EXACT0>: closest or any hit
// (or, under PACK, K1b's packed epilogue) for the forms whose acceptance
// stays inside the triangle ('mxu3' and the f32 'both' bands).  `boxes` and
// `levels` hold a 4-ary tree whose level 0 is the 128-row chunks, `slices`
// the 32-row slice boxes (4 a chunk), `lanes` the table re-laid for the walk
// (ops/dense_trace.py:lane_table).
// - Each lane walks its ray's tree nearest entry first with a stack in
//   shared memory of `stack_cap` entries (3 (levels - 1) + 1,
//   ops/dense_trace.py:walk_stack); a push past it sets *status (the
//   wrapper raises), so no walk is cut short silently.
// - A lane whose walk reaches a chunk slab-tests the chunk's four slices and
//   waits with those its segment enters.  The warp then takes its waiting
//   chunks one at a time: the lanes waiting on that chunk
//   (__match_any_sync) form a group, and each ray of the group is tested
//   by all 32 lanes against its slices, one row a lane (a slice's rows are
//   three 16-byte loads coalesced across the warp); the group's rays run
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

#pragma once

#include "trace_common.cuh"

#define LPRT_WALK_CHUNK 128
#define LPRT_WALK_SLICES 4  // 32-row slices per chunk: one row per lane each
#define LPRT_WALK_BLOCK 128
#define LPRT_WALK_MIN_BLOCKS 8  // resident blocks an SM: at most 64 registers a thread
// The forms that walk (their acceptance stays inside the triangle): 'mxu3'
// and the f32 'both' bands.
#define LPRT_WALK_FORMS(X) X(0) X(1) X(2)

namespace lprt {
namespace walk {

constexpr unsigned FULL = 0xffffffffu;

template <bool EXACT0>
__device__ __forceinline__ bool walk_box(const float* __restrict__ b, float ox, float oy,
                                         float oz, float ix, float iy, float iz, float maxd,
                                         float* entry) {
  return EXACT0 ? box_entry_exact0(b, ox, oy, oz, ix, iy, iz, maxd, entry)
                : box_entry(b, ox, oy, oz, ix, iy, iz, maxd, entry);
}

// one lane's ray and its walk
struct Walker {
  int r = -1;  // the ray, -1: none
  float ox, oy, oz, dx, dy, dz, mn, mx, ix, iy, iz;
  int sk;
  float bt = 1e5f, bu = 0.f, bv = 0.f;
  int btri = -1, brow = -1;
  PackedBest pb;
  bool blocked = false;
  int sp = 0;
  int pend = -1;      // the chunk this lane waits on
  unsigned smask = 0;  // ... and its slices to test
};

template <int FORM, bool PACK, bool ANY, bool PERSIST, bool EXACT0>
__global__ void __launch_bounds__(LPRT_WALK_BLOCK, LPRT_WALK_MIN_BLOCKS)
chunk_walk_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
                  const int* __restrict__ skip, const float* __restrict__ mind,
                  const float* __restrict__ maxd, const float4* __restrict__ lanes,
                  const int* __restrict__ tri_id, const int* __restrict__ obj_id,
                  const float* __restrict__ boxes, const float* __restrict__ slices,
                  const int* __restrict__ levels, int n_levels, int R, int TI,
                  int stack_cap, Band band, float* __restrict__ t_out,
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
  constexpr int LMASK = LPRT_WALK_CHUNK - 1;  // the packed key's local-row bits
  const int lane = threadIdx.x & 31;
  const int bd = blockDim.x;
  int2* st = s_stack + threadIdx.x;
  const int top = n_levels - 1;
  Walker w;

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
    float e;
    if (walk_box<EXACT0>(boxes + 6 * s_off[top], w.ox, w.oy, w.oz, w.ix, w.iy, w.iz, w.mx, &e)) {
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
        if (lvl == 0) {
          unsigned m = 0;
#pragma unroll
          for (int q = 0; q < LPRT_WALK_SLICES; ++q) {
            const int sl = LPRT_WALK_SLICES * idx + q;
            float es;
            if (sl * 32 < TI &&
                walk_box<EXACT0>(slices + 6 * sl, w.ox, w.oy, w.oz, w.ix, w.iy, w.iz, w.mx, &es) &&
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
              walk_box<EXACT0>(boxes + 6 * (s_off[cl] + ch), w.ox, w.oy, w.oz, w.ix, w.iy, w.iz,
                        w.mx, &e)) {
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
#pragma unroll
        for (int q = 0; q < LPRT_WALK_SLICES; ++q) {
          if (!(m & (1u << q))) continue;
          const int k = kbase + 32 * q + lane;
          float t, u, v;
          // row 32 q + lane of the chunk: 16-byte loads coalesced across the
          // warp (lane_table), from L1 for the group's later rays
          const float4* src = lanes + (size_t)(LPRT_WALK_SLICES * chunk + q) * 96 + lane;
          const float4 a = __ldg(src), b = __ldg(src + 32), d = __ldg(src + 64);
          const float c[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, d.x, d.y, d.z, d.w};
          const bool geom = tri_test<FORM>(c, ox, oy, oz, dx, dy, dz, nullptr, band, t, u, v);
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
                int R, int TI, int stack_cap, Band band, float* t_out, float* u_out,
                float* v_out, int* tri_out, int* obj_out, int* status, cudaStream_t s) {
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
                                       t_out, u_out, v_out, tri_out, obj_out, status);
  return (int)cudaGetLastError();
}

template <int FORM, bool PACK, bool ANY, bool EXACT0>
int launch_walk_p(int persist, const float* orig, const float* dir, const int* skip,
                  const float* mind, const float* maxd, const float4* lanes, const int* tri_id,
                  const int* obj_id, const float* boxes, const float* slices,
                  const int* levels, int n_levels, int R, int TI, int stack_cap, Band band,
                  float* t_out, float* u_out, float* v_out, int* tri_out, int* obj_out,
                  int* status, cudaStream_t s) {
  return persist ? launch_walk<FORM, PACK, ANY, true, EXACT0>(
                       orig, dir, skip, mind, maxd, lanes, tri_id, obj_id, boxes, slices,
                       levels, n_levels, R, TI, stack_cap, band, t_out, u_out, v_out, tri_out,
                       obj_out, status, s)
                 : launch_walk<FORM, PACK, ANY, false, EXACT0>(
                       orig, dir, skip, mind, maxd, lanes, tri_id, obj_id, boxes, slices,
                       levels, n_levels, R, TI, stack_cap, band, t_out, u_out, v_out, tri_out,
                       obj_out, status, s);
}

// The walk's entry: checks the arguments, then launches the form's kernel
// (PACKABLE: K1b's packed epilogue under 'mxu3'); -> cudaError_t.
template <bool PACKABLE, bool EXACT0>
int launch_walk_forms(const float* orig, const float* dir, const int* skip, const float* mind,
                      const float* maxd, const float* lanes, const int* tri_id,
                      const int* obj_id, const float* boxes, const float* slices,
                      const int* levels, int n_levels, int R, int TI, int find_any, int pack,
                      int form, int stack_cap, int persist, float k0, float k1, float k2,
                      float* t_out, float* u_out, float* v_out, int* tri_out, int* obj_out,
                      int* status, void* stream) {
  if (n_levels < 1 || n_levels > LPRT_MAX_LEVELS || !valid_form(form) || LPRT_WIDENED(form) ||
      stack_cap < 1 || stack_cap > LPRT_MAX_STACK ||
      (long long)TI > ((long long)LPRT_WALK_CHUNK << LPRT_IDX_BITS) ||
      (pack && (!PACKABLE || find_any || form != 0)))
    return (int)cudaErrorInvalidValue;
  const Band band = {k0, k1, k2};
  const float4* l4 = reinterpret_cast<const float4*>(lanes);
  cudaStream_t s = (cudaStream_t)stream;
#define LPRT_WALK_ARGS                                                                      \
  persist, orig, dir, skip, mind, maxd, l4, tri_id, obj_id, boxes, slices, levels, n_levels, \
      R, TI, stack_cap, band, t_out, u_out, v_out, tri_out, obj_out, status, s
  if constexpr (PACKABLE) {
    if (pack) return launch_walk_p<0, true, false, EXACT0>(LPRT_WALK_ARGS);
  }
#define LPRT_WALK_FORM(f)                                                  \
  if (form == (f))                                                         \
    return find_any ? launch_walk_p<(f), false, true, EXACT0>(LPRT_WALK_ARGS) \
                    : launch_walk_p<(f), false, false, EXACT0>(LPRT_WALK_ARGS);
  LPRT_WALK_FORMS(LPRT_WALK_FORM)
#undef LPRT_WALK_FORM
#undef LPRT_WALK_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace walk
}  // namespace lprt
