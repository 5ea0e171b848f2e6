// Dense trace over a multi-chunk table (K1b): closest hit or any hit.
//
// Replaces the TPU kernel ops/dense_pallas.py:_kernel in its multi-chunk
// mode (every fallback: 'mxu3', and 'both' / 'dtype' with the dense error
// band in fp32, bf16 and fp16, :369-421: the w_cond/w_body walk at :526-610
// with the epilogues _finish_chunk :60-101, _finish_chunk_any :104-127 and,
// under dense_epilogue='pack', _finish_chunk_packed :130-180), reached
// through trace_rays_dense_pallas and trace_rays_dense_pallas_sorted.
// Plain version: ops/dense_trace.py:dense_trace_multi_plain.
//
// What it computes, per ray: the M-shift test against the instance
// triangles of the coefficient table, accepted by the band (strict under
// 'mxu3', else the dense kernel's error band), a hit also needing
// mind < t < maxd, tri != skip and a finite t.  Closest hit: the (t, tri,
// row)-lexicographic minimum, t = 1e5 / ids -1 on a miss.  Any hit: tri = 0
// if some triangle accepts, else -1; t = 1e5, u = v = 0, obj = -1 either
// way.  Under pack (closest hit; 'mxu3' and the sub-f32 dense bands,
// LPRT_PACK_FORMS) each 128-row chunk is a chunk of the packed epilogue:
// the least key (bits(t) & ~127) | local row wins the chunk, across chunks
// the least (t, row); out t, the winner's table row and its 15-bit u/v
// (trace_common.cuh:PackedBest), written into t_out, tri_out, obj_out.
//
// Design of the walk (the forms whose acceptance stays inside the
// triangle: 'mxu3' and the f32 'both' band): the rows come in 128-row
// chunks with one world AABB each (recentred like the rays), and a 4-ary
// tree over the chunk boxes (ops/dense_trace.py:build_tree); each chunk
// also has the AABBs of its four 32-row slices (the packet route's leaf
// boxes).
// - The walk state is out of local memory: each lane walks its ray's tree
//   nearest entry first with a stack in shared memory, sized by the tree's
//   depth (3 (levels - 1) + 1 entries, ops/dense_trace.py:walk_stack); a
//   push past it sets *status (the wrapper raises), so no walk is cut
//   short silently.
// - Rows are fetched by the warp and tested by every lane: a lane whose
//   walk reaches a chunk slab-tests the chunk's four slices and waits with
//   the slices its segment enters.  The warp then takes its waiting chunks
//   one at a time: the lanes waiting on that chunk (__match_any_sync) form
//   a group, and each ray of the group is tested by all 32 lanes against
//   its slices, one row a lane (the table re-laid so that a slice's rows
//   are three 16-byte loads coalesced across the warp,
//   ops/dense_trace.py:lane_table); the group's rays run back to back, so
//   after the first their row loads hit L1.  (Keeping a group's slices in
//   registers instead was slower on the H100: the registers it took halved
//   the warps an SM holds.)  A ballot finds
//   the lanes whose row would accept (their triangle ids, for the skip
//   test, are read for those lanes alone); their (t, tri, row) reach the
//   ray's lane by shuffles (closest hit), their keys by a warp minimum
//   (pack), or the ray is blocked and leaves the walk at once (any hit).
// - Divergence: only the walk between chunks runs lane by lane; with
//   `persist`, a grid of resident blocks pulls rays from a counter
//   (status[1]), so a lane whose ray finishes takes the next one.  The
//   wrapper persists in any hit, whose rays end at very different depths;
//   in closest hit the lanes keep their neighbouring rays, which share
//   chunks (on the H100 each choice was the faster for its kind).
// The boxes are conservative and ties go by (t, tri, row), so the result
// does not depend on the walk or on which lanes test which rows: it equals
// the plain version's global minimum bit for bit.  A slice is skipped when
// the segment does not enter it (it holds no accepted row) and, in closest
// hit without pack, when its entry lies beyond the best t; under pack a
// slice beyond the best t is still tested, since its rows take part in
// their chunk's key minimum.
//
// The forms whose acceptance is widened (the sub-f32 bands, and 'dtype')
// walk no tree: they scan every row in order, trace_common.cuh's
// tree_trace_kernel<128, ...> as before.
//
// The TPU kernel's tile schedule (screen blocks, per-tile chunk lists with
// packed entry words, t_cut and the overflow sweep, the scene-exit cap,
// HBM streaming) exists to feed 512-lane tiles from VMEM; a warp walk needs
// none of it.  Under 'mxu3' the TPU computes u/v/t through a bf16x3 MXU
// product (~2^-16 relative), in fp32 through an f32 dot that sums in
// another order; here they are plain f32, so the two agree to that
// accuracy, not bitwise (cross-chunk exact ties also go by walk order
// there).
//
// What bounds it on the H100: operations, by the data.  Per live ray one
// slab test (34 ops) per tree box and slice box it enters before its hit,
// and ~40 f32 operations per row of every slice it tests (~60 more in a
// band).  Built with --fmad=false so the test rounds like its plain
// version.

#include "trace_common.cuh"

#define LPRT_CHUNK 128
#define K1B_SLICES 4  // 32-row slices per chunk: one row per lane each
#define K1B_BLOCK 128
#define K1B_MIN_BLOCKS 8  // resident blocks an SM: at most 64 registers a thread

namespace {

using lprt::Band;
using lprt::PackedBest;
using lprt::box_entry;
using lprt::tri_test;

constexpr unsigned FULL = 0xffffffffu;

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

template <int FORM, bool PACK, bool ANY, bool PERSIST>
__global__ void __launch_bounds__(K1B_BLOCK, K1B_MIN_BLOCKS)
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
  constexpr int LMASK = LPRT_CHUNK - 1;  // the packed key's local-row bits
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
    if (box_entry(boxes + 6 * s_off[top], w.ox, w.oy, w.oz, w.ix, w.iy, w.iz, w.mx, &e)) {
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
          for (int q = 0; q < K1B_SLICES; ++q) {
            const int sl = K1B_SLICES * idx + q;
            float es;
            if (sl * 32 < TI &&
                box_entry(slices + 6 * sl, w.ox, w.oy, w.oz, w.ix, w.iy, w.iz, w.mx, &es) &&
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
              box_entry(boxes + 6 * (s_off[cl] + ch), w.ox, w.oy, w.oz, w.ix, w.iy, w.iz,
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
      const int kbase = chunk * LPRT_CHUNK;
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
        for (int q = 0; q < K1B_SLICES; ++q) {
          if (!(m & (1u << q))) continue;
          const int k = kbase + 32 * q + lane;
          float t, u, v;
          // row 32 q + lane of the chunk: 16-byte loads coalesced across the
          // warp (lane_table), from L1 for the group's later rays
          const float4* src = lanes + (size_t)(K1B_SLICES * chunk + q) * 96 + lane;
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

template <int FORM, bool PACK, bool ANY, bool PERSIST>
int launch_walk(const float* orig, const float* dir, const int* skip, const float* mind,
                const float* maxd, const float4* lanes, const int* tri_id, const int* obj_id,
                const float* boxes, const float* slices, const int* levels, int n_levels,
                int R, int TI, int stack_cap, Band band, float* t_out, float* u_out,
                float* v_out, int* tri_out, int* obj_out, int* status, cudaStream_t s) {
  auto kernel = chunk_walk_kernel<FORM, PACK, ANY, PERSIST>;
  const size_t smem = sizeof(int2) * (size_t)stack_cap * K1B_BLOCK;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int grid = (R + K1B_BLOCK - 1) / K1B_BLOCK;
  if (PERSIST) {  // resident blocks only: they pull the rays from status[1]
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, K1B_BLOCK, smem)) !=
            cudaSuccess)
      return (int)e;
    const int resident = sms * per_sm > 0 ? sms * per_sm : 1;
    if (grid > resident) grid = resident;
  }
  if (grid == 0) return (int)cudaGetLastError();
  kernel<<<grid, K1B_BLOCK, smem, s>>>(orig, dir, skip, mind, maxd, lanes, tri_id, obj_id,
                                       boxes, slices, levels, n_levels, R, TI, stack_cap, band,
                                       t_out, u_out, v_out, tri_out, obj_out, status);
  return (int)cudaGetLastError();
}

template <int FORM, bool PACK, bool ANY>
int launch_walk_p(int persist, const float* orig, const float* dir, const int* skip,
                  const float* mind, const float* maxd, const float4* lanes, const int* tri_id,
                  const int* obj_id, const float* boxes, const float* slices,
                  const int* levels, int n_levels, int R, int TI, int stack_cap, Band band,
                  float* t_out, float* u_out, float* v_out, int* tri_out, int* obj_out,
                  int* status, cudaStream_t s) {
  return persist ? launch_walk<FORM, PACK, ANY, true>(
                       orig, dir, skip, mind, maxd, lanes, tri_id, obj_id, boxes, slices,
                       levels, n_levels, R, TI, stack_cap, band, t_out, u_out, v_out, tri_out,
                       obj_out, status, s)
                 : launch_walk<FORM, PACK, ANY, false>(
                       orig, dir, skip, mind, maxd, lanes, tri_id, obj_id, boxes, slices,
                       levels, n_levels, R, TI, stack_cap, band, t_out, u_out, v_out, tri_out,
                       obj_out, status, s);
}

}  // namespace

// The forms that walk the tree (their acceptance stays inside the
// triangle): 'mxu3' and the f32 'both' bands; pack: 'mxu3' alone.
#define K1B_WALK_FORMS(X) X(0) X(1) X(2)

// lanes: the table re-laid for the walk (ops/dense_trace.py:lane_table),
// slices: the 32-row slice boxes (4 per chunk), stack_cap: the walk's
// stack entries, persist: resident blocks pulling rays from status[1].
// The widened forms read coef and scan every row.
extern "C" int lprt_dense_multi(const float* orig, const float* dir,
                                const int* skip, const float* mind,
                                const float* maxd, const float* coef,
                                const int* tri_id, const int* obj_id,
                                const float* boxes, const int* levels,
                                const float* lanes, const float* slices,
                                int n_levels, int R, int TI, int find_any,
                                int pack, int form, int stack_cap, int persist,
                                float k0, float k1, float k2,
                                float* t_out, float* u_out, float* v_out,
                                int* tri_out, int* obj_out, int* status,
                                void* stream) {
  if (LPRT_WIDENED(form))
    return lprt::launch_tree_trace<LPRT_CHUNK, true>(
        orig, dir, skip, mind, maxd, coef, tri_id, obj_id, boxes, levels,
        n_levels, R, TI, find_any, pack, form, k0, k1, k2, t_out, u_out, v_out,
        tri_out, obj_out, status, stream);
  if (n_levels < 1 || n_levels > LPRT_MAX_LEVELS || !lprt::valid_form(form) ||
      stack_cap < 1 || stack_cap > LPRT_MAX_STACK ||
      (long long)TI > ((long long)LPRT_CHUNK << LPRT_IDX_BITS) ||
      (pack && (find_any || form != 0)))
    return (int)cudaErrorInvalidValue;
  const Band band = {k0, k1, k2};
  const float4* l4 = reinterpret_cast<const float4*>(lanes);
  cudaStream_t s = (cudaStream_t)stream;
#define K1B_ARGS                                                                       \
  persist, orig, dir, skip, mind, maxd, l4, tri_id, obj_id, boxes, slices, levels,   \
      n_levels, R, TI, stack_cap, band, t_out, u_out, v_out, tri_out, obj_out, status, s
  if (pack) return launch_walk_p<0, true, false>(K1B_ARGS);
#define K1B_FORM(f)                                                 \
  if (form == (f))                                                  \
    return find_any ? launch_walk_p<(f), false, true>(K1B_ARGS)   \
                    : launch_walk_p<(f), false, false>(K1B_ARGS);
  K1B_WALK_FORMS(K1B_FORM)
#undef K1B_FORM
#undef K1B_ARGS
  return (int)cudaErrorInvalidValue;
}
