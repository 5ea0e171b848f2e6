// Per-ray wavefront for incoherent launches: the candidate schedule and the
// assigned-group lane test (K5).
//
// lprt_wavefront_assigned replaces the TPU kernel
// ops/wavefront.py:_assigned_kernel (:99, with the packed epilogue
// ops/dense_pallas.py:_finish_chunk_packed :130-180), reached through
// trace_rays_wavefront (:274) in its oneshot pair pass (pallas_call :557).
// lprt_wavefront_schedule replaces ops/wavefront.py:_schedule (:211), which
// is XLA code in the JAX package, not a Pallas kernel.  Plain versions:
// ops/wavefront.py:assigned_test_plain and schedule_plain.
//
// Schedule, per ray: the slab test (ops/dense_trace.py:ray_aabb_entry, 0.02
// of slop) against every group box gives a packed word
// (entry_bits & ~id_mask) | group id, or the sentinel where the segment
// [0, maxd) cannot enter the box, or where the word lies below the ray's
// cursor wmin.  A word at or above the sentinel (an entry >= 3e38) counts as
// the sentinel.  Out: the k least words ascending, then the (k+1)-th (tcut);
// sentinels fill.  Words are unique (the id is in the low bits), so this
// order is total.
// Design: a 4-ary tree of union boxes over the group boxes
// (ops/dense_trace.py:build_tree over the groups, one group a leaf, built
// once per frame table by ops/wavefront.py:setup), all of it in shared
// memory (<= 2,731 boxes for <= 2,048 groups, 66 KB); a persistent grid of
// resident blocks, one thread per ray; a dead ray (maxd <= 0) writes
// sentinels at once.  The words come LPRT_LIST at a time, kept sorted in
// registers by a branch-free insertion; each batch walks the tree nearest
// entry first (a stack in local memory) for the least words above the last
// one written.  The slab test is monotone under f32 rounding: (lo - o) inv
// is monotone in lo, min and max are exact, and an axis whose slab
// distances overflow for a group overflows for every box that contains it.
// So a node that contains a group's box is entered whenever the group's is,
// with an entry no later, and the walk culls a subtree exactly when its box
// is not entered (with some finite axis: a node with none is walked) or
// when (bits(entry) & ~id_mask) of its box is at or above the list's last
// word: no word below it is then skipped, and the list equals the flat
// scan's.  Bound: operations, 34 per slab test plus the insertion, per
// node tested (the COUNT form writes each ray's tests, for the bound).
//
// K5, per pair lane: the M-shift test (rows n[0..8] | e[0..2], as in K1b)
// of the lane's ray against the rows of each chunk of its q assigned
// groups (a group = s_group consecutive chunks).  A row is accepted when
// u > 0, v > 0, u + v < 1, mind < t < maxd, t > 0, tri != skip and t is
// finite.  Within a chunk the winner is the least key
// (t_bits & ~127) | local_row; across chunks the strictly smaller t wins.
// Out: the winner's exact t, its table row, and pk = (qu << 15) | qv with
// qu = int(clip((u + 0.5) * 16384, 0, 32767)); t = 1e5 and -1 ids where
// nothing is accepted.  An any-hit lane stops at its first accepted row (in
// row order), and its plain version does the same.  Group ids outside
// [0, NG) test nothing; the pair pass sends live pairs only, so in the
// oneshot route every lane has its group.
//
// The TPU kernel's tiling has no counterpart here: per-tile distinct-group
// lists in scalar prefetch, the list cap and its deferred lanes, fixed tile
// widths, and streaming the table from HBM.  Every lane is tested in its
// pass.  Bound: operations, 34 per slice box tested and ~40 per row tested.
// Design: one thread per lane; the lanes arrive sorted by group id, so the
// lanes of a warp nearly always share one chunk and each row load is a
// warp-uniform broadcast through the read-only cache (the table, 48 B a
// row, ~4 MB at 82,690 rows, stays in L2).  Built with --fmad=false so the
// test rounds like its plain version.  Each block first slab-tests its 256
// lanes' first chunks and regroups the lanes stably by the 4-bit mask of
// the slices they enter (a counting sort in shared memory:
// __match_any_sync ranks within a warp, one warp scans the bins), so a
// warp's lanes mostly test the same slices of one chunk; the masks and
// entry bounds go with the lanes into their loops.  A lane tests its rows
// LPRT_K5_ROWS at a time: their loads and tests are independent, and only
// the fold into the chunk's least key runs in row order (reading a row's
// triangle id only where all else accepts it), so a lane's chain of loads
// and divisions, what a launch of a few thousand lanes waits on, overlaps.
//
// Culling by 32-row slices.  Each chunk's four slices have boxes (the
// frame's packet-route leaf boxes, ops/dense_trace.py:slice_table,
// recentred like the lanes' rays).  A lane slab-tests them with
// trace_common.cuh:box_entry_exact0 on its own ray (o_q recentred, d_q
// quantised: the ray its rows are tested with) and tests rows only in the
// slices its segment enters, in row order.  Its rules, with e_i the entry
// bound of slice i, kmin the chunk's least key so far and bt the lane's best
// t before the chunk:
// (1) every accepted row lies in an entered slice, at t >= e_i.  The rows
//     are tested by the strict f32 test on the f32 table against the same
//     quantised ray the boxes are tested with, so box_entry_exact0's margin
//     derivation applies as it does to K6's f32 rays: the accepted point
//     lies on the ray (on a zero axis exactly at o_a), inside its triangle
//     up to ~gamma_8 S (1 + aspect), which the boxes' widening (1e-3 of
//     the extent + 1e-4) and m cover; box_entry's 0.02 of slop keeps e_i
//     at or below its t.  Checked on K5's own inputs: chip_smoke.py holds
//     this kernel bit for bit against the all-row plain version on every
//     lane of every pass it records, and tests/test_torch_k5_slices.py
//     checks that every accepted row's slice is entered.
// (2) closest hit, a whole chunk: skipped when every entered slice has
//     e_i >= bt.  Its rows then all have t >= bt, so its winner has too,
//     and across chunks only a strictly smaller t replaces bt.
// (3) closest hit, one slice: skipped when its least possible key
//     (bits(e_i) & ~127) | 32 i exceeds min(kmin, KB), KB = (bits(bt) &
//     ~127) | 127.  t >= e_i >= 0 orders like its bits, so each of its keys
//     is at least that.  A key above kmin cannot be the chunk's least.  A
//     key above KB has t > bt: if such a row were the chunk's winner, every
//     other row's key would be larger still, so the chunk without it gives
//     a winner with t > bt too (or none), and either way bt stays.  So the
//     chunk's fold is unchanged.  (A slice is not skipped for e_i >= bt
//     alone: a key there can beat a later slice's row of smaller t in the
//     same 128-ulp bucket, which would then win the chunk with t < bt.)
// (4) any hit: only unentered slices are skipped (they hold no accepted
//     row), so the first accepted row in row order is the plain version's.
// The last chunk's rows at or past TI are never tested, and a slice that
// starts past TI is not slab-tested.  COUNT (the counting form, for the
// bound and the divergence figures): per lane, the slices entered under
// box_entry_exact0 and under box_entry over all its chunks, the slice boxes
// it tested, the slices and rows it tested, and the slice bodies its warp
// ran where this lane led it (the lowest active lane).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "trace_common.cuh"

#define LPRT_CHUNK 128
#define LPRT_SLICE 32
#define LPRT_ASSIGNED_COUNTS 7  // the counting form's ints per lane
#define LPRT_ASSIGNED_BLOCK 256
#define LPRT_K5_ROWS 4  // K5: rows a lane tests at a time
#define LPRT_MASK_BINS 17  // the regrouping's keys: a 4-bit slice mask, or none
#define LPRT_MAX_GROUPS 2048
#define LPRT_LIST 17  // the schedule's register list: words per batch
#define LPRT_SCHED_BLOCK 256
#define LPRT_SCHED_LEVELS 8  // the group tree's levels at most (2,048 groups take 7)
#define LPRT_SCHED_STACK (3 * (LPRT_SCHED_LEVELS - 2) + 1)

namespace {

// Slab-entry bound of the ray against box b = [lo3 | hi3]; false when the
// ray's segment [0, maxd) cannot enter it (trace_common.cuh:box_entry);
// *fin: some axis had finite slab distances.
__device__ __forceinline__ bool box_entry(const float* b, float ox, float oy,
                                          float oz, float ix, float iy,
                                          float iz, float maxd, float* entry,
                                          bool* fin) {
  const float big = 3e38f, slop = 0.02f;
  float tmin = -big, tmax = big;
  bool any_fin = false;
  const float o[3] = {ox, oy, oz};
  const float inv[3] = {ix, iy, iz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float t1 = (b[a] - o[a]) * inv[a];
    float t2 = (b[3 + a] - o[a]) * inv[a];
    if (isfinite(t1) && isfinite(t2)) {
      tmin = fmaxf(tmin, fminf(t1, t2));
      tmax = fminf(tmax, fmaxf(t1, t2));
      any_fin = true;
    }
  }
  float e = fmaxf(tmin - slop, 0.f);
  *entry = e;
  *fin = any_fin;
  return any_fin && (tmin <= tmax + slop) && (tmax + slop >= 0.f) && (e < maxd);
}

// insert word w into the ascending list a, dropping its largest entry
__device__ __forceinline__ void insert_word(int (&a)[LPRT_LIST], int w) {
#pragma unroll
  for (int i = LPRT_LIST - 1; i > 0; --i) a[i] = a[i - 1] > w ? a[i - 1] : min(a[i], w);
  a[0] = min(a[0], w);
}

template <bool COUNT>
__global__ void __launch_bounds__(LPRT_SCHED_BLOCK)
schedule_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
                const float* __restrict__ maxd, const int* __restrict__ wmin,
                const float* __restrict__ boxes, const int* __restrict__ levels,
                int n_levels, int n_boxes, int R, int id_mask, int sent, int k,
                int* __restrict__ cand, int* __restrict__ tcut, int* __restrict__ tests) {
  extern __shared__ float s_box[];  // n_boxes x [lo3 | hi3], root level first
  __shared__ int s_off[LPRT_SCHED_LEVELS], s_n[LPRT_SCHED_LEVELS];
  if (threadIdx.x < n_levels) {
    s_off[threadIdx.x] = levels[threadIdx.x];
    s_n[threadIdx.x] = levels[n_levels + threadIdx.x];
  }
  for (int i = threadIdx.x; i < n_boxes * 6; i += blockDim.x) s_box[i] = boxes[i];
  __syncthreads();
  const int top = n_levels - 1;

  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < R; r += gridDim.x * blockDim.x) {
    const float ox = orig[3 * r], oy = orig[3 * r + 1], oz = orig[3 * r + 2];
    const float ix = 1.f / dir[3 * r], iy = 1.f / dir[3 * r + 1], iz = 1.f / dir[3 * r + 2];
    const float mx = maxd[r];
    const int wm = wmin[r];
    int* out = cand + (size_t)r * k;
    if (!(mx > 0.f)) {  // a dead ray (maxd <= 0) enters no box
      for (int i = 0; i < k; ++i) out[i] = sent;
      tcut[r] = sent;
      if (COUNT) tests[r] = 0;
      continue;
    }
    int n_tests = 0;
    const float* grp = s_box + 6 * s_off[0];
    // the ray's word for group g (the sentinel where it has none)
    auto word = [&](int g) -> int {
      float e;
      bool fin;
      if (COUNT) ++n_tests;
      if (!box_entry(grp + 6 * g, ox, oy, oz, ix, iy, iz, mx, &e, &fin)) return sent;
      int w = (__float_as_int(e) & ~id_mask) | g;
      return (w < sent && w >= wm) ? w : sent;
    };
    // node i of level l: false when no group below it can have a word;
    // *E: the least (entry bits & ~id_mask) a group below it can have
    auto node = [&](int l, int i, int* E) -> bool {
      float e;
      bool fin;
      if (COUNT) ++n_tests;
      const bool ok = box_entry(s_box + 6 * (s_off[l] + i), ox, oy, oz, ix, iy, iz, mx, &e, &fin);
      *E = __float_as_int(e) & ~id_mask;
      return ok || !fin;
    };

    // the k + 1 least words ascending (the list, then tcut), LPRT_LIST at a
    // time: each batch walks the tree for the least words above the last
    // one written, kept sorted in registers
    int last = -1;  // every word is >= 0 (entries are >= 0)
    for (int j0 = 0; j0 <= k; j0 += LPRT_LIST) {
      int a[LPRT_LIST];
#pragma unroll
      for (int i = 0; i < LPRT_LIST; ++i) a[i] = sent;
      if (last != sent) {
        int2 st[LPRT_SCHED_STACK];  // (level << 16 | index, least masked entry bits)
        int sp = 0;
        if (top == 0) {
          const int w = word(0);
          if (w > last) insert_word(a, w);
        } else {
          int E;
          if (node(top, 0, &E)) st[sp++] = make_int2(top << 16, E);
        }
        while (sp > 0) {
          const int2 en = st[--sp];
          if (en.y >= a[LPRT_LIST - 1]) continue;
          const int cl = (en.x >> 16) - 1;
          const int c0 = (en.x & 0xffff) * 4;
          const int c1 = min(c0 + 4, s_n[cl]);
          if (cl == 0) {  // the groups: their words into the list
            for (int g = c0; g < c1; ++g) {
              const int w = word(g);
              if (w <= last || w >= a[LPRT_LIST - 1]) continue;
              insert_word(a, w);
            }
            continue;
          }
          // internal children, pushed farthest entry first (the nearest on top)
          int ce[4], cn[4];
          int n = 0;
          for (int ch = c0; ch < c1; ++ch) {
            int E;
            if (!node(cl, ch, &E) || E >= a[LPRT_LIST - 1]) continue;
            int j = n++;
            while (j > 0 && ce[j - 1] < E) {
              ce[j] = ce[j - 1];
              cn[j] = cn[j - 1];
              --j;
            }
            ce[j] = E;
            cn[j] = ch;
          }
          for (int j = 0; j < n; ++j) st[sp++] = make_int2((cl << 16) | cn[j], ce[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < LPRT_LIST; ++i) {
        int j = j0 + i;
        if (j < k) out[j] = a[i];
        else if (j == k) tcut[r] = a[i];
      }
      last = a[LPRT_LIST - 1];
    }
    if (COUNT) tests[r] = n_tests;
  }
}

template <bool COUNT>
__global__ void __launch_bounds__(LPRT_ASSIGNED_BLOCK) assigned_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const int* __restrict__ skip, const float* __restrict__ mind,
    const float* __restrict__ maxd, const int* __restrict__ gid, int P, int q,
    const float4* __restrict__ coef, const int* __restrict__ tri_id,
    const float* __restrict__ slices, int TI, int NG, int s_group, int find_any,
    float* __restrict__ t_out, int* __restrict__ row_out, int* __restrict__ pk_out,
    int* __restrict__ counts) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  // the regrouping's slab tests of the lane's first chunk, kept for its
  // loop: the entered mask (-1: none kept) and the entry bounds
  int first = -1;
  float first_e[4] = {0.f, 0.f, 0.f, 0.f};
  __shared__ int s_first[LPRT_ASSIGNED_BLOCK];
  {
    // the block's lanes regrouped by the slices of their first chunk that
    // their rays enter (a 4-bit mask; 16: none), stably, so that a warp's
    // lanes mostly test the same slices of the same chunk; each lane's own
    // loop below is unchanged
    __shared__ int s_cnt[LPRT_ASSIGNED_BLOCK / 32][LPRT_MASK_BINS];
    __shared__ int s_base[LPRT_ASSIGNED_BLOCK / 32][LPRT_MASK_BINS];
    __shared__ int s_lane[LPRT_ASSIGNED_BLOCK];
    __shared__ float4 s_entry[LPRT_ASSIGNED_BLOCK];
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    int key = LPRT_MASK_BINS - 1;
    float e0[4] = {0.f, 0.f, 0.f, 0.f};
    if (p < P) {
      int g = -1;
      for (int j = 0; j < q && g < 0; ++j) {
        const int gj = gid[(size_t)p * q + j];
        if (gj >= 0 && gj < NG) g = gj;
      }
      if (g >= 0) {
        const float ox = orig[3 * p], oy = orig[3 * p + 1], oz = orig[3 * p + 2];
        const float ix = 1.f / dir[3 * p], iy = 1.f / dir[3 * p + 1], iz = 1.f / dir[3 * p + 2];
        const int c = g * s_group;
        key = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (c * LPRT_CHUNK + LPRT_SLICE * i < TI &&
              lprt::box_entry_exact0(slices + 6 * (4 * c + i), ox, oy, oz, ix, iy, iz, maxd[p],
                                     &e0[i]))
            key |= 1 << i;
        }
      }
    }
    if (l < LPRT_MASK_BINS) s_cnt[w][l] = 0;
    __syncwarp();
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int rank = __popc(peers & ((1u << l) - 1));
    if (rank == 0) s_cnt[w][key] = __popc(peers);
    __syncthreads();
    if (w == 0) {  // bases in (key, warp) order: an exclusive scan
      int pre[LPRT_ASSIGNED_BLOCK / 32], tot = 0;
#pragma unroll
      for (int v = 0; v < LPRT_ASSIGNED_BLOCK / 32; ++v) {
        pre[v] = tot;
        tot += l < LPRT_MASK_BINS ? s_cnt[v][l] : 0;
      }
      int inc = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, inc, o);
        if (l >= o) inc += n;
      }
      if (l < LPRT_MASK_BINS) {
#pragma unroll
        for (int v = 0; v < LPRT_ASSIGNED_BLOCK / 32; ++v) s_base[v][l] = inc - tot + pre[v];
      }
    }
    __syncthreads();
    const int slot = s_base[w][key] + rank;
    s_lane[slot] = p;
    s_entry[slot] = make_float4(e0[0], e0[1], e0[2], e0[3]);
    s_first[slot] = key;
    __syncthreads();
    p = s_lane[threadIdx.x];
    first = s_first[threadIdx.x];
    if (first == LPRT_MASK_BINS - 1) first = -1;  // no group: nothing kept
    const float4 fe = s_entry[threadIdx.x];
    first_e[0] = fe.x;
    first_e[1] = fe.y;
    first_e[2] = fe.z;
    first_e[3] = fe.w;
  }
  if (p >= P) return;
  const float ox = orig[3 * p], oy = orig[3 * p + 1], oz = orig[3 * p + 2];
  const float dx = dir[3 * p], dy = dir[3 * p + 1], dz = dir[3 * p + 2];
  const float ix = 1.f / dx, iy = 1.f / dy, iz = 1.f / dz;
  const float mn = mind[p], mx = maxd[p];
  const int sk = skip[p];
  int n_e0 = 0, n_be = 0, n_box = 0, n_sl = 0, n_rows = 0, n_warp = 0;

  float bt = 1e5f;
  int brow = -1, bpk = -1;
  bool done = false;  // an any-hit lane has its row (COUNT: still counts entries)
  for (int j = 0; j < q; ++j) {
    int g = gid[(size_t)p * q + j];
    if (g < 0 || g >= NG) continue;
    for (int s = 0; s < s_group; ++s) {
      const int c = g * s_group + s;
      const int k0 = c * LPRT_CHUNK;
      if (k0 >= TI) break;
      if (done && !COUNT) break;
      float e[4];
      unsigned ent = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        e[i] = 0.f;
        if (k0 + LPRT_SLICE * i >= TI) continue;
        const float* b = slices + 6 * (4 * c + i);
        if (first >= 0) {  // the lane's first chunk, tested by the regrouping
          e[i] = first_e[i];
          ent |= (first >> i & 1) << i;
        } else if (lprt::box_entry_exact0(b, ox, oy, oz, ix, iy, iz, mx, &e[i])) {
          ent |= 1u << i;
        }
        if (COUNT) {
          float eb;
          n_be += lprt::box_entry(b, ox, oy, oz, ix, iy, iz, mx, &eb);
          if (!done) ++n_box;
        }
      }
      first = -1;
      if (COUNT) n_e0 += __popc(ent);
      if (done || ent == 0) continue;
      if (!find_any) {  // rule (2): no entered slice reaches below bt
        float emin = 3e38f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (ent >> i & 1) emin = fminf(emin, e[i]);
        if (emin >= bt) continue;
      }
      const int kb = (__float_as_int(bt) & ~(LPRT_CHUNK - 1)) | (LPRT_CHUNK - 1);
      int kmin = INT_MAX;
      float wt = 0.f, wu = 0.f, wv = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!(ent >> i & 1)) continue;
        // rule (3): the slice's least key cannot change the chunk's fold
        if (!find_any && ((__float_as_int(e[i]) & ~(LPRT_CHUNK - 1)) | (LPRT_SLICE * i)) >
                             min(kmin, kb))
          continue;
        if (COUNT) {
          ++n_sl;
          if ((threadIdx.x & 31) == __ffs(__activemask()) - 1) ++n_warp;
        }
        const int r0 = k0 + LPRT_SLICE * i, r1 = min(TI, r0 + LPRT_SLICE);
        for (int k1 = r0; k1 < r1; k1 += LPRT_K5_ROWS) {
          float ts[LPRT_K5_ROWS], us[LPRT_K5_ROWS], vs[LPRT_K5_ROWS];
          bool accs[LPRT_K5_ROWS];
#pragma unroll
          for (int r = 0; r < LPRT_K5_ROWS; ++r) {
            const int kk = min(k1 + r, r1 - 1);  // a row past r1: the last again, not accepted
            float4 a = __ldg(coef + 3 * kk), b = __ldg(coef + 3 * kk + 1),
                   cc = __ldg(coef + 3 * kk + 2);
            // rows: a = n0 n1 n2 n3, b = n4 n5 n6 n7, cc = n8 e0 e1 e2
            float Oz = b.z * ox + b.w * oy + cc.x * oz + cc.w;
            float Dz = b.z * dx + b.w * dy + cc.x * dz;
            float Ox = a.x * ox + a.y * oy + a.z * oz + cc.y;
            float Oy = a.w * ox + b.x * oy + b.y * oz + cc.z;
            float Dx = a.x * dx + a.y * dy + a.z * dz;
            float Dy = a.w * dx + b.x * dy + b.y * dz;
            float t = -Oz / Dz;
            float u = Ox + t * Dx;
            float v = Oy + t * Dy;
            ts[r] = t;
            us[r] = u;
            vs[r] = v;
            // the row's own triangle id is read in the fold, for the rows
            // that pass all else (few)
            accs[r] = (k1 + r < r1) && (u > 0.f) && (v > 0.f) && (u + v < 1.f) && (t > mn) &&
                      (t < mx) && (t > 0.f) && isfinite(t);
          }
          int n_step = min(LPRT_K5_ROWS, r1 - k1);  // rows tested (COUNT)
#pragma unroll
          for (int r = 0; r < LPRT_K5_ROWS; ++r) {  // the fold, in row order
            if (!accs[r] || __ldg(tri_id + k1 + r) == sk) continue;
            int key = (__float_as_int(ts[r]) & ~(LPRT_CHUNK - 1)) | (k1 + r - k0);
            if (key < kmin) {
              kmin = key;
              wt = ts[r];
              wu = us[r];
              wv = vs[r];
            }
            if (find_any) {  // the first accepted row
              n_step = r + 1;
              break;
            }
          }
          if (COUNT) n_rows += n_step;
          if (find_any && kmin != INT_MAX) break;
        }
        if (find_any && kmin != INT_MAX) break;
      }
      if (kmin != INT_MAX && wt < bt) {
        bt = wt;
        brow = k0 + (kmin & (LPRT_CHUNK - 1));
        int qu = (int)fminf(fmaxf((wu + 0.5f) * 16384.f, 0.f), 32767.f);
        int qv = (int)fminf(fmaxf((wv + 0.5f) * 16384.f, 0.f), 32767.f);
        bpk = (qu << 15) | qv;
      }
      if (find_any && brow >= 0) done = true;
    }
    if (done && !COUNT) break;
  }
  t_out[p] = bt;
  row_out[p] = brow;
  pk_out[p] = bpk;
  if (COUNT) {
    int* o = counts + (size_t)LPRT_ASSIGNED_COUNTS * p;
    o[0] = n_e0;
    o[1] = n_be;
    o[2] = n_box;
    o[3] = n_sl;
    o[4] = n_rows;
    o[5] = n_warp;
    o[6] = blockIdx.x * blockDim.x + threadIdx.x;  // the lane's thread
  }
}

}  // namespace

// boxes / levels / n_levels: the tree over the NG group boxes (level 0, in
// group order); tests: per ray, the boxes its walk tested (null: not
// counted, the kernel without the counter).
extern "C" int lprt_wavefront_schedule(const float* orig, const float* dir,
                                       const float* maxd, const int* wmin,
                                       const float* boxes, const int* levels,
                                       int n_levels, int n_boxes, int R, int NG,
                                       int id_bits, int k, int* cand, int* tcut,
                                       int* tests, void* stream) {
  if (NG < 1 || NG > LPRT_MAX_GROUPS || k < 1 || id_bits < 2 || id_bits > 16 ||
      (1 << id_bits) <= NG || n_levels < 1 || n_levels > LPRT_SCHED_LEVELS || n_boxes < NG)
    return (int)cudaErrorInvalidValue;
  const int id_mask = (1 << id_bits) - 1;
  const int sent_bits = 0x7F61B1E6;  // the bits of (float)3e38
  const int sent = (sent_bits & ~id_mask) | id_mask;
  const size_t smem = (size_t)n_boxes * 6 * sizeof(float);
  auto kernel = tests ? schedule_kernel<true> : schedule_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, LPRT_SCHED_BLOCK,
                                                         smem)) != cudaSuccess)
    return (int)e;
  // resident blocks only: each stages the tree once and strides over the rays
  long long grid = ((long long)R + LPRT_SCHED_BLOCK - 1) / LPRT_SCHED_BLOCK;
  const long long resident = sms * per_sm > 0 ? (long long)sms * per_sm : 1;
  if (grid > resident) grid = resident;
  if (grid > 0) {
    kernel<<<(unsigned)grid, LPRT_SCHED_BLOCK, smem, (cudaStream_t)stream>>>(
        orig, dir, maxd, wmin, boxes, levels, n_levels, n_boxes, R, id_mask, sent, k, cand, tcut,
        tests);
  }
  return (int)cudaGetLastError();
}

// slices: (4 NC, 6) f32 [lo3 | hi3] the 32-row slice boxes, NC = ceil(TI /
// 128); counts: (P, LPRT_ASSIGNED_COUNTS) i32, the counting form (null: the
// kernel without the counters).
extern "C" int lprt_wavefront_assigned(const float* orig, const float* dir,
                                       const int* skip, const float* mind,
                                       const float* maxd, const int* gid, int P,
                                       int q, const float* coef, const int* tri_id,
                                       const float* slices, int TI, int NG, int s_group,
                                       int find_any, float* t_out, int* row_out,
                                       int* pk_out, int* counts,
                                       void* stream) {
  if (q < 1 || s_group < 1 || (long long)NG * s_group * LPRT_CHUNK < TI)
    return (int)cudaErrorInvalidValue;
  const int block = LPRT_ASSIGNED_BLOCK;
  const long long grid = ((long long)P + block - 1) / block;
  auto kernel = counts ? assigned_kernel<true> : assigned_kernel<false>;
  if (grid > 0) {
    kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
        orig, dir, skip, mind, maxd, gid, P, q, reinterpret_cast<const float4*>(coef),
        tri_id, slices, TI, NG, s_group, find_any, t_out, row_out, pk_out, counts);
  }
  return (int)cudaGetLastError();
}
