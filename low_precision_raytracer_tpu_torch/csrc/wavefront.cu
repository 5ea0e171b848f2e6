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
// of the lane's ray against the 128 rows of each chunk of its q assigned
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
// pass.  Bound: operations, ~40 f32 operations per triangle test.  Design:
// one thread per lane; the lanes arrive sorted by group id, so the lanes of
// a warp nearly always share one chunk and each row load is a warp-uniform
// broadcast through the read-only cache (the table, 48 B a row, ~4 MB at
// 82,690 rows, stays in L2).  Built with --fmad=false so the test rounds
// like its plain version.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#define LPRT_CHUNK 128
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

__global__ void assigned_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const int* __restrict__ skip, const float* __restrict__ mind,
    const float* __restrict__ maxd, const int* __restrict__ gid, int P, int q,
    const float4* __restrict__ coef, const int* __restrict__ tri_id, int TI,
    int NG, int s_group, int find_any, float* __restrict__ t_out,
    int* __restrict__ row_out, int* __restrict__ pk_out) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float ox = orig[3 * p], oy = orig[3 * p + 1], oz = orig[3 * p + 2];
  float dx = dir[3 * p], dy = dir[3 * p + 1], dz = dir[3 * p + 2];
  float mn = mind[p], mx = maxd[p];
  int sk = skip[p];

  float bt = 1e5f;
  int brow = -1, bpk = -1;
  for (int j = 0; j < q; ++j) {
    int g = gid[(size_t)p * q + j];
    if (g < 0 || g >= NG) continue;
    for (int s = 0; s < s_group; ++s) {
      int k0 = (g * s_group + s) * LPRT_CHUNK;
      if (k0 >= TI) break;
      int k1 = min(TI, k0 + LPRT_CHUNK);
      int kmin = INT_MAX;
      float wt = 0.f, wu = 0.f, wv = 0.f;
      for (int kk = k0; kk < k1; ++kk) {
        float4 a = __ldg(coef + 3 * kk), b = __ldg(coef + 3 * kk + 1),
               c = __ldg(coef + 3 * kk + 2);
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
        bool acc = (u > 0.f) && (v > 0.f) && (u + v < 1.f) && (t > mn) &&
                   (t < mx) && (t > 0.f) && (__ldg(tri_id + kk) != sk) && isfinite(t);
        if (!acc) continue;
        int key = (__float_as_int(t) & ~(LPRT_CHUNK - 1)) | (kk - k0);
        if (key < kmin) {
          kmin = key;
          wt = t;
          wu = u;
          wv = v;
        }
        if (find_any) break;  // the first accepted row
      }
      if (kmin != INT_MAX && wt < bt) {
        bt = wt;
        brow = k0 + (kmin & (LPRT_CHUNK - 1));
        int qu = (int)fminf(fmaxf((wu + 0.5f) * 16384.f, 0.f), 32767.f);
        int qv = (int)fminf(fmaxf((wv + 0.5f) * 16384.f, 0.f), 32767.f);
        bpk = (qu << 15) | qv;
      }
      if (find_any && brow >= 0) break;
    }
    if (find_any && brow >= 0) break;
  }
  t_out[p] = bt;
  row_out[p] = brow;
  pk_out[p] = bpk;
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

extern "C" int lprt_wavefront_assigned(const float* orig, const float* dir,
                                       const int* skip, const float* mind,
                                       const float* maxd, const int* gid, int P,
                                       int q, const float* coef, const int* tri_id,
                                       int TI, int NG, int s_group, int find_any,
                                       float* t_out, int* row_out, int* pk_out,
                                       void* stream) {
  if (q < 1 || s_group < 1 || (long long)NG * s_group * LPRT_CHUNK < TI)
    return (int)cudaErrorInvalidValue;
  const int block = 256;
  const long long grid = ((long long)P + block - 1) / block;
  if (grid > 0) {
    assigned_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
        orig, dir, skip, mind, maxd, gid, P, q, reinterpret_cast<const float4*>(coef),
        tri_id, TI, NG, s_group, find_any, t_out, row_out, pk_out);
  }
  return (int)cudaGetLastError();
}
