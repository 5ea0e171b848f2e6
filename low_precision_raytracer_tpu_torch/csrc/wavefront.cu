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
// order is total.  Design: one thread per ray, the boxes in shared memory
// (<= 2048 groups, 48 KB); a dead ray (maxd <= 0) writes sentinels at
// once.  The words come 17 at a time, kept sorted in registers by a
// branch-free insertion: k <= 16 (the first pass) takes one scan of the
// boxes; a deeper list (the tail passes of a few rays) rescans them once
// per batch of 17 for the least words above the last one written, as K1b's
// walk rescans for its next chunk.  Bound: operations (34 per slab test,
// plus the insertion), NG tests per ray and batch.
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

namespace {

// Slab-entry bound of the ray against box b = [lo3 | hi3]; false when the
// ray's segment [0, maxd) cannot enter it (as dense_multi.cu).
__device__ __forceinline__ bool box_entry(const float* b, float ox, float oy,
                                          float oz, float ix, float iy,
                                          float iz, float maxd, float* entry) {
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
  return any_fin && (tmin <= tmax + slop) && (tmax + slop >= 0.f) && (e < maxd);
}

__global__ void schedule_kernel(const float* __restrict__ orig,
                                const float* __restrict__ dir,
                                const float* __restrict__ maxd,
                                const int* __restrict__ wmin,
                                const float* __restrict__ boxes, int R, int NG,
                                int id_mask, int sent, int k,
                                int* __restrict__ cand, int* __restrict__ tcut) {
  extern __shared__ float s_box[];  // NG x [lo3 | hi3]
  for (int i = threadIdx.x; i < NG * 6; i += blockDim.x) s_box[i] = boxes[i];
  __syncthreads();

  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float ox = orig[3 * r], oy = orig[3 * r + 1], oz = orig[3 * r + 2];
  float ix = 1.f / dir[3 * r], iy = 1.f / dir[3 * r + 1], iz = 1.f / dir[3 * r + 2];
  float mx = maxd[r];
  int wm = wmin[r];
  int* out = cand + (size_t)r * k;
  if (!(mx > 0.f)) {  // a dead ray (maxd <= 0) enters no box
    for (int i = 0; i < k; ++i) out[i] = sent;
    tcut[r] = sent;
    return;
  }

  // the ray's word for group g (the sentinel where it has none)
  auto word = [&](int g) -> int {
    float e;
    if (!box_entry(s_box + 6 * g, ox, oy, oz, ix, iy, iz, mx, &e)) return sent;
    int w = (__float_as_int(e) & ~id_mask) | g;
    return (w < sent && w >= wm) ? w : sent;
  };

  // the k + 1 least words ascending (the list, then tcut), LPRT_LIST at a
  // time: each batch rescans the boxes once for the least words above the
  // last one written, kept sorted in registers
  int last = -1;  // every word is >= 0 (entries are >= 0)
  for (int j0 = 0; j0 <= k; j0 += LPRT_LIST) {
    int a[LPRT_LIST];
#pragma unroll
    for (int i = 0; i < LPRT_LIST; ++i) a[i] = sent;
    if (last != sent) {
      for (int g = 0; g < NG; ++g) {
        int w = word(g);
        if (w <= last || w >= a[LPRT_LIST - 1]) continue;
        // insert w into the ascending list, dropping its largest entry
#pragma unroll
        for (int i = LPRT_LIST - 1; i > 0; --i) a[i] = a[i - 1] > w ? a[i - 1] : min(a[i], w);
        a[0] = min(a[0], w);
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

extern "C" int lprt_wavefront_schedule(const float* orig, const float* dir,
                                       const float* maxd, const int* wmin,
                                       const float* boxes, int R, int NG,
                                       int id_bits, int k, int* cand, int* tcut,
                                       void* stream) {
  if (NG < 1 || NG > LPRT_MAX_GROUPS || k < 1 || id_bits < 2 || id_bits > 16 ||
      (1 << id_bits) <= NG)
    return (int)cudaErrorInvalidValue;
  const int id_mask = (1 << id_bits) - 1;
  const int sent_bits = 0x7F61B1E6;  // the bits of (float)3e38
  const int sent = (sent_bits & ~id_mask) | id_mask;
  const int block = 128;
  const int grid = (R + block - 1) / block;
  if (grid > 0) {
    schedule_kernel<<<grid, block, NG * 6 * sizeof(float), (cudaStream_t)stream>>>(
        orig, dir, maxd, wmin, boxes, R, NG, id_mask, sent, k, cand, tcut);
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
