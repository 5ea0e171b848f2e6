// Dense trace over a multi-chunk table (K1b): closest hit or any hit.
//
// Replaces the TPU kernel ops/dense_pallas.py:_kernel in its multi-chunk
// mode (fallback='mxu3', the w_cond/w_body walk at :526-610 with the
// epilogues _finish_chunk :60-101 and _finish_chunk_any :104-127), reached
// through trace_rays_dense_pallas and trace_rays_dense_pallas_sorted.
// Plain version: ops/dense_trace.py:dense_trace_multi_plain.
//
// What it computes, per ray: the M-shift test against the instance
// triangles of the coefficient table (rows n[0..8] | e[0..2], as in K1a:
// Oz = n[6:9].o + e[2], Dz = n[6:9].d, Ox/Oy/Dx/Dy likewise, t = -Oz/Dz,
// strict u > 0, v > 0, u + v < 1), a hit also needing mind < t < maxd,
// tri != skip and a finite t.  Closest hit: the (t, tri, row)-lexicographic
// minimum, t = 1e5 / ids -1 on a miss.  Any hit: tri = 0 if some triangle
// accepts, else -1; t = 1e5, u = v = 0, obj = -1 either way.
//
// The rows come in chunks of 128, each with a world AABB (recentred like
// the rays).  A ray walks the chunks whose box its segment enters, nearest
// entry first (the slab test of ops/dense_trace.py:ray_aabb_entry, 0.02 of
// slop), and stops once the next entry lies beyond its best t (closest) or
// at its first accepted hit (any).  Because ties are broken by (t, tri,
// row) and the boxes are conservative, the result does not depend on the
// walk: it equals the plain version's global minimum bit for bit.
//
// The TPU kernel's tile schedule (screen blocks, per-tile chunk lists with
// packed entry words, t_cut and the overflow sweep, the scene-exit cap,
// HBM streaming) exists to feed 512-lane tiles from VMEM; a per-ray walk
// needs none of it.  The TPU computes u/v/t through a bf16x3 MXU product
// (~2^-16 relative); here they are plain f32, so the two agree to that
// accuracy, not bitwise (cross-chunk exact ties also go by walk order
// there).
//
// What bounds it on the H100: operations, by the data.  Per live ray it
// runs one slab test per chunk for each chunk it visits (plus one), and
// ~40 f32 operations per triangle of every visited chunk; the table
// (48 B/row, 255 KB for 5,314 rows) stays in L2 and is read through the
// read-only cache.  Design: one thread per ray; the chunk boxes in shared
// memory (<= 2048 chunks, 48 KB); the next chunk is found by rescanning the
// boxes for the least (entry, chunk) after the last one visited, so no
// per-ray list is stored; dead lanes (maxd <= mind) walk nothing.  Built
// with --fmad=false so the test rounds like its plain version.

#include <cuda_runtime.h>
#include <math.h>

#define LPRT_CHUNK 128
#define LPRT_MAX_CHUNKS 2048

namespace {

// Slab-entry bound of the ray against box b = [lo3 | hi3]; false when the
// ray's segment [0, maxd) cannot enter it.
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

__global__ void dense_multi_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const int* __restrict__ skip, const float* __restrict__ mind,
    const float* __restrict__ maxd, const float4* __restrict__ coef,
    const int* __restrict__ tri_id, const int* __restrict__ obj_id,
    const float* __restrict__ boxes, int R, int TI, int NC, int find_any,
    float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ tri_out,
    int* __restrict__ obj_out) {
  extern __shared__ float s_box[];  // NC x [lo3 | hi3]
  for (int i = threadIdx.x; i < NC * 6; i += blockDim.x) s_box[i] = boxes[i];
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
    float last_e = -1.f;
    int last_c = -1;
    while (true) {
      // the least (entry, chunk) after (last_e, last_c)
      float ne = 3.4e38f;
      int nc = -1;
      for (int c = 0; c < NC; ++c) {
        float e;
        if (!box_entry(s_box + 6 * c, ox, oy, oz, ix, iy, iz, mx, &e)) continue;
        bool after = e > last_e || (e == last_e && c > last_c);
        if (after && e < ne) {
          ne = e;
          nc = c;
        }
      }
      if (nc < 0 || (!find_any && ne > bt)) break;
      int k1 = min(TI, (nc + 1) * LPRT_CHUNK);
      bool blocked = false;
      for (int k = nc * LPRT_CHUNK; k < k1; ++k) {
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
      if (blocked) {
        btri = 0;
        break;
      }
      last_e = ne;
      last_c = nc;
    }
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

extern "C" int lprt_dense_trace_multi(const float* orig, const float* dir,
                                      const int* skip, const float* mind,
                                      const float* maxd, const float* coef,
                                      const int* tri_id, const int* obj_id,
                                      const float* boxes, int R, int TI, int NC,
                                      int find_any, float* t_out, float* u_out,
                                      float* v_out, int* tri_out, int* obj_out,
                                      void* stream) {
  if (NC > LPRT_MAX_CHUNKS || NC * LPRT_CHUNK < TI) return (int)cudaErrorInvalidValue;
  const int block = 128;
  const int grid = (R + block - 1) / block;
  if (grid > 0) {
    dense_multi_kernel<<<grid, block, NC * 6 * sizeof(float), (cudaStream_t)stream>>>(
        orig, dir, skip, mind, maxd, reinterpret_cast<const float4*>(coef),
        tri_id, obj_id, boxes, R, TI, NC, find_any, t_out, u_out, v_out,
        tri_out, obj_out);
  }
  return (int)cudaGetLastError();
}
