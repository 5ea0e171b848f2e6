// Device code shared by the trace kernels: K1a (dense_trace.cu), K1b
// (dense_multi.cu) and K6 (packet_trace.cu).
//
// - tri_test: the M-shift test of one ray against one coefficient row
//   (n[0..8] row-major | e[0..2]): Oz = n[6:9].o + e[2], Dz = n[6:9].d,
//   t = -Oz/Dz, then u = Ox + t Dx, v = Oy + t Dy, accepted by the band form
//   FORM (ops/dense_trace.py:Band; kind | flags):
//   - kind 0 ('mxu3'): strict u > 0, v > 0, u + v < 1 on the f32 rows;
//   - kinds 1 and 2: an error band, in the dense kernel's form
//     (dense_pallas.py:_kernel :369-421, the S rows scaled by sband as
//     _mxu_tables :888-910 builds them) or the packet kernel's
//     (traversal_pallas.py:_kernel :365-397).  Without an operand flag
//     (fp32) Ox/Oy/Dx/Dy and the S rows come from the f32 rows and ray;
//     with one (bf16, fp16) from the row's 16 band rows (values exact in
//     that type, ops/dense_trace.py:band_rows) against the ray rounded to
//     that type once per ray (make_operand), every product exact in f32.
//     'both': a lane inside the band takes the strict test, in the sub-f32
//     forms on the f32 rows (u32 = Ox32 + t Dx32, v32 likewise, which then
//     are its u and v); outside it the band-widened test.  'dtype'
//     (LPRT_FLAG_DTYPE): the band-widened test alone.
//   Plain version: ops/dense_trace.py:m_shift_test and band_accept.
//   plane_oz_dz and tri_test_oz are its two halves, for a caller that
//   culls on Oz and Dz before the rest (K1a).
// - box_entry: the conservative slab test of ops/dense_trace.py:
//   ray_aabb_entry (0.02 of slop, axes with non-finite slab distances
//   skipped); box_entry_exact0: the same, exact on a zero direction axis
//   (K6's walk).
// - scan_trace_kernel<FORM, PACK>: closest or any hit of every row under a
//   widened acceptance, one thread per ray: the card's reference for K1b's
//   and K6's walks under a band (chunk_walk.cuh, every form), reached by no
//   render path.
//
// Every expression keeps the plain versions' order of operations, and the
// sources build with --fmad=false, so a kernel rounds like its plain
// version and equals it bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#define LPRT_KIND_STRICT 0  // 'mxu3'
#define LPRT_KIND_DENSE 1   // K1's band: k = (sband, c1, c3)
#define LPRT_KIND_PACKET 2  // K6's band: k = (d12, d1, -)
#define LPRT_FLAG_DTYPE 4   // 'dtype': the band-widened test alone
#define LPRT_OPERAND_BF16 8
#define LPRT_OPERAND_FP16 16
#define LPRT_KIND(f) ((f) & 3)
#define LPRT_OPERAND(f) ((f) & (LPRT_OPERAND_BF16 | LPRT_OPERAND_FP16))
// a widened acceptance (sub-f32, or 'dtype') can accept points outside the
// triangle's box: K1b and K6 then walk boxes grown by its reach
// (ops/band_pad.py)
#define LPRT_WIDENED(f) (LPRT_OPERAND(f) || ((f) & LPRT_FLAG_DTYPE))
// floats per table row: 12 f32 columns, then 16 band rows in sub-f32 forms
#define LPRT_ROW(f) (LPRT_OPERAND(f) ? 28 : 12)

// Every form a kernel is built for: X(form) per form.
#define LPRT_FORMS(X)                                                        \
  X(0) X(1) X(2) X(5) X(6) X(9) X(10) X(13) X(14) X(18) X(22)

// The forms K1a and K1b are built for under the packed epilogue: 'mxu3'
// (bf16, fp16) and the dense band's sub-f32 forms; fp32 ignores 'pack'.
#define LPRT_PACK_FORMS(X) X(0) X(9) X(13)

#define LPRT_FAN 4
#define LPRT_MAX_LEVELS 16
#define LPRT_MAX_STACK (3 * (LPRT_MAX_LEVELS - 1) + 1)
#define LPRT_IDX_BITS 27

namespace lprt {

struct Band {
  float k0, k1, k2;
};

__host__ __device__ constexpr bool valid_form(int f) {
#define LPRT_IS_FORM(x) f == (x) ||
  return LPRT_FORMS(LPRT_IS_FORM) false;
#undef LPRT_IS_FORM
}

// The sub-f32 forms' ray operand: the ray's components rounded to the
// form's type, once per ray, q = [ox oy oz dx dy dz].
template <int FORM>
__device__ __forceinline__ float round_operand(float x) {
  if (LPRT_OPERAND(FORM) == LPRT_OPERAND_BF16)
    return __bfloat162float(__float2bfloat16_rn(x));
  return __half2float(__float2half_rn(x));
}

template <int FORM>
__device__ __forceinline__ void make_operand(float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float* q) {
  q[0] = round_operand<FORM>(ox);
  q[1] = round_operand<FORM>(oy);
  q[2] = round_operand<FORM>(oz);
  q[3] = round_operand<FORM>(dx);
  q[4] = round_operand<FORM>(dy);
  q[5] = round_operand<FORM>(dz);
}

// The plane rows of the test: Oz = n[6:9].o + e[2], Dz = n[6:9].d, from
// p = (n6, n7, n8, e2) (row c's columns 6, 7, 8, 11); t = -Oz / Dz.
__device__ __forceinline__ void plane_oz_dz(float4 p, float ox, float oy, float oz,
                                            float dx, float dy, float dz, float& Oz,
                                            float& Dz) {
  Oz = p.x * ox + p.y * oy + p.z * oz + p.w;
  Dz = p.x * dx + p.y * dy + p.z * dz;
}

// tri_test from its Oz and Dz (plane_oz_dz); the same arithmetic.
template <int FORM>
__device__ __forceinline__ bool tri_test_oz(const float* c, float ox, float oy,
                                            float oz, float dx, float dy,
                                            float dz, const float* q,
                                            const Band& b, float Oz, float Dz,
                                            float& t, float& u, float& v) {
  float Ox = c[0] * ox + c[1] * oy + c[2] * oz + c[9];
  float Oy = c[3] * ox + c[4] * oy + c[5] * oz + c[10];
  float Dx = c[0] * dx + c[1] * dy + c[2] * dz;
  float Dy = c[3] * dx + c[4] * dy + c[5] * dz;
  t = -Oz / Dz;
  if (LPRT_KIND(FORM) == LPRT_KIND_STRICT) {
    u = Ox + t * Dx;
    v = Oy + t * Dy;
    return (u > 0.f) && (v > 0.f) && (u + v < 1.f);
  }
  // a: the S rows' coefficients [|n0| |n1| |n2| |e0| | |n3| |n4| |n5| |e1|]
  float a[8];
  float u32 = 0.f, v32 = 0.f;
  // the operand the dtype rows and S rows read: the f32 ray, or q
  const float r[6] = {ox, oy, oz, dx, dy, dz};
  const float* p = LPRT_OPERAND(FORM) ? q : r;
  if (!LPRT_OPERAND(FORM)) {
    const int col[8] = {0, 1, 2, 9, 3, 4, 5, 10};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      a[i] = fabsf(c[col[i]]);
      if (LPRT_KIND(FORM) == LPRT_KIND_DENSE) a[i] = a[i] * b.k0;
    }
  } else {
    const float* br = c + 12;
    u32 = Ox + t * Dx;
    v32 = Oy + t * Dy;
    Ox = br[0] * p[0] + br[1] * p[1] + br[2] * p[2] + br[3];
    Oy = br[4] * p[0] + br[5] * p[1] + br[6] * p[2] + br[7];
    Dx = br[0] * p[3] + br[1] * p[4] + br[2] * p[5];
    Dy = br[4] * p[3] + br[5] * p[4] + br[6] * p[5];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = br[8 + i];
  }
  float aox = fabsf(p[0]), aoy = fabsf(p[1]), aoz = fabsf(p[2]);
  float adx = fabsf(p[3]), ady = fabsf(p[4]), adz = fabsf(p[5]);
  float s_ox = a[0] * aox + a[1] * aoy + a[2] * aoz + a[3];
  float s_oy = a[4] * aox + a[5] * aoy + a[6] * aoz + a[7];
  float s_dx = a[0] * adx + a[1] * ady + a[2] * adz;
  float s_dy = a[4] * adx + a[5] * ady + a[6] * adz;
  float t_dx = t * Dx, t_dy = t * Dy;
  u = Ox + t_dx;
  v = Oy + t_dy;
  float eu, ev;
  if (LPRT_KIND(FORM) == LPRT_KIND_DENSE) {
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
  if ((FORM & LPRT_FLAG_DTYPE) || !ambiguous) return dtype_accept;
  if (LPRT_OPERAND(FORM)) {  // the f32 re-test, and its u, v
    u = u32;
    v = v32;
  }
  return (u > 0.f) && (v > 0.f) && (u + v < 1.f);
}

// c: the row (LPRT_ROW(FORM) floats); q: the ray operand of a sub-f32 form
// (make_operand; not read otherwise).  -> the acceptance before the
// distance, skip and finiteness gates; t, u, v through the references.
template <int FORM>
__device__ __forceinline__ bool tri_test(const float* c, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, const float* q,
                                         const Band& b, float& t, float& u,
                                         float& v) {
  float Oz, Dz;
  plane_oz_dz(make_float4(c[6], c[7], c[8], c[11]), ox, oy, oz, dx, dy, dz, Oz, Dz);
  return tri_test_oz<FORM>(c, ox, oy, oz, dx, dy, dz, q, b, Oz, Dz, t, u, v);
}

__host__ __device__ constexpr bool valid_pack_form(int f) {
#define LPRT_IS_PACK_FORM(x) f == (x) ||
  return LPRT_PACK_FORMS(LPRT_IS_PACK_FORM) false;
#undef LPRT_IS_PACK_FORM
}

// The packed winner epilogue (dense_pallas.py:_finish_chunk_packed
// :130-180; plain version ops/dense_trace.py:_packed).  Per chunk, an
// accepted row with t > 0 gets the key (bits(t) & ~lmask) | local row
// (positive floats order like their bits, and the local row makes each
// key unique), and the least key wins the chunk with its exact t; across
// chunks the least (t, global row) wins, so the result does not depend on
// the order in which chunks are visited.  Out: t, the winner's row, and
// pk = (qu << 15) | qv, q = trunc(clip((x + 0.5) * 16384, 0, 32767)).
struct PackedBest {
  float t = 1e5f, u = 0.f, v = 0.f;
  int row = -1;
  // the current chunk
  int kmin = INT_MAX;
  float ct = 0.f, cu = 0.f, cv = 0.f;

  __device__ __forceinline__ void row_test(float t_, float u_, float v_,
                                           int local, int lmask) {
    int key = (__float_as_int(t_) & ~lmask) | local;
    if (key < kmin) {
      kmin = key;
      ct = t_;
      cu = u_;
      cv = v_;
    }
  }
  // fold the current chunk (rows from `first`) into the best
  __device__ __forceinline__ void end_chunk(int first, int lmask) {
    if (kmin == INT_MAX) return;
    int r = first + (kmin & lmask);
    if (ct < t || (ct == t && r < row)) {
      t = ct;
      u = cu;
      v = cv;
      row = r;
    }
    kmin = INT_MAX;
  }
  __device__ __forceinline__ int pk() const {
    if (row < 0) return -1;
    int qu = (int)fminf(fmaxf((u + 0.5f) * 16384.f, 0.f), 32767.f);
    int qv = (int)fminf(fmaxf((v + 0.5f) * 16384.f, 0.f), 32767.f);
    return (qu << 15) | qv;
  }
};

// Slab-entry bound of the ray against a box [lo3 | hi3] whose bound i is
// b(i); false when the ray's segment [0, maxd) cannot enter it.
template <class B>
__device__ __forceinline__ bool box_entry_at(B b, float ox, float oy, float oz, float ix,
                                             float iy, float iz, float maxd, float* entry) {
  const float big = 3e38f, slop = 0.02f;
  float tmin = -big, tmax = big;
  bool any_fin = false;
  const float o[3] = {ox, oy, oz};
  const float inv[3] = {ix, iy, iz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float t1 = (b(a) - o[a]) * inv[a];
    float t2 = (b(3 + a) - o[a]) * inv[a];
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

// box_entry_at on the box b = [lo3 | hi3] in global memory.
__device__ __forceinline__ bool box_entry(const float* __restrict__ b, float ox,
                                          float oy, float oz, float ix,
                                          float iy, float iz, float maxd,
                                          float* entry) {
  return box_entry_at([&](int i) { return __ldg(b + i); }, ox, oy, oz, ix, iy, iz, maxd,
                      entry);
}

// box_entry made exact on a zero direction axis (K6's walk only; the
// schedule's words and K1b's walk keep box_entry).  box_entry skips an axis
// whose slab distances are not finite, so a ray with d_a = 0 enters every box
// whose other slabs it crosses, whatever the box's extent on a: the sun of
// sponza_like_scene (a rotation about x) sends every shadow ray along such a
// band.  Here an axis whose 1/d is infinite (d_a = +-0, or |d_a| < 2^-128,
// which moves the ray less than 1e-33 over any segment) also needs the origin
// inside the box on that axis, by the margin
//   m = LPRT_ZERO_AXIS_MARGIN (1 + |o_x| + |o_y| + |o_z|),
// then box_entry decides as before: a subset of box_entry's boxes.
// Why it keeps every accepted row: on such an axis every point of the
// segment has coordinate o_a, so an accepted point lies at o_a.  A leaf box
// is its rows' f32 vertex bounds widened by 1e-3 of its extent + 1e-4
// (models/scene.py:_group_aabbs), recentred like the rays (one rounding,
// ops/trace.py:_box_tables); the strict f32 test (and the f32 'both' band,
// strict up to ~2^-20) accepts a point at most ~gamma_8 S (1 + aspect)
// outside its triangle, gamma_8 ~ 4.8e-7, S the magnitude of the recentred
// coordinates it combines, aspect the triangle's edge over its height.  m
// and the widening cover that for S up to 1 + |o|_1 and an aspect up to
// ~200; past that, the widening alone covers it, as it does for box_entry
// on any axis with d_a != 0 (there the 0.02 slop in t is 0.02 |d_a| in
// space, which vanishes as d_a -> 0).  The comparison needs no product, so
// o_a == lo_a is exact (box_entry's (lo_a - o_a) * inf is NaN there).  An
// internal node is a union of its leaves, so it passes whenever a leaf
// below it does.  Plain version: ops/packet_trace.py:zero_axis_inside.
#define LPRT_ZERO_AXIS_MARGIN 1e-4f

template <class B>
__device__ __forceinline__ bool box_entry_exact0_at(B b, float ox, float oy, float oz,
                                                    float ix, float iy, float iz, float maxd,
                                                    float* entry) {
  const float o[3] = {ox, oy, oz};
  const float inv[3] = {ix, iy, iz};
  const float m = LPRT_ZERO_AXIS_MARGIN * (1.f + fabsf(ox) + fabsf(oy) + fabsf(oz));
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (isinf(inv[a])) {
      if (!(b(a) - m <= o[a] && o[a] <= b(3 + a) + m)) {
        *entry = 0.f;
        return false;
      }
    }
  }
  return box_entry_at(b, ox, oy, oz, ix, iy, iz, maxd, entry);
}

__device__ __forceinline__ bool box_entry_exact0(const float* __restrict__ b, float ox,
                                                 float oy, float oz, float ix, float iy,
                                                 float iz, float maxd, float* entry) {
  return box_entry_exact0_at([&](int i) { return __ldg(b + i); }, ox, oy, oz, ix, iy, iz,
                             maxd, entry);
}

// The all-row scan of the widened acceptances (LPRT_WIDENED: the sub-f32
// forms and 'dtype'), the reference K1b's and K6's walks are held to on the
// card (dense_multi.cu:lprt_band_scan).  What it computes, per ray: the
// tri_test<FORM> of every row, a hit also needing mind < t < maxd,
// tri != skip and a finite t.  Closest hit: the (t, tri, row)-lexicographic
// minimum, t = 1e5 / ids -1 on a miss.  Any hit: tri = 0 if some row
// accepts, else -1; t = 1e5, u = v = 0, obj = -1 either way.
//
// A widened test can accept a point well outside its triangle (a bf16
// 'dtype' band reaches tens of percent of the barycentric range on distant
// hits), so outside every unpadded box of a tree: one thread per ray tests
// every row in order, and the result is the plain version's global minimum.
// (The TPU kernels cull such hits by their tiles' boxes, which bound no
// single ray; the JAX package's all-pairs XLA route, ops/dense.py, keeps
// them, as this does and as the walks over grown boxes do.)  Under PACK
// (K1b's packed epilogue) every LPRT_SCAN_CHUNK rows are a chunk of
// PackedBest.  Dead lanes (maxd <= mind) test nothing.
#define LPRT_SCAN_CHUNK 128
#define LPRT_SCAN_FORMS(X) X(5) X(6) X(9) X(10) X(13) X(14) X(18) X(22)
#define LPRT_SCAN_PACK_FORMS(X) X(9) X(13)

template <int FORM, bool PACK>
__global__ void scan_trace_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const int* __restrict__ skip, const float* __restrict__ mind,
    const float* __restrict__ maxd, const float4* __restrict__ coef,
    const int* __restrict__ tri_id, const int* __restrict__ obj_id, int R, int TI,
    int find_any, Band band, float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ tri_out, int* __restrict__ obj_out) {
  constexpr int ROW = LPRT_ROW(FORM);
  constexpr int LMASK = LPRT_SCAN_CHUNK - 1;  // the packed key's local-row bits
  static_assert(LPRT_WIDENED(FORM), "the scan is the reference of the widened forms");
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float ox = orig[3 * r], oy = orig[3 * r + 1], oz = orig[3 * r + 2];
  float dx = dir[3 * r], dy = dir[3 * r + 1], dz = dir[3 * r + 2];
  float mn = mind[r], mx = maxd[r];
  int sk = skip[r];

  float bt = 1e5f, bu = 0.f, bv = 0.f;
  int btri = -1, brow = -1;
  PackedBest pb;
  if (mx > mn) {
    float q[6];
    if (LPRT_OPERAND(FORM)) make_operand<FORM>(ox, oy, oz, dx, dy, dz, q);
    bool done = false;
    for (int k0 = 0; k0 < TI && !done; k0 += LPRT_SCAN_CHUNK) {
      const int k1 = min(TI, k0 + LPRT_SCAN_CHUNK);
      for (int k = k0; k < k1; ++k) {
        float c[ROW];
#pragma unroll
        for (int j = 0; j < ROW / 4; ++j) {
          float4 w = __ldg(coef + (ROW / 4) * k + j);
          c[4 * j] = w.x;
          c[4 * j + 1] = w.y;
          c[4 * j + 2] = w.z;
          c[4 * j + 3] = w.w;
        }
        float t, u, v;
        bool geom = tri_test<FORM>(c, ox, oy, oz, dx, dy, dz, q, band, t, u, v);
        int tri = __ldg(tri_id + k);
        bool acc = geom && (t > mn) && (t < mx) && (tri != sk) && isfinite(t);
        if (!acc) continue;
        if (PACK) {
          if (t > 0.f) pb.row_test(t, u, v, k - k0, LMASK);
          continue;
        }
        if (find_any) {
          btri = 0;
          done = true;
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
      if (PACK) pb.end_chunk(k0, LMASK);
    }
  }
  if (PACK) {  // (t, row, pk) into (t_out, tri_out, obj_out)
    t_out[r] = pb.t;
    tri_out[r] = pb.row;
    obj_out[r] = pb.pk();
    return;
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

// Launch scan_trace_kernel<form, pack> on `stream`; -> cudaError_t.
// PACKABLE: the packed forms are built (K1b); elsewhere pack is refused.
template <bool PACKABLE>
int launch_scan_trace(const float* orig, const float* dir, const int* skip,
                      const float* mind, const float* maxd, const float* coef,
                      const int* tri_id, const int* obj_id, int R, int TI, int find_any,
                      int pack, int form, float k0, float k1, float k2, float* t_out,
                      float* u_out, float* v_out, int* tri_out, int* obj_out,
                      void* stream) {
  if (!valid_form(form) || !LPRT_WIDENED(form) ||
      (pack && (!PACKABLE || find_any || !valid_pack_form(form))))
    return (int)cudaErrorInvalidValue;
  const int block = 128;
  const int grid = (R + block - 1) / block;
  if (grid == 0) return (int)cudaGetLastError();
  const Band band = {k0, k1, k2};
  const float4* c4 = reinterpret_cast<const float4*>(coef);
  cudaStream_t s = (cudaStream_t)stream;
#define LPRT_SCAN_ARGS                                                                 \
  orig, dir, skip, mind, maxd, c4, tri_id, obj_id, R, TI, find_any, band, t_out, u_out, \
      v_out, tri_out, obj_out
#define LPRT_SCAN_FORM(f) \
  if (!pack && form == (f)) scan_trace_kernel<(f), false><<<grid, block, 0, s>>>(LPRT_SCAN_ARGS);
  LPRT_SCAN_FORMS(LPRT_SCAN_FORM)
#undef LPRT_SCAN_FORM
  if constexpr (PACKABLE) {
#define LPRT_SCAN_PACK_FORM(f) \
  if (pack && form == (f)) scan_trace_kernel<(f), true><<<grid, block, 0, s>>>(LPRT_SCAN_ARGS);
    LPRT_SCAN_PACK_FORMS(LPRT_SCAN_PACK_FORM)
#undef LPRT_SCAN_PACK_FORM
  }
#undef LPRT_SCAN_ARGS
  return (int)cudaGetLastError();
}

}  // namespace lprt
