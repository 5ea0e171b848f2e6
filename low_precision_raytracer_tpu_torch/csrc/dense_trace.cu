// Dense closest-hit trace with the fused shadow (DI) phase, one chunk.
//
// Replaces the TPU kernel ops/dense_pallas.py:_kernel in its single-chunk
// mode (single=True, di_lights=L; every fallback: 'mxu3', and 'both' /
// 'dtype' with the dense error band in fp32, bf16 and fp16, chunk_quants
// :369-421, its DI phase :445-503 re-running the same test on shadow rays
// whose operand it rounds from their f32 components, :483-491), reached
// through trace_rays_dense_pallas.
// Plain version: ops/dense_trace.py:dense_trace_plain.
//
// What it computes, per ray: the closest hit among the TI <= 128 instance
// triangles of the one chunk, from the world-space coefficient rows
// (Oz = n[6:9].o + e[2], Dz = n[6:9].d, Ox/Oy/Dx/Dy likewise), t = -Oz/Dz,
// accepted by the band (trace_common.cuh:tri_test: strict u > 0, v > 0,
// u + v < 1 under 'mxu3', else the dense error band), gated by
// mind < t < maxd, tri != skip and finite t; ties in t go to the smallest
// tri id; a miss keeps t = 1e5, u = v = 0, ids -1.  Then, from the winner's
// point o + t d, one shadow ray per light (point: toward the recentred
// position, range = distance; directional: along -normalize(dir), range
// 1000), any-hit against the same triangles with the same acceptance,
// t > d_mov and the winner's tri skipped; bit l of vis is set where the
// light is unoccluded and a winner exists.
//
// Under pack (dense_epilogue='pack', _finish_chunk_packed :130-180; no
// shadow phase, as in the reference; built for 'mxu3' and the sub-f32
// dense bands, LPRT_PACK_FORMS) the table is one chunk: an accepted row
// with t > 0 gets the key (bits(t) & ~(2^lb - 1)) | row, lb the wrapper's
// ceil(log2 of the table rounded up to 16 rows), and the least key wins
// with its exact t; out t, the winner's row and its 15-bit u/v
// (trace_common.cuh:PackedBest) in t_out, tri_out, obj_out.
//
// Under 'mxu3' the TPU computes u/v through a manual bf16x3 MXU product
// (~2^-16 relative), in fp32 through an f32 dot that sums in another
// order, and its sub-f32 band rows through a bf16 dot whose f32 sums may
// also run in another order; here t and the f32 rows are plain f32 from
// the f32 coefficient table, so the two agree to that accuracy, not
// bitwise.
//
// What bounds it on the H100: instructions.  Per ray it reads 36 bytes and
// writes 24 (~125 MB at 2.07M rays, ~40 us at 3.35 TB/s); the test of one
// (ray, triangle) is ~81 SASS instructions in the strict form (--fmad=false
// forbids contraction, and t = -Oz/Dz is an IEEE division sequence), more
// in a band, for each of the 34 triangles of the flagship and again in the
// shadow phase.  The
// triangle table and the light rows live in shared memory (one copy per
// block, read as broadcasts), one thread per ray, no atomics on outputs.
// Lanes with maxd <= mind keep the miss values without testing (the TPU's
// dead-tile guard, per lane).
//
// Design: exact culls before the expensive part of the test (`cull`, the
// proofs there), so that a rejected triangle costs its plane rows (Oz, Dz:
// 11 instructions from one float4) and a few more instead of the whole
// test: a sign cull (an accepted t must be > 0) and a range cull against
// the lane's bound (the least of maxd and the best t, the light's range),
// with an exact margin.  A warp runs the full test of a row when one of
// its lanes survives, so the lanes of a block are regrouped by the octant
// of their direction first (a counting sort in shared memory): a bounce
// launch's neighbouring pixels send rays every way, and rays of one octant
// cull the same walls.  The culls only drop (ray, row) pairs that the full
// test would reject or that could not change the result, and the rows run
// in table order, each surviving one through the same arithmetic
// (tri_test_oz), the sub-f32 forms on the same rounded operand: every
// result is bit for bit the plain version's.  (Closest hit, the packed key
// and any hit do not depend on the order of the rows either: ties go by
// triangle id, the packed form keeps the least key, one blocker suffices.)
// Each shared row holds its coefficients, plane rows and ids together, so
// a step of the loops moves one pointer.
// Plain emulation of the culled loops: ops/dense_trace.py:dense_trace_cull_plain.

#include "trace_common.cuh"

#define LPRT_MAX_TRIS 128
#define LPRT_MAX_LIGHTS 32
#define LPRT_K1A_BLOCK 256
#define LPRT_OCTANT_BINS 9  // 8 octants, then dead lanes and lanes past R

namespace {

// The next float above a bound x (x not NaN: maxd, a t, a light's range):
// the bits stepped away from zero above 0, toward it below; +-0 gives the
// least subnormal; +Inf gives a NaN, which turns the range cull off, as a
// bound of +Inf should.
__device__ __forceinline__ float next_up(float x) {
  const int i = __float_as_int(x);
  return x == 0.f ? __int_as_float(1) : __int_as_float(i + (i < 0 ? -1 : 1));
}

// The culls: true when a row with plane rows Oz, Dz cannot give an accepted
// t that beats the bound, so the rest of the test may be skipped.
// `up` = next_up(U): U the largest t that can still change the result (the
// least of maxd and the best t so far; under the packed epilogue the top of
// the best key's bucket; the light's range in the shadow phase).
// `need_pos`: an accepted t must be > 0 (the lane's mind >= 0, the packed
// epilogue's t > 0, the shadow phase's d_mov >= 0).  w = -Oz sign(Dz)
// (Dz's sign bit, one LOP3), so for finite Dz != 0 the exact quotient
// q = -Oz/Dz is w / |Dz|; P = __fmul_ru(up, |Dz|) >= up |Dz| exactly
// (rounded toward +Inf: +Inf on overflow; NaN, which fails the compare,
// for a NaN bound or 0 x Inf).
// - Range cull, w > P.  For finite Dz != 0: w > up |Dz|, so q > up; up is
//   a float and rounding is monotone, so t = rn(q) >= up > U: t fails
//   t < maxd, or loses to the best t (a tie t == best is never culled:
//   t >= next_up(best) > best), or its key lies above the best key's
//   bucket.  For Dz = +-0, w > P = 0 means Oz != 0, so t = +-Inf, never
//   accepted.  For Dz = +-Inf, P = -Inf needs up < 0 (U < 0), and
//   t = +-0 > U or NaN.
// - Sign cull, need_pos and not w > 0.  An accepted t is finite and > 0.
//   w <= 0 gives q <= 0, so t <= 0 (rounding is monotone); NaN gives NaN;
//   Dz = +-0 gives t = +-Inf or NaN, Dz = +-Inf t = +-0 or NaN.
// No case culls a row the full test would accept, so every result is the
// plain version's.  The margin is exact (one ulp of U and the product
// rounded up): no delta depends on the rounding of Oz or Dz, since the
// cull reads the same Oz and Dz the test divides.
__device__ __forceinline__ bool cull(float Oz, float Dz, float up, bool need_pos) {
  const float w = __int_as_float((__float_as_int(Oz) ^ (__float_as_int(Dz) & 0x80000000)) ^
                                 0x80000000);
  return (w > __fmul_ru(up, fabsf(Dz))) || (need_pos && !(w > 0.f));
}

template <int FORM, bool PACK>
__global__ void __launch_bounds__(LPRT_K1A_BLOCK) dense_trace_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const int* __restrict__ skip, const float* __restrict__ mind,
    const float* __restrict__ maxd, const float* __restrict__ coef,
    const int* __restrict__ tri_id, const int* __restrict__ obj_id,
    const float* __restrict__ lights, int R, int TI, int L, float d_mov,
    lprt::Band band, int lmask, float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ tri_out,
    int* __restrict__ obj_out, int* __restrict__ vis_out) {
  constexpr int ROW = LPRT_ROW(FORM);
  // one shared row per table row, so that a step of the loops moves one
  // pointer: [coef (ROW) | n6 n7 n8 e2 | tri | obj | 2 unused], 16-byte
  // aligned
  constexpr int RS = ROW + 8;
  constexpr int PL = ROW, TRI = ROW + 4, OBJ = ROW + 5;
  __shared__ __align__(16) float s_rows[LPRT_MAX_TRIS * RS];
  __shared__ float s_light[LPRT_MAX_LIGHTS * 4];
  for (int i = threadIdx.x; i < TI * ROW; i += blockDim.x)
    s_rows[(i / ROW) * RS + i % ROW] = coef[i];
  for (int i = threadIdx.x; i < TI; i += blockDim.x) {
    float* row = s_rows + RS * i;
    row[PL] = coef[ROW * i + 6];
    row[PL + 1] = coef[ROW * i + 7];
    row[PL + 2] = coef[ROW * i + 8];
    row[PL + 3] = coef[ROW * i + 11];
    row[TRI] = __int_as_float(tri_id[i]);
    row[OBJ] = __int_as_float(obj_id[i]);
  }
  for (int i = threadIdx.x; i < L * 4; i += blockDim.x) s_light[i] = lights[i];
  // The block's lanes regrouped by their direction's octant (a counting
  // sort in shared memory, dead lanes and lanes past R last), so that a warp
  // holds rays whose sign culls agree: a bounce launch's rays leave each
  // pixel in any direction.  Each lane then takes the ray of its slot and
  // writes that ray's results.
  __shared__ int s_bin[LPRT_OCTANT_BINS];
  __shared__ int s_perm[LPRT_K1A_BLOCK];
  if (threadIdx.x < LPRT_OCTANT_BINS) s_bin[threadIdx.x] = 0;
  __syncthreads();
  int key = LPRT_OCTANT_BINS - 1;
  {
    const int r0 = blockIdx.x * blockDim.x + threadIdx.x;
    if (r0 < R && maxd[r0] > mind[r0])
      key = ((__float_as_uint(dir[3 * r0]) >> 31) << 2) |
            ((__float_as_uint(dir[3 * r0 + 1]) >> 31) << 1) |
            (__float_as_uint(dir[3 * r0 + 2]) >> 31);
    const int slot = atomicAdd(&s_bin[key], 1);
    __syncthreads();
    if (threadIdx.x == 0) {
      int sum = 0;
      for (int b = 0; b < LPRT_OCTANT_BINS; ++b) {
        const int n = s_bin[b];
        s_bin[b] = sum;
        sum += n;
      }
    }
    __syncthreads();
    s_perm[s_bin[key] + slot] = r0;
    __syncthreads();
  }
  int r = s_perm[threadIdx.x];
  if (r >= R) return;
  float ox = orig[3 * r], oy = orig[3 * r + 1], oz = orig[3 * r + 2];
  float dx = dir[3 * r], dy = dir[3 * r + 1], dz = dir[3 * r + 2];
  float mn = mind[r], mx = maxd[r];
  int sk = skip[r];

  float bt = 1e5f, bu = 0.f, bv = 0.f;
  int btri = -1, bobj = -1;
  lprt::PackedBest pb;
  if (mx > mn) {
    float q[6];
    if (LPRT_OPERAND(FORM)) lprt::make_operand<FORM>(ox, oy, oz, dx, dy, dz, q);
    const bool need_pos = PACK || mn >= 0.f;
    float up = next_up(PACK ? mx : fminf(mx, bt));
    for (int k = 0; k < TI; ++k) {
      const float* row = s_rows + RS * k;
      float Oz, Dz;
      lprt::plane_oz_dz(*reinterpret_cast<const float4*>(row + PL), ox, oy, oz, dx, dy, dz,
                        Oz, Dz);
      if (cull(Oz, Dz, up, need_pos)) continue;
      float t, u, v;
      bool geom = lprt::tri_test_oz<FORM>(row, ox, oy, oz, dx, dy, dz, q, band, Oz, Dz, t,
                                          u, v);
      int tri = __float_as_int(row[TRI]);
      bool acc = geom && (t > mn) && (t < mx) && (tri != sk) && isfinite(t);
      if (PACK) {
        if (acc && t > 0.f) {
          pb.row_test(t, u, v, k, lmask);
          // every key above the least key's bucket loses to it
          up = next_up(fminf(mx, __int_as_float(pb.kmin | lmask)));
        }
      } else if (acc && (t < bt || (t == bt && tri < btri))) {
        bt = t;
        bu = u;
        bv = v;
        btri = tri;
        bobj = __float_as_int(row[OBJ]);
        up = next_up(fminf(mx, bt));
      }
    }
  }
  if (PACK) {  // (t, row, pk) into (t_out, tri_out, obj_out)
    pb.end_chunk(0, lmask);
    t_out[r] = pb.t;
    tri_out[r] = pb.row;
    obj_out[r] = pb.pk();
    return;
  }
  t_out[r] = bt;
  u_out[r] = bu;
  v_out[r] = bv;
  tri_out[r] = btri;
  obj_out[r] = bobj;
  if (vis_out == nullptr) return;

  int vis = 0;
  if (btri >= 0) {
    float px = ox + bt * dx, py = oy + bt * dy, pz = oz + bt * dz;
    const bool need_pos = d_mov >= 0.f;
    for (int l = 0; l < L; ++l) {
      const float* a = s_light + 4 * l;
      bool isdir = a[0] > 0.f;
      float lx = a[1] - px, ly = a[2] - py, lz = a[3] - pz;
      float dist = sqrtf(lx * lx + ly * ly + lz * lz);
      float inv = 1.f / fmaxf(dist, 1e-20f);
      float sx = isdir ? a[1] : lx * inv;
      float sy = isdir ? a[2] : ly * inv;
      float sz = isdir ? a[3] : lz * inv;
      float maxd_l = isdir ? 1000.f : dist;
      const float up = next_up(maxd_l);
      // the shadow ray's operand is rounded from its f32 components
      float sq[6];
      if (LPRT_OPERAND(FORM)) lprt::make_operand<FORM>(px, py, pz, sx, sy, sz, sq);
      bool blocked = false;
      for (int k = 0; k < TI && !blocked; ++k) {
        const float* row = s_rows + RS * k;
        float Oz, Dz;
        lprt::plane_oz_dz(*reinterpret_cast<const float4*>(row + PL), px, py, pz, sx, sy, sz,
                          Oz, Dz);
        // the winner's own triangle never blocks
        if ((__float_as_int(row[TRI]) == btri) | cull(Oz, Dz, up, need_pos)) continue;
        float t, u, v;
        bool geom = lprt::tri_test_oz<FORM>(row, px, py, pz, sx, sy, sz, sq, band, Oz, Dz, t,
                                            u, v);
        blocked = geom && (t > d_mov) && (t < maxd_l) && isfinite(t);
      }
      if (!blocked) vis |= 1 << l;
    }
  }
  vis_out[r] = vis;
}

}  // namespace

extern "C" int lprt_dense_trace(const float* orig, const float* dir,
                                const int* skip, const float* mind,
                                const float* maxd, const float* coef,
                                const int* tri_id, const int* obj_id,
                                const float* lights, int R, int TI, int L,
                                float d_mov, int form, float k0, float k1,
                                float k2, int pack, int lb, float* t_out,
                                float* u_out, float* v_out, int* tri_out,
                                int* obj_out, int* vis_out, void* stream) {
  if (TI > LPRT_MAX_TRIS || L > LPRT_MAX_LIGHTS || !lprt::valid_form(form) ||
      (pack && (vis_out != nullptr || !lprt::valid_pack_form(form) || lb < 1 ||
                (1 << lb) < TI)))
    return (int)cudaErrorInvalidValue;
  const int block = LPRT_K1A_BLOCK;
  const int grid = (R + block - 1) / block;
  if (grid == 0) return (int)cudaGetLastError();
  const lprt::Band band = {k0, k1, k2};
  cudaStream_t s = (cudaStream_t)stream;
  const int lmask = (1 << lb) - 1;
#define LPRT_DENSE_ARGS                                                       \
  orig, dir, skip, mind, maxd, coef, tri_id, obj_id, lights, R, TI, L, d_mov, \
      band, lmask, t_out, u_out, v_out, tri_out, obj_out, vis_out
#define LPRT_DENSE_FORM(f)  \
  if (!pack && form == (f)) \
    dense_trace_kernel<(f), false><<<grid, block, 0, s>>>(LPRT_DENSE_ARGS);
  LPRT_FORMS(LPRT_DENSE_FORM)
#undef LPRT_DENSE_FORM
#define LPRT_DENSE_PACK_FORM(f) \
  if (pack && form == (f))      \
    dense_trace_kernel<(f), true><<<grid, block, 0, s>>>(LPRT_DENSE_ARGS);
  LPRT_PACK_FORMS(LPRT_DENSE_PACK_FORM)
#undef LPRT_DENSE_PACK_FORM
#undef LPRT_DENSE_ARGS
  return (int)cudaGetLastError();
}
