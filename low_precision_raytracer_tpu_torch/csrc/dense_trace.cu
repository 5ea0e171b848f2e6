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
// What bounds it on the H100: neither bytes nor operations at this size.
// Per ray it reads 36 bytes and writes 24, and runs ~40 f32 operations per
// triangle (~60 more in a band), twice with the shadow phase: at
// 2.07M rays x 34 triangles that is ~3.5 GFLOP against 67 TFLOP/s, and
// ~125 MB against 3.35 TB/s, both tens of microseconds.  The design keeps
// the triangle table and the light rows in shared memory (one 6 KB copy per
// block, 14 KB with a sub-f32 form's band rows, read as broadcasts), one
// thread per ray with coalesced ray loads,
// and no atomics.  Lanes with maxd <= mind keep the miss values without
// testing (the TPU's dead-tile guard, per lane).  Built with --fmad=false
// so the test rounds like its plain version.

#include "trace_common.cuh"

#define LPRT_MAX_TRIS 128
#define LPRT_MAX_LIGHTS 32

namespace {

template <int FORM, bool PACK>
__global__ void dense_trace_kernel(
    const float* __restrict__ orig, const float* __restrict__ dir,
    const int* __restrict__ skip, const float* __restrict__ mind,
    const float* __restrict__ maxd, const float* __restrict__ coef,
    const int* __restrict__ tri_id, const int* __restrict__ obj_id,
    const float* __restrict__ lights, int R, int TI, int L, float d_mov,
    lprt::Band band, int lmask, float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ tri_out,
    int* __restrict__ obj_out, int* __restrict__ vis_out) {
  constexpr int ROW = LPRT_ROW(FORM);
  __shared__ float s_coef[LPRT_MAX_TRIS * ROW];
  __shared__ int s_tri[LPRT_MAX_TRIS];
  __shared__ int s_obj[LPRT_MAX_TRIS];
  __shared__ float s_light[LPRT_MAX_LIGHTS * 4];
  for (int i = threadIdx.x; i < TI * ROW; i += blockDim.x) s_coef[i] = coef[i];
  for (int i = threadIdx.x; i < TI; i += blockDim.x) {
    s_tri[i] = tri_id[i];
    s_obj[i] = obj_id[i];
  }
  for (int i = threadIdx.x; i < L * 4; i += blockDim.x) s_light[i] = lights[i];
  __syncthreads();

  int r = blockIdx.x * blockDim.x + threadIdx.x;
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
    for (int k = 0; k < TI; ++k) {
      float t, u, v;
      bool geom = lprt::tri_test<FORM>(s_coef + ROW * k, ox, oy, oz, dx, dy, dz, q,
                                       band, t, u, v);
      int tri = s_tri[k];
      bool acc = geom && (t > mn) && (t < mx) && (tri != sk) && isfinite(t);
      if (PACK) {
        if (acc && t > 0.f) pb.row_test(t, u, v, k, lmask);
      } else if (acc && (t < bt || (t == bt && tri < btri))) {
        bt = t;
        bu = u;
        bv = v;
        btri = tri;
        bobj = s_obj[k];
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
      // the shadow ray's operand is rounded from its f32 components
      float sq[6];
      if (LPRT_OPERAND(FORM)) lprt::make_operand<FORM>(px, py, pz, sx, sy, sz, sq);
      bool blocked = false;
      for (int k = 0; k < TI && !blocked; ++k) {
        float t, u, v;
        bool geom = lprt::tri_test<FORM>(s_coef + ROW * k, px, py, pz, sx, sy, sz, sq,
                                         band, t, u, v);
        blocked = geom && (t > d_mov) && (t < maxd_l) && (s_tri[k] != btri) &&
                  isfinite(t);
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
  const int block = 256;
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
