// The Q2.4 tool's two chunk bodies (tools/mxu_proto.py): the bf16
// error-band closest hit of each ray over NC chunks of TC random rows.
//
// lprt_mxu_proto_vpu replaces the TPU kernel tools/bench_mxu_proto.py:
// vpu_kernel (:31-100, pallas_call :227); lprt_mxu_proto_mxu replaces
// mxu_kernel (:103-162, pallas_call :235).  Plain versions:
// tools/mxu_proto.py:vpu_body_plain and mxu_body_plain.
//
// Both, per ray and chunk: t = -Oz/Dz, u = Ox + t Dx, v = Oy + t Dy from the
// dtype rows, the band eu = (d12 S_ox + t d12 S_dx + d1 (|Ox| + 3 |t Dx|))
// 0.2 (ev likewise), the strict f32 re-test (u32, v32) on ambiguous lanes;
// accepted rows need t > 0 and a finite t.  The chunk's winner is the
// least accepted t with, over the rows at that t, the largest u and the
// largest v (two separate maxima, as the reference takes them); across
// chunks a strictly smaller t wins.  Out: t (1e5 where nothing is
// accepted), u, v (0 there).
//
// vpu: one thread per ray; the table (per row [n_dt (bf16 values) | n_f32
// | e], 21 floats) in shared memory, read as broadcasts.  Every expression
// keeps the plain version's order and the source builds with
// --fmad=false: equal to the plain version bit for bit.  Bound: operations,
// ~142 f32 operations per (ray, row).
//
// mxu: the K = 16 product of the bf16 table Aab (8 blocks [Ox Oy Dx Dy Sox
// Soy Sdx Sdy] of TC rows) against the ray rounded to bf16 ([o 1 d 0 | |o|
// 1 |d| 0]) runs on the tensor cores, hand-written
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: the table rows are
// the M side (16 at a time), the rays the N side (8 per tile).  A warp
// takes one ray tile (8 rays) and, for each 16-row slice i of the chunk,
// issues one mma per block b, so that each thread holds the 8 block values
// of the same 4 (row, ray) pairs (rows g, g + 8 of the slice, rays 2q,
// 2q + 1 of the tile; g = lane / 4, q = lane % 4).  The
// K = 8 f32 product (Oz, Dz, Ox32, Oy32, Dx32, Dy32 against [o 1 d 0])
// stays on the CUDA cores in f32, in the plain version's order (TF32 would
// change it), and so does the tail.  The per-ray winner is reduced across
// the 8 lanes that share q by shuffles.  A block of 4 warps stages each
// chunk's Aab (TC x 8 x 32 bytes) and A32 (8 x 6 TC f32) in shared memory.
// The tensor cores' accumulation order is not the plain version's, so this
// body is held to its plain version by a bar (tools/mxu_proto.py), not bit
// for bit.  Bound: the f32 operations on the CUDA cores (~155 per (ray,
// row)); the tensor-core product is 1/4 of that at 15x the rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float D12 = 0.0390625f;  // 2^-7 + 2^-5
constexpr float D1F = 0.0078125f;  // 2^-7
constexpr float NEG = -3e38f;

// The running winner of one chunk, and its fold across rows, lanes and
// chunks: the least t, the largest u and v at that t.
struct Win {
  float t = INFINITY, u = NEG, v = NEG;

  __device__ __forceinline__ void add(float t_, float u_, float v_) {
    if (t_ < t) {
      t = t_;
      u = u_;
      v = v_;
    } else if (t_ == t) {
      u = fmaxf(u, u_);
      v = fmaxf(v, v_);
    }
  }
};

// The tail from the blocks of one (row, ray) pair; -> accepted, with
// t, u_sel, v_sel.  The plain version's expressions, in its order.
__device__ __forceinline__ bool tail(float Oz, float Dz, float Ox, float Oy,
                                     float Dx, float Dy, float s_ox, float s_oy,
                                     float s_dx, float s_dy, float Ox32,
                                     float Oy32, float Dx32, float Dy32,
                                     float& t, float& u_sel, float& v_sel) {
  t = -Oz / Dz;
  float u = Ox + t * Dx;
  float v = Oy + t * Dy;
  float eu = (D12 * s_ox + t * D12 * s_dx + D1F * (fabsf(Ox) + 3.f * fabsf(t * Dx))) * 0.2f;
  float ev = (D12 * s_oy + t * D12 * s_dy + D1F * (fabsf(Oy) + 3.f * fabsf(t * Dy))) * 0.2f;
  float u32 = Ox32 + t * Dx32;
  float v32 = Oy32 + t * Dy32;
  bool ok32 = (u32 > 0.f) && (v32 > 0.f) && (u32 + v32 < 1.f);
  float w = 1.f - u - v;
  float ew = eu + ev;
  bool amb = (u >= -eu && u <= 0.f) || (v >= -ev && v <= 0.f) || (w >= -ew && w <= 0.f);
  bool dtype_accept = (u > -eu) && (v > -ev) && (u + v < 1.f + eu + ev);
  u_sel = amb ? u32 : u;
  v_sel = amb ? v32 : v;
  return ((amb && ok32) || (!amb && dtype_accept)) && (t > 0.f) && isfinite(t);
}

// ---------------------------------------------------------------------------
// vpu

__global__ void vpu_kernel(const float* __restrict__ table,
                           const float* __restrict__ o,
                           const float* __restrict__ d, int R, int TI, int TC,
                           float* __restrict__ t_out, float* __restrict__ u_out,
                           float* __restrict__ v_out) {
  extern __shared__ float s_tab[];  // TI x [n_dt 9 | n_f32 9 | e 3]
  for (int i = threadIdx.x; i < TI * 21; i += blockDim.x) s_tab[i] = table[i];
  __syncthreads();
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float ox = o[r], oy = o[R + r], oz = o[2 * R + r];
  float dx = d[r], dy = d[R + r], dz = d[2 * R + r];
  float aox = fabsf(ox), aoy = fabsf(oy), aoz = fabsf(oz);
  float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
  float bt = 1e5f, bu = 0.f, bv = 0.f;
  for (int c0 = 0; c0 < TI; c0 += TC) {
    Win win;
    for (int k = c0; k < c0 + TC; ++k) {
      const float* a = s_tab + 21 * k;  // n_dt
      const float* b = a + 9;           // n_f32
      const float* e = a + 18;
      float Ox = a[0] * ox + a[1] * oy + a[2] * oz + e[0];
      float Dx = a[0] * dx + a[1] * dy + a[2] * dz;
      float Oy = a[3] * ox + a[4] * oy + a[5] * oz + e[1];
      float Dy = a[3] * dx + a[4] * dy + a[5] * dz;
      float Oz = b[6] * ox + b[7] * oy + b[8] * oz + e[2];
      float Dz = b[6] * dx + b[7] * dy + b[8] * dz;
      float s_ox = fabsf(a[0]) * aox + fabsf(a[1]) * aoy + fabsf(a[2]) * aoz + fabsf(e[0]);
      float s_dx = fabsf(a[0]) * adx + fabsf(a[1]) * ady + fabsf(a[2]) * adz;
      float s_oy = fabsf(a[3]) * aox + fabsf(a[4]) * aoy + fabsf(a[5]) * aoz + fabsf(e[1]);
      float s_dy = fabsf(a[3]) * adx + fabsf(a[4]) * ady + fabsf(a[5]) * adz;
      float Ox32 = b[0] * ox + b[1] * oy + b[2] * oz + e[0];
      float Dx32 = b[0] * dx + b[1] * dy + b[2] * dz;
      float Oy32 = b[3] * ox + b[4] * oy + b[5] * oz + e[1];
      float Dy32 = b[3] * dx + b[4] * dy + b[5] * dz;
      float t, u, v;
      if (tail(Oz, Dz, Ox, Oy, Dx, Dy, s_ox, s_oy, s_dx, s_dy, Ox32, Oy32, Dx32, Dy32,
               t, u, v))
        win.add(t, u, v);
    }
    if (isfinite(win.t) && win.t < bt) {
      bt = win.t;
      bu = win.u;
      bv = win.v;
    }
  }
  t_out[r] = bt;
  u_out[r] = bu;
  v_out[r] = bv;
}

// ---------------------------------------------------------------------------
// mxu

constexpr int WARPS = 4;  // per block; a warp takes one ray tile of 8 rays
constexpr int RAYS_PER_BLOCK = WARPS * 8;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat16 a = __float2bfloat16_rn(lo), b = __float2bfloat16_rn(hi);
  return (uint32_t)__bfloat16_as_ushort(a) | ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f),
        "f"(0.f), "f"(0.f));
}

// The f32 product of one A32 column (8 features) against [o 1 d 0], in the
// plain version's order (k = 0, 1, ...).
__device__ __forceinline__ float dot8(const float* col, int stride, const float* b) {
  float acc = col[0] * b[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) acc = acc + col[k * stride] * b[k];
  return acc;
}

__global__ void __launch_bounds__(WARPS * 32)
    mxu_kernel(const float* __restrict__ a32t, const __nv_bfloat16* __restrict__ aab,
               const float* __restrict__ o, const float* __restrict__ d, int R,
               int NC, int TC, int P32, int P16, float* __restrict__ t_out,
               float* __restrict__ u_out, float* __restrict__ v_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_a32 = reinterpret_cast<float*>(smem);  // 8 x P32
  uint32_t* s_ab = reinterpret_cast<uint32_t*>(s_a32 + 8 * P32);  // 8 TC rows x 8 words

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int base = blockIdx.x * RAYS_PER_BLOCK + warp * 8;

  // the B fragment: ray base + g, features k = 2q, 2q + 1, 2q + 8, 2q + 9
  uint32_t b0, b1;
  {
    const int rb = base + g;
    float f[16];
    if (rb < R) {
      const float x[8] = {o[rb], o[R + rb], o[2 * R + rb], 1.f,
                          d[rb], d[R + rb], d[2 * R + rb], 0.f};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        f[k] = x[k];
        f[8 + k] = (k == 3) ? 1.f : fabsf(x[k]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) f[k] = 0.f;
    }
    b0 = pack_bf16(f[2 * q], f[2 * q + 1]);
    b1 = pack_bf16(f[2 * q + 8], f[2 * q + 9]);
  }
  // the f32 rays of the thread's two output columns: base + 2q + h
  float ray[2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = base + 2 * q + h;
    const bool in = r < R;
    float* y = ray[h];
    y[0] = in ? o[r] : 0.f;
    y[1] = in ? o[R + r] : 0.f;
    y[2] = in ? o[2 * R + r] : 0.f;
    y[3] = 1.f;
    y[4] = in ? d[r] : 0.f;
    y[5] = in ? d[R + r] : 0.f;
    y[6] = in ? d[2 * R + r] : 0.f;
    y[7] = 0.f;
  }
  float bt[2] = {1e5f, 1e5f}, bu[2] = {0.f, 0.f}, bv[2] = {0.f, 0.f};

  for (int c = 0; c < NC; ++c) {
    __syncthreads();  // the previous chunk's tables are no longer read
    const float* g32 = a32t + (size_t)c * 8 * P32;
    for (int i = threadIdx.x; i < 8 * P32; i += blockDim.x) s_a32[i] = g32[i];
    const uint32_t* gab = reinterpret_cast<const uint32_t*>(aab + (size_t)c * P16 * 16);
    for (int i = threadIdx.x; i < 8 * TC * 8; i += blockDim.x) s_ab[i] = gab[i];
    __syncthreads();

    Win win[2];
    for (int i = 0; i < TC / 16; ++i) {
      float acc[8][4];
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int m0 = b * TC + 16 * i;
        // A fragment: rows m0 + g, m0 + g + 8; K pairs 2q, 2q + 8 (8 words a row)
        mma_bf16(acc[b], s_ab[(m0 + g) * 8 + q], s_ab[(m0 + g + 8) * 8 + q],
                 s_ab[(m0 + g) * 8 + q + 4], s_ab[(m0 + g + 8) * 8 + q + 4], b0, b1);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // the C fragment's (row, ray) pairs
        const int row = 16 * i + g + (j >= 2 ? 8 : 0);
        const float* y = ray[j & 1];
        float Oz = dot8(s_a32 + 0 * TC + row, P32, y);
        float Dz = dot8(s_a32 + 1 * TC + row, P32, y);
        float Ox32 = dot8(s_a32 + 2 * TC + row, P32, y);
        float Oy32 = dot8(s_a32 + 3 * TC + row, P32, y);
        float Dx32 = dot8(s_a32 + 4 * TC + row, P32, y);
        float Dy32 = dot8(s_a32 + 5 * TC + row, P32, y);
        float t, u, v;
        if (tail(Oz, Dz, acc[0][j], acc[1][j], acc[2][j], acc[3][j], acc[4][j], acc[5][j],
                 acc[6][j], acc[7][j], Ox32, Oy32, Dx32, Dy32, t, u, v))
          win[j & 1].add(t, u, v);
      }
    }
    // the chunk's winner per ray: fold across the 8 lanes that share q
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Win& w = win[h];
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        float t2 = __shfl_xor_sync(0xffffffffu, w.t, m);
        float u2 = __shfl_xor_sync(0xffffffffu, w.u, m);
        float v2 = __shfl_xor_sync(0xffffffffu, w.v, m);
        if (isfinite(t2)) w.add(t2, u2, v2);
      }
      if (isfinite(w.t) && w.t < bt[h]) {
        bt[h] = w.t;
        bu[h] = w.u;
        bv[h] = w.v;
      }
    }
  }
  if (g != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = base + 2 * q + h;
    if (r < R) {
      t_out[r] = bt[h];
      u_out[r] = bu[h];
      v_out[r] = bv[h];
    }
  }
}

}  // namespace

extern "C" int lprt_mxu_proto_vpu(const float* table, const float* o,
                                  const float* d, int R, int TI, int TC,
                                  float* t_out, float* u_out, float* v_out,
                                  void* stream) {
  const size_t smem = (size_t)TI * 21 * sizeof(float);
  if (TC < 1 || TI % TC || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int block = 256;
  const int grid = (R + block - 1) / block;
  if (grid > 0)
    vpu_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(table, o, d, R, TI, TC, t_out,
                                                            u_out, v_out);
  return (int)cudaGetLastError();
}

extern "C" int lprt_mxu_proto_mxu(const float* a32t, const void* aab, const float* o,
                                  const float* d, int R, int NC, int TC, int P32, int P16,
                                  float* t_out, float* u_out, float* v_out,
                                  void* stream) {
  const size_t smem = (size_t)8 * P32 * sizeof(float) + (size_t)8 * TC * 16 * 2;
  if (TC < 16 || TC % 16 || P32 < 6 * TC || P16 < 8 * TC || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const int grid = (R + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK;
  if (grid > 0)
    mxu_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
        a32t, reinterpret_cast<const __nv_bfloat16*>(aab), o, d, R, NC, TC, P32, P16, t_out,
        u_out, v_out);
  return (int)cudaGetLastError();
}
