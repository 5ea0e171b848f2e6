// SVGF kernels for the denoiser pair (GI-coloured and GI-white instances).
// All planes are unpadded channel-major (C, H, W) f32; a tap outside the
// image reads 0 in every channel (mask channels included), which is what
// the zero pads of the TPU layout gave.  Plain versions live in
// ops/svgf_kernels.py.  Arithmetic follows the TPU kernels' order so that
// NaN/Inf travel the same way (no fast-math; built with --fmad=false).
//
// lprt_coef_fetch  replaces ops/svgf_pallas.py:_coef_fetch_kernel
//                  (coef_fetch_pallas): the weighted temporal history fetch.
// lprt_temporal    replaces ops/svgf_pallas.py:_temporal_kernel
//                  (temporal_accum_pallas_pair): temporal accumulation.
// lprt_wavelet     replaces ops/svgf_pallas.py:_wavelet_kernel
//                  (wavelet_iter_pallas): one a-trous iteration.
//
// What bounds them on the H100, at 1920x1080: each is a stencil whose
// compulsory traffic is a few hundred MB (K2 17 planes in, 11 out; K3 24
// in, 20 out; K4 23 in, 12 out: 0.09-0.37 GB, 27-110 us at 3.35 TB/s) but
// whose tap loops re-read neighbours many times (K2 16 views x 10
// channels, K3 a 9x9 box per stage-1 position, K4 25 taps x 18 channels)
// and run ~0.2-1.5 kFLOP per pixel.  The designs keep those re-reads on
// chip: K2 stages a 64 x 16 tile's shifted history window in shared memory
// and, where the window is finite, sums only the 4 views its residual
// selects (see K2 below); K3 stages a 32 x 32 tile's colour with its 6-pixel
// halo and its geometry with a 2-pixel ring in shared memory (see K3
// below); K4 stages a tile of one coset with its ring (see K4 below).

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float nan_max(float a, float b) {
  // jnp.maximum semantics: NaN in either operand gives NaN
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ float pow_int(float x, int n) {
  // binary squaring, the same multiply chain as ops/svgf.py:_pow_int
  if (n <= 0) return 1.f;
  float result = 0.f, base = x;
  bool have = false;
  while (n > 0) {
    if (n & 1) {
      result = have ? result * base : base;
      have = true;
    }
    base = base * base;
    n >>= 1;
  }
  return result;
}

__device__ __forceinline__ int pmod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

// a-trous / bilateral tap weights h = (3/8, 1/4, 1/16) and the 3x3
// gaussian (1/2, 1/4): products formed in double, then rounded to f32 like
// the TPU kernels' jnp.asarray(python float, f32)
__device__ __forceinline__ float wavelet_h(int a, int b) {
  const double h[3] = {3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0};
  return (float)(h[a < 0 ? -a : a] * h[b < 0 ? -b : b]);
}

__device__ __forceinline__ float gauss_g(int a, int b) {
  const double g[2] = {1.0 / 2.0, 1.0 / 4.0};
  return (float)(g[a < 0 ? -a : a] * g[b < 0 ? -b : b]);
}

// max(0, n.n')^sigma_n in three forms: pow_int's multiply chain with the
// exponent known at compile time (N >= 0) or an integer at run time
// (N == -1), the same chain either way; or a non-integer exponent (N == -2):
// powf, as the plain version's torch.pow and the TPU kernels' `**`
template <int N>
__device__ __forceinline__ float pow_n(float x, float sn) {
  if (N == -2) return powf(x, sn);
  if (N < 0) return pow_int(x, (int)sn);
  if (N == 0) return 1.f;
  float result = 0.f, base = x;
  bool have = false;
#pragma unroll
  for (int b = 0; b < 31; ++b) {
    if ((N >> b) == 0) break;
    if ((N >> b) & 1) {
      result = have ? result * base : base;
      have = true;
    }
    base = base * base;
  }
  return result;
}

// ---------------------------------------------------------------------------
// K2: weighted temporal fetch on the shifted-select fast path.
// hist (C, H, W) in the consumer's channel order; rw (7, H, W) =
// [res_y, res_x, w0..w3, count]; (my, mx) the global motion.  View (vy, vx)
// of pixel (y, x) reads the 1-pixel zero-padded history at
// ((y + 1 + vy + my) mod (H + 2), (x + 1 + vx + mx) mod (W + 2)) — the
// XLA-side roll + wrap pad of the TPU path, folded into the index.
// out (C + 1, H, W) = [sum_k w_k tap_k / sum_k w_k, 0 where count == 0 |
// count].  The plain version (and the TPU) multiplies every one of the 16
// views (vx outer, vy inner, -1..2) by its coefficient, 0 too, so that a
// non-finite neighbour reaches the sum.
//
// Design: a block of 64 x 8 threads takes a 64 x 16 tile (two rows a
// thread) and stages its shifted history window in shared memory: the tile
// with a ring of 1 pixel before and 2 after in each axis, all C channels
// (19 x 67 x 10 f32 = 50,920 B on the main path; the ring re-reads 24% of
// the tile's history bytes, mostly from L2), in coalesced loads.  The wrap
// and pad index is worked out once per staged row and column (s_row,
// s_col), not once per tap.  One __syncthreads_and finds whether every
// staged value is finite.  If so, each pixel sums only its matched views,
// which is exact (bit for bit the 16-view sum):
// - Tap k (offset (dy, dx) in (0,0), (0,1), (1,0), (1,1)) puts w_k on view
//   (vy, vx) only where (res_y, res_x) == (vy - dy, vx - dx), so for a
//   residual (ry, rx) in {-1, 0, 1}^2 exactly the views (ry + dy_k,
//   rx + dx_k) carry a term w_k, one each, and every other coefficient is
//   a sum of +0 terms; a residual outside the window matches no view.
// - A matched view's coefficient is w_k plus +0 terms: w_k + 0 = w_k for
//   any w_k other than -0 (NaN and +-Inf pass unchanged), and -0 + 0 = +0,
//   a zero either way.
// - With every tap finite, a zero coefficient gives a term of +-0.  num
//   starts at +0 and takes num = num + term: x + (+-0) = x for x != 0, and
//   +0 + (+-0) = +0, so a zero term never changes num.  num is never -0: it
//   starts at +0, a zero term keeps it, and a sum of nonzero terms that
//   cancels rounds to +0.  So dropping the zero terms, and taking w_k for a
//   coefficient that is w_k up to the sign of a zero, leaves num's bits as
//   they were, provided the remaining terms keep their order: vx outer, vy
//   inner gives the taps in the order k = 0, 2, 1, 3.
// A tile with any non-finite staged value runs the full 16-view sum (from
// shared memory), where 0 x Inf = NaN must reach num as in the plain
// version.  Outputs are written plane by plane, coalesced.
// What bounds it: bytes (17 planes in, 11 out at C = 10: 0.23 GB at
// 1920x1080, 69 us at 3.35 TB/s); the fast path does 4 multiply-adds and
// a divide a pixel and channel.
#define F_TW 64  // tile width
#define F_TH 16  // tile height
#define F_BY 8   // thread rows: F_TH / F_BY pixel rows each
#define F_SW (F_TW + 3)  // staged columns: 1 before the tile, 2 after
#define F_SH (F_TH + 3)  // staged rows
#define F_PLANE (F_SH * F_SW)
#define LPRT_MAX_FETCH_C 16

// the view offset (-1, 0, 1) a residual selects, or false outside the window
__device__ __forceinline__ bool residual_view(float r, int* v) {
  if (r == -1.f) *v = -1;
  else if (r == 0.f) *v = 0;
  else if (r == 1.f) *v = 1;
  else return false;
  return true;
}

// CT > 0: C = CT at compile time (the main path's 10); CT = 0: C at run time
template <int CT>
__global__ void __launch_bounds__(F_TW * F_BY)
    coef_fetch_kernel(const float* __restrict__ hist, const float* __restrict__ rw, int C_rt,
                      int H, int W, int my, int mx, float* __restrict__ out) {
  const int C = CT > 0 ? CT : C_rt;
  extern __shared__ float s_hist[];  // [C][F_SH][F_SW]
  __shared__ int s_row[F_SH], s_col[F_SW];  // the staged row / column's source, -1 outside
  const int x0 = blockIdx.x * F_TW, y0 = blockIdx.y * F_TH;
  const int tid = threadIdx.y * F_TW + threadIdx.x;
  // staged row wy holds padded row (y0 + wy + my) mod (H + 2): view vy of
  // tile row ly is staged row ly + 1 + vy
  if (tid < F_SH) {
    int py = pmod(y0 + tid + my, H + 2) - 1;
    s_row[tid] = py >= 0 && py < H ? py : -1;
  } else if (tid < F_SH + F_SW) {
    int px = pmod(x0 + (tid - F_SH) + mx, W + 2) - 1;
    s_col[tid - F_SH] = px >= 0 && px < W ? px : -1;
  }
  __syncthreads();
  const size_t HW = (size_t)H * W;
  bool fin = true;
  // each thread stages the same window positions in every channel: the C
  // loads of a position are independent, so they are in flight together
  for (int i = tid; i < F_PLANE; i += F_TW * F_BY) {
    const int wy = i / F_SW, wx = i - wy * F_SW;
    const int py = s_row[wy], px = s_col[wx];
    const bool in = py >= 0 && px >= 0;
    const float* src = hist + (in ? (size_t)py * W + px : 0);
    if (CT > 0) {
      float v[CT > 0 ? CT : 1];
#pragma unroll
      for (int c = 0; c < CT; ++c) v[c] = in ? __ldg(src + c * HW) : 0.f;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        s_hist[c * F_PLANE + i] = v[c];
        fin = fin && isfinite(v[c]);
      }
    } else {
      for (int c = 0; c < C; ++c) {
        const float v = in ? __ldg(src + c * HW) : 0.f;
        s_hist[c * F_PLANE + i] = v;
        fin = fin && isfinite(v);
      }
    }
  }
  const bool all_fin = __syncthreads_and(fin);

  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  const int tdy[4] = {0, 0, 1, 1}, tdx[4] = {0, 1, 0, 1};
#pragma unroll
  for (int j = 0; j < F_TH / F_BY; ++j) {
    const int ly = threadIdx.y + j * F_BY, y = y0 + ly;
    if (y >= H) break;
    const size_t p = (size_t)y * W + x;
    const float ry = rw[p], rx = rw[HW + p];
    const float wk[4] = {rw[2 * HW + p], rw[3 * HW + p], rw[4 * HW + p], rw[5 * HW + p]};
    const float count = rw[6 * HW + p];
    const float den = wk[0] + wk[1] + wk[2] + wk[3];
    const float den_safe = den > 0.f ? den : 1.f;
    const bool gate = count > 0.f;
    // view (0, 0) of this pixel in channel 0
    const float* s0 = s_hist + (ly + 1) * F_SW + threadIdx.x + 1;
    int iy, ix;
    if (all_fin) {
      const bool m = residual_view(ry, &iy) && residual_view(rx, &ix);
      for (int c = 0; c < C; ++c) {
        float num = 0.f;
        if (m) {
          const float* q = s0 + c * F_PLANE + iy * F_SW + ix;
          num = num + wk[0] * q[0];         // view (ry, rx)
          num = num + wk[2] * q[F_SW];      // (ry + 1, rx)
          num = num + wk[1] * q[1];         // (ry, rx + 1)
          num = num + wk[3] * q[F_SW + 1];  // (ry + 1, rx + 1)
        }
        out[c * HW + p] = gate ? num / den_safe : 0.f;
      }
    } else {
      float coeff[16];  // [vx + 1][vy + 1], as the plain version forms them
#pragma unroll
      for (int vx = -1; vx <= 2; ++vx) {
#pragma unroll
        for (int vy = -1; vy <= 2; ++vy) {
          float cf = 0.f;
          bool any = false;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int sy = vy - tdy[k], sx = vx - tdx[k];
            if (sy < -1 || sy > 1 || sx < -1 || sx > 1) continue;
            const float term = (ry == (float)sy && rx == (float)sx) ? wk[k] : 0.f;
            cf = any ? cf + term : term;
            any = true;
          }
          coeff[4 * (vx + 1) + vy + 1] = cf;
        }
      }
      for (int c = 0; c < C; ++c) {
        float num = 0.f;
        const float* q = s0 + c * F_PLANE;
#pragma unroll
        for (int vx = -1; vx <= 2; ++vx) {
#pragma unroll
          for (int vy = -1; vy <= 2; ++vy)
            num = num + coeff[4 * (vx + 1) + vy + 1] * q[vy * F_SW + vx];
        }
        out[c * HW + p] = gate ? num / den_safe : 0.f;
      }
    }
    out[C * HW + p] = count;
  }
}

template <int CT>
int launch_coef_fetch(const float* hist, const float* rw, int C, int H, int W, int my,
                      int mx, float* out, cudaStream_t s) {
  const size_t smem = sizeof(float) * C * F_PLANE;
  cudaError_t e = cudaFuncSetAttribute(
      coef_fetch_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 block(F_TW, F_BY);
  dim3 grid((W + F_TW - 1) / F_TW, (H + F_TH - 1) / F_TH);
  coef_fetch_kernel<CT><<<grid, block, smem, s>>>(hist, rw, C, H, W, my, mx, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3: temporal accumulation for both instances.
// col6 (6, H, W) raw colour [inst0 rgb | inst1 rgb]; geo7 (7, H, W) =
// [depth (NaN -> 1e30), gx*sigma_z, gy*sigma_z, nx, ny, nz, one];
// ctr11 (11, H, W) = the K2 fetch [h0 rgb, h1 rgb, m1_0, m1_1, m2_0, m2_1,
// count].  Stage 1 (outlier clamp of the 9x9 box moments, history lerp,
// illuminance) runs on the tile plus a 2-pixel ring, so the 5x5 moments of
// stage 2 read it from shared memory.
// out: cv (12, H, W) [per instance r, g, b, var, fc, fv], ext (4, H, W)
// [il0, il1, pen0, pen1], mst (4, H, W) [m1_0, m1_1, m2_0, m2_1].
//
// Design: a block of 32 x 16 threads takes a 32 x 32 tile (each thread two
// pixels in stage 2), so the colour halo it re-reads is 44 x 44 / 32^2 =
// 1.9x and stage 1 runs on 36 x 36 / 32^2 = 1.27x.  Per instance:
// (A) its three colour channels are staged once for the 44-row region, in
//     row-aligned float4 loads where the rows allow (W % 4 == 0 and an
//     aligned base), as the plain version's `safe` value (0 where not
//     finite or outside the image) and one bit per pixel, finite and in the
//     image (the `finv` indicator), in two words a row;
// (B) one thread per (channel, column, strip of 9 stage-1 rows) forms the
//     strip's 17 row sums (9 taps each, in order) in a register ring and
//     each stage-1 value from 9 of them (in order), then the clamp and the
//     history lerp; the counts are popcounts of the bit rows (sums of
//     0 / 1 in any order are exact); ic goes to shared memory and, on the
//     tile, straight to cv;
// (C) the illuminance (r, g, b terms in order) and its finiteness mask.
// Depth and normal of the tile and its 2-pixel ring are staged once as
// float4 (zero outside the image, as the plain version's pad), so stage 2's
// 25 taps read only shared memory.  Five barriers for the whole tile, where
// the 32 x 8 tile of one channel at a time took twenty.  Shared memory:
// ~84 KB a block, two blocks (1,024 threads) an SM.  Every pixel keeps the
// plain version's term order, IEEE division, expf and pow_int's multiply
// chain (unrolled for the configured sigma_n = 128; powf for a non-integer
// sigma_n).
//
// What bounds it: bytes (24 planes in, 20 out: 0.36 GB at 1920x1080,
// 109 us at 3.35 TB/s); the row and column sums (~80 f32 operations a pixel
// and channel) and the 25 taps' divides and expf are the on-chip work.
#define T_TW 32   // tile width and height
#define T_TY 16   // thread rows: two pixel rows each
#define T_S1 (T_TW + 4)   // stage-1 region: the tile and a 2-pixel ring
#define T_INH (T_S1 + 8)  // colour rows staged: the stage-1 rows +- 4
#define T_INW (T_TW + 16) // colour columns staged: col0 - 8 .. col0 + 39 (44 used)
#define T_STRIP 9         // stage-1 rows per thread in (B)
#define T_NSTRIP (T_S1 / T_STRIP)

// the shared memory of one block, carved from the dynamic allocation
struct TemporalSmem {
  float safe[3][T_INH][T_INW];          // (A): one instance's colour, `safe`
  unsigned bits[2][3][T_INH][2];        // (A): finite-and-in-image bits a row
  float ic[3][T_S1][T_S1];              // (B)
  float il[2][T_S1][T_S1], fil[2][T_S1][T_S1];  // (C), both instances
  float4 geo[T_S1][T_S1];               // depth, nx, ny, nz
  unsigned char fin_ic[T_TW][T_TW];     // bit i: instance i's ic all finite
};

template <int SN>
__global__ void __launch_bounds__(T_TW* T_TY, 2)
    temporal_kernel(const float* __restrict__ col6,
                    const float* __restrict__ geo7,
                    const float* __restrict__ ctr11, int H, int W, int vec,
                    float color_w, float moments_w, float below, float sigma_n,
                    float eps_z, float* __restrict__ cv,
                    float* __restrict__ ext, float* __restrict__ mst) {
  extern __shared__ float4 smem_raw[];
  TemporalSmem& S = *reinterpret_cast<TemporalSmem*>(smem_raw);
  const int tid = threadIdx.y * T_TW + threadIdx.x;
  const int nthr = T_TW * T_TY;
  const int row0 = blockIdx.y * T_TW, col0 = blockIdx.x * T_TW;
  const size_t HW = (size_t)H * W;
  const float lum_w[3] = {0.2126f, 0.7152f, 0.0722f};
  const float one_m_wc = 1.f - color_w;
  auto inside = [&](int y, int x) { return y >= 0 && y < H && x >= 0 && x < W; };

  for (int i = tid; i < 2 * 3 * T_INH * 2; i += nthr) (&S.bits[0][0][0][0])[i] = 0u;
  __syncthreads();

  // (A) instance `inst`'s colour; with the first, the geometry of stage 2
  auto stage = [&](int inst) {
    constexpr int V = T_INW / 4;  // float4 a row
    for (int i = tid; i < 3 * T_INH * V; i += nthr) {
      const int c = i / (T_INH * V), r = i % (T_INH * V);
      const int iy = r / V, k = r % V;
      const int y = row0 - 6 + iy, x0 = col0 - 8 + 4 * k;
      const float* ch = col6 + (size_t)(3 * inst + c) * HW;
      float v[4];
      if (vec && y >= 0 && y < H && x0 >= 0 && x0 + 3 < W) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(ch + (size_t)y * W + x0));
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = inside(y, x0 + e) ? __ldg(ch + (size_t)y * W + x0 + e) : 0.f;
      }
      unsigned nib = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool fin = isfinite(v[e]);
        if (fin && inside(y, x0 + e)) nib |= 1u << e;
        v[e] = fin ? v[e] : 0.f;
      }
      *reinterpret_cast<float4*>(&S.safe[c][iy][4 * k]) = make_float4(v[0], v[1], v[2], v[3]);
      if (nib) atomicOr(&S.bits[inst][c][iy][k >> 3], nib << (4 * (k & 7)));
    }
    if (inst == 0) {
      for (int i = tid; i < T_S1 * T_S1; i += nthr) {
        const int sy = i / T_S1, sx = i % T_S1;
        const int y = row0 - 2 + sy, x = col0 - 2 + sx;
        float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
        if (inside(y, x)) {
          const size_t q = (size_t)y * W + x;
          g = make_float4(__ldg(geo7 + q), __ldg(geo7 + 3 * HW + q), __ldg(geo7 + 4 * HW + q),
                          __ldg(geo7 + 5 * HW + q));
        }
        S.geo[sy][sx] = g;
      }
    }
  };

  // (B) the stage-1 values of instance `inst`: one thread per (channel,
  // strip, column); the 9x9 box sums keep the plain version's order (the 9
  // column offsets of a row first, then the 9 rows)
  auto box_stage = [&](int inst) {
    if (tid >= 3 * T_NSTRIP * T_S1) return;
    const int sx = tid % T_S1, c = tid / (T_NSTRIP * T_S1);
    const int sy0 = ((tid / T_S1) % T_NSTRIP) * T_STRIP;
    const unsigned* bits = &S.bits[inst][c][0][0];
    float ra[T_STRIP], rb[T_STRIP], rq[T_STRIP];
#pragma unroll
    for (int r = 0; r < T_STRIP + 8; ++r) {
      const int iy = sy0 + r;
      const float* row = &S.safe[c][iy][sx + 2];
      float b = row[0], q = b * b;
#pragma unroll
      for (int dj = 1; dj < 9; ++dj) {
        const float sv = row[dj];
        b = b + sv;
        q = q + sv * sv;
      }
      const unsigned long long m =
          ((unsigned long long)bits[2 * iy + 1] << 32) | bits[2 * iy];
      ra[r % T_STRIP] = (float)__popcll((m >> (sx + 2)) & 0x1FFull);
      rb[r % T_STRIP] = b;
      rq[r % T_STRIP] = q;
      if (r < 8) continue;
      const int k = r - 8, sy = sy0 + k;
      float rs_f = ra[k % T_STRIP], rs_s = rb[k % T_STRIP], rs_s2 = rq[k % T_STRIP];
#pragma unroll
      for (int di = 1; di < 9; ++di) {
        rs_f = rs_f + ra[(k + di) % T_STRIP];
        rs_s = rs_s + rb[(k + di) % T_STRIP];
        rs_s2 = rs_s2 + rq[(k + di) % T_STRIP];
      }
      float m1c = rs_s / rs_f;
      float m2c = rs_s2 / rs_f;
      const int y = row0 - 2 + sy, x = col0 - 2 + sx;
      const bool in = inside(y, x);
      // the raw centre: finite (or outside the image, where it is 0) -> safe
      const unsigned long long mc =
          ((unsigned long long)bits[2 * (sy + 4) + 1] << 32) | bits[2 * (sy + 4)];
      float p = (!in || ((mc >> (sx + 6)) & 1ull)) ? S.safe[c][sy + 4][sx + 6] : m1c;
      float stdc = sqrtf(m2c - m1c * m1c);
      if (isfinite(stdc)) p = fminf(fmaxf(p, m1c - 0.5f * stdc), m1c + 0.5f * stdc);
      const size_t qi = in ? (size_t)y * W + x : 0;
      float h = in ? __ldg(ctr11 + (size_t)(3 * inst + c) * HW + qi) : 0.f;
      float fcq = in ? __ldg(ctr11 + 10 * HW + qi) : 0.f;
      float hist = fcq > 0.f ? h : p;
      hist = isfinite(hist) ? hist : p;
      float ic = color_w * p + one_m_wc * hist;
      S.ic[c][sy][sx] = ic;
      const int ty = sy - 2, tx = sx - 2;
      if (in && ty >= 0 && ty < T_TW && tx >= 0 && tx < T_TW)
        cv[(size_t)(6 * inst + c) * HW + qi] = ic;
    }
  };

  // (C) instance `inst`'s illuminance and its mask on the stage-1 region
  auto lum_stage = [&](int inst) {
    for (int i = tid; i < T_S1 * T_S1; i += nthr) {
      const int sy = i / T_S1, sx = i % T_S1;
      const float ic0 = S.ic[0][sy][sx], ic1 = S.ic[1][sy][sx], ic2 = S.ic[2][sy][sx];
      float acc = lum_w[0] * ic0;
      acc = acc + lum_w[1] * ic1;
      acc = acc + lum_w[2] * ic2;
      const float one = inside(row0 - 2 + sy, col0 - 2 + sx) ? 1.f : 0.f;
      const bool fin = isfinite(acc);
      S.il[inst][sy][sx] = fin ? acc : 0.f;
      S.fil[inst][sy][sx] = (fin ? 1.f : 0.f) * one;
      const int ty = sy - 2, tx = sx - 2;
      if (ty >= 0 && ty < T_TW && tx >= 0 && tx < T_TW) {
        const bool f = isfinite(ic0) && isfinite(ic1) && isfinite(ic2);
        S.fin_ic[ty][tx] = (inst ? S.fin_ic[ty][tx] : 0) | (f ? 1 << inst : 0);
      }
    }
  };

  stage(0);
  __syncthreads();
  box_stage(0);
  __syncthreads();
  lum_stage(0);
  stage(1);
  __syncthreads();
  box_stage(1);
  __syncthreads();
  lum_stage(1);
  __syncthreads();

  const float one_m_mw = 1.f - moments_w;
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    const int ty = threadIdx.y + T_TY * half, tx = threadIdx.x;
    const int y = row0 + ty, x = col0 + tx;
    if (y >= H || x >= W) continue;
    const size_t p = (size_t)y * W + x;
    const float4 own = S.geo[ty + 2][tx + 2];
    const float depth_p = own.x, nx_p = own.y, ny_p = own.z, nz_p = own.w;
    const float gx = geo7[HW + p], gy = geo7[2 * HW + p];
    float num[2] = {0.f, 0.f}, num2[2] = {0.f, 0.f}, wsum[2] = {0.f, 0.f};
#pragma unroll
    for (int tj = -2; tj <= 2; ++tj) {
#pragma unroll
      for (int ti = -2; ti <= 2; ++ti) {
        const float4 qg = S.geo[ty + 2 + ti][tx + 2 + tj];
        float dd = gx * (float)ti + gy * (float)tj;
        float t1 = fabsf(depth_p - qg.x) / fabsf(dd + eps_z);
        float ndot = nx_p * qg.y + ny_p * qg.z + nz_p * qg.w;
        float w_n = pow_n<SN>(nan_max(0.f, ndot), sigma_n);
        float hw = wavelet_h(ti, tj) * expf(-t1) * w_n;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float hm = hw * S.fil[i][ty + 2 + ti][tx + 2 + tj];
          float iq = S.il[i][ty + 2 + ti][tx + 2 + tj];
          num[i] = num[i] + hm * iq;
          num2[i] = num2[i] + hm * iq * iq;
          wsum[i] = wsum[i] + hm;
        }
      }
    }

    const float fc_c = ctr11[10 * HW + p];
    const bool spatial = fc_c < below;
    const float n2 = nx_p * nx_p + ny_p * ny_p + nz_p * nz_p;
    const bool geo_ok_base = (depth_p < 1e30f * 0.5f) && (n2 > 0.5f);
    const unsigned fin_ic = S.fin_ic[ty][tx];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float ilc = S.il[i][ty + 2][tx + 2];
      bool fin_il = S.fil[i][ty + 2][tx + 2] > 0.f;
      float m1_sp = num[i] / wsum[i];
      float m2_sp = num2[i] / wsum[i];
      float m1_t = one_m_mw * ctr11[(size_t)(6 + i) * HW + p] + moments_w * ilc;
      m1_t = isfinite(m1_t) ? m1_t : ilc;
      float il2 = ilc * ilc;
      float m2_t = one_m_mw * ctr11[(size_t)(8 + i) * HW + p] + moments_w * il2;
      m2_t = isfinite(m2_t) ? m2_t : il2;
      float miu1 = spatial ? m1_sp : m1_t;
      float miu2 = spatial ? m2_sp : m2_t;
      float var = miu2 - miu1 * miu1;
      bool geo_ok = geo_ok_base && fin_il;
      size_t b = (size_t)(6 * i) * HW;
      cv[b + 3 * HW + p] = var;
      cv[b + 4 * HW + p] = ((fin_ic >> i & 1) && geo_ok) ? 1.f : 0.f;
      cv[b + 5 * HW + p] = (isfinite(var) && geo_ok) ? 1.f : 0.f;
      ext[(size_t)i * HW + p] = ilc;
      ext[(size_t)(2 + i) * HW + p] = geo_ok ? 0.f : 1e30f;
      mst[(size_t)i * HW + p] = miu1;
      mst[(size_t)(2 + i) * HW + p] = miu2;
    }
  }
}

template <int SN>
int launch_temporal(const float* col6, const float* geo7, const float* ctr11, int H, int W,
                    float color_w, float moments_w, float below, float sigma_n, float eps_z,
                    float* cv, float* ext, float* mst, cudaStream_t s) {
  const size_t smem = sizeof(TemporalSmem);
  cudaError_t e = cudaFuncSetAttribute(
      temporal_kernel<SN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // float4 rows: every row starts 16-byte aligned
  const int vec = W % 4 == 0 && reinterpret_cast<size_t>(col6) % 16 == 0;
  dim3 block(T_TW, T_TY);
  dim3 grid((W + T_TW - 1) / T_TW, (H + T_TW - 1) / T_TW);
  temporal_kernel<SN><<<grid, block, smem, s>>>(col6, geo7, ctr11, H, W, vec, color_w,
                                                moments_w, below, sigma_n, eps_z, cv, ext, mst);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K4: one a-trous iteration at `stride` for both instances.
// geo (11, H, W) = geo7 + [il0, il1, pen0, pen1]; cv (12, H, W) as K3
// writes it.  Shared depth/normal edge weights, per-instance luminance term
// on the 3x3-gaussian-prefiltered raw variance; a dead centre (pen > 0) or
// a non-finite result falls back to the raw centre value.
//
// Design: the 25 taps of pixel (y, x) at stride s lie on its coset
// (y mod s, x mod s), at most 2 coset points away.  A block takes WT_Y
// coset rows of one row coset cy and, across x, k = min(s, WT_KMAX)
// neighbouring column cosets cx0 .. cx0 + k - 1 of 32 / k coset columns
// each (ops/svgf_kernels.py:wavelet_tiles mirrors this geometry).  It
// stages the tile's points and their 2-point ring in shared memory once:
// per point the 18 floats its taps read (depth, the normal, il0, il1, and
// per instance the colour and variance already cleaned by their masks,
// as the plain version's `clean`, and the two masks), zero outside the
// image, in 5 float4 (20 floats: 80 bytes a point, so the 8 lanes of a
// 128-bit shared load hit distinct banks).  A staged row lays the k
// cosets' points side by side, so the staging loads read k neighbouring
// pixels of a row (the whole row segment for s <= 4, runs of 4 from
// s = 8: 8 cosets a tile measured slower, its ring twice the tile) and
// the tap loop reads neighbouring points for neighbouring lanes.  The tap loop then needs no bounds check and no 64-bit index;
// the 3x3 prefilter and the centre's own terms are read once per pixel
// from device memory.  One thread a pixel (two coset rows a thread, each
// staged point serving both, was slower on the H100: fewer resident warps).
// Every pixel keeps the plain version's term order (tj outer, ti inner),
// IEEE division, expf and pow_int's multiply chain (unrolled for the
// configured sigma_n = 128; powf for a non-integer sigma_n), so NaN and
// Inf travel as they do there.  Any stride takes the same tiles: above
// WT_KMAX a block still covers 4 column cosets (`groups` blocks across a
// tile), so the staged ring and the shared memory (46,080 bytes) are
// those of s = 4 at s = 16, 32 or 64.  One
// shortcut: an instance whose centre is dead (pen > 0) skips its taps, as
// its result is its raw value whatever they hold (den is 0, so every
// quotient is non-finite); a pixel with both dead (sky) skips the loop.
//
// What bounds it: bytes (23 planes in, 12 out: 0.29 GB at 1920x1080, 87 us
// at 3.35 TB/s).  The staging reads each staged point 1.7-2.9 times at
// 1080p, the ring the more the larger the stride
// (ops/svgf_kernels.py:wavelet_staged_bytes); the tap loop's shared-memory
// reads (25 x 80 bytes a pixel) and its IEEE divides and expf run after
// each block's staging, overlapped only across the blocks of an SM.
#define WT_X 32     // threads across x
#define WT_Y 8      // coset rows a block covers
#define WT_KMAX 4   // column cosets a block covers at most
#define WT_RING 2   // coset points of halo on every side

struct WavePixel {
  float depth, gx, gy, nx, ny, nz;
  float il[2], recip2[2];
  bool live[2];  // instance i's centre is not dead (pen <= 0 or NaN)
  float num_r[2], num_g[2], num_b[2], den_c[2], num_v[2], den_v[2];
};

// one tap (ti, tj) of pixel a from the staged point q[0..4]:
// q0 = (depth, nx, ny, nz), q1 = (il0, fc0, fv0, il1),
// q2 = (r0, g0, b0, v0), q3 = (fc1, fv1, r1, g1), q4 = (b1, v1, -, -)
template <int SN>
__device__ __forceinline__ void wavelet_tap(WavePixel& a, int ti, int tj, int stride,
                                            const float4* q, float sigma_n,
                                            float eps_z) {
  if (!a.live[0] && !a.live[1]) return;
  const int di = ti * stride, dj = tj * stride;
  const float4 q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3], q4 = q[4];
  float dd = a.gx * (float)di + a.gy * (float)dj;
  float t1 = fabsf(a.depth - q0.x) / fabsf(dd + eps_z);
  float ndot = a.nx * q0.y + a.ny * q0.z + a.nz * q0.w;
  float w_n = pow_n<SN>(nan_max(0.f, ndot), sigma_n);
  float hvn = wavelet_h(ti, tj) * w_n;
  const float il_q[2] = {q1.x, q1.w};
  const float fc[2] = {q1.y, q3.x}, fv[2] = {q1.z, q3.y};
  const float cr[2] = {q2.x, q3.z}, cg[2] = {q2.y, q3.w};
  const float cb[2] = {q2.z, q4.x}, vc[2] = {q2.w, q4.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!a.live[i]) continue;
    float t2 = fabsf(a.il[i] - il_q[i]) * a.recip2[i];
    float hw = hvn * expf(-(t1 + t2));
    float hc = hw * fc[i];
    float hv = hw * fv[i];
    a.num_r[i] = a.num_r[i] + hc * cr[i];
    a.num_g[i] = a.num_g[i] + hc * cg[i];
    a.num_b[i] = a.num_b[i] + hc * cb[i];
    a.den_c[i] = a.den_c[i] + hc;
    a.num_v[i] = a.num_v[i] + hv * hv * vc[i];
    a.den_v[i] = a.den_v[i] + hv;
  }
}

template <int SN>
__global__ void __launch_bounds__(WT_X * WT_Y)
wavelet_kernel(const float* __restrict__ geo, const float* __restrict__ cvin,
               int H, int W, int stride, float sigma_n, float sigma_l, float eps,
               float eps_z, float* __restrict__ cvout) {
  extern __shared__ float4 s_pts[];  // [row][col] points, 5 float4 each
  const int k = min(stride, WT_KMAX);
  const int groups = (stride + k - 1) / k;
  const int tx_cos = WT_X / k;  // coset columns per column coset
  const int cx0 = (blockIdx.x % groups) * k;
  const int X0 = (blockIdx.x / groups) * tx_cos;
  const int cy = blockIdx.y % stride;
  const int Y0 = (blockIdx.y / stride) * WT_Y;
  const int ncols = (tx_cos + 2 * WT_RING) * k;
  const int nrows = WT_Y + 2 * WT_RING;
  const size_t HW = (size_t)H * W;
  const int tid = threadIdx.y * WT_X + threadIdx.x;
  const int nthreads = WT_X * WT_Y;

  // stage the tile and its ring
  for (int i = tid; i < nrows * ncols; i += nthreads) {
    const int r = i / ncols, c = i - r * ncols;
    const int x = (X0 + c / k - WT_RING) * stride + cx0 + c % k;
    const int y = (Y0 + r - WT_RING) * stride + cy;
    float v[18];
#pragma unroll
    for (int j = 0; j < 18; ++j) v[j] = 0.f;
    if (x >= 0 && x < W && y >= 0 && y < H) {
      const size_t p = (size_t)y * W + x;
      const int gch[6] = {0, 3, 4, 5, 7, 8};  // depth, n, il0, il1
#pragma unroll
      for (int j = 0; j < 6; ++j) v[j] = __ldg(geo + gch[j] * HW + p);
#pragma unroll
      for (int inst = 0; inst < 2; ++inst) {
        const float* b = cvin + (size_t)(6 * inst) * HW + p;
        float fc = __ldg(b + 4 * HW), fv = __ldg(b + 5 * HW);
        float* o = v + 6 + 6 * inst;  // r g b v fc fv, cleaned
        o[0] = fc > 0.f ? __ldg(b) : 0.f;
        o[1] = fc > 0.f ? __ldg(b + HW) : 0.f;
        o[2] = fc > 0.f ? __ldg(b + 2 * HW) : 0.f;
        o[3] = fv > 0.f ? __ldg(b + 3 * HW) : 0.f;
        o[4] = fc;
        o[5] = fv;
      }
    }
    float4* d = s_pts + 5 * i;
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[10], v[11], v[5]);
    d[2] = make_float4(v[6], v[7], v[8], v[9]);
    d[3] = make_float4(v[16], v[17], v[12], v[13]);
    d[4] = make_float4(v[14], v[15], 0.f, 0.f);
  }
  __syncthreads();

  const int ph = threadIdx.x % k, xl = threadIdx.x / k;
  const int x = (X0 + xl) * stride + cx0 + ph;
  const bool col_ok = xl < tx_cos && cx0 + ph < stride && x < W;
  const int xs = min(xl, tx_cos - 1);  // idle lanes (32 % k != 0) read in bounds
  auto ld = [&](const float* base, int ch, int qy, int qx) -> float {
    bool in = qy >= 0 && qy < H && qx >= 0 && qx < W;
    return in ? __ldg(base + ch * HW + (size_t)qy * W + qx) : 0.f;
  };

  const int y = (Y0 + threadIdx.y) * stride + cy;
  const bool ok = col_ok && y < H;
  const size_t p = ok ? (size_t)y * W + x : 0;
  WavePixel a;
  {
    const float4* own = s_pts + 5 * ((threadIdx.y + WT_RING) * ncols + (xs + WT_RING) * k + ph);
    const float4 o0 = own[0], o1 = own[1];
    a.depth = o0.x;
    a.nx = o0.y;
    a.ny = o0.z;
    a.nz = o0.w;
    a.il[0] = o1.x;
    a.il[1] = o1.w;
  }
  a.gx = ok ? geo[HW + p] : 0.f;
  a.gy = ok ? geo[2 * HW + p] : 0.f;
  a.live[0] = ok && !(geo[9 * HW + p] > 0.f);
  a.live[1] = ok && !(geo[10 * HW + p] > 0.f);
  float gnum[2] = {0.f, 0.f}, gden = 0.f;
  if (ok) {
    for (int dj = -1; dj <= 1; ++dj) {
      for (int di = -1; di <= 1; ++di) {
        float g = gauss_g(di, dj);
        gnum[0] = gnum[0] + g * ld(cvin, 3, y + di, x + dj);
        gnum[1] = gnum[1] + g * ld(cvin, 9, y + di, x + dj);
        gden = gden + g * ld(geo, 6, y + di, x + dj);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a.recip2[i] = 1.f / (sigma_l * sqrtf(gnum[i] / gden) + eps);
    a.num_r[i] = a.num_g[i] = a.num_b[i] = 0.f;
    a.den_c[i] = a.num_v[i] = a.den_v[i] = 0.f;
  }

#pragma unroll
  for (int tj = -WT_RING; tj <= WT_RING; ++tj) {
#pragma unroll
    for (int ti = -WT_RING; ti <= WT_RING; ++ti) {
      const float4* q = s_pts + 5 * ((threadIdx.y + WT_RING + ti) * ncols +
                                     (xs + WT_RING + tj) * k + ph);
      float4 pt[5];
#pragma unroll
      for (int j = 0; j < 5; ++j) pt[j] = q[j];
      wavelet_tap<SN>(a, ti, tj, stride, pt, sigma_n, eps_z);
    }
  }

  if (!ok) return;
  for (int i = 0; i < 2; ++i) {
    int b = 6 * i;
    if (!a.live[i]) {  // a dead centre: den 0, so its raw value below
      a.den_c[i] = 0.f;
      a.den_v[i] = 0.f;
    }
    float oc[3] = {a.num_r[i] / a.den_c[i], a.num_g[i] / a.den_c[i],
                   a.num_b[i] / a.den_c[i]};
    bool valid_c = isfinite(oc[0]) && isfinite(oc[1]) && isfinite(oc[2]);
    float ov = a.num_v[i] / (a.den_v[i] * a.den_v[i]);
    bool valid_v = isfinite(ov);
    for (int c = 0; c < 3; ++c)
      cvout[(b + c) * HW + p] = valid_c ? oc[c] : cvin[(b + c) * HW + p];
    cvout[(b + 3) * HW + p] = valid_v ? ov : cvin[(b + 3) * HW + p];
    cvout[(b + 4) * HW + p] = valid_c ? 1.f : cvin[(b + 4) * HW + p];
    cvout[(b + 5) * HW + p] = valid_v ? 1.f : cvin[(b + 5) * HW + p];
  }
}

template <int SN>
int launch_wavelet(const float* geo, const float* cvin, int H, int W,
                   int stride, float sigma_n, float sigma_l, float eps,
                   float eps_z, float* cvout, cudaStream_t s) {
  const int k = min(stride, WT_KMAX);
  const int groups = (stride + k - 1) / k;
  const int tx_cos = WT_X / k;
  // coset columns / rows of the largest coset, in tiles
  const int tiles_x = ((W + stride - 1) / stride + tx_cos - 1) / tx_cos;
  const int tiles_y = ((H + stride - 1) / stride + WT_Y - 1) / WT_Y;
  const size_t smem = sizeof(float4) * 5 * (WT_Y + 2 * WT_RING) *
                      ((tx_cos + 2 * WT_RING) * k);
  cudaError_t e = cudaFuncSetAttribute(
      wavelet_kernel<SN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 block(WT_X, WT_Y);
  dim3 grid(tiles_x * groups, tiles_y * stride);
  wavelet_kernel<SN><<<grid, block, smem, s>>>(geo, cvin, H, W, stride, sigma_n,
                                               sigma_l, eps, eps_z, cvout);
  return (int)cudaGetLastError();
}

// an exponent pow_int's chain takes (ops/svgf.py:pow_sigma_n's rule,
// float(sigma_n).is_integer(), within int range)
bool is_int_exponent(float sn) {
  return sn == floorf(sn) && fabsf(sn) < 2147483648.f;
}

}  // namespace

extern "C" int lprt_coef_fetch(const float* hist, const float* rw, int C,
                               int H, int W, int my, int mx, float* out,
                               void* stream) {
  if (C < 0 || C > LPRT_MAX_FETCH_C) return (int)cudaErrorInvalidValue;
  if (H < 1 || W < 1) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  // the main path's 10 history channels unrolled; any other count at run time
  if (C == 10) return launch_coef_fetch<10>(hist, rw, C, H, W, my, mx, out, s);
  return launch_coef_fetch<0>(hist, rw, C, H, W, my, mx, out, s);
}

extern "C" int lprt_temporal(const float* col6, const float* geo7,
                             const float* ctr11, int H, int W, float color_w,
                             float moments_w, float below, float sigma_n,
                             float eps_z, float* cv, float* ext, float* mst,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  // the configured sigma_n (128) with pow_int's chain unrolled; any other
  // integer exponent runs the loop, a non-integer one powf
  if (sigma_n == 128.f)
    return launch_temporal<128>(col6, geo7, ctr11, H, W, color_w, moments_w, below, sigma_n,
                                eps_z, cv, ext, mst, s);
  if (!is_int_exponent(sigma_n))
    return launch_temporal<-2>(col6, geo7, ctr11, H, W, color_w, moments_w, below, sigma_n,
                               eps_z, cv, ext, mst, s);
  return launch_temporal<-1>(col6, geo7, ctr11, H, W, color_w, moments_w, below, sigma_n,
                             eps_z, cv, ext, mst, s);
}

extern "C" int lprt_wavelet(const float* geo, const float* cvin, int H, int W,
                            int stride, float sigma_n, float sigma_l, float eps,
                            float eps_z, float* cvout, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (stride < 1) return (int)cudaErrorInvalidValue;
  // the configured sigma_n (128) with pow_int's chain unrolled; any other
  // integer exponent runs the loop, a non-integer one powf
  if (sigma_n == 128.f)
    return launch_wavelet<128>(geo, cvin, H, W, stride, sigma_n, sigma_l, eps, eps_z, cvout, s);
  if (!is_int_exponent(sigma_n))
    return launch_wavelet<-2>(geo, cvin, H, W, stride, sigma_n, sigma_l, eps, eps_z, cvout, s);
  return launch_wavelet<-1>(geo, cvin, H, W, stride, sigma_n, sigma_l, eps, eps_z, cvout, s);
}
