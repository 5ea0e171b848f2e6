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
// Both kernels are persistent: a grid of as many blocks as fit on the
// card, each loading its chunks' table into shared memory once, with the
// bulk-copy engine behind an mbarrier (cp.async.bulk), and then walking
// many ray groups.  A launch takes the chunks that fit in shared memory;
// the wrapper launches again for the next chunks, and a later launch
// starts from the winners the earlier one wrote (`first` = 0).
//
// vpu: the table is TI rows of 24 floats [n_dt (bf16 values) 9 | n_f32 9 |
// e 3 | 0 0 0], read by 16-byte broadcast loads; a thread takes VPU_RAYS
// rays, so that one row's loads serve all of them.  Every expression keeps
// the plain version's order, the winner update is branch-free, and the
// source builds with --fmad=false: equal to the plain version bit for bit.
// Bound: operations, 142 f32 operations per (ray, row), with no FMA to
// contract them into.
//
// mxu: the K = 16 product of the bf16 table Aab (8 blocks [Ox Oy Dx Dy Sox
// Soy Sdx Sdy] of TC rows) against the ray rounded to bf16 ([o 1 d 0 | |o|
// 1 |d| 0]) runs on the tensor cores with wgmma.mma_async m64n64k16: the
// rays are the M side (a warpgroup's tile of 64 rays; its A operand, the
// rays' features, sits in registers for the tile's whole life), the table
// the N side, 64 columns = the 8 blocks of one 8-row slice of a chunk (B
// from shared memory, K-major, no swizzle: core matrices of 8 columns x 16
// bytes, LBO = 128 bytes to the next 8 K values, SBO = 256 bytes to the
// next block).  Every block is one 8-column group of the accumulator, so
// each thread holds all 8 blocks of its 4 (ray, row) pairs: rays g, g + 8
// of its warp's 16, rows 2q, 2q + 1 of the slice (g = lane / 4, q = lane %
// 4).  The table rows are the M side in the TPU kernel; here the rays are,
// so that a chunk of any multiple of 8 rows fills the product with no dead
// rows, and a ray's rows fall in the 4 lanes of one quad (two shuffles
// reduce its winner).
// The K = 8 f32 product (Oz, Dz, Ox32, Oy32, Dx32, Dy32 against [o 1 d 0])
// stays on the CUDA cores: no split of it onto the tensor cores can meet
// the body's bar (tools/mxu_proto.py), since even the correctly rounded
// product differs from the plain version's in-order f32 sums by more than
// the bar on a few rays a launch.  It runs in the plain version's order on
// the terms the A32 layout does not zero (33 operations a pair; the layout
// is build_tables', tools/mxu_proto.py:check_a32_layout), from 24 floats a
// row read by 16-byte loads once a row
// for the thread's two rays, and so equals the plain version's bit for bit.
// The tensor cores' accumulation order is not the plain version's, so this
// body is held to its plain version by a bar, not bit for bit.  Bound: the
// f32 operations on the CUDA cores (98 per (ray, row)); the tensor-core
// product is 256 bf16 operations at 15x their rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float D12 = 0.0390625f;  // 2^-7 + 2^-5
constexpr float D1F = 0.0078125f;  // 2^-7
constexpr float NEG = -3e38f;

// The running winner of one chunk, and its fold across rows and lanes: the
// least t, the largest u and v at that t.  Branch-free.
struct Win {
  float t = INFINITY, u = NEG, v = NEG;

  __device__ __forceinline__ void add(bool ok, float t_, float u_, float v_) {
    const bool lt = ok && t_ < t, eq = ok && t_ == t;
    u = lt ? u_ : (eq ? fmaxf(u, u_) : u);
    v = lt ? v_ : (eq ? fmaxf(v, v_) : v);
    t = lt ? t_ : t;
  }
};

// The winners across chunks: a strictly smaller t wins.
struct Best {
  float t = 1e5f, u = 0.f, v = 0.f;

  __device__ __forceinline__ void fold(const Win& w) {
    const bool better = isfinite(w.t) && w.t < t;
    t = better ? w.t : t;
    u = better ? w.u : u;
    v = better ? w.v : v;
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
// the table's load: global -> shared by the bulk-copy engine, once a block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

constexpr uint32_t PIECE = 32768;  // bytes a bulk copy

// Copies `n` regions (dst, src, bytes: multiples of 16, 16-byte aligned)
// into shared memory and waits for all of them on `bar`.  Every thread of
// the block calls it.
__device__ __forceinline__ void load_shared(int n, void* const* dst, const void* const* src,
                                            const uint32_t* bytes, uint64_t* bar) {
  const uint32_t b = smem_u32(bar);
  if (threadIdx.x == 0) {
    uint32_t total = 0;
    for (int i = 0; i < n; ++i) total += bytes[i];
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                 "r"(total)
                 : "memory");
    for (int i = 0; i < n; ++i)
      for (uint32_t off = 0; off < bytes[i]; off += PIECE) {
        const uint32_t len = bytes[i] - off < PIECE ? bytes[i] - off : PIECE;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(static_cast<char*>(dst[i]) + off)),
            "l"(static_cast<const char*>(src[i]) + off), "r"(len), "r"(b)
            : "memory");
      }
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
}

// The persistent grid: as many blocks as fit on the card at once, no more
// than there is work for.
template <typename K>
int persistent_grid(K kernel, int threads, size_t smem, int work_blocks, int* grid) {
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = work_blocks < nsm * per_sm ? work_blocks : nsm * per_sm;
  return 0;
}

constexpr size_t SMEM_MAX = 227 * 1024 - 1024;  // dynamic shared memory a block may take

// ---------------------------------------------------------------------------
// vpu

constexpr int VPU_THREADS = 256;
constexpr int VPU_RAYS = 4;  // rays a thread
constexpr int VPU_ROW = 24;  // floats a table row

__global__ void __launch_bounds__(VPU_THREADS)
    vpu_kernel(const float* __restrict__ table, const float* __restrict__ o,
               const float* __restrict__ d, int R, int NC, int TC, int first,
               float* __restrict__ t_out, float* __restrict__ u_out,
               float* __restrict__ v_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  {
    void* dst[1] = {smem};
    const void* src[1] = {table};
    const uint32_t bytes[1] = {(uint32_t)(NC * TC * VPU_ROW * 4)};
    load_shared(1, dst, src, bytes, &bar);
  }
  const float4* s_tab = reinterpret_cast<const float4*>(smem);
  constexpr int GROUP = VPU_THREADS * VPU_RAYS;
  for (int base = blockIdx.x * GROUP; base < R; base += gridDim.x * GROUP) {
    float ox[VPU_RAYS], oy[VPU_RAYS], oz[VPU_RAYS], dx[VPU_RAYS], dy[VPU_RAYS], dz[VPU_RAYS];
    Best best[VPU_RAYS];
#pragma unroll
    for (int i = 0; i < VPU_RAYS; ++i) {
      const int r = base + i * VPU_THREADS + threadIdx.x;
      const bool in = r < R;
      ox[i] = in ? o[r] : 0.f;
      oy[i] = in ? o[R + r] : 0.f;
      oz[i] = in ? o[2 * R + r] : 0.f;
      dx[i] = in ? d[r] : 0.f;
      dy[i] = in ? d[R + r] : 0.f;
      dz[i] = in ? d[2 * R + r] : 0.f;
      if (in && !first) best[i] = Best{t_out[r], u_out[r], v_out[r]};
    }
    for (int c0 = 0; c0 < NC * TC; c0 += TC) {
      Win win[VPU_RAYS];
#pragma unroll 1
      for (int k = c0; k < c0 + TC; ++k) {
        const float4* row = s_tab + (VPU_ROW / 4) * k;
        const float4 r0 = row[0], r1 = row[1], r2 = row[2], r3 = row[3], r4 = row[4];
        const float e2 = reinterpret_cast<const float*>(row + 5)[0];
        // n_dt 0..5 = a[], n_f32 0..8 = b[], e 0..2
        const float a[6] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y};
        const float b[9] = {r2.y, r2.z, r2.w, r3.x, r3.y, r3.z, r3.w, r4.x, r4.y};
        const float e[3] = {r4.z, r4.w, e2};
#pragma unroll
        for (int i = 0; i < VPU_RAYS; ++i) {
          const float aox = fabsf(ox[i]), aoy = fabsf(oy[i]), aoz = fabsf(oz[i]);
          const float adx = fabsf(dx[i]), ady = fabsf(dy[i]), adz = fabsf(dz[i]);
          float Ox = a[0] * ox[i] + a[1] * oy[i] + a[2] * oz[i] + e[0];
          float Dx = a[0] * dx[i] + a[1] * dy[i] + a[2] * dz[i];
          float Oy = a[3] * ox[i] + a[4] * oy[i] + a[5] * oz[i] + e[1];
          float Dy = a[3] * dx[i] + a[4] * dy[i] + a[5] * dz[i];
          float Oz = b[6] * ox[i] + b[7] * oy[i] + b[8] * oz[i] + e[2];
          float Dz = b[6] * dx[i] + b[7] * dy[i] + b[8] * dz[i];
          float s_ox = fabsf(a[0]) * aox + fabsf(a[1]) * aoy + fabsf(a[2]) * aoz + fabsf(e[0]);
          float s_dx = fabsf(a[0]) * adx + fabsf(a[1]) * ady + fabsf(a[2]) * adz;
          float s_oy = fabsf(a[3]) * aox + fabsf(a[4]) * aoy + fabsf(a[5]) * aoz + fabsf(e[1]);
          float s_dy = fabsf(a[3]) * adx + fabsf(a[4]) * ady + fabsf(a[5]) * adz;
          float Ox32 = b[0] * ox[i] + b[1] * oy[i] + b[2] * oz[i] + e[0];
          float Dx32 = b[0] * dx[i] + b[1] * dy[i] + b[2] * dz[i];
          float Oy32 = b[3] * ox[i] + b[4] * oy[i] + b[5] * oz[i] + e[1];
          float Dy32 = b[3] * dx[i] + b[4] * dy[i] + b[5] * dz[i];
          float t, u, v;
          const bool ok = tail(Oz, Dz, Ox, Oy, Dx, Dy, s_ox, s_oy, s_dx, s_dy, Ox32, Oy32,
                               Dx32, Dy32, t, u, v);
          win[i].add(ok, t, u, v);
        }
      }
#pragma unroll
      for (int i = 0; i < VPU_RAYS; ++i) best[i].fold(win[i]);
    }
#pragma unroll
    for (int i = 0; i < VPU_RAYS; ++i) {
      const int r = base + i * VPU_THREADS + threadIdx.x;
      if (r < R) {
        t_out[r] = best[i].t;
        u_out[r] = best[i].u;
        v_out[r] = best[i].v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// mxu

constexpr int MXU_WG = 4;  // warpgroups a block, one block an SM
constexpr int MXU_THREADS = 128 * MXU_WG;
constexpr int TILE = 64;                   // rays a warpgroup tile (wgmma's M)
constexpr int SLICE = 8;                   // table rows a product (N = 8 blocks x 8 rows)
constexpr int SLICE_BYTES = 8 * 2 * SLICE * 16;  // Aab bytes of a slice: 2048
constexpr int F_ROW = 24;                  // floats a row of the f32 product's table
constexpr uint64_t LBO = 128, SBO = 256;   // bytes: the next 8 K values, the next block

// The wgmma descriptor of one slice's B operand at shared address `addr`
// (K-major, no swizzle).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((LBO >> 4) << 16) | ((SBO >> 4) << 32);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat16 a = __float2bfloat16_rn(lo), b = __float2bfloat16_rn(hi);
  return (uint32_t)__bfloat16_as_ushort(a) | ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// d = A B over one slice: A (64 rays x 16) from registers, B (16 x 64) at
// `desc`; the accumulator is overwritten (scale-d = 0).
__device__ __forceinline__ void wgmma_slice(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

// Keeps the compiler from moving reads of the accumulator above the wait.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// PROBE: instead of the tail, write every block value of every (ray, row)
// to probe[((c R + ray) 8 + block) TC + row] (the fragment-layout check).
template <bool PROBE>
__global__ void __launch_bounds__(MXU_THREADS, 1)
    mxu_kernel(const __nv_bfloat16* __restrict__ tab_ab, const float* __restrict__ tab_f,
               const float* __restrict__ o, const float* __restrict__ d, int R, int NC,
               int TC, int first, float* __restrict__ t_out, float* __restrict__ u_out,
               float* __restrict__ v_out, float* __restrict__ probe) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int nsl = TC / SLICE;
  const uint32_t ab_bytes = (uint32_t)(NC * nsl * SLICE_BYTES);
  const float* s_f = reinterpret_cast<const float*>(smem + ab_bytes);
  {
    void* dst[2] = {smem, smem + ab_bytes};
    const void* src[2] = {tab_ab, tab_f};
    const uint32_t bytes[2] = {ab_bytes, (uint32_t)(NC * TC * F_ROW * 4)};
    load_shared(2, dst, src, bytes, &bar);
  }
  const uint32_t ab0 = smem_u32(smem);

  const int tid = threadIdx.x & 127, wg = threadIdx.x >> 7;
  const int lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int ntiles = (R + TILE - 1) / TILE;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int tile = blockIdx.x * MXU_WG + wg; tile < ntiles; tile += gridDim.x * MXU_WG) {
    // the thread's rays: 16 w + g and 16 w + g + 8 of the tile (h = 0, 1)
    const int r0 = tile * TILE + (tid >> 5) * 16 + g;
    int rid[2] = {r0, r0 + 8};
    float ox[2], oy[2], oz[2], dx[2], dy[2], dz[2];
    uint32_t a[4];
    Best best[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rid[h];
      const bool in = r < R;
      ox[h] = in ? o[r] : 0.f;
      oy[h] = in ? o[R + r] : 0.f;
      oz[h] = in ? o[2 * R + r] : 0.f;
      dx[h] = in ? d[r] : 0.f;
      dy[h] = in ? d[R + r] : 0.f;
      dz[h] = in ? d[2 * R + r] : 0.f;
      if (!PROBE && in && !first) best[h] = Best{t_out[r], u_out[r], v_out[r]};
      // the A fragment: features 2q, 2q + 1 (register h) and 2q + 8, 2q + 9
      // (register 2 + h) of [o 1 d 0 | |o| 1 |d| 0]
      const float lo = q == 0 ? ox[h] : q == 1 ? oz[h] : q == 2 ? dx[h] : dz[h];
      const float hi = q == 0 ? oy[h] : q == 1 ? 1.f : q == 2 ? dy[h] : 0.f;
      a[h] = pack_bf16(lo, hi);
      a[2 + h] = pack_bf16(fabsf(lo), fabsf(hi));
    }

    for (int c = 0; c < NC; ++c) {
      Win win[2];
#pragma unroll 1
      for (int s = 0; s < nsl; ++s) {
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_slice(acc, a, b_desc(ab0 + (uint32_t)((c * nsl + s) * SLICE_BYTES)));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(acc);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = s * SLICE + 2 * q + rr;  // in the chunk
          if (PROBE) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (rid[h] < R)
#pragma unroll
                for (int b = 0; b < 8; ++b)
                  probe[(((size_t)c * R + rid[h]) * 8 + b) * TC + row] = acc[4 * b + 2 * h + rr];
            continue;
          }
          // the f32 product's row: [Oz k0-3 | Dz k4-7 | Ox32 | Dx32 | Oy32 | Dy32]
          const float4* fr = reinterpret_cast<const float4*>(s_f + (c * TC + row) * F_ROW);
          const float4 z0 = fr[0], z1 = fr[1], x0 = fr[2], x1 = fr[3], y0 = fr[4], y1 = fr[5];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // [o 1 d 0] in the plain version's order; the zero terms add nothing
            const float Oz = z0.x * ox[h] + z0.y * oy[h] + z0.z * oz[h] + z0.w;
            const float Dz = z1.x * dx[h] + z1.y * dy[h] + z1.z * dz[h];
            const float Ox32 = x0.x * ox[h] + x0.y * oy[h] + x0.z * oz[h] + x0.w;
            const float Dx32 = x1.x * dx[h] + x1.y * dy[h] + x1.z * dz[h];
            const float Oy32 = y0.x * ox[h] + y0.y * oy[h] + y0.z * oz[h] + y0.w;
            const float Dy32 = y1.x * dx[h] + y1.y * dy[h] + y1.z * dz[h];
            const int j = 2 * h + rr;  // block b of this pair: acc[4 b + j]
            float t, u, v;
            const bool ok = tail(Oz, Dz, acc[j], acc[4 + j], acc[8 + j], acc[12 + j],
                                 acc[16 + j], acc[20 + j], acc[24 + j], acc[28 + j], Ox32,
                                 Oy32, Dx32, Dy32, t, u, v);
            win[h].add(ok, t, u, v);
          }
        }
      }
      if (PROBE) continue;
      // the chunk's winner per ray: fold across the quad's 4 lanes
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        Win& w = win[h];
#pragma unroll
        for (int m = 1; m < 4; m <<= 1) {
          const float t2 = __shfl_xor_sync(0xffffffffu, w.t, m);
          const float u2 = __shfl_xor_sync(0xffffffffu, w.u, m);
          const float v2 = __shfl_xor_sync(0xffffffffu, w.v, m);
          w.add(isfinite(t2), t2, u2, v2);
        }
        best[h].fold(w);
      }
    }
    if (PROBE || q != 0) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (rid[h] < R) {
        t_out[rid[h]] = best[h].t;
        u_out[rid[h]] = best[h].u;
        v_out[rid[h]] = best[h].v;
      }
  }
}

// Chunks of TC rows one launch of a body takes (body 0: vpu, 1: mxu): as
// many as fit in SMEM_MAX; 0 where TC is unsupported.
int chunks_a_launch(int body, int TC) {
  size_t row = 0;
  if (body == 0 && TC >= 1) row = VPU_ROW * sizeof(float);
  if (body == 1 && TC >= SLICE && TC % SLICE == 0) row = SLICE_BYTES / SLICE + F_ROW * 4;
  return row ? (int)(SMEM_MAX / (row * TC)) : 0;
}

template <bool PROBE>
int launch_mxu(const void* tab_ab, const float* tab_f, const float* o, const float* d, int R,
               int NC, int TC, int first, float* t_out, float* u_out, float* v_out,
               float* probe, void* stream) {
  if (NC < 1 || NC > chunks_a_launch(1, TC)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)NC * TC * (SLICE_BYTES / SLICE + F_ROW * 4);
  const int tiles = (R + TILE - 1) / TILE;
  if (tiles == 0) return 0;
  int grid = 0;
  const int code = persistent_grid(mxu_kernel<PROBE>, MXU_THREADS, smem,
                                   (tiles + MXU_WG - 1) / MXU_WG, &grid);
  if (code) return code;
  mxu_kernel<PROBE><<<grid, MXU_THREADS, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(tab_ab), tab_f, o, d, R, NC, TC, first, t_out,
      u_out, v_out, probe);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lprt_mxu_proto_vpu(const float* table, const float* o, const float* d, int R,
                                  int NC, int TC, int first, float* t_out, float* u_out,
                                  float* v_out, void* stream) {
  if (NC < 1 || NC > chunks_a_launch(0, TC)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)NC * TC * VPU_ROW * sizeof(float);
  constexpr int GROUP = VPU_THREADS * VPU_RAYS;
  const int groups = (R + GROUP - 1) / GROUP;
  if (groups == 0) return 0;
  int grid = 0;
  const int code = persistent_grid(vpu_kernel, VPU_THREADS, smem, groups, &grid);
  if (code) return code;
  vpu_kernel<<<grid, VPU_THREADS, smem, (cudaStream_t)stream>>>(table, o, d, R, NC, TC, first,
                                                                t_out, u_out, v_out);
  return (int)cudaGetLastError();
}

extern "C" int lprt_mxu_proto_mxu(const void* tab_ab, const float* tab_f, const float* o,
                                  const float* d, int R, int NC, int TC, int first,
                                  float* t_out, float* u_out, float* v_out, void* stream) {
  return launch_mxu<false>(tab_ab, tab_f, o, d, R, NC, TC, first, t_out, u_out, v_out,
                           nullptr, stream);
}

extern "C" int lprt_mxu_proto_probe(const void* tab_ab, const float* tab_f, const float* o,
                                    const float* d, int R, int NC, int TC, float* probe,
                                    void* stream) {
  return launch_mxu<true>(tab_ab, tab_f, o, d, R, NC, TC, 1, nullptr, nullptr, nullptr, probe,
                          stream);
}

extern "C" int lprt_mxu_proto_chunks(int body, int TC) { return chunks_a_launch(body, TC); }

// The tables' layout as the kernels read it: floats a VPU row, rows a
// slice, bf16 bytes a row, floats an f32 row, the descriptor's LBO and SBO.
extern "C" int lprt_mxu_proto_layout(int* out) {
  const int v[6] = {VPU_ROW, SLICE, SLICE_BYTES / SLICE, F_ROW, (int)LBO, (int)SBO};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}
