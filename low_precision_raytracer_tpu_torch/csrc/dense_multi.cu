// Dense trace over a multi-chunk table (K1b): closest hit or any hit.
//
// Replaces the TPU kernel ops/dense_pallas.py:_kernel in its multi-chunk
// mode (every fallback: 'mxu3', and 'both' / 'dtype' with the dense error
// band in fp32, bf16 and fp16, :369-421: the w_cond/w_body walk at :526-610
// with the epilogues _finish_chunk :60-101, _finish_chunk_any :104-127 and,
// under dense_epilogue='pack', _finish_chunk_packed :130-180), reached
// through trace_rays_dense_pallas and trace_rays_dense_pallas_sorted.
// Plain version: ops/dense_trace.py:dense_trace_multi_plain.
//
// What it computes, per ray: the M-shift test against the instance
// triangles of the coefficient table, accepted by the band (strict under
// 'mxu3', else the dense kernel's error band), a hit also needing
// mind < t < maxd, tri != skip and a finite t.  Closest hit: the (t, tri,
// row)-lexicographic minimum, t = 1e5 / ids -1 on a miss.  Any hit: tri = 0
// if some triangle accepts, else -1; t = 1e5, u = v = 0, obj = -1 either
// way.  Under pack (closest hit; 'mxu3' and the sub-f32 dense bands,
// LPRT_PACK_FORMS) each 128-row chunk is a chunk of the packed epilogue:
// the least key (bits(t) & ~127) | local row wins the chunk, across chunks
// the least (t, row); out t, the winner's table row and its 15-bit u/v
// (trace_common.cuh:PackedBest), written into t_out, tri_out, obj_out.
//
// Design: the warp walk of chunk_walk.cuh, shared with K6, its boxes
// tested by box_entry.  The rows come in 128-row chunks with one world AABB
// each (recentred like the rays) under a 4-ary tree over the chunk boxes
// (ops/dense_trace.py:build_tree); each chunk also has the AABBs of its
// four 32-row slices (the packet route's leaf boxes), which the walk culls
// one by one; the table is re-laid for coalesced row loads
// (ops/dense_trace.py:lane_table).  Under a widened acceptance (the
// sub-f32 bands, and 'dtype') the walk grows every box for the ray that
// tests it by the band's proven reach (ops/band_pad.py; the proof is in
// chunk_walk.cuh), and is otherwise the same.  The wrapper
// persists in any hit, whose rays end at very different depths; in closest
// hit the lanes keep their neighbouring rays, which share chunks (on the
// H100 each choice was the faster for its kind).
//
// lprt_band_scan: the all-row scan of a widened form
// (trace_common.cuh:scan_trace_kernel), every form and the packed one; the
// card's reference for the walk under a band, reached by no render path.
//
// The TPU kernel's tile schedule (screen blocks, per-tile chunk lists with
// packed entry words, t_cut and the overflow sweep, the scene-exit cap,
// HBM streaming) exists to feed 512-lane tiles from VMEM; a warp walk needs
// none of it.  Under 'mxu3' the TPU computes u/v/t through a bf16x3 MXU
// product (~2^-16 relative), in fp32 through an f32 dot that sums in
// another order; here they are plain f32, so the two agree to that
// accuracy, not bitwise (cross-chunk exact ties also go by walk order
// there).
//
// What bounds it on the H100: operations, by the data.  Per live ray one
// slab test (34 ops) per tree box and slice box it enters before its hit,
// and ~40 f32 operations per row of every slice it tests (~60 more in a
// band).  Built with --fmad=false so the test rounds like its plain
// version.

#include "chunk_walk.cuh"

// lanes: the table re-laid for the walk (ops/dense_trace.py:lane_table),
// slices: the 32-row slice boxes (4 per chunk), box_pads / slice_pads /
// ray_pads: a widened form's pads (chunk_walk.cuh:WalkPads; null in the
// other forms), stack_cap: the walk's stack entries, persist: resident
// blocks pulling rays from status[1].
extern "C" int lprt_dense_multi(const float* orig, const float* dir,
                                const int* skip, const float* mind,
                                const float* maxd, const int* tri_id,
                                const int* obj_id, const float* boxes,
                                const int* levels, const float* lanes,
                                const float* slices, const float* box_pads,
                                const float* slice_pads, const float* ray_pads,
                                int n_levels, int R, int TI,
                                int find_any, int pack, int form, int stack_cap,
                                int persist, float k0, float k1, float k2,
                                float* t_out, float* u_out, float* v_out,
                                int* tri_out, int* obj_out, int* status,
                                void* stream) {
  return lprt::walk::launch_walk_forms<true, false>(
      orig, dir, skip, mind, maxd, lanes, tri_id, obj_id, boxes, slices, levels, box_pads,
      slice_pads, ray_pads, n_levels, R, TI,
      find_any, pack, form, stack_cap, persist, k0, k1, k2, t_out, u_out, v_out, tri_out,
      obj_out, status, stream);
}

// coef: the (TI, LPRT_ROW(form)) table in row order.
extern "C" int lprt_band_scan(const float* orig, const float* dir, const int* skip,
                              const float* mind, const float* maxd, const float* coef,
                              const int* tri_id, const int* obj_id, int R, int TI,
                              int find_any, int pack, int form, float k0, float k1,
                              float k2, float* t_out, float* u_out, float* v_out,
                              int* tri_out, int* obj_out, void* stream) {
  return lprt::launch_scan_trace<true>(orig, dir, skip, mind, maxd, coef, tri_id, obj_id, R, TI,
                                       find_any, pack, form, k0, k1, k2, t_out, u_out, v_out,
                                       tri_out, obj_out, stream);
}
