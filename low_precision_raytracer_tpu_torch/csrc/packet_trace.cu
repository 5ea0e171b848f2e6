// Packet BVH trace (K6): closest hit or any hit over a table of any size.
//
// Replaces the TPU kernel ops/traversal_pallas.py:_kernel (every fallback:
// 'mxu3', and 'both' / 'dtype' with the packet kernel's own error band in
// fp32, bf16 and fp16, :256-311 and :365-397, whose sub-f32 rows and ray
// operand are in the render dtype; the leaf walk at :188-426), reached through trace_rays_packet and
// trace_rays_packet_sorted.  Plain version: ops/dense_trace.py:
// dense_trace_multi_plain with the packet band (the leaves only prune, so
// the function is K1b's; see ops/packet_trace.py).
//
// What it computes, per ray: the M-shift test against the instance
// triangles of the coefficient table (rows n[0..8] | e[0..2], as in K1b),
// a hit also needing mind < t < maxd, tri != skip and a finite t.  Closest
// hit: the (t, tri, row)-lexicographic minimum, t = 1e5 / ids -1 on a
// miss.  Any hit: tri = 0 if some triangle accepts, else -1; t = 1e5,
// u = v = 0, obj = -1 either way.
//
// Design: one thread per ray, an ordered depth-first walk of an implicit
// 4-ary tree with a per-thread stack (trace_common.cuh:tree_trace_kernel).
// Level 0 is the leaves (32 consecutive rows of the morton-ordered table
// each, with their widened world AABBs); node i of level l + 1 is the union
// of nodes 4i .. 4i + 3 of level l (ops/packet_trace.py:build_tree), up to
// one root.  Children are pushed farthest entry first, nodes beyond the best
// t skipped, ties by (t, tri, row), any hit stopping at its first accepted
// row: the result equals the plain version's global minimum bit for bit.
//
// What bounds it on the H100: operations, by the data — per live ray a slab
// test (34 ops) per box it enters before its hit and ~40 f32 operations per
// row of each leaf it tests (~60 more in a band).  The table (48 B/row,
// 98 MB at 2M rows; 112 B/row with a sub-f32 form's band rows) is read through the read-only cache; neighbouring rays
// (screen order, or the morton sort of incoherent launches) share leaves.
// None of the TPU kernel's packet scheduling (512-ray packets sharing a leaf
// list, the list rows and their SMEM pipeline, 7-bit quantised bounds, the
// overflow walk, GSZ grouping for the MXU, the streamed table, screen
// tiling) has a counterpart here.  Built with --fmad=false so the test
// rounds like its plain version.

#include "trace_common.cuh"

#define LPRT_LEAF 32

extern "C" int lprt_packet_trace(const float* orig, const float* dir,
                                 const int* skip, const float* mind,
                                 const float* maxd, const float* coef,
                                 const int* tri_id, const int* obj_id,
                                 const float* boxes, const int* levels,
                                 int n_levels, int R, int TI, int find_any,
                                 int pack, int form, float k0, float k1, float k2,
                                 float* t_out, float* u_out, float* v_out,
                                 int* tri_out, int* obj_out, int* status,
                                 void* stream) {
  return lprt::launch_tree_trace<LPRT_LEAF, false>(
      orig, dir, skip, mind, maxd, coef, tri_id, obj_id, boxes, levels,
      n_levels, R, TI, find_any, pack, form, k0, k1, k2, t_out, u_out, v_out,
      tri_out, obj_out, status, stream);
}
