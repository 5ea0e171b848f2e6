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
// Design, for the forms whose acceptance stays inside the triangle ('mxu3'
// and the f32 'both' band): the warp walk of chunk_walk.cuh, K1b's.  The
// packet BVH is an implicit 4-ary tree over the morton-ordered 32-row leaves
// (ops/dense_trace.py:build_tree), so its level-1 nodes are exactly the
// 128-row chunks of 4 leaves: the walk takes levels 1.. as its chunk tree
// and the leaves as its slices (ops/packet_trace.py:walk_view), with the
// table re-laid for coalesced row loads (lane_table).  Each lane walks its
// ray's tree nearest entry first with its stack in shared memory; the warp
// tests each waiting ray's leaves with one row a lane and merges the
// accepting lanes in (t, tri, row) order; an any-hit ray leaves at its first
// accepted row.  The boxes are tested by box_entry_exact0: on a zero
// direction axis the origin must lie inside the box (with a margin), where
// box_entry let such a ray enter every box its other slabs cross (the
// colonnade's sun rays, d_x = 0, entered over 1,500 leaves a ray).  Under a
// widened acceptance (the sub-f32 bands, 'dtype') the walk grows every box
// for the ray that tests it by the band's proven reach (ops/band_pad.py;
// the proof, the zero-axis rule's case too, is in chunk_walk.cuh).  The result
// equals the plain version's global minimum bit for bit.
//
// What bounds it on the H100: operations, by the data: per live ray a slab
// test (34 ops) per box it enters before its hit and ~40 f32 operations per
// row of each leaf it tests (~60 more in a band).  The table (48 B/row, 98
// MB at 2M rows; 112 B/row with a sub-f32 form's band rows) is read through
// the read-only cache; neighbouring rays (screen order, or the morton sort
// of incoherent launches) share leaves.  None of the TPU kernel's packet
// scheduling (512-ray packets sharing a leaf list, the list rows and their
// SMEM pipeline, 7-bit quantised bounds, the overflow walk, GSZ grouping for
// the MXU, the streamed table, screen tiling) has a counterpart here.  Built
// with --fmad=false so the test rounds like its plain version.

#include "chunk_walk.cuh"

// boxes / levels / n_levels: the chunk tree (the packet tree's levels 1..),
// slices: the 32-row leaf boxes, lanes: lane_table(coef), box_pads /
// slice_pads / ray_pads: a widened form's pads (chunk_walk.cuh:WalkPads;
// null in the other forms), stack_cap: the walk's stack entries, persist:
// resident blocks pulling rays from status[1].
extern "C" int lprt_packet_trace(const float* orig, const float* dir,
                                 const int* skip, const float* mind,
                                 const float* maxd, const int* tri_id,
                                 const int* obj_id, const float* boxes,
                                 const int* levels, const float* lanes,
                                 const float* slices, const float* box_pads,
                                 const float* slice_pads, const float* ray_pads,
                                 int n_levels, int R, int TI,
                                 int find_any, int form, int stack_cap, int persist,
                                 float k0, float k1, float k2,
                                 float* t_out, float* u_out, float* v_out,
                                 int* tri_out, int* obj_out, int* status,
                                 void* stream) {
  return lprt::walk::launch_walk_forms<false, true>(
      orig, dir, skip, mind, maxd, lanes, tri_id, obj_id, boxes, slices, levels, box_pads,
      slice_pads, ray_pads, n_levels, R, TI,
      find_any, 0, form, stack_cap, persist, k0, k1, k2, t_out, u_out, v_out, tri_out, obj_out,
      status, stream);
}
