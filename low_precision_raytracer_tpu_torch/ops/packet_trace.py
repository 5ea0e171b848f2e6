"""Packet BVH trace, K6 (port of `low_precision_raytracer_tpu/ops/traversal_pallas.py`:
`trace_rays_packet` and `trace_rays_packet_sorted`, every `fallback`:
'mxu3', and 'both' / 'dtype' with the packet kernel's own error band,
`dense_trace.packet_band`, whose sub-f32 rows and ray operand are in the
render dtype itself).

What it computes, per ray: the closest accepted hit of the M-shift test
over the rows of the coefficient table (t from the f32 rows, u and v
accepted by the band: strict u > 0, v > 0, u + v < 1 under 'mxu3'; then
mind < t < maxd,
tri != skip, t finite) as (t, u, v, tri, obj), the miss record t = 1e5 /
u = v = 0 / ids -1 where none; for any hit the occlusion marker (tri 0 if
some row accepts, else -1; t = 1e5, u = v = 0, obj = -1).  The TPU kernel
groups the rows into leaves of BVH_LEAF_TRIS = 32 with world AABBs and
walks them front to back with an ordered early exit, which only skips
leaves that cannot beat a lane's best hit: up to exact-t ties its result
is the global closest hit over all rows, the function K1b computes.  So
the plain version of K6 is K1b's, `ops/dense_trace.py:dense_trace_multi_plain`,
on the same table with K6's band (the leaves only prune, so it does not
read them); `packet_trace` calls it on CPU tensors and the card check
holds the kernel to it.  Ties in t go to the smallest tri, then the
smallest row, as in K1b (the TPU kernel keeps the first winner it visits
across its 128-row groups, so at exact cross-leaf ties the two packages
may differ).

The kernel, `csrc/packet_trace.cu`, is one thread per ray walking an
implicit 4-ary tree over the morton-ordered leaves front to back with a
stack (`dense_trace.build_tree`, and the walk of `csrc/trace_common.cuh`,
which K1b runs over its 128-row chunks).  None of the TPU kernel's scheduling
carries over: its 512-ray packets sharing one leaf list, the list rows
and their SMEM DMA pipeline, the 7-bit quantised bounds, the overflow
walk, the leaf groups staged for the MXU, the streamed table and the
screen tiling all exist to feed 512-lane tiles from VMEM.

`packet_trace_sorted` is the coherence-recovering launch of incoherent
rays (key by `morton_key` in its 'beam' mode, stable sort, trace, scatter
back); its result equals `packet_trace`'s bit for bit.
"""

from __future__ import annotations

import torch

from low_precision_raytracer_tpu_torch.models.scene import BVH_LEAF_TRIS, DENSE_CHUNK_TRIS
from low_precision_raytracer_tpu_torch.ops import cuda_lib
from low_precision_raytracer_tpu_torch.ops.dense_trace import (
    STRICT,
    Band,
    BoxTree,
    _check_args,
    build_tree,
    dense_trace_multi_plain,
    morton_key,
    sorted_launch,
    table_cols,
    tree_launch,
)

LEAF = BVH_LEAF_TRIS


def packet_trace(origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids,
                 leaf_lo, leaf_hi, find_any: bool = False, band: Band = STRICT,
                 tree: BoxTree | None = None):
    """K6 wrapper.  origins/directions (R, 3) f32 (recentred), skip (R,)
    i32, mind/maxd (R,) f32, coef (TI, table_cols(band)) f32, tri_ids /
    obj_ids (TI,) i32, leaf_lo/leaf_hi (NL, 3) f32 with NL = 4 ceil(TI /
    128): the (widened) AABB of rows [32 l, 32 l + 32), in the rays' frame; `band`:
    `STRICT` or a `packet_band`; `tree`: `build_tree(leaf_lo, leaf_hi, TI,
    LEAF)` when the caller keeps one.  -> (t, u, v, tri, obj), see the module
    docstring.  On CPU tensors it runs the plain version; on CUDA tensors
    it launches the kernel or raises."""
    R, TI = origins.shape[0], coef.shape[0]
    NL = -(-TI // DENSE_CHUNK_TRIS) * (DENSE_CHUNK_TRIS // LEAF)
    f32, i32 = torch.float32, torch.int32
    _check_args("packet_trace",
                [origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids,
                 leaf_lo, leaf_hi],
                [(f32, (R, 3)), (f32, (R, 3)), (i32, (R,)), (f32, (R,)), (f32, (R,)),
                 (f32, (TI, table_cols(band))), (i32, (TI,)), (i32, (TI,)),
                 (f32, (NL, 3)), (f32, (NL, 3))])
    if origins.device.type == "cpu":
        return dense_trace_multi_plain(origins, directions, skip, mind, maxd, coef,
                                       tri_ids, obj_ids, find_any=find_any, band=band)
    if tree is None:
        tree = build_tree(leaf_lo, leaf_hi, TI, LEAF)
    if tree.leaf != LEAF:
        raise ValueError(f"packet_trace: the tree's leaf boxes hold {tree.leaf} rows, not {LEAF}")
    out = tree_launch("packet_trace", origins, directions, skip, mind, maxd, coef, tri_ids,
                      obj_ids, tree, find_any, band)
    cuda_lib.LAUNCHES["packet_trace"] += 1
    return out


def packet_trace_sorted(origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids,
                        leaf_lo, leaf_hi, find_any: bool = False, band: Band = STRICT,
                        tree: BoxTree | None = None):
    """K6 on incoherent rays (`trace_rays_packet_sorted`): sort the rays by
    `morton_key(..., mode='beam')` (dead lanes last), trace them in that
    order, scatter the results back.  Same arguments and results as
    `packet_trace`, equal to it bit for bit."""
    key = morton_key(origins, directions, live=maxd > mind, mode="beam")
    return sorted_launch(packet_trace, key, origins, directions, skip, mind, maxd, coef,
                         tri_ids, obj_ids, leaf_lo, leaf_hi, find_any=find_any, band=band,
                         tree=tree)
