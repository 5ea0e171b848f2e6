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

The kernel, `csrc/packet_trace.cu`, walks the packet tree with K1b's warp
walk (`csrc/chunk_walk.cuh`): the tree's level-1 nodes are exactly the
128-row chunks of four leaves, so levels 1.. are its chunk tree and the
leaves its 32-row slices (`walk_view`); each lane walks its ray's tree
nearest entry first, and the warp tests each waiting ray's leaves one row
a lane.  Its boxes are tested exactly on a zero direction axis
(`zero_axis_inside`): there the origin must lie in the box, with a margin,
where the slab test of the other kernels lets such a ray enter every box
its other slabs cross.  Under a widened acceptance each box is grown for
the ray that tests it by the band's proven reach (`ops/band_pad.py`).  None of
the TPU kernel's scheduling carries over: its 512-ray packets sharing one
leaf list, the list rows and their SMEM DMA pipeline, the 7-bit quantised
bounds, the overflow walk, the leaf groups staged for the MXU, the
streamed table and the screen tiling all exist to feed 512-lane tiles
from VMEM.

`packet_trace_sorted` is the coherence-recovering launch of incoherent
rays (key by `morton_key` in its 'beam' mode, stable sort, trace, scatter
back); its result equals `packet_trace`'s bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from low_precision_raytracer_tpu_torch.models.scene import BVH_LEAF_TRIS, DENSE_CHUNK_TRIS
from low_precision_raytracer_tpu_torch.ops import band_pad, cuda_lib
from low_precision_raytracer_tpu_torch.ops.dense_trace import (
    MAX_LEVELS,
    STRICT,
    Band,
    BoxTree,
    _check_args,
    build_tree,
    dense_trace_multi_plain,
    lane_table,
    morton_key,
    sorted_launch,
    table_cols,
)

LEAF = BVH_LEAF_TRIS
ZERO_AXIS_MARGIN = 1e-4  # csrc/trace_common.cuh:LPRT_ZERO_AXIS_MARGIN


def zero_axis_inside(lo, hi, o, inv):
    """The zero-axis rule of K6's box test (`box_entry_exact0`): rays (n,
    3) with inv = 1 / d against one box each (n, 3) + (n, 3) -> (n,) bool,
    false where some axis with an infinite inv (d = +-0) has the origin
    outside the box by more than the margin ZERO_AXIS_MARGIN (1 + |o|_1).
    The kernel enters a box when this holds and the slab test
    (`dense_trace.ray_aabb_entry`'s rule) enters it."""
    ao = o.abs()
    m = ZERO_AXIS_MARGIN * (1 + ao[:, 0] + ao[:, 1] + ao[:, 2])
    zero = torch.isinf(inv)
    inside = ((lo - m[:, None]) <= o) & (o <= (hi + m[:, None]))
    return (inside | ~zero).all(dim=1)


class PacketWalk(NamedTuple):
    """The packet tree as the warp walk reads it (`walk_view`)."""

    boxes: torch.Tensor  # (N, 6) f32: the boxes `levels` indexes
    levels: torch.Tensor  # (2 n_levels,) i32 the chunk tree's [offsets | sizes]
    n_levels: int
    slices: torch.Tensor  # (ceil(TI / 32), 6) f32 the leaf boxes
    lanes: torch.Tensor  # lane_table(coef): the rows re-laid for the walk
    stack: int  # the walk's stack entries, 3 (n_levels - 1) + 1


def walk_view(tree: BoxTree, coef) -> PacketWalk:
    """K6's tree for K1b's warp walk: node i of the packet tree's level 1
    is the union of leaves 4i .. 4i + 3, i.e. the box of rows [128 i,
    128 i + 128), so levels 1.. are a chunk tree and the leaves its 32-row
    slices; a one-leaf tree is its own chunk.  The boxes are `tree.boxes`
    itself, the slices a view of its leaf level."""
    L = len(tree.sizes)
    offs = [sum(tree.sizes[lvl + 1:]) for lvl in range(L)]
    n0 = tree.sizes[0]
    slices = tree.boxes[offs[0]:offs[0] + n0]
    if L == 1:
        levels, n_levels = [0, 1], 1
    else:
        levels, n_levels = offs[1:] + list(tree.sizes[1:]), L - 1
    if n_levels > MAX_LEVELS:
        raise NotImplementedError(f"packet_trace: {n_levels} chunk-tree levels, the walk "
                                  f"covers {MAX_LEVELS}")
    return PacketWalk(tree.boxes, torch.tensor(levels, dtype=torch.int32,
                                               device=tree.boxes.device),
                      n_levels, slices, lane_table(coef), 3 * (n_levels - 1) + 1)


def packet_trace(origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids,
                 leaf_lo, leaf_hi, find_any: bool = False, band: Band = STRICT,
                 tree: BoxTree | None = None, walk: PacketWalk | None = None,
                 persist: bool | None = None, pads: band_pad.BandPads | None = None):
    """K6 wrapper.  origins/directions (R, 3) f32 (recentred), skip (R,)
    i32, mind/maxd (R,) f32, coef (TI, table_cols(band)) f32, tri_ids /
    obj_ids (TI,) i32, leaf_lo/leaf_hi (NL, 3) f32 with NL = 4 ceil(TI /
    128): the (widened) AABB of rows [32 l, 32 l + 32), in the rays' frame; `band`:
    `STRICT` or a `packet_band`; `tree`: `build_tree(leaf_lo, leaf_hi, TI,
    LEAF)`, `walk`: `walk_view(tree, coef)` and, under a widened band,
    `pads`: `band_pad.band_pads(coef, band, tree)`, when the caller keeps
    them; `persist`: resident blocks pull the rays from a counter (default:
    in any hit, as K1b).  -> (t, u, v, tri, obj), see the module docstring.
    On CPU tensors it runs the plain version; on CUDA tensors it launches
    the kernel or raises."""
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
    if walk is None:
        walk = walk_view(tree, coef)
    wide = (None, None, None)
    if band.widened:
        if pads is None:
            pads = band_pad.band_pads(coef, band, tree)
        wide = (pads.tree, pads.slices,
                band_pad.launch_pads(origins, directions, mind, maxd, band, tree, pads, find_any))
    persist = find_any if persist is None else persist
    dev = origins.device
    t = torch.empty((R,), dtype=f32, device=dev)
    tri = torch.empty((R,), dtype=i32, device=dev)
    obj = torch.empty_like(tri)
    u, v = torch.empty_like(t), torch.empty_like(t)
    status = torch.zeros((2,), dtype=i32, device=dev)  # overflow, ray counter
    code = cuda_lib.library("packet_trace").lprt_packet_trace(
        origins.data_ptr(), directions.data_ptr(), skip.data_ptr(), mind.data_ptr(),
        maxd.data_ptr(), tri_ids.data_ptr(), obj_ids.data_ptr(), walk.boxes.data_ptr(),
        walk.levels.data_ptr(), walk.lanes.data_ptr(), walk.slices.data_ptr(),
        *(None if x is None else x.data_ptr() for x in wide), walk.n_levels,
        R, TI, int(find_any), band.form, walk.stack, int(persist), band.k0, band.k1, band.k2,
        t.data_ptr(), u.data_ptr(), v.data_ptr(), tri.data_ptr(), obj.data_ptr(),
        status.data_ptr(), cuda_lib.stream_ptr(dev))
    cuda_lib.check(code, "packet_trace")
    if int(status[0].item()):
        raise RuntimeError("packet_trace: a ray's walk overflowed the kernel's stack")
    cuda_lib.LAUNCHES["packet_trace"] += 1
    return t, u, v, tri, obj


def packet_trace_sorted(origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids,
                        leaf_lo, leaf_hi, find_any: bool = False, band: Band = STRICT,
                        tree: BoxTree | None = None, walk: PacketWalk | None = None,
                        persist: bool | None = None, pads: band_pad.BandPads | None = None):
    """K6 on incoherent rays (`trace_rays_packet_sorted`): sort the rays by
    `morton_key(..., mode='beam')` (dead lanes last), trace them in that
    order, scatter the results back.  Same arguments and results as
    `packet_trace`, equal to it bit for bit."""
    key = morton_key(origins, directions, live=maxd > mind, mode="beam")
    return sorted_launch(packet_trace, key, origins, directions, skip, mind, maxd, coef,
                         tri_ids, obj_ids, leaf_lo, leaf_hi, find_any=find_any, band=band,
                         tree=tree, walk=walk, persist=persist, pads=pads)
