"""Packet BVH trace, K6 (port of `low_precision_raytracer_tpu/ops/traversal_pallas.py`:
`trace_rays_packet` and `trace_rays_packet_sorted`, `fallback='mxu3'`).

What it computes, per ray: the closest accepted hit of the M-shift test
over the rows of the coefficient table (the f32 rows, strict u > 0, v >
0, u + v < 1, mind < t < maxd, tri != skip, t finite) as (t, u, v, tri,
obj), the miss record t = 1e5 / u = v = 0 / ids -1 where none; for any
hit the occlusion marker (tri 0 if some row accepts, else -1; t = 1e5, u
= v = 0, obj = -1).  The TPU kernel groups the rows into leaves of
BVH_LEAF_TRIS = 32 with world AABBs and walks them front to back with an
ordered early exit, which only skips leaves that cannot beat a lane's
best hit: up to exact-t ties its result is the global closest hit over
all rows, the function K1b computes.  So the plain version of K6 is K1b's,
`ops/dense_trace.py:dense_trace_multi_plain`, on the same table (the
leaves only prune, so it does not read them); `packet_trace` calls it on
CPU tensors and the card check holds the kernel to it.  Ties in t go to
the smallest tri, then the smallest row, as in K1b (the TPU kernel keeps
the first winner it visits across its 128-row groups, so at exact
cross-leaf ties the two packages may differ).

The kernel, `csrc/packet_trace.cu`, is one thread per ray walking an
implicit 4-ary tree over the morton-ordered leaves front to back with a
stack (`build_tree`; the design is named in the source's header).  None
of the TPU kernel's scheduling carries over: its 512-ray packets sharing
one leaf list, the list rows and their SMEM DMA pipeline, the 7-bit
quantised bounds, the overflow walk, the leaf groups staged for the MXU,
the streamed table and the screen tiling all exist to feed 512-lane
tiles from VMEM.

`packet_trace_sorted` is the coherence-recovering launch of incoherent
rays (key by `morton_key` in its 'beam' mode, stable sort, trace, scatter
back); its result equals `packet_trace`'s bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from low_precision_raytracer_tpu_torch.models.scene import BVH_LEAF_TRIS, DENSE_CHUNK_TRIS
from low_precision_raytracer_tpu_torch.ops import cuda_lib
from low_precision_raytracer_tpu_torch.ops.dense_trace import (
    _check_args,
    dense_trace_multi_plain,
    morton_key,
    sorted_launch,
)

LEAF = BVH_LEAF_TRIS
FAN = 4  # children per tree node
MAX_LEVELS = 16  # the kernel's stack covers 3 (MAX_LEVELS - 1) + 1 entries


class PacketTree(NamedTuple):
    """An implicit FAN-ary tree over the leaves, in the rays' frame."""

    boxes: torch.Tensor  # (N, 6) f32 [lo3 | hi3], root level first, leaves last
    levels: torch.Tensor  # (2 L,) i32 [offset of level 0..L-1 | size of level 0..L-1]
    sizes: tuple  # static: nodes per level, level 0 (the leaves) first


def build_tree(leaf_lo, leaf_hi, n_rows: int) -> PacketTree:
    """The tree the kernel walks: level 0 is the leaves that hold rows
    (ceil(n_rows / 32) of them; the all-padding leaves are left out), and
    node i of level l + 1 is the union of nodes 4i .. 4i + 3 of level l,
    up to a single root.  The unions are exact min / max of the children's
    boxes, so a node contains every box below it."""
    n0 = -(-n_rows // LEAF)
    los, his = [leaf_lo[:n0]], [leaf_hi[:n0]]
    while los[-1].shape[0] > 1:
        lo, hi = los[-1], his[-1]
        pad = (-lo.shape[0]) % FAN
        inf = float("inf")
        lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=inf)
        hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-inf)
        los.append(lo.reshape(-1, FAN, 3).amin(dim=1))
        his.append(hi.reshape(-1, FAN, 3).amax(dim=1))
    sizes = tuple(x.shape[0] for x in los)
    if len(sizes) > MAX_LEVELS:
        raise NotImplementedError(
            f"packet_trace: {len(sizes)} tree levels, the kernel's stack covers "
            f"{MAX_LEVELS} ({FAN ** (MAX_LEVELS - 1)} leaves)")
    offsets, at = [], 0
    for n in reversed(sizes):  # root level first
        offsets.append(at)
        at += n
    offsets.reverse()
    boxes = torch.cat([torch.cat([lo, hi], dim=1) for lo, hi in zip(reversed(los),
                                                                     reversed(his))])
    levels = torch.tensor(offsets + list(sizes), dtype=torch.int32, device=leaf_lo.device)
    return PacketTree(boxes.contiguous(), levels, sizes)


def packet_trace(origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids,
                 leaf_lo, leaf_hi, find_any: bool = False, tree: PacketTree | None = None):
    """K6 wrapper.  origins/directions (R, 3) f32 (recentred), skip (R,)
    i32, mind/maxd (R,) f32, coef (TI, 12) f32, tri_ids / obj_ids (TI,)
    i32, leaf_lo/leaf_hi (NL, 3) f32 with NL = 4 ceil(TI / 128): the
    (widened) AABB of rows [32 l, 32 l + 32), in the rays' frame; `tree`:
    `build_tree(leaf_lo, leaf_hi, TI)` when the caller keeps one.  ->
    (t, u, v, tri, obj), see the module docstring.  On CPU tensors it runs
    the plain version; on CUDA tensors it launches the kernel or raises."""
    R, TI = origins.shape[0], coef.shape[0]
    NL = -(-TI // DENSE_CHUNK_TRIS) * (DENSE_CHUNK_TRIS // LEAF)
    f32, i32 = torch.float32, torch.int32
    _check_args("packet_trace",
                [origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids,
                 leaf_lo, leaf_hi],
                [(f32, (R, 3)), (f32, (R, 3)), (i32, (R,)), (f32, (R,)), (f32, (R,)),
                 (f32, (TI, 12)), (i32, (TI,)), (i32, (TI,)), (f32, (NL, 3)),
                 (f32, (NL, 3))])
    dev = origins.device
    if dev.type == "cpu":
        return dense_trace_multi_plain(origins, directions, skip, mind, maxd, coef,
                                       tri_ids, obj_ids, find_any=find_any)
    if coef.data_ptr() % 16:
        raise ValueError("packet_trace: the coefficient table must be 16-byte aligned")
    if tree is None:
        tree = build_tree(leaf_lo, leaf_hi, TI)
    t = torch.empty((R,), dtype=f32, device=dev)
    u, v = torch.empty_like(t), torch.empty_like(t)
    tri = torch.empty((R,), dtype=i32, device=dev)
    obj = torch.empty_like(tri)
    status = torch.zeros((1,), dtype=i32, device=dev)
    lib = cuda_lib.library("packet_trace")
    code = lib.lprt_packet_trace(
        origins.data_ptr(), directions.data_ptr(), skip.data_ptr(), mind.data_ptr(),
        maxd.data_ptr(), coef.data_ptr(), tri_ids.data_ptr(), obj_ids.data_ptr(),
        tree.boxes.data_ptr(), tree.levels.data_ptr(), len(tree.sizes), R, TI,
        int(find_any), t.data_ptr(), u.data_ptr(), v.data_ptr(), tri.data_ptr(),
        obj.data_ptr(), status.data_ptr(), cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(code, "packet_trace")
    cuda_lib.LAUNCHES["packet_trace"] += 1
    if int(status.item()):
        raise RuntimeError("packet_trace: a ray's walk overflowed the kernel's stack")
    return t, u, v, tri, obj


def packet_trace_sorted(origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids,
                        leaf_lo, leaf_hi, find_any: bool = False,
                        tree: PacketTree | None = None):
    """K6 on incoherent rays (`trace_rays_packet_sorted`): sort the rays by
    `morton_key(..., mode='beam')` (dead lanes last), trace them in that
    order, scatter the results back.  Same arguments and results as
    `packet_trace`, equal to it bit for bit."""
    key = morton_key(origins, directions, live=maxd > mind, mode="beam")
    return sorted_launch(packet_trace, key, origins, directions, skip, mind, maxd, coef,
                         tri_ids, obj_ids, leaf_lo, leaf_hi, find_any=find_any, tree=tree)
