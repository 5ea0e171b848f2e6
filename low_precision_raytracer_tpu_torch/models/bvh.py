"""Two-level BVH builder (port of `low_precision_raytracer_tpu/models/bvh.py`,
copied): parent-linked SoA node arrays on the host.

Topology, as in the JAX package: a binary median split (size / 2) on the
widest axis of the node AABB (strict > comparisons, x wins ties); BLAS
split keys are each triangle's first vertex, TLAS keys the AABB lower
bound; the median is found by a stable sort on (key, primitive id), so
the builder is deterministic; nodes are emitted in preorder (node, its
left subtree, its right subtree) with parent links for the stackless
walk; leaves hold up to `leaf_size` primitives.  AABBs are computed in
fp32 and cast to the render dtype widened (`bvh_aabbs_for_dtype`).

Above 64 primitives `build_bvh` runs the C++ builder
(`models/native.py`, `csrc/bvh_builder.cpp`), whose arrays are
bit-identical to this numpy one; at 64 or fewer, or with
`use_native=False`, the numpy builder runs.  The BLAS is built once per
scene, the TLAS over the objects' world AABBs per frame (leaf size 1).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch

from low_precision_raytracer_tpu_torch.utils.dtypes import widen_aabb

INVALID = -1
# the native builder pays off above this many primitives (as the JAX package)
NATIVE_MIN_PRIMS = 64
# triangles per BLAS leaf of a scene's build (the JAX `bvh_leaf_size`)
LEAF_SIZE = 4


@dataclass
class BVHArrays:
    """Parent-linked BVH as SoA numpy arrays: aabb_lo / aabb_hi (N, 3) f32,
    parent / lc / rc (N,) i32 (-1 = none), leaf_offset / leaf_count (N,)
    i32 (leaf_count 0: an internal node), prim (P,) i32 the primitive ids
    in leaf order.  The root is node 0."""

    aabb_lo: np.ndarray
    aabb_hi: np.ndarray
    parent: np.ndarray
    lc: np.ndarray
    rc: np.ndarray
    leaf_offset: np.ndarray
    leaf_count: np.ndarray
    prim: np.ndarray

    @property
    def n_nodes(self) -> int:
        return self.aabb_lo.shape[0]


def build_bvh(prim_lo, prim_hi, split_key, leaf_size=1, use_native=True) -> BVHArrays:
    """Median-split BVH over primitives: prim_lo / prim_hi (P, 3) fp32
    per-primitive AABBs (node AABBs are their unions), split_key (P, 3)
    fp32 sort keys."""
    prim_lo = np.asarray(prim_lo, np.float32)
    prim_hi = np.asarray(prim_hi, np.float32)
    split_key = np.asarray(split_key, np.float32)
    n = prim_lo.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    if use_native and n > NATIVE_MIN_PRIMS:
        from low_precision_raytracer_tpu_torch.models.native import native_build_bvh

        return BVHArrays(**native_build_bvh(prim_lo, prim_hi, split_key, leaf_size))

    aabb_lo, aabb_hi = [], []
    parent, lc, rc = [], [], []
    leaf_offset, leaf_count = [], []
    prim_out = []
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))

    def rec(idx: np.ndarray, parent_id: int) -> int:
        size = idx.shape[0]
        if size == 0:
            return INVALID
        lo = prim_lo[idx].min(axis=0)
        hi = prim_hi[idx].max(axis=0)
        node = len(parent)
        aabb_lo.append(lo)
        aabb_hi.append(hi)
        parent.append(parent_id)
        lc.append(INVALID)
        rc.append(INVALID)
        leaf_offset.append(0)
        leaf_count.append(0)
        if size <= leaf_size:
            leaf_offset[node] = len(prim_out)
            leaf_count[node] = size
            prim_out.extend(int(i) for i in idx)
        else:
            width = hi - lo
            if width[1] > width[0] and width[1] > width[2]:
                axis = 1
            elif width[2] > width[0] and width[2] > width[1]:
                axis = 2
            else:
                axis = 0
            srt = idx[np.lexsort((idx, split_key[idx, axis]))]
            half = size // 2
            lc[node] = rec(srt[:half], node)
            rc[node] = rec(srt[half:], node)
        return node

    rec(np.arange(n, dtype=np.int64), INVALID)
    return BVHArrays(
        aabb_lo=np.asarray(aabb_lo, np.float32),
        aabb_hi=np.asarray(aabb_hi, np.float32),
        parent=np.asarray(parent, np.int32),
        lc=np.asarray(lc, np.int32),
        rc=np.asarray(rc, np.int32),
        leaf_offset=np.asarray(leaf_offset, np.int32),
        leaf_count=np.asarray(leaf_count, np.int32),
        prim=np.asarray(prim_out, np.int32),
    )


def triangle_aabbs(positions, indices, use_native=True):
    """Per-triangle fp32 AABBs and first-vertex split keys: positions (V,
    3) fp32, indices (T, 3) i32 -> (lo, hi, key), each (T, 3)."""
    if use_native and np.asarray(indices).shape[0] > NATIVE_MIN_PRIMS:
        from low_precision_raytracer_tpu_torch.models.native import native_triangle_aabbs

        return native_triangle_aabbs(positions, indices)
    tri = np.asarray(positions, np.float32)[np.asarray(indices)]  # (T, 3, 3)
    return tri.min(axis=1), tri.max(axis=1), tri[:, 0, :]


def build_blas(positions, indices, leaf_size=1, use_native=True) -> BVHArrays:
    """A mesh's BLAS."""
    lo, hi, key = triangle_aabbs(positions, indices, use_native)
    return build_bvh(lo, hi, key, leaf_size=leaf_size, use_native=use_native)


def build_tlas(world_lo, world_hi, use_native=True) -> BVHArrays:
    """The scene BVH over the objects' world AABBs, leaf size 1."""
    world_lo = np.asarray(world_lo, np.float32)
    return build_bvh(world_lo, world_hi, world_lo, leaf_size=1, use_native=use_native)


@dataclass
class PackedBLAS(BVHArrays):
    """Every mesh's BLAS concatenated into one SoA with global ids: root[m]
    is mesh m's root node, prim holds global triangle ids, each root's
    parent is -1."""

    root: np.ndarray = None  # (n_meshes,) i32


def pack_blas(blas_list, tri_offsets) -> PackedBLAS:
    """Concatenate per-mesh BLAS arrays, globalising node and triangle ids."""
    names = ("aabb_lo", "aabb_hi", "parent", "lc", "rc", "leaf_offset", "leaf_count", "prim")
    outs = {k: [] for k in names}
    roots = []
    node_off = geom_off = 0

    def shift(a, off):
        return np.where(a >= 0, a + off, a).astype(np.int32)

    for blas, tri_off in zip(blas_list, tri_offsets):
        roots.append(node_off)
        outs["aabb_lo"].append(blas.aabb_lo)
        outs["aabb_hi"].append(blas.aabb_hi)
        for k in ("parent", "lc", "rc"):
            outs[k].append(shift(getattr(blas, k), node_off))
        outs["leaf_offset"].append(blas.leaf_offset + geom_off)
        outs["leaf_count"].append(blas.leaf_count)
        outs["prim"].append(blas.prim + tri_off)
        node_off += blas.n_nodes
        geom_off += blas.prim.shape[0]
    cat = {k: np.concatenate(v).astype(np.float32 if k.startswith("aabb") else np.int32)
           for k, v in outs.items()}
    return PackedBLAS(**cat, root=np.asarray(roots, np.int32))


def bvh_aabbs_for_dtype(aabb_lo, aabb_hi, dtype: torch.dtype):
    """Node AABBs cast to the render dtype, widened (CPU tensors)."""
    return widen_aabb(aabb_lo, aabb_hi, dtype)
