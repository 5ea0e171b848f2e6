"""Trace dispatch (port of `low_precision_raytracer_tpu/ops/trace.py`).

`resolve_impl` resolves `traversal_impl='auto'` as the JAX package does
on the TPU: the dense route ('dense_pallas') up to `packet_bvh_min_tris`
instance triangles, the packet BVH ('pallas') up to `packet_bvh_max_tris`,
the two-level BVH walk ('jax') above.  `trace` prepares the kernels'
inputs (recentred rays, the coefficient table, the chunk or leaf AABBs,
the light rows) the way the JAX wrappers prepare them outside their
kernels, then dispatches as the JAX package does.

The BVH walk ('jax', `ops/traversal.py`, the kernel `csrc/bvh_walk.cu`)
and the all-pairs route ('dense', `ops/dense.py`, plain PyTorch) take
`cfg.triangle_fallback` with 'mxu3' resolved to 'both' (`resolve_fallback`
on these routes), the dtype epsilon on every secondary launch, no fused
shadow phase and no reordering of incoherent launches, as in the JAX
package.  The walk reads the scene's BLAS and triangle rows and the
frame's TLAS, which are built only on that route (`walk=True`): `trace`
takes the scene (`scene=`) there.

The dense route:
- closest-hit launches on single-chunk scenes (<= 128 instance
  triangles) -> K1a `dense_trace`, with the fused shadow phase when
  `di_lights` is given;
- other coherent launches (multi-chunk, or any hit) -> K1b
  `dense_trace_multi`, any chunk count (the tree over the chunk boxes is
  built once per frame table), each ray capped at its scene exit on
  multi-chunk scenes (`scene_exit_cap`, as `trace_rays_dense_pallas`);
- incoherent launches the JAX package sends to the per-ray wavefront
  (bf16, above `wavefront_min_tris` instance triangles) ->
  `trace_rays_wavefront` (K5 and its schedule kernel, `ops/wavefront.py`),
  after the `lane_k` transposes;
- other multi-chunk, incoherent launches on scenes with several objects
  and more than 4 chunks' worth of triangles -> the sorted K1b launch
  (`dense_trace_multi_sorted`, keyed by `incoherent_sort`), unless
  `incoherent_sort='none'`.

The packet BVH (K6, `ops/packet_trace.py`): coherent launches ->
`packet_trace`; incoherent launches on scenes with several objects and
more than 4096 instance triangles -> `packet_trace_sorted` (the morton
'beam' key); the tree over the leaf AABBs, and the view of it K6's warp
walk reads (`walk_view`, with the re-laid rows), are built once per frame
table.  Under a widened acceptance (the sub-f32 bands and 'dtype') both
walks grow each box for the ray that tests it by the band's proven
reach, from pads built once per frame table and band (`ops/band_pad.py`);
they return what the all-row scan returns.

`resolve_fallback`, `incoherent_reorders`, `di_fusible` and
`moveforward_eps` answer as the JAX package does for the resolved route.
`dense_epilogue='pack'` takes the packed winner epilogue on the dense
route's closest-hit launches in bf16 and fp16 (`use_pack`; fp32 ignores
it, and so do any-hit launches, the wavefront and the packet BVH, as in
the JAX package): K1a and K1b return (t, row, pk), decoded here
(`decode_packed`), and there is no fused shadow phase.  The wavefront
runs in `cfg.wavefront_mode` ('auto' is 'oneshot').
Every kernel gets the acceptance the JAX package resolves
(`acceptance_band`): under 'auto' the strict 'mxu3' test in bf16 and fp16
and the f32 'both' error band in fp32; 'both' and 'dtype' given
explicitly take the error band in any precision (the dense kernels' form
on the dense route, the packet kernel's on the packet BVH), and then the
wavefront is never used and every secondary launch takes the dtype
epsilon, as in the JAX package.  The per-frame table (`frame_table`)
carries the sub-f32 forms' band rows only when such a form is asked for.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from low_precision_raytracer_tpu_torch.config import Precision, RenderConfig
from low_precision_raytracer_tpu_torch.models.hierarchy import LIGHT_DIRECTIONAL
from low_precision_raytracer_tpu_torch.models.scene import (
    DENSE_CHUNK_TRIS,
    FrameInput,
    instance_tris,
)
from low_precision_raytracer_tpu_torch.ops.band_pad import band_pads
from low_precision_raytracer_tpu_torch.ops.dense import trace_rays_dense
from low_precision_raytracer_tpu_torch.ops.dense_trace import (
    CHUNK,
    KIND_STRICT,
    STRICT,
    Band,
    coef_table,
    decode_packed,
    dense_band,
    dense_trace,
    dense_trace_multi,
    dense_trace_multi_sorted,
    packet_band,
    scene_exit_cap,
)
from low_precision_raytracer_tpu_torch.ops.dense_trace import build_tree, per_table
from low_precision_raytracer_tpu_torch.ops.dense_trace import slice_table as _slice_table
from low_precision_raytracer_tpu_torch.ops.packet_trace import (
    LEAF,
    packet_trace,
    packet_trace_sorted,
    walk_view,
)
from low_precision_raytracer_tpu_torch.ops.traversal import trace_rays
from low_precision_raytracer_tpu_torch.ops.wavefront import trace_rays_wavefront

TC = DENSE_CHUNK_TRIS
# the packet walk sorts incoherent launches above this many instance
# triangles (`ops/trace.py:414` of the JAX package)
PACKET_SORT_MIN_TRIS = 4096


class Hit(NamedTuple):
    t: torch.Tensor  # (R,) f32, 1e5 on a miss
    u: torch.Tensor  # (R,) f32
    v: torch.Tensor  # (R,) f32
    tri: torch.Tensor  # (R,) i32, -1 on a miss (any hit: >= 0 if blocked)
    obj: torch.Tensor  # (R,) i32, -1 on a miss


def resolve_fallback(fb: str, prec: Precision, impl: str = "dense_pallas") -> str:
    """'auto' -> 'mxu3' for sub-fp32 dtypes on the kernel routes ('mxu3'
    exists only there); fp32 and the 'jax' / 'dense' routes get the
    exact-reference 'both'."""
    if fb == "auto":
        fb = "mxu3"
    if fb == "mxu3" and (prec.is_f32 or impl not in ("dense_pallas", "pallas")):
        return "both"
    return fb


def acceptance_band(frame: FrameInput, cfg: RenderConfig, prec: Precision) -> Band:
    """The acceptance every kernel of this route runs: the strict test for
    'mxu3'; for 'both' and 'dtype' the error band of the resolved route
    (the dense kernels' or the packet kernel's) in `prec`."""
    impl = resolve_impl(frame, cfg)
    fb = resolve_fallback(cfg.triangle_fallback, prec, impl)
    if fb == "mxu3":
        return STRICT
    if impl == "pallas":
        return packet_band(prec, fb)
    return dense_band(prec, fb)


def resolve_impl(frame: FrameInput, cfg: RenderConfig) -> str:
    """The trace route: `cfg.traversal_impl`, or for 'auto' the JAX
    package's TPU resolution from the instance-triangle count, in every
    precision.  fp16 too takes the kernel routes (and so 'mxu3' under
    'auto'), where the JAX package on the TPU sends fp16 to its XLA routes
    ('dense' / 'jax', `ops/trace.py:34-38`) only because Mosaic has no f16
    type; the card has no such gap.  The port's fp16 computes what the JAX
    package computes with the route named (`traversal_impl='dense_pallas'`
    or `'pallas'`).  A frame without a coefficient table (above
    DENSE_COEFF_MAX_TRIS, which the default packet_bvh_max_tris equals)
    takes the walk."""
    impl = cfg.traversal_impl
    if impl != "auto":
        return impl
    ti = instance_tris(frame)
    if ti > 0 and frame.dense_n is not None:
        if ti <= cfg.packet_bvh_min_tris and len(frame.obj_layout) > 0:
            return "dense_pallas"
        if ti <= cfg.packet_bvh_max_tris:
            return "pallas"
    return "jax"


def resolve_cfg(frame: FrameInput, cfg: RenderConfig) -> RenderConfig:
    """`cfg` with 'auto' replaced by the scene's route (the JAX `Renderer`
    bakes it in at construction)."""
    return dataclasses.replace(cfg, traversal_impl=resolve_impl(frame, cfg))


def _wavefront_route(frame: FrameInput, cfg: RenderConfig, prec: Precision) -> bool:
    """Would the JAX package send this scene's incoherent launches to the
    per-ray wavefront (`ops/trace.py:299-326`, inside the dense route)?"""
    ti = instance_tris(frame)
    return (resolve_impl(frame, cfg) == "dense_pallas"
            and cfg.incoherent_impl == "wavefront" and not prec.is_f32
            and resolve_fallback(cfg.triangle_fallback, prec) == "mxu3"
            and ti > max(4 * TC, cfg.wavefront_min_tris)
            and ti <= cfg.packet_bvh_max_tris)


def _sorted_route(frame: FrameInput, cfg: RenderConfig) -> bool:
    """Would an incoherent launch that does not go to the wavefront be
    sorted (the dense route's sorted K1b, the packet walk's sorted launch)?"""
    n_obj, ti = len(frame.obj_layout), instance_tris(frame)
    impl = resolve_impl(frame, cfg)
    if impl == "pallas":
        return n_obj > 1 and ti > PACKET_SORT_MIN_TRIS
    return (impl == "dense_pallas" and n_obj > 1 and ti > 4 * TC
            and cfg.incoherent_sort != "none")


def incoherent_reorders(frame: FrameInput, cfg: RenderConfig, prec: Precision) -> bool:
    """Would a `coherent=False` launch leave pixel order (sorted launch or
    wavefront)?  The renderer's fuse/unfuse choice reads this."""
    return _wavefront_route(frame, cfg, prec) or _sorted_route(frame, cfg)


def di_fusible(frame: FrameInput, cfg: RenderConfig) -> bool:
    """Can closest-hit launches carry the fused shadow phase?  True for
    single-chunk scenes of the dense route with at least one light, unless
    the packed epilogue is asked for (the shadow phase needs the full
    winner, JAX `ops/trace.py:114-115`)."""
    if cfg.di_fuse == "off" or resolve_impl(frame, cfg) != "dense_pallas":
        return False
    if cfg.dense_epilogue == "pack":
        return False
    return 0 < instance_tris(frame) <= TC and frame.n_lights > 0


def use_pack(cfg: RenderConfig, prec: Precision, find_any: bool) -> bool:
    """Does a dense-route launch take the packed epilogue?  Under
    `dense_epilogue='pack'`, for closest hit, below fp32
    (`trace_rays_dense_pallas` :961)."""
    return cfg.dense_epilogue == "pack" and not prec.is_f32 and not find_any


def moveforward_eps(frame: FrameInput, cfg: RenderConfig, prec: Precision,
                    coherent: bool = True) -> float:
    """Self-intersection epsilon of a secondary launch: origins ride
    exactly on the mxu3 dense route, so only the test's own t error needs
    clearing (`ray_moveforward_t_exact`); the wavefront re-quantizes its
    origins and keeps the dtype epsilon, and so does every launch of the
    packet BVH, the BVH walk and the all-pairs route (as in the JAX
    package, `ops/trace.py:135-136`)."""
    if (prec.is_f32 or resolve_impl(frame, cfg) != "dense_pallas"
            or resolve_fallback(cfg.triangle_fallback, prec) != "mxu3"):
        return prec.ray_moveforward_t
    if not coherent and _wavefront_route(frame, cfg, prec):
        return prec.ray_moveforward_t
    return prec.ray_moveforward_t_exact


def fused_moveforward(prec: Precision, band: Band) -> float:
    """The fused shadow phase's min t: its origins are the kernel's own f32
    hit points, so the exact epsilon, unless a sub-f32 error-band test
    re-quantizes them (`trace_rays_dense_pallas`'s `d_mov`)."""
    if band.kind == KIND_STRICT or prec.is_f32:
        return prec.ray_moveforward_t_exact
    return prec.ray_moveforward_t


def check_scene(frame: FrameInput, cfg: RenderConfig) -> None:
    """Raise ValueError when the scene's route reads the coefficient table
    and the frame has none (above DENSE_COEFF_MAX_TRIS instance triangles,
    where 'auto' takes the BVH walk, which needs no table)."""
    impl = resolve_impl(frame, cfg)
    if impl != "jax" and frame.dense_n is None:
        raise ValueError(
            f"traversal_impl={impl!r} reads the coefficient table, which a scene of "
            f"{instance_tris(frame)} instance triangles does not have (above "
            "DENSE_COEFF_MAX_TRIS); take traversal_impl='jax' or 'auto'")


def _box_tables(boxes_lo, boxes_hi, frame: FrameInput, leaf: int):
    """Boxes of `leaf` rows each, recentred like the rays, and the tree over
    them, once per frame table (keyed on `boxes_lo`)."""

    def build():
        c = frame.dense_center
        lo = (boxes_lo - c[None, :]).contiguous()
        hi = (boxes_hi - c[None, :]).contiguous()
        return lo, hi, build_tree(lo, hi, frame.dense_n_f32.shape[0], leaf)

    return per_table(boxes_lo, ("boxes", leaf), build)


def frame_table(frame: FrameInput, band: Band) -> torch.Tensor:
    """The frame's coefficient table for `band` (`coef_table`), built once
    per frame table and form (keyed on `dense_n_f32`): the f32 (TI, 12)
    rows, with the band rows only when a sub-f32 error-band acceptance asks
    for them."""
    return per_table(frame.dense_n_f32, ("table", band), lambda: coef_table(frame, band))


def _packet_tables(frame: FrameInput):
    """The packet route's leaf AABBs and the tree over them."""
    return _box_tables(frame.dense_leaf_lo, frame.dense_leaf_hi, frame, LEAF)


def _packet_walk(coef, tree):
    """K6's view of the packet tree for its warp walk (`walk_view`, with
    the rows of `coef` re-laid for it), once per coefficient table (one per
    frame table and acceptance, `frame_table`)."""
    return per_table(coef, ("walk",), lambda: walk_view(tree, coef))


def _band_pads(coef, tree, band: Band, slices=None):
    """The pads of a widened band's walk on `tree` (and K1b's `slices`;
    `band_pad.band_pads`), once per coefficient table and tree; None for
    the other acceptances."""
    if not band.widened:
        return None
    return per_table(coef, ("pads", tree.leaf), lambda: band_pads(coef, band, tree, slices))


def _chunk_tables(frame: FrameInput):
    """K1b's chunk AABBs and the tree over them."""
    return _box_tables(frame.dense_chunk_lo, frame.dense_chunk_hi, frame, CHUNK)


def di_light_rows(frame: FrameInput, di_lights: dict) -> torch.Tensor:
    """(L, 4) f32 rows [is_directional, ax, ay, az]: a = -normalize(dir)
    for directional lights, else the position recentred like the rays."""
    f32 = torch.float32
    c = frame.dense_center
    lp = di_lights["light_pos"].to(f32) - c[None, :]
    ld = di_lights["light_dir"].to(f32)
    nrm2 = torch.sum(ld * ld, dim=1, keepdim=True)
    ldn = ld / torch.sqrt(torch.clamp(nrm2, min=1e-20))
    isdir = di_lights["light_type"] == LIGHT_DIRECTIONAL
    avec = torch.where(isdir[:, None], -ldn, lp)
    return torch.cat([isdir.to(f32)[:, None], avec], dim=1).contiguous()


def trace(frame: FrameInput, origins, directions, *, cfg: RenderConfig,
          prec: Precision, find_any: bool = False, skip_tri=None, min_dist=0.0,
          max_dist=1e5, coherent: bool = True, lane_k: int = 1, di_lights=None,
          scene=None):
    """One trace launch.  -> Hit, or (Hit, vis (R,) i32) when `di_lights`
    asks for the fused shadow phase (single-chunk dense route only).
    `scene` (the SceneArrays): needed on the BVH walk's route.

    `coherent=False` marks rays not in screen order (GI bounces, bounce
    shadows).  `lane_k=K`: the caller packed K command lanes per pixel,
    pixel-major (row i*K + l = pixel i's lane l); the launch runs them
    lane-major (K blocks of pixel-ordered rays, so the dead lanes of one
    light cluster) and returns them pixel-major."""
    f32 = torch.float32
    dev = origins.device
    R = origins.shape[0]
    if skip_tri is None:
        skip_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    min_dist = torch.broadcast_to(torch.as_tensor(min_dist, dtype=f32, device=dev), (R,))
    max_dist = torch.broadcast_to(torch.as_tensor(max_dist, dtype=f32, device=dev), (R,))

    if lane_k > 1:
        if di_lights is not None:
            raise ValueError("the fused shadow phase is for lane_k=1 launches")
        K, R0 = lane_k, R // lane_k
        t3 = lambda x: x.reshape(R0, K, 3).transpose(0, 1).reshape(R, 3)
        t1 = lambda x: x.reshape(R0, K).T.reshape(R)
        hit = trace(frame, t3(origins), t3(directions), cfg=cfg, prec=prec,
                    find_any=find_any, skip_tri=t1(skip_tri), min_dist=t1(min_dist),
                    max_dist=t1(max_dist), coherent=coherent, scene=scene)
        return Hit(*(x.reshape(K, R0).T.reshape(R) for x in hit))

    impl = resolve_impl(frame, cfg)
    if impl in ("jax", "dense"):
        if di_lights is not None:
            raise ValueError("the fused shadow phase rides single-chunk closest-hit launches")
        kw = dict(prec=prec, find_any=find_any,
                  fallback=resolve_fallback(cfg.triangle_fallback, prec, impl),
                  skip_tri=skip_tri, min_dist=min_dist, max_dist=max_dist)
        if impl == "dense":
            return Hit(*trace_rays_dense(frame, origins, directions, **kw))
        if scene is None or scene.blas_parent is None or frame.tlas_parent is None:
            raise ValueError("the BVH walk ('jax') needs the scene (trace(..., scene=)) and "
                             "its tables: build_scene_arrays / flatten_frame with walk=True")
        return Hit(*trace_rays(scene, frame, origins, directions, **kw, coherent=coherent))
    acc = acceptance_band(frame, cfg, prec)
    if di_lights is not None and (find_any or instance_tris(frame) > TC
                                  or impl != "dense_pallas"):
        raise ValueError("the fused shadow phase rides single-chunk closest-hit launches")
    if not coherent and _wavefront_route(frame, cfg, prec):
        return Hit(*trace_rays_wavefront(
            frame, origins, directions, prec=prec, skip_tri=skip_tri, min_dist=min_dist,
            max_dist=max_dist, find_any=find_any, mode=cfg.wavefront_mode))
    c = frame.dense_center
    o = (origins.to(f32) - c[None, :]).contiguous()
    d = directions.to(f32).contiguous()
    rays = (o, d, skip_tri.to(torch.int32).contiguous(), min_dist.contiguous(),
            max_dist.contiguous(), frame_table(frame, acc), frame.dense_tri, frame.dense_obj)
    if impl == "pallas":
        lo, hi, tree = _packet_tables(frame)
        walk = _packet_walk(rays[5], tree)
        launch = (packet_trace_sorted if not coherent and _sorted_route(frame, cfg)
                  else packet_trace)
        return Hit(*launch(*rays, lo, hi, find_any=find_any, band=acc, tree=tree, walk=walk,
                           pads=_band_pads(rays[5], tree, acc)))
    pack = use_pack(cfg, prec, find_any)
    if pack and di_lights is not None:
        raise ValueError("the packed epilogue has no fused shadow phase (di_fusible)")

    def packed(out):
        t, row, pk = out
        u, v, tri, obj = decode_packed(row, pk, frame.dense_tri, frame.dense_obj)
        return Hit(t, u, v, tri, obj)

    if instance_tris(frame) <= TC and not find_any:
        if pack:
            return packed(dense_trace(*rays, band=acc, pack=True))
        lights = None if di_lights is None else di_light_rows(frame, di_lights)
        *h, vis = dense_trace(*rays, lights, d_mov=fused_moveforward(prec, acc), band=acc)
        return (Hit(*h), vis) if di_lights is not None else Hit(*h)
    if instance_tris(frame) > TC:
        # multi-chunk launches reach no further than the scene's exit, as in
        # `trace_rays_dense_pallas`: under a band's widened acceptance a row
        # can accept a point outside the scene box
        cap = scene_exit_cap(frame, origins.to(f32), d, max_dist).contiguous()
        rays = rays[:4] + (cap,) + rays[5:]
    lo, hi, tree = _chunk_tables(frame)
    slices = _slice_table(frame)
    pads = _band_pads(rays[5], tree, acc, slices)
    if not coherent and _sorted_route(frame, cfg):
        out = dense_trace_multi_sorted(*rays, lo, hi, find_any=find_any,
                                       key_mode=cfg.incoherent_sort, band=acc, tree=tree,
                                       pack=pack, slices=slices, pads=pads)
    else:
        out = dense_trace_multi(*rays, lo, hi, find_any=find_any, band=acc, tree=tree,
                                pack=pack, slices=slices, pads=pads)
    return packed(out) if pack else Hit(*out)
