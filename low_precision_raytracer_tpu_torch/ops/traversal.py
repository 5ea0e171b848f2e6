"""Stackless two-level BVH walk (port of
`low_precision_raytracer_tpu/ops/traversal.py:trace_rays`): the kernel
`csrc/bvh_walk.cu`, its wrapper `trace_rays` and its plain version
`trace_rays_plain`.

What it computes, per ray: the closest hit (or with `find_any` the first
accepted hit) in the order of the JAX package's parent-link state machine.
The ray walks the TLAS from the root; entering a leaf (one object)
transforms the ray into object space by the object's W2L matrix in the
render dtype (`transform_ray`), moves the TLAS cursor past the leaf and
walks the mesh's BLAS, testing up to `scene.leaf_size` triangles of each leaf it
enters in leaf order (skipping `skip_tri`, `ops/triangle.py`); popping
above the BLAS root returns it to the TLAS.  Boxes take the slab tests of
`ops/aabb.py` in the render dtype (the scene test with additive slop, the
object test with multiplicative slop), a box also needing t1max < maxd and
t2min > mind in the dtype and, in the BLAS, t1max < best_t in f32.  The
closest hit keeps an f32 best_t under a strict < (the first of equal t in
walk order wins).  Each ray takes at most `max_iters(scene, frame)` steps,
one node a step, as an active lane of the JAX loop advances one node per
iteration.  -> (t, u, v, tri, obj): f32 t/u/v, i32 ids; t = 1e5 and ids
-1 on a miss (any hit: the accepted hit's record).

The plain version runs the JAX loop in lockstep over the rays, masked as
in the JAX package.  The reference kernel (`trace_rays_reference`, the
walk's first form, on no render path) runs one thread a ray through the
same state machine in the ray's own order.  The walk (`trace_rays`) keeps
every result with fewer steps: the same depth-first order on a short
stack, dead rays unwalked, on `coherent=False` launches the live rays
packed (`launch_order`), and the exact zero-axis rule on BLAS boxes
(`ops/walk_pad.py`; `trace_rays_plain(..., exact0=True)` applies it too).
All round every render-dtype operation to the dtype and fuse nothing (the
kernels build with --fmad=false; their fused multiply-adds are the plain
version's float64 form), so they agree bit for bit.
`transform_ray`'s `rot @ o` is the f32 multiply-add chain of XLA's matrix
product on the CPU, rounded once.  Rays with an exact zero direction
component skip that axis in every box test (the JAX rule), so they enter
every box their other slabs cross (the colonnade's sun rays, d_x = 0)
unless the rule proves a BLAS box holds nothing they can accept.
"""

from __future__ import annotations

import torch

from low_precision_raytracer_tpu_torch.config import Precision
from low_precision_raytracer_tpu_torch.ops import cuda_lib, walk_pad
from low_precision_raytracer_tpu_torch.ops.aabb import (
    OBJECT_SLOP,
    SCENE_SLOP,
    dtype_const,
    ray_aabb_object,
    ray_aabb_scene,
)
from low_precision_raytracer_tpu_torch.ops.triangle import (
    TriangleParts,
    accept_against,
    fma,
    ray_triangle_parts,
)

INVALID = -1
# per-ray counts a launch can return (`stats`): TLAS steps, BLAS steps,
# triangle tests, objects entered
N_STATS = 4
# the plain walk drops its finished lanes every COMPACT iterations (once
# half of them are done)
COMPACT = 16
_DT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def max_iters(scene, frame) -> int:
    """The step cap of a ray: a ray re-walks a shared BLAS once per entered
    instance, so it scales with the instance count (`traversal.py:130`)."""
    n_instances = max(len(frame.obj_layout), 1)
    return 3 * (frame.tlas_parent.shape[0] + n_instances * scene.blas_parent.shape[0]) + 64


def transform_ray(w2l, o, d):
    """W2L (..., 4, 4) in the render dtype applied to rays (..., 3): the
    w-divided point and the w = 0 direction, in the dtype.  Each row of
    `rot @ x` is the f32 chain fma(r2, x2, fma(r1, x1, r0 x0)) rounded
    once to the dtype, as XLA computes the matrix product on the CPU (below
    f32 the products are exact, so it is their f32 sum); the translation,
    the w row and the divide round op by op."""
    f32 = torch.float32
    dt = o.dtype
    rot = w2l[..., :3, :3].to(f32)

    def matvec(x):
        xf = x.to(f32)[..., None, :]
        p0 = rot[..., 0] * xf[..., 0]
        return fma(rot[..., 2], xf[..., 2], fma(rot[..., 1], xf[..., 1], p0)).to(dt)

    o4 = matvec(o) + w2l[..., :3, 3]
    q = w2l[..., 3, :3].to(f32) * o.to(f32)
    ww = ((q[..., 0] + q[..., 1]) + q[..., 2]).to(dt) + w2l[..., 3, 3]
    return o4 / ww[..., None], matvec(d)


def _rays(origins, directions, skip_tri, min_dist, max_dist, dt):
    R = origins.shape[0]
    dev = origins.device
    f32 = torch.float32
    if skip_tri is None:
        skip_tri = torch.full((R,), INVALID, dtype=torch.int32, device=dev)
    mind = torch.broadcast_to(torch.as_tensor(min_dist, dtype=f32, device=dev), (R,))
    maxd = torch.broadcast_to(torch.as_tensor(max_dist, dtype=f32, device=dev), (R,))
    return (origins.to(dt), directions.to(dt), skip_tri.to(torch.int32), mind.contiguous(),
            maxd.contiguous())


def trace_rays_plain(scene, frame, origins, directions, *, prec: Precision,
                     find_any: bool = False, fallback: str = "both", skip_tri=None,
                     min_dist=0.0, max_dist=1e5, stats=None, exact0: bool = False):
    """The plain version: the JAX loop in lockstep, every lane masked, the
    finished lanes dropped now and then (which changes no lane's result); a
    leaf's triangles are tested together (`ray_triangle_parts`) and taken
    in leaf order against the running best_t (`accept_against`), which is
    the JAX loop's sequential update.  `stats`: an (R, N_STATS) i32 tensor
    to fill with each ray's counts, or None.  `exact0`: the BLAS box test
    also takes the walk's exact zero-axis rule (`walk_pad.rule_enters`,
    where the form has one), which changes the counts and no result."""
    leaf_size = scene.leaf_size
    dt = prec.dtype
    f32, i32 = torch.float32, torch.int32
    o_w, d_w, skip, mind, maxd = _rays(origins, directions, skip_tri, min_dist, max_dist, dt)
    R, dev = o_w.shape[0], o_w.device
    full = lambda v, t=i32: torch.full((R,), v, dtype=t, device=dev)
    # the finished record of every ray (written as lanes retire)
    out_t, out_u, out_v = full(1e5, f32), full(0.0, f32), full(0.0, f32)
    out_tri, out_obj = full(INVALID), full(INVALID)
    counts = torch.zeros((R, N_STATS), dtype=i32, device=dev)
    # the walking lanes: `lane` maps them to rays; retired lanes are
    # dropped every COMPACT iterations once half of them are done
    lane = torch.arange(R, device=dev)
    st = dict(o_w=o_w, d_w=d_w, skip=skip, mind=mind, maxd=maxd, mode=full(0), tl=full(INVALID),
              tc=full(0), bl=full(INVALID), bc=full(INVALID), obj=full(0), o_loc=o_w.clone(),
              d_loc=d_w.clone(), best_t=out_t.clone(), best_u=out_u.clone(),
              best_v=out_v.clone(), best_tri=out_tri.clone(), best_obj=out_obj.clone(),
              done=full(False, torch.bool), counts=counts.clone())
    ks = torch.arange(leaf_size, device=dev)
    pad4 = (node_pads(scene, prec, fallback)
            if exact0 and walk_pad.rule_form(dt, fallback) else None)

    def nxt(hit_from_parent, is_leaf, from_lc, lc, rc, parent):
        desc_target = torch.where(lc >= 0, lc, torch.where(rc >= 0, rc, parent))
        fromlc_target = torch.where(rc >= 0, rc, parent)
        return torch.where(hit_from_parent & ~is_leaf, desc_target,
                           torch.where(from_lc, fromlc_target, parent))

    def retire(keep):
        """Write every lane's record out; keep the lanes of `keep`."""
        nonlocal lane, st
        out_t[lane], out_u[lane], out_v[lane] = st["best_t"], st["best_u"], st["best_v"]
        out_tri[lane], out_obj[lane], counts[lane] = st["best_tri"], st["best_obj"], st["counts"]
        lane = lane[keep]
        st = {k: v[keep] for k, v in st.items()}

    for it in range(max_iters(scene, frame)):
        act = ~st["done"] & ~((st["mode"] == 0) & (st["tc"] < 0))
        if it % COMPACT == 0:
            n_act = int(act.sum())
            if n_act == 0:
                break
            if 2 * n_act <= lane.numel():
                retire(act)
                act = act[act]
        S = st
        o_w, d_w, mind, maxd = S["o_w"], S["d_w"], S["mind"], S["maxd"]
        mind_dt, maxd_dt = mind.to(dt), maxd.to(dt)
        mode, tl, tc, bl, bc, obj = S["mode"], S["tl"], S["tc"], S["bl"], S["bc"], S["obj"]
        o_loc, d_loc, best_t, done = S["o_loc"], S["d_loc"], S["best_t"], S["done"]
        tm, bm = act & (mode == 0), act & (mode == 1)

        # ---- TLAS lanes
        ti = torch.where(tm, tc, 0).long()
        parent, lc, rc = frame.tlas_parent[ti], frame.tlas_lc[ti], frame.tlas_rc[ti]
        leaf_cnt = frame.tlas_leaf_count[ti]
        hit, tmin, tmax = ray_aabb_scene(o_w, d_w, frame.tlas_lo[ti], frame.tlas_hi[ti])
        hit = hit & (tmin < maxd_dt) & (tmax > mind_dt)
        from_parent = tl == parent
        enter = tm & from_parent & hit & (leaf_cnt > 0)
        from_lc = ~from_parent & (tl == lc)
        S["tc"] = torch.where(tm, nxt(from_parent & hit, leaf_cnt > 0, from_lc, lc, rc, parent),
                              tc)
        S["tl"] = torch.where(tm, tc, tl)
        o_new = frame.tlas_prim[frame.tlas_leaf_offset[ti].long()]
        ei = torch.where(enter, o_new, 0).long()
        ol_new, dl_new = transform_ray(frame.obj_w2l[ei], o_w, d_w)
        root_new = scene.blas_root[frame.obj_mesh[ei].long()]

        # ---- BLAS lanes (the state from before this step)
        bi = torch.where(bm, bc, 0).long()
        parent, lc, rc = scene.blas_parent[bi], scene.blas_lc[bi], scene.blas_rc[bi]
        leaf_off, leaf_cnt = scene.blas_leaf_offset[bi], scene.blas_leaf_count[bi]
        hit, tmin, tmax = ray_aabb_object(o_loc, d_loc, scene.blas_lo[bi], scene.blas_hi[bi])
        hit = hit & (tmin.to(f32) < best_t) & (tmin < maxd_dt) & (tmax > mind_dt)
        if pad4 is not None:
            reach = walk_pad.ray_reach(o_loc, d_loc, mind, maxd)
            hit = hit & walk_pad.rule_enters(o_loc, d_loc, scene.blas_lo[bi], scene.blas_hi[bi],
                                             pad4[bi], reach, best_t, find_any)
        from_parent = bl == parent
        proc = bm & from_parent & hit & (leaf_cnt > 0)
        from_lc = ~from_parent & (bl == lc)
        # the leaf's triangles, (lanes, leaf_size), taken in leaf order
        slot = proc[:, None] & (ks[None, :] < leaf_cnt[:, None])
        tri = scene.blas_prim[torch.where(slot, leaf_off[:, None] + ks[None, :], 0).long()]
        slot = slot & (tri != S["skip"][:, None])
        g = torch.where(slot, tri, 0).long()
        parts = ray_triangle_parts(o_loc[:, None, :], d_loc[:, None, :], scene.tri_v2[g],
                                   scene.tri_m[g], scene.tri_v2_f32[g], scene.tri_m_f32[g],
                                   mind[:, None], maxd[:, None], prec, fallback=fallback)
        n_tri = torch.zeros_like(tc)
        for k in range(leaf_size):
            pk = TriangleParts(*(x[:, k] for x in parts))
            valid = slot[:, k] & ~done
            n_tri = n_tri + valid.to(i32)
            up = valid & accept_against(pk, best_t)
            best_t = torch.where(up, pk.t_out, best_t)
            S["best_u"] = torch.where(up, pk.u_out, S["best_u"])
            S["best_v"] = torch.where(up, pk.v_out, S["best_v"])
            S["best_tri"] = torch.where(up, tri[:, k], S["best_tri"])
            S["best_obj"] = torch.where(up, obj, S["best_obj"])
            if find_any:
                done = done | up
        S["best_t"], S["done"] = best_t, done
        new_bc = torch.where(bm, nxt(from_parent & hit, leaf_cnt > 0, from_lc, lc, rc, parent),
                             torch.where(enter, root_new, bc))
        S["bl"] = torch.where(bm, bc, torch.where(enter, INVALID, bl))
        S["bc"] = new_bc
        S["mode"] = torch.where(bm & (new_bc < 0), 0, torch.where(enter, 1, mode)).to(i32)
        S["obj"] = torch.where(enter, o_new, obj)
        S["o_loc"] = torch.where(enter[:, None], ol_new, o_loc)
        S["d_loc"] = torch.where(enter[:, None], dl_new, d_loc)
        S["counts"] = S["counts"] + torch.stack(
            [tm.to(i32), bm.to(i32), n_tri, enter.to(i32)], 1)
    retire(torch.zeros_like(lane, dtype=torch.bool))
    if stats is not None:
        stats.copy_(counts)
    return out_t, out_u, out_v, out_tri, out_obj


def _scene_rows(scene):
    """The kernel's view of the scene tables, f32 and i32: BLAS boxes (N,
    6) [lo | hi] and links (N, 5) [parent, lc, rc, leaf_offset,
    leaf_count], triangle rows (T, 12) [v2 | m row-major] in the render
    dtype's values and in f32, and the BLAS's depth."""
    from low_precision_raytracer_tpu_torch.ops.dense_trace import per_table

    def build():
        T = scene.tri_v2.shape[0]
        rows = lambda v2, m: torch.cat([v2.reshape(T, 3), m.reshape(T, 9)], 1).to(
            torch.float32).contiguous()
        return (_boxes(scene.blas_lo, scene.blas_hi),
                _links(scene.blas_parent, scene.blas_lc, scene.blas_rc,
                       scene.blas_leaf_offset, scene.blas_leaf_count),
                rows(scene.tri_v2, scene.tri_m), rows(scene.tri_v2_f32, scene.tri_m_f32),
                int(walk_pad.node_depth(scene.blas_parent).max()))

    return per_table(scene.blas_parent, ("walk_rows",), build)


def node_pads(scene, prec: Precision, fallback: str) -> torch.Tensor:
    """`walk_pad.node_pads` of the scene's BLAS, once per table and form."""
    from low_precision_raytracer_tpu_torch.ops.dense_trace import per_table

    return per_table(scene.blas_parent, ("walk_pads", prec.dtype, prec.delta1, prec.delta2,
                                         fallback),
                     lambda: walk_pad.node_pads(scene, prec, fallback))


def _boxes(lo, hi):
    return torch.cat([lo, hi], 1).to(torch.float32).contiguous()


def _links(*cols):
    return torch.stack(cols, 1).to(torch.int32).contiguous()


# the walk's stack (csrc/bvh_walk.cu:kStack): one right child a level of
# the TLAS and the BLAS
STACK = 64


def launch_order(mind, maxd) -> torch.Tensor:
    """An incoherent launch's order: (R,) i32, the live rays (maxd > mind)
    first and the dead ones (maxd <= mind, or a NaN) after them, each in
    the caller's order, so the live ones fill whole warps.  No host
    synchronisation."""
    live = maxd > mind
    n = torch.cumsum(live.to(torch.int64), 0)
    n_live = n[-1:] if n.numel() else n.new_zeros(1)
    idx = torch.arange(live.numel(), device=live.device)
    order = torch.empty_like(idx)
    order[torch.where(live, n - 1, n_live + idx - n)] = idx
    return order.to(torch.int32)


def trace_rays_packed_plain(scene, frame, origins, directions, *, coherent: bool = True,
                            stats=None, **kw):
    """The walk's launch around the plain version (any device): a dead ray
    (maxd <= mind, or a NaN) accepts nothing, since every accept needs mind
    < t < maxd, so it gets the miss record (t = 1e5, u = v = 0, ids -1) and
    zero counts unwalked; the live ones are walked by `trace_rays_plain`
    (kw: its keywords) packed by `launch_order` where `coherent` is False,
    and their results written back at their own places, as the kernel
    writes them.  Equal to `trace_rays_plain` on the unpacked rays."""
    prec = kw["prec"]
    o_w, d_w, skip, mind, maxd = _rays(origins, directions, kw.pop("skip_tri", None),
                                       kw.pop("min_dist", 0.0), kw.pop("max_dist", 1e5),
                                       prec.dtype)
    R, dev = o_w.shape[0], o_w.device
    order = torch.arange(R, device=dev) if coherent else launch_order(mind, maxd).long()
    sel = order[(maxd > mind)[order]]
    full = lambda v, t: torch.full((R,), v, dtype=t, device=dev)
    f32, i32 = torch.float32, torch.int32
    out = (full(1e5, f32), full(0.0, f32), full(0.0, f32), full(INVALID, i32), full(INVALID, i32))
    pst = None
    if stats is not None:
        stats.zero_()
        pst = torch.zeros((sel.numel(), N_STATS), dtype=i32, device=dev)
    got = trace_rays_plain(scene, frame, o_w[sel], d_w[sel], skip_tri=skip[sel],
                           min_dist=mind[sel], max_dist=maxd[sel], stats=pst, **kw)
    for x, y in zip(out, got):
        x[sel] = y
    if stats is not None:
        stats[sel] = pst
    return out


def _launch(scene, frame, origins, directions, prec, find_any, fallback, skip_tri, min_dist,
            max_dist, stats, walk: bool, coherent: bool):
    """The kernel launch of `trace_rays` (walk=True) and
    `trace_rays_reference`."""
    dt = prec.dtype
    f32, i32 = torch.float32, torch.int32
    if fallback not in ("both", "dtype"):
        raise ValueError(f"trace_rays: fallback {fallback!r} is not 'both' or 'dtype'")
    o_w, d_w, skip, mind, maxd = _rays(origins, directions, skip_tri, min_dist, max_dist, dt)
    R, dev = o_w.shape[0], o_w.device
    if scene.blas_parent.device != dev or frame.tlas_parent.device != dev:
        raise ValueError("trace_rays: the scene, the frame and the rays must share a device")
    if stats is not None and (stats.shape != (R, N_STATS) or stats.dtype != i32
                              or not stats.is_contiguous() or stats.device != dev):
        raise ValueError(f"trace_rays: stats must be a contiguous ({R}, {N_STATS}) int32 "
                         "tensor on the rays' device")
    blas_box, blas_link, tri_dt, tri_f32, blas_depth = _scene_rows(scene)
    tlas_box = _boxes(frame.tlas_lo, frame.tlas_hi)
    tlas_link = _links(frame.tlas_parent, frame.tlas_lc, frame.tlas_rc,
                       frame.tlas_leaf_offset, frame.tlas_leaf_count)
    w2l = frame.obj_w2l.reshape(-1, 16).to(f32).contiguous()
    c = lambda x: float(dtype_const(x, dt))
    out = tuple(torch.empty((R,), dtype=t, device=dev) for t in (f32, f32, f32, i32, i32))
    # every operand bound to a name, alive until the launch is queued
    ins = [o_w.to(f32).contiguous(), d_w.to(f32).contiguous(), skip.contiguous(), mind, maxd,
           tlas_box, tlas_link, frame.tlas_prim.to(i32).contiguous(), w2l,
           frame.obj_mesh.to(i32).contiguous(), scene.blas_root.to(i32).contiguous(),
           blas_box, blas_link, scene.blas_prim.to(i32).contiguous(), tri_dt, tri_f32]
    lib = cuda_lib.library("bvh_walk")
    ptr = lambda x: None if x is None else x.data_ptr()
    consts = (max_iters(scene, frame), c(SCENE_SLOP), c(OBJECT_SLOP), c(prec.delta1),
              c(prec.delta2), c(0.2), c(torch.finfo(f32).max))
    mode = (R, _DT[dt], int(find_any), int(fallback == "dtype"))
    if walk:
        from low_precision_raytracer_tpu_torch.ops.dense_trace import per_table

        tlas_depth = per_table(frame.tlas_parent, ("tlas_depth",),
                               lambda: int(walk_pad.node_depth(frame.tlas_parent).max()))
        if tlas_depth + blas_depth + 1 > STACK:
            raise ValueError(f"trace_rays: the TLAS ({tlas_depth}) and BLAS ({blas_depth}) are "
                             f"deeper than the walk's stack of {STACK} entries allows")
        order = None if coherent else launch_order(mind, maxd)
        pad4 = node_pads(scene, prec, fallback) if walk_pad.rule_form(dt, fallback) else None
        code = lib.lprt_bvh_walk_stack(*(x.data_ptr() for x in ins), ptr(order), ptr(pad4),
                                       *mode, *consts, *(x.data_ptr() for x in out), ptr(stats),
                                       cuda_lib.stream_ptr(dev))
        name = "bvh_walk"
    else:
        code = lib.lprt_bvh_walk(*(x.data_ptr() for x in ins), *mode, *consts,
                                 *(x.data_ptr() for x in out), ptr(stats),
                                 cuda_lib.stream_ptr(dev))
        name = "bvh_walk_ref"
    cuda_lib.check(code, name)
    cuda_lib.LAUNCHES[name] += 1
    return out


def trace_rays(scene, frame, origins, directions, *, prec: Precision, find_any: bool = False,
               fallback: str = "both", skip_tri=None, min_dist=0.0, max_dist=1e5,
               stats=None, coherent: bool = True):
    """The walk's wrapper (the JAX `trace_rays`' arguments): origins /
    directions (R, 3) in any float type (cast to the render dtype, as the
    JAX package casts them), skip_tri (R,) i32 or None, min_dist /
    max_dist scalars or (R,) f32; `fallback` 'both' or 'dtype'; `stats`:
    an (R, N_STATS) i32 tensor for each ray's counts, or None (dead rays
    count 0); `coherent=False` packs the live rays (`launch_order`).  On
    CPU tensors it runs the plain version; on CUDA tensors it launches the
    walk kernel or raises.  -> (t, u, v, tri, obj)."""
    if fallback not in ("both", "dtype"):
        raise ValueError(f"trace_rays: fallback {fallback!r} is not 'both' or 'dtype'")
    if origins.device.type == "cpu":
        return trace_rays_plain(scene, frame, origins, directions, prec=prec, find_any=find_any,
                                fallback=fallback, skip_tri=skip_tri, min_dist=min_dist,
                                max_dist=max_dist, stats=stats)
    return _launch(scene, frame, origins, directions, prec, find_any, fallback, skip_tri,
                   min_dist, max_dist, stats, True, coherent)


def trace_rays_reference(scene, frame, origins, directions, *, prec: Precision,
                         find_any: bool = False, fallback: str = "both", skip_tri=None,
                         min_dist=0.0, max_dist=1e5, stats=None):
    """The walk's reference on the card, on no render path: the kernel's
    first form (the JAX machine, one thread a ray in the caller's order, no
    rule).  `trace_rays`' arguments; CUDA tensors only."""
    if origins.device.type != "cuda":
        raise ValueError("trace_rays_reference: a kernel on the card; the CPU's reference is "
                         "trace_rays_plain")
    return _launch(scene, frame, origins, directions, prec, find_any, fallback, skip_tri,
                   min_dist, max_dist, stats, False, True)
