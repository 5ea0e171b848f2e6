"""Dense traces (port of `low_precision_raytracer_tpu/ops/dense_pallas.py`,
`fallback='mxu3'`): the M-shift test of every ray against world-space
per-instance-triangle coefficient rows, strict f32 acceptance.

Two kernels, each with a wrapper and its plain PyTorch version (the
wrapper launches the kernel on CUDA tensors, or raises; on CPU tensors it
runs the plain version):

- `dense_trace` (K1a, `csrc/dense_trace.cu`): single-chunk scenes
  (<= 128 instance triangles), closest hit with the fused shadow phase.
  Returns (t, u, v, tri, obj, vis), vis the per-ray bitmask of lights
  unoccluded from the winner's point (zeros when `lights` is None).
- `dense_trace_multi` (K1b, `csrc/dense_multi.cu`): any table size, the
  rows grouped in chunks of 128 with one world AABB each; closest hit or
  any hit.  Returns (t, u, v, tri, obj).

Both take the rays recentred by the scene centre and the coefficient
table as (TI, 12) f32 rows [n (3x3 row-major) | e (3)].  Closest hit: t =
1e5, u = v = 0, ids -1 on a miss; ties in t go to the smallest tri id, so
the result does not depend on the order in which triangles are tested.
Any hit: tri is a 0 (occluded) / -1 marker, t = 1e5, u = v = 0, obj = -1.

Around K1b: `ray_aabb_entry` (the conservative slab-entry bound both the
kernel's chunk walk and the sort key use), the sort keys `anchor_key` and
`morton_key`, and `dense_trace_multi_sorted`, the coherence-recovering
launch for incoherent rays (`trace_rays_dense_pallas_sorted`: key, stable
sort, trace, unsort; `sorted_launch` also serves the packet BVH's).
`m_shift_test` (the test's arithmetic, shared by the plain versions),
`coef_table` (the kernels' table layout) and `scene_exit_cap` (the
per-ray reach cap of the wavefront) sit here too.
"""

from __future__ import annotations

import torch

from low_precision_raytracer_tpu_torch.ops import cuda_lib

T_MISS = 1e5
MAX_TRIS = 128  # the kernel's shared-memory table
MAX_LIGHTS = 32  # bits of the visibility mask
CHUNK = 128  # K1b: table rows per chunk AABB
MAX_CHUNKS = 2048  # K1b: chunk AABBs in the kernel's 48 KB of shared memory
BOX_SLOP = 0.02  # scene-level slab-test slop of the JAX package


def tri_quantities(coef, o, d):
    """(R, TI) t, u, v, accept_geom for rays o, d (R, 3) against the
    table rows; the sums run in the kernel's order."""
    return m_shift_test([coef[:, i][None, :] for i in range(12)], o[:, :, None], d[:, :, None])


def m_shift_test(n, o, d):
    """The M-shift test of rays o, d (R, 3, 1) against coefficient rows n
    (12 tensors broadcasting against (R, 1): the table's columns, or each
    ray's own rows); -> t, u, v, accept_geom, the sums in the kernels'
    order."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    Oz = n[6] * ox + n[7] * oy + n[8] * oz + n[11]
    Dz = n[6] * dx + n[7] * dy + n[8] * dz
    Ox = n[0] * ox + n[1] * oy + n[2] * oz + n[9]
    Oy = n[3] * ox + n[4] * oy + n[5] * oz + n[10]
    Dx = n[0] * dx + n[1] * dy + n[2] * dz
    Dy = n[3] * dx + n[4] * dy + n[5] * dz
    t = -Oz / Dz
    u = Ox + t * Dx
    v = Oy + t * Dy
    return t, u, v, (u > 0) & (v > 0) & (u + v < 1)


def _closest(t, u, v, accept, tri_ids, obj_ids):
    """(R, TI) test results -> the (t, tri)-lexicographic closest accepted
    hit per ray: (t, u, v, tri, obj), the miss record where none."""
    R = t.shape[0]
    tri = tri_ids[None, :]
    inf = torch.tensor(float("inf"), dtype=t.dtype, device=t.device)
    t_masked = torch.where(accept, t, inf)
    t_min = t_masked.min(dim=1).values
    at_min = t_masked == t_min[:, None]
    big = torch.iinfo(torch.int32).max
    tri_win = torch.where(at_min, tri, big).min(dim=1).values
    win = at_min & (tri == tri_win[:, None])
    k = torch.argmax(win.to(torch.int8), dim=1)  # first winning row
    got = torch.isfinite(t_min) & (t_min < T_MISS)
    take = lambda x: x.gather(1, k[:, None])[:, 0]
    t_out = torch.where(got, t_min, torch.full_like(t_min, T_MISS))
    u_out = torch.where(got, take(u), torch.zeros_like(t_min))
    v_out = torch.where(got, take(v), torch.zeros_like(t_min))
    neg = torch.full((R,), -1, dtype=torch.int32, device=t.device)
    tri_out = torch.where(got, tri_win.to(torch.int32), neg)
    obj_out = torch.where(got, obj_ids[k].to(torch.int32), neg)
    return t_out, u_out, v_out, tri_out, obj_out


def _accept(t, geom, skip, mind, maxd, tri_ids):
    return (geom & (t > mind[:, None]) & (t < maxd[:, None])
            & (tri_ids[None, :] != skip[:, None]) & torch.isfinite(t))


def dense_trace_plain(origins, directions, skip, mind, maxd, coef, tri_ids,
                      obj_ids, lights=None, d_mov: float = 0.0):
    """Plain PyTorch version of the kernel: a dense (R, TI) broadcast test,
    then the shadow phase as a loop over the lights."""
    R = origins.shape[0]
    t, u, v, geom = tri_quantities(coef, origins, directions)
    accept = _accept(t, geom, skip, mind, maxd, tri_ids)
    t_out, u_out, v_out, tri_out, obj_out = _closest(t, u, v, accept, tri_ids, obj_ids)
    tri = tri_ids[None, :]

    vis = torch.zeros((R,), dtype=torch.int32, device=t.device)
    if lights is None:
        return t_out, u_out, v_out, tri_out, obj_out, vis
    p = origins + t_out[:, None] * directions
    for l in range(lights.shape[0]):
        isdir = lights[l, 0] > 0
        a = lights[l, 1:4]
        dvec = a[None, :] - p
        dist = torch.sqrt(dvec[:, 0] * dvec[:, 0] + dvec[:, 1] * dvec[:, 1]
                          + dvec[:, 2] * dvec[:, 2])
        inv = 1.0 / torch.clamp(dist, min=1e-20)
        sdir = torch.where(isdir, a[None, :].expand(R, 3), dvec * inv[:, None])
        maxd_l = torch.where(isdir, torch.full_like(dist, 1000.0), dist)
        t2, _u2, _v2, geom2 = tri_quantities(coef, p, sdir)
        blocked = (geom2 & (t2 > d_mov) & (t2 < maxd_l[:, None])
                   & (tri != tri_out[:, None]) & torch.isfinite(t2)).any(dim=1)
        vis = vis | torch.where((tri_out >= 0) & ~blocked, 1 << l, 0).to(torch.int32)
    return t_out, u_out, v_out, tri_out, obj_out, vis


def _check_args(what, args, want):
    """Raise unless every tensor is contiguous, of its dtype and shape, and
    on the first one's device."""
    dev = args[0].device
    for a, (dt, shape) in zip(args, want):
        if a.dtype != dt or tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(f"{what}: expected contiguous {dt} {shape}, "
                             f"got {a.dtype} {tuple(a.shape)}")
        if a.device != dev:
            raise ValueError(f"{what}: all tensors must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")


def dense_trace(origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids,
                lights=None, d_mov: float = 0.0):
    """Kernel wrapper: see the module docstring.  origins/directions (R, 3)
    f32, skip (R,) i32, mind/maxd (R,) f32, coef (TI, 12) f32, tri_ids /
    obj_ids (TI,) i32, lights (L, 4) f32 [is_directional, ax, ay, az] or
    None."""
    R = origins.shape[0]
    TI = coef.shape[0]
    L = 0 if lights is None else lights.shape[0]
    f32, i32 = torch.float32, torch.int32
    args = [origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids]
    want = [(f32, (R, 3)), (f32, (R, 3)), (i32, (R,)), (f32, (R,)), (f32, (R,)),
            (f32, (TI, 12)), (i32, (TI,)), (i32, (TI,))]
    if lights is not None:
        args.append(lights)
        want.append((f32, (L, 4)))
    dev = origins.device
    _check_args("dense_trace", args, want)
    if TI > MAX_TRIS or L > MAX_LIGHTS:
        raise NotImplementedError(
            f"dense_trace covers single-chunk scenes (<= {MAX_TRIS} instance "
            f"triangles, <= {MAX_LIGHTS} lights); got {TI} / {L} "
            "(multi-chunk scenes go to dense_trace_multi)")
    if dev.type == "cpu":
        return dense_trace_plain(origins, directions, skip, mind, maxd, coef,
                                 tri_ids, obj_ids, lights, d_mov)
    t = torch.empty((R,), dtype=f32, device=dev)
    u, v = torch.empty_like(t), torch.empty_like(t)
    tri = torch.empty((R,), dtype=i32, device=dev)
    obj, vis = torch.empty_like(tri), torch.empty_like(tri)
    lib = cuda_lib.library("dense_trace")
    code = lib.lprt_dense_trace(
        origins.data_ptr(), directions.data_ptr(), skip.data_ptr(),
        mind.data_ptr(), maxd.data_ptr(), coef.data_ptr(), tri_ids.data_ptr(),
        obj_ids.data_ptr(), None if lights is None else lights.data_ptr(),
        R, TI, L, float(d_mov), t.data_ptr(), u.data_ptr(), v.data_ptr(),
        tri.data_ptr(), obj.data_ptr(),
        None if lights is None else vis.data_ptr(), cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(code, "dense_trace")
    cuda_lib.LAUNCHES["dense_trace"] += 1
    if lights is None:
        vis.zero_()
    return t, u, v, tri, obj, vis



# ---------------------------------------------------------------------------
# K1b: multi-chunk dense trace


def dense_trace_multi_plain(origins, directions, skip, mind, maxd, coef, tri_ids,
                            obj_ids, chunk_lo=None, chunk_hi=None, find_any=False,
                            slab_elems: int = 1 << 22):
    """Plain PyTorch version of K1b: every ray against every row (the
    chunk AABBs only prune, so they are not read), as a global (t, tri)
    minimum or an any-accept, in slabs of rays of about `slab_elems`
    (ray, row) pairs to bound memory: each f32 temporary of the test is
    4 * slab_elems bytes, whatever the table's size."""
    R, TI = origins.shape[0], coef.shape[0]
    dev = origins.device
    outs = []
    rs = max(1, slab_elems // TI)
    for r0 in range(0, max(R, 1), rs):
        sl = slice(r0, r0 + rs)
        t, u, v, geom = tri_quantities(coef, origins[sl], directions[sl])
        acc = _accept(t, geom, skip[sl], mind[sl], maxd[sl], tri_ids)
        if find_any:
            n = t.shape[0]
            blocked = acc.any(dim=1)
            outs.append((torch.full((n,), T_MISS, dtype=torch.float32, device=dev),
                         torch.zeros((n,), dtype=torch.float32, device=dev),
                         torch.zeros((n,), dtype=torch.float32, device=dev),
                         torch.where(blocked, 0, -1).to(torch.int32),
                         torch.full((n,), -1, dtype=torch.int32, device=dev)))
        else:
            outs.append(_closest(t, u, v, acc, tri_ids, obj_ids))
    return tuple(torch.cat(x) for x in zip(*outs))


def dense_trace_multi(origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids,
                      chunk_lo, chunk_hi, find_any: bool = False):
    """K1b wrapper: see the module docstring.  origins/directions (R, 3)
    f32, skip (R,) i32, mind/maxd (R,) f32, coef (TI, 12) f32, tri_ids /
    obj_ids (TI,) i32, chunk_lo/chunk_hi (NC, 3) f32 with NC =
    ceil(TI / 128): the AABB of rows [128 c, 128 c + 128), in the rays'
    (recentred) frame.  -> (t, u, v, tri, obj)."""
    R = origins.shape[0]
    TI = coef.shape[0]
    NC = -(-TI // CHUNK)
    f32, i32 = torch.float32, torch.int32
    _check_args("dense_trace_multi",
                [origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids,
                 chunk_lo, chunk_hi],
                [(f32, (R, 3)), (f32, (R, 3)), (i32, (R,)), (f32, (R,)), (f32, (R,)),
                 (f32, (TI, 12)), (i32, (TI,)), (i32, (TI,)), (f32, (NC, 3)),
                 (f32, (NC, 3))])
    if NC > MAX_CHUNKS:
        raise NotImplementedError(
            f"dense_trace_multi holds <= {MAX_CHUNKS} chunk AABBs in shared "
            f"memory; got {NC} ({TI} instance triangles: the packet BVH, "
            "ROADMAP queue 1 item 10)")
    dev = origins.device
    if dev.type == "cpu":
        return dense_trace_multi_plain(origins, directions, skip, mind, maxd, coef,
                                       tri_ids, obj_ids, chunk_lo, chunk_hi, find_any)
    if coef.data_ptr() % 16:
        raise ValueError("dense_trace_multi: the coefficient table must be 16-byte aligned")
    t = torch.empty((R,), dtype=f32, device=dev)
    u, v = torch.empty_like(t), torch.empty_like(t)
    tri = torch.empty((R,), dtype=i32, device=dev)
    obj = torch.empty_like(tri)
    boxes = torch.cat([chunk_lo, chunk_hi], dim=1).contiguous()  # (NC, 6)
    lib = cuda_lib.library("dense_multi")
    code = lib.lprt_dense_trace_multi(
        origins.data_ptr(), directions.data_ptr(), skip.data_ptr(), mind.data_ptr(),
        maxd.data_ptr(), coef.data_ptr(), tri_ids.data_ptr(), obj_ids.data_ptr(),
        boxes.data_ptr(), R, TI, NC, int(find_any), t.data_ptr(), u.data_ptr(),
        v.data_ptr(), tri.data_ptr(), obj.data_ptr(), cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(code, "dense_trace_multi")
    cuda_lib.LAUNCHES["dense_trace_multi"] += 1
    return t, u, v, tri, obj


def ray_aabb_entry(lo, hi, o, d, maxd):
    """Conservative slab-test entry bound of rays (RS, 3) against boxes
    (N, 3): -> (entry (RS, N) f32 >= 0, ok (RS, N) bool).  Axes whose slab
    distances are not finite (a zero direction component) constrain
    nothing; 0.02 of slop keeps the bound below every hit the box holds."""
    inv = 1.0 / d
    big = 3e38
    t1 = (lo[None] - o[:, None]) * inv[:, None]  # (RS, N, 3)
    t2 = (hi[None] - o[:, None]) * inv[:, None]
    a = torch.minimum(t1, t2)
    b = torch.maximum(t1, t2)
    fin = torch.isfinite(a) & torch.isfinite(b)
    tmin = torch.where(fin, a, -big).amax(dim=-1)
    tmax = torch.where(fin, b, big).amin(dim=-1)
    entry = torch.clamp(tmin - BOX_SLOP, min=0.0)
    ok = (fin.any(dim=-1) & (tmin <= tmax + BOX_SLOP) & (tmax + BOX_SLOP >= 0)
          & (entry < maxd[:, None]))
    return entry, ok


def coef_table(frame):
    """(TI, 12) f32 rows n[0..8] | e[0..2] of the frame's dense table: the
    layout every trace kernel reads."""
    TI = frame.dense_n_f32.shape[0]
    return torch.cat([frame.dense_n_f32.reshape(TI, 9), frame.dense_e], dim=1).contiguous()


def scene_exit_cap(frame, o, d, max_dist):
    """Cap every lane's reach at its exit from the scene AABB (the union of
    the object boxes), with the JAX package's slop: no hit lies beyond it,
    and the wavefront's resolution test needs a finite reach.  o, d (R, 3)
    f32 world-space rays, max_dist (R,) f32 -> (R,) f32."""
    lo = frame.obj_aabb_lo.amin(dim=0)
    hi = frame.obj_aabb_hi.amax(dim=0)
    inv = 1.0 / d
    t1 = (lo[None, :] - o) * inv
    t2 = (hi[None, :] - o) * inv
    far = torch.maximum(t1, t2)
    far = torch.where(torch.isfinite(far), far, torch.full_like(far, 3e38))
    texit = far.amin(dim=-1)
    ext = hi - lo
    slop = 1e-3 * torch.sqrt(torch.sum(ext * ext)) + 0.05
    return torch.minimum(max_dist, torch.clamp(texit, min=0.0) * 1.01 + slop)


def anchor_key(lo, hi, origins, directions, max_dist, live, slab_elems: int = 1 << 24):
    """Sort key that groups rays by their nearest chunk (by slab-entry
    bound; chunks merge into <= 1024 anchor groups) and then by direction
    octant and 2 magnitude bits per axis; dead lanes sort last.  The
    (rays, anchors) sweep runs in slabs of about `slab_elems` / 3 pairs."""
    nc = lo.shape[0]
    s = -(-nc // 1024)  # group size -> <= 1024 anchors
    if s > 1:
        pad = (-nc) % s
        lo_g = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=3e38)
        hi_g = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-3e38)
        lo_g = lo_g.reshape(-1, s, 3).amin(dim=1)
        hi_g = hi_g.reshape(-1, s, 3).amax(dim=1)
    else:
        lo_g, hi_g = lo, hi
    na = lo_g.shape[0]
    R = origins.shape[0]
    rs = max(4096, slab_elems // (3 * na))
    anchor = torch.empty((R,), dtype=torch.int32, device=origins.device)
    for r0 in range(0, R, rs):
        sl = slice(r0, r0 + rs)
        entry, ok = ray_aabb_entry(lo_g, hi_g, origins[sl], directions[sl], max_dist[sl])
        anchor[sl] = torch.argmin(torch.where(ok, entry, 3e38), dim=1).to(torch.int32)
    d = directions
    octant = ((d[:, 0] > 0).to(torch.int32) | ((d[:, 1] > 0).to(torch.int32) << 1)
              | ((d[:, 2] > 0).to(torch.int32) << 2))
    qd = torch.clamp(d.abs() * 3, 0, 3).to(torch.int32)  # 2 bits per axis
    dirbits = (octant << 6) | (qd[:, 0] << 4) | (qd[:, 1] << 2) | qd[:, 2]
    key = (anchor << 9) | dirbits
    return key | torch.where(live, 0, 1 << 28).to(torch.int32)


def _spread3(x):
    """7 bits -> every 3rd bit."""
    x = (x | (x << 8)) & 0x0100F00F
    x = (x | (x << 4)) & 0x010C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _spread6(x):
    """4 bits -> bits 0, 6, 12, 18."""
    x = (x | (x << 10)) & 0x00003003
    x = (x | (x << 5)) & 0x00041041
    return x


def morton_key(origins, directions, live=None, mode: str = "beam"):
    """The JAX package's `_morton_key` (`ops/dense_pallas.py`): liveness
    (bit 28: dead lanes sort last), the direction octant, then 'origin': a
    21-bit morton code of the origin (7 bits per axis) or 'beam': origin
    and |direction| interleaved, 4 bits per axis each, origin-major.  The
    origin grid spans the launch's own origins.  -> (R,) i32."""
    of = origins.to(torch.float32)
    df = directions.to(torch.float32)
    lo = of.amin(dim=0)
    hi = of.amax(dim=0)
    i32 = torch.int32
    octant = ((df[:, 0] > 0).to(i32) | ((df[:, 1] > 0).to(i32) << 1)
              | ((df[:, 2] > 0).to(i32) << 2))
    span = torch.clamp(hi - lo, min=1e-6)
    if mode == "origin":
        q = torch.clamp((of - lo) / span * 127, 0, 127).to(i32)
        m = _spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1) | (_spread3(q[:, 2]) << 2)
        key = (octant << 21) | m
    elif mode == "beam":
        qo = torch.clamp((of - lo) / span * 15, 0, 15).to(i32)
        qd = torch.clamp(df.abs() * 15, 0, 15).to(i32)
        m = ((_spread6(qo[:, 0]) << 5) | (_spread6(qo[:, 1]) << 4) | (_spread6(qo[:, 2]) << 3)
             | (_spread6(qd[:, 0]) << 2) | (_spread6(qd[:, 1]) << 1) | _spread6(qd[:, 2]))
        key = (octant << 24) | m
    else:
        raise ValueError(f"morton_key: unknown mode {mode!r}")
    if live is not None:
        key = key | torch.where(live, 0, 1 << 28).to(i32)
    return key


def sorted_launch(launch, key, origins, directions, skip, mind, maxd, *table, **kw):
    """`launch` on the rays in `key` order (a stable sort: a fixed
    permutation), its results scattered back to the caller's order."""
    order = torch.sort(key, stable=True).indices
    outs = launch(origins[order], directions[order], skip[order], mind[order], maxd[order],
                  *table, **kw)
    back = []
    for x in outs:
        y = torch.empty_like(x)
        y[order] = x
        back.append(y)
    return tuple(back)


def dense_trace_multi_sorted(origins, directions, skip, mind, maxd, coef, tri_ids,
                             obj_ids, chunk_lo, chunk_hi, find_any: bool = False,
                             key_mode: str = "anchor"):
    """K1b on incoherent rays, coherence recovered
    (`trace_rays_dense_pallas_sorted`): sort the rays by `anchor_key`, or
    by `morton_key` in mode `key_mode` ('beam' / 'origin'), trace them in
    that order, scatter the results back to the caller's order.  Same
    arguments and results as `dense_trace_multi`; equal to it bit for bit
    (its result does not depend on ray order)."""
    live = maxd > mind
    if key_mode == "anchor":
        key = anchor_key(chunk_lo, chunk_hi, origins, directions, maxd, live=live)
    else:
        key = morton_key(origins, directions, live=live, mode=key_mode)
    return sorted_launch(dense_trace_multi, key, origins, directions, skip, mind, maxd,
                         coef, tri_ids, obj_ids, chunk_lo, chunk_hi, find_any=find_any)
