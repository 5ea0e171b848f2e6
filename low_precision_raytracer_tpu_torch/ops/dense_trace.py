"""Dense single-chunk trace with the fused shadow phase (port of
`low_precision_raytracer_tpu/ops/dense_pallas.py:trace_rays_dense_pallas`,
single-chunk mode, `fallback='mxu3'`, `di_lights=L`).

`dense_trace` is the kernel wrapper: on CUDA tensors it launches
`csrc/dense_trace.cu` (or raises), on CPU tensors it runs
`dense_trace_plain`, the same function in plain PyTorch.  Both take the
rays already recentred by the scene centre (as the TPU path feeds its
kernel) and the coefficient table as (TI, 12) f32 rows [n (3x3 row-major)
| e (3)].

Returns (t, u, v, tri, obj, vis): closest hit per ray (t = 1e5, u = v = 0,
ids -1 on a miss; ties in t go to the smallest tri id) and the per-ray
visibility bitmask (bit l = light l unoccluded from the winner's point;
all zeros when `lights` is None).
"""

from __future__ import annotations

import torch

from low_precision_raytracer_tpu_torch.ops import cuda_lib

T_MISS = 1e5
MAX_TRIS = 128  # the kernel's shared-memory table
MAX_LIGHTS = 32  # bits of the visibility mask


def tri_quantities(coef, o, d):
    """(R, TI) t, u, v, accept_geom for rays o, d (R, 3) against the
    table rows; the sums run in the kernel's order."""
    n = [coef[:, i][None, :] for i in range(12)]
    ox, oy, oz = (o[:, i : i + 1] for i in range(3))
    dx, dy, dz = (d[:, i : i + 1] for i in range(3))
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


def dense_trace_plain(origins, directions, skip, mind, maxd, coef, tri_ids,
                      obj_ids, lights=None, d_mov: float = 0.0):
    """Plain PyTorch version of the kernel: a dense (R, TI) broadcast test,
    then the shadow phase as a loop over the lights."""
    R = origins.shape[0]
    t, u, v, geom = tri_quantities(coef, origins, directions)
    tri = tri_ids[None, :]
    accept = (geom & (t > mind[:, None]) & (t < maxd[:, None])
              & (tri != skip[:, None]) & torch.isfinite(t))
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
    for a, (dt, shape) in zip(args, want):
        if a.dtype != dt or tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(f"dense_trace: expected contiguous {dt} {shape}, "
                             f"got {a.dtype} {tuple(a.shape)}")
        if a.device != dev:
            raise ValueError("dense_trace: all tensors must be on one device")
    if TI > MAX_TRIS or L > MAX_LIGHTS:
        raise NotImplementedError(
            f"dense_trace covers single-chunk scenes (<= {MAX_TRIS} instance "
            f"triangles, <= {MAX_LIGHTS} lights); got {TI} / {L} "
            "(multi-chunk scenes: ROADMAP queue 1 item 9)")
    if dev.type == "cpu":
        return dense_trace_plain(origins, directions, skip, mind, maxd, coef,
                                 tri_ids, obj_ids, lights, d_mov)
    if dev.type != "cuda":
        raise ValueError(f"dense_trace: unsupported device {dev}")
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

