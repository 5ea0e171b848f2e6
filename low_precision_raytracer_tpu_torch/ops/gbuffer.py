"""Traced primary-visibility G-buffer (port of
`low_precision_raytracer_tpu/ops/gbuffer.py`): `fill_gbuffer` and
`interpolate_hit_attributes` (the small-scene per-triangle-row path)."""

from __future__ import annotations

import torch

from low_precision_raytracer_tpu_torch.math.vec import matvec, normalize
from low_precision_raytracer_tpu_torch.ops.texture import has_textures
from low_precision_raytracer_tpu_torch.ops.trace import Hit, trace


def _finish_world(l2w, position, normal, tangent):
    """World transform with (R, 4, 4)-gathered rows; normals/tangents go
    through L2W directly (no inverse-transpose), like the reference."""
    # fixed-order f32 sums ((r0 x0 + r1 x1) + r2 x2), rounded once to the
    # dtype as a batched `@` rounds its f32 accumulator: a shard's rows
    # then get the whole frame's bits on any device (the order of
    # `ops/reproject.py`'s clip product; on Cornell's hits every order
    # gives the JAX attributes' bits)
    dt = l2w.dtype
    rot = l2w[..., :3, :3].float()
    rotate = lambda x: matvec(rot, x.float()).to(dt)
    normal = normalize(rotate(normal))
    tangent = normalize(rotate(tangent))
    pos_w = rotate(position) + l2w[..., :3, 3]
    return pos_w, normal, tangent


def interpolate_hit_attributes(scene, frame, hit: Hit, dtype):
    """Barycentric attribute interpolation + local-to-world transform in
    `dtype` (misses read triangle/object 0; callers mask them).  The uv
    sets are interpolated only in a scene with textures (else None)."""
    dt = dtype
    u = hit.u.to(dt)[..., None]
    v = hit.v.to(dt)[..., None]
    w = (1.0 - hit.u - hit.v).to(dt)[..., None]
    tri = torch.clamp(hit.tri, min=0).long()
    obj = torch.clamp(hit.obj, min=0).long()
    a = scene.tri_attr[tri].to(dt)  # (R, 48): 3 vertices x 16 attributes
    # position, normal, tangent, colour (and the uv sets) of each vertex
    k = 16 if has_textures(scene) else 12
    attr = u * a[:, 0:k] + v * a[:, 16:16 + k] + w * a[:, 32:32 + k]
    # f32 attributes read the f32 L2W copy; a dtype matrix would
    # re-quantize the world transform itself
    l2w_tab = frame.obj_l2w_f32 if dt == torch.float32 else frame.obj_l2w
    l2w = l2w_tab[obj].to(dt)
    pos_w, normal, tangent = _finish_world(
        l2w, attr[:, 0:3], normalize(attr[:, 3:6]), normalize(attr[:, 6:9]))
    return dict(
        position=pos_w,
        normal=normal,
        tangent=tangent,
        color=attr[:, 9:12],
        uv0=attr[:, 12:14] if k == 16 else None,
        uv1=attr[:, 14:16] if k == 16 else None,
        material=frame.obj_material[obj],
        obj=hit.obj,
        tri=hit.tri,
    )


def fill_gbuffer(scene, frame, origins, directions, *, cfg, prec, di_lights=None):
    """Trace primary rays (a coherent closest-hit launch) and produce the
    G-buffer pixel arrays (zeros on miss); `depth` is the f32 hit distance
    under shade_f32.  With `di_lights` (single-chunk scenes) the launch
    also returns round-0 shadow visibility in g["di_vis"]."""
    if di_lights is not None:
        hit, vis = trace(frame, origins, directions, cfg=cfg, prec=prec,
                         di_lights=di_lights, scene=scene)
    else:
        hit = trace(frame, origins, directions, cfg=cfg, prec=prec, scene=scene)
    attr_dt = torch.float32 if cfg.shade_f32 else prec.dtype
    attrs = interpolate_hit_attributes(scene, frame, hit, attr_dt)
    valid = hit.tri >= 0
    vz = valid[..., None]
    zero3 = torch.zeros_like(attrs["position"])
    g = dict(
        valid=valid,
        position=torch.where(vz, attrs["position"], zero3),
        normal=torch.where(vz, attrs["normal"], zero3),
        tangent=torch.where(vz, attrs["tangent"], zero3),
        color=torch.where(vz, attrs["color"], zero3),
        obj=torch.where(valid, hit.obj, 0),
        tri=torch.where(valid, hit.tri, 0),
        material=torch.where(valid, attrs["material"], 0),
        depth=torch.where(valid, hit.t, 0.0).to(attr_dt),
        t=hit.t,
    )
    if attrs["uv0"] is not None:
        for k in ("uv0", "uv1"):
            g[k] = torch.where(vz, attrs[k], torch.zeros_like(attrs[k]))
    if di_lights is not None:
        g["di_vis"] = vis
    return g, hit
