"""Trace dispatch for the dense route (port of the pieces of
`low_precision_raytracer_tpu/ops/trace.py` this path needs).

The port has one backend: the single-chunk dense trace with the fused
shadow phase (ops/dense_trace.py).  `resolve_fallback`, `di_fusible` and
`moveforward_eps` answer as the JAX package does for that route; `trace`
prepares the kernel's inputs (recentred rays, the coefficient table, the
light rows) the way `trace_rays_dense_pallas` prepares them outside its
kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from low_precision_raytracer_tpu_torch.config import Precision, RenderConfig
from low_precision_raytracer_tpu_torch.models.hierarchy import LIGHT_DIRECTIONAL
from low_precision_raytracer_tpu_torch.models.scene import (
    DENSE_CHUNK_TRIS,
    FrameInput,
    instance_tris,
)
from low_precision_raytracer_tpu_torch.ops.dense_trace import dense_trace


class Hit(NamedTuple):
    t: torch.Tensor  # (R,) f32, 1e5 on a miss
    u: torch.Tensor  # (R,) f32
    v: torch.Tensor  # (R,) f32
    tri: torch.Tensor  # (R,) i32, -1 on a miss
    obj: torch.Tensor  # (R,) i32, -1 on a miss


def resolve_fallback(fb: str, prec: Precision) -> str:
    """'auto' -> 'mxu3' for sub-fp32 dtypes on the dense route; fp32 gets
    the exact-reference 'both'."""
    if fb == "auto":
        fb = "mxu3"
    if fb == "mxu3" and prec.is_f32:
        return "both"
    return fb


def di_fusible(frame: FrameInput, cfg: RenderConfig) -> bool:
    """Can closest-hit launches carry the fused shadow phase?  True for
    single-chunk scenes with at least one light."""
    if cfg.di_fuse == "off":
        return False
    return 0 < instance_tris(frame) <= DENSE_CHUNK_TRIS and frame.n_lights > 0


def moveforward_eps(cfg: RenderConfig, prec: Precision) -> float:
    """Self-intersection epsilon of a secondary launch: origins ride
    exactly on the mxu3 dense route, so only the test's own t error needs
    clearing (`ray_moveforward_t_exact`)."""
    if prec.is_f32 or resolve_fallback(cfg.triangle_fallback, prec) != "mxu3":
        return prec.ray_moveforward_t
    return prec.ray_moveforward_t_exact


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
          prec: Precision, skip_tri=None, min_dist=0.0, max_dist=1e5,
          di_lights=None):
    """Closest-hit launch on the single-chunk dense route.
    -> (Hit, vis (R,) i32); vis is all zeros without `di_lights`."""
    if resolve_fallback(cfg.triangle_fallback, prec) != "mxu3":
        raise NotImplementedError(
            "only the mxu3 acceptance is ported (fp32 'both' / bf16 'dtype': "
            "ROADMAP queue 1 item 3)")
    if instance_tris(frame) > DENSE_CHUNK_TRIS:
        raise NotImplementedError(
            "multi-chunk scenes wait (ROADMAP queue 1 item 9)")
    f32 = torch.float32
    dev = origins.device
    R = origins.shape[0]
    TI = frame.dense_n_f32.shape[0]
    if skip_tri is None:
        skip_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    min_dist = torch.broadcast_to(torch.as_tensor(min_dist, dtype=f32, device=dev), (R,))
    max_dist = torch.broadcast_to(torch.as_tensor(max_dist, dtype=f32, device=dev), (R,))
    o = (origins.to(f32) - frame.dense_center[None, :]).contiguous()
    d = directions.to(f32).contiguous()
    coef = torch.cat([frame.dense_n_f32.reshape(TI, 9), frame.dense_e], dim=1).contiguous()
    lights = None if di_lights is None else di_light_rows(frame, di_lights)
    t, u, v, tri, obj, vis = dense_trace(
        o, d, skip_tri.to(torch.int32).contiguous(), min_dist.contiguous(),
        max_dist.contiguous(), coef, frame.dense_tri, frame.dense_obj, lights,
        d_mov=prec.ray_moveforward_t_exact,
    )
    return Hit(t=t, u=u, v=v, tri=tri, obj=obj), vis
