"""Ray-AABB slab tests of the BVH walk (port of
`low_precision_raytracer_tpu/ops/aabb.py`), plain PyTorch.

Two variants with different slop, as in the JAX package:
- the scene (TLAS) test accepts ``t1max <= t2min + slop_add``;
- the object (BLAS) test accepts ``t1max <= t2min * slop_mul``.
The slops are the JAX package's `Precision` defaults (`SCENE_SLOP`,
`OBJECT_SLOP`), the same in every precision.

Both skip axes whose slab distances are not finite (a zero direction
component, or an fp16 quotient that overflows) and fail when no axis is
finite.  Every operation runs in the ray's dtype, rounded as it goes; the
"no finite axis" sentinels are the f32 maximum cast to that dtype, which is
inf in bf16 and fp16.  Vectorised over leading dims (rays (..., 3)
against boxes (..., 3)).
"""

from __future__ import annotations

import torch

SCENE_SLOP = 0.02
OBJECT_SLOP = 1.001953


def dtype_const(x: float, dt: torch.dtype) -> torch.Tensor:
    """A Python float rounded to `dt` once, from its float64 value."""
    return torch.tensor(x, dtype=torch.float64).to(dt)


def slab(o, d, lo, hi):
    """-> (t1max, t2min, updated) in the rays' dtype."""
    t1 = (lo - o) / d
    t2 = (hi - o) / d
    a = torch.minimum(t1, t2)
    b = torch.maximum(t1, t2)
    finite = torch.isfinite(a) & torch.isfinite(b)
    big = dtype_const(torch.finfo(torch.float32).max, o.dtype).to(o.device)
    t1max = torch.where(finite, a, -big).amax(dim=-1)
    t2min = torch.where(finite, b, big).amin(dim=-1)
    return t1max, t2min, finite.any(dim=-1)


def ray_aabb_scene(o, d, lo, hi, slop_add=SCENE_SLOP):
    """TLAS slab test -> (hit, t1max, t2min)."""
    t1max, t2min, updated = slab(o, d, lo, hi)
    s = dtype_const(slop_add, o.dtype).to(o.device)
    hit = updated & (t1max <= t2min + s) & (0 <= t2min + s)
    return hit, t1max, t2min


def ray_aabb_object(o, d, lo, hi, slop_mul=OBJECT_SLOP):
    """BLAS slab test -> (hit, t1max, t2min)."""
    t1max, t2min, updated = slab(o, d, lo, hi)
    s = dtype_const(slop_mul, o.dtype).to(o.device)
    hit = updated & (t1max <= t2min * s) & (0 <= t2min)
    return hit, t1max, t2min
