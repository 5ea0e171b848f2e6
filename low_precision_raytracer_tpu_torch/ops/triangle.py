"""The BVH walk's M-shift ray-triangle test (port of
`low_precision_raytracer_tpu/ops/triangle.py`), plain PyTorch.

The per-triangle matrix M (fp32, rounded to the render dtype for the
dtype path) maps (O - v2, D) to (Ox, Dx, Oy, Dy) in the render dtype and
(Oz, Dz, t) always in fp32.  Rounding-error bounds (units delta1 /
delta2) widen u and v into error_u / error_v.  `fallback='both'`: a
barycentric inside its error band re-runs the test fully in fp32, else
the band-widened dtype result is accepted; `'dtype'`: the band-widened
dtype test alone.

Every dtype operation rounds its result to the dtype (torch computes a
bf16 / fp16 op in f32 and rounds once, the correctly rounded result);
nothing is fused.  The dtype path's t is a rounded reciprocal times -Oz
(`inv_dz = 1 / Dz`, `t = -Oz * inv_dz`), the fp32 re-test's a division,
as written in the JAX package.

bf16 keeps three values in f32 where the JAX function widens a bf16
result to f32, because XLA computes it so on the CPU (its bf16
normalisation keeps the f32 value the widening would round away): the z
row takes O = o - v2 unrounded, t Dx / t Dy take Dx / Dy's last add
unrounded, and the dtype path's f32 u / v are Ox + t Dx / Oy + t Dy
unrounded (the tests themselves read the rounded u, v).  fp16, which XLA
computes natively, and fp32 have no such widening.  XLA on the CPU also
contracts an f32 or fp16 product feeding an add into one fused
multiply-add: the port does so where the f32 results decide an edge hit,
in every f32 dot product (`dot3`: the z row and the f32 re-test) and in
the re-test's u32 = t32 Dx32 + Ox32, v32 likewise (`fma`, the float64
product and sum rounded once to f32); elsewhere (the error bounds of fp32
and fp16) it rounds op by op.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from low_precision_raytracer_tpu_torch.config import Precision
from low_precision_raytracer_tpu_torch.ops.aabb import dtype_const


class TriangleHit(NamedTuple):
    accept: torch.Tensor  # bool
    t: torch.Tensor  # f32
    u: torch.Tensor  # f32
    v: torch.Tensor  # f32


def mrow_dot(m, row, vec3):
    """Row `row` of M dotted with vec3 in the dtype, keeping the three
    rounded partial products (the error bounds read them)."""
    a = vec3[..., 0] * m[..., row, 0]
    b = vec3[..., 1] * m[..., row, 1]
    c = vec3[..., 2] * m[..., row, 2]
    return a, b, c, (a + b) + c


def wide_sum(a, b, c, excess: bool):
    """(a + b) + c widened to f32: with `excess`, the last add unrounded."""
    f32 = torch.float32
    return (a + b).to(f32) + c.to(f32) if excess else ((a + b) + c).to(f32)


def fma(a, b, c):
    """a b + c rounded once to f32 (f32 operands; the exact product summed
    in float64, then rounded)."""
    return (a.double() * b.double() + c.double()).float()


def dot3(a, b):
    """An f32 dot product of 3-vectors as XLA contracts it on the CPU:
    fma(a2, b2, fma(a0, b0, a1 b1))."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 0], b[..., 0], a[..., 1] * b[..., 1]))


class TriangleParts(NamedTuple):
    """The test's result before the best_t compares: a hit is accepted
    against best_t when `base & (t < best_t) & (~ambiguous | (t32 <
    best_t))` (`accept_against`)."""

    base: torch.Tensor  # bool: every condition but the two best_t compares
    t: torch.Tensor  # f32 the dtype path's t
    t32: torch.Tensor  # f32 the f32 re-test's t (t where none runs)
    ambiguous: torch.Tensor  # bool: the f32 re-test decides
    t_out: torch.Tensor  # f32 the hit's (t, u, v)
    u_out: torch.Tensor
    v_out: torch.Tensor


def accept_against(p: TriangleParts, best_t):
    return p.base & (p.t < best_t) & (~p.ambiguous | (p.t32 < best_t))


def ray_triangle_parts(o, d, v2, m, v2_f32, m_f32, min_dist, max_dist, prec: Precision,
                       fallback: str = "both") -> TriangleParts:
    """The M-shift test without best_t (`ray_triangle`'s arguments)."""
    dt = o.dtype
    f32 = torch.float32
    dev = o.device
    excess = dt == torch.bfloat16
    O = o - v2
    ox0, ox1, ox2, Ox = mrow_dot(m, 0, O)
    dx0, dx1, dx2, Dx = mrow_dot(m, 0, d)
    oy0, oy1, oy2, Oy = mrow_dot(m, 1, O)
    dy0, dy1, dy2, Dy = mrow_dot(m, 1, d)
    # (Oz, Dz, t) always in fp32
    m2f = m[..., 2, :].to(f32)
    Oz = dot3(o.to(f32) - v2.to(f32) if excess else O.to(f32), m2f)
    Dz = dot3(d.to(f32), m2f)
    inv_dz = 1.0 / Dz
    t = -Oz * inv_dz
    t_dx = (t * wide_sum(dx0, dx1, dx2, excess)).to(dt)
    t_dy = (t * wide_sum(dy0, dy1, dy2, excess)).to(dt)
    u = Ox + t_dx
    v = Oy + t_dy
    # the f32 u, v a hit reports
    wide = lambda a, b: a.to(f32) + b.to(f32) if excess else (a + b).to(f32)
    u_f32, v_f32 = wide(Ox, t_dx), wide(Oy, t_dy)

    c = lambda x: dtype_const(x, dt).to(dev)
    d1, d2 = c(prec.delta1), c(prec.delta2)
    t_dt = t.to(dt)

    def err3(a, b, cc):
        s = (a.abs() + b.abs()) + cc.abs()
        return d1 * s + d2 * s

    e_ox, e_dx = err3(ox0, ox1, ox2), err3(dx0, dx1, dx2)
    e_oy, e_dy = err3(oy0, oy1, oy2), err3(dy0, dy1, dy2)
    point2, three, one, zero = c(0.2), c(3.0), c(1.0), c(0.0)
    error_u = ((e_ox + t_dt * e_dx) + d1 * (Ox.abs() + three * t_dx.abs())) * point2
    error_v = ((e_oy + t_dt * e_dy) + d1 * (Oy.abs() + three * t_dy.abs())) * point2

    in_range = (t > min_dist) & (t < max_dist)
    w = (one - u) - v
    in_band = lambda x, e: (x >= -e) & (x <= zero)
    dtype_accept = (u > -error_u) & (v > -error_v) & (u + v < (one + error_u) + error_v)
    if fallback == "dtype":
        no = torch.zeros_like(in_range)
        return TriangleParts(in_range & dtype_accept, t, t, no, t, u_f32, v_f32)
    ambiguous = in_band(u, error_u) | in_band(v, error_v) | in_band(w, error_v + error_u)

    # the full fp32 re-test, of the dtype-space local ray
    O32 = o.to(f32) - v2_f32
    D32 = d.to(f32)
    Ox32, Dx32 = dot3(O32, m_f32[..., 0, :]), dot3(D32, m_f32[..., 0, :])
    Oy32, Dy32 = dot3(O32, m_f32[..., 1, :]), dot3(D32, m_f32[..., 1, :])
    Oz32, Dz32 = dot3(O32, m_f32[..., 2, :]), dot3(D32, m_f32[..., 2, :])
    t32 = -Oz32 / Dz32
    u32 = fma(t32, Dx32, Ox32)
    v32 = fma(t32, Dy32, Oy32)
    ok32 = ((t32 > min_dist) & (t32 < max_dist) & (u32 > 0) & (v32 > 0) & (u32 + v32 < 1))
    base = in_range & torch.where(ambiguous, ok32, dtype_accept)
    return TriangleParts(base, t, torch.where(ambiguous, t32, t), ambiguous,
                         torch.where(ambiguous, t32, t), torch.where(ambiguous, u32, u_f32),
                         torch.where(ambiguous, v32, v_f32))


def ray_triangle(o, d, v2, m, v2_f32, m_f32, best_t, min_dist, max_dist, prec: Precision,
                 fallback: str = "both") -> TriangleHit:
    """Batched M-shift test.  o, d (..., 3) local rays in the render dtype;
    v2 (..., 3) / m (..., 3, 3) in the dtype, v2_f32 / m_f32 their fp32
    shadows (unused under 'dtype'); best_t, min_dist, max_dist (...) f32.
    -> accept and fp32 (t, u, v); best_t is not updated."""
    p = ray_triangle_parts(o, d, v2, m, v2_f32, m_f32, min_dist, max_dist, prec, fallback)
    return TriangleHit(accept_against(p, best_t), p.t_out, p.u_out, p.v_out)
