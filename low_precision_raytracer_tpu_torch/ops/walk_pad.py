"""The pad of the BVH walk's exact zero-axis rule (`csrc/bvh_walk.cu`,
`bvh_walk_stack`): how far outside a BLAS box, along an axis a on which a
ray's object-space direction is exactly 0, the walk's triangle test
(`ops/triangle.py`, the M-shift test with its error band) can accept a
point.  Such a ray keeps o_a on its whole length, so a box it does not
reach within the pad on a holds no triangle the test accepts, at any
best t: the walk may skip it and keep every hit, every tie and every
any-hit choice of the JAX walk.  The proof is in `csrc/bvh_walk.cu` beside
the rule; here is its arithmetic, in float64 on the host, once a table.

Per triangle and per branch of the test (the dtype test, and under 'both'
the f32 re-test), a pad on each axis a that is linear in the ray's
X = (1, O_0, O_1, O_2, T_0, T_1, T_2, T_t), O_i = |o_i| and T_i = |t|
|d_i|, T_t = |t| (o, d the ray in object space in the dtype's values, t
the accepted point's parameter):
  pad_a = dev_a + S_a dS(X) + Q_a Z(X) + eO (|o_a| + |v2_a|) + eta,
dS bounding the sum of how far the three exact barycentrics of the
computed point fall below 0, Z its exact distance from the plane in the
row's z units, S_a the triangle's extent on a and Q_a |N_a2| (N the
inverse of the row's M, its triangle's vertices v2 + N e_k), dev_a how far
those vertices lie outside the leaf's box, eO the rounding of O = o - v2.
A leaf takes the largest coefficients of its triangles, a node the largest
of its children's (plus any excess of a child's box over its own), so a
node's grown box holds every grown box below it.  Each node then keeps
four f32 numbers (`node_pads`): c0 the largest constant over its axes, cO
the largest O_i coefficient, cT the largest T_i one, ct the largest T_t
one, each grown by 2^-16 and rounded up; the walk grows a box by
  pad = c0 + cO Os + |t| (cT Ds + ct),  Os = sum |o_i|, Ds = sum |d_i|,
at |t| no larger than the ray's reach and the box's own bound on it
(`rule_enters`, the kernel's float64 arithmetic op for op).

A triangle whose rows are not all finite or hold an entry above 2^40, or
whose M has no well-conditioned inverse, gets an infinite pad: the rule
then never skips a box above it.  fp16 'dtype' takes no rule
(`rule_form`): its band eu can overflow fp16 to inf, and then the test
accepts any finite (u, v).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from low_precision_raytracer_tpu_torch.ops.aabb import dtype_const
from low_precision_raytracer_tpu_torch.ops.band_pad import _outward

U32 = 2.0**-24
ETA32 = 2.0**-150
# (unit roundoff, half the smallest subnormal) of each render dtype
ROUNDING = {torch.bfloat16: (2.0**-8, 2.0**-134), torch.float16: (2.0**-11, 2.0**-25),
            torch.float32: (U32, ETA32)}
MAG = 2.0**40  # the largest row entry, Os, Ds and reach the proof admits
REL_MARGIN = 2.0**-16  # the host's float64 rounding, relative
ABS_MARGIN = 2.0**-40  # ... and of the kernel's float64 compares, times the box's size
TB_MARGIN = 1.0 + 2.0**-40  # the kernel's rounding of a box's bound on |t|
N_COEF = 8


def gamma(k: int, e: float) -> float:
    return k * e / (1 - k * e)


def rule_form(dtype: torch.dtype, fallback: str) -> bool:
    """Does this (dtype, fallback) take the zero-axis rule?"""
    return not (dtype == torch.float16 and fallback == "dtype")


def _inverse(m64):
    """-> (N, eN): the float64 inverse of each (T, 3, 3) matrix and a bound
    on each entry's error from its residual (inf where it is not < 1/2)."""
    n, info = torch.linalg.inv_ex(m64)
    eye = torch.eye(3, dtype=m64.dtype, device=m64.device)
    res = (eye - m64 @ n).abs().sum(dim=2).amax(dim=1)
    res = res + 8 * 2.0**-53 * (m64.abs() @ n.abs()).sum(dim=2).amax(dim=1)
    norm = n.abs().sum(dim=2).amax(dim=1)
    en = norm * res / (1 - res) * (1 + 2.0**-40)
    bad = (info != 0) | ~(res < 0.5) | ~torch.isfinite(en)
    return n, torch.where(bad, float("inf"), en)


def _geometry(v2, m64):
    """Per triangle: (S (T, 3), Q (T, 3), vlo (T, 3), vhi (T, 3), eN (T,))
    of the triangle the rows describe (vertices v2 + N e_k, widened by eN)."""
    n, en = _inverse(m64)
    verts = torch.stack([v2 + n[:, :, 0], v2 + n[:, :, 1], v2], dim=2)  # (T, 3 axes, 3)
    vlo = verts.amin(dim=2) - en[:, None]
    vhi = verts.amax(dim=2) + en[:, None]
    return vhi - vlo, n[:, :, 2].abs() + en[:, None], vlo, vhi, en


def _branch(v2, m64, e: float, eta: float, dtype_path: bool, prec, dt):
    """(T, 3, 8) float64: the branch's pad coefficients without dev_a, and
    (vlo, vhi) (T, 3) of its triangles (see the module docstring and the
    proof in csrc/bvh_walk.cu)."""
    T = v2.shape[0]
    f64 = torch.float64
    am = m64.abs()
    av2 = v2.abs()
    kappa = (1 + U32) * (1 + e)
    zero = torch.zeros((T, N_COEF), dtype=f64, device=v2.device)
    eta_t = zero.clone()
    eta_t[:, 0] = 1.0
    eta_t[:, 7] = 1.0

    def sa(row):  # sum_i |m_i| |O_i|, |O_i| <= kappa (|o_i| + |v2_i|) + eta
        x = zero.clone()
        x[:, 0] = (am[:, row] * (kappa * av2 + eta)).sum(dim=1)
        x[:, 1:4] = kappa * am[:, row]
        return x

    def sb(row):  # |t| sum_i |m_i| |d_i|
        x = zero.clone()
        x[:, 4:7] = am[:, row]
        return x

    if dtype_path:
        c = lambda v: float(dtype_const(v, dt))
        D1, D2, P2 = c(prec.delta1), c(prec.delta2), c(0.2)
        # H >= eu + ev (computed), E >= |u - u*| + |v - v*|
        H = sum((1 + gamma(16, e)) * P2 * ((2 * D1 + D2) * sa(x) + (4 * D1 + D2) * sb(x))
                for x in (0, 1)) + 32 * eta * eta_t
        E = (sum(gamma(3, e) * sa(x) + gamma(4, e) * sb(x) for x in (0, 1))
             + 16 * eta * eta_t)
        unit = zero.clone()
        unit[:, 0] = 1.0
        E = E + 2 * (e / (1 - e)) * (1 + gamma(3, e)) * (unit + 2 * H)
        dsum = (2 + gamma(3, e)) * H + 2 * E + gamma(3, e) * unit
        zrel = gamma(3, U32) + (e if dt == torch.bfloat16 else 0.0)
    else:  # the f32 re-test: u32, v32 > 0 and u32 + v32 < 1
        E = sum(gamma(3, U32) * (sa(x) + sb(x)) for x in (0, 1)) + 8 * ETA32 * eta_t
        E[:, 0] += 2 * U32 / (1 - U32)
        dsum = 2 * E
        zrel = gamma(3, U32)
    # Z >= |z*| of the computed point
    Z = gamma(7, U32) * sb(2)
    Z[:, 0] += zrel * (1 + U32) * (am[:, 2] * av2).sum(dim=1)
    Z[:, 1:4] += zrel * (1 + U32) * am[:, 2]
    Z = Z + (8 * ETA32 + eta) * (1 + am[:, 2].sum(dim=1))[:, None] * eta_t
    S, Q, vlo, vhi, _en = _geometry(v2, m64)
    out = S[:, :, None] * dsum[:, None, :] + Q[:, :, None] * Z[:, None, :]
    eo = kappa - 1
    out[:, :, 0] += eo * av2 + eta
    for a in range(3):
        out[:, a, 1 + a] += eo
    return out, vlo, vhi


def _rows_ok(*xs):
    ok = None
    for x in xs:
        x = x.reshape(x.shape[0], -1)
        good = (torch.isfinite(x) & (x.abs() <= MAG)).all(dim=1)
        ok = good if ok is None else ok & good
    return ok


def node_depth(parent) -> torch.Tensor:
    """(N,) the number of edges from its root to each node of a forest
    given by its parent links (-1 at the roots)."""
    parent = parent.long()
    p = parent.clone()
    depth = torch.zeros_like(p)
    while bool((p >= 0).any()):
        depth += (p >= 0).long()
        p = torch.where(p >= 0, parent[p.clamp(min=0)], -1)
    return depth


def _amax_into(dst, idx, src):
    """dst[idx[k]] = max(dst[idx[k]], src[k]), elementwise."""
    flat = src.reshape(src.shape[0], -1)
    dst.view(dst.shape[0], -1).scatter_reduce_(0, idx[:, None].expand_as(flat), flat, "amax")


def node_pads(scene, prec, fallback: str) -> torch.Tensor:
    """(NB, 4) f32 (c0, cO, cT, ct) of every BLAS node (module docstring),
    rounded up; inf where the rule must never skip the node."""
    f64 = torch.float64
    dt = prec.dtype
    e, eta = ROUNDING[dt]
    v2 = scene.tri_v2.to(f64)
    m = scene.tri_m.to(f64).reshape(-1, 3, 3)
    v2f = scene.tri_v2_f32.to(f64)
    mf = scene.tri_m_f32.to(f64).reshape(-1, 3, 3)
    ok = _rows_ok(v2, m)
    parts = [_branch(v2, m, e, eta, True, prec, dt)]
    if fallback == "both":
        ok = ok & _rows_ok(v2f, mf)
        parts.append(_branch(v2f, mf, U32, ETA32, False, prec, dt))
    lo = scene.blas_lo.to(f64)
    hi = scene.blas_hi.to(f64)
    NB = lo.shape[0]
    dev_ = lo.device
    # the leaves' entries: (node, triangle)
    cnt = scene.blas_leaf_count.long()
    node = torch.repeat_interleave(torch.arange(NB, device=dev_), cnt)
    first = torch.repeat_interleave(scene.blas_leaf_offset.long(), cnt)
    slot = torch.arange(node.numel(), device=dev_) - torch.repeat_interleave(
        torch.cumsum(cnt, 0) - cnt, cnt)
    tri = scene.blas_prim.long()[first + slot]
    coef = None
    for c, vlo, vhi in parts:
        dev_a = torch.maximum(torch.maximum(lo[node] - vlo[tri], vhi[tri] - hi[node]),
                              torch.zeros_like(vlo[tri]))
        x = c[tri].clone()
        x[:, :, 0] += dev_a
        coef = x if coef is None else torch.maximum(coef, x)
    bad = ~ok[tri] | ~torch.isfinite(coef).flatten(1).all(dim=1)
    coef = torch.where(bad[:, None, None], float("inf"), coef)
    nodes = torch.zeros((NB, 3, N_COEF), dtype=f64, device=dev_)
    _amax_into(nodes, node, coef)
    # up the tree, deepest first: a node takes the largest of its
    # children's, plus any excess of the child's box over its own
    parent = scene.blas_parent.long()
    depth = node_depth(parent)
    for dd in range(int(depth.max()) if NB else 0, 0, -1):
        kids = torch.nonzero(depth == dd).flatten()
        par = parent[kids]
        x = nodes[kids].clone()
        x[:, :, 0] += torch.maximum(torch.maximum(lo[par] - lo[kids], hi[kids] - hi[par]),
                                    torch.zeros_like(lo[kids]))
        _amax_into(nodes, par, x)
    size = torch.maximum(lo.abs(), hi.abs()).amax(dim=1)
    four = torch.stack([nodes[:, :, 0].amax(dim=1) + ABS_MARGIN * size,
                        nodes[:, :, 1:4].amax(dim=(1, 2)), nodes[:, :, 4:7].amax(dim=(1, 2)),
                        nodes[:, :, 7].amax(dim=1)], dim=1) * (1 + REL_MARGIN)
    four = torch.where(torch.isfinite(four), four, float("inf"))
    return _outward(four, False).contiguous()


class Reach(NamedTuple):
    """A ray's numbers for the rule (float64, (R,) each; `ray_reach`)."""

    Os: torch.Tensor  # sum |o_i|, as (|o_0| + |o_1|) + |o_2|
    Ds: torch.Tensor  # sum |d_i|, likewise
    R: torch.Tensor  # max(|mind|, |maxd|): no accepted point lies past |t| = R
    amind: torch.Tensor  # |mind|
    ok: torch.Tensor  # bool: the rule may apply (finite ray, Os, Ds, R <= MAG)


def ray_reach(o, d, mind, maxd) -> Reach:
    """The rule's numbers of rays o / d (R, 3) in the dtype's values (any
    float type), mind / maxd (R,) f32."""
    f64 = torch.float64
    ao, ad = o.to(f64).abs(), d.to(f64).abs()
    Os = (ao[:, 0] + ao[:, 1]) + ao[:, 2]
    Ds = (ad[:, 0] + ad[:, 1]) + ad[:, 2]
    amind = mind.to(f64).abs()
    R = torch.maximum(amind, maxd.to(f64).abs())
    ok = (torch.isfinite(o).all(dim=1) & torch.isfinite(d).all(dim=1) & (Os <= MAG)
          & (Ds <= MAG) & (R <= MAG))
    return Reach(Os, Ds, R, amind, ok)


def box_pad(o, d, lo, hi, pad4, reach: Reach, tr):
    """(n,) float64: the pad of boxes (n, 3) lo / hi for their rays (n, 3)
    o / d in the dtype's values, pad4 (n, 4) f32 the boxes' `node_pads`,
    `reach` the rays' `ray_reach`, tr (n,) float64 their bound on |t|:
    P0 + min(tr, tb) P1, tb the box's own bound on |t| (module docstring),
    the kernel's float64 arithmetic op for op."""
    f64 = torch.float64
    c = pad4.to(f64)
    P0 = c[:, 0] + c[:, 1] * reach.Os
    P1 = c[:, 2] * reach.Ds + c[:, 3]
    o64, lo64, hi64 = o.to(f64), lo.to(f64), hi.to(f64)
    ad = d.to(f64).abs()
    b = ad.argmax(dim=1, keepdim=True)  # the first of equal largest
    ob = o64.gather(1, b)[:, 0]
    W = torch.maximum(hi64.gather(1, b)[:, 0] - ob, ob - lo64.gather(1, b)[:, 0])
    den = ad.gather(1, b)[:, 0] - P1
    tb = (W + P0) / torch.where(den > 0, den, 1.0) * TB_MARGIN
    tt = torch.where(den > 0, torch.minimum(tr, tb), tr)
    return P0 + tt * P1


def rule_enters(o, d, lo, hi, pad4, reach: Reach, best_t, find_any: bool):
    """The rule's verdict on boxes (n, 3) lo / hi for their rays (n, 3) o /
    d in the dtype's values: False where an axis with d_a == 0 exactly has
    o_a outside [lo_a - pad, hi_a + pad] (`box_pad`); the kernel's
    float64 arithmetic op for op (`csrc/bvh_walk.cu:rule_enters`).  pad4
    (n, 4) f32 the boxes' `node_pads`, `reach` their rays' `ray_reach`,
    best_t (n,) f32 their best t (closest hit: |t| <= max(|mind|,
    |best_t|) of a hit that can still win)."""
    f64 = torch.float64
    tr = reach.R
    if not find_any:
        tr = torch.minimum(tr, torch.maximum(reach.amind, best_t.to(f64).abs()))
    pad = box_pad(o, d, lo, hi, pad4, reach, tr)[:, None]
    o64 = o.to(f64)
    out = (o64 < lo.to(f64) - pad) | (o64 > hi.to(f64) + pad)
    return ~(reach.ok & ((d == 0) & out).any(dim=1))
