"""The pad that keeps K1b's and K6's tree walks exact under a widened
acceptance (the sub-f32 error bands and 'dtype', `Band.widened`).

A widened test accepts points outside its triangle, so outside the boxes
the strict walks cull by (`models/scene.py:_group_aabbs` widens them only
for the strict test's rounding).  This module bounds how far outside, and
grows each box by that much, so that the walks may cull by the grown boxes
and still keep every hit the all-row scan keeps.  The proof is in
`csrc/chunk_walk.cuh` beside the walk; here is its arithmetic.

**Where an accepted point lies.**  A row's f32 coefficients (n, e) map a
point P to its edge coordinates (u, v, z) = n P + e; their inverse maps
(u, v, 0) to u V0 + v V1 + w V2 (w = 1 - u - v), the vertices of the
triangle the f32 row describes: V2 = -n^-1 e, V0 - V2 and V1 - V2 the
first two columns of n^-1 (`row_spans`).  If u, v, w >= -du, -dv, -dw,
then on each axis a, P_a lies within (du + dv + dw) span_a of that
triangle's vertex range, span_a its extent on a (P_a - min_a = u (V0_a -
min_a) + v (V1_a - min_a) + w (V2_a - min_a), and only the negative
coefficients can pull it below).  The accepted point P = o + t d sits on
the f32 plane up to the rounding of t, exactly as under the strict test,
whose tolerance the boxes' widening already covers.

**How far the computed u is from P's.**  The kernel's u (`tri_test_oz`)
differs from u*(P) = n0 . P + e0 by at most
  dev_u = sum_i c_i (O_i + T_i) + |b3 - e0| + g |b3| + eta sum_i |b_i| (1 + T_t),
  c_i = |b_i - n_i| + (eps_q + g) |b_i|,
with, per row, b the operand's u row (the band rows of a sub-f32 form; in
fp32 the f32 row itself, so b = n and b3 = e0), and per ray O_i >= |o_i|
and |q_i| (q the ray rounded to the operand type), T_i >= |t| |d_i| and
|t| |q_i'| (q' the rounded direction), T_t >= |t|: eps_q the operand
type's unit roundoff (2^-8 bf16, 2^-11 fp16, 0 f32), eta its subnormal
half-spacing (|q_i - o_i| <= eps_q |o_i| + eta), g = gamma_8 of f32 (every
sum of the test rounds in f32; the sub-f32 products are exact in f32).

**How far the band reaches.**  Under 'dtype' (FLAG_DTYPE) the test accepts
u > -eu; the kernel's eu is at most
  reach_u = (1 + g) [sum_i ((KA a_i + K1 |b_i|) O_i + (KA a_i + K3 |b_i|) T_i)
                     + KA a3 + K1 |b3|],
a the S row of u (the band rows' S columns in a sub-f32 form; in fp32
|n_i| k0 rounded, or |n_i|), (KA, K1, K3) = (1, c1, c3) in the dense
kernels' band and (0.2 d12, 0.2 d1, 0.6 d1) in the packet kernel's.  Under
'both' a lane outside the band passes only where u, v and w all compute
> 0 (reach 0), and a lane inside it takes the strict f32 test (the
widening's case).

So du = reach_u + dev_u (and dv the same with the v rows), dw <= du + dv
plus the rounding of w and of the compare, and a point accepted by the
row lies within
  pad_a = Delta span_a,  Delta = 2 (1 + 2^-16) (du + dv) + 2^-20
of the row's vertex range on axis a (the 2^-16 and 2^-20 cover that
rounding: |u|, |v| <= 1 + 2 (eu + ev) at an accepted point).  Delta is
linear in X = (1, O_0, O_1, O_2, T_0, T_1, T_2, T_t): the row's
`row_coeffs`, times span_a its `row_pads`.  A box takes the largest of its
rows' coefficients, a tree node the largest of its children's
(`tree_pads`), so a node's grown box holds every grown box below it.

**Per ray** (`ray_pads`, `pad_t`): the walk grows each box it tests for
the ray it tests it for.  A box's pad on every axis is at most
  p = c0 + cO Os + tr (cT Ds + ct),
from the box's four numbers (`box_pad4`: c0 the largest constant over its
axes, cO the largest O_i coefficient over its axes and i, cT the largest
T_i one, ct the largest T_t one; so sum_i C_ai O_i <= cO Os) and the ray's
Os = sum_i O_i, Ds = sum_i (|d_i| (1 + eps_q) + eta) (so T_i = tr (|d_i|
(1 + eps_q) + eta), summed, is at most tr Ds), where tr >= |t| of every
accepted point the walk still has to keep:
- in any hit and under the packed epilogue, the ray's reach: |t| <
  max(|mind|, |maxd|), and from the scene, on each axis a where |d_a| >
  P1_a, |t| <= (W_a + P0_a) / (|d_a| - P1_a): an accepted point lies in
  the root box grown by its pad at |t|, P0_a + P1_a |t| on axis a (P0_a =
  C_a0 + sum_i C_ai O_i, P1_a = sum_i C_a,4+i (|d_i| (1 + eps_q) + eta) +
  C_a7, the root's coefficients at the ray's own values), and |t| |d_a|
  from the origin on a, W_a the distance from the origin to the root box's
  far side on a;
- in closest hit, no farther than max(|mind|, the best t so far) either: a
  hit that can still win has t <= the best t (ties included), and a pad
  grows with |t|, so a box grown at the best t holds it; the best t starts
  at the miss value 1e5, which no winning hit reaches.
A box also bounds |t| of an accepted point inside it by itself: the
point lies in the box grown by P0 + P1 |t| (P0 = c0 + cO Os, P1 = cT Ds +
ct), and |t| |d_a| from o on the ray's longest axis a, so |t| <= (W_a +
P0) / (|d_a| - P1) where |d_a| > P1, W_a the distance from o to the box's
far side on a; the pad is taken at the smaller of this and tr, so a box
near the origin grows little even before the first hit.  The ray's
numbers are computed in float64 and rounded up to f32, the box's too; the
kernel rounds each step the way that grows the box and the bounds
outward, so it tests a box at least as large as this grown one (`grow`,
the plain version).  The wrapper raises (`check_reach`)
where a live ray's largest pad is not finite or would make the slab
distances on the ray's longest axis overflow, since the slab test enters
no box whose slab distances are all infinite: possible only where the
caller passes maxd = inf and the scene bound fails (the render paths cap
every launch), or for a direction too short to reach past the scene.

Rays with a non-finite origin or direction component, or a zero
direction, accept nothing (their t or u is not finite).  A row whose
plane columns (6, 7, 8, 11) are not all finite, as the row of a triangle
with no area is, accepts nothing: a finite ray's t = -Oz / Dz is then NaN
or infinite (a non-finite n_2i makes both Oz and Dz infinite or NaN, or
one of them NaN through a zero component; a non-finite e_2 alone makes Oz
so and Dz finite), and the kernels accept a finite t only; its pad is 0.
Any other row whose pad is not finite (its edge rows overflow, or n has
no inverse) takes B_a + O_a + T_a, B_a the largest |bound| of any box the
walk reads on axis a: then every box above it holds every point the ray
reaches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from low_precision_raytracer_tpu_torch.ops.dense_trace import (
    CHUNK,
    FAN,
    SLICE,
    FLAG_DTYPE,
    KIND_DENSE,
    Band,
    BoxTree,
)

U32 = 2.0**-24
GAMMA = 8 * U32 / (1 - 8 * U32)  # gamma_8 of f32
REL_MARGIN = 2.0**-16  # the rounding of w and of the dtype compare, relative
ABS_MARGIN = 2.0**-20  # ... and absolute, in barycentric units
PLANE_COLS = [6, 7, 8, 11]  # t = -Oz / Dz reads these columns alone


def operand_eps(band: Band):
    """(eps_q, eta) of the form's ray operand: unit roundoff and subnormal
    half-spacing of its type; (0, 0) for f32 rows."""
    if band.operand is torch.bfloat16:  # 8 significant bits: 1 + 2^-8 rounds to 1
        return 2.0**-8, 2.0**-134
    if band.operand is torch.float16:
        return 2.0**-11, 2.0**-25
    return 0.0, 0.0


def band_consts(band: Band):
    """(KA, K1, K3): how eu weighs the S sums, |Ox| and |t Dx|."""
    if band.kind == KIND_DENSE:
        return 1.0, float(band.k1), float(band.k2)
    return 0.2 * float(band.k0), 0.2 * float(band.k1), 0.6 * float(band.k1)


def row_spans(coef) -> torch.Tensor:
    """(TI, 3) float64: per axis, the extent of the triangle each f32 row
    describes (its vertices from the inverse of n); inf where n has no
    finite inverse."""
    n = coef[:, :9].to(torch.float64).reshape(-1, 3, 3)
    inv, info = torch.linalg.inv_ex(n)
    e0, e1 = inv[:, :, 0], inv[:, :, 1]  # V0 - V2, V1 - V2
    z = torch.zeros_like(e0)
    span = torch.maximum(torch.maximum(z, e0), e1) - torch.minimum(torch.minimum(z, e0), e1)
    bad = (info != 0) | ~torch.isfinite(span).all(dim=1)
    return torch.where(bad[:, None], float("inf"), span)


N_COEF = 8  # X = (1, O_0, O_1, O_2, T_0, T_1, T_2, T_t)


def row_coeffs(coef, band: Band) -> torch.Tensor:
    """(TI, 8) float64: the row's Delta = coeffs . X (see the module
    docstring)."""
    c = coef.to(torch.float64)
    eps_q, eta = operand_eps(band)
    KA, K1, K3 = band_consts(band)
    dtype_only = bool(band.form & FLAG_DTYPE)
    out = torch.zeros((c.shape[0], N_COEF), dtype=torch.float64, device=c.device)
    for x in range(2):  # u, then v
        n = c[:, 3 * x:3 * x + 3]
        e = c[:, 9 + x]
        if band.operand is not None:
            b = c[:, 12 + 4 * x:15 + 4 * x]
            b3 = c[:, 15 + 4 * x]
            a = c[:, 20 + 4 * x:23 + 4 * x]
            a3 = c[:, 23 + 4 * x]
        else:  # the kernel's S row from the f32 row: |n| k0 (dense, rounded) or |n|
            b, b3 = n, e
            cf = coef[:, [3 * x, 3 * x + 1, 3 * x + 2, 9 + x]].abs()
            if band.kind == KIND_DENSE:
                cf = cf * torch.tensor(band.k0, dtype=torch.float32, device=coef.device)
            a, a3 = cf[:, :3].to(torch.float64), cf[:, 3].to(torch.float64)
        ab, aa = b.abs(), a.abs()
        ci = (b - n).abs() + (eps_q + GAMMA) * ab
        eb = eta * ab.sum(dim=1)
        out[:, 0] += (b3 - e).abs() + GAMMA * b3.abs() + eb
        out[:, 1:4] += ci
        out[:, 4:7] += ci
        out[:, 7] += eb
        if dtype_only:
            g = 1 + GAMMA
            out[:, 0] += g * (KA * a3.abs() + K1 * b3.abs())
            out[:, 1:4] += g * (KA * aa + K1 * ab)
            out[:, 4:7] += g * (KA * aa + K3 * ab)
    out *= 2 * (1 + REL_MARGIN)
    out[:, 0] += ABS_MARGIN
    return out


def row_pads(coef, band: Band, bound) -> torch.Tensor:
    """(TI, 3, 8) float64: per row and axis a, coeffs span_a; 0 for a row
    that accepts nothing (its plane columns not all finite); for a row
    whose pad is not finite, bound_a + O_a + T_a (`bound` (3,): the
    largest |bound| of any box the walk reads, per axis)."""
    p = row_spans(coef)[:, :, None] * row_coeffs(coef, band)[:, None, :]
    unbounded = torch.zeros_like(p[:1])
    unbounded[0, :, 0] = bound.to(p.dtype)
    unbounded[0, :, 1:7] = 1.0
    p = torch.where(torch.isfinite(p).flatten(1).all(dim=1)[:, None, None], p, unbounded)
    dead = ~torch.isfinite(coef[:, PLANE_COLS]).all(dim=1)
    return torch.where(dead[:, None, None], 0.0, p)


def group_max(x, n: int) -> torch.Tensor:
    """The largest of each `n` consecutive rows of x (rows, ...), the last
    group padded with zeros."""
    pad = (-x.shape[0]) % n
    x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, pad))
    return x.reshape(-1, n, *x.shape[1:]).amax(dim=1)


def tree_pads(leaf_pads, tree: BoxTree) -> torch.Tensor:
    """The coefficients of every node of `tree` (in `tree.boxes` order, root
    level first) from those of its leaf boxes: a node takes the largest of
    its children's, as `build_tree` takes the union of their boxes."""
    levels = [leaf_pads[:tree.sizes[0]]]
    while levels[-1].shape[0] > 1:
        levels.append(group_max(levels[-1], FAN))
    return torch.cat(list(reversed(levels)))


def _outward(x64, down: bool):
    """float64 -> f32 rounded toward -inf (`down`) or +inf."""
    x = x64.to(torch.float32)
    inf = torch.full_like(x, float("-inf") if down else float("inf"))
    wrong = (x.to(torch.float64) > x64) if down else (x.to(torch.float64) < x64)
    return torch.where(wrong, torch.nextafter(x, inf), x)


def box_pad4(pads) -> torch.Tensor:
    """(n, 4) f32 (c0, cO, cT, ct) of boxes with coefficients (n, 3, 8):
    the largest constant, O_i, T_i and T_t coefficient over the axes (and
    i), rounded up."""
    c = torch.stack([pads[:, :, 0].amax(dim=1), pads[:, :, 1:4].amax(dim=(1, 2)),
                     pads[:, :, 4:7].amax(dim=(1, 2)), pads[:, :, 7].amax(dim=1)], dim=1)
    return _outward(c, False).contiguous()


class BandPads(NamedTuple):
    """A table's pads under one widened band (see the module docstring)."""

    tree: torch.Tensor  # (n, 4) f32 box_pad4 of the walk's tree boxes, in `tree.boxes` order
    slices: torch.Tensor  # (4 NC, 4) f32 ... of the 32-row slice boxes (K6: the tree's leaves)
    root: torch.Tensor  # (3, 8) float64 the root's coefficients per axis (the scene bound)
    bound: torch.Tensor  # (3,) float64 the largest |bound| of the boxes, per axis


def band_pads(coef, band: Band, tree: BoxTree, slices=None) -> BandPads:
    """The pads of `tree` (leaves of `tree.leaf` rows) and of the 32-row
    slices of the table `coef` under `band` (4 a 128-row chunk, as
    `slice_table` lays them out; `slices` their boxes, for the bound, when
    they are not the tree's leaves); raises if a box's pad does not fit in
    f32."""
    used = -(-coef.shape[0] // SLICE)  # not the empty slices past TI
    boxes = tree.boxes if slices is None else torch.cat([tree.boxes, slices[:used]])
    bound = boxes.to(torch.float64).abs().reshape(-1, 2, 3).amax(dim=(0, 1))
    rows = row_pads(coef, band, bound)
    rows = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, (-rows.shape[0]) % CHUNK))
    nodes = tree_pads(group_max(rows, tree.leaf), tree)
    out = BandPads(box_pad4(nodes), box_pad4(group_max(rows, SLICE)), nodes[0], bound)
    if not (bool(torch.isfinite(out.tree).all()) and bool(torch.isfinite(out.slices).all())):
        raise ValueError("band_pad: a box's pad under this band does not fit in f32")
    return out


def ray_pads(o, d, mind, maxd, band: Band, root_box, root) -> torch.Tensor:
    """(R, 4) f32 (Os, Ds, reach, 0) of each ray (see the module docstring),
    rounded up: reach bounds |t| of any point the ray accepts (inf where
    neither maxd nor the scene bounds it); 0 for a ray with a non-finite
    component.  root_box (6,): the tree's root box, root (3, 8) its
    coefficients (`BandPads.root`)."""
    eps_q, eta = operand_eps(band)
    f64 = torch.float64
    o64, d64 = o.to(f64), d.to(f64)
    O = o64.abs() * (1 + eps_q) + eta
    Dq = d64.abs() * (1 + eps_q) + eta
    P0 = O @ root[:, 1:4].T + root[:, 0]
    P1 = Dq @ root[:, 4:7].T + root[:, 7]
    box = root_box.to(f64)
    W = torch.maximum(box[3:] - o64, o64 - box[:3])
    den = d64.abs() - P1
    t_scene = torch.where(den > 0, (W + P0) / torch.where(den > 0, den, 1.0),
                          float("inf")).amin(dim=1)
    reach = torch.minimum(torch.maximum(mind.to(f64).abs(), maxd.to(f64).abs()), t_scene)
    out = torch.stack([O.sum(dim=1), Dq.sum(dim=1), reach, torch.zeros_like(reach)], dim=1)
    fin = torch.isfinite(o).all(dim=1) & torch.isfinite(d).all(dim=1)
    return torch.where(fin[:, None], _outward(out, False), 0.0).contiguous()


def pad_t(ray4, mind, best, fixed: bool) -> torch.Tensor:
    """(R,) the |t| up to which the walk grows a ray's boxes: its reach
    (`fixed`: any hit, the packed epilogue), else no farther than
    max(|mind|, best) (closest hit; `best` (R,) its best t), as the kernel
    takes it."""
    if fixed:
        return ray4[:, 2]
    return torch.minimum(ray4[:, 2], torch.maximum(mind.abs(), best))


def box_reach(boxes, c4, ray4, o, d):
    """(P0, P1, tb) float64 (n,) of boxes (n, 6) for their rays (see
    `grow`): the box's pad is P0 + P1 |t|, and no point inside it that the
    ray accepts lies past |t| = tb (inf where |d_a| <= P1)."""
    f64 = torch.float64
    c, r, b = c4.to(f64), ray4.to(f64), boxes.to(f64)
    P0 = c[:, 0] + c[:, 1] * r[:, 0]
    P1 = c[:, 2] * r[:, 1] + c[:, 3]
    ad = d.abs()
    a = ad.argmax(dim=1, keepdim=True)
    oa = o.gather(1, a)[:, 0].to(f64)
    W = torch.maximum(b[:, 3:].gather(1, a)[:, 0] - oa, oa - b[:, :3].gather(1, a)[:, 0])
    den = ad.gather(1, a)[:, 0].to(f64) - P1
    return P0, P1, torch.where(den > 0, (W + P0) / torch.where(den > 0, den, 1.0),
                               float("inf"))


def grow(boxes, c4, ray4, tr, o, d) -> torch.Tensor:
    """Plain version of the kernel's grown box (`chunk_walk.cuh:walk_box`):
    boxes (n, 6) f32 [lo3 | hi3], each grown on every axis by its ray's
    pad, c0 + cO Os + t (cT Ds + ct) with c4 (n, 4) the box's `box_pad4`
    and ray4 (n, 4) its ray's `ray_pads`, at t = min(tr, tb): tr (n,) the
    ray's `pad_t`, tb the box's own bound on |t| of an accepted point
    inside it (`box_reach`; o, d (n, 3) the ray; on its longest axis a,
    first of equal ones, |t| |d_a| <= W_a + P0 + P1 |t| with P0 = c0 + cO
    Os, P1 = cT Ds + ct, W_a the distance from o to the box's far side on
    a).  In float64, the pad rounded up to f32, the bounds outward; the
    kernel's box holds this one."""
    P0, P1, tb = box_reach(boxes, c4, ray4, o, d)
    b = boxes.to(torch.float64)
    p = _outward(P0 + torch.minimum(tr.to(torch.float64), tb) * P1, False).to(torch.float64)
    p = p[:, None]
    return torch.cat([_outward(b[:, :3] - p, True), _outward(b[:, 3:] + p, False)], dim=1)


# the largest slab distance `check_reach` allows on a ray's longest axis
SLAB_MAX = 2.0**120


def check_reach(o, d, mind, maxd, ray4, pads: BandPads, fixed: bool) -> None:
    """Raise ValueError where a live ray of the launch (finite, with a
    nonzero direction) could be handed a box the slab test cannot enter:
    its largest pad over the launch's boxes, at its largest `pad_t` (the
    miss value 1e5 as the best t in closest hit), not finite, or the slab
    distance of the farthest grown bound on its longest axis above
    SLAB_MAX."""
    f64 = torch.float64
    c = torch.cat([pads.tree, pads.slices]).to(f64).amax(dim=0)
    r = ray4.to(f64)
    tr = pad_t(r, mind.to(f64), torch.full_like(r[:, 2], 1e5), fixed)
    p = c[0] + c[1] * r[:, 0] + tr * (c[2] * r[:, 1] + c[3])
    da = d.to(f64).abs().amax(dim=1)
    far = (pads.bound.amax() + p + o.to(f64).abs().amax(dim=1)) / da
    live = ((maxd > mind) & torch.isfinite(o).all(dim=1) & torch.isfinite(d).all(dim=1)
            & (da > 0))
    if bool((live & ~(far <= SLAB_MAX)).any()):
        raise ValueError("band_pad: a ray's reach has no finite bound (no finite max distance "
                         "and no scene bound), so its boxes cannot be grown for a widened band")


def launch_pads(o, d, mind, maxd, band: Band, tree: BoxTree, pads: BandPads,
                fixed: bool) -> torch.Tensor:
    """The rays' pads for one walk launch (`ray_pads`; `fixed`: any hit or
    the packed epilogue), checked (`check_reach`)."""
    ray4 = ray_pads(o, d, mind, maxd, band, tree.boxes[0], pads.root)
    check_reach(o, d, mind, maxd, ray4, pads, fixed)
    return ray4
