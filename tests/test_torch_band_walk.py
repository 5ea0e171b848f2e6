"""PyTorch port, K1b's and K6's tree walks under a widened acceptance (the
sub-f32 error bands and 'dtype'): the walk over boxes grown for each ray by the band's
proven reach (`ops/band_pad.py`, the proof in `csrc/chunk_walk.cuh`)
keeps every hit the all-row scan keeps.

On colonnade-5k (`sponza_like_scene()`, 5,314 instance triangles) and on
colonnade-8k (`sponza_like_scene(5, 2)`, 8,302, just above the old 8,192
cap), in every widened form of both kinds (K1b: the dense band's forms 5,
9 and 13 on the chunk tree under `box_entry`; K6: the packet band's 6, 10,
14, 18 and 22 on the packet tree under the zero-axis rule), with rays of
five families: a 24 x 24 primary grid, distant rays from 40-120 units
away aimed into random slice boxes, grazing rays (a direction within 1e-3
of a triangle's plane), the sun's rays (d_x exactly 0) from points of
the scene, and rays aimed from afar at points just outside a triangle
and outside its slice box (the accepted points an unpadded walk misses):
- (a) the plain emulation of the padded walk (`walk_plain`, here) equals
  the all-row plain version (`dense_trace_multi_plain`) bit for bit in
  closest hit, any hit and, in the packed forms, the packed epilogue, and
  drops no accepted (ray, row) pair; the set holds accepted points outside
  their unpadded slice boxes, and the walk over unpadded boxes drops
  accepted pairs;
- the slices (K1b) or leaves (K6) that chip_smoke.py's `walk_ops` counts
  per ray on the grown boxes, which give the walks' reported bounds and
  per-ray counts on the card, are those the emulation enters no later
  than the ray's closest hit;
- a triangle with no area (two equal vertices) in colonnade-5k, whose row
  has no finite plane and accepts nothing, leaves the pads finite, and
  the emulation still equals the plain version with no distance cap
  (maxd = inf); so does a row with a finite plane and a non-finite edge
  coefficient, whose pad covers all a ray reaches, in closest hit, where
  an any-hit launch with no distance cap raises;
- (b) in float64, per (ray, row) on random rows of both tables and random
  rays, every accepted point lies inside its row's vertex range grown by
  the row's pad at the hit's own |t| (beside the strict test's own
  tolerance), and inside its slice box grown as the kernel grows it;
- the wrappers, K1b's and K6's, on CPU tensors return the plain version
  under every widened form (the kernels themselves are held on the card by
  chip_smoke.py);
- (c) the slice boxes' pads by brute force, with rays of an exact zero
  axis: aimed just past a triangle's extreme (every accepted point inside
  its slice box grown as the walk grows it), and two f32 ulps outside a
  grown face (left out by the box, accepted by no row of it);
- the operand's unit roundoff in the pads is bf16's and fp16's own (2^-8,
  2^-11)."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import pytest
import torch

import chip_smoke

from low_precision_raytracer_tpu_torch.config import RenderConfig, get_precision
from low_precision_raytracer_tpu_torch.models.procedural import sponza_like_scene
from low_precision_raytracer_tpu_torch.ops import band_pad as BP
from low_precision_raytracer_tpu_torch.ops import walk_pad
from low_precision_raytracer_tpu_torch.ops import trace as T
from low_precision_raytracer_tpu_torch.ops.camera import primary_ray_grid
from low_precision_raytracer_tpu_torch.ops.dense_trace import (
    CHUNK,
    FAN,
    SLICE,
    BoxTree,
    _accept,
    _closest,
    _packed,
    dense_band,
    dense_trace_multi,
    dense_trace_multi_plain,
    packet_band,
    tri_quantities,
)
from low_precision_raytracer_tpu_torch.ops.packet_trace import packet_trace, walk_view
from low_precision_raytracer_tpu_torch.ops.wavefront import slice_entry
from low_precision_raytracer_tpu_torch.render.renderer import Renderer

SCENES = {"colonnade-5k": (4, 2), "colonnade-8k": (5, 2)}
# (precision, fallback, kind) -> form: every widened form of both kinds
FORMS = [("fp32", "dtype", "dense"), ("bf16", "both", "dense"), ("bf16", "dtype", "dense"),
         ("fp32", "dtype", "packet"), ("bf16", "both", "packet"), ("bf16", "dtype", "packet"),
         ("fp16", "both", "packet"), ("fp16", "dtype", "packet")]
WANT_FORMS = {5, 9, 13, 6, 10, 14, 18, 22}
N_SIDE = 24  # the primary grid
N_FAMILY = 160  # rays of each other family


def _band(precision, fallback, kind):
    make = dense_band if kind == "dense" else packet_band
    return make(get_precision(precision), fallback)


def _triangles(coef):
    """(TI, 3, 3) float64 vertices V0, V1, V2 of the triangles the f32 rows
    describe."""
    n = coef[:, :9].double().reshape(-1, 3, 3)
    inv = torch.linalg.inv(n)
    v2 = -(inv @ coef[:, 9:12].double()[:, :, None])[:, :, 0]
    return torch.stack([v2 + inv[:, :, 0], v2 + inv[:, :, 1], v2], dim=1)


def walk_plain(o, d, skip, mind, maxd, coef, tri_ids, obj_ids, tree: BoxTree, slices, band,
               pads: BP.BandPads | None = None, find_any: bool = False, pack: bool = False,
               exact0: bool = False, grow: bool = True, slab_elems: int = 1 << 22):
    """Plain emulation of K1b's and K6's walk (csrc/chunk_walk.cuh) under a
    widened band, vectorised: every tree box and slice box grown for each
    ray (`band_pad.grow`; in closest hit at the ray's final best t, the
    plain version's, the smallest pad the kernel's walk uses, so it enters
    no box the kernel skips; `grow=False` keeps them as they are, the walk
    without the pad) and slab-tested by the kernel's rule (`box_entry`, or
    `exact0`: the zero-axis rule); a row takes part where its slice and
    every node above it are entered, in closest hit (not pack) no later
    than its t, and in pack and closest hit every node above its slice no
    later than its t (the walk skips those beyond the best t, and the
    winner's t is at most the best).  `tree` is the chunk tree the walk
    reads (K6: the view of the packet tree's levels 1..), `slices` its
    slice boxes, `pads` theirs (default: `band_pads` of a chunk tree; K6's
    view takes its packet tree's).  -> (outputs as
    `dense_trace_multi_plain` gives them, (R, ns) slices entered, (R, ns)
    the latest entry of each slice and the nodes above it, accepted (ray,
    row) pairs outside the walk per ray (R,) i64)."""
    R, TI = o.shape[0], coef.shape[0]
    dev = o.device
    inv = 1.0 / d
    L = len(tree.sizes)
    offs = tree.levels[:L].tolist()
    if grow:
        if pads is None:
            pads = BP.band_pads(coef, band, tree, slices)
        ray4 = BP.ray_pads(o, d, mind, maxd, band, tree.boxes[0], pads.root)
        fixed = find_any or pack
        best = None if fixed else dense_trace_multi_plain(
            o, d, skip, mind, maxd, coef, tri_ids, obj_ids, band=band)[0]
        tr = BP.pad_t(ray4, mind, best, fixed)

    def entry(boxes, c4):  # (R, n) entry and entered under the kernel's rule
        n = boxes.shape[0]
        b = boxes.repeat(R, 1)
        if grow:
            b = BP.grow(b, c4.repeat(R, 1), ray4.repeat_interleave(n, 0),
                        tr.repeat_interleave(n, 0), o.repeat_interleave(n, 0),
                        d.repeat_interleave(n, 0))
        e, ok0, ok = slice_entry(b, o.repeat_interleave(n, 0), inv.repeat_interleave(n, 0),
                                 maxd.repeat_interleave(n, 0))
        return e.reshape(R, n), (ok0 if exact0 else ok).reshape(R, n)

    live = maxd > mind
    ok_up = live[:, None].clone()
    e_up = torch.zeros((R, 1), dtype=torch.float32, device=dev)
    for lvl in range(L - 1, -1, -1):  # root first: chain each level to its parent
        nodes = slice(offs[lvl], offs[lvl] + tree.sizes[lvl])
        e, ok = entry(tree.boxes[nodes], pads.tree[nodes] if grow else None)
        parent = torch.arange(tree.sizes[lvl], device=dev) // FAN if lvl < L - 1 \
            else torch.zeros(tree.sizes[lvl], dtype=torch.long, device=dev)
        ok_up = ok & ok_up[:, parent]
        e_up = torch.maximum(e, e_up[:, parent])
    ns = min(tree.sizes[0] * (CHUNK // SLICE), slices.shape[0])
    e_s, ok_s = entry(slices[:ns], pads.slices[:ns] if grow else None)
    chunk = torch.arange(ns, device=dev) // (CHUNK // SLICE)
    ok_s = ok_s & ok_up[:, chunk]
    e_tree = e_up[:, chunk]  # the latest entry of the nodes above each slice
    e_all = torch.maximum(e_s, e_tree)

    outs, dropped = [], torch.zeros(R, dtype=torch.int64, device=dev)
    rs = max(1, slab_elems // TI)
    sl = torch.arange(TI, device=dev) // SLICE
    for r0 in range(0, max(R, 1), rs):
        rr = slice(r0, r0 + rs)
        t, u, v, geom = tri_quantities(coef, o[rr], d[rr], band)
        acc = _accept(t, geom, skip[rr], mind[rr], maxd[rr], tri_ids)
        inside = ok_s[rr][:, sl]
        if not find_any:
            inside = inside & ((e_tree if pack else e_all)[rr][:, sl] <= t)
        dropped[rr] = (acc & ~inside).sum(dim=1)
        acc = acc & inside
        if find_any:
            n = t.shape[0]
            outs.append((torch.full((n,), 1e5, dtype=torch.float32, device=dev),
                         torch.zeros((n,), dtype=torch.float32, device=dev),
                         torch.zeros((n,), dtype=torch.float32, device=dev),
                         torch.where(acc.any(dim=1), 0, -1).to(torch.int32),
                         torch.full((n,), -1, dtype=torch.int32, device=dev)))
        elif pack:
            outs.append(_packed(t, u, v, acc, CHUNK))
        else:
            outs.append(_closest(t, u, v, acc, tri_ids, obj_ids))
    return tuple(torch.cat(x) for x in zip(*outs)), ok_s, e_all, dropped


def _unit(x):
    return x / torch.linalg.norm(x, dim=1, keepdim=True)


def _rays(frame, coef, slices, seed):
    """The five families of the module docstring, recentred: (o, d, skip,
    mind, maxd) f32 and the index range of the last family (aimed just
    outside a triangle and its slice box)."""
    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    c = frame.dense_center
    o, d = primary_ray_grid(frame.cam_l2w_f32, frame.cam_fov_y_f32, N_SIDE, N_SIDE)
    fam_o, fam_d = [o.reshape(-1, 3) - c], [d.reshape(-1, 3)]
    n = N_FAMILY
    ns = slices.shape[0]
    # distant rays into random slice boxes
    s = torch.randint(0, ns, (n,), generator=g)
    lo, hi = slices[s, :3].double(), slices[s, 3:].double()
    aim = lo + (hi - lo) * torch.rand((n, 3), generator=g, dtype=f64)
    dd = _unit(torch.randn((n, 3), generator=g, dtype=f64))
    dist = 40 + 80 * torch.rand((n, 1), generator=g, dtype=f64)
    fam_o.append((aim - dist * dd).float())
    fam_d.append(dd.float())
    # grazing rays: within 1e-3 of a random triangle's plane, towards it
    tri = _triangles(coef)
    rows = torch.randint(0, coef.shape[0], (n,), generator=g)
    v = tri[rows]
    nrm = _unit(torch.cross(v[:, 0] - v[:, 2], v[:, 1] - v[:, 2], dim=1))
    w = torch.rand((n, 3), generator=g, dtype=f64)
    w = w / w.sum(dim=1, keepdim=True)
    aim = (w[:, :, None] * v).sum(dim=1)
    inplane = _unit(torch.cross(nrm, torch.randn((n, 3), generator=g, dtype=f64), dim=1))
    dd = _unit(inplane + 1e-3 * (2 * torch.rand((n, 1), generator=g, dtype=f64) - 1) * nrm)
    fam_o.append((aim - (2 + 10 * torch.rand((n, 1), generator=g, dtype=f64)) * dd).float())
    fam_d.append(dd.float())
    # the sun's rays: d_x exactly 0, from points of random slice boxes
    sun = frame.light_dir[frame.light_type == 1][0].float()
    sd = _unit(-sun[None].double()).float().expand(n, 3).clone()
    sd[:, 0] = 0.0
    s = torch.randint(0, ns, (n,), generator=g)
    lo, hi = slices[s, :3].double(), slices[s, 3:].double()
    fam_o.append((lo + (hi - lo) * torch.rand((n, 3), generator=g, dtype=f64)).float())
    fam_d.append(sd)
    # from afar at a point just outside a triangle, outside its slice box
    rows = torch.randint(0, coef.shape[0], (8 * n,), generator=g)
    v = tri[rows]
    k = torch.randint(0, 3, (8 * n,), generator=g)
    vert = v[torch.arange(8 * n), k]
    cen = v.mean(dim=1)
    aim = vert + (0.01 + 0.3 * torch.rand((8 * n, 1), generator=g, dtype=f64)) * (vert - cen)
    sb = slices[rows // SLICE].double()
    out = ((aim < sb[:, :3]) | (aim > sb[:, 3:])).any(dim=1)
    aim, v = aim[out][:n], v[out][:n]
    m = aim.shape[0]
    nrm = _unit(torch.cross(v[:, 0] - v[:, 2], v[:, 1] - v[:, 2], dim=1))
    dd = _unit(nrm + 0.7 * _unit(torch.randn((m, 3), generator=g, dtype=f64)))
    dd = torch.where(((dd * nrm).sum(dim=1, keepdim=True) > 0), -dd, dd)
    dist = 30 + 90 * torch.rand((m, 1), generator=g, dtype=f64)
    fam_o.append((aim - dist * dd).float())
    fam_d.append(dd.float())
    o = torch.cat(fam_o).contiguous()
    dvec = torch.cat(fam_d).contiguous()
    R = o.shape[0]
    skip = torch.where(torch.rand(R, generator=g) < 0.1,
                       torch.randint(0, int(frame.dense_tri.max()) + 1, (R,), generator=g),
                       -1).to(torch.int32)
    mind = torch.full((R,), 1e-4)
    maxd = torch.full((R,), 1e5)
    maxd[5::97] = 0.0  # dead lanes
    return (o, dvec, skip, mind, maxd), (R - m, R)


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request):
    grid, sub = SCENES[request.param]
    out = {}
    for precision in ("fp32", "bf16", "fp16"):
        r = Renderer(sponza_like_scene(grid, sub),
                     RenderConfig(width=8, height=8, precision=precision,
                                  triangle_fallback="dtype"), device="cpu")
        out[precision] = r.frame
    f = out["bf16"]
    rays, outside = _rays(f, T.frame_table(f, dense_band(get_precision("bf16"))),
                          T._slice_table(f), seed=grid)
    return dict(name=request.param, frames=out, rays=rays, outside=outside)


def _walk_tables(frame, coef, kind, rays, band):
    """(tree as the walk reads it, slice boxes, their pad coefficients,
    exact0, launch args): K1b's chunk tree with the scene-exit cap as the
    dense route's launches carry it, or the view of K6's packet tree."""
    o, d, skip, mind, maxd = rays
    if kind == "dense":
        _lo, _hi, tree = T._chunk_tables(frame)
        cap = T.scene_exit_cap(frame, o + frame.dense_center, d, maxd)
        slices = T._slice_table(frame)
        return (tree, slices, BP.band_pads(coef, band, tree, slices), False,
                (o, d, skip, mind, cap))
    ptree = T._packet_tables(frame)[2]
    w = walk_view(ptree, coef)
    view = BoxTree(w.boxes, w.levels, ptree.sizes[1:], CHUNK)
    return view, w.slices, BP.band_pads(coef, band, ptree), True, rays


@pytest.mark.parametrize("precision,fallback,kind", FORMS)
def test_padded_walk_equals_plain(scene, precision, fallback, kind):
    """(a): see the module docstring."""
    band = _band(precision, fallback, kind)
    assert band.widened and band.form in WANT_FORMS
    f = scene["frames"][precision]
    coef = T.frame_table(f, band)
    tree, slices, pads, exact0, args = _walk_tables(f, coef, kind, scene["rays"], band)
    o, d, skip, mind, maxd = args
    tab = (coef, f.dense_tri, f.dense_obj)
    kinds = [("closest", False, False), ("any", True, False)]
    if band.form in (9, 13):
        kinds.append(("pack", False, True))
    for name, find_any, pack in kinds:
        got, entered, _e, dropped = walk_plain(*args, *tab, tree, slices, band, pads,
                                               find_any=find_any, pack=pack, exact0=exact0)
        want = dense_trace_multi_plain(*args, *tab, find_any=find_any, band=band, pack=pack)
        for a, b in zip(got, want):
            assert torch.equal(a, b), name
        assert int(dropped.sum()) == 0, name
        hit = want[1] if pack else want[3]
        assert bool((hit >= 0).any()) and bool((hit < 0).any())
        # the pad culls: fewer slices than all on the primary grid
        n_prim = N_SIDE * N_SIDE
        assert float(entered[:n_prim].sum(dim=1).float().mean()) < slices.shape[0]
    # accepted points outside their unpadded slice box exist, and the walk
    # over unpadded boxes would drop them
    a0, a1 = scene["outside"]
    sel = torch.arange(a0, a1)
    sub = [x[sel] for x in args]
    t, _u, _v, geom = tri_quantities(coef, sub[0], sub[1], band)
    acc = _accept(t, geom, sub[2], sub[3], sub[4], f.dense_tri)
    ray, row = torch.nonzero(acc, as_tuple=True)
    p = sub[0][ray].double() + t[ray, row].double()[:, None] * sub[1][ray].double()
    sb = slices[row // SLICE].double()
    outside = ((p < sb[:, :3]) | (p > sb[:, 3:])).any(dim=1)
    assert int(outside.sum()) > 0
    dropped = walk_plain(*sub, *tab, tree, slices, band, exact0=exact0, grow=False)[3]
    assert int(dropped.sum()) > 0


def _row_boxes(coef):
    tri = _triangles(coef)
    return tri.amin(dim=1), tri.amax(dim=1)


@pytest.mark.parametrize("precision,fallback,kind", FORMS)
def test_pad_bound_float64(scene, precision, fallback, kind):
    """(b): per (ray, row), every accepted point P = o + t d (float64) lies
    within its row's vertex range grown by the row's pad at the ray's own
    values and the hit's own |t| (beside the strict test's own tolerance),
    and inside its slice box grown as the kernel grows it at that |t|; the
    hit's |t| is within the ray's reach (`ray_pads`) and the slice box's
    own bound (`box_reach`)."""
    band = _band(precision, fallback, kind)
    f = scene["frames"][precision]
    coef = T.frame_table(f, band)
    g = torch.Generator().manual_seed(band.form)
    rows = torch.randperm(coef.shape[0], generator=g)[:768]
    tab = coef[rows]
    tree, slices, bp, _exact0, args = _walk_tables(f, coef, kind, scene["rays"], band)
    o, d, skip, mind, maxd = args
    live = torch.nonzero(maxd > mind)[:, 0]
    pick = live[torch.randperm(live.numel(), generator=g)[:1024]]
    o, d, mind, maxd = o[pick], d[pick], mind[pick], maxd[pick]
    t, _u, _v, geom = tri_quantities(tab, o, d, band)
    acc = geom & (t > mind[:, None]) & (t < maxd[:, None]) & torch.isfinite(t)
    ray, j = torch.nonzero(acc, as_tuple=True)
    assert ray.numel() > 100
    th = t[ray, j]
    p = o[ray].double() + th.double()[:, None] * d[ray].double()
    eps_q, eta = BP.operand_eps(band)
    at = th.double().abs()[:, None]
    X = torch.cat([torch.ones_like(at), o[ray].double().abs() * (1 + eps_q) + eta,
                   at * (d[ray].double().abs() * (1 + eps_q) + eta), at], dim=1)
    pad = torch.einsum("mak,mk->ma", BP.row_pads(tab, band, bp.bound)[j], X)
    lo_r, hi_r = _row_boxes(tab)
    tol = 1e-4 + 1e-5 * p.abs().amax(dim=1, keepdim=True)
    over = torch.maximum(lo_r[j] - pad - p, p - hi_r[j] - pad)
    assert bool((over <= tol).all())
    ray4 = BP.ray_pads(o, d, mind, maxd, band, tree.boxes[0], bp.root)
    assert bool((at[:, 0] <= ray4[ray, 2].double()).all())
    sl = rows[j] // SLICE
    grown = BP.grow(slices[sl], bp.slices[sl], ray4[ray], th.abs(), o[ray], d[ray]).double()
    assert bool(((p >= grown[:, :3]) & (p <= grown[:, 3:])).all())
    # ... inside the slice box grown by its pad at |t|, and within the
    # box's own bound on |t|, each checked apart from the pad's slack
    P0, P1, tb = BP.box_reach(slices[sl], bp.slices[sl], ray4[ray], o[ray], d[ray])
    pb = (P0 + at[:, 0] * P1)[:, None]
    sb = slices[sl].double()
    assert bool(((p >= sb[:, :3] - pb) & (p <= sb[:, 3:] + pb)).all())
    assert bool((at[:, 0] <= tb).all())
    # some accepted points lie outside their rows' unpadded vertex range
    over0 = torch.maximum(lo_r[j] - p, p - hi_r[j]).amax(dim=1)
    assert bool((over0 > 1e-3).any())


@pytest.mark.parametrize("precision,fallback,kind", FORMS)
def test_walk_ops_counts_emulation(scene, precision, fallback, kind):
    """chip_smoke.py's `walk_ops`, growing the boxes as the card's phases
    have it (`walk_growth`), counts per ray the slices (K1b) or leaves (K6)
    the emulation enters no later than the ray's closest hit."""
    band = _band(precision, fallback, kind)
    f = scene["frames"][precision]
    coef = T.frame_table(f, band)
    tree, slices, pads, exact0, args = _walk_tables(f, coef, kind, scene["rays"], band)
    out, ok_s, e_all, _dropped = walk_plain(*args, coef, f.dense_tri, f.dense_obj, tree,
                                            slices, band, pads, exact0=exact0)
    want = (ok_s & (e_all <= out[0][:, None])).sum(dim=1)
    largs = list(args) + [coef]
    kw = dict(band=band, pads=pads)
    if kind == "dense":
        growth = chip_smoke.walk_growth(largs, kw, tree, out[0], slices)
        per_ray = chip_smoke.walk_ops(largs, out[0], tree, band, slices=slices,
                                      growth=growth)[3]
    else:
        ptree = T._packet_tables(f)[2]
        growth = chip_smoke.walk_growth(largs, kw, ptree, out[0])
        per_ray = chip_smoke.walk_ops(largs, out[0], ptree, band, exact0=True,
                                      growth=growth)[3]
    assert torch.equal(per_ray.long(), want)
    assert int(want.sum()) > 0


@pytest.fixture(scope="module")
def flat_scene():
    """colonnade-5k with a triangle of no area (its second vertex index
    made its first's), per precision; the rays of the `scene` fixture's
    families, from its own seed."""
    out = {}
    for precision in ("fp32", "bf16", "fp16"):
        host = sponza_like_scene(*SCENES["colonnade-5k"])
        host.meshes[0].indices[0, 1] = host.meshes[0].indices[0, 0]
        r = Renderer(host, RenderConfig(width=8, height=8, precision=precision,
                                        triangle_fallback="dtype"), device="cpu")
        out[precision] = r.frame
    f = out["bf16"]
    rays, _outside = _rays(f, T.frame_table(f, dense_band(get_precision("bf16"))),
                           T._slice_table(f), seed=7)
    return dict(frames=out, rays=rays)


def _emulation_holds(args, tab, tree, slices, band, pads, exact0, kinds):
    for find_any, pack in kinds:
        got, _ok, _e, dropped = walk_plain(*args, *tab, tree, slices, band, pads,
                                           find_any=find_any, pack=pack, exact0=exact0)
        want = dense_trace_multi_plain(*args, *tab, find_any=find_any, band=band, pack=pack)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert int(dropped.sum()) == 0


@pytest.mark.parametrize("precision,fallback,kind", FORMS)
def test_flat_triangle_no_cap(flat_scene, precision, fallback, kind):
    """A row with no finite plane (a triangle of no area) gets no pad and
    leaves the pads finite; the emulation of the padded walk equals the
    plain version in closest and any hit (and the packed epilogue) with
    maxd = 1e5 (the render paths' largest cap) and with maxd = inf on every
    live ray (K1b's launch capped by the scene exit, K6's not: each ray's
    scene bound holds).  A row with a finite plane and an edge row that is
    not (one coefficient made inf) gets the pad that covers every point a
    ray reaches, so no ray has a scene bound: with maxd = inf the closest
    hit still equals the plain version, and an any-hit launch raises
    (`launch_pads`) where it cannot bound the rays' reach."""
    band = _band(precision, fallback, kind)
    f = flat_scene["frames"][precision]
    coef = T.frame_table(f, band)
    dead = ~torch.isfinite(coef[:, BP.PLANE_COLS]).all(dim=1)
    assert int(dead.sum()) > 0
    o, d, skip, mind, maxd = flat_scene["rays"]
    live = maxd > mind
    tab = (coef, f.dense_tri, f.dense_obj)
    kinds = [(False, False), (True, False)] + ([(False, True)] if band.form in (9, 13) else [])
    for cap in (1e5, float("inf")):
        m = torch.where(live, cap, maxd)
        tree, slices, pads, exact0, args = _walk_tables(f, coef, kind, (o, d, skip, mind, m),
                                                       band)
        rp = BP.row_pads(coef, band, pads.bound)
        assert bool(torch.isfinite(rp).all()) and bool((rp[dead] == 0).all())
        for fixed in (False, True):
            BP.launch_pads(args[0], args[1], args[3], args[4], band, tree, pads, fixed)
        _emulation_holds(args, tab, tree, slices, band, pads, exact0, kinds)
    bad = coef.clone()
    bad[coef.shape[0] // 2, 0] = float("inf")
    tab = (bad, f.dense_tri, f.dense_obj)
    m = torch.where(live, float("inf"), maxd)
    tree, slices, pads, exact0, args = _walk_tables(f, bad, kind, (o, d, skip, mind, m), band)
    assert bool(torch.isfinite(pads.tree).all())
    ray4 = BP.ray_pads(args[0], args[1], args[3], args[4], band, tree.boxes[0], pads.root)
    if kind == "packet":
        assert bool(torch.isinf(ray4[live, 2]).all())
        with pytest.raises(ValueError, match="no finite bound"):
            BP.launch_pads(args[0], args[1], args[3], args[4], band, tree, pads, True)
        kinds = [(False, False)]
    BP.launch_pads(args[0], args[1], args[3], args[4], band, tree, pads, False)
    _emulation_holds(args, tab, tree, slices, band, pads, exact0, kinds)

@pytest.mark.parametrize("kind", ["dense", "packet"])
def test_wrappers_on_cpu(scene, kind):
    """The K1b and K6 wrappers on CPU tensors return the plain version in
    a widened form (bf16 'dtype'), and `check_scene` no longer refuses a
    band above 8,192 instance triangles."""
    band = _band("bf16", "dtype", kind)
    f = scene["frames"]["bf16"]
    coef = T.frame_table(f, band)
    rays = [x[::7].contiguous() for x in scene["rays"]]
    want = dense_trace_multi_plain(*rays, coef, f.dense_tri, f.dense_obj, band=band)
    if kind == "dense":
        got = dense_trace_multi(*rays, coef, f.dense_tri, f.dense_obj, f.dense_chunk_lo,
                                f.dense_chunk_hi, band=band)
    else:
        got = packet_trace(*rays, coef, f.dense_tri, f.dense_obj, f.dense_leaf_lo,
                           f.dense_leaf_hi, band=band)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not hasattr(T, "BAND_SCAN_MAX_TRIS")


def _edge_rays(tri, g):
    """Rays with an exact zero axis a, aimed at each triangle's centroid
    from an origin pushed past its extreme on a by 1e-4 .. 0.1 of its
    extent (so only a widened test can accept them): -> (o, d) f32."""
    f64 = torch.float64
    n = tri.shape[0]
    cen = tri.mean(dim=1)
    lo, hi = tri.amin(dim=1), tri.amax(dim=1)
    os_, ds_ = [], []
    for a in range(3):
        span = hi[:, a] - lo[:, a] + 1e-3
        for off in (1e-4, 1e-3, 1e-2, 1e-1):
            for side in (0, 1):
                o = cen + 2 * torch.randn((n, 3), generator=g, dtype=f64)
                o[:, a] = lo[:, a] - off * span if side == 0 else hi[:, a] + off * span
                dd = cen - o
                dd[:, a] = 0.0
                os_.append(o.float())
                ds_.append(_unit(dd).float())
    return torch.cat(os_), torch.cat(ds_)


def _accepts(coef, o, d, mind, maxd, band):
    t, _u, _v, geom = tri_quantities(coef, o, d, band)
    return t, geom & (t > mind[:, None]) & (t < maxd[:, None]) & torch.isfinite(t)


@pytest.mark.parametrize("precision,fallback,kind", FORMS)
def test_pad_holds_by_brute_force(scene, precision, fallback, kind):
    """The slice boxes' pads by brute force, with rays of an exact zero
    axis a (every point they accept has o_a on a): rays aimed past a
    triangle's extreme on a, tested against 256 rows (theirs among them),
    every accepted point inside its slice box grown for the ray at the
    point's |t| (`grow`, as the walk grows it); and rays whose origins sit
    on the grown face of a slice box on a (at the ray's reach, its own pad's
    fixed point) and two f32 ulps outside it: the grown box leaves out the
    ray outside, and no row of the slice accepts it."""
    band = _band(precision, fallback, kind)
    f = scene["frames"][precision]
    coef = T.frame_table(f, band)
    tree, slices, bp, _exact0, _args = _walk_tables(f, coef, kind, scene["rays"], band)
    g = torch.Generator().manual_seed(band.form)
    root = tree.boxes[0]
    live_rows = torch.nonzero(torch.isfinite(coef[:, BP.PLANE_COLS]).all(dim=1)).flatten()
    rows = live_rows[torch.randperm(live_rows.numel(), generator=g)[:256]]
    tab = coef[rows]
    o, d = _edge_rays(_triangles(tab), g)
    n = o.shape[0]
    mind, maxd = torch.full((n,), 1e-4), torch.full((n,), 1e5)
    t, acc = _accepts(tab, o, d, mind, maxd, band)
    ray, j = torch.nonzero(acc, as_tuple=True)
    assert ray.numel() > 0
    ray4 = BP.ray_pads(o, d, mind, maxd, band, root, bp.root)
    sl = rows[j] // SLICE
    grown = BP.grow(slices[sl], bp.slices[sl], ray4[ray], t[ray, j].abs(), o[ray], d[ray])
    p = o[ray].double() + t[ray, j].double()[:, None] * d[ray].double()
    zero = d[ray] == 0
    inside = (p >= grown[:, :3].double()) & (p <= grown[:, 3:].double())
    assert bool(inside[zero].all()), f"{int((~inside[zero]).sum())} points outside"
    # on and two ulps outside the grown faces of 48 slice boxes
    ns = slices.shape[0]
    s = torch.randperm(ns, generator=g)[:48].repeat_interleave(6)
    axis = torch.arange(3).repeat_interleave(2).repeat(48)
    side = torch.arange(2).repeat(3 * 48)
    m = s.numel()
    box = slices[s].double()
    o = (box[:, :3] + (box[:, 3:] - box[:, :3]) * torch.rand((m, 3), generator=g,
                                                               dtype=torch.float64)).float()
    d = torch.randn((m, 3), generator=g)
    d[torch.arange(m), axis] = 0.0
    d = _unit(d)
    mind, maxd = torch.full((m,), 1e-4), torch.full((m,), 1e5)
    col = axis + 3 * side
    for _ in range(40):  # the pad depends on o: iterate to its fixed point
        ray4 = BP.ray_pads(o, d, mind, maxd, band, root, bp.root)
        face = BP.grow(slices[s], bp.slices[s], ray4, ray4[:, 2], o, d)
        edge = face[torch.arange(m), col].float()
        fixed = edge == o[torch.arange(m), axis]
        if bool(fixed.all()):
            break
        o[torch.arange(m), axis] = edge
    # where the pad grows with |o| by less than a quarter of it, two ulps
    # outward move o past the face
    fixed = fixed & (bp.slices[s, 1] < 0.25)
    assert int(fixed.sum()) >= 0.5 * m
    out = o.clone()
    step = torch.where(side == 1, float("inf"), float("-inf"))
    for _ in range(2):  # the face is rounded outward to f32: it moves by an ulp with o
        out[torch.arange(m), axis] = torch.nextafter(out[torch.arange(m), axis], step)
    ray4 = BP.ray_pads(out, d, mind, maxd, band, root, bp.root)
    face = BP.grow(slices[s], bp.slices[s], ray4, ray4[:, 2], out, d)
    oa = out[torch.arange(m), axis]
    beyond = torch.where(side == 1, oa > face[torch.arange(m), col],
                         oa < face[torch.arange(m), col])
    assert bool(beyond[fixed].all())
    _t, acc = _accepts(coef, out, d, mind, maxd, band)
    own = (torch.arange(coef.shape[0])[None, :] // SLICE) == s[:, None]
    assert not bool((acc & own)[fixed].any())


@pytest.mark.parametrize("precision", ["bf16", "fp16"])
def test_operand_eps_is_unit_roundoff(precision):
    """The ray operand's unit roundoff in the pads (`operand_eps`, and the
    walk's `walk_pad.ROUNDING`) bounds the relative rounding of every value
    of [1, 2) on a 2^-16 grid to the type, and that rounding comes within
    2^-16 of it (bf16 keeps 8 significant bits: 2^-8, fp16 11: 2^-11)."""
    band = _band(precision, "dtype", "packet")
    assert band.operand is get_precision(precision).dtype
    eps_q, _eta = BP.operand_eps(band)
    assert (eps_q, _eta) == walk_pad.ROUNDING[band.operand]
    x = 1 + torch.arange(1 << 16, dtype=torch.float64) * 2.0**-16
    rel = ((x.float().to(band.operand).double() - x).abs() / x).max()
    assert float(rel) <= eps_q
    assert float(rel) >= eps_q * (1 - 2.0**-16) / (1 + eps_q)
