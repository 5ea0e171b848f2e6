"""PyTorch port, K6's walk (`csrc/packet_trace.cu`: K1b's warp walk of
`csrc/chunk_walk.cuh` over the packet tree, its boxes tested by
`box_entry_exact0`, exact on a zero direction axis) emulated ray by ray on
the CPU, the view of the packet tree it walks (`ops/packet_trace.py:
walk_view`) and its zero-axis rule (`zero_axis_inside`).

On the port's own `sponza_like_scene(3, 1)` (830 instance triangles, 26
leaves, bf16 tables) with random rays: +-0 direction components planted on
each axis and on two at once, origins exactly on a leaf face in the plane
of that face, rays aimed along a zero axis at random points of leaf
boxes, dead lanes and skipped triangles:
- the walk, emulated by tests/test_torch_k1b_walk.py's `warp_walk` on the
  walk view (levels 1.. of the packet tree as the chunk tree, the leaves as
  the slices, the stack `walk_view` sizes, the warp's group merge) with the
  zero-axis rule, equals `dense_trace_multi_plain` bit for bit in closest
  hit and any hit, under 'mxu3' and the f32 'both' packet band;
- the rule is conservative: every row the plain version accepts lies in a
  leaf (and under nodes) that the rule enters, and it enters fewer leaves
  than the slab test alone on the zero-axis rays;
- the port against the JAX packet kernel (`trace_rays_packet(...,
  interpret=True)`, through each package's `trace` with
  `traversal_impl='pallas'`) on zero-axis rays, at the bars of
  tests/test_torch_packet.py."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import RenderConfig as JaxConfig
from low_precision_raytracer_tpu.config import get_precision as jax_precision
from low_precision_raytracer_tpu.models.procedural import sponza_like_scene as jax_sponza
from low_precision_raytracer_tpu.models.scene import build_scene_arrays, flatten_frame
from low_precision_raytracer_tpu_torch.config import RenderConfig, get_precision
from low_precision_raytracer_tpu_torch.models import scene as tscene
from low_precision_raytracer_tpu_torch.models.procedural import sponza_like_scene
from low_precision_raytracer_tpu_torch.ops import trace as T
from low_precision_raytracer_tpu_torch.ops.dense_trace import (
    CHUNK,
    STRICT,
    BoxTree,
    _accept,
    build_tree,
    dense_trace_multi_plain,
    packet_band,
    tri_quantities,
)
from low_precision_raytracer_tpu_torch.ops.packet_trace import (
    LEAF,
    ZERO_AXIS_MARGIN,
    walk_view,
    zero_axis_inside,
)
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_k1b_walk import _box, warp_walk
from test_torch_packet import _both, _check_any, _check_closest

N_RAYS = 320


def _box_exact0(b, o, inv, maxd):
    """K6's box_entry_exact0 of one ray against boxes (n, 6)."""
    e, ok = _box(b, o, inv, maxd)
    n = b.shape[0]
    inside = zero_axis_inside(b[:, :3], b[:, 3:], o[None].expand(n, 3), inv[None].expand(n, 3))
    return e, ok & inside


def _zero_axis_rays(lo, hi, rng, n):
    """(o, d) (n, 3) f64: random origins in the boxes' span and random
    directions, with the planted cases of the module docstring."""
    base, span = lo.min(0).values.numpy(), (hi.max(0).values - lo.min(0).values).numpy()
    o = base + rng.random((n, 3)) * span
    d = rng.standard_normal((n, 3))
    d[0::7, 0] = 0.0
    d[1::9, 1] = 0.0
    d[2::11, 2] = 0.0
    d[3::13, :2] = 0.0
    # every fifth ray: its origin on a face of a random leaf, in its plane
    face = np.arange(4, n, 5)
    leaf = rng.integers(0, lo.shape[0], face.size)
    ax = rng.integers(0, 3, face.size)
    side = rng.random(face.size) < 0.5
    o[face, ax] = np.where(side, lo.numpy()[leaf, ax], hi.numpy()[leaf, ax])
    d[face, ax] = 0.0
    # every sixth ray: towards a random point of a random leaf along a zero
    # axis (not its centre: a square face's box has its centre on the
    # face's diagonal, where the reference's bf16x3 product and the f32
    # test split a hit between the two triangles, ROADMAP queue 3)
    aim = np.arange(5, n, 6)
    leaf = rng.integers(0, lo.shape[0], aim.size)
    frac = 0.1 + 0.8 * rng.random((aim.size, 3))
    ctr = lo.numpy()[leaf] + frac * (hi - lo).numpy()[leaf]
    d[aim, rng.integers(0, 3, aim.size)] = 0.0
    d[~d.any(axis=1), 1] = 1.0  # no all-zero direction
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[aim] = ctr - 4.0 * d[aim]
    return o, d


@pytest.fixture(scope="module")
def scene():
    r = Renderer(sponza_like_scene(3, 1), RenderConfig(width=32, height=16, precision="bf16"),
                 device="cpu")
    f = r.frame
    lo, hi, tree = T._packet_tables(f)
    rng = np.random.default_rng(17)
    o, d = _zero_axis_rays(lo[:tree.sizes[0]], hi[:tree.sizes[0]], rng, N_RAYS)
    maxd = np.where(rng.random(N_RAYS) < 0.5, 1e5, 1 + 40 * rng.random(N_RAYS))
    maxd[6::17] = 0.0  # dead lanes
    skip = np.where(rng.random(N_RAYS) < 0.3,
                    rng.integers(0, int(f.dense_tri.max()) + 1, N_RAYS), -1)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    rays = (f32(o), f32(d), torch.tensor(skip, dtype=torch.int32), torch.full((N_RAYS,), 1e-2),
            f32(maxd))
    assert bool(torch.isinf(1.0 / rays[1]).any(dim=1).float().mean() > 0.4)
    return dict(frame=f, lo=lo, hi=hi, tree=tree, rays=rays)


def _view_tree(scene, coef):
    w = walk_view(scene["tree"], coef)
    return w, BoxTree(w.boxes, w.levels, scene["tree"].sizes[1:], CHUNK)


def _band(form):
    return packet_band(get_precision("fp32"), "both") if form == "f32-both" else STRICT


@pytest.mark.parametrize("form", ["mxu3", "f32-both"])
@pytest.mark.parametrize("find_any", [False, True], ids=["closest", "any"])
def test_k6_walk_equals_plain(scene, form, find_any):
    band = _band(form)
    f = scene["frame"]
    coef = T.frame_table(f, band)
    w, view = _view_tree(scene, coef)
    got, overflow = warp_walk(*scene["rays"], coef, f.dense_tri, f.dense_obj, view, w.slices,
                              find_any=find_any, band=band, stack=w.stack, box=_box_exact0)
    want = dense_trace_multi_plain(*scene["rays"], coef, f.dense_tri, f.dense_obj,
                                   find_any=find_any, band=band)
    assert not overflow
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    hit = want[3] >= 0
    zero = torch.isinf(1.0 / scene["rays"][1]).any(dim=1)
    assert bool((hit & zero).any()) and bool((~hit).any())


def test_walk_view(scene):
    """Levels 1.. of the packet tree are a chunk tree (node i of level 1 is
    the union of leaves 4i .. 4i + 3, rows [128 i, 128 i + 128)), the
    leaves its slices, the stack 3 (levels - 1) + 1; a one-leaf table is
    its own chunk."""
    f, tree = scene["frame"], scene["tree"]
    coef = T.frame_table(f, STRICT)
    w, view = _view_tree(scene, coef)
    assert tree.sizes == (26, 7, 2, 1) and w.n_levels == 3 and w.stack == 7
    L = len(tree.sizes)
    offs = [sum(tree.sizes[lvl + 1:]) for lvl in range(L)]
    assert w.levels.tolist() == offs[1:] + list(tree.sizes[1:])
    assert torch.equal(w.slices, tree.boxes[offs[0]:])
    lo, hi = w.slices[:, :3], w.slices[:, 3:]
    for c in range(tree.sizes[1]):
        box = tree.boxes[offs[1] + c]
        assert torch.equal(box[:3], lo[4 * c:4 * c + 4].amin(0))
        assert torch.equal(box[3:], hi[4 * c:4 * c + 4].amax(0))
    one = build_tree(lo[:1], hi[:1], 20, LEAF)
    w1 = walk_view(one, coef[:20])
    assert w1.n_levels == 1 and w1.levels.tolist() == [0, 1] and w1.stack == 1
    assert torch.equal(w1.slices, one.boxes)


@pytest.mark.parametrize("form", ["mxu3", "f32-both"])
def test_zero_axis_rule_is_conservative(scene, form):
    """Every (ray, row) the plain version accepts: the rule (with the slab
    test) enters the row's leaf and each node above it; the rule cuts the
    leaves the zero-axis rays enter; an origin exactly on a face is
    inside."""
    band = _band(form)
    f, tree = scene["frame"], scene["tree"]
    coef = T.frame_table(f, band)
    o, d, skip, mind, maxd = scene["rays"]
    t, _u, _v, geom = tri_quantities(coef, o, d, band)
    acc = _accept(t, geom, skip, mind, maxd, f.dense_tri)
    ray, row = torch.nonzero(acc, as_tuple=True)
    zero = torch.isinf(1.0 / d)
    assert bool(zero[ray].any(dim=1).sum() > 20)
    L = len(tree.sizes)
    offs = [sum(tree.sizes[lvl + 1:]) for lvl in range(L)]
    node = row // LEAF
    for lvl in range(L):
        b = tree.boxes[offs[lvl] + node]
        _e, ok = _box_all(b, o[ray], d[ray], maxd[ray])
        inside = zero_axis_inside(b[:, :3], b[:, 3:], o[ray], 1.0 / d[ray])
        assert bool((ok & inside).all()), f"level {lvl}"
        node = node // 4
    # leaves entered by the zero-axis rays: the rule against the slab test alone
    z = torch.nonzero(zero.any(dim=1) & (maxd > mind))[:, 0]
    leaves = tree.boxes[offs[0]:]
    n = leaves.shape[0]
    rz = z.repeat_interleave(n)
    lb = leaves.repeat(z.numel(), 1)
    _e, ok = _box_all(lb, o[rz], d[rz], maxd[rz])
    inside = zero_axis_inside(lb[:, :3], lb[:, 3:], o[rz], 1.0 / d[rz])
    assert int((ok & inside).sum()) < int(ok.sum())
    # an origin exactly on the low face, d = 0 on that axis: inside, no NaN
    lo, hi = leaves[:1, :3], leaves[:1, 3:]
    oo = (lo + hi) * 0.5
    oo[0, 1] = lo[0, 1]
    dd = torch.tensor([[0.6, 0.0, 0.8]])
    assert bool(zero_axis_inside(lo, hi, oo, 1.0 / dd)[0])
    oo[0, 1] = lo[0, 1] - 2 * ZERO_AXIS_MARGIN * (1 + float(oo.abs().sum()))
    assert not bool(zero_axis_inside(lo, hi, oo, 1.0 / dd)[0])


def _box_all(b, o, d, maxd):
    """box_entry of rays (n, 3) against one box each (n, 6)."""
    inv = 1.0 / d
    t1 = (b[:, :3] - o) * inv
    t2 = (b[:, 3:] - o) * inv
    fin = torch.isfinite(t1) & torch.isfinite(t2)
    tmin = torch.where(fin, torch.minimum(t1, t2), -3e38).amax(dim=1)
    tmax = torch.where(fin, torch.maximum(t1, t2), 3e38).amin(dim=1)
    e = torch.clamp(tmin - 0.02, min=0.0)
    return e, fin.any(1) & (tmin <= tmax + 0.02) & (tmax + 0.02 >= 0) & (e < maxd)


@pytest.fixture(scope="module")
def jax_case():
    """colonnade-830 (`sponza_like_scene(3, 1)` without sky) in both
    packages, the same tables (tests/test_torch_packet.py's setup)."""
    w, h = 64, 8
    host = jax_sponza(3, 1, with_skybox=False)
    prec = jax_precision("bf16")
    jscene = build_scene_arrays(host, prec)
    frame = flatten_frame(host, prec, max_direct_lights=4, width=w, height=h)
    frame_np = {k: np.asarray(getattr(frame, k)) for k in tscene.tensor_fields(tscene.FrameInput)}
    frame_np.update(obj_layout=frame.obj_layout, n_lights=frame.n_lights,
                    dense_morton=frame.dense_morton)
    scene_np = {k: np.asarray(getattr(jscene, k))
                for k in tscene.tensor_fields(tscene.SceneArrays)}
    scene_np.update(n_meshes=jscene.n_meshes, sky_valid=jscene.sky_valid)
    _s, tframe = tscene.scene_from_numpy(scene_np, frame_np, "cpu")
    assert tscene.instance_tris(tframe) == 830
    return dict(prec=prec, scene=jscene, frame=frame, tframe=tframe,
                jcfg=JaxConfig(width=w, height=h, precision="bf16", traversal_impl="pallas"),
                cfg=RenderConfig(width=w, height=h, precision="bf16", traversal_impl="pallas"),
                R=w * h)


@pytest.mark.parametrize("find_any", [False, True], ids=["closest", "any"])
def test_zero_axis_rays_match_jax(jax_case, find_any):
    c = jax_case
    tf = c["tframe"]
    lo, hi, tree = T._packet_tables(tf)
    n0 = tree.sizes[0]
    ctr = tf.dense_center[None, :]
    rng = np.random.default_rng(29 + find_any)
    o, d = _zero_axis_rays(lo[:n0] + ctr, hi[:n0] + ctr, rng, c["R"])
    o, d = o.astype(np.float32), d.astype(np.float32)
    assert (d == 0).any(axis=1).mean() > 0.4
    maxd = np.where(rng.random(c["R"]) < 0.1, 0.0, 30.0).astype(np.float32)
    kw = dict(find_any=find_any, min_dist=0.01, max_dist=maxd)
    j, t = _both(c, o, d, **kw)
    dead = maxd == 0
    if find_any:
        _check_any(j, t, dead)
    else:
        _check_closest(c, j, t, o, d, dead)
    assert 0.05 < (t["tri"][~dead] >= 0).mean() < 0.95
