"""PyTorch port, the BVH walk's exact zero-axis rule and packed launch
(`ops/walk_pad.py`, `ops/traversal.py`).

- The pad by brute force: for each of the six (dtype, fallback) forms, on
  colonnade-830 (`sponza_like_scene(3, 1)`) and on a mesh of random
  triangles (thin ones among them), rays with an exact zero axis whose
  origins sit on, one ulp inside and one ulp outside each box's lo_a - pad
  and hi_a + pad, and rays aimed just past the triangles' extremes on that
  axis: every triangle that `ray_triangle_parts` accepts, over all
  triangles with no walk, lies in a box the rule lets in, with every box
  above it (any hit's reach, and closest hit at the smallest best t that
  keeps it); and the rule skips each box for the ray one ulp outside its
  grown face (so a pad too large fails too).  fp16 'dtype' takes no rule.
- `trace_rays_plain(..., exact0=True)` equals `exact0=False` bit for bit
  (t / u / v bits, ids) on zero-axis-heavy rays in every form (closest
  hit; any hit in bf16 'both'), with fewer steps where the form has a rule, and the JAX walk
  (in a fresh interpreter, as `test_torch_traversal.py` runs it) bit for
  bit in closest hit.
- `trace_rays_packed_plain` (the card route's launch: dead rays given
  the miss record unwalked, the live ones packed by `launch_order` on an
  incoherent launch, the results scattered back, around the plain
  version) equals the unpacked plain walk, in place and packed, counts
  included; dead rays get the miss record and zero counts; `launch_order`
  puts the live rays first, each part in the caller's order (closest hit
  in bf16 'both', any hit in fp32 'dtype')."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu_torch.config import RenderConfig, get_precision
from low_precision_raytracer_tpu_torch.models.procedural import (
    single_mesh_scene,
    sponza_like_scene,
)
from low_precision_raytracer_tpu_torch.models.scene import Mesh
from low_precision_raytracer_tpu_torch.ops import walk_pad
from low_precision_raytracer_tpu_torch.ops.traversal import (
    N_STATS,
    launch_order,
    node_pads,
    trace_rays_packed_plain,
    trace_rays_plain,
)
from low_precision_raytracer_tpu_torch.ops.triangle import accept_against, ray_triangle_parts
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_traversal import JaxProcess

FORMS = [(p, fb) for p in ("bf16", "fp16", "fp32") for fb in ("both", "dtype")]
IDS = [f"{p}-{fb}" for p, fb in FORMS]


def random_mesh(n=48, seed=5):
    """Random triangles in [-1, 1]^3, every fourth one thin."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, (n, 3, 3)).astype(np.float32)
    v[::4, 2] = v[::4, 0] + (v[::4, 1] - v[::4, 0]) * 0.5 + 1e-3
    return Mesh(positions=v.reshape(-1, 3), indices=np.arange(3 * n).reshape(n, 3))


SCENES = {"colonnade-830": lambda: sponza_like_scene(3, 1),
          "random": lambda: single_mesh_scene(random_mesh())}
_TABLES = {}


def walk_tables(name, precision):
    """(scene, frame) of the walk's route on the CPU, once a module."""
    key = (name, precision)
    if key not in _TABLES:
        r = Renderer(SCENES[name](), RenderConfig(width=16, height=16, precision=precision,
                                                  traversal_impl="jax"), device="cpu")
        _TABLES[key] = (r.scene, r.frame)
    return _TABLES[key]


def leaf_paths(scene):
    """Per triangle, its leaf node and every node above it: (T, depth + 1)
    i64, -1 past the root."""
    cnt = scene.blas_leaf_count.long()
    NB = cnt.numel()
    node = torch.repeat_interleave(torch.arange(NB), cnt)
    first = torch.repeat_interleave(scene.blas_leaf_offset.long(), cnt)
    slot = torch.arange(node.numel()) - torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    leaf = torch.full((scene.tri_v2.shape[0],), -1, dtype=torch.long)
    leaf[scene.blas_prim.long()[first + slot]] = node
    parent = scene.blas_parent.long()
    cols = [leaf]
    while bool((cols[-1] >= 0).any()):
        p = cols[-1]
        cols.append(torch.where(p >= 0, parent[p.clamp(min=0)], -1))
    return torch.stack(cols, 1)


def boundary_rays(scene, pads, dt, seed=0):
    """Rays in the dtype's values with one exact zero axis a, for each box
    and side: the origin's a at lo_a - pad (hi_a + pad) of the box for the
    ray itself, and one ulp inside and outside it; the other axes at random
    near the box, the direction random in the other two.  Then rays aimed
    at each triangle's centroid from an origin on its extreme on a, pushed
    past it by 1e-4 .. 0.3 of its extent.  -> (o, d) f32, and the rays one
    ulp outside a box's grown face with their boxes: (index, node) i64,
    where the origin reached the pad's fixed point and the pad grows with
    |o| by less than a quarter of it (not so for a thin triangle's box)."""
    rng = np.random.default_rng(seed)
    lo, hi = scene.blas_lo.float(), scene.blas_hi.float()
    NB = lo.shape[0]
    mind = torch.zeros(1)
    maxd = torch.full((1,), 1e5)
    os_, ds_, outside = [], [], []
    for node in range(NB):
        for a in range(3):
            for side in (0, 1):
                d = torch.from_numpy(rng.standard_normal(3)).float()
                d[a] = 0.0
                d = (d / d.norm()).to(dt).float()
                o = lo[node] + (hi[node] - lo[node]) * torch.from_numpy(rng.random(3)).float()
                o = (o + torch.from_numpy(rng.standard_normal(3)).float() * 0.5).to(dt).float()
                # one ulp outward moves o farther than the pad grows with it
                slow = float(pads[node, 1]) < 0.25
                fixed = False
                for _ in range(40):  # the pad depends on o: iterate to its fixed point
                    reach = walk_pad.ray_reach(o[None], d[None], mind, maxd)
                    pad = float(walk_pad.box_pad(o[None], d[None], lo[node][None],
                                                 hi[node][None], pads[node][None], reach,
                                                 reach.R)[0])
                    edge = float(lo[node, a]) - pad if side == 0 else float(hi[node, a]) + pad
                    edge = float(torch.tensor(edge).to(dt))
                    fixed = bool(reach.ok[0]) and edge == float(o[a])
                    if fixed or not bool(reach.ok[0]):
                        break
                    o[a] = edge
                for step in (-1, 0, 1):
                    oo = o.to(dt).clone()
                    for _ in range(abs(step)):
                        oo[a] = torch.nextafter(oo[a], torch.tensor(np.inf, dtype=dt) * step)
                    if fixed and slow and step == (1 if side else -1):
                        outside.append((len(os_), node))
                    os_.append(oo.float())
                    ds_.append(d)
    v2 = scene.tri_v2_f32.float()
    n, _ = torch.linalg.inv_ex(scene.tri_m_f32.double().reshape(-1, 3, 3))
    verts = torch.stack([v2 + n[:, :, 0].float(), v2 + n[:, :, 1].float(), v2], 1)  # (T, 3, 3)
    cen = verts.mean(1)
    for t in range(v2.shape[0]):
        for a in range(3):
            span = float(verts[t, :, a].max() - verts[t, :, a].min()) + 1e-3
            for off in (1e-4, 1e-3, 1e-2, 0.1, 0.3):
                for side in (0, 1):
                    o = cen[t] + torch.from_numpy(rng.standard_normal(3)).float() * 2
                    o[a] = (verts[t, :, a].min() - off * span if side == 0
                            else verts[t, :, a].max() + off * span)
                    d = cen[t] - o
                    d[a] = 0.0
                    if float(d.norm()) == 0:
                        continue
                    os_.append(o.to(dt).float())
                    ds_.append((d / d.norm()).to(dt).float())
    outside = torch.tensor(outside, dtype=torch.long)
    return torch.stack(os_), torch.stack(ds_), outside[:, 0], outside[:, 1]


@pytest.mark.parametrize("scene_name", list(SCENES))
@pytest.mark.parametrize("form", FORMS, ids=IDS)
def test_pad_holds_by_brute_force(scene_name, form):
    precision, fallback = form
    prec = get_precision(precision)
    dt = prec.dtype
    scene, _frame = walk_tables(scene_name, precision)
    if not walk_pad.rule_form(dt, fallback):
        assert precision == "fp16" and fallback == "dtype"
        return
    pads = node_pads(scene, prec, fallback)
    assert bool(torch.isfinite(pads).all())
    o, d, out_ray, out_node = boundary_rays(scene, pads, dt)
    n = o.shape[0]
    mind = torch.full((n,), 0.01)
    maxd = torch.full((n,), 1e5)
    T = scene.tri_v2.shape[0]
    od, dd = o.to(dt)[:, None, :], d.to(dt)[:, None, :]
    parts = ray_triangle_parts(od, dd, scene.tri_v2[None], scene.tri_m[None],
                               scene.tri_v2_f32[None], scene.tri_m_f32[None], mind[:, None],
                               maxd[:, None], prec, fallback=fallback)
    acc = accept_against(parts, torch.full((n, T), float("inf")))
    ray, tri = torch.nonzero(acc, as_tuple=True)
    assert ray.numel() > 0
    paths = leaf_paths(scene)[tri]  # (k, depth + 1)
    k, depth = paths.shape
    rr = ray[:, None].expand(k, depth)[paths >= 0]
    nodes = paths[paths >= 0]
    reach = walk_pad.ray_reach(o[rr], d[rr], mind[rr], maxd[rr])
    lo, hi = scene.blas_lo[nodes], scene.blas_hi[nodes]
    ok_any = walk_pad.rule_enters(o[rr], d[rr], lo, hi, pads[nodes], reach, None, True)
    assert bool(ok_any.all()), f"{int((~ok_any).sum())} accepted (ray, box) pairs skipped"
    # closest hit: the smallest best t that still admits the hit
    t_hit = torch.maximum(parts.t[ray, tri], parts.t32[ray, tri])
    best = torch.nextafter(t_hit, torch.full_like(t_hit, float("inf")))
    best = best[:, None].expand(k, depth)[paths >= 0]
    ok_closest = walk_pad.rule_enters(o[rr], d[rr], lo, hi, pads[nodes], reach, best, False)
    assert bool(ok_closest.all())
    # the rays sit on the rule's edges: it skips each box for the ray one
    # ulp outside its grown face, so a larger pad would fail here
    assert bool((d == 0).any(dim=1).all())
    reach = walk_pad.ray_reach(o[out_ray], d[out_ray], mind[out_ray], maxd[out_ray])
    enters = walk_pad.rule_enters(o[out_ray], d[out_ray], scene.blas_lo[out_node],
                                  scene.blas_hi[out_node], pads[out_node], reach, None, True)
    assert out_ray.numel() > 0
    if scene_name == "colonnade-830":  # a few bf16 origins cycle between two values
        assert out_ray.numel() >= 0.95 * 6 * scene.blas_lo.shape[0]
    assert not bool(enters.any()), f"{int(enters.sum())} boxes entered one ulp outside"


def zero_axis_rays(frame, n=256, seed=3):
    """Rays from inside the scene box with one exact zero direction axis
    (half of them the sun's direction with d_x = 0), per-ray min / max
    distances, some dead (max <= min)."""
    rng = np.random.default_rng(seed)
    lo, hi = frame.obj_aabb_lo.min(0).values.float(), frame.obj_aabb_hi.max(0).values.float()
    o = lo + (hi - lo) * torch.from_numpy(rng.random((n, 3))).float()
    ld = frame.light_dir[0].float()
    sun = -ld / ld.norm()
    sun[0] = 0.0
    d = torch.from_numpy(rng.standard_normal((n, 3))).float()
    d[torch.arange(n), torch.from_numpy(rng.integers(0, 3, n))] = 0.0
    d[: n // 2] = sun
    d = d / d.norm(dim=1, keepdim=True)
    mind = torch.from_numpy(rng.random(n) * 0.05).float()
    maxd = torch.where(torch.from_numpy(rng.random(n) < 0.2),
                       torch.from_numpy(rng.random(n) * 3).float(), torch.tensor(1e5))
    maxd[::17] = 0.0
    return o, d, mind, maxd


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


# every form in closest hit (against the JAX walk too), any hit in bf16 'both'
CASES = [(p, fb, False) for p, fb in FORMS] + [("bf16", "both", True)]
JAX_CASES = [c for c in CASES if not c[2]]


def jax_walk_refs(payload):
    """Child process: the JAX `trace_rays` on colonnade-830 of each case ->
    {case: (t, u, v, tri, obj)} as numpy."""
    from low_precision_raytracer_tpu.config import get_precision as jax_precision
    from low_precision_raytracer_tpu.models import procedural as jproc
    from low_precision_raytracer_tpu.models.scene import build_scene_arrays, flatten_frame
    from low_precision_raytracer_tpu.ops.traversal import trace_rays as jax_trace_rays

    rays, cases = payload
    out = {}
    for precision in ("bf16", "fp16", "fp32"):
        host = jproc.sponza_like_scene(3, 1)
        prec = jax_precision(precision)
        scene = build_scene_arrays(host, prec, leaf_size=4)
        frame = flatten_frame(host, prec, max_direct_lights=4, width=16, height=16)
        r = rays[precision]
        for case in cases:
            if case[0] != precision:
                continue
            hit = jax_trace_rays(scene, frame, jnp.asarray(r[0]), jnp.asarray(r[1]), prec=prec,
                                 find_any=case[2], fallback=case[1], leaf_size=4,
                                 min_dist=jnp.asarray(r[2]), max_dist=jnp.asarray(r[3]))
            out[case] = tuple(np.asarray(x) for x in hit)
    return out


@pytest.fixture(scope="module")
def exact0_walks():
    """{case: (JAX hit, exact0=False hit and counts, exact0=True hit and
    counts)}: the JAX walks run in their own process meanwhile."""
    rays = {p: zero_axis_rays(walk_tables("colonnade-830", p)[1]) for p in ("bf16", "fp16",
                                                                            "fp32")}
    proc = JaxProcess("test_torch_walk_rule", "jax_walk_refs",
                      ({p: tuple(x.numpy() for x in r) for p, r in rays.items()}, JAX_CASES))
    port = {}
    for case in CASES:
        precision, fallback, find_any = case
        scene, frame = walk_tables("colonnade-830", precision)
        o, d, mind, maxd = rays[precision]
        kw = dict(prec=get_precision(precision), find_any=find_any, fallback=fallback,
                  min_dist=mind, max_dist=maxd)
        s0 = torch.zeros((o.shape[0], N_STATS), dtype=torch.int32)
        s1 = torch.zeros_like(s0)
        ref = trace_rays_plain(scene, frame, o, d, **kw, stats=s0)
        got = trace_rays_plain(scene, frame, o, d, **kw, stats=s1, exact0=True)
        port[case] = (ref, s0, got, s1)
    jax_out = proc.result()
    return {case: (jax_out.get(case), *port[case]) for case in CASES}


@pytest.mark.parametrize("case", CASES, ids=[f"{p}-{fb}-{a}" for p, fb, a in CASES])
def test_exact0_plain_equals_jax_walk(exact0_walks, case):
    precision, fallback, find_any = case
    jax_hit, ref, s0, got, s1 = exact0_walks[case]
    for x, y in zip(ref, got):
        assert torch.equal(bits(x), bits(y))
    assert int((ref[3] >= 0).sum()) > 20
    if jax_hit is not None:
        for x, y in zip(jax_hit, got):
            assert torch.equal(bits(torch.from_numpy(np.asarray(x))), bits(y))
    if walk_pad.rule_form(get_precision(precision).dtype, fallback):
        assert int(s1[:, :2].sum()) < int(s0[:, :2].sum())
    else:
        assert torch.equal(s0, s1)


@pytest.mark.parametrize("coherent", [True, False])
@pytest.mark.parametrize("form", [("bf16", "both", False), ("fp32", "dtype", True)],
                         ids=["bf16-both-closest", "fp32-dtype-any"])
def test_packed_launch_equals_unpacked(form, coherent):
    precision, fallback, find_any = form
    prec = get_precision(precision)
    scene, frame = walk_tables("colonnade-830", precision)
    o, d, mind, maxd = zero_axis_rays(frame, n=160, seed=4)
    mind[5] = float("nan")
    maxd[7] = mind[7]
    kw = dict(prec=prec, find_any=find_any, fallback=fallback, min_dist=mind, max_dist=maxd)
    s0 = torch.zeros((o.shape[0], N_STATS), dtype=torch.int32)
    s1 = torch.full_like(s0, 7)
    ref = trace_rays_plain(scene, frame, o, d, **kw, stats=s0)
    got = trace_rays_packed_plain(scene, frame, o, d, coherent=coherent, **kw, stats=s1)
    for x, y in zip(ref, got):
        assert torch.equal(bits(x), bits(y))
    assert int((ref[3] >= 0).sum()) > 10
    dead = ~(maxd > mind)
    assert int(dead.sum()) >= 10
    assert bool((got[0][dead] == 1e5).all()) and bool((got[3][dead] == -1).all())
    assert bool((got[1][dead] == 0).all()) and bool((got[4][dead] == -1).all())
    assert bool((s1[dead] == 0).all())
    assert torch.equal(s0[~dead], s1[~dead])
    live = maxd > mind
    order = launch_order(mind, maxd).long()
    n_live = int(live.sum())
    assert torch.equal(order[:n_live], torch.nonzero(live).flatten())
    assert torch.equal(order[n_live:], torch.nonzero(~live).flatten())
