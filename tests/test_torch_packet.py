"""PyTorch port, the packet BVH route (K6, `ops/packet_trace.py`) against
the JAX package's `trace_rays_packet` / `trace_rays_packet_sorted(...,
interpret=True)`, both reached through each package's own `trace` with
`traversal_impl='pallas'` (bf16, fallback 'mxu3'), on the same tables:
Cornell and `sponza_like_scene(2, 1)` without sky at 16 x 128 rays (the
JAX tests' scenes: single-level leaf schedules), and colonnade-46k,
`sponza_like_scene(6, 3)` without sky, at 8 x 128 (1,456 leaves >
`L1_MIN_LEAVES`: the TPU kernel's two-level schedule, and more than 4096
instance triangles, so incoherent launches take the sorted walk).

Bars (tests/test_dense_pallas.py:145-150): closest hit — hit masks equal,
tri agreement > 0.999 with obj equal and t/u/v within rtol/atol 2e-3 where
it agrees; a lane whose two triangles lie at the same float64 distance
counts as agreeing (the TPU kernel keeps the first winner it visits across
its 128-row groups, the port the smaller tri: the rule of ROADMAP queue 3),
plain agreement must still exceed 0.99; any hit — occlusion agreement >
0.999 (the TPU kernel returns the hit it stopped on, the port the 0 / -1
marker); dead lanes exactly -1 on both sides; skip_tri honoured.

Within the port: the sorted launch equals the unsorted one bit for bit;
`morton_key` equals the JAX `_morton_key` bit for bit in both modes; and
the kernel's walk (`csrc/trace_common.cuh`, which `csrc/packet_trace.cu`
runs over the 32-row leaves and `csrc/dense_multi.cu` over the 128-row
chunks: an ordered depth-first walk of the 4-ary tree with a stack, children pushed farthest first, a node
skipped when its entry exceeds the best t, any hit stopping at its first
accepted row), emulated here in PyTorch, equals the plain version's global
(t, tri, row) minimum bit for bit, on a constructed equal-t tie across two
leaves too.  Routes: `resolve_impl` and the gates that read it."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import dataclasses
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import RenderConfig as JaxConfig
from low_precision_raytracer_tpu.config import get_precision as jax_precision
from low_precision_raytracer_tpu.models.procedural import cornell_box_scene as jax_cornell
from low_precision_raytracer_tpu.models.procedural import sponza_like_scene as jax_sponza
from low_precision_raytracer_tpu.models.scene import build_scene_arrays, flatten_frame
from low_precision_raytracer_tpu.ops.camera import primary_ray_grid
from low_precision_raytracer_tpu.ops.dense_pallas import _morton_key
from low_precision_raytracer_tpu.ops.trace import di_fusible as jax_di_fusible
from low_precision_raytracer_tpu.ops.trace import incoherent_reorders as jax_reorders
from low_precision_raytracer_tpu.ops.trace import moveforward_eps as jax_moveforward_eps
from low_precision_raytracer_tpu.ops.trace import trace as jax_trace
from low_precision_raytracer_tpu.ops.traversal_pallas import L1_MIN_LEAVES
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models import scene as tscene
from low_precision_raytracer_tpu_torch.models.procedural import sponza_like_scene
from low_precision_raytracer_tpu_torch.ops.camera import primary_ray_grid as torch_ray_grid
from low_precision_raytracer_tpu_torch.ops.dense_trace import (
    CHUNK,
    FAN,
    STRICT,
    build_tree,
    coef_table,
    dense_trace_multi_plain,
    m_shift_test,
    pack_uv,
)
from low_precision_raytracer_tpu_torch.ops.packet_trace import (
    LEAF,
    morton_key,
    packet_trace_sorted,
)
from low_precision_raytracer_tpu_torch.ops.trace import (
    _wavefront_route,
    check_scene,
    di_fusible,
    incoherent_reorders,
    moveforward_eps,
    resolve_impl,
    trace,
)
from low_precision_raytracer_tpu_torch.render.renderer import Renderer

SCENES = {  # name -> (host builder, grid (H, W), instance triangles)
    "cornell": (jax_cornell, (16, 128), 34),
    "colonnade-370": (lambda: jax_sponza(2, 1, with_skybox=False), (16, 128), 370),
    "colonnade-46k": (lambda: jax_sponza(6, 3, with_skybox=False), (8, 128), 46514),
}


@pytest.fixture(scope="module", params=list(SCENES))
def setup(request):
    build, (h, w), ti = SCENES[request.param]
    host = build()
    prec = jax_precision("bf16")
    scene = build_scene_arrays(host, prec)
    frame = flatten_frame(host, prec, max_direct_lights=4, width=w, height=h)
    frame_np = {k: np.asarray(getattr(frame, k)) for k in tscene.tensor_fields(tscene.FrameInput)}
    frame_np.update(obj_layout=frame.obj_layout, n_lights=frame.n_lights,
                    dense_morton=frame.dense_morton)
    scene_np = {k: np.asarray(getattr(scene, k)) for k in tscene.tensor_fields(tscene.SceneArrays)}
    scene_np.update(n_meshes=scene.n_meshes, sky_valid=scene.sky_valid)
    _s, tframe = tscene.scene_from_numpy(scene_np, frame_np, "cpu")
    assert tscene.instance_tris(tframe) == ti
    o, d = primary_ray_grid(frame.cam_l2w_f32, frame.cam_fov_y_f32, w, h, jnp.float32)
    c = dict(name=request.param, prec=prec, scene=scene, frame=frame, tframe=tframe,
             jcfg=JaxConfig(width=w, height=h, precision="bf16", traversal_impl="pallas"),
             cfg=RenderConfig(width=w, height=h, precision="bf16", traversal_impl="pallas"),
             o=np.array(o).reshape(-1, 3), d=np.array(d).reshape(-1, 3), R=h * w)
    c["primary"] = _both(c, c["o"], c["d"])
    return c


def _both(c, o, d, **kw):
    """One launch through both packages' trace dispatch.  -> (jax, port)
    hit records as numpy dicts."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    hj = jax_trace(c["scene"], c["frame"], jnp.asarray(o), jnp.asarray(d), prec=c["prec"],
                   cfg=c["jcfg"], **jkw)
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ht = trace(c["tframe"], torch.from_numpy(o), torch.from_numpy(d), cfg=c["cfg"],
               prec=c["cfg"].prec, **tkw)
    names = ("t", "u", "v", "tri", "obj")
    return ({k: np.asarray(getattr(hj, k)) for k in names},
            {k: getattr(ht, k).numpy() for k in names})


def _t64(c, o, d, tri, obj):
    """float64 distance along each ray to the table row of (obj, tri)."""
    tf = c["tframe"]
    rows_key = tf.dense_obj.numpy().astype(np.int64) << 24 | tf.dense_tri.numpy()
    order = np.argsort(rows_key)
    row = order[np.searchsorted(rows_key[order], obj.astype(np.int64) << 24 | tri)]
    n = tf.dense_n_f32.numpy().astype(np.float64).reshape(-1, 3, 3)[row]
    e = tf.dense_e.numpy().astype(np.float64)[row]
    oc = o.astype(np.float64) - tf.dense_center.numpy().astype(np.float64)
    oz = np.einsum("rj,rj->r", n[:, 2], oc) + e[:, 2]
    dz = np.einsum("rj,rj->r", n[:, 2], d.astype(np.float64))
    return -oz / dz


def _check_closest(c, j, t, o, d, dead):
    np.testing.assert_array_equal(j["tri"] >= 0, t["tri"] >= 0)
    same = j["tri"] == t["tri"]
    diff = ~same
    t_j = _t64(c, o[diff], d[diff], j["tri"][diff], j["obj"][diff])
    t_p = _t64(c, o[diff], d[diff], t["tri"][diff], t["obj"][diff])
    tie = np.zeros_like(same)
    tie[diff] = np.abs(t_j - t_p) <= 1e-5 * np.maximum(1.0, np.abs(t_p))
    assert same.mean() > 0.99 and (same | tie).mean() > 0.999, \
        f"tri agreement {same.mean()}, with ties {(same | tie).mean()}"
    np.testing.assert_array_equal(j["obj"][same], t["obj"][same])
    hit = same & (t["tri"] >= 0)
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(t[k][hit], j[k][hit], rtol=2e-3, atol=2e-3, err_msg=k)
    for r in (j, t):
        np.testing.assert_array_equal(r["tri"][dead], -1)
    np.testing.assert_array_equal(t["t"][dead], 1e5)


def _check_any(j, t, dead):
    occ_j, occ_t = j["tri"] >= 0, t["tri"] >= 0
    assert (occ_j == occ_t).mean() > 0.999, f"occlusion agreement {(occ_j == occ_t).mean()}"
    for r in (j, t):
        np.testing.assert_array_equal(r["tri"][dead], -1)
    np.testing.assert_array_equal(t["tri"][occ_t], 0)
    np.testing.assert_array_equal(t["obj"], -1)
    np.testing.assert_array_equal(t["t"], 1e5)


def _bounce(c, seed):
    """GI-shaped rays: origins on the primary hits, random directions away
    from the camera, the hit triangle skipped, dead lanes where the primary
    missed and at random (10%)."""
    rng = np.random.default_rng(seed)
    j0, _ = c["primary"]
    valid = j0["tri"] >= 0
    p = (c["o"] + np.where(valid, j0["t"], 0)[:, None] * c["d"]).astype(np.float32)
    d = rng.normal(size=(c["R"], 3)).astype(np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(np.sum(d * c["d"], axis=1, keepdims=True) > 0, -d, d).astype(np.float32)
    maxd = np.where(valid & (rng.random(c["R"]) > 0.1), 1e5, 0.0).astype(np.float32)
    skip = np.where(valid, j0["tri"], -1).astype(np.int32)
    return p, d, skip, maxd


def _shadows(c, p, valid, skip, rng):
    """Pixel-major (n L) shadow commands from points p toward the frame's
    lights, each direction tilted at random by ~1e-3 rad (off the sun's
    in-face-plane edge case, ROADMAP queue 3); invalid points and 20% of
    the slots at random are dead.  -> (o, d, skip, maxd, dead, L)."""
    f = c["frame"]
    L = f.n_lights
    n = p.shape[0]
    lt = np.asarray(f.light_type)[:L]
    lpos = np.asarray(f.light_pos.astype(jnp.float32))[:L]
    ldir = np.asarray(f.light_dir.astype(jnp.float32))[:L]
    dirs, maxd = [], []
    for i in range(L):
        if lt[i] == 2:  # directional
            dd = np.broadcast_to(-ldir[i] / np.linalg.norm(ldir[i]), (n, 3))
            mx = np.full(n, 1000.0, np.float32)
        else:
            v = lpos[i][None, :] - p
            mx = np.linalg.norm(v, axis=1)
            dd = v / mx[:, None]
        dd = dd + 1e-3 * rng.normal(size=(n, 3))
        dirs.append(dd / np.linalg.norm(dd, axis=1, keepdims=True))
        maxd.append(mx)
    d = np.stack(dirs, axis=1).astype(np.float32)
    live = valid[:, None] & (rng.random((n, L)) > 0.2)
    maxd = np.where(live, np.stack(maxd, axis=1), 0.0).astype(np.float32)
    o = np.broadcast_to(p[:, None, :], (n, L, 3)).reshape(-1, 3).astype(np.float32)
    skips = np.repeat(np.where(valid, skip, -1), L).astype(np.int32)
    return o, d.reshape(-1, 3), skips, maxd.reshape(-1), ~live.reshape(-1), L


def test_primary_closest(setup):
    j, t = setup["primary"]
    _check_closest(setup, j, t, setup["o"], setup["d"], np.zeros(setup["R"], bool))
    assert 0.1 < (t["tri"] >= 0).mean()


def _bounce_closest(c):
    """The GI bounce (seed 5) through both packages, once per scene: ->
    (rays (p, d, skip, maxd), (jax, port)); the round-1 shadows start from
    its hits."""
    if "bounce" not in c:
        p, d, skip, maxd = _bounce(c, 5)
        c["bounce"] = (p, d, skip, maxd), _both(c, p, d, skip_tri=skip, min_dist=0.1,
                                                max_dist=maxd, coherent=False)
    return c["bounce"]


def test_bounce_closest(setup):
    """The GI bounce (coherent=False: the sorted walk on colonnade-46k)."""
    c = setup
    (p, d, skip, maxd), (j, t) = _bounce_closest(c)
    _check_closest(c, j, t, p, d, maxd == 0)
    assert (t["tri"][maxd > 0] >= 0).mean() > 0.2


@pytest.mark.parametrize("coherent", [True, False], ids=["round0", "round1_sorted"])
def test_shadows_any_hit(setup, coherent):
    """Shadow commands, lane_k = the light count, from the primary hits
    (round 0, coherent) or from the bounce hits (round 1)."""
    c = setup
    rng = np.random.default_rng(11 if coherent else 12)
    j0, _ = c["primary"]
    if coherent:
        p = (c["o"] + j0["t"][:, None] * c["d"]).astype(np.float32)
        valid, skip = j0["tri"] >= 0, j0["tri"]
    else:
        (p, d, _skip, _maxd), (jg, _) = _bounce_closest(c)
        p = (p + np.where(jg["tri"] >= 0, jg["t"], 0)[:, None] * d).astype(np.float32)
        valid, skip = jg["tri"] >= 0, jg["tri"]
    o, d, skips, maxd, dead, L = _shadows(c, p, valid, skip, rng)
    j, t = _both(c, o, d, find_any=True, skip_tri=skips, min_dist=0.1, max_dist=maxd,
                 coherent=coherent, lane_k=L)
    _check_any(j, t, dead)
    if c["name"] != "cornell":  # the closed box: every live shadow ray is clear
        assert 0.02 < (t["tri"][~dead] >= 0).mean() < 0.98


def test_skip_tri(setup):
    """The primary rays again with their hit triangle skipped: never
    re-hit, and both packages agree on what lies behind it."""
    c = setup
    j0, _ = c["primary"]
    skip = j0["tri"].astype(np.int32)
    j, t = _both(c, c["o"], c["d"], skip_tri=skip)
    hit0 = skip >= 0
    assert (t["tri"][hit0] != skip[hit0]).all() and (j["tri"][hit0] != skip[hit0]).all()
    _check_closest(c, j, t, c["o"], c["d"], np.zeros(c["R"], bool))


def _launch_args(tf, o, d, skip, mind, maxd):
    c = tf.dense_center
    return ((torch.from_numpy(o) - c).contiguous(), torch.from_numpy(d).contiguous(),
            torch.from_numpy(skip), torch.from_numpy(mind), torch.from_numpy(maxd),
            coef_table(tf), tf.dense_tri, tf.dense_obj, (tf.dense_leaf_lo - c).contiguous(),
            (tf.dense_leaf_hi - c).contiguous())


def _entry(tree, gidx, o, inv, maxd):
    """The kernel's `box_entry` of rays (m, 3) against boxes (m, k) of the
    flat tree: -> (entry (m, k), ok (m, k))."""
    b = tree.boxes[gidx]
    t1 = (b[..., :3] - o[:, None]) * inv[:, None]
    t2 = (b[..., 3:] - o[:, None]) * inv[:, None]
    a, bb = torch.minimum(t1, t2), torch.maximum(t1, t2)
    fin = torch.isfinite(t1) & torch.isfinite(t2)
    tmin = torch.where(fin, a, -3e38).amax(dim=-1)
    tmax = torch.where(fin, bb, 3e38).amin(dim=-1)
    e = torch.clamp(tmin - 0.02, min=0.0)
    ok = fin.any(-1) & (tmin <= tmax + 0.02) & (tmax + 0.02 >= 0) & (e < maxd[:, None])
    return e, ok


class _Packed:
    """The kernels' packed epilogue (`trace_common.cuh:PackedBest`) per ray,
    vectorised: a running chunk key minimum, folded at each chunk's end
    into the least (t, row)."""

    def __init__(self, n, lmask):
        self.lmask = lmask
        self.t = torch.full((n,), 1e5)
        self.u, self.v = torch.zeros(n), torch.zeros(n)
        self.row = torch.full((n,), -1, dtype=torch.int64)
        self.kmin = torch.full((n,), 2**31 - 1, dtype=torch.int32)
        self.ct, self.cu, self.cv = torch.zeros(n), torch.zeros(n), torch.zeros(n)

    def row_test(self, idx, acc, t, u, v, local):
        """Rays `idx` with the row at `local` of their chunk."""
        key = (t.view(torch.int32) & ~self.lmask) | local
        take = acc & (t > 0) & (key < self.kmin[idx])
        w = idx[take]
        self.kmin[w], self.ct[w], self.cu[w], self.cv[w] = key[take], t[take], u[take], v[take]

    def end_chunk(self, idx, first):
        got = self.kmin[idx] != 2**31 - 1
        r = first + (self.kmin[idx] & self.lmask).long()
        ct, bt, brow = self.ct[idx], self.t[idx], self.row[idx]
        better = got & ((ct < bt) | ((ct == bt) & (r < brow)))
        w = idx[better]
        self.t[w], self.u[w], self.v[w], self.row[w] = ct[better], self.cu[w], self.cv[w], r[better]
        self.kmin[idx] = 2**31 - 1

    def out(self):
        pk = torch.where(self.row >= 0, pack_uv(self.u, self.v), -1).to(torch.int32)
        return self.t, self.row.to(torch.int32), pk


def _row_loop(o, d, skip, mind, maxd, coef, tri_ids, obj_ids, find_any, band, pack=False,
              leaf=CHUNK):
    """The kernels' loop over every row in order under a widened band, with
    their update rule (any hit: the first accepted row blocks; `pack`: the
    packed epilogue over chunks of `leaf` rows)."""
    n, TI = o.shape[0], coef.shape[0]
    t, u, v, geom = m_shift_test([coef[:, i][None, :] for i in range(coef.shape[1])],
                                 o[:, :, None], d[:, :, None], band)
    acc = (geom & (t > mind[:, None]) & (t < maxd[:, None])
           & (tri_ids[None, :] != skip[:, None]) & torch.isfinite(t))
    if pack:
        pb, every = _Packed(n, leaf - 1), torch.arange(n)
        for k in range(TI):
            pb.row_test(every, acc[:, k], t[:, k], u[:, k], v[:, k], k % leaf)
            if k % leaf == leaf - 1 or k == TI - 1:
                pb.end_chunk(every, k - k % leaf)
        return pb.out()
    if find_any:
        return (torch.full((n,), 1e5), torch.zeros(n), torch.zeros(n),
                torch.where(acc.any(1), 0, -1).to(torch.int32),
                torch.full((n,), -1, dtype=torch.int32))
    bt = torch.full((n,), 1e5)
    bu, bv = torch.zeros(n), torch.zeros(n)
    btri = torch.full((n,), -1, dtype=torch.int32)
    brow = torch.full((n,), -1, dtype=torch.int64)
    for k in range(TI):
        tk, trk = t[:, k], tri_ids[k]
        better = acc[:, k] & ((tk < bt) | ((tk == bt) & ((trk < btri) | ((trk == btri) & (k < brow)))))
        bt = torch.where(better, tk, bt)
        bu = torch.where(better, u[:, k], bu)
        bv = torch.where(better, v[:, k], bv)
        btri = torch.where(better, trk, btri)
        brow = torch.where(better, k, brow)
    obj = torch.where(brow >= 0, obj_ids[brow.clamp(min=0)], -1).to(torch.int32)
    return bt, bu, bv, btri, obj


def _walk(o, d, skip, mind, maxd, coef, tri_ids, obj_ids, tree, find_any, band=STRICT,
          pack=False):
    """The kernels' tree walk in PyTorch, vectorised over rays: per ray a
    stack of (level, index, entry); pop, skip a node whose entry exceeds
    the best t (closest hit), test a leaf's `tree.leaf` rows in order (the
    kernel's update rule, the test accepted by `band`; `pack`: the packed
    epilogue, a leaf one chunk, -> (t, row, pk)) or push an internal
    node's entered children farthest first (equal entries: the lower index
    on top).  Under a widened band the kernels walk no tree: every row, in
    order (`_row_loop`)."""
    if band.widened:
        return _row_loop(o, d, skip, mind, maxd, coef, tri_ids, obj_ids, find_any, band,
                         pack, tree.leaf)
    n, TI = o.shape[0], coef.shape[0]
    leaf = tree.leaf
    pb = _Packed(n, leaf - 1) if pack else None
    L = len(tree.sizes)
    offs = tree.levels[:L].long()
    sizes = torch.tensor(tree.sizes)
    S = 3 * (L - 1) + 1
    st_lvl = torch.zeros((n, S), dtype=torch.int64)
    st_idx = torch.zeros((n, S), dtype=torch.int64)
    st_ent = torch.zeros((n, S))
    sp = torch.zeros(n, dtype=torch.int64)
    inv = 1.0 / d
    live = maxd > mind
    e, ok = _entry(tree, offs[L - 1].expand(n, 1), o, inv, maxd)
    root = live & ok[:, 0]
    st_lvl[root, 0] = L - 1
    st_ent[root, 0] = e[root, 0]
    sp[root] = 1
    bt = pb.t if pack else torch.full((n,), 1e5)  # the pruning bound: the best t
    bu, bv = torch.zeros(n), torch.zeros(n)
    btri = torch.full((n,), -1, dtype=torch.int32)
    brow = torch.full((n,), -1, dtype=torch.int64)
    while bool((sp > 0).any()):
        act = torch.nonzero(sp > 0)[:, 0]
        sp[act] -= 1
        s = sp[act]
        lvl, idx, ent = st_lvl[act, s], st_idx[act, s], st_ent[act, s]
        go = torch.ones_like(lvl, dtype=torch.bool) if find_any else ~(ent > bt[act])
        lf, li = act[go & (lvl == 0)], idx[go & (lvl == 0)]
        if lf.numel():
            rows = li[:, None] * leaf + torch.arange(leaf)[None, :]
            cr = coef[rows.clamp(max=TI - 1)]
            t, u, v, geom = m_shift_test([cr[..., i] for i in range(coef.shape[1])],
                                         o[lf][:, :, None], d[lf][:, :, None], band)
            tri = tri_ids[rows.clamp(max=TI - 1)]
            acc = ((rows < TI) & geom & (t > mind[lf, None])
                   & (t < maxd[lf, None]) & (tri != skip[lf, None]) & torch.isfinite(t))
            if pack:
                for k in range(leaf):
                    pb.row_test(lf, acc[:, k], t[:, k], u[:, k], v[:, k], k)
                pb.end_chunk(lf, li * leaf)
            elif find_any:
                hit = lf[acc.any(1)]
                btri[hit] = 0
                sp[hit] = 0
            else:
                for k in range(leaf):
                    tk, trk, rk = t[:, k], tri[:, k], rows[:, k]
                    b_t, b_tri, b_row = bt[lf], btri[lf], brow[lf]
                    better = acc[:, k] & ((tk < b_t) | ((tk == b_t) & (
                        (trk < b_tri) | ((trk == b_tri) & (rk < b_row)))))
                    w = lf[better]
                    bt[w], bu[w], bv[w] = tk[better], u[better, k], v[better, k]
                    btri[w], brow[w] = trk[better], rk[better]
        nd, ni, nl = act[go & (lvl > 0)], idx[go & (lvl > 0)], lvl[go & (lvl > 0)]
        if nd.numel():
            cl = nl - 1
            ch = ni[:, None] * FAN + torch.arange(FAN)[None, :]
            exists = ch < sizes[cl][:, None]
            gidx = offs[cl][:, None] + torch.minimum(ch, sizes[cl][:, None] - 1)
            e, ok = _entry(tree, gidx, o[nd], inv[nd], maxd[nd])
            ok &= exists
            if not find_any:
                ok &= ~(e > bt[nd][:, None])
            # farthest first; among equal entries the higher index first
            ev = torch.where(ok, e, -float("inf")).flip(1)
            order = torch.sort(ev, dim=1, descending=True, stable=True).indices
            ch_s, e_s = ch.flip(1).gather(1, order), ev.gather(1, order)
            cnt = ok.sum(1)
            for j in range(FAN):
                m = j < cnt
                rws, at = nd[m], sp[nd[m]]
                assert bool((at < S).all()), "stack overflow"
                st_lvl[rws, at], st_idx[rws, at], st_ent[rws, at] = cl[m], ch_s[m, j], e_s[m, j]
                sp[rws] += 1
    if pack:
        return pb.out()
    if find_any:
        return (torch.full((n,), 1e5), torch.zeros(n), torch.zeros(n), btri,
                torch.full((n,), -1, dtype=torch.int32))
    obj = torch.where(brow >= 0, obj_ids[brow.clamp(min=0)], -1).to(torch.int32)
    return bt, bu, bv, btri, obj


@pytest.mark.parametrize("find_any", [False, True], ids=["closest", "any"])
def test_walk_and_sort_equal_plain(setup, find_any):
    """Bit for bit on a GI-shaped launch (any hit: shadow-shaped, toward the
    lights): the kernel's walk (emulated) and the sorted launch (on the CPU:
    key, sort, the plain version, scatter back) both equal the plain global
    minimum."""
    c = setup
    p, d, skip, maxd = _bounce(c, 9)
    if find_any:
        p, d, skip, maxd, _dead, _L = _shadows(c, p, maxd > 0, skip, np.random.default_rng(3))
    args = _launch_args(c["tframe"], p, d, skip, np.full(p.shape[0], 0.1, np.float32), maxd)
    tree = build_tree(args[8], args[9], args[5].shape[0], LEAF)
    plain = dense_trace_multi_plain(*args[:8], find_any=find_any)
    for a, b in zip(packet_trace_sorted(*args, find_any=find_any), plain):
        assert torch.equal(a, b)
    # the emulated walk on a strided quarter of the lanes (it loops per pop)
    sel = torch.arange(0, p.shape[0], 4)
    sub = [a[sel] for a in args[:5]] + list(args[5:8])
    for a, b in zip(_walk(*sub, tree, find_any), plain):
        assert torch.equal(a, b[sel])
    assert (plain[3][sel] >= 0).any() and (plain[3][sel] < 0).any()


def test_walk_breaks_cross_leaf_tie_like_plain():
    """A constructed equal-t tie across two leaves of colonnade-5k: row j,
    in a leaf far from row i, gets row i's coefficients and the smaller tri
    id of the two (its leaf box widened to cover row i's triangle).  Rays that hit row
    i now meet both at exactly one t; the walk must return row j's tri, as
    the plain (t, tri) minimum does, whichever leaf it reaches
    first."""
    tf = tscene.flatten_frame(sponza_like_scene(), "bf16", "cpu", width=32, height=32)
    o, d = (x.reshape(-1, 3).numpy() for x in torch_ray_grid(
        tf.cam_l2w_f32, tf.cam_fov_y_f32, 32, 32, torch.float32))
    n = o.shape[0]
    args = list(_launch_args(tf, o, d, np.full(n, -1, np.int32), np.zeros(n, np.float32),
                             np.full(n, 1e5, np.float32)))
    base = dense_trace_multi_plain(*args[:8])
    rows = torch.nonzero(args[6][None, :] == base[3][:, None])[:, 1]  # each hit's row
    i = int(torch.mode(rows).values)  # the row most rays hit
    TI = args[5].shape[0]
    j = TI - 1 if i < TI // 2 else 0
    coef, tri_ids = args[5].clone(), args[6].clone()
    lo, hi = args[8].clone(), args[9].clone()
    coef[j] = coef[i]
    tri_ids[j] = tri_ids[i]
    tri_ids[i] = tri_ids.max() + 1  # row i keeps the larger id
    li, lj = i // LEAF, j // LEAF
    lo[lj], hi[lj] = torch.minimum(lo[lj], lo[li]), torch.maximum(hi[lj], hi[li])
    args[5], args[6], args[8], args[9] = coef, tri_ids, lo, hi
    plain = dense_trace_multi_plain(*args[:8])
    tied = base[3] == tri_ids[j]
    assert int(tied.sum()) > 10 and bool((plain[3][tied] == tri_ids[j]).all())
    tree = build_tree(lo, hi, TI, LEAF)
    for a, b in zip(_walk(*args[:8], tree, False), plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["beam", "origin"])
def test_morton_key_matches_jax(mode):
    rng = np.random.default_rng(4)
    o = (rng.normal(size=(4096, 3)) * [5, 2, 7]).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[:64, 0] = 0.0  # the sun's exact zero component
    live = rng.random(4096) > 0.2
    want = np.asarray(_morton_key(jnp.asarray(o), jnp.asarray(d), live=jnp.asarray(live),
                                  mode=mode))
    got = morton_key(torch.from_numpy(o), torch.from_numpy(d), live=torch.from_numpy(live),
                     mode=mode).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        morton_key(torch.from_numpy(o), torch.from_numpy(d), mode=mode).numpy(),
        np.asarray(_morton_key(jnp.asarray(o), jnp.asarray(d), mode=mode)))


def test_tree_levels(setup):
    """The tree over the leaves that hold rows: each node the union of its
    (up to) four children, one root, the leaf boxes unchanged."""
    tf = setup["tframe"]
    TI = tf.dense_n_f32.shape[0]
    tree = build_tree(tf.dense_leaf_lo, tf.dense_leaf_hi, TI, LEAF)
    n0 = -(-TI // LEAF)
    assert tree.sizes[0] == n0 and tree.sizes[-1] == 1
    assert setup["name"] != "colonnade-46k" or n0 > L1_MIN_LEAVES
    offs = tree.levels[: len(tree.sizes)].tolist()
    assert torch.equal(tree.boxes[offs[0]:offs[0] + n0],
                       torch.cat([tf.dense_leaf_lo[:n0], tf.dense_leaf_hi[:n0]], 1))
    for lvl in range(1, len(tree.sizes)):
        kids = tree.boxes[offs[lvl - 1]:offs[lvl - 1] + tree.sizes[lvl - 1]]
        for k in range(tree.sizes[lvl]):
            ch = kids[FAN * k:FAN * k + FAN]
            assert torch.equal(tree.boxes[offs[lvl] + k],
                               torch.cat([ch[:, :3].amin(0), ch[:, 3:].amax(0)]))


def test_routes(setup):
    """Under traversal_impl='pallas' both packages gate alike: no fused
    shadow phase, the dtype epsilon on every launch, incoherent launches
    sorted above 4096 instance triangles; the wavefront is never used."""
    c = setup
    cfg = RenderConfig(width=8, height=8, precision="bf16", traversal_impl="pallas",
                       wavefront_min_tris=16)
    jcfg = JaxConfig(width=8, height=8, precision="bf16", traversal_impl="pallas",
                     wavefront_min_tris=16)
    tf, prec = c["tframe"], cfg.prec
    assert resolve_impl(tf, cfg) == "pallas"
    assert not _wavefront_route(tf, cfg, prec)
    assert not di_fusible(tf, cfg) and not jax_di_fusible(c["scene"], c["frame"], jcfg, c["prec"])
    assert incoherent_reorders(tf, cfg, prec) == jax_reorders(c["scene"], c["frame"], jcfg,
                                                              c["prec"])
    assert incoherent_reorders(tf, cfg, prec) == (c["name"] == "colonnade-46k")
    for coherent in (True, False):
        eps = moveforward_eps(tf, cfg, prec, coherent)
        assert eps == jax_moveforward_eps(c["scene"], c["frame"], jcfg, c["prec"], coherent)
        assert eps == prec.ray_moveforward_t == 0.1


def test_auto_resolution():
    """'auto' on colonnade-5k (5,314 instance triangles): the dense route
    by default, the packet BVH once packet_bvh_min_tris is below the count
    (the Renderer bakes it in), the BVH walk once packet_bvh_max_tris is
    below it too; a frame without a coefficient table takes the walk under
    'auto', and a route that reads the table is refused it."""
    tf = tscene.flatten_frame(sponza_like_scene(), "bf16", "cpu")
    base = RenderConfig(width=8, height=8, precision="bf16")
    assert resolve_impl(tf, base) == "dense_pallas"
    packet = RenderConfig(width=8, height=8, precision="bf16", packet_bvh_min_tris=5000)
    assert resolve_impl(tf, packet) == "pallas"
    r = Renderer(sponza_like_scene(), packet, device="cpu")
    assert r.cfg.traversal_impl == "pallas"
    assert moveforward_eps(r.frame, r.cfg, r.cfg.prec, True) == 0.1
    assert not _wavefront_route(r.frame, RenderConfig(
        width=8, height=8, precision="bf16", packet_bvh_min_tris=5000, wavefront_min_tris=600),
        r.cfg.prec)
    xla = RenderConfig(width=8, height=8, precision="bf16", packet_bvh_min_tris=4000,
                       packet_bvh_max_tris=5000)
    assert resolve_impl(tf, xla) == "jax"
    check_scene(tf, xla)  # the walk reads no coefficient table
    bare = dataclasses.replace(tf, dense_n=None)
    assert resolve_impl(bare, packet) == "jax"
    check_scene(bare, packet)
    with pytest.raises(ValueError, match="coefficient table"):
        check_scene(bare, RenderConfig(width=8, height=8, precision="bf16",
                                       traversal_impl="pallas"))
