"""PyTorch port, K1b: the multi-chunk dense trace (`dense_trace_multi`'s
plain version, through ops/trace.trace) against the TPU kernel's
multi-chunk mode, `trace_rays_dense_pallas` / `_sorted(...,
interpret=True)` through the JAX package's own `trace`, on the same bf16
tables of `sponza_like_scene(3, 1)` without sky: 830 instance triangles
in 7 chunks and 19 objects, so incoherent launches take the anchor-sorted
path (colonnade-83k's route, the wavefront, is checked here too; its
launches are tests/test_torch_wavefront.py's).  The four launch forms of the Sponza-class frame run at a 16 x 128
grid: primary closest hit (coherent), round-0 shadows (any hit, lane_k=2,
coherent), the GI bounce (closest, sorted) and round-1 shadows (any hit,
lane_k=2, sorted).

Bars: the TPU kernel computes u/v/t through a bf16x3 product (~2^-16
relative) and breaks exact cross-chunk ties by walk order, the port uses
plain f32 and a (t, tri, row) order, so closest hits agree on > 99.9% of
lanes with t/u/v within rtol/atol 2e-3 and equal ids where they agree
(tests/test_dense_pallas.py:145-150); any-hit occlusion agrees on > 99.9%
of lanes and dead lanes (maxd = 0) are exactly -1 on both sides.

Within the port: the sorted launch equals the unsorted one bit for bit;
K1b's plain version equals K1a's on Cornell; and the kernel's walk (a
4-ary tree over the chunk boxes, nearest entry first, closest hit skipping
boxes past its best t, any hit stopping at its first blocker; emulated by
tests/test_torch_packet.py:_walk) equals the plain version's global
minimum bit for bit: its boxes never cut a hit."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
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
from low_precision_raytracer_tpu.ops.trace import incoherent_reorders as jax_reorders
from low_precision_raytracer_tpu.ops.trace import moveforward_eps as jax_moveforward_eps
from low_precision_raytracer_tpu.ops.trace import trace as jax_trace
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models import scene as tscene
from low_precision_raytracer_tpu_torch.ops.dense_trace import (
    CHUNK,
    dense_trace_multi,
    dense_trace_multi_plain,
    dense_trace_multi_sorted,
    build_tree,
    dense_trace_plain,
)
from low_precision_raytracer_tpu_torch.ops.trace import (
    _wavefront_route,
    incoherent_reorders,
    moveforward_eps,
    trace,
)
from test_torch_packet import _walk as tree_walk

H, W = 16, 128
R = H * W


def _tables(host, n=W, m=H):
    prec = jax_precision("bf16")
    scene = build_scene_arrays(host, prec)
    frame = flatten_frame(host, prec, max_direct_lights=4, width=n, height=m)
    frame_np = {k: np.asarray(getattr(frame, k)) for k in tscene.tensor_fields(tscene.FrameInput)}
    frame_np.update(obj_layout=frame.obj_layout, n_lights=frame.n_lights,
                    dense_morton=frame.dense_morton)
    scene_np = {k: np.asarray(getattr(scene, k)) for k in tscene.tensor_fields(tscene.SceneArrays)}
    scene_np.update(n_meshes=scene.n_meshes, sky_valid=scene.sky_valid)
    tscn, tframe = tscene.scene_from_numpy(scene_np, frame_np, "cpu")
    return prec, scene, frame, tframe


@pytest.fixture(scope="module")
def sponza():
    prec, scene, frame, tframe = _tables(jax_sponza(3, 1, with_skybox=False))
    jcfg = JaxConfig(width=W, height=H, precision="bf16", traversal_impl="dense_pallas")
    cfg = RenderConfig(width=W, height=H, precision="bf16")
    o, d = primary_ray_grid(frame.cam_l2w_f32, frame.cam_fov_y_f32, W, H, jnp.float32)
    c = dict(prec=prec, scene=scene, frame=frame, tframe=tframe, jcfg=jcfg, cfg=cfg,
             o=np.array(o).reshape(-1, 3), d=np.array(d).reshape(-1, 3))
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


def _check_closest(j, t):
    same = j["tri"] == t["tri"]
    assert same.mean() > 0.999, f"tri agreement {same.mean()}"
    np.testing.assert_array_equal(j["obj"][same], t["obj"][same])
    hit = same & (j["tri"] >= 0)
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(t[k][hit], j[k][hit], rtol=2e-3, atol=2e-3, err_msg=k)


def _check_any(j, t, dead):
    occ_j, occ_t = j["tri"] >= 0, t["tri"] >= 0
    assert (occ_j == occ_t).mean() > 0.999, f"occlusion agreement {(occ_j == occ_t).mean()}"
    for r in (j, t):
        np.testing.assert_array_equal(r["tri"][dead], -1)
    np.testing.assert_array_equal(t["obj"], -1)


def _shadow_rays(c, p, valid, rng):
    """Pixel-major (R*2) shadow commands from points p toward the scene's
    two lights (sun, fill), each direction tilted at random by ~1e-3 rad;
    invalid pixels and a random 20% of the slots are dead (maxd = 0).

    The tilt keeps the comparison off a degenerate case: the sun's
    direction has an x component of exactly 0, so its rays from a
    pillar's x faces run inside the face plane and meet the next face
    exactly on its edge (u or v = 0), which the TPU's bf16x3 product and
    the port's f32 resolve either way (0.2% of these lanes untilted; see
    ROADMAP queue 3)."""
    f = c["frame"]
    n = p.shape[0]
    lt = np.asarray(f.light_type)[:2]
    lpos = np.asarray(f.light_pos.astype(jnp.float32))[:2]
    ldir = np.asarray(f.light_dir.astype(jnp.float32))[:2]
    dirs, maxd = [], []
    for i in range(2):
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
    d = np.stack(dirs, axis=1).astype(np.float32)  # (n, 2, 3)
    live = valid[:, None] & (rng.random((n, 2)) > 0.2)
    maxd = np.where(live, np.stack(maxd, axis=1), 0.0).astype(np.float32)
    o = np.broadcast_to(p[:, None, :], (n, 2, 3)).reshape(-1, 3).astype(np.float32)
    return o, d.reshape(-1, 3), maxd.reshape(-1), ~live.reshape(-1)


def _gi_rays(c, rng):
    j0, _ = c["primary"]
    valid = j0["tri"] >= 0
    p = (c["o"] + j0["t"][:, None] * c["d"]).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(np.sum(d * c["d"], axis=1, keepdims=True) > 0, -d, d).astype(np.float32)
    maxd = np.where(valid & (rng.random(R) > 0.1), 1e5, 0.0).astype(np.float32)
    skip = np.where(valid, j0["tri"], -1).astype(np.int32)
    return p, d, skip, maxd


def _check_routes(prec, scene, frame, tframe, jcfg, cfg, ti, nc, wavefront):
    assert frame.dense_n.shape[0] == ti and frame.dense_chunk_lo.shape[0] == nc
    assert jax_reorders(scene, frame, jcfg, prec)
    assert incoherent_reorders(tframe, cfg, cfg.prec)
    assert _wavefront_route(tframe, cfg, cfg.prec) == wavefront
    for coherent in (True, False):
        eps = moveforward_eps(tframe, cfg, cfg.prec, coherent)
        assert eps == jax_moveforward_eps(scene, frame, jcfg, prec, coherent)
        want = prec.ray_moveforward_t if (wavefront and not coherent) \
            else prec.ray_moveforward_t_exact
        assert eps == want


def test_routes_match_jax(sponza):
    """The Sponza-class launch forms: multi-chunk, and incoherent launches
    reorder (the sorted path) in both packages."""
    c = sponza
    _check_routes(c["prec"], c["scene"], c["frame"], c["tframe"], c["jcfg"], c["cfg"],
                  830, 7, wavefront=False)


def test_routes_match_jax_colonnade_83k():
    """colonnade-83k: above wavefront_min_tris, incoherent launches go to
    the per-ray wavefront (with the dtype epsilon) in both packages;
    coherent ones keep K1b and the exact epsilon."""
    prec, scene, frame, tframe = _tables(jax_sponza(8, 3, with_skybox=False))
    jcfg = JaxConfig(width=W, height=H, precision="bf16", traversal_impl="dense_pallas")
    cfg = RenderConfig(width=W, height=H, precision="bf16")
    _check_routes(prec, scene, frame, tframe, jcfg, cfg, 82690, 647, wavefront=True)


def test_primary_closest(sponza):
    j, t = sponza["primary"]
    _check_closest(j, t)
    assert 0.1 < (t["tri"] >= 0).mean() < 0.9  # floor, pillars, balls and sky


@pytest.mark.parametrize("coherent", [True, False], ids=["round0", "round1_sorted"])
def test_shadows_any_hit(sponza, coherent):
    """Shadow commands, lane_k=2, from the primary hits (round 0,
    coherent) or from the GI bounce hits (round 1, sorted)."""
    c = sponza
    rng = np.random.default_rng(11 if coherent else 12)
    j0, _ = c["primary"]
    if coherent:
        p = (c["o"] + j0["t"][:, None] * c["d"]).astype(np.float32)
        valid, skip = j0["tri"] >= 0, j0["tri"]
    else:
        p, d, skip_gi, maxd = _gi_rays(c, np.random.default_rng(5))
        jg, _ = _both(c, p, d, skip_tri=skip_gi, min_dist=1e-2, max_dist=maxd, coherent=False)
        p = (p + np.where(jg["tri"] >= 0, jg["t"], 0)[:, None] * d).astype(np.float32)
        valid, skip = jg["tri"] >= 0, jg["tri"]
    o, d, maxd, dead = _shadow_rays(c, p, valid, rng)
    skips = np.repeat(np.where(valid, skip, -1), 2).astype(np.int32)
    j, t = _both(c, o, d, find_any=True, skip_tri=skips, min_dist=1e-2, max_dist=maxd,
                 coherent=coherent, lane_k=2)
    _check_any(j, t, dead)
    live = ~dead
    assert 0.02 < (t["tri"][live] >= 0).mean() < 0.98  # both outcomes occur


def test_gi_closest_sorted(sponza):
    """Bounce-shaped incoherent launch: origins on the primary hits, random
    directions away from the camera, the hit triangle skipped, dead
    lanes."""
    c = sponza
    p, d, skip, maxd = _gi_rays(c, np.random.default_rng(5))
    j, t = _both(c, p, d, skip_tri=skip, min_dist=1e-2, max_dist=maxd, coherent=False)
    _check_closest(j, t)
    dead = maxd == 0
    for r in (j, t):
        np.testing.assert_array_equal(r["tri"][dead], -1)
        np.testing.assert_array_equal(r["t"][dead], 1e5)
    assert (t["tri"][~dead] >= 0).mean() > 0.2


def _launch_args(tf, o, d, skip, mind, maxd):
    TI = tf.dense_n_f32.shape[0]
    c = tf.dense_center
    coef = torch.cat([tf.dense_n_f32.reshape(TI, 9), tf.dense_e], dim=1).contiguous()
    return ((torch.from_numpy(o) - c).contiguous(), torch.from_numpy(d).contiguous(),
            torch.from_numpy(skip), torch.from_numpy(mind), torch.from_numpy(maxd), coef,
            tf.dense_tri, tf.dense_obj, (tf.dense_chunk_lo - c).contiguous(),
            (tf.dense_chunk_hi - c).contiguous())


@pytest.mark.parametrize("find_any", [False, True], ids=["closest", "any"])
def test_walk_and_sort_equal_plain(sponza, find_any):
    """Bit for bit on the GI-shaped launch: the kernel's walk (emulated)
    and the sorted launch both equal the plain global minimum."""
    c = sponza
    p, d, skip, maxd = _gi_rays(c, np.random.default_rng(9))
    if find_any:  # shadow-shaped: toward the fill light, its range capped
        o, d, maxd, _dead = _shadow_rays(c, p, maxd > 0, np.random.default_rng(3))
        p, skip = o, np.repeat(skip, 2)
    args = _launch_args(c["tframe"], p, d, skip, np.full(p.shape[0], 1e-2, np.float32), maxd)
    plain = dense_trace_multi_plain(*args, find_any=find_any)
    tree = build_tree(args[8], args[9], args[5].shape[0], CHUNK)
    for got in (tree_walk(*args[:8], tree, find_any), dense_trace_multi(*args, find_any=find_any),
                dense_trace_multi_sorted(*args, find_any=find_any)):
        for a, b in zip(got, plain):
            assert torch.equal(a, b)
    assert (plain[3] >= 0).any() and (plain[3] < 0).any()


@pytest.mark.parametrize("key_mode", ["anchor", "beam", "origin"])
def test_sorted_launch_keys_equal_unsorted(sponza, key_mode):
    """The sorted K1b launch under each `incoherent_sort` key equals the
    unsorted launch bit for bit (closest and any hit)."""
    c = sponza
    p, d, skip, maxd = _gi_rays(c, np.random.default_rng(6))
    args = _launch_args(c["tframe"], p, d, skip, np.full(p.shape[0], 1e-2, np.float32), maxd)
    for find_any in (False, True):
        want = dense_trace_multi(*args, find_any=find_any)
        got = dense_trace_multi_sorted(*args, find_any=find_any, key_mode=key_mode)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_multi_equals_single_on_cornell():
    """On a one-chunk table K1b's plain version is K1a's (no lights), and
    its any-hit marker is K1a's hit / miss."""
    _p, _s, frame, tf = _tables(jax_cornell(), 48, 48)
    o, d = primary_ray_grid(frame.cam_l2w_f32, frame.cam_fov_y_f32, 48, 48, jnp.float32)
    o, d = np.array(o).reshape(-1, 3), np.array(d).reshape(-1, 3)
    n = o.shape[0]
    args = _launch_args(tf, o, d, np.full(n, -1, np.int32), np.zeros(n, np.float32),
                        np.full(n, 1e5, np.float32))
    multi = dense_trace_multi_plain(*args)
    single = dense_trace_plain(*args[:8])[:5]
    for a, b in zip(multi, single):
        assert torch.equal(a, b)
    assert (multi[3] >= 0).all()
    occ = dense_trace_multi_plain(*args, find_any=True)[3]
    assert torch.equal(occ, torch.where(single[3] >= 0, 0, -1).to(torch.int32))
