"""PyTorch port, fp32: the f32 'both' acceptance of the trace kernels (K1a
with its fused shadow phase, K1b, K6) against the JAX package.

- The acceptance alone (`ops/dense_trace.py:band_accept`), in both band
  forms, bit for bit against a numpy transcription of the JAX expressions
  (`dense_pallas.py:_kernel` :393-418, `traversal_pallas.py:_kernel`
  :375-394) on constructed lanes: u, v and w exactly on the band's edge
  and at 0, u + v a few ulps around 1 (w rounds as (1 - u) - v), the band
  and the strict test disagreeing, and infinite / NaN t.
- K1a: `dense_trace_plain` with the fused shadow phase (through
  ops/trace.trace) against `trace_rays_dense_pallas(prec=FP32, fallback=
  'both', di_lights=...)` in interpret mode on Cornell's primary and a
  bounce-shaped launch.
- K1b: the four launch forms of the Sponza-class frame on
  `sponza_like_scene(3, 1)` (830 instance triangles, 7 chunks) through both
  packages' `trace` (`traversal_impl='dense_pallas'`): in fp32 the
  incoherent launches go to the sorted dense kernel in both.
- K6: the same four forms through both packages' `trace` with
  `traversal_impl='pallas'` (`trace_rays_packet(_sorted)`), on
  colonnade-5k (5,314 instance triangles: incoherent launches sorted).
- The K1b and K6 walks (emulated in PyTorch) under the f32 band equal
  their plain versions bit for bit.

Bars (the bf16 ones of tests/test_torch_dense_multi.py, with t/u/v
tightened): tri agreement > 0.999, ids equal where it agrees, t/u/v within
rtol / atol 1e-4 there (observed at most 1.6e-6 on K1a, 1.4e-5 on K1b,
3.9e-5 on K6, each a t of the bounce or primary launch: the JAX f32 dot
sums in another order than the port's f32), occlusion and visibility
agreement > 0.999, dead lanes exactly the miss record."""

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
from low_precision_raytracer_tpu.ops.dense_pallas import trace_rays_dense_pallas
from low_precision_raytracer_tpu.ops.trace import incoherent_reorders as jax_reorders
from low_precision_raytracer_tpu.ops.trace import moveforward_eps as jax_moveforward_eps
from low_precision_raytracer_tpu.ops.trace import trace as jax_trace
from low_precision_raytracer_tpu.render.renderer import _di_light_spec
from low_precision_raytracer_tpu_torch.config import FP32, RenderConfig
from low_precision_raytracer_tpu_torch.models import scene as tscene
from low_precision_raytracer_tpu_torch.ops.dense_trace import (
    CHUNK,
    band_accept,
    build_tree,
    dense_band,
    dense_trace_multi_plain,
    packet_band,
)
from low_precision_raytracer_tpu_torch.ops.packet_trace import LEAF
from low_precision_raytracer_tpu_torch.ops.trace import (
    _wavefront_route,
    acceptance_band,
    incoherent_reorders,
    moveforward_eps,
    trace,
)
from test_torch_dense_multi import _gi_rays, _shadow_rays
from test_torch_packet import _launch_args, _walk

F = np.float32
RTOL = ATOL = 1e-4
BANDS = {"dense": dense_band(FP32), "packet": packet_band(FP32)}


# ---------------------------------------------------------------------------
# the acceptance alone


def _jax_accept(form, t, Ox, Oy, Dx, Dy, s_ox, s_oy, s_dx, s_dy):
    """numpy f32 transcription of the JAX kernels' f32 'both' branch."""
    d1, d2 = FP32.delta1, FP32.delta2
    t_dx = t * Dx
    t_dy = t * Dy
    u = Ox + t_dx
    v = Oy + t_dy
    if form == "dense":  # dense_pallas.py:288-289, 396-397 (S rows pre-scaled)
        c1, c3 = F(0.2 * d1), F(0.6 * d1)
        error_u = s_ox + t * s_dx + c1 * np.abs(Ox) + c3 * np.abs(t_dx)
        error_v = s_oy + t * s_dy + c1 * np.abs(Oy) + c3 * np.abs(t_dy)
    else:  # traversal_pallas.py:120-121, 375-376
        d12, d1f = F(d1 + d2), F(d1)
        error_u = (d12 * s_ox + t * d12 * s_dx + d1f * (np.abs(Ox) + F(3) * np.abs(t_dx))) * F(0.2)
        error_v = (d12 * s_oy + t * d12 * s_dy + d1f * (np.abs(Oy) + F(3) * np.abs(t_dy))) * F(0.2)
    w = F(1.0) - u - v
    in_band = lambda x, err: (x >= -err) & (x <= 0)
    ambiguous = in_band(u, error_u) | in_band(v, error_v) | in_band(w, error_u + error_v)
    dtype_accept = (u > -error_u) & (v > -error_v) & (u + v < F(1) + error_u + error_v)
    strict = (u > 0) & (v > 0) & (u + v < 1)
    accept = (ambiguous & strict) | (~ambiguous & dtype_accept)
    return accept, dict(u=u, v=v, w=w, eu=error_u, ev=error_v, ambiguous=ambiguous,
                        strict=strict, dtype_accept=dtype_accept)


def _constructed_lanes(form, rng, n=4096):
    """(t, Ox, Oy, Dx, Dy, S...) f32 lanes: random ones near the band, and
    lanes placed exactly on its edges (by fixed-point iteration in f32)."""
    t = rng.uniform(0.1, 10, n).astype(F)
    Ox = rng.uniform(-0.01, 1.0, n).astype(F)
    Oy = rng.uniform(-0.01, 1.0, n).astype(F)
    Dx = rng.normal(0, 1e-3, n).astype(F)
    Dy = rng.normal(0, 1e-3, n).astype(F)
    S = [rng.uniform(0, 2e-3, n).astype(F) for _ in range(4)]
    q = n // 8
    # u = 0 exactly, and u + v a few ulps around 1 (t Dx = t Dy = 0)
    Dx[:4 * q] = 0
    Dy[:4 * q] = 0
    Ox[:q] = 0
    u = rng.uniform(0.05, 0.95, q).astype(F)
    Ox[q:2 * q] = u
    v = F(1) - u
    Oy[q:2 * q] = v + rng.integers(-3, 4, q).astype(F) * np.spacing(v)
    # u = -error_u exactly: iterate to the fixed point in f32 (the band's
    # own term in |u| moves it by ~1e-7)
    blk = slice(2 * q, 3 * q)
    for _ in range(6):
        _, x = _jax_accept(form, t, Ox, Oy, Dx, Dy, *S)
        Ox[blk] = -x["eu"][blk]
    # w = -(error_u + error_v) exactly: w = (1 - u) - v a little below 0,
    # then s_oy searched ulp by ulp around its linear estimate
    blk = slice(3 * q, 4 * q)
    S[2][blk] = S[3][blk] = 0
    Oy[blk] = (F(1) - Ox[blk]) + rng.uniform(2e-4, 2e-3, q).astype(F)
    S[1][blk] = 0
    _, x0 = _jax_accept(form, t, Ox, Oy, Dx, Dy, *S)
    S[1][blk] = F(1e-3)
    _, x1 = _jax_accept(form, t, Ox, Oy, Dx, Dy, *S)
    slope = (x1["ev"] - x0["ev"])[blk] / F(1e-3)
    s0 = ((-x0["w"] - x0["eu"] - x0["ev"])[blk] / slope).astype(F)
    found = np.zeros(q, bool)
    best = s0.copy()
    for k in range(-64, 65):
        S[1][blk] = s0 + F(k) * np.spacing(s0)
        _, x = _jax_accept(form, t, Ox, Oy, Dx, Dy, *S)
        hit = ~found & (x["w"] == -(x["eu"] + x["ev"]))[blk]
        best[hit] = S[1][blk][hit]
        found |= hit
    S[1][blk] = best
    # infinite / NaN t
    t[-8:] = [np.inf, -np.inf, np.nan, np.inf, np.nan, -np.inf, np.inf, np.nan]
    return t, Ox, Oy, Dx, Dy, S


@pytest.mark.parametrize("form", ["dense", "packet"])
def test_band_accept_matches_jax_expressions(form):
    rng = np.random.default_rng(21 if form == "dense" else 22)
    with np.errstate(invalid="ignore"):
        t, Ox, Oy, Dx, Dy, S = _constructed_lanes(form, rng)
        want, x = _jax_accept(form, t, Ox, Oy, Dx, Dy, *S)
    tt = [torch.from_numpy(a) for a in (t, Ox, Oy, Dx, Dy, *S)]
    t_, Ox_, Oy_, Dx_, Dy_ = tt[:5]
    t_dx, t_dy = t_ * Dx_, t_ * Dy_
    got = band_accept(BANDS[form], t_, Ox_ + t_dx, Oy_ + t_dy, Ox_, Oy_, t_dx, t_dy, *tt[5:])
    np.testing.assert_array_equal(got.numpy(), want)
    with np.errstate(invalid="ignore"):
        # the constructed cases occur: edges hit exactly, both tests decide
        assert (x["u"] == -x["eu"]).sum() > 400 and (x["u"] == 0).sum() > 400
        assert (x["w"] == -(x["eu"] + x["ev"])).sum() > 300 and (x["w"] == 0).sum() > 40
        assert (x["ambiguous"] & (x["strict"] != x["dtype_accept"])).sum() > 500
        assert (~x["ambiguous"] & x["dtype_accept"] & ~x["strict"]).sum() > 40
    assert not want[-8:].any()


# ---------------------------------------------------------------------------
# K1a on Cornell, fused shadow phase

N = 64


def _tables(host, prec_name="fp32", n=N, m=N):
    prec = jax_precision(prec_name)
    scene = build_scene_arrays(host, prec)
    frame = flatten_frame(host, prec, max_direct_lights=4, width=n, height=m)
    frame_np = {k: np.asarray(getattr(frame, k)) for k in tscene.tensor_fields(tscene.FrameInput)}
    frame_np.update(obj_layout=frame.obj_layout, n_lights=frame.n_lights,
                    dense_morton=frame.dense_morton)
    scene_np = {k: np.asarray(getattr(scene, k)) for k in tscene.tensor_fields(tscene.SceneArrays)}
    scene_np.update(n_meshes=scene.n_meshes, sky_valid=scene.sky_valid)
    _s, tframe = tscene.scene_from_numpy(scene_np, frame_np, "cpu")
    o, d = primary_ray_grid(frame.cam_l2w_f32, frame.cam_fov_y_f32, n, m, jnp.float32)
    return dict(prec=prec, scene=scene, frame=frame, tframe=tframe,
                o=np.array(o).reshape(-1, 3), d=np.array(d).reshape(-1, 3))


def _close(j, t, hit):
    """t/u/v within the bars on `hit`; -> the largest difference."""
    err = 0.0
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(t[k][hit], j[k][hit], rtol=RTOL, atol=ATOL, err_msg=k)
        if hit.any():
            err = max(err, float(np.abs(t[k][hit] - j[k][hit]).max()))
    return err


@pytest.fixture(scope="module")
def cornell():
    c = _tables(jax_cornell())
    c["spec"] = _di_light_spec(c["frame"], JaxConfig(width=N, height=N, precision="fp32"))
    return c


def _k1a_both(c, o, d, **kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    hj, vj = trace_rays_dense_pallas(
        c["scene"], c["frame"], jnp.asarray(o), jnp.asarray(d), prec=c["prec"],
        fallback="both", di_lights=c["spec"], tile_hw=(N, N), interpret=True, **jkw)
    tf = c["tframe"]
    tspec = {k: getattr(tf, k)[: tf.n_lights] for k in ("light_type", "light_pos", "light_dir")}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ht, vt = trace(tf, torch.from_numpy(o), torch.from_numpy(d),
                   cfg=RenderConfig(width=N, height=N, precision="fp32"), prec=FP32,
                   di_lights=tspec, **tkw)
    j = {k: np.asarray(getattr(hj, k)) for k in ("t", "u", "v", "tri", "obj")}
    t = {k: getattr(ht, k).numpy() for k in ("t", "u", "v", "tri", "obj")}
    j["vis"], t["vis"] = np.asarray(vj), vt.numpy()
    return j, t


def _once(c, key, fn):
    """`fn()` once per module fixture `c`: a JAX interpret-mode reference
    the cases share."""
    if key not in c:
        c[key] = fn()
    return c[key]


def _k1a_primary(c):
    return _once(c, "primary", lambda: _k1a_both(c, c["o"], c["d"]))


def _check_k1a(j, t):
    same = j["tri"] == t["tri"]
    assert same.mean() > 0.999, f"tri agreement {same.mean()}"
    np.testing.assert_array_equal(j["obj"][same], t["obj"][same])
    _close(j, t, same & (j["tri"] >= 0))
    assert (j["vis"] == t["vis"]).mean() > 0.999


def test_k1a_primary(cornell):
    c = cornell
    tf = c["tframe"]
    assert acceptance_band(tf, RenderConfig(precision="fp32"), FP32) == dense_band(FP32)
    j, t = _k1a_primary(c)
    _check_k1a(j, t)
    assert (t["tri"] >= 0).mean() > 0.99 and t["vis"].any() and not t["vis"].all()


def test_k1a_bounce(cornell):
    """Bounce-shaped launch from the primary hits (the hit triangle
    skipped, min_dist the fp32 epsilon 1e-4, a quarter of the lanes dead)
    with the fused shadow phase from the bounce hits."""
    c = cornell
    j0, _ = _k1a_primary(c)
    rng = np.random.default_rng(7)
    R = c["o"].shape[0]
    o = (c["o"] + j0["t"][:, None] * c["d"]).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(np.sum(d * c["d"], axis=1, keepdims=True) > 0, -d, d).astype(np.float32)
    dead = rng.random(R) < 0.25
    maxd = np.where(dead, 0.0, 1e5).astype(np.float32)
    mind = np.full(R, FP32.ray_moveforward_t, np.float32)
    j, t = _k1a_both(c, o, d, skip_tri=j0["tri"].astype(np.int32), min_dist=mind,
                     max_dist=maxd)
    _check_k1a(j, t)
    for r in (j, t):
        np.testing.assert_array_equal(r["t"][dead], 1e5)
        for k in ("u", "v", "vis"):
            np.testing.assert_array_equal(r[k][dead], 0)
        for k in ("tri", "obj"):
            np.testing.assert_array_equal(r[k][dead], -1)
    assert (t["tri"][~dead] >= 0).mean() > 0.5


# ---------------------------------------------------------------------------
# K1b (dense route) and K6 (packet route): the four launch forms

H, W = 16, 128
ROUTES = {  # route -> (scene args, traversal_impl)
    "k1b": ((3, 1), "dense_pallas"),
    "k6": ((4, 2), "pallas"),
}


@pytest.fixture(scope="module", params=list(ROUTES))
def route(request):
    args, impl = ROUTES[request.param]
    c = _tables(jax_sponza(*args, with_skybox=False), n=W, m=H)
    c.update(name=request.param, R=H * W,
             jcfg=JaxConfig(width=W, height=H, precision="fp32", traversal_impl=impl),
             cfg=RenderConfig(width=W, height=H, precision="fp32", traversal_impl=impl))
    c["primary"] = _route_both(c, c["o"], c["d"])
    return c


def _route_both(c, o, d, **kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    hj = jax_trace(c["scene"], c["frame"], jnp.asarray(o), jnp.asarray(d), prec=c["prec"],
                   cfg=c["jcfg"], **jkw)
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ht = trace(c["tframe"], torch.from_numpy(o), torch.from_numpy(d), cfg=c["cfg"], prec=FP32,
               **tkw)
    names = ("t", "u", "v", "tri", "obj")
    return ({k: np.asarray(getattr(hj, k)) for k in names},
            {k: getattr(ht, k).numpy() for k in names})


def _check_closest(j, t, dead):
    same = j["tri"] == t["tri"]
    assert same.mean() > 0.999, f"tri agreement {same.mean()}"
    np.testing.assert_array_equal(j["obj"][same], t["obj"][same])
    _close(j, t, same & (t["tri"] >= 0))
    for r in (j, t):
        np.testing.assert_array_equal(r["tri"][dead], -1)
    np.testing.assert_array_equal(t["t"][dead], 1e5)


def _check_any(j, t, dead):
    occ_j, occ_t = j["tri"] >= 0, t["tri"] >= 0
    assert (occ_j == occ_t).mean() > 0.999, f"occlusion agreement {(occ_j == occ_t).mean()}"
    for r in (j, t):
        np.testing.assert_array_equal(r["tri"][dead], -1)
    np.testing.assert_array_equal(t["obj"], -1)


def test_routes(route):
    """In fp32 both packages gate alike: no wavefront (incoherent launches
    reorder through the sorted kernel), the fp32 epsilon on every launch,
    the route's own band."""
    c = route
    tf, cfg = c["tframe"], c["cfg"]
    assert not _wavefront_route(tf, cfg, FP32)
    assert incoherent_reorders(tf, cfg, FP32)
    assert jax_reorders(c["scene"], c["frame"], c["jcfg"], c["prec"])
    for coherent in (True, False):
        eps = moveforward_eps(tf, cfg, FP32, coherent)
        assert eps == jax_moveforward_eps(c["scene"], c["frame"], c["jcfg"], c["prec"], coherent)
        assert eps == FP32.ray_moveforward_t == 1e-4
    want = packet_band(FP32) if c["name"] == "k6" else dense_band(FP32)
    assert acceptance_band(tf, cfg, FP32) == want


def test_primary(route):
    j, t = route["primary"]
    _check_closest(j, t, np.zeros(route["R"], bool))
    assert 0.1 < (t["tri"] >= 0).mean() < 0.95


def _bounce_sorted(c):
    """The GI-shaped launch (seed 5) through both packages, once per route:
    -> (rays (p, d, skip, maxd), (jax, port))."""
    def run():
        p, d, skip, maxd = _gi_rays(c, np.random.default_rng(5))
        return (p, d, skip, maxd), _route_both(c, p, d, skip_tri=skip, min_dist=1e-4,
                                               max_dist=maxd, coherent=False)
    return _once(c, "bounce", run)


def test_bounce_sorted(route):
    c = route
    (p, d, skip, maxd), (j, t) = _bounce_sorted(c)
    _check_closest(j, t, maxd == 0)
    assert (t["tri"][maxd > 0] >= 0).mean() > 0.2


@pytest.mark.parametrize("coherent", [True, False], ids=["round0", "round1_sorted"])
def test_shadows_any_hit(route, coherent):
    c = route
    rng = np.random.default_rng(11 if coherent else 12)
    j0, _ = c["primary"]
    if coherent:
        p = (c["o"] + j0["t"][:, None] * c["d"]).astype(np.float32)
        valid, skip = j0["tri"] >= 0, j0["tri"]
    else:
        (p, d, _skip, _maxd), (jg, _) = _bounce_sorted(c)
        p = (p + np.where(jg["tri"] >= 0, jg["t"], 0)[:, None] * d).astype(np.float32)
        valid, skip = jg["tri"] >= 0, jg["tri"]
    o, d, maxd, dead = _shadow_rays(c, p, valid, rng)
    skips = np.repeat(np.where(valid, skip, -1), 2).astype(np.int32)
    j, t = _route_both(c, o, d, find_any=True, skip_tri=skips, min_dist=1e-4, max_dist=maxd,
                       coherent=coherent, lane_k=2)
    _check_any(j, t, dead)
    assert 0.02 < (t["tri"][~dead] >= 0).mean() < 0.98


@pytest.mark.parametrize("find_any", [False, True], ids=["closest", "any"])
def test_walk_equals_plain(route, find_any):
    """The kernel's tree walk (emulated), over K1b's 128-row chunks or K6's
    32-row leaves, with the route's f32 band, equals the plain version bit
    for bit on a bounce-shaped (closest) or shadow-shaped (any) launch."""
    c = route
    tf = c["tframe"]
    p, d, skip, maxd = _gi_rays(c, np.random.default_rng(9))
    if find_any:
        p, d, maxd, _dead = _shadow_rays(c, p, maxd > 0, np.random.default_rng(3))
        skip = np.repeat(skip, 2)
    args = list(_launch_args(tf, p, d, skip, np.full(p.shape[0], 1e-4, np.float32), maxd))
    TI = args[5].shape[0]
    if c["name"] == "k1b":
        cc = tf.dense_center
        lo, hi = (tf.dense_chunk_lo - cc).contiguous(), (tf.dense_chunk_hi - cc).contiguous()
        tree, band = build_tree(lo, hi, TI, CHUNK), dense_band(FP32)
    else:
        tree, band = build_tree(args[8], args[9], TI, LEAF), packet_band(FP32)
    plain = dense_trace_multi_plain(*args[:8], find_any=find_any, band=band)
    sel = torch.arange(0, p.shape[0], 4)
    sub = [a[sel] for a in args[:5]] + args[5:8]
    for a, b in zip(_walk(*sub, tree, find_any, band), plain):
        assert torch.equal(a, b[sel])
    assert (plain[3][sel] >= 0).any() and (plain[3][sel] < 0).any()
