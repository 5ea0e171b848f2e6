"""PyTorch port, the sub-f32 error-band acceptances (`triangle_fallback=
'both' | 'dtype'` in bf16 and fp16, and 'dtype' in fp32) of the trace
kernels K1a (with its fused shadow phase), K1b and K6, against the JAX
package.

- The acceptance alone (`ops/dense_trace.py:band_accept`), in both band
  forms, both fallbacks, bf16 and fp16 constants, bit for bit against a
  numpy transcription of the JAX lines (`dense_pallas.py:_kernel`
  :369-421, `traversal_pallas.py:_kernel` :365-397) on constructed lanes:
  u exactly on the band's edge and at 0, u + v a few ulps around 1, the
  f32 re-test's u32 exactly 0 and u32 + v32 around 1 on ambiguous lanes,
  infinite / NaN t.
- The band rows (`band_rows`, through `coef_table`) bit for bit against
  the JAX tables: the dense form's against `_mxu_tables` (dtype rows
  rounded to bf16 in bf16 and in fp16, S rows scaled by sband), the packet
  form's against `build_stream_table` rounded as its kernel rounds them.
- K1a with the fused shadow phase on Cornell (64 x 64 primary, and a
  bounce-shaped launch with a quarter of the lanes dead) against
  `trace_rays_dense_pallas(fallback=...)` in interpret mode, under each of
  the four sub-f32 acceptances.
- K1b's four launch forms on `sponza_like_scene(3, 1)` (16 x 64 primary
  rays) through both packages' `trace`, under each acceptance (with a band
  the wavefront gate is closed and every secondary launch takes the dtype
  epsilon, as in the JAX package); K6's, on colonnade-5k, are in
  tests/test_torch_band_packet.py.
- The reference's two fp16 dtype tests (dense: rows rounded to bf16; K6:
  fp16), measured against the f32 strict test (ROADMAP queue 3).
- Under these widened acceptances K1b and K6 test every row (their walk
  would miss hits outside the tree's boxes); that loop, emulated in
  PyTorch, equals the plain version bit for bit (on colonnade-830's table:
  the dense form in bf16 'both', the packet form in fp16 and fp32
  'dtype').

Bars (those of tests/test_torch_dense_multi.py): tri agreement > 0.999
(an exact tie in the port's t between coplanar faces that a band lets both
accept counts as agreeing; plain agreement > 0.99), ids equal where it
agrees, t/u/v within rtol / atol 2e-3 there, occlusion and visibility
agreement > 0.999, dead lanes exactly the miss record.  The
JAX side sums its bf16 dots in its own order and takes t from its bf16x3
product (~2^-16), the port sums in the kernel's order from the f32 table."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import RenderConfig as JaxConfig
from low_precision_raytracer_tpu.models.procedural import cornell_box_scene as jax_cornell
from low_precision_raytracer_tpu.models.procedural import sponza_like_scene as jax_sponza
from low_precision_raytracer_tpu.ops.dense_pallas import _mxu_tables, trace_rays_dense_pallas
from low_precision_raytracer_tpu.ops.trace import incoherent_reorders as jax_reorders
from low_precision_raytracer_tpu.ops.trace import moveforward_eps as jax_moveforward_eps
from low_precision_raytracer_tpu.ops.trace import trace as jax_trace
from low_precision_raytracer_tpu.ops.traversal_pallas import build_stream_table
from low_precision_raytracer_tpu.render.renderer import _di_light_spec
from low_precision_raytracer_tpu_torch.config import RenderConfig, get_precision
from low_precision_raytracer_tpu_torch.ops.dense_trace import (
    CHUNK,
    band_accept,
    build_tree,
    coef_table,
    dense_band,
    dense_trace_multi_plain,
    packet_band,
    tri_quantities,
)
from low_precision_raytracer_tpu_torch.ops.packet_trace import LEAF
from low_precision_raytracer_tpu_torch.ops.trace import (
    _wavefront_route,
    acceptance_band,
    fused_moveforward,
    incoherent_reorders,
    moveforward_eps,
    trace,
)
from test_torch_dense_multi import _shadow_rays
from test_torch_fp32 import _tables
from test_torch_packet import _launch_args, _walk

F = np.float32
RTOL = ATOL = 2e-3
ACCS = [("bf16", "both"), ("bf16", "dtype"), ("fp16", "both"), ("fp16", "dtype")]
ACC_IDS = [f"{p}-{fb}" for p, fb in ACCS]
BAND_FNS = {"dense": dense_band, "packet": packet_band}


# ---------------------------------------------------------------------------
# the acceptance alone


def _jax_accept(kind, prec, fallback, t, Ox, Oy, Dx, Dy, s_ox, s_oy, s_dx, s_dy,
                Ox32, Oy32, Dx32, Dy32):
    """numpy f32 transcription of the JAX kernels' sub-f32 branches."""
    d1, d2 = prec.delta1, prec.delta2
    t_dx = t * Dx
    t_dy = t * Dy
    u = Ox + t_dx
    v = Oy + t_dy
    if kind == "dense":  # dense_pallas.py:288-289, 396-397 (S rows pre-scaled)
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
    u32 = Ox32 + t * Dx32  # dense_pallas.py:407-414, traversal_pallas.py:382-389
    v32 = Oy32 + t * Dy32
    ok32 = (u32 > 0) & (v32 > 0) & (u32 + v32 < 1)
    if fallback == "both":
        accept = (ambiguous & ok32) | (~ambiguous & dtype_accept)
    else:
        accept = dtype_accept
    return accept, dict(u=u, v=v, eu=error_u, ev=error_v, ambiguous=ambiguous, ok32=ok32,
                        u32=u32, v32=v32, dtype_accept=dtype_accept)


def _constructed_lanes(kind, prec, rng, n=4096):
    """f32 lanes near the band, some placed exactly on its edges (u =
    -error_u by fixed-point iteration, u = 0, u + v a few ulps around 1),
    the f32 re-test's u32 = 0 and u32 + v32 around 1 on lanes inside it."""
    t = rng.uniform(0.1, 10, n).astype(F)
    Ox = rng.uniform(-0.05, 1.0, n).astype(F)
    Oy = rng.uniform(-0.05, 1.0, n).astype(F)
    Dx = rng.normal(0, 1e-3, n).astype(F)
    Dy = rng.normal(0, 1e-3, n).astype(F)
    S = [rng.uniform(0, 2e-3, n).astype(F) for _ in range(4)]
    # the f32 rows: a small perturbation of the dtype rows
    Ox32 = (Ox + rng.normal(0, 2e-3, n)).astype(F)
    Oy32 = (Oy + rng.normal(0, 2e-3, n)).astype(F)
    Dx32 = (Dx + rng.normal(0, 1e-5, n)).astype(F)
    Dy32 = (Dy + rng.normal(0, 1e-5, n)).astype(F)
    q = n // 8
    Dx[:3 * q] = Dy[:3 * q] = 0
    Ox[:q] = 0
    u = rng.uniform(0.05, 0.95, q).astype(F)
    Ox[q:2 * q] = u
    Oy[q:2 * q] = (F(1) - u) + rng.integers(-3, 4, q).astype(F) * np.spacing(F(1) - u)
    args = lambda: (t, Ox, Oy, Dx, Dy, *S, Ox32, Oy32, Dx32, Dy32)
    blk = slice(2 * q, 3 * q)
    for _ in range(6):
        _, x = _jax_accept(kind, prec, "both", *args())
        Ox[blk] = -x["eu"][blk]
    # inside the band: u32 exactly 0, or u32 + v32 a few ulps around 1
    amb = slice(0, 3 * q)
    Dx32[amb] = Dy32[amb] = 0
    h = 3 * q // 2
    Ox32[:h:2] = 0
    u32 = rng.uniform(0.05, 0.95, 3 * q).astype(F)
    Ox32[1:3 * q:2] = u32[1::2]
    Oy32[1:3 * q:2] = (F(1) - u32[1::2]) + rng.integers(-3, 4, u32[1::2].size).astype(F) \
        * np.spacing(F(1) - u32[1::2])
    t[-8:] = [np.inf, -np.inf, np.nan, np.inf, np.nan, -np.inf, np.inf, np.nan]
    return args()


@pytest.mark.parametrize("acc", ACCS, ids=ACC_IDS)
@pytest.mark.parametrize("kind", ["dense", "packet"])
def test_band_accept_matches_jax_expressions(kind, acc):
    name, fallback = acc
    prec = get_precision(name)
    band = BAND_FNS[kind](prec, fallback)
    rng = np.random.default_rng(40 + 4 * list(BAND_FNS).index(kind) + ACCS.index(acc))
    with np.errstate(invalid="ignore"):
        lanes = _constructed_lanes(kind, prec, rng)
        want, x = _jax_accept(kind, prec, fallback, *lanes)
    tt = [torch.from_numpy(a) for a in lanes]
    t_, Ox_, Oy_, Dx_, Dy_ = tt[:5]
    t_dx, t_dy = t_ * Dx_, t_ * Dy_
    uv32 = (tt[9] + t_ * tt[11], tt[10] + t_ * tt[12])
    got = band_accept(band, t_, Ox_ + t_dx, Oy_ + t_dy, Ox_, Oy_, t_dx, t_dy, *tt[5:9],
                      uv32=uv32)
    np.testing.assert_array_equal(got.numpy(), want)
    with np.errstate(invalid="ignore"):
        # the constructed cases occur, and both tests decide some lanes
        amb = x["ambiguous"]
        assert (x["u"] == -x["eu"]).sum() > 400 and (x["u"] == 0).sum() > 400
        assert (amb & (x["u32"] == 0)).sum() > 200
        assert (amb & (np.abs(x["u32"] + x["v32"] - 1) < 4e-7)).sum() > 100
        assert (amb & (x["ok32"] != x["dtype_accept"])).sum() > 100
        strict = (x["u"] > 0) & (x["v"] > 0) & (x["u"] + x["v"] < 1)
        assert (~amb & x["dtype_accept"] & ~strict).sum() > 20
    assert not want[-8:].any()


# ---------------------------------------------------------------------------
# the band rows against the JAX tables


@pytest.mark.parametrize("name", ["bf16", "fp16"])
def test_band_rows_match_jax_tables(name):
    """On colonnade-830 (830 rows, 7 chunks): the dense form's 16 band rows
    against `_mxu_tables`' Aab slab, the packet form's against the dtype
    columns of `build_stream_table` rounded as K6 rounds them."""
    c = _tables(jax_sponza(3, 1, with_skybox=False), name, n=8, m=8)
    prec, frame, tf = c["prec"], c["frame"], c["tframe"]
    tp = get_precision(name)
    TI = frame.dense_n.shape[0]
    tc = CHUNK
    pad = (-TI) % tc
    n_dt = jnp.pad(frame.dense_n.reshape(TI, 9).astype(prec.dtype), ((0, pad), (0, 0)))
    n_f32 = jnp.pad(frame.dense_n_f32.reshape(TI, 9), ((0, pad), (0, 0)))
    e = jnp.pad(frame.dense_e, ((0, pad), (0, 0)), constant_values=1.0)
    ids = jnp.pad(frame.dense_tri, (0, pad))[:, None]
    _a32, aabt, _n32 = _mxu_tables(n_dt, n_f32, e, ids, ids, tc, prec.dtype, False, False,
                                   d1=prec.delta1, d2=prec.delta2)
    assert aabt.dtype == jnp.bfloat16  # fp16 too: the dense test's rows are bf16
    ab = np.asarray(aabt.astype(jnp.float32)).reshape(-1, 16, aabt.shape[1])
    # block b of chunk k, row i: ab[k, :, b * tc + i]; blocks Ox Oy Dx Dy Sox Soy Sdx Sdy
    blk = lambda b: ab[:, :, b * tc:(b + 1) * tc].transpose(0, 2, 1).reshape(-1, 16)[:TI]
    want = np.concatenate([blk(0)[:, 0:4], blk(1)[:, 0:4], blk(4)[:, 8:12],
                           blk(5)[:, 8:12]], axis=1)
    got = coef_table(tf, dense_band(tp, "both"))
    assert got.shape == (TI, 28)
    np.testing.assert_array_equal(got[:, :12].numpy(), coef_table(tf).numpy())
    np.testing.assert_array_equal(got[:, 12:].numpy(), want)
    np.testing.assert_array_equal(blk(2)[:, 4:7], want[:, 0:3])  # Dx reads the Ox row

    tbl = np.asarray(build_stream_table(frame, prec.dtype))[:TI]
    rnd = lambda x: np.asarray(jnp.asarray(x).astype(prec.dtype).astype(jnp.float32))
    o_rows = np.concatenate([tbl[:, 0:3], tbl[:, 18:19], tbl[:, 3:6], tbl[:, 19:20]], axis=1)
    want = np.concatenate([rnd(o_rows), rnd(np.abs(o_rows))], axis=1)
    got = coef_table(tf, packet_band(tp, "dtype"))
    np.testing.assert_array_equal(got[:, 12:].numpy(), want)


# ---------------------------------------------------------------------------
# K1a on Cornell, fused shadow phase

N = 64


@pytest.fixture(scope="module", params=ACCS, ids=ACC_IDS)
def cornell(request):
    name, fallback = request.param
    c = _tables(jax_cornell(), name)
    c.update(fallback=fallback, tprec=get_precision(name),
             cfg=RenderConfig(width=N, height=N, precision=name, triangle_fallback=fallback))
    c["spec"] = _di_light_spec(c["frame"], JaxConfig(width=N, height=N, precision=name))
    return c


def _k1a_both(c, o, d, **kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    hj, vj = trace_rays_dense_pallas(
        c["scene"], c["frame"], jnp.asarray(o), jnp.asarray(d), prec=c["prec"],
        fallback=c["fallback"], di_lights=c["spec"], tile_hw=(N, N), interpret=True, **jkw)
    tf = c["tframe"]
    tspec = {k: getattr(tf, k)[: tf.n_lights] for k in ("light_type", "light_pos", "light_dir")}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ht, vt = trace(tf, torch.from_numpy(o), torch.from_numpy(d), cfg=c["cfg"], prec=c["tprec"],
                   di_lights=tspec, **tkw)
    j = {k: np.asarray(getattr(hj, k)) for k in ("t", "u", "v", "tri", "obj")}
    t = {k: getattr(ht, k).numpy() for k in ("t", "u", "v", "tri", "obj")}
    j["vis"], t["vis"] = np.asarray(vj), vt.numpy()
    return j, t


def _close(j, t, hit):
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(t[k][hit], j[k][hit], rtol=RTOL, atol=ATOL, err_msg=k)


def _tri_agreement(c, o, d, j, t, band):
    """-> the lanes whose winners agree: the same tri, or an exact tie in
    the port's arithmetic (the JAX winner's row accepted at the port's
    winning t, which the port breaks by the smaller tri id and the JAX
    kernel by its own t rounding: coplanar faces, such as a box's bottom on
    the floor, where a band lets both accept).  Plain agreement must still
    exceed 0.99."""
    same = j["tri"] == t["tri"]
    assert same.mean() > 0.99, f"plain tri agreement {same.mean()}"
    tf = c["tframe"]
    coef = coef_table(tf, band)
    for r in np.nonzero(~same & (j["tri"] >= 0) & (t["tri"] >= 0))[0]:
        row = (tf.dense_tri == int(j["tri"][r])) & (tf.dense_obj == int(j["obj"][r]))
        oo = torch.from_numpy(o[r:r + 1]) - tf.dense_center
        tt, _u, _v, acc = tri_quantities(coef[row], oo, torch.from_numpy(d[r:r + 1]), band)
        same[r] = bool((acc[0] & (tt[0] == float(t["t"][r]))).any())
    return same


def _check_k1a(c, o, d, j, t, band):
    same = _tri_agreement(c, o, d, j, t, band)
    assert same.mean() > 0.999, f"tri agreement {same.mean()}"
    same &= j["tri"] == t["tri"]
    np.testing.assert_array_equal(j["obj"][same], t["obj"][same])
    _close(j, t, same & (j["tri"] >= 0))
    assert (j["vis"] == t["vis"]).mean() > 0.999, f"vis agreement {(j['vis'] == t['vis']).mean()}"


def test_k1a(cornell):
    """The primary launch, then a bounce-shaped launch from its hits (the
    hit triangle skipped, min_dist the dtype epsilon, a quarter of the
    lanes dead), each with the fused shadow phase at the dtype epsilon."""
    c = cornell
    tp, fb = c["tprec"], c["fallback"]
    band = acceptance_band(c["tframe"], c["cfg"], tp)
    assert band == dense_band(tp, fb)
    assert fused_moveforward(tp, band) == tp.ray_moveforward_t == 0.1
    j0, t0 = _k1a_both(c, c["o"], c["d"])
    _check_k1a(c, c["o"], c["d"], j0, t0, band)
    assert (t0["tri"] >= 0).mean() > 0.99 and t0["vis"].any() and not t0["vis"].all()

    rng = np.random.default_rng(7)
    R = c["o"].shape[0]
    o = (c["o"] + j0["t"][:, None] * c["d"]).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(np.sum(d * c["d"], axis=1, keepdims=True) > 0, -d, d).astype(np.float32)
    dead = rng.random(R) < 0.25
    maxd = np.where(dead, 0.0, 1e5).astype(np.float32)
    mind = np.full(R, tp.ray_moveforward_t, np.float32)
    j, t = _k1a_both(c, o, d, skip_tri=j0["tri"].astype(np.int32), min_dist=mind,
                     max_dist=maxd)
    _check_k1a(c, o, d, j, t, band)
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
ROUTES = {"k1b": ((3, 1), "dense_pallas"), "k6": ((4, 2), "pallas")}
_SCENES = {}


def _scene(args, name, w=W):
    """The scene's tables at H x w, one build per scene, precision, size."""
    key = (args, name, w)
    if key not in _SCENES:
        _SCENES[key] = _tables(jax_sponza(*args, with_skybox=False), name, n=w, m=H)
    return dict(_SCENES[key])


def route_case(rname, name, fallback, w=W):
    """-> the launch context of route `rname` under one acceptance, its
    primary launch through both packages."""
    args, impl = ROUTES[rname]
    c = _scene(args, name, w)
    kw = dict(width=w, height=H, precision=name, traversal_impl=impl,
              triangle_fallback=fallback)
    c.update(name=rname, R=H * w, tprec=get_precision(name), fallback=fallback,
             jcfg=JaxConfig(**kw), cfg=RenderConfig(**kw))
    c["primary"] = _route_both(c, c["o"], c["d"])
    return c


@pytest.fixture(scope="module", params=ACCS, ids=ACC_IDS)
def route(request):
    return route_case("k1b", *request.param, w=64)


def _gi_rays(c, rng):
    """Hemisphere-scattered rays from the primary hits (the incoherent
    launch shape), a tenth of the live lanes dead."""
    R = c["R"]
    j0, _ = c["primary"]
    valid = j0["tri"] >= 0
    p = (c["o"] + j0["t"][:, None] * c["d"]).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(np.sum(d * c["d"], axis=1, keepdims=True) > 0, -d, d).astype(np.float32)
    maxd = np.where(valid & (rng.random(R) > 0.1), 1e5, 0.0).astype(np.float32)
    skip = np.where(valid, j0["tri"], -1).astype(np.int32)
    return p, d, skip, maxd


def _route_both(c, o, d, **kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    hj = jax_trace(c["scene"], c["frame"], jnp.asarray(o), jnp.asarray(d), prec=c["prec"],
                   cfg=c["jcfg"], **jkw)
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ht = trace(c["tframe"], torch.from_numpy(o), torch.from_numpy(d), cfg=c["cfg"],
               prec=c["tprec"], **tkw)
    names = ("t", "u", "v", "tri", "obj")
    return ({k: np.asarray(getattr(hj, k)) for k in names},
            {k: getattr(ht, k).numpy() for k in names})


def _check_closest(c, o, d, j, t, dead):
    same = _tri_agreement(c, o, d, j, t, acceptance_band(c["tframe"], c["cfg"], c["tprec"]))
    assert same.mean() > 0.999, f"tri agreement {same.mean()}"
    same &= j["tri"] == t["tri"]
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


def test_launch_forms(route):
    """K1b under each acceptance (K6's: tests/test_torch_band_packet.py)."""
    check_launch_forms(route)


def check_launch_forms(c):
    """The gates as the JAX package's (no wavefront, the dtype epsilon on
    every secondary launch, the route's band form); then the primary, the
    sorted GI bounce and the round-0 / round-1 (sorted) shadows."""
    tf, cfg, tp = c["tframe"], c["cfg"], c["tprec"]
    assert not _wavefront_route(tf, cfg, tp)
    assert incoherent_reorders(tf, cfg, tp)
    assert jax_reorders(c["scene"], c["frame"], c["jcfg"], c["prec"])
    eps = tp.ray_moveforward_t
    for coherent in (True, False):
        assert moveforward_eps(tf, cfg, tp, coherent) == eps == jax_moveforward_eps(
            c["scene"], c["frame"], c["jcfg"], c["prec"], coherent)
    band_fn = packet_band if c["name"] == "k6" else dense_band
    assert acceptance_band(tf, cfg, tp) == band_fn(tp, c["fallback"])

    j0, t0 = c["primary"]
    _check_closest(c, c["o"], c["d"], j0, t0, np.zeros(c["R"], bool))
    assert 0.1 < (t0["tri"] >= 0).mean() < 0.95

    p, d, skip, maxd = _gi_rays(c, np.random.default_rng(5))
    jg, tg = _route_both(c, p, d, skip_tri=skip, min_dist=eps, max_dist=maxd, coherent=False)
    _check_closest(c, p, d, jg, tg, maxd == 0)
    assert (tg["tri"][maxd > 0] >= 0).mean() > 0.2

    for coherent in (True, False):
        rng = np.random.default_rng(11 if coherent else 12)
        if coherent:
            q = (c["o"] + j0["t"][:, None] * c["d"]).astype(np.float32)
            valid, sk = j0["tri"] >= 0, j0["tri"]
        else:
            q = (p + np.where(jg["tri"] >= 0, jg["t"], 0)[:, None] * d).astype(np.float32)
            valid, sk = jg["tri"] >= 0, jg["tri"]
        o, sd, smax, dead = _shadow_rays(c, q, valid, rng)
        skips = np.repeat(np.where(valid, sk, -1), 2).astype(np.int32)
        j, t = _route_both(c, o, sd, find_any=True, skip_tri=skips, min_dist=eps,
                           max_dist=smax, coherent=coherent, lane_k=2)
        _check_any(j, t, dead)
        assert 0.02 < (t["tri"][~dead] >= 0).mean() < 0.98


@pytest.mark.parametrize("find_any", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("rname,name,fallback", [
    ("k1b", "bf16", "both"), ("k6", "fp16", "dtype"), ("k6", "fp32", "dtype")])
def test_row_loop_equals_plain(rname, name, fallback, find_any):
    """Under a widened acceptance (every sub-f32 form, and 'dtype') a row
    can accept a point outside every box of the tree, so K1b and K6 walk
    no tree but test every row in order with their update rule (emulated):
    equal to the plain version bit for bit on a bounce-shaped (closest) or
    shadow-shaped (any) launch.  The walk itself would not be: it misses
    such hits."""
    c = _scene(ROUTES["k1b"][0], name)  # the loop is the same on either route's table
    c["R"] = H * W
    impl = ROUTES[rname][1]
    tf, tp = c["tframe"], get_precision(name)
    names = ("t", "u", "v", "tri", "obj")
    ht = trace(tf, torch.from_numpy(c["o"]), torch.from_numpy(c["d"]), prec=tp,
               cfg=RenderConfig(width=W, height=H, precision=name, traversal_impl=impl))
    c["primary"] = ({k: getattr(ht, k).numpy() for k in names},) * 2
    p, d, skip, maxd = _gi_rays(c, np.random.default_rng(9))
    if find_any:
        p, d, maxd, _dead = _shadow_rays(c, p, maxd > 0, np.random.default_rng(3))
        skip = np.repeat(skip, 2)
    band = (packet_band if rname == "k6" else dense_band)(tp, fallback)
    assert band.widened
    args = list(_launch_args(tf, p, d, skip, np.full(p.shape[0], 0.1, np.float32), maxd))
    args[5] = coef_table(tf, band)
    plain = dense_trace_multi_plain(*args[:8], find_any=find_any, band=band)
    sel = torch.arange(0, p.shape[0], 4)
    sub = [a[sel] for a in args[:5]] + args[5:8]
    tree = build_tree(args[8], args[9], args[5].shape[0], LEAF)
    for a, b in zip(_walk(*sub, tree, find_any, band), plain):
        assert torch.equal(a, b[sel])
    assert (plain[3][sel] >= 0).any() and (plain[3][sel] < 0).any()


def test_fp16_dtype_forms_differ():
    """A property of the reference, copied as it is: in fp16 the dense
    kernels' dtype test reads its rows rounded to bf16 (`_mxu_tables` :910,
    the ray operand too, :283-285) under fp16's narrower band constants,
    while K6 reads true fp16 rows.  On Cornell's 64 x 64 primary rays
    (106,496 forward, finite tests) the two fp16 'dtype' acceptances
    disagree with the f32 strict test on 414 (dense) and 448 (packet)
    tests and with each other on 128, and the dense form rejects no strict
    hit there but does on colonnade-830 (2 of 660,340 at 32 x 32); in bf16
    the two forms agree on every test of both scenes."""
    from low_precision_raytracer_tpu_torch.models.procedural import (
        cornell_box_scene,
        sponza_like_scene,
    )
    from low_precision_raytracer_tpu_torch.models.scene import flatten_frame as t_flatten
    from low_precision_raytracer_tpu_torch.ops.camera import primary_ray_grid as t_grid

    for host, n, want in ((cornell_box_scene(), 64, (414, 448, 128, 0)),
                          (sponza_like_scene(3, 1), 32, (146, 124, 106, 2))):
        counts = {}
        for name in ("fp16", "bf16"):
            p = get_precision(name)
            fr = t_flatten(host, p, "cpu", 4, n, n)
            o, d = t_grid(fr.cam_l2w_f32, fr.cam_fov_y_f32, n, n, torch.float32)
            o, d = o.reshape(-1, 3) - fr.dense_center, d.reshape(-1, 3)
            t, _, _, strict = tri_quantities(coef_table(fr), o, d)
            ok = torch.isfinite(t) & (t > 0)
            acc = [tri_quantities(coef_table(fr, b), o, d, b)[3]
                   for b in (dense_band(p, "dtype"), packet_band(p, "dtype"))]
            counts[name] = (int(((acc[0] != strict) & ok).sum()),
                            int(((acc[1] != strict) & ok).sum()),
                            int(((acc[0] != acc[1]) & ok).sum()),
                            int((~acc[0] & strict & ok).sum()))
        assert counts["fp16"] == want, counts
        assert counts["bf16"][2] == 0 and counts["bf16"][0] == counts["bf16"][1] > 0
