"""PyTorch port, the two-level BVH walk (`ops/traversal.py`, plain version
`trace_rays_plain`) and its box and triangle tests (`ops/aabb.py`,
`ops/triangle.py`) against the JAX package's `trace_rays`, `ray_aabb_*`
and `ray_triangle`, on numpy-seeded inputs and the same tables (the JAX
leaves carried across by `scene_from_numpy`).

The walk: the single triangle, the icosphere, Cornell and colonnade-5k, at
fp32, bf16 and fp16, under 'both' and 'dtype', closest and any hit, on
primary rays, rays from inside the scene box with zero and tiny direction
components (skipped axes; fp16 quotients that overflow), with skip_tri and
per-ray min / max distances, and on colonnade-5k the sun's shadow rays
(d_x = 0 exactly, the longest walks).  Bars: fp32 tri-id agreement >=
0.9995 with t / u / v within 1e-5 (rtol and atol) where the ids agree;
bf16 and fp16 tri-id agreement > 0.999 with t / u / v within rtol / atol
2e-3; any hit on occlusion only, > 0.999 (ROADMAP queue 3's record).

The JAX walk compiles a lax.while_loop per case; XLA:CPU has crashed
compiling such a program late in a long-lived process (tests/conftest.py),
so the JAX references run in a fresh interpreter (`JaxProcess`), once per
module, while the port walks in this one."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import get_precision as jax_precision
from low_precision_raytracer_tpu.models import procedural as jproc
from low_precision_raytracer_tpu.models.scene import build_scene_arrays, flatten_frame
from low_precision_raytracer_tpu.ops.aabb import ray_aabb_object as jax_box_object
from low_precision_raytracer_tpu.ops.aabb import ray_aabb_scene as jax_box_scene
from low_precision_raytracer_tpu.ops.camera import primary_ray_grid
from low_precision_raytracer_tpu.ops.triangle import ray_triangle as jax_ray_triangle
from low_precision_raytracer_tpu_torch.config import get_precision
from low_precision_raytracer_tpu_torch.models import scene as tscene
from low_precision_raytracer_tpu_torch.ops.aabb import dtype_const, ray_aabb_object, ray_aabb_scene
from low_precision_raytracer_tpu_torch.ops.traversal import N_STATS, trace_rays
from low_precision_raytracer_tpu_torch.ops.triangle import ray_triangle

TESTS = Path(__file__).resolve().parent
NP_DT = {"bf16": ml_dtypes.bfloat16, "fp16": np.float16, "fp32": np.float32}
TORCH_DT = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}


class JaxProcess:
    """`module.func(payload)` started in a fresh interpreter (tests/ on its
    path, JAX on the CPU); payload and result travel as pickles.
    `result()` waits for it."""

    def __init__(self, module: str, func: str, payload):
        self._tmp = tempfile.TemporaryDirectory()
        src = os.path.join(self._tmp.name, "in.pkl")
        self._dst = os.path.join(self._tmp.name, "out.pkl")
        with open(src, "wb") as fh:
            pickle.dump(payload, fh)
        code = ("import sys, pickle, jax\n"
                "jax.config.update('jax_platforms', 'cpu')\n"
                f"sys.path[:0] = [{str(TESTS)!r}, {str(TESTS.parent)!r}]\n"
                f"import {module} as m\n"
                f"out = m.{func}(pickle.load(open({src!r}, 'rb')))\n"
                f"pickle.dump(out, open({self._dst!r}, 'wb'))\n")
        self._proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.DEVNULL,
                                      stderr=subprocess.PIPE, text=True,
                                      env={**os.environ, "JAX_PLATFORMS": "cpu"})

    def result(self):
        try:
            _out, err = self._proc.communicate(timeout=900)
            assert self._proc.returncode == 0, err[-4000:]
            with open(self._dst, "rb") as fh:
                return pickle.load(fh)
        finally:
            self._proc.kill()
            self._tmp.cleanup()


def jax_host(name):
    return {"triangle": jproc.single_triangle_scene,
            "icosphere": lambda: jproc.single_mesh_scene(jproc.icosphere_mesh(2)),
            "cornell": jproc.cornell_box_scene,
            "colonnade-5k": jproc.sponza_like_scene}[name]()


def jax_tables(name, precision):
    host = jax_host(name)
    prec = jax_precision(precision)
    return (build_scene_arrays(host, prec, leaf_size=4),
            flatten_frame(host, prec, max_direct_lights=4, width=16, height=16))


def port_tables(scene, frame):
    """The JAX tables as the port's SceneArrays / FrameInput (CPU)."""
    snp = {k: getattr(scene, k) for k in tscene.tensor_fields(tscene.SceneArrays)}
    snp = {k: None if v is None else np.asarray(v) for k, v in snp.items()}
    snp.update(n_meshes=scene.n_meshes, sky_valid=scene.sky_valid, leaf_size=scene.leaf_size)
    fnp = {k: getattr(frame, k) for k in tscene.tensor_fields(tscene.FrameInput)}
    fnp = {k: None if v is None else np.asarray(v) for k, v in fnp.items()}
    fnp.update(obj_layout=frame.obj_layout, n_lights=frame.n_lights,
               dense_morton=frame.dense_morton)
    return tscene.scene_from_numpy(snp, fnp, "cpu")


def make_rays(name, frame, seed=0):
    """numpy f32 rays of one scene: 16 x 16 primary rays, then 256 rays from
    inside the scene box in random directions (a quarter with one exact
    zero component, an eighth with a component of 1e-6: its fp16 slab
    quotients overflow) with random skip ids, min in [0, 0.05) and a fifth
    with a short max; on colonnade-5k also 128 sun shadow rays from the
    floor (d_x = 0).  -> dict(o, d, skip, mind, maxd)."""
    rng = np.random.default_rng(seed)
    o, d = primary_ray_grid(frame.cam_l2w_f32, frame.cam_fov_y_f32, 16, 16, jnp.float32)
    po, pd = np.asarray(o).reshape(-1, 3), np.asarray(d).reshape(-1, 3)
    lo, hi = np.asarray(frame.obj_aabb_lo).min(0), np.asarray(frame.obj_aabb_hi).max(0)
    n = 256
    ro = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    axis = rng.integers(0, 3, n)
    rd[np.arange(n // 4), axis[:n // 4]] = 0.0
    rd[n // 4:3 * n // 8, 1] = 1e-6
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    n_tri = max(t1 for _m, _t0, t1 in frame.obj_layout)
    parts_o, parts_d = [po, ro], [pd, rd.astype(np.float32)]
    skip = [np.full(len(po), -1, np.int32), rng.integers(-1, n_tri, n).astype(np.int32)]
    mind = [np.zeros(len(po), np.float32), (rng.random(n) * 0.05).astype(np.float32)]
    maxd = [np.full(len(po), 1e5, np.float32),
            np.where(rng.random(n) < 0.2, rng.random(n) * 2, 1e5).astype(np.float32)]
    if name == "colonnade-5k":
        ld = np.asarray(frame.light_dir[0], np.float32)
        sun = (-ld / np.linalg.norm(ld)).astype(np.float32)
        sun[0] = 0.0
        m = 128
        so = np.stack([rng.uniform(-12, 12, m), np.zeros(m), rng.uniform(-12, 12, m)], 1)
        parts_o.append(so.astype(np.float32))
        parts_d.append(np.tile(sun, (m, 1)))
        skip.append(np.full(m, -1, np.int32))
        mind.append(np.full(m, 0.1, np.float32))
        maxd.append(np.full(m, 1e5, np.float32))
    return dict(o=np.concatenate(parts_o), d=np.concatenate(parts_d), skip=np.concatenate(skip),
                mind=np.concatenate(mind), maxd=np.concatenate(maxd))


# (scene, precision, fallback, find_any): every precision and fallback on
# Cornell, a spread of them on the others
CASES = (
    [("cornell", p, fb, False) for p in ("fp32", "bf16", "fp16") for fb in ("both", "dtype")]
    + [("cornell", p, "both", True) for p in ("fp32", "bf16")] + [("cornell", "fp16", "dtype", True)]
    + [("triangle", "fp32", "both", False), ("triangle", "bf16", "dtype", True),
       ("icosphere", "bf16", "both", False), ("icosphere", "fp16", "both", True)]
    + [("colonnade-5k", p, fb, a) for p, fb, a in (("bf16", "both", False), ("bf16", "both", True),
                                                   ("fp32", "both", False),
                                                   ("fp16", "dtype", False))])


def jax_walk_refs(cases):
    """Child process: the JAX `trace_rays` of every case -> {case: (t, u,
    v, tri, obj)} as numpy."""
    from low_precision_raytracer_tpu.ops.traversal import trace_rays as jax_trace_rays

    out = {}
    for case in cases:
        name, precision, fallback, find_any = case
        scene, frame = jax_tables(name, precision)
        r = make_rays(name, frame)
        hit = jax_trace_rays(scene, frame, jnp.asarray(r["o"]), jnp.asarray(r["d"]),
                             prec=jax_precision(precision), find_any=find_any, fallback=fallback,
                             leaf_size=4, skip_tri=jnp.asarray(r["skip"]),
                             min_dist=jnp.asarray(r["mind"]), max_dist=jnp.asarray(r["maxd"]))
        out[case] = tuple(np.asarray(x) for x in hit)
    return out


def port_walk(case):
    """The port's plain walk of one case -> (rays, (t, u, v, tri, obj),
    per-ray counts) as numpy."""
    name, precision, fallback, find_any = case
    scene, frame = jax_tables(name, precision)
    r = make_rays(name, frame)
    ts, tf = port_tables(scene, frame)
    stats = torch.zeros((r["o"].shape[0], N_STATS), dtype=torch.int32)
    got = trace_rays(ts, tf, torch.from_numpy(r["o"]), torch.from_numpy(r["d"]),
                     prec=get_precision(precision), find_any=find_any, fallback=fallback,
                     skip_tri=torch.from_numpy(r["skip"]), min_dist=torch.from_numpy(r["mind"]),
                     max_dist=torch.from_numpy(r["maxd"]), stats=stats)
    return r, tuple(x.numpy() for x in got), stats.numpy()


@pytest.fixture(scope="module")
def walks():
    """{case: (JAX hit, port rays, port hit, port counts)}: the JAX
    references run in their own process while the port walks here."""
    jax_proc = JaxProcess("test_torch_traversal", "jax_walk_refs", CASES)
    port = {case: port_walk(case) for case in CASES}
    ref = jax_proc.result()
    return {case: (ref[case], *port[case]) for case in CASES}


def hold_hits(ref, got, precision, find_any):
    """The walk's bars (module docstring) on two (t, u, v, tri, obj)."""
    if find_any:
        agree = (ref[3] >= 0) == (got[3] >= 0)
        assert agree.mean() > 0.999, f"occlusion agreement {agree.mean()}"
        return
    same = ref[3] == got[3]
    tol = 1e-5 if precision == "fp32" else 2e-3
    if precision == "fp32":
        assert same.mean() >= 0.9995, f"tri agreement {same.mean()}"
    else:
        assert same.mean() > 0.999, f"tri agreement {same.mean()}"
    np.testing.assert_array_equal(ref[4][same], got[4][same])
    hit = same & (ref[3] >= 0)
    for i in range(3):
        np.testing.assert_allclose(got[i][hit], ref[i][hit], rtol=tol, atol=tol)
    miss = same & (ref[3] < 0)
    assert (got[0][miss] == 1e5).all() and (got[4][miss] == -1).all()


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_plain_walk_matches_jax(walks, case):
    name, _precision, _fallback, find_any = case
    ref, r, got, st = walks[case]
    hold_hits(ref, got, case[1], find_any)
    hits = got[3] >= 0
    assert hits.any() and not hits.all()
    # skip_tri is honoured, and nothing is hit outside (min, max)
    assert (got[3][hits] != r["skip"][hits]).all()
    if not find_any:
        assert (got[0][hits] > r["mind"][hits]).all() and (got[0][hits] < r["maxd"][hits]).all()
    assert (st[:, 0] >= 1).all() and (st[:, 3] <= st[:, 0]).all()
    if name == "colonnade-5k":  # the sun's rays skip x: they walk far more
        assert np.median(st[-128:, :2].sum(1)) > np.median(st[:256, :2].sum(1))


def test_walk_tables_only_on_its_route():
    """The BLAS and the TLAS are built only on the walk's route: a Renderer
    that resolves to the dense route has neither, and `trace` on 'jax'
    over its tables raises; a Renderer on 'jax' has both and traces."""
    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene
    from low_precision_raytracer_tpu_torch.ops.trace import trace
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    cfg = RenderConfig(width=8, height=8, precision="bf16")
    walk_cfg = RenderConfig(width=8, height=8, precision="bf16", traversal_impl="jax")
    o, d = torch.tensor([[0.0, 1.0, 3.0]]), torch.tensor([[0.0, 0.0, -1.0]])
    r = Renderer(cornell_box_scene(), cfg, device="cpu")
    assert r.cfg.traversal_impl == "dense_pallas"
    assert all(getattr(r.scene, k) is None for k in tscene.WALK_SCENE_FIELDS)
    assert all(getattr(r.frame, k) is None for k in tscene.TLAS_FIELDS)
    with pytest.raises(ValueError, match="walk=True"):
        trace(r.frame, o, d, cfg=walk_cfg, prec=cfg.prec, scene=r.scene)
    w = Renderer(cornell_box_scene(), walk_cfg, device="cpu")
    assert all(getattr(w.scene, k) is not None for k in tscene.WALK_SCENE_FIELDS)
    assert all(getattr(w.frame, k) is not None for k in tscene.TLAS_FIELDS)
    hit = trace(w.frame, o, d, cfg=w.cfg, prec=cfg.prec, scene=w.scene)
    assert int(hit.tri[0]) >= 0 and 0 < float(hit.t[0]) < 1e5


@pytest.mark.parametrize("precision", ["bf16", "fp16", "fp32"])
def test_dtype_constants_match_jax(precision):
    """Every constant the walk rounds to the dtype equals numpy's (ml_dtypes')
    single rounding from float64; the f32 maximum is inf below f32."""
    dt = TORCH_DT[precision]
    for x in (0.02, 1.001953, 0.2, 3.0, 1.0, 2.0**-7, 2.0**-5, 2.0**-10, 2.0**-8,
              float(np.finfo(np.float32).max)):
        with np.errstate(over="ignore"):
            want = np.asarray(x, NP_DT[precision]).astype(np.float64)
        assert float(dtype_const(x, dt)) == float(want), x
    if precision != "fp32":
        assert float(dtype_const(float(np.finfo(np.float32).max), dt)) == float("inf")


def _to_torch(a, precision):
    a = np.asarray(a)
    if precision == "bf16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("precision", ["bf16", "fp16", "fp32"])
def test_box_tests_match_jax(precision):
    """Both slab tests, bit for bit: random boxes, rays with exact zero
    direction components (the axis skipped), components of 1e-6 (fp16
    quotients overflow to inf and are skipped), origins on a box face."""
    rng = np.random.default_rng(11)
    n = 4096
    jd = NP_DT[precision]
    o = rng.standard_normal((n, 3)).astype(np.float32) * 4
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[: n // 4, 0] = 0.0
    d[n // 4: n // 3, 1:] = 0.0
    d[n // 3: n // 2, 2] = 1e-6
    lo = rng.standard_normal((n, 3)).astype(np.float32)
    hi = lo + np.abs(rng.standard_normal((n, 3))).astype(np.float32)
    lo[-64:, 0] = o[-64:, 0]  # origin on a face: 0 / 0 on a zero axis
    d[-64:, 0] = 0.0
    args = [np.asarray(jnp.asarray(x, jd)) for x in (o, d, lo, hi)]
    jp = jax_precision(precision)
    # the port's slops are module constants equal to the JAX defaults
    for jfn, tfn, slop in ((jax_box_scene, ray_aabb_scene, jp.scene_aabb_slop),
                           (jax_box_object, ray_aabb_object, jp.object_aabb_slop)):
        ref = jax.jit(lambda a, b, c, e, _f=jfn, _s=slop: _f(a, b, c, e, _s))(*args)
        got = tfn(*(_to_torch(x, precision) for x in args))
        for x, y in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(x).astype(np.float32), y.float().numpy())
        assert 0 < float(got[0].float().mean()) < 1


@pytest.mark.parametrize("fallback", ["both", "dtype"])
@pytest.mark.parametrize("precision", ["bf16", "fp16", "fp32"])
def test_triangle_test_matches_jax(precision, fallback):
    """The M-shift test on rays aimed at the triangles' edges and corners
    (barycentrics inside the error band, so 'both' re-tests them in f32)
    and at random points, a quarter of them outside: acceptance agreement >
    0.999 (>= 0.9995 in fp32), and where both accept t within the walk's
    bars and u / v within them plus 8 ulps of the dtype at the size of
    Ox's and t Dx's partial products (XLA's fused multiply-adds, amplified
    by the cancellation in u = Ox + t Dx); bf16 'dtype' bit for bit
    (ops/triangle.py's rules)."""
    rng = np.random.default_rng(12)
    n = 8192
    jd = NP_DT[precision]
    v = rng.standard_normal((n, 3, 3)).astype(np.float32)
    bary = rng.random((n, 3))
    bary[np.arange(n // 2), rng.integers(0, 3, n // 2)] *= 1e-3  # near an edge
    bary /= bary.sum(1, keepdims=True)
    out = np.arange(3 * n // 4, n)
    bary[out, rng.integers(0, 3, out.size)] -= rng.random(out.size) * 0.3  # outside
    target = np.einsum("nk,nkj->nj", bary, v.astype(np.float64))
    o = (target + rng.standard_normal((n, 3)) * 3).astype(np.float32)
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    from low_precision_raytracer_tpu.models.scene import compute_m_matrices

    m = compute_m_matrices(v.reshape(-1, 3), np.arange(3 * n).reshape(n, 3))
    v2 = v[:, 2]
    best = np.full(n, 1e5, np.float32)
    mind = np.zeros(n, np.float32)
    maxd = np.full(n, 1e5, np.float32)
    oj, dj, v2j, mj = (np.asarray(jnp.asarray(x, jd)) for x in (o, d, v2, m))
    ref = jax.jit(lambda a, b, c, e: jax_ray_triangle(
        a, b, c, e, jnp.asarray(v2), jnp.asarray(m), jnp.asarray(best), jnp.asarray(mind),
        jnp.asarray(maxd), jax_precision(precision), fallback=fallback))(oj, dj, v2j, mj)
    got = ray_triangle(*(_to_torch(x, precision) for x in (oj, dj, v2j, mj)),
                       torch.from_numpy(v2), torch.from_numpy(m), torch.from_numpy(best),
                       torch.from_numpy(mind), torch.from_numpy(maxd), get_precision(precision),
                       fallback=fallback)
    acc_j, acc_t = np.asarray(ref.accept), got.accept.numpy()
    agree = acc_j == acc_t
    assert agree.mean() >= (0.9995 if precision == "fp32" else 0.999 + 1e-9), agree.mean()
    assert 0.5 < acc_t.mean() < 0.97
    both = acc_j & acc_t
    tol = 1e-5 if precision == "fp32" else 2e-3
    np.testing.assert_allclose(got.t.numpy()[both], np.asarray(ref.t)[both], rtol=tol, atol=tol)
    # u = Ox + t Dx cancels on these random (some thin) triangles, and
    # XLA's fused multiply-adds in the fp16 / fp32 dtype rows move Ox by
    # ulps of its partial products: u / v are held to the bars plus 8 ulps
    # of the dtype at the sum of |partial products| of Ox and t Dx
    o64, d64 = o.astype(np.float64), d.astype(np.float64)
    t64 = np.asarray(ref.t, np.float64)
    eps = {"bf16": 2.0**-8, "fp16": 2.0**-11, "fp32": 2.0**-24}[precision]
    for row, x, y in ((0, ref.u, got.u), (1, ref.v, got.v)):
        mr = m[:, row].astype(np.float64)
        scale = (np.abs(mr * (o64 - v2)).sum(1)
                 + np.abs(t64) * np.abs(mr * d64).sum(1))
        bound = tol * (1 + np.abs(np.asarray(x))) + 8 * eps * scale
        assert (np.abs(y.numpy() - np.asarray(x))[both] <= bound[both]).all()
    if precision == "bf16" and fallback == "dtype":
        for x, y in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
