"""PyTorch port, the per-ray wavefront's 'rounds' mode
(`ops/wavefront.py:run_cycle`; JAX `trace_rays_wavefront(mode='rounds')`,
`run_cycle` / `round_step` :666-808) against the JAX package, on
colonnade-830 (`sponza_like_scene(3, 1)`, 830 instance triangles in 7
chunks) with `wavefront_min_tris` lowered so that its incoherent launches
take the wavefront.

- The GI-bounce launch (closest hit) and the round-1 shadow launch (any
  hit, two lanes a pixel) through both packages' `trace` at 16 x 64, the
  JAX side in interpret mode, each JAX reference computed once for the
  module.  Rays are rounded to bf16 (as tests/test_torch_wavefront.py makes
  them), so 'rounds' (f32 rays) and 'oneshot' (rays rounded to the render
  dtype) see the same rays.
- 'rounds' against the port's own 'oneshot' on the same rays: hit masks
  equal, tri equal up to exact-t ties; with the cycle starved (K_CAND = 2,
  one rank per round, one round) the refill cycle and the tail passes run
  and the result is the same.
- A frame at 8 x 8 over 2 against the JAX Renderer with
  `wavefront_mode='rounds'`.

Bars: tests/test_torch_wavefront.py's (hit masks equal; tri agreement >
0.999 counting coplanar float64 ties, plain > 0.99; t, u, v within 2e-3
where tri agrees, the port held to float64 where the reference's bf16x3
product is off; any hit: occlusion agreement > 0.999; dead lanes -1) and
tests/test_torch_render_e2e.py's (>= 35 dB)."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import RenderConfig as JaxConfig
from low_precision_raytracer_tpu.config import SVGFConfig as JaxSVGF
from low_precision_raytracer_tpu.models.procedural import sponza_like_scene as jax_sponza
from low_precision_raytracer_tpu.ops.trace import trace as jax_trace
from low_precision_raytracer_tpu.render.renderer import Renderer as JaxRenderer
from low_precision_raytracer_tpu_torch.config import RenderConfig, get_precision
from low_precision_raytracer_tpu_torch.models.procedural import sponza_like_scene
from low_precision_raytracer_tpu_torch.ops import trace as ttrace
from low_precision_raytracer_tpu_torch.ops import wavefront as W
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_band import _gi_rays
from test_torch_dense_multi import _shadow_rays
from test_torch_fp32 import _tables
from test_torch_render_e2e import _run_both
from test_torch_wavefront import _bf16, _check_closest

H, Wd = 16, 64
NAMES = ("t", "u", "v", "tri", "obj")
EPS = get_precision("bf16").ray_moveforward_t  # the wavefront's epsilon


def _port(c, o, d, mode, **kw):
    tt = lambda x: torch.from_numpy(np.array(x))  # a writable copy
    tkw = {k: (tt(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    cfg = RenderConfig(width=Wd, height=H, precision="bf16", wavefront_min_tris=0,
                       wavefront_mode=mode)
    hit = ttrace.trace(c["tframe"], tt(o), tt(d), cfg=cfg,
                       prec=c["tprec"], coherent=False, **tkw)
    return {k: getattr(hit, k).numpy() for k in NAMES}


def _jax(c, o, d, **kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    hit = jax_trace(c["scene"], c["frame"], jnp.asarray(o), jnp.asarray(d), prec=c["prec"],
                    cfg=c["jcfg"], coherent=False, **jkw)
    return {k: np.asarray(getattr(hit, k)) for k in NAMES}


@pytest.fixture(scope="module")
def launches():
    """colonnade-830's two wavefront launch forms, bf16-rounded rays, and
    the JAX references (once for the module)."""
    c = _tables(jax_sponza(3, 1, with_skybox=False), "bf16", n=Wd, m=H)
    c["jcfg"] = JaxConfig(width=Wd, height=H, precision="bf16", traversal_impl="dense_pallas",
                          wavefront_min_tris=0, wavefront_mode="rounds")
    c.update(R=H * Wd, tprec=get_precision("bf16"))
    cfg = RenderConfig(width=Wd, height=H, precision="bf16")
    prim = ttrace.trace(c["tframe"], torch.from_numpy(c["o"]), torch.from_numpy(c["d"]),
                        cfg=cfg, prec=c["tprec"])
    c["primary"] = ({k: getattr(prim, k).numpy() for k in NAMES},) * 2
    p, d, skip, maxd = _gi_rays(c, np.random.default_rng(5))
    p, d = _bf16(p), _bf16(d)
    gi = dict(skip_tri=skip, min_dist=EPS, max_dist=maxd)
    c["gi"] = (p, d, gi, maxd > 0, _jax(c, p, d, **gi))
    g = _port(c, p, d, "rounds", **gi)
    q = _bf16(p + np.where(g["tri"] >= 0, g["t"], 0)[:, None] * d)
    o, sd, smax, dead = _shadow_rays(c, q, g["tri"] >= 0, np.random.default_rng(12))
    sd = _bf16(sd)
    sh = dict(find_any=True, skip_tri=np.repeat(np.where(g["tri"] >= 0, g["tri"], -1), 2)
              .astype(np.int32), min_dist=EPS, max_dist=smax, lane_k=2)
    c["shadow"] = (o, sd, sh, ~dead, _jax(c, o, sd, **sh))
    return c


def test_rounds_gi_bounce(launches):
    """The GI bounce in 'rounds' against the JAX 'rounds' launch."""
    c = launches
    W.reset_stats()
    p, d, kw, live, j = c["gi"]
    t = _port(c, p, d, "rounds", **kw)
    _check_closest(c, j, t, p, d, live)
    assert (t["tri"][live] >= 0).mean() > 0.2
    assert W.STATS["launches"] == 1 and W.STATS["cycles"] == 1 and W.STATS["rounds"] >= 1


def test_rounds_shadows_any_hit(launches):
    """Round-1 shadows (any hit, lane_k = 2) in 'rounds'."""
    c = launches
    o, d, kw, live, j = c["shadow"]
    t = _port(c, o, d, "rounds", **kw)
    occ_j, occ_t = j["tri"] >= 0, t["tri"] >= 0
    assert (occ_j == occ_t).mean() > 0.999, f"occlusion agreement {(occ_j == occ_t).mean()}"
    for r in (j, t):
        np.testing.assert_array_equal(r["tri"][~live], -1)
    assert 0.02 < occ_t[live].mean() < 0.98


def _same_up_to_ties(a, b, find_any=False):
    np.testing.assert_array_equal(a["tri"] >= 0, b["tri"] >= 0)
    if find_any:  # an any-hit launch returns some blocker: occlusion only
        return
    diff = a["tri"] != b["tri"]
    assert np.array_equal(a["t"][diff], b["t"][diff]), "tri differs off an exact-t tie"
    same = ~diff & (a["tri"] >= 0)
    for k in NAMES:
        np.testing.assert_array_equal(a[k][same], b[k][same], err_msg=k)


@pytest.mark.parametrize("starved", [False, True], ids=["defaults", "starved"])
def test_rounds_matches_oneshot(launches, starved, monkeypatch):
    """'rounds' equals 'oneshot' on the same rays (hit masks, and for the
    GI bounce tri up to exact-t ties) on both launch forms.  Starved (two candidates a
    cycle, one rank per round, one round, a refill cycle above 2 groups),
    most rays reach the second cycle and the tail passes, and K5 runs with
    q = 1; by default with q = 4."""
    c = launches
    qs = []
    real = W.assigned_test
    monkeypatch.setattr(W, "assigned_test", lambda *a, **kw: (
        qs.append(a[5].shape[1]) or real(*a, **kw)))
    if starved:
        for name, v in (("K_CAND", 2), ("Q_RANKS", 1), ("N_ROUNDS", 1),
                        ("CYCLE2_MIN_GROUPS", 2)):
            monkeypatch.setattr(W, name, v)
    for form in ("gi", "shadow"):
        o, d, kw, _live, _j = c[form]
        W.reset_stats()
        r = _port(c, o, d, "rounds", **kw)
        stats = dict(W.STATS)
        _same_up_to_ties(r, _port(c, o, d, "oneshot", **kw), kw.get("find_any", False))
        if starved:
            assert stats["cycles"] == 2 and stats["tail_rays"] > 0 and stats["tail_passes"] > 0
        else:
            assert stats["cycles"] == 1 and 1 <= stats["rounds"] <= W.N_ROUNDS
    q = 1 if starved else W.Q_RANKS
    assert q in qs


def test_rounds_frame_matches_jax():
    """colonnade-830 (skybox on) with its incoherent launches on the
    wavefront in 'rounds' mode, 8 x 8 over 2 frames, against the JAX
    Renderer."""
    n = 8
    jcfg = JaxConfig(width=n, height=n, precision="bf16", traversal_impl="dense_pallas",
                     wavefront_min_tris=0, wavefront_mode="rounds",
                     svgf=JaxSVGF(wavelet_impl="pallas"))
    cfg = RenderConfig(width=n, height=n, precision="bf16", wavefront_min_tris=0,
                       wavefront_mode="rounds")
    jr = JaxRenderer(jax_sponza(3, 1), jcfg)
    tr = Renderer(sponza_like_scene(3, 1), cfg, device="cpu")
    assert ttrace._wavefront_route(tr.frame, tr.cfg, tr.cfg.prec)
    W.reset_stats()
    _run_both(jr, tr, 2, n)
    assert W.STATS["launches"] == 4  # the GI bounce and round-1 shadows, per frame
