"""PyTorch port, fp16 end to end, against the JAX package.

- The fp16 tables (the scene's attribute rows, materials and sky in fp16,
  the frame's `dense_n` rounded to fp16 beside the f32 rows) bit for bit
  against the JAX package's on Cornell and colonnade-5k.
- The routes: fp16 under 'auto' takes the kernel routes (the dense route
  with 'mxu3', the wavefront for colonnade-83k's incoherent launches), the
  gates answering as the JAX package's do with the route named
  (`traversal_impl='dense_pallas'`; on the TPU the JAX package sends fp16
  'auto' to its XLA routes only because Mosaic has no f16 type).
- The per-ray wavefront in fp16 (rays rounded to fp16, the packed u/v
  decode) against the JAX `trace_rays_wavefront(prec=fp16,
  interpret=True)` on colonnade-370, at the bars of
  tests/test_torch_wavefront.py.
- `ops/diagnostics.py:fallback_rate` against the JAX function on Cornell's
  primary launch at 64 x 64, fp16 and bf16: tested counts equal, rates
  within 1e-3.
- Frames against the JAX `Renderer` with the route named and the JAX
  uniforms fed in (tests/test_torch_render_e2e.py's bars, >= 35 dB): the
  fp16 flagship at 32 x 32 over 3 frames; and golden config 3 (fp16, 48 x
  48, made by the JAX package on its XLA 'dense' route with the 'both'
  test) in the port at > 30 dB (tests/test_golden.py's fp16 bar)."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import RenderConfig as JaxConfig
from low_precision_raytracer_tpu.config import get_precision as jax_precision
from low_precision_raytracer_tpu.models.procedural import cornell_box_scene as jax_cornell
from low_precision_raytracer_tpu.models.procedural import sponza_like_scene as jax_sponza
from low_precision_raytracer_tpu.models.scene import flatten_frame
from low_precision_raytracer_tpu.ops import diagnostics as JD
from low_precision_raytracer_tpu.ops import wavefront as JW
from low_precision_raytracer_tpu.ops.camera import primary_ray_grid
from low_precision_raytracer_tpu.ops.trace import incoherent_reorders as jax_reorders
from low_precision_raytracer_tpu.ops.trace import moveforward_eps as jax_moveforward_eps
from low_precision_raytracer_tpu.ops.trace import resolve_fallback as jax_resolve_fallback
from low_precision_raytracer_tpu.render.renderer import Renderer as JaxRenderer
from low_precision_raytracer_tpu.utils.rng import render_key
from low_precision_raytracer_tpu_torch.config import RenderConfig, get_precision
from low_precision_raytracer_tpu_torch.models import scene as tscene
from low_precision_raytracer_tpu_torch.models.procedural import (
    cornell_box_scene,
    sponza_like_scene,
)
from low_precision_raytracer_tpu_torch.ops import wavefront as W
from low_precision_raytracer_tpu_torch.ops.dense_trace import STRICT
from low_precision_raytracer_tpu_torch.ops.diagnostics import fallback_rate
from low_precision_raytracer_tpu_torch.ops.trace import (
    _wavefront_route,
    acceptance_band,
    di_fusible,
    fused_moveforward,
    incoherent_reorders,
    moveforward_eps,
    resolve_fallback,
)
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_fp32 import _tables
from test_torch_render_e2e import _jax_pallas_cfg, _jax_uniforms, _psnr, _run_both
from test_torch_scene import _assert_tables_equal, _jax_tables
from test_torch_wavefront import _check_closest

FP16 = get_precision("fp16")


# ---------------------------------------------------------------------------
# tables and routes


@pytest.mark.parametrize("args", [None, (4, 2)], ids=["cornell", "colonnade-5k"])
def test_fp16_tables_match_jax_bitwise(args):
    host_j = jax_cornell() if args is None else jax_sponza(*args)
    host_t = cornell_box_scene() if args is None else sponza_like_scene(*args)
    s_jax, f_jax = _jax_tables("fp16", host_j)
    s = tscene.build_scene_arrays(host_t, "fp16", "cpu", walk=True)
    f = tscene.flatten_frame(host_t, "fp16", "cpu", max_direct_lights=4, width=64, height=48,
                             walk=True)
    _assert_tables_equal(s, f, s_jax, f_jax)
    assert f.dense_n.dtype == s.tri_attr.dtype == s.sky_quad.dtype == torch.float16
    assert bool((f.dense_n.float() != f.dense_n_f32).any())


@pytest.mark.parametrize("args", [None, (8, 3)], ids=["cornell", "colonnade-83k"])
def test_fp16_routes_match_jax(args):
    """fp16 'auto': the dense route with 'mxu3' (K1a with the fused shadow
    phase on Cornell; K1b and the wavefront on colonnade-83k), the gates
    equal to the JAX package's with the route named."""
    host_j = jax_cornell() if args is None else jax_sponza(*args)
    host_t = cornell_box_scene() if args is None else sponza_like_scene(*args)
    n = 16
    jcfg = _jax_pallas_cfg(width=n, height=n, precision="fp16")
    jprec = jax_precision("fp16")
    frame = flatten_frame(host_j, jprec, max_direct_lights=4, width=n, height=n)
    tr = Renderer(host_t, RenderConfig(width=n, height=n, precision="fp16"), device="cpu")
    tf, cfg = tr.frame, tr.cfg
    assert cfg.traversal_impl == "dense_pallas"
    assert resolve_fallback(cfg.triangle_fallback, FP16) == "mxu3" == jax_resolve_fallback(
        jcfg.triangle_fallback, jprec, "dense_pallas")
    assert acceptance_band(tf, cfg, FP16) == STRICT
    assert fused_moveforward(FP16, STRICT) == FP16.ray_moveforward_t_exact == 0.01
    assert di_fusible(tf, cfg) == (args is None)
    assert incoherent_reorders(tf, cfg, FP16) == jax_reorders(None, frame, jcfg, jprec)
    assert _wavefront_route(tf, cfg, FP16) == (args is not None)
    for coherent in (True, False):
        assert moveforward_eps(tf, cfg, FP16, coherent) == jax_moveforward_eps(
            None, frame, jcfg, jprec, coherent)
    # a band given explicitly closes the wavefront gate, as in the JAX package
    both = RenderConfig(width=n, height=n, precision="fp16", triangle_fallback="both",
                        traversal_impl="dense_pallas")
    assert not _wavefront_route(tf, both, FP16)
    assert moveforward_eps(tf, both, FP16, False) == FP16.ray_moveforward_t == 0.1


# ---------------------------------------------------------------------------
# the wavefront in fp16

H, Wd = 16, 128
R = H * Wd


def _fp16(x):
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.float16).astype(jnp.float32))


@pytest.fixture(scope="module")
def colonnade_370():
    c = _tables(jax_sponza(2, 1, with_skybox=False), "fp16", n=Wd, m=H)
    perm = np.random.default_rng(3).permutation(R)
    c["o"], c["d"] = _fp16(c["o"][perm]), _fp16(c["d"][perm])
    c["primary"] = _wave_both(c, c["o"], c["d"])
    return c


def _wave_both(c, o, d, **kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    hj = JW.trace_rays_wavefront(c["scene"], c["frame"], jnp.asarray(o), jnp.asarray(d),
                                 prec=c["prec"], interpret=True, mode="oneshot", **jkw)
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ht = W.trace_rays_wavefront(c["tframe"], torch.from_numpy(o), torch.from_numpy(d),
                                prec=FP16, **tkw)
    names = ("t", "u", "v", "tri", "obj")
    return ({k: np.asarray(getattr(hj, k)) for k in names},
            {k: x.numpy() for k, x in zip(names, ht)})


def test_wavefront_fp16(colonnade_370):
    """The primary launch (scrambled), a bounce launch (fp16-rounded
    scattered rays from the hits, a tenth of the lanes dead, min_dist 0.1)
    and an any-hit launch on the same rays."""
    c = colonnade_370
    j, t = c["primary"]
    _check_closest(c, j, t, c["o"], c["d"])
    assert 0.1 < (t["tri"] >= 0).mean() < 0.95
    rng = np.random.default_rng(7)
    live = (j["tri"] >= 0) & (rng.random(R) > 0.1)
    p = _fp16(c["o"] + np.where(j["tri"] >= 0, j["t"], 0)[:, None] * c["d"])
    b = rng.normal(size=(R, 3))
    b = _fp16(b / np.linalg.norm(b, axis=1, keepdims=True))
    maxd = np.where(live, 1e5, 0.0).astype(np.float32)
    jb, tb = _wave_both(c, p, b, min_dist=0.1, max_dist=maxd)
    _check_closest(c, jb, tb, p, b, live)
    assert (tb["tri"][live] >= 0).mean() > 0.2
    ja, ta = _wave_both(c, p, b, min_dist=0.1, max_dist=np.minimum(maxd, 6.0), find_any=True)
    occ_j, occ_t = ja["tri"] >= 0, ta["tri"] >= 0
    assert (occ_j == occ_t).mean() > 0.999
    for r in (ja, ta):
        np.testing.assert_array_equal(r["tri"][~live], -1)
    assert 0.05 < occ_t[live].mean() < 0.95


# ---------------------------------------------------------------------------
# the fallback rate


@pytest.mark.parametrize("name", ["fp16", "bf16"])
def test_fallback_rate_matches_jax(name):
    n = 64
    c = _tables(jax_cornell(), name, n=n, m=n)
    # the JAX diagnostic's rays: the camera grid in the render dtype
    o, d = primary_ray_grid(c["frame"].cam_l2w, c["frame"].cam_fov_y, n, n, c["prec"].dtype)
    o = np.asarray(o.astype(jnp.float32)).reshape(-1, 3)
    d = np.asarray(d.astype(jnp.float32)).reshape(-1, 3)
    want = JD.fallback_rate(c["frame"], jnp.asarray(o), jnp.asarray(d), c["prec"])
    got = fallback_rate(c["tframe"], torch.from_numpy(o), torch.from_numpy(d),
                        get_precision(name))
    assert got["tested"] == want["tested"] and 0 < got["tested"] <= n * n * 34
    assert abs(got["rate"] - want["rate"]) <= 1e-3, (got, want)
    assert 0 < got["ambiguous"] < got["tested"]


# ---------------------------------------------------------------------------
# frames


def test_fp16_flagship_frames_match_jax():
    """The fp16 flagship (K1a with the fused shadow phase under 'mxu3') at
    32 x 32 over 3 frames."""
    n = 32
    jr = JaxRenderer(jax_cornell(), _jax_pallas_cfg(width=n, height=n, precision="fp16"))
    tr = Renderer(cornell_box_scene(), RenderConfig(width=n, height=n, precision="fp16"),
                  device="cpu")
    ct = _run_both(jr, tr, 3, n)
    assert int(ct.max()) == 2


def test_golden_config3_fp16():
    """Golden config 3 (fp16 Cornell, GI, 48 x 48, made by the JAX package
    on its XLA 'dense' route with the 'both' test): the port's kernel route
    ('mxu3') fed the JAX key chain's uniforms, > 30 dB."""
    cfg = RenderConfig(width=48, height=48, precision="fp16", gi_on=True)
    tr = Renderer(cornell_box_scene(), cfg, device="cpu")
    _key, us = _jax_uniforms(render_key(0), tr.cfg)
    img = tr.render(uniforms=us)[0].numpy()
    want = np.load(os.path.join(os.path.dirname(__file__), "golden", "config3_fp16.npy"))
    p = _psnr(img, want)
    assert p > 30.0, f"config3_fp16: PSNR vs golden {p:.2f} dB"
    assert np.isfinite(img).all()


def test_jax_renderer_fp16_auto_route_is_xla_on_cpu():
    """What the golden was made with: fp16 'auto' off the TPU resolves to
    the JAX package's XLA 'dense' route with the 'both' test (so the golden
    bounds the two routes' difference)."""
    from low_precision_raytracer_tpu.ops.trace import resolve_impl as jax_resolve_impl

    jprec = jax_precision("fp16")
    frame = flatten_frame(jax_cornell(), jprec, max_direct_lights=4, width=48, height=48)
    jcfg = JaxConfig(width=48, height=48, precision="fp16")
    assert jax.default_backend() == "cpu"
    assert jax_resolve_impl(None, frame, jcfg) == "dense"
    assert jax_resolve_fallback(jcfg.triangle_fallback, jprec, "dense") == "both"
