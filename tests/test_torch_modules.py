"""PyTorch port, module by module against the JAX package on the same
inputs: the camera grid, the G-buffer and shade from the same hit
records and uniforms, the bounce-hit attributes, the depth gradients and
the compose stage.

Bars and why:
- camera: max abs diff <= 1e-6 (f32 elementwise math + a 3x3 f32 product
  in both, TF32 off);
- G-buffer and shade in f32: rtol 1e-5 (same operations; ~1 ulp
  transcendentals), with atol 1e-6 for values that cancel toward 0.  On
  shade outputs it must hold on >= 99.9% of the entries, and rtol 2e-4 on
  all: XLA on the CPU contracts multiply-add pairs into FMAs (jnp.sum(a*b)
  over 3 components equals the fma chain bit for bit), eager PyTorch
  rounds every product, and near the mirror direction the GGX lobe's
  (1 - nh^2) cancels and amplifies that 1-ulp difference ~1000x;
- bf16 outputs (the bounce-hit attributes), compared in f32 within 2^-7
  relative: XLA on the CPU fuses and rounds bf16 at other points than
  eager PyTorch, and one bf16 rounding is 2^-8 relative;
- compose: within 1 ulp (pow is the only transcendental)."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import DemoSettings as JaxDemo
from low_precision_raytracer_tpu.config import RenderConfig as JaxConfig
from low_precision_raytracer_tpu.config import get_precision as jax_precision
from low_precision_raytracer_tpu.models.procedural import cornell_box_scene
from low_precision_raytracer_tpu.models.scene import build_scene_arrays, flatten_frame
from low_precision_raytracer_tpu.ops import compose as jcompose
from low_precision_raytracer_tpu.ops.camera import primary_ray_grid as jax_grid
from low_precision_raytracer_tpu.ops.gbuffer import fill_gbuffer as jax_fill_gbuffer
from low_precision_raytracer_tpu.ops.shade import gbuffer_to_shade_input as jax_sin
from low_precision_raytracer_tpu.ops.shade import shade as jax_shade
from low_precision_raytracer_tpu.ops.svgf import preprocess_normal_depth as jax_grad
from low_precision_raytracer_tpu.render.renderer import _di_light_spec
from low_precision_raytracer_tpu.render.renderer import _gi_shade_input as jax_gi_input
from low_precision_raytracer_tpu_torch.config import DemoSettings, RenderConfig
from low_precision_raytracer_tpu_torch.models import scene as tscene
from low_precision_raytracer_tpu_torch.ops import compose as tcompose
from low_precision_raytracer_tpu_torch.ops.camera import primary_ray_grid
from low_precision_raytracer_tpu_torch.ops.gbuffer import interpolate_hit_attributes
from low_precision_raytracer_tpu_torch.ops.shade import gbuffer_to_shade_input, shade
from low_precision_raytracer_tpu_torch.ops.svgf import preprocess_normal_depth
from low_precision_raytracer_tpu_torch.ops.trace import Hit
from low_precision_raytracer_tpu_torch.render.renderer import _gi_shade_input

N = 48
R = N * N


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = jnp.asarray(x)
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _close(port, ref, name, rtol=1e-5, atol=1e-6, all_rtol=None):
    """rtol/atol on every entry, or (with all_rtol) on >= 99.9% of them
    and all_rtol on every entry."""
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape, f"{name}: {port.shape} vs {ref.shape}"
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref), err_msg=f"{name}: NaN")
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(port[ok], ref[ok], rtol=all_rtol or rtol, atol=atol, err_msg=name)
    if all_rtol:
        frac = np.isclose(port[ok], ref[ok], rtol=rtol, atol=atol).mean()
        assert frac >= 0.999, f"{name}: {frac} within rtol {rtol}"


@pytest.fixture(scope="module")
def setup():
    host = cornell_box_scene()
    prec = jax_precision("bf16")
    jcfg = JaxConfig(width=N, height=N, precision="bf16", traversal_impl="dense_pallas")
    scene = build_scene_arrays(host, prec)
    frame = flatten_frame(host, prec, max_direct_lights=4, width=N, height=N)
    scene_np = {k: np.asarray(getattr(scene, k)) for k in tscene.tensor_fields(tscene.SceneArrays)}
    scene_np["n_meshes"] = scene.n_meshes
    frame_np = {k: np.asarray(getattr(frame, k)) for k in tscene.tensor_fields(tscene.FrameInput)}
    frame_np.update(obj_layout=frame.obj_layout, n_lights=frame.n_lights)
    tscn, tfrm = tscene.scene_from_numpy(scene_np, frame_np, "cpu")
    o, d = jax_grid(frame.cam_l2w_f32, frame.cam_fov_y_f32, N, N, jnp.float32)
    o, d = o.reshape(R, 3), d.reshape(R, 3)
    g, hit = jax_fill_gbuffer(scene, frame, o, d, prec, cfg=jcfg,
                              di_lights=_di_light_spec(frame, jcfg))
    thit = Hit(*(torch.from_numpy(np.array(getattr(hit, k))) for k in ("t", "u", "v", "tri", "obj")))
    return dict(prec=prec, jcfg=jcfg, scene=scene, frame=frame, tscene=tscn, tframe=tfrm,
                o=o, d=d, g=g, hit=hit, thit=thit,
                cfg=RenderConfig(width=N, height=N, precision="bf16"))


def test_camera_grid(setup):
    f = setup["frame"]
    oj, dj = jax_grid(f.cam_l2w_f32, f.cam_fov_y_f32, 64, 40, jnp.float32)
    ot, dt = primary_ray_grid(setup["tframe"].cam_l2w_f32, setup["tframe"].cam_fov_y_f32, 64, 40)
    assert np.abs(ot.numpy() - np.asarray(oj)).max() <= 1e-6
    assert np.abs(dt.numpy() - np.asarray(dj)).max() <= 1e-6


def test_gbuffer_attributes_f32(setup):
    """f32 interpolation (shade_f32) from the same hit records."""
    attrs = interpolate_hit_attributes(setup["tscene"], setup["tframe"], setup["thit"], torch.float32)
    valid = setup["thit"].tri >= 0
    g = setup["g"]
    for k in ("position", "normal", "tangent", "color"):
        _close(attrs[k][valid], np.asarray(g[k])[valid.numpy()], k)
    np.testing.assert_array_equal(attrs["material"][valid].numpy(), np.asarray(g["material"])[valid.numpy()])


def _port_gbuffer(s):
    """The port's G-buffer dict from the JAX hit records (as fill_gbuffer
    builds it after its trace)."""
    attrs = interpolate_hit_attributes(s["tscene"], s["tframe"], s["thit"], torch.float32)
    valid = s["thit"].tri >= 0
    vz = valid[:, None]
    g = {k: torch.where(vz, attrs[k], torch.zeros_like(attrs[k]))
         for k in ("position", "normal", "tangent", "color")}
    g.update(valid=valid, obj=torch.where(valid, s["thit"].obj, 0),
             tri=torch.where(valid, s["thit"].tri, 0),
             material=torch.where(valid, attrs["material"], 0))
    return g


def test_shade_rounds(setup):
    """Shade round 0 (GI, injected uniforms) and the bounce round from the
    same bounce hits, plus the bounce-hit attributes in bf16."""
    s = setup
    key = jax.random.PRNGKey(3)
    us = jax.random.uniform(key, (7 * R,), jnp.float32)
    d32 = np.array(s["d"])
    pos32 = np.array(s["o"]) + np.array(s["hit"].t)[:, None] * d32
    out_j = jax_shade(s["scene"], s["frame"], jax_sin(s["g"], position_f32=jnp.asarray(pos32)),
                      view_dir=-s["d"], prec=s["prec"], cfg=s["jcfg"], first_round=True,
                      no_gi=False, key=key)
    sin_t = gbuffer_to_shade_input(_port_gbuffer(s), position_f32=torch.from_numpy(pos32))
    out_t = shade(s["tscene"], s["tframe"], sin_t, view_dir=-torch.from_numpy(d32), cfg=s["cfg"],
                  first_round=True, no_gi=False, uniforms=torch.from_numpy(np.array(us)))
    for k in ("intensity", "albedo", "gi_direction", "gi_multiplier", "source"):
        _close(getattr(out_t, k), getattr(out_j, k), k, all_rtol=2e-4)
    for k in ("valid", "direction", "max_t", "multiplier"):
        _close(getattr(out_t.lights, k), getattr(out_j.lights, k), f"lights.{k}", all_rtol=2e-4)
    np.testing.assert_array_equal(out_t.skip_tri.numpy(), np.asarray(out_j.skip_tri))
    np.testing.assert_array_equal(out_t.gi_valid.numpy(), np.asarray(out_j.gi_valid))

    # bounce hits: the JAX trace from the JAX round-0 rays, fed to both
    from low_precision_raytracer_tpu.ops.trace import trace as jax_trace

    maxt = jnp.where(out_j.gi_valid, 1e5, 0.0)
    hit_j = jax_trace(s["scene"], s["frame"], out_j.source, out_j.gi_direction, prec=s["prec"],
                      cfg=s["jcfg"], skip_tri=out_j.skip_tri, min_dist=1e-2, max_dist=maxt,
                      coherent=False)
    hit_t = Hit(*(torch.from_numpy(np.array(getattr(hit_j, k))) for k in ("t", "u", "v", "tri", "obj")))
    sin1_j = jax_gi_input(s["scene"], s["frame"], out_j, hit_j, s["prec"])
    out0_t = out_t._replace(source=torch.from_numpy(np.array(out_j.source)),
                            gi_direction=torch.from_numpy(np.array(out_j.gi_direction)),
                            gi_valid=torch.from_numpy(np.array(out_j.gi_valid)))
    sin1_t = _gi_shade_input(s["tscene"], s["tframe"], out0_t, hit_t, s["cfg"].prec)
    live = (hit_t.tri >= 0).numpy()
    for k in ("position", "normal", "tangent", "color"):
        a, b = getattr(sin1_t, k), getattr(sin1_j, k)
        assert a.dtype == torch.bfloat16
        _close(_np(a)[live], _np(b)[live], f"bounce {k}", rtol=2.0**-7, atol=2.0**-7)
    for k in ("type", "material", "obj", "tri"):
        np.testing.assert_array_equal(getattr(sin1_t, k).numpy(), np.asarray(getattr(sin1_j, k)))
    _close(sin1_t.position_f32, sin1_j.position_f32, "bounce position_f32")

    # the last round: no GI, lights only, from the same (JAX) bounce input
    out1_j = jax_shade(s["scene"], s["frame"], sin1_j, view_dir=out_j.view_dir_out,
                       prec=s["prec"], cfg=s["jcfg"], first_round=False, no_gi=True, key=key)
    sin1_jt = sin1_t._replace(**{k: torch.from_numpy(_np(getattr(sin1_j, k))).to(torch.bfloat16)
                                 for k in ("position", "normal", "tangent", "color")})
    out1_t = shade(s["tscene"], s["tframe"], sin1_jt,
                   view_dir=torch.from_numpy(np.array(out_j.view_dir_out)), cfg=s["cfg"],
                   first_round=False, no_gi=True)
    for k in ("valid", "direction", "max_t", "multiplier"):
        _close(getattr(out1_t.lights, k), getattr(out1_j.lights, k), f"bounce lights.{k}",
               all_rtol=2e-4)


def test_depth_gradients(setup):
    depth = np.array(setup["g"]["depth"]).reshape(N, N)
    normal = np.array(setup["g"]["normal"]).reshape(N, N, 3)
    np.testing.assert_array_equal(
        preprocess_normal_depth(torch.from_numpy(normal), torch.from_numpy(depth)).numpy(),
        np.asarray(jax_grad(jnp.asarray(normal), jnp.asarray(depth))))


@pytest.mark.parametrize("demo", [dict(), dict(demodulate=True, add_gi_white=False)])
def test_compose(demo):
    rng = np.random.default_rng(5)
    i0, i1, g0, alb = (rng.random((16, 16, 3), dtype=np.float32) * 2 for _ in range(4))
    g0[..., 2] = np.where(rng.random((16, 16)) < 0.7, np.nan, g0[..., 2])
    jd, td = JaxDemo(**demo), DemoSettings(**demo)
    cj = jcompose.write_clean_color(*(jnp.asarray(x) for x in (i0, i1, g0)), jd)
    ct = tcompose.write_clean_color(*(torch.from_numpy(x) for x in (i0, i1, g0)), td)
    for a, b in zip(ct, cj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    col_j = jcompose.add_denoised_color(*cj, jnp.asarray(alb), jd)
    col_t = tcompose.add_denoised_color(*ct, torch.from_numpy(alb), td)
    np.testing.assert_array_equal(col_t.numpy(), np.asarray(col_j))
    img_t = tcompose.tonemap_gamma(col_t).numpy()
    img_j = np.asarray(jcompose.tonemap_gamma(col_j))
    ulp = np.abs(img_t.view(np.int32) - img_j.view(np.int32))
    assert ulp.max() <= 1, f"tonemap differs by {ulp.max()} ulp"


# ---------------------------------------------------------------------------
# Sponza-class modules: the skybox fetch, shade's sky branch, and the
# unfused shadow / GI launches of `_trace_di_gi`.
#
# Bars: the sky fetch and the sky branch rtol/atol 1e-5: the same bf16
# quad texels and bilinear arithmetic in f32, the uv from atan2/asin that
# differ by ~1 ulp between XLA and PyTorch; with the sun disc's texels
# near 60, an ulp of u moves a blend weight by ~1e-5 of a texel step.
# The launches: the bar of tests/test_torch_dense_multi.py (visibility and
# bounce-tri agreement > 99.9%, bounce positions within 2e-3 where the tri
# agrees).

NS = 32
RS = NS * NS


def _jt(x):
    """jnp -> torch (bf16 bit-exact)."""
    return tscene._to_tensor(np.asarray(x), "cpu")


@pytest.fixture(scope="module")
def sky_setup():
    from low_precision_raytracer_tpu.models.procedural import sponza_like_scene

    host = sponza_like_scene(3, 1)
    prec = jax_precision("bf16")
    jcfg = JaxConfig(width=NS, height=NS, precision="bf16", traversal_impl="dense_pallas")
    scene = build_scene_arrays(host, prec)
    frame = flatten_frame(host, prec, max_direct_lights=4, width=NS, height=NS)
    scene_np = {k: np.asarray(getattr(scene, k)) for k in tscene.tensor_fields(tscene.SceneArrays)}
    scene_np.update(n_meshes=scene.n_meshes, sky_valid=scene.sky_valid)
    frame_np = {k: np.asarray(getattr(frame, k)) for k in tscene.tensor_fields(tscene.FrameInput)}
    frame_np.update(obj_layout=frame.obj_layout, n_lights=frame.n_lights,
                    dense_morton=frame.dense_morton)
    tscn, tfrm = tscene.scene_from_numpy(scene_np, frame_np, "cpu")
    o, d = jax_grid(frame.cam_l2w_f32, frame.cam_fov_y_f32, NS, NS, jnp.float32)
    o, d = o.reshape(RS, 3), d.reshape(RS, 3)
    g, hit = jax_fill_gbuffer(scene, frame, o, d, prec, cfg=jcfg)
    pos32 = o + hit.t[:, None] * d
    key = jax.random.PRNGKey(4)
    out_j = jax_shade(scene, frame, jax_sin(g, position_f32=pos32), view_dir=-d, prec=prec,
                      cfg=jcfg, first_round=True, no_gi=False, key=key)
    return dict(prec=prec, jcfg=jcfg, scene=scene, frame=frame, tscene=tscn, tframe=tfrm,
                o=o, d=d, g=g, hit=hit, pos32=pos32, key=key, out_j=out_j,
                cfg=RenderConfig(width=NS, height=NS, precision="bf16"))


def _port_shade_out(out_j):
    """The JAX package's ShadeOutputs as the port's."""
    from low_precision_raytracer_tpu_torch.ops.shade import LightCommands, ShadeOutputs

    lights = LightCommands(*(_jt(x) for x in out_j.lights))
    return ShadeOutputs(**{k: (lights if k == "lights" else _jt(getattr(out_j, k)))
                           for k in ShadeOutputs._fields})


def test_sample_skybox(sky_setup):
    from low_precision_raytracer_tpu.ops.texture import sample_skybox as jax_sky
    from low_precision_raytracer_tpu_torch.ops.texture import sample_skybox

    s = sky_setup
    rng = np.random.default_rng(8)
    dirs = rng.normal(size=(4096, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs[:16] = [0, 0, 1]  # the poles and the seam
    dirs[16:32] = [0, 0, -1]
    dirs[32:48] = [-1, 0, 0]
    _close(sample_skybox(s["tscene"], s["tframe"], torch.from_numpy(dirs)),
           jax_sky(s["scene"], s["frame"], jnp.asarray(dirs)), "sky", rtol=1e-5, atol=1e-5)


def test_shade_sky_branch(sky_setup):
    """Round 0: sky radiance on the pixels no surface covers, along the
    primary direction; a bounce: on SHADE_SKYBOX lanes along -view_dir."""
    from low_precision_raytracer_tpu.ops.shade import SHADE_SKYBOX
    from low_precision_raytracer_tpu.ops.shade import ShadeInput as JaxShadeInput

    s = sky_setup
    out_j = s["out_j"]
    thit = Hit(*(_jt(getattr(s["hit"], k)) for k in ("t", "u", "v", "tri", "obj")))
    s_t = dict(s, thit=thit)
    sin_t = gbuffer_to_shade_input(_port_gbuffer(s_t), position_f32=_jt(s["pos32"]))
    out_t = shade(s["tscene"], s["tframe"], sin_t, view_dir=-_jt(s["d"]), cfg=s["cfg"],
                  first_round=True, no_gi=False, uniforms=_jt(
                      jax.random.uniform(s["key"], (7 * RS,), jnp.float32)))
    sky0 = np.asarray(out_j.di_sky)
    assert (sky0.sum(1) > 0).mean() > 0.2  # the sky shows
    _close(out_t.di_sky, sky0, "di_sky round 0", rtol=1e-5, atol=1e-5)
    # a bounce round whose lanes all escaped to the sky
    rng = np.random.default_rng(2)
    vd = rng.normal(size=(RS, 3)).astype(np.float32)
    types = np.where(rng.random(RS) < 0.7, SHADE_SKYBOX, 0).astype(np.int32)
    sin1 = sin_t._replace(type=torch.from_numpy(types))
    sin1_j = JaxShadeInput(type=jnp.asarray(types), position=s["g"]["position"],
                           normal=s["g"]["normal"], tangent=s["g"]["tangent"],
                           color=s["g"]["color"], uv0=s["g"]["uv0"], uv1=s["g"]["uv1"],
                           material=s["g"]["material"], obj=s["g"]["obj"], tri=s["g"]["tri"],
                           position_f32=s["pos32"])
    out1_j = jax_shade(s["scene"], s["frame"], sin1_j, view_dir=jnp.asarray(vd), prec=s["prec"],
                       cfg=s["jcfg"], first_round=False, no_gi=True, key=s["key"])
    out1_t = shade(s["tscene"], s["tframe"], sin1, view_dir=torch.from_numpy(vd), cfg=s["cfg"],
                   first_round=False, no_gi=True)
    _close(out1_t.di_sky, out1_j.di_sky, "di_sky bounce", rtol=1e-5, atol=1e-5)
    assert (np.asarray(out1_j.di_sky).sum(1) > 0).mean() > 0.6


def test_trace_di_gi_rounds(sky_setup):
    """Round 0 (coherent: shadows unsorted, the GI bounce sorted) and the
    bounce round's shadows (sorted), each from the same JAX shade
    output."""
    from low_precision_raytracer_tpu.render.renderer import _trace_di_gi as jax_di_gi
    from low_precision_raytracer_tpu_torch.render.renderer import _trace_di_gi

    s = sky_setup
    out_j = s["out_j"]
    di_j, sin_j = jax_di_gi(s["scene"], s["frame"], out_j, s["prec"], s["jcfg"],
                            want_gi=True, coherent=True)
    di_t, sin_t = _trace_di_gi(s["tscene"], s["tframe"], _port_shade_out(out_j), s["cfg"],
                               s["cfg"].prec, want_gi=True, coherent=True)
    vis_j, vis_t = np.asarray(di_j).any(-1), di_t.numpy().any(-1)
    assert (vis_j == vis_t).mean() > 0.999
    both = vis_j & vis_t
    np.testing.assert_array_equal(di_t.numpy()[both], np.asarray(di_j)[both])
    assert vis_j.any() and (np.asarray(out_j.lights.valid) & ~vis_j).any()
    tri_j, tri_t = np.asarray(sin_j.tri), sin_t.tri.numpy()
    same = tri_j == tri_t
    assert same.mean() > 0.999
    np.testing.assert_array_equal(sin_t.type.numpy(), np.asarray(sin_j.type))
    _close(sin_t.position_f32[same], np.asarray(sin_j.position_f32)[same], "bounce position",
           rtol=2e-3, atol=2e-3)

    out1_j = jax_shade(s["scene"], s["frame"], sin_j, view_dir=out_j.view_dir_out,
                       prec=s["prec"], cfg=s["jcfg"], first_round=False, no_gi=True, key=s["key"])
    di1_j, none_j = jax_di_gi(s["scene"], s["frame"], out1_j, s["prec"], s["jcfg"],
                              want_gi=False, coherent=False)
    di1_t, none_t = _trace_di_gi(s["tscene"], s["tframe"], _port_shade_out(out1_j), s["cfg"],
                                 s["cfg"].prec, want_gi=False, coherent=False)
    assert none_j is None and none_t is None
    v1j, v1t = np.asarray(di1_j).any(-1), di1_t.numpy().any(-1)
    assert (v1j == v1t).mean() > 0.999 and v1j.any()
