"""PyTorch port, textures: `ops/texture.py:sample_texture` within 1e-6 of
the JAX function (random uv inside and outside [0, 1], negative uv, several
texture sizes, sRGB and linear, f32 and bf16 uv); the atlas and material
texture fields of `build_scene_arrays` equal to the JAX package's (the
one-texel pad too); textured frames against the JAX Renderer at >= 35 dB
a frame (the animated textured cube at times other than 0, the textured
Sponza-class scene of `tools/textured_scene.py` at 64^2 textures and 48 x
48).

The frame helpers (`run_frames`, `rig_box`) and the `sponza_glb` fixture
are shared with tests/test_torch_gltf.py."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gltf_writer import cube_glb
from low_precision_raytracer_tpu.config import RenderConfig as JaxConfig
from low_precision_raytracer_tpu.config import SVGFConfig as JaxSVGF
from low_precision_raytracer_tpu.config import get_precision as jax_precision
from low_precision_raytracer_tpu.models.gltf import load_gltf as jax_load
from low_precision_raytracer_tpu.models.procedural import procedural_sky as jax_sky
from low_precision_raytracer_tpu.models.scene import Skybox as JaxSkybox
from low_precision_raytracer_tpu.models.scene import build_scene_arrays as jax_scene_arrays
from low_precision_raytracer_tpu.ops.texture import sample_texture as jax_sample
from low_precision_raytracer_tpu.render.renderer import Renderer as JaxRenderer
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models import scene as tscene
from low_precision_raytracer_tpu_torch.models.gltf import load_gltf
from low_precision_raytracer_tpu_torch.ops.texture import has_textures, sample_texture
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from low_precision_raytracer_tpu_torch.tools.textured_scene import (
    textured_sponza_scene,
    write_textured_sponza,
)
from test_torch_render_e2e import _jax_uniforms, _psnr
from test_torch_scene import _bits

ATLAS_FIELDS = ("tex_data", "tex_offset", "tex_width", "tex_height", "tex_srgb",
                "mat_tex_color", "mat_uv_color", "mat_tex_emission", "mat_uv_emission",
                "mat_tex_mr", "mat_uv_mr", "mat_channel_roughness", "mat_channel_metallic")


def run_frames(jr, tr, times, bar=35.0):
    """Render one frame at each time on both Renderers, the port fed the
    JAX draws; hold every frame to `bar` dB and >= 99.9% validity
    agreement.  -> (the port's last aux, the JAX side's)."""
    key = jr.key
    for f, t in enumerate(times):
        key, us = _jax_uniforms(key, tr.cfg)
        img_j, aux_j = jr.render(time=t)
        img_t, aux_t = tr.render(time=t, uniforms=us)
        img_j, img_t = np.asarray(img_j), img_t.numpy()
        assert img_t.shape == img_j.shape and np.isfinite(img_t).all()
        p = _psnr(img_t, img_j)
        assert p >= bar, f"frame {f} (time {t}): PSNR {p:.2f} dB"
        agree = (np.asarray(aux_j["valid"]) == aux_t["valid"].numpy()).mean()
        assert agree >= 0.999, f"frame {f}: valid agreement {agree}"
    return aux_t, aux_j


# the flagship Cornell camera's x / y offset (`models/procedural.py`), which
# keeps pixel centres off the triangle edges
CAMERA_OFFSET = (0.0131, 0.0077)


def rig_box(scene, hier, offset=(0.0, 0.0)):
    """The camera and lamp tests/test_gltf.py gives the Khronos boxes, from
    either package's hierarchy module; `offset` moves the camera in x, y."""
    cam = hier.CameraObject(name="cam", fov_y=np.pi / 3)
    cam.translation = np.array([*offset, 2.0], np.float32)
    scene.root.add(cam)
    scene.active_camera = cam
    lamp = hier.LightObject(name="lamp", light_type=hier.LIGHT_POINT,
                            intensity=np.array([40.0, 40.0, 40.0], np.float32))
    lamp.translation = np.array([0.0, 0.0, 2.5], np.float32)
    scene.root.add(lamp)
    return scene


def jax_pallas_cfg(**kw):
    return JaxConfig(traversal_impl="dense_pallas", svgf=JaxSVGF(wavelet_impl="pallas"), **kw)


@pytest.fixture(scope="module")
def sponza_glb(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("textured") / "sponza64.glb")
    write_textured_sponza(path, tex_size=64)
    return path


def jax_textured_sponza(path):
    scene = jax_load(path)
    scene.skybox = JaxSkybox(data=jax_sky(64, 128), exposure=1.0)
    return scene


def _atlas_scene(sizes, srgb, seed):
    """A one-cube scene whose materials use textures of `sizes`, loaded by
    neither loader: the same host arrays go to both packages."""
    from low_precision_raytracer_tpu.models import materials as jm
    from low_precision_raytracer_tpu.models import procedural as jp
    from low_precision_raytracer_tpu_torch.models import materials as tm
    from low_precision_raytracer_tpu_torch.models import procedural as tp

    rng = np.random.default_rng(seed)
    texs = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for h, w in sizes]
    out = []
    for proc, mats in ((jp, jm), (tp, tm)):
        s = proc.single_mesh_scene(proc.cube_mesh(1.0))
        s.textures = [t.copy() for t in texs]
        s.texture_srgb = list(srgb)
        for k in range(len(texs)):
            s.materials.append(mats.Material(tex_color=k, uv_color=k % 2,
                                             tex_metallic_roughness=len(texs) - 1 - k))
        out.append(s)
    return out


SIZES = {"one-texel": [(1, 1)], "mixed": [(3, 5), (64, 64), (1, 7)],
         "odd": [(17, 9), (2, 2), (33, 1), (8, 31)]}


@pytest.mark.parametrize("uv_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sizes", list(SIZES), ids=list(SIZES))
def test_sample_texture_matches_jax(sizes, uv_dtype):
    """Bilinear, wrap-addressed, sRGB decoded per texel before the blend:
    within 1e-6 of the JAX fetch (its pow may differ from torch's by an
    ulp)."""
    n_tex = len(SIZES[sizes])
    srgb = [k % 2 == 0 for k in range(n_tex)]
    jhost, thost = _atlas_scene(SIZES[sizes], srgb, seed=len(sizes))
    js = jax_scene_arrays(jhost, jax_precision("fp32"))
    ts = tscene.build_scene_arrays(thost, "fp32", "cpu")
    rng = np.random.default_rng(7)
    n = 4096
    uv = (rng.standard_normal((n, 2)) * 2.5).astype(np.float32)
    uv[:64] = rng.uniform(0, 1, (64, 2))  # inside [0, 1] too
    uv[64:80] = np.float32(-1e-7)  # just below 0: the last texel wraps in
    tid = rng.integers(-1, n_tex, n).astype(np.int32)
    if uv_dtype == "bf16":
        j_uv = jnp.asarray(uv, jnp.bfloat16)
        t_uv = torch.from_numpy(np.array(j_uv).view(np.int16)).view(torch.bfloat16)
    else:
        j_uv, t_uv = jnp.asarray(uv), torch.from_numpy(uv)
    ref = np.asarray(jax_sample(js, jnp.asarray(tid), j_uv))
    got = sample_texture(ts, torch.from_numpy(tid), t_uv).numpy()
    assert got.dtype == np.float32 and got.shape == (n, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert has_textures(ts)


def _scenes(kind, sponza_glb, tmp_path):
    from low_precision_raytracer_tpu.models import hierarchy as jh
    from low_precision_raytracer_tpu_torch.models import hierarchy as th

    if kind == "box-textured":
        return (rig_box(jax_load("tests/assets/BoxTextured.gltf"), jh),
                rig_box(load_gltf("tests/assets/BoxTextured.gltf"), th))
    if kind == "one-texel":
        return _atlas_scene([(1, 1)], [True], seed=3)
    if kind == "textured-sponza":
        return jax_textured_sponza(sponza_glb), textured_sponza_scene(sponza_glb)
    path = str(tmp_path / "cube.glb")
    cube_glb(path, with_texture=True, with_animation=True)
    return jax_load(path), load_gltf(path)


@pytest.mark.parametrize("kind", ["box-textured", "one-texel", "textured-sponza", "cube"])
@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_atlas_fields_match_jax(kind, precision, sponza_glb, tmp_path):
    """tex_data / offsets / sizes / sRGB flags and the material texture
    columns equal to the JAX build_scene_arrays, dtypes too; a one-texel
    atlas gets its zero pad row."""
    jhost, thost = _scenes(kind, sponza_glb, tmp_path)
    js = jax_scene_arrays(jhost, jax_precision(precision))
    ts = tscene.build_scene_arrays(thost, precision, "cpu")
    for name in ATLAS_FIELDS:
        a, b = _bits(getattr(ts, name)), _bits(getattr(js, name))
        assert a.dtype == b.dtype, f"{name}: {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert has_textures(ts)
    if kind == "one-texel":
        assert ts.tex_data.shape == (2, 4) and not ts.tex_data[1].any()


def test_animated_textured_cube_frames_match_jax(tmp_path):
    """The textured cube .glb with its translation and rotation channels,
    bf16, 48 x 48, 5 frames at times 0.25 .. 1.75."""
    path = str(tmp_path / "cube.glb")
    cube_glb(path, with_texture=True, with_animation=True)
    n = 48
    jr = JaxRenderer(jax_load(path), jax_pallas_cfg(width=n, height=n, precision="bf16"))
    tr = Renderer(load_gltf(path), RenderConfig(width=n, height=n, precision="bf16"),
                  device="cpu")
    assert tr.host.animated and has_textures(tr.scene)
    aux_t, _aux_j = run_frames(jr, tr, [0.25, 0.6, 1.0, 1.4, 1.75])
    assert aux_t["valid"].float().mean() > 0.05


def test_textured_sponza_frames_match_jax(sponza_glb):
    """The textured Sponza-class scene (64^2 textures, one material on uv
    set 1, a texture shared by base colour and metallic-roughness), bf16,
    48 x 48, 5 frames: K1b's plain version, the sorted incoherent launches,
    textures sampled on both shade rounds."""
    n = 48
    jr = JaxRenderer(jax_textured_sponza(sponza_glb),
                     jax_pallas_cfg(width=n, height=n, precision="bf16"))
    tr = Renderer(textured_sponza_scene(sponza_glb),
                  RenderConfig(width=n, height=n, precision="bf16"), device="cpu")
    assert len(tr.host.textures) == 8 and tr.scene.sky_valid
    run_frames(jr, tr, [0.0] * 5)
