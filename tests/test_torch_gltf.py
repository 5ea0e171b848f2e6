"""PyTorch port, the glTF loader (`models/gltf.py`): the port's `load_gltf`
against the JAX package's on every asset in tests/assets/ (the JPEG base
colour of `BoxTexturedJpeg.glb` bit for bit too), on every
`cube_glb` variant, on the cases tests/test_gltf.py writes (tangent
synthesis, a matrix node, STEP and CUBICSPLINE channels, a data-URI and a
percent-encoded buffer, a second file appended) and on the textured
Sponza-class `.glb` of `tools/textured_scene.py`: mesh arrays bit-equal;
materials, textures and sRGB flags equal; lights, cameras, animation
keyframes and the tree equal.  Every malformed file that
tests/test_gltf.py mutates raises the port's own GLTFError.  Then
BoxTextured.gltf renders its checker on the port, and its frames match the
JAX Renderer's at >= 35 dB in bf16 and fp32 (5 frames each); and the
textured Sponza-class albedo plane is equal on the packet route (K6's
plain version) and the dense route."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import base64
import json
import shutil
from dataclasses import fields

import numpy as np
import pytest

from gltf_writer import GLBBuilder, cube_glb
from low_precision_raytracer_tpu.models import hierarchy as jh
from low_precision_raytracer_tpu.models.gltf import load_gltf as jax_load
from low_precision_raytracer_tpu.render.renderer import Renderer as JaxRenderer
from low_precision_raytracer_tpu_torch.config import DemoSettings, RenderConfig
from low_precision_raytracer_tpu_torch.models import hierarchy as th
from low_precision_raytracer_tpu_torch.models.gltf import GLTFError, load_gltf
from low_precision_raytracer_tpu_torch.models.scene import HostScene
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from low_precision_raytracer_tpu_torch.tools.textured_scene import (
    textured_sponza_scene,
    write_textured_sponza,
)
from test_torch_render_e2e import _jax_uniforms
from test_torch_texture import (  # noqa: F401  (sponza_glb: a fixture)
    CAMERA_OFFSET,
    jax_pallas_cfg,
    rig_box,
    run_frames,
    sponza_glb,
)

ASSETS = "tests/assets/"
MESH_ARRAYS = ("positions", "indices", "normals", "tangents", "colors", "uv0", "uv1")


def _same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}: {a.dtype}{a.shape} " \
            f"vs {b.dtype}{b.shape}"
        assert a.tobytes() == b.tobytes(), what
    else:
        assert type(a) is type(b) and a == b, f"{what}: {a!r} vs {b!r}"


def _sampler(a, b, what):
    assert (a.times is None) == (b.times is None), what
    if a.times is not None:
        _same(a.times, b.times, what + ".times")
        _same(a.values, b.values, what + ".values")
    assert a.step == b.step, what


def assert_host_equal(port, ref):
    """Every HostScene field of the port's load equal to the JAX load's."""
    assert len(port.meshes) == len(ref.meshes)
    for i, (a, b) in enumerate(zip(port.meshes, ref.meshes)):
        assert a.name == b.name
        for name in MESH_ARRAYS:
            _same(getattr(a, name), getattr(b, name), f"mesh {i}.{name}")
    assert len(port.materials) == len(ref.materials)
    for i, (a, b) in enumerate(zip(port.materials, ref.materials)):
        assert [f.name for f in fields(a)] == [f.name for f in fields(b)]
        for f in fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"material {i}.{f.name}")
    assert len(port.textures) == len(ref.textures)
    for i, (a, b) in enumerate(zip(port.textures, ref.textures)):
        _same(a, b, f"texture {i}")
    assert port.texture_srgb == ref.texture_srgb
    assert port.animated == ref.animated and port.skybox is None and ref.skybox is None
    nodes_p, nodes_r = list(port.root.walk()), list(ref.root.walk())
    assert len(nodes_p) == len(nodes_r)
    # walk order of each node, by identity (dataclass == compares arrays)
    at_p = {id(n): i for i, n in enumerate(nodes_p)}
    at_r = {id(n): i for i, n in enumerate(nodes_r)}
    for i, (a, b) in enumerate(zip(nodes_p, nodes_r)):
        what = f"node {i} ({b.name})"
        assert type(a).__name__ == type(b).__name__ and a.name == b.name, what
        for ch in ("translation", "rotation", "scale"):
            _same(getattr(a, ch), getattr(b, ch), f"{what}.{ch}")
            _sampler(getattr(a.animation, ch), getattr(b.animation, ch), f"{what} {ch}")
        assert [at_p[id(c)] for c in a.children] == [at_r[id(c)] for c in b.children], what
        assert at_p.get(id(a.parent)) == at_r.get(id(b.parent)), what
        extra = {"MeshObject": ("mesh_id", "material_id", "aabb_lo", "aabb_hi"),
                 "CameraObject": ("fov_y", "aspect_ratio", "z_near", "z_far"),
                 "LightObject": ("light_type", "intensity", "inner_cone_angle",
                                 "outer_cone_angle", "maximum_distance")}
        for name in extra.get(type(b).__name__, ()):
            _same(getattr(a, name), getattr(b, name), f"{what}.{name}")
    if ref.active_camera is None:
        assert port.active_camera is None
    else:
        assert at_p[id(port.active_camera)] == at_r[id(ref.active_camera)]


@pytest.mark.parametrize("asset", ["Box.gltf", "BoxTextured.gltf", "sparse_quad.gltf",
                                   "BoxInterleaved.glb", "BoxTexturedJpeg.glb"])
def test_assets_match_jax(asset):
    assert_host_equal(load_gltf(ASSETS + asset), jax_load(ASSETS + asset))


CUBE_FLAGS = [(t, lt, c, a) for t in (False, True) for lt in (False, True)
              for c in (False, True) for a in (False, True)]


@pytest.mark.parametrize("flags", CUBE_FLAGS, ids=lambda f: "".join(
    name if on else "-" for name, on in zip("tlca", f)))
def test_cube_glb_matches_jax(flags, tmp_path):
    """cube_glb(with_texture, with_light, with_camera, with_animation)."""
    path = str(tmp_path / "cube.glb")
    cube_glb(path, *flags)
    port = load_gltf(path)
    assert_host_equal(port, jax_load(path))
    assert bool(port.textures) == flags[0] and port.animated == flags[3]


def _triangle(b=None):
    b = b or GLBBuilder()
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    mid = b.add_mesh(pos, [0, 1, 2], normals=np.tile([0, 0, 1], (3, 1)).astype(np.float32))
    return b, mid


def _write_case(case, tmp_path):
    """The writer cases of tests/test_gltf.py -> the file's path."""
    from low_precision_raytracer_tpu.math.hostmath import trs_matrix

    b, mid = _triangle()
    glb = str(tmp_path / f"{case}.glb")
    if case == "tangents":
        b.add_node(name="tri", mesh=mid)
    elif case == "matrix":
        q = np.array([0, np.sin(np.pi / 8), 0, np.cos(np.pi / 8)], np.float32)
        b.add_node(mesh=mid, matrix=trs_matrix([1, 2, 3], q, [2, 2, 2]))
        b.add_node(mesh=mid, matrix=trs_matrix([0, 1, 0], q, [1, -2, 1]))  # a mirror
    elif case == "interpolation":
        n = b.add_node(name="stepper", mesh=mid)
        b.add_animation(n, "translation", [0, 1, 2], [[0, 0, 0], [0, 1, 0], [0, 2, 0]],
                        interpolation="STEP")
        n2 = b.add_node(name="spliner")
        cs = [[9, 9, 9], [0, 0, 0], [9, 9, 9], [9, 9, 9], [0, 4, 0], [9, 9, 9]]
        b.add_animation(n2, "translation", [0, 1], cs, interpolation="CUBICSPLINE")
        b.add_animation(n2, "scale", [0, 1], [[1, 1, 1], [2, 2, 2]])
    elif case == "lights":
        for k, kind in enumerate(("point", "directional", "spot")):
            spot = dict(innerConeAngle=0.1, outerConeAngle=0.4) if kind == "spot" else {}
            lt = b.add_light(kind, (1, 0.5, 0.25), 3.0 + k, **spot)
            b.add_node(name=kind, light=lt, translation=(k, 2, 0))
        b.lights[0]["range"] = 7.5
        b.add_node(mesh=mid)
    elif case in ("data_uri", "percent_uri"):
        b.add_node(mesh=mid)
        g = b.gltf_dict()
        if case == "data_uri":
            g["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                      + base64.b64encode(bytes(b.bin)).decode())
        else:
            (tmp_path / "my buf.bin").write_bytes(bytes(b.bin))
            g["buffers"][0]["uri"] = "my%20buf.bin"
        path = tmp_path / f"{case}.gltf"
        path.write_text(json.dumps(g))
        return str(path)
    b.write_glb(glb)
    return glb


@pytest.mark.parametrize("case", ["tangents", "matrix", "interpolation", "lights", "data_uri",
                                  "percent_uri"])
def test_writer_cases_match_jax(case, tmp_path):
    path = _write_case(case, tmp_path)
    port, ref = load_gltf(path), jax_load(path)
    assert_host_equal(port, ref)
    if case == "interpolation":  # the loaded samplers run as the JAX ones do
        for t in (0.3, 0.75, 1.5):
            port.root.apply_animation(t)
            ref.root.apply_animation(t)
            assert_host_equal(port, ref)


def test_second_file_appends(tmp_path):
    """A second load into the same HostScene offsets its material ids."""
    a, b = str(tmp_path / "a.glb"), str(tmp_path / "b.glb")
    cube_glb(a, with_texture=True)
    cube_glb(b, with_texture=True, with_light=False)
    port = load_gltf(b, load_gltf(a))
    ref = jax_load(b, jax_load(a))
    assert_host_equal(port, ref)
    assert len(port.materials) == 3 and len(port.textures) == 2


def test_textured_sponza_glb_matches_jax(tmp_path):
    """The tool's file: four materials, seven PNGs (RGBA and RGB, all five
    row filters), eight atlas entries (one texture is both a base colour and
    a metallic-roughness map), TEXCOORD_1, lights and a camera."""
    path = str(tmp_path / "sponza.glb")
    write_textured_sponza(path, tex_size=64)
    port = load_gltf(path)
    assert_host_equal(port, jax_load(path))
    assert len(port.textures) == 8 and port.texture_srgb == [True, False] * 4
    assert [m.uv_color for m in port.materials] == [0, 0, 0, 0, 1]
    assert np.array_equal(port.textures[2], port.textures[5])  # stone's base = gold's MR


def _malformed(tmp_path):
    base = json.load(open(ASSETS + "BoxTextured.gltf"))
    for f in ("BoxTextured0.bin", "BoxTexturedCheck.png"):
        shutil.copy(ASSETS + f, tmp_path)
    return base


MUTATIONS = {
    "no-buffers": lambda g: g.pop("buffers"),
    "no-accessors": lambda g: g.pop("accessors"),
    "position-accessor": lambda g: g["meshes"][0]["primitives"][0]["attributes"]
    .__setitem__("POSITION", 99),
    "buffer-view": lambda g: g["accessors"][0].__setitem__("bufferView", 42),
    "component-type": lambda g: g["accessors"][1].__setitem__("componentType", 1234),
    "view-offset": lambda g: g["bufferViews"][1].__setitem__("byteOffset", 820),
    "no-nodes": lambda g: g.pop("nodes"),
    "missing-image": lambda g: g["images"][0].__setitem__("uri", "missing.png"),
    "mesh-index": lambda g: g["nodes"][1].__setitem__("mesh", 7),
    "negative-count": lambda g: g["accessors"][0].__setitem__("count", -5),
    "indices-accessor": lambda g: g["meshes"][0]["primitives"][0].__setitem__("indices", 77),
    "node-cycle": lambda g: g["nodes"][1].setdefault("children", []).append(0),
    "bad-png": lambda g: g["images"][0].__setitem__("uri", "bad.png"),
    "not-an-image": lambda g: g["images"][0].__setitem__("uri", "BoxTextured0.bin"),
}


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_malformed_raises_gltferror(mutation, tmp_path):
    """The mutations of tests/test_gltf.py:test_malformed_gltf_raises_typed_errors,
    a node cycle, a PNG with a broken CRC and a buffer that is no image."""
    g = _malformed(tmp_path)
    png = bytearray(open(ASSETS + "BoxTexturedCheck.png", "rb").read())
    png[40] ^= 0xFF
    (tmp_path / "bad.png").write_bytes(bytes(png))
    MUTATIONS[mutation](g)
    p = tmp_path / "m.gltf"
    p.write_text(json.dumps(g))
    with pytest.raises(GLTFError):
        load_gltf(str(p))


def test_bad_extension_and_glb(tmp_path):
    (tmp_path / "scene.obj").write_text("")
    with pytest.raises(GLTFError):
        load_gltf(str(tmp_path / "scene.obj"))
    (tmp_path / "bad.glb").write_bytes(b"glTX" + bytes(16))
    with pytest.raises(GLTFError):
        load_gltf(str(tmp_path / "bad.glb"))


def _box(hier, loader, offset=(0.0, 0.0)):
    return rig_box(loader(ASSETS + "BoxTextured.gltf"), hier, offset)


def test_boxtextured_renders_checker():
    """tests/test_gltf.py:test_khronos_boxtextured_renders_checker on the
    port: the +Z face shows red cells (G << R) and white cells (G ~ R)."""
    cfg = RenderConfig(width=64, height=64, precision="fp32", gi_on=False, taa_on=False,
                       demo=DemoSettings(svgf=False))
    img, aux = Renderer(_box(th, load_gltf), cfg, device="cpu").render()
    img = img.numpy()
    assert np.isfinite(img).all()
    face = img[24:40, 24:40]
    assert aux["valid"].numpy()[24:40, 24:40].all()
    ratio = face[..., 1] / np.maximum(face[..., 0], 1e-6)
    assert ratio.min() < 0.25
    assert ratio.max() > 0.8


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_boxtextured_frames_match_jax(precision):
    """BoxTextured.gltf with the camera and lamp above, the camera moved by
    CAMERA_OFFSET, 64 x 64, GI, SVGF on, 5 frames: the single-chunk route
    (K1a's plain version)."""
    n = 64
    jr = JaxRenderer(_box(jh, jax_load, CAMERA_OFFSET),
                     jax_pallas_cfg(width=n, height=n, precision=precision))
    tr = Renderer(_box(th, load_gltf, CAMERA_OFFSET),
                  RenderConfig(width=n, height=n, precision=precision), device="cpu")
    aux_t, _aux_j = run_frames(jr, tr, [0.0] * 5)
    assert aux_t["valid"].float().mean() > 0.2


def test_boxtextured_centred_camera_diagonal():
    """With the camera exactly on the face's axis, the pixel centres of one
    anti-diagonal aim exactly at the face's diagonal edge.  There the
    port's strict f32 test rejects the ray in both triangles and the JAX
    bf16x3 product splits it (ROADMAP queue 3, "Hits on a quad's
    diagonal"): fp32 validity differs only on that diagonal (r + c = 63),
    on at most 16 of its 64 pixels; off it the albedo agrees to 1e-3 (the
    bf16x3 u, v move the texture's footprint by ~2^-16)."""
    n = 64
    jr = JaxRenderer(_box(jh, jax_load), jax_pallas_cfg(width=n, height=n, precision="fp32"))
    tr = Renderer(_box(th, load_gltf), RenderConfig(width=n, height=n, precision="fp32"),
                  device="cpu")
    _key, us = _jax_uniforms(jr.key, tr.cfg)
    _img_j, aux_j = jr.render()
    _img_t, aux_t = tr.render(uniforms=us)
    vj, vt = np.asarray(aux_j["valid"]), aux_t["valid"].numpy()
    rows, cols = np.nonzero(vj != vt)
    assert 0 < len(rows) <= 16 and np.all(rows + cols == n - 1), list(zip(rows, cols))
    off = np.add.outer(np.arange(n), np.arange(n)) != n - 1
    np.testing.assert_allclose(aux_t["albedo"].numpy()[off], np.asarray(aux_j["albedo"])[off],
                               atol=1e-3)


def test_textured_sponza_routes_agree(sponza_glb):
    """The packet route (K6's plain version) gives the dense route's albedo
    plane on >= 99.9% of pixels; the textures reach the plane (it differs
    from the untextured materials' on most valid pixels)."""
    n = 64
    planes = {}
    for impl in ("auto", "pallas"):
        r = Renderer(textured_sponza_scene(sponza_glb),
                     RenderConfig(width=n, height=n, precision="bf16", traversal_impl=impl),
                     device="cpu")
        _img, aux = r.render()
        planes[impl] = aux["albedo"].numpy()
    assert r.cfg.traversal_impl == "pallas"
    same = np.isclose(planes["auto"], planes["pallas"], rtol=0, atol=1e-6).all(axis=2)
    assert same.mean() >= 0.999, same.mean()
    host = textured_sponza_scene(sponza_glb)
    for m in host.materials:
        m.tex_color = -1
    _img, aux = Renderer(host, RenderConfig(width=n, height=n, precision="bf16"),
                         device="cpu").render()
    valid = aux["valid"].numpy()
    differs = ~np.isclose(aux["albedo"].numpy(), planes["auto"], atol=1e-3).all(axis=2)
    assert differs[valid].mean() > 0.5


def test_loader_imports():
    """The loader and the decoder import no PIL, no jax and nothing of the
    JAX package."""
    import ast

    for mod in ("models/gltf.py", "utils/png.py", "utils/log.py", "ops/texture.py",
                "tools/textured_scene.py"):
        tree = ast.parse(open("low_precision_raytracer_tpu_torch/" + mod).read())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for name in names:
                top = name.split(".")[0]
                assert top not in ("PIL", "jax", "low_precision_raytracer_tpu"), (mod, name)
    assert HostScene().texture_srgb == []
