"""PyTorch port, host side: the port's own Cornell and Sponza-class builds
equal the JAX package's tables leaf for leaf, bit for bit (morton order,
chunk and leaf AABBs, the quad-packed sky); `scene_from_numpy` carries the JAX
leaves across unchanged; the port imports no JAX; the entry points refuse
what they do not cover and render what they do (the BVH walk and the
all-pairs route among them)."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import get_precision as jax_precision
from low_precision_raytracer_tpu.models.procedural import cornell_box_scene as jax_cornell
from low_precision_raytracer_tpu.models.procedural import sponza_like_scene as jax_sponza
from low_precision_raytracer_tpu.models.scene import build_scene_arrays, flatten_frame
from low_precision_raytracer_tpu_torch.config import RenderConfig, SVGFConfig
from low_precision_raytracer_tpu_torch.models import scene as tscene
from low_precision_raytracer_tpu_torch.models.procedural import (
    _mesh_node,
    cornell_box_scene,
    sponza_like_scene,
)
from low_precision_raytracer_tpu_torch.render.renderer import Renderer

W, H = 64, 48


def _jax_tables(precision, host=None):
    host = jax_cornell() if host is None else host
    prec = jax_precision(precision)
    return (build_scene_arrays(host, prec),
            flatten_frame(host, prec, max_direct_lights=4, width=W, height=H))


def _bits(x):
    """Tensor or array -> numpy, bf16 as its int16 bit pattern."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_tables_equal(s_port, f_port, s_jax, f_jax):
    for cls, port, ref in ((tscene.SceneArrays, s_port, s_jax),
                           (tscene.FrameInput, f_port, f_jax)):
        for name in tscene.tensor_fields(cls):
            a, b = _bits(getattr(port, name)), _bits(getattr(ref, name))
            assert a.dtype == b.dtype, f"{name}: {a.dtype} vs {b.dtype}"
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert s_port.n_meshes == s_jax.n_meshes
    assert s_port.sky_valid == s_jax.sky_valid
    assert f_port.obj_layout == f_jax.obj_layout
    assert f_port.n_lights == f_jax.n_lights
    assert f_port.dense_morton == f_jax.dense_morton


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_host_copy_matches_jax_bitwise(precision):
    """The port's numpy copy of the host code (hierarchy flatten, M
    matrices, dense coefficients, materials) gives bit-identical tables."""
    s_jax, f_jax = _jax_tables(precision)
    host = cornell_box_scene()
    s = tscene.build_scene_arrays(host, precision, "cpu", walk=True)
    f = tscene.flatten_frame(host, precision, "cpu", max_direct_lights=4, width=W, height=H,
                             walk=True)
    _assert_tables_equal(s, f, s_jax, f_jax)
    assert tscene.instance_tris(f) == 34


@pytest.mark.parametrize("args", [(3, 1), (4, 2), (8, 3)],
                         ids=["colonnade-830", "colonnade-5k", "colonnade-83k"])
def test_sponza_tables_match_jax_bitwise(args):
    """Multi-chunk tables: morton-ordered rows, dense_tri / dense_obj, the
    per-chunk AABBs, the quad-packed sky in bf16 and the sky scalars."""
    s_jax, f_jax = _jax_tables("bf16", jax_sponza(*args))
    host = sponza_like_scene(*args)
    s = tscene.build_scene_arrays(host, "bf16", "cpu", walk=True)
    f = tscene.flatten_frame(host, "bf16", "cpu", max_direct_lights=4, width=W, height=H,
                             walk=True)
    _assert_tables_equal(s, f, s_jax, f_jax)
    ti = {(3, 1): 830, (4, 2): 5314, (8, 3): 82690}[args]
    assert tscene.instance_tris(f) == ti and f.dense_chunk_lo.shape == (-(-ti // 128), 3)
    assert f.dense_morton and s.sky_valid and s.sky_quad.dtype == torch.bfloat16


@pytest.mark.parametrize("args", [(4, 2), (8, 3)], ids=["colonnade-5k", "colonnade-83k"])
def test_leaf_aabbs_match_jax_bitwise(args):
    """The packet BVH's per-leaf AABBs (32 rows each, the rows padded to a
    128 multiple, widened, the all-padding leaves parked far away)."""
    _s, f_jax = _jax_tables("bf16", jax_sponza(*args))
    f = tscene.flatten_frame(sponza_like_scene(*args), "bf16", "cpu", max_direct_lights=4,
                             width=W, height=H)
    nc = f.dense_chunk_lo.shape[0]
    assert f.dense_leaf_lo.shape == f.dense_leaf_hi.shape == (4 * nc, 3)
    for name in ("dense_leaf_lo", "dense_leaf_hi"):
        np.testing.assert_array_equal(getattr(f, name).numpy(), np.asarray(getattr(f_jax, name)),
                                      err_msg=name)
    ti = tscene.instance_tris(f)
    assert bool((f.dense_leaf_lo[:-(-ti // 32)] <= f.dense_leaf_hi[:-(-ti // 32)]).all())


def test_coefficient_table_cap(monkeypatch):
    """Above DENSE_COEFF_MAX_TRIS no table is built (as in the JAX package),
    'auto' resolves to the BVH walk, and the scene renders; a route that
    reads the table is refused on such a frame."""
    from low_precision_raytracer_tpu_torch.ops.trace import check_scene, resolve_impl

    monkeypatch.setattr(tscene, "DENSE_COEFF_MAX_TRIS", 100)
    f = tscene.flatten_frame(sponza_like_scene(2, 1), "bf16", "cpu")
    assert tscene.instance_tris(f) > 100
    assert f.dense_n is None and f.dense_chunk_lo is None and not f.dense_morton
    cfg = RenderConfig(width=8, height=8, precision="bf16")
    assert resolve_impl(f, cfg) == "jax"
    r = Renderer(sponza_like_scene(2, 1), cfg, device="cpu")
    assert r.cfg.traversal_impl == "jax" and r.frame.dense_n is None
    img, _aux = r.render()
    assert tuple(img.shape) == (8, 8, 3) and bool(torch.isfinite(img).all())
    with pytest.raises(ValueError, match="coefficient table"):
        check_scene(f, RenderConfig(width=8, height=8, precision="bf16", traversal_impl="pallas"))


def test_scene_from_numpy_carries_jax_leaves():
    s_jax, f_jax = _jax_tables("bf16")
    scene_np = {k: np.asarray(getattr(s_jax, k)) for k in tscene.tensor_fields(tscene.SceneArrays)}
    scene_np["n_meshes"] = s_jax.n_meshes
    frame_np = {k: np.asarray(getattr(f_jax, k)) for k in tscene.tensor_fields(tscene.FrameInput)}
    frame_np.update(obj_layout=f_jax.obj_layout, n_lights=f_jax.n_lights,
                    dense_morton=f_jax.dense_morton)
    scene_np["sky_valid"] = s_jax.sky_valid
    s, f = tscene.scene_from_numpy(scene_np, frame_np, "cpu")
    _assert_tables_equal(s, f, s_jax, f_jax)
    assert s.tri_attr.dtype == torch.bfloat16 and f.dense_e.dtype == torch.float32


def test_port_imports_no_jax():
    """Importing every module of the port (and chip_smoke.py) loads
    neither jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import low_precision_raytracer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('low_precision_raytracer_tpu.')\n"
        "       or m == 'low_precision_raytracer_tpu']\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_renderer_without_cuda_raises(monkeypatch):
    """No device given and no card: the entry point raises instead of
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RenderConfig(width=8, height=8, precision="bf16")
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(cornell_box_scene(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(cornell_box_scene(), cfg, device="cuda")
    assert Renderer(cornell_box_scene(), cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw", [
    dict(shade_f32=False),
    dict(svgf=SVGFConfig(strides=(1, 2, 4, 8, 32))),
    dict(svgf=SVGFConfig(sigma_n=127.5)),
    dict(svgf=SVGFConfig(state_f32=False)),
    dict(mesh=object()),
])
def test_uncovered_configs_raise(kw):
    """The options the port once refused (ROADMAP queue 1 item 9) construct
    and render a finite frame; a device mesh (multiple GPUs, item 10) is
    still refused, naming its item."""
    cfg = RenderConfig(width=8, height=8, **{"precision": "bf16", **kw})
    if "mesh" in kw:
        with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1 item 10\)"):
            Renderer(cornell_box_scene(), cfg, device="cpu")
        return
    img, _aux = Renderer(cornell_box_scene(), cfg, device="cpu").render()
    assert tuple(img.shape) == (8, 8, 3) and bool(torch.isfinite(img).all())


@pytest.mark.parametrize("impl", ["jax", "dense"])
def test_walk_and_all_pairs_configs_render(impl):
    """traversal_impl='jax' (the BVH walk) and 'dense' (the all-pairs
    route) construct and render."""
    cfg = RenderConfig(width=8, height=8, precision="bf16", traversal_impl=impl)
    r = Renderer(cornell_box_scene(), cfg, device="cpu")
    assert r.cfg.traversal_impl == impl
    img, _aux = r.render()
    assert tuple(img.shape) == (8, 8, 3) and bool(torch.isfinite(img).all())
    with pytest.raises(ValueError, match="traversal_impl"):
        RenderConfig(traversal_impl="xla")


def test_animated_scene_and_taa_construct():
    """An animated scene and TAA below mix weight 1 (the interactive path)
    are covered: the Renderer constructs on the CPU and renders a frame."""
    from low_precision_raytracer_tpu_torch.models.procedural import animated_cornell_scene

    for kw in (dict(taa_mix_weight=0.3), dict(taa_force_full=True)):
        r = Renderer(animated_cornell_scene(),
                     RenderConfig(width=8, height=8, precision="bf16", **kw), device="cpu")
        img, _aux = r.render(time=0.5)
        assert tuple(img.shape) == (8, 8, 3) and bool(torch.isfinite(img).all())


@pytest.mark.parametrize("precision,fallback,impl,widened", [
    ("bf16", "both", "auto", True),
    ("fp16", "dtype", "pallas", True),
    ("fp32", "dtype", "auto", True),
    ("fp32", "both", "auto", False),
    ("bf16", "mxu3", "pallas", False),
])
def test_widened_band_row_cap(precision, fallback, impl, widened):
    """The widened acceptances (every sub-f32 band, and 'dtype') are no
    longer capped at 8,192 instance triangles: K1b and K6 walk their trees
    under them, over boxes grown by the band's reach (ops/band_pad.py).
    colonnade-8k (8,302, just above the old cap) is accepted under each
    form on the route the JAX package takes (the dense route under 'auto',
    the packet BVH under 'pallas'), as are fp32 'both' and 'mxu3'; the
    table carries the band rows exactly where a sub-f32 form reads them."""
    from low_precision_raytracer_tpu_torch.ops.dense_trace import table_cols
    from low_precision_raytracer_tpu_torch.ops.trace import acceptance_band, frame_table

    cfg = RenderConfig(width=8, height=8, precision=precision, triangle_fallback=fallback,
                       traversal_impl=impl)
    r = Renderer(sponza_like_scene(5, 2), cfg, device="cpu")
    assert r.frame.dense_n_f32.shape[0] == 8302
    assert r.cfg.traversal_impl == ("dense_pallas" if impl == "auto" else "pallas")
    band = acceptance_band(r.frame, r.cfg, r.cfg.prec)
    assert band.widened == widened
    assert frame_table(r.frame, band).shape[1] == table_cols(band)
    assert table_cols(band) == (12 if precision == "fp32" or fallback == "mxu3" else 28)
    # at colonnade-5k (5,314) too
    assert Renderer(sponza_like_scene(), cfg, device="cpu").frame.dense_n_f32.shape[0] == 5314


def test_uncovered_scenes_raise():
    """A-trous strides above 16 render; a scene that 'auto' sends to
    the BVH walk (above packet_bvh_max_tris), a scene with a texture, a two-chunk scene (130 instance triangles), a skybox,
    di_fuse='off', the per-ray wavefront (K5, here on colonnade-830 with
    its threshold lowered) in both its modes, the morton sort keys and the
    packet BVH (K6, with packet_bvh_min_tris lowered) are covered."""
    cfg = RenderConfig(width=8, height=8, precision="bf16")
    host = cornell_box_scene()
    host.textures = [np.zeros((2, 2, 4), np.uint8)]
    host.texture_srgb = [True]
    img, _aux = Renderer(host, cfg, device="cpu").render()
    assert bool(torch.isfinite(img).all())
    walk = Renderer(sponza_like_scene(3, 1), RenderConfig(
        width=8, height=8, precision="bf16", packet_bvh_min_tris=600,
        packet_bvh_max_tris=700), device="cpu")
    assert walk.cfg.traversal_impl == "jax"
    assert bool(torch.isfinite(walk.render()[0]).all())
    for kw in (dict(packet_bvh_min_tris=600), dict(incoherent_sort="beam"),
               dict(incoherent_sort="origin")):
        img, _aux = Renderer(sponza_like_scene(3, 1), RenderConfig(
            width=8, height=8, precision="bf16", **kw), device="cpu").render()
        assert bool(torch.isfinite(img).all())
    img, _aux = Renderer(sponza_like_scene(3, 1), RenderConfig(
        width=8, height=8, precision="bf16",
        svgf=SVGFConfig(strides=(1, 2, 4, 8, 16, 32))), device="cpu").render()
    assert bool(torch.isfinite(img).all())
    for mode in ("auto", "rounds"):
        img, _aux = Renderer(sponza_like_scene(3, 1), RenderConfig(
            width=8, height=8, precision="bf16", wavefront_min_tris=600, wavefront_mode=mode),
            device="cpu").render()
        assert bool(torch.isfinite(img).all())
    host = cornell_box_scene()
    for i in range(8):  # 34 + 8 x 12 = 130 instance triangles: two chunks
        host.root.add(_mesh_node(host, 1, 0, f"extra{i}", t=[0.1 * i, 0, 0],
                                 s=[0.1, 0.1, 0.1]))
    img, _aux = Renderer(host, cfg, device="cpu").render()
    assert bool(torch.isfinite(img).all())
    img, _aux = Renderer(sponza_like_scene(2, 0), cfg, device="cpu").render()
    assert bool(torch.isfinite(img).all())
    # the unfused route on a single-chunk scene (any-hit shadows on K1b)
    off = RenderConfig(width=8, height=8, precision="bf16", di_fuse="off")
    img, _aux = Renderer(cornell_box_scene(), off, device="cpu").render()
    assert bool(torch.isfinite(img).all())
