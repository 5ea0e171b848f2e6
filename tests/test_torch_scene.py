"""PyTorch port, host side: the port's own Cornell build equals the JAX
package's tables leaf for leaf, bit for bit; `scene_from_numpy` carries
the JAX leaves across unchanged; the port imports no JAX; the entry points
refuse what they do not cover."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import get_precision as jax_precision
from low_precision_raytracer_tpu.models.procedural import cornell_box_scene as jax_cornell
from low_precision_raytracer_tpu.models.scene import build_scene_arrays, flatten_frame
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models import scene as tscene
from low_precision_raytracer_tpu_torch.models.procedural import _mesh_node, cornell_box_scene
from low_precision_raytracer_tpu_torch.render.renderer import Renderer

W, H = 64, 48


def _jax_tables(precision):
    host = jax_cornell()
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
    assert f_port.obj_layout == f_jax.obj_layout
    assert f_port.n_lights == f_jax.n_lights


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_host_copy_matches_jax_bitwise(precision):
    """The port's numpy copy of the host code (hierarchy flatten, M
    matrices, dense coefficients, materials) gives bit-identical tables."""
    s_jax, f_jax = _jax_tables(precision)
    host = cornell_box_scene()
    s = tscene.build_scene_arrays(host, precision, "cpu")
    f = tscene.flatten_frame(host, precision, "cpu", max_direct_lights=4, width=W, height=H)
    _assert_tables_equal(s, f, s_jax, f_jax)
    assert tscene.instance_tris(f) == 34


def test_scene_from_numpy_carries_jax_leaves():
    s_jax, f_jax = _jax_tables("bf16")
    scene_np = {k: np.asarray(getattr(s_jax, k)) for k in tscene.tensor_fields(tscene.SceneArrays)}
    scene_np["n_meshes"] = s_jax.n_meshes
    frame_np = {k: np.asarray(getattr(f_jax, k)) for k in tscene.tensor_fields(tscene.FrameInput)}
    frame_np.update(obj_layout=f_jax.obj_layout, n_lights=f_jax.n_lights)
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
    dict(precision="fp32"),
    dict(precision="fp16"),
    dict(taa_mix_weight=0.5),
    dict(taa_force_full=True),
    dict(traversal_impl="jax"),
    dict(triangle_fallback="both"),
    dict(di_fuse="off"),
])
def test_uncovered_configs_raise(kw):
    cfg = RenderConfig(width=8, height=8, **{"precision": "bf16", **kw})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Renderer(cornell_box_scene(), cfg, device="cpu")


def test_uncovered_scenes_raise():
    cfg = RenderConfig(width=8, height=8, precision="bf16")
    host = cornell_box_scene()
    host.skybox = object()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Renderer(host, cfg, device="cpu")
    host = cornell_box_scene()
    for i in range(8):  # 34 + 8 x 12 = 130 instance triangles: two chunks
        host.root.add(_mesh_node(host, 1, 0, f"extra{i}", t=[0.1 * i, 0, 0],
                                 s=[0.1, 0.1, 0.1]))
    with pytest.raises(NotImplementedError, match="multi-chunk"):
        Renderer(host, cfg, device="cpu")
