"""PyTorch port, the BVH builders (`models/bvh.py`, `models/native.py`,
`utils/dtypes.py`) against the JAX package's, bit for bit: `build_blas` at
leaf sizes 1, 4 and 8 on the icosphere, the cube and the quad (numpy and
native builds), `build_tlas` over a colonnade's object boxes, `pack_blas`,
`bvh_aabbs_for_dtype` in bf16 and fp16 and `widen_aabb` on adversarial
values (zeros of both signs, subnormals, values past the fp16 range);
the port's native (C++) build equals its numpy build; the scene's BLAS /
TLAS tables equal the JAX package's."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import ml_dtypes
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.models import bvh as jbvh
from low_precision_raytracer_tpu.models.procedural import cube_mesh as jax_cube
from low_precision_raytracer_tpu.models.procedural import icosphere_mesh as jax_icosphere
from low_precision_raytracer_tpu.models.procedural import quad_mesh as jax_quad
from low_precision_raytracer_tpu.models.procedural import sponza_like_scene as jax_sponza
from low_precision_raytracer_tpu.models.scene import build_scene_arrays
from low_precision_raytracer_tpu.models.scene import flatten_frame as jax_flatten
from low_precision_raytracer_tpu.utils.dtypes import widen_aabb as jax_widen
from low_precision_raytracer_tpu_torch.models import bvh as tbvh
from low_precision_raytracer_tpu_torch.models import native
from low_precision_raytracer_tpu_torch.models import scene as tscene
from low_precision_raytracer_tpu_torch.models.procedural import sponza_like_scene
from low_precision_raytracer_tpu_torch.utils import host_build
from low_precision_raytracer_tpu_torch.utils.dtypes import widen_aabb

FIELDS = ("aabb_lo", "aabb_hi", "parent", "lc", "rc", "leaf_offset", "leaf_count", "prim")
MESHES = {"icosphere": lambda: jax_icosphere(3), "cube": lambda: jax_cube(1.0),
          "quad": lambda: jax_quad(2.0)}
DTYPES = {"bf16": (ml_dtypes.bfloat16, torch.bfloat16), "fp16": (np.float16, torch.float16)}


def _bits(x):
    """numpy (ml_dtypes) or torch array -> its raw bits (or values)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.element_size() == 2 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x


def _assert_bvh_equal(a, b, names=FIELDS):
    for k in names:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("leaf_size", [1, 4, 8])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_build_blas_matches_jax(mesh, leaf_size):
    m = MESHES[mesh]()
    ref = jbvh.build_blas(m.positions, m.indices, leaf_size=leaf_size)
    for use_native in (True, False):
        got = tbvh.build_blas(m.positions, m.indices, leaf_size=leaf_size, use_native=use_native)
        _assert_bvh_equal(got, ref)
    assert int(ref.leaf_count.max()) <= leaf_size


@pytest.mark.parametrize("leaf_size", [1, 4])
def test_native_build_equals_numpy_build(leaf_size):
    """Above 64 primitives the C++ builder runs; on random boxes with
    repeated split keys (the stable sort's ties) and a flat axis it equals
    the numpy builder bit for bit."""
    rng = np.random.default_rng(3)
    n = 3000
    lo = rng.standard_normal((n, 3)).astype(np.float32)
    lo[:, 2] = 0.0  # a flat axis
    lo[::7] = lo[3]  # repeated keys
    hi = lo + np.abs(rng.standard_normal((n, 3))).astype(np.float32)
    a = tbvh.build_bvh(lo, hi, lo, leaf_size=leaf_size, use_native=True)
    b = tbvh.build_bvh(lo, hi, lo, leaf_size=leaf_size, use_native=False)
    _assert_bvh_equal(a, b)
    if leaf_size == 1:
        assert a.n_nodes == 2 * n - 1
    pos = rng.standard_normal((500, 3)).astype(np.float32)
    idx = rng.integers(0, 500, (2000, 3)).astype(np.int32)
    for x, y in zip(tbvh.triangle_aabbs(pos, idx, use_native=True),
                    tbvh.triangle_aabbs(pos, idx, use_native=False)):
        np.testing.assert_array_equal(x, y)
    assert native.get_library() is native.get_library()


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that fails raises with its output; nothing falls back."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(host_build, "BUILD", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="bvh_builder.cpp"):
        native.get_library()


def test_build_tlas_and_pack_blas_match_jax():
    host = jax_sponza(3, 1)
    jf = jax_flatten(host, "bf16", max_direct_lights=4, width=8, height=8)
    lo, hi = np.asarray(jf.obj_aabb_lo), np.asarray(jf.obj_aabb_hi)
    _assert_bvh_equal(tbvh.build_tlas(lo, hi), jbvh.build_tlas(lo, hi))
    meshes = host.meshes
    t_off = np.cumsum([0] + [m.n_triangles for m in meshes]).astype(np.int32)
    ref = jbvh.pack_blas([jbvh.build_blas(m.positions, m.indices, 4) for m in meshes], t_off[:-1])
    got = tbvh.pack_blas([tbvh.build_blas(m.positions, m.indices, 4) for m in meshes], t_off[:-1])
    _assert_bvh_equal(got, ref, FIELDS + ("root",))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bvh_aabbs_for_dtype_match_jax(dtype):
    jd, td = DTYPES[dtype]
    m = jax_icosphere(3)
    b = jbvh.build_blas(m.positions, m.indices, leaf_size=4)
    j_lo, j_hi = jbvh.bvh_aabbs_for_dtype(b.aabb_lo, b.aabb_hi, jd)
    t_lo, t_hi = tbvh.bvh_aabbs_for_dtype(b.aabb_lo, b.aabb_hi, td)
    np.testing.assert_array_equal(_bits(t_lo), _bits(j_lo))
    np.testing.assert_array_equal(_bits(t_hi), _bits(j_hi))
    assert (t_lo.float().numpy() <= b.aabb_lo).all() and (t_hi.float().numpy() >= b.aabb_hi).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_widen_aabb_matches_jax(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4000, 3)) * rng.choice([1e-8, 1e-3, 1.0, 1e3, 1e5], (4000, 3)))
    x = x.astype(np.float32)
    x[:4] = 0.0
    x[4:8] = -0.0
    x[8] = [1e-42, -1e-42, 70000.0]
    x[9] = [-70000.0, 65504.0, -65504.0]
    with np.errstate(over="ignore"):
        j_lo, j_hi = jax_widen(x, x, jd)
    t_lo, t_hi = widen_aabb(x, x, td)
    np.testing.assert_array_equal(_bits(t_lo), _bits(j_lo))
    np.testing.assert_array_equal(_bits(t_hi), _bits(j_hi))
    assert t_lo.dtype == t_hi.dtype == td


def test_scene_bvh_tables_match_jax():
    """The scene build's BLAS (the JAX package's default leaf size, LEAF_SIZE)
    and the frame's TLAS, bf16, equal the JAX package's tables bit for bit;
    off the walk's route neither is built."""
    js = build_scene_arrays(jax_sponza(3, 1), "bf16")
    ts = tscene.build_scene_arrays(sponza_like_scene(3, 1), "bf16", "cpu", walk=True)
    assert ts.leaf_size == js.leaf_size == tbvh.LEAF_SIZE
    for k in tscene.WALK_SCENE_FIELDS:
        np.testing.assert_array_equal(_bits(getattr(ts, k)), _bits(getattr(js, k)), err_msg=k)
    jf = jax_flatten(jax_sponza(3, 1), "bf16", max_direct_lights=4, width=8, height=8)
    tf = tscene.flatten_frame(sponza_like_scene(3, 1), "bf16", "cpu", width=8, height=8,
                              walk=True)
    for k in ("obj_w2l",) + tscene.TLAS_FIELDS:
        np.testing.assert_array_equal(_bits(getattr(tf, k)), _bits(getattr(jf, k)), err_msg=k)
    ts = tscene.build_scene_arrays(sponza_like_scene(3, 1), "bf16", "cpu")
    tf = tscene.flatten_frame(sponza_like_scene(3, 1), "bf16", "cpu", width=8, height=8)
    assert all(getattr(ts, k) is None for k in tscene.WALK_SCENE_FIELDS)
    assert all(getattr(tf, k) is None for k in tscene.TLAS_FIELDS)
