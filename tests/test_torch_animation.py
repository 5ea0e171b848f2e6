"""PyTorch port, animation and the per-frame flatten: the keyframe
samplers and `apply_animation` bit for bit against the JAX package (a loop
wrap, a step sampler and a zero-length segment among ten times), the
animated Cornell box's frame tables equal to the JAX package's over 4
animated frames (and to a fresh flatten of the port's, through its
caches), and a frame in which only the camera moves returns the previous
frame's table tensors and rebuilds no per-table cache."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import numpy as np
import pytest

from low_precision_raytracer_tpu.config import get_precision as jax_precision
from low_precision_raytracer_tpu.models.hierarchy import Sampler as JaxSampler
from low_precision_raytracer_tpu.models.procedural import animated_cornell_scene as jax_anim
from low_precision_raytracer_tpu.models.scene import build_scene_arrays as jax_scene_arrays
from low_precision_raytracer_tpu.models.scene import flatten_frame as jax_flatten
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models import scene as tscene
from low_precision_raytracer_tpu_torch.models.hierarchy import Sampler
from low_precision_raytracer_tpu_torch.models.procedural import (
    animated_cornell_scene,
    sponza_like_scene,
)
from low_precision_raytracer_tpu_torch.ops import dense_trace
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_scene import _assert_tables_equal, _bits

W, H = 64, 48
# a loop wrap (>= 4 s, the tall box's loop; >= 2 s, the lamp's), keyframe
# times exactly, the zero-length segment's time
TIMES = (0.0, 0.37, 1.0, 1.5, 2.0, 2.5, 3.3, 4.0, 5.25, 9.7)
ANIM_TIMES = (0.0, 0.37, 1.5, 4.6)


def _extra_samplers(scene, sampler_cls):
    """A step sampler on the short box's scale and a zero-length segment
    (duplicated keyframe time 2.5) on the back wall's translation."""
    scene.root.search("short").animation.scale = sampler_cls(
        times=np.array([0.0, 1.0, 3.0], np.float32),
        values=np.array([[0.55, 0.6, 0.55], [0.5, 0.7, 0.5], [0.6, 0.5, 0.6]], np.float32),
        step=True)
    scene.root.search("back").animation.translation = sampler_cls(
        times=np.array([0.0, 2.5, 2.5, 5.0], np.float32),
        values=np.array([[0, 0, -1], [0, 0.1, -1], [0, -0.1, -1], [0, 0, -1]], np.float32))
    return scene


def test_samplers_and_apply_animation_match_jax():
    port = _extra_samplers(animated_cornell_scene(), Sampler)
    ref = _extra_samplers(jax_anim(), JaxSampler)
    sampled = 0
    for t in TIMES:
        port.root.apply_animation(t)
        ref.root.apply_animation(t)
        for a, b in zip(port.root.walk(), ref.root.walk(), strict=True):
            assert a.name == b.name
            for ch in ("translation", "rotation", "scale"):
                x, y = getattr(a, ch), getattr(b, ch)
                assert x.dtype == y.dtype == np.float32, (t, a.name, ch)
                assert x.tobytes() == y.tobytes(), (t, a.name, ch, x, y)
            for ch in ("translation", "rotation", "scale"):
                sa, sb = getattr(a.animation, ch), getattr(b.animation, ch)
                if sa.times is not None:
                    sampled += 1
                    assert sa.sample(t, None).tobytes() == sb.sample(t, None).tobytes()
            np.testing.assert_array_equal(a.transform_matrix(), b.transform_matrix())
    assert sampled == len(TIMES) * 5  # tall r/t, lamp t, short s, back t


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_animated_frame_tables_match_jax(precision):
    """flatten_frame(time) of the animated Cornell box over 4 frames, the
    port through its per-object and whole-frame caches: every table column
    equal to the JAX package's and to a fresh flatten."""
    port, ref = animated_cornell_scene(), jax_anim()
    s_port = tscene.build_scene_arrays(port, precision, "cpu", walk=True)
    s_ref = jax_scene_arrays(ref, jax_precision(precision))
    prev = None
    for t in ANIM_TIMES:
        f_port = tscene.flatten_frame(port, precision, "cpu", width=W, height=H, time=t,
                                      walk=True)
        f_ref = jax_flatten(ref, jax_precision(precision), time=t, max_direct_lights=4,
                            width=W, height=H)
        _assert_tables_equal(s_port, f_port, s_ref, f_ref)
        fresh = tscene.flatten_frame(animated_cornell_scene(), precision, "cpu", width=W,
                                     height=H, time=t, walk=True)
        for name in tscene.tensor_fields(tscene.FrameInput):
            assert np.array_equal(_bits(getattr(f_port, name)), _bits(getattr(fresh, name)),
                                  equal_nan=True), (t, name)
        if prev is not None:  # the tall box moved: a new table
            assert not np.array_equal(prev.dense_e.numpy(), f_port.dense_e.numpy())
            assert not np.array_equal(prev.light_pos.float().numpy(),
                                      f_port.light_pos.float().numpy())
        prev = f_port


def test_camera_only_frame_reuses_tables():
    """The Sponza-class frame (small) with a camera yaw and dolly: each
    frame after the first returns the first frame's table tensors, and no
    per-table cache (box trees, slice tables, the coefficient table)
    rebuilds; the camera itself moves."""
    host = sponza_like_scene(3, 1)
    cam = host.active_camera
    yaw = np.float32(np.sin(np.radians(4) / 2))
    cam.animation.rotation = Sampler(
        times=np.array([0.0, 1.0], np.float32),
        values=np.array([[0, 0, 0, 1], [0, yaw, 0, np.sqrt(1 - yaw * yaw)]], np.float32))
    cam.animation.translation = Sampler(
        times=np.array([0.0, 1.0], np.float32),
        values=np.stack([cam.translation, cam.translation - np.array([0, 0, 0.6], np.float32)]))
    r = Renderer(host, RenderConfig(width=16, height=16, precision="bf16"), device="cpu")
    r.render(time=0.0)
    f0, builds = r.frame, dense_trace.TABLE_BUILDS
    for f in (1, 2):
        r.render(time=f / 30)
        for name in tscene.tensor_fields(tscene.FrameInput):
            if name.startswith("dense_"):
                assert getattr(r.frame, name) is getattr(f0, name), name
        assert not np.array_equal(r.frame.cam_w2c.numpy(), f0.cam_w2c.numpy())
        assert not np.array_equal(r.frame.cam_l2w_f32.numpy(), f0.cam_l2w_f32.numpy())
    assert dense_trace.TABLE_BUILDS == builds


def test_moved_object_matches_fresh_flatten():
    """An object moved by hand between frames (a new array, then an
    in-place edit of it) invalidates the transform, world-matrix, per-object
    and whole-frame caches: each frame equals a fresh flatten of the moved
    scene, and the stacked object arrays are read-only."""
    host = sponza_like_scene(3, 1)
    tscene.flatten_frame(host, "bf16", "cpu", width=W, height=H, walk=True)
    ball = host.root.search("ball1_1")
    for move in ("assign", "in_place"):
        if move == "assign":
            ball.translation = ball.translation + np.float32(0.25)
        else:
            ball.translation[1] -= np.float32(0.5)
        cached = tscene.flatten_frame(host, "bf16", "cpu", width=W, height=H, walk=True)
        fresh_host = sponza_like_scene(3, 1)
        fresh_host.root.search("ball1_1").translation = ball.translation.copy()
        fresh = tscene.flatten_frame(fresh_host, "bf16", "cpu", width=W, height=H, walk=True)
        for name in tscene.tensor_fields(tscene.FrameInput):
            assert np.array_equal(_bits(getattr(cached, name)), _bits(getattr(fresh, name))), \
                (move, name)
    flat = host.root._stack_cache[1]
    with pytest.raises(ValueError):
        flat[0][0, 0, 0] = 1.0
