"""PyTorch port, K1a: `dense_trace_plain` (through ops/trace.trace) against
the TPU kernel `trace_rays_dense_pallas(..., fallback='mxu3',
di_lights=...)` in interpret mode, on the same Cornell bf16 tables.

Bars (the reference's own for the bf16 mxu3 trace,
tests/test_dense_pallas.py:test_mxu3_matches_fp32_oracle): the TPU kernel
computes u/v/t through a bf16x3 product (~2^-16 relative), the port in
plain f32, so hits agree on > 99.9% of lanes and t/u/v within rtol/atol
2e-3 where they agree; ids are exact where the triangle agrees; the
shadow bits agree on > 99.9% of lanes; dead lanes (maxd <= mind) keep the
exact miss record."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import RenderConfig as JaxConfig
from low_precision_raytracer_tpu.config import get_precision as jax_precision
from low_precision_raytracer_tpu.models.procedural import cornell_box_scene
from low_precision_raytracer_tpu.models.scene import build_scene_arrays, flatten_frame
from low_precision_raytracer_tpu.ops.camera import primary_ray_grid
from low_precision_raytracer_tpu.ops.dense_pallas import trace_rays_dense_pallas
from low_precision_raytracer_tpu.render.renderer import _di_light_spec
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models import scene as tscene
from low_precision_raytracer_tpu_torch.ops.trace import trace

N = 64  # 64 x 64 rays


@pytest.fixture(scope="module")
def cornell():
    host = cornell_box_scene()
    prec = jax_precision("bf16")
    scene = build_scene_arrays(host, prec)
    frame = flatten_frame(host, prec, max_direct_lights=4, width=N, height=N)
    frame_np = {k: np.asarray(getattr(frame, k)) for k in tscene.tensor_fields(tscene.FrameInput)}
    frame_np.update(obj_layout=frame.obj_layout, n_lights=frame.n_lights)
    scene_np = {k: np.asarray(getattr(scene, k)) for k in tscene.tensor_fields(tscene.SceneArrays)}
    scene_np["n_meshes"] = scene.n_meshes
    _, tframe = tscene.scene_from_numpy(scene_np, frame_np, "cpu")
    o, d = primary_ray_grid(frame.cam_l2w_f32, frame.cam_fov_y_f32, N, N, jnp.float32)
    spec = _di_light_spec(frame, JaxConfig(width=N, height=N, precision="bf16"))
    return dict(prec=prec, scene=scene, frame=frame, tframe=tframe, spec=spec,
                o=np.array(o).reshape(-1, 3), d=np.array(d).reshape(-1, 3))


def _both(c, o, d, **kw):
    """-> (jax hit + vis, port hit + vis) as numpy dicts."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    hj, vj = trace_rays_dense_pallas(
        c["scene"], c["frame"], jnp.asarray(o), jnp.asarray(d), prec=c["prec"],
        fallback="mxu3", di_lights=c["spec"], tile_hw=(N, N), interpret=True, **jkw)
    tf = c["tframe"]
    tspec = {k: getattr(tf, k)[: tf.n_lights] for k in ("light_type", "light_pos", "light_dir")}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ht, vt = trace(tf, torch.from_numpy(o), torch.from_numpy(d),
                   cfg=RenderConfig(width=N, height=N, precision="bf16"),
                   prec=RenderConfig(precision="bf16").prec, di_lights=tspec, **tkw)
    j = {k: np.asarray(getattr(hj, k)) for k in ("t", "u", "v", "tri", "obj")}
    t = {k: getattr(ht, k).numpy() for k in ("t", "u", "v", "tri", "obj")}
    j["vis"], t["vis"] = np.asarray(vj), vt.numpy()
    return j, t


def _check(j, t):
    same = j["tri"] == t["tri"]
    assert same.mean() > 0.999, f"tri agreement {same.mean()}"
    np.testing.assert_array_equal(j["obj"][same], t["obj"][same])
    hit = same & (j["tri"] >= 0)
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(t[k][hit], j[k][hit], rtol=2e-3, atol=2e-3, err_msg=k)
    assert (j["vis"] == t["vis"]).mean() > 0.999


def test_primary_launch(cornell):
    """Primary rays, scalar distances: every lane live."""
    j, t = _both(cornell, cornell["o"], cornell["d"])
    _check(j, t)
    assert (t["tri"] >= 0).mean() > 0.99 and t["vis"].any()


def test_gi_like_launch(cornell):
    """Bounce-shaped launch: origins on the primary hits, random
    hemisphere directions, the hit triangle skipped, a quarter of the
    lanes dead (maxd = 0)."""
    j0, _ = _both(cornell, cornell["o"], cornell["d"])
    rng = np.random.default_rng(7)
    R = cornell["o"].shape[0]
    o = (cornell["o"] + j0["t"][:, None] * cornell["d"]).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    # turn back toward the camera side, where most rays leave the open box
    d = np.where(np.sum(d * cornell["d"], axis=1, keepdims=True) > 0, -d, d)
    dead = rng.random(R) < 0.25
    maxd = np.where(dead, 0.0, 1e5).astype(np.float32)
    skip = j0["tri"].astype(np.int32)
    mind = np.full(R, 1e-2, np.float32)
    j, t = _both(cornell, o, d, skip_tri=skip, min_dist=mind, max_dist=maxd)
    _check(j, t)
    for r in (j, t):
        np.testing.assert_array_equal(r["t"][dead], 1e5)
        for k in ("u", "v", "vis"):
            np.testing.assert_array_equal(r[k][dead], 0)
        for k in ("tri", "obj"):
            np.testing.assert_array_equal(r[k][dead], -1)
    assert (t["tri"][~dead] >= 0).mean() > 0.5
