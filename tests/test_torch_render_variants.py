"""PyTorch port, whole frames beyond the main ones of
tests/test_torch_render_e2e.py (whose helpers they share).

- Golden configs 1, 2, 4 and 5 (fp32, 48 x 48, `tests/golden/*.npy`,
  rendered by the JAX package; config 4 is the animated Cornell box after 4
  animation steps, `render(time=i / 4)`, so it holds the reprojection and
  the SVGF history of moving objects; config 5 has the denoiser off, so its
  1-spp noise must match): the port fed the JAX key chain's uniforms, PSNR
  > 35 dB (tests/test_golden.py's bar).  Config 5 is also fed the JAX camera grid:
  XLA's f32 tan of its half field of view (pi/6) is one ulp above the
  correctly rounded value torch returns (0.57735032 against 0.57735026),
  which moves every ray by an ulp and, with the denoiser off, flips one
  silhouette pixel (34.3 dB); the camera grid is held to JAX at 1e-6 in
  tests/test_torch_modules.py.
- The bf16 flagship's frame variants no other test holds to the JAX
  Renderer (GI off, the denoiser off, TAA off, three bounces) at 32 x 32
  over 2 frames, at tests/test_torch_render_e2e.py's bars."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import os

import jax
import numpy as np
import pytest

from low_precision_raytracer_tpu.config import DemoSettings as JaxDemo
from low_precision_raytracer_tpu.models.procedural import cornell_box_scene as jax_cornell
from low_precision_raytracer_tpu.render.renderer import Renderer as JaxRenderer
from low_precision_raytracer_tpu.utils.rng import render_key
from low_precision_raytracer_tpu_torch.config import DemoSettings, RenderConfig
from low_precision_raytracer_tpu_torch.models.procedural import (
    animated_cornell_scene,
    cornell_box_scene,
    single_mesh_scene,
    sponza_like_scene,
)
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_render_e2e import _jax_pallas_cfg, _jax_uniforms, _psnr, _run_both


GOLDENS = {  # tests/test_golden.py:CONFIGS, the port's side:
    # (scene, cfg, JAX camera?, the frames' times)
    "config1_mesh_direct": (single_mesh_scene, dict(gi_on=False, taa_on=False), False, (0.0,)),
    "config2_cornell_gi": (cornell_box_scene, dict(gi_on=True), False, (0.0,)),
    "config4_animated_svgf": (animated_cornell_scene, dict(gi_on=True), False,
                              (0.0, 0.25, 0.5, 0.75)),
    "config5_sponza_sky": (lambda: sponza_like_scene(2, 1),
                           dict(gi_on=True, demo=DemoSettings(svgf=False), taa_on=False), True,
                           (0.0,)),
}


@pytest.mark.parametrize("name", list(GOLDENS))
def test_golden_config(name, monkeypatch):
    import torch

    from low_precision_raytracer_tpu.ops.camera import primary_ray_grid as jax_ray_grid
    from low_precision_raytracer_tpu_torch.render import renderer as trenderer

    scene_fn, kw, jax_camera, times = GOLDENS[name]
    cfg = RenderConfig(width=48, height=48, precision="fp32", **kw)
    tr = Renderer(scene_fn(), cfg, device="cpu")
    if jax_camera:
        monkeypatch.setattr(trenderer, "primary_ray_grid", lambda m, fov, w, h, dt: tuple(
            torch.from_numpy(np.array(x)) for x in jax_ray_grid(
                m.numpy(), fov.numpy(), w, h, jax.numpy.float32)))
    key = render_key(0)
    for t in times:
        key, us = _jax_uniforms(key, tr.cfg)
        img = tr.render(time=t, uniforms=us)[0].numpy()
    want = np.load(os.path.join(os.path.dirname(__file__), "golden", f"{name}.npy"))
    p = _psnr(img, want)
    assert p > 35.0, f"{name}: PSNR vs golden {p:.2f} dB"


@pytest.mark.parametrize("kw", [
    dict(gi_on=False),
    dict(demo=(DemoSettings(svgf=False), JaxDemo(svgf=False))),
    dict(taa_on=False),
    dict(max_bounces=3),
], ids=["no_gi", "no_svgf", "no_taa", "three_bounces"])
def test_bf16_variants_match_jax(kw):
    """Frame variants of the bf16 flagship no other test holds to the JAX
    Renderer, 32 x 32 over 2 frames."""
    n = 32
    tkw = {k: (v[0] if isinstance(v, tuple) else v) for k, v in kw.items()}
    jkw = {k: (v[1] if isinstance(v, tuple) else v) for k, v in kw.items()}
    jr = JaxRenderer(jax_cornell(), _jax_pallas_cfg(width=n, height=n, precision="bf16", **jkw))
    tr = Renderer(cornell_box_scene(), RenderConfig(width=n, height=n, precision="bf16", **tkw),
                  device="cpu")
    _run_both(jr, tr, 2, n)
