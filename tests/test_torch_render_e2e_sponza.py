"""PyTorch port, whole frames (tests/test_torch_render_e2e.py's bars and
helpers): the Sponza-class frame (`sponza_like_scene(3, 1)`, skybox on:
multi-chunk, unfused shadows, sorted incoherent launches) against the JAX
Renderer, bf16 at 64 x 64 over 4 frames and fp32 (K1b with the f32 band)
at 32 x 32 over 4."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
from low_precision_raytracer_tpu.config import RenderConfig as JaxConfig
from low_precision_raytracer_tpu.config import SVGFConfig as JaxSVGF
from low_precision_raytracer_tpu.models.procedural import sponza_like_scene as jax_sponza
from low_precision_raytracer_tpu.models.scene import flatten_frame
from low_precision_raytracer_tpu.ops.trace import di_fusible as jax_di_fusible
from low_precision_raytracer_tpu.ops.trace import incoherent_reorders as jax_reorders
from low_precision_raytracer_tpu.render.renderer import Renderer as JaxRenderer
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models.procedural import sponza_like_scene
from low_precision_raytracer_tpu_torch.ops.trace import (
    _wavefront_route,
    di_fusible,
    incoherent_reorders,
)
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_render_e2e import N, _jax_pallas_cfg, _run_both


def test_sponza_frame_matches_jax():
    """The Sponza-class route: no fused shadow phase, incoherent launches
    sorted, sky radiance in both rounds."""
    jr = JaxRenderer(jax_sponza(3, 1), JaxConfig(
        width=N, height=N, precision="bf16", traversal_impl="dense_pallas",
        svgf=JaxSVGF(wavelet_impl="pallas")))
    tr = Renderer(sponza_like_scene(3, 1), RenderConfig(width=N, height=N, precision="bf16"),
                  device="cpu")
    f0 = flatten_frame(jr.host, jr.prec, max_direct_lights=4, width=N, height=N)
    assert not jax_di_fusible(jr.scene, f0, jr.cfg, jr.prec)
    assert jax_reorders(jr.scene, f0, jr.cfg, jr.prec)
    assert not di_fusible(tr.frame, tr.cfg)
    assert incoherent_reorders(tr.frame, tr.cfg, tr.cfg.prec)
    assert tr.scene.sky_valid
    ct = _run_both(jr, tr, 4)
    assert int(ct.max()) == 3



def test_sponza_frame_matches_jax_fp32():
    """The fp32 Sponza-class route: K1b with the f32 band, the incoherent
    launches on the sorted K1b."""
    n = 32
    jr = JaxRenderer(jax_sponza(3, 1), _jax_pallas_cfg(width=n, height=n, precision="fp32"))
    tr = Renderer(sponza_like_scene(3, 1), RenderConfig(width=n, height=n, precision="fp32"),
                  device="cpu")
    assert not _wavefront_route(tr.frame, tr.cfg, tr.cfg.prec)
    assert incoherent_reorders(tr.frame, tr.cfg, tr.cfg.prec)
    ct = _run_both(jr, tr, 4, n)
    assert int(ct.max()) == 3
