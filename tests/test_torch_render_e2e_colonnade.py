"""PyTorch port, whole frames (tests/test_torch_render_e2e.py's bars and
helpers): colonnade-83k (`sponza_like_scene(8, 3)`: the incoherent
launches on the per-ray wavefront) against the JAX Renderer, bf16 at
32 x 32 over 4 frames."""

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
from low_precision_raytracer_tpu_torch.models.scene import instance_tris
from low_precision_raytracer_tpu_torch.ops.trace import _wavefront_route, di_fusible
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_render_e2e import _run_both


def test_colonnade_83k_frame_matches_jax(monkeypatch):
    """colonnade-83k (`sponza_like_scene(8, 3)`: 82,690 instance triangles
    in 647 chunks, skybox) at 32 x 32 over 4 frames: primary and round-0
    shadows on K1b, the GI bounce and round-1 shadows (any hit) on the
    per-ray wavefront, two launches each per frame."""
    from low_precision_raytracer_tpu_torch.ops import trace as ttrace

    calls = []
    for name in ("dense_trace_multi", "dense_trace_multi_sorted", "trace_rays_wavefront"):
        fn = getattr(ttrace, name)
        monkeypatch.setattr(ttrace, name, lambda *a, _n=name, _f=fn, **kw: (
            calls.append((_n, kw.get("find_any", False))) or _f(*a, **kw)))
    n = 32
    jr = JaxRenderer(jax_sponza(8, 3), JaxConfig(
        width=n, height=n, precision="bf16", traversal_impl="dense_pallas",
        svgf=JaxSVGF(wavelet_impl="pallas")))
    tr = Renderer(sponza_like_scene(8, 3), RenderConfig(width=n, height=n, precision="bf16"),
                  device="cpu")
    f0 = flatten_frame(jr.host, jr.prec, max_direct_lights=4, width=n, height=n)
    assert not jax_di_fusible(jr.scene, f0, jr.cfg, jr.prec)
    assert jax_reorders(jr.scene, f0, jr.cfg, jr.prec)
    assert not di_fusible(tr.frame, tr.cfg)
    assert _wavefront_route(tr.frame, tr.cfg, tr.cfg.prec)
    assert instance_tris(tr.frame) == 82690 and tr.frame.dense_chunk_lo.shape[0] == 647
    ct = _run_both(jr, tr, 4, n)
    assert int(ct.max()) == 3
    assert calls == [("dense_trace_multi", False), ("dense_trace_multi", True),
                     ("trace_rays_wavefront", False), ("trace_rays_wavefront", True)] * 4
