"""PyTorch port, whole frames (tests/test_torch_render_e2e.py's bars and
helpers): the packet-BVH route (`traversal_impl='pallas'` on colonnade-5k,
the route 'auto' takes above 2^20 instance triangles) against the JAX
Renderer, bf16 at 32 x 32 over 4 frames."""

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
from low_precision_raytracer_tpu_torch.ops.trace import (
    _wavefront_route,
    di_fusible,
    incoherent_reorders,
)
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_render_e2e import _run_both


def test_packet_frame_matches_jax(monkeypatch):
    """The packet BVH route (K6) on colonnade-5k (`sponza_like_scene()`,
    5,314 instance triangles, skybox) with traversal_impl='pallas' on both
    sides, 32 x 32 over 4 frames: per frame the primary and round-0 shadows
    on the packet walk, the GI bounce and round-1 shadows on the sorted
    packet walk (above 4096 instance triangles, several objects)."""
    from low_precision_raytracer_tpu_torch.ops import trace as ttrace

    calls = []
    for name in ("dense_trace", "dense_trace_multi", "dense_trace_multi_sorted",
                 "trace_rays_wavefront", "packet_trace", "packet_trace_sorted"):
        fn = getattr(ttrace, name)
        monkeypatch.setattr(ttrace, name, lambda *a, _n=name, _f=fn, **kw: (
            calls.append((_n, kw.get("find_any", False))) or _f(*a, **kw)))
    n = 32
    jr = JaxRenderer(jax_sponza(), JaxConfig(
        width=n, height=n, precision="bf16", traversal_impl="pallas",
        svgf=JaxSVGF(wavelet_impl="pallas")))
    tr = Renderer(sponza_like_scene(), RenderConfig(width=n, height=n, precision="bf16",
                                                    traversal_impl="pallas"), device="cpu")
    f0 = flatten_frame(jr.host, jr.prec, max_direct_lights=4, width=n, height=n)
    assert not jax_di_fusible(jr.scene, f0, jr.cfg, jr.prec)
    assert jax_reorders(jr.scene, f0, jr.cfg, jr.prec)
    assert not di_fusible(tr.frame, tr.cfg)
    assert incoherent_reorders(tr.frame, tr.cfg, tr.cfg.prec)
    assert not _wavefront_route(tr.frame, tr.cfg, tr.cfg.prec)
    assert instance_tris(tr.frame) == 5314
    ct = _run_both(jr, tr, 4, n)
    assert int(ct.max()) == 3
    assert calls == [("packet_trace", False), ("packet_trace", True),
                     ("packet_trace_sorted", False), ("packet_trace_sorted", True)] * 4
