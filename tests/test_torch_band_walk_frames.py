"""PyTorch port, a whole frame under a widened error band above the old
8,192-triangle cap: colonnade-8k (`sponza_like_scene(5, 2)`, 8,302
instance triangles) in bf16 'both' on the dense route, where K1b walks its
chunk tree over boxes grown by the band's reach (`ops/band_pad.py`), against
the JAX `Renderer` with the route named and the JAX uniforms fed in, at the
bars of tests/test_torch_render_e2e.py (>= 35 dB, validity >= 0.999, frame
counts equal), 16 x 16 over 2 frames.  In its own file so that tier-1's
`--dist loadfile` spreads it beside tests/test_torch_band_walk.py."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)

from low_precision_raytracer_tpu.models.procedural import sponza_like_scene as jax_sponza
from low_precision_raytracer_tpu.render.renderer import Renderer as JaxRenderer
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models.procedural import sponza_like_scene
from low_precision_raytracer_tpu_torch.ops.dense_trace import dense_band
from low_precision_raytracer_tpu_torch.ops.trace import acceptance_band, instance_tris
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_band_frames import _record_bands
from test_torch_render_e2e import _jax_pallas_cfg, _run_both


def test_colonnade_8k_band_frames_match_jax(monkeypatch):
    calls = _record_bands(monkeypatch)
    n = 16
    kw = dict(width=n, height=n, precision="bf16", triangle_fallback="both")
    jr = JaxRenderer(jax_sponza(5, 2), _jax_pallas_cfg(**kw))
    tr = Renderer(sponza_like_scene(5, 2), RenderConfig(**kw), device="cpu")
    assert instance_tris(tr.frame) == 8302 and tr.cfg.traversal_impl == "dense_pallas"
    band = acceptance_band(tr.frame, tr.cfg, tr.cfg.prec)
    assert band == dense_band(tr.cfg.prec, "both") and band.widened
    _run_both(jr, tr, 2, n)
    names = {name for name, _form in calls}
    assert names <= {"dense_trace_multi", "dense_trace_multi_sorted"}
    assert {form for _name, form in calls} == {band.form}
