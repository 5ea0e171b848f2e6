"""PyTorch port, the packet kernel K6 under the sub-f32 error-band
acceptances (`triangle_fallback='both' | 'dtype'`, bf16 and fp16), against
the JAX package: its four launch forms on colonnade-5k (`sponza_like_scene(4,
2)`, 5,314 instance triangles: the incoherent launches morton-sorted)
through both packages' `trace` with `traversal_impl='pallas'`, 16 x 64
primary rays, under each acceptance, at the bars of
tests/test_torch_band.py (which holds K1a and K1b; the two share its
helpers); and an fp16 'both' frame of the packet route against the JAX
`Renderer` (tests/test_torch_render_e2e.py's bars).  In its own file so
that tier-1's `--dist loadfile` spreads the band tests over workers."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import pytest

from low_precision_raytracer_tpu.config import RenderConfig as JaxConfig
from low_precision_raytracer_tpu.config import SVGFConfig as JaxSVGF
from low_precision_raytracer_tpu.models.procedural import sponza_like_scene as jax_sponza
from low_precision_raytracer_tpu.render.renderer import Renderer as JaxRenderer
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models.procedural import sponza_like_scene
from low_precision_raytracer_tpu_torch.ops.dense_trace import packet_band
from low_precision_raytracer_tpu_torch.ops.trace import acceptance_band
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_band import ACC_IDS, ACCS, check_launch_forms, route_case
from test_torch_band_frames import _record_bands
from test_torch_render_e2e import _run_both


@pytest.mark.parametrize("acc", ACCS, ids=ACC_IDS)
def test_packet_launch_forms(acc):
    check_launch_forms(route_case("k6", *acc, w=64))


def test_packet_band_frame_matches_jax(monkeypatch):
    """An fp16 'both' frame of the packet route (K6 in its own band form)
    on colonnade-370 at 8 x 8 over 2 frames."""
    calls = _record_bands(monkeypatch)
    n = 8
    kw = dict(width=n, height=n, precision="fp16", triangle_fallback="both",
              traversal_impl="pallas")
    jr = JaxRenderer(jax_sponza(2, 1), JaxConfig(svgf=JaxSVGF(wavelet_impl="pallas"), **kw))
    tr = Renderer(sponza_like_scene(2, 1), RenderConfig(**kw), device="cpu")
    band = acceptance_band(tr.frame, tr.cfg, tr.cfg.prec)
    assert band == packet_band(tr.cfg.prec, "both")
    _run_both(jr, tr, 2, n)
    # per frame: the primary, round 0's shadows and GI bounce in one launch
    # (no reordering at 370 instance triangles), round 1's shadows
    assert calls == [("packet_trace", band.form)] * 6
