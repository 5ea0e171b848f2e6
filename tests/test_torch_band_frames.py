"""PyTorch port, whole frames under the sub-f32 error-band acceptances
(`triangle_fallback='both' | 'dtype'`), against the JAX `Renderer` with
the route named and the JAX uniforms fed in, at the bars of
tests/test_torch_render_e2e.py (>= 35 dB, validity >= 0.999, frame counts
equal): the bf16 'both' and fp16 'dtype' flagship (K1a and its fused
shadow phase in the band, the dtype epsilon 0.1 on the secondary launch
and in the shadow phase) at 16 x 16 over 2 frames.  (The fp16 'both'
frame of the packet route is in tests/test_torch_fp16.py.)  In its own
file so that tier-1's `--dist loadfile` spreads it beside
tests/test_torch_band.py and tests/test_torch_fp16.py."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import pytest

from low_precision_raytracer_tpu.models.procedural import cornell_box_scene as jax_cornell
from low_precision_raytracer_tpu.render.renderer import Renderer as JaxRenderer
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene
from low_precision_raytracer_tpu_torch.ops.dense_trace import dense_band
from low_precision_raytracer_tpu_torch.ops.trace import acceptance_band, di_fusible
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_render_e2e import _jax_pallas_cfg, _run_both


def _record_bands(monkeypatch):
    """-> the list the port's trace wrappers append (name, band form) to."""
    from low_precision_raytracer_tpu_torch.ops import trace as ttrace

    calls = []
    for name in ("dense_trace", "dense_trace_multi", "dense_trace_multi_sorted",
                 "trace_rays_wavefront", "packet_trace", "packet_trace_sorted"):
        fn = getattr(ttrace, name)
        monkeypatch.setattr(ttrace, name, lambda *a, _n=name, _f=fn, **kw: (
            calls.append((_n, kw["band"].form if "band" in kw else None)) or _f(*a, **kw)))
    return calls


@pytest.mark.parametrize("precision,fallback", [("bf16", "both"), ("fp16", "dtype")])
def test_flagship_band_frames_match_jax(precision, fallback, monkeypatch):
    calls = _record_bands(monkeypatch)
    n = 16
    jr = JaxRenderer(jax_cornell(), _jax_pallas_cfg(width=n, height=n, precision=precision,
                                                    triangle_fallback=fallback))
    tr = Renderer(cornell_box_scene(), RenderConfig(width=n, height=n, precision=precision,
                                                    triangle_fallback=fallback), device="cpu")
    assert di_fusible(tr.frame, tr.cfg)
    band = acceptance_band(tr.frame, tr.cfg, tr.cfg.prec)
    assert band == dense_band(tr.cfg.prec, fallback)
    _run_both(jr, tr, 2, n)
    assert calls == [("dense_trace", band.form)] * 4
