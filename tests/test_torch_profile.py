"""PyTorch port, the per-stage profiler (`render/profile.py`), the three
cases of tests/test_profile.py at 32 x 24 on the CPU: the full 12-stage
schedule with GI and TAA active, TAA absent at mix weight 1 (the renderer
elides it), the GI stages absent without GI.  Every name comes from
`utils/timing.py:STAGE_NAMES` (the JAX package's list, checked equal in
tests/test_torch_host.py), and the profiler runs the port's own schedule:
it would break where `render_frame`'s helpers change."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)

from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene
from low_precision_raytracer_tpu_torch.render.profile import profile_frame
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from low_precision_raytracer_tpu_torch.utils.timing import STAGE_NAMES


def _profile(**kw):
    r = Renderer(cornell_box_scene(), RenderConfig(width=32, height=24, **kw), device="cpu")
    r.render()  # one production frame first, so the temporal state is warm
    state = r.state
    stats = profile_frame(r)
    assert r.state is state and r.frame_index == 1  # the profiler advances nothing
    measured = {k for k in stats if k != "TOTAL (staged)"}
    assert measured <= set(STAGE_NAMES)
    assert all(v >= 0.0 for v in stats.values())
    assert stats["TOTAL (staged)"] == sum(v for k, v in stats.items() if k != "TOTAL (staged)")
    return measured


def test_profile_frame_stage_names_and_values():
    # TAA below mix weight 1 runs: the full 12-stage schedule
    assert _profile(precision="bf16", gi_on=True, taa_mix_weight=0.9) == set(STAGE_NAMES)


def test_profile_frame_taa_elided_at_weight_one():
    assert _profile(precision="bf16", gi_on=True) == set(STAGE_NAMES) - {"TAA"}


def test_profile_frame_no_gi_subset():
    measured = _profile(precision="fp32", gi_on=False)
    assert not measured & {"Trace GI #1", "Shade #2", "Trace DI #2", "Accumulate DI #2"}
