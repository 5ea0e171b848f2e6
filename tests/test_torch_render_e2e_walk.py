"""PyTorch port, whole frames on the routes without a kernel of the dense
or packet kind: the two-level BVH walk (`traversal_impl='jax'`,
`ops/traversal.py`) and the all-pairs route (`'dense'`, `ops/dense.py`)
against the JAX Renderer on the same route, with tests/test_torch_render_e2e.py's
bars on every frame (PSNR >= 35 dB, validity agreement >= 0.999, SVGF
frame counts equal where the validity agrees), the port fed the JAX
package's own GI uniforms: Cornell at 48 x 48 in bf16 and fp32 over 2
frames on each route, and colonnade-5k at 16 x 16 under 'auto' with
packet_bvh_min_tris / packet_bvh_max_tris lowered below its 5,314 instance
triangles, so that the port resolves the walk; the JAX reference names
'jax' (its 'auto' off the TPU would take 'dense').  Routes that never
reorder run three launches a frame: the primary, round 0's shadows and GI
bounce as one closest-hit launch, round 1's shadows (any hit).

The JAX frames compile the walk's lax.while_loop, so they render in a
fresh interpreter (`test_torch_traversal.JaxProcess`) while the port
renders here, fed the uniforms of the JAX Renderer's key chain."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import numpy as np
import pytest

from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models.procedural import (
    cornell_box_scene,
    sponza_like_scene,
)
from low_precision_raytracer_tpu_torch.ops.trace import (
    di_fusible,
    incoherent_reorders,
    moveforward_eps,
    resolve_impl,
)
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_traversal import JaxProcess

# name -> (scene, size, frames, precision, the port's cfg kwargs, the JAX route)
CASES = {
    "colonnade-5k-auto-bf16": ("colonnade-5k", 16, 1, "bf16",
                               dict(packet_bvh_min_tris=4000, packet_bvh_max_tris=5000), "jax"),
    "cornell-jax-bf16": ("cornell", 48, 2, "bf16", dict(traversal_impl="jax"), "jax"),
    "cornell-jax-fp32": ("cornell", 48, 2, "fp32", dict(traversal_impl="jax"), "jax"),
    "cornell-dense-bf16": ("cornell", 48, 2, "bf16", dict(traversal_impl="dense"), "dense"),
    "cornell-dense-fp32": ("cornell", 48, 2, "fp32", dict(traversal_impl="dense"), "dense"),
}


def jax_frames(cases):
    """Child process: each case's JAX frames -> {name: [(image, valid,
    svgf counts)] per frame}, numpy."""
    from low_precision_raytracer_tpu.config import RenderConfig as JaxConfig
    from low_precision_raytracer_tpu.models.procedural import cornell_box_scene as jax_cornell
    from low_precision_raytracer_tpu.models.procedural import sponza_like_scene as jax_sponza
    from low_precision_raytracer_tpu.render.renderer import Renderer as JaxRenderer

    out = {}
    for name, (scene, n, frames, precision, _kw, route) in cases.items():
        host = jax_cornell() if scene == "cornell" else jax_sponza()
        jr = JaxRenderer(host, JaxConfig(width=n, height=n, precision=precision,
                                         traversal_impl=route))
        out[name] = []
        for _ in range(frames):
            img, aux = jr.render()
            out[name].append((np.asarray(img), np.asarray(aux["valid"]),
                              np.asarray(jr.state.svgf_frame_count)))
    return out


def _port(name):
    scene, n, _frames, precision, kw, _route = CASES[name]
    host = cornell_box_scene() if scene == "cornell" else sponza_like_scene()
    return Renderer(host, RenderConfig(width=n, height=n, precision=precision, **kw),
                    device="cpu")


class _Frames:
    """The JAX frames, rendering in their own process from module setup on;
    `get()` waits for them once."""

    def __init__(self):
        self._proc = JaxProcess("test_torch_render_e2e_walk", "jax_frames", CASES)
        self._out = None

    def get(self):
        if self._out is None:
            self._out = self._proc.result()
        return self._out


@pytest.fixture(scope="module")
def frames():
    return _Frames()


@pytest.mark.parametrize("name", list(CASES))
def test_walk_route_frames_match_jax(frames, name, monkeypatch):
    from low_precision_raytracer_tpu.utils.rng import render_key
    from low_precision_raytracer_tpu_torch.ops import trace as ttrace
    from test_torch_render_e2e import _jax_uniforms, _psnr

    route = CASES[name][5]
    calls = []
    for fn_name in ("trace_rays", "trace_rays_dense"):
        fn = getattr(ttrace, fn_name)
        monkeypatch.setattr(ttrace, fn_name, lambda *a, _n=fn_name, _f=fn, **kw: (
            calls.append((_n, kw["find_any"])) or _f(*a, **kw)))
    tr = _port(name)
    assert tr.cfg.traversal_impl == route == resolve_impl(tr.frame, tr.cfg)
    assert not di_fusible(tr.frame, tr.cfg)
    assert not incoherent_reorders(tr.frame, tr.cfg, tr.cfg.prec)
    assert moveforward_eps(tr.frame, tr.cfg, tr.cfg.prec, False) == tr.cfg.prec.ray_moveforward_t
    # the JAX Renderer's key chain (threefry off the TPU), replayed here
    key, ports = render_key(0), []
    for _ in range(CASES[name][2]):
        key, us = _jax_uniforms(key, tr.cfg)
        img_t, aux_t = tr.render(uniforms=us)
        ports.append((img_t.numpy(), aux_t["valid"].numpy(), tr.state.svgf_frame_count.numpy()))
    for f, ((img_j, valid_j, count_j), (img_t, valid_t, ct)) in enumerate(
            zip(frames.get()[name], ports)):
        assert img_t.shape == img_j.shape and np.isfinite(img_t).all()
        p = _psnr(img_t, img_j)
        assert p >= 35.0, f"frame {f}: PSNR {p:.2f} dB"
        agree = valid_j == valid_t
        assert agree.mean() >= 0.999, f"frame {f}: valid agreement {agree.mean()}"
        np.testing.assert_array_equal(ct[agree], count_j[agree], err_msg=f"frame {f}")
    want = "trace_rays" if route == "jax" else "trace_rays_dense"
    assert calls == [(want, False), (want, False), (want, True)] * CASES[name][2]
