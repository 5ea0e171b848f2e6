"""PyTorch port, whole frames: the port's Renderer against the JAX
Renderer, bf16, GI with max_bounces=2, SVGF on, TAA at mix weight 1, at
64 x 64 — the flagship Cornell frame over 5 frames (frame 5 is the first
whose SVGF moments come from the temporal branch), and the Sponza-class
frame (`sponza_like_scene(3, 1)`, skybox on: multi-chunk, unfused
shadows, sorted incoherent launches) over 4 — and colonnade-83k
(`sponza_like_scene(8, 3)`: incoherent launches on the per-ray wavefront)
at 32 x 32 over 4, and the packet-BVH route (`traversal_impl='pallas'` on
colonnade-5k, the route 'auto' takes above 2^20 instance triangles) at
32 x 32 over 4.  The JAX side runs the TPU route
(dense Pallas trace or the packet BVH kernel, fused Pallas SVGF) in
interpret mode; the port is fed
the JAX package's own GI uniforms, `jax.random.uniform(k_shade0, (7R,))`
from the key splits of `render_frame`.

Bars, every frame: image PSNR >= 35 dB (the bar the ROADMAP set for the
port's frame); the G-buffer validity mask agrees on >= 99.9% of pixels;
the SVGF frame counts are equal where the validity agrees.  The two sides
differ by the trace's bf16x3-vs-f32 u/v/t (~2^-16), bf16 rounding points
in the bounce attributes, and ~1 ulp transcendentals.

fp32 (the default precision; the kernels' f32 'both' acceptance): the
flagship at 64 x 64 over 5 frames and the Sponza-class frame at 32 x 32
over 4, at the same bars.  The golden configs and the other bf16 frame
variants are in tests/test_torch_render_variants.py."""

import jax
import numpy as np

from low_precision_raytracer_tpu.config import RenderConfig as JaxConfig
from low_precision_raytracer_tpu.config import SVGFConfig as JaxSVGF
from low_precision_raytracer_tpu.models.procedural import cornell_box_scene as jax_cornell
from low_precision_raytracer_tpu.models.procedural import sponza_like_scene as jax_sponza
from low_precision_raytracer_tpu.models.scene import flatten_frame
from low_precision_raytracer_tpu.ops.trace import di_fusible as jax_di_fusible
from low_precision_raytracer_tpu.ops.trace import incoherent_reorders as jax_reorders
from low_precision_raytracer_tpu.render.renderer import Renderer as JaxRenderer
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models.procedural import (
    cornell_box_scene,
    sponza_like_scene,
)
from low_precision_raytracer_tpu_torch.models.scene import instance_tris
from low_precision_raytracer_tpu_torch.ops.trace import (
    _wavefront_route,
    di_fusible,
    incoherent_reorders,
)
from low_precision_raytracer_tpu_torch.render.renderer import Renderer

N = 64
FRAMES = 5


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10.0 * np.log10(1.0 / mse))


def _jax_uniforms(key, cfg):
    """The JAX `Renderer.render` key chain for one frame: -> (next key, the
    GI shade rounds' uniforms `render_frame` draws, as CPU tensors)."""
    import torch

    key, sub = jax.random.split(key)
    gi_rounds = cfg.max_bounces - 1 if cfg.gi_on else 0
    _k_taa, k_shade0, *k_rounds = jax.random.split(sub, 2 + max(gi_rounds, 1))
    keys = [k_shade0, *k_rounds][:gi_rounds]
    R = cfg.width * cfg.height
    return key, [torch.from_numpy(np.array(jax.random.uniform(k, (7 * R,), jax.numpy.float32)))
                 for k in keys]


def _run_both(jr, tr, frames, n=N):
    """Render `frames` frames of n x n on both, the port fed the JAX draws;
    hold every frame to the bars.  -> the port's last SVGF frame counts."""
    key = jr.key  # the JAX Renderer's own key chain, replayed for the draws
    R = n * n
    for f in range(frames):
        key, us = _jax_uniforms(key, tr.cfg)
        img_j, aux_j = jr.render()
        img_t, aux_t = tr.render(uniforms=us)
        img_j, img_t = np.asarray(img_j), img_t.numpy()
        assert img_t.shape == img_j.shape and np.isfinite(img_t).all()
        p = _psnr(img_t, img_j)
        assert p >= 35.0, f"frame {f}: PSNR {p:.2f} dB"
        vj, vt = np.asarray(aux_j["valid"]), aux_t["valid"].numpy()
        agree = vj == vt
        assert agree.mean() >= 0.999, f"frame {f}: valid agreement {agree.mean()}"
        cj = np.asarray(jr.state.svgf_frame_count)
        ct = tr.state.svgf_frame_count.numpy()
        np.testing.assert_array_equal(ct[agree], cj[agree], err_msg=f"frame {f}")
        assert int(aux_t["n_rays"]) > R
        # frame 0 has no history; without the denoiser there is no fetch
        assert aux_t["svgf_fast_path"] == ((f > 0) if tr.cfg.demo.svgf else None)
    return ct


def test_flagship_frame_matches_jax():
    jr = JaxRenderer(jax_cornell(), JaxConfig(
        width=N, height=N, precision="bf16", traversal_impl="dense_pallas",
        svgf=JaxSVGF(wavelet_impl="pallas")))
    tr = Renderer(cornell_box_scene(), RenderConfig(width=N, height=N, precision="bf16"),
                  device="cpu")
    ct = _run_both(jr, tr, FRAMES)
    assert int(ct.max()) == FRAMES - 1


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


def _jax_pallas_cfg(**kw):
    return JaxConfig(traversal_impl="dense_pallas", svgf=JaxSVGF(wavelet_impl="pallas"), **kw)


def test_flagship_frame_matches_jax_fp32():
    """The fp32 flagship (K1a with the f32 'both' band and its fused shadow
    phase, the temporal map reprojecting the G-buffer position)."""
    jr = JaxRenderer(jax_cornell(), _jax_pallas_cfg(width=N, height=N, precision="fp32"))
    tr = Renderer(cornell_box_scene(), RenderConfig(width=N, height=N, precision="fp32"),
                  device="cpu")
    ct = _run_both(jr, tr, FRAMES)
    assert int(ct.max()) == FRAMES - 1


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
