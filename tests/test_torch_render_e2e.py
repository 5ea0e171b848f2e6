"""PyTorch port, whole frames: the port's Renderer against the JAX
Renderer, bf16, GI with max_bounces=2, SVGF on, TAA at mix weight 1 — the
flagship Cornell frame at 64 x 64 over 5 frames (frame 5 is the first
whose SVGF moments come from the temporal branch), in bf16 and in fp32
(the default precision; the kernels' f32 'both' acceptance).  The JAX
side runs the TPU route (dense Pallas trace, fused Pallas SVGF) in
interpret mode; the port is fed the JAX package's own GI uniforms,
`jax.random.uniform(k_shade0, (7R,))` from the key splits of
`render_frame`.

Bars, every frame: image PSNR >= 35 dB (the bar the ROADMAP set for the
port's frame); the G-buffer validity mask agrees on >= 99.9% of pixels;
the SVGF frame counts are equal where the validity agrees.  The two sides
differ by the trace's bf16x3-vs-f32 u/v/t (~2^-16), bf16 rounding points
in the bounce attributes, and ~1 ulp transcendentals.

The other frames, each file small enough for tier-1's `--dist loadfile`
to spread them over its workers: the Sponza-class frame in
tests/test_torch_render_e2e_sponza.py, colonnade-83k (the per-ray
wavefront) in tests/test_torch_render_e2e_colonnade.py, the packet-BVH
route in tests/test_torch_render_e2e_packet.py; the golden configs and the
other bf16 frame variants in tests/test_torch_render_variants.py.  The
helpers here (`_run_both`, `_jax_uniforms`, `_jax_pallas_cfg`) are
shared by them."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import jax
import numpy as np

from low_precision_raytracer_tpu.config import RenderConfig as JaxConfig
from low_precision_raytracer_tpu.config import SVGFConfig as JaxSVGF
from low_precision_raytracer_tpu.models.procedural import cornell_box_scene as jax_cornell
from low_precision_raytracer_tpu.render.renderer import Renderer as JaxRenderer
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene
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
