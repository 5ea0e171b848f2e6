"""PyTorch port, the TAA half and the interactive path: the TAA half of the
temporal maps and its history fetch against the JAX
`generate_temporal_maps(want_taa=True)` on the same G-buffer, state and
random bits; `temporal_anti_aliasing` against the JAX function in f32 and
bf16; `taa_force_full` at mix weight 1 bitwise equal to the elided path;
and the animated Cornell box with a moving camera at `taa_mix_weight=0.3`
against the JAX `Renderer` (dense Pallas trace and Pallas SVGF in
interpret mode), fp32 and bf16, the port fed the JAX package's uniforms
and TAA bits.

Tolerances: the temporal maps' counts and anchors are held bit for bit,
their weights bit for bit in bf16 and to two f32 ulps of the footprint's
coordinate in fp32 (XLA rounds the 4x4 reprojection product through
FMAs); the finished TAA history fetch to rtol 1e-6 / atol 1e-6 in f32 (the
weights above, and the JAX package sums the taps as coefficient planes on
its residual fast path and as a reduce on the take path, the port in tap
order); the blend bit for bit in f32 and to one bf16 ulp in bf16 (XLA may
keep the blend's intermediate products in f32); whole frames >= 35 dB."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.models.hierarchy import Sampler as JaxSampler
from low_precision_raytracer_tpu.models.procedural import animated_cornell_scene as jax_anim
from low_precision_raytracer_tpu.ops.reproject import generate_temporal_maps as jax_maps
from low_precision_raytracer_tpu.ops.taa import temporal_anti_aliasing as jax_taa
from low_precision_raytracer_tpu.render.renderer import Renderer as JaxRenderer
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models.hierarchy import Sampler
from low_precision_raytracer_tpu_torch.models.procedural import (
    animated_cornell_scene,
    cornell_box_scene,
)
from low_precision_raytracer_tpu_torch.ops.taa import temporal_anti_aliasing
from low_precision_raytracer_tpu_torch.render import renderer as trenderer
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_render_e2e import _jax_pallas_cfg, _psnr

N = 32
# two small steps (the K2 fast fetch), then a jump (the plain 2x2 take)
TIMES = (0.0, 1 / 30, 2 / 30, 0.6)
DT = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp32": (torch.float32, jnp.float32)}


def _dolly(scene, sampler_cls):
    """A camera dolly toward the box: 0.06 units a second."""
    cam = scene.active_camera
    t0 = np.asarray(cam.translation, np.float32)
    cam.animation.translation = sampler_cls(
        times=np.array([0.0, 10.0], np.float32),
        values=np.stack([t0, t0 - np.array([0, 0, 0.6], np.float32)]))
    return scene


def _jax_draws(key, cfg):
    """The JAX `Renderer.render` key chain for one frame: -> (next key, the
    GI rounds' uniforms, the TAA bits), as CPU tensors."""
    key, sub = jax.random.split(key)
    gi_rounds = cfg.max_bounces - 1 if cfg.gi_on else 0
    k_taa, k_shade0, *k_rounds = jax.random.split(sub, 2 + max(gi_rounds, 1))
    R = cfg.width * cfg.height
    us = [torch.from_numpy(np.array(jax.random.uniform(k, (7 * R,), jnp.float32)))
          for k in [k_shade0, *k_rounds][:gi_rounds]]
    bits = jax.random.bits(k_taa, (cfg.height, cfg.width), jnp.uint32)
    return key, us, torch.from_numpy(np.array(bits).astype(np.int64)), k_taa


def _capture(precision, monkeypatch):
    """Port frames of the animated, dollying Cornell box at N x N, the
    temporal maps' inputs of each recorded with the JAX key each frame's
    TAA bits come from."""
    calls = []
    orig = trenderer.generate_temporal_maps

    def rec(*args, **kw):
        out = orig(*args, **kw)
        calls.append((args, kw, out))
        return out

    monkeypatch.setattr(trenderer, "generate_temporal_maps", rec)
    tr = Renderer(_dolly(animated_cornell_scene(), Sampler),
                  RenderConfig(width=N, height=N, precision=precision, taa_mix_weight=0.3),
                  device="cpu")
    key, keys = jax.random.PRNGKey(7), []
    for t in TIMES:
        key, us, bits, k_taa = _jax_draws(key, tr.cfg)
        tr.render(time=t, uniforms=us, taa_bits=bits)
        keys.append(k_taa)
    return tr, calls, keys


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_taa_half_matches_jax(precision, monkeypatch):
    tr, calls, keys = _capture(precision, monkeypatch)
    tdt, jdt = DT[precision]
    j = lambda x: jnp.asarray(x.numpy())
    # f32 weights: two f32 ulps of the footprint's coordinate (< W), which
    # the 4x4 reprojection product may round differently (XLA contracts it
    # into FMAs); bf16 weights bit for bit
    w_tol = 0.0 if precision == "bf16" else N * 2.0 ** -22
    branches = set()
    for f, ((g, frame, state, W, H, _dt, pos32, _payload), kw, out) in enumerate(calls):
        svgf_map, _ctr, fast, taa_map, taa_pre = out
        branches.add(fast)
        jg = {k: j(g[k].float() if g[k].dtype == torch.bfloat16 else g[k])
              for k in ("valid", "obj", "position")}
        jg["position"] = jg["position"].astype(jdt)
        jframe = SimpleNamespace(obj_mesh=j(frame.obj_mesh), obj_w2l=j(frame.obj_w2l_f32),
                                 obj_w2l_f32=j(frame.obj_w2l_f32))
        jstate = SimpleNamespace(last_w2c=j(state.last_w2c), last_l2w=j(state.last_l2w),
                                 last_mesh_id=j(state.last_mesh_id),
                                 svgf_frame_count=j(state.svgf_frame_count))
        s_ref, t_ref, _sp, pre_ref = jax_maps(
            jg, jframe, jstate, W, H, jdt, keys[f], taa_payload=j(kw["taa_payload"]),
            n_meshes=tr.scene.n_meshes, position_f32=None if pos32 is None else j(pos32),
            want_taa=True)
        for name, got, ref in (("svgf", svgf_map, s_ref), ("taa", taa_map, t_ref)):
            for k in ("frame_count", "base_y", "base_x"):
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                              err_msg=f"frame {f} {name} {k}")
            np.testing.assert_allclose(got["weights"].float().numpy(),
                                       np.asarray(ref["weights"], np.float32), rtol=0,
                                       atol=w_tol, err_msg=f"frame {f} {name} weights")
            assert got["weights"].dtype == tdt
        if f > 0:  # frame 0 has no history
            assert int(taa_map["frame_count"].sum()) > N * N // 2
        np.testing.assert_allclose(taa_pre.numpy(), np.asarray(pre_ref), rtol=1e-6, atol=1e-6,
                                   err_msg=f"frame {f} TAA history fetch")
    assert branches == {True, False}


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_temporal_anti_aliasing_matches_jax(precision):
    tdt, jdt = DT[precision]
    rng = np.random.default_rng(3)
    color = rng.uniform(0, 2, (N, N, 3)).astype(np.float32)
    hist = rng.uniform(0, 2, (N, N, 3)).astype(np.float32)
    hist[0, :4, 0] = [np.nan, np.inf, -np.inf, np.nan]
    count = (rng.uniform(size=(N, N)) > 0.2).astype(np.int32)
    c_t = torch.from_numpy(color).to(tdt)
    got = temporal_anti_aliasing(c_t, {"frame_count": torch.from_numpy(count)}, 0.3,
                                 torch.from_numpy(hist))
    ref = jax_taa(jnp.asarray(color, jdt), None, {"frame_count": jnp.asarray(count)}, 0.3,
                  hist_pre=jnp.asarray(hist))
    assert got.dtype == tdt and bool(torch.isfinite(got).all())
    g, r = got.float().numpy(), np.asarray(ref, np.float32)
    if precision == "fp32":
        np.testing.assert_array_equal(g, r)
    else:  # one bf16 ulp
        np.testing.assert_array_less(np.abs(g - r), np.abs(r) * 2.0 ** -7 + 1e-30)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_taa_force_full_at_weight_one_is_elided_path(precision):
    """At mix weight 1 the full TAA half (jittered map, history fetch,
    blend) gives the elided path's frames bit for bit."""
    gen = torch.Generator().manual_seed(5)
    draws = [([torch.rand((7 * N * N,), generator=gen)],
              torch.randint(0, 1 << 32, (N, N), generator=gen, dtype=torch.int64))
             for _ in range(3)]
    imgs = {}
    for force in (True, False):
        r = Renderer(cornell_box_scene(), RenderConfig(
            width=N, height=N, precision=precision, taa_force_full=force), device="cpu")
        imgs[force] = [r.render(uniforms=us, taa_bits=bits)[0].numpy() for us, bits in draws]
    for a, b in zip(imgs[True], imgs[False]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_animated_taa_frames_match_jax(precision):
    """The interactive path: animated Cornell, the camera dollying, TAA at
    0.3, N x N over 4 frames; >= 35 dB a frame, validity agreement
    >= 0.999, SVGF frame counts equal where validity agrees; the port's
    history fetch takes the K2 path on the small steps and the plain 2x2
    take on the jump."""
    jr = JaxRenderer(_dolly(jax_anim(), JaxSampler),
                     _jax_pallas_cfg(width=N, height=N, precision=precision,
                                     taa_mix_weight=0.3))
    tr = Renderer(_dolly(animated_cornell_scene(), Sampler),
                  RenderConfig(width=N, height=N, precision=precision, taa_mix_weight=0.3),
                  device="cpu")
    key, fast = jr.key, []
    for f, t in enumerate(TIMES):
        key, us, bits, _k = _jax_draws(key, tr.cfg)
        img_j, aux_j = jr.render(time=t)
        img_t, aux_t = tr.render(time=t, uniforms=us, taa_bits=bits)
        img_j, img_t = np.asarray(img_j), img_t.numpy()
        assert img_t.shape == img_j.shape and np.isfinite(img_t).all()
        p = _psnr(img_t, img_j)
        assert p >= 35.0, f"frame {f}: PSNR {p:.2f} dB"
        agree = np.asarray(aux_j["valid"]) == aux_t["valid"].numpy()
        assert agree.mean() >= 0.999, f"frame {f}: valid agreement {agree.mean()}"
        np.testing.assert_array_equal(tr.state.svgf_frame_count.numpy()[agree],
                                      np.asarray(jr.state.svgf_frame_count)[agree])
        fast.append(aux_t["svgf_fast_path"])
    assert fast == [False, True, True, False]
    assert int(tr.state.svgf_frame_count.max()) >= 2
