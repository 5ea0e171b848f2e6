"""Per-stage profiling (port of `low_precision_raytracer_tpu/render/profile.py`).

A production frame runs its stages back to back with no sync.  This
harness runs the port's own `render_frame` schedule as separate stages,
calling the same helpers `render/renderer.py` calls, and times each one on
its own: one warm call, then `_TIMED_ITERS` calls between two CUDA events
(the host clock on the CPU).  The result is keyed by the reference's 12
stage names (`utils/timing.py:STAGE_NAMES`).  TAA is absent at mix weight
1 (the renderer elides it), the GI stages without GI.  Stages are pure
(explicit draws), so repeated calls do the same work.  Use it only for
profiling: the syncs between stages serialize what a frame overlaps."""

from __future__ import annotations

import time

import torch

from low_precision_raytracer_tpu_torch.ops.camera import primary_ray_grid
from low_precision_raytracer_tpu_torch.ops.compose import (
    add_denoised_color,
    tonemap_gamma,
    write_clean_color,
)
from low_precision_raytracer_tpu_torch.ops.gbuffer import fill_gbuffer
from low_precision_raytracer_tpu_torch.ops.reproject import generate_temporal_maps
from low_precision_raytracer_tpu_torch.ops.shade import gbuffer_to_shade_input, shade
from low_precision_raytracer_tpu_torch.ops.svgf import preprocess_normal_depth
from low_precision_raytracer_tpu_torch.ops.svgf_kernels import svgf_pair_full
from low_precision_raytracer_tpu_torch.ops.taa import temporal_anti_aliasing
from low_precision_raytracer_tpu_torch.ops.trace import di_fusible, moveforward_eps, trace
from low_precision_raytracer_tpu_torch.render.renderer import (
    _di_from_vis,
    _di_light_spec,
    _gi_shade_input,
    _trace_di,
    _trace_gi_fused_di,
    taa_active,
)
from low_precision_raytracer_tpu_torch.utils.rng import render_generator
from low_precision_raytracer_tpu_torch.utils.timing import STAGE_NAMES, sync

_TIMED_ITERS = 8


def _timed(name, stats, dev, fn, *args):
    """One warm call, then _TIMED_ITERS calls timed as a block: CUDA events
    on the card, the host clock on the CPU.  -> the last call's output;
    stats[name] = seconds per call."""
    out = fn(*args)
    sync(dev)
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(_TIMED_ITERS):
            out = fn(*args)
        end.record()
        end.synchronize()
        stats[name] = start.elapsed_time(end) / 1e3 / _TIMED_ITERS
    else:
        t0 = time.perf_counter()
        for _ in range(_TIMED_ITERS):
            out = fn(*args)
        stats[name] = (time.perf_counter() - t0) / _TIMED_ITERS
    return out


def profile_frame(renderer, time_value: float = 0.0) -> dict[str, float]:
    """-> {stage name: seconds} under the reference's stage names, and
    "TOTAL (staged)", their sum, for one frame of `renderer` at
    `time_value` (its carried state read, not advanced)."""
    cfg = renderer.cfg
    prec = cfg.prec
    dt = prec.dtype
    f32 = torch.float32
    H, W = cfg.height, cfg.width
    R = H * W
    scene = renderer.scene
    state = renderer.state
    frame = renderer._flatten(cfg, time_value)
    dev = renderer.device
    gen = render_generator(1, dev)
    shade_dt = f32 if cfg.shade_f32 else dt
    us0 = torch.rand((7 * R,), generator=gen, dtype=shade_dt, device=dev)
    taa = taa_active(cfg)
    taa_bits = (torch.randint(0, 1 << 32, (H, W), generator=gen, dtype=torch.int64, device=dev)
                if taa else None)
    stats: dict[str, float] = {}
    # the production schedule: on single-chunk scenes the primary and GI
    # launches carry the shadow phase (fused), so the "Trace DI" stages
    # decode visibility only
    fused = di_fusible(frame, cfg)
    di_spec = _di_light_spec(frame, cfg) if fused else None
    o32g, d32g = primary_ray_grid(frame.cam_l2w_f32, frame.cam_fov_y_f32, W, H, f32)
    d32 = d32g.reshape(R, 3)

    def primary():
        return fill_gbuffer(scene, frame, o32g.reshape(R, 3), d32, cfg=cfg, prec=prec,
                            di_lights=di_spec)[0]

    g_flat = _timed("Primary Ray", stats, dev, primary)
    g2d = {k: v.reshape((H, W) + tuple(v.shape[1:])) for k, v in g_flat.items()}
    pos32 = None if prec.is_f32 else o32g + g2d["t"][..., None] * d32g

    def tmaps():
        payload = None
        if cfg.demo.svgf:
            sc, sw = state.svgf_colored, state.svgf_white
            payload = torch.stack([
                sc.color_history[..., 0], sc.color_history[..., 1], sc.color_history[..., 2],
                sw.color_history[..., 0], sw.color_history[..., 1], sw.color_history[..., 2],
                sc.miu1, sw.miu1, sc.miu2, sw.miu2,
            ]).to(f32)
        return generate_temporal_maps(
            g2d, frame, state, W, H, dt, pos32, payload,
            taa_payload=state.taa_history if taa else None, taa_bits=taa_bits)

    svgf_map, svgf_ctr, _fast, taa_map, taa_pre = _timed(
        "Generate Temporal Map", stats, dev, tmaps)

    sin0 = gbuffer_to_shade_input(
        g_flat, position_f32=None if pos32 is None else pos32.reshape(R, 3))
    out0 = _timed("Pixel Shade #1", stats, dev, lambda: shade(
        scene, frame, sin0, view_dir=-d32, cfg=cfg, first_round=True, no_gi=not cfg.gi_on,
        uniforms=us0 if cfg.gi_on else None))

    if fused:
        def di_fn(out, vis):
            return _di_from_vis(vis, out.lights, dt)
        di0 = _timed("Trace DI Ray #1", stats, dev, di_fn, out0, g_flat["di_vis"])
    else:
        # round 0's shadows start at screen-ordered primary hits
        # (coherent), the bounce round's at scattered GI hits
        def di_fn(out, coherent):
            return _trace_di(scene, frame, out.source, out.lights, out.skip_tri, cfg, prec,
                             coherent=coherent)
        di0 = _timed("Trace DI Ray #1", stats, dev, di_fn, out0, True)

    def accumulate(out, di):
        return out.intensity + torch.sum(di, dim=1) + out.di_sky

    intensity0 = _timed("Accumulate DI #1", stats, dev, accumulate, out0, di0)
    intensity1 = torch.zeros((R, 3), dtype=dt, device=dev)

    if cfg.gi_on:
        if fused:
            sin1, vis1 = _timed("Trace GI #1", stats, dev, lambda: _trace_gi_fused_di(
                scene, frame, out0, cfg, prec, di_spec))
        else:
            def gi_trace():
                maxt = torch.where(out0.gi_valid, 1e5, 0.0).to(f32)
                hit = trace(frame, out0.source, out0.gi_direction, cfg=cfg, prec=prec,
                            skip_tri=out0.skip_tri,
                            min_dist=moveforward_eps(frame, cfg, prec, False), max_dist=maxt,
                            coherent=False, scene=scene)
                return _gi_shade_input(scene, frame, out0, hit, prec)
            sin1 = _timed("Trace GI #1", stats, dev, gi_trace)
        out1 = _timed("Shade #2", stats, dev, lambda: shade(
            scene, frame, sin1, view_dir=out0.view_dir_out, cfg=cfg, first_round=False,
            no_gi=True))
        di1 = _timed("Trace DI #2", stats, dev, di_fn, out1, vis1 if fused else False)
        intensity1 = _timed("Accumulate DI #2", stats, dev, accumulate, out1, di1)

    clean, mul_c, mul_w = write_clean_color(
        intensity0.reshape(H, W, 3), intensity1.reshape(H, W, 3),
        out0.gi_multiplier.reshape(H, W, 3), cfg.demo)
    if cfg.demo.svgf:
        def svgf():
            grad = preprocess_normal_depth(g2d["normal"], g2d["depth"])
            return svgf_pair_full(torch.stack([mul_c, mul_w]), svgf_ctr, g2d["depth"], grad,
                                  g2d["normal"], cfg.svgf, cfg.svgf.color_mix_weight,
                                  cfg.svgf.moments_mix_weight)[0]
        out2 = _timed("SVGF", stats, dev, svgf)
        mul_c, mul_w = out2[0].to(mul_c.dtype), out2[1].to(mul_w.dtype)

    color = add_denoised_color(clean, mul_c, mul_w, out0.albedo.reshape(H, W, 3), cfg.demo)
    if taa:
        color = _timed("TAA", stats, dev, lambda: temporal_anti_aliasing(
            color, taa_map, cfg.taa_mix_weight, taa_pre))

    def backup():
        mesh_id = torch.where(g2d["valid"], frame.obj_mesh[g2d["obj"].long()], -1)
        return tonemap_gamma(color), mesh_id.to(torch.int32)

    _timed("Backup Temporal Data", stats, dev, backup)

    # the stage names are the reference's list; a misspelt key here would
    # drift from it silently
    assert set(stats) <= set(STAGE_NAMES), sorted(set(stats) - set(STAGE_NAMES))
    stats["TOTAL (staged)"] = sum(stats.values())
    return stats
