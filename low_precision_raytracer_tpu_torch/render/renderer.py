"""The frame orchestrator (port of `low_precision_raytracer_tpu/render/renderer.py`:
`render_frame`, its shadow/GI launch helpers and the `Renderer` class).

One frame, in order: the f32 camera grid; the primary launch and the
G-buffer; the SVGF temporal map and its packed history fetch (K2); shade
round 0; its shadow and GI launches; shade round 1 and its shadow launch;
the clean / demodulated split; the SVGF pair (K3, then K4 per stride);
compose; the TAA blend; tonemap.  TAA at mix weight 1 is the identity and
is not run (unless `taa_force_full`); below 1 the temporal map gains its
jittered TAA half and the blend runs (plain PyTorch, as the JAX package
runs it in XLA).

`Renderer.render(time)` flattens the host scene at `time` on every call:
the animation (objects, lights, the camera) is sampled, and the
coefficient table is rebuilt only when an object moved
(`models/scene.py:_dense_coefficients`).

Single-chunk scenes with lights (Cornell) take the fused route: the
primary launch carries round 0's shadow phase and the GI launch round 1's
(K1a x 2).  Other scenes take the unfused route (`_trace_di_gi`): on a
multi-chunk, multi-object scene that is four launches, the primary, round
0's shadows (coherent), round 0's GI bounce and round 1's shadows (both
incoherent): on K1b, the last two sorted by `anchor_key` (Sponza-class),
or on the per-ray wavefront (colonnade-83k); on the packet BVH K6, the
last two sorted by `morton_key` (colonnade-2M, above 2^20 instance
triangles).  Routes that never reorder (the BVH walk above 4M instance
triangles, colonnade-8M; the all-pairs route) run round 0's shadows and GI
bounce as one closest-hit launch of L + 1 lanes a pixel: three launches.
Sky radiance (`di_sky`) joins both rounds' intensity.

Under a row mesh (`cfg.mesh`, a `parallel/tiling.py:PixelMesh` of more
than one rank) the frame is one rank's rows: the camera grid's rows, its
pixels' elements of the whole frame's GI uniforms and TAA bits (every
rank draws the whole frame from the same seeded generator, so a shard
sees what the unsharded frame sees), the halo history fetch (no K2), the
sharded SVGF pair (`ops/svgf_kernels.py:svgf_pair_full_sharded`) and one
all-reduce of the ray and halo-miss counts.  Every trace launch takes
only the rank's rays: any contiguous partition of the rays is valid, as
the JAX package's `ops/trace.py` notes.
"""

from __future__ import annotations

import dataclasses
import time as _time

import torch

from low_precision_raytracer_tpu_torch.config import (
    RenderConfig,
    check_supported,
    resolve_device,
)
from low_precision_raytracer_tpu_torch.models.scene import (
    HostScene,
    build_scene_arrays,
    flatten_frame,
)
from low_precision_raytracer_tpu_torch.ops.camera import primary_ray_grid
from low_precision_raytracer_tpu_torch.ops.compose import (
    add_denoised_color,
    tonemap_gamma,
    write_clean_color,
)
from low_precision_raytracer_tpu_torch.ops.gbuffer import (
    fill_gbuffer,
    interpolate_hit_attributes,
)
from low_precision_raytracer_tpu_torch.ops.reproject import generate_temporal_maps
from low_precision_raytracer_tpu_torch.ops.shade import (
    SHADE_COMMON,
    SHADE_INVALID,
    SHADE_SKYBOX,
    ShadeInput,
    gbuffer_to_shade_input,
    shade,
)
from low_precision_raytracer_tpu_torch.ops.svgf import SVGFState, preprocess_normal_depth
from low_precision_raytracer_tpu_torch.ops.svgf_kernels import (
    svgf_pair_full,
    svgf_pair_full_sharded,
)
from low_precision_raytracer_tpu_torch.ops.taa import temporal_anti_aliasing
from low_precision_raytracer_tpu_torch.ops.trace import (
    Hit,
    check_scene,
    di_fusible,
    incoherent_reorders,
    moveforward_eps,
    resolve_cfg,
    trace,
)
from low_precision_raytracer_tpu_torch.parallel.halo import all_reduce_sum
from low_precision_raytracer_tpu_torch.parallel.tiling import active_mesh
from low_precision_raytracer_tpu_torch.render.framestate import (
    FrameState,
    init_frame_state,
)
from low_precision_raytracer_tpu_torch.utils.rng import render_generator


def _trace_di(scene, frame, source, lights, skip_tri, cfg, prec, coherent=True):
    """Any-hit shadow ray per (pixel, light) command; invalid slots get
    max_dist 0 and cost nothing.  -> di_intensity (R, L, 3) in the render
    dtype."""
    R = source.shape[0]
    L = lights.valid.shape[1]
    dt = prec.dtype
    if L == 0:
        return torch.zeros((R, 0, 3), dtype=dt, device=source.device)
    # pixel-major command rows, run lane-major inside trace (lane_k)
    o = source[:, None, :].expand(R, L, 3).reshape(R * L, 3)
    d = lights.direction.reshape(R * L, 3)
    maxt = torch.where(lights.valid, lights.max_t.to(torch.float32), 0.0).reshape(R * L)
    skips = skip_tri[:, None].expand(R, L).reshape(R * L)
    hit = trace(frame, o, d, cfg=cfg, prec=prec, find_any=True, skip_tri=skips,
                min_dist=moveforward_eps(frame, cfg, prec, coherent), max_dist=maxt,
                coherent=coherent, lane_k=L, scene=scene)
    visible = hit.tri.reshape(R, L) < 0
    vis = (visible & lights.valid).to(dt)[..., None]
    return vis * lights.multiplier


def _gi_shade_input(scene, frame, shade_out, hit, prec):
    """Closest GI hit -> next round's ShadeInput (COMMON / SKYBOX /
    INVALID), attributes interpolated in the render dtype."""
    attrs = interpolate_hit_attributes(scene, frame, hit, prec.dtype)
    got = hit.tri >= 0
    stype = torch.where(
        shade_out.gi_valid,
        torch.where(got, SHADE_COMMON, SHADE_SKYBOX),
        SHADE_INVALID,
    ).to(torch.int32)
    # f32 bounce-hit position from the f32 ray-origin chain
    pos32 = shade_out.source + hit.t[:, None] * shade_out.gi_direction.to(torch.float32)
    return ShadeInput(
        type=stype,
        position=attrs["position"],
        position_f32=pos32,
        normal=attrs["normal"],
        tangent=attrs["tangent"],
        color=attrs["color"],
        uv0=attrs["uv0"],
        uv1=attrs["uv1"],
        material=attrs["material"],
        obj=torch.clamp(hit.obj, min=0),
        tri=torch.clamp(hit.tri, min=0),
    )


def _di_light_spec(frame, cfg):
    """The light tensors of the fused shadow phase (the same L every
    shade round uses)."""
    L = min(frame.n_lights, cfg.max_direct_lights)
    return dict(
        light_type=frame.light_type[:L],
        light_pos=frame.light_pos[:L],
        light_dir=frame.light_dir[:L],
    )


def _di_from_vis(vis_bits, lights, dt):
    """Decode the fused launch's visibility bitmask against this round's
    light commands: visible ? multiplier : 0.  -> (R, L, 3)."""
    L = lights.valid.shape[1]
    shifts = torch.arange(L, dtype=torch.int32, device=vis_bits.device)
    bits = (vis_bits[:, None] >> shifts[None, :]) & 1
    ok = (bits > 0) & lights.valid
    return ok.to(dt)[..., None] * lights.multiplier


def _trace_gi_fused_di(scene, frame, shade_out, cfg, prec, di_spec):
    """GI bounce launch carrying the next round's shadow phase.
    -> (gi ShadeInput, vis_bits (R,) i32)."""
    maxt = torch.where(shade_out.gi_valid, 1e5, 0.0).to(torch.float32)
    hit, vis = trace(
        frame, shade_out.source, shade_out.gi_direction, cfg=cfg, prec=prec,
        skip_tri=shade_out.skip_tri, min_dist=moveforward_eps(frame, cfg, prec, False),
        max_dist=maxt, di_lights=di_spec, scene=scene,
    )
    return _gi_shade_input(scene, frame, shade_out, hit, prec), vis


def _trace_di_gi(scene, frame, shade_out, cfg, prec, *, want_gi, coherent):
    """The round's shadow rays and (optionally) its GI bounce, unfused
    route.  -> (di_intensity (R, L, 3), gi ShadeInput | None).

    Where incoherent launches get sorted and this round's shadows are
    coherent (round 0 on a Sponza-class scene), the two run as separate
    launches: the shadows unsorted, the GI bounce sorted.  Otherwise both
    share one closest-hit launch of L + 1 lanes per pixel (visible := no
    hit)."""
    R = shade_out.source.shape[0]
    L = shade_out.lights.valid.shape[1]
    lights = shade_out.lights
    eps = moveforward_eps(frame, cfg, prec, False)
    if not want_gi or L == 0 or (coherent and incoherent_reorders(frame, cfg, prec)):
        di = _trace_di(scene, frame, shade_out.source, lights, shade_out.skip_tri, cfg, prec,
                       coherent=coherent)
        sin_next = None
        if want_gi:
            maxt = torch.where(shade_out.gi_valid, 1e5, 0.0).to(torch.float32)
            hit = trace(frame, shade_out.source, shade_out.gi_direction, cfg=cfg,
                        prec=prec, skip_tri=shade_out.skip_tri, min_dist=eps,
                        max_dist=maxt, coherent=False, scene=scene)
            sin_next = _gi_shade_input(scene, frame, shade_out, hit, prec)
        return di, sin_next

    # pixel-major fused lanes: row i*(L+1)+l = pixel i's l-th shadow ray,
    # row i*(L+1)+L = its GI bounce
    K = L + 1
    o = shade_out.source[:, None, :].expand(R, K, 3).reshape(R * K, 3)
    d = torch.cat([lights.direction, shade_out.gi_direction.to(torch.float32)[:, None, :]],
                  dim=1).reshape(R * K, 3)
    maxt_sh = torch.where(lights.valid, lights.max_t.to(torch.float32), 0.0)
    maxt_gi = torch.where(shade_out.gi_valid, 1e5, 0.0).to(torch.float32)
    maxt = torch.cat([maxt_sh, maxt_gi[:, None]], dim=1).reshape(R * K)
    skips = shade_out.skip_tri[:, None].expand(R, K).reshape(R * K)
    hit = trace(frame, o, d, cfg=cfg, prec=prec, skip_tri=skips, min_dist=eps,
                max_dist=maxt, coherent=False, lane_k=K, scene=scene)
    tri_rk = hit.tri.reshape(R, K)
    vis = ((tri_rk[:, :L] < 0) & lights.valid).to(prec.dtype)[..., None]
    hit_gi = Hit(*(x.reshape(R, K)[:, L] for x in hit))
    return vis * lights.multiplier, _gi_shade_input(scene, frame, shade_out, hit_gi, prec)


def taa_active(cfg: RenderConfig) -> bool:
    """Does the TAA half run?  Not at mix weight exactly 1, where the blend
    is the identity, unless `taa_force_full` asks for it."""
    return cfg.taa_on and (cfg.taa_force_full or float(cfg.taa_mix_weight) != 1.0)


def render_frame(scene, frame, state: FrameState, cfg: RenderConfig,
                 uniforms=None, generator=None, taa_bits=None):
    """One full frame.  -> (image (H, W, 3) f32 gamma-encoded, aux, state).

    `uniforms`: one (7 H W,) tensor per GI shade round in the shade dtype,
    f32 under `shade_f32`, else the render dtype (the JAX package's
    `jax.random.uniform(k_shade, (7R,), dt)`), else drawn from
    `generator`.  `taa_bits`: when the TAA half runs, the (H, W) jitter
    words, int64 in [0, 2^32) (the JAX package's `jax.random.bits(k_taa,
    (H, W), uint32)`), else drawn from `generator` before the uniforms.
    Under a row mesh both are the whole frame's draws and the image, aux
    planes and state are the rank's rows.
    aux["svgf_fast_path"] says whether the history fetch took the K2 path
    (None with the denoiser off); under a mesh aux["halo_misses"] counts
    the anchors of the whole frame that left the halo."""
    check_supported(cfg)
    mesh = active_mesh(cfg.mesh)
    fused = di_fusible(frame, cfg)
    prec = cfg.prec
    dt = prec.dtype
    f32 = torch.float32
    H_img, W = cfg.height, cfg.width
    r0, r1 = (0, H_img) if mesh is None else mesh.rows(H_img)
    H = r1 - r0  # the rows this process renders
    R = H * W
    dev = frame.obj_l2w_f32.device
    # shade rounds that draw GI uniforms: all but the last
    gi_rounds = cfg.max_bounces - 1 if cfg.gi_on else 0
    taa = taa_active(cfg)
    if taa and taa_bits is None:
        taa_bits = torch.randint(0, 1 << 32, (H_img, W), generator=generator,
                                 dtype=torch.int64, device=dev)
    if uniforms is None:
        shade_dt = f32 if cfg.shade_f32 else dt
        uniforms = [torch.rand((7 * H_img * W,), generator=generator, dtype=shade_dt,
                               device=dev) for _ in range(gi_rounds)]
    if len(uniforms) != gi_rounds:
        raise ValueError(f"render_frame: {gi_rounds} GI rounds need as many "
                         f"uniform tensors, got {len(uniforms)}")
    if mesh is not None:  # the rank's pixels of the whole frame's draws
        if taa:
            taa_bits = taa_bits[r0:r1]
        uniforms = [u.reshape(7, H_img * W)[:, r0 * W:r1 * W].reshape(-1) for u in uniforms]

    # ---- primary rays (f32 grid in every mode) + G-buffer, with the
    # round-0 shadow phase fused into the launch on single-chunk scenes
    di_spec = _di_light_spec(frame, cfg) if fused else None
    o32g, d32g = primary_ray_grid(frame.cam_l2w_f32, frame.cam_fov_y_f32, W, H_img, f32)
    if mesh is not None:  # the grid's rows, bit for bit those of the whole grid
        o32g, d32g = o32g[r0:r1], d32g[r0:r1]
    d32 = d32g.reshape(R, 3)
    g_flat, _ = fill_gbuffer(scene, frame, o32g.reshape(R, 3), d32, cfg=cfg,
                             prec=prec, di_lights=di_spec)
    g2d = {k: v.reshape((H, W) + tuple(v.shape[1:])) for k, v in g_flat.items()}
    # f32 hit positions o32 + t d32 anchor the reprojection and round 0's
    # light geometry in low-precision modes; fp32 uses the G-buffer's
    # interpolated position, as the JAX package does
    pos32 = None if prec.is_f32 else o32g + g2d["t"][..., None] * d32g

    # ---- SVGF temporal map + packed history fetch (K2)
    svgf_payload = None
    if cfg.demo.svgf:
        sc, sw = state.svgf_colored, state.svgf_white
        svgf_payload = torch.stack([
            sc.color_history[..., 0], sc.color_history[..., 1], sc.color_history[..., 2],
            sw.color_history[..., 0], sw.color_history[..., 1], sw.color_history[..., 2],
            sc.miu1, sw.miu1, sc.miu2, sw.miu2,
        ]).to(f32)  # the render dtype's zeros on frame 0 under state_f32=False
    svgf_map, svgf_ctr, fast, taa_map, taa_pre = generate_temporal_maps(
        g2d, frame, state, W, H_img, dt, pos32, svgf_payload,
        taa_payload=state.taa_history if taa else None, taa_bits=taa_bits if taa else None,
        mesh=mesh)

    # ---- shade round 0, then the GI launch carrying round 1's shadows
    sin0 = gbuffer_to_shade_input(
        g_flat, position_f32=None if pos32 is None else pos32.reshape(R, 3))
    out0 = shade(scene, frame, sin0, view_dir=-d32, cfg=cfg, first_round=True,
                 no_gi=gi_rounds == 0, uniforms=uniforms[0] if gi_rounds else None)
    sin_next = vis_next = None
    if fused:
        di0 = _di_from_vis(g_flat["di_vis"], out0.lights, dt)
        if gi_rounds >= 1:
            sin_next, vis_next = _trace_gi_fused_di(scene, frame, out0, cfg, prec, di_spec)
    else:
        di0, sin_next = _trace_di_gi(scene, frame, out0, cfg, prec,
                                     want_gi=gi_rounds >= 1, coherent=True)
    intensity0 = out0.intensity + torch.sum(di0, dim=1) + out0.di_sky
    n_rays = R + torch.sum(out0.lights.valid.to(torch.int32))

    # ---- GI rounds; round-1 radiance feeds the SVGF channels directly,
    # deeper rounds fold in times the path throughput
    intensity1 = torch.zeros((R, 3), dtype=dt, device=dev)
    path_mult = torch.ones((R, 3), dtype=dt, device=dev)
    out_prev = out0
    for r in range(1, gi_rounds + 1):
        last = r == gi_rounds
        out_r = shade(scene, frame, sin_next, view_dir=out_prev.view_dir_out,
                      cfg=cfg, first_round=False, no_gi=last,
                      uniforms=None if last else uniforms[r])
        if fused:
            di_r = _di_from_vis(vis_next, out_r.lights, dt)
            if not last:
                sin_next, vis_next = _trace_gi_fused_di(scene, frame, out_r, cfg, prec,
                                                        di_spec)
        else:
            # rays from scattered bounce hit points
            di_r, sin_next = _trace_di_gi(scene, frame, out_r, cfg, prec,
                                          want_gi=not last, coherent=False)
        contrib = out_r.intensity + torch.sum(di_r, dim=1) + out_r.di_sky
        intensity1 = intensity1 + path_mult * contrib
        n_rays = (n_rays + torch.sum(out_prev.gi_valid.to(torch.int32))
                  + torch.sum(out_r.lights.valid.to(torch.int32)))
        if not last:
            path_mult = path_mult * out_r.gi_multiplier
            out_prev = out_r

    # ---- clean colour split + the two denoiser instances
    clean, mul_c, mul_w = write_clean_color(
        intensity0.reshape(H, W, 3), intensity1.reshape(H, W, 3),
        out0.gi_multiplier.reshape(H, W, 3), cfg.demo)
    new_colored, new_white = state.svgf_colored, state.svgf_white
    if cfg.demo.svgf:
        normal2d, depth2d = g2d["normal"], g2d["depth"]
        if mesh is None:
            grad = preprocess_normal_depth(normal2d, depth2d)
            out2, st2 = svgf_pair_full(
                torch.stack([mul_c, mul_w]), svgf_ctr, depth2d, grad, normal2d,
                cfg.svgf, cfg.svgf.color_mix_weight, cfg.svgf.moments_mix_weight)
        else:
            out2, st2 = svgf_pair_full_sharded(
                torch.stack([mul_c, mul_w]), svgf_ctr, depth2d, normal2d, cfg.svgf,
                cfg.svgf.color_mix_weight, cfg.svgf.moments_mix_weight, mesh)
        mul_c, mul_w = out2[0].to(mul_c.dtype), out2[1].to(mul_w.dtype)
        new_colored = SVGFState(*(x[0] for x in st2))
        new_white = SVGFState(*(x[1] for x in st2))
    albedo = out0.albedo.reshape(H, W, 3)
    color = add_denoised_color(clean, mul_c, mul_w, albedo, cfg.demo)
    if taa:
        color = temporal_anti_aliasing(color, taa_map, cfg.taa_mix_weight, taa_pre)
    image = tonemap_gamma(color)

    valid = g2d["valid"]
    new_state = FrameState(
        svgf_colored=new_colored,
        svgf_white=new_white,
        taa_history=color.to(state.taa_history.dtype),
        svgf_frame_count=svgf_map["frame_count"],
        last_mesh_id=torch.where(valid, frame.obj_mesh[g2d["obj"].long()], -1).to(torch.int32),
        last_prim=g2d["tri"].to(torch.int32),
        last_l2w=frame.obj_l2w_f32,
        last_w2c=frame.cam_w2c,
    )
    aux = dict(
        clean=clean,
        gi_colored=mul_c,
        gi_white=mul_w,
        albedo=albedo,
        valid=valid,
        hit_t=g2d["t"],
        n_rays=n_rays,
        svgf_fast_path=fast,
    )
    if mesh is not None:  # the whole frame's counts: one all-reduce
        misses = svgf_map.get("halo_misses", torch.zeros((), dtype=torch.int64, device=dev))
        tot = all_reduce_sum(torch.stack([n_rays.to(torch.int64), misses]), mesh)
        aux["n_rays"], aux["halo_misses"] = tot[0], tot[1]
    return image, aux, new_state


class Renderer:
    """Owns the host scene, the device scene, the frame state and the
    random generator (`utils/rng.py:render_generator`), and renders frame
    after frame, counting them in `frame_index`.  Runs on CUDA unless
    `device` says otherwise; raises when no card is there.  With `mesh`
    (a `parallel/tiling.py:PixelMesh`, or `cfg.mesh`) it is one rank of a
    row-sharded frame: the mesh's device, the rank's rows of the state and
    of each frame (`render` returns the image rows)."""

    def __init__(self, host_scene: HostScene, cfg: RenderConfig, device=None,
                 seed: int = 0, mesh=None):
        if mesh is not None:
            cfg = dataclasses.replace(cfg, mesh=mesh)
        check_supported(cfg)
        self.host = host_scene
        self.device = resolve_device(device, cfg.mesh)
        self.frame = self._flatten(cfg, 0.0)
        check_scene(self.frame, cfg)
        # bake the scene's route into the config, as the JAX Renderer does
        self.cfg = resolve_cfg(self.frame, cfg)
        # the BVH walk's tables (BLAS, TLAS) only on its route
        walk = self.cfg.traversal_impl == "jax"
        self.scene = build_scene_arrays(host_scene, cfg.prec, self.device, walk=walk)
        if walk and self.frame.tlas_parent is None:
            self.frame = self._flatten(self.cfg, 0.0)
        self.state = init_frame_state(cfg, len(self.frame.obj_layout), self.device)
        self.generator = render_generator(seed, self.device)
        self.frame_index = 0

    def _flatten(self, cfg: RenderConfig, time: float):
        return flatten_frame(self.host, cfg.prec, self.device,
                             max_direct_lights=cfg.max_direct_lights,
                             width=cfg.width, height=cfg.height, time=time,
                             walk=cfg.traversal_impl == "jax")

    def render(self, time: float = 0.0, uniforms=None, taa_bits=None):
        """Flatten the scene at `time` (`self.frame` is then that frame's
        input) and render it.  -> (image, aux); aux["flatten_ms"] is the
        flatten's host time."""
        t0 = _time.perf_counter()
        self.frame = self._flatten(self.cfg, time)
        flatten_ms = (_time.perf_counter() - t0) * 1e3
        check_scene(self.frame, self.cfg)
        image, aux, self.state = render_frame(
            self.scene, self.frame, self.state, self.cfg, uniforms=uniforms,
            generator=self.generator, taa_bits=taa_bits,
        )
        aux["flatten_ms"] = flatten_ms
        self.frame_index += 1
        return image, aux
