"""Headless command line (port of `low_precision_raytracer_tpu/cli.py`):

    python -m low_precision_raytracer_tpu_torch.cli render scene.glb \\
        --precision bf16 --width 1024 --height 768 --frames 8 --out out.png
    python -m low_precision_raytracer_tpu_torch.cli render cornell --profile
    python -m low_precision_raytracer_tpu_torch.cli info scene.glb
    python -m low_precision_raytracer_tpu_torch.cli parity cornell
    python -m low_precision_raytracer_tpu_torch.cli view cornell

(`lprt-torch` once the package is installed.)  Every command that renders
takes `--device` (default `cuda`, the counterpart of the JAX package's
platform choice; `cpu` runs the kernels' plain versions) and raises when
no card is there.  The pre-load configuration (precision, resolution)
maps to flags, the per-frame toggles to --no-svgf / --no-taa / --no-gi /
--demodulate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _build_scene(name_or_path: str):
    from low_precision_raytracer_tpu_torch.models import procedural

    scenes = {
        "cornell": procedural.cornell_box_scene,
        "cornell-anim": procedural.animated_cornell_scene,
        "sphere": procedural.single_mesh_scene,
        "triangle": procedural.single_triangle_scene,
        "sponza": procedural.sponza_like_scene,
    }
    if name_or_path in scenes:
        return scenes[name_or_path]()
    import numpy as np

    from low_precision_raytracer_tpu_torch.models.gltf import load_gltf
    from low_precision_raytracer_tpu_torch.models.hierarchy import (
        LIGHT_POINT,
        CameraObject,
        LightObject,
    )

    scene = load_gltf(name_or_path)
    if not scene.meshes:
        # the default camera and headlight rigs below aggregate mesh AABBs
        raise SystemExit(
            "scene has no meshes — nothing to render (camera/light-only "
            "glTF files are valid but not renderable)"
        )
    lo = np.min(np.stack([m.aabb[0] for m in scene.meshes]), axis=0)
    hi = np.max(np.stack([m.aabb[1] for m in scene.meshes]), axis=0)
    radius = float(np.linalg.norm(hi - lo)) / 2 + 1e-3
    if scene.active_camera is None:
        # a default camera, as the explorer rigs one when the file has none
        cam = CameraObject(name="default-cam", fov_y=np.pi / 3)
        cam.translation = (lo + hi) / 2 + np.array([0, 0, 2.5 * radius], np.float32)
        scene.root.add(cam)
        scene.active_camera = cam
    if not any(isinstance(n, LightObject) for n in scene.root.walk()):
        # a headlight for light-less files (e.g. the Khronos Box sample):
        # without it a GI render of such a file is black (SKYBOX_COLOR is
        # 0); a command-line convenience, not reference parity
        lamp = LightObject(
            name="default-headlight",
            light_type=LIGHT_POINT,
            intensity=np.full(3, 40.0 * radius * radius, np.float32),
        )
        lamp.translation = np.asarray(
            scene.active_camera.translation, np.float32
        ) + np.array([radius, 2.0 * radius, radius], np.float32)
        scene.root.add(lamp)
    return scene


def _with_skybox(scene, args):
    if args.skybox:
        from low_precision_raytracer_tpu_torch.models.scene import Skybox
        from low_precision_raytracer_tpu_torch.utils.image import load_hdr_equirect

        scene.skybox = Skybox(data=load_hdr_equirect(args.skybox),
                              exposure=args.skybox_exposure)
    return scene


def cmd_render(args) -> int:
    from low_precision_raytracer_tpu_torch.config import DemoSettings, RenderConfig
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer
    from low_precision_raytracer_tpu_torch.utils.image import save_png
    from low_precision_raytracer_tpu_torch.utils.timing import sync

    if args.frames < 1:
        raise SystemExit("--frames must be >= 1")

    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        precision=args.precision,
        gi_on=not args.no_gi,
        taa_on=not args.no_taa,
        taa_mix_weight=args.taa_weight,
        demo=DemoSettings(svgf=not args.no_svgf, demodulate=args.demodulate),
        triangle_fallback=args.fallback,
        traversal_impl=args.impl,
        max_bounces=args.bounces,
        dense_epilogue=args.epilogue,
        incoherent_sort=args.incoherent_sort,
        incoherent_impl=args.incoherent_impl,
    )
    scene = _with_skybox(_build_scene(args.scene), args)
    renderer = Renderer(scene, cfg, device=args.device)
    image = None
    t0 = time.perf_counter()
    for f in range(args.frames):
        image, _aux = renderer.render(time=f * args.time_step)
        if args.out_pattern:
            save_png(args.out_pattern.format(f), image)
    sync(renderer.device)
    dt = time.perf_counter() - t0
    print(
        f"rendered {args.frames} frame(s) {args.width}x{args.height} "
        f"{args.precision} on {renderer.device} in {dt:.2f}s "
        f"({args.frames / dt:.2f} fps incl. the kernels' first build)",
        file=sys.stderr,
    )
    if args.profile:
        from low_precision_raytracer_tpu_torch.render.profile import profile_frame

        stats = profile_frame(renderer)
        for k, v in stats.items():
            print(f"{k:>24s}: {v * 1e3:8.3f} ms", file=sys.stderr)
    if args.out:
        save_png(args.out, image)
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


def cmd_info(args) -> int:
    scene = _build_scene(args.scene)
    tris = sum(m.n_triangles for m in scene.meshes)
    verts = sum(m.positions.shape[0] for m in scene.meshes)
    info = dict(
        meshes=len(scene.meshes),
        triangles=int(tris),
        vertices=int(verts),
        materials=len(scene.materials),
        textures=len(scene.textures),
        animated=scene.animated,
        has_camera=scene.active_camera is not None,
    )
    print(json.dumps(info, indent=2))
    return 0


def cmd_parity(args) -> int:
    """Low-precision-vs-fp32 parity: renders the same scene at both
    precisions (same seed) and prints PSNR and SSIM of the last frames and
    the fp32-fallback rate of the low-precision primary rays."""
    import numpy as np

    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.ops.camera import primary_ray_grid
    from low_precision_raytracer_tpu_torch.ops.diagnostics import fallback_rate
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer
    from low_precision_raytracer_tpu_torch.utils.image import psnr, ssim

    imgs = {}
    renderers = {}
    for prec in ("fp32", args.precision):
        cfg = RenderConfig(
            width=args.width, height=args.height, precision=prec, gi_on=not args.no_gi
        )
        renderers[prec] = Renderer(_build_scene(args.scene), cfg, device=args.device)
        img = None
        for f in range(args.frames):
            img, _ = renderers[prec].render(time=f * args.time_step)
        imgs[prec] = img.float().cpu().numpy()
    p = psnr(imgs["fp32"], imgs[args.precision])
    s = ssim(imgs["fp32"], imgs[args.precision])

    # the fallback-rate diagnostic on the low-precision primary rays (the
    # camera grid in the render dtype); no table above 4 x 2^20 triangles
    r = renderers[args.precision]
    frame = r.frame
    rate = float("nan")
    if getattr(frame, "dense_n", None) is not None:
        o, d = primary_ray_grid(frame.cam_l2w_f32, frame.cam_fov_y_f32, r.cfg.width,
                                r.cfg.height, r.cfg.prec.dtype)
        stats = fallback_rate(frame, o.reshape(-1, 3), d.reshape(-1, 3), r.cfg.prec)
        rate = float(stats["rate"])
    print(json.dumps({
        "precision": args.precision,
        "psnr_db": round(p, 2) if np.isfinite(p) else p,
        "ssim": round(s, 4),
        "fp32_fallback_rate": round(rate, 6),
        "frames": args.frames,
    }))
    return 0


def cmd_view(args) -> int:
    """Interactive explorer: frames into a browser canvas over HTTP."""
    from low_precision_raytracer_tpu_torch.config import DemoSettings, RenderConfig
    from low_precision_raytracer_tpu_torch.gui.viewer import SceneExplorer, serve

    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        precision=args.precision,
        gi_on=not args.no_gi,
        demo=DemoSettings(svgf=not args.no_svgf),
        taa_mix_weight=0.3,  # interactive: keep history but converge fast
    )
    scene = _with_skybox(_build_scene(args.scene), args)
    explorer = SceneExplorer(scene, cfg, device=args.device)
    srv = serve(explorer, host=args.host, port=args.port)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def cmd_bench(args) -> int:
    raise NotImplementedError(
        "the port's benchmark waits (ROADMAP queue 1 item 13); the repo-root "
        "bench.py is the JAX package's TPU record")


def _device_flag(p):
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lprt-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to PNG")
    pr.add_argument("scene", help="glTF path or builtin: cornell|cornell-anim|sphere|"
                                  "triangle|sponza")
    pr.add_argument("--width", type=int, default=1024)
    pr.add_argument("--height", type=int, default=768)
    pr.add_argument("--precision", choices=["fp32", "bf16", "fp16"], default="fp32")
    pr.add_argument("--frames", type=int, default=1)
    pr.add_argument("--time-step", type=float, default=1 / 30)
    pr.add_argument("--out", default="out.png")
    pr.add_argument("--out-pattern", default=None,
                    help="per-frame PNG path pattern, e.g. frames/f{:04d}.png")
    pr.add_argument("--no-gi", action="store_true")
    pr.add_argument("--no-svgf", action="store_true")
    pr.add_argument("--no-taa", action="store_true")
    pr.add_argument("--taa-weight", type=float, default=1.0)
    pr.add_argument("--demodulate", action="store_true")
    pr.add_argument("--fallback", choices=["auto", "both", "dtype", "mxu3"], default="auto")
    pr.add_argument("--impl", default="auto",
                    choices=["auto", "jax", "dense", "dense_pallas", "pallas"],
                    help="trace route (auto: the dense kernels up to 2^20 instance "
                         "triangles, the packet BVH to 4 x 2^20, the BVH walk above)")
    pr.add_argument("--epilogue", choices=["auto", "reduce5", "pack"],
                    default="auto", help="dense-kernel chunk epilogue")
    pr.add_argument("--incoherent-sort",
                    choices=["anchor", "beam", "origin", "none"],
                    default="anchor", help="bounce-launch ray order (default: the "
                    "config's default)")
    pr.add_argument("--incoherent-impl", choices=["tile", "wavefront"],
                    default="wavefront", help="bounce-launch route (default: the "
                    "config's default)")
    pr.add_argument("--bounces", type=int, default=2,
                    help="max_bounces incl. the primary shade round")
    pr.add_argument("--skybox", default=None, help="equirectangular HDR path")
    pr.add_argument("--skybox-exposure", type=float, default=1.0)
    pr.add_argument("--profile", action="store_true",
                    help="time the 12 stages of one more frame (render/profile.py)")
    _device_flag(pr)
    pr.set_defaults(fn=cmd_render)

    pi = sub.add_parser("info", help="print scene statistics")
    pi.add_argument("scene")
    pi.set_defaults(fn=cmd_info)

    pp = sub.add_parser("parity", help="low-precision-vs-fp32 PSNR/SSIM parity check")
    pp.add_argument("scene", nargs="?", default="cornell")
    pp.add_argument("--precision", choices=["bf16", "fp16"], default="bf16")
    pp.add_argument("--width", type=int, default=256)
    pp.add_argument("--height", type=int, default=256)
    pp.add_argument("--frames", type=int, default=4)
    pp.add_argument("--time-step", type=float, default=1 / 30)
    pp.add_argument("--no-gi", action="store_true")
    _device_flag(pp)
    pp.set_defaults(fn=cmd_parity)

    pb = sub.add_parser("bench", help="the benchmark (waits: ROADMAP queue 1 item 13)")
    pb.add_argument("--width", type=int, default=1920)
    pb.add_argument("--height", type=int, default=1080)
    pb.add_argument("--precision", default="bf16")
    pb.add_argument("--frames", type=int, default=20)
    pb.set_defaults(fn=cmd_bench)

    pv = sub.add_parser("view", help="interactive browser explorer")
    pv.add_argument("scene", nargs="?", default="cornell")
    pv.add_argument("--width", type=int, default=512)
    pv.add_argument("--height", type=int, default=512)
    pv.add_argument("--precision", choices=["fp32", "bf16", "fp16"], default="bf16")
    pv.add_argument("--no-gi", action="store_true")
    pv.add_argument("--no-svgf", action="store_true")
    pv.add_argument("--skybox", default=None, help="equirectangular HDR path")
    pv.add_argument("--skybox-exposure", type=float, default=1.0)
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=8008)
    _device_flag(pv)
    pv.set_defaults(fn=cmd_view)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
