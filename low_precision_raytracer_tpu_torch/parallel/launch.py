"""Start the ranks of a row-sharded run, and the rank function that
renders frames and writes what each rank saw.

`spawn(n, fn, backend, device, args)` runs `fn(mesh, *args)` in n
processes started with `torch.multiprocessing`'s spawn method: each joins
a process group over a `FileStore` in a temporary directory (no TCP port,
so parallel runs cannot collide), makes its `PixelMesh` and never builds
a kernel (`ops/cuda_lib.py:NO_BUILD_ENV`: the parent builds them first).
Under NCCL rank r takes `cuda:r` (its LOCAL_RANK) unless `device` names
one; under gloo every rank takes `device`.

`render_rank(mesh, spec)` renders the cases of `spec` on its rank and
saves them to `<spec["out"]>/rank<r>.pt`: per case and frame the image
rows, the state rows (or, with `keep="digest"`, a SHA-256 of each pixel
leaf's rows), the kernels' launch counts, the exchanges (`halo.COUNTS`),
the frame's ms (host clock around `render()` and a synchronize), the
whole frame's ray and halo-miss counts, and once the ms of the whole
frame's draws, which every rank pays.  A case names its scene as
"module:function" with arguments, so a spawned rank imports only the
port (and the named module)."""

from __future__ import annotations

import hashlib
import importlib
import os
import statistics
import tempfile
import time

import torch
import torch.distributed as dist


def _child(rank, n, fn, backend, device, store_dir, args, threads):
    from low_precision_raytracer_tpu_torch.ops import cuda_lib
    from low_precision_raytracer_tpu_torch.parallel.tiling import make_pixel_mesh

    os.environ[cuda_lib.NO_BUILD_ENV] = "1"
    os.environ["LOCAL_RANK"] = str(rank)
    if threads:
        torch.set_num_threads(threads)
    store = dist.FileStore(os.path.join(store_dir, "store"), n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n)
    try:
        fn(make_pixel_mesh(backend, device), *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(n: int, fn, backend: str, device=None, args=(), threads: int | None = None):
    """Run fn(mesh, *args) on n ranks (one process each) and wait for all;
    a rank that raises makes this raise.  `threads`: torch threads a rank."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_child, args=(n, fn, backend, device, tmp, tuple(args), threads),
                           nprocs=n, start_method="spawn", join=True)


def _factory(name: str):
    module, fn = name.split(":")
    return getattr(importlib.import_module(module), fn)


def state_leaves(state) -> dict:
    """The pixel leaves of a FrameState by name."""
    out = {f"svgf_colored.{k}": v for k, v in state.svgf_colored._asdict().items()}
    out.update({f"svgf_white.{k}": v for k, v in state.svgf_white._asdict().items()})
    for k in ("taa_history", "svgf_frame_count", "last_mesh_id", "last_prim"):
        out[k] = getattr(state, k)
    return out


def state_digest(state) -> dict:
    """SHA-256 of each pixel leaf's bytes (equal digests: equal bits)."""
    return {k: hashlib.sha256(v.detach().contiguous().cpu().view(torch.uint8).numpy()
                              .tobytes()).hexdigest() for k, v in state_leaves(state).items()}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def draw_ms(cfg, device, reps: int = 10) -> float:
    """The median ms of the whole frame's draws (`render_frame`'s): the TAA
    bits when TAA runs, one GI uniform draw a GI round."""
    from low_precision_raytracer_tpu_torch.render.renderer import taa_active

    gen = torch.Generator(device=device).manual_seed(1)
    H, W = cfg.height, cfg.width
    dt = torch.float32 if cfg.shade_f32 else cfg.prec.dtype
    rounds = cfg.max_bounces - 1 if cfg.gi_on else 0
    times = []
    for _ in range(reps + 1):
        _sync(device)
        t0 = time.perf_counter()
        if taa_active(cfg):
            torch.randint(0, 1 << 32, (H, W), generator=gen, dtype=torch.int64, device=device)
        for _ in range(rounds):
            torch.rand((7 * H * W,), generator=gen, dtype=dt, device=device)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def render_rank(mesh, spec: dict) -> None:
    """Render spec["cases"] on this rank and save what it saw (see the
    module docstring).  A case: name, scene ("module:function"),
    scene_args, cfg (RenderConfig keywords), frames, times (a time a
    frame, or None), seed, uniforms (a file of the whole frames' GI
    uniforms, a list of tensors a frame, or None), taa_bits (a file of
    the whole frames' TAA bits, an (H, W) tensor a frame, or None), keep
    ("rows" or "digest")."""
    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.ops import cuda_lib
    from low_precision_raytracer_tpu_torch.parallel import halo
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    dev = mesh.device
    saved = {}
    for case in spec["cases"]:
        cfg = RenderConfig(**case["cfg"])
        host = _factory(case["scene"])(*case.get("scene_args", ()))
        r = Renderer(host, cfg, device=dev, seed=case.get("seed", 0), mesh=mesh)
        us_all = torch.load(case["uniforms"]) if case.get("uniforms") else None
        bits_all = torch.load(case["taa_bits"]) if case.get("taa_bits") else None
        keep = case.get("keep", "rows")
        rec = {k: [] for k in ("images", "states", "launches", "exchanges", "frame_ms",
                               "n_rays", "halo_misses")}
        for f in range(case["frames"]):
            us = None if us_all is None else [u.to(dev) for u in us_all[f]]
            bits = None if bits_all is None else bits_all[f].to(dev)
            t = 0.0 if case.get("times") is None else case["times"][f]
            before = dict(cuda_lib.LAUNCHES)
            halo.reset_counts()
            _sync(dev)
            t0 = time.perf_counter()
            image, aux = r.render(time=t, uniforms=us, taa_bits=bits)
            _sync(dev)
            rec["frame_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["exchanges"].append(dict(halo.COUNTS))
            rec["launches"].append({k: v - before[k] for k, v in cuda_lib.LAUNCHES.items()})
            rec["images"].append(image.cpu())
            rec["n_rays"].append(int(aux["n_rays"]))
            rec["halo_misses"].append(int(aux.get("halo_misses", 0)))
            rec["states"].append(
                state_digest(r.state) if keep == "digest"
                else {k: v.cpu() for k, v in state_leaves(r.state).items()})
        rec["draw_ms"] = draw_ms(cfg, dev)
        saved[case["name"]] = rec
        del r
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    torch.save(saved, os.path.join(spec["out"], f"rank{mesh.rank}.pt"))


def exchange_rank(mesh, spec: dict) -> None:
    """The exchange's own check on this rank: a (C, H, W) frame drawn from
    spec["seed"], this rank's rows of it, `exchange_rows` for each (top,
    bottom) of spec["strips"]; saves the strips to
    `<spec["out"]>/rank<r>.pt` for the caller to hold against slices of the
    same frame."""
    from low_precision_raytracer_tpu_torch.parallel.halo import exchange_rows
    from low_precision_raytracer_tpu_torch.parallel.tiling import shard_rows

    C, H, W = spec["shape"]
    gen = torch.Generator().manual_seed(spec["seed"])
    frame = torch.rand((C, H, W), generator=gen).to(mesh.device)
    mine = shard_rows(frame, mesh, dim=1).contiguous()
    got = [tuple(x.cpu() for x in exchange_rows(mine, top, bottom, mesh))
           for top, bottom in spec["strips"]]
    torch.save(got, os.path.join(spec["out"], f"rank{mesh.rank}.pt"))
