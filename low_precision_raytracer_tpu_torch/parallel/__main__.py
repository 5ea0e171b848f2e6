"""The sharded frame's dry run (counterpart of the JAX package's
`__graft_entry__.py:dryrun_multichip`):

    python -m low_precision_raytracer_tpu_torch.parallel --ranks N --backend gloo|nccl \\
        [--device cpu] [--frames F]
    torchrun --nproc-per-node N -m low_precision_raytracer_tpu_torch.parallel \\
        --backend gloo|nccl [--device cpu] [--frames F]

renders F frames (default 2) of the bf16 flagship (Cornell) at 128 x
max(128, 2N) (rounded up to a multiple of N) over N ranks, checks the
gathered image's shape and that image and state equal the one-process
frames bit for bit, prints one JSON line and exits non-zero when they do
not.  The first form starts the ranks itself (`launch.spawn`, after
building the kernels when the device is a card; on the CPU every process
runs one torch thread); under torchrun each
process is a rank (RANK / WORLD_SIZE / LOCAL_RANK), and the kernels must
be built beforehand (`ops/cuda_lib.py:build_all`).  Under NCCL each rank
takes `cuda:{LOCAL_RANK}`; under gloo every rank takes `--device` (the
card by default)."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

SCENE = "low_precision_raytracer_tpu_torch.models.procedural:cornell_box_scene"


def frame_height(n: int) -> int:
    h = max(128, 2 * n)
    return h + (-h) % n


def _reference(cfg, frames, device):
    """The one-process frames: -> [(image, state leaves)] on the CPU."""
    from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene
    from low_precision_raytracer_tpu_torch.parallel.launch import state_leaves
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    r = Renderer(cornell_box_scene(), cfg, device=device, seed=0)
    out = []
    for _ in range(frames):
        image, _aux = r.render()
        out.append((image.cpu(), {k: v.cpu() for k, v in state_leaves(r.state).items()}))
    return out


def _compare(ref, images, states):
    """-> (shape ok, [frames whose image and every state leaf are equal])."""
    shape_ok = all(tuple(i.shape) == tuple(ri.shape) for i, (ri, _) in zip(images, ref))
    equal = [f for f, ((ri, rs), i, s) in enumerate(zip(ref, images, states))
             if torch.equal(ri, i) and all(torch.equal(rs[k], s[k]) for k in rs)]
    return shape_ok, equal


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m low_precision_raytracer_tpu_torch.parallel")
    ap.add_argument("--ranks", type=int, help="ranks to start (not under torchrun)")
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--device", default=None, help="every rank's device under gloo")
    ap.add_argument("--frames", type=int, default=2)
    a = ap.parse_args(argv)

    from low_precision_raytracer_tpu_torch.config import RenderConfig, resolve_device

    under_torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    n = int(os.environ["WORLD_SIZE"]) if under_torchrun else a.ranks
    if not n or n < 1:
        ap.error("--ranks N is needed outside torchrun")
    cfg = RenderConfig(width=128, height=frame_height(n), precision="bf16")
    if under_torchrun:
        return _torchrun_rank(a, cfg)

    from low_precision_raytracer_tpu_torch.parallel.launch import render_rank, spawn

    if a.backend == "nccl" and n > torch.cuda.device_count():
        ap.error(f"NCCL takes a card a rank: {n} ranks, {torch.cuda.device_count()} cards")
    dev = resolve_device(a.device if a.backend == "gloo" else "cuda")
    if dev.type == "cpu":  # one torch thread a process: the ranks share the cores
        torch.set_num_threads(1)
    else:
        from low_precision_raytracer_tpu_torch.ops import cuda_lib

        cuda_lib.build_all()
    ref = _reference(cfg, a.frames, dev)
    with tempfile.TemporaryDirectory() as out:
        case = dict(name="flagship", scene=SCENE, cfg=dict(width=cfg.width, height=cfg.height,
                                                            precision="bf16"),
                    frames=a.frames, keep="rows")
        spawn(n, render_rank, a.backend, a.device if a.backend == "gloo" else None,
              args=(dict(cases=[case], out=out),), threads=1 if dev.type == "cpu" else None)
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"))["flagship"] for r in range(n)]
    images = [torch.cat([rk["images"][f] for rk in ranks]) for f in range(a.frames)]
    states = [{k: torch.cat([rk["states"][f][k] for rk in ranks]) for k in ranks[0]["states"][f]}
              for f in range(a.frames)]
    shape_ok, equal = _compare(ref, images, states)
    ok = shape_ok and len(equal) == a.frames
    print(json.dumps(dict(ranks=n, backend=a.backend, device=str(dev), height=cfg.height,
                          width=cfg.width, frames=a.frames, shape_ok=shape_ok,
                          frames_equal=len(equal), ok=ok)))
    return 0 if ok else 1


def _torchrun_rank(a, cfg) -> int:
    """One torchrun process: render its rows, gather the frame, compare on
    rank 0; every rank exits with the comparison's verdict."""
    import torch.distributed as dist

    from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene
    from low_precision_raytracer_tpu_torch.ops import cuda_lib
    from low_precision_raytracer_tpu_torch.parallel.halo import all_gather_rows, all_reduce_sum
    from low_precision_raytracer_tpu_torch.parallel.launch import state_leaves
    from low_precision_raytracer_tpu_torch.parallel.tiling import gather_state, make_pixel_mesh
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    os.environ[cuda_lib.NO_BUILD_ENV] = "1"
    mesh = make_pixel_mesh(a.backend, a.device if a.backend == "gloo" else None)
    r = Renderer(cornell_box_scene(), cfg, seed=0, mesh=mesh)
    images, states = [], []
    for _ in range(a.frames):
        image, _aux = r.render()
        images.append(all_gather_rows(image, mesh).cpu())
        states.append({k: v.cpu() for k, v in state_leaves(gather_state(r.state, mesh)).items()})
    ok = 1
    if mesh.rank == 0:
        shape_ok, equal = _compare(_reference(cfg, a.frames, mesh.device), images, states)
        ok = int(shape_ok and len(equal) == a.frames)
        print(json.dumps(dict(ranks=mesh.size, backend=a.backend, device=str(mesh.device),
                              height=cfg.height, width=cfg.width, frames=a.frames,
                              shape_ok=shape_ok, frames_equal=len(equal), ok=bool(ok))))
    # rank 0's verdict, on every rank
    verdict = all_reduce_sum(torch.tensor([0 if mesh.rank else ok], device=mesh.device), mesh)
    dist.destroy_process_group()
    return 0 if int(verdict[0]) else 1


if __name__ == "__main__":
    sys.exit(main())
