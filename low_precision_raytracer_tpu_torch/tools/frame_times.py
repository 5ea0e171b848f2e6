"""Frame times of the port at 1920x1080 on one GPU, for comparing two
checkouts of this repository on the same card.

    PYTHONPATH=<checkout> python3 low_precision_raytracer_tpu_torch/tools/frame_times.py \
        [scene:precision ...]

renders 8 frames of each scene (default: the flagship, colonnade-83k and
colonnade-328k in bf16; scenes `flagship` (Cornell), `sponza` (the
Sponza-class frame, `sponza_like_scene()`), `colonnade-83k`
(`sponza_like_scene(8, 3)`), `colonnade-328k` (`(8, 4)`), `colonnade-2M`
(`(10, 5)`), and `animated`: the interactive path, `chip_smoke.py`'s
animated phase (the animated Cornell box, the camera dollying 0.02 units
a frame, `taa_mix_weight=0.3`, frame f at time f / 30; a checkout without
animation refuses it); precisions bf16, fp32, fp16) through a fresh
`Renderer` (seed 0) of whichever package `PYTHONPATH` puts first, and
prints one JSON line per scene: the median ms of frames 3-8, host clock
around `render()` and a synchronize, as `chip_smoke.py`'s path phases time
a frame, every frame's ms and, where the package reports it, every
frame's flatten ms.  Run it by path, so that an older checkout without
this file can be timed: from the same call, a b b a.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

W, H, FRAMES = 1920, 1080, 8
FPS, DOLLY = 30, 0.02  # the animated scene: frame f at f / FPS, the camera's units a frame


def animated_scene():
    """The animated Cornell box with the camera dollying toward the box."""
    import numpy as np

    from low_precision_raytracer_tpu_torch.models.hierarchy import Sampler
    from low_precision_raytracer_tpu_torch.models.procedural import animated_cornell_scene

    scene = animated_cornell_scene()
    cam = scene.active_camera
    t0 = np.asarray(cam.translation, np.float32)
    cam.animation.translation = Sampler(
        times=np.array([0.0, 10.0], np.float32),
        values=np.stack([t0, t0 - np.array([0, 0, DOLLY * FPS * 10], np.float32)]))
    return scene


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("frame_times: no CUDA device", file=sys.stderr)
        return 1
    import low_precision_raytracer_tpu_torch as pkg
    from low_precision_raytracer_tpu_torch.config import RenderConfig
    from low_precision_raytracer_tpu_torch.models.procedural import (
        cornell_box_scene,
        sponza_like_scene,
    )
    from low_precision_raytracer_tpu_torch.render.renderer import Renderer

    scenes = {"flagship": cornell_box_scene, "sponza": sponza_like_scene,
              "colonnade-83k": lambda: sponza_like_scene(8, 3),
              "colonnade-328k": lambda: sponza_like_scene(8, 4),
              "colonnade-2M": lambda: sponza_like_scene(10, 5), "animated": animated_scene}
    runs = ([a.split(":") for a in sys.argv[1:]]
            or [[name, "bf16"] for name in ("flagship", "colonnade-83k", "colonnade-328k")])
    for name, precision in runs:
        moving = name == "animated"
        renderer = Renderer(scenes[name](), RenderConfig(
            width=W, height=H, precision=precision, taa_mix_weight=0.3 if moving else 1.0))
        ms, flatten_ms = [], []
        for f in range(FRAMES):
            t0 = time.perf_counter()
            _img, aux = renderer.render(time=f / FPS) if moving else renderer.render()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            flatten_ms.append(aux.get("flatten_ms"))
        del renderer
        torch.cuda.empty_cache()
        print(json.dumps(dict(package=pkg.__file__, scene=name, precision=precision,
                              frame_ms=statistics.median(ms[2:]), frames_ms=ms,
                              flatten_ms=flatten_ms)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
