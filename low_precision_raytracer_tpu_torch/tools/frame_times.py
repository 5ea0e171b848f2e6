"""Frame times of the port at 1920x1080 on one GPU, for comparing two
checkouts of this repository on the same card.

    PYTHONPATH=<checkout> python3 low_precision_raytracer_tpu_torch/tools/frame_times.py \
        [scene:precision ...]

renders 8 frames of each scene (default: the flagship, colonnade-83k and
colonnade-328k in bf16; scenes `flagship` (Cornell), `colonnade-83k`
(`sponza_like_scene(8, 3)`), `colonnade-328k` (`(8, 4)`), precisions
bf16, fp32, fp16) through a fresh `Renderer` (seed 0) of whichever
package `PYTHONPATH` puts first, and prints one JSON line per scene: the
median ms of frames 3-8, host clock around `render()` and a synchronize,
as `chip_smoke.py`'s path phases time a frame, and every frame's ms.  Run
it by path, so that an older checkout without this file can be timed:
from the same call, a b b a.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

W, H, FRAMES = 1920, 1080, 8


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

    scenes = {"flagship": cornell_box_scene, "colonnade-83k": lambda: sponza_like_scene(8, 3),
              "colonnade-328k": lambda: sponza_like_scene(8, 4)}
    runs = [a.split(":") for a in sys.argv[1:]] or [[name, "bf16"] for name in scenes]
    for name, precision in runs:
        renderer = Renderer(scenes[name](), RenderConfig(width=W, height=H, precision=precision))
        ms = []
        for _ in range(FRAMES):
            t0 = time.perf_counter()
            renderer.render()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        del renderer
        torch.cuda.empty_cache()
        print(json.dumps(dict(package=pkg.__file__, scene=name, precision=precision,
                              frame_ms=statistics.median(ms[2:]), frames_ms=ms)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
