"""Per-stage timing names and the device sync (port of
`low_precision_raytracer_tpu/utils/timing.py`).

Production frames run stage after stage without a sync; the profiler
(render/profile.py) times each stage on its own and keys the result by the
reference's 12 stage names."""

from __future__ import annotations

import torch

# the reference's 12 stage names, in the JAX package's order
STAGE_NAMES = [
    "Primary Ray",
    "Generate Temporal Map",
    "Pixel Shade #1",
    "Trace DI Ray #1",
    "Accumulate DI #1",
    "Trace GI #1",
    "Shade #2",
    "Trace DI #2",
    "Accumulate DI #2",
    "SVGF",
    "TAA",
    "Backup Temporal Data",
]


def sync(device) -> None:
    """Wait for all work queued on `device` (the JAX package's `sync` and
    `sync_one`: one `torch.cuda.synchronize`); nothing on the CPU, where
    every op has finished when it returns."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
