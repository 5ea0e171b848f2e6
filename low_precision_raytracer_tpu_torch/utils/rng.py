"""The frame loop's random generator (port of
`low_precision_raytracer_tpu/utils/rng.py`).

One helper, so that every entry point (the Renderer, the CLI, the
explorer, the profiler) draws from the same kind of generator: a
`torch.Generator` on the render device, seeded.  The JAX package picks a
key (`render_key`) the same way; its draws are not the port's, so the
tests feed the JAX draws where they compare frames."""

from __future__ import annotations

import torch


def render_generator(seed: int = 0, device="cpu") -> torch.Generator:
    """A generator on `device` seeded with `seed`: the GI uniforms and the
    TAA jitter words of every frame come from it."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))
