"""Temporal anti-aliasing (port of `low_precision_raytracer_tpu/ops/taa.py`):
the history blend through the jittered TAA map, non-finite history
replaced by the frame's colour."""

from __future__ import annotations

import torch


def temporal_anti_aliasing(color, taa_map, taa_weight: float, hist_pre):
    """hist * (1 - w) + color * w in the colour dtype.  hist_pre: the
    finished weighted history fetch (H, W, 3) (`reproject.fetch_weighted`);
    pixels whose map count is 0, and non-finite history, take `color`."""
    dt = color.dtype
    hist = torch.where((taa_map["frame_count"] > 0)[..., None], hist_pre.to(dt), color)
    hist = torch.where(torch.isfinite(hist), hist, color)
    w = torch.tensor(taa_weight, dtype=dt, device=color.device)
    return hist * (1 - w) + color * w
