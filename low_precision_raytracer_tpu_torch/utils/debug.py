"""Pixel-picker debugging (port of `low_precision_raytracer_tpu/utils/debug.py`).

A debug pixel is an index: `debug_pixel` prints one pixel of any per-pixel
tensor, `pick_pixel` extracts a whole per-pixel record of the renderer's
aux dict on the host."""

from __future__ import annotations

import torch


def debug_pixel(label: str, array, x: int, y: int) -> None:
    """Print array[y, x] (callers of flat arrays index them first):

        debug_pixel("albedo", aux["albedo"], x=412, y=200)
    """
    v = array[y, x]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().tolist()
    print(f"{label} @({x},{y}) = {v}")


def pick_pixel(aux: dict, x: int, y: int, height: int, width: int) -> dict:
    """Host-side pixel inspector over the renderer's aux dict.  Only
    entries whose leading dims are the (height, width) pixel grid are
    indexed: non-pixel arrays (transform stacks, per-object tables) whose
    first two dims merely admit [y, x] are left out."""
    out = {}
    for k, v in aux.items():
        if (
            hasattr(v, "ndim")
            and v.ndim >= 2
            and v.shape[0] == height
            and v.shape[1] == width
        ):
            px = v[y, x]
            out[k] = px.detach().cpu().numpy() if isinstance(px, torch.Tensor) else px
    return out
