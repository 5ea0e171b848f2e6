"""Directed casts to the render dtype (port of
`low_precision_raytracer_tpu/utils/dtypes.py`).

BVH AABBs are computed in fp32 and stored in the render dtype widened
conservatively: lower bounds rounded toward -inf, upper bounds toward
+inf, so a bf16 / fp16 box always contains its fp32 original.  The same
bit steps as the JAX package's numpy version, on torch tensors (the port
has no numpy bfloat16): the results are bit-identical.
"""

from __future__ import annotations

import numpy as np
import torch


def _next_down(y: torch.Tensor) -> torch.Tensor:
    """The next representable bf16 / fp16 value toward -inf, by a step of
    the bit pattern: up for negative values and -0, down for positive
    ones, +0 to the smallest negative subnormal."""
    b = y.view(torch.int16)
    is_neg = (y < 0) | ((y == 0) & torch.signbit(y))
    stepped = torch.where(is_neg, b + 1, b - 1)
    neg_sub = torch.tensor(-0.0, dtype=y.dtype).view(torch.int16) + 1
    stepped = torch.where((y == 0) & ~torch.signbit(y), neg_sub, stepped)
    return stepped.to(torch.int16).view(y.dtype)


def cast_round_down(x, dtype: torch.dtype) -> torch.Tensor:
    """fp32 -> `dtype` rounding toward -inf (a CPU tensor)."""
    x = torch.as_tensor(np.asarray(x, np.float32))
    if dtype == torch.float32:
        return x
    y = x.to(dtype)
    too_big = y.to(torch.float32) > x
    return torch.where(too_big, _next_down(y), y)


def cast_round_up(x, dtype: torch.dtype) -> torch.Tensor:
    """fp32 -> `dtype` rounding toward +inf (a CPU tensor)."""
    x = torch.as_tensor(np.asarray(x, np.float32))
    if dtype == torch.float32:
        return x
    return -cast_round_down(-x, dtype)


def widen_aabb(lo, hi, dtype: torch.dtype):
    """Conservatively cast an fp32 AABB to `dtype`."""
    return cast_round_down(lo, dtype), cast_round_up(hi, dtype)
