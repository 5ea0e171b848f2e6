"""Tensor vector helpers over ``(..., 3)`` tensors (port of
`low_precision_raytracer_tpu/math/vec.py`).

Dtype-preserving: each helper computes in the dtype its inputs carry.
"""

from __future__ import annotations

from functools import lru_cache

import torch


@lru_cache(maxsize=None)
def const(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as the JAX package's
    `jnp.asarray(value, dtype)`, kept a Python float so that it stays a
    scalar operand (in f32 the same value torch takes for the float)."""
    return float(torch.tensor(value, dtype=dtype))


def dot(a, b):
    """Batched 3-vector dot product -> (...,)."""
    return torch.sum(a * b, dim=-1)


def normalize(v):
    """v / |v| with no epsilon guard: NaN/Inf are in-band values that
    downstream filters launder."""
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def reflect(v, n):
    """Mirror of v about the normalized normal n: 2 (v.n) n - v."""
    return 2.0 * dot(v, n)[..., None] * n - v


def pow5(x):
    """x**5 by the binary-exponent multiply chain (the JAX package's
    integer power lowers to the same chain)."""
    x2 = x * x
    return x * (x2 * x2)
