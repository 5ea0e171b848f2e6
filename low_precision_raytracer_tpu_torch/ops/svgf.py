"""SVGF state and helpers (port of the parts of
`low_precision_raytracer_tpu/ops/svgf.py` the fused path uses): the
per-instance temporal state, the depth-gradient preprocess and the
edge-stopping power (the binary-squaring chain for an integer sigma_n).
The denoiser itself is the fused kernel chain of ops/svgf_kernels.py."""

from __future__ import annotations

from typing import NamedTuple

import torch

WAVELET_H = (3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)
GAUSS_G = (1.0 / 2.0, 1.0 / 4.0)


def _pow_int(x, n: int):
    """x**n via binary squaring (n static), the multiply chain the
    kernels use for max(0, n.n')^sigma_n."""
    if n <= 0:
        return torch.ones_like(x)
    result = None
    base = x
    while n > 0:
        if n & 1:
            result = base if result is None else result * base
        base = base * base
        n >>= 1
    return result


def pow_sigma_n(x, sigma_n: float):
    """x**sigma_n as the kernels take it: an integer exponent by
    `_pow_int`'s chain, any other by `torch.pow` (the JAX package's `**`
    in f32)."""
    if float(sigma_n).is_integer():
        return _pow_int(x, int(sigma_n))
    return torch.pow(x, float(sigma_n))


class SVGFState(NamedTuple):
    """Per-instance temporal state (GI-coloured or GI-white)."""

    miu1: torch.Tensor  # (H, W)
    miu2: torch.Tensor  # (H, W)
    color_history: torch.Tensor  # (H, W, 3)


def init_svgf_state(height, width, dtype, device) -> SVGFState:
    return SVGFState(
        miu1=torch.zeros((height, width), dtype=dtype, device=device),
        miu2=torch.zeros((height, width), dtype=dtype, device=device),
        color_history=torch.zeros((height, width, 3), dtype=dtype, device=device),
    )


def preprocess_normal_depth(normal, depth):
    """Depth gradients, forward difference at the border and backward
    elsewhere.  depth (H, W) -> grad (H, W, 2) = [d/dx, d/dy]."""
    gx = depth - torch.roll(depth, 1, dims=1)
    gx[:, 0] = depth[:, 1] - depth[:, 0]
    gy = depth - torch.roll(depth, 1, dims=0)
    gy[0, :] = depth[1, :] - depth[0, :]
    return torch.stack([gx, gy], dim=-1)
