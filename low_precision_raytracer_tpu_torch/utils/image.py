"""Image quality measures, copied from `low_precision_raytracer_tpu/utils/image.py`
(`psnr`, `ssim`): numpy on arrays or CPU tensors, in float64."""

from __future__ import annotations

import numpy as np


def psnr(a, b, peak=1.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def ssim(a, b) -> float:
    """Global (single-window) SSIM over the luma channel — a coarse but
    dependency-free structural similarity for parity tests."""
    a = np.asarray(a, np.float64).mean(axis=-1)
    b = np.asarray(b, np.float64).mean(axis=-1)
    c1, c2 = 0.01**2, 0.03**2
    mu_a, mu_b = a.mean(), b.mean()
    va, vb = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return float(
        ((2 * mu_a * mu_b + c1) * (2 * cov + c2))
        / ((mu_a**2 + mu_b**2 + c1) * (va + vb + c2))
    )
