"""Colour composition + tonemap (port of
`low_precision_raytracer_tpu/ops/compose.py`)."""

from __future__ import annotations

import torch

from low_precision_raytracer_tpu_torch.config import DemoSettings


def write_clean_color(intensity0, intensity1, gi_multiplier0, demo: DemoSettings):
    """The NaN tag in gi_multiplier0[..., 2] selects the demodulated path:
    tagged pixels route bounce light into the (colored, white) SVGF
    inputs; untagged (mirror) pixels add it directly.
    -> (clean_color, mul_gi_colored, mul_gi_white)."""
    dt = intensity0.dtype
    zero = torch.zeros_like(intensity0)
    final = intensity0 if demo.add_direct_out else zero
    tagged = torch.isnan(gi_multiplier0[..., 2])[..., None]
    mul_gi_colored = torch.where(tagged, gi_multiplier0[..., 0:1] * intensity1, zero).to(dt)
    mul_gi_white = torch.where(tagged, gi_multiplier0[..., 1:2] * intensity1, zero).to(dt)
    if demo.add_direct_out:
        final = final + torch.where(tagged, zero, intensity1 * gi_multiplier0)
    return final.to(dt), mul_gi_colored, mul_gi_white


def add_denoised_color(clean, mul_gi_colored, mul_gi_white, albedo, demo: DemoSettings):
    """Re-modulate the denoised GI channels."""
    a = torch.ones_like(albedo) if demo.demodulate else albedo
    out = clean
    if demo.add_gi_colored:
        out = out + mul_gi_colored * a
    if demo.add_gi_white:
        out = out + mul_gi_white
    return out


def tonemap_gamma(color):
    """gamma 1/2.2 encode, f32 output clamped to [0, 1]."""
    c = torch.clamp(color.to(torch.float32), min=0.0)
    return torch.clamp(c ** (1.0 / 2.2), 0.0, 1.0)
