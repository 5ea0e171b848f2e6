"""Importance sampling helpers (port of
`low_precision_raytracer_tpu/ops/sampling.py`): GGX half-vector sampling
with a uniform azimuth, the uniform hemisphere from two uniforms, and the
equirectangular direction -> uv map of the skybox."""

from __future__ import annotations

import math

import torch


def sample_ggx(a2, u1, u2):
    """GGX half-vector sample in tangent space (z = cos theta), with the
    cancellation-free denominator (1 - u1) + a2*u1.  a2 = roughness^4."""
    z = torch.sqrt((1.0 - u1) / ((1.0 - u1) + a2 * u1))
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def d_ggx_opti(nh, a2):
    """pi * tmp^2 with tmp = (1 - NH^2) + NH^2*a2 (cancellation-free)."""
    nh2 = nh * nh
    tmp = (1.0 - nh2) + nh2 * a2
    return math.pi * tmp * tmp


def pdf_ggx_reflect(nh, a2):
    return nh * a2 / d_ggx_opti(nh, a2)


def tangent_to_world(vec, n, t, b):
    return t * vec[..., 0:1] + b * vec[..., 1:2] + n * vec[..., 2:3]


def uniform_hemisphere_trig(normal, tangent, bitangent, u1, u2):
    """Uniform hemisphere direction from two uniforms in an orthonormal
    frame: z = u1, phi = 2*pi*u2.  Returns (dir, cosine = z)."""
    z = u1.to(normal.dtype)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * u2.to(normal.dtype)
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    v = tangent * x[..., None] + bitangent * y[..., None] + normal * z[..., None]
    return v, z


def direction_to_spherical(d, offset_x, offset_y):
    """Equirectangular direction -> (u, v) in [0, 1), always f32 (the
    reference's truncated 1/(2 pi) and 1/pi constants kept)."""
    f32 = torch.float32
    dx = d[..., 0].to(f32)
    dy = d[..., 1].to(f32)
    dz = torch.clamp(d[..., 2].to(f32), -1.0, 1.0)
    u = 0.1591 * torch.atan2(dy, dx) + 0.5 + offset_x.to(f32)
    v = 0.3183 * torch.asin(dz) + 0.5 + offset_y.to(f32)
    u = torch.remainder(u, 1.0)
    v = 1.0 - torch.remainder(v, 1.0)
    return u, v
