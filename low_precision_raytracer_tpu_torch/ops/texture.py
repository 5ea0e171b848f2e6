"""Skybox sampling (port of `low_precision_raytracer_tpu/ops/texture.py:
sample_skybox`).  `sample_texture` waits with textured scenes (ROADMAP
queue 1 item 5)."""

from __future__ import annotations

import torch

from low_precision_raytracer_tpu_torch.ops.sampling import direction_to_spherical


def sample_skybox(scene, frame, directions):
    """Equirectangular HDR sky fetch: bilinear, x wrapping, y clamped,
    scaled by the exposure.  One gather of the quad-packed footprint rows
    (`scene.sky_quad`, render dtype: bf16 quantises the HDR texels as the
    JAX package does) per direction.  (..., 3) -> (..., 3) f32."""
    f32 = torch.float32
    H, W = scene.sky_data.shape[0], scene.sky_data.shape[1]
    u, v = direction_to_spherical(directions, frame.sky_delta_x, frame.sky_delta_y)
    x = u * W - 0.5
    y = v * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fu = (x - x0)[..., None]
    fv = (y - y0)[..., None]
    xi = torch.remainder(x0.to(torch.int32), W)
    yi = torch.clamp(y0.to(torch.int32), 0, H - 1)
    idx = (yi * W + xi).reshape(-1).long()
    taps = scene.sky_quad[idx].reshape(directions.shape[:-1] + (4, 3)).to(f32)
    c00, c10, c01, c11 = taps[..., 0, :], taps[..., 1, :], taps[..., 2, :], taps[..., 3, :]
    out = (c00 * (1 - fu) + c10 * fu) * (1 - fv) + (c01 * (1 - fu) + c11 * fu) * fv
    return out * frame.sky_exposure
