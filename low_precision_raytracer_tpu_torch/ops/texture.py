"""Texture and skybox sampling (port of
`low_precision_raytracer_tpu/ops/texture.py`): `sample_texture`, the
bilinear wrap-addressed fetch from the flat texture atlas, and
`sample_skybox`.  Plain PyTorch, as the JAX package runs them in XLA."""

from __future__ import annotations

import torch

from low_precision_raytracer_tpu_torch.ops.sampling import direction_to_spherical


def has_textures(scene) -> bool:
    """Static gate: the atlas holds a real texture (its placeholder is one
    zero texel, `models/scene.py:_texture_atlas`)."""
    return scene.tex_data.shape[0] > 1


def _srgb_to_linear(c):
    """IEC 61966-2-1 decode."""
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def sample_texture(scene, tex_id, uv):
    """Bilinear wrap-addressed fetch -> (..., 4) f32 in [0, 1].  Each texel
    is decoded from sRGB (where its texture is sRGB) before the blend.  No
    flip: row floor(v h - 0.5) is read, v running down the image as glTF
    has it.

    tex_id: (...,) i32 atlas texture ids (ids < 0 read texture 0; callers
    mask them).  uv: (..., 2) any float dtype."""
    f32 = torch.float32
    tid = torch.clamp(tex_id.long(), 0, scene.tex_width.shape[0] - 1)
    w = scene.tex_width[tid]
    h = scene.tex_height[tid]
    off = scene.tex_offset[tid].long()
    srgb = scene.tex_srgb[tid][..., None]
    u = uv[..., 0].to(f32) * w - 0.5
    v = uv[..., 1].to(f32) * h - 0.5
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fu = (u - x0)[..., None]
    fv = (v - y0)[..., None]
    wl, hl = w.long(), h.long()

    def texel(x, y):
        idx = off + torch.remainder(y.long(), hl) * wl + torch.remainder(x.long(), wl)
        raw = scene.tex_data[idx].to(f32) / 255.0
        rgb = torch.where(srgb, _srgb_to_linear(raw[..., :3]), raw[..., :3])
        return torch.cat([rgb, raw[..., 3:4]], dim=-1)

    top = texel(x0, y0) * (1 - fu) + texel(x0 + 1, y0) * fu
    bot = texel(x0, y0 + 1) * (1 - fu) + texel(x0 + 1, y0 + 1) * fu
    return top * (1 - fv) + bot * fv


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
