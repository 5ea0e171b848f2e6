"""The shade stage (port of `low_precision_raytracer_tpu/ops/shade.py`).

Pure function over SoA pixel tensors: consumes a ShadeInput (the G-buffer
on the first round, the bounce hits after it) and emits the round's
emission/ambient intensity, the GI bounce ray with its BRDF multiplier
(NaN demodulation tag on round 0), and one shadow-ray command per light.

Shading computes in f32 (`cfg.shade_f32`).  The 7*R GI uniforms of a
round with GI are one f32 draw, passed in by the caller (`uniforms`), so
tests can feed the JAX package's draws.  With a skybox, `di_sky` carries
the sky radiance of the pixels no surface covers.  In a scene with
textures the base colour comes from the material's base-colour texture
(where it has one) at the uv set it names, on every round.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from low_precision_raytracer_tpu_torch.config import SKYBOX_COLOR, RenderConfig
from low_precision_raytracer_tpu_torch.math.vec import dot, normalize, reflect
from low_precision_raytracer_tpu_torch.models.hierarchy import LIGHT_DIRECTIONAL
from low_precision_raytracer_tpu_torch.ops.bsdf import glassy_brdf, material_brdf
from low_precision_raytracer_tpu_torch.ops.sampling import (
    pdf_ggx_reflect,
    sample_ggx,
    tangent_to_world,
    uniform_hemisphere_trig,
)
from low_precision_raytracer_tpu_torch.ops.texture import (
    has_textures,
    sample_skybox,
    sample_texture,
)

SHADE_INVALID = 0
SHADE_COMMON = 1
SHADE_SKYBOX = 2


class ShadeInput(NamedTuple):
    type: torch.Tensor  # (R,) i32
    position: torch.Tensor  # (R, 3)
    normal: torch.Tensor
    tangent: torch.Tensor
    color: torch.Tensor  # vertex colour
    material: torch.Tensor  # (R,) i32
    obj: torch.Tensor  # (R,) i32
    tri: torch.Tensor  # (R,) i32
    # f32 hit position o32 + t * d32: the light-geometry anchor (None ->
    # position in f32)
    position_f32: torch.Tensor | None = None
    # (R, 2) uv sets: None in a scene without textures
    uv0: torch.Tensor | None = None
    uv1: torch.Tensor | None = None


class LightCommands(NamedTuple):
    valid: torch.Tensor  # (R, L) bool
    direction: torch.Tensor  # (R, L, 3) f32
    max_t: torch.Tensor  # (R, L) f32
    multiplier: torch.Tensor  # (R, L, 3) f32


class ShadeOutputs(NamedTuple):
    intensity: torch.Tensor  # (R, 3)
    di_sky: torch.Tensor  # (R, 3) sky radiance (zeros without a skybox)
    albedo: torch.Tensor  # (R, 3) (first round; zeros otherwise)
    lights: LightCommands
    gi_valid: torch.Tensor  # (R,) bool
    gi_direction: torch.Tensor  # (R, 3)
    gi_multiplier: torch.Tensor  # (R, 3) (NaN tag in [2] on the first round)
    view_dir_out: torch.Tensor  # (R, 3) = -gi_direction
    skip_tri: torch.Tensor  # (R,) i32
    source: torch.Tensor  # (R, 3) f32 ray origin of both command kinds


def gbuffer_to_shade_input(g, position_f32=None) -> ShadeInput:
    return ShadeInput(
        type=torch.where(g["valid"], SHADE_COMMON, SHADE_INVALID).to(torch.int32),
        position=g["position"],
        position_f32=position_f32,
        normal=g["normal"],
        tangent=g["tangent"],
        color=g["color"],
        uv0=g.get("uv0"),
        uv1=g.get("uv1"),
        material=g["material"],
        obj=g["obj"],
        tri=g["tri"],
    )


def _gather_material(scene, mid):
    mid = mid.long()
    return dict(
        color=scene.mat_color[mid],
        emission=scene.mat_emission[mid],
        metallic=scene.mat_metallic[mid],
        roughness=scene.mat_roughness[mid],
        double_sided=scene.mat_double_sided[mid],
        tex_color=scene.mat_tex_color[mid],
        uv_color=scene.mat_uv_color[mid],
    )


def shade(scene, frame, sinput: ShadeInput, view_dir, *, cfg: RenderConfig,
          first_round: bool, no_gi: bool, uniforms=None) -> ShadeOutputs:
    """One shade pass over R pixels.  `uniforms`: (7 R,) f32 in [0, 1),
    required unless `no_gi`."""
    f32 = torch.float32
    dt = f32  # cfg.shade_f32 (check_supported refuses the dtype shader)
    up = lambda x: x.to(dt)
    sinput = sinput._replace(
        position=up(sinput.position), normal=up(sinput.normal),
        tangent=up(sinput.tangent), color=up(sinput.color),
    )
    view_dir = view_dir.to(dt)
    R = sinput.position.shape[0]
    dev = sinput.position.device
    zero3 = torch.zeros((R, 3), dtype=dt, device=dev)
    L = min(frame.n_lights, cfg.max_direct_lights)

    is_common = sinput.type == SHADE_COMMON

    # sky radiance: on the first round for pixels no surface covers, along
    # the primary direction; on a bounce for lanes whose GI ray escaped,
    # along it (= -view_dir)
    di_sky = zero3
    if scene.sky_valid:
        sky_dir = -view_dir if first_round else -normalize(view_dir)
        sky_rgb = sample_skybox(scene, frame, sky_dir).to(dt)
        sky_mask = sinput.type == (SHADE_INVALID if first_round else SHADE_SKYBOX)
        di_sky = torch.where(sky_mask[:, None], sky_rgb, zero3)

    mat = _gather_material(scene, sinput.material)
    for k in ("color", "emission", "metallic", "roughness"):
        mat[k] = mat[k].to(dt)

    # base colour: the texture (where the material has one) replaces the
    # factor, then the vertex colour multiplies
    color = mat["color"]
    if has_textures(scene):
        tex_uv = torch.where((mat["uv_color"] == 0)[:, None], sinput.uv0.to(dt),
                             sinput.uv1.to(dt))
        tex_rgba = sample_texture(scene, mat["tex_color"], tex_uv)
        color = torch.where((mat["tex_color"] >= 0)[:, None], tex_rgba[:, :3].to(dt), color)
    color = color * sinput.color

    # N, V; double-sided flip or reject
    raw_normal = sinput.normal
    v_dot_n = dot(view_dir, raw_normal)
    flip = (v_dot_n < 0) & mat["double_sided"]
    rejected = (v_dot_n < 0) & ~mat["double_sided"]
    normal = torch.where(flip[:, None], -raw_normal, raw_normal)
    valid = is_common & ~rejected

    # tangent frame re-orthogonalization
    bitangent = normalize(torch.linalg.cross(raw_normal, sinput.tangent, dim=-1))
    tangent = normalize(torch.linalg.cross(bitangent, raw_normal, dim=-1))

    if no_gi:  # the NO_GI fake ambient replaces emission
        skyc = torch.tensor(SKYBOX_COLOR, dtype=dt, device=dev)
        intensity = skyc * color * 0.5
    else:
        intensity = mat["emission"]
    intensity = torch.where(valid[:, None], intensity, zero3)
    albedo = torch.where(valid[:, None], color, zero3) if first_round else zero3

    if not no_gi:
        if uniforms is None or tuple(uniforms.shape) != (7 * R,):
            raise ValueError(f"shade: a GI round needs (7*R,) = ({7 * R},) uniforms")
        us = uniforms.to(dt)
        r_mirror, r_spec, r_metal, u_ggx1, u_ggx2, uh1, uh2 = (
            us[i * R : (i + 1) * R] for i in range(7))
        metallic = mat["metallic"]
        roughness = mat["roughness"]
        mirror_dir = normalize(reflect(view_dir, normal))
        lo_rough = roughness < 0.1

        # one hemisphere draw serves both roughness branches
        diff_dir, cos_diff = uniform_hemisphere_trig(normal, tangent, bitangent, uh1, uh2)

        # low-roughness lobes: metallic russian-roulette mirror, glassy specular
        g_mirror = glassy_brdf(metallic, view_dir, mirror_dir, normal)
        mult_a = g_mirror.get_brdf(color) / metallic[:, None]
        pdf_b = (1.0 - metallic) * 0.6
        take_a = r_mirror < metallic
        take_b = ~take_a & (r_spec < 0.6)

        # high-roughness lobes: GGX importance / uniform hemisphere mix
        a = roughness * roughness
        a2 = a * a
        h_t = sample_ggx(a2, u_ggx1, u_ggx2)
        h_w = normalize(tangent_to_world(h_t, normal, tangent, bitangent))
        ggx_dir = reflect(view_dir, h_w)
        ggx_cos = torch.clamp(dot(ggx_dir, h_w), min=0.05)
        pdf_ggx = pdf_ggx_reflect(h_t[..., 2], a2) * metallic / (4 * ggx_cos)
        pdf_diff = (0.5 / math.pi) * (1.0 - metallic)

        take_ggx = r_metal < metallic
        dir_hi = normalize(torch.where(take_ggx[:, None], ggx_dir, diff_dir))
        cos_sel = torch.where(take_ggx, ggx_cos, cos_diff)
        pdf_sel = torch.where(take_ggx, pdf_ggx, pdf_diff)

        # one material_brdf chain at the per-ray selected direction
        eval_dir = torch.where(lo_rough[:, None], diff_dir, dir_hi)
        brdf_e = material_brdf(metallic, roughness, view_dir, eval_dir, normal)

        # the reference's low-roughness hemisphere lobe uses cos * 2pi
        # without the lobe-selection probability (reproduced as is)
        mult_c_scalar = cos_diff * (2.0 * math.pi)
        mult_hi_scalar = cos_sel / pdf_sel
        e_scalar = torch.where(lo_rough, mult_c_scalar, mult_hi_scalar)
        if first_round:
            nan = torch.full((R,), float("nan"), dtype=dt, device=dev)
            mult_b = torch.stack([g_mirror.colored / pdf_b, g_mirror.white / pdf_b, nan], dim=-1)
            mult_e = torch.stack([brdf_e.colored * e_scalar, brdf_e.white * e_scalar, nan], dim=-1)
        else:
            mult_b = g_mirror.get_brdf(color) / pdf_b[:, None]
            mult_e = brdf_e.get_brdf(color) * e_scalar[:, None]

        dir_lo = torch.where((take_a | take_b)[:, None], mirror_dir, diff_dir)
        mult_lo = torch.where(take_a[:, None], mult_a,
                              torch.where(take_b[:, None], mult_b, mult_e))
        gi_direction = torch.where(lo_rough[:, None], dir_lo, dir_hi)
        gi_multiplier = torch.where(lo_rough[:, None], mult_lo, mult_e)
        gi_valid = valid
        gi_multiplier = torch.where(valid[:, None], gi_multiplier, zero3)
    else:
        gi_direction = torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=dev).expand(R, 3)
        gi_multiplier = zero3
        gi_valid = torch.zeros((R,), dtype=torch.bool, device=dev)

    view_dir_out = -gi_direction

    # direct-light commands: light geometry in f32 from the f32 hit position
    pos32 = sinput.position_f32 if sinput.position_f32 is not None else sinput.position.to(f32)
    n32 = normal.to(f32)
    rough_di = torch.clamp(mat["roughness"], min=0.10)
    up_z = torch.tensor([0.0, 0.0, 1.0], dtype=f32, device=dev).expand(R, 3)
    l_valid, l_dir, l_maxt, l_mult = [], [], [], []
    for i in range(L):
        is_dir = frame.light_type[i] == LIGHT_DIRECTIONAL
        lpos = frame.light_pos[i].to(f32)
        ldirw = frame.light_dir[i].to(f32)
        lint = frame.light_intensity[i].to(f32)
        dvec = lpos - pos32
        dist2 = dot(dvec, dvec)
        pdir = normalize(dvec)
        ddir = -normalize(ldirw)
        ldir_i = torch.where(is_dir, ddir, pdir)
        cosine = dot(ldir_i, n32)
        b32 = material_brdf(mat["metallic"].to(f32), rough_di.to(f32),
                            view_dir.to(f32), ldir_i, n32).get_brdf(color.to(f32))
        point_mult = (cosine / dist2 / 10.0)[:, None] * b32 * lint
        dir_mult = cosine[:, None] * b32 * lint
        mult_i = torch.where(is_dir, dir_mult, point_mult)
        maxt_i = torch.where(is_dir, torch.full_like(dist2, 1000.0), torch.sqrt(dist2))
        ok = valid & frame.light_valid[i] & (cosine >= 0)
        l_valid.append(ok)
        l_dir.append(torch.where(ok[:, None], ldir_i, up_z))
        l_maxt.append(torch.where(ok, maxt_i, torch.zeros_like(maxt_i)))
        l_mult.append(torch.where(ok[:, None], mult_i, torch.zeros_like(mult_i)))
    if L > 0:
        lights = LightCommands(
            valid=torch.stack(l_valid, dim=1),
            direction=torch.stack(l_dir, dim=1),
            max_t=torch.stack(l_maxt, dim=1),
            multiplier=torch.stack(l_mult, dim=1),
        )
    else:
        lights = LightCommands(
            valid=torch.zeros((R, 0), dtype=torch.bool, device=dev),
            direction=torch.zeros((R, 0, 3), dtype=f32, device=dev),
            max_t=torch.zeros((R, 0), dtype=f32, device=dev),
            multiplier=torch.zeros((R, 0, 3), dtype=f32, device=dev),
        )

    return ShadeOutputs(
        intensity=intensity,
        di_sky=di_sky,
        albedo=albedo,
        lights=lights,
        gi_valid=gi_valid,
        gi_direction=gi_direction,
        gi_multiplier=gi_multiplier,
        view_dir_out=view_dir_out,
        skip_tri=torch.where(valid, sinput.tri, -1).to(torch.int32),
        source=pos32,
    )
