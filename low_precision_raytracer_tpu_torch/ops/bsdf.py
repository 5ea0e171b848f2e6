"""BRDF library (port of `low_precision_raytracer_tpu/ops/bsdf.py`).

glTF metallic-roughness BRDF split into a ``(colored, white)`` pair: the
reflectance for base colour ``c`` is ``c * colored + white``.  Elementwise
over (...,) lanes in the dtype of the inputs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from low_precision_raytracer_tpu_torch.math.vec import dot, normalize, pow5


class BRDF(NamedTuple):
    colored: torch.Tensor  # (...,)
    white: torch.Tensor  # (...,)

    def get_brdf(self, base_color):
        return base_color * self.colored[..., None] + self.white[..., None]


def specular_brdf(V, H, L, N, alpha):
    """GGX NDF x height-correlated Smith visibility, with the
    cancellation-free NDF denominator (1 - nh^2) + nh^2*a2."""
    hl = dot(H, L)
    hv = dot(H, V)
    nh = dot(N, H)
    anl = torch.abs(dot(N, L))
    anv = torch.abs(dot(N, V))
    a2 = alpha * alpha
    div1 = anl + torch.sqrt(torch.clamp(a2 + (1.0 - a2) * anl * anl, min=0.0))
    div2 = anv + torch.sqrt(torch.clamp(a2 + (1.0 - a2) * anv * anv, min=0.0))
    nh2 = nh * nh
    denom = (1.0 - nh2) + nh2 * a2
    d_val = a2 / (math.pi * torch.clamp(denom * denom, min=1e-12))
    out = d_val / torch.clamp(div1, min=1e-12) / torch.clamp(div2, min=1e-12)
    bad = (nh <= 0) | (hl <= 0) | (hv <= 0)
    return torch.where(bad, torch.zeros_like(out), out)


def material_brdf(metallic, roughness, V, L, N) -> BRDF:
    """Dielectric (f0 = 0.04 Schlick + Lambert/pi) + metal GGX mix."""
    H = normalize(L + V)
    vh = dot(V, H)
    p5 = pow5(torch.clamp(1.0 - torch.abs(vh), min=0.0))
    alpha = roughness * roughness
    layer = specular_brdf(V, H, L, N, alpha)

    f0 = 0.04
    dielectric_fr = f0 + (1.0 - f0) * p5
    dielectric_white = dielectric_fr * layer
    dielectric_colored = (1.0 - dielectric_fr) * (1.0 / math.pi)

    metal_white = layer * p5
    metal_colored = layer * (1.0 - p5)

    colored = metal_colored * metallic + dielectric_colored * (1.0 - metallic)
    white = metal_white * metallic + dielectric_white * (1.0 - metallic)

    back = dot(L, N) < 0
    zero = torch.zeros_like(colored)
    return BRDF(torch.where(back, zero, colored), torch.where(back, zero, white))


def glassy_brdf(metallic, V, L, N) -> BRDF:
    """Mirror-bounce BRDF for the russian-roulette glassy lobe."""
    H = normalize(L + V)
    vh = dot(V, H)
    p5 = pow5(torch.clamp(1.0 - torch.abs(vh), min=0.0))

    f0 = 0.04
    dielectric_white = f0 + (1.0 - f0) * p5
    colored = (1.0 - p5) * metallic
    white = p5 * metallic + dielectric_white * (1.0 - metallic)

    back = dot(L, N) < 0
    zero = torch.zeros_like(colored)
    return BRDF(torch.where(back, zero, colored), torch.where(back, zero, white))
