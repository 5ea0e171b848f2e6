"""Materials: a copy of `low_precision_raytracer_tpu/models/materials.py`.

A host-side Material dataclass plus the packed SoA numpy table shipped to
the device.  Texture references are ids into the scene's texture atlas
(`models/scene.py:build_scene_arrays`); NO_TEX means "use the constant
factor".
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

NO_TEX = -1


@dataclass
class Material:
    color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    emission: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    metallic: float = 0.0
    roughness: float = 1.0
    double_sided: bool = True

    # texture id (NO_TEX = none) + uv set selector (0/1)
    tex_color: int = NO_TEX
    uv_color: int = 0
    tex_emission: int = NO_TEX
    uv_emission: int = 0
    tex_metallic_roughness: int = NO_TEX
    uv_metallic_roughness: int = 0
    # glTF metallicRoughness channel mapping: G=roughness, B=metallic
    channel_roughness: int = 1
    channel_metallic: int = 2


def pack_materials(materials: list[Material]) -> dict[str, np.ndarray]:
    """Pack to SoA numpy arrays (cast to the render dtype at upload)."""
    if not materials:
        materials = [Material()]
    ints = lambda name: np.array([getattr(m, name) for m in materials], np.int32)
    return {
        "color": np.stack([np.asarray(m.color, np.float32) for m in materials]),
        "emission": np.stack([np.asarray(m.emission, np.float32) for m in materials]),
        "metallic": np.array([m.metallic for m in materials], np.float32),
        "roughness": np.array([m.roughness for m in materials], np.float32),
        "double_sided": np.array([m.double_sided for m in materials], np.bool_),
        "tex_color": ints("tex_color"),
        "uv_color": ints("uv_color"),
        "tex_emission": ints("tex_emission"),
        "uv_emission": ints("uv_emission"),
        "tex_mr": ints("tex_metallic_roughness"),
        "uv_mr": ints("uv_metallic_roughness"),
        "channel_roughness": ints("channel_roughness"),
        "channel_metallic": ints("channel_metallic"),
    }
