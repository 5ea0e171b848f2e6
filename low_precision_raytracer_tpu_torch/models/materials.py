"""Materials: a copy of `low_precision_raytracer_tpu/models/materials.py`.

A host-side Material dataclass plus the packed SoA numpy table shipped to
the device.  Texture references wait with textures (ROADMAP queue 1
item 5).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Material:
    color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    emission: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    metallic: float = 0.0
    roughness: float = 1.0
    double_sided: bool = True


def pack_materials(materials: list[Material]) -> dict[str, np.ndarray]:
    """Pack to SoA numpy arrays (cast to the render dtype at upload)."""
    if not materials:
        materials = [Material()]
    return {
        "color": np.stack([np.asarray(m.color, np.float32) for m in materials]),
        "emission": np.stack([np.asarray(m.emission, np.float32) for m in materials]),
        "metallic": np.array([m.metallic for m in materials], np.float32),
        "roughness": np.array([m.roughness for m in materials], np.float32),
        "double_sided": np.array([m.double_sided for m in materials], np.bool_),
    }
