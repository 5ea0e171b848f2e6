"""The textured Sponza-class scene: `sponza_like_scene()`'s geometry,
lights and camera written as a `.glb` with PNG textures, and loaded back.

    python3 -m low_precision_raytracer_tpu_torch.tools.textured_scene OUT.glb [TEX_SIZE]

Only numpy, `zlib`, `struct` and `json` write the file (`utils/png.py`
encodes the images).  What it holds:

- uv0 is a box projection of each mesh's local positions on the axis its
  normal is closest to, repeated several times a face and centred on 0,
  so negative coordinates test the wrap; TEXCOORD_1 is uv0 scaled by 2;
- each of the four materials has a TEX_SIZE^2 sRGB base-colour texture (a
  seeded checker of two colours plus noise, so a flip, a transpose or a
  channel swap shows) and a linear metallic-roughness texture, which the
  loader reads and shade never samples.  The glaze material reads its base
  colour through texCoord 1, and the gold material's metallic-roughness
  texture is the stone material's base-colour texture, so the loader's
  (texture, sRGB) cache makes two atlas entries of it;
- the PNG rows cycle through all five filter types; base-colour images are
  RGBA, metallic-roughness ones RGB.

glTF has no sky: `textured_sponza_scene` loads the file and adds
`sponza_like_scene`'s panorama.
"""

from __future__ import annotations

import json
import struct
import sys

import numpy as np

from low_precision_raytracer_tpu_torch.models.hierarchy import (
    LIGHT_DIRECTIONAL,
    LightObject,
    MeshObject,
)
from low_precision_raytracer_tpu_torch.models.procedural import procedural_sky, sponza_like_scene
from low_precision_raytracer_tpu_torch.models.scene import HostScene, Skybox
from low_precision_raytracer_tpu_torch.utils.png import encode_png

# box-projection repeats per mesh of sponza_like_scene: floor quad, pillar
# cube, ball
UV_REPEAT = (6.0, 4.0, 2.0)
# the material that samples its base colour through TEXCOORD_1, and the
# material whose metallic-roughness texture is another's base colour
UV1_MATERIAL = 3  # glaze
SHARED_MR = (2, 1)  # gold's metallic-roughness = stone's base colour
CYCLE_FILTERS = (0, 1, 2, 3, 4)


def box_uv(positions: np.ndarray, normals: np.ndarray, repeat: float) -> np.ndarray:
    """Box projection: the two coordinates off each vertex normal's largest
    axis, times `repeat`.  (V, 3), (V, 3) -> (V, 2) f32."""
    ax = np.argmax(np.abs(normals), axis=1)
    a1, a2 = (ax + 1) % 3, (ax + 2) % 3
    rows = np.arange(len(positions))
    return (np.stack([positions[rows, a1], positions[rows, a2]], axis=1)
            * np.float32(repeat)).astype(np.float32)


def checker_texture(size: int, colors, rng, cells: int = 8, alpha: bool = True) -> np.ndarray:
    """A `cells` x `cells` checker of two RGB colours plus uniform noise of
    +-24, as (size, size, 4 or 3) uint8."""
    yy, xx = np.mgrid[0:size, 0:size]
    cell = ((yy * cells // size) + (xx * cells // size)) % 2
    c = np.asarray(colors, np.int16)[cell]
    img = np.clip(c + rng.integers(-24, 25, c.shape), 0, 255).astype(np.uint8)
    if alpha:
        img = np.concatenate([img, np.full((size, size, 1), 255, np.uint8)], axis=2)
    return img


class _GLB:
    """A minimal glTF 2.0 binary writer."""

    def __init__(self):
        self.bin = bytearray()
        self.gltf = {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": []}],
                     "nodes": [], "meshes": [], "materials": [], "textures": [], "images": [],
                     "accessors": [], "bufferViews": [], "buffers": []}

    def view(self, data: bytes) -> int:
        self.bin.extend(b"\0" * (-len(self.bin) % 4))
        self.gltf["bufferViews"].append(
            {"buffer": 0, "byteOffset": len(self.bin), "byteLength": len(data)})
        self.bin.extend(data)
        return len(self.gltf["bufferViews"]) - 1

    def accessor(self, a: np.ndarray, type_: str, component: int) -> int:
        acc = {"bufferView": self.view(np.ascontiguousarray(a).tobytes()),
               "componentType": component, "count": int(a.shape[0]), "type": type_}
        if type_ == "VEC3":
            acc["min"] = a.min(axis=0).tolist()
            acc["max"] = a.max(axis=0).tolist()
        self.gltf["accessors"].append(acc)
        return len(self.gltf["accessors"]) - 1

    def image(self, png: bytes) -> int:
        self.gltf["images"].append({"bufferView": self.view(png), "mimeType": "image/png"})
        self.gltf["textures"].append({"source": len(self.gltf["images"]) - 1})
        return len(self.gltf["textures"]) - 1

    def node(self, **kw) -> int:
        self.gltf["nodes"].append(kw)
        self.gltf["scenes"][0]["nodes"].append(len(self.gltf["nodes"]) - 1)
        return len(self.gltf["nodes"]) - 1

    def write(self, path: str) -> None:
        self.bin.extend(b"\0" * (-len(self.bin) % 4))
        self.gltf["buffers"] = [{"byteLength": len(self.bin)}]
        js = json.dumps(self.gltf).encode()
        js += b" " * (-len(js) % 4)
        with open(path, "wb") as f:
            f.write(struct.pack("<4sII", b"glTF", 2, 28 + len(js) + len(self.bin)))
            f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
            f.write(struct.pack("<II", len(self.bin), 0x004E4942) + bytes(self.bin))


def _trs(node) -> dict:
    return {"translation": node.translation.astype(float).tolist(),
            "rotation": node.rotation.astype(float).tolist(),
            "scale": node.scale.astype(float).tolist()}


def write_textured_sponza(path: str, tex_size: int = 1024, seed: int = 0,
                          pillar_grid: int = 4, sphere_subdiv: int = 2) -> None:
    """Write `sponza_like_scene(pillar_grid, sphere_subdiv)` (without its
    sky) as a textured `.glb` at `path`."""
    src = sponza_like_scene(pillar_grid, sphere_subdiv, with_skybox=False)
    rng = np.random.default_rng(seed)
    g = _GLB()
    # base colour: RGBA sRGB; metallic-roughness: RGB linear (G roughness, B metallic)
    base = [g.image(encode_png(checker_texture(tex_size, cols, rng), 6, 8,
                               filters=CYCLE_FILTERS))
            for cols in (((200, 190, 170), (90, 80, 70)), ((230, 170, 60), (120, 70, 20)),
                         ((60, 110, 220), (230, 235, 240)), ((150, 150, 150), (40, 60, 50)))]
    mr = {m: g.image(encode_png(checker_texture(tex_size, ((0, 200, 30), (0, 60, 220)), rng,
                                                alpha=False), 2, 8, filters=CYCLE_FILTERS))
          for m in range(len(src.materials)) if m != SHARED_MR[0]}
    mr[SHARED_MR[0]] = base[SHARED_MR[1]]
    for m, mat in enumerate(src.materials):
        g.gltf["materials"].append({
            "pbrMetallicRoughness": {
                "baseColorFactor": [*np.asarray(mat.color, float).tolist(), 1.0],
                "metallicFactor": float(mat.metallic),
                "roughnessFactor": float(mat.roughness),
                "baseColorTexture": {"index": base[m],
                                     "texCoord": 1 if m == UV1_MATERIAL else 0},
                "metallicRoughnessTexture": {"index": mr[m]},
            },
            "doubleSided": bool(mat.double_sided),
        })
    geometry = []
    for i, mesh in enumerate(src.meshes):
        uv0 = box_uv(mesh.positions, mesh.normals, UV_REPEAT[i])
        t4 = np.concatenate([mesh.tangents, np.ones((len(mesh.tangents), 1), np.float32)],
                            axis=1)
        geometry.append({
            "POSITION": g.accessor(mesh.positions, "VEC3", 5126),
            "NORMAL": g.accessor(mesh.normals, "VEC3", 5126),
            "TANGENT": g.accessor(t4, "VEC4", 5126),
            "TEXCOORD_0": g.accessor(uv0, "VEC2", 5126),
            "TEXCOORD_1": g.accessor(uv0 * np.float32(2), "VEC2", 5126),
        })
        geometry[-1]["indices"] = g.accessor(mesh.indices.astype(np.uint32).reshape(-1, 1),
                                             "SCALAR", 5125)
    meshes = {}  # (mesh id, material id) -> glTF mesh
    lights = []
    for node in src.root.walk():
        if isinstance(node, MeshObject):
            key = (node.mesh_id, node.material_id)
            if key not in meshes:
                attrs = dict(geometry[node.mesh_id])
                idx = attrs.pop("indices")
                g.gltf["meshes"].append({"name": src.meshes[node.mesh_id].name, "primitives": [
                    {"attributes": attrs, "indices": idx, "material": node.material_id,
                     "mode": 4}]})
                meshes[key] = len(g.gltf["meshes"]) - 1
            g.node(name=node.name, mesh=meshes[key], **_trs(node))
        elif isinstance(node, LightObject):
            peak = float(np.max(node.intensity))
            lights.append({"type": "directional" if node.light_type == LIGHT_DIRECTIONAL
                           else "point", "color": (node.intensity / peak).astype(float).tolist(),
                           "intensity": peak})
            g.node(name=node.name, extensions={"KHR_lights_punctual": {"light": len(lights) - 1}},
                   **_trs(node))
    cam = src.active_camera
    g.gltf["cameras"] = [{"type": "perspective", "perspective": {
        "yfov": float(cam.fov_y), "znear": float(cam.z_near), "zfar": float(cam.z_far),
        "aspectRatio": float(cam.aspect_ratio)}}]
    g.node(name=cam.name, camera=0, **_trs(cam))
    g.gltf["extensions"] = {"KHR_lights_punctual": {"lights": lights}}
    g.gltf["extensionsUsed"] = ["KHR_lights_punctual"]
    g.write(path)


def textured_sponza_scene(path: str) -> HostScene:
    """Load the file `write_textured_sponza` wrote and add the sky."""
    from low_precision_raytracer_tpu_torch.models.gltf import load_gltf

    scene = load_gltf(path)
    scene.skybox = Skybox(data=procedural_sky(64, 128), exposure=1.0)
    return scene


if __name__ == "__main__":
    write_textured_sponza(sys.argv[1], *(int(a) for a in sys.argv[2:3]))
