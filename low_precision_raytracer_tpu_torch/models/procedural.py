"""Procedural scenes: `cornell_box_scene` and the unit meshes it uses,
copied from `low_precision_raytracer_tpu/models/procedural.py`."""

from __future__ import annotations

import numpy as np

from low_precision_raytracer_tpu_torch.models.hierarchy import (
    LIGHT_POINT,
    CameraObject,
    LightObject,
    MeshObject,
    Object,
)
from low_precision_raytracer_tpu_torch.models.materials import Material
from low_precision_raytracer_tpu_torch.models.scene import HostScene, Mesh


def quad_mesh(size=1.0):
    """Unit quad in the XY plane facing +Z."""
    s = size / 2
    pos = np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    nrm = np.tile([0, 0, 1], (4, 1)).astype(np.float32)
    tan = np.tile([1, 0, 0], (4, 1)).astype(np.float32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return Mesh(pos, idx, normals=nrm, tangents=tan, uv0=uv, name="quad")


def cube_mesh(size=1.0):
    """Axis-aligned cube with outward normals, 12 triangles."""
    s = size / 2
    faces = []
    # (axis, sign): +x, -x, +y, -y, +z, -z
    for axis in range(3):
        for sign in (1.0, -1.0):
            n = np.zeros(3, np.float32)
            n[axis] = sign
            u = np.zeros(3, np.float32)
            u[(axis + 1) % 3] = 1.0
            v = np.cross(n, u)
            c = n * s
            corners = [c - u * s - v * s, c + u * s - v * s, c + u * s + v * s, c - u * s + v * s]
            faces.append((np.stack(corners), n, u))
    pos, nrm, tan, idx = [], [], [], []
    for i, (corners, n, u) in enumerate(faces):
        base = 4 * i
        pos.append(corners)
        nrm.append(np.tile(n, (4, 1)))
        tan.append(np.tile(u, (4, 1)))
        idx.append([[base, base + 1, base + 2], [base, base + 2, base + 3]])
    return Mesh(
        np.concatenate(pos).astype(np.float32),
        np.concatenate(idx).astype(np.int32),
        normals=np.concatenate(nrm).astype(np.float32),
        tangents=np.concatenate(tan).astype(np.float32),
        name="cube",
    )


def _mesh_node(scene: HostScene, mesh_id: int, material_id: int, name: str, t=None, r=None, s=None):
    mesh = scene.meshes[mesh_id]
    lo, hi = mesh.aabb
    node = MeshObject(
        name=name, mesh_id=mesh_id, material_id=material_id, aabb_lo=lo, aabb_hi=hi
    )
    if t is not None:
        node.translation = np.asarray(t, np.float32)
    if r is not None:
        node.rotation = np.asarray(r, np.float32)
    if s is not None:
        node.scale = np.asarray(s, np.float32)
    return node


def cornell_box_scene(light_intensity=30.0):
    """The Cornell box: 5 walls, 2 boxes (34 instance triangles), 1 point
    light."""
    scene = HostScene()
    quad = scene.add_mesh(quad_mesh(2.0))
    box = scene.add_mesh(cube_mesh(1.0))

    white = scene.add_material(Material(color=np.array([0.73, 0.73, 0.73], np.float32)))
    red = scene.add_material(Material(color=np.array([0.65, 0.05, 0.05], np.float32)))
    green = scene.add_material(Material(color=np.array([0.12, 0.45, 0.15], np.float32)))
    metal = scene.add_material(
        Material(color=np.array([0.8, 0.85, 0.9], np.float32), metallic=1.0, roughness=0.15)
    )

    scene.root = Object(name="root")
    r = scene.root
    sq2 = np.float32(np.sqrt(0.5))
    ws = [1.05, 1.05, 1]  # overlap wall seams so corner rays cannot escape
    r.add(_mesh_node(scene, quad, white, "floor", t=[0, -1, 0], r=[-sq2, 0, 0, sq2], s=ws))
    r.add(_mesh_node(scene, quad, white, "ceiling", t=[0, 1, 0], r=[sq2, 0, 0, sq2], s=ws))
    r.add(_mesh_node(scene, quad, white, "back", t=[0, 0, -1], s=ws))
    r.add(_mesh_node(scene, quad, red, "left", t=[-1, 0, 0], r=[0, sq2, 0, sq2], s=ws))
    r.add(_mesh_node(scene, quad, green, "right", t=[1, 0, 0], r=[0, -sq2, 0, sq2], s=ws))
    deg = np.pi / 180
    q18 = np.array([0, np.sin(18 * deg / 2), 0, np.cos(18 * deg / 2)], np.float32)
    r.add(_mesh_node(scene, box, white, "tall", t=[-0.35, -0.4, -0.35], r=q18, s=[0.55, 1.2, 0.55]))
    qm15 = np.array([0, np.sin(-15 * deg / 2), 0, np.cos(-15 * deg / 2)], np.float32)
    r.add(_mesh_node(scene, box, metal, "short", t=[0.4, -0.7, 0.35], r=qm15, s=[0.55, 0.6, 0.55]))

    light = LightObject(
        name="lamp",
        light_type=LIGHT_POINT,
        intensity=np.array([light_intensity] * 3, np.float32),
    )
    light.translation = np.array([0, 0.85, 0], np.float32)
    r.add(light)

    # narrow fov so the 2x2 back wall fills the frame from z=3.2; the small
    # x/y offset breaks exact pixel-centre/triangle-edge alignment
    cam = CameraObject(name="cam", fov_y=0.47)
    cam.translation = np.array([0.0131, 0.0077, 3.2], np.float32)
    r.add(cam)
    scene.active_camera = cam
    return scene
