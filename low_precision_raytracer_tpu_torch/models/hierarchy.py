"""Scene hierarchy, static part: a copy of
`low_precision_raytracer_tpu/models/hierarchy.py` without the animation
samplers (animated scenes wait, ROADMAP queue 1 item 4).

Host-side object tree with TRS + quaternion transforms and the per-frame
flatten to render arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from low_precision_raytracer_tpu_torch.math.hostmath import (
    invert_rigid,
    look_at,
    trs_matrix,
)

# light types
LIGHT_SPOT = 0
LIGHT_POINT = 1
LIGHT_DIRECTIONAL = 2


@dataclass
class Object:
    """Hierarchy node."""

    name: str = ""
    translation: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = field(
        default_factory=lambda: np.array([0, 0, 0, 1], np.float32)
    )  # quat (x, y, z, w)
    scale: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    children: list = field(default_factory=list)
    parent: "Object | None" = None

    def add(self, child: "Object") -> "Object":
        child.parent = self
        self.children.append(child)
        return child

    def transform_matrix(self) -> np.ndarray:
        """T * R * S, with the rotation normalized first."""
        t = np.asarray(self.translation, np.float32)
        q = np.asarray(self.rotation, np.float32)
        s = np.asarray(self.scale, np.float32)
        n = np.linalg.norm(q)
        if n > 0:
            q = q / n
        return trs_matrix(t, q, s)

    def local_to_world(self) -> np.ndarray:
        m = self.transform_matrix()
        node = self.parent
        while node is not None:
            m = node.transform_matrix() @ m
            node = node.parent
        return m


@dataclass
class MeshObject(Object):
    """A node instancing a mesh."""

    mesh_id: int = 0
    material_id: int = 0
    aabb_lo: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    aabb_hi: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))

    def world_aabb(self, transform: np.ndarray):
        """Transform the 8 box corners."""
        bounds = np.stack([self.aabb_lo, self.aabb_hi])
        corners = np.array(
            [
                [bounds[(i >> 0) & 1][0], bounds[(i >> 1) & 1][1], bounds[(i >> 2) & 1][2]]
                for i in range(8)
            ],
            np.float32,
        )
        h = np.concatenate([corners, np.ones((8, 1), np.float32)], axis=1)
        w = (transform @ h.T).T
        w = w[:, :3] / w[:, 3:4]
        return w.min(axis=0), w.max(axis=0)


@dataclass
class CameraObject(Object):
    """Perspective camera node."""

    fov_y: float = np.pi / 2
    aspect_ratio: float = 1.0
    z_near: float = 0.1
    z_far: float = 100.0

    def world_to_view(self, transform: np.ndarray) -> np.ndarray:
        """lookAt through the node transform."""

        def apply(p, w):
            h = transform @ np.array([*p, w], np.float32)
            return h[:3] / (h[3] if w == 1.0 else 1.0)

        eye = apply((0, 0, 0), 1.0)
        center = apply((0, 0, -1), 1.0)
        up = apply((0, 1, 0), 0.0)
        return look_at(eye, center, up)


@dataclass
class LightObject(Object):
    """Punctual light node."""

    light_type: int = LIGHT_POINT
    intensity: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))


@dataclass
class FlatScene:
    """Per-frame flattened scene: numpy host arrays ready for upload."""

    obj_l2w: np.ndarray  # (O, 4, 4) f32
    obj_w2l: np.ndarray  # (O, 4, 4) f32
    obj_mesh: np.ndarray  # (O,) i32
    obj_material: np.ndarray  # (O,) i32
    obj_aabb_lo: np.ndarray  # (O, 3) f32 world space
    obj_aabb_hi: np.ndarray  # (O, 3) f32
    light_type: np.ndarray  # (L,) i32
    light_pos: np.ndarray  # (L, 3) f32
    light_dir: np.ndarray  # (L, 3) f32
    light_intensity: np.ndarray  # (L, 3) f32
    cam_l2w: np.ndarray  # (4, 4) f32
    cam_w2v: np.ndarray  # (4, 4) f32
    cam_fov_y: float = np.pi / 2
    cam_z_near: float = 0.1
    cam_z_far: float = 100.0


def build_flat_scene(root: Object, active_camera: CameraObject | None) -> FlatScene:
    """Flatten the hierarchy into per-object / per-light arrays."""
    objs, lights = [], []
    cam = {}

    def rec(node: Object, transform: np.ndarray):
        new_t = transform @ node.transform_matrix()
        if isinstance(node, MeshObject):
            lo, hi = node.world_aabb(new_t)
            objs.append((new_t, invert_rigid(new_t), node.mesh_id,
                         node.material_id, lo, hi))
        elif isinstance(node, LightObject):
            d = new_t @ np.array([0, 0, -1, 0], np.float32)
            d = d[:3] / np.linalg.norm(d[:3])
            lights.append((node.light_type, new_t[:3, 3].copy(), d, node.intensity))
        elif isinstance(node, CameraObject) and node is active_camera:
            cam["l2w"] = new_t
            cam["w2v"] = node.world_to_view(new_t)
        for child in node.children:
            rec(child, new_t)

    rec(root, np.eye(4, dtype=np.float32))
    if active_camera is None:
        raise ValueError("no active camera")
    if "l2w" not in cam:  # active camera not in the tree: use its own L2W
        m = active_camera.local_to_world()
        cam["l2w"] = m
        cam["w2v"] = active_camera.world_to_view(m)
    if not objs:
        raise ValueError("scene contains no mesh objects")

    def stack3(i):
        if not lights:
            return np.zeros((0, 3), np.float32)
        return np.stack([l[i] for l in lights]).astype(np.float32)

    return FlatScene(
        obj_l2w=np.stack([o[0] for o in objs]).astype(np.float32),
        obj_w2l=np.stack([o[1] for o in objs]).astype(np.float32),
        obj_mesh=np.array([o[2] for o in objs], np.int32),
        obj_material=np.array([o[3] for o in objs], np.int32),
        obj_aabb_lo=np.stack([o[4] for o in objs]).astype(np.float32),
        obj_aabb_hi=np.stack([o[5] for o in objs]).astype(np.float32),
        light_type=np.array([l[0] for l in lights], np.int32).reshape(-1),
        light_pos=stack3(1),
        light_dir=stack3(2),
        light_intensity=stack3(3),
        cam_l2w=cam["l2w"].astype(np.float32),
        cam_w2v=cam["w2v"].astype(np.float32),
        cam_fov_y=float(active_camera.fov_y),
        cam_z_near=float(active_camera.z_near),
        cam_z_far=float(active_camera.z_far),
    )
