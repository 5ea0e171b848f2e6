"""Scene hierarchy: a copy of `low_precision_raytracer_tpu/models/hierarchy.py`.

Host-side object tree with TRS + quaternion transforms, keyframe
animation samplers (`Sampler`, `Animation`, `Object.apply_animation`) and
the per-frame flatten to render arrays.  The camera is a node like any
other: a camera path is a `Sampler` on its `animation`.
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
class Sampler:
    """Keyframe sampler with fmod looping.  Quaternion channels use
    component lerp, not slerp, on purpose (the reference's behaviour)."""

    times: np.ndarray | None = None  # (K,)
    values: np.ndarray | None = None  # (K, D)
    step: bool = False  # STEP interpolation: hold values[i] over segment i

    def sample(self, time: float, default):
        if self.times is None or len(self.times) == 0:
            return np.asarray(default, np.float32)
        if len(self.times) == 1:
            return np.asarray(self.values[0], np.float32)
        max_time = float(self.times[-1])
        if time >= max_time:
            time = float(np.fmod(time, max_time))
        # first segment i with times[i+1] >= time
        i = int(np.searchsorted(self.times[1:], time, side="left"))
        i = min(i, len(self.times) - 2)
        t0, t1 = float(self.times[i]), float(self.times[i + 1])
        if self.step:
            return np.asarray(self.values[i], np.float32)
        # a zero-length segment (duplicated keyframe times) takes its end value
        u = (time - t0) / (t1 - t0) if t1 > t0 else 1.0
        return ((1.0 - u) * self.values[i] + u * self.values[i + 1]).astype(np.float32)


@dataclass
class Animation:
    translation: Sampler = field(default_factory=Sampler)
    scale: Sampler = field(default_factory=Sampler)
    rotation: Sampler = field(default_factory=Sampler)  # quats (x, y, z, w)


@dataclass
class Object:
    """Hierarchy node."""

    name: str = ""
    translation: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = field(
        default_factory=lambda: np.array([0, 0, 0, 1], np.float32)
    )  # quat (x, y, z, w)
    scale: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    animation: Animation = field(default_factory=Animation)
    children: list = field(default_factory=list)
    parent: "Object | None" = None

    def add(self, child: "Object") -> "Object":
        child.parent = self
        self.children.append(child)
        return child

    def apply_animation(self, time: float) -> None:
        """Sample this node's TRS at `time`, then its children's."""
        self.translation = self.animation.translation.sample(time, self.translation)
        self.scale = self.animation.scale.sample(time, self.scale)
        self.rotation = np.asarray(self.animation.rotation.sample(time, self.rotation),
                                   np.float32)
        for child in self.children:
            child.apply_animation(time)

    def transform_matrix(self) -> np.ndarray:
        """T * R * S, with the rotation normalized first.  Cached on the
        exact TRS bytes, so a node that does not move costs one compute in
        all; the returned matrix is shared and must not be mutated."""
        t = np.asarray(self.translation, np.float32)
        q = np.asarray(self.rotation, np.float32)
        s = np.asarray(self.scale, np.float32)
        key = (t.tobytes(), q.tobytes(), s.tobytes())
        hit = self.__dict__.get("_tm_cache")
        if hit is not None and hit[0] == key:
            return hit[1]
        n = np.linalg.norm(q)
        if n > 0:
            q = q / n
        m = trs_matrix(t, q, s)
        self._tm_cache = (key, m)
        return m

    def local_to_world(self) -> np.ndarray:
        m = self.transform_matrix()
        node = self.parent
        while node is not None:
            m = node.transform_matrix() @ m
            node = node.parent
        return m

    def search(self, name: str) -> "Object | None":
        if self.name == name:
            return self
        for child in self.children:
            found = child.search(name)
            if found is not None:
                return found
        return None

    def walk(self):
        yield self
        for child in self.children:
            yield from child.walk()


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
    """Punctual light node.  The cone angles and the range are loaded from
    glTF and not rendered: a spot light renders as a point light."""

    light_type: int = LIGHT_POINT
    intensity: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    inner_cone_angle: float = 0.0
    outer_cone_angle: float = np.pi / 4
    maximum_distance: float = 1e5


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


# the root's parent transform: shared, never mutated
_IDENTITY = np.eye(4, dtype=np.float32)
_IDENTITY.flags.writeable = False


def _world_matrix(node: Object, transform: np.ndarray) -> np.ndarray:
    """transform @ the node's local matrix, the same array as last time
    while both factors are the same arrays (shared, never mutated)."""
    tm = node.transform_matrix()
    hit = node.__dict__.get("_world_cache")
    if hit is not None and hit[0] is transform and hit[1] is tm:
        return hit[2]
    new_t = transform @ tm
    node._world_cache = (transform, tm, new_t)
    return new_t


def _stacked_objects(root: Object, objs: list):
    """(l2w, w2l, aabb_lo, aabb_hi) stacked over the objects, read-only;
    the previous frame's stacks while every object's arrays are the same
    (a frame in which no object moved)."""
    hit = root.__dict__.get("_stack_cache")
    if hit is not None and len(hit[0]) == len(objs) and all(
            a[0] is b[0] and a[1] is b[1] and a[4] is b[4] and a[5] is b[5]
            for a, b in zip(hit[0], objs)):
        return hit[1]
    out = tuple(np.stack([o[i] for o in objs]).astype(np.float32) for i in (0, 1, 4, 5))
    for a in out:
        a.flags.writeable = False
    root._stack_cache = (objs, out)
    return out


def build_flat_scene(root: Object, active_camera: CameraObject | None) -> FlatScene:
    """Flatten the hierarchy into per-object / per-light arrays.  Nodes
    that did not move reuse their world matrices, inverses and boxes, and
    a frame in which no object moved reuses the previous frame's stacked
    object arrays (read-only)."""
    objs, lights = [], []
    cam = {}

    def derived(node: Object, new_t: np.ndarray, fn):
        """fn(new_t), kept while the world matrix is the same array, or
        one of the same bytes (a node that does not move skips it)."""
        hit = node.__dict__.get("_flat_cache")
        if hit is not None and (hit[0] is new_t or hit[1] == new_t.tobytes()):
            return hit[2]
        value = fn(new_t)
        node._flat_cache = (new_t, new_t.tobytes(), value)
        return value

    def light_geometry(m):
        d = m @ np.array([0, 0, -1, 0], np.float32)
        return m[:3, 3].copy(), d[:3] / np.linalg.norm(d[:3])

    def rec(node: Object, transform: np.ndarray):
        new_t = _world_matrix(node, transform)
        if isinstance(node, MeshObject):
            w2l, lo, hi = derived(node, new_t, lambda m: (invert_rigid(m), *node.world_aabb(m)))
            objs.append((new_t, w2l, node.mesh_id, node.material_id, lo, hi))
        elif isinstance(node, LightObject):
            pos, d = derived(node, new_t, light_geometry)
            lights.append((node.light_type, pos, d, node.intensity))
        elif isinstance(node, CameraObject) and node is active_camera:
            cam["l2w"] = new_t
            cam["w2v"] = derived(node, new_t, node.world_to_view)
        for child in node.children:
            rec(child, new_t)

    rec(root, _IDENTITY)
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

    l2w, w2l, lo, hi = _stacked_objects(root, objs)
    return FlatScene(
        obj_l2w=l2w,
        obj_w2l=w2l,
        obj_mesh=np.array([o[2] for o in objs], np.int32),
        obj_material=np.array([o[3] for o in objs], np.int32),
        obj_aabb_lo=lo,
        obj_aabb_hi=hi,
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
