"""Scene resources: the host half of `low_precision_raytracer_tpu/models/scene.py`
(copied, not imported) plus torch device arrays.

- :class:`HostScene` / :class:`Mesh` / :class:`Skybox` — load-time host
  state (numpy);
- :class:`SceneArrays` — load-time device tensors the dense path, the
  G-buffer and shade read (per-triangle attribute rows, material table,
  the texture atlas, the quad-packed skybox), and on the BVH walk's route
  only (`walk=True`) its per-triangle M-shift data and packed BLAS
  (`models/bvh.py`, LEAF_SIZE triangles a leaf);
- :class:`FrameInput` — per-frame device tensors: object transforms and
  world AABBs, lights, camera, sky scalars, on the walk's route the TLAS
  over the objects (rebuilt when an object's world AABB changed, behind a
  byte-keyed cache), and the world-space coefficient table with its per-chunk and
  per-leaf AABBs (morton-ordered above one chunk, as in the JAX package):
  the dense route reads the chunks, the packet BVH (K6) the leaves.  Above
  DENSE_COEFF_MAX_TRIS instance triangles there is no table (its fields
  are None), as in the JAX package: such scenes take the BVH walk.

`HOST_SECONDS` keeps the host seconds of the last BLAS and TLAS builds.

`scene_from_numpy` carries the JAX package's leaves across (as numpy
arrays), so a test can run both packages on exactly the same tables.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, fields

import numpy as np
import torch

from low_precision_raytracer_tpu_torch.config import Precision, get_precision
from low_precision_raytracer_tpu_torch.math.hostmath import (
    cross_product_difference,
    inverse_3x3_dop,
    perspective,
)
from low_precision_raytracer_tpu_torch.models.hierarchy import (
    CameraObject,
    FlatScene,
    Object,
    build_flat_scene,
)
from low_precision_raytracer_tpu_torch.models.bvh import (
    LEAF_SIZE,
    build_blas,
    build_tlas,
    bvh_aabbs_for_dtype,
    pack_blas,
)
from low_precision_raytracer_tpu_torch.models.materials import pack_materials

# triangles per kernel chunk in the JAX package's dense kernel; a scene
# whose instance triangles fit in one chunk is a single-chunk scene
DENSE_CHUNK_TRIS = 128
# spatial (morton) dense-table order above one chunk
DENSE_MORTON = True
# triangles per packet-BVH leaf (DENSE_CHUNK_TRIS % BVH_LEAF_TRIS == 0, so
# chunks and leaves share the table's padding)
BVH_LEAF_TRIS = 32
# the coefficient table's instance-triangle cap (covers packet_bvh_max_tris);
# above it no table is built and the scene takes the BVH walk
DENSE_COEFF_MAX_TRIS = 4 << 20
# host seconds of the last BLAS build (build_scene_arrays) and the last TLAS
# build (flatten_frame; a frame served from the TLAS cache builds none)
HOST_SECONDS = {"blas": 0.0, "tlas": 0.0}


@dataclass
class Mesh:
    """One triangle mesh: positions + the vertex attribute set."""

    positions: np.ndarray  # (V, 3) f32
    indices: np.ndarray  # (T, 3) i32
    normals: np.ndarray | None = None
    tangents: np.ndarray | None = None
    colors: np.ndarray | None = None
    uv0: np.ndarray | None = None
    uv1: np.ndarray | None = None
    name: str = ""

    def __post_init__(self):
        self.positions = np.asarray(self.positions, np.float32).reshape(-1, 3)
        self.indices = np.asarray(self.indices, np.int32).reshape(-1, 3)
        v = self.positions.shape[0]
        if self.normals is None:
            self.normals = np.tile(np.array([0, 1, 0], np.float32), (v, 1))
        if self.tangents is None:
            self.tangents = np.tile(np.array([1, 0, 0], np.float32), (v, 1))
        if self.colors is None:
            self.colors = np.ones((v, 3), np.float32)
        if self.uv0 is None:
            self.uv0 = np.zeros((v, 2), np.float32)
        if self.uv1 is None:
            self.uv1 = np.zeros((v, 2), np.float32)
        for name in ("normals", "tangents", "colors"):
            setattr(self, name, np.asarray(getattr(self, name), np.float32).reshape(v, 3))
        for name in ("uv0", "uv1"):
            setattr(self, name, np.asarray(getattr(self, name), np.float32).reshape(v, 2))

    @property
    def aabb(self):
        return self.positions.min(axis=0), self.positions.max(axis=0)

    @property
    def n_triangles(self) -> int:
        return self.indices.shape[0]


@dataclass
class Skybox:
    """Equirectangular HDR skybox."""

    data: np.ndarray  # (H, W, 3) f32 linear HDR
    delta_x: float = 0.0
    delta_y: float = 0.0
    exposure: float = 1.0


@dataclass
class HostScene:
    """All load-time host state."""

    meshes: list = field(default_factory=list)
    materials: list = field(default_factory=list)
    textures: list = field(default_factory=list)  # (H, W, 4) uint8 RGBA arrays
    texture_srgb: list = field(default_factory=list)  # one bool per texture
    root: Object = field(default_factory=Object)
    active_camera: CameraObject | None = None
    skybox: Skybox | None = None
    animated: bool = False

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def add_material(self, mat) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1


@dataclass(frozen=True)
class SceneArrays:
    # packed per-triangle attribute rows (T, 48) in the render dtype:
    # 3 vertices x [pos3 nrm3 tan3 col3 uv0.2 uv1.2]
    tri_attr: torch.Tensor
    # material table
    mat_color: torch.Tensor  # (M, 3) dtype
    mat_emission: torch.Tensor  # (M, 3) dtype
    mat_metallic: torch.Tensor  # (M,) dtype
    mat_roughness: torch.Tensor  # (M,) dtype
    mat_double_sided: torch.Tensor  # (M,) bool
    mat_tex_color: torch.Tensor  # (M,) i32 atlas texture id, NO_TEX = -1
    mat_uv_color: torch.Tensor  # (M,) i32 uv set
    # loaded but never sampled, as in the JAX package: shade reads only
    # the base-colour texture
    mat_tex_emission: torch.Tensor  # (M,) i32
    mat_uv_emission: torch.Tensor
    mat_tex_mr: torch.Tensor
    mat_uv_mr: torch.Tensor
    mat_channel_roughness: torch.Tensor
    mat_channel_metallic: torch.Tensor
    # texture atlas: every texture's RGBA texels, row-major, one after the
    # other; texture k starts at texel tex_offset[k].  Without textures one
    # zero texel, and a real atlas of one texel gets a zero texel more, so
    # `ops/texture.py:has_textures` (tex_data rows > 1) tells them apart
    tex_data: torch.Tensor  # (N, 4) uint8
    tex_offset: torch.Tensor  # (K,) i32
    tex_width: torch.Tensor  # (K,) i32
    tex_height: torch.Tensor  # (K,) i32
    tex_srgb: torch.Tensor  # (K,) bool
    # skybox: the panorama and its quad-packed bilinear footprint rows in
    # the render dtype, row (y, x) = [(y,x), (y,x+1 wrap), (y+1 clamp,x),
    # (y+1 clamp,x+1 wrap)] x RGB; a (1, 1, 3) zero panorama without sky
    sky_data: torch.Tensor  # (h, w, 3) f32
    sky_quad: torch.Tensor  # (h*w, 12) dtype
    # the BVH walk's tables, None off its route (`walk_arrays`).
    # per-triangle M-shift data: the third vertex and the shear/inverse
    # matrix, in the render dtype and their f32 shadows
    tri_v2: torch.Tensor  # (T, 3) dtype
    tri_v2_f32: torch.Tensor  # (T, 3) f32
    tri_m: torch.Tensor  # (T, 3, 3) dtype
    tri_m_f32: torch.Tensor  # (T, 3, 3) f32
    # packed BLAS: every mesh's tree, global node ids (roots' parents -1),
    # boxes widened to the render dtype
    blas_lo: torch.Tensor  # (NB, 3) dtype
    blas_hi: torch.Tensor  # (NB, 3) dtype
    blas_parent: torch.Tensor  # (NB,) i32
    blas_lc: torch.Tensor  # (NB,) i32
    blas_rc: torch.Tensor  # (NB,) i32
    blas_leaf_offset: torch.Tensor  # (NB,) i32
    blas_leaf_count: torch.Tensor  # (NB,) i32 (0: an internal node)
    blas_prim: torch.Tensor  # (P,) i32 global triangle ids in leaf order
    blas_root: torch.Tensor  # (n_meshes,) i32
    n_meshes: int = 0  # static
    sky_valid: bool = False  # static
    leaf_size: int = LEAF_SIZE  # static: the BLAS's triangles per leaf


@dataclass(frozen=True)
class FrameInput:
    obj_l2w: torch.Tensor  # (O, 4, 4) dtype
    obj_w2l: torch.Tensor  # (O, 4, 4) dtype (the BVH walk's object transform)
    obj_l2w_f32: torch.Tensor  # (O, 4, 4) f32
    obj_w2l_f32: torch.Tensor  # (O, 4, 4) f32
    obj_mesh: torch.Tensor  # (O,) i32
    obj_material: torch.Tensor  # (O,) i32
    obj_aabb_lo: torch.Tensor  # (O, 3) f32 world AABBs
    obj_aabb_hi: torch.Tensor  # (O, 3) f32
    # TLAS over the objects' world AABBs (leaf size 1, prim -> object id),
    # boxes widened to the render dtype; None off the walk's route
    tlas_lo: torch.Tensor  # (NT, 3) dtype
    tlas_hi: torch.Tensor  # (NT, 3) dtype
    tlas_parent: torch.Tensor  # (NT,) i32
    tlas_lc: torch.Tensor  # (NT,) i32
    tlas_rc: torch.Tensor  # (NT,) i32
    tlas_leaf_offset: torch.Tensor  # (NT,) i32
    tlas_leaf_count: torch.Tensor  # (NT,) i32
    tlas_prim: torch.Tensor  # (O,) i32
    # lights, padded to max_direct_lights
    light_type: torch.Tensor  # (Lmax,) i32
    light_pos: torch.Tensor  # (Lmax, 3) dtype
    light_dir: torch.Tensor  # (Lmax, 3) dtype
    light_intensity: torch.Tensor  # (Lmax, 3) dtype
    light_valid: torch.Tensor  # (Lmax,) bool
    # camera: f32 world-to-clip (reprojection) and f32 ray generation
    cam_w2c: torch.Tensor  # (4, 4) f32
    cam_l2w_f32: torch.Tensor  # (4, 4) f32
    cam_fov_y_f32: torch.Tensor  # () f32
    # skybox dynamics
    sky_delta_x: torch.Tensor  # () f32
    sky_delta_y: torch.Tensor  # () f32
    sky_exposure: torch.Tensor  # () f32
    # dense route: per-instance-triangle world-space test coefficients,
    # rows n = m @ A (A = W2L linear part), offsets e = m.(b - v2) + n.c,
    # recentred at the scene centre c; the rows also rounded to the render
    # dtype (the sub-f32 error-band tests' dtype rows).  None, with the
    # chunk and leaf AABBs, above DENSE_COEFF_MAX_TRIS
    dense_n: torch.Tensor  # (TI, 3, 3) dtype
    dense_n_f32: torch.Tensor  # (TI, 3, 3) f32
    dense_e: torch.Tensor  # (TI, 3) f32
    dense_tri: torch.Tensor  # (TI,) i32 global triangle id
    dense_obj: torch.Tensor  # (TI,) i32 object id
    dense_center: torch.Tensor  # (3,) f32
    # world AABBs of each DENSE_CHUNK_TRIS consecutive table rows, widened
    # to stay conservative under f32 rounding
    dense_chunk_lo: torch.Tensor  # (NC, 3) f32
    dense_chunk_hi: torch.Tensor  # (NC, 3) f32
    # the same per BVH_LEAF_TRIS rows: the packet BVH's leaves (NL = 4 NC)
    dense_leaf_lo: torch.Tensor  # (NL, 3) f32
    dense_leaf_hi: torch.Tensor  # (NL, 3) f32
    # static: ((mesh_id, tri_start, tri_end), ...) per object
    obj_layout: tuple = ()
    # static: active light count (<= max_direct_lights)
    n_lights: int = 0
    # static: table rows are morton-ordered by world centroid
    dense_morton: bool = False


_STATIC = ("n_meshes", "sky_valid", "leaf_size", "obj_layout", "n_lights", "dense_morton")


def tensor_fields(cls) -> list[str]:
    """Names of the tensor fields of SceneArrays / FrameInput."""
    return [f.name for f in fields(cls) if f.name not in _STATIC]


def compute_m_matrices(positions_f32: np.ndarray, tri_idx: np.ndarray):
    """Per-triangle shear/inverse matrices in fp32: M1 columns are
    [v0-v2, v1-v2, cross_dop(v0-v2, v1-v2) - v2] and M = M1^-1 via the
    difference-of-products cofactor inverse."""
    v0 = positions_f32[tri_idx[:, 0]]
    v1 = positions_f32[tri_idx[:, 1]]
    v2 = positions_f32[tri_idx[:, 2]]
    e0 = v0 - v2
    e1 = v1 - v2
    col2 = cross_product_difference(e0, e1) - v2
    m1 = np.stack([e0, e1, col2], axis=-1)  # columns
    return inverse_3x3_dop(m1).astype(np.float32)


def _host_m_cache(host: HostScene):
    """Per-HostScene cache of the fp32 M matrices, third vertices and
    local triangle vertices, keyed on the identity of every mesh's
    arrays."""
    key = tuple((id(m.positions), id(m.indices)) for m in host.meshes)
    cache = getattr(host, "_m_cache", None)
    if cache is not None and cache[0] == key:
        return cache[1:]
    v_off = np.cumsum([0] + [m.positions.shape[0] for m in host.meshes])
    pos = np.concatenate([m.positions for m in host.meshes]).astype(np.float32)
    tri_idx = np.concatenate(
        [m.indices + v_off[i] for i, m in enumerate(host.meshes)]
    ).astype(np.int32)
    m_f32 = compute_m_matrices(pos, tri_idx)
    v2_f32 = pos[tri_idx[:, 2]]
    verts_f32 = pos[tri_idx]  # (T, 3, 3)
    host._m_cache = (key, m_f32, v2_f32, verts_f32)
    return m_f32, v2_f32, verts_f32


def _morton_order(lo_raw, hi_raw):
    """Stable order of the rows by the 30-bit morton code of their world
    centroids (10 bits per axis)."""
    cen = (lo_raw + hi_raw) * 0.5
    cmin = cen.min(axis=0)
    ext = np.maximum(cen.max(axis=0) - cmin, 1e-30)
    q = np.minimum((cen - cmin) / ext * 1024.0, 1023.0).astype(np.uint64)

    def spread(x):
        x = (x | (x << 32)) & np.uint64(0x1F00000000FFFF)
        x = (x | (x << 16)) & np.uint64(0x1F0000FF0000FF)
        x = (x | (x << 8)) & np.uint64(0x100F00F00F00F00F)
        x = (x | (x << 4)) & np.uint64(0x10C30C30C30C30C3)
        x = (x | (x << 2)) & np.uint64(0x1249249249249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return np.argsort(code, kind="stable")


def _group_aabbs(lo_raw, hi_raw, n_per_group: int):
    """World AABBs of each `n_per_group` consecutive rows, the rows padded
    to a DENSE_CHUNK_TRIS multiple, widened by 1e-3 of their extent + 1e-4;
    an all-padding group parks far away."""
    ti = lo_raw.shape[0]
    pad = (-ti) % DENSE_CHUNK_TRIS
    big = np.float32(1e30)
    lo_t = np.pad(lo_raw, ((0, pad), (0, 0)), constant_values=big)
    hi_t = np.pad(hi_raw, ((0, pad), (0, 0)), constant_values=-big)
    ng = (ti + pad) // n_per_group
    g_lo = lo_t.reshape(ng, n_per_group, 3).min(axis=1)
    g_hi = hi_t.reshape(ng, n_per_group, 3).max(axis=1)
    ext = np.maximum(g_hi - g_lo, 0.0)
    g_lo = g_lo - ext * 1e-3 - 1e-4
    g_hi = g_hi + ext * 1e-3 + 1e-4
    empty = g_hi[:, 0] < g_lo[:, 0]
    g_lo[empty] = big
    g_hi[empty] = big
    return g_lo, g_hi


def _dense_coefficients(host: HostScene, flat: FlatScene, t_off, prec: Precision, device):
    """World-space per-instance-triangle test coefficients (host float64
    -> fp32) as device tensors: with the local test m @ (A o + b - v2) and
    the W2L linear part A, the world-ray form is n.o + e with rows n = m @ A
    and offsets e = m.(b - v2) + n.c (recentred at the scene centre c).

    -> dict (dense_n, dense_n_f32, dense_e, dense_tri, dense_obj,
    dense_center, dense_chunk_lo/hi, dense_leaf_lo/hi, dense_morton), each
    tensor None for a scene of no or more than DENSE_COEFF_MAX_TRIS
    instance triangles (the JAX package's rule).  Above one chunk the rows
    are sorted by the morton code of their world centroids, so each 128-row
    chunk is a compact blob with a tight AABB; single-chunk scenes keep
    object order.

    Two host caches keyed on transform bytes (exact) bound the per-frame
    cost, as in the JAX package:
    - the whole frame: when no object transform changed (a static scene,
      or a frame where only the camera or the lights move) the previous
      frame's dict comes back, the same device tensors, so every cache
      keyed on a table tensor (`ops/dense_trace.py:per_table`) keeps its
      entry;
    - per object: only objects that moved recompute their (n, e without
      the recentre term, triangle AABBs) block; n.c is re-applied over the
      whole table, since c moves with the scene box.  Blocks the current
      frame does not use are dropped."""
    n_obj = flat.obj_mesh.shape[0]
    ti = int(np.sum(t_off[flat.obj_mesh + 1] - t_off[flat.obj_mesh]))
    if ti == 0 or ti > DENSE_COEFF_MAX_TRIS:
        return dict(dense_n=None, dense_n_f32=None, dense_e=None, dense_tri=None,
                    dense_obj=None, dense_center=None, dense_chunk_lo=None,
                    dense_chunk_hi=None, dense_leaf_lo=None, dense_leaf_hi=None,
                    dense_morton=False)
    cache = getattr(host, "_dense_cache", None)
    if cache is None or cache["n_tris"] != ti:
        cache = {"blocks": {}, "key": None, "out": None, "n_tris": ti}
        host._dense_cache = cache
    frame_key = (prec.name, str(device), flat.obj_mesh.tobytes(), flat.obj_w2l.tobytes(),
                 flat.obj_l2w.tobytes())
    if cache["key"] == frame_key:
        return cache["out"]

    m_f32, v2_f32, verts_f32 = _host_m_cache(host)
    center = (
        (flat.obj_aabb_lo.min(axis=0) + flat.obj_aabb_hi.max(axis=0)) / 2
    ).astype(np.float64)
    blocks, new_blocks = cache["blocks"], {}
    ns, es, tris, objs, los, his = [], [], [], [], [], []
    for o in range(n_obj):
        mesh = int(flat.obj_mesh[o])
        t0, t1 = int(t_off[mesh]), int(t_off[mesh + 1])
        if t0 == t1:
            continue
        bkey = (mesh, flat.obj_w2l[o].tobytes(), flat.obj_l2w[o].tobytes())
        blk = new_blocks.get(bkey) or blocks.get(bkey)
        if blk is None:
            w2l = flat.obj_w2l[o].astype(np.float64)
            A = w2l[:3, :3]
            b = w2l[:3, 3]
            m = m_f32[t0:t1].astype(np.float64)  # (T, 3, 3) rows
            v2 = v2_f32[t0:t1].astype(np.float64)
            l2w = flat.obj_l2w[o].astype(np.float64)
            vw = (verts_f32[t0:t1].astype(np.float64) @ l2w[:3, :3].T
                  + l2w[:3, 3]).astype(np.float32)
            # e stays f64: it cancels against n.c below
            blk = ((m @ A).astype(np.float32), np.einsum("trk,tk->tr", m, b[None, :] - v2),
                   vw.min(axis=1), vw.max(axis=1))
        new_blocks[bkey] = blk
        ns.append(blk[0])
        es.append(blk[1])
        los.append(blk[2])
        his.append(blk[3])
        tris.append(np.arange(t0, t1, dtype=np.int32))
        objs.append(np.full(t1 - t0, o, np.int32))
    cache["blocks"] = new_blocks
    n_all = np.concatenate(ns)
    e_all = (np.concatenate(es) + n_all.astype(np.float64) @ center).astype(np.float32)
    tri_all = np.concatenate(tris)
    obj_all = np.concatenate(objs)
    lo_raw = np.concatenate(los)
    hi_raw = np.concatenate(his)
    morton = DENSE_MORTON and n_all.shape[0] > DENSE_CHUNK_TRIS
    if morton:
        order = _morton_order(lo_raw, hi_raw)
        n_all, e_all, tri_all, obj_all = n_all[order], e_all[order], tri_all[order], obj_all[order]
        lo_raw, hi_raw = lo_raw[order], hi_raw[order]
    chunk_lo, chunk_hi = _group_aabbs(lo_raw, hi_raw, DENSE_CHUNK_TRIS)
    leaf_lo, leaf_hi = _group_aabbs(lo_raw, hi_raw, BVH_LEAF_TRIS)
    f32, i32 = torch.float32, torch.int32
    out = _upload(dict(
        dense_n=(n_all, prec.dtype),
        dense_n_f32=(n_all, f32),
        dense_e=(e_all, f32),
        dense_tri=(tri_all, i32),
        dense_obj=(obj_all, i32),
        dense_center=(center.astype(np.float32), f32),
        dense_chunk_lo=(chunk_lo, f32),
        dense_chunk_hi=(chunk_hi, f32),
        dense_leaf_lo=(leaf_lo, f32),
        dense_leaf_hi=(leaf_hi, f32),
    ), device)
    out["dense_morton"] = morton
    cache["key"] = frame_key
    cache["out"] = out
    return out


# elements between the starts of two arrays that share one upload: 64
# bytes for 4-byte types, more than the widest vector load of a kernel
_UPLOAD_ALIGN = 16


def _upload(arrays: dict, device, cache: dict | None = None) -> dict:
    """{name: (numpy array, torch dtype)} -> {name: tensor on `device`}, in
    one host-to-device copy per numpy dtype: each tensor is a view of that
    copy, cast to its torch dtype on the device.  With `cache`, an array
    whose bytes equal the previous upload's under its name gets the
    previous tensor back and is not copied (a still frame copies nothing)."""
    out, todo = {}, {}
    for name, (a, dt) in arrays.items():
        a = np.ascontiguousarray(a)
        key = None if cache is None else (a.dtype.str, a.shape, dt, a.tobytes())
        hit = None if cache is None else cache.get(name)
        if hit is not None and hit[0] == key:
            out[name] = hit[1]
        else:
            todo.setdefault(a.dtype.str, []).append((name, a, dt, key))
    for items in todo.values():
        spans = [-(-max(a.size, 1) // _UPLOAD_ALIGN) * _UPLOAD_ALIGN for _n, a, _d, _k in items]
        buf = np.zeros(sum(spans), items[0][1].dtype)
        starts = np.cumsum([0] + spans[:-1]).tolist()
        for (_n, a, _d, _k), s0 in zip(items, starts):
            buf[s0:s0 + a.size] = a.reshape(-1)
        dev = torch.from_numpy(buf).to(device)
        for (name, a, dt, key), s0 in zip(items, starts):
            out[name] = dev[s0:s0 + a.size].view(a.shape).to(dt)
            if cache is not None:
                cache[name] = (key, out[name])
    return out


def _to_tensor(a, device, dtype=None) -> torch.Tensor:
    """numpy -> torch on `device`; bfloat16 numpy arrays (ml_dtypes, as the
    JAX package hands them out) travel bit-exactly through int16."""
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _texture_atlas(host: HostScene) -> dict:
    """The flat RGBA atlas of the host's textures (RGB ones get alpha 255)
    and its per-texture offset, size and sRGB flag, as numpy arrays."""
    if not host.textures:
        return dict(tex_data=np.zeros((1, 4), np.uint8), tex_offset=np.zeros(1, np.int32),
                    tex_width=np.ones(1, np.int32), tex_height=np.ones(1, np.int32),
                    tex_srgb=np.zeros(1, np.bool_))
    flat, offsets, off = [], [], 0
    for t in host.textures:
        t = np.asarray(t, np.uint8).reshape(t.shape[0], t.shape[1], -1)
        if t.shape[2] == 3:
            t = np.concatenate([t, np.full((*t.shape[:2], 1), 255, np.uint8)], axis=2)
        offsets.append(off)
        flat.append(t.reshape(-1, 4))
        off += t.shape[0] * t.shape[1]
    tex_data = np.concatenate(flat)
    if tex_data.shape[0] == 1:  # one texel in all: keep it apart from the placeholder
        tex_data = np.concatenate([tex_data, np.zeros((1, 4), np.uint8)])
    return dict(tex_data=tex_data, tex_offset=np.array(offsets, np.int32),
                tex_width=np.array([t.shape[1] for t in host.textures], np.int32),
                tex_height=np.array([t.shape[0] for t in host.textures], np.int32),
                tex_srgb=np.array(host.texture_srgb, np.bool_))


WALK_SCENE_FIELDS = ("tri_v2", "tri_v2_f32", "tri_m", "tri_m_f32", "blas_lo", "blas_hi",
                     "blas_parent", "blas_lc", "blas_rc", "blas_leaf_offset",
                     "blas_leaf_count", "blas_prim", "blas_root")
TLAS_FIELDS = ("tlas_lo", "tlas_hi", "tlas_parent", "tlas_lc", "tlas_rc", "tlas_leaf_offset",
               "tlas_leaf_count", "tlas_prim")


def walk_arrays(host: HostScene, prec: Precision | str, device) -> dict:
    """The BVH walk's scene tables (WALK_SCENE_FIELDS): the per-triangle
    M-shift rows and the packed BLAS of LEAF_SIZE triangles a leaf, its
    boxes widened to the render dtype; the build's host seconds go to
    HOST_SECONDS["blas"]."""
    dt = get_precision(prec).dtype
    meshes = host.meshes
    m_f32, v2_f32, _ = _host_m_cache(host)
    t0 = time.perf_counter()
    t_off = np.cumsum([0] + [m.n_triangles for m in meshes]).astype(np.int32)
    blas = pack_blas([build_blas(m.positions, m.indices, leaf_size=LEAF_SIZE) for m in meshes],
                     t_off[:-1])
    blas_lo, blas_hi = bvh_aabbs_for_dtype(blas.aabb_lo, blas.aabb_hi, dt)
    HOST_SECONDS["blas"] = time.perf_counter() - t0
    as_dt = lambda x: _to_tensor(np.asarray(x, np.float32), device, dt)
    return dict(
        tri_v2=as_dt(v2_f32),
        tri_v2_f32=_to_tensor(v2_f32, device),
        tri_m=as_dt(m_f32),
        tri_m_f32=_to_tensor(m_f32, device),
        blas_lo=blas_lo.to(device),
        blas_hi=blas_hi.to(device),
        **{f"blas_{k}": _to_tensor(np.asarray(getattr(blas, k), np.int32), device)
           for k in ("parent", "lc", "rc", "leaf_offset", "leaf_count", "prim", "root")})


def build_scene_arrays(host: HostScene, prec: Precision | str, device,
                       walk: bool = False) -> SceneArrays:
    """Flatten host meshes/materials into device tensors; with `walk` also
    the BVH walk's tables (`walk_arrays`), else those fields are None."""
    prec = get_precision(prec)
    dt = prec.dtype
    meshes = host.meshes
    if not meshes:
        raise ValueError("scene has no meshes")
    v_off = np.cumsum([0] + [m.positions.shape[0] for m in meshes])
    pos = np.concatenate([m.positions for m in meshes]).astype(np.float32)
    nrm = np.concatenate([m.normals for m in meshes]).astype(np.float32)
    tan = np.concatenate([m.tangents for m in meshes]).astype(np.float32)
    col = np.concatenate([m.colors for m in meshes]).astype(np.float32)
    uv0 = np.concatenate([m.uv0 for m in meshes]).astype(np.float32)
    uv1 = np.concatenate([m.uv1 for m in meshes]).astype(np.float32)
    tri_idx = np.concatenate(
        [m.indices + v_off[i] for i, m in enumerate(meshes)]
    ).astype(np.int32)
    n_tris = tri_idx.shape[0]
    per_vert = np.concatenate([pos, nrm, tan, col, uv0, uv1], axis=1)  # (V, 16)
    tri_attr = per_vert[tri_idx].reshape(n_tris, 48).astype(np.float32)
    mats = pack_materials(host.materials)
    atlas = _texture_atlas(host)
    sky_valid = host.skybox is not None
    sky_data = (np.asarray(host.skybox.data, np.float32) if sky_valid
                else np.zeros((1, 1, 3), np.float32))
    # quad-packed footprint rows: x wraps, y clamps
    x1 = np.roll(sky_data, -1, axis=1)
    y1 = np.concatenate([sky_data[1:], sky_data[-1:]], axis=0)
    y1x1 = np.roll(y1, -1, axis=1)
    sky_quad = np.concatenate([sky_data, x1, y1, y1x1], axis=2).reshape(-1, 12)
    as_dt = lambda x: _to_tensor(np.asarray(x, np.float32), device, dt)
    return SceneArrays(
        tri_attr=as_dt(tri_attr),
        mat_color=as_dt(mats["color"]),
        mat_emission=as_dt(mats["emission"]),
        mat_metallic=as_dt(mats["metallic"]),
        mat_roughness=as_dt(mats["roughness"]),
        mat_double_sided=_to_tensor(mats["double_sided"], device),
        **{f"mat_{k}": _to_tensor(mats[k], device)
           for k in ("tex_color", "uv_color", "tex_emission", "uv_emission", "tex_mr",
                     "uv_mr", "channel_roughness", "channel_metallic")},
        **{k: _to_tensor(a, device) for k, a in atlas.items()},
        sky_data=_to_tensor(sky_data, device),
        sky_quad=as_dt(sky_quad),
        **(walk_arrays(host, prec, device) if walk else dict.fromkeys(WALK_SCENE_FIELDS)),
        n_meshes=len(meshes),
        sky_valid=sky_valid,
    )


def flatten_frame(
    host: HostScene,
    prec: Precision | str,
    device,
    max_direct_lights: int = 4,
    width: int | None = None,
    height: int | None = None,
    time: float = 0.0,
    walk: bool = False,
) -> FrameInput:
    """Host flatten of the hierarchy at `time` -> device FrameInput.  An
    animated scene (or any `time` != 0) samples its animation first; the
    coefficient table and its boxes are rebuilt only when an object moved
    (`_dense_coefficients`).  With `walk` the frame carries the TLAS
    (`_tlas`), else its fields are None."""
    prec = get_precision(prec)
    dt = prec.dtype
    if host.animated or time != 0.0:
        host.root.apply_animation(time)
    flat = build_flat_scene(host.root, host.active_camera)

    n_l = flat.light_type.shape[0]
    lmax = max_direct_lights
    lt = np.zeros(lmax, np.int32)
    lp = np.zeros((lmax, 3), np.float32)
    ld = np.tile(np.array([0, 0, -1], np.float32), (lmax, 1))
    li = np.zeros((lmax, 3), np.float32)
    lv = np.zeros(lmax, np.bool_)
    k = min(n_l, lmax)
    lt[:k] = flat.light_type[:k]
    lp[:k] = flat.light_pos[:k]
    ld[:k] = flat.light_dir[:k]
    li[:k] = flat.light_intensity[:k]
    lv[:k] = True

    w = width if width is not None else 1
    h = height if height is not None else 1
    v2c = perspective(flat.cam_fov_y, w, h, flat.cam_z_near, flat.cam_z_far)
    w2c = (v2c @ flat.cam_w2v).astype(np.float32)

    t_off = np.cumsum([0] + [m.n_triangles for m in host.meshes])
    m = flat.obj_mesh
    obj_layout = tuple(zip(m.tolist(), t_off[m].tolist(), t_off[m + 1].tolist()))
    dense = _dense_coefficients(host, flat, t_off, prec, device)
    tlas = {}
    if walk:
        tree, (lo, hi) = _tlas(host, flat, dt)
        tlas = dict(tlas_lo=(lo, dt), tlas_hi=(hi, dt),
                    **{f"tlas_{k}": (getattr(tree, k), torch.int32)
                       for k in ("parent", "lc", "rc", "leaf_offset", "leaf_count", "prim")})
    sky = host.skybox

    f32, i32 = torch.float32, torch.int32
    a32 = lambda x: np.asarray(x, np.float32)
    fields = _upload(dict(
        obj_l2w=(flat.obj_l2w, dt),
        obj_w2l=(flat.obj_w2l, dt),
        obj_l2w_f32=(flat.obj_l2w, f32),
        obj_w2l_f32=(flat.obj_w2l, f32),
        obj_mesh=(flat.obj_mesh, i32),
        obj_material=(flat.obj_material, i32),
        obj_aabb_lo=(flat.obj_aabb_lo, f32),
        obj_aabb_hi=(flat.obj_aabb_hi, f32),
        **tlas,
        light_type=(lt, i32),
        light_pos=(lp, dt),
        light_dir=(ld, dt),
        light_intensity=(li, dt),
        light_valid=(lv, torch.bool),
        cam_w2c=(w2c, f32),
        cam_l2w_f32=(a32(flat.cam_l2w), f32),
        cam_fov_y_f32=(a32(flat.cam_fov_y), f32),
        sky_delta_x=(a32(sky.delta_x if sky else 0.0), f32),
        sky_delta_y=(a32(sky.delta_y if sky else 0.0), f32),
        sky_exposure=(a32(sky.exposure if sky else 1.0), f32),
    ), device, cache=host.__dict__.setdefault("_upload_cache", {}).setdefault(str(device), {}))
    return FrameInput(
        **{**dict.fromkeys(TLAS_FIELDS), **fields},
        obj_layout=obj_layout,
        n_lights=int(k),
        **dense,
    )


def _tlas(host: HostScene, flat: FlatScene, dt: torch.dtype):
    """The TLAS over the objects' world AABBs and its boxes widened to
    `dt` (f32 numpy values), rebuilt only when the boxes' bytes changed
    (the JAX package's `_tlas_cache`); the build's host seconds go to
    HOST_SECONDS["tlas"]."""
    key = (flat.obj_aabb_lo.tobytes(), flat.obj_aabb_hi.tobytes())
    cache = getattr(host, "_tlas_cache", None)
    if cache is None or cache[0] != key:
        t0 = time.perf_counter()
        cache = (key, build_tlas(flat.obj_aabb_lo, flat.obj_aabb_hi), {})
        HOST_SECONDS["tlas"] = time.perf_counter() - t0
        host._tlas_cache = cache
    tlas, boxes = cache[1], cache[2]
    if dt not in boxes:
        boxes[dt] = tuple(x.float().numpy()
                          for x in bvh_aabbs_for_dtype(tlas.aabb_lo, tlas.aabb_hi, dt))
    return tlas, boxes[dt]


def scene_from_numpy(scene_np: dict, frame_np: dict, device):
    """Build (SceneArrays, FrameInput) from the JAX package's leaves given
    as numpy arrays, keyed by field name.  Static fields come as plain
    Python values: `n_meshes` and `sky_valid` in scene_np, `obj_layout`,
    `n_lights` and `dense_morton` in frame_np (a missing one takes its
    default); `leaf_size` in scene_np.  A None (the coefficient table of a
    scene above DENSE_COEFF_MAX_TRIS, the walk's tables off its route)
    stays None.  Extra keys are ignored;
    bfloat16 arrays carry over bit for bit."""

    def build(cls, src):
        kw = {f: None if src[f] is None else _to_tensor(src[f], device)
              for f in tensor_fields(cls)}
        kw.update({f: src[f] for f in _STATIC if f in src and f in cls.__dataclass_fields__})
        return cls(**kw)

    return build(SceneArrays, scene_np), build(FrameInput, frame_np)


def instance_tris(frame: FrameInput) -> int:
    return int(sum(t1 - t0 for _m, t0, t1 in frame.obj_layout))
