"""ctypes binding to the host BVH builder in C++ (`csrc/bvh_builder.cpp`;
port of `low_precision_raytracer_tpu/models/native.py`).

The library is built with `g++` at first use into `_build/` beside the
package (`utils/host_build.py`, under a name keyed by the source bytes and
the flags) and loaded with ctypes.  Where the JAX package falls back to its numpy builder when
`make` fails, the port raises with the compiler's output: the numpy
builder runs only where `models/bvh.py` asks for it by rule (64 or fewer
primitives, or `use_native=False`).
"""

from __future__ import annotations

import ctypes

import numpy as np

from low_precision_raytracer_tpu_torch.utils.host_build import build_host_library

_lib = None


def get_library() -> ctypes.CDLL:
    """The loaded builder library, built on first use; raises with the
    compiler's output when the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    out = build_host_library("bvh_builder")
    lib = ctypes.CDLL(str(out))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.lprt_build_bvh.restype = ctypes.c_int32
    lib.lprt_build_bvh.argtypes = [
        f32p, f32p, f32p, ctypes.c_int64, ctypes.c_int32,
        f32p, f32p, i32p, i32p, i32p, i32p, i32p, i32p,
    ]
    lib.lprt_triangle_aabbs.restype = None
    lib.lprt_triangle_aabbs.argtypes = [f32p, i32p, ctypes.c_int64, f32p, f32p, f32p]
    _lib = lib
    return lib


def native_build_bvh(prim_lo, prim_hi, split_key, leaf_size: int) -> dict:
    """-> the BVH SoA arrays (`models/bvh.py:BVHArrays` fields) from the
    C++ builder."""
    lib = get_library()
    prim_lo = np.ascontiguousarray(prim_lo, np.float32)
    prim_hi = np.ascontiguousarray(prim_hi, np.float32)
    split_key = np.ascontiguousarray(split_key, np.float32)
    n = prim_lo.shape[0]
    cap = max(2 * n - 1, 1)
    out = dict(aabb_lo=np.empty((cap, 3), np.float32), aabb_hi=np.empty((cap, 3), np.float32),
               **{k: np.empty(cap, np.int32)
                  for k in ("parent", "lc", "rc", "leaf_offset", "leaf_count")})
    prim = np.empty(n, np.int32)
    n_nodes = lib.lprt_build_bvh(
        prim_lo, prim_hi, split_key, n, leaf_size, out["aabb_lo"], out["aabb_hi"],
        out["parent"], out["lc"], out["rc"], out["leaf_offset"], out["leaf_count"], prim)
    if n_nodes <= 0:
        raise ValueError(f"native BVH build failed ({n} primitives, leaf size {leaf_size})")
    out = {k: v[:n_nodes].copy() for k, v in out.items()}
    out["prim"] = prim
    return out


def native_triangle_aabbs(positions, indices):
    """Per-triangle AABBs and first-vertex keys from the C++ builder."""
    lib = get_library()
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    n = indices.shape[0]
    lo, hi, key = (np.empty((n, 3), np.float32) for _ in range(3))
    lib.lprt_triangle_aabbs(positions, indices.reshape(-1), n, lo, hi, key)
    return lo, hi, key
