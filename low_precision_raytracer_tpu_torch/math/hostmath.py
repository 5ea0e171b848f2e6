"""Host-side (numpy) scene math: a copy of
`low_precision_raytracer_tpu/math/hostmath.py` (the port imports nothing
of the JAX package).

Error-free transforms and the analytic inverse used by the M-matrix
precompute, plus the TRS/quaternion and camera helpers of the hierarchy
flatten.  Vectorized over leading batch dimensions and computed in float32
(float64 intermediates where the original uses them).
"""

from __future__ import annotations

import numpy as np


def difference_of_products(a, b, c, d):
    """a*b - c*d through float64 intermediates (stands in for the fma
    error-free form; as accurate for float32 inputs)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    d = np.asarray(d, np.float64)
    return (a * b - c * d).astype(np.float32)


def cross_product_difference(v1, v2):
    """Error-free cross product.  v1, v2: (..., 3) -> (..., 3) float32."""
    v1 = np.asarray(v1)
    v2 = np.asarray(v2)
    x = difference_of_products(v1[..., 1], v2[..., 2], v2[..., 1], v1[..., 2])
    y = difference_of_products(v1[..., 2], v2[..., 0], v2[..., 2], v1[..., 0])
    z = difference_of_products(v1[..., 0], v2[..., 1], v2[..., 0], v1[..., 1])
    return np.stack([x, y, z], axis=-1)


def inverse_3x3_dop(m):
    """Analytic 3x3 inverse with difference-of-products cofactors.
    m: (..., 3, 3) -> (..., 3, 3) float32."""
    m = np.asarray(m, np.float32)
    dop = difference_of_products

    def e(i, j):
        return m[..., i, j]

    c00 = dop(e(1, 1), e(2, 2), e(2, 1), e(1, 2))
    c01 = dop(e(0, 2), e(2, 1), e(0, 1), e(2, 2))
    c02 = dop(e(0, 1), e(1, 2), e(0, 2), e(1, 1))
    c10 = dop(e(1, 2), e(2, 0), e(1, 0), e(2, 2))
    c11 = dop(e(0, 0), e(2, 2), e(0, 2), e(2, 0))
    c12 = dop(e(1, 0), e(0, 2), e(0, 0), e(1, 2))
    c20 = dop(e(1, 0), e(2, 1), e(2, 0), e(1, 1))
    c21 = dop(e(2, 0), e(0, 1), e(0, 0), e(2, 1))
    c22 = dop(e(0, 0), e(1, 1), e(1, 0), e(0, 1))

    det = e(0, 0) * c00 + e(0, 1) * c10 + e(0, 2) * c20
    inv_det = np.float32(1.0) / det

    rows = np.stack(
        [
            np.stack([c00, c01, c02], axis=-1),
            np.stack([c10, c11, c12], axis=-1),
            np.stack([c20, c21, c22], axis=-1),
        ],
        axis=-2,
    )
    return rows * inv_det[..., None, None]


def quaternion_to_matrix(quat):
    """Quaternion (x, y, z, w) -> 4x4 rotation matrix (scipy convention).
    quat: (..., 4) -> (..., 4, 4)."""
    q = np.asarray(quat, np.float32)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    x2, y2, z2, w2 = x * x, y * y, z * z, w * w
    xy, zw, xz, yw, yz, xw = x * y, z * w, x * z, y * w, y * z, x * w
    zero = np.zeros_like(x)
    one = np.ones_like(x)
    rows = [
        [x2 - y2 - z2 + w2, 2 * (xy - zw), 2 * (xz + yw), zero],
        [2 * (xy + zw), -x2 + y2 - z2 + w2, 2 * (yz - xw), zero],
        [2 * (xz - yw), 2 * (yz + xw), -x2 - y2 + z2 + w2, zero],
        [zero, zero, zero, one],
    ]
    return np.stack(
        [np.stack(r, axis=-1) for r in rows], axis=-2
    ).astype(np.float32)


def trs_matrix(translation, rotation_quat, scale):
    """TRS composition T @ R @ S."""
    t = np.asarray(translation, np.float32)
    s = np.asarray(scale, np.float32)
    m = quaternion_to_matrix(rotation_quat)
    m = m.copy()
    m[..., :3, 0] *= s[..., None, 0]
    m[..., :3, 1] *= s[..., None, 1]
    m[..., :3, 2] *= s[..., None, 2]
    m[..., :3, 3] = t
    return m


def look_at(eye, center, up):
    """Right-handed lookAt world-to-view matrix (glm::lookAt semantics)."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fov_y, width, height, z_near, z_far):
    """glm::perspectiveFov view-to-clip matrix (row-major, y-up, -z
    forward) used for the reprojection W2C."""
    h = 1.0 / np.tan(fov_y * 0.5)
    w = h * height / width
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = -(z_far + z_near) / (z_far - z_near)
    m[2, 3] = -(2.0 * z_far * z_near) / (z_far - z_near)
    m[3, 2] = -1.0
    return m


def invert_rigid(m):
    """Inverse of a 4x4 affine transform (float64 internally)."""
    return np.linalg.inv(np.asarray(m, np.float64)).astype(np.float32)
