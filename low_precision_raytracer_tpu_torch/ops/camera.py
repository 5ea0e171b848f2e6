"""Primary-ray generation (port of `low_precision_raytracer_tpu/ops/camera.py`).

Pinhole rays in camera space ((x, y, -1) through the pixel centre, y up,
-z forward), transformed by the camera's local-to-world.  Row 0 of the
(H, W) grid maps to normalized y = -1 (image bottom).
"""

from __future__ import annotations

import torch

from low_precision_raytracer_tpu_torch.math.vec import normalize


def primary_ray_grid(cam_l2w, fov_y, width: int, height: int, dtype=torch.float32):
    """-> origins (H, W, 3), directions (H, W, 3) in `dtype` (world space).
    The renderer calls it in f32 in every precision mode."""
    dt = dtype
    dev = cam_l2w.device
    f32 = torch.float32
    x = (torch.arange(width, dtype=f32, device=dev) + 0.5) * (2.0 / width) - 1.0
    y = (torch.arange(height, dtype=f32, device=dev) + 0.5) * (2.0 / height) - 1.0
    ny, nx = torch.meshgrid(y, x, indexing="ij")  # (H, W)

    max_y = torch.tan(torch.as_tensor(fov_y, device=dev).to(dt) / 2).to(dt)
    aspect = torch.tensor(width / height, dtype=dt, device=dev)
    yy = ny.to(dt) * max_y
    xx = nx.to(dt) * max_y * aspect

    d_local = normalize(torch.stack([xx, yy, torch.full_like(xx, -1.0)], dim=-1))
    m = cam_l2w.to(dt)
    rot = m[:3, :3]
    # true f32 product: TF32 is off (config.resolve_device)
    d_w = normalize(d_local @ rot.T)
    o_w = torch.broadcast_to((m[:3, 3] / m[3, 3]).to(dt), d_w.shape)
    return o_w, d_w
