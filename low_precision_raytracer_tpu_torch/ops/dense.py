"""The all-pairs route (port of `low_precision_raytracer_tpu/ops/dense.py:
trace_rays_dense`, `traversal_impl='dense'`), plain PyTorch.

The JAX package runs it as XLA matrix products outside any Pallas kernel:
every ray against every row of the frame's world-space coefficient table
(`FrameInput.dense_*`).  The x and y rows are products of operands in the
render dtype with f32 accumulation (here: both operands rounded to the
dtype, the product in f32, as `preferred_element_type=F32` computes it; a
bf16 `torch.matmul` would round its output to bf16), the z row (t) is
always f32, and the error bounds are products of the operands' absolute
values.  Inside the band 'both' re-tests u / v with the f32 rows (fp32:
the strict test); 'dtype' takes the band-widened test alone.  A hit also
needs mind < t < maxd, tri != skip and a finite t; the closest accepted
row wins, the first of equal t in table order.  `find_any` changes
nothing (no early out): the result is the closest hit either way.
-> (t, u, v, tri, obj), t = 1e5, u = v = 0 and ids -1 on a miss.

Rays go in slices of at most 2^24 (ray, row) pairs, bounding the (rays,
TI) intermediates.
"""

from __future__ import annotations

import torch

from low_precision_raytracer_tpu_torch.config import Precision

PAIRS = 1 << 24


def trace_rays_dense(frame, origins, directions, *, prec: Precision, fallback: str = "both",
                     skip_tri=None, min_dist=0.0, max_dist=1e5, find_any: bool = False):
    """All-pairs closest hit over every instance triangle; origins /
    directions (R, 3)."""
    if frame.dense_n is None:
        raise ValueError("the all-pairs route needs the frame's coefficient table "
                         "(none above DENSE_COEFF_MAX_TRIS instance triangles)")
    f32 = torch.float32
    dt = prec.dtype
    R, dev = origins.shape[0], origins.device
    mind = torch.broadcast_to(torch.as_tensor(min_dist, dtype=f32, device=dev), (R,))
    maxd = torch.broadcast_to(torch.as_tensor(max_dist, dtype=f32, device=dev), (R,))
    if skip_tri is None:
        skip_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    o_sh = (origins.to(f32) - frame.dense_center).to(dt)
    d_w = directions.to(dt)
    TI = frame.dense_n.shape[0]
    n_dt = frame.dense_n.reshape(TI, 9).to(f32)  # the dtype's values
    n_f32 = frame.dense_n_f32.reshape(TI, 9)
    e = frame.dense_e
    n0, n1 = n_dt[:, 0:3].T, n_dt[:, 3:6].T
    n2f = n_f32[:, 6:9].T
    a0, a1 = n0.abs(), n1.abs()
    d1 = torch.tensor(prec.delta1, dtype=f32)
    d12 = d1 + torch.tensor(prec.delta2, dtype=f32)
    # the x / y rows: f32 products on the f32 rows in fp32, else on the
    # dtype rows (operands rounded to the dtype)
    nx, ny = (n_f32[:, 0:3].T, n_f32[:, 3:6].T) if prec.is_f32 else (n0, n1)
    refit = fallback == "both" and not prec.is_f32

    def chunk(o_c, d_c, skip_c, mind_c, maxd_c):
        of, df = o_c.to(f32), d_c.to(f32)
        Ox = of @ nx + e[:, 0]
        Dx = df @ nx
        Oy = of @ ny + e[:, 1]
        Dy = df @ ny
        Oz = of @ n2f + e[:, 2]
        Dz = df @ n2f
        t = -Oz / Dz
        t_dx = t * Dx
        t_dy = t * Dy
        u = Ox + t_dx
        v = Oy + t_dy
        s_ox = of.abs() @ a0 + e[:, 0].abs()
        s_dx = df.abs() @ a0
        s_oy = of.abs() @ a1 + e[:, 1].abs()
        s_dy = df.abs() @ a1
        error_u = (d12 * s_ox + t * d12 * s_dx + d1 * (Ox.abs() + 3 * t_dx.abs())) * 0.2
        error_v = (d12 * s_oy + t * d12 * s_dy + d1 * (Oy.abs() + 3 * t_dy.abs())) * 0.2
        w = 1.0 - u - v
        in_band = lambda x, err: (x >= -err) & (x <= 0)
        ambiguous = in_band(u, error_u) | in_band(v, error_v) | in_band(w, error_u + error_v)
        dtype_accept = (u > -error_u) & (v > -error_v) & (u + v < 1 + error_u + error_v)
        if refit:
            u32 = (of @ n_f32[:, 0:3].T + e[:, 0]) + t * (df @ n_f32[:, 0:3].T)
            v32 = (of @ n_f32[:, 3:6].T + e[:, 1]) + t * (df @ n_f32[:, 3:6].T)
            ok32 = (u32 > 0) & (v32 > 0) & (u32 + v32 < 1)
            u = torch.where(ambiguous, u32, u)
            v = torch.where(ambiguous, v32, v)
            accept = torch.where(ambiguous, ok32, dtype_accept)
        elif fallback == "both":
            strict = (u > 0) & (v > 0) & (u + v < 1)
            accept = torch.where(ambiguous, strict, dtype_accept)
        else:
            accept = dtype_accept
        accept = (accept & (t > mind_c[:, None]) & (t < maxd_c[:, None])
                  & (frame.dense_tri[None, :] != skip_c[:, None]) & torch.isfinite(t))
        t_masked = torch.where(accept, t, torch.inf)
        k = torch.argmin(t_masked, dim=1, keepdim=True)
        tk = torch.gather(t_masked, 1, k)[:, 0]
        hit = torch.isfinite(tk)
        take = lambda x: torch.gather(x, 1, k)[:, 0]
        return (torch.where(hit, tk, 1e5), torch.where(hit, take(u), 0.0),
                torch.where(hit, take(v), 0.0),
                torch.where(hit, frame.dense_tri[k[:, 0]], -1).to(torch.int32),
                torch.where(hit, frame.dense_obj[k[:, 0]], -1).to(torch.int32))

    step = max(1, PAIRS // max(TI, 1))
    parts = [chunk(o_sh[i:i + step], d_w[i:i + step], skip_tri[i:i + step],
                   mind[i:i + step], maxd[i:i + step]) for i in range(0, R, step)]
    return tuple(torch.cat(x) for x in zip(*parts))
