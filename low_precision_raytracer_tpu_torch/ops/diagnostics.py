"""Low-precision diagnostics (port of `low_precision_raytracer_tpu/ops/diagnostics.py`):
the fp32-fallback rate, the share of forward, finite (ray, instance
triangle) dtype tests that land inside the rounding-error band and are
re-run in f32 under `triangle_fallback='both'`.

Plain PyTorch in the matmul form of the JAX function (no kernel): the
rays and the coefficient rows rounded to the render dtype, each product
exact in f32 and summed in f32 (`torch.matmul` on the f32 copies; TF32 is
off, `config.resolve_device`).  The band is the JAX diagnostic's own
statement of it (the packet kernel's constants, with |u - Ox| for |t Dx|).
"""

from __future__ import annotations

import torch

from low_precision_raytracer_tpu_torch.config import Precision

CHUNK = 8192  # rays per slice: bounds the (slice, TI) f32 temporaries


def _fallback_counts(frame, origins, directions, prec: Precision):
    """One ray slice -> (tested, ambiguous) per ray, (n,) i64 each."""
    f32 = torch.float32
    dt = prec.dtype
    c = frame.dense_center
    o = (origins.to(f32) - c[None, :]).to(dt).to(f32)
    d = directions.to(dt).to(f32)
    TI = frame.dense_n_f32.shape[0]
    n_dt = frame.dense_n.reshape(TI, 9).to(f32)
    e = frame.dense_e
    n0, n1 = n_dt[:, 0:3].T, n_dt[:, 3:6].T
    n2f = frame.dense_n_f32.reshape(TI, 9)[:, 6:9].T

    Ox = o @ n0 + e[:, 0]
    Dx = d @ n0
    Oy = o @ n1 + e[:, 1]
    Dy = d @ n1
    Oz = o @ n2f + e[:, 2]
    Dz = d @ n2f
    t = -Oz / Dz
    u = Ox + t * Dx
    v = Oy + t * Dy

    d1 = torch.tensor(prec.delta1, dtype=f32)
    d2 = torch.tensor(prec.delta2, dtype=f32)
    d12 = d1 + d2
    ao, ad = o.abs(), d.abs()
    s_ox = ao @ n0.abs() + e[:, 0].abs()
    s_dx = ad @ n0.abs()
    s_oy = ao @ n1.abs() + e[:, 1].abs()
    s_dy = ad @ n1.abs()
    error_u = (d12 * s_ox + t * d12 * s_dx + d1 * (Ox.abs() + 3 * (u - Ox).abs())) * 0.2
    error_v = (d12 * s_oy + t * d12 * s_dy + d1 * (Oy.abs() + 3 * (v - Oy).abs())) * 0.2

    w = 1.0 - u - v
    in_band = lambda x, err: (x >= -err) & (x <= 0)
    # only forward, finite tests count
    valid = torch.isfinite(t) & (t > 0)
    ambiguous = (in_band(u, error_u) | in_band(v, error_v)
                 | in_band(w, error_u + error_v)) & valid
    return valid.sum(dim=1), ambiguous.sum(dim=1)


def fallback_rate(frame, origins, directions, prec: Precision, chunk: int = CHUNK) -> dict:
    """-> dict(tested, ambiguous, rate): counts over all (ray, instance
    triangle) dtype tests of the rays (R, 3), in slices of `chunk` rays."""
    tested = amb = 0
    for r0 in range(0, origins.shape[0], chunk):
        tc, ac = _fallback_counts(frame, origins[r0:r0 + chunk], directions[r0:r0 + chunk],
                                  prec)
        tested += int(tc.sum())
        amb += int(ac.sum())
    return dict(tested=tested, ambiguous=amb, rate=amb / max(tested, 1))
