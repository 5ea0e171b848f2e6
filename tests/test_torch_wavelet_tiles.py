"""PyTorch port, K4's coset tiling (`csrc/svgf.cu:wavelet_kernel`).

At stride s the 25 taps of pixel (y, x) lie on its coset (y mod s, x mod
s).  The kernel's blocks each stage a tile of coset points (8 coset rows
of one row coset, k = min(s, 8) neighbouring column cosets) and its
zero-filled 2-point ring in shared memory, then run the tap loop from the
staged points alone.  Here that tiling is emulated in PyTorch: every
block's staged points are built with the kernel's index arithmetic
(`ops/svgf_kernels.py:wavelet_tile_points`, cleaned by their masks as the
kernel stages them), each pixel reads its 25 taps from its own block's
tile, and the plain version's arithmetic then runs on those taps (with
the kernel's one shortcut: a dead centre's taps are not accumulated, as
its result is its raw value whatever they hold).  The emulation equals
`wavelet_iter_plain` bit for bit (NaN at the same places) at every stride
1-16 on a 37x53 frame and at the pipeline's strides on 5x7 (narrower than
2s from s = 4 on), with NaN, +-Inf and dead centres planted; so the tiles,
their ring, the zero fill and the shortcut reproduce the plain version
exactly."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu_torch.config import SVGFConfig
from low_precision_raytracer_tpu_torch.ops.svgf import WAVELET_H, _pow_int
from low_precision_raytracer_tpu_torch.ops.svgf_kernels import (
    C_B,
    C_DEPTH,
    C_FC,
    C_FV,
    C_G,
    C_IL0,
    C_NX,
    C_NY,
    C_NZ,
    C_PEN0,
    C_R,
    C_VAR,
    N_CV,
    N_CVI,
    N_GEO,
    GAUSS_G,
    wavelet_iter_plain,
    wavelet_staged_bytes,
    wavelet_tile_points,
    wavelet_tiles,
)

F = torch.nn.functional


def _planes(H, W, seed):
    """geo (11, H, W), cv (12, H, W) as the pipeline packs them, with NaN,
    +-Inf and dead centres (pen > 0) planted."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    geo = np.zeros((N_GEO, H, W), np.float32)
    geo[C_DEPTH] = 2 + 0.3 * np.sin(xx / 7.0) + 0.2 * np.cos(yy / 5.0)
    geo[1:3] = 0.05 * rng.standard_normal((2, H, W))
    n = np.stack([0.2 * np.sin(xx / 9.0), 0.2 * np.cos(yy / 8.0), np.ones((H, W))])
    geo[C_NX:C_NZ + 1] = n / np.linalg.norm(n, axis=0, keepdims=True)
    geo[6] = 1.0
    geo[C_IL0:C_IL0 + 2] = rng.random((2, H, W))
    geo[C_PEN0:C_PEN0 + 2] = np.where(rng.random((2, H, W)) < 0.05, 1e30, 0.0)
    cv = rng.random((N_CV, H, W)).astype(np.float32)
    for b in (0, N_CVI):
        cv[b + C_FC] = rng.random((H, W)) < 0.85
        cv[b + C_FV] = rng.random((H, W)) < 0.85
    m = rng.random((N_CV, H, W))
    cv[m < 0.02] = np.nan
    cv[(m > 0.5) & (m < 0.52)] = np.inf
    cv[(m > 0.7) & (m < 0.72)] = -np.inf
    g = rng.random((N_GEO, H, W))
    geo[C_DEPTH][g[0] < 0.02] = np.nan
    geo[C_IL0][g[1] < 0.02] = np.inf
    geo[1][g[2] < 0.01] = np.nan
    return torch.from_numpy(geo), torch.from_numpy(cv)


def _staged(geo, cv, stride):
    """Every block's staged points, as the kernel stages them: a dict of
    (blocks_y, blocks_x, staged rows, staged cols) planes, zero outside the
    frame, colour and variance cleaned by their masks."""
    _, H, W = cv.shape
    y, x = wavelet_tile_points(H, W, stride)
    inside = (y >= 0) & (y < H) & (x >= 0) & (x < W)
    yc, xc = y.clamp(0, H - 1), x.clamp(0, W - 1)
    take = lambda p: torch.where(inside, p[yc, xc], torch.zeros((), dtype=p.dtype))
    s = {"depth": take(geo[C_DEPTH]), "nx": take(geo[C_NX]), "ny": take(geo[C_NY]),
         "nz": take(geo[C_NZ]), "il": [take(geo[C_IL0]), take(geo[C_IL0 + 1])]}
    for i, b in enumerate((0, N_CVI)):
        fc, fv = take(cv[b + C_FC]), take(cv[b + C_FV])
        s[f"fc{i}"], s[f"fv{i}"] = fc, fv
        s[f"clean{i}"] = [torch.where(fc > 0, take(cv[b + c]), 0.0) for c in (C_R, C_G, C_B)] \
            + [torch.where(fv > 0, take(cv[b + C_VAR]), 0.0)]
    return s


def _tap_index(H, W, stride, ti, tj):
    """Where each pixel's tap (ti, tj) sits in its block's staged tile:
    (block y, block x, staged row, staged col), each (H, W)."""
    t = wavelet_tiles(H, W, stride)
    y = torch.arange(H)[:, None].expand(H, W)
    x = torch.arange(W)[None, :].expand(H, W)
    Y, X, cy, cx = y // stride, x // stride, y % stride, x % stride
    by = (Y // t.rows) * stride + cy
    bx = (X // t.cols) * t.groups + cx // t.k
    row = Y % t.rows + t.ring + ti
    col = (X % t.cols + t.ring + tj) * t.k + cx % t.k
    return by, bx, row, col


def wavelet_tiled(geo, cv, stride, cfg):
    """K4 with its taps read from the staged tiles: the plain version's
    arithmetic (`wavelet_iter_plain`, term for term) on taps gathered
    from each pixel's block."""
    _, H, W = cv.shape
    s = _staged(geo, cv, stride)
    cp = F.pad(cv, (1, 1, 1, 1))
    gp = F.pad(geo, (1, 1, 1, 1))
    view = lambda x, di, dj: x[..., 1 + di:1 + di + H, 1 + dj:1 + dj + W]
    depth_p, gx, gy, nx_p, ny_p, nz_p = (geo[c] for c in range(6))
    il_p = [geo[C_IL0], geo[C_IL0 + 1]]
    eps1 = cfg.sigma_z * cfg.eps
    sn = int(cfg.sigma_n)

    gnum = [torch.zeros_like(depth_p) for _ in (0, 1)]
    gden = torch.zeros_like(depth_p)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            g = GAUSS_G[abs(di)] * GAUSS_G[abs(dj)]
            gnum[0] = gnum[0] + g * view(cp[C_VAR], di, dj)
            gnum[1] = gnum[1] + g * view(cp[N_CVI + C_VAR], di, dj)
            gden = gden + g * view(gp[6], di, dj)
    recip2 = [1.0 / (cfg.sigma_l * torch.sqrt(gnum[i] / gden) + cfg.eps) for i in (0, 1)]

    live = [~(geo[C_PEN0 + i] > 0) for i in (0, 1)]
    zero = torch.zeros_like(depth_p)
    num_r, num_g, num_b = [zero] * 2, [zero] * 2, [zero] * 2
    den_c, num_v, den_v = [zero] * 2, [zero] * 2, [zero] * 2
    for tj in range(-2, 3):
        dj = tj * stride
        for ti in range(-2, 3):
            di = ti * stride
            at = _tap_index(H, W, stride, ti, tj)
            q = lambda plane: plane[at]
            hval = WAVELET_H[abs(ti)] * WAVELET_H[abs(tj)]
            dd = gx * float(di) + gy * float(dj)
            t1 = torch.abs(depth_p - q(s["depth"])) / torch.abs(dd + eps1)
            ndot = nx_p * q(s["nx"]) + ny_p * q(s["ny"]) + nz_p * q(s["nz"])
            hvn = hval * _pow_int(torch.clamp(ndot, min=0.0), sn)
            for i in (0, 1):
                t2 = torch.abs(il_p[i] - q(s["il"][i])) * recip2[i]
                hw = hvn * torch.exp(-(t1 + t2))
                hc = hw * q(s[f"fc{i}"])
                hv = hw * q(s[f"fv{i}"])
                clean = s[f"clean{i}"]
                # the kernel skips a dead centre's taps (its result is its
                # raw value whatever they hold)
                keep = lambda new, old: torch.where(live[i], new, old)
                num_r[i] = keep(num_r[i] + hc * q(clean[0]), num_r[i])
                num_g[i] = keep(num_g[i] + hc * q(clean[1]), num_g[i])
                num_b[i] = keep(num_b[i] + hc * q(clean[2]), num_b[i])
                den_c[i] = keep(den_c[i] + hc, den_c[i])
                num_v[i] = keep(num_v[i] + hv * hv * q(clean[3]), num_v[i])
                den_v[i] = keep(den_v[i] + hv, den_v[i])

    out = []
    for i, b in enumerate((0, N_CVI)):
        dead = geo[C_PEN0 + i] > 0
        dc = torch.where(dead, 0.0, den_c[i])
        dv = torch.where(dead, 0.0, den_v[i])
        oc = [num_r[i] / dc, num_g[i] / dc, num_b[i] / dc]
        valid_c = torch.isfinite(oc[0]) & torch.isfinite(oc[1]) & torch.isfinite(oc[2])
        ov = num_v[i] / (dv * dv)
        valid_v = torch.isfinite(ov)
        out += [torch.where(valid_c, oc[c], cv[b + c]) for c in range(3)]
        out += [torch.where(valid_v, ov, cv[b + C_VAR]),
                torch.where(valid_c, 1.0, cv[b + C_FC]),
                torch.where(valid_v, 1.0, cv[b + C_FV])]
    return torch.stack(out).contiguous()


def _assert_bitwise(got, want):
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    assert torch.equal(nan_g, nan_w)
    assert torch.equal(got.view(torch.int32)[~nan_g], want.view(torch.int32)[~nan_w])


@pytest.mark.parametrize("H, W, stride", [(37, 53, s) for s in range(1, 17)]
                         + [(5, 7, s) for s in (1, 2, 4, 8, 16)])
def test_tiled_taps_equal_plain(H, W, stride):
    geo, cv = _planes(H, W, seed=stride)
    cfg = SVGFConfig()
    want = wavelet_iter_plain(geo, cv, stride, cfg)
    got = wavelet_tiled(geo, cv, stride, cfg)
    _assert_bitwise(got, want)
    # the planted values reach the result: NaN and fallbacks both occur
    assert bool(torch.isnan(want).any()) and bool(torch.isfinite(want).any())


def test_every_pixel_is_one_block_centre():
    """Each pixel is the centre of exactly one thread of one block, its
    taps within that block's staged tile; the staging bytes count each
    in-frame point of each tile once."""
    for H, W, stride in ((37, 53, 3), (5, 7, 16), (1080, 1920, 16)):
        t = wavelet_tiles(H, W, stride)
        nr, nc = t.staged
        by, bx, row, col = _tap_index(H, W, stride, 0, 0)
        assert int(by.max()) < t.grid[1] and int(bx.max()) < t.grid[0]
        key = ((by * t.grid[0] + bx) * nr + row) * nc + col
        assert torch.unique(key).numel() == H * W
        for ti, tj in ((-2, -2), (2, 2)):
            _, _, r, c = _tap_index(H, W, stride, ti, tj)
            assert int(r.min()) >= 0 and int(r.max()) < nr
            assert int(c.min()) >= 0 and int(c.max()) < nc
        y, x = wavelet_tile_points(H, W, stride)
        inside = (y >= 0) & (y < H) & (x >= 0) & (x < W)
        assert wavelet_staged_bytes(H, W, stride) == int(inside.sum()) * 18 * 4
