"""The fused SVGF pipeline (port of `low_precision_raytracer_tpu/ops/svgf_pallas.py`):
the weighted history fetch (K2), the temporal accumulation of both
denoiser instances (K3) and the a-trous iteration (K4), with the packing
around them and the whole pair chain `svgf_pair_full`.

Every plane is unpadded channel-major (C, H, W) f32.  A tap outside the
image reads 0 in every channel, masks included, which is what the TPU
layout's zero pads gave.  Validity travels as data: depth NaN -> BIG (the
depth term kills the tap), normal NaN -> 0, a NaN gradient stays NaN (all
taps die -> fallback), colour and variance travel raw with NaN kept, and a
pixel whose taps all die falls back to its raw value.

Each kernel wrapper (`coef_fetch`, `temporal_accum`, `wavelet_iter`)
checks its inputs, runs the plain PyTorch version on CPU tensors and
launches the CUDA kernel of `csrc/svgf.cu` on CUDA tensors (or raises).
The plain versions follow the TPU kernels' arithmetic order.
`wavelet_tiles` and `wavelet_tile_points` mirror K4's coset tiling (the
CPU emulation of tests/test_torch_wavelet_tiles.py reads them), and
`wavelet_staged_bytes` counts what its staging reads.  `fetch_full_tiles`
and `coef_fetch_tiles_plain` mirror K2's tiles and its finite gate (the
CPU emulation of tests/test_torch_k2_k1a_culls.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from low_precision_raytracer_tpu_torch.config import SVGFConfig
from low_precision_raytracer_tpu_torch.ops import cuda_lib
from low_precision_raytracer_tpu_torch.ops.svgf import (
    GAUSS_G,
    WAVELET_H,
    SVGFState,
    pow_sigma_n,
)

BIG = 1e30  # sentinel: exp(-BIG) == 0

# geometry channels (N_GEO): sanitised depth, grad * sigma_z, sanitised
# normal, in-image indicator, per-instance sanitised illuminance, per-
# instance centre penalty BIG * (1 - geometry_valid)
(C_DEPTH, C_GX, C_GY, C_NX, C_NY, C_NZ, C_ONE,
 C_IL0, C_IL1, C_PEN0, C_PEN1) = range(11)
N_GEO = 11
# colour/variance channels per instance: raw rgb, raw variance, colour
# mask, variance mask
C_R, C_G, C_B, C_VAR, C_FC, C_FV = range(6)
N_CVI = 6
N_CV = 2 * N_CVI
# the fetch / temporal-kernel history channels (ctr order)
(T_H0R, T_H0G, T_H0B, T_H1R, T_H1G, T_H1B,
 T_M1_0, T_M1_1, T_M2_0, T_M2_1, T_FC) = range(11)
N_CTR = 11
LUM_W = (0.2126, 0.7152, 0.0722)
_TAPS = ((0, 0), (0, 1), (1, 0), (1, 1))


# ---------------------------------------------------------------------------
# packing


def pack_geometry_base(depth, grad, normal, cfg: SVGFConfig):
    """(7, H, W) f32 [depth_s, gx*sigma_z, gy*sigma_z, nx, ny, nz, one]:
    depth NaN -> BIG, normal NaN -> 0, grad kept raw and pre-scaled."""
    f32 = torch.float32
    depth = depth.to(f32)
    normal = normal.to(f32)
    grad = grad.to(f32)
    fin_n = torch.isfinite(normal).all(dim=-1)
    depth_s = torch.where(torch.isfinite(depth), depth, BIG)
    n_s = torch.where(fin_n[..., None], normal, 0.0)
    sz = cfg.sigma_z
    return torch.stack([depth_s, grad[..., 0] * sz, grad[..., 1] * sz,
                        n_s[..., 0], n_s[..., 1], n_s[..., 2],
                        torch.ones_like(depth)]).contiguous()


def geometry_valid2(depth, normal, illum2):
    """Per-instance 'geometry participates' mask (2, H, W) bool."""
    fin = torch.isfinite(depth) & torch.isfinite(normal).all(dim=-1)
    return fin[None] & torch.isfinite(illum2)


def pack_cv_pair(color2, var2, fgeo2):
    """(2, H, W, 3) colour + (2, H, W) variance (raw) + (2, H, W)
    geometry-valid -> (N_CV, H, W) f32 with 0/1 mask channels."""
    f32 = torch.float32
    color2 = color2.to(f32)
    var2 = var2.to(f32)
    chans = []
    for i in (0, 1):
        fc = (torch.isfinite(color2[i]).all(dim=-1) & fgeo2[i]).to(f32)
        fv = (torch.isfinite(var2[i]) & fgeo2[i]).to(f32)
        chans += [color2[i, ..., 0], color2[i, ..., 1], color2[i, ..., 2], var2[i], fc, fv]
    return torch.stack(chans).contiguous()


def unpack_cv_pair(cv):
    """(N_CV, H, W) -> (colour (2, H, W, 3), variance (2, H, W)), raw."""
    color = torch.stack([cv[b + C_R : b + C_B + 1].permute(1, 2, 0) for b in (0, N_CVI)])
    var = torch.stack([cv[b + C_VAR] for b in (0, N_CVI)])
    return color, var


def _check_planes(name, planes, H, W):
    dev = planes[0][1].device
    for want_c, x in planes:
        if (x.dtype != torch.float32 or not x.is_contiguous()
                or tuple(x.shape) != (want_c, H, W) or x.device != dev):
            raise ValueError(f"{name}: expected contiguous f32 ({want_c}, {H}, {W}) "
                             f"on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# K2: weighted temporal history fetch (shifted-select fast path)


def coef_fetch_plain(hist, rw, my: int, mx: int):
    """hist (C, H, W); rw (7, H, W) [res_y, res_x, w0..w3, count]; global
    motion (my, mx).  -> (C + 1, H, W): sum_k w_k tap_k / sum_k w_k (0
    where count == 0) and the count plane.  View (vy, vx) of pixel (y, x)
    reads the 1-pixel zero-padded history at ((y+1+vy+my) mod (H+2),
    (x+1+vx+mx) mod (W+2)); all 16 views are weighted, zero weights too."""
    C, H, W = hist.shape
    dev = hist.device
    P = F.pad(hist, (1, 1, 1, 1))
    res_y, res_x = rw[0], rw[1]
    wk = [rw[2 + k] for k in range(4)]
    count = rw[6]
    num = torch.zeros_like(hist)
    for vx in range(-1, 3):
        ix = (torch.arange(W, device=dev) + 1 + vx + mx) % (W + 2)
        for vy in range(-1, 3):
            coeff = None
            for k, (dy, dx) in enumerate(_TAPS):
                sy, sx = vy - dy, vx - dx
                if -1 <= sy <= 1 and -1 <= sx <= 1:
                    term = torch.where((res_y == float(sy)) & (res_x == float(sx)), wk[k], 0.0)
                    coeff = term if coeff is None else coeff + term
            iy = (torch.arange(H, device=dev) + 1 + vy + my) % (H + 2)
            num = num + coeff * P[:, iy][:, :, ix]
    den = wk[0] + wk[1] + wk[2] + wk[3]
    den_safe = torch.where(den > 0, den, 1.0)
    out = torch.where(count > 0, num / den_safe, 0.0)
    return torch.cat([out, count[None]], dim=0)


FETCH_TILE = (16, 64)  # K2's tile, rows x columns (csrc/svgf.cu: F_TH, F_TW)


def fetch_full_tiles(hist, my: int, mx: int):
    """K2's finite gate: (tiles_y, tiles_x) bool, True where the tile's
    staged history window (the tile with a ring of 1 pixel before and 2
    after in each axis, wrapped and zero-padded as the views read it, all
    channels) holds a non-finite value, so the kernel sums all 16 views
    there."""
    C, H, W = hist.shape
    TH, TW = FETCH_TILE
    dev = hist.device
    bad = ~torch.isfinite(F.pad(hist, (1, 1, 1, 1))).all(dim=0)  # (H + 2, W + 2)
    span = lambda n, t, m, size: (torch.arange(-(-n // t), device=dev)[:, None] * t
                                  + torch.arange(t + 3, device=dev)[None, :] + m) % size
    rows, cols = span(H, TH, my, H + 2), span(W, TW, mx, W + 2)
    return bad[rows].any(dim=1)[:, cols].any(dim=-1)


def coef_fetch_tiles_plain(hist, rw, my: int, mx: int):
    """K2's loop (`csrc/svgf.cu:coef_fetch_kernel`) in plain PyTorch: on the
    tiles whose staged window is finite (`fetch_full_tiles`) each pixel sums
    only the four views its residual selects, w_k times tap k in the order
    k = 0, 2, 1, 3 from +0 (+0 where the residual is outside the window);
    elsewhere the 16-view sum of `coef_fetch_plain`.  Equal to it bit for
    bit (the proof is in the kernel's source)."""
    C, H, W = hist.shape
    TH, TW = FETCH_TILE
    dev = hist.device
    full = fetch_full_tiles(hist, my, mx)
    full_px = full.repeat_interleave(TH, 0).repeat_interleave(TW, 1)[:H, :W]
    P = F.pad(hist, (1, 1, 1, 1))
    res_y, res_x = rw[0], rw[1]
    wk = [rw[2 + k] for k in range(4)]
    count = rw[6]
    win = lambda r: (r == -1) | (r == 0) | (r == 1)
    m = win(res_y) & win(res_x)
    ry = torch.where(m, res_y, 0.0).long()
    rx = torch.where(m, res_x, 0.0).long()
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]

    def tap(dy, dx):  # view (ry + dy, rx + dx) of every pixel, (C, H, W)
        return P[:, (yy + 1 + ry + dy + my) % (H + 2), (xx + 1 + rx + dx + mx) % (W + 2)]

    num = torch.zeros_like(hist)
    for k in (0, 2, 1, 3):
        num = num + wk[k] * tap(*_TAPS[k])
    num = torch.where(m, num, 0.0)
    den = wk[0] + wk[1] + wk[2] + wk[3]
    den_safe = torch.where(den > 0, den, 1.0)
    fast = torch.where(count > 0, num / den_safe, 0.0)
    out = torch.where(full_px, coef_fetch_plain(hist, rw, my, mx)[:C], fast)
    return torch.cat([out, count[None]], dim=0)


def coef_fetch(hist, rw, my: int, mx: int):
    """Kernel wrapper of `coef_fetch_plain` (TPU: `_coef_fetch_kernel`)."""
    C, H, W = hist.shape
    dev = _check_planes("coef_fetch", [(C, hist), (7, rw)], H, W)
    if C > 16:
        raise ValueError("coef_fetch: at most 16 history channels")
    if dev.type == "cpu":
        return coef_fetch_plain(hist, rw, my, mx)
    out = torch.empty((C + 1, H, W), dtype=torch.float32, device=dev)
    code = cuda_lib.library("svgf").lprt_coef_fetch(
        hist.data_ptr(), rw.data_ptr(), C, H, W, int(my), int(mx),
        out.data_ptr(), cuda_lib.stream_ptr(dev))
    cuda_lib.check(code, "coef_fetch")
    cuda_lib.LAUNCHES["coef_fetch"] += 1
    return out


# ---------------------------------------------------------------------------
# K3: temporal accumulation, both instances


def _box9(x, H, W):
    """9x9 box sums of (C, H + 12, W + 12) planes (image at offset 6) on the
    stage-1 domain (image +- 2): the 9 column offsets first, then the 9
    row offsets, each in order."""
    csum = x[..., 0 : W + 4]
    for dj in range(1, 9):
        csum = csum + x[..., dj : dj + W + 4]
    out = csum[..., 0 : H + 4, :]
    for di in range(1, 9):
        out = out + csum[..., di : di + H + 4, :]
    return out


def temporal_accum_plain(col6, geo7, ctr11, cfg: SVGFConfig, color_w: float,
                         moments_w: float):
    """col6 (6, H, W) raw colour [inst0 rgb | inst1 rgb]; geo7 (7, H, W)
    from pack_geometry_base; ctr11 (11, H, W) the fetched history.
    -> (cv (12, H, W), ext (4, H, W) [il0, il1, pen0, pen1],
        mst (4, H, W) [m1_0, m1_1, m2_0, m2_1])."""
    f32 = torch.float32
    _, H, W = col6.shape
    w_c = torch.tensor(color_w, dtype=f32)
    one_m_wc = 1.0 - w_c
    # stage 1 on the image +- 2 (the 5x5 moments read it there)
    colp = F.pad(col6, (6, 6, 6, 6))
    one_p = F.pad(torch.ones_like(col6[0]), (6, 6, 6, 6))
    fin = torch.isfinite(colp)
    finv = torch.where(fin, 1.0, 0.0) * one_p
    safe = torch.where(fin, colp, 0.0) * one_p
    rs_f = _box9(finv, H, W)
    rs_s = _box9(safe, H, W)
    rs_s2 = _box9(safe * safe, H, W)
    m1c = rs_s / rs_f
    m2c = rs_s2 / rs_f
    raw = colp[:, 4 : H + 8, 4 : W + 8]
    p = torch.where(torch.isfinite(raw), raw, m1c)
    stdc = torch.sqrt(m2c - m1c * m1c)
    clamped = torch.minimum(torch.maximum(p, m1c - 0.5 * stdc), m1c + 0.5 * stdc)
    p = torch.where(torch.isfinite(stdc), clamped, p)
    ctr_s1 = F.pad(ctr11, (2, 2, 2, 2))
    fc_s1 = ctr_s1[T_FC]
    hist = torch.where(fc_s1 > 0, ctr_s1[0:6], p)
    hist = torch.where(torch.isfinite(hist), hist, p)
    ic = w_c * p + one_m_wc * hist  # (6, H + 4, W + 4)
    one_s1 = one_p[4 : H + 8, 4 : W + 8]
    il, fil = [], []
    for i in (0, 1):
        acc = LUM_W[0] * ic[3 * i] + LUM_W[1] * ic[3 * i + 1] + LUM_W[2] * ic[3 * i + 2]
        fin_i = torch.isfinite(acc)
        il.append(torch.where(fin_i, acc, 0.0))
        fil.append(torch.where(fin_i, 1.0, 0.0) * one_s1)

    # 5x5 bilateral moments on the image
    geop = F.pad(geo7, (2, 2, 2, 2))
    depth_p, gx, gy, nx_p, ny_p, nz_p = (geo7[c] for c in range(6))
    eps1 = cfg.sigma_z * cfg.eps
    num = [torch.zeros_like(depth_p) for _ in (0, 1)]
    num2 = [torch.zeros_like(depth_p) for _ in (0, 1)]
    wsum = [torch.zeros_like(depth_p) for _ in (0, 1)]
    for tj in range(-2, 3):
        for ti in range(-2, 3):
            q = lambda x: x[..., 2 + ti : 2 + ti + H, 2 + tj : 2 + tj + W]
            hval = WAVELET_H[abs(ti)] * WAVELET_H[abs(tj)]
            dd = gx * float(ti) + gy * float(tj)
            t1 = torch.abs(depth_p - q(geop[C_DEPTH])) / torch.abs(dd + eps1)
            ndot = nx_p * q(geop[C_NX]) + ny_p * q(geop[C_NY]) + nz_p * q(geop[C_NZ])
            w_n = pow_sigma_n(torch.clamp(ndot, min=0.0), cfg.sigma_n)
            hw = hval * torch.exp(-t1) * w_n
            for i in (0, 1):
                hm = hw * q(fil[i])
                iq = q(il[i])
                num[i] = num[i] + hm * iq
                num2[i] = num2[i] + hm * iq * iq
                wsum[i] = wsum[i] + hm

    ctr = lambda x: x[..., 2 : 2 + H, 2 : 2 + W]
    mw = torch.tensor(moments_w, dtype=f32)
    one_m_mw = 1.0 - mw
    spatial = ctr11[T_FC] < float(cfg.spatial_moments_below)
    n2 = nx_p * nx_p + ny_p * ny_p + nz_p * nz_p
    geo_ok_base = (depth_p < BIG * 0.5) & (n2 > 0.5)
    cv, ext, mst = [], [None] * 4, [None] * 4
    for i in (0, 1):
        ic_c = [ctr(ic[3 * i + c]) for c in range(3)]
        ilc = ctr(il[i])
        m1_t = one_m_mw * ctr11[T_M1_0 + i] + mw * ilc
        m1_t = torch.where(torch.isfinite(m1_t), m1_t, ilc)
        il2 = ilc * ilc
        m2_t = one_m_mw * ctr11[T_M2_0 + i] + mw * il2
        m2_t = torch.where(torch.isfinite(m2_t), m2_t, il2)
        miu1 = torch.where(spatial, num[i] / wsum[i], m1_t)
        miu2 = torch.where(spatial, num2[i] / wsum[i], m2_t)
        var = miu2 - miu1 * miu1
        fin_ic = torch.isfinite(ic_c[0]) & torch.isfinite(ic_c[1]) & torch.isfinite(ic_c[2])
        geo_ok = geo_ok_base & (ctr(fil[i]) > 0)
        cv += ic_c + [var, (fin_ic & geo_ok).to(f32), (torch.isfinite(var) & geo_ok).to(f32)]
        ext[i] = ilc
        ext[2 + i] = torch.where(geo_ok, 0.0, BIG)
        mst[i] = miu1
        mst[2 + i] = miu2
    return (torch.stack(cv).contiguous(), torch.stack(ext).contiguous(),
            torch.stack(mst).contiguous())


def temporal_accum(col6, geo7, ctr11, cfg: SVGFConfig, color_w: float,
                   moments_w: float):
    """Kernel wrapper of `temporal_accum_plain` (TPU: `_temporal_kernel`)."""
    _, H, W = col6.shape
    dev = _check_planes("temporal_accum", [(6, col6), (7, geo7), (N_CTR, ctr11)], H, W)
    if dev.type == "cpu":
        return temporal_accum_plain(col6, geo7, ctr11, cfg, color_w, moments_w)
    cv = torch.empty((N_CV, H, W), dtype=torch.float32, device=dev)
    ext = torch.empty((4, H, W), dtype=torch.float32, device=dev)
    mst = torch.empty((4, H, W), dtype=torch.float32, device=dev)
    code = cuda_lib.library("svgf").lprt_temporal(
        col6.data_ptr(), geo7.data_ptr(), ctr11.data_ptr(), H, W,
        float(color_w), float(moments_w), float(cfg.spatial_moments_below),
        float(cfg.sigma_n), float(cfg.sigma_z * cfg.eps), cv.data_ptr(),
        ext.data_ptr(), mst.data_ptr(), cuda_lib.stream_ptr(dev))
    cuda_lib.check(code, "temporal_accum")
    cuda_lib.LAUNCHES["temporal_accum"] += 1
    return cv, ext, mst



# ---------------------------------------------------------------------------
# K4: one a-trous iteration, both instances


def wavelet_iter_plain(geo, cv, stride: int, cfg: SVGFConfig):
    """geo (11, H, W), cv (12, H, W) -> next cv (12, H, W)."""
    _, H, W = cv.shape
    k = 2 * stride
    gp = F.pad(geo, (k, k, k, k))
    cp = F.pad(cv, (k, k, k, k))
    view = lambda x, di, dj: x[..., k + di : k + di + H, k + dj : k + dj + W]
    depth_p, gx, gy, nx_p, ny_p, nz_p = (geo[c] for c in range(6))
    il_p = [geo[C_IL0], geo[C_IL1]]
    eps1 = cfg.sigma_z * cfg.eps

    gnum = [torch.zeros_like(depth_p) for _ in (0, 1)]
    gden = torch.zeros_like(depth_p)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            g = GAUSS_G[abs(di)] * GAUSS_G[abs(dj)]
            gnum[0] = gnum[0] + g * view(cp[C_VAR], di, dj)
            gnum[1] = gnum[1] + g * view(cp[N_CVI + C_VAR], di, dj)
            gden = gden + g * view(gp[C_ONE], di, dj)
    recip2 = [1.0 / (cfg.sigma_l * torch.sqrt(gnum[i] / gden) + cfg.eps) for i in (0, 1)]

    # sanitised tap copies: raw * mask is NaN-unsafe, so select
    clean = [[torch.where(cp[b + C_FC] > 0, cp[b + c], 0.0) for c in (C_R, C_G, C_B)]
             + [torch.where(cp[b + C_FV] > 0, cp[b + C_VAR], 0.0)] for b in (0, N_CVI)]
    zero = torch.zeros_like(depth_p)
    num_r, num_g, num_b = [zero] * 2, [zero] * 2, [zero] * 2
    den_c, num_v, den_v = [zero] * 2, [zero] * 2, [zero] * 2
    for tj in range(-2, 3):
        dj = tj * stride
        for ti in range(-2, 3):
            di = ti * stride
            q = lambda x: view(x, di, dj)
            hval = WAVELET_H[abs(ti)] * WAVELET_H[abs(tj)]
            dd = gx * float(di) + gy * float(dj)
            t1 = torch.abs(depth_p - q(gp[C_DEPTH])) / torch.abs(dd + eps1)
            ndot = nx_p * q(gp[C_NX]) + ny_p * q(gp[C_NY]) + nz_p * q(gp[C_NZ])
            hvn = hval * pow_sigma_n(torch.clamp(ndot, min=0.0), cfg.sigma_n)
            for i, b in enumerate((0, N_CVI)):
                t2 = torch.abs(il_p[i] - q(gp[C_IL0 + i])) * recip2[i]
                hw = hvn * torch.exp(-(t1 + t2))
                hc = hw * q(cp[b + C_FC])
                hv = hw * q(cp[b + C_FV])
                num_r[i] = num_r[i] + hc * q(clean[i][0])
                num_g[i] = num_g[i] + hc * q(clean[i][1])
                num_b[i] = num_b[i] + hc * q(clean[i][2])
                den_c[i] = den_c[i] + hc
                num_v[i] = num_v[i] + hv * hv * q(clean[i][3])
                den_v[i] = den_v[i] + hv

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


class WaveletTiles(NamedTuple):
    """The coset tiling of K4 (`csrc/svgf.cu:wavelet_kernel`) at one
    stride: a block takes `rows` coset rows of one row coset and `k`
    neighbouring column cosets of `cols` coset columns each, and stages
    them with a `ring` of coset points on every side."""

    k: int  # column cosets a block covers
    groups: int  # blocks across the column cosets of one tile
    cols: int  # coset columns per column coset
    rows: int  # coset rows
    ring: int
    grid: tuple  # (blocks across x, blocks across y)

    @property
    def staged(self) -> tuple:
        """(staged rows, staged columns) of a block's tile and ring."""
        return self.rows + 2 * self.ring, (self.cols + 2 * self.ring) * self.k


WT_X, WT_Y, WT_KMAX, WT_RING = 32, 8, 4, 2  # csrc/svgf.cu's tile constants
STAGED_FLOATS = 18  # floats a staged point holds: depth, n, il0, il1, 2 x (rgb, v, fc, fv)


def wavelet_tiles(H: int, W: int, stride: int) -> WaveletTiles:
    """K4's tile geometry at `stride` on an (H, W) frame (the kernel's
    own arithmetic, `launch_wavelet` and `wavelet_kernel`)."""
    k = min(stride, WT_KMAX)
    groups = -(-stride // k)
    cols = WT_X // k
    tiles_x = -(-(-(-W // stride)) // cols)
    tiles_y = -(-(-(-H // stride)) // WT_Y)
    return WaveletTiles(k, groups, cols, WT_Y, WT_RING, (tiles_x * groups, tiles_y * stride))


def wavelet_tile_points(H: int, W: int, stride: int):
    """The points each block of K4 stages, as frame coordinates:
    -> (y, x) int64 tensors (blocks_y, blocks_x, staged rows, staged
    columns); points outside the frame (y or x out of range) are staged
    as zeros.  Mirrors the kernel's staging loop."""
    t = wavelet_tiles(H, W, stride)
    nr, nc = t.staged
    by = torch.arange(t.grid[1])[:, None, None, None]
    bx = torch.arange(t.grid[0])[None, :, None, None]
    r = torch.arange(nr)[None, None, :, None]
    c = torch.arange(nc)[None, None, None, :]
    cx0 = (bx % t.groups) * t.k
    X0 = (bx // t.groups) * t.cols
    cy = by % stride
    Y0 = (by // stride) * t.rows
    x = (X0 + torch.div(c, t.k, rounding_mode="floor") - t.ring) * stride + cx0 + c % t.k
    y = (Y0 + r - t.ring) * stride + cy
    return y.expand(-1, t.grid[0], -1, nc), x.expand(t.grid[1], -1, nr, -1)


def wavelet_staged_bytes(H: int, W: int, stride: int) -> int:
    """Bytes K4's staging reads from device memory in one launch: the
    STAGED_FLOATS channels of every in-frame point of every block's tile
    and ring (points staged by two blocks count twice)."""
    y, x = wavelet_tile_points(H, W, stride)
    inside = (y >= 0) & (y < H) & (x >= 0) & (x < W)
    return int(inside.sum()) * STAGED_FLOATS * 4


def wavelet_iter(geo, cv, stride: int, cfg: SVGFConfig):
    """Kernel wrapper of `wavelet_iter_plain` (TPU: `_wavelet_kernel`)."""
    _, H, W = cv.shape
    dev = _check_planes("wavelet_iter", [(N_GEO, geo), (N_CV, cv)], H, W)
    if dev.type == "cpu":
        return wavelet_iter_plain(geo, cv, stride, cfg)
    out = torch.empty_like(cv)
    code = cuda_lib.library("svgf").lprt_wavelet(
        geo.data_ptr(), cv.data_ptr(), H, W, int(stride), float(cfg.sigma_n),
        float(cfg.sigma_l), float(cfg.eps), float(cfg.sigma_z * cfg.eps),
        out.data_ptr(), cuda_lib.stream_ptr(dev))
    cuda_lib.check(code, "wavelet_iter")
    cuda_lib.LAUNCHES["wavelet_iter"] += 1
    return out


# ---------------------------------------------------------------------------
# the pair chain


def svgf_pair_full(color2, ctr11, depth, grad, normal, cfg: SVGFConfig,
                   color_w: float, moments_w: float):
    """The whole SVGF pair: temporal accumulation (K3) then the a-trous
    chain (K4 per stride); the first stride's output is next frame's
    colour history.  color2 (2, H, W, 3); ctr11 (11, H, W) the fetched
    history (K2).  -> (out_color2 (2, H, W, 3) f32, SVGFState with
    (2, ...) leaves: f32 under `state_f32`, else color2's dtype, as the JAX
    package rounds them)."""
    f32 = torch.float32
    _, H, W, _ = color2.shape
    geo7 = pack_geometry_base(depth, grad, normal, cfg)
    col6 = color2.to(f32).permute(0, 3, 1, 2).reshape(6, H, W).contiguous()
    cv, ext, mst = temporal_accum(col6, geo7, ctr11.contiguous(), cfg, color_w, moments_w)
    geo = torch.cat([geo7, ext], dim=0)
    history2 = None
    for it, s in enumerate(cfg.strides):
        cv = wavelet_iter(geo, cv, s, cfg)
        if it == 0:
            history2, _ = unpack_cv_pair(cv)
    out2, _ = unpack_cv_pair(cv)
    if history2 is None:
        history2 = out2
    sdt = f32 if cfg.state_f32 else color2.dtype
    state2 = SVGFState(miu1=mst[0:2].to(sdt), miu2=mst[2:4].to(sdt),
                       color_history=history2.to(sdt))
    return out2, state2
