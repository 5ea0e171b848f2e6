"""Temporal reprojection (port of `low_precision_raytracer_tpu/ops/reproject.py`:
`generate_temporal_maps` with `packed=True`, `_footprint`, `_residuals`,
`fetch_weighted_packed` and, for the TAA half, `fetch_weighted`).

Each pixel's f32 hit position is reprojected through its object's
composite matrix (last W2C @ last L2W @ current W2L) to last frame's
screen; the 2x2 bilinear footprint there is validated per tap by mesh id,
renormalised, and carries the frame count forward.  The history fetch
takes the fast shifted path (K2, ops/svgf_kernels.coef_fetch) when every
caring anchor sits within one pixel of pixel + one global motion, else
the general 2x2 take in plain PyTorch, as the JAX package runs it in XLA.
Choosing the branch reads one flag from the device (a host sync per
frame).

The TAA half (when the TAA blend runs) reprojects a second footprint
jittered by a per-pixel word of 32 random bits (16 bits per axis),
validates its taps by mesh id only (the weights stay bilinear, renormalised
over the in-bounds taps; a tap of the same mesh only gates the count), and
fetches the (H, W, 3) colour history weighted, as `fetch_weighted` does.
The JAX package computes all of this in XLA, outside any Pallas kernel;
the port computes it in plain PyTorch, and fetches through the general 2x2
take on every frame.  That take reads the same taps as the JAX package's
residual fast path; the sums may differ in the last f32 bits, since the fast
path sums coefficient planes, and a non-finite history value can reach
different pixels through a zero weight (the blend replaces non-finite
history by the frame's colour).

Under a row mesh of more than one rank (`parallel/tiling.py`) the fetch
copies the JAX package's `_gather2x2_halo`: each rank takes
kh = min(HALO_ROWS, h) image rows from each neighbour (one exchange
carries every history plane both halves read), rows past the image edge
read zero, and an anchor beyond the halo reads zero in every tap, so that
pixel's history restarts.  K2 and the residual test are off there, as in
the JAX package (`render/renderer.py:297`, `ops/reproject.py:465-471`):
every frame takes the general 2x2 take, `halo_take` on the rank's rows
and the strips.  The general take sums w_k tap_k in K2's order (k = 0,
2, 1, 3), so a finite history fetches the same bits on either branch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from low_precision_raytracer_tpu_torch.math.vec import matvec
from low_precision_raytracer_tpu_torch.ops.svgf_kernels import coef_fetch

RES_K = 1  # residual radius of the shifted fast path
# rows each rank takes from each neighbour for the fetch under a row mesh:
# 16 rows of vertical motion a frame plus the footprint's second row (JAX
# `ops/reproject.py:HALO_ROWS`); anchors further away restart their history
HALO_ROWS = 17


def _footprint(fx, fy, H: int, W: int, dt):
    """2x2 bilinear footprint: anchor (trunc toward zero), per-tap weights
    in `dt` in window order, per-tap in-bounds masks; anchors pre-shifted
    for a 1-pixel pad and clipped into range."""
    lx = torch.trunc(fx)
    ly = torch.trunc(fy)
    wx1 = (fx - lx).to(dt)
    wy1 = (fy - ly).to(dt)
    wx0 = ((lx + 1) - fx).to(dt)
    wy0 = ((ly + 1) - fy).to(dt)
    w = torch.stack([wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1], dim=-1)
    lyi = ly.to(torch.int32)
    lxi = lx.to(torch.int32)
    y0_ok = (lyi >= 0) & (lyi < H)
    y1_ok = (lyi + 1 >= 0) & (lyi + 1 < H)
    x0_ok = (lxi >= 0) & (lxi < W)
    x1_ok = (lxi + 1 >= 0) & (lxi + 1 < W)
    inb = torch.stack([y0_ok & x0_ok, y0_ok & x1_ok, y1_ok & x0_ok, y1_ok & x1_ok], dim=-1)
    base_y = torch.clamp(lyi + 1, 0, H)
    base_x = torch.clamp(lxi + 1, 0, W)
    inb = inb & (lyi + 1 == base_y)[..., None] & (lxi + 1 == base_x)[..., None]
    return base_y, base_x, w, inb


def _residuals(base_y, base_x, care):
    """Global integer motion (my, mx) (0-dim int tensors), per-pixel
    residual planes and the all_ok flag (0-dim bool): every caring anchor
    within RES_K of pixel + (my, mx)."""
    H, W = base_y.shape
    dev = base_y.device
    row = torch.arange(H, dtype=torch.int32, device=dev)[:, None]
    col = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    dy = base_y - (row + 1)
    dx = base_x - (col + 1)
    cf = care.to(torch.float32)
    n = torch.clamp(torch.sum(cf), min=1.0)
    my = torch.round(torch.sum(dy * cf) / n).to(torch.int32)
    mx = torch.round(torch.sum(dx * cf) / n).to(torch.int32)
    res_y = dy - my
    res_x = dx - mx
    in_win = (torch.abs(res_y) <= RES_K) & (torch.abs(res_x) <= RES_K)
    all_ok = torch.all(in_win | ~care)
    return my, mx, res_y, res_x, all_ok


def _gather2x2(planes, base_y, base_x):
    """The 4 taps (k, C, H, W) of every anchor from the 1-pixel zero-padded
    (C, H, W) planes, tap order [(0,0), (0,1), (1,0), (1,1)]."""
    P = F.pad(planes, (1, 1, 1, 1))
    by, bx = base_y.long(), base_x.long()
    return torch.stack([P[:, by + dy, bx + dx] for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1))])


def halo_take(planes, above, below, base_y, base_x, r0: int, H: int):
    """The 2x2 take of one rank under a row mesh (JAX `_gather2x2_halo`'s
    shard-local part): planes (C, h, W) the rank's rows [r0, r0 + h) of an
    H-row frame, above / below (C, kh, W) the kh image rows on either side
    (`parallel/halo.py:exchange_rows`); base_* (h, W) global anchors
    pre-shifted for the 1-pixel pad.  -> (taps (4, C, h, W) in tap order,
    miss (h, W) bool): an anchor whose rows leave the rank's rows and the
    strips reads zero in all four taps (its first row outside) or in its
    second row (that row an image row past the lower strip); `miss` marks
    both."""
    C, h, W = planes.shape
    kh = above.shape[1]
    ext = torch.cat([above, planes, below], dim=1)  # image rows r0 - kh .. r0 + h + kh
    gr = torch.arange(r0 - kh, r0 + h + kh, device=planes.device)
    ext = torch.where(((gr >= 0) & (gr < H))[None, :, None], ext, torch.zeros_like(ext))
    P = F.pad(ext, (1, 1, 0, 1))  # a zero column on each side, a zero row below
    n = h + 2 * kh
    ly = base_y.long() - 1 - r0 + kh  # the anchor's first row in ext
    reach = (ly >= 0) & (ly <= n - 1)
    lyc = torch.clamp(ly, 0, n - 1)
    bx = base_x.long()
    taps = torch.stack([P[:, lyc + dy, bx + dx] for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1))])
    taps = torch.where(reach[None, None], taps, torch.zeros_like(taps))
    miss = ~reach | ((ly == n - 1) & (base_y < H))
    return taps, miss


def _weighted_ctr(taps, wgt, count):
    """The general take's finished fetch in the temporal kernel's channel
    order: taps (4, C, H, W) -> (C + 1, H, W) f32, sum_k w_k tap_k in K2's
    order (k = 0, 2, 1, 3) over sum_k w_k, 0 where count == 0, then the
    count plane."""
    f32 = torch.float32
    wk = wgt.to(f32).permute(2, 0, 1)[:, None]  # (4, 1, H, W)
    num = taps[0] * wk[0] + taps[2] * wk[2] + taps[1] * wk[1] + taps[3] * wk[3]
    den = wk[0] + wk[1] + wk[2] + wk[3]
    out = num / torch.where(den > 0, den, 1.0)
    out = torch.where(count > 0, out, 0.0)
    return torch.cat([out, count.to(f32)[None]], dim=0)


def fetch_weighted_packed(payload_cm, base_y, base_x, wgt, count, residuals):
    """Finished weighted fetch in the temporal kernel's channel order:
    -> (C + 1, H, W) f32 = [sum_k w_k tap_k / sum_k w_k (0 where count
    == 0) | count].  Also returns whether the fast path (K2) ran."""
    f32 = torch.float32
    my, mx, res_y, res_x, all_ok = residuals
    my_h, mx_h, ok_h = torch.stack([my, mx, all_ok.to(torch.int32)]).tolist()
    if ok_h:
        w32 = wgt.to(f32)
        rw = torch.stack([res_y.to(f32), res_x.to(f32)]
                         + [w32[..., k] for k in range(4)] + [count.to(f32)])
        return coef_fetch(payload_cm.contiguous(), rw.contiguous(), my_h, mx_h), True
    return _weighted_ctr(_gather2x2(payload_cm.to(f32), base_y, base_x), wgt, count), False


def fetch_weighted(taps, wgt, count):
    """Finished weighted fetch of a history's 2x2 taps (4, C, H, W):
    -> (H, W, C) f32 = sum_k w_k tap_k / sum_k w_k, 0 where count == 0."""
    wk = wgt.to(torch.float32).permute(2, 0, 1)[:, None]  # (4, 1, H, W)
    num = taps[0] * wk[0] + taps[1] * wk[1] + taps[2] * wk[2] + taps[3] * wk[3]
    den = wk[0] + wk[1] + wk[2] + wk[3]
    out = torch.where(count > 0, num / torch.where(den > 0, den, 1.0), 0.0)
    return out.permute(1, 2, 0)


def taa_jitter(bits, dt):
    """Sub-pixel jitter from a (H, W) word of 32 random bits (int64 in
    [0, 2^32)): 16 bits per axis, computed in f32, rounded to `dt`."""
    f32 = torch.float32
    jx = ((bits & 0xFFFF).to(f32) * (1.0 / 65536.0)).to(dt)
    jy = ((bits >> 16).to(f32) * (1.0 / 65536.0)).to(dt)
    return jx, jy


def generate_temporal_maps(g, frame, state, width: int, height: int, dtype,
                           position_f32, svgf_payload, taa_payload=None, taa_bits=None,
                           mesh=None):
    """The SVGF temporal map and its packed history fetch, and the TAA map
    and its history fetch when `taa_bits` is given.
    g: G-buffer dict of (h, W, ...) tensors; state: FrameState;
    position_f32: (h, W, 3) f32 hit positions to reproject, or None for
    the G-buffer's position (fp32); svgf_payload: (10, h, W) f32 history in
    ctr order or None; taa_payload: (h, W, 3) history or None; taa_bits:
    (h, W) int64 random words in [0, 2^32) or None (no TAA half).  h is
    `height`, or under `mesh` (a row mesh of more than one rank,
    `parallel/tiling.py:PixelMesh`: the halo fetch) this rank's rows of it.
    -> (svgf_map dict(frame_count, weights, base_y, base_x; under a mesh
        also halo_misses, the caring pixels of both maps whose anchor left
        the halo, a 0-dim int64 tensor), ctr (11, h, W) or None, fast_path
        (bool or None), taa_map (same keys) or None, taa_pre (h, W, 3) f32
        or None)."""
    dt = dtype
    H, W = height, width
    f32 = torch.float32
    valid = g["valid"]
    h = valid.shape[0]
    obj = g["obj"].long()
    mesh_p = frame.obj_mesh[obj]
    # the per-object composite is computed whole on every rank, so its
    # batched `@` gives every rank the same bits; the per-pixel product is
    # a fixed-order sum ((c0 x + c1 y) + c2 z) + c3, the same bits on any
    # number of rows (a batched `@` over the pixels is not, on a GPU).  Of
    # the orders tried this one is closest to the JAX matmul (71% of
    # random clip values bit-equal against 63% for (2, 1, 0)) and gives
    # the CPU's batched `@` its own bits
    comp = state.last_w2c[None] @ state.last_l2w @ frame.obj_w2l_f32  # (O, 4, 4)
    comp_px = comp[obj]  # (h, W, 4, 4)
    pos = (position_f32 if position_f32 is not None else g["position"]).to(f32)
    clip = matvec(comp_px[..., :3], pos) + comp_px[..., 3]
    g_fx = (1 + clip[..., 0] / clip[..., 3]) / 2 * W
    g_fy = (1 + clip[..., 1] / clip[..., 3]) / 2 * H

    # the history planes the fetches read: last-frame validation data
    # (mesh id + 1, frame count; exact small integers, fetched as integers
    # where the JAX package packs them into float channels, exact for the
    # same ranges), the SVGF payload and the TAA colour
    val = torch.stack([state.last_mesh_id + 1, torch.clamp(state.svgf_frame_count, 0, 255)])
    want_taa = taa_bits is not None
    planes = {"val": val}
    if svgf_payload is not None:
        planes["svgf"] = svgf_payload.to(f32)
    if want_taa and taa_payload is not None:
        planes["taa"] = taa_payload.permute(2, 0, 1).to(f32)
    if mesh is None:
        def take(name, by, bx, care=None, n=None):
            return _gather2x2(planes[name][:n], by, bx)
    else:
        # one exchange of every plane (the integers' bits as f32)
        r0 = mesh.rank * h
        kh = min(HALO_ROWS, h)
        slots, parts, c = {}, [], 0
        for name, x in planes.items():
            slots[name] = (c, c + x.shape[0])
            parts.append(x.view(f32) if x.dtype == torch.int32 else x)
            c += x.shape[0]
        stack = torch.cat(parts, dim=0).contiguous()
        above, below = mesh.exchange(stack, kh, kh)
        misses = torch.zeros((), dtype=torch.int64, device=valid.device)

        def take(name, by, bx, care=None, n=None):
            """The 2x2 taps of plane `name` (its first n channels), counting
            the caring pixels whose anchor left the halo."""
            nonlocal misses
            c0, c1 = slots[name]
            c = slice(c0, c1 if n is None else c0 + n)
            taps, miss = halo_take(stack[c], above[c], below[c], by, bx, r0, H)
            if care is not None:
                misses = misses + (miss & care).sum()
            return taps.view(torch.int32) if planes[name].dtype == torch.int32 else taps

    # ---- the SVGF map: strict same-object validation
    by, bx, w, inb = _footprint(g_fx - 0.5, g_fy - 0.5, H, W, dt)
    care = valid & inb.any(dim=-1)
    taps = take("val", by, bx, care)  # (4, 2, h, W)
    tap_mesh = taps[:, 0].permute(1, 2, 0) - 1
    tap_count = taps[:, 1].permute(1, 2, 0)
    tap_ok = inb & (tap_mesh == mesh_p[..., None]) & valid[..., None]
    w_s = torch.where(tap_ok, w, torch.zeros_like(w)).to(dt)
    total = torch.sum(w_s, dim=-1)
    any_ok = total > 0
    w_s = torch.where(any_ok[..., None],
                      w_s / torch.where(any_ok, total, torch.ones_like(total))[..., None],
                      torch.zeros_like(w_s))
    fc = torch.amax(torch.where(tap_ok, tap_count, 0), dim=-1)
    new_count = torch.where(any_ok & valid, torch.clamp(fc + 1, max=255), 0).to(torch.int32)
    svgf_map = dict(frame_count=new_count, weights=w_s, base_y=by, base_x=bx)
    ctr = fast = None
    if svgf_payload is not None:
        if mesh is None:
            res = _residuals(by, bx, care)
            ctr, fast = fetch_weighted_packed(planes["svgf"], by, bx, w_s, new_count, res)
        else:
            ctr, fast = _weighted_ctr(take("svgf", by, bx), w_s, new_count), False

    # ---- the TAA map: jittered footprint, loose validation
    taa_map = taa_pre = None
    if want_taa:
        jx, jy = taa_jitter(taa_bits, dt)
        by2, bx2, w2, inb2 = _footprint(g_fx - jx, g_fy - jy, H, W, dt)
        tap_mesh2 = take("val", by2, bx2, valid & inb2.any(dim=-1), n=1)[:, 0].permute(1, 2, 0) - 1
        w_t = torch.where(inb2, w2, torch.zeros_like(w2)).to(dt)
        total2 = torch.sum(w_t, dim=-1)
        any2 = total2 > 0
        w_t = torch.where(any2[..., None],
                          w_t / torch.where(any2, total2, torch.ones_like(total2))[..., None],
                          torch.zeros_like(w_t))
        same_obj = torch.any(inb2 & (tap_mesh2 == mesh_p[..., None]), dim=-1)
        taa_count = (same_obj & valid & any2).to(torch.int32)
        taa_map = dict(frame_count=taa_count, weights=w_t, base_y=by2, base_x=bx2)
        if taa_payload is not None:
            taa_pre = fetch_weighted(take("taa", by2, bx2), w_t, taa_count)
    if mesh is not None:
        svgf_map["halo_misses"] = misses
    return svgf_map, ctr, fast, taa_map, taa_pre
