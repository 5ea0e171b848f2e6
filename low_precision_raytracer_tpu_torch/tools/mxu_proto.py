"""Micro-prototype of the dense intersection chunk body: the per-lane
("VPU") row body against the tensor-core ("MXU") staged body (port of
`tools/bench_mxu_proto.py`, the round-3 kernel-redesign tool of the JAX
package).

    python3 -m low_precision_raytracer_tpu_torch.tools.mxu_proto [TC] [NCHUNK ...]

(defaults: TC = 48 rows per chunk, NCHUNK = 1 and 8) runs both bodies on
R = 2,073,600 random rays (1080p) against NCHUNK random chunks and prints,
for each NCHUNK, ms per body (CUDA events), Mray-chunks/s, hit agreement
and the largest |t| difference between the bodies, with the card's name
and power limit.  It needs a card.

Both bodies compute the bf16 error-band closest hit of each ray over the
chunks (the packet kernel's band constants in bf16, d12 = 2^-7 + 2^-5,
d1 = 2^-7): per chunk the least accepted t, with the largest u and the
largest v over the rows at that t (two separate maxima, as the reference
takes them); across chunks a strictly smaller t wins.  They differ in
their operands:

- `vpu_body` (`vpu_kernel` :31-100): the dtype rows n_dt (bf16 values)
  and the f32 rows n_f32 against the f32 ray, e in f32;
- `mxu_body` (`mxu_kernel` :103-162): two products per chunk, the f32
  A32 table (Oz, Dz and the f32 Ox, Oy, Dx, Dy rows, K = 8) against the
  f32 ray, and the bf16 Aab table (the dtype rows and their S rows, e
  rounded to bf16, K = 16) against the ray rounded to bf16.

`build_tables` lays the tables out as the JAX tool does (`build_tables`
:169-212).  `vpu_body_plain` / `mxu_body_plain` are the plain versions;
`vpu_body` / `mxu_body` launch `csrc/mxu_proto.cu` on CUDA tensors (the
plain versions on CPU tensors), on the kernels' own layouts of those
tables (`vpu_table`, `mxu_tables`, built in each call).
The MXU body's K = 16 product runs on the tensor cores (`wgmma` m64n64k16,
bf16 operands, f32 accumulate), whose accumulation order is not the plain
version's; its f32 product stays on the CUDA cores in f32, in the plain
version's order: no split of it onto the tensor cores meets the body's bar
(hit agreement >= 0.9999, |x - plain| <= 1e-5 |plain| + 1e-6), because
even the correctly rounded product misses it on a few rays (measured by
`tests/test_torch_mxu_proto.py` on the CPU).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from low_precision_raytracer_tpu_torch.ops import cuda_lib

R_1080P = 2_073_600
D12 = 2.0**-7 + 2.0**-5  # the packet band's d1 + d2 in bf16
D1F = 2.0**-7
NEG = -3e38


def pad128(x: int) -> int:
    return ((x + 127) // 128) * 128


def build_tables(n_f32, e, tc: int):
    """The tool's tables from numpy n_f32 (TI, 9) f32 and e (TI, 3) f32,
    TI a multiple of tc.  -> torch CPU tensors (n_dt (TI, 9) bf16, a32t
    (NC, 8, P32) f32, aabt (NC, 16, P16) bf16): a32t holds, per chunk, the
    blocks [Oz, Dz, Ox32, Oy32, Dx32, Dy32] of tc rows each as columns
    against the ray features [ox oy oz 1 dx dy dz 0]; aabt the blocks [Ox,
    Oy, Dx, Dy, Sox, Soy, Sdx, Sdy] against [o 1 d 0 | |o| 1 |d| 0], from
    the bf16 rows and |e|, e rounded to bf16; both padded to a multiple of
    128 columns."""
    nf32 = torch.from_numpy(np.array(n_f32, np.float32))
    e = torch.from_numpy(np.array(e, np.float32))
    TI = nf32.shape[0]
    if TI % tc:
        raise ValueError(f"build_tables: {TI} rows are not whole chunks of {tc}")
    nchunk = TI // tc
    n_dt = nf32.to(torch.bfloat16)
    z3, z1 = torch.zeros((TI, 3)), torch.zeros((TI, 1))
    cat = lambda *xs: torch.cat(xs, dim=1)
    rows = [
        cat(nf32[:, 6:9], e[:, 2:3], z3, z1),  # Oz
        cat(z3, z1, nf32[:, 6:9], z1),  # Dz
        cat(nf32[:, 0:3], e[:, 0:1], z3, z1),  # Ox32
        cat(nf32[:, 3:6], e[:, 1:2], z3, z1),  # Oy32
        cat(z3, z1, nf32[:, 0:3], z1),  # Dx32
        cat(z3, z1, nf32[:, 3:6], z1),  # Dy32
    ]
    a32 = torch.stack([r.reshape(nchunk, tc, 8) for r in rows], 1).reshape(nchunk, 6 * tc, 8)
    a32t = torch.nn.functional.pad(a32.transpose(1, 2), (0, pad128(6 * tc) - 6 * tc))
    nf = n_dt.float()
    ea, na = e.abs(), nf.abs()
    z8 = torch.zeros((TI, 8))
    rows_ab = [
        cat(nf[:, 0:3], e[:, 0:1], z3, z1, z8),  # Ox
        cat(nf[:, 3:6], e[:, 1:2], z3, z1, z8),  # Oy
        cat(z3, z1, nf[:, 0:3], z1, z8),  # Dx
        cat(z3, z1, nf[:, 3:6], z1, z8),  # Dy
        cat(z8, na[:, 0:3], ea[:, 0:1], z3, z1),  # Sox
        cat(z8, na[:, 3:6], ea[:, 1:2], z3, z1),  # Soy
        cat(z8, z3, z1, na[:, 0:3], z1),  # Sdx
        cat(z8, z3, z1, na[:, 3:6], z1),  # Sdy
    ]
    aab = torch.stack([r.reshape(nchunk, tc, 16) for r in rows_ab], 1).reshape(
        nchunk, 8 * tc, 16)
    aabt = torch.nn.functional.pad(aab.transpose(1, 2).to(torch.bfloat16),
                                   (0, pad128(8 * tc) - 8 * tc))
    return n_dt, a32t.contiguous(), aabt.contiguous()


def _tail(t_out, u_out, v_out, Oz, Dz, Ox, Oy, Dx, Dy, s_ox, s_oy,
          s_dx, s_dy, Ox32, Oy32, Dx32, Dy32):
    """The shared tail of both bodies on one chunk's (rows, rays) blocks:
    the band test, then the chunk's winner folded into (t, u, v)_out."""
    t = -Oz / Dz
    u = Ox + t * Dx
    v = Oy + t * Dy
    eu = (D12 * s_ox + t * D12 * s_dx + D1F * (Ox.abs() + 3 * (t * Dx).abs())) * 0.2
    ev = (D12 * s_oy + t * D12 * s_dy + D1F * (Oy.abs() + 3 * (t * Dy).abs())) * 0.2
    u32 = Ox32 + t * Dx32
    v32 = Oy32 + t * Dy32
    ok32 = (u32 > 0) & (v32 > 0) & (u32 + v32 < 1)
    w = 1.0 - u - v
    in_band = lambda x, err: (x >= -err) & (x <= 0)
    amb = in_band(u, eu) | in_band(v, ev) | in_band(w, eu + ev)
    dtype_accept = (u > -eu) & (v > -ev) & (u + v < 1 + eu + ev)
    u_sel = torch.where(amb, u32, u)
    v_sel = torch.where(amb, v32, v)
    accept = ((amb & ok32) | (~amb & dtype_accept)) & (t > 0) & torch.isfinite(t)
    t_masked = torch.where(accept, t, float("inf"))
    t_min = t_masked.min(dim=0).values
    at_min = t_masked == t_min[None, :]
    u_win = torch.where(at_min, u_sel, NEG).max(dim=0).values
    v_win = torch.where(at_min, v_sel, NEG).max(dim=0).values
    better = torch.isfinite(t_min) & (t_min < t_out)
    return (torch.where(better, t_min, t_out), torch.where(better, u_win, u_out),
            torch.where(better, v_win, v_out))


def _rays(o, d, sl):
    return [o[i, sl][None, :] for i in range(3)], [d[i, sl][None, :] for i in range(3)]


def vpu_body_plain(n_dt, n_f32, e, o, d, tc: int, slab: int = 8192):
    """Plain version of the VPU body.  n_dt (TI, 9) bf16 (or its f32
    values), n_f32 (TI, 9) f32, e (TI, 3) f32, o / d (3, R) f32.  -> t, u,
    v (R,) f32 (1e5, 0, 0 where nothing is accepted)."""
    nd, nf = n_dt.float(), n_f32
    nchunk = nf.shape[0] // tc
    R = o.shape[1]
    outs = []
    for r0 in range(0, R, slab):
        sl = slice(r0, r0 + slab)
        (ox, oy, oz), (dx, dy, dz) = _rays(o, d, sl)
        n = ox.shape[1]
        t_out = torch.full((n,), 1e5, dtype=torch.float32, device=o.device)
        u_out, v_out = torch.zeros_like(t_out), torch.zeros_like(t_out)
        for c in range(nchunk):
            rs = slice(c * tc, (c + 1) * tc)
            a, b, ee = nd[rs], nf[rs], e[rs]
            col = lambda m, j: m[:, j:j + 1]

            def row(m, k, e_col):
                o_val = col(m, 3 * k) * ox + col(m, 3 * k + 1) * oy + col(m, 3 * k + 2) * oz + e_col
                d_val = col(m, 3 * k) * dx + col(m, 3 * k + 1) * dy + col(m, 3 * k + 2) * dz
                return o_val, d_val

            def arow(m, k, e_col):
                s_o = (col(m, 3 * k).abs() * ox.abs() + col(m, 3 * k + 1).abs() * oy.abs()
                       + col(m, 3 * k + 2).abs() * oz.abs() + e_col.abs())
                s_d = (col(m, 3 * k).abs() * dx.abs() + col(m, 3 * k + 1).abs() * dy.abs()
                       + col(m, 3 * k + 2).abs() * dz.abs())
                return s_o, s_d

            Ox, Dx = row(a, 0, ee[:, 0:1])
            Oy, Dy = row(a, 1, ee[:, 1:2])
            Oz, Dz = row(b, 2, ee[:, 2:3])
            s_ox, s_dx = arow(a, 0, ee[:, 0:1])
            s_oy, s_dy = arow(a, 1, ee[:, 1:2])
            Ox32, Dx32 = row(b, 0, ee[:, 0:1])
            Oy32, Dy32 = row(b, 1, ee[:, 1:2])
            t_out, u_out, v_out = _tail(t_out, u_out, v_out, Oz, Dz, Ox, Oy,
                                        Dx, Dy, s_ox, s_oy, s_dx, s_dy, Ox32, Oy32, Dx32, Dy32)
        outs.append((t_out, u_out, v_out))
    return tuple(torch.cat(x) for x in zip(*outs))


def _features(o, d, sl):
    """B32 (8, n) f32 and Bab (16, n) f32 (bf16 values) of the rays."""
    ox, oy, oz = o[0, sl], o[1, sl], o[2, sl]
    dx, dy, dz = d[0, sl], d[1, sl], d[2, sl]
    one, zer = torch.ones_like(ox), torch.zeros_like(ox)
    b32 = torch.stack([ox, oy, oz, one, dx, dy, dz, zer])
    bab = torch.stack([ox, oy, oz, one, dx, dy, dz, zer, ox.abs(), oy.abs(), oz.abs(), one,
                       dx.abs(), dy.abs(), dz.abs(), zer])
    return b32, bab.to(torch.bfloat16).float()


def _product(at, b):
    """(K, M) table columns against (K, n) features: -> (M, n), the f32
    sums in order k = 0, 1, ... (the kernel's order on the CUDA cores)."""
    acc = at[0][:, None] * b[0][None, :]
    for k in range(1, at.shape[0]):
        acc = acc + at[k][:, None] * b[k][None, :]
    return acc


def mxu_body_plain(a32t, aabt, o, d, tc: int, slab: int = 8192, mab_fn=None):
    """Plain version of the MXU body: a32t (NC, 8, P32) f32, aabt (NC, 16,
    P16) bf16 (`build_tables`), o / d (3, R) f32.  Both products sum their
    K terms in order in f32 (bf16 products are exact in f32).  -> t, u, v
    (R,) f32."""
    nchunk = a32t.shape[0]
    R = o.shape[1]
    outs = []
    for r0 in range(0, R, slab):
        sl = slice(r0, r0 + slab)
        b32, bab = _features(o, d, sl)
        n = b32.shape[1]
        t_out = torch.full((n,), 1e5, dtype=torch.float32, device=o.device)
        u_out, v_out = torch.zeros_like(t_out), torch.zeros_like(t_out)
        for c in range(nchunk):
            m32 = _product(a32t[c, :, :6 * tc], b32)
            mab = _product(aabt[c, :, :8 * tc].float(), bab)
            blk32 = lambda k: m32[k * tc:(k + 1) * tc]
            blkab = lambda k: mab[k * tc:(k + 1) * tc]
            t_out, u_out, v_out = _tail(
                t_out, u_out, v_out, blk32(0), blk32(1), blkab(0), blkab(1),
                blkab(2), blkab(3), blkab(4), blkab(5), blkab(6), blkab(7), blk32(2), blk32(3),
                blk32(4), blk32(5))
        outs.append((t_out, u_out, v_out))
    return tuple(torch.cat(x) for x in zip(*outs))


def _check(name, tensors, shapes):
    for t, (dt, shape) in zip(tensors, shapes):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: all tensors must be on one device")


# the tables' layout as the kernels read it (csrc/mxu_proto.cu, which
# reports its own through lprt_mxu_proto_layout; `_library` holds the two equal)
VPU_ROW = 24  # floats a row of the VPU body's table
SLICE = 8  # table rows a tensor-core product (csrc/mxu_proto.cu:SLICE)
AB_ROW_BYTES = 8 * 16 * 2  # the 8 blocks' K = 16 bf16 values of a row
F_ROW = 24  # floats a row of the MXU body's f32 table
# the bf16 operand's core matrices: 8 rows x 16 bytes; LBO, SBO (bytes)
# step to the next 8 K values and to the next block (csrc/mxu_proto.cu:b_desc)
LBO, SBO = 128, 256
BODIES = ("vpu", "mxu")  # lprt_mxu_proto_chunks' body numbers


_CHECKED = []  # the libraries whose layout `_library` has checked


def _library():
    """The built `mxu_proto` library, its layout checked against this
    module's."""
    lib = cuda_lib.library("mxu_proto")
    if lib not in _CHECKED:
        got = (ctypes.c_int * 6)()
        lib.lprt_mxu_proto_layout(ctypes.addressof(got))
        want = (VPU_ROW, SLICE, AB_ROW_BYTES, F_ROW, LBO, SBO)
        if tuple(got) != want:
            raise RuntimeError(f"csrc/mxu_proto.cu lays its tables out as {tuple(got)}, "
                               f"tools/mxu_proto.py as {want}")
        _CHECKED.append(lib)
    return lib


def chunks_a_launch(body: str, tc: int) -> int:
    """Chunks of tc rows one launch of `body` ('vpu' or 'mxu') takes: as
    many as fit in a block's shared memory, as the kernels' library
    decides it (needs a card).  Raises ValueError where none fits."""
    n = _library().lprt_mxu_proto_chunks(BODIES.index(body), tc)
    if n < 1:
        raise ValueError(f"{body}_body: unsupported tc={tc} (no chunk fits in shared memory)")
    return n


def _check_mxu_tc(name, tc, a32t, aabt):
    if tc < SLICE or tc % SLICE:
        raise ValueError(f"{name}: the tensor-core body takes tc a multiple of {SLICE}, "
                         f"not {tc}")
    if a32t.shape[2] < 6 * tc or aabt.shape[2] < 8 * tc:
        raise ValueError(f"{name}: tables too narrow for tc={tc}")


def check_a32_layout(a32t, tc: int):
    """Raises ValueError if a32t has a nonzero term where `build_tables`
    puts a zero: the tensor-core body's kernel skips those terms."""
    blk = a32t[:, :, :6 * tc].reshape(a32t.shape[0], 8, 6, tc)  # [c, k, block, row]
    o_blk, d_blk = blk[:, :, [0, 2, 3]], blk[:, :, [1, 4, 5]]  # Oz Ox32 Oy32, Dz Dx32 Dy32
    if bool(o_blk[:, 4:].ne(0).any() | d_blk[:, :4].ne(0).any() | d_blk[:, 7].ne(0).any()):
        raise ValueError("check_a32_layout: a32t has nonzero terms outside build_tables' "
                         "layout")


def vpu_table(n_dt, n_f32, e):
    """The VPU body's table: (TI, 24) f32 rows [n_dt (bf16 values) 9 |
    n_f32 9 | e 3 | 0 0 0], read by 16-byte loads."""
    TI = n_f32.shape[0]
    pad = torch.zeros((TI, VPU_ROW - 21), dtype=torch.float32, device=n_f32.device)
    return torch.cat([n_dt.float(), n_f32, e, pad], dim=1).contiguous()


def mxu_tables(a32t, aabt, tc: int):
    """The MXU body's tables from `build_tables`' a32t / aabt.  -> (tab_ab
    bf16 (NC, TC / 8, 8, 2, 8, 8): per chunk and 8-row slice, the 8 blocks'
    operand in wgmma's K-major core-matrix order [block][K half][row][8 K],
    so that a slice is one product's B; tab_f f32 (NC, TC, 24): per row the
    terms of the f32 product that the layout does not zero, [Oz k0-3 | Dz
    k4-7 | Ox32 k0-3 | Dx32 k4-7 | Oy32 k0-3 | Dy32 k4-7]; k7 of a D block
    and the terms left out are zeros of `build_tables`' layout,
    `check_a32_layout`).  Slices only: an index list would copy it to the
    card and wait for the stream.  Raises ValueError if TC is not a
    multiple of 8 or if the tables are too narrow for TC."""
    nchunk = a32t.shape[0]
    _check_mxu_tc("mxu_tables", tc, a32t, aabt)
    # aabt[c, 8 kh + k8, tc b + 8 s + r] -> [c, s, b, kh, r, k8]
    ab = aabt[:, :, :8 * tc].reshape(nchunk, 2, 8, 8, tc // SLICE, SLICE)
    tab_ab = ab.permute(0, 4, 3, 1, 5, 2).contiguous()
    blk = a32t[:, :, :6 * tc].reshape(nchunk, 8, 6, tc)  # [c, k, block, row]
    # blocks Oz 0, Dz 1, Ox32 2, Oy32 3, Dx32 4, Dy32 5
    parts = [blk[:, 0:4, 0], blk[:, 4:8, 1], blk[:, 0:4, 2], blk[:, 4:8, 4], blk[:, 0:4, 3],
             blk[:, 4:8, 5]]
    tab_f = torch.cat(parts, dim=1).transpose(1, 2).contiguous()  # [c, row, 24]
    return tab_ab, tab_f


def vpu_body(n_dt, n_f32, e, o, d, tc: int):
    """VPU body wrapper (see `vpu_body_plain`); CUDA `lprt_mxu_proto_vpu` on
    `vpu_table`'s layout, one launch for as many chunks as fit in shared
    memory (`chunks_a_launch`)."""
    TI, R = n_f32.shape[0], o.shape[1]
    f32 = torch.float32
    _check("vpu_body", [n_f32, n_dt, e, o, d],
           [(f32, (TI, 9)), (torch.bfloat16, (TI, 9)), (f32, (TI, 3)), (f32, (3, R)),
            (f32, (3, R))])
    if tc < 1:
        raise ValueError(f"vpu_body: unsupported tc={tc}")
    if TI == 0 or TI % tc:
        raise ValueError(f"vpu_body: {TI} rows are not whole chunks of {tc}")
    if o.device.type == "cpu":
        return vpu_body_plain(n_dt, n_f32, e, o, d, tc)
    nchunk, step = TI // tc, chunks_a_launch("vpu", tc)
    table = vpu_table(n_dt, n_f32, e)
    t = torch.empty((R,), dtype=f32, device=o.device)
    u, v = torch.empty_like(t), torch.empty_like(t)
    lib = _library()
    for c0 in range(0, nchunk, step):
        code = lib.lprt_mxu_proto_vpu(
            table.data_ptr() + c0 * tc * VPU_ROW * 4, o.data_ptr(), d.data_ptr(), R,
            min(step, nchunk - c0), tc, int(c0 == 0), t.data_ptr(), u.data_ptr(),
            v.data_ptr(), cuda_lib.stream_ptr(o.device))
        cuda_lib.check(code, "mxu_proto vpu_body")
        cuda_lib.LAUNCHES["mxu_proto_vpu"] += 1
    return t, u, v


def _mxu_args(name, a32t, aabt, o, d, tc):
    nchunk, R = a32t.shape[0], o.shape[1]
    f32 = torch.float32
    P32, P16 = a32t.shape[2], aabt.shape[2]
    _check(name, [a32t, aabt, o, d],
           [(f32, (nchunk, 8, P32)), (torch.bfloat16, (nchunk, 16, P16)), (f32, (3, R)),
            (f32, (3, R))])
    if nchunk == 0:
        raise ValueError(f"{name}: no chunks")
    _check_mxu_tc(name, tc, a32t, aabt)


def mxu_body(a32t, aabt, o, d, tc: int):
    """MXU body wrapper (see `mxu_body_plain`); CUDA `lprt_mxu_proto_mxu`,
    the Aab product on the tensor cores, on `mxu_tables`' layout (a32t must
    hold `build_tables`' zeros, `check_a32_layout`), one launch for as many
    chunks as fit in shared memory (`chunks_a_launch`).  tc must be a
    multiple of 8."""
    _mxu_args("mxu_body", a32t, aabt, o, d, tc)
    if o.device.type == "cpu":
        return mxu_body_plain(a32t, aabt, o, d, tc)
    nchunk, R = a32t.shape[0], o.shape[1]
    step = chunks_a_launch("mxu", tc)
    tab_ab, tab_f = mxu_tables(a32t, aabt, tc)
    t = torch.empty((R,), dtype=torch.float32, device=o.device)
    u, v = torch.empty_like(t), torch.empty_like(t)
    lib = _library()
    for c0 in range(0, nchunk, step):
        code = lib.lprt_mxu_proto_mxu(
            tab_ab.data_ptr() + c0 * tc * AB_ROW_BYTES, tab_f.data_ptr() + c0 * tc * F_ROW * 4,
            o.data_ptr(), d.data_ptr(), R, min(step, nchunk - c0), tc, int(c0 == 0),
            t.data_ptr(), u.data_ptr(), v.data_ptr(), cuda_lib.stream_ptr(o.device))
        cuda_lib.check(code, "mxu_proto mxu_body")
        cuda_lib.LAUNCHES["mxu_proto_mxu"] += 1
    return t, u, v


def mxu_probe(a32t, aabt, o, d, tc: int):
    """The tensor-core product alone, as the MXU body's kernel computes it
    (its PROBE form: no tail, on the card only): -> (NC, R, 8, TC) f32,
    every block value of every (ray, row).  Its plain version is
    `probe_plain`."""
    _mxu_args("mxu_probe", a32t, aabt, o, d, tc)
    if o.device.type == "cpu":
        raise ValueError("mxu_probe: runs on the card only (its plain version: probe_plain)")
    nchunk, R = a32t.shape[0], o.shape[1]
    step = chunks_a_launch("mxu", tc)
    tab_ab, tab_f = mxu_tables(a32t, aabt, tc)
    out = torch.empty((nchunk, R, 8, tc), dtype=torch.float32, device=o.device)
    lib = _library()
    for c0 in range(0, nchunk, step):
        code = lib.lprt_mxu_proto_probe(
            tab_ab.data_ptr() + c0 * tc * AB_ROW_BYTES, tab_f.data_ptr() + c0 * tc * F_ROW * 4,
            o.data_ptr(), d.data_ptr(), R, min(step, nchunk - c0), tc,
            out.data_ptr() + c0 * R * 8 * tc * 4, cuda_lib.stream_ptr(o.device))
        cuda_lib.check(code, "mxu_proto probe")
    return out


def probe_plain(aabt, o, d, tc: int):
    """The bf16 product's block values, (NC, R, 8, TC) f32, summed in order
    (`mxu_body_plain`'s mab)."""
    _b32, bab = _features(o, d, slice(None))
    nchunk = aabt.shape[0]
    mab = torch.stack([_product(aabt[c, :, :8 * tc].float(), bab) for c in range(nchunk)])
    return mab.reshape(nchunk, 8, tc, -1).permute(0, 3, 1, 2).contiguous()


# f32 operations per (ray, row), counted from the code of each body (the
# plain versions' expressions, which the kernels repeat):
# VPU: three row() calls (3 mul + 3 add, 3 mul + 2 add each) 33, t 2, u, v 4,
# two arow() calls (S_o, S_d: 6 + 5 mul/add, the |.| of the row and ray
# terms not counted) 22, two error bounds (12 each) 24, the f32 rows Ox32 ..
# Dy32 22, u32, v32 4, ok32 4, w 2, the three band tests and eu + ev 10, the
# widened test 7, the two selects 2, t > 0 and finite 2, the winner (min,
# ==, two max) 4
VPU_OPS = 142
# MXU: the f32 product on the CUDA cores on the terms the A32 layout does
# not zero, three O rows (3 mul + 3 add) and three D rows (3 mul + 2 add)
# 33, then the same tail from t on (2 + 4 + 24 + 4 + 4 + 2 + 10 + 7 + 2 + 2
# + 4) 65; and the bf16 product on the tensor cores, 8 blocks x 16 K
# multiply-adds = 256 operations
MXU_OPS_F32, MXU_OPS_BF16 = 98, 256


def make_case(nchunk: int, tc: int, R: int, device, seed: int = 0):
    """Random tables (n ~ N(0, 1), e ~ 0.1 N(0, 1)) and rays (o, d ~ N(0, 1),
    (3, R)) from `seed`, as the JAX tool draws them (its draws are its own).
    -> dict of the bodies' inputs on `device` (a32t checked by
    `check_a32_layout`)."""
    rng = np.random.default_rng(seed)
    TI = nchunk * tc
    n_f32 = rng.standard_normal((TI, 9), dtype=np.float32)
    e = (rng.standard_normal((TI, 3), dtype=np.float32) * np.float32(0.1)).astype(np.float32)
    n_dt, a32t, aabt = build_tables(n_f32, e, tc)
    check_a32_layout(a32t, tc)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    o = torch.randn((3, R), generator=gen, device=device)
    d = torch.randn((3, R), generator=gen, device=device)
    to = lambda x: x.to(device)
    return dict(n_dt=to(n_dt), n_f32=to(torch.from_numpy(n_f32)), e=to(torch.from_numpy(e)),
                a32t=to(a32t), aabt=to(aabt), o=o, d=d, tc=tc)


def unit_case(nchunk: int, tc: int, R: int, device, seed: int = 0):
    """`make_case` with the bf16 table's rows unit vectors scaled by one of
    1, -1, 2, -0.5: each block value of the product is then one ray feature
    times that factor, exactly, in any order of summation (the layout probe:
    the tensor-core body must equal its plain version bit for bit)."""
    case = make_case(nchunk, tc, R, "cpu", seed)
    rng = np.random.default_rng(seed + 2)
    rows = nchunk * 8 * tc
    unit = np.zeros((rows, 16), np.float32)
    unit[np.arange(rows), rng.integers(0, 16, rows)] = rng.choice(
        np.array([1.0, -1.0, 2.0, -0.5], np.float32), rows)
    aab = torch.from_numpy(unit).reshape(nchunk, 8 * tc, 16).transpose(1, 2)
    aabt = torch.zeros_like(case["aabt"])
    aabt[:, :, :8 * tc] = aab.to(torch.bfloat16)
    case["aabt"] = aabt
    return {k: v.to(device) if torch.is_tensor(v) else v for k, v in case.items()}


def run_vpu(case):
    c = case
    return vpu_body(c["n_dt"], c["n_f32"], c["e"], c["o"], c["d"], c["tc"])


def run_mxu(case):
    c = case
    return mxu_body(c["a32t"], c["aabt"], c["o"], c["d"], c["tc"])


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean ms per call over `reps` calls (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(a, b):
    """Hit agreement and the largest |t| difference on lanes both hit."""
    hit_a, hit_b = a[0] < 1e5, b[0] < 1e5
    both = hit_a & hit_b
    terr = float((a[0] - b[0])[both].abs().max()) if bool(both.any()) else 0.0
    return dict(hit_agreement=float((hit_a == hit_b).float().mean()), max_abs_dt=terr,
                hits=(float(hit_a.float().mean()), float(hit_b.float().mean())))


def measure(nchunk: int, tc: int, R: int = R_1080P, case=None) -> dict:
    """Both bodies at (nchunk, tc) on R rays on the card (or on `case`,
    `make_case`'s): time, rate, the agreement between them."""
    case = make_case(nchunk, tc, R, "cuda") if case is None else case
    R = case["o"].shape[1]
    rv, rm = run_vpu(case), run_mxu(case)
    rep = dict(tc=tc, nchunk=nchunk, rays=R,
               vpu_ms=cuda_ms(lambda: run_vpu(case)), mxu_ms=cuda_ms(lambda: run_mxu(case)))
    rep["vpu_mray_chunks_per_s"] = R * nchunk / rep["vpu_ms"] / 1e3
    rep["mxu_mray_chunks_per_s"] = R * nchunk / rep["mxu_ms"] / 1e3
    rep.update(compare(rv, rm))
    return rep


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("mxu_proto: no CUDA device", file=sys.stderr)
        return 1
    tc = int(argv[0]) if argv else 48
    nchunks = [int(x) for x in argv[1:]] or [1, 8]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    for nchunk in nchunks:
        rep = measure(nchunk, tc)
        print(f"TC={tc} NCHUNK={nchunk} R={rep['rays']}")
        print(f"VPU body: {rep['vpu_ms']:8.3f} ms  {rep['vpu_mray_chunks_per_s']:.0f} "
              "Mray-chunks/s")
        print(f"MXU body: {rep['mxu_ms']:8.3f} ms  {rep['mxu_mray_chunks_per_s']:.0f} "
              "Mray-chunks/s")
        print(f"hit agreement {rep['hit_agreement']:.6f}  max|t| diff {rep['max_abs_dt']:.2e}  "
              f"hits {rep['hits'][0]:.3f}/{rep['hits'][1]:.3f}")
        print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
