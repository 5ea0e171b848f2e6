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
plain versions on CPU tensors).  The MXU body's K = 16 product runs on the
tensor cores (`mma.sync` m16n8k16, bf16 operands, f32 accumulate), whose
accumulation order is not the plain version's; its f32 product stays on
the CUDA cores in f32.
"""

from __future__ import annotations

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


def vpu_body(n_dt, n_f32, e, o, d, tc: int):
    """VPU body wrapper (see `vpu_body_plain`); CUDA `lprt_mxu_proto_vpu`."""
    TI, R = n_f32.shape[0], o.shape[1]
    f32 = torch.float32
    _check("vpu_body", [n_f32, n_dt, e, o, d],
           [(f32, (TI, 9)), (torch.bfloat16, (TI, 9)), (f32, (TI, 3)), (f32, (3, R)),
            (f32, (3, R))])
    if TI % tc:
        raise ValueError(f"vpu_body: {TI} rows are not whole chunks of {tc}")
    if o.device.type == "cpu":
        return vpu_body_plain(n_dt, n_f32, e, o, d, tc)
    # one table of 21 f32 columns per row, [n_dt | n_f32 | e]
    table = torch.cat([n_dt.float(), n_f32, e], dim=1).contiguous()
    t = torch.empty((R,), dtype=f32, device=o.device)
    u, v = torch.empty_like(t), torch.empty_like(t)
    code = cuda_lib.library("mxu_proto").lprt_mxu_proto_vpu(
        table.data_ptr(), o.data_ptr(), d.data_ptr(), R, TI, tc, t.data_ptr(), u.data_ptr(),
        v.data_ptr(), cuda_lib.stream_ptr(o.device))
    cuda_lib.check(code, "mxu_proto vpu_body")
    cuda_lib.LAUNCHES["mxu_proto_vpu"] += 1
    return t, u, v


def mxu_body(a32t, aabt, o, d, tc: int):
    """MXU body wrapper (see `mxu_body_plain`); CUDA `lprt_mxu_proto_mxu`,
    the Aab product on the tensor cores.  tc must be a multiple of 16."""
    nchunk, R = a32t.shape[0], o.shape[1]
    f32 = torch.float32
    P32, P16 = a32t.shape[2], aabt.shape[2]
    _check("mxu_body", [a32t, aabt, o, d],
           [(f32, (nchunk, 8, P32)), (torch.bfloat16, (nchunk, 16, P16)), (f32, (3, R)),
            (f32, (3, R))])
    if P32 < 6 * tc or P16 < 8 * tc:
        raise ValueError(f"mxu_body: tables too narrow for tc={tc}")
    if o.device.type == "cpu":
        return mxu_body_plain(a32t, aabt, o, d, tc)
    if tc % 16:
        raise ValueError(f"mxu_body: the tensor-core body takes tc a multiple of 16, not {tc}")
    # the kernel reads Aab as (rows, 16) bf16, row-major: a row's 16 K
    # values are one 32-byte line (the mma A fragment's layout)
    aab = aabt.transpose(1, 2).contiguous()
    t = torch.empty((R,), dtype=f32, device=o.device)
    u, v = torch.empty_like(t), torch.empty_like(t)
    code = cuda_lib.library("mxu_proto").lprt_mxu_proto_mxu(
        a32t.data_ptr(), aab.data_ptr(), o.data_ptr(), d.data_ptr(), R, nchunk, tc, P32, P16,
        t.data_ptr(), u.data_ptr(), v.data_ptr(), cuda_lib.stream_ptr(o.device))
    cuda_lib.check(code, "mxu_proto mxu_body")
    cuda_lib.LAUNCHES["mxu_proto_mxu"] += 1
    return t, u, v


# f32 operations per (ray, row), counted from the code of each body (the
# plain versions' expressions, which the kernels repeat):
# VPU: three row() calls (3 mul + 3 add, 3 mul + 2 add each) 33, t 2, u, v 4,
# two arow() calls (S_o, S_d: 6 + 5 mul/add, the |.| of the row and ray
# terms not counted) 22, two error bounds (12 each) 24, the f32 rows Ox32 ..
# Dy32 22, u32, v32 4, ok32 4, w 2, the three band tests and eu + ev 10, the
# widened test 7, the two selects 2, t > 0 and finite 2, the winner (min,
# ==, two max) 4
VPU_OPS = 142
# MXU: the f32 product on the CUDA cores, 6 blocks x (8 mul + 7 add) 90,
# then the same tail from t on (2 + 4 + 24 + 4 + 4 + 2 + 10 + 7 + 2 + 2 + 4)
# 65; and the bf16 product on the tensor cores, 8 blocks x 16 K
# multiply-adds = 256 operations
MXU_OPS_F32, MXU_OPS_BF16 = 155, 256


def make_case(nchunk: int, tc: int, R: int, device, seed: int = 0):
    """Random tables (n ~ N(0, 1), e ~ 0.1 N(0, 1)) and rays (o, d ~ N(0, 1),
    (3, R)) from `seed`, as the JAX tool draws them (its draws are its own).
    -> dict of the bodies' inputs on `device`."""
    rng = np.random.default_rng(seed)
    TI = nchunk * tc
    n_f32 = rng.standard_normal((TI, 9), dtype=np.float32)
    e = (rng.standard_normal((TI, 3), dtype=np.float32) * np.float32(0.1)).astype(np.float32)
    n_dt, a32t, aabt = build_tables(n_f32, e, tc)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    o = torch.randn((3, R), generator=gen, device=device)
    d = torch.randn((3, R), generator=gen, device=device)
    to = lambda x: x.to(device)
    return dict(n_dt=to(n_dt), n_f32=to(torch.from_numpy(n_f32)), e=to(torch.from_numpy(e)),
                a32t=to(a32t), aabt=to(aabt), o=o, d=d, tc=tc)


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
