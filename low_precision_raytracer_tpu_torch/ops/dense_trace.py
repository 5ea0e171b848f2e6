"""Dense traces (port of `low_precision_raytracer_tpu/ops/dense_pallas.py`,
every `fallback`: 'mxu3', and the error-band tests 'both' and 'dtype' in
fp32, bf16 and fp16): the M-shift test of every ray against world-space
per-instance-triangle coefficient rows.

Two kernels, each with a wrapper and its plain PyTorch version (the
wrapper launches the kernel on CUDA tensors, or raises; on CPU tensors it
runs the plain version):

- `dense_trace` (K1a, `csrc/dense_trace.cu`): single-chunk scenes
  (<= 128 instance triangles), closest hit with the fused shadow phase.
  Returns (t, u, v, tri, obj, vis), vis the per-ray bitmask of lights
  unoccluded from the winner's point (zeros when `lights` is None).  The
  kernel culls (ray, row) pairs by sign and range before the test;
  `dense_trace_cull_plain` emulates its loops (with `k1a_cull`, `mul_ru`,
  `next_up` and the lane order `k1a_lane_order`) and counts what they
  skip, and `k1a_edge_rays` makes the adversarial lanes its holds use.
- `dense_trace_multi` (K1b, `csrc/dense_multi.cu`): any table size, the
  rows grouped in chunks of 128 with one world AABB each, walked by a
  warp through a 4-ary tree over the chunk boxes (`build_tree`, the stack
  sized by `walk_stack`), each chunk's four 32-row slices culled by their
  own boxes and tested one row a lane (the table re-laid by `lane_table`;
  `k1b_launch`); closest hit or any hit.  Returns (t, u, v, tri, obj).
  Under a widened acceptance (`Band.widened`) each box is grown for the
  ray that tests it by the band's proven reach (`ops/band_pad.py`).  Its card
  reference there is `band_scan`, the all-row scan, on no render path.

Both take the rays recentred by the scene centre, the coefficient table
as (TI, 12) f32 rows [n (3x3 row-major) | e (3)] (a sub-f32 error-band
form adds its 16 band rows, (TI, 28): `coef_table`) and the acceptance
(`Band`).  Closest hit: t = 1e5, u = v = 0, ids -1 on a miss; ties in t go
to the smallest tri id, so the result does not depend on the order in
which triangles are tested.  Any hit: tri is a 0 (occluded) / -1 marker,
t = 1e5, u = v = 0, obj = -1.

`pack=True` (closest hit only; `dense_epilogue='pack'`) selects the
packed winner epilogue of `dense_pallas.py:_finish_chunk_packed`
(:130-180) instead, under any acceptance.  Per chunk (128 rows in K1b;
K1a's one chunk is its table rounded up to 16 rows, `k1a_chunk`, as the
JAX package sizes it) a row is accepted as above and also needs t > 0;
its key is (bits(t) & ~(2^lb - 1)) | local row, lb = ceil(log2 chunk)
(`pack_lb`), and the least key wins the chunk: rows whose t differ by
less than 2^-lb relative may resolve either way, as in the reference.
The winner's t is kept exactly.  Across chunks the strictly smaller t
wins, and on an exact tie the lower global row (the reference leaves
such ties to its walk order; one rule makes the kernel and its plain
version agree bit for bit whatever order the walk visits chunks in).
The launch returns (t, row, pk): the winner's global table row and its
u/v as 15-bit fixed point, pk = (qu << 15) | qv, q = trunc(clip((x +
0.5) * 16384, 0, 32767)); t = 1e5, row = pk = -1 on a miss.
`decode_packed` turns row / pk into tri, obj, u, v (the wavefront's
decode too).

Around K1b: `ray_aabb_entry` (the conservative slab-entry bound both the
kernels' walks and the sort key use), the sort keys `anchor_key` and
`morton_key`, and `dense_trace_multi_sorted`, the coherence-recovering
launch for incoherent rays (`trace_rays_dense_pallas_sorted`: key, stable
sort, trace, unsort; `sorted_launch` also serves the packet BVH's).
`m_shift_test` and `band_accept` (the test's arithmetic, shared by the
plain versions), the acceptances (`Band`, `dense_band`, `packet_band`),
`coef_table` and `band_rows` (the kernels' table layout), `build_tree`
(the box trees K1b, K6 and the wavefront's schedule walk), `lane_table`
and `walk_stack` (what the warp walk K1b and K6 share reads, in
`csrc/chunk_walk.cuh`), `per_table` (the per-frame-table cache) and
`scene_exit_cap` (the per-ray reach cap of the wavefront and of the
multi-chunk dense launches) sit here too.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from low_precision_raytracer_tpu_torch.ops import cuda_lib

T_MISS = 1e5
MAX_TRIS = 128  # the kernel's shared-memory table
MAX_LIGHTS = 32  # bits of the visibility mask
CHUNK = 128  # K1b: table rows per chunk AABB
BOX_SLOP = 0.02  # scene-level slab-test slop of the JAX package
FAN = 4  # children per box-tree node
MAX_LEVELS = 16  # the tree kernels' stack covers 3 (MAX_LEVELS - 1) + 1 entries


def _f32(x: float) -> float:
    return float(np.float32(x))


# Band.form: the kind of acceptance in its low two bits, flags above
KIND_STRICT = 0  # 'mxu3': u > 0, v > 0, u + v < 1
KIND_DENSE = 1  # the dense kernels' error band (K1a, K1b)
KIND_PACKET = 2  # the packet kernel's error band (K6)
FLAG_DTYPE = 4  # 'dtype': the band-widened test alone
OPERAND_BF16 = 8  # sub-f32: the dtype rows and the ray operand in bf16 ...
OPERAND_FP16 = 16  # ... or in fp16 (K6's fp16 rows)
BAND_COLS = 16  # the band rows a sub-f32 form reads after the 12 f32 columns


class Band(NamedTuple):
    """The acceptance of the triangle test, as the kernels take it.

    `form` = kind | flags.  Kind 0 (`STRICT`, 'mxu3'): u > 0, v > 0,
    u + v < 1 on the f32 rows.  Kinds 1 and 2: an error band around the
    dtype test, the dense kernels' (`dense_band`, `dense_pallas.py:_kernel`
    :369-421) or the packet kernel's (`packet_band`,
    `traversal_pallas.py:_kernel` :365-397), whose constants and rounding
    differ.  Without an operand flag u and v come from the f32 rows (fp32);
    with `OPERAND_BF16` / `OPERAND_FP16` (bf16, fp16) from the table's band
    rows (`band_rows`) and the ray rounded to that type.  'both' (no
    `FLAG_DTYPE`): strict inside the band, band-widened outside it; in
    sub-f32 forms a lane inside the band is re-tested on the f32 rows and
    takes its u, v from them.  'dtype' (`FLAG_DTYPE`): the band-widened
    test alone.  k0-k2 are f32 values: (sband, c1, c3) for kind 1, (d12,
    d1, -) for kind 2."""

    form: int = 0
    k0: float = 0.0
    k1: float = 0.0
    k2: float = 0.0

    @property
    def kind(self) -> int:
        return self.form & 3

    @property
    def dtype_only(self) -> bool:
        return bool(self.form & FLAG_DTYPE)

    @property
    def widened(self) -> bool:
        """Can the test accept a point outside the triangle (by more than
        the f32 rounding of u and v)?  The sub-f32 forms and 'dtype'."""
        return self.operand is not None or self.dtype_only

    @property
    def operand(self):
        """The type the sub-f32 forms round the ray to (None: f32 rows)."""
        if self.form & OPERAND_BF16:
            return torch.bfloat16
        if self.form & OPERAND_FP16:
            return torch.float16
        return None


STRICT = Band()


def _flags(fallback: str) -> int:
    if fallback not in ("both", "dtype"):
        raise ValueError(f"no error band for triangle_fallback={fallback!r}")
    return FLAG_DTYPE if fallback == "dtype" else 0


def dense_band(prec, fallback: str = "both") -> Band:
    """K1's band for `prec` and `fallback` ('both' | 'dtype'): (sband =
    0.2 (d1 + d2), folded into the S rows; c1 = 0.2 d1; c3 = 0.6 d1).  Its
    sub-f32 dtype rows are bf16 in bf16 and in fp16 (`_mxu_tables` :910
    rounds the fp16 rows to bf16 again), and so is the ray operand."""
    d1, d2 = prec.delta1, prec.delta2
    form = KIND_DENSE | _flags(fallback) | (0 if prec.is_f32 else OPERAND_BF16)
    return Band(form, _f32(0.2 * (d1 + d2)), _f32(0.2 * d1), _f32(0.6 * d1))


def packet_band(prec, fallback: str = "both") -> Band:
    """K6's band for `prec` and `fallback`: (d12 = d1 + d2, d1).  Its
    sub-f32 dtype rows and ray operand are in the render dtype itself
    (`traversal_pallas.py:_kernel` :266-276)."""
    operand = {"fp32": 0, "bf16": OPERAND_BF16, "fp16": OPERAND_FP16}[prec.name]
    form = KIND_PACKET | _flags(fallback) | operand
    return Band(form, _f32(prec.delta1 + prec.delta2), _f32(prec.delta1))


def band_rows(n_dt, e, band: Band) -> torch.Tensor:
    """(TI, 16) f32 band rows of a sub-f32 form, from the dtype-rounded
    coefficients n_dt (TI, 9) and the f32 offsets e (TI, 3):
    [Ox: n0 n1 n2 e0 | Oy: n3 n4 n5 e1 | S_x | S_y], each value rounded to
    the form's operand type.  The dense form's S rows are |n|, |e| scaled
    by sband before the rounding (`_mxu_tables` :895-910), the packet
    form's |n|, |e| of the rounded rows (:266-276)."""
    dt = band.operand
    f32 = torch.float32
    nd = n_dt.to(f32)
    o_rows = torch.cat([nd[:, 0:3], e[:, 0:1], nd[:, 3:6], e[:, 1:2]], dim=1)
    if band.kind == KIND_DENSE:
        sband = torch.tensor(band.k0, dtype=f32, device=nd.device)
        s_rows = o_rows.abs() * sband
    else:
        s_rows = o_rows.to(dt).to(f32).abs()
    return torch.cat([o_rows, s_rows], dim=1).to(dt).to(f32).contiguous()


def table_cols(band: Band) -> int:
    """Columns of the coefficient table a kernel reads under `band`."""
    return 12 + (BAND_COLS if band.operand is not None else 0)


def tri_quantities(coef, o, d, band: Band = STRICT):
    """(R, TI) t, u, v, accept_geom for rays o, d (R, 3) against the
    table rows (12 f32 columns, then the band rows of a sub-f32 form); the
    sums run in the kernel's order."""
    return m_shift_test([coef[:, i][None, :] for i in range(coef.shape[1])],
                        o[:, :, None], d[:, :, None], band)


def m_shift_test(n, o, d, band: Band = STRICT):
    """The M-shift test of rays o, d (R, 3, 1) against coefficient rows n
    (12 tensors broadcasting against (R, 1): the table's columns, or each
    ray's own rows; 28 with the band rows of a sub-f32 form); -> t, u, v,
    accept_geom, the sums in the kernels' order, accepted by `band`."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    Oz = n[6] * ox + n[7] * oy + n[8] * oz + n[11]
    Dz = n[6] * dx + n[7] * dy + n[8] * dz
    Ox = n[0] * ox + n[1] * oy + n[2] * oz + n[9]
    Oy = n[3] * ox + n[4] * oy + n[5] * oz + n[10]
    Dx = n[0] * dx + n[1] * dy + n[2] * dz
    Dy = n[3] * dx + n[4] * dy + n[5] * dz
    t = -Oz / Dz
    if band.kind == KIND_STRICT:
        u, v = Ox + t * Dx, Oy + t * Dy
        return t, u, v, (u > 0) & (v > 0) & (u + v < 1)
    if band.operand is None:  # f32 rows; K1 folds sband into |n| and |e|
        a = [n[i].abs() for i in (0, 1, 2, 9, 3, 4, 5, 10)]
        if band.kind == KIND_DENSE:
            a = [x * band.k0 for x in a]
        bo, bd, uv32 = (ox, oy, oz), (dx, dy, dz), None
    else:  # the band rows, the ray rounded to the operand type
        b, a = n[12:20], n[20:28]
        q = lambda x: x.to(band.operand).to(torch.float32)
        bo, bd = (q(ox), q(oy), q(oz)), (q(dx), q(dy), q(dz))
        uv32 = (Ox + t * Dx, Oy + t * Dy)
        Ox = b[0] * bo[0] + b[1] * bo[1] + b[2] * bo[2] + b[3]
        Oy = b[4] * bo[0] + b[5] * bo[1] + b[6] * bo[2] + b[7]
        Dx = b[0] * bd[0] + b[1] * bd[1] + b[2] * bd[2]
        Dy = b[4] * bd[0] + b[5] * bd[1] + b[6] * bd[2]
    ao, ad = [x.abs() for x in bo], [x.abs() for x in bd]
    s_ox = a[0] * ao[0] + a[1] * ao[1] + a[2] * ao[2] + a[3]
    s_oy = a[4] * ao[0] + a[5] * ao[1] + a[6] * ao[2] + a[7]
    s_dx = a[0] * ad[0] + a[1] * ad[1] + a[2] * ad[2]
    s_dy = a[4] * ad[0] + a[5] * ad[1] + a[6] * ad[2]
    t_dx = t * Dx
    t_dy = t * Dy
    u = Ox + t_dx
    v = Oy + t_dy
    accept, ambiguous = _band(band, t, u, v, Ox, Oy, t_dx, t_dy, s_ox, s_oy, s_dx, s_dy,
                              uv32)
    if uv32 is not None and not band.dtype_only:
        u = torch.where(ambiguous, uv32[0], u)
        v = torch.where(ambiguous, uv32[1], v)
    return t, u, v, accept


def band_accept(band: Band, t, u, v, Ox, Oy, t_dx, t_dy, s_ox, s_oy, s_dx, s_dy, uv32=None):
    """The acceptance of an error-band form (a lane is ambiguous where u, v
    or w = 1 - u - v lies in [-err, 0]), the JAX expressions term for term:
    under 'dtype' the band-widened test; under 'both' the strict test on
    ambiguous lanes, on the f32 rows' u32, v32 (`uv32`) in a sub-f32 form,
    and the band-widened test elsewhere."""
    return _band(band, t, u, v, Ox, Oy, t_dx, t_dy, s_ox, s_oy, s_dx, s_dy, uv32)[0]


def _band(band, t, u, v, Ox, Oy, t_dx, t_dy, s_ox, s_oy, s_dx, s_dy, uv32):
    """-> (accept, ambiguous); see `band_accept`."""
    if band.kind == KIND_DENSE:
        c1, c3 = band.k1, band.k2
        eu = s_ox + t * s_dx + c1 * Ox.abs() + c3 * t_dx.abs()
        ev = s_oy + t * s_dy + c1 * Oy.abs() + c3 * t_dy.abs()
    elif band.kind == KIND_PACKET:
        d12, d1f = band.k0, band.k1
        eu = (d12 * s_ox + t * d12 * s_dx + d1f * (Ox.abs() + 3 * t_dx.abs())) * 0.2
        ev = (d12 * s_oy + t * d12 * s_dy + d1f * (Oy.abs() + 3 * t_dy.abs())) * 0.2
    else:
        raise ValueError(f"band_accept: no error band in form {band.form}")
    w = 1.0 - u - v
    in_band = lambda x, err: (x >= -err) & (x <= 0)
    ambiguous = in_band(u, eu) | in_band(v, ev) | in_band(w, eu + ev)
    dtype_accept = (u > -eu) & (v > -ev) & (u + v < 1 + eu + ev)
    if band.dtype_only:
        return dtype_accept, ambiguous
    if band.operand is not None:
        if uv32 is None:
            raise ValueError("band_accept: a sub-f32 'both' form re-tests on the f32 rows (uv32)")
        u, v = uv32
    strict = (u > 0) & (v > 0) & (u + v < 1)
    return (ambiguous & strict) | (~ambiguous & dtype_accept), ambiguous


def _closest(t, u, v, accept, tri_ids, obj_ids):
    """(R, TI) test results -> the (t, tri)-lexicographic closest accepted
    hit per ray: (t, u, v, tri, obj), the miss record where none."""
    R = t.shape[0]
    tri = tri_ids[None, :]
    inf = torch.tensor(float("inf"), dtype=t.dtype, device=t.device)
    t_masked = torch.where(accept, t, inf)
    t_min = t_masked.min(dim=1).values
    at_min = t_masked == t_min[:, None]
    big = torch.iinfo(torch.int32).max
    tri_win = torch.where(at_min, tri, big).min(dim=1).values
    win = at_min & (tri == tri_win[:, None])
    k = torch.argmax(win.to(torch.int8), dim=1)  # first winning row
    got = torch.isfinite(t_min) & (t_min < T_MISS)
    take = lambda x: x.gather(1, k[:, None])[:, 0]
    t_out = torch.where(got, t_min, torch.full_like(t_min, T_MISS))
    u_out = torch.where(got, take(u), torch.zeros_like(t_min))
    v_out = torch.where(got, take(v), torch.zeros_like(t_min))
    neg = torch.full((R,), -1, dtype=torch.int32, device=t.device)
    tri_out = torch.where(got, tri_win.to(torch.int32), neg)
    obj_out = torch.where(got, obj_ids[k].to(torch.int32), neg)
    return t_out, u_out, v_out, tri_out, obj_out


def _accept(t, geom, skip, mind, maxd, tri_ids):
    return (geom & (t > mind[:, None]) & (t < maxd[:, None])
            & (tri_ids[None, :] != skip[:, None]) & torch.isfinite(t))


PACK_SCALE = 16384.0  # the packed u/v's fixed point: 2^-14 steps, offset 0.5
INT32_MAX = 2**31 - 1


def pack_lb(chunk: int) -> int:
    """Bits of the chunk-local row in the packed key: ceil(log2 chunk)
    (7 for K1b's 128-row chunks), at least 1."""
    return max(1, (chunk - 1).bit_length())


def k1a_chunk(TI: int) -> int:
    """K1a's chunk height under the packed epilogue: the table rounded up
    to 16 rows (`trace_rays_dense_pallas` :1004), so lb is 6 on Cornell's
    34 rows."""
    return max(16, -(-TI // 16) * 16)


def pack_uv(u, v):
    """-> pk = (qu << 15) | qv, q = trunc(clip((x + 0.5) * 16384, 0, 32767))."""
    q = lambda x: torch.clamp((x + 0.5) * PACK_SCALE, 0.0, 32767.0).to(torch.int32)
    return (q(u) << 15) | q(v)


def _packed(t, u, v, accept, chunk: int):
    """(R, TI) test results -> the packed epilogue's (t, row, pk) per ray:
    per chunk of `chunk` rows the least key (bits(t) & ~(2^lb - 1)) | local
    row over the accepted rows with t > 0; across chunks the least (t,
    row); a miss where no winner lies below 1e5."""
    R, TI = t.shape
    dev = t.device
    nc = -(-TI // chunk)
    lmask = (1 << pack_lb(chunk)) - 1
    pad = nc * chunk - TI
    local = (torch.arange(nc * chunk, device=dev, dtype=torch.int32) % chunk)[None, :]
    acc = torch.nn.functional.pad(accept & (t > 0), (0, pad), value=False)
    tb = torch.nn.functional.pad(t, (0, pad)).view(torch.int32)
    key = torch.where(acc, (tb & ~lmask) | local, INT32_MAX).reshape(R, nc, chunk)
    kmin, j = key.min(dim=2)  # keys are unique within a chunk
    got = kmin != INT32_MAX
    row = (torch.arange(nc, device=dev)[None, :] * chunk + j).clamp(max=TI - 1)
    t_c = torch.where(got, t.gather(1, row), float("inf"))
    t_best = t_c.min(dim=1).values
    at = got & (t_c == t_best[:, None])
    row_best = torch.where(at, row, TI).min(dim=1).values
    hit = t_best < T_MISS
    rb = row_best.clamp(max=TI - 1)[:, None]
    pk = pack_uv(u.gather(1, rb)[:, 0], v.gather(1, rb)[:, 0])
    neg = torch.full((R,), -1, dtype=torch.int32, device=dev)
    return (torch.where(hit, t_best, torch.full_like(t_best, T_MISS)),
            torch.where(hit, row_best.to(torch.int32), neg), torch.where(hit, pk, neg))


def decode_packed(row, pk, tri_ids, obj_ids):
    """Packed winners (row, pk; row -1 on a miss) -> (u, v, tri, obj): tri
    and obj by one take from the table's id columns, u and v from the
    15-bit fixed point (`trace_rays_dense_pallas` :1241-1254); u = v = 0,
    ids -1 on a miss."""
    valid = row >= 0
    rc = row.clamp(min=0).long()
    neg = torch.full_like(row, -1)
    inv_q = 1.0 / PACK_SCALE
    u = torch.where(valid, (pk >> 15).to(torch.float32) * inv_q - 0.5, 0.0)
    v = torch.where(valid, (pk & 0x7FFF).to(torch.float32) * inv_q - 0.5, 0.0)
    return u, v, torch.where(valid, tri_ids[rc], neg), torch.where(valid, obj_ids[rc], neg)


def dense_trace_plain(origins, directions, skip, mind, maxd, coef, tri_ids,
                      obj_ids, lights=None, d_mov: float = 0.0, band: Band = STRICT,
                      pack: bool = False):
    """Plain PyTorch version of the kernel: a dense (R, TI) broadcast test,
    then the shadow phase as a loop over the lights; under `pack` the
    packed epilogue over one `k1a_chunk` chunk, -> (t, row, pk)."""
    R = origins.shape[0]
    t, u, v, geom = tri_quantities(coef, origins, directions, band)
    accept = _accept(t, geom, skip, mind, maxd, tri_ids)
    if pack:
        _check_pack(lights)
        return _packed(t, u, v, accept, k1a_chunk(coef.shape[0]))
    t_out, u_out, v_out, tri_out, obj_out = _closest(t, u, v, accept, tri_ids, obj_ids)
    tri = tri_ids[None, :]

    vis = torch.zeros((R,), dtype=torch.int32, device=t.device)
    if lights is None:
        return t_out, u_out, v_out, tri_out, obj_out, vis
    p = origins + t_out[:, None] * directions
    for l in range(lights.shape[0]):
        isdir = lights[l, 0] > 0
        a = lights[l, 1:4]
        dvec = a[None, :] - p
        dist = torch.sqrt(dvec[:, 0] * dvec[:, 0] + dvec[:, 1] * dvec[:, 1]
                          + dvec[:, 2] * dvec[:, 2])
        inv = 1.0 / torch.clamp(dist, min=1e-20)
        sdir = torch.where(isdir, a[None, :].expand(R, 3), dvec * inv[:, None])
        maxd_l = torch.where(isdir, torch.full_like(dist, 1000.0), dist)
        t2, _u2, _v2, geom2 = tri_quantities(coef, p, sdir, band)
        blocked = (geom2 & (t2 > d_mov) & (t2 < maxd_l[:, None])
                   & (tri != tri_out[:, None]) & torch.isfinite(t2)).any(dim=1)
        vis = vis | torch.where((tri_out >= 0) & ~blocked, 1 << l, 0).to(torch.int32)
    return t_out, u_out, v_out, tri_out, obj_out, vis


def next_up(x):
    """The next f32 above each value, as the kernel's `next_up` steps it;
    +Inf stays +Inf here and turns NaN there, which turns the range cull off
    either way."""
    return torch.nextafter(x, torch.full_like(x, float("inf")))


def mul_ru(a, b):
    """a * b in f32 rounded toward +Inf (`__fmul_ru`): the exact product in
    f64 (two f32 significands need 48 bits, and the exponents fit), rounded
    to nearest in f32, then stepped up where that fell below it."""
    p = a.double() * b.double()
    r = p.float()
    return torch.where(r.double() < p, next_up(r), r)


def k1a_cull(Oz, Dz, up, need_pos):
    """K1a's culls (`csrc/dense_trace.cu:cull`, the proofs there), with
    w = -Oz sign(Dz) (Dz's sign bit) and P = __fmul_ru(up, |Dz|), up =
    next_up(U): the range cull w > P (t > U), and where `need_pos` (an
    accepted t must be > 0) the sign cull, not w > 0.  -> (culled, by the
    range cull)."""
    w = torch.where(torch.signbit(Dz), Oz, -Oz)
    by_range = w > mul_ru(up, Dz.abs())
    return by_range | (need_pos & ~(w > 0)), by_range


K1A_BLOCK = 256  # K1a's rays per block (csrc/dense_trace.cu: LPRT_K1A_BLOCK)


def k1a_lane_order(directions, mind, maxd, block: int = K1A_BLOCK):
    """K1a's lanes: in each block of `block` rays, the live rays grouped by
    their direction's octant (the x, y, z sign bits), then the dead ones
    and the slots past R.  -> the ray of each lane slot (-1 past R), in
    block order and, within an octant, in ray order (the kernel's atomics
    order a bin's rays in some order; the bins, and so each warp's octants,
    are the same)."""
    R = directions.shape[0]
    dev = directions.device
    sb = torch.signbit(directions).long()
    key = torch.where(maxd > mind, sb[:, 0] * 4 + sb[:, 1] * 2 + sb[:, 2], 8)
    n = -(-R // block) * block
    key = torch.cat([key, torch.full((n - R,), 9, dtype=key.dtype, device=dev)])
    blk = torch.arange(n, device=dev) // block
    order = torch.sort(blk * 16 + key, stable=True).indices
    return torch.where(order < R, order, -1)


class _CullCounts:
    """(lane, row) pairs of one culled loop: visited, culled by sign, by
    range, fully tested; and per 32-lane warp (the lanes `k1a_lane_order`
    gives) the rows it visits with some lane (`warp_steps`) and the rows it
    tests in full, some lane surviving (`warp_full`)."""

    def __init__(self, slots):
        self.slots = slots
        dev = slots.device
        z = lambda: torch.zeros((), dtype=torch.int64, device=dev)
        self.n = {k: z() for k in ("tests", "sign_culled", "range_culled", "full",
                                   "warp_steps", "warp_full")}

    def _warps(self, m):
        return torch.where(self.slots >= 0, m[self.slots.clamp(min=0)], False).view(-1, 32)

    def add(self, visit, culled, by_range):
        full = visit & ~culled
        self.n["tests"] += visit.sum()
        self.n["sign_culled"] += (visit & culled & ~by_range).sum()
        self.n["range_culled"] += (visit & by_range).sum()
        self.n["full"] += full.sum()
        self.n["warp_steps"] += self._warps(visit).any(1).sum()
        self.n["warp_full"] += self._warps(full).any(1).sum()

    def result(self):
        return {k: int(v) for k, v in self.n.items()}


def dense_trace_cull_plain(origins, directions, skip, mind, maxd, coef, tri_ids,
                           obj_ids, lights=None, d_mov: float = 0.0, band: Band = STRICT,
                           pack: bool = False):
    """K1a's culled loops (`csrc/dense_trace.cu:dense_trace_kernel`) in plain
    PyTorch, for every ray at once: the rows in table order, each (ray, row)
    first through `k1a_cull` against the ray's running bound (the least of
    maxd and the best t; under `pack` the top of the least key's bucket),
    the survivors through the test, the best and its bound updated row by
    row; then per light the shadow ray's any hit, its rows culled against
    the light's range, the winner's triangle skipped.  -> (the outputs of
    `dense_trace_plain`, which they equal bit for bit; counts {"primary":
    ..., "shadow": ...} of `_CullCounts`)."""
    R, TI = origins.shape[0], coef.shape[0]
    dev = origins.device
    f32, i32 = torch.float32, torch.int32
    ox, oy, oz = origins.unbind(1)
    dx, dy, dz = directions.unbind(1)
    live = maxd > mind
    need_pos = torch.ones_like(live) if pack else mind >= 0
    bt = torch.full((R,), T_MISS, dtype=f32, device=dev)
    bu, bv = torch.zeros_like(bt), torch.zeros_like(bt)
    btri = torch.full((R,), -1, dtype=i32, device=dev)
    bobj = btri.clone()
    lmask = (1 << pack_lb(k1a_chunk(TI))) - 1
    kmin = torch.full((R,), INT32_MAX, dtype=i32, device=dev)
    up = next_up(maxd if pack else torch.minimum(maxd, bt))
    slots = k1a_lane_order(directions, mind, maxd)
    counts = _CullCounts(slots)
    for k in range(TI):
        c = coef[k]
        Oz = c[6] * ox + c[7] * oy + c[8] * oz + c[11]
        Dz = c[6] * dx + c[7] * dy + c[8] * dz
        culled, by_range = k1a_cull(Oz, Dz, up, need_pos)
        counts.add(live, culled, by_range)
        t, u, v, geom = (x[:, 0] for x in tri_quantities(coef[k : k + 1], origins, directions,
                                                          band))
        tri = tri_ids[k]
        acc = (live & ~culled & geom & (t > mind) & (t < maxd) & (tri != skip)
               & torch.isfinite(t))
        if pack:
            acc = acc & (t > 0)
            key = (t.view(i32) & ~lmask) | k
            upd = acc & (key < kmin)
            kmin = torch.where(upd, key, kmin)
            bt, bu, bv = (torch.where(upd, a, b) for a, b in ((t, bt), (u, bu), (v, bv)))
            up = torch.where(acc, next_up(torch.minimum(maxd, (kmin | lmask).view(f32))), up)
        else:
            upd = acc & ((t < bt) | ((t == bt) & (tri < btri)))
            bt, bu, bv = (torch.where(upd, a, b) for a, b in ((t, bt), (u, bu), (v, bv)))
            btri = torch.where(upd, tri, btri)
            bobj = torch.where(upd, obj_ids[k], bobj)
            up = torch.where(upd, next_up(torch.minimum(maxd, bt)), up)
    out_counts = {"primary": counts.result()}
    if pack:
        _check_pack(lights)
        hit = (kmin != INT32_MAX) & (bt < T_MISS)
        neg = torch.full((R,), -1, dtype=i32, device=dev)
        row = torch.where(hit, kmin & lmask, neg)
        return (torch.where(hit, bt, torch.full_like(bt, T_MISS)), row,
                torch.where(hit, pack_uv(bu, bv), neg)), out_counts

    vis = torch.zeros((R,), dtype=i32, device=dev)
    if lights is None:
        return (bt, bu, bv, btri, bobj, vis), out_counts
    got = btri >= 0
    p = origins + bt[:, None] * directions
    px, py, pz = p.unbind(1)
    shadow = _CullCounts(slots)
    for l in range(lights.shape[0]):
        isdir = lights[l, 0] > 0
        a = lights[l, 1:4]
        dvec = a[None, :] - p
        dist = torch.sqrt(dvec[:, 0] * dvec[:, 0] + dvec[:, 1] * dvec[:, 1]
                          + dvec[:, 2] * dvec[:, 2])
        inv = 1.0 / torch.clamp(dist, min=1e-20)
        sdir = torch.where(isdir, a[None, :].expand(R, 3), dvec * inv[:, None])
        maxd_l = torch.where(isdir, torch.full_like(dist, 1000.0), dist)
        up_l = next_up(maxd_l)
        sx, sy, sz = sdir.unbind(1)
        blocked = torch.zeros_like(got)
        for k in range(TI):
            c = coef[k]
            visit = got & ~blocked & (tri_ids[k] != btri)
            Oz = c[6] * px + c[7] * py + c[8] * pz + c[11]
            Dz = c[6] * sx + c[7] * sy + c[8] * sz
            culled, by_range = k1a_cull(Oz, Dz, up_l, torch.tensor(d_mov >= 0.0, device=dev))
            shadow.add(visit, culled, by_range)
            t2, _u, _v, geom2 = (x[:, 0] for x in tri_quantities(coef[k : k + 1], p, sdir, band))
            blocked = blocked | (visit & ~culled & geom2 & (t2 > d_mov) & (t2 < maxd_l)
                                 & torch.isfinite(t2))
        vis = vis | torch.where(got & ~blocked, 1 << l, 0).to(i32)
    out_counts["shadow"] = shadow.result()
    return (bt, bu, bv, btri, bobj, vis), out_counts


def k1a_edge_rays(coef, lo, hi, floor_spot, n: int, seed: int = 0):
    """Adversarial K1a lanes for the holds of its culls (numpy from `seed`,
    on coef's device), five families of n // 5 lanes each, recentred like
    the table: (o, d, skip, mind, maxd).
    - direction components exactly +-0 (one or two axes), against the
      axis-aligned walls; origins uniform in the box [lo, hi];
    - origins on a row's plane, Oz == 0 exactly in the kernel's f32 order
      (searched ulp by ulp along the plane's steepest axis);
    - mind < 0 (down to -0.5), so rows behind the origin may be accepted;
    - dead lanes: maxd == mind and maxd < mind;
    - rays from below `floor_spot` (a point of the floor under a box
      standing on it) straight up and nearly so, meeting the floor and the
      box's bottom face in one plane: coplanar ties in t.
    Every family has mind 0 or 1e-4 and maxd 1e5 unless noted, skip -1 or a
    random row's id."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    tab = coef.detach().cpu().numpy().astype(f32)
    lo, hi = np.asarray(lo, f32), np.asarray(hi, f32)
    m = max(1, n // 5)

    def unit(k):
        d = rng.normal(size=(k, 3))
        return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(f32)

    def inside(k):
        return (lo + (hi - lo) * rng.random((k, 3))).astype(f32)

    o0, d0 = inside(m), unit(m)
    for i in range(m):  # one zero axis, or two (an axis-aligned ray)
        axes = [i % 3] if i % 4 else [i % 3, (i + 1) % 3]
        for a in axes:
            d0[i, a] = -0.0 if rng.random() < 0.5 else 0.0
    d0 /= np.maximum(np.linalg.norm(d0, axis=1, keepdims=True), 1e-30).astype(f32)
    d0[d0 == 0] = 0.0
    for i in range(0, m, 2):  # keep signed zeros on half of them
        d0[i][d0[i] == 0] = -0.0

    o1, d1 = inside(4 * m), unit(4 * m)
    keep = np.zeros(4 * m, bool)
    steps = np.arange(-64, 65, dtype=np.int32)
    for i in range(4 * m):
        row = tab[rng.integers(len(tab))]
        pl = np.array([row[6], row[7], row[8]], f32)
        a = int(np.argmax(np.abs(pl)))
        if pl[a] == 0:
            continue
        rest = sum(float(pl[j]) * float(o1[i, j]) for j in range(3) if j != a)
        x0 = f32(-(rest + float(row[11])) / float(pl[a]))
        cand = np.repeat(o1[i][None], len(steps), 0)
        cand[:, a] = (np.asarray(x0, f32).view(np.int32) + steps).view(f32)
        Oz = pl[0] * cand[:, 0] + pl[1] * cand[:, 1] + pl[2] * cand[:, 2] + row[11]
        hit = np.flatnonzero(Oz == 0)
        if len(hit):
            o1[i] = cand[hit[0]]
            keep[i] = True
    o1, d1 = o1[keep][:m], d1[keep][:m]

    o2, d2 = inside(m), unit(m)
    o3, d3 = inside(m), unit(m)
    spot = np.asarray(floor_spot, f32)
    o4 = (spot + np.array([0.2, 0.0, 0.2], f32) * (rng.random((m, 3)) - 0.5).astype(f32)
          - np.array([0.0, 0.5, 0.0], f32)).astype(f32)
    d4 = np.tile(np.array([0.0, 1.0, 0.0], f32), (m, 1))
    d4[m // 2:] = unit(m - m // 2) * f32(0.02) + np.array([0.0, 1.0, 0.0], f32)
    d4 /= np.linalg.norm(d4, axis=1, keepdims=True).astype(f32)

    o = np.concatenate([o0, o1, o2, o3, o4]).astype(f32)
    d = np.concatenate([d0, d1, d2, d3, d4]).astype(f32)
    R = len(o)
    mind = np.where(rng.random(R) < 0.5, 0.0, 1e-4).astype(f32)
    maxd = np.full(R, 1e5, f32)
    a2 = len(o0) + len(o1)
    mind[a2 : a2 + m] = -0.5 * rng.random(m).astype(f32)
    mind[a2 : a2 + m : 7] = -0.0
    a3 = a2 + m
    maxd[a3 : a3 + m] = mind[a3 : a3 + m]
    maxd[a3 + 1 : a3 + m : 2] = mind[a3 + 1 : a3 + m : 2] - rng.random(len(range(a3 + 1, a3 + m, 2))).astype(f32)
    skip = np.where(rng.random(R) < 0.7, -1, rng.integers(0, len(tab), R)).astype(np.int32)
    dev = coef.device
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return t(o), t(d), t(skip), t(mind), t(maxd)


def _check_pack(lights=None, find_any=False):
    if lights is not None or find_any:
        raise ValueError("the packed epilogue is for closest-hit launches without the "
                         "fused shadow phase")


def _check_args(what, args, want):
    """Raise unless every tensor is contiguous, of its dtype and shape, and
    on the first one's device."""
    dev = args[0].device
    for a, (dt, shape) in zip(args, want):
        if a.dtype != dt or tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(f"{what}: expected contiguous {dt} {shape}, "
                             f"got {a.dtype} {tuple(a.shape)}")
        if a.device != dev:
            raise ValueError(f"{what}: all tensors must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")


def dense_trace(origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids,
                lights=None, d_mov: float = 0.0, band: Band = STRICT, pack: bool = False):
    """Kernel wrapper: see the module docstring.  origins/directions (R, 3)
    f32, skip (R,) i32, mind/maxd (R,) f32, coef (TI, table_cols(band))
    f32, tri_ids / obj_ids (TI,) i32, lights (L, 4) f32 [is_directional,
    ax, ay, az] or None; `band` the acceptance of both phases, `d_mov` the
    shadow phase's min t.  -> (t, u, v, tri, obj, vis); under `pack` (no
    lights) (t, row, pk)."""
    R = origins.shape[0]
    TI = coef.shape[0]
    L = 0 if lights is None else lights.shape[0]
    f32, i32 = torch.float32, torch.int32
    args = [origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids]
    want = [(f32, (R, 3)), (f32, (R, 3)), (i32, (R,)), (f32, (R,)), (f32, (R,)),
            (f32, (TI, table_cols(band))), (i32, (TI,)), (i32, (TI,))]
    if lights is not None:
        args.append(lights)
        want.append((f32, (L, 4)))
    dev = origins.device
    _check_args("dense_trace", args, want)
    if TI > MAX_TRIS or L > MAX_LIGHTS:
        raise NotImplementedError(
            f"dense_trace covers single-chunk scenes (<= {MAX_TRIS} instance "
            f"triangles, <= {MAX_LIGHTS} lights); got {TI} / {L} "
            "(multi-chunk scenes go to dense_trace_multi)")
    if pack:
        _check_pack(lights)
    if dev.type == "cpu":
        return dense_trace_plain(origins, directions, skip, mind, maxd, coef,
                                 tri_ids, obj_ids, lights, d_mov, band, pack)
    t = torch.empty((R,), dtype=f32, device=dev)
    tri = torch.empty((R,), dtype=i32, device=dev)
    obj = torch.empty_like(tri)
    # under pack the kernel writes (t, row, pk) into (t, tri, obj), no u, v
    u, v, vis = (None,) * 3 if pack else (torch.empty_like(t), torch.empty_like(t),
                                          torch.empty_like(tri))
    ptr = lambda x: None if x is None else x.data_ptr()
    lib = cuda_lib.library("dense_trace")
    code = lib.lprt_dense_trace(
        origins.data_ptr(), directions.data_ptr(), skip.data_ptr(),
        mind.data_ptr(), maxd.data_ptr(), coef.data_ptr(), tri_ids.data_ptr(),
        obj_ids.data_ptr(), ptr(lights), R, TI, L, float(d_mov), *band,
        int(pack), pack_lb(k1a_chunk(TI)), t.data_ptr(), ptr(u), ptr(v),
        tri.data_ptr(), obj.data_ptr(), None if lights is None else vis.data_ptr(),
        cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(code, "dense_trace")
    if pack:
        cuda_lib.LAUNCHES["dense_trace_pack"] += 1
        return t, tri, obj
    cuda_lib.LAUNCHES["dense_trace"] += 1
    if lights is None:
        vis.zero_()
    return t, u, v, tri, obj, vis


# ---------------------------------------------------------------------------
# K1b: multi-chunk dense trace, and the box tree it shares with K6


def dense_trace_multi_plain(origins, directions, skip, mind, maxd, coef, tri_ids,
                            obj_ids, chunk_lo=None, chunk_hi=None, find_any=False,
                            band: Band = STRICT, tree=None, slab_elems: int = 1 << 22,
                            pack: bool = False):
    """Plain PyTorch version of K1b: every ray against every row (the
    chunk AABBs and their tree only prune, so they are not read), as a
    global (t, tri) minimum, the packed epilogue over 128-row chunks
    (`pack`: -> (t, row, pk)) or an any-accept, in slabs of rays of about
    `slab_elems` (ray, row) pairs to bound memory: each f32 temporary of
    the test is 4 * slab_elems bytes, whatever the table's size."""
    if pack:
        _check_pack(find_any=find_any)
    R, TI = origins.shape[0], coef.shape[0]
    dev = origins.device
    outs = []
    rs = max(1, slab_elems // TI)
    for r0 in range(0, max(R, 1), rs):
        sl = slice(r0, r0 + rs)
        t, u, v, geom = tri_quantities(coef, origins[sl], directions[sl], band)
        acc = _accept(t, geom, skip[sl], mind[sl], maxd[sl], tri_ids)
        if find_any:
            n = t.shape[0]
            blocked = acc.any(dim=1)
            outs.append((torch.full((n,), T_MISS, dtype=torch.float32, device=dev),
                         torch.zeros((n,), dtype=torch.float32, device=dev),
                         torch.zeros((n,), dtype=torch.float32, device=dev),
                         torch.where(blocked, 0, -1).to(torch.int32),
                         torch.full((n,), -1, dtype=torch.int32, device=dev)))
        elif pack:
            outs.append(_packed(t, u, v, acc, CHUNK))
        else:
            outs.append(_closest(t, u, v, acc, tri_ids, obj_ids))
    return tuple(torch.cat(x) for x in zip(*outs))


_TABLE_CACHE: dict = {}
# builds `per_table` has run (a frame whose table tensors are the previous
# frame's, as after a camera-only move, runs none)
TABLE_BUILDS = 0


def per_table(anchor: torch.Tensor, key, build):
    """`build()`, once per frame table and `key`: the result is kept while
    `anchor` (a tensor of that table) lives, and entries whose anchor died
    are dropped."""
    global TABLE_BUILDS
    k = (id(anchor), key)
    hit = _TABLE_CACHE.get(k)
    if hit is not None and hit[0]() is anchor:
        return hit[1]
    for dead in [d for d, (ref, _) in _TABLE_CACHE.items() if ref() is None]:
        del _TABLE_CACHE[dead]
    TABLE_BUILDS += 1
    value = build()
    _TABLE_CACHE[k] = (weakref.ref(anchor), value)
    return value


def slice_table(frame) -> torch.Tensor:
    """The 32-row slice boxes K1b and K5 cull by: the AABB of each 32 rows
    (the packet route's leaf boxes), recentred like the rays, (4 NC, 6)
    [lo3 | hi3], once per frame table."""

    def build():
        c = frame.dense_center[None, :]
        return torch.cat([frame.dense_leaf_lo - c, frame.dense_leaf_hi - c], dim=1).contiguous()

    return per_table(frame.dense_leaf_lo, ("slices",), build)


class BoxTree(NamedTuple):
    """An implicit FAN-ary tree over boxes that each hold `leaf`
    consecutive table rows, in the rays' frame."""

    boxes: torch.Tensor  # (N, 6) f32 [lo3 | hi3], root level first, leaves last
    levels: torch.Tensor  # (2 L,) i32 [offset of level 0..L-1 | size of level 0..L-1]
    sizes: tuple  # static: nodes per level, level 0 (the leaves) first
    leaf: int  # table rows per leaf box


def build_tree(leaf_lo, leaf_hi, n_rows: int, leaf: int) -> BoxTree:
    """The tree the K1b and K6 kernels walk: level 0 is the boxes that hold
    rows (ceil(n_rows / leaf) of them; all-padding boxes are left out), and
    node i of level l + 1 is the union of nodes 4i .. 4i + 3 of level l, up
    to a single root.  The unions are exact min / max of the children's
    boxes, so a node contains every box below it."""
    n0 = -(-n_rows // leaf)
    los, his = [leaf_lo[:n0]], [leaf_hi[:n0]]
    while los[-1].shape[0] > 1:
        lo, hi = los[-1], his[-1]
        pad = (-lo.shape[0]) % FAN
        inf = float("inf")
        lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=inf)
        hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-inf)
        los.append(lo.reshape(-1, FAN, 3).amin(dim=1))
        his.append(hi.reshape(-1, FAN, 3).amax(dim=1))
    sizes = tuple(x.shape[0] for x in los)
    if len(sizes) > MAX_LEVELS:
        raise NotImplementedError(
            f"build_tree: {len(sizes)} tree levels, the kernels' stack covers "
            f"{MAX_LEVELS} ({FAN ** (MAX_LEVELS - 1)} leaf boxes)")
    offsets, at = [], 0
    for n in reversed(sizes):  # root level first
        offsets.append(at)
        at += n
    offsets.reverse()
    boxes = torch.cat([torch.cat([lo, hi], dim=1) for lo, hi in zip(reversed(los),
                                                                     reversed(his))])
    levels = torch.tensor(offsets + list(sizes), dtype=torch.int32, device=leaf_lo.device)
    return BoxTree(boxes.contiguous(), levels, sizes, leaf)


SLICE = 32  # K1b: rows per slice box (four a chunk), one row per lane of a warp
MAX_STACK = 3 * (MAX_LEVELS - 1) + 1  # the deepest stack K1b's walk is built for


def walk_stack(tree: BoxTree) -> int:
    """Stack entries K1b's walk needs on `tree`: popping an internal node
    pushes at most FAN - 1 entries more than it takes, so 3 (levels - 1)
    + 1; a tree deeper than the kernel's MAX_LEVELS is refused."""
    L = len(tree.sizes)
    if L > MAX_LEVELS:
        raise NotImplementedError(f"walk_stack: {L} tree levels, K1b's walk covers "
                                  f"{MAX_LEVELS} ({MAX_STACK} stack entries)")
    return 3 * (L - 1) + 1


def lane_table(coef) -> torch.Tensor:
    """The (TI, C) f32 rows (C = 12, or 28 with a sub-f32 form's band rows)
    re-laid for the warp walk: per 32-row slice s and float4 part m of a
    row, the 32 rows' parts side by side, so that lane j's load of part m
    of row 32 s + j is 16-byte coalesced across the warp.  -> (NC * 4 * P *
    32, 4) f32 with P = C / 4, rows past TI zero (NC = ceil(TI / 128)); row
    k's part m sits at [(k // 32) * 32 P + 32 m + k % 32]."""
    TI, C = coef.shape
    n = -(-TI // CHUNK) * CHUNK
    padded = torch.nn.functional.pad(coef, (0, 0, 0, n - TI))
    return padded.reshape(n // SLICE, SLICE, C // 4, 4).transpose(1, 2).reshape(-1, 4).contiguous()


def chunk_slices(chunk_lo, chunk_hi) -> torch.Tensor:
    """Slice boxes for a table whose 32-row slices have no boxes of their
    own: each chunk's box four times, (4 NC, 6) [lo3 | hi3]."""
    return torch.cat([chunk_lo, chunk_hi], dim=1).repeat_interleave(CHUNK // SLICE, dim=0)


def k1b_launch(origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids, tree: BoxTree,
               slices, find_any: bool, band: Band, pack: bool = False,
               stack: int | None = None, persist: bool | None = None, pads=None):
    """Launch K1b (csrc/dense_multi.cu) on CUDA tensors checked by the
    caller: the warp walk of `tree` and the (4 NC, 6) `slices` boxes, under
    a widened acceptance each grown for the ray that tests it by the band's
    reach (`ops/band_pad.py`; `pads`: `band_pads(coef, band, tree, slices)`
    when the caller keeps them).  `stack`: the walk's stack entries (default
    `walk_stack(tree)`; a smaller one makes deep walks overflow, which
    raises); `persist`: resident blocks pull the rays from a counter, so a
    lane whose ray ends takes the next (default: in any hit, where rays end
    at very different depths; in closest hit the lanes keep their
    neighbouring rays, which share chunks).  -> (t, u, v, tri, obj); under
    `pack` (t, row, pk)."""
    from low_precision_raytracer_tpu_torch.ops import band_pad  # it imports this module

    dev = origins.device
    R, TI = origins.shape[0], coef.shape[0]
    if tree.leaf != CHUNK:
        raise ValueError(f"dense_trace_multi: the tree's leaf boxes hold {tree.leaf} rows, "
                         f"not {CHUNK}")
    NC = tree.sizes[0]
    if tuple(slices.shape) != (NC * CHUNK // SLICE, 6) or slices.dtype != torch.float32:
        raise ValueError(f"dense_trace_multi: slices must be ({NC * CHUNK // SLICE}, 6) f32, "
                         f"got {slices.dtype} {tuple(slices.shape)}")
    stack = walk_stack(tree) if stack is None else stack
    persist = find_any if persist is None else persist
    wide = (None, None, None)
    if band.widened:
        if pads is None:
            pads = band_pad.band_pads(coef, band, tree, slices)
        ray4 = band_pad.launch_pads(origins, directions, mind, maxd, band, tree, pads,
                                    find_any or pack)
        wide = (pads.tree, pads.slices, ray4)
    lanes = lane_table(coef)
    slices = slices.contiguous()
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    tri = torch.empty((R,), dtype=torch.int32, device=dev)
    obj = torch.empty_like(tri)
    # under pack the kernel writes (t, row, pk) into (t, tri, obj), no u, v
    u, v = (None, None) if pack else (torch.empty_like(t), torch.empty_like(t))
    status = torch.zeros((2,), dtype=torch.int32, device=dev)  # overflow, ray counter
    ptr = lambda x: None if x is None else x.data_ptr()
    code = cuda_lib.library("dense_multi").lprt_dense_multi(
        origins.data_ptr(), directions.data_ptr(), skip.data_ptr(), mind.data_ptr(),
        maxd.data_ptr(), tri_ids.data_ptr(), obj_ids.data_ptr(),
        tree.boxes.data_ptr(), tree.levels.data_ptr(), lanes.data_ptr(), slices.data_ptr(),
        *(ptr(x) for x in wide), len(tree.sizes), R, TI, int(find_any), int(pack), band.form,
        int(stack), int(persist),
        band.k0, band.k1, band.k2, t.data_ptr(), ptr(u), ptr(v), tri.data_ptr(),
        obj.data_ptr(), status.data_ptr(), cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(code, "dense_multi")
    if int(status[0].item()):
        raise RuntimeError("dense_multi: a ray's walk overflowed the kernel's stack")
    return (t, tri, obj) if pack else (t, u, v, tri, obj)


def dense_trace_multi(origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids,
                      chunk_lo, chunk_hi, find_any: bool = False, band: Band = STRICT,
                      tree: BoxTree | None = None, pack: bool = False, slices=None,
                      pads=None):
    """K1b wrapper: see the module docstring.  origins/directions (R, 3)
    f32, skip (R,) i32, mind/maxd (R,) f32, coef (TI, table_cols(band))
    f32, tri_ids / obj_ids (TI,) i32, chunk_lo/chunk_hi (NC, 3) f32 with NC =
    ceil(TI / 128): the AABB of rows [128 c, 128 c + 128), in the rays'
    (recentred) frame; `tree`: `build_tree(chunk_lo, chunk_hi, TI, 128)`
    when the caller keeps one; `slices` (4 NC, 6) f32 [lo3 | hi3]: the
    AABB of rows [32 s, 32 s + 32), in the same frame (default: each
    chunk's box, `chunk_slices`); `pads`: the widened band's pads of
    `tree` and `slices` (`band_pad.band_pads`) when the caller keeps them.  -> (t, u, v, tri, obj); under `pack` (closest hit)
    (t, row, pk)."""
    R = origins.shape[0]
    TI = coef.shape[0]
    NC = -(-TI // CHUNK)
    f32, i32 = torch.float32, torch.int32
    _check_args("dense_trace_multi",
                [origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids,
                 chunk_lo, chunk_hi],
                [(f32, (R, 3)), (f32, (R, 3)), (i32, (R,)), (f32, (R,)), (f32, (R,)),
                 (f32, (TI, table_cols(band))), (i32, (TI,)), (i32, (TI,)), (f32, (NC, 3)),
                 (f32, (NC, 3))])
    if pack:
        _check_pack(find_any=find_any)
    if origins.device.type == "cpu":
        return dense_trace_multi_plain(origins, directions, skip, mind, maxd, coef,
                                       tri_ids, obj_ids, find_any=find_any, band=band,
                                       pack=pack)
    if tree is None:
        tree = build_tree(chunk_lo, chunk_hi, TI, CHUNK)
    if slices is None:
        slices = chunk_slices(chunk_lo, chunk_hi)
    out = k1b_launch(origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids, tree,
                     slices, find_any, band, pack, pads=pads)
    cuda_lib.LAUNCHES["dense_trace_multi_pack" if pack else "dense_trace_multi"] += 1
    return out


def band_scan(origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids,
              find_any: bool = False, band: Band = STRICT, pack: bool = False):
    """The all-row scan of a widened acceptance (`scan_trace_kernel` in
    csrc/dense_multi.cu, one thread a ray testing every row in order): the
    reference the walks of K1b and K6 are held to on the card, under any
    widened form (dense or packet band) and K1b's packed epilogue.  No
    render path calls it.  Same arguments and results as
    `dense_trace_multi_plain`, which it runs on CPU tensors."""
    R, TI = origins.shape[0], coef.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check_args("band_scan", [origins, directions, skip, mind, maxd, coef, tri_ids, obj_ids],
                [(f32, (R, 3)), (f32, (R, 3)), (i32, (R,)), (f32, (R,)), (f32, (R,)),
                 (f32, (TI, table_cols(band))), (i32, (TI,)), (i32, (TI,))])
    if not band.widened:
        raise ValueError("band_scan: the scan is for the widened forms")
    if pack:
        _check_pack(find_any=find_any)
    if origins.device.type == "cpu":
        return dense_trace_multi_plain(origins, directions, skip, mind, maxd, coef, tri_ids,
                                       obj_ids, find_any=find_any, band=band, pack=pack)
    if coef.data_ptr() % 16:
        raise ValueError("band_scan: the coefficient table must be 16-byte aligned")
    dev = origins.device
    t = torch.empty((R,), dtype=f32, device=dev)
    tri = torch.empty((R,), dtype=i32, device=dev)
    obj = torch.empty_like(tri)
    u, v = (None, None) if pack else (torch.empty_like(t), torch.empty_like(t))
    ptr = lambda x: None if x is None else x.data_ptr()
    code = cuda_lib.library("dense_multi").lprt_band_scan(
        origins.data_ptr(), directions.data_ptr(), skip.data_ptr(), mind.data_ptr(),
        maxd.data_ptr(), coef.data_ptr(), tri_ids.data_ptr(), obj_ids.data_ptr(), R, TI,
        int(find_any), int(pack), band.form, band.k0, band.k1, band.k2, t.data_ptr(), ptr(u),
        ptr(v), tri.data_ptr(), obj.data_ptr(), cuda_lib.stream_ptr(dev))
    cuda_lib.check(code, "band_scan")
    cuda_lib.LAUNCHES["band_scan"] += 1
    return (t, tri, obj) if pack else (t, u, v, tri, obj)


def ray_aabb_entry(lo, hi, o, d, maxd):
    """Conservative slab-test entry bound of rays (RS, 3) against boxes
    (N, 3): -> (entry (RS, N) f32 >= 0, ok (RS, N) bool).  Axes whose slab
    distances are not finite (a zero direction component) constrain
    nothing; 0.02 of slop keeps the bound below every hit the box holds."""
    inv = 1.0 / d
    big = 3e38
    t1 = (lo[None] - o[:, None]) * inv[:, None]  # (RS, N, 3)
    t2 = (hi[None] - o[:, None]) * inv[:, None]
    a = torch.minimum(t1, t2)
    b = torch.maximum(t1, t2)
    fin = torch.isfinite(a) & torch.isfinite(b)
    tmin = torch.where(fin, a, -big).amax(dim=-1)
    tmax = torch.where(fin, b, big).amin(dim=-1)
    entry = torch.clamp(tmin - BOX_SLOP, min=0.0)
    ok = (fin.any(dim=-1) & (tmin <= tmax + BOX_SLOP) & (tmax + BOX_SLOP >= 0)
          & (entry < maxd[:, None]))
    return entry, ok


def coef_table(frame, band: Band = STRICT):
    """(TI, 12) f32 rows n[0..8] | e[0..2] of the frame's dense table: the
    layout every trace kernel reads; a sub-f32 error-band form appends its
    16 band rows (`band_rows`, from `frame.dense_n`), (TI, 28)."""
    TI = frame.dense_n_f32.shape[0]
    cols = [frame.dense_n_f32.reshape(TI, 9), frame.dense_e]
    if band.operand is not None:
        cols.append(band_rows(frame.dense_n.reshape(TI, 9), frame.dense_e, band))
    return torch.cat(cols, dim=1).contiguous()


def scene_exit_cap(frame, o, d, max_dist):
    """Cap every lane's reach at its exit from the scene AABB (the union of
    the object boxes), with the JAX package's slop: no hit lies beyond it,
    and the wavefront's resolution test needs a finite reach.  o, d (R, 3)
    f32 world-space rays, max_dist (R,) f32 -> (R,) f32."""
    lo = frame.obj_aabb_lo.amin(dim=0)
    hi = frame.obj_aabb_hi.amax(dim=0)
    inv = 1.0 / d
    t1 = (lo[None, :] - o) * inv
    t2 = (hi[None, :] - o) * inv
    far = torch.maximum(t1, t2)
    far = torch.where(torch.isfinite(far), far, torch.full_like(far, 3e38))
    texit = far.amin(dim=-1)
    ext = hi - lo
    slop = 1e-3 * torch.sqrt(torch.sum(ext * ext)) + 0.05
    return torch.minimum(max_dist, torch.clamp(texit, min=0.0) * 1.01 + slop)


def anchor_key(lo, hi, origins, directions, max_dist, live, slab_elems: int = 1 << 24):
    """Sort key that groups rays by their nearest chunk (by slab-entry
    bound; chunks merge into <= 1024 anchor groups) and then by direction
    octant and 2 magnitude bits per axis; dead lanes sort last.  The
    (rays, anchors) sweep runs in slabs of about `slab_elems` / 3 pairs."""
    nc = lo.shape[0]
    s = -(-nc // 1024)  # group size -> <= 1024 anchors
    if s > 1:
        pad = (-nc) % s
        lo_g = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=3e38)
        hi_g = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-3e38)
        lo_g = lo_g.reshape(-1, s, 3).amin(dim=1)
        hi_g = hi_g.reshape(-1, s, 3).amax(dim=1)
    else:
        lo_g, hi_g = lo, hi
    na = lo_g.shape[0]
    R = origins.shape[0]
    rs = max(4096, slab_elems // (3 * na))
    anchor = torch.empty((R,), dtype=torch.int32, device=origins.device)
    for r0 in range(0, R, rs):
        sl = slice(r0, r0 + rs)
        entry, ok = ray_aabb_entry(lo_g, hi_g, origins[sl], directions[sl], max_dist[sl])
        anchor[sl] = torch.argmin(torch.where(ok, entry, 3e38), dim=1).to(torch.int32)
    d = directions
    octant = ((d[:, 0] > 0).to(torch.int32) | ((d[:, 1] > 0).to(torch.int32) << 1)
              | ((d[:, 2] > 0).to(torch.int32) << 2))
    qd = torch.clamp(d.abs() * 3, 0, 3).to(torch.int32)  # 2 bits per axis
    dirbits = (octant << 6) | (qd[:, 0] << 4) | (qd[:, 1] << 2) | qd[:, 2]
    key = (anchor << 9) | dirbits
    return key | torch.where(live, 0, 1 << 28).to(torch.int32)


def _spread3(x):
    """7 bits -> every 3rd bit."""
    x = (x | (x << 8)) & 0x0100F00F
    x = (x | (x << 4)) & 0x010C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _spread6(x):
    """4 bits -> bits 0, 6, 12, 18."""
    x = (x | (x << 10)) & 0x00003003
    x = (x | (x << 5)) & 0x00041041
    return x


def morton_key(origins, directions, live=None, mode: str = "beam"):
    """The JAX package's `_morton_key` (`ops/dense_pallas.py`): liveness
    (bit 28: dead lanes sort last), the direction octant, then 'origin': a
    21-bit morton code of the origin (7 bits per axis) or 'beam': origin
    and |direction| interleaved, 4 bits per axis each, origin-major.  The
    origin grid spans the launch's own origins.  -> (R,) i32."""
    of = origins.to(torch.float32)
    df = directions.to(torch.float32)
    lo = of.amin(dim=0)
    hi = of.amax(dim=0)
    i32 = torch.int32
    octant = ((df[:, 0] > 0).to(i32) | ((df[:, 1] > 0).to(i32) << 1)
              | ((df[:, 2] > 0).to(i32) << 2))
    span = torch.clamp(hi - lo, min=1e-6)
    if mode == "origin":
        q = torch.clamp((of - lo) / span * 127, 0, 127).to(i32)
        m = _spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1) | (_spread3(q[:, 2]) << 2)
        key = (octant << 21) | m
    elif mode == "beam":
        qo = torch.clamp((of - lo) / span * 15, 0, 15).to(i32)
        qd = torch.clamp(df.abs() * 15, 0, 15).to(i32)
        m = ((_spread6(qo[:, 0]) << 5) | (_spread6(qo[:, 1]) << 4) | (_spread6(qo[:, 2]) << 3)
             | (_spread6(qd[:, 0]) << 2) | (_spread6(qd[:, 1]) << 1) | _spread6(qd[:, 2]))
        key = (octant << 24) | m
    else:
        raise ValueError(f"morton_key: unknown mode {mode!r}")
    if live is not None:
        key = key | torch.where(live, 0, 1 << 28).to(i32)
    return key


def sorted_launch(launch, key, origins, directions, skip, mind, maxd, *table, **kw):
    """`launch` on the rays in `key` order (a stable sort: a fixed
    permutation), its results scattered back to the caller's order."""
    order = torch.sort(key, stable=True).indices
    outs = launch(origins[order], directions[order], skip[order], mind[order], maxd[order],
                  *table, **kw)
    back = []
    for x in outs:
        y = torch.empty_like(x)
        y[order] = x
        back.append(y)
    return tuple(back)


def dense_trace_multi_sorted(origins, directions, skip, mind, maxd, coef, tri_ids,
                             obj_ids, chunk_lo, chunk_hi, find_any: bool = False,
                             key_mode: str = "anchor", band: Band = STRICT,
                             tree: BoxTree | None = None, pack: bool = False, slices=None,
                             pads=None):
    """K1b on incoherent rays, coherence recovered
    (`trace_rays_dense_pallas_sorted`): sort the rays by `anchor_key`, or
    by `morton_key` in mode `key_mode` ('beam' / 'origin'), trace them in
    that order, scatter the results back to the caller's order.  Same
    arguments and results as `dense_trace_multi`; equal to it bit for bit
    (its result does not depend on ray order)."""
    live = maxd > mind
    if key_mode == "anchor":
        key = anchor_key(chunk_lo, chunk_hi, origins, directions, maxd, live=live)
    else:
        key = morton_key(origins, directions, live=live, mode=key_mode)
    return sorted_launch(dense_trace_multi, key, origins, directions, skip, mind, maxd,
                         coef, tri_ids, obj_ids, chunk_lo, chunk_hi, find_any=find_any,
                         band=band, tree=tree, pack=pack, slices=slices, pads=pads)
