"""Per-ray wavefront for incoherent launches (port of
`low_precision_raytracer_tpu/ops/wavefront.py:trace_rays_wavefront`, in
its two modes: 'oneshot', the mode 'auto' resolves to, and 'rounds').

Each ray gets an exact candidate list instead of sharing a tile's union of
chunks.  One 'oneshot' launch:

1. cap each ray's reach at its scene exit (`scene_exit_cap`); live rays
   have maxd > min_dist;
2. SCHEDULE (`schedule`, CUDA `lprt_wavefront_schedule`): every live ray's
   k nearest chunk groups by slab-entry bound, as packed words
   (entry_bits & ~id_mask) | group id, plus the (k+1)-th word `tcut`; the
   kernel walks a tree of union boxes over the groups (`group_tree`,
   built once per frame table with the group boxes, `group_tables`) and
   culls a subtree only where no word below it can make the list;
3. PAIR PASS: every live (ray, candidate) pair becomes one lane (dead
   rays and empty list slots get none); the lane's ray is rounded to the
   render dtype and then recentred in f32; the lanes are
   sorted by group id (`torch.sort(stable=True)`, the payload gathered
   through the permutation) and each is tested against its group's rows
   (`assigned_test`, K5, CUDA `lprt_wavefront_assigned`: it tests only the
   32-row slices whose boxes its ray enters under the zero-axis rule, as
   `assigned_cull_plain` emulates); the results go
   back to pair order, and per ray the winner is the first minimum t over
   its candidates;
4. MERGE: the running best is replaced only by a strictly smaller t; a ray
   is resolved once min(best t, maxd) <= the entry bound of its first
   untested candidate (or, for any hit, once it has a hit);
5. TAIL: the unresolved rays are compacted to their exact count and get
   deeper lists from their cursor (the first untested word), pass after
   pass until none is left.  Each pass tests at least the next candidate of
   every such ray and a ray without one retires, so the loop ends; it
   raises past a cap it cannot reach rather than return a partial result;
6. DECODE (`decode_packed`): tri and obj from the winning table row; u and
   v from the packed 15-bit fixed point (2^-14 steps); t exact.  An any-hit
   launch returns the tri id of a blocker (consumers read only tri >= 0).

'rounds' (`run_cycle` / `round_step` of the JAX package, :666-808) keeps
the rays in f32 (recentred, not rounded) and replaces steps 2-4 by up to
two schedule cycles: a cycle lists each unresolved ray's K_CAND nearest
groups (from its cursor), then runs at most N_ROUNDS rounds; a round gives
each unresolved ray one lane carrying its next Q_RANKS untested ranks (a
lane tests them in rank order through K5 with q = Q_RANKS), the lanes
sorted by their first group id, merges the results (strictly smaller t)
and retires a ray once min(best t, maxd) <= the entry bound of its first
untested rank (any hit: also at its first hit).  Rounds stop early once
every ray is resolved.  A second cycle refills from the first untested
packed word when there are more than CYCLE2_MIN_GROUPS groups and some
ray is unresolved.

The TPU version's per-tile distinct-group lists (CH_CAP and its `covered`
deferral), tile widths (WTR), HBM streaming of the table, static tail
tiers and its terminal tile-path sweep have no counterpart: every rank a
round assigns and every lane of a pass is tested, and the rays left
unresolved after 'rounds' cycles go to the tail passes of step 5 (on
their f32 rays) until each resolves.  The JAX sweep traces its straggler
rays unquantised through the tile path; in 'oneshot' they stay quantised
here like every other lane.  `STATS` counts cycles, rounds and the rays
that reach the tail passes.

Wrappers launch their kernel on CUDA tensors (or raise) and run the plain
PyTorch version on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from low_precision_raytracer_tpu_torch.ops import cuda_lib
from low_precision_raytracer_tpu_torch.ops.dense_trace import (
    CHUNK,
    SLICE,
    T_MISS,
    BoxTree,
    _check_args,
    build_tree,
    coef_table,
    decode_packed,
    m_shift_test,
    pack_uv,
    per_table,
    ray_aabb_entry,
    scene_exit_cap,
    slice_table,
)
from low_precision_raytracer_tpu_torch.ops.packet_trace import zero_axis_inside

ONESHOT_K = 8  # candidates per ray in the first, full-width pass
# 'rounds' (the JAX package's K_CAND, Q_RANKS, N_ROUNDS, CYCLE2_MIN_GROUPS)
K_CAND = 8  # candidates per ray and cycle
Q_RANKS = 4  # candidate ranks a lane tests per round
N_ROUNDS = 2  # rounds per cycle at most
CYCLE2_MIN_GROUPS = 512  # a second (refill) cycle above this many groups
# tail passes: (unresolved share of the launch above which, candidates)
TAIL_TIERS = ((1 / 4, 8), (1 / 16, 16), (1 / 64, 32), (1 / 256, 64), (0.0, 128))
GROUP_WIDTH = 2048  # the schedule's boxes: s_group = ceil(chunks / this)
SENT_BITS = int(np.float32(3e38).view(np.int32))
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def _n_groups(TI: int, s_group: int) -> int:
    n_chunks = -(-TI // CHUNK)
    return -(-n_chunks // s_group)


def _sentinel(id_bits: int) -> int:
    id_mask = (1 << id_bits) - 1
    return (SENT_BITS & ~id_mask) | id_mask


# ---------------------------------------------------------------------------
# the schedule


def schedule_plain(lo, hi, o, d, maxd, wmin, id_bits: int, k: int,
                   slab_elems: int = 1 << 24):
    """Plain PyTorch version of the schedule (port of `_schedule`): per ray
    the k least packed words >= wmin, ascending, and the (k+1)-th (tcut);
    the sentinel where fewer exist.  lo/hi (NG, 3) f32 group boxes, o/d
    (R, 3) f32 world-space rays, maxd (R,) f32 (0 for a dead ray), wmin
    (R,) i32.  A word at or above the sentinel (an entry >= 3e38) counts as
    the sentinel.  -> cand (R, k) i32, tcut (R,) i32."""
    R, NG = o.shape[0], lo.shape[0]
    id_mask = (1 << id_bits) - 1
    sent = _sentinel(id_bits)
    ids = torch.arange(NG, dtype=torch.int32, device=o.device)[None, :]
    cand = torch.empty((R, k), dtype=torch.int32, device=o.device)
    tcut = torch.empty((R,), dtype=torch.int32, device=o.device)
    rs = max(1024, slab_elems // max(3 * NG, 1))
    for r0 in range(0, R, rs):
        sl = slice(r0, r0 + rs)
        entry, ok = ray_aabb_entry(lo, hi, o[sl], d[sl], maxd[sl])
        words = (entry.view(torch.int32) & ~id_mask) | ids
        words = torch.where(ok & (words < sent) & (words >= wmin[sl, None]), words, sent)
        if NG <= k:
            words = torch.nn.functional.pad(words, (0, k + 1 - NG), value=sent)
        least = torch.topk(words, k + 1, dim=1, largest=False, sorted=True).values
        cand[sl] = least[:, :k]
        tcut[sl] = least[:, k]
    return cand, tcut


def group_tree(lo, hi) -> BoxTree:
    """The schedule kernel's tree over the NG group boxes (one group a
    leaf, in group order): node i of level l + 1 is the exact union of
    nodes 4i .. 4i + 3 of level l (`dense_trace.build_tree`)."""
    return build_tree(lo, hi, lo.shape[0], 1)


SCHED_LEVELS = 8  # csrc/wavefront.cu:LPRT_SCHED_LEVELS


def schedule(lo, hi, o, d, maxd, wmin, id_bits: int, k: int, tree: BoxTree | None = None,
             tests=None):
    """Schedule wrapper (see `schedule_plain`).  `tree`: `group_tree(lo,
    hi)` when the caller keeps one; `tests` (R,) i32: where given, each
    ray's count of the boxes its walk tested (the kernel's counting form,
    for the bound)."""
    R, NG = o.shape[0], lo.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check_args("wavefront schedule", [o, d, maxd, wmin, lo, hi],
                [(f32, (R, 3)), (f32, (R, 3)), (f32, (R,)), (i32, (R,)), (f32, (NG, 3)),
                 (f32, (NG, 3))])
    if NG > GROUP_WIDTH or (1 << id_bits) <= NG:
        raise ValueError(f"wavefront schedule: {NG} groups, id_bits {id_bits}")
    dev = o.device
    if dev.type == "cpu":
        return schedule_plain(lo, hi, o, d, maxd, wmin, id_bits, k)
    if tree is None:
        tree = group_tree(lo, hi)
    if tree.sizes[0] != NG or tree.leaf != 1 or len(tree.sizes) > SCHED_LEVELS:
        raise ValueError(f"wavefront schedule: a tree of {tree.sizes} over {NG} groups")
    if tests is not None:
        _check_args("wavefront schedule", [tests], [(i32, (R,))])
    cand = torch.empty((R, k), dtype=i32, device=dev)
    tcut = torch.empty((R,), dtype=i32, device=dev)
    code = cuda_lib.library("wavefront").lprt_wavefront_schedule(
        o.data_ptr(), d.data_ptr(), maxd.data_ptr(), wmin.data_ptr(), tree.boxes.data_ptr(),
        tree.levels.data_ptr(), len(tree.sizes), tree.boxes.shape[0], R, NG, id_bits, k,
        cand.data_ptr(), tcut.data_ptr(), None if tests is None else tests.data_ptr(),
        cuda_lib.stream_ptr(dev))
    cuda_lib.check(code, "wavefront schedule")
    cuda_lib.LAUNCHES["wavefront_schedule"] += 1
    return cand, tcut


# ---------------------------------------------------------------------------
# K5: the assigned-group lane test


def assigned_test_plain(o, d, skip, mind, maxd, gid, coef, tri_ids, s_group: int,
                        find_any: bool = False, slab_lanes: int = 8192):
    """Plain PyTorch version of K5: each lane against the rows of its
    assigned groups' chunks, in order (groups, then chunks, then rows).
    Within a chunk the least key (t_bits & ~127) | local row wins (any hit:
    the first accepted row); across chunks the strictly smaller t.  o/d
    (P, 3) f32 (recentred, quantised), skip (P,) i32, mind/maxd (P,) f32,
    gid (P, q) i32 (ids outside [0, NG) test nothing), coef (TI, 12) f32,
    tri_ids (TI,) i32.  -> t (P,) f32 (1e5 where nothing is accepted), row
    and pk (P,) i32 (-1)."""
    P, q = gid.shape
    TI = coef.shape[0]
    NG = _n_groups(TI, s_group)
    dev = o.device
    lmask = CHUNK - 1
    local = torch.arange(CHUNK, device=dev)
    outs = []
    for p0 in range(0, max(P, 1), slab_lanes):
        sl = slice(p0, p0 + slab_lanes)
        n = gid[sl].shape[0]
        oo, dd = o[sl][:, :, None], d[sl][:, :, None]
        bt = torch.full((n,), T_MISS, dtype=torch.float32, device=dev)
        brow = torch.full((n,), -1, dtype=torch.int32, device=dev)
        bpk = torch.full((n,), -1, dtype=torch.int32, device=dev)
        for j in range(q):
            g = gid[sl, j].to(torch.int64)
            for s in range(s_group):
                k0 = (g * s_group + s) * CHUNK
                rows = k0[:, None] + local[None, :]
                valid = ((g >= 0) & (g < NG))[:, None] & (rows < TI)
                rows_c = torch.where(valid, rows, 0)
                cr = coef[rows_c]  # (n, 128, 12)
                t, u, v, geom = m_shift_test([cr[..., i] for i in range(12)], oo, dd)
                acc = (valid & geom & (t > mind[sl, None]) & (t < maxd[sl, None]) & (t > 0)
                       & (tri_ids[rows_c] != skip[sl, None]) & torch.isfinite(t))
                if find_any:
                    win = torch.argmax(acc.to(torch.int8), dim=1)  # the first accepted row
                else:
                    key = torch.where(acc, (t.view(torch.int32) & ~lmask) | local.to(torch.int32),
                                      INT32_MAX)
                    win = torch.argmin(key, dim=1)
                got = acc.any(dim=1)
                take = lambda x: x.gather(1, win[:, None])[:, 0]
                tw = take(t)
                better = got & (tw < bt)
                if find_any:
                    better &= brow < 0
                bt = torch.where(better, tw, bt)
                brow = torch.where(better, (k0 + win).to(torch.int32), brow)
                bpk = torch.where(better, pack_uv(take(u), take(v)), bpk)
        outs.append((bt, brow, bpk))
    return tuple(torch.cat(x) for x in zip(*outs))


# the counting form's ints per lane (csrc/wavefront.cu:LPRT_ASSIGNED_COUNTS)
ASSIGNED_COUNTS = ("entered", "entered_box_entry", "boxes_tested", "slices_tested",
                   "rows_tested", "warp_slices", "thread")


def slice_entry(b, o, inv, maxd):
    """K5's slab test of lanes (n, 3) with inv = 1 / d against one slice
    box each (n, 6) [lo3 | hi3]: -> (entry (n,) f32, entered under the
    zero-axis rule (`box_entry_exact0`) (n,) bool, entered under the slab
    test alone (`box_entry`) (n,) bool)."""
    t1 = (b[:, :3] - o) * inv
    t2 = (b[:, 3:] - o) * inv
    fin = torch.isfinite(t1) & torch.isfinite(t2)
    tmin = torch.where(fin, torch.minimum(t1, t2), -3e38).amax(dim=1)
    tmax = torch.where(fin, torch.maximum(t1, t2), 3e38).amin(dim=1)
    e = torch.clamp(tmin - 0.02, min=0.0)
    ok = fin.any(dim=1) & (tmin <= tmax + 0.02) & (tmax + 0.02 >= 0) & (e < maxd)
    return e, ok & zero_axis_inside(b[:, :3], b[:, 3:], o, inv), ok


def assigned_cull_plain(o, d, skip, mind, maxd, gid, coef, tri_ids, slices, s_group: int,
                        find_any: bool = False, slab_lanes: int = 8192):
    """K5's culled loop (csrc/wavefront.cu:assigned_kernel) emulated in
    plain PyTorch, lane by lane in slabs: per chunk the four slice boxes
    `slices` (4 NC, 6) tested by `slice_entry`; closest hit skips a chunk
    whose entered slices all have entry >= the best t and a slice whose
    least key (bits(entry) & ~127) | 32 i exceeds min(chunk minimum so
    far, (bits(best t) & ~127) | 127); any hit skips unentered slices only
    and stops at its first accepted row.  Its result equals
    `assigned_test_plain`'s.  -> (t, row, pk, counts (P, 5) i64: the
    first five of ASSIGNED_COUNTS)."""
    P, q = gid.shape
    TI = coef.shape[0]
    NG = _n_groups(TI, s_group)
    dev = o.device
    lmask = CHUNK - 1
    local = torch.arange(CHUNK, device=dev)
    first = torch.arange(0, CHUNK, SLICE, device=dev)  # each slice's first local row
    inv = 1.0 / d
    outs = []
    for p0 in range(0, max(P, 1), slab_lanes):
        sl = slice(p0, p0 + slab_lanes)
        n = gid[sl].shape[0]
        oo, dd = o[sl][:, :, None], d[sl][:, :, None]
        bt = torch.full((n,), T_MISS, dtype=torch.float32, device=dev)
        brow = torch.full((n,), -1, dtype=torch.int32, device=dev)
        bpk = torch.full((n,), -1, dtype=torch.int32, device=dev)
        done = torch.zeros((n,), dtype=torch.bool, device=dev)
        cnt = torch.zeros((n, 5), dtype=torch.int64, device=dev)
        for j in range(q):
            g = gid[sl, j].to(torch.int64)
            for s in range(s_group):
                c = g * s_group + s
                k0 = c * CHUNK
                on = (g >= 0) & (g < NG) & (k0 < TI)  # the chunk is visited
                live = on & ~done  # ... and its rows may be tested
                rows = k0[:, None] + local[None, :]
                valid = on[:, None] & (rows < TI)
                rows_c = torch.where(valid, rows, 0)
                cr = coef[rows_c]  # (n, 128, 12)
                t, u, v, geom = m_shift_test([cr[..., i] for i in range(12)], oo, dd)
                acc = (valid & geom & (t > mind[sl, None]) & (t < maxd[sl, None]) & (t > 0)
                       & (tri_ids[rows_c] != skip[sl, None]) & torch.isfinite(t))
                has = on[:, None] & (k0[:, None] + first[None, :] < TI)  # (n, 4)
                width = torch.clamp(TI - (k0[:, None] + first[None, :]), 0, SLICE) * has
                box = slices[torch.where(has, 4 * c[:, None] + torch.arange(4, device=dev), 0)]
                e, ent, ent_b = (x.reshape(n, 4) for x in slice_entry(
                    box.reshape(-1, 6), o[sl].repeat_interleave(4, 0),
                    inv[sl].repeat_interleave(4, 0), maxd[sl].repeat_interleave(4)))
                ent, ent_b = ent & has, ent_b & has
                cnt[:, 0] += ent.sum(dim=1)
                cnt[:, 1] += ent_b.sum(dim=1)
                cnt[:, 2] += torch.where(live, has.sum(dim=1), 0)
                if find_any:
                    tested = ent & live[:, None]
                    a = (acc.reshape(n, 4, SLICE) & tested[:, :, None]).reshape(n, CHUNK)
                    got = a.any(dim=1)
                    win = torch.argmax(a.to(torch.int8), dim=1)  # the first accepted row
                    before = first[None, :] < (win - win % SLICE)[:, None]
                    n_rows = torch.where(got, (width * (tested & before)).sum(dim=1)
                                         + win % SLICE + 1, (width * tested).sum(dim=1))
                    # the lane leaves the chunk at its first accepted row
                    tested &= ~got[:, None] | (first[None, :] <= (win - win % SLICE)[:, None])
                else:
                    emin = torch.where(ent, e, float("inf")).amin(dim=1)
                    chunk_on = live & ent.any(dim=1) & (emin < bt)
                    keys = torch.where(acc, (t.view(torch.int32) & ~lmask)
                                       | local.to(torch.int32), INT32_MAX).reshape(n, 4, SLICE)
                    kb = (bt.view(torch.int32) & ~lmask) | lmask
                    kmin = torch.full((n,), INT32_MAX, dtype=torch.int32, device=dev)
                    tested = torch.zeros((n, 4), dtype=torch.bool, device=dev)
                    for i in range(4):
                        least = (e[:, i].contiguous().view(torch.int32) & ~lmask) | (SLICE * i)
                        ti = chunk_on & ent[:, i] & (least <= torch.minimum(kmin, kb))
                        tested[:, i] = ti
                        kmin = torch.where(ti, torch.minimum(kmin, keys[:, i].amin(dim=1)), kmin)
                    got = kmin != INT32_MAX
                    win = (kmin & lmask).to(torch.int64)
                    n_rows = (width * tested).sum(dim=1)
                cnt[:, 3] += tested.sum(dim=1)
                cnt[:, 4] += n_rows
                take = lambda x: x.gather(1, win[:, None])[:, 0]
                tw = take(t)
                better = got & (tw < bt)
                if find_any:
                    better &= brow < 0
                bt = torch.where(better, tw, bt)
                brow = torch.where(better, (k0 + win).to(torch.int32), brow)
                bpk = torch.where(better, pack_uv(take(u), take(v)), bpk)
                if find_any:
                    done |= brow >= 0
        outs.append((bt, brow, bpk, cnt))
    return tuple(torch.cat(x) for x in zip(*outs))


def assigned_test(o, d, skip, mind, maxd, gid, coef, tri_ids, s_group: int,
                  find_any: bool = False, *, slices=None, counts=None):
    """K5 wrapper (see `assigned_test_plain`).  The kernel tests only the
    32-row slices its lane's ray enters (`assigned_cull_plain`): `slices`
    (4 NC, 6) f32, the frame's `slice_table`, is required on CUDA; `counts`
    (P, 7) i32: where given, the kernel's counting form fills it
    (ASSIGNED_COUNTS).  Each block of the kernel regroups its lanes by the
    slices of their first chunk that their rays enter, so a warp's lanes
    test the same slices; the results do not depend on the lanes' order."""
    P, q = gid.shape
    TI = coef.shape[0]
    NG = _n_groups(TI, s_group)
    f32, i32 = torch.float32, torch.int32
    _check_args("wavefront assigned_test",
                [o, d, skip, mind, maxd, gid, coef, tri_ids],
                [(f32, (P, 3)), (f32, (P, 3)), (i32, (P,)), (f32, (P,)), (f32, (P,)),
                 (i32, (P, q)), (f32, (TI, 12)), (i32, (TI,))])
    dev = o.device
    if dev.type == "cpu":
        if counts is not None:
            raise ValueError("wavefront assigned_test: the counting form is the kernel's")
        return assigned_test_plain(o, d, skip, mind, maxd, gid, coef, tri_ids, s_group,
                                   find_any)
    if coef.data_ptr() % 16:
        raise ValueError("wavefront assigned_test: the coefficient table must be 16-byte aligned")
    NC = -(-TI // CHUNK)
    if slices is None:
        raise ValueError("wavefront assigned_test: the kernel needs the slice boxes")
    _check_args("wavefront assigned_test", [slices], [(f32, (NC * CHUNK // SLICE, 6))])
    if counts is not None:
        _check_args("wavefront assigned_test", [counts], [(i32, (P, len(ASSIGNED_COUNTS)))])
    t = torch.empty((P,), dtype=f32, device=dev)
    row = torch.empty((P,), dtype=i32, device=dev)
    pk = torch.empty_like(row)
    code = cuda_lib.library("wavefront").lprt_wavefront_assigned(
        o.data_ptr(), d.data_ptr(), skip.data_ptr(), mind.data_ptr(), maxd.data_ptr(),
        gid.data_ptr(), P, q, coef.data_ptr(), tri_ids.data_ptr(), slices.data_ptr(), TI, NG,
        s_group, int(find_any), t.data_ptr(), row.data_ptr(), pk.data_ptr(),
        None if counts is None else counts.data_ptr(), cuda_lib.stream_ptr(dev))
    cuda_lib.check(code, "wavefront assigned_test")
    cuda_lib.LAUNCHES["wavefront_assigned"] += 1
    return t, row, pk


# ---------------------------------------------------------------------------
# the launch


class Launch(NamedTuple):
    """One wavefront launch's per-ray state and tables."""

    o: torch.Tensor  # (R, 3) f32 world-space rays: the schedule's
    d: torch.Tensor
    o_q: torch.Tensor  # (R, 3) f32, the lanes' rays: recentred ('oneshot':
    d_q: torch.Tensor  # rounded to the render dtype first)
    skip: torch.Tensor  # (R,) i32
    mind: torch.Tensor  # (R,) f32
    maxd: torch.Tensor  # (R,) f32, capped at the scene exit
    live: torch.Tensor  # (R,) bool
    lo: torch.Tensor  # (NG, 3) f32 world group boxes
    hi: torch.Tensor
    tree: BoxTree  # the schedule's tree over them (`group_tree`)
    coef: torch.Tensor  # (TI, 12) f32
    slices: torch.Tensor  # (4 NC, 6) f32 the 32-row slice boxes K5 culls by
    tri: torch.Tensor  # (TI,) i32
    obj: torch.Tensor  # (TI,) i32
    s_group: int
    id_bits: int
    find_any: bool


def setup(frame, origins, directions, prec, skip_tri, min_dist, max_dist,
          find_any: bool, quantize: bool = True) -> Launch:
    """The launch's state; `quantize` rounds the lanes' rays to the render
    dtype ('oneshot'), else they stay f32 ('rounds')."""
    f32 = torch.float32
    dev = origins.device
    R = origins.shape[0]
    skip = (torch.full((R,), -1, dtype=torch.int32, device=dev) if skip_tri is None
            else skip_tri.to(torch.int32))
    mind = torch.broadcast_to(torch.as_tensor(min_dist, dtype=f32, device=dev), (R,))
    max_dist = torch.broadcast_to(torch.as_tensor(max_dist, dtype=f32, device=dev), (R,))
    o = origins.to(f32).contiguous()
    d = directions.to(f32).contiguous()
    maxd = scene_exit_cap(frame, o, d, max_dist).contiguous()
    c = frame.dense_center
    q = (lambda x: x.to(prec.dtype).to(f32)) if quantize else (lambda x: x)
    o_q = (q(o) - c[None, :]).contiguous()
    d_q = q(d).contiguous()

    lo, hi, s_group, id_bits, tree = group_tables(frame)
    return Launch(o, d, o_q, d_q, skip.contiguous(), mind.contiguous(), maxd,
                  maxd > mind, lo, hi, tree, coef_table(frame), slice_table(frame),
                  frame.dense_tri, frame.dense_obj, s_group, id_bits, find_any)


def group_tables(frame):
    """The frame's group boxes (world AABBs of s_group consecutive chunks,
    s_group = ceil(chunks / GROUP_WIDTH)), s_group, the id bits of the
    packed words and the schedule's tree over the groups, once per frame
    table (keyed on `dense_chunk_lo`)."""

    def build():
        lo, hi = frame.dense_chunk_lo, frame.dense_chunk_hi
        n_chunks = lo.shape[0]
        s_group = max(1, -(-n_chunks // GROUP_WIDTH))
        pad = (-n_chunks) % s_group
        if s_group > 1:
            lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=3e38)
            hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-3e38)
            lo = lo.reshape(-1, s_group, 3).amin(dim=1)
            hi = hi.reshape(-1, s_group, 3).amax(dim=1)
        lo, hi = lo.contiguous(), hi.contiguous()
        # one extra bit so the sentinel id (all ones) exceeds every real id
        id_bits = max(2, lo.shape[0].bit_length())
        return lo, hi, s_group, id_bits, group_tree(lo, hi)

    return per_table(frame.dense_chunk_lo, ("groups",), build)


def pair_lanes(L: Launch, sel, cand, live):
    """Expand the live (ray, candidate) pairs into lanes sorted by group
    id; a pair of a dead ray, or past the end of its ray's list, gets no
    lane (one host sync for the count).  `sel` (n,) i64 ray indices (None:
    all rays), cand (n, kk) i32 words, live (n,) bool.  -> (pair (P,) i64:
    each lane's index in pair order, the lanes' (o, d, skip, mind, maxd,
    gid (P, 1)))."""
    id_mask = (1 << L.id_bits) - 1
    kk = cand.shape[1]
    pid = cand & id_mask
    pair = torch.nonzero(((pid < id_mask) & live[:, None]).reshape(-1)).flatten()
    key_s, order = torch.sort(pid.reshape(-1)[pair], stable=True)
    pair = pair[order]
    ray_s = pair // kk
    if sel is not None:
        ray_s = sel[ray_s]
    return pair, _lanes(L, ray_s, key_s[:, None].contiguous())


def _lanes(L: Launch, rays, gid):
    """The lanes' inputs of K5 for ray indices `rays` with groups gid."""
    return L.o_q[rays], L.d_q[rays], L.skip[rays], L.mind[rays], L.maxd[rays], gid


def combine(pair, out, cand, tcut, id_bits: int):
    """Back to pair order (a pair without a lane: no hit), then per ray the
    first minimum t over its candidates with a hit.  -> (t_b, row_b, pk_b,
    e_next, w_next): the entry bound and word of the first untested
    candidate (tcut: every listed candidate was tested)."""
    n, kk = cand.shape
    back = []
    for x, miss in zip(out, (T_MISS, -1, -1)):
        y = torch.full((n * kk,), miss, dtype=x.dtype, device=x.device)
        y[pair] = x
        back.append(y.reshape(n, kk))
    t_r, row_r, pk_r = back
    t_m = torch.where(row_r >= 0, t_r, float("inf"))
    j = torch.argmin(t_m, dim=1, keepdim=True)
    t_b = t_m.gather(1, j)[:, 0]
    row_b = row_r.gather(1, j)[:, 0]
    pk_b = pk_r.gather(1, j)[:, 0]
    id_mask = (1 << id_bits) - 1
    e_next = (tcut & ~id_mask).view(torch.float32)
    return t_b, row_b, pk_b, e_next, tcut


def pair_pass(L: Launch, sel, emin, kk: int):
    """Schedule, pair expansion, K5 and the per-ray combine for the rays
    `sel` (None: all) from their cursors `emin` (n,) i32 with kk
    candidates each."""
    take = (lambda x: x) if sel is None else (lambda x: x[sel])
    live = take(L.live)
    cand, tcut = schedule(L.lo, L.hi, take(L.o), take(L.d),
                          torch.where(live, take(L.maxd), 0.0).contiguous(), emin,
                          L.id_bits, kk, tree=L.tree)
    pair, lanes = pair_lanes(L, sel, cand, live)
    out = assigned_test(*lanes, L.coef, L.tri, L.s_group, L.find_any, slices=L.slices)
    return combine(pair, out, cand, tcut, L.id_bits)


def _tail_k(n: int, R: int, n_groups: int) -> int:
    for share, k in TAIL_TIERS:
        if n > share * R:
            return min(k, n_groups)
    return min(TAIL_TIERS[-1][1], n_groups)


class State(NamedTuple):
    """A launch's running per-ray result (updated in place)."""

    best_t: torch.Tensor  # (R,) f32, 1e5 until a hit
    best_row: torch.Tensor  # (R,) i32, -1 until a hit
    best_pk: torch.Tensor  # (R,) i32
    resolved: torch.Tensor  # (R,) bool
    emin: torch.Tensor  # (R,) i32: the first untested packed word (the cursor)


STATS = {"launches": 0, "cycles": 0, "rounds": 0, "tail_rays": 0, "tail_passes": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def _merge(L: Launch, st: State, sel, t_b, row_b, pk_b, e_next, w_next):
    """Fold a pass's per-ray result into the state for the rays `sel`
    (None: all): the strictly smaller t wins; a ray resolves once min(best
    t, maxd) <= e_next (any hit: also once it has a hit); the cursor moves
    to w_next."""
    sl = slice(None) if sel is None else sel
    bt, br, bp = st.best_t[sl], st.best_row[sl], st.best_pk[sl]
    better = (row_b >= 0) & (t_b < bt)
    st.best_t[sl] = bt = torch.where(better, t_b, bt)
    st.best_row[sl] = br = torch.where(better, row_b, br)
    st.best_pk[sl] = torch.where(better, pk_b, bp)
    res = torch.minimum(bt, L.maxd[sl]) <= e_next
    if L.find_any:
        res |= br >= 0
    st.resolved[sl] = st.resolved[sl] | res
    st.emin[sl] = w_next


def run_cycle(L: Launch, st: State, sel) -> int:
    """One 'rounds' cycle (JAX `run_cycle` :760-808) for the unresolved
    live rays `sel` (i64): their K_CAND nearest groups from the cursor,
    then up to N_ROUNDS rounds (`round_step` :666-758), each ray's next
    Q_RANKS ranks per round.  Updates `st`; -> the rounds run."""
    n_groups = L.lo.shape[0]
    k = min(K_CAND, n_groups)
    q = min(Q_RANKS, k)
    id_mask = (1 << L.id_bits) - 1
    dev = L.o.device
    cand, tcut = schedule(L.lo, L.hi, L.o[sel], L.d[sel], L.maxd[sel].contiguous(),
                          st.emin[sel].contiguous(), L.id_bits, k, tree=L.tree)
    cand_id = cand & id_mask
    cand_e = (cand & ~id_mask).view(torch.float32)
    tcut_e = (tcut & ~id_mask).view(torch.float32)
    ptr = torch.zeros(sel.shape, dtype=torch.int64, device=dev)
    ranks = torch.arange(q, device=dev)[None, :]

    def entry_at(p, idx=slice(None)):  # entry bound of the first untested rank
        on_list = cand_e[idx].gather(1, p.clamp(max=k - 1)[:, None])[:, 0]
        return torch.where(p < k, on_list, tcut_e[idx])

    bt, br, bp = st.best_t[sel], st.best_row[sel], st.best_pk[sel]
    mx = L.maxd[sel]
    res = st.resolved[sel] | (torch.minimum(bt, mx) <= entry_at(ptr))
    rounds = 0
    while rounds < N_ROUNDS:
        act = torch.nonzero(~res).flatten()  # one host sync per round
        if act.numel() == 0:
            break
        rk = ptr[act, None] + ranks
        gid = torch.where(rk < k, cand_id[act].gather(1, rk.clamp(max=k - 1)), id_mask)
        # the lanes sorted by their first group: a warp's lanes share rows
        order = torch.sort(gid[:, 0], stable=True).indices
        lanes = _lanes(L, sel[act[order]], gid[order].to(torch.int32).contiguous())
        t_r, row_r, pk_r = assigned_test(*lanes, L.coef, L.tri, L.s_group, L.find_any,
                                         slices=L.slices)
        ia = act[order]
        better = (row_r >= 0) & (t_r < bt[ia])
        bt[ia] = torch.where(better, t_r, bt[ia])
        br[ia] = torch.where(better, row_r, br[ia])
        bp[ia] = torch.where(better, pk_r, bp[ia])
        ptr[act] = torch.clamp(ptr[act] + q, max=k)
        ra = torch.minimum(bt[act], mx[act]) <= entry_at(ptr[act], act)
        if L.find_any:
            ra |= br[act] >= 0
        res[act] = ra
        rounds += 1
    w_at = cand.gather(1, ptr.clamp(max=k - 1)[:, None])[:, 0]
    st.best_t[sel], st.best_row[sel], st.best_pk[sel] = bt, br, bp
    st.resolved[sel] = res
    st.emin[sel] = torch.where(res, INT32_MAX, torch.where(ptr < k, w_at, tcut))
    return rounds


def trace_rays_wavefront(frame, origins, directions, *, prec, skip_tri=None, min_dist=0.0,
                         max_dist=1e5, find_any: bool = False, mode: str = "auto"):
    """One wavefront launch in `mode` ('auto' is 'oneshot'; see the module
    docstring).  origins/directions (R, 3), skip_tri (R,) i32 or None,
    min_dist/max_dist scalars or (R,).  -> (t, u, v, tri, obj): t = 1e5,
    u = v = 0 and ids -1 on a miss."""
    if prec.is_f32:
        raise ValueError("the wavefront launch is for bf16/fp16 (the mxu3 test)")
    mode = "oneshot" if mode == "auto" else mode
    if mode not in ("oneshot", "rounds"):
        raise ValueError(f"wavefront mode {mode!r}")
    L = setup(frame, origins, directions, prec, skip_tri, min_dist, max_dist, find_any,
              quantize=mode == "oneshot")
    R, dev = L.o.shape[0], L.o.device
    n_groups = L.lo.shape[0]
    i32 = torch.int32
    st = State(torch.full((R,), T_MISS, dtype=torch.float32, device=dev),
               torch.full((R,), -1, dtype=i32, device=dev),
               torch.full((R,), -1, dtype=i32, device=dev), ~L.live,
               torch.full((R,), INT32_MIN, dtype=i32, device=dev))
    STATS["launches"] += 1

    if mode == "rounds":
        for _cycle in range(1 if n_groups <= CYCLE2_MIN_GROUPS else 2):
            sel = torch.nonzero(~st.resolved).flatten()
            if sel.numel() == 0:
                break
            STATS["cycles"] += 1
            STATS["rounds"] += run_cycle(L, st, sel)
    else:
        _merge(L, st, None, *pair_pass(L, None, st.emin, min(ONESHOT_K, n_groups)))

    # the tail: the unresolved rays, compacted (one host sync per pass)
    sel = torch.nonzero(~st.resolved).flatten()
    STATS["tail_rays"] += sel.numel()
    # every pass tests >= 8 (or all remaining) candidates of each ray in it
    max_passes = 1 + -(-n_groups // min(8, n_groups))
    for n_pass in range(max_passes + 1):
        if sel.numel() == 0:
            break
        if n_pass == max_passes:
            raise RuntimeError(f"wavefront: rays unresolved after {max_passes} tail passes")
        STATS["tail_passes"] += 1
        k = _tail_k(sel.numel(), R, n_groups)
        _merge(L, st, sel, *pair_pass(L, sel, st.emin[sel], k))
        sel = torch.nonzero(~st.resolved).flatten()

    u, v, tri, obj = decode_packed(st.best_row, st.best_pk, L.tri, L.obj)
    return st.best_t, u, v, tri, obj
