"""PyTorch port, K1b's warp walk (`csrc/dense_multi.cu:chunk_walk_kernel`)
and the host helpers it reads: the stack bound from the tree's depth
(`walk_stack`), the table re-laid for coalesced row loads (`lane_table`)
and the 32-row slice boxes (`ops/trace.py:_slice_table`, the packet
route's leaf boxes; `chunk_slices` where a table has none).

On the port's own `sponza_like_scene(3, 1)` (830 instance triangles in 7
chunks, bf16 tables) with random rays (zero direction components, dead
lanes and skipped triangles planted):
- the kernel's walk, emulated ray by ray (its stack bounded by
  `walk_stack`, a chunk's slices slab-tested and skipped as the kernel
  skips them, the rows read back from `lane_table`, accepted lanes merged
  as the warp merges them), equals `dense_trace_multi_plain` bit for bit
  in closest hit, any hit, the packed epilogue and the f32 'both' band;
  with too small a stack it reports the overflow the kernel raises on;
- the re-laid table and the slice boxes through the emulated tree walk of
  tests/test_torch_dense_multi.py (`test_torch_packet._walk`, here over a
  tree of the slice boxes) give the same results;
- a tree deeper than the kernel's stack is built for is refused."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu_torch.config import RenderConfig, get_precision
from low_precision_raytracer_tpu_torch.models.procedural import sponza_like_scene
from low_precision_raytracer_tpu_torch.ops import trace as T
from low_precision_raytracer_tpu_torch.ops.dense_trace import (
    CHUNK,
    MAX_LEVELS,
    SLICE,
    STRICT,
    BoxTree,
    build_tree,
    chunk_slices,
    dense_band,
    dense_trace_multi,
    dense_trace_multi_plain,
    lane_table,
    m_shift_test,
    pack_uv,
    walk_stack,
)
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_packet import _walk as tree_walk

N_RAYS = 384
INT32_MAX = 2**31 - 1


@pytest.fixture(scope="module")
def scene():
    r = Renderer(sponza_like_scene(3, 1), RenderConfig(width=32, height=16, precision="bf16"),
                 device="cpu")
    f = r.frame
    lo, hi, tree = T._chunk_tables(f)
    coef = T.frame_table(f, STRICT)
    rng = np.random.default_rng(11)
    span = (hi.max(0).values - lo.min(0).values).numpy()
    base = lo.min(0).values.numpy()
    o = base + rng.random((N_RAYS, 3)) * span
    d = rng.standard_normal((N_RAYS, 3))
    d[::7, 0] = 0.0  # zero direction components, as the sun's
    d[3::11, 2] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxd = np.where(rng.random(N_RAYS) < 0.5, 1e5, 1 + 40 * rng.random(N_RAYS))
    maxd[5::13] = 0.0  # dead lanes
    skip = np.where(rng.random(N_RAYS) < 0.3,
                    rng.integers(0, int(f.dense_tri.max()) + 1, N_RAYS), -1)
    rays = (torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32),
            torch.tensor(skip, dtype=torch.int32), torch.full((N_RAYS,), 1e-2),
            torch.tensor(maxd, dtype=torch.float32))
    return dict(frame=f, lo=lo, hi=hi, tree=tree, coef=coef, rays=rays,
                slices=T._slice_table(f))


def _box(b, o, inv, maxd):
    """The kernels' box_entry of one ray against boxes (n, 6)."""
    t1 = (b[:, :3] - o) * inv
    t2 = (b[:, 3:] - o) * inv
    fin = torch.isfinite(t1) & torch.isfinite(t2)
    tmin = torch.where(fin, torch.minimum(t1, t2), -3e38).amax(dim=1)
    tmax = torch.where(fin, torch.maximum(t1, t2), 3e38).amin(dim=1)
    e = torch.clamp(tmin - 0.02, min=0.0)
    return e, fin.any(1) & (tmin <= tmax + 0.02) & (tmax + 0.02 >= 0) & (e < maxd)


def warp_walk(o, d, skip, mind, maxd, coef, tri_ids, obj_ids, tree, slices, find_any=False,
              band=STRICT, pack=False, stack=None, box=_box):
    """K1b's warp walk, ray by ray: -> (outputs as the kernel writes them,
    overflowed).  `box`: the box test (K1b's `box_entry`; K6 passes its
    zero-axis rule).  Per ray a stack of at most `stack` entries (default
    `walk_stack(tree)`); a popped chunk's slices are slab-tested (closest
    hit without pack also skips a slice entered beyond the best t) and the
    32 rows of each slice left, read from `lane_table`, are tested at once,
    as a warp's 32 lanes test them: accepted lanes merge into the best in
    lane order (closest hit), their least packed key into the chunk's
    (pack), or the first slice with an accepted lane blocks the ray (any
    hit)."""
    R, TI = o.shape[0], coef.shape[0]
    lanes = lane_table(coef)
    P = coef.shape[1] // 4  # float4 parts a row
    cap = walk_stack(tree) if stack is None else stack
    L = len(tree.sizes)
    offs = tree.levels[:L].tolist()
    top = L - 1
    out_t = torch.full((R,), 1e5)
    out_u, out_v = torch.zeros(R), torch.zeros(R)
    out_tri = torch.full((R,), -1, dtype=torch.int32)
    out_obj = torch.full((R,), -1, dtype=torch.int32)
    overflow = False
    for r in range(R):
        mn, mx = float(mind[r]), float(maxd[r])
        bt, bu, bv, btri, brow = torch.tensor(1e5), 0.0, 0.0, -1, -1
        pt, pu, pv, prow = torch.tensor(1e5), 0.0, 0.0, -1
        blocked = False
        if mx > mn:
            inv = 1.0 / d[r]
            e, ok = box(tree.boxes[offs[top]][None], o[r], inv, maxd[r])
            st = [(top, 0, e[0])] if bool(ok[0]) else []
            while st:
                lvl, idx, ent = st.pop()
                best = pt if pack else bt
                if not find_any and bool(ent > best):
                    continue
                if lvl == 0:
                    sl = [CHUNK // SLICE * idx + q for q in range(CHUNK // SLICE)]
                    sl = [s for s in sl if s * SLICE < TI]
                    es, ok = box(slices[sl], o[r], inv, maxd[r])
                    if not find_any and not pack:
                        ok &= ~(es > best)
                    kmin, ct, cu, cv = INT32_MAX, None, 0.0, 0.0
                    for s in [s for s, keep in zip(sl, ok.tolist()) if keep]:
                        rows = lanes[s * SLICE * P:(s + 1) * SLICE * P].reshape(P, SLICE, 4)
                        rows = rows.transpose(0, 1).reshape(SLICE, 4 * P)
                        k = s * SLICE + torch.arange(SLICE)
                        kc = k.clamp(max=TI - 1)
                        t, u, v, geom = m_shift_test([rows[:, i][None, :] for i in range(4 * P)],
                                                     o[r][None, :, None], d[r][None, :, None],
                                                     band)
                        t, u, v, geom = t[0], u[0], v[0], geom[0]
                        acc = ((k < TI) & geom & (t > mn) & (t < mx) & (tri_ids[kc] != skip[r])
                               & torch.isfinite(t))
                        if find_any:
                            if bool(acc.any()):
                                blocked, st = True, []
                                break
                            continue
                        if pack:
                            acc &= t > 0
                            key = torch.where(acc, (t.view(torch.int32) & ~(CHUNK - 1))
                                              | (k - CHUNK * idx).to(torch.int32), INT32_MAX)
                            km = int(key.min())
                            if km < kmin:
                                lane = km & (SLICE - 1)
                                kmin, ct, cu, cv = km, t[lane], u[lane], v[lane]
                            continue
                        for lane in torch.nonzero(acc)[:, 0].tolist():
                            wt, wtri, wk = t[lane], int(tri_ids[k[lane]]), int(k[lane])
                            if bool(wt < bt) or (bool(wt == bt) and (
                                    wtri < btri or (wtri == btri and wk < brow))):
                                bt, bu, bv, btri, brow = wt, u[lane], v[lane], wtri, wk
                    if pack and kmin != INT32_MAX:
                        row = CHUNK * idx + (kmin & (CHUNK - 1))
                        if bool(ct < pt) or (bool(ct == pt) and row < prow):
                            pt, pu, pv, prow = ct, cu, cv, row
                    continue
                cl = lvl - 1
                ch = [c for c in range(4 * idx, 4 * idx + 4) if c < tree.sizes[cl]]
                e, ok = box(tree.boxes[[offs[cl] + c for c in ch]], o[r], inv, maxd[r])
                if not find_any:
                    ok &= ~(e > (pt if pack else bt))
                kids = sorted(((float(e[j]), c) for j, c in enumerate(ch) if bool(ok[j])),
                              reverse=True)
                if len(st) + len(kids) > cap:
                    overflow, st = True, []
                    break
                st += [(cl, c, torch.tensor(x)) for x, c in kids]
        if pack:
            out_t[r], out_tri[r] = pt, prow
            out_obj[r] = int(pack_uv(torch.tensor([pu]), torch.tensor([pv]))[0]) \
                if prow >= 0 else -1
        elif find_any:
            out_tri[r] = 0 if blocked else -1
        else:
            out_t[r], out_u[r], out_v[r], out_tri[r] = bt, bu, bv, btri
            out_obj[r] = int(obj_ids[brow]) if brow >= 0 else -1
    if pack:
        return (out_t, out_tri, out_obj), overflow
    return (out_t, out_u, out_v, out_tri, out_obj), overflow


def _table(scene, band=STRICT):
    f = scene["frame"]
    coef = T.frame_table(f, band)
    return coef, f.dense_tri, f.dense_obj


@pytest.mark.parametrize("form", ["closest", "any", "pack", "f32-both"])
@pytest.mark.parametrize("slice_boxes", ["leaves", "chunks"])
def test_warp_walk_equals_plain(scene, form, slice_boxes):
    band = dense_band(get_precision("fp32")) if form == "f32-both" else STRICT
    coef, tri, obj = _table(scene, band)
    find_any, pack = form == "any", form == "pack"
    slices = scene["slices"] if slice_boxes == "leaves" else chunk_slices(scene["lo"], scene["hi"])
    got, overflow = warp_walk(*scene["rays"], coef, tri, obj, scene["tree"], slices,
                              find_any=find_any, band=band, pack=pack)
    want = dense_trace_multi_plain(*scene["rays"], coef, tri, obj, find_any=find_any,
                                   band=band, pack=pack)
    assert not overflow
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    hit = want[1] if pack else want[3]
    assert bool((hit >= 0).any()) and bool((hit < 0).any())


def test_stack_bound_and_overflow(scene):
    """The stack `walk_stack` gives is what the walk needs (3 per internal
    level + 1), and a smaller one overflows, which the kernel reports."""
    tree = scene["tree"]
    assert walk_stack(tree) == 3 * (len(tree.sizes) - 1) + 1
    coef, tri, obj = _table(scene)
    _, overflow = warp_walk(*(x[:48] for x in scene["rays"]), coef, tri, obj, tree,
                            scene["slices"], stack=2)
    assert overflow


def test_too_deep_tree_refused(scene):
    tree = scene["tree"]
    deep = BoxTree(tree.boxes, tree.levels, tuple([1] * (MAX_LEVELS + 1)), CHUNK)
    with pytest.raises(NotImplementedError):
        walk_stack(deep)
    assert walk_stack(BoxTree(tree.boxes, tree.levels, tuple([1] * MAX_LEVELS), CHUNK)) \
        == 3 * (MAX_LEVELS - 1) + 1


def test_lane_table_layout():
    """Row k's float4 part m sits at [(k // 32) 32 P + 32 m + k % 32], P
    the parts a row (3 for the f32 rows, 7 with the band rows); rows past
    the table are zero."""
    rng = np.random.default_rng(4)
    TI = 300
    coef = torch.tensor(rng.standard_normal((TI, 12)), dtype=torch.float32)
    lanes = lane_table(coef)
    NC = -(-TI // CHUNK)
    assert tuple(lanes.shape) == (NC * CHUNK * 3, 4)
    k = torch.arange(NC * CHUNK)
    for m in range(3):
        got = lanes[(k // SLICE) * 96 + SLICE * m + k % SLICE]
        assert torch.equal(got[:TI], coef[:, 4 * m:4 * m + 4])
        assert bool((got[TI:] == 0).all())
    # a sub-f32 form's table: the walk re-lays all 28 columns, 7 parts a row
    wide = torch.cat([coef, torch.tensor(rng.standard_normal((TI, 16)), dtype=torch.float32)],
                     dim=1)
    lanes = lane_table(wide)
    assert tuple(lanes.shape) == (NC * CHUNK * 7, 4)
    for m in range(7):
        got = lanes[(k // SLICE) * SLICE * 7 + SLICE * m + k % SLICE]
        assert torch.equal(got[:TI], wide[:, 4 * m:4 * m + 4])
        assert bool((got[TI:] == 0).all())


def test_slice_table_is_the_packet_leaves(scene):
    f = scene["frame"]
    lo, hi, _ = T._packet_tables(f)
    assert torch.equal(scene["slices"], torch.cat([lo, hi], dim=1))
    assert scene["slices"].shape[0] == CHUNK // SLICE * scene["lo"].shape[0]
    rep = chunk_slices(scene["lo"], scene["hi"])
    assert torch.equal(rep[1::4], torch.cat([scene["lo"], scene["hi"]], dim=1))


@pytest.mark.parametrize("find_any", [False, True], ids=["closest", "any"])
def test_relaid_table_and_slices_through_tree_walk(scene, find_any):
    """The rows read back from `lane_table` and a tree over the slice
    boxes, walked by the emulated tree walk, give the plain version's
    result; so does the wrapper (the plain version on the CPU)."""
    coef, tri, obj = _table(scene)
    TI = coef.shape[0]
    rows = lane_table(coef).reshape(-1, 3, SLICE, 4).transpose(1, 2).reshape(-1, 12)[:TI]
    s = scene["slices"]
    tree = build_tree(s[:, :3], s[:, 3:], TI, SLICE)
    got = tree_walk(*scene["rays"], rows.contiguous(), tri, obj, tree, find_any)
    want = dense_trace_multi_plain(*scene["rays"], coef, tri, obj, find_any=find_any)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    wrapped = dense_trace_multi(*scene["rays"], coef, tri, obj, scene["lo"], scene["hi"],
                                find_any=find_any, tree=scene["tree"], slices=s)
    for a, b in zip(wrapped, want):
        assert torch.equal(a, b)
