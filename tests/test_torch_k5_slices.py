"""PyTorch port, K5's culled lane loop (`csrc/wavefront.cu:assigned_kernel`:
each lane tests only the 32-row slices whose boxes its ray enters under the
zero-axis rule, `box_entry_exact0`) emulated in plain PyTorch
(`ops/wavefront.py:assigned_cull_plain`) against K5's all-row plain version
`assigned_test_plain`, on the JAX package's `sponza_like_scene(3, 1)`
(830 instance triangles in 7 chunks, the last one partial: 62 rows; bf16
tables, flattened by the JAX package).  Lanes come from the schedule of
rays made with numpy from seeds and rounded to bf16: a third along the
sun's direction (d_x exactly 0, as `sponza_like_scene`'s sun), a third
random, a third with a zero y or z component; dead lanes and skipped
triangles among them.

- The emulation equals the plain version bit for bit (t, row, pk) in
  closest and any hit, with one and two chunks a group (s_group) and one
  and four groups a lane (q), on lanes of the first pass, on lanes sent to
  the last (partial) group, and on a table whose winning rows are copied
  into other slices of their chunks (keys tied in their 128-ulp bucket
  across slices; every slice box then its chunk's box).
- Its rule is conservative: every row the all-row test accepts lies in a
  slice its lane enters under the rule (`packet_trace.zero_axis_inside`
  with the slab test), at a t no smaller than that slice's entry bound; the
  rule enters fewer slices than the slab test alone on the zero-axis lanes.
- Whole wavefront launches ('oneshot' and 'rounds', closest and any hit)
  with the emulation in K5's place equal the plain route bit for bit, and
  on the sun's shadow rays the port's launch agrees with the JAX package's
  `trace_rays_wavefront(..., interpret=True)` at the occlusion bar of
  tests/test_torch_wavefront.py (> 0.999)."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import get_precision as jax_precision
from low_precision_raytracer_tpu.models.procedural import sponza_like_scene as jax_sponza
from low_precision_raytracer_tpu.models.scene import build_scene_arrays, flatten_frame
from low_precision_raytracer_tpu.ops import wavefront as JW
from low_precision_raytracer_tpu_torch.config import get_precision
from low_precision_raytracer_tpu_torch.models import scene as tscene
from low_precision_raytracer_tpu_torch.ops import wavefront as W
from low_precision_raytracer_tpu_torch.ops.dense_trace import (
    CHUNK,
    SLICE,
    chunk_slices,
    m_shift_test,
)
from low_precision_raytracer_tpu_torch.ops.packet_trace import zero_axis_inside

BF16 = get_precision("bf16")
N_RAYS = 1536
SUN = np.array([0.0, 0.8, 0.6])  # a direction with an exact zero x component


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).to(torch.float32)


@pytest.fixture(scope="module")
def scene():
    host = jax_sponza(3, 1, with_skybox=False)
    prec = jax_precision("bf16")
    jscene = build_scene_arrays(host, prec)
    frame = flatten_frame(host, prec, max_direct_lights=4, width=16, height=16)
    frame_np = {k: np.asarray(getattr(frame, k)) for k in tscene.tensor_fields(tscene.FrameInput)}
    frame_np.update(obj_layout=frame.obj_layout, n_lights=frame.n_lights,
                    dense_morton=frame.dense_morton)
    scene_np = {k: np.asarray(getattr(jscene, k))
                for k in tscene.tensor_fields(tscene.SceneArrays)}
    scene_np.update(n_meshes=jscene.n_meshes, sky_valid=jscene.sky_valid)
    _s, tframe = tscene.scene_from_numpy(scene_np, frame_np, "cpu")
    return dict(jscene=jscene, jframe=frame, prec=prec, frame=tframe)


def _rays(frame, n, seed):
    """n rays from random points of the scene box: a third along SUN, a
    third random, a third with a zero y or z component; bf16-rounded."""
    rng = np.random.default_rng(seed)
    lo = frame.dense_chunk_lo.min(dim=0).values.numpy()
    hi = frame.dense_chunk_hi.max(dim=0).values.numpy()
    o = rng.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (n, 3))
    d = rng.normal(size=(n, 3))
    third = n // 3
    d[:third] = SUN + 0.3 * np.concatenate([np.zeros((third, 1)), rng.normal(size=(third, 2))],
                                           axis=1)
    rest = np.arange(2 * third, n)
    d[rest, 1 + rng.integers(0, 2, rest.size)] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return _bf16(o), _bf16(d)


def _first_pass(frame, seed, find_any, q=1):
    """The first pass's lanes of a launch of `_rays` (min_dist 0.01, every
    ninth ray dead, tri ids skipped at random): q = 1, the pair lanes; q =
    4, per live ray its first four candidate groups (-1 past its list).
    -> (Launch, lanes, the number of groups)."""
    o, d = _rays(frame, N_RAYS, seed)
    rng = np.random.default_rng(seed + 100)
    maxd = torch.where(torch.arange(N_RAYS) % 9 == 0, 0.0, 1e5)
    skip = torch.from_numpy(rng.integers(-1, frame.dense_tri.shape[0] // 4, N_RAYS)
                            .astype(np.int32))
    L = W.setup(frame, o, d, BF16, skip, 0.01, maxd, find_any)
    NG = L.lo.shape[0]
    k = min(W.ONESHOT_K, NG)
    cand, _tcut = W.schedule(L.lo, L.hi, L.o, L.d, torch.where(L.live, L.maxd, 0.0),
                             torch.full((N_RAYS,), W.INT32_MIN, dtype=torch.int32), L.id_bits, k)
    if q == 1:
        _pair, lanes = W.pair_lanes(L, None, cand, L.live)
        return L, lanes, NG
    cid = cand[:, :q] & ((1 << L.id_bits) - 1)
    gid = torch.where(cid < NG, cid, -1).to(torch.int32)
    rays = torch.nonzero(L.live)[:, 0]
    return L, W._lanes(L, rays, gid[rays].contiguous()), NG


def _regroup(lanes, s_group):
    """The lanes with their group ids read with s_group chunks a group."""
    gid = lanes[5]
    return lanes[:5] + (torch.where(gid >= 0, gid // s_group, -1).to(torch.int32),)


def _check(lanes, L, s_group, find_any, slices=None, coef=None, tri=None):
    coef = L.coef if coef is None else coef
    tri = L.tri if tri is None else tri
    slices = L.slices if slices is None else slices
    want = W.assigned_test_plain(*lanes, coef, tri, s_group, find_any)
    got = W.assigned_cull_plain(*lanes, coef, tri, slices, s_group, find_any)
    for name, a, b in zip(("t", "row", "pk"), got, want):
        assert torch.equal(a, b), name
    return got, want


@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("s_group", [1, 2])
@pytest.mark.parametrize("find_any", [False, True], ids=["closest", "any"])
def test_emulation_equals_plain(scene, find_any, s_group, q):
    L, lanes, _NG = _first_pass(scene["frame"], 5 + q + s_group, find_any, q)
    lanes = _regroup(lanes, s_group)
    got, want = _check(lanes, L, s_group, find_any)
    c = got[3]
    assert 0.05 < float((want[1] >= 0).float().mean()) < 0.95
    # the counts: entered under the rule <= under the slab test alone; tested
    # slices entered; rows of tested slices only
    assert bool((c[:, 0] <= c[:, 1]).all()) and bool((c[:, 3] <= c[:, 0]).all())
    assert bool((c[:, 4] <= SLICE * c[:, 3]).all())
    sun = lanes[1][:, 0] == 0
    assert int(sun.sum()) > 100 and bool((c[sun, 0] < c[sun, 1]).any())
    assert bool((c[:, 0] < c[:, 1]).sum() > 0)


@pytest.mark.parametrize("find_any", [False, True], ids=["closest", "any"])
def test_accepted_rows_lie_in_entered_slices(scene, find_any):
    """Every (lane, row) the all-row test accepts, over the lane's chunk,
    lies in a slice the lane enters under the zero-axis rule, at t no
    smaller than the slice's entry bound."""
    L, lanes, _NG = _first_pass(scene["frame"], 31, find_any)
    o, d, skip, mind, maxd, gid = lanes
    TI = L.coef.shape[0]
    rows = gid[:, 0:1].long() * CHUNK + torch.arange(CHUNK)[None, :]
    valid = rows < TI
    rc = torch.where(valid, rows, 0)
    cr = L.coef[rc]
    t, _u, _v, geom = m_shift_test([cr[..., i] for i in range(12)], o[:, :, None], d[:, :, None])
    acc = (valid & geom & (t > mind[:, None]) & (t < maxd[:, None]) & (t > 0)
           & (L.tri[rc] != skip[:, None]) & torch.isfinite(t))
    lane, col = torch.nonzero(acc, as_tuple=True)
    assert lane.numel() > 500
    row = rc[lane, col]
    inv = 1.0 / d[lane]
    e, ent, ent_b = W.slice_entry(L.slices[row // SLICE], o[lane], inv, maxd[lane])
    assert bool(ent.all()) and bool(ent_b.all())
    assert bool(zero_axis_inside(L.slices[row // SLICE, :3], L.slices[row // SLICE, 3:], o[lane],
                                 inv).all())
    assert bool((t[lane, col] >= e).all())
    assert int((d[lane] == 0).any(dim=1).sum()) > 100  # zero-axis lanes among them


@pytest.mark.parametrize("s_group", [1, 2])
def test_last_partial_group(scene, s_group):
    """Lanes sent to the last group (its last chunk holds 62 rows) with q =
    1, and with q = 4: the last group, one past the end, the one before
    it, the last again."""
    for find_any in (False, True):
        L, lanes, _NG = _first_pass(scene["frame"], 41, find_any)
        TI = L.coef.shape[0]
        assert TI % CHUNK == 62
        NG = W._n_groups(TI, s_group)
        n = lanes[0].shape[0]
        last = torch.full((n, 1), NG - 1, dtype=torch.int32)
        got, want = _check(lanes[:5] + (last,), L, s_group, find_any)
        assert bool((want[1] >= 0).any())
        four = torch.tensor([NG - 1, NG, max(NG - 2, 0), NG - 1], dtype=torch.int32)
        _check(lanes[:5] + (four.expand(n, 4).contiguous(),), L, s_group, find_any)


def test_keys_tied_across_slices(scene):
    """Closest hit on a table whose winning rows are copied into another
    slice of the same chunk (the copy's plane offset exact, one ulp down or
    up): rows of different slices then tie in their key bucket, and the
    lower local row must win as in the plain version.  Every slice box is
    its chunk's box (`chunk_slices`), which holds the copies."""
    f = scene["frame"]
    L, lanes, _NG = _first_pass(f, 53, False)
    ref = W.assigned_test_plain(*lanes, L.coef, L.tri, 1, False)
    pick = torch.nonzero(ref[1] >= 0)[:, 0]
    row = ref[1][pick].long()
    to = torch.where(row % CHUNK < CHUNK - SLICE, row + SLICE, row - SLICE)
    to = torch.where(to < L.coef.shape[0], to, row - SLICE)
    coef, tri = L.coef.clone(), L.tri.clone()
    copy = coef[row].clone()
    step = torch.arange(pick.numel()) % 3
    e2 = copy[:, 11]
    copy[:, 11] = torch.where(step == 1, torch.nextafter(e2, torch.tensor(-3e38)),
                              torch.where(step == 2, torch.nextafter(e2, torch.tensor(3e38)), e2))
    coef[to] = copy
    tri[to] = L.tri[row]
    c = f.dense_center[None, :]
    boxes = chunk_slices(f.dense_chunk_lo - c, f.dense_chunk_hi - c).contiguous()
    tied = tuple(x[pick] for x in lanes)
    got, want = _check(tied, L, 1, False, slices=boxes, coef=coef, tri=tri)
    moved_earlier = (want[1] // SLICE) < (row // SLICE)
    assert int(moved_earlier.sum()) > 10  # a copy in an earlier slice took the win


@pytest.mark.parametrize("mode", ["oneshot", "rounds"])
@pytest.mark.parametrize("find_any", [False, True], ids=["closest", "any"])
def test_launch_with_culled_lanes(scene, mode, find_any, monkeypatch):
    """A whole launch with the culled loop in K5's place (the slice boxes
    passed by the pair pass and the rounds) equals the plain route."""
    f = scene["frame"]
    o, d = _rays(f, N_RAYS, 61)
    kw = dict(prec=BF16, min_dist=0.01, max_dist=torch.full((N_RAYS,), 30.0),
              find_any=find_any, mode=mode)
    want = W.trace_rays_wavefront(f, o, d, **kw)
    seen = []

    def culled(*a, slices=None, counts=None):
        assert slices is not None and counts is None
        seen.append(a[5].shape[1])
        return W.assigned_cull_plain(*a[:8], slices, *a[8:])[:3]

    monkeypatch.setattr(W, "assigned_test", culled)
    got = W.trace_rays_wavefront(f, o, d, **kw)
    for name, a, b in zip(("t", "u", "v", "tri", "obj"), got, want):
        assert torch.equal(a, b), name
    assert seen and (mode == "oneshot" or W.Q_RANKS in seen)
    assert bool((want[3] >= 0).any()) and bool((want[3] < 0).any())


def test_sun_shadows_against_jax(scene, monkeypatch):
    """The sun's shadow rays (d_x exactly 0) from points of the scene box:
    the port's launch with the culled loop in K5's place against the JAX
    package's wavefront (interpret mode): occlusion agreement > 0.999."""
    f = scene["frame"]
    rng = np.random.default_rng(71)
    lo = f.dense_chunk_lo.min(dim=0).values.numpy()
    hi = f.dense_chunk_hi.max(dim=0).values.numpy()
    n = 1024
    o = np.asarray(_bf16(rng.uniform(lo, hi, (n, 3)) * [1.0, 0.2, 1.0]
                         + [0.0, lo[1] * 0.8 + 0.05, 0.0]))
    d = np.asarray(_bf16(np.broadcast_to(SUN / np.linalg.norm(SUN), (n, 3))))
    maxd = np.full((n,), 1000.0, np.float32)
    hj = JW.trace_rays_wavefront(scene["jscene"], scene["jframe"], jnp.asarray(o), jnp.asarray(d),
                                 prec=scene["prec"], interpret=True, mode="oneshot",
                                 min_dist=0.01, max_dist=jnp.asarray(maxd), find_any=True)
    monkeypatch.setattr(W, "assigned_test", lambda *a, slices=None, counts=None: (
        W.assigned_cull_plain(*a[:8], slices, *a[8:])[:3]))
    ht = W.trace_rays_wavefront(f, torch.from_numpy(o), torch.from_numpy(d), prec=BF16,
                                min_dist=0.01, max_dist=torch.from_numpy(maxd), find_any=True)
    occ_j, occ_t = np.asarray(hj.tri) >= 0, ht[3].numpy() >= 0
    assert (occ_j == occ_t).mean() > 0.999
    assert 0.02 < occ_t.mean() < 0.98
