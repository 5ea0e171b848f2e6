"""PyTorch port, the wavefront schedule kernel's tree walk
(`csrc/wavefront.cu:schedule_kernel`) emulated ray by ray on the CPU, and
the tree it walks (`ops/wavefront.py:group_tree`, `group_tables`).

The kernel walks a 4-ary tree of union boxes over the group boxes, nearest
entry first, and culls a subtree when the segment does not enter its box
(with some finite axis) or when the masked entry bits of its box are at or
above the 17th word held; the words come 17 at a time, each batch walking
the tree again above the last word written.  The emulation follows the
kernel step by step (the same slab test, `ray_aabb_entry`'s arithmetic,
the same child order and stack, the same culls) and counts the boxes it
tests.  Held:
- bit for bit against `schedule_plain` (the flat scan), for k = 8, 16, 32
  and 64, from the start and from a cursor `wmin` inside the lists, on
  colonnade-5k's group boxes (`sponza_like_scene(4, 2)`: 42 groups, a
  4-level tree) with bounce-shaped rays, dead rays and rays with planted
  +-0 direction components on each axis;
- against the JAX `_schedule` (words and tcut equal) on the same rays, as
  tests/test_torch_wavefront.py holds `schedule_plain`;
- on 300 random group boxes (a 6-level tree) with zero-axis rays;
- a case where whole subtrees lie beyond the 17th word: groups along a
  line, the rays along it; the walk tests none of the far groups and still
  equals the flat scan."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import get_precision as jax_precision
from low_precision_raytracer_tpu.models.procedural import sponza_like_scene as jax_sponza
from low_precision_raytracer_tpu.models.scene import flatten_frame
from low_precision_raytracer_tpu.ops import wavefront as JW
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models.procedural import sponza_like_scene
from low_precision_raytracer_tpu_torch.ops import wavefront as W
from low_precision_raytracer_tpu_torch.render.renderer import Renderer

LIST = 17  # csrc/wavefront.cu:LPRT_LIST
N_RAYS = 256


def _slab(boxes, o, d, maxd):
    """The kernel's box_entry of every ray against every box: -> (entry
    (R, N) f32, ok (R, N), fin (R, N): some axis had finite slab
    distances)."""
    inv = 1.0 / d
    t1 = (boxes[None, :, :3] - o[:, None]) * inv[:, None]
    t2 = (boxes[None, :, 3:] - o[:, None]) * inv[:, None]
    a, b = torch.minimum(t1, t2), torch.maximum(t1, t2)
    fa = torch.isfinite(t1) & torch.isfinite(t2)
    tmin = torch.where(fa, a, -3e38).amax(dim=-1)
    tmax = torch.where(fa, b, 3e38).amin(dim=-1)
    e = torch.clamp(tmin - 0.02, min=0.0)
    fin = fa.any(dim=-1)
    ok = fin & (tmin <= tmax + 0.02) & (tmax + 0.02 >= 0) & (e < maxd[:, None])
    return e, ok, fin


def tree_schedule(tree, o, d, maxd, wmin, id_bits, k):
    """The kernel's walk, ray by ray: -> (cand (R, k), tcut (R,), boxes
    tested per ray (R,), the groups whose words were computed per ray)."""
    R = o.shape[0]
    L = len(tree.sizes)
    offs = [sum(tree.sizes[lvl + 1:]) for lvl in range(L)]
    id_mask = (1 << id_bits) - 1
    sent = W._sentinel(id_bits)
    e, ok, fin = _slab(tree.boxes, o, d, maxd)
    E = (e.view(torch.int32) & ~id_mask).tolist()
    ok, fin = ok.tolist(), fin.tolist()
    cand = torch.full((R, k), sent, dtype=torch.int32)
    tcut = torch.full((R,), sent, dtype=torch.int32)
    tests = [0] * R
    seen = [set() for _ in range(R)]
    for r in range(R):
        if not float(maxd[r]) > 0:
            continue
        wm = int(wmin[r])

        def word(g):
            tests[r] += 1
            seen[r].add(g)
            i = offs[0] + g
            if not ok[r][i]:
                return sent
            w = E[r][i] | g
            return w if (w < sent and w >= wm) else sent

        def node(lvl, i):
            tests[r] += 1
            j = offs[lvl] + i
            return ok[r][j] or not fin[r][j], E[r][j]

        out = []
        last = -1
        for _j0 in range(0, k + 1, LIST):
            a = [sent] * LIST
            if last != sent:
                st = []
                if L == 1:
                    w = word(0)
                    if w > last:
                        a = sorted(a + [w])[:LIST]
                else:
                    enter, e0 = node(L - 1, 0)
                    if enter:
                        st.append((L - 1, 0, e0))
                while st:
                    lvl, idx, en = st.pop()
                    if en >= a[-1]:
                        continue
                    cl = lvl - 1
                    kids = range(4 * idx, min(4 * idx + 4, tree.sizes[cl]))
                    if cl == 0:
                        for g in kids:
                            w = word(g)
                            if w <= last or w >= a[-1]:
                                continue
                            a = sorted(a + [w])[:LIST]
                        continue
                    ce = []  # descending by entry, equal entries in child order
                    for ch in kids:
                        enter, ec = node(cl, ch)
                        if not enter or ec >= a[-1]:
                            continue
                        j = len(ce)
                        while j > 0 and ce[j - 1][0] < ec:
                            j -= 1
                        ce.insert(j, (ec, ch))
                    st += [(cl, ch, ec) for ec, ch in ce]
            out += a
            last = a[-1]
        cand[r] = torch.tensor(out[:k], dtype=torch.int32)
        tcut[r] = out[k]
    return cand, tcut, torch.tensor(tests), seen


def _check(tree, lo, hi, o, d, maxd, wmin, id_bits, k):
    got_c, got_t, tests, _seen = tree_schedule(tree, o, d, maxd, wmin, id_bits, k)
    want_c, want_t = W.schedule_plain(lo, hi, o, d, maxd, wmin, id_bits, k)
    assert torch.equal(got_c, want_c)
    assert torch.equal(got_t, want_t)
    return want_c, tests


@pytest.fixture(scope="module")
def colonnade():
    """colonnade-5k's group boxes (the port's frame) and bounce-shaped
    rays: origins on the scene's surfaces' bounding box, random
    directions, +-0 components planted on each axis, 20% dead."""
    r = Renderer(sponza_like_scene(4, 2), RenderConfig(width=16, height=16, precision="bf16"),
                 device="cpu")
    lo, hi, s_group, id_bits, tree = W.group_tables(r.frame)
    rng = np.random.default_rng(21)
    base, span = lo.min(0).values.numpy(), (hi.max(0).values - lo.min(0).values).numpy()
    o = base + rng.random((N_RAYS, 3)) * span
    d = rng.standard_normal((N_RAYS, 3))
    d[0::5, 0] = 0.0
    d[1::7, 1] = -0.0
    d[2::9, 2] = 0.0
    d[3::11, :2] = 0.0
    d[~d.any(axis=1), 2] = 1.0  # no all-zero direction
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[1::7, 1] = -0.0  # keep the sign of the planted -0 through the division
    maxd = np.where(rng.random(N_RAYS) < 0.2, 0.0, 1 + 60 * rng.random(N_RAYS))
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    return dict(lo=lo, hi=hi, tree=tree, id_bits=id_bits, s_group=s_group,
                rays=(f32(o), f32(d), f32(maxd)))


def test_group_tables(colonnade):
    """The groups are colonnade-5k's 42 chunk boxes (s_group 1), and the
    tree's leaves are the group boxes in group order, each level the exact
    union of four nodes below it."""
    lo, hi, tree = colonnade["lo"], colonnade["hi"], colonnade["tree"]
    assert colonnade["s_group"] == 1 and lo.shape[0] == 42
    assert tree.sizes == (42, 11, 3, 1) and tree.leaf == 1
    L = len(tree.sizes)
    offs = [sum(tree.sizes[lvl + 1:]) for lvl in range(L)]
    assert tree.levels.tolist() == offs + list(tree.sizes)
    assert torch.equal(tree.boxes[offs[0]:], torch.cat([lo, hi], dim=1))
    for lvl in range(1, L):
        for i in range(tree.sizes[lvl]):
            kids = tree.boxes[offs[lvl - 1] + 4 * i:offs[lvl - 1] + min(4 * i + 4,
                                                                        tree.sizes[lvl - 1])]
            box = tree.boxes[offs[lvl] + i]
            assert torch.equal(box[:3], kids[:, :3].amin(0))
            assert torch.equal(box[3:], kids[:, 3:].amax(0))


@pytest.mark.parametrize("k", [8, 16, 32, 64])
def test_tree_walk_equals_plain(colonnade, k):
    """From the start, and from each ray's third word (the tail passes'
    cursor); the walk tests fewer boxes than the flat scan's NG a batch."""
    c = colonnade
    o, d, maxd = c["rays"]
    NG = c["lo"].shape[0]
    wmin = torch.full((N_RAYS,), W.INT32_MIN, dtype=torch.int32)
    first, tests = _check(c["tree"], c["lo"], c["hi"], o, d, maxd, wmin, c["id_bits"], k)
    sent = W._sentinel(c["id_bits"])
    assert (first[:, 0] < sent).float().mean() > 0.5
    live = maxd > 0
    batches = k // LIST + 1
    assert float(tests[live].float().mean()) < NG * batches
    cursor = torch.where(first[:, 2] < sent, first[:, 2], W.INT32_MIN)
    _check(c["tree"], c["lo"], c["hi"], o, d, maxd, cursor.contiguous(), c["id_bits"], k)


@pytest.mark.parametrize("k", [8, 32])
def test_tree_walk_matches_jax_schedule(colonnade, k):
    """The words and tcut of the walk equal the JAX `_schedule`'s on the
    JAX package's own colonnade-5k frame (the same group boxes)."""
    c = colonnade
    frame = flatten_frame(jax_sponza(4, 2), jax_precision("bf16"), max_direct_lights=4,
                          width=16, height=16)
    lo, hi = np.asarray(frame.dense_chunk_lo), np.asarray(frame.dense_chunk_hi)
    assert np.array_equal(lo, c["lo"].numpy()) and np.array_equal(hi, c["hi"].numpy())
    o, d, maxd = c["rays"]
    NG = lo.shape[0]
    wmin = torch.full((N_RAYS,), W.INT32_MIN, dtype=torch.int32)
    got_c, got_t, _tests, _seen = tree_schedule(c["tree"], o, d, maxd, wmin, c["id_bits"], k)
    cj, tj = JW._schedule(*(jnp.asarray(x.numpy()) for x in (c["lo"], c["hi"], o, d, maxd)), NG,
                          c["id_bits"], k, wmin=jnp.asarray(wmin.numpy()))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(tj))


def test_random_boxes_zero_axis_rays():
    """300 random group boxes (a 6-level tree), rays with +-0 components
    on each axis and on two axes at once, k = 32 from a cursor."""
    rng = np.random.default_rng(5)
    NG = 300
    c = rng.random((NG, 3)) * 20 - 10
    ext = rng.random((NG, 3)) * 1.5
    lo = torch.tensor(c - ext, dtype=torch.float32)
    hi = torch.tensor(c + ext, dtype=torch.float32)
    tree = W.group_tree(lo, hi)
    assert len(tree.sizes) == 6
    n = 160
    o = rng.random((n, 3)) * 24 - 12
    # every sixth origin exactly on a box's low x face, its ray in that plane
    o[::6, 0] = (c - ext)[rng.integers(0, NG, len(o[::6])), 0]
    d = rng.standard_normal((n, 3))
    d[::3, 0] = 0.0
    d[1::3, 2] = 0.0
    d[2::8, :2] = 0.0
    d[::6, 0] = 0.0
    d[~d.any(axis=1), 1] = 1.0  # no all-zero direction
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    o, d, maxd = f32(o), f32(d), f32(np.full(n, 40.0))
    assert bool((torch.isinf(1.0 / d)).any(dim=1).float().mean() > 0.5)
    id_bits = max(2, NG.bit_length())
    start = torch.full((n,), W.INT32_MIN, dtype=torch.int32)
    first, tests = _check(tree, lo, hi, o, d, maxd, start, id_bits, 32)
    assert float(tests.float().mean()) < NG * 2
    sent = W._sentinel(id_bits)
    cursor = torch.where(first[:, 5] < sent, first[:, 5], W.INT32_MIN).contiguous()
    _check(tree, lo, hi, o, d, maxd, cursor, id_bits, 32)


def test_far_subtrees_culled():
    """64 unit boxes along x, 3 apart, and rays along +x from before the
    first: every ray enters every box, the 17 nearest are the first 17, and
    the subtrees of the last 32 boxes lie wholly beyond the 17th word, so
    the walk tests none of their groups (the flat scan tests all 64) and
    still gives the flat scan's words."""
    NG = 64
    x = np.arange(NG, dtype=np.float32) * 3
    lo = torch.tensor(np.stack([x, np.zeros(NG), np.zeros(NG)], 1), dtype=torch.float32)
    hi = lo + 1.0
    tree = W.group_tree(lo, hi)
    n = 8
    rng = np.random.default_rng(2)
    o = torch.tensor(np.stack([np.full(n, -5.0), 0.2 + 0.6 * rng.random(n),
                               0.2 + 0.6 * rng.random(n)], 1), dtype=torch.float32)
    d = torch.tensor([[1.0, 0.0, 0.0]] * n, dtype=torch.float32)
    maxd = torch.full((n,), 1e3)
    id_bits = max(2, NG.bit_length())
    wmin = torch.full((n,), W.INT32_MIN, dtype=torch.int32)
    got_c, got_t, tests, seen = tree_schedule(tree, o, d, maxd, wmin, id_bits, 8)
    want_c, want_t = W.schedule_plain(lo, hi, o, d, maxd, wmin, id_bits, 8)
    assert torch.equal(got_c, want_c) and torch.equal(got_t, want_t)
    assert torch.equal(want_c[0] & ((1 << id_bits) - 1), torch.arange(8, dtype=torch.int32))
    for s in seen:
        assert max(s) < 32
    assert int(tests.max()) < NG
