"""PyTorch port, the per-ray wavefront (`ops/wavefront.py`, the plain
versions of its schedule and of K5) against the JAX package's
`trace_rays_wavefront(..., interpret=True, mode='oneshot')` on the same
bf16 tables, on two scenes: `sponza_like_scene(2, 1)` without sky (the JAX
tests' scene: 370 instance triangles, 3 chunks) and colonnade-83k,
`sponza_like_scene(8, 3)` without sky (82,690 instance triangles in 647
chunks, the JAX package's large-scene configuration).  Rays are made with
numpy from seeds and rounded to bf16 (as the JAX tests make them), so the
lane quantisation is exact on both sides.

Bars (tests/test_wavefront.py, tests/test_dense_pallas.py:145-150): hit
masks equal; tri agreement > 0.999 with obj equal where tri agrees; t, u, v
within rtol/atol 2e-3 where tri agrees; any hit: occlusion agreement >
0.999; dead lanes -1.  Two exceptions, measured on colonnade-83k and
bounded:
- coplanar ties.  The pillars' base faces lie in the floor plane, so a
  bounce ray can meet two triangles at one distance; the JAX package
  breaks such cross-chunk ties by its walk order, the port by candidate
  order (17 of 2,048 bounce lanes).  A lane whose two triangles lie at the
  same float64 distance (1e-5 relative) counts as agreeing; plain tri
  agreement must still exceed 0.99.
- the reference's arithmetic.  The TPU kernel computes u/v/t through a
  bf16x3 product that drops the low bits of each f32 coefficient, which on
  the small sphere triangles misses the exact value of the same triangle
  by up to ~0.03 (11 of 1,350 primary hits).  Where the reference is off
  the float64 value of the same table row by more than the bar, the port is
  held to the float64 value instead; such lanes must stay below 1.5%.

Also: the port against the float64 brute-force oracle (`tests/oracle.py`,
the bars of tests/test_wavefront.py:220-249); `schedule_plain` against the
JAX `_schedule` (words and tcut equal); and the whole launch against an
all-pairs reference of the packed semantics on the same quantised rays, bit
for bit: the schedule and the tail passes never cut a hit."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import get_precision as jax_precision
from low_precision_raytracer_tpu.models.hierarchy import build_flat_scene
from low_precision_raytracer_tpu.models.procedural import sponza_like_scene as jax_sponza
from low_precision_raytracer_tpu.models.scene import build_scene_arrays, flatten_frame
from low_precision_raytracer_tpu.ops import wavefront as JW
from low_precision_raytracer_tpu.ops.camera import primary_ray_grid
from low_precision_raytracer_tpu_torch.config import get_precision
from low_precision_raytracer_tpu_torch.models import scene as tscene
from low_precision_raytracer_tpu_torch.ops import wavefront as W
from low_precision_raytracer_tpu_torch.ops.dense_trace import (
    CHUNK,
    dense_trace_multi_plain,
    ray_aabb_entry,
    tri_quantities,
)

H, Wd = 16, 128
R = H * Wd
BF16 = get_precision("bf16")
SCENES = {"colonnade-370": (2, 1), "colonnade-83k": (8, 3)}


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module", params=list(SCENES))
def setup(request):
    host = jax_sponza(*SCENES[request.param], with_skybox=False)
    prec = jax_precision("bf16")
    scene = build_scene_arrays(host, prec)
    frame = flatten_frame(host, prec, max_direct_lights=4, width=Wd, height=H)
    frame_np = {k: np.asarray(getattr(frame, k)) for k in tscene.tensor_fields(tscene.FrameInput)}
    frame_np.update(obj_layout=frame.obj_layout, n_lights=frame.n_lights,
                    dense_morton=frame.dense_morton)
    scene_np = {k: np.asarray(getattr(scene, k)) for k in tscene.tensor_fields(tscene.SceneArrays)}
    scene_np.update(n_meshes=scene.n_meshes, sky_valid=scene.sky_valid)
    _s, tframe = tscene.scene_from_numpy(scene_np, frame_np, "cpu")
    o, d = primary_ray_grid(frame.cam_l2w_f32, frame.cam_fov_y_f32, Wd, H, jnp.float32)
    perm = np.random.default_rng(3).permutation(R)  # scrambled: no screen coherence
    c = dict(name=request.param, host=host, prec=prec, scene=scene, frame=frame,
             tframe=tframe, o=_bf16(np.asarray(o).reshape(-1, 3)[perm]),
             d=_bf16(np.asarray(d).reshape(-1, 3)[perm]))
    c["primary"] = _both(c, c["o"], c["d"])
    return c


def _both(c, o, d, **kw):
    """One launch through both packages' wavefront.  -> (jax, port) hit
    records as numpy dicts."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    hj = JW.trace_rays_wavefront(c["scene"], c["frame"], jnp.asarray(o), jnp.asarray(d),
                                 prec=c["prec"], interpret=True, mode="oneshot", **jkw)
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ht = W.trace_rays_wavefront(c["tframe"], torch.from_numpy(o), torch.from_numpy(d),
                                prec=BF16, **tkw)
    names = ("t", "u", "v", "tri", "obj")
    return ({k: np.asarray(getattr(hj, k)) for k in names},
            {k: x.numpy() for k, x in zip(names, ht)})


def _exact(c, o, d, tri, obj):
    """float64 t, u, v of each hit's table row (found by (obj, tri)) for the
    bf16-rounded rays: the table's exact arithmetic."""
    tf = c["tframe"]
    rows_key = tf.dense_obj.numpy().astype(np.int64) << 20 | tf.dense_tri.numpy()
    order = np.argsort(rows_key)
    row = order[np.searchsorted(rows_key[order], obj.astype(np.int64) << 20 | tri)]
    n = tf.dense_n_f32.numpy().astype(np.float64).reshape(-1, 9)[row]
    e = tf.dense_e.numpy().astype(np.float64)[row]
    oc = o.astype(np.float64) - tf.dense_center.numpy().astype(np.float64)
    dd = d.astype(np.float64)
    M = n.reshape(-1, 3, 3)
    Oxyz = np.einsum("rij,rj->ri", M, oc) + e
    Dxyz = np.einsum("rij,rj->ri", M, dd)
    t = -Oxyz[:, 2] / Dxyz[:, 2]
    return t, Oxyz[:, 0] + t * Dxyz[:, 0], Oxyz[:, 1] + t * Dxyz[:, 1]


def _close(a, b):
    return np.abs(a - b) <= 2e-3 + 2e-3 * np.abs(b)


def _check_closest(c, j, t, o, d, live=None):
    np.testing.assert_array_equal(j["tri"] >= 0, t["tri"] >= 0)
    same = j["tri"] == t["tri"]
    # coplanar ties: two triangles at one float64 distance (a pillar's base
    # on the floor), which the packages' candidate orders break either way
    diff = ~same & (t["tri"] >= 0)
    t_j = _exact(c, o[diff], d[diff], j["tri"][diff], j["obj"][diff])[0]
    t_p = _exact(c, o[diff], d[diff], t["tri"][diff], t["obj"][diff])[0]
    tie = np.zeros_like(same)
    tie[diff] = np.abs(t_j - t_p) <= 1e-5 * np.maximum(1.0, np.abs(t_p))
    assert same.mean() > 0.99 and (same | tie).mean() > 0.999, \
        f"tri agreement {same.mean()}, with ties {(same | tie).mean()}"
    np.testing.assert_array_equal(j["obj"][same], t["obj"][same])
    hit = same & (t["tri"] >= 0)
    ex = _exact(c, o[hit], d[hit], t["tri"][hit], t["obj"][hit])
    ref_ok = np.ones(int(hit.sum()), bool)
    for k, x in zip(("t", "u", "v"), ex):
        assert _close(t[k][hit], x).all(), f"{k}: port off the float64 value"
        ref_ok &= _close(j[k][hit], x)
    assert (~ref_ok).sum() <= 0.015 * hit.sum(), f"reference off on {(~ref_ok).sum()} hits"
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(t[k][hit][ref_ok], j[k][hit][ref_ok], rtol=2e-3, atol=2e-3,
                                   err_msg=k)
    if live is not None:
        for r in (j, t):
            np.testing.assert_array_equal(r["tri"][~live], -1)


def _bounce(c, seed, dead_share=0.1):
    """Hemisphere-scattered rays from the primary hits (the production
    incoherent launch shape), bf16-rounded; dead lanes where the primary
    missed and at random."""
    rng = np.random.default_rng(seed)
    j0, _ = c["primary"]
    live = (j0["tri"] >= 0) & (rng.random(R) > dead_share)
    p = _bf16(c["o"] + np.where(j0["tri"] >= 0, j0["t"], 0)[:, None] * c["d"])
    b = rng.normal(size=(R, 3))
    b = _bf16(b / np.linalg.norm(b, axis=1, keepdims=True))
    maxd = np.where(live, 1e5, 0.0).astype(np.float32)
    return p, b, maxd, live


def test_primary_scrambled(setup):
    j, t = setup["primary"]
    _check_closest(setup, j, t, setup["o"], setup["d"])
    assert 0.1 < (t["tri"] >= 0).mean() < 0.95


def _bounce_launch(c):
    """The bounce launch (seed 7) through both packages, once per scene;
    -> (rays (p, b, maxd, live), (jax, port))."""
    if "bounce" not in c:
        p, b, maxd, live = _bounce(c, 7)
        c["bounce"] = (p, b, maxd, live), _both(c, p, b, min_dist=0.1, max_dist=maxd)
    return c["bounce"]


def test_bounce(setup):
    """Per-lane maxd with dead lanes, min_dist 0.1 (the bounce epsilon)."""
    (p, b, maxd, live), (j, t) = _bounce_launch(setup)
    _check_closest(setup, j, t, p, b, live)
    assert (t["tri"][live] >= 0).mean() > 0.2


def test_find_any(setup):
    p, b, maxd, live = _bounce(setup, 11)
    maxd = np.minimum(maxd, 6.0).astype(np.float32)
    j, t = _both(setup, p, b, min_dist=0.1, max_dist=maxd, find_any=True)
    occ_j, occ_t = j["tri"] >= 0, t["tri"] >= 0
    assert (occ_j == occ_t).mean() > 0.999
    for r in (j, t):
        np.testing.assert_array_equal(r["tri"][~live], -1)
    assert 0.05 < occ_t[live].mean() < 0.95


def test_skip_tri(setup):
    """Re-trace from the primary hits along the primary directions with
    the hit triangle skipped: no lane re-hits it at zero distance, and the
    two packages agree."""
    c = setup
    j0, _ = c["primary"]
    live = j0["tri"] >= 0
    p = _bf16(c["o"] + np.where(live, j0["t"], 0)[:, None] * c["d"])
    skip = np.where(live, j0["tri"], -1).astype(np.int32)
    maxd = np.where(live, 1e5, 0.0).astype(np.float32)
    j, t = _both(c, p, c["d"], skip_tri=skip, max_dist=maxd)
    _check_closest(c, j, t, p, c["d"], live)
    assert not ((t["tri"] == skip) & (t["t"] < 1e-3) & live).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_rays(setup, seed):
    """Origins inside and outside the scene box, random directions and
    per-lane reach."""
    c = setup
    rng = np.random.default_rng(100 + seed)
    lo = np.asarray(c["frame"].obj_aabb_lo).min(0)
    hi = np.asarray(c["frame"].obj_aabb_hi).max(0)
    span = hi - lo
    o = _bf16(lo - 0.5 * span + rng.random((R, 3)) * 2.0 * span)
    d = rng.normal(size=(R, 3))
    d = _bf16(d / np.linalg.norm(d, axis=1, keepdims=True))
    maxd = (rng.random(R) * 30.0).astype(np.float32)
    j, t = _both(c, o, d, max_dist=maxd)
    _check_closest(c, j, t, o, d)


def test_starved_first_pass(setup, monkeypatch):
    """Two candidates in the first pass: most rays resolve in the tail
    passes, and the result still meets the bars against the JAX launch
    (test_bounce's rays and reference)."""
    c = setup
    (p, b, maxd, live), (j, _t) = _bounce_launch(c)
    passes = []
    pair_pass = W.pair_pass
    monkeypatch.setattr(W, "ONESHOT_K", 2)
    monkeypatch.setattr(W, "pair_pass", lambda L, sel, *a: passes.append(sel) or pair_pass(L, sel, *a))
    ht = W.trace_rays_wavefront(c["tframe"], torch.from_numpy(p), torch.from_numpy(b),
                                prec=BF16, min_dist=0.1, max_dist=torch.from_numpy(maxd))
    t = {k: x.numpy() for k, x in zip(("t", "u", "v", "tri", "obj"), ht)}
    _check_closest(c, j, t, p, b, live)
    assert len(passes) >= 2 and passes[1].numel() > 0


def test_matches_fp64_oracle(setup):
    """The float64 brute-force oracle on scrambled primary rays
    (tests/test_wavefront.py:220-249's bars)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from oracle import brute_force_trace

    c = setup
    n = 512 if c["name"] == "colonnade-83k" else R
    _, t = c["primary"]
    flat = build_flat_scene(c["host"].root, c["host"].active_camera)
    want = brute_force_trace(flat, c["host"].meshes, c["o"][:n].astype(np.float64),
                             c["d"][:n].astype(np.float64))
    got_hit = t["tri"][:n] >= 0
    assert (got_hit == want["hit"]).mean() > 0.995
    both = got_hit & want["hit"]
    same = t["tri"][:n][both] == want["tri"][both]
    assert same.mean() > 0.98
    t_err = np.abs(t["t"][:n][both][same] - want["t"][both][same])
    assert np.quantile(t_err, 0.95) < 0.03


@pytest.mark.parametrize("k", [8, 16, 128])
def test_schedule_matches_jax(setup, k):
    """Words and tcut equal the JAX `_schedule`'s, from the start (k=8) and
    from a cursor inside the lists (k=16, 128)."""
    c = setup
    p, b, maxd, _live = _bounce(c, 13, dead_share=0.3)
    lo, hi = np.asarray(c["frame"].dense_chunk_lo), np.asarray(c["frame"].dense_chunk_hi)
    NG = lo.shape[0]
    id_bits = max(2, NG.bit_length())
    k = min(k, NG)
    tt = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    args = (tt(lo), tt(hi), tt(p), tt(b), tt(maxd))
    wmin = np.full(R, W.INT32_MIN, np.int32)
    if k > 8:  # a cursor: each ray's third candidate word
        first, _ = W.schedule_plain(*args, tt(wmin), id_bits, 3)
        wmin = first[:, 2].numpy()
    cand, tcut = W.schedule_plain(*args, tt(wmin), id_bits, k)
    cj, tj = JW._schedule(*(jnp.asarray(x) for x in (lo, hi, p, b, maxd)), NG, id_bits, k,
                          wmin=jnp.asarray(wmin))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(tcut.numpy(), np.asarray(tj))
    sent = W._sentinel(id_bits)
    assert (cand[:, 0] < sent).float().mean() > 0.05 and (cand[:, -1] == sent).any()


def _all_pairs_packed(L, slab=64):
    """Every ray against every chunk with K5's in-chunk rule (least key
    (t_bits & ~127) | local row), then the first minimum t over the chunks
    in packed-word order (chunks the ray's segment does not enter last) —
    no schedule, no passes.  -> (t, u, v, tri, obj)."""
    TI = L.coef.shape[0]
    NC = -(-TI // CHUNK)
    id_mask = (1 << L.id_bits) - 1
    outs = []
    for r0 in range(0, L.o.shape[0], slab):
        sl = slice(r0, r0 + slab)
        n = L.o[sl].shape[0]
        t, u, v, geom = tri_quantities(L.coef, L.o_q[sl], L.d_q[sl])
        acc = (geom & (t > L.mind[sl, None]) & (t < L.maxd[sl, None]) & (t > 0)
               & (L.tri[None, :] != L.skip[sl, None]) & torch.isfinite(t) & L.live[sl, None])
        local = torch.arange(TI, dtype=torch.int32) % CHUNK
        key = torch.where(acc, (t.view(torch.int32) & ~(CHUNK - 1)) | local, W.INT32_MAX)
        pad = lambda x, val: torch.nn.functional.pad(x, (0, NC * CHUNK - TI), value=val)
        key = pad(key, W.INT32_MAX).reshape(n, NC, CHUNK)
        j = key.argmin(dim=2)  # (n, NC) local winner
        row = torch.arange(NC)[None, :] * CHUNK + j
        got = key.gather(2, j[..., None])[..., 0] != W.INT32_MAX
        rowc = row.clamp(max=TI - 1)
        t_c = torch.where(got, t.gather(1, rowc), float("inf"))
        entry, ok = ray_aabb_entry(L.lo, L.hi, L.o[sl], L.d[sl], L.maxd[sl])
        words = torch.where(ok, (entry.view(torch.int32) & ~id_mask) | torch.arange(NC, dtype=torch.int32),
                            W.INT32_MAX)
        order = torch.sort(words, dim=1, stable=True).indices
        w = t_c.gather(1, order).argmin(dim=1, keepdim=True)
        win = order.gather(1, w)[:, 0]
        bt = t_c.gather(1, win[:, None])[:, 0]
        brow = rowc.gather(1, win[:, None])[:, 0]
        hit = torch.isfinite(bt)
        uw, vw = u.gather(1, brow[:, None])[:, 0], v.gather(1, brow[:, None])[:, 0]
        qu = torch.clamp((uw + 0.5) * 16384.0, 0.0, 32767.0).to(torch.int32)
        qv = torch.clamp((vw + 0.5) * 16384.0, 0.0, 32767.0).to(torch.int32)
        neg = torch.full((n,), -1, dtype=torch.int32)
        outs.append((torch.where(hit, bt, 1e5),
                     torch.where(hit, qu.float() / 16384.0 - 0.5, 0.0),
                     torch.where(hit, qv.float() / 16384.0 - 0.5, 0.0),
                     torch.where(hit, L.tri[brow], neg), torch.where(hit, L.obj[brow], neg)))
    return tuple(torch.cat(x) for x in zip(*outs))


@pytest.mark.parametrize("k", [8, 2], ids=["oneshot_k8", "starved_k2"])
def test_equals_all_pairs_packed(setup, k, monkeypatch):
    """Bit for bit: closest hit against the all-pairs packed reference,
    any hit's occlusion against the all-pairs any hit (K1b's plain
    version), on bounce-shaped launches."""
    c = setup
    monkeypatch.setattr(W, "ONESHOT_K", k)
    p, b, maxd, _live = _bounce(c, 21)
    o, d = torch.from_numpy(p), torch.from_numpy(b)
    mx = torch.from_numpy(maxd)
    got = W.trace_rays_wavefront(c["tframe"], o, d, prec=BF16, min_dist=0.1, max_dist=mx)
    L = W.setup(c["tframe"], o, d, BF16, None, 0.1, mx, False)
    want = _all_pairs_packed(L)
    for name, a, e in zip(("t", "u", "v", "tri", "obj"), got, want):
        assert torch.equal(a, e), name
    occ = W.trace_rays_wavefront(c["tframe"], o, d, prec=BF16, min_dist=0.1,
                                 max_dist=torch.clamp(mx, max=6.0), find_any=True)[3]
    L = W.setup(c["tframe"], o, d, BF16, None, 0.1, torch.clamp(mx, max=6.0), True)
    ref = dense_trace_multi_plain(L.o_q, L.d_q, L.skip, L.mind, L.maxd, L.coef, L.tri, L.obj,
                                  find_any=True)[3]
    assert torch.equal(occ >= 0, ref >= 0)
    assert (got[3] >= 0).any() and (occ >= 0).any() and (occ < 0).any()


def test_pair_lanes_sorted_and_tested(setup):
    """`assigned_test` on CPU tensors is its plain version; the pair lanes
    of one pass (the live pairs only, sorted by group) go through it, and
    an any-hit lane stops at its first accepted row (a blocker of the
    lane's own group)."""
    c = setup
    p, b, maxd, _live = _bounce(c, 31)
    L = W.setup(c["tframe"], torch.from_numpy(p), torch.from_numpy(b), BF16, None, 0.1,
                torch.from_numpy(maxd), True)
    NG = L.lo.shape[0]
    k = min(W.ONESHOT_K, NG)
    cand, _tcut = W.schedule(L.lo, L.hi, L.o, L.d, torch.where(L.live, L.maxd, 0.0),
                             torch.full((R,), W.INT32_MIN, dtype=torch.int32), L.id_bits, k)
    pair, lanes = W.pair_lanes(L, None, cand, L.live)
    gid = lanes[-1][:, 0]
    assert bool((gid[1:] >= gid[:-1]).all())  # sorted by group
    pid = cand & ((1 << L.id_bits) - 1)
    live_pairs = (pid < NG) & L.live[:, None]
    assert gid.numel() == int(live_pairs.sum()) and bool(live_pairs.reshape(-1)[pair].all())
    assert torch.equal(gid, pid.reshape(-1)[pair])
    t, row, pk = W.assigned_test(*lanes, L.coef, L.tri, L.s_group, True)
    hit = row >= 0
    assert bool(hit.any()) and bool((row[hit] // CHUNK == gid[hit]).all())
    assert bool((pk[hit] >= 0).all()) and bool((pk[~hit] == -1).all())
    assert bool((t[~hit] == 1e5).all())
