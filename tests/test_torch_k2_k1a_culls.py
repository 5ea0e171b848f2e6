"""PyTorch port, the loops of K2 (`csrc/svgf.cu:coef_fetch_kernel`) and K1a
(`csrc/dense_trace.cu:dense_trace_kernel`) emulated in plain PyTorch
against the plain versions they must equal bit for bit.

K2 (`ops/svgf_kernels.py:coef_fetch_tiles_plain`): on the 64 x 16 tiles
whose staged history window is finite (`fetch_full_tiles`) each pixel sums
only the four views its residual selects, elsewhere all 16.  Inputs made
with numpy from seeds at 128x128, 61x97 and 29x7: residuals in {-1, 0, 1}
(some -0) with some outside the window, weights with -0, NaN and +Inf,
count 0 on a third of the pixels, global motions of both signs that wrap,
NaN, +-Inf and -0 history taps in a few tiles.  Held bit for bit against
`coef_fetch_plain` (NaN at the same places, every other value's bits
equal); without the gate the NaN positions differ; and through
`fetch_weighted_packed` against the JAX fetch (`coef_fetch_pallas` in
interpret mode) at tests/test_torch_svgf_kernels.py's bar.

K1a (`ops/dense_trace.py:dense_trace_cull_plain`): each (ray, row) first
through the sign and range culls (`k1a_cull`, with `__fmul_ru` emulated
by `mul_ru`), the survivors through the test; on the port's Cornell tables
in every form K1a runs ('mxu3' bf16 and fp16, the f32 'both' band, 'both'
and 'dtype' in bf16 and fp16, fp32 'dtype'), closest hit with the fused
shadow phase and, below fp32, the packed epilogue; on the table and on the
table doubled (exact ties in t, the smaller id later); on primary rays, a
bounce-shaped launch and the adversarial lanes of `k1a_edge_rays` (zero
direction components, origins with Oz exactly 0, mind < 0, dead lanes,
rays up through the floor under the tall box).  Held bit for bit against
`dense_trace_plain`; and in K1a's place on the route against the JAX
package's `trace_rays_dense_pallas` (interpret mode) at
tests/test_torch_dense_trace.py's bars."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from fractions import Fraction

from low_precision_raytracer_tpu.ops.reproject import (
    fetch_weighted_packed as jax_fetch_weighted_packed,
)
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene
from low_precision_raytracer_tpu_torch.models.scene import flatten_frame
from low_precision_raytracer_tpu_torch.ops import reproject
from low_precision_raytracer_tpu_torch.ops import trace as T
from low_precision_raytracer_tpu_torch.ops.camera import primary_ray_grid
from low_precision_raytracer_tpu_torch.ops.dense_trace import (
    dense_trace_cull_plain,
    dense_trace_plain,
    k1a_edge_rays,
    k1a_lane_order,
    mul_ru,
    next_up,
    tri_quantities,
)
from low_precision_raytracer_tpu_torch.ops.svgf_kernels import (
    FETCH_TILE,
    coef_fetch_plain,
    coef_fetch_tiles_plain,
    fetch_full_tiles,
)
from test_torch_dense_trace import _both, _check, cornell  # noqa: F401  (a fixture)
from test_torch_svgf_kernels import _close, _crop

f32 = torch.float32


def _bits_equal(a, b, what):
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    assert torch.equal(nan_a, nan_b), f"{what}: NaN positions differ"
    diff = (a.view(torch.int32) != b.view(torch.int32)) & ~nan_a
    assert not bool(diff.any()), f"{what}: {int(diff.sum())} values differ in bits"


# ---------------------------------------------------------------------------
# K2


def _fetch_inputs(H, W, seed, C=10):
    rng = np.random.default_rng(seed)
    hist = (rng.random((C, H, W), dtype=np.float32) * 4 - 2).astype(np.float32)
    hist[rng.random((C, H, W)) < 0.05] = -0.0
    for val in (np.nan, np.inf, -np.inf):  # a few taps in a few places
        hist[rng.integers(C), rng.integers(H), rng.integers(W)] = val
    res = (rng.integers(-1, 2, (2, H, W))).astype(np.float32)
    res[rng.random((2, H, W)) < 0.05] = -0.0
    odd = rng.random((2, H, W)) < 0.03
    res[odd] = rng.choice(np.array([-2.0, 2.0, 0.5, np.nan], np.float32), int(odd.sum()))
    w = rng.random((4, H, W), dtype=np.float32) * (rng.random((4, H, W)) > 0.2)
    w[rng.random((4, H, W)) < 0.05] = -0.0
    w[rng.random((4, H, W)) < 0.005] = np.nan
    w[rng.random((4, H, W)) < 0.005] = np.inf
    count = np.where(rng.random((1, H, W)) < 0.33, 0,
                     rng.integers(1, 5, (1, H, W))).astype(np.float32)
    rw = np.concatenate([res, w.astype(np.float32), count]).astype(np.float32)
    return torch.from_numpy(hist), torch.from_numpy(rw)


SIZES = [(128, 128), (61, 97), (29, 7)]
MOTIONS = [(0, 0), (3, -5), (-2, 7), "wrap"]


@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for h, w in SIZES])
@pytest.mark.parametrize("motion", MOTIONS, ids=["still", "3,-5", "-2,7", "wrap"])
def test_k2_tiles_equal_plain(size, motion):
    """The matched-views sum under the finite gate equals the 16-view sum
    bit for bit, motions wrapping in both directions."""
    H, W = size
    my, mx = (H + 5, -(W + 3)) if motion == "wrap" else motion
    hist, rw = _fetch_inputs(H, W, seed=H * W + 7)
    out = coef_fetch_tiles_plain(hist, rw, my, mx)
    _bits_equal(out, coef_fetch_plain(hist, rw, my, mx), f"{W}x{H} ({my}, {mx})")
    if (H, W) == (128, 128):  # both sides of the gate ran
        full = fetch_full_tiles(hist, my, mx)
        assert 0 < int(full.sum()) < full.numel()


@pytest.mark.parametrize("C", [1, 3, 16])
def test_k2_tiles_equal_plain_channels(C):
    """The same at other history widths the wrapper takes (the kernel's
    run-time-C body), 97x61 with a motion that wraps."""
    hist, rw = _fetch_inputs(61, 97, seed=C, C=C)
    out = coef_fetch_tiles_plain(hist, rw, 66, -100)
    _bits_equal(out, coef_fetch_plain(hist, rw, 66, -100), f"C {C}")


def test_k2_gate_is_needed():
    """Summing the matched views on a tile whose window holds a NaN loses
    it where a zero coefficient meets it (0 x NaN): the gate is what keeps
    the two equal."""
    hist, rw = _fetch_inputs(128, 128, seed=3)
    TH, TW = FETCH_TILE
    hist[0, TH // 2 :: TH, TW // 2 :: TW] = float("nan")
    assert bool(fetch_full_tiles(hist, 0, 0).all())
    plain = coef_fetch_plain(hist, rw, 0, 0)
    every_tile_fast = torch.zeros_like(fetch_full_tiles(hist, 0, 0))
    import low_precision_raytracer_tpu_torch.ops.svgf_kernels as sk

    orig = sk.fetch_full_tiles
    sk.fetch_full_tiles = lambda *a: every_tile_fast
    try:
        ungated = coef_fetch_tiles_plain(hist, rw, 0, 0)
    finally:
        sk.fetch_full_tiles = orig
    assert not torch.equal(torch.isnan(ungated), torch.isnan(plain))
    _bits_equal(coef_fetch_tiles_plain(hist, rw, 0, 0), plain, "gated")


def test_k2_emulation_against_jax(monkeypatch):
    """The emulation in K2's place on `fetch_weighted_packed` against the
    JAX fetch (`coef_fetch_pallas`, interpret mode): a wrapping motion, NaN
    history on a few tiles."""
    H, W = 40, 96
    rng = np.random.default_rng(1)
    hist = rng.random((10, H, W), dtype=np.float32)
    hist[:, 15:18, 40:44] = np.nan
    res_y = rng.integers(-1, 2, (H, W)).astype(np.int32)
    res_x = rng.integers(-1, 2, (H, W)).astype(np.int32)
    wgt = rng.random((H, W, 4), dtype=np.float32) * (rng.random((H, W, 4)) > 0.2)
    count = rng.integers(0, 5, (H, W)).astype(np.int32)
    my, mx = 1, -2
    row = np.arange(H, dtype=np.int32)[:, None]
    col = np.arange(W, dtype=np.int32)[None, :]
    by = np.clip(row + 1 + my + res_y, 0, H).astype(np.int32)
    bx = np.clip(col + 1 + mx + res_x, 0, W).astype(np.int32)
    ref = jax_fetch_weighted_packed(
        jnp.asarray(hist), jnp.asarray(by), jnp.asarray(bx), jnp.asarray(wgt),
        jnp.asarray(count),
        (jnp.int32(my), jnp.int32(mx), jnp.asarray(res_y), jnp.asarray(res_x), jnp.bool_(True)),
        interpret=True)
    monkeypatch.setattr(reproject, "coef_fetch", coef_fetch_tiles_plain)
    T_ = torch.from_numpy
    out, fast = reproject.fetch_weighted_packed(
        T_(hist), T_(by), T_(bx), T_(wgt), T_(count),
        (torch.tensor(my, dtype=torch.int32), torch.tensor(mx, dtype=torch.int32),
         T_(res_y), T_(res_x), torch.tensor(True)))
    assert fast
    full = fetch_full_tiles(T_(hist), my, mx)
    assert 0 < int(full.sum()) < full.numel()
    _close(out.numpy(), _crop(ref), "fetch (emulated K2)")


# ---------------------------------------------------------------------------
# K1a


def test_mul_ru_and_next_up():
    """`mul_ru` is the product rounded toward +Inf (against exact
    rationals), into the subnormals and past the largest float too;
    `next_up` is the next float above."""
    rng = np.random.default_rng(4)
    a = (rng.normal(size=4000) * 10.0 ** rng.integers(-40, 20, 4000)).astype(np.float32)
    b = (rng.normal(size=4000) * 10.0 ** rng.integers(-25, 20, 4000)).astype(np.float32)
    a[:4], b[:4] = [3e38, -3e38, 1e-30, 0.0], [2.0, 2.0, 1e-20, -5.0]
    got = mul_ru(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    top = Fraction(float(np.finfo(np.float32).max))
    for x, y, g in zip(a, b, got):
        exact = Fraction(float(x)) * Fraction(float(y))
        if np.isinf(g):
            assert g > 0 and exact > top
            continue
        assert exact <= Fraction(float(g)), (x, y, g)
        if g != -np.finfo(np.float32).max:  # else every float below is -Inf
            below = np.nextafter(g, np.float32(-np.inf), dtype=np.float32)
            assert Fraction(float(below)) < exact, (x, y, g)
    x = np.array([0.0, -0.0, 1.0, -1e-45, 3.4028235e38, -np.inf], np.float32)
    with np.errstate(over="ignore"):
        want = np.nextafter(x, np.float32(np.inf), dtype=np.float32)
    assert np.array_equal(next_up(torch.from_numpy(x)).numpy().view(np.int32), want.view(np.int32))


CORNELL_N = 32
K1A_FORMS = [("bf16", "mxu3"), ("fp16", "mxu3"), ("fp32", "both"), ("bf16", "both"),
             ("bf16", "dtype"), ("fp16", "both"), ("fp16", "dtype"), ("fp32", "dtype")]


def _cornell_launches(precision, fallback):
    cfg = RenderConfig(width=CORNELL_N, height=CORNELL_N, precision=precision,
                       triangle_fallback=fallback)
    frame = flatten_frame(cornell_box_scene(), cfg.prec, "cpu", 4, CORNELL_N, CORNELL_N)
    band = T.acceptance_band(frame, cfg, cfg.prec)
    coef = T.frame_table(frame, band)
    spec = {k: getattr(frame, k)[: frame.n_lights] for k in ("light_type", "light_pos", "light_dir")}
    lights = T.di_light_rows(frame, spec)
    d_mov = T.fused_moveforward(cfg.prec, band)
    c = frame.dense_center
    o, d = primary_ray_grid(frame.cam_l2w_f32, frame.cam_fov_y_f32, CORNELL_N, CORNELL_N)
    o = (o.reshape(-1, 3) - c).contiguous()
    d = d.reshape(-1, 3).contiguous()
    R = o.shape[0]
    none = torch.full((R,), -1, dtype=torch.int32)
    primary = (o, d, none, torch.zeros(R), torch.full((R,), 1e5))
    # bounce-shaped: from the primary hits, random directions, the hit row
    # skipped, a quarter dead
    hit = dense_trace_plain(*primary, coef, frame.dense_tri, frame.dense_obj, band=band)
    rng = np.random.default_rng(9)
    g = torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32))
    g = g / g.norm(dim=1, keepdim=True)
    maxd = torch.where(torch.from_numpy(rng.random(R) < 0.25), 0.0, 1e5).to(f32)
    bounce = ((o + hit[0][:, None] * d).contiguous(), g.contiguous(), hit[3].contiguous(),
              torch.full((R,), 1e-3), maxd)
    box = torch.tensor([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]]) - c
    spot = torch.tensor([-0.35, -1.0, -0.35]) - c
    edge = k1a_edge_rays(coef, box[0].tolist(), box[1].tolist(), spot.tolist(), 2500, seed=2)
    tables = {"table": (coef, frame.dense_tri, frame.dense_obj),
              "doubled": (torch.cat([coef, coef]).contiguous(),
                          torch.cat([frame.dense_tri + 1000, frame.dense_tri]).int().contiguous(),
                          torch.cat([frame.dense_obj, frame.dense_obj]).int().contiguous())}
    return dict(band=band, lights=lights, d_mov=d_mov, tables=tables, prec=cfg.prec,
                launches={"primary": primary, "bounce": bounce, "edge": edge})


@pytest.fixture(scope="module", params=K1A_FORMS, ids=[f"{p}-{f}" for p, f in K1A_FORMS])
def cornell_form(request):
    return _cornell_launches(*request.param)


@pytest.mark.parametrize("table", ["table", "doubled"])
def test_k1a_cull_equals_plain(cornell_form, table):
    """The culled loops equal `dense_trace_plain` bit for bit on every ray
    of every launch (fused shadow phase; packed below fp32), and both culls
    cut in both phases."""
    c = cornell_form
    tab = c["tables"][table]
    forms = [dict(lights=c["lights"], d_mov=c["d_mov"])]
    if not c["prec"].is_f32:
        forms.append(dict(pack=True))
    for name, rays in c["launches"].items():
        for kw in forms:
            args = rays + tab
            out, counts = dense_trace_cull_plain(*args, band=c["band"], **kw)
            want = dense_trace_plain(*args, band=c["band"], **kw)
            for i, (a, b) in enumerate(zip(out, want)):
                assert torch.equal(a, b), f"{name} {kw.keys()} output {i}"
            for phase, n in counts.items():
                assert n["sign_culled"] + n["range_culled"] + n["full"] == n["tests"]
                assert n["warp_full"] <= n["warp_steps"]
                if name != "edge":
                    assert n["sign_culled"] > 0 and n["range_culled"] > 0, (name, phase, n)


def test_k1a_lane_order():
    """K1a's lanes (`k1a_lane_order`): each block of 256 slots holds its
    own rays, each once, the live ones grouped by octant (sign bits, -0
    negative) in ray order, then the dead ones, then -1 past R."""
    rng = np.random.default_rng(5)
    R = 700
    d = torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32))
    d[::9, 1] = -0.0
    mind = torch.zeros(R)
    maxd = torch.where(torch.from_numpy(rng.random(R) < 0.2), 0.0, 1e5).to(f32)
    slots = k1a_lane_order(d, mind, maxd)
    assert slots.shape[0] == 768
    for b in range(3):
        blk = slots[256 * b : 256 * (b + 1)]
        rays = blk[blk >= 0]
        assert torch.equal(torch.sort(rays).values, torch.arange(256 * b, min(R, 256 * (b + 1))))
        assert bool((blk[len(rays):] == -1).all())
        sb = torch.signbit(d[rays]).long()
        key = torch.where(maxd[rays] > mind[rays], sb[:, 0] * 4 + sb[:, 1] * 2 + sb[:, 2], 8)
        assert bool((key[1:] >= key[:-1]).all())
        for k in key.unique():
            assert bool((rays[key == k].diff() > 0).all())


def test_k1a_edge_lanes(cornell_form):
    """The adversarial lanes are what they claim: zero direction
    components, origins with Oz == 0 on some row, lanes with mind < 0 that
    take a hit at t <= 0 (a row behind the origin), dead lanes that keep the
    miss record, exact ties in the least t on the doubled table."""
    c = cornell_form
    o, d, skip, mind, maxd = c["launches"]["edge"]
    coef, tri, obj = c["tables"]["table"]
    assert int((d == 0).any(dim=1).sum()) >= 400
    Oz = (coef[:, 6][None] * o[:, 0:1] + coef[:, 7][None] * o[:, 1:2]
          + coef[:, 8][None] * o[:, 2:3] + coef[:, 11][None])
    assert int((Oz == 0).any(dim=1).sum()) >= 200
    out = dense_trace_plain(o, d, skip, mind, maxd, coef, tri, obj, band=c["band"])
    assert int(((mind < 0) & (out[3] >= 0) & (out[0] <= 0)).sum()) > 0
    dead = maxd <= mind
    assert int(dead.sum()) >= 400
    assert bool((out[3][dead] == -1).all()) and bool((out[0][dead] == 1e5).all())
    dc, dt, _ = c["tables"]["doubled"]
    t, _u, _v, geom = tri_quantities(dc, o, d, c["band"])
    ok = (geom & (t > mind[:, None]) & (t < maxd[:, None]) & (dt[None] != skip[:, None])
          & torch.isfinite(t))
    tmin = torch.where(ok, t, float("inf")).min(dim=1).values
    assert int((((t == tmin[:, None]) & ok).sum(dim=1) > 1).sum()) > 100


def test_k1a_emulation_against_jax(cornell, monkeypatch):  # noqa: F811
    """The culled loops in K1a's place on the route (`ops/trace.py:trace`,
    fused shadow phase) against `trace_rays_dense_pallas(fallback='mxu3')`
    in interpret mode on a bounce-shaped launch with dead lanes, at
    tests/test_torch_dense_trace.py's bars."""
    monkeypatch.setattr(T, "dense_trace", lambda *a, **kw: dense_trace_cull_plain(*a, **kw)[0])
    j0, _ = _both(cornell, cornell["o"], cornell["d"])
    rng = np.random.default_rng(7)
    R = cornell["o"].shape[0]
    o = (cornell["o"] + j0["t"][:, None] * cornell["d"]).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(np.sum(d * cornell["d"], axis=1, keepdims=True) > 0, -d, d)
    maxd = np.where(rng.random(R) < 0.25, 0.0, 1e5).astype(np.float32)
    j, t = _both(cornell, o, d, skip_tri=j0["tri"].astype(np.int32),
                 min_dist=np.full(R, 1e-2, np.float32), max_dist=maxd)
    _check(j, t)
    assert (t["tri"] >= 0).mean() > 0.4
