"""PyTorch port, the packed winner epilogue (`dense_epilogue='pack'`,
`dense_pallas.py:_finish_chunk_packed` :130-180) of K1a and K1b, against
the JAX package.

- The epilogue alone (`ops/dense_trace.py:_packed`, the plain version;
  the kernels' running form emulated by tests/test_torch_packet.py:
  `_Packed`) against the JAX lines themselves, run chunk by chunk on
  numpy refs: constructed lanes with a same-chunk pair inside the key's
  truncation window (the key decides, not t) and exact t ties across
  chunks (the lower row: the reference's first-visited chunk when chunks
  go in row order, the port's rule in any order).
- K1a on Cornell (64 x 64 primary, then a bounce-shaped launch, both
  closest hit on K1a under 'pack') and the separate any-hit shadow launch
  (K1b) that takes the place of the fused phase (`di_fusible` is False
  under 'pack'),
  through both packages' `trace` (JAX: `trace_rays_dense_pallas(...,
  epilogue='pack')` in interpret mode).
- K1b's two closest-hit launch forms on colonnade-830 (`sponza_like_scene(3,
  1)`, 16 x 64): the primary and the anchor-sorted GI bounce.
- K1b's tree walk under 'pack' (emulated, `_walk(pack=True)`) equal to the
  plain version bit for bit; fp32 ignores 'pack'; K1a and K1b under bf16
  'both' with 'pack'; the flagship's 'pack' frame against the JAX
  Renderer.

Bars (JAX `tests/test_dense_pallas.py:297-327`, and the port-vs-JAX bars of
tests/test_torch_band.py): against the JAX kernels, hit-mask agreement >
0.999 (the port tests in f32, the reference in bf16x3: ROADMAP queue 3),
tri agreement > 0.999 counting exact-t coplanar ties as agreeing
(`_tri_agreement`; plain agreement > 0.99), obj equal where tri agrees, t
within 2e-3 and u/v within 1/16384 + 2e-3 there.  Against the port's own
'reduce5' on the same rays: hit masks equal, tri agreement > 0.999, t
equal to rtol 1e-6 where tri agrees (the stored t is exact), u/v within
1/16384 + 1e-6.  The JAX test's t bar (rtol 1e-6) compares two epilogues
of one kernel, as the 'reduce5' comparison here does; against the JAX
kernel the port's f32 t differs from its bf16x3 t by up to 4.0e-5
relative on Cornell's primary rays and 5.5e-4 absolute on its bounce
rays (measured), so t is held there to the bf16x3 bar, 2e-3."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import RenderConfig as JaxConfig
from low_precision_raytracer_tpu.config import SVGFConfig as JaxSVGF
from low_precision_raytracer_tpu.models.procedural import cornell_box_scene as jax_cornell
from low_precision_raytracer_tpu.models.procedural import sponza_like_scene as jax_sponza
from low_precision_raytracer_tpu.ops.dense_pallas import _finish_chunk_packed
from low_precision_raytracer_tpu.ops.trace import di_fusible as jax_di_fusible
from low_precision_raytracer_tpu.ops.trace import trace as jax_trace
from low_precision_raytracer_tpu.render.renderer import Renderer as JaxRenderer
from low_precision_raytracer_tpu_torch.config import RenderConfig, get_precision
from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene
from low_precision_raytracer_tpu_torch.ops import trace as ttrace
from low_precision_raytracer_tpu_torch.ops.dense_trace import (
    CHUNK,
    _packed,
    build_tree,
    coef_table,
    dense_band,
    dense_trace,
    dense_trace_multi_plain,
    k1a_chunk,
    pack_lb,
)
from low_precision_raytracer_tpu_torch.ops.trace import acceptance_band, di_fusible, use_pack
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_band import _gi_rays, _tri_agreement
from test_torch_fp32 import _tables
from test_torch_packet import _launch_args, _Packed, _shadows, _walk
from test_torch_render_e2e import _run_both

Q = 1.0 / 16384
NAMES = ("t", "u", "v", "tri", "obj")


def _both(c, o, d, **kw):
    """One launch through both packages' `trace` under the case's configs.
    -> (jax, port) hit records as numpy dicts."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    hj = jax_trace(c["scene"], c["frame"], jnp.asarray(o), jnp.asarray(d), prec=c["prec"],
                   cfg=c["jcfg"], **jkw)
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ht = ttrace.trace(c["tframe"], torch.from_numpy(o), torch.from_numpy(d), cfg=c["cfg"],
                      prec=c["tprec"], **tkw)
    return ({k: np.asarray(getattr(hj, k)) for k in NAMES},
            {k: getattr(ht, k).numpy() for k in NAMES})


def _port(c, o, d, cfg, **kw):
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    ht = ttrace.trace(c["tframe"], torch.from_numpy(o), torch.from_numpy(d), cfg=cfg,
                      prec=c["tprec"], **tkw)
    return {k: getattr(ht, k).numpy() for k in NAMES}


def _case(host, name, w, h, fallback="auto", impl="dense_pallas"):
    c = _tables(host, name, n=w, m=h)
    kw = dict(width=w, height=h, precision=name, traversal_impl=impl,
              triangle_fallback=fallback)
    c.update(R=w * h, tprec=get_precision(name), jcfg=JaxConfig(dense_epilogue="pack", **kw),
             cfg=RenderConfig(dense_epilogue="pack", **kw),
             cfg5=RenderConfig(dense_epilogue="reduce5", **kw))
    return c


def _check_vs_jax(c, o, d, j, t, dead=None):
    hits = (j["tri"] >= 0) == (t["tri"] >= 0)
    assert hits.mean() > 0.999, f"hit-mask agreement {hits.mean()}"
    band = acceptance_band(c["tframe"], c["cfg"], c["tprec"])
    same = _tri_agreement(c, o, d, j, t, band) & hits
    assert same.mean() > 0.999, f"tri agreement {same.mean()}"
    same &= j["tri"] == t["tri"]
    np.testing.assert_array_equal(j["obj"][same], t["obj"][same])
    hit = same & (t["tri"] >= 0)
    np.testing.assert_allclose(t["t"][hit], j["t"][hit], rtol=2e-3, atol=2e-3)
    for k in ("u", "v"):
        assert np.abs(t[k][hit] - j[k][hit]).max() <= Q + 2e-3, k
    if dead is not None:
        for r in (j, t):
            np.testing.assert_array_equal(r["tri"][dead], -1)
        np.testing.assert_array_equal(t["t"][dead], 1e5)


def _check_vs_reduce5(p, r):
    np.testing.assert_array_equal(p["tri"] >= 0, r["tri"] >= 0)
    same = p["tri"] == r["tri"]
    assert same.mean() > 0.999, f"tri agreement with reduce5 {same.mean()}"
    hit = same & (p["tri"] >= 0)
    np.testing.assert_allclose(p["t"][hit], r["t"][hit], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(p["obj"][hit], r["obj"][hit])
    for k in ("u", "v"):
        assert np.abs(p[k][hit] - r[k][hit]).max() <= Q + 1e-6, k


# ---------------------------------------------------------------------------
# the epilogue alone


def _jax_packed(t, u, v, acc, tc):
    """The JAX lines, chunk after chunk in row order, on numpy refs: (R,
    TI) -> (t, row, pk)."""
    R, TI = t.shape
    outf = np.full((1, R), 1e5, np.float32)
    ids = np.full((2, R), -1, np.int32)
    z = jnp.zeros((1, R), jnp.float32)
    for c in range(TI // tc):
        sl = slice(c * tc, (c + 1) * tc)
        _finish_chunk_packed(jnp.asarray(acc[:, sl].T), jnp.asarray(u[:, sl].T),
                             jnp.asarray(v[:, sl].T), jnp.asarray(t[:, sl].T),
                             jnp.zeros((tc, 1), jnp.float32), c, tc, z - 1.0,
                             z + 3e38, z - 1.0, outf, ids, R)
    return outf[0], ids[0], ids[1]


def test_packed_epilogue_matches_jax_lines():
    """Random lanes over two 128-row chunks plus constructed ones: a
    same-chunk pair inside the truncation window (the farther row has the
    lower local index and the same truncated bits, so it wins the key), an
    exact t tie across the chunks (the lower row), and a lane with no
    accepted row.  The plain version and the kernels' running form
    (`_Packed`) equal the JAX lines bit for bit, t, row and pk."""
    rng = np.random.default_rng(0)
    R, TI = 64, 2 * CHUNK
    t = (rng.random((R, TI)) * 10 + 0.5).astype(np.float32)
    u = rng.random((R, TI)).astype(np.float32) - 0.2
    v = rng.random((R, TI)).astype(np.float32) - 0.2
    acc = rng.random((R, TI)) < 0.05
    acc[0] = False
    # lane 1: rows 3 (local 3) and 9 (local 9) in one bucket of bits & ~127
    base = np.float32(2.0) + np.float32(2.0**-22) * 64  # low 7 bits = 64
    t[1] = 50.0
    acc[1] = False
    t[1, 3], t[1, 9] = base + np.float32(2.0**-22) * 10, base  # row 9 is closer
    acc[1, [3, 9]] = True
    # lane 2: an exact tie across the chunks (rows 200 and 20)
    t[2] = 50.0
    acc[2] = False
    t[2, 20] = t[2, 200] = np.float32(3.25)
    acc[2, [20, 200]] = True
    want = _jax_packed(t, u, v, acc, CHUNK)
    tt = [torch.from_numpy(x) for x in (t, u, v)]
    got = _packed(*tt, torch.from_numpy(acc), CHUNK)
    pb, every = _Packed(R, CHUNK - 1), torch.arange(R)
    for k in range(TI):  # the kernels' running form, rows in order
        pb.row_test(every, torch.from_numpy(acc[:, k]), tt[0][:, k], tt[1][:, k], tt[2][:, k],
                    k % CHUNK)
        if k % CHUNK == CHUNK - 1:
            pb.end_chunk(every, k - CHUNK + 1)
    for x, w, name in zip(got, want, ("t", "row", "pk")):
        np.testing.assert_array_equal(x.numpy(), w, err_msg=name)
    for x, w in zip(pb.out(), want):
        np.testing.assert_array_equal(x.numpy(), w)
    assert got[1][1] == 3 and got[0][1] == t[1, 3] > t[1, 9]
    assert got[1][2] == 20 and got[1][0] == -1 and got[2][0] == -1 and got[0][0] == 1e5
    # the reversed chunk order (a walk may visit chunk 1 first): the same
    pb = _Packed(R, CHUNK - 1)
    for c0 in (CHUNK, 0):
        for k in range(c0, c0 + CHUNK):
            pb.row_test(every, torch.from_numpy(acc[:, k]), tt[0][:, k], tt[1][:, k],
                        tt[2][:, k], k % CHUNK)
        pb.end_chunk(every, c0)
    for x, w in zip(pb.out(), want):
        np.testing.assert_array_equal(x.numpy(), w)
    assert pack_lb(CHUNK) == 7 and pack_lb(k1a_chunk(34)) == 6


# ---------------------------------------------------------------------------
# K1a on Cornell


N = 64


@pytest.fixture(scope="module")
def cornell():
    c = _case(jax_cornell(), "bf16", N, N)
    c["primary"] = _both(c, c["o"], c["d"])
    return c


def test_k1a_pack(cornell, monkeypatch):
    """The primary launch and a bounce-shaped one (the hit triangle
    skipped, min_dist the exact epsilon, a quarter of the lanes dead), both
    on K1a's packed form: against the JAX kernel and the port's reduce5."""
    c = cornell
    calls = []
    real = ttrace.dense_trace
    monkeypatch.setattr(ttrace, "dense_trace", lambda *a, **kw: (
        calls.append(kw.get("pack", False)) or real(*a, **kw)))
    assert use_pack(c["cfg"], c["tprec"], False) and not di_fusible(c["tframe"], c["cfg"])
    assert not jax_di_fusible(c["scene"], c["frame"], c["jcfg"], c["prec"])
    j0, t0 = c["primary"]
    _check_vs_jax(c, c["o"], c["d"], j0, t0)
    _check_vs_reduce5(t0, _port(c, c["o"], c["d"], c["cfg5"]))
    assert (t0["tri"] >= 0).mean() > 0.99

    rng = np.random.default_rng(7)
    R = c["R"]
    o = (c["o"] + j0["t"][:, None] * c["d"]).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(np.sum(d * c["d"], axis=1, keepdims=True) > 0, -d, d).astype(np.float32)
    dead = rng.random(R) < 0.25
    kw = dict(skip_tri=j0["tri"].astype(np.int32), min_dist=np.full(R, 0.01, np.float32),
              max_dist=np.where(dead, 0.0, 1e5).astype(np.float32), coherent=False)
    j, t = _both(c, o, d, **kw)
    _check_vs_jax(c, o, d, j, t, dead)
    _check_vs_reduce5(t, _port(c, o, d, c["cfg5"], **kw))
    # K1a's packed form under 'pack', its full one under 'reduce5'
    assert calls == [False, True, False] and (t["tri"][~dead] >= 0).mean() > 0.5


def test_k1a_separate_shadow_launch(cornell, monkeypatch):
    """Under 'pack' the flagship's shadow rays take their own any-hit
    launch (K1b; the packed epilogue is for closest hit): occlusion
    agreement > 0.999 with the JAX kernel, equal to the reduce5 route's."""
    c = cornell
    calls = []
    for name in ("dense_trace", "dense_trace_multi"):
        fn = getattr(ttrace, name)
        monkeypatch.setattr(ttrace, name, lambda *a, _n=name, _f=fn, **kw: (
            calls.append((_n, kw.get("find_any", False), kw.get("pack", False)))
            or _f(*a, **kw)))
    j0, _ = c["primary"]
    p = (c["o"] + j0["t"][:, None] * c["d"]).astype(np.float32)
    valid = j0["tri"] >= 0
    o, sd, skips, smax, dead, L = _shadows(c, p, valid, j0["tri"], np.random.default_rng(11))
    kw = dict(find_any=True, skip_tri=skips, min_dist=0.01, max_dist=smax, lane_k=L)
    j, t = _both(c, o, sd, **kw)
    occ_j, occ_t = j["tri"] >= 0, t["tri"] >= 0
    assert (occ_j == occ_t).mean() > 0.999
    np.testing.assert_array_equal(occ_t, _port(c, o, sd, c["cfg5"], **kw)["tri"] >= 0)
    for r in (j, t):
        np.testing.assert_array_equal(r["tri"][dead], -1)
    assert calls == [("dense_trace_multi", True, False)] * 2
    assert occ_t[~dead].mean() < 0.98


# ---------------------------------------------------------------------------
# K1b on colonnade-830


H, W = 16, 64


@pytest.fixture(scope="module")
def colonnade():
    c = _case(jax_sponza(3, 1, with_skybox=False), "bf16", W, H)
    c["primary"] = _both(c, c["o"], c["d"])
    return c


@pytest.mark.parametrize("form", ["primary", "gi_sorted"])
def test_k1b_pack(colonnade, form, monkeypatch):
    """K1b's closest-hit launches under 'pack': the primary, and the GI
    bounce (hemisphere rays from the primary hits, sorted by the anchor
    key), against the JAX kernel and the port's reduce5."""
    c = colonnade
    calls = []
    for name in ("dense_trace_multi", "dense_trace_multi_sorted"):
        fn = getattr(ttrace, name)
        monkeypatch.setattr(ttrace, name, lambda *a, _n=name, _f=fn, **kw: (
            calls.append((_n, kw.get("pack", False))) or _f(*a, **kw)))
    if form == "primary":
        o, d, kw, dead = c["o"], c["d"], {}, None
        j, t = c["primary"]
        ttrace.trace(c["tframe"], torch.from_numpy(o), torch.from_numpy(d), cfg=c["cfg"],
                     prec=c["tprec"])
        want = ("dense_trace_multi", True)
    else:
        o, d, skip, maxd = _gi_rays(c, np.random.default_rng(5))
        kw = dict(skip_tri=skip, min_dist=0.01, max_dist=maxd, coherent=False)
        dead = maxd == 0
        j, t = _both(c, o, d, **kw)
        want = ("dense_trace_multi_sorted", True)
    _check_vs_jax(c, o, d, j, t, dead)
    _check_vs_reduce5(t, _port(c, o, d, c["cfg5"], **kw))
    assert calls == [want, (want[0], False)] and 0.1 < (t["tri"] >= 0).mean()


@pytest.mark.parametrize("band", ["mxu3", "bf16-both"])
def test_walk_pack_equals_plain(colonnade, band):
    """Bit for bit on a GI-shaped launch: K1b's tree walk (emulated) under
    'pack' equals the plain version's packed epilogue (under bf16 'both' a
    widened test: the all-row loop, its key reset every 128 rows)."""
    c = colonnade
    tf = c["tframe"]
    p, d, skip, maxd = _gi_rays(c, np.random.default_rng(9))
    args = list(_launch_args(tf, p, d, skip, np.full(p.shape[0], 0.01, np.float32), maxd))
    acc = dense_band(c["tprec"], "both") if band == "bf16-both" else ttrace.STRICT
    args[5] = coef_table(tf, acc)
    lo, hi = ((x - tf.dense_center).contiguous() for x in (tf.dense_chunk_lo, tf.dense_chunk_hi))
    plain = dense_trace_multi_plain(*args[:8], band=acc, pack=True)
    sel = torch.arange(0, p.shape[0], 2)
    sub = [a[sel] for a in args[:5]] + args[5:8]
    tree = build_tree(lo, hi, args[5].shape[0], CHUNK)
    for a, b in zip(_walk(*sub, tree, False, acc, pack=True), plain):
        assert torch.equal(a, b[sel])
    assert (plain[1][sel] >= 0).any() and (plain[1][sel] < 0).any()


def test_fp32_ignores_pack(colonnade):
    """fp32 keeps the exact epilogue (`trace_rays_dense_pallas` :961): the
    'pack' config returns what 'reduce5' returns, bit for bit."""
    c = colonnade
    cfg = RenderConfig(width=W, height=H, precision="fp32", dense_epilogue="pack")
    prec = get_precision("fp32")
    assert not use_pack(cfg, prec, False)
    o, d = torch.from_numpy(c["o"]), torch.from_numpy(c["d"])
    a = ttrace.trace(c["tframe"], o, d, cfg=cfg, prec=prec)
    b = ttrace.trace(c["tframe"], o, d, cfg=RenderConfig(width=W, height=H, precision="fp32"),
                     prec=prec)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_band_both_pack():
    """'pack' under the bf16 'both' band: K1a on Cornell's 32 x 32 primary
    rays against the JAX kernel, and the kernel wrapper's CPU path is its
    plain version with the packed key over one 48-row chunk (lb = 6)."""
    c = _case(jax_cornell(), "bf16", 32, 32, fallback="both")
    j, t = _both(c, c["o"], c["d"])
    _check_vs_jax(c, c["o"], c["d"], j, t)
    _check_vs_reduce5(t, _port(c, c["o"], c["d"], c["cfg5"]))
    tf = c["tframe"]
    band = dense_band(c["tprec"], "both")
    n = c["o"].shape[0]
    args = _launch_args(tf, c["o"], c["d"], np.full(n, -1, np.int32), np.zeros(n, np.float32),
                        np.full(n, 1e5, np.float32))
    coef = coef_table(tf, band)
    out = dense_trace(*args[:5], coef, *args[6:8], band=band, pack=True)
    row = out[1]
    assert torch.equal(torch.where(row >= 0, tf.dense_tri[row.clamp(min=0).long()], -1),
                       torch.from_numpy(t["tri"]))


def test_flagship_pack_frame_matches_jax(monkeypatch):
    """The flagship frame under 'pack' (bf16, GI, SVGF, 16 x 16 x 2 frames)
    against the JAX Renderer: no fused shadow phase, so per frame K1a's
    packed form twice (the primary; round 0's shadow rays and GI bounce,
    L + 1 lanes a pixel in one closest-hit launch, as the JAX renderer runs
    them) and K1b's any hit once (round 1's shadows)."""
    calls = []
    for name in ("dense_trace", "dense_trace_multi"):
        fn = getattr(ttrace, name)
        monkeypatch.setattr(ttrace, name, lambda *a, _n=name, _f=fn, **kw: (
            calls.append((_n, kw.get("pack", False), kw.get("find_any", False)))
            or _f(*a, **kw)))
    n = 16
    jr = JaxRenderer(jax_cornell(), JaxConfig(
        width=n, height=n, precision="bf16", traversal_impl="dense_pallas",
        dense_epilogue="pack", svgf=JaxSVGF(wavelet_impl="pallas")))
    tr = Renderer(cornell_box_scene(), RenderConfig(width=n, height=n, precision="bf16",
                                                    dense_epilogue="pack"), device="cpu")
    _run_both(jr, tr, 2, n)
    per_frame = [("dense_trace", True, False), ("dense_trace", True, False),
                 ("dense_trace_multi", False, True)]
    assert calls == per_frame * 2
