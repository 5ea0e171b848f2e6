"""PyTorch port, the dense route past 2048 chunks: colonnade-328k,
`sponza_like_scene(8, 4)` (328,450 instance triangles in 2,567 chunks, the
JAX package's large-scene size `tools/bench_large_scene.py` names), which
`traversal_impl='auto'` sends to the dense route (up to 2^20 instance
triangles) as the JAX package does on the TPU.

- `dense_trace_multi` takes any chunk count: its tree over the 2,567 chunk
  boxes has 7 levels, and on the CPU it runs the plain version.
- The kernel's walk (emulated by tests/test_torch_packet.py:_walk over
  the 128-row chunks) equals the plain version bit for bit on this table,
  with a constructed equal-t tie across two chunks far apart in the table.
- Routes, both packages' gates: in bf16 the incoherent launches go to the
  per-ray wavefront, in fp32 to the anchor-sorted K1b; the epsilons agree.
- One frame renders, finite, in bf16 (8 x 8) and in fp32 (4 x 4), with
  the launch sequence asserted.
- Primary hits on 256 rays agree with the float64 brute-force oracle
  (`tests/oracle.py`'s solve, vectorised over the triangles) at
  tests/test_torch_wavefront.py's bars: hit masks agree on > 99.5% of
  rays, the triangle on > 98% of common hits, t within 0.03 at the 95th
  percentile."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import RenderConfig as JaxConfig
from low_precision_raytracer_tpu.config import get_precision as jax_precision
from low_precision_raytracer_tpu.models.hierarchy import build_flat_scene
from low_precision_raytracer_tpu.models.procedural import sponza_like_scene as jax_sponza
from low_precision_raytracer_tpu.models.scene import build_scene_arrays, flatten_frame
from low_precision_raytracer_tpu.ops.trace import incoherent_reorders as jax_reorders
from low_precision_raytracer_tpu.ops.trace import moveforward_eps as jax_moveforward_eps
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.models import scene as tscene
from low_precision_raytracer_tpu_torch.models.procedural import sponza_like_scene
from low_precision_raytracer_tpu_torch.ops import trace as ttrace
from low_precision_raytracer_tpu_torch.ops.camera import primary_ray_grid
from low_precision_raytracer_tpu_torch.ops.dense_trace import (
    CHUNK,
    build_tree,
    dense_trace_multi,
    dense_trace_multi_plain,
)
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_packet import _walk

TI, NC = 328450, 2567


@pytest.fixture(scope="module")
def frame():
    f = tscene.flatten_frame(sponza_like_scene(8, 4), "bf16", "cpu", max_direct_lights=4,
                             width=16, height=16)
    assert tscene.instance_tris(f) == TI and f.dense_chunk_lo.shape == (NC, 3)
    return f


def _args(f, o, d, skip=None, mind=None, maxd=None):
    n = o.shape[0]
    lo, hi, tree = ttrace._chunk_tables(f)
    c = f.dense_center
    skip = torch.full((n,), -1, dtype=torch.int32) if skip is None else skip
    mind = torch.zeros(n) if mind is None else mind
    maxd = torch.full((n,), 1e5) if maxd is None else maxd
    return [(o - c).contiguous(), d.contiguous(), skip, mind, maxd,
            ttrace.coef_table(f), f.dense_tri, f.dense_obj, lo, hi], tree


def _primary(f, n=16):
    o, d = primary_ray_grid(f.cam_l2w_f32, f.cam_fov_y_f32, n, n, torch.float32)
    return o.reshape(-1, 3), d.reshape(-1, 3)


@pytest.fixture(scope="module")
def primary(frame):
    """16 x 16 primary rays as K1b's arguments, the chunk tree, and K1b's
    result (on the CPU, the plain version)."""
    o, d = _primary(frame)
    args, tree = _args(frame, o, d)
    return args, tree, dense_trace_multi(*args, tree=tree)


def test_multi_takes_any_chunk_count(primary):
    _args_, tree, got = primary
    assert tree.leaf == CHUNK and tree.sizes == (2567, 642, 161, 41, 11, 3, 1)
    assert got[0].shape == (256,) and (got[3] >= 0).mean(dtype=torch.float32) > 0.5


def test_walk_equals_plain_with_cross_chunk_tie(frame, primary):
    """Row j, in a chunk far from row i's, gets row i's coefficients and
    the smaller tri id of the two (its chunk box widened to cover row i's
    triangle): rays that hit row i meet both at exactly one t, and the walk
    must return row j's tri, as the plain (t, tri) minimum does, whichever
    chunk it reaches first."""
    args, _tree, base = primary
    args = list(args)
    rows = torch.nonzero(args[6][None, :] == base[3][:, None])[:, 1]  # each hit's row
    i = int(torch.mode(rows).values)  # the row most rays hit
    j = TI - 1 if i < TI // 2 else 0
    coef, tri_ids = args[5].clone(), args[6].clone()
    lo, hi = args[8].clone(), args[9].clone()
    coef[j] = coef[i]
    tri_ids[j] = tri_ids[i]
    tri_ids[i] = tri_ids.max() + 1  # row i keeps the larger id
    ci, cj = i // CHUNK, j // CHUNK
    lo[cj], hi[cj] = torch.minimum(lo[cj], lo[ci]), torch.maximum(hi[cj], hi[ci])
    args[5], args[6], args[8], args[9] = coef, tri_ids, lo, hi
    plain = dense_trace_multi_plain(*args[:8])
    tied = base[3] == tri_ids[j]
    assert int(tied.sum()) > 2 and bool((plain[3][tied] == tri_ids[j]).all())
    tree = build_tree(lo, hi, TI, CHUNK)
    for a, b in zip(_walk(*args[:8], tree, False), plain):
        assert torch.equal(a, b)
    # any hit: shadow-shaped rays from the hits toward the fill light
    hit = plain[3] >= 0
    p = (args[0] + plain[0][:, None] * args[1])[hit]
    to = torch.tensor([0.0, 5.0, 0.0]) - frame.dense_center - p
    dist = torch.linalg.norm(to, dim=1)
    n = p.shape[0]
    sh = [p.contiguous(), (to / dist[:, None]).contiguous(), plain[3][hit].contiguous(),
          torch.full((n,), 1e-2), dist.contiguous(), *args[5:8]]
    want = dense_trace_multi_plain(*sh, find_any=True)
    for a, b in zip(_walk(*sh, tree, True), want):
        assert torch.equal(a, b)
    assert (want[3] >= 0).any() and (want[3] < 0).any()


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_routes_match_jax(frame, precision):
    host = jax_sponza(8, 4)
    prec = jax_precision(precision)
    jframe = flatten_frame(host, prec, max_direct_lights=4, width=16, height=16)
    jscene = build_scene_arrays(host, prec)
    jcfg = JaxConfig(width=16, height=16, precision=precision, traversal_impl="dense_pallas")
    cfg = RenderConfig(width=16, height=16, precision=precision)
    tf = tscene.flatten_frame(sponza_like_scene(8, 4), precision, "cpu", max_direct_lights=4,
                              width=16, height=16)
    assert ttrace.resolve_impl(tf, cfg) == "dense_pallas"  # <= packet_bvh_min_tris
    assert ttrace._wavefront_route(tf, cfg, cfg.prec) == (precision == "bf16")
    assert ttrace.incoherent_reorders(tf, cfg, cfg.prec)
    assert jax_reorders(jscene, jframe, jcfg, prec)
    for coherent in (True, False):
        assert ttrace.moveforward_eps(tf, cfg, cfg.prec, coherent) == jax_moveforward_eps(
            jscene, jframe, jcfg, prec, coherent)


@pytest.mark.parametrize("precision,n", [("bf16", 8), ("fp32", 4)])
def test_renders_8x8(monkeypatch, precision, n):
    """K1b takes the primary and round-0 shadows; the GI bounce and round-1
    shadows go to the wavefront in bf16, to the sorted K1b in fp32 (4 x 4:
    the plain f32 band over 328k rows is the CPU's slowest test)."""
    calls = []
    for name in ("dense_trace", "dense_trace_multi", "dense_trace_multi_sorted",
                 "trace_rays_wavefront", "packet_trace", "packet_trace_sorted"):
        fn = getattr(ttrace, name)
        monkeypatch.setattr(ttrace, name, lambda *a, _n=name, _f=fn, **kw: (
            calls.append((_n, kw.get("find_any", False))) or _f(*a, **kw)))
    r = Renderer(sponza_like_scene(8, 4), RenderConfig(width=n, height=n, precision=precision),
                 device="cpu")
    assert r.cfg.traversal_impl == "dense_pallas"
    img, aux = r.render()
    assert img.shape == (n, n, 3) and bool(torch.isfinite(img).all())
    assert float(img.std()) > 1e-3 and int(aux["n_rays"]) > n * n
    incoherent = ("trace_rays_wavefront" if precision == "bf16" else "dense_trace_multi_sorted")
    assert calls == [("dense_trace_multi", False), ("dense_trace_multi", True),
                     (incoherent, False), (incoherent, True)]


def _fp64_oracle(flat, meshes, o, d, block=16):
    """tests/oracle.py:brute_force_trace for closest hits, vectorised over
    the triangles (its per-triangle loop takes ~30 s at 328k): the same
    float64 M-shift solve per (ray, triangle), the first minimal t in
    triangle order.  -> (t, tri, hit) (R,)."""
    from oracle import world_triangles

    tris, _obj, glob = world_triangles(flat, meshes)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    e0, e1 = v0 - v2, v1 - v2
    n = np.cross(e0, e1)
    m = np.stack([e0, e1, n], axis=2)  # columns e0, e1, n
    ok_m = np.linalg.det(m) != 0
    minv = np.linalg.inv(np.where(ok_m[:, None, None], m, np.eye(3)))
    v2n = np.einsum("tj,tj->t", v2, n)
    ts, tri = [], []
    for r0 in range(0, o.shape[0], block):
        ob, db = o[r0:r0 + block], d[r0:r0 + block]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (v2n[None] - ob @ n.T) / (db @ n.T)
            p = [ob[:, j:j + 1] + t * db[:, j:j + 1] - v2[None, :, j] for j in range(3)]
            u = p[0] * minv[:, 0, 0] + p[1] * minv[:, 0, 1] + p[2] * minv[:, 0, 2]
            v = p[0] * minv[:, 1, 0] + p[1] * minv[:, 1, 1] + p[2] * minv[:, 1, 2]
            ok = (ok_m[None] & np.isfinite(t) & (t > 0) & (t < 1e5) & (u > 0) & (v > 0)
                  & (u + v < 1))
        tm = np.where(ok, t, np.inf)
        k = np.argmin(tm, axis=1)
        best = tm[np.arange(k.shape[0]), k]
        ts.append(np.where(np.isfinite(best), best, 1e5))
        tri.append(np.where(np.isfinite(best), glob[k], -1))
    t, tri = np.concatenate(ts), np.concatenate(tri)
    return t, tri, tri >= 0


def test_primary_matches_fp64_oracle(frame):
    host = jax_sponza(8, 4)
    o, d = _primary(frame)
    hit = ttrace.trace(frame, o, d, cfg=RenderConfig(width=16, height=16, precision="bf16"),
                       prec=RenderConfig(precision="bf16").prec)
    flat = build_flat_scene(host.root, host.active_camera)
    want_t, want_tri, want_hit = _fp64_oracle(flat, host.meshes, o.numpy().astype(np.float64),
                                              d.numpy().astype(np.float64))
    got_hit = hit.tri.numpy() >= 0
    assert (got_hit == want_hit).mean() > 0.995
    both = got_hit & want_hit
    same = hit.tri.numpy()[both] == want_tri[both]
    assert same.mean() > 0.98
    t_err = np.abs(hit.t.numpy()[both][same] - want_t[both][same])
    assert np.quantile(t_err, 0.95) < 0.03
