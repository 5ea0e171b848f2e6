"""PyTorch port, the row-sharded frame's local parts in one process: the
halo history take (`ops/reproject.py:halo_take`) and the sharded SVGF pair
(`ops/svgf_kernels.py:svgf_pair_full_sharded`), each rank's work run on its
rows with the strips cut from the whole planes.

- The take, fed strips sliced from the whole array, equals the JAX
  package's `_gather2x2_halo` under `make_pixel_mesh(4)` bit for bit:
  anchors inside the halo, beyond it and at both image edges, on shards of
  32 rows (kh = 17) and of 16 (shorter than 17 rows, kh = 16); where no
  anchor row leaves the halo it equals the unsharded take.
- The sharded pair, its ranks run as threads of this process over
  `ThreadMesh` (whose exchange cuts each strip from the ranks' posted
  planes), equals the port's unsharded `svgf_pair_full` bit for bit: 4
  shards of the JAX sharding test's frame (H = 160, W = 40, a NaN beside a
  shard boundary), strides to 64, and 8 shards of 4 rows (the JAX
  package's `xla_halo` case, here the exchange's all-gather form); and it
  holds the JAX sharded pair (`svgf_denoise_pair(..., mesh=
  make_pixel_mesh(4), wavelet_impl='pallas', interpret=True)`) at the bars
  of tests/test_torch_svgf_kernels.py (rtol 1e-4, atol 1e-5, identical NaN
  positions), the JAX side fed the same depth gradient.
- Tight reaches: each stage's input cut one row short of its stated reach
  (`K3_REACH`, `k4_reach`) changes at least one of the shard's pixels on
  random planes, and at the reach none."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import SVGFConfig as JaxSVGF
from low_precision_raytracer_tpu.ops.reproject import _gather2x2_halo
from low_precision_raytracer_tpu.ops.svgf import SVGFState as JaxSVGFState
from low_precision_raytracer_tpu.ops.svgf import svgf_denoise_pair
from low_precision_raytracer_tpu.parallel.tiling import make_pixel_mesh as jax_mesh
from low_precision_raytracer_tpu_torch.config import SVGFConfig
from low_precision_raytracer_tpu_torch.ops import svgf_kernels as tsk
from low_precision_raytracer_tpu_torch.ops.reproject import HALO_ROWS, _gather2x2, halo_take
from low_precision_raytracer_tpu_torch.ops.svgf import preprocess_normal_depth

T = torch.from_numpy


# ---------------------------------------------------------------------------
# ranks as threads


class _Board:
    def __init__(self, n):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=300)
        self.posted = [None] * n


class ThreadMesh:
    """One rank of n run as a thread: `exchange` posts this rank's planes,
    waits for every rank's, and cuts the strips from the frame they make
    (zeros past the image edge), as `parallel/halo.py:exchange_rows`
    returns them."""

    def __init__(self, board, rank):
        self.board, self.rank, self.size = board, rank, board.n
        self.calls = 0

    def exchange(self, planes, top, bottom):
        b = self.board
        b.posted[self.rank] = planes
        b.barrier.wait()
        frame = torch.cat(b.posted, dim=1)
        b.barrier.wait()  # every rank has read before the next post
        self.calls += 1
        return _strips(frame, self.rank * planes.shape[1], planes.shape[1], top, bottom)


def _strips(frame, r0, h, top, bottom):
    """Rows [r0 - top, r0) and [r0 + h, r0 + h + bottom) of the (C, H, W)
    frame, zero past its edge."""
    C, H, W = frame.shape
    above = frame.new_zeros((C, top, W))
    below = frame.new_zeros((C, bottom, W))
    a0 = max(0, r0 - top)
    above[:, top - (r0 - a0):] = frame[:, a0:r0]
    b1 = min(H, r0 + h + bottom)
    below[:, :b1 - r0 - h] = frame[:, r0 + h:b1]
    return above, below


def run_ranks(n, fn):
    """fn(mesh) on n ThreadMesh ranks, one thread each: -> their results."""
    board, out, err = _Board(n), [None] * n, []

    def go(r):
        try:
            out[r] = fn(ThreadMesh(board, r))
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            err.append(e)
            board.barrier.abort()

    threads = [threading.Thread(target=go, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if err:
        raise err[0]
    return out


def _bits_equal(a, b, name):
    assert a.shape == b.shape, name
    assert torch.equal(torch.isnan(a), torch.isnan(b)), f"{name}: NaN positions"
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), name


# ---------------------------------------------------------------------------
# the halo take


def _anchors(H, W, seed):
    """Pre-shifted anchors: motion within the halo, beyond it, and rows
    clamped at both image edges."""
    rng = np.random.default_rng(seed)
    row = np.arange(H)[:, None]
    col = np.arange(W)[None, :]
    dy = rng.integers(-8, 9, (H, W))
    far = rng.random((H, W)) < 0.2
    dy = np.where(far, rng.integers(-40, 41, (H, W)), dy)
    by = np.clip(row + 1 + dy, 0, H)
    by[:, :2] = 0  # the top edge and the pad row above it
    by[:, 2:4] = H  # the bottom edge and the pad row below it
    bx = np.clip(col + 1 + rng.integers(-3, 4, (H, W)), 0, W)
    return by.astype(np.int32), bx.astype(np.int32)


@pytest.mark.parametrize("H", [128, 64], ids=["shard32", "shard16"])
def test_halo_take_matches_jax(H):
    W, C, n = 24, 3, 4
    rng = np.random.default_rng(H)
    a = rng.random((H, W, C), dtype=np.float32) + 0.5
    by, bx = _anchors(H, W, H + 1)
    ref = np.asarray(_gather2x2_halo(jnp.asarray(a), jnp.asarray(by), jnp.asarray(bx),
                                     jax_mesh(n)))  # (H, W, 4, C)
    h = H // n
    kh = min(HALO_ROWS, h)
    planes = T(a).permute(2, 0, 1).contiguous()
    whole = _gather2x2(planes, T(by), T(bx))  # (4, C, H, W)
    misses = 0
    for r in range(n):
        r0 = r * h
        above, below = _strips(planes, r0, h, kh, kh)
        taps, miss = halo_take(planes[:, r0:r0 + h], above, below, T(by[r0:r0 + h]),
                               T(bx[r0:r0 + h]), r0, H)
        got = taps.permute(2, 3, 0, 1).numpy()  # (h, W, 4, C)
        np.testing.assert_array_equal(got, ref[r0:r0 + h], err_msg=f"rank {r}")
        hit = ~miss
        assert torch.equal(taps[..., hit], whole[:, :, r0:r0 + h][..., hit]), f"rank {r}"
        misses += int(miss.sum())
    assert 0 < misses < H * W
    assert (by == 0).any() and (by == H).any()


# ---------------------------------------------------------------------------
# the sharded SVGF pair


def _jax_sharding_inputs():
    """tests/test_sharding.py:test_sharded_fused_svgf_full_bitwise's inputs
    (H = 160, W = 40, a NaN beside a shard boundary), as numpy."""
    H, W = 160, 40
    ks = jax.random.split(jax.random.PRNGKey(7), 10)
    color2 = jax.random.uniform(ks[0], (2, H, W, 3))
    depth = jax.random.uniform(ks[1], (H, W)) * 5
    normal = jax.random.normal(ks[3], (H, W, 3))
    normal = normal / np.linalg.norm(np.asarray(normal), axis=-1, keepdims=True)
    fc = (jax.random.uniform(ks[7], (H, W)) > 0.2).astype(jnp.int32) * 5
    pre = (jax.random.uniform(ks[1], (2, H, W, 3), jnp.float32),
           jax.random.uniform(ks[2], (2, H, W), jnp.float32),
           jax.random.uniform(ks[3], (2, H, W), jnp.float32) + 1.0)
    color2 = color2.at[0, 41, 7, 1].set(np.nan)
    f = lambda x: np.array(x, np.float32)
    return dict(color2=f(color2), depth=f(depth), normal=f(normal), fc=np.array(fc),
                hist2=f(pre[0]), m1=f(pre[1]), m2=f(pre[2]))


def _ctr11(d):
    return np.stack([d["hist2"][i, ..., c] for i in (0, 1) for c in range(3)]
                    + [d["m1"][0], d["m1"][1], d["m2"][0], d["m2"][1],
                       d["fc"].astype(np.float32)])


def _sharded(n, color2, ctr11, depth, normal, cfg):
    """svgf_pair_full_sharded over n thread ranks -> the whole (out2,
    SVGFState leaves) and the exchanges each rank made."""
    h = depth.shape[0] // n

    def rank(m):
        s = slice(m.rank * h, (m.rank + 1) * h)
        out = tsk.svgf_pair_full_sharded(color2[:, s], ctr11[:, s].contiguous(), depth[s],
                                         normal[s], cfg, 0.1, 0.1, m)
        return out, m.calls

    res = run_ranks(n, rank)
    out2 = torch.cat([r[0][0] for r in res], dim=1)
    state = [torch.cat([r[0][1][i] for r in res], dim=1) for i in range(3)]
    return out2, state, [r[1] for r in res]


def _unsharded(color2, ctr11, depth, normal, cfg):
    """The unsharded pair, in a thread of its own as the ranks run (a
    thread's floating-point state, denormals flushed or not, is its own, and
    the JAX side leaves this thread's set its way)."""
    def one(_mesh):
        grad = preprocess_normal_depth(normal, depth)
        out2, st = tsk.svgf_pair_full(color2, ctr11, depth, grad, normal, cfg, 0.1, 0.1)
        return out2, list(st)

    return run_ranks(1, one)[0]


@functools.lru_cache(maxsize=1)
def _jax_pair():
    """The JAX sharded pair on the JAX test's inputs, once per module."""
    d = _jax_sharding_inputs()
    grad = preprocess_normal_depth(T(d["normal"]), T(d["depth"])).numpy()
    H, W = d["depth"].shape
    j = jnp.asarray
    state2 = JaxSVGFState(miu1=j(d["m1"]), miu2=j(d["m2"]), color_history=j(d["hist2"]))
    svgf_map = dict(frame_count=j(d["fc"]), weights=jnp.zeros((H, W, 4), jnp.float32),
                    base_y=jnp.zeros((H, W), jnp.int32), base_x=jnp.zeros((H, W), jnp.int32))
    out, st = svgf_denoise_pair(
        j(d["color2"]), state2, svgf_map, j(d["normal"]), j(d["depth"]), j(grad), JaxSVGF(),
        0.1, 0.1, prefetch2=(j(d["hist2"]), j(d["m1"]), j(d["m2"])), wavelet_impl="pallas",
        interpret=True, mesh=jax_mesh(4))
    return d, np.asarray(out), [np.asarray(x) for x in (st.miu1, st.miu2, st.color_history)]


def _close(port, ref, name):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, name
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref), err_msg=f"{name}: NaN")
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(port[ok], ref[ok], rtol=1e-4, atol=1e-5, err_msg=name)


def test_sharded_pair_matches_unsharded_and_jax():
    """4 shards of 40 rows: bit for bit against the unsharded pair, within
    the kernel bars of the JAX sharded pair; 9 exchanges a rank."""
    d, ref_out, ref_state = _jax_pair()
    cfg = SVGFConfig()
    args = (T(d["color2"]), T(_ctr11(d)), T(d["depth"]), T(d["normal"]), cfg)
    out2, state, calls = _sharded(4, *args)
    u_out, u_state = _unsharded(*args)
    _bits_equal(out2, u_out, "out")
    for name, a, b in zip(("miu1", "miu2", "color_history"), state, u_state):
        _bits_equal(a, b, name)
    assert calls == [4 + len(cfg.strides)] * 4
    _close(out2.numpy(), ref_out, "out vs JAX")
    for name, a, b in zip(("miu1", "miu2", "color_history"), state, ref_state):
        _close(a.numpy(), b, f"{name} vs JAX")


def _random_pair(H, W, seed):
    rng = np.random.default_rng(seed)
    color2 = T(rng.random((2, H, W, 3), dtype=np.float32))
    color2[1, H // 2, 3, 0] = float("nan")
    depth = T(rng.random((H, W), dtype=np.float32) * 5)
    depth[H // 4, 5] = float("nan")
    normal = T(rng.normal(size=(H, W, 3)).astype(np.float32))
    normal = normal / normal.norm(dim=-1, keepdim=True)
    ctr = T(rng.random((11, H, W), dtype=np.float32))
    ctr[10] = T(rng.integers(0, 8, (H, W)).astype(np.float32))  # spatial and temporal
    return color2, ctr, depth, normal


@pytest.mark.parametrize("n, H, strides", [
    (4, 128, (1, 2, 4, 8, 16, 32, 64)),
    (8, 32, (1, 2, 4, 8, 16)),
], ids=["strides-to-64", "8-shards-of-4-rows"])
def test_sharded_pair_shapes(n, H, strides):
    """Strides past the shard (the all-gather form of the exchange at 32
    and 64) and shards shorter than every reach: bit for bit."""
    cfg = SVGFConfig(strides=strides)
    args = (*_random_pair(H, 24, n), cfg)
    out2, state, _calls = _sharded(n, *args)
    u_out, u_state = _unsharded(*args)
    _bits_equal(out2, u_out, "out")
    for name, a, b in zip(("miu1", "miu2", "color_history"), state, u_state):
        _bits_equal(a, b, name)


# ---------------------------------------------------------------------------
# tight reaches


def _cut(x, r0, h, t, b, real_t=None, real_b=None):
    """x's rows [r0 - t, r0 + h + b), those beyond real_t / real_b rows
    from the shard zeroed."""
    out = x[:, r0 - t:r0 + h + b].clone()
    if real_t is not None and real_t < t:
        out[:, :t - real_t] = 0
    if real_b is not None and real_b < b:
        out[:, out.shape[1] - (b - real_b):] = 0
    return out


def test_reaches_are_tight():
    """For a middle shard: K3's colour, history and geometry and K4's
    geometry and colour at each stride, cut to their reach, give the
    unsharded rows; cut one row shorter, some pixel changes."""
    run_ranks(1, lambda _mesh: _reaches_are_tight())  # a thread's own FP state


def _reaches_are_tight():
    H, W, h, r0 = 96, 24, 16, 40
    cfg = SVGFConfig()
    color2, ctr, depth, normal = _random_pair(H, W, 3)
    grad = preprocess_normal_depth(normal, depth)
    geo7 = tsk.pack_geometry_base(depth, grad, normal, cfg)
    col6 = color2.permute(0, 3, 1, 2).reshape(6, H, W).contiguous()
    whole = torch.cat(tsk.temporal_accum(col6, geo7, ctr, cfg, 0.1, 0.1))
    e = tsk.K3_REACH["col"]

    def k3(col_rows, ctr_rows, geo_rows, span):
        out = tsk.temporal_accum(_cut(col6, r0, h, span, span, col_rows, col_rows),
                                 _cut(geo7, r0, h, span, span, geo_rows, geo_rows),
                                 _cut(ctr, r0, h, span, span, ctr_rows, ctr_rows),
                                 cfg, 0.1, 0.1)
        return torch.cat(out)[:, span:span + h]

    own = whole[:, r0:r0 + h]
    R = tsk.K3_REACH
    _bits_equal(k3(R["col"], R["ctr"], R["geo"], e), own, "K3 at its reach")
    for name, short in (("col", k3(e - 1, R["ctr"], R["geo"], e - 1)),
                        ("ctr", k3(e, R["ctr"] - 1, R["geo"], e)),
                        ("geo", k3(e, R["ctr"], R["geo"] - 1, e))):
        assert not torch.equal(torch.nan_to_num(short), torch.nan_to_num(own)), \
            f"K3 {name} one row short"

    cv, ext, _mst = tsk.temporal_accum(col6, geo7, ctr, cfg, 0.1, 0.1)
    geo = torch.cat([geo7, ext])
    for s in (1, 2, 4, 8):
        ref = tsk.wavelet_iter(geo, cv, s, cfg)[:, r0:r0 + h]
        k = tsk.k4_reach(s)
        at = tsk.wavelet_iter(_cut(geo, r0, h, k, k), _cut(cv, r0, h, k, k), s, cfg)
        _bits_equal(at[:, k:k + h], ref, f"K4 s={s} at its reach")
        for name, g_rows, c_rows in (("geo", k - 1, k), ("cv", k, k - 1)):
            got = tsk.wavelet_iter(_cut(geo, r0, h, k, k, g_rows, g_rows),
                                   _cut(cv, r0, h, k, k, c_rows, c_rows), s, cfg)[:, k:k + h]
            assert not torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref)), \
                f"K4 s={s} {name} one row short"


# ---------------------------------------------------------------------------
# per-pixel products (ROADMAP queue 3 F3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blocks", [1, 2, 3, 4])
def test_pixel_products_same_bits_on_row_blocks(blocks, dtype):
    """The G-buffer's world transform (`ops/gbuffer.py:_finish_world`) and
    the reprojection's clip product (`ops/reproject.py:
    generate_temporal_maps`, `vec.matvec` plus the translation column) on
    a 48 x 20 frame cut into 1-4 row blocks give the whole frame's bits:
    fixed-order sums of elementwise products, the same on any device."""
    from low_precision_raytracer_tpu_torch.math.vec import matvec
    from low_precision_raytracer_tpu_torch.ops.gbuffer import _finish_world

    gen = torch.Generator().manual_seed(blocks)
    H, W = 48, 20
    l2w = torch.randn((H, W, 4, 4), generator=gen).to(dtype)
    pos, nrm, tan = (torch.randn((H, W, 3), generator=gen).to(dtype) for _ in range(3))
    comp = torch.randn((H, W, 4, 4), generator=gen)
    p32 = torch.randn((H, W, 3), generator=gen) * 5

    def clip(c, p):
        return matvec(c[..., :3], p) + c[..., 3]

    whole = (*_finish_world(l2w, pos, nrm, tan), clip(comp, p32))
    h = H // blocks
    parts = [(*_finish_world(l2w[s], pos[s], nrm[s], tan[s]), clip(comp[s], p32[s]))
             for s in (slice(b * h, (b + 1) * h) for b in range(blocks))]
    bits = lambda x: x.view(torch.int16 if x.element_size() == 2 else torch.int32)
    for k, ref in enumerate(whole):
        got = torch.cat([p[k] for p in parts])
        assert got.dtype == ref.dtype and torch.equal(bits(got), bits(ref)), k
