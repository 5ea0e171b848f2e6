"""PyTorch port, the MXU/VPU prototype tool (`low_precision_raytracer_tpu_torch/
tools/mxu_proto.py`, port of `tools/bench_mxu_proto.py`), against the JAX
tool.

The JAX tool reads its chunk height and count from `sys.argv` at import
(:26-27) and its kernels read the module globals `TC` / `NCHUNK` / `TR`, so
it is imported from its path with `sys.argv` set to `bench_mxu_proto.py 48
2` (TC = 48, two chunks).

- `build_tables` on JAX `build_tables(PRNGKey(0), 2, 48)`'s `n_f32` and
  `e` equals its `a32t` / `aabt` (and the bf16 `n_dt`) bit for bit.
- `vpu_kernel` and `mxu_kernel` run through `pl.pallas_call(...,
  interpret=True)` on R = 1,024 rays (two 512-ray tiles) made with numpy;
  the port's plain bodies (`vpu_body` / `mxu_body` on CPU tensors) agree:
  hit agreement >= 0.999, t / u / v to rtol 1e-5 with atol 1e-6 where both
  hit.  XLA on the CPU contracts some products into FMAs, which moves
  values made by cancellation (u, v near 0) by up to 4.8e-7 (measured on
  these rays), beyond rtol 1e-5 of their size; the atol covers that, as the
  card's bar for the tensor-core body does (1e-5 |x| + 1e-6).
- The tool's operation counts and its tensor-core body's prerequisites.
- The kernels' own layouts of the tables (`vpu_table`, `mxu_tables`),
  read back through the kernels' addressing (the wgmma descriptor's LBO /
  SBO and the f32 rows' offsets), equal the JAX `build_tables`' values
  bit for bit at TC 48 and 64; the wrappers refuse a TC the kernels do not
  take and tables too narrow for TC (a TC of which no chunk fits in shared
  memory is refused on the card, `chip_smoke.py:tool_edge_phase`), and
  `check_a32_layout` an A32 table with terms outside the layout.
- No split of the f32 product onto the tensor cores meets the card's bar:
  a 3xTF32 emulation, and even the correctly rounded product, miss it
  against the plain version's in-order f32 sums, so the tensor-core body
  keeps that product on the CUDA cores.
- The layout probe's case (`unit_case`): each block value of its product
  is one ray feature times a power of two, exactly."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from low_precision_raytracer_tpu_torch.tools import mxu_proto as P

TC, NCHUNK, R = 48, 2, 1024
TOOL = Path(__file__).resolve().parent.parent / "tools" / "bench_mxu_proto.py"


@pytest.fixture(scope="module")
def tool():
    """The JAX tool imported from its path under its own argv, and its
    tables."""
    argv = sys.argv
    sys.argv = ["bench_mxu_proto.py", str(TC), str(NCHUNK)]
    try:
        spec = importlib.util.spec_from_file_location("bench_mxu_proto", TOOL)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
    assert (mod.TC, mod.NCHUNK) == (TC, NCHUNK)
    n_dt, n_f32, e, a32t, aabt = mod.build_tables(jax.random.PRNGKey(0), NCHUNK, TC)
    return dict(mod=mod, n_dt=n_dt, n_f32=n_f32, e=e, a32t=a32t, aabt=aabt)


def test_build_tables_match_jax(tool):
    n_dt, a32t, aabt = P.build_tables(np.asarray(tool["n_f32"]), np.asarray(tool["e"]), TC)
    f32 = lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32))
    np.testing.assert_array_equal(a32t.numpy(), f32(tool["a32t"]))
    np.testing.assert_array_equal(aabt.float().numpy(), f32(tool["aabt"]))
    np.testing.assert_array_equal(n_dt.float().numpy(), f32(tool["n_dt"]))
    assert a32t.dtype == torch.float32 and aabt.dtype == n_dt.dtype == torch.bfloat16
    assert tuple(a32t.shape) == (NCHUNK, 8, 384) and tuple(aabt.shape) == (NCHUNK, 16, 384)


@pytest.fixture(scope="module")
def bodies(tool):
    """Both JAX kernels in interpret mode and both plain bodies of the port
    on the same numpy rays (3, R)."""
    mod = tool["mod"]
    rng = np.random.default_rng(0)
    o = rng.standard_normal((3, R)).astype(np.float32)
    d = rng.standard_normal((3, R)).astype(np.float32)
    tr = mod.TR
    ray_block = lambda rows: pl.BlockSpec((rows, tr), lambda i: (0, i))
    const = lambda shape: pl.BlockSpec(shape, lambda i: (0,) * len(shape))
    outs = [jax.ShapeDtypeStruct((1, R), jnp.float32)] * 3
    vpu = pl.pallas_call(
        mod.vpu_kernel, grid=(R // tr,),
        in_specs=[const(tool["n_dt"].shape), const(tool["n_f32"].shape), const(tool["e"].shape),
                  ray_block(3), ray_block(3)],
        out_specs=[ray_block(1)] * 3, out_shape=outs, interpret=True)
    mxu = pl.pallas_call(
        functools.partial(mod.mxu_kernel, nab=8), grid=(R // tr,),
        in_specs=[const(tool["a32t"].shape), const(tool["aabt"].shape), ray_block(3),
                  ray_block(3)],
        out_specs=[ray_block(1)] * 3, out_shape=outs, interpret=True)
    jv = vpu(tool["n_dt"], tool["n_f32"], tool["e"], jnp.asarray(o), jnp.asarray(d))
    jm = mxu(tool["a32t"], tool["aabt"], jnp.asarray(o), jnp.asarray(d))
    n_dt, a32t, aabt = P.build_tables(np.asarray(tool["n_f32"]), np.asarray(tool["e"]), TC)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    n_f32 = torch.from_numpy(np.array(tool["n_f32"]))
    e = torch.from_numpy(np.array(tool["e"]))
    pv = P.vpu_body(n_dt, n_f32, e, to, td, TC)
    pm = P.mxu_body(a32t, aabt, to, td, TC)
    npy = lambda xs: [np.asarray(x).reshape(-1) for x in xs]
    return {"vpu": (npy(jv), npy(pv)), "mxu": (npy(jm), npy(pm))}


@pytest.mark.parametrize("body", ["vpu", "mxu"])
def test_plain_body_matches_jax_kernel(bodies, body):
    j, t = bodies[body]
    hit_j, hit_t = j[0] < 1e5, t[0] < 1e5
    assert (hit_j == hit_t).mean() >= 0.999, f"hit agreement {(hit_j == hit_t).mean()}"
    both = hit_j & hit_t
    assert 0.2 < both.mean() < 0.95
    for k, name in enumerate("tuv"):
        np.testing.assert_allclose(t[k][both], j[k][both], rtol=1e-5, atol=1e-6, err_msg=name)
    for k, miss in enumerate((1e5, 0.0, 0.0)):
        np.testing.assert_array_equal(t[k][~hit_t], miss)


def test_bodies_agree_and_count(bodies):
    """The two plain bodies differ only in their operands' rounding (the
    MXU body rounds the ray and e to bf16): they agree on nearly every hit;
    and the operation counts the card's bound uses are the code's."""
    (_, v), (_, m) = bodies["vpu"], bodies["mxu"]
    assert ((v[0] < 1e5) == (m[0] < 1e5)).mean() >= 0.99
    assert P.VPU_OPS == 33 + 2 + 4 + 22 + 24 + 22 + 4 + 4 + 2 + 10 + 7 + 2 + 2 + 4
    # the tensor-core body's f32 product: three O rows (3 mul + 3 add) and
    # three D rows (3 mul + 2 add), then the tail
    assert P.MXU_OPS_F32 == 3 * 6 + 3 * 5 + 65 and P.MXU_OPS_BF16 == 8 * 16 * 2
    with pytest.raises(ValueError, match="rows are not whole chunks"):
        P.build_tables(np.zeros((50, 9), np.float32), np.zeros((50, 3), np.float32), TC)


@pytest.fixture(scope="module", params=[48, 64])
def jax_tables(request, tool):
    """The JAX tool's tables at TC 48 (the module's) and 64, NCHUNK 2."""
    tc = request.param
    if tc == TC:
        return tc, tool
    n_dt, n_f32, e, a32t, aabt = tool["mod"].build_tables(jax.random.PRNGKey(3), NCHUNK, tc)
    return tc, dict(n_dt=n_dt, n_f32=n_f32, e=e, a32t=a32t, aabt=aabt)


def test_kernel_layouts_match_build_tables(jax_tables):
    """Each value the kernels read, at the address the kernels compute,
    equals the JAX table's value bit for bit."""
    tc, jt = jax_tables
    f32 = lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32))
    bits16 = lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    n_f32, e = np.array(jt["n_f32"]), np.array(jt["e"])
    n_dt, a32t, aabt = P.build_tables(n_f32, e, tc)
    # VPU: row k = [n_dt 9 | n_f32 9 | e 3 | 0 0 0]
    vt = P.vpu_table(n_dt, torch.from_numpy(n_f32), torch.from_numpy(e)).numpy()
    assert vt.shape == (NCHUNK * tc, P.VPU_ROW)
    np.testing.assert_array_equal(vt[:, 0:9], f32(jt["n_dt"]))
    np.testing.assert_array_equal(vt[:, 9:18], n_f32)
    np.testing.assert_array_equal(vt[:, 18:21], e)
    np.testing.assert_array_equal(vt[:, 21:], 0)
    tab_ab, tab_f = P.mxu_tables(a32t, aabt, tc)
    # MXU, bf16 operand: chunk c, block b, row 8 s + r, K k at byte (c nsl +
    # s) 2048 + b SBO + (k / 8) LBO + 16 r + 2 (k % 8), the descriptor's walk
    flat = tab_ab.reshape(-1).view(torch.int16).numpy().view(np.uint16)
    c, k, b, row = np.meshgrid(np.arange(NCHUNK), np.arange(16), np.arange(8), np.arange(tc),
                               indexing="ij")
    s, r = row // P.SLICE, row % P.SLICE
    byte = ((c * (tc // P.SLICE) + s) * (8 * 2 * P.SLICE * 16) + b * P.SBO + (k // 8) * P.LBO
            + 16 * r + 2 * (k % 8))
    want = bits16(jt["aabt"])[c, k, b * tc + row]
    np.testing.assert_array_equal(flat[byte // 2], want)
    assert flat.size == NCHUNK * tc * P.AB_ROW_BYTES // 2
    # MXU, f32 rows: [Oz k0-3 | Dz k4-6, 0 | Ox32 | Dx32 | Oy32 | Dy32]
    ja = f32(jt["a32t"])
    tf = tab_f.numpy()
    for p, (ob, db) in enumerate(((0, 1), (2, 4), (3, 5))):
        for ci in range(NCHUNK):
            np.testing.assert_array_equal(tf[ci, :, 8 * p:8 * p + 4],
                                          ja[ci, 0:4, ob * tc:(ob + 1) * tc].T)
            np.testing.assert_array_equal(tf[ci, :, 8 * p + 4:8 * p + 7],
                                          ja[ci, 4:7, db * tc:(db + 1) * tc].T)
            # the terms the kernel skips are zeros of the layout
            np.testing.assert_array_equal(ja[ci, 4:8, ob * tc:(ob + 1) * tc], 0)
            np.testing.assert_array_equal(ja[ci, [0, 1, 2, 3, 7], db * tc:(db + 1) * tc], 0)
    np.testing.assert_array_equal(tf[:, :, 7::8], 0)


def test_wrappers_refuse():
    case = P.make_case(2, 48, 64, "cpu")
    a32t, aabt, o, d = case["a32t"], case["aabt"], case["o"], case["d"]
    for tc in (12, 4, 0):
        with pytest.raises(ValueError, match="multiple of 8"):
            P.mxu_body(a32t, aabt, o, d, tc)
    with pytest.raises(ValueError, match="too narrow"):
        P.mxu_body(a32t, aabt, o, d, 64)  # 8 x 64 columns of a 384-wide Aab
    with pytest.raises(ValueError, match="too narrow"):
        P.mxu_tables(a32t, aabt, 64)
    P.check_a32_layout(a32t, 48)
    bad = a32t.clone()
    bad[0, 5, 10] = 1.0  # a D term in the Oz block
    with pytest.raises(ValueError, match="outside build_tables' layout"):
        P.check_a32_layout(bad, 48)
    n_dt, n_f32, e = case["n_dt"], case["n_f32"], case["e"]
    for tc in (0, -48):
        with pytest.raises(ValueError, match="unsupported tc"):
            P.vpu_body(n_dt, n_f32, e, o, d, tc)
    with pytest.raises(ValueError, match="not whole chunks"):
        P.vpu_body(n_dt, n_f32, e, o, d, 40)


def _tf32(x):
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)  # round to nearest, ties away


def _split_body(case, product):
    """`mxu_body_plain` with its f32 product replaced by `product`."""
    tc = case["tc"]
    b32, bab = P._features(case["o"], case["d"], slice(None))
    n = b32.shape[1]
    t, u, v = torch.full((n,), 1e5), torch.zeros(n), torch.zeros(n)
    for c in range(case["a32t"].shape[0]):
        m32 = product(case["a32t"][c, :, :6 * tc], b32)
        mab = P._product(case["aabt"][c, :, :8 * tc].float(), bab)
        b3 = lambda k: m32[k * tc:(k + 1) * tc]
        ba = lambda k: mab[k * tc:(k + 1) * tc]
        t, u, v = P._tail(t, u, v, b3(0), b3(1), *(ba(k) for k in range(8)), *(b3(k)
                                                                             for k in range(2, 6)))
    return t, u, v


def _of_bar(got, want):
    hk, hp = got[0] < 1e5, want[0] < 1e5
    both = hk & hp
    dev = max(float(((a - b).abs() / (1e-5 * b.abs() + 1e-6))[both].max())
              for a, b in zip(got, want))
    return float((hk == hp).float().mean()), dev


def test_no_split_meets_the_bar():
    """The card's bar for the tensor-core body (hit agreement >= 0.9999,
    |x - plain| <= 1e-5 |plain| + 1e-6) on `chip_smoke.py`'s 2^14 rays, TC
    48, NCHUNK 1, with the f32 product (a) summed in order in f32, as the
    kernel does on the CUDA cores: equal to the plain version; (b) split
    3xTF32 (big = tf32(x), small = tf32(x - big); big big + big small +
    small big, every product exact, summed in float64 and rounded once, a
    kinder sum than the tensor cores'): past the bar; (c) correctly
    rounded: past the bar too, so no split can meet it."""
    case = P.make_case(1, 48, 1 << 14, "cpu")
    want = P.mxu_body_plain(case["a32t"], case["aabt"], case["o"], case["d"], 48)
    in_order = _split_body(case, P._product)
    assert all(torch.equal(a, b) for a, b in zip(in_order, want))

    def tf32x3(at, b):
        big_a, big_b = _tf32(at), _tf32(b)
        small_a, small_b = _tf32(at - big_a), _tf32(b - big_b)
        dd = lambda x, y: x.double().T @ y.double()
        return (dd(big_a, big_b) + dd(big_a, small_b) + dd(small_a, big_b)).float()

    exact = lambda at, b: (at.double().T @ b.double()).float()
    for name, product in (("3xTF32", tf32x3), ("rounded once", exact)):
        agree, dev = _of_bar(_split_body(case, product), want)
        assert agree >= 0.9999 and dev > 1.0, (name, agree, dev)


def test_unit_case_probe_plain():
    """The layout probe's table: every block value of the product is one
    of the ray's 16 bf16 features times 1, -1, 2 or -0.5."""
    case = P.unit_case(2, 48, 256, "cpu")
    got = P.probe_plain(case["aabt"], case["o"], case["d"], 48)  # (NC, R, 8, TC)
    _b32, bab = P._features(case["o"], case["d"], slice(None))  # (16, R)
    unit = case["aabt"][:, :, :8 * 48].float().reshape(2, 16, 8, 48)
    k = unit.abs().argmax(dim=1)  # (NC, 8, TC)
    scale = unit.gather(1, k[:, None]).squeeze(1)
    assert set(scale.unique().tolist()) <= {1.0, -1.0, 2.0, -0.5}
    want = bab.T[:, k] * scale  # (R, NC, 8, TC)
    assert torch.equal(got, want.permute(1, 0, 2, 3))
    assert float((P.run_mxu(case)[0] < 1e5).float().mean()) > 0.5
