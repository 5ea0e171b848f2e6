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
- The tool's operation counts and its tensor-core body's prerequisites."""

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
    assert P.MXU_OPS_F32 == 6 * 15 + 65 and P.MXU_OPS_BF16 == 8 * 16 * 2
    with pytest.raises(ValueError, match="rows are not whole chunks"):
        P.build_tables(np.zeros((50, 9), np.float32), np.zeros((50, 3), np.float32), TC)
