"""PyTorch port, the all-pairs route (`ops/dense.py:trace_rays_dense`,
`traversal_impl='dense'`) against the JAX package's `trace_rays_dense` on
the same tables and rays (`test_torch_traversal.make_rays`: primary rays,
rays from inside the scene box with zero and tiny direction components,
skip ids, per-ray min / max distances; on colonnade-5k the sun's shadow
rays): Cornell and colonnade-5k at fp32, bf16 and fp16 under 'both' and
'dtype'.  Bars (the walk's): fp32 tri-id agreement >= 0.9995 with t / u /
v within 1e-5 where the ids agree, bf16 and fp16 > 0.999 with rtol / atol
2e-3.  Both routes through each package's `trace` agree too, and the
route refuses a frame without a coefficient table."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import RenderConfig as JaxConfig
from low_precision_raytracer_tpu.config import get_precision as jax_precision
from low_precision_raytracer_tpu.ops.dense import trace_rays_dense as jax_dense
from low_precision_raytracer_tpu.ops.trace import trace as jax_trace
from low_precision_raytracer_tpu_torch.config import RenderConfig, get_precision
from low_precision_raytracer_tpu_torch.ops.dense import trace_rays_dense
from low_precision_raytracer_tpu_torch.ops.trace import trace
from test_torch_traversal import hold_hits, jax_tables, make_rays, port_tables

CASES = [(s, p, fb) for s in ("cornell", "colonnade-5k") for p in ("fp32", "bf16", "fp16")
         for fb in ("both", "dtype")]


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_dense_route_matches_jax(case):
    name, precision, fallback = case
    scene, frame = jax_tables(name, precision)
    r = make_rays(name, frame)
    ref = jax_dense(scene, frame, jnp.asarray(r["o"]), jnp.asarray(r["d"]),
                    prec=jax_precision(precision), fallback=fallback,
                    skip_tri=jnp.asarray(r["skip"]), min_dist=jnp.asarray(r["mind"]),
                    max_dist=jnp.asarray(r["maxd"]))
    _ts, tf = port_tables(scene, frame)
    got = trace_rays_dense(tf, torch.from_numpy(r["o"]), torch.from_numpy(r["d"]),
                           prec=get_precision(precision), fallback=fallback,
                           skip_tri=torch.from_numpy(r["skip"]),
                           min_dist=torch.from_numpy(r["mind"]),
                           max_dist=torch.from_numpy(r["maxd"]))
    got = tuple(x.numpy() for x in got)
    hold_hits(tuple(np.asarray(x) for x in ref), got, precision, False)
    hits = got[3] >= 0
    assert hits.any() and not hits.all()
    assert (got[3][hits] != r["skip"][hits]).all()


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_dense_route_through_trace(precision):
    """`trace` with traversal_impl='dense' on both sides ('auto' fallback:
    'both' on this route), any hit too (the closest hit's record)."""
    scene, frame = jax_tables("cornell", precision)
    r = make_rays("cornell", frame, seed=1)
    ts, tf = port_tables(scene, frame)
    jcfg = JaxConfig(width=16, height=16, precision=precision, traversal_impl="dense")
    cfg = RenderConfig(width=16, height=16, precision=precision, traversal_impl="dense")
    for find_any in (False, True):
        ref = jax_trace(scene, frame, jnp.asarray(r["o"]), jnp.asarray(r["d"]),
                        prec=jax_precision(precision), cfg=jcfg, find_any=find_any,
                        skip_tri=jnp.asarray(r["skip"]), min_dist=jnp.asarray(r["mind"]),
                        max_dist=jnp.asarray(r["maxd"]))
        got = trace(tf, torch.from_numpy(r["o"]), torch.from_numpy(r["d"]), cfg=cfg,
                    prec=cfg.prec, find_any=find_any, skip_tri=torch.from_numpy(r["skip"]),
                    min_dist=torch.from_numpy(r["mind"]), max_dist=torch.from_numpy(r["maxd"]),
                    scene=ts)
        hold_hits(tuple(np.asarray(x) for x in ref), tuple(x.numpy() for x in got), precision,
                  find_any)


def test_dense_route_needs_a_table():
    scene, frame = jax_tables("cornell", "bf16")
    _ts, tf = port_tables(scene, frame)
    bare = dataclasses.replace(tf, dense_n=None)
    o = torch.zeros((1, 3))
    with pytest.raises(ValueError, match="coefficient table"):
        trace_rays_dense(bare, o, o, prec=get_precision("bf16"))
