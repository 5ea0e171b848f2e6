"""PyTorch port, the row-sharded frame over real ranks: gloo processes on
the CPU started by `parallel/launch.py:spawn` (one torch thread a rank),
each running a rank function of the port (`render_rank`, `exchange_rank`),
so a spawned rank imports neither this module nor JAX.

- `exchange_rows` at 2, 3 and 4 ranks equals the slices of the whole
  frame, zeros past the image edges, for strips within a shard (the
  neighbour form) and longer than one (the all-gather form).
- Cornell over 4 ranks at 32 x 128, 2 frames, fp32 and bf16, fed the JAX
  package's draws: the gathered image and state equal the port's
  one-process render bit for bit, and the image reaches >= 35 dB against
  the JAX `render_frame_sharded(make_pixel_mesh(4), ...)` on the same key
  (as tests/test_sharding.py:80-93 sets it up); the launch and exchange
  counts of each rank (four exchanges and the strides' five a frame, one
  all-reduce).
- ROADMAP queue 3 G1: Cornell at 64 x 64 over 4 ranks, TAA at 0.3, the
  camera panning further a frame than the halo: anchors leave it from
  frame 1 on (the count is asserted above 0), each frame >= 35 dB
  against JAX `render_frame_sharded`; frame 0 bit for bit against the
  port, and frames 1-2 departing from the unsharded port frame at the
  pixels where the JAX sharded frame departs from the JAX unsharded one.
- A mesh of one rank renders the unsharded frame (tests/test_sharding.py:
  49-60).
- The small colonnade (`sponza_like_scene(3, 1)`) over 2 ranks, bf16, with
  its incoherent launches on the per-ray wavefront (K5's route) and on the
  packet route (K6's): bit for bit against the unsharded port
  (tests/test_sharding.py:64-77, 231-253).
- `python -m low_precision_raytracer_tpu_torch.parallel --ranks 2
  --backend gloo --device cpu` exits 0.

The one-process references run in a thread of their own: a thread's
floating-point state (denormals flushed or not) is its own, and the JAX
side leaves the main thread's set its way, where the ranks start fresh.
A frame that breaks bit for bit on an op whose result depends on its
batch size would be a ROADMAP queue 3 fault, held instead at >= 60 dB;
none does here."""

import torch_threads  # noqa: F401  (caps the CPU threads per test process)
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from low_precision_raytracer_tpu.config import RenderConfig as JaxConfig
from low_precision_raytracer_tpu.models.hierarchy import Sampler as JaxSampler
from low_precision_raytracer_tpu.models.procedural import cornell_box_scene as jax_cornell
from low_precision_raytracer_tpu.models.scene import build_scene_arrays, flatten_frame
from low_precision_raytracer_tpu.ops.trace import resolve_cfg as jax_resolve_cfg
from low_precision_raytracer_tpu.parallel.tiling import make_pixel_mesh as jax_mesh
from low_precision_raytracer_tpu.parallel.tiling import render_frame_sharded as jax_sharded
from low_precision_raytracer_tpu.render.framestate import init_frame_state as jax_state
from low_precision_raytracer_tpu.render.renderer import render_frame as jax_render_frame
from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.ops import trace as T
from low_precision_raytracer_tpu_torch.parallel.launch import (
    exchange_rank,
    render_rank,
    spawn,
    state_leaves,
)
from low_precision_raytracer_tpu_torch.render.renderer import Renderer
from test_torch_render_e2e import _jax_uniforms
from test_torch_taa import _jax_draws
from torch_scenes import panning_cornell_scene

ROOT = Path(__file__).resolve().parent.parent
PROC = "low_precision_raytracer_tpu_torch.models.procedural:"


def _in_thread(fn):
    out, err = [], []

    def go():
        try:
            out.append(fn())
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            err.append(e)

    t = threading.Thread(target=go)
    t.start()
    t.join()
    if err:
        raise err[0]
    return out[0]


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10.0 * np.log10(1.0 / mse))


def _run(n, cases, tmp_path):
    """render_rank over n gloo ranks -> each case's whole frames:
    {name: dict(images=[...], states=[{leaf: ...}], ranks=[per-rank record])}."""
    out = tmp_path / f"out{n}"
    out.mkdir()
    spawn(n, render_rank, "gloo", "cpu", args=(dict(cases=cases, out=str(out)),), threads=1)
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(n)]
    got = {}
    for case in cases:
        rec = [rk[case["name"]] for rk in ranks]
        frames = range(case["frames"])
        got[case["name"]] = dict(
            images=[torch.cat([r["images"][f] for r in rec]) for f in frames],
            states=[{k: torch.cat([r["states"][f][k] for r in rec]) for k in rec[0]["states"][f]}
                    for f in frames],
            ranks=rec)
    return got


def _reference(case, uniforms=None, taa_bits=None):
    """The port's one-process frames of a case, in a fresh thread."""
    def go():
        r = Renderer(_scene(case), RenderConfig(**case["cfg"]), device="cpu", seed=0)
        out = []
        for f in range(case["frames"]):
            image, _aux = r.render(
                time=0.0 if case.get("times") is None else case["times"][f],
                uniforms=None if uniforms is None else uniforms[f],
                taa_bits=None if taa_bits is None else taa_bits[f])
            out.append((image, {k: v.clone() for k, v in state_leaves(r.state).items()}))
        return out

    return _in_thread(go)


def _scene(case):
    import importlib

    module, fn = case["scene"].split(":")
    return getattr(importlib.import_module(module), fn)(*case.get("scene_args", ()))


def _assert_bits(got, ref, name):
    for f, (image, states) in enumerate(zip(got["images"], got["states"])):
        r_image, r_states = ref[f]
        assert torch.equal(image, r_image), f"{name} frame {f}: image"
        for k, v in r_states.items():
            assert torch.equal(torch.nan_to_num(states[k]), torch.nan_to_num(v)), \
                f"{name} frame {f}: {k}"


@pytest.mark.parametrize("n", [2, 3, 4])
def test_exchange_rows(n, tmp_path):
    """Strips within a shard (1 and 7 rows; unequal above and below) and
    longer than one (the all-gather form), against slices of the frame."""
    C, H, W = 3, 12 * n, 5
    strips = [(1, 1), (7, 3), (0, 5), (12, 12), (30, 2)]
    spawn(n, exchange_rank, "gloo", "cpu", args=(dict(
        shape=(C, H, W), seed=n, strips=strips, out=str(tmp_path)),), threads=1)
    frame = torch.rand((C, H, W), generator=torch.Generator().manual_seed(n))
    padded = torch.nn.functional.pad(frame, (0, 0, 64, 64))  # zeros past the edges
    h = H // n
    for r in range(n):
        got = torch.load(tmp_path / f"rank{r}.pt")
        for (top, bottom), (above, below) in zip(strips, got):
            r0 = 64 + r * h
            assert torch.equal(above, padded[:, r0 - top:r0]), (r, top)
            assert torch.equal(below, padded[:, r0 + h:r0 + h + bottom]), (r, bottom)


def _jax_frames(precision, n_frames, key):
    """JAX render_frame_sharded over make_pixel_mesh(4) at 32 x 128, the key
    chain of `Renderer.render`, -> (images, the port's uniforms a frame)."""
    cfg = JaxConfig(width=32, height=128, precision=precision, gi_on=True,
                    traversal_impl="dense_pallas")
    host = jax_cornell()
    scene = build_scene_arrays(host, cfg.prec, leaf_size=cfg.bvh_leaf_size)
    frame = flatten_frame(host, cfg.prec, max_direct_lights=4, width=32, height=128)
    cfg = jax_resolve_cfg(scene, frame, cfg)
    state = jax_state(cfg, len(frame.obj_layout))
    tcfg = RenderConfig(width=32, height=128, precision=precision)
    images, uniforms = [], []
    for _ in range(n_frames):
        nxt, us = _jax_uniforms(key, tcfg)
        _, sub = jax.random.split(key)
        image, _aux, state = jax_sharded(jax_mesh(4), scene, frame, state, cfg, sub)
        images.append(np.asarray(image))
        uniforms.append(us)
        key = nxt
    return images, uniforms


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_cornell_four_ranks(precision, tmp_path):
    frames = 2
    jax_images, uniforms = _jax_frames(precision, frames, jax.random.PRNGKey(3))
    us_file = tmp_path / "uniforms.pt"
    torch.save(uniforms, us_file)
    case = dict(name="cornell", scene=PROC + "cornell_box_scene", frames=frames,
                cfg=dict(width=32, height=128, precision=precision), uniforms=str(us_file))
    got = _run(4, [case], tmp_path)["cornell"]
    _assert_bits(got, _reference(case, uniforms), "cornell")
    for f, (image, ref) in enumerate(zip(got["images"], jax_images)):
        p = _psnr(image.numpy(), ref)
        assert p >= 35.0, f"frame {f}: {p:.2f} dB against JAX"
    for rec in got["ranks"]:
        for f in range(frames):
            assert rec["exchanges"][f]["calls"] == 1 + 4 + 5
            assert rec["exchanges"][f]["all_reduces"] == 1
            assert rec["exchanges"][f]["bytes"] > 0
        assert rec["n_rays"][0] == got["ranks"][0]["n_rays"][0] > 32 * 128
        # frame 0 reprojects through the initial identity matrices into a
        # history of zeros; from frame 1 a still camera's anchors stay home
        assert rec["halo_misses"][1] == 0


def test_panning_anchors_leave_the_halo(tmp_path):
    """ROADMAP queue 3 G1: Cornell at 64 x 64 over 4 ranks (16-row shards),
    bf16, TAA at 0.3, the camera panning ~25 rows a frame
    (`tests/torch_scenes.py`), so from frame 1 on anchors leave the halo
    and the fetch reads zeros there, as the JAX `_gather2x2_halo` does.
    Held: each frame >= 35 dB against the JAX `render_frame_sharded` on
    the same draws; the whole frame's halo-miss count above 0 on frames 1
    and 2; frame 0 bit for bit against the one-process port.  Frames 1
    and 2 cannot equal the one-process frame (the shards drop the history
    of the pixels whose anchors left the halo, the unsharded frame keeps
    it), so they are held pixel by pixel against what the JAX package's
    sharded frame does: where the port's sharded frame departs from its
    unsharded one by more than 1e-5 (in any channel), the JAX sharded
    frame departs from the JAX unsharded one by more than 1e-6, and the
    reverse (~1,500 and ~3,100 such pixels of 4,096; elsewhere both
    departures are last bits, below 1e-6, or none)."""
    n, size, times = 4, 64, (0.0, 1.0, 2.0)
    cfg = JaxConfig(width=size, height=size, precision="bf16", gi_on=True,
                    traversal_impl="dense_pallas", taa_mix_weight=0.3)
    host = panning_cornell_scene(JaxSampler, jax_cornell())
    scene = build_scene_arrays(host, cfg.prec, leaf_size=cfg.bvh_leaf_size)
    flat = lambda t: flatten_frame(host, cfg.prec, time=t, max_direct_lights=4,
                                   width=size, height=size)
    cfg = jax_resolve_cfg(scene, flat(0.0), cfg)
    state = unsharded = jax_state(cfg, len(flat(0.0).obj_layout))
    tcfg = RenderConfig(width=size, height=size, precision="bf16", taa_mix_weight=0.3)
    key, jax_images, jax_whole, uniforms, bits = jax.random.PRNGKey(5), [], [], [], []
    for t in times:
        nxt, us, b, _k = _jax_draws(key, tcfg)
        _, sub = jax.random.split(key)
        image, _aux, state = jax_sharded(jax_mesh(n), scene, flat(t), state, cfg, sub)
        whole, _aux, unsharded = jax_render_frame(scene, flat(t), unsharded, cfg, sub)
        jax_images.append(np.asarray(image))
        jax_whole.append(np.asarray(whole))
        uniforms.append(us)
        bits.append(b)
        key = nxt
    torch.save(uniforms, tmp_path / "uniforms.pt")
    torch.save(bits, tmp_path / "bits.pt")
    case = dict(name="pan", scene="torch_scenes:panning_cornell_scene", frames=len(times),
                times=times, cfg=dict(width=size, height=size, precision="bf16",
                                      taa_mix_weight=0.3),
                uniforms=str(tmp_path / "uniforms.pt"), taa_bits=str(tmp_path / "bits.pt"))
    got = _run(n, [case], tmp_path)["pan"]
    ref = _reference(case, uniforms, bits)
    _assert_bits(dict(images=got["images"][:1], states=got["states"][:1]), ref[:1], "pan")
    misses = got["ranks"][0]["halo_misses"]
    assert all(rec["halo_misses"] == misses for rec in got["ranks"])
    assert misses[1] > 0 and misses[2] > 0, misses
    for f, (image, jax_image) in enumerate(zip(got["images"], jax_images)):
        p = _psnr(image.numpy(), jax_image)
        assert p >= 35.0, f"frame {f}: {p:.2f} dB against JAX"
        if f:
            port_delta = np.abs(image.numpy() - ref[f][0].numpy()).max(-1)
            jax_delta = np.abs(jax_image - jax_whole[f]).max(-1)
            for a, b in ((port_delta, jax_delta), (jax_delta, port_delta)):
                lost = a > 1e-5
                assert lost.sum() > 100 and (b[lost] > 1e-6).all(), \
                    (f, int(lost.sum()), int((b[lost] <= 1e-6).sum()))


def test_one_rank_mesh_is_no_mesh(tmp_path):
    case = dict(name="cornell", scene=PROC + "cornell_box_scene", frames=2,
                cfg=dict(width=32, height=32, precision="bf16"))
    got = _run(1, [case], tmp_path)["cornell"]
    _assert_bits(got, _reference(case), "one rank")
    assert got["ranks"][0]["exchanges"][1]["calls"] == 0


@pytest.mark.parametrize("route", ["wavefront", "packet"])
def test_colonnade_two_ranks(route, tmp_path):
    kw = (dict(incoherent_impl="wavefront", wavefront_min_tris=0) if route == "wavefront"
          else dict(traversal_impl="pallas"))
    case = dict(name=route, scene=PROC + "sponza_like_scene", frames=2,
                scene_args=(3, 1, False), cfg=dict(width=32, height=32, precision="bf16", **kw))
    r = Renderer(_scene(case), RenderConfig(**case["cfg"]), device="cpu")
    if route == "wavefront":
        assert T._wavefront_route(r.frame, r.cfg, r.cfg.prec)
    else:
        assert r.cfg.traversal_impl == "pallas"
    got = _run(2, [case], tmp_path)[route]
    _assert_bits(got, _reference(case), route)


def test_dry_run_exits_zero():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    p = subprocess.run([sys.executable, "-m", "low_precision_raytracer_tpu_torch.parallel",
                        "--ranks", "2", "--backend", "gloo", "--device", "cpu"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    assert '"ok": true' in p.stdout
