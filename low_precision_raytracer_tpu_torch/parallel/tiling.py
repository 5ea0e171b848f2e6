"""The row-sharded frame (port of `low_precision_raytracer_tpu/parallel/tiling.py`).

The JAX package jits one program over a device mesh from one controller;
the port runs one process a shard (`torch.distributed`), since its frame
is mostly PyTorch glue launched from Python and one process would launch
each card's glue in turn.  Rank r of n owns image rows [r H / n,
(r + 1) H / n); H must divide by n.  Each rank builds the scene and the
frame tables itself (they are replicated), holds its rows of the pixel
leaves of `FrameState` (`last_l2w` and `last_w2c` whole, as
`_state_spec` replicates them), traces only its own pixels' rays and
runs the port's kernels on its own rows.  Neighbouring rows come from the
halo exchanges of `parallel/halo.py`: one for the history fetch
(`ops/reproject.py:generate_temporal_maps`), nine for the SVGF pair
(`ops/svgf_kernels.py:svgf_pair_full_sharded`), and one all-reduce of the
frame's ray and halo-miss counts.  A mesh of one rank is no mesh.

A `PixelMesh` names the rank, the mesh size, the process group (None for
the default group), the rank's device and the backend; `make_pixel_mesh`
reads them from an initialised process group or from torchrun's
`RANK` / `WORLD_SIZE` / `LOCAL_RANK`.  Nothing picks a backend or a
device on its own: under NCCL a rank takes `cuda:{LOCAL_RANK}` unless
given a device, under gloo the device the caller names (CUDA by default,
`config.resolve_device`)."""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from low_precision_raytracer_tpu_torch.config import RenderConfig

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True, eq=False)
class PixelMesh:
    """One rank's view of a row-sharded mesh."""

    rank: int
    size: int
    group: object  # a torch.distributed ProcessGroup, or None: the default group
    device: torch.device
    backend: str

    def rows(self, height: int) -> tuple[int, int]:
        """This rank's image rows [r0, r1) of a `height`-row frame."""
        if height % self.size:
            raise ValueError(f"height {height} does not divide over {self.size} ranks")
        h = height // self.size
        return self.rank * h, (self.rank + 1) * h

    def exchange(self, planes, top: int, bottom: int):
        """`halo.exchange_rows` over this mesh."""
        from low_precision_raytracer_tpu_torch.parallel.halo import exchange_rows

        return exchange_rows(planes, top, bottom, self)


def make_pixel_mesh(backend: str, device=None, group=None) -> PixelMesh:
    """This process's rank of the row mesh.  Uses the initialised process
    group (or `group`); without one, initialises the default group from
    torchrun's variables (`init_method='env://'`), and raises when they are
    not set.  `backend` must be the group's.  The device: `device`, else
    `cuda:{LOCAL_RANK}` under NCCL (LOCAL_RANK must be set), else CUDA as
    `config.resolve_device` gives it."""
    from low_precision_raytracer_tpu_torch.config import resolve_device

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError("make_pixel_mesh: no process group is initialised and "
                               "RANK / WORLD_SIZE are not set (run under torchrun, or "
                               "call torch.distributed.init_process_group first)")
        dist.init_process_group(backend, init_method="env://")
    got = dist.get_backend(group)
    if got != backend:
        raise ValueError(f"make_pixel_mesh: the process group's backend is {got!r}, "
                         f"not {backend!r}")
    if device is None and backend == "nccl":
        if "LOCAL_RANK" not in os.environ:
            raise RuntimeError("make_pixel_mesh: NCCL needs a device or LOCAL_RANK")
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    dev = resolve_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"make_pixel_mesh: NCCL needs a CUDA device, got {dev}")
        torch.cuda.set_device(dev)
    return PixelMesh(rank=dist.get_rank(group), size=dist.get_world_size(group),
                     group=group, device=dev, backend=backend)


def active_mesh(mesh):
    """The mesh to shard over: None for no mesh or a mesh of one rank."""
    return mesh if mesh is not None and mesh.size > 1 else None


def shard_rows(x, mesh: PixelMesh, dim: int = 0):
    """This rank's rows of a whole-frame tensor (rows along `dim`)."""
    r0, r1 = mesh.rows(x.shape[dim])
    return x.narrow(dim, r0, r1 - r0)


# the FrameState leaves split by rows (the rest, last_l2w and last_w2c,
# are replicated)
PIXEL_LEAVES = ("taa_history", "svgf_frame_count", "last_mesh_id", "last_prim")


def _map_state(state, fn):
    from low_precision_raytracer_tpu_torch.ops.svgf import SVGFState

    return dataclasses.replace(
        state,
        svgf_colored=SVGFState(*(fn(x) for x in state.svgf_colored)),
        svgf_white=SVGFState(*(fn(x) for x in state.svgf_white)),
        **{k: fn(getattr(state, k)) for k in PIXEL_LEAVES})


def shard_state(state, mesh: PixelMesh):
    """A whole-frame FrameState -> this rank's: its rows of the pixel
    leaves, the transforms whole."""
    return _map_state(state, lambda x: shard_rows(x, mesh).contiguous())


def gather_state(state, mesh: PixelMesh):
    """Every rank's FrameState -> the whole-frame FrameState, on every
    rank (one all-gather a pixel leaf); rank 0 can then save it
    (`render/checkpoint.py`)."""
    from low_precision_raytracer_tpu_torch.parallel.halo import all_gather_rows

    return _map_state(state, lambda x: all_gather_rows(x, mesh))


def render_frame_sharded(mesh: PixelMesh, scene, frame, state, cfg: RenderConfig,
                         uniforms=None, generator=None, taa_bits=None):
    """One frame of this rank: `render/renderer.py:render_frame` under
    `cfg.mesh = mesh`.  `state` holds this rank's rows (`shard_state`);
    `uniforms` and `taa_bits`, when given, are the whole frame's draws, of
    which the rank takes its own pixels'.  -> (image rows (h, W, 3), aux,
    the rank's new state)."""
    from low_precision_raytracer_tpu_torch.render.renderer import render_frame

    mesh.rows(cfg.height)  # raises unless the height divides
    if cfg.mesh is None:
        cfg = dataclasses.replace(cfg, mesh=mesh)
    elif cfg.mesh is not mesh:
        raise ValueError("render_frame_sharded: cfg.mesh is another mesh")
    return render_frame(scene, frame, state, cfg, uniforms=uniforms, generator=generator,
                        taa_bits=taa_bits)
