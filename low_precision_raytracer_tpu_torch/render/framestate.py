"""The carried frame state (port of
`low_precision_raytracer_tpu/render/framestate.py`): everything frame N
hands to frame N + 1.  The TAA history is written every frame (the
frame's colour before tonemapping) and read only when the TAA blend
runs (mix weight != 1, or `taa_force_full`).

The SVGF and TAA planes start in f32 under `svgf.state_f32` (the
default), else in the render dtype, as the JAX package holds them.  The
TAA history keeps its dtype: each frame's colour is rounded to it.  The
SVGF planes take the denoised colour's dtype from frame 1 on
(`ops/svgf_kernels.py:svgf_pair_full`), f32 in every precision, since the
direct light's f32 multipliers promote the colour; so under
`state_f32=False` only the TAA history is held in the render dtype."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from low_precision_raytracer_tpu_torch.config import RenderConfig
from low_precision_raytracer_tpu_torch.ops.svgf import SVGFState, init_svgf_state


@dataclass(frozen=True)
class FrameState:
    # SVGF per-instance temporal state (GI-coloured / GI-white)
    svgf_colored: SVGFState
    svgf_white: SVGFState
    # TAA history colour (f32 under state_f32, else the render dtype)
    taa_history: torch.Tensor  # (H, W, 3)
    # committed SVGF temporal-map frame counts
    svgf_frame_count: torch.Tensor  # (H, W) i32
    # last frame's per-pixel mesh id (-1 = empty) / primitive
    last_mesh_id: torch.Tensor  # (H, W) i32
    last_prim: torch.Tensor  # (H, W) i32
    # last frame's per-object L2W and world-to-clip, f32
    last_l2w: torch.Tensor  # (n_objects, 4, 4)
    last_w2c: torch.Tensor  # (4, 4)


def init_frame_state(cfg: RenderConfig, n_objects: int, device) -> FrameState:
    """Frame 0's state: of the whole frame, or under a row mesh
    (`cfg.mesh`) of this rank's rows (`parallel/tiling.py:shard_state`)."""
    from low_precision_raytracer_tpu_torch.parallel.tiling import active_mesh

    mesh = active_mesh(cfg.mesh)
    r0, r1 = (0, cfg.height) if mesh is None else mesh.rows(cfg.height)
    H, W = r1 - r0, cfg.width
    f32 = torch.float32
    sdt = f32 if cfg.svgf.state_f32 else cfg.prec.dtype
    eye = torch.eye(4, dtype=f32, device=device)
    return FrameState(
        svgf_colored=init_svgf_state(H, W, sdt, device),
        svgf_white=init_svgf_state(H, W, sdt, device),
        taa_history=torch.zeros((H, W, 3), dtype=sdt, device=device),
        svgf_frame_count=torch.zeros((H, W), dtype=torch.int32, device=device),
        last_mesh_id=torch.full((H, W), -1, dtype=torch.int32, device=device),
        last_prim=torch.zeros((H, W), dtype=torch.int32, device=device),
        last_l2w=eye.expand(n_objects, 4, 4).contiguous(),
        last_w2c=eye,
    )
