"""Checkpoint / resume (port of `low_precision_raytracer_tpu/render/checkpoint.py`).

The carried FrameState + the random generator's state + the frame index
serialize to one .npz, so that a sequence resumes bit for bit.  The 12
fields are the JAX package's, under its names, a bf16 leaf stored as f32
with its dtype tag; the generator's `get_state()` takes the place of the
JAX key.  `load_checkpoint` also reads a file the JAX package's
`save_checkpoint` wrote: its 12 fields (a frame's state is the only set of
parameters this system carries across), its key left aside."""

from __future__ import annotations

import numpy as np
import torch

from low_precision_raytracer_tpu_torch.config import resolve_device
from low_precision_raytracer_tpu_torch.ops.svgf import SVGFState
from low_precision_raytracer_tpu_torch.render.framestate import FrameState

# the 12 checkpoint fields, the JAX package's dotted paths: save and load
# both walk them
_FIELDS = [
    "svgf_colored.miu1", "svgf_colored.miu2", "svgf_colored.color_history",
    "svgf_white.miu1", "svgf_white.miu2", "svgf_white.color_history",
    "taa_history", "svgf_frame_count", "last_mesh_id", "last_prim",
    "last_l2w", "last_w2c",
]
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int32": torch.int32}


def _get_path(obj, dotted: str):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def save_checkpoint(path: str, state: FrameState, generator: torch.Generator,
                    frame_index: int) -> None:
    arrays = {}
    dtypes = {}
    for k in _FIELDS:
        t = _get_path(state, k).detach()
        dtypes[k] = str(t.dtype).removeprefix("torch.")
        # bf16 has no portable npz dtype: stored as f32 + its dtype tag
        arrays[k] = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    np.savez(
        path,
        __generator__=generator.get_state().numpy(),
        __generator_device__=np.asarray(generator.device.type),
        __frame_index__=np.asarray(frame_index),
        __dtypes__=np.asarray([f"{k}|{dtypes[k]}" for k in _FIELDS]),
        **arrays,
    )


def load_checkpoint(path: str, device=None):
    """-> (FrameState on `device`, generator or None, frame_index).  The
    generator comes back on `device` with its saved state; a file the JAX
    package wrote has no generator (None: its key has no counterpart
    here), so the caller keeps its own.  `device`: CUDA unless given
    (`config.resolve_device`)."""
    dev = resolve_device(device)
    z = np.load(path, allow_pickle=False)
    dtypes = dict(s.split("|") for s in z["__dtypes__"].tolist())

    def get(k):
        return torch.from_numpy(np.array(z[k])).to(device=dev, dtype=_DTYPES[dtypes[k]])

    vals = {k: get(k) for k in _FIELDS}
    state = FrameState(
        svgf_colored=SVGFState(
            miu1=vals["svgf_colored.miu1"],
            miu2=vals["svgf_colored.miu2"],
            color_history=vals["svgf_colored.color_history"],
        ),
        svgf_white=SVGFState(
            miu1=vals["svgf_white.miu1"],
            miu2=vals["svgf_white.miu2"],
            color_history=vals["svgf_white.color_history"],
        ),
        **{k: vals[k] for k in _FIELDS if "." not in k},
    )
    generator = None
    if "__generator__" in z.files:
        saved = str(z["__generator_device__"])
        if saved != dev.type:
            raise ValueError(f"{path}: a {saved} generator's state cannot resume on {dev}")
        generator = torch.Generator(device=dev)
        generator.set_state(torch.from_numpy(np.array(z["__generator__"])))
    return state, generator, int(z["__frame_index__"])
