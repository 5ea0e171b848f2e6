"""The row-sharded frame over several GPUs (port of
`low_precision_raytracer_tpu/parallel/`): one process a shard with
`torch.distributed`, the halo exchanges of `halo.py`, the mesh and the
state's split in `tiling.py`, the ranks' launcher in `launch.py`, and
`python -m low_precision_raytracer_tpu_torch.parallel`, the counterpart of
the JAX package's `__graft_entry__.py:dryrun_multichip`."""

from low_precision_raytracer_tpu_torch.parallel.tiling import (
    PixelMesh,
    gather_state,
    make_pixel_mesh,
    render_frame_sharded,
    shard_rows,
    shard_state,
)

__all__ = ["PixelMesh", "gather_state", "make_pixel_mesh", "render_frame_sharded",
           "shard_rows", "shard_state"]
