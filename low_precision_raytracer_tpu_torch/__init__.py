"""PyTorch/CUDA port of `low_precision_raytracer_tpu` for NVIDIA Hopper.

Same module layout as the JAX package (config, math, models, ops,
render, utils); each module's docstring names the JAX module it ports.  The
package imports torch and numpy only.  Entry points run on CUDA unless the
caller passes device="cpu", where every kernel wrapper runs its plain
PyTorch version.
"""
