"""PyTorch/CUDA port of `low_precision_raytracer_tpu` for NVIDIA Hopper.

Same module layout as the JAX package (config, math, models, ops,
render, utils, gui, cli); each module's docstring names the JAX module it
ports.  The package imports torch and numpy only.  Entry points run on
CUDA unless the caller passes device="cpu", where every kernel wrapper
runs its plain PyTorch version.  The command line:
`python -m low_precision_raytracer_tpu_torch.cli` (`lprt-torch`).
"""

from low_precision_raytracer_tpu_torch.config import (
    BF16,
    FP16,
    FP32,
    DemoSettings,
    Precision,
    RenderConfig,
    SVGFConfig,
    get_precision,
)

__version__ = "0.1.0"

__all__ = [
    "BF16",
    "FP16",
    "FP32",
    "DemoSettings",
    "Precision",
    "RenderConfig",
    "SVGFConfig",
    "get_precision",
    "__version__",
]
