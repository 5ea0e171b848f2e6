"""Interactive-viewer support (port of `low_precision_raytracer_tpu/gui/`):
the camera controllers and the browser explorer (`gui/viewer.py`); the
headless CLI (`low_precision_raytracer_tpu_torch.cli`) is the primary
interface."""

from low_precision_raytracer_tpu_torch.gui.controller import (
    HoldRotateController,
    MoveController,
)

__all__ = ["MoveController", "HoldRotateController"]
