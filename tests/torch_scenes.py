"""Scenes of the port's CPU tests that spawned ranks build by name
("module:function", `parallel/launch.py:render_rank`): this module imports
only the port, so a rank that builds one imports no JAX."""

import numpy as np

from low_precision_raytracer_tpu_torch.models.hierarchy import Sampler
from low_precision_raytracer_tpu_torch.models.procedural import cornell_box_scene

# the camera's vertical travel a second: ~25 rows of a 64-row frame on
# the back wall, more on the boxes, so a frame a second moves the
# reprojection further than the 17-row halo (`ops/reproject.py:HALO_ROWS`)
PAN = 1.2


def panning_cornell_scene(sampler_cls=Sampler, scene=None):
    """The Cornell box, its camera panning up PAN units over t in [0, 1]
    and back over [1, 2]; `scene` and `sampler_cls` let the JAX package's
    own scene take the same path."""
    scene = cornell_box_scene() if scene is None else scene
    cam = scene.active_camera
    t0 = np.asarray(cam.translation, np.float32)
    up = t0 + np.array([0, PAN, 0], np.float32)
    cam.animation.translation = sampler_cls(
        times=np.array([0.0, 1.0, 2.0], np.float32), values=np.stack([t0, up, t0]))
    scene.animated = True
    return scene
