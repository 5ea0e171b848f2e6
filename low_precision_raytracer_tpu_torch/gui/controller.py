"""Input controllers (a copy of `low_precision_raytracer_tpu/gui/controller.py`,
pure Python; reference 2.22: `rt/gui/controller.hpp`), decoupled from any
UI toolkit: callers feed key/mouse state per frame, controllers integrate
camera motion.  Usable from the web viewer or for scripted camera paths.
"""

from __future__ import annotations

import math


class MoveController:
    """Keyed accelerate-to-max integrator (`MoveController`,
    `rt/gui/controller.hpp:12-88`): a +/- key pair accelerates from
    initial_speed toward max_speed; releasing (or reversing) resets."""

    def __init__(
        self,
        initial_speed: float = 0.02,
        acceleration: float = 4.0,
        max_speed: float = 30.0,
        min_position: float = -math.inf,
        max_position: float = math.inf,
    ):
        self.initial_speed = initial_speed
        self.acceleration = acceleration
        self.max_speed = max_speed
        self.min_position = min_position
        self.max_position = max_position
        self._last_state = 0
        self._speed = 0.0
        self.accumulated_pos = 0.0

    def clear(self) -> None:
        self._speed = 0.0
        self._last_state = 0
        self.accumulated_pos = 0.0

    def get_value(self) -> float:
        return self.accumulated_pos

    def pop_value(self) -> float:
        v = self.accumulated_pos
        self.accumulated_pos = 0.0
        return v

    def receive_event(self, dt: float, plus_down: bool, minus_down: bool) -> None:
        state = 1 if plus_down else (-1 if minus_down else 0)
        if state != self._last_state or state == 0:
            self._speed = state * self.initial_speed
        self._last_state = state

        delta = 0.0
        if self._speed == self.max_speed * state:
            delta = self._speed * dt
        elif abs(self._speed + state * dt * self.acceleration) > self.max_speed:
            # this step would cross max speed: integrate the ramp then cruise.
            # t_mid is SECONDS until the crossing — the reference divides by
            # (dt * acceleration) (`rt/gui/controller.hpp:71`), a dimensionless
            # fraction it then uses as seconds, overshooting position by up to
            # hundreds of units right at the crossing; fixed here like the
            # double-add below
            t_mid = (self.max_speed - abs(self._speed)) / self.acceleration
            delta += (2 * self._speed + state * t_mid * self.acceleration) * t_mid / 2
            delta += (dt - t_mid) * self.max_speed * state
            self._speed = self.max_speed * state
        else:
            delta = (2 * self._speed + state * dt * self.acceleration) * dt / 2
            self._speed += state * dt * self.acceleration
            # (the reference double-adds the ramp segment here —
            #  `rt/gui/controller.hpp:77-82` — not reproduced)
        self.accumulated_pos += delta
        self.accumulated_pos = min(self.accumulated_pos, self.max_position)
        self.accumulated_pos = max(self.accumulated_pos, self.min_position)


class HoldRotateController:
    """Right-drag yaw/pitch with clamping + wheel FOV
    (`HoldRotateController`, `rt/gui/controller.hpp:91-175`)."""

    def __init__(self):
        self.acc_x = 0.0
        self.acc_y = 0.0
        self.acc_z = math.pi * 0.3
        self.x_sensitivity = 0.001
        self.y_sensitivity = 0.001
        self.z_sensitivity = 0.02
        self.y_min = -0.9 * math.pi / 2
        self.y_max = +0.9 * math.pi / 2
        self.z_min = math.pi * 0.2
        self.z_max = math.pi * 0.7
        self.is_down = False
        self._last = (0.0, 0.0)

    def clear(self) -> None:
        self.acc_x = 0.0
        self.acc_y = 0.0
        self.acc_z = math.pi * 0.3

    def get_xyz(self):
        return self.acc_x, self.acc_y, self.acc_z

    def _clip(self) -> None:
        # wrap yaw into (-pi, pi]; the reference tests `acc_x < M_PI`
        # (`rt/gui/controller.hpp:100`), sending EVERY in-range value
        # through +2pi then -2pi each event — fixed to the intended bound
        if self.acc_x < -math.pi:
            self.acc_x += 2 * math.pi
        if self.acc_x > math.pi:
            self.acc_x -= 2 * math.pi
        self.acc_y = min(max(self.acc_y, self.y_min), self.y_max)
        self.acc_z = min(max(self.acc_z, self.z_min), self.z_max)

    def receive_event(self, mouse_pos, right_down: bool, wheel: float = 0.0) -> None:
        x, y = mouse_pos
        if right_down and not self.is_down:
            self._last = (x, y)
            self.is_down = True
        elif not right_down:
            self.is_down = False

        if self.is_down:
            lx, ly = self._last
            self.acc_x += (x - lx) * self.x_sensitivity
            self.acc_y += (y - ly) * self.y_sensitivity
            self._last = (x, y)

        self.acc_z += self.z_sensitivity * wheel
        self._clip()
