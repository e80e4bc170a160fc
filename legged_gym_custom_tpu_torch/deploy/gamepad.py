"""Xbox gamepad reader (copy of legged_gym_custom_tpu/deploy/gamepad.py,
reference deploy/deploy_mujoco/gamepad_reader.py:15-126).

Daemon-thread poller with deadzone interpolation and the LB+RB e-stop latch.
Gated on the optional `inputs` package; a stub returning zero commands is used
when no gamepad/library is available (CI, headless hosts).
"""
from __future__ import annotations

import threading

import numpy as np


def _interpolate(raw, old_max, new_scale, deadzone=0.01):
    ratio = raw / old_max
    if abs(ratio) < deadzone:
        return 0.0
    return ratio * new_scale


class Gamepad:
    def __init__(self, vel_scale_x=1.0, vel_scale_y=1.0, vel_scale_rot=1.0):
        self._vel_scale = (vel_scale_x, vel_scale_y, vel_scale_rot)
        self.vx = self.vy = self.wz = 0.0
        self.estop_flagged = False
        self.is_running = True
        self.lb_pressed = False
        self.rb_pressed = False
        self.jump_pressed = False
        try:
            import inputs  # noqa: F401

            self._available = bool(inputs.devices.gamepads)
        except Exception:
            self._available = False
        if self._available:
            self._thread = threading.Thread(target=self._read_loop, daemon=True)
            self._thread.start()

    def _read_loop(self):
        import inputs

        while self.is_running:
            try:
                events = inputs.get_gamepad()
            except Exception:
                continue
            for e in events:
                self._handle(e)

    def _handle(self, event):
        sx, sy, sr = self._vel_scale
        if event.code == "ABS_Y":
            self.vx = _interpolate(-event.state, 32768, sx)
        elif event.code == "ABS_X":
            self.vy = _interpolate(-event.state, 32768, sy)
        elif event.code == "ABS_RX":
            self.wz = _interpolate(-event.state, 32768, sr)
        elif event.code == "BTN_TL":
            self.lb_pressed = bool(event.state)
        elif event.code == "BTN_TR":
            self.rb_pressed = bool(event.state)
            self.jump_pressed = bool(event.state)
        # e-stop latch: LB+RB together (gamepad_reader.py:106-113)
        if self.lb_pressed and self.rb_pressed:
            self.estop_flagged = True
            self.vx = self.vy = self.wz = 0.0

    def get_command(self) -> np.ndarray:
        if self.estop_flagged:
            return np.zeros(3, np.float32)
        return np.array([self.vx, self.vy, self.wz], np.float32)

    def stop(self):
        self.is_running = False
