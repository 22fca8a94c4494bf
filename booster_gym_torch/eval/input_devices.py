"""Command input sources for the MuJoCo evaluation harness (the port's
own copy of booster_gym_tpu/eval/input_devices.py: numpy and pygame).

The reference drives play_mujoco with a pygame joystick (axis scaling +
deadzone) and a keyboard fallback (reference: play_mujoco.py:139-278).
Here both are CommandSource objects the viewer loop polls; the joystick
maps left stick -> (vx, vy), right stick x -> vyaw, with per-axis deadzone
and scale, triggers scaling gait frequency, and a stop button.
"""

import numpy as np


class CommandState:
    """Shared command state: velocity commands + gait frequency + flags."""

    def __init__(self, vx=0.0, vy=0.0, vyaw=0.0, gait_frequency=1.5):
        self.cmd = np.array([vx, vy, vyaw], np.float32)
        self.gait_frequency = float(gait_frequency)
        self.toggle_recording = False
        self.save_state = False
        self.load_state = False
        self.reset = False

    def pop_flag(self, name):
        v = getattr(self, name)
        setattr(self, name, False)
        return v


class KeyboardCommands:
    """Key-callback command source for mujoco.viewer.launch_passive.

    Map (reference keyboard semantics): w/s vx, a/d vy, q/e yaw,
    space stop, +/- gait frequency, z/x save/load state, r reset,
    v toggle recording."""

    def __init__(self, state: CommandState):
        self.state = state

    def __call__(self, keycode):
        c = chr(keycode).lower() if 0 <= keycode < 256 else ""
        s = self.state
        if c == "w":
            s.cmd[0] += 0.1
        elif c == "s":
            s.cmd[0] -= 0.1
        elif c == "a":
            s.cmd[1] += 0.1
        elif c == "d":
            s.cmd[1] -= 0.1
        elif c == "q":
            s.cmd[2] += 0.1
        elif c == "e":
            s.cmd[2] -= 0.1
        elif c == " ":
            s.cmd[:] = 0.0
        elif c == "=":
            s.gait_frequency = min(s.gait_frequency + 0.1, 2.0)
        elif c == "-":
            s.gait_frequency = max(s.gait_frequency - 0.1, 1.0)
        elif c == "z":
            s.save_state = True
        elif c == "x":
            s.load_state = True
        elif c == "r":
            s.reset = True
        elif c == "v":
            s.toggle_recording = True

    def poll(self):  # keyboard updates arrive via the callback
        pass


class JoystickCommands:
    """pygame joystick command source.

    Axes: 1 (left stick y, inverted) -> vx; 0 (left stick x, inverted) ->
    vy; 3 (right stick x, inverted) -> vyaw.  Per-axis deadzone then linear
    scale to the command ranges.  Buttons: 0 (A) zeroes the commands,
    1 (B) requests reset, 2 (X) toggles recording.  Trigger (axis 5 in
    [-1, 1]) scales gait frequency across [min, max]."""

    AXIS_VX, AXIS_VY, AXIS_VYAW, AXIS_GAIT = 1, 0, 3, 5
    BTN_STOP, BTN_RESET, BTN_RECORD = 0, 1, 2

    def __init__(self, state: CommandState, deadzone=0.1,
                 scale=(1.0, 0.5, 1.0), gait_range=(1.0, 2.0), index=0):
        import pygame

        self._pg = pygame
        pygame.init()
        pygame.joystick.init()
        if pygame.joystick.get_count() <= index:
            raise RuntimeError("no joystick detected")
        self.js = pygame.joystick.Joystick(index)
        self.js.init()
        self.state = state
        self.deadzone = deadzone
        self.scale = np.asarray(scale, np.float32)
        self.gait_range = gait_range
        self._record_was_down = False

    def _axis(self, idx):
        v = float(self.js.get_axis(idx))
        if abs(v) < self.deadzone:
            return 0.0
        # rescale so the command ramps from 0 at the deadzone edge
        return (v - np.sign(v) * self.deadzone) / (1.0 - self.deadzone)

    def poll(self):
        pg = self._pg
        pg.event.pump()
        s = self.state
        s.cmd[0] = -self._axis(self.AXIS_VX) * self.scale[0]
        s.cmd[1] = -self._axis(self.AXIS_VY) * self.scale[1]
        s.cmd[2] = -self._axis(self.AXIS_VYAW) * self.scale[2]
        if self.js.get_numaxes() > self.AXIS_GAIT:
            t = (float(self.js.get_axis(self.AXIS_GAIT)) + 1.0) / 2.0
            lo, hi = self.gait_range
            s.gait_frequency = lo + t * (hi - lo)
        if self.js.get_button(self.BTN_STOP):
            s.cmd[:] = 0.0
        if self.js.get_button(self.BTN_RESET):
            s.reset = True
        down = bool(self.js.get_button(self.BTN_RECORD))
        if down and not self._record_was_down:
            s.toggle_recording = True
        self._record_was_down = down


def make_command_source(state, prefer_joystick=True):
    """Joystick when present, keyboard otherwise.  Returns (source,
    key_callback_or_None)."""
    if prefer_joystick:
        try:
            src = JoystickCommands(state)
            print(f"joystick: {src.js.get_name()}")
            return src, None
        except Exception as e:
            print(f"no joystick ({e}); keyboard controls active")
    kb = KeyboardCommands(state)
    return kb, kb
