"""Operator command source: joystick (evdev) with keyboard fallback
(reference: deploy/utils/remote_control_service.py).

Thread-safe vx/vy/vyaw getters plus the mode-transition gates the
controller polls (custom-mode start, RL-gait start, standup request).  A
ScriptedRemote backend drives the controller in tests and headless evals.
"""

import threading


class RemoteControlService:
    """Base/keyboard implementation.  Subclasses override the input loop."""

    def __init__(self):
        self._lock = threading.Lock()
        self._vx = 0.0
        self._vy = 0.0
        self._vyaw = 0.0
        self._start_custom = False
        self._start_rl = False
        self._standup = False
        self._closed = False
        self._start_input_thread()

    # -- input backends -------------------------------------------------
    def _start_input_thread(self):
        try:
            self._start_joystick()
            return
        except Exception:
            pass
        try:
            self._start_keyboard()
        except Exception:
            # headless: everything is driven programmatically
            pass

    def _start_joystick(self):
        import evdev  # noqa: F401

        devices = [evdev.InputDevice(p) for p in evdev.list_devices()]
        sticks = [d for d in devices if "pad" in d.name.lower() or "joy" in d.name.lower()]
        if not sticks:
            raise RuntimeError("no joystick")
        self._device = sticks[0]
        t = threading.Thread(target=self._joystick_loop, daemon=True)
        t.start()

    def _joystick_loop(self):
        import evdev
        from evdev import ecodes

        deadzone = 0.1
        absinfo = {a[0]: a[1] for a in self._device.capabilities().get(ecodes.EV_ABS, [])}

        def scale(code, value):
            info = absinfo.get(code)
            if info is None:
                return 0.0
            span = (info.max - info.min) / 2.0
            mid = (info.max + info.min) / 2.0
            x = (value - mid) / span
            return 0.0 if abs(x) < deadzone else x

        for event in self._device.read_loop():
            if self._closed:
                return
            if event.type == ecodes.EV_ABS:
                with self._lock:
                    if event.code == ecodes.ABS_Y:
                        self._vx = -scale(event.code, event.value)
                    elif event.code == ecodes.ABS_X:
                        self._vy = -scale(event.code, event.value)
                    elif event.code == ecodes.ABS_RX:
                        self._vyaw = -scale(event.code, event.value)
            elif event.type == ecodes.EV_KEY and event.value == 1:
                with self._lock:
                    if event.code == ecodes.BTN_A:
                        self._start_custom = True
                    elif event.code == ecodes.BTN_B:
                        self._start_rl = True
                    elif event.code == ecodes.BTN_X:
                        self._standup = True

    def _start_keyboard(self):
        from sshkeyboard import listen_keyboard

        step = 0.2

        def on_press(key):
            with self._lock:
                if key == "w":
                    self._vx += step
                elif key == "s":
                    self._vx -= step
                elif key == "a":
                    self._vy += step
                elif key == "d":
                    self._vy -= step
                elif key == "q":
                    self._vyaw += step
                elif key == "e":
                    self._vyaw -= step
                elif key == "space":
                    self._vx = self._vy = self._vyaw = 0.0
                elif key == "1":
                    self._start_custom = True
                elif key == "2":
                    self._start_rl = True
                elif key == "k":
                    self._standup = True

        t = threading.Thread(
            target=lambda: listen_keyboard(on_press=on_press), daemon=True)
        t.start()

    # -- controller-facing API ------------------------------------------
    def get_vx_cmd(self):
        with self._lock:
            return self._vx

    def get_vy_cmd(self):
        with self._lock:
            return self._vy

    def get_vyaw_cmd(self):
        with self._lock:
            return self._vyaw

    def start_custom_mode(self):
        with self._lock:
            return self._start_custom

    def start_rl_gait(self):
        with self._lock:
            return self._start_rl

    def start_standup(self):
        with self._lock:
            v = self._standup
            self._standup = False
            return v

    def get_custom_mode_operation_hint(self):
        return "Press '1' (or gamepad A) to enter custom mode / prepare pose."

    def get_rl_gait_operation_hint(self):
        return "Press '2' (or gamepad B) to start the RL gait."

    def get_operation_hint(self):
        return "Drive with w/s/a/d/q/e (or left/right sticks); 'k' requests standup."

    def close(self):
        self._closed = True


class ScriptedRemote(RemoteControlService):
    """Deterministic command source for tests and headless evaluation."""

    def __init__(self, vx=0.0, vy=0.0, vyaw=0.0, auto_start=True):
        self._lock = threading.Lock()
        self._vx, self._vy, self._vyaw = vx, vy, vyaw
        self._start_custom = auto_start
        self._start_rl = auto_start
        self._standup = False
        self._closed = False

    def set_commands(self, vx, vy, vyaw):
        with self._lock:
            self._vx, self._vy, self._vyaw = vx, vy, vyaw

    def request_standup(self):
        with self._lock:
            self._standup = True
