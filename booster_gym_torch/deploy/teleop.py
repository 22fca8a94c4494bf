"""Upper-body VR teleoperation client + mock tracking source.

Re-design of the reference's WebSocket arm-teleop path (reference:
deploy/upper_body_controller.py): receive target joint positions for the 10
upper-body joints over WebSocket, clip to per-joint limits, feed them into
the Controller; stream observed joint positions back.  A MockArmTracking
source generates sine/fixed trajectories in-process for tests without VR
hardware (reference: upper_body_controller.py MockArmTrackingSystem).
"""

import json
import logging
import threading
import time

import numpy as np

logger = logging.getLogger(__name__)

# per-joint position limits for [head(2), left arm(4), right arm(4)]
UPPER_BODY_LIMITS = np.array(
    [
        [-1.57, 1.57], [-0.35, 1.22],
        [-3.31, 1.22], [-2.2, 0.0], [-2.0, 2.0], [-2.0, 0.0],
        [-3.31, 1.22], [0.0, 2.2], [-2.0, 2.0], [0.0, 2.0],
    ],
    dtype=np.float32,
)


def clip_upper_body(positions):
    p = np.asarray(positions, np.float32)[: len(UPPER_BODY_LIMITS)]
    return np.clip(p, UPPER_BODY_LIMITS[: len(p), 0], UPPER_BODY_LIMITS[: len(p), 1])


class MockArmTracking:
    """In-process tracking source: sine sweep or fixed pose at a given rate."""

    def __init__(self, controller, mode="sine", rate_hz=100.0, amplitude=0.3):
        self.controller = controller
        self.mode = mode
        self.rate_hz = rate_hz
        self.amplitude = amplitude
        self.base = controller.manual_upper_body_positions.copy()
        self._running = False
        self._thread = None

    def positions_at(self, t):
        if self.mode == "sine":
            return clip_upper_body(
                self.base + self.amplitude * np.sin(2 * np.pi * 0.2 * t))
        return clip_upper_body(self.base)

    def start(self):
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        t0 = time.time()
        while self._running:
            self.controller.set_upper_body_positions(self.positions_at(time.time() - t0))
            time.sleep(1.0 / self.rate_hz)

    def stop(self):
        self._running = False


class TeleopSession:
    """Connection/session bookkeeping for the teleop stream: message and
    reconnect counters, staleness tracking, thread-safe snapshots."""

    def __init__(self):
        self.connected = False
        self.connections = 0
        self.messages = 0
        self.dropped = 0          # messages rejected (malformed / wrong shape)
        self.last_msg_time = None
        self._lock = threading.Lock()

    def on_connect(self):
        with self._lock:
            self.connected = True
            self.connections += 1

    def on_disconnect(self):
        with self._lock:
            self.connected = False

    def on_message(self, ok=True):
        with self._lock:
            if ok:
                self.messages += 1
                self.last_msg_time = time.monotonic()
            else:
                self.dropped += 1

    def stale(self, timeout_s):
        with self._lock:
            if self.last_msg_time is None:
                return True
            return (time.monotonic() - self.last_msg_time) > timeout_s

    def snapshot(self):
        with self._lock:
            return {
                "connected": self.connected, "connections": self.connections,
                "messages": self.messages, "dropped": self.dropped,
            }


class WebSocketArmClient:
    """Connects to a VR tracking server; applies received target_positions
    to the controller (limit-clipped, EMA-smoothed, per-message rate-
    clamped) and streams back observed positions.

    Robustness semantics (reference: deploy/upper_body_controller.py's
    reconnect/session breadth, re-designed):
      * automatic reconnect with exponential backoff (capped);
      * a staleness watchdog — if no valid message arrives for
        `stale_timeout_s`, the arms hold the last safe pose rather than
        chase a dead stream (check via `stale()`, used by the Controller);
      * malformed messages are counted and dropped, never applied.
    """

    def __init__(self, controller, uri="ws://localhost:8765", stream_back=True,
                 smoothing=0.5, max_step=0.1, stale_timeout_s=0.5,
                 backoff_initial_s=0.2, backoff_max_s=5.0):
        self.controller = controller
        self.uri = uri
        self.stream_back = stream_back
        self.smoothing = smoothing          # EMA weight on the new target
        self.max_step = max_step            # rad per message, per joint
        self.stale_timeout_s = stale_timeout_s
        self.backoff_initial_s = backoff_initial_s
        self.backoff_max_s = backoff_max_s
        self.session = TeleopSession()
        self._running = False
        self._smoothed = None

    def stale(self):
        return self.session.stale(self.stale_timeout_s)

    def _apply_targets(self, raw_targets):
        try:
            t = np.asarray(raw_targets, np.float32)
            if t.shape != (len(UPPER_BODY_LIMITS),) or not np.all(np.isfinite(t)):
                raise ValueError(f"bad target shape/values {t.shape}")
        except Exception as e:
            logger.warning("dropping malformed teleop message: %s", e)
            self.session.on_message(ok=False)
            return
        target = clip_upper_body(t)
        prev = (self._smoothed if self._smoothed is not None
                else self.controller.manual_upper_body_positions)
        stepped = np.clip(target, prev - self.max_step, prev + self.max_step)
        self._smoothed = self.smoothing * stepped + (1 - self.smoothing) * prev
        self.controller.set_upper_body_positions(self._smoothed)
        self.session.on_message(ok=True)

    async def _session(self):
        import websockets

        async with websockets.connect(self.uri) as ws:
            logger.info("teleop connected to %s", self.uri)
            self.session.on_connect()
            try:
                while self._running:
                    raw = await ws.recv()
                    try:
                        msg = json.loads(raw)
                    except ValueError:
                        # a corrupt frame is a bad message, not a dead
                        # stream: count it and keep the session alive
                        logger.warning("dropping non-JSON teleop frame")
                        self.session.on_message(ok=False)
                        continue
                    if not isinstance(msg, dict):
                        self.session.on_message(ok=False)
                        continue
                    if "target_positions" in msg:
                        self._apply_targets(msg["target_positions"])
                    if self.stream_back:
                        observed = self.controller.dof_pos_latest[:10].tolist()
                        await ws.send(json.dumps({"observed_positions": observed}))
            finally:
                self.session.on_disconnect()

    def run_forever(self):
        import asyncio

        self._running = True
        backoff = self.backoff_initial_s
        while self._running:
            try:
                asyncio.run(self._session())
                backoff = self.backoff_initial_s
            except Exception as e:
                if not self._running:
                    break
                logger.warning(
                    "teleop connection lost (%s); retrying in %.1fs", e, backoff)
                time.sleep(backoff)
                backoff = min(backoff * 2, self.backoff_max_s)

    def start(self):
        """Run the client loop on a daemon thread; returns the thread."""
        th = threading.Thread(target=self.run_forever, daemon=True)
        th.start()
        return th

    def stop(self):
        self._running = False
