"""SDK abstraction: one interface, three backends.

The reference talks to booster_robotics_sdk_python directly
(reference: deploy/deploy.py:8-17, :124-136).  Here the controller depends
only on RobotInterface, with:

  * SdkRobot     — the real Booster DDS SDK (imported lazily; unavailable in
                   this environment, guarded);
  * MockRobot    — an in-process robot emulator: motors track commanded
                   targets first-order, the IMU reports a configurable
                   attitude, and low-state callbacks fire at dt.  This is
                   the test-suite analog of the reference's Webots ladder
                   rung (SURVEY.md §4).

Message dataclasses replicate the SDK's LowCmd/LowState surface for the 23
serial joints so code is portable between backends.
"""

import dataclasses
import threading
from typing import Callable, List, Optional

import numpy as np

NUM_JOINTS = 23


@dataclasses.dataclass
class MotorCmd:
    q: float = 0.0
    dq: float = 0.0
    tau: float = 0.0
    kp: float = 0.0
    kd: float = 0.0
    weight: float = 0.0


@dataclasses.dataclass
class LowCmd:
    cmd_type: str = "SERIAL"
    motor_cmd: List[MotorCmd] = dataclasses.field(
        default_factory=lambda: [MotorCmd() for _ in range(NUM_JOINTS)])


@dataclasses.dataclass
class MotorState:
    q: float = 0.0
    dq: float = 0.0


@dataclasses.dataclass
class ImuState:
    rpy: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    gyro: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))


@dataclasses.dataclass
class LowState:
    imu_state: ImuState = dataclasses.field(default_factory=ImuState)
    motor_state_serial: List[MotorState] = dataclasses.field(
        default_factory=lambda: [MotorState() for _ in range(NUM_JOINTS)])


class RobotInterface:
    """What the controller needs from a robot backend."""

    def init_channels(self, low_state_handler: Callable):
        raise NotImplementedError

    def publish_low_cmd(self, cmd: LowCmd):
        raise NotImplementedError

    def change_mode(self, mode: str):
        raise NotImplementedError

    def close(self):
        raise NotImplementedError


class SdkRobot(RobotInterface):
    """Real Booster Robotics SDK backend (hardware / Webots)."""

    def __init__(self, net="127.0.0.1"):
        import booster_robotics_sdk_python as sdk  # noqa: F401

        self._sdk = sdk
        sdk.ChannelFactory.Instance().Init(0, net)
        self._publisher = None
        self._subscriber = None
        self._client = None

    def init_channels(self, low_state_handler):
        sdk = self._sdk
        self._subscriber = sdk.B1LowStateSubscriber(low_state_handler)
        self._publisher = sdk.B1LowCmdPublisher()
        self._client = sdk.B1LocoClient()
        self._subscriber.InitChannel()
        self._publisher.InitChannel()
        self._client.Init()

    def make_low_cmd(self):
        sdk = self._sdk
        cmd = sdk.LowCmd()
        cmd.cmd_type = sdk.LowCmdType.SERIAL
        cmd.motor_cmd = [sdk.MotorCmd() for _ in range(sdk.B1JointCnt)]
        return cmd

    def publish_low_cmd(self, cmd):
        self._publisher.Write(cmd)

    def change_mode(self, mode):
        sdk = self._sdk
        modes = {"custom": sdk.RobotMode.kCustom, "damping": sdk.RobotMode.kDamping}
        self._client.ChangeMode(modes[mode])

    def close(self):
        if self._publisher:
            self._publisher.CloseChannel()
        if self._subscriber:
            self._subscriber.CloseChannel()


class MockRobot(RobotInterface):
    """In-process emulator with PD-consistent joint dynamics: every joint
    is a rigid inertia driven by the same control law the firmware runs —
    tau = kp (q* - q) + kd (dq* - dq) + tau_ff — integrated semi-implicitly
    at dt.  Torque-only commands (kp == kd == 0, e.g. the parallel-ankle
    conversion, reference deploy/deploy.py:365-376) therefore produce
    physically consistent motion instead of a kinematic hack, so tests of
    the torque path validate the actual closed loop.  The IMU attitude is
    settable by tests (e.g. to trigger the fall detector); low-state
    callbacks are driven by tick()."""

    def __init__(self, dt=0.002, joint_inertia=0.05, joint_damping=0.2):
        self.dt = dt
        self.inertia = np.full(NUM_JOINTS, float(joint_inertia))
        self.damping = np.full(NUM_JOINTS, float(joint_damping))
        self.q = np.zeros(NUM_JOINTS)
        self.dq = np.zeros(NUM_JOINTS)
        self.rpy = np.zeros(3)
        self.gyro = np.zeros(3)
        self.last_cmd: Optional[LowCmd] = None
        self.published = []
        self.mode_changes = []
        self._handler = None
        self._lock = threading.Lock()

    def init_channels(self, low_state_handler):
        self._handler = low_state_handler

    def make_low_cmd(self):
        return LowCmd()

    def publish_low_cmd(self, cmd):
        with self._lock:
            self.last_cmd = cmd
            self.published.append(
                np.array([m.q for m in cmd.motor_cmd], np.float32))

    def change_mode(self, mode):
        self.mode_changes.append(mode)

    def close(self):
        pass

    def tick(self, n=1):
        """Advance the emulated robot and deliver low-state messages."""
        for _ in range(n):
            with self._lock:
                if self.last_cmd is not None:
                    mc = self.last_cmd.motor_cmd
                    q_t = np.array([m.q for m in mc])
                    dq_t = np.array([m.dq for m in mc])
                    tau_ff = np.array([m.tau for m in mc])
                    kp = np.array([m.kp for m in mc])
                    kd = np.array([m.kd for m in mc])
                    # firmware control law + rigid-inertia joint dynamics
                    tau = kp * (q_t - self.q) + kd * (dq_t - self.dq) + tau_ff
                    qdd = (tau - self.damping * self.dq) / self.inertia
                    self.dq = self.dq + self.dt * qdd
                    self.q = self.q + self.dt * self.dq
            if self._handler is not None:
                state = LowState()
                state.imu_state.rpy = self.rpy.copy()
                state.imu_state.gyro = self.gyro.copy()
                for i in range(NUM_JOINTS):
                    state.motor_state_serial[i].q = float(self.q[i])
                    state.motor_state_serial[i].dq = float(self.dq[i])
                self._handler(state)
