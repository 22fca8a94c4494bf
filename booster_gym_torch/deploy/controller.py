"""The robot controller: inference loop + high-rate command publisher.

Re-design of the reference's two controllers (reference: deploy/deploy.py
and deploy/deploy_standup.py) as one class over the RobotInterface
abstraction:

  * low-state callback thread: IMU fall detection (|roll|,|pitch| > 1 rad),
    state capture at the inference cadence, sim-time ticking
    (deploy/deploy.py:138-156);
  * inference loop at 50 Hz: walking policy for the legs, upper body by
    policy/teleop/sine mode (deploy/deploy.py:271-334);
  * publisher loop at 500 Hz: EMA target filtering (0.8/0.2, 0.9/0.1 for
    teleop), series-parallel ankle conversion — position command becomes a
    torque command for parallel_mech_indexes (deploy/deploy.py:336-382);
  * optional standup state machine NORMAL/STANDUP/IDLE with the stacked-obs
    mirror-averaged standup policy (deploy/deploy_standup.py:150-189,
    :319-393).
"""

import enum
import logging
import threading
import time

import numpy as np

from booster_gym_torch.deploy.command import create_first_frame_rl_cmd, create_prepare_cmd
from booster_gym_torch.deploy.policy import StandupPolicy, WalkPolicy
from booster_gym_torch.deploy.rotate import rotate_vector_inverse_rpy
from booster_gym_torch.deploy.sdk import NUM_JOINTS
from booster_gym_torch.deploy.timer import Timer, TimerConfig

logger = logging.getLogger(__name__)

UPPER_BODY_INDICES = list(range(0, 10))   # head(2) + arms(8)
LOWER_BODY_INDICES = list(range(11, 23))  # legs


class ControlMode(enum.Enum):
    NORMAL = "normal"
    STANDUP = "standup"
    IDLE = "idle"


class UpperBodyMode(enum.Enum):
    POLICY = "policy"
    TELEOP = "teleop"
    SINE = "sine"


class Controller:
    def __init__(self, cfg, robot, remote, policy_path=None,
                 enable_standup=False, standup_policy_path=None,
                 upper_body_mode=UpperBodyMode.POLICY, sim_time=True,
                 use_native_publisher=False):
        self.cfg = cfg
        self.robot = robot
        self.remote = remote
        self.policy = WalkPolicy(cfg, policy_path=policy_path)
        self.standup_policy = None
        if enable_standup:
            self.standup_policy = StandupPolicy(cfg, policy_path=standup_policy_path)
        self.upper_body_mode = upper_body_mode
        self.sim_time = sim_time

        self.timer = Timer(TimerConfig(time_step=cfg["common"]["dt"]))
        self.next_inference_time = 0.0
        self.next_publish_time = 0.0

        self.base_ang_vel = np.zeros(3, np.float32)
        self.projected_gravity = np.zeros(3, np.float32)
        self.dof_pos = np.zeros(NUM_JOINTS, np.float32)
        self.dof_vel = np.zeros(NUM_JOINTS, np.float32)
        self.dof_pos_latest = np.zeros(NUM_JOINTS, np.float32)
        self.dof_target = np.zeros(NUM_JOINTS, np.float32)
        self.filtered_dof_target = np.zeros(NUM_JOINTS, np.float32)
        self.manual_upper_body_positions = np.asarray(
            cfg["common"]["default_qpos"], np.float32)[UPPER_BODY_INDICES]
        self.sine_upper_body_positions = self.manual_upper_body_positions.copy()

        self.control_mode = ControlMode.NORMAL
        self.standup_requested = False
        self.robot_fallen = False
        self.running = True
        self.publish_lock = threading.Lock()
        self.publish_runner = None
        # teleop staleness watchdog (set via set_teleop_client): when the
        # stream goes stale the arm targets are explicitly frozen instead of
        # merely happening to stop updating
        self.teleop_client = None
        self._teleop_stale_logged = False

        self.native_publisher = None
        if use_native_publisher:
            from booster_gym_torch.deploy import native

            if native.available():
                self.native_publisher = native.NativePublisher(
                    cfg, teleop_upper_body=upper_body_mode is UpperBodyMode.TELEOP)
            else:
                logger.warning(
                    "native publisher requested but no C++ toolchain; using Python loop")

        self.low_cmd = robot.make_low_cmd()
        robot.init_channels(self._low_state_handler)

    # -- state callback (SDK thread) ------------------------------------
    def _low_state_handler(self, msg):
        rpy = msg.imu_state.rpy
        self.robot_fallen = abs(rpy[0]) > 1.0 or abs(rpy[1]) > 1.0
        if self.standup_policy is None:
            if self.robot_fallen:
                logger.warning("IMU rpy too large: %s", rpy)
                self.running = False
        else:
            if self.remote.start_standup():
                self.standup_requested = True
            if self.standup_requested:
                self.control_mode = ControlMode.STANDUP
            elif self.robot_fallen:
                self.control_mode = ControlMode.IDLE
            else:
                self.control_mode = ControlMode.NORMAL

        if self.sim_time:
            self.timer.tick_timer_if_sim()
        time_now = self.timer.get_time()
        for i, motor in enumerate(msg.motor_state_serial):
            self.dof_pos_latest[i] = motor.q
        if time_now >= self.next_inference_time:
            self.projected_gravity[:] = rotate_vector_inverse_rpy(
                rpy[0], rpy[1], rpy[2], np.array([0.0, 0.0, -1.0]))
            self.base_ang_vel[:] = msg.imu_state.gyro
            for i, motor in enumerate(msg.motor_state_serial):
                self.dof_pos[i] = motor.q
                self.dof_vel[i] = motor.dq

    # -- lifecycle -------------------------------------------------------
    def start_custom_mode(self, wait=True):
        if wait:
            print(self.remote.get_custom_mode_operation_hint())
            while not self.remote.start_custom_mode():
                time.sleep(0.1)
        create_prepare_cmd(self.low_cmd, self.cfg)
        for i in range(NUM_JOINTS):
            self.dof_target[i] = self.low_cmd.motor_cmd[i].q
            self.filtered_dof_target[i] = self.low_cmd.motor_cmd[i].q
        self.robot.publish_low_cmd(self.low_cmd)
        self.robot.change_mode("custom")

    def start_rl_gait(self, wait=True, threaded_publisher=True):
        if wait:
            print(self.remote.get_rl_gait_operation_hint())
            while not self.remote.start_rl_gait():
                time.sleep(0.1)
        create_first_frame_rl_cmd(self.low_cmd, self.cfg)
        self.robot.publish_low_cmd(self.low_cmd)
        self.next_inference_time = self.timer.get_time()
        self.next_publish_time = self.timer.get_time()
        if threaded_publisher:
            self.publish_runner = threading.Thread(target=self._publish_loop, daemon=True)
            self.publish_runner.start()

    def cleanup(self):
        self.running = False
        self.remote.close()
        self.robot.close()
        if self.publish_runner is not None:
            self.publish_runner.join(timeout=1.0)

    # -- inference (50 Hz) ----------------------------------------------
    def run_inference_step(self):
        """One conditional inference step; returns True if inference ran."""
        time_now = self.timer.get_time()
        if time_now < self.next_inference_time:
            return False
        self.next_inference_time += self.policy.policy_interval

        mode = self.control_mode
        if mode == ControlMode.IDLE:
            self.dof_target[:] = self.dof_pos_latest
            return True
        if mode == ControlMode.STANDUP and self.standup_policy is not None:
            targets = self.standup_policy.inference(
                time_now, self.dof_pos, self.dof_vel,
                self.base_ang_vel, self.projected_gravity)
            self.dof_target[:] = targets
            return True

        dof_pos, dof_vel = self.dof_pos, self.dof_vel
        if self.upper_body_mode is UpperBodyMode.SINE:
            dof_pos = dof_pos.copy()
            dof_vel = dof_vel.copy()
            dof_pos[UPPER_BODY_INDICES] = self.policy.default_dof_pos[UPPER_BODY_INDICES]
            dof_vel[UPPER_BODY_INDICES] = 0.0
        targets = self.policy.inference(
            time_now, dof_pos, dof_vel, self.base_ang_vel, self.projected_gravity,
            self.remote.get_vx_cmd(), self.remote.get_vy_cmd(),
            self.remote.get_vyaw_cmd())
        for i in LOWER_BODY_INDICES:
            self.dof_target[i] = targets[i]
        if self.upper_body_mode is UpperBodyMode.TELEOP:
            if self.teleop_client is not None and self.teleop_client.stale():
                # watchdog: dead/quiet stream — hold the last applied arm
                # targets rather than chase whatever arrives next
                if not self._teleop_stale_logged:
                    logger.warning("teleop stream stale; holding arm targets")
                    self._teleop_stale_logged = True
            else:
                self._teleop_stale_logged = False
                with self.publish_lock:
                    self.dof_target[UPPER_BODY_INDICES] = self.manual_upper_body_positions
        elif self.upper_body_mode is UpperBodyMode.SINE:
            with self.publish_lock:
                self.dof_target[UPPER_BODY_INDICES] = self.sine_upper_body_positions
        else:
            for i in UPPER_BODY_INDICES:
                self.dof_target[i] = targets[i]
        return True

    def set_teleop_client(self, client):
        """Register the teleop client whose `stale()` gates arm updates."""
        self.teleop_client = client

    def set_upper_body_positions(self, positions):
        with self.publish_lock:
            self.manual_upper_body_positions[: len(positions)] = positions

    def set_sine_upper_body_positions(self, positions):
        with self.publish_lock:
            self.sine_upper_body_positions[: len(positions)] = positions

    # -- publisher (500 Hz) ----------------------------------------------
    def publish_step(self):
        """One command publish: EMA filter + parallel-ankle conversion."""
        cfg = self.cfg
        teleop = self.upper_body_mode is UpperBodyMode.TELEOP
        for i in LOWER_BODY_INDICES + [10]:
            self.filtered_dof_target[i] = (
                self.filtered_dof_target[i] * 0.8 + self.dof_target[i] * 0.2)
        w = 0.9 if teleop else 0.8
        for i in UPPER_BODY_INDICES:
            self.filtered_dof_target[i] = (
                self.filtered_dof_target[i] * w + self.dof_target[i] * (1 - w))

        for i in range(NUM_JOINTS):
            self.low_cmd.motor_cmd[i].q = float(self.filtered_dof_target[i])

        # series-parallel ankle mechanism: command torque, not position
        # (deploy/deploy.py:365-376)
        for i in cfg["mech"]["parallel_mech_indexes"]:
            m = self.low_cmd.motor_cmd[i]
            m.q = float(self.dof_pos_latest[i])
            m.tau = float(np.clip(
                (self.filtered_dof_target[i] - self.dof_pos_latest[i])
                * cfg["common"]["stiffness"][i],
                -cfg["common"]["torque_limit"][i],
                cfg["common"]["torque_limit"][i],
            ))
            m.kp = 0.0
        self.robot.publish_low_cmd(self.low_cmd)

    def _publish_loop(self):
        if self.native_publisher is not None:
            return self._publish_loop_native()
        while self.running:
            time_now = self.timer.get_time()
            if time_now < self.next_publish_time:
                time.sleep(0.001)
                continue
            self.next_publish_time += self.cfg["common"]["dt"]
            with self.publish_lock:
                self.publish_step()
            time.sleep(0.001)

    def _publish_loop_native(self):
        """Publisher loop backed by the C++ pipeline (deploy/native): the
        filtering + ankle-conversion math and the 500 Hz pacing run natively;
        Python only forwards the finished command to the robot backend."""
        pub = self.native_publisher
        pub.init_filtered(self.filtered_dof_target)
        cfg = self.cfg

        def on_command(q, tau, kp_mask):
            if not self.running:
                pub.stop()
                return
            pub.set_targets(self.dof_target, self.dof_pos_latest)
            for i in range(NUM_JOINTS):
                m = self.low_cmd.motor_cmd[i]
                m.q = float(q[i])
                m.tau = float(tau[i])
                if kp_mask[i] == 0.0:
                    m.kp = 0.0
                else:
                    m.kp = cfg["common"]["stiffness"][i]
            self.robot.publish_low_cmd(self.low_cmd)

        pub.set_targets(self.dof_target, self.dof_pos_latest)
        overruns = pub.run_loop(on_command, -1)
        logger.info("native publisher exited (%d deadline overruns)", overruns)

    def run(self):
        """Main inference loop body (call repeatedly)."""
        if not self.run_inference_step():
            time.sleep(0.001)

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.cleanup()
