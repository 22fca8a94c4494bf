"""The port's deploy stack (booster_gym_torch/deploy) on the CPU: the
scenarios of the JAX package's deploy tests (tests/test_deploy.py,
test_teleop.py, test_native_publisher.py, test_standup_wrapper.py) run on
the port's copy, the port's Controller held bitwise to the JAX package's
on the MockRobot, and `python -m booster_gym_torch.deploy.main --mock` run
in a process where jax and booster_gym_tpu cannot be imported.

The walking policy is the repository's models/T1_walk.pt (the JAX tests'
vendor policy is not in the repository), the standup policy
models/T1_standup.pt.  The tolerances are the JAX tests' own.
"""

import asyncio
import copy
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import yaml

from booster_gym_torch.deploy import native
from booster_gym_torch.deploy.controller import Controller, ControlMode, UpperBodyMode
from booster_gym_torch.deploy.policy import (
    StandupPolicy,
    WalkPolicy,
    mirror_act_matrix,
    mirror_obs_matrix,
)
from booster_gym_torch.deploy.remote_control import ScriptedRemote
from booster_gym_torch.deploy.rotate import rotate_vector_inverse_rpy
from booster_gym_torch.deploy.sdk import NUM_JOINTS, MockRobot
from booster_gym_torch.deploy.teleop import UPPER_BODY_LIMITS, WebSocketArmClient, clip_upper_body
from booster_gym_torch.deploy.teleop_spoofer import JointTargetGenerator, serve
from booster_gym_torch.deploy.timer import Timer, TimerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_PATH = os.path.join(REPO, "booster_gym_torch", "deploy", "configs", "T1.yaml")
WALK = os.path.join(REPO, "models", "T1_walk.pt")
STANDUP = os.path.join(REPO, "models", "T1_standup.pt")


@pytest.fixture(scope="module")
def deploy_cfg():
    with open(CFG_PATH) as f:
        return yaml.safe_load(f)


def test_config_is_the_jax_config_with_policies_that_exist(deploy_cfg):
    """The JAX package's deploy config, with the policy paths pointed at
    files of the repository."""
    with open(os.path.join(REPO, "booster_gym_tpu", "deploy", "configs", "T1.yaml")) as f:
        jax_cfg = yaml.safe_load(f)
    paths = ("policy_path", "standup_policy_path")
    for k in paths:
        assert os.path.exists(os.path.join(REPO, deploy_cfg["policy"][k])), k
    strip = lambda c: {**c, "policy": {k: v for k, v in c["policy"].items() if k not in paths}}
    assert strip(deploy_cfg) == strip(jax_cfg)
    assert deploy_cfg["policy"]["policy_path"] == jax_cfg["policy"]["policy_path"]


# -- tests/test_deploy.py's scenarios -----------------------------------------
def test_rotate_inverse_rpy():
    v = rotate_vector_inverse_rpy(0.0, 0.0, np.pi / 2, np.array([1.0, 0.0, 0.0]))
    np.testing.assert_allclose(v, [0.0, -1.0, 0.0], atol=1e-9)
    v = rotate_vector_inverse_rpy(0.0, np.pi / 2, 0.0, np.array([0.0, 0.0, -1.0]))
    np.testing.assert_allclose(v, [1.0, 0.0, 0.0], atol=1e-9)


def test_timer_sim_ticks():
    t = Timer(TimerConfig(time_step=0.002))
    assert t.get_time() == 0.0
    for _ in range(500):
        t.tick_timer_if_sim()
    assert t.get_time() == pytest.approx(1.0)
    t.advance(500)
    assert t.get_time() == pytest.approx(2.0)
    t.reset()
    assert t.get_time() == 0.0


def test_mock_robot_pd_dynamics():
    robot = MockRobot(dt=0.002)
    robot.init_channels(lambda s: None)
    cmd = robot.make_low_cmd()
    cmd.motor_cmd[0].q = 0.5
    cmd.motor_cmd[0].kp = 50.0
    cmd.motor_cmd[0].kd = 5.0
    cmd.motor_cmd[1].tau = 1.0  # torque mode: kp == kd == 0
    robot.publish_low_cmd(cmd)
    robot.tick(2500)  # 5 s
    assert robot.q[0] == pytest.approx(0.5, abs=1e-3)
    assert abs(robot.dq[0]) < 1e-3
    assert robot.dq[1] == pytest.approx(1.0 / robot.damping[1], rel=0.05)
    assert robot.q[2] == 0.0


def test_mirror_matrices_are_involutions():
    mo, ma = mirror_obs_matrix(), mirror_act_matrix()
    np.testing.assert_allclose(mo @ mo, np.eye(42), atol=1e-6)
    np.testing.assert_allclose(ma @ ma, np.eye(12), atol=1e-6)


def test_walk_policy_obs_and_targets(deploy_cfg):
    pol = WalkPolicy(deploy_cfg, policy_path=WALK)
    dof_pos = np.asarray(deploy_cfg["common"]["default_qpos"], np.float32)
    targets = pol.inference(
        time_now=0.02, dof_pos=dof_pos, dof_vel=np.zeros(NUM_JOINTS, np.float32),
        base_ang_vel=np.zeros(3, np.float32),
        projected_gravity=np.array([0, 0, -1], np.float32), vx=0.3, vy=0.0, vyaw=0.0)
    assert targets.shape == (NUM_JOINTS,)
    np.testing.assert_allclose(targets[:11], dof_pos[:11])
    assert np.all(np.abs(targets[11:] - dof_pos[11:]) <= 1.0 + 1e-6)
    # command smoothing is rate-limited by the policy interval
    assert abs(pol.smoothed_commands[0]) <= pol.policy_interval + 1e-6


def test_controller_against_mock_robot(deploy_cfg):
    robot = MockRobot(dt=deploy_cfg["common"]["dt"])
    ctrl = Controller(deploy_cfg, robot, ScriptedRemote(vx=0.3, auto_start=True),
                      policy_path=WALK, sim_time=True)
    ctrl.start_custom_mode(wait=False)
    assert robot.mode_changes == ["custom"]
    ctrl.start_rl_gait(wait=False, threaded_publisher=False)
    for _ in range(50):
        robot.tick()
        ctrl.run_inference_step()
        ctrl.publish_step()
    assert len(robot.published) >= 50
    last = robot.published[-1]
    assert np.all(np.isfinite(last))
    # parallel ankles are torque-commanded: their published q is the
    # measured joint position, not the filtered target
    for i in deploy_cfg["mech"]["parallel_mech_indexes"]:
        assert last[i] == pytest.approx(robot.q[i], abs=1e-5)
    ctrl.cleanup()


def test_fall_detection_stops_controller(deploy_cfg):
    robot = MockRobot()
    ctrl = Controller(deploy_cfg, robot, ScriptedRemote(auto_start=True), policy_path=WALK,
                      sim_time=True)
    ctrl.start_custom_mode(wait=False)
    robot.rpy = np.array([1.2, 0.0, 0.0])  # fallen
    robot.tick()
    assert ctrl.running is False
    ctrl.cleanup()


def test_standup_state_machine(deploy_cfg):
    robot = MockRobot()
    remote = ScriptedRemote(auto_start=True)
    ctrl = Controller(deploy_cfg, robot, remote, policy_path=WALK, sim_time=True)
    ctrl.standup_policy = object()  # sentinel: enables the state machine
    ctrl.start_custom_mode(wait=False)
    robot.tick()
    assert ctrl.control_mode is ControlMode.NORMAL
    robot.rpy = np.array([1.2, 0.0, 0.0])
    robot.tick()
    assert ctrl.control_mode is ControlMode.IDLE  # fallen, no request yet
    remote.request_standup()
    robot.tick()
    assert ctrl.control_mode is ControlMode.STANDUP
    robot.rpy = np.zeros(3)
    robot.tick()
    assert ctrl.control_mode is ControlMode.STANDUP   # latched until the operator resets
    ctrl.cleanup()


def test_teleop_stale_freezes_arm_targets(deploy_cfg):
    class FakeClient:
        is_stale = False

        def stale(self):
            return self.is_stale

    robot = MockRobot(dt=deploy_cfg["common"]["dt"])
    ctrl = Controller(deploy_cfg, robot, ScriptedRemote(auto_start=True), policy_path=WALK,
                      sim_time=True, upper_body_mode=UpperBodyMode.TELEOP)
    client = FakeClient()
    ctrl.set_teleop_client(client)
    ctrl.start_custom_mode(wait=False)
    ctrl.start_rl_gait(wait=False, threaded_publisher=False)
    ctrl.set_upper_body_positions(np.full(10, 0.25, np.float32))
    robot.tick(10)
    ctrl.run_inference_step()
    live = ctrl.dof_target[:10].copy()
    np.testing.assert_allclose(live, 0.25, atol=1e-6)
    client.is_stale = True
    ctrl.set_upper_body_positions(np.full(10, 0.9, np.float32))
    for _ in range(10):
        robot.tick(10)
        ctrl.run_inference_step()
    np.testing.assert_allclose(ctrl.dof_target[:10], live, atol=1e-6)
    client.is_stale = False
    robot.tick(10)
    ctrl.run_inference_step()
    np.testing.assert_allclose(ctrl.dof_target[:10], 0.9, atol=1e-6)
    ctrl.cleanup()


def test_standup_policy_runs_in_controller(deploy_cfg):
    cfg = copy.deepcopy(deploy_cfg)
    cfg["policy"]["standup_policy_path"] = STANDUP
    robot = MockRobot()
    remote = ScriptedRemote(auto_start=True)
    ctrl = Controller(cfg, robot, remote, policy_path=WALK, sim_time=True, enable_standup=True,
                      standup_policy_path=STANDUP)
    ctrl.start_custom_mode(wait=False)
    robot.rpy = np.array([0.0, 1.4, 0.0])
    robot.tick()
    assert ctrl.control_mode is ControlMode.IDLE
    remote.request_standup()
    robot.tick()
    assert ctrl.control_mode is ControlMode.STANDUP
    targets = []
    for _ in range(100):           # 2 s of the 50 Hz inference loop
        robot.tick(10)
        if ctrl.run_inference_step():
            targets.append(ctrl.dof_target.copy())
        ctrl.publish_step()
    t = np.asarray(targets)
    assert len(t) >= 90 and np.all(np.isfinite(t))
    idx = cfg["policy"]["standup_joint_indices"]
    assert np.abs(t[-1, idx] - t[0, idx]).max() > 1e-4, "standup policy produced frozen targets"
    default = np.asarray(cfg["common"]["default_qpos"])
    scale = cfg["policy"]["control"]["action_scale"]
    clip = cfg["policy"]["normalization"]["standup_clip_actions"]
    assert np.all(np.abs(t[:, idx] - default[idx]) <= scale * clip + 1e-5)
    ctrl.cleanup()


# -- tests/test_standup_wrapper.py's scenarios --------------------------------
@pytest.fixture
def standup_pol(deploy_cfg):
    return StandupPolicy(deploy_cfg, policy_path=STANDUP)


def _fallen_obs_inputs(rng, t):
    dof_pos = rng.normal(0.0, 0.2, 23).astype(np.float32)
    dof_vel = rng.normal(0.0, 0.5, 23).astype(np.float32)
    gyro = rng.normal(0.0, 0.1, 3).astype(np.float32)
    return t, dof_pos, dof_vel, gyro, np.array([-0.95, 0.05, -0.3], np.float32)


def test_episode_restart_rearms_history(standup_pol):
    pol, rng = standup_pol, np.random.default_rng(0)
    for k in range(25):
        assert np.all(np.isfinite(pol.inference(*_fallen_obs_inputs(rng, 0.02 * k))))
    stack_ep1 = pol.stacked_obs.copy()
    assert np.abs(stack_ep1[0] - stack_ep1[-1]).max() > 1e-6
    pol.first_inference = True
    pol.actions[:] = 0.0
    pol.dof_targets[:] = pol.full_default
    assert np.all(np.isfinite(pol.inference(*_fallen_obs_inputs(rng, 0.0))))
    assert np.abs(pol.stacked_obs - pol.stacked_obs[0]).max() == 0.0
    assert np.abs(pol.stacked_obs[0] - stack_ep1[0]).max() > 1e-6


def test_actions_respect_clips(standup_pol):
    pol, rng = standup_pol, np.random.default_rng(1)
    n = pol.cfg["policy"]["normalization"]
    for k in range(10):
        targets = pol.inference(*_fallen_obs_inputs(rng, 0.02 * k))
        assert np.all(np.abs(pol.actions) <= n["standup_clip_actions"] + 1e-6)
        mask = np.ones(23, bool)
        mask[pol.joint_indices] = False
        np.testing.assert_array_equal(targets[mask], pol.full_default[mask])


# -- tests/test_native_publisher.py's scenarios -------------------------------
def python_publish_step(cfg, filtered, targets, measured, teleop=False):
    n = len(filtered)
    w = np.full(n, 0.8)
    if teleop:
        w[:10] = 0.9
    filtered = filtered * w + targets * (1 - w)
    q, tau, mask = filtered.copy(), np.zeros(n), np.ones(n)
    for i in cfg["mech"]["parallel_mech_indexes"]:
        q[i] = measured[i]
        tau[i] = np.clip((filtered[i] - measured[i]) * cfg["common"]["stiffness"][i],
                         -cfg["common"]["torque_limit"][i], cfg["common"]["torque_limit"][i])
        mask[i] = 0.0
    return filtered, q, tau, mask


@pytest.fixture(scope="module")
def publisher_built():
    if not native.available():
        pytest.skip("no C++ toolchain for the native publisher")
    assert native._SO.startswith(os.path.join(REPO, "build", "deploy"))
    assert os.path.exists(native._SO)


def test_native_matches_python_pipeline(deploy_cfg, publisher_built):
    rng = np.random.default_rng(0)
    pub = native.NativePublisher(deploy_cfg)
    q0 = rng.normal(0, 0.2, 23).astype(np.float32)
    pub.init_filtered(q0)
    filtered = q0.astype(np.float64).copy()
    for _ in range(20):
        targets = rng.normal(0, 0.3, 23).astype(np.float32)
        measured = rng.normal(0, 0.3, 23).astype(np.float32)
        pub.set_targets(targets, measured)
        q_c, tau_c, mask_c = pub.step()
        filtered, q_py, tau_py, mask_py = python_publish_step(deploy_cfg, filtered, targets,
                                                              measured)
        np.testing.assert_allclose(q_c, q_py, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tau_c, tau_py, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(mask_c, mask_py)


def test_paced_loop_holds_rate(deploy_cfg, publisher_built):
    pub = native.NativePublisher(deploy_cfg)
    pub.init_filtered(np.zeros(23, np.float32))
    pub.set_targets(np.zeros(23, np.float32), np.zeros(23, np.float32))
    calls = []
    t0 = time.perf_counter()
    overruns = pub.run_loop(lambda q, tau, m: calls.append(time.perf_counter()), 250)
    elapsed = time.perf_counter() - t0
    assert len(calls) == 250
    assert 0.4 < elapsed < 1.5, elapsed   # 250 periods of 2 ms, with a busy host's slack
    assert overruns < 50


# -- tests/test_teleop.py's scenarios -----------------------------------------
class StubController:
    def __init__(self):
        self.manual_upper_body_positions = np.zeros(10, np.float32)
        self.dof_pos_latest = np.zeros(23, np.float32)
        self.applied = []

    def set_upper_body_positions(self, p):
        self.applied.append(np.array(p))


class SpooferThread:
    """The spoofer server on its own asyncio loop; stoppable."""

    def __init__(self, port, mode="sine", rate_hz=200.0):
        self.port, self.mode, self.rate_hz = port, mode, rate_hz
        self.loop = self.thread = None

    def start(self):
        started = threading.Event()

        def run():
            self.loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self.loop)

            async def main():
                self.task = asyncio.ensure_future(
                    serve("127.0.0.1", self.port, self.mode, self.rate_hz))
                await asyncio.sleep(0.05)
                started.set()
                await self.task

            try:
                self.loop.run_until_complete(main())
            except (Exception, asyncio.CancelledError):
                pass
            finally:
                self.loop.close()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(5.0)

    def stop(self):
        if self.loop is not None and not self.loop.is_closed():
            self.loop.call_soon_threadsafe(self.task.cancel)
        self.thread.join(timeout=5.0)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(cond, timeout=5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.02)
    return False


def test_generator_modes_respect_limits():
    for mode in ("sine", "random", "fixed"):
        gen = JointTargetGenerator(mode=mode)
        for t in np.linspace(0, 10, 50):
            p = gen.positions_at(t)
            assert np.all(p >= UPPER_BODY_LIMITS[:, 0] - 1e-6)
            assert np.all(p <= UPPER_BODY_LIMITS[:, 1] + 1e-6)


def test_clip_upper_body():
    np.testing.assert_allclose(clip_upper_body(np.full(10, 100.0)), UPPER_BODY_LIMITS[:, 1])


def test_stream_and_reconnect():
    pytest.importorskip("websockets")
    port = _free_port()
    spoofer = SpooferThread(port)
    spoofer.start()
    ctrl = StubController()
    client = WebSocketArmClient(ctrl, uri=f"ws://127.0.0.1:{port}", backoff_initial_s=0.05,
                                backoff_max_s=0.2)
    client.start()
    try:
        assert _wait(lambda: client.session.messages >= 5)
        assert not client.stale()
        last = ctrl.applied[-1]
        assert np.all(last >= UPPER_BODY_LIMITS[:, 0] - 1e-6)
        assert np.all(last <= UPPER_BODY_LIMITS[:, 1] + 1e-6)
        assert client.session.snapshot()["connections"] == 1
        # the server dies: the client notices, the stream goes stale
        spoofer.stop()
        assert _wait(lambda: not client.session.connected)
        time.sleep(client.stale_timeout_s + 0.1)
        assert client.stale()
        # the server returns on the same port: the client reconnects by itself
        spoofer2 = SpooferThread(port)
        spoofer2.start()
        n_before = client.session.messages
        assert _wait(lambda: client.session.snapshot()["connections"] >= 2, 10.0)
        assert _wait(lambda: client.session.messages > n_before)
        assert not client.stale()
        spoofer2.stop()
    finally:
        client.stop()


def test_malformed_messages_dropped():
    ctrl = StubController()
    client = WebSocketArmClient(ctrl, uri="ws://unused")
    client._apply_targets([1.0] * 3)            # wrong shape
    client._apply_targets([float("nan")] * 10)  # non-finite
    assert client.session.dropped == 2 and client.session.messages == 0
    assert ctrl.applied == []


def test_rate_clamp_and_smoothing():
    ctrl = StubController()
    client = WebSocketArmClient(ctrl, uri="ws://unused", smoothing=1.0, max_step=0.1)
    client._apply_targets([1.0] * 10)
    assert np.all(np.abs(ctrl.applied[-1]) <= 0.1 + 1e-6)
    for _ in range(30):
        client._apply_targets([1.0] * 10)
    np.testing.assert_allclose(ctrl.applied[-1], clip_upper_body(np.ones(10)), atol=1e-5)


# -- against the JAX package's deploy stack -----------------------------------
def drive(pkg, cfg, mode, ticks=600):
    """`pkg`'s Controller (booster_gym_torch.deploy or booster_gym_tpu.deploy)
    against its MockRobot, from a ScriptedRemote under sim time: custom
    mode, the RL gait, then per 2 ms tick inference and a publish; the
    commands change at tick 250, and in sine mode the arms move.  Returns
    per tick the dof targets, the filtered targets, the robot's q and dq
    and the published q."""
    import importlib

    ctl = importlib.import_module(f"{pkg}.controller")
    remote_mod = importlib.import_module(f"{pkg}.remote_control")
    sdk = importlib.import_module(f"{pkg}.sdk")
    robot = sdk.MockRobot(dt=cfg["common"]["dt"])
    remote = remote_mod.ScriptedRemote(vx=0.3, auto_start=True)
    ctrl = ctl.Controller(copy.deepcopy(cfg), robot, remote, policy_path=WALK, sim_time=True,
                          upper_body_mode=ctl.UpperBodyMode(mode))
    ctrl.start_custom_mode(wait=False)
    ctrl.start_rl_gait(wait=False, threaded_publisher=False)
    out = {k: [] for k in ("dof_target", "filtered", "q", "dq", "published")}
    for i in range(ticks):
        if i == 250:
            remote.set_commands(0.1, -0.2, 0.4)
        if mode == "sine":
            ctrl.set_sine_upper_body_positions(np.full(10, 0.3 * np.sin(0.01 * i), np.float32))
        robot.tick()
        ctrl.run_inference_step()
        ctrl.publish_step()
        out["dof_target"].append(ctrl.dof_target.copy())
        out["filtered"].append(ctrl.filtered_dof_target.copy())
        out["q"].append(robot.q.copy())
        out["dq"].append(robot.dq.copy())
        out["published"].append(robot.published[-1].copy())
    ctrl.cleanup()
    return {k: np.stack(v) for k, v in out.items()}


@pytest.mark.parametrize("mode", ["policy", "sine"])
def test_controller_is_the_jax_controller_bitwise(deploy_cfg, mode):
    """1.2 s of control on each package's MockRobot with the same
    TorchScript policy: the dof targets, the filtered targets, the robot's
    state and every published command bitwise equal."""
    ours = drive("booster_gym_torch.deploy", deploy_cfg, mode)
    ref = drive("booster_gym_tpu.deploy", deploy_cfg, mode)
    for k in ours:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    legs = ours["dof_target"][:, 11:]
    assert np.abs(legs - np.asarray(deploy_cfg["common"]["default_qpos"])[11:]).max() > 1e-3


_NO_JAX_MAIN = r"""
import runpy, sys

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "booster_gym_tpu"):
            raise ImportError(f"{name} cannot be imported here")
        return None

sys.meta_path.insert(0, _Blocked())
sys.argv = ["booster_gym_torch.deploy.main"] + sys.argv[1:]
try:
    runpy.run_module("booster_gym_torch.deploy.main", run_name="__main__")
finally:
    bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "booster_gym_tpu"))
    print("imported of JAX:", bad)
"""


def test_deploy_main_mock_runs_where_jax_cannot_be_imported(tmp_path):
    """python -m booster_gym_torch.deploy.main --mock with the JAX CLI's
    flags, on the exported policy of a config of its own, in a process
    whose imports of jax and booster_gym_tpu raise: it runs, prints its
    summary, and the policy moved the legs."""
    with open(CFG_PATH) as f:
        cfg = yaml.safe_load(f)
    cfg["policy"]["policy_path"] = WALK
    path = tmp_path / "T1.yaml"
    path.write_text(yaml.safe_dump(cfg))
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", _NO_JAX_MAIN, "--mock", "--seconds", "1",
                          "--config", str(path)], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "imported of JAX: []" in out.stdout, out.stdout
    (line,) = [ln for ln in out.stdout.splitlines() if ln.startswith("mock run done")]
    legs = line.split("leg_target[0:4]=")[1].strip("[] ").split()
    assert any(abs(float(v)) > 1e-3 for v in legs), line


@pytest.mark.parametrize("mirror_average", [True, False])
def test_standup_policy_is_the_jax_standup_policy_bitwise(deploy_cfg, mirror_average):
    """The stacked-obs standup wrapper, with and without mirror averaging,
    on the same fallen-robot inputs: actions and targets bitwise the JAX
    package's."""
    from booster_gym_tpu.deploy.policy import StandupPolicy as JaxStandupPolicy

    cfg = copy.deepcopy(deploy_cfg)
    cfg["policy"]["standup_mirror_average"] = mirror_average
    ours, ref = StandupPolicy(cfg, policy_path=STANDUP), JaxStandupPolicy(cfg, policy_path=STANDUP)
    assert ours.mirror_average is ref.mirror_average is mirror_average
    rng = np.random.default_rng(2)
    for k in range(30):
        inputs = _fallen_obs_inputs(rng, 0.02 * k)
        np.testing.assert_array_equal(ours.inference(*inputs), ref.inference(*inputs))
        np.testing.assert_array_equal(ours.actions, ref.actions)
        np.testing.assert_array_equal(ours.stacked_obs, ref.stacked_obs)
