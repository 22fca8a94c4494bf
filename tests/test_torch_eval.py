"""The port's MuJoCo evaluation, renderer and input devices
(booster_gym_torch/eval) against the JAX package's.

MujocoEval runs on the T1-shaped stand-in's MJCF, written in code
(booster_gym_torch.testing.t1_shaped_mjcf_text: 12 motors, the
`orientation` and `angular-velocity` sensors), driven by the TorchScript
walking policy models/T1_walk.pt.  Both harnesses step the same mujoco with
the same numpy and the same policy, so their trajectories must be equal
bitwise, and a restored snapshot must replay bitwise.  torch_policy (the
port's actor mean) against the JAX package's jax_policy on the JAX run's
checkpoint: one bf16 ulp, 8e-3 relative, the port's actor parity
tolerance (tests/test_torch_ppo.py).  The render tests skip without an
offscreen GL backend, as tests/test_render.py does.
"""

import copy
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from booster_gym_torch.eval import mujoco_eval
from booster_gym_torch.eval.input_devices import (
    CommandState,
    JoystickCommands,
    KeyboardCommands,
    make_command_source,
)
from booster_gym_torch.testing import write_t1_shaped_mjcf
from booster_gym_torch.utils.config import load_task_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALK = os.path.join(ROOT, "models", "T1_walk.pt")
JAX_CKPT = os.path.join(ROOT, "logs", "2026-08-17-04-03-56", "nn", "model_1100.ckpt")
TOL_ACTOR = 8e-3
COMMANDS = (0.3, 0.0, 0.0)


@pytest.fixture(scope="module")
def mjcf(tmp_path_factory):
    return write_t1_shaped_mjcf(tmp_path_factory.mktemp("mjcf"))


@pytest.fixture(scope="module")
def cfg(mjcf):
    cfg = load_task_cfg("T1")
    cfg["asset"]["mujoco_file"] = mjcf
    return cfg


def traj_equal(a, b):
    assert set(a) == set(b) == {"qpos", "qvel", "torques", "actions"}
    for k in a:
        assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k


def test_standin_mjcf_has_the_eval_layout(mjcf):
    m = mujoco.MjModel.from_xml_path(mjcf)
    assert (m.nq, m.nv, m.nu) == (19, 18, 12)
    names = [mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_ACTUATOR, i) for i in range(m.nu)]
    assert names[0] == "Left_Hip_Pitch" and names[-1] == "Right_Ankle_Roll"
    data = mujoco.MjData(m)
    assert data.sensor("orientation").data.shape == (4,)
    assert data.sensor("angular-velocity").data.shape == (3,)


def test_mujoco_eval_matches_jax_bitwise(cfg):
    from booster_gym_tpu.eval import mujoco_eval as jax_eval

    ours = mujoco_eval.MujocoEval(copy.deepcopy(cfg), mujoco_eval.torchscript_policy(WALK))
    ref = jax_eval.MujocoEval(copy.deepcopy(cfg), jax_eval.torchscript_policy(WALK))
    np.testing.assert_array_equal(ours.kp, ref.kp)
    np.testing.assert_array_equal(ours.default_dof_pos, ref.default_dof_pos)
    a = ours.run(2.0, commands=COMMANDS, gait_frequency=1.5)
    b = ref.run(2.0, commands=COMMANDS, gait_frequency=1.5)
    traj_equal(a, b)
    assert a["qpos"].shape == (1000, 19) and np.isfinite(a["qpos"]).all()
    assert np.abs(a["actions"]).max() > 0   # the policy acted


def test_restore_state_replays_bitwise(cfg):
    ev = mujoco_eval.MujocoEval(cfg, mujoco_eval.torchscript_policy(WALK))
    ev.run(0.3, commands=COMMANDS)
    snap = ev.save_state()
    first = ev.run(0.5, commands=COMMANDS)
    ev.run(0.2, commands=(0.0, 0.2, 0.1))
    ev.restore_state(snap)
    traj_equal(ev.run(0.5, commands=COMMANDS), first)
    ev.reset()
    assert ev.iteration == 0 and ev.gait_process == 0.0


def test_torch_policy_matches_jax_policy():
    import jax

    from booster_gym_tpu.algo.ppo import PPO as JaxPPO
    from booster_gym_tpu.eval.mujoco_eval import jax_policy
    from booster_gym_tpu.utils.recorder import load_checkpoint as jax_load_checkpoint

    from booster_gym_torch.algo.networks import ActorCritic
    from booster_gym_torch.algo.ppo import flat_params
    from booster_gym_torch.convert import train_state_from_jax_checkpoint
    from booster_gym_torch.utils.recorder import load_checkpoint

    cfg = load_task_cfg("T1")
    env = types.SimpleNamespace(num_actions=12, num_obs=47, num_privileged_obs=14)
    ref = jax_policy(JaxPPO(env, cfg), jax.tree.map(np.asarray,
                                                   jax_load_checkpoint(JAX_CKPT)["params"]))
    net = ActorCritic(12, 47, 14)
    net.load_state_dict(train_state_from_jax_checkpoint(net, load_checkpoint(JAX_CKPT))["params"])
    ours = mujoco_eval.torch_policy(net, flat_params(net), "cpu")
    rng = np.random.default_rng(0)
    for _ in range(8):
        obs = rng.normal(0, 1, 47).astype(np.float32)
        a, b = ours(obs), ref(obs)
        assert a.shape == (12,) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=TOL_ACTOR, atol=TOL_ACTOR)


def test_play_mujoco_cli_runs_both_policy_kinds(mjcf, capsys):
    from booster_gym_torch import play_mujoco

    args = ["--mujoco_file", mjcf, "--seconds", "0.3", "--vx", "0.3", "--device", "cpu"]
    ts = play_mujoco.main([*args, "--policy_pt", WALK])
    ck = play_mujoco.main([*args, "--checkpoint", JAX_CKPT])
    out = capsys.readouterr().out
    assert out.count("ran 0.3s") == 2 and "displacement" in out
    for traj in (ts, ck):
        assert traj["qpos"].shape == (150, 19) and np.isfinite(traj["qpos"]).all()
    assert not np.array_equal(ts["actions"], ck["actions"])   # two policies


def test_load_mjcf_adds_the_missing_ground(tmp_path):
    """A scene-less MJCF whose contact pairs name a `ground` geom it does
    not define loads with the ground inserted, as the JAX package's
    load_mjcf loads it."""
    from booster_gym_tpu.eval.mujoco_eval import load_mjcf as jax_load_mjcf

    from booster_gym_torch.testing import t1_shaped_mjcf_text

    text = t1_shaped_mjcf_text().replace(
        '<geom name="ground" type="plane" size="0 0 1" contype="0" conaffinity="1"/>', "")
    text = text.replace('<geom type="box" size="0.1115 0.05 0.02"',
                        '<geom name="left_sole" type="box" size="0.1115 0.05 0.02"', 1)
    text = text.replace("<actuator>", '<contact><pair geom1="left_sole" geom2="ground"/>'
                                      "</contact>\n<actuator>")
    path = tmp_path / "sceneless.xml"
    path.write_text(text)
    with pytest.raises(ValueError):
        mujoco.MjModel.from_xml_path(str(path))
    m, ref = mujoco_eval.load_mjcf(str(path)), jax_load_mjcf(str(path))
    assert mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_GEOM, "ground") >= 0
    assert (m.ngeom, m.npair, m.nu) == (ref.ngeom, ref.npair, ref.nu) == (ref.ngeom, 1, 12)
    np.testing.assert_array_equal(m.geom_size, ref.geom_size)


def test_quat_rotate_inverse_np_matches_the_ports_quat():
    from booster_gym_torch.math.quat import quat_rotate_inverse

    rng = np.random.default_rng(1)
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        v = rng.normal(size=3)
        ours = mujoco_eval.quat_rotate_inverse_np(q[[1, 2, 3, 0]], v)
        ref = quat_rotate_inverse(torch.as_tensor(q)[None], torch.as_tensor(v)[None])[0]
        np.testing.assert_allclose(ours, ref.numpy(), rtol=1e-12, atol=1e-12)


def test_import_without_mujoco():
    """The module, the MPC and the CLI import without mujoco (a training
    machine may have none): mujoco is imported only inside the functions."""
    code = ("import sys; sys.modules['mujoco'] = None\n"
            "import booster_gym_torch.eval.mujoco_eval, booster_gym_torch.eval.render\n"
            "import booster_gym_torch.play_mujoco, booster_gym_torch.mpc\n"
            "print('imported')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and "imported" in out.stdout, out.stderr


# ---------------------------------------------------------------------------
# the renderer
@pytest.fixture(scope="module")
def gl():
    pytest.importorskip("cv2")
    from booster_gym_torch.eval.render import _gl_available

    if not _gl_available():
        pytest.skip("no offscreen GL backend")


def standing_qpos(n):
    qpos = np.zeros((n, 19), np.float32)
    qpos[:, 2] = 0.72
    qpos[:, 3] = 1.0
    qpos[:, 0] = np.linspace(0.0, 1.0, n)   # walk the camera target forward
    return qpos


def test_render_states_to_video_end_to_end(gl, mjcf, tmp_path):
    import cv2

    from booster_gym_torch.eval.render import render_states_to_video

    n = 12
    out = str(tmp_path / "clip.mp4")
    path = render_states_to_video(mjcf, standing_qpos(n), out, fps=25, width=160, height=120,
                                  workers=2)
    assert path == out and os.path.getsize(out) > 0
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == n
    assert cap.get(cv2.CAP_PROP_FPS) == pytest.approx(25.0)
    ok, frame = cap.read()
    assert ok and frame.shape == (120, 160, 3)
    assert (frame > 0).sum() > 100   # rendered content, not black
    cap.release()


def test_render_trajectory_of_a_play_run(gl, cfg, tmp_path):
    """render_trajectory on Runner.play's per-step dicts: one frame per
    control step, at the control rate."""
    import cv2

    from booster_gym_torch.eval.render import render_trajectory

    qpos = standing_qpos(6)
    traj = [{"root_pos": np.stack([q[:3], q[:3] + 1]), "root_quat": np.stack([q[3:7]] * 2),
             "q": np.zeros((2, 12), np.float32), "rew": np.zeros(2)} for q in qpos]
    path = render_trajectory(cfg, traj, env_idx=0, out_dir=str(tmp_path / "videos"))
    cap = cv2.VideoCapture(path)
    assert os.path.dirname(path) == str(tmp_path / "videos")
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 6
    assert cap.get(cv2.CAP_PROP_FPS) == pytest.approx(50.0)
    cap.release()


# ---------------------------------------------------------------------------
# the input devices (tests/test_input_devices.py, on the port's copy)
def test_keyboard_map():
    s = CommandState()
    kb = KeyboardCommands(s)
    for c in "wwa":
        kb(ord(c))
    np.testing.assert_allclose(s.cmd, [0.2, 0.1, 0.0], atol=1e-6)
    kb(ord("e"))
    assert s.cmd[2] == pytest.approx(-0.1)
    kb(ord(" "))
    np.testing.assert_allclose(s.cmd, 0.0)
    kb(ord("="))
    assert s.gait_frequency == pytest.approx(1.6)
    kb(ord("v"))
    assert s.pop_flag("toggle_recording") is True
    assert s.pop_flag("toggle_recording") is False
    kb(ord("r"))
    assert s.pop_flag("reset") is True


def test_joystick_requires_hardware():
    # no joystick here: constructing must raise so make_command_source
    # falls back to the keyboard
    s = CommandState()
    with pytest.raises(Exception):
        JoystickCommands(s)
    src, key_cb = make_command_source(s, prefer_joystick=True)
    assert isinstance(src, KeyboardCommands)
    assert key_cb is src


class _FakeJoystick:
    """A deterministic pygame.joystick.Joystick stand-in."""

    def __init__(self, axes, buttons):
        self.axes = axes
        self.buttons = buttons

    def get_axis(self, i):
        return self.axes[i]

    def get_numaxes(self):
        return len(self.axes)

    def get_button(self, i):
        return self.buttons[i]


def test_joystick_mapping_deadzone_and_buttons():
    s = CommandState()
    js = JoystickCommands.__new__(JoystickCommands)
    js.state = s
    js.deadzone = 0.1
    js.scale = np.array([1.0, 0.5, 1.0], np.float32)
    js.gait_range = (1.0, 2.0)
    js._record_was_down = False
    js._pg = types.SimpleNamespace(event=types.SimpleNamespace(pump=lambda: None))
    # half-forward stick (axis 1 = -0.55 after inversion -> +vx), small
    # sideways inside the deadzone, full trigger
    js.js = _FakeJoystick(axes=[0.05, -0.55, 0.0, 0.0, 0.0, 1.0], buttons=[0, 0, 0])
    js.poll()
    assert s.cmd[0] == pytest.approx((0.55 - 0.1) / 0.9, rel=1e-5)
    assert s.cmd[1] == 0.0
    assert s.gait_frequency == pytest.approx(2.0)
    # the stop button zeroes the commands; the record button triggers once
    # per press
    js.js = _FakeJoystick(axes=[0.0, -1.0, 0.0, 0.0, 0.0, -1.0], buttons=[1, 0, 1])
    js.poll()
    np.testing.assert_allclose(s.cmd, 0.0)
    assert s.pop_flag("toggle_recording") is True
    js.poll()
    assert s.pop_flag("toggle_recording") is False
