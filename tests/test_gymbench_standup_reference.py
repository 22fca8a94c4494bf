"""The benchmark's plain reference of T1Standup
(gymbench/reference/envs/t1_standup.py) against the port's T1Standup
(booster_gym_torch/envs/standup.py) on the CPU, at 16 envs with the bank
settled for 2 control steps and the serial stand-in robot written from
booster_gym_torch.testing.

On the CPU the port's control step is the same plain loop as the
reference's copy, so from one input and one generator seed the two steps
agree to the bit, resets from the bank included.  The check itself draws
the reference's noise and resets from a generator of its own, and holds a
reset env to what a bank reset fixes whatever its draws (reset_terms),
which stays finite where the entry drawn is not.  The benchmark's check
(check_train) builds this reference from gymbench/configs/t1_standup.json,
and the limits in gymbench/limits/t1_standup_train.json pass the sound
program and fail a program whose env step leaves the state unchanged.
"""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from gymbench import calibrate, check_train, run, spec
from gymbench.reference.envs import env_class
from gymbench.reference.envs.t1_standup import T1Standup as RefStandup

from booster_gym_torch.envs.standup import T1Standup
from booster_gym_torch.testing import (
    t1_serial_mjcf_text,
    t1_serial_urdf_text,
    write_t1_serial_mjcf,
    write_t1_serial_urdf,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 16
WORKLOAD = "t1_standup_train"


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("standin")
    cfg, _ = spec.config("t1_standup")
    cfg["env"] = {**cfg["env"], "num_envs": B}
    cfg["standup"] = {**cfg["standup"], "settle_rounds": 2}
    cfg["basic"] = {**cfg["basic"], "seed": 5}
    cfg["asset"] = {**cfg["asset"], "file": write_t1_serial_urdf(tmp),
                    "mujoco_file": write_t1_serial_mjcf(tmp)}
    return cfg


@pytest.fixture(scope="module")
def program(cfg):
    """The port's env, its params with a settled bank, and a state a few
    steps on from reset_all."""
    torch.manual_seed(0)
    env = T1Standup(cfg, "cpu")
    gen = torch.Generator().manual_seed(11)
    params = env.init_params(gen)
    state, _, _ = env.reset_all(params, gen)
    for _ in range(2):
        state = env.step(params, state, _actions(gen), gen)[0]
    return env, params, state


def _actions(gen):
    # past the clip of 5 now and then
    return 3.0 * torch.randn(B, 12, generator=gen)


def _timed_out(env, state, envs):
    """`state` with `envs` past the episode's length: they reset this step."""
    length = state.episode_length.clone()
    length[envs] = env.max_episode_length + 1
    return dataclasses.replace(state, episode_length=length)


def _fields(x, prefix=""):
    if isinstance(x, torch.Tensor):
        return {prefix: x}
    out = {}
    for f in dataclasses.fields(x):
        out.update(_fields(getattr(x, f.name), f"{prefix}.{f.name}"))
    return out


def test_reference_step_is_the_ports_bitwise(cfg, program):
    """From one input and one generator seed: the sim state, the frame
    stack and every other state field, the observations, rewards and
    terminations, with four envs resetting from the bank."""
    env, params, state = program
    ref = RefStandup(cfg, "cpu")
    rp = check_train.ref_params(ref, params)
    state = _timed_out(env, state, [0, 3, 7, 12])
    act = _actions(torch.Generator().manual_seed(2))
    got = env.step(params, state, act, torch.Generator().manual_seed(9))
    want = ref.step(rp, check_train.ref_state(ref, state), act,
                    torch.Generator().manual_seed(9))
    assert got[3].tolist() == want[3].tolist() and int(got[3].sum()) >= 4
    g, w = _fields(got[0]), _fields(want[0])
    assert sorted(g) == sorted(w) and ".obs_stack" in g and ".sim.q" in g
    for name in g:
        assert torch.equal(g[name], w[name]), name
    for a, b in ((got[1], want[1]), (got[2], want[2]),
                 (got[4]["privileged_obs"], want[4]["privileged_obs"])):
        assert torch.equal(a, b)
    # the stack rolled: the input's newest frames are the output's older ones
    keep = ~got[3]
    assert torch.equal(got[0].obs_stack[keep, 1:], state.obs_stack[keep, :-1])


def test_reset_terms_of_a_bank_reset(cfg, program):
    """The check's own draws: envs that reset in both read 0 in what a bank
    reset fixes, and a reset that keeps moving reads over 1."""
    env, params, state = program
    ref = check_train.Reference(cfg, "cpu")
    rp = check_train.ref_params(ref.env, params)
    state = _timed_out(env, state, [1, 2, 9])
    act = _actions(torch.Generator().manual_seed(4))
    out = env.step(params, state, act, torch.Generator().manual_seed(6))
    want = ref.env_step(rp, state, act)
    done = out[3]
    assert done[[1, 2, 9]].all()
    gap, reset = check_train.env_gap(ref.env, out, want)
    assert float(reset.max()) == 0.0 and float(gap.max()) < 1e-6
    moving = check_train.plant("reset_moving", state, out)
    _, reset = check_train.env_gap(ref.env, moving, want)
    assert float(reset[done & (state.sim.qd.abs().amax(1) > 0)].min()) > 1e-3


def test_a_nonfinite_bank_entry_keeps_every_number_finite(cfg, program, monkeypatch):
    """A reset that draws a bank entry of NaN gives the env a NaN state;
    the step after, both sides find it non-finite and reset it.  Every
    compared number stays finite on both steps."""
    env, params, state = program
    bank = params.init_bank
    nan_bank = dataclasses.replace(bank, **{
        k: v.clone() for k, v in ((f.name, getattr(bank, f.name))
                                  for f in dataclasses.fields(bank))})
    for name in ("root_pos", "root_quat", "q"):
        getattr(nan_bank, name)[5] = float("nan")
    params = dataclasses.replace(params, init_bank=nan_bank)
    draw = env._draw_reset

    def onto_the_nan(gen, size):
        draws = draw(gen, size)
        return {**draws, "idx": torch.full_like(draws["idx"], 5)}

    monkeypatch.setattr(env, "_draw_reset", onto_the_nan)
    ref = check_train.Reference(cfg, "cpu")
    rp = check_train.ref_params(ref.env, params)
    gen = torch.Generator().manual_seed(8)
    state = _timed_out(env, state, [0, 4])
    numbers = []
    for step in range(2):
        act = _actions(gen)
        out = env.step(params, state, act, gen)
        want = ref.env_step(rp, state, act)
        gap, reset = check_train.env_gap(ref.env, out, want)
        gap = torch.maximum(gap, check_train.obs_gap(ref.env, rp, out[0], out[1],
                                                     out[4]["privileged_obs"], ref.sigmas))
        assert torch.isfinite(gap).all() and torch.isfinite(reset).all()
        assert out[3][[0, 4]].all() and want[3][[0, 4]].all()
        numbers.append((gap, out[3] != want[3], reset))
        state = out[0]
        if step == 0:
            assert not torch.isfinite(state.sim.q[[0, 4]]).any()
            assert torch.isfinite(out[1]).all() and torch.isfinite(out[2]).all()
    got = check_train.step_numbers(numbers)
    assert all(v == v and abs(v) < float("inf") for v in got.values()), got
    assert got["reset_gap"] == 0.0 and got["done_share"] == 0.0


def test_obs_sigmas_cover_the_newest_frames_noisy_columns(cfg, program):
    env, params, state = program
    ref = RefStandup(cfg, "cpu")
    obs_sig, priv_sig = ref.obs_sigmas()
    assert len(obs_sig) == 420 and len(priv_sig) == 14
    noisy = [i for i, s in enumerate(obs_sig) if s > 0]
    # gravity, angular velocity, the 12 joints' offsets and velocities
    assert noisy == list(range(30))
    assert obs_sig[:6] == [0.01] * 3 + [0.1] * 3
    rp = check_train.ref_params(ref, params)
    state, obs, priv = env._observe(params, state, torch.Generator().manual_seed(1))
    want_obs, want_priv = ref.noise_free_obs(rp, check_train.ref_state(ref, state))
    for got, want, sig in ((obs, want_obs, obs_sig), (priv, want_priv, priv_sig)):
        sig = torch.tensor(sig)
        assert torch.equal(got[:, sig == 0], want[:, sig == 0])
        assert ((got - want).abs() <= 8 * sig).all() and (got != want).any()


@pytest.fixture(scope="module")
def readings():
    """The calibration's readings of the cell at 16 envs, 3 mini-epochs and
    3 sampled steps, the bank settled for 2 control steps."""
    cell = spec.workload(spec.benchmark(), WORKLOAD)
    cfg, _ = spec.config(cell["config"])
    cfg["runner"] = {**cfg["runner"], "mini_epochs": 3}
    cfg["standup"] = {**cfg["standup"], "settle_rounds": 2}
    traffic = {**spec.traffic(cell["traffic"]), "num_envs": B, "check_steps": 3}
    return calibrate.train_seed(cfg, traffic, 2 ** 31 + 29, control=True, device="cpu")


STEP_NUMBERS = ("field_gap", "step_gap", "step_share", "done_share", "reset_gap")


def test_check_builds_the_standup_reference():
    cfg, _ = spec.config("t1_standup")
    cfg["env"] = {**cfg["env"], "num_envs": 4}
    assert env_class(cfg) is RefStandup
    ref = check_train.Reference(cfg, "cpu")
    assert type(ref.env) is RefStandup and ref.env.model.num_points == 85
    assert ref.env.model.num_dofs == 23 and ref.env.num_actions == 12
    assert ref.net.actor.layers[0].in_features == 420
    assert ref.net.critic.layers[0].in_features == 434


def test_limits_pass_the_sound_program_and_fail_a_frozen_state(readings):
    limits = spec.limits(WORKLOAD)
    sound = {k: readings["sound"][k] for k in STEP_NUMBERS}
    assert run.judge(sound, {k: limits[k] for k in STEP_NUMBERS})[0]
    # on the CPU both control steps are the one plain loop
    assert sound["step_gap"] == 0.0 and sound["step_share"] == 0.0
    unchanged = {**sound, **readings["unchanged"]}
    ok, compared = run.judge(unchanged, {k: limits[k] for k in STEP_NUMBERS})
    assert not ok and compared["step_gap"]["value"] > limits["step_gap"]
    assert compared["step_share"]["value"] > limits["step_share"]


def test_frozen_robot_is_the_stand_in():
    for ext, text in (("urdf", t1_serial_urdf_text()), ("xml", t1_serial_mjcf_text())):
        with open(os.path.join(ROOT, "gymbench", "robots", f"t1_serial_standin.{ext}"),
                  encoding="utf-8") as f:
            assert f.read() == text, ext


def test_reference_points_are_the_programs(cfg):
    from booster_gym_torch.model import load_urdf
    from booster_gym_torch.model.mjcf_points import with_mjcf_collision
    from gymbench.reference.model import load_urdf as ref_load_urdf
    from gymbench.reference.model.mjcf_points import with_mjcf_collision as ref_with

    urdf, mjcf = cfg["asset"]["file"], cfg["asset"]["mujoco_file"]
    got = ref_with(ref_load_urdf(urdf), mjcf)
    want = with_mjcf_collision(load_urdf(urdf), mjcf)
    for name in ("point_body", "point_pos", "point_radius", "point_shape", "shape_body"):
        assert (getattr(got, name) == getattr(want, name)).all(), name
    assert got.num_points == 85


BLOCKED = r'''
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "booster_gym_tpu",
                                  "booster_gym_torch"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
import torch
from gymbench import spec
from gymbench.reference.envs import tasks
from gymbench.reference.envs.t1_standup import T1Standup
cfg, _ = spec.config("t1_standup")
cfg["env"]["num_envs"] = 2
env = T1Standup(cfg, "cpu")
print("built", env.model.num_points, sorted(tasks()),
      sorted({m.split(".")[0] for m in sys.modules} & {"jax", "booster_gym_torch"}))
'''


def test_reference_imports_neither_the_program_nor_jax():
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", BLOCKED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == (
        "built 85 ['T1', 'T1Serial', 'T1Standup'] []")
