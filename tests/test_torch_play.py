"""The port's play over several ranks (Runner.play on the runner's Group,
and the launcher of `python -m booster_gym_torch.play`) on the CPU.

2 ranks over gloo, each a process of booster_gym_torch.parallel.launch,
play the JAX run's model_1100.ckpt on the plane (16 global envs, 20 steps)
against 1 rank through the same launcher: rank 0's gathered trajectory is
the 1-rank trajectory bitwise, deterministic and with noise (every draw at
the global batch, sliced), and rank 1 returns None.  The ranks run with
MKL_CBWR=AUTO,STRICT, as tests/test_torch_parallel.py's do (MKL then gives
a row of a product the same bits at 8 rows as at 16).  At world size 1
play is the loop it was before it ran on the group (copied below as
`single_process_play`), bitwise.  The launcher's world size follows
booster_gym_torch.train's, with four cards stood in by monkeypatching.
"""

import copy
import os

import numpy as np
import pytest
import torch

from booster_gym_torch import play as port_play
from booster_gym_torch.parallel import launch
from booster_gym_torch.parallel.mesh import _DIST_ENV_SIGNALS
from booster_gym_torch.runner import Runner
from booster_gym_torch.testing import dp_cfg, dp_play, write_t1_shaped_urdf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CKPT = os.path.join(REPO, "logs", "2026-08-17-04-03-56", "nn", "model_1100.ckpt")
RANK_TIMEOUT_S = 300
KEYS = ("root_pos", "root_quat", "q", "rew", "done")


@pytest.fixture(autouse=True)
def _strict_mkl(monkeypatch):
    monkeypatch.setenv("MKL_CBWR", "AUTO,STRICT")


def play_cfg(urdf, num_envs=16):
    cfg = dp_cfg(urdf, num_envs=num_envs, curriculum=False)
    cfg["basic"]["checkpoint"] = JAX_CKPT
    return cfg


@pytest.fixture(scope="module")
def plays(tmp_path_factory):
    urdf = write_t1_shaped_urdf(tmp_path_factory.mktemp("urdf"))
    spec = {"cfg": play_cfg(urdf), "device": "cpu", "steps": 20, "noisy": True}
    mp = pytest.MonkeyPatch()
    mp.setenv("MKL_CBWR", "AUTO,STRICT")
    out = {}
    try:
        for world in (1, 2):
            d = tmp_path_factory.mktemp(f"world{world}")
            launch(dp_play, world, (spec, str(d)), timeout_s=RANK_TIMEOUT_S)
            out[world] = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                          for r in range(world)]
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("mode", ["deterministic", "noisy"])
def test_two_ranks_play_as_one_rank(plays, mode):
    i = ("deterministic", "noisy").index(mode)
    (one,), two = plays[1], plays[2]
    assert one["world"] == 1 and [r["world"] for r in two] == [2, 2]
    whole = one["plays"][i]
    assert two[1]["plays"][i] is None       # rank 1 returns None
    gathered = two[0]["plays"][i]
    assert sorted(gathered) == sorted(KEYS)
    for k in KEYS:
        assert gathered[k].shape == whole[k].shape and whole[k].shape[:2] == (20, 16), k
        assert gathered[k].dtype == whole[k].dtype, k
        np.testing.assert_array_equal(gathered[k], whole[k], err_msg=k)
    assert np.isfinite(whole["q"]).all() and whole["done"].dtype == np.bool_
    if mode == "noisy":
        assert not np.array_equal(whole["q"], one["plays"][0]["q"])


@torch.no_grad()
def single_process_play(runner, num_steps, deterministic):
    """Runner.play as it stood before it ran on the runner's group: one
    process, the noise drawn at the batch's own shape."""
    env_params, ts = runner._init_state()
    state, obs = ts.env_state, ts.obs
    keys = ("root_pos", "root_quat", "q", "rew", "done")
    steps = {k: [] for k in keys}
    for _ in range(num_steps):
        mu, std = runner.ppo.network.act(obs)
        act = mu if deterministic else mu + std * torch.randn(
            mu.shape, generator=runner.gen, device=runner.device)
        state, obs, rew, done, _ = runner.env.step(env_params, state, act, runner.gen)
        for k, x in zip(keys, (state.sim.root_pos, state.sim.root_quat, state.sim.q, rew, done)):
            steps[k].append(x.clone())
    arrays = {k: torch.stack(v).cpu().numpy() for k, v in steps.items()}
    return [{k: arrays[k][i] for k in keys} for i in range(len(steps["rew"]))]


@pytest.mark.parametrize("deterministic", [True, False])
def test_play_at_world_size_one_is_the_single_process_play(tmp_path, monkeypatch, deterministic):
    monkeypatch.chdir(tmp_path)
    for k in _DIST_ENV_SIGNALS:
        monkeypatch.delenv(k, raising=False)
    cfg = play_cfg(write_t1_shaped_urdf(tmp_path), num_envs=8)
    runner = Runner(copy.deepcopy(cfg), device="cpu")
    assert runner.group.world == 1
    ours = runner.play(num_steps=6, deterministic=deterministic)
    ref = single_process_play(runner, 6, deterministic)
    assert len(ours) == len(ref) == 6
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("no_data_parallel", [False, True])
def test_play_launcher_starts_a_rank_per_card(tmp_path, monkeypatch, capsys, no_data_parallel):
    """Where the machine has several cards `python -m booster_gym_torch.play`
    starts one rank per card through the launcher, with train's world size
    and messages; --no_data_parallel, and --device cpu, play in the calling
    process.  (Four cards stood in; no rank is started.)"""
    for k in _DIST_ENV_SIGNALS:
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(port_play, "play", lambda cfg, device: calls.append(("here", cfg)))
    monkeypatch.setattr(port_play, "launch", lambda fn, world, args, **kw: calls.append(
        ("launch", world, fn, args)))
    argv = ["--task=T1", "--terrain=plane", "--num_envs", "12", "--checkpoint", JAX_CKPT,
            "--asset_file", write_t1_shaped_urdf(tmp_path)]
    argv += ["--no_data_parallel"] if no_data_parallel else []
    port_play.main(argv)
    if no_data_parallel:
        ((where, cfg),) = calls
        assert where == "here" and cfg["basic"]["data_parallel"] is False
        assert "data-parallel" not in capsys.readouterr().out
    else:
        ((where, world, fn, (cfg, device)),) = calls
        assert (where, world, fn, device) == ("launch", 4, port_play.play, "cuda")
        assert cfg["basic"].get("data_parallel", True) is True
        assert "data-parallel: 4 devices x 3 envs/device" in capsys.readouterr().out
    calls.clear()
    port_play.main(argv + ["--device", "cpu"])
    assert [c[0] for c in calls] == ["here"]


def test_episode_lengths_of_a_play():
    """Each env's first episode runs from the play's start, later ones from
    the step after the env's last reset; envs with no reset are counted."""
    done = np.zeros((6, 3), bool)
    done[1, 0] = done[4, 0] = True          # env 0: 2 steps, then 3
    done[5, 1] = True                       # env 1: 6 steps; env 2 never resets
    assert port_play.episode_lengths(done) == ([2, 3, 6], 1)
    assert port_play.episode_lengths(np.zeros((4, 2), bool)) == ([], 2)


def test_num_steps_reaches_the_play(tmp_path, monkeypatch):
    """--num_steps N sets basic.play_steps, which Runner.play takes as its
    step count; without it the config has no play_steps (10 s)."""
    calls = []
    monkeypatch.setattr(port_play, "play", lambda cfg, device: calls.append(cfg))
    argv = ["--task=T1", "--terrain=plane", "--num_envs", "4", "--checkpoint", JAX_CKPT,
            "--asset_file", write_t1_shaped_urdf(tmp_path), "--device", "cpu"]
    port_play.main(argv + ["--num_steps", "7"])
    port_play.main(argv)
    assert calls[0]["basic"]["play_steps"] == 7 and "play_steps" not in calls[1]["basic"]
