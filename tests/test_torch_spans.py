"""The program's profiler spans (booster_gym_torch/utils/spans.py): off
without a profiler, one shared null context and no record_function call;
under a CPU profiler one train_iteration of a small stand-in T1 carries
each span as many times as the step runs it, nested as the step nests
(the fused update's K2, K3 and K4 once a mini-epoch each); the iteration's
outputs are bitwise the same with and without the profiler; and
T1Standup's bank is one span at set-up."""

import pytest
import torch

from booster_gym_torch.algo.ppo import flat_params
from booster_gym_torch.runner import Runner
from booster_gym_torch.testing import write_t1_shaped_urdf
from booster_gym_torch.utils import spans
from booster_gym_torch.utils.config import load_task_cfg

HORIZON = 3
ENV_PARTS = ("env.physics", "env.post_physics", "env.reward", "env.reset", "env.observe")
UPDATE_PARTS = ("ppo.gae", "ppo.grads", "ppo.opt")


def test_span_is_one_null_context_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first = spans.span("ppo.iteration", "3")
    assert all(spans.span(name) is first for name in ("env.step", "x", ""))
    with first:
        with spans.span("env.step"):
            pass


def _cfg(tmp, terrain, mini_epochs=1):
    cfg = load_task_cfg("T1")
    cfg["env"]["num_envs"] = 4
    cfg["terrain"]["type"] = terrain
    if terrain == "trimesh":
        cfg["terrain"].update(num_terrains=2, terrain_width=4.0, terrain_length=4.0,
                              border_size=2.0)
    cfg["runner"].update(horizon_length=HORIZON, mini_epochs=mini_epochs)
    cfg["basic"].update(seed=5, checkpoint=None, data_parallel=False)
    cfg["asset"]["file"] = write_t1_shaped_urdf(tmp)
    return cfg


def _iteration(cfg, profiled):
    """(outputs, host spans as (name, start, end)) of one train_iteration
    after ppo.init, under a CPU profiler or not."""
    runner = Runner(cfg, device="cpu")
    env_params, ts = runner.ppo.init(runner.gen)
    found = []
    if profiled:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            ts, metrics = runner.ppo.train_iteration(env_params, ts, runner.gen)
        found = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.name.startswith(("ppo.", "env."))]
    else:
        ts, metrics = runner.ppo.train_iteration(env_params, ts, runner.gen)
    outputs = {**metrics, "params": flat_params(runner.ppo.network), "obs": ts.obs,
               "adam_m": ts.opt.m, "lr": ts.lr, "root_pos": ts.env_state.sim.root_pos}
    return outputs, found


@pytest.fixture(scope="module", params=["plane", "trimesh"])
def runs(request, tmp_path_factory):
    cfg = _cfg(tmp_path_factory.mktemp(request.param), request.param)
    return _iteration(cfg, profiled=True), _iteration(cfg, profiled=False)


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_spans_counted_and_nested_in_one_iteration(runs):
    (_, found), _ = runs
    by = {}
    for s in found:
        by.setdefault(s[0], []).append(s)
    counts = {name: len(v) for name, v in by.items()}
    assert counts == {"ppo.iteration": 1, "ppo.rollout": 1, "ppo.update": 1,
                      **{name: 1 for name in UPDATE_PARTS},
                      **{name: HORIZON for name in ("ppo.act", "env.step", "ppo.episode_stats",
                                                    *ENV_PARTS)}}
    (it,), (roll,), (upd,) = by["ppo.iteration"], by["ppo.rollout"], by["ppo.update"]
    assert _inside(roll, it) and _inside(upd, it) and roll[2] <= upd[1]
    for name in ("ppo.act", "env.step", "ppo.episode_stats"):
        assert all(_inside(s, roll) for s in by[name])
    steps = sorted(by["env.step"], key=lambda s: s[1])
    for name in ENV_PARTS:
        for s in by[name]:
            assert sum(_inside(s, step) for step in steps) == 1, (name, s)
    # each control step: act, then the env step, then its bookkeeping
    for act, step, stats in zip(*(sorted(by[n], key=lambda s: s[1])
                                  for n in ("ppo.act", "env.step", "ppo.episode_stats"))):
        assert act[2] <= step[1] and step[2] <= stats[1]


def test_outputs_bitwise_with_and_without_the_profiler(runs):
    (traced, _), (plain, _) = runs
    assert sorted(traced) == sorted(plain)
    for k in plain:
        assert torch.equal(traced[k], plain[k]), k


def test_update_parts_open_once_per_mini_epoch_in_order(tmp_path):
    """The fused update's K2, K3 and K4 calls each sit in their own span,
    once a mini-epoch, in that order, inside ppo.update."""
    epochs = 3
    _, found = _iteration(_cfg(tmp_path, "plane", mini_epochs=epochs), profiled=True)
    (upd,) = [s for s in found if s[0] == "ppo.update"]
    parts = sorted((s for s in found if s[0] in UPDATE_PARTS), key=lambda s: s[1])
    assert [s[0] for s in parts] == list(UPDATE_PARTS) * epochs
    assert all(_inside(s, upd) for s in parts)
    assert all(a[2] <= b[1] for a, b in zip(parts, parts[1:]))


def test_bank_is_one_span_at_set_up(tmp_path):
    """T1Standup builds its bank of settled fallen states inside env.bank,
    once, in init_params; the step opens no such span."""
    from booster_gym_torch.envs.standup import T1Standup
    from booster_gym_torch.testing import write_t1_serial_mjcf, write_t1_serial_urdf

    cfg = load_task_cfg("T1Standup")
    cfg["env"]["num_envs"] = 2
    cfg["standup"]["settle_rounds"] = 1
    cfg["control"]["decimation"] = 2
    cfg["asset"].update(file=write_t1_serial_urdf(tmp_path),
                        mujoco_file=write_t1_serial_mjcf(tmp_path))
    env = T1Standup(cfg, "cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        params = env.init_params(gen)
        state, _, _ = env.reset_all(params, gen)
        env.step(params, state, torch.zeros(2, 12), gen)
    names = [e.name for e in prof.events()]
    assert names.count("env.bank") == 1 and names.count("env.step") == 1
    assert params.init_bank.q.shape == (2, 23)
