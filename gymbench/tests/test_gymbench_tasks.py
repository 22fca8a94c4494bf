"""The check takes its reference env from the config's task: the registry
of reference envs, T1's layout as the reference T1's own (held to frozen
copies of what the check read before it was moved there), an unknown task
failing before set-up, and a new task's module, with a state and params of
its own, found and built with nothing else changed."""

import dataclasses
import sys
import time

import pytest
import torch

from gymbench import cells, check_train, spec, train
from gymbench.reference import envs
from gymbench.reference.envs.t1 import T1

# the check's T1 layout before it moved into the reference T1: the sigma
# per column of (obs, privileged obs) of t1_shaped.json (12 DoF, 12
# actions) and the compared state fields
FROZEN_SIGMAS = ([0.01] * 3 + [0.1] * 3 + [0.0] * 5 + [0.01] * 12 + [0.1 * 0.1] * 12
                 + [0.0] * 12,
                 [0.0] * 4 + [0.05] * 3 + [0.02] + [0.0] * 6)
FROZEN_FIELDS = ("torques", "last_dof_targets", "contact_forces", "base_lin_vel",
                 "base_ang_vel", "projected_gravity", "feet_pos", "feet_contact",
                 "terrain_height_root", "point_heights", "point_normals", "filtered_lin_vel",
                 "filtered_ang_vel")


def _cfg(terrain="plane", num_envs=16, **basic):
    cfg, _ = spec.config("t1_shaped")
    cfg["env"] = {**cfg["env"], "num_envs": num_envs}
    cfg["terrain"] = {**cfg["terrain"], "type": terrain}
    cfg["basic"] = {**cfg["basic"], "seed": 5, **basic}
    return cfg


def test_env_class_resolves_the_t1_tasks():
    assert envs.env_class(_cfg(task="T1")) is T1
    assert envs.env_class(_cfg(task="T1Serial")) is T1
    # env_class before task, as the program picks its class
    assert envs.env_class(_cfg(task="Walkabout", env_class="T1")) is T1
    with pytest.raises(KeyError, match="Walkabout"):
        envs.env_class(_cfg(task="T1", env_class="Walkabout"))


def test_an_unknown_task_fails_before_set_up(monkeypatch):
    def reached(*args, **kw):
        raise AssertionError("set-up was reached")

    monkeypatch.setattr(train, "set_up", reached)
    cell = spec.workload(spec.benchmark(), "t1_shaped_flat_train")
    traffic = spec.traffic(cell["traffic"])
    with pytest.raises(KeyError, match=r"known: \['T1', 'T1Serial'"):
        cells.train_run(cell, _cfg(task="Walkabout"), traffic, 3, 0.5, False, time.time(),
                        device="cpu")


def _frozen_env_gap(out, ref):
    """check_train.env_gap as it read before the reference T1 held its
    fields and its reset rule."""
    rel = check_train._rel
    (s, _, rew, done, _), (r, _, rew_r, done_r, _) = out, ref
    B = rew.shape[0]
    gap = torch.zeros(B)
    for name in ("root_pos", "root_quat", "root_lin_vel", "root_ang_vel", "q", "qd"):
        gap = torch.maximum(gap, rel(getattr(s.sim, name), getattr(r.sim, name), B))
    for name in FROZEN_FIELDS:
        gap = torch.maximum(gap, rel(getattr(s, name), getattr(r, name), B))
    gap = torch.where(~done & ~done_r, gap, 0.0)
    reset = s.sim.qd.abs().amax(1) + (s.episode_length != 0).float()
    reset = torch.maximum(reset, rel(s.sim.root_ang_vel, r.sim.root_ang_vel, B))
    reset = torch.maximum(reset, rel(s.projected_gravity, r.projected_gravity, B))
    height = lambda x: x.sim.root_pos[:, 2] - x.terrain_height_root
    reset = torch.maximum(reset, rel(height(s), height(r), B))
    reset = torch.where(done & done_r, reset, 0.0)
    gap = torch.maximum(torch.maximum(gap, reset), rel(rew, rew_r, B))
    return torch.where(done != done_r, check_train.OFF, gap), reset


def _jitter(x, gen):
    """A copy of a state's tensors with every float moved a little and
    every integer by up to 1."""
    if isinstance(x, torch.Tensor):
        if x.dtype.is_floating_point:
            return x + 0.05 * torch.randn(x.shape, generator=gen)
        if x.dtype == torch.bool:
            return x
        return x + torch.randint(0, 2, x.shape, generator=gen, dtype=x.dtype)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _jitter(getattr(x, f.name), gen)
                                         for f in dataclasses.fields(x)})
    return x


@pytest.mark.parametrize("terrain", ["plane", "trimesh"])
def test_the_reference_t1_holds_the_checks_layout(terrain):
    env = T1(_cfg(terrain), "cpu")
    assert env.obs_sigmas() == FROZEN_SIGMAS
    assert T1.STATE_FIELDS == FROZEN_FIELDS
    gen = torch.Generator().manual_seed(7)
    params = env.init_params(gen)
    params = dataclasses.replace(params, **env.own_params())
    state, obs, info = env.reset_all(params, gen)
    want = (obs, info["privileged_obs"])
    # with the noise left out, only the noisy columns differ, by < 8 sigma
    for got, full, sig in zip(env.noise_free_obs(params, state), want, FROZEN_SIGMAS):
        sig = torch.tensor(sig)
        assert torch.equal(got[:, sig == 0], full[:, sig == 0])
        assert ((got - full).abs() <= 8 * sig).all()
    B = obs.shape[0]
    rew = torch.rand(B, generator=gen)
    s, r = _jitter(state, gen), _jitter(state, gen)
    done, done_r = torch.rand(B, generator=gen) < 0.5, torch.rand(B, generator=gen) < 0.5
    done_r[:4] = done[:4] = True
    out, ref = (s, obs, rew, done, info), (r, obs, rew + 0.01, done_r, info)
    for got, frozen in zip(check_train.env_gap(env, out, ref), _frozen_env_gap(out, ref)):
        assert torch.equal(got, frozen)
    assert (check_train.env_gap(env, out, ref)[1][:4] > 0).all()


STACKED = '''
import dataclasses

import torch

from gymbench.reference.envs.state import EnvParams, EnvState
from gymbench.reference.envs.t1 import T1
from gymbench.reference.physics.types import SimState


@dataclasses.dataclass
class StackedState(EnvState):
    obs_stack: torch.Tensor = None


@dataclasses.dataclass
class BankParams(EnvParams):
    init_bank: SimState = None


class T1Stacked(T1):
    State = StackedState
    Params = BankParams


TASKS = {"T1Stacked": T1Stacked}
'''


@pytest.fixture
def stacked_task(tmp_path, monkeypatch):
    """A new module, t1_stacked.py, in a directory of the reference envs'
    package: a subclass of the reference T1 with a frame stack in its
    state and a bank of starts in its params, registered as T1Stacked."""
    (tmp_path / "t1_stacked.py").write_text(STACKED)
    monkeypatch.setattr(envs, "__path__", [*envs.__path__, str(tmp_path)])
    envs.tasks.cache_clear()
    yield
    envs.tasks.cache_clear()
    sys.modules.pop("gymbench.reference.envs.t1_stacked", None)


def test_a_new_tasks_module_is_what_the_check_builds(stacked_task):
    from booster_gym_torch.envs.standup import StandupParams, StandupState
    from booster_gym_torch.physics.types import SimState

    cfg = _cfg(task="T1Stacked")
    ref = check_train.Reference(cfg, "cpu")
    stacked = sys.modules["gymbench.reference.envs.t1_stacked"]
    assert type(ref.env) is stacked.T1Stacked and "T1" in envs.tasks()
    gen = torch.Generator().manual_seed(3)
    params = ref.env.init_params(gen)
    state, _, _ = ref.env.reset_all(dataclasses.replace(params, **ref.env.own_params()), gen)

    # the program's own dataclasses, with their extra fields
    as_program = lambda cls, x, **kw: cls(**{f.name: getattr(x, f.name)
                                             for f in dataclasses.fields(x)}, **kw)
    stack = torch.randn(16, 10, 42, generator=gen)
    sim = as_program(SimState, state.sim)
    program_state = as_program(StandupState, dataclasses.replace(state, sim=sim),
                               obs_stack=stack)
    got = check_train.ref_state(ref.env, program_state)
    assert type(got) is stacked.StackedState and got.obs_stack is stack
    assert type(got.sim).__module__ == "gymbench.reference.physics.types"

    program_params = as_program(StandupParams, params, init_bank=sim)
    got = check_train.ref_params(ref.env, program_params)
    assert type(got) is stacked.BankParams
    assert type(got.init_bank).__module__ == "gymbench.reference.physics.types"
    assert got.init_bank.q is sim.q and got.env_origins is ref.env.env_origins
