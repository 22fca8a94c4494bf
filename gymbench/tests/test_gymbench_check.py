"""The comparison that decides `correct`, at a size a CPU test holds: the
plain reference against the port's plain path (the port's kernels run
their plain versions on the CPU), the control (the reference in fp8 in the
program's place) coming out not correct, and a whole run of a cell with
the timed path broken underneath coming out not correct, once for each
fault the cell can have."""

import time

import pytest
import torch

from gymbench import calibrate, cells, check_train, run, spec, train
from gymbench.reference.envs import env_class

TRAIN = "t1_shaped_flat_train"


def _train_cell(name=TRAIN):
    cell = spec.workload(spec.benchmark(), name)
    cfg, _ = spec.config(cell["config"])
    cfg["runner"] = {**cfg["runner"], "mini_epochs": 3}
    traffic = {**spec.traffic(cell["traffic"]), "num_envs": 16, "check_steps": 3}
    return cell, cfg, traffic


@pytest.fixture(scope="module")
def readings():
    cell, cfg, traffic = _train_cell()
    return calibrate.train_seed(cfg, traffic, 2 ** 31 + 11, control=True, device="cpu")


def test_reference_follows_the_plain_path(readings):
    sound = readings["sound"]
    # on the CPU the port's control step is the same plain loop as the
    # reference's copy, so the env step agrees to the bit
    assert sound["field_gap"] == 0.0 and sound["step_gap"] == 0.0
    assert sound["step_share"] == 0.0 and sound["done_share"] == 0.0
    assert sound["reset_gap"] == 0.0
    # the fused update's plain version against the autograd update, bf16
    assert sound["loss_gap"] < 0.05 and sound["grad_gap"] < 0.05
    assert sound["change_gap"] < 0.05


def test_control_is_not_correct(readings):
    limits = spec.limits(TRAIN)
    control = readings["control"]
    assert not run.judge({**readings["sound"], **control}, limits)[0]
    assert control["loss_gap"] > 3 * readings["sound"]["loss_gap"]


def _run_train(monkeypatch=None):
    cell, cfg, traffic = _train_cell()
    result = cells.train_run(cell, cfg, traffic, 3, 0.5, False, time.time(), device="cpu")
    return run.judge(result["numbers"], spec.limits(TRAIN))


def test_fault_state_unchanged(monkeypatch):
    from booster_gym_torch.algo import update_kernel

    orig = update_kernel.FusedUpdate.opt_stage

    def unchanged(self, g, p, m, v, *args, **kw):
        _, m2, v2, staged = orig(self, g, p, m, v, *args, **kw)
        return p, m2, v2, self.stage(p)

    monkeypatch.setattr(update_kernel.FusedUpdate, "opt_stage", unchanged)
    ok, compared = _run_train()
    assert not ok and compared["change_gap"]["value"] >= 0.99


def test_fault_half_the_batch(monkeypatch):
    from booster_gym_torch.algo import ppo

    orig = ppo.PPO.update

    def half(self, ts, carry, buf):
        B = buf[0].shape[1] // 2
        carry = (carry[0], carry[1][:B], carry[2][:B], *carry[3:])
        return orig(self, ts, carry, tuple(x[:, :B] for x in buf))

    monkeypatch.setattr(ppo.PPO, "update", half)
    ok, compared = _run_train()
    assert not ok


@pytest.mark.parametrize("fault", ["unchanged", "part_unchanged", "done_flipped"])
def test_env_step_faults_are_not_correct(readings, fault):
    """A fault planted in the program's env step, in every env or in one
    in a hundred (at 16 envs: env 0), fails the step's numbers."""
    limits = spec.limits(TRAIN)
    got = readings[fault]
    assert not run.judge({**readings["sound"], **got}, limits)[0]
    assert got["step_share"] > limits["step_share"]


def test_a_reset_that_keeps_moving_reads_in_reset_gap():
    """An env that both sides reset but whose joints keep their velocity
    and whose episode goes on reads at least 1."""
    cell, cfg, traffic = _train_cell()
    _, _, _, _, cap = train.set_up(cfg, traffic, 7, "cpu")
    _, _, (state, obs, rew, done, info) = cap.env_steps[max(cap.env_steps)]
    done = torch.zeros_like(done)
    done[0] = True
    out = (state, obs, rew, done, info)
    gap, reset = check_train.env_gap(env_class(cfg), out, out)
    assert reset[0] >= 1.0 and gap[0] >= 1.0 and (reset[1:] == 0).all()
    assert check_train.step_numbers([(gap, done != done, reset)])["reset_gap"] >= 1.0


def test_fault_control_step_frozen_in_some_envs(monkeypatch):
    from booster_gym_torch.physics import substep_kernel

    orig = substep_kernel.SubstepKernel.control_step

    def frozen(self, psim, *args, **kw):
        out = orig(self, psim, *args, **kw)
        some = torch.arange(psim.shape[1]) % check_train.FAULT_STRIDE == 0
        return out._replace(state=torch.where(some[None, :], psim, out.state))

    monkeypatch.setattr(substep_kernel.SubstepKernel, "control_step", frozen)
    ok, compared = _run_train()
    assert not ok and compared["step_share"]["value"] > compared["step_share"]["limit"]


def test_fault_termination_altered(monkeypatch):
    from booster_gym_torch.envs import t1

    orig = t1.T1.step

    def flipped(self, *args, **kw):
        state, obs, rew, done, info = orig(self, *args, **kw)
        some = torch.arange(done.shape[0]) % check_train.FAULT_STRIDE == 0
        return state, obs, rew, done ^ some, info

    monkeypatch.setattr(t1.T1, "step", flipped)
    ok, compared = _run_train()
    assert not ok and compared["done_share"]["value"] > compared["done_share"]["limit"]


@pytest.mark.cuda
def test_on_card_a_small_run_is_correct(card):
    """A training cell's whole run on the card at a small size."""
    cell, cfg, traffic = _train_cell("t1_shaped_rough_train")
    traffic = {**traffic, "num_envs": 512}
    result = cells.train_run(cell, cfg, traffic, 5, 2.0, True, time.time(), device=card)
    assert result["attempted"] >= 1 and result["numbers"]["field_gap"] == 0.0
    assert result["metrics"]["rollout_ms.train"] > 0
