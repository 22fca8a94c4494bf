"""The port's sampling MPC (booster_gym_torch/mpc) against the JAX
package's, on the T1-shaped stand-in robot on the plane.

The JAX side runs its CPU default, the XLA engine, jitted; the port runs
its env's kernel path, here the control step's plain version.  Both plan
from the same state and dynamics (the JAX env's, carried across by
booster_gym_torch.convert) with the same noise: the JAX planner's own draw
sigma * normal(key, (H, K, nd)), made here with its key and passed to the
port.  Sizes are small (H = 3 control steps of 10 substeps, K = 8
samples): XLA:CPU compiles the planner's nested scans at the 12-DoF
stand-in in seconds.  Tolerance: rtol = atol = 2e-3 (TOL), the physics
tolerance of tests/test_torch_env.py, on the targets, the shifted mean and
info.

The three properties of tests/test_mpc.py (valid targets, a cost that does
not grow over warm-started plans, a closed loop that keeps the robot up)
are held on the stand-in with that test's sizes (H = 6, K = 32, sigma 0.2).
The rollout on the card, K1 at K = 256, is held to control_step_plain one
control step at a time by the `cuda` test, which skips without a card.
The JAX package is imported inside the tests that compare with it, so
that the `cuda` test also runs where JAX is not installed:
`python -m pytest --noconftest -m cuda tests/test_torch_mpc.py`.
"""

import copy

import numpy as np
import pytest
import torch

from booster_gym_torch.convert import dyn_params_from_jax, sim_state_from_jax
from booster_gym_torch.envs.t1 import T1
from booster_gym_torch.mpc import SamplingMPC, standup_cost, tile
from booster_gym_torch.physics import SimState
from booster_gym_torch.testing import (
    hold_mpc_rollout,
    mpc_path_cfg,
    mpc_start,
    write_t1_shaped_urdf,
)

TOL = 2e-3
H, K, DECIMATION = 3, 8, 10


@pytest.fixture(scope="module")
def urdf(tmp_path_factory):
    return write_t1_shaped_urdf(tmp_path_factory.mktemp("urdf"))


@pytest.fixture(scope="module")
def pair(urdf):
    import jax

    from booster_gym_tpu.envs.t1 import T1 as JaxT1

    cfg = mpc_path_cfg(urdf)
    jenv = JaxT1(copy.deepcopy(cfg))
    tenv = T1(copy.deepcopy(cfg), device="cpu")
    jparams = jenv.init_params(jax.random.PRNGKey(0))
    jsim = jenv.reset_all(jparams, jax.random.PRNGKey(1))[0].sim
    host = lambda x: jax.tree.map(np.asarray, x)
    return (jenv, tenv, jsim, jparams.dyn, sim_state_from_jax(host(jsim), "cpu"),
            dyn_params_from_jax(host(jparams.dyn), "cpu"))


@pytest.fixture(scope="module")
def standin(urdf):
    """The port alone on the stand-in, at tests/test_mpc.py's sizes."""
    env, sim, dyn = mpc_start(urdf, "cpu")
    return env, SamplingMPC(env, horizon=6, num_samples=32, sigma=0.2), sim, dyn


def close(a, b, label):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL, atol=TOL, err_msg=label)


def test_standup_cost_matches_jax(pair):
    import jax.numpy as jnp

    from booster_gym_tpu.mpc import standup_cost as jax_standup_cost
    from booster_gym_tpu.physics import SimState as JState

    tenv = pair[1]
    rng = np.random.default_rng(0)
    B, nd = 64, tenv.model.num_dofs
    quat = rng.normal(size=(B, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    f32 = lambda x: np.asarray(x, np.float32)
    fields = dict(root_pos=f32(rng.uniform([-1, -1, 0.1], [1, 1, 0.9], (B, 3))),
                  root_quat=f32(quat), root_lin_vel=f32(rng.normal(size=(B, 3))),
                  root_ang_vel=f32(rng.normal(size=(B, 3))),
                  q=f32(rng.normal(0, 0.5, (B, nd))), qd=f32(rng.normal(0, 2, (B, nd))))
    default = tenv.default_dof_pos
    ours = standup_cost(SimState(**{k: torch.as_tensor(v) for k, v in fields.items()}), default)
    ref = jax_standup_cost(JState(**{k: jnp.asarray(v) for k, v in fields.items()}),
                           jnp.asarray(default.numpy()))
    close(ours.numpy(), ref, "standup_cost")
    ours = standup_cost(SimState(**{k: torch.as_tensor(v) for k, v in fields.items()}), default,
                        target_height=0.5)
    close(ours.numpy(), jax_standup_cost(JState(**{k: jnp.asarray(v) for k, v in fields.items()}),
                                         jnp.asarray(default.numpy()), target_height=0.5),
          "standup_cost at target_height 0.5")


def test_plan_matches_jax(pair):
    """Two plans in a row, each side warm-starting from its own shifted
    mean."""
    import jax

    from booster_gym_tpu.mpc import SamplingMPC as JaxMPC

    jenv, tenv, jsim, jdyn, sim1, dyn1 = pair
    jmpc = JaxMPC(jenv, horizon=H, num_samples=K, decimation=DECIMATION)
    tmpc = SamplingMPC(tenv, horizon=H, num_samples=K, decimation=DECIMATION)
    nd = tenv.model.num_dofs
    for i in range(2):
        key = jax.random.PRNGKey(20 + i)
        noise = jmpc.sigma * jax.random.normal(key, (H, K, nd))
        jt, jmpc._mean, jinfo = jmpc._plan(jsim, jdyn, jmpc._mean, key)
        tt, tinfo = tmpc.plan(sim1, dyn1, noise=torch.as_tensor(np.array(noise)))
        close(tt.numpy(), jt, f"targets, plan {i}")
        close(tmpc._mean.numpy(), jmpc._mean, f"shifted mean, plan {i}")
        for name in ("best_cost", "mean_cost", "ess"):
            close(float(tinfo[name]), float(jinfo[name]), f"{name}, plan {i}")
    assert float(tinfo["ess"]) >= 1.0


def test_rollout_is_the_clip_pd_loop_bitwise(pair):
    """With no delay and no joint friction the control step's plain
    version is the JAX rollout's loop: tau = clip(kp (targets - q) - kd
    qd, +-limits) around the eager substep (packed_call on the CPU),
    bitwise."""
    tenv, sim1, dyn1 = pair[1], pair[4], pair[5]
    mpc = SamplingMPC(tenv, horizon=H, num_samples=K, decimation=DECIMATION)
    sub, nd = tenv.substep, tenv.model.num_dofs
    gen = torch.Generator().manual_seed(3)
    mpc._mean = 0.1 * torch.randn((H, nd), generator=gen)
    deltas, targets = mpc.sample(mpc._mean, mpc.draw(gen))
    state_k, dyn_k = tile(sim1, dyn1, K)
    final, costs = mpc._rollout(dyn_k, state_k, targets)

    psim, pdyn = sub.pack_sim(state_k), sub.pack_dyn(dyn_k)
    kp, kd = tenv.base_stiffness[:, None], tenv.base_damping[:, None]
    lim = tenv.torque_limits[:, None]
    ext = torch.zeros((6, K))
    ref_costs = []
    for t in targets:
        for _ in range(DECIMATION):
            tau = torch.clamp(kp * (t.T - psim[13:13 + nd]) - kd * psim[13 + nd:], -lim, lim)
            psim = sub.packed_call(psim, pdyn, tau.contiguous(), ext)[0]
        ref_costs.append(mpc.cost_fn(sub.unpack_sim(psim)))
    assert torch.equal(costs, torch.stack(ref_costs))
    for k in SimState.FIELDS:
        assert torch.equal(getattr(final, k), getattr(sub.unpack_sim(psim), k)), k
    assert bool(torch.isfinite(costs).all())


def test_xla_backend_plan_matches_kernel_backend(pair, urdf):
    """sim.backend: xla plans through the eager engine's loop; on the
    plane it gives the kernel path's plan."""
    tenv, sim1, dyn1 = pair[1], pair[4], pair[5]
    cfg = mpc_path_cfg(urdf)
    cfg["sim"]["backend"] = "xla"
    xenv = T1(cfg, device="cpu")
    assert xenv.substep is None and tenv.substep is not None
    noise = SamplingMPC(tenv, horizon=H, num_samples=K).draw(torch.Generator().manual_seed(5))
    outs = [SamplingMPC(env, horizon=H, num_samples=K, decimation=DECIMATION).plan(
        sim1, dyn1, noise=noise) for env in (tenv, xenv)]
    close(outs[1][0].numpy(), outs[0][0].numpy(), "targets")
    for name in ("best_cost", "mean_cost", "ess"):
        close(float(outs[1][1][name]), float(outs[0][1][name]), name)


def test_plan_returns_valid_targets(standin):
    env, mpc, sim, dyn1 = standin
    mpc.reset()
    targets, info = mpc.plan(sim, dyn1, gen=torch.Generator().manual_seed(2))
    assert targets.shape == (12,)
    assert bool((targets >= env.dof_lower - 1e-5).all())
    assert bool((targets <= env.dof_upper + 1e-5).all())
    assert np.isfinite(float(info["best_cost"]))
    assert 1.0 <= float(info["ess"]) <= mpc.num_samples


def test_planner_cost_improves_over_iterations(standin):
    env, mpc, sim, dyn1 = standin
    mpc.reset()
    costs = []
    for i in range(4):
        _, info = mpc.plan(sim, dyn1, gen=torch.Generator().manual_seed(10 + i))
        costs.append(float(info["best_cost"]))
    # replanning from the warm-started mean should not get worse
    assert costs[-1] <= costs[0] * 1.05 + 1e-3, costs


def test_closed_loop_holds_standing(standin):
    """From the standing start the MPC keeps the robot up over 0.5 s of
    closed-loop control (25 plans at 50 Hz), each plan's first targets
    applied for one control step of the same physics."""
    env, mpc, sim, dyn1 = standin
    mpc.reset()
    gen = torch.Generator().manual_seed(42)
    for _ in range(25):
        targets, _ = mpc.plan(sim, dyn1, gen=gen)
        sim = mpc._rollout(dyn1, sim, targets[None, None])[0]
    h = float(sim.root_pos[0, 2])
    assert h > 0.55, f"MPC failed to keep the robot up (h={h:.3f})"
    assert np.isfinite(float(standup_cost(sim, env.default_dof_pos)[0]))


def test_trimesh_kernel_env_raises(urdf):
    cfg = mpc_path_cfg(urdf)
    cfg["terrain"].update(type="trimesh", num_terrains=2, terrain_width=4.0,
                          terrain_length=4.0, border_size=2.0)
    env = T1(cfg, device="cpu")
    assert not env.substep.plane
    with pytest.raises(ValueError, match="trimesh"):
        SamplingMPC(env, horizon=H, num_samples=K)


@pytest.mark.cuda
def test_k1_rollout_on_card_matches_plain(urdf):
    """K1 at the MPC's batch (K = 256, 32 blocks of 8 envs), one control
    step per launch, held to control_step_plain from the kernel's own state
    at every step (testing.hold_mpc_rollout: samples whose plain state is
    chaotic under a one-ulp nudge left out, at most 1% a step, and a sample
    past the tolerance only where the plain step reaches it from a
    rounding-perturbed state); then plan's weighting of the same noise
    equals the weighting of those costs exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    env, sim, dyn1 = mpc_start(urdf, "cuda")
    mpc = SamplingMPC(env, horizon=4)
    noise = mpc.draw(torch.Generator("cuda").manual_seed(0))
    held = hold_mpc_rollout(mpc, sim, dyn1, noise, tol=TOL)
    assert held["finite_same"]
    assert not any(held["over"]), held["state_err"]
    assert int(held["chaotic"].sum(1).max()) <= mpc.num_samples // 100
    n0 = env.substep.launches
    targets, info = mpc.plan(sim, dyn1, noise=noise)
    assert env.substep.launches - n0 == mpc.horizon
    ref_targets, ref_mean, ref_info = mpc.weigh(held["deltas"], held["costs"])
    assert torch.equal(targets, ref_targets) and torch.equal(mpc._mean, ref_mean)
    for name, v in ref_info.items():
        assert torch.equal(info[name], v), name
