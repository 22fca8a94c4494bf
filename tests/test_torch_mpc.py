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

On a trimesh env the kernel backend's rollout is K5 on flat ground (h = 0,
n = +z at every point), as the JAX planner's is on its Pallas backend,
where env.substep is the plane=False kernel's plane-signature step: the
port's plan there is held to the JAX plane planner at TOL, and K5's plain
control step on those inputs to the JAX plane=False step (interpret mode)
on the toy robot of tests/test_pallas_small.py, at TOL over 3 substeps
(the T1-scale Pallas kernel is never compiled on the CPU).  Under
sim.backend: xla the port's rollout queries the field in every substep,
and its plan on a small field is held to the JAX XLA planner's at TOL.

The three properties of tests/test_mpc.py (valid targets, a cost that does
not grow over warm-started plans, a closed loop that keeps the robot up)
are held on the stand-in with that test's sizes (H = 6, K = 32, sigma 0.2).
The rollout on the card, K1 at K = 256, is held to control_step_plain one
control step at a time by a `cuda` test, and the trimesh env's plan (K5)
to the plane env's (K1) bitwise by another; both skip without a card.
The JAX package is imported inside the tests that compare with it, so
that the `cuda` tests also run where JAX is not installed:
`python -m pytest --noconftest -m cuda tests/test_torch_mpc.py`.
"""

import copy

import numpy as np
import pytest
import torch

from booster_gym_torch.convert import dyn_params_from_jax, sim_state_from_jax
from booster_gym_torch.envs.t1 import T1
from booster_gym_torch.mpc import SamplingMPC, flat_ground, standup_cost, tile
from booster_gym_torch.physics import SimConfig, SimState
from booster_gym_torch.physics.substep_kernel import SubstepKernel
from booster_gym_torch.testing import (
    hold_mpc_rollout,
    mpc_path_cfg,
    mpc_start,
    rand_inputs,
    toy_model,
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


def small_field(cfg):
    """A small trimesh field: 2 tiles of 4 m x 4 m and a 2 m border."""
    cfg["terrain"].update(type="trimesh", num_terrains=2, terrain_width=4.0,
                          terrain_length=4.0, border_size=2.0)
    return cfg


@pytest.fixture(scope="module")
def jax_plans(pair):
    """Two plans of the JAX planner on the plane env (its CPU default, the
    XLA engine, jitted), each warm-started from the last one's shifted
    mean: [(noise, targets, shifted mean, info)], the noise its own draw
    sigma * normal(key, (H, K, nd))."""
    import jax

    from booster_gym_tpu.mpc import SamplingMPC as JaxMPC

    jenv, tenv, jsim, jdyn = pair[:4]
    jmpc = JaxMPC(jenv, horizon=H, num_samples=K, decimation=DECIMATION)
    nd = tenv.model.num_dofs
    plans = []
    for i in range(2):
        key = jax.random.PRNGKey(20 + i)
        noise = jmpc.sigma * jax.random.normal(key, (H, K, nd))
        jt, jmpc._mean, jinfo = jmpc._plan(jsim, jdyn, jmpc._mean, key)
        plans.append((torch.as_tensor(np.array(noise)), np.asarray(jt), np.asarray(jmpc._mean),
                      {k: float(v) for k, v in jinfo.items()}))
    return plans


def hold_to_jax_plans(mpc, sim1, dyn1, plans):
    for i, (noise, jt, jmean, jinfo) in enumerate(plans):
        tt, tinfo = mpc.plan(sim1, dyn1, noise=noise)
        close(tt.numpy(), jt, f"targets, plan {i}")
        close(mpc._mean.numpy(), jmean, f"shifted mean, plan {i}")
        for name in ("best_cost", "mean_cost", "ess"):
            close(float(tinfo[name]), jinfo[name], f"{name}, plan {i}")
    assert float(tinfo["ess"]) >= 1.0


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


def test_plan_matches_jax(pair, jax_plans):
    """Two plans in a row, each side warm-starting from its own shifted
    mean."""
    tenv, sim1, dyn1 = pair[1], pair[4], pair[5]
    hold_to_jax_plans(SamplingMPC(tenv, horizon=H, num_samples=K, decimation=DECIMATION),
                      sim1, dyn1, jax_plans)


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


def test_trimesh_kernel_plan_is_the_jax_plane_plan(pair, jax_plans, urdf):
    """A trimesh env on its kernel backend plans on flat ground, as the JAX
    planner does on its Pallas backend: from the plane pair's state and
    dynamics with the same noise, the port's plan (K5's plain control
    step on flat_ground's inputs) is the JAX plane planner's, at TOL."""
    sim1, dyn1 = pair[4], pair[5]
    env = T1(small_field(mpc_path_cfg(urdf)), device="cpu")
    assert env.substep is not None and not env.substep.plane
    mpc = SamplingMPC(env, horizon=H, num_samples=K, decimation=DECIMATION)
    hold_to_jax_plans(mpc, sim1, dyn1, jax_plans)
    ph, pn = mpc.rollout_inputs(K)[6:]
    assert mpc.rollout_inputs(K)[6] is ph    # made once per K
    npt = env.model.num_points
    assert torch.equal(ph, torch.zeros(npt, K))
    assert torch.equal(pn.view(npt, 3, K)[:, 2], torch.ones(npt, K))
    assert torch.equal(pn.view(npt, 3, K)[:, :2], torch.zeros(npt, 2, K))


def test_k5_flat_ground_control_step_is_the_jax_plane_signature_step():
    """On the toy robot: K5's plain control_step with the planner's inputs
    (no delay, no joint friction, no push, flat_ground) against the JAX
    plane=False kernel's plane-signature `step` in interpret mode (h = 0,
    n = +z at every point, booster_gym_tpu/physics/pallas_engine.py), in
    the JAX planner's loop clip(kp (targets - q) - kd qd, +-limits), over
    3 substeps."""
    import jax.numpy as jnp

    from booster_gym_tpu.physics import DynParams as JDyn, SimConfig as JCfg, SimState as JState
    from booster_gym_tpu.physics.pallas_engine import make_substep_pallas
    from booster_gym_tpu.utils.compile import jit_nofusion

    model, B, substeps = toy_model(), 8, 3
    feet = [i for i, n in enumerate(model.body_names) if "foot" in n]
    state, dyn, *_ = rand_inputs(model, B, "cpu", seed=11)
    nd = model.num_dofs
    gen = torch.Generator().manual_seed(12)
    targets = (state.q + 0.2 * torch.randn(state.q.shape, generator=gen)).contiguous()
    kp, kd = torch.full((nd,), 30.0), torch.full((nd,), 1.5)
    lim = torch.as_tensor(np.asarray(model.dof_effort, np.float32))

    sub = SubstepKernel(model, SimConfig(), feet, "cpu", plane=False)
    out = sub.control_step(sub.pack_sim(state), sub.pack_dyn(dyn), targets, targets,
                           torch.zeros(B, dtype=torch.int64), kp.expand(B, nd).contiguous(),
                           kd.expand(B, nd).contiguous(), torch.zeros(B, nd), lim,
                           torch.zeros(B, 6), *flat_ground(model.num_points, B, "cpu"),
                           decimation=substeps)
    ours = sub.unpack_sim(out.state)

    step = jit_nofusion(make_substep_pallas(model, JCfg(), feet_indices=feet, interpret=True,
                                            plane=False))
    j = lambda obj: {k: jnp.asarray(v.numpy()) for k, v in vars(obj).items()}
    sim, jdyn = JState(**j(state)), JDyn(**j(dyn))
    jt, jkp, jkd, jlim = (jnp.asarray(x.numpy()) for x in (targets, kp, kd, lim))
    zeros3 = jnp.zeros((B, 3))
    for _ in range(substeps):
        tau = jnp.clip(jkp * (jt - sim.q) - jkd * sim.qd, -jlim, jlim)
        sim = step(sim, jdyn, tau, zeros3, zeros3)[0]
    for k in SimState.FIELDS:
        close(getattr(ours, k).numpy(), getattr(sim, k), k)
    assert bool(torch.isfinite(out.state).all())


def test_xla_backend_plan_on_trimesh_matches_jax(urdf):
    """sim.backend: xla on a small field: the port's rollout queries the
    field in every substep, as the JAX XLA engine does; from the JAX env's
    reset state on that field, with the JAX planner's noise, the plans
    agree at TOL."""
    import jax

    from booster_gym_tpu.envs.t1 import T1 as JaxT1
    from booster_gym_tpu.mpc import SamplingMPC as JaxMPC

    cfg = small_field(mpc_path_cfg(urdf))
    jenv = JaxT1(copy.deepcopy(cfg))
    cfg["sim"]["backend"] = "xla"
    tenv = T1(cfg, device="cpu")
    assert tenv.substep is None and tenv.terrain.type == "trimesh"
    jparams = jenv.init_params(jax.random.PRNGKey(0))
    jsim = jenv.reset_all(jparams, jax.random.PRNGKey(1))[0].sim
    host = lambda x: jax.tree.map(np.asarray, x)
    sim1 = sim_state_from_jax(host(jsim), "cpu")
    dyn1 = dyn_params_from_jax(host(jparams.dyn), "cpu")
    jmpc = JaxMPC(jenv, horizon=H, num_samples=K, decimation=DECIMATION)
    key = jax.random.PRNGKey(30)
    noise = jmpc.sigma * jax.random.normal(key, (H, K, tenv.model.num_dofs))
    jt, jmean, jinfo = jmpc._plan(jsim, jparams.dyn, jmpc._mean, key)
    hold_to_jax_plans(SamplingMPC(tenv, horizon=H, num_samples=K, decimation=DECIMATION),
                      sim1, dyn1, [(torch.as_tensor(np.array(noise)), np.asarray(jt),
                                    np.asarray(jmean), {k: float(v) for k, v in jinfo.items()})])


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


@pytest.mark.cuda
def test_trimesh_plan_on_card_is_the_plane_plan_bitwise(urdf):
    """On the card the trimesh env's rollout is K5 on flat ground, which
    runs K1's code on the same values: from the same start and noise, the
    trimesh env's plan (targets, shifted mean, info) equals the plane
    env's bitwise, one K5 launch per control step and no fused sampling."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    env, sim, dyn1 = mpc_start(urdf, "cuda")
    rough = T1(mpc_path_cfg(urdf, terrain="trimesh"), "cuda")
    assert env.substep.plane and not rough.substep.plane
    plans = []
    for e in (env, rough):
        mpc = SamplingMPC(e, horizon=4)
        noise = mpc.draw(torch.Generator("cuda").manual_seed(0))
        n0, f0 = e.substep.launches, e.substep.fused_sampler_launches
        targets, info = mpc.plan(sim, dyn1, noise=noise)
        assert e.substep.launches - n0 == mpc.horizon
        assert e.substep.fused_sampler_launches == f0
        plans.append((targets, mpc._mean, info))
    (t0, m0, i0), (t1, m1, i1) = plans
    assert torch.equal(t0, t1) and torch.equal(m0, m1)
    for name in i0:
        assert torch.equal(i0[name], i1[name]), name
