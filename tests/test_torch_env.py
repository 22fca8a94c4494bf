"""The port's T1 env (plane and trimesh terrain) against the JAX package's,
on the T1-shaped stand-in robot.

Both sides start from the same EnvParams / EnvState (the JAX side's,
carried across by booster_gym_torch.convert) and take three control steps
with the same actions.  The config draws no randomness that matters inside
step: noise ranges are zero, kicks and pushes come after the horizon, and
command resampling lies seconds away.  Envs that reset on either side are
left out of the comparison (a reset draws a new state).  Tolerance: rtol =
atol = 2e-3 on observations, rewards and reward terms, the physics
tolerance of tests/test_torch_physics.py.

On trimesh (a small field: 2 tiles of 4 m x 4 m, border 2 m) the JAX side
runs its CPU default, the xla engine, which queries the terrain inside the
substep; the port runs the same engine under sim.backend: xla.  The port's
default kernel path (carried per-point terrain, substep kernel and terrain
sampler, here their plain versions) is then held to its own invariants.
"""

import copy
import dataclasses

import numpy as np
import jax
import pytest
import torch

from booster_gym_tpu.envs.t1 import T1 as JaxT1
from booster_gym_tpu.utils.config import load_task_cfg as jax_load_task_cfg

from booster_gym_torch.convert import env_params_from_jax, env_state_from_jax
from booster_gym_torch.envs.randomize import apply_randomization
from booster_gym_torch.envs.t1 import T1
from booster_gym_torch.math.quat import quat_rotate
from booster_gym_torch.testing import write_t1_shaped_urdf
from booster_gym_torch.utils.config import load_task_cfg

TOL = 2e-3
B = 32


def quiet_cfg(urdf, num_envs=B):
    cfg = jax_load_task_cfg("T1")
    cfg["env"]["num_envs"] = num_envs
    cfg["terrain"]["type"] = "plane"
    cfg["asset"]["file"] = urdf
    for spec in cfg["noise"].values():
        spec["range"] = [0.0, 0.0]
    cfg["randomization"]["kick_interval_s"] = 1000.0
    cfg["randomization"]["push_interval_s"] = 1000.0
    return cfg


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    urdf = write_t1_shaped_urdf(tmp_path_factory.mktemp("urdf"))
    cfg = quiet_cfg(urdf)
    jenv = JaxT1(copy.deepcopy(cfg))
    tenv = T1(copy.deepcopy(cfg), device="cpu")
    jparams = jenv.init_params(jax.random.PRNGKey(0))
    jstate, jobs, jinfo = jenv.reset_all(jparams, jax.random.PRNGKey(1))
    host = lambda x: jax.tree.map(np.asarray, x)
    tparams = env_params_from_jax(host(jparams), "cpu")
    tstate = env_state_from_jax(host(jstate), "cpu")
    return jenv, tenv, jparams, jstate, jobs, jinfo, tparams, tstate


def close(a, b, keep, label):
    a, b = np.asarray(a)[keep], np.asarray(b)[keep]
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=label)


def test_env_dims_and_registry(pair):
    jenv, tenv = pair[0], pair[1]
    assert tenv.model.num_points == 56 and tenv.model.num_bodies == 13
    assert list(tenv.reward_scales) == list(jenv.reward_scales)
    assert len(tenv.reward_scales) == 23
    np.testing.assert_allclose(tenv.default_dof_pos.numpy(), np.asarray(jenv.default_dof_pos))
    np.testing.assert_allclose(tenv.env_origins.numpy(), np.asarray(jenv.env_origins))
    assert tenv.penalized_contact_indices == list(jenv.penalized_contact_indices)
    assert tenv.feet_indices == list(jenv.feet_indices)
    assert tenv.foot_shape_indices == list(jenv.foot_shape_indices)


def test_three_steps_match_jax(pair):
    jenv, tenv, jparams, jstate, _, _, tparams, tstate = pair
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    compared = 0
    for step in range(3):
        actions = (0.3 * rng.standard_normal((B, 12))).astype(np.float32)
        jstate, jobs, jrew, jdone, jinfo = jstep(jparams, jstate, jax.numpy.asarray(actions))
        tstate, tobs, trew, tdone, tinfo = tenv.step(tparams, tstate, torch.as_tensor(actions),
                                                     gen)
        keep = ~(np.asarray(jdone) | tdone.numpy())
        assert keep.sum() >= B // 2, "too many resets to compare"
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(tinfo["time_outs"].numpy(), np.asarray(jinfo["time_outs"]))
        close(tobs.numpy(), jobs, keep, f"obs, step {step}")
        close(tinfo["privileged_obs"].numpy(), jinfo["privileged_obs"], keep,
              f"privileged obs, step {step}")
        close(trew.numpy(), jrew, keep, f"reward, step {step}")
        assert set(tinfo["rew_terms"]) == set(jinfo["rew_terms"])
        for name, val in tinfo["rew_terms"].items():
            close(val.numpy(), jinfo["rew_terms"][name], keep, f"{name}, step {step}")
        compared += int(keep.sum())
    assert compared > 0


def test_apply_randomization_statistics():
    gen = torch.Generator().manual_seed(3)
    x = torch.full((200_000,), 2.0)
    g = apply_randomization(gen, x, {"range": [0.5, 0.2], "operation": "additive",
                                     "distribution": "gaussian"})
    assert abs(float(g.mean()) - 2.5) < 3e-3 and abs(float(g.std()) - 0.2) < 3e-3
    u, noise = apply_randomization(gen, x, {"range": [0.8, 1.2], "operation": "scaling",
                                            "distribution": "uniform"}, return_noise=True)
    assert float(u.min()) >= 1.6 and float(u.max()) <= 2.4
    assert abs(float(u.mean()) - 2.0) < 3e-3
    assert abs(float(noise.mean()) - 0.5) < 3e-3 and abs(float(noise.var()) - 1 / 12) < 2e-3
    assert apply_randomization(gen, x, None) is x


def test_reset_and_init_samplers_statistics(tmp_path):
    """The port's own draws (torch.Generator) by their distributions."""
    cfg = load_task_cfg("T1")
    cfg["env"]["num_envs"] = 4096
    cfg["terrain"]["type"] = "plane"
    cfg["asset"]["file"] = write_t1_shaped_urdf(tmp_path)
    env = T1(cfg, device="cpu")
    gen = torch.Generator().manual_seed(5)
    params = env.init_params(gen)
    state, obs, info = env.reset_all(params, gen)
    n = env.num_envs
    assert obs.shape == (n, 47) and info["privileged_obs"].shape == (n, 14)

    ratio = params.dof_stiffness / env.base_stiffness
    assert float(ratio.min()) >= 0.95 and float(ratio.max()) <= 1.05
    assert abs(float(ratio.mean()) - 1.0) < 2e-3
    mass_ratio = params.dyn.body_mass[:, 0] / float(env.model.body_mass[0])
    assert float(mass_ratio.min()) >= 0.8 and float(mass_ratio.max()) <= 1.2
    foot = params.dyn.shape_friction[:, env.foot_shape_indices]
    assert float(foot.min()) >= 0.1 and float(foot.max()) <= 2.0
    assert abs(float(foot.mean()) - 1.05) < 0.02
    others = [s for s in range(len(env.model.shape_body)) if s not in env.foot_shape_indices]
    assert bool((params.dyn.shape_friction[:, others] == 1.0).all())

    counts = torch.bincount(state.delay_steps, minlength=env.decimation)
    assert len(counts) == env.decimation and int(counts.min()) > 0.7 * n / env.decimation
    yaw = 2 * torch.atan2(state.sim.root_quat[:, 3], state.sim.root_quat[:, 0])
    yaw = torch.remainder(yaw, 2 * np.pi)
    assert abs(float(yaw.mean()) - np.pi) < 0.1
    still = state.gait_frequency == 0.0
    assert abs(float(still.float().mean()) - 0.1) < 0.02
    moving = state.commands[~still]
    assert float(moving.min()) >= -1.0 and float(moving.max()) <= 1.0
    assert abs(float(moving.mean())) < 0.05
    gf = state.gait_frequency[~still]
    assert float(gf.min()) >= 1.0 and float(gf.max()) <= 2.0
    lo, hi = (int(t / env.dt) for t in cfg["commands"]["resampling_time_s"])
    assert int(state.cmd_resample_time.min()) >= lo and int(state.cmd_resample_time.max()) < hi


def test_curriculum_update_and_sampling(tmp_path):
    """The curriculum grid: a success at level (0, 0) diffuses to its four
    neighbours; sampled commands follow the grid's categorical."""
    cfg = load_task_cfg("T1")
    cfg["env"]["num_envs"] = 8
    cfg["terrain"]["type"] = "plane"
    cfg["asset"]["file"] = write_t1_shaped_urdf(tmp_path)
    cfg["commands"]["curriculum"] = True
    env = T1(cfg, device="cpu")
    state = env._zero_state()
    state = state.replace(episode_length=torch.full((8,), 10_000))
    mask = torch.zeros(8, dtype=torch.bool)
    mask[0] = True
    prob = env._update_curriculum(state, mask)
    c = cfg["commands"]
    x, y = c["lin_vel_levels"], c["ang_vel_levels"]
    assert float(prob[x, y]) == 1.0   # clamped
    for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        assert float(prob[x + dx, y + dy]) == pytest.approx(c["update_rate"])
    assert float(prob.sum()) == pytest.approx(1.0 + 4 * c["update_rate"])
    gen = torch.Generator().manual_seed(0)
    cmds, levels = env._sample_curriculum_commands(state.replace(curriculum_prob=prob), gen)
    assert cmds.shape == (8, 3) and levels.shape == (8, 2)
    assert int(levels.abs().max()) <= 1


def test_still_mode_exact_fraction(tmp_path):
    """still_mode exact_fraction: of the k envs resampling a command, exactly
    floor(still_proportion * k) go still."""
    cfg = load_task_cfg("T1")
    cfg["env"]["num_envs"] = 1000
    cfg["terrain"]["type"] = "plane"
    cfg["asset"]["file"] = write_t1_shaped_urdf(tmp_path)
    cfg["commands"]["still_mode"] = "exact_fraction"
    env = T1(cfg, device="cpu")
    state = env._zero_state()
    resample = torch.arange(1000) < 730
    state = state.replace(cmd_resample_time=torch.where(resample, 0, 5))
    out = env._resample_commands(state, torch.Generator().manual_seed(0))
    still = (out.gait_frequency == 0.0) & resample
    assert int(still.sum()) == int(0.1 * 730)
    assert bool((out.gait_frequency[~resample] == 0.0).all())   # untouched: zeros
    assert bool((out.cmd_resample_time[~resample] == 5).all())


# ---------------------------------------------------------------------------
# trimesh
SMALL_FIELD = dict(num_terrains=2, terrain_width=4.0, terrain_length=4.0, border_size=2.0)


def rough_cfg(urdf, num_envs=B):
    cfg = quiet_cfg(urdf, num_envs)
    cfg["terrain"]["type"] = "trimesh"
    cfg["terrain"].update(SMALL_FIELD)
    return cfg


@pytest.fixture(scope="module")
def rough_pair(tmp_path_factory):
    urdf = write_t1_shaped_urdf(tmp_path_factory.mktemp("urdf"))
    cfg = rough_cfg(urdf)
    jenv = JaxT1(copy.deepcopy(cfg))
    assert not jenv.pallas_backend            # the JAX package's CPU default
    xcfg = copy.deepcopy(cfg)
    xcfg["sim"]["backend"] = "xla"
    tenv = T1(xcfg, device="cpu")
    jparams = jenv.init_params(jax.random.PRNGKey(0))
    jstate, _, _ = jenv.reset_all(jparams, jax.random.PRNGKey(1))
    host = lambda x: jax.tree.map(np.asarray, x)
    return jenv, tenv, jparams, jstate, env_params_from_jax(host(jparams), "cpu"), \
        env_state_from_jax(host(jstate), "cpu")


@pytest.fixture(scope="module")
def kernel_env(tmp_path_factory):
    """The port's default backend on trimesh, on the CPU."""
    urdf = write_t1_shaped_urdf(tmp_path_factory.mktemp("urdf"))
    env = T1(rough_cfg(urdf, 16), device="cpu")
    gen = torch.Generator().manual_seed(2)
    params = env.init_params(gen)
    state, _, _ = env.reset_all(params, gen)
    return env, params, state


def test_trimesh_origins_and_reset_state_match_jax(rough_pair):
    jenv, tenv, jparams, jstate, tparams, tstate = rough_pair
    assert tenv.engine_substep is not None and tenv.substep is None
    assert tenv.terrain_sampler is None
    np.testing.assert_array_equal(tenv.terrain.height_field.numpy(),
                                  np.asarray(jenv.terrain.height_field))
    np.testing.assert_array_equal(tparams.height_field.numpy(), np.asarray(jparams.height_field))
    np.testing.assert_allclose(tenv.env_origins.numpy(), np.asarray(jenv.env_origins),
                               rtol=0, atol=1e-6)
    assert float(tenv.env_origins[:, 2].abs().max()) > 0
    # what reset_all derives from the drawn root poses, from the JAX state:
    # the terrain under the root and under every contact point (atol 1e-6,
    # the direct queries' tolerance), and the feet state (2e-3)
    root_h = tenv.terrain.heights(tstate.sim.root_pos[:, :2], tparams.height_field)
    np.testing.assert_allclose(root_h.numpy(), np.asarray(jstate.terrain_height_root), atol=1e-6)
    np.testing.assert_allclose(
        (tstate.sim.root_pos[:, 2] - root_h).numpy(), 0.72, atol=1e-5)
    refreshed = tenv._refresh_point_terrain(tstate)
    assert refreshed.point_heights.shape == (B, 56)
    np.testing.assert_allclose(refreshed.point_heights.numpy(),
                               np.asarray(jstate.point_heights), atol=1e-6)
    np.testing.assert_allclose(refreshed.point_normals.numpy(),
                               np.asarray(jstate.point_normals), atol=1e-6)
    zero = torch.zeros_like(tstate.filtered_lin_vel)
    post = tenv._refresh_post_physics(
        tparams, tstate.replace(filtered_lin_vel=zero, filtered_ang_vel=zero))
    np.testing.assert_array_equal(post.feet_contact.numpy(), np.asarray(jstate.feet_contact))
    np.testing.assert_allclose(post.feet_pos.numpy(), np.asarray(jstate.feet_pos),
                               rtol=TOL, atol=TOL)
    # the port's own reset_all on the field: roots stand 0.72 m above it
    state, obs, _ = tenv.reset_all(tparams, torch.Generator().manual_seed(0))
    h = tenv.terrain.heights(state.sim.root_pos[:, :2])
    np.testing.assert_allclose((state.sim.root_pos[:, 2] - h).numpy(), 0.72, atol=1e-5)
    assert torch.equal(state.terrain_height_root, h) and bool(torch.isfinite(obs).all())


def test_trimesh_three_steps_match_jax(rough_pair):
    jenv, tenv, jparams, jstate, tparams, tstate = rough_pair
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    compared = 0
    for step in range(3):
        actions = (0.3 * rng.standard_normal((B, 12))).astype(np.float32)
        jstate, jobs, jrew, jdone, jinfo = jstep(jparams, jstate, jax.numpy.asarray(actions))
        tstate, tobs, trew, tdone, tinfo = tenv.step(tparams, tstate, torch.as_tensor(actions),
                                                     gen)
        keep = ~(np.asarray(jdone) | tdone.numpy())
        assert keep.sum() >= B // 2, "too many resets to compare"
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        close(tobs.numpy(), jobs, keep, f"obs, step {step}")
        close(tinfo["privileged_obs"].numpy(), jinfo["privileged_obs"], keep,
              f"privileged obs, step {step}")
        close(trew.numpy(), jrew, keep, f"reward, step {step}")
        close(tstate.terrain_height_root.numpy(), jstate.terrain_height_root, keep,
              f"root terrain height, step {step}")
        close(tstate.sim.root_pos.numpy(), jstate.sim.root_pos, keep, f"root pos, step {step}")
        for name, val in tinfo["rew_terms"].items():
            close(val.numpy(), jinfo["rew_terms"][name], keep, f"{name}, step {step}")
        compared += int(keep.sum())
    assert compared > 0
    assert float(tstate.terrain_height_root.abs().max()) > 0   # the field is not flat there


def test_teleport_matches_jax(rough_pair):
    """Robots placed past each border wrap to the other side, as in JAX."""
    jenv, tenv, _, jstate, _, tstate = rough_pair
    t = jenv.terrain
    pos = np.asarray(jstate.sim.root_pos).copy()
    far = 0.75 * t.border_size + 0.1
    pos[0, 0], pos[1, 0] = -far, t.env_width + far
    pos[2, 1], pos[3, 1] = -far, t.env_length + far
    pos[4, :2] = [-far, t.env_length + far]
    pos[5, :2] = [-0.75 * t.border_size + 0.05, 1.0]          # inside: stays
    jnew, jmoved = jenv._teleport_robots(
        jstate.replace(sim=jstate.sim.replace(root_pos=jax.numpy.asarray(pos))))
    sim = copy.copy(tstate.sim)
    sim.root_pos = torch.as_tensor(pos)
    tnew, tmoved = tenv._teleport_robots(tstate.replace(sim=sim))
    np.testing.assert_array_equal(tmoved.numpy(), np.asarray(jmoved))
    assert tmoved[:5].all() and not tmoved[5]
    np.testing.assert_allclose(tnew.sim.root_pos.numpy(), np.asarray(jnew.sim.root_pos),
                               rtol=0, atol=1e-6)


def test_plane_env_does_not_teleport(pair):
    tenv, tstate = pair[1], pair[7]
    new, moved = tenv._teleport_robots(tstate)
    assert not bool(moved.any()) and new is tstate


def test_kernel_path_carries_the_sampled_point_terrain(kernel_env):
    """After a step every env that did not reset carries the sampler's
    heights and normals at the last substep's contact-point xy, and the
    root's height from the same call (rtol 1e-5 / atol 1e-6: the same
    function on the same inputs)."""
    env, params, state = kernel_env
    assert env.substep is not None and not env.substep.plane
    assert env.terrain_sampler.num_points == 56 + 1 + 8
    n = env.num_envs
    gen = torch.Generator().manual_seed(3)
    actions = 0.2 * torch.randn(n, 12, generator=gen)
    # the step's control step, kept to read its contact-point xy
    steps, control_step = [], env.substep.control_step
    env.substep.control_step = lambda *a, **k: steps.append(control_step(*a, **k)) or steps[-1]
    try:
        state2, obs, rew, done, _ = env.step(params, state, actions, gen)
    finally:
        env.substep.control_step = control_step
    assert bool(torch.isfinite(obs).all()) and bool(torch.isfinite(rew).all())
    assert env.substep.launches == 0 and env.terrain_sampler.launches == 0   # the CPU
    (out,) = steps
    pt_xy = out.ptxy.T.reshape(n, 56, 2)
    root_xy = out.state[0:2].T.contiguous()
    queries = torch.cat([pt_xy, root_xy[:, None], torch.zeros(n, 8, 2)], dim=1)
    h, nrm = env.terrain_sampler.plain(params.height_field, root_xy, queries)
    keep = ~done
    assert int(keep.sum()) >= n // 2
    torch.testing.assert_close(state2.point_heights[keep], h[keep, :56], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(state2.point_normals[keep], nrm[keep, :56], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(state2.terrain_height_root[keep], h[keep, 56],
                               rtol=1e-5, atol=1e-6)
    assert float(state2.point_heights[keep].abs().max()) > 0
    # the carried values differ from env to env and from point to point
    assert float(state2.point_heights[keep].std(dim=1).max()) > 0


def test_kernel_path_reset_falls_back_to_the_root_terrain(kernel_env):
    """Force every env to time out: the carried per-point terrain collapses
    to the height and normal under each env's new root."""
    env, params, state = kernel_env
    n = env.num_envs
    state = state.replace(episode_length=torch.full((n,), env.max_episode_length + 1))
    gen = torch.Generator().manual_seed(4)
    state2, obs, _, done, _ = env.step(params, state, torch.zeros(n, 12), gen)
    assert bool(done.all()), "every env must have reset"
    h_root, n_root = env.terrain.heights_and_normals(state2.sim.root_pos[:, :2],
                                                     params.height_field)
    torch.testing.assert_close(state2.point_heights, h_root[:, None].expand(n, 56),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(state2.point_normals, n_root[:, None, :].expand(n, 56, 3),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(state2.terrain_height_root, h_root, rtol=1e-5, atol=1e-6)
    assert bool(torch.isfinite(obs).all())


# ---------------------------------------------------------------------------
# the step as it stood before the control step's epilogue took over its
# post-physics ops (the foot edge points, the terrain sampler's call)
class FormerT1(T1):
    """T1 with the former step: the edge points and the sampler's queries
    as tensor ops after the physics, copied from the env before the
    control-step kernel's epilogue computed them."""

    def _physics_inner_loop(self, params, state, dof_targets, push_f_w, push_t_w):
        sub = self.substep
        B, npt = self.num_envs, self.model.num_points
        if sub.plane:
            ph = pn = None
        else:
            ph = state.point_heights.T.contiguous()
            pn = state.point_normals.reshape(B, -1).T.contiguous()
        psim, last, tsum, pforces, pfeet, pptxy = sub.control_step(
            sub.pack_sim(state.sim), sub.pack_dyn(params.dyn), dof_targets.contiguous(),
            state.last_dof_targets.contiguous(), state.delay_steps.contiguous(),
            params.dof_stiffness.contiguous(), params.dof_damping.contiguous(),
            params.dof_friction.contiguous(), self.torque_limits,
            torch.cat([push_f_w, push_t_w], dim=-1), ph, pn, decimation=self.decimation)[:6]
        nb, nf = self.model.num_bodies, len(self.feet_indices)
        feet = pfeet.T.reshape(B, nf, 12)
        pt_xy = self._zeros(B, npt, 2) if sub.plane else pptxy.T.reshape(B, npt, 2)
        return (sub.unpack_sim(psim), last, tsum / self.decimation,
                pforces.T.reshape(B, nb, 3), feet[..., 0:3],
                feet[..., 3:12].reshape(B, nf, 3, 3), pt_xy)

    def _feet_edge_world(self, feet_pos, feet_R):
        px, py, pz = feet_pos.unbind(-1)
        xs, ys, zs = [], [], []
        for lx, ly, lz in self.feet_edge_pos.tolist():
            xs.append(px + feet_R[..., 0, 0] * lx + feet_R[..., 0, 1] * ly + feet_R[..., 0, 2] * lz)
            ys.append(py + feet_R[..., 1, 0] * lx + feet_R[..., 1, 1] * ly + feet_R[..., 1, 2] * lz)
            zs.append(pz + feet_R[..., 2, 0] * lx + feet_R[..., 2, 1] * ly + feet_R[..., 2, 2] * lz)
        return torch.stack(xs, -1), torch.stack(ys, -1), torch.stack(zs, -1)

    def step(self, params, state, actions, gen):
        actions, dof_targets = self._apply_actions(actions)
        state = state.replace(actions=actions)

        push_f_w = quat_rotate(state.sim.root_quat, state.push_force)
        push_t_w = quat_rotate(state.sim.root_quat, state.push_torque)
        sim, last_targets, torques, forces, feet_pos, feet_R, pt_xy = self._physics_inner_loop(
            params, state, dof_targets, push_f_w, push_t_w)
        state = state.replace(sim=sim, last_dof_targets=last_targets, torques=torques,
                              contact_forces=forces)

        edge_xyz = self._feet_edge_world(feet_pos, feet_R)
        edge_h = None
        if self.terrain_sampler is not None:
            B, npt = self.num_envs, self.model.num_points
            edge_xy = torch.stack([edge_xyz[0].reshape(B, -1), edge_xyz[1].reshape(B, -1)], -1)
            root_xy = sim.root_pos[:, :2].contiguous()
            queries = torch.cat([pt_xy, root_xy[:, None, :], edge_xy], dim=1)
            h_all, n_all = self.terrain_sampler(params.height_field, root_xy, queries)
            pt_h, pt_n = h_all[:, :npt], n_all[:, :npt]
            root_h = h_all[:, npt]
            edge_h = h_all[:, npt + 1:].reshape(edge_xyz[2].shape)
        else:
            root_h = self.terrain.heights(sim.root_pos[:, :2], params.height_field)
        state = state.replace(terrain_height_root=root_h)
        state = self._refresh_post_physics(params, state, feet_pos=feet_pos, feet_R=feet_R,
                                           edge_xyz=edge_xyz, edge_heights=edge_h)
        state = state.replace(
            episode_length=state.episode_length + 1,
            common_step_counter=state.common_step_counter + 1,
            gait_process=torch.remainder(
                state.gait_process + self.dt * state.gait_frequency, 1.0))

        state = self._kick_robots(state, gen)
        state = self._push_robots(state, gen)
        state = self._check_termination(state)
        rew, rew_terms = self._compute_reward(params, state)

        reset_mask = state.reset_buf
        state = self._reset_envs(params, state, reset_mask, gen)
        state, moved_mask = self._teleport_robots(state)
        if self.terrain.type != "plane":
            fix = reset_mask | moved_mask
            h_root, n_root = self.terrain.heights_and_normals(
                state.sim.root_pos[:, :2], params.height_field)
            state = state.replace(terrain_height_root=torch.where(
                fix, h_root, state.terrain_height_root))
            if self.terrain_sampler is not None:
                state = state.replace(
                    point_heights=torch.where(fix[:, None], h_root[:, None], pt_h),
                    point_normals=torch.where(fix[:, None, None], n_root[:, None, :], pt_n))
        state = self._resample_commands(state, gen)
        state = self._refresh_post_physics(params, state, reset_mask=reset_mask)
        obs, privileged = self._compute_observations(params, state, gen)

        state = state.replace(
            last_actions=state.actions, last_dof_vel=state.sim.qd,
            last_root_vel=torch.cat([state.sim.root_lin_vel, state.sim.root_ang_vel], dim=-1),
            last_feet_pos=state.feet_pos)
        info = {"privileged_obs": privileged, "time_outs": state.time_out_buf,
                "rew_terms": rew_terms}
        return state, obs, rew, reset_mask, info


@pytest.mark.parametrize("terrain", ["plane", "trimesh"])
def test_cpu_step_is_the_former_step_bitwise(terrain, tmp_path):
    """Three control steps on the CPU, with a quarter of the envs forced to
    time out before the second: every state field, the observations, the
    rewards and their terms, the resets and the privileged observations
    equal the former step's bitwise."""
    urdf = write_t1_shaped_urdf(tmp_path)
    cfg = quiet_cfg(urdf, 16) if terrain == "plane" else rough_cfg(urdf, 16)
    env, former = T1(copy.deepcopy(cfg), "cpu"), FormerT1(copy.deepcopy(cfg), "cpu")
    gen = torch.Generator().manual_seed(5)
    params = env.init_params(gen)
    state, _, _ = env.reset_all(params, gen)
    states = [state, state]
    for i in range(3):
        if i == 1:
            states = [s.replace(episode_length=torch.where(
                torch.arange(16) % 4 == 0, env.max_episode_length + 1, s.episode_length))
                for s in states]
        actions = 0.3 * torch.randn(16, 12, generator=torch.Generator().manual_seed(i))
        outs = [e.step(params, s, actions, torch.Generator().manual_seed(10 + i))
                for e, s in zip((env, former), states)]
        (s_new, obs, rew, done, info), (s_old, obs_o, rew_o, done_o, info_o) = outs
        for f in dataclasses.fields(s_new):
            a, b = getattr(s_new, f.name), getattr(s_old, f.name)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), (i, f.name)
            else:
                for g in dataclasses.fields(a):
                    assert torch.equal(getattr(a, g.name), getattr(b, g.name)), (i, g.name)
        for a, b in ((obs, obs_o), (rew, rew_o), (done, done_o),
                     (info["privileged_obs"], info_o["privileged_obs"]),
                     (info["time_outs"], info_o["time_outs"])):
            assert torch.equal(a, b), i
        for k in info["rew_terms"]:
            assert torch.equal(info["rew_terms"][k], info_o["rew_terms"][k]), (i, k)
        states = [s_new, s_old]
        if i == 1:
            assert bool(done[::4].all()), "the forced time-outs reset"
    assert env.substep.launches == 0
