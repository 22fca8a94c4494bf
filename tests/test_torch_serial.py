"""The 23-DoF serial robot in the port against the JAX package, on the
serial stand-in of booster_gym_torch.testing (24 bodies, 23 DoF in the
SDK's serial order; 121 contact points from its URDF, 85 from its MJCF):

  * forward kinematics and the mass matrix (rtol 1e-5 / atol 1e-5: the
    same f32 products in another order), and one substep of the plain
    engine against the JAX XLA-op engine on both point sets (the JAX
    package's kernel-vs-engine tolerances: rtol = atol = 2e-3 on the state,
    rtol 5e-2 / atol 1 N on the contact forces).  The JAX side runs op by op
    (eager, jax.disable_jit for the env's scans): XLA:CPU's compile of a
    23-DoF substep takes minutes and tens of GB, and the Pallas kernel in
    interpret mode longer still;
  * the launch shape csrc/substep.cu picks from kernel_sizes' sizes (its
    env working set and shared-memory arithmetic, compiled by the host C++
    compiler): T1's unchanged, the serial robot's on both point sets;
  * T1Serial: its dims, gains, default angles and penalised bodies, and
    three env steps against the JAX env (rtol = atol = 2e-3, the physics
    tolerance, on observations, rewards and reward terms; resets left out;
    2 substeps a control step, where T1Serial.yaml has 10, to keep the JAX
    side's op-by-op steps short);
  * the update's plain versions at T1Serial's 23 actions and at
    T1Standup's 434-wide critic input against the JAX package's Pallas
    update kernels in interpret mode (tests/test_torch_update.py's
    tolerances)
  (tests/test_torch_serial_kernel.py holds the kernels at these sizes on
  the card).
"""

import copy
import functools
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from booster_gym_tpu.algo.networks import ActorCritic as JaxActorCritic
from booster_gym_tpu.algo.update_kernel import FusedUpdate as JaxFusedUpdate
from booster_gym_tpu.envs.t1 import T1 as JaxT1
from booster_gym_tpu.model import load_urdf as jax_load_urdf
from booster_gym_tpu.model.mjcf_points import with_mjcf_collision as jax_with_mjcf
from booster_gym_tpu.physics import DynParams as JDyn, SimConfig as JCfg, SimState as JState
from booster_gym_tpu.physics import dynamics as jdyn
from booster_gym_tpu.physics import kinematics as jkin
from booster_gym_tpu.physics.engine import make_substep as jax_make_substep
from booster_gym_tpu.terrain import Terrain as JTerrain
from booster_gym_tpu.utils.config import load_task_cfg as jax_load_task_cfg

from booster_gym_torch.algo.networks import ActorCritic
from booster_gym_torch.algo.ppo import flat_params
from booster_gym_torch.algo.update_kernel import FusedUpdate, param_layout
from booster_gym_torch.convert import (
    env_params_from_jax,
    env_state_from_jax,
    flat_from_flax,
    flat_from_leaves,
    params_from_flax,
)
from booster_gym_torch.envs import make_task
from booster_gym_torch.model import load_urdf
from booster_gym_torch.model.mjcf_points import with_mjcf_collision
from booster_gym_torch.physics import DynParams, SimConfig, SimState
from booster_gym_torch.physics import dynamics as tdyn
from booster_gym_torch.physics import substep_kernel as sk
from booster_gym_torch.physics.engine import ModelConsts, make_substep
from booster_gym_torch.physics.kinematics import forward_kinematics
from booster_gym_torch.testing import (
    task_dims,
    write_t1_serial_mjcf,
    write_t1_serial_urdf,
    write_t1_shaped_urdf,
)

STATE_TOL = 2e-3
ENV_TOL = 2e-3
GAMMA, LAM = 0.995, 0.95


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("serial")
    return write_t1_serial_urdf(d), write_t1_serial_mjcf(d)


def rand_state(model, B, seed):
    """Random states and contact materials as numpy (the JAX package's
    _rand_inputs)."""
    rng = np.random.default_rng(seed)
    nd, ns = model.num_dofs, len(model.shape_body)
    f32 = lambda x: np.asarray(x, np.float32)
    quat = rng.normal(size=(B, 4))
    quat[: B // 2] = [1, 0, 0, 0]
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    pos = np.zeros((B, 3))
    pos[:, 2] = rng.uniform(0.2, 0.8, B)
    state = dict(root_pos=f32(pos), root_quat=f32(quat),
                 root_lin_vel=f32(rng.uniform(-1, 1, (B, 3))),
                 root_ang_vel=f32(rng.uniform(-1, 1, (B, 3))),
                 q=f32(rng.uniform(-1, 1, (B, nd))), qd=f32(rng.uniform(-2, 2, (B, nd))))
    dyn = dict(body_mass=f32(np.tile(model.body_mass, (B, 1))),
               body_com=f32(np.tile(model.body_com, (B, 1, 1))),
               body_inertia=f32(np.tile(model.body_inertia, (B, 1, 1, 1))),
               shape_friction=f32(rng.uniform(0.5, 1.5, (B, ns))),
               shape_restitution=f32(rng.uniform(0.0, 0.5, (B, ns))))
    return state, dyn, f32(rng.uniform(-5, 5, (B, nd))), f32(rng.uniform(-2, 2, (B, 3))), \
        f32(rng.uniform(-0.5, 0.5, (B, 3)))


# ---------------------------------------------------------------------------
# kinematics, dynamics, one substep
def test_serial_fk_and_mass_matrix_match_jax(assets):
    urdf, _ = assets
    jmodel, tmodel = jax_load_urdf(urdf), load_urdf(urdf)
    assert tmodel.body_names == jmodel.body_names and tmodel.dof_names == jmodel.dof_names
    state, dyn, *_ = rand_state(tmodel, 16, seed=1)
    jR, jp = jkin.forward_kinematics(jmodel, *(jnp.asarray(state[k]) for k in
                                               ("root_pos", "root_quat", "q")))
    consts = ModelConsts.build(tmodel, "cpu")
    tR, tp = forward_kinematics(consts, *(torch.as_tensor(state[k]) for k in
                                          ("root_pos", "root_quat", "q")))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-5)

    root = jnp.asarray(state["root_pos"])
    jphi = jdyn.phi_columns(jmodel, jR, jp, root)
    jJ = jdyn.jacobians(jmodel, jdyn._ancestor_dof_mask(jmodel), jphi)
    jI = jdyn.spatial_inertias(*(jnp.asarray(dyn[k]) for k in ("body_mass", "body_com",
                                                               "body_inertia")), jR, jp, root)
    jM = jdyn.mass_matrix(jJ, jI)
    t = lambda k: torch.as_tensor(dyn[k])
    tphi = tdyn.phi_columns(consts, tR, tp, torch.as_tensor(state["root_pos"]))
    tM = tdyn.mass_matrix(tdyn.jacobians(consts, tphi), tdyn.spatial_inertias(
        t("body_mass"), t("body_com"), t("body_inertia"), tR, tp,
        torch.as_tensor(state["root_pos"])))
    assert tM.shape == (16, 29, 29)
    np.testing.assert_allclose(tM.numpy(), np.asarray(jM), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("points", ["urdf", "mjcf"])
def test_serial_substep_matches_jax_engine(assets, points):
    urdf, mjcf = assets
    jmodel, tmodel = jax_load_urdf(urdf), load_urdf(urdf)
    if points == "mjcf":
        jmodel, tmodel = jax_with_mjcf(jmodel, mjcf), with_mjcf_collision(tmodel, mjcf)
    assert tmodel.num_points == (121 if points == "urdf" else 85)
    feet = [tmodel.body_names.index("left_foot_link"),
            tmodel.body_names.index("right_foot_link")]
    terrain = JTerrain({"type": "plane", "static_friction": 1.0, "restitution": 0.0})
    # eager: XLA:CPU's compile of the 23-DoF substep takes minutes and tens
    # of GB, op by op it takes seconds
    jstep = jax_make_substep(jmodel, JCfg(), terrain, feet_indices=feet)
    tstep = make_substep(tmodel, SimConfig(), feet, "cpu")
    state, dyn, tau, ef, et = rand_state(tmodel, 32, seed=2)
    out_j = jstep(JState(**{k: jnp.asarray(v) for k, v in state.items()}),
                  JDyn(**{k: jnp.asarray(v) for k, v in dyn.items()}),
                  jnp.asarray(tau), jnp.asarray(ef), jnp.asarray(et))
    out_t = tstep(SimState(**{k: torch.as_tensor(v) for k, v in state.items()}),
                  DynParams(**{k: torch.as_tensor(v) for k, v in dyn.items()}),
                  torch.as_tensor(tau), torch.as_tensor(ef), torch.as_tensor(et))
    for name in SimState.FIELDS:
        np.testing.assert_allclose(getattr(out_t[0], name).numpy(),
                                   np.asarray(getattr(out_j[0], name)),
                                   rtol=STATE_TOL, atol=STATE_TOL, err_msg=name)
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), rtol=5e-2, atol=1.0)
    for a, b in zip(out_t[2:], out_j[2:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=STATE_TOL, atol=STATE_TOL)


# ---------------------------------------------------------------------------
# K1's launch shape
def source_launch_shape(sizes, tmp_path):
    """(EPB, MINB, SMEM_BYTES) as csrc/substep.cu computes them for these -D
    sizes: its size macros, EnvWS and launch-shape constexprs (the text
    from NV's definition up to the static_assert), compiled for the host."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = open(sk.CSRC).read()
    part = src[src.index("#define NV (6 + ND)"):src.index("static_assert(EPB >= 1")]
    cpp, exe = tmp_path / "shape.cpp", tmp_path / "shape"
    cpp.write_text("#include <cstdio>\n" + part
                   + 'int main() { printf("%d %d %d", (int)(EPB), (int)(MINB), SMEM_BYTES); }\n')
    subprocess.run([cxx, "-std=c++17", *[f"-D{k}={v}" for k, v in sizes.items()], str(cpp),
                    "-o", str(exe)], check=True)
    return tuple(int(v) for v in subprocess.run([str(exe)], check=True, capture_output=True,
                                                text=True).stdout.split())


@pytest.mark.parametrize("robot,shape", [
    ("t1", (8, 4, 56736)),          # 4 blocks of 56.7 KB an SM
    ("serial", (7, 2, 104204)),     # 121 URDF points: 2 blocks of 7 envs
    ("standup", (8, 2, 115436)),    # 85 MJCF points: 2 blocks of 8 envs
])
def test_kernel_sizes_pick_the_launch_shape_from_the_robot(assets, tmp_path, robot, shape):
    urdf, mjcf = assets
    if robot == "t1":
        model = load_urdf(write_t1_shaped_urdf(tmp_path), cylinder_rim_points=4)
    else:
        model = load_urdf(urdf)
        if robot == "standup":
            model = with_mjcf_collision(model, mjcf)
    feet = [model.body_names.index("left_foot_link"), model.body_names.index("right_foot_link")]
    sizes = sk.kernel_sizes(model, feet, num_edges=4)
    assert set(sizes) == {"NB", "ND", "NPT", "NS", "NF", "NE", "PLANE"}
    epb, minb, smem = source_launch_shape(sizes, tmp_path)
    assert (epb, minb, smem) == shape
    # the block fits 227 KB, MINB blocks an SM's 228 KB (1 KB reserved a block)
    assert smem <= 232448 and minb * (smem + 1024) <= 233472 and epb * minb <= 32


# ---------------------------------------------------------------------------
# T1Serial
def serial_cfg(urdf, num_envs):
    cfg = jax_load_task_cfg("T1Serial")
    cfg["env"]["num_envs"] = num_envs
    cfg["asset"]["file"] = urdf
    for spec in cfg["noise"].values():
        spec["range"] = [0.0, 0.0]
    cfg["randomization"]["kick_interval_s"] = 1000.0
    cfg["randomization"]["push_interval_s"] = 1000.0
    return cfg


@pytest.fixture(scope="module")
def serial_pair(assets):
    urdf, _ = assets
    cfg = serial_cfg(urdf, 8)
    # 2 substeps a control step (T1Serial.yaml: 10): the JAX side runs op by
    # op, about 1 s a substep, and the loop's code is the same at any count
    cfg["control"]["decimation"] = 2
    jenv = JaxT1(copy.deepcopy(cfg))
    tenv = make_task(copy.deepcopy(cfg), "cpu")
    jparams = jenv.init_params(jax.random.PRNGKey(0))
    jstate, _, _ = jenv.reset_all(jparams, jax.random.PRNGKey(1))
    host = lambda x: jax.tree.map(np.asarray, x)
    return jenv, tenv, jparams, jstate, env_params_from_jax(host(jparams), "cpu"), \
        env_state_from_jax(host(jstate), "cpu")


def test_t1serial_dims_gains_and_defaults_match_jax(serial_pair):
    jenv, tenv = serial_pair[:2]
    assert (tenv.num_obs, tenv.num_actions, tenv.num_privileged_obs) == (80, 23, 14)
    assert tenv.model.num_points == 121 and tenv.model.num_bodies == 24
    # the JAX env keeps the gains in float64, the port in float32
    for ours, theirs in ((tenv.base_stiffness, jenv.base_stiffness),
                         (tenv.base_damping, jenv.base_damping)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs, np.float32))
    np.testing.assert_array_equal(tenv.default_dof_pos.numpy(), np.asarray(jenv.default_dof_pos))
    # full joint names win over substrings in document order
    named = dict(zip(tenv.model.dof_names, tenv.default_dof_pos.tolist()))
    assert named["Left_Shoulder_Roll"] == pytest.approx(-1.35)
    assert named["Right_Elbow_Yaw"] == pytest.approx(0.5)
    assert named["Right_Shoulder_Pitch"] == pytest.approx(0.2)
    assert named["AAHead_yaw"] == 0.0 and named["Left_Knee_Pitch"] == pytest.approx(0.4)
    assert tenv.penalized_contact_indices == list(jenv.penalized_contact_indices)
    hands = [tenv.model.body_index(f"{s}_hand_link") for s in ("left", "right")]
    assert set(hands) <= set(tenv.penalized_contact_indices)
    assert list(tenv.reward_scales) == list(jenv.reward_scales)


def test_t1serial_three_steps_match_jax(serial_pair):
    jenv, tenv, jparams, jstate, tparams, tstate = serial_pair
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    compared = 0
    for step in range(3):
        actions = (0.3 * rng.standard_normal((8, 23))).astype(np.float32)
        with jax.disable_jit():   # op by op (see test_serial_substep_matches_jax_engine)
            jstate, jobs, jrew, jdone, jinfo = jenv.step(jparams, jstate, jnp.asarray(actions))
        tstate, tobs, trew, tdone, tinfo = tenv.step(tparams, tstate, torch.as_tensor(actions),
                                                     gen)
        keep = ~(np.asarray(jdone) | tdone.numpy())
        assert keep.sum() >= 4, "too many resets to compare"
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        for label, a, b in (("obs", tobs, jobs), ("reward", trew, jrew),
                            ("privileged", tinfo["privileged_obs"], jinfo["privileged_obs"]),
                            *((k, v, jinfo["rew_terms"][k]) for k, v in tinfo["rew_terms"].items())):
            np.testing.assert_allclose(a.numpy()[keep], np.asarray(b)[keep], rtol=ENV_TOL,
                                       atol=ENV_TOL, err_msg=f"{label}, step {step}")
        assert tobs.shape == (8, 80)
        compared += int(keep.sum())
    assert compared > 0


# ---------------------------------------------------------------------------
# the update's plain versions at the new widths, against the Pallas kernels
WIDTHS = {task: task_dims(task) for task in ("T1Serial", "T1Standup")}


def make_update(task, dtype, seed=0):
    na, no, npv = WIDTHS[task]
    jnet = JaxActorCritic(na, no, npv, compute_dtype=dtype)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, no)), jnp.zeros((1, npv)))
    rng = np.random.default_rng(seed + 100)
    params = jax.tree.map(
        lambda p: p + jnp.asarray(0.05 * rng.normal(size=p.shape), jnp.float32)
        if p.ndim == 1 or p.shape[0] == 1 else p, params)
    jfused = JaxFusedUpdate(no, npv, na, clip_ratio=0.2, bound_coef=0.2, compute_dtype=dtype,
                            tile=128, interpret=True)
    net = ActorCritic(na, no, npv, compute_dtype=dtype)
    net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jfused, jnet, params, FusedUpdate(net, clip_ratio=0.2, bound_coef=0.2), net


def update_batch(task, jnet, params, rng, T, B):
    na, no, npv = WIDTHS[task]
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    obs, priv = f32(T, B, no), f32(T, B, npv)
    mu, std = (np.asarray(x) for x in jnet.apply(params, jnp.asarray(obs),
                                                  method=JaxActorCritic.act))
    act = (mu + std * f32(T, B, na)).astype(np.float32)
    logp = np.sum(-0.5 * ((act - mu) / std) ** 2 - np.log(std) - 0.5 * np.log(2 * np.pi), -1)
    return dict(obs=obs, priv=priv, act=act, adv=(0.3 + 2.0 * f32(T, B)), ret=f32(T, B),
                old_logp=(logp + 0.3 * f32(T, B)).astype(np.float32),
                mu_old=(mu + 0.02 * f32(T, B, na)).astype(np.float32), obs_last=f32(B, no),
                priv_last=f32(B, npv))


def port_prep(fused, d):
    tt = lambda x: torch.as_tensor(np.array(x))
    return fused.prepare(*(tt(d[k]) for k in ("obs", "priv", "act", "mu_old", "old_logp",
                                              "obs_last", "priv_last")))


@pytest.mark.parametrize("task", sorted(WIDTHS))
def test_gae_plain_matches_jax_at_new_widths(task):
    jfused, jnet, params, fused, net = make_update(task, "f32")
    T, B = 4, 96
    rng = np.random.default_rng(1)
    d = update_batch(task, jnet, params, rng, T, B)
    rew = rng.normal(size=(T, B)).astype(np.float32)
    done, timeout = rng.random((T, B)) < 0.2, rng.random((T, B)) < 0.1
    nonterm, tf = 1.0 - (done | timeout).astype(np.float32), timeout.astype(np.float32)
    adv_j, ret_j, sa_j, sa2_j = jax.jit(functools.partial(jfused.gae, gamma=GAMMA, lam=LAM))(
        params, *(jnp.asarray(x) for x in (d["obs"], d["priv"], d["obs_last"], d["priv_last"],
                                           rew, nonterm, tf)))
    tt = torch.as_tensor
    adv, ret, sa, sa2 = fused.gae(fused.stage(flat_params(net)), port_prep(fused, d)["obsc"],
                                  tt(rew), tt(nonterm), tt(tf), GAMMA, LAM)
    np.testing.assert_allclose(adv.numpy(), np.asarray(adv_j), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(ret.numpy(), np.asarray(ret_j), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(float(sa), float(sa_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(sa2), float(sa2_j), rtol=1e-4, atol=1e-4)


def jax_grads_stats(jfused, params, d, mean, rstd, self_old):
    prep = jfused.prepare(*(jnp.asarray(d[k]) for k in ("obs", "priv", "act", "mu_old",
                                                        "old_logp")))
    # bf16: XLA:CPU's excess precision off, so that interpret mode rounds
    # where the kernel says it does (tests/test_torch_update.py)
    fn = jax.jit(functools.partial(jfused.grads_stats_prepared, self_old=self_old),
                 compiler_options={"xla_allow_excess_precision": False})
    return fn(params, prep, jnp.asarray(d["adv"]), jnp.asarray(d["ret"]), jnp.float32(mean),
              jnp.float32(rstd))


@pytest.mark.parametrize("task", sorted(WIDTHS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_grads_stats_plain_matches_jax_at_new_widths(task, dtype):
    """f32: every leaf to rtol 2e-4 / atol 5e-7, the sums to 1e-4; bf16: the
    gradient to 2.5 bf16 ulps (2.5 * 2^-8) of its norm."""
    jfused, jnet, params, fused, net = make_update(task, dtype)
    na = WIDTHS[task][0]
    d = update_batch(task, jnet, params, np.random.default_rng(2), 3, 96)
    mean, rstd = float(d["adv"].mean()), float(1.0 / (d["adv"].std(ddof=1) + 1e-8))
    g_j, st_j, mu_j, logp_j = jax_grads_stats(jfused, params, d, mean, rstd, 0.0)
    p = flat_params(net)
    g, st, mu, logp = fused.grads_stats(fused.stage(p), p, port_prep(fused, d),
                                        torch.as_tensor(d["adv"]), torch.as_tensor(d["ret"]),
                                        torch.tensor(mean), torch.tensor(rstd), False)
    g_ref = flat_from_flax(net, jax.tree.map(np.asarray, g_j))
    if dtype == "f32":
        for name, (off, shape) in param_layout(net).items():
            n = int(np.prod(shape))
            np.testing.assert_allclose(g[off:off + n].numpy(), g_ref[off:off + n].numpy(),
                                       rtol=2e-4, atol=5e-7, err_msg=name)
        for k in ("vl", "al", "bhi", "blo", "klsq"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(st_j[k]), rtol=1e-4,
                                       atol=1e-6 * 288 if k == "al" else 1e-9, err_msg=k)
        np.testing.assert_allclose(logp.numpy(), np.asarray(logp_j).reshape(-1), rtol=2e-4,
                                   atol=1e-5)
    else:
        assert float((g - g_ref).norm() / g_ref.norm()) <= 2.5 * 2.0 ** -8
    np.testing.assert_allclose(mu.numpy(), np.moveaxis(np.asarray(mu_j), 0, -1).reshape(-1, na),
                               rtol=2e-4 if dtype == "f32" else 2.0 ** -7,
                               atol=1e-6 if dtype == "f32" else 2.0 ** -9)
    assert st["klsq"].shape == (na,)


@pytest.mark.parametrize("task", sorted(WIDTHS))
def test_opt_stage_plain_matches_jax_at_new_widths(task):
    """K4 at 196,271 (T1Serial) and 368,921 (T1Standup) parameters."""
    jfused, jnet, params, fused, net = make_update(task, "bf16")
    assert fused.n_params == {"T1Serial": 196271, "T1Standup": 368921}[task]
    rng = np.random.default_rng(3)
    rand = lambda scale, f=lambda x: x: jax.tree.map(
        lambda q: jnp.asarray(f(rng.normal(size=q.shape)) * scale, jnp.float32), params)
    grads, mu, nu = rand(0.3), rand(1e-2), rand(1e-3, np.abs)
    kw = dict(entropy_coef=-0.01, b1=0.9, b2=0.999, eps=1e-8, max_norm=1.0)
    p_j, m_j, v_j, _ = jax.jit(functools.partial(jfused.opt_stage, **kw))(
        *(jfused.param_leaves(t) for t in (grads, params, mu, nu)), jnp.int32(7),
        jnp.float32(1e-3))
    flat = lambda t: flat_from_flax(net, jax.tree.map(np.asarray, t))
    p2, m2, v2, staged = fused.opt_stage(flat(grads), flat_params(net), flat(mu), flat(nu), 7,
                                         torch.tensor(1e-3), **kw)
    for ours, theirs in ((p2, p_j), (m2, m_j), (v2, v_j)):
        np.testing.assert_allclose(ours.numpy(),
                                   flat_from_leaves(net, jax.tree.map(np.asarray, theirs)).numpy(),
                                   rtol=1e-5, atol=1e-7)
    assert torch.equal(staged, p2.to(torch.bfloat16))
