"""The port's T1Standup (booster_gym_torch/envs/standup.py), its export
wrapper and its checkpoints against the JAX package, on the serial
stand-in of booster_gym_torch.testing (the MJCF's 85 contact points).

Both envs are built from one config: 8 envs, no observation noise, a
bank settled for 2 control steps of 2 substeps (T1Standup.yaml: 60 of 10;
the JAX side runs op by op, about 1 s a substep, since XLA:CPU's compile
of a 23-DoF substep takes minutes and tens of GB).  Random values are
drawn the JAX way from its keys and handed to the port's functions of the
draws (_fallen_seed_states, _reset_from_bank), so both sides compute from
the same numbers.  Tolerances: 1e-6 where both sides do the same f32
elementwise arithmetic (actions, frames, the stack, rewards, resets);
rtol = atol = 2e-3, the physics tolerance, where a substep runs (the
bank's settle, an env step, whose resets are left out).
"""

import copy
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import booster_gym_tpu.utils.compile as jax_compile
from booster_gym_tpu.algo.ppo import PPO as JaxPPO
from booster_gym_tpu.envs import make_task as jax_make_task
from booster_gym_tpu.utils.config import load_task_cfg as jax_load_task_cfg
from export_model import actor_params_to_torch, standup_module

from booster_gym_torch import export as port_export
from booster_gym_torch.algo.ppo import PPO, OptState, flat_params
from booster_gym_torch.convert import (
    env_params_from_jax,
    env_state_from_jax,
    params_from_flax,
    sim_state_from_jax,
)
from booster_gym_torch.envs import make_task
from booster_gym_torch.envs.standup import StandupParams, StandupState, T1Standup
from booster_gym_torch.runner import Runner
from booster_gym_torch.testing import update_inputs, write_t1_serial_mjcf, write_t1_serial_urdf
from booster_gym_torch.utils.config import load_task_cfg

B = 8
EXACT = 1e-6
PHYS = 2e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def standup_cfg(urdf, mjcf, task="T1Standup"):
    cfg = jax_load_task_cfg(task)
    cfg["env"]["num_envs"] = B
    cfg["asset"]["file"] = urdf
    cfg["asset"]["mujoco_file"] = mjcf
    cfg["noise"] = {}
    cfg["standup"]["settle_rounds"] = 2
    cfg["control"]["decimation"] = 2
    return cfg


class _Eager:
    """The JAX side op by op: jax.disable_jit, and the package's
    jit_nofusion (the bank's settle) left as the plain function."""

    def __enter__(self):
        self._mp = pytest.MonkeyPatch()
        self._mp.setattr(jax_compile, "jit_nofusion", lambda fn, static_argnums=(): fn)
        self._dj = jax.disable_jit()
        self._dj.__enter__()

    def __exit__(self, *exc):
        self._dj.__exit__(*exc)
        self._mp.undo()


def host(tree):
    return jax.tree.map(np.asarray, tree)


def to_port_params(jparams):
    base = env_params_from_jax(host(jparams), "cpu")
    fields = {f: getattr(base, f) for f in base.__dataclass_fields__}
    return StandupParams(**fields, init_bank=sim_state_from_jax(host(jparams.init_bank), "cpu"))


def to_port_state(jstate):
    base = env_state_from_jax(host(jstate), "cpu")
    fields = {f: getattr(base, f) for f in base.__dataclass_fields__}
    return StandupState(**fields, obs_stack=torch.as_tensor(np.asarray(jstate.obs_stack)))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("standup")
    urdf, mjcf = write_t1_serial_urdf(d), write_t1_serial_mjcf(d)
    cfg = standup_cfg(urdf, mjcf)
    jenv = jax_make_task(copy.deepcopy(cfg))
    tenv = make_task(copy.deepcopy(cfg), "cpu")
    with _Eager():
        jparams = jenv.init_params(jax.random.PRNGKey(0))
        jstate, _, _ = jenv.reset_all(jparams, jax.random.PRNGKey(1))
    return types.SimpleNamespace(jenv=jenv, tenv=tenv, jparams=jparams, jstate=jstate,
                                 tparams=to_port_params(jparams), tstate=to_port_state(jstate),
                                 cfg=cfg, urdf=urdf, mjcf=mjcf)


def close(a, b, tol, label, keep=None):
    a, b = np.asarray(a), np.asarray(b)
    if keep is not None:
        a, b = a[keep], b[keep]
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=label)


def rand_states(pair, seed):
    """Random states on both sides: joints, velocities, gravity, actions,
    contact forces, heights and a stack of earlier frames, half the envs
    reset; one env non-finite."""
    rng = np.random.default_rng(seed)
    jenv, nd = pair.jenv, pair.tenv.model.num_dofs
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    s = pair.jstate
    g = f32(B, 3)
    g[:, 2] = np.linspace(-1.0, 0.5, B)
    pos = np.asarray(s.sim.root_pos).copy()
    pos[:, 2] = np.linspace(0.05, 0.7, B)
    qd = 0.5 * f32(B, nd)
    qd[0] *= 0.01                       # slow enough for the success term
    forces = 30.0 * np.abs(f32(B, pair.tenv.model.num_bodies, 3))
    q = 0.3 * f32(B, nd)
    q[B - 1, 3] = np.nan                # a faulted env
    jstate = s.replace(
        sim=s.sim.replace(q=jnp.asarray(q), qd=jnp.asarray(qd), root_pos=jnp.asarray(pos),
                          root_lin_vel=jnp.asarray(f32(B, 3)),
                          root_ang_vel=jnp.asarray(f32(B, 3))),
        base_ang_vel=jnp.asarray(f32(B, 3)), base_lin_vel=jnp.asarray(f32(B, 3)),
        projected_gravity=jnp.asarray(g), actions=jnp.asarray(f32(B, 12)),
        last_actions=jnp.asarray(f32(B, 12)), contact_forces=jnp.asarray(forces),
        obs_stack=jnp.asarray(f32(B, jenv.train_stack, 42)),
        reset_buf=jnp.asarray(np.arange(B) % 2 == 0),
        episode_length=jnp.asarray(np.arange(B) * 100, jnp.int32),
        terrain_height_root=jnp.asarray(0.01 * f32(B)))
    return jstate, to_port_state(jstate)


# ---------------------------------------------------------------------------
def test_geometry_and_registry(pair):
    tenv = pair.tenv
    assert isinstance(tenv, T1Standup)
    assert (tenv.model.num_dofs, tenv.num_actions, tenv.num_obs) == (23, 12, 420)
    assert tenv.model.num_points == pair.jenv.model.num_points == 85
    names = [tenv.model.dof_names[i] for i in tenv.action_indices.tolist()]
    assert names == [
        "Left_Shoulder_Pitch", "Left_Elbow_Yaw", "Right_Shoulder_Pitch", "Right_Elbow_Yaw",
        "Left_Hip_Pitch", "Left_Hip_Roll", "Left_Knee_Pitch", "Left_Ankle_Pitch",
        "Right_Hip_Pitch", "Right_Hip_Roll", "Right_Knee_Pitch", "Right_Ankle_Pitch"]
    close(tenv.default_subset, pair.jenv.default_subset, EXACT, "default subset")
    assert list(tenv.reward_scales) == list(pair.jenv.reward_scales)
    # the fine-tune stage: its own config, the standup class, the newest
    # checkpoint in place of a machine's path
    ft = load_task_cfg("T1StandupFT")
    assert ft["basic"]["env_class"] == "T1Standup" and ft["basic"]["checkpoint"] == -1
    assert ft["algorithm"]["update_tile"] == 2048   # read and ignored by the port


def test_apply_actions_matches_jax(pair):
    acts = np.random.default_rng(0).uniform(-8, 8, (B, 12)).astype(np.float32)
    ja, jt = pair.jenv._apply_actions(jnp.asarray(acts))
    ta, tt = pair.tenv._apply_actions(torch.as_tensor(acts))
    assert float(ta.abs().max()) == 5.0 and tt.shape == (B, 23)
    close(ta, ja, EXACT, "clipped actions")
    close(tt, jt, EXACT, "targets")


def test_observe_stack_and_privileged_match_jax(pair):
    jstate, tstate = rand_states(pair, seed=1)
    gen = torch.Generator().manual_seed(0)
    for step in range(2):
        jstate, jobs, jpriv = pair.jenv._observe(pair.jparams, jstate, jax.random.PRNGKey(step))
        tstate, tobs, tpriv = pair.tenv._observe(pair.tparams, tstate, gen)
        close(tobs, jobs, EXACT, f"obs {step}")
        close(tstate.obs_stack, jstate.obs_stack, EXACT, f"stack {step}")
        close(tpriv, jpriv, EXACT, f"privileged {step}")
        assert tobs.shape == (B, 420) and bool(torch.isfinite(tobs).all())
        # a reset env's stack is its first frame throughout
        st = tstate.obs_stack
        reset = tstate.reset_buf
        assert bool((st[reset] == st[reset][:, :1]).all())
        tstate = tstate.replace(reset_buf=torch.zeros_like(reset))
        jstate = jstate.replace(reset_buf=jnp.zeros(B, bool))
    # newest first: the second step's slot 1 is the first step's slot 0
    assert torch.equal(tobs[:, 42:84], tstate.obs_stack[:, 1])


def test_rewards_and_termination_match_jax(pair):
    jstate, tstate = rand_states(pair, seed=2)
    for name in ("standup_height", "standup_upright", "standup_posture",
                 "standup_feet_load", "standup_success"):
        j = getattr(pair.jenv, f"_reward_{name}")(pair.jparams, jstate)
        t = getattr(pair.tenv, f"_reward_{name}")(pair.tparams, tstate)
        ok = np.isfinite(np.asarray(j))
        close(t.numpy()[ok], np.asarray(j)[ok], EXACT, name)
    assert float(pair.tenv._reward_standup_success(pair.tparams, tstate).sum()) >= 0
    jt, jterms = pair.jenv._compute_reward(pair.jparams, jstate)
    tt, tterms = pair.tenv._compute_reward(pair.tparams, tstate)
    close(tt, jt, EXACT, "total")
    for k in jterms:
        close(tterms[k], jterms[k], EXACT, k)
    assert bool(torch.isfinite(tt).all())    # the faulted env's terms are zeroed
    jr = pair.jenv._check_termination(jstate)
    tr = pair.tenv._check_termination(tstate)
    np.testing.assert_array_equal(tr.reset_buf.numpy(), np.asarray(jr.reset_buf))
    np.testing.assert_array_equal(tr.time_out_buf.numpy(), np.asarray(jr.time_out_buf))
    assert bool(tr.reset_buf[B - 1])          # the non-finite env resets


def jax_fallen_draws(jenv, key):
    """The values JAX's _fallen_seed_states draws from `key`."""
    ks = jax.random.split(key, 5)
    ks2 = jax.random.split(ks[4], 3)
    nd = jenv.model.num_dofs
    t = lambda x: torch.as_tensor(np.asarray(x))
    return {"angle": t(jax.random.uniform(ks[0], (B,), minval=jnp.deg2rad(5.0),
                                          maxval=jnp.deg2rad(120.0))),
            "flip": t(jax.random.bernoulli(ks[1], 0.5, (B,))),
            "use_pitch": t(jax.random.bernoulli(ks[2], 0.5, (B,))),
            "yaw": t(jax.random.uniform(ks[3], (B,)) * 2 * jnp.pi),
            "q_noise": t(jax.random.uniform(ks[4], (B, nd), minval=-0.3, maxval=0.3)),
            "tip": t(jax.random.uniform(ks2[0], (B,), minval=jnp.deg2rad(10.0),
                                        maxval=jnp.deg2rad(50.0))),
            "depth": t(jax.random.uniform(ks2[1], (B, 1), minval=0.6, maxval=1.0))}


def test_fallen_seed_states_match_jax(pair):
    key = jax.random.PRNGKey(5)
    js = pair.jenv._fallen_seed_states(key)
    ts = pair.tenv._fallen_seed_states(jax_fallen_draws(pair.jenv, key))
    for f in ("root_pos", "root_quat", "root_lin_vel", "root_ang_vel", "q", "qd"):
        close(getattr(ts, f), getattr(js, f), EXACT, f)
    assert float(ts.root_pos[:, 2].min()) == 0.5


def test_bank_settle_matches_jax(pair):
    """The drops settled for 2 control steps (one control-step call each on
    the port's kernel path, here its plain loop), then the standing
    ladder."""
    key = jax.random.PRNGKey(6)
    with _Eager():
        jbank = pair.jenv._build_fallen_bank(pair.jparams, key)
    n0 = pair.tenv.substep.launches
    tbank = pair.tenv._standing_ladder(pair.tenv._settle(
        pair.tparams, pair.tenv._fallen_seed_states(jax_fallen_draws(pair.jenv, key))))
    assert pair.tenv.substep.launches == n0   # the CPU runs the plain loop
    for f in ("root_pos", "root_quat", "root_lin_vel", "root_ang_vel", "q", "qd"):
        close(getattr(tbank, f), getattr(jbank, f), PHYS, f)
    # the ladder: env 0 the default stance, upright, 2 envs (B / 4) in all
    close(tbank.q[0], pair.tenv.default_dof_pos, EXACT, "ladder depth 0")
    assert torch.equal(tbank.root_quat[:2], torch.tensor([[1.0, 0, 0, 0]] * 2))


def test_reset_from_bank_matches_jax(pair):
    key = jax.random.PRNGKey(7)
    jstate, tstate = rand_states(pair, seed=3)
    mask = np.arange(B) % 3 != 1
    ks = jax.random.split(key, 4)
    K = pair.jparams.init_bank.q.shape[0]
    t = lambda x: torch.as_tensor(np.asarray(x))
    draws = {"idx": t(jax.random.randint(ks[0], (B,), 0, K)).long(),
             "q_noise": t(jax.random.uniform(ks[1], (B, 23), minval=-0.05, maxval=0.05)),
             "dyaw": t(jax.random.uniform(ks[2], (B,)) * 2 * jnp.pi),
             "delay": t(jax.random.randint(ks[3], (B,), 0, pair.jenv.decimation)).long()}
    jr = pair.jenv._reset_envs(pair.jparams, jstate, jnp.asarray(mask), key)
    tr = pair.tenv._reset_from_bank(pair.tparams, tstate, torch.as_tensor(mask), draws)
    for f in ("root_pos", "root_quat", "root_lin_vel", "root_ang_vel", "q", "qd"):
        a, b = getattr(tr.sim, f).numpy(), np.asarray(getattr(jr.sim, f))
        close(a[mask], b[mask], EXACT, f)
    for f in ("actions", "last_actions", "last_dof_targets", "last_root_vel", "episode_length",
              "filtered_lin_vel", "delay_steps", "cmd_resample_time"):
        close(getattr(tr, f).numpy()[mask], np.asarray(getattr(jr, f))[mask], EXACT, f)
    # the envs outside the mask keep their state
    assert torch.equal(tr.sim.qd[~torch.as_tensor(mask)], tstate.sim.qd[~torch.as_tensor(mask)])


def test_one_env_step_matches_jax(pair):
    acts = (0.5 * np.random.default_rng(4).standard_normal((B, 12))).astype(np.float32)
    with _Eager():
        jstate, jobs, jrew, jdone, jinfo = pair.jenv.step(pair.jparams, pair.jstate,
                                                          jnp.asarray(acts))
    tstate, tobs, trew, tdone, tinfo = pair.tenv.step(
        pair.tparams, pair.tstate, torch.as_tensor(acts), torch.Generator().manual_seed(0))
    keep = ~(np.asarray(jdone) | tdone.numpy())
    assert keep.sum() >= B // 2
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    close(tobs, jobs, PHYS, "obs", keep)
    close(tstate.obs_stack, jstate.obs_stack, PHYS, "stack", keep)
    close(tinfo["privileged_obs"], jinfo["privileged_obs"], PHYS, "privileged", keep)
    close(trew, jrew, PHYS, "reward", keep)
    for k, v in tinfo["rew_terms"].items():
        close(v, jinfo["rew_terms"][k], PHYS, k, keep)


# ---------------------------------------------------------------------------
# PPO at the standup config
@pytest.mark.parametrize("backend", ["fused", "xla"])
def test_ppo_standup_settings_on_both_backends(backend):
    """init_logstd -1, bound_coef 0.2 and the min_logstd clamp at -2 after
    every mini-epoch, as the JAX package's PPO reads them (ppo.py:91-112,
    357-358, 410-412)."""
    cfg = load_task_cfg("T1Standup")
    cfg["algorithm"]["update_backend"] = backend
    cfg["runner"]["mini_epochs"] = 2
    env = types.SimpleNamespace(num_actions=12, num_obs=420, num_privileged_obs=14)
    ppo = PPO(env, cfg, "cpu")
    jcfg = jax_load_task_cfg("T1Standup")
    jppo = JaxPPO(env, jcfg)
    assert ppo.bound_coef == jppo.bound_coef == 0.2
    assert ppo.min_logstd == jppo.min_logstd == -2.0
    assert bool((ppo.network.logstd == -1.0).all())
    ppo.network.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        ppo.network.logstd.fill_(-2.5)
    d = update_inputs(ppo.network, 3, 16, "cpu", seed=1)
    n = flat_params(ppo.network).numel()
    ts = types.SimpleNamespace(opt=OptState(m=torch.zeros(n), v=torch.zeros(n), count=0),
                               lr=torch.tensor(1e-3))
    opt, _, stats = ppo.update(ts, (None, d["obs_last"], d["priv_last"]), d["buf"])
    # from -2.5, two Adam steps of ~1e-3 would leave it near -2.5: the clamp
    # lifts it to -2 after the first, the second moves it by at most ~1e-3
    ls = ppo.network.logstd
    assert bool((ls >= -2.0).all() and (ls < -1.99).all()) and opt.count == 2
    assert bool(torch.isfinite(stats).all())


# ---------------------------------------------------------------------------
# export and checkpoints
def jax_standup_checkpoint(path, seed=0):
    """A JAX T1Standup checkpoint as the JAX recorder's pickle fallback
    writes it: flax params of the 420-wide actor, optax's state, lr,
    iteration, curriculum."""
    env = types.SimpleNamespace(num_actions=12, num_obs=420, num_privileged_obs=14)
    jppo = JaxPPO(env, jax_load_task_cfg("T1Standup"))
    params = jppo.network.init(jax.random.PRNGKey(seed), jnp.zeros((1, 420)), jnp.zeros((1, 14)))
    rng = np.random.default_rng(seed)
    opt_state = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape) ** 2, x.dtype)
                             if x.dtype == jnp.float32 else x, jppo.tx.init(params))
    saved = host({"params": params, "opt_state": opt_state, "lr": jnp.float32(1e-5),
                  "iteration": jnp.int32(12), "curriculum": jnp.ones((3, 3))})
    with open(path, "wb") as f:
        pickle.dump(saved, f)
    return saved


def test_standup_export_matches_jax_standup_module(tmp_path):
    ckpt = tmp_path / "logs" / "run" / "nn" / "model_12.ckpt"
    ckpt.parent.mkdir(parents=True)
    saved = jax_standup_checkpoint(ckpt)
    cfg = jax_load_task_cfg("T1Standup")
    ref = standup_module(actor_params_to_torch(saved["params"]), cfg)
    path = port_export.main(["--task=T1Standup", f"--checkpoint={ckpt}", "--output",
                             str(tmp_path / "standup.pt")])
    ours = torch.jit.load(path)
    rng = np.random.default_rng(3)
    obs = torch.as_tensor(rng.normal(size=(16, 42)).astype(np.float32))
    stack = torch.as_tensor(rng.normal(size=(16, 50, 42)).astype(np.float32))
    with torch.no_grad():
        a, b = ours(obs, stack), ref(obs, stack)
    assert a.shape == (16, 12) and torch.equal(a, b)
    assert torch.equal(a, torch.jit.script(ref)(obs, stack))
    # the walk task's export stays the bare actor
    assert not isinstance(port_export.deploy_module(torch.nn.Identity(), load_task_cfg("T1")),
                          port_export.StandupActor)


def test_jax_standup_checkpoint_loads_without_jax_and_resumes(tmp_path):
    """In a fresh interpreter the port reads a JAX T1Standup pickle
    checkpoint into the 420-wide ActorCritic with JAX never imported; a
    port Runner on the standup config restores its params bitwise."""
    ckpt = tmp_path / "model_12.ckpt"
    saved = jax_standup_checkpoint(ckpt, seed=1)
    out = tmp_path / "params.pt"
    code = (
        "import sys, torch\n"
        "from booster_gym_torch.algo.networks import ActorCritic\n"
        "from booster_gym_torch.convert import train_state_from_jax_checkpoint\n"
        "from booster_gym_torch.utils.recorder import load_checkpoint\n"
        f"p = train_state_from_jax_checkpoint(ActorCritic(12, 420, 14), load_checkpoint({str(ckpt)!r}))\n"
        "torch.save(p['params'], sys.argv[1])\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'flax', 'booster_gym_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code, str(out)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout
    want = params_from_flax(saved["params"])
    ours = torch.load(out, weights_only=True)
    assert ours["actor.layers.0.weight"].shape == (256, 420)
    assert all(torch.equal(ours[k], want[k]) for k in want)

    d = tmp_path / "assets"
    d.mkdir()
    cfg = load_task_cfg("T1Standup")
    cfg["env"]["num_envs"] = 4
    cfg["asset"]["file"] = write_t1_serial_urdf(d)
    cfg["asset"]["mujoco_file"] = write_t1_serial_mjcf(d)
    cfg["standup"]["settle_rounds"] = 1
    cfg["basic"]["checkpoint"] = str(ckpt)
    runner = Runner(cfg, device="cpu")
    _, ts = runner._init_state()
    sd = runner.ppo.network.state_dict()
    assert all(torch.equal(sd[k], want[k]) for k in want)
    assert ts.iteration == 12 and float(ts.lr) == float(np.float32(1e-5))
