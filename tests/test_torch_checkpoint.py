"""The port's checkpoints, resume and play on the CPU, and the JAX
package's pickle checkpoints read without JAX.

Tiny runs as tests/test_checkpoint.py has them: 8 envs, horizon 4, 2
mini-epochs, seed 11, on the plane and on a small trimesh field.
Tolerances: every restored piece, and two resumes from one checkpoint,
bitwise; the JAX checkpoint's pieces against convert.py on the
JAX-unpickled tree bitwise; the actor on that checkpoint against the JAX
PPO.act at bf16, one bf16 ulp (8e-3, tests/test_torch_ppo.py's network
tolerance); one Adam step from the restored state against the JAX
_flat_optimizer_step at rtol 1e-5 / atol 1e-7.
"""

import json
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

from booster_gym_tpu.algo.ppo import PPO as JaxPPO
from booster_gym_tpu.utils.config import load_task_cfg as jax_load_task_cfg
from booster_gym_tpu.utils.recorder import load_checkpoint as jax_load_checkpoint

from booster_gym_torch.algo.networks import ActorCritic
from booster_gym_torch.algo.ppo import PPO, flat_params
from booster_gym_torch.convert import (
    flat_from_flax,
    params_from_flax,
    train_state_from_jax_checkpoint,
)
from booster_gym_torch.runner import Runner
from booster_gym_torch.testing import write_t1_shaped_urdf
from booster_gym_torch.utils.config import load_task_cfg
from booster_gym_torch.utils.recorder import load_checkpoint, resolve_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CKPT = os.path.join(REPO, "logs", "2026-08-17-04-03-56", "nn", "model_1100.ckpt")
NA, NO, NP = 12, 47, 14
ENV = types.SimpleNamespace(num_actions=NA, num_obs=NO, num_privileged_obs=NP)
TERRAINS = ["plane", "trimesh"]


def tiny_cfg(tmp_path, terrain, checkpoint=None, max_iterations=2, save_interval=1):
    cfg = load_task_cfg("T1")
    cfg["env"]["num_envs"] = 8
    cfg["terrain"]["type"] = terrain
    if terrain == "trimesh":
        cfg["terrain"].update(num_terrains=2, terrain_width=4.0, terrain_length=4.0,
                              border_size=2.0)
    cfg["runner"].update(horizon_length=4, mini_epochs=2, save_interval=save_interval)
    cfg["basic"].update(max_iterations=max_iterations, checkpoint=checkpoint, seed=11)
    cfg["asset"]["file"] = write_t1_shaped_urdf(tmp_path)
    return cfg


def same(a, b):
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def assert_restored(runner, ts, saved):
    """Every piece of `saved` (a port checkpoint dict) restored bitwise."""
    sd = runner.ppo.network.state_dict()
    assert sorted(sd) == sorted(saved["params"])
    for k, v in saved["params"].items():
        assert same(sd[k], v), k
    assert same(ts.opt.m, saved["adam_m"]) and same(ts.opt.v, saved["adam_v"])
    assert ts.opt.count == saved["adam_count"]
    assert same(ts.lr, torch.tensor(saved["lr"], dtype=torch.float32))
    assert ts.iteration == saved["iteration"]
    assert same(ts.env_state.curriculum_prob, saved["curriculum"])
    assert same(runner.gen.get_state(), saved["gen_state"])


@pytest.mark.parametrize("terrain", TERRAINS)
def test_train_then_resume_restores_every_piece(tmp_path, monkeypatch, terrain):
    monkeypatch.chdir(tmp_path)
    runner = Runner(tiny_cfg(tmp_path, terrain), device="cpu")
    runner.train()
    path = resolve_checkpoint(-1)
    assert path.endswith("model_2.pt")
    saved = load_checkpoint(path)
    live = runner.train_state
    assert saved["iteration"] == 2 and saved["adam_count"] == 2 * 2
    assert same(saved["adam_m"], live.opt.m) and same(saved["gen_state"], runner.gen.get_state())

    resumed = Runner(tiny_cfg(tmp_path, terrain, checkpoint=-1, max_iterations=3), device="cpu")
    assert resumed.checkpoint == path
    _, ts = resumed._init_state()
    assert_restored(resumed, ts, saved)
    # _init_state starts from the seed each time, so train() restores the same
    _, again = resumed._init_state()
    assert_restored(resumed, again, saved)
    records = resumed.train()
    assert len(records) == 1 and resumed.train_state.iteration == 3
    assert resumed.train_state.opt.count == 3 * 2
    assert all(np.isfinite(v) for v in records[0].values())
    assert any(p.endswith("model_3.pt") for p in _checkpoints(tmp_path))


def _checkpoints(root):
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".pt")]


@pytest.mark.parametrize("terrain", TERRAINS)
def test_two_resumes_repeat_bitwise(tmp_path, monkeypatch, terrain):
    """Two resumes from one checkpoint take the same iteration bitwise:
    params, Adam moments and metrics."""
    monkeypatch.chdir(tmp_path)
    Runner(tiny_cfg(tmp_path, terrain), device="cpu").train()
    (first,) = [p for p in _checkpoints(tmp_path) if p.endswith("model_1.pt")]
    outs = []
    for _ in range(2):
        runner = Runner(tiny_cfg(tmp_path, terrain, checkpoint=first), device="cpu")
        (rec,) = runner.train()
        ts = runner.train_state
        assert ts.iteration == 2
        outs.append((flat_params(runner.ppo.network), ts.opt.m, ts.opt.v, rec))
    (p0, m0, v0, r0), (p1, m1, v1, r1) = outs
    assert torch.equal(p0, p1) and torch.equal(m0, m1) and torch.equal(v0, v1)
    timing = ("rollout_ms", "update_ms", "iter_ms", "env_steps_per_sec")
    assert {k: v for k, v in r0.items() if k not in timing} == \
        {k: v for k, v in r1.items() if k not in timing}


def test_resume_profiles_iterations_ten_to_thirteen_after_the_start(tmp_path, monkeypatch):
    """--profile traces iterations start + 10 to start + 13 of a resumed
    run into a Chrome trace."""
    monkeypatch.chdir(tmp_path)
    cfg = tiny_cfg(tmp_path, "plane", max_iterations=1)
    cfg["runner"].update(horizon_length=1, mini_epochs=1)
    Runner(cfg, device="cpu").train()
    cfg = tiny_cfg(tmp_path, "plane", checkpoint=-1, max_iterations=16, save_interval=100)
    cfg["runner"].update(horizon_length=1, mini_epochs=1)
    cfg["basic"]["profile"] = str(tmp_path / "prof")
    runner = Runner(cfg, device="cpu")
    assert len(runner.train()) == 15
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("aten::" in str(n) for n in names)


def test_resolve_checkpoint_picks_the_newest_by_mtime(tmp_path):
    root = tmp_path / "logs"
    pt = root / "a" / "nn" / "model_3.pt"
    ckpt = root / "b" / "nn" / "model_1100.ckpt"
    policy = root / "a" / "nn" / "model_3_policy.pt"     # an export, not a checkpoint
    orbax = root / "c" / "nn" / "model_7"
    for p in (pt, ckpt, policy):
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"")
    os.utime(pt, (100, 100))
    os.utime(ckpt, (200, 200))
    os.utime(policy, (300, 300))
    assert resolve_checkpoint(-1, root=str(root)) == str(ckpt)
    os.utime(pt, (400, 400))
    assert resolve_checkpoint("-1", root=str(root)) == str(pt)
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    os.utime(orbax, (500, 500))
    assert resolve_checkpoint(-1, root=str(root)) == str(orbax)
    with pytest.raises(ValueError, match=r"\.pt .*\.ckpt"):
        load_checkpoint(str(orbax))
    assert resolve_checkpoint(str(pt)) == str(pt)
    with pytest.raises(FileNotFoundError):
        resolve_checkpoint(str(root / "missing.pt"))
    with pytest.raises(FileNotFoundError):
        resolve_checkpoint(-1, root=str(tmp_path / "empty"))


def test_jax_checkpoint_unpickler_refuses_other_classes(tmp_path):
    path = tmp_path / "bad.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"params": os.system}, f)
    with pytest.raises(pickle.UnpicklingError, match="may not hold"):
        load_checkpoint(str(path))


def test_jax_checkpoint_loads_without_jax(tmp_path):
    """In a fresh interpreter the port's loader reads model_1100.ckpt with
    jax, optax and flax never imported; its pieces equal params_from_flax
    and flat_from_flax of the tree that the JAX package's own loader
    unpickles, bitwise."""
    out = tmp_path / "pieces.pt"
    code = (
        "import sys, torch\n"
        "from booster_gym_torch.algo.networks import ActorCritic\n"
        "from booster_gym_torch.convert import train_state_from_jax_checkpoint\n"
        "from booster_gym_torch.utils.recorder import load_checkpoint\n"
        f"saved = load_checkpoint({JAX_CKPT!r})\n"
        "p = train_state_from_jax_checkpoint(ActorCritic(12, 47, 14), saved)\n"
        "torch.save({**p, 'opt': [p['opt'].m, p['opt'].v, p['opt'].count]}, sys.argv[1])\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'flax', 'orbax', 'booster_gym_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code, str(out)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout
    ours = torch.load(out, weights_only=True)

    ref = jax_load_checkpoint(JAX_CKPT)
    net = ActorCritic(NA, NO, NP)
    adam = ref["opt_state"][1].inner_state[0]
    want = params_from_flax(ref["params"])
    assert sorted(ours["params"]) == sorted(want)
    for k in want:
        assert torch.equal(ours["params"][k], want[k]), k
    m, v, count = ours["opt"]
    assert torch.equal(m, flat_from_flax(net, adam.mu))
    assert torch.equal(v, flat_from_flax(net, adam.nu))
    assert count == int(adam.count) == 22000
    assert ours["lr"] == float(ref["lr"]) and ours["iteration"] == int(ref["iteration"]) == 1100
    assert torch.equal(ours["curriculum"], torch.as_tensor(np.asarray(ref["curriculum"])))
    assert tuple(ours["curriculum"].shape) == (21, 21)


def test_orbax_checkpoint_is_refused_then_read_after_the_jax_side_resave(tmp_path):
    """The JAX recorder's orbax directory: resolve_checkpoint finds it,
    load_checkpoint refuses it, and the one-line JAX-side re-save that the
    error names gives a .ckpt whose pieces (orbax's dicts, not optax's
    states) convert to those of the saved tree, bitwise."""
    from booster_gym_tpu.utils.recorder import Recorder as JaxRecorder

    _, jppo = jax_ppo()
    params = jppo.network.init(jax.random.PRNGKey(3), jnp.zeros((1, NO)), jnp.zeros((1, NP)))
    rng = np.random.default_rng(9)
    opt_state = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape) ** 2, x.dtype)
        if x.dtype == jnp.float32 else x, jppo.tx.init(params))
    cfg = {"runner": {}, "basic": {"task": "T1"}}
    orbax_dir = JaxRecorder(cfg, root=str(tmp_path / "logs")).save(
        {"params": params, "opt_state": opt_state, "lr": jnp.float32(3e-4),
         "iteration": jnp.int32(7), "curriculum": jnp.ones((21, 21)),
         "key": jax.random.PRNGKey(0)}, 7)
    assert resolve_checkpoint(-1, root=str(tmp_path / "logs")) == orbax_dir
    with pytest.raises(ValueError, match="orbax"):
        load_checkpoint(orbax_dir)
    with open(orbax_dir + ".ckpt", "wb") as f:
        pickle.dump(jax_load_checkpoint(orbax_dir), f)
    net = ActorCritic(NA, NO, NP)
    pieces = train_state_from_jax_checkpoint(net, load_checkpoint(orbax_dir + ".ckpt"))
    host = lambda t: jax.tree.map(np.asarray, t)
    adam = opt_state[1].inner_state[0]
    assert torch.equal(pieces["opt"].m, flat_from_flax(net, host(adam.mu)))
    assert torch.equal(pieces["opt"].v, flat_from_flax(net, host(adam.nu)))
    assert pieces["opt"].count == 0 and pieces["iteration"] == 7
    assert pieces["lr"] == float(np.float32(3e-4))
    want = params_from_flax(host(params))
    assert all(torch.equal(pieces["params"][k], want[k]) for k in want)


def jax_ppo():
    cfg = jax_load_task_cfg("T1")
    cfg["algorithm"]["update_backend"] = "xla"
    return cfg, JaxPPO(ENV, cfg)


def test_actor_on_the_jax_checkpoint_matches_jax_act():
    """The port's actor-critic on model_1100.ckpt against the JAX PPO.act,
    both at bf16 (T1.yaml's compute type), on seeded observations."""
    _, jppo = jax_ppo()
    ref = jax_load_checkpoint(JAX_CKPT)
    params = jax.tree.map(jnp.asarray, ref["params"])
    net = ActorCritic(NA, NO, NP, compute_dtype="bf16")
    net.load_state_dict(train_state_from_jax_checkpoint(net, load_checkpoint(JAX_CKPT))["params"])
    obs = np.random.default_rng(7).normal(size=(256, NO)).astype(np.float32)
    mu_j, std_j = jppo.act(params, jnp.asarray(obs))
    with torch.no_grad():
        mu_t, std_t = net.act(torch.as_tensor(obs))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(std_t.numpy(), np.asarray(std_j), rtol=1e-6)
    assert float(np.abs(np.asarray(mu_j)).max()) > 0.1    # a trained actor, not zeros


def test_adam_step_from_the_restored_state_matches_jax():
    """One clip + Adam step from model_1100.ckpt's optimizer state (count
    22,000: the bias correction far out) on a seeded gradient, the port's
    PPO.flat_adam against the JAX _flat_optimizer_step."""
    cfg, jppo = jax_ppo()
    tppo = PPO(ENV, cfg, "cpu")
    net = tppo.network
    ref = jax_load_checkpoint(JAX_CKPT)
    pieces = train_state_from_jax_checkpoint(net, load_checkpoint(JAX_CKPT))
    net.load_state_dict(pieces["params"])
    rng = np.random.default_rng(5)
    grads = jax.tree.map(lambda p: np.asarray(rng.normal(size=p.shape) * 0.05, np.float32),
                         ref["params"])
    lr = jnp.asarray(ref["lr"])
    params = jax.tree.map(jnp.asarray, ref["params"])
    p_j, opt_j = jppo._flat_optimizer_step(
        jax.tree.map(jnp.asarray, grads), params, jax.tree.map(jnp.asarray, ref["opt_state"]), lr)
    opt = pieces["opt"]
    p_t, m_t, v_t, cnt = tppo.flat_adam(flat_from_flax(net, grads), flat_params(net), opt.m,
                                        opt.v, opt.count, torch.tensor(pieces["lr"]))
    host = lambda t: jax.tree.map(np.asarray, t)
    adam_j = opt_j[1].inner_state[0]
    tol = dict(rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(p_t.numpy(), flat_from_flax(net, host(p_j)).numpy(), **tol)
    np.testing.assert_allclose(m_t.numpy(), flat_from_flax(net, host(adam_j.mu)).numpy(), **tol)
    np.testing.assert_allclose(v_t.numpy(), flat_from_flax(net, host(adam_j.nu)).numpy(), **tol)
    assert cnt == int(adam_j.count) == 22001
    assert float((p_t - flat_params(net)).abs().max()) > 0


@pytest.mark.parametrize("terrain", TERRAINS)
def test_play_on_cpu(tmp_path, monkeypatch, terrain):
    """Runner.play from model_1100.ckpt: the JAX play's keys and shapes,
    numpy arrays, and the same trajectory twice; the noisy play differs."""
    monkeypatch.chdir(tmp_path)
    runner = Runner(tiny_cfg(tmp_path, terrain, checkpoint=JAX_CKPT), device="cpu")
    traj = runner.play(num_steps=5)
    assert len(traj) == 5
    B, nd = 8, runner.env.model.num_dofs
    shapes = {"root_pos": (B, 3), "root_quat": (B, 4), "q": (B, nd), "rew": (B,), "done": (B,)}
    for step in traj:
        assert {k: v.shape for k, v in step.items()} == shapes
        assert all(isinstance(v, np.ndarray) and np.isfinite(v).all() for v in step.values())
        assert step["done"].dtype == np.bool_
    again = runner.play(num_steps=5)
    for a, b in zip(traj, again):
        for k in shapes:
            np.testing.assert_array_equal(a[k], b[k])
    noisy = runner.play(num_steps=5, deterministic=False)
    assert not np.array_equal(noisy[-1]["q"], traj[-1]["q"])
