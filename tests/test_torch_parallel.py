"""The port's env-batch data parallelism (booster_gym_torch/parallel) on the
CPU: 2 ranks over gloo against 1 rank, and against the JAX package under a
2-device mesh.

The ranks are processes of booster_gym_torch.parallel.launch, the launcher
that `python -m booster_gym_torch.train` uses, each with torchrun's
environment; the 1-rank runs go through the same launcher.  The JAX side
runs in a subprocess with 2 virtual host devices
(--xla_force_host_platform_device_count=2) and its Pallas kernels in
interpret mode, as tests/test_torch_update.py builds it.  Every process
runs with MKL_CBWR=AUTO,STRICT: MKL then gives a row of a product the same
bits whatever the batch's size, so that the 1-rank and 2-rank rollouts can
be held to each other closely (without it the actor's 256 -> 128 product
differs by an ulp between 8 and 16 rows, which the contact dynamics grow
to ~2e-5 in four steps).

Tolerances:
  * rollout buffers, per row: 1e-5 absolute (with MKL's strict mode they
    come out bitwise, which the plane test also checks);
  * the curriculum grid: 1e-6 (its scatter-adds are summed in another
    order);
  * parameters rtol 1e-4 / atol 1e-6, Adam m rtol 1e-4 / atol 1e-7 and v
    rtol 1e-4 / atol 1e-9, the loss statistics rtol 1e-4 / atol 1e-7, lr
    rtol 1e-6: tests/test_torch_update.py's (the gradient's sums are taken
    in another order); the xla update's statistics atol 1e-6, that file's
    tolerance for the xla path's rounding noise (epoch 0's actor loss is a
    mean of normalized advantages, 0 up to rounding on either side);
  * the metrics reward rtol 1e-3 / atol 1e-5 and value_loss rtol 5e-2, the
    JAX package's sharded-against-single-device tolerances
    (tests/test_sharding.py:58);
  * across ranks: parameters, Adam state and lr bitwise;
  * checkpoints, and the standup bank: bitwise.
"""

import copy
import dataclasses
import glob
import os
import pickle
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from booster_gym_tpu.parallel.mesh import _DIST_ENV_SIGNALS as JAX_DIST_ENV_SIGNALS
from booster_gym_tpu.runner import Runner as JaxRunner

from booster_gym_torch import train as port_train
from booster_gym_torch.algo.networks import ActorCritic
from booster_gym_torch.convert import flat_from_flax
from booster_gym_torch.parallel import Group, initialize_distributed, largest_world, launch
from booster_gym_torch.parallel.mesh import _DIST_ENV_SIGNALS
from booster_gym_torch.testing import (
    dp_bank,
    dp_cfg,
    dp_train,
    dp_update,
    standup_path_cfg,
    update_case,
    write_t1_serial_mjcf,
    write_t1_serial_urdf,
    write_t1_shaped_urdf,
)
from booster_gym_torch.utils.config import load_task_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 300
BUFFERS = ("obs", "priv", "act", "mu", "std", "rew", "done", "time_outs")
STAT_NAMES = ("value_loss", "actor_loss", "bound_loss", "entropy", "kl_mean")


@pytest.fixture(autouse=True)
def _strict_mkl(monkeypatch):
    monkeypatch.setenv("MKL_CBWR", "AUTO,STRICT")


def run_ranks(fn, world, spec, out_dir):
    """fn's rank results, launched as `world` ranks in out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    launch(fn, world, (spec, str(out_dir)), timeout_s=RANK_TIMEOUT_S)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def checkpoint_of(out_dir, it):
    (path,) = glob.glob(os.path.join(out_dir, "logs", "*", "nn", f"model_{it}.pt"))
    return path


# ---------------------------------------------------------------------------
# (a) the group's initialization: quiet with nothing configured, loud when
# configured but broken (tests/test_multihost.py:119, 130)
def test_initialize_distributed_quiet_when_unconfigured(monkeypatch):
    for k in _DIST_ENV_SIGNALS:
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed("gloo") is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("case", ["rank_outside_the_world", "missing_variable",
                                  "unreachable_store", "no_backend"])
def test_initialize_distributed_loud_on_bad_config(monkeypatch, case):
    for k in _DIST_ENV_SIGNALS:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(Exception):
        if case == "rank_outside_the_world":
            initialize_distributed("gloo", init_method="tcp://127.0.0.1:1", world_size=2,
                                   rank=5)
        elif case == "missing_variable":
            monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")   # and no WORLD_SIZE, RANK
            initialize_distributed("gloo")
        elif case == "unreachable_store":
            # rank 1 waits for rank 0's store, which nobody serves
            initialize_distributed("gloo", init_method="tcp://127.0.0.1:1", world_size=2,
                                   rank=1, timeout_s=2)
        else:
            initialize_distributed(None, world_size=2, rank=0)
    assert not dist.is_initialized()


def test_group_rows_and_draws():
    """Rows [lo, hi) per rank; a draw is the global batch's, sliced; every
    collective is the identity at world size 1."""
    gen = lambda: torch.Generator().manual_seed(3)
    whole = torch.rand((12, 3), generator=gen())
    for rank in range(3):
        g = Group(12, torch.device("cpu"), world=3, rank=rank, backend="gloo")
        assert (g.lo, g.hi, g.local_envs) == (4 * rank, 4 * rank + 4, 4)
        assert torch.equal(g.draw(torch.rand, gen(), (4, 3)), whole[g.lo:g.hi])
        assert torch.equal(g.draw(torch.randint, gen(), (4,), 0, 9),
                           torch.randint(0, 9, (12,), generator=gen())[g.lo:g.hi])
        with pytest.raises(ValueError):
            g.draw(torch.rand, gen(), (12, 3))
    one = Group(12, torch.device("cpu"))
    assert torch.equal(one.draw(torch.rand, gen(), (12, 3)), whole)
    x = torch.ones(3)
    assert one.all_reduce(x) is x and one.all_gather(x) is x and one.broadcast(x) is x
    with pytest.raises(ValueError):
        Group(10, torch.device("cpu"), world=3, rank=0, backend="gloo")
    with pytest.raises(ValueError):
        Group(12, torch.device("cpu"), world=2, rank=0)     # no backend


# ---------------------------------------------------------------------------
# (b) the world's size: the JAX runner's mesh rule
MESH_CASES = [(1, 16, True), (8, 16, True), (8, 12, True), (8, 4096, True), (3, 4096, True),
              (4, 13, True), (6, 7, True), (8, 16, False), (2, 1, True)]


@pytest.mark.parametrize("n_devices,num_envs,data_parallel", MESH_CASES)
def test_world_size_matches_the_jax_runners_mesh(monkeypatch, capsys, n_devices, num_envs,
                                                 data_parallel):
    cfg = {"basic": {"data_parallel": data_parallel}, "env": {"num_envs": num_envs}}
    monkeypatch.setattr(jax, "devices", lambda *a: [object()] * n_devices)
    monkeypatch.setattr("booster_gym_tpu.runner.make_mesh", lambda n: n)
    stub = types.SimpleNamespace(cfg=cfg, env=types.SimpleNamespace(num_envs=num_envs))
    mesh = JaxRunner._build_mesh(stub)
    jax_out = capsys.readouterr().out
    n = port_train.world_size(cfg, n_devices)
    assert n == (1 if mesh is None else mesh)
    assert capsys.readouterr().out == jax_out
    if data_parallel:
        assert largest_world(n_devices, num_envs) == n
    assert set(_DIST_ENV_SIGNALS) != set(JAX_DIST_ENV_SIGNALS)   # torchrun's, not JAX's


# ---------------------------------------------------------------------------
# the JAX reference: one subprocess with 2 virtual devices
_JAX_REFERENCE = r"""
import os, pickle, sys, types
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from booster_gym_tpu.algo.networks import ActorCritic
from booster_gym_tpu.algo.ppo import PPO
from booster_gym_tpu.parallel import make_mesh, shard_batch_pytree
from booster_gym_tpu.utils.config import load_task_cfg

assert len(jax.devices()) == 2, jax.devices()
out_dir = sys.argv[1]
mesh = make_mesh(2)
host = lambda t: jax.tree.map(np.asarray, t)

# (c) shard_batch_pytree's rows per device
B = 6
tree = {"env": np.arange(B * 3, dtype=np.float32).reshape(B, 3),
        "grid": np.arange(4, dtype=np.float32),
        "pair": (np.arange(B, dtype=np.int32), np.float32(2.0)),
        "time_major": np.arange(2 * B, dtype=np.float32).reshape(2, B)}
placed = shard_batch_pytree(mesh, tree, B)
shards = {}
for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
    shards[jax.tree_util.keystr(path)] = {s.device.id: np.asarray(s.data)
                                           for s in leaf.addressable_shards}
with open(os.path.join(out_dir, "shards.pkl"), "wb") as f:
    pickle.dump({"tree": tree, "shards": shards}, f)

# (d) PPO.update under the mesh, both backends, from one state
NA, NO, NP, T, B = 12, 47, 14, 4, 16
ENV = types.SimpleNamespace(num_actions=NA, num_obs=NO, num_privileged_obs=NP)
cfg = load_task_cfg("T1")
cfg["algorithm"]["compute_dtype"] = "f32"
cfg["runner"]["mini_epochs"] = 3
jnet = ActorCritic(NA, NO, NP, compute_dtype="f32")
params = jnet.init(jax.random.PRNGKey(2), jnp.zeros((1, NO)), jnp.zeros((1, NP)))
rng = np.random.default_rng(4)
f32 = lambda *s: rng.normal(size=s).astype(np.float32)
obs, priv = f32(T, B, NO), f32(T, B, NP)
mu, std = (np.asarray(x) for x in jnet.apply(params, jnp.asarray(obs), method=ActorCritic.act))
act = (mu + std * f32(T, B, NA)).astype(np.float32)
buf = (obs, priv, act, mu, std, f32(T, B), rng.random((T, B)) < 0.1, rng.random((T, B)) < 0.1)
obs_last, priv_last = f32(B, NO), f32(B, NP)
rand_tree = lambda scale: jax.tree.map(
    lambda q: jnp.asarray(np.abs(rng.normal(size=q.shape)) * scale, jnp.float32), params)
m0, v0 = rand_tree(1e-3), rand_tree(1e-5)
inputs = {"params": host(params), "m0": host(m0), "v0": host(v0), "lr0": 1e-3, "count0": 7,
          "buf": buf, "obs_last": obs_last, "priv_last": priv_last}
with open(os.path.join(out_dir, "inputs.pkl"), "wb") as f:
    pickle.dump(inputs, f)
tb = NamedSharding(mesh, P(None, "dp"))
b = NamedSharding(mesh, P("dp"))
sbuf = tuple(jax.device_put(jnp.asarray(x), tb) for x in buf)
carry = (None, jax.device_put(jnp.asarray(obs_last), b),
         jax.device_put(jnp.asarray(priv_last), b)) + (None,) * 6
results = {}
for backend in ("fused", "xla"):
    ppo = PPO(ENV, {**cfg, "algorithm": {**cfg["algorithm"], "update_backend": backend}})
    ppo.set_mesh(mesh)
    clip_state, inj = ppo.tx.init(params)
    adam, rest = inj.inner_state
    opt_state = (clip_state, inj._replace(count=jnp.int32(7), inner_state=(
        adam._replace(count=jnp.int32(7), mu=m0, nu=v0), rest)))
    jts = types.SimpleNamespace(params=params, opt_state=opt_state, lr=jnp.float32(1e-3))
    (p, opt, lr), stats = ppo.update(jts, carry, sbuf)
    adam_j = opt[1].inner_state[0]
    results[backend] = {"p": host(p), "m": host(adam_j.mu), "v": host(adam_j.nu),
                        "count": int(adam_j.count), "lr": float(lr),
                        "stats": [np.asarray(s) for s in stats]}
with open(os.path.join(out_dir, "updates.pkl"), "wb") as f:
    pickle.dump(results, f)
print("jax reference done")
"""


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _JAX_REFERENCE, str(out)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    load = lambda name: pickle.load(open(out / name, "rb"))
    return out, load("shards.pkl"), load("updates.pkl")


# (c) shard_rows keeps what shard_batch_pytree puts on each device
def test_shard_rows_keeps_the_rows_of_shard_batch_pytree(jax_reference):
    _, ref, _ = jax_reference
    tree, B = ref["tree"], 6
    port_tree = {"env": torch.as_tensor(tree["env"]), "grid": torch.as_tensor(tree["grid"]),
                 "pair": (torch.as_tensor(tree["pair"][0]), torch.tensor(2.0)),
                 "time_major": torch.as_tensor(tree["time_major"])}
    paths = {"['env']": lambda t: t["env"], "['grid']": lambda t: t["grid"],
             "['pair'][0]": lambda t: t["pair"][0], "['pair'][1]": lambda t: t["pair"][1],
             "['time_major']": lambda t: t["time_major"]}
    assert sorted(paths) == sorted(ref["shards"])
    for rank in range(2):
        g = Group(B, torch.device("cpu"), world=2, rank=rank, backend="gloo")
        mine = g.shard_rows(port_tree, B)
        for path, get in paths.items():
            np.testing.assert_array_equal(get(mine).numpy(), ref["shards"][path][rank],
                                          err_msg=f"{path} on rank {rank}")
    # a dataclass of leaves, as the env's state is
    Pair = dataclasses.make_dataclass("Pair", ["a", "b"])
    half = Group(B, torch.device("cpu"), world=2, rank=1, backend="gloo").shard_rows(
        Pair(torch.arange(B), torch.arange(3)), B)
    assert half.a.tolist() == [3, 4, 5] and half.b.tolist() == [0, 1, 2]


# (d) the update in 2 ranks against the JAX update under a 2-device mesh
@pytest.mark.parametrize("backend", ["fused", "xla"])
def test_update_over_two_ranks_matches_jax_under_a_two_device_mesh(jax_reference, tmp_path,
                                                                   backend):
    ref_dir, _, updates = jax_reference
    cfg = load_task_cfg("T1")
    cfg["algorithm"].update(compute_dtype="f32", update_backend=backend)
    cfg["runner"]["mini_epochs"] = 3
    spec = {"cfg": cfg, "device": "cpu", "inputs": str(ref_dir / "inputs.pkl")}
    ranks = run_ranks(dp_update, 2, spec, tmp_path)
    ref = updates[backend]
    net = ActorCritic(12, 47, 14, compute_dtype="f32")
    flat = lambda tree: flat_from_flax(net, tree).numpy()
    r0 = ranks[0]
    for k in ("p", "m", "v", "lr", "stats"):
        assert torch.equal(r0[k], ranks[1][k]), f"{k} differs between the ranks"
    np.testing.assert_allclose(r0["p"].numpy(), flat(ref["p"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(r0["m"].numpy(), flat(ref["m"]), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(r0["v"].numpy(), flat(ref["v"]), rtol=1e-4, atol=1e-9)
    stat_atol = {"fused": 1e-7, "xla": 1e-6}[backend]
    for i, name in enumerate(STAT_NAMES):
        np.testing.assert_allclose(r0["stats"][:, i].numpy(), ref["stats"][i], rtol=1e-4,
                                   atol=stat_atol, err_msg=name)
    np.testing.assert_allclose(float(r0["lr"]), ref["lr"], rtol=1e-6)
    assert float(r0["lr"]) != 1e-3 and r0["count"] == ref["count"] == 7 + 3


# ---------------------------------------------------------------------------
# (e), (i): a whole iteration in 2 ranks against 1 rank, and resume across
# world sizes
@pytest.fixture(scope="module")
def plane_runs(tmp_path_factory):
    urdf = write_t1_shaped_urdf(tmp_path_factory.mktemp("urdf"))
    cfg = dp_cfg(urdf)      # 16 envs, horizon 4, 2 mini-epochs, f32, 1 iteration
    d1, d2 = tmp_path_factory.mktemp("world1"), tmp_path_factory.mktemp("world2")
    mp = pytest.MonkeyPatch()
    mp.setenv("MKL_CBWR", "AUTO,STRICT")
    try:
        one = run_ranks(dp_train, 1, {"cfg": cfg, "device": "cpu"}, d1)[0]
        two = run_ranks(dp_train, 2, {"cfg": cfg, "device": "cpu",
                                      "resume": checkpoint_of(d1, 1)}, d2)
        # no iteration of its own: the 2-rank checkpoint resumed on 1 rank
        idle = copy.deepcopy(cfg)
        idle["basic"]["max_iterations"] = 0
        back = run_ranks(dp_train, 1, {"cfg": idle, "device": "cpu",
                                       "resume": checkpoint_of(d2, 1)},
                         tmp_path_factory.mktemp("world1_resumed"))[0]
    finally:
        mp.undo()
    return one, two, back


def hold_to_one_rank(one, two, compare_curriculum=True):
    """The checks of (e) and (f): the 2-rank iteration against the 1-rank."""
    for i, name in enumerate(BUFFERS):
        whole = one["buffers"][i]
        for r in two:
            part = r["buffers"][i]
            assert part.shape[1] * 2 == whole.shape[1], name
            lo = r["rank"] * part.shape[1]
            np.testing.assert_allclose(part.double().numpy(),
                                       whole[:, lo:lo + part.shape[1]].double().numpy(),
                                       rtol=0, atol=1e-5, err_msg=f"{name} of rank {r['rank']}")
    if compare_curriculum:
        for r in two:
            np.testing.assert_allclose(r["curriculum"].numpy(), one["curriculum"].numpy(),
                                       rtol=0, atol=1e-6)
    a, b = one["snaps"][-1], two[0]["snaps"][-1]
    np.testing.assert_allclose(b["p"].numpy(), a["p"].numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(b["m"].numpy(), a["m"].numpy(), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(b["v"].numpy(), a["v"].numpy(), rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(float(b["lr"]), float(a["lr"]), rtol=1e-6)
    ra, rb = one["records"][0], two[0]["records"][0]
    np.testing.assert_allclose(rb["reward"], ra["reward"], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(rb["value_loss"], ra["value_loss"], rtol=5e-2)
    for r in two[1:]:
        for k in ("p", "m", "v", "lr"):
            assert all(torch.equal(s[k], s0[k]) for s, s0 in zip(r["snaps"], two[0]["snaps"])), k
        timing = ("rollout_ms", "update_ms", "iter_ms", "env_steps_per_sec")
        assert {k: v for k, v in r["records"][0].items() if k not in timing} == {
            k: v for k, v in two[0]["records"][0].items() if k not in timing}


def test_two_ranks_iterate_as_one_rank(plane_runs):
    one, two, _ = plane_runs
    assert one["world"] == 1 and [r["world"] for r in two] == [2, 2]
    hold_to_one_rank(one, two)
    # with MKL's strict mode nothing but the update's sums differs
    assert all(torch.equal(torch.cat([r["buffers"][i] for r in two], 1), one["buffers"][i])
               for i in range(len(BUFFERS)))
    # the collectives per iteration: the curriculum's grid per control step,
    # per mini-epoch K2's two sums and K3's gradient with its sums, then the
    # metrics' sums and maxima; none at world size 1
    assert one["reduce"] == [[]]
    rec = two[0]["records"][0]
    n_terms = sum(k.startswith("episode/") for k in rec)
    calls = [(numel, op) for numel, op, _ in two[0]["reduce"][0]]
    assert calls == ([(one["curriculum"].numel(), "sum")] * 4
                     + [(2, "sum"), (two[0]["n_params"] + 4 + 12, "sum")] * 2
                     + [(2 + 1 + n_terms + 2, "sum"), (2, "max")])


def test_checkpoints_resume_across_world_sizes(plane_runs):
    """A 1-rank checkpoint resumed on 2 ranks and a 2-rank rank-0
    checkpoint on 1 rank: every piece restored bitwise."""
    _, two, back = plane_runs
    for r in two:
        assert r["restored"] and all(r["restored"].values()), r["restored"]
    assert back["restored"] and all(back["restored"].values()), back["restored"]


# (f) the same on a small trimesh field (K5's plain path), 1 iteration
def test_two_ranks_iterate_as_one_rank_on_trimesh(tmp_path):
    cfg = dp_cfg(write_t1_shaped_urdf(tmp_path), terrain="trimesh", curriculum=False)
    one = run_ranks(dp_train, 1, {"cfg": cfg, "device": "cpu"}, tmp_path / "one")[0]
    two = run_ranks(dp_train, 2, {"cfg": cfg, "device": "cpu"}, tmp_path / "two")
    hold_to_one_rank(one, two, compare_curriculum=False)


# (g) the standup bank: each rank settles its slice, the ranks gather it
def test_standup_bank_over_two_ranks_is_the_one_rank_bank(tmp_path):
    cfg = standup_path_cfg(write_t1_serial_urdf(tmp_path), write_t1_serial_mjcf(tmp_path))
    cfg["env"]["num_envs"] = 8
    cfg["standup"]["settle_rounds"] = 1
    one = run_ranks(dp_bank, 1, {"cfg": cfg, "device": "cpu"}, tmp_path / "one")[0]
    two = run_ranks(dp_bank, 2, {"cfg": cfg, "device": "cpu"}, tmp_path / "two")
    assert sorted(one) == sorted(two[0]) and one["q"].shape[0] == 8
    for r in two:
        for k, v in one.items():
            assert torch.equal(r[k], v), k


# (h) K3 on half the rows with the global count, summed, is the whole batch
def test_k3_plain_over_two_halves_with_the_global_count_is_the_whole_batch():
    """The gradient's rows add up: K3's plain version on each half of the
    envs with n_total = 2n, the halves' g and sums added, against the call
    on all rows.  f32; the tolerance of the update's gradient (1e-4 of its
    norm, tests/test_torch_update.py), since the halves' weight gradients
    are summed in another order; the sums rtol 1e-5 / atol 1e-6."""
    T, B = 4, 16
    fused, p, staged, prep, d = update_case("f32", T, B, "cpu", seed=3)
    adv, ret = d["adv"], d["ret"]
    mean, rstd = adv.mean(), 1.0 / (adv.std() + 1e-8)
    g, st, mu, logp = fused.grads_stats(staged, p, prep, adv, ret, mean, rstd, False)
    halves = []
    for cols in (slice(0, B // 2), slice(B // 2, B)):
        sub = {k: v[:, cols].contiguous() for k, v in prep.items()}
        halves.append((sub, adv[:, cols].contiguous(), ret[:, cols].contiguous()))
    parts = [fused.grads_stats(staged, p, sub, a, r, mean, rstd, False, n_total=T * B)
             for sub, a, r in halves]
    g2 = parts[0][0] + parts[1][0]
    assert float((g2 - g).norm() / g.norm()) <= 1e-4
    for k in ("vl", "al", "bhi", "blo", "klsq"):
        np.testing.assert_allclose((parts[0][1][k] + parts[1][1][k]).numpy(), st[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    whole_mu = torch.cat([q[2].view(T, B // 2, -1) for q in parts], 1)
    assert torch.equal(whole_mu, mu.view(T, B, -1))
    # at n_total = n the call is the one without it, bitwise; at 2n the
    # loss means halve, and the bound term's scale with them
    sub, a, r = halves[1]
    g_half = fused.grads_stats(staged, p, sub, a, r, mean, rstd, False)[0]
    assert torch.equal(g_half, fused.grads_stats(staged, p, sub, a, r, mean, rstd, False,
                                                 n_total=T * B // 2)[0])
    assert float((parts[1][0] - 0.5 * g_half).norm() / g_half.norm()) <= 1e-6
    assert fused.grads_stats_launches == 0
    with pytest.raises(ValueError):
        fused.grads_stats_timed(staged, p, prep, adv, ret, mean, rstd, False, None,
                                n_total=T * B - 1)
