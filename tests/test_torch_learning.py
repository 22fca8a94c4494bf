"""The port learns: tests/test_learning.py's run and rule, the reward-curve
tool, and pins on the recorded curves.

- train_curve on the CPU at 16 envs, 3 iterations: rows in the JAX tool's
  format (tools/train_curve.py), plus the robot and the card.
- testing.learning_cfg equals the JAX test's config dict on the same
  stand-in robot.
- The curves that `python -m booster_gym_torch.tools.train_curve` recorded
  on the card (booster_gym_torch/records/reward_curve_*.jsonl, the
  T1-shaped stand-in, 4096 envs, seed 42) meet the learning criteria fixed
  before they were run: reward at iteration 1000 at least 10 x the mean of
  the rows at iterations <= 100; steps at iteration 1000 at least 5 x
  steps at iteration 1; the first reward below 10; every lr in
  [1e-5, 1e-2]; flat bf16 and flat f32 within 10 reward of each other at
  iteration 1000 (tests/test_reward_curve.py's bound).
- The learning check at 4096 envs on the card (`cuda`, skips here).
- `slow`: the JAX test's own run (64 envs, 300 iterations, seeds 3, 4, 5)
  on the stand-in through the JAX package and through the port, both on
  the CPU, each seed held to the rule, and the port's late-window mean
  reward within the JAX seeds' range widened by half its width on each
  side.  Its numbers are recorded in
  booster_gym_torch/records/learning_cpu_standin.json (written where
  LEARNING_RECORD_OUT names a path), which a tier-1 test pins.
"""

import concurrent.futures
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from booster_gym_torch.testing import (
    LEARNING_EARLY,
    LEARNING_LATE,
    learning_cfg,
    learning_check,
    learning_rule,
    write_t1_shaped_urdf,
)
from booster_gym_torch.tools import STANDIN, train_curve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = os.path.join(REPO, "booster_gym_torch", "records")
CPU_RECORD = os.path.join(RECORDS, "learning_cpu_standin.json")
CPU_SEEDS = (3, 4, 5)
CPU_ENVS, CPU_ITERS = 64, 300


def _env():
    """The repository importable, and one OpenMP thread (tests/test_torch_train.py's
    _env)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def jax_test_cfg(urdf):
    """tests/test_learning.py's mutations of the JAX package's T1.yaml,
    line for line, on the robot at `urdf`."""
    from booster_gym_tpu.utils.config import load_task_cfg

    cfg = load_task_cfg("T1")
    cfg["env"]["num_envs"] = 64
    cfg["terrain"]["type"] = "plane"
    cfg["runner"]["horizon_length"] = 24
    cfg["runner"]["mini_epochs"] = 5
    cfg["rewards"]["episode_length_s"] = 8.0
    cfg["algorithm"]["learning_rate"] = 3.e-4
    cfg["noise"] = {}
    r = cfg["randomization"]
    r["kick_interval_s"] = 1000.0
    r["push_interval_s"] = 1000.0
    r.pop("init_dof_pos", None)
    r.pop("init_base_lin_vel_xy", None)
    cfg["commands"]["lin_vel_x"] = [-0.3, 0.5]
    cfg["commands"]["lin_vel_y"] = [-0.2, 0.2]
    cfg["commands"]["ang_vel_yaw"] = [-0.3, 0.3]
    cfg["commands"]["still_proportion"] = 0.2
    cfg["asset"]["file"] = urdf
    return cfg


def test_learning_cfg_is_the_jax_tests_config(tmp_path):
    urdf = write_t1_shaped_urdf(tmp_path)
    assert learning_cfg(urdf, 64) == jax_test_cfg(urdf)
    big = learning_cfg(urdf, 4096)
    assert big["env"]["num_envs"] == 4096 and big["noise"] == {}


def test_learning_rule_is_the_jax_tests_rule():
    """The windows and the two inequalities of tests/test_learning.py, on
    made-up curves at and past each threshold."""
    assert (LEARNING_EARLY, LEARNING_LATE) == (slice(20, 60), slice(-40, None))
    steps = np.full(300, 50.0)
    flat = np.full(300, 0.2)
    assert not learning_rule(flat, steps)[0]
    up = flat.copy()
    up[-40:] = 0.31                       # above max(1.5 x 0.2, 0.2 + 0.1) = 0.3
    assert learning_rule(up, steps)[0]
    up[-40:] = 0.30                       # not above max(0.3, 0.3)
    assert not learning_rule(up, steps)[0]
    up[-40:] = 0.5
    fewer = steps.copy()
    fewer[-40:] = 0.85 * 50.0             # survival must stay above 0.85 x early
    assert not learning_rule(up, fewer)[0]
    ok, early_r, late_r, early_s, late_s = learning_rule(up, steps)
    assert ok and (early_r, late_r, early_s, late_s) == (0.2, 0.5, 50.0, 50.0)
    small = np.full(300, 0.01)
    small[-40:] = 0.1                     # 10 x early but not early + 0.1
    assert not learning_rule(small, steps)[0]
    up[5] = np.nan                        # outside both windows, still refused
    assert not learning_rule(up, steps)[0]


def test_train_curve_rows_on_cpu(tmp_path):
    """The tool's CLI at 16 envs for 3 iterations on the CPU: one row, at
    iteration 1, with the JAX tool's keys and types, the robot and the
    card; the print lines of the JAX tool."""
    urdf = write_t1_shaped_urdf(tmp_path)
    out_path = tmp_path / "curve.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "booster_gym_torch.tools.train_curve", "3", "bf16",
         str(out_path), "plane", "--device", "cpu", "--num_envs", "16", "--asset_file", urdf],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    rows = [json.loads(line) for line in open(out_path)]
    assert len(rows) == 1
    row = rows[0]
    assert list(row)[:5] == ["iter", "reward", "lr", "kl", "steps"]
    assert row["iter"] == 1 and row["robot"] == urdf and row["card"] == "cpu"
    assert all(isinstance(row[k], float) and np.isfinite(row[k])
               for k in ("reward", "lr", "kl", "steps"))
    assert row["reward"] == round(row["reward"], 3) and 1e-5 - 1e-9 <= row["lr"] <= 1e-2 + 1e-9
    assert "[bf16] iter 1: reward" in out.stdout and "[bf16] final reward" in out.stdout
    assert str(out_path) in out.stdout


def test_train_curve_refuses_without_a_card(tmp_path):
    """No card and no --device cpu: a non-zero exit and no file, not a
    run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out_path = tmp_path / "curve.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "booster_gym_torch.tools.train_curve", "3", "bf16",
         str(out_path)], cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
    assert not out_path.exists()


def test_train_curve_default_output_names():
    assert train_curve.default_output("bf16", "plane") == os.path.join(
        "booster_gym_torch", "records", "reward_curve_flat_bf16.jsonl")
    assert train_curve.default_output("f32", "trimesh") == os.path.join(
        "booster_gym_torch", "records", "reward_curve_rough_f32.jsonl")


# -- the card curves ---------------------------------------------------------

def _curve(name):
    path = os.path.join(RECORDS, f"reward_curve_{name}.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


CARD_CURVES = {"flat_bf16": 2000, "flat_f32": 1000, "rough_bf16": 1000}


@pytest.mark.parametrize("name", sorted(CARD_CURVES))
def test_card_curve_recorded(name):
    """Each curve was run on the card on the stand-in to its length, rows at
    iteration 1 and every 50, every row finite, the lr inside its clamp."""
    rows = _curve(name)
    assert [r["iter"] for r in rows] == [1] + list(range(50, CARD_CURVES[name] + 1, 50))
    assert all("H100" in r["card"] for r in rows), rows[0]["card"]
    assert all(r["robot"] == STANDIN for r in rows)
    assert all(np.isfinite([r["reward"], r["lr"], r["kl"], r["steps"]]).all() for r in rows)
    assert all(1e-5 - 1e-9 <= r["lr"] <= 1e-2 + 1e-9 for r in rows)


@pytest.mark.parametrize("name", ["flat_bf16", "rough_bf16"])
def test_card_curve_learns(name):
    ok, why = train_curve.learning_criteria(_curve(name))
    assert ok, why


def test_card_bf16_curve_matches_f32():
    bf16 = {r["iter"]: r["reward"] for r in _curve("flat_bf16")}
    f32 = {r["iter"]: r["reward"] for r in _curve("flat_f32")}
    assert abs(bf16[1000] - f32[1000]) < 10.0


def test_learning_criteria_refuse_a_flat_curve():
    rows = [{"iter": i, "reward": 1.0, "lr": 1e-3, "kl": 0.01, "steps": 50.0}
            for i in [1] + list(range(50, 1001, 50))]
    ok, why = train_curve.learning_criteria(rows)
    assert not ok and "10 x" in why
    rows[-1] = dict(rows[-1], reward=11.0)
    ok, why = train_curve.learning_criteria(rows)
    assert not ok and "5 x" in why
    rows[-1]["steps"] = 250.0
    assert train_curve.learning_criteria(rows) == (True, "")
    rows[3]["lr"] = 2e-2
    assert not train_curve.learning_criteria(rows)[0]


# -- the learning check on the card ----------------------------------------------

@pytest.mark.cuda
def test_learning_check_on_card(tmp_path):
    """chip_smoke.py's phase 12: learning_cfg at 4096 envs, bf16, the fused
    update, seed 3, 300 iterations on the card meets the JAX test's rule,
    through K1 (24 launches an iteration) and K2-K4 (5 each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    urdf = write_t1_shaped_urdf(tmp_path)
    rewards, steps, counts = learning_check(learning_cfg(urdf, 4096), 300, 3, "cuda")
    ok, early_r, late_r, early_s, late_s = learning_rule(rewards, steps)
    assert ok, (early_r, late_r, early_s, late_s, np.round(rewards[::15], 3))
    assert counts == {"substep": 300 * 24, "gae": 300 * 5, "grads_stats": 300 * 5,
                      "opt_stage": 300 * 5}


# -- the CPU comparison with the JAX package ---------------------------------------

def _jax_run(urdf, seed, iterations):
    """tests/test_learning.py's run on `urdf` with PRNGKey(seed), in a
    process of its own."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from booster_gym_tpu.algo import PPO
    from booster_gym_tpu.envs import make_task

    t0 = time.time()
    cfg = jax_test_cfg(urdf)
    env = make_task(cfg)
    ppo = PPO(env, cfg)
    env_params, ts = ppo.init(jax.random.PRNGKey(seed))
    step = jax.jit(ppo.train_iteration, donate_argnums=(1,))
    rewards, steps = [], []
    for _ in range(iterations):
        ts, metrics = step(env_params, ts)
        rewards.append(metrics["reward"])
        steps.append(metrics["steps"])
    rewards = np.asarray(jax.device_get(rewards), np.float64)
    steps = np.asarray(jax.device_get(steps), np.float64)
    return rewards, steps, time.time() - t0


def _port_run(urdf, seed, iterations):
    torch.set_num_threads(1)
    t0 = time.time()
    rewards, steps, _ = learning_check(learning_cfg(urdf, CPU_ENVS), iterations, seed, "cpu")
    return rewards, steps, time.time() - t0


def _summary(rewards, steps, seconds):
    ok, early_r, late_r, early_s, late_s = learning_rule(rewards, steps)
    return {"ok": ok, "early_reward": early_r, "late_reward": late_r, "early_steps": early_s,
            "late_steps": late_s, "seconds": round(seconds, 1),
            "reward_every15": [round(float(v), 4) for v in rewards[::15]],
            "steps_every15": [round(float(v), 2) for v in steps[::15]]}


def widened_range(values):
    lo, hi = min(values), max(values)
    return lo - (hi - lo) / 2, hi + (hi - lo) / 2


def check_cpu_record(rec):
    """The comparison's verdicts: every seed of both packages meets the rule,
    and each port seed's late mean lies in the JAX seeds' widened range."""
    lo, hi = widened_range([r["late_reward"] for r in rec["jax"].values()])
    bad = [f"{pkg} seed {s}: rule" for pkg in ("jax", "port") for s, r in rec[pkg].items()
           if not r["ok"]]
    bad += [f"port seed {s}: late {r['late_reward']:.4f} outside [{lo:.4f}, {hi:.4f}]"
            for s, r in rec["port"].items() if not lo <= r["late_reward"] <= hi]
    return bad


@pytest.mark.slow
def test_port_learns_as_the_jax_package_on_the_cpu(tmp_path):
    """Both packages, three seeds each, six processes at once (about 55
    minutes on 8 cores)."""
    urdf = write_t1_shaped_urdf(tmp_path)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(6, mp_context=ctx) as pool:
        futures = {(pkg, seed): pool.submit(fn, urdf, seed, CPU_ITERS)
                   for pkg, fn in (("jax", _jax_run), ("port", _port_run))
                   for seed in CPU_SEEDS}
        rec = {"robot": "T1-shaped stand-in (booster_gym_torch/testing.py "
                        "write_t1_shaped_urdf)",
               "config": "tests/test_learning.py (testing.learning_cfg)",
               "num_envs": CPU_ENVS, "iterations": CPU_ITERS, "seeds": list(CPU_SEEDS),
               "device": "cpu", "torch": torch.__version__,
               "jax": {}, "port": {}}
        for (pkg, seed), fut in futures.items():
            rec[pkg][str(seed)] = _summary(*fut.result())
    out = os.environ.get("LEARNING_RECORD_OUT")
    if out:
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
    assert not check_cpu_record(rec), (check_cpu_record(rec), json.dumps(rec))


def test_cpu_comparison_record():
    """The slow test's numbers as committed: its settings, every seed of both
    packages meeting the rule, the port inside the JAX seeds' widened
    range."""
    with open(CPU_RECORD) as f:
        rec = json.load(f)
    assert (rec["num_envs"], rec["iterations"], rec["seeds"]) == (CPU_ENVS, CPU_ITERS,
                                                                   list(CPU_SEEDS))
    assert sorted(rec["jax"]) == sorted(rec["port"]) == [str(s) for s in CPU_SEEDS]
    for runs in (rec["jax"], rec["port"]):
        for r in runs.values():
            assert len(r["reward_every15"]) == len(r["steps_every15"]) == CPU_ITERS // 15
    assert not check_cpu_record(rec), check_cpu_record(rec)
