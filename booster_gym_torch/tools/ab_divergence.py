"""A/B the two env-semantics divergences of envs/t1.py (port of
tools/ab_divergence.py).

Trains short flat-terrain runs for each arm and records reward
trajectories:

  base              shipped semantics (Bernoulli still, consistent curriculum)
  still_exact       reference-exact still selection (commands.still_mode:
                    exact_fraction, the exact fraction of the resampled envs)
  curriculum_base   the command curriculum on
  curriculum_quirk  the curriculum with the reference's transpose quirk
                    (commands.curriculum_transpose_quirk)

    python -m booster_gym_torch.tools.ab_divergence [--iters 1000] [--num_envs 4096]
        [--seeds 0 1] [--out FILE] [--device cuda|cpu] [--asset_file URDF]

One row per arm and seed, appended to --out
(booster_gym_torch/records/ab_divergence.jsonl by default), with the JAX
tool's keys, then the robot (--asset_file, else the T1-shaped stand-in)
and the card.  Runs on cuda unless --device cpu; without a card it exits
non-zero.
"""

import argparse
import copy
import json
import os
import time

import numpy as np

from booster_gym_torch.tools import card, device_or_exit, open_out, t1_robot


def arms(base):
    """The four arms' configs from the base config."""
    still = copy.deepcopy(base)
    still["commands"]["still_mode"] = "exact_fraction"
    curr_base = copy.deepcopy(base)
    curr_base["commands"]["curriculum"] = True
    curr_quirk = copy.deepcopy(curr_base)
    curr_quirk["commands"]["curriculum_transpose_quirk"] = True
    return {"base": base, "still_exact": still, "curriculum_base": curr_base,
            "curriculum_quirk": curr_quirk}


def arm_row(name, seed, iters, rewards, wall_s):
    """The JAX tool's row from an arm's per-iteration rewards."""
    r = np.asarray(rewards, np.float64)
    return {"arm": name, "seed": seed, "iters": iters,
            "reward_mean_last10pct": float(r[-max(1, iters // 10):].mean()),
            "reward_curve_every50": [round(float(v), 4) for v in r[::50]],
            "wall_s": round(wall_s, 1)}


def run_arm(name, cfg, iters, seed, device, log=print):
    import torch

    from booster_gym_torch.algo.ppo import PPO
    from booster_gym_torch.envs import make_task

    env = make_task(cfg, device)
    ppo = PPO(env, cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    env_params, ts = ppo.init(gen)
    t0 = time.time()
    rewards = []
    for i in range(iters):
        ts, m = ppo.train_iteration(env_params, ts, gen)
        rewards.append(m["reward"])
        if (i + 1) % max(1, iters // 10) == 0:
            log(f"[{name}] it {i + 1}/{iters} reward={float(m['reward']):.3f} "
                f"({time.time() - t0:.0f}s)")
    return arm_row(name, seed, iters, torch.stack(rewards).double().cpu().numpy(),
                   time.time() - t0)


def summary(results, names):
    """{arm: (mean, std)} of the rows' reward_mean_last10pct over seeds."""
    out = {}
    for name in names:
        vals = [r["reward_mean_last10pct"] for r in results if r["arm"] == name]
        out[name] = (float(np.mean(vals)), float(np.std(vals)))
    return out


def main(argv=None):
    from booster_gym_torch.utils.config import load_task_cfg

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--num_envs", type=int, default=4096)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--out", default=os.path.join("booster_gym_torch", "records",
                                                  "ab_divergence.jsonl"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--asset_file", default=None)
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)
    urdf, robot = t1_robot(args.asset_file)
    card_name = card(device)

    base = load_task_cfg("T1")
    base["env"]["num_envs"] = args.num_envs
    base["terrain"]["type"] = "plane"
    base["asset"]["file"] = urdf
    arm_cfgs = arms(base)
    results = []
    for seed in args.seeds:
        for name, cfg in arm_cfgs.items():
            res = {**run_arm(name, cfg, args.iters, seed, device), "robot": robot,
                   "card": card_name}
            results.append(res)
            with open(open_out(args.out), "a") as f:
                f.write(json.dumps(res) + "\n")
            print(json.dumps(res), flush=True)

    print("\nsummary (reward mean over last 10% of iters):")
    for name, (mean, std) in summary(results, arm_cfgs).items():
        print(f"  {name}: {mean:.3f} +- {std:.3f}")
    return results


if __name__ == "__main__":
    main()
