"""Train T1 for N iterations and log the reward curve to a jsonl (port of
tools/train_curve.py):

    python -m booster_gym_torch.tools.train_curve [ITERS [DTYPE [OUT [TERRAIN]]]] \
        [--device cuda|cpu] [--num_envs N] [--asset_file URDF]

ITERS 5000, DTYPE bf16 (the update's compute dtype; f32), OUT "-" or
absent for booster_gym_torch/records/reward_curve_{flat,rough}_{DTYPE}.jsonl,
TERRAIN plane (flat) or trimesh (rough, T1.yaml's own terrain block).  T1.yaml
at 4096 envs and seed 42, PPO.train_iteration called in a loop as the JAX
tool calls its jitted one.  A row at iteration 1 and every 50: iter,
reward (rounded to 3 places), lr, kl, steps as the JAX tool writes them,
then the robot, the card's name and power limit (nvidia-smi; "cpu" on the
CPU) and the seconds since the first iteration began.  The robot is
--asset_file, else the T1-shaped stand-in.  Runs on cuda unless --device
cpu; without a card it exits non-zero.

learning_criteria() is the bar a recorded curve must clear to show that
training learns (PERF.md section 2).
"""

import argparse
import json
import os
import time

from booster_gym_torch.tools import card, device_or_exit, open_out, t1_robot

SEED = 42


def default_output(dtype, terrain):
    name = "flat" if terrain == "plane" else "rough"
    return os.path.join("booster_gym_torch", "records", f"reward_curve_{name}_{dtype}.jsonl")


def curve_cfg(urdf, dtype, terrain, num_envs=4096):
    from booster_gym_torch.utils.config import load_task_cfg

    cfg = load_task_cfg("T1")
    cfg["env"]["num_envs"] = num_envs
    cfg["terrain"]["type"] = terrain
    cfg["algorithm"]["compute_dtype"] = dtype
    cfg["asset"]["file"] = urdf
    return cfg


def learning_criteria(rows, at=1000):
    """(ok, why): the reward at iteration `at` at least 10 x the mean
    reward of the rows at iterations <= 100; steps at `at` at least 5 x
    steps at iteration 1; the first reward below 10; every lr in
    [1e-5, 1e-2].  `why` names the first criterion missed, "" if none."""
    by_iter = {r["iter"]: r for r in rows}
    early = [r["reward"] for r in rows if r["iter"] <= 100]
    last, first = by_iter.get(at), rows[0]
    if last is None:
        return False, f"no row at iteration {at}"
    if not last["reward"] >= 10 * (sum(early) / len(early)):
        return False, (f"reward {last['reward']} at {at} below 10 x the early mean "
                       f"{sum(early) / len(early):.4f}")
    if not last["steps"] >= 5 * first["steps"]:
        return False, f"steps {last['steps']} at {at} below 5 x {first['steps']} at iteration 1"
    if not first["reward"] < 10:
        return False, f"first reward {first['reward']} not below 10"
    if not all(1e-5 - 1e-9 <= r["lr"] <= 1e-2 + 1e-9 for r in rows):
        return False, "an lr outside [1e-5, 1e-2]"
    return True, ""


def run(iters, dtype, out, terrain, device, num_envs=4096, asset_file=None):
    """Train and write the curve to `out`; returns the rows."""
    import torch

    from booster_gym_torch.algo.ppo import PPO
    from booster_gym_torch.envs import make_task

    urdf, robot = t1_robot(asset_file)
    card_name = card(device)
    cfg = curve_cfg(urdf, dtype, terrain, num_envs)
    env = make_task(cfg, device)
    ppo = PPO(env, cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    env_params, ts = ppo.init(gen)
    rows = []
    t0 = time.time()
    with open(open_out(out), "w") as f:
        for i in range(iters):
            ts, m = ppo.train_iteration(env_params, ts, gen)
            if (i + 1) % 50 == 0 or i == 0:
                r = float(m["reward"])
                row = {"iter": i + 1, "reward": round(r, 3), "lr": float(m["lr"]),
                       "kl": float(m["kl_mean"]), "steps": float(m["steps"]),
                       "robot": robot, "card": card_name,
                       "wall_s": round(time.time() - t0, 2)}
                rows.append(row)
                f.write(json.dumps(row) + "\n")
                f.flush()
                if (i + 1) % 500 == 0 or i == 0:
                    print(f"[{dtype}] iter {i + 1}: reward {r:.2f} "
                          f"({time.time() - t0:.0f}s)", flush=True)
    print(f"[{dtype}] final reward {float(m['reward']):.2f} in {time.time() - t0:.0f}s -> {out}",
          flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("iters", nargs="?", type=int, default=5000)
    ap.add_argument("dtype", nargs="?", default="bf16", choices=("bf16", "f32"))
    ap.add_argument("out", nargs="?", default="-")
    ap.add_argument("terrain", nargs="?", default="plane", choices=("plane", "trimesh"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num_envs", type=int, default=4096)
    ap.add_argument("--asset_file", default=None)
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)
    out = args.out if args.out != "-" else default_output(args.dtype, args.terrain)
    run(args.iters, args.dtype, out, args.terrain, device, args.num_envs, args.asset_file)


if __name__ == "__main__":
    main()
