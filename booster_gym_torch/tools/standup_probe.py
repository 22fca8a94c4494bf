"""Trajectory probe for a standup checkpoint (port of
tools/standup_probe.py): roll the deterministic policy in the T1Standup
env and print the height/uprightness envelope over the episode, the fast
diagnostic between training rounds (is the policy rising-then-falling, or
never trying?).

    python -m booster_gym_torch.tools.standup_probe [--ckpt -1|PATH[,PATH...]]
        [--envs 64] [--seconds 8] [--bank-seed S] [--out FILE]
        [--device cuda|cpu] [--asset_file URDF --mujoco_file MJCF]

A checkpoint is the port's model_<it>.pt or the JAX package's
model_<it>.ckpt; -1 the newest under logs/.  The robot is --asset_file and
--mujoco_file, else the 23-DoF serial stand-in; the summary names it.  Runs
on cuda unless --device cpu; without a card it exits non-zero.
"""

import argparse
import json

import numpy as np

from booster_gym_torch.tools import device_or_exit, load_params, open_out, serial_robot

CATEGORIES = ("prone", "supine", "side", "upright")


def categorize(quat_wxyz):
    """prone / supine / side / upright from the initial base orientation
    (projected gravity in the base frame), as numpy strings."""
    import torch

    from booster_gym_torch.math.quat import quat_rotate_inverse

    q = torch.as_tensor(np.asarray(quat_wxyz, np.float32))
    g = quat_rotate_inverse(q, torch.tensor([0.0, 0.0, -1.0]).expand(q.shape[0], 3)).numpy()
    cats = np.full(len(g), "side", dtype=object)
    cats[np.abs(g[:, 0]) >= np.abs(g[:, 1])] = "pitch"
    # pitched forward (face-down) has gravity along -x in the base frame
    cats[(cats == "pitch") & (g[:, 0] < 0)] = "prone"
    cats[cats == "pitch"] = "supine"
    cats[g[:, 2] < -0.7] = "upright"
    return cats


def envelope(h, u):
    """The trunk heights' and uprightness' spread over the envs."""
    return {"p25": float(np.percentile(h, 25)), "med": float(np.median(h)),
            "p75": float(np.percentile(h, 75)), "max": float(h.max()),
            "up_med": float(np.median(u)), "up_p90": float(np.percentile(u, 90))}


def envelope_line(t, e):
    return (f"t={t:4.1f}s  h: p25={e['p25']:.3f} med={e['med']:.3f} p75={e['p75']:.3f} "
            f"max={e['max']:.3f} | up: med={e['up_med']:.2f} p90={e['up_p90']:.2f}")


def standing(h, u):
    """Standing: trunk above 0.55 m and uprightness above 0.9."""
    return (h > 0.55) & (u > 0.9)


def per_category(cats, ok):
    return {c: {"n": int((cats == c).sum()), "success": int(ok[cats == c].sum())}
            for c in CATEGORIES if (cats == c).sum()}


def probe_cfg(urdf, mjcf, envs):
    from booster_gym_torch.utils.config import load_task_cfg

    cfg = load_task_cfg("T1Standup")
    cfg["env"]["num_envs"] = envs
    cfg["noise"] = {}
    cfg["asset"]["file"] = urdf
    cfg["asset"]["mujoco_file"] = mjcf
    return cfg


def start(cfg, device, bank_seed=None):
    """(env, ppo, env_params, state0, obs0): the training bank from seed 0
    and resets from seed 1 (PPO.init as the trainer makes them), or with
    `bank_seed` a held-out bank from that seed and resets from the next."""
    import torch

    from booster_gym_torch.algo.ppo import PPO
    from booster_gym_torch.envs import make_task

    env = make_task(cfg, device)
    ppo = PPO(env, cfg, device)
    gen = torch.Generator(device=device)
    if bank_seed is not None:
        env_params = env.init_params(gen.manual_seed(bank_seed))
        gen.manual_seed(bank_seed + 1)
    else:
        env_params, _ = ppo.init(gen.manual_seed(0))
        gen.manual_seed(1)
    state0, obs0, _ = env.reset_all(env_params, gen)
    return env, ppo, env_params, state0, obs0, gen


def probe(cfg, ckpts, device, seconds=8.0, bank_seed=None, robot="", log=print):
    """One summary per checkpoint: the envelope each second, then the share
    standing at the end, overall and per starting category."""
    import torch

    env, ppo, env_params, state0, obs0, gen = start(cfg, device, bank_seed)
    cats = categorize(state0.sim.root_quat.cpu().numpy())
    n = int(seconds / env.dt)
    per_second = int(round(1.0 / env.dt))
    summaries = []
    for path in ckpts:
        log(f"loading {path}")
        load_params(ppo.network, path)
        state, obs = state0, obs0
        with torch.no_grad():
            for i in range(n):
                mu, _ = ppo.network.act(obs)
                state, obs, _, _, _ = env.step(env_params, state, mu, gen)
                if (i + 1) % per_second == 0:
                    h = state.sim.root_pos[:, 2].cpu().numpy()
                    u = -state.projected_gravity[:, 2].cpu().numpy()
                    log(envelope_line((i + 1) * env.dt, envelope(h, u)))
        ok = standing(state.sim.root_pos[:, 2].cpu().numpy(),
                      -state.projected_gravity[:, 2].cpu().numpy())
        log(f"[{path}] standing at t={seconds}s: {ok.mean() * 100:.1f}% of {len(ok)} envs")
        cat = per_category(cats, ok)
        for c, v in cat.items():
            log(f"  {c:8s}: {v['success']}/{v['n']} ({100 * v['success'] / v['n']:.1f}%)")
        summaries.append({"ckpt": path, "envs": len(ok), "seconds": seconds,
                          "bank_seed": bank_seed, "standing_rate": float(ok.mean()),
                          "per_category": cat, "robot": robot})
    return summaries


def main(argv=None):
    from booster_gym_torch.utils.recorder import resolve_checkpoint

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default="-1",
                    help="checkpoint path, -1 for newest, or a comma-separated list "
                         "(probed in one process)")
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--bank-seed", type=int, default=None,
                    help="rebuild the init bank from a fresh seed (held-out drops)")
    ap.add_argument("--out", default=None, help="write a JSON summary")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--asset_file", default=None)
    ap.add_argument("--mujoco_file", default=None)
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)
    urdf, mjcf, robot = serial_robot(args.asset_file, args.mujoco_file)
    ckpts = [resolve_checkpoint(c) for c in args.ckpt.split(",")]
    summaries = probe(probe_cfg(urdf, mjcf, args.envs), ckpts, device, args.seconds,
                      args.bank_seed, robot)
    if args.out:
        with open(open_out(args.out), "w") as f:
            json.dump(summaries[-1] if len(summaries) == 1 else {"probes": summaries}, f,
                      indent=1)
        print(f"wrote {args.out}", flush=True)
    return summaries


if __name__ == "__main__":
    main()
