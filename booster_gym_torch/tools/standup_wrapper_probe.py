"""Control experiment for the standup artifact (port of
tools/standup_wrapper_probe.py): drive the port's T1Standup env with the
deploy wrapper (booster_gym_torch/deploy's StandupPolicy: the TorchScript
module, its 50-frame stack and mirror averaging) instead of the raw actor.

Separates failure causes for the MuJoCo cross-check: if the wrapper stands
the robot up here (where the raw actor does), the export and the wrapper
are right and a MuJoCo gap is physics transfer; if not, the fault is in
export, stacking or mirroring.

    python -m booster_gym_torch.tools.standup_wrapper_probe [--model models/T1_standup.pt]
        [--envs 8] [--seconds 8] [--no-mirror] [--device cuda|cpu]
        [--asset_file URDF --mujoco_file MJCF]

The robot is --asset_file and --mujoco_file, else the 23-DoF serial
stand-in.  Runs on cuda unless --device cpu; without a card it exits
non-zero.  The wrapper itself runs on the CPU, one env at a time, as on
the robot.
"""

import argparse
import os

import numpy as np
import yaml

from booster_gym_torch.tools import device_or_exit, serial_robot
from booster_gym_torch.tools.standup_probe import probe_cfg, standing, start

DEPLOY_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "deploy", "configs", "T1.yaml")


def wrapper_actions(env, pols, t, state):
    """The env's actions [B, na] that reproduce each wrapper's PD targets:
    the inverse of T1Standup._apply_actions on the wrappers' outputs."""
    q, qd = state.sim.q.cpu().numpy(), state.sim.qd.cpu().numpy()
    gyro = state.base_ang_vel.cpu().numpy()
    pg = state.projected_gravity.cpu().numpy()
    idx = env.action_indices.cpu().numpy()
    default_sub = env.default_subset.cpu().numpy()
    scale = env.cfg["control"]["action_scale"]
    acts = np.zeros((len(pols), env.num_actions), np.float32)
    for e, pol in enumerate(pols):
        targets = pol.inference(t, q[e], qd[e], gyro[e], pg[e])
        acts[e] = (targets[idx] - default_sub) / scale
    return acts


def rearm(pol):
    """A reset env, or a new drop, restarts from a fresh pose: re-arm the
    wrapper as the Controller does on a mode entry (a stale 50-frame
    history from the last episode would poison the policy)."""
    pol.first_inference = True
    pol.actions[:] = 0.0
    pol.dof_targets[:] = pol.full_default


def run(cfg, model, device, seconds=8.0, mirror=True, log=print):
    """The share of envs standing after `seconds`."""
    import torch

    from booster_gym_torch.deploy.policy import StandupPolicy

    with open(DEPLOY_CFG) as f:
        dcfg = yaml.safe_load(f)
    env, _, env_params, state, _, gen = start(cfg, device)
    pols = []
    for _ in range(env.num_envs):
        pol = StandupPolicy(dcfg, policy_path=model)
        pol.mirror_average = mirror
        pols.append(pol)
    per_second = int(round(1.0 / env.dt))
    for i in range(int(seconds / env.dt)):
        acts = wrapper_actions(env, pols, i * env.dt, state)
        state, _, _, done, _ = env.step(env_params, state, torch.as_tensor(acts, device=device),
                                        gen)
        for e in np.nonzero(done.cpu().numpy())[0]:
            rearm(pols[e])
        if (i + 1) % per_second == 0:
            h = state.sim.root_pos[:, 2].cpu().numpy()
            u = -state.projected_gravity[:, 2].cpu().numpy()
            log(f"t={(i + 1) * env.dt:4.1f}s h: med={np.median(h):.3f} max={h.max():.3f} | "
                f"up med={np.median(u):.2f}")
    ok = standing(state.sim.root_pos[:, 2].cpu().numpy(),
                  -state.projected_gravity[:, 2].cpu().numpy())
    log(f"wrapper-in-engine standing at t={seconds}s: {ok.mean() * 100:.0f}% of {env.num_envs} "
        f"envs ({'mirror-averaged' if mirror else 'no-mirror'})")
    return float(ok.mean())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="models/T1_standup.pt")
    ap.add_argument("--envs", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--no-mirror", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--asset_file", default=None)
    ap.add_argument("--mujoco_file", default=None)
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)
    urdf, mjcf, robot = serial_robot(args.asset_file, args.mujoco_file)
    print(f"robot: {robot}", flush=True)
    return run(probe_cfg(urdf, mjcf, args.envs), args.model, device, args.seconds,
               not args.no_mirror)


if __name__ == "__main__":
    main()
