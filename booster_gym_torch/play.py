"""Play a trained policy in the training sim (port of play.py):

    python -m booster_gym_torch.play --task=T1 --checkpoint=PATH|-1 \
        [--terrain=plane] [--num_envs N --asset_file URDF] [--device cuda|cpu] \
        [--no_data_parallel] [--num_steps N]
    torchrun --nproc_per_node=N -m booster_gym_torch.play --task=T1 ...

PATH is the port's model_<it>.pt or the JAX package's model_<it>.ckpt.
Steps 10 s of control steps (--num_steps N: N steps) with the actor's mean
and prints the mean reward per step, the episodes that ended in the play
(how many, their mean length, how many envs never reset), then the steps'
rate (CUDA events on a GPU, the host clock on the CPU).  Runs on cuda
unless --device cpu.  Under viewer.record_video (T1.yaml: true) env
viewer.record_env_idx's states are rendered offline to videos/<time>.mp4
by eval/render.py (MuJoCo's offscreen renderer on the asset's MJCF);
without mujoco or a GL backend it prints why there is no video.

Over every GPU, as the JAX package's `python play.py` steps its env
sharded over the mesh: the launcher of booster_gym_torch.train starts its
ranks (train.world_size), each steps its slice of the env batch, and rank
0 gathers the trajectory, prints and renders; its rate is rank 0's time
for the global batch.  Under torchrun this process is one rank.  With one
card, --device cpu, --no_data_parallel or basic.data_parallel: false it
plays in this process.
"""

import argparse

import numpy as np
import torch

from booster_gym_torch.parallel import configured, launch
from booster_gym_torch.runner import Runner, _Timer
from booster_gym_torch.train import world_size
from booster_gym_torch.utils.config import build_cfg, parse_args


def episode_lengths(done):
    """(lengths of the episodes that ended, envs that never reset) from
    done [steps, envs]: an env's first episode runs from the play's start,
    each later one from the step after its last reset."""
    done = np.asarray(done, bool)
    lengths, start = [], np.zeros(done.shape[1], np.int64)
    for t, row in enumerate(done):
        ended = np.nonzero(row)[0]
        lengths += (t + 1 - start[ended]).tolist()
        start[ended] = t + 1
    return lengths, int((~done.any(0)).sum())


def play(cfg, device):
    """One process's play: a rank of the group the environment configures,
    or the whole run, for basic.play_steps control steps (10 s by
    default).  Returns rank 0's trajectory, None on another rank."""
    runner = Runner(cfg, device=device)
    timer = _Timer(runner.device)
    traj = runner.play(num_steps=cfg["basic"].get("play_steps"), timer=timer)
    if traj is None:
        return None
    rews = np.stack([t["rew"] for t in traj])
    print(f"played {len(traj)} steps, mean reward/step: {rews.mean():.4f}")
    lengths, never = episode_lengths([t["done"] for t in traj])
    mean = np.mean(lengths) if lengths else float("nan")
    print(f"episodes ended: {len(lengths)}, mean length {mean:.1f} steps "
          f"({mean * runner.env.dt:.2f} s); envs never reset: {never} of {rews.shape[1]}")
    ms = timer.ms("steps", "end")
    print(f"{len(traj) / (ms / 1e3):,.1f} steps/s ({rews.size / (ms / 1e3):,.0f} env-steps/s) "
          f"on {runner.device}")
    if cfg["viewer"].get("record_video", False):
        try:
            from booster_gym_torch.eval.render import render_trajectory

            path = render_trajectory(cfg, traj, env_idx=cfg["viewer"].get("record_env_idx", 0))
            print(f"video written to {path}")
        except Exception as e:
            print(f"video rendering unavailable: {e}")
    return traj


def main(argv=None):
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--num_steps", type=int, help="Control steps to play (default 10 s).")
    known, rest = extra.parse_known_args(argv)
    args = parse_args(rest)
    cfg = build_cfg(args)
    if known.num_steps is not None:
        cfg["basic"]["play_steps"] = known.num_steps
    n = 1
    if (torch.device(args.device).type == "cuda" and torch.cuda.is_available()
            and not configured()):
        n = world_size(cfg, torch.cuda.device_count())
    if n == 1:
        return play(cfg, args.device)
    launch(play, n, (cfg, args.device))


if __name__ == "__main__":
    main()
