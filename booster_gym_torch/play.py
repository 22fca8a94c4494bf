"""Play a trained policy in the training sim (port of play.py):

    python -m booster_gym_torch.play --task=T1 --checkpoint=PATH|-1 \
        [--terrain=plane] [--num_envs N --asset_file URDF] [--device cuda|cpu] \
        [--no_data_parallel]
    torchrun --nproc_per_node=N -m booster_gym_torch.play --task=T1 ...

PATH is the port's model_<it>.pt or the JAX package's model_<it>.ckpt.
Steps 10 s of control steps with the actor's mean and prints the mean
reward per step, then the steps' rate (CUDA events on a GPU, the host
clock on the CPU).  Runs on cuda unless --device cpu.  Under
viewer.record_video (T1.yaml: true) env viewer.record_env_idx's states
are rendered offline to videos/<time>.mp4 by eval/render.py (MuJoCo's
offscreen renderer on the asset's MJCF); without mujoco or a GL backend
it prints why there is no video.

Over every GPU, as the JAX package's `python play.py` steps its env
sharded over the mesh: the launcher of booster_gym_torch.train starts its
ranks (train.world_size), each steps its slice of the env batch, and rank
0 gathers the trajectory, prints and renders; its rate is rank 0's time
for the global batch.  Under torchrun this process is one rank.  With one
card, --device cpu, --no_data_parallel or basic.data_parallel: false it
plays in this process.
"""

import numpy as np
import torch

from booster_gym_torch.parallel import configured, launch
from booster_gym_torch.runner import Runner, _Timer
from booster_gym_torch.train import world_size
from booster_gym_torch.utils.config import build_cfg, parse_args


def play(cfg, device):
    """One process's play: a rank of the group the environment configures,
    or the whole run.  Returns rank 0's trajectory, None on another rank."""
    runner = Runner(cfg, device=device)
    timer = _Timer(runner.device)
    traj = runner.play(timer=timer)
    if traj is None:
        return None
    rews = np.stack([t["rew"] for t in traj])
    print(f"played {len(traj)} steps, mean reward/step: {rews.mean():.4f}")
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
    args = parse_args(argv)
    cfg = build_cfg(args)
    n = 1
    if (torch.device(args.device).type == "cuda" and torch.cuda.is_available()
            and not configured()):
        n = world_size(cfg, torch.cuda.device_count())
    if n == 1:
        return play(cfg, args.device)
    launch(play, n, (cfg, args.device))


if __name__ == "__main__":
    main()
