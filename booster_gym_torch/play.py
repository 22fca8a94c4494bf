"""Play a trained policy in the training sim (port of play.py):

    python -m booster_gym_torch.play --task=T1 --checkpoint=PATH|-1 \
        [--terrain=plane] [--num_envs N --asset_file URDF] [--device cuda|cpu]

PATH is the port's model_<it>.pt or the JAX package's model_<it>.ckpt.
Steps 10 s of control steps with the actor's mean and prints the mean
reward per step, then the steps' rate (CUDA events on a GPU, the host
clock on the CPU).  Runs on cuda unless --device cpu.
"""

import numpy as np

from booster_gym_torch.runner import Runner, _Timer
from booster_gym_torch.utils.config import build_cfg, parse_args


def main(argv=None):
    args = parse_args(argv)
    cfg = build_cfg(args)
    runner = Runner(cfg, device=args.device)
    timer = _Timer(runner.device)
    traj = runner.play(timer=timer)
    rews = np.stack([t["rew"] for t in traj])
    print(f"played {len(traj)} steps, mean reward/step: {rews.mean():.4f}")
    ms = timer.ms("steps", "end")
    print(f"{len(traj) / (ms / 1e3):,.1f} steps/s ({rews.size / (ms / 1e3):,.0f} env-steps/s) "
          f"on {runner.device}")
    if cfg["viewer"].get("record_video", False):
        print("video rendering unavailable: the port has no renderer yet")
    return traj


if __name__ == "__main__":
    main()
